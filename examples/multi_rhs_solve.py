"""Production pattern: amortized multi-RHS solves on general sparse.

The cost of an irregular SpMV is dominated by the gather's
per-index addressing, and that index stream is IDENTICAL for every
right-hand side.  ``solve_batched`` runs a whole batch of systems as one
vmapped dispatch whose gathers/scatters lay the batch out as the
trailing axis (custom batching rules in ``sparse/formats.py``), paying
the addressing once per index for the whole batch: the shared index
stream is read once per batch, not once per system.

Typical uses: multiple load cases of one structure, multiple sources in
one field problem, block-Krylov outer methods.  Each lane keeps its OWN
convergence point — converged systems freeze while the rest iterate.

The reference can only solve one system at a time (its host loops,
reference: v3/cpu/cg.py:19).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import krylov_tpu
from krylov_tpu.sparse.convert import to_hyb
from krylov_tpu.sparse.fixtures import powerlaw_spd


def main():
    n, nrhs = 1 << 14, 8
    A_sp = powerlaw_spd(n, seed=0)
    A = to_hyb(A_sp, dtype=np.float32)

    rng = np.random.default_rng(7)
    B = rng.standard_normal((nrhs, n)).astype(np.float32)  # (batch, N)

    # ONE dispatch for the whole batch; result fields carry the batch axis.
    res = krylov_tpu.solve_batched(A, B, method="cg", tol=1e-5, maxiter=2000)

    X = np.asarray(res.x)  # (batch, N)
    iters = np.asarray(res.iterations)
    for i in range(nrhs):
        true = np.linalg.norm(B[i] - A_sp @ X[i].astype(np.float64)) / np.linalg.norm(B[i])
        print(
            f"system {i}: {int(iters[i]):4d} iterations, "
            f"converged={bool(np.asarray(res.converged)[i])}, "
            f"true residual {true:.2e}"
        )
    assert np.asarray(res.converged).all()


if __name__ == "__main__":
    main()
