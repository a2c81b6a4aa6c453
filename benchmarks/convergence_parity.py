"""Convergence-vs-reference artifact: run every algorithm against the actual
reference v3 CPU implementations (mounted read-only at /root/reference) on the
same float64 SPD systems, and record:

- iteration-count parity (history LENGTH must match exactly — the solvers
  make identical accept/reject and convergence decisions), and
- the max relative deviation of the residual histories over their meaningful
  range (the final entries sit at the round-off floor ~1e-12 of tol where
  relative deviation measures noise, so the last 10% is reported separately).

This is the artifact form of tests/test_reference_parity.py (BASELINE.md
fidelity bar).  Sizes follow the tests: parity of long f64 Krylov runs is
only bitwise-meaningful while rounding has not yet driven the trajectories
apart (CG on ill-conditioned systems is chaotically sensitive — two
mathematically identical implementations with different reduction orders
separate exponentially); the golden configs below are chosen so histories
track to <=1e-4 relative through convergence.

Larger-scale convergence (N=250k..10M) is exercised by ``chip_smoke.py``
against plain SciPy/NumPy float64 checks instead (the reference cannot run
those sizes: its dense-operand path is O(N^2) memory).

Usage:  JAX_PLATFORMS=cpu python benchmarks/convergence_parity.py
"""

import contextlib
import io
import os
import sys

import numpy as np

import sys as _sys, os as _os
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

import krylov_tpu
from krylov_tpu.sparse.fixtures import laplace2d, poisson1d

REF = "/root/reference"


def load_reference():
    if not os.path.isdir(os.path.join(REF, "v3")):
        return None
    if not hasattr(np, "int"):
        np.int = int
    sys.path.insert(0, os.path.dirname(REF))
    import importlib

    mods = {}
    for name in ["cg", "mrr", "kskipcg", "kskipmrr", "adaptivekskipmrr"]:
        mods[name] = getattr(
            importlib.import_module(f"reference.v3.cpu.{name}"), name
        )
    return mods


def main():
    ref = load_reference()
    if ref is None:
        print("reference mount absent; nothing to compare against")
        return
    # Golden configs (mirroring tests/test_reference_parity.py): known
    # solution x_true, b = A x_true, tol=1e-8.
    cases = [
        ("cg", laplace2d(12), {}),
        ("mrr", laplace2d(12), {}),
        ("kskipcg", laplace2d(12), {"k": 1}),
        ("kskipcg", laplace2d(12), {"k": 4}),
        ("kskipmrr", laplace2d(12), {"k": 2}),
        ("kskipmrr", laplace2d(12), {"k": 4}),
        ("adaptivekskipmrr", laplace2d(12), {"k": 3}),
        ("cg", poisson1d(400), {}),
        ("mrr", poisson1d(400), {}),
    ]
    tol, maxiter = 1e-8, 4000
    rng = np.random.default_rng(7)
    print(
        f"{'method':18s} {'k':>2s} {'N':>6s} {'iters':>6s} {'ref':>6s} "
        f"{'len=':>5s} {'dev(main)':>10s} {'dev(tail)':>10s} {'x_dev':>9s}"
    )
    all_ok = True
    for method, A, kw in cases:
        n = A.shape[0]
        dense = np.asarray(A.todense())
        x_true = rng.standard_normal(n)
        b = dense @ x_true
        x, info = krylov_tpu.solve(
            A, b, method=method, tol=tol, maxiter=maxiter, **kw
        )
        with contextlib.redirect_stdout(io.StringIO()):
            x_r, info_r = ref[method](
                dense, b.copy(), tol=tol, maxiter=maxiter, **kw
            )
        ours = np.asarray(info["residual"])
        theirs = np.asarray(info_r["residual"])
        len_ok = len(ours) == len(theirs)
        m = min(len(ours), len(theirs))
        cut = max(int(0.9 * m), 1)
        rel = np.abs(ours[:m] - theirs[:m]) / np.maximum(np.abs(theirs[:m]), 1e-300)
        dev_main = float(np.nanmax(rel[:cut]))
        dev_tail = float(np.nanmax(rel[cut:])) if cut < m else 0.0
        x_dev = float(
            np.linalg.norm(np.asarray(x) - x_r) / np.linalg.norm(x_r)
        )
        ok = len_ok and dev_main < 1e-3 and x_dev < 1e-5
        all_ok &= ok
        print(
            f"{method:18s} {kw.get('k', 0):>2d} {n:>6d} "
            f"{info['iterations']:>6d} {len(theirs) - 1:>6d} "
            f"{str(len_ok):>5s} {dev_main:>10.2e} {dev_tail:>10.2e} "
            f"{x_dev:>9.2e}  {'OK' if ok else 'MISMATCH'}"
        )
    print(f"\nparity: {'ALL OK' if all_ok else 'MISMATCHES PRESENT'}")


if __name__ == "__main__":
    main()
