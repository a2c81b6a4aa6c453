"""Preconditioned + pipelined CG family with matvec-only preconditioners.

    python examples/preconditioned.py
"""

import sys, os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import krylov_tpu
from krylov_tpu import precond
from krylov_tpu.sparse.fixtures import laplace2d

A = laplace2d(48, dtype=np.float32)
b = np.ones(A.shape[0], dtype=np.float32)

for name, M in [
    ("identity", None),
    ("jacobi", precond.jacobi(A)),
    ("chebyshev(6)", precond.chebyshev(A, degree=6)),
]:
    for method in ["pcg", "chronopoulos_gear", "gropp", "pipelined_cg"]:
        # tol=1e-4: this demo runs in float32, where the TRUE residual
        # floors at ~eps_f32 * kappa(A) ~ 1e-4 on this grid; the pipelined
        # variant's residual-replacement makes its recurred residual track
        # the true one, so it honestly reports that floor (use refine= /
        # restarts= or float64 for tighter tolerances).
        x, info = krylov_tpu.solve(A, b, method=method, M=M, tol=1e-4)
        print(
            f"{method:18s} M={name:13s} iters={info['iterations']:4d} "
            f"converged={info['converged']}"
        )
