"""Row-partitioned distributed solve over a device mesh.

On a multi-GPU host this uses all GPUs; on a dev box run with

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/distributed_solve.py
"""

import sys, os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

import krylov_tpu
from krylov_tpu.dist import make_mesh
from krylov_tpu.sparse.fixtures import laplace2d

print(f"devices: {jax.device_count()} x {jax.devices()[0].platform}")
mesh = make_mesh()

A = laplace2d(64, 128, dtype=np.float32)  # grid (128, 64): leading axis sharded
b = np.ones(A.shape[0], dtype=np.float32)

x, info = krylov_tpu.solve(
    A, b, method="adaptivekskipmrr", k=4, tol=1e-5, mesh=mesh, verbose=True
)
true_res = np.linalg.norm(b - np.asarray(A.matvec(x))) / np.linalg.norm(b)
print(f"-> true relative residual: {true_res:.3e}, khistory={info['khistory']}")
