"""tpu-krylov: a JAX library of Krylov subspace solvers.

A from-scratch JAX/XLA re-design of the capability set of
5enxia/parallel-krylov (CG, MrR, k-skip CG, k-skip MrR, adaptive k-skip MrR,
plus the preconditioned/pipelined CG family), replacing the reference's
cpu/gpu/mpi dispatch tree (reference: v1/ v2/ v3/ trees) with a single
mesh-parameterized code path:

- sparse containers registered as pytrees (``krylov_tpu.sparse``)
- solvers as pure jitted functions built on ``lax.while_loop`` /
  ``lax.fori_loop`` (``krylov_tpu.solvers``)
- distribution via ``jax.sharding.Mesh`` + ``shard_map`` with psum/all_gather/
  ppermute collectives (``krylov_tpu.dist``)
- a SciPy-compatible front door (``krylov_tpu.api``), modeled on the
  reference's v3 API (reference: v3/cpu/cg.py:7).
"""

from krylov_tpu import sparse
from krylov_tpu.context import Context, DEFAULT_CONTEXT
from krylov_tpu.api import (
    solve,
    solve_batched,
    solve_device,
    cg,
    mrr,
    kskipcg,
    kskipmrr,
    adaptivekskipmrr,
)

__version__ = "0.1.0"

__all__ = [
    "sparse",
    "Context",
    "DEFAULT_CONTEXT",
    "solve",
    "solve_batched",
    "solve_device",
    "cg",
    "mrr",
    "kskipcg",
    "kskipmrr",
    "adaptivekskipmrr",
]
