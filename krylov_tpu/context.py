"""Compute context: the single point where distribution enters the solvers.

The reference maintains ten parallel solver trees (cpu / cpu-mpi / gpu /
gpu-mpi across three generations) differing only in how ``A.dot(x)`` and the
inner products are evaluated (reference: v3/cpu/mpi/common.py:39-43 —
local SpMV + ``comm.Allgather``; v3/gpu/common.py:112-126 — P2P broadcast +
per-GPU SpMV + P2P gather).  Here a single :class:`Context` parameterizes one
solver implementation:

- ``Context(axis=None)`` — single-device execution; reductions are plain
  ``jnp`` ops.
- ``Context(axis="rows")`` — the solver body runs inside ``shard_map`` over a
  1-D device mesh; every reduction becomes a ``lax.psum`` over the axis, and
  the operator's matvec performs its own collective (all-gather or halo
  exchange), see :mod:`krylov_tpu.dist`.

Inner products accumulate at ``lax.Precision.HIGHEST`` and can be promoted to
a wider ``scalar_dtype`` (float32 data + float64 scalar recurrences): the
reference's all-float64 policy (reference: v3/cpu/common.py:23) where it
matters, at float32 vector bandwidth.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax


@dataclasses.dataclass(frozen=True)
class Context:
    """Execution context for solver kernels.

    Attributes:
      axis: ``shard_map`` mesh axis name the solver body is mapped over, or
        ``None`` for single-device execution.
      scalar_dtype: dtype for inner-product results and scalar recurrences
        (``None`` → same as the vector dtype).
    """

    axis: Optional[str] = None
    scalar_dtype: Optional[jnp.dtype] = None

    # -- reductions ---------------------------------------------------------
    def psum(self, v):
        return lax.psum(v, self.axis) if self.axis is not None else v

    def _scalar(self, v):
        """Cast to ``scalar_dtype`` — applied to reduction INPUTS as well as
        results.  Promoting only after the reduction would keep the rounded
        narrow result (useless for stability); promoting the operands makes
        the inner products themselves exact to the wide precision.  This is
        what the k-skip bundle needs: the monomial-basis Gram matrix has
        condition ~kappa^k, so its entries must carry more than vector
        precision for the scalar recurrences (reference: all-f64 policy,
        v3/cpu/common.py:23) — here f32 vectors + f64 Gram/recurrences.
        (Full-length vector dots widen their operands too — accepted cost:
        with scalar_dtype=f64 every reduction, not just the small Gram, is
        exact to f64.)
        """
        return v.astype(self.scalar_dtype) if self.scalar_dtype is not None else v

    # Historical alias (operand-widening and result casts are the same op).
    _wide = _scalar

    def dot(self, u, v):
        """Global inner product <u, v> (one psum when distributed)."""
        local = jnp.dot(self._wide(u), self._wide(v), precision=lax.Precision.HIGHEST)
        return self._scalar(self.psum(local))

    def norm(self, u):
        return jnp.sqrt(self.dot(u, u))

    def gram(self, B):
        """All pairwise inner products of the rows of B in ONE fused reduction.

        ``B`` is a (m, n_local) stack of Krylov basis vectors; the result is
        the (m, m) Gram matrix psum-reduced across the mesh.  This replaces
        the reference's 6k+O(1) individual dot products per k-skip bundle
        (reference: v3/cpu/kskipmrr.py:51-59, computed redundantly per rank
        at v3/cpu/mpi/kskipmrr.py:64-73): a single matmul + a single
        collective.
        """
        Bw = self._wide(B)
        local = jnp.dot(Bw, Bw.T, precision=lax.Precision.HIGHEST)
        return self._scalar(self.psum(local))

    def cross_gram(self, U, V):
        """(m_u, m_v) matrix of inner products between rows of U and rows of V."""
        local = jnp.dot(
            self._wide(U), self._wide(V).T, precision=lax.Precision.HIGHEST
        )
        return self._scalar(self.psum(local))

    def dot_bundle(self, pairs):
        """Batch of inner products [(u_i, v_i), ...] in one fused reduction."""
        locals_ = jnp.stack(
            [
                jnp.dot(self._wide(u), self._wide(v), precision=lax.Precision.HIGHEST)
                for u, v in pairs
            ]
        )
        return self._scalar(self.psum(locals_))

    # -- operator application ----------------------------------------------
    def matvec(self, A, x):
        """Apply the operator; distributed operators (``needs_ctx=True``,
        see :class:`krylov_tpu.dist.spmv.ShardedOperator`) get the context
        for their internal collectives."""
        if getattr(A, "needs_ctx", False):
            return A.matvec(x, self)
        return A.matvec(x)


DEFAULT_CONTEXT = Context()
