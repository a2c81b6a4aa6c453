"""Matvec-only preconditioners.

The reference's only preconditioner is a duck-typed ILU operand
(``ilu.solve(r)``, reference: v1/threads/pipeline/pcg.py:4,29) — sparse
triangular solves, which serialize row-by-row and leave a wide vector
machine idle.  The replacements provided here are matvec-only and fully
jittable:

- :func:`jacobi` — inverse-diagonal scaling (a DiaMatrix with offset 0);
- :class:`ChebyshevPreconditioner` — degree-d Chebyshev polynomial
  approximation of ``A^{-1}`` on a spectral interval ``[lmin, lmax]``:
  d extra SpMVs per application, zero extra reductions, embarrassingly
  parallel, and it composes with the row-partitioned SpMV (halo exchange)
  unchanged.

Both work with every method that takes ``M`` (``pcg``, ``chronopoulos_gear``,
``gropp``, ``pipelined_cg`` — and plain ``cg``/``mrr`` ignore ``M`` like the
reference does, reference: v3/cpu/cg.py:7).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from krylov_tpu.sparse.formats import (
    DenseMatrix,
    DiaMatrix,
    EllMatrix,
    HybMatrix,
    StencilMatrix,
)


def extract_diagonal(A) -> np.ndarray:
    """Host-side diagonal extraction for any container."""
    if isinstance(A, StencilMatrix):
        zero = tuple(0 for _ in A.grid)
        coef = np.asarray(A.coef)
        out = np.zeros(A.shape[0], dtype=coef.dtype)
        for s, disp in enumerate(A.stencil):
            if tuple(disp) == zero:
                out += coef[s].reshape(-1)
        return out
    if isinstance(A, DiaMatrix):
        if 0 not in A.offsets:
            return np.zeros(A.shape[0], dtype=np.asarray(A.data).dtype)
        return np.asarray(A.data)[A.offsets.index(0)]
    if isinstance(A, EllMatrix):
        data = np.asarray(A.data)
        idx = np.asarray(A.indices)
        rows = np.arange(A.shape[0])[:, None]
        return np.where(idx == rows, data, 0.0).sum(axis=1)
    if isinstance(A, HybMatrix):
        data = np.asarray(A.ell_data)
        idx = np.asarray(A.ell_indices)
        rows = np.arange(A.shape[0])[:, None]
        out = np.where(idx == rows, data, 0.0).sum(axis=1)
        # tail chunks: scatter-add entries whose column equals the chunk's
        # target row (duplicate chunks of one long row accumulate, matching
        # the matvec's scatter-add semantics)
        t_rows = np.asarray(A.tail_rows)
        t_data = np.asarray(A.tail_data)
        t_idx = np.asarray(A.tail_indices)
        diag_contrib = np.where(t_idx == t_rows[:, None], t_data, 0.0).sum(axis=1)
        np.add.at(out, t_rows, diag_contrib)
        return out
    if isinstance(A, DenseMatrix):
        return np.diag(np.asarray(A.data))
    raise TypeError(f"cannot extract diagonal from {type(A)}")


def jacobi(A) -> DiaMatrix:
    """M ≈ A^{-1} as inverse-diagonal scaling."""
    d = extract_diagonal(A)
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)
    n = A.shape[0]
    return DiaMatrix(jnp.asarray(inv)[None, :], (0,), (n, n))


def gershgorin_bounds(A) -> Tuple[float, float]:
    """Cheap spectral-interval estimate for SPD A: lmax by Gershgorin row
    sums, lmin by a crude lmax/30 heuristic (safe for preconditioning —
    an underestimate only flattens the polynomial)."""
    if isinstance(A, StencilMatrix):
        rowsum = np.abs(np.asarray(A.coef)).sum(axis=0).reshape(-1)
    elif isinstance(A, DiaMatrix):
        rowsum = np.abs(np.asarray(A.data)).sum(axis=0)
    elif isinstance(A, EllMatrix):
        rowsum = np.abs(np.asarray(A.data)).sum(axis=1)
    elif isinstance(A, HybMatrix):
        rowsum = np.abs(np.asarray(A.ell_data)).sum(axis=1)
        np.add.at(
            rowsum,
            np.asarray(A.tail_rows),
            np.abs(np.asarray(A.tail_data)).sum(axis=1),
        )
    elif isinstance(A, DenseMatrix):
        rowsum = np.abs(np.asarray(A.data)).sum(axis=1)
    else:
        raise TypeError(f"cannot bound spectrum of {type(A)}")
    lmax = float(rowsum.max())
    return lmax / 30.0, lmax


def lanczos_bounds(
    A, m: int = 16, seed: int = 0, safety: float = 1.05
) -> Tuple[float, float]:
    """Spectral-interval estimate via an m-step Lanczos run (m SpMVs).

    The Ritz values of the Lanczos tridiagonal converge to the extreme
    eigenvalues of SPD ``A`` from inside, so the returned interval is
    ``[theta_min / safety, theta_max * safety]``.  Much tighter than
    :func:`gershgorin_bounds` whose ``lmin = lmax/30`` heuristic can be
    arbitrarily wrong (e.g. strongly graded diagonals); Chebyshev quality
    depends directly on the interval, so use this when the spectrum is
    unknown.  Runs jitted on device with full reorthogonalization (m is
    small, the QR-like cost is negligible next to the SpMVs).
    """
    import jax

    n = A.shape[0]
    rng = np.random.default_rng(seed)
    v0 = rng.standard_normal(n)

    @jax.jit
    def run(v0):
        V = jnp.zeros((m + 1, n), dtype=A.dtype)
        v = (v0 / jnp.linalg.norm(v0)).astype(A.dtype)
        V = V.at[0].set(v)
        alphas = jnp.zeros(m, dtype=A.dtype)
        betas = jnp.zeros(m, dtype=A.dtype)

        def body(j, st):
            V, alphas, betas = st
            v = V[j]
            w = A.matvec(v)
            alpha = jnp.dot(w, v, precision=jax.lax.Precision.HIGHEST)
            w = w - alpha * v
            # full reorthogonalization against all previous vectors
            proj = jnp.dot(V, w, precision=jax.lax.Precision.HIGHEST)
            w = w - jnp.dot(proj, V, precision=jax.lax.Precision.HIGHEST)
            beta = jnp.linalg.norm(w)
            v_next = jnp.where(beta > 0, w / jnp.where(beta > 0, beta, 1.0), w)
            V = V.at[j + 1].set(v_next)
            return (
                V,
                alphas.at[j].set(alpha),
                betas.at[j].set(beta),
            )

        V, alphas, betas = jax.lax.fori_loop(0, m, body, (V, alphas, betas))
        return alphas, betas

    alphas, betas = jax.device_get(run(jnp.asarray(v0, dtype=A.dtype)))
    T = np.diag(np.asarray(alphas, np.float64))
    off = np.asarray(betas, np.float64)[: m - 1]
    T += np.diag(off, 1) + np.diag(off, -1)
    theta = np.linalg.eigvalsh(T)
    lmin = max(float(theta[0]), 1e-30) / safety
    lmax = float(theta[-1]) * safety
    return lmin, lmax


@dataclasses.dataclass(frozen=True)
class ChebyshevPreconditioner:
    """Apply z ≈ A^{-1} v via a degree-d Chebyshev recurrence (d SpMVs)."""

    A: object  # any library operator (or ShardedOperator inside shard_map)
    lmin: float
    lmax: float
    degree: int

    needs_ctx = True

    @property
    def shape(self):
        return self.A.shape

    @property
    def dtype(self):
        return self.A.dtype

    def matvec(self, v, ctx):
        theta = 0.5 * (self.lmax + self.lmin)
        delta = 0.5 * (self.lmax - self.lmin)
        sigma1 = theta / delta
        rho = 1.0 / sigma1
        z = jnp.zeros_like(v)
        r = v
        d = r / theta
        for _ in range(self.degree):
            z = z + d
            r = r - ctx.matvec(self.A, d)
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
            rho = rho_new
        return z


jax.tree_util.register_dataclass(
    ChebyshevPreconditioner,
    data_fields=["A"],
    meta_fields=["lmin", "lmax", "degree"],
)


def chebyshev(
    A,
    degree: int = 4,
    lmin: float | None = None,
    lmax: float | None = None,
    bounds: str = "auto",
):
    """Build a Chebyshev polynomial preconditioner with estimated bounds.

    ``bounds``: ``"auto"`` (default — Lanczos, falling back to Gershgorin
    if the Lanczos run fails), ``"lanczos"`` (m SpMVs, tight interval), or
    ``"gershgorin"`` (free, but its ``lmin = lmax/30`` heuristic can be
    orders of magnitude wrong on graded spectra, flattening the polynomial).
    The 16 Lanczos SpMVs are a one-time cost dwarfed by the degree*iters
    SpMVs any preconditioned solve pays, so Lanczos is the default.
    """
    if lmin is None or lmax is None:
        if bounds == "gershgorin":
            lo, hi = gershgorin_bounds(A)
        elif bounds == "lanczos":
            lo, hi = lanczos_bounds(A)
        elif bounds == "auto":
            try:
                lo, hi = lanczos_bounds(A)
                if not (np.isfinite(lo) and np.isfinite(hi) and 0 < lo < hi):
                    raise ValueError("degenerate Lanczos interval")
            except Exception:
                lo, hi = gershgorin_bounds(A)
        else:
            raise ValueError(
                f"bounds must be 'auto', 'lanczos' or 'gershgorin', got {bounds!r}"
            )
        lmin = lo if lmin is None else lmin
        lmax = hi if lmax is None else lmax
    return ChebyshevPreconditioner(A=A, lmin=float(lmin), lmax=float(lmax), degree=int(degree))
