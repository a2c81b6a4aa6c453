"""Communication-avoiding CG with a Chebyshev s-step basis (``cacg``).

Beyond-reference capability.  The reference's k-skip family advances its
inner products through scalar recurrences derived for the MONOMIAL basis
``A^j r`` (reference: v3/cpu/kskipcg.py:59-64), whose conditioning grows
like ``kappa^k`` — in float32 it collapses around k≈4 on stiff operators
and even float64 gives out near k≈8-10 (tests/test_cacg.py).  The
principled fix from the CA-Krylov literature (Hoemmen 2010 "Communication-
avoiding Krylov subspace methods"; Carson 2015 thesis) is to span the same
Krylov space with a better-conditioned polynomial basis and carry the CG
scalars through the basis Gram matrix instead of bespoke recurrences:

- **Basis**: shifted-scaled Chebyshev polynomials ``rho_j`` on a spectral
  interval ``[lmin, lmax]`` (3-term recurrence; |rho_j| <= 1 on the
  interval, so basis conditioning grows polynomially, not like kappa^k).
  Chains ``P = [rho_0(A)p .. rho_s(A)p]`` (s+1 vectors) and
  ``R = [rho_0(A)r .. rho_{s-1}(A)r]`` — 2s-1 SpMVs per outer iteration.
- **Change-of-basis matrix T** ((2s+1)^2, static): ``A V e_j = V T e_j``
  for every basis column the inner loop touches, straight from the 3-term
  recurrence.  Applying A to any iterate becomes a tiny matrix-vector
  product in coefficient space.
- **One Gram** ``G = V V^T`` per outer iteration — a single matmul
  and, distributed, ONE psum per s CG steps (the same communication
  schedule as the k-skip family, reference analog:
  v3/cpu/mpi/kskipcg.py bundles).
- **Inner s steps** run entirely on (2s+1)-long coefficient vectors:
  ``alpha = <r,r>_G / <p, T p>_G``, updates on x̂/r̂/p̂ — scalar-dtype
  dataflow, no vector work at all.
- **Recovery**: ``x += x̂ V``, ``p = p̂ V`` — two tall-skinny matmuls;
  the residual is recomputed as ``b - A x`` each outer iteration
  (residual replacement, Carson §5: keeps the true and recurred residuals
  coupled in working precision at a cost of 1/(2s-1) extra SpMVs).

Spectral bounds (measured guidance, see also ``api._resolve_bounds``):
``lmax`` overestimates are benign (mild basis-conditioning loss), and an
``lmin`` that sits ABOVE the true smallest eigenvalues is also fine (the
few modes below the interval cost only a bounded Chebyshev growth factor
— measured: an lmin 400x above true lmin still converged).  What
destabilizes the method is WIDENING the interval downward: lowering lmin
shrinks the recurrence scale ``c`` and measurably diverged the
kappa~1e5 solve when widened 4x.  Do not "pad" bounds downward;
:func:`krylov_tpu.precond.lanczos_bounds` supplies tight ones (the same
machinery the Chebyshev preconditioner uses).

Measured effect (tests/test_cacg.py): float32 at s=8 on the kappa~1e5
graded-spectrum system converges where monomial k-skip CG records NaN —
and in float64 it tracks plain CG's iteration count.
"""

from __future__ import annotations

from functools import partial

import jax.numpy as jnp
import numpy as np
from jax import lax

from krylov_tpu.context import Context, DEFAULT_CONTEXT
from krylov_tpu.solvers._common import (
    SolveResult,
    safe_div,
    scalar_dtype_of,
    tree_select,
)


# Outer-level divergence guard threshold: an outer iteration whose entry
# residual exceeds this multiple of the best residual seen triggers a
# rollback-restart (see cacg_kernel docstring).  Healthy CG/MrR residual
# histories oscillate well under 10x; the post-floor instability grows by
# orders of magnitude per outer (measured: 1.6e-7 -> 1.1e-5 -> 4.9e-3).
_GUARD_GROWTH = 10.0

# Every product in coefficient space and every recovery combination runs at
# full working precision.  At the default precision a float32 matmul may run
# in TF32 on a GPU (10 mantissa bits, ~1e-3 relative error), which breaks
# the Gram-weighted inner products the s inner steps are built on and the
# cross-outer conjugacy of the carried search direction.
_mm = partial(jnp.matmul, precision=lax.Precision.HIGHEST)


def _chebyshev_T(m: int, blocks, lmin: float, lmax: float) -> np.ndarray:
    """Change-of-basis matrix for shifted-scaled Chebyshev chains.

    ``blocks`` lists ``(offset, n_applied)`` per chain: the chain's columns
    start at ``offset`` and A is applied to its first ``n_applied`` columns
    (chain tips — and any extra non-chain columns like CA-MrR's ``z`` — are
    never touched and stay zero).  ``T[:, j]`` holds the coefficients of
    ``A @ V[:, j]`` in the basis.

    From ``rho_0 = 1``, ``rho_1(z) = (z - d)/c``,
    ``rho_{j+1}(z) = 2 (z - d)/c rho_j(z) - rho_{j-1}(z)`` with
    ``d = (lmax+lmin)/2``, ``c = (lmax-lmin)/2``:

        A rho_0 = c rho_1 + d rho_0
        A rho_j = (c/2) rho_{j+1} + d rho_j + (c/2) rho_{j-1}   (j >= 1)
    """
    d = 0.5 * (lmax + lmin)
    c = 0.5 * (lmax - lmin)
    T = np.zeros((m, m), dtype=np.float64)
    for off, cols in blocks:
        if cols <= 0:
            continue
        T[off + 0, off + 0] = d
        T[off + 1, off + 0] = c
        for j in range(1, cols):
            T[off + j - 1, off + j] = 0.5 * c
            T[off + j, off + j] = d
            T[off + j + 1, off + j] = 0.5 * c
    return T


def _monomial_T(m: int, blocks) -> np.ndarray:
    """Change-of-basis matrix for the raw monomial chains (A V_j = V_{j+1})
    — the reference's basis, kept for ablation/parity experiments."""
    T = np.zeros((m, m), dtype=np.float64)
    for off, cols in blocks:
        for j in range(cols):
            T[off + j + 1, off + j] = 1.0
    return T


def cacg_kernel(
    A,
    b,
    x0,
    *,
    tol: float = 1e-5,
    maxiter: int,
    s: int = 4,
    lmin: float = 0.0,
    lmax: float = 0.0,
    basis: str = "chebyshev",
    ctx: Context = DEFAULT_CONTEXT,
    carry_in=None,
    emit_carry: bool = False,
) -> SolveResult:
    """``carry_in=((x, r, p, x_best, res_best), valid)`` resumes exactly
    from a previous chunk's ``result.carry`` (the outer iteration is fully
    determined by these; ``x_best``/``res_best`` thread the divergence
    guard's state); ``emit_carry=True`` returns them.

    ``lmin``/``lmax`` bound the spectrum for the Chebyshev basis (the
    public API fills them with Lanczos estimates); ``basis="monomial"``
    ignores them.

    **Divergence guard**: s-step CG is unstable once the residual reaches
    the working-precision floor — a forced continuation past convergence
    blows up within two outer iterations (CPU: 1.6e-7 -> 1.1e-5 -> 4.9e-3
    at n=16k, s=8), and where the attainable floor sits just above ``tol``
    an un-guarded kernel sails past its best iterate into that
    instability.  The body
    therefore tracks the best iterate seen and, when an outer iteration
    regresses by more than ``_GUARD_GROWTH``x (or goes non-finite), rolls
    back to ``x_best`` and restarts the direction chain from the true
    residual (``p = r = b - A x_best``) — restarted-CG semantics, the same
    shape as the adaptive solver's rollback (reference analog:
    v3/cpu/adaptivekskipmrr.py:44-66).  On exhaustion the best iterate is
    returned, never a diverged one.
    """
    if s < 1:
        raise ValueError(f"s must be >= 1, got {s}")
    blocks = ((0, s), (s + 1, s - 1))  # P chain (s+1 cols), R chain (s cols)
    if basis == "chebyshev":
        if not (lmax > lmin >= 0.0):
            raise ValueError(
                f"chebyshev basis needs spectral bounds lmax > lmin >= 0, "
                f"got [{lmin}, {lmax}]"
            )
        T_np = _chebyshev_T(2 * s + 1, blocks, lmin, lmax)
        d = 0.5 * (lmax + lmin)
        c = 0.5 * (lmax - lmin)
    elif basis == "monomial":
        T_np = _monomial_T(2 * s + 1, blocks)
        d = c = 0.0
    else:
        raise ValueError(f"unknown basis {basis!r}")

    sdt = scalar_dtype_of(ctx, b)
    vdt = b.dtype
    b_norm = ctx.norm(b)
    m = 2 * s + 1
    o = s + 1  # R-block offset
    T = jnp.asarray(T_np, dtype=sdt)

    r0 = b - ctx.matvec(A, x0)
    p0 = r0
    xb0 = x0
    rb0 = jnp.asarray(jnp.inf, dtype=sdt)
    if carry_in is not None:
        (xc, rc, pc, xbc, rbc), valid = carry_in
        x0, r0, p0, xb0, rb0 = tree_select(
            valid, (xc, rc, pc, xbc, rbc), (x0, r0, p0, xb0, rb0)
        )

    max_outer = -(-maxiter // s)  # ceil
    res_trace = jnp.zeros(max_outer + 1, dtype=sdt)
    nosl_trace = jnp.zeros(max_outer + 1, dtype=jnp.int32)

    carry0 = (
        x0,
        r0,
        p0,
        xb0,  # best iterate seen (divergence guard)
        rb0,  # its residual
        jnp.zeros((), jnp.int32),  # i (solution updates)
        jnp.zeros((), jnp.int32),  # index (outer iterations)
        jnp.zeros((), bool),
        res_trace,
        nosl_trace,
    )

    def cond(cst):
        i, converged = cst[5], cst[7]
        return jnp.logical_and(~converged, i < maxiter)

    def _chain(v0, length):
        """[rho_0(A)v .. rho_{length-1}(A)v] via the 3-term recurrence."""
        chain = [v0]
        if length >= 2:
            if basis == "chebyshev":
                chain.append(((ctx.matvec(A, v0) - d * v0) / c).astype(vdt))
            else:
                chain.append(ctx.matvec(A, v0))
        for _ in range(length - 2):
            if basis == "chebyshev":
                nxt = (
                    (2.0 / c) * (ctx.matvec(A, chain[-1]) - d * chain[-1])
                    - chain[-2]
                )
            else:
                nxt = ctx.matvec(A, chain[-1])
            chain.append(nxt.astype(vdt))
        return chain

    def body(cst):
        x, r, p, x_best, res_best, i, index, _, rtrace, ntrace = cst

        V = jnp.stack(_chain(p, s + 1) + _chain(r, s))  # (m, n_local)
        G = ctx.gram(V)  # (m, m) in sdt, ONE psum

        res = jnp.sqrt(G[o, o]) / b_norm
        rtrace = rtrace.at[index].set(res)
        conv = res < tol
        bad = jnp.logical_or(
            ~jnp.isfinite(res), res > _GUARD_GROWTH * res_best
        )
        better = jnp.logical_and(jnp.isfinite(res), res < res_best)
        x_best, res_best = tree_select(
            better, (x, res), (x_best, res_best)
        )

        def rollback(_):
            # Discard this outer's (diverging) basis; restart the chain
            # from the best iterate's TRUE residual.
            r_rb = b - ctx.matvec(A, x_best)
            return x_best, r_rb, r_rb

        def advance(_):
            # s CG steps on (m,)-coefficient vectors (scalar-dtype
            # dataflow).
            p_hat = jnp.zeros(m, sdt).at[0].set(1.0)
            r_hat = jnp.zeros(m, sdt).at[o].set(1.0)
            x_hat = jnp.zeros(m, sdt)
            rGr = G[o, o]
            for _ in range(s):
                w = _mm(T, p_hat)
                alpha = safe_div(rGr, _mm(p_hat, _mm(G, w)))
                x_hat_n = x_hat + alpha * p_hat
                r_hat_n = r_hat - alpha * w
                rGr_new = _mm(r_hat_n, _mm(G, r_hat_n))
                beta = safe_div(rGr_new, rGr)
                p_hat = r_hat_n + beta * p_hat
                x_hat, r_hat, rGr = x_hat_n, r_hat_n, rGr_new

            # Recovery: two tall-skinny combinations + residual
            # replacement, at full precision (see _mm).
            x_n = x + _mm(x_hat.astype(vdt), V)
            p_n = _mm(p_hat.astype(vdt), V)
            r_n = b - ctx.matvec(A, x_n)
            return x_n, r_n, p_n

        x_n, r_n, p_n = lax.cond(bad, rollback, advance, None)

        x, r, p = tree_select(conv, (x, r, p), (x_n, r_n, p_n))
        i = jnp.where(conv, i, i + s)
        index = jnp.where(conv, index, index + 1)
        ntrace = jnp.where(conv, ntrace, ntrace.at[index].set(i))
        return (
            x, r, p, x_best, res_best, i, index, conv, rtrace, ntrace
        )

    (
        x, r, p, x_best, res_best, i, index, converged, rtrace, ntrace
    ) = lax.while_loop(cond, body, carry0)

    # The carry keeps the raw loop state (x, r, p consistent with each
    # other) so chunked continuation resumes the recurrence exactly; only
    # the RESULT's x gets the best-iterate substitution below.
    carry_out = (x, r, p, x_best, res_best) if emit_carry else None

    final_res = ctx.norm(r) / b_norm
    # On exhaustion return the BEST iterate, never a diverged one (its
    # residual is exact: it was measured when x_best was saved).
    use_best = jnp.logical_and(~converged, res_best < final_res)
    x = tree_select(use_best, x_best, x)
    final_res = jnp.where(use_best, res_best, final_res)
    rtrace = jnp.where(converged, rtrace, rtrace.at[index].set(final_res))

    return SolveResult(
        x=x,
        residual_trace=rtrace,
        nosl_trace=ntrace,
        iterations=i,
        index=index,
        converged=converged,
        carry=carry_out,
    )


def camrr_kernel(
    A,
    b,
    x0,
    *,
    tol: float = 1e-5,
    maxiter: int,
    s: int = 4,
    lmin: float = 0.0,
    lmax: float = 0.0,
    basis: str = "chebyshev",
    ctx: Context = DEFAULT_CONTEXT,
    carry_in=None,
    emit_carry: bool = False,
) -> SolveResult:
    """Communication-avoiding MrR with a Chebyshev s-step basis.

    The reference's flagship family is MrR (reference: v3/cpu/mrr.py:7-61,
    k-skip form v3/cpu/kskipmrr.py:8-108); this is its float32-stable
    communication-avoiding form, built the same way as :func:`cacg_kernel`:
    Chebyshev chains from the current ``r`` AND ``y`` (s+1 columns each,
    2s SpMVs per outer), plus the auxiliary ``z`` carried as one extra
    basis column that A is never applied to — MrR's solution update is
    ``x -= z`` so ``z`` only needs to live in the recovery span.  One Gram
    (single psum) serves s MrR steps run entirely on (2s+3)-long
    coefficient vectors:

        Ar      = T r̂
        gamma   = <y, Ar>_G / <y, y>_G
        s_vec   = Ar - gamma y          (reference: v3/cpu/mrr.py:38-41)
        zeta    = <r, s_vec>_G / <s_vec, s_vec>_G
        eta     = -zeta gamma
        ŷ <- eta ŷ + zeta Ar;  ẑ <- eta ẑ - zeta r̂;  r̂ <- r̂ - ŷ

    Recovery combines x/y/z from the basis and recomputes ``r = b - A x``
    (residual replacement).  ``carry_in=((x, r, y, z, x_best, res_best),
    valid)`` resumes exactly; ``emit_carry=True`` returns that state.

    Carries the same outer-level divergence guard as :func:`cacg_kernel`
    (best-iterate tracking; rollback on non-finite or >10x-regressed
    residual, restarting y/z via the MrR init half-step — the reference's
    adaptive rollback shape, v3/cpu/adaptivekskipmrr.py:44-66).  The guard
    is insurance that a stagnated run returns its best iterate instead of a
    diverged one.
    """
    if s < 1:
        raise ValueError(f"s must be >= 1, got {s}")
    m = 2 * s + 3  # r-chain (s+1) + y-chain (s+1) + z column
    o = s + 1  # y-chain offset
    oz = 2 * s + 2  # z column
    blocks = ((0, s), (o, s))
    if basis == "chebyshev":
        if not (lmax > lmin >= 0.0):
            raise ValueError(
                f"chebyshev basis needs spectral bounds lmax > lmin >= 0, "
                f"got [{lmin}, {lmax}]"
            )
        T_np = _chebyshev_T(m, blocks, lmin, lmax)
        d = 0.5 * (lmax + lmin)
        c = 0.5 * (lmax - lmin)
    elif basis == "monomial":
        T_np = _monomial_T(m, blocks)
        d = c = 0.0
    else:
        raise ValueError(f"unknown basis {basis!r}")

    sdt = scalar_dtype_of(ctx, b)
    vdt = b.dtype
    b_norm = ctx.norm(b)
    T = jnp.asarray(T_np, dtype=sdt)

    # MrR init half-iteration (reference: v3/cpu/mrr.py:20-31).
    r = b - ctx.matvec(A, x0)
    Ar1 = ctx.matvec(A, r)
    rAr, ArAr = ctx.dot_bundle([(r, Ar1), (Ar1, Ar1)])
    zeta0 = safe_div(rAr, ArAr)
    y0 = (zeta0 * Ar1).astype(vdt)
    z0 = (-zeta0 * r).astype(vdt)
    r0 = r - y0
    x_init = x0 - z0

    i0 = jnp.ones((), jnp.int32)
    index0 = jnp.ones((), jnp.int32)
    x_c, r_c, y_c, z_c = x_init, r0, y0, z0
    xb0 = x_init
    rb0 = jnp.asarray(jnp.inf, dtype=sdt)
    if carry_in is not None:
        (xc, rc, yc, zc, xbc, rbc), valid = carry_in
        x_c, r_c, y_c, z_c, xb0, rb0 = tree_select(
            valid, (xc, rc, yc, zc, xbc, rbc),
            (x_c, r_c, y_c, z_c, xb0, rb0),
        )
        i0 = jnp.where(valid, 0, i0).astype(jnp.int32)
        index0 = jnp.where(valid, 0, index0).astype(jnp.int32)

    max_outer = 1 + (-(-maxiter // s))
    res_trace = jnp.zeros(max_outer + 1, dtype=sdt)
    nosl_trace = jnp.zeros(max_outer + 1, dtype=jnp.int32)
    res_trace = res_trace.at[0].set(ctx.norm(b - ctx.matvec(A, x0)) / b_norm)
    nosl_trace = nosl_trace.at[1].set(1)

    carry0 = (
        x_c, r_c, y_c, z_c,
        xb0, rb0,
        i0, index0,
        jnp.zeros((), bool),
        res_trace, nosl_trace,
    )

    def cond(cst):
        i, converged = cst[6], cst[8]
        return jnp.logical_and(~converged, i < maxiter)

    def _chain(v0, length):
        chain = [v0]
        if length >= 2:
            if basis == "chebyshev":
                chain.append(((ctx.matvec(A, v0) - d * v0) / c).astype(vdt))
            else:
                chain.append(ctx.matvec(A, v0))
        for _ in range(length - 2):
            if basis == "chebyshev":
                nxt = (
                    (2.0 / c) * (ctx.matvec(A, chain[-1]) - d * chain[-1])
                    - chain[-2]
                )
            else:
                nxt = ctx.matvec(A, chain[-1])
            chain.append(nxt.astype(vdt))
        return chain

    def body(cst):
        x, r, y, z, x_best, res_best, i, index, _, rtrace, ntrace = cst

        V = jnp.stack(_chain(r, s + 1) + _chain(y, s + 1) + [z])
        G = ctx.gram(V)  # ONE psum per s MrR steps

        res = jnp.sqrt(G[0, 0]) / b_norm
        rtrace = rtrace.at[index].set(res)
        conv = res < tol
        bad = jnp.logical_or(
            ~jnp.isfinite(res), res > _GUARD_GROWTH * res_best
        )
        better = jnp.logical_and(jnp.isfinite(res), res < res_best)
        x_best, res_best = tree_select(
            better, (x, res), (x_best, res_best)
        )

        def rollback(_):
            # Restart from the best iterate via the MrR init half-step
            # (reference: v3/cpu/mrr.py:20-31) — one extra matvec + one
            # dot_bundle, only on the (rare) rollback branch.
            r_rb = b - ctx.matvec(A, x_best)
            Ar1 = ctx.matvec(A, r_rb)
            rAr_rb, ArAr_rb = ctx.dot_bundle([(r_rb, Ar1), (Ar1, Ar1)])
            zeta_rb = safe_div(rAr_rb, ArAr_rb)
            y_rb = (zeta_rb * Ar1).astype(vdt)
            z_rb = (-zeta_rb * r_rb).astype(vdt)
            return (
                x_best - z_rb, (r_rb - y_rb).astype(vdt), y_rb, z_rb
            )

        def advance(_):
            r_hat = jnp.zeros(m, sdt).at[0].set(1.0)
            y_hat = jnp.zeros(m, sdt).at[o].set(1.0)
            z_hat = jnp.zeros(m, sdt).at[oz].set(1.0)
            x_hat = jnp.zeros(m, sdt)
            for _ in range(s):
                Ar_hat = _mm(T, r_hat)
                Gy = _mm(G, y_hat)
                gamma = safe_div(_mm(Ar_hat, Gy), _mm(y_hat, Gy))
                s_hat = Ar_hat - gamma * y_hat
                Gs = _mm(G, s_hat)
                zeta = safe_div(_mm(r_hat, Gs), _mm(s_hat, Gs))
                eta = -zeta * gamma
                y_hat = eta * y_hat + zeta * Ar_hat
                z_hat = eta * z_hat - zeta * r_hat
                r_hat = r_hat - y_hat
                x_hat = x_hat - z_hat

            x_n = x + _mm(x_hat.astype(vdt), V)
            y_n = _mm(y_hat.astype(vdt), V)
            z_n = _mm(z_hat.astype(vdt), V)
            r_n = b - ctx.matvec(A, x_n)  # residual replacement
            return x_n, r_n, y_n, z_n

        x_n, r_n, y_n, z_n = lax.cond(bad, rollback, advance, None)

        x, r, y, z = tree_select(
            conv, (x, r, y, z), (x_n, r_n, y_n, z_n)
        )
        i = jnp.where(conv, i, i + s)
        index = jnp.where(conv, index, index + 1)
        ntrace = jnp.where(conv, ntrace, ntrace.at[index].set(i))
        return (
            x, r, y, z, x_best, res_best, i, index, conv, rtrace, ntrace
        )

    (
        x, r, y, z, x_best, res_best, i, index, converged, rtrace, ntrace
    ) = lax.while_loop(cond, body, carry0)

    carry_out = (x, r, y, z, x_best, res_best) if emit_carry else None

    final_res = ctx.norm(r) / b_norm
    use_best = jnp.logical_and(~converged, res_best < final_res)
    x = tree_select(use_best, x_best, x)
    final_res = jnp.where(use_best, res_best, final_res)
    rtrace = jnp.where(converged, rtrace, rtrace.at[index].set(final_res))

    return SolveResult(
        x=x,
        residual_trace=rtrace,
        nosl_trace=ntrace,
        iterations=i,
        index=index,
        converged=converged,
        carry=carry_out,
    )
