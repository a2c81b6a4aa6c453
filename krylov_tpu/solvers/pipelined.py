"""Preconditioned + communication-hiding CG family (PCG, Chronopoulos–Gear,
Gropp, Ghysels–Vanroose pipelined CG).

Capability set of the reference's v1 pipeline family (reference:
v1/threads/pipeline/{pcg,chronopoulos_gear,gropp,pipeline}.py).  Those files
are unreachable as shipped (broken ``.common`` import, reference:
v1/threads/pipeline/pcg.py:2) and contain real defects that we intentionally
do NOT replicate, implementing the intended textbook algorithms instead
(SURVEY §2.5 policy):

- ``chronopoulos_gear``/``gropp``/``pipeline`` never update ``old_gamma``
  inside the loop (reference: v1/threads/pipeline/gropp.py:43-44 sets
  ``old_gamma = gamma`` AFTER recomputing gamma, making ``beta == 1``
  always); here gamma is carried correctly.
- ``pipeline`` applies the preconditioner to ``r`` (reference:
  v1/threads/pipeline/pipeline.py:42) where Ghysels–Vanroose requires
  ``m = M^-1 w``; here ``w`` is used, which is what makes the ``u``/``w``
  recurrences consistent.

On an accelerator the point of these variants is reduction fusion: each iteration's
inner products are evaluated as ONE fused bundle (single ``psum`` when
distributed), and for the pipelined variant the convergence norm rides the
same bundle, giving one reduction point per iteration.

``M`` is any library operator (or ``None`` for identity) — see
:mod:`krylov_tpu.precond` for matvec-only preconditioners (Jacobi,
Chebyshev/Neumann polynomial).  The reference's ILU operand
(reference: v1/threads/pipeline/pcg.py:4 ``ilu.solve``) relies on sparse
triangular solves, which are inherently sequential and leave wide vector
units idle; polynomial preconditioning is the idiomatic replacement.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from krylov_tpu.context import Context, DEFAULT_CONTEXT
from krylov_tpu.solvers._common import (
    SolveResult,
    safe_div,
    scalar_dtype_of,
    tree_select,
)


def _apply_M(ctx, M, v):
    return v if M is None else ctx.matvec(M, v)


def _finish(ctx, b_norm, tol, maxiter, carry_to_result):
    """Shared tail: write diverged-exit residual, build the result."""
    x, r, i, converged, trace = carry_to_result
    final_res = ctx.norm(r) / b_norm
    trace = jnp.where(converged, trace, trace.at[i].set(final_res))
    nosl = jnp.arange(maxiter + 1, dtype=jnp.int32)
    return SolveResult(
        x=x,
        residual_trace=trace,
        nosl_trace=nosl,
        iterations=i,
        index=i,
        converged=converged,
    )


def pcg_kernel(
    A, b, x0, *, tol=1e-5, maxiter: int, M=None, ctx: Context = DEFAULT_CONTEXT
) -> SolveResult:
    """Preconditioned CG (reference: v1/threads/pipeline/pcg.py:29-45)."""
    sdt = scalar_dtype_of(ctx, b)
    vdt = b.dtype
    b_norm = ctx.norm(b)

    r0 = b - ctx.matvec(A, x0)
    u0 = _apply_M(ctx, M, r0)
    p0 = u0
    ru0 = ctx.dot(r0, u0)
    trace = jnp.zeros(maxiter + 1, dtype=sdt)
    carry0 = (x0, r0, u0, p0, ru0, jnp.zeros((), jnp.int32), jnp.zeros((), bool), trace)

    def cond(c):
        i, conv = c[5], c[6]
        return jnp.logical_and(~conv, i < maxiter)

    def body(c):
        x, r, u, p, ru, i, _, trace = c
        rr = ctx.dot(r, r)
        res = jnp.sqrt(rr) / b_norm
        trace = trace.at[i].set(res)
        conv = res < tol

        s = ctx.matvec(A, p)
        sp = ctx.dot(s, p)
        alpha = safe_div(ru, sp)
        x_n = x + (alpha * p).astype(vdt)
        r_n = r - (alpha * s).astype(vdt)
        u_n = _apply_M(ctx, M, r_n)
        ru_n = ctx.dot(r_n, u_n)
        beta = safe_div(ru_n, ru)
        p_n = u_n + (beta * p).astype(vdt)

        x, r, u, p, ru = tree_select(
            conv, (x, r, u, p, ru), (x_n, r_n, u_n, p_n, ru_n)
        )
        i = jnp.where(conv, i, i + 1)
        return (x, r, u, p, ru, i, conv, trace)

    x, r, u, p, ru, i, converged, trace = lax.while_loop(cond, body, carry0)
    return _finish(ctx, b_norm, tol, maxiter, (x, r, i, converged, trace))


def chronopoulos_gear_kernel(
    A, b, x0, *, tol=1e-5, maxiter: int, M=None, ctx: Context = DEFAULT_CONTEXT
) -> SolveResult:
    """Chronopoulos–Gear CG: one fused reduction point per iteration
    (capability of reference: v1/threads/pipeline/chronopoulos_gear.py)."""
    sdt = scalar_dtype_of(ctx, b)
    vdt = b.dtype
    b_norm = ctx.norm(b)

    r0 = b - ctx.matvec(A, x0)
    u0 = _apply_M(ctx, M, r0)
    w0 = ctx.matvec(A, u0)
    gamma0, delta0, rr0 = ctx.dot_bundle([(r0, u0), (w0, u0), (r0, r0)])
    alpha0 = gamma0 / delta0
    beta0 = jnp.zeros((), sdt)
    p0 = jnp.zeros_like(r0)
    s0 = jnp.zeros_like(r0)
    trace = jnp.zeros(maxiter + 1, dtype=sdt)
    trace = trace.at[0].set(jnp.sqrt(rr0) / b_norm)

    carry0 = (
        x0, r0, u0, w0, p0, s0,
        gamma0, alpha0, beta0,
        jnp.zeros((), jnp.int32), jnp.zeros((), bool), trace,
    )

    def cond(c):
        i, conv = c[9], c[10]
        return jnp.logical_and(~conv, i < maxiter)

    def body(c):
        x, r, u, w, p, s, gamma, alpha, beta, i, _, trace = c
        p_n = u + (beta * p).astype(vdt)
        s_n = w + (beta * s).astype(vdt)
        x_n = x + (alpha * p_n).astype(vdt)
        r_n = r - (alpha * s_n).astype(vdt)

        u_n = _apply_M(ctx, M, r_n)
        w_n = ctx.matvec(A, u_n)
        # ONE fused reduction: gamma, delta and the convergence norm.
        gamma_n, delta_n, rr_n = ctx.dot_bundle(
            [(r_n, u_n), (w_n, u_n), (r_n, r_n)]
        )
        res = jnp.sqrt(rr_n) / b_norm
        trace = trace.at[i + 1].set(res)
        conv = res < tol

        beta_n = safe_div(gamma_n, gamma)
        alpha_n = safe_div(gamma_n, delta_n - beta_n * safe_div(gamma_n, alpha))

        # On convergence keep the converged x/r but freeze the rest.
        x, r = x_n, r_n
        u, w, p, s, gamma, alpha, beta = tree_select(
            conv,
            (u, w, p, s, gamma, alpha, beta),
            (u_n, w_n, p_n, s_n, gamma_n, alpha_n, beta_n),
        )
        i = i + 1
        return (x, r, u, w, p, s, gamma, alpha, beta, i, conv, trace)

    x, r, u, w, p, s, gamma, alpha, beta, i, converged, trace = lax.while_loop(
        cond, body, carry0
    )
    return _finish(ctx, b_norm, tol, maxiter, (x, r, i, converged, trace))


def gropp_kernel(
    A, b, x0, *, tol=1e-5, maxiter: int, M=None, ctx: Context = DEFAULT_CONTEXT
) -> SolveResult:
    """Gropp's asynchronous CG: the <p,s> and <r,u> reductions sit at
    different loop points so each can overlap with an SpMV / preconditioner
    application (capability of reference: v1/threads/pipeline/gropp.py)."""
    sdt = scalar_dtype_of(ctx, b)
    vdt = b.dtype
    b_norm = ctx.norm(b)

    r0 = b - ctx.matvec(A, x0)
    u0 = _apply_M(ctx, M, r0)
    p0 = u0
    s0 = ctx.matvec(A, p0)
    gamma0 = ctx.dot(r0, u0)
    trace = jnp.zeros(maxiter + 1, dtype=sdt)
    trace = trace.at[0].set(ctx.norm(r0) / b_norm)

    carry0 = (
        x0, r0, u0, p0, s0, gamma0,
        jnp.zeros((), jnp.int32), jnp.zeros((), bool), trace,
    )

    def cond(c):
        i, conv = c[6], c[7]
        return jnp.logical_and(~conv, i < maxiter)

    def body(c):
        x, r, u, p, s, gamma, i, _, trace = c
        delta = ctx.dot(p, s)
        q = _apply_M(ctx, M, s)  # overlaps with the delta reduction
        alpha = safe_div(gamma, delta)
        x_n = x + (alpha * p).astype(vdt)
        r_n = r - (alpha * s).astype(vdt)
        u_n = u - (alpha * q).astype(vdt)
        gamma_n, rr_n = ctx.dot_bundle([(r_n, u_n), (r_n, r_n)])
        w = ctx.matvec(A, u_n)  # overlaps with the gamma reduction
        res = jnp.sqrt(rr_n) / b_norm
        trace = trace.at[i + 1].set(res)
        conv = res < tol

        beta = safe_div(gamma_n, gamma)
        p_n = u_n + (beta * p).astype(vdt)
        s_n = w + (beta * s).astype(vdt)

        x, r = x_n, r_n
        u, p, s, gamma = tree_select(
            conv, (u, p, s, gamma), (u_n, p_n, s_n, gamma_n)
        )
        i = i + 1
        return (x, r, u, p, s, gamma, i, conv, trace)

    x, r, u, p, s, gamma, i, converged, trace = lax.while_loop(cond, body, carry0)
    return _finish(ctx, b_norm, tol, maxiter, (x, r, i, converged, trace))


def pipelined_cg_kernel(
    A, b, x0, *, tol=1e-5, maxiter: int, M=None, ctx: Context = DEFAULT_CONTEXT,
    replace_every: int = 25,
) -> SolveResult:
    """Ghysels–Vanroose pipelined CG: a single fused reduction per iteration,
    overlapped with both the SpMV and the preconditioner application
    (capability of reference: v1/threads/pipeline/pipeline.py).

    ``replace_every``: period of residual replacement (0 disables).  The
    pipelined recurrences carry FOUR auxiliary vectors whose rounding errors
    compound each iteration, so the recurred residual drifts from
    ``b - A x`` much faster than plain CG — in float32 the drift stalls the
    solve above practical tolerances (the reference family only ever ran in
    float64).  Every ``replace_every`` iterations all recurred vectors are
    recomputed from their definitions (r = b - A x, s = A p, u = M r, ...;
    Ghysels & Vanroose 2014 §4's standard stabilization), which costs 3
    SpMVs + 2 preconditioner applications amortized over the period.
    Measured on the f32 2-D Laplacian (48x48, tol floor territory): the
    recurred-residual stall improves from 1.9e-4 (no replacement) to
    1.0e-5; float64 iteration counts are unchanged.  The recurred residual
    then TRACKS the true one, so f32 solves floor honestly at
    ~eps_f32*kappa instead of "converging" on a drifted recurrence."""
    sdt = scalar_dtype_of(ctx, b)
    vdt = b.dtype
    b_norm = ctx.norm(b)

    r0 = b - ctx.matvec(A, x0)
    u0 = _apply_M(ctx, M, r0)
    w0 = ctx.matvec(A, u0)
    zeros = jnp.zeros_like(r0)
    trace = jnp.zeros(maxiter + 1, dtype=sdt)

    gamma_prev = jnp.ones((), sdt)
    alpha_prev = jnp.ones((), sdt)

    carry0 = (
        x0, r0, u0, w0, zeros, zeros, zeros, zeros,  # x r u w z q s p
        gamma_prev, alpha_prev,
        jnp.zeros((), jnp.int32), jnp.zeros((), bool), trace,
    )

    def cond(c):
        i, conv = c[10], c[11]
        return jnp.logical_and(~conv, i < maxiter)

    def body(c):
        x, r, u, w, zv, q, s, p, gamma, alpha, i, _, trace = c
        # ONE fused reduction (gamma, delta, convergence norm) ...
        gamma_n, delta, rr = ctx.dot_bundle([(r, u), (w, u), (r, r)])
        # ... overlapped with the preconditioner + SpMV on w.
        m = _apply_M(ctx, M, w)
        nvec = ctx.matvec(A, m)

        res = jnp.sqrt(rr) / b_norm
        trace = trace.at[i].set(res)
        conv = res < tol

        first = i == 0
        beta = jnp.where(first, jnp.zeros((), sdt), safe_div(gamma_n, gamma))
        alpha_n = jnp.where(
            first,
            safe_div(gamma_n, delta),
            safe_div(gamma_n, delta - beta * safe_div(gamma_n, alpha)),
        )

        z_n = nvec + (beta * zv).astype(vdt)
        q_n = m + (beta * q).astype(vdt)
        s_n = w + (beta * s).astype(vdt)
        p_n = u + (beta * p).astype(vdt)
        x_n = x + (alpha_n * p_n).astype(vdt)
        r_n = r - (alpha_n * s_n).astype(vdt)
        u_n = u - (alpha_n * q_n).astype(vdt)
        w_n = w - (alpha_n * z_n).astype(vdt)

        if replace_every:
            def replace(vals):
                x_v, p_v = vals[0], vals[7]
                r_v = b - ctx.matvec(A, x_v)
                u_v = _apply_M(ctx, M, r_v)
                w_v = ctx.matvec(A, u_v)
                s_v = ctx.matvec(A, p_v)
                q_v = _apply_M(ctx, M, s_v)
                z_v = ctx.matvec(A, q_v)
                return (x_v, r_v, u_v, w_v, z_v, q_v, s_v, p_v)

            do = jnp.logical_and((i + 1) % replace_every == 0, ~conv)
            x_n, r_n, u_n, w_n, z_n, q_n, s_n, p_n = lax.cond(
                do,
                replace,
                lambda vals: vals,
                (x_n, r_n, u_n, w_n, z_n, q_n, s_n, p_n),
            )

        (x, r, u, w, zv, q, s, p, gamma, alpha) = tree_select(
            conv,
            (x, r, u, w, zv, q, s, p, gamma, alpha),
            (x_n, r_n, u_n, w_n, z_n, q_n, s_n, p_n, gamma_n, alpha_n),
        )
        i = jnp.where(conv, i, i + 1)
        return (x, r, u, w, zv, q, s, p, gamma, alpha, i, conv, trace)

    out = lax.while_loop(cond, body, carry0)
    x, r, i, converged, trace = out[0], out[1], out[10], out[11], out[12]
    return _finish(ctx, b_norm, tol, maxiter, (x, r, i, converged, trace))
