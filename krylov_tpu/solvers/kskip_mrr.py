"""Communication-avoiding k-skip MrR.

Algorithm semantics follow the reference (reference: v3/cpu/kskipmrr.py:8-108):
an MrR init half-iteration, then outer iterations that build bases
``Ar[0..k+1]``, ``Ay[0..k]``, evaluate the bundles

    alpha[j] = <Ar[j//2], Ar[j//2 + j%2]>   j = 0..2k+2
    beta[j]  = <Ay[j//2], Ar[j//2 + j%2]>   j = 1..2k+1   (beta[0] = 0)
    delta[j] = <Ay[j//2], Ay[j//2 + j%2]>   j = 0..2k

and perform k+1 MrR steps via scalar recurrences (reference:
v3/cpu/kskipmrr.py:72-93), each with one SpMV ``Ar[1] = A @ Ar[0]``.

Redesign (same as :mod:`krylov_tpu.solvers.kskip_cg`): the 6k+6
bundle entries are read out of ONE Gram matrix of the stacked basis
``B = [Ar[0..k+1]; Ay[0..k]]`` — a single matmul + a single ``psum``.

One reference inefficiency is intentionally NOT replicated: the reference
recomputes ``Ar[1] = A @ Ar[0]`` at the top of every outer basis loop
(reference: v3/cpu/kskipmrr.py:46-47) even though the tail of the previous
inner step just computed exactly that value (reference:
v3/cpu/kskipmrr.py:92).  Here ``Ar[1]`` is carried across outer iterations
(seeded with one extra SpMV after the init phase), saving one SpMV per outer
iteration with bit-identical numerics.

Basis stabilization (``basis_norm=True``): the raw monomial basis
``A^j r`` degenerates in working precision — ``||A^j r||`` grows like
``lambda_max^j`` and in float32 the Gram entries overflow outright at
k=8 on stiff operators (NaN), while the recurrences lose everything to
cancellation well before that.  With
``basis_norm`` each new basis vector is scaled to unit norm as it is
built and the cumulative scale factors are carried in the SCALAR dtype;
the Gram of the normalized basis (all entries O(1)) is then rescaled by
``outer(c, c)`` so alpha/beta/delta take exactly their mathematical
values — exact algebra, no approximation, and the recurrences are
untouched.  Scope of the fix: normalization prevents the GRAM OVERFLOW
failure mode (with ``scalar_dtype=float64`` the adaptive solver converges
where the raw basis gives NaN) but it does NOT repair the recurrences'
kappa^k cancellation: plain monomial k-skip MrR can still reach NaN with
basis_norm at large k on ill-conditioned systems.  For stiff systems at large skip sizes use
the Chebyshev-basis methods (``cacg``/``camrr``), whose Gram entries
stay O(||r||^2) by construction; basis_norm + adaptive k is the
monomial-family fallback.  Costs: one extra norm reduction per basis vector, batched in
pairs across the Ar/Ay chains (k+1 extra fused psums per outer iteration
when distributed).  The vector updates are unaffected (they only consume
the carried true ``Ar[1]``, never the higher powers).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from krylov_tpu.context import Context, DEFAULT_CONTEXT
from krylov_tpu.solvers._common import (
    SolveResult,
    pow2_scale,
    safe_div,
    scalar_dtype_of,
    tree_select,
)


def _mrr_vector_step(ctx, A, vdt, zeta, eta, x, r, y, z, Ar1):
    """The shared MrR solution update (reference: v3/cpu/kskipmrr.py:65-70)."""
    y = (eta * y + zeta * Ar1).astype(vdt)
    z = (eta * z - zeta * r).astype(vdt)
    r = r - y
    Ar1 = ctx.matvec(A, r)
    x = x - z
    return x, r, y, z, Ar1


def kskipmrr_kernel(
    A,
    b,
    x0,
    *,
    tol: float = 1e-5,
    maxiter: int,
    k: int = 0,
    ctx: Context = DEFAULT_CONTEXT,
    carry_in=None,
    emit_carry: bool = False,
    basis_norm: bool = False,
) -> SolveResult:
    """``carry_in=((x, r, y, z, Ar1), valid)`` resumes exactly from a
    previous chunk's ``result.carry`` (the outer iteration is fully
    determined by these five vectors); ``emit_carry=True`` returns them.
    See ``solve(chunk_iters=)``.  ``basis_norm`` enables normalized-basis
    construction (see module docstring)."""
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    sdt = scalar_dtype_of(ctx, b)
    vdt = b.dtype
    b_norm = ctx.norm(b)

    # index grows by 1 per outer iteration, i by k+1; i starts at 1.
    max_index = 1 + max(0, -(-(maxiter - 1) // (k + 1))) if maxiter > 0 else 1
    res_trace = jnp.zeros(max_index + 1, dtype=sdt)
    nosl_trace = jnp.zeros(max_index + 1, dtype=jnp.int32)

    # Initial residual + init half-iteration (reference: v3/cpu/kskipmrr.py:20-34).
    r = b - ctx.matvec(A, x0)
    res_trace = res_trace.at[0].set(ctx.norm(r) / b_norm)
    Ar1 = ctx.matvec(A, r)
    rAr, ArAr = ctx.dot_bundle([(r, Ar1), (Ar1, Ar1)])
    zeta = safe_div(rAr, ArAr)
    y = (zeta * Ar1).astype(vdt)
    z = (-zeta * r).astype(vdt)
    r = r - y
    x = x0 - z
    nosl_trace = nosl_trace.at[1].set(1)
    # Seed the carried Ar[1] (see module docstring).
    Ar1 = ctx.matvec(A, r)

    i0 = jnp.ones((), jnp.int32)
    index0 = jnp.ones((), jnp.int32)
    if carry_in is not None:
        # Carried chunk: keep the carried state (no init half-iteration) and
        # start local counters at 0 — the body records the carried residual
        # in trace slot 0.
        (xc, rc, yc, zc, Ar1c), valid = carry_in
        x, r, y, z, Ar1 = tree_select(
            valid, (xc, rc, yc, zc, Ar1c), (x, r, y, z, Ar1)
        )
        i0 = jnp.where(valid, 0, i0).astype(jnp.int32)
        index0 = jnp.where(valid, 0, index0).astype(jnp.int32)

    carry0 = (
        x,
        r,
        y,
        z,
        Ar1,
        i0,
        index0,
        jnp.zeros((), bool),
        res_trace,
        nosl_trace,
    )

    KA = k + 2  # offset of the Ay block in the stacked basis

    def cond(c):
        i, converged = c[5], c[7]
        return jnp.logical_and(~converged, i < maxiter)

    def _inv(s, vdt_):
        # Exact reciprocal: s is a power of two (pow2_scale), never zero.
        return (1.0 / s).astype(vdt_)

    def body(c):
        x, r, y, z, Ar1, i, index, _, rtrace, ntrace = c

        if basis_norm:
            # Normalized monomial basis with carried cumulative scales (see
            # module docstring): V rows are unit-norm, c holds the exact
            # scale of each true basis vector in the scalar dtype, and the
            # rescaled Gram equals the true-bundle Gram exactly.
            s2 = ctx.dot_bundle([(r, r), (Ar1, Ar1), (y, y)])
            s_r0 = pow2_scale(jnp.sqrt(s2[0]))
            s_r1 = pow2_scale(jnp.sqrt(s2[1]))
            s_y0 = pow2_scale(jnp.sqrt(s2[2]))
            Vr = [r * _inv(s_r0, vdt), Ar1 * _inv(s_r1, vdt)]
            Vy = [y * _inv(s_y0, vdt)]
            c_r = [s_r0, s_r1]
            c_y = [s_y0]
            for _ in range(k):
                Wr = ctx.matvec(A, Vr[-1])
                Wy = ctx.matvec(A, Vy[-1])
                n2 = ctx.dot_bundle([(Wr, Wr), (Wy, Wy)])
                nr = pow2_scale(jnp.sqrt(n2[0]))
                ny = pow2_scale(jnp.sqrt(n2[1]))
                Vr.append(Wr * _inv(nr, vdt))
                c_r.append(c_r[-1] * nr)
                Vy.append(Wy * _inv(ny, vdt))
                c_y.append(c_y[-1] * ny)
            cs = jnp.stack(c_r + c_y)
            G = ctx.gram(jnp.stack(Vr + Vy)) * (cs[:, None] * cs[None, :])
            Ar = [r, Ar1]  # vector updates consume only the true Ar[1]
        else:
            # Bases: Ar[0..k+1] (Ar[1] carried), Ay[0..k] — 2k SpMVs.
            Ar = [r, Ar1]
            for _ in range(k):
                Ar.append(ctx.matvec(A, Ar[-1]))
            Ay = [y]
            for _ in range(k):
                Ay.append(ctx.matvec(A, Ay[-1]))

            B = jnp.stack(Ar + Ay)
            G = ctx.gram(B)

        alpha = [G[j // 2, j // 2 + j % 2] for j in range(2 * k + 3)]
        beta = [jnp.zeros((), sdt)] + [
            G[KA + j // 2, j // 2 + j % 2] for j in range(1, 2 * k + 2)
        ]
        delta = [G[KA + j // 2, KA + j // 2 + j % 2] for j in range(2 * k + 1)]

        res = jnp.sqrt(alpha[0]) / b_norm
        rtrace = rtrace.at[index].set(res)
        conv = res < tol

        # MrR step 1 (reference: v3/cpu/kskipmrr.py:62-70).
        d = alpha[2] * delta[0] - beta[1] ** 2
        zeta = safe_div(alpha[1] * delta[0], d)
        eta = -safe_div(alpha[1] * beta[1], d)
        x_n, r_n, y_n, z_n, Ar1_n = _mrr_vector_step(
            ctx, A, vdt, zeta, eta, x, r, y, z, Ar[1]
        )

        # k scalar-recurrence steps (reference: v3/cpu/kskipmrr.py:72-93).
        for j in range(k):
            delta[0] = zeta**2 * alpha[2] + eta * zeta * beta[1]
            alpha[0] = alpha[0] - zeta * alpha[1]
            delta[1] = (
                eta**2 * delta[1] + 2 * eta * zeta * beta[2] + zeta**2 * alpha[3]
            )
            beta[1] = eta * beta[1] + zeta * alpha[2] - delta[1]
            alpha[1] = -beta[1]
            for l in range(2, 2 * (k - j) + 1):
                delta[l] = (
                    eta**2 * delta[l]
                    + 2 * eta * zeta * beta[l + 1]
                    + zeta**2 * alpha[l + 2]
                )
                tau = eta * beta[l] + zeta * alpha[l + 1]
                beta[l] = tau - delta[l]
                alpha[l] = alpha[l] - tau - beta[l]
            d = alpha[2] * delta[0] - beta[1] ** 2
            zeta = safe_div(alpha[1] * delta[0], d)
            eta = -safe_div(alpha[1] * beta[1], d)
            x_n, r_n, y_n, z_n, Ar1_n = _mrr_vector_step(
                ctx, A, vdt, zeta, eta, x_n, r_n, y_n, z_n, Ar1_n
            )

        x, r, y, z, Ar1 = tree_select(
            conv, (x, r, y, z, Ar1), (x_n, r_n, y_n, z_n, Ar1_n)
        )
        i = jnp.where(conv, i, i + (k + 1))
        index = jnp.where(conv, index, index + 1)
        ntrace = jnp.where(conv, ntrace, ntrace.at[index].set(i))
        return (x, r, y, z, Ar1, i, index, conv, rtrace, ntrace)

    x, r, y, z, Ar1, i, index, converged, rtrace, ntrace = lax.while_loop(
        cond, body, carry0
    )

    final_res = ctx.norm(r) / b_norm
    rtrace = jnp.where(converged, rtrace, rtrace.at[index].set(final_res))

    return SolveResult(
        x=x,
        residual_trace=rtrace,
        nosl_trace=ntrace,
        iterations=i,
        index=index,
        converged=converged,
        carry=(x, r, y, z, Ar1) if emit_carry else None,
    )
