"""Communication-avoiding k-skip CG.

Algorithm semantics follow the reference (reference: v3/cpu/kskipcg.py:8-87):
each outer iteration builds Krylov bases ``Ar[0..k]`` and ``Ap[0..k+1]``,
evaluates the coefficient bundles

    a[j] = <Ar[j//2], Ar[j//2 + j%2]>      j = 0..2k
    f[j] = <Ap[j//2], Ap[j//2 + j%2]>      j = 0..2k+2   (f[2k+3] = 0, unread)
    c[j] = <Ar[j//2], Ap[j//2 + j%2]>      j = 0..2k+1

and then performs k+1 CG steps where the inner products are advanced by
scalar recurrences only (reference: v3/cpu/kskipcg.py:59-64).

Redesign of the bundle: all of a/f/c are entries of the Gram
matrix of the stacked basis ``B = [Ar[0..k]; Ap[0..k+1]]`` — one
(2k+3) x (2k+3) Gram computed as a single matmul ``B @ B.T`` and, when
distributed, reduced with ONE ``psum`` (the reference instead computes the
6k+8 dot products one by one, redundantly on every rank after allgathering
the bases — reference: v3/cpu/mpi/kskipcg.py analog of
v3/cpu/mpi/kskipmrr.py:64-73).  ``k`` is static, so the scalar recurrences
unroll at trace time into pure scalar dataflow (the role of the reference's
absent Cython ``scalar_iteration`` kernel, reference:
v1/processes/adaptivekskipmrr.py:5).

The convergence check reads ``sqrt(a[0]) = ||r||`` from the Gram matrix, so
it costs no extra reduction.

``basis_norm=True`` builds the Krylov chains with per-vector normalization
and carries the cumulative scale factors in the scalar dtype, rescaling the
Gram by ``outer(c, c)`` so a/f/c take exactly their mathematical values —
exact algebra that prevents the float32 overflow/cancellation collapse of
the raw monomial basis on stiff operators (full rationale:
:mod:`krylov_tpu.solvers.kskip_mrr` module docstring).  The CG vector
updates consume only the true ``p`` and ``A p``, which are kept unscaled.
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


def kskipcg_kernel(
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
    """``carry_in=((x, r, p), valid)`` resumes exactly from a previous
    chunk's ``result.carry``; ``emit_carry=True`` returns the post-loop
    state.  See ``solve(chunk_iters=)``.  ``basis_norm`` enables
    normalized-basis construction (see module docstring)."""
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    sdt = scalar_dtype_of(ctx, b)
    b_norm = ctx.norm(b)
    vdt = b.dtype

    r0 = b - ctx.matvec(A, x0)
    p0 = r0
    if carry_in is not None:
        (xc, rc, pc), valid = carry_in
        x0, r0, p0 = tree_select(valid, (xc, rc, pc), (x0, r0, p0))

    # Outer iterations advance i by k+1; the trace is indexed by outer count.
    max_outer = -(-maxiter // (k + 1))  # ceil
    res_trace = jnp.zeros(max_outer + 1, dtype=sdt)
    nosl_trace = jnp.zeros(max_outer + 1, dtype=jnp.int32)

    carry0 = (
        x0,
        r0,
        p0,
        jnp.zeros((), jnp.int32),  # i  (solution updates)
        jnp.zeros((), jnp.int32),  # index (outer iterations)
        jnp.zeros((), bool),
        res_trace,
        nosl_trace,
    )

    K = k + 1  # offset of the Ap block inside the stacked basis

    def cond(c):
        _x, _r, _p, i, _index, converged, _rt, _nt = c
        return jnp.logical_and(~converged, i < maxiter)

    def _inv(s, vdt_):
        # Exact reciprocal: s is a power of two (pow2_scale), never zero.
        return (1.0 / s).astype(vdt_)

    def body(c):
        x, r, p, i, index, _, rtrace, ntrace = c

        if basis_norm:
            # Normalized chains with carried cumulative scales (same SpMV
            # count as the raw chains: 1 + 2k); the rescaled Gram equals
            # the true-bundle Gram exactly.
            Ap1 = ctx.matvec(A, p)
            s2 = ctx.dot_bundle([(r, r), (p, p), (Ap1, Ap1)])
            s_r0 = pow2_scale(jnp.sqrt(s2[0]))
            s_p0 = pow2_scale(jnp.sqrt(s2[1]))
            s_p1 = pow2_scale(jnp.sqrt(s2[2]))
            Vr = [r * _inv(s_r0, vdt)]
            Vp = [p * _inv(s_p0, vdt), Ap1 * _inv(s_p1, vdt)]
            c_r = [s_r0]
            c_p = [s_p0, s_p1]
            for _ in range(k):
                Wr = ctx.matvec(A, Vr[-1])
                Wp = ctx.matvec(A, Vp[-1])
                n2 = ctx.dot_bundle([(Wr, Wr), (Wp, Wp)])
                nr = pow2_scale(jnp.sqrt(n2[0]))
                np_ = pow2_scale(jnp.sqrt(n2[1]))
                Vr.append(Wr * _inv(nr, vdt))
                c_r.append(c_r[-1] * nr)
                Vp.append(Wp * _inv(np_, vdt))
                c_p.append(c_p[-1] * np_)
            cs = jnp.stack(c_r + c_p)
            G = ctx.gram(jnp.stack(Vr + Vp)) * (cs[:, None] * cs[None, :])
            Ap = [p, Ap1]  # vector updates consume the true p and A p
        else:
            # Krylov bases (2k+1 SpMVs; static unroll).
            Ar = [r]
            for _ in range(k):
                Ar.append(ctx.matvec(A, Ar[-1]))
            Ap = [p]
            for _ in range(k + 1):
                Ap.append(ctx.matvec(A, Ap[-1]))

            # Fused bundle: one Gram matmul, one collective.
            B = jnp.stack(Ar + Ap)
            G = ctx.gram(B)

        a = [G[j // 2, j // 2 + j % 2] for j in range(2 * k + 1)]
        f = [G[K + j // 2, K + j // 2 + j % 2] for j in range(2 * k + 3)]
        f.append(jnp.zeros((), sdt))  # f[2k+3] (zero and unread, see module doc)
        cc = [G[j // 2, K + j // 2 + j % 2] for j in range(2 * k + 2)]

        res = jnp.sqrt(a[0]) / b_norm
        rtrace = rtrace.at[index].set(res)
        conv = res < tol

        # k+1 CG steps driven by scalar recurrences
        # (reference: v3/cpu/kskipcg.py:50-74).
        x_n, r_n = x, r
        p_cur, Ap_cur = Ap[0], Ap[1]
        alpha = safe_div(a[0], f[1])
        beta = safe_div(alpha**2 * f[2], a[0]) - 1
        x_n = x_n + (alpha * p_cur).astype(vdt)
        r_n = r_n - (alpha * Ap_cur).astype(vdt)
        p_cur = r_n + (beta * p_cur).astype(vdt)
        Ap_cur = ctx.matvec(A, p_cur)

        for j in range(k):
            for l in range(2 * (k - j) + 1):
                a[l] = a[l] + alpha * (alpha * f[l + 2] - 2 * cc[l + 1])
                d = cc[l] - alpha * f[l + 1]
                cc[l] = a[l] + d * beta
                f[l] = cc[l] + beta * (d + beta * f[l])
            alpha = safe_div(a[0], f[1])
            beta = safe_div(alpha**2 * f[2], a[0]) - 1
            x_n = x_n + (alpha * p_cur).astype(vdt)
            r_n = r_n - (alpha * Ap_cur).astype(vdt)
            p_cur = r_n + (beta * p_cur).astype(vdt)
            Ap_cur = ctx.matvec(A, p_cur)

        x, r, p = tree_select(conv, (x, r, p), (x_n, r_n, p_cur))
        i = jnp.where(conv, i, i + (k + 1))
        index = jnp.where(conv, index, index + 1)
        ntrace = jnp.where(conv, ntrace, ntrace.at[index].set(i))
        return (x, r, p, i, index, conv, rtrace, ntrace)

    x, r, p, i, index, converged, rtrace, ntrace = lax.while_loop(
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
        carry=(x, r, p) if emit_carry else None,
    )
