"""Adaptive k-skip MrR with the k-adaptation fully traced (no host round-trips).

Semantics follow the reference (reference: v3/cpu/adaptivekskipmrr.py:8-141):
k-skip MrR plus a per-outer-iteration residual guard — if the residual rose
versus the last accepted iteration, the solver *rolls back* the solution to
``pre_x``, re-derives the true residual ``b - A x``, performs one safe plain
MrR step, and decrements k (floor 1, reference:
v3/cpu/adaptivekskipmrr.py:63-65); otherwise it accepts the state
(``pre_residual``/``pre_x`` checkpoint, reference:
v3/cpu/adaptivekskipmrr.py:68-70).  Either way it then proceeds with a
k-skip outer step at the current k.  ``khistory`` records k per outer index.

Fully traced design — this is the piece the reference needed a (missing)
Cython kernel for (reference: v1/processes/adaptivekskipmrr.py:5) and the
BASELINE north star requires traced-and-jitted:

- ``k`` is a *traced* int32 carried through ``lax.while_loop``; buffers are
  allocated once for the static ``k_max`` (= initial k) since k only
  decreases.
- Basis buffers are zero-initialized and filled by ``lax.fori_loop`` with
  traced bounds ``k+2``/``k+1``, so exactly k+1 (+k) SpMVs run per outer
  iteration regardless of ``k_max``, and unused basis rows stay zero —
  making their Gram entries zero rather than garbage.
- The coefficient bundle is one Gram matmul + one psum, extracted into
  fixed-size alpha/beta/delta vectors.
- The scalar recurrences run as nested ``fori_loop``s with traced trip
  counts (``j in [0,k)``, ``l in [2, 2(k-j)+1)``), updating the coefficient
  vectors at dynamic indices — pure on-device scalar dataflow.
- The rollback is a ``lax.cond``.

One undefined reference behavior is pinned down: if the very first outer
iteration already shows a residual increase, the reference would read
``pre_x`` before any assignment (NameError, reference:
v3/cpu/adaptivekskipmrr.py:44-47 — ``pre_x`` is only set in the accept
branch at :69); here ``pre_x`` is initialized to the post-init-step ``x``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

from krylov_tpu.context import Context, DEFAULT_CONTEXT
from krylov_tpu.solvers._common import (
    SolveResult,
    pow2_scale,
    safe_div,
    scalar_dtype_of,
    tree_select,
)


def adaptivekskipmrr_kernel(
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
    """``carry_in=((x, r, y, z, Ar1, pre_x, pre_res, k_cur), valid)`` resumes
    exactly from a previous chunk's ``result.carry`` — including the rollback
    snapshot (pre_x, pre_res) and the ADAPTED traced k, so a rollback
    spanning a chunk boundary behaves identically to the unbroken solve;
    ``emit_carry=True`` returns that state.  See ``solve(chunk_iters=)``."""
    k_max = max(int(k), 1)
    sdt = scalar_dtype_of(ctx, b)
    vdt = b.dtype
    b_norm = ctx.norm(b)
    n = b.shape[0]

    trace_len = maxiter + 2
    res_trace = jnp.zeros(trace_len, dtype=sdt)
    nosl_trace = jnp.zeros(trace_len, dtype=jnp.int32)
    k_trace = jnp.zeros(trace_len, dtype=jnp.int32)
    k_trace = k_trace.at[0].set(k).at[1].set(k)

    # --- init half-iteration (reference: v3/cpu/adaptivekskipmrr.py:22-38) ---
    r = b - ctx.matvec(A, x0)
    res0 = ctx.norm(r) / b_norm
    res_trace = res_trace.at[0].set(res0)
    Ar1 = ctx.matvec(A, r)
    rAr, ArAr = ctx.dot_bundle([(r, Ar1), (Ar1, Ar1)])
    zeta = safe_div(rAr, ArAr)
    y = (zeta * Ar1).astype(vdt)
    z = (-zeta * r).astype(vdt)
    r = r - y
    x = x0 - z
    nosl_trace = nosl_trace.at[1].set(1)
    Ar1 = ctx.matvec(A, r)  # carried (see kskip_mrr module doc)

    KA = k_max + 2  # Ay-block offset in the stacked basis
    n_alpha = 2 * k_max + 3
    n_beta = 2 * k_max + 2
    n_delta = 2 * k_max + 1

    # Static gather patterns for extracting the bundle vectors from the Gram
    # matrix of B = [Ar[0..k_max+1]; Ay[0..k_max]].
    a_rows = np.array([j // 2 for j in range(n_alpha)])
    a_cols = np.array([j // 2 + j % 2 for j in range(n_alpha)])
    b_rows = np.array([KA + j // 2 for j in range(n_beta)])
    b_cols = np.array([j // 2 + j % 2 for j in range(n_beta)])
    d_rows = np.array([KA + j // 2 for j in range(n_delta)])
    d_cols = np.array([KA + j // 2 + j % 2 for j in range(n_delta)])

    i0 = jnp.ones((), jnp.int32)
    index0 = jnp.ones((), jnp.int32)
    pre_x, pre_res = x, res0
    k_cur = jnp.asarray(k, jnp.int32)
    if carry_in is not None:
        (xc, rc, yc, zc, Ar1c, pre_xc, pre_resc, kc), valid = carry_in
        x, r, y, z, Ar1, pre_x, pre_res, k_cur = tree_select(
            valid,
            (xc, rc, yc, zc, Ar1c, pre_xc, pre_resc, kc),
            (x, r, y, z, Ar1, pre_x, pre_res, k_cur),
        )
        i0 = jnp.where(valid, 0, i0).astype(jnp.int32)
        index0 = jnp.where(valid, 0, index0).astype(jnp.int32)
        # khistory slot 0 must report the carried (possibly adapted) k
        k_trace = k_trace.at[0].set(k_cur).at[1].set(k_cur)

    carry0 = dict(
        x=x,
        r=r,
        y=y,
        z=z,
        Ar1=Ar1,
        pre_x=pre_x,
        pre_res=pre_res,
        k=k_cur,
        i=i0,
        index=index0,
        converged=jnp.zeros((), bool),
        rtrace=res_trace,
        ntrace=nosl_trace,
        ktrace=k_trace,
    )

    def cond(c):
        return jnp.logical_and(~c["converged"], c["i"] < maxiter)

    def _mrr_init_like_step(x_in, r_unused):
        """Rollback recovery: one plain MrR half-step from pre_x
        (reference: v3/cpu/adaptivekskipmrr.py:46-57)."""
        r_new = b - ctx.matvec(A, x_in)
        Ar1_new = ctx.matvec(A, r_new)
        rAr_, ArAr_ = ctx.dot_bundle([(r_new, Ar1_new), (Ar1_new, Ar1_new)])
        zeta_ = safe_div(rAr_, ArAr_)
        y_ = (zeta_ * Ar1_new).astype(vdt)
        z_ = (-zeta_ * r_new).astype(vdt)
        r_out = r_new - y_
        x_out = x_in - z_
        Ar1_out = ctx.matvec(A, r_out)
        return x_out, r_out, y_, z_, Ar1_out

    def body(c):
        res = ctx.norm(c["r"]) / b_norm
        rtrace = c["rtrace"].at[c["index"]].set(res)
        # Non-finite counts as "rose": the reference's ``residual >
        # pre_residual`` comparison is False for NaN, so a blow-up INSIDE a
        # k-skip outer step would be silently ACCEPTED and the solve stuck
        # at NaN forever (observed on the 1M-row kappa~1e6 capture).  On
        # finite values this is exactly the reference predicate
        # (reference: v3/cpu/adaptivekskipmrr.py:44).
        rose = jnp.logical_or(res > c["pre_res"], ~jnp.isfinite(res))

        def rollback(op):
            x_o, r_o, y_o, z_o, Ar1_o = _mrr_init_like_step(c["pre_x"], None)
            i_n = c["i"] + 1
            index_n = c["index"] + 1
            res_n = ctx.norm(r_o) / b_norm
            rt = rtrace.at[index_n].set(res_n)
            nt = c["ntrace"].at[index_n].set(i_n)
            k_n = jnp.where(c["k"] > 1, c["k"] - 1, c["k"])
            kt = c["ktrace"].at[index_n].set(k_n)
            return (
                x_o, r_o, y_o, z_o, Ar1_o,
                c["pre_x"], c["pre_res"],
                k_n, i_n, index_n, rt, nt, kt,
            )

        def accept(op):
            return (
                c["x"], c["r"], c["y"], c["z"], c["Ar1"],
                c["x"], res,
                c["k"], c["i"], c["index"], rtrace, c["ntrace"], c["ktrace"],
            )

        (x, r, y, z, Ar1, pre_x, pre_res, kk, i, index, rtrace2, ntrace, ktrace) = (
            lax.cond(rose, rollback, accept, None)
        )

        cur_res = rtrace2[index]
        conv = cur_res < tol

        # ---- k-skip outer step at the current (traced) k ----
        if basis_norm:
            # Normalized chains with carried cumulative scales (rationale:
            # kskip_mrr module docstring).  Unused rows keep scale 1 — their
            # Gram entries are zero anyway.
            def _inv(s):
                # Exact reciprocal: s is a power of two (pow2_scale).
                return (1.0 / s).astype(vdt)

            s2 = ctx.dot_bundle([(r, r), (Ar1, Ar1), (y, y)])
            s_r0 = pow2_scale(jnp.sqrt(s2[0]))
            s_r1 = pow2_scale(jnp.sqrt(s2[1]))
            s_y0 = pow2_scale(jnp.sqrt(s2[2]))
            ArB = (
                jnp.zeros((k_max + 2, n), vdt)
                .at[0].set(r * _inv(s_r0))
                .at[1].set(Ar1 * _inv(s_r1))
            )
            cR = jnp.ones(k_max + 2, sdt).at[0].set(s_r0).at[1].set(s_r1)

            def chain_step(j, st):
                buf, cc = st
                W = ctx.matvec(A, buf[j - 1])
                s = pow2_scale(ctx.norm(W))
                return (
                    buf.at[j].set(W * _inv(s)),
                    cc.at[j].set(cc[j - 1] * s),
                )

            ArB, cR = lax.fori_loop(2, kk + 2, chain_step, (ArB, cR))
            AyB = jnp.zeros((k_max + 1, n), vdt).at[0].set(y * _inv(s_y0))
            cY = jnp.ones(k_max + 1, sdt).at[0].set(s_y0)
            AyB, cY = lax.fori_loop(1, kk + 1, chain_step, (AyB, cY))

            cs = jnp.concatenate([cR, cY])
            G = ctx.gram(jnp.concatenate([ArB, AyB], axis=0)) * (
                cs[:, None] * cs[None, :]
            )
        else:
            ArB = jnp.zeros((k_max + 2, n), vdt).at[0].set(r).at[1].set(Ar1)
            ArB = lax.fori_loop(
                2,
                kk + 2,
                lambda j, buf: buf.at[j].set(ctx.matvec(A, buf[j - 1])),
                ArB,
            )
            AyB = jnp.zeros((k_max + 1, n), vdt).at[0].set(y)
            AyB = lax.fori_loop(
                1,
                kk + 1,
                lambda j, buf: buf.at[j].set(ctx.matvec(A, buf[j - 1])),
                AyB,
            )

            G = ctx.gram(jnp.concatenate([ArB, AyB], axis=0))
        alpha = G[a_rows, a_cols]
        beta = G[b_rows, b_cols].at[0].set(0.0)
        delta = G[d_rows, d_cols]

        # MrR step 1 (reference: v3/cpu/adaptivekskipmrr.py:91-99).
        # The vector update consumes the TRUE (unscaled) Ar[1] — the carried
        # ``Ar1``, which row 1 of ArB holds (normalized under basis_norm).
        d0 = alpha[2] * delta[0] - beta[1] ** 2
        zeta_s = safe_div(alpha[1] * delta[0], d0)
        eta_s = -safe_div(alpha[1] * beta[1], d0)
        y_n = (eta_s * y + zeta_s * Ar1).astype(vdt)
        z_n = (eta_s * z - zeta_s * r).astype(vdt)
        r_n = r - y_n
        Ar1_n = ctx.matvec(A, r_n)
        x_n = x - z_n

        # k scalar-recurrence steps with traced trip counts
        # (reference: v3/cpu/adaptivekskipmrr.py:101-127).
        def k_step(j, st):
            alpha, beta, delta, zeta_s, eta_s, x_n, r_n, y_n, z_n, Ar1_n = st
            delta = delta.at[0].set(
                zeta_s**2 * alpha[2] + eta_s * zeta_s * beta[1]
            )
            alpha = alpha.at[0].add(-zeta_s * alpha[1])
            delta = delta.at[1].set(
                eta_s**2 * delta[1]
                + 2 * eta_s * zeta_s * beta[2]
                + zeta_s**2 * alpha[3]
            )
            beta = beta.at[1].set(
                eta_s * beta[1] + zeta_s * alpha[2] - delta[1]
            )
            alpha = alpha.at[1].set(-beta[1])

            def l_step(l, st_l):
                alpha, beta, delta = st_l
                delta = delta.at[l].set(
                    eta_s**2 * delta[l]
                    + 2 * eta_s * zeta_s * beta[l + 1]
                    + zeta_s**2 * alpha[l + 2]
                )
                tau = eta_s * beta[l] + zeta_s * alpha[l + 1]
                beta = beta.at[l].set(tau - delta[l])
                alpha = alpha.at[l].add(-tau - beta[l])
                return (alpha, beta, delta)

            alpha, beta, delta = lax.fori_loop(
                2, 2 * (kk - j) + 1, l_step, (alpha, beta, delta)
            )

            d0 = alpha[2] * delta[0] - beta[1] ** 2
            zeta_s = safe_div(alpha[1] * delta[0], d0)
            eta_s = -safe_div(alpha[1] * beta[1], d0)
            y_n = (eta_s * y_n + zeta_s * Ar1_n).astype(vdt)
            z_n = (eta_s * z_n - zeta_s * r_n).astype(vdt)
            r_n = r_n - y_n
            Ar1_n = ctx.matvec(A, r_n)
            x_n = x_n - z_n
            return (alpha, beta, delta, zeta_s, eta_s, x_n, r_n, y_n, z_n, Ar1_n)

        st = (alpha, beta, delta, zeta_s, eta_s, x_n, r_n, y_n, z_n, Ar1_n)
        st = lax.fori_loop(0, kk, k_step, st)
        x_n, r_n, y_n, z_n, Ar1_n = st[5], st[6], st[7], st[8], st[9]

        i_n = i + kk + 1
        index_n = index + 1
        ntrace_n = ntrace.at[index_n].set(i_n)
        ktrace_n = ktrace.at[index_n].set(kk)

        # Keep pre-step state when converged (the loop then exits).
        (x, r, y, z, Ar1, i, index, ntrace, ktrace) = tree_select(
            conv,
            (x, r, y, z, Ar1, i, index, ntrace, ktrace),
            (x_n, r_n, y_n, z_n, Ar1_n, i_n, index_n, ntrace_n, ktrace_n),
        )
        return dict(
            x=x, r=r, y=y, z=z, Ar1=Ar1,
            pre_x=pre_x, pre_res=pre_res,
            k=kk, i=i, index=index, converged=conv,
            rtrace=rtrace2, ntrace=ntrace, ktrace=ktrace,
        )

    out = lax.while_loop(cond, body, carry0)

    final_res = ctx.norm(out["r"]) / b_norm
    rtrace = jnp.where(
        out["converged"],
        out["rtrace"],
        out["rtrace"].at[out["index"]].set(final_res),
    )

    return SolveResult(
        x=out["x"],
        residual_trace=rtrace,
        nosl_trace=out["ntrace"],
        iterations=out["i"],
        index=out["index"],
        converged=out["converged"],
        k_trace=out["ktrace"],
        final_k=out["k"],
        carry=(
            out["x"], out["r"], out["y"], out["z"], out["Ar1"],
            out["pre_x"], out["pre_res"], out["k"],
        )
        if emit_carry
        else None,
    )
