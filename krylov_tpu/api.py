"""SciPy-compatible front door.

Signatures are modeled on the reference's v3 generation (reference:
v3/cpu/cg.py:7): ``cg(A, b, x=None, tol=1e-05, maxiter=None, M=None,
callback=None, atol=None) -> (x, info)`` with ``info = {'time', 'nosl',
'residual'[, 'khistory']}``; k-skip variants add ``k`` (reference:
v3/cpu/kskipcg.py:8).  The backend-selection trees of the reference collapse
into two knobs here: ``mesh`` (None → single device, a 1-D
``jax.sharding.Mesh`` → distributed via ``shard_map``) and the operator
container type.

Unlike the reference, ``M`` (a preconditioner with a ``.solve(r)`` method or
a callable) is honored by the methods that support it — the reference accepts
``M`` but ignores it everywhere except the v1 pipeline family (reference:
v3/cpu/cg.py:7 vs v1/threads/pipeline/pcg.py:29-45).
"""

from __future__ import annotations

import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from krylov_tpu.context import Context
from krylov_tpu.diagnostics import build_info, finish_banner, start_banner
from krylov_tpu.sparse import as_operator


def _get_kernel(method: str):
    from krylov_tpu import solvers

    table = {
        "cg": solvers.cg_kernel,
        "mrr": solvers.mrr_kernel,
    }
    try:
        from krylov_tpu.solvers.kskip_cg import kskipcg_kernel

        table["kskipcg"] = kskipcg_kernel
    except ImportError:  # pragma: no cover - during staged bring-up
        pass
    try:
        from krylov_tpu.solvers.kskip_mrr import kskipmrr_kernel

        table["kskipmrr"] = kskipmrr_kernel
    except ImportError:  # pragma: no cover
        pass
    try:
        from krylov_tpu.solvers.adaptive_kskip_mrr import adaptivekskipmrr_kernel

        table["adaptivekskipmrr"] = adaptivekskipmrr_kernel
    except ImportError:  # pragma: no cover
        pass
    try:
        from krylov_tpu.solvers.cacg import cacg_kernel, camrr_kernel

        table["cacg"] = cacg_kernel
        table["camrr"] = camrr_kernel
    except ImportError:  # pragma: no cover
        pass
    try:
        from krylov_tpu.solvers.pipelined import (
            chronopoulos_gear_kernel,
            gropp_kernel,
            pcg_kernel,
            pipelined_cg_kernel,
        )

        table["pcg"] = pcg_kernel
        table["chronopoulos_gear"] = chronopoulos_gear_kernel
        table["gropp"] = gropp_kernel
        table["pipelined_cg"] = pipelined_cg_kernel
    except ImportError:  # pragma: no cover
        pass
    if method not in table:
        raise ValueError(f"unknown method {method!r}; available: {sorted(table)}")
    return table[method]


_METHOD_NAMES = {
    "cg": "CG",
    "mrr": "MrR",
    "kskipcg": "k-skip CG",
    "kskipmrr": "k-skip MrR",
    "adaptivekskipmrr": "Adaptive k-skip MrR",
    "cacg": "CA-CG (Chebyshev basis)",
    "camrr": "CA-MrR (Chebyshev basis)",
    "pcg": "Preconditioned CG",
    "chronopoulos_gear": "chronopoulos gear",
    "gropp": "gropp",
    "pipelined_cg": "pipeline",
}

_KSKIP_METHODS = {"kskipcg", "kskipmrr", "adaptivekskipmrr"}
# Chebyshev-basis CA methods: skip size via ``k`` (as s) + static spectral
# bounds.
_CACG_METHODS = {"cacg", "camrr"}
_PRECONDITIONED_METHODS = {"pcg", "chronopoulos_gear", "gropp", "pipelined_cg"}
# Methods whose kernels can thread their full recurrence state across
# chunked dispatches (carry_in/emit_carry) — chunk_iters is EXACT for these.
_CARRY_METHODS = {
    "cg", "mrr", "kskipcg", "kskipmrr", "adaptivekskipmrr", "cacg", "camrr",
}


@partial(
    jax.jit,
    static_argnames=("method", "maxiter", "k", "ctx", "basis_norm", "sb"),
)
def _run_kernel(
    A, b, x0, tol, method, maxiter, k, ctx, M=None, basis_norm=False, sb=None
):
    kernel = _get_kernel(method)
    kwargs = dict(tol=tol, maxiter=maxiter, ctx=ctx)
    if method in _KSKIP_METHODS:
        kwargs["k"] = k
        if basis_norm:
            kwargs["basis_norm"] = True
    if method in _CACG_METHODS:
        kwargs["s"] = max(k, 1)
        kwargs["lmin"], kwargs["lmax"] = sb
    if method in _PRECONDITIONED_METHODS:
        kwargs["M"] = M
    return kernel(A, b, x0, **kwargs)


@partial(
    jax.jit,
    static_argnames=(
        "method", "maxiter", "k", "ctx", "restarts", "emit_carry",
        "basis_norm", "sb",
    ),
)
def _run_single(
    A, b, x0, tol, M, carry=None, *,
    method, maxiter, k, ctx, restarts, emit_carry=False, basis_norm=False,
    sb=None,
):
    """Single-device solve, optionally followed by ``restarts`` device-side
    defect-correction passes.

    The solvers converge on the RECURRED residual (reference semantics,
    v3/cpu/cg.py:21-24), which in float32 drifts from the true residual
    ``||b - A x||`` over many iterations.  Each restart recomputes the true
    residual on device in working precision (accurate to ~eps_f32
    relative — far below practical tolerances), and, if it is still above
    ``tol``, solves the correction system ``A d = r`` to the equivalent
    relative tolerance and updates ``x += d``.  All inside ONE dispatch —
    unlike :func:`solve`'s ``refine=`` path, which round-trips through the
    host in float64 for tolerances below the f32 floor."""

    def base(bb, x0b, tolb):
        if carry is not None or emit_carry:
            # exact chunked continuation (guarded in the planner); the carry
            # threads the recurrence state across bounded dispatches without
            # a Krylov restart
            kernel = _get_kernel(method)
            kw = dict(
                tol=tolb, maxiter=maxiter, ctx=ctx,
                carry_in=carry, emit_carry=emit_carry,
            )
            if method in _KSKIP_METHODS:
                kw["k"] = k
                if basis_norm:
                    kw["basis_norm"] = True
            if method in _CACG_METHODS:
                kw["s"] = max(k, 1)
                kw["lmin"], kw["lmax"] = sb
            return kernel(A, bb, x0b, **kw)
        return _run_kernel(
            A, bb, x0b, tolb, method, maxiter, k, ctx, M,
            basis_norm=basis_norm, sb=sb,
        )

    result = base(b, x0, tol)
    if restarts == 0:
        return result

    b_norm = jnp.linalg.norm(b)
    x, iters = result.x, result.iterations
    for _ in range(restarts):
        r = b - A.matvec(x)
        r_norm = jnp.linalg.norm(r)
        true_rel = r_norm / b_norm
        # tol on the ORIGINAL system == tol * b_norm / r_norm on the defect.
        # The correction solve itself converges on a RECURRED residual whose
        # true residual sits slightly higher, so ask for 5x margin; floor at
        # ~2 eps_f32 (unreachable below) and cap at 0.5.
        inner_tol = jnp.clip(
            0.2 * tol * b_norm / jnp.maximum(r_norm, jnp.asarray(1e-30, r_norm.dtype)),
            2e-7,
            0.5,
        ).astype(b.dtype)

        def correct(_):
            res2 = base(r, jnp.zeros_like(x), inner_tol)
            return x + res2.x, iters + res2.iterations

        def skip(_):
            return x, iters

        x, iters = lax.cond(true_rel >= tol, correct, skip, None)

    true_final = jnp.linalg.norm(b - A.matvec(x)) / b_norm
    return _with_restart_fields(result, x, iters, true_final, tol)


def _with_restart_fields(result, x, iters, true_final, tol):
    import dataclasses

    return dataclasses.replace(
        result,
        x=x,
        iterations=iters,
        converged=true_final < tol,
        true_residual=true_final,
    )


def _resolve_bounds(A, method, spectral_bounds):
    """Static (lmin, lmax) for the Chebyshev-basis methods; Lanczos-estimated
    when not supplied (same machinery as the Chebyshev preconditioner)."""
    if method not in _CACG_METHODS:
        return None
    if spectral_bounds is not None:
        lo, hi = spectral_bounds
        return (float(lo), float(hi))
    from krylov_tpu.precond import lanczos_bounds

    # Plain Lanczos bounds, no extra widening: measured on the kappa~1e5
    # graded-spectrum system, the raw 16-step Ritz interval converges in
    # 408 iterations even though its lmin sits 400x above the true lmin
    # (the handful of eigenvalues below the interval cost only a mild
    # Chebyshev growth factor), while widening lmin by 4x DIVERGED the
    # same solve.  Bound quality is empirical; prefer the measured
    # configuration and let callers override via spectral_bounds=.
    return tuple(lanczos_bounds(A))


def _plan_single(
    A, b, x0, tol, method, maxiter, k, M, scalar_dtype, restarts,
    carry=None, emit_carry=False, basis_norm=False, spectral_bounds=None,
):
    """(jitted fn, dynamic args, static kwargs) for a single-device solve."""
    if carry is not None or emit_carry:
        assert method in _CARRY_METHODS and not restarts
    statics = dict(
        method=method,
        maxiter=maxiter,
        k=k,
        ctx=Context(axis=None, scalar_dtype=scalar_dtype),
        restarts=restarts,
        emit_carry=emit_carry,
        basis_norm=basis_norm and method in _KSKIP_METHODS,
        sb=_resolve_bounds(A, method, spectral_bounds),
    )
    args = (A, b, x0, jnp.asarray(tol, dtype=b.dtype), M, carry)
    return _run_single, args, statics


def solve_device(
    A,
    b,
    method: str = "cg",
    x0=None,
    tol: float = 1e-5,
    maxiter: Optional[int] = None,
    k: int = 0,
    M=None,
    mesh=None,
    scalar_dtype=None,
    restarts: int = 0,
    basis_norm: bool = False,
    spectral_bounds=None,
):
    """Like :func:`solve` but returns the raw on-device
    :class:`~krylov_tpu.solvers.SolveResult` (fixed-shape traces, no host
    sync, no info dict) — for composing solves inside larger jitted
    programs and for device-side benchmarking.

    ``restarts``: number of device-side defect-correction passes appended to
    the solve, all inside the same dispatch (see :func:`_run_single`).  The
    returned result then carries ``true_residual`` and ``converged`` reflects
    the true residual.  Single-device only."""
    from krylov_tpu.sparse.formats import to_device

    A = as_operator(A)
    if mesh is None:
        A = to_device(A)  # containers are host-lazy; commit leaves once
    b = jnp.asarray(b, dtype=A.dtype)
    n = b.shape[0]
    if maxiter is None:
        maxiter = n
    x0 = (
        jnp.zeros(n, dtype=A.dtype)
        if x0 is None
        else jnp.asarray(x0, dtype=A.dtype)
    )
    spectral_bounds = _resolve_bounds(A, method, spectral_bounds)
    if mesh is None:
        fn, args, statics = _plan_single(
            A, b, x0, tol, method, maxiter, k, M, scalar_dtype, restarts,
            basis_norm=basis_norm, spectral_bounds=spectral_bounds,
        )
        return fn(*args, **statics)
    if restarts:
        raise ValueError("restarts= is single-device only (use refine= with mesh)")
    from krylov_tpu.dist import solve_sharded

    return solve_sharded(
        A, b, x0, tol=tol, method=method, maxiter=maxiter, k=k, M=M,
        mesh=mesh, scalar_dtype=scalar_dtype, basis_norm=basis_norm,
        spectral_bounds=spectral_bounds,
    )


_AOT_CACHE: dict = {}
_AOT_CACHE_MAX = 128  # FIFO-evicted; bounds memory in long-lived processes


def _aot_compile(fn, args, statics):
    """Compile ``fn`` ahead-of-time for these arg shapes, cached.

    Lets :func:`solve` time EXECUTION only — the reference times just its
    iteration loop (reference: v3/cpu/common.py:9-18), while timing a jitted
    call's first invocation would fold 20-40s of XLA compilation into
    ``info['time']``.  Returns (compiled, compile_seconds) with
    ``compile_seconds == 0.0`` on a cache hit."""
    leaves, treedef = jax.tree.flatten(args)
    key = (
        fn,
        treedef,
        tuple((l.shape, str(l.dtype)) for l in leaves),
        tuple(sorted(statics.items(), key=lambda kv: kv[0])),
    )
    if key in _AOT_CACHE:
        return _AOT_CACHE[key], 0.0
    t0 = time.perf_counter()
    compiled = fn.lower(*args, **statics).compile()
    dt = time.perf_counter() - t0
    if len(_AOT_CACHE) >= _AOT_CACHE_MAX:
        _AOT_CACHE.pop(next(iter(_AOT_CACHE)))
    _AOT_CACHE[key] = compiled
    return compiled, dt


def _solve_chunked(
    A, b, x0, tol, method, maxiter, k, M, scalar_dtype, chunk_iters,
    basis_norm=False, spectral_bounds=None,
):
    """Chunked solve: repeated ``chunk_iters``-bounded dispatches (see
    ``solve``'s ``chunk_iters`` doc).  For every method in
    ``_CARRY_METHODS`` — cg, mrr and the whole k-skip family including
    adaptive (whose carry threads the rollback snapshot and adapted k) —
    the full recurrence state is CARRIED across chunks
    (``emit_carry``/``carry_in`` on the kernels), so the iteration sequence
    is exactly the unbroken solve's — no restart penalty
    (tests/test_restarts.py asserts exactness for cg/mrr/the k-skip family;
    tests/test_cacg.py for cacg/camrr — all seven carry methods).  The pipelined
    family warm-restarts from the carried iterate.  Every chunk reuses ONE
    cached executable (same shapes/statics), so only the first pays
    compile.  Returns ``(last_result, merged_info, compile_seconds)``; the
    merged info carries concatenated traces and ``info["chunks"]``."""
    import dataclasses

    exact = method in _CARRY_METHODS
    x_cur = x0
    carry = None
    if exact:
        sdt = b.dtype if scalar_dtype is None else jnp.dtype(scalar_dtype)
        z = jnp.zeros_like(b)
        state0 = {
            "cg": (z, z, z, jnp.zeros((), sdt)),  # (x, r, p, gamma)
            "mrr": (z, z, z, z),  # (x, r, y, z)
            "kskipcg": (z, z, z),  # (x, r, p)
            # (x, r, p, x_best, res_best) — the trailing pair threads the
            # divergence guard's best-iterate state across chunks
            "cacg": (z, z, z, z, jnp.zeros((), sdt)),
            # (x, r, y, z, x_best, res_best)
            "camrr": (z, z, z, z, z, jnp.zeros((), sdt)),
            "kskipmrr": (z, z, z, z, z),  # (x, r, y, z, Ar1)
            # (x, r, y, z, Ar1, pre_x, pre_res, k_cur)
            "adaptivekskipmrr": (
                z, z, z, z, z, z,
                jnp.zeros((), sdt), jnp.zeros((), jnp.int32),
            ),
        }[method]
        carry = (state0, jnp.zeros((), bool))
    compile_total = 0.0
    merged = None
    iters_done = 0
    chunks = 0
    while True:
        fn, args, statics = _plan_single(
            A, b, x_cur, tol, method, chunk_iters, k, M,
            scalar_dtype, 0, carry=carry, emit_carry=exact,
            basis_norm=basis_norm, spectral_bounds=spectral_bounds,
        )
        compiled, ct = _aot_compile(fn, args, statics)
        compile_total += ct
        t0 = time.perf_counter()
        dev_res = jax.block_until_ready(compiled(*args))
        dt = time.perf_counter() - t0
        if exact:
            carry = (dev_res.carry, jnp.ones((), bool))
            dev_res = dataclasses.replace(dev_res, carry=None)
        # Per-chunk host fetch covers only the small leaves (traces +
        # scalars) — the N-vector iterate stays ON DEVICE between chunks
        # (build_info never reads x).  The full result is fetched once,
        # after the last chunk.
        seg = build_info(
            jax.device_get(dataclasses.replace(dev_res, x=None)), dt
        )
        chunks += 1
        if merged is None:
            merged = seg
        else:
            merged["time"] += seg["time"]
            merged["nosl"] = np.concatenate(
                [merged["nosl"], seg["nosl"][1:] + merged["nosl"][-1]]
            )
            merged["residual"] = np.concatenate(
                [merged["residual"], seg["residual"][1:]]
            )
            if "khistory" in merged and "khistory" in seg:
                merged["khistory"] = np.concatenate(
                    [merged["khistory"], seg["khistory"][1:]]
                )
            if "final_k" in seg:
                merged["final_k"] = seg["final_k"]
            merged["iterations"] += seg["iterations"]
            merged["converged"] = seg["converged"]
        iters_done += seg["iterations"]
        x_cur = dev_res.x
        if (
            seg["converged"]
            or iters_done >= maxiter
            or seg["iterations"] == 0  # no progress: diverged / stalled
            or not np.isfinite(seg["residual"][-1])
        ):
            result = jax.device_get(dev_res)
            break
    merged["chunks"] = chunks
    return result, merged, compile_total


def solve(
    A,
    b,
    method: str = "cg",
    x0=None,
    tol: float = 1e-5,
    maxiter: Optional[int] = None,
    k: int = 0,
    M=None,
    mesh=None,
    scalar_dtype=None,
    refine: int = 0,
    restarts: int = 0,
    chunk_iters: Optional[int] = None,
    basis_norm: bool = False,
    spectral_bounds=None,
    verbose: bool = False,
):
    """Solve the SPD system ``A x = b``; returns ``(x, info)``.

    Args:
      A: operator — a ``krylov_tpu.sparse`` container, scipy sparse matrix,
        or dense array.
      method: one of ``cg``, ``mrr``, ``kskipcg``, ``kskipmrr``,
        ``adaptivekskipmrr``, ``pcg``, ``chronopoulos_gear``, ``gropp``,
        ``pipelined_cg``.
      mesh: optional 1-D ``jax.sharding.Mesh``; when given, the solve runs
        row-partitioned under ``shard_map``.
      scalar_dtype: dtype for inner products / scalar recurrences (e.g.
        ``jnp.float64`` with float32 vectors).
      refine: mixed-precision iterative-refinement steps.  The solvers
        (like the reference, v3/cpu/cg.py:21-24) converge on the RECURRED
        residual in working precision, so in float32 the true residual
        ``||b - A x||/||b||`` floors at ~``eps_f32 * kappa(A)``.  With
        ``refine=m > 0``, while the float64 true residual is above ``tol``
        (checked at most ``m`` times) the defect ``r = b - A x`` is formed
        in float64 on the host, the correction ``A d = r`` is solved in
        working precision on device, and ``x += d`` accumulates in float64;
        the returned ``x`` is then float64 and ``info`` carries
        ``true_residual`` and ``refinements``.  Default 0 preserves exact
        reference semantics (and the working-precision return dtype).
      spectral_bounds: ``(lmin, lmax)`` interval for the Chebyshev-basis
        method ``cacg`` (estimated by a 16-step Lanczos run when omitted —
        the same machinery as the Chebyshev preconditioner).  ``cacg``
        reads the skip size from ``k`` (s CG steps per reduction) and is
        the float32-stable communication-avoiding alternative to
        ``kskipcg`` for stiff systems (see
        :mod:`krylov_tpu.solvers.cacg`).
      basis_norm: (k-skip methods only) build the Krylov chains with
        per-vector normalization, carrying the exact cumulative scales
        through the coefficient bundle — exact algebra that prevents the
        float32 overflow/cancellation collapse of the raw monomial basis on
        ill-conditioned systems (see
        :mod:`krylov_tpu.solvers.kskip_mrr`).  Combine with
        ``scalar_dtype=jnp.float64`` for hard problems: f32 vectors, f64
        bundle/recurrences.  Costs ~k extra fused norm reductions per outer
        iteration.
      chunk_iters: split the solve into dispatches of at most this many
        iterations each (single-device only).  For ``cg``, ``mrr`` and the
        whole k-skip family (``kskipcg``, ``kskipmrr``,
        ``adaptivekskipmrr`` — including its rollback snapshot and adapted
        k) the full recurrence state is carried across chunks, so the
        iteration sequence is EXACTLY the unbroken solve's; the pipelined
        family warm-restarts from the carried iterate (standard
        restarted-Krylov semantics — may need more total iterations).
        Chunks always run whole: the final chunk may overshoot ``maxiter``
        by up to ``chunk_iters - 1`` iterations (e.g. ``maxiter=25,
        chunk_iters=10`` can execute 30), unlike the reference's hard
        per-iteration cap (reference: v3/cpu/cg.py:19) — keeping every
        dispatch the same shape is what lets all chunks share one compiled
        executable.  Residual history, nosl and iteration counts concatenate
        across chunks; ``info["chunks"]`` records the dispatch count.  A device
        fault mid-dispatch loses that dispatch's work, so chunking bounds
        what a fault costs to one chunk, and lets long solves checkpoint
        between chunks.  The reference's host loops are implicitly "chunked"
        at every iteration (v3/cpu/cg.py:19-40); this is the explicit
        device-side dial for the same robustness.
      verbose: print the reference-style banner (reference: v3/common.py:2-23).
    """
    in_dtype = getattr(A, "dtype", None)
    if (
        in_dtype is not None
        and np.dtype(in_dtype) == np.float64
        and not jax.config.jax_enable_x64
    ):
        import warnings

        warnings.warn(
            "float64 operands will be silently downcast to float32 because "
            "jax_enable_x64 is off; enable it (jax.config.update("
            "'jax_enable_x64', True)) for reference-equivalent float64 "
            "numerics, or pass scalar_dtype=jnp.float64 for mixed precision",
            stacklevel=2,
        )
    A = A_host = as_operator(A)
    if mesh is None:
        from krylov_tpu.sparse.formats import to_device

        # Containers are host-lazy (numpy leaves); commit once so every
        # chunk/restart dispatch reuses the same device buffers.  The mesh
        # path shards the host arrays itself (dist/solve.py).  ``A_host``
        # keeps the pre-commit operator so the ``refine=`` path's host-f64
        # matvecs don't pull the operator back through the device.
        A = to_device(A)
    if np.asarray(b).ndim != 1 or A.shape[0] != A.shape[1] or A.shape[0] != np.asarray(b).shape[0]:
        raise ValueError(
            f"need a square system: A has shape {A.shape}, b has shape "
            f"{np.asarray(b).shape}"
        )

    if verbose:
        start_banner(
            _METHOD_NAMES.get(method, method),
            k if method in _KSKIP_METHODS else None,
        )

    compile_time = None
    chunk_info = None
    if method in _CACG_METHODS:
        # Resolve ONCE (a 16-SpMV Lanczos run) so chunk/restart dispatches
        # and the mesh path all reuse the same static bounds.
        spectral_bounds = _resolve_bounds(A, method, spectral_bounds)
    if mesh is None:
        # AOT-compile (cached), then time EXECUTION only — reference
        # semantics: the loop is timed, setup is not (v3/cpu/common.py:9-18).
        b_dev = jnp.asarray(b, dtype=A.dtype)
        n = b_dev.shape[0]
        maxiter_eff = n if maxiter is None else maxiter
        x0_dev = (
            jnp.zeros(n, dtype=A.dtype)
            if x0 is None
            else jnp.asarray(x0, dtype=A.dtype)
        )
        if chunk_iters is not None and chunk_iters < maxiter_eff:
            if chunk_iters < 1:
                raise ValueError(f"chunk_iters must be >= 1, got {chunk_iters}")
            if restarts:
                raise ValueError(
                    "chunk_iters= and restarts= are mutually exclusive "
                    "(restarts already re-dispatches; chunk the outer solve "
                    "OR defect-correct, not both)"
                )
            result, chunk_info, compile_time = _solve_chunked(
                A, b_dev, x0_dev, tol, method, maxiter_eff, k, M,
                scalar_dtype, chunk_iters, basis_norm=basis_norm,
                spectral_bounds=spectral_bounds,
            )
            elapsed = chunk_info["time"]
        else:
            fn, args, statics = _plan_single(
                A, b_dev, x0_dev, tol, method, maxiter_eff, k, M,
                scalar_dtype, restarts, basis_norm=basis_norm,
                spectral_bounds=spectral_bounds,
            )
            compiled, compile_time = _aot_compile(fn, args, statics)
            t0 = time.perf_counter()
            result = jax.block_until_ready(compiled(*args))
            elapsed = time.perf_counter() - t0
    else:
        # Mesh path: AOT-compiled through the shared cache too, so
        # info["time"] is execution-only here as well (the first sharded
        # solve reports its compile separately in info["compile_time"]).
        if restarts:
            raise ValueError(
                "restarts= is single-device only (use refine= with mesh)"
            )
        if chunk_iters is not None:
            raise ValueError("chunk_iters= is single-device only")
        from krylov_tpu.dist import solve_sharded

        b_dev = np.asarray(b, dtype=A.dtype)
        n = b_dev.shape[0]
        x0_arr = (
            np.zeros(n, dtype=A.dtype)
            if x0 is None
            else np.asarray(x0, dtype=A.dtype)
        )
        result, compile_time, elapsed = solve_sharded(
            A,
            b_dev,
            x0_arr,
            tol=tol,
            method=method,
            maxiter=n if maxiter is None else maxiter,
            k=k,
            M=M,
            mesh=mesh,
            scalar_dtype=scalar_dtype,
            basis_norm=basis_norm,
            spectral_bounds=spectral_bounds,
            return_times=True,
        )

    # ONE bulk device→host fetch instead of a transfer per field.
    if chunk_info is None:
        result = jax.device_get(result)
        info = build_info(result, elapsed)
    else:
        info = chunk_info  # already host-side, merged across chunks
    if compile_time:
        info["compile_time"] = compile_time

    x_out = None
    if refine:
        # Mixed-precision iterative refinement (defect correction): the
        # solvers converge on the RECURRED residual in working precision
        # (f32 on the device), so both the recurrence drift and the f32
        # representation of x floor the true residual at ~eps_f32 * kappa.
        # Each refinement step computes the defect r = b - A x in float64 on
        # the host (one cheap pass over the operator), solves the correction
        # system ``A d = r`` in working precision on device, and accumulates
        # ``x += d`` in float64.  Per step the true residual contracts by
        # the correction solve's achieved accuracy, so a couple of steps
        # reach far below the f32 floor.
        from krylov_tpu.sparse.convert import host_matvec64

        b64 = np.asarray(b, dtype=np.float64)
        b_norm = np.linalg.norm(b64)
        x64 = np.asarray(result.x, dtype=np.float64)

        refinements = 0
        true_rel = float(
            np.linalg.norm(b64 - host_matvec64(A_host, x64)) / b_norm
        )
        for _ in range(refine):
            if not np.isfinite(true_rel) or true_rel < tol:
                break
            r64 = b64 - host_matvec64(A_host, x64)
            r_norm = np.linalg.norm(r64)
            # ask the correction solve for just enough: tol on the ORIGINAL
            # system means tol * b_norm / r_norm relative to the defect
            inner_tol = float(np.clip(tol * b_norm / r_norm, 1e-7, 0.1))
            # The correction solve goes back through solve() itself (with
            # refine=0) so it inherits EVERYTHING that made the primary
            # solve converge: basis_norm, the already-resolved spectral
            # bounds (no repeated Lanczos estimate), and chunk_iters'
            # bounded dispatches (ADVICE r4: dropping these re-ran the raw
            # monomial basis — which can NaN on exactly the systems where
            # refine is needed — and re-estimated bounds per step).
            d_corr, seg = solve(
                A,
                r64.astype(A.dtype),
                method=method,
                x0=None,
                tol=inner_tol,
                maxiter=maxiter,
                k=k,
                M=M,
                mesh=mesh,
                scalar_dtype=scalar_dtype,
                chunk_iters=chunk_iters,
                basis_norm=basis_norm,
                spectral_bounds=spectral_bounds,
            )
            x64 = x64 + np.asarray(d_corr, dtype=np.float64)
            refinements += 1
            true_rel = float(
                np.linalg.norm(b64 - host_matvec64(A_host, x64)) / b_norm
            )
            info["time"] += seg["time"]
            info["nosl"] = np.concatenate(
                [info["nosl"], seg["nosl"][1:] + info["nosl"][-1]]
            )
            # the defect solve's residual history, rescaled to the original
            # system (its b is the defect r)
            info["residual"] = np.concatenate(
                [info["residual"], seg["residual"][1:] * (r_norm / b_norm)]
            )
            if "khistory" in info and "khistory" in seg:
                info["khistory"] = np.concatenate(
                    [info["khistory"], seg["khistory"][1:]]
                )
            if "final_k" in seg:
                info["final_k"] = seg["final_k"]
            info["iterations"] += seg["iterations"]
        # refine's contract is convergence of the TRUE residual; the recurred
        # notion from the initial solve is superseded by this check.
        info["converged"] = bool(true_rel < tol)
        info["true_residual"] = true_rel
        info["refinements"] = refinements
        x_out = x64  # float64: casting back to f32 would re-floor ||b-Ax||
        elapsed = info["time"]

    if verbose:
        finish_banner(
            elapsed,
            info["converged"],
            info["iterations"],
            info["residual"][-1],
            info.get("final_k"),
        )
    return (np.asarray(result.x) if x_out is None else x_out), info


def solve_batched(
    A,
    B,
    method: str = "cg",
    X0=None,
    tol: float = 1e-5,
    maxiter: Optional[int] = None,
    k: int = 0,
    M=None,
    mesh=None,
    scalar_dtype=None,
    basis_norm: bool = False,
    spectral_bounds=None,
):
    """Solve ``A x_i = b_i`` for a whole batch of right-hand sides at once.

    ``B`` is (batch, N); returns the on-device batched
    :class:`~krylov_tpu.solvers.SolveResult` (``x`` is (batch, N), traces are
    (batch, maxiter+1), ...).  The batch runs as ONE jitted dispatch — each
    system keeps its own convergence point (converged members freeze while
    the rest iterate).  A capability the reference has no analog for: its
    host-side loops can only solve one system at a time (reference:
    v3/cpu/cg.py:19).

    Composition: ``M`` (preconditioner) works with the preconditioned
    methods, and ``mesh`` runs the batch row-partitioned (the batch axis
    vmaps *inside* the ``shard_map``, so per-system reductions batch into
    single collectives).
    """
    A = as_operator(A)
    if mesh is None:
        from krylov_tpu.sparse.formats import to_device

        A = to_device(A)
    B = jnp.asarray(B, dtype=A.dtype)
    if B.ndim != 2 or B.shape[1] != A.shape[0]:
        raise ValueError(f"B must be (batch, N={A.shape[0]}), got {B.shape}")
    n = B.shape[1]
    if maxiter is None:
        maxiter = n
    X0 = (
        jnp.zeros_like(B)
        if X0 is None
        else jnp.asarray(X0, dtype=A.dtype)
    )
    if mesh is not None:
        from krylov_tpu.dist import solve_sharded

        return solve_sharded(
            A, B, X0, tol=tol, method=method, maxiter=maxiter, k=k, M=M,
            mesh=mesh, scalar_dtype=scalar_dtype, basis_norm=basis_norm,
            spectral_bounds=_resolve_bounds(A, method, spectral_bounds),
        )
    return _run_batched(
        A, B, X0, jnp.asarray(tol, dtype=A.dtype), M,
        method=method, maxiter=maxiter, k=k,
        ctx=Context(axis=None, scalar_dtype=scalar_dtype),
        basis_norm=basis_norm and method in _KSKIP_METHODS,
        sb=_resolve_bounds(A, method, spectral_bounds),
    )


@partial(
    jax.jit,
    static_argnames=("method", "maxiter", "k", "ctx", "basis_norm", "sb"),
)
def _run_batched(
    A, B, X0, tol, M, *, method, maxiter, k, ctx, basis_norm=False, sb=None,
):
    kernel = _get_kernel(method)
    kwargs = dict(tol=tol, maxiter=maxiter, ctx=ctx)
    if method in _KSKIP_METHODS:
        kwargs["k"] = k
        if basis_norm:
            kwargs["basis_norm"] = True
    if method in _CACG_METHODS:
        kwargs["s"] = max(k, 1)
        kwargs["lmin"], kwargs["lmax"] = sb
    if method in _PRECONDITIONED_METHODS:
        kwargs["M"] = M

    def one(b, x0):
        return kernel(A, b, x0, **kwargs)

    return jax.vmap(one)(B, X0)


def _scipy_style(method):
    def f(
        A,
        b,
        x=None,
        tol=1e-05,
        maxiter=None,
        k=0,
        M=None,
        callback=None,
        atol=None,
        **kw,
    ):
        if callback is not None or atol is not None:
            # Accepted-but-unused in the reference too (reference: v3/cpu/cg.py:7).
            pass
        return solve(A, b, method=method, x0=x, tol=tol, maxiter=maxiter, k=k, M=M, **kw)

    f.__name__ = method
    f.__doc__ = f"Reference-compatible wrapper for method={method!r}; see :func:`solve`."
    return f


cg = _scipy_style("cg")
mrr = _scipy_style("mrr")
kskipcg = _scipy_style("kskipcg")
kskipmrr = _scipy_style("kskipmrr")
adaptivekskipmrr = _scipy_style("adaptivekskipmrr")
pcg = _scipy_style("pcg")
chronopoulos_gear = _scipy_style("chronopoulos_gear")
gropp = _scipy_style("gropp")
pipelined_cg = _scipy_style("pipelined_cg")
