"""``shard_map`` wrapper: run ANY solver kernel row-partitioned over a mesh.

This is the single mesh-parameterized entry point that replaces the
reference's per-backend solver copies (reference: the v3/cpu/mpi and
v3/gpu/mpi trees re-implement every algorithm).  The SAME kernel functions
from :mod:`krylov_tpu.solvers` run here unchanged — only the
:class:`~krylov_tpu.context.Context` (axis name) and the operator
(:class:`~krylov_tpu.dist.spmv.ShardedOperator`) change.

Unlike the reference's MPI variants, which return the result on rank 0 and
``exit(0)`` on every other rank (reference: v3/cpu/mpi/cg.py:61-62), the
sharded solve returns replicated traces and the sharded solution on all
hosts, keeping the solve composable inside larger jitted programs.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from krylov_tpu.context import Context
from krylov_tpu.solvers._common import SolveResult
from krylov_tpu.sparse.convert import pad_to_multiple
from krylov_tpu.dist.spmv import shard_operator

_KSKIP_METHODS = {"kskipcg", "kskipmrr", "adaptivekskipmrr"}
_CACG_METHODS = {"cacg", "camrr"}
_PRECONDITIONED_METHODS = {"pcg", "chronopoulos_gear", "gropp", "pipelined_cg"}

_CACHE: dict = {}
_CACHE_MAX = 128  # FIFO-evicted; bounds memory in long-lived processes


def pad_preconditioner(M, multiple: int):
    """Zero-pad a preconditioner so its N divides ``multiple``.

    Mirrors :func:`~krylov_tpu.sparse.convert.pad_to_multiple` for the system
    operator: padding rows get a unit diagonal, so the padded preconditioner
    acts as the identity on the pad block.  That is exact — the padded rhs
    entries are zero and every Krylov vector stays zero there (the padded A
    is also identity on the block), so M_pad never mixes pad and real rows.
    """
    import dataclasses as _dc

    from krylov_tpu.precond import ChebyshevPreconditioner

    if M is None:
        return None
    if isinstance(M, ChebyshevPreconditioner):
        # Chebyshev applies a polynomial of A; padding the inner operator
        # with a unit diagonal makes the polynomial act as the scalar p(1) on
        # the pad block — harmless for the same pad-rows-stay-zero reason.
        A_p, _, _ = pad_to_multiple(M.A, np.zeros(M.A.shape[0]), multiple)
        return _dc.replace(M, A=A_p)
    M_p, _, _ = pad_to_multiple(M, np.zeros(M.shape[0]), multiple)
    return M_p


def shard_preconditioner(M, n_devices: int, axis: str):
    """Prepare (sharded M pytree, specs) mirroring :func:`shard_operator`.

    Supports library-operator preconditioners (Jacobi's diagonal DiaMatrix,
    any container) and :class:`~krylov_tpu.precond.ChebyshevPreconditioner`
    (its inner operator is sharded recursively, so the polynomial recurrence
    runs on row blocks with the same halo/all-gather collectives as A).
    """
    import dataclasses as _dc

    from krylov_tpu.precond import ChebyshevPreconditioner

    if M is None:
        return None, None
    if isinstance(M, ChebyshevPreconditioner):
        inner_op, inner_specs = shard_operator(M.A, n_devices, axis=axis)
        return (
            _dc.replace(M, A=inner_op),
            _dc.replace(M, A=inner_specs),
        )
    return shard_operator(M, n_devices, axis=axis)


def _build(
    mesh, axis, method, maxiter, k, ctx, op_specs, m_specs, has_k_trace,
    batched=False, basis_norm=False, sb=None,
):
    key = (
        mesh, axis, method, maxiter, k, ctx, op_specs, m_specs, has_k_trace,
        batched, basis_norm, sb,
    )
    if key in _CACHE:
        return _CACHE[key]

    from krylov_tpu.api import _get_kernel

    kernel = _get_kernel(method)
    vec_spec = P(None, axis) if batched else P(axis)
    in_specs = (op_specs, vec_spec, vec_spec, P())
    if m_specs is not None:
        in_specs = in_specs + (m_specs,)
    scal_spec = P(None) if batched else P()
    out_specs = SolveResult(
        x=vec_spec,
        residual_trace=scal_spec,
        nosl_trace=scal_spec,
        iterations=scal_spec,
        index=scal_spec,
        converged=scal_spec,
        k_trace=scal_spec if has_k_trace else None,
        final_k=scal_spec if has_k_trace else None,
    )

    def local_fn(op, b_local, x0_local, tol, *maybe_m):
        kwargs = dict(tol=tol, maxiter=maxiter, ctx=ctx)
        if method in _KSKIP_METHODS:
            kwargs["k"] = k
            if basis_norm:
                kwargs["basis_norm"] = True
        if method in _CACG_METHODS:
            kwargs["s"] = max(k, 1)
            kwargs["lmin"], kwargs["lmax"] = sb
        if method in _PRECONDITIONED_METHODS:
            kwargs["M"] = maybe_m[0] if maybe_m else None

        def one(b_l, x0_l):
            return kernel(op, b_l, x0_l, **kwargs)

        if batched:
            # vmap INSIDE shard_map: each device vmaps over the batch of its
            # local row blocks; the per-system psums/ppermutes batch cleanly.
            return jax.vmap(one)(b_local, x0_local)
        return one(b_local, x0_local)

    fn = jax.jit(
        jax.shard_map(local_fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    )
    if len(_CACHE) >= _CACHE_MAX:
        _CACHE.pop(next(iter(_CACHE)))
    _CACHE[key] = fn, in_specs
    return fn, in_specs


def plan_sharded(
    A,
    b,
    x0,
    *,
    tol: float,
    method: str,
    maxiter: int,
    k: int = 0,
    M=None,
    mesh: Mesh,
    scalar_dtype=None,
    basis_norm: bool = False,
    spectral_bounds=None,
):
    """Pad and row-partition the system over ``mesh`` and compile its program.

    Returns ``(compiled, args, compile_seconds)``: ``compiled(*args)`` solves
    the padded system.  Every input in ``args`` is already placed in the
    program's row-block layout (the operator ``args[0]`` too), so the
    timed call moves no input: placing them from device 0 at the call
    costs more than a whole small solve.  Compilation goes through the same
    cache as the single-device path (:func:`krylov_tpu.api._aot_compile`),
    so ``compile_seconds`` is 0.0 on a cache hit."""
    (axis,) = mesh.axis_names
    n_devices = mesh.devices.size
    batched = np.asarray(b).ndim == 2
    n_orig = np.asarray(b).shape[-1]

    b_np = np.asarray(b)
    x0_np = np.asarray(x0)
    A_p, _, _ = pad_to_multiple(A, b_np[0] if batched else b_np, n_devices)
    pad = A_p.shape[0] - n_orig
    if pad:
        pad_widths = [(0, 0)] * (b_np.ndim - 1) + [(0, pad)]
        b_p = np.pad(b_np, pad_widths)
        x0_p = np.pad(x0_np, pad_widths)
    else:
        b_p, x0_p = b_np, x0_np

    M_p = pad_preconditioner(M, n_devices) if pad else M
    op, op_specs = shard_operator(A_p, n_devices, axis=axis)
    m_op, m_specs = shard_preconditioner(M_p, n_devices, axis=axis)
    ctx = Context(axis=axis, scalar_dtype=scalar_dtype)
    has_k_trace = method == "adaptivekskipmrr"
    if method in _CACG_METHODS and spectral_bounds is None:
        from krylov_tpu.api import _resolve_bounds

        spectral_bounds = _resolve_bounds(A, method, None)
    fn, in_specs = _build(
        mesh, axis, method, maxiter, k, ctx, op_specs, m_specs, has_k_trace,
        batched=batched, basis_norm=basis_norm,
        sb=tuple(spectral_bounds) if spectral_bounds else None,
    )

    args = (op, b_p, x0_p, np.asarray(tol))
    if m_op is not None:
        args = args + (m_op,)
    args = jax.device_put(args, jax.tree.map(
        lambda s: NamedSharding(mesh, s), in_specs,
        is_leaf=lambda s: isinstance(s, P),
    ))

    from krylov_tpu.api import _aot_compile

    compiled, compile_s = _aot_compile(fn, args, {})
    return compiled, args, compile_s


def solve_sharded(
    A,
    b,
    x0,
    *,
    tol: float,
    method: str,
    maxiter: int,
    k: int = 0,
    M=None,
    mesh: Mesh,
    scalar_dtype=None,
    basis_norm: bool = False,
    spectral_bounds=None,
    return_times: bool = False,
):
    """Row-partition the system over ``mesh`` and solve under ``shard_map``.

    ``b``/``x0`` may be (N,) for one system or (batch, N) for a batch of
    right-hand sides; batched solves vmap the kernel inside the shard_map
    (one compiled program, per-system convergence points).

    The sharded program is AOT-compiled by :func:`plan_sharded`, so
    repeated solves skip compilation entirely.  With ``return_times=True``
    returns ``(result, compile_seconds, exec_seconds)`` — compile separated
    from execution, matching the reference's loop-only timing
    (reference: v3/cpu/common.py:9-18); ``compile_seconds`` is 0.0 on a
    cache hit."""
    import time as _time

    n_orig = np.asarray(b).shape[-1]
    compiled, args, compile_s = plan_sharded(
        A, b, x0, tol=tol, method=method, maxiter=maxiter, k=k, M=M,
        mesh=mesh, scalar_dtype=scalar_dtype, basis_norm=basis_norm,
        spectral_bounds=spectral_bounds,
    )
    t0 = _time.perf_counter()
    result = jax.block_until_ready(compiled(*args))
    exec_s = _time.perf_counter() - t0
    if result.x.shape[-1] != n_orig:
        import dataclasses as _dc

        result = _dc.replace(result, x=result.x[..., :n_orig])
    if return_times:
        return result, compile_s, exec_s
    return result
