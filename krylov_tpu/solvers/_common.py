"""Shared machinery for the jitted solver kernels.

Design notes (vs. the reference's host-side loops):

The reference iterates in Python, checking ``residual[i] < tol`` on the host
each iteration and ``break``-ing out (reference: v3/cpu/cg.py:19-24).  On an
accelerator that would force a device→host sync per iteration, so every
solver here is a single ``lax.while_loop`` whose predicate lives on device:

- the carry holds the iterate state plus ``(i, index, converged)`` and
  fixed-size residual / solution-update traces (``maxiter`` is static);
- each body writes ``residual[index]``, evaluates convergence, computes the
  next state unconditionally, and keeps the *old* state when converged (the
  loop then exits at the next predicate check) — this reproduces the
  reference's check-then-break ordering exactly, at the cost of one dead
  update at convergence;
- on divergence (loop exhausts ``maxiter``) the final residual is written
  after the loop, matching the reference's ``while/else`` branch
  (reference: v3/cpu/cg.py:37-40).

The python-facing wrappers in :mod:`krylov_tpu.api` slice the traces to
``index+1`` and assemble the reference-compatible info dict.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp


def tree_select(pred, on_true, on_false):
    """Elementwise ``where`` over a pytree (predicate is a scalar bool)."""
    return jax.tree.map(lambda a, b: jnp.where(pred, a, b), on_true, on_false)


def pow2_scale(s):
    """Nearest power of two to ``s`` (1.0 where ``s <= 0`` / non-finite).

    Used by the ``basis_norm`` Krylov-chain stabilization: scaling a vector
    by a power of two is EXACT in floating point (only the exponent field
    changes), so normalizing each basis vector by ``pow2_scale(||v||)``
    keeps the Gram entries O(1) — preventing the float32 overflow of the
    raw monomial basis — while introducing ZERO additional rounding into
    the basis vectors themselves (a plain ``v / ||v||`` rounds every entry
    and measurably perturbs the k-skip trajectory).
    """
    ok = jnp.isfinite(s) & (s > 0)
    e = jnp.round(jnp.log2(jnp.where(ok, s, 1.0))).astype(jnp.int32)
    # Construct 2**e exactly from the float32 bit pattern (e+127)<<23.
    # exp2 lowers to exp(e*ln2) on XLA and is off by an ulp for large |e|
    # (breaking the exact-scaling guarantee).  All per-step norms fit the
    # float32 exponent range (the basis vectors are working-precision); the
    # clip makes out-of-range float64 norms scale partially (still an exact
    # power of two) rather than overflow.
    e = jnp.clip(e, -126, 127)
    val32 = jax.lax.bitcast_convert_type(
        ((e + 127) << 23).astype(jnp.int32), jnp.float32
    )
    val = val32.astype(s.dtype)
    return jnp.where(ok, val, jnp.ones_like(s))


def safe_div(num, den):
    """``num / den`` with exact-zero denominators mapped to 0.

    Krylov recurrences divide by inner products that become exactly zero at
    exact convergence (e.g. ``<Ap, p>`` once ``p == 0``).  The reference
    implementations produce NaN there and report divergence even though the
    iterate is exact (observed on reference: v3/cpu/kskipmrr.py:87-88 and
    v3/cpu/kskipcg.py:50-51 with rhs vectors exciting few eigenmodes).  A
    zero quotient instead freezes the affected update (the step becomes a
    no-op), so the converged iterate survives to the next residual check.
    For nonzero denominators this is bit-identical to a plain divide.
    """
    zero = den == 0
    return jnp.where(zero, jnp.zeros_like(num), num / jnp.where(zero, 1, den))


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Fixed-shape result of a jitted solver kernel.

    ``residual_trace``/``nosl_trace``/``k_trace`` are full ``maxiter+1``-sized
    buffers; entries beyond ``index`` are undefined.  ``iterations`` is the
    reference's ``i`` (number of solution updates), ``index`` the number of
    outer iterations (they differ for the k-skip family, reference:
    v3/cpu/kskipcg.py:66-68).
    """

    x: jax.Array
    residual_trace: jax.Array
    nosl_trace: jax.Array
    iterations: jax.Array  # i
    index: jax.Array  # outer-iteration count
    converged: jax.Array  # bool
    k_trace: Optional[jax.Array] = None
    final_k: Optional[jax.Array] = None
    # Device-computed ||b - A x|| / ||b|| (set by the ``restarts=`` defect-
    # correction path in :mod:`krylov_tpu.api`; None otherwise).
    true_residual: Optional[jax.Array] = None
    # Opaque solver-state tuple for EXACT chunked continuation (cg/mrr with
    # ``emit_carry=True``): feed back via ``carry_in=(carry, valid)`` and the
    # next chunk resumes the recurrence bit-for-bit — no Krylov restart.
    carry: Optional[tuple] = None


jax.tree_util.register_dataclass(
    SolveResult,
    data_fields=[
        "x",
        "residual_trace",
        "nosl_trace",
        "iterations",
        "index",
        "converged",
        "k_trace",
        "final_k",
        "true_residual",
        "carry",
    ],
    meta_fields=[],
)


def scalar_dtype_of(ctx, b):
    return ctx.scalar_dtype if ctx.scalar_dtype is not None else b.dtype


def check_square(A, b):
    n = b.shape[-1]
    if A.shape[0] != A.shape[1] or A.shape[0] != n:
        raise ValueError(f"system shape mismatch: A {A.shape}, b {b.shape}")
    return n
