"""Normalized-basis (``basis_norm=``) stabilization of the k-skip family.

The raw monomial basis ``A^j r`` collapses in float32 on
stiff operators (overflow + cancellation — NaN in float32 k-skip runs on
the graded power-law system).  ``basis_norm`` scales each basis vector by the nearest POWER OF
TWO of its norm (exact in floating point — no added rounding) and carries
the cumulative scales through the bundle, so alpha/beta/delta take exactly
their mathematical values.  These tests pin:

- float64 parity: identical iteration counts with and without basis_norm
  (the algebra is exact; reference recurrences unchanged,
  reference: v3/cpu/kskipmrr.py:72-93);
- float32 + f64 scalars on an ill-conditioned system (the row-4b class,
  kappa ~ 1e5): basis_norm keeps the k-skip family finite and converging
  where the raw basis diverges;
- the sharded (mesh) path supports basis_norm (the chain norms psum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import krylov_tpu
from krylov_tpu.sparse import as_operator
from krylov_tpu.sparse.fixtures import laplace2d, powerlaw_spd
from krylov_tpu.solvers._common import pow2_scale


def test_pow2_scale_properties():
    s = jnp.asarray([1e-30, 0.7, 1.0, 1.5, 3.0, 1264.0, 1e30])
    out = np.asarray(pow2_scale(s))
    # every output is an exact power of two
    m, e = np.frexp(out)
    assert np.all(m == 0.5)
    # within a factor sqrt(2) of the input
    assert np.all(out / np.asarray(s) <= np.sqrt(2.0) + 1e-12)
    assert np.all(out / np.asarray(s) >= 1.0 / np.sqrt(2.0) - 1e-12)
    # degenerate inputs map to 1.0 (zero vectors stay zero, Gram stays clean)
    bad = np.asarray(pow2_scale(jnp.asarray([0.0, -1.0, np.nan, np.inf])))
    assert np.all(bad == 1.0)


@pytest.mark.parametrize("method", ["kskipcg", "kskipmrr", "adaptivekskipmrr"])
@pytest.mark.parametrize("k", [2, 4])
def test_f64_iteration_parity(method, k, rng):
    """Exact algebra: in float64 the normalized-basis solve makes the same
    decisions as the raw-basis solve (same iteration count) and the early
    residual histories agree to tight tolerance."""
    A = laplace2d(48, dtype=np.float64)
    b = rng.standard_normal(48 * 48)
    _, i1 = krylov_tpu.solve(A, b, method=method, k=k, tol=1e-8, maxiter=4000)
    _, i2 = krylov_tpu.solve(
        A, b, method=method, k=k, tol=1e-8, maxiter=4000, basis_norm=True
    )
    assert i1["iterations"] == i2["iterations"]
    m = min(6, len(i1["residual"]), len(i2["residual"]))
    np.testing.assert_allclose(
        i1["residual"][:m], i2["residual"][:m], rtol=1e-9
    )


def _hard_problem(n=2048, dtype=np.float32, seed=0):
    """Power-law graph Laplacian with graded diagonal (kappa ~ 1e5) — the
    system where the raw f32 k-skip basis records NaN."""
    A64 = powerlaw_spd(n, shift=1e-3, diag_scale_decades=1.5, seed=seed)
    return A64, as_operator(A64.astype(dtype))


def _true_res(A64, b, x):
    b64 = np.asarray(b, np.float64)
    return float(
        np.linalg.norm(b64 - A64 @ np.asarray(x, np.float64))
        / np.linalg.norm(b64)
    )


def test_f32_kskipmrr_k4_converges_with_basis_norm(rng):
    A64, Ao = _hard_problem()
    b = rng.standard_normal(A64.shape[0]).astype(np.float32)
    x, info = krylov_tpu.solve(
        Ao, b, method="kskipmrr", k=4, tol=1e-4, maxiter=4000,
        scalar_dtype=jnp.float64, basis_norm=True,
    )
    assert info["converged"]
    assert np.isfinite(info["residual"]).all()
    assert _true_res(A64, b, x) < 5e-4


def test_f32_adaptive_k8_with_basis_norm_beats_raw(rng):
    """At k=8 the raw f32 basis overflows outright; basis_norm keeps the
    adaptive solver finite and converging (the rollback handles the rest,
    reference semantics: v3/cpu/adaptivekskipmrr.py:44-66)."""
    A64, Ao = _hard_problem()
    b = rng.standard_normal(A64.shape[0]).astype(np.float32)
    x, info = krylov_tpu.solve(
        Ao, b, method="adaptivekskipmrr", k=8, tol=1e-4, maxiter=4000,
        scalar_dtype=jnp.float64, basis_norm=True,
    )
    assert info["converged"]
    assert np.isfinite(info["residual"]).all()
    assert _true_res(A64, b, x) < 5e-4


def test_basis_norm_sharded_matches_single_device(rng):
    """The chain-norm reductions psum correctly under shard_map."""
    from jax.sharding import Mesh

    A = laplace2d(32, dtype=np.float64)
    b = rng.standard_normal(32 * 32)
    mesh = Mesh(np.array(jax.devices()[:4]), ("rows",))
    _, i_single = krylov_tpu.solve(
        A, b, method="kskipmrr", k=2, tol=1e-8, maxiter=2000, basis_norm=True
    )
    _, i_mesh = krylov_tpu.solve(
        A, b, method="kskipmrr", k=2, tol=1e-8, maxiter=2000,
        basis_norm=True, mesh=mesh,
    )
    assert i_single["iterations"] == i_mesh["iterations"]
    np.testing.assert_allclose(
        i_single["residual"], i_mesh["residual"], rtol=1e-8
    )


def test_basis_norm_chunked_exact(rng):
    """chunk_iters carry-continuation composes with basis_norm."""
    A = laplace2d(32, dtype=np.float64)
    b = rng.standard_normal(32 * 32)
    _, i_full = krylov_tpu.solve(
        A, b, method="kskipmrr", k=2, tol=1e-8, maxiter=2000, basis_norm=True
    )
    _, i_chunk = krylov_tpu.solve(
        A, b, method="kskipmrr", k=2, tol=1e-8, maxiter=2000,
        basis_norm=True, chunk_iters=50,
    )
    assert i_full["iterations"] == i_chunk["iterations"]
    np.testing.assert_allclose(
        i_full["residual"], i_chunk["residual"][: len(i_full["residual"])],
        rtol=1e-9,
    )
