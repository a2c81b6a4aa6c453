"""CA-CG with Chebyshev s-step basis (beyond-reference capability).

The reference's monomial k-skip recurrences collapse in working precision
on stiff operators (reference: v3/cpu/kskipcg.py:59-64 is f64-only by
construction, v3/cpu/common.py:23).  ``cacg`` spans the same Krylov space
with a Chebyshev basis + Gram-matrix coefficient algebra
(:mod:`krylov_tpu.solvers.cacg`), which these tests pin:

- float64: iteration counts track plain CG (the method IS CG in exact
  arithmetic, one reduction per s steps);
- float32 (+f64 scalars) on the kappa~1e5 graded-spectrum system: s=8 and
  s=16 converge where monomial k-skip records NaN;
- chunk-carry exactness, mesh-path agreement, Lanczos-default and
  explicit spectral bounds, and the monomial-basis ablation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import krylov_tpu
from krylov_tpu.sparse import as_operator
from krylov_tpu.sparse.fixtures import laplace2d, powerlaw_spd


def _hard(n=2048, seed=0):
    A64 = powerlaw_spd(n, shift=1e-3, diag_scale_decades=1.5, seed=seed)
    return A64, as_operator(A64.astype(np.float32))


def _true_res(A64, b, x):
    b64 = np.asarray(b, np.float64)
    return float(
        np.linalg.norm(b64 - A64 @ np.asarray(x, np.float64))
        / np.linalg.norm(b64)
    )


@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_f64_tracks_plain_cg(s, rng):
    A = laplace2d(48, dtype=np.float64)
    b = rng.standard_normal(48 * 48)
    _, icg = krylov_tpu.solve(A, b, method="cg", tol=1e-8, maxiter=4000)
    _, ica = krylov_tpu.solve(A, b, method="cacg", k=s, tol=1e-8, maxiter=4000)
    assert ica["converged"]
    # same Krylov method: iteration counts agree to within one s-block
    assert abs(ica["iterations"] - icg["iterations"]) <= s


@pytest.mark.parametrize("s", [8, 16])
def test_f32_converges_at_large_s_where_monomial_dies(s, rng):
    """The headline property: float32 communication-avoiding CG at s=8/16
    on the graded power-law problem class (monomial k-skip records NaN
    there at k>=4)."""
    A64, Ao = _hard()
    b = rng.standard_normal(A64.shape[0]).astype(np.float32)
    x, info = krylov_tpu.solve(
        Ao, b, method="cacg", k=s, tol=1e-4, maxiter=6000,
        scalar_dtype=jnp.float64,
    )
    assert info["converged"]
    assert np.isfinite(info["residual"]).all()
    assert _true_res(A64, b, x) < 5e-4


def test_pure_f32_still_finite_and_converging(rng):
    A64, Ao = _hard()
    b = rng.standard_normal(A64.shape[0]).astype(np.float32)
    x, info = krylov_tpu.solve(Ao, b, method="cacg", k=8, tol=1e-4, maxiter=8000)
    assert info["converged"]
    assert _true_res(A64, b, x) < 5e-4


def test_monomial_ablation_matches_in_f64(rng):
    """basis="monomial" through the same Gram algebra still equals CG in
    f64 at small s (the basis, not the algebra, is what Chebyshev fixes)."""
    from krylov_tpu.solvers.cacg import cacg_kernel

    A = laplace2d(24, dtype=np.float64)
    Ad = jax.tree.map(jnp.asarray, A)
    b = jnp.asarray(rng.standard_normal(576))
    res_c = cacg_kernel(
        Ad, b, jnp.zeros_like(b), tol=1e-8, maxiter=2000, s=2,
        lmin=0.01, lmax=8.0,
    )
    res_m = cacg_kernel(
        Ad, b, jnp.zeros_like(b), tol=1e-8, maxiter=2000, s=2,
        basis="monomial",
    )
    assert bool(res_c.converged) and bool(res_m.converged)
    assert int(res_c.iterations) == int(res_m.iterations)


def test_chunked_carry_is_exact(rng):
    A = laplace2d(32, dtype=np.float64)
    b = rng.standard_normal(1024)
    _, i1 = krylov_tpu.solve(A, b, method="cacg", k=4, tol=1e-8, maxiter=2000)
    _, i2 = krylov_tpu.solve(
        A, b, method="cacg", k=4, tol=1e-8, maxiter=2000, chunk_iters=40
    )
    assert i1["iterations"] == i2["iterations"]
    np.testing.assert_allclose(
        i1["residual"], i2["residual"][: len(i1["residual"])], rtol=1e-12
    )


def test_mesh_matches_single_device(rng):
    from jax.sharding import Mesh

    A = laplace2d(32, dtype=np.float64)
    b = rng.standard_normal(1024)
    mesh = Mesh(np.array(jax.devices()[:4]), ("rows",))
    _, i1 = krylov_tpu.solve(A, b, method="cacg", k=4, tol=1e-8, maxiter=2000)
    _, im = krylov_tpu.solve(
        A, b, method="cacg", k=4, tol=1e-8, maxiter=2000, mesh=mesh
    )
    assert i1["iterations"] == im["iterations"]
    # sharded Gram reduces in a different order; tail entries sit at the
    # f64 round-off floor
    np.testing.assert_allclose(
        i1["residual"], im["residual"], rtol=1e-6, atol=1e-14
    )


def test_explicit_spectral_bounds(rng):
    A = laplace2d(32, dtype=np.float64)
    b = rng.standard_normal(1024)
    _, info = krylov_tpu.solve(
        A, b, method="cacg", k=4, tol=1e-8, maxiter=2000,
        spectral_bounds=(0.01, 8.0),
    )
    assert info["converged"]


def test_bad_bounds_raise():
    from krylov_tpu.solvers.cacg import cacg_kernel

    A = laplace2d(8, dtype=np.float64)
    b = jnp.ones(64)
    with pytest.raises(ValueError, match="spectral bounds"):
        cacg_kernel(
            jax.tree.map(jnp.asarray, A), b, jnp.zeros_like(b),
            tol=1e-6, maxiter=10, s=2, lmin=5.0, lmax=1.0,
        )


@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_camrr_f64_tracks_plain_mrr(s, rng):
    A = laplace2d(48, dtype=np.float64)
    b = rng.standard_normal(48 * 48)
    _, imrr = krylov_tpu.solve(A, b, method="mrr", tol=1e-8, maxiter=4000)
    _, icam = krylov_tpu.solve(
        A, b, method="camrr", k=s, tol=1e-8, maxiter=4000
    )
    assert icam["converged"]
    assert abs(icam["iterations"] - imrr["iterations"]) <= s + 1


@pytest.mark.parametrize("s", [4, 8])
def test_camrr_f32_converges_where_kskipmrr_dies(s, rng):
    """CA-MrR at s=8 on the row-4b class — the reference's flagship family
    (v3/cpu/kskipmrr.py) in its float32-stable communication-avoiding form
    (monomial kskipmrr records NaN here at k>=4)."""
    A64, Ao = _hard()
    b = rng.standard_normal(A64.shape[0]).astype(np.float32)
    x, info = krylov_tpu.solve(
        Ao, b, method="camrr", k=s, tol=1e-4, maxiter=6000,
        scalar_dtype=jnp.float64,
    )
    assert info["converged"]
    assert np.isfinite(info["residual"]).all()
    assert _true_res(A64, b, x) < 5e-4


def test_camrr_chunked_and_mesh_agree(rng):
    from jax.sharding import Mesh

    A = laplace2d(32, dtype=np.float64)
    b = rng.standard_normal(1024)
    _, i1 = krylov_tpu.solve(A, b, method="camrr", k=4, tol=1e-8, maxiter=2000)
    _, i2 = krylov_tpu.solve(
        A, b, method="camrr", k=4, tol=1e-8, maxiter=2000, chunk_iters=40
    )
    mesh = Mesh(np.array(jax.devices()[:4]), ("rows",))
    _, im = krylov_tpu.solve(
        A, b, method="camrr", k=4, tol=1e-8, maxiter=2000, mesh=mesh
    )
    assert i1["iterations"] == i2["iterations"] == im["iterations"]


def _kernel_dots(method, scalar_dtype):
    """Every dot_general in the traced cacg/camrr kernel (loop and branch
    bodies included)."""
    from krylov_tpu.context import Context
    from krylov_tpu.solvers.cacg import cacg_kernel, camrr_kernel

    kernel = cacg_kernel if method == "cacg" else camrr_kernel
    A = as_operator(laplace2d(16, dtype=np.float32))
    b = jnp.ones(256, jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda b: kernel(
            A, b, jnp.zeros_like(b), tol=1e-5, maxiter=16, s=4,
            lmin=0.05, lmax=8.0,
            ctx=Context(scalar_dtype=scalar_dtype),
        )
    )(b)

    def walk(jx, out):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn)
            for v in eqn.params.values():
                if hasattr(v, "jaxpr"):
                    walk(v.jaxpr, out)
                elif isinstance(v, (list, tuple)):
                    for u in v:
                        if hasattr(u, "jaxpr"):
                            walk(u.jaxpr, out)
        return out

    return walk(jaxpr.jaxpr, [])


def _assert_highest(eqns):
    from jax import lax

    for e in eqns:
        prec = e.params.get("precision")
        assert prec is not None and all(
            p == lax.Precision.HIGHEST for p in (
                prec if isinstance(prec, tuple) else (prec,)
            )
        ), f"dot_general without HIGHEST precision: {e}"


@pytest.mark.parametrize("method", ["cacg", "camrr"])
def test_recovery_matmuls_pin_highest_precision(method):
    """The basis-recovery combinations ``x_hat @ V`` / ``p_hat @ V`` MUST
    run at ``Precision.HIGHEST``.

    At the default precision a float32 matmul may run in TF32 on a GPU
    (~1e-3 relative error); the carried search direction must preserve
    CG's cross-outer conjugacy in full working precision.  CPU ignores
    the precision flag, so this pins the STRUCTURE: every float32
    dot_general in the traced kernel carries HIGHEST precision.
    """
    dots = _kernel_dots(method, jnp.float64)
    f32_dots = [
        e for e in dots
        if any(getattr(v.aval, "dtype", None) == jnp.float32 for v in e.invars)
    ]
    assert f32_dots, "expected f32 recovery matmuls in the kernel trace"
    _assert_highest(f32_dots)


@pytest.mark.parametrize("method", ["cacg", "camrr"])
def test_coefficient_products_pin_highest_precision(method):
    """With float32 scalars the coefficient-space products (``T @ p_hat``,
    ``G @ w``, the Gram-weighted inner products) are float32 matmuls too:
    every dot_general of the kernel, not only the recovery, must carry
    HIGHEST so that none of them can run in TF32."""
    dots = _kernel_dots(method, None)
    assert len(dots) > 4, "expected coefficient-space products in the trace"
    _assert_highest(dots)


@pytest.mark.parametrize("method", ["cacg", "camrr"])
def test_divergence_guard_returns_best_iterate(method, rng):
    """Regression (mechanism test): s-step Krylov
    methods are unstable PAST the working-precision floor — measured on
    CPU, a forced continuation (unreachable tol) blew up within two outer
    iterations of reaching the floor (1.6e-7 -> 1.1e-5 -> 4.9e-3 at
    n=16k, s=8) before the guard existed.  Where the attainable floor
    sits just above ``tol``, an un-guarded cacg crosses into that
    instability (residual 41.3 / NaN were seen that way).  The guard
    must (a) keep the trace finite-or-rolled-back and (b) return the best
    iterate, never a diverged one.
    """
    A = laplace2d(48, dtype=np.float32)
    n = 48 * 48
    b = rng.standard_normal(n).astype(np.float32)
    # tol=1e-30 is unreachable in f32: the solve runs its full maxiter
    # budget straight through the floor and into the instability.
    x, info = krylov_tpu.solve(
        A, b, method=method, k=8, tol=1e-30, maxiter=320,
        scalar_dtype=jnp.float64,
    )
    true = float(
        np.linalg.norm(b - np.asarray(A.matvec(jnp.asarray(x)), np.float64).astype(np.float64))
        / np.linalg.norm(b)
    )
    assert not info["converged"]
    # The f32 floor here is ~1e-7; anything under 1e-5 proves the best
    # iterate survived the post-floor regime (the unguarded kernel
    # returned O(1)-or-NaN iterates).
    assert np.isfinite(true) and true < 1e-5, true
