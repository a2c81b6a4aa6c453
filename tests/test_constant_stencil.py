"""Constant-coefficient StencilMatrix form: per-term scalar weights instead
of stored coefficient grids (same operator, no HBM coefficient traffic).

Every consumer must give bit-identical (or reduction-order-identical)
results vs the stored-grid form: XLA matvec, DIA conversion, preconditioner
extraction, and the sharded halo path.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import krylov_tpu
from krylov_tpu.dist import make_mesh
from krylov_tpu.precond import extract_diagonal, gershgorin_bounds, jacobi
from krylov_tpu.sparse.fixtures import laplace2d, laplace3d


@pytest.mark.parametrize("dims", [(16, 16), (17, 13)])
def test_grid_coef_materializes_grid_form(dims):
    Ac = laplace2d(*dims, constant=True)
    Ag = laplace2d(*dims)
    assert Ac.is_constant and not Ag.is_constant
    np.testing.assert_array_equal(
        np.asarray(Ac.grid_coef()), np.asarray(Ag.coef)
    )


def test_grid_coef_3d():
    Ac = laplace3d(5, 6, 7, constant=True)
    Ag = laplace3d(5, 6, 7)
    np.testing.assert_array_equal(
        np.asarray(Ac.grid_coef()), np.asarray(Ag.coef)
    )


@pytest.mark.parametrize("dims", [(16, 16), (17, 13)])
def test_matvec_matches_grid_form(dims):
    Ac = laplace2d(*dims, constant=True)
    Ag = laplace2d(*dims)
    x = np.random.default_rng(0).standard_normal(Ac.shape[0])
    np.testing.assert_array_equal(
        np.asarray(Ac.matvec(jnp.asarray(x))),
        np.asarray(Ag.matvec(jnp.asarray(x))),
    )


def test_matvec_matches_grid_form_3d():
    Ac = laplace3d(5, 6, 7, constant=True)
    Ag = laplace3d(5, 6, 7)
    x = np.random.default_rng(1).standard_normal(Ac.shape[0])
    np.testing.assert_array_equal(
        np.asarray(Ac.matvec(jnp.asarray(x))),
        np.asarray(Ag.matvec(jnp.asarray(x))),
    )


def test_to_dia_matches_grid_form():
    Ac = laplace2d(9, 11, constant=True)
    Ag = laplace2d(9, 11)
    Dc, Dg = Ac.to_dia(), Ag.to_dia()
    assert Dc.offsets == Dg.offsets
    np.testing.assert_array_equal(np.asarray(Dc.data), np.asarray(Dg.data))


def test_preconditioners_constant_form():
    Ac = laplace2d(12, constant=True)
    Ag = laplace2d(12)
    np.testing.assert_array_equal(extract_diagonal(Ac), extract_diagonal(Ag))
    np.testing.assert_array_equal(
        np.asarray(jacobi(Ac).data), np.asarray(jacobi(Ag).data)
    )
    assert gershgorin_bounds(Ac) == gershgorin_bounds(Ag)


@pytest.mark.parametrize("method", ["cg", "mrr", "kskipmrr"])
def test_sharded_halo_constant(method):
    """Replicated constant weights + zeroed wrap-around halos on the edge
    devices must reproduce the single-device solve on the 8-device mesh."""
    mesh = make_mesh(jax.devices()[:8])
    A = laplace2d(16, constant=True)
    b = np.random.default_rng(4).standard_normal(A.shape[0])
    k = 2 if method == "kskipmrr" else 0
    x1, i1 = krylov_tpu.solve(A, b, method=method, k=k, tol=1e-9, maxiter=2000)
    x8, i8 = krylov_tpu.solve(
        A, b, method=method, k=k, tol=1e-9, maxiter=2000, mesh=mesh
    )
    assert i1["converged"] and i8["converged"]
    np.testing.assert_allclose(x8, x1, rtol=1e-6, atol=1e-9)


def test_solve_constant_matches_grid(rng):
    """Front-door solve: same convergence path for both forms (XLA may fold
    the scalar-weight multiplies differently, so ULP-level slack)."""
    Ac = laplace2d(20, constant=True)
    Ag = laplace2d(20)
    b = rng.standard_normal(Ac.shape[0])
    xc, ic = krylov_tpu.solve(Ac, b, method="cg", tol=1e-9)
    xg, ig = krylov_tpu.solve(Ag, b, method="cg", tol=1e-9)
    assert ic["converged"] and ig["converged"]
    assert ic["iterations"] == ig["iterations"]
    m = min(len(ic["residual"]), len(ig["residual"]))
    np.testing.assert_allclose(
        ic["residual"][:m], ig["residual"][:m], rtol=1e-10
    )
    np.testing.assert_allclose(xc, xg, rtol=1e-9, atol=1e-12)
