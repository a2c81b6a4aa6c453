"""Preconditioned / pipelined CG family (capability of the reference's
v1/threads/pipeline tree) + matvec-only preconditioners."""

import numpy as np
import pytest

import krylov_tpu
from krylov_tpu import precond
from krylov_tpu.sparse.fixtures import laplace2d, poisson1d

METHODS = ["pcg", "chronopoulos_gear", "gropp", "pipelined_cg"]


def _system(nx=12, seed=3):
    A = laplace2d(nx)
    rng = np.random.default_rng(seed)
    x_true = rng.standard_normal(A.shape[0])
    b = A.todense() @ x_true
    return A, b, x_true


@pytest.mark.parametrize("method", METHODS)
def test_unpreconditioned(method):
    A, b, x_true = _system()
    x, info = krylov_tpu.solve(A, b, method=method, tol=1e-10, maxiter=2000)
    assert info["converged"], info["residual"][-5:]
    np.testing.assert_allclose(x, x_true, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("method", METHODS)
def test_jacobi_preconditioned(method):
    A, b, x_true = _system()
    M = precond.jacobi(A)
    x, info = krylov_tpu.solve(A, b, method=method, M=M, tol=1e-10, maxiter=2000)
    assert info["converged"]
    np.testing.assert_allclose(x, x_true, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("method", ["pcg", "pipelined_cg"])
def test_chebyshev_preconditioner_cuts_iterations(method):
    A = laplace2d(24)
    b = np.ones(A.shape[0])
    _, info_plain = krylov_tpu.solve(A, b, method=method, tol=1e-9, maxiter=5000)
    M = precond.chebyshev(A, degree=6)
    _, info_prec = krylov_tpu.solve(
        A, b, method=method, M=M, tol=1e-9, maxiter=5000
    )
    assert info_plain["converged"] and info_prec["converged"]
    # A degree-6 polynomial preconditioner should cut outer iterations by
    # well over 2x on the Laplacian.
    assert info_prec["iterations"] * 2 < info_plain["iterations"]


def test_unpreconditioned_pcg_matches_cg():
    """With M=I, PCG is plain CG (same alpha/beta sequences)."""
    A = poisson1d(100)
    b = np.ones(100)
    _, i1 = krylov_tpu.solve(A, b, method="pcg", tol=1e-9, maxiter=500)
    _, i2 = krylov_tpu.solve(A, b, method="cg", tol=1e-9, maxiter=500)
    assert i1["converged"] and i2["converged"]
    assert abs(i1["iterations"] - i2["iterations"]) <= 1
    m = min(len(i1["residual"]), len(i2["residual"]))
    np.testing.assert_allclose(i1["residual"][:m], i2["residual"][:m], rtol=1e-7)


def test_lanczos_bounds_on_graded_spectrum():
    """A strongly graded diagonal breaks the gershgorin lmin = lmax/30
    heuristic by orders of magnitude; Lanczos recovers the true interval."""
    from krylov_tpu.sparse.formats import DiaMatrix
    import jax.numpy as jnp

    n = 512
    d = np.geomspace(1e-4, 1.0, n)  # condition number 1e4
    A = DiaMatrix(jnp.asarray(d)[None, :], (0,), (n, n))

    g_lo, g_hi = precond.gershgorin_bounds(A)
    l_lo, l_hi = precond.lanczos_bounds(A, m=48)
    # Heuristic lmin is ~333x too large on this spectrum ...
    assert g_lo > 100 * d[0]
    # ... Lanczos lands within ~4x of the true lmin (Ritz values converge
    # from inside — the small end of a log-uniform spectrum converges
    # slowest) and nails lmax.
    assert l_lo <= 4 * d[0] and l_hi >= d[-1] * 0.999
    assert l_lo > d[0] / 10 and l_hi < d[-1] * 10


def test_chebyshev_lanczos_bounds_beat_heuristic():
    """On a graded spectrum the gershgorin lmin=lmax/30
    heuristic is badly wrong; Lanczos-bounded Chebyshev must converge in
    <= 0.6x the outer iterations, and it is now the DEFAULT (bounds="auto")."""
    from krylov_tpu.sparse.formats import DiaMatrix
    import jax.numpy as jnp

    n = 256
    rng = np.random.default_rng(0)
    d = np.geomspace(1e-4, 1.0, n)
    A = DiaMatrix(jnp.asarray(d)[None, :], (0,), (n, n))
    b = rng.standard_normal(n)

    # The interval error bites hardest at high degree (a tight polynomial on
    # the WRONG interval leaves the sub-lmin modes nearly untouched).
    M_h = precond.chebyshev(A, degree=24, bounds="gershgorin")
    M_l = precond.chebyshev(A, degree=24)  # default = auto -> lanczos
    assert M_l.lmin < 0.1 * M_h.lmin  # the heuristic interval was badly off
    _, info_h = krylov_tpu.solve(A, b, method="pcg", M=M_h, tol=1e-9, maxiter=5000)
    _, info_l = krylov_tpu.solve(A, b, method="pcg", M=M_l, tol=1e-9, maxiter=5000)
    assert info_l["converged"]
    assert info_l["iterations"] <= 0.6 * info_h["iterations"]


def test_chebyshev_apply_approximates_inverse():
    A = laplace2d(10)
    n = A.shape[0]
    M = precond.chebyshev(A, degree=20, lmin=0.05, lmax=8.0)
    from krylov_tpu.context import DEFAULT_CONTEXT
    import jax.numpy as jnp

    v = np.ones(n)
    z = np.asarray(M.matvec(jnp.asarray(v), DEFAULT_CONTEXT))
    # z should be much closer to A^{-1} v than v itself is.
    x_exact = np.linalg.solve(A.todense(), v)
    assert np.linalg.norm(z - x_exact) < 0.5 * np.linalg.norm(v - x_exact)
