"""k-skip CG / k-skip MrR correctness."""

import numpy as np
import pytest

import krylov_tpu
from krylov_tpu.sparse.fixtures import laplace2d, poisson1d


@pytest.mark.parametrize("method", ["kskipcg", "kskipmrr"])
@pytest.mark.parametrize("k", [0, 1, 2, 4])
def test_kskip_converges(method, k):
    A = laplace2d(12)
    n = A.shape[0]
    rng = np.random.default_rng(4)
    x_true = rng.standard_normal(n)
    b = A.todense() @ x_true
    x, info = krylov_tpu.solve(A, b, method=method, k=k, tol=1e-10, maxiter=2000)
    assert info["converged"], f"{method} k={k} diverged: {info['residual'][-5:]}"
    np.testing.assert_allclose(x, x_true, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("method", ["kskipcg", "kskipmrr"])
def test_kskip_nosl_stride(method):
    """Solution-update counts advance by k+1 per outer iteration
    (reference: v3/cpu/kskipcg.py:66-68).

    k=2 and random rhs: with b=ones this fixture excites few eigenmodes and
    converges exactly mid-block, hitting the k-skip 0/0 breakdown — the
    reference NaNs there too (verified); random rhs avoids the degenerate
    regime.  k-skip MrR at k>=3 diverges on this fixture in the reference as
    well; that instability is why the adaptive variant exists.
    """
    k = 2
    A = poisson1d(80)
    b = np.random.default_rng(12).standard_normal(80)
    x, info = krylov_tpu.solve(A, b, method=method, k=k, tol=1e-9, maxiter=1000)
    assert info["converged"]
    nosl = info["nosl"]
    start = 1 if method == "kskipmrr" else 0  # MrR init step
    diffs = np.diff(nosl[start + 1 :])
    assert np.all(diffs == k + 1), diffs


def test_kskip_k0_matches_cg_iterations():
    """k=0 k-skip CG is plain CG, one outer iteration per update."""
    A = laplace2d(10)
    b = np.ones(A.shape[0])
    _, info0 = krylov_tpu.solve(A, b, method="kskipcg", k=0, tol=1e-8, maxiter=1000)
    _, info_cg = krylov_tpu.solve(A, b, method="cg", tol=1e-8, maxiter=1000)
    assert info0["converged"] and info_cg["converged"]
    assert abs(info0["iterations"] - info_cg["iterations"]) <= 1
    m = min(len(info0["residual"]), len(info_cg["residual"]))
    # atol floor: the final converged entries sit at machine epsilon
    # (~1e-16) where only absolute comparison is meaningful.
    np.testing.assert_allclose(
        info0["residual"][:m], info_cg["residual"][:m], rtol=1e-6, atol=1e-12
    )


@pytest.mark.parametrize("k", [1, 3])
def test_kskip_fewer_outer_iterations(k):
    """k-skip reduces reduction points ~(k+1)x for similar update counts."""
    A = laplace2d(12)
    b = np.ones(A.shape[0])
    _, info = krylov_tpu.solve(A, b, method="kskipcg", k=k, tol=1e-8, maxiter=2000)
    assert info["converged"]
    outer = len(info["residual"]) - 1
    updates = info["iterations"]
    assert outer <= -(-updates // (k + 1)) + 1


def test_scalar_dtype_f64_stabilizes_f32_kskip():
    """Mixed precision (f32 vectors + f64 Gram/scalar recurrences) rescues
    the k-skip recurrence where raw float32 diverges to NaN.

    The monomial-basis Gram has condition ~kappa^k, so its entries need
    more than vector precision; ``scalar_dtype=f64`` upcasts the Gram
    operands (context.py::_wide) and runs the recurrences in f64.  This is
    the reference's all-float64 policy (reference: v3/cpu/common.py:23)
    where it matters, at float32 vector bandwidth.
    laplace2d(64) (kappa ~ 1.7e3), k=5: raw f32 NaNs; mixed converges.
    (k=6 sits on the stability cliff — convergence there flips with XLA CPU
    reduction order; k=5 is robustly on the stable side for the mixed path.)
    """
    import jax.numpy as jnp

    A = laplace2d(64, dtype=np.float32)
    b = np.random.default_rng(0).standard_normal(A.shape[0]).astype(np.float32)

    _, raw = krylov_tpu.solve(
        A, b, method="kskipmrr", k=5, tol=1e-4, maxiter=1200
    )
    assert not raw["converged"]
    assert np.isnan(raw["residual"][-1])

    x, mixed = krylov_tpu.solve(
        A, b, method="kskipmrr", k=5, tol=1e-4, maxiter=1200,
        scalar_dtype=jnp.float64,
    )
    assert mixed["converged"]
    true_res = np.linalg.norm(
        np.asarray(A.matvec(x)) - b
    ) / np.linalg.norm(b)
    assert true_res < 5e-4


def test_scalar_dtype_f64_matches_full_f64_iterations():
    """At k=4 the mixed-precision iteration count equals full f64's exactly
    (the Gram — not the basis vectors — was the precision bottleneck)."""
    import jax.numpy as jnp

    b64 = np.random.default_rng(0).standard_normal(128 * 128)
    A64 = laplace2d(128, dtype=np.float64)
    _, full = krylov_tpu.solve(A64, b64, method="kskipmrr", k=4, tol=1e-4,
                               maxiter=1500)
    A32 = laplace2d(128, dtype=np.float32)
    _, mixed = krylov_tpu.solve(
        A32, b64.astype(np.float32), method="kskipmrr", k=4, tol=1e-4,
        maxiter=1500, scalar_dtype=jnp.float64,
    )
    assert full["converged"] and mixed["converged"]
    assert mixed["iterations"] == full["iterations"]
