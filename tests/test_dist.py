"""Distributed (shard_map) solves on the 8-device CPU mesh.

The reference could only test its distributed engines on real clusters
(hardcoded topology maps, reference: v2/gpu/mpi/common.py:199-216); here the
SAME mesh-parameterized code path that runs on a multi-GPU host is validated on
8 virtual CPU devices.  Sharded results must match the single-device solves
to reduction-order tolerance.
"""

import numpy as np
import pytest

import jax

import krylov_tpu
from krylov_tpu.dist import make_mesh, shard_operator
from krylov_tpu.sparse.fixtures import laplace2d, poisson1d, random_spd_ell


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest should provide 8 CPU devices"
    return make_mesh(jax.devices()[:8])


def _compare(A, b, method, mesh, k=0, tol=1e-9, maxiter=2000):
    x1, i1 = krylov_tpu.solve(A, b, method=method, k=k, tol=tol, maxiter=maxiter)
    x8, i8 = krylov_tpu.solve(
        A, b, method=method, k=k, tol=tol, maxiter=maxiter, mesh=mesh
    )
    assert i1["converged"] and i8["converged"]
    # Reduction-order drift may shift convergence by at most one OUTER
    # iteration (k+1 solution updates for the k-skip family); anything more
    # would indicate a systematically different sharded path.
    assert abs(i1["iterations"] - i8["iterations"]) <= k + 1
    np.testing.assert_allclose(x8, x1, rtol=1e-6, atol=1e-9)
    m = min(len(i1["residual"]), len(i8["residual"]))
    np.testing.assert_allclose(i1["residual"][:m], i8["residual"][:m], rtol=1e-4)
    return i1, i8


@pytest.mark.parametrize("method", ["cg", "mrr"])
def test_sharded_matches_single_dia(method, mesh):
    A = laplace2d(16)  # N=256, divides 8 -> halo strategy
    b = np.ones(A.shape[0])
    _compare(A, b, method, mesh)


@pytest.mark.parametrize("method,k", [("kskipcg", 2), ("kskipmrr", 2)])
def test_sharded_kskip(method, k, mesh):
    A = laplace2d(16)
    b = np.random.default_rng(12).standard_normal(A.shape[0])
    _compare(A, b, method, mesh, k=k)


def test_sharded_adaptive(mesh):
    A = laplace2d(16)
    b = np.random.default_rng(12).standard_normal(A.shape[0])
    x1, i1 = krylov_tpu.solve(
        A, b, method="adaptivekskipmrr", k=2, tol=1e-9, maxiter=2000
    )
    x8, i8 = krylov_tpu.solve(
        A, b, method="adaptivekskipmrr", k=2, tol=1e-9, maxiter=2000, mesh=mesh
    )
    assert i1["converged"] and i8["converged"]
    np.testing.assert_allclose(x8, x1, rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(i1["khistory"], i8["khistory"])


def test_sharded_padding_path(mesh):
    """N=100 not divisible by 8 -> zero-padding with unit diagonal
    (reference analog: v2/cpu/mpi/common.py:28-51)."""
    A = poisson1d(100)
    b = np.ones(100)
    x1, i1 = krylov_tpu.solve(A, b, method="cg", tol=1e-9)
    x8, i8 = krylov_tpu.solve(A, b, method="cg", tol=1e-9, mesh=mesh)
    assert i8["converged"]
    assert x8.shape == (100,)
    np.testing.assert_allclose(x8, x1, rtol=1e-6, atol=1e-9)


def test_sharded_ell_allgather(mesh):
    """General sparse (ELL) uses the all-gather strategy."""
    A = random_spd_ell(128, row_nnz=8, seed=2)
    op, specs = shard_operator(A, 8)
    assert op.strategy == "allgather"
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(128)
    b = A.todense() @ x_true
    x8, i8 = krylov_tpu.solve(A, b, method="cg", tol=1e-10, maxiter=1000, mesh=mesh)
    assert i8["converged"]
    np.testing.assert_allclose(x8, x_true, rtol=1e-6, atol=1e-8)


def test_halo_strategy_selected(mesh):
    A = laplace2d(16)
    op, specs = shard_operator(A, 8)
    assert op.strategy == "halo"
    assert op.local_n == 32


@pytest.mark.parametrize("precond_name", ["jacobi", "chebyshev"])
def test_sharded_preconditioned(precond_name, mesh):
    """Preconditioners shard with the operator: Jacobi's diagonal scaling
    row-partitions; Chebyshev's inner operator runs the same halo SpMV."""
    from krylov_tpu import precond

    A = laplace2d(16)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    M = precond.jacobi(A) if precond_name == "jacobi" else precond.chebyshev(A, degree=4)
    x1, i1 = krylov_tpu.solve(A, b, method="pcg", M=M, tol=1e-9)
    x8, i8 = krylov_tpu.solve(A, b, method="pcg", M=M, tol=1e-9, mesh=mesh)
    assert i1["converged"] and i8["converged"]
    assert i1["iterations"] == i8["iterations"]
    np.testing.assert_allclose(x8, x1, rtol=1e-6, atol=1e-9)


def test_sharded_preconditioned_with_padding(mesh):
    """pcg + mesh at N=100 (not divisible by 8): the preconditioner is
    zero-padded with a unit diagonal alongside the operator."""
    from krylov_tpu import precond

    A = poisson1d(100)
    b = np.random.default_rng(3).standard_normal(100)
    for M in (precond.jacobi(A), precond.chebyshev(A, degree=3)):
        x1, i1 = krylov_tpu.solve(A, b, method="pcg", M=M, tol=1e-9, maxiter=500)
        x8, i8 = krylov_tpu.solve(
            A, b, method="pcg", M=M, tol=1e-9, maxiter=500, mesh=mesh
        )
        assert i1["converged"] and i8["converged"]
        assert x8.shape == (100,)
        np.testing.assert_allclose(x8, x1, rtol=1e-6, atol=1e-9)


def test_batched_sharded(mesh):
    """Batched multi-RHS + mesh: the batch vmaps inside the shard_map."""
    from krylov_tpu.api import solve_batched

    A = laplace2d(16)
    n = A.shape[0]
    rng = np.random.default_rng(7)
    B = rng.standard_normal((3, n))
    res = solve_batched(A, B, method="cg", tol=1e-9, maxiter=1000, mesh=mesh)
    assert res.x.shape == (3, n)
    assert np.all(np.asarray(res.converged))
    for i in range(3):
        x_i, info_i = krylov_tpu.solve(A, B[i], method="cg", tol=1e-9, maxiter=1000)
        assert int(res.iterations[i]) == info_i["iterations"]
        np.testing.assert_allclose(np.asarray(res.x[i]), x_i, rtol=1e-6, atol=1e-9)


def test_batched_sharded_with_padding(mesh):
    """Batched + mesh at N=100 (pads to 104) returns (batch, 100)."""
    from krylov_tpu.api import solve_batched

    A = poisson1d(100)
    rng = np.random.default_rng(8)
    B = rng.standard_normal((2, 100))
    res = solve_batched(A, B, method="cg", tol=1e-9, maxiter=500, mesh=mesh)
    assert res.x.shape == (2, 100)
    assert np.all(np.asarray(res.converged))
    for i in range(2):
        r = np.linalg.norm(B[i] - A.todense() @ np.asarray(res.x[i]))
        assert r / np.linalg.norm(B[i]) < 1e-8


def test_halo_matvec_matches_dense(mesh):
    """Sharded halo SpMV == dense matvec, standalone."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from krylov_tpu.context import Context

    A = laplace2d(16)
    n = A.shape[0]
    op, op_specs = shard_operator(A, 8)
    ctx = Context(axis="rows")
    rng = np.random.default_rng(1)
    x = rng.standard_normal(n)

    fn = jax.jit(
        jax.shard_map(
            lambda o, xl: o.matvec(xl, ctx),
            mesh=mesh,
            in_specs=(op_specs, P("rows")),
            out_specs=P("rows"),
        )
    )
    y = np.asarray(fn(op, jnp.asarray(x)))
    np.testing.assert_allclose(y, A.todense() @ x, rtol=1e-12)


def test_sharded_compile_time_split(mesh):
    """Sharded info["time"] must be execution-only, with the
    first call reporting its compile separately (reference times only the
    loop, reference: v3/cpu/common.py:9-18).  Unique shape so the AOT cache
    cannot already hold this program."""
    A = laplace2d(8, 26)  # N=208: not used by any other test
    b = np.ones(A.shape[0])
    _, i1 = krylov_tpu.solve(A, b, method="cg", tol=1e-8, mesh=mesh)
    assert "compile_time" in i1 and i1["compile_time"] > 0
    assert i1["time"] < i1["compile_time"]  # execution ≪ compile on N=208
    _, i2 = krylov_tpu.solve(A, b, method="cg", tol=1e-8, mesh=mesh)
    assert "compile_time" not in i2  # cache hit -> execution-only timing
