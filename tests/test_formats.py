"""Container correctness: conversions and matvecs vs scipy dense ground truth."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from krylov_tpu.sparse import DenseMatrix, DiaMatrix, EllMatrix, as_operator, convert
from krylov_tpu.sparse.fixtures import laplace2d, laplace3d, poisson1d, random_spd_ell


def _random_csr(n, density, rng, sym=True):
    m = sp.random(n, n, density=density, random_state=np.random.RandomState(7))
    if sym:
        m = m + m.T
    m = m.tocsr()
    m.setdiag(np.abs(m).sum(axis=1).A1 + 1.0)
    return m.tocsr()


def test_poisson1d_matches_scipy():
    n = 50
    A = poisson1d(n)
    ref = sp.diags([-1, 2, -1], [-1, 0, 1], shape=(n, n)).toarray()
    np.testing.assert_allclose(A.todense(), ref)


def test_laplace2d_matches_kron():
    nx = 7
    T = sp.diags([-1, 2, -1], [-1, 0, 1], shape=(nx, nx))
    I = sp.eye(nx)
    ref = (sp.kron(I, T) + sp.kron(T, I)).toarray()
    A = laplace2d(nx)
    np.testing.assert_allclose(A.todense(), ref)


def test_laplace3d_spd_rowsums():
    A = laplace3d(4)
    dense = A.todense()
    np.testing.assert_allclose(dense, dense.T)
    w = np.linalg.eigvalsh(dense)
    assert w.min() > 0


@pytest.mark.parametrize("fixture", ["poisson", "laplace"])
def test_dia_matvec(fixture):
    A = poisson1d(40) if fixture == "poisson" else laplace2d(8)
    n = A.shape[0]
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n)
    y = np.asarray(A.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y, A.todense() @ x, rtol=1e-12)


def test_to_dia_roundtrip(rng):
    csr = _random_csr(30, 0.1, rng)
    # force dia regardless of heuristic
    A = convert.to_dia(csr)
    np.testing.assert_allclose(A.todense(), csr.toarray(), rtol=1e-12)
    x = rng.standard_normal(30)
    np.testing.assert_allclose(
        np.asarray(A.matvec(jnp.asarray(x))), csr @ x, rtol=1e-12
    )


def test_to_ell_roundtrip(rng):
    csr = _random_csr(35, 0.15, rng)
    A = convert.to_ell(csr)
    np.testing.assert_allclose(A.todense(), csr.toarray(), rtol=1e-12)
    x = rng.standard_normal(35)
    np.testing.assert_allclose(
        np.asarray(A.matvec(jnp.asarray(x))), csr @ x, rtol=1e-12
    )


def test_as_operator_dispatch(rng):
    csr = _random_csr(20, 0.1, rng)
    op = as_operator(csr)
    assert isinstance(op, (DiaMatrix, EllMatrix))
    dense_op = as_operator(csr.toarray())
    assert isinstance(dense_op, DenseMatrix)
    x = rng.standard_normal(20)
    np.testing.assert_allclose(
        np.asarray(op.matvec(jnp.asarray(x))), csr @ x, rtol=1e-12
    )


def test_banded_goes_dia():
    A = as_operator(sp.diags([-1, 2, -1], [-1, 0, 1], shape=(64, 64)).tocsr())
    assert isinstance(A, DiaMatrix)


def test_random_spd_ell_is_spd():
    A = random_spd_ell(40, row_nnz=6)
    dense = A.todense()
    np.testing.assert_allclose(dense, dense.T, atol=1e-12)
    assert np.linalg.eigvalsh(dense).min() > 0


@pytest.mark.parametrize("kind", ["dia", "ell", "dense"])
def test_pad_to_multiple(kind, rng):
    n, mult = 29, 8
    csr = _random_csr(n, 0.1, rng)
    if kind == "dia":
        A = convert.to_dia(csr)
    elif kind == "ell":
        A = convert.to_ell(csr)
    else:
        A = convert.to_dense(csr)
    b = rng.standard_normal(n)
    A_p, b_p, n_orig = convert.pad_to_multiple(A, b, mult)
    assert n_orig == n
    assert A_p.shape[0] % mult == 0
    dense_p = A_p.todense()
    np.testing.assert_allclose(dense_p[:n, :n], csr.toarray(), rtol=1e-12)
    # padding rows: unit diagonal, decoupled
    np.testing.assert_allclose(dense_p[n:, :n], 0.0)
    np.testing.assert_allclose(dense_p[:n, n:], 0.0)
    np.testing.assert_allclose(dense_p[n:, n:], np.eye(A_p.shape[0] - n))
    np.testing.assert_allclose(b_p[n:], 0.0)


def test_gather_rows_matches_element_gather(rng):
    """gather_rows must be exact vs ``x[idx]``, including at odd table sizes
    and duplicate/boundary indices."""
    from krylov_tpu.sparse import formats

    x_np = rng.standard_normal(1003).astype(np.float32)
    idx = np.concatenate(
        [
            rng.integers(0, 1003, size=(64, 7)),
            np.array([[0] * 7, [1002] * 7]),  # boundary + duplicates
        ]
    ).astype(np.int32)
    got = formats.gather_rows(jnp.asarray(x_np), jnp.asarray(idx))
    np.testing.assert_array_equal(np.asarray(got), x_np[idx])


def test_gather_rows_nonfinite_neighbors_do_not_poison(rng):
    """A NaN/inf in x must only affect gathers that actually index it — not
    gathers of neighbouring elements."""
    from krylov_tpu.sparse import formats

    x_np = rng.standard_normal(256).astype(np.float32)
    x_np[5] = np.inf
    x_np[130] = np.nan
    x = jnp.asarray(x_np)
    # indices adjacent to the poisoned entries, but never equal to them
    idx = jnp.asarray(np.array([[4, 6, 12], [128, 131, 140]], dtype=np.int32))
    out = np.asarray(formats.gather_rows(x, idx))
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out, x_np[np.asarray(idx)])


def test_hyb_matvec_matches_scipy(rng):
    """Full HYB matvec (ELL gather + split tail scatter-add) vs scipy."""
    from krylov_tpu.sparse.convert import to_hyb
    from krylov_tpu.sparse.fixtures import powerlaw_spd

    A_sp = powerlaw_spd(512, seed=3)
    H = to_hyb(A_sp, dtype=np.float64)
    assert H.tail_data.shape[0] > 0, "fixture must exercise the tail block"
    x = rng.standard_normal(512)
    y = np.asarray(H.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y, A_sp @ x, rtol=1e-12, atol=1e-12)


def test_fixtures_and_host_paths_do_zero_device_transfers():
    """Containers are host-lazy (no device round-trip or device memory in
    nominally host-side code).  Building
    fixtures, converting from scipy, to_dia/todense/grid_coef, padding, and
    the host-f64 matvec must all run without touching any device."""
    import jax

    from krylov_tpu.sparse.convert import (
        from_scipy,
        host_matvec64,
        pad_to_multiple,
        to_hyb,
    )
    from krylov_tpu.sparse.fixtures import (
        laplace2d,
        laplace3d,
        poisson1d,
        powerlaw_spd,
        rhs_for_solution,
    )

    with jax.transfer_guard("disallow"):
        A = laplace2d(50, dtype=np.float64)
        Ac = laplace2d(50, dtype=np.float64, constant=True)
        D = A.to_dia()
        Dc = Ac.to_dia()
        np.testing.assert_allclose(
            np.asarray(D.data), np.asarray(Dc.data), rtol=0, atol=0
        )
        A3 = laplace3d(8, dtype=np.float64, constant=True)
        A3.grid_coef()
        P = poisson1d(33, dtype=np.float64)
        P.todense()
        pad_to_multiple(P, np.ones(33), 8)
        S = powerlaw_spd(256, seed=1)
        H = to_hyb(S, dtype=np.float64)
        E = from_scipy(S.tocsr())
        x = np.linspace(0.0, 1.0, 256)
        np.testing.assert_allclose(host_matvec64(H, x), S @ x, atol=1e-12)
        rhs_for_solution(P, np.ones(33))


def test_gather_rows_vmap_matches_per_lane(rng):
    """The custom vmap rule (batch -> trailing-axis row gather; the
    multi-RHS amortization) must agree with per-lane gathers, with
    non-finite entries present (the inf/NaN-safety property)."""
    import jax
    from krylov_tpu.sparse import formats

    n, w, batch = 257, 6, 5
    X = rng.standard_normal((batch, n)).astype(np.float32)
    X[0, 3] = np.inf
    X[1, 7] = np.nan
    idx = rng.integers(0, n, size=(64, w)).astype(np.int32)

    expect = np.stack([np.asarray(X[b])[idx] for b in range(batch)])
    got = np.asarray(
        jax.vmap(lambda x: formats.gather_rows(x, jnp.asarray(idx)))(
            jnp.asarray(X)
        )
    )
    np.testing.assert_array_equal(got, expect)
    got1 = np.asarray(formats.gather_rows(jnp.asarray(X[2]), jnp.asarray(idx)))
    np.testing.assert_array_equal(got1, expect[2])


def test_scatter_add_rows_vmap_matches_per_lane(rng):
    """The batched HYB tail scatter routes through a trailing-axis
    slice scatter (same amortization as the gathers); must equal per-lane
    scatter-adds, duplicates accumulating."""
    import jax
    from krylov_tpu.sparse.formats import _scatter_add_rows

    n, t, batch = 97, 23, 5
    Y = rng.standard_normal((batch, n)).astype(np.float32)
    E = rng.standard_normal((batch, t)).astype(np.float32)
    rows = rng.integers(0, n, size=t).astype(np.int32)
    rows[3] = rows[7]  # duplicate target: contributions must accumulate

    expect = Y.copy()
    for b in range(batch):
        np.add.at(expect[b], rows, E[b])
    got = np.asarray(
        jax.vmap(
            lambda y, e: _scatter_add_rows(y, jnp.asarray(rows), e)
        )(jnp.asarray(Y), jnp.asarray(E))
    )
    np.testing.assert_allclose(got, expect, rtol=1e-6)


def test_to_device_commit_is_cached(rng):
    """Repeated to_device on the SAME host-lazy container returns the SAME
    committed operator (identity-keyed weak cache) — without it, every
    solve() call re-uploads the matrix."""
    import gc
    from krylov_tpu.sparse import formats
    from krylov_tpu.sparse.fixtures import laplace2d

    A = laplace2d(8, dtype=np.float32)
    c1 = formats.to_device(A)
    c2 = formats.to_device(A)
    assert c1 is c2
    # committed form passes through unchanged
    assert formats.to_device(c1) is c1
    # cache is weak: dropping the host container evicts the entry
    key = id(A)
    del A
    gc.collect()
    assert key not in formats._COMMIT_CACHE


def test_to_device_never_caches_a_commit_made_under_jit():
    """A host-lazy container first committed inside a jit trace must not
    leave tracers in the commit cache: a jitted solve_device followed by a
    host solve on the SAME container both succeed, with the same answer."""
    import jax

    import krylov_tpu
    from krylov_tpu.sparse import formats

    A = laplace2d(12, dtype=np.float64)
    b = np.random.default_rng(5).standard_normal(A.shape[0])
    res = jax.jit(
        lambda bb: krylov_tpu.solve_device(A, bb, method="cg", tol=1e-8)
    )(jnp.asarray(b))
    for _, committed in formats._COMMIT_CACHE.values():
        for leaf in jax.tree.leaves(committed):
            assert not isinstance(leaf, jax.core.Tracer)
    x, info = krylov_tpu.solve(A, b, method="cg", tol=1e-8)
    assert info["converged"] and bool(res.converged)
    assert info["iterations"] == int(res.iterations)
    np.testing.assert_allclose(x, np.asarray(res.x), rtol=1e-10, atol=1e-12)
