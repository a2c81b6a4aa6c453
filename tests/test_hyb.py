"""Hybrid ELL+tail (HybMatrix) general-sparse path.

The reference consumes arbitrary ``scipy.sparse.csr_matrix`` systems
(reference: v3/cpu/cg.py:27); plain max-width ELLPACK blows up on skewed
row-nnz distributions (power-law graph matrices), which is what the split
HYB container exists for.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

import krylov_tpu
from krylov_tpu.sparse import convert
from krylov_tpu.sparse.fixtures import powerlaw_spd
from krylov_tpu.sparse.formats import EllMatrix, HybMatrix, as_operator


@pytest.fixture(scope="module")
def skewed():
    A = powerlaw_spd(5000, seed=11, max_deg=1200)
    rng = np.random.default_rng(3)
    x_true = rng.standard_normal(A.shape[0])
    return A, x_true, A @ x_true


def test_hyb_storage_beats_ell_4x(skewed):
    """Done-condition for HYB: a power-law matrix where plain ELL storage is
    >= 4x larger than the split."""
    A, _, _ = skewed
    row_nnz = np.diff(A.indptr)
    w, hyb_slots = convert.hyb_split_width(row_nnz)
    ell_slots = A.shape[0] * int(row_nnz.max())
    assert ell_slots >= 4 * hyb_slots
    H = convert.to_hyb(A)
    assert H.stored_entries * 4 <= ell_slots  # the ACTUAL build, not the estimate


def test_from_scipy_picks_hyb_on_skew(skewed):
    A, _, _ = skewed
    assert isinstance(convert.from_scipy(A), HybMatrix)


def test_from_scipy_keeps_ell_on_uniform():
    # uniform row widths: HYB cannot save 2x, plain ELL remains the choice
    rng = np.random.default_rng(0)
    n, d = 600, 7
    rows = np.repeat(np.arange(n), d)
    cols = rng.integers(0, n, size=rows.size)
    A = sp.coo_matrix((rng.uniform(1, 2, rows.size), (rows, cols)), shape=(n, n))
    A = (A + A.T).tocsr() + sp.eye(n) * 50.0
    assert isinstance(convert.from_scipy(A), EllMatrix)


def test_hyb_matvec_matches_scipy(skewed):
    A, x_true, _ = skewed
    H = convert.to_hyb(A)
    y = np.asarray(H.matvec(jnp.asarray(x_true)))
    np.testing.assert_allclose(y, A @ x_true, rtol=1e-12, atol=1e-12)


def test_hyb_todense_and_host_matvec(skewed):
    A, x_true, _ = skewed
    A_small = powerlaw_spd(300, seed=4)
    H = convert.to_hyb(A_small)
    np.testing.assert_allclose(H.todense(), A_small.toarray(), atol=1e-14)
    y = convert.host_matvec64(convert.to_hyb(A), x_true)
    np.testing.assert_allclose(y, A @ x_true, rtol=1e-12, atol=1e-12)


def test_hyb_solve(skewed):
    A, x_true, b = skewed
    x, info = krylov_tpu.solve(A, b, method="cg", tol=1e-10)
    assert info["converged"]
    np.testing.assert_allclose(x, x_true, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("method,k", [("cg", 0), ("kskipmrr", 3)])
def test_hyb_sharded_solve(skewed, method, k):
    from krylov_tpu.dist import make_mesh

    A, x_true, b = skewed
    H = convert.from_scipy(A)
    x, info = krylov_tpu.solve(
        H, b, method=method, k=k, tol=1e-10, mesh=make_mesh()
    )
    assert info["converged"]
    np.testing.assert_allclose(x, x_true, rtol=1e-6, atol=1e-7)


def test_hyb_sharded_padding_path():
    """N not divisible by the mesh: pad_to_multiple's HYB branch."""
    from krylov_tpu.dist import make_mesh

    n = 5003
    A = powerlaw_spd(n, seed=5)
    x_true = np.ones(n)
    b = A @ x_true
    x, info = krylov_tpu.solve(
        convert.from_scipy(A), b, method="cg", tol=1e-10, mesh=make_mesh()
    )
    assert info["converged"]
    assert x.shape == (n,)
    np.testing.assert_allclose(x, x_true, rtol=1e-6, atol=1e-7)


def test_hyb_pad_to_multiple_dense_equiv():
    A = powerlaw_spd(301, seed=6)
    H = convert.to_hyb(A)
    Hp, b_p, n0 = convert.pad_to_multiple(H, np.ones(301), 8)
    assert n0 == 301 and Hp.shape == (304, 304) and b_p.shape == (304,)
    dense = np.zeros((304, 304))
    dense[:301, :301] = A.toarray()
    dense[range(301, 304), range(301, 304)] = 1.0
    np.testing.assert_allclose(Hp.todense(), dense, atol=1e-14)


def test_hyb_io_roundtrip(tmp_path):
    """mtx -> native reader -> auto container (HYB on skew) -> solve."""
    import scipy.io as sio

    from krylov_tpu.sparse import io as kio

    n = 800
    A = powerlaw_spd(n, seed=7, max_deg=250)
    path = tmp_path / "pl.mtx"
    sio.mmwrite(str(path), A.tocoo())
    H = kio.load_mtx(str(path))
    assert isinstance(H, HybMatrix)
    x_true = np.ones(n)
    x, info = krylov_tpu.solve(H, A @ x_true, method="mrr", tol=1e-10)
    assert info["converged"]
    np.testing.assert_allclose(x, x_true, rtol=1e-6, atol=1e-7)


def test_as_operator_passthrough(skewed):
    A, _, _ = skewed
    H = convert.to_hyb(A)
    assert as_operator(H) is H


def test_hyb_extract_diagonal_and_gershgorin(skewed):
    """ADVICE r2 (medium): diagonal/rowsum extraction must cover HybMatrix —
    reachable from the public API via --precond jacobi|chebyshev on the
    powerlaw fixture, which auto-selects HYB."""
    from krylov_tpu import precond

    A, _, _ = skewed
    # width=1 forces even diagonal entries of long rows into the tail block,
    # exercising the scatter-add branch
    for H in (convert.to_hyb(A), convert.to_hyb(A, width=1)):
        d = precond.extract_diagonal(H)
        np.testing.assert_allclose(d, A.diagonal(), rtol=1e-12, atol=1e-14)
        lmin, lmax = precond.gershgorin_bounds(H)
        rowsum = np.abs(A).sum(axis=1).A1
        assert lmax == pytest.approx(float(rowsum.max()), rel=1e-12)


def test_hyb_pcg_jacobi_and_chebyshev(skewed):
    """End-to-end: preconditioned solves on the HYB container."""
    from krylov_tpu import precond

    A, x_true, b = skewed
    H = convert.from_scipy(A)
    assert isinstance(H, HybMatrix)
    for M in (precond.jacobi(H), precond.chebyshev(H, degree=3)):
        x, info = krylov_tpu.solve(H, b, method="pcg", M=M, tol=1e-10)
        assert info["converged"]
        np.testing.assert_allclose(x, x_true, rtol=1e-6, atol=1e-7)


def test_graded_spectrum_variant_is_hard_and_jacobi_fixes_it():
    """``diag_scale_decades`` turns the trivially-conditioned powerlaw SPD
    (kappa ~ 41, CG ~ 16 iterations at any size) into a genuinely graded
    spectrum: CG needs an order of magnitude more
    iterations, and Jacobi-PCG — which undoes the diagonal grading —
    recovers the easy count.  Run at n=2048 for speed; kappa of the n=4096
    instance of the same generator is 1.6e5 (scipy eigsh, both ends)."""
    import jax.numpy as jnp

    import krylov_tpu
    from krylov_tpu import precond
    from krylov_tpu.sparse.convert import to_hyb

    n = 2048
    A_easy = to_hyb(powerlaw_spd(n, shift=1e-3, seed=42))
    A_hard = to_hyb(
        powerlaw_spd(n, shift=1e-3, diag_scale_decades=1.5, seed=42)
    )
    b = np.random.default_rng(7).standard_normal(n)

    _, easy = krylov_tpu.solve(A_easy, b, method="cg", tol=1e-6, maxiter=8000)
    _, hard = krylov_tpu.solve(A_hard, b, method="cg", tol=1e-6, maxiter=8000)
    _, pcg = krylov_tpu.solve(
        A_hard, b, method="pcg", M=precond.jacobi(A_hard), tol=1e-6,
        maxiter=8000,
    )
    assert easy["converged"] and hard["converged"] and pcg["converged"]
    assert hard["iterations"] >= 8 * easy["iterations"]
    assert pcg["iterations"] <= hard["iterations"] // 4
