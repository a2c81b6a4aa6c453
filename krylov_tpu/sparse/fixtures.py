"""Analytic SPD test problems (the benchmark configs from BASELINE.md).

The reference validated solvers on externally supplied ``.mtx``/``.npy``
matrices that were never committed (reference: .gitignore:1-19); these
constructors provide the standard SPD families the baselines are defined on.

All constructors return HOST containers (numpy leaves): building a fixture
never touches an accelerator, so host-side consumers (``to_dia``,
``todense``, benchmark check matrices, diagnostics) run with zero device
transfers and no device memory.  The solve paths commit leaves to the
device once per call (:func:`krylov_tpu.sparse.formats.to_device`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from krylov_tpu.sparse.formats import DiaMatrix, EllMatrix, StencilMatrix


def poisson1d(n: int, dtype=np.float64) -> DiaMatrix:
    """1-D Poisson tridiagonal SPD matrix: diag 2, off-diags -1 (BASELINE config 1)."""
    main = np.full(n, 2.0, dtype=dtype)
    lower = np.zeros(n, dtype=dtype)
    upper = np.zeros(n, dtype=dtype)
    lower[1:] = -1.0  # A[i, i-1]
    upper[: n - 1] = -1.0  # A[i, i+1]
    data = np.stack([lower, main, upper])
    return DiaMatrix(data, (-1, 0, 1), (n, n))


def laplace2d(
    nx: int,
    ny: int | None = None,
    dtype=np.float64,
    constant: bool = False,
) -> StencilMatrix:
    """2-D 5-point Laplacian on an ny*nx grid, row-major (BASELINE configs 2-3).

    Returned as a grid-aware :class:`StencilMatrix` (the structured-grid
    container); interior stencil [4, -1, -1, -1, -1] with Dirichlet
    boundaries (couplings across the grid edge stored as zero).

    ``constant=True`` returns the constant-coefficient form — per-term
    scalar weights instead of stored grids (same operator; see
    :class:`StencilMatrix`) — which skips streaming 5 coefficient grids
    from device memory per matvec.
    """
    ny = ny if ny is not None else nx
    stencil = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))
    if constant:
        w = np.array([-1.0, -1.0, 4.0, -1.0, -1.0], dtype=dtype)
        return StencilMatrix(w, stencil, (ny, nx))
    iy = np.arange(ny)[:, None]
    ix = np.arange(nx)[None, :]
    main = np.full((ny, nx), 4.0, dtype=dtype)
    north = np.broadcast_to((iy > 0), (ny, nx)).astype(dtype) * -1.0  # (i-1, j)
    south = np.broadcast_to((iy < ny - 1), (ny, nx)).astype(dtype) * -1.0
    west = np.broadcast_to((ix > 0), (ny, nx)).astype(dtype) * -1.0  # (i, j-1)
    east = np.broadcast_to((ix < nx - 1), (ny, nx)).astype(dtype) * -1.0
    coef = np.stack([north, west, main, east, south]).astype(dtype)
    return StencilMatrix(coef, stencil, (ny, nx))


def laplace3d(
    nx: int,
    ny: int | None = None,
    nz: int | None = None,
    dtype=np.float64,
    constant: bool = False,
) -> StencilMatrix:
    """3-D 7-point Laplacian on an nz*ny*nx grid (for the >=10M-row configs)."""
    ny = ny if ny is not None else nx
    nz = nz if nz is not None else nx
    if constant:
        w = np.array([-1.0, -1.0, -1.0, 6.0, -1.0, -1.0, -1.0], dtype=dtype)
        stencil = (
            (-1, 0, 0),
            (0, -1, 0),
            (0, 0, -1),
            (0, 0, 0),
            (0, 0, 1),
            (0, 1, 0),
            (1, 0, 0),
        )
        return StencilMatrix(w, stencil, (nz, ny, nx))
    iz = np.arange(nz)[:, None, None]
    iy = np.arange(ny)[None, :, None]
    ix = np.arange(nx)[None, None, :]
    shp = (nz, ny, nx)
    main = np.full(shp, 6.0, dtype=dtype)
    zm = np.broadcast_to(iz > 0, shp).astype(dtype) * -1.0
    zp = np.broadcast_to(iz < nz - 1, shp).astype(dtype) * -1.0
    ym = np.broadcast_to(iy > 0, shp).astype(dtype) * -1.0
    yp = np.broadcast_to(iy < ny - 1, shp).astype(dtype) * -1.0
    xm = np.broadcast_to(ix > 0, shp).astype(dtype) * -1.0
    xp = np.broadcast_to(ix < nx - 1, shp).astype(dtype) * -1.0
    coef = np.stack([zm, ym, xm, main, xp, yp, zp]).astype(dtype)
    stencil = (
        (-1, 0, 0),
        (0, -1, 0),
        (0, 0, -1),
        (0, 0, 0),
        (0, 0, 1),
        (0, 1, 0),
        (1, 0, 0),
    )
    return StencilMatrix(coef, stencil, shp)


def random_spd_ell(
    n: int, row_nnz: int = 8, seed: int = 0, dtype=np.float64
) -> EllMatrix:
    """Random diagonally-dominant SPD matrix in ELL format (general-sparse path).

    Built as S + S^T + shift*I from a random sparse S, so it is symmetric and
    strictly diagonally dominant (hence SPD).
    """
    rng = np.random.default_rng(seed)
    half = max(1, row_nnz // 2)
    rows = np.repeat(np.arange(n), half)
    cols = rng.integers(0, n, size=rows.size)
    vals = rng.uniform(-1.0, 1.0, size=rows.size).astype(dtype)
    import scipy.sparse as sp

    S = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    A = S + S.T
    A = A.tolil()
    A.setdiag(np.abs(A).sum(axis=1).A1 + 1.0)
    A = A.tocsr()
    from krylov_tpu.sparse.convert import to_ell

    return to_ell(A, dtype=dtype)


def powerlaw_spd(
    n: int,
    avg_deg: int = 8,
    alpha: float = 2.1,
    max_deg: int | None = None,
    shift: float = 0.05,
    diag_scale_decades: float = 0.0,
    seed: int = 0,
    dtype=np.float64,
):
    """Power-law-degree sparse SPD matrix (SuiteSparse-graph-like), as scipy CSR.

    The reference consumes arbitrary ``scipy.sparse.csr_matrix`` systems
    (reference: v3/cpu/cg.py:27); committed SuiteSparse matrices were
    gitignored (reference: .gitignore:1-19).  This constructor produces the
    same *shape* of problem: a scale-free graph whose row-nnz distribution is
    Zipf-like with a heavy tail (a few hub rows thousands wide), which is the
    adversarial case for max-width ELL padding and the reason
    :class:`~krylov_tpu.sparse.formats.HybMatrix` exists.

    The operator is ``A = (1 + shift) I - D^{-1/2} W D^{-1/2}`` — a shifted
    symmetric-normalized graph Laplacian.  Its spectrum lies in
    ``[shift, 2 + shift]`` independent of the degree skew, so conditioning is
    controlled by ``shift`` alone (kappa <= (2+shift)/shift ~ 41 at the
    default) and float32 solves converge reliably at any size.
    """
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    # Zipf-ish degrees: Pareto tail, floor 2, cap max_deg (default n//64).
    max_deg = max_deg if max_deg is not None else max(n // 64, 16)
    deg = 2 + (avg_deg - 2) * rng.pareto(alpha, size=n)
    deg = np.minimum(deg.astype(np.int64), max_deg)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = rng.integers(0, n, size=rows.size, dtype=np.int64)
    off = rows != cols  # drop accidental self-loops
    w = rng.uniform(0.5, 1.5, size=rows.size)
    S = sp.coo_matrix(
        (w[off], (rows[off], cols[off])), shape=(n, n)
    ).tocsr()
    W = S + S.T
    d = np.asarray(W.sum(axis=1)).ravel()
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(d, 1e-30))
    Dh = sp.diags(d_inv_sqrt)
    W_norm = Dh @ W @ Dh
    A = sp.eye(n, format="csr") * (1.0 + shift) - W_norm
    if diag_scale_decades:
        # Symmetric log-uniform diagonal scaling S A S fills the spectrum
        # across ~2*diag_scale_decades decades (the shifted normalized
        # Laplacian alone has ONE outlier eigenvalue near ``shift`` with the
        # semicircle bulk well inside [0.3, 1.7] — CG shrugs that off in ~16
        # iterations at any size).  Graded diagonals are the structure that
        # makes real SuiteSparse SPD problems (thermal*, G3_circuit class)
        # take hundreds-to-thousands of CG iterations; symmetric scaling
        # preserves SPD exactly.
        s = 10.0 ** rng.uniform(0.0, diag_scale_decades, size=n)
        S = sp.diags(s)
        A = S @ A @ S
    return A.tocsr().astype(dtype)


def rhs_for_solution(A, x_true: np.ndarray) -> np.ndarray:
    """b = A @ x_true computed on host in float64 for a known-solution test."""
    if hasattr(A, "matvec"):
        from krylov_tpu.sparse.convert import host_matvec64

        return host_matvec64(A, x_true).astype(np.asarray(x_true).dtype)
    return np.asarray(A @ x_true)


def ones_rhs(n: int, dtype=np.float64) -> np.ndarray:
    return np.ones(n, dtype=dtype)
