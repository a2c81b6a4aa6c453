"""Conversions from host formats (scipy CSR/COO, dense) into library containers.

The reference delegates format handling to scipy/CuPy CSR (reference:
v2/gpu/common.py:95-105 uploads ``csr_matrix`` per device); here the
conversion step is explicit preprocessing: analyze the sparsity pattern once
on host, emit a static-shape container.  A C++ fast path for very large
matrices lives in ``native/`` (used automatically when built); this module is
the always-available pure-python/numpy path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from krylov_tpu.sparse.formats import (
    DenseMatrix,
    DiaMatrix,
    EllMatrix,
    HybMatrix,
    Operator,
)


def _csr_parts(A):
    csr = A.tocsr()
    csr.sum_duplicates()
    return csr


def analyze(A) -> dict:
    """Host-side pattern analysis used to pick a container format."""
    csr = _csr_parts(A)
    n, m = csr.shape
    coo = csr.tocoo()
    offs = np.unique(coo.col.astype(np.int64) - coo.row.astype(np.int64))
    row_nnz = np.diff(csr.indptr)
    return {
        "shape": (n, m),
        "nnz": int(csr.nnz),
        "num_offsets": int(offs.size),
        "offsets": offs,
        "max_row_nnz": int(row_nnz.max(initial=0)),
        "mean_row_nnz": float(row_nnz.mean()) if n else 0.0,
    }


def from_scipy(A, dtype=None, max_dia_offsets: int = 32) -> Operator:
    """Pick the best container for a scipy sparse matrix.

    Banded patterns (few distinct diagonals — the 1-D Poisson and 2-D
    Laplacian benchmark families) go to :class:`DiaMatrix`.  General
    patterns go to :class:`EllMatrix`, unless the row-nnz distribution is
    skewed enough that max-width padding blows up storage (power-law degree
    graphs), in which case the split :class:`HybMatrix` is used (the
    ELL+tail storage choice is made by :func:`hyb_split_width`).
    """
    info = analyze(A)
    n, m = info["shape"]
    # DIA is only worthwhile when the diagonals are dense enough that the
    # shifted-multiply work (num_offsets * N) stays close to nnz.
    if info["num_offsets"] <= max_dia_offsets and info["num_offsets"] * n <= 8 * max(
        info["nnz"], 1
    ):
        return to_dia(A, dtype=dtype)
    csr = _csr_parts(A)
    row_nnz = np.diff(csr.indptr)
    w, hyb_slots = hyb_split_width(row_nnz)
    ell_slots = n * max(int(row_nnz.max(initial=1)), 1)
    if hyb_slots * 2 <= ell_slots:
        return to_hyb(csr, dtype=dtype, width=w)
    return to_ell(csr, dtype=dtype)


def hyb_split_width(
    row_nnz: np.ndarray, tail_width: int = 32
) -> Tuple[int, int]:
    """Choose the ELL width ``w`` of an ELL+tail split minimizing storage.

    The tail stores each long row's overflow as ceil(overflow/tail_width)
    fixed-width chunks (long rows SPLIT across chunks — one hub row cannot
    force wide padding on the whole tail; the matvec's scatter-add merges a
    row's chunks).  Storage(w) = n*w + sum_i ceil(max(nnz_i - w, 0) /
    tail_width) * tail_width, evaluated at every distinct row width (the only
    places the minimum can move).  Returns (w, storage_slots).
    """
    n = row_nnz.shape[0]
    sorted_nnz = np.sort(row_nnz).astype(np.int64)
    suffix = np.concatenate([np.cumsum(sorted_nnz[::-1])[::-1], [0]])
    cands = np.unique(np.concatenate([[1], np.unique(sorted_nnz)]))
    cands = cands[cands >= 1].astype(np.int64)
    lo = np.searchsorted(sorted_nnz, cands, side="right")
    t = n - lo  # rows with nnz > w
    overflow = suffix[lo] - t * cands  # total entries past w
    # padding: each long row's last chunk is part-filled (~tail_width/2 avg);
    # exact enough for width selection, exact storage measured after build.
    cost = n * cands + overflow + t * (tail_width // 2)
    best = int(np.argmin(cost))
    return int(cands[best]), int(cost[best])


def to_dia(A, dtype=None) -> DiaMatrix:
    """Convert to row-indexed diagonal storage: data[d, i] = A[i, i+off_d]."""
    csr = _csr_parts(A)
    n, m = csr.shape
    coo = csr.tocoo()
    rows = coo.row.astype(np.int64)
    cols = coo.col.astype(np.int64)
    vals = coo.data
    offs = np.unique(cols - rows)
    dtype = dtype or vals.dtype
    data = np.zeros((len(offs), n), dtype=dtype)
    off_index = {int(o): d for d, o in enumerate(offs)}
    d_idx = np.array([off_index[int(o)] for o in (cols - rows)], dtype=np.int64)
    data[d_idx, rows] = vals
    return DiaMatrix(
        data=data, offsets=tuple(int(o) for o in offs), shape=(n, m)
    )


def _ell_arrays(csr, w: int, dtype):
    """Vectorized (data, indices) ELL build for the first ``w`` entries of
    every row; also returns the flat (entry -> row, slot) maps used by the
    tail build."""
    n = csr.shape[0]
    row_nnz = np.diff(csr.indptr)
    entry_row = np.repeat(np.arange(n, dtype=np.int64), row_nnz)
    slot = np.arange(csr.nnz, dtype=np.int64) - np.repeat(
        csr.indptr[:-1].astype(np.int64), row_nnz
    )
    data = np.zeros((n, w), dtype=dtype)
    indices = np.zeros((n, w), dtype=np.int32)
    keep = slot < w
    data[entry_row[keep], slot[keep]] = csr.data[keep]
    indices[entry_row[keep], slot[keep]] = csr.indices[keep]
    return data, indices, entry_row, slot


def to_ell(A, dtype=None, width: Optional[int] = None) -> EllMatrix:
    """Convert to ELLPACK with rows padded to the max (or given) width."""
    csr = _csr_parts(A)
    n, m = csr.shape
    row_nnz = np.diff(csr.indptr)
    w = int(width if width is not None else row_nnz.max(initial=1))
    w = max(w, 1)
    dtype = dtype or csr.data.dtype
    data, indices, _, _ = _ell_arrays(csr, w, dtype)
    return EllMatrix(data=data, indices=indices, shape=(n, m))


def to_hyb(
    A,
    dtype=None,
    width: Optional[int] = None,
    tail_width: int = 32,
    tail_multiple: int = 8,
) -> HybMatrix:
    """Convert to hybrid ELL + tail storage (:class:`HybMatrix`).

    ``width`` is the ELL split point (chosen by :func:`hyb_split_width` when
    omitted).  A row with more than ``width`` entries spills its overflow
    into ceil(overflow / tail_width) chunks of the fixed-width tail block —
    long rows are SPLIT across chunks, all carrying the same target row id,
    merged by the matvec's scatter-add.  The tail slot count is padded to a
    multiple of ``tail_multiple``.
    """
    csr = _csr_parts(A)
    n, m = csr.shape
    row_nnz = np.diff(csr.indptr).astype(np.int64)
    wmax = int(row_nnz.max(initial=1))
    w = int(width) if width is not None else hyb_split_width(row_nnz, tail_width)[0]
    w = max(min(w, wmax), 1)
    dtype = dtype or csr.data.dtype
    data, indices, entry_row, slot = _ell_arrays(csr, w, dtype)

    wt = int(tail_width)
    overflow = np.maximum(row_nnz - w, 0)
    chunks_per_row = -(-overflow // wt)  # ceil
    t = int(chunks_per_row.sum())
    t_pad = max(-(-max(t, 1) // tail_multiple) * tail_multiple, tail_multiple)
    tail_rows = np.zeros(t_pad, dtype=np.int32)
    tail_data = np.zeros((t_pad, wt), dtype=dtype)
    tail_indices = np.zeros((t_pad, wt), dtype=np.int32)
    if t:
        long_rows = np.flatnonzero(chunks_per_row)
        tail_rows[:t] = np.repeat(long_rows, chunks_per_row[long_rows])
        # first chunk id of each row, then (chunk, pos) per overflow entry
        chunk_start = np.zeros(n, dtype=np.int64)
        chunk_start[1:] = np.cumsum(chunks_per_row)[:-1]
        over = slot >= w
        p = slot[over] - w
        tr = chunk_start[entry_row[over]] + p // wt
        ts = p % wt
        tail_data[tr, ts] = csr.data[over]
        tail_indices[tr, ts] = csr.indices[over]
    return HybMatrix(
        ell_data=data,
        ell_indices=indices,
        tail_rows=tail_rows,
        tail_data=tail_data,
        tail_indices=tail_indices,
        shape=(n, m),
    )


def to_dense(A, dtype=None) -> DenseMatrix:
    if hasattr(A, "toarray"):
        arr = A.toarray()
    else:
        arr = np.asarray(A)
    return DenseMatrix(np.asarray(arr, dtype=dtype))


def pad_to_multiple(A: Operator, b: np.ndarray, multiple: int) -> Tuple[Operator, np.ndarray, int]:
    """Zero-pad the system so N divides ``multiple``.

    Counterpart of the reference's padding step that makes N divisible
    by the process/GPU count (reference: v2/cpu/mpi/common.py:28-51,
    v2/gpu/common.py:25-60).  Padding rows get a unit diagonal (keeps the
    operator SPD and padded solution entries exactly zero for zero rhs).
    Returns (padded_A, padded_b, original_N).
    """
    from krylov_tpu.sparse.formats import StencilMatrix

    n = A.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return A, np.asarray(b), n
    if isinstance(A, StencilMatrix):
        # Padded stencils lose their grid structure; fall back to flat DIA.
        return pad_to_multiple(A.to_dia(), b, multiple)
    b_p = np.concatenate([np.asarray(b), np.zeros(pad, dtype=np.asarray(b).dtype)])
    if isinstance(A, DiaMatrix):
        data = np.asarray(A.data)
        new = np.zeros((data.shape[0], n + pad), dtype=data.dtype)
        new[:, :n] = data
        offsets = A.offsets
        if 0 in offsets:
            d0 = offsets.index(0)
        else:
            offsets = (0,) + offsets
            new = np.concatenate([np.zeros((1, n + pad), new.dtype), new], axis=0)
            d0 = 0
        new[d0, n:] = 1.0
        return (DiaMatrix(new, offsets, (n + pad, n + pad)), b_p, n)
    if isinstance(A, EllMatrix):
        data = np.asarray(A.data)
        idx = np.asarray(A.indices)
        w = data.shape[1]
        new_data = np.zeros((n + pad, w), dtype=data.dtype)
        new_idx = np.zeros((n + pad, w), dtype=idx.dtype)
        new_data[:n] = data
        new_idx[:n] = idx
        new_data[n:, 0] = 1.0
        new_idx[n:, 0] = np.arange(n, n + pad, dtype=idx.dtype)
        return (
            EllMatrix(new_data, new_idx, (n + pad, n + pad)),
            b_p,
            n,
        )
    if isinstance(A, HybMatrix):
        data = np.asarray(A.ell_data)
        idx = np.asarray(A.ell_indices)
        w = data.shape[1]
        new_data = np.zeros((n + pad, w), dtype=data.dtype)
        new_idx = np.zeros((n + pad, w), dtype=idx.dtype)
        new_data[:n] = data
        new_idx[:n] = idx
        new_data[n:, 0] = 1.0
        new_idx[n:, 0] = np.arange(n, n + pad, dtype=idx.dtype)
        return (
            HybMatrix(
                new_data,
                new_idx,
                A.tail_rows,
                A.tail_data,
                A.tail_indices,
                (n + pad, n + pad),
            ),
            b_p,
            n,
        )
    if isinstance(A, DenseMatrix):
        data = np.asarray(A.data)
        new = np.zeros((n + pad, n + pad), dtype=data.dtype)
        new[:n, :n] = data
        new[range(n, n + pad), range(n, n + pad)] = 1.0
        return DenseMatrix(new), b_p, n
    raise TypeError(f"cannot pad operator of type {type(A)}")


def host_matvec64(A, x) -> np.ndarray:
    """``A @ x`` evaluated in float64 NumPy on the host.

    Used by :func:`krylov_tpu.solve`'s ``refine=`` path (mixed-precision
    iterative refinement): the residual ``b - A x`` must be formed in higher
    precision than the device dtype for a restart to see below the float32
    representation floor.  Cheap: one pass over the operator per restart.
    """
    from krylov_tpu.sparse.formats import StencilMatrix

    x = np.asarray(x, dtype=np.float64)
    if isinstance(A, StencilMatrix):
        A = A.to_dia()
    if isinstance(A, DiaMatrix):
        n = A.shape[0]
        data = np.asarray(A.data, dtype=np.float64)
        y = np.zeros(n)
        for d, off in enumerate(A.offsets):
            lo, hi = max(0, -off), min(n, n - off)
            if hi > lo:
                y[lo:hi] += data[d, lo:hi] * x[lo + off : hi + off]
        return y
    if isinstance(A, EllMatrix):
        data = np.asarray(A.data, dtype=np.float64)
        idx = np.asarray(A.indices)
        return (data * x[idx]).sum(axis=-1)
    if isinstance(A, HybMatrix):
        data = np.asarray(A.ell_data, dtype=np.float64)
        idx = np.asarray(A.ell_indices)
        y = (data * x[idx]).sum(axis=-1)
        t_data = np.asarray(A.tail_data, dtype=np.float64)
        t_idx = np.asarray(A.tail_indices)
        extra = (t_data * x[t_idx]).sum(axis=-1)
        np.add.at(y, np.asarray(A.tail_rows), extra)
        return y
    if isinstance(A, DenseMatrix):
        return np.asarray(A.data, dtype=np.float64) @ x
    raise TypeError(f"no host matvec for {type(A).__name__}")
