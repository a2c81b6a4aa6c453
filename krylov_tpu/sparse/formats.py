"""Sparse matrix containers, registered as JAX pytrees.

The reference library operates on ``np.ndarray`` dense matrices or
``scipy.sparse.csr_matrix`` and leans on BLAS/cuSPARSE for ``A.dot(x)``
(reference: v3/cpu/cg.py:27, v3/gpu/common.py:95-105).  CSR's per-row
variable-length structure does not fit XLA's static shapes, so this library
uses fixed-shape containers instead:

- :class:`DiaMatrix` — diagonal (banded / stencil) storage.  All of the
  reference's benchmark problems (1-D Poisson, 2-D 5-point Laplacian) are
  banded; a DIA matvec is a handful of shifted elementwise multiply-adds —
  unit-stride memory access and no gathers, which XLA fuses into one pass.
- :class:`EllMatrix` — ELLPACK: fixed-width padded rows.  The general-sparse
  workhorse; the matvec is a dense gather + row reduction that XLA maps well.
- :class:`DenseMatrix` — plain dense operand; the matvec is one GEMV.

All containers are immutable pytrees so they can be passed through ``jit``,
``shard_map``, ``scan`` etc.; structural metadata (shape, offsets, block
sizes) is static so XLA sees fixed shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def _register_dataclass_pytree(cls, data_fields, meta_fields):
    jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )
    return cls


@jax.custom_batching.custom_vmap
def gather_rows(x: jax.Array, idx: jax.Array) -> jax.Array:
    """``x[idx]`` for 1-D ``x`` and integer ``idx`` of any shape — the
    irregular-SpMV gather primitive.

    A plain element gather.  It is a function of its own for its batching
    rule (below), which turns a batch of gathers with shared indices into
    one multi-RHS row gather.  The reference delegates this to
    scipy/cuSPARSE CSR (v3/cpu/cg.py:27, v3/gpu/common.py:95-105).
    """
    return jnp.take(x, idx, axis=0)


@gather_rows.def_vmap
def _gather_rows_vmap(axis_size, in_batched, x, idx):
    """Batched gathers amortize to ONE multi-RHS row gather.

    A batch of gathers with SHARED indices is the multi-RHS amortization
    opportunity: lay the batch out as the TRAILING axis of a (n, batch)
    matrix and gather ROWS — each gathered "element" is then a batch-wide
    contiguous slice, so the per-element addressing cost is paid once per
    index for the whole batch, and the index stream is read once.  The
    rule defines no differentiation rule: ``custom_vmap`` functions are not
    differentiable.
    """
    x_b, idx_b = in_batched
    if x_b and not idx_b:
        xt = jnp.moveaxis(x, 0, -1)  # (n, batch)
        out = jnp.take(xt, idx, axis=0)  # (*idx.shape, batch)
        return jnp.moveaxis(out, -1, 0), True
    if not x_b and not idx_b:
        return gather_rows(x, idx), False
    # idx batched (rare: batched operators) — sequential fallback.
    from jax import lax

    if not x_b:
        return lax.map(lambda i: gather_rows(x, i), idx), True
    return lax.map(lambda xi: gather_rows(xi[0], xi[1]), (x, idx)), True


@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """Banded matrix in row-indexed diagonal storage.

    ``data[d, i] == A[i, i + offsets[d]]``; entries whose column index falls
    outside ``[0, N)`` must be stored as zero.  ``offsets`` is static
    (a tuple of python ints) so the matvec unrolls into ``len(offsets)``
    shifted multiply-adds at trace time.
    """

    data: jax.Array  # (ndiags, nrows)
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        # Upper bound (stored entries); exact for fixtures built without
        # explicit zeros in-band.
        n = self.shape[0]
        return sum(n - abs(o) for o in self.offsets)

    @property
    def bandwidth(self) -> int:
        return max(abs(o) for o in self.offsets) if self.offsets else 0

    def matvec(self, x: jax.Array) -> jax.Array:
        """y[i] = sum_d data[d, i] * x[i + offsets[d]].

        Implemented as zero-pad + static shifted slices + multiply-adds:
        pure elementwise work that XLA fuses into a single pass (no gather
        or scatter ops).  Out-of-range band entries are stored as zero, so
        the padded reads are harmless.
        """
        n = self.shape[0]
        pad_l = max(0, -min(self.offsets))
        pad_r = max(0, max(self.offsets))
        x_ext = jnp.pad(x, (pad_l, pad_r)) if (pad_l or pad_r) else x
        y = jnp.zeros_like(x, shape=(n,))
        for d, off in enumerate(self.offsets):
            start = pad_l + off
            y = y + self.data[d] * lax.slice(x_ext, (start,), (start + n,))
        return y

    def todense(self) -> np.ndarray:
        n, m = self.shape
        out = np.zeros((n, m), dtype=np.asarray(self.data).dtype)
        data = np.asarray(self.data)
        for d, off in enumerate(self.offsets):
            for i in range(n):
                j = i + off
                if 0 <= j < m:
                    out[i, j] = data[d, i]
        return out


_register_dataclass_pytree(DiaMatrix, ["data"], ["offsets", "shape"])


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """ELLPACK (padded fixed-width rows).

    ``data[i, s]`` is the value of the ``s``-th stored entry of row ``i`` and
    ``indices[i, s]`` its column.  Padding slots carry value 0 with an
    arbitrary in-range column index, so they contribute nothing to the
    matvec.  The matvec is ``(data * x[indices]).sum(-1)`` — one gather plus
    a row reduction, both static-shape.
    """

    data: jax.Array  # (nrows, width)
    indices: jax.Array  # (nrows, width) int32
    shape: Tuple[int, int]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(np.asarray(self.data)))

    def matvec(self, x: jax.Array) -> jax.Array:
        return jnp.sum(self.data * gather_rows(x, self.indices), axis=1)

    def todense(self) -> np.ndarray:
        n, m = self.shape
        out = np.zeros((n, m), dtype=np.asarray(self.data).dtype)
        data = np.asarray(self.data)
        idx = np.asarray(self.indices)
        for i in range(n):
            for s in range(idx.shape[1]):
                out[i, idx[i, s]] += data[i, s]
        return out


_register_dataclass_pytree(EllMatrix, ["data", "indices"], ["shape"])


@jax.custom_batching.custom_vmap
def _scatter_add_rows(y: jax.Array, rows: jax.Array, extra: jax.Array):
    """``y.at[rows].add(extra)`` for 1-D ``y`` — the HYB tail accumulate."""
    return y.at[rows].add(extra)


@_scatter_add_rows.def_vmap
def _scatter_add_rows_vmap(axis_size, in_batched, y, rows, extra):
    """Batched tail scatter-adds amortize like the gathers (gather_rows):
    with shared target rows, lay the batch out trailing and scatter
    batch-wide SLICES into an (n, batch) matrix — one addressed update
    per row for the whole batch, instead of the per-lane batched scatter
    XLA derives from vmap."""
    y_b, rows_b, e_b = in_batched
    if y_b and e_b and not rows_b:
        yt = jnp.moveaxis(y, 0, -1)  # (n, batch)
        et = jnp.moveaxis(extra, 0, -1)  # (t, batch)
        out = yt.at[rows].add(et)
        return jnp.moveaxis(out, -1, 0), True
    from jax import lax

    if not (y_b or rows_b or e_b):
        return _scatter_add_rows(y, rows, extra), False

    def pick(v, batched):
        return (lambda i: v[i]) if batched else (lambda i: v)

    fy, fr, fe = pick(y, y_b), pick(rows, rows_b), pick(extra, e_b)
    return lax.map(
        lambda i: _scatter_add_rows(fy(i), fr(i), fe(i)),
        jnp.arange(axis_size),
    ), True


@dataclasses.dataclass(frozen=True)
class HybMatrix:
    """Hybrid ELL + tail storage for skewed row-nnz distributions.

    Plain ELLPACK pads every row to the maximum row width, which blows up
    memory on power-law degree distributions (SuiteSparse graph matrices):
    one 10k-nnz hub row forces 10k-wide padding on a million 8-nnz rows.
    The classic fix (cuSPARSE's HYB format) splits the matrix:

    - the first ``w`` entries of every row live in a regular ELL block
      (``ell_data``/``ell_indices``, shape ``(n, w)``) — dense gather + row
      reduction, fully vectorized;
    - the overflow of the few long rows lives in a fixed-width tail block
      (``tail_data``/``tail_indices``, shape ``(t, w_tail)``): each long row
      is SPLIT into ceil(overflow / w_tail) chunks, every chunk carrying the
      same target row in ``tail_rows``, and the chunk contributions are
      scatter-ADDED (duplicates accumulate) — so one 5000-nnz hub row costs
      ~5000 stored slots, not 5000-wide padding across the whole tail.  ``t``
      is tiny for skewed matrices, so the serializing scatter touches a
      negligible fraction of rows.

    ``w`` is chosen at conversion time to minimize total storage
    (:func:`krylov_tpu.sparse.convert.hyb_split_width`).  Padding slots store
    value 0 with an in-range column; padding *tail chunks* store row 0 with
    all-zero data (a scatter-add of zero).

    The reference handles such matrices through scipy/cuSPARSE CSR
    (reference: v3/cpu/cg.py:27, v3/gpu/common.py:95-105); CSR's per-row
    variable length cannot map onto static-shape XLA, and this split is the
    static-shape answer.  The matvec uses :func:`gather_rows` for both
    blocks, so batched solves get its multi-RHS row gather.
    """

    ell_data: jax.Array  # (n, w)
    ell_indices: jax.Array  # (n, w) int32
    tail_rows: jax.Array  # (t,) int32
    tail_data: jax.Array  # (t, w_tail)
    tail_indices: jax.Array  # (t, w_tail) int32
    shape: Tuple[int, int]

    @property
    def dtype(self):
        return self.ell_data.dtype

    @property
    def width(self) -> int:
        return self.ell_data.shape[1]

    @property
    def tail_width(self) -> int:
        return self.tail_data.shape[1]

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(np.asarray(self.ell_data))) + int(
            np.count_nonzero(np.asarray(self.tail_data))
        )

    @property
    def stored_entries(self) -> int:
        """Total padded storage slots (the quantity HYB minimizes vs ELL)."""
        return self.ell_data.size + self.tail_data.size

    def matvec(self, x: jax.Array) -> jax.Array:
        y = jnp.sum(self.ell_data * gather_rows(x, self.ell_indices), axis=1)
        extra = jnp.sum(
            self.tail_data * gather_rows(x, self.tail_indices), axis=1
        )
        return _scatter_add_rows(y, self.tail_rows, extra)

    def todense(self) -> np.ndarray:
        n, m = self.shape
        out = np.zeros((n, m), dtype=np.asarray(self.ell_data).dtype)
        data = np.asarray(self.ell_data)
        idx = np.asarray(self.ell_indices)
        for i in range(n):
            for s in range(idx.shape[1]):
                out[i, idx[i, s]] += data[i, s]
        t_rows = np.asarray(self.tail_rows)
        t_data = np.asarray(self.tail_data)
        t_idx = np.asarray(self.tail_indices)
        for ti in range(t_rows.shape[0]):
            for s in range(t_idx.shape[1]):
                out[t_rows[ti], t_idx[ti, s]] += t_data[ti, s]
        return out


_register_dataclass_pytree(
    HybMatrix,
    ["ell_data", "ell_indices", "tail_rows", "tail_data", "tail_indices"],
    ["shape"],
)


@dataclasses.dataclass(frozen=True)
class StencilMatrix:
    """Grid-aware banded operator: a stencil on a structured d-dim grid.

    For operators that come from structured grids (the reference's benchmark
    families: 1-D Poisson, 2-D 5-point / 3-D 7-point Laplacians), plain DIA
    storage flattens the grid and turns neighbor couplings into ±1 / ±nx
    vector shifts.  Keeping the grid shape explicit instead lets the matvec
    run as d-dimensional shifted slices of the grid view, which XLA fuses
    with the padding into one elementwise pass, and lets the sharded path
    exchange whole boundary planes (:mod:`krylov_tpu.dist.spmv`).

    ``coef[s, *g] = A[flat(g), flat(g + stencil[s])]`` — row-indexed, like
    :class:`DiaMatrix`; couplings leaving the grid must be stored as zero
    (zero padding makes their reads harmless).

    **Constant-coefficient form**: ``coef`` may instead be a flat
    ``(nstencil,)`` vector of per-term weights (e.g. the 5-point Laplacian's
    ``[-1, -1, 4, -1, -1]``).  Dirichlet boundaries still come out exactly
    right — a coupling leaving the grid reads the zero padding of ``x`` —
    while the matvec stops streaming ``nstencil`` coefficient grids from
    device memory, and the operator shrinks from ``nstencil`` grids to
    ``nstencil`` scalars.
    """

    coef: jax.Array  # (nstencil, *grid) or (nstencil,) constant weights
    stencil: Tuple[Tuple[int, ...], ...]  # per-term grid displacement
    grid: Tuple[int, ...]

    @property
    def shape(self):
        n = 1
        for g in self.grid:
            n *= g
        return (n, n)

    @property
    def dtype(self):
        return self.coef.dtype

    @property
    def nnz(self) -> int:
        n = self.shape[0]
        return len(self.stencil) * n  # upper bound (stored entries)

    @property
    def is_constant(self) -> bool:
        """True for the constant-coefficient (per-term scalar weight) form."""
        return self.coef.ndim == 1

    def grid_coef(self) -> jax.Array:
        """Materialize full ``(nstencil, *grid)`` coefficients.

        For the constant form, weights broadcast over the grid with
        leaving-the-grid couplings zeroed — the invariant every flat-indexed
        consumer (DIA conversion, row partitioning) depends on.  Host
        containers (numpy ``coef``) are expanded in pure numpy so host-side
        consumers never touch the device (see :func:`to_device`).
        """
        if not self.is_constant:
            return self.coef
        ns = len(self.stencil)
        mask = np.ones((ns,) + self.grid, dtype=bool)
        for s, disp in enumerate(self.stencil):
            for ax, d in enumerate(disp):
                sl = [s] + [slice(None)] * len(self.grid)
                if d > 0:
                    sl[1 + ax] = slice(self.grid[ax] - d, None)
                elif d < 0:
                    sl[1 + ax] = slice(0, -d)
                else:
                    continue
                mask[tuple(sl)] = False
        shape = (ns,) + (1,) * len(self.grid)
        if isinstance(self.coef, np.ndarray):
            return np.where(
                mask,
                self.coef.reshape(shape),
                np.zeros((), self.coef.dtype),
            )
        return jnp.where(
            jnp.asarray(mask),
            self.coef.reshape(shape),
            jnp.zeros((), self.coef.dtype),
        )

    @property
    def offsets(self) -> Tuple[int, ...]:
        """Flat DIA offsets equivalent to the stencil displacements."""
        strides = []
        acc = 1
        for g in reversed(self.grid):
            strides.append(acc)
            acc *= g
        strides = tuple(reversed(strides))
        return tuple(
            sum(d * s for d, s in zip(disp, strides)) for disp in self.stencil
        )

    def matvec(self, x: jax.Array) -> jax.Array:
        xg = x.reshape(self.grid)
        pads = []
        for ax in range(len(self.grid)):
            lo = max(0, -min(d[ax] for d in self.stencil))
            hi = max(0, max(d[ax] for d in self.stencil))
            pads.append((lo, hi))
        xp = jnp.pad(xg, pads)
        y = jnp.zeros_like(xg)
        for s, disp in enumerate(self.stencil):
            starts = tuple(p[0] + d for p, d in zip(pads, disp))
            limits = tuple(st + g for st, g in zip(starts, self.grid))
            y = y + self.coef[s] * lax.slice(xp, starts, limits)
        return y.reshape(-1)

    def to_dia(self) -> "DiaMatrix":
        """Exact conversion to flat DIA storage (same row-indexed values)."""
        n = self.shape[0]
        coef = np.asarray(self.grid_coef()).reshape(len(self.stencil), n)
        offs = self.offsets
        # merge duplicate offsets if any
        order = np.argsort(offs)
        merged: dict = {}
        for s in order:
            merged.setdefault(offs[s], np.zeros(n, coef.dtype))
            merged[offs[s]] += coef[s]
        keys = sorted(merged)
        data = np.stack([merged[o] for o in keys])
        return DiaMatrix(data, tuple(int(o) for o in keys), (n, n))

    def todense(self) -> np.ndarray:
        return self.to_dia().todense()


_register_dataclass_pytree(StencilMatrix, ["coef"], ["stencil", "grid"])


@dataclasses.dataclass(frozen=True)
class DenseMatrix:
    """Dense operand; the matvec is a GEMV at ``Precision.HIGHEST``."""

    data: jax.Array  # (nrows, ncols)

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0]) * int(self.data.shape[1])

    def matvec(self, x: jax.Array) -> jax.Array:
        return jnp.dot(self.data, x, precision=lax.Precision.HIGHEST)

    def todense(self) -> np.ndarray:
        return np.asarray(self.data)


_register_dataclass_pytree(DenseMatrix, ["data"], [])


Operator = DiaMatrix | StencilMatrix | EllMatrix | HybMatrix | DenseMatrix


# Identity-keyed commit cache: host-lazy container -> committed form.
# Weakly keyed on the HOST container (evicted when it is collected); the
# `ref() is A` check guards against id() reuse after collection.
_COMMIT_CACHE: dict = {}


def to_device(A: Operator) -> Operator:
    """Commit an operator's array leaves to the default device.

    Containers are built HOST-LAZY (numpy leaves — fixtures and scipy
    conversions never touch an accelerator); the solve front doors call this
    once per solve so dispatches reuse committed device buffers instead of
    re-transferring per call.  Idempotent: device leaves (and tracers, when
    called inside a jitted program) pass through unchanged.

    Repeated calls on the SAME host-lazy container return the same
    committed operator (identity-keyed weak cache): without it, every
    ``solve(A, b)`` call on a host-lazy container re-uploads the whole
    matrix.  The device buffers live as long as the host container does.

    A commit made while a ``jit`` trace is running yields tracers that are
    valid only inside that trace, so it is returned but never cached: a
    later host-side solve on the same container commits afresh.
    """
    import weakref

    leaves = jax.tree.leaves(A)
    if all(isinstance(l, jax.Array) for l in leaves):
        return A  # already committed (or traced)
    if not all(isinstance(l, np.ndarray) for l in leaves):
        return jax.tree.map(jnp.asarray, A)
    key = id(A)
    hit = _COMMIT_CACHE.get(key)
    if hit is not None and hit[0]() is A:
        return hit[1]
    committed = jax.tree.map(jnp.asarray, A)
    if any(isinstance(l, jax.core.Tracer) for l in jax.tree.leaves(committed)):
        return committed
    try:
        ref = weakref.ref(A, lambda _, k=key: _COMMIT_CACHE.pop(k, None))
    except TypeError:  # not weakref-able: no safe eviction, skip caching
        return committed
    _COMMIT_CACHE[key] = (ref, committed)
    return committed


def as_operator(A, dtype=None) -> Operator:
    """Coerce ``A`` into a library operator.

    Accepts our containers (returned unchanged), numpy/JAX dense arrays, and
    scipy sparse matrices (converted via :func:`krylov_tpu.sparse.convert`).
    This is the front-door coercion used by :func:`krylov_tpu.api.solve`, the
    analog of the reference accepting either ``np.ndarray`` or
    ``scipy.sparse.csr_matrix`` (reference: v2/cpu/mpi/common.py:26-64 treats
    both cases explicitly).
    """
    from krylov_tpu.sparse import convert

    if isinstance(A, (DiaMatrix, StencilMatrix, EllMatrix, HybMatrix, DenseMatrix)):
        return A
    if hasattr(A, "tocsr") and hasattr(A, "nnz"):  # scipy sparse
        return convert.from_scipy(A, dtype=dtype)
    # numpy input stays host-side (host-lazy, like the other conversions);
    # jax arrays / tracers pass through jnp untouched.
    arr = (
        np.asarray(A, dtype=dtype)
        if isinstance(A, np.ndarray)
        else jnp.asarray(A, dtype=dtype)
    )
    if arr.ndim != 2:
        raise ValueError(f"expected a 2-D operand, got shape {arr.shape}")
    return DenseMatrix(arr)
