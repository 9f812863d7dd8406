"""Sparse data substrate: the CSR container and the blocked-ELL tile layout.

Host-side numpy, the same code as the JAX package's ``repro.data.sparse``
so one seed gives identical arrays in both packages:

* :class:`CSRMatrix` — CSR in the **feature-major** ``(d, n)`` convention
  (rows are features, columns are samples), with the row/column nnz
  histograms the nnz-aware partitioner (:mod:`repro_torch.data.partition`)
  balances on.
* :class:`BlockedEll` — the matrix cut into ``(block_rows, block_cols)``
  dense tiles, empty tiles dropped, each row-block keeping a fixed-width
  (padded) list of its surviving tiles. The CUDA kernels of
  :mod:`repro_torch.kernels.sparse_hvp` walk this layout.
* :func:`load_libsvm_sparse` / :func:`iter_libsvm_chunks` — the chunked
  libsvm reader (O(nnz + chunk) peak memory), the paper's data format.
* :func:`make_sparse_glm_data` — synthetic power-law-sparsity GLM data.

On the device a shard's pair of layouts (forward for ``X @ v``, transposed
for ``X^T u``) travels as the :class:`EllPair` of four tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# CSR container (host side, numpy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CSRMatrix:
    """Compressed-sparse-row matrix in the feature-major ``(d, n)`` layout.

    ``indptr`` has length ``d + 1``; ``indices[indptr[i]:indptr[i+1]]``
    are the sample indices holding nonzeros of feature ``i``.
    """

    indptr: np.ndarray   # (d + 1,) int64
    indices: np.ndarray  # (nnz,) int32 column (sample) indices
    data: np.ndarray     # (nnz,) values
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        """Number of stored nonzeros."""
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def xt_dot(self, w: np.ndarray) -> np.ndarray:
        """Host-side margins ``X^T w`` of the feature-major ``(d, n)``
        matrix: one O(nnz) scatter-add pass in float64, cast back to the
        value dtype (``repro.data.sparse.CSRMatrix.xt_dot``)."""
        w = np.asarray(w)
        d, n = self.shape
        rows = np.repeat(np.arange(d), np.diff(self.indptr))
        out = np.zeros(n, np.float64)
        np.add.at(out, self.indices,
                  self.data.astype(np.float64) * w.astype(np.float64)[rows])
        return out.astype(self.data.dtype)

    @classmethod
    def from_dense(cls, X: np.ndarray, dtype=np.float32) -> "CSRMatrix":
        """Build from a dense ``(d, n)`` array, dropping exact zeros."""
        X = np.asarray(X)
        d, n = X.shape
        mask = X != 0
        counts = mask.sum(axis=1)
        indptr = np.zeros(d + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        rows, cols = np.nonzero(mask)
        order = np.lexsort((cols, rows))
        return cls(indptr=indptr,
                   indices=cols[order].astype(np.int32),
                   data=X[rows[order], cols[order]].astype(dtype),
                   shape=(d, n))

    @classmethod
    def from_coo(cls, rows, cols, vals, shape, dtype=np.float32
                 ) -> "CSRMatrix":
        """Build from COO triplets (duplicates must not occur)."""
        d, n = shape
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        counts = np.bincount(rows, minlength=d)
        indptr = np.zeros(d + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        return cls(indptr=indptr, indices=cols.astype(np.int32),
                   data=vals.astype(dtype), shape=(d, n))

    def todense(self) -> np.ndarray:
        """Materialize the dense ``(d, n)`` array (tests / small data)."""
        d, n = self.shape
        X = np.zeros((d, n), self.data.dtype)
        rows = np.repeat(np.arange(d), np.diff(self.indptr))
        X[rows, self.indices] = self.data
        return X

    def nnz_per_row(self) -> np.ndarray:
        """(d,) nonzeros per feature — what DiSCO-F load-balances on."""
        return np.diff(self.indptr).astype(np.int64)

    def nnz_per_col(self) -> np.ndarray:
        """(n,) nonzeros per sample — what DiSCO-S load-balances on."""
        return np.bincount(self.indices, minlength=self.shape[1]
                           ).astype(np.int64)

    def take_rows(self, idx: np.ndarray) -> "CSRMatrix":
        """New CSR holding rows ``idx`` in the given order. Indices
        ``>= d`` select synthetic *empty* rows — the padding slots a
        :class:`repro_torch.data.partition.Partition` permutation may
        contain."""
        idx = np.asarray(idx, np.int64)
        d = self.shape[0]
        starts = np.where(idx < d, self.indptr[np.minimum(idx, d - 1)], 0)
        ends = np.where(idx < d, self.indptr[np.minimum(idx, d - 1) + 1], 0)
        counts = ends - starts
        indptr = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        gather = np.concatenate(
            [np.arange(s, e) for s, e in zip(starts, ends)]
        ) if len(idx) else np.zeros(0, np.int64)
        gather = gather.astype(np.int64)
        return CSRMatrix(indptr=indptr, indices=self.indices[gather],
                         data=self.data[gather],
                         shape=(len(idx), self.shape[1]))

    def take_cols_dense(self, idx: np.ndarray) -> np.ndarray:
        """Dense ``(d, len(idx))`` slab of the selected sample columns —
        how the tau preconditioner samples are materialized."""
        idx = np.asarray(idx, np.int64)
        d, n = self.shape
        pos = np.full(n, -1, np.int64)
        pos[idx] = np.arange(len(idx))
        keep = pos[self.indices] >= 0
        rows = np.repeat(np.arange(d), np.diff(self.indptr))[keep]
        out = np.zeros((d, len(idx)), self.data.dtype)
        out[rows, pos[self.indices[keep]]] = self.data[keep]
        return out

    def transpose(self) -> "CSRMatrix":
        """CSR of X^T — an ``(n, d)`` matrix with rows = samples."""
        d, n = self.shape
        rows = np.repeat(np.arange(d), np.diff(self.indptr))
        return CSRMatrix.from_coo(self.indices, rows, self.data, (n, d),
                                  dtype=self.data.dtype)


# ---------------------------------------------------------------------------
# blocked-ELL tiles (host side) + the device-side pair
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BlockedEll:
    """Tile-granular blocked-ELL: per row-block, a padded list of tiles.

    ``data[i, k]`` is the dense ``(block_rows, block_cols)`` tile of the
    ``k``-th surviving column-block of row-block ``i``; ``cols[i, k]`` its
    column-block index. Padding slots carry ``cols = 0`` and an all-zero
    tile, so they contribute nothing to products. The padded logical shape
    is ``(n_row_blocks * block_rows, n_col_blocks * block_cols)``.
    """

    data: np.ndarray   # (n_row_blocks, width, block_rows, block_cols)
    cols: np.ndarray   # (n_row_blocks, width) int32
    shape: tuple[int, int]          # logical (unpadded) shape
    block: tuple[int, int]          # (block_rows, block_cols)

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    @property
    def n_row_blocks(self) -> int:
        return int(self.data.shape[0])

    @property
    def n_col_blocks(self) -> int:
        return max(-(-self.shape[1] // self.block[1]), 1)

    def todense(self) -> np.ndarray:
        """Dense padded array, then cropped to the logical shape."""
        nb, w, br, bc = self.data.shape
        X = np.zeros((nb * br, self.n_col_blocks * bc), self.data.dtype)
        for i in range(nb):
            for k in range(w):
                c = int(self.cols[i, k])
                X[i * br:(i + 1) * br, c * bc:(c + 1) * bc] += \
                    self.data[i, k]
        return X[: self.shape[0], : self.shape[1]]


class EllPlan(NamedTuple):
    """Where the nonzeros of one matrix go in its blocked-ELL layout,
    computed from the index structure alone (:func:`ell_plan`).

    ``cols`` (nb, W) int32 column-block ids (padding slots 0);
    ``per_block`` (nb,) each row-block's tile count, which is its live
    count (its slots up to the last real tile); ``offsets`` (nnz,) int64,
    the flat position of each nonzero, in the order of the values it was
    planned from, in the ``(nb, W, br, bc)`` tile array ``shape``;
    ``logical`` the unpadded ``(rows, cols)`` of the matrix.
    """

    cols: np.ndarray
    per_block: np.ndarray
    offsets: np.ndarray
    shape: tuple[int, int, int, int]
    logical: tuple[int, int]


# tile-id bitmaps up to this many entries (beyond nnz) replace the sort
# of the tile ids; both give the same plan
_BITMAP_EXTRA = 1 << 22


def _plan_pairs(rows, cols, shape, br, bc, width) -> EllPlan:
    """The :class:`EllPlan` of the nonzeros at (``rows``, ``cols``) of a
    ``shape`` matrix cut into ``(br, bc)`` tiles; pairs in any order."""
    d, n = shape
    nrb, ncb = -(-d // br), max(-(-n // bc), 1)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    rb, cb = rows // br, cols // bc
    tile_ids = rb * ncb + cb
    # per row-block: its column-blocks in ascending order, and each
    # nonzero's tile rank among all tiles (row-block major)
    if nrb * ncb <= len(tile_ids) + _BITMAP_EXTRA:
        present = np.zeros(nrb * ncb, bool)
        present[tile_ids] = True
        uniq = np.flatnonzero(present)
        rank = np.cumsum(present) - 1
        tile_rank = rank[tile_ids]
    else:
        uniq = np.unique(tile_ids)
        tile_rank = np.searchsorted(uniq, tile_ids)
    urb, ucb = uniq // ncb, uniq % ncb
    per_block = np.bincount(urb, minlength=nrb).astype(np.int64)
    natural = int(per_block.max()) if len(uniq) else 0
    w = max(width or 0, natural, 1)
    if width is not None and width < natural:
        raise ValueError(f"width {width} < natural max width {natural}")
    ell_cols = np.zeros((nrb, w), np.int32)
    # tiles of one row-block occupy a contiguous run of ranks from
    # starts[r], so a tile's slot is its rank less that start
    starts = np.zeros(nrb + 1, np.int64)
    np.cumsum(per_block, out=starts[1:])
    ell_cols[urb, np.arange(len(uniq)) - starts[urb]] = ucb.astype(np.int32)
    slot = tile_rank - starts[rb]
    offsets = ((rb * w + slot) * br + rows % br) * bc + cols % bc
    return EllPlan(cols=ell_cols, per_block=per_block, offsets=offsets,
                   shape=(nrb, w, br, bc), logical=(d, n))


def ell_plan(csr: CSRMatrix, block_rows: int, block_cols: int,
             width: int | None = None, *, transpose: bool = False
             ) -> EllPlan:
    """The blocked-ELL plan of ``csr`` (``transpose=True``: of its
    transpose) in ``(block_rows, block_cols)`` tiles, from the index
    structure alone; ``offsets`` follow ``csr.data``'s order either way,
    so one value array fills both layouts and no transpose of the CSR is
    built. ``width`` as for :func:`ell_from_csr`. Host numpy."""
    d, n = csr.shape
    rows = np.repeat(np.arange(d, dtype=np.int64), np.diff(csr.indptr))
    if transpose:
        return _plan_pairs(csr.indices, rows, (n, d), block_rows,
                           block_cols, width)
    return _plan_pairs(rows, csr.indices, (d, n), block_rows, block_cols,
                       width)


def _zeros(shape, dtype, device) -> torch.Tensor:
    """Zeros; on the CPU in numpy's lazily zeroed pages where numpy has
    the dtype (a layout of several GB is mostly never touched)."""
    if device.type == "cpu" and dtype != torch.bfloat16:
        return torch.from_numpy(np.zeros(
            shape, torch.empty((), dtype=dtype).numpy().dtype))
    return torch.zeros(shape, dtype=dtype, device=device)


def ell_fill(plan: EllPlan, values, *, out=None, device="cpu",
             dtype=torch.float32) -> torch.Tensor:
    """The tiles of ``plan`` holding ``values`` (in the plan's order): a
    zeroed ``plan.shape`` tensor (``out``, else a new one of ``dtype`` on
    ``device``) with each value scattered to its offset. Each value is
    cast to the tile dtype before it is placed (at bf16 the
    round-to-nearest-even cast of the host's ``astype``). ``values`` and
    the offsets may be tensors already on the tiles' device (the streamed
    data plane's staged copies) or host arrays."""
    if out is None:
        out = _zeros(plan.shape, dtype, torch.device(device))
    else:
        out.zero_()
    if not isinstance(values, torch.Tensor):
        values = torch.from_numpy(np.array(values, copy=True))
    offsets = plan.offsets
    if not isinstance(offsets, torch.Tensor):
        offsets = torch.from_numpy(np.asarray(offsets, np.int64))
    out.view(-1).scatter_(0, offsets.to(out.device),
                          values.to(out.device).to(out.dtype))
    return out


def ell_from_csr(csr: CSRMatrix, block_rows: int, block_cols: int,
                 width: int | None = None) -> BlockedEll:
    """Cut ``csr`` into tiles and keep only the nonempty ones
    (:func:`ell_plan` then :func:`ell_fill` on the CPU).

    ``width`` pads the per-row-block tile lists to a fixed fan-out (>= the
    natural max). Zero-width matrices get ``width=1`` of zero tiles so the
    kernels always have a (no-op) tile to stream.
    """
    plan = ell_plan(csr, block_rows, block_cols, width)
    values = np.asarray(csr.data)
    data = ell_fill(plan, values,
                    dtype=torch.from_numpy(values[:0].copy()).dtype)
    return BlockedEll(data=data.numpy(), cols=plan.cols, shape=csr.shape,
                      block=(block_rows, block_cols))


def ell_pair_from_csr(csr: CSRMatrix, block_rows: int, block_cols: int,
                      width: int | None = None, width_t: int | None = None
                      ) -> tuple[BlockedEll, BlockedEll]:
    """Forward and transposed blocked-ELL layouts of one shard's matrix
    (``repro.data.sparse.ell_pair_from_csr``): ``ell_from_csr`` of ``csr``
    in ``(block_rows, block_cols)`` tiles at ``width``, and of its
    transpose in ``(block_cols, block_rows)`` tiles at ``width_t``."""
    fwd = ell_from_csr(csr, block_rows, block_cols, width=width)
    tr = ell_from_csr(csr.transpose(), block_cols, block_rows,
                      width=width_t)
    return fwd, tr


def ell_tile_widths(csr: CSRMatrix, block_rows: int, block_cols: int
                    ) -> tuple[int, int]:
    """Natural blocked-ELL widths of a matrix, forward and transposed.

    ``(w_fwd, w_tr)``: the most surviving tiles of a row-block of
    ``ell_from_csr(csr, block_rows, block_cols)`` and of
    ``ell_from_csr(csr.T, block_cols, block_rows)``, from the index
    structure alone (no tile is built); both at least 1, the zero-tile
    floor of :func:`ell_from_csr`. A streamed solve fixes every chunk's
    padded widths with it before any chunk value is read.
    """
    nrb = -(-csr.shape[0] // block_rows)
    ncb = max(-(-csr.shape[1] // block_cols), 1)
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
    rb = rows // block_rows
    cb = np.asarray(csr.indices, np.int64) // block_cols
    uniq = np.unique(rb.astype(np.int64) * ncb + cb)
    if not len(uniq):
        return 1, 1
    w_fwd = int(np.bincount(uniq // ncb, minlength=max(nrb, 1)).max())
    w_tr = int(np.bincount(uniq % ncb, minlength=ncb).max())
    return max(w_fwd, 1), max(w_tr, 1)


def pad_csr_rows(csr: CSRMatrix, n_rows: int) -> CSRMatrix:
    """Extend a CSR slab with trailing empty rows up to ``n_rows`` (how a
    ragged last store chunk is brought to the uniform ``chunk_size``
    width); the slab itself when it already has ``n_rows``."""
    have = csr.shape[0]
    if have == n_rows:
        return csr
    if have > n_rows:
        raise ValueError(f"cannot pad {have} rows down to {n_rows}")
    indptr = np.concatenate(
        [np.asarray(csr.indptr, np.int64),
         np.full(n_rows - have, int(csr.indptr[-1]), np.int64)])
    return CSRMatrix(indptr=indptr, indices=np.asarray(csr.indices),
                     data=np.asarray(csr.data),
                     shape=(n_rows, csr.shape[1]))


def hvp_tile_dtype(name: str) -> torch.dtype:
    """Resolve ``DiscoConfig.hvp_dtype`` to the HVP tiles' torch dtype.

    'float32' / 'f32' -> ``torch.float32``; 'bfloat16' / 'bf16' ->
    ``torch.bfloat16`` (the reference's spellings; it returns numpy
    dtypes, ml_dtypes' bfloat16 for bf16, which the port does not use).
    The mixed-precision contract: only the stored HVP tiles carry this
    dtype; PCG state, coefficients, gradients and margins stay f32, and
    every kernel accumulates and returns f32.
    """
    if name in ("float32", "f32"):
        return torch.float32
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"unknown hvp_dtype {name!r} "
                     "(expected 'float32' or 'bfloat16')")


class EllPair(NamedTuple):
    """Device-side sparse shard operand: the tensors of one shard.

    ``data/cols`` hold the forward blocked-ELL layout of the local shard
    (drives ``X @ v``); ``dataT/colsT`` the transposed layout (drives
    ``X^T u``). Vector lengths are the *padded* dims: ``X @ v`` maps
    ``(ncb*bc,) -> (nrb*br,)`` and ``X^T u`` the reverse. ``sched`` and
    ``schedT`` are the two layouts' live-tile schedules
    (``repro_torch.kernels.sparse_hvp.ell_schedule``) and ``hvp_sched``
    the transposed layout's step schedule for the one-pass HVP
    (``repro_torch.kernels.sparse_hvp.ell_hvp_schedule``), built once at
    set-up and passed with every product; None reads every slot.
    """

    data: torch.Tensor    # (nrb, W, br, bc)
    cols: torch.Tensor    # (nrb, W) int32
    dataT: torch.Tensor   # (ncb, WT, bc, br)
    colsT: torch.Tensor   # (ncb, WT) int32
    sched: torch.Tensor | None = None    # int32, of data / cols
    schedT: torch.Tensor | None = None   # int32, of dataT / colsT
    hvp_sched: object | None = None      # HvpSchedule, of dataT / colsT

    @property
    def padded_shape(self) -> tuple[int, int]:
        """(rows, cols) of the padded local operand."""
        nrb, _, br, _ = self.data.shape
        ncb, _, bc, _ = self.dataT.shape
        return nrb * br, ncb * bc


def stack_shard_ells(csrs: list[CSRMatrix], block_rows: int,
                     block_cols: int, width: int | None = None, *,
                     transpose: bool = False
                     ) -> tuple[np.ndarray, np.ndarray]:
    """The shards' :func:`ell_from_csr` layouts (``transpose=True``: of
    their transposes), stacked into uniform ``(m, ...)`` arrays in
    ``(block_rows, block_cols)`` tiles.

    Every shard is padded to the *global* max ELL width, or to ``width``
    (zero tiles, ``cols = 0``). Each shard is planned from its index
    structure (:func:`ell_plan`) and its values are filled in place into
    one lazily zeroed stack: a layout of several GB, mostly zero pages
    never touched, is neither zeroed nor copied, and no transposed CSR is
    built.
    """
    plan = lambda c, w: ell_plan(c, block_rows, block_cols, w,
                                 transpose=transpose)
    plans = [plan(c, width) for c in csrs]
    W = max(p.shape[1] for p in plans)
    plans = [p if p.shape[1] == W else plan(c, W)
             for c, p in zip(csrs, plans)]
    values = [np.asarray(c.data) for c in csrs]
    data = np.zeros((len(plans),) + plans[0].shape, values[0].dtype)
    for s, (p, v) in enumerate(zip(plans, values)):
        data[s].reshape(-1)[p.offsets] = v
    return data, np.stack([p.cols for p in plans])


def shard_csrs_from_partition(X: CSRMatrix, part, axis: str
                              ) -> list[CSRMatrix]:
    """Split ``X`` into one local CSR per shard under a
    :class:`repro_torch.data.partition.Partition` of the given axis
    ('features' | 'samples'). Every shard's matrix has identical shape
    (``part`` pads with empty indices)."""
    m, width = part.m, part.width
    if axis == "features":
        Xp = X.take_rows(part.perm)
        return [Xp.take_rows(np.arange(s * width, (s + 1) * width))
                for s in range(m)]
    if axis == "samples":
        XTp = X.transpose().take_rows(part.perm)
        return [XTp.take_rows(np.arange(s * width, (s + 1) * width))
                .transpose() for s in range(m)]
    raise ValueError(f"unknown partition axis {axis!r}")


def build_shard_ell_pairs(shard_csrs: list[CSRMatrix], block_rows: int,
                          block_cols: int, dtype=None, local=None):
    """Per-shard forward + transposed ELLs, stacked with a leading shard
    axis ``m``: returns ``(data, cols, dataT, colsT)``.

    dtype : optional tile dtype (a torch dtype, e.g.
    ``hvp_tile_dtype('bfloat16')``). numpy holds no bf16, so with a
    2-byte dtype ``data`` / ``dataT`` come back as CPU tensors of it
    (rounded to nearest even); with ``torch.float32`` (or None) as numpy
    arrays. ``cols`` / ``colsT`` stay int32 numpy arrays.
    local : a slice of the shards to build (a process of a multi-process
        solve): only those are tiled, at the widths common to all shards
        (:func:`ell_tile_widths`, from the index structure alone), so the
        result is those shards' rows of the whole stack.
    """
    width = width_t = None
    if local is not None:
        widths = [ell_tile_widths(c, block_rows, block_cols)
                  for c in shard_csrs]
        width = max(w for w, _ in widths)
        width_t = max(w for _, w in widths)
        shard_csrs = shard_csrs[local]
    data, cols = stack_shard_ells(shard_csrs, block_rows, block_cols, width)
    dataT, colsT = stack_shard_ells(shard_csrs, block_cols, block_rows,
                                    width_t, transpose=True)
    if dtype is not None and dtype != torch.float32:
        data = torch.from_numpy(data).to(dtype)
        dataT = torch.from_numpy(dataT).to(dtype)
    elif dtype is not None:
        data = data.astype(np.float32, copy=False)
        dataT = dataT.astype(np.float32, copy=False)
    return data, cols, dataT, colsT


# ---------------------------------------------------------------------------
# streaming libsvm reader (bounded memory)
# ---------------------------------------------------------------------------

def truncate_features(fi: np.ndarray, si: np.ndarray, vs: np.ndarray,
                      n_features: int
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Drop COO triplets whose 0-based feature index is ``>= n_features``.

    The single source of the explicit-``n_features`` *truncation*
    semantics every libsvm reader of the port shares
    (:func:`repro_torch.data.libsvm.load_libsvm`, :func:`load_libsvm_sparse`,
    :func:`iter_libsvm_chunks`): a requested feature dimension smaller
    than the max index seen drops the out-of-range features — the
    standard libsvm-reader convention — rather than writing out of the
    intended range. No-op (same arrays back) when nothing is out of
    range.
    """
    keep = fi < n_features
    if bool(keep.all()):
        return fi, si, vs
    return fi[keep], si[keep], vs[keep]


def iter_libsvm_chunks(path: str, chunk_samples: int = 8192,
                       dtype=np.float32, n_features: int | None = None
                       ) -> Iterator[tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray]]:
    """Yield ``(feat_idx, sample_idx, vals, labels)`` COO chunks.

    Feature indices are converted to 0-based. ``sample_idx`` is global
    (monotone across chunks). Peak memory is O(chunk nnz), independent of
    the file size — the building block of :func:`load_libsvm_sparse`.

    An explicit ``n_features`` applies the shared
    :func:`truncate_features` clamp to every chunk (features at index
    ``>= n_features`` are dropped), matching the
    ``load_libsvm`` / ``load_libsvm_sparse`` truncation semantics.
    """
    fi: list[int] = []
    si: list[int] = []
    vs: list[float] = []
    ys: list[float] = []
    base = 0

    def flush():
        f, s, v = (np.asarray(fi, np.int64), np.asarray(si, np.int64),
                   np.asarray(vs, dtype))
        if n_features is not None:
            f, s, v = truncate_features(f, s, v, n_features)
        return f, s, v, np.asarray(ys, dtype)

    n_in_chunk = 0
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            j = base + n_in_chunk
            ys.append(float(parts[0]))
            for tok in parts[1:]:
                idx, val = tok.split(":")
                fi.append(int(idx) - 1)   # libsvm indices are 1-based
                si.append(j)
                vs.append(float(val))
            n_in_chunk += 1
            if n_in_chunk >= chunk_samples:
                yield flush()
                base += n_in_chunk
                n_in_chunk = 0
                fi, si, vs, ys = [], [], [], []
    if n_in_chunk or base == 0:
        yield flush()


def load_libsvm_sparse(path: str, n_features: int | None = None,
                       dtype=np.float32, chunk_samples: int = 8192
                       ) -> tuple[CSRMatrix, np.ndarray]:
    """Streaming libsvm -> (CSRMatrix ``(d, n)``, labels ``(n,)``).

    Reads the file in ``chunk_samples``-sized chunks, accumulating COO
    triplets — peak memory O(nnz + chunk), never the dense ``d * n``.
    Matches :func:`repro_torch.data.libsvm.load_libsvm` semantics via the
    shared :func:`truncate_features` clamp: an explicit ``n_features``
    smaller than the max seen index *truncates* (features beyond the
    range are dropped, per chunk), larger pads with empty features.
    """
    fparts, sparts, vparts, yparts = [], [], [], []
    max_feat = -1
    n = 0
    for fi, si, vs, ys in iter_libsvm_chunks(path, chunk_samples, dtype,
                                             n_features=n_features):
        if len(fi):
            max_feat = max(max_feat, int(fi.max()))
        fparts.append(fi)
        sparts.append(si)
        vparts.append(vs)
        yparts.append(ys)
        n += len(ys)
    fi = np.concatenate(fparts) if fparts else np.zeros(0, np.int64)
    si = np.concatenate(sparts) if sparts else np.zeros(0, np.int64)
    vs = np.concatenate(vparts) if vparts else np.zeros(0, dtype)
    y = np.concatenate(yparts) if yparts else np.zeros(0, dtype)
    d = n_features if n_features is not None else max_feat + 1
    return CSRMatrix.from_coo(fi, si, vs, (d, n), dtype=dtype), y


# ---------------------------------------------------------------------------
# synthetic power-law sparsity (the load-balancing stress regime)
# ---------------------------------------------------------------------------

def make_sparse_glm_data(d: int, n: int, density: float = 0.05,
                         alpha: float = 1.2, beta: float = 0.8,
                         task: str = "classification",
                         seed: int = 0, dtype=np.float32
                         ) -> tuple[CSRMatrix, np.ndarray, np.ndarray]:
    """Sparse GLM data with power-law feature *and* sample popularity.

    Feature ``i`` (0-based rank) appears with probability proportional to
    ``(i + 1)^-alpha``; sample ``j`` scales all of its probabilities by an
    activity ``(j + 1)^-beta``. Both axes normalized so the expected
    overall density is ``density`` — the scale-free structure of text
    datasets (rcv1/news20/splice).

    Returns ``(X_csr (d, n), y (n,), w_true (d,))``.
    """
    rng = np.random.default_rng(seed)
    pop = (np.arange(1, d + 1, dtype=np.float64) ** (-alpha))
    p = pop * (density * d / pop.sum())                    # per-feature prob
    act = (np.arange(1, n + 1, dtype=np.float64) ** (-beta))
    act *= n / act.sum()                                   # mean-1 activity

    rows_l, cols_l = [], []
    for i in range(d):
        hit = np.nonzero(rng.random(n) < np.minimum(p[i] * act, 1.0))[0]
        rows_l.append(np.full(len(hit), i, np.int64))
        cols_l.append(hit.astype(np.int64))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = rng.standard_normal(len(rows)).astype(dtype)
    X = CSRMatrix.from_coo(rows, cols, vals, (d, n), dtype=dtype)

    w_true = (rng.standard_normal(d) / np.sqrt(max(d, 1))).astype(dtype)
    Xd_w = np.zeros(n, np.float64)
    rr = np.repeat(np.arange(d), np.diff(X.indptr))
    np.add.at(Xd_w, X.indices, X.data.astype(np.float64) * w_true[rr])
    margins = Xd_w.astype(dtype)
    if task == "classification":
        scale = max(float(margins.std()), 1e-9)
        prob = 1.0 / (1.0 + np.exp(-margins / scale))
        y = np.where(rng.random(n) < prob, 1.0, -1.0).astype(dtype)
    elif task == "regression":
        y = (margins + 0.1 * rng.standard_normal(n)).astype(dtype)
    else:
        raise ValueError(f"unknown task {task!r}")
    return X, y, w_true
