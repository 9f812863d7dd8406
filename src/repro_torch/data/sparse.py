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
* :func:`make_sparse_glm_data` — synthetic power-law-sparsity GLM data.

On the device a shard's pair of layouts (forward for ``X @ v``, transposed
for ``X^T u``) travels as the :class:`EllPair` of four tensors.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

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


def ell_from_csr(csr: CSRMatrix, block_rows: int, block_cols: int,
                 width: int | None = None) -> BlockedEll:
    """Cut ``csr`` into tiles and keep only the nonempty ones.

    ``width`` pads the per-row-block tile lists to a fixed fan-out (>= the
    natural max). Zero-width matrices get ``width=1`` of zero tiles so the
    kernels always have a (no-op) tile to stream.
    """
    d, n = csr.shape
    br, bc = block_rows, block_cols
    nrb, ncb = -(-d // br), max(-(-n // bc), 1)
    rows = np.repeat(np.arange(d), np.diff(csr.indptr))
    rb, cb = rows // br, csr.indices // bc

    # per row-block: sorted unique column-blocks
    tile_ids = rb.astype(np.int64) * ncb + cb
    uniq = np.unique(tile_ids)
    urb, ucb = uniq // ncb, uniq % ncb
    per_block = np.bincount(urb, minlength=nrb)
    natural = int(per_block.max()) if len(uniq) else 0
    w = max(width or 0, natural, 1)
    if width is not None and width < natural:
        raise ValueError(f"width {width} < natural max width {natural}")

    data = np.zeros((nrb, w, br, bc), csr.data.dtype)
    cols = np.zeros((nrb, w), np.int32)
    # slot of each unique tile within its row-block (uniq is sorted, so
    # tiles of one row-block occupy a contiguous run starting at starts[r])
    starts = np.zeros(nrb + 1, np.int64)
    np.cumsum(per_block, out=starts[1:])
    cols[urb, np.arange(len(uniq)) - starts[urb]] = ucb.astype(np.int32)

    # scatter nonzeros into their tiles
    slot = np.searchsorted(uniq, tile_ids) - starts[rb]
    data[rb, slot, rows % br, csr.indices % bc] = csr.data
    return BlockedEll(data=data, cols=cols, shape=(d, n), block=(br, bc))


def hvp_tile_dtype(name: str) -> np.dtype:
    """Resolve ``DiscoConfig.hvp_dtype`` to the tile dtype.

    Only 'float32' is ported; 'bfloat16' tiles raise until their kernels
    land."""
    if name in ("float32", "f32"):
        return np.dtype(np.float32)
    if name in ("bfloat16", "bf16"):
        raise NotImplementedError(
            "bfloat16 HVP tiles are not yet ported to repro_torch "
            "(use hvp_dtype='float32')")
    raise ValueError(f"unknown hvp_dtype {name!r} "
                     "(expected 'float32' or 'bfloat16')")


class EllPair(NamedTuple):
    """Device-side sparse shard operand: four tensors of one shard.

    ``data/cols`` hold the forward blocked-ELL layout of the local shard
    (drives ``X @ v``); ``dataT/colsT`` the transposed layout (drives
    ``X^T u``). Vector lengths are the *padded* dims: ``X @ v`` maps
    ``(ncb*bc,) -> (nrb*br,)`` and ``X^T u`` the reverse.
    """

    data: torch.Tensor    # (nrb, W, br, bc)
    cols: torch.Tensor    # (nrb, W) int32
    dataT: torch.Tensor   # (ncb, WT, bc, br)
    colsT: torch.Tensor   # (ncb, WT) int32

    @property
    def padded_shape(self) -> tuple[int, int]:
        """(rows, cols) of the padded local operand."""
        nrb, _, br, _ = self.data.shape
        ncb, _, bc, _ = self.dataT.shape
        return nrb * br, ncb * bc


def stack_shard_ells(ells: list[BlockedEll]
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Stack per-shard ELLs into uniform ``(m, ...)`` arrays.

    Every shard is padded to the *global* max ELL width (zero tiles,
    ``cols = 0``). Filled into one preallocated array rather than padded
    and stacked, so a layout of several GB is copied once.
    """
    W = max(e.width for e in ells)
    nb, _, br, bc = ells[0].data.shape
    data = np.zeros((len(ells), nb, W, br, bc), ells[0].data.dtype)
    cols = np.zeros((len(ells), nb, W), ells[0].cols.dtype)
    for s, e in enumerate(ells):
        data[s, :, :e.width] = e.data
        cols[s, :, :e.width] = e.cols
    return data, cols


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
                          block_cols: int
                          ) -> tuple[np.ndarray, np.ndarray,
                                     np.ndarray, np.ndarray]:
    """Per-shard forward + transposed ELLs, stacked with a leading shard
    axis ``m``: returns ``(data, cols, dataT, colsT)``."""
    fwd = [ell_from_csr(c, block_rows, block_cols) for c in shard_csrs]
    data, cols = stack_shard_ells(fwd)
    del fwd
    tr = [ell_from_csr(c.transpose(), block_cols, block_rows)
          for c in shard_csrs]
    dataT, colsT = stack_shard_ells(tr)
    return data, cols, dataT, colsT


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
