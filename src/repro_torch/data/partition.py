"""nnz-aware load-balanced partitioning (the paper's title contribution).

DiSCO's per-iteration critical path is gated by the *slowest* shard: every
collective is a barrier, so a shard holding more nonzeros than its peers
stalls the others for the difference. This module assigns equal-count
*blocks* of features or samples to shards, balancing per-shard
**nonzeros** with the capacity-constrained LPT (longest processing time)
greedy, so shard *widths* stay equal and only membership is rebalanced
via a permutation of the indices. The same code as the JAX package's
``repro.data.partition``, so both give identical partitions.

Quality metric (``DiscoResult.partition_info``)::

    imbalance = max_shard_nnz / mean_shard_nnz        # 1.0 is perfect
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.sparse import CSRMatrix


@dataclasses.dataclass(frozen=True)
class Partition:
    """A load-balanced assignment of indices to ``m`` equal-width shards.

    ``perm[k]`` is the original index placed at sharded position ``k``:
    shard ``s`` owns positions ``[s * width, (s+1) * width)`` of the
    permuted axis. ``inv`` is the inverse permutation. Indices
    ``>= n_items`` are synthetic empty slots carrying zero nnz.
    """

    perm: np.ndarray         # (n_padded,) original index per sharded slot
    inv: np.ndarray          # (n_padded,) sharded slot per original index
    shard_nnz: np.ndarray    # (m,) nonzeros per shard
    n_items: int             # real (unpadded) index count
    m: int                   # shard count
    strategy: str            # 'width' | 'lpt'

    @property
    def width(self) -> int:
        """Indices per shard (equal by construction)."""
        return len(self.perm) // self.m

    @property
    def imbalance(self) -> float:
        """max_shard_nnz / mean_shard_nnz; 1.0 is a perfect balance."""
        return imbalance(self.shard_nnz)

    def stats(self) -> dict:
        """Summary dict (what ``DiscoResult.partition_info`` carries)."""
        return dict(strategy=self.strategy, m=self.m,
                    n_items=self.n_items, width=self.width,
                    shard_nnz=self.shard_nnz.tolist(),
                    imbalance=float(self.imbalance))


def imbalance(shard_nnz) -> float:
    """max/mean of per-shard nonzero counts (1.0 = perfectly balanced)."""
    shard_nnz = np.asarray(shard_nnz, np.float64)
    mean = shard_nnz.mean()
    if mean <= 0:
        return 1.0
    return float(shard_nnz.max() / mean)


def _padded_counts(nnz_counts: np.ndarray, m: int, block: int,
                   pad_multiple: int) -> tuple[np.ndarray, int]:
    """Pad the per-index nnz histogram so blocks divide evenly among the
    ``m`` shards AND each shard's width is a multiple of ``pad_multiple``
    (the blocked-ELL tile edge the sharded axis is later cut into)."""
    n = len(nnz_counts)
    unit = m * int(np.lcm(block, max(pad_multiple, 1)))
    n_padded = -(-max(n, 1) // unit) * unit
    padded = np.zeros(n_padded, np.int64)
    padded[:n] = nnz_counts
    return padded, n_padded


def equal_width_partition(nnz_counts, m: int, block: int = 1,
                          pad_multiple: int = 1) -> Partition:
    """Naive contiguous equal-width slicing (the baseline): shard ``s``
    takes indices ``[s * width, (s+1) * width)`` in their original
    order."""
    nnz_counts = np.asarray(nnz_counts, np.int64)
    padded, n_padded = _padded_counts(nnz_counts, m, block, pad_multiple)
    perm = np.arange(n_padded)
    shard_nnz = padded.reshape(m, -1).sum(axis=1)
    return Partition(perm=perm, inv=perm.copy(), shard_nnz=shard_nnz,
                     n_items=len(nnz_counts), m=m, strategy="width")


def _lpt_assign(block_nnz: np.ndarray, m: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """Greedy capacity-constrained LPT over per-block nnz: blocks sorted
    by nnz descending (stable), each placed on the currently lightest
    shard that still has capacity. Returns ``(assign, load)``."""
    n_blocks = len(block_nnz)
    cap = n_blocks // m
    order = np.argsort(-block_nnz, kind="stable")
    load = np.zeros(m, np.int64)
    used = np.zeros(m, np.int64)
    assign = np.empty(n_blocks, np.int64)
    for b in order:
        open_shards = np.nonzero(used < cap)[0]
        s = open_shards[np.argmin(load[open_shards])]
        assign[b] = s
        load[s] += block_nnz[b]
        used[s] += 1
    return assign, load


def _perm_from_assign(assign: np.ndarray, block: int, m: int
                      ) -> np.ndarray:
    """Index permutation realizing a block->shard assignment: shard s's
    blocks in ascending block order, each expanded to its ``block``
    contiguous indices."""
    perm = np.empty(len(assign) * block, np.int64)
    pos = 0
    for s in range(m):
        for b in np.nonzero(assign == s)[0]:
            perm[pos:pos + block] = np.arange(b * block, (b + 1) * block)
            pos += block
    return perm


def lpt_partition(nnz_counts, m: int, block: int = 1,
                  pad_multiple: int = 1) -> Partition:
    """Capacity-constrained LPT: balance shard nnz at equal shard width.

    Indices are grouped into contiguous blocks of ``block``; blocks are
    sorted by nnz descending and greedily assigned to the lightest shard
    that still has capacity (each shard takes exactly ``n_blocks / m``
    blocks).
    """
    nnz_counts = np.asarray(nnz_counts, np.int64)
    padded, n_padded = _padded_counts(nnz_counts, m, block, pad_multiple)
    block_nnz = padded.reshape(-1, block).sum(axis=1)
    assign, load = _lpt_assign(block_nnz, m)
    perm = _perm_from_assign(assign, block, m)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n_padded)
    return Partition(perm=perm, inv=inv, shard_nnz=load,
                     n_items=len(nnz_counts), m=m, strategy="lpt")


def chunk_partition(chunk_nnz, chunk_size: int, n_items: int, m: int,
                    strategy: str = "lpt",
                    chunk_cost=None) -> Partition:
    """Partition fixed-width *chunks* across ``m`` shards from nnz stats.

    ``chunk_nnz`` comes from a :class:`repro_torch.data.store.ShardStore`
    header, so a balanced assignment needs no chunk values. Chunk ``c``
    covers indices ``[c * chunk_size, (c+1) * chunk_size)`` of the chunked
    axis (the last real chunk may be ragged: its tail indices are
    ``>= n_items`` and carry no nnz); the chunk list is padded with empty
    chunks to a multiple of ``m``.

    Gives the same :class:`Partition` as ``lpt_partition(per_index_counts,
    m, block=chunk_size, pad_multiple=p)`` for any ``p`` dividing
    ``chunk_size``. ``chunk_cost`` (optional, ``(n_chunks,)`` nonnegative
    ints) replaces nnz as what the LPT balances (measured per-chunk
    seconds); each shard's chunks are then ordered by descending cost, so
    the expensive chunks of different shards fall in the same schedule
    steps, while ``shard_nnz`` still reports true nonzeros.
    """
    chunk_nnz = np.asarray(chunk_nnz, np.int64)
    n_chunks = len(chunk_nnz)
    n_chunks_padded = -(-max(n_chunks, 1) // m) * m
    block_nnz = np.zeros(n_chunks_padded, np.int64)
    block_nnz[:n_chunks] = chunk_nnz
    if chunk_cost is not None:
        chunk_cost = np.asarray(chunk_cost, np.int64)
        if len(chunk_cost) != n_chunks:
            raise ValueError(
                f"chunk_cost has {len(chunk_cost)} entries for "
                f"{n_chunks} chunks")
        block_cost = np.zeros(n_chunks_padded, np.int64)
        block_cost[:n_chunks] = chunk_cost
    else:
        block_cost = block_nnz
    if strategy == "lpt":
        assign, _ = _lpt_assign(block_cost, m)
        if chunk_cost is None:
            perm = _perm_from_assign(assign, chunk_size, m)
        else:
            # descending cost within a shard; the stable sort keeps
            # ascending ids among equal costs
            perm = np.empty(n_chunks_padded * chunk_size, np.int64)
            pos = 0
            for s in range(m):
                blocks = np.nonzero(assign == s)[0]
                for b in blocks[np.argsort(-block_cost[blocks],
                                           kind="stable")]:
                    perm[pos: pos + chunk_size] = np.arange(
                        b * chunk_size, (b + 1) * chunk_size)
                    pos += chunk_size
        load = np.zeros(m, np.int64)
        np.add.at(load, assign, block_nnz)
    elif strategy == "width":
        perm = np.arange(n_chunks_padded * chunk_size, dtype=np.int64)
        load = block_nnz.reshape(m, -1).sum(axis=1)
    else:
        raise ValueError(f"unknown partition strategy {strategy!r}")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return Partition(perm=perm, inv=inv, shard_nnz=load,
                     n_items=int(n_items), m=m, strategy=strategy)


def make_partition(X: CSRMatrix, axis: str, m: int, strategy: str = "lpt",
                   block: int = 1, pad_multiple: int = 1) -> Partition:
    """Partition a CSR matrix's features or samples across ``m`` shards.

    axis         : 'features' (DiSCO-F: balance nnz per feature row) or
                   'samples' (DiSCO-S: balance nnz per sample column)
    strategy     : 'lpt' (nnz-balanced) | 'width' (equal-width baseline)
    block        : assignment granularity (1 = per index)
    pad_multiple : force each shard's width to this multiple — pass the
                   blocked-ELL tile edge so local tiling never re-pads
    """
    if axis == "features":
        counts = X.nnz_per_row()
    elif axis == "samples":
        counts = X.nnz_per_col()
    else:
        raise ValueError(f"unknown partition axis {axis!r}")
    if strategy == "lpt":
        return lpt_partition(counts, m, block=block,
                             pad_multiple=pad_multiple)
    if strategy == "width":
        return equal_width_partition(counts, m, block=block,
                                     pad_multiple=pad_multiple)
    raise ValueError(f"unknown partition strategy {strategy!r}")
