"""Analytic communication accounting (paper Tables 2-4), classic and
s-step PCG, the HVP's device-memory byte model and the serving cost
models.

Counts the collectives the way the paper does:

  DiSCO-S, per outer iteration : broadcast w_k (d) + reduceAll grad (d)
  DiSCO-S, per PCG iteration   : broadcast u_t (d) + reduceAll H u_t (d)
  DiSCO-F, per outer iteration : reduceAll margins (n) + final reduce v (d_j)
  DiSCO-F, per PCG iteration   : reduceAll (n) + 2 scalar reduceAlls

  DANE  : 2 reduceAll (d) per iteration (gradient, then the averaged
          local solution)
  CoCoA+: 1 reduceAll (d) per outer iteration

``rounds`` is the paper's MPI view; ``spmd_collectives`` counts the
all-reduces an SPMD program runs (a broadcast+reduceAll pair of a
replicated vector is one all-reduce).
"""
from __future__ import annotations

import dataclasses

import numpy as np

BYTES_PER_FLOAT = 4  # f32 throughout


@dataclasses.dataclass
class CommLedger:
    rounds: int = 0          # paper-style rounds (MPI view)
    floats: int = 0          # total vector elements moved through collectives
    spmd_collectives: int = 0

    def add(self, rounds: int, floats: int, spmd: int | None = None):
        self.rounds += rounds
        self.floats += floats
        self.spmd_collectives += spmd if spmd is not None else rounds

    @property
    def bytes(self) -> int:
        return self.floats * BYTES_PER_FLOAT

    def merged(self, other: "CommLedger") -> "CommLedger":
        return CommLedger(self.rounds + other.rounds,
                          self.floats + other.floats,
                          self.spmd_collectives + other.spmd_collectives)


def disco_s_outer_cost(d: int) -> tuple[int, int, int]:
    """(rounds, floats, spmd) for one outer iteration excluding PCG."""
    return 2, 2 * d, 1


def disco_s_pcg_cost(d: int, iters: int) -> tuple[int, int, int]:
    """(rounds, floats, spmd) for ``iters`` classic DiSCO-S PCG
    iterations: per iteration one d-vector broadcast of the probe u_t
    plus one d-vector reduceAll of H u_t (a single SPMD all-reduce)."""
    return 2 * iters, 2 * d * iters, 1 * iters


def disco_f_outer_cost(n: int, d: int, m: int) -> tuple[int, int, int]:
    """(rounds, floats, spmd) for one DiSCO-F outer iteration excluding
    PCG: the margins reduceAll (n floats) + the final "Reduce an R^{d_j}
    vector" of Algorithm 3 line 12 (d floats total). Under SPMD only the
    margins all-reduce materializes."""
    return 2, n + d, 1


def disco_f_pcg_cost(n: int, iters: int) -> tuple[int, int, int]:
    """(rounds, floats, spmd) for ``iters`` classic DiSCO-F PCG
    iterations: one n-vector reduceAll each, plus two scalar reduceAlls
    counted in floats and SPMD collectives but not as vector rounds."""
    return 1 * iters, (n + 2) * iters, 3 * iters


def disco_s_sstep_cost(d: int, s: int, rounds: int) -> tuple[int, int, int]:
    """(rounds, floats, spmd) for ``rounds`` s-step DiSCO-S rounds: per
    round the (d, s+1) trial basis is broadcast and the (d, s+1) batched
    HVP reduced, the pair of one classic iteration carrying s+1 vectors;
    the Gram system is replicated and costs nothing. Under SPMD the pair
    is one all-reduce per round."""
    k = s + 1
    return 2 * rounds, 2 * d * k * rounds, 1 * rounds


def disco_f_sstep_cost(n: int, s: int, rounds: int) -> tuple[int, int, int]:
    """(rounds, floats, spmd) for ``rounds`` s-step DiSCO-F rounds: one
    (n, s) reduceAll of the batched pass A (H p_prev is carried from the
    previous round), plus one small reduceAll of the Gram payload
    (2(s+1)^2 + (s+1) floats), counted in floats and SPMD collectives but
    not as a vector round, as the classic path's scalar reduceAlls."""
    k = s + 1
    return 1 * rounds, (n * s + 2 * k * k + k) * rounds, 2 * rounds


def dane_iter_cost(d: int) -> tuple[int, int, int]:
    """(rounds, floats, spmd) for one DANE iteration: two d-vector
    reduceAlls (gradient, then the averaged local solution)."""
    return 2, 2 * d, 2


def cocoa_iter_cost(d: int) -> tuple[int, int, int]:
    """(rounds, floats, spmd) for one CoCoA+ outer iteration: a single
    d-vector reduceAll of the aggregated local updates."""
    return 1, d, 1


# ---------------------------------------------------------------------------
# load balance and the HVP's device-memory traffic (the reference's
# repro/core/comm.py, numpy only)
#
# Every collective above is a barrier, so a sparse partition moves at the
# pace of its heaviest shard (max shard nnz, not the mean). The HVP is
# memory-bound, so the bytes the data tiles move bound PCG's inner loop:
# the fused one-pass kernels read the tiles once per application instead
# of twice, and bf16 tiles (DiscoConfig.hvp_dtype) halve the bytes of
# each element.
# ---------------------------------------------------------------------------

BYTES_BF16 = 2


def sparse_hvp_flops(nnz: int) -> int:
    """Flops of one sparse HVP application: two passes over the nonzeros
    (X^T u then X (c.*z)), one multiply-add each -> 4 flops/nnz."""
    return 4 * nnz


def hvp_dtype_bytes(hvp_dtype: str) -> int:
    """Bytes per stored tile element for a ``DiscoConfig.hvp_dtype``,
    through :func:`repro_torch.data.sparse.hvp_tile_dtype`, so the model
    and the tile builders accept the same spellings."""
    from repro_torch.data.sparse import hvp_tile_dtype
    return int(hvp_tile_dtype(hvp_dtype).itemsize)


def dense_hvp_bytes(d: int, n: int, s: int = 1, *, fused: bool = False,
                    dtype_bytes: int = BYTES_PER_FLOAT) -> int:
    """X bytes of ONE dense (multi-)HVP application: the two-pass kernels
    read the (d, n) X twice, the fused one once; the s probe vectors share
    each read, so ``s`` does not appear."""
    del s
    passes = 1 if fused else 2
    return passes * d * n * dtype_bytes


def ell_hvp_bytes(tiles_fwd: int, tiles_tr: int, block_rows: int,
                  block_cols: int, *, fused: bool = False,
                  dtype_bytes: int = BYTES_PER_FLOAT) -> int:
    """Blocked-ELL tile bytes of ONE sparse (multi-)HVP application, from
    the tile counts of the forward and transposed layouts: the two-pass
    pair reads both layouts once, the fused kernel only the transposed
    one."""
    tile = block_rows * block_cols * dtype_bytes
    return (tiles_tr if fused else tiles_fwd + tiles_tr) * tile


def straggler_factor(shard_nnz) -> float:
    """max_shard_nnz / mean_shard_nnz: how far barrier collectives stretch
    the compute phase of a skewed partition (1.0 is a perfect balance)."""
    shard_nnz = np.asarray(shard_nnz, np.float64)
    mean = shard_nnz.mean()
    return float(shard_nnz.max() / mean) if mean > 0 else 1.0


def disco_sparse_iter_time(shard_nnz, pcg_iters: int, partition: str,
                           n: int, d: int, m: int, s: int = 1, *,
                           flops_per_sec: float = 5e11,
                           bytes_per_sec: float = 1e10,
                           latency_s: float = 5e-6,
                           hvp_fused: bool = False,
                           hvp_dtype_bytes: int = BYTES_PER_FLOAT,
                           hbm_bytes_per_sec: float = 8e11) -> dict:
    """Modeled seconds for ONE Newton iteration on a sparse partition.

    compute: (pcg_iters * s + 1) HVP applications, each the heavier of
    its flops (:func:`sparse_hvp_flops`) and the value bytes its tile
    stream moves on the heaviest shard (one pass over the nonzeros when
    ``hvp_fused``, two otherwise, at ``hvp_dtype_bytes`` an element);
    comm: the (rounds, floats) of the matching cost function above,
    ``latency_s`` a round plus wire time. The default rates are the
    reference's model constants, not measured ones. Returns
    ``compute_s``, ``hvp_bytes`` (per application), ``comm_s``,
    ``total_s`` and ``straggler``.
    """
    shard_nnz = np.asarray(shard_nnz, np.float64)
    max_nnz = float(shard_nnz.max()) if len(shard_nnz) else 0.0

    if partition == "features":
        r1, f1, _ = disco_f_outer_cost(n, d, m)
        if s > 1:
            r2, f2, _ = disco_f_sstep_cost(n, s, pcg_iters)
        else:
            r2, f2, _ = disco_f_pcg_cost(n, pcg_iters)
    elif partition == "samples":
        r1, f1, _ = disco_s_outer_cost(d)
        if s > 1:
            r2, f2, _ = disco_s_sstep_cost(d, s, pcg_iters)
        else:
            r2, f2, _ = disco_s_pcg_cost(d, pcg_iters)
    else:
        raise ValueError(f"unknown partition {partition!r}")

    hvp_apps = pcg_iters * max(s, 1) + 1
    hvp_bytes = (1 if hvp_fused else 2) * max_nnz * hvp_dtype_bytes
    per_app = max(sparse_hvp_flops(int(max_nnz)) / flops_per_sec,
                  hvp_bytes / hbm_bytes_per_sec)
    compute_s = hvp_apps * per_app
    comm_s = (r1 + r2) * latency_s \
        + (f1 + f2) * BYTES_PER_FLOAT / bytes_per_sec
    return dict(compute_s=compute_s, hvp_bytes=hvp_bytes, comm_s=comm_s,
                total_s=compute_s + comm_s,
                straggler=straggler_factor(shard_nnz))


# ---------------------------------------------------------------------------
# out-of-core streaming extension: every HVP re-reads the shard's chunks,
# and a prefetch pipeline overlaps that I/O with the kernels, so a step
# pays max(io, compute), not their sum, plus a fill of prefetch_depth
# chunks at the head of each pass
# ---------------------------------------------------------------------------

STREAM_BYTES_PER_NNZ = 8  # stored CSR chunk payload: 4B value + 4B index


def streaming_data_passes(partition: str, pcg_iters: int, s: int = 1) -> int:
    """Full passes over the on-disk shard data for ONE Newton iteration.

    DiSCO-S sample chunks complete both HVP directions per chunk (one
    pass per HVP application; the s-step basis operator is the resident
    tau-sample estimate and reads no chunk); DiSCO-F feature chunks must
    finish pass A (the n-vector) before pass B starts (two passes per
    operator application, each of the ``s - 1`` streamed basis products
    of an s-step round included). The margins and the gradient of the
    outer step add 2 passes.
    """
    if partition == "features":
        per_round = 2 * max(s, 1)            # 2(s-1) basis + 2 true HVP
        return 2 + pcg_iters * per_round
    if partition == "samples":
        return 2 + pcg_iters
    raise ValueError(f"unknown partition {partition!r}")


def disco_streaming_iter_time(shard_nnz, pcg_iters: int, partition: str,
                              n: int, d: int, m: int, s: int = 1, *,
                              chunk_nnz_max: int, prefetch_depth: int = 2,
                              flops_per_sec: float = 5e11,
                              bytes_per_sec: float = 1e10,
                              latency_s: float = 5e-6,
                              disk_bytes_per_sec: float = 2e9,
                              hvp_fused: bool = False,
                              hvp_dtype_bytes: int = BYTES_PER_FLOAT,
                              hbm_bytes_per_sec: float = 8e11) -> dict:
    """Modeled seconds for ONE Newton iteration of a *streamed* solve.

    :func:`disco_sparse_iter_time` plus the I/O plane: every data pass
    re-reads the heaviest shard's chunk bytes from disk
    (``STREAM_BYTES_PER_NNZ`` a nonzero), and the streamed phase costs
    ``max(io_s, compute_s)`` plus a fill of ``prefetch_depth`` chunks a
    pass. Disk bytes do not depend on the ``hvp_*`` levers (chunks are
    stored f32 CSR). The default rates are the reference's model
    constants, not measured ones.

    Returns ``io_s``, ``compute_s``, ``comm_s``, ``fill_s``,
    ``data_passes``, the overlapped ``total_s``, the serial
    ``total_no_overlap_s``, ``overlap_savings_s`` and ``straggler``.
    """
    base = disco_sparse_iter_time(
        shard_nnz, pcg_iters, partition, n=n, d=d, m=m, s=s,
        flops_per_sec=flops_per_sec, bytes_per_sec=bytes_per_sec,
        latency_s=latency_s, hvp_fused=hvp_fused,
        hvp_dtype_bytes=hvp_dtype_bytes,
        hbm_bytes_per_sec=hbm_bytes_per_sec)
    shard_nnz = np.asarray(shard_nnz, np.float64)
    max_nnz = float(shard_nnz.max()) if len(shard_nnz) else 0.0
    passes = streaming_data_passes(partition, pcg_iters, s)
    io_s = passes * max_nnz * STREAM_BYTES_PER_NNZ / disk_bytes_per_sec
    fill_s = passes * prefetch_depth * chunk_nnz_max \
        * STREAM_BYTES_PER_NNZ / disk_bytes_per_sec
    compute_s, comm_s = base["compute_s"], base["comm_s"]
    total = comm_s + max(io_s, compute_s) + fill_s
    total_naive = comm_s + io_s + compute_s + fill_s
    return dict(io_s=io_s, compute_s=compute_s, comm_s=comm_s,
                fill_s=fill_s, data_passes=passes, total_s=total,
                total_no_overlap_s=total_naive,
                overlap_savings_s=total_naive - total,
                straggler=base["straggler"])


# ---------------------------------------------------------------------------
# online serving (repro_torch.glm_serve)
#
# A scoring tick runs ONE kernel launch for the whole micro-batch, whose
# fixed cost dwarfs the per-request sparse dot product: sequential
# single-request scoring is dispatch-bound and micro-batching B requests
# amortizes the dispatch over B. The constants below are the model's
# parameters, copied from ``repro.core.comm``; they are not measurements
# of any device.
# ---------------------------------------------------------------------------

def scoring_flops(nnz: int) -> int:
    """Flops of scoring stored request nonzeros: one multiply-add per
    nonzero of the packed request batch (margins only; the loss link is
    O(batch))."""
    return 2 * nnz


def glm_serving_tick_time(batch: int, nnz_per_req: float, *,
                          ell_width: int, block_b: int, block_d: int,
                          dispatch_s: float = 2e-4,
                          flops_per_sec: float = 5e11,
                          bytes_per_sec: float = 1e10) -> dict:
    """Modeled seconds for ONE micro-batched scoring tick of ``batch``
    requests (``repro.core.comm.glm_serving_tick_time``).

    Three terms: the fixed per-tick ``dispatch_s``, paid once a tick
    whatever the batch; wire time for staging the *padded* tile stream
    (``ceil(batch / block_b) * ell_width`` tiles of ``block_b * block_d``
    f32 values) at ``bytes_per_sec``; and compute time for the useful flops
    (:func:`scoring_flops` over ``batch * nnz_per_req`` nonzeros) at
    ``flops_per_sec``. The defaults are the model's parameters, not a
    card's figures.

    Returns a dict with ``dispatch_s``, ``stage_s``, ``compute_s``,
    ``total_s`` and ``per_request_s``.
    """
    n_row_blocks = -(-max(batch, 1) // block_b)
    tile_bytes = n_row_blocks * ell_width * block_b * block_d \
        * BYTES_PER_FLOAT
    stage_s = tile_bytes / bytes_per_sec
    compute_s = scoring_flops(int(batch * nnz_per_req)) / flops_per_sec
    total = dispatch_s + stage_s + compute_s
    return dict(dispatch_s=dispatch_s, stage_s=stage_s,
                compute_s=compute_s, total_s=total,
                per_request_s=total / max(batch, 1))


def glm_serving_throughput(batch: int, nnz_per_req: float, *,
                           ell_width: int, block_b: int, block_d: int,
                           dispatch_s: float = 2e-4,
                           flops_per_sec: float = 5e11,
                           bytes_per_sec: float = 1e10) -> dict:
    """Modeled requests/second of micro-batched against sequential scoring
    (``repro.core.comm.glm_serving_throughput``).

    ``batched_rps`` runs ticks of ``batch`` requests; ``sequential_rps``
    batch-1 ticks (one dispatch a request). Their ratio ``speedup``
    approaches ``dispatch_s / per_request_work`` as requests shrink.
    """
    tick = glm_serving_tick_time(
        batch, nnz_per_req, ell_width=ell_width, block_b=block_b,
        block_d=block_d, dispatch_s=dispatch_s,
        flops_per_sec=flops_per_sec, bytes_per_sec=bytes_per_sec)
    single = glm_serving_tick_time(
        1, nnz_per_req, ell_width=ell_width, block_b=block_b,
        block_d=block_d, dispatch_s=dispatch_s,
        flops_per_sec=flops_per_sec, bytes_per_sec=bytes_per_sec)
    batched_rps = batch / tick["total_s"]
    sequential_rps = 1.0 / single["total_s"]
    return dict(batched_rps=batched_rps, sequential_rps=sequential_rps,
                speedup=batched_rps / sequential_rps,
                tick_s=tick["total_s"])


def elastic_replan_model(chunk_seconds, schedule_before, schedule_after,
                         passes_remaining: int,
                         replan_overhead_s: float = 0.0) -> dict:
    """Modeled wall-clock of finishing a solve with vs without a re-plan
    (the reference's ``repro.core.comm.elastic_replan_model``).

    One pass of a schedule costs ``sum_t max_s chunk_seconds``
    (:func:`repro_torch.robust.straggler.barrier_seconds`: every
    collective waits for the slowest shard), so ``passes_remaining``
    passes cost that much each, and the re-planned variant pays
    ``replan_overhead_s`` once (no chunk data moves).

    Returns ``static_s`` (keep the old schedule), ``replanned_s``
    (overhead + new-schedule passes), ``gain`` (static / replanned; > 1
    means the re-plan pays) and ``break_even_passes`` (``inf`` when the
    new schedule is no faster).
    """
    from repro_torch.robust.straggler import barrier_seconds

    cs = np.asarray(chunk_seconds, np.float64)
    before = barrier_seconds(np.asarray(schedule_before), cs)
    after = barrier_seconds(np.asarray(schedule_after), cs)
    static_s = before * passes_remaining
    replanned_s = replan_overhead_s + after * passes_remaining
    per_pass_gain = before - after
    break_even = (replan_overhead_s / per_pass_gain
                  if per_pass_gain > 0 else float("inf"))
    return dict(static_s=float(static_s),
                replanned_s=float(replanned_s),
                gain=float(static_s / replanned_s) if replanned_s > 0
                else float("inf"),
                break_even_passes=float(break_even))
