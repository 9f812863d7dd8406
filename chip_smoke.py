#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Usage, from the repository root on a machine with one Hopper card:

    python3 chip_smoke.py

Eight phases; any failed check makes the exit code nonzero.

1. Build: compiles the twenty-one hand-written CUDA kernels from
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` (one process per source,
   all at once: the eleven, and the bf16-tile instances of K1, K2, K6,
   K7, K3, K4, K8, K9, K5 and K10) and prints the card's name and power
   limit.
2. Kernels: holds each kernel against its plain PyTorch version on the
   card (relative L2 error <= 1e-5 in f32): ``ell_mv`` and ``ell_hvp`` at
   8x8, 16x16 and 128x128 tiles on layouts with padding slots; ``xt_u``,
   ``x_cz`` and ``x_c_xt_u`` at ragged dense shapes and every cluster
   size its fit rule allows;
   each with and without the scale ``c``; the multi-vector ``ell_mm``,
   ``ell_hvp_mm`` (also against the two-pass ``ell_mm`` pair),
   ``xt_multi``, ``x_cz_multi`` and the fused ``x_c_xt_multi`` (on every
   cluster size, also against ``x_c_xt_u`` column by column and against
   the ``xt_multi`` + ``x_cz_multi`` pair) at s = 1, 2, 4, 5 and 8
   columns, on contiguous and strided blocks; ``ell_mv`` and ``ell_mm``
   on layouts at the edges of their live-tile schedule (W = 300 on 3
   row-blocks, one full row-block among empty ones, W = 1, 256 x 32 and
   32 x 256 tiles, 12 x 6 tiles on the direct path), with and without
   the schedule, each call repeated bit for bit, and with NaN in the
   padding, which the scheduled calls must not read; ``ell_hvp`` and
   ``ell_hvp_mm`` on the same layouts taken as transposed layouts, with
   their step schedule at the default step_bytes, at one below every
   row-block and at one above the whole layout, and without one, at s in
   1, 2, 4, 5 and 8 on contiguous and strided U, with and without c,
   against their plain versions and the two-pass ``ell_mv`` / ``ell_mm``
   pair, with NaN in the padding; the same for the bf16 instances
   (``ell_mv_bf16``, ``ell_mm_bf16``, ``ell_hvp_bf16``,
   ``ell_hvp_mm_bf16``) on bf16 copies of those layouts against the
   plain versions at bf16 tiles (<= 1e-5: the products are exact in
   f32), the fused ones in two halves (their hand-off ``c .* z`` rounded
   to bf16, ties within the f32 summation error bound aside, F11; the
   output against the plain pass B of the kernel's own hand-off and
   against the two-pass bf16 pair's); the bf16 dense instances
   (``xt_u_bf16``, ``x_cz_bf16``, ``xt_multi_bf16``, ``x_cz_multi_bf16``)
   at the dense shapes on bf16 X as whole rows, column views at offsets
   1 and 8 and rows of a stride not a multiple of 8 (both copy paths),
   against their plain versions at bf16 (<= 1e-5), each repeated bit for
   bit, K8 and K9 at s = 1, 2, 4, 5, 8 and 13; the bf16 one-pass
   instances (``x_c_xt_u_bf16``, ``x_c_xt_multi_bf16``) on the same views,
   on every cluster size their fit rule allows, K10 at s = 1, 2, 4, 5 and
   8 on contiguous and strided U, with and without c, each call in two
   halves (the hand-off against the plain one's and the two-pass bf16
   pair's rounding, values within the f32 summation slack aside; the
   output against the plain and the pair's pass B of the kernel's own
   hand-off, <= 1e-5), repeated bit for bit; K8 ``xt_multi`` and K9
   ``x_cz_multi`` at both tile types (``csrc/dense_multi.cuh``) at the
   dense shapes as whole rows, column views at offsets 1, 4 and 8 and
   rows of a stride not a multiple of 8, at s = 1 .. 8 and 13 on
   contiguous and strided blocks, K9 with and without c, on the card's
   CTA count and on 3 and 1,000 CTAs, each call repeated bit for bit on
   the copy path ``glm_hvp.dense_path(X)`` predicts (the ptxas report of
   their instances, registers and spills by path and s, is printed after
   the build); ``flash_attention`` (K11)
   in f32 (<= 1e-5) and bf16 (<= 1e-2 against the plain version in f32
   on the same bf16 inputs, and at most 1.5x the error of the plain
   output's bf16 rounding alone) over GQA groups 1, 2, 4, 5 and 16,
   ragged S, S != T with ``kv_len`` < T, causal, non-causal and windows,
   head_dim 32, 64 and 128, S and T at the bf16 kernel's tile edges (127,
   128, 129, 257), each on contiguous inputs, on transposed (B, S, H, Dh)
   views and on views cut from wider rows, each call repeated bit for
   bit; and in bf16 at the MoE prefills' calls as the model passes them
   (qwen3-moe-30b-a3b: 2 x 32 heads over 4 KV heads x 4,096 tokens,
   causal; mixtral-8x7b: 1 x 32 over 8 x 8,192 through its window of
   4,096). The s-step Gram solve is
   timed on the card and on the CPU. Then small solves on the card against
   the same solves on the CPU: sparse and dense, classic and s-step (fused
   dense s-step included), a λ-path and softmax; checkpoints written on
   the card (DiSCO-S m = 1 and DiSCO-F m = 4 sparse, DiSCO-S dense,
   killed at step 2) resumed on the CPU to the CPU's uninterrupted
   solve; small bf16 sparse
   solves (``hvp_dtype='bfloat16'``: DiSCO-S m = 1 two-pass and fused,
   DiSCO-F m = 2 and a fused s-step, card against CPU within relative L2
   3e-4, F11); small bf16 dense solves (DiSCO-S m = 1, DiSCO-F m = 2, an
   s-step and the plain layout, and fused: DiSCO-S m = 1 and 2, a DiSCO-F
   s-step and DiSCO-F m = 2, the same limit); and the paper's
   comparisons: the original DiSCO (``precond='sag'``, DiSCO-S) sparse
   and dense at m = 1 and 4 and one s-step solve, Hessian subsampling
   (frac 0.5, the same masks on both) on both partitions, sparse and
   dense, at m = 1 and 4, and GD, DANE and CoCoA+ (logistic and
   quadratic) at m = 1 and 4.
3. Sparse slice: ``disco_fit`` at the shape of LIBSVM rcv1.binary's
   training split (d = 47,236 features, n = 20,242 samples, about 1.5 M
   nonzeros, synthetic power-law data from a seed): DiSCO-S and DiSCO-F
   at m = 1 and m = 4 shards, two-pass, plus the fused HVP for both at
   m = 1. On the first run's layouts ``ell_mv``, ``ell_hvp``, ``ell_mm``
   and ``ell_hvp_mm`` (at s = 5, the columns of a DiSCO-S round at
   ``pcg_block_s = 4``) are timed beside their plain versions and
   PyTorch's block-sparse (BSR) product (``ell_mv`` and ``ell_mm`` on the
   transposed layout too, with the solver's schedules as the main path
   passes them; their copy path, the tiles stored, nonempty and live,
   and their times with every slot live and with twice the CTAs;
   ``ell_hvp`` and ``ell_hvp_mm`` with the solver's step schedule, their
   share of bound and GB/s over the live bytes, beside the two-pass pair
   and two variants of the schedule: one step over the whole layout and
   half the step_bytes), and held against the plain versions (the fused
   kernels also against the two-pass pair) at full width. On the first
   run's solver, trace and checkpoint: a traced fit (``repro_torch.obs``)
   gives the untraced ``w`` bit for bit with the same launches and host
   syncs, ``comm.rounds`` equal to ``CommLedger.rounds``, one
   ``newton.outer`` span a step within its ``iter_s`` and a Chrome trace
   that reads back; a fit killed at step 3 (``solver._faults``) resumes
   from its checkpoints within rel. 1e-7 of the uninterrupted ``w`` with
   the same history and ledger (lines ``trace-ckpt``: the median
   ``iter_s`` traced and untraced, ``ckpt.write`` ms, the trace's
   events); the slice's CSR goes through a ``ShardStore`` (chunks of
   4,096 samples), is read back exact with checksums on, and a solve
   from it gives the in-memory ``w`` bit for bit (line ``store``: MB/s
   written and read). A second fit of the first run is profiled. Then
   five bf16 runs
   (``hvp_dtype='bfloat16'``): DiSCO-S and DiSCO-F m = 1 two-pass,
   DiSCO-S m = 1 fused, and DiSCO-S m = 1 s-step (s = 4) two-pass and
   fused, each held to the launches the code predicts (the f32 ``ell_mv``
   only for the margins and the gradient), f falling every step and the
   f32 m = 1 two-pass ``w`` of its partition (<= 1e-4); on the first
   run's bf16 copies the four bf16 instances are held to their plain
   versions and timed beside them, the f32 kernels of the same call, a
   bf16 BSR product where the card's torch has one and the bound at
   2-byte tiles.
   Then four s-step runs (``pcg_block_s = 4``): DiSCO-S and DiSCO-F at
   m = 1 two-pass, DiSCO-S m = 1 fused and DiSCO-F m = 4 two-pass, each
   held to the launches the code predicts, the classic convergence check
   and the classic m = 1 ``w``; the first is profiled. Then the original
   DiSCO (SAG, sag_epochs = 5, tau = 100) on DiSCO-S at m = 1 and 4, 2
   Newton steps (f falling every step, the gradient norm falling, the
   predicted launches; one SAG application timed: ms, launches, device
   time), and DiSCO-F with ``hessian_subsample`` 0.5 and 0.0625 at
   m = 1 and 4, 2 steps (finite, one mask a step of the right shape and
   mean, the predicted launches; f printed; the first profiled). Right
   after the first run (DiSCO-S m = 1), whose in-memory solver its m = 1
   twins re-target, the streamed (out-of-core) solve (lines ``stream
   ...``): the slice written as two stores of 1,024-index chunks
   (samples and features); every chunk's tiles assembled on the card
   against ``ell_from_csr`` bit for bit (f32, both layouts; bf16 the
   cast); ``DiscoSolver.from_store`` at 2 Newton steps, DiSCO-S m = 1
   two-pass f32 (K1), fused bf16 (K2 bf16), s-step (s = 4) two-pass
   (K6) and fused (K7), DiSCO-F m = 4 (K1), each against its in-memory
   twin (partition_info equal to the partitioner's at
   ``partition_block = 1024``, the first step's gradient norm and f
   within 1e-6, w within its run's limit, 1e-4 and equal rounds for
   s-step, 5e-3 fused bf16, 1e-2 classic: the sum order moves classic
   PCG at lam = 1e-4 by a few 1e-3) and the byte bounds; the DiSCO-S
   two-pass stream bit for bit the in-memory solve with one shard a
   chunk, with no more host syncs; the fused bf16 stream under 0.75x the
   f32 stream's bytes; transient read faults on the s-step stream
   retried bit for bit, a kill and resume, an elastic re-plan against
   the static plan (one step); one timed pass of each HVP stream (host,
   staged bytes, device, wait), two with no chunk plan kept, and a
   profiled streamed Newton step. Right after the slice, the GLM serving
   plane (``serve_glm_phase``, lines ``serve-glm ...``) on the first
   run's model: 8,192 held-out requests of the slice's generator (seed
   1, about 76 nonzeros each); K1 at the scoring tiles (8 x 128) on
   micro-batches of 1, 7, 64 and 1,024 requests, f32 and bf16, the
   card's pack against the host's bit for bit, with the plan's schedule
   and without against the plain version, repeated bit for bit, NaN in
   the padding, timed beside its bound and a ``torch.sparse_csr_tensor``
   product; the fit published to a ``ModelRegistry`` and loaded back bit
   for bit; every request through ``ScoringEngine`` against
   ``oracle_margins`` (1e-5 f32, 2e-2 bf16 of the largest margin) and
   against the CPU engine (1e-6), predict / predict_proba against
   ``GLMProblem``'s; one host sync a tick; the scheduler over all of
   them at bf16, and at f32 with every eighth past a deadline of 0 s and a
   second version published mid-stream and served from the next tick,
   traced; a warm streamed
   refit of the 4,096-chunk store grown by n/16 samples, bit for bit the
   in-memory solve whose shards are the chunks; ``refit_path`` over the
   λ grid with 4,096 validation samples; and bench_serving's
   warm-against-cold gate on its own small problem. Between the slice's
   runs and the serving plane, the multi-process solve (``dist_phase``,
   lines ``dist ...``): the slice's CSR written once, then
   ``repro_torch.parallel.launch.spawn`` runs on four gloo ranks sharing
   the card (one shard a rank, payloads staged through pinned host
   buffers) DiSCO-S and DiSCO-F at m = 4 in memory (cut to their first 4
   Newton steps), softmax K = 10 DiSCO-S and DiSCO-F at m = 4 on the
   dense slice's recipe drawn chunk by chunk (each rank draws its own
   block; 2 Newton steps), the streamed DiSCO-F and DiSCO-S at m = 4 and
   the fused bf16 DiSCO-S (each rank streaming its shard's chunks; 2
   steps) and the streamed DiSCO-S killed at step 1; on one NCCL rank
   DiSCO-S m = 1 in memory and softmax; after the serving plane
   (``dist_resume_phase``) four new ranks resume the killed run and run
   a one-step warm refit of the serving plane's grown store. Every rank's
   ``w``, history, ledger and partition info must equal its one-process
   twin bit for bit (the slice's runs refit to 4 steps, the stream
   phase's DiSCO-F m = 4 run, the others made in the phase; the fused
   bf16 ranks, whose K2 atomics order their sums run by run, within
   5e-3 of the f32 twin), every rank the same, each rank must launch its
   path's kernels (their launches join the kernels line's), a streamed
   rank's bytes one shard's; printed per run: the ranks' set-up and fit
   seconds beside the one-process run's, the group's vector and scalar
   all-reduces, floats and staged bytes, the seconds inside collectives
   and their share of the fit, host syncs, and for the streamed runs each
   rank's loaded and peak bytes beside the one-process run's. Four
   ranks on one card measure process overhead and host staging, not a
   cluster; multi-card NCCL is not measured.
4. Dense slice: ``disco_fit(use_kernel=True)`` at d = 4,096, n = 262,144
   f32 (X is 4 GiB: the per-card shard of the repository's pod-scale dense
   problem, the full sample axis), data made on the card by the
   ``make_glm_data`` recipe from a seed; the same six runs. At full width
   ``xt_u``, ``x_cz`` and ``x_c_xt_u`` are held against their plain
   versions and timed beside them and beside ``torch.mv`` (``xt_u`` and
   ``x_cz`` also on the DiSCO-S m = 4 column view ``X[:, :n/4]`` and the
   DiSCO-F m = 4 row block ``X[:d/4]``, each repeated bit for bit on the
   bulk-copy path), and so are
   ``xt_multi``, ``x_cz_multi`` and ``x_c_xt_multi`` at s = 5 beside
   ``torch.matmul`` (``x_c_xt_multi`` also beside the kernel pair);
   ``x_c_xt_u`` at the three shapes and ``x_c_xt_multi`` at the first two
   are timed beside the two-pass kernel pairs they fuse and the library
   pairs, each repeated bit for bit on the TMA path, with its plan (Q,
   bn, stages) and cluster count C; the first run's solver is traced,
   killed at step 3 and resumed as on the sparse slice; a
   second fit of the first run is profiled. Every Newton step must
   decrease f, and m = 4 and fused runs must end at the m = 1 two-pass
   ``w``. Then six s-step runs: DiSCO-S and DiSCO-F at m = 1 two-pass,
   DiSCO-F m = 4 fused (its basis operator on ``x_c_xt_u``), and the
   fused rounds on ``x_c_xt_multi``: DiSCO-S at m = 1 and m = 4, DiSCO-F
   at m = 1; with the same checks. On a bf16 copy of X the four bf16
   dense instances are held to their plain versions and timed at the full
   width and both m = 4 shard shapes (K8 and K9 at s = 5, and 8 and 13 at
   the full width) beside the plain versions, ``torch.mv`` / ``@`` on the
   bf16 X and the f32 kernels of the same call; K8 and K9 at both types
   are held and timed at the full width at s = 1, 2, 4, 5, 8 and 13 and at
   both shard shapes at s = 5 and 8 beside their bound, the cuBLAS call
   of the same type and the plain version (lines ``multi grid ...``); so
   are the bf16 K5 (full
   width and both shard shapes) and K10 (s = 5 and 8 at the full width,
   s = 5 at both shard shapes), each held in its two halves, beside its
   bound, the bf16 two-pass kernel pair, the ``torch.mv`` pair on the
   bf16 X, the plain version and the f32 kernel.
5. Workloads on the dense slice's X: a warm λ-path (λ = 1e-2, 1e-3,
   1e-4; fused s-step DiSCO-S, scored on 32,768 held-out samples of the
   same model), multinomial softmax with K = 10 classes (DiSCO-S m = 1
   and DiSCO-F m = 4, classic and s-step), and Poisson and Huber
   regression (fused DiSCO-S); each held to its predicted launches or
   its convergence, and the λ-path's last point to the classic ``w``;
   GD and DANE at m = 1 and 4 (ms per outer iteration, rounds, the
   gradient norm falling). Then at ``hvp_dtype='bfloat16'``: softmax K = 10
   (DiSCO-S m = 1), DiSCO-S and DiSCO-F m = 1, DiSCO-S m = 4, an s-step
   (s = 4) and a ``use_kernel=False`` run, and a warm two-pass λ-path,
   each held to the launches the code predicts (PCG on the bf16
   instances, no f32 dense kernel), f falling and the f32 run's w or W
   (<= 1e-4). Then fused at bf16 (the one-pass K5 and K10): DiSCO-S and
   DiSCO-F m = 1, DiSCO-S m = 4 and a DiSCO-S s-step (s = 4), each held
   to its predicted launches, f falling, the f32 fused run's and the
   bf16 two-pass run's w (<= 1e-4) and PCG iterations within 10% of the
   f32 fused run's; and a warm fused s-step λ-path on K5 + K10, its
   endpoint at the f32 fused and the bf16 two-pass paths' (<= 1e-4).
   Then Figure 3 on ``make_regime('rcv1_like')``
   (m = 4, logistic): DiSCO-F, DiSCO-S and the original DiSCO on the
   dense kernels, DANE, and CoCoA+ (2 outer iterations), each's
   gradient norm and rounds per iteration, and CoCoA+'s launches per
   outer step.
6. Flash attention timed: K11 at olmo-1b's call in a 4 x 4,096-token
   prefill, ``(4, 16, 4096, 128)`` causal in bf16 (contiguous, and on the
   head-major views the model passes) and in f32, at
   ``prefill_32k``'s length ``(1, 16, 32768, 128)`` bf16 (3 reps; no
   plain version: its scores would take 68 GB) and at chatglm3-6b's heads
   ``(2, 32 -> 2, 2048, 128)``, each beside the plain version and beside
   ``scaled_dot_product_attention`` (the yardstick; the port never calls
   it), with its bound; one JSON line per shape.
7. Serving slice: olmo-1b at its published width (16 layers, d_model
   2,048, 16 heads of 128, d_ff 8,192, vocab 50,304) in bf16, weights
   from seed 0 on the card. Prefill ``forward(last_only=True)`` of 4
   prompts of 4,096 tokens, 16 K11 launches per forward (time, tokens/s,
   K11's device time from the profiler, which must find it, peak
   memory); ``Engine.generate``
   of 4 prompts of 128 tokens and 32 new tokens (ms per decode step,
   tokens/s, no K11 launch), greedy output repeated and a request alone
   equal to it in the batch; ``ContinuousEngine`` serving 6 requests on 4
   slots. Then in f32 (TF32 off): the prefill's last logits against the
   teacher-forced replay through ``decode_step`` on 2 x 512 tokens
   (relative L2 <= 1e-3, argmax equal); olmo-1b and chatglm3-6b at 2
   layers, card against CPU (<= 1e-4); chatglm3-6b's bf16 prefill of
   2 x 2,048 tokens, K11 at GQA group 16. Between the two, after the
   olmo model is freed, the MoE decoders (lines ``moe ...``, budget
   150 s): qwen3-moe-30b-a3b whole in bf16 (48 layers, 128 experts top-8,
   30,532,110,336 parameters, 61.1 GB, weights from seed 0 on the card):
   prefill of 2 x 4,096 tokens (capacity 320 an expert and row, 48 K11
   launches a forward, time, tokens/s, peak memory, and the profile's
   device time of K11, the expert products, routing, dispatch, combine
   and attention), then on its first 16 layers (sharing the weights; the
   whole model's decode is host-bound at 137-188 ms a step)
   ``Engine.generate`` of 4 x 128-token prompts and 32 new tokens (ms a
   step, no K11 launch, repeated, a request alone as in the batch) and
   ``ContinuousEngine`` (6 requests on 4 slots);
   mixtral-8x7b at full width cut to 4 of its 32 layers (the whole is
   93.4 GB), prefill of 1 x 8,192 tokens through K11's window of 4,096;
   then in f32 (TF32 off) qwen3-moe at 2 layers and mixtral at 1 layer
   with window 128: card against CPU on 2 x 256 tokens (routing tables
   equal, tokens at a router tie named, logits <= 1e-4) and prefill
   against the decode replay on 2 x 512 tokens at capacity factor 4.0
   (nothing dropped, <= 1e-3, argmax equal). After them the SSM and
   hybrid decoders (lines ``ssm ...``, budget 120 s): falcon-mamba-7b
   (64 Mamba1 layers, d_model 4,096, d_inner 8,192, state 16; 14.56 GB,
   A_log and D f32) and zamba2-2.7b (54 Mamba2 layers, d_model 2,560,
   state 64, two shared attention blocks of 32 heads of 80 invoked 9
   times, window 4,096; 5.29 GB) whole in bf16 from seed 0: prefill of
   2 x 4,096 tokens (K11 launches: none, and 9 a forward; time,
   tokens/s, peak memory, the profile's device time of ``ssm.proj``,
   ``ssm.conv``, ``ssm.scan``, attention and the rest (falcon-mamba's on
   its first 16 layers), and the scan of one layer timed alone against
   the forward), then serving on falcon-mamba's first 32 layers and
   zamba2's first 18 (printed cuts) as the MoE decoders'; then in
   f32 falcon-mamba at 2 layers and zamba2 at 4 layers (period 2, window
   128): card against CPU on 2 x 300 tokens (across a chunk edge,
   <= 1e-4), prefill against the decode replay on 2 x 512 tokens (<=
   1e-3, argmax equal), and the same layers in bf16 against f32 (<=
   5e-2).
8. Report: the kernels' JSON line.

Each slice zeroes the kernels' launch counts just before each fit or
forward and reads them just after; every kernel of the slice must have
run. The line
before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of the JAX
package ``repro``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores

SLICE = dict(d=47236, n=20242, density=0.0036, seed=0)
SOLVE = dict(loss="logistic", precond="woodbury", tau=100, lam=1e-4,
             partition_strategy="lpt", max_outer=10)
RUNS = [("samples", 1, False), ("samples", 4, False),
        ("features", 1, False), ("features", 4, False),
        ("samples", 1, True), ("features", 1, True)]
# the per-card shard of repro/launch/dryrun_glm.py's d = 1,048,576 by
# n = 262,144 problem over 256 cards, keeping the whole sample axis
DENSE = dict(d=4096, n=262_144, cond_decay=0.8, seed=0)
DENSE_SOLVE = dict(loss="logistic", precond="woodbury", tau=100, lam=1e-4,
                   use_kernel=True, max_outer=10, grad_tol=0.0)
DENSE_SHAPES = [(200, 300), (131, 77), (64, 4099), (2000, 2048)]
REL_TOL_KERNEL = 1e-5
REL_TOL_W = 1e-4
REPS = 20
# s-step PCG: Krylov dimensions per round, and the columns of a DiSCO-S
# round at that s, at which the multi-vector kernels are timed
SSTEP_S = 4
TIMED_S = SSTEP_S + 1
SSTEP_RUNS = [("samples", 1, False), ("features", 1, False),
              ("samples", 1, True), ("features", 4, False)]
DENSE_SSTEP_RUNS = [("samples", 1, False), ("features", 1, False),
                    ("features", 4, True), ("samples", 1, True),
                    ("samples", 4, True), ("features", 1, True)]
MULTI_S = (1, 2, 4, 5, 8)
MAX_COLS = 8                     # columns per multi-vector kernel launch
# the workloads on the dense slice's X
LAMBDAS = (1e-2, 1e-3, 1e-4)
N_VAL = 32_768
SOFTMAX_K = 10
SOFTMAX_SOLVE = dict(lam=1e-3, max_outer=8, grad_tol=0.0, use_kernel=True)
SOFTMAX_RUNS = [("samples", 1, 1), ("samples", 1, 2), ("features", 4, 1),
                ("features", 4, 2)]
# the paper's comparisons: the original DiSCO (SAG preconditioner,
# Figure 3) on DiSCO-S, Hessian subsampling (Figure 5's ends below 1) on
# DiSCO-F, both on the sparse slice; GD and DANE on the dense slice's X;
# Figure 3's five methods on make_regime('rcv1_like')
SAG_SOLVE = dict(SOLVE, precond="sag", sag_epochs=5, max_outer=2)
SUBSAMPLE_FRACS = (0.5, 0.0625)
SUBSAMPLE_SOLVE = dict(SOLVE, max_outer=2)
COMPARISON_SHARDS = (1, 4)
BASELINE_OUTER = 3
FIG3 = dict(regime="rcv1_like", lam=1e-4, m=4, outer=3, cocoa_outer=2)
COCOA_PROBE_STEPS = (16, 32)     # local steps of the two profiled passes

# flash attention (K11) and the dense decoder serving slice
BF16_FLOPS_PER_S = 989.4e12      # bf16 dense tensor-core rate
FLASH_TOL = {"float32": 1e-5, "bfloat16": 1e-2}   # relative L2 vs plain f32
FLASH_CASES = [
    # B, Hq, Hkv, S, T, Dh, causal, window, kv_len
    (2, 4, 2, 128, 128, 64, True, 0, None),   # tests/test_kernels.py:91-96
    (1, 8, 2, 256, 256, 64, True, 64, None),
    (2, 2, 2, 96, 96, 32, False, 0, None),
    (1, 4, 1, 200, 200, 64, True, 0, None),
    (1, 4, 4, 130, 130, 64, False, 50, None),
    (1, 16, 4, 64, 64, 128, True, 0, None),
    (1, 5, 1, 97, 97, 128, True, 0, None),    # group 5, ragged S
    (2, 32, 2, 63, 63, 128, True, 0, None),   # group 16 (chatglm3-6b)
    (1, 16, 16, 200, 200, 128, False, 50, None),
    (1, 4, 1, 63, 200, 32, True, 0, 150),     # S != T, kv_len < T
    (1, 8, 2, 200, 97, 64, False, 50, 80),
    (2, 20, 4, 97, 300, 128, True, 50, 250),
    (1, 16, 1, 1000, 1000, 128, True, 0, None),
    # the bf16 kernel's edges: 128-row q tiles (64 a warpgroup), 128-key
    # kv tiles, a window inside one tile and one across more than two,
    # kv_len inside the last tile, group 16
    (1, 4, 2, 127, 127, 128, True, 0, None),
    (1, 4, 2, 128, 128, 32, True, 0, None),
    (2, 4, 1, 129, 129, 64, True, 0, None),
    (1, 4, 2, 257, 257, 128, True, 0, None),
    (1, 4, 4, 257, 257, 64, True, 100, None),
    (1, 4, 2, 600, 600, 128, True, 300, None),
    (1, 2, 2, 257, 257, 32, False, 300, None),
    (1, 4, 2, 129, 257, 128, True, 0, 250),
    (1, 8, 2, 300, 300, 64, False, 0, 290),
    (1, 32, 2, 257, 257, 128, True, 0, None),
    (1, 16, 1, 128, 129, 128, False, 0, None),
    # q tiles that attend no key: alone, and paired with one that does
    (1, 4, 1, 600, 97, 32, True, 64, None),
    # Dh = 80 (zamba2-2.7b's shared attention): the bf16 kernel's
    # 128-column tiles, columns 80-127 TMA's zero fill
    (1, 4, 2, 257, 257, 80, True, 100, None),
    (2, 32, 32, 130, 130, 80, True, 0, None),
    (1, 5, 1, 63, 200, 80, False, 50, 150),
]
# contiguous (B, H, S, Dh); a (B, S, H, Dh) tensor transposed, as the
# model passes its projections; the same cut from rows of Dh + 8
FLASH_LAYOUTS = ("contiguous", "head_major", "sliced")
# the model prefills' calls, in bf16 as the model passes them
# (head-major): qwen3-moe-30b-a3b's 2 x 4,096 tokens at GQA group 8,
# mixtral-8x7b's 1 x 8,192 through its window of 4,096 at group 4,
# zamba2-2.7b's 2 x 4,096 at Dh = 80 and its window of 4,096 at 8,192;
# their plain versions' f32 scores take 4.3 to 8.6 GB
FLASH_MODEL_CASES = {
    "qwen3-moe-30b-a3b": (2, 32, 4, 4096, 4096, 128, True, 0, None),
    "mixtral-8x7b": (1, 32, 8, 8192, 8192, 128, True, 4096, None),
    "zamba2-2.7b": (2, 32, 32, 4096, 4096, 80, True, 0, None),
    "zamba2-2.7b at 8,192": (1, 32, 32, 8192, 8192, 80, True, 4096, None),
}
FLASH_ROUNDING_RATIO = 1.5   # bf16 error over the output rounding's alone
# name: B, Hq, Hkv, S (= T), Dh, dtype, reps, time the plain version,
# layout; all causal. main: olmo-1b's call in a prefill of 4 x 4,096
# tokens (one layer), contiguous and as the model passes it (head-major
# views); prefill_32k: one layer's call at that shape's length, whose
# plain version would need 68 GB of f32 scores; gqa: chatglm3-6b's heads;
# zamba2: a shared block's call in its prefill of 2 x 4,096 (Dh = 80)
FLASH_TIMED = {
    "main_bf16": (4, 16, 16, 4096, 128, "bfloat16", REPS, True,
                  "contiguous"),
    "main_bf16_head_major": (4, 16, 16, 4096, 128, "bfloat16", REPS, False,
                             "head_major"),
    "main_f32": (4, 16, 16, 4096, 128, "float32", REPS, True, "contiguous"),
    "prefill_32k_bf16": (1, 16, 16, 32768, 128, "bfloat16", 3, False,
                         "contiguous"),
    "gqa_bf16": (2, 32, 2, 2048, 128, "bfloat16", REPS, True, "contiguous"),
    "zamba2_bf16_head_major": (2, 32, 32, 4096, 80, "bfloat16", REPS, True,
                               "head_major"),
}
# K11's device functions, as the profiler names them
FLASH_KERNEL_NAMES = re.compile(r"flash_(wgmma|f32)_kernel")
MODEL_ARCH = "olmo-1b"
PREFILL = (4, 4096)          # train_4k's length, the batch cut to 4
PREFILL_REPS = 3
DECODE_PROFILED = 8          # decode steps under the profiler
SERVE = dict(batch=4, prompt=128, new=32)
CONSISTENCY = (2, 512)       # f32 prefill vs decode replay
# the MoE decoders (phase "moe"): qwen3-moe-30b-a3b whole in bf16, mixtral-8x7b
# at full width cut in depth, and f32 checks on a layer or two of each
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_PARAMS = (30_532_110_336, 3_353_020_416)     # all, active a token
MOE_PREFILL = (2, 4096)      # train_4k's length, the batch cut to 2
MOE_CAPACITY = 320           # per expert and row at 4,096 tokens, cf 1.25
# the serving of the MoE decoders and (phase "ssm") the SSM and hybrid ones
MOE_SERVE = dict(batch=4, prompt=128, new=32, max_len=256)
MOE_DECODE_PROFILED = 4      # decode steps under the profiler (device only)
# serving runs on the whole model's first MOE_SERVE_LAYERS layers: decode is
# host-bound (137-188 ms a step at 48 layers on an H100 80GB HBM3 at
# 700 W), and its three 159-step runs at full depth would take 65-90 s
MOE_SERVE_LAYERS = 16
MIXTRAL = "mixtral-8x7b"
MIXTRAL_LAYERS = 4           # of 32: the whole model is 93.4 GB in bf16
MIXTRAL_PREFILL = (1, 8192)  # twice the window, so the window mask cuts
MOE_CONSISTENCY = (2, 256)   # f32 card vs CPU
MOE_REPLAY = (2, 512)        # f32 prefill vs decode replay at cf 4.0
MOE_F32 = {MOE_ARCH: dict(num_layers=2),
           MIXTRAL: dict(num_layers=1, window=128)}
MOE_BUDGET_S = 150.0
# the profiler ranges a prefill runs in (repro_torch.models.moe.moe_block's
# parts, each layer's attention), whose device time the profile sums
MOE_RANGES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine",
              "attention")
# the SSM and hybrid decoders (phase "ssm"): both whole in bf16, prefill
# and serving, then f32 checks on a few layers of each
SSM_WHOLE = {
    # published width and depth: layers, d_model, d_inner, state, heads
    # of the shared attention, head_dim, vocab; parameters
    "falcon-mamba-7b": ((64, 4096, 8192, 16, 0, 0, 65024), 7_272_665_088),
    "zamba2-2.7b": ((54, 2560, 5120, 64, 32, 80, 32000), 2_645_497_760),
}
SSM_PREFILL = (2, 4096)      # train_4k's length, the batch cut to 2
SSM_PREFILL_REPS = 2
# serving runs on the first half of falcon-mamba-7b's layers and the
# first third of zamba2-2.7b's (3 of its 9 shared-block groups): decode
# is host-bound (76 ms a step at falcon-mamba's 64 layers, 85 ms at
# zamba2's 54, 51 ms at 30, on an H100 80GB HBM3 at 700 W), and three
# 159-step runs of each at full depth put the phase over its budget
SSM_SERVE_LAYERS = {"falcon-mamba-7b": 32, "zamba2-2.7b": 18}
# the profiled prefill of falcon-mamba-7b runs on its first 16 layers
# (all alike) at the full 2 x 4,096 tokens: the profiler took about a
# minute to process the whole model's 45,000 kernels of one forward
SSM_PROFILE_LAYERS = {"falcon-mamba-7b": 16}
SSM_F32 = {"falcon-mamba-7b": dict(num_layers=2),
           "zamba2-2.7b": dict(num_layers=4, shared_attn_period=2,
                               window=128)}
SSM_CONSISTENCY = (2, 300)   # f32 card vs CPU, across the chunk edge (256)
SSM_REPLAY = (2, 512)        # f32 prefill vs decode replay
SSM_BUDGET_S = 120.0
SSM_RANGES = ("ssm.proj", "ssm.conv", "ssm.scan", "attention")
# bf16 prefill (K11's tensor-core kernel) vs the same forward in f32 on the
# same weights: bf16 rounds every activation of every layer (2^-9 each),
# so the limit is bf16-sized; tests/test_torch_models.py holds the CPU's
# bf16 forward to the same limit at 16 layers
BF16_MODEL_TOL = 5e-2

SOURCE = "src/repro_torch/kernels/csrc/{}.cu"
REPLACES = {"ell_mv": "src/repro/kernels/sparse_hvp.py:82",
            "ell_hvp": "src/repro/kernels/sparse_hvp.py:204",
            "xt_u": "src/repro/kernels/glm_hvp.py:81",
            "x_cz": "src/repro/kernels/glm_hvp.py:124",
            "x_c_xt_u": "src/repro/kernels/glm_hvp.py:258",
            "ell_mm": "src/repro/kernels/sparse_hvp.py:136",
            "ell_hvp_mm": "src/repro/kernels/sparse_hvp.py:268",
            "xt_multi": "src/repro/kernels/glm_hvp.py:168",
            "x_cz_multi": "src/repro/kernels/glm_hvp.py:208",
            "x_c_xt_multi": "src/repro/kernels/glm_hvp.py:302",
            "flash_attention": "src/repro/kernels/flash_attention.py:85"}
SPARSE_KERNELS = ("ell_mv", "ell_hvp", "ell_mm", "ell_hvp_mm")
# their instances on bf16 tiles (DiscoConfig.hvp_dtype='bfloat16'): the
# same TPU kernels at bf16 tile storage
SPARSE_BF16 = tuple(f"{k}_bf16" for k in SPARSE_KERNELS)
REPLACES.update({f"{k}_bf16": REPLACES[k] for k in SPARSE_KERNELS})
# the bf16 runs of the sparse slice: partition, m, fused, pcg_block_s;
# each held to the f32 m = 1 two-pass w of its partition at REL_TOL_W
BF16_RUNS = [("samples", 1, False, 1), ("features", 1, False, 1),
             ("samples", 1, True, 1), ("samples", 1, False, SSTEP_S),
             ("samples", 1, True, SSTEP_S)]
# card against CPU on a small bf16 solve: another f32 summation order
# moves a bf16 solve by up to 1.2e-4 relative L2 (ROADMAP F11)
BF16_REL_W_SMALL = 3e-4
BYTES_BF16 = 2
DENSE_KERNELS = ("xt_u", "x_cz", "x_c_xt_u", "xt_multi", "x_cz_multi",
                 "x_c_xt_multi")
DENSE_SINGLE = ("xt_u", "x_cz", "x_c_xt_u")
# the two-pass dense kernels' instances on bf16 tiles (hvp_dtype =
# 'bfloat16' on dense input): the same TPU kernels at bf16 tile storage
DENSE_TWO_PASS = ("xt_u", "x_cz", "xt_multi", "x_cz_multi")
DENSE_BF16 = tuple(f"{k}_bf16" for k in DENSE_TWO_PASS)
REPLACES.update({f"{k}_bf16": REPLACES[k] for k in DENSE_TWO_PASS})
# the multi-vector checks at bf16 add 13 columns (two launches: 8 + 5)
BF16_MULTI_S = MULTI_S + (13,)
# the bf16 runs on the dense slice's X: partition, m, pcg_block_s,
# use_kernel; each held to the f32 m = 1 two-pass w of its partition
BF16_DENSE_RUNS = [("samples", 1, 1, True), ("features", 1, 1, True),
                   ("samples", 4, 1, True), ("samples", 1, SSTEP_S, True),
                   ("samples", 1, 1, False)]
# the one-pass dense kernels' instances on bf16 tiles (hvp_fused=True with
# hvp_dtype='bfloat16' on dense input): the same TPU kernels at bf16
DENSE_FUSED_BF16 = ("x_c_xt_u_bf16", "x_c_xt_multi_bf16")
REPLACES.update({k: REPLACES[k[:-len("_bf16")]] for k in DENSE_FUSED_BF16})
# the fused bf16 runs on the dense slice's X: partition, m, pcg_block_s;
# each held to the f32 fused run and the bf16 two-pass run of its cell (w
# at REL_TOL_W), its PCG iterations (or rounds) in all within
# FUSED_BF16_ITERS of the f32 fused run's
BF16_FUSED_RUNS = [("samples", 1, 1), ("features", 1, 1), ("samples", 4, 1),
                   ("samples", 1, SSTEP_S)]
FUSED_BF16_ITERS = 0.10

FAILURES: list[str] = []


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def rel_err(got, ref) -> float:
    import torch
    return float(torch.linalg.norm(got - ref) /
                 torch.clamp(torch.linalg.norm(ref), min=1e-30))


def time_ms(fn, reps: int = REPS) -> float:
    """Median milliseconds of ``fn`` over ``reps`` calls, each between two
    CUDA events, after warm-up. The calls are queued back to back behind
    one untimed call, so the host's launch work overlaps the device's and
    each event pair times the device work of one call."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    fn()
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def nonempty_tiles(data) -> int:
    """Tiles of a (.., br, bc) layout holding at least one nonzero."""
    return int((data.reshape(-1, data.shape[-2] * data.shape[-1]) != 0)
               .any(dim=1).sum())


def bound_ms(tiles: int, tile_elems: int, other_bytes: int,
             flops_per_elem: int) -> tuple[float, str]:
    """Least time for the work: the larger of bytes over the HBM rate and
    f32 operations over the f32 peak; and which of the two bounds it."""
    t_bytes = (tiles * tile_elems * 4 + other_bytes) / HBM_BYTES_PER_S
    t_ops = tiles * tile_elems * flops_per_elem / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def record_err(errs, name, got, want) -> float:
    """Relative L2 error of ``got``; kept as the kernel's worst."""
    e = rel_err(got, want)
    errs[name]["rel"] = max(errs[name]["rel"], e)
    errs[name]["abs"] = max(errs[name]["abs"],
                            float((got - want).abs().max()))
    return e


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

MULTI_KERNEL = re.compile(r"multi_kernelILb([01])ELb([01])E\w+?Li(\d)E")


def multi_ptxas(log: str) -> list:
    """The registers and spill bytes of each instance of
    ``csrc/dense_multi.cuh``'s kernel in an ``nvcc -Xptxas -v`` log (its
    path and its s, from the mangled name)."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\S+?)'?(?: for|$)", line.strip())
        if m:
            k = MULTI_KERNEL.search(m[1])
            if k is None:
                cur = None
                continue
            key = ("bulk" if k[2] == "1" else "direct", int(k[3]))
            cur = next((r for r in out if (r["path"], r["s"]) == key), None)
            if cur is None:
                cur = dict(path=key[0], s=key[1], registers=None,
                           spill_stores=0, spill_loads=0)
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m[1])
    return sorted(out, key=lambda r: (r["path"], r["s"]))

def phase_build(build) -> None:
    t0 = time.perf_counter()
    reports = build.build_kernels()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(reports) or 'cached'})", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    for name, log in reports.items():
        if name.startswith(("xt_multi", "x_cz_multi")):
            rows = multi_ptxas(log)
            print(f"ptxas {name} by instance: " + ", ".join(
                f"{r['path']} s={r['s']} {r['registers']} regs"
                + (f" SPILLS {r['spill_stores']}/{r['spill_loads']} B"
                   if r["spill_stores"] or r["spill_loads"] else "")
                for r in rows), flush=True)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        line = smi.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired) as exc:
        line = f"nvidia-smi unavailable: {exc!r}"
    check(not line.startswith("nvidia-smi unavailable"),
          "nvidia-smi reads the card")
    print(line, flush=True)


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def phase_kernels(torch, sparse_hvp, ref, errs) -> None:
    from repro_torch.data.sparse import ell_from_csr, make_sparse_glm_data
    dev = torch.device("cuda")
    rng_seed = 0
    for block in (8, 16, 128):
        if block <= 16:
            X, _, _ = make_sparse_glm_data(d=70, n=90, density=0.05, seed=1)
        else:
            X, _, _ = make_sparse_glm_data(d=2000, n=1500, density=0.005,
                                           seed=1)
        fwd = ell_from_csr(X, block, block)
        tr = ell_from_csr(X.transpose(), block, block)
        padded = bool((fwd.cols[:, 1:] == 0).any())
        check(padded, f"{block}x{block} layout has padding slots")
        T = lambda a: torch.from_numpy(a).to(dev)
        data, cols, dataT, colsT = map(T, (fwd.data, fwd.cols, tr.data,
                                           tr.cols))
        n_col, n_row = fwd.n_col_blocks * block, fwd.n_row_blocks * block
        g = torch.Generator(device=dev).manual_seed(rng_seed)
        v = torch.randn(n_col, generator=g, device=dev)
        u = torch.randn(n_row, generator=g, device=dev)
        for with_c in (False, True):
            c, cT = ((torch.rand(n_col, generator=g, device=dev),
                      torch.rand(n_row, generator=g, device=dev))
                     if with_c else (None, None))
            cases = [
                ("ell_mv", "forward", sparse_hvp.ell_mv(data, cols, v, c),
                 ref.ref_ell_mv(data, cols, v, c)),
                ("ell_mv", "transposed",
                 sparse_hvp.ell_mv(dataT, colsT, u, cT),
                 ref.ref_ell_mv(dataT, colsT, u, cT)),
                ("ell_hvp", "transposed",
                 sparse_hvp.ell_hvp(dataT, colsT, u, c),
                 ref.ref_ell_hvp_t(dataT, colsT, u, c)),
            ]
            torch.cuda.synchronize()
            for name, layout, got, want in cases:
                e = record_err(errs, name, got, want)
                check(e <= REL_TOL_KERNEL,
                      f"{name} {layout} {block}x{block} c={with_c}: "
                      f"rel err {e:.2e}")
        rng_seed += 1


def edge_layouts():
    """Small layouts at the edges of K1's and K6's live-tile schedule,
    each with the copy path its shape takes: power-law ones with padding
    slots at 8 x 8, 16 x 16 and 128 x 128; 3 row-blocks of W = 300 (fewer
    than the SMs); one full row-block among 199 empty ones; W = 1 with
    every other row-block empty; 256 x 32 tiles (two row chunks) and
    32 x 256; and 12 x 6 tiles (24-byte rows, which a bulk copy cannot
    take: the direct path)."""
    import numpy as np
    from repro_torch.data.sparse import (CSRMatrix, ell_from_csr,
                                         make_sparse_glm_data)
    rng = np.random.default_rng(11)
    tiled = lambda a, br, bc: ell_from_csr(CSRMatrix.from_dense(a), br, bc)
    out = []
    for block in (8, 16, 128):
        kw = (dict(d=70, n=90, density=0.05) if block <= 16 else
              dict(d=2000, n=1500, density=0.005))
        X, _, _ = make_sparse_glm_data(**kw, seed=2)
        out.append((f"{block}x{block}", ell_from_csr(X, block, block),
                    "bulk"))
    dense = rng.standard_normal((3 * 16, 300 * 16)).astype(np.float32)
    dense[rng.random(dense.shape) > 0.05] = 0.0
    out.append(("3 row-blocks of W=300", tiled(dense, 16, 16), "bulk"))
    dense = np.zeros((200 * 16, 40 * 16), np.float32)
    dense[77 * 16:78 * 16] = rng.standard_normal((16, 40 * 16))
    out.append(("one full row-block of 200", tiled(dense, 16, 16), "bulk"))
    dense = np.zeros((300 * 8, 300 * 8), np.float32)
    for i in range(0, 300, 2):
        dense[i * 8:(i + 1) * 8, i * 8:(i + 1) * 8] = \
            rng.standard_normal((8, 8))
    out.append(("W=1", tiled(dense, 8, 8), "bulk"))
    X, _, _ = make_sparse_glm_data(d=1000, n=900, density=0.01, seed=4)
    for br, bc, path in ((256, 32, "bulk"), (32, 256, "bulk"),
                         (12, 6, "direct")):
        out.append((f"{br}x{bc}", ell_from_csr(X, br, bc), path))
    return out


def phase_ell_edges(torch, sparse_hvp, ref, errs) -> None:
    """K1 and K6 on :func:`edge_layouts`, with the layout's schedule and
    without (every slot live), with and without c, K6 at s in MULTI_S on
    a strided V, each call repeated bit for bit and on the path its shape
    takes; then NaN put into the padding after the schedule is built must
    leave both results finite and equal (the padding is not read). One
    check line per layout."""
    import numpy as np
    dev = torch.device("cuda")
    ctas = sparse_hvp.default_ctas(dev)
    for tag, ell, path in edge_layouts():
        T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        data, cols = T(ell.data), T(ell.cols)
        nb, w, br, bc = data.shape
        sched = sparse_hvp.ell_schedule(data, cols, ctas)
        n_in = ell.n_col_blocks * bc
        g = torch.Generator(device=dev).manual_seed(nb)
        v = torch.randn(n_in, generator=g, device=dev)
        c = torch.rand(n_in, generator=g, device=dev)
        worst, same, paths = {"ell_mv": 0.0, "ell_mm": 0.0}, True, set()
        for sc in (None, sched):
            for cc in (None, c):
                got = sparse_hvp.ell_mv(data, cols, v, cc, sched=sc)
                paths.add(sparse_hvp.last_path["ell_mv"])
                again = sparse_hvp.ell_mv(data, cols, v, cc, sched=sc)
                want = ref.ref_ell_mv(data, cols, v, cc)
                torch.cuda.synchronize()
                worst["ell_mv"] = max(worst["ell_mv"],
                                      record_err(errs, "ell_mv", got, want))
                same &= bool(torch.equal(got, again))
                for k in MULTI_S:
                    V = torch.randn((n_in, k + 1), generator=g,
                                    device=dev)[:, :k]
                    got = sparse_hvp.ell_mm(data, cols, V, cc, sched=sc)
                    paths.add(sparse_hvp.last_path["ell_mm"])
                    again = sparse_hvp.ell_mm(data, cols, V, cc, sched=sc)
                    want = ref.ref_ell_mm(data, cols, V, cc)
                    torch.cuda.synchronize()
                    worst["ell_mm"] = max(worst["ell_mm"], record_err(
                        errs, "ell_mm", got, want))
                    same &= bool(torch.equal(got, again))
        live = sparse_hvp.schedule_parts(sched, nb)[0].long()
        padding = torch.arange(w, device=dev)[None, :] >= live[:, None]
        poisoned = data.clone()
        poisoned[padding] = float("nan")
        V = torch.randn((n_in, TIMED_S + 1), generator=g,
                        device=dev)[:, :TIMED_S]
        y = sparse_hvp.ell_mv(poisoned, cols, v, c, sched=sched)
        Y = sparse_hvp.ell_mm(poisoned, cols, V, c, sched=sched)
        torch.cuda.synchronize()
        skipped = (bool(y.isfinite().all()) and bool(Y.isfinite().all())
                   and bool(torch.equal(y, sparse_hvp.ell_mv(
                       data, cols, v, c, sched=sched)))
                   and bool(torch.equal(Y, sparse_hvp.ell_mm(
                       data, cols, V, c, sched=sched))))
        check(max(worst.values()) <= REL_TOL_KERNEL and same and skipped
              and paths == {path},
              f"ell_mv / ell_mm {tag} {tuple(data.shape)}, with and without "
              f"the schedule, c, s in {list(MULTI_S)}: worst rel err "
              f"{worst['ell_mv']:.2e} / {worst['ell_mm']:.2e}, repeatable "
              f"{same}, path {sorted(paths)} (want {path}), NaN padding "
              f"not read {skipped}")


def forward_of(ell):
    """The forward layout of A whose transposed layout is ``ell`` (tiles
    of A^T), for the two-pass pair."""
    import numpy as np
    from repro_torch.data.sparse import CSRMatrix, ell_from_csr
    nb, w, br, bc = ell.data.shape
    M = np.zeros((nb * br, ell.n_col_blocks * bc), np.float32)
    for i in range(nb):
        for k in range(w):
            j = ell.cols[i, k]
            M[i * br:(i + 1) * br, j * bc:(j + 1) * bc] += ell.data[i, k]
    return ell_from_csr(CSRMatrix.from_dense(np.ascontiguousarray(M.T)),
                        bc, br)


HVP_STEPS = {"every slot": None, "default": 0, "one row-block a step": 1,
             "one step": 1 << 40}    # step_bytes (0: the card's default)


def phase_hvp_edges(torch, sparse_hvp, ref, errs) -> None:
    """K2 and K7 on :func:`edge_layouts` taken as transposed layouts: with
    the layout's step schedule at the default step_bytes, one below every
    row-block (each a step alone) and one above the whole layout (one
    step), and without a schedule (every slot live); with and without c,
    K7 at s in MULTI_S on contiguous and strided U; against the plain
    versions and the two-pass pair (ell_mv / ell_mm on the transposed,
    then the forward layout), on the path the shape takes; with a
    schedule, NaN in every padding slot must change nothing. One check
    line per layout."""
    import numpy as np
    dev = torch.device("cuda")
    ctas = sparse_hvp.default_ctas(dev)
    for tag, ell, path in edge_layouts():
        fwd = forward_of(ell)
        T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        clean, colsT, data, cols = T(ell.data), T(ell.cols), T(fwd.data), \
            T(fwd.cols)
        nb, w, R, C = clean.shape
        n_u = ell.n_col_blocks * C
        g = torch.Generator(device=dev).manual_seed(nb + 1)
        u = torch.randn(n_u, generator=g, device=dev)
        c = torch.rand(nb * R, generator=g, device=dev)
        worst = {"ell_hvp": 0.0, "ell_hvp_mm": 0.0}
        paths, finite, steps = set(), True, {}
        for name, step_bytes in HVP_STEPS.items():
            sched, dataT = None, clean
            if step_bytes is not None:
                sched = sparse_hvp.ell_hvp_schedule(
                    clean, colsT, ctas, step_bytes or None)
                steps[name] = sched.steps
                live = sched.parts()[0].long()
                dataT = clean.clone()
                dataT[torch.arange(w, device=dev)[None, :]
                      >= live[:, None]] = float("nan")
            for cc in (None, c):
                got = sparse_hvp.ell_hvp(dataT, colsT, u, cc, sched=sched)
                paths.add(sparse_hvp.last_path["ell_hvp"])
                pair = sparse_hvp.ell_mv(data, cols, sparse_hvp.ell_mv(
                    clean, colsT, u), cc)
                want = ref.ref_ell_hvp_t(clean, colsT, u, cc)
                torch.cuda.synchronize()
                finite &= bool(got.isfinite().all())
                worst["ell_hvp"] = max(worst["ell_hvp"],
                                       record_err(errs, "ell_hvp", got, want),
                                       rel_err(got, pair))
                for k in MULTI_S:
                    for strided in (False, True):
                        U = torch.randn((n_u, k + 1), generator=g,
                                        device=dev)[:, :k]
                        if not strided:
                            U = U.contiguous()
                        got = sparse_hvp.ell_hvp_mm(dataT, colsT, U, cc,
                                                    sched=sched)
                        paths.add(sparse_hvp.last_path["ell_hvp_mm"])
                        pair = sparse_hvp.ell_mm(data, cols, sparse_hvp.ell_mm(
                            clean, colsT, U), cc)
                        want = ref.ref_ell_hvp_mm_t(clean, colsT, U, cc)
                        torch.cuda.synchronize()
                        finite &= bool(got.isfinite().all())
                        worst["ell_hvp_mm"] = max(
                            worst["ell_hvp_mm"],
                            record_err(errs, "ell_hvp_mm", got, want),
                            rel_err(got, pair))
        check(max(worst.values()) <= REL_TOL_KERNEL and finite
              and paths == {path},
              f"ell_hvp / ell_hvp_mm {tag} {tuple(clean.shape)}, steps "
              f"{json.dumps(steps)} and every slot, c, s in "
              f"{list(MULTI_S)} contiguous and strided: worst rel err "
              f"(plain and two-pass pair) {worst['ell_hvp']:.2e} / "
              f"{worst['ell_hvp_mm']:.2e}, NaN padding not read {finite}, "
              f"path {sorted(paths)} (want {path})")


def check_fused_bf16(torch, sparse_hvp, ref, dataT, colsT, U, c, got, cz,
                     pair_z=None, fwd=None) -> dict:
    """A bf16 fused kernel's call held in its two halves: its hand-off
    ``cz`` (rounded c .* Z) against the plain hand-off (and against the
    two-pass pair's, ``pair_z`` = the pair's pass A), ties within f32
    summation error aside (``ref.ell_handoff_flips``); its
    output against the plain pass B of its own hand-off (and the pair's
    pass B, bf16 K6 on the forward layout ``fwd``). Returns the worst
    rel errors, the tie flips and the end-to-end rel err against the
    whole plain version."""
    n_u = U.shape[0]
    t = ref.ref_ell_handoff_t(dataT, colsT, U, c)
    slack = ref.ell_handoff_slack(dataT, colsT, U, c, t)
    cz = cz.reshape(t.shape)
    flips, ties = ref.ell_handoff_flips(cz, t, slack)
    want = ref.ref_ell_scatter_t(dataT, colsT, cz, n_u)
    out = dict(rel=rel_err(got, want), abs=float((got - want).abs().max()),
               flips=flips, ties=ties,
               end_to_end=rel_err(got, ref.ref_ell_scatter_t(
                   dataT, colsT, t.to(torch.bfloat16).float(), n_u)))
    if pair_z is not None:
        tp = pair_z if c is None else c[:, None] * pair_z
        pflips, pties = ref.ell_handoff_flips(cz, tp, slack)
        out.update(pair_flips=pflips, ties=ties and pties,
                   pair_rel=rel_err(got, sparse_hvp.ell_mm(fwd[0], fwd[1],
                                                           cz)))
    return out


def phase_bf16_edges(torch, sparse_hvp, ref, errs) -> None:
    """The bf16 instances on :func:`edge_layouts` (bulk where a tile row
    is a multiple of 16 bytes, so 12 x 6 takes the direct path): K1 and
    K6 with and without the schedule and c, K6 at s in MULTI_S on a
    strided V, repeated bit for bit, NaN padding not read; K2 and K7 with
    every HVP_STEPS schedule (NaN in the padding where there is one),
    with and without c, at s in MULTI_S on contiguous and strided U, each
    held in its two halves (:func:`check_fused_bf16`) against the plain
    version and the two-pass bf16 pair. One check line per layout and
    pair of kernels."""
    import numpy as np
    dev = torch.device("cuda")
    ctas = sparse_hvp.default_ctas(dev)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    for tag, ell, _ in edge_layouts():
        data, cols = T(ell.data).to(torch.bfloat16), T(ell.cols)
        nb, w, br, bc = data.shape
        path = "bulk" if bc % 8 == 0 else "direct"
        sched = sparse_hvp.ell_schedule(data, cols, ctas)
        n_in = ell.n_col_blocks * bc
        g = torch.Generator(device=dev).manual_seed(nb + 7)
        v = torch.randn(n_in, generator=g, device=dev)
        c = torch.rand(n_in, generator=g, device=dev)
        worst, same, paths = {"ell_mv_bf16": 0.0, "ell_mm_bf16": 0.0}, \
            True, set()
        for sc in (None, sched):
            for cc in (None, c):
                got = sparse_hvp.ell_mv(data, cols, v, cc, sched=sc)
                paths.add(sparse_hvp.last_path["ell_mv_bf16"])
                again = sparse_hvp.ell_mv(data, cols, v, cc, sched=sc)
                want = ref.ref_ell_mv(data, cols, v, cc)
                torch.cuda.synchronize()
                worst["ell_mv_bf16"] = max(worst["ell_mv_bf16"], record_err(
                    errs, "ell_mv_bf16", got, want))
                same &= bool(torch.equal(got, again))
                for k in MULTI_S:
                    V = torch.randn((n_in, k + 1), generator=g,
                                    device=dev)[:, :k]
                    got = sparse_hvp.ell_mm(data, cols, V, cc, sched=sc)
                    paths.add(sparse_hvp.last_path["ell_mm_bf16"])
                    again = sparse_hvp.ell_mm(data, cols, V, cc, sched=sc)
                    want = ref.ref_ell_mm(data, cols, V, cc)
                    torch.cuda.synchronize()
                    worst["ell_mm_bf16"] = max(worst["ell_mm_bf16"],
                                               record_err(errs, "ell_mm_bf16",
                                                          got, want))
                    same &= bool(torch.equal(got, again))
        live = sparse_hvp.schedule_parts(sched, nb)[0].long()
        poisoned = data.clone()
        poisoned[torch.arange(w, device=dev)[None, :] >= live[:, None]] = \
            float("nan")
        V = torch.randn((n_in, TIMED_S + 1), generator=g,
                        device=dev)[:, :TIMED_S]
        y = sparse_hvp.ell_mv(poisoned, cols, v, c, sched=sched)
        Y = sparse_hvp.ell_mm(poisoned, cols, V, c, sched=sched)
        torch.cuda.synchronize()
        skipped = (bool(torch.equal(y, sparse_hvp.ell_mv(
            data, cols, v, c, sched=sched))) and bool(torch.equal(
                Y, sparse_hvp.ell_mm(data, cols, V, c, sched=sched))))
        check(max(worst.values()) <= REL_TOL_KERNEL and same and skipped
              and paths == {path},
              f"bf16 ell_mv / ell_mm {tag} {tuple(data.shape)}, with and "
              f"without the schedule, c, s in {list(MULTI_S)}: worst rel "
              f"err {worst['ell_mv_bf16']:.2e} / {worst['ell_mm_bf16']:.2e},"
              f" repeatable {same}, path {sorted(paths)} (want {path}), "
              f"NaN padding not read {skipped}")

        fwd = forward_of(ell)
        clean, colsT = data, cols
        fdata, fcols = T(fwd.data).to(torch.bfloat16), T(fwd.cols)
        nb, w, R, C = clean.shape
        path = "bulk" if C % 8 == 0 else "direct"
        n_u = ell.n_col_blocks * C
        u = torch.randn(n_u, generator=g, device=dev)
        cT = torch.rand(nb * R, generator=g, device=dev)
        worst = dict(rel=0.0, pair_rel=0.0, end_to_end=0.0)
        flips, ties, finite, paths, steps = 0, True, True, set(), {}
        for name, step_bytes in HVP_STEPS.items():
            sc, dataT = None, clean
            if step_bytes is not None:
                sc = sparse_hvp.ell_hvp_schedule(clean, colsT, ctas,
                                                 step_bytes or None)
                steps[name] = sc.steps
                lv = sc.parts()[0].long()
                dataT = clean.clone()
                dataT[torch.arange(w, device=dev)[None, :]
                      >= lv[:, None]] = float("nan")
            for cc in (None, cT):
                for k in MULTI_S:
                    for strided in (False, True):
                        if k == 1 and strided:
                            continue
                        U = torch.randn((n_u, k + 1), generator=g,
                                        device=dev)[:, :k]
                        if not strided:
                            U = U.contiguous()
                        cz = torch.zeros(nb * R * k, device=dev)
                        if k == 1:
                            kname = "ell_hvp_bf16"
                            got = sparse_hvp.ell_hvp(dataT, colsT, U[:, 0],
                                                     cc, sched=sc,
                                                     cz_out=cz)[:, None]
                        else:
                            kname = "ell_hvp_mm_bf16"
                            got = sparse_hvp.ell_hvp_mm(dataT, colsT, U, cc,
                                                        sched=sc, cz_out=cz)
                        paths.add(sparse_hvp.last_path[kname])
                        pair_z = sparse_hvp.ell_mm(clean, colsT, U)
                        torch.cuda.synchronize()
                        finite &= bool(got.isfinite().all())
                        r = check_fused_bf16(torch, sparse_hvp, ref, clean,
                                             colsT, U, cc, got, cz, pair_z,
                                             (fdata, fcols))
                        rec = errs[kname]
                        rec["rel"] = max(rec["rel"], r["rel"], r["pair_rel"])
                        rec["abs"] = max(rec["abs"], r["abs"])
                        for key in worst:
                            worst[key] = max(worst[key], r[key])
                        flips += r["flips"]
                        ties &= r["ties"]
        check(max(worst["rel"], worst["pair_rel"]) <= REL_TOL_KERNEL and ties
              and finite and paths == {path},
              f"bf16 ell_hvp / ell_hvp_mm {tag} {tuple(clean.shape)}, steps "
              f"{json.dumps(steps)} and every slot, c, s in {list(MULTI_S)}"
              f" contiguous and strided: rel err of y against the plain and "
              f"the pair's pass B on the kernel's hand-off {worst['rel']:.2e}"
              f" / {worst['pair_rel']:.2e}, hand-off elements off the plain "
              f"rounding {flips} (all ties {ties}), end-to-end rel err "
              f"{worst['end_to_end']:.2e}, NaN padding not read {finite}, "
              f"path {sorted(paths)} (want {path})")


def phase_dense_kernels(torch, glm_hvp, ref, errs) -> None:
    """The dense kernels at ragged shapes (scalar and 16-byte loads, a d
    past the widest panel), with and without c, x_c_xt_u on every cluster
    size its fit rule allows, and a column-slice view as a DiSCO-S shard
    passes it."""
    dev = torch.device("cuda")
    for d, n in DENSE_SHAPES:
        g = torch.Generator(device=dev).manual_seed(d + n)
        X = torch.randn((d, n), generator=g, device=dev) / d ** 0.5
        u = torch.randn(d, generator=g, device=dev)
        z = torch.randn(n, generator=g, device=dev)
        c = torch.rand(n, generator=g, device=dev)
        for cc in (None, c):
            cz = z if cc is None else cc * z
            zu = ref.ref_xt_u(X, u)
            cases = [("xt_u", glm_hvp.xt_u(X, u), zu),
                     ("x_cz", glm_hvp.x_cz(X, cc, z), ref.ref_x_cz(X, cz)),
                     ("x_c_xt_u", glm_hvp.x_c_xt_u(X, cc, u),
                      ref.ref_x_cz(X, zu if cc is None else cc * zu))]
            torch.cuda.synchronize()
            for name, got, want in cases:
                e = record_err(errs, name, got, want)
                check(e <= REL_TOL_KERNEL, f"{name} {d}x{n} "
                      f"c={cc is not None}: rel err {e:.2e}")
        want = ref.ref_x_c_xt_u(X, c, u)
        for q in glm_hvp.CLUSTER_SIZES:
            if glm_hvp.fused_plan(d, 1, q) is None:
                continue
            got = glm_hvp.x_c_xt_u(X, c, u, _cluster=q)
            again = glm_hvp.x_c_xt_u(X, c, u, _cluster=q)
            run = glm_hvp.last_fused["x_c_xt_u"]
            e = record_err(errs, "x_c_xt_u", got, want)
            check(e <= REL_TOL_KERNEL and bool(torch.equal(got, again)),
                  f"x_c_xt_u {d}x{n} {fused_tag(run)}: rel err {e:.2e}, "
                  f"repeatable {bool(torch.equal(got, again))}")
    view, cs = X[:, 512:1536], c[512:1536]
    for name, got, want in (
            ("xt_u", glm_hvp.xt_u(view, u), ref.ref_xt_u(view, u)),
            ("x_cz", glm_hvp.x_cz(view, cs, cs), ref.ref_x_cz(view, cs * cs)),
            ("x_c_xt_u", glm_hvp.x_c_xt_u(view, cs, u),
             ref.ref_x_c_xt_u(view, cs, u))):
        e = record_err(errs, name, got, want)
        check(e <= REL_TOL_KERNEL, f"{name} on a column slice: rel err "
                                   f"{e:.2e}")


def fused_tag(run) -> str:
    """A fused call's plan, clusters and path, as the check lines print
    them."""
    return (f"Q={run.plan.cluster} bn={run.plan.bn} stages="
            f"{run.plan.stages} C={run.clusters} path {run.path}")


def phase_multi_kernels(torch, sparse_hvp, glm_hvp, ref, errs) -> None:
    """The multi-vector kernels at small ragged shapes, s in MULTI_S, with
    and without c, on contiguous and strided (first s of s + 1 columns)
    blocks: ell_mm on both layouts and ell_hvp_mm (also against the
    two-pass ell_mm pair) at 8x8, 16x16 and 128x128 tiles; xt_multi and
    x_cz_multi at DENSE_SHAPES. One check line per kernel and shape, with
    the worst error over its cases."""
    from repro_torch.data.sparse import ell_from_csr, make_sparse_glm_data
    dev = torch.device("cuda")
    T = lambda a: torch.from_numpy(a).to(dev)

    def block(rows, k, seed, strided):
        g = torch.Generator(device=dev).manual_seed(seed)
        B = torch.randn((rows, k + 1), generator=g, device=dev)
        return B[:, :k] if strided else B[:, :k].contiguous()

    for size in (8, 16, 128):
        if size <= 16:
            X, _, _ = make_sparse_glm_data(d=70, n=90, density=0.05, seed=2)
        else:
            X, _, _ = make_sparse_glm_data(d=2000, n=1500, density=0.005,
                                           seed=2)
        fwd = ell_from_csr(X, size, size)
        tr = ell_from_csr(X.transpose(), size, size)
        data, cols, dataT, colsT = map(T, (fwd.data, fwd.cols, tr.data,
                                           tr.cols))
        n_col, n_row = fwd.n_col_blocks * size, fwd.n_row_blocks * size
        worst = {"ell_mm": 0.0, "ell_hvp_mm": 0.0}
        for k in MULTI_S:
            for with_c in (False, True):
                strided = (k + with_c) % 2 == 1
                V = block(n_col, k, 10 * k + with_c, strided)
                U = block(n_row, k, 10 * k + with_c + 5, strided)
                c = (torch.rand(n_col, device=dev) if with_c else None)
                cases = [
                    ("ell_mm", sparse_hvp.ell_mm(data, cols, V, c),
                     ref.ref_ell_mm(data, cols, V, c)),
                    ("ell_mm", sparse_hvp.ell_mm(dataT, colsT, U),
                     ref.ref_ell_mm(dataT, colsT, U)),
                    ("ell_hvp_mm", sparse_hvp.ell_hvp_mm(dataT, colsT, U, c),
                     ref.ref_ell_hvp_mm_t(dataT, colsT, U, c)),
                    ("ell_hvp_mm", sparse_hvp.ell_hvp_mm(dataT, colsT, U, c),
                     sparse_hvp.ell_mm(data, cols,
                                       sparse_hvp.ell_mm(dataT, colsT, U),
                                       c))]
                torch.cuda.synchronize()
                for name, got, want in cases:
                    worst[name] = max(worst[name],
                                      record_err(errs, name, got, want))
        for name, e in worst.items():
            check(e <= REL_TOL_KERNEL, f"{name} {size}x{size} s in "
                  f"{list(MULTI_S)}, c and strided blocks: worst rel err "
                  f"{e:.2e}")
    for d, n in DENSE_SHAPES:
        g = torch.Generator(device=dev).manual_seed(d * n)
        Xd = torch.randn((d, n), generator=g, device=dev) / d ** 0.5
        c = torch.rand(n, generator=g, device=dev)
        worst = {"xt_multi": 0.0, "x_cz_multi": 0.0}
        for k in MULTI_S:
            U = block(d, k, k, strided=k % 2 == 1)
            Z = block(n, k, k + 1, strided=k % 2 == 0)
            cases = [("xt_multi", glm_hvp.xt_multi(Xd, U),
                      ref.ref_xt_multi(Xd, U)),
                     ("x_cz_multi", glm_hvp.x_cz_multi(Xd, c, Z),
                      ref.ref_x_cz_multi(Xd, c, Z)),
                     ("x_cz_multi", glm_hvp.x_cz_multi(Xd, None, Z),
                      ref.ref_x_cz_multi(Xd, None, Z))]
            torch.cuda.synchronize()
            for name, got, want in cases:
                worst[name] = max(worst[name],
                                  record_err(errs, name, got, want))
        for name, e in worst.items():
            check(e <= REL_TOL_KERNEL, f"{name} {d}x{n} s in "
                  f"{list(MULTI_S)}: worst rel err {e:.2e}")


def phase_fused_multi_kernel(torch, glm_hvp, ref, errs) -> None:
    """x_c_xt_multi at DENSE_SHAPES, s in MULTI_S, with and without c, on
    contiguous and strided (first s of s + 1 columns) U, on every cluster
    size its fit rule allows: against its plain version, repeatable bit
    for bit;
    then column k against x_c_xt_u on U[:, k], and the whole against the
    xt_multi + x_cz_multi pair. Relative L2 throughout (the sums cancel in
    places, so no elementwise tolerance). One check line per shape."""
    dev = torch.device("cuda")
    for d, n in DENSE_SHAPES:
        g = torch.Generator(device=dev).manual_seed(3 * d + n)
        X = torch.randn((d, n), generator=g, device=dev) / d ** 0.5
        c = torch.rand(n, generator=g, device=dev)
        worst, same, widths = 0.0, True, set()
        worst_col, worst_pair = 0.0, 0.0
        for k in MULTI_S:
            B = torch.randn((d, k + 1), generator=g, device=dev)
            for U in (B[:, :k].contiguous(), B[:, :k]):
                for cc in (None, c):
                    want = ref.ref_x_c_xt_multi(X, cc, U)
                    for q in glm_hvp.CLUSTER_SIZES:
                        if glm_hvp.fused_plan(d, k, q) is None:
                            continue
                        widths.add(q)
                        got = glm_hvp.x_c_xt_multi(X, cc, U, _cluster=q)
                        again = glm_hvp.x_c_xt_multi(X, cc, U, _cluster=q)
                        torch.cuda.synchronize()
                        worst = max(worst, record_err(errs, "x_c_xt_multi",
                                                      got, want))
                        same &= bool(torch.equal(got, again))
            Y = glm_hvp.x_c_xt_multi(X, c, U)
            pair = glm_hvp.x_cz_multi(X, c, glm_hvp.xt_multi(X, U))
            torch.cuda.synchronize()
            worst_pair = max(worst_pair,
                             record_err(errs, "x_c_xt_multi", Y, pair))
            for j in range(k):
                col = glm_hvp.x_c_xt_u(X, c, U[:, j].contiguous())
                worst_col = max(worst_col, rel_err(Y[:, j], col))
        check(worst <= REL_TOL_KERNEL and same and worst_col <= REL_TOL_KERNEL
              and worst_pair <= REL_TOL_KERNEL,
              f"x_c_xt_multi {d}x{n} s in {list(MULTI_S)}, c and strided U, "
              f"clusters of {sorted(widths)}: worst rel err {worst:.2e}, "
              f"repeatable {same}; columns vs x_c_xt_u {worst_col:.2e}; vs "
              f"the xt_multi + x_cz_multi pair {worst_pair:.2e}")


def bf16_dense_views(torch, dev, d, n, seed) -> dict:
    """bf16 X of (d, n) as the checks take it, on both copy paths: whole
    rows (bulk when n % 8 == 0), a column view at offset 1 (not 16-byte
    aligned: direct) and one at offset 8 of rows of n + 8 (bulk when
    n % 8 == 0), and rows of n + 4 (a row stride not a multiple of 8:
    direct)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    wide = (torch.randn((d, n + 8), generator=g, device=dev)
            / d ** 0.5).to(torch.bfloat16)
    odd = (torch.randn((d, n + 4), generator=g, device=dev)
           / d ** 0.5).to(torch.bfloat16)
    return {"rows": wide[:, :n].contiguous(), "view_at_1": wide[:, 1:n + 1],
            "view_at_8": wide[:, 8:], "ld_n+4": odd[:, :n]}


def phase_dense_bf16_kernels(torch, glm_hvp, ops, ref, errs) -> None:
    """The four bf16 dense instances at DENSE_SHAPES on bf16 X, each shape
    as whole rows, column views at offsets 1 and 8 and rows of a stride
    not a multiple of 8, against their plain versions at bf16 (relative L2
    <= 1e-5: the products are exact in f32), each call repeated bit for
    bit; K3 and K4 with and without c on the copy path the shape calls for
    (``glm_hvp.dense_path``); K8 and K9 through the ops at s in
    BF16_MULTI_S (13: two launches) on strided blocks, K9 with and
    without c. One check line per shape and view."""
    dev = torch.device("cuda")
    for d, n in DENSE_SHAPES:
        g = torch.Generator(device=dev).manual_seed(7 * d + n)
        u = torch.randn(d, generator=g, device=dev)
        z = torch.randn(n, generator=g, device=dev)
        c = torch.rand(n, generator=g, device=dev)
        Ub = torch.randn((d, 14), generator=g, device=dev)
        Zb = torch.randn((n, 14), generator=g, device=dev)
        for view, X in bf16_dense_views(torch, dev, d, n, d + n).items():
            worst = dict.fromkeys(DENSE_BF16, 0.0)
            same, paths = True, set()

            def held(name, fn, want):
                nonlocal same
                got, again = fn(), fn()
                torch.cuda.synchronize()
                worst[name] = max(worst[name],
                                  record_err(errs, name, got, want))
                same &= bool(torch.equal(got, again))

            held("xt_u_bf16", lambda: glm_hvp.xt_u(X, u), ref.ref_xt_u(X, u))
            paths.add(glm_hvp.last_path["xt_u_bf16"])
            for cc in (None, c):
                held("x_cz_bf16", lambda: glm_hvp.x_cz(X, cc, z),
                     ref.ref_x_cz(X, z if cc is None else cc * z))
                paths.add(glm_hvp.last_path["x_cz_bf16"])
            for k in BF16_MULTI_S:
                U, Z = Ub[:, :k], Zb[:, :k]
                held("xt_multi_bf16", lambda: ops.xt_multi(X, U),
                     ref.ref_xt_multi(X, U))
                for cc in (None, c):
                    held("x_cz_multi_bf16", lambda: ops.x_cz_multi(X, cc, Z),
                         ref.ref_x_cz_multi(X, cc, Z))
            want_path = glm_hvp.dense_path(X, c, z)
            check(max(worst.values()) <= REL_TOL_KERNEL and same
                  and paths == {want_path},
                  f"bf16 dense {d}x{n} {view}: worst rel err "
                  + ", ".join(f"{k} {e:.2e}" for k, e in worst.items())
                  + f"; repeatable {same}; K3/K4 path {sorted(paths)} (want "
                  f"{want_path})")


def multi_views(torch, dev, d, n, seed, dtype) -> dict:
    """X of (d, n) at ``dtype`` as whole rows, column views at offsets 1,
    4 and 8 of rows of n + 8, and rows of n + 4 (a stride not a multiple
    of 8): the bulk path where rows are whole 16-byte units and X is
    aligned, the direct path elsewhere."""
    g = torch.Generator(device=dev).manual_seed(seed)
    wide = (torch.randn((d, n + 8), generator=g, device=dev)
            / d ** 0.5).to(dtype)
    odd = (torch.randn((d, n + 4), generator=g, device=dev)
           / d ** 0.5).to(dtype)
    return {"rows": wide[:, :n].contiguous(), "view_at_1": wide[:, 1:n + 1],
            "view_at_4": wide[:, 4:n + 4], "view_at_8": wide[:, 8:],
            "ld_n+4": odd[:, :n]}


MULTI_CTAS = (None, 3, 1000)    # the card's count, fewer and more than pieces
MULTI_PATH_S = tuple(range(1, MAX_COLS + 1)) + (13,)


def phase_multi_paths(torch, glm_hvp, ops, ref, errs) -> None:
    """K8 ``xt_multi`` and K9 ``x_cz_multi`` (``csrc/dense_multi.cuh``) at
    DENSE_SHAPES at both tile types, each shape as whole rows, column views
    at offsets 1, 4 and 8 and rows of a stride not a multiple of 8, at
    s = 1 .. 8 and 13 (two launches through the ops) on contiguous and
    strided blocks, K9 with and without c, on the card's CTA count and
    forced to 3 and 1,000 CTAs (fewer and more than the pieces): within
    1e-5 of the plain versions, each call repeated bit for bit, on the
    copy path ``glm_hvp.dense_path(X)`` predicts. One check line per shape,
    type and view."""
    dev = torch.device("cuda")
    for d, n in DENSE_SHAPES:
        g = torch.Generator(device=dev).manual_seed(3 * d + n)
        c = torch.rand(n, generator=g, device=dev)
        Ub = torch.randn((d, 14), generator=g, device=dev)
        Zb = torch.randn((n, 14), generator=g, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            tag = "" if dtype == torch.float32 else "_bf16"
            for view, X in multi_views(torch, dev, d, n, d * n,
                                       dtype).items():
                worst = {"xt_multi": 0.0, "x_cz_multi": 0.0}
                same, paths = True, set()
                for k in MULTI_PATH_S:
                    for strided in (False, True):
                        U = Ub[:, :k] if strided else Ub[:, :k].contiguous()
                        Z = Zb[:, :k] if strided else Zb[:, :k].contiguous()
                        cases = [("xt_multi", None, ref.ref_xt_multi(X, U))]
                        cases += [("x_cz_multi", cc,
                                   ref.ref_x_cz_multi(X, cc, Z))
                                  for cc in (None, c)]
                        for ctas in MULTI_CTAS if k <= MAX_COLS else (None,):
                            for name, cc, want in cases:
                                if name == "xt_multi":
                                    fn = ((lambda: glm_hvp.xt_multi(
                                        X, U, _ctas=ctas)) if k <= MAX_COLS
                                        else (lambda: ops.xt_multi(X, U)))
                                else:
                                    fn = ((lambda: glm_hvp.x_cz_multi(
                                        X, cc, Z, _ctas=ctas))
                                        if k <= MAX_COLS
                                        else (lambda: ops.x_cz_multi(
                                            X, cc, Z)))
                                got = fn()
                                paths.add(glm_hvp.last_path[name + tag])
                                again = fn()
                                torch.cuda.synchronize()
                                worst[name] = max(worst[name], record_err(
                                    errs, name + tag, got, want))
                                same &= bool(torch.equal(got, again))
                want_path = glm_hvp.dense_path(X)
                check(max(worst.values()) <= REL_TOL_KERNEL and same
                      and paths == {want_path},
                      f"K8/K9{tag or ' f32'} {d}x{n} {view} s in 1-8, 13, "
                      f"contiguous and strided, c and none, ctas "
                      f"{list(MULTI_CTAS)}: worst rel err "
                      + ", ".join(f"{k} {e:.2e}" for k, e in worst.items())
                      + f"; repeatable {same}; path {sorted(paths)} (want "
                      f"{want_path})")


def check_dense_fused_bf16(torch, glm_hvp, ref, X, c, U, got, cz) -> dict:
    """A bf16 K5 (U a vector) or K10 call held in its two halves: its
    hand-off ``cz`` (rounded c .* z) against the plain hand-off and the
    bf16 two-pass pair's pass A (K3 / K8), roundings of values within the
    f32 summation slack aside (``ref.dense_handoff_flips``; the rate of
    such elements against the plain version is held by the caller over
    its calls, ``ref.handoff_rate_ok``: the pair's K3 / K8 sum rows in
    order, so more of its elements sit across a tie, each within the
    slack); its output against the plain pass B of its
    own hand-off and the pair's pass B (K4 / K9) on it. Returns the rel
    errors, the flips, the elements and the end-to-end rel err against
    the whole plain version."""
    t = ref.ref_dense_handoff(X, c, U)
    slack = ref.dense_handoff_slack(X, c, U, t)
    cz = cz.reshape(t.shape)
    flips, ties = ref.dense_handoff_flips(cz, t, slack)
    if U.dim() == 1:
        pz = glm_hvp.xt_u(X, U)
        tp = pz if c is None else c * pz
        want, pair_y = ref.ref_x_cz(X, cz), glm_hvp.x_cz(X, None, cz)
        whole = ref.ref_x_cz(X, t)
    else:
        pz = glm_hvp.xt_multi(X, U)
        tp = pz if c is None else c[:, None] * pz
        want = ref.ref_x_cz_multi(X, None, cz)
        pair_y = glm_hvp.x_cz_multi(X, None, cz)
        whole = ref.ref_x_cz_multi(X, None, t)
    pflips, pties = ref.dense_handoff_flips(cz, tp, slack)
    torch.cuda.synchronize()
    return dict(rel=rel_err(got, want), abs=float((got - want).abs().max()),
                pair_rel=rel_err(got, pair_y), flips=flips,
                pair_flips=pflips, ties=ties and pties, numel=t.numel(),
                end_to_end=rel_err(got, whole))


def record_fused_bf16(errs, name, r) -> None:
    """Keep a bf16 fused call's halves in the kernel's worst errors."""
    rec = errs[name]
    rec["rel"] = max(rec["rel"], r["rel"], r["pair_rel"])
    rec["abs"] = max(rec["abs"], r["abs"])
    rec["end_to_end"] = max(rec.get("end_to_end", 0.0), r["end_to_end"])
    rec["flips"] = rec.get("flips", 0) + r["flips"]


def phase_dense_fused_bf16_kernels(torch, glm_hvp, ref, errs) -> None:
    """The bf16 K5 and K10 at DENSE_SHAPES on bf16 X, each shape as whole
    rows, column views at offsets 1 and 8 and rows of another stride
    (:func:`bf16_dense_views`), on every cluster size the bf16 fit rule
    allows: K5 with and without c, K10 at s in MULTI_S on contiguous and
    strided U, with and without c; each call held in its two halves
    (:func:`check_dense_fused_bf16`, against the plain version and the
    bf16 two-pass pair at REL_TOL_KERNEL), repeated bit for bit, on the
    copy path ``glm_hvp.fused_path`` predicts. One check line per shape
    and view."""
    dev = torch.device("cuda")
    bf = torch.bfloat16
    for d, n in DENSE_SHAPES:
        g = torch.Generator(device=dev).manual_seed(11 * d + n)
        u = torch.randn(d, generator=g, device=dev)
        c = torch.rand(n, generator=g, device=dev)
        Ub = torch.randn((d, MAX_COLS + 1), generator=g, device=dev)
        for view, X in bf16_dense_views(torch, dev, d, n, d + 2 * n).items():
            worst = dict(rel=0.0, pair_rel=0.0, end_to_end=0.0)
            flips, pflips, numel = 0, 0, 0
            ties, same, paths, sizes = True, True, set(), set()

            def held(name, fn, Uv, cc):
                nonlocal flips, pflips, numel, ties, same
                cz = torch.zeros((n,) if Uv.dim() == 1 else (n, Uv.shape[1]),
                                 device=dev)
                got, again = fn(cz), fn(None)
                paths.add(glm_hvp.last_path[name])
                torch.cuda.synchronize()
                r = check_dense_fused_bf16(torch, glm_hvp, ref, X, cc, Uv,
                                           got, cz)
                record_fused_bf16(errs, name, r)
                for k in worst:
                    worst[k] = max(worst[k], r[k])
                flips += r["flips"]
                pflips += r["pair_flips"]
                numel += r["numel"]
                ties &= r["ties"]
                same &= bool(torch.equal(got, again))

            for q in glm_hvp.CLUSTER_SIZES:
                if glm_hvp.fused_plan(d, 1, q, dtype=bf) is not None:
                    sizes.add(q)
                    for cc in (None, c):
                        held("x_c_xt_u_bf16",
                             lambda cz: glm_hvp.x_c_xt_u(
                                 X, cc, u, cz_out=cz, _cluster=q), u, cc)
                for k in MULTI_S:
                    if glm_hvp.fused_plan(d, k, q, dtype=bf) is None:
                        continue
                    sizes.add(q)
                    for U in (Ub[:, :k].contiguous(), Ub[:, :k]):
                        for cc in (None, c):
                            held("x_c_xt_multi_bf16",
                                 lambda cz: glm_hvp.x_c_xt_multi(
                                     X, cc, U, cz_out=cz, _cluster=q), U, cc)
            want_path = glm_hvp.fused_path(X)
            rate = ref.handoff_rate_ok(flips, numel)
            check(max(worst["rel"], worst["pair_rel"]) <= REL_TOL_KERNEL
                  and ties and rate and same and paths == {want_path},
                  f"bf16 x_c_xt_u / x_c_xt_multi {d}x{n} {view}, clusters "
                  f"of {sorted(sizes)}, c, s in {list(MULTI_S)} contiguous "
                  f"and strided: rel err of y against the plain and the "
                  f"pair's pass B on the kernel's hand-off {worst['rel']:.2e}"
                  f" / {worst['pair_rel']:.2e}, hand-off elements off the "
                  f"plain / pair rounding {flips} / {pflips} of {numel} "
                  f"(all within the slack {ties}), "
                  f"end-to-end rel err {worst['end_to_end']:.2e}, "
                  f"repeatable {same}, path {sorted(paths)} (want "
                  f"{want_path})")


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def measure_kernels(torch, solver, sparse_hvp, ref, errs) -> dict:
    """Full-width timings and checks on the first run's layouts
    (DiSCO-S, m = 1), ell_mv with the solver's schedules as the main path
    passes them."""
    dev = solver.device
    data, cols = solver.ell_data[0], solver.ell_cols[0]
    dataT, colsT = solver.ell_dataT[0], solver.ell_colsT[0]
    sched, schedT = solver.ell_sched[0], solver.ell_schedT[0]
    nrb, W, br, bc = data.shape
    ncb, WT = dataT.shape[:2]
    g = torch.Generator(device=dev).manual_seed(1)
    # first-step quantities: w = 0, so phi'' = 1/4 and phi' = -y/2
    wts, yv = solver.weights[0], solver.y[0]
    c = 0.25 * wts
    d1 = -0.5 * yv * wts
    u = torch.randn(nrb * br, generator=g, device=dev)

    grad_k = sparse_hvp.ell_mv(data, cols, d1, sched=sched)
    grad_p = ref.ref_ell_mv(data, cols, d1)
    hvp2_k = sparse_hvp.ell_mv(
        data, cols, sparse_hvp.ell_mv(dataT, colsT, u, sched=schedT), c,
        sched=sched)
    hvp2_p = ref.ref_ell_mv(data, cols, ref.ref_ell_mv(dataT, colsT, u), c)
    hs = solver.ell_hvp_sched[0]
    variants = hvp_variants(sparse_hvp, dataT, colsT, schedT, hs)
    hvpf_k = sparse_hvp.ell_hvp(dataT, colsT, u, c, sched=hs)
    hvpf_p = ref.ref_ell_hvp_t(dataT, colsT, u, c)
    cases = [("full-width gradient", "ell_mv", grad_k, grad_p),
             ("full-width two-pass HVP", "ell_mv", hvp2_k, hvp2_p),
             ("full-width fused HVP", "ell_hvp", hvpf_k, hvpf_p),
             ("full-width fused HVP vs the ell_mv pair", "ell_hvp", hvpf_k,
              hvp2_k)]
    cases += [(f"full-width fused HVP, {name}", "ell_hvp",
               sparse_hvp.ell_hvp(dataT, colsT, u, c, sched=sc), hvpf_p)
              for name, sc in variants.items()]
    torch.cuda.synchronize()
    for name, kname, got, want in cases:
        e = record_err(errs, kname, got, want)
        check(e <= REL_TOL_KERNEL, f"{name}: rel err {e:.2e}")
    del grad_p, hvp2_p, hvpf_p, cases

    tiles_f, tiles_t = nonempty_tiles(data), nonempty_tiles(dataT)
    v = torch.randn(ncb * bc, generator=g, device=dev)
    out = {}
    # ell_mv on the forward layout without c: the gradient product X d1,
    # the shape the block-sparse library call computes too. The bytes
    # are those the kernel reads: the live tiles (with the schedule, as
    # the main path calls it), cols, v and y.
    ms = time_ms(lambda: sparse_hvp.ell_mv(data, cols, v, sched=sched))
    ms_t = time_ms(lambda: sparse_hvp.ell_mv(dataT, colsT, u, sched=schedT))
    ms_c = time_ms(lambda: sparse_hvp.ell_mv(data, cols, v, c, sched=sched))
    plain = time_ms(lambda: ref.ref_ell_mv(data, cols, v))
    live = schedule_tiles(sparse_hvp, sched, nrb)
    layout_bytes = 4 * (live * br * bc + cols.numel() + v.numel() + nrb * br)
    bms, by = bound_ms(tiles_f, br * bc, cols.numel() * 4 + v.numel() * 4
                       + nrb * br * 4, 2)
    lib = library_bsr_ms(torch, data, cols, v)
    lib_t = library_bsr_ms(torch, dataT, colsT, u)
    out["ell_mv"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        bytes=layout_bytes, gbps=layout_bytes / ms / 1e6,
        ms_transposed=ms_t, library_ms_transposed=lib_t,
        bsr_factor=ms / lib if lib else None,
        bsr_factor_transposed=ms_t / lib_t if lib_t else None,
        ms_forward_with_c=ms_c,
        **schedule_detail(torch, sparse_hvp, "ell_mv", data, cols, dataT,
                          colsT, sched, schedT, (v,), (u,)),
        shape=[nrb, W, br, bc])
    # ell_hvp on the transposed layout with c: the fused HVP, with the
    # solver's step schedule as the main path passes it. Its bytes: the
    # live tiles, colsT, u, c and y, each once.
    ms = time_ms(lambda: sparse_hvp.ell_hvp(dataT, colsT, u, c, sched=hs))
    plain = time_ms(lambda: ref.ref_ell_hvp_t(dataT, colsT, u, c))
    two_pass = time_ms(lambda: sparse_hvp.ell_mv(
        data, cols, sparse_hvp.ell_mv(dataT, colsT, u, sched=schedT), c,
        sched=sched))
    live_t = schedule_tiles(sparse_hvp, schedT, ncb)
    live_bytes = 4 * (live_t * br * bc + colsT.numel() + u.numel()
                      + c.numel() + nrb * br)
    bms, by = bound_ms(tiles_t, br * bc, colsT.numel() * 4 + u.numel() * 4
                       + c.numel() * 4 + nrb * br * 4, 4)
    out["ell_hvp"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
        bytes=live_bytes, gbps=live_bytes / ms / 1e6,
        share_of_bound=bms / ms, two_pass_ell_mv_ms=two_pass,
        **{f"ms_{k}": time_ms(lambda: sparse_hvp.ell_hvp(
            dataT, colsT, u, c, sched=sc)) for k, sc in variants.items()},
        **hvp_schedule_detail(torch, hs, variants), tiles_nonempty=tiles_t,
        tiles_live=live_t, tiles_stored=ncb * WT, shape=[ncb, WT, bc, br])
    for name, m in out.items():
        print(f"{name} full width {m['shape']}: {m['ms'] * 1e3:.1f} us/call,"
              f" {m['gbps']:.0f} GB/s over {m['bytes'] / 1e9:.2f} GB read,"
              f" bound {m['bound_ms'] * 1e3:.1f} us ({m['bound_by']}),"
              f" plain {m['plain_ms'] * 1e3:.1f} us,"
              f" library {m['library_ms']}", flush=True)
    print_schedule_detail("ell_mv", out["ell_mv"])
    print_hvp_detail("ell_hvp", out["ell_hvp"], "two_pass_ell_mv_ms")
    return out


def hvp_variants(sparse_hvp, dataT, colsT, schedT, hs) -> dict:
    """The two variants of the solver's step schedule ``hs`` that K2 and
    K7 are timed with: one step over the whole layout (pass B reads from
    device memory again: what the L2 reuse buys) and half the chosen
    step_bytes."""
    live = sparse_hvp.schedule_parts(schedT, dataT.shape[0])[0]
    return {k: sparse_hvp.ell_hvp_schedule(dataT, colsT, hs.ctas, sb,
                                           live=live)
            for k, sb in (("one_step", 1 << 40),
                          ("half_step_bytes", hs.step_bytes // 2))}


def hvp_schedule_detail(torch, hs, variants) -> dict:
    """The step schedules' sizes: steps, step_bytes, CTAs, and the card's
    L2 bytes."""
    out = dict(steps=hs.steps, step_bytes=hs.step_bytes, ctas=hs.ctas,
               l2_bytes=torch.cuda.get_device_properties(0).L2_cache_size)
    for k, sc in variants.items():
        out[f"steps_{k}"], out[f"step_bytes_{k}"] = sc.steps, sc.step_bytes
    return out


def print_hvp_detail(name, m, pair_key) -> None:
    keys = ("share_of_bound", pair_key, "ms_one_step",
            "ms_half_step_bytes", "steps", "step_bytes", "ctas", "l2_bytes",
            "steps_one_step", "steps_half_step_bytes", "tiles_live",
            "tiles_stored")
    print(f"{name} steps " + json.dumps({k: m[k] for k in keys}),
          flush=True)


def schedule_tiles(sparse_hvp, sched, nb) -> int:
    """Live tiles of a schedule of ``nb`` row-blocks."""
    return int(sparse_hvp.schedule_parts(sched, nb)[1][-1])


def schedule_detail(torch, sparse_hvp, name, data, cols, dataT, colsT,
                    sched, schedT, fwd_args, tr_args) -> dict:
    """K1's or K6's (``name``) schedule on both layouts: the copy path,
    the tiles the layouts store, hold nonzeros and count live (the
    schedule's sum), the time of building the schedule, and the kernel's
    time with the schedule, with every slot live (no schedule) and with
    twice the CTAs. ``*_args``: the vector (K1) or block (K6) of each
    layout."""
    launch = getattr(sparse_hvp, name)
    launch(data, cols, *fwd_args, sched=sched)
    path = sparse_hvp.last_path[name]
    sms = torch.cuda.get_device_properties(data.device).multi_processor_count
    out = dict(path=path, ctas=int(sched.numel() - 2 * data.shape[0] - 2),
               sms=sms)
    for tag, d, c, sc, args in (("forward", data, cols, sched, fwd_args),
                                ("transposed", dataT, colsT, schedT,
                                 tr_args)):
        nb, w = d.shape[:2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc2 = sparse_hvp.ell_schedule(d, c, 2 * sms)
        torch.cuda.synchronize()
        out[f"{tag}_schedule_build_ms"] = (time.perf_counter() - t0) * 1e3
        out[f"{tag}_tiles_stored"] = nb * w
        out[f"{tag}_tiles_nonempty"] = nonempty_tiles(d)
        out[f"{tag}_tiles_live"] = schedule_tiles(sparse_hvp, sc, nb)
        out[f"{tag}_ms_scheduled"] = time_ms(
            lambda: launch(d, c, *args, sched=sc))
        out[f"{tag}_ms_every_slot"] = time_ms(lambda: launch(d, c, *args))
        out[f"{tag}_ms_2x_ctas"] = time_ms(
            lambda: launch(d, c, *args, sched=sc2))
        del sc2
    out.update(tiles_nonempty=out["forward_tiles_nonempty"],
               tiles_stored=out["forward_tiles_stored"])
    return out


def print_schedule_detail(name, m) -> None:
    keys = ("path", "ctas", "sms") + tuple(
        f"{t}_{k}" for t in ("forward", "transposed")
        for k in ("tiles_stored", "tiles_nonempty", "tiles_live",
                  "schedule_build_ms", "ms_scheduled", "ms_every_slot",
                  "ms_2x_ctas"))
    print(f"{name} schedule " + json.dumps({k: m[k] for k in keys}),
          flush=True)


def library_bsr_ms(torch, data, cols, v):
    """Time of PyTorch's block-sparse (BSR) matrix product for the same
    A v (v of shape (n,) or (n, s)), from the layout's nonempty tiles;
    None if the card's PyTorch cannot run it. On bf16 tiles v is rounded
    to bf16 as the kernels round it and the product is bf16, so it is
    held to the f32-sum version at 1e-2, not 1e-4. A yardstick only: the
    port never calls it."""
    nrb, W, br, bc = data.shape
    keep = (data.reshape(nrb, W, -1) != 0).any(dim=2)
    counts = keep.sum(dim=1)
    crow = torch.zeros(nrb + 1, dtype=torch.int64, device=data.device)
    crow[1:] = torch.cumsum(counts, 0)
    try:
        bsr = torch.sparse_bsr_tensor(
            crow, cols[keep].to(torch.int64), data[keep],
            size=(nrb * br, v.shape[0]))
        vv = v.reshape(v.shape[0], -1).to(data.dtype)
        got = (bsr @ vv).float()
        want = torch.einsum("iwab,iwbs->ias", data.float(),
                            vv.float().reshape(-1, bc, vv.shape[1])[
                                cols.long()]).reshape(got.shape)
        tol = 1e-4 if data.dtype == torch.float32 else 1e-2
        if rel_err(got, want) > tol:
            print("library BSR product disagrees; not timed")
            return None
        return time_ms(lambda: bsr @ vv)
    except (RuntimeError, NotImplementedError, TypeError) as exc:
        print(f"library BSR product unavailable on this card's torch: "
              f"{str(exc).splitlines()[0][:200]}")
        return None


def measure_sparse_multi(torch, solver, sparse_hvp, ref, errs) -> dict:
    """Full-width checks and timings of ell_mm and ell_hvp_mm at TIMED_S
    columns on the first run's layouts (DiSCO-S, m = 1), U a strided view
    of a wider block as DiSCO-F passes it."""
    dev = solver.device
    data, cols = solver.ell_data[0], solver.ell_cols[0]
    dataT, colsT = solver.ell_dataT[0], solver.ell_colsT[0]
    sched, schedT = solver.ell_sched[0], solver.ell_schedT[0]
    nrb, W, br, bc = data.shape
    ncb, WT = dataT.shape[:2]
    s = TIMED_S
    g = torch.Generator(device=dev).manual_seed(4)
    c = 0.25 * solver.weights[0]
    V = torch.randn((ncb * bc, s + 1), generator=g, device=dev)[:, :s]
    U = torch.randn((nrb * br, s + 1), generator=g, device=dev)[:, :s]
    two_k = sparse_hvp.ell_mm(
        data, cols, sparse_hvp.ell_mm(dataT, colsT, U, sched=schedT), c,
        sched=sched)
    two_p = ref.ref_ell_mm(data, cols, ref.ref_ell_mm(dataT, colsT, U), c)
    hs = solver.ell_hvp_sched[0]
    variants = hvp_variants(sparse_hvp, dataT, colsT, schedT, hs)
    fused_k = sparse_hvp.ell_hvp_mm(dataT, colsT, U, c, sched=hs)
    fused_p = ref.ref_ell_hvp_mm_t(dataT, colsT, U, c)
    fwd_k = sparse_hvp.ell_mm(data, cols, V, sched=sched)
    fwd_p = ref.ref_ell_mm(data, cols, V)
    cases = [("forward", "ell_mm", fwd_k, fwd_p),
             ("two-pass HVP", "ell_mm", two_k, two_p),
             ("fused HVP", "ell_hvp_mm", fused_k, fused_p),
             ("fused HVP vs the ell_mm pair", "ell_hvp_mm", fused_k, two_k)]
    cases += [(f"fused HVP, {name}", "ell_hvp_mm", sparse_hvp.ell_hvp_mm(
        dataT, colsT, U, c, sched=sc), fused_p)
        for name, sc in variants.items()]
    torch.cuda.synchronize()
    for what, kname, got, want in cases:
        e = record_err(errs, kname, got, want)
        check(e <= REL_TOL_KERNEL, f"{kname} full width s={s} {what}: rel "
                                   f"err {e:.2e}")
    del cases
    check(bool(torch.equal(fwd_k, sparse_hvp.ell_mm(data, cols, V,
                                                    sched=sched))),
          "ell_mm full width: repeatable bit for bit")
    del two_k, two_p, fused_k, fused_p, fwd_k, fwd_p

    tiles_f, tiles_t = nonempty_tiles(data), nonempty_tiles(dataT)
    out = {}
    ms = time_ms(lambda: sparse_hvp.ell_mm(data, cols, V, sched=sched))
    ms_t = time_ms(lambda: sparse_hvp.ell_mm(dataT, colsT, U, sched=schedT))
    live = schedule_tiles(sparse_hvp, sched, nrb)
    layout_bytes = 4 * (live * br * bc + cols.numel() + V.numel()
                        + nrb * br * s)
    bms, by = bound_ms(tiles_f, br * bc, 4 * (cols.numel() + V.numel()
                                              + nrb * br * s), 2 * s)
    lib = library_bsr_ms(torch, data, cols, V.contiguous())
    lib_t = library_bsr_ms(torch, dataT, colsT, U.contiguous())
    out["ell_mm"] = dict(
        ms=ms, plain_ms=time_ms(lambda: ref.ref_ell_mm(data, cols, V)),
        bound_ms=bms, bound_by=by, library_ms=lib,
        bytes=layout_bytes, gbps=layout_bytes / ms / 1e6,
        ms_transposed=ms_t, library_ms_transposed=lib_t,
        bsr_factor=ms / lib if lib else None,
        bsr_factor_transposed=ms_t / lib_t if lib_t else None,
        ms_forward_with_c=time_ms(
            lambda: sparse_hvp.ell_mm(data, cols, V, c, sched=sched)),
        ms_by_s={k: time_ms(lambda: sparse_hvp.ell_mm(
            data, cols, V[:, :k], sched=sched)) for k in (1, 2, 4)},
        ell_mv_ms=time_ms(lambda: sparse_hvp.ell_mv(
            data, cols, V[:, 0].contiguous(), sched=sched)),
        **schedule_detail(torch, sparse_hvp, "ell_mm", data, cols, dataT,
                          colsT, sched, schedT, (V,), (U,)),
        shape=[nrb, W, br, bc, s])
    ms = time_ms(lambda: sparse_hvp.ell_hvp_mm(dataT, colsT, U, c,
                                               sched=hs))
    live_t = schedule_tiles(sparse_hvp, schedT, ncb)
    live_bytes = 4 * (live_t * br * bc + colsT.numel() + U.numel()
                      + c.numel() + nrb * br * s)
    bms, by = bound_ms(tiles_t, br * bc, 4 * (colsT.numel() + U.numel()
                                              + c.numel() + nrb * br * s),
                       4 * s)
    out["ell_hvp_mm"] = dict(
        ms=ms, plain_ms=time_ms(
            lambda: ref.ref_ell_hvp_mm_t(dataT, colsT, U, c)),
        bound_ms=bms, bound_by=by, library_ms=None,
        bytes=live_bytes, gbps=live_bytes / ms / 1e6,
        share_of_bound=bms / ms,
        two_pass_ell_mm_ms=time_ms(lambda: sparse_hvp.ell_mm(
            data, cols, sparse_hvp.ell_mm(dataT, colsT, U, sched=schedT), c,
            sched=sched)),
        **{f"ms_{k}": time_ms(lambda: sparse_hvp.ell_hvp_mm(
            dataT, colsT, U, c, sched=sc)) for k, sc in variants.items()},
        **hvp_schedule_detail(torch, hs, variants), tiles_nonempty=tiles_t,
        tiles_live=live_t, tiles_stored=ncb * WT,
        shape=[ncb, WT, bc, br, s])
    for name, m in out.items():
        print(f"{name} full width {m['shape']}: {m['ms'] * 1e3:.1f} us/call,"
              f" {m['gbps']:.0f} GB/s over {m['bytes'] / 1e9:.2f} GB read,"
              f" bound {m['bound_ms'] * 1e3:.1f} us ({m['bound_by']}),"
              f" plain {m['plain_ms'] * 1e3:.1f} us,"
              f" library {m['library_ms']}", flush=True)
    print("ell_mm detail " + json.dumps(
        {k: out["ell_mm"][k] for k in ("ms_transposed",
                                       "library_ms_transposed", "bsr_factor",
                                       "bsr_factor_transposed",
                                       "ms_forward_with_c", "ms_by_s",
                                       "ell_mv_ms")})
          + " ell_hvp_mm two-pass pair "
          + json.dumps(out["ell_hvp_mm"]["two_pass_ell_mm_ms"]), flush=True)
    print_schedule_detail("ell_mm", out["ell_mm"])
    print_hvp_detail("ell_hvp_mm", out["ell_hvp_mm"], "two_pass_ell_mm_ms")
    return out


def measure_bf16_kernels(torch, solver, sparse_hvp, ref, errs,
                         f32) -> dict:
    """The bf16 instances at full width on a bf16 DiSCO-S m = 1 solver's
    copies of the first run's layouts (the f32 layouts cast on the card),
    with the solver's schedules as the main path passes them: held to
    their plain versions (K2 and K7 in their two halves, also against the
    two-pass bf16 pair), then timed beside the plain versions, a bf16 BSR
    product where the card's torch has one, and the f32 kernels' times of
    the same call (``f32``: the f32 timings); bound at 2-byte tiles, GB/s
    over the live bytes."""
    from repro_torch.core import comm
    dev = solver.device
    data, cols = solver.ell_data_h[0], solver.ell_cols[0]
    dataT, colsT = solver.ell_dataT_h[0], solver.ell_colsT[0]
    sched, schedT = solver.ell_sched[0], solver.ell_schedT[0]
    hs = solver.ell_hvp_sched[0]
    nrb, W, br, bc = data.shape
    ncb, WT = dataT.shape[:2]
    s = TIMED_S
    g = torch.Generator(device=dev).manual_seed(1)
    wts, yv = solver.weights[0], solver.y[0]
    c = 0.25 * wts
    d1 = -0.5 * yv * wts
    u = torch.randn(nrb * br, generator=g, device=dev)
    V = torch.randn((ncb * bc, s + 1), generator=g, device=dev)[:, :s]
    U = torch.randn((nrb * br, s + 1), generator=g, device=dev)[:, :s]
    variants = hvp_variants(sparse_hvp, dataT, colsT, schedT, hs)

    cases = [("gradient", "ell_mv_bf16",
              sparse_hvp.ell_mv(data, cols, d1, sched=sched),
              ref.ref_ell_mv(data, cols, d1)),
             ("two-pass HVP", "ell_mv_bf16",
              sparse_hvp.ell_mv(data, cols, sparse_hvp.ell_mv(
                  dataT, colsT, u, sched=schedT), c, sched=sched),
              ref.ref_ell_mv(data, cols, ref.ref_ell_mv(dataT, colsT, u), c)),
             (f"forward s={s}", "ell_mm_bf16",
              sparse_hvp.ell_mm(data, cols, V, sched=sched),
              ref.ref_ell_mm(data, cols, V)),
             (f"two-pass HVP s={s}", "ell_mm_bf16",
              sparse_hvp.ell_mm(data, cols, sparse_hvp.ell_mm(
                  dataT, colsT, U, sched=schedT), c, sched=sched),
              ref.ref_ell_mm(data, cols, ref.ref_ell_mm(dataT, colsT, U), c))]
    torch.cuda.synchronize()
    for what, kname, got, want in cases:
        e = record_err(errs, kname, got, want)
        check(e <= REL_TOL_KERNEL, f"bf16 {kname} full width {what}: rel err "
                                   f"{e:.2e}")
    del cases
    check(bool(torch.equal(sparse_hvp.ell_mv(data, cols, d1, sched=sched),
                           sparse_hvp.ell_mv(data, cols, d1, sched=sched)))
          and bool(torch.equal(sparse_hvp.ell_mm(data, cols, V, sched=sched),
                               sparse_hvp.ell_mm(data, cols, V,
                                                 sched=sched))),
          "bf16 ell_mv / ell_mm full width: repeatable bit for bit")
    pair_u = sparse_hvp.ell_mv(dataT, colsT, u, sched=schedT)[:, None]
    pair_U = sparse_hvp.ell_mm(dataT, colsT, U, sched=schedT)
    for name, sc in [("the solver's step schedule", hs)] + list(
            variants.items()):
        for kname, X in (("ell_hvp_bf16", u[:, None]), ("ell_hvp_mm_bf16",
                                                        U)):
            cz = torch.zeros(ncb * bc * X.shape[1], device=dev)
            if kname == "ell_hvp_bf16":
                got = sparse_hvp.ell_hvp(dataT, colsT, u, c, sched=sc,
                                         cz_out=cz)[:, None]
            else:
                got = sparse_hvp.ell_hvp_mm(dataT, colsT, U, c, sched=sc,
                                            cz_out=cz)
            torch.cuda.synchronize()
            r = check_fused_bf16(torch, sparse_hvp, ref, dataT, colsT, X, c,
                                 got, cz, pair_u if X.shape[1] == 1
                                 else pair_U, (data, cols))
            rec = errs[kname]
            rec["rel"] = max(rec["rel"], r["rel"], r["pair_rel"])
            rec["abs"] = max(rec["abs"], r["abs"])
            rec["end_to_end"] = max(rec.get("end_to_end", 0.0),
                                    r["end_to_end"])
            rec["flips"] = rec.get("flips", 0) + r["flips"]
            check(max(r["rel"], r["pair_rel"]) <= REL_TOL_KERNEL
                  and r["ties"],
                  f"bf16 {kname} full width s={X.shape[1]}, {name}: rel err "
                  f"of y against the plain and the pair's pass B on the "
                  f"kernel's hand-off {r['rel']:.2e} / {r['pair_rel']:.2e};"
                  f" hand-off elements off the plain / pair rounding "
                  f"{r['flips']} / {r['pair_flips']} of {cz.numel()}, all "
                  f"ties {r['ties']}; end-to-end rel err "
                  f"{r['end_to_end']:.2e}")
    del pair_u, pair_U

    tiles_f, tiles_t = nonempty_tiles(data), nonempty_tiles(dataT)
    live = schedule_tiles(sparse_hvp, sched, nrb)
    live_t = schedule_tiles(sparse_hvp, schedT, ncb)
    tb = br * bc * BYTES_BF16
    v = torch.randn(ncb * bc, generator=g, device=dev)
    out = {}

    def row(kname, ms, plain, lib, tiles, live_tiles, other, flops, **kw):
        # bound: the nonempty tiles at 2 bytes an element (the byte model's
        # one pass over one layout), the vectors once, or the f32 flops
        tile_bytes = comm.ell_hvp_bytes(0, tiles, br, bc, fused=True,
                                        dtype_bytes=BYTES_BF16)
        t_bytes = (tile_bytes + other) / HBM_BYTES_PER_S
        t_ops = tiles * br * bc * flops / F32_FLOPS_PER_S
        bms = 1e3 * max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        nbytes = live_tiles * tb + other
        f32_ms = f32[kname[:-len("_bf16")]]["ms"]
        out[kname] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                          library_ms=lib, bytes=nbytes,
                          gbps=nbytes / ms / 1e6, share_of_bound=bms / ms,
                          f32_ms=f32_ms, bf16_over_f32=ms / f32_ms, **kw)

    other = 4 * (cols.numel() + v.numel() + nrb * br)
    row("ell_mv_bf16",
        time_ms(lambda: sparse_hvp.ell_mv(data, cols, v, sched=sched)),
        time_ms(lambda: ref.ref_ell_mv(data, cols, v)),
        library_bsr_ms(torch, data, cols, v), tiles_f, live, other, 2,
        ms_transposed=time_ms(lambda: sparse_hvp.ell_mv(dataT, colsT, u,
                                                        sched=schedT)),
        ms_forward_with_c=time_ms(lambda: sparse_hvp.ell_mv(
            data, cols, v, c, sched=sched)),
        path=sparse_hvp.last_path["ell_mv_bf16"], shape=[nrb, W, br, bc])
    other = 4 * (colsT.numel() + u.numel() + c.numel() + nrb * br)
    row("ell_hvp_bf16",
        time_ms(lambda: sparse_hvp.ell_hvp(dataT, colsT, u, c, sched=hs)),
        time_ms(lambda: ref.ref_ell_hvp_t(dataT, colsT, u, c)), None,
        tiles_t, live_t, other, 4,
        two_pass_ell_mv_ms=time_ms(lambda: sparse_hvp.ell_mv(
            data, cols, sparse_hvp.ell_mv(dataT, colsT, u, sched=schedT), c,
            sched=sched)),
        **{f"ms_{k}": time_ms(lambda: sparse_hvp.ell_hvp(
            dataT, colsT, u, c, sched=sc)) for k, sc in variants.items()},
        **hvp_schedule_detail(torch, hs, variants),
        path=sparse_hvp.last_path["ell_hvp_bf16"], shape=[ncb, WT, bc, br])
    other = 4 * (cols.numel() + V.numel() + nrb * br * s)
    row("ell_mm_bf16",
        time_ms(lambda: sparse_hvp.ell_mm(data, cols, V, sched=sched)),
        time_ms(lambda: ref.ref_ell_mm(data, cols, V)),
        library_bsr_ms(torch, data, cols, V.contiguous()), tiles_f,
        live, other, 2 * s,
        ms_transposed=time_ms(lambda: sparse_hvp.ell_mm(dataT, colsT, U,
                                                        sched=schedT)),
        path=sparse_hvp.last_path["ell_mm_bf16"], shape=[nrb, W, br, bc, s])
    other = 4 * (colsT.numel() + U.numel() + c.numel() + nrb * br * s)
    row("ell_hvp_mm_bf16",
        time_ms(lambda: sparse_hvp.ell_hvp_mm(dataT, colsT, U, c, sched=hs)),
        time_ms(lambda: ref.ref_ell_hvp_mm_t(dataT, colsT, U, c)), None,
        tiles_t, live_t, other, 4 * s,
        two_pass_ell_mm_ms=time_ms(lambda: sparse_hvp.ell_mm(
            data, cols, sparse_hvp.ell_mm(dataT, colsT, U, sched=schedT), c,
            sched=sched)),
        **{f"ms_{k}": time_ms(lambda: sparse_hvp.ell_hvp_mm(
            dataT, colsT, U, c, sched=sc)) for k, sc in variants.items()},
        path=sparse_hvp.last_path["ell_hvp_mm_bf16"],
        shape=[ncb, WT, bc, br, s])
    for name, m in out.items():
        print(f"{name} full width {m['shape']} ({m['path']}): "
              f"{m['ms'] * 1e3:.1f} us/call, {m['gbps']:.0f} GB/s over "
              f"{m['bytes'] / 1e9:.3f} GB read, bound "
              f"{m['bound_ms'] * 1e3:.1f} us ({m['bound_by']}, "
              f"{100 * m['share_of_bound']:.1f}%), plain "
              f"{m['plain_ms'] * 1e3:.1f} us, library {m['library_ms']}, "
              f"f32 {m['f32_ms'] * 1e3:.1f} us ({m['bf16_over_f32']:.3f}x)",
              flush=True)
    print("bf16 detail " + json.dumps({k: {
        key: val for key, val in m.items() if key.startswith(
            ("ms_", "two_pass", "steps", "step_bytes"))}
        for k, m in out.items()}), flush=True)
    return out


def bf16_launches(partition, m, fused, s, steps, iters) -> dict:
    """The sparse kernel launches of a bf16 fit: the margins and the
    gradient on the f32 layouts (one f32 ell_mv each a shard a Newton
    step); PCG's products on the bf16 instances: classic, one HVP an
    iteration (two ell_mv a shard two-pass, one ell_hvp fused, on m = 1
    or DiSCO-S); s-step as :func:`predicted_launches` counts them."""
    if s > 1:
        hvp = predicted_launches(True, partition, m, fused, s, 0, iters)
    else:
        hvp = dict.fromkeys(SPARSE_KERNELS, 0)
        hvp["ell_hvp" if fused else "ell_mv"] = (1 if fused else 2) * m * iters
    n = {f"{k}_bf16": hvp[k] for k in SPARSE_KERNELS}
    n.update(dict.fromkeys(SPARSE_KERNELS, 0), ell_mv=2 * m * steps)
    return n


def bf16_slice_runs(torch, rt, build, sparse_hvp, ref, X, y, f32_w,
                    launches, errs, f32_timings) -> dict:
    """The bf16 runs of the sparse slice (BF16_RUNS), full width: each held
    to the launches the code predicts, f falling every Newton step and the
    f32 m = 1 two-pass w of its partition (``f32_w``) at REL_TOL_W. The
    first run's copies are held and timed first
    (:func:`measure_bf16_kernels`)."""
    timings = None
    for partition, m, fused, s in BF16_RUNS:
        kind = f"s-step s={s} " if s > 1 else ""
        tag = f"bf16 {kind}" + run_tag(partition, m, fused)
        cfg = rt.DiscoConfig(partition=partition, hvp_fused=fused,
                             pcg_block_s=s, hvp_dtype="bfloat16", **SOLVE)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        solver = rt.DiscoSolver(X, y, cfg, group=rt.InProcessGroup(m),
                                device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        if timings is None:
            timings = measure_bf16_kernels(torch, solver, sparse_hvp, ref,
                                           errs, f32_timings)
            torch.cuda.reset_peak_memory_stats()
        res, counts = fit_counted(torch, build, solver)
        for k in launches:
            launches[k] += counts[k]
        hist = res.history
        iters = sum(int(h["pcg_iters"]) for h in hist)
        row = run_row(torch, tag, res, counts, setup_s,
                      f=[h["f"] for h in hist],
                      hvp_bytes=2 * (solver.ell_data_h.numel()
                                     + solver.ell_dataT_h.numel()))
        check(bool(torch.from_numpy(res.w).isfinite().all())
              and res.w.shape == (X.shape[0],),
              f"{tag}: finite w of shape (d,)")
        want = bf16_launches(partition, m, fused, s, len(hist), iters)
        got = {k: counts[k] for k in want}
        check(got == want and iters > 0,
              f"{tag}: launches as predicted {json.dumps(want)}"
              + ("" if got == want else f", got {json.dumps(got)}"))
        check_f_decreases(tag, hist)
        e = rel_w(res.w, f32_w[partition])
        check(e <= REL_TOL_W, f"{tag} vs f32 m=1 two-pass: rel diff of w "
                              f"{e:.2e} (<= {REL_TOL_W:g})")
        print(f"{tag}: PCG {'rounds' if s > 1 else 'iterations'} per step "
              f"{row['pcg_iters']}, median iter_s "
              f"{row['iter_s_median']:.4f}", flush=True)
        del solver, res
        gc.collect()
        torch.cuda.empty_cache()
    return timings


def time_gram_solve(torch) -> None:
    """Host milliseconds of one s-step Gram solve (``pcg._solve_round`` on
    an (s+1) x (s+1) system at s = SSTEP_S), each call ended by a device
    sync, on the card and on the CPU; printed, not gated."""
    from repro_torch.core.pcg import _solve_round
    g = torch.Generator().manual_seed(5)
    k = SSTEP_S + 1
    U = torch.randn((64, k), generator=g) * torch.logspace(0, 2, k)
    H = torch.randn((64, 64), generator=g) / 8
    H = H @ H.T + torch.eye(64)
    G, B, b = U.T @ H @ U, U.T @ U, U.T @ torch.randn(64, generator=g)
    out = {}
    for where, dev in (("card", "cuda"), ("cpu", "cpu")):
        args = [t.to(dev) for t in (G, B, b)]
        for _ in range(3):
            a = _solve_round(*args, SSTEP_S)
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            a = _solve_round(*args, SSTEP_S)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[where] = (statistics.median(times) * 1e3, a.cpu())
    print(f"gram solve (s={SSTEP_S}): {out['card'][0]:.3f} ms host time per "
          f"call on the card, {out['cpu'][0]:.3f} ms on the CPU; rel diff "
          f"of a {rel_err(out['card'][1], out['cpu'][1]):.2e}", flush=True)


def groups(cols: int) -> int:
    """Launches of a multi-vector op on ``cols`` columns (kernels/ops.py
    splits past MAX_COLS)."""
    return -(-cols // MAX_COLS)


def predicted_launches(sparse, partition, m, fused, s, steps, rounds):
    """The kernel launches an s-step fit makes, from the code's structure
    (core/pcg.py, core/disco.py): per Newton step the margins and the
    gradient (sparse input: one ell_mv each per shard; dense: cuBLAS); per
    round s - 1 basis-operator products (the whole local HVP: for DiSCO-S
    on one shard only, for DiSCO-F on every shard) and one batched round
    (DiSCO-S: apply_multi per shard on s + 1 columns; DiSCO-F: one
    apply_multi on s columns when fused on one shard, else pass A and
    pass B multi per shard), one launch per column group."""
    n = dict.fromkeys(SPARSE_KERNELS + DENSE_KERNELS, 0)
    basis = (s - 1) * rounds * (m if partition == "features" else
                                (1 if m == 1 else 0))
    if sparse:
        n["ell_mv"] += 2 * m * steps
        if fused:
            n["ell_hvp"] += basis
        else:
            n["ell_mv"] += 2 * basis
    elif fused:
        n["x_c_xt_u"] += basis
    else:
        n["xt_u"] += basis
        n["x_cz"] += basis
    one_apply = partition == "samples" or (fused and m == 1)
    per_round = m if partition == "samples" or not one_apply else 1
    per_round *= groups(s + 1 if partition == "samples" else s)
    if sparse and fused and one_apply:
        n["ell_hvp_mm"] += per_round * rounds
    elif sparse:
        n["ell_mm"] += 2 * per_round * rounds
    elif fused and one_apply:
        n["x_c_xt_multi"] += per_round * rounds
    else:
        n["xt_multi"] += per_round * rounds
        n["x_cz_multi"] += per_round * rounds
    return n


def run_tag(partition: str, m: int, fused: bool) -> str:
    return (f"{'DiSCO-S' if partition == 'samples' else 'DiSCO-F'} m={m} "
            f"{'fused' if fused else 'two-pass'}")


def fit_counted(torch, build, solver):
    """One fit of the main path, the launch counts zeroed just before it
    and read just after."""
    build.reset_launch_counts()
    res = solver.fit()
    torch.cuda.synchronize()
    return res, build.launch_counts()


def run_row(torch, tag, res, counts, setup_s, **extra) -> dict:
    hist = res.history
    row = dict(
        run=tag, newton_iters=len(hist),
        pcg_iters=[int(h["pcg_iters"]) for h in hist],
        grad_norm_first=hist[0]["grad_norm"],
        grad_norm_last=hist[-1]["grad_norm"],
        iter_s_median=statistics.median(h["iter_s"] for h in hist),
        setup_s=setup_s, ledger_rounds=res.ledger.rounds,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=counts, **extra)
    print("run " + json.dumps(row), flush=True)
    return row


def rel_w(a, b) -> float:
    import numpy as np
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def phase_slice(torch, rt, build, sparse_hvp, ref, errs, keep):
    """The sparse slice's runs; ``keep`` (a dict holding ``dir``, a
    directory that outlives the phase) gets what the serving phase reuses:
    the data, the first run's result and config, DiSCO-S m = 4's w and the
    store of :func:`store_roundtrip`."""
    from repro_torch.data.sparse import make_sparse_glm_data
    t0 = time.perf_counter()
    X, y, _ = make_sparse_glm_data(**SLICE)
    print(f"data: d={X.shape[0]} n={X.shape[1]} nnz={X.nnz} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    launches = dict.fromkeys(SPARSE_KERNELS + SPARSE_BF16, 0)
    timings, results = None, {}
    for partition, m, fused in RUNS:
        tag = run_tag(partition, m, fused)
        cfg = rt.DiscoConfig(partition=partition, hvp_fused=fused, **SOLVE)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        solver = rt.DiscoSolver(X, y, cfg, group=rt.InProcessGroup(m),
                                device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        ell_bytes = 4 * (solver.ell_data.numel() + solver.ell_dataT.numel())
        if timings is None:
            timings = measure_kernels(torch, solver, sparse_hvp, ref, errs)
            timings.update(measure_sparse_multi(torch, solver, sparse_hvp,
                                                ref, errs))
            torch.cuda.reset_peak_memory_stats()
        t_fit = time.perf_counter()
        res, counts = fit_counted(torch, build, solver)
        fit_s = time.perf_counter() - t_fit
        for k in SPARSE_KERNELS:
            launches[k] += counts[k]
        if (partition, m, fused) in DIST_TWINS:
            keep.setdefault("twins", {})[(partition, m)] = dist_twin(
                torch, solver, res, setup_s, fit_s, DIST_DEPTH[(partition,
                                                                m)])
        row = run_row(torch, tag, res, counts, setup_s,
                      imbalance=res.partition_info["imbalance"],
                      ell_bytes=ell_bytes,
                      ell_widths=[int(solver.ell_data.shape[2]),
                                  int(solver.ell_dataT.shape[2])])
        g0, g1 = row["grad_norm_first"], row["grad_norm_last"]
        check(bool(torch.from_numpy(res.w).isfinite().all())
              and res.w.shape == (X.shape[0],), f"{tag}: finite w of shape (d,)")
        check(g1 <= 1e-3 * g0, f"{tag}: grad_norm {g0:.3e} -> {g1:.3e}")
        check(counts["ell_mv"] > 0, f"{tag}: ell_mv launched")
        if fused:
            check(counts["ell_hvp"] > 0, f"{tag}: ell_hvp launched")
        results[(partition, m, fused)] = (res.w, row["pcg_iters"])
        if (partition, m, fused) == RUNS[0]:
            t_tc = time.perf_counter()
            trace_and_checkpoint(torch, build, solver, res, counts, tag)
            keep.update(X=X, y=y, res=res, cfg=cfg,
                        store=f"{keep['dir']}/store")
            store_roundtrip(torch, rt, X, y, cfg, res, keep["store"])
            print(f"trace and checkpoint, sparse: "
                  f"{time.perf_counter() - t_tc:.1f} s", flush=True)
            try:
                profile_fit(torch, solver)
            except RuntimeError as exc:   # a measurement only, not a check
                print(f"profile unavailable: {exc}", flush=True)
            # the streamed solve, its m = 1 twins this solver re-targeted
            stream_phase(torch, rt, build, X, y, launches, solver, keep)
        del solver, res
        gc.collect()
        torch.cuda.empty_cache()

    w = {k: v[0] for k, v in results.items()}
    keep["w_m4"] = w[("samples", 4, False)]
    e = rel_w(w[("samples", 4, False)], w[("samples", 1, False)])
    check(e <= 1e-3, f"DiSCO-S m=4 vs m=1: rel diff of w {e:.2e}")
    for p in ("samples", "features"):
        e = rel_w(w[(p, 1, True)], w[(p, 1, False)])
        check(e <= 1e-4, f"{p} fused vs two-pass: rel diff of w {e:.2e}")
    timings.update(bf16_slice_runs(
        torch, rt, build, sparse_hvp, ref, X, y,
        {p: w[(p, 1, False)] for p in ("samples", "features")}, launches,
        errs, timings))
    sstep_phase(torch, rt, build, X, y, SOLVE, SSTEP_RUNS,
                {p: results[(p, 1, False)] for p in ("samples", "features")},
                True, launches)
    sag_slice_runs(torch, rt, build, X, y, results[("samples", 1, False)][1],
                   launches)
    subsample_slice_runs(torch, rt, build, X, y, launches)
    return timings, launches


def sstep_phase(torch, rt, build, X, y, solve, runs, classic, sparse,
                launches):
    """The s-step runs of a slice (``pcg_block_s = SSTEP_S``): each held
    to the launches the code predicts, the slice's convergence check and
    the classic m = 1 ``w`` of its partition (``classic``); fused against
    two-pass. The first run is profiled and its host syncs counted.
    Returns each run's ``w`` and rounds per step, by (partition, m,
    fused)."""
    prefix = "" if sparse else "dense "
    results, iters = {}, {}
    for partition, m, fused in runs:
        tag = f"{prefix}s-step s={SSTEP_S} " + run_tag(partition, m, fused)
        cfg = rt.DiscoConfig(partition=partition, hvp_fused=fused,
                             pcg_block_s=SSTEP_S, **solve)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        solver = rt.DiscoSolver(X, y, cfg, group=rt.InProcessGroup(m),
                                device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        res, counts = fit_counted(torch, build, solver)
        for k in launches:
            launches[k] += counts[k]
        hist = res.history
        rounds = [int(h["pcg_iters"]) for h in hist]
        base_w, base_iters = classic[partition]
        row = run_row(torch, tag, res, counts, setup_s,
                      classic_m1_pcg_iters=base_iters,
                      f=[h["f"] for h in hist])
        check(bool(torch.from_numpy(res.w).isfinite().all())
              and res.w.shape == (X.shape[0],), f"{tag}: finite w of shape (d,)")
        want = predicted_launches(sparse, partition, m, fused, SSTEP_S,
                                  len(hist), sum(rounds))
        got = {k: counts[k] for k in want}
        check(got == want and sum(rounds) > 0,
              f"{tag}: launches as predicted {json.dumps(want)}"
              + ("" if got == want else f", got {json.dumps(got)}"))
        if sparse:
            g0, g1 = row["grad_norm_first"], row["grad_norm_last"]
            check(g1 <= 1e-3 * g0, f"{tag}: grad_norm {g0:.3e} -> {g1:.3e}")
        else:
            check_f_decreases(tag, hist)
        e = rel_w(res.w, base_w)
        tol = 1e-3 if sparse else REL_TOL_W
        check(e <= tol, f"{tag} vs classic m=1: rel diff of w {e:.2e} "
                        f"(<= {tol:g})")
        print(f"{tag}: rounds per step {rounds} (classic m=1 iterations "
              f"{base_iters}), median iter_s {row['iter_s_median']:.4f}",
              flush=True)
        results[(partition, m, fused)] = res.w
        iters[(partition, m, fused)] = rounds
        if (partition, m, fused) == runs[0]:
            try:
                profile_fit(torch, solver, count_syncs=True,
                            rounds=sum(rounds))
            except RuntimeError as exc:   # a measurement only, not a check
                print(f"profile unavailable: {exc}", flush=True)
        del solver, res
        gc.collect()
        torch.cuda.empty_cache()
    for p in ("samples", "features"):
        if (p, 1, True) in results and (p, 1, False) in results:
            e = rel_w(results[(p, 1, True)], results[(p, 1, False)])
            check(e <= 1e-4, f"{prefix}s-step {p} fused vs two-pass: rel "
                             f"diff of w {e:.2e}")
    return {k: (w, iters[k]) for k, w in results.items()}


# ---------------------------------------------------------------------------
# the multi-process solve (phase 3, after the slice's runs; its resume and
# refit part after the serving phase)
# ---------------------------------------------------------------------------

# the one-process runs of RUNS the ranks are held to, bit for bit
DIST_TWINS = (("samples", 1, False), ("samples", 4, False),
              ("features", 4, False))
DIST_GLOO = (("samples", 4), ("features", 4))   # four gloo ranks on cuda:0
DIST_NCCL = (("samples", 1),)                   # one NCCL rank
# Newton steps of each in-memory run, cut to the first four (DiSCO-F at
# m = 4: 315 of its 1,716 PCG iterations) to keep the phase within its
# budget; a twin is the RUNS solver refit at that depth, whose history is
# the 10-step run's first four entries
DIST_DEPTH = {key: 4 for key in DIST_GLOO + DIST_NCCL}
# the streamed runs on the four gloo ranks (STREAM_SOLVE, 2 Newton steps):
# (tag, partition, config overrides, kernels each rank must launch)
DIST_STREAM = (
    ("F_m4_f32", "features", {}, ("ell_mv",)),
    ("S_m4_f32", "samples", {}, ("ell_mv",)),
    ("S_m4_fused_bf16", "samples",
     dict(hvp_fused=True, hvp_dtype="bfloat16"), ("ell_mv", "ell_hvp_bf16")),
)
# K2's f32 atomics change a fused run's sum order from run to run, so the
# fused bf16 ranks are held to the f32 two-pass twin at the stream phase's
# fused bf16 limit, and to each other bit for bit
DIST_FUSED_TOL = 5e-3
DIST_KILL_AT = 1                 # the streamed DiSCO-S m = 4 run's kill
# softmax K = 10 at the dense slice's recipe and shape, 2 Newton steps:
# DiSCO-S and DiSCO-F on the four gloo ranks, DiSCO-S on one NCCL rank
DIST_SOFTMAX = dict(SOFTMAX_SOLVE, max_outer=2, n_classes=SOFTMAX_K)
DIST_SOFTMAX_GLOO = (("samples", 4), ("features", 4))
DIST_SOFTMAX_NCCL = (("samples", 1),)
DIST_DENSE_CHUNK = 8192          # columns of X drawn from one generator
DIST_TIMEOUT_S = 120.0
# the in-memory runs' gloo and NCCL spawns 90 s, the other paths 90 s
DIST_BUDGET_S = 180.0
HISTORY_TIMINGS = ("iter_s",)


def result_summary(res) -> dict:
    """A fit's result without its timings (what the ranks must equal);
    a softmax fit's ``W`` stands for ``w``."""
    import numpy as np
    led = getattr(res, "ledger", None)
    return dict(w=np.asarray(res.w if hasattr(res, "w") else res.W),
                history=[{k: v for k, v in h.items()
                          if k not in HISTORY_TIMINGS} for h in res.history],
                ledger=(None if led is None else
                        (led.rounds, led.floats, led.spmd_collectives)),
                partition_info=getattr(res, "partition_info", None),
                replan_events=getattr(res, "replan_events", None),
                stream_stats=getattr(res, "stream_stats", None))


def dist_twin(torch, solver, res, setup_s, fit_s, depth) -> dict:
    """The one-process result a dist run is held to: ``res`` itself, or
    at a cut depth ``solver``'s refit to ``depth`` Newton steps (timed),
    whose history must be ``res``'s first ``depth`` entries."""
    full = result_summary(res)
    if depth == solver.cfg.max_outer:
        return dict(summary=full, setup_s=setup_s, fit_s=fit_s)
    cfg = solver.cfg
    solver.cfg = dataclasses.replace(cfg, max_outer=depth)
    try:
        t0 = time.perf_counter()
        cut = solver.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        solver.cfg = cfg
    cut = result_summary(cut)
    check(cut["history"] == full["history"][:depth],
          f"dist twin: the {depth}-step refit's history is the "
          f"{cfg.max_outer}-step run's first {depth} entries")
    return dict(summary=cut, setup_s=setup_s, fit_s=fit_s)


def same_result(a: dict, b: dict) -> bool:
    import numpy as np
    return (a["w"].dtype == b["w"].dtype and np.array_equal(a["w"], b["w"])
            and a["history"] == b["history"] and a["ledger"] == b["ledger"]
            and a["partition_info"] == b["partition_info"])


def dense_mixing(torch, dev, d, cond_decay, seed):
    """``make_dense_data``'s feature covariance: the (d, d) f32 mixing
    matrix, singular values k^-cond_decay / 2 of a seeded Gaussian's QR."""
    g = torch.Generator(device=dev).manual_seed(seed)
    scales = torch.arange(1, d + 1, dtype=torch.float64,
                          device=dev) ** (-cond_decay)
    Q, _ = torch.linalg.qr(torch.randn((d, d), generator=g, device=dev,
                                       dtype=torch.float64))
    return (Q * scales.sqrt()[None, :]).float()


def dense_chunk(torch, A, seed, c):
    """Columns ``[c C, (c + 1) C)`` of the chunk-drawn dense X (``C =
    DIST_DENSE_CHUNK``): the mixing matrix times a Gaussian block from a
    generator of its own (seeded by ``seed`` and ``c``), unit-norm
    columns; so any process draws any block of X alone, bit for bit."""
    g = torch.Generator(device=A.device).manual_seed(
        seed * 1_000_003 + 1 + c)
    Xc = A @ torch.randn((A.shape[0], DIST_DENSE_CHUNK), generator=g,
                         device=A.device)
    Xc /= torch.clamp(torch.linalg.norm(Xc, dim=0, keepdim=True), min=1e-12)
    return Xc


def dense_block(torch, A, seed, n, partition, m, shard):
    """Shard ``shard`` of ``m`` of the chunk-drawn (d, n) X, drawn on
    ``A``'s device without the rest: its columns (DiSCO-S) or its rows
    (DiSCO-F, each chunk drawn whole and cut)."""
    d = A.shape[0]
    C = DIST_DENSE_CHUNK
    if partition == "samples":
        lo, hi = shard * n // m, (shard + 1) * n // m
        return torch.cat([dense_chunk(torch, A, seed, c)
                          for c in range(lo // C, hi // C)], dim=1)
    rows = slice(shard * d // m, (shard + 1) * d // m)
    out = torch.empty((rows.stop - rows.start, n), device=A.device)
    for c in range(n // C):
        out[:, c * C:(c + 1) * C] = dense_chunk(torch, A, seed, c)[rows]
    return out


def dist_softmax_solver(torch, rt, group, path, partition, dev):
    """A rank's softmax solver on its own block of the chunk-drawn X (the
    mixing matrix and the labels read from ``path``)."""
    import numpy as np
    arr = np.load(path)
    A = torch.from_numpy(arr["A"]).to(dev)
    n = int(arr["labels"].shape[0])
    X_loc = dense_block(torch, A, DENSE["seed"], n, partition, group.size,
                        group.rank)
    del A
    cfg = rt.SoftmaxConfig(partition=partition, **DIST_SOFTMAX)
    return rt.SoftmaxSolver.from_local_block(
        X_loc, arr["labels"], cfg, d=X_loc.shape[0] * (
            group.size if partition == "features" else 1),
        group=group, device=dev)


def dist_job(torch, rt, build, group, job, dev):
    """Build one job's solver (timed), then one fit under sync debug mode
    with the launch counts and the group's counters zeroed just before
    it. A killed fit (``SimulatedKill``) is recorded, not raised: every
    rank raises at the same step, so the group stays in step."""
    from repro_torch.data import ShardStore
    from repro_torch.glm_serve import ModelRegistry, RefitLoop
    from repro_torch.robust import FaultPlan, SimulatedKill
    kind = job["kind"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit_kw, loop = {}, None
    if kind == "memory":
        arr = job["slice"]
        X = rt.CSRMatrix(arr["indptr"], arr["indices"], arr["data"],
                         tuple(arr["shape"]))
        cfg = rt.DiscoConfig(**dict(SOLVE, partition=job["partition"],
                                    hvp_fused=False,
                                    max_outer=job["depth"]))
        solver = rt.DiscoSolver(X, arr["y"], cfg, group=group, device=dev)
    elif kind == "softmax":
        solver = dist_softmax_solver(torch, rt, group, job["path"],
                                     job["partition"], dev)
    elif kind == "stream":
        plan = (FaultPlan(kill_at_step=job["kill_at"])
                if job.get("kill_at") is not None else None)
        solver = rt.DiscoSolver.from_store(
            ShardStore(job["store"]), rt.DiscoConfig(**job["cfg"]),
            group=group, device=dev, fault_plan=plan)
        if job.get("ckpt"):
            fit_kw = dict(checkpoint_dir=job["ckpt"],
                          resume=job.get("kill_at") is None)
    else:                                               # refit
        loop = RefitLoop(ModelRegistry(job["registry"]),
                         ShardStore(job["store"]),
                         rt.DiscoConfig(**job["cfg"]), group=group,
                         device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    group.reset_counts()
    out = {}

    def run():
        build.reset_launch_counts()
        try:
            if loop is not None:
                out["version"], out["res"] = loop.refit(warm=True)
            else:
                out["res"] = solver.fit(**fit_kw)
        except SimulatedKill:
            out["res"] = None
        torch.cuda.synchronize()
        out["counts"] = build.launch_counts()
    t0 = time.perf_counter()
    syncs = count_host_syncs(torch, run)
    fit_s = time.perf_counter() - t0
    res = out["res"]
    row = dict(setup_s=setup_s, fit_s=fit_s, host_syncs=syncs,
               launches={k: v for k, v in out["counts"].items() if v},
               group=group.counts(), killed=res is None,
               summary=None if res is None else result_summary(res),
               version=out.get("version"))
    if kind == "memory":
        row["shard_bytes"] = 4 * (solver.ell_data.numel()
                                  + solver.ell_dataT.numel())
    if kind == "softmax":
        row["shard_bytes"] = solver.X.numel() * solver.X.element_size()
    return row


def dist_rank(group, jobs) -> dict:
    """The body of a rank of the dist phase (a new interpreter): each
    job of ``jobs`` (``{key: job}``) on this rank's shard, in order:
    the slice's in-memory solves (``memory``), softmax on this rank's
    block of the chunk-drawn dense X (``softmax``), streamed solves of
    this rank's chunks, killed or resumed (``stream``), a warm refit
    (``refit``)."""
    import numpy as np
    import torch
    import repro_torch as rt
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False   # as main()
    torch.backends.cudnn.allow_tf32 = False
    dev = group.device or torch.device("cuda")
    out = {}
    for key, job in jobs.items():
        if job["kind"] == "memory":
            job = dict(job, slice=dict(np.load(job["path"])))
        out[key] = dist_job(torch, rt, build, group, job, dev)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dist_rows(tag, twin, rows, launches, kernels, exact=True) -> None:
    """The checks of one run on the ranks: each rank launched ``kernels``
    (their launches join ``launches``), every rank the same, and each
    equal to ``twin`` (a result summary) bit for bit (``exact``)."""
    for r, row in enumerate(rows):
        for k, v in row["launches"].items():
            if k in launches:
                launches[k] += v
        check(all(row["launches"].get(k, 0) > 0 for k in kernels),
              f"dist {tag}: rank {r} launched " + ", ".join(
                  f"{k} {row['launches'].get(k, 0)}" for k in kernels))
    if exact:
        same = [same_result(row["summary"], twin) for row in rows]
        check(all(same), f"dist {tag}: every rank's w, history, ledger "
                         f"and partition_info equal the one-process run's "
                         f"bit for bit ({same})")
    check(all(same_result(row["summary"], rows[0]["summary"])
              for row in rows), f"dist {tag}: every rank the same")


def dist_line(tag, spawn_s, twin, rows, **extra) -> None:
    g = rows[0]["group"]
    hist = twin["summary"]["history"]
    line = dict(
        run=tag, spawn_s=spawn_s,
        setup_s=[row["setup_s"] for row in rows],
        fit_s=[row["fit_s"] for row in rows],
        one_process_setup_s=twin.get("setup_s"),
        one_process_fit_s=twin.get("fit_s"),
        newton_iters=len(hist),
        pcg_iters=sum(int(h["pcg_iters"]) for h in hist),
        vector_calls=g["vector_calls"], vector_floats=g["vector_floats"],
        scalar_calls=g["scalar_calls"], gather_calls=g["gather_calls"],
        barrier_calls=g["barrier_calls"],
        broadcast_calls=g["broadcast_calls"],
        ledger_spmd=(twin["summary"]["ledger"] or (None,) * 3)[2],
        staged_bytes=[row["group"]["staged_bytes"] for row in rows],
        collective_s=[row["group"]["seconds"] for row in rows],
        collective_share=[row["group"]["seconds"] / row["fit_s"]
                          for row in rows],
        host_syncs=[row["host_syncs"] for row in rows],
        launches=[row["launches"] for row in rows], **extra)
    print("dist " + json.dumps(line), flush=True)


def dist_stream_checks(tag, want, rows, m=4) -> dict:
    """A streamed run's byte ledger on the ranks against ``want``, the
    ``stream_stats`` of a one-process run of ``m`` shards on the same
    store and tiles: each rank's payload one shard's (the one-process
    step's ``1 / m``), the rank's peak at most ``STREAM_DEPTH + 2`` of
    them and every rank's bytes the same; for a twin of the same solve
    (``m`` > 1) the ranks' bytes also sum to its (another solve runs other
    passes). Returns the dist line's fields."""
    st = [row["summary"]["stream_stats"] for row in rows]
    one = want["max_step_bytes"] // m
    total = sum(s["bytes_loaded"] for s in st)
    check((m == 1 or total == want["bytes_loaded"])
          and all(s["bytes_loaded"] == st[0]["bytes_loaded"]
                  and s["max_step_bytes"] == one
                  and s["peak_bytes"] <= (STREAM_DEPTH + 2) * one
                  for s in st),
          f"dist {tag}: the ranks' bytes {st[0]['bytes_loaded']} each, "
          f"{total} in all (one process: {want['bytes_loaded']}); each "
          f"rank's step {[s['max_step_bytes'] for s in st]} B = {one} "
          f"(one shard), peak {[s['peak_bytes'] for s in st]} <= "
          f"{STREAM_DEPTH + 2} x {one} (one process: {want['peak_bytes']})")
    return dict(bytes_loaded=[s["bytes_loaded"] for s in st],
                bytes_loaded_one_process=want["bytes_loaded"],
                peak_bytes=[s["peak_bytes"] for s in st],
                peak_bytes_one_process=want["peak_bytes"],
                max_step_bytes=[s["max_step_bytes"] for s in st],
                max_step_bytes_one_process=want["max_step_bytes"])


def dist_softmax_twins(torch, rt, keep) -> dict:
    """The dense X drawn chunk by chunk in this process (the mixing
    matrix and the labels saved for the ranks), softmax labels as the
    softmax phase draws them, and the one-process twins of the softmax
    runs; X is freed before the ranks start."""
    import numpy as np
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    d, n = DENSE["d"], DENSE["n"]
    A = dense_mixing(torch, dev, d, DENSE["cond_decay"], DENSE["seed"])
    X = torch.empty((d, n), device=dev)
    for c in range(n // DIST_DENSE_CHUNK):
        X[:, c * DIST_DENSE_CHUNK:(c + 1) * DIST_DENSE_CHUNK] = \
            dense_chunk(torch, A, DENSE["seed"], c)
    g = torch.Generator(device=dev).manual_seed(2)
    W_true = torch.randn((d, SOFTMAX_K), generator=g, device=dev)
    labels = torch.argmax(X.T @ W_true + torch.randn(
        (n, SOFTMAX_K), generator=g, device=dev), dim=1).cpu().numpy()
    path = f"{keep['dir']}/dist_dense.npz"
    np.savez(path, A=A.cpu().numpy(), labels=labels)
    torch.cuda.synchronize()
    print(f"dist dense X drawn by chunks: {time.perf_counter() - t0:.1f} s",
          flush=True)
    twins = {}
    for partition, m in DIST_SOFTMAX_GLOO + DIST_SOFTMAX_NCCL:
        cfg = rt.SoftmaxConfig(partition=partition, **DIST_SOFTMAX)
        t0 = time.perf_counter()
        solver = rt.SoftmaxSolver(X, labels, cfg,
                                  group=rt.InProcessGroup(m), device=dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = solver.fit()
        torch.cuda.synchronize()
        twins[(partition, m)] = dict(summary=result_summary(res),
                                     setup_s=setup_s,
                                     fit_s=time.perf_counter() - t0)
        del solver, res
    del X, A, W_true
    gc.collect()
    torch.cuda.empty_cache()
    return dict(path=path, twins=twins)


def dist_phase(torch, rt, keep, launches) -> dict:
    """The multi-process solve (lines ``dist ...``), each rank a process
    of :func:`repro_torch.parallel.launch.spawn` holding its own shard:
    on four gloo ranks sharing the card, the slice's DiSCO-S and DiSCO-F
    at m = 4 in memory (``DIST_DEPTH`` steps), softmax K = 10 DiSCO-S and
    DiSCO-F at m = 4 (each rank drawing its block of the chunk-drawn
    dense X alone), the streamed runs of ``DIST_STREAM`` (each rank
    streaming its shard's chunks) and the streamed DiSCO-S run killed at
    step ``DIST_KILL_AT`` (resumed by :func:`dist_resume_phase` in new
    processes); on one NCCL rank, DiSCO-S m = 1 in memory and softmax.
    Each rank's result must equal its one-process twin bit for bit
    (``keep``'s ``twins`` from :func:`dist_twin`, the stream phase's
    DiSCO-F m = 4 run, the twins made here), every rank the same, and
    each rank must have launched its path's kernels; their launches join
    the kernels line's (the dense kernels' in the returned dict). Four
    ranks on one card measure process overhead and host staging, not a
    cluster."""
    import numpy as np
    from repro_torch.data import ShardStore
    from repro_torch.parallel.launch import spawn
    t_phase = time.perf_counter()
    X, y = keep["X"], keep["y"]
    path = f"{keep['dir']}/dist_slice.npz"
    np.savez(path, indptr=X.indptr, indices=X.indices, data=X.data,
             shape=np.asarray(X.shape), y=np.asarray(y))
    twins = dict(keep["twins"])
    t0 = time.perf_counter()
    soft = dist_softmax_twins(torch, rt, keep)
    twins.update({("softmax",) + k: v for k, v in soft["twins"].items()})
    # the one-process streamed twins: the stream phase's DiSCO-F m = 4,
    # a DiSCO-S m = 4 run here
    stores = keep["stream_stores"]
    twins[("stream", "F_m4_f32")] = keep["stream_twin"]
    cfg = rt.DiscoConfig(**dict(STREAM_SOLVE, partition="samples"))
    t1 = time.perf_counter()
    res = rt.DiscoSolver.from_store(ShardStore(stores["samples"]), cfg,
                                    group=rt.InProcessGroup(4),
                                    device="cuda").fit()
    torch.cuda.synchronize()
    twins[("stream", "S_m4_f32")] = dict(
        summary=result_summary(res), fit_s=time.perf_counter() - t1)
    keep["dist_twins"] = twins
    twins_s = time.perf_counter() - t0
    keep["dist_ckpt"] = f"{keep['dir']}/dist_ckpt"
    gloo = {("memory", p, m): dict(kind="memory", path=path, partition=p,
                                   depth=DIST_DEPTH[(p, m)])
            for p, m in DIST_GLOO}
    gloo.update({("softmax", p, m): dict(kind="softmax", path=soft["path"],
                                         partition=p)
                 for p, m in DIST_SOFTMAX_GLOO})
    for tag, partition, kw, _ in DIST_STREAM:
        gloo[("stream", tag)] = dict(
            kind="stream", store=stores[partition],
            cfg=dict(STREAM_SOLVE, partition=partition, **kw))
    gloo[("stream", "S_m4_killed")] = dict(
        gloo[("stream", "S_m4_f32")], kill_at=DIST_KILL_AT,
        ckpt=keep["dist_ckpt"])
    nccl = {("memory", p, m): dict(kind="memory", path=path, partition=p,
                                   depth=DIST_DEPTH[(p, m)])
            for p, m in DIST_NCCL}
    nccl.update({("softmax", p, m): dict(kind="softmax", path=soft["path"],
                                         partition=p)
                 for p, m in DIST_SOFTMAX_NCCL})
    dense = dict.fromkeys(("xt_multi", "x_cz_multi"), 0)
    spawns = {}
    for backend, nproc, jobs in (("gloo", 4, gloo), ("nccl", 1, nccl)):
        t0 = time.perf_counter()
        per_rank = spawn(dist_rank, nproc, backend=backend,
                         device="cuda" if backend == "gloo" else None,
                         args=(jobs,), timeout_s=DIST_TIMEOUT_S)
        spawn_s = spawns[backend] = time.perf_counter() - t0
        ranks = f"{nproc} {backend} rank" + ("s" if nproc > 1 else "")
        for key in jobs:
            rows = [r[key] for r in per_rank]
            if key[0] == "memory":
                tag = f"{run_tag(key[1], key[2], False)} {ranks}"
                twin = twins[(key[1], key[2])]
                dist_rows(tag, twin["summary"], rows, launches, ("ell_mv",))
                dist_line(tag, spawn_s, twin, rows,
                          shard_bytes=[row["shard_bytes"] for row in rows])
            elif key[0] == "softmax":
                tag = (f"softmax K={SOFTMAX_K} "
                       f"{'DiSCO-S' if key[1] == 'samples' else 'DiSCO-F'} "
                       f"m={key[2]} {ranks}")
                twin = twins[key]
                dist_rows(tag, twin["summary"], rows, dense,
                          ("xt_multi", "x_cz_multi"))
                dist_line(tag, spawn_s, twin, rows,
                          shard_bytes=[row["shard_bytes"] for row in rows])
            elif key[1] == "S_m4_killed":
                check(all(row["killed"] for row in rows),
                      f"dist stream S_m4 {ranks}: every rank killed at step"
                      f" {DIST_KILL_AT}")
                for row in rows:
                    for k, v in row["launches"].items():
                        if k in launches:
                            launches[k] += v
            else:
                tag = f"stream {key[1]} {ranks}"
                spec = {t: (kern, "fused" not in t)
                        for t, _, _, kern in DIST_STREAM}
                kernels, exact = spec[key[1]]
                twin = twins[("stream", "S_m4_f32" if not exact
                              else key[1])]
                dist_rows(tag, twin["summary"], rows, launches, kernels,
                          exact=exact)
                # the fused run's steps against the stream phase's fused
                # bf16 m = 1 run's (one chunk a step, as a rank's)
                extra = (dist_stream_checks(
                    tag, twin["summary"]["stream_stats"], rows) if exact
                    else dist_stream_checks(tag, keep["stream_fused_m1"],
                                            rows, m=1))
                if not exact:
                    e = rel_w(rows[0]["summary"]["w"], twin["summary"]["w"])
                    check(e <= DIST_FUSED_TOL,
                          f"dist {tag}: w within rel {e:.2e} <= "
                          f"{DIST_FUSED_TOL:g} of the f32 two-pass "
                          f"one-process run's")
                    extra["rel_w_f32_twin"] = e
                dist_line(tag, spawn_s, twin, rows, **extra)
    t_phase = time.perf_counter() - t_phase
    keep["dist_s"] = t_phase
    print("dist phase parts " + json.dumps(dict(
        twins_s=twins_s, spawn_s=spawns, phase_s=t_phase)), flush=True)
    return dense


def dist_resume_phase(torch, rt, keep, launches) -> None:
    """The dist phase's second part, after the serving phase (lines
    ``dist ...``): on four new gloo ranks, the killed streamed DiSCO-S
    m = 4 run resumed from its checkpoint (rank 0 wrote it, rank 0 reads
    and broadcasts it), which must equal the uninterrupted run bit for
    bit; and a one-step warm refit of the serving phase's grown store
    from its registry's active weights (copies of the registry), which
    must equal ``InProcessGroup(4)``'s refit of the same store bit for bit
    and publish one version, the same on every rank."""
    import shutil
    from repro_torch.data import ShardStore
    from repro_torch.glm_serve import ModelRegistry, RefitLoop
    from repro_torch.parallel.launch import spawn
    t_phase = time.perf_counter()
    twins = keep["dist_twins"]
    reg = f"{keep['dir']}/registry"
    regs = {k: f"{keep['dir']}/dist_registry_{k}" for k in ("one", "ranks")}
    for copy in regs.values():
        shutil.copytree(reg, copy)
    rcfg = rt.DiscoConfig(**REFIT_SOLVE)
    t0 = time.perf_counter()
    loop = RefitLoop(ModelRegistry(regs["one"]), ShardStore(keep["store"]),
                     rcfg, group=rt.InProcessGroup(4), device="cuda")
    v_one, res = loop.refit(warm=True)
    torch.cuda.synchronize()
    twin_refit = dict(summary=result_summary(res),
                      fit_s=time.perf_counter() - t0)
    stores = keep["stream_stores"]
    jobs = {
        ("stream", "S_m4_resumed"): dict(
            kind="stream", store=stores["samples"],
            cfg=dict(STREAM_SOLVE, partition="samples"),
            ckpt=keep["dist_ckpt"]),
        ("refit",): dict(kind="refit", registry=regs["ranks"],
                         store=keep["store"], cfg=REFIT_SOLVE),
    }
    t0 = time.perf_counter()
    per_rank = spawn(dist_rank, 4, backend="gloo", device="cuda",
                     args=(jobs,), timeout_s=DIST_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    rows = [r[("stream", "S_m4_resumed")] for r in per_rank]
    tag = "stream S_m4 resumed 4 gloo ranks"
    twin = twins[("stream", "S_m4_f32")]
    dist_rows(tag, twin["summary"], rows, launches, ("ell_mv",))
    check(all(row["group"]["broadcast_calls"] == 1 for row in rows),
          f"dist {tag}: the checkpoint read by rank 0 and broadcast once")
    dist_line(tag, spawn_s, twin, rows, resumed_at=DIST_KILL_AT)
    rows = [r[("refit",)] for r in per_rank]
    tag = "refit 4 gloo ranks"
    dist_rows(tag, twin_refit["summary"], rows, launches, ("ell_mv",))
    versions = ModelRegistry(regs["ranks"]).versions()
    check(all(row["version"] == v_one for row in rows)
          and versions == ModelRegistry(regs["one"]).versions()
          and versions[-1] == v_one,
          f"dist {tag}: one version published (v{v_one}), the same on "
          f"every rank ({[row['version'] for row in rows]}; the ranks' "
          f"registry {versions})")
    dist_line(tag, spawn_s, twin_refit, rows, version=v_one)
    t_phase = time.perf_counter() - t_phase
    total = keep["dist_s"] + t_phase
    print(f"dist phase: {total:.1f} s (budget {DIST_BUDGET_S:.0f} s; "
          f"resume and refit {t_phase:.1f} s)", flush=True)


# ---------------------------------------------------------------------------
# trace and checkpoint (phases 3 and 4, on the first run's solver)
# ---------------------------------------------------------------------------

KILL_AT = 3                      # the kill-and-resume's injected kill
STORE_CHUNK = 4096               # samples per chunk of the store round trip
TRAJECTORY = ("outer_iter", "pcg_iters", "comm_rounds_cum",
              "comm_floats_cum")


def synced_fit(torch, build, solver):
    """``fit_counted`` under PyTorch's sync debug mode: the result, its
    launch counts and the host syncs of the whole fit."""
    out = {}

    def run():
        out["res"], out["counts"] = fit_counted(torch, build, solver)
    syncs = count_host_syncs(torch, run)
    return out["res"], out["counts"], syncs


def same_trajectory(a, b) -> bool:
    """The same history columns (not the timings) and the same ledger."""
    return len(a.history) == len(b.history) and all(
        x[k] == y[k] for x, y in zip(a.history, b.history)
        for k in TRAJECTORY) and a.ledger == b.ledger


def trace_and_checkpoint(torch, build, solver, plain, plain_counts,
                         tag) -> dict:
    """The tracing plane and checkpoint/resume on a full-width solver of
    the main path, whose untraced fit gave ``plain`` / ``plain_counts``.

    A traced fit must give ``plain.w`` bit for bit with the same launches,
    and the traced and untraced fits the same host syncs; the
    ``comm.rounds`` counter must equal the ledger, one ``newton.outer``
    span a step, each no longer than its ``iter_s``; the Chrome trace
    must write and read back. Then the fit is killed at step ``KILL_AT``
    (``solver._faults``) and resumed from its checkpoints: ``w`` within
    rel. 1e-7 of ``plain.w`` (0 expected), the same trajectory. Tracing
    is off again at the end."""
    import tempfile
    import numpy as np
    from repro_torch import obs
    from repro_torch.robust import (FaultInjector, FaultPlan, SimulatedKill,
                                    latest_checkpoint)
    # host syncs: a traced fit between two untraced ones (the process's
    # first fit in sync debug mode counted one sync more on the card, so
    # the traced fit is held to the second)
    obs.disable()
    gc.collect()
    _, _, syncs_first = synced_fit(torch, build, solver)
    tracer = obs.enable(reset=True)
    try:
        _, _, syncs1 = synced_fit(torch, build, solver)
    finally:
        obs.disable()
    untraced, counts0, syncs0 = synced_fit(torch, build, solver)
    tracer = obs.enable(reset=True)
    try:
        traced, counts = fit_counted(torch, build, solver)
        events, counters, _ = tracer.snapshot()
    finally:
        obs.disable()
    check(np.array_equal(traced.w, plain.w)
          and np.array_equal(untraced.w, plain.w),
          f"{tag} traced: w bit for bit the untraced fit's")
    check(counts == plain_counts == counts0,
          f"{tag} traced: the untraced fit's launches "
          f"({sum(counts.values())})")
    check(syncs0 == syncs1, f"{tag} traced: host syncs {syncs1}, untraced "
                            f"{syncs0} (before them {syncs_first})")
    check(counters.get("comm.rounds") == traced.ledger.rounds,
          f"{tag} traced: comm.rounds {counters.get('comm.rounds')} == "
          f"CommLedger.rounds {traced.ledger.rounds}")
    outer = [e for e in events if e.kind == "newton.outer"]
    check(len(outer) == len(traced.history) and all(
        e.dur_ns / 1e9 <= h["iter_s"]
        for e, h in zip(outer, traced.history)),
        f"{tag} traced: {len(outer)} newton.outer spans, each within its "
        "iter_s")
    with tempfile.TemporaryDirectory() as tmp:
        path = obs.export.write_chrome_trace(tracer, f"{tmp}/trace.json")
        with open(path) as f:
            back = json.load(f)
        check(back == json.loads(json.dumps(obs.export.chrome_trace(tracer)))
              and sum(e["ph"] == "X" for e in back) == len(outer),
              f"{tag} traced: the Chrome trace reads back ({len(back)} "
              "events)")

        ckpt = f"{tmp}/ckpt"
        tracer = obs.enable(reset=True)
        try:
            solver._faults = FaultInjector(FaultPlan(kill_at_step=KILL_AT))
            try:
                solver.fit(checkpoint_dir=ckpt)
                killed = False
            except SimulatedKill:
                killed = True
            finally:
                solver._faults = None
            at = latest_checkpoint(ckpt)
            resumed = solver.fit(checkpoint_dir=ckpt, resume=True)
            torch.cuda.synchronize()
            writes = [e.dur_ns / 1e6 for e in tracer.events
                      if e.kind == "ckpt.write"]
        finally:
            obs.disable()
    e = rel_w(resumed.w, plain.w)
    check(killed and at == KILL_AT,
          f"{tag} checkpoint: killed at step {KILL_AT}, LATEST {at}")
    check(e <= 1e-7 and same_trajectory(resumed, plain),
          f"{tag} checkpoint: the resumed w within rel {e:.2e} of the "
          "uninterrupted fit's, the same history columns and ledger")
    row = dict(
        run=tag, iter_s_median_untraced=statistics.median(
            h["iter_s"] for h in plain.history),
        iter_s_median_traced=statistics.median(
            h["iter_s"] for h in traced.history),
        trace_events=len(events), chrome_events=len(back),
        host_syncs=syncs0, launches=sum(counts.values()),
        ckpt_writes=len(writes),
        ckpt_write_ms_median=statistics.median(writes) if writes else None,
        ckpt_write_ms_max=max(writes) if writes else None,
        resume_rel_err=e)
    print("trace-ckpt " + json.dumps(row), flush=True)
    return row


def store_roundtrip(torch, rt, X, y, cfg, plain, path) -> dict:
    """The shard store at full width: ``X`` (the sparse slice's CSR)
    written at ``path`` (kept for the serving phase's refits) chunked
    along the samples, reopened with checksums on and read back exact; a
    solve from the read CSR on the card gives the in-memory solve's
    ``plain.w`` bit for bit."""
    import os
    import numpy as np
    from repro_torch.data import ShardStore
    t0 = time.perf_counter()
    store = ShardStore.from_csr(X, y, path, axis="samples",
                                chunk_size=STORE_CHUNK)
    write_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, fs in os.walk(path) for f in fs)
    t0 = time.perf_counter()
    Xb, yb = ShardStore(path, verify=True).to_csr()
    read_s = time.perf_counter() - t0
    same = all(np.array_equal(getattr(Xb, f), getattr(X, f))
               for f in ("indptr", "indices", "data")) \
        and np.array_equal(yb, y) and Xb.shape == X.shape
    check(same, f"store: {store.n_chunks} chunks of {STORE_CHUNK} "
                f"samples, {store.nnz} nonzeros read back exact")
    t0 = time.perf_counter()
    solver = rt.DiscoSolver(Xb, yb, cfg, device="cuda")
    res = solver.fit()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    check(np.array_equal(res.w, plain.w),
          "store: the solve from the store's CSR gives the in-memory w "
          "bit for bit")
    row = dict(chunks=store.n_chunks, nnz=store.nnz, bytes=nbytes,
               write_s=write_s, write_mb_s=nbytes / write_s / 1e6,
               verified_read_s=read_s,
               verified_read_mb_s=nbytes / read_s / 1e6,
               setup_and_fit_s=solve_s)
    print("store " + json.dumps(row), flush=True)
    del solver
    return row


# ---------------------------------------------------------------------------
# phase 3, streamed: the out-of-core solve on the same slice
# ---------------------------------------------------------------------------

STREAM_CHUNK = 1024              # indices per chunk of both stores
SOLVE_BLOCK = 128                # the slice's tiles (DiscoConfig's default)
STREAM_DEPTH = 2                 # prefetch_depth of the streamed runs
# 2 Newton steps: at 3 the phase took 160.5 s on an H100 (PERF.md)
STREAM_SOLVE = dict(SOLVE, max_outer=2, partition_block=STREAM_CHUNK,
                    stream_chunk_size=STREAM_CHUNK,
                    prefetch_depth=STREAM_DEPTH)
# (tag, partition, m, config overrides, kernels its fit must launch, w's
# limit against the in-memory twin, whether PCG's iterations must equal
# the twin's). The chunk sums' order moves classic PCG at lam = 1e-4 by
# 1.8e-3-2.5e-3 (DiSCO-S) and 5.8e-3-8.8e-3 (DiSCO-F) on an H100, its
# iteration counts with it; the fused bf16 run, whose sum order K2's
# f32 atomics change from run to run, by 0.9e-3-2.2e-3; the s-step
# runs, their rounds equal, by 1.3e-5-2.1e-5 (PERF.md). The classic stream is also held bit for bit to the solve
# whose shards are the chunks, the s-step stream bit for bit to itself
# under injected read faults.
STREAM_RUNS = [
    ("S_m1_f32", "samples", 1, {}, ("ell_mv",), 1e-2, False),
    ("S_m1_fused_bf16", "samples", 1,
     dict(hvp_fused=True, hvp_dtype="bfloat16"), ("ell_mv", "ell_hvp_bf16"),
     5e-3, False),
    ("S_m1_sstep", "samples", 1, dict(pcg_block_s=SSTEP_S),
     ("ell_mv", "ell_mm"), 1e-4, True),
    ("S_m1_sstep_fused", "samples", 1,
     dict(pcg_block_s=SSTEP_S, hvp_fused=True), ("ell_mv", "ell_hvp_mm"),
     1e-4, True),
    ("F_m4_f32", "features", 4, {}, ("ell_mv",), 1e-2, False),
]
STREAM_SLOW_S = 0.02             # injected latency of the straggling chunks


def stream_stats_ok(tag, st) -> None:
    check(st["peak_bytes"] <= (STREAM_DEPTH + 2) * st["max_step_bytes"]
          and st["peak_bytes"] < st["bytes_loaded"] / 4,
          f"stream {tag}: peak {st['peak_bytes']} B <= (depth + 2) x "
          f"{st['max_step_bytes']} B and < {st['bytes_loaded']} / 4 B")


def stream_tiles(torch, store, plan_streams) -> None:
    """Every chunk's tiles assembled on the card, both layouts, against
    ``ell_from_csr`` on the host bit for bit: ``ell_from_csr`` is
    ``ell_plan`` + ``ell_fill`` (``tests/test_torch_stream.py`` holds it
    to the reference's), so the card's tiles must hold exactly the
    chunk's values at the host plan's offsets and zeros elsewhere, with
    its column ids; the bf16 tiles must be the f32 ones' cast (round to
    nearest even, the host's ``astype``). Two plans, one a pass, so the
    two passes run side by side."""
    import numpy as np
    from repro_torch.data.sparse import ell_plan, pad_csr_rows
    plans = [plan_streams(store, 1, block_rows=SOLVE_BLOCK,
                          block_cols=SOLVE_BLOCK, device="cuda",
                          hvp_dtype=torch.bfloat16) for _ in range(2)]
    plan = plans[0]
    flip = store.axis == "samples"
    ok, chunks, nnz = True, 0, 0
    with plans[0].stream("both") as f32, \
            plans[1].stream("both", hvp=True) as b16:
        for t, (a, b) in enumerate(zip(f32, b16)):
            cid = int(plan.schedule[0, t])
            slab = pad_csr_rows(store.chunk_csr(cid), plan.chunk_size)
            vals = np.asarray(slab.data, np.float32)
            ok &= bool((vals != 0).all())
            for lay, kd, kc in (("fwd", "data", "cols"),
                                ("tr", "dataT", "colsT")):
                _, _, r, c = plan._dims(lay)
                w = plan.w_fwd if lay == "fwd" else plan.w_tr
                want = ell_plan(slab, r, c, w, transpose=(lay == "fwd")
                                == flip)
                tiles = a[kd][0]
                ok &= tuple(tiles.shape) == want.shape
                nz = torch.nonzero(tiles.reshape(-1)).reshape(-1)
                order = np.argsort(want.offsets, kind="stable")
                ok &= bool(np.array_equal(nz.cpu().numpy(),
                                          want.offsets[order]))
                ok &= bool(np.array_equal(
                    tiles.reshape(-1)[nz].cpu().numpy(), vals[order]))
                ok &= bool(np.array_equal(a[kc][0].cpu().numpy(),
                                          want.cols))
                ok &= bool(torch.equal(b[kd][0], tiles.to(torch.bfloat16)))
            chunks += cid >= 0
            nnz += len(vals)
    check(ok and chunks == store.n_chunks and nnz == store.nnz,
          f"stream tiles, {store.axis} store: {chunks} chunks ({nnz} "
          "nonzeros) assembled on the card equal ell_from_csr bit for "
          "bit (f32, both layouts), and the bf16 tiles its cast")


def stream_pass_probe(torch, tag, plan, kind, run_chunk) -> dict:
    """One timed pass: the producer's host seconds (read + plan +
    enqueue) and its seconds waiting for a free device buffer or pinned
    set, the bytes staged to the card, the pass's device time between
    CUDA events on the solve's stream, the time that stream waited for
    payloads, and the device time inside each step's launches (CUDA
    events just before the step's first launch and just after its last,
    summed: the kernels and the host's gaps between them)."""
    st = plan.stats
    host0, wait0, staged0 = st.host_s, st.wait_s, st.staged_bytes
    plan.time_waits(True)
    event = lambda: torch.cuda.Event(enable_timing=True)
    a, b, steps = event(), event(), []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    with plan.stream(*kind) as pf:
        for pl in pf:
            steps.append((event(), event()))
            steps[-1][0].record()
            run_chunk(pl)
            steps[-1][1].record()
    b.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    waited = plan.waited_ms()
    plan.time_waits(False)
    dev_ms = a.elapsed_time(b)
    row = dict(tag=tag, wall_ms=wall * 1e3,
               host_ms=(st.host_s - host0) * 1e3,
               producer_wait_ms=(st.wait_s - wait0) * 1e3,
               h2d_bytes=st.staged_bytes - staged0, device_ms=dev_ms,
               waited_ms=waited,
               launch_windows_ms=sum(x.elapsed_time(y) for x, y in steps),
               steps=plan.n_steps)
    print("stream pass " + json.dumps(row), flush=True)
    return row


def stream_phase(torch, rt, build, X, y, launches, solver_m1, keep) -> None:
    """The streamed (out-of-core) solve on the sparse slice.

    Two stores in a temporary directory (samples and features, chunks of
    ``STREAM_CHUNK``); every chunk's tiles on the card against the host;
    five streamed runs, each held to its in-memory twin: ``partition_info``
    equal to the in-memory partitioner's at ``partition_block =
    STREAM_CHUNK``, the first step's gradient norm and f within 1e-6 (the
    products before PCG), ``w`` within its run's limit and, for the
    s-step runs, the same PCG rounds (``STREAM_RUNS``: classic PCG at
    lam = 1e-4 runs 70-100 iterations a step, and a sum in another order
    moves its iteration counts and ``w`` by a few 1e-3). The m = 1 twins
    re-target ``solver_m1``, the slice's in-memory DiSCO-S m = 1 solver
    (``partition_block`` 1 pads n to 20,352 against the stores' 20,480;
    the padding adds no live tile). The exactness checks: the DiSCO-S
    m = 1 two-pass stream equals the in-memory solve whose shards are the
    chunks (``partition_strategy='width'``, m = 20) bit for bit, PCG
    iterations and host syncs included (an s-step solve at m > 1 is not
    the m = 1 one: its rounds differ); the s-step (K6) stream under
    injected read faults equals its fault-free run bit for bit. Then the
    byte bounds and the bf16 ratio, kill-and-resume / re-plan, one timed
    pass of each HVP stream, two of a plan that keeps no chunk plan,
    and a profiled streamed Newton step. The stores stay in ``keep``'s
    directory (``stream_stores``) with the DiSCO-F m = 4 run's result
    (``stream_twin``), which the dist phase's ranks are held to."""
    import copy
    import dataclasses
    import tempfile
    import numpy as np
    from repro_torch.data import ShardStore
    from repro_torch.data import stream as stream_mod
    from repro_torch.data.partition import make_partition
    from repro_torch.data.stream import plan_streams
    from repro_torch.kernels import ops
    from repro_torch.robust import FaultPlan, SimulatedKill
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        stores = {axis: ShardStore.from_csr(
            X, y, f"{keep['dir']}/stream_{axis}", axis=axis,
            chunk_size=STREAM_CHUNK) for axis in ("samples", "features")}
        keep["stream_stores"] = {k: v.path for k, v in stores.items()}
        print(f"stream stores: {stores['samples'].n_chunks} sample and "
              f"{stores['features'].n_chunks} feature chunks "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        t0 = time.perf_counter()
        for store in stores.values():
            stream_tiles(torch, store, plan_streams)
        print(f"stream tiles: {time.perf_counter() - t0:.1f} s", flush=True)
        t_runs = time.perf_counter()
        setup_s = []                     # the in-memory twins' set-ups

        inmem = {("samples", 1, "lpt"): solver_m1}
        results = {}

        def config(partition, kw):
            return rt.DiscoConfig(partition=partition,
                                  **dict(STREAM_SOLVE, **kw))

        def twin(partition, m, kw):
            """The in-memory twin: one solver built a partition, shard
            count and strategy, re-targeted at the run's config like
            ``with_lam`` (the same device tensors; fused and s-step only
            change the step; a bf16 twin reloads the f32 twin's device
            state, which casts the HVP copies on the card)."""
            cfg = config(partition, kw)
            key = (partition, m, cfg.partition_strategy)
            if key not in inmem:
                t1 = time.perf_counter()
                inmem[key] = rt.DiscoSolver(
                    X, y, dataclasses.replace(cfg, hvp_dtype="float32"),
                    group=rt.InProcessGroup(m), device="cuda")
                torch.cuda.synchronize()
                setup_s.append(time.perf_counter() - t1)
                print(f"stream twin {key}: set-up {setup_s[-1]:.1f} s",
                      flush=True)
            base = inmem[key]
            solver = copy.copy(base)
            solver.cfg = cfg
            if cfg.hvp_dtype == "float32":
                solver._step = solver._build_step()
                return solver
            solver.hvp_dtype = torch.bfloat16
            state = dict(ell_data=base.ell_data, ell_cols=base.ell_cols,
                         ell_dataT=base.ell_dataT, ell_colsT=base.ell_colsT,
                         y_tau=base.y_tau, X_tau=base.X_tau,
                         y=base.y.reshape(-1))
            if partition == "samples":
                state["weights"] = base.weights.reshape(-1)
            else:
                state["smask"] = base.smask
            solver._load_state(state, base._perm)
            return solver

        def streamed(partition, m, kw, **extra):
            return rt.DiscoSolver.from_store(
                ShardStore(stores[partition].path), config(partition, kw),
                group=rt.InProcessGroup(m), device="cuda", **extra)

        for tag, partition, m, kw, kernels, tol, same_its in STREAM_RUNS:
            t1 = time.perf_counter()
            solver = streamed(partition, m, kw)
            res, counts, syncs = synced_fit(torch, build, solver)
            t_stream = time.perf_counter() - t1
            for k, v in counts.items():
                if k in launches:
                    launches[k] += v
            mem, _, _ = synced_fit(torch, build, twin(partition, m, kw))
            results[tag] = (solver, res, mem)
            if tag == "F_m4_f32":
                keep["stream_twin"] = dict(summary=result_summary(res),
                                           fit_s=t_stream)
            if tag == "S_m1_fused_bf16":
                keep["stream_fused_m1"] = res.stream_stats
            e = rel_w(res.w, mem.w)
            h0, g0 = res.history[0], mem.history[0]
            first = max(abs(h0[k] - g0[k]) / abs(g0[k])
                        for k in ("grad_norm", "f"))
            its = [int(h["pcg_iters"]) for h in res.history]
            its_mem = [int(h["pcg_iters"]) for h in mem.history]
            part = make_partition(X, partition, m, "lpt", block=STREAM_CHUNK,
                                  pad_multiple=SOLVE_BLOCK).stats()
            check(res.partition_info == part and first <= 1e-6 and e <= tol
                  and (its == its_mem or not same_its),
                  f"stream {tag}: partition_info equal to the in-memory "
                  f"partitioner's at partition_block = {STREAM_CHUNK}, first"
                  f" step's grad_norm and f within {first:.1e} <= 1e-6, w "
                  f"within rel {e:.2e} <= {tol:.0e} of the twin's, PCG "
                  f"iterations {its}, twin {its_mem}"
                  + (" (equal)" if same_its else ""))
            check(all(counts[k] > 0 for k in kernels),
                  f"stream {tag}: " + ", ".join(
                      f"{k} launched {counts[k]}" for k in kernels))
            stream_stats_ok(tag, res.stream_stats)
            row = dict(tag=tag, seconds=t_stream, iter_s_median=statistics
                       .median(h["iter_s"] for h in res.history),
                       iter_s_median_inmem=statistics.median(
                           h["iter_s"] for h in mem.history),
                       pcg_iters=its, pcg_iters_inmem=its_mem, rel_w=e,
                       host_syncs=syncs,
                       launches={k: v for k, v in counts.items() if v},
                       stream_stats=res.stream_stats,
                       host_s=solver._plan.stats.host_s,
                       staged_bytes=solver._plan.stats.staged_bytes)
            print("stream run " + json.dumps(row), flush=True)
            if tag == "S_m1_f32":
                # the exact twin: the in-memory solve whose shards are the
                # chunks (equal-width partition, one shard a chunk)
                n_chunks = stores["samples"].n_chunks
                exact, _, exact_syncs = synced_fit(torch, build, twin(
                    partition, n_chunks, dict(kw, partition_strategy="width")))
                its_exact = [int(h["pcg_iters"]) for h in exact.history]
                check(np.array_equal(res.w, exact.w) and its == its_exact
                      and syncs <= exact_syncs,
                      f"stream {tag}: w and PCG iterations bit for bit the "
                      f"in-memory solve with one shard a chunk (m = "
                      f"{n_chunks}); host syncs {syncs} <= its {exact_syncs}"
                      f"; against the m = 1 twin rel {e:.2e}: the sum "
                      "order's own spread")
                del exact
        b_f32 = results["S_m1_f32"][1].stream_stats["bytes_loaded"]
        b_bf16 = results["S_m1_fused_bf16"][1].stream_stats["bytes_loaded"]
        check(b_bf16 < 0.75 * b_f32,
              f"stream: fused bf16 loads {b_bf16} B < 0.75 x the two-pass "
              f"f32 stream's {b_f32} B ({b_bf16 / b_f32:.3f})")

        t_runs = time.perf_counter() - t_runs
        t_probe = time.perf_counter()
        # one timed pass of each HVP stream, one profiled Newton step
        solver = results["S_m1_f32"][0]
        plan = solver._plan
        u = torch.ones(plan.other_padded, device="cuda")
        c = torch.ones(plan.chunk_size, device="cuda")

        def two_pass(pl):
            z = ops.ell_matvec(pl["dataT"][0], pl["colsT"][0], u,
                               sched=pl["schedT"][0])
            ops.ell_matvec(pl["data"][0], pl["cols"][0], z, c,
                           sched=pl["sched"][0])

        def one_pass(pl):
            ops.ell_hvp(pl["dataT"][0], pl["colsT"][0], u, c,
                        sched=pl["hvp_sched"][0])
        stream_pass_probe(torch, "S_m1_f32 HVP pass", plan, ("both", True),
                          two_pass)
        stream_pass_probe(torch, "S_m1_fused_bf16 HVP pass",
                          results["S_m1_fused_bf16"][0]._plan,
                          ("tr", True, True), one_pass)
        # the producer thread and the solve share the interpreter lock,
        # which a waiting thread gets after at most the switch interval
        # (5 ms by default): the same pass with 0.1 ms
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-4)
        try:
            stream_pass_probe(torch, "S_m1_f32 HVP pass, switch interval "
                              "0.1 ms", plan, ("both", True), two_pass)
        finally:
            sys.setswitchinterval(interval)
        w0 = torch.zeros(solver._w_shape, device="cuda")
        try:
            # device activity only: the host ops of a streamed step are
            # hundreds of thousands, and their profile takes longer than
            # the step
            wall, prof = device_profile(torch, lambda: solver._step(w0, 0),
                                        host_ops=False)
            busy = sum(r[0] for r in prof) * 1e-6
            print("stream profile " + json.dumps(dict(
                run="S_m1_f32 step 0", wall_s=wall, device_busy_s=busy,
                busy_share=busy / wall, top=[
                    dict(name=k[:60], calls=n, device_s=t * 1e-6)
                    for t, n, k in prof[:8]])), flush=True)
        except RuntimeError as exc:        # a measurement only
            print(f"stream profile unavailable: {exc}", flush=True)

        # with no room for chunk plans: every pass plans every chunk on
        # the host (the first pass also opens the chunks' memory maps)
        kept = stream_mod.PLAN_CACHE_BYTES
        stream_mod.PLAN_CACHE_BYTES = 0
        try:
            bare = plan_streams(stores["samples"], 1, block_rows=SOLVE_BLOCK,
                                block_cols=SOLVE_BLOCK,
                                prefetch_depth=STREAM_DEPTH, device="cuda")
            for i in (1, 2):
                stream_pass_probe(torch, f"S_m1_f32 HVP pass, no plan "
                                  f"cache, pass {i}", bare, ("both", True),
                                  two_pass)
        finally:
            stream_mod.PLAN_CACHE_BYTES = kept
        del bare

        t_probe = time.perf_counter() - t_probe
        t_robust = time.perf_counter()
        # robustness: retries on the s-step (K6) stream, kill-and-resume
        # on the classic (K1) one, both deterministic
        sstep_w = results["S_m1_sstep"][1].w
        faulty = streamed("samples", 1, dict(io_backoff_s=0.0,
                                             pcg_block_s=SSTEP_S),
                          fault_plan=FaultPlan(seed=5, read_error_rate=0.3,
                                               read_error_attempts=1))
        res = faulty.fit()
        check(faulty._faults.faults_injected > 0
              and np.array_equal(res.w, sstep_w),
              f"stream retry: {faulty._faults.faults_injected} transient "
              "read faults retried (io_retries = 3) on the s-step stream, "
              "w bit for bit the fault-free run's")
        whole = results["S_m1_f32"][1]
        ckpt = f"{tmp}/ckpt"
        kill_at = STREAM_SOLVE["max_outer"] - 1
        try:
            streamed("samples", 1, {}, fault_plan=FaultPlan(
                kill_at_step=kill_at)).fit(checkpoint_dir=ckpt)
            killed = False
        except SimulatedKill:
            killed = True
        res = streamed("samples", 1, {}).fit(checkpoint_dir=ckpt,
                                             resume=True)
        e = rel_w(res.w, whole.w)
        check(killed and e <= 1e-7 and len(res.history) == len(
            whole.history), f"stream resume: killed at step {kill_at}, "
                            f"resumed w within rel {e:.2e} <= 1e-7 of the "
                            "uninterrupted run's")
        # re-plan on the m = 4 samples plan with two chunks of shard 0
        # straggling, at lam = 1e-2, where PCG's trajectory does not move
        # with the sum order (at 1e-4 it moves by 1e-3, above; the
        # re-planned sums are in another order after every re-plan); one
        # Newton step, as DiSCO-S re-plans between PCG rounds
        probe = plan_streams(stores["samples"], 4, block_rows=SOLVE_BLOCK,
                             block_cols=SOLVE_BLOCK, device="cpu")
        slow = {int(cid): STREAM_SLOW_S for cid in probe.schedule[0, :2]}
        kw = dict(max_outer=1, lam=1e-2)
        static = streamed("samples", 4, kw).fit()
        replanned = streamed("samples", 4, dict(
            kw, elastic_replan=True, replan_threshold=1.3),
            fault_plan=FaultPlan(slow_chunks=slow)).fit()
        e = rel_w(replanned.w, static.w)
        events = replanned.replan_events
        check(len(events) >= 1 and e <= 1e-4,
              f"stream re-plan: {len(events)} re-plan(s) (first "
              f"{events[:1]}), w within rel {e:.2e} <= 1e-4 of the static "
              "plan's")
        t_robust = time.perf_counter() - t_robust
    del inmem, results, solver_m1
    gc.collect()
    torch.cuda.empty_cache()
    print("stream phase parts " + json.dumps(dict(
        runs_and_twins_s=t_runs, twin_setups_s=setup_s,
        passes_and_profile_s=t_probe, robustness_s=t_robust)), flush=True)
    print(f"stream phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# phase 3, serving: the GLM serving plane on the sparse slice's model
# ---------------------------------------------------------------------------

SERVE_REQUESTS = 8192            # held-out samples scored as requests
SERVE_INGEST = SLICE["n"] // 16  # samples a refit ingests (n/16, as bench_serving)
SERVE_VAL = 4096                 # held-out validation samples of refit_path
SERVE_SEED = 1                   # the held-out samples' generator seed
SERVE_LAYOUTS = (1, 7, 64, 1024)  # micro-batches K1 is held to its plain version on
SERVE_SEQUENTIAL = 512           # requests scored one a tick
SERVE_SWAP_TICK = 56             # v2 is published before this tick
SERVE_DEADLINE_EVERY = 8         # every eighth request has a deadline of 0 s
SERVE_CPU = 1024                 # requests also scored by the CPU engine
SERVE_GATE = {"float32": 1e-5, "bfloat16": 2e-2}   # bench_serving's parity gate
# 1 Newton step: at 2 the whole script took 814.5 s on an H100 (PERF.md)
REFIT_SOLVE = dict(SOLVE, partition="samples", max_outer=1,
                   partition_block=STORE_CHUNK,
                   stream_chunk_size=STORE_CHUNK, prefetch_depth=STREAM_DEPTH)
# bench_serving's own small problem for the warm-against-cold refit gate
SMALL_REFIT = dict(d=96, n=1024, density=0.08, alpha=1.2, beta=0.8, seed=0)
SMALL_REFIT_CHUNK = 128
SMALL_REFIT_SOLVE = dict(partition="samples", loss="logistic", lam=1e-4,
                         tau=32, max_outer=30, grad_tol=5e-5,
                         pcg_rel_tol=0.01, ell_block_d=8, ell_block_n=8,
                         partition_block=SMALL_REFIT_CHUNK,
                         stream_chunk_size=SMALL_REFIT_CHUNK)


def serve_data(rt):
    """Held-out samples of the slice's generator (another seed): the
    requests, each built from its sample's sparse column, the samples a
    refit ingests and the validation set of ``refit_path``."""
    import numpy as np
    from repro_torch.glm_serve import ScoreRequest
    n = SERVE_REQUESTS + SERVE_INGEST + SERVE_VAL
    Xh, yh, _ = rt.make_sparse_glm_data(**dict(SLICE, n=n, seed=SERVE_SEED))
    T = Xh.transpose()               # (n, d): a sample a row
    reqs = [ScoreRequest(
        T.indices[T.indptr[i]:T.indptr[i + 1]].astype(np.int64),
        T.data[T.indptr[i]:T.indptr[i + 1]]) for i in range(SERVE_REQUESTS)]

    def part(lo, hi):
        return T.take_rows(np.arange(lo, hi)).transpose(), yh[lo:hi]
    ingest = part(SERVE_REQUESTS, SERVE_REQUESTS + SERVE_INGEST)
    val = part(SERVE_REQUESTS + SERVE_INGEST, n)
    reqs_csr = part(0, SERVE_REQUESTS)[0]
    return reqs, reqs_csr, ingest, val


def serve_batches(reqs, batch):
    """The micro-batches K1 and a tick are measured on: ``SERVE_LAYOUTS``
    requests from the head, where ``batch`` (the engine's) is the median
    of the consecutive ``batch``-request ticks by nonzeros, and the head's
    ``batch`` beside it (the generator's power law over samples makes the
    head the heaviest). Returns ``[(label, requests)]``."""
    import numpy as np
    ticks = [reqs[i:i + batch] for i in range(0, len(reqs), batch)]
    nnz = np.array([sum(r.nnz for r in t) for t in ticks])
    median = ticks[int(np.argsort(nnz)[len(nnz) // 2])]
    out = []
    for B in SERVE_LAYOUTS:
        if B == batch:
            out += [(f"{B} median", median), (f"{B} head", reqs[:B])]
        else:
            out.append((str(B), reqs[:B]))
    return out


def queued_device_ms(torch, fn, reps: int = 1, cycles: int = 20_000_000):
    """Device milliseconds a call of ``fn`` (which must not synchronize)
    over ``reps`` calls, the host's work taken out: the calls are queued
    behind a spin kernel (``torch.cuda._sleep``) that outlasts their
    launches, so they run back to back between two events. No profiler
    is involved. If the start event had passed by the time the last call
    was queued, the host fell behind and the spin is doubled (three
    tries); None if it never held."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        behind = start.query()
        torch.cuda.synchronize()
        if not behind:
            return start.elapsed_time(end) / reps
        cycles *= 2
    return None


def serve_k1_layouts(torch, sparse_hvp, ref, batches, w, timings) -> None:
    """K1 at the scoring tiles (8 x 128, rows of requests) on packed
    micro-batches (:func:`serve_batches`), f32 and bf16: the card's pack
    against the host's bit for bit; with the plan's schedule and without
    against the plain version (relative L2 1e-5; at bf16 the plain version
    at bf16 tiles, rounding ``w`` as F10), each call repeated bit for bit;
    NaN in the slots past the live ones, which the scheduled call must not
    read. Timed: µs a call between events, µs on the card
    (:func:`queued_device_ms`), its bound (the live tiles' bytes, the
    column ids of the live tiles, ``w`` and the margins once over the HBM
    rate), and one ``torch.sparse_csr_tensor`` product of the batch. The
    kernels line's scoring figures are the median batch's, the share from
    the device time only."""
    import numpy as np
    from repro_torch.data.sparse import hvp_tile_dtype
    from repro_torch.glm_serve import RequestPacker
    d = len(w)
    for tiles in ("float32", "bfloat16"):
        tdt = hvp_tile_dtype(tiles)
        name = "ell_mv" if tiles == "float32" else "ell_mv_bf16"
        for label, part in batches:
            B = len(part)
            kw = dict(block_b=8, block_d=128, tile_dtype=tdt)
            p = RequestPacker(d, B, device="cuda", **kw)
            data, cols, sched = p.pack_scheduled(part)
            hdata, hcols = RequestPacker(d, B, device="cpu", **kw).pack(part)
            check(torch.equal(data.cpu().float(), hdata.float())
                  and torch.equal(cols.cpu(), hcols),
                  f"serve-glm pack B={label} {tiles}: the card's tiles are "
                  f"the host's bit for bit")
            wp = p.pad_weights(w)
            want = ref.ref_ell_mv(data, cols, wp)
            for tag, s in (("scheduled", sched), ("every slot", None)):
                got = sparse_hvp.ell_mv(data, cols, wp, sched=s)
                e = rel_err(got, want)
                again = sparse_hvp.ell_mv(data, cols, wp, sched=s)
                check(e <= REL_TOL_KERNEL and torch.equal(got, again),
                      f"serve-glm {name} B={label} {tag}: rel err {e:.2e}, "
                      f"repeats bit for bit")
            nb = data.shape[0]
            live = sched[:nb].long()
            pad = torch.arange(data.shape[1], device=data.device)[None, :] \
                >= live[:, None]
            poisoned = data.clone()
            poisoned[pad] = float("nan")
            got = sparse_hvp.ell_mv(poisoned, cols, wp, sched=sched)
            check(torch.equal(got, sparse_hvp.ell_mv(data, cols, wp,
                                                     sched=sched)),
                  f"serve-glm {name} B={label}: NaN padding left unread")
            del poisoned
            n_live, stored = int(live.sum()), data.shape[0] * data.shape[1]

            def call():
                return sparse_hvp.ell_mv(data, cols, wp, sched=sched)
            us = time_ms(call) * 1e3
            dev_ms = queued_device_ms(torch, call, reps=REPS)
            dev_us = None if dev_ms is None else dev_ms * 1e3
            path = sparse_hvp.last_path[name]
            bound_us = 1e6 * (n_live * (8 * 128 * data.element_size() + 4)
                              + wp.numel() * 4 + B * 4) / HBM_BYTES_PER_S
            # the library's product: the batch as a CSR tensor, @ w
            lens = [r.nnz for r in part]
            crow = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                                dtype=torch.int64, device="cuda")
            col = torch.from_numpy(np.concatenate(
                [r.indices for r in part]).astype(np.int64)).to("cuda")
            val = torch.from_numpy(np.concatenate(
                [np.asarray(r.values, np.float32) for r in part])).to("cuda")
            A = torch.sparse_csr_tensor(crow, col, val, size=(B, d),
                                        check_invariants=True)
            wd = wp[:d].contiguous()
            lib = A @ wd
            e_lib = (rel_err(lib, want[:B]) if tiles == "float32" else None)
            lib_us = (time_ms(lambda: A @ wd) * 1e3
                      if e_lib is None or e_lib <= 1e-5 else None)
            row = dict(tiles=tiles, batch=label, nnz=int(sum(lens)),
                       path=path, live_tiles=n_live, stored_tiles=stored,
                       us=us, device_us=dev_us, bound_us=bound_us,
                       share=None if dev_us is None else bound_us / dev_us,
                       sparse_csr_us=lib_us, sparse_csr_rel_err=e_lib,
                       staged_bytes=p.staged_bytes,
                       tile_bytes=data.numel() * data.element_size())
            print("serve-glm k1 " + json.dumps(row), flush=True)
            if label.endswith("median"):
                timings.setdefault(name, {}).update(
                    scoring_us=us, scoring_device_us=dev_us,
                    scoring_bound_us=bound_us, scoring_nnz=row["nnz"],
                    scoring_live_tiles=n_live, scoring_path=path,
                    scoring_sparse_csr_us=lib_us)
            elif label.endswith("head"):
                timings.setdefault(name, {}).update(
                    scoring_head_device_us=dev_us, scoring_head_nnz=row["nnz"])
            del data, cols, sched, want, A


def serve_tick(torch, ops, eng, part) -> dict:
    """One tick of ``eng`` on ``part``: the host's plan ms, the tick's ms
    (median of 20, plan to margins on the host), its host syncs, its
    device µs whole and in parts (:func:`queued_device_ms`: the staging
    copy and tile fill, K1, the copy back) and the device's busy share of
    the tick, K1's launches, and the bytes it ships."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    for _ in range(20):
        eng.packer.plan(part)
    plan_ms = (time.perf_counter() - t0) / 20 * 1e3
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        eng.score(part)
        times.append(time.perf_counter() - t0)
    tick_ms = statistics.median(times) * 1e3
    syncs = count_host_syncs(torch, lambda: eng.score(part))
    build.reset_launch_counts()
    eng.score(part)
    k1 = sum(build.launch_counts().values())
    wp = eng.packer.pad_weights(eng.w)
    data, cols, sched = eng.packer.pack_scheduled(part)
    y = ops.ell_matvec(data, cols, wp, sched=sched)

    def whole():
        dd, cc, ss = eng.packer.pack_scheduled(part)
        ops.ell_matvec(dd, cc, wp, sched=ss)[:len(part)].to(
            "cpu", non_blocking=True)
    parts = dict(
        staging=queued_device_ms(torch, lambda: eng.packer.pack_scheduled(
            part), cycles=100_000_000),
        k1=queued_device_ms(torch, lambda: ops.ell_matvec(
            data, cols, wp, sched=sched), reps=REPS),
        copy_back=queued_device_ms(torch, lambda: y[:len(part)].to(
            "cpu", non_blocking=True), reps=REPS))
    dev_ms = queued_device_ms(torch, whole, cycles=100_000_000)
    return dict(nnz=int(sum(r.nnz for r in part)), plan_ms=plan_ms,
                tick_ms=tick_ms, host_syncs=syncs, k1_launches=k1,
                staged_bytes=eng.packer.staged_bytes,
                reference_tile_bytes=eng.packer.n_row_blocks
                * eng.packer.width * 8 * 128 * 4,
                device_us=None if dev_ms is None else dev_ms * 1e3,
                device_parts_us={k: None if v is None else v * 1e3
                                 for k, v in parts.items()},
                busy_share=None if dev_ms is None else dev_ms / tick_ms)


def serve_glm_phase(torch, rt, build, sparse_hvp, ref, keep, launches,
                    timings) -> None:
    """The GLM serving plane on the sparse slice (``keep``: its X, y, the
    first run's DiSCO-S m = 1 f32 result and config, DiSCO-S m = 4's w,
    and the store of ``store_roundtrip``).

    K1 on the scoring layouts (:func:`serve_k1_layouts`); the registry
    (publish, load bit for bit, ACTIVE); predict / predict_proba against
    ``GLMProblem``'s on the requests' CSR. Then the main path, its launch
    window: the engine scoring ``SERVE_REQUESTS`` held-out requests at f32
    and bf16, the scheduler over all of them at bf16, and at f32 with
    every eighth past a deadline of 0 s and a second version published
    mid-stream, traced; a streamed warm refit of the grown store; and
    ``refit_path`` with a validation set. Its results are checked after
    the window: against ``oracle_margins`` (bench_serving's gate), the
    same engine on the CPU (1e-6), ``score``'s margins, the in-memory
    solve whose shards are the store's chunks (bit for bit). Last, the
    measurements (ticks, one request a tick) and bench_serving's
    warm-against-cold gate on its own small problem. The launch counts of
    the window are added to the slice's."""
    import dataclasses
    import numpy as np
    from repro_torch import obs
    from repro_torch.core import comm
    from repro_torch.data import ShardStore
    from repro_torch.glm_serve import (MicroBatchScheduler, ModelRegistry,
                                       RefitLoop, ScoringEngine,
                                       oracle_margins)
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    X, y, res, cfg = keep["X"], keep["y"], keep["res"], keep["cfg"]
    w1 = np.asarray(res.w)
    reqs, reqs_csr, (Xi, yi), (Xv, yv) = serve_data(rt)
    nnz = float(np.mean([r.nnz for r in reqs]))
    batches = serve_batches(reqs, 64)
    print(f"serve-glm data: {len(reqs)} requests, {nnz:.1f} nonzeros a "
          f"request; {Xi.shape[1]} to ingest, {Xv.shape[1]} to validate "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)
    serve_k1_layouts(torch, sparse_hvp, ref, batches, w1, timings)
    t_k1 = time.perf_counter() - t_phase

    reg = ModelRegistry(f"{keep['dir']}/registry")
    v1 = reg.publish(res, cfg)
    pub = reg.load()
    check(v1 == 1 and reg.active_version() == 1
          and pub.w.tobytes() == w1.tobytes() and pub.w.dtype == w1.dtype
          and pub.cfg == cfg and pub.result.history == res.history
          and pub.result.ledger == res.ledger
          and pub.result.partition_info == res.partition_info,
          "serve-glm registry: the slice's fit published, loaded back "
          "(w bit for bit; config, history, ledger equal), ACTIVE flipped")

    # checks' inputs, before the launch window: predict / predict_proba,
    # and each version's margins on the requests the scheduler scores
    engines = {t: ScoringEngine(reg, hvp_dtype=t, device="cuda")
               for t in ("float32", "bfloat16")}
    eng = engines["float32"]
    prob = rt.GLMProblem.create(np.zeros((len(w1), 1), np.float32),
                                np.ones(1, np.float32), device="cpu")
    pred_ok = np.array_equal(eng.predict(reqs),
                             prob.predict(w1, reqs_csr).numpy())
    p_err = float(np.abs(eng.predict_proba(reqs)
                         - prob.predict_proba(w1, reqs_csr).numpy()).max())
    check(pred_ok and p_err <= 1e-6,
          f"serve-glm predict equals GLMProblem.predict on the requests' "
          f"CSR; predict_proba within {p_err:.1e} (limit 1e-6)")
    w2 = np.asarray(keep["w_m4"], w1.dtype)
    res2 = dataclasses.replace(res, w=w2)
    valid = [r for i, r in enumerate(reqs) if i % SERVE_DEADLINE_EVERY]
    by_v = {1: eng.score(valid),
            2: ScoringEngine(w2, loss="logistic", device="cuda")
            .score(valid)}
    rcfg = rt.DiscoConfig(**REFIT_SOLVE)
    store = ShardStore(keep["store"])
    loop = RefitLoop(reg, store, rcfg, device="cuda")

    # the main path: its launch window
    build.reset_launch_counts()
    got, score_s = {}, {}
    for t, e in engines.items():
        t0 = time.perf_counter()
        got[t] = e.score(reqs)
        score_s[t] = time.perf_counter() - t0
    sb = MicroBatchScheduler(engines["bfloat16"])
    rids_b = [sb.submit(r) for r in reqs]
    fin_b = sb.run_until_done()
    tracer = obs.enable(reset=True)
    sched = MicroBatchScheduler(eng)
    rids = [sched.submit(r, deadline_s=None if i % SERVE_DEADLINE_EVERY
                         else 0.0) for i, r in enumerate(reqs)]
    t0 = time.perf_counter()
    while sched.waiting:
        if sched.stats.ticks == SERVE_SWAP_TICK and reg.active_version() == 1:
            v2 = reg.publish(res2, cfg)
        sched.tick()
    elapsed = time.perf_counter() - t0
    events, counters, _ = tracer.snapshot()
    obs.disable()
    w0 = reg.load().w
    t0 = time.perf_counter()
    n_grown = loop.ingest(Xi, yi)
    v3, warm = loop.refit(warm=True)
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    active3, w3 = reg.active_version(), reg.load().w
    t0 = time.perf_counter()
    v4, path = loop.refit_path(LAMBDAS, X_val=Xv, y_val=yv)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    counts = build.launch_counts()
    for k in launches:
        launches[k] += counts.get(k, 0)
    check(counts["ell_mv"] > 0 and counts["ell_mv_bf16"] > 0,
          f"serve-glm: K1 launched on the serving path ({counts['ell_mv']} "
          f"f32, {counts['ell_mv_bf16']} bf16)")

    # the main path's results
    want = oracle_margins(reqs, w1)
    scale = max(float(np.abs(want).max()), 1e-30)
    for t in engines:
        err = float(np.abs(got[t] - want).max()) / scale
        check(err <= SERVE_GATE[t],
              f"serve-glm score {t}: {len(reqs)} requests, max err "
              f"{err:.2e} of max |margin| against oracle_margins "
              f"(gate {SERVE_GATE[t]:.0e}; {len(reqs) / score_s[t]:.0f} "
              f"req/s)")
    cpu = ScoringEngine(w1, loss="logistic", device="cpu").score(
        reqs[:SERVE_CPU])
    e = float(np.abs(got["float32"][:SERVE_CPU] - cpu).max()) / scale
    check(e <= 1e-6, f"serve-glm score: card against the CPU engine on the "
                     f"first {SERVE_CPU} requests {e:.2e} of max |margin| "
                     f"(limit 1e-6)")
    mb = np.array([fin_b[r].margin for r in rids_b])
    e = float(np.abs(mb - want).max()) / scale
    check(sb.stats.completed == len(reqs)
          and np.array_equal(mb, got["bfloat16"].astype(np.float64))
          and e <= SERVE_GATE["bfloat16"],
          f"serve-glm scheduler bfloat16: {sb.stats.completed} requests, "
          f"every margin equals score's, {e:.2e} of max |margin| against "
          f"oracle_margins (gate {SERVE_GATE['bfloat16']:.0e})")
    st = sched.stats
    fin = sched.finished
    done = [fin[r] for i, r in enumerate(rids) if i % SERVE_DEADLINE_EVERY]
    rejected = [fin[r] for i, r in enumerate(rids)
                if not i % SERVE_DEADLINE_EVERY]
    exact = all(c.margin == float(by_v[1 if c.tick < SERVE_SWAP_TICK else 2][k])
                for k, c in enumerate(done))
    late = np.array([c.margin for c in done if c.tick >= SERVE_SWAP_TICK])
    late_want = oracle_margins(
        [r for r, c in zip(valid, done) if c.tick >= SERVE_SWAP_TICK], w2)
    e2 = float(np.abs(late - late_want).max()) / scale
    early = np.array([c.margin for c in done if c.tick < SERVE_SWAP_TICK])
    e1 = float(np.abs(early - oracle_margins(
        [r for r, c in zip(valid, done) if c.tick < SERVE_SWAP_TICK],
        w1)).max()) / scale
    check(st.completed + st.rejected == len(reqs)
          and st.rejected == len(rejected)
          and all(c.rejected and c.margin is None for c in rejected)
          and not any(c.rejected for c in done) and exact
          and e1 <= SERVE_GATE["float32"],
          f"serve-glm scheduler: {st.completed} scored + {st.rejected} "
          f"rejected = {len(reqs)} submitted; every margin equals score's, "
          f"{e1:.2e} of max |margin| against oracle_margins before the "
          f"swap")
    check(eng.reloads == 1 and eng.version == v2 == 2 and len(late) > 0
          and e2 <= SERVE_GATE["float32"],
          f"serve-glm scheduler: v2 served from tick {SERVE_SWAP_TICK} on "
          f"({len(late)} requests, err {e2:.2e} against its oracle)")
    spans = [e for e in events if e.kind == "serve.tick"]
    check(len(spans) == st.ticks
          and counters.get("serve.scored") == st.completed
          and sum(e.kind == "serve.hot_swap" for e in events) == 1
          and sum(e.kind == "registry.publish" for e in events) == 1,
          f"serve-glm traced: {len(spans)} serve.tick spans for "
          f"{st.ticks} ticks, serve.scored = {counters.get('serve.scored')}"
          f", one serve.hot_swap")
    t0 = time.perf_counter()
    Xg, yg = store.to_csr()
    twin = rt.DiscoSolver(
        Xg, yg, dataclasses.replace(rcfg, partition_strategy="width"),
        group=rt.InProcessGroup(store.n_chunks), device="cuda").fit(w0=w0)
    check(n_grown == SLICE["n"] + SERVE_INGEST and v3 == 3 and active3 == 3
          and np.array_equal(w3, warm.w)
          and np.array_equal(warm.w, twin.w)
          and [h["pcg_iters"] for h in warm.history]
          == [h["pcg_iters"] for h in twin.history],
          f"serve-glm refit: {SERVE_INGEST} samples ingested "
          f"({n_grown} in {store.n_chunks} chunks), the warm streamed refit "
          f"published as v{v3} and active, equal bit for bit to the "
          f"in-memory solve whose shards are the chunks "
          f"(grad {warm.history[0]['grad_norm']:.3e} -> "
          f"{warm.history[-1]['grad_norm']:.3e})")
    twin_s = time.perf_counter() - t0
    del twin, Xg, yg
    best = path.best_index
    check(v4 == 4 and reg.active_version() == 4 and best is not None
          and loop.cfg.lam == path.lambdas[best] == reg.load().cfg.lam
          and np.array_equal(reg.load().w, path.results[best].w),
          f"serve-glm refit_path over {LAMBDAS}: winner lam "
          f"{path.best_lambda:g} (val losses "
          f"{[round(v, 6) for v in path.val_losses]}) published as v{v4}")

    t_main = time.perf_counter() - t_phase - t_k1

    # measurements, after the window: a tick of the median and of the
    # head batch, one request a tick, and the small warm-against-cold gate
    t0 = time.perf_counter()
    count_host_syncs(torch, lambda: None)   # its first use warns once more
    tick = {label.split()[-1]: serve_tick(torch, ops, eng, part)
            for label, part in batches if label.startswith(f"{eng.batch} ")}
    per_tick = {k: (t["host_syncs"], t["k1_launches"])
                for k, t in tick.items()}
    check(all(v == (1, 1) for v in per_tick.values()),
          f"serve-glm tick: one host sync and one K1 launch a tick "
          f"(host syncs, K1 launches: {per_tick})")
    seq = ScoringEngine(reg, batch=1, device="cuda")
    seq.score(reqs[:1])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for r in reqs[:SERVE_SEQUENTIAL]:
        seq.score([r])
    seq_rps = SERVE_SEQUENTIAL / (time.perf_counter() - t1)
    t1 = time.perf_counter()
    small = dict(small_refit_gate(rt, keep["dir"]),
                 seconds=time.perf_counter() - t1)
    t_meas = time.perf_counter() - t0

    model_tick = comm.glm_serving_tick_time(
        eng.batch, nnz, ell_width=eng.packer.width, block_b=8, block_d=128)
    model_rps = comm.glm_serving_throughput(
        eng.batch, nnz, ell_width=eng.packer.width, block_b=8, block_d=128)
    row = dict(requests=len(reqs), nnz_per_request=nnz,
               batched_rps=st.throughput_rps(elapsed),
               sequential_rps=seq_rps, p50_ms=st.p50_s * 1e3,
               p99_ms=st.p99_s * 1e3, busy_share_scheduler=st.busy_s / elapsed,
               ticks=st.ticks, tick=tick, launches=counts, refit_s=refit_s,
               twin_s=twin_s, refit_newton=len(warm.history),
               refit_path_s=path_s, small_refit=small,
               model_figures=dict(tick_s=model_tick["total_s"],
                                  batched_rps=model_rps["batched_rps"],
                                  sequential_rps=model_rps["sequential_rps"]),
               k1_s=t_k1, main_path_s=t_main, measurements_s=t_meas)
    print("serve-glm " + json.dumps(row), flush=True)
    print(f"serve-glm phase: {time.perf_counter() - t_phase:.1f} s (K1 "
          f"layouts {t_k1:.1f}, the main path and its checks {t_main:.1f}, "
          f"measurements {t_meas:.1f})", flush=True)


def small_refit_gate(rt, tmp) -> dict:
    """bench_serving's warm-against-cold refit gate on its own problem:
    fit from a store of the first 15/16 of the samples, publish, ingest
    the rest, refit warm and cold; the warm refit takes at most half the
    cold one's Newton steps, both converged."""
    from repro_torch.data import ShardStore
    from repro_torch.glm_serve import ModelRegistry, RefitLoop
    X, y, _ = rt.make_sparse_glm_data(**SMALL_REFIT)
    n0 = X.shape[1] - X.shape[1] // 16
    T = X.transpose()

    def part(lo, hi):
        import numpy as np
        return T.take_rows(np.arange(lo, hi)).transpose(), y[lo:hi]
    cfg = rt.DiscoConfig(**SMALL_REFIT_SOLVE)
    store = ShardStore.from_csr(*part(0, n0), f"{tmp}/small_store",
                                axis="samples", chunk_size=SMALL_REFIT_CHUNK)
    reg = ModelRegistry(f"{tmp}/small_registry")
    reg.publish(rt.DiscoSolver.from_store(store, cfg, device="cuda").fit(),
                cfg)
    loop = RefitLoop(reg, store, cfg, device="cuda")
    loop.ingest(*part(n0, X.shape[1]))
    _, warm = loop.refit(warm=True)
    _, cold = loop.refit(warm=False)
    iw, ic = loop.newton_iters(warm), loop.newton_iters(cold)
    check(warm.converged and cold.converged and 2 * iw <= ic,
          f"serve-glm warm refit {iw} Newton steps against cold {ic} "
          f"(gate: at most half), both converged")
    return dict(warm_newton=iw, cold_newton=ic)


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def make_dense_data(torch, dev, d, n, cond_decay, seed):
    """``make_glm_data``'s recipe, made on the card from a seeded
    generator (on the host the (d, d) @ (d, n) product alone is about
    9 TFLOP): feature covariance with singular values k^-cond_decay,
    unit-norm columns, +-1 labels from a logistic model of a random
    w_true. Returns X (d, n) f32 and y (n,) on the card, and the model
    (mixing matrix, w_true, margin scale) for held-out samples."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f64 = torch.float64
    scales = torch.arange(1, d + 1, dtype=f64, device=dev) ** (-cond_decay)
    Q, _ = torch.linalg.qr(torch.randn((d, d), generator=g, device=dev,
                                       dtype=f64))
    A = (Q * scales.sqrt()[None, :]).float()
    del Q
    X = A @ torch.randn((d, n), generator=g, device=dev)
    X /= torch.clamp(torch.linalg.norm(X, dim=0, keepdim=True), min=1e-12)
    w_true = torch.randn(d, generator=g, device=dev) / d ** 0.5
    margins = X.T @ w_true
    scale = torch.clamp(margins.std(), min=1e-9)
    p = torch.sigmoid(margins / scale)
    y = torch.where(torch.rand(n, generator=g, device=dev) < p, 1.0, -1.0)
    return X, y, dict(A=A, w_true=w_true, scale=scale)


def held_out(torch, model, n, seed):
    """``n`` more samples of the same model (the recipe's steps after the
    covariance, from a generator seeded with ``seed``)."""
    A, w_true = model["A"], model["w_true"]
    g = torch.Generator(device=A.device).manual_seed(seed)
    X = A @ torch.randn((A.shape[0], n), generator=g, device=A.device)
    X /= torch.clamp(torch.linalg.norm(X, dim=0, keepdim=True), min=1e-12)
    p = torch.sigmoid(X.T @ w_true / model["scale"])
    y = torch.where(torch.rand(n, generator=g, device=A.device) < p, 1.0,
                    -1.0)
    return X, y


def measure_dense_kernels(torch, X, glm_hvp, ref, errs) -> dict:
    """Full-width checks and timings of the dense kernels on the slice's
    X, with phi''-sized scales c in [0, 1/4)."""
    d, n = X.shape
    g = torch.Generator(device=X.device).manual_seed(2)
    u = torch.randn(d, generator=g, device=X.device)
    z = torch.randn(n, generator=g, device=X.device)
    c = 0.25 * torch.rand(n, generator=g, device=X.device)
    kernel = {"xt_u": lambda: glm_hvp.xt_u(X, u),
              "x_cz": lambda: glm_hvp.x_cz(X, c, z),
              "x_c_xt_u": lambda: glm_hvp.x_c_xt_u(X, c, u)}
    plain = {"xt_u": lambda: ref.ref_xt_u(X, u),
             "x_cz": lambda: ref.ref_x_cz(X, c * z),
             "x_c_xt_u": lambda: ref.ref_x_c_xt_u(X, c, u)}
    # one PyTorch call computing the same function; K5 has none, and the
    # two-call pair is kept beside it
    library = {"xt_u": lambda: torch.mv(X.t(), u),
               "x_cz": lambda: torch.mv(X, c * z)}
    pair = lambda: torch.mv(X, c * torch.mv(X.t(), u))
    vec_bytes = {"xt_u": 4 * (d + n), "x_cz": 4 * (2 * n + d),
                 "x_c_xt_u": 4 * (n + 2 * d)}
    flops = {"xt_u": 2 * d * n, "x_cz": 2 * d * n + n,
             "x_c_xt_u": 4 * d * n + n}
    out = {}
    for name in DENSE_SINGLE:
        got, want = kernel[name](), plain[name]()
        lib = library.get(name, pair)()
        torch.cuda.synchronize()
        e = record_err(errs, name, got, want)
        check(e <= REL_TOL_KERNEL, f"{name} full width {d}x{n}: rel err "
                                   f"{e:.2e}")
        lib_ok = rel_err(lib, got) <= REL_TOL_KERNEL
        if not lib_ok:
            print(f"library call for {name} disagrees with the kernel "
                  f"({rel_err(lib, got):.2e}); not timed", flush=True)
        del got, want, lib
        t_bytes = (4 * d * n + vec_bytes[name]) / HBM_BYTES_PER_S
        t_ops = flops[name] / F32_FLOPS_PER_S
        ms = time_ms(kernel[name])
        lib_ms = time_ms(library.get(name, pair)) if lib_ok else None
        out[name] = dict(
            ms=ms, plain_ms=time_ms(plain[name]),
            library_ms=lib_ms if name in library else None,
            bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=4 * d * n + vec_bytes[name],
            gbps=(4 * d * n + vec_bytes[name]) / ms / 1e6, shape=[d, n])
        if name not in library:
            out[name]["library_pair_ms"] = lib_ms
    fused = out["x_c_xt_u"]
    # the fit rule's candidates: its plan on each cluster size it allows
    fused["plan_ms"] = {
        f"Q{q}": time_ms(lambda: glm_hvp.x_c_xt_u(X, c, u, _cluster=q))
        for q in glm_hvp.CLUSTER_SIZES if glm_hvp.fused_plan(d, 1, q)}
    fused["two_pass_kernels_ms"] = time_ms(
        lambda: glm_hvp.x_cz(X, c, glm_hvp.xt_u(X, u)))
    shards = measure_dense_shards(torch, X, u, z, c, glm_hvp, ref, errs)
    for name in ("xt_u", "x_cz"):
        out[name]["shapes"] = shards[name]
    out.update(measure_dense_multi(torch, X, c, glm_hvp, ref, errs))
    for name, shapes in measure_fused_shapes(torch, X, u, c, glm_hvp, ref,
                                             errs).items():
        out[name]["shapes"] = shapes
        out[name]["plan"] = shapes["full"]["plan"]
    for name in DENSE_KERNELS:
        m = out[name]
        print(f"{name} full width {m['shape']}: {m['ms'] * 1e3:.1f} us/call,"
              f" {m['gbps']:.0f} GB/s over {m['bytes'] / 1e9:.2f} GB,"
              f" bound {m['bound_ms'] * 1e3:.1f} us ({m['bound_by']}),"
              f" plain {m['plain_ms'] * 1e3:.1f} us,"
              f" library {m['library_ms']}", flush=True)
    print("x_c_xt_u detail " + json.dumps(
        {k: fused[k] for k in ("plan", "plan_ms", "two_pass_kernels_ms",
                               "library_pair_ms")}), flush=True)
    return out


def measure_fused_shapes(torch, X, u, c, glm_hvp, ref, errs) -> dict:
    """K5 at the dense slice's three shapes (the full width, the DiSCO-S
    m = 4 column view X[:, :n/4] and the DiSCO-F m = 4 row block X[:d/4])
    and K10 (s = TIMED_S) at the first two, where the solver passes them:
    each held against its plain version, repeated bit for bit on the TMA
    path, and timed beside the two-pass kernel pair it fuses (K3 + K4, K8
    + K9), the two-call library pair and its bound (X's bytes over the HBM
    rate), with its plan, clusters and path."""
    d, n = X.shape
    s = TIMED_S
    g = torch.Generator(device=X.device).manual_seed(4)
    U = torch.randn((d, s), generator=g, device=X.device)
    shapes = {"full": (X, u, c, U),
              "S_m4_view": (X[:, :n // 4], u, c[:n // 4], U),
              "F_m4_rows": (X[:d // 4], u[:d // 4], c, U[:d // 4])}
    out = {"x_c_xt_u": {}, "x_c_xt_multi": {}}
    for shape, (A, ua, ca, Ua) in shapes.items():
        calls = {
            "x_c_xt_u": (lambda: glm_hvp.x_c_xt_u(A, ca, ua),
                         lambda: ref.ref_x_c_xt_u(A, ca, ua),
                         lambda: glm_hvp.x_cz(A, ca, glm_hvp.xt_u(A, ua)),
                         lambda: torch.mv(A, ca * torch.mv(A.t(), ua)))}
        if shape != "F_m4_rows":
            calls["x_c_xt_multi"] = (
                lambda: glm_hvp.x_c_xt_multi(A, ca, Ua),
                lambda: ref.ref_x_c_xt_multi(A, ca, Ua),
                lambda: glm_hvp.x_cz_multi(A, ca, glm_hvp.xt_multi(A, Ua)),
                lambda: A @ (ca[:, None] * (A.t() @ Ua)))
        for name, (kernel, plain, pair, library) in calls.items():
            got, again, want = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            run = glm_hvp.last_fused[name]
            e = record_err(errs, name, got, want)
            same = bool(torch.equal(got, again))
            check(e <= REL_TOL_KERNEL and same and run.path == "bulk",
                  f"{name} {shape} {tuple(A.shape)}: rel err {e:.2e}, "
                  f"repeatable {same}, {fused_tag(run)}")
            del got, again, want
            row = dict(dims=list(A.shape), path=run.path,
                       plan=dict(run.plan._asdict(), clusters=run.clusters),
                       us=time_ms(kernel) * 1e3,
                       kernel_pair_us=time_ms(pair) * 1e3,
                       library_pair_us=time_ms(library) * 1e3,
                       bound_us=1e6 * A.numel() * 4 / HBM_BYTES_PER_S)
            row["of_bound"] = row["bound_us"] / row["us"]
            out[name][shape] = row
            print(f"{name} {shape} {row['dims']}: {row['us']:.1f} us/call "
                  f"({100 * row['of_bound']:.1f}% of bound "
                  f"{row['bound_us']:.1f} us), kernel pair "
                  f"{row['kernel_pair_us']:.1f} us, library pair "
                  f"{row['library_pair_us']:.1f} us, {fused_tag(run)}",
                  flush=True)
    return out


def measure_dense_shards(torch, X, u, z, c, glm_hvp, ref, errs) -> dict:
    """K3 and K4 at the dense slice's three shapes: the full width, the
    DiSCO-S m = 4 column view X[:, :n/4] and the DiSCO-F m = 4 row block
    X[:d/4], each held against its plain version, repeated bit for bit,
    and timed beside torch.mv and its bound (X's bytes over the HBM
    rate), with the copy path it took."""
    d, n = X.shape
    shapes = {"full": (X, u, z, c),
              "S_m4_view": (X[:, :n // 4], u, z[:n // 4], c[:n // 4]),
              "F_m4_rows": (X[:d // 4], u[:d // 4], z, c)}
    out = {"xt_u": {}, "x_cz": {}}
    for shape, (A, ua, za, ca) in shapes.items():
        calls = {
            "xt_u": (lambda: glm_hvp.xt_u(A, ua),
                     lambda: ref.ref_xt_u(A, ua),
                     lambda: torch.mv(A.t(), ua)),
            "x_cz": (lambda: glm_hvp.x_cz(A, ca, za),
                     lambda: ref.ref_x_cz(A, ca * za),
                     lambda: torch.mv(A, ca * za))}
        for name, (kernel, plain, library) in calls.items():
            got, again, want = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            path = glm_hvp.last_path[name]
            e = record_err(errs, name, got, want)
            same = bool(torch.equal(got, again))
            check(e <= REL_TOL_KERNEL and same and path == "bulk",
                  f"{name} {shape} {tuple(A.shape)}: rel err {e:.2e}, "
                  f"repeatable {same}, path {path}")
            del got, again, want
            row = dict(dims=list(A.shape), path=path,
                       us=time_ms(kernel) * 1e3,
                       library_us=time_ms(library) * 1e3,
                       bound_us=1e6 * A.numel() * 4 / HBM_BYTES_PER_S)
            row["of_bound"] = row["bound_us"] / row["us"]
            out[name][shape] = row
            print(f"{name} {shape} {row['dims']}: {row['us']:.1f} us/call "
                  f"({100 * row['of_bound']:.1f}% of bound "
                  f"{row['bound_us']:.1f} us), torch.mv "
                  f"{row['library_us']:.1f} us, path {path}", flush=True)
    return out


def measure_dense_multi(torch, X, c, glm_hvp, ref, errs) -> dict:
    """Full-width checks and timings of xt_multi, x_cz_multi and the fused
    x_c_xt_multi at TIMED_S columns, beside torch.matmul (cuBLAS) of the
    same product (for x_c_xt_multi the two-call pair, and the kernel
    pair), and their times at 1, 4 and 8 columns (one read of X serves
    them all). The checks take strided blocks (the first s columns of 8);
    the timings take the main path's layouts: xt_multi the strided U that
    DiSCO-F passes, x_cz_multi the contiguous Z that pass A and the
    all-reduce leave, x_c_xt_multi the contiguous basis of a DiSCO-S
    round. x_cz_multi and x_c_xt_multi re-read their (n, s) or (d, s)
    block from L2, so a strided block is slower; its time is kept too."""
    d, n = X.shape
    s = TIMED_S
    g = torch.Generator(device=X.device).manual_seed(3)
    U8 = torch.randn((d, 8), generator=g, device=X.device)
    Z8 = torch.randn((n, 8), generator=g, device=X.device)
    Uc = {k: U8[:, :k].contiguous() for k in (1, 4, s, 8)}
    Zc = {k: Z8[:, :k].contiguous() for k in (1, 4, s, 8)}
    U, Z = Uc[s], Zc[s]
    checked = {"xt_multi": lambda: glm_hvp.xt_multi(X, U8[:, :s]),
               "x_cz_multi": lambda: glm_hvp.x_cz_multi(X, c, Z8[:, :s]),
               "x_c_xt_multi": lambda: glm_hvp.x_c_xt_multi(X, c, U8[:, :s])}
    timed = {"xt_multi": lambda k=s: glm_hvp.xt_multi(X, U8[:, :k]),
             "x_cz_multi": lambda k=s: glm_hvp.x_cz_multi(X, c, Zc[k]),
             "x_c_xt_multi": lambda k=s: glm_hvp.x_c_xt_multi(X, c, Uc[k])}
    plain = {"xt_multi": lambda: ref.ref_xt_multi(X, U),
             "x_cz_multi": lambda: ref.ref_x_cz_multi(X, c, Z),
             "x_c_xt_multi": lambda: ref.ref_x_c_xt_multi(X, c, U)}
    library = {"xt_multi": lambda: X.t() @ U,
               "x_cz_multi": lambda: X @ (c[:, None] * Z)}
    # no single PyTorch call computes x_c_xt_multi: the two-call pair is
    # kept beside it
    pair = lambda: X @ (c[:, None] * (X.t() @ U))
    vec_bytes = {"xt_multi": 4 * (d * s + n * s),
                 "x_cz_multi": 4 * (n * s + n + d * s),
                 "x_c_xt_multi": 4 * (2 * d * s + n)}
    flops = {"xt_multi": 2 * d * n * s, "x_cz_multi": 2 * d * n * s + n * s,
             "x_c_xt_multi": 4 * d * n * s + n * s}
    out = {}
    for name in ("xt_multi", "x_cz_multi", "x_c_xt_multi"):
        got, want = checked[name](), plain[name]()
        lib = library.get(name, pair)()
        torch.cuda.synchronize()
        e = record_err(errs, name, got, want)
        check(e <= REL_TOL_KERNEL, f"{name} full width {d}x{n} s={s} "
                                   f"(strided): rel err {e:.2e}")
        check(bool(torch.equal(got, checked[name]())),
              f"{name} full width: repeatable bit for bit")
        lib_ok = rel_err(lib, got) <= REL_TOL_KERNEL
        if not lib_ok:
            print(f"library call for {name} disagrees with the kernel "
                  f"({rel_err(lib, got):.2e}); not timed", flush=True)
        del got, want, lib
        nbytes = 4 * d * n + vec_bytes[name]
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops[name] / F32_FLOPS_PER_S
        ms = time_ms(timed[name])
        lib_ms = time_ms(library.get(name, pair)) if lib_ok else None
        out[name] = dict(
            ms=ms, plain_ms=time_ms(plain[name]),
            library_ms=lib_ms if name in library else None,
            bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes, gbps=nbytes / ms / 1e6, shape=[d, n, s],
            ms_by_s={k: time_ms(lambda: timed[name](k)) for k in (1, 4, 8)})
        if name != "xt_multi":
            out[name]["ms_strided"] = time_ms(checked[name])
        if name not in library:
            out[name]["library_pair_ms"] = lib_ms
    fused = out["x_c_xt_multi"]
    fused.update(
        kernel_pair_ms=time_ms(lambda: glm_hvp.x_cz_multi(
            X, c, glm_hvp.xt_multi(X, U))),
        x_c_xt_u_ms=time_ms(lambda: glm_hvp.x_c_xt_u(X, c, Uc[1][:, 0])))
    print("x_c_xt_multi detail " + json.dumps(
        {k: fused[k] for k in ("ms_by_s", "ms_strided",
                               "kernel_pair_ms", "library_pair_ms",
                               "x_c_xt_u_ms")})
          + " x_cz_multi " + json.dumps(
              {k: out["x_cz_multi"][k] for k in ("ms_by_s", "ms_strided")}),
          flush=True)
    return out


def measure_dense_bf16(torch, X, glm_hvp, ref, errs, f32) -> dict:
    """The four bf16 instances on a bf16 copy of the dense slice's X (2
    GiB), at the full width and the m = 4 shard shapes (the DiSCO-S column
    view X[:, :n/4], the DiSCO-F row block X[:d/4]), K8 and K9 at s =
    TIMED_S on the main path's layouts (a strided U as DiSCO-F passes it,
    a contiguous Z) and at the full width also at s = 8 and 13 (two
    launches): each held to its plain version at bf16 (<= 1e-5), repeated
    bit for bit (K3 and K4 on the bulk path), and timed beside the plain
    version and one PyTorch call on the same bf16 X with the vector
    rounded to bf16 (``torch.mv`` / ``@``, cuBLAS: the library time; its
    output is bf16, so it is held to the kernel at 1e-2 only to show it
    computes the same function), with the f32 kernel's time of the same
    call (``f32``). Bound: X's 2-byte elements and the f32 vectors once
    over the HBM rate (the f32 FMAs over the f32 peak are 20x less)."""
    from repro_torch.kernels import ops
    d, n = X.shape
    dev = X.device
    Xh = X.to(torch.bfloat16)
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(5)
    u = torch.randn(d, generator=g, device=dev)
    z = torch.randn(n, generator=g, device=dev)
    c = 0.25 * torch.rand(n, generator=g, device=dev)
    s = TIMED_S
    U13 = torch.randn((d, 13), generator=g, device=dev)
    Z13 = torch.randn((n, 13), generator=g, device=dev)
    Z = Z13[:, :s].contiguous()
    shapes = {"full": (Xh, u, z, c, U13[:, :s], Z),
              "S_m4_view": (Xh[:, :n // 4], u, z[:n // 4], c[:n // 4],
                            U13[:, :s], Z[:n // 4]),
              "F_m4_rows": (Xh[:d // 4], u[:d // 4], z, c,
                            U13[:d // 4, :s], Z)}
    out = {}
    for shape, (A, ua, za, ca, Ua, Za) in shapes.items():
        calls = {
            "xt_u_bf16": (lambda: glm_hvp.xt_u(A, ua),
                          lambda: ref.ref_xt_u(A, ua),
                          lambda: torch.mv(A.t(), ua.to(bf))),
            "x_cz_bf16": (lambda: glm_hvp.x_cz(A, ca, za),
                          lambda: ref.ref_x_cz(A, ca * za),
                          lambda: torch.mv(A, (ca * za).to(bf))),
            "xt_multi_bf16": (lambda: glm_hvp.xt_multi(A, Ua),
                              lambda: ref.ref_xt_multi(A, Ua),
                              lambda: A.t() @ Ua.to(bf)),
            "x_cz_multi_bf16": (lambda: glm_hvp.x_cz_multi(A, ca, Za),
                                lambda: ref.ref_x_cz_multi(A, ca, Za),
                                lambda: A @ (ca[:, None] * Za).to(bf))}
        for name, (kernel, plain, library) in calls.items():
            got, again, want = kernel(), kernel(), plain()
            lib = library()
            torch.cuda.synchronize()
            e = record_err(errs, name, got, want)
            same = bool(torch.equal(got, again))
            lib_rel = rel_err(lib.float(), got)
            path = glm_hvp.last_path[name]
            check(e <= REL_TOL_KERNEL and same and path == "bulk",
                  f"{name} {shape} {tuple(A.shape)}: rel err {e:.2e}, "
                  f"repeatable {same}, path {path}; the library call "
                  f"(bf16 output) {lib_rel:.2e} from it")
            del got, again, want, lib
            k = Ua.shape[1] if "multi" in name else 1
            rows, cols = A.shape
            # f32 floats read once and written once beside X
            vec = {"xt_u_bf16": rows + cols, "x_cz_bf16": 2 * cols + rows,
                   "xt_multi_bf16": (rows + cols) * k,
                   "x_cz_multi_bf16": cols * k + cols + rows * k}[name]
            nbytes = 2 * A.numel() + 4 * vec
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = 2 * A.numel() * k / F32_FLOPS_PER_S
            ms = time_ms(kernel)
            row = dict(ms=ms, library_ms=time_ms(library) if lib_rel <= 1e-2
                       else None,
                       bound_ms=1e3 * max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bytes=nbytes, gbps=nbytes / ms / 1e6,
                       share_of_bound=1e3 * max(t_bytes, t_ops) / ms,
                       dims=list(A.shape), path=path)
            if shape == "full":
                f32_ms = f32[name[:-len("_bf16")]]["ms"]
                out[name] = dict(row, plain_ms=time_ms(plain), f32_ms=f32_ms,
                                 bf16_over_f32=ms / f32_ms, shape=[d, n] + (
                                     [k] if "multi" in name else []),
                                 shapes={})
            else:
                out[name]["shapes"][shape] = row
            print(f"{name} {shape} {row['dims']}: {ms * 1e3:.1f} us/call, "
                  f"{row['gbps']:.0f} GB/s, bound {row['bound_ms'] * 1e3:.1f}"
                  f" us ({100 * row['share_of_bound']:.1f}%), library "
                  f"{row['library_ms']}, path {path}", flush=True)
    # K8 and K9 at 8 and 13 columns at the full width (13: two launches),
    # beside their bound (X once, the f32 blocks once) and the bf16 cuBLAS
    # call of the same product
    for k in (8, 13):
        U, Zk = U13[:, :k], Z13[:, :k].contiguous()
        for name, kernel, plain, library, vec in (
                ("xt_multi_bf16", lambda: ops.xt_multi(Xh, U),
                 lambda: ref.ref_xt_multi(Xh, U),
                 lambda: Xh.t() @ U.to(bf), (d + n) * k),
                ("x_cz_multi_bf16", lambda: ops.x_cz_multi(Xh, c, Zk),
                 lambda: ref.ref_x_cz_multi(Xh, c, Zk),
                 lambda: Xh @ (c[:, None] * Zk).to(bf), n * k + n + d * k)):
            got, again, want = kernel(), kernel(), plain()
            lib = library()
            torch.cuda.synchronize()
            e = record_err(errs, name, got, want)
            same = bool(torch.equal(got, again))
            lib_rel = rel_err(lib.float(), got)
            check(e <= REL_TOL_KERNEL and same,
                  f"{name} full width s={k} ({groups(k)} launches): rel err "
                  f"{e:.2e}, repeatable {same}; the library call (bf16 "
                  f"output) {lib_rel:.2e} from it")
            del got, again, want, lib
            t_bytes = (2 * d * n + 4 * vec) / HBM_BYTES_PER_S
            t_ops = 2 * d * n * k / F32_FLOPS_PER_S
            out[name][f"ms_s{k}"] = time_ms(kernel)
            out[name][f"bound_ms_s{k}"] = 1e3 * max(t_bytes, t_ops)
            out[name][f"library_ms_s{k}"] = (time_ms(library)
                                             if lib_rel <= 1e-2 else None)
    for name in DENSE_BF16:
        m = out[name]
        print(f"{name} full width {m['shape']}: {m['ms'] * 1e3:.1f} us/call, "
              f"{m['gbps']:.0f} GB/s over {m['bytes'] / 1e9:.3f} GB, bound "
              f"{m['bound_ms'] * 1e3:.1f} us ({m['bound_by']}, "
              f"{100 * m['share_of_bound']:.1f}%), plain "
              f"{m['plain_ms'] * 1e3:.1f} us, library {m['library_ms']}, "
              f"f32 {m['f32_ms'] * 1e3:.1f} us ({m['bf16_over_f32']:.3f}x)",
              flush=True)
    print("dense bf16 detail " + json.dumps(
        {k: {key: v for key, v in m.items() if key.startswith(
            ("ms_s", "bound_ms_s", "library_ms_s", "shapes"))}
         for k, m in out.items()}), flush=True)
    grid = measure_multi_grid(torch, X, Xh, glm_hvp, ops, ref, errs)
    for name, rows in grid.items():
        target = out[name] if name in out else f32[name]
        target["grid"] = rows
    out.update(measure_fused_bf16(torch, Xh, glm_hvp, ref, errs, f32))
    del Xh
    return out


MULTI_GRID_FULL = (1, 2, 4, 5, 8, 13)
MULTI_GRID_SHARDS = (5, 8)


def measure_multi_grid(torch, X, Xh, glm_hvp, ops, ref, errs) -> dict:
    """K8 and K9 at both tile types, at the full width at s in
    MULTI_GRID_FULL (13: two launches through the ops, as softmax's column
    groups go) and at the m = 4 shard shapes (the DiSCO-S column view, the
    DiSCO-F row block) at s in MULTI_GRID_SHARDS: each held to its plain
    version (<= 1e-5) and repeated bit for bit, then timed beside its
    bound, one cuBLAS call of the same type (``X.t() @ U``,
    ``X @ (c Z)``, the block formed beforehand, so the matmul alone; at
    bf16 on the bf16 X with the block rounded to bf16 beforehand, where
    ``measure_dense_bf16`` times the call with the rounding in it) and
    the plain version. U is the
    strided block DiSCO-F passes, Z contiguous, as pass A leaves it.
    Bound: X once and the f32 blocks once over the HBM rate, or the
    multiply-adds over the f32 peak (the bf16 tensor-core peak at bf16) if
    larger. One line per case; {kernel name: {case: row}}."""
    d, n = X.shape
    dev = X.device
    g = torch.Generator(device=dev).manual_seed(17)
    c = 0.25 * torch.rand(n, generator=g, device=dev)
    U13 = torch.randn((d, 14), generator=g, device=dev)[:, :13]
    Z13 = torch.randn((n, 13), generator=g, device=dev)
    shapes = {"full": (slice(None), slice(None), MULTI_GRID_FULL),
              "S_m4_view": (slice(None), slice(0, n // 4), MULTI_GRID_SHARDS),
              "F_m4_rows": (slice(0, d // 4), slice(None), MULTI_GRID_SHARDS)}
    out = {}
    for A0, tag in ((X, ""), (Xh, "_bf16")):
        bf = A0.dtype == torch.bfloat16
        peak = BF16_FLOPS_PER_S if bf else F32_FLOPS_PER_S
        for shape, (rows, cols, ss) in shapes.items():
            A = A0[rows, cols]
            ca = c[cols]
            dd, nn = A.shape
            for k in ss:
                U, Z = U13[rows, :k], Z13[cols, :k].contiguous()
                Ub = U.to(torch.bfloat16) if bf else U
                czb = ((ca[:, None] * Z).to(torch.bfloat16) if bf
                       else ca[:, None] * Z)
                for name, kernel, plain, library, vec in (
                        ("xt_multi", lambda: ops.xt_multi(A, U),
                         lambda: ref.ref_xt_multi(A, U),
                         lambda: A.t() @ Ub, (dd + nn) * k),
                        ("x_cz_multi", lambda: ops.x_cz_multi(A, ca, Z),
                         lambda: ref.ref_x_cz_multi(A, ca, Z),
                         lambda: A @ czb, nn * k + nn + dd * k)):
                    got, again, want = kernel(), kernel(), plain()
                    lib = library()
                    torch.cuda.synchronize()
                    e = record_err(errs, name + tag, got, want)
                    same = bool(torch.equal(got, again))
                    lib_rel = rel_err(lib.float(), got)
                    check(e <= REL_TOL_KERNEL and same,
                          f"{name}{tag} {shape} {list(A.shape)} s={k}: rel "
                          f"err {e:.2e}, repeatable {same}; the cuBLAS call "
                          f"{lib_rel:.2e} from it")
                    del got, again, want, lib
                    t_bytes = (A.numel() * A.element_size() + 4 * vec) \
                        / HBM_BYTES_PER_S
                    t_ops = 2 * A.numel() * k / peak
                    ms = time_ms(kernel)
                    row = dict(
                        us=ms * 1e3, bound_us=1e6 * max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops
                        else "operations",
                        library_us=(time_ms(library) * 1e3
                                    if lib_rel <= (1e-2 if bf else 1e-5)
                                    else None),
                        plain_us=time_ms(plain, reps=5) * 1e3,
                        max_rel_err=e, dims=[dd, nn, k])
                    row["share_of_bound"] = row["bound_us"] / row["us"]
                    out.setdefault(name + tag, {})[f"{shape}_s{k}"] = row
                    print(f"multi grid {name}{tag} {shape} {[dd, nn]} s={k}:"
                          f" {row['us']:.1f} us, bound {row['bound_us']:.1f} "
                          f"us ({100 * row['share_of_bound']:.1f}%), cuBLAS "
                          f"{row['library_us'] and round(row['library_us'], 1)}"
                          f" us, plain {row['plain_us']:.1f} us, path "
                          f"{glm_hvp.last_path[name + tag]}", flush=True)
    return out


def measure_fused_bf16(torch, Xh, glm_hvp, ref, errs, f32) -> dict:
    """The bf16 K5 and K10 on the bf16 copy ``Xh`` of the dense slice's X
    (2 GiB): K5 at the full width and the m = 4 shard shapes (the DiSCO-S
    column view, the DiSCO-F row block), K10 at the full width at s =
    TIMED_S and 8 and at the two shard shapes at s = TIMED_S (contiguous
    U, as a DiSCO-S round passes its basis): each call held in its two
    halves (:func:`check_dense_fused_bf16`), repeated bit for bit, on the
    TMA path, then timed beside its bound (X's 2-byte elements and the f32
    vectors once over the HBM rate; the f32 FMAs over the f32 peak), the
    bf16 two-pass kernel pair (K3 + K4, K8 + K9), the pair of PyTorch
    calls on the bf16 X (``torch.mv`` / ``@``, no single PyTorch call
    computes the fused product, so ``library_ms`` is null), the plain
    version and the f32 kernel's time of the same call (``f32``)."""
    d, n = Xh.shape
    bf = torch.bfloat16
    s = TIMED_S
    g = torch.Generator(device=Xh.device).manual_seed(6)
    u = torch.randn(d, generator=g, device=Xh.device)
    c = 0.25 * torch.rand(n, generator=g, device=Xh.device)
    U8 = torch.randn((d, 8), generator=g, device=Xh.device)
    cases = [("x_c_xt_u_bf16", "full", Xh, c, u),
             ("x_c_xt_u_bf16", "S_m4_view", Xh[:, :n // 4], c[:n // 4], u),
             ("x_c_xt_u_bf16", "F_m4_rows", Xh[:d // 4], c, u[:d // 4]),
             ("x_c_xt_multi_bf16", "full", Xh, c, U8[:, :s].contiguous()),
             ("x_c_xt_multi_bf16", "full_s8", Xh, c, U8),
             ("x_c_xt_multi_bf16", "S_m4_view", Xh[:, :n // 4], c[:n // 4],
              U8[:, :s].contiguous()),
             ("x_c_xt_multi_bf16", "F_m4_rows", Xh[:d // 4], c,
              U8[:d // 4, :s].contiguous())]
    f32_of = {"x_c_xt_u_bf16": {
        "full": f32["x_c_xt_u"]["ms"],
        **{k: f32["x_c_xt_u"]["shapes"][k]["us"] / 1e3
           for k in ("S_m4_view", "F_m4_rows")}},
        "x_c_xt_multi_bf16": {
        "full": f32["x_c_xt_multi"]["ms"],
        "full_s8": f32["x_c_xt_multi"]["ms_by_s"][8],
        "S_m4_view": f32["x_c_xt_multi"]["shapes"]["S_m4_view"]["us"] / 1e3}}
    out = {}
    for name, shape, A, ca, Ua in cases:
        multi = Ua.dim() == 2
        k = Ua.shape[1] if multi else 1
        if multi:
            kernel = lambda cz=None: glm_hvp.x_c_xt_multi(A, ca, Ua,
                                                          cz_out=cz)
            plain = lambda: ref.ref_x_c_xt_multi(A, ca, Ua)
            pair = lambda: glm_hvp.x_cz_multi(A, ca, glm_hvp.xt_multi(A, Ua))
            library = lambda: A @ (ca[:, None] * (A.t() @ Ua.to(bf))).to(bf)
        else:
            kernel = lambda cz=None: glm_hvp.x_c_xt_u(A, ca, Ua, cz_out=cz)
            plain = lambda: ref.ref_x_c_xt_u(A, ca, Ua)
            pair = lambda: glm_hvp.x_cz(A, ca, glm_hvp.xt_u(A, Ua))
            library = lambda: torch.mv(A, (ca * torch.mv(
                A.t(), Ua.to(bf)).float()).to(bf))
        cz = torch.zeros((A.shape[1],) + ((k,) if multi else ()),
                         device=Xh.device)
        got, again = kernel(cz), kernel()
        run = glm_hvp.last_fused[name]
        torch.cuda.synchronize()
        r = check_dense_fused_bf16(torch, glm_hvp, ref, A, ca, Ua, got, cz)
        record_fused_bf16(errs, name, r)
        same = bool(torch.equal(got, again))
        lib = library()
        torch.cuda.synchronize()
        lib_rel = rel_err(lib.float(), got)
        rate = ref.handoff_rate_ok(r["flips"], r["numel"])
        check(max(r["rel"], r["pair_rel"]) <= REL_TOL_KERNEL and r["ties"]
              and rate and same and run.path == "bulk",
              f"{name} {shape} {tuple(A.shape)} s={k}: rel err of y against "
              f"the plain and the pair's pass B on the kernel's hand-off "
              f"{r['rel']:.2e} / {r['pair_rel']:.2e}, hand-off elements off "
              f"the plain / pair rounding {r['flips']} / {r['pair_flips']} "
              f"of {cz.numel()} (all within the slack {r['ties']}), "
              f"end-to-end rel err {r['end_to_end']:.2e}, repeatable "
              f"{same}, {fused_tag(run)}; the library pair (bf16 output) "
              f"{lib_rel:.2e} from it")
        del got, again, lib, cz
        rows, cols = A.shape
        nbytes = 2 * A.numel() + 4 * (2 * rows * k + cols)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = (4 * A.numel() * k + cols * k) / F32_FLOPS_PER_S
        ms = time_ms(kernel)
        f32_ms = f32_of[name].get(shape)
        row = dict(ms=ms, library_ms=None,
                   library_pair_ms=(time_ms(library) if lib_rel <= 1e-2
                                    else None),
                   kernel_pair_ms=time_ms(pair),
                   bound_ms=1e3 * max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=nbytes, gbps=nbytes / ms / 1e6,
                   share_of_bound=1e3 * max(t_bytes, t_ops) / ms,
                   dims=list(A.shape), s=k, path=run.path,
                   plan=dict(run.plan._asdict(), clusters=run.clusters),
                   f32_ms=f32_ms,
                   bf16_over_f32=None if f32_ms is None else ms / f32_ms)
        if shape == "full":
            out[name] = dict(row, plain_ms=time_ms(plain), shape=[d, n] + (
                [k] if multi else []), shapes={})
        else:
            out[name]["shapes"][shape] = row
        print(f"{name} {shape} {row['dims']} s={k}: {ms * 1e3:.1f} us/call, "
              f"{row['gbps']:.0f} GB/s, bound {row['bound_ms'] * 1e3:.1f} us"
              f" ({100 * row['share_of_bound']:.1f}%), bf16 kernel pair "
              f"{row['kernel_pair_ms'] * 1e3:.1f} us, library pair "
              f"{row['library_pair_ms']} ms, f32 kernel "
              + ("not measured" if f32_ms is None
                 else f"{f32_ms * 1e3:.1f} us")
              + f", {fused_tag(run)}", flush=True)
    for name in DENSE_FUSED_BF16:
        m = out[name]
        print(f"{name} full width {m['shape']}: {m['ms'] * 1e3:.1f} us/call,"
              f" {m['gbps']:.0f} GB/s over {m['bytes'] / 1e9:.3f} GB, bound "
              f"{m['bound_ms'] * 1e3:.1f} us ({m['bound_by']}, "
              f"{100 * m['share_of_bound']:.1f}%), plain "
              f"{m['plain_ms'] * 1e3:.1f} us, bf16 kernel pair "
              f"{m['kernel_pair_ms'] * 1e3:.1f} us, library pair "
              f"{m['library_pair_ms']}, f32 {m['f32_ms'] * 1e3:.1f} us "
              f"({m['bf16_over_f32']:.3f}x)", flush=True)
    print("dense fused bf16 detail " + json.dumps(
        {k: m["shapes"] for k, m in out.items()}), flush=True)
    return out


def check_f_decreases(tag, hist) -> None:
    """Every Newton step lowers f. A damped Newton step from w_k lowers f
    by about omega(delta_k) = delta_k - log(1 + delta_k); where that is
    below 1e-6 |f_k|, under the f32 rounding of the n-term sum that gives
    f, the step must only not raise f beyond that rounding."""
    import math
    ok, strict = True, 0
    for a, b in zip(hist, hist[1:]):
        fa, fb, delta = a["f"], b["f"], a["delta"]
        resolution = 1e-6 * abs(fa)
        if delta - math.log1p(delta) > resolution:
            ok &= fb < fa
            strict += 1
        else:
            ok &= fb <= fa + resolution
    check(ok, f"{tag}: f decreases at every Newton step ({strict} of "
              f"{len(hist) - 1} steps above f32 resolution and held to a "
              f"strict decrease, the rest to no rise beyond rounding)")


def phase_dense(torch, rt, build, glm_hvp, ref, errs):
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    X, y, model = make_dense_data(torch, dev, **DENSE)
    torch.cuda.synchronize()
    print(f"dense data on the card: d={X.shape[0]} n={X.shape[1]} "
          f"({X.numel() * 4 / 2**30:.2f} GiB, "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    timings = measure_dense_kernels(torch, X, glm_hvp, ref, errs)
    timings.update(measure_dense_bf16(torch, X, glm_hvp, ref, errs, timings))
    launches = dict.fromkeys(DENSE_KERNELS + DENSE_BF16 + DENSE_FUSED_BF16,
                             0)
    results, iters = {}, {}
    for partition, m, fused in RUNS:
        tag = "dense " + run_tag(partition, m, fused)
        cfg = rt.DiscoConfig(partition=partition, hvp_fused=fused,
                             **DENSE_SOLVE)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        solver = rt.DiscoSolver(X, y, cfg, group=rt.InProcessGroup(m),
                                device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        check(solver.X.data_ptr() == X.data_ptr(),
              f"{tag}: the solver shards X in place (no copy)")
        res, counts = fit_counted(torch, build, solver)
        for k in DENSE_KERNELS:
            launches[k] += counts[k]
        hist = res.history
        run_row(torch, tag, res, counts, setup_s,
                f=[h["f"] for h in hist])
        check(bool(torch.from_numpy(res.w).isfinite().all())
              and res.w.shape == (X.shape[0],), f"{tag}: finite w of shape (d,)")
        check_f_decreases(tag, hist)
        if fused and (partition == "samples" or m == 1):
            check(counts["x_c_xt_u"] > 0 and counts["xt_u"] == 0,
                  f"{tag}: x_c_xt_u launched for every HVP")
        else:
            check(counts["xt_u"] > 0 and counts["x_cz"] > 0,
                  f"{tag}: xt_u and x_cz launched")
        results[(partition, m, fused)] = res.w
        iters[(partition, m, fused)] = [int(h["pcg_iters"]) for h in hist]
        if (partition, m, fused) == RUNS[0]:
            t_tc = time.perf_counter()
            trace_and_checkpoint(torch, build, solver, res, counts, tag)
            print(f"trace and checkpoint, dense: "
                  f"{time.perf_counter() - t_tc:.1f} s", flush=True)
            try:
                profile_fit(torch, solver)
            except RuntimeError as exc:   # a measurement only, not a check
                print(f"profile unavailable: {exc}", flush=True)
        del solver, res
        gc.collect()
        torch.cuda.empty_cache()

    for p in ("samples", "features"):
        base = results[(p, 1, False)]
        for other, what in (((p, 4, False), "m=4 vs m=1"),
                            ((p, 1, True), "fused vs two-pass")):
            e = rel_w(results[other], base)
            check(e <= REL_TOL_W, f"dense {p} {what}: rel diff of w {e:.2e}")
    sstep = sstep_phase(torch, rt, build, X, y, DENSE_SOLVE,
                        DENSE_SSTEP_RUNS,
                        {p: (results[(p, 1, False)], iters[(p, 1, False)])
                         for p in ("samples", "features")}, False, launches)
    f32_path = lambda_path_phase(torch, rt, build, X, y, model,
                                 results[("samples", 1, False)], launches)
    softmax_phase(torch, rt, build, X, launches)
    glm_losses_phase(torch, rt, build, X, model, launches)
    bf16_pair = dense_bf16_phase(torch, rt, build, X, y, model,
                                 {p: results[(p, 1, False)]
                                  for p in ("samples", "features")},
                                 launches)
    f32_fused = {(p, 1, 1): (results[(p, 1, True)], iters[(p, 1, True)])
                 for p in ("samples", "features")}
    f32_fused[("samples", 1, SSTEP_S)] = sstep[("samples", 1, True)]
    f32_fused["path"] = f32_path
    dense_fused_bf16_phase(torch, rt, build, X, y, model, f32_fused,
                           bf16_pair, launches)
    baselines_dense_phase(torch, rt, X, y)
    del X, y, model
    gc.collect()
    torch.cuda.empty_cache()
    return timings, launches


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

def as_bf16(n: dict) -> dict:
    """A prediction of the dense kernels' launches (keyed by the f32
    kernels) moved to the bf16 instances: on bf16 tiles the f32 kernels
    launch none."""
    out = dict.fromkeys(DENSE_KERNELS, 0)
    out.update({f"{k}_bf16": n.get(k, 0) for k in DENSE_KERNELS})
    return out


def dense_bf16_launches(partition, m, s, use_kernel, steps, units,
                        fused=False) -> dict:
    """The dense kernel launches of a bf16 fit: the margins and the
    gradient are cuBLAS on the f32 X, so no f32 kernel launches; PCG's
    products go to the bf16 instances as an f32 fit makes them: classic,
    one HVP an iteration on each shard (the one-pass K5 when ``fused``
    and no collective separates the passes: DiSCO-S, one-shard DiSCO-F;
    else the two-pass pair); s-step as :func:`predicted_launches` counts
    them; the plain layout (``use_kernel=False``) launches none."""
    if not use_kernel:
        return as_bf16({})
    if s > 1:
        return as_bf16(predicted_launches(False, partition, m, fused, s,
                                          steps, units))
    if fused and (partition == "samples" or m == 1):
        return as_bf16({"x_c_xt_u": m * units})
    return as_bf16({"xt_u": m * units, "x_cz": m * units})


def dense_bf16_phase(torch, rt, build, X, y, model, f32_w, launches):
    """The bf16 runs on the dense slice's X (``hvp_dtype='bfloat16'``):
    BF16_DENSE_RUNS, each with X shared and PCG's shards views of one
    bf16 copy, held to the launches the code predicts (the bf16 instances
    for PCG, no f32 dense kernel at all), f falling every Newton step and
    the f32 m = 1 two-pass w of its partition (``f32_w``) at REL_TOL_W;
    then a warm two-pass λ-path (classic DiSCO-S m = 1 at LAMBDAS, scored
    on N_VAL held-out samples), the same checks, its λ = 1e-4 endpoint at
    the f32 w. Each prints iter_s, PCG iterations, gradient norms and peak
    memory. Returns the kernels' runs' ``w`` and PCG iterations (rounds)
    per step by (partition, m, pcg_block_s), and the λ-path's endpoint
    ``w`` under "path"."""
    from repro_torch.core import comm
    bf = torch.bfloat16
    out = {}
    for partition, m, s, use_kernel in BF16_DENSE_RUNS:
        kind = f"s-step s={s} " if s > 1 else ""
        layout = "" if use_kernel else " plain layout"
        tag = f"dense bf16 {kind}{run_tag(partition, m, False)}{layout}"
        cfg = rt.DiscoConfig(partition=partition, pcg_block_s=s,
                             hvp_dtype="bfloat16",
                             **dict(DENSE_SOLVE, use_kernel=use_kernel))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        solver = rt.DiscoSolver(X, y, cfg, group=rt.InProcessGroup(m),
                                device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        base = solver.X_h.untyped_storage().data_ptr()
        check(solver.X.data_ptr() == X.data_ptr()
              and solver.X_h.dtype == bf
              and all(h.dtype == bf and h.untyped_storage().data_ptr() == base
                      for h in solver._hvp_locs),
              f"{tag}: X shared, PCG's shards views of one bf16 copy")
        res, counts = fit_counted(torch, build, solver)
        for k in launches:
            launches[k] += counts[k]
        hist = res.history
        units = sum(int(h["pcg_iters"]) for h in hist)
        # X bytes of one HVP, the byte model's (core/comm.py)
        row = run_row(torch, tag, res, counts, setup_s,
                      f=[h["f"] for h in hist],
                      hvp_bytes=comm.dense_hvp_bytes(
                          *X.shape, dtype_bytes=BYTES_BF16))
        check(bool(torch.from_numpy(res.w).isfinite().all())
              and res.w.shape == (X.shape[0],),
              f"{tag}: finite w of shape (d,)")
        want = dense_bf16_launches(partition, m, s, use_kernel, len(hist),
                                   units)
        got = {k: counts[k] for k in want}
        check(got == want and units > 0,
              f"{tag}: launches as predicted {json.dumps(want)}"
              + ("" if got == want else f", got {json.dumps(got)}"))
        check_f_decreases(tag, hist)
        e = rel_w(res.w, f32_w[partition])
        check(e <= REL_TOL_W, f"{tag} vs f32 m=1 two-pass: rel diff of w "
                              f"{e:.2e} (<= {REL_TOL_W:g})")
        print(f"{tag}: PCG {'rounds' if s > 1 else 'iterations'} per step "
              f"{row['pcg_iters']}, median iter_s "
              f"{row['iter_s_median']:.4f}, peak "
              f"{row['max_memory_allocated'] / 2**30:.2f} GiB", flush=True)
        if use_kernel:
            out[(partition, m, s)] = (res.w, row["pcg_iters"])
        del solver, res
        gc.collect()
        torch.cuda.empty_cache()

    X_val, y_val = held_out(torch, model, N_VAL, seed=1)
    cfg = rt.DiscoConfig(partition="samples", hvp_dtype="bfloat16",
                         **dict(DENSE_SOLVE, grad_tol=1e-8))
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    path = rt.lambda_path_fit(X, y, LAMBDAS, cfg, device="cuda",
                              X_val=X_val, y_val=y_val)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    for k in launches:
        launches[k] += counts[k]
    want = as_bf16({})
    points = []
    for lam, res, passes, vloss in zip(path.lambdas, path.results,
                                       path.x_passes, path.val_losses):
        hist = res.history
        iters = [int(h["pcg_iters"]) for h in hist]
        for k, v in dense_bf16_launches("samples", 1, 1, True, len(hist),
                                        sum(iters)).items():
            want[k] += v
        check_f_decreases(f"bf16 lambda path point {lam:g}", hist)
        points.append(dict(
            lam=lam, newton_iters=len(hist), pcg_iters=iters,
            iter_s_median=statistics.median(h["iter_s"] for h in hist),
            x_passes=passes, val_loss=vloss,
            grad_norm_first=hist[0]["grad_norm"],
            grad_norm_last=hist[-1]["grad_norm"]))
    print("lambda path bf16 " + json.dumps(dict(
        points=points, best_lambda=path.best_lambda, wall_s=wall,
        total_x_passes=path.total_x_passes, n_val=N_VAL,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches={k: counts[k] for k in want})), flush=True)
    got = {k: counts[k] for k in want}
    check(got == want and counts["xt_u_bf16"] > 0,
          f"bf16 lambda path: launches as predicted {json.dumps(want)}"
          + ("" if got == want else f", got {json.dumps(got)}"))
    e = rel_w(path.results[-1].w, f32_w["samples"])
    check(path.lambdas[-1] == DENSE_SOLVE["lam"] and e <= REL_TOL_W,
          f"bf16 lambda path: the lambda={path.lambdas[-1]:g} endpoint vs "
          f"the f32 classic m=1 w: rel diff {e:.2e}")
    out["path"] = path.results[-1].w
    del X_val, y_val, path
    return out



def dense_fused_bf16_phase(torch, rt, build, X, y, model, f32_fused,
                           bf16_pair, launches) -> None:
    """The fused bf16 runs on the dense slice's X (``hvp_fused=True,
    hvp_dtype='bfloat16'``): BF16_FUSED_RUNS, each with X shared and
    PCG's shards views of one bf16 copy, held to the launches the code
    predicts (:func:`dense_bf16_launches`), f falling every Newton step,
    ``w`` within REL_TOL_W of the f32 fused run's (``f32_fused``; the f32
    DiSCO-S m = 4 fused run is made here first, as the f32 runs have
    none) and of the bf16 two-pass run's of its cell (``bf16_pair``), and
    its PCG iterations (rounds) in all within FUSED_BF16_ITERS of the f32
    fused run's. Then a warm fused s-step λ-path (DiSCO-S m = 1: K5 for
    the basis products, K10 for the rounds) at LAMBDAS, scored on N_VAL
    held-out samples: ``with_lam`` allocates nothing and shares X and its
    bf16 copy, the launches predicted, f falling at every point, the
    λ = 1e-4 endpoint within REL_TOL_W of the f32 fused λ-path's and the
    bf16 two-pass λ-path's; its rounds printed beside the f32 path's."""
    from repro_torch.core import comm
    bf = torch.bfloat16
    cfg = rt.DiscoConfig(partition="samples", hvp_fused=True, **DENSE_SOLVE)
    solver = rt.DiscoSolver(X, y, cfg, group=rt.InProcessGroup(4),
                            device="cuda")
    res, counts = fit_counted(torch, build, solver)
    for k in launches:
        launches[k] += counts[k]
    tag = "dense " + run_tag("samples", 4, True)
    row = run_row(torch, tag, res, counts, 0.0,
                  f=[h["f"] for h in res.history])
    check_f_decreases(tag, res.history)
    check(counts["x_c_xt_u"] > 0 and counts["xt_u"] == 0,
          f"{tag}: x_c_xt_u launched for every HVP")
    f32_fused[("samples", 4, 1)] = (res.w, row["pcg_iters"])
    del solver, res
    gc.collect()
    torch.cuda.empty_cache()
    for partition, m, s in BF16_FUSED_RUNS:
        kind = f"s-step s={s} " if s > 1 else ""
        tag = f"dense bf16 {kind}{run_tag(partition, m, True)}"
        cfg = rt.DiscoConfig(partition=partition, pcg_block_s=s,
                             hvp_fused=True, hvp_dtype="bfloat16",
                             **DENSE_SOLVE)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        solver = rt.DiscoSolver(X, y, cfg, group=rt.InProcessGroup(m),
                                device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        base = solver.X_h.untyped_storage().data_ptr()
        check(solver.X.data_ptr() == X.data_ptr()
              and solver.X_h.dtype == bf
              and all(h.dtype == bf and h.untyped_storage().data_ptr() == base
                      for h in solver._hvp_locs),
              f"{tag}: X shared, PCG's shards views of one bf16 copy")
        res, counts = fit_counted(torch, build, solver)
        for k in launches:
            launches[k] += counts[k]
        hist = res.history
        units = sum(int(h["pcg_iters"]) for h in hist)
        row = run_row(torch, tag, res, counts, setup_s,
                      f=[h["f"] for h in hist],
                      hvp_bytes=comm.dense_hvp_bytes(
                          *X.shape, fused=True, dtype_bytes=BYTES_BF16))
        check(bool(torch.from_numpy(res.w).isfinite().all())
              and res.w.shape == (X.shape[0],),
              f"{tag}: finite w of shape (d,)")
        want = dense_bf16_launches(partition, m, s, True, len(hist), units,
                                   fused=True)
        got = {k: counts[k] for k in want}
        check(got == want and units > 0
              and counts["x_c_xt_u_bf16"] + counts["x_c_xt_multi_bf16"] > 0,
              f"{tag}: launches as predicted {json.dumps(want)}"
              + ("" if got == want else f", got {json.dumps(got)}"))
        check_f_decreases(tag, hist)
        f32_w, f32_iters = f32_fused[(partition, m, s)]
        pair_w, pair_iters = bf16_pair[(partition, m, s)]
        e32, epair = rel_w(res.w, f32_w), rel_w(res.w, pair_w)
        check(e32 <= REL_TOL_W and epair <= REL_TOL_W,
              f"{tag}: rel diff of w {e32:.2e} from the f32 fused run, "
              f"{epair:.2e} from the bf16 two-pass run (<= {REL_TOL_W:g})")
        base_iters = sum(f32_iters)
        check(abs(units - base_iters) <= FUSED_BF16_ITERS * base_iters,
              f"{tag}: PCG {'rounds' if s > 1 else 'iterations'} {units} "
              f"{row['pcg_iters']} within {FUSED_BF16_ITERS:.0%} of the f32 "
              f"fused run's {base_iters} {f32_iters} (bf16 two-pass "
              f"{sum(pair_iters)})")
        print(f"{tag}: median iter_s {row['iter_s_median']:.4f}, peak "
              f"{row['max_memory_allocated'] / 2**30:.2f} GiB", flush=True)
        del solver, res
        gc.collect()
        torch.cuda.empty_cache()

    X_val, y_val = held_out(torch, model, N_VAL, seed=1)
    cfg = rt.DiscoConfig(partition="samples", hvp_fused=True,
                         pcg_block_s=SSTEP_S, hvp_dtype="bfloat16",
                         **dict(DENSE_SOLVE, grad_tol=1e-8))
    solver = rt.DiscoSolver(X, y, cfg, device="cuda")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    other = solver.with_lam(LAMBDAS[1])
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    check(after == before and other.X is solver.X
          and other.X_h is solver.X_h
          and other._hvp_locs is solver._hvp_locs,
          f"fused bf16 lambda path: with_lam allocated {after - before} "
          f"bytes and shares X and its bf16 copy")
    del solver, other
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    path = rt.lambda_path_fit(X, y, LAMBDAS, cfg, device="cuda",
                              X_val=X_val, y_val=y_val)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    for k in launches:
        launches[k] += counts[k]
    pred = dict.fromkeys(DENSE_KERNELS, 0)
    points = []
    for lam, res, passes, vloss in zip(path.lambdas, path.results,
                                       path.x_passes, path.val_losses):
        hist = res.history
        rounds = [int(h["pcg_iters"]) for h in hist]
        for k, v in predicted_launches(False, "samples", 1, True, SSTEP_S,
                                       len(hist), sum(rounds)).items():
            if k in pred:
                pred[k] += v
        check_f_decreases(f"fused bf16 lambda path point {lam:g}", hist)
        points.append(dict(
            lam=lam, newton_iters=len(hist), rounds=rounds,
            iter_s_median=statistics.median(h["iter_s"] for h in hist),
            x_passes=passes, val_loss=vloss,
            grad_norm_first=hist[0]["grad_norm"],
            grad_norm_last=hist[-1]["grad_norm"]))
    want = as_bf16(pred)
    total = sum(sum(p["rounds"]) for p in points)
    print("lambda path fused bf16 " + json.dumps(dict(
        points=points, best_lambda=path.best_lambda, wall_s=wall,
        total_x_passes=path.total_x_passes, n_val=N_VAL, rounds=total,
        f32_fused_rounds=f32_fused["path"][1],
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches={k: counts[k] for k in want})), flush=True)
    got = {k: counts[k] for k in want}
    check(got == want and counts["x_c_xt_u_bf16"] > 0
          and counts["x_c_xt_multi_bf16"] > 0,
          f"fused bf16 lambda path: launches as predicted "
          f"{json.dumps(want)}"
          + ("" if got == want else f", got {json.dumps(got)}"))
    e32 = rel_w(path.results[-1].w, f32_fused["path"][0])
    epair = rel_w(path.results[-1].w, bf16_pair["path"])
    check(path.lambdas[-1] == DENSE_SOLVE["lam"] and e32 <= REL_TOL_W
          and epair <= REL_TOL_W,
          f"fused bf16 lambda path: the lambda={path.lambdas[-1]:g} "
          f"endpoint vs the f32 fused path's {e32:.2e}, vs the bf16 "
          f"two-pass path's {epair:.2e} (<= {REL_TOL_W:g}); rounds {total} "
          f"against the f32 fused path's {f32_fused['path'][1]}")
    del X_val, y_val, path


def lambda_path_phase(torch, rt, build, X, y, model, classic_w,
                      launches) -> None:
    """A warm λ-path on the dense slice: fused s-step DiSCO-S m = 1
    (every round one x_c_xt_multi) at LAMBDAS, scored on N_VAL held-out
    samples of the same model (seed 1). Checks: ``with_lam`` allocates
    nothing (X shared), the launches the code predicts (x_c_xt_multi
    among them), f decreasing at every point, and the last point
    (λ = 1e-4) at the classic m = 1 two-pass ``w``."""
    X_val, y_val = held_out(torch, model, N_VAL, seed=1)
    cfg = rt.DiscoConfig(partition="samples", hvp_fused=True,
                         pcg_block_s=SSTEP_S,
                         **dict(DENSE_SOLVE, grad_tol=1e-8))
    solver = rt.DiscoSolver(X, y, cfg, device="cuda")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    other = solver.with_lam(LAMBDAS[1])
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    check(after == before and other.X is solver.X
          and other.X.data_ptr() == X.data_ptr(),
          f"lambda path: with_lam allocated {after - before} bytes and "
          f"shares X")
    del solver, other
    build.reset_launch_counts()
    t0 = time.perf_counter()
    path = rt.lambda_path_fit(X, y, LAMBDAS, cfg, device="cuda",
                              X_val=X_val, y_val=y_val)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    for k in launches:
        launches[k] += counts[k]
    want = dict.fromkeys(DENSE_KERNELS, 0)
    points = []
    for lam, res, passes, vloss in zip(path.lambdas, path.results,
                                       path.x_passes, path.val_losses):
        hist = res.history
        rounds = [int(h["pcg_iters"]) for h in hist]
        for k, v in predicted_launches(False, "samples", 1, True, SSTEP_S,
                                       len(hist), sum(rounds)).items():
            if k in want:
                want[k] += v
        check_f_decreases(f"lambda path point {lam:g}", hist)
        points.append(dict(
            lam=lam, newton_iters=len(hist), rounds=rounds,
            iter_s_median=statistics.median(h["iter_s"] for h in hist),
            x_passes=passes, val_loss=vloss,
            grad_norm_first=hist[0]["grad_norm"],
            grad_norm_last=hist[-1]["grad_norm"]))
    print("lambda path " + json.dumps(dict(
        points=points, best_lambda=path.best_lambda, wall_s=wall,
        total_x_passes=path.total_x_passes, n_val=N_VAL,
        launches={k: counts[k] for k in DENSE_KERNELS})), flush=True)
    got = {k: counts[k] for k in want}
    check(got == want and counts["x_c_xt_multi"] > 0,
          f"lambda path: launches as predicted {json.dumps(want)}"
          + ("" if got == want else f", got {json.dumps(got)}"))
    e = rel_w(path.results[-1].w, classic_w)
    check(path.lambdas[-1] == DENSE_SOLVE["lam"] and e <= REL_TOL_W,
          f"lambda path: the lambda={path.lambdas[-1]:g} endpoint vs the "
          f"classic m=1 w: rel diff {e:.2e}")
    out = (path.results[-1].w, sum(sum(p["rounds"]) for p in points))
    del X_val, y_val, path
    return out


def softmax_launches(partition, m, s, units):
    """The dense kernel launches of a softmax fit (core/softmax.py), from
    its PCG iterations or s-step rounds: a K-class product is one
    multi-vector op each way, ``groups(K)`` launches; classic: per
    iteration one product per shard; s-step: per round s - 1 basis
    products (the whole HVP on one DiSCO-S shard, each shard's block for
    DiSCO-F, the tau-sample estimate in torch.matmul for DiSCO-S on
    several) and the batched round, K (s + 1) (DiSCO-S) or K s (DiSCO-F)
    columns per shard."""
    K = SOFTMAX_K
    if s <= 1:
        per = m * groups(K)
    else:
        basis = (s - 1) * (m * groups(K) if partition == "features"
                           else (groups(K) if m == 1 else 0))
        per = basis + m * groups(K * (s + 1) if partition == "samples"
                                 else K * s)
    n = dict.fromkeys(DENSE_KERNELS, 0)
    n["xt_multi"] = n["x_cz_multi"] = per * units
    return n


def softmax_phase(torch, rt, build, X, launches) -> None:
    """Multinomial softmax on the dense slice's X with SOFTMAX_K classes
    (labels argmax(X^T W_true + noise), W_true from seed 2): SOFTMAX_RUNS,
    each held to its predicted launches (with the 8-column split) and to
    f decreasing; DiSCO-F m = 4 against DiSCO-S m = 1, s-step against
    classic."""
    dev = X.device
    d, n = X.shape
    g = torch.Generator(device=dev).manual_seed(2)
    W_true = torch.randn((d, SOFTMAX_K), generator=g, device=dev)
    labels = torch.argmax(X.T @ W_true + torch.randn(
        (n, SOFTMAX_K), generator=g, device=dev), dim=1)
    del W_true
    out = {}
    for partition, m, s in SOFTMAX_RUNS:
        tag = (f"softmax K={SOFTMAX_K} "
               + ("DiSCO-S" if partition == "samples" else "DiSCO-F")
               + f" m={m} " + ("classic" if s == 1 else f"s-step s={s}"))
        cfg = rt.SoftmaxConfig(partition=partition, pcg_block_s=s,
                               n_classes=SOFTMAX_K, **SOFTMAX_SOLVE)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        solver = rt.SoftmaxSolver(X, labels, cfg, group=rt.InProcessGroup(m),
                                  device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        check(solver.X.data_ptr() == X.data_ptr(),
              f"{tag}: the solver shards X in place (no copy)")
        build.reset_launch_counts()
        res = solver.fit()
        torch.cuda.synchronize()
        counts = build.launch_counts()
        for k in launches:
            launches[k] += counts[k]
        hist = res.history
        units = [int(h["pcg_iters"]) for h in hist]
        print("run " + json.dumps(dict(
            run=tag, newton_iters=len(hist), pcg_iters=units,
            grad_norm_first=hist[0]["grad_norm"],
            grad_norm_last=hist[-1]["grad_norm"],
            iter_s_median=statistics.median(h["iter_s"] for h in hist),
            setup_s=setup_s,
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            launches=counts, f=[h["f"] for h in hist])), flush=True)
        check(bool(torch.from_numpy(res.W).isfinite().all())
              and res.W.shape == (d, SOFTMAX_K),
              f"{tag}: finite W of shape (d, K)")
        want = softmax_launches(partition, m, s, sum(units))
        got = {k: counts[k] for k in want}
        check(got == want and sum(units) > 0,
              f"{tag}: launches as predicted {json.dumps(want)}"
              + ("" if got == want else f", got {json.dumps(got)}"))
        check_f_decreases(tag, hist)
        out[(partition, m, s)] = res.W
        del solver, res
        gc.collect()
        torch.cuda.empty_cache()
    for s in (1, 2):
        e = rel_w(out[("features", 4, s)], out[("samples", 1, s)])
        check(e <= REL_TOL_W, f"softmax s={s} DiSCO-F m=4 vs DiSCO-S m=1: "
                              f"rel diff of W {e:.2e}")
    for p, m in (("samples", 1), ("features", 4)):
        e = rel_w(out[(p, m, 2)], out[(p, m, 1)])
        check(e <= REL_TOL_W, f"softmax {p} m={m} s-step vs classic: rel "
                              f"diff of W {e:.2e}")
    softmax_hvp_check(torch, X, torch.from_numpy(out[("samples", 1, 1)])
                      .to(dev))
    softmax_bf16_run(torch, rt, build, X, labels, out[("samples", 1, 1)],
                     launches)
    del labels


def softmax_hvp_check(torch, X, W) -> None:
    """``ops.softmax_hvp`` on the card (K8, the class coupling, K9: the
    solver's operator, 8 + 2 columns) at the fitted ``W``'s probabilities
    on a random direction, unweighted and with a 0/1 mask of a fifth of
    the samples, against the plain ``ref.ref_softmax_hvp`` on the same
    inputs (relative L2 ``REL_TOL_KERNEL``). A check only: run between
    the launch windows."""
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=X.device).manual_seed(4)
    P = ref.ref_softmax_probs(X.T @ W)
    U = torch.randn(W.shape, generator=g, device=X.device)
    mask = (torch.rand(X.shape[1], generator=g, device=X.device) > 0.2
            ).float()
    for tag, wts in (("unweighted", None), ("masked", mask)):
        got = ops.softmax_hvp(X, P, U, lam=1e-3, weights=wts)
        e = rel_err(got, ref.ref_softmax_hvp(X, P, U, 1e-3, weights=wts))
        check(e <= REL_TOL_KERNEL, f"softmax_hvp K={W.shape[1]} {tag} on "
                                   f"the card against its plain version: "
                                   f"rel err {e:.2e}")


def softmax_bf16_run(torch, rt, build, X, labels, f32_W, launches) -> None:
    """Softmax with SOFTMAX_K classes on bf16 tiles (DiSCO-S m = 1
    classic): the K-class products on the bf16 K8 / K9 instances only
    (the predicted launches, no f32 dense kernel), f decreasing, and W at
    the f32 run's (``f32_W``) within REL_TOL_W."""
    tag = f"softmax K={SOFTMAX_K} DiSCO-S m=1 classic bf16"
    cfg = rt.SoftmaxConfig(partition="samples", pcg_block_s=1,
                           n_classes=SOFTMAX_K, hvp_dtype="bfloat16",
                           **SOFTMAX_SOLVE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver = rt.SoftmaxSolver(X, labels, cfg, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(solver.X.data_ptr() == X.data_ptr()
          and solver._hvp_locs[0].dtype == torch.bfloat16,
          f"{tag}: X shared, PCG's shard a view of the bf16 copy")
    build.reset_launch_counts()
    res = solver.fit()
    torch.cuda.synchronize()
    counts = build.launch_counts()
    for k in launches:
        launches[k] += counts[k]
    hist = res.history
    units = [int(h["pcg_iters"]) for h in hist]
    print("run " + json.dumps(dict(
        run=tag, newton_iters=len(hist), pcg_iters=units,
        grad_norm_first=hist[0]["grad_norm"],
        grad_norm_last=hist[-1]["grad_norm"],
        iter_s_median=statistics.median(h["iter_s"] for h in hist),
        setup_s=setup_s,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=counts, f=[h["f"] for h in hist])), flush=True)
    check(bool(torch.from_numpy(res.W).isfinite().all())
          and res.W.shape == (X.shape[0], SOFTMAX_K),
          f"{tag}: finite W of shape (d, K)")
    want = as_bf16(softmax_launches("samples", 1, 1, sum(units)))
    got = {k: counts[k] for k in want}
    check(got == want and sum(units) > 0,
          f"{tag}: launches as predicted {json.dumps(want)}"
          + ("" if got == want else f", got {json.dumps(got)}"))
    check_f_decreases(tag, hist)
    e = rel_w(res.W, f32_W)
    check(e <= REL_TOL_W, f"{tag} vs f32: rel diff of W {e:.2e} (<= "
                          f"{REL_TOL_W:g})")
    del solver, res
    gc.collect()
    torch.cuda.empty_cache()


def glm_losses_phase(torch, rt, build, X, model, launches) -> None:
    """Poisson and Huber regression on the dense slice's X (the
    ``make_glm_data`` regression recipe on its model: y = margins + 0.1
    noise; Poisson counts drawn from exp(margins)), fused DiSCO-S m = 1:
    every HVP one x_c_xt_u, and the gradient norm down 1e3-fold."""
    n = X.shape[1]
    g = torch.Generator(device=X.device).manual_seed(3)
    margins = X.T @ model["w_true"]
    targets = {"poisson": torch.poisson(torch.exp(margins), generator=g),
               "huber": margins + 0.1 * torch.randn(n, generator=g,
                                                    device=X.device)}
    for loss, yv in targets.items():
        tag = f"dense {loss} DiSCO-S m=1 fused"
        cfg = rt.DiscoConfig(partition="samples", hvp_fused=True,
                             **dict(DENSE_SOLVE, loss=loss))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        solver = rt.DiscoSolver(X, yv, cfg, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        res, counts = fit_counted(torch, build, solver)
        for k in launches:
            launches[k] += counts[k]
        row = run_row(torch, tag, res, counts, setup_s,
                      f=[h["f"] for h in res.history])
        g0, g1 = row["grad_norm_first"], row["grad_norm_last"]
        check(bool(torch.from_numpy(res.w).isfinite().all())
              and g1 <= 1e-3 * g0,
              f"{tag}: finite w, grad_norm {g0:.3e} -> {g1:.3e}")
        check(counts["x_c_xt_u"] > 0 and counts["xt_u"] == 0,
              f"{tag}: x_c_xt_u launched for every HVP")
        del solver, res
    del targets, margins


def count_host_syncs(torch, fn) -> int:
    """Host-device synchronizations of one call of ``fn`` (such as one
    more ``fit()``), counted with PyTorch's sync debug mode (it warns at
    each one)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def device_profile(torch, fn, host_ops=True):
    """``fn()`` under ``torch.profiler``: its wall time and the device-side
    events as (device µs, calls, name), largest first. Device busy time is
    their sum (kernels, copies, fills: one stream, so they do not
    overlap), not that of the host ops that launched them, which
    ``host_ops=False`` leaves out of the profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if host_ops else [])) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    return wall, rows


def profile_fit(torch, solver, count_syncs=False, rounds=None) -> None:
    """Where the time of one whole solve goes: a second ``fit()`` under
    ``torch.profiler`` (:func:`device_profile`). The profiler's own host
    cost makes the idle share an upper bound. With ``count_syncs``, a
    third fit counts the host syncs (per PCG round: ``rounds``)."""
    wall, rows = device_profile(torch, solver.fit)
    busy = sum(r[0] for r in rows) * 1e-6
    out = dict(wall_s=wall, device_busy_s=busy,
               busy_share=busy / wall if wall > 0 else None,
               top=[dict(name=k[:60], calls=c, device_s=t * 1e-6)
                    for t, c, k in rows[:12 if count_syncs else 8]])
    if count_syncs:
        syncs = count_host_syncs(torch, solver.fit)
        out.update(host_syncs=syncs, rounds=rounds,
                   host_syncs_per_round=syncs / rounds if rounds else None)
    print("profile " + json.dumps(out), flush=True)


def same_solve(tag, on_card, on_cpu, w="w") -> None:
    """The card's solve equals the CPU's: ``w`` (the result's attribute of
    that name) within rtol 1e-4 / atol 1e-6 and the same PCG iterations
    (or s-step rounds) per step."""
    import numpy as np
    a, b = getattr(on_card, w), getattr(on_cpu, w)
    close = bool(np.allclose(a, b, rtol=1e-4, atol=1e-6))
    same_iters = [h["pcg_iters"] for h in on_card.history] == \
        [h["pcg_iters"] for h in on_cpu.history]
    e = float(np.max(np.abs(a - b)))
    check(close and same_iters,
          f"{tag} on the card vs the CPU: w within rtol 1e-4 / atol "
          f"1e-6 {close} (max abs diff {e:.2e}), same PCG iterations "
          f"{same_iters}")


def small_reference(torch, rt) -> None:
    """Small solves on the card against the same solves on the CPU (the
    plain versions, which the repository's tests hold to the JAX
    package): sparse DiSCO-S classic and s-step (s = 4, fused), dense
    DiSCO-S at m = 4 two-pass, DiSCO-F at m = 1 fused and DiSCO-S s-step
    (s = 3); fused dense s-step (x_c_xt_multi rounds: DiSCO-S at m = 1
    and m = 4, s = 3, and DiSCO-F at m = 1, s = 2, whose s = 4 basis is
    too ill-conditioned in f32 for rtol 1e-4 between two summation
    orders); a λ-path on the fused s-step solve; softmax with 10 classes
    (every product split 8 + 2) on both partitions."""
    import numpy as np
    X, y, _ = rt.make_sparse_glm_data(d=96, n=200, density=0.2, alpha=0.8,
                                      beta=0.5, seed=1)
    cfg = rt.DiscoConfig(loss="logistic", lam=1e-3, tau=100, max_outer=4,
                         grad_tol=0.0, ell_block_d=16, ell_block_n=16,
                         partition="samples")
    same_solve("small sparse solve", rt.disco_fit(X, y, cfg, device="cuda"),
               rt.disco_fit(X, y, cfg, device="cpu"))
    cfg = rt.DiscoConfig(loss="logistic", lam=1e-3, tau=100, max_outer=4,
                         grad_tol=0.0, ell_block_d=16, ell_block_n=16,
                         partition="samples", hvp_fused=True, pcg_block_s=4)
    same_solve("small sparse s-step s=4 DiSCO-S m=1 fused",
               rt.disco_fit(X, y, cfg, device="cuda"),
               rt.disco_fit(X, y, cfg, device="cpu"))
    X, y, _ = rt.make_glm_data(d=98, n=202, seed=1)
    for partition, m, fused, s in (("samples", 4, False, 1),
                                   ("features", 1, True, 1),
                                   ("samples", 1, False, 3),
                                   ("samples", 1, True, 3),
                                   ("samples", 4, True, 3),
                                   ("features", 1, True, 2)):
        cfg = rt.DiscoConfig(loss="logistic", lam=1e-3, tau=100,
                             max_outer=4, grad_tol=0.0, use_kernel=True,
                             partition=partition, hvp_fused=fused,
                             pcg_block_s=s)
        group = rt.InProcessGroup(m)
        kind = "" if s == 1 else f" s-step s={s}"
        same_solve(f"small dense{kind} {run_tag(partition, m, fused)}",
                   rt.disco_fit(X, y, cfg, group=group, device="cuda"),
                   rt.disco_fit(X, y, cfg, group=group, device="cpu"))
    X_val, y_val, _ = rt.make_glm_data(d=98, n=150, seed=2)
    cfg = rt.DiscoConfig(loss="logistic", tau=100, max_outer=6,
                         grad_tol=1e-6, use_kernel=True, hvp_fused=True,
                         partition="samples", pcg_block_s=3)
    paths = [rt.lambda_path_fit(X, y, LAMBDAS, cfg, device=dev,
                                X_val=X_val, y_val=y_val)
             for dev in ("cuda", "cpu")]
    for lam, on_card, on_cpu in zip(LAMBDAS, paths[0].results,
                                    paths[1].results):
        same_solve(f"small lambda path point {lam:g}", on_card, on_cpu)
    check(paths[0].x_passes == paths[1].x_passes
          and paths[0].best_lambda == paths[1].best_lambda,
          f"small lambda path on the card vs the CPU: x passes "
          f"{paths[0].x_passes} vs {paths[1].x_passes}, best lambda "
          f"{paths[0].best_lambda} vs {paths[1].best_lambda}")
    X, _, _ = rt.make_glm_data(d=40, n=301, seed=3)
    rng = np.random.default_rng(2)
    labels = np.argmax(X.T @ rng.standard_normal((40, SOFTMAX_K))
                       + 0.1 * rng.standard_normal((301, SOFTMAX_K)), axis=1)
    for partition, m, s in (("samples", 1, 1), ("samples", 1, 2),
                            ("features", 4, 2)):
        cfg = rt.SoftmaxConfig(lam=1e-3, partition=partition, pcg_block_s=s,
                               use_kernel=True, max_outer=4, grad_tol=0.0,
                               tau=64)
        group = rt.InProcessGroup(m)
        on_card, on_cpu = (rt.softmax_fit(X, labels, cfg, group=group,
                                          device=dev)
                           for dev in ("cuda", "cpu"))
        same_solve(f"small softmax K={SOFTMAX_K} s={s} {partition} m={m}",
                   on_card, on_cpu, w="W")


def small_checkpoint_reference(torch, rt) -> None:
    """Checkpoints move between the card and the CPU: small_reference's
    sparse problem (DiSCO-S m = 1, DiSCO-F m = 4 on the LPT permutation)
    and a dense DiSCO-S solve, killed at step 2 on the card and resumed on
    the CPU, end within ``same_solve``'s tolerance of the CPU's
    uninterrupted solve with its PCG iterations."""
    import tempfile
    from repro_torch.robust import FaultInjector, FaultPlan, SimulatedKill
    Xs, ys, _ = rt.make_sparse_glm_data(d=96, n=200, density=0.2, alpha=0.8,
                                        beta=0.5, seed=1)
    Xd, yd, _ = rt.make_glm_data(d=98, n=202, seed=1)
    for kind, X, y, partition, m, kw in (
            ("sparse", Xs, ys, "samples", 1,
             dict(ell_block_d=16, ell_block_n=16)),
            ("sparse", Xs, ys, "features", 4,
             dict(ell_block_d=16, ell_block_n=16)),
            ("dense", Xd, yd, "samples", 1, dict(use_kernel=True))):
        cfg = rt.DiscoConfig(loss="logistic", lam=1e-3, tau=100,
                             max_outer=4, grad_tol=0.0, partition=partition,
                             **kw)
        group = rt.InProcessGroup(m)
        card = rt.DiscoSolver(X, y, cfg, group=group, device="cuda")
        with tempfile.TemporaryDirectory() as tmp:
            card._faults = FaultInjector(FaultPlan(kill_at_step=2))
            try:
                card.fit(checkpoint_dir=tmp)
                killed = False
            except SimulatedKill:
                killed = True
            cpu = rt.DiscoSolver(X, y, cfg, group=group, device="cpu")
            resumed = cpu.fit(checkpoint_dir=tmp, resume=True)
        check(killed, f"small {kind} {run_tag(partition, m, False)}: "
                      "killed on the card at step 2")
        same_solve(f"small {kind} {run_tag(partition, m, False)} "
                   "checkpointed on the card, resumed on the CPU", resumed,
                   cpu.fit())


def small_bf16_reference(torch, rt) -> None:
    """Small bf16 sparse solves (``hvp_dtype='bfloat16'``) on the card
    against the same solves on the CPU: DiSCO-S m = 1 two-pass and fused,
    DiSCO-F m = 2 two-pass and m = 1 fused s-step (s = 2). The same PCG
    iterations (or rounds) every step and w within relative L2
    BF16_REL_W_SMALL (F11: at bf16 another f32 summation order moves the
    solve that far, the reference's own solve included), the bf16
    instances launched and the f32 kernels only for the margins and the
    gradient."""
    import numpy as np
    from repro_torch.kernels import build
    X, y, _ = rt.make_sparse_glm_data(d=96, n=200, density=0.2, alpha=0.8,
                                      beta=0.5, seed=1)
    for partition, m, fused, s in (("samples", 1, False, 1),
                                   ("samples", 1, True, 1),
                                   ("features", 2, False, 1),
                                   ("features", 1, True, 2)):
        cfg = rt.DiscoConfig(loss="logistic", lam=1e-2, tau=100,
                             max_outer=4, grad_tol=0.0, ell_block_d=16,
                             ell_block_n=16, partition=partition,
                             hvp_fused=fused, pcg_block_s=s,
                             hvp_dtype="bfloat16")
        group = rt.InProcessGroup(m)
        build.reset_launch_counts()
        on_card = rt.disco_fit(X, y, cfg, group=group, device="cuda")
        counts = build.launch_counts()
        on_cpu = rt.disco_fit(X, y, cfg, group=group, device="cpu")
        e = rel_w(on_card.w, on_cpu.w)
        same_iters = [h["pcg_iters"] for h in on_card.history] == \
            [h["pcg_iters"] for h in on_cpu.history]
        bf16 = sum(counts[k] for k in SPARSE_BF16)
        f32_only_margins = (counts["ell_mv"] == 2 * m * len(on_card.history)
                            and not any(counts[k] for k in SPARSE_KERNELS[1:]))
        kind = "" if s == 1 else f" s-step s={s}"
        check(e <= BF16_REL_W_SMALL and same_iters and bf16 > 0
              and f32_only_margins and bool(np.isfinite(on_card.w).all()),
              f"small bf16 sparse{kind} {run_tag(partition, m, fused)} on "
              f"the card vs the CPU: rel diff of w {e:.2e} (<= "
              f"{BF16_REL_W_SMALL:g}), same PCG iterations {same_iters}, "
              f"bf16 launches {bf16}, f32 kernels for the margins and the "
              f"gradient only {f32_only_margins}")


def small_bf16_dense_reference(torch, rt) -> None:
    """Small bf16 dense solves (``hvp_dtype='bfloat16'``) on the card
    against the same solves on the CPU: two-pass DiSCO-S m = 1 and
    DiSCO-F m = 2 on the kernels' layout, DiSCO-S m = 1 s-step (s = 2),
    and DiSCO-S m = 1 on the plain layout; fused (the one-pass K5 / K10)
    DiSCO-S m = 1 and 2, DiSCO-F m = 1 s-step (s = 2) and DiSCO-F m = 2.
    The same PCG iterations (or rounds) every step and w within relative
    L2 BF16_REL_W_SMALL (F11), the bf16 instances launched on the
    kernels' layout (the one-pass ones wherever no collective separates
    the passes) and no f32 dense kernel at all."""
    import numpy as np
    from repro_torch.kernels import build
    X, y, _ = rt.make_glm_data(d=98, n=202, seed=1)
    for partition, m, s, use_kernel, fused in (
            ("samples", 1, 1, True, False), ("features", 2, 1, True, False),
            ("samples", 1, 2, True, False), ("samples", 1, 1, False, False),
            ("samples", 1, 1, True, True), ("samples", 2, 1, True, True),
            ("features", 1, 2, True, True), ("features", 2, 1, True, True)):
        cfg = rt.DiscoConfig(loss="logistic", lam=1e-3, tau=100,
                             max_outer=4, grad_tol=0.0, partition=partition,
                             pcg_block_s=s, use_kernel=use_kernel,
                             hvp_fused=fused, hvp_dtype="bfloat16")
        group = rt.InProcessGroup(m)
        build.reset_launch_counts()
        on_card = rt.disco_fit(X, y, cfg, group=group, device="cuda")
        counts = build.launch_counts()
        on_cpu = rt.disco_fit(X, y, cfg, group=group, device="cpu")
        e = rel_w(on_card.w, on_cpu.w)
        same_iters = [h["pcg_iters"] for h in on_card.history] == \
            [h["pcg_iters"] for h in on_cpu.history]
        bf16 = sum(counts[k] for k in DENSE_BF16 + DENSE_FUSED_BF16)
        one_pass = sum(counts[k] for k in DENSE_FUSED_BF16)
        f32 = sum(counts[k] for k in DENSE_KERNELS)
        kind = "" if s == 1 else f" s-step s={s}"
        layout = "" if use_kernel else " plain layout"
        check(e <= BF16_REL_W_SMALL and same_iters and f32 == 0
              and (bf16 > 0) == use_kernel
              and (one_pass > 0) == (fused and (partition == "samples"
                                                or m == 1))
              and bool(np.isfinite(on_card.w).all()),
              f"small bf16 dense{kind} {run_tag(partition, m, fused)}"
              f"{layout} on the card vs the CPU: rel diff of w {e:.2e} (<= "
              f"{BF16_REL_W_SMALL:g}), same PCG iterations {same_iters}, "
              f"bf16 launches {bf16} (one-pass {one_pass}), f32 dense "
              f"launches {f32}")


# ---------------------------------------------------------------------------
# the paper's comparisons: original DiSCO (SAG), Hessian subsampling, and
# the GD / DANE / CoCoA+ baselines
# ---------------------------------------------------------------------------

def same_baseline(tag, on_card, on_cpu) -> None:
    """A baseline's fit on the card equals the CPU's: ``w`` within rtol
    1e-4 / atol 1e-6, the per-iteration gradient norms within rtol 1e-4
    and the same ledger."""
    import numpy as np
    (wa, ha, la), (wb, hb, lb) = on_card, on_cpu
    close = bool(np.allclose(wa, wb, rtol=1e-4, atol=1e-6))
    ga = np.array([h["grad_norm"] for h in ha])
    gb = np.array([h["grad_norm"] for h in hb])
    grads = ga.shape == gb.shape and bool(np.allclose(ga, gb, rtol=1e-4))
    check(close and grads and la == lb,
          f"{tag} on the card vs the CPU: w within rtol 1e-4 / atol 1e-6 "
          f"{close} (max abs diff {float(np.max(np.abs(wa - wb))):.2e}), "
          f"grad norms {grads}, ledger {la == lb}")


def small_comparisons(torch, rt) -> None:
    """The comparisons on small problems, card against CPU: the original
    DiSCO (``precond='sag'``, DiSCO-S) sparse and dense at m = 1 and 4
    and one sparse s-step solve (s = 3); Hessian subsampling (frac 0.5,
    lam 1e-2, the same seed and so the same masks on both) on both
    partitions, sparse and dense, at m = 1 and 4; GD, DANE and CoCoA+,
    logistic and quadratic, at m = 1 and 4."""
    base = dict(loss="logistic", lam=1e-3, tau=100, max_outer=4,
                grad_tol=0.0)
    Xs, ys, _ = rt.make_sparse_glm_data(d=96, n=200, density=0.2,
                                        alpha=0.8, beta=0.5, seed=1)
    Xd, yd, _ = rt.make_glm_data(d=98, n=202, seed=1)
    problems = (("sparse", Xs, ys, dict(ell_block_d=16, ell_block_n=16)),
                ("dense", Xd, yd, dict(use_kernel=True)))
    for kind, X, y, kw in problems:
        runs = ((1, 1), (4, 1)) + (((1, 3),) if kind == "sparse" else ())
        for m, s in runs:
            cfg = rt.DiscoConfig(partition="samples", precond="sag",
                                 sag_epochs=5, pcg_block_s=s, **base, **kw)
            group = rt.InProcessGroup(m)
            same_solve(f"small {kind} SAG DiSCO-S m={m}"
                       + ("" if s == 1 else f" s-step s={s}"),
                       rt.disco_fit(X, y, cfg, group=group, device="cuda"),
                       rt.disco_fit(X, y, cfg, group=group, device="cpu"))
        for partition in ("samples", "features"):
            for m in COMPARISON_SHARDS:
                cfg = rt.DiscoConfig(partition=partition,
                                     hessian_subsample=0.5,
                                     **dict(base, lam=1e-2), **kw)
                group = rt.InProcessGroup(m)
                same_solve(f"small {kind} subsampled 0.5 "
                           f"{run_tag(partition, m, False)}",
                           rt.disco_fit(X, y, cfg, group=group,
                                        device="cuda"),
                           rt.disco_fit(X, y, cfg, group=group,
                                        device="cpu"))
    X, y, _ = rt.make_glm_data(d=40, n=202, seed=2)
    for loss in ("logistic", "quadratic"):
        for name, fit, cfg in (
                ("GD", rt.gd_fit, rt.GDConfig(loss=loss, lam=1e-3,
                                              max_outer=8)),
                ("DANE", rt.dane_fit, rt.DaneConfig(loss=loss, lam=1e-3,
                                                    max_outer=3)),
                ("CoCoA+", rt.cocoa_fit, rt.CocoaConfig(loss=loss, lam=1e-3,
                                                        max_outer=3))):
            for m in COMPARISON_SHARDS:
                group = rt.InProcessGroup(m)
                same_baseline(f"small {name} {loss} m={m}",
                              fit(X, y, cfg, group=group, device="cuda"),
                              fit(X, y, cfg, group=group, device="cpu"))


def launches_and_busy(torch, fn) -> dict:
    """``fn()`` once under the profiler: its device launches (every
    device-side event: kernels, copies, fills), device busy time, wall
    time and busy share."""
    wall, rows = device_profile(torch, fn)
    busy = sum(r[0] for r in rows) * 1e-6
    return dict(launches=sum(r[1] for r in rows), device_ms=busy * 1e3,
                profiled_wall_ms=wall * 1e3,
                busy_share=busy / wall if wall > 0 else None)


def time_sag_application(torch, solver) -> dict:
    """One SAG application (``sag_epochs`` x tau serial steps) on the
    solver's replicated X_tau slab, with the first step's phi'' = 1/4:
    ms between CUDA events (mean of 3, after a warm-up: the launches' host
    time included, as the solve pays it) and one more under the profiler
    (launches, device time, busy share)."""
    from repro_torch.core.preconditioner import sag_solve
    cfg = solver.cfg
    X_tau = solver.X_tau
    coeffs = torch.full((X_tau.shape[1],), 0.25, device=X_tau.device)
    g = torch.Generator(device=X_tau.device).manual_seed(0)
    r = torch.randn(X_tau.shape[0], generator=g, device=X_tau.device)

    def apply():
        return sag_solve(X_tau, coeffs, cfg.lam, cfg.mu, r,
                         epochs=cfg.sag_epochs)
    apply()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        apply()
    stop.record()
    torch.cuda.synchronize()
    row = dict(ms=start.elapsed_time(stop) / 3,
               steps=cfg.sag_epochs * X_tau.shape[1],
               slab_bytes=X_tau.numel() * 4)
    row.update(launches_and_busy(torch, apply))
    return row


def classic_ell_launches(m, steps, iters) -> dict:
    """ell_mv launches of a classic two-pass sparse fit: margins and
    gradient, one per shard a Newton step, and two per shard a PCG
    iteration (the HVP's two passes); no other sparse kernel."""
    n = dict.fromkeys(SPARSE_KERNELS, 0)
    n["ell_mv"] = 2 * m * (steps + iters)
    return n


def f_decreases(hist) -> bool:
    return all(b["f"] < a["f"] for a, b in zip(hist, hist[1:]))


def sag_slice_runs(torch, rt, build, X, y, woodbury, launches) -> None:
    """The original DiSCO at the sparse slice's shape: DiSCO-S with
    ``precond='sag'`` (sag_epochs = 5, tau = 100) at m = 1 and 4, 2 Newton
    steps, two-pass (3 until the bf16 one-pass phases took their time). Each: the launches the code predicts, f decreasing
    at every step and the gradient norm falling; one SAG application
    timed (ms, launches, busy share) on the first; the steps' PCG
    iterations and time per SAG application against the classic
    Woodbury run (``woodbury``: its PCG iterations per step)."""
    ws = {}
    for m in COMPARISON_SHARDS:
        tag = f"SAG {run_tag('samples', m, False)}"
        cfg = rt.DiscoConfig(partition="samples", **SAG_SOLVE)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        solver = rt.DiscoSolver(X, y, cfg, group=rt.InProcessGroup(m),
                                device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        sag = time_sag_application(torch, solver) if m == 1 else None
        res, counts = fit_counted(torch, build, solver)
        for k in SPARSE_KERNELS:
            launches[k] += counts[k]
        hist = res.history
        iters = [int(h["pcg_iters"]) for h in hist]
        # one application before PCG's loop and one an iteration
        apps = sum(iters) + len(hist)
        fit_s = sum(h["iter_s"] for h in hist)
        row = run_row(torch, tag, res, counts, setup_s,
                      f=[h["f"] for h in hist],
                      woodbury_pcg_iters=woodbury[:len(hist)],
                      sag_applications=apps,
                      ms_per_application_in_fit=fit_s / apps * 1e3,
                      sag_application=sag)
        check(bool(torch.from_numpy(res.w).isfinite().all())
              and res.w.shape == (X.shape[0],),
              f"{tag}: finite w of shape (d,)")
        check_f_decreases(tag, hist)
        check(row["grad_norm_last"] < row["grad_norm_first"],
              f"{tag}: grad_norm {row['grad_norm_first']:.3e} -> "
              f"{row['grad_norm_last']:.3e}")
        want = classic_ell_launches(m, len(hist), sum(iters))
        got = {k: counts[k] for k in want}
        check(got == want, f"{tag}: launches as predicted "
                           f"{json.dumps(want)}"
              + ("" if got == want else f", got {json.dumps(got)}"))
        if sag is not None:
            print(f"{tag}: one SAG application {sag['ms']:.2f} ms, "
                  f"{sag['launches']} launches, device {sag['device_ms']:.2f}"
                  f" ms, busy {sag['busy_share']}", flush=True)
        ws[m] = res.w
        del solver, res
        gc.collect()
        torch.cuda.empty_cache()
    print(f"SAG DiSCO-S m=4 vs m=1: rel diff of w "
          f"{rel_w(ws[4], ws[1]):.2e}", flush=True)


def subsample_slice_runs(torch, rt, build, X, y, launches) -> None:
    """Hessian subsampling at the sparse slice's shape: DiSCO-F two-pass
    with ``hessian_subsample`` in SUBSAMPLE_FRACS at m = 1 and 4, 2
    Newton steps (3 until the bf16 one-pass phases took their time). Each: one mask a step over the padded sample axis,
    its mean within 5 sigma of frac; finite f and w; the launches the code
    predicts. f and the gradient norm are printed, not held to a
    decrease: at lam = 1e-4 with d > n a Newton step on a 6.25% Hessian
    raises f (the JAX package's solve does the same, PERF.md). The m = 1
    frac 0.5 fit is profiled."""
    import numpy as np
    from repro_torch.core import disco as disco_mod
    draw = disco_mod.subsample_mask
    for frac in SUBSAMPLE_FRACS:
        for m in COMPARISON_SHARDS:
            tag = f"subsampled {frac:g} {run_tag('features', m, False)}"
            cfg = rt.DiscoConfig(partition="features",
                                 hessian_subsample=frac, **SUBSAMPLE_SOLVE)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            solver = rt.DiscoSolver(X, y, cfg, group=rt.InProcessGroup(m),
                                    device="cuda")
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            masks = []

            def spy(seed, outer_iter, shard, frac_, shape):
                mask = draw(seed, outer_iter, shard, frac_, shape)
                masks.append((shard, tuple(shape), float(mask.float()
                                                         .mean())))
                return mask
            disco_mod.subsample_mask = spy
            try:
                res, counts = fit_counted(torch, build, solver)
            finally:
                disco_mod.subsample_mask = draw
            for k in SPARSE_KERNELS:
                launches[k] += counts[k]
            hist = res.history
            iters = [int(h["pcg_iters"]) for h in hist]
            n_pad = int(solver.smask.shape[0])
            run_row(torch, tag, res, counts, setup_s,
                    f=[h["f"] for h in hist],
                    f_decreases=f_decreases(hist),
                    grad_norms=[h["grad_norm"] for h in hist],
                    mask_means=[k[2] for k in masks])
            check(bool(np.isfinite(res.w).all())
                  and all(np.isfinite(h["f"]) for h in hist),
                  f"{tag}: finite w and f")
            spread = 5 * (frac * (1 - frac) / n_pad) ** 0.5
            check(len(masks) == len(hist)
                  and all(sh is None and shape == (n_pad,)
                          and abs(mean - frac) <= spread
                          for sh, shape, mean in masks),
                  f"{tag}: one shared mask a step over the padded n "
                  f"({n_pad}), means {[round(k[2], 4) for k in masks]} "
                  f"within 5 sigma ({spread:.4f}) of {frac:g}")
            want = classic_ell_launches(m, len(hist), sum(iters))
            got = {k: counts[k] for k in want}
            check(got == want, f"{tag}: launches as predicted "
                               f"{json.dumps(want)}"
                  + ("" if got == want else f", got {json.dumps(got)}"))
            if (frac, m) == (SUBSAMPLE_FRACS[0], 1):
                try:
                    profile_fit(torch, solver)
                except RuntimeError as exc:   # a measurement only
                    print(f"profile unavailable: {exc}", flush=True)
            del solver, res
            gc.collect()
            torch.cuda.empty_cache()


def timed_fit(torch, rt, fit, X, y, cfg, m):
    """A baseline's fit on the card on ``m`` shards, and its wall time."""
    t0 = time.perf_counter()
    out = fit(X, y, cfg, group=rt.InProcessGroup(m), device="cuda")
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def baselines_dense_phase(torch, rt, X, y) -> None:
    """GD and DANE on the dense slice's X (4 GiB), logistic at the slice's
    lam, m = 1 and 4, BASELINE_OUTER outer iterations: ms per outer
    iteration (a 1-iteration fit's time subtracted, so set-up and GD's
    power iteration drop out), rounds, gradient norms; the gradient norm
    must fall and w be finite."""
    import numpy as np
    lam = DENSE_SOLVE["lam"]
    for name, fit, cls in (("GD", rt.gd_fit, rt.GDConfig),
                           ("DANE", rt.dane_fit, rt.DaneConfig)):
        for m in COMPARISON_SHARDS:
            tag = f"dense {name} m={m}"
            torch.cuda.reset_peak_memory_stats()
            _, t1 = timed_fit(torch, rt, fit, X, y,
                              cls(loss="logistic", lam=lam, max_outer=1), m)
            (w, hist, ledger), tk = timed_fit(
                torch, rt, fit, X, y,
                cls(loss="logistic", lam=lam, max_outer=BASELINE_OUTER), m)
            g = [h["grad_norm"] for h in hist]
            print("baseline " + json.dumps(dict(
                run=tag, outer=len(hist), grad_norms=g,
                f=[h["f"] for h in hist],
                rounds=[h["comm_rounds_cum"] for h in hist],
                ms_per_outer=(tk - t1) / (len(hist) - 1) * 1e3,
                fit_s=tk, one_outer_fit_s=t1,
                max_memory_allocated=torch.cuda.max_memory_allocated())),
                flush=True)
            check(bool(np.isfinite(w).all()) and g[-1] < g[0]
                  and ledger.rounds == hist[-1]["comm_rounds_cum"],
                  f"{tag}: finite w, grad_norm {g[0]:.3e} -> {g[-1]:.3e}")
            del w, hist
            gc.collect()
            torch.cuda.empty_cache()


def cocoa_pass_launches(torch, rt, X, y, lam, m) -> dict:
    """Launches of one CoCoA+ outer step at the full local pass, from two
    profiled outer steps of COCOA_PROBE_STEPS local steps: every local
    step issues the same operations, so the launches are linear in the
    step count."""
    counts = []
    for steps in COCOA_PROBE_STEPS:
        cfg = rt.CocoaConfig(loss="logistic", lam=lam, max_outer=1,
                             local_steps=steps)
        counts.append(launches_and_busy(torch, lambda: rt.cocoa_fit(
            X, y, cfg, group=rt.InProcessGroup(m), device="cuda")))
    (a, b), (ca, cb) = COCOA_PROBE_STEPS, counts
    per_step = (cb["launches"] - ca["launches"]) / (b - a)
    fixed = ca["launches"] - a * per_step
    n_loc = -(-X.shape[1] // m)
    return dict(per_local_step=per_step, fixed=fixed,
                per_outer=fixed + n_loc * per_step, local_steps=n_loc,
                probe_busy_share=cb["busy_share"])


def figure3_phase(torch, rt, build) -> None:
    """Figure 3 on the card: DiSCO-F, DiSCO-S, the original DiSCO (SAG),
    DANE and CoCoA+ on ``make_regime('rcv1_like')`` (256 x 4096 dense),
    logistic, lam 1e-4, m = 4, FIG3['outer'] outer iterations each
    (CoCoA+ FIG3['cocoa_outer']), the DiSCO runs on the dense kernels:
    gradient norm and cumulative rounds per iteration, wall time per
    iteration, and CoCoA+'s launches per outer step. Every gradient norm
    finite; the Newton-type methods' and DANE's falling."""
    import numpy as np
    from repro_torch.data.synthetic import make_regime
    X, y, _ = make_regime(FIG3["regime"])
    lam, m, outer = FIG3["lam"], FIG3["m"], FIG3["outer"]
    group = rt.InProcessGroup(m)
    rows = []
    for name, partition, precond in (("DiSCO-F", "features", "woodbury"),
                                     ("DiSCO-S", "samples", "woodbury"),
                                     ("DiSCO(SAG)", "samples", "sag")):
        cfg = rt.DiscoConfig(loss="logistic", lam=lam, tau=100,
                             partition=partition, precond=precond,
                             sag_epochs=5, max_outer=outer, grad_tol=0.0,
                             use_kernel=True)
        build.reset_launch_counts()
        t0 = time.perf_counter()
        res = rt.disco_fit(X, y, cfg, group=group, device="cuda")
        torch.cuda.synchronize()
        rows.append(dict(algorithm=name, grad_norms=res.grad_norms.tolist(),
                         rounds=res.comm_rounds.tolist(),
                         pcg_iters=[int(h["pcg_iters"])
                                    for h in res.history],
                         s_per_outer=(time.perf_counter() - t0) / outer,
                         launches=build.launch_counts()))
    for name, fit, cfg in (
            ("DANE", rt.dane_fit, rt.DaneConfig(loss="logistic", lam=lam,
                                                max_outer=outer)),
            ("CoCoA+", rt.cocoa_fit,
             rt.CocoaConfig(loss="logistic", lam=lam,
                            max_outer=FIG3["cocoa_outer"]))):
        (w, hist, ledger), wall = timed_fit(torch, rt, fit, X, y, cfg, m)
        rows.append(dict(algorithm=name,
                         grad_norms=[h["grad_norm"] for h in hist],
                         rounds=[h["comm_rounds_cum"] for h in hist],
                         s_per_outer=wall / len(hist)))
    cocoa = cocoa_pass_launches(torch, rt, X, y, lam, m)
    for row in rows:
        print("figure3 " + json.dumps(dict(row, regime=FIG3["regime"],
                                           m=m, lam=lam)), flush=True)
        g = row["grad_norms"]
        falls = row["algorithm"] == "CoCoA+" or g[-1] < g[0]
        check(bool(np.isfinite(g).all()) and falls,
              f"figure 3 {row['algorithm']}: grad norms "
              f"{[float(f'{v:.3e}') for v in g]} at rounds {row['rounds']}")
    print("cocoa launches " + json.dumps(cocoa), flush=True)
    check(cocoa["per_local_step"] > 0 and cocoa["fixed"] >= 0,
          f"CoCoA+ launches linear in the local steps: "
          f"{cocoa['per_local_step']:g} a step, {cocoa['fixed']:g} fixed")


# ---------------------------------------------------------------------------
# flash attention (K11) and the dense decoder serving slice
# ---------------------------------------------------------------------------

def attended_pairs(S, T, causal, window, kv_len=None) -> int:
    """(q, k) pairs the masks keep for one (batch, head): the work the
    kernel must do on these inputs."""
    import numpy as np
    kv_len = T if kv_len is None else kv_len
    i = np.arange(S, dtype=np.int64)
    hi = np.minimum(kv_len, i + 1) if causal else np.full(S, kv_len)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(S, int)
    return int(np.maximum(0, hi - lo).sum())


def flash_bound(B, Hq, Hkv, S, T, Dh, esize, causal, window, kv_len=None):
    """Least time of one call: 4 Dh flops per attended pair over the bf16
    tensor-core rate (f32: the CUDA-core rate), or q, k, v and o moved
    once over the HBM rate, whichever is larger."""
    pairs = B * Hq * attended_pairs(S, T, causal, window, kv_len)
    flops = 4 * Dh * pairs
    nbytes = esize * Dh * (2 * B * Hq * S + 2 * B * Hkv * T)
    t_ops = flops / (BF16_FLOPS_PER_S if esize == 2 else F32_FLOPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return dict(pairs=pairs, flops=flops, bytes=nbytes,
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def flash_inputs(torch, B, Hq, Hkv, S, T, Dh, dtype, seed,
                 layout="contiguous"):
    """q, k, v from a seed, laid out as FLASH_LAYOUTS names."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "contiguous":
        mk = lambda b, h, n: torch.randn((b, h, n, Dh), generator=g,
                                         device="cuda").to(dtype)
    else:
        pad = 8 if layout == "sliced" else 0
        mk = lambda b, h, n: torch.randn(
            (b, n, h, Dh + pad), generator=g,
            device="cuda").to(dtype)[..., :Dh].transpose(1, 2)
    return mk(B, Hq, S), mk(B, Hkv, T), mk(B, Hkv, T)


def phase_flash_kernel(torch, flash, ref, errs, bf16_errs) -> None:
    """K11 against its plain version on the card, f32 (TF32 off) and bf16
    (against the plain version in f32 on the same bf16 inputs), over
    FLASH_CASES, then in bf16 at the model prefills' calls (FLASH_MODEL_CASES);
    each call is repeated and must match bit for bit. For
    bf16 it also prints the error of the plain f32 output rounded to bf16,
    the part of the kernel's error that the output dtype alone makes (the
    rest comes from P rounded to bf16 before the PV product)."""
    rounding = []
    for i, (B, Hq, Hkv, S, T, Dh, causal, window, kv_len) in enumerate(
            FLASH_CASES):
        for dtype, layout in ((d, l) for d in (torch.float32, torch.bfloat16)
                              for l in FLASH_LAYOUTS):
            q, k, v = flash_inputs(torch, B, Hq, Hkv, S, T, Dh, dtype, i,
                                   layout)
            kw = dict(causal=causal, window=window, kv_len=kv_len)
            got = flash.flash_attention(q, k, v, **kw)
            again = flash.flash_attention(q, k, v, **kw)
            want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                           **kw)
            torch.cuda.synchronize()
            tag = (f"flash_attention {str(dtype)[6:]} {layout} B={B} "
                   f"Hq={Hq} Hkv={Hkv} S={S} T={T} Dh={Dh} causal={causal} "
                   f"window={window} kv_len={kv_len}")
            if dtype == torch.float32:
                e = record_err(errs, "flash_attention", got, want)
            else:
                e = record_err(bf16_errs, "flash_attention", got.float(),
                               want)
                rounding.append(
                    [e, rel_err(want.to(torch.bfloat16).float(), want)])
                tag += f" (output rounding alone {rounding[-1][1]:.2e})"
            tol = FLASH_TOL[str(dtype)[6:]]
            check(e <= tol and torch.equal(got, again)
                  and bool(got.isfinite().all()),
                  f"{tag}: rel err {e:.2e} (<= {tol:g}), repeats bit for "
                  f"bit {torch.equal(got, again)}")
    for name, (B, Hq, Hkv, S, T, Dh, causal, window, kv_len) in \
            FLASH_MODEL_CASES.items():
        q, k, v = flash_inputs(torch, B, Hq, Hkv, S, T, Dh, torch.bfloat16,
                               len(name), "head_major")
        kw = dict(causal=causal, window=window, kv_len=kv_len)
        got = flash.flash_attention(q, k, v, **kw)
        again = flash.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        e = record_err(bf16_errs, "flash_attention", got.float(), want)
        rounding.append([e, rel_err(want.to(torch.bfloat16).float(), want)])
        tol = FLASH_TOL["bfloat16"]
        check(e <= tol and torch.equal(got, again)
              and bool(got.isfinite().all()),
              f"flash_attention bf16 head_major at {name}'s prefill B={B} "
              f"Hq={Hq} Hkv={Hkv} S={S} T={T} Dh={Dh} causal={causal} "
              f"window={window}: rel err {e:.2e} (<= {tol:g}; output "
              f"rounding alone {rounding[-1][1]:.2e}), repeats bit for bit "
              f"{torch.equal(got, again)}")
        del q, k, v, got, again, want
        torch.cuda.empty_cache()
    ratio = max(r[0] / r[1] for r in rounding)
    print("flash_attention bf16 error against output rounding " + json.dumps(
        dict(kernel_rel_err_max=max(r[0] for r in rounding),
             output_rounding_rel_err_max=max(r[1] for r in rounding),
             ratio_max=ratio, per_case=rounding)), flush=True)
    check(ratio <= FLASH_ROUNDING_RATIO,
          f"flash_attention bf16: error at most {ratio:.3f}x the output "
          f"rounding's alone (<= {FLASH_ROUNDING_RATIO})")


def phase_flash_timing(torch, flash, ref, errs, bf16_errs) -> dict:
    """K11 timed at FLASH_TIMED beside its plain version (where the scores
    fit) and beside ``scaled_dot_product_attention`` (the library
    yardstick; the port never calls it). One JSON line per shape."""
    import torch.nn.functional as F
    rows = {}
    for name, (B, Hq, Hkv, S, Dh, dtype_name, reps, plain, layout) in \
            FLASH_TIMED.items():
        dtype = getattr(torch, dtype_name)
        q, k, v = flash_inputs(torch, B, Hq, Hkv, S, S, Dh, dtype, 99, layout)
        kernel = lambda: flash.flash_attention(q, k, v, causal=True)
        library = lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=Hq != Hkv)
        got, lib = kernel(), library()
        row = dict(shape=[B, Hq, Hkv, S, S, Dh], dtype=dtype_name,
                   layout=layout, causal=True,
                   **flash_bound(B, Hq, Hkv, S, S, Dh, q.element_size(),
                                 True, 0))
        if plain:
            want = ref.flash_attention_ref(q.float(), k.float(), v.float())
            torch.cuda.synchronize()
            e = record_err(errs if dtype == torch.float32 else bf16_errs,
                           "flash_attention", got.float(), want)
            tol = FLASH_TOL[str(dtype)[6:]]
            check(e <= tol, f"flash_attention {name} {row['shape']}: rel "
                            f"err {e:.2e} (<= {tol:g})")
            row.update(rel_err_vs_plain=e, abs_err_vs_plain=float(
                (got.float() - want).abs().max()))
            del want
            row["plain_ms"] = time_ms(
                lambda: ref.flash_attention_ref(q, k, v), reps=reps)
        else:
            row["plain_ms"] = None     # scores of B*Hq*S*S f32 do not fit
        lib_err = rel_err(lib.float(), got.float())
        del got, lib
        row["ms"] = time_ms(kernel, reps=reps)
        row["library_ms"] = time_ms(library, reps=reps)
        row["library_rel_diff"] = lib_err
        row["tflops"] = row["flops"] / row["ms"] / 1e9
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["vs_library"] = row["ms"] / row["library_ms"]
        print(f"flash_attention {name} " + json.dumps(row), flush=True)
        rows[name] = row
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def phase_model(torch, rt, build) -> int:
    """The serving slice: olmo-1b at its published width in bf16, weights
    from seed 0. Prefill ``forward(last_only=True)`` of PREFILL tokens (16
    K11 launches each), then ``Engine.generate`` and ``ContinuousEngine``
    decode (no K11 launch). Returns K11's launches on this path."""
    import numpy as np
    cfg = rt.get_config(MODEL_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype)
          == (16, 2048, 16, 16, 128, 8192, 50304, "bfloat16"),
          f"{MODEL_ARCH} at its published width in bf16")
    t0 = time.perf_counter()
    model = rt.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.param_count() == 1_176_764_416,
          f"{MODEL_ARCH}: {n_params} parameters on the card "
          f"({time.perf_counter() - t0:.1f} s to draw)")
    B, S = PREFILL
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    prefill = lambda: rt.forward(cfg, model, {"tokens": tokens},
                                 last_only=True)[0]
    logits = prefill()                                     # warm-up
    launches, times = 0, []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(PREFILL_REPS):
        build.reset_launch_counts()
        t0 = time.perf_counter()
        logits = prefill()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        n = build.launch_counts()["flash_attention"]
        launches += n
        check(n == cfg.num_layers, f"prefill: {n} K11 launches per forward "
                                   f"(one per layer: {cfg.num_layers})")
    peak = torch.cuda.max_memory_allocated()
    check(tuple(logits.shape) == (B, 1, cfg.padded_vocab)
          and logits.dtype == torch.float32
          and bool(logits.isfinite().all()),
          f"prefill logits {tuple(logits.shape)} {logits.dtype}, finite")
    wall, rows = device_profile(torch, prefill)
    busy = sum(r[0] for r in rows) * 1e-6
    k11 = sum(r[0] for r in rows if FLASH_KERNEL_NAMES.search(r[2])) * 1e-6
    check(k11 > 0, f"prefill: the profiler finds K11's kernels "
                   f"({FLASH_KERNEL_NAMES.pattern}), {k11 * 1e3:.2f} ms a "
                   f"forward")
    med = statistics.median(times)
    print("model prefill " + json.dumps(dict(
        arch=MODEL_ARCH, batch=B, seq=S, dtype=cfg.dtype, params=n_params,
        forward_s=times, forward_s_median=med, tokens_per_s=B * S / med,
        k11_s_per_forward=k11, k11_share=k11 / busy if busy else None,
        profiled_wall_s=wall, device_busy_s=busy,
        busy_share=busy / wall if wall else None,
        top=[dict(name=k[:60], calls=c, device_s=t * 1e-6)
             for t, c, k in rows[:8]],
        max_memory_allocated=peak)), flush=True)
    bf16_against_f32(torch, rt, cfg, model, tokens, logits,
                     f"{MODEL_ARCH} B={B} S={S}")
    del logits

    # decode: Engine.generate replays the prompts through decode_step
    rng = np.random.default_rng(2)
    reqs = [rt.Request(prompt=rng.integers(0, cfg.vocab_size,
                                           SERVE["prompt"]).tolist(),
                       max_new_tokens=SERVE["new"])
            for _ in range(SERVE["batch"])]
    eng = rt.Engine(cfg, model, batch_size=SERVE["batch"],
                    max_len=S + 64)
    eng.generate(reqs[:1])                                 # warm-up
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = build.launch_counts()["flash_attention"]
    check(n == 0, f"decode: {n} K11 launches (decode attention is plain)")
    steps = SERVE["prompt"] + outs[0].steps - 1            # decode_step calls
    new = sum(len(o.tokens) for o in outs)
    check(all(len(o.tokens) == SERVE["new"] for o in outs),
          f"Engine: every request got {SERVE['new']} tokens")
    print("model decode " + json.dumps(dict(
        arch=MODEL_ARCH, batch=SERVE["batch"], prompt=SERVE["prompt"],
        new_tokens=SERVE["new"], max_len=S + 64, generate_s=dt,
        decode_steps=steps, ms_per_decode_step=1e3 * dt / steps,
        new_tokens_per_s=new / dt,
        max_memory_allocated=torch.cuda.max_memory_allocated())),
        flush=True)
    # where a decode step's time goes: DECODE_PROFILED steps on a fresh
    # cache under the profiler, and the host syncs of as many more
    cache = rt.init_cache(cfg, SERVE["batch"], S + 64)

    def decode(n=DECODE_PROFILED):
        nonlocal cache
        for t in range(n):
            _, cache = rt.decode_step(cfg, model, tokens[:, t:t + 1], cache)
    decode()                                               # warm-up
    wall, rows = device_profile(torch, decode)
    busy = sum(r[0] for r in rows) * 1e-6
    print("model decode profile " + json.dumps(dict(
        steps=DECODE_PROFILED, profiled_wall_s=wall, device_busy_s=busy,
        busy_share=busy / wall if wall else None,
        device_ms_per_step=1e3 * busy / DECODE_PROFILED,
        host_syncs_per_step=count_host_syncs(torch, decode)
        / DECODE_PROFILED,
        launches_per_step=sum(r[1] for r in rows) / DECODE_PROFILED,
        top=[dict(name=k[:60], calls=c, device_s=t * 1e-6)
             for t, c, k in rows[:8]])), flush=True)
    del cache
    again = eng.generate(reqs)
    check([o.tokens for o in again] == [o.tokens for o in outs],
          "Engine: greedy output repeats on a second run")
    solo = eng.generate(reqs[:1])
    check(solo[0].tokens == outs[0].tokens,
          "Engine: a request alone equals the same request in the batch")
    ce = rt.ContinuousEngine(cfg, model, batch_size=SERVE["batch"],
                             max_len=256)
    for i in range(6):
        ce.submit(rt.Request(prompt=rng.integers(0, cfg.vocab_size,
                                                 16).tolist(),
                             max_new_tokens=8))
    build.reset_launch_counts()
    done = ce.run_until_done(max_ticks=200)
    check(sorted(done) == list(range(6))
          and all(len(c.tokens) == 8 for c in done.values())
          and build.launch_counts()["flash_attention"] == 0,
          f"ContinuousEngine: 6 requests over {SERVE['batch']} slots all "
          f"finished in {ce.ticks} ticks, no K11 launch")
    del model, eng, ce
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def bf16_against_f32(torch, rt, cfg, model, tokens, logits, tag) -> None:
    """The bf16 prefill's last logits against the same forward in f32 on
    the same weights upcast, through K11's f32 kernel (held to the plain
    version at 1e-5): relative L2 <= BF16_MODEL_TOL. This holds the bf16
    tensor-core kernel inside the model against a reference."""
    from repro_torch.models import DecoderLM
    f32 = cfg.replace(dtype="float32")
    up = DecoderLM(f32, None, torch.float32, torch.device("cuda"))
    up.load_state_dict(model.state_dict())
    want = rt.forward(f32, up, {"tokens": tokens}, last_only=True)[0]
    e = rel_err(logits, want)
    same = float((logits.argmax(-1) == want.argmax(-1)).float().mean())
    check(e <= BF16_MODEL_TOL,
          f"{tag}: bf16 prefill vs the f32 forward on the same weights, "
          f"last logits rel L2 {e:.2e} (<= {BF16_MODEL_TOL:g}), argmax "
          f"equal in {same:.2f} of rows")
    del up, want
    gc.collect()
    torch.cuda.empty_cache()


def card_against_cpu(torch, rt, cfg, seq, seed, tag, batch=1) -> None:
    """``forward`` on the card (K11, f32) against the port on the CPU (the
    plain version) on the same weights: relative L2 <= 1e-4."""
    from repro_torch.models import DecoderLM
    model = rt.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed))
    on_cpu = DecoderLM(cfg, None, torch.float32, torch.device("cpu"))
    on_cpu.load_state_dict(model.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=torch.Generator().manual_seed(seed))
    got = rt.forward(cfg, model, {"tokens": tokens})[0].cpu()
    want = rt.forward(cfg, on_cpu, {"tokens": tokens})[0]
    e = rel_err(got, want)
    check(e <= 1e-4, f"{tag}: card vs CPU forward of {batch}x{seq} tokens "
                     f"in f32, rel L2 {e:.2e} (<= 1e-4)")
    del model, on_cpu
    gc.collect()
    torch.cuda.empty_cache()


def phase_model_consistency(torch, rt, build) -> None:
    """At full width in f32 (TF32 off, so no tolerance rests on it):
    olmo-1b's prefill (K11) against the teacher-forced replay through
    ``decode_step`` (plain decode attention); olmo-1b at 2 layers and
    chatglm3-6b at 2 layers, card against CPU; and chatglm3-6b's bf16
    prefill, K11 at GQA group 16."""
    cfg = rt.get_config(MODEL_ARCH).replace(dtype="float32")
    model = rt.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    B, S = CONSISTENCY
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(3))
    build.reset_launch_counts()
    fwd = rt.forward(cfg, model, {"tokens": tokens}, last_only=True)[0]
    n = build.launch_counts()["flash_attention"]
    t0 = time.perf_counter()
    cache = rt.init_cache(cfg, B, S)
    for t in range(S):
        dec, cache = rt.decode_step(cfg, model, tokens[:, t:t + 1], cache)
    torch.cuda.synchronize()
    e = rel_err(dec, fwd)
    same = bool((dec.argmax(-1) == fwd.argmax(-1)).all())
    check(e <= 1e-3 and same and n == cfg.num_layers,
          f"{MODEL_ARCH} f32 B={B} S={S}: prefill ({n} K11 launches) vs "
          f"decode replay ({time.perf_counter() - t0:.1f} s), last logits "
          f"rel L2 {e:.2e} (<= 1e-3), argmax equal {same}")
    del model, cache, fwd, dec
    gc.collect()
    torch.cuda.empty_cache()
    card_against_cpu(torch, rt, cfg.replace(num_layers=2), 256, 4,
                     f"{MODEL_ARCH} 2 layers")

    glm = rt.get_config("chatglm3-6b").replace(num_layers=2)
    check(glm.num_heads // glm.num_kv_heads == 16,
          "chatglm3-6b: GQA group 16")
    model = rt.init_params(glm, torch.Generator(device="cuda").manual_seed(5))
    tokens = torch.randint(0, glm.vocab_size, (2, 2048), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(7))
    build.reset_launch_counts()
    t0 = time.perf_counter()
    logits = rt.forward(glm, model, {"tokens": tokens}, last_only=True)[0]
    torch.cuda.synchronize()
    n = build.launch_counts()["flash_attention"]
    check(n == 2 and bool(logits.isfinite().all()),
          f"chatglm3-6b 2 layers bf16 prefill of 2x2048 "
          f"({time.perf_counter() - t0:.2f} s): {n} K11 launches at group "
          f"16, finite logits")
    bf16_against_f32(torch, rt, glm, model, tokens, logits,
                     "chatglm3-6b 2 layers 2x2048")
    del model, logits
    gc.collect()
    torch.cuda.empty_cache()
    card_against_cpu(torch, rt, glm.replace(dtype="float32"), 256, 6,
                     "chatglm3-6b 2 layers")


# ---------------------------------------------------------------------------
# the MoE decoders
# ---------------------------------------------------------------------------

def host_memory() -> dict:
    """MemTotal and MemAvailable of the host, in GiB (/proc/meminfo)."""
    out = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                key, val = line.split(":", 1)
                if key in ("MemTotal", "MemAvailable"):
                    out[key] = int(val.split()[0]) / 2 ** 20
    except OSError as exc:
        out["error"] = repr(exc)
    return out


class recorded_routes:
    """Within the block, every MoE layer of ``model`` keeps its routing
    (``MoE.routes``); after it, ``self.calls`` holds ``(x, router, C,
    routing)`` of each call, layer by layer in call order."""

    def __init__(self, model):
        self.moes = [layer.moe for layer in model.layers]

    def __enter__(self):
        for m in self.moes:
            m.routes = []
        return self

    def __exit__(self, *exc):
        self.calls = [(x, m.router, C, r) for m in self.moes
                      for x, C, r in m.routes]
        for m in self.moes:
            m.routes = None


def prefill_profile(torch, fn, names=MOE_RANGES) -> dict:
    """``fn()`` (one prefill) under the profiler with the ranges ``names``:
    the device time of each range, of K11 and in all, and the top device
    operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    names = set(names)
    # a range's device time: the kernels its host ops launched (the CPU
    # event's own total; the profiler also records a device-side span of
    # each range, idle gaps included, under the same name)
    ranges = dict.fromkeys(sorted(names), 0.0)
    for e in prof.events():
        if e.name in names and e.device_type == DeviceType.CPU:
            ranges[e.name] += e.device_time_total * 1e-6
    rows = []
    for e in prof.key_averages():
        if e.key in names:
            continue
        if e.device_type == DeviceType.CUDA:
            dev_us = getattr(e, "self_device_time_total", 0)
            if dev_us > 0:
                rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) * 1e-6
    k11 = sum(r[0] for r in rows if FLASH_KERNEL_NAMES.search(r[2])) * 1e-6
    shares = {k: (v / busy if busy else None) for k, v in ranges.items()}
    return dict(profiled_wall_s=wall, device_busy_s=busy,
                busy_share=busy / wall if wall else None, k11_s=k11,
                k11_share=k11 / busy if busy else None, ranges_s=ranges,
                range_shares=shares,
                other_share=(1 - sum(v for v in shares.values() if v)
                             if busy else None),
                top=[dict(name=k[:70], calls=c, device_s=t * 1e-6)
                     for t, c, k in rows[:12]])


def decoder_prefill(torch, rt, build, cfg, model, tokens, tag, reps,
                    attention_layers=None):
    """``reps`` timed prefills (``forward(last_only=True)``) after a
    warm-up, each with one K11 launch a layer (or an attention block:
    ``attention_layers`` of them); returns (logits, times, K11
    launches)."""
    if attention_layers is None:
        attention_layers = cfg.num_layers
    prefill = lambda: rt.forward(cfg, model, {"tokens": tokens},
                                 last_only=True)[0]
    logits = prefill()
    torch.cuda.synchronize()
    launches, times = 0, []
    for _ in range(reps):
        build.reset_launch_counts()
        t0 = time.perf_counter()
        logits = prefill()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        n = build.launch_counts()["flash_attention"]
        launches += n
        check(n == attention_layers,
              f"{tag} prefill: {n} K11 launches a forward (one an "
              f"attention block: {attention_layers})")
    B = tokens.shape[0]
    check(tuple(logits.shape) == (B, 1, cfg.padded_vocab)
          and logits.dtype == torch.float32
          and bool(logits.isfinite().all()),
          f"{tag} prefill logits {tuple(logits.shape)} {logits.dtype}, "
          f"finite")
    return logits, times, launches


def decoder_serve(torch, rt, build, cfg, model, label="moe") -> None:
    """``Engine.generate`` (MOE_SERVE) on the card: ms a step, no K11
    launch, greedy output repeated, a request alone as in the batch; a
    decode step's profile; ``ContinuousEngine`` with 6 requests on 4
    slots. Lines ``{label} decode ...``."""
    import numpy as np
    sv = MOE_SERVE
    rng = np.random.default_rng(2)
    reqs = [rt.Request(prompt=rng.integers(0, cfg.vocab_size,
                                           sv["prompt"]).tolist(),
                       max_new_tokens=sv["new"]) for _ in range(sv["batch"])]
    eng = rt.Engine(cfg, model, batch_size=sv["batch"], max_len=sv["max_len"])
    eng.generate([rt.Request(prompt=[1, 2], max_new_tokens=2)])   # warm-up
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = build.launch_counts()["flash_attention"]
    check(n == 0, f"{cfg.name} decode: {n} K11 launches (decode attention "
                  f"is plain)")
    steps = sv["prompt"] + outs[0].steps - 1
    new = sum(len(o.tokens) for o in outs)
    check(all(len(o.tokens) == sv["new"] for o in outs),
          f"{cfg.name} Engine: every request got {sv['new']} tokens")
    print(f"{label} decode " + json.dumps(dict(
        arch=cfg.name, layers=cfg.num_layers, batch=sv["batch"],
        prompt=sv["prompt"], new_tokens=sv["new"], max_len=sv["max_len"],
        generate_s=dt, decode_steps=steps,
        ms_per_decode_step=1e3 * dt / steps, new_tokens_per_s=new / dt,
        max_memory_allocated=torch.cuda.max_memory_allocated())), flush=True)
    cache = rt.init_cache(cfg, sv["batch"], sv["max_len"])
    toks = torch.from_numpy(np.array([r.prompt for r in reqs])).cuda()

    def decode(n=MOE_DECODE_PROFILED):
        nonlocal cache
        for t in range(n):
            _, cache = rt.decode_step(cfg, model, toks[:, t:t + 1], cache)
    decode()                                               # warm-up
    wall, rows = device_profile(torch, decode, host_ops=False)
    busy = sum(r[0] for r in rows) * 1e-6
    print(f"{label} decode profile " + json.dumps(dict(
        arch=cfg.name, steps=MOE_DECODE_PROFILED, profiled_wall_s=wall,
        device_busy_s=busy, busy_share=busy / wall if wall else None,
        device_ms_per_step=1e3 * busy / MOE_DECODE_PROFILED,
        launches_per_step=sum(r[1] for r in rows) / MOE_DECODE_PROFILED,
        top=[dict(name=k[:70], calls=c, device_s=t * 1e-6)
             for t, c, k in rows[:10]])), flush=True)
    del cache
    again = eng.generate(reqs)
    check([o.tokens for o in again] == [o.tokens for o in outs],
          f"{cfg.name} Engine: greedy output repeats on a second run")
    solo = eng.generate(reqs[:1])
    check(solo[0].tokens == outs[0].tokens,
          f"{cfg.name} Engine: a request alone equals the same request in "
          f"the batch")
    ce = rt.ContinuousEngine(cfg, model, batch_size=sv["batch"],
                             max_len=sv["max_len"])
    for _ in range(6):
        ce.submit(rt.Request(prompt=rng.integers(0, cfg.vocab_size,
                                                 16).tolist(),
                             max_new_tokens=8))
    build.reset_launch_counts()
    t0 = time.perf_counter()
    done = ce.run_until_done(max_ticks=200)
    torch.cuda.synchronize()
    check(sorted(done) == list(range(6))
          and all(len(c.tokens) == 8 for c in done.values())
          and build.launch_counts()["flash_attention"] == 0,
          f"{cfg.name} ContinuousEngine: 6 requests over {sv['batch']} "
          f"slots all finished in {ce.ticks} ticks "
          f"({time.perf_counter() - t0:.1f} s), no K11 launch")


def depth_prefix(torch, cfg, model, layers, label="moe",
                 what="serving (Engine, ContinuousEngine)"):
    """(config, model) of the first ``layers`` layers of ``model``, sharing
    its weights (nothing is copied; a hybrid keeps its shared blocks and
    the projections of the invocations left); the cut is printed."""
    from torch import nn
    from repro_torch.models import DecoderLM
    cut = cfg.replace(num_layers=layers)
    view = DecoderLM(cut, None, cfg.torch_dtype, torch.device("meta"))
    view.embed, view.final_norm = model.embed, model.final_norm
    view.layers = nn.ModuleList(model.layers[:layers])
    if cfg.arch_type == "hybrid":
        view.shared = model.shared
        view.shared_proj = nn.Parameter(
            model.shared_proj[:layers // cfg.shared_attn_period],
            requires_grad=False)
    print(f"{label} cut: {cfg.name} {what} on the first {layers} of its "
          f"{cfg.num_layers} layers, sharing the whole model's weights",
          flush=True)
    return cut, view


def moe_whole(torch, rt, build) -> int:
    """qwen3-moe-30b-a3b whole in bf16, weights from seed 0 on the card:
    the parameter counts, prefill of MOE_PREFILL tokens (its capacity and
    dispatch buffer, K11 launches, time, peak memory, the profile of where
    the time goes) and serving on its first MOE_SERVE_LAYERS layers.
    Returns K11's launches."""
    cfg = rt.get_config(MOE_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.head_dim, cfg.num_experts, cfg.top_k, cfg.d_ff,
           cfg.vocab_size, cfg.dtype)
          == (48, 2048, 32, 4, 128, 128, 8, 768, 151936, "bfloat16"),
          f"{MOE_ARCH} at its published width in bf16")
    check((cfg.param_count(), cfg.active_param_count()) == MOE_PARAMS,
          f"{MOE_ARCH}: {cfg.param_count():,} parameters, "
          f"{cfg.active_param_count():,} active a token")
    t0 = time.perf_counter()
    model = rt.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    routers = {p.dtype for n, p in model.named_parameters()
               if n.endswith("moe.router")}
    check(n_params == MOE_PARAMS[0] and routers == {torch.float32},
          f"{MOE_ARCH}: {n_params:,} parameters on the card, "
          f"{nbytes / 1e9:.2f} GB, the routers f32 "
          f"({time.perf_counter() - t0:.1f} s to draw)")
    from repro_torch.models import moe
    B, S = MOE_PREFILL
    C = moe.capacity(cfg, S)
    dispatch_bytes = B * cfg.num_experts * C * cfg.d_model * 2
    check(C == MOE_CAPACITY, f"{MOE_ARCH} at S = {S}: capacity {C} a "
                             f"expert and row, dispatch buffer "
                             f"{dispatch_bytes / 1e6:.1f} MB a layer")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    torch.cuda.reset_peak_memory_stats()
    logits, times, launches = decoder_prefill(torch, rt, build, cfg, model,
                                              tokens, MOE_ARCH, PREFILL_REPS)
    peak = torch.cuda.max_memory_allocated()
    with recorded_routes(model) as rec:          # one more, for the drops
        rt.forward(cfg, model, {"tokens": tokens}, last_only=True)
    dropped = [float(r.dropped.mean()) for *_, r in rec.calls]
    del rec
    t_draw_prefill = time.perf_counter() - t0
    prof = prefill_profile(torch, lambda: rt.forward(
        cfg, model, {"tokens": tokens}, last_only=True))
    t_profile = time.perf_counter() - t0 - t_draw_prefill
    med = statistics.median(times)
    print("moe prefill " + json.dumps(dict(
        arch=MOE_ARCH, batch=B, seq=S, dtype=cfg.dtype, params=n_params,
        param_bytes=nbytes, capacity=C, dispatch_bytes_per_layer=
        dispatch_bytes, dropped_frac_mean=statistics.mean(dropped),
        dropped_frac_max=max(dropped), forward_s=times,
        forward_s_median=med, tokens_per_s=B * S / med,
        max_memory_allocated=peak, **prof)), flush=True)
    del logits
    decoder_serve(torch, rt, build, *depth_prefix(torch, cfg, model,
                                                  MOE_SERVE_LAYERS))
    t = time.perf_counter() - t0
    print(f"moe {MOE_ARCH}: {t:.1f} s (draw and prefill "
          f"{t_draw_prefill:.1f}, profile {t_profile:.1f}, serving "
          f"{t - t_draw_prefill - t_profile:.1f})", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def moe_mixtral(torch, rt, build) -> int:
    """mixtral-8x7b at full width in bf16, cut to MIXTRAL_LAYERS layers
    (the whole model does not fit the card): prefill of MIXTRAL_PREFILL
    tokens, twice the window, so K11's window mask cuts. Returns K11's
    launches."""
    whole = rt.get_config(MIXTRAL)
    from repro_torch.models import moe
    check((whole.num_layers, whole.d_model, whole.num_heads,
           whole.num_kv_heads, whole.d_ff, whole.num_experts, whole.top_k,
           whole.attention, whole.window, whole.dtype)
          == (32, 4096, 32, 8, 14336, 8, 2, "sliding", 4096, "bfloat16"),
          f"{MIXTRAL} at its published width in bf16")
    cfg = whole.replace(num_layers=MIXTRAL_LAYERS)
    print(f"moe cut: {MIXTRAL} {whole.param_count():,} parameters "
          f"({2 * whole.param_count() / 1e9:.1f} GB in bf16) do not fit "
          f"the card's 80 GB; cut to {MIXTRAL_LAYERS} of "
          f"{whole.num_layers} layers ({cfg.param_count():,} parameters)",
          flush=True)
    model = rt.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    B, S = MIXTRAL_PREFILL
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(2))
    torch.cuda.reset_peak_memory_stats()
    logits, times, launches = decoder_prefill(
        torch, rt, build, cfg, model, tokens, f"{MIXTRAL} x{cfg.num_layers}",
        PREFILL_REPS)
    peak = torch.cuda.max_memory_allocated()
    full = rt.forward(cfg.replace(attention="full"), model,
                      {"tokens": tokens}, last_only=True)[0]
    moved = rel_err(full, logits)
    check(moved > 1e-3, f"{MIXTRAL}: the window acts (the same prefill "
                        f"without it moves the last logits by rel "
                        f"{moved:.2e})")
    med = statistics.median(times)
    print("moe prefill " + json.dumps(dict(
        arch=MIXTRAL, layers=cfg.num_layers, batch=B, seq=S,
        window=cfg.window, capacity=moe.capacity(cfg, S), forward_s=times,
        forward_s_median=med, tokens_per_s=B * S / med,
        max_memory_allocated=peak, window_moves_logits=moved)), flush=True)
    del model, logits, full
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def route_ties(torch, card, cpu, k) -> list:
    """(layer, row, token, gap) of each token whose k-th and (k+1)-th
    router probabilities lie within the f32 difference between the card's
    and the CPU's probabilities of that layer (four times its largest),
    where the two may route apart; ``card`` and ``cpu`` are the recorded
    routes of one forward each."""
    from repro_torch.models import moe
    ties = []
    for layer, ((xg, rg, _, _), (xc, rc, _, _)) in enumerate(zip(card, cpu)):
        pg = moe._router_probs(rg, xg).cpu()
        pc = moe._router_probs(rc, xc)
        slack = 4 * float((pg - pc).abs().max())
        top = torch.sort(pc, dim=-1, descending=True).values
        gap = top[..., k - 1] - top[..., k]
        for b, t in zip(*torch.nonzero(gap <= slack, as_tuple=True)):
            ties.append((layer, int(b), int(t), float(gap[b, t])))
    return ties


def moe_card_against_cpu(torch, rt, cfg, seq, seed, tag) -> None:
    """f32 ``forward`` on the card against the port on the CPU on the same
    weights: every layer's routing table equal, the logits within relative
    L2 1e-4. A token at a router tie (:func:`route_ties`) may route apart;
    each is named, and the rows it moves are held up to it only."""
    from repro_torch.models import DecoderLM
    model = rt.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed))
    on_cpu = DecoderLM(cfg, None, torch.float32, torch.device("cpu"))
    on_cpu.load_state_dict(model.state_dict())
    B, S = seq
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(seed))
    with recorded_routes(model) as on_card, recorded_routes(on_cpu) as here:
        got = rt.forward(cfg, model, {"tokens": tokens})[0].cpu()
        want = rt.forward(cfg, on_cpu, {"tokens": tokens})[0]
    card, cpu = on_card.calls, here.calls
    ties = route_ties(torch, card, cpu, cfg.top_k)
    tie_at = {(l, b, t) for l, b, t, _ in ties}
    apart, first = [], {}
    for layer, ((_, _, C, rg), (_, _, _, rc)) in enumerate(zip(card, cpu)):
        diff = (rg.sel.cpu() != rc.sel).any(-1)
        for b, t in zip(*torch.nonzero(diff, as_tuple=True)):
            b, t = int(b), int(t)
            apart.append((layer, b, t))
            first[b] = min(first.get(b, S), t)
        rows = [b for b in range(B) if b not in first]
        same = all(torch.equal(rg.buf_tok[b].cpu(), rc.buf_tok[b])
                   and torch.equal(rg.tok_slot[b].cpu(), rc.tok_slot[b])
                   for b in rows)
        check(same, f"{tag} layer {layer}: routing tables (buf_tok, "
                    f"tok_slot) equal card vs CPU in rows {rows}")
    check(all(a in tie_at for a in apart),
          f"{tag}: tokens routed apart {apart}, each at a router tie "
          f"{ties}")
    keep = torch.ones(B, S, dtype=torch.bool)
    for b, t in first.items():
        keep[b, t:] = False
    e = rel_err(got[keep], want[keep])
    check(e <= 1e-4, f"{tag}: card vs CPU forward of {B}x{S} tokens in f32, "
                     f"rel L2 {e:.2e} (<= 1e-4) over {int(keep.sum())} "
                     f"positions (ties: {ties or 'none'})")
    del model, on_cpu, on_card, here
    gc.collect()
    torch.cuda.empty_cache()


def moe_replay(torch, rt, build, cfg, seq, seed, tag) -> None:
    """f32 prefill (K11) against the teacher-forced ``decode_step`` replay
    at capacity factor 4.0, nothing dropped: last logits relative L2 <=
    1e-3, argmax equal."""
    cfg = cfg.replace(capacity_factor=4.0)
    model = rt.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed))
    B, S = seq
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(seed + 1))
    build.reset_launch_counts()
    with recorded_routes(model) as rec:
        fwd = rt.forward(cfg, model, {"tokens": tokens}, last_only=True)[0]
    n = build.launch_counts()["flash_attention"]
    dropped = max(float(r.dropped.max()) for *_, r in rec.calls)
    check(dropped == 0.0, f"{tag} at capacity factor 4.0 (C = "
                          f"{rec.calls[0][2]} for S = {S}): no token "
                          f"dropped ({dropped})")
    del rec
    t0 = time.perf_counter()
    cache = rt.init_cache(cfg, B, S)
    for t in range(S):
        dec, cache = rt.decode_step(cfg, model, tokens[:, t:t + 1], cache)
    torch.cuda.synchronize()
    e = rel_err(dec, fwd)
    same = bool((dec.argmax(-1) == fwd.argmax(-1)).all())
    check(e <= 1e-3 and same and n == cfg.num_layers,
          f"{tag} f32 B={B} S={S}: prefill ({n} K11 launches) vs decode "
          f"replay ({time.perf_counter() - t0:.1f} s), last logits rel L2 "
          f"{e:.2e} (<= 1e-3), argmax equal {same}")
    del model, cache, fwd, dec
    gc.collect()
    torch.cuda.empty_cache()


def moe_phase(torch, rt, build) -> int:
    """The MoE decoders on the card (after the olmo model is freed):
    qwen3-moe-30b-a3b whole in bf16 (:func:`moe_whole`), mixtral-8x7b at
    full width over MIXTRAL_LAYERS layers (:func:`moe_mixtral`), then in
    f32 with TF32 off a layer or two of each (MOE_F32; mixtral at window
    128) card against CPU (:func:`moe_card_against_cpu`) and prefill
    against the decode replay (:func:`moe_replay`). Returns K11's
    launches on its main path."""
    t0 = time.perf_counter()
    print("moe host memory " + json.dumps(host_memory()), flush=True)
    launches = moe_whole(torch, rt, build)
    t_whole = time.perf_counter() - t0
    launches += moe_mixtral(torch, rt, build)
    t_bf16 = time.perf_counter() - t0
    for arch, cut in MOE_F32.items():
        cfg = rt.get_config(arch).replace(dtype="float32", **cut)
        tag = f"{arch} " + " ".join(f"{k}={v}" for k, v in cut.items())
        moe_card_against_cpu(torch, rt, cfg, MOE_CONSISTENCY, 4, tag)
        moe_replay(torch, rt, build, cfg, MOE_REPLAY, 5, tag)
    t = time.perf_counter() - t0
    print(f"moe phase: {t:.1f} s (budget {MOE_BUDGET_S:.0f} s; "
          f"{MOE_ARCH} {t_whole:.1f}, {MIXTRAL} {t_bf16 - t_whole:.1f}, "
          f"f32 checks {t - t_bf16:.1f})", flush=True)
    return launches


# ---------------------------------------------------------------------------
# the SSM and hybrid decoders
# ---------------------------------------------------------------------------

def attention_blocks(cfg) -> int:
    """Attention blocks a forward runs: a hybrid's shared-block
    invocations, none in the SSM."""
    from repro_torch.models.model import shared_invocations
    return shared_invocations(cfg) if cfg.arch_type == "hybrid" else 0


def scan_ms(torch, cfg, model, tokens) -> float:
    """Device ms of one layer's scan at the prefill's shape (layer 0 on
    the normed embeddings, CUDA events): the plain-torch part of a Mamba
    layer that a fused selective-scan kernel would replace."""
    from repro_torch.models import mamba as mb
    from repro_torch.models.layers import apply_norm, embed_tokens
    lp = model.layers[0].mamba
    with torch.no_grad():
        x = apply_norm(cfg, model.layers[0].norm1,
                       embed_tokens(cfg, model.embed, tokens))
        A = -torch.exp(lp.A_log)
        if cfg.arch_type == "ssm":
            u, _, dt, Bc, Cc = mb._mamba1_inputs(cfg, lp, x)
            fn = lambda: mb._selective_scan(u, dt, A, Bc, Cc, cfg.ssm_chunk)
        else:
            u, _, dt, Bc, Cc = mb._mamba2_inputs(cfg, lp, x)
            fn = lambda: mb._ssd(cfg, u, dt, A, Bc, Cc, cfg.ssm_chunk)
        return time_ms(fn, reps=3)


def ssm_whole(torch, rt, build, arch) -> int:
    """``arch`` whole in bf16 from seed 0: published width and depth, the
    parameter count and the f32 leaves; prefill of SSM_PREFILL tokens
    (K11 launches, time, tokens/s, peak memory, the profile by range, one
    layer's scan timed alone) and serving on its first
    SSM_SERVE_LAYERS layers. Returns K11's launches."""
    t0 = time.perf_counter()
    width, n_want = SSM_WHOLE[arch]
    cfg = rt.get_config(arch)
    check((cfg.num_layers, cfg.d_model, cfg.d_inner, cfg.ssm_state,
           cfg.num_heads, cfg.head_dim, cfg.vocab_size, cfg.dtype)
          == width + ("bfloat16",),
          f"{arch} at its published width and depth in bf16")
    model = rt.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    f32 = sorted({n.split(".")[-1] for n, p in model.named_parameters()
                  if p.dtype == torch.float32})
    want_f32 = sorted(["A_log", "D"] + (["dt_bias"] if cfg.arch_type
                                        == "hybrid" else []))
    check(n_params == n_want == cfg.param_count() and f32 == want_f32,
          f"{arch}: {n_params:,} parameters on the card, "
          f"{nbytes / 1e9:.2f} GB, f32 leaves {f32} "
          f"({time.perf_counter() - t0:.1f} s to draw)")
    attn = attention_blocks(cfg)
    B, S = SSM_PREFILL
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    torch.cuda.reset_peak_memory_stats()
    logits, times, launches = decoder_prefill(torch, rt, build, cfg, model,
                                              tokens, arch, SSM_PREFILL_REPS,
                                              attention_layers=attn)
    peak = torch.cuda.max_memory_allocated()
    del logits
    t_prefill = time.perf_counter() - t0
    pcfg, pmodel = cfg, model
    if arch in SSM_PROFILE_LAYERS:
        pcfg, pmodel = depth_prefix(torch, cfg, model,
                                    SSM_PROFILE_LAYERS[arch], "ssm",
                                    "the prefill profile")
    prof = prefill_profile(torch, lambda: rt.forward(
        pcfg, pmodel, {"tokens": tokens}, last_only=True), SSM_RANGES)
    del pmodel
    one = scan_ms(torch, cfg, model, tokens)
    t_profile = time.perf_counter() - t0 - t_prefill
    med = statistics.median(times)
    check(prof["ranges_s"]["ssm.scan"] > 0
          and (prof["k11_s"] > 0) == (attn > 0),
          f"{arch} prefill profile: the ssm ranges found, K11's kernels "
          f"{'found' if attn else 'absent'}")
    print("ssm prefill " + json.dumps(dict(
        arch=arch, arch_type=cfg.arch_type, batch=B, seq=S, dtype=cfg.dtype,
        params=n_params, param_bytes=nbytes,
        k11_launches_per_forward=attn, forward_s=times,
        forward_s_median=med, tokens_per_s=B * S / med,
        max_memory_allocated=peak, scan_ms_one_layer=one,
        scan_share_of_forward=cfg.num_layers * one * 1e-3 / med,
        profiled_layers=pcfg.num_layers,
        ranges_over_busy=(sum(prof["ranges_s"].values())
                          / prof["device_busy_s"]
                          if prof["device_busy_s"] else None),
        **prof)), flush=True)
    decoder_serve(torch, rt, build, *depth_prefix(
        torch, cfg, model, SSM_SERVE_LAYERS[arch], "ssm"), "ssm")
    t = time.perf_counter() - t0
    print(f"ssm {arch}: {t:.1f} s (draw and prefill {t_prefill:.1f}, "
          f"profile and scan timing {t_profile:.1f}, serving "
          f"{t - t_prefill - t_profile:.1f})", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def ssm_replay(torch, rt, build, cfg, seq, seed, tag) -> None:
    """f32 prefill (K11 in a hybrid's shared blocks) against the
    teacher-forced ``decode_step`` replay: last logits relative L2 <=
    1e-3, argmax equal."""
    model = rt.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed))
    B, S = seq
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(seed + 1))
    build.reset_launch_counts()
    fwd = rt.forward(cfg, model, {"tokens": tokens}, last_only=True)[0]
    n = build.launch_counts()["flash_attention"]
    t0 = time.perf_counter()
    cache = rt.init_cache(cfg, B, S)
    for t in range(S):
        dec, cache = rt.decode_step(cfg, model, tokens[:, t:t + 1], cache)
    torch.cuda.synchronize()
    e = rel_err(dec, fwd)
    same = bool((dec.argmax(-1) == fwd.argmax(-1)).all())
    check(e <= 1e-3 and same and n == attention_blocks(cfg),
          f"{tag} f32 B={B} S={S}: prefill ({n} K11 launches) vs decode "
          f"replay ({time.perf_counter() - t0:.1f} s), last logits rel L2 "
          f"{e:.2e} (<= 1e-3), argmax equal {same}")
    del model, cache, fwd, dec
    gc.collect()
    torch.cuda.empty_cache()


def ssm_phase(torch, rt, build) -> int:
    """The SSM and hybrid decoders on the card (after the MoE models are
    freed): falcon-mamba-7b and zamba2-2.7b whole in bf16
    (:func:`ssm_whole`), then in f32 with TF32 off a few layers of each
    (SSM_F32) card against CPU, prefill against the decode replay
    (:func:`ssm_replay`), and the same layers in bf16 against f32.
    Returns K11's launches on its main path."""
    t0 = time.perf_counter()
    launches = sum(ssm_whole(torch, rt, build, arch) for arch in SSM_WHOLE)
    t_whole = time.perf_counter() - t0
    for arch, cut in SSM_F32.items():
        cfg = rt.get_config(arch).replace(dtype="float32", **cut)
        tag = f"{arch} " + " ".join(f"{k}={v}" for k, v in cut.items())
        B, S = SSM_CONSISTENCY
        card_against_cpu(torch, rt, cfg, S, 4, tag, batch=B)
        ssm_replay(torch, rt, build, cfg, SSM_REPLAY, 5, tag)
        bf16 = cfg.replace(dtype="bfloat16")
        model = rt.init_params(bf16, torch.Generator(device="cuda")
                               .manual_seed(6))
        tokens = torch.randint(0, cfg.vocab_size, SSM_REPLAY, device="cuda",
                               generator=torch.Generator(device="cuda")
                               .manual_seed(7))
        logits = rt.forward(bf16, model, {"tokens": tokens},
                            last_only=True)[0]
        bf16_against_f32(torch, rt, bf16, model, tokens, logits,
                         f"{tag} {SSM_REPLAY[0]}x{SSM_REPLAY[1]}")
        del model, logits
    t = time.perf_counter() - t0
    print(f"ssm phase: {t:.1f} s (budget {SSM_BUDGET_S:.0f} s; whole "
          f"models {t_whole:.1f}, f32 checks {t - t_whole:.1f})", flush=True)
    return launches


def report_row(name, t, launches, err) -> dict:
    """One kernel's entry of the ``{"kernels": [...]}`` line: the
    contract's keys, then the rest of its timing record."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "gbps",
            "bytes")
    return dict(
        name=name, route="cuda", source=SOURCE.format(name),
        replaces=REPLACES[name], launches=launches,
        max_abs_err=err["abs"], max_rel_err=err["rel"],
        ms=t["ms"], us_per_call=t["ms"] * 1e3, plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_us=t["bound_ms"] * 1e3,
        bound_by=t["bound_by"], library_ms=t["library_ms"],
        gbps=t["gbps"], bytes=t["bytes"],
        **{f"handoff_{k}": err[k] for k in ("flips", "end_to_end")
           if k in err},
        **{k: v for k, v in t.items() if k not in keys})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no repro_torch sources under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import repro_torch as rt
    from repro_torch.kernels import build, glm_hvp, ops, ref, sparse_hvp
    from repro_torch.kernels import flash_attention as flash

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
          f" x{torch.cuda.device_count()}", flush=True)
    t_start = time.perf_counter()
    phase_build(build)
    errs = {k.name: dict(rel=0.0, abs=0.0) for k in build.KERNELS}
    phase_kernels(torch, sparse_hvp, ref, errs)
    phase_dense_kernels(torch, glm_hvp, ref, errs)
    phase_multi_kernels(torch, sparse_hvp, glm_hvp, ref, errs)
    phase_ell_edges(torch, sparse_hvp, ref, errs)
    phase_hvp_edges(torch, sparse_hvp, ref, errs)
    phase_bf16_edges(torch, sparse_hvp, ref, errs)
    phase_fused_multi_kernel(torch, glm_hvp, ref, errs)
    phase_dense_bf16_kernels(torch, glm_hvp, ops, ref, errs)
    phase_multi_paths(torch, glm_hvp, ops, ref, errs)
    phase_dense_fused_bf16_kernels(torch, glm_hvp, ref, errs)
    bf16_errs = {"flash_attention": dict(rel=0.0, abs=0.0)}
    phase_flash_kernel(torch, flash, ref, errs, bf16_errs)
    time_gram_solve(torch)
    small_reference(torch, rt)
    small_checkpoint_reference(torch, rt)
    small_bf16_reference(torch, rt)
    small_bf16_dense_reference(torch, rt)
    small_comparisons(torch, rt)
    with tempfile.TemporaryDirectory() as tmp:
        keep = dict(dir=tmp)
        timings, launches = phase_slice(torch, rt, build, sparse_hvp, ref,
                                        errs, keep)
        dist_dense = dist_phase(torch, rt, keep, launches)
        t_sparse = time.perf_counter() - t_start
        serve_glm_phase(torch, rt, build, sparse_hvp, ref, keep, launches,
                        timings)
        dist_resume_phase(torch, rt, keep, launches)
        del keep
        gc.collect()
        torch.cuda.empty_cache()
    dense_timings, dense_launches = phase_dense(torch, rt, build, glm_hvp,
                                                ref, errs)
    timings.update(dense_timings)
    launches.update(dense_launches)
    for k, v in dist_dense.items():         # the dist phase's softmax ranks
        launches[k] += v
    figure3_phase(torch, rt, build)
    t_model = time.perf_counter()
    flash_rows = phase_flash_timing(torch, flash, ref, errs, bf16_errs)
    launches["flash_attention"] = phase_model(torch, rt, build)
    launches["flash_attention"] += moe_phase(torch, rt, build)
    launches["flash_attention"] += ssm_phase(torch, rt, build)
    phase_model_consistency(torch, rt, build)
    main_row = flash_rows["main_bf16"]
    timings["flash_attention"] = dict(
        main_row, gbps=main_row["bytes"] / main_row["ms"] / 1e6,
        max_rel_err_bf16=bf16_errs["flash_attention"]["rel"],
        max_abs_err_bf16=bf16_errs["flash_attention"]["abs"],
        **{f"{k}_ms": r["ms"] for k, r in flash_rows.items()
           if k != "main_bf16"},
        **{f"zamba2_bf16_head_major_{k}": flash_rows[
            "zamba2_bf16_head_major"][k] for k in ("bound_ms",
                                                   "library_ms")})
    t_model = time.perf_counter() - t_model

    kernels = []
    for k in build.KERNELS:
        name, t = k.name, timings[k.name]
        kernels.append(report_row(name, t, launches[name], errs[name]))
        check(launches[name] > 0, f"{name} launched on the main path "
                                  f"({launches[name]} launches)")
        check(errs[name]["rel"] <= REL_TOL_KERNEL,
              f"{name} max rel err {errs[name]['rel']:.2e}")
    print(f"total {time.perf_counter() - t_start:.1f} s (sparse slice and "
          f"before {t_sparse:.1f} s, K11 timing and the model slice "
          f"{t_model:.1f} s)", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    if FAILURES:
        print("chip_smoke FAILED:\n  " + "\n  ".join(FAILURES),
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
