#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Usage, from the repository root on a machine with one Hopper card:

    python3 chip_smoke.py

Five phases; any failed check makes the exit code nonzero.

1. Build: compiles the five hand-written CUDA kernels from
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` (one process per source,
   all at once) and prints the card's name and power limit.
2. Kernels: holds each kernel against its plain PyTorch version on the
   card (relative L2 error <= 1e-5 in f32): ``ell_mv`` and ``ell_hvp`` at
   8x8, 16x16 and 128x128 tiles on layouts with padding slots; ``xt_u``,
   ``x_cz`` and ``x_c_xt_u`` at ragged dense shapes and every panel width;
   each with and without the scale ``c``. Then a small sparse and a small
   dense solve on the card against the same solves on the CPU.
3. Sparse slice: ``disco_fit`` at the shape of LIBSVM rcv1.binary's
   training split (d = 47,236 features, n = 20,242 samples, about 1.5 M
   nonzeros, synthetic power-law data from a seed): DiSCO-S and DiSCO-F
   at m = 1 and m = 4 shards, two-pass, plus the fused HVP for both at
   m = 1. On the first run's layouts ``ell_mv`` and ``ell_hvp`` are timed
   beside their plain versions and PyTorch's block-sparse (BSR) product,
   and a full-width gradient and HVP are held against the plain versions;
   a second fit of the first run is profiled.
4. Dense slice: ``disco_fit(use_kernel=True)`` at d = 4,096, n = 262,144
   f32 (X is 4 GiB: the per-card shard of the repository's pod-scale dense
   problem, the full sample axis), data made on the card by the
   ``make_glm_data`` recipe from a seed; the same six runs. At full width
   ``xt_u``, ``x_cz`` and ``x_c_xt_u`` are held against their plain
   versions and timed beside them and beside ``torch.mv``; a second fit
   of the first run is profiled. Every Newton step must decrease f, and
   m = 4 and fused runs must end at the m = 1 two-pass ``w``.
5. Report: the kernels' JSON line.

Each slice zeroes the kernels' launch counts just before each fit and
reads them just after; every kernel of the slice must have run. The line
before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of the JAX
package ``repro``.
"""
from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
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

SOURCE = "src/repro_torch/kernels/csrc/{}.cu"
REPLACES = {"ell_mv": "src/repro/kernels/sparse_hvp.py:82",
            "ell_hvp": "src/repro/kernels/sparse_hvp.py:204",
            "xt_u": "src/repro/kernels/glm_hvp.py:81",
            "x_cz": "src/repro/kernels/glm_hvp.py:124",
            "x_c_xt_u": "src/repro/kernels/glm_hvp.py:258"}
SPARSE_KERNELS = ("ell_mv", "ell_hvp")
DENSE_KERNELS = ("xt_u", "x_cz", "x_c_xt_u")

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

def phase_build(build) -> None:
    t0 = time.perf_counter()
    reports = build.build_kernels()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(reports) or 'cached'})", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
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


def phase_dense_kernels(torch, glm_hvp, ref, errs) -> None:
    """The dense kernels at ragged shapes (scalar and 16-byte loads, a d
    past the widest panel), with and without c, every panel width of
    x_c_xt_u, and a column-slice view as a DiSCO-S shard passes it."""
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
        for bn in glm_hvp.PANEL_WIDTHS:
            if glm_hvp.fused_smem_bytes(d, bn) > glm_hvp.SMEM_LIMIT:
                continue
            got = glm_hvp.x_c_xt_u(X, c, u, _block_n=bn)
            again = glm_hvp.x_c_xt_u(X, c, u, _block_n=bn)
            e = record_err(errs, "x_c_xt_u", got, want)
            check(e <= REL_TOL_KERNEL and bool(torch.equal(got, again)),
                  f"x_c_xt_u {d}x{n} panel {bn}: rel err {e:.2e}, "
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


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def measure_kernels(torch, solver, sparse_hvp, ref, errs) -> dict:
    """Full-width timings and checks on the first run's layouts
    (DiSCO-S, m = 1)."""
    dev = solver.device
    data, cols = solver.ell_data[0], solver.ell_cols[0]
    dataT, colsT = solver.ell_dataT[0], solver.ell_colsT[0]
    nrb, W, br, bc = data.shape
    ncb, WT = dataT.shape[:2]
    g = torch.Generator(device=dev).manual_seed(1)
    # first-step quantities: w = 0, so phi'' = 1/4 and phi' = -y/2
    wts, yv = solver.weights[0], solver.y[0]
    c = 0.25 * wts
    d1 = -0.5 * yv * wts
    u = torch.randn(nrb * br, generator=g, device=dev)

    grad_k = sparse_hvp.ell_mv(data, cols, d1)
    grad_p = ref.ref_ell_mv(data, cols, d1)
    hvp2_k = sparse_hvp.ell_mv(data, cols,
                               sparse_hvp.ell_mv(dataT, colsT, u), c)
    hvp2_p = ref.ref_ell_mv(data, cols, ref.ref_ell_mv(dataT, colsT, u), c)
    hvpf_k = sparse_hvp.ell_hvp(dataT, colsT, u, c)
    hvpf_p = ref.ref_ell_hvp_t(dataT, colsT, u, c)
    torch.cuda.synchronize()
    for name, kname, got, want in (
            ("full-width gradient", "ell_mv", grad_k, grad_p),
            ("full-width two-pass HVP", "ell_mv", hvp2_k, hvp2_p),
            ("full-width fused HVP", "ell_hvp", hvpf_k, hvpf_p)):
        e = record_err(errs, kname, got, want)
        check(e <= REL_TOL_KERNEL, f"{name}: rel err {e:.2e}")
    del grad_p, hvp2_p, hvpf_p

    tiles_f, tiles_t = nonempty_tiles(data), nonempty_tiles(dataT)
    v = torch.randn(ncb * bc, generator=g, device=dev)
    out = {}
    # ell_mv on the forward layout without c: the gradient product X d1,
    # the shape the block-sparse library call computes too
    ms = time_ms(lambda: sparse_hvp.ell_mv(data, cols, v))
    ms_t = time_ms(lambda: sparse_hvp.ell_mv(dataT, colsT, u))
    ms_c = time_ms(lambda: sparse_hvp.ell_mv(data, cols, v, c))
    plain = time_ms(lambda: ref.ref_ell_mv(data, cols, v))
    layout_bytes = data.numel() * 4 + cols.numel() * 4 + v.numel() * 4 \
        + nrb * br * 4
    bms, by = bound_ms(tiles_f, br * bc, cols.numel() * 4 + v.numel() * 4
                       + nrb * br * 4, 2)
    lib = library_bsr_ms(torch, data, cols, v)
    out["ell_mv"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        bytes=layout_bytes, gbps=layout_bytes / ms / 1e6,
        ms_transposed=ms_t, ms_forward_with_c=ms_c,
        tiles_nonempty=tiles_f, tiles_stored=nrb * W,
        shape=[nrb, W, br, bc])
    # ell_hvp on the transposed layout with c: the fused HVP
    ms = time_ms(lambda: sparse_hvp.ell_hvp(dataT, colsT, u, c))
    plain = time_ms(lambda: ref.ref_ell_hvp_t(dataT, colsT, u, c))
    two_pass = time_ms(lambda: sparse_hvp.ell_mv(
        data, cols, sparse_hvp.ell_mv(dataT, colsT, u), c))
    read_bytes = 2 * dataT.numel() * 4 + 2 * colsT.numel() * 4 \
        + u.numel() * 4 + c.numel() * 4 + nrb * br * 4
    bms, by = bound_ms(tiles_t, br * bc, colsT.numel() * 4 + u.numel() * 4
                       + c.numel() * 4 + nrb * br * 4, 4)
    out["ell_hvp"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
        bytes=read_bytes, gbps=read_bytes / ms / 1e6,
        two_pass_ell_mv_ms=two_pass, tiles_nonempty=tiles_t,
        tiles_stored=ncb * WT, shape=[ncb, WT, bc, br])
    for name, m in out.items():
        print(f"{name} full width {m['shape']}: {m['ms'] * 1e3:.1f} us/call,"
              f" {m['gbps']:.0f} GB/s over {m['bytes'] / 1e9:.2f} GB read,"
              f" bound {m['bound_ms'] * 1e3:.1f} us ({m['bound_by']}),"
              f" plain {m['plain_ms'] * 1e3:.1f} us,"
              f" library {m['library_ms']}", flush=True)
    return out


def library_bsr_ms(torch, data, cols, v):
    """Time of PyTorch's block-sparse (BSR) matrix product for the same
    A v, from the layout's nonempty tiles; None if the card's PyTorch
    cannot run it. A yardstick only: the port never calls it."""
    nrb, W, br, bc = data.shape
    keep = (data.reshape(nrb, W, -1) != 0).any(dim=2)
    counts = keep.sum(dim=1)
    crow = torch.zeros(nrb + 1, dtype=torch.int64, device=data.device)
    crow[1:] = torch.cumsum(counts, 0)
    try:
        bsr = torch.sparse_bsr_tensor(
            crow, cols[keep].to(torch.int64), data[keep],
            size=(nrb * br, v.numel()))
        vv = v.unsqueeze(1)
        got = (bsr @ vv).squeeze(1)
        want = torch.einsum("iwab,iwb->ia", data,
                            v.reshape(-1, bc)[cols.long()]).reshape(-1)
        if rel_err(got, want) > 1e-4:
            print("library BSR product disagrees; not timed")
            return None
        return time_ms(lambda: bsr @ vv)
    except (RuntimeError, NotImplementedError) as exc:
        print(f"library BSR product unavailable: {exc}")
        return None


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


def phase_slice(torch, rt, build, sparse_hvp, ref, errs):
    from repro_torch.data.sparse import make_sparse_glm_data
    t0 = time.perf_counter()
    X, y, _ = make_sparse_glm_data(**SLICE)
    print(f"data: d={X.shape[0]} n={X.shape[1]} nnz={X.nnz} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    launches = dict.fromkeys(SPARSE_KERNELS, 0)
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
            torch.cuda.reset_peak_memory_stats()
        res, counts = fit_counted(torch, build, solver)
        for k in SPARSE_KERNELS:
            launches[k] += counts[k]
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
        results[(partition, m, fused)] = res.w
        if (partition, m, fused) == RUNS[0]:
            try:
                profile_fit(torch, solver)
            except RuntimeError as exc:   # a measurement only, not a check
                print(f"profile unavailable: {exc}", flush=True)
        del solver, res
        gc.collect()
        torch.cuda.empty_cache()

    e = rel_w(results[("samples", 4, False)], results[("samples", 1, False)])
    check(e <= 1e-3, f"DiSCO-S m=4 vs m=1: rel diff of w {e:.2e}")
    for p in ("samples", "features"):
        e = rel_w(results[(p, 1, True)], results[(p, 1, False)])
        check(e <= 1e-4, f"{p} fused vs two-pass: rel diff of w {e:.2e}")
    return timings, launches


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def make_dense_data(torch, dev, d, n, cond_decay, seed):
    """``make_glm_data``'s recipe, made on the card from a seeded
    generator (on the host the (d, d) @ (d, n) product alone is about
    9 TFLOP): feature covariance with singular values k^-cond_decay,
    unit-norm columns, +-1 labels from a logistic model of a random
    w_true. Returns X (d, n) f32 and y (n,) on the card."""
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
    p = torch.sigmoid(margins / torch.clamp(margins.std(), min=1e-9))
    y = torch.where(torch.rand(n, generator=g, device=dev) < p, 1.0, -1.0)
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
    for name in DENSE_KERNELS:
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
    fused["panel_ms"] = {
        bn: time_ms(lambda: glm_hvp.x_c_xt_u(X, c, u, _block_n=bn))
        for bn in glm_hvp.PANEL_WIDTHS
        if glm_hvp.fused_smem_bytes(d, bn) <= glm_hvp.SMEM_LIMIT}
    fused["panel"] = glm_hvp.fused_panel_width(d)
    fused["two_pass_kernels_ms"] = time_ms(
        lambda: glm_hvp.x_cz(X, c, glm_hvp.xt_u(X, u)))
    out["xt_u"]["slices"] = glm_hvp.xt_u_slices(
        d, n, torch.cuda.get_device_properties(X.device).multi_processor_count)
    for name in DENSE_KERNELS:
        m = out[name]
        print(f"{name} full width {m['shape']}: {m['ms'] * 1e3:.1f} us/call,"
              f" {m['gbps']:.0f} GB/s over {m['bytes'] / 1e9:.2f} GB,"
              f" bound {m['bound_ms'] * 1e3:.1f} us ({m['bound_by']}),"
              f" plain {m['plain_ms'] * 1e3:.1f} us,"
              f" library {m['library_ms']}", flush=True)
    print("x_c_xt_u detail " + json.dumps(
        {k: fused[k] for k in ("panel", "panel_ms", "two_pass_kernels_ms",
                               "library_pair_ms")}), flush=True)
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
    X, y = make_dense_data(torch, dev, **DENSE)
    torch.cuda.synchronize()
    print(f"dense data on the card: d={X.shape[0]} n={X.shape[1]} "
          f"({X.numel() * 4 / 2**30:.2f} GiB, "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    timings = measure_dense_kernels(torch, X, glm_hvp, ref, errs)
    launches = dict.fromkeys(DENSE_KERNELS, 0)
    results = {}
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
        if (partition, m, fused) == RUNS[0]:
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
    del X, y
    gc.collect()
    torch.cuda.empty_cache()
    return timings, launches


def profile_fit(torch, solver) -> None:
    """Where the time of one whole solve goes: a second ``fit()`` under
    ``torch.profiler``; device busy time is the sum of the device-side
    events (kernels, copies, fills: one stream, so they do not overlap),
    not of the host ops that launched them. The profiler's own host cost
    makes the idle share an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.fit()
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
    busy = sum(r[0] for r in rows) * 1e-6
    print("profile " + json.dumps(dict(
        wall_s=wall, device_busy_s=busy,
        busy_share=busy / wall if wall > 0 else None,
        top=[dict(name=k[:60], calls=c, device_s=t * 1e-6)
             for t, c, k in rows[:8]])), flush=True)


def same_solve(tag, on_card, on_cpu) -> None:
    """The card's solve equals the CPU's: w within rtol 1e-4 / atol 1e-6
    and the same PCG iterations per step."""
    import numpy as np
    close = bool(np.allclose(on_card.w, on_cpu.w, rtol=1e-4, atol=1e-6))
    same_iters = [h["pcg_iters"] for h in on_card.history] == \
        [h["pcg_iters"] for h in on_cpu.history]
    e = float(np.max(np.abs(on_card.w - on_cpu.w)))
    check(close and same_iters,
          f"{tag} on the card vs the CPU: w within rtol 1e-4 / atol "
          f"1e-6 {close} (max abs diff {e:.2e}), same PCG iterations "
          f"{same_iters}")


def small_reference(torch, rt) -> None:
    """Small solves on the card against the same solves on the CPU (the
    plain versions, which the repository's tests hold to the JAX
    package): sparse DiSCO-S, and dense DiSCO-S at m = 4 two-pass and
    DiSCO-F at m = 1 fused."""
    X, y, _ = rt.make_sparse_glm_data(d=96, n=200, density=0.2, alpha=0.8,
                                      beta=0.5, seed=1)
    cfg = rt.DiscoConfig(loss="logistic", lam=1e-3, tau=100, max_outer=4,
                         grad_tol=0.0, ell_block_d=16, ell_block_n=16,
                         partition="samples")
    same_solve("small sparse solve", rt.disco_fit(X, y, cfg, device="cuda"),
               rt.disco_fit(X, y, cfg, device="cpu"))
    X, y, _ = rt.make_glm_data(d=98, n=202, seed=1)
    for partition, m, fused in (("samples", 4, False),
                                ("features", 1, True)):
        cfg = rt.DiscoConfig(loss="logistic", lam=1e-3, tau=100,
                             max_outer=4, grad_tol=0.0, use_kernel=True,
                             partition=partition, hvp_fused=fused)
        group = rt.InProcessGroup(m)
        same_solve(f"small dense {run_tag(partition, m, fused)}",
                   rt.disco_fit(X, y, cfg, group=group, device="cuda"),
                   rt.disco_fit(X, y, cfg, group=group, device="cpu"))


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
    from repro_torch.kernels import build, glm_hvp, ref, sparse_hvp

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
    small_reference(torch, rt)
    timings, launches = phase_slice(torch, rt, build, sparse_hvp, ref, errs)
    t_sparse = time.perf_counter() - t_start
    dense_timings, dense_launches = phase_dense(torch, rt, build, glm_hvp,
                                                ref, errs)
    timings.update(dense_timings)
    launches.update(dense_launches)

    kernels = []
    for k in build.KERNELS:
        name, t = k.name, timings[k.name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE.format(name),
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=errs[name]["abs"], max_rel_err=errs[name]["rel"],
            ms=t["ms"], us_per_call=t["ms"] * 1e3, plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_us=t["bound_ms"] * 1e3,
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            gbps=t["gbps"], bytes=t["bytes"],
            **{k: v for k, v in t.items() if k not in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "gbps", "bytes")}))
        check(launches[name] > 0, f"{name} launched on the main path "
                                  f"({launches[name]} launches)")
        check(errs[name]["rel"] <= REL_TOL_KERNEL,
              f"{name} max rel err {errs[name]['rel']:.2e}")
    print(f"total {time.perf_counter() - t_start:.1f} s (sparse slice and "
          f"before {t_sparse:.1f} s)", flush=True)
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
