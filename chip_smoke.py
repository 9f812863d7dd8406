#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Usage, from the repository root on a machine with one Hopper card:

    python3 chip_smoke.py

Three phases; any failed check makes the exit code nonzero.

1. Build: compiles the hand-written CUDA kernels from ``src/repro_torch/
   kernels/csrc`` with ``nvcc`` (one process per source, all at once) and
   prints the card's name and power limit.
2. Kernels: holds ``ell_mv`` and ``ell_hvp`` against their plain PyTorch
   versions on the card, at 8x8, 16x16 and 128x128 tiles, with and without
   the scale ``c``, on layouts with padding slots (relative L2 error
   <= 1e-5 in f32).
3. Slice: ``disco_fit`` on the card at the shape of LIBSVM rcv1.binary's
   training split (d = 47,236 features, n = 20,242 samples, about 1.5 M
   nonzeros, synthetic power-law data from a seed): DiSCO-S and DiSCO-F at
   m = 1 and m = 4 shards, two-pass, plus the fused HVP for both at m = 1.
   The kernels' launch counts are zeroed just before each fit and read just
   after, and every kernel must have run. On the first run's layouts the
   kernels are timed (CUDA events, median of 20 calls) beside their plain
   versions and, for ``ell_mv``, beside PyTorch's block-sparse (BSR)
   product, and one full-width gradient and HVP are held against the plain
   versions.

The line before the last is ``{"kernels": [...]}``; the last line is
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
REL_TOL_KERNEL = 1e-5
REPS = 20

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
    CUDA events, after warm-up."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_build(sparse_hvp) -> None:
    t0 = time.perf_counter()
    reports = sparse_hvp.build_kernels()
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
                e = rel_err(got, want)
                errs[name]["rel"] = max(errs[name]["rel"], e)
                errs[name]["abs"] = max(errs[name]["abs"],
                                        float((got - want).abs().max()))
                check(e <= REL_TOL_KERNEL,
                      f"{name} {layout} {block}x{block} c={with_c}: "
                      f"rel err {e:.2e}")
        rng_seed += 1


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
        e = rel_err(got, want)
        errs[kname]["rel"] = max(errs[kname]["rel"], e)
        errs[kname]["abs"] = max(errs[kname]["abs"],
                                 float((got - want).abs().max()))
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


def phase_slice(torch, rt, sparse_hvp, ref, errs):
    from repro_torch.data.sparse import make_sparse_glm_data
    t0 = time.perf_counter()
    X, y, _ = make_sparse_glm_data(**SLICE)
    print(f"data: d={X.shape[0]} n={X.shape[1]} nnz={X.nnz} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    launches = {k.name: 0 for k in sparse_hvp.KERNELS}
    timings, results = None, {}
    for partition, m, fused in RUNS:
        tag = f"{'DiSCO-S' if partition == 'samples' else 'DiSCO-F'} " \
              f"m={m} {'fused' if fused else 'two-pass'}"
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
        sparse_hvp.reset_launch_counts()
        res = solver.fit()
        torch.cuda.synchronize()
        counts = sparse_hvp.launch_counts()
        for k, n_launch in counts.items():
            launches[k] += n_launch
        hist = res.history
        g0, g1 = hist[0]["grad_norm"], hist[-1]["grad_norm"]
        pcg = [int(h["pcg_iters"]) for h in hist]
        row = dict(
            run=tag, newton_iters=len(hist), pcg_iters=pcg,
            grad_norm_first=g0, grad_norm_last=g1,
            iter_s_median=statistics.median(h["iter_s"] for h in hist),
            setup_s=setup_s, ledger_rounds=res.ledger.rounds,
            imbalance=res.partition_info["imbalance"],
            ell_bytes=ell_bytes,
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            launches=counts, ell_widths=[int(solver.ell_data.shape[2]),
                                         int(solver.ell_dataT.shape[2])])
        print("run " + json.dumps(row), flush=True)
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

    def rel(a, b):
        import numpy as np
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))
    e = rel(results[("samples", 4, False)], results[("samples", 1, False)])
    check(e <= 1e-3, f"DiSCO-S m=4 vs m=1: rel diff of w {e:.2e}")
    for p in ("samples", "features"):
        e = rel(results[(p, 1, True)], results[(p, 1, False)])
        check(e <= 1e-4, f"{p} fused vs two-pass: rel diff of w {e:.2e}")
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


def small_reference(torch, rt) -> None:
    """A small solve on the card against the same solve on the CPU (the
    plain versions, which the repository's tests hold to the JAX
    package)."""
    X, y, _ = rt.make_sparse_glm_data(d=96, n=200, density=0.2, alpha=0.8,
                                      beta=0.5, seed=1)
    cfg = rt.DiscoConfig(loss="logistic", lam=1e-3, tau=100, max_outer=4,
                         grad_tol=0.0, ell_block_d=16, ell_block_n=16,
                         partition="samples")
    on_card = rt.disco_fit(X, y, cfg, device="cuda")
    on_cpu = rt.disco_fit(X, y, cfg, device="cpu")
    import numpy as np
    close = bool(np.allclose(on_card.w, on_cpu.w, rtol=1e-4, atol=1e-6))
    same_iters = [h["pcg_iters"] for h in on_card.history] == \
        [h["pcg_iters"] for h in on_cpu.history]
    e = float(np.max(np.abs(on_card.w - on_cpu.w)))
    check(close and same_iters,
          f"small solve on the card vs the CPU: w within rtol 1e-4 / atol "
          f"1e-6 {close} (max abs diff {e:.2e}), same PCG iterations "
          f"{same_iters}")


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
    from repro_torch.kernels import ref, sparse_hvp

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
          f" x{torch.cuda.device_count()}", flush=True)
    t_start = time.perf_counter()
    phase_build(sparse_hvp)
    errs = {k.name: dict(rel=0.0, abs=0.0) for k in sparse_hvp.KERNELS}
    phase_kernels(torch, sparse_hvp, ref, errs)
    small_reference(torch, rt)
    timings, launches = phase_slice(torch, rt, sparse_hvp, ref, errs)

    source = {"ell_mv": "src/repro_torch/kernels/csrc/ell_mv.cu",
              "ell_hvp": "src/repro_torch/kernels/csrc/ell_hvp.cu"}
    replaces = {"ell_mv": "src/repro/kernels/sparse_hvp.py:82",
                "ell_hvp": "src/repro/kernels/sparse_hvp.py:204"}
    kernels = []
    for name in ("ell_mv", "ell_hvp"):
        t = timings[name]
        kernels.append(dict(
            name=name, route="cuda", source=source[name],
            replaces=replaces[name], launches=launches[name],
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
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
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
