#!/usr/bin/env python3
"""Time text-edited variants of ``csrc/dense_multi.cuh`` for the bf16
instances of K8 ``xt_multi`` and K9 ``x_cz_multi`` at the dense slice's
full width (d = 4,096, n = 262,144, bf16 X) on one card, beside the
build in the checkout and the f32 kernels, each variant held to the plain
version (relative L2 <= 1e-5; names starting ``abl`` are timed even when
wrong).

Usage, from the repository root on a machine with one Hopper card:

    python3 chip_multi_variants.py ['name@KERNEL@@old text@@new text' ...]

KERNEL is ``xt_multi_bf16`` or ``x_cz_multi_bf16``; several edits of one
variant join with ``@@@``. Without arguments it times the built-in set:
the kernels with all kMaxCols sums held (the f32 kernels' one instance
for any s), K8 with 8 rows in flight, and K9 with 4 rows a CTA. Each
variant is compiled by its own ``nvcc`` from a copy of ``csrc/`` under
``build/multi_variants/`` (all at once), loaded with ctypes and called
with the arguments the wrappers in ``kernels/glm_hvp.py`` pass, at s = 1,
5 and 8 (median of 20 calls between CUDA events, after warm-up). Prints
one line a kernel, variant and s, the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
D, N = 4096, 262_144
S_VALUES = (1, 5, 8)
HELD_ALL = ("  if constexpr (sizeof(T) == 4) {\n    return f(std::integral_constant<int, 0>{});",
            "  if constexpr (true) {\n    return f(std::integral_constant<int, 0>{});")
BUILTIN = {
    "held_all": ("xt_multi_bf16", [HELD_ALL]),
    "held_all_k9": ("x_cz_multi_bf16", [HELD_ALL]),
    "unroll8": ("xt_multi_bf16", [("#pragma unroll 4\n        for (int rr",
                                   "#pragma unroll 8\n        for (int rr")]),
    "rows4": ("x_cz_multi_bf16", [("constexpr int ROWS = 8;",
                                   "constexpr int ROWS = 4;")]),
}


def parse(args) -> dict:
    out = {}
    for arg in args:
        head, *edits = arg.split("@@@")
        name_kernel, old, new = head.split("@@")
        name, kernel = name_kernel.split("@")
        pairs = [(old, new)] + [tuple(e.split("@@")) for e in edits]
        out[name] = (kernel, pairs)
    return out


def time_ms(torch, fn, reps=20) -> float:
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_multi_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, glm_hvp, ref
    variants = parse(sys.argv[1:]) or BUILTIN
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    build.build_kernels()
    work = ROOT / "build" / "multi_variants"
    jobs = {}
    for name, (kernel, edits) in variants.items():
        src = work / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(build.CSRC, src)
        text = (src / "dense_multi.cuh").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the edit {old!r} matches "
                                 f"{text.count(old)} times")
            text = text.replace(old, new)
        (src / "dense_multi.cuh").write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(src), "-o",
               str(src / f"{kernel}.so"), str(src / f"{kernel}.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate(timeout=build.BUILD_TIMEOUT_S)
        kernel = variants[name][0]
        if proc.returncode != 0:
            print(f"{name}: nvcc failed\n{log[-2000:]}", flush=True)
            continue
        fn = getattr(ctypes.CDLL(str(work / name / f"{kernel}.so")),
                     f"{kernel}_launch")
        base = build.XT_MULTI if kernel.startswith("xt") else build.X_CZ_MULTI
        fn.argtypes, fn.restype = base.argtypes, ctypes.c_int
        fns[name] = (kernel, fn)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn((D, N), generator=g, device=dev) / D ** 0.5
    Xh = X.to(torch.bfloat16)
    c = torch.rand(N, generator=g, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rel = lambda a, b: float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
    slices = glm_hvp.xt_u_slices(D, N, glm_hvp._sm_count(0))
    for s in S_VALUES:
        U = torch.randn((D, s + 1), generator=g, device=dev)[:, :s]
        Z = torch.randn((N, s), generator=g, device=dev)
        want = {"xt_multi_bf16": ref.ref_xt_multi(Xh, U),
                "x_cz_multi_bf16": ref.ref_x_cz_multi(Xh, c, Z)}
        built = {"xt_multi_bf16": lambda: glm_hvp.xt_multi(Xh, U),
                 "x_cz_multi_bf16": lambda: glm_hvp.x_cz_multi(Xh, c, Z),
                 "xt_multi (f32)": lambda: glm_hvp.xt_multi(X, U),
                 "x_cz_multi (f32)": lambda: glm_hvp.x_cz_multi(X, c, Z)}
        for name, fn in built.items():
            err = rel(fn(), want[name]) if name in want else float("nan")
            print(f"s={s} built {name}: {time_ms(torch, fn) * 1e3:.1f} us, "
                  f"rel err {err:.2e}", flush=True)
        for name, (kernel, fn) in fns.items():
            if kernel == "xt_multi_bf16":
                out = torch.empty((N, s), device=dev)
                part = torch.empty((slices, N, s), device=dev)
                call = lambda: fn(Xh.data_ptr(), Xh.stride(0), U.data_ptr(),
                                  U.stride(0), out.data_ptr(),
                                  part.data_ptr(), D, N, s, slices,
                                  glm_hvp.THREADS, stream)
            else:
                out = torch.empty((D, s), device=dev)
                call = lambda: fn(Xh.data_ptr(), Xh.stride(0), c.data_ptr(),
                                  Z.data_ptr(), Z.stride(0), out.data_ptr(),
                                  D, N, s, glm_hvp.THREADS, stream)
            if call() != 0:
                print(f"s={s} {name}: launch failed", flush=True)
                continue
            torch.cuda.synchronize()
            err = rel(out, want[kernel])
            if err > 1e-5 and not name.startswith("abl"):
                print(f"s={s} {name} ({kernel}): wrong, rel err {err:.2e}",
                      flush=True)
                continue
            print(f"s={s} {name} ({kernel}): {time_ms(torch, call) * 1e3:.1f}"
                  f" us, rel err {err:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
