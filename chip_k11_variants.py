#!/usr/bin/env python3
"""Variants of the flash-attention kernel (K11) against each other on one
NVIDIA card, each also against ``scaled_dot_product_attention``.

Usage, from the repository root on a machine with one Hopper card:

    python3 chip_k11_variants.py [NAME@@OLD@@NEW[@@OLD@@NEW ...] ...]
                                 [NAME=PATH ...]

The kernel as it is in ``src/repro_torch/kernels/csrc/flash_attention.cu``
is the variant ``base``. ``NAME@@OLD@@NEW`` adds a variant whose source is
``base``'s with the text OLD replaced by NEW (OLD must occur; more pairs
may follow); ``NAME=PATH`` adds one from a whole source file. Every
variant is built with the
repository's ``nvcc`` flags (one process each, all at once) into
``build/k11_variants/`` and loaded in place of the built kernel. Each is
checked against the plain version on ``chip_smoke.FLASH_CASES`` in bf16
(relative L2 <= 1e-2, repeated bit for bit; a variant whose name starts
with ``abl`` is an ablation, timed even when it fails) and timed on
``chip_smoke.FLASH_TIMED``'s bf16 shapes beside SDPA, in turns within this
one process: compare variants only within one run. One JSON line per
variant and shape; the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as cs


def build_variants(build, variants: dict) -> dict:
    """{name: entry point} of the variants that compiled."""
    out_dir = cs.ROOT / "build" / "k11_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in variants.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
               str(out_dir / f"{name}.so"), str(src)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate(timeout=build.BUILD_TIMEOUT_S)
        regs = [line.strip() for line in log.splitlines()
                if "registers" in line or "spill stores" in line]
        print(f"variant {name}: nvcc exit {proc.returncode}; " + "; ".join(
            regs), flush=True)
        if proc.returncode != 0:
            print(log, flush=True)
            continue
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).flash_attention_launch
        fn.argtypes = build.FLASH_ATTENTION.argtypes
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def check_variant(torch, flash, ref) -> list:
    """Failed checks of the loaded variant on FLASH_CASES in bf16."""
    failed = []
    for i, (B, Hq, Hkv, S, T, Dh, causal, window, kv_len) in enumerate(
            cs.FLASH_CASES):
        for layout in cs.FLASH_LAYOUTS:
            q, k, v = cs.flash_inputs(torch, B, Hq, Hkv, S, T, Dh,
                                      torch.bfloat16, i, layout)
            kw = dict(causal=causal, window=window, kv_len=kv_len)
            try:
                got = flash.flash_attention(q, k, v, **kw)
                again = flash.flash_attention(q, k, v, **kw)
                torch.cuda.synchronize()
            except RuntimeError as exc:
                failed.append(f"{cs.FLASH_CASES[i]} {layout}: {exc}")
                return failed            # a fault leaves the context unusable
            want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                           **kw)
            e = cs.rel_err(got.float(), want)
            if not (e <= cs.FLASH_TOL["bfloat16"] and torch.equal(got, again)):
                failed.append(f"{cs.FLASH_CASES[i]} {layout}: rel err {e:.2e}")
    return failed


def time_variant(torch, flash, name) -> None:
    import torch.nn.functional as F
    for shape, (B, Hq, Hkv, S, Dh, dtype_name, reps, _, layout) in \
            cs.FLASH_TIMED.items():
        if dtype_name != "bfloat16":
            continue
        q, k, v = cs.flash_inputs(torch, B, Hq, Hkv, S, S, Dh,
                                  torch.bfloat16, 99, layout)
        ms = cs.time_ms(lambda: flash.flash_attention(q, k, v, causal=True),
                        reps=reps)
        lib = cs.time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=Hq != Hkv), reps=reps)
        bound = cs.flash_bound(B, Hq, Hkv, S, S, Dh, 2, True, 0)
        print(f"variant {name} {shape} " + json.dumps(dict(
            ms=ms, library_ms=lib, vs_library=ms / lib,
            tflops=bound["flops"] / ms / 1e9,
            share_of_bound=bound["bound_ms"] / ms)), flush=True)
        del q, k, v


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_k11_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as flash

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    base = (build.CSRC / "flash_attention.cu").read_text()
    variants = {"base": base}
    for arg in sys.argv[1:]:
        if "@@" in arg:
            name, *edits = arg.split("@@")
            text = base
            for old, new in zip(edits[::2], edits[1::2]):
                if old not in text:
                    print(f"variant {name}: text not found: {old!r}",
                          file=sys.stderr)
                    return 2
                text = text.replace(old, new)
            variants[name] = text
        else:
            name, path = arg.split("=", 1)
            variants[name] = Path(path).read_text()
    t0 = time.perf_counter()
    entries = build_variants(build, variants)
    print(f"built {len(entries)} of {len(variants)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ok = len(entries) == len(variants)
    for name, fn in entries.items():
        build.FLASH_ATTENTION._fn = fn
        failed = check_variant(torch, flash, ref)
        print(f"variant {name}: {len(failed)} failed checks " + json.dumps(
            failed[:5]), flush=True)
        if failed and not name.startswith("abl"):
            ok = False
            continue
        time_variant(torch, flash, name)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
