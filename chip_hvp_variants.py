#!/usr/bin/env python3
"""Variants of the one-pass sparse HVP kernels (K2 ``ell_hvp``, K7
``ell_hvp_mm``) against each other on one NVIDIA card, at the rcv1-train
shape of ``chip_smoke.py``'s sparse slice.

Usage, from the repository root on a machine with one Hopper card:

    python3 chip_hvp_variants.py [NAME@@OLD@@NEW[@@OLD@@NEW ...] ...]
                                 [NAME:STEP_BYTES ...]

With no argument it runs ``DEFAULT_VARIANTS``: ablations of the step
hand-off (the fix-up, the flag wait, pass B), pass A two steps ahead,
steps of 40 MiB and one step over the whole layout.

The design header ``src/repro_torch/kernels/csrc/ell_hvp_stream.cuh`` as
it is, with the solver's step schedule, is the variant ``base``.
``NAME@@OLD@@NEW`` adds a variant whose header is ``base``'s with the text
OLD replaced by NEW (OLD must occur; more pairs may follow); each is built
with both entry points (``ell_hvp.cu``, ``ell_hvp_mm.cu``) and the
repository's ``nvcc`` flags (one process each, all at once) into
``build/hvp_variants/NAME/`` and loaded in place of the built kernels.
``NAME:STEP_BYTES`` adds the base kernels with a step schedule of that
``step_bytes``, and ``NAME@VARIANT:STEP_BYTES`` the header variant
VARIANT with it. Each variant is checked against
the plain versions (relative L2 <= 1e-5; a variant whose name starts with
``abl`` is an ablation, timed even when it is wrong) and timed, K2 with
the scale c and K7 at s = 5 on a strided U as ``chip_smoke.py`` times
them, in turns within this one process (base first and last): compare
variants only within one run. The two-pass pair is timed beside them.
One JSON line per variant; the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

SOURCES = ("ell_hvp", "ell_hvp_mm")
HEADER = "ell_hvp_stream.cuh"
# the set run when no variant is named: ablations of the hand-off (each
# wrong on purpose), a deeper pass-A lead, and two other step sizes
DEFAULT_VARIANTS = [
    "abl_nofixup@@    fixup<T, float4, S>(p, red, part, bnd_s, k0, k1, "
    "base, i);@@    (void)0;",
    "abl_nowait@@    while (flag.load(cuda::memory_order_acquire) != "
    "p.epoch) {@@    while (false) {",
    "abl_pass_a_only@@    if (w.b0 < w.b1) {@@    if (w.b0 < w.b1 && "
    "w.pass_a) {@@    if (b0 >= b1) continue;@@    if (b0 >= b1 || !a) "
    "continue;",
    "lag2@@constexpr int kLag = 1;@@constexpr int kLag = 2;",
    "base_40MB:41943040",
    "one_step:1099511627776",
]


def parse(args):
    """({name: header text}, {name: (header name, step_bytes)})."""
    texts, runs = {}, {}
    for arg in args:
        if "@@" in arg:
            name, *pairs = arg.split("@@")
            if len(pairs) % 2:
                raise SystemExit(f"{name}: OLD@@NEW pairs expected")
            texts[name] = pairs
        else:
            name, step_bytes = arg.rsplit(":", 1)
            runs[name] = int(step_bytes)
    return texts, runs


def build_variants(build, base_text: str, edits: dict) -> dict:
    """{name: {source: entry point}} of the header variants that
    compiled."""
    root = cs.ROOT / "build" / "hvp_variants"
    jobs = {}
    for name, pairs in edits.items():
        text = base_text
        for old, new in zip(pairs[::2], pairs[1::2]):
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in {HEADER}")
            text = text.replace(old, new)
        out = root / name
        out.mkdir(parents=True, exist_ok=True)
        (out / HEADER).write_text(text)
        for src in SOURCES:
            shutil.copy(build.CSRC / f"{src}.cu", out / f"{src}.cu")
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                   "-o", str(out / f"{src}.so"), str(out / f"{src}.cu")]
            jobs[(name, src)] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    entries = {}
    for (name, src), proc in jobs.items():
        log, _ = proc.communicate(timeout=build.BUILD_TIMEOUT_S)
        regs = [line.strip() for line in log.splitlines()
                if "registers" in line or "spill stores" in line]
        print(f"variant {name} {src}: nvcc exit {proc.returncode}; "
              + "; ".join(regs[-4:]), flush=True)
        if proc.returncode != 0:
            print(log, flush=True)
            continue
        kernel = getattr(build, src.upper())
        fn = getattr(ctypes.CDLL(str(root / name / f"{src}.so")),
                     f"{src}_launch")
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
        entries.setdefault(name, {})[src] = fn
    return {k: v for k, v in entries.items() if len(v) == len(SOURCES)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_hvp_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.SRC))
    import repro_torch as rt
    from repro_torch.data.sparse import make_sparse_glm_data
    from repro_torch.kernels import build, ref, sparse_hvp

    edits, steps = parse(sys.argv[1:] or DEFAULT_VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build.build_kernels([build.ELL_MV, build.ELL_HVP, build.ELL_MM,
                         build.ELL_HVP_MM])
    base_fns = {src: getattr(build, src.upper()).entry() for src in SOURCES}
    variants = {"base": base_fns}
    variants.update(build_variants(
        build, (build.CSRC / HEADER).read_text(), edits))

    X, y, _ = make_sparse_glm_data(**cs.SLICE)
    cfg = rt.DiscoConfig(partition="samples", hvp_fused=True, **cs.SOLVE)
    solver = rt.DiscoSolver(X, y, cfg, group=rt.InProcessGroup(1),
                            device="cuda")
    data, cols = solver.ell_data[0], solver.ell_cols[0]
    dataT, colsT = solver.ell_dataT[0], solver.ell_colsT[0]
    sched, schedT = solver.ell_sched[0], solver.ell_schedT[0]
    hs = solver.ell_hvp_sched[0]
    nrb, _, br, _ = data.shape
    ncb = dataT.shape[0]
    live = sparse_hvp.schedule_parts(schedT, ncb)[0]
    s = cs.TIMED_S
    g = torch.Generator(device="cuda").manual_seed(4)
    c = 0.25 * solver.weights[0]
    u = torch.randn(nrb * br, generator=g, device="cuda")
    U = torch.randn((nrb * br, s + 1), generator=g, device="cuda")[:, :s]
    want = ref.ref_ell_hvp_t(dataT, colsT, u, c)
    want_mm = ref.ref_ell_hvp_mm_t(dataT, colsT, U, c)

    runs = [("base", "base", hs)]
    for name in variants:
        if name != "base":
            runs.append((name, name, hs))
    for name, step_bytes in steps.items():
        kern = name.split("@", 1)[1] if "@" in name else "base"
        if kern != "base" and kern not in variants:
            print(f"{name}: no header variant {kern}", flush=True)
            continue
        runs.append((name, kern, sparse_hvp.ell_hvp_schedule(
            dataT, colsT, hs.ctas, step_bytes, live=live)))
    runs.append(("base (again)", "base", hs))

    pair = cs.time_ms(lambda: sparse_hvp.ell_mv(
        data, cols, sparse_hvp.ell_mv(dataT, colsT, u, sched=schedT), c,
        sched=sched))
    pair_mm = cs.time_ms(lambda: sparse_hvp.ell_mm(
        data, cols, sparse_hvp.ell_mm(dataT, colsT, U, sched=schedT), c,
        sched=sched))
    print(json.dumps({"two_pass_ell_mv_ms": pair,
                      "two_pass_ell_mm_ms": pair_mm}), flush=True)
    failed = []
    for name, kern, sc in runs:
        for src in SOURCES:
            getattr(build, src.upper())._fn = variants[kern][src]
        sc.state.zero_()        # an ablation may leave its counters set
        try:
            got = sparse_hvp.ell_hvp(dataT, colsT, u, c, sched=sc)
            got_mm = sparse_hvp.ell_hvp_mm(dataT, colsT, U, c, sched=sc)
            torch.cuda.synchronize()
        except RuntimeError as exc:
            print(f"{name}: {exc}", flush=True)
            failed.append(name)
            break                       # a fault leaves the context unusable
        err = (cs.rel_err(got, want), cs.rel_err(got_mm, want_mm))
        ok = max(err) <= cs.REL_TOL_KERNEL
        if not ok and not name.startswith("abl"):
            failed.append(name)
        row = dict(variant=name, kernel=kern, steps=sc.steps,
                   step_bytes=sc.step_bytes, rel_err=err, ok=ok)
        if ok or name.startswith("abl"):
            row["ell_hvp_ms"] = cs.time_ms(lambda: sparse_hvp.ell_hvp(
                dataT, colsT, u, c, sched=sc))
            row["ell_hvp_mm_ms"] = cs.time_ms(lambda: sparse_hvp.ell_hvp_mm(
                dataT, colsT, U, c, sched=sc))
        print(json.dumps(row), flush=True)
    if failed:
        print("variants that failed: " + ", ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
