#!/usr/bin/env python3
"""Variants of the dense one-vector kernels (K3 ``xt_u``, K4 ``x_cz``)
against each other and ``torch.mv`` on one NVIDIA card, at the dense
slice's full width (d = 4,096, n = 262,144 f32), at its two m = 4
shard shapes: the DiSCO-S column view ``X[:, :n/4]`` and the DiSCO-F row
block ``X[:d/4]``, and at the row block ``X[:d/16]``: a kernel's time
against the bytes it reads across the four shapes separates its fixed
cost (launch, ramp, tail, fix-up) from its streaming rate.

Usage, from the repository root on a machine with one Hopper card:

    python3 chip_dense_variants.py [--parent DIR]
                                   [NAME@@OLD@@NEW[@@OLD@@NEW ...] ...]
                                   [NAME@VARIANT:CTAS_PER_SM ...]

With no variant named it runs ``DEFAULT_VARIANTS``: the other piece
shapes measured, and ablations that time the fix-up, the evict-first
policy and the arithmetic.

The design header ``src/repro_torch/kernels/csrc/dense_stream.cuh`` as it
is, on one CTA per SM, is the variant ``base``.
``NAME@@OLD@@NEW`` adds a variant whose header is ``base``'s with the text
OLD replaced by NEW (OLD must occur; more pairs may follow); each is built
with both entry points (``xt_u.cu``, ``x_cz.cu``) and the repository's
``nvcc`` flags (one process each, all at once) into
``build/dense_variants/NAME/`` and loaded in place of the built kernels;
the wrappers take the variant's piece shape (``kTileRows``,
``kTileCols``). ``NAME@VARIANT:CTAS_PER_SM`` adds the header variant
VARIANT (``base`` for the header as it is) on that many CTAs per SM.

``--parent DIR`` also times the wrappers of another checkout of the
repository at DIR (its ``src/repro_torch``, built into its own
``build/``), in a process of its own on the same seeded X, before and
after this checkout's variants: the way to hold a change against its
parent within one call.

Each variant is checked against the plain versions (relative L2 <= 1e-5,
repeated bit for bit) at every shape (a variant whose name starts with
``abl`` is an ablation, timed even when it is wrong), then timed as
``chip_smoke.py`` times kernels (median of 20 calls between CUDA
events), in turns within this one process (``torch.mv`` and base first
and last): compare variants only within one run. One JSON line per
variant and shape; the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

SOURCES = ("xt_u", "x_cz")
HEADER = "dense_stream.cuh"
SEED = 7

# the set run when no variant is named: the other pieces measured (32 x
# 512 on 512 consumer threads, three stages; 32 x 768, two stages), and
# ablations, wrong on purpose, that time the parts of a call: without the
# fix-up, without the evict-first policy, and the copies alone (no
# arithmetic)
DEFAULT_VARIANTS = [
    "p32x512@@kTileRows = 16;@@kTileRows = 32;@@kTileCols = 1536;"
    "@@kTileCols = 512;@@kThreads = 384;@@kThreads = 512;",
    "p32x768@@kTileRows = 16;@@kTileRows = 32;@@kTileCols = 1536;"
    "@@kTileCols = 768;",
    "abl_nofixup@@  if (p.ctas > 1) {@@  if (false) {",
    "abl_noevict@@    bulk_copy_hint(stage + static_cast<size_t>(r) * "
    "kTileCols * 4,@@    bulk_copy(stage + static_cast<size_t>(r) * "
    "kTileCols * 4,@@                   row_bytes, bar, policy);"
    "@@                   row_bytes, bar);",
    "abl_copies_only@@if (4 * q < pc.w) {@@if (false && 4 * q < pc.w) {",
]


def parse(args):
    """({name: [old, new, ...]}, [(name, header variant, CTAs per SM)])."""
    edits, runs = {}, []
    for arg in args:
        if "@@" in arg:
            name, *pairs = arg.split("@@")
            if len(pairs) % 2:
                raise SystemExit(f"{name}: OLD@@NEW pairs expected")
            edits[name] = pairs
            runs.append((name, name, None))
        else:
            name, per_sm = arg.rsplit(":", 1)
            name, _, kern = name.partition("@")
            runs.append((name, kern or "base", int(per_sm)))
    return edits, runs


def tile_shape(text: str) -> tuple[int, int]:
    """(kTileRows, kTileCols) of a header text."""
    get = lambda k: int(re.search(rf"constexpr int {k} = (\d+);", text)[1])
    return get("kTileRows"), get("kTileCols")


def build_variants(build, base_text: str, edits: dict) -> dict:
    """{name: ({source: entry point}, piece shape)} of the header variants
    that compiled."""
    root = cs.ROOT / "build" / "dense_variants"
    jobs, texts = {}, {}
    for name, pairs in edits.items():
        text = base_text
        for old, new in zip(pairs[::2], pairs[1::2]):
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in {HEADER}")
            text = text.replace(old, new)
        texts[name] = text
        out = root / name
        out.mkdir(parents=True, exist_ok=True)
        (out / HEADER).write_text(text)
        for src in SOURCES:
            shutil.copy(build.CSRC / f"{src}.cu", out / f"{src}.cu")
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(out), "-I",
                   str(build.CSRC), "-o", str(out / f"{src}.so"),
                   str(out / f"{src}.cu")]
            jobs[(name, src)] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    entries = {}
    for (name, src), proc in jobs.items():
        log, _ = proc.communicate(timeout=build.BUILD_TIMEOUT_S)
        regs = [line.strip() for line in log.splitlines()
                if "registers" in line or "spill stores" in line]
        print(f"variant {name} {src}: nvcc exit {proc.returncode}; "
              + "; ".join(regs[-6:]), flush=True)
        if proc.returncode != 0:
            print(log, flush=True)
            continue
        kernel = getattr(build, src.upper())
        fn = getattr(ctypes.CDLL(str(root / name / f"{src}.so")),
                     f"{src}_launch")
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
        entries.setdefault(name, {})[src] = fn
    return {k: (v, tile_shape(texts[k])) for k, v in entries.items()
            if len(v) == len(SOURCES)}


def make_inputs(torch):
    """The seeded X at full width, its two shard views, and the vectors."""
    d, n = cs.DENSE["d"], cs.DENSE["n"]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    X = torch.randn((d, n), generator=g, device="cuda") / d ** 0.5
    u = torch.randn(d, generator=g, device="cuda")
    z = torch.randn(n, generator=g, device="cuda")
    c = 0.25 * torch.rand(n, generator=g, device="cuda")
    shapes = {"full": (X, slice(None), slice(None)),
              "S_m4_view": (X[:, :n // 4], slice(None), slice(0, n // 4)),
              "F_m4_rows": (X[:d // 4], slice(0, d // 4), slice(None)),
              "rows_d16": (X[:d // 16], slice(0, d // 16), slice(None))}
    return {k: (A, u[r], z[cols], c[cols])
            for k, (A, r, cols) in shapes.items()}


def bound_us(A) -> float:
    """Bytes of X read once over the HBM rate (the vectors are < 0.1%)."""
    return 1e6 * A.numel() * 4 / cs.HBM_BYTES_PER_S


def time_library(torch, inputs) -> dict:
    return {k: {"xt_u": cs.time_ms(lambda: torch.mv(A.t(), u)) * 1e3,
                "x_cz": cs.time_ms(lambda: torch.mv(A, c * z)) * 1e3}
            for k, (A, u, z, c) in inputs.items()}


def parent_main(parent: Path) -> int:
    """Time the parent checkout's xt_u and x_cz on the same inputs."""
    import torch
    sys.path.insert(0, str(parent / "src"))
    from repro_torch.kernels import build, glm_hvp
    assert Path(build.__file__).resolve().is_relative_to(parent.resolve())
    build.build_kernels([build.XT_U, build.X_CZ])
    for name, (A, u, z, c) in make_inputs(torch).items():
        row = {"variant": "parent", "shape": name,
               "dims": list(A.shape), "bound_us": bound_us(A),
               "xt_u_us": cs.time_ms(lambda: glm_hvp.xt_u(A, u)) * 1e3,
               "x_cz_us": cs.time_ms(lambda: glm_hvp.x_cz(A, c, z)) * 1e3}
        print(json.dumps(row), flush=True)
    return 0


def run_parent(parent: Path) -> None:
    proc = subprocess.run([sys.executable, __file__, "--as-parent",
                           str(parent)], capture_output=True, text=True,
                          timeout=900)
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], flush=True)
        raise SystemExit(f"the parent's run failed ({proc.returncode})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_dense_variants: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args[:1] == ["--as-parent"]:
        return parent_main(Path(args[1]))
    parent = None
    if args[:1] == ["--parent"]:
        parent, args = Path(args[1]).resolve(), args[2:]
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.kernels import build, glm_hvp, ref

    edits, runs = parse(args or DEFAULT_VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if parent:
        run_parent(parent)
    build.build_kernels([build.XT_U, build.X_CZ])
    base_text = (build.CSRC / HEADER).read_text()
    variants = {"base": ({src: getattr(build, src.upper()).entry()
                          for src in SOURCES}, tile_shape(base_text))}
    variants.update(build_variants(build, base_text, edits))
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    inputs = make_inputs(torch)
    want = {k: (ref.ref_xt_u(A, u), ref.ref_x_cz(A, c * z))
            for k, (A, u, z, c) in inputs.items()}
    library = time_library(torch, inputs)
    runs = ([("base", "base", None)] + runs
            + [("base (again)", "base", None)])
    failed = []
    for name, kern, per_sm in runs:
        if kern not in variants:
            print(f"{name}: no header variant {kern} built", flush=True)
            failed.append(name)
            continue
        fns, (rows, cols) = variants[kern]
        for src in SOURCES:
            getattr(build, src.upper())._fn = fns[src]
        glm_hvp.TILE_ROWS, glm_hvp.TILE_COLS = rows, cols
        glm_hvp.dense_split.cache_clear()
        ctas = sms * (per_sm or 1)
        for shape, (A, u, z, c) in inputs.items():
            kz = lambda: glm_hvp.xt_u(A, u, _ctas=ctas)
            ky = lambda: glm_hvp.x_cz(A, c, z, _ctas=ctas)
            try:
                got = (kz(), ky())
                again = (kz(), ky())
                torch.cuda.synchronize()
            except RuntimeError as exc:
                print(f"{name} {shape}: {exc}", flush=True)
                failed.append(name)
                break                   # a fault leaves the context unusable
            err = [cs.rel_err(g, w) for g, w in zip(got, want[shape])]
            same = all(bool(torch.equal(g, a)) for g, a in zip(got, again))
            ok = max(err) <= cs.REL_TOL_KERNEL and same
            row = dict(variant=name, kernel=kern, tile=[rows, cols],
                       ctas=ctas, shape=shape, dims=list(A.shape),
                       path=[glm_hvp.last_path["xt_u"],
                             glm_hvp.last_path["x_cz"]],
                       rel_err=err, repeats=same, ok=ok,
                       bound_us=bound_us(A),
                       library_xt_u_us=library[shape]["xt_u"],
                       library_x_cz_us=library[shape]["x_cz"])
            if ok or name.startswith("abl"):
                row["xt_u_us"] = cs.time_ms(kz) * 1e3
                row["x_cz_us"] = cs.time_ms(ky) * 1e3
            if not ok and not name.startswith("abl"):
                failed.append(name)
            print(json.dumps(row), flush=True)
    print(json.dumps({"library_again": time_library(torch, inputs)}),
          flush=True)
    if parent:
        run_parent(parent)
    if failed:
        print("variants that failed: " + ", ".join(sorted(set(failed))),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
