#!/usr/bin/env python3
"""Variants of the dense multi-vector kernels (K8 ``xt_multi``, K9
``x_cz_multi``) against each other, the parent's kernels and one cuBLAS
call, on one NVIDIA card, at both tile types: at the dense slice's full
width (d = 4,096, n = 262,144) at s = 1, 2, 4, 5, 8 and 13 columns (13:
two launches through the ops, as softmax's groups go), and at its two
m = 4 shard shapes (the DiSCO-S column view ``X[:, :n/4]``, the DiSCO-F
row block ``X[:d/4]``) at s = 5 and 8.

Usage, from the repository root on a machine with one Hopper card:

    python3 chip_multi_variants.py [--parent DIR]
                                   [NAME@@OLD@@NEW[@@OLD@@NEW ...] ...]
    python3 chip_multi_variants.py --runs [--parent DIR]

With no variant named it runs ``DEFAULT_VARIANTS``: the design's knobs
(the bf16 tiles on the CUDA cores instead of the tensor cores, the ring's
stages, the pieces' rows) and ablations that time the fix-up and the
copies alone.

The design header ``src/repro_torch/kernels/csrc/dense_multi.cuh`` as it
is is the variant ``base``. ``NAME@@OLD@@NEW`` adds a variant whose
header is ``base``'s with the text OLD replaced by NEW (OLD must occur
once; more pairs may follow); each is built with the four entry points
(``xt_multi.cu``, ``x_cz_multi.cu`` and their ``_bf16`` instances) and
the repository's ``nvcc`` flags (one process each, all at once) into
``build/multi_variants/NAME/`` and loaded in place of the built kernels;
the wrappers take the variant's pieces (``kXtRowsF32``,
``kXtRowBytesF32`` and the rest of the eight).

``--parent DIR`` also times the ops of another checkout of the
repository at DIR (its ``src/repro_torch``, built into its own
``build/``), in a process of its own on the same seeded inputs, before
this checkout's variants: the way to hold a change against its parent
within one call (for example ``git archive`` of the parent unpacked
under ``build/``).

``--runs`` times the solves that go through K8 and K9 instead, on the
dense slice's X as ``chip_smoke.py`` makes it, after the two ops as a
softmax product calls them (K = 10 columns, two launches each, K9
without c, f32 and bf16): softmax with K = 10
classes (DiSCO-S m = 1 classic, f32 and bf16 tiles: K8 and K9 at 8 and
2 columns in every product) and the two-pass s-step DiSCO-S m = 1 at
s = 4 (K8 and K9 at 5 columns), each run's median time per Newton step;
with ``--parent`` the parent's package runs the same solves in turns
(parent, this checkout, this checkout, parent), one process each.

Each variant is checked against the plain versions (relative L2 <= 1e-5,
repeated bit for bit) at every case (a variant whose name starts with
``abl`` is an ablation, timed even when it is wrong), then timed as
``chip_smoke.py`` times kernels (median of 20 calls between CUDA events).
Compare variants only within one run. One JSON line per variant, kernel,
tile type and shape; the card's name and power limit first.
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

SOURCES = ("xt_multi", "x_cz_multi", "xt_multi_bf16", "x_cz_multi_bf16")
HEADER = "dense_multi.cuh"
SEED = 11
FULL_S = (1, 2, 4, 5, 8, 13)
SHARD_S = (5, 8)

# the set run when no variant is named: bf16 on the CUDA cores; a
# two-stage ring; the other pieces measured: bf16 K8 rows of 4 KB (16 x
# 2048), bf16 K9 rows of 512 bytes (128 x 256, the first design) and a
# 64-row bf16 K9 piece (1 KB rows, three stages, c and Z 0.28 of X), f32
# K9 rows of 1 KB (64 x 256); and ablations, wrong on purpose: without the
# fix-up, and the copies and the vector staging alone (no arithmetic)
DEFAULT_VARIANTS = [
    "fma_bf16@@kMmaAtBf16 = true;@@kMmaAtBf16 = false;",
    "stages2@@kMaxStages = 4;@@kMaxStages = 2;",
    "xt_bf16_4k@@kXtRowBytesBf16 = 2048;@@kXtRowBytesBf16 = 4096;"
    "@@kXtRowsBf16 = 32;@@kXtRowsBf16 = 16;",
    "cz_bf16_512@@kCzRowBytesBf16 = 1024;@@kCzRowBytesBf16 = 512;"
    "@@kCzRowsBf16 = 96;@@kCzRowsBf16 = 128;",
    "cz_bf16_64@@kCzRowsBf16 = 96;@@kCzRowsBf16 = 64;",
    "cz_f32_1k@@kCzRowBytesF32 = 2048;@@kCzRowBytesF32 = 1024;"
    "@@kCzRowsF32 = 40;@@kCzRowsF32 = 64;",
    "abl_nofixup@@  if (ctas > 1) {@@  if (false) {",
    "abl_copies_only@@    compute<XT, T, S>(st, buf, acc);@@",
]


def parse(args) -> dict:
    """{name: [(old, new), ...]} from NAME@@OLD@@NEW[@@OLD@@NEW ...]."""
    out = {}
    for arg in args:
        name, *parts = arg.split("@@")
        if not parts or len(parts) % 2:
            raise SystemExit(f"bad variant {arg!r}: NAME@@OLD@@NEW...")
        out[name] = list(zip(parts[::2], parts[1::2]))
    return out


def header_constants(text: str) -> dict:
    """The pieces a header variant takes, as glm_hvp mirrors them."""
    get = lambda k: int(re.search(rf"constexpr int {k} = (\d+);", text)[1])
    return {name: tuple((get(f"k{k}Rows{t}"), get(f"k{k}RowBytes{t}"))
                        for t in ("F32", "Bf16"))
            for name, k in (("xt_multi", "Xt"), ("x_cz_multi", "Cz"))}


def build_variants(build, base_text: str, variants: dict) -> dict:
    """Build each variant's four libraries; {name: ({source: fn},
    constants)} for those that built."""
    work = build.BUILD_DIR.parent / "multi_variants"
    jobs = {}
    for name, edits in variants.items():
        text = base_text
        for old, new in edits:
            if text.count(old) != 1:
                print(f"{name}: the edit {old[:60]!r} matches "
                      f"{text.count(old)} times; skipped", flush=True)
                break
            text = text.replace(old, new)
        else:
            src = work / name
            shutil.rmtree(src, ignore_errors=True)
            shutil.copytree(build.CSRC, src)
            (src / HEADER).write_text(text)
            jobs[name] = (text, src, [
                (k, subprocess.Popen(
                    [build._nvcc(), *build.NVCC_FLAGS, "-I", str(src), "-o",
                     str(src / f"{k}.so"), str(src / f"{k}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)) for k in SOURCES])
    out = {}
    for name, (text, src, procs) in jobs.items():
        fns, ok = {}, True
        for k, proc in procs:
            log, _ = proc.communicate(timeout=build.BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                print(f"{name}: nvcc failed for {k}\n{log[-3000:]}",
                      flush=True)
                ok = False
                continue
            spills = [ln.strip() for ln in log.splitlines()
                      if "spill" in ln and " 0 bytes spill stores" not in ln]
            if spills:
                print(f"{name} {k}: {spills}", flush=True)
            fn = getattr(ctypes.CDLL(str(src / f"{k}.so")), f"{k}_launch")
            fn.argtypes = getattr(build, k.upper()).argtypes
            fn.restype = ctypes.c_int
            fns[k] = fn
        if ok:
            out[name] = (fns, header_constants(text))
    return out


def make_inputs(torch):
    """The seeded X (f32 and its bf16 copy), c, U and Z blocks of 13
    columns, and the cases: (shape, rows, columns, s values)."""
    d, n = cs.DENSE["d"], cs.DENSE["n"]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    X = torch.randn((d, n), generator=g, device="cuda") / d ** 0.5
    c = 0.25 * torch.rand(n, generator=g, device="cuda")
    U = torch.randn((d, 13), generator=g, device="cuda")
    Z = torch.randn((n, 13), generator=g, device="cuda")
    shapes = {"full": (slice(None), slice(None), FULL_S),
              "S_m4_view": (slice(None), slice(0, n // 4), SHARD_S),
              "F_m4_rows": (slice(0, d // 4), slice(None), SHARD_S)}
    return X, X.to(torch.bfloat16), c, U, Z, shapes


def cases(torch, X, Xh, c, U, Z, shapes):
    """(kernel, tile type, shape, s, A, c, U block, contiguous Z block):
    U strided, as DiSCO-F passes it; Z contiguous, as pass A leaves it."""
    for tname, A0 in (("f32", X), ("bf16", Xh)):
        for shape, (rows, cols, ss) in shapes.items():
            A = A0[rows, cols]
            for s in ss:
                yield (tname, shape, s, A, c[cols], U[rows, :s],
                       Z[cols, :s].contiguous())


def bound_us(A, s) -> float:
    """X once and the f32 blocks once over the HBM rate."""
    d, n = A.shape
    return 1e6 * (A.numel() * A.element_size() + 4 * (d + n) * s) \
        / cs.HBM_BYTES_PER_S


RUNS = (("softmax K=10 DiSCO-S m=1 classic", "softmax", "float32"),
        ("softmax K=10 DiSCO-S m=1 classic bf16", "softmax", "bfloat16"),
        ("dense s-step s=4 DiSCO-S m=1 two-pass", "sstep", "float32"),
        ("dense bf16 s-step s=4 DiSCO-S m=1 two-pass", "sstep", "bfloat16"))


def runs_main(who: str) -> int:
    """The RUNS on the package on sys.path; one JSON line each."""
    import statistics
    import torch
    import repro_torch as rt
    from repro_torch.kernels import build
    dev = torch.device("cuda")
    X, y, _ = cs.make_dense_data(torch, dev, **cs.DENSE)
    d, n = X.shape
    g = torch.Generator(device=dev).manual_seed(2)
    W_true = torch.randn((d, cs.SOFTMAX_K), generator=g, device=dev)
    labels = torch.argmax(X.T @ W_true + torch.randn(
        (n, cs.SOFTMAX_K), generator=g, device=dev), dim=1)
    del W_true
    # the products as softmax issues them: U and Z (d, K) and (n, K)
    # blocks, each op two launches (8 + 2 columns), K9 without c
    from repro_torch.kernels import ops
    U = torch.randn((d, cs.SOFTMAX_K), generator=g, device=dev)
    Z = torch.randn((n, cs.SOFTMAX_K), generator=g, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        A = X.to(dtype)
        print(json.dumps({
            "variant": who, "op": f"softmax K={cs.SOFTMAX_K} HVP {dtype}",
            "xt_multi_us": cs.time_ms(lambda: ops.xt_multi(A, U)) * 1e3,
            "x_cz_multi_us": cs.time_ms(
                lambda: ops.x_cz_multi(A, None, Z)) * 1e3}), flush=True)
        del A
    for tag, kind, dtype in RUNS:
        if kind == "softmax":
            cfg = rt.SoftmaxConfig(partition="samples", pcg_block_s=1,
                                   n_classes=cs.SOFTMAX_K, hvp_dtype=dtype,
                                   **cs.SOFTMAX_SOLVE)
            solver = rt.SoftmaxSolver(X, labels, cfg, device="cuda")
        else:
            cfg = rt.DiscoConfig(partition="samples", hvp_fused=False,
                                 pcg_block_s=cs.SSTEP_S, hvp_dtype=dtype,
                                 **cs.DENSE_SOLVE)
            solver = rt.DiscoSolver(X, y, cfg, device="cuda")
        torch.cuda.synchronize()
        build.reset_launch_counts()
        hist = solver.fit().history
        torch.cuda.synchronize()
        print(json.dumps({
            "variant": who, "run": tag,
            "iter_s_median": statistics.median(h["iter_s"] for h in hist),
            "pcg_iters": [int(h["pcg_iters"]) for h in hist],
            "launches": {k: v for k, v in build.launch_counts().items()
                         if v}}), flush=True)
        del solver
        torch.cuda.empty_cache()
    return 0


def parent_main(parent: Path) -> int:
    """Time the parent checkout's ops on the same inputs."""
    import torch
    sys.path.insert(0, str(parent / "src"))
    from repro_torch.kernels import build, ops
    assert Path(build.__file__).resolve().is_relative_to(parent.resolve())
    build.build_kernels([build.XT_MULTI, build.X_CZ_MULTI,
                         build.XT_MULTI_BF16, build.X_CZ_MULTI_BF16])
    for tname, shape, s, A, ca, Ua, Za in cases(torch, *make_inputs(torch)):
        row = {"variant": "parent", "type": tname, "shape": shape, "s": s,
               "bound_us": bound_us(A, s),
               "xt_multi_us": cs.time_ms(lambda: ops.xt_multi(A, Ua)) * 1e3,
               "x_cz_multi_us": cs.time_ms(
                   lambda: ops.x_cz_multi(A, ca, Za)) * 1e3}
        print(json.dumps(row), flush=True)
    return 0


def run_parent(parent: Path, runs: bool = False) -> None:
    proc = subprocess.run([sys.executable, __file__, "--as-parent",
                           str(parent)] + (["--runs"] if runs else []),
                          capture_output=True, text=True, timeout=900)
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], flush=True)
        raise SystemExit(f"the parent's run failed ({proc.returncode})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_multi_variants: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    runs = "--runs" in args
    args = [a for a in args if a != "--runs"]
    if args[:1] == ["--as-parent"]:
        if runs:
            sys.path.insert(0, str(Path(args[1]) / "src"))
            return runs_main("parent")
        return parent_main(Path(args[1]))
    if args[:1] == ["--as-this"]:
        sys.path.insert(0, str(cs.SRC))
        return runs_main("this")
    parent = None
    if args[:1] == ["--parent"]:
        parent, args = Path(args[1]).resolve(), args[2:]
    if runs:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        for turn in ("parent", "this", "this", "parent"):
            if turn == "parent" and parent:
                run_parent(parent, runs=True)
            elif turn == "this":
                proc = subprocess.run(
                    [sys.executable, __file__, "--as-this", "--runs"],
                    capture_output=True, text=True, timeout=900)
                print(proc.stdout, end="", flush=True)
                if proc.returncode:
                    print(proc.stderr[-4000:], flush=True)
                    return proc.returncode
        return 0
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.kernels import build, glm_hvp, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if parent:
        run_parent(parent)
    kernels = [getattr(build, k.upper()) for k in SOURCES]
    build.build_kernels(kernels)
    base_text = (build.CSRC / HEADER).read_text()
    variants = {"base": ({k.name: k.entry() for k in kernels},
                         header_constants(base_text))}
    variants.update(build_variants(build, base_text,
                                   parse(args or DEFAULT_VARIANTS)))
    inputs = make_inputs(torch)
    todo = list(cases(torch, *inputs))
    bf = torch.bfloat16
    for tname, shape, s, A, ca, Ua, Za in todo:
        lib8 = ((lambda: A.t() @ Ua.to(bf)) if tname == "bf16"
                else (lambda: A.t() @ Ua))
        lib9 = ((lambda: A @ (ca[:, None] * Za).to(bf)) if tname == "bf16"
                else (lambda: A @ (ca[:, None] * Za)))
        print(json.dumps({"variant": "cuBLAS", "type": tname,
                          "shape": shape, "s": s,
                          "bound_us": bound_us(A, s),
                          "xt_multi_us": cs.time_ms(lib8) * 1e3,
                          "x_cz_multi_us": cs.time_ms(lib9) * 1e3}),
              flush=True)
    original = dict(glm_hvp.MULTI_PIECES)
    for name, (fns, consts) in [*variants.items(),
                                ("base (again)", variants["base"])]:
        for k in kernels:
            k._fn = fns[k.name]
        glm_hvp.MULTI_PIECES.update(consts)
        glm_hvp.multi_split.cache_clear()
        for tname, shape, s, A, ca, Ua, Za in todo:
            row = {"variant": name, "type": tname, "shape": shape, "s": s,
                   "bound_us": bound_us(A, s)}
            for kname, fn, want in (
                    ("xt_multi", lambda: ops.xt_multi(A, Ua),
                     ref.ref_xt_multi(A, Ua)),
                    ("x_cz_multi", lambda: ops.x_cz_multi(A, ca, Za),
                     ref.ref_x_cz_multi(A, ca, Za))):
                got, again = fn(), fn()
                torch.cuda.synchronize()
                err = cs.rel_err(got, want)
                ok = err <= cs.REL_TOL_KERNEL and bool(torch.equal(got, again))
                row[f"{kname}_err"] = err
                if ok or name.startswith("abl"):
                    row[f"{kname}_us"] = cs.time_ms(fn) * 1e3
                else:
                    row[f"{kname}_us"] = None
                    print(f"{name} {kname} {tname} {shape} s={s}: wrong "
                          f"(rel err {err:.2e})", flush=True)
                del got, again, want
            print(json.dumps(row), flush=True)
    glm_hvp.MULTI_PIECES.update(original)
    glm_hvp.multi_split.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
