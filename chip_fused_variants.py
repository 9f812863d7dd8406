#!/usr/bin/env python3
"""Variants of the fused dense kernels (K5 ``x_c_xt_u``, K10
``x_c_xt_multi``) against each other and the two-pass kernel pairs they
fuse (K3 + K4, K8 + K9) on one NVIDIA card, at the dense slice's full
width (d = 4,096, n = 262,144 f32) and its two m = 4 shard shapes: the
DiSCO-S column view ``X[:, :n/4]`` (K5 and K10) and the DiSCO-F row block
``X[:d/4]`` (K5).

Usage, from the repository root on a machine with one Hopper card:

    python3 chip_fused_variants.py [--parent DIR]
                                   [NAME@@OLD@@NEW[@@OLD@@NEW ...] ...]
                                   [NAME@VARIANT:Q:BN:STAGES ...]

With no variant named it runs ``DEFAULT_VARIANTS``: the panels split over
the clusters in turn rather than in ranges, and ablations that time the
exchange, the lag and the arithmetic.

The design header ``src/repro_torch/kernels/csrc/fused_stream.cuh`` as it
is, on the fit rule's plan, is the variant ``base``. ``NAME@@OLD@@NEW``
adds a variant whose header is ``base``'s with the text OLD replaced by
NEW (OLD must occur; more pairs may follow); each is built with both entry
points (``x_c_xt_u.cu``, ``x_c_xt_multi.cu``) and the repository's
``nvcc`` flags (one process each, all at once) into
``build/fused_variants/NAME/`` and loaded in place of the built kernels.
``NAME@VARIANT:Q:BN:STAGES`` adds the header variant VARIANT (``base``
for the header as it is) on the plan of Q CTAs a cluster, panels of BN
columns and STAGES stages, at the shapes where that plan fits (the fit
rule's own plan elsewhere).

``--parent DIR`` also times the wrappers of another checkout of the
repository at DIR (its ``src/repro_torch``, built into its own
``build/``), in a process of its own on the same seeded X, before and
after this checkout's variants: the way to hold a change against its
parent within one call.

Each variant is checked against the plain versions (relative L2 <= 1e-5,
repeated bit for bit; a variant whose name starts with ``abl`` is an
ablation, timed even when it is wrong), then timed as ``chip_smoke.py``
times kernels (median of 20 calls between CUDA events), in turns within
this one process (base first and last): compare variants only within one
run. One JSON line per variant and shape; the card's name and power limit
first.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

SOURCES = ("x_c_xt_u", "x_c_xt_multi")
HEADER = "fused_stream.cuh"
SEED = 11
S_TIMED = (1, 5, 8)          # K10's columns at full width (5 elsewhere)

# the panels of a cluster in turn (panel k + m C) rather than in a range
INTERLEAVE = [
    "  const long long first = panel_bound(p, cl);\n"
    "  const int np = static_cast<int>(panel_bound(p, cl + 1) - first);",
    "  const long long first = cl;\n"
    "  const int np = static_cast<int>(\n"
    "      max(0, (p.panels - cl + p.clusters - 1) / p.clusters));",
    "  return (first + m) * bn;",
    "  return (first + static_cast<long long>(m) * p.clusters) * bn;"]
NO_EXCHANGE = ["      if (t < E) wait_cluster(&xfull[sl], (m / kSlots) & 1);\n", "",
               "r < p.q ? ld_peer(peer_addr(mine, r)) : 0.f;",
               "r == 0 ? *mine : 0.f;"]
L2_256 = ["CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
          "CU_TENSOR_MAP_L2_PROMOTION_L2_256B"]
EVICT_NORMAL = ["createpolicy.fractional.L2::evict_first.b64",
                "createpolicy.fractional.L2::evict_normal.b64"]
NO_MATH = ["      for (int j = 0; j < rpt; ++j) {",
           "      for (int j = 0; j < 0 * rpt; ++j) {",
           "        if (g < p.groups) {", "        if (false && g < p.groups) {"]

DEFAULT_VARIANTS = [
    "interleave@@" + "@@".join(INTERLEAVE),
    "lag0@@  p.lag = stages >= 3 ? 1 : 0;@@  p.lag = 0;",
    "abl_noexchange@@" + "@@".join(NO_EXCHANGE),
    "abl_copies_only@@" + "@@".join(NO_MATH + NO_EXCHANGE),
    "abl_copies_only_interleave@@" + "@@".join(NO_MATH + NO_EXCHANGE
                                               + INTERLEAVE),
    "q8_bn16_st4@base:8:16:4",
    "q4_bn16_st3@base:4:16:3",
    "interleave_bn16_st4@interleave:8:16:4",
]


def parse(args):
    """({name: [old, new, ...]}, [(name, header variant, plan or None)])."""
    edits, runs = {}, []
    for arg in args:
        if "@@" in arg:
            name, *pairs = arg.split("@@")
            if len(pairs) % 2:
                raise SystemExit(f"{name}: OLD@@NEW pairs expected")
            edits[name] = pairs
            runs.append((name, name, None))
        else:
            name, spec = arg.split("@", 1)
            kern, q, bn, stages = spec.split(":")
            runs.append((name, kern or "base", (int(q), int(bn),
                                                int(stages))))
    return edits, runs


def build_variants(build, base_text: str, edits: dict) -> dict:
    """{name: {source: entry point}} of the header variants that
    compiled."""
    root = cs.ROOT / "build" / "fused_variants"
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
                if "registers" in line or "stack frame" in line]
        print(f"variant {name} {src}: nvcc exit {proc.returncode}; "
              + "; ".join(regs[-8:]), flush=True)
        if proc.returncode != 0:
            print(log[-6000:], flush=True)
            continue
        kernel = getattr(build, src.upper())
        fn = getattr(ctypes.CDLL(str(root / name / f"{src}.so")),
                     f"{src}_launch")
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
        entries.setdefault(name, {})[src] = fn
    return {k: v for k, v in entries.items() if len(v) == len(SOURCES)}


def make_inputs(torch):
    """The seeded X at full width, its two shard views, c, u and U."""
    d, n = cs.DENSE["d"], cs.DENSE["n"]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    X = torch.randn((d, n), generator=g, device="cuda") / d ** 0.5
    u = torch.randn(d, generator=g, device="cuda")
    U = torch.randn((d, 8), generator=g, device="cuda")
    c = 0.25 * torch.rand(n, generator=g, device="cuda")
    shapes = {"full": (X, slice(None), slice(None), S_TIMED),
              "S_m4_view": (X[:, :n // 4], slice(None), slice(0, n // 4),
                            (5,)),
              "F_m4_rows": (X[:d // 4], slice(0, d // 4), slice(None), ())}
    return {k: (A, u[r], c[cols], {s: U[r, :s].contiguous() for s in ss})
            for k, (A, r, cols, ss) in shapes.items()}


def bound_us(A) -> float:
    """Bytes of X read once over the HBM rate (the vectors are < 0.1%)."""
    return 1e6 * A.numel() * 4 / cs.HBM_BYTES_PER_S


def time_pairs(glm_hvp, inputs) -> dict:
    """The two-pass kernel pairs each fused kernel replaces."""
    out = {}
    for k, (A, u, c, Us) in inputs.items():
        row = {"K3+K4": cs.time_ms(
            lambda: glm_hvp.x_cz(A, c, glm_hvp.xt_u(A, u))) * 1e3}
        for s, U in Us.items():
            row[f"K8+K9 s={s}"] = cs.time_ms(lambda: glm_hvp.x_cz_multi(
                A, c, glm_hvp.xt_multi(A, U))) * 1e3
        out[k] = row
    return out


def parent_main(parent: Path) -> int:
    """Time the parent checkout's x_c_xt_u and x_c_xt_multi on the same
    inputs."""
    import torch
    sys.path.insert(0, str(parent / "src"))
    from repro_torch.kernels import build, glm_hvp
    assert Path(build.__file__).resolve().is_relative_to(parent.resolve())
    build.build_kernels([build.X_C_XT_U, build.X_C_XT_MULTI])
    for name, (A, u, c, Us) in make_inputs(torch).items():
        row = {"variant": "parent", "shape": name, "dims": list(A.shape),
               "bound_us": bound_us(A),
               "x_c_xt_u_us": cs.time_ms(
                   lambda: glm_hvp.x_c_xt_u(A, c, u)) * 1e3}
        for s, U in Us.items():
            row[f"x_c_xt_multi_s{s}_us"] = cs.time_ms(
                lambda: glm_hvp.x_c_xt_multi(A, c, U)) * 1e3
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
        print("chip_fused_variants: no CUDA device", file=sys.stderr)
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
    build.build_kernels([build.X_C_XT_U, build.X_C_XT_MULTI, build.XT_U,
                         build.X_CZ, build.XT_MULTI, build.X_CZ_MULTI])
    variants = {"base": {src: getattr(build, src.upper()).entry()
                         for src in SOURCES}}
    variants.update(build_variants(build, (build.CSRC / HEADER).read_text(),
                                   edits))
    rule = glm_hvp.fused_plan

    inputs = make_inputs(torch)
    want = {k: (ref.ref_x_c_xt_u(A, c, u),
                {s: ref.ref_x_c_xt_multi(A, c, U) for s, U in Us.items()})
            for k, (A, u, c, Us) in inputs.items()}
    print(json.dumps({"pairs": time_pairs(glm_hvp, inputs)}), flush=True)
    runs = [("base", "base", None)] + runs + [("base (again)", "base", None)]
    failed = []
    for name, kern, plan in runs:
        if kern not in variants:
            print(f"{name}: no header variant {kern} built", flush=True)
            failed.append(name)
            continue
        for src in SOURCES:
            getattr(build, src.upper())._fn = variants[kern][src]
        for shape, (A, u, c, Us) in inputs.items():
            d = A.shape[0]

            def planned(dd, s=1, cluster=None, dtype=torch.float32, _d=d):
                if plan and dd == _d and cluster is None \
                        and dtype == torch.float32:
                    q, bn, stages = plan
                    rows = glm_hvp.fused_rows(dd, q)
                    if (rows // glm_hvp.FUSED_ROW_QUANTUM
                            <= glm_hvp.fused_max_groups(s)
                            and glm_hvp.fused_smem_bytes(rows, bn, stages, s)
                            <= glm_hvp.SMEM_LIMIT):
                        return glm_hvp.FusedPlan(q, bn, stages, rows)
                return rule(dd, s, cluster, dtype=dtype)

            glm_hvp.fused_plan = planned
            calls = {"x_c_xt_u": lambda: glm_hvp.x_c_xt_u(A, c, u)}
            for s, U in Us.items():
                calls[f"x_c_xt_multi s={s}"] = \
                    lambda U=U: glm_hvp.x_c_xt_multi(A, c, U)
            got, again = {}, {}
            for k, f in list(calls.items()):
                try:                    # a plan the variant refuses
                    got[k], again[k] = f(), f()
                    torch.cuda.synchronize()
                except RuntimeError as exc:
                    print(f"{name} {shape} {k}: {exc}", flush=True)
                    failed.append(name)
                    del calls[k]
            if not calls:
                continue
            ref_of = {"x_c_xt_u": want[shape][0],
                      **{f"x_c_xt_multi s={s}": want[shape][1][s]
                         for s in Us}}
            err = {k: cs.rel_err(got[k], ref_of[k]) for k in calls}
            same = all(bool(torch.equal(got[k], again[k])) for k in calls)
            ok = max(err.values()) <= cs.REL_TOL_KERNEL and same
            row = dict(variant=name, kernel=kern, shape=shape,
                       dims=list(A.shape), rel_err=err, repeats=same, ok=ok,
                       fused={k: str(v) for k, v in
                              glm_hvp.last_fused.items()},
                       bound_us=bound_us(A))
            if ok or name.startswith("abl"):
                row["us"] = {k: cs.time_ms(f) * 1e3
                             for k, f in calls.items()}
            if not ok and not name.startswith("abl"):
                failed.append(name)
            print(json.dumps(row), flush=True)
        glm_hvp.fused_plan = rule
    print(json.dumps({"pairs_again": time_pairs(glm_hvp, inputs)}),
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
