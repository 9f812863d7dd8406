"""Serving launcher:  python -m repro_torch.launch.serve --arch olmo-1b ...

Spins up the batched decode engine on the reduced config of a dense, MoE
(``--arch mixtral-8x7b``, ``--arch qwen3-moe-30b-a3b``), SSM (``--arch
falcon-mamba-7b``) or hybrid (``--arch zamba2-2.7b``) decoder and serves a
synthetic request batch, on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.serve import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b",
                    help="one of " + ", ".join(a.replace("_", "-")
                                               for a in ARCHS)
                    + " (dense, MoE, SSM and hybrid decoders)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch).replace(dtype="float32")
    eng = Engine(cfg, batch_size=args.batch,
                 max_len=64 + args.new_tokens, device=args.device)
    print(f"serving {args.arch} (reduced, {cfg.param_count()/1e6:.1f}M) "
          f"batch={args.batch} on {eng.device}")

    done = 0
    t0 = time.perf_counter()
    pending = [Request(prompt=[1 + i, 2 + i, 3 + i],
                       max_new_tokens=args.new_tokens,
                       temperature=args.temperature)
               for i in range(args.requests)]
    while pending:
        batch, pending = pending[:args.batch], pending[args.batch:]
        outs = eng.generate(batch)
        for o in outs:
            done += len(o.tokens)
    dt = time.perf_counter() - t0
    print(f"{args.requests} requests, {done} tokens in {dt:.2f}s "
          f"({done / dt:.1f} tok/s)")


if __name__ == "__main__":
    main()
