"""LLM continuous batching: slots over the cached decode step
(``repro/serve/scheduler.py``).

``ContinuousEngine`` keeps B cache slots and, at every decode tick:

  1. fills free slots from the waiting queue (the new request's prompt
     goes into ITS slot only, one token per tick, while other slots keep
     decoding);
  2. decodes one token for every active slot;
  3. retires slots that hit max_new_tokens or eos, immediately reusable.

All slots share one (B, ...) cache (KV entries, or a Mamba layer's conv
inputs and SSM state), so every tick is the same
:func:`~repro_torch.models.decode_step` whatever the request mix.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models import init_cache
from repro_torch.serve.engine import (Completion, Request, make_serve_step,
                                      model_and_device)


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    req_id: int = -1
    prompt_left: list = dataclasses.field(default_factory=list)
    out: list = dataclasses.field(default_factory=list)
    done: bool = True

    @property
    def active(self):
        return self.req is not None and not self.done


class ContinuousEngine:
    """Slot-based continuous batching over a shared KV cache."""

    def __init__(self, model_cfg, model=None, batch_size: int = 4,
                 max_len: int = 256, seed: int = 0, device=None):
        self.cfg = model_cfg
        self.B = batch_size
        self.max_len = max_len
        self.model, self.device = model_and_device(model_cfg, model, seed,
                                                   device)
        self._step = make_serve_step(model_cfg)
        self.cache = init_cache(model_cfg, batch_size, max_len,
                                device=self.device)
        self.slots = [_Slot() for _ in range(batch_size)]
        self.waiting: list[tuple[int, Request]] = []
        self.finished: dict[int, Completion] = {}
        self._next_id = 0
        self._last_logits = None
        self.ticks = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> int:
        rid = self._next_id
        self._next_id += 1
        self.waiting.append((rid, req))
        return rid

    def _admit(self):
        for slot in self.slots:
            if slot.active or not self.waiting:
                continue
            rid, req = self.waiting.pop(0)
            slot.req = req
            slot.req_id = rid
            slot.prompt_left = list(req.prompt)
            slot.out = []
            slot.done = False

    def _reset_slot(self, i: int):
        """Clear the previous occupant's state from slot i, as the
        reference does: KV entries are masked out by pos = -1
        (decode_attention treats pos < 0 as empty); for the SSM and hybrid
        families every other array of the slot (the conv inputs, the SSM
        states, a hybrid's shared-attention k and v) is zeroed, so that a
        reused slot carries no recurrent state."""
        recurrent = self.cfg.arch_type in ("ssm", "hybrid")
        for part, arrays in self.cache.items():
            if part == "index":
                continue
            for name, a in arrays.items():
                if name == "pos":
                    a[:, i] = -1
                elif recurrent:
                    a[:, i] = 0

    def tick(self):
        """One global decode step across all slots."""
        self._admit()
        tokens = np.zeros((self.B, 1), np.int64)
        greedy = None
        for i, slot in enumerate(self.slots):
            if not slot.active:
                continue
            if slot.prompt_left:
                if len(slot.prompt_left) == len(slot.req.prompt):
                    self._reset_slot(i)
                tokens[i, 0] = slot.prompt_left.pop(0)
            elif self._last_logits is not None:
                if greedy is None:    # one device read for all slots
                    greedy = torch.argmax(
                        self._last_logits[:, -1, : self.cfg.vocab_size],
                        -1).tolist()
                slot.out.append(greedy[i])
                tokens[i, 0] = greedy[i]
        logits, self.cache = self._step(
            self.model, torch.from_numpy(tokens).to(self.device), self.cache)
        self._last_logits = logits
        self.ticks += 1

        for slot in self.slots:
            if not slot.active or slot.prompt_left:
                continue
            r = slot.req
            if slot.out and (len(slot.out) >= r.max_new_tokens
                             or slot.out[-1] == r.eos_id):
                self.finished[slot.req_id] = Completion(
                    tokens=slot.out, steps=self.ticks, elapsed_s=0.0)
                slot.req = None
                slot.done = True

    def run_until_done(self, max_ticks: int = 10_000):
        t0 = time.perf_counter()
        while (self.waiting or any(s.active for s in self.slots)) \
                and self.ticks < max_ticks:
            self.tick()
        dt = time.perf_counter() - t0
        for c in self.finished.values():
            c.elapsed_s = dt
        return self.finished
