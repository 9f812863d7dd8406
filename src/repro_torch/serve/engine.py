"""LLM serving over the dense, MoE, SSM and hybrid decoders: single-token
decode and a batched engine (``repro/serve/engine.py``).

``Engine.generate`` works as the JAX engine's: prompts are left-padded
into the batch's static slots and replayed token by token through
:func:`~repro_torch.models.decode_step` (prefill as decode steps; no
launch of the flash kernel; a Mamba layer's state advances a token a
step, as in the reference), then decoded greedily (``argmax``) or by
temperature sampling from the engine's ``torch.Generator``, with per-slot
eos and ``max_new_tokens``. Prefill of a whole prompt batch in one pass
is :func:`~repro_torch.models.forward` with ``last_only=True``.

Runs on the card unless the caller passes ``device='cpu'`` (or a model
that lies on the CPU).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.disco import resolve_device
from repro_torch.models import decode_step, init_cache, init_params


def make_serve_step(model_cfg, mesh=None):
    """Returns ``step(model, tokens (B, 1), cache) -> (logits, cache)``.
    The mesh variant (a model sharded over several cards) is not yet
    ported."""
    if mesh is not None:
        raise NotImplementedError("make_serve_step over a mesh is not yet "
                                  "ported to repro_torch (one card only)")

    def step(model, tokens, cache):
        return decode_step(model_cfg, model, tokens, cache)
    return step


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    eos_id: int = -1               # -1 = never stop early


@dataclasses.dataclass
class Completion:
    tokens: list[int]
    steps: int
    elapsed_s: float


def model_and_device(model_cfg, model, seed, device):
    """The engine's model and device: ``model`` as given (``device``, if
    also given, must be the model's), else parameters from seed ``seed``
    on ``device`` (default: the card)."""
    if model is None:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return init_params(model_cfg, gen, device=dev), dev
    if device is not None and torch.device(device) != model.device:
        raise ValueError(f"the model lies on {model.device}, not {device}")
    return model, model.device


class Engine:
    """Static-batch greedy/temperature decode engine over the dense, MoE,
    SSM and hybrid decoders."""

    def __init__(self, model_cfg, model=None, batch_size: int = 4,
                 max_len: int = 512, seed: int = 0, device=None):
        self.cfg = model_cfg
        self.batch_size = batch_size
        self.max_len = max_len
        self.model, self.device = model_and_device(model_cfg, model, seed,
                                                   device)
        self._step = make_serve_step(model_cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _sample(self, logits, temperature):
        logits = logits[:, -1, : self.cfg.vocab_size]
        if temperature <= 0:
            return torch.argmax(logits, -1)
        probs = torch.softmax(logits / temperature, -1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    def generate(self, requests: list[Request]) -> list[Completion]:
        """Prompts replayed through the cache, then batched decode."""
        if len(requests) > self.batch_size:
            raise ValueError(f"{len(requests)} requests for "
                             f"{self.batch_size} slots")
        t0 = time.perf_counter()
        B = self.batch_size
        prompts = [r.prompt for r in requests]
        prompts += [[0]] * (B - len(requests))     # pad slots
        plen = max(len(p) for p in prompts)
        toks = np.zeros((B, plen), np.int64)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p            # left-pad
        toks = torch.from_numpy(toks).to(self.device)

        cache = init_cache(self.cfg, B, self.max_len, device=self.device)
        logits = None
        for t in range(plen):
            logits, cache = self._step(self.model, toks[:, t:t + 1], cache)

        max_new = max(r.max_new_tokens for r in requests)
        out = [[] for _ in range(B)]
        done = np.zeros(B, bool)
        steps = 0
        for _ in range(max_new):
            temps = requests[0].temperature if requests else 0.0
            nxt = self._sample(logits, temps).cpu().numpy()
            for i, r in enumerate(requests):
                if not done[i] and len(out[i]) < r.max_new_tokens:
                    out[i].append(int(nxt[i]))
                    if nxt[i] == r.eos_id:
                        done[i] = True
                else:
                    done[i] = True
            steps += 1
            if done[: len(requests)].all():
                break
            logits, cache = self._step(
                self.model, torch.from_numpy(nxt.reshape(B, 1)).to(
                    self.device), cache)
        dt = time.perf_counter() - t0
        return [Completion(tokens=out[i], steps=steps, elapsed_s=dt)
                for i in range(len(requests))]
