"""The decoder families: init / forward / decode
(``repro/models/model.py``).

``arch_type == "dense"``: a decoder-only transformer (GQA, a RoPE variant,
an MLP); ``"moe"``: the same with a Mixture-of-Experts FFN in every layer
(:mod:`repro_torch.models.moe`); ``"ssm"``: a stack of Mamba1 blocks
(attention-free); ``"hybrid"``: a Mamba2 backbone with shared attention
blocks (Zamba2-style, :mod:`repro_torch.models.mamba`). The model is an
``nn.Module``, :class:`DecoderLM`, whose ``layers`` are an
``nn.ModuleList`` of blocks in place of the JAX package's stacked pytree
scanned with ``lax.scan``; its parameter names are the JAX dict's keys
(``layers.3.attn.wq`` is ``params["layers"]["attn"]["wq"][3]``,
``layers.3.mamba.in_proj`` is ``params["layers"]["mamba"]["in_proj"][3]``,
a hybrid's ``shared.1.attn.wq`` is ``params["shared"]["attn"]["wq"][1]``).
The JAX functions keep their names here, at module level:
:func:`init_params`, :func:`forward`, :func:`init_cache`,
:func:`decode_step` and :func:`count_params_analytic`. The audio and VLM
families raise "not yet ported".

``forward`` is the prefill of serving (``last_only=True`` unembeds only
the last position): every self-attention (a hybrid's shared blocks
included) is one launch of the flash kernel on the card; an MoE layer
routes and dispatches at its capacity; a Mamba layer runs its chunked
scan in plain torch. ``decode_step`` attends over the KV cache in plain
torch, updates the cache (KV and SSM states) in place and runs an MoE
layer token-choice (each token its k experts).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function

from repro_torch.core.disco import resolve_device
from repro_torch.models.attention import (attention_block, decode_attention,
                                          init_attention, init_kv_cache)
from repro_torch.models import mamba as mb
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                       init_embedding, init_mlp, init_norm,
                                       make_param, truncated_normal_, unembed)
from repro_torch.models.moe import init_moe, moe_block, token_choice
from repro_torch.models.rope import default_positions

PORTED = ("dense", "moe", "ssm", "hybrid")


def check_ported(cfg) -> None:
    if cfg.arch_type not in PORTED:
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} ({cfg.name}) is not yet ported to "
            f"repro_torch (the audio and VLM families are still to come); "
            f"the dense, MoE, SSM and hybrid decoders are")
    if cfg.arch_type == "moe" and cfg.moe_layer_period != 1:
        raise ValueError("the MoE family has an MoE FFN in every layer "
                         "(moe_layer_period 1)")


class DenseBlock(nn.Module):
    """One pre-norm block: norm1, attn, norm2, mlp."""

    def __init__(self, cfg, generator=None, dtype=None, device=None):
        super().__init__()
        self.norm1 = init_norm(cfg, dtype, device)
        self.attn = init_attention(cfg, generator, dtype, device)
        self.norm2 = init_norm(cfg, dtype, device)
        self.mlp = init_mlp(cfg, generator, dtype, device)


class MoEBlock(nn.Module):
    """One pre-norm block with an MoE FFN: norm1, attn, norm2, moe (the
    router f32 whatever ``dtype``)."""

    def __init__(self, cfg, generator=None, dtype=None, device=None):
        super().__init__()
        self.norm1 = init_norm(cfg, dtype, device)
        self.attn = init_attention(cfg, generator, dtype, device)
        self.norm2 = init_norm(cfg, dtype, device)
        self.moe = init_moe(cfg, generator, dtype, device)


class Mamba1Block(nn.Module):
    """One pre-norm Mamba1 block: norm1, mamba."""

    def __init__(self, cfg, generator=None, dtype=None, device=None):
        super().__init__()
        self.norm1 = init_norm(cfg, dtype, device)
        self.mamba = mb.init_mamba1(cfg, generator, dtype, device)


class Mamba2Block(nn.Module):
    """One pre-norm Mamba2 block: norm1, mamba."""

    def __init__(self, cfg, generator=None, dtype=None, device=None):
        super().__init__()
        self.norm1 = init_norm(cfg, dtype, device)
        self.mamba = mb.init_mamba2(cfg, generator, dtype, device)


BLOCKS = {"dense": DenseBlock, "moe": MoEBlock, "ssm": Mamba1Block,
          "hybrid": Mamba2Block}


def shared_invocations(cfg) -> int:
    """A hybrid's shared-block invocations: one a group of
    ``shared_attn_period`` Mamba2 layers."""
    return cfg.num_layers // cfg.shared_attn_period


class DecoderLM(nn.Module):
    """embed, final_norm and ``cfg.num_layers`` blocks; a hybrid also has
    ``shared`` (``n_shared_blocks`` dense blocks) and ``shared_proj``, one
    (2d, d) projection of ``concat(x, x0)`` an invocation. With a
    generator the weights are drawn from it; without, they are left
    unfilled."""

    def __init__(self, cfg, generator=None, dtype=None, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.embed = init_embedding(cfg, generator, dtype, device)
        self.final_norm = init_norm(cfg, dtype, device)
        block = BLOCKS[cfg.arch_type]
        self.layers = nn.ModuleList(
            block(cfg, generator, dtype, device)
            for _ in range(cfg.num_layers))
        if cfg.arch_type == "hybrid":
            self.shared = nn.ModuleList(
                DenseBlock(cfg, generator, dtype, device)
                for _ in range(cfg.n_shared_blocks))
            d = cfg.d_model
            self.shared_proj = make_param(
                (shared_invocations(cfg), 2 * d, d), dtype, device)
            truncated_normal_(self.shared_proj, (2 * d) ** -0.5, generator)

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg, generator=None, *, device=None, dtype=None) -> DecoderLM:
    """A :class:`DecoderLM` with truncated-normal weights from
    ``generator`` (default: seed 0), made on ``device`` (default: the card;
    raises without one unless ``device='cpu'``) in ``dtype`` (default
    ``cfg.torch_dtype``)."""
    check_ported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return DecoderLM(cfg, generator, dtype or cfg.torch_dtype, dev)


def count_params_analytic(cfg, active_only=False) -> int:
    """Exact parameter count from the shapes on the meta device (nothing
    is allocated). ``active_only``: an MoE expert matrix counts
    ``top_k / num_experts`` of its size, truncated per matrix stacked over
    the layers, as the reference truncates its stacked leaves."""
    check_ported(cfg)
    model = DecoderLM(cfg, None, cfg.torch_dtype, torch.device("meta"))
    stacked = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        key = ".".join(parts[:1] + parts[2:]) if parts[0] == "layers" \
            else name
        stacked[key] = stacked.get(key, 0) + p.numel()
    total = 0
    for key, n in stacked.items():
        if active_only and cfg.moe and ".moe.w_" in f".{key}":
            n = int(n * cfg.top_k / cfg.num_experts)
        total += n
    return total


def _tokens(model, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=model.device)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _attention(cfg, lp, x, positions):
    """x plus the attention of its norm; the attention runs inside a
    profiler range named ``attention``."""
    xn = apply_norm(cfg, lp.norm1, x)
    with record_function("attention"):
        a = attention_block(cfg, lp.attn, xn, positions)
    return x + a


def _layer_fwd(cfg, lp, x, positions):
    """One block's prefill: (x, the MoE aux loss or None)."""
    h = _attention(cfg, lp, x, positions)
    hn = apply_norm(cfg, lp.norm2, h)
    if isinstance(lp, MoEBlock):
        ff, aux = moe_block(cfg, lp.moe, hn)
        return h + ff, aux["aux_loss"]
    return h + apply_mlp(cfg, lp.mlp, hn), None


@torch.no_grad()
def forward(cfg, model, batch, last_only=False):
    """Returns (logits (B, S, padded_vocab) f32, aux_loss scalar).

    ``batch["tokens"]`` (B, S) ints, optional ``batch["positions"]``
    (B, S). ``last_only=True`` (the prefill serving path) unembeds only
    the final position: (B, 1, padded_vocab). The aux loss is the MoE
    family's load-balancing loss summed over the layers; for the other
    families it is 0.
    """
    check_ported(cfg)
    tokens = _tokens(model, batch["tokens"])
    B, S = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = default_positions(cfg, B, S, device=tokens.device)
    else:
        positions = _tokens(model, positions)

    x = embed_tokens(cfg, model.embed, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    if cfg.arch_type == "ssm":
        for lp in model.layers:
            x = x + mb.mamba1_block(cfg, lp.mamba,
                                    apply_norm(cfg, lp.norm1, x))
    elif cfg.arch_type == "hybrid":
        x = _hybrid_forward(cfg, model, x, positions)
    else:
        for lp in model.layers:
            x, layer_aux = _layer_fwd(cfg, lp, x, positions)
            if layer_aux is not None:
                aux = aux + layer_aux
    x = apply_norm(cfg, model.final_norm, x)
    if last_only:
        x = x[:, -1:, :]
    return unembed(cfg, model.embed, x), aux


def _hybrid_forward(cfg, model, x, positions):
    """Zamba2-style: group g runs shared block ``g % n_shared_blocks`` on
    ``concat(x, x0) @ shared_proj[g]`` (its output, its own residual
    included, added to x), then its ``shared_attn_period`` Mamba2
    layers."""
    period = cfg.shared_attn_period
    x0 = x
    for g in range(shared_invocations(cfg)):
        sp = model.shared[g % cfg.n_shared_blocks]
        inp = torch.cat([x, x0], -1) @ model.shared_proj[g]
        x = x + _layer_fwd(cfg, sp, inp, positions)[0]
        for lp in model.layers[g * period:(g + 1) * period]:
            x = x + mb.mamba2_block(cfg, lp.mamba,
                                    apply_norm(cfg, lp.norm1, x))
    return x


# ---------------------------------------------------------------------------
# KV / SSM cache + single-token decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch, max_len, dtype=None, *, device=None):
    """``{"index": 0, "layers": {...}}``, each layer array stacked on a
    leading (num_layers,) axis as the JAX cache is: ``k``, ``v``, ``pos``
    for the dense and MoE families, ``conv`` (W-1 inputs, in ``dtype``)
    and ``ssm`` (f32) for the SSM and hybrid ones; a hybrid also has
    ``shared``: ``k``, ``v``, ``pos`` of each invocation, stacked on a
    leading (num_layers // shared_attn_period,) axis."""
    check_ported(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.torch_dtype
    at = cfg.arch_type
    cache = {"index": 0}
    if at == "ssm":
        cache["layers"] = mb.init_mamba1_cache(cfg, cfg.num_layers, batch,
                                               dtype, dev)
    elif at == "hybrid":
        cache["layers"] = mb.init_mamba2_cache(cfg, cfg.num_layers, batch,
                                               dtype, dev)
        cache["shared"] = init_kv_cache(cfg, shared_invocations(cfg), batch,
                                        max_len, dtype, dev)
    else:
        cache["layers"] = init_kv_cache(cfg, cfg.num_layers, batch, max_len,
                                        dtype, dev)
    return cache


def _layer_step(cfg, lp, x, lcache, index):
    h_attn, lcache = decode_attention(cfg, lp.attn,
                                      apply_norm(cfg, lp.norm1, x),
                                      lcache, index)
    h = x + h_attn
    hn = apply_norm(cfg, lp.norm2, h)
    if isinstance(lp, MoEBlock):
        # token-choice: each token runs its k experts, not the capacity
        # dispatch over all E; decode discards the aux loss
        return h + token_choice(cfg, lp.moe, hn)[0], lcache
    return h + apply_mlp(cfg, lp.mlp, hn), lcache


def _at(arrays, i):
    """Layer (or invocation) i's views of stacked cache arrays."""
    return {name: a[i] for name, a in arrays.items()}


def _block_step(cfg, lp, x, lcache, index):
    """One block's decode step; its cache views are updated in place."""
    if isinstance(lp, Mamba1Block):
        return x + mb.mamba1_step(cfg, lp.mamba, apply_norm(cfg, lp.norm1, x),
                                  lcache)[0]
    if isinstance(lp, Mamba2Block):
        return x + mb.mamba2_step(cfg, lp.mamba, apply_norm(cfg, lp.norm1, x),
                                  lcache)[0]
    return _layer_step(cfg, lp, x, lcache, index)[0]


def _hybrid_decode(cfg, model, x, cache, index):
    """:func:`_hybrid_forward` for one token: invocation g attends over its
    own rolling KV cache (``cache["shared"]`` at g)."""
    period = cfg.shared_attn_period
    x0 = x
    for g in range(shared_invocations(cfg)):
        sp = model.shared[g % cfg.n_shared_blocks]
        inp = torch.cat([x, x0], -1) @ model.shared_proj[g]
        x = x + _layer_step(cfg, sp, inp, _at(cache["shared"], g), index)[0]
        for i in range(g * period, (g + 1) * period):
            x = _block_step(cfg, model.layers[i], x, _at(cache["layers"], i),
                            index)
    return x


@torch.no_grad()
def decode_step(cfg, model, tokens, cache):
    """tokens: (B, 1) -> logits (B, 1, padded_vocab) f32, and the cache,
    updated in place (KV arrays written at slot ``index mod L``, SSM
    states replaced, its ``index`` advanced by one)."""
    check_ported(cfg)
    index = int(cache["index"])
    x = embed_tokens(cfg, model.embed, _tokens(model, tokens))
    if cfg.arch_type == "hybrid":
        x = _hybrid_decode(cfg, model, x, cache, index)
    else:
        for i, lp in enumerate(model.layers):
            x = _block_step(cfg, lp, x, _at(cache["layers"], i), index)
    x = apply_norm(cfg, model.final_norm, x)
    cache["index"] = index + 1
    return unembed(cfg, model.embed, x), cache
