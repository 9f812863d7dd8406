"""The dense decoder family: init / forward / decode (``repro/models/model.py``).

``arch_type == "dense"``: a decoder-only transformer (GQA, a RoPE variant,
an MLP) as an ``nn.Module``, :class:`DecoderLM`, whose ``layers`` are an
``nn.ModuleList`` of blocks in place of the JAX package's stacked pytree
scanned with ``lax.scan``; its parameter names are the JAX dict's keys
(``layers.3.attn.wq`` is ``params["layers"]["attn"]["wq"][3]``). The
JAX functions keep their names here, at module level: :func:`init_params`,
:func:`forward`, :func:`init_cache`, :func:`decode_step` and
:func:`count_params_analytic`. The MoE, SSM, hybrid, audio and VLM
families raise "not yet ported".

``forward`` is the prefill of serving (``last_only=True`` unembeds only
the last position): every layer's self-attention is one launch of the
flash kernel on the card. ``decode_step`` attends over the KV cache in
plain torch and updates the cache in place.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.disco import resolve_device
from repro_torch.models.attention import (attention_block, decode_attention,
                                          init_attention, init_kv_cache)
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                       init_embedding, init_mlp, init_norm,
                                       unembed)
from repro_torch.models.rope import default_positions


def check_ported(cfg) -> None:
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} ({cfg.name}) is not yet ported to "
            f"repro_torch; the dense decoders are")


class DenseBlock(nn.Module):
    """One pre-norm block: norm1, attn, norm2, mlp."""

    def __init__(self, cfg, generator=None, dtype=None, device=None):
        super().__init__()
        self.norm1 = init_norm(cfg, dtype, device)
        self.attn = init_attention(cfg, generator, dtype, device)
        self.norm2 = init_norm(cfg, dtype, device)
        self.mlp = init_mlp(cfg, generator, dtype, device)


class DecoderLM(nn.Module):
    """embed, final_norm and ``cfg.num_layers`` blocks. With a generator
    the weights are drawn from it; without, they are left unfilled."""

    def __init__(self, cfg, generator=None, dtype=None, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.embed = init_embedding(cfg, generator, dtype, device)
        self.final_norm = init_norm(cfg, dtype, device)
        self.layers = nn.ModuleList(
            DenseBlock(cfg, generator, dtype, device)
            for _ in range(cfg.num_layers))

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


def count_params_analytic(cfg) -> int:
    """Exact parameter count from the shapes on the meta device (nothing
    is allocated)."""
    model = DecoderLM(cfg, None, cfg.torch_dtype, torch.device("meta"))
    return sum(p.numel() for p in model.parameters())


def _tokens(model, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=model.device)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _dense_layer_fwd(cfg, lp, x, positions):
    h = x + attention_block(cfg, lp.attn, apply_norm(cfg, lp.norm1, x),
                            positions)
    return h + apply_mlp(cfg, lp.mlp, apply_norm(cfg, lp.norm2, h))


@torch.no_grad()
def forward(cfg, model, batch, last_only=False):
    """Returns (logits (B, S, padded_vocab) f32, aux_loss scalar).

    ``batch["tokens"]`` (B, S) ints, optional ``batch["positions"]``
    (B, S). ``last_only=True`` (the prefill serving path) unembeds only
    the final position: (B, 1, padded_vocab). The aux loss is the MoE
    family's; for the dense family it is 0.
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
    for lp in model.layers:
        x = _dense_layer_fwd(cfg, lp, x, positions)
    x = apply_norm(cfg, model.final_norm, x)
    if last_only:
        x = x[:, -1:, :]
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return unembed(cfg, model.embed, x), aux


# ---------------------------------------------------------------------------
# KV cache + single-token decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch, max_len, dtype=None, *, device=None):
    """``{"index": 0, "layers": {"k", "v", "pos"}}``, each layer array
    stacked on a leading (num_layers,) axis as the JAX cache is."""
    check_ported(cfg)
    dev = resolve_device(device)
    return {"index": 0,
            "layers": init_kv_cache(cfg, cfg.num_layers, batch, max_len,
                                    dtype or cfg.torch_dtype, dev)}


def _dense_layer_step(cfg, lp, x, lcache, index):
    h_attn, lcache = decode_attention(cfg, lp.attn,
                                      apply_norm(cfg, lp.norm1, x),
                                      lcache, index)
    h = x + h_attn
    return h + apply_mlp(cfg, lp.mlp, apply_norm(cfg, lp.norm2, h)), lcache


@torch.no_grad()
def decode_step(cfg, model, tokens, cache):
    """tokens: (B, 1) -> logits (B, 1, padded_vocab) f32, and the cache,
    updated in place (its layer arrays written at slot ``index mod L``,
    its ``index`` advanced by one)."""
    check_ported(cfg)
    index = int(cache["index"])
    x = embed_tokens(cfg, model.embed, _tokens(model, tokens))
    layers = cache["layers"]
    for i, lp in enumerate(model.layers):
        lcache = {name: a[i] for name, a in layers.items()}
        x, _ = _dense_layer_step(cfg, lp, x, lcache, index)
    x = apply_norm(cfg, model.final_norm, x)
    cache["index"] = index + 1
    return unembed(cfg, model.embed, x), cache
