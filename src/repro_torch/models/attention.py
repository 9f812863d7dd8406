"""GQA attention with RoPE variants, sliding window and a KV cache
(``repro/models/attention.py``).

Prefill and forward attend through :func:`repro_torch.kernels.ops.
flash_attention` on every device: CUDA tensors launch the hand-written
flash kernel, CPU tensors take its plain version. There is no
``REPRO_ATTN_IMPL`` switch, so on the CPU the port computes what the JAX
function computes under ``REPRO_ATTN_IMPL=flash``, which equals the JAX
default (``full_attention``) wherever positions run 0..S-1, as in every
forward of the dense and MoE families. ``blockwise_attention`` (the JAX package's
memory workaround for training) waits for the training slice.

Single-token decode (:func:`decode_attention`) is plain torch, as the JAX
package's is plain jnp. Projections are flat (d_model -> heads *
head_dim) matrices in the JAX ``(in, out)`` orientation.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.layers import make_param, truncated_normal_
from repro_torch.models.rope import apply_rope

NEG_INF = -1e30


class Attention(nn.Module):
    """``wq`` (d, q_dim), ``wk``/``wv`` (d, kv_dim), ``wo`` (q_dim, d),
    and ``bq``/``bk``/``bv`` with ``cfg.qkv_bias``."""

    def __init__(self, cfg, dtype=None, device=None):
        super().__init__()
        d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
        self.wq = make_param((d, qd), dtype, device)
        self.wk = make_param((d, kvd), dtype, device)
        self.wv = make_param((d, kvd), dtype, device)
        self.wo = make_param((qd, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = make_param((qd,), dtype, device, 0.0)
            self.bk = make_param((kvd,), dtype, device, 0.0)
            self.bv = make_param((kvd,), dtype, device, 0.0)


def init_attention(cfg, generator, dtype=None, device=None) -> Attention:
    attn = Attention(cfg, dtype, device)
    std = cfg.d_model ** -0.5
    for w in (attn.wq, attn.wk, attn.wv):
        truncated_normal_(w, std, generator)
    truncated_normal_(attn.wo, cfg.q_dim ** -0.5, generator)
    return attn


def _project_qkv(cfg, attn, x):
    """Returns q (B,S,H,D), k/v (B,S,Hkv,D)."""
    B, S, _ = x.shape
    q = x @ attn.wq
    k = x @ attn.wk
    v = x @ attn.wv
    if cfg.qkv_bias:
        q, k, v = q + attn.bq, k + attn.bk, v + attn.bv
    q = q.view(B, S, cfg.num_heads, cfg.head_dim)
    k = k.view(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.view(B, S, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _gqa_scores(q, k):
    """q: (B,S,H,D), k: (B,T,Hkv,D) -> scores (B,H,S,T) with GQA groups."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k) / math.sqrt(D)
    return s.reshape(B, H, S, s.shape[-1])


def _gqa_combine(probs, v):
    B, H, S, T = probs.shape
    Hkv = v.shape[2]
    pg = probs.reshape(B, Hkv, H // Hkv, S, T)
    o = torch.einsum("bkgst,btkd->bskgd", pg, v)
    return o.reshape(B, S, H, v.shape[-1])


def attention_block(cfg, attn, x, positions):
    """Causal self-attention sub-layer: project, rope, attend (flash),
    project. Sliding-window configs (``cfg.attention == "sliding"``) mask
    to ``cfg.window``. The kernel masks by position index 0..S-1;
    ``positions`` feed RoPE.
    """
    q, k, v = _project_qkv(cfg, attn, x)
    q = apply_rope(cfg, q, positions)
    k = apply_rope(cfg, k, positions)
    # head-major views of the (B, S, H, D) projections: the kernel reads
    # them where they lie and writes o as a view of (B, S, H, D), so
    # neither side copies
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True,
                            window=cfg.window if cfg.attention == "sliding"
                            else 0)
    B, S = x.shape[:2]
    return o.transpose(1, 2).reshape(B, S, cfg.q_dim) @ attn.wo


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, layers, batch, max_len, dtype, device=None):
    """Zero K/V and ``pos = -1`` (empty) slots for ``layers`` layers:
    (layers, batch, L, Hkv, D) and (layers, batch, L), stacked as the JAX
    cache is. Sliding-window caches hold L = min(max_len, window) slots."""
    L = min(max_len, cfg.window) if cfg.attention == "sliding" else max_len
    kv = (layers, batch, L, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "pos": torch.full((layers, batch, L), -1, dtype=torch.int32,
                              device=device)}


def decode_attention(cfg, attn, x, cache, index: int):
    """One-token decode. x: (B, 1, d); index: absolute position.

    Writes the token's k, v and position into slot ``index mod L`` of
    ``cache`` in place (the JAX function returns a new cache) and returns
    (out, cache). Sliding-window caches are rolling buffers; masking is
    by absolute stored position, so wraparound is handled uniformly and
    empty slots (pos = -1) are always invalid.
    """
    B = x.shape[0]
    q, k, v = _project_qkv(cfg, attn, x)
    pos = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
    q = apply_rope(cfg, q, pos)
    k = apply_rope(cfg, k, pos)

    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    slot = index % ck.shape[1]
    ck[:, slot] = k[:, 0]
    cv[:, slot] = v[:, 0]
    cpos[:, slot] = index

    scores = _gqa_scores(q, ck).float()                 # (B,H,1,L)
    diff = index - cpos                                  # (B, L)
    valid = (cpos >= 0) & (diff >= 0)
    if cfg.attention == "sliding":
        valid &= diff < cfg.window
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, -1).to(x.dtype)
    o = _gqa_combine(probs, cv)
    return o.reshape(B, 1, cfg.q_dim) @ attn.wo, cache
