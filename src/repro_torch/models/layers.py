"""Shared layers: norms, MLPs, embeddings (``repro/models/layers.py``).

Conventions, as the JAX package's:
  * each ``init_*`` takes a ``torch.Generator`` and returns the layer's
    parameters as an ``nn.Module`` whose parameter names are the JAX
    dict's keys (``Norm.scale``, ``MLP.w_gate``, ...); with
    ``generator=None`` the parameters are left unfilled (shapes only, as
    on the meta device);
  * weights keep the JAX ``(in, out)`` orientation: ``y = x @ w``;
  * every ``apply_*`` is pure: (cfg, module, x, ...) -> y;
  * compute dtype follows x; norm statistics run in f32.

Parameters do not require gradients: the port serves, it does not train
yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def make_param(shape, dtype, device, fill=None) -> nn.Parameter:
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


def truncated_normal(generator, shape, std, dtype, device=None):
    """``std`` times a standard normal truncated to [-2, 2], drawn in f32
    from ``generator`` on ``device`` (default: the generator's) and cast
    to ``dtype`` (the
    distribution of ``repro.models.layers.truncated_normal``; its draws
    come from ``jax.random`` and cannot be reproduced bit for bit)."""
    w = torch.empty(shape, dtype=torch.float32,
                    device=generator.device if device is None else device)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    return w.to(dtype)


@torch.no_grad()
def truncated_normal_(param, std, generator):
    """Fill ``param`` with std * N(0, 1) truncated to [-2, 2] (as
    ``jax.random.truncated_normal(key, -2, 2)``), drawn in f32 from
    ``generator`` on the parameter's device, then cast."""
    if generator is None:
        return param
    param.copy_(truncated_normal(generator, param.shape, std,
                                 torch.float32, param.device))
    return param


# -- norms -------------------------------------------------------------------

class Norm(nn.Module):
    """rmsnorm (``scale``), layernorm (``scale``, ``bias``) or OLMo's
    non-parametric LayerNorm (no parameters)."""

    def __init__(self, cfg, dtype=None, device=None):
        super().__init__()
        if cfg.norm not in ("rmsnorm", "layernorm", "nonparametric_ln"):
            raise ValueError(cfg.norm)
        if cfg.norm in ("rmsnorm", "layernorm"):
            self.scale = make_param((cfg.d_model,), dtype, device, 1.0)
        if cfg.norm == "layernorm":
            self.bias = make_param((cfg.d_model,), dtype, device, 0.0)


def init_norm(cfg, dtype=None, device=None) -> Norm:
    return Norm(cfg, dtype, device)


def apply_norm(cfg, norm, x, eps=1e-5):
    xf = x.float()
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (y * norm.scale.float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if cfg.norm == "layernorm":
        y = y * norm.scale.float() + norm.bias.float()
    return y.to(x.dtype)


# -- MLPs --------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU (``w_gate``, ``w_up``, ``w_down``) or GELU (``w_in``,
    ``b_in``, ``w_out``, ``b_out``)."""

    def __init__(self, cfg, dtype=None, device=None, d_ff=None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        if cfg.mlp == "swiglu":
            self.w_gate = make_param((d, f), dtype, device)
            self.w_up = make_param((d, f), dtype, device)
            self.w_down = make_param((f, d), dtype, device)
        elif cfg.mlp == "gelu":
            self.w_in = make_param((d, f), dtype, device)
            self.b_in = make_param((f,), dtype, device, 0.0)
            self.w_out = make_param((f, d), dtype, device)
            self.b_out = make_param((d,), dtype, device, 0.0)
        else:
            raise ValueError(cfg.mlp)


def init_mlp(cfg, generator, dtype=None, device=None, d_ff=None) -> MLP:
    mlp = MLP(cfg, dtype, device, d_ff)
    d, f = cfg.d_model, d_ff or cfg.d_ff
    std_in, std_out = d ** -0.5, f ** -0.5
    if cfg.mlp == "swiglu":
        truncated_normal_(mlp.w_gate, std_in, generator)
        truncated_normal_(mlp.w_up, std_in, generator)
        truncated_normal_(mlp.w_down, std_out, generator)
    else:
        truncated_normal_(mlp.w_in, std_in, generator)
        truncated_normal_(mlp.w_out, std_out, generator)
    return mlp


def apply_mlp(cfg, mlp, x):
    if cfg.mlp == "swiglu":
        g = F.silu(x @ mlp.w_gate)
        return (g * (x @ mlp.w_up)) @ mlp.w_down
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ mlp.w_in + mlp.b_in, approximate="tanh")
    return h @ mlp.w_out + mlp.b_out


# -- embeddings --------------------------------------------------------------

class Embedding(nn.Module):
    """``embedding`` (padded_vocab, d), and ``unembed`` (d, padded_vocab)
    when the embeddings are not tied."""

    def __init__(self, cfg, dtype=None, device=None):
        super().__init__()
        self.embedding = make_param((cfg.padded_vocab, cfg.d_model), dtype,
                                    device)
        if not cfg.tie_embeddings:
            self.unembed = make_param((cfg.d_model, cfg.padded_vocab), dtype,
                                      device)


def init_embedding(cfg, generator, dtype=None, device=None) -> Embedding:
    emb = Embedding(cfg, dtype, device)
    truncated_normal_(emb.embedding, 1.0, generator)
    if not cfg.tie_embeddings:
        truncated_normal_(emb.unembed, cfg.d_model ** -0.5, generator)
    return emb


def embed_tokens(cfg, emb, tokens):
    return F.embedding(tokens, emb.embedding)


def unembed(cfg, emb, h):
    """Logits in f32: tied (h @ embedding^T) or untied (h @ unembed)."""
    w = emb.embedding.T if cfg.tie_embeddings else emb.unembed
    return (h @ w).float()
