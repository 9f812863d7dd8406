"""Rotary position embeddings (``repro/models/rope.py``): standard, partial
(ChatGLM 2d) and none.

All functions take q/k of shape (batch, seq, heads, head_dim) and integer
positions (batch, seq). M-RoPE (Qwen2-VL) comes with the VLM family and
raises "not yet ported".
"""
from __future__ import annotations

import torch


def _rope_angles(positions, dim, theta):
    # positions: (..., seq) -> (..., seq, dim/2)
    # theta stays a Python scalar (a kernel argument): a tensor made from
    # it would be a blocking host-to-device copy at every call
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / torch.pow(theta, exps)
    return positions.float()[..., None] * inv


def _apply_rotary(x, angles):
    # x: (..., seq, heads, head_dim); angles: (..., seq, head_dim/2)
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     -1).to(x.dtype)


def apply_rope(cfg, x, positions):
    """Dispatch on cfg.rope. x: (batch, seq, heads, head_dim)."""
    hd = x.shape[-1]
    if cfg.rope in ("none", "sinusoidal"):
        return x  # sinusoidal is additive, at the embedding
    if cfg.rope == "standard":
        return _apply_rotary(x, _rope_angles(positions, hd, cfg.rope_theta))
    if cfg.rope == "partial":
        # ChatGLM-style 2d RoPE: rotate only a fraction of head_dim
        rot = int(hd * cfg.rope_fraction)
        rot -= rot % 2
        xr, xp = x[..., :rot], x[..., rot:]
        xr = _apply_rotary(xr, _rope_angles(positions, rot, cfg.rope_theta))
        return torch.cat([xr, xp], -1)
    if cfg.rope == "mrope":
        raise NotImplementedError("mrope (the VLM family) is not yet ported "
                                  "to repro_torch")
    raise ValueError(cfg.rope)


def default_positions(cfg, batch, seq_len, offset=0, device=None):
    if cfg.rope == "mrope":
        raise NotImplementedError("mrope (the VLM family) is not yet ported "
                                  "to repro_torch")
    pos = torch.arange(offset, offset + seq_len, dtype=torch.int32,
                       device=device)
    return pos.expand(batch, seq_len)
