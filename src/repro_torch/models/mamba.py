"""Mamba1 (S6 selective scan) and Mamba2 (SSD) blocks
(``repro/models/mamba.py``).

The JAX functions keep their names here, at module level. Each block's
parameters are an ``nn.Module`` whose attribute names are the JAX dict's
keys (:class:`Mamba1`, :class:`Mamba2`); weights keep the ``(in, out)``
orientation (``y = x @ w``).

Dtypes follow the reference's casts: the projections and the causal
convolution run in the model's dtype; ``dt``, B, C, the scan and its
state are f32, and so are ``A_log`` and ``D`` (Mamba2's ``dt_bias`` too)
whatever the model's dtype.

Prefill is chunked as the reference's (``cfg.ssm_chunk`` positions a
chunk, the state carried across chunks):

* Mamba1: inside a chunk, the reference's ``lax.associative_scan`` of
  ``h_t = a_t h_{t-1} + b_t`` becomes a log-depth doubling scan over the
  chunk's positions (8 steps at 256), each combining ``(a_l a_r,
  a_r b_l + b_r)`` as the reference's ``op`` does. No closed form through
  ``exp(-cumsum(dt A))``, which overflows inside long chunks. The chunks
  run one after another, so the scan holds O(chunk x d_inner x d_state).
* Mamba2: the SSD dual form. The intra-chunk ``(chunk x chunk)`` products
  and each chunk's own state contribution are computed for all chunks at
  once; only the carry of the state across chunks is a loop.

The causal convolution is W shifted multiply-adds summed in f32 (never
``F.conv1d``, which on the card runs through cuDNN, in TF32 by default).
Decode is one token's state update, written into the cache in place.
Everything here is plain torch: the reference computes its scans outside
any Pallas kernel. Profiler ranges: ``ssm.proj`` (the projections),
``ssm.conv`` (the convolution) and ``ssm.scan`` (the scan with its skip
term ``D``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from repro_torch.models.layers import make_param, truncated_normal_


def _dt_rank(cfg) -> int:
    return max(1, -(-cfg.d_model // 16))


def _dt_bias(n, dtype, device) -> torch.Tensor:
    """softplus^-1(0.01): log(expm1(0.01)) in f32, then cast."""
    return torch.full((n,), 0.01, dtype=torch.float32,
                      device=device).expm1().log().to(dtype)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _tap_sum(taps, weight):
    """sum_j taps[j] * weight[:, j] in f32, in tap order: the causal
    convolution's sum, shared by prefill and decode."""
    w = weight.float()
    acc = taps[0] * w[:, 0]
    for j in range(1, w.shape[1]):
        acc.addcmul_(taps[j], w[:, j])
    return acc


def _causal_conv(x, weight, bias):
    """Depthwise causal conv. x: (B, L, C), weight: (C, W) -> (B, L, C) in
    x's dtype: the W taps summed in f32, rounded once, then the bias
    added."""
    L, W = x.shape[1], weight.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0)).float()
    y = _tap_sum([xp[:, j:j + L] for j in range(W)], weight)
    return y.to(x.dtype) + bias


def _conv_step(state, xt, weight, bias):
    """state: (B, W-1, C) previous inputs; xt: (B, C). Returns (y,
    new_state), y summed as :func:`_causal_conv` sums a position."""
    full = torch.cat([state, xt[:, None].to(state.dtype)], 1)   # (B, W, C)
    ff = full.float()
    y = _tap_sum([ff[:, j] for j in range(full.shape[1])], weight)
    return y.to(xt.dtype) + bias, full[:, 1:]


def _doubling_scan(a, b):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` (h_{-1} = 0) along
    axis 1: returns (a_cum, b_cum), a_cum[t] = a_0 ... a_t and b_cum[t] =
    h_t. Hillis-Steele doubling: at shift s, t >= s takes (a_{t-s} a_t,
    a_t b_{t-s} + b_t), the reference's ``op(l, r)`` with l the earlier
    window."""
    c = a.shape[1]
    s = 1
    while s < c:
        a_next, b_next = torch.empty_like(a), torch.empty_like(b)
        a_next[:, :s] = a[:, :s]
        b_next[:, :s] = b[:, :s]
        torch.mul(a[:, :-s], a[:, s:], out=a_next[:, s:])
        torch.addcmul(b[:, s:], a[:, s:], b[:, :-s], out=b_next[:, s:])
        a, b = a_next, b_next
        s *= 2
    return a, b


# ---------------------------------------------------------------------------
# Mamba1
# ---------------------------------------------------------------------------

class Mamba1(nn.Module):
    """``in_proj`` (d, 2 di), ``conv_w`` (di, W), ``conv_b``, ``x_proj``
    (di, R + 2N), ``dt_proj`` (R, di), ``dt_bias`` (di,), ``A_log`` (di, N)
    f32, ``D`` (di,) f32 and ``out_proj`` (di, d), R = ceil(d / 16)."""

    def __init__(self, cfg, dtype=None, device=None):
        super().__init__()
        d, di, N, W = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
        R = _dt_rank(cfg)
        self.in_proj = make_param((d, 2 * di), dtype, device)
        self.conv_w = make_param((di, W), dtype, device)
        self.conv_b = make_param((di,), dtype, device, 0.0)
        self.x_proj = make_param((di, R + 2 * N), dtype, device)
        self.dt_proj = make_param((R, di), dtype, device)
        self.dt_bias = make_param((di,), dtype, device)
        self.A_log = make_param((di, N), torch.float32, device)
        self.D = make_param((di,), torch.float32, device, 1.0)
        self.out_proj = make_param((di, d), dtype, device)


def init_mamba1(cfg, generator, dtype=None, device=None) -> Mamba1:
    m = Mamba1(cfg, dtype, device)
    if generator is None:
        return m
    d, di, N, W = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    R = _dt_rank(cfg)
    truncated_normal_(m.in_proj, d ** -0.5, generator)
    truncated_normal_(m.conv_w, W ** -0.5, generator)
    truncated_normal_(m.x_proj, di ** -0.5, generator)
    truncated_normal_(m.dt_proj, R ** -0.5, generator)
    truncated_normal_(m.out_proj, di ** -0.5, generator)
    with torch.no_grad():
        m.dt_bias.copy_(_dt_bias(di, m.dt_bias.dtype, m.dt_bias.device))
        A = torch.arange(1, N + 1, dtype=torch.float32, device=m.A_log.device)
        m.A_log.copy_(A.log().expand(di, N))
    return m


def _mamba1_inputs(cfg, params, x):
    """Common projection path. Returns (u, z, dt, Bc, Cc)."""
    di, N = cfg.d_inner, cfg.ssm_state
    R = _dt_rank(cfg)
    with record_function("ssm.proj"):
        xz = x @ params.in_proj
    u, z = xz[..., :di], xz[..., di:]              # (..., di) each
    with record_function("ssm.conv"):
        u = F.silu(_causal_conv(u, params.conv_w, params.conv_b))
    with record_function("ssm.proj"):
        proj = u @ params.x_proj                   # (B, L, R + 2N)
        Bc = proj[..., R:R + N].float()
        Cc = proj[..., R + N:].float()
        dt = F.softplus(proj[..., :R] @ params.dt_proj
                        + params.dt_bias).float()
    return u, z, dt, Bc, Cc


def _selective_scan(u, dt, A, Bc, Cc, chunk):
    """y (B, L, di) f32 of the selective scan from a zero state, chunk by
    chunk; a last chunk shorter than ``chunk`` is scanned as it is (the
    reference's zero padding leaves the state as it is)."""
    Bsz, L, di = u.shape
    y = torch.empty((Bsz, L, di), dtype=torch.float32, device=u.device)
    state = torch.zeros((Bsz, di, A.shape[1]), dtype=torch.float32,
                        device=u.device)
    for c0 in range(0, L, chunk):
        sl = slice(c0, min(L, c0 + chunk))
        dti = dt[:, sl]
        da = torch.exp(dti[..., None] * A)                   # (B, c, di, N)
        db = (dti * u[:, sl].float())[..., None] * Bc[:, sl, None, :]
        a_cum, b_cum = _doubling_scan(da, db)
        del da, db
        h = torch.addcmul(b_cum, a_cum, state[:, None])      # (B, c, di, N)
        del a_cum, b_cum
        y[:, sl] = (h @ Cc[:, sl, :, None])[..., 0]
        state = h[:, -1].clone()
        del h
    return y


def mamba1_block(cfg, params, x, chunk=None):
    """x: (B, L, d) -> (B, L, d) via the chunked selective scan."""
    chunk = chunk or cfg.ssm_chunk
    u, z, dt, Bc, Cc = _mamba1_inputs(cfg, params, x)
    with record_function("ssm.scan"):
        A = -torch.exp(params.A_log)               # (di, N), negative
        y = _selective_scan(u, dt, A, Bc, Cc, chunk)
        y = y + u.float() * params.D
    y = y.to(x.dtype) * F.silu(z)
    with record_function("ssm.proj"):
        return y @ params.out_proj


def init_mamba1_cache(cfg, layers, batch, dtype, device=None):
    """Zero conv inputs (layers, batch, W-1, di) in ``dtype`` and zero
    states (layers, batch, di, N) in f32, stacked as the JAX cache is."""
    return {"conv": torch.zeros((layers, batch, cfg.ssm_conv - 1,
                                 cfg.d_inner), dtype=dtype, device=device),
            "ssm": torch.zeros((layers, batch, cfg.d_inner, cfg.ssm_state),
                               dtype=torch.float32, device=device)}


def mamba1_step(cfg, params, x, cache):
    """x: (B, 1, d) single-token decode. ``cache`` (``conv`` (B, W-1, di),
    ``ssm`` (B, di, N)) is updated in place; returns (y (B, 1, d),
    cache)."""
    di, N = cfg.d_inner, cfg.ssm_state
    R = _dt_rank(cfg)
    xz = x[:, 0] @ params.in_proj
    u, z = xz[..., :di], xz[..., di:]              # (B, di)
    u, conv_state = _conv_step(cache["conv"], u, params.conv_w,
                               params.conv_b)
    u = F.silu(u)
    proj = u @ params.x_proj
    Bc = proj[..., R:R + N].float()
    Cc = proj[..., R + N:].float()
    dt = F.softplus(proj[..., :R] @ params.dt_proj + params.dt_bias).float()
    A = -torch.exp(params.A_log)
    da = torch.exp(dt[..., None] * A)                        # (B, di, N)
    db = (dt * u.float())[..., None] * Bc[:, None, :]
    h = torch.addcmul(db, da, cache["ssm"])
    y = (h @ Cc[:, :, None])[..., 0] + u.float() * params.D
    y = y.to(x.dtype) * F.silu(z)
    cache["conv"].copy_(conv_state)
    cache["ssm"].copy_(h)
    return (y @ params.out_proj)[:, None], cache


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

class Mamba2(nn.Module):
    """``in_proj`` (d, 2 di + 2N + H), ``conv_w`` (di + 2N, W),
    ``conv_b``, ``dt_bias``, ``A_log`` and ``D`` (H,) f32,
    ``norm_scale`` (di,) (the gated RMSNorm) and ``out_proj`` (di, d)."""

    def __init__(self, cfg, dtype=None, device=None):
        super().__init__()
        d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
        H, W = cfg.ssm_heads, cfg.ssm_conv
        conv_dim = di + 2 * N                      # x, B, C all convolved
        self.in_proj = make_param((d, 2 * di + 2 * N + H), dtype, device)
        self.conv_w = make_param((conv_dim, W), dtype, device)
        self.conv_b = make_param((conv_dim,), dtype, device, 0.0)
        self.dt_bias = make_param((H,), torch.float32, device)
        self.A_log = make_param((H,), torch.float32, device)
        self.D = make_param((H,), torch.float32, device, 1.0)
        self.norm_scale = make_param((di,), dtype, device, 1.0)
        self.out_proj = make_param((di, d), dtype, device)


def init_mamba2(cfg, generator, dtype=None, device=None) -> Mamba2:
    m = Mamba2(cfg, dtype, device)
    if generator is None:
        return m
    d, di, H, W = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_conv
    truncated_normal_(m.in_proj, d ** -0.5, generator)
    truncated_normal_(m.conv_w, W ** -0.5, generator)
    truncated_normal_(m.out_proj, di ** -0.5, generator)
    with torch.no_grad():
        m.dt_bias.copy_(_dt_bias(H, torch.float32, m.dt_bias.device))
        m.A_log.copy_(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                     device=m.A_log.device).log())
    return m


def _mamba2_inputs(cfg, params, x):
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    with record_function("ssm.proj"):
        zxbcdt = x @ params.in_proj
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * N]
    dt_in = zxbcdt[..., -H:]
    with record_function("ssm.conv"):
        xbc = F.silu(_causal_conv(xbc, params.conv_w, params.conv_b))
    u = xbc[..., :di]
    Bc = xbc[..., di:di + N].float()
    Cc = xbc[..., di + N:].float()
    dt = F.softplus(dt_in.float() + params.dt_bias)
    return u, z, dt, Bc, Cc


def _gated_rmsnorm(y, z, scale, eps=1e-5):
    y = y * F.silu(z.to(y.dtype))
    v = y.float()
    v = v * torch.rsqrt((v * v).mean(-1, keepdim=True) + eps)
    return (v * scale.float()).to(y.dtype)


def _ssd(cfg, u, dt, A, Bc, Cc, chunk):
    """The SSD dual form from a zero state: y (B, L, H, P) f32. Chunks are
    zero-padded to a multiple of ``chunk`` as in the reference (dt = 0
    there, so the state is left as it is)."""
    Bsz, L = u.shape[:2]
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    pad = (-L) % chunk
    if pad:
        u, dt, Bc, Cc = (F.pad(t, (0, 0, 0, pad)) for t in (u, dt, Bc, Cc))
    nc = (L + pad) // chunk
    # head-major chunks: xdt (B, nc, H, c, P), dt and its cumsum (B, nc, H, c)
    dth = dt.reshape(Bsz, nc, chunk, H).transpose(2, 3)
    xdt = u.float().reshape(Bsz, nc, chunk, H, P).transpose(2, 3) \
        * dth[..., None]
    Bcc = Bc.reshape(Bsz, nc, 1, chunk, N)
    Ccc = Cc.reshape(Bsz, nc, 1, chunk, N)
    cum = torch.cumsum(dth * A[:, None], dim=-1)            # (B, nc, H, c)
    # intra-chunk: M[i, j] = (C_i . B_j) exp(cum_i - cum_j), i >= j
    ii = torch.arange(chunk, device=u.device)
    later = ii[:, None] < ii[None, :]
    diff = cum[..., :, None] - cum[..., None, :]             # (B, nc, H, c, c)
    M = torch.exp(diff.masked_fill_(later, float("-inf")))
    M.mul_(Ccc @ Bcc.transpose(-1, -2))
    y = M @ xdt                                              # (B, nc, H, c, P)
    del M, diff
    # each chunk's own contribution to the state it passes on
    decay_out = torch.exp(cum[..., -1:] - cum)               # (B, nc, H, c)
    dBx = (xdt * decay_out[..., None]).transpose(-1, -2) @ Bcc   # (.., P, N)
    chunk_decay = torch.exp(cum[..., -1])                    # (B, nc, H)
    # the carry: the state entering each chunk, one chunk after another
    entering = torch.empty_like(dBx)
    state = torch.zeros_like(dBx[:, 0])                      # (B, H, P, N)
    for k in range(nc):
        entering[:, k] = state
        state = torch.addcmul(dBx[:, k], chunk_decay[:, k, :, None, None],
                              state)
    # inter-chunk: the entering state read by C, decayed to position i
    y += (Ccc @ entering.transpose(-1, -2)) * torch.exp(cum)[..., None]
    return y.transpose(2, 3).reshape(Bsz, L + pad, H, P)[:, :L]


def mamba2_block(cfg, params, x, chunk=None):
    """SSD dual form: intra-chunk (chunk x chunk) products + the state
    carried across chunks."""
    chunk = chunk or cfg.ssm_chunk
    Bsz, L, _ = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    u, z, dt, Bc, Cc = _mamba2_inputs(cfg, params, x)
    with record_function("ssm.scan"):
        A = -torch.exp(params.A_log)               # (H,)
        y = _ssd(cfg, u, dt, A, Bc, Cc, chunk)
        y = y + u.float().reshape(Bsz, L, H, P) * params.D[:, None]
    y = y.reshape(Bsz, L, cfg.d_inner).to(x.dtype)
    y = _gated_rmsnorm(y, z, params.norm_scale)
    with record_function("ssm.proj"):
        return y @ params.out_proj


def init_mamba2_cache(cfg, layers, batch, dtype, device=None):
    """Zero conv inputs (layers, batch, W-1, di + 2N) in ``dtype`` and
    zero states (layers, batch, H, P, N) in f32."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {"conv": torch.zeros((layers, batch, cfg.ssm_conv - 1, conv_dim),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((layers, batch, cfg.ssm_heads,
                                cfg.ssm_headdim, cfg.ssm_state),
                               dtype=torch.float32, device=device)}


def mamba2_step(cfg, params, x, cache):
    """x: (B, 1, d) single-token decode; ``cache`` (``conv`` (B, W-1,
    di + 2N), ``ssm`` (B, H, P, N)) is updated in place."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    zxbcdt = x[:, 0] @ params.in_proj
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * N]
    dt_in = zxbcdt[..., -H:]
    xbc, conv_state = _conv_step(cache["conv"], xbc, params.conv_w,
                                 params.conv_b)
    xbc = F.silu(xbc)
    u = xbc[..., :di].reshape(-1, H, P)
    Bc = xbc[..., di:di + N].float()
    Cc = xbc[..., di + N:].float()
    dt = F.softplus(dt_in.float() + params.dt_bias)          # (B, H)
    A = -torch.exp(params.A_log)
    da = torch.exp(dt * A)                                   # (B, H)
    dBx = (u.float() * dt[..., None])[..., None] * Bc[:, None, None, :]
    h = torch.addcmul(dBx, da[..., None, None], cache["ssm"])
    y = (h @ Cc[:, None, :, None])[..., 0] \
        + u.float() * params.D[:, None]
    y = y.reshape(-1, di).to(x.dtype)
    y = _gated_rmsnorm(y, z, params.norm_scale)
    cache["conv"].copy_(conv_state)
    cache["ssm"].copy_(h)
    return (y @ params.out_proj)[:, None], cache
