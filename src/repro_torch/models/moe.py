"""Mixture-of-Experts FFN with top-k routing and capacity-bounded dispatch
(``repro/models/moe.py``).

Dispatch is index-based, as the JAX package's: the (token, choice) pairs of
one batch row are sorted by expert (a stable sort, so within an expert the
earlier token comes first), each pair's position in its expert's segment is
its rank there, and the first ``C`` pairs of each expert fill that expert's
``C`` buffer slots; the rest are dropped. Every batch row routes on its own
and keeps its own capacity ``C = ceil(S k cf / E)`` (GShard's group is the
batch row), so a row's routing never depends on another row's tokens.

The routing table of a row (:class:`Routing`) is the reference's
``_route_row`` batched over B: ``buf_tok`` (the token in each of the E*C
slots, ``S`` for an empty slot, which reads a zero row) and ``buf_w``, plus
``tok_slot``, each (token, choice)'s slot (``E*C`` if dropped). The combine
reads each token's k slots through ``tok_slot`` and sums them in choice
order in f32: the reference's scatter-add computes the same sum, but a
scatter-add on the card adds with atomics in an order that changes from run
to run; this one is fixed, so a forward repeats bit for bit.

The expert products are batched matrix products over the experts
(``torch.bmm``): the reference computes them as ``einsum``s, not in a
Pallas kernel. Single-token decode (:func:`token_choice`, and
:func:`moe_block_decode` with the aux loss) gathers each token's k expert
matrices, as the reference does, and runs one batched product per matrix
over the (token, choice) pairs: k d f weights a token, the active
parameters, instead of the capacity dispatch's E slots.

The router is f32 whatever the model's dtype and routes on f32 logits;
the experts take the model's dtype. Top-k takes the largest probabilities
and, between equal ones, the lower expert index first, as ``lax.top_k``
does: a stable descending sort (``torch.topk`` breaks ties otherwise).

:func:`moe_block` runs its parts inside ``torch.profiler.record_function``
ranges (``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``),
so a profile of a forward sums each part's device time by name; with no
profiler on, a range records nothing. Setting ``MoE.routes`` to a list
keeps the routing of each call of that layer.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from repro_torch.models.layers import make_param, truncated_normal_


class MoE(nn.Module):
    """``router`` (d, E) f32, ``w_gate`` / ``w_up`` (E, d, f) and
    ``w_down`` (E, f, d) in the model's dtype. ``routes``: None, or a list
    to which :func:`moe_block` appends ``(x, C, routing)`` of each call
    (a forward's routing tables, for checks)."""

    def __init__(self, cfg, dtype=None, device=None):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        self.router = make_param((d, E), torch.float32, device)
        self.w_gate = make_param((E, d, f), dtype, device)
        self.w_up = make_param((E, d, f), dtype, device)
        self.w_down = make_param((E, f, d), dtype, device)
        self.routes = None


def init_moe(cfg, generator, dtype=None, device=None) -> MoE:
    moe = MoE(cfg, dtype, device)
    std_in, std_out = cfg.d_model ** -0.5, cfg.d_ff ** -0.5
    truncated_normal_(moe.router, std_in, generator)
    truncated_normal_(moe.w_gate, std_in, generator)
    truncated_normal_(moe.w_up, std_in, generator)
    truncated_normal_(moe.w_down, std_out, generator)
    return moe


class Routing(NamedTuple):
    """The routing of B rows of S tokens over E experts at capacity C."""
    sel: torch.Tensor        # (B, S, k) experts, best first
    weights: torch.Tensor    # (B, S, k) f32, renormalised over the k
    buf_tok: torch.Tensor    # (B, E*C) token of each slot; S = empty
    buf_w: torch.Tensor      # (B, E*C) f32 weight of each slot; 0 = empty
    tok_slot: torch.Tensor   # (B, S, k) slot of each choice; E*C = dropped
    aux_loss: torch.Tensor   # (B,) f32 Switch load-balancing loss
    dropped: torch.Tensor    # (B,) f32 fraction of choices dropped


def capacity(cfg, S, capacity_factor=None) -> int:
    """Slots an expert has in one batch row of S tokens: the reference's
    float arithmetic, ``ceil(S k cf / E)``, at least 1."""
    cf = capacity_factor or cfg.capacity_factor
    return max(1, int(-(-S * cfg.top_k * cf // cfg.num_experts)))


def top_k(probs, k):
    """(values, indices) of the k largest along the last axis, largest
    first, the lower index first between equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router_probs(router, x):
    logits = x.float() @ router
    return torch.softmax(logits, -1)


def _renorm(weights):
    return weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)


def _balance_loss(probs, sel, E):
    """E * sum_e f_e p_e over the leading axis of probs (..., T, E) and
    sel (..., T, k): p_e the mean probability, f_e the share of choices."""
    lead = probs.shape[:-2]
    n = sel.shape[-2] * sel.shape[-1]
    flat = sel.reshape(*lead, n)
    counts = torch.zeros(*lead, E, dtype=torch.float32, device=probs.device)
    counts.scatter_add_(-1, flat, torch.ones_like(flat, dtype=torch.float32))
    return E * (probs.mean(-2) * (counts / n)).sum(-1)


def route(cfg, router, x, C) -> Routing:
    """Route every row of x (B, S, d) on its own at capacity C."""
    B, S, _ = x.shape
    E, k = cfg.num_experts, cfg.top_k
    dev = x.device
    probs = _router_probs(router, x)                       # (B, S, E)
    weights, sel = top_k(probs, k)
    weights = _renorm(weights)
    aux_loss = _balance_loss(probs, sel, E)

    A = S * k
    e_flat = sel.reshape(B, A)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_sorted = e_flat.gather(1, order)
    tok_sorted = order // k              # pair i is token i // k, choice i % k
    w_sorted = weights.reshape(B, A).gather(1, order)
    experts = torch.arange(E, device=dev).expand(B, E).contiguous()
    seg_start = torch.searchsorted(e_sorted, experts)      # left side
    pos = torch.arange(A, device=dev) - seg_start.gather(1, e_sorted)
    keep = pos < C
    slot = torch.where(keep, e_sorted * C + pos, E * C)    # E*C: overflow
    dropped = 1.0 - keep.float().mean(-1)

    buf_tok = torch.full((B, E * C + 1), S, dtype=torch.int64, device=dev)
    buf_tok.scatter_(1, slot, tok_sorted)
    buf_w = torch.zeros((B, E * C + 1), dtype=torch.float32, device=dev)
    buf_w.scatter_(1, slot, w_sorted)
    tok_slot = torch.empty_like(slot).scatter_(1, order, slot)
    return Routing(sel, weights, buf_tok[:, :-1], buf_w[:, :-1],
                   tok_slot.view(B, S, k), aux_loss, dropped)


def _dispatch(x, r, C):
    """Each slot's token row (the sentinel S reads zeros), gathered
    straight into expert-major order: (E, B*C, d), rows (b, c) of expert
    e at e*B*C + b*C + c."""
    B, S, d = x.shape
    E = r.buf_tok.shape[1] // C
    xpad = torch.cat([x, x.new_zeros(B, 1, d)], 1).reshape(B * (S + 1), d)
    base = torch.arange(B, device=x.device).view(B, 1, 1) * (S + 1)
    src = (r.buf_tok.view(B, E, C) + base).transpose(0, 1).reshape(-1)
    return xpad.index_select(0, src).view(E, B * C, d)


def _experts(moe, xe):
    """SwiGLU of every expert on its rows: xe (E, R, d) -> (E, R, d)."""
    g = F.silu(torch.bmm(xe, moe.w_gate))
    return torch.bmm(g * torch.bmm(xe, moe.w_up), moe.w_down)


def _combine(rows, weights, dtype):
    """sum_j weights[..., j] rows[..., j, :] in f32, in choice order."""
    return (rows.float() * weights.unsqueeze(-1)).sum(-2).to(dtype)


def _combine_slots(ye, r, C, dtype):
    """Each token's k slots of the experts' output ye (E, B*C, d), summed
    with their weights: (B, S, d). A dropped choice reads a zero row."""
    B, S, k = r.tok_slot.shape
    E, d = ye.shape[0], ye.shape[-1]
    s = r.tok_slot
    b = torch.arange(B, device=ye.device).view(B, 1, 1)
    row = torch.where(s < E * C, (s // C) * (B * C) + b * C + s % C,
                      E * B * C)
    yz = torch.cat([ye.reshape(E * B * C, d), ye.new_zeros(1, d)])
    rows = yz.index_select(0, row.reshape(-1)).view(B, S, k, d)
    return _combine(rows, r.weights, dtype)


def moe_block(cfg, moe, x, capacity_factor=None):
    """x: (B, S, d) -> (B, S, d), aux dict (``aux_loss``, ``dropped_frac``:
    means over the rows)."""
    C = capacity(cfg, x.shape[1], capacity_factor)
    with record_function("moe.route"):
        r = route(cfg, moe.router, x, C)
    if moe.routes is not None:
        moe.routes.append((x, C, r))
    with record_function("moe.dispatch"):
        xe = _dispatch(x, r, C)
    with record_function("moe.experts"):
        ye = _experts(moe, xe)
    del xe                      # the dispatch buffer, freed before the combine
    with record_function("moe.combine"):
        out = _combine_slots(ye, r, C, x.dtype)
    return out, {"aux_loss": r.aux_loss.mean(),
                 "dropped_frac": r.dropped.mean()}


def token_choice(cfg, moe, x):
    """Token-choice MoE for single-token decode: each token runs only its k
    experts, whose matrices are gathered per (token, choice) pair.

    x: (B, 1, d) -> (B, 1, d), and the router's probabilities (B, E) and
    choices (B, k).
    """
    B, S, d = x.shape
    if S != 1:
        raise ValueError(f"decode path: one token per sequence, got {S}")
    k = cfg.top_k
    xf = x.reshape(B, d)
    probs = _router_probs(moe.router, xf)                   # (B, E)
    weights, sel = top_k(probs, k)
    weights = _renorm(weights)

    pairs = sel.reshape(B * k)
    xk = xf.unsqueeze(1).expand(B, k, d).reshape(B * k, 1, d)
    g = F.silu(torch.bmm(xk, moe.w_gate[pairs]))           # (B*k, 1, f)
    h = g * torch.bmm(xk, moe.w_up[pairs])
    yk = torch.bmm(h, moe.w_down[pairs]).view(B, k, d)
    return _combine(yk, weights, x.dtype).view(B, 1, d), probs, sel


def moe_block_decode(cfg, moe, x):
    """x: (B, 1, d) -> (B, 1, d), aux dict (``aux_loss`` over the B tokens;
    ``dropped_frac`` 0: nothing is dropped): :func:`token_choice`, as
    the reference's ``moe_block_decode``."""
    y, probs, sel = token_choice(cfg, moe, x)
    return y, {"aux_loss": _balance_loss(probs, sel, cfg.num_experts),
               "dropped_frac": torch.zeros((), device=x.device)}
