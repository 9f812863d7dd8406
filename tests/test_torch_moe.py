"""The port's MoE decoders against the JAX model zoo.

Both MoE smoke configs (mixtral-8x7b, qwen3-moe-30b-a3b): JAX
``init_params(PRNGKey(0))``, read as numpy, crosses into the port with
``repro_torch.convert.lm_params_from_jax``; the same numpy inputs (B = 2,
S = 48, from a seed) then go through both packages.

The routing table is held to the reference's ``jax.vmap(_route_row)``
exactly: the experts each token selects, the token in every buffer slot
and so the tokens dropped past capacity (the stable sort's order); its
weights, the load-balancing loss and the dropped fraction at rtol 1e-6.
A capacity factor of 0.5 drops tokens, so the drop order is exercised.
The MoE blocks, ``forward`` and ``decode_step`` are held as
``tests/test_torch_models.py`` holds the dense family: rtol 1e-4, atol
1e-5 (times the logits' scale for logits).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import count_params_analytic as jax_count
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit
from repro.models import moe as jmoe
import repro_torch.configs as tcfgs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import (count_params_analytic, decode_step, forward,
                                init_cache, init_params)
from repro_torch.models import moe as tmoe

MOE = ["mixtral_8x7b", "qwen3_moe_30b_a3b"]
RTOL, ATOL = 1e-4, 1e-5
ROUTE_RTOL = 1e-6
B, S = 2, 48


def assert_logits_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.sqrt(np.mean(want.astype(np.float64) ** 2))))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module", params=MOE)
def pair(request):
    jcfg = jcfgs.get_smoke_config(request.param)
    tcfg = tcfgs.get_smoke_config(request.param)
    params = jinit(jcfg, jax.random.PRNGKey(0))
    model = lm_params_from_jax(tcfg, _np_tree(params), device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, params, model, tokens


def _layer0_moe(params):
    return {k: np.asarray(v[0]) for k, v in params["layers"]["moe"].items()}


def _hidden(cfg, seed, s=S):
    return np.random.default_rng(seed).standard_normal(
        (B, s, cfg.d_model)).astype(np.float32)


def _ref_route(jcfg, router, x, C):
    """The reference's routing of every row, with its top-k choices."""
    k = jcfg.top_k
    buf_tok, buf_w, aux, dropped = jax.vmap(
        lambda xr: jmoe._route_row(jcfg, router, xr, k, C))(x)
    probs = jax.nn.softmax(x.astype(jnp.float32) @ router, -1)
    _, sel = jax.lax.top_k(probs, k)
    return [np.asarray(a) for a in (sel, buf_tok, buf_w, aux, dropped)]


def _kept_pairs(buf_tok, S_, C):
    """(row, token, expert) of every filled slot."""
    b, i = np.nonzero(buf_tok != S_)
    return set(zip(b.tolist(), buf_tok[b, i].tolist(), (i // C).tolist()))


@pytest.mark.parametrize("arch", MOE)
def test_configs_equal_jax(arch):
    for get in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(jcfgs, get)(arch)) == \
            dataclasses.asdict(getattr(tcfgs, get)(arch))
    assert tcfgs.get_config(arch.replace("_", "-")).arch_type == "moe"


@pytest.mark.parametrize("arch", MOE)
def test_param_counts_match_jax_without_allocating(arch):
    cfg, jcfg = tcfgs.get_config(arch), jcfgs.get_config(arch)
    assert cfg.param_count() == count_params_analytic(cfg) == jax_count(jcfg)
    assert cfg.active_param_count() == \
        count_params_analytic(cfg, active_only=True) == \
        jax_count(jcfg, active_only=True) == jcfg.active_param_count()
    if arch == "qwen3_moe_30b_a3b":
        assert cfg.param_count() == 30_532_110_336
        assert cfg.active_param_count() == 3_353_020_416


@pytest.mark.parametrize("arch,S,cf,C", [
    ("mixtral_8x7b", 7, 1.25, 5), ("mixtral_8x7b", 7, 0.5, 2),
    ("qwen3_moe_30b_a3b", 1, 1.25, 1), ("qwen3_moe_30b_a3b", 5, 0.3, 1)])
def test_capacity_rounds_up_per_row(arch, S, cf, C):
    """ceil(S k cf / E) in the reference's float arithmetic, at least 1,
    where the quotient is not whole (smoke: E = 4, k = 2); and the full
    configs' capacities at the card's prefill lengths."""
    cfg = tcfgs.get_smoke_config(arch)
    k, E = cfg.top_k, cfg.num_experts
    assert tmoe.capacity(cfg, S, cf) == C == max(1, int(-(-S * k * cf // E)))
    assert tmoe.capacity(tcfgs.get_config("qwen3_moe_30b_a3b"), 4096) == 320
    assert tmoe.capacity(tcfgs.get_config("mixtral_8x7b"), 8192) == 2560


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("arch", MOE)
def test_routing_table_equals_reference(arch, cf):
    jcfg, tcfg = jcfgs.get_smoke_config(arch), tcfgs.get_smoke_config(arch)
    params = _np_tree(jinit(jcfg, jax.random.PRNGKey(0)))
    router = np.array(_layer0_moe(params)["router"])
    x = _hidden(tcfg, 3)
    E, k = tcfg.num_experts, tcfg.top_k
    C = tmoe.capacity(tcfg, S, cf)
    assert C == max(1, int(-(-S * k * cf // E)))
    sel, buf_tok, buf_w, aux, dropped = _ref_route(jcfg, jnp.asarray(router),
                                                   jnp.asarray(x), C)
    r = tmoe.route(tcfg, torch.from_numpy(router), torch.from_numpy(x), C)
    np.testing.assert_array_equal(r.sel.numpy(), sel)
    np.testing.assert_array_equal(r.buf_tok.numpy(), buf_tok)
    np.testing.assert_allclose(r.buf_w.numpy(), buf_w, rtol=ROUTE_RTOL)
    np.testing.assert_allclose(r.aux_loss.numpy(), aux, rtol=ROUTE_RTOL)
    np.testing.assert_allclose(r.dropped.numpy(), dropped, rtol=ROUTE_RTOL)
    # the dropped (token, choice) pairs are the reference's: every kept
    # pair sits in its slot of the table, every other choice is dropped
    slot = r.tok_slot.numpy()
    kept = {(b, t, int(r.sel[b, t, j])) for b, t, j in zip(
        *np.nonzero(slot < E * C))}
    assert kept == _kept_pairs(buf_tok, S, C)
    for b, t, j in zip(*np.nonzero(slot < E * C)):
        assert buf_tok[b, slot[b, t, j]] == t
    n_dropped = int((slot == E * C).sum())
    np.testing.assert_allclose(n_dropped / (B * S * k), dropped.mean(),
                               rtol=ROUTE_RTOL)
    if cf < 1:
        assert dropped.min() > 0 and n_dropped > 0
    # each row keeps its own capacity: a row routed alone is routed alike
    for b in range(B):
        alone = tmoe.route(tcfg, torch.from_numpy(router),
                           torch.from_numpy(x[b:b + 1]), C)
        np.testing.assert_array_equal(alone.buf_tok[0].numpy(), buf_tok[b])


@pytest.mark.parametrize("arch", MOE)
def test_routing_ties_take_the_lower_expert(arch):
    """A zero router makes every probability 1/E: both packages pick
    experts 0..k-1 for every token, and past capacity drop the later
    tokens (the stable sort keeps token order within an expert)."""
    jcfg, tcfg = jcfgs.get_smoke_config(arch), tcfgs.get_smoke_config(arch)
    router = np.zeros((tcfg.d_model, tcfg.num_experts), np.float32)
    x = _hidden(tcfg, 4)
    C = tmoe.capacity(tcfg, S)
    sel, buf_tok, buf_w, _, dropped = _ref_route(jcfg, jnp.asarray(router),
                                                 jnp.asarray(x), C)
    r = tmoe.route(tcfg, torch.from_numpy(router), torch.from_numpy(x), C)
    assert (r.sel.numpy() == np.arange(tcfg.top_k)).all()
    np.testing.assert_array_equal(r.sel.numpy(), sel)
    np.testing.assert_array_equal(r.buf_tok.numpy(), buf_tok)
    np.testing.assert_allclose(r.buf_w.numpy(), buf_w, rtol=ROUTE_RTOL)
    assert np.array_equal(buf_tok[:, :C], np.tile(np.arange(C), (B, 1)))
    assert dropped.min() > 0
    np.testing.assert_array_equal(r.dropped.numpy(), dropped)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_block_matches_reference(pair, cf):
    jcfg, tcfg, params, model, _ = pair
    p = _layer0_moe(_np_tree(params))
    x = _hidden(tcfg, 5)
    want, jaux = jmoe.moe_block(jcfg, {k: jnp.asarray(v) for k, v in
                                       p.items()}, jnp.asarray(x),
                                capacity_factor=cf)
    got, aux = tmoe.moe_block(tcfg, model.layers[0].moe, torch.from_numpy(x),
                              capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    for key in ("aux_loss", "dropped_frac"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   rtol=ROUTE_RTOL)
    again, _ = tmoe.moe_block(tcfg, model.layers[0].moe, torch.from_numpy(x),
                              capacity_factor=cf)
    assert torch.equal(got, again)


def test_moe_block_decode_matches_reference(pair):
    jcfg, tcfg, params, model, _ = pair
    p = {k: jnp.asarray(v) for k, v in _layer0_moe(_np_tree(params)).items()}
    x = _hidden(tcfg, 6, s=1)
    want, jaux = jmoe.moe_block_decode(jcfg, p, jnp.asarray(x))
    got, aux = tmoe.moe_block_decode(tcfg, model.layers[0].moe,
                                     torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux["aux_loss"]),
                               float(jaux["aux_loss"]), rtol=ROUTE_RTOL)
    assert float(aux["dropped_frac"]) == 0.0
    bare, _, sel = tmoe.token_choice(tcfg, model.layers[0].moe,
                                     torch.from_numpy(x))
    assert torch.equal(bare, got)
    assert sel.shape == (B, tcfg.top_k)
    with pytest.raises(ValueError, match="one token"):
        tmoe.moe_block_decode(tcfg, model.layers[0].moe,
                              torch.from_numpy(_hidden(tcfg, 6, s=2)))


@pytest.mark.parametrize("impl", ["default", "flash"])
@pytest.mark.parametrize("last_only", [False, True])
def test_forward_matches_jax(pair, monkeypatch, impl, last_only):
    jcfg, tcfg, params, model, tokens = pair
    if impl == "flash":
        monkeypatch.setenv("REPRO_ATTN_IMPL", "flash")
    else:
        monkeypatch.delenv("REPRO_ATTN_IMPL", raising=False)
    want, jaux = jforward(jcfg, params, {"tokens": jnp.asarray(tokens)},
                          last_only=last_only)
    got, aux = forward(tcfg, model, {"tokens": tokens}, last_only=last_only)
    assert got.dtype == torch.float32
    assert got.shape == (B, 1 if last_only else S, tcfg.padded_vocab)
    assert_logits_close(got.numpy(), want)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def _teacher_forced(jcfg, tcfg, params, model, tokens, steps, max_len):
    """``steps`` decode steps of both packages on ``tokens`` and the
    port's forward over the same tokens: each step's logits against the
    reference's and against the forward's at that position."""
    fwd, _ = forward(tcfg, model, {"tokens": tokens[:, :steps]})
    jfwd, _ = jforward(jcfg, params, {"tokens": jnp.asarray(
        tokens[:, :steps])})
    assert_logits_close(fwd.numpy(), jfwd)
    step = jax.jit(lambda p, t, c: jdecode(jcfg, p, t, c))
    jcache = jinit_cache(jcfg, B, max_len, jnp.float32)
    cache = init_cache(tcfg, B, max_len, device="cpu")
    for t in range(steps):
        want, jcache = step(params, jnp.asarray(tokens[:, t:t + 1]), jcache)
        got, cache = decode_step(tcfg, model, tokens[:, t:t + 1], cache)
        assert_logits_close(got.numpy(), want)
        assert_logits_close(got[:, 0].numpy(), fwd[:, t].numpy())
    assert cache["index"] == int(jcache["index"]) == steps
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["layers"][name].numpy(),
                                   np.asarray(jcache["layers"][name]),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(cache["layers"]["pos"].numpy(),
                                  np.asarray(jcache["layers"]["pos"]))
    return cache


@pytest.mark.parametrize("arch", MOE)
def test_decode_teacher_forced_matches_jax_and_forward(arch):
    """At capacity_factor 4.0 (E / k = 2 here, so C = 2 S and nothing is
    dropped) the prefill equals the token-choice decode replay, as in
    the reference's own test."""
    jcfg = jcfgs.get_smoke_config(arch).replace(capacity_factor=4.0)
    tcfg = tcfgs.get_smoke_config(arch).replace(capacity_factor=4.0)
    params = jinit(jcfg, jax.random.PRNGKey(0))
    model = lm_params_from_jax(tcfg, _np_tree(params), device="cpu")
    tokens = np.random.default_rng(7).integers(0, tcfg.vocab_size, (B, 12))
    _teacher_forced(jcfg, tcfg, params, model, tokens, 12, 16)


def test_mixtral_window_and_rolling_cache_match_jax():
    """mixtral's smoke config at window 16: the forward's window mask acts
    from position 16 on, and 24 decode steps wrap the 16-slot cache."""
    jcfg = jcfgs.get_smoke_config("mixtral_8x7b").replace(
        window=16, capacity_factor=4.0)
    tcfg = tcfgs.get_smoke_config("mixtral_8x7b").replace(
        window=16, capacity_factor=4.0)
    assert tcfg.attention == "sliding"
    params = jinit(jcfg, jax.random.PRNGKey(2))
    model = lm_params_from_jax(tcfg, _np_tree(params), device="cpu")
    tokens = np.random.default_rng(8).integers(0, tcfg.vocab_size, (B, 24))
    cache = _teacher_forced(jcfg, tcfg, params, model, tokens, 24, 32)
    assert cache["layers"]["k"].shape[2] == 16
    assert sorted(cache["layers"]["pos"][0, 0].tolist()) == list(range(8, 24))
    # the mask matters: the same forward without a window differs
    full, _ = forward(tcfg.replace(attention="full"), model,
                      {"tokens": tokens})
    windowed, _ = forward(tcfg, model, {"tokens": tokens})
    assert torch.equal(full[:, :16], windowed[:, :16])
    assert not torch.allclose(full[:, 16:], windowed[:, 16:], rtol=1e-3)


def test_bf16_router_stays_f32_and_crosses_exactly():
    jcfg = jcfgs.get_smoke_config("qwen3_moe_30b_a3b").replace(
        dtype="bfloat16")
    tcfg = tcfgs.get_smoke_config("qwen3_moe_30b_a3b").replace(
        dtype="bfloat16")
    params = _np_tree(jinit(jcfg, jax.random.PRNGKey(0)))
    assert params["layers"]["moe"]["router"].dtype == np.float32
    model = lm_params_from_jax(tcfg, params, device="cpu")
    moe = model.layers[1].moe
    assert moe.router.dtype == torch.float32
    assert moe.w_gate.dtype == torch.bfloat16
    np.testing.assert_array_equal(moe.router.numpy(),
                                  params["layers"]["moe"]["router"][1])
    np.testing.assert_array_equal(
        moe.w_down.view(torch.int16).numpy(),
        params["layers"]["moe"]["w_down"][1].view(np.int16))
    mine = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert mine.layers[0].moe.router.dtype == torch.float32
    assert mine.layers[0].moe.w_up.dtype == torch.bfloat16
    logits, aux = forward(tcfg, mine, {"tokens": np.ones((1, 8), np.int64)},
                          last_only=True)
    assert bool(logits.isfinite().all()) and bool(aux.isfinite())


def test_converter_refuses_a_router_of_another_dtype():
    """``p.copy_`` would cast silently: a bf16 router in a bf16 model, or
    an f32 expert in one, is refused."""
    jcfg = jcfgs.get_smoke_config("mixtral_8x7b").replace(dtype="bfloat16")
    tcfg = tcfgs.get_smoke_config("mixtral_8x7b").replace(dtype="bfloat16")
    params = _np_tree(jinit(jcfg, jax.random.PRNGKey(0)))
    moe = params["layers"]["moe"]
    bad = {**params, "layers": {**params["layers"], "moe": {
        **moe, "router": moe["router"].astype(moe["w_gate"].dtype)}}}
    with pytest.raises(ValueError, match="router: dtype"):
        lm_params_from_jax(tcfg, bad, device="cpu")
    bad = {**params, "layers": {**params["layers"], "moe": {
        **moe, "w_up": moe["w_up"].astype(np.float32)}}}
    with pytest.raises(ValueError, match="w_up: dtype"):
        lm_params_from_jax(tcfg, bad, device="cpu")
    f32 = _np_tree(jinit(jcfg.replace(dtype="float32"),
                         jax.random.PRNGKey(0)))
    model = lm_params_from_jax(tcfg.replace(dtype="float32"), f32,
                               device="cpu")
    assert model.layers[0].moe.w_up.dtype == torch.float32


def test_init_params_draws_the_moe_weights():
    cfg = tcfgs.get_smoke_config("qwen3_moe_30b_a3b")
    a = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
        assert not p.requires_grad
    moe = a.layers[0].moe
    assert moe.router.shape == (cfg.d_model, cfg.num_experts)
    assert moe.w_down.shape == (cfg.num_experts, cfg.d_ff, cfg.d_model)
    for w, std in ((moe.router, cfg.d_model ** -0.5),
                   (moe.w_gate, cfg.d_model ** -0.5),
                   (moe.w_down, cfg.d_ff ** -0.5)):
        assert float(w.abs().max()) <= 2 * std
        assert abs(float(w.std()) / std - 0.88) < 0.05
    assert not torch.equal(a.layers[0].moe.w_gate[0], a.layers[0].moe.w_gate[1])
    assert not hasattr(a.layers[0], "mlp")


def test_forward_keeps_each_layers_routing_when_asked(pair):
    """With ``MoE.routes`` a list, a forward appends each layer's input,
    capacity and routing, equal to routing that input directly; with None
    (the default) nothing is kept. A profile of the forward sums each MoE
    part and each layer's attention under its range's name."""
    from torch.profiler import ProfilerActivity, profile
    _, tcfg, _, model, tokens = pair
    moes = [layer.moe for layer in model.layers]
    assert all(m.routes is None for m in moes)
    for m in moes:
        m.routes = []
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got, _ = forward(tcfg, model, {"tokens": tokens})
        recorded = [m.routes for m in moes]
    finally:
        for m in moes:
            m.routes = None
    C = tmoe.capacity(tcfg, S)
    for m, calls in zip(moes, recorded):
        assert len(calls) == 1
        x, c, r = calls[0]
        assert x.shape == (B, S, tcfg.d_model) and c == C
        want = tmoe.route(tcfg, m.router, x, C)
        for name in ("sel", "buf_tok", "tok_slot", "buf_w", "dropped"):
            assert torch.equal(getattr(r, name), getattr(want, name)), name
    again, _ = forward(tcfg, model, {"tokens": tokens})
    assert torch.equal(got, again)
    assert all(m.routes is None for m in moes)
    counts = {e.key: e.count for e in prof.key_averages()}
    for name in ("moe.route", "moe.dispatch", "moe.experts", "moe.combine",
                 "attention"):
        assert counts.get(name) == tcfg.num_layers, name
