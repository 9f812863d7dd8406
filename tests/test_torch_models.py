"""The port's dense decoders against the JAX model zoo.

Each of the four dense smoke configs: JAX ``init_params(PRNGKey(0))``,
read as numpy, crosses into the port with
``repro_torch.convert.lm_params_from_jax``; the same numpy tokens then go
through both packages' ``forward`` and ``decode_step``. The JAX forward
runs twice: under its default attention (``full_attention``) and under
``REPRO_ATTN_IMPL=flash`` (the Pallas kernel in interpret mode); the port
on the CPU runs the flash kernel's plain version. Tolerance on f32
logits: rtol 1e-4 and atol 1e-5 times the logits' scale (their RMS, at
least 1): f32 sums in another order through two layers, and the softmax
in another form (the JAX default divides the scores by sqrt(Dh), the
flash path multiplies). The scale matters for olmo, whose tied
unembedding (embedding std 1) gives logits of RMS ~11, where a difference
of 1.4e-5 (1.3e-6 of the scale) falls on a logit of 0.0135.
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
from repro.models import layers as jlayers
from repro.models import rope as jrope
import repro_torch.configs as tcfgs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import (DecoderLM, count_params_analytic, decode_step,
                                forward, init_cache, init_params)
from repro_torch.models import layers as tlayers
from repro_torch.models import rope as trope

DENSE = ["olmo_1b", "chatglm3_6b", "phi3_medium_14b", "qwen2_5_32b"]
RTOL, ATOL = 1e-4, 1e-5
B, S = 2, 48


def assert_logits_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.sqrt(np.mean(want.astype(np.float64) ** 2))))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    jcfg = jcfgs.get_smoke_config(request.param)
    tcfg = tcfgs.get_smoke_config(request.param)
    params = jinit(jcfg, jax.random.PRNGKey(0))
    model = lm_params_from_jax(tcfg, _np_tree(params), device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, params, model, tokens


@pytest.mark.parametrize("arch", DENSE)
def test_configs_equal_jax(arch):
    for get in ("get_config", "get_smoke_config"):
        j = dataclasses.asdict(getattr(jcfgs, get)(arch))
        t = dataclasses.asdict(getattr(tcfgs, get)(arch))
        assert j == t
    assert tcfgs.get_config(arch.replace("_", "-")).name == \
        jcfgs.get_config(arch).name


@pytest.mark.parametrize("arch", DENSE)
def test_param_count_matches_jax_without_allocating(arch):
    cfg = tcfgs.get_config(arch)
    assert cfg.param_count() == count_params_analytic(cfg) == \
        jax_count(jcfgs.get_config(arch))
    if arch == "olmo_1b":
        assert cfg.param_count() == 1_176_764_416


def test_other_architectures_are_not_yet_ported():
    """The two families still unported (audio, VLM) raise; the MoE, SSM
    and hybrid families are ported (``tests/test_torch_moe.py``,
    ``tests/test_torch_mamba.py``)."""
    assert sorted(tcfgs.NOT_YET_PORTED) == sorted(
        set(jcfgs.ARCHS) - set(tcfgs.ARCHS)) == ["qwen2_vl_72b",
                                                  "whisper_medium"]
    for name in ("whisper-medium", "qwen2-vl-72b"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            tcfgs.get_config(name)
        with pytest.raises(NotImplementedError, match="audio and VLM"):
            tcfgs.get_smoke_config(name)
    with pytest.raises(KeyError):
        tcfgs.get_config("gpt-5")
    audio = tcfgs.get_smoke_config("olmo_1b").replace(arch_type="audio")
    for call in (lambda: init_params(audio, device="cpu"),
                 lambda: DecoderLM(audio),
                 lambda: init_cache(audio, 1, 8, device="cpu"),
                 lambda: count_params_analytic(audio)):
        with pytest.raises(NotImplementedError, match="audio and VLM"):
            call()


@pytest.mark.parametrize("impl", ["default", "flash"])
@pytest.mark.parametrize("last_only", [False, True])
def test_forward_matches_jax(pair, monkeypatch, impl, last_only):
    jcfg, tcfg, params, model, tokens = pair
    if impl == "flash":
        monkeypatch.setenv("REPRO_ATTN_IMPL", "flash")
    else:
        monkeypatch.delenv("REPRO_ATTN_IMPL", raising=False)
    want, _ = jforward(jcfg, params, {"tokens": jnp.asarray(tokens)},
                       last_only=last_only)
    got, aux = forward(tcfg, model, {"tokens": tokens}, last_only=last_only)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert got.shape == (B, 1 if last_only else S, tcfg.padded_vocab)
    assert_logits_close(got.numpy(), want)


def test_decode_steps_match_jax(pair):
    """8 teacher-forced decode steps: logits and the whole cache."""
    jcfg, tcfg, params, model, tokens = pair
    step = jax.jit(lambda p, t, c: jdecode(jcfg, p, t, c))
    jcache = jinit_cache(jcfg, B, 16, jnp.float32)
    cache = init_cache(tcfg, B, 16, device="cpu")
    fwd, _ = forward(tcfg, model, {"tokens": tokens[:, :8]})
    for t in range(8):
        want, jcache = step(params, jnp.asarray(tokens[:, t:t + 1]), jcache)
        got, cache = decode_step(tcfg, model, tokens[:, t:t + 1], cache)
        assert_logits_close(got.numpy(), want)
        assert_logits_close(got[:, 0].numpy(), fwd[:, t].numpy())
    assert cache["index"] == int(jcache["index"]) == 8
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["layers"][name].numpy(),
                                   np.asarray(jcache["layers"][name]),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(cache["layers"]["pos"].numpy(),
                                  np.asarray(jcache["layers"]["pos"]))


def test_sliding_window_forward_and_rolling_decode_match_jax():
    """A sliding-window variant of olmo's smoke config: the forward's
    window mask, and the decode cache's rolling slots (max_len 16 holds
    min(16, window = 6) slots, so 12 steps wrap around)."""
    jcfg = jcfgs.get_smoke_config("olmo_1b").replace(attention="sliding",
                                                     window=6)
    tcfg = tcfgs.get_smoke_config("olmo_1b").replace(attention="sliding",
                                                     window=6)
    params = jinit(jcfg, jax.random.PRNGKey(3))
    model = lm_params_from_jax(tcfg, _np_tree(params), device="cpu")
    tokens = np.random.default_rng(2).integers(0, 512, (B, 12))
    want, _ = jforward(jcfg, params, {"tokens": jnp.asarray(tokens)})
    got, _ = forward(tcfg, model, {"tokens": tokens})
    assert_logits_close(got.numpy(), want)
    jcache = jinit_cache(jcfg, B, 16, jnp.float32)
    cache = init_cache(tcfg, B, 16, device="cpu")
    assert cache["layers"]["k"].shape[2] == 6
    step = jax.jit(lambda p, t, c: jdecode(jcfg, p, t, c))
    for t in range(12):
        jl, jcache = step(params, jnp.asarray(tokens[:, t:t + 1]), jcache)
        tl, cache = decode_step(tcfg, model, tokens[:, t:t + 1], cache)
        assert_logits_close(tl.numpy(), jl)
        assert_logits_close(tl[:, 0].numpy(), got[:, t].numpy())
    np.testing.assert_array_equal(cache["layers"]["pos"].numpy(),
                                  np.asarray(jcache["layers"]["pos"]))


def _module_from(module, tree):
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(torch.from_numpy(np.asarray(tree[name])))
    return module


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparametric_ln"])
def test_norms_match_jax(norm):
    cfg = tcfgs.get_smoke_config("olmo_1b").replace(norm=norm)
    rng = np.random.default_rng(0)
    x = (3 + 2 * rng.standard_normal((2, 5, cfg.d_model))).astype(np.float32)
    p = {}
    if norm != "nonparametric_ln":
        p["scale"] = rng.uniform(0.5, 1.5, cfg.d_model).astype(np.float32)
    if norm == "layernorm":
        p["bias"] = rng.standard_normal(cfg.d_model).astype(np.float32)
    want = jlayers.apply_norm(cfg, p, jnp.asarray(x))
    mod = _module_from(tlayers.init_norm(cfg, torch.float32), p)
    got = tlayers.apply_norm(cfg, mod, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
def test_mlps_match_jax(mlp):
    cfg = tcfgs.get_smoke_config("olmo_1b").replace(mlp=mlp)
    p = _np_tree(jlayers.init_mlp(cfg, jax.random.PRNGKey(1), jnp.float32))
    if mlp == "gelu":     # nonzero biases
        p["b_in"] = np.full_like(p["b_in"], 0.1)
        p["b_out"] = np.full_like(p["b_out"], -0.2)
    x = np.random.default_rng(0).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32)
    want = jlayers.apply_mlp(cfg, p, jnp.asarray(x))
    mod = _module_from(tlayers.MLP(cfg, torch.float32), p)
    got = tlayers.apply_mlp(cfg, mod, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("tied", [True, False])
def test_embedding_and_unembedding_match_jax(tied):
    cfg = tcfgs.get_smoke_config("olmo_1b").replace(tie_embeddings=tied)
    p = _np_tree(jlayers.init_embedding(cfg, jax.random.PRNGKey(2),
                                        jnp.float32))
    mod = _module_from(tlayers.Embedding(cfg, torch.float32), p)
    tokens = np.array([[0, 5, 511], [7, 7, 3]], np.int32)
    np.testing.assert_array_equal(
        tlayers.embed_tokens(cfg, mod, torch.from_numpy(tokens)).numpy(),
        np.asarray(jlayers.embed_tokens(cfg, p, jnp.asarray(tokens))))
    h = np.random.default_rng(0).standard_normal(
        (2, 3, cfg.d_model)).astype(np.float32)
    got = tlayers.unembed(cfg, mod, torch.from_numpy(h))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jlayers.unembed(cfg, p, jnp.asarray(h))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rope,theta", [("standard", 1e4), ("standard", 1e6),
                                        ("partial", 1e4), ("none", 1e4)])
def test_rope_matches_jax(rope, theta):
    cfg = tcfgs.get_smoke_config("chatglm3_6b").replace(rope=rope,
                                                        rope_theta=theta)
    x = np.random.default_rng(0).standard_normal((2, 7, 3, 32)).astype(
        np.float32)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    want = jrope.apply_rope(cfg, jnp.asarray(x), jnp.asarray(pos))
    got = trope.apply_rope(cfg, torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(
        trope.default_positions(cfg, 2, 5, offset=3).numpy(),
        np.asarray(jrope.default_positions(cfg, 2, 5, offset=3)))


def test_bf16_params_cross_bit_for_bit():
    """bf16 (ml_dtypes) arrays cross as their uint16 bits."""
    jcfg = jcfgs.get_smoke_config("chatglm3_6b").replace(dtype="bfloat16")
    tcfg = tcfgs.get_smoke_config("chatglm3_6b").replace(dtype="bfloat16")
    params = _np_tree(jinit(jcfg, jax.random.PRNGKey(0)))
    model = lm_params_from_jax(tcfg, params, device="cpu")
    assert model.embed.embedding.dtype == torch.bfloat16
    got = model.layers[1].attn.wq.view(torch.int16).numpy()
    want = params["layers"]["attn"]["wq"][1].view(np.int16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(model.embed.unembed.float().numpy(),
                                  params["embed"]["unembed"].astype(
                                      np.float32))


def test_converter_refuses_mismatched_params():
    cfg = tcfgs.get_smoke_config("olmo_1b")
    params = _np_tree(jinit(jcfgs.get_smoke_config("olmo_1b"),
                            jax.random.PRNGKey(0)))
    bad = {**params, "layers": {**params["layers"], "extra": np.zeros(
        (cfg.num_layers, 3))}}
    with pytest.raises(KeyError, match="unexpected"):
        lm_params_from_jax(cfg, bad, device="cpu")
    with pytest.raises(ValueError, match="stacked layers"):
        lm_params_from_jax(cfg.replace(num_layers=3), params, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_jax(cfg.replace(d_ff=256), params, device="cpu")


def test_init_params_is_seeded_and_truncated():
    cfg = tcfgs.get_smoke_config("phi3_medium_14b")
    gen = lambda: torch.Generator().manual_seed(5)
    a = init_params(cfg, gen(), device="cpu")
    b = init_params(cfg, gen(), device="cpu")
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
        assert not p.requires_grad
    w = a.layers[0].attn.wq                       # std d ** -0.5, cut at 2 std
    std = cfg.d_model ** -0.5
    assert float(w.abs().max()) <= 2 * std
    assert abs(float(w.std()) / std - 0.88) < 0.05   # truncated-normal std
    assert a.embed.unembed.shape == (cfg.d_model, cfg.padded_vocab)
    c = init_params(cfg, torch.Generator().manual_seed(6), device="cpu")
    assert not torch.equal(a.layers[0].mlp.w_up, c.layers[0].mlp.w_up)


@pytest.mark.parametrize("arch,layers", [("olmo_1b", 16), ("chatglm3_6b", 2)])
def test_bf16_forward_within_bf16_rounding_of_f32(arch, layers):
    """The bf16 forward against the f32 forward on the same weights
    upcast, at the relative L2 limit (5e-2) that ``chip_smoke.py`` holds
    the card's bf16 prefill to: bf16 rounds every activation of every
    layer, so the limit is bf16-sized, and a wrongly wired attention
    breaks it."""
    cfg = tcfgs.get_smoke_config(arch).replace(num_layers=layers,
                                               dtype="bfloat16")
    f32 = cfg.replace(dtype="float32")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    up = DecoderLM(f32, None, torch.float32, torch.device("cpu"))
    up.load_state_dict(model.state_dict())
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 256))
    got = forward(cfg, model, {"tokens": tokens}, last_only=True)[0]
    want = forward(f32, up, {"tokens": tokens}, last_only=True)[0]
    assert got.dtype == want.dtype == torch.float32
    e = float((got - want).norm() / want.norm())
    assert 0 < e <= 5e-2, e
    # the same comparison with one layer's attention output zeroed
    # (a stand-in for a kernel wired wrongly inside the model) fails
    wo = model.layers[0].attn.wo
    saved = wo.clone()
    wo.zero_()
    bad = forward(cfg, model, {"tokens": tokens}, last_only=True)[0]
    wo.copy_(saved)
    assert float((bad - want).norm() / want.norm()) > 5e-2
