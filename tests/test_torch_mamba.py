"""The port's SSM (Mamba1) and hybrid (Mamba2 + shared attention)
decoders against the JAX model zoo.

Both smoke configs (falcon-mamba-7b, zamba2-2.7b): JAX
``init_params(PRNGKey(0))``, read as numpy, crosses into the port with
``repro_torch.convert.lm_params_from_jax``; the same numpy inputs (from a
seed) then go through both packages. The blocks, ``forward`` and
``decode_step`` are held at rtol 1e-4 and atol 1e-5 (times the logits'
scale for logits), as the dense and MoE families are: the port's doubling
scan and all-chunks-at-once SSD products sum in another order than the
reference's ``associative_scan`` and per-chunk einsums. The causal
convolution sums its 4 taps in f32 as the reference's einsum does: rtol
1e-6, and atol 1e-6 times the output's scale (an einsum may sum the taps
in another order, which moves a sum that cancels by an ulp of its
terms). The reference's ``decode_step`` is jitted.
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
from repro.models import mamba as jmamba
import repro_torch.configs as tcfgs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import (DecoderLM, count_params_analytic, decode_step,
                                forward, init_cache, init_params)
from repro_torch.models import mamba as tmamba

SSM = ["falcon_mamba_7b", "zamba2_2_7b"]
RTOL, ATOL = 1e-4, 1e-5
CONV_RTOL = 1e-6
B = 2
S = 80                 # past zamba2-smoke's window (64) and 2 chunks of 32
PARAMS = {"falcon_mamba_7b": 7_272_665_088, "zamba2_2_7b": 2_645_497_760}


def _scale(want):
    return max(1.0, float(np.sqrt(np.mean(np.asarray(
        want, np.float64) ** 2))))


def assert_logits_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * _scale(want))


def assert_conv_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=CONV_RTOL,
                               atol=CONV_RTOL * _scale(want))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.fixture(scope="module", params=SSM)
def pair(request):
    jcfg = jcfgs.get_smoke_config(request.param)
    tcfg = tcfgs.get_smoke_config(request.param)
    params = jinit(jcfg, jax.random.PRNGKey(0))
    model = lm_params_from_jax(tcfg, _np_tree(params), device="cpu")
    tokens = _rng(1).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, params, model, tokens


def _layer(params, i=0):
    """Layer i's Mamba parameters as JAX arrays."""
    return {k: jnp.asarray(np.asarray(v[i]))
            for k, v in params["layers"]["mamba"].items()}


def _hidden(cfg, seed, s):
    return _rng(seed).standard_normal((B, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", SSM)
def test_configs_equal_jax(arch):
    for get in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(jcfgs, get)(arch)) == \
            dataclasses.asdict(getattr(tcfgs, get)(arch))
    name = {"falcon_mamba_7b": "falcon-mamba-7b",
            "zamba2_2_7b": "zamba2-2.7b"}[arch]
    assert tcfgs.get_config(name).arch_type == \
        {"falcon_mamba_7b": "ssm", "zamba2_2_7b": "hybrid"}[arch]


@pytest.mark.parametrize("arch", SSM)
def test_param_counts_match_jax_without_allocating(arch):
    cfg = tcfgs.get_config(arch)
    assert cfg.param_count() == count_params_analytic(cfg) == \
        jax_count(jcfgs.get_config(arch)) == PARAMS[arch]


@pytest.mark.parametrize("C,W,L", [(24, 4, 1), (40, 4, 19), (8, 2, 7)])
def test_causal_conv_and_step_match_jax(C, W, L):
    """The convolution over L positions, and one step from a nonzero
    window of W - 1 inputs, against the reference's einsums."""
    rng = _rng(C + W + L)
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    w = rng.standard_normal((C, W)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    want = jmamba._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tmamba._causal_conv(*map(torch.from_numpy, (x, w, b)))
    assert_conv_close(got, want)
    state = rng.standard_normal((B, W - 1, C)).astype(np.float32)
    xt = rng.standard_normal((B, C)).astype(np.float32)
    want_y, want_s = jmamba._conv_step(*map(jnp.asarray, (state, xt, w, b)))
    got_y, got_s = tmamba._conv_step(*map(torch.from_numpy,
                                          (state, xt, w, b)))
    assert_conv_close(got_y, want_y)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # the step is the convolution's last position of its window
    full = np.concatenate([state, xt[:, None]], 1)
    conv = tmamba._causal_conv(*map(torch.from_numpy, (full, w, b)))
    assert torch.equal(conv[:, -1], got_y)


def test_doubling_scan_is_the_recurrence_without_overflow():
    """The doubling scan against the recurrence stepped token by token,
    also where sum(dt A) within a chunk reaches -2,000 (a closed form
    through exp(-cumsum) would overflow there)."""
    rng = _rng(3)
    for scale in (0.1, 30.0):
        a = np.exp(-scale * rng.random((B, 67, 5, 3))).astype(np.float32)
        b = rng.standard_normal((B, 67, 5, 3)).astype(np.float32)
        a_cum, h = tmamba._doubling_scan(torch.from_numpy(a),
                                         torch.from_numpy(b))
        want, prod = np.zeros_like(b), np.ones_like(a[:, 0])
        state = np.zeros_like(b[:, 0])
        for t in range(a.shape[1]):
            state = a[:, t] * state + b[:, t]
            prod = prod * a[:, t]
            want[:, t] = state
            np.testing.assert_allclose(a_cum[:, t].numpy(), prod, rtol=1e-5,
                                       atol=1e-30)
        assert bool(torch.isfinite(h).all())
        np.testing.assert_allclose(h.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("L", [64, 50, 200], ids=["whole", "ragged",
                                                  "chunks"])
def test_mamba1_block_matches_jax(L):
    """L a multiple of the chunk (32), not one (the reference pads), and
    over several chunks with a ragged last one."""
    jcfg = jcfgs.get_smoke_config("falcon_mamba_7b")
    tcfg = tcfgs.get_smoke_config("falcon_mamba_7b")
    params = jinit(jcfg, jax.random.PRNGKey(0))
    model = lm_params_from_jax(tcfg, _np_tree(params), device="cpu")
    x = _hidden(tcfg, L, L)
    want = jmamba.mamba1_block(jcfg, _layer(params, 1), jnp.asarray(x))
    got = tmamba.mamba1_block(tcfg, model.layers[1].mamba,
                              torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("L", [64, 50, 200], ids=["whole", "ragged",
                                                  "chunks"])
def test_mamba2_block_matches_jax(L):
    jcfg = jcfgs.get_smoke_config("zamba2_2_7b")
    tcfg = tcfgs.get_smoke_config("zamba2_2_7b")
    params = jinit(jcfg, jax.random.PRNGKey(0))
    model = lm_params_from_jax(tcfg, _np_tree(params), device="cpu")
    x = _hidden(tcfg, L + 1, L)
    want = jmamba.mamba2_block(jcfg, _layer(params, 2), jnp.asarray(x))
    got = tmamba.mamba2_block(tcfg, model.layers[2].mamba,
                              torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_steps_match_jax_from_a_nonzero_cache(pair):
    """One decode step of layer 1's block from a random cache: output, the
    conv window and the state, the cache updated in place."""
    jcfg, tcfg, params, model, _ = pair
    ssm = tcfg.arch_type == "ssm"
    jinit_c = jmamba.init_mamba1_cache if ssm else jmamba.init_mamba2_cache
    shapes = {k: v.shape for k, v in jinit_c(jcfg, B, jnp.float32).items()}
    rng = _rng(9)
    cache = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    x = _hidden(tcfg, 10, 1)
    jstep = jmamba.mamba1_step if ssm else jmamba.mamba2_step
    tstep = tmamba.mamba1_step if ssm else tmamba.mamba2_step
    want, jnew = jstep(jcfg, _layer(params, 1), jnp.asarray(x),
                       {k: jnp.asarray(v) for k, v in cache.items()})
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, tnew = tstep(tcfg, model.layers[1].mamba, torch.from_numpy(x),
                      tcache)
    assert tnew is tcache
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    for k in shapes:
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jnew[k]),
                                   rtol=RTOL, atol=ATOL)
    assert not np.allclose(tcache["ssm"].numpy(), cache["ssm"])


@pytest.mark.parametrize("last_only", [False, True])
def test_forward_matches_jax(pair, last_only):
    jcfg, tcfg, params, model, tokens = pair
    want, jaux = jforward(jcfg, params, {"tokens": jnp.asarray(tokens)},
                          last_only=last_only)
    got, aux = forward(tcfg, model, {"tokens": tokens}, last_only=last_only)
    assert got.dtype == torch.float32
    assert got.shape == (B, 1 if last_only else S, tcfg.padded_vocab)
    assert_logits_close(got.numpy(), want)
    assert float(aux) == float(jaux) == 0.0


def test_decode_teacher_forced_matches_jax_and_forward(pair):
    """S decode steps of both packages and the port's forward over the
    same tokens: each step's logits against the reference's and the
    forward's at that position; the caches at the end (zamba2-smoke's
    rolling KV caches of 64 slots have wrapped)."""
    jcfg, tcfg, params, model, tokens = pair
    fwd, _ = forward(tcfg, model, {"tokens": tokens})
    step = jax.jit(lambda p, t, c: jdecode(jcfg, p, t, c))
    max_len = S + 8
    jcache = jinit_cache(jcfg, B, max_len, jnp.float32)
    cache = init_cache(tcfg, B, max_len, device="cpu")
    for t in range(S):
        want, jcache = step(params, jnp.asarray(tokens[:, t:t + 1]), jcache)
        got, cache = decode_step(tcfg, model, tokens[:, t:t + 1], cache)
        assert_logits_close(got.numpy(), want)
        assert_logits_close(got[:, 0].numpy(), fwd[:, t].numpy())
    assert cache["index"] == int(jcache["index"]) == S
    for part in [p for p in ("layers", "shared") if p in cache]:
        for name, a in cache[part].items():
            if name == "pos":
                np.testing.assert_array_equal(
                    a.numpy(), np.asarray(jcache[part][name]))
            else:
                np.testing.assert_allclose(
                    a.numpy(), np.asarray(jcache[part][name]), rtol=RTOL,
                    atol=ATOL)
    if tcfg.arch_type == "hybrid":
        assert cache["shared"]["k"].shape[2] == tcfg.window < S
        assert sorted(cache["shared"]["pos"][0, 0].tolist()) == \
            list(range(S - tcfg.window, S))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SSM)
def test_init_cache_shapes_and_dtypes(arch, dtype):
    jcfg = jcfgs.get_smoke_config(arch).replace(dtype=dtype)
    tcfg = tcfgs.get_smoke_config(arch).replace(dtype=dtype)
    want = jinit_cache(jcfg, 3, 100)
    got = init_cache(tcfg, 3, 100, device="cpu")
    assert sorted(got) == sorted(want)
    assert got["index"] == int(want["index"]) == 0
    for part in [p for p in got if p != "index"]:
        assert sorted(got[part]) == sorted(want[part])
        for name, a in got[part].items():
            w = want[part][name]
            assert tuple(a.shape) == w.shape, (part, name)
            assert str(a.dtype)[6:] == str(w.dtype), (part, name)
            assert bool((a == (-1 if name == "pos" else 0)).all())


def test_converter_takes_both_trees_and_refuses_a_cast():
    """bf16 trees cross bit for bit, the f32 leaves (A_log, D, a Mamba2
    block's dt_bias) staying f32, the hybrid's stacked shared blocks and
    its shared_proj included; an f32 A_log cast to bf16, a misshapen
    shared_proj and a missing shared block are refused."""
    for arch in SSM:
        jcfg = jcfgs.get_smoke_config(arch).replace(dtype="bfloat16")
        tcfg = tcfgs.get_smoke_config(arch).replace(dtype="bfloat16")
        params = _np_tree(jinit(jcfg, jax.random.PRNGKey(0)))
        model = lm_params_from_jax(tcfg, params, device="cpu")
        state = model.state_dict()
        mamba = params["layers"]["mamba"]
        for key, val in mamba.items():
            for i in (0, tcfg.num_layers - 1):
                got = state[f"layers.{i}.mamba.{key}"]
                assert str(got.dtype)[6:] == str(val.dtype), key
                np.testing.assert_array_equal(
                    got.view(torch.int16 if val.dtype.itemsize == 2
                             else torch.int32).numpy(),
                    val[i].view(np.int16 if val.dtype.itemsize == 2
                                else np.int32))
        f32 = {k for k, v in mamba.items() if v.dtype == np.float32}
        assert f32 == ({"A_log", "D"} if arch == "falcon_mamba_7b"
                       else {"A_log", "D", "dt_bias"})
        bad = {**params, "layers": {**params["layers"], "mamba": {
            **mamba, "A_log": mamba["A_log"].astype(mamba["in_proj"].dtype)}}}
        with pytest.raises(ValueError, match="A_log: dtype"):
            lm_params_from_jax(tcfg, bad, device="cpu")
        if arch == "zamba2_2_7b":
            np.testing.assert_array_equal(
                model.shared[1].attn.wq.view(torch.int16).numpy(),
                params["shared"]["attn"]["wq"][1].view(np.int16))
            np.testing.assert_array_equal(
                model.shared_proj.view(torch.int16).numpy(),
                params["shared_proj"].view(np.int16))
            assert model.shared_proj.shape == (2, 2 * tcfg.d_model,
                                               tcfg.d_model)
            with pytest.raises(ValueError, match="shared_proj: shape"):
                lm_params_from_jax(tcfg, {**params, "shared_proj": params[
                    "shared_proj"][:1]}, device="cpu")
            cut = jax.tree.map(lambda a: a[:1], params["shared"])
            with pytest.raises(ValueError, match="stacked shared"):
                lm_params_from_jax(tcfg, {**params, "shared": cut},
                                   device="cpu")


@pytest.mark.parametrize("arch", SSM)
def test_init_params_draws_the_ssm_weights(arch):
    """Seeded truncated normals for the projections; A_log, D and
    dt_bias are the reference's deterministic values, in its dtypes (to
    an ulp: the two packages' f32 logs round apart)."""
    cfg = tcfgs.get_smoke_config(arch).replace(dtype="bfloat16")
    a = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
        assert not p.requires_grad
    jparams = _np_tree(jinit(jcfgs.get_smoke_config(arch).replace(
        dtype="bfloat16"), jax.random.PRNGKey(0)))["layers"]["mamba"]
    m = a.layers[1].mamba
    for key in ("A_log", "D", "dt_bias", "conv_b"):
        got = getattr(m, key)
        assert str(got.dtype)[6:] == str(jparams[key].dtype), key
        np.testing.assert_allclose(got.float().numpy(),
                                   jparams[key][1].astype(np.float32),
                                   rtol=2 ** -23)
    d = cfg.d_model
    w, std = m.in_proj, d ** -0.5
    assert float(w.abs().max()) <= 2 * std * (1 + 2 ** -8)
    assert abs(float(w.float().std()) / std - 0.88) < 0.05
    assert not torch.equal(a.layers[0].mamba.in_proj, m.in_proj)
    if arch == "zamba2_2_7b":
        assert len(a.shared) == cfg.n_shared_blocks
        p = a.shared_proj
        assert p.shape == (2, 2 * d, d) and p.dtype == torch.bfloat16
        assert float(p.abs().max()) <= 2 * (2 * d) ** -0.5 * (1 + 2 ** -8)


@pytest.mark.parametrize("arch", SSM)
def test_bf16_forward_within_bf16_rounding_of_f32(arch):
    """The bf16 forward against the f32 forward on the same weights
    upcast, at the relative L2 limit (5e-2) the MoE family is held to; a
    block's output projection zeroed (a stand-in for a block wired
    wrongly) breaks it."""
    cfg = tcfgs.get_smoke_config(arch).replace(dtype="bfloat16")
    f32 = cfg.replace(dtype="float32")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    up = DecoderLM(f32, None, torch.float32, torch.device("cpu"))
    up.load_state_dict(model.state_dict())
    tokens = _rng(0).integers(0, cfg.vocab_size, (2, 150))
    got = forward(cfg, model, {"tokens": tokens}, last_only=True)[0]
    want = forward(f32, up, {"tokens": tokens}, last_only=True)[0]
    e = float((got - want).norm() / want.norm())
    assert 0 < e <= 5e-2, e
    out = model.layers[0].mamba.out_proj
    saved = out.clone()
    out.zero_()
    bad = forward(cfg, model, {"tokens": tokens}, last_only=True)[0]
    out.copy_(saved)
    assert float((bad - want).norm() / want.norm()) > 5e-2


def test_forward_runs_in_the_ssm_ranges(pair):
    """A profile of the forward sums each Mamba part under its range's
    name (``ssm.conv`` and ``ssm.scan`` once a layer, ``ssm.proj`` three
    times a Mamba1 layer and twice a Mamba2 one); the hybrid's shared
    attention runs once an invocation."""
    from torch.profiler import ProfilerActivity, profile
    _, tcfg, _, model, tokens = pair
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        forward(tcfg, model, {"tokens": tokens}, last_only=True)
    counts = {e.key: e.count for e in prof.key_averages()}
    L = tcfg.num_layers
    assert counts.get("ssm.conv") == counts.get("ssm.scan") == L
    if tcfg.arch_type == "ssm":
        assert counts.get("ssm.proj") == 3 * L
        assert "attention" not in counts
    else:
        assert counts.get("ssm.proj") == 2 * L
        assert counts.get("attention") == L // tcfg.shared_attn_period


def test_hybrid_shared_blocks_alternate_and_the_window_acts():
    """zamba2-smoke with four groups of one layer: group g runs shared
    block g % 2 (swapping the two blocks changes the logits); the window
    of 16 cuts from position 16 on."""
    cfg = tcfgs.get_smoke_config("zamba2_2_7b").replace(
        shared_attn_period=1, window=16)
    model = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    tokens = _rng(2).integers(0, cfg.vocab_size, (1, 40))
    base = forward(cfg, model, {"tokens": tokens})[0]
    full = forward(cfg.replace(attention="full"), model,
                   {"tokens": tokens})[0]
    assert torch.equal(base[:, :16], full[:, :16])
    assert not torch.allclose(base[:, 16:], full[:, 16:], rtol=1e-3)
    model.shared = torch.nn.ModuleList([model.shared[1], model.shared[0]])
    swapped = forward(cfg, model, {"tokens": tokens})[0]
    assert not torch.allclose(base, swapped, rtol=1e-3)
