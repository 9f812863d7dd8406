"""The port's serving engines against the JAX package's (the dense, MoE,
SSM and hybrid smoke configs), and the serving properties of
``tests/test_serve.py`` on the port.

The JAX engines and the port's run on the same parameters (JAX
``init_params(PRNGKey(0))`` read as numpy, crossed with
``lm_params_from_jax``) and must emit the same greedy tokens: logits agree
to ~1e-6 of their scale (``tests/test_torch_models.py``), far inside the
gaps between a random model's top logits. Everything runs on the CPU.
"""
import jax
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import init_params as jinit
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
import repro_torch.configs as tcfgs
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve as launcher
from repro_torch.serve import (ContinuousEngine, Engine, Request,
                               make_serve_step)

ARCHS = ["olmo_1b", "chatglm3_6b", "qwen3_moe_30b_a3b", "mixtral_8x7b",
         "falcon_mamba_7b", "zamba2_2_7b"]
REQUESTS = [([5, 6, 7], 6), ([9, 8], 4), ([3], 5)]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg = jcfgs.get_smoke_config(request.param)
    tcfg = tcfgs.get_smoke_config(request.param)
    params = jinit(jcfg, jax.random.PRNGKey(0))
    model = lm_params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                               device="cpu")
    return jcfg, tcfg, params, model


def test_engine_greedy_tokens_match_jax(pair):
    jcfg, tcfg, params, model = pair
    want = JEngine(jcfg, params, batch_size=3, max_len=32).generate(
        [JRequest(prompt=p, max_new_tokens=n) for p, n in REQUESTS])
    got = Engine(tcfg, model, batch_size=3, max_len=32).generate(
        [Request(prompt=p, max_new_tokens=n) for p, n in REQUESTS])
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [c.steps for c in got] == [c.steps for c in want]
    assert [len(c.tokens) for c in got] == [n for _, n in REQUESTS]


def test_continuous_engine_matches_jax(pair):
    """Five requests over two slots: the same tokens per request and the
    same number of ticks."""
    jcfg, tcfg, params, model = pair
    reqs = REQUESTS + [([1, 2, 3, 4], 3), ([11], 2)]
    jeng = JContinuousEngine(jcfg, params, batch_size=2, max_len=64)
    eng = ContinuousEngine(tcfg, model, batch_size=2, max_len=64)
    for p, n in reqs:
        jeng.submit(JRequest(prompt=p, max_new_tokens=n))
        eng.submit(Request(prompt=p, max_new_tokens=n))
    want, got = jeng.run_until_done(), eng.run_until_done()
    assert sorted(got) == sorted(want) == list(range(len(reqs)))
    for rid in want:
        assert got[rid].tokens == want[rid].tokens
        assert got[rid].steps == want[rid].steps
    assert eng.ticks == jeng.ticks
    assert not eng.waiting and not any(s.active for s in eng.slots)


def _cfg():
    return tcfgs.get_smoke_config("olmo_1b").replace(dtype="float32")


def test_greedy_decode_deterministic():
    outs = []
    for _ in range(2):
        eng = Engine(_cfg(), batch_size=2, max_len=64, seed=0, device="cpu")
        outs.append(eng.generate([Request(prompt=[1, 2, 3],
                                          max_new_tokens=6)])[0].tokens)
    assert outs[0] == outs[1]
    assert len(outs[0]) == 6
    assert all(0 <= t < _cfg().vocab_size for t in outs[0])


def test_batched_requests_match_single():
    """A request decoded alone equals the same request in a batch."""
    eng1 = Engine(_cfg(), batch_size=2, max_len=64, seed=0, device="cpu")
    solo = eng1.generate([Request(prompt=[5, 6, 7], max_new_tokens=5)])
    eng2 = Engine(_cfg(), batch_size=2, max_len=64, seed=0, device="cpu")
    pair = eng2.generate([Request(prompt=[5, 6, 7], max_new_tokens=5),
                          Request(prompt=[9, 8], max_new_tokens=5)])
    assert solo[0].tokens == pair[0].tokens


def test_eos_stops_generation():
    eng = Engine(_cfg(), batch_size=1, max_len=64, seed=0, device="cpu")
    free = eng.generate([Request(prompt=[1, 2], max_new_tokens=8)])
    first = free[0].tokens[0]
    stopped = eng.generate([Request(prompt=[1, 2], max_new_tokens=8,
                                    eos_id=int(first))])
    assert stopped[0].tokens == [first]


def test_temperature_sampling_varies():
    eng = Engine(_cfg(), batch_size=1, max_len=64, seed=0, device="cpu")
    # untrained logits have std ~ sqrt(d); the temperature must exceed
    # that to flatten the distribution
    a = eng.generate([Request(prompt=[1], max_new_tokens=12,
                              temperature=50.0)])[0].tokens
    b = eng.generate([Request(prompt=[1], max_new_tokens=12,
                              temperature=50.0)])[0].tokens
    assert a != b      # the engine's generator advances between calls
    again = Engine(_cfg(), batch_size=1, max_len=64, seed=0, device="cpu")
    assert again.generate([Request(prompt=[1], max_new_tokens=12,
                                   temperature=50.0)])[0].tokens == a


def test_continuous_engine_reuses_slots():
    """A slot's next occupant sees none of the previous one's cache: its
    tokens equal those of the same request served alone."""
    eng = ContinuousEngine(_cfg(), batch_size=1, max_len=64, device="cpu")
    first = eng.submit(Request(prompt=[4, 5], max_new_tokens=3))
    second = eng.submit(Request(prompt=[7, 8, 9], max_new_tokens=4))
    done = eng.run_until_done()
    alone = ContinuousEngine(_cfg(), batch_size=1, max_len=64, device="cpu")
    alone.submit(Request(prompt=[7, 8, 9], max_new_tokens=4))
    assert len(done[first].tokens) == 3
    assert done[second].tokens == alone.run_until_done()[0].tokens


def test_engine_refuses_too_many_requests_and_a_mesh():
    eng = Engine(_cfg(), batch_size=1, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="slots"):
        eng.generate([Request(prompt=[1]), Request(prompt=[2])])
    with pytest.raises(NotImplementedError, match="mesh"):
        make_serve_step(_cfg(), mesh=object())
    with pytest.raises(ValueError, match="lies on"):
        Engine(_cfg(), eng.model, device="meta")


def test_engines_refuse_cpu_fallback(monkeypatch):
    """Without ``device=`` the engines and the launcher run on the card;
    with no card they raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: Engine(_cfg()), lambda: ContinuousEngine(_cfg()),
                 lambda: launcher.main(["--requests", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_launcher_serves_on_the_cpu(capsys):
    launcher.main(["--arch", "chatglm3-6b", "--device", "cpu", "--batch",
                   "2", "--requests", "3", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "serving chatglm3-6b" in out and "on cpu" in out
    assert "3 requests, 12 tokens" in out


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-30b-a3b"])
def test_launcher_serves_moe_on_the_cpu(capsys, arch):
    launcher.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                   "--requests", "3", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert f"serving {arch}" in out and "on cpu" in out
    assert "3 requests, 12 tokens" in out


def test_moe_engine_batch_and_repeat(monkeypatch):
    """An MoE engine's greedy output repeats, and a request alone gets what
    it gets in a batch (each token routes on its own in decode)."""
    cfg = tcfgs.get_smoke_config("qwen3_moe_30b_a3b")
    eng = Engine(cfg, batch_size=3, max_len=32, device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=n) for p, n in REQUESTS]
    outs = eng.generate(reqs)
    assert [c.tokens for c in eng.generate(reqs)] == [c.tokens for c in outs]
    assert eng.generate(reqs[:1])[0].tokens == outs[0].tokens


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_launcher_serves_ssm_and_hybrid_on_the_cpu(capsys, arch):
    launcher.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                   "--requests", "3", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert f"serving {arch}" in out and "on cpu" in out
    assert "3 requests, 12 tokens" in out


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "zamba2_2_7b"])
def test_reused_slot_carries_no_recurrent_state(arch):
    """A request served in a slot that served another first equals that
    request served alone: the reset zeroes the slot's conv inputs and SSM
    states (and a hybrid's shared k and v, pos = -1) and leaves the other
    slots' as they are."""
    cfg = tcfgs.get_smoke_config(arch)
    model = lm_params_from_jax(cfg, jax.tree.map(np.asarray, jinit(
        jcfgs.get_smoke_config(arch), jax.random.PRNGKey(0))), device="cpu")
    eng = ContinuousEngine(cfg, model, batch_size=2, max_len=64)
    first = eng.submit(Request(prompt=[4, 5, 6, 7, 8], max_new_tokens=6))
    eng.submit(Request(prompt=[1, 2], max_new_tokens=2))
    third = eng.submit(Request(prompt=[7, 8, 9], max_new_tokens=5))
    done = eng.run_until_done()
    alone = ContinuousEngine(cfg, model, batch_size=2, max_len=64)
    alone.submit(Request(prompt=[7, 8, 9], max_new_tokens=5))
    assert len(done[first].tokens) == 6
    assert done[third].tokens == alone.run_until_done()[0].tokens
    before = {p: {n: a.clone() for n, a in arrays.items()}
              for p, arrays in eng.cache.items() if p != "index"}
    assert all(bool(a[:, 1].any()) for a in before["layers"].values())
    eng._reset_slot(1)
    for part, arrays in eng.cache.items():
        if part == "index":
            continue
        for name, a in arrays.items():
            assert bool((a[:, 1] == (-1 if name == "pos" else 0)).all())
            assert torch.equal(a[:, 0], before[part][name][:, 0])
