"""Hessian subsampling (paper §5.4) in the port against the JAX package.

The reference draws its masks from ``jax.random`` (ROADMAP F1), which
torch cannot reproduce, so its masks are injected in place of the port's
``subsample_mask``: the key split once per outer step, folded with the
shard index on DiSCO-S, ``bernoulli(frac)`` over the shape the port asks
for. Both partitions, sparse (``tests/test_torch_disco.py``'s 96 x 200)
and dense (``tests/test_torch_dense.py``'s 98 x 202, ragged against 4
shards), classic and s-step, at m = 1 and 4: the same PCG iterations per
step, an equal ``CommLedger`` and ``w`` within rtol 1e-4 / atol 1e-6 (a
mask of another shape than the reference's, padding included, would
move all three). s-step solves are held as in ``tests/test_torch_sstep.py``
(F4): ``w`` within that tolerance of the reference's interpret or plain
(``REPRO_KERNEL_MODE=ref``) run, or no further from the interpret run
than the plain run is; they run at s = 2, where the port, the interpret
and the plain run lie within 4.3e-7 of each other in relative L2 (at
s = 3 DiSCO-F's sparse solve spreads to 2.3e-6 between the reference's
own runs and 4.9e-6 to the port). At m = 4 the reference runs in a
subprocess with four forced host devices.

These run at lam = 1e-2. At 1e-3 a half-sample Hessian of 200 samples
needs 16-23 PCG iterations a step and the gradient norm stops falling;
there the reference's own two runs (interpret, plain) end up to 5.9e-3
apart in ``w`` (F7), and the port is held the F4 way: no further from
the interpret run than the plain run is.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.core import DiscoConfig as JDiscoConfig
from repro.core import disco_fit as j_disco_fit
from repro.data.sparse import make_sparse_glm_data
from repro.data.synthetic import make_glm_data
from repro_torch import CSRMatrix, DiscoConfig, InProcessGroup, disco_fit
from repro_torch.core import disco as port_disco

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
KW = dict(loss="logistic", lam=1e-2, tau=100, max_outer=4, grad_tol=0.0,
          ell_block_d=16, ell_block_n=16, hessian_subsample=0.5,
          use_kernel=True)
RTOL, ATOL = 1e-4, 1e-6
# partition, kind, pcg_block_s
CASES = [(p, k, s) for p in ("samples", "features")
         for k in ("sparse", "dense") for s in (1, 2)]


def _id(case):
    p, k, s = case
    return f"{p}-{k}" + ("" if s == 1 else f"-s{s}")


def jax_mask(seed, outer_iter, shard, frac, shape):
    """The reference's mask for outer step ``outer_iter``: the fit loop's
    ``key, sub = split(key)``, folded with the shard index on DiSCO-S
    (``_shard_subsample_mask``), raw on DiSCO-F."""
    key = jax.random.PRNGKey(seed)
    for _ in range(outer_iter + 1):
        key, sub = jax.random.split(key)
    if shard is not None:
        sub = jax.random.fold_in(sub, shard)
    return torch.from_numpy(np.array(jax.random.bernoulli(sub, frac, shape)))


@pytest.fixture()
def reference_masks(monkeypatch):
    """Inject the reference's masks; returns the calls' arguments."""
    calls = []

    def draw(seed, outer_iter, shard, frac, shape):
        calls.append((outer_iter, shard, tuple(shape)))
        return jax_mask(seed, outer_iter, shard, frac, shape)
    monkeypatch.setattr(port_disco, "subsample_mask", draw)
    return calls


def _data(kind):
    if kind == "sparse":
        X, y, _ = make_sparse_glm_data(d=96, n=200, density=0.2, alpha=0.8,
                                       beta=0.5, seed=1)
        return X, y, CSRMatrix(X.indptr, X.indices, X.data, X.shape)
    X, y, _ = make_glm_data(d=98, n=202, seed=1)
    return X, y, X


def _cfg(cls, case, **over):
    partition, _, s = case
    return cls(**dict(KW, partition=partition, pcg_block_s=s, **over))


def _summary(res) -> dict:
    led = res.ledger
    return dict(w=np.asarray(res.w).tolist(),
                pcg_iters=[int(h["pcg_iters"]) for h in res.history],
                ledger=[led.rounds, led.floats, led.spmd_collectives])


def _assert_matches(got, ref: dict, ref_plain: dict):
    """``ref``: the reference in interpret mode; ``ref_plain``: on its
    plain versions (s-step), else ``ref`` again."""
    s = _summary(got)
    assert s["pcg_iters"] == ref["pcg_iters"] == ref_plain["pcg_iters"]
    assert s["ledger"] == ref["ledger"]
    w_ref = np.asarray(ref["w"], np.float32)
    w_plain = np.asarray(ref_plain["w"], np.float32)
    if any(np.allclose(got.w, w, rtol=RTOL, atol=ATOL)
           for w in (w_ref, w_plain)):
        return
    own = float(np.max(np.abs(w_plain - w_ref)))
    diff = float(np.max(np.abs(got.w - w_ref)))
    assert diff <= own, (
        f"w differs by up to {diff:.3g} from the reference, beyond rtol "
        f"{RTOL} / atol {ATOL} of its runs and beyond their own spread "
        f"{own:.3g}")


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_subsampled_fit_matches_jax(case, reference_masks, monkeypatch):
    partition, kind, s = case
    X, y, Xt = _data(kind)
    ref = _summary(j_disco_fit(X, y, _cfg(JDiscoConfig, case)))
    ref_plain = ref
    if s > 1:
        monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")
        ref_plain = _summary(j_disco_fit(X, y, _cfg(JDiscoConfig, case)))
    reference_masks.clear()
    got = disco_fit(Xt, y, _cfg(DiscoConfig, case), device="cpu")
    _assert_matches(got, ref, ref_plain)
    # one fresh mask a step, over the shape of the step's coefficients
    n_pad = 208 if kind == "sparse" else 202     # ELL pads n to 16
    assert reference_masks == [
        (k, None if partition == "features" else 0, (n_pad,))
        for k in range(KW["max_outer"])]


SCRIPT_4 = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    assert len(jax.devices()) == 4
    from repro.core import DiscoConfig, disco_fit
    from repro.data.sparse import make_sparse_glm_data
    from repro.data.synthetic import make_glm_data
    KW, CASES = json.loads(sys.argv[1])
    data = {"sparse": make_sparse_glm_data(d=96, n=200, density=0.2,
                                           alpha=0.8, beta=0.5, seed=1),
            "dense": make_glm_data(d=98, n=202, seed=1)}
    out = []
    for partition, kind, s in CASES:
        X, y, _ = data[kind]
        axis = "model" if partition == "features" else "data"
        runs = []
        for mode in ["interpret"] + (["ref"] if s > 1 else []):
            os.environ["REPRO_KERNEL_MODE"] = mode
            r = disco_fit(X, y, DiscoConfig(partition=partition,
                                            pcg_block_s=s, **KW),
                          mesh=jax.make_mesh((4,), (axis,)))
            led = r.ledger
            runs.append(dict(
                w=np.asarray(r.w).tolist(),
                pcg_iters=[int(h["pcg_iters"]) for h in r.history],
                ledger=[led.rounds, led.floats, led.spmd_collectives]))
        out.append(runs)
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_4device_runs():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               REPRO_KERNEL_MODE="interpret")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", SCRIPT_4,
                        json.dumps([KW, CASES])], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return dict(zip(map(_id, CASES), json.loads(line[len("RESULT "):])))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_subsampled_fit_4shards_matches_jax(jax_4device_runs, case,
                                            reference_masks):
    partition, kind, _ = case
    X, y, Xt = _data(kind)
    got = disco_fit(Xt, y, _cfg(DiscoConfig, case), group=InProcessGroup(4),
                    device="cpu")
    runs = jax_4device_runs[_id(case)]
    _assert_matches(got, runs[0], runs[-1])
    if partition == "samples":      # one mask per shard, its padded width
        width = 64 if kind == "sparse" else 51
        assert reference_masks == [(k, s, (width,))
                                   for k in range(KW["max_outer"])
                                   for s in range(4)]


@pytest.mark.parametrize("partition", ["samples", "features"])
def test_subsampled_fit_at_small_lam_within_the_reference_spread(
        partition, reference_masks, monkeypatch):
    """F7's regime (lam = 1e-3): the port is no further from the
    reference's interpret run than its plain run is."""
    X, y, Xt = _data("sparse")
    cfg = dict(KW, lam=1e-3, partition=partition)
    ref_i = np.asarray(j_disco_fit(X, y, JDiscoConfig(**cfg)).w)
    monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")
    ref_p = np.asarray(j_disco_fit(X, y, JDiscoConfig(**cfg)).w)
    got = disco_fit(Xt, y, DiscoConfig(**cfg), device="cpu").w
    spread = np.linalg.norm(ref_p - ref_i)
    assert spread > 0
    assert np.linalg.norm(got - ref_i) <= spread


def test_port_masks_are_fresh_per_step_and_shard():
    """The port's own masks: mean near frac, another draw every step and
    every shard, the same draw for the same arguments (so the card and
    the CPU use the same masks)."""
    draw = port_disco.subsample_mask
    base = draw(0, 0, 0, 0.25, (20000,))
    assert base.dtype == torch.bool and base.shape == (20000,)
    assert abs(base.float().mean().item() - 0.25) < 0.01
    assert torch.equal(base, draw(0, 0, 0, 0.25, (20000,)))
    for other in (draw(0, 1, 0, 0.25, (20000,)),
                  draw(0, 0, 1, 0.25, (20000,)),
                  draw(0, 0, None, 0.25, (20000,)),
                  draw(1, 0, 0, 0.25, (20000,))):
        agree = (base & other).float().mean().item()
        assert abs(agree - 0.25 * 0.25) < 0.01   # independent draws


def test_port_masks_in_a_solve(monkeypatch):
    """In a DiSCO-S solve on 4 shards each step draws 4 masks, one per
    shard; the solve with its own masks runs and differs from the
    unsubsampled one."""
    calls = []
    draw = port_disco.subsample_mask

    def spy(seed, outer_iter, shard, frac, shape):
        mask = draw(seed, outer_iter, shard, frac, shape)
        calls.append(mask)
        return mask
    monkeypatch.setattr(port_disco, "subsample_mask", spy)
    X, y, Xt = _data("sparse")
    cfg = DiscoConfig(**dict(KW, partition="samples"))
    res = disco_fit(Xt, y, cfg, group=InProcessGroup(4), device="cpu")
    assert len(calls) == 4 * KW["max_outer"]
    masks = torch.stack(calls).float()
    assert abs(masks.mean().item() - 0.5) < 0.05
    assert len({tuple(m.tolist()) for m in calls}) == len(calls)
    full = disco_fit(Xt, y, DiscoConfig(**dict(KW, partition="samples",
                                               hessian_subsample=1.0)),
                     group=InProcessGroup(4), device="cpu")
    assert not np.allclose(res.w, full.w)
    assert res.grad_norms[-1] < 0.2 * res.grad_norms[0]


def report():
    """The spreads behind the choices above, and F9: the reference and the
    port (the reference's masks injected) on DiSCO-F at an eighth of the
    rcv1 shape, lam = 1e-4, where a 6.25% Hessian raises f."""
    import repro_torch.core.disco as pd
    pd.subsample_mask = jax_mask
    rel = lambda a, b: float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                             / np.linalg.norm(np.asarray(b)))

    def runs(X, y, Xt, kw):
        os.environ["REPRO_KERNEL_MODE"] = "interpret"
        a = j_disco_fit(X, y, JDiscoConfig(**kw))
        os.environ["REPRO_KERNEL_MODE"] = "ref"
        b = j_disco_fit(X, y, JDiscoConfig(**kw))
        return a, b, disco_fit(Xt, y, DiscoConfig(**kw), device="cpu")

    X, y, Xt = _data("sparse")
    for name, kw in (("s-step s=3 DiSCO-F", dict(KW, partition="features",
                                                 pcg_block_s=3)),
                     ("s-step s=2 DiSCO-F", dict(KW, partition="features",
                                                 pcg_block_s=2)),
                     ("lam=1e-3 DiSCO-S", dict(KW, lam=1e-3,
                                               partition="samples")),
                     ("lam=1e-3 DiSCO-F", dict(KW, lam=1e-3,
                                               partition="features"))):
        a, b, c = runs(X, y, Xt, kw)
        print(f"{name}: rel L2 plain-interpret {rel(b.w, a.w):.2e}, "
              f"port-interpret {rel(c.w, a.w):.2e}; PCG iterations "
              f"{[int(h['pcg_iters']) for h in a.history]}")
    X, y, _ = make_sparse_glm_data(d=47236 // 8, n=20242 // 8,
                                   density=0.0036, seed=0)
    Xt = CSRMatrix(X.indptr, X.indices, X.data, X.shape)
    os.environ["REPRO_KERNEL_MODE"] = "ref"
    for frac in (0.0625, 0.5):
        kw = dict(loss="logistic", tau=100, lam=1e-4, grad_tol=0.0,
                  partition="features", hessian_subsample=frac, max_outer=4)
        a = j_disco_fit(X, y, JDiscoConfig(**kw))
        c = disco_fit(Xt, y, DiscoConfig(**kw), device="cpu")
        print(f"F9 frac {frac}: f reference "
              f"{[round(float(h['f']), 4) for h in a.history]}, port "
              f"{[round(h['f'], 4) for h in c.history]}")


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_subsample.py
    report()
