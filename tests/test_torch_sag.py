"""The original DiSCO's SAG preconditioner in the port against the JAX
package's.

``sag_solve`` alone: the same numpy inputs through
``repro.core.preconditioner.sag_solve`` and the port's, relative L2 <=
1e-5, with the default step and a given one. The whole solve,
``disco_fit(partition='samples', precond='sag')`` at the paper's tau = 100
and ``sag_epochs = 5``, on ``tests/test_torch_disco.py``'s sparse 96 x 200
matrix and ``tests/test_torch_dense.py``'s dense 98 x 202 one, logistic
and quadratic, classic and s-step: the same PCG iterations (or rounds)
per step, an equal ``CommLedger`` and ``w`` within rtol 1e-4 / atol 1e-6.
At m = 4 the reference runs in a subprocess with four forced host
devices. SAG on DiSCO-F raises ``ValueError`` in both packages.

Dense quadratic runs on the sparse matrix's dense form: on the 98 x 202
matrix the quadratic SAG-preconditioned PCG converges in neither package
(256 iterations a step, ||r|| stuck near 0.13; ROADMAP F8). There the
inexact SAG operator is indefinite, the reference's own two runs
(interpret, plain) differ by 1.2% in the gradient norm after one step,
and <r, M^-1 r> reaches exactly 0 in f32 at an iteration that depends on
the summation order, after which PCG divides 0 by 0.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DiscoConfig as JDiscoConfig
from repro.core import disco_fit as j_disco_fit
from repro.core.preconditioner import sag_solve as j_sag_solve
from repro.data.sparse import make_sparse_glm_data
from repro.data.synthetic import make_glm_data
from repro_torch import CSRMatrix, DiscoConfig, InProcessGroup, disco_fit
from repro_torch.core.preconditioner import sag_solve

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
KW = dict(lam=1e-3, tau=100, max_outer=4, grad_tol=0.0, ell_block_d=16,
          ell_block_n=16, partition="samples", precond="sag", sag_epochs=5,
          use_kernel=True)
RTOL, ATOL = 1e-4, 1e-6
# kind, loss, pcg_block_s
CASES = [(k, loss, 1) for k in ("sparse", "dense")
         for loss in ("logistic", "quadratic")] + \
    [("sparse", "logistic", 3), ("dense", "logistic", 3)]


def _id(case):
    kind, loss, s = case
    return f"{kind}-{loss}" + ("" if s == 1 else f"-s{s}")


def _data(kind, loss="logistic"):
    if kind == "sparse" or loss == "quadratic":
        X, y, _ = make_sparse_glm_data(d=96, n=200, density=0.2, alpha=0.8,
                                       beta=0.5, seed=1)
        if kind == "dense":
            return X.todense(), y, X.todense()
        return X, y, CSRMatrix(X.indptr, X.indices, X.data, X.shape)
    X, y, _ = make_glm_data(d=98, n=202, seed=1)
    return X, y, X


def _summary(res) -> dict:
    led = res.ledger
    return dict(w=np.asarray(res.w).tolist(),
                pcg_iters=[int(h["pcg_iters"]) for h in res.history],
                ledger=[led.rounds, led.floats, led.spmd_collectives])


def _assert_matches(got, ref: dict):
    np.testing.assert_allclose(got.w, np.asarray(ref["w"], np.float32),
                               rtol=RTOL, atol=ATOL)
    s = _summary(got)
    assert s["pcg_iters"] == ref["pcg_iters"]
    assert s["ledger"] == ref["ledger"]


@pytest.mark.parametrize("d,tau,epochs", [(37, 5, 1), (96, 16, 5),
                                          (300, 100, 5), (64, 100, 2)])
@pytest.mark.parametrize("given_step", [False, True])
def test_sag_solve_matches_jax(d, tau, epochs, given_step):
    rng = np.random.default_rng(d + tau)
    X_tau = (rng.standard_normal((d, tau)) / np.sqrt(d)).astype(np.float32)
    coeffs = rng.uniform(0.05, 0.25, tau).astype(np.float32)
    r = rng.standard_normal(d).astype(np.float32)
    step = 0.5 if given_step else None
    want = np.asarray(j_sag_solve(jnp.asarray(X_tau), jnp.asarray(coeffs),
                                  1e-3, 1e-2, jnp.asarray(r), epochs=epochs,
                                  step=step))
    got = sag_solve(torch.from_numpy(X_tau), torch.from_numpy(coeffs),
                    1e-3, 1e-2, torch.from_numpy(r), epochs=epochs,
                    step=step).numpy()
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
    # the iterate moved off the warm start r / delta
    assert np.linalg.norm(got - r / 1.1e-2) > 1e-3 * np.linalg.norm(got)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_sag_disco_fit_matches_jax(case):
    kind, loss, s = case
    X, y, Xt = _data(kind, loss)
    kw = dict(KW, loss=loss, pcg_block_s=s)
    ref = _summary(j_disco_fit(X, y, JDiscoConfig(**kw)))
    got = disco_fit(Xt, y, DiscoConfig(**kw), device="cpu")
    _assert_matches(got, ref)
    assert got.grad_norms[-1] < 0.5 * got.grad_norms[0]


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
    Xs, ys, _ = make_sparse_glm_data(d=96, n=200, density=0.2, alpha=0.8,
                                     beta=0.5, seed=1)
    Xd, yd, _ = make_glm_data(d=98, n=202, seed=1)
    data = {("sparse", "logistic"): (Xs, ys),
            ("sparse", "quadratic"): (Xs, ys),
            ("dense", "logistic"): (Xd, yd),
            ("dense", "quadratic"): (Xs.todense(), ys)}
    out = []
    for kind, loss, s in CASES:
        X, y = data[(kind, loss)]
        r = disco_fit(X, y, DiscoConfig(loss=loss, pcg_block_s=s, **KW),
                      mesh=jax.make_mesh((4,), ("data",)))
        led = r.ledger
        out.append(dict(w=np.asarray(r.w).tolist(),
                        pcg_iters=[int(h["pcg_iters"]) for h in r.history],
                        ledger=[led.rounds, led.floats,
                                led.spmd_collectives]))
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
def test_sag_disco_fit_4shards_matches_jax(jax_4device_runs, case):
    kind, loss, s = case
    X, y, Xt = _data(kind, loss)
    got = disco_fit(Xt, y, DiscoConfig(**dict(KW, loss=loss, pcg_block_s=s)),
                    group=InProcessGroup(4), device="cpu")
    _assert_matches(got, jax_4device_runs[_id(case)])


def test_sag_on_features_raises_like_jax():
    X, y, Xt = _data("sparse")
    kw = dict(KW, partition="features", max_outer=1)
    with pytest.raises(ValueError, match="unknown precond 'sag'"):
        j_disco_fit(X, y, JDiscoConfig(**kw))
    with pytest.raises(ValueError, match="unknown precond 'sag'"):
        disco_fit(Xt, y, DiscoConfig(**kw), device="cpu")


def report():
    """F8: dense quadratic SAG on the 98 x 202 matrix, where neither
    package's PCG converges (the reference's interpret and plain runs,
    and the port)."""
    X, y, _ = make_glm_data(d=98, n=202, seed=1)
    kw = dict(KW, loss="quadratic", max_outer=2)
    for mode in ("interpret", "ref"):
        os.environ["REPRO_KERNEL_MODE"] = mode
        r = j_disco_fit(X, y, JDiscoConfig(**kw))
        print(f"reference {mode}: PCG iterations "
              f"{[int(h['pcg_iters']) for h in r.history]}, ||r|| "
              f"{[round(float(h['pcg_r_norm']), 4) for h in r.history]}, "
              f"grad norms {[float(h['grad_norm']) for h in r.history]}")
    r = disco_fit(X, y, DiscoConfig(**kw), device="cpu")
    print(f"port: PCG iterations {[h['pcg_iters'] for h in r.history]}, "
          f"||r|| {[h['pcg_r_norm'] for h in r.history]}")


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_sag.py
    report()
