"""The port stands alone: no JAX, nothing of the JAX package, and no
silent CPU fallback."""
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any import of jax now fails
    sys.modules["ml_dtypes"] = None    # nor of ml_dtypes (bf16 is torch's)
    import numpy as np
    import repro_torch
    from repro_torch import (CSRMatrix, DiscoConfig, DiscoSolver,
                             GLMProblem, InProcessGroup, disco_fit,
                             make_glm_data, make_sparse_glm_data)
    import repro_torch.convert, repro_torch.kernels.sparse_hvp
    import repro_torch.kernels.glm_hvp, repro_torch.kernels.build
    X, y, _ = make_sparse_glm_data(d=48, n=80, density=0.2, seed=0)
    Xd, yd, _ = make_glm_data(d=30, n=50, seed=0)
    for partition in ("samples", "features"):
        r = disco_fit(X, y, DiscoConfig(partition=partition, tau=16,
                                        max_outer=2, ell_block_d=8,
                                        ell_block_n=8),
                      group=InProcessGroup(2), device="cpu")
        assert np.isfinite(r.w).all() and r.w.shape == (48,)
        r = disco_fit(Xd, yd, DiscoConfig(partition=partition, tau=16,
                                          max_outer=2, use_kernel=True,
                                          hvp_fused=True),
                      group=InProcessGroup(2), device="cpu")
        assert np.isfinite(r.w).all() and r.w.shape == (30,)
        assert r.grad_norms[-1] < r.grad_norms[0]
        for s in (1, 2):
            r = disco_fit(Xd, yd, DiscoConfig(partition=partition, tau=16,
                                              max_outer=2, use_kernel=True,
                                              hvp_fused=True, pcg_block_s=s,
                                              hvp_dtype="bfloat16"),
                          group=InProcessGroup(1), device="cpu")
            assert np.isfinite(r.w).all() and r.w.shape == (30,)
            assert r.grad_norms[-1] < r.grad_norms[0]
        r = disco_fit(X, y, DiscoConfig(partition=partition, tau=16,
                                        max_outer=2, ell_block_d=8,
                                        ell_block_n=8, pcg_block_s=3),
                      group=InProcessGroup(2), device="cpu")
        assert np.isfinite(r.w).all() and r.grad_norms[-1] < r.grad_norms[0]
        for fused, s in ((False, 1), (True, 1), (True, 2)):
            r = disco_fit(X, y, DiscoConfig(partition=partition, tau=16,
                                            max_outer=2, ell_block_d=8,
                                            ell_block_n=8, hvp_fused=fused,
                                            pcg_block_s=s,
                                            hvp_dtype="bfloat16"),
                          group=InProcessGroup(2), device="cpu")
            assert np.isfinite(r.w).all()
            assert r.grad_norms[-1] < r.grad_norms[0]
    from repro_torch.data.sparse import build_shard_ell_pairs, hvp_tile_dtype
    from repro_torch.core import comm
    tiles = build_shard_ell_pairs([X], 8, 8, dtype=hvp_tile_dtype("bf16"))
    assert str(tiles[0].dtype) == "torch.bfloat16"
    assert comm.hvp_dtype_bytes("bfloat16") == 2
    for kw in (dict(precond="sag", sag_epochs=2),
               dict(hessian_subsample=0.5), dict(hessian_subsample=0.5,
                                                 pcg_block_s=2)):
        r = disco_fit(X, y, DiscoConfig(partition="samples", tau=16,
                                        max_outer=2, ell_block_d=8,
                                        ell_block_n=8, **kw),
                      group=InProcessGroup(2), device="cpu")
        assert np.isfinite(r.w).all() and r.grad_norms[-1] < r.grad_norms[0]
    r = disco_fit(Xd, yd, DiscoConfig(partition="features", tau=16,
                                      max_outer=2, hessian_subsample=0.5),
                  group=InProcessGroup(2), device="cpu")
    assert np.isfinite(r.w).all()
    import os, tempfile
    import repro_torch.core.baselines, repro_torch.data.libsvm
    from repro_torch import (CocoaConfig, DaneConfig, GDConfig, cocoa_fit,
                             dane_fit, gd_fit, load_libsvm,
                             load_libsvm_sparse, save_libsvm)
    for fit, cfg in ((gd_fit, GDConfig(max_outer=3)),
                     (dane_fit, DaneConfig(max_outer=2)),
                     (cocoa_fit, CocoaConfig(max_outer=2, local_steps=8))):
        w, hist, ledger = fit(Xd, yd, cfg, group=InProcessGroup(2),
                              device="cpu")
        assert np.isfinite(w).all() and ledger.rounds > 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "d.svm")
        save_libsvm(path, Xd[:, :10], yd[:10])
        Xs, ys = load_libsvm_sparse(path, n_features=30)
        assert Xs.shape == (30, 10)
        assert np.allclose(load_libsvm(path, n_features=30)[0], Xd[:, :10],
                           rtol=1e-5, atol=1e-6)
    import repro_torch.core.lambda_path, repro_torch.core.softmax
    from repro_torch import SoftmaxConfig, lambda_path_fit, softmax_fit
    labels = np.argmax(Xd[:3].T, axis=1)
    for partition in ("samples", "features"):
        r = softmax_fit(Xd, labels, SoftmaxConfig(partition=partition,
                                                  max_outer=2, tau=16,
                                                  use_kernel=True,
                                                  pcg_block_s=2),
                        group=InProcessGroup(2), device="cpu")
        assert np.isfinite(r.W).all() and r.W.shape == (30, 3)
        assert r.grad_norms[-1] < r.grad_norms[0]
    for dtype in ("float32", "bfloat16"):
        path = lambda_path_fit(Xd, yd, [1e-2, 1e-3],
                               DiscoConfig(tau=16, max_outer=2,
                                           use_kernel=True, hvp_fused=True,
                                           pcg_block_s=2, hvp_dtype=dtype,
                                           partition="samples"),
                               X_val=Xd, y_val=yd, device="cpu")
        assert path.lambdas == [1e-2, 1e-3]
        assert path.best_lambda in path.lambdas
        assert all(np.isfinite(r.w).all() for r in path.results)
    import torch
    assert GLMProblem.create(Xd, yd, device="cpu").grad(torch.zeros(30)).shape == (30,)
    import repro_torch.models, repro_torch.serve, repro_torch.launch.serve
    import repro_torch.kernels.flash_attention
    from repro_torch import (ContinuousEngine, Engine, Request, decode_step,
                             forward, get_smoke_config, init_cache,
                             init_params)
    cfg = get_smoke_config("chatglm3-6b")
    model = init_params(cfg, device="cpu")
    logits, _ = forward(cfg, model, {"tokens": np.ones((2, 9), np.int64)},
                        last_only=True)
    assert logits.shape == (2, 1, cfg.padded_vocab)
    cache = init_cache(cfg, 2, 8, device="cpu")
    logits, cache = decode_step(cfg, model, np.ones((2, 1), np.int64), cache)
    assert torch.isfinite(logits).all() and cache["index"] == 1
    out = Engine(cfg, model, batch_size=2, max_len=16).generate(
        [Request(prompt=[1, 2], max_new_tokens=3)])
    assert len(out[0].tokens) == 3
    eng = ContinuousEngine(cfg, model, batch_size=2, max_len=16)
    eng.submit(Request(prompt=[3], max_new_tokens=2))
    assert len(eng.run_until_done()[0].tokens) == 2
    import repro_torch.models.moe
    for arch in ("mixtral-8x7b", "qwen3-moe-30b-a3b"):
        cfg = get_smoke_config(arch)
        model = init_params(cfg, device="cpu")
        logits, aux = forward(cfg, model, {"tokens": np.ones((2, 9), np.int64)},
                              last_only=True)
        assert logits.shape == (2, 1, cfg.padded_vocab) and float(aux) > 0
        cache = init_cache(cfg, 2, 8, device="cpu")
        logits, cache = decode_step(cfg, model, np.ones((2, 1), np.int64),
                                    cache)
        assert torch.isfinite(logits).all() and cache["index"] == 1
        out = Engine(cfg, model, batch_size=2, max_len=16).generate(
            [Request(prompt=[1, 2], max_new_tokens=3)])
        assert len(out[0].tokens) == 3
    import repro_torch.models.mamba
    for arch in ("falcon-mamba-7b", "zamba2-2.7b"):
        cfg = get_smoke_config(arch)
        model = init_params(cfg, device="cpu")
        logits, _ = forward(cfg, model, {"tokens": np.ones((2, 40), np.int64)},
                            last_only=True)
        assert logits.shape == (2, 1, cfg.padded_vocab)
        assert torch.isfinite(logits).all()
        cache = init_cache(cfg, 2, 8, device="cpu")
        logits, cache = decode_step(cfg, model, np.ones((2, 1), np.int64),
                                    cache)
        assert torch.isfinite(logits).all() and cache["index"] == 1
        out = Engine(cfg, model, batch_size=2, max_len=16).generate(
            [Request(prompt=[1, 2], max_new_tokens=3)])
        assert len(out[0].tokens) == 3
    import repro_torch.obs, repro_torch.robust, repro_torch.data.store
    from repro_torch import obs
    from repro_torch.data import ShardStore
    from repro_torch.robust import FaultInjector, FaultPlan, SimulatedKill
    with tempfile.TemporaryDirectory() as tmp:
        store = ShardStore.from_csr(X, y, os.path.join(tmp, "s"),
                                    axis="samples", chunk_size=16)
        Xs, ys = ShardStore(store.path, verify=True).to_csr()
        assert np.array_equal(Xs.data, X.data) and np.array_equal(ys, y)
        cfg = DiscoConfig(partition="features", tau=16, max_outer=3,
                          ell_block_d=8, ell_block_n=8, trace=True)
        solver = DiscoSolver(Xs, ys, cfg, group=InProcessGroup(2),
                             device="cpu")
        whole = solver.fit()
        solver._faults = FaultInjector(FaultPlan(kill_at_step=2))
        ckpt = os.path.join(tmp, "ckpt")
        try:
            solver.fit(checkpoint_dir=ckpt)
            raise AssertionError("not killed")
        except SimulatedKill:
            pass
        solver._faults = None
        r = solver.fit(checkpoint_dir=ckpt, resume=True)
        assert np.array_equal(r.w, whole.w)
        tracer = obs.get_tracer()
        obs.export.write_chrome_trace(tracer, os.path.join(tmp, "t.json"))
        assert tracer.span_count("newton.outer") == 3 + 2 + 1
        assert tracer.span_count("ckpt.write") == 2 + 1
        obs.disable()
        # the streamed solve, traced, with re-planning armed
        from repro_torch import disco_fit_streaming
        from repro_torch.robust import ChunkTimingLedger, ElasticReplanner
        tracer = obs.enable(reset=True)
        for partition in ("samples", "features"):
            cfg = DiscoConfig(partition=partition, tau=16, max_outer=2,
                              ell_block_d=8, ell_block_n=8,
                              partition_block=16, stream_chunk_size=16,
                              elastic_replan=True, replan_threshold=1.0,
                              trace=True)
            r = disco_fit_streaming(X, y, os.path.join(tmp, partition), cfg,
                                    group=InProcessGroup(2), device="cpu")
            assert np.isfinite(r.w).all() and r.stream_stats["passes"] > 0
        assert tracer.span_count("stream.pass") > 0
        assert tracer.span_count("pcg.round") > 0
        obs.disable()
        # GLM serving: publish -> load -> score -> run_until_done ->
        # refit_path
        import repro_torch.glm_serve
        from repro_torch.glm_serve import (MicroBatchScheduler,
                                           ModelRegistry, RefitLoop,
                                           ScoreRequest, ScoringEngine,
                                           oracle_margins)
        tracer = obs.enable(reset=True)
        cfg = DiscoConfig(partition="samples", tau=16, max_outer=2,
                          ell_block_d=8, ell_block_n=8, partition_block=16,
                          stream_chunk_size=16)
        reg = ModelRegistry(os.path.join(tmp, "reg"))
        reg.publish(disco_fit(X, y, cfg, device="cpu"), cfg)
        assert reg.load().w.shape == (48,)
        eng = ScoringEngine(reg, batch=4, block_b=2, block_d=8,
                            device="cpu")
        Xd = X.todense()
        reqs = [ScoreRequest.from_dense(Xd[:, j]) for j in range(9)]
        sched = MicroBatchScheduler(eng)
        rids = [sched.submit(r) for r in reqs]
        fin = sched.run_until_done()
        got = np.array([fin[r].margin for r in rids], np.float32)
        assert np.allclose(got, oracle_margins(reqs, reg.load().w),
                           rtol=1e-5, atol=1e-6)
        assert np.allclose(eng.score(reqs), got, rtol=0, atol=0)
        store = ShardStore.from_csr(X, y, os.path.join(tmp, "refit"),
                                    axis="samples", chunk_size=16)
        loop = RefitLoop(reg, store, cfg, device="cpu")
        v, path = loop.refit_path([1e-2, 1e-3], X_val=X, y_val=y)
        assert v == 2 and reg.active_version() == 2
        assert loop.cfg.lam == path.best_lambda
        assert tracer.span_count("serve.tick") == 3
        assert tracer.span_count("registry.publish") == 2
        obs.disable()
    leaked = sorted(m for m in sys.modules
                    if m == "repro" or m.startswith("repro.")
                    or (m.split(".")[0] in ("jax", "ml_dtypes")
                        and sys.modules[m] is not None))
    assert not leaked, leaked
    print("ISOLATED")
""")


def test_port_runs_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ISOLATED" in r.stdout


def test_spawned_ranks_load_no_jax_or_repro(tmp_path):
    """A rank of ``repro_torch.parallel.launch.spawn`` is a new
    interpreter, which the ``sys.modules["jax"] = None`` check above never
    sees: each of two gloo ranks runs distributed solves (in memory,
    streamed, softmax) and reports the modules of JAX, ``ml_dtypes`` and
    the JAX package it loaded, which must be none."""
    import torch_dist_ranks as ranks
    from repro_torch import make_sparse_glm_data
    from repro_torch.parallel.launch import spawn
    X, y, _ = make_sparse_glm_data(d=48, n=80, density=0.2, seed=0)
    out = spawn(ranks.isolated_solve, 2, backend="gloo", device="cpu",
                args=(((X.indptr, X.indices, X.data, X.shape), y),
                      str(tmp_path)),
                timeout_s=60.0)
    assert out == [[], []]


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro|ml_dtypes)\b|from\s+(jax|repro|ml_dtypes)[\s.])",
    re.MULTILINE)


def test_no_jax_or_repro_imports_in_port_sources():
    """No port source and no root chip script imports jax, the JAX
    package or ml_dtypes (JAX's bf16 dtype; the port's bf16 is torch's)."""
    files = sorted((SRC / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py", ROOT / "chip_k11_variants.py",
         ROOT / "chip_hvp_variants.py", ROOT / "chip_dense_variants.py",
         ROOT / "chip_fused_variants.py", ROOT / "chip_multi_variants.py"]
    assert len(files) > 10
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, (f, hits)


_LIBRARY = re.compile(
    r"^\s*#\s*include\s*[<\"](cublas|cublasLt|cudnn|cusparse|cutlass|cute|"
    r"torch|ATen|c10|thrust|cub)[/_.]", re.MULTILINE)


def test_kernel_sources_call_no_library():
    """Every CUDA source of the port, the bf16 one-pass instances
    included, is a kernel written here: no cuBLAS, cuDNN, cuSPARSE,
    CUTLASS, Thrust or PyTorch header is included, and every source
    ``kernels/build.py`` compiles is among them."""
    from repro_torch.kernels import build
    sources = sorted((SRC / "repro_torch" / "kernels" / "csrc").glob("*.cu*"))
    assert {k.source for k in build.KERNELS} <= set(sources)
    assert {"x_c_xt_u_bf16.cu", "x_c_xt_multi_bf16.cu",
            "fused_stream.cuh"} <= {f.name for f in sources}
    for f in sources:
        hits = _LIBRARY.findall(f.read_text())
        assert not hits, (f, hits)


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """Without ``device=`` the entry points run on the card; with no card
    they raise instead of quietly running on the CPU."""
    from repro_torch import (CSRMatrix, DiscoConfig, DiscoSolver, disco_fit,
                             make_sparse_glm_data)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y, _ = make_sparse_glm_data(d=16, n=20, density=0.3, seed=0)
    cfg = DiscoConfig(tau=8, max_outer=1, ell_block_d=8, ell_block_n=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        disco_fit(X, y, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        DiscoSolver(X, y, cfg, device="cuda")
    assert isinstance(X, CSRMatrix)
    from repro_torch import SoftmaxConfig, lambda_path_fit, softmax_fit
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lambda_path_fit(X, y, [1e-2, 1e-3], cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        softmax_fit(X.todense(), (y > 0).astype(int),
                    SoftmaxConfig(max_outer=1))


def test_model_entry_points_refuse_cpu_fallback(monkeypatch):
    """The model zoo's entry points, like the solver's, default to the card
    and raise without one."""
    from repro_torch import Engine, get_smoke_config, init_cache, init_params
    from repro_torch.convert import lm_params_from_jax
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("olmo-1b")
    for call in (lambda: init_params(cfg), lambda: init_cache(cfg, 1, 8),
                 lambda: Engine(cfg), lambda: lm_params_from_jax(cfg, {})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
