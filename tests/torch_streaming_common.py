"""What the streamed-solve tests share: the problem, the solver settings
and variants, the cells, and the module fixtures ``stores`` (the problem
written once a module as a samples store and a features store of 16-index
chunks) and ``_one_thread`` (autouse: one intra-op thread).

``tests/test_torch_streaming.py`` (the reference's streamed cases, robustness,
tracing and checkpoints), ``tests/test_torch_streaming_port.py`` (every
cell against the port's in-memory solve) and
``tests/test_torch_streaming_reference.py`` (against the reference's
in-memory solve) import it; three files so that ``--dist loadfile`` can
run them on three workers.
"""
import os

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.data.sparse import make_sparse_glm_data
from repro_torch import (CSRMatrix, DiscoConfig, DiscoSolver, InProcessGroup,
                         obs)
from repro_torch.data.store import ShardStore

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DATA = dict(d=96, n=160, density=0.2, alpha=1.0, beta=0.5, seed=1)
SOLVE = dict(loss="logistic", lam=1e-2, tau=16, max_outer=5,
             grad_tol=1e-10, ell_block_d=8, ell_block_n=8,
             partition_block=16, stream_chunk_size=16)
RTOL, ATOL = 1e-4, 1e-6
REL_F32, REL_BF16 = 1e-5, 3e-4

VARIANTS = {"classic": {}, "s2": dict(pcg_block_s=2),
            "s3": dict(pcg_block_s=3),
            "subsampled": dict(hessian_subsample=0.5, lam=1e-1, seed=7),
            "fused": dict(hvp_fused=True),
            "fused-s2": dict(hvp_fused=True, pcg_block_s=2),
            "bf16": dict(hvp_dtype="bfloat16"),
            "fused-bf16": dict(hvp_fused=True, hvp_dtype="bfloat16")}
CELLS = [(p, m, v) for p in ("samples", "features") for m in (1, 4)
         for v in VARIANTS if not (p == "features" and "fused" in v)]
# the cells also held to the reference (no subsampling draws)
REF_CELLS = [c for c in CELLS if c[2] != "subsampled"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module, restored after. The problem is
    tiny (d = 96, n = 160), so torch's 8 threads a process only contend:
    with the suite's 6 workers on 8 cores these three files ran 20-35
    times slower than alone (525 s against 17-50 s for each of 4
    concurrent files at one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _obs_clean():
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


def _data(seed=1):
    X, y, _ = make_sparse_glm_data(**dict(DATA, seed=seed))
    return X, y, CSRMatrix(X.indptr, X.indices, X.data, X.shape)


def _cfg(partition, variant="classic", **kw):
    return DiscoConfig(partition=partition,
                       **dict(SOLVE, **VARIANTS[variant], **kw))


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    X, y, _ = _data()
    root = tmp_path_factory.mktemp("streaming_stores")
    return {axis: ShardStore.from_csr(X, y, str(root / axis), axis=axis,
                                      chunk_size=16).path
            for axis in ("samples", "features")}


def _streamed(stores, partition, m, cfg, **kw):
    return DiscoSolver.from_store(ShardStore(stores[partition]), cfg,
                                  group=InProcessGroup(m), device="cpu",
                                  **kw)


def _iters(res):
    return [int(h["pcg_iters"]) for h in res.history]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))
