"""The port's streamed DiSCO solve against its own in-memory solve, cell by
cell: at ``partition_block = stream_chunk_size`` both realise the same
chunk-granular partition, so the same ``partition_info``, the same PCG
iterations on every step and ``w`` within relative L2 1e-5 (3e-4 and
iterations within one at bf16 tiles, ROADMAP F11); and the streamed step
draws the in-memory step's subsampling masks. The settings and the
``stores`` fixture are ``tests/torch_streaming_common.py``'s; the rest of
the streamed tests are in ``tests/test_torch_streaming.py``.
"""
import numpy as np
import pytest

from repro_torch import DiscoSolver, InProcessGroup
# _obs_clean, _one_thread (autouse) and stores are the shared module's
# fixtures
from torch_streaming_common import (_obs_clean, _one_thread, REL_F32, REL_BF16,
                                    CELLS, _data, _cfg, stores, _streamed,
                                    _iters, _rel)


# ---------------------------------------------------------------------------
# every cell against the port's in-memory solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("partition,m,variant", CELLS,
                         ids=[f"{p}-m{m}-{v}" for p, m, v in CELLS])
def test_streamed_matches_port_inmemory(stores, partition, m, variant):
    _, y, X = _data()
    cfg = _cfg(partition, variant)
    rs = _streamed(stores, partition, m, cfg).fit()
    rm = DiscoSolver(X, y, cfg, group=InProcessGroup(m), device="cpu").fit()
    assert rs.partition_info == rm.partition_info
    assert rs.ledger.rounds > 0 and len(rs.history) == len(rm.history)
    if cfg.hvp_dtype == "bfloat16":
        assert _rel(rs.w, rm.w) <= REL_BF16
        assert all(abs(a - b) <= 1 for a, b in zip(_iters(rs), _iters(rm)))
    else:
        assert _rel(rs.w, rm.w) <= REL_F32, _rel(rs.w, rm.w)
        assert _iters(rs) == _iters(rm)
        assert rs.ledger == rm.ledger
    st = rs.stream_stats
    assert st["passes"] > 0 and st["steps"] > 0
    assert st["peak_bytes"] <= (cfg.prefetch_depth + 2) \
        * st["max_step_bytes"]
    assert st["peak_bytes"] < st["bytes_loaded"] / 4
    assert rm.stream_stats is None and rs.replan_events == []


def test_streamed_subsample_masks_equal_inmemory(stores, monkeypatch):
    """The streamed step draws the in-memory step's masks: the subsampled
    coefficients of every step are the same, shard by shard."""
    from repro_torch.core import disco
    _, y, X = _data()
    seen = []
    orig = disco.DiscoSolver._subsample

    def spy(self, c, k):
        out = orig(self, c, k)
        seen.append((self._streaming, k, (out == 0).cpu().numpy()))
        return out
    monkeypatch.setattr(disco.DiscoSolver, "_subsample", spy)
    for partition in ("samples", "features"):
        seen.clear()
        cfg = _cfg(partition, "subsampled", max_outer=3)
        _streamed(stores, partition, 4, cfg).fit()
        DiscoSolver(X, y, cfg, group=InProcessGroup(4), device="cpu").fit()
        s = [z for st, _, z in seen if st]
        mem = [z for st, _, z in seen if not st]
        assert len(s) == len(mem) == 3
        for a, b in zip(s, mem):
            np.testing.assert_array_equal(a, b)
