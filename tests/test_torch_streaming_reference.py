"""The port's streamed DiSCO solve against the JAX package's in-memory
solve (``REPRO_KERNEL_MODE=ref``; at m = 4 in one subprocess with four
forced host devices, the module fixture ``ref_m4``): ``w`` within rtol
1e-4 / atol 1e-6, relative L2 3e-4 at bf16; at ``hessian_subsample = 1.0``
only (ROADMAP F1). The reference's own streamed solve fails on this JAX
(ROADMAP F0). The settings and the ``stores`` fixture are
``tests/torch_streaming_common.py``'s.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.core import DiscoConfig as JDiscoConfig
from repro.core import DiscoSolver as JDiscoSolver
# _obs_clean, _one_thread (autouse) and stores are the shared module's
# fixtures
from torch_streaming_common import (_obs_clean, _one_thread, SRC, DATA, SOLVE,
                                    RTOL, ATOL, REL_BF16, VARIANTS, REF_CELLS,
                                    _data, _cfg, stores, _streamed, _rel)


# ---------------------------------------------------------------------------
# against the reference's in-memory solve
# ---------------------------------------------------------------------------

def _ref_kw(partition, variant):
    kw = dict(SOLVE, **VARIANTS[variant])
    kw["partition"] = partition
    return kw


SCRIPT_4 = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["REPRO_KERNEL_MODE"] = "ref"
    import jax
    import numpy as np
    assert len(jax.devices()) == 4
    from repro.core import DiscoConfig, DiscoSolver
    from repro.data.sparse import make_sparse_glm_data
    DATA, CASES = json.loads(sys.argv[1])
    X, y, _ = make_sparse_glm_data(**DATA)
    out = []
    for kw in CASES:
        axis = "model" if kw["partition"] == "features" else "data"
        r = DiscoSolver(X, y, DiscoConfig(**kw),
                        mesh=jax.make_mesh((4,), (axis,))).fit()
        out.append(dict(w=np.asarray(r.w).tolist(),
                        pcg_iters=[int(h["pcg_iters"]) for h in r.history],
                        partition_info=r.partition_info))
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_m4():
    cases = [c for c in REF_CELLS if c[1] == 4]
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-c", SCRIPT_4,
         json.dumps([DATA, [_ref_kw(p, v) for p, _, v in cases]])],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return dict(zip(cases, json.loads(line[len("RESULT "):])))


@pytest.mark.parametrize("partition,m,variant", REF_CELLS,
                         ids=[f"{p}-m{m}-{v}" for p, m, v in REF_CELLS])
def test_streamed_matches_reference_inmemory(stores, monkeypatch, ref_m4,
                                             partition, m, variant):
    X, y, _ = _data()
    cfg = _cfg(partition, variant)
    rs = _streamed(stores, partition, m, cfg).fit()
    if m == 1:
        monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")
        r = JDiscoSolver(X, y, JDiscoConfig(**_ref_kw(partition, variant))
                         ).fit()
        ref = dict(w=np.asarray(r.w), partition_info=r.partition_info)
    else:
        ref = ref_m4[(partition, m, variant)]
    assert rs.partition_info == ref["partition_info"]
    w_ref = np.asarray(ref["w"], np.float32)
    if cfg.hvp_dtype == "bfloat16":
        assert _rel(rs.w, w_ref) <= REL_BF16
    else:
        np.testing.assert_allclose(rs.w, w_ref, rtol=RTOL, atol=ATOL)
