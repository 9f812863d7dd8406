"""bf16 HVP tiles (``DiscoConfig(hvp_dtype='bfloat16')``) on the sparse
path, against the JAX package.

The same numpy inputs go through the JAX functions (Pallas kernels in
interpret mode, as the suite's conftest sets) and the port on the CPU
(the plain versions of ``repro_torch.kernels.ref``):

* the four blocked-ELL ops at bf16 tiles: relative L2 <= 1e-5 (the
  products are of two bf16 values, exact in f32; only the f32 sum order
  differs);
* ROADMAP F10: the JAX oracle ``ref_ell_mv`` does not round the vector
  operand, so at bf16 it misses the interpret kernel by more than 1e-4;
* the bf16 tiles bit for bit, ties included;
* the solver: the same PCG iterations every step, equal ``CommLedger``
  and partition info; one Newton step from the reference's own state
  within rtol 1e-4 / atol 1e-6; the whole 4-step solve within relative
  L2 :data:`BF16_REL_W` (ROADMAP F11: at bf16 a rounding point turns an
  f32-level difference into a bf16-level one wherever a value lies near
  a rounding tie, so the reference's own solve moves by up to 1.2e-4
  over two tilings of the same matrix, against 1e-7 at f32;
  :func:`test_f11_reference_moves_with_sum_order_at_bf16`);
* the reference's mixed-precision contract
  (``tests/test_hvp_fused.py``): the bf16 solve lands within 1e-4 of the
  f32 one, the bf16 copies are engaged while the margins' layouts stay
  f32, and f32 makes no copy;
* the HBM byte model of ``core/comm.py``.

At m = 2 the reference runs in a subprocess with two forced host devices.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import DiscoConfig as JDiscoConfig
from repro.core import DiscoSolver as JDiscoSolver
from repro.core import comm as jcomm
from repro.core import disco_fit as j_disco_fit
from repro.data import sparse as jsparse
from repro.data.sparse import ell_from_csr, make_sparse_glm_data
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import (CSRMatrix, DiscoConfig, DiscoSolver, InProcessGroup,
                         SoftmaxConfig, SoftmaxSolver, disco_fit)
from repro_torch.core.hvp import UnsupportedHvpError
from repro_torch.convert import STATE_KEYS, solver_from_arrays, w_to_port
from repro_torch.core import comm as tcomm
from repro_torch.data import sparse as tsparse
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sparse_hvp

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
BF16 = ml_dtypes.bfloat16
KERNEL_REL = 1e-5
RTOL, ATOL = 1e-4, 1e-6
# the whole solve: 2.4x the largest spread of the reference's own bf16
# solve over 16 x 16 and 8 x 8 tiles of this matrix among these cells
# (1.24e-4, DiSCO-F m = 2, s = 2; F11)
BF16_REL_W = 3e-4
MULTI_S = [1, 2, 5, 8]


def _rel(got, ref) -> float:
    return float(np.linalg.norm(np.asarray(got, np.float64) - ref)
                 / np.linalg.norm(np.asarray(ref, np.float64)))


def _layouts(block, seed=0):
    """Forward + transposed layouts with padding slots (the f32 tests'
    layouts, ``tests/test_torch_kernels.py``)."""
    X, _, _ = make_sparse_glm_data(d=70, n=90, density=0.05, seed=seed)
    fwd = ell_from_csr(X, block, block)
    tr = ell_from_csr(X.transpose(), block, block)
    assert (np.diff(fwd.cols, axis=1) <= 0).any()
    return fwd, tr


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf(data):
    """The same tiles for both packages: ml_dtypes bf16 for JAX, a torch
    bf16 tensor for the port."""
    return data.astype(BF16), _t(data).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# the four ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("with_c", [False, True])
@pytest.mark.parametrize("layout", ["forward", "transposed"])
def test_ell_matvec_bf16_matches_jax(block, with_c, layout):
    rng = np.random.default_rng(block)
    fwd, tr = _layouts(block)
    ell = fwd if layout == "forward" else tr
    n_in = ell.n_col_blocks * block
    v = rng.standard_normal(n_in).astype(np.float32)
    c = rng.uniform(0.0, 1.0, n_in).astype(np.float32) if with_c else None
    jd, td = _bf(ell.data)
    want = np.asarray(jops.ell_matvec(jd, ell.cols, v, c))
    got = tops.ell_matvec(td, _t(ell.cols), _t(v),
                          None if c is None else _t(c))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= KERNEL_REL


@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("with_c", [False, True])
@pytest.mark.parametrize("layout", ["forward", "transposed"])
@pytest.mark.parametrize("s", MULTI_S)
def test_ell_matmat_bf16_matches_jax(block, with_c, layout, s):
    rng = np.random.default_rng(100 + block + s)
    fwd, tr = _layouts(block)
    ell = fwd if layout == "forward" else tr
    n_in = ell.n_col_blocks * block
    V = rng.standard_normal((n_in, s)).astype(np.float32)
    c = rng.uniform(0.0, 1.0, n_in).astype(np.float32) if with_c else None
    jd, td = _bf(ell.data)
    want = np.asarray(jops.ell_matmat(jd, ell.cols, V, c))
    got = tops.ell_matmat(td, _t(ell.cols), _t(V),
                          None if c is None else _t(c))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= KERNEL_REL


@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("with_c", [False, True])
@pytest.mark.parametrize("with_fwd", [False, True])
def test_ell_hvp_bf16_matches_jax(block, with_c, with_fwd):
    rng = np.random.default_rng(10 + block)
    fwd, tr = _layouts(block, seed=1)
    u = rng.standard_normal(fwd.n_row_blocks * block).astype(np.float32)
    c = (rng.uniform(0.0, 1.0, tr.n_row_blocks * block).astype(np.float32)
         if with_c else None)
    jd, td = _bf(tr.data)
    jfd, tfd = _bf(fwd.data)
    want = np.asarray(jops.ell_hvp(jd, tr.cols, u, c,
                                   fwd=(jfd, fwd.cols) if with_fwd else None))
    got = tops.ell_hvp(td, _t(tr.cols), _t(u), None if c is None else _t(c),
                       fwd=(tfd, _t(fwd.cols)) if with_fwd else None)
    assert _rel(got.numpy(), want) <= KERNEL_REL


@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("with_c", [False, True])
@pytest.mark.parametrize("with_fwd", [False, True])
@pytest.mark.parametrize("s", MULTI_S)
def test_ell_hvp_mm_bf16_matches_jax(block, with_c, with_fwd, s):
    rng = np.random.default_rng(200 + block + s)
    fwd, tr = _layouts(block, seed=1)
    U = rng.standard_normal((fwd.n_row_blocks * block, s)).astype(np.float32)
    c = (rng.uniform(0.0, 1.0, tr.n_row_blocks * block).astype(np.float32)
         if with_c else None)
    jd, td = _bf(tr.data)
    jfd, tfd = _bf(fwd.data)
    want = np.asarray(jops.ell_hvp_mm(
        jd, tr.cols, U, c, fwd=(jfd, fwd.cols) if with_fwd else None))
    got = tops.ell_hvp_mm(td, _t(tr.cols), _t(U),
                          None if c is None else _t(c),
                          fwd=(tfd, _t(fwd.cols)) if with_fwd else None)
    assert _rel(got.numpy(), want) <= KERNEL_REL


def test_f10_oracle_misses_the_kernel_at_bf16():
    """ROADMAP F10: under bf16 tiles the TPU kernels round the vector
    operand to bf16 (``(c * v).astype(x.dtype)``; ``u`` and ``c * z`` in
    the fused HVP), the JAX oracles (``repro/kernels/ref.py``) do not. The
    oracle misses the interpret kernel by more than 1e-4; the port's plain
    versions follow the kernel (within 1e-5), and at f32 the two agree."""
    rng = np.random.default_rng(5)
    fwd, tr = _layouts(8, seed=1)
    v = rng.standard_normal(fwd.n_col_blocks * 8).astype(np.float32)
    c = rng.uniform(0.0, 1.0, fwd.n_col_blocks * 8).astype(np.float32)
    u = rng.standard_normal(fwd.n_row_blocks * 8).astype(np.float32)
    cT = rng.uniform(0.0, 1.0, tr.n_row_blocks * 8).astype(np.float32)
    jd, td = _bf(fwd.data)
    jdT, tdT = _bf(tr.data)
    kernel = np.asarray(jops.ell_matvec(jd, fwd.cols, v, c))
    oracle = np.asarray(jref.ref_ell_mv(jd, fwd.cols, v, c))
    port = tref.ref_ell_mv(td, _t(fwd.cols), _t(v), _t(c)).numpy()
    assert _rel(oracle, kernel) > 1e-4
    assert _rel(port, kernel) <= KERNEL_REL
    kernel = np.asarray(jops.ell_hvp(jdT, tr.cols, u, cT))
    oracle = np.asarray(jref.ref_ell_hvp_t(jdT, tr.cols, u, cT))
    port = tref.ref_ell_hvp_t(tdT, _t(tr.cols), _t(u), _t(cT)).numpy()
    assert _rel(oracle, kernel) > 1e-4
    assert _rel(port, kernel) <= KERNEL_REL
    # at f32 the rounding is the identity: oracle and kernel agree
    kernel = np.asarray(jops.ell_matvec(fwd.data, fwd.cols, v, c))
    oracle = np.asarray(jref.ref_ell_mv(fwd.data, fwd.cols, v, c))
    assert _rel(oracle, kernel) <= KERNEL_REL


def test_plain_versions_unchanged_at_f32():
    """The rounding points are the identity at f32 tiles: the plain
    versions give, bit for bit, what they compute without them."""
    rng = np.random.default_rng(6)
    fwd, tr = _layouts(16, seed=2)
    data, cols = _t(fwd.data), _t(fwd.cols)
    dataT, colsT = _t(tr.data), _t(tr.cols)
    v = _t(rng.standard_normal(fwd.n_col_blocks * 16).astype(np.float32))
    c = _t(rng.uniform(0, 1, fwd.n_col_blocks * 16).astype(np.float32))
    U = _t(rng.standard_normal((fwd.n_row_blocks * 16, 3))
           .astype(np.float32))
    g = (c * v).reshape(-1, 16)[cols.long()]
    y = torch.einsum("iwab,iwb->ia", data, g).reshape(-1)
    assert torch.equal(tref.ref_ell_mv(data, cols, v, c), y)
    Z = tref.ref_ell_mm(dataT, colsT, U)
    contrib = torch.einsum("jwab,jas->jwbs", dataT,
                           (c[:, None] * Z).reshape(-1, 16, 3))
    Y = torch.zeros((fwd.n_row_blocks, 16, 3))
    Y.index_add_(0, colsT.reshape(-1).long(), contrib.reshape(-1, 16, 3))
    assert torch.equal(tref.ref_ell_hvp_mm_t(dataT, colsT, U, c),
                       Y.reshape(-1, 3))


def test_handoff_criterion():
    """The card checks' criterion for a fused kernel's rounded hand-off
    (``ref.ell_handoff_flips``): the plain rounding agrees; one element
    rounded the other way at a tie within the f32 summation bound agrees;
    the same away from a tie, a value that is not bf16, or a hand-off
    rounded toward zero (about half the elements off) does not."""
    rng = np.random.default_rng(9)
    fwd, tr = _layouts(16, seed=1)
    dataT, colsT = _t(tr.data).to(torch.bfloat16), _t(tr.cols)
    U = _t(rng.standard_normal((fwd.n_row_blocks * 16, 2))
           .astype(np.float32))
    c = _t(rng.uniform(0, 1, tr.n_row_blocks * 16).astype(np.float32))
    t = tref.ref_ell_handoff_t(dataT, colsT, U, c)
    slack = tref.ell_handoff_slack(dataT, colsT, U, c, t)
    assert (slack >= 0).all() and (slack < 1e-2 * t.abs().max()).all()
    cz = t.to(torch.bfloat16).float()
    assert tref.ell_handoff_flips(cz, t, slack) == (0, True)
    big = int(t.abs().argmax())
    step = 2.0 ** (torch.floor(torch.log2(cz.flatten()[big].abs())) - 7)
    lo = cz.flatten()[big] - torch.sign(t.flatten()[big]) * step  # neighbour
    tied = t.clone().flatten()
    tied[big] = (cz.flatten()[big] + lo) / 2       # t exactly at the tie
    tied = tied.reshape(t.shape)
    other = cz.clone().flatten()
    other[big] = lo                                # the other neighbour
    other = other.reshape(t.shape)
    plain = tied.to(torch.bfloat16).float()
    kernel = other if not torch.equal(plain, other) else cz
    assert tref.ell_handoff_flips(kernel, tied, slack) == (1, True)
    assert not tref.ell_handoff_flips(other, t, slack)[1]    # not a tie
    assert not tref.ell_handoff_flips(cz + 1e-7 * cz.abs().max(), t,
                                      slack)[1]
    toward_zero = (t.view(torch.int32) & -65536).view(torch.float32)
    flips, ok = tref.ell_handoff_flips(toward_zero, t, slack)
    assert flips > t.numel() // 4 and not ok


# ---------------------------------------------------------------------------
# tiles and the dtype
# ---------------------------------------------------------------------------

def test_hvp_tile_dtype_spellings():
    for name in ("float32", "f32"):
        assert tsparse.hvp_tile_dtype(name) is torch.float32
        assert jsparse.hvp_tile_dtype(name) == np.float32
    for name in ("bfloat16", "bf16"):
        assert tsparse.hvp_tile_dtype(name) is torch.bfloat16
        assert jsparse.hvp_tile_dtype(name) == np.dtype(BF16)
    for name in ("float16", "fp32", ""):
        with pytest.raises(ValueError, match="unknown hvp_dtype"):
            tsparse.hvp_tile_dtype(name)
        with pytest.raises(ValueError, match="unknown hvp_dtype"):
            jsparse.hvp_tile_dtype(name)


def test_bf16_tiles_equal_the_reference_bits():
    """``build_shard_ell_pairs(dtype=torch.bfloat16)``'s tiles, as int16,
    are the reference's ``astype(hvp_tile_dtype('bfloat16'))`` tiles as
    uint16, on power-law data and on values at exact rounding ties (to
    even, both ways) and next to them."""
    X, _, _ = make_sparse_glm_data(d=70, n=90, density=0.1, seed=3)
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -7)      # bf16's spacing at 1
    ties = np.array([one + ulp / 2, one + 3 * ulp / 2, -(one + ulp / 2),
                     np.nextafter(one + ulp / 2, np.float32(2)),
                     np.nextafter(one + ulp / 2, np.float32(0)),
                     np.float32(3.0e-39), np.float32(65504.5)], np.float32)
    data = X.data.copy()
    data[:len(ties)] = ties
    Xj = jsparse.CSRMatrix(X.indptr, X.indices, data, X.shape)
    Xt = tsparse.CSRMatrix(X.indptr, X.indices, data, X.shape)
    halves = [np.arange(35), np.arange(35, 70)]
    jd, jc, jdT, jcT = jsparse.build_shard_ell_pairs(
        [Xj.take_rows(h) for h in halves], 8, 8,
        dtype=jsparse.hvp_tile_dtype("bfloat16"))
    td, tc, tdT, tcT = tsparse.build_shard_ell_pairs(
        [Xt.take_rows(h) for h in halves], 8, 8,
        dtype=tsparse.hvp_tile_dtype("bfloat16"))
    assert td.dtype == tdT.dtype == torch.bfloat16
    assert td.device.type == "cpu"
    np.testing.assert_array_equal(td.view(torch.int16).numpy(),
                                  jd.view(np.uint16).astype(np.int16))
    np.testing.assert_array_equal(tdT.view(torch.int16).numpy(),
                                  jdT.view(np.uint16).astype(np.int16))
    for a, b in ((tc, jc), (tcT, jcT)):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    # the ties really are in the tiles, rounded to even
    bits = set(td.view(torch.int16).flatten().tolist())
    assert int(torch.tensor(1.0).to(torch.bfloat16).view(torch.int16)) in bits
    # f32 (or no dtype) gives the numpy f32 arrays
    f32 = tsparse.build_shard_ell_pairs([Xt], 8, 8, dtype=torch.float32)
    assert isinstance(f32[0], np.ndarray) and f32[0].dtype == np.float32


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

KW = dict(loss="logistic", lam=1e-2, tau=100, max_outer=4, grad_tol=0.0,
          ell_block_d=16, ell_block_n=16, hvp_dtype="bfloat16")
DATA = dict(d=96, n=200, density=0.2, alpha=0.8, beta=0.5, seed=1)
# partition, fused, s
CELLS = [(p, f, s) for p in ("samples", "features") for f in (False, True)
         for s in (1, 2)]
cell_id = lambda c: f"{c[0]}-{'fused' if c[1] else 'two-pass'}-s{c[2]}"


def _data():
    X, y, _ = make_sparse_glm_data(**DATA)
    return X, y, CSRMatrix(X.indptr, X.indices, X.data, X.shape)


def _summary(res) -> dict:
    led = res.ledger
    return dict(w=np.asarray(res.w).tolist(),
                pcg_iters=[int(h["pcg_iters"]) for h in res.history],
                ledger=[led.rounds, led.floats, led.spmd_collectives],
                partition_info=res.partition_info)


def _cfg(cell, **kw):
    partition, fused, s = cell
    return dict(KW, partition=partition, hvp_fused=fused, pcg_block_s=s,
                **kw)


def _assert_matches(got, ref: dict):
    s = _summary(got)
    assert s["pcg_iters"] == ref["pcg_iters"]
    assert s["ledger"] == ref["ledger"]
    assert s["partition_info"] == ref["partition_info"]
    assert _rel(got.w, np.asarray(ref["w"], np.float64)) <= BF16_REL_W


SCRIPT_2 = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    import numpy as np
    assert len(jax.devices()) == 2
    from repro.core import DiscoConfig, disco_fit
    from repro.data.sparse import make_sparse_glm_data
    KWS, DATA = json.loads(sys.argv[1])
    X, y, _ = make_sparse_glm_data(**DATA)
    out = []
    for kw in KWS:
        axis = "model" if kw["partition"] == "features" else "data"
        r = disco_fit(X, y, DiscoConfig(**kw),
                      mesh=jax.make_mesh((2,), (axis,)))
        led = r.ledger
        out.append(dict(w=np.asarray(r.w).tolist(),
                        pcg_iters=[int(h["pcg_iters"]) for h in r.history],
                        ledger=[led.rounds, led.floats,
                                led.spmd_collectives],
                        partition_info=r.partition_info))
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_2device_runs():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               REPRO_KERNEL_MODE="interpret")
    env.pop("XLA_FLAGS", None)
    kws = [_cfg(c) for c in CELLS]
    r = subprocess.run([sys.executable, "-c", SCRIPT_2,
                        json.dumps([kws, DATA])], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return dict(zip(CELLS, json.loads(line[len("RESULT "):])))


@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_bf16_solve_matches_jax(cell):
    X, y, Xt = _data()
    ref = _summary(j_disco_fit(X, y, JDiscoConfig(**_cfg(cell))))
    got = disco_fit(Xt, y, DiscoConfig(**_cfg(cell)), device="cpu")
    _assert_matches(got, ref)
    assert got.grad_norms[-1] < 0.5 * got.grad_norms[0]


@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_bf16_solve_2shards_matches_jax(jax_2device_runs, cell):
    _, y, Xt = _data()
    got = disco_fit(Xt, y, DiscoConfig(**_cfg(cell)),
                    group=InProcessGroup(2), device="cpu")
    assert got.partition_info["m"] == 2
    _assert_matches(got, jax_2device_runs[cell])


@pytest.mark.parametrize("partition", ["samples", "features"])
@pytest.mark.parametrize("fused", [False, True])
def test_bf16_step_from_reference_state_matches_jax(partition, fused):
    """One Newton step from the JAX solver's own arrays and a random
    iterate: w_new and the step's stats within rtol 1e-4 / atol 1e-6,
    the same PCG iterations. (The port converts the reference's f32
    layouts and casts its own bf16 copies, which equal the reference's.)
    """
    X, y, _ = _data()
    kw = _cfg((partition, fused, 1))
    js = JDiscoSolver(X, y, JDiscoConfig(**kw))
    arrays = {k: np.asarray(getattr(js, k)) for k in STATE_KEYS[partition]}
    arrays["perm"] = js._part.perm
    ps = solver_from_arrays(arrays, X.shape, DiscoConfig(**kw), device="cpu")
    assert np.array_equal(ps.ell_dataT_h.float().numpy(),
                          np.asarray(js.ell_dataT_h).astype(np.float32))
    w = (0.1 * np.random.default_rng(7).standard_normal(
        int(np.prod(js._w_shape)))).astype(np.float32)
    jw, jstats = js._step(jnp.asarray(w), jax.random.PRNGKey(0))
    pw, pstats = ps._step(w_to_port(ps, w))
    np.testing.assert_allclose(pw.reshape(-1).numpy(), np.asarray(jw),
                               rtol=RTOL, atol=ATOL)
    assert pstats["pcg_iters"] == int(jstats["pcg_iters"]) > 1
    for k in ("grad_norm", "f", "delta", "pcg_r_norm"):
        np.testing.assert_allclose(float(pstats[k]), float(jstats[k]),
                                   rtol=1e-5)


def test_f11_reference_moves_with_sum_order_at_bf16():
    """ROADMAP F11: the reference's own solve, on 16 x 16 and on 8 x 8
    tiles of the same matrix (another f32 summation order, the same
    math), ends 1e-7 apart at f32 and more than 1e-5 apart at bf16 after
    4 Newton steps, with the same PCG iterations. The bf16 solve tests
    hold the port to :data:`BF16_REL_W` for this reason."""
    X, y, _ = _data()
    spread = {}
    for dt in ("float32", "bfloat16"):
        runs = [j_disco_fit(X, y, JDiscoConfig(**dict(
            _cfg(("samples", False, 1)), hvp_dtype=dt, ell_block_d=b,
            ell_block_n=b))) for b in (16, 8)]
        assert ([h["pcg_iters"] for h in runs[0].history]
                == [h["pcg_iters"] for h in runs[1].history])
        spread[dt] = _rel(runs[1].w, np.asarray(runs[0].w, np.float64))
    assert spread["float32"] < 1e-6
    assert spread["bfloat16"] > 1e-5
    assert spread["bfloat16"] <= BF16_REL_W


def test_bf16_converges_to_f32_optimum():
    """The reference's mixed-precision contract
    (``tests/test_hvp_fused.py::test_solver_bf16_converges_to_f32_optimum``)
    on the port: bf16 curvature with f32 first-order terms lands within
    1e-4 of the port's f32 solve."""
    X, y, _ = make_sparse_glm_data(d=96, n=160, density=0.2, alpha=1.0,
                                   beta=0.5, seed=4)
    Xt = CSRMatrix(X.indptr, X.indices, X.data, X.shape)
    kw = dict(loss="logistic", lam=1e-2, tau=16, max_outer=12,
              grad_tol=1e-9, ell_block_d=8, ell_block_n=8,
              partition_block=16)
    for partition in ("features", "samples"):
        r0 = disco_fit(Xt, y, DiscoConfig(partition=partition, **kw),
                       device="cpu")
        rb = disco_fit(Xt, y, DiscoConfig(partition=partition,
                                          hvp_fused=True,
                                          hvp_dtype="bfloat16", **kw),
                       device="cpu")
        rel = np.linalg.norm(rb.w - r0.w) / np.linalg.norm(r0.w)
        assert rel <= 1e-4, (partition, rel)


def test_bf16_tiles_engaged_and_f32_makes_no_copy():
    """The reference's ``test_solver_bf16_tiles_actually_engaged`` on the
    port: PCG's shards hold bf16 copies, the margins' and gradient's stay
    f32; the default shares the f32 tensors. The copies share the f32
    layouts' live-tile schedules and cols; the step schedule counts
    2-byte tiles; ``with_lam`` shares the copies."""
    X, y, Xt = _data()
    cfg = DiscoConfig(partition="samples", loss="logistic", lam=1e-2,
                      tau=16, ell_block_d=8, ell_block_n=8,
                      hvp_dtype="bfloat16")
    s = DiscoSolver(Xt, y, cfg, device="cpu")
    assert s.ell_data_h.dtype == s.ell_dataT_h.dtype == torch.bfloat16
    assert s.ell_data.dtype == s.ell_dataT.dtype == torch.float32
    assert torch.equal(s.ell_data_h, s.ell_data.to(torch.bfloat16))
    for loc, hloc in zip(s._locs, s._hvp_locs):
        assert loc.data.dtype == torch.float32
        assert hloc.data.dtype == hloc.dataT.dtype == torch.bfloat16
        for name in ("cols", "colsT", "sched", "schedT"):
            assert (getattr(hloc, name).data_ptr()
                    == getattr(loc, name).data_ptr())
    nbT = s.ell_dataT.shape[1]
    live = sparse_hvp.schedule_parts(s.ell_schedT[0], nbT)[0]
    half = sparse_hvp.ell_hvp_schedule(s.ell_dataT[0], s.ell_colsT[0],
                                       s.ell_hvp_sched[0].ctas,
                                       s.ell_hvp_sched[0].step_bytes // 2,
                                       live=live)
    assert torch.equal(s.ell_hvp_sched[0].table, half.table)
    lam2 = s.with_lam(1e-3)
    assert lam2.ell_data_h is s.ell_data_h and lam2._hvp_locs is s._hvp_locs
    s32 = DiscoSolver(Xt, y, DiscoConfig(partition="samples",
                                         ell_block_d=8, ell_block_n=8),
                      device="cpu")
    assert s32.ell_data_h is s32.ell_data
    assert s32.ell_dataT_h is s32.ell_dataT
    assert s32._hvp_locs is s32._locs


def test_dense_bf16_raises_not_yet_ported():
    """bf16 on dense input runs on every dense path: the two-pass kernels
    and the plain layout (``tests/test_torch_dense_bf16.py``), and, since
    the one-pass kernels K5 and K10 take bf16 tiles, with
    ``hvp_fused=True`` too, classic and s-step (it raised "not yet
    ported" until then; ``tests/test_torch_fused_bf16.py`` holds it to
    the reference): it builds PCG's shards as views of one bf16 copy and
    takes a step. Softmax never fuses: its fused cell is the registry's
    refusal at every dtype, as in the reference."""
    X, y, _ = _data()
    for s in (1, 2):
        solver = DiscoSolver(X.todense(), y, DiscoConfig(
            use_kernel=True, hvp_fused=True, pcg_block_s=s,
            hvp_dtype="bfloat16"), device="cpu")
        assert solver.X_h.dtype == torch.bfloat16
        assert all(h.dtype == torch.bfloat16 for h in solver._hvp_locs)
        w, stats = solver._step(torch.zeros(solver._w_shape))
        assert torch.isfinite(w).all() and stats["pcg_iters"] > 0
    for use_kernel in (False, True):
        DiscoSolver(X.todense(), y, DiscoConfig(
            use_kernel=use_kernel, hvp_dtype="bfloat16"), device="cpu")
    with pytest.raises(UnsupportedHvpError, match="coupling"):
        SoftmaxSolver(X.todense(), (y > 0).astype(np.int64), SoftmaxConfig(
            use_kernel=True, hvp_fused=True, hvp_dtype="bfloat16"),
            device="cpu")


# ---------------------------------------------------------------------------
# the HBM byte model
# ---------------------------------------------------------------------------

def test_byte_model_matches_reference():
    assert tcomm.BYTES_BF16 == jcomm.BYTES_BF16 == 2
    for name in ("float32", "f32", "bfloat16", "bf16"):
        assert tcomm.hvp_dtype_bytes(name) == jcomm.hvp_dtype_bytes(name)
    with pytest.raises(ValueError):
        tcomm.hvp_dtype_bytes("float16")
    for nnz in (0, 1, 1534142):
        assert tcomm.sparse_hvp_flops(nnz) == jcomm.sparse_hvp_flops(nnz)
    for d, n, s in ((4096, 262144, 1), (131, 77, 5)):
        for fused in (False, True):
            for b in (4, 2):
                assert (tcomm.dense_hvp_bytes(d, n, s, fused=fused,
                                              dtype_bytes=b)
                        == jcomm.dense_hvp_bytes(d, n, s, fused=fused,
                                                 dtype_bytes=b))
                assert (tcomm.ell_hvp_bytes(58830, 44141, 128, 128,
                                            fused=fused, dtype_bytes=b)
                        == jcomm.ell_hvp_bytes(58830, 44141, 128, 128,
                                               fused=fused, dtype_bytes=b))
    for nnz in ([10, 10, 10], [1, 5, 9, 2], [0, 0], [7]):
        assert tcomm.straggler_factor(nnz) == jcomm.straggler_factor(nnz)
    for partition in ("samples", "features"):
        for m, s in ((1, 1), (4, 1), (4, 5)):
            for fused in (False, True):
                for b in (4, 2):
                    args = ([400, 700, 500, 380][:m], 86, partition, 20242,
                            47236, m, s)
                    kw = dict(hvp_fused=fused, hvp_dtype_bytes=b)
                    assert (tcomm.disco_sparse_iter_time(*args, **kw)
                            == jcomm.disco_sparse_iter_time(*args, **kw))
    with pytest.raises(ValueError):
        tcomm.disco_sparse_iter_time([1], 1, "rows", 2, 2, 1)
