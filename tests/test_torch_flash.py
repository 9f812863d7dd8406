"""The port's flash attention against the JAX package's.

Same numpy inputs through ``repro.kernels.ops.flash_attention`` (the
Pallas kernel in interpret mode, as the suite's conftest sets, blocks of
64) and ``repro_torch.kernels.ops.flash_attention`` on CPU tensors, which
runs the kernel's plain version ``flash_attention_ref``. Tolerances are the
JAX package's own flash tests': atol = rtol = 2e-5 in f32 (the online
softmax sums in another order) and 3e-2 in bf16 (the output's rounding).
The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash_kernel
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

F32_TOL = 2e-5
BF16_TOL = 3e-2

# tests/test_kernels.py's sweep: B, Hq, Hkv, S, Dh, causal, window (S == T)
CASES = [
    (2, 4, 2, 128, 64, True, 0),
    (1, 8, 2, 256, 64, True, 64),
    (2, 2, 2, 96, 32, False, 0),
    (1, 4, 1, 200, 64, True, 0),
    (1, 4, 4, 130, 64, False, 50),
    (1, 16, 4, 64, 128, True, 0),
]
# S != T: B, Hq, Hkv, S, T, Dh, causal, window; every row attends a key
UNEVEN = [
    (1, 4, 2, 100, 160, 64, True, 0),
    (1, 4, 4, 160, 100, 32, True, 0),
    (2, 2, 1, 96, 200, 64, False, 50),
    (1, 5, 1, 130, 70, 128, False, 0),
    (1, 4, 2, 63, 97, 32, True, 40),
]


def _qkv(B, Hq, Hkv, S, T, Dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, S, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, Dh)).astype(np.float32)
    return q, k, v


def _jax(fn, q, k, v, dtype=jnp.float32, **kw):
    out = fn(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
             jnp.asarray(v, dtype), **kw)
    return np.asarray(out.astype(jnp.float32))


def _port(fn, q, k, v, dtype=torch.float32, **kw):
    out = fn(torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
             torch.from_numpy(v).to(dtype), **kw)
    return out.float().numpy()


@pytest.mark.parametrize("B,Hq,Hkv,S,Dh,causal,win", CASES)
def test_flash_op_matches_jax(B, Hq, Hkv, S, Dh, causal, win):
    q, k, v = _qkv(B, Hq, Hkv, S, S, Dh, seed=S + Dh)
    want = _jax(jops.flash_attention, q, k, v, causal=causal, window=win,
                block_q=64, block_k=64)
    got = _port(tops.flash_attention, q, k, v, causal=causal, window=win)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    # with S == T the kernel's function is the oracle's (F2)
    oracle = _port(tref.ref_attention, q, k, v, causal=causal, window=win)
    np.testing.assert_allclose(got, oracle, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("B,Hq,Hkv,S,T,Dh,causal,win", UNEVEN)
def test_flash_op_matches_jax_uneven(B, Hq, Hkv, S, T, Dh, causal, win):
    """S != T: the JAX op pads both to block multiples and masks the keys
    past T; the port takes them as they are."""
    q, k, v = _qkv(B, Hq, Hkv, S, T, Dh, seed=S * T)
    want = _jax(jops.flash_attention, q, k, v, causal=causal, window=win,
                block_q=64, block_k=64)
    got = _port(tops.flash_attention, q, k, v, causal=causal, window=win)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("causal,win", [(True, 0), (False, 0), (True, 50)])
def test_flash_kv_len_matches_jax_kernel(causal, win):
    """Keys at or past kv_len are never attended: the plain version against
    the Pallas kernel called with the same kv_len."""
    q, k, v = _qkv(1, 4, 2, 128, 192, 64, seed=7)
    want = _jax(jax_flash_kernel, q, k, v, causal=causal, window=win,
                block_q=64, block_k=64, kv_len=150, interpret=True)
    got = _port(tref.flash_attention_ref, q, k, v, causal=causal, window=win,
                kv_len=150)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    # and kv_len = 150 is the same as cutting k and v to 150 keys
    cut = _port(tref.flash_attention_ref, q, k[:, :, :150], v[:, :, :150],
                causal=causal, window=win)
    np.testing.assert_allclose(got, cut, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("Hq,Hkv,S,causal,win", [
    (4, 4, 128, True, 0), (4, 4, 192, True, 64), (8, 2, 128, False, 0),
    (8, 2, 192, True, 50)], ids=["causal", "window", "gqa", "gqa-window"])
def test_flash_at_head_dim_80_matches_jax_kernel(Hq, Hkv, S, causal, win):
    """zamba2-2.7b's head_dim: the plain version against the Pallas kernel
    in interpret mode (its blocks span the whole 80 columns)."""
    q, k, v = _qkv(1, Hq, Hkv, S, S, 80, seed=S + Hq)
    want = _jax(jax_flash_kernel, q, k, v, causal=causal, window=win,
                block_q=64, block_k=64, interpret=True)
    got = _port(tref.flash_attention_ref, q, k, v, causal=causal, window=win)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    op = _port(tops.flash_attention, q, k, v, causal=causal, window=win)
    np.testing.assert_array_equal(op, got)
    assert 80 in tflash.HEAD_DIMS


@pytest.mark.parametrize("Hkv,S,T,win", [(2, 128, 128, 0), (1, 96, 160, 0),
                                          (2, 130, 130, 50)])
def test_flash_op_bf16_matches_jax(Hkv, S, T, win):
    q, k, v = _qkv(1, 4, Hkv, S, T, 64, seed=S + T)
    want = _jax(jops.flash_attention, q, k, v, jnp.bfloat16, window=win,
                block_q=64, block_k=64)
    got = _port(tops.flash_attention, q, k, v, torch.bfloat16, window=win)
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL)
    out = tops.flash_attention(*(torch.from_numpy(a).bfloat16()
                                 for a in (q, k, v)), window=win)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


@pytest.mark.parametrize("B,Hq,Hkv,S,T,Dh,causal,win", [
    (1, 4, 2, 100, 160, 64, True, 0),
    (1, 4, 4, 64, 64, 32, True, 20),
    (2, 6, 3, 80, 48, 32, False, 0),
    (1, 2, 1, 96, 200, 64, False, 50),
    (1, 2, 2, 160, 100, 32, True, 0),      # rows q < S - T attend no key
])
def test_ref_attention_matches_jax_oracle(B, Hq, Hkv, S, T, Dh, causal, win):
    q, k, v = _qkv(B, Hq, Hkv, S, T, Dh, seed=3)
    want = _jax(jref.ref_attention, q, k, v, causal=causal, window=win)
    got = _port(tref.ref_attention, q, k, v, causal=causal, window=win)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL,
                               equal_nan=True)
    assert np.isnan(got).any() == (causal and S > T)


@pytest.mark.parametrize("S,T", [(100, 160), (160, 100)])
def test_f2_kernel_and_oracle_differ_when_s_ne_t(S, T):
    """ROADMAP F2: the kernel lines positions up from 0, the oracle lines
    the last q up with the last k, in both packages; each port function
    equals its own JAX counterpart."""
    q, k, v = _qkv(1, 2, 2, S, T, 32, seed=11)
    jk = _jax(jops.flash_attention, q, k, v, block_q=64, block_k=64)
    jo = _jax(jref.ref_attention, q, k, v)
    tk = _port(tops.flash_attention, q, k, v)
    to = _port(tref.ref_attention, q, k, v)
    rows = slice(max(0, S - T), S)     # rows the oracle does not leave NaN
    assert np.abs(jk[:, :, rows] - jo[:, :, rows]).max() > 0.1
    assert np.abs(tk[:, :, rows] - to[:, :, rows]).max() > 0.1
    np.testing.assert_allclose(tk, jk, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(to, jo, atol=F32_TOL, rtol=F32_TOL,
                               equal_nan=True)


def test_rows_with_no_key_are_zero():
    """A row that attends no key (here: past T + window - 1 under a causal
    window) is 0 and never NaN; every other row matches the JAX op."""
    q, k, v = _qkv(1, 4, 1, 200, 97, 32, seed=5)
    got = _port(tops.flash_attention, q, k, v, causal=True, window=64)
    assert np.isfinite(got).all()
    empty = np.arange(200) >= 97 + 64 - 1
    assert (got[:, :, empty] == 0).all()
    want = _jax(jops.flash_attention, q, k, v, causal=True, window=64,
                block_q=64, block_k=64)
    np.testing.assert_allclose(got[:, :, ~empty], want[:, :, ~empty],
                               atol=F32_TOL, rtol=F32_TOL)


def test_scale_argument():
    q, k, v = _qkv(1, 2, 2, 40, 40, 32, seed=2)
    a = _port(tops.flash_attention, q, k, v, scale=0.3)
    b = _port(tops.flash_attention, q * (0.3 / 32 ** -0.5), k, v)
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_cpu_op_launches_no_kernel():
    build.reset_launch_counts()
    q, k, v = (torch.ones((1, 2, 5, 32)), torch.ones((1, 1, 7, 32)),
               torch.ones((1, 1, 7, 32)))
    tops.flash_attention(q, k, v)
    assert build.launch_counts()["flash_attention"] == 0


def test_kernel_wrapper_checks_and_refuses_cpu_tensors():
    """The wrapper raises on what the kernel does not take, and on CPU
    tensors it raises rather than run the plain version."""
    ok = lambda *s: torch.zeros(s)
    q, k = ok(1, 4, 10, 64), ok(1, 2, 12, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, k, k)
    bad = [
        ((ok(1, 4, 10, 48), ok(1, 2, 12, 48), ok(1, 2, 12, 48)), {},
         ValueError, "head_dim"),
        ((q.half(), k.half(), k.half()), {}, TypeError, "float32 or bfloat16"),
        ((q, k.bfloat16(), k.bfloat16()), {}, TypeError, "dtypes differ"),
        ((q.transpose(2, 3), k, k), {}, ValueError, "4-D|contiguous|must be"),
        ((ok(1, 3, 10, 64), k, k), {}, ValueError, "multiple of kv-heads"),
        ((q, k, ok(1, 2, 11, 64)), {}, ValueError, "must be"),
        ((q, k, k), {"kv_len": 13}, ValueError, "kv_len"),
        ((q, k, k), {"window": -1}, ValueError, "window"),
        ((ok(1, 4, 0, 64), k, k), {}, ValueError, "empty"),
        ((q[..., 0], k, k), {}, ValueError, "4-D"),
    ]
    for args, kw, exc, msg in bad:
        with pytest.raises(exc, match=msg):
            tflash.flash_attention(*args, **kw)


def test_kernel_entry_takes_the_wrappers_arguments():
    """The C entry point's parameters are the ctypes argument list: four
    pointers, the 12 strides, then the shape and flags."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    sig = re.search(r'extern "C" int flash_attention_launch\(([^)]*)\)', src)
    params = [p.strip() for p in sig.group(1).split(",")]
    assert len(params) == len(build.FLASH_ATTENTION.argtypes) == 17
    assert params[4] == "const long long* strides"
    assert params[14].startswith("float scale")
    assert "repro/kernels/flash_attention.py" in src
    for dh in tflash.HEAD_DIMS:
        assert f"case {dh}:" in src


# ---------------------------------------------------------------------------
# strided q, k, v: (B, S, H, Dh) tensors seen as (B, H, S, Dh)
# ---------------------------------------------------------------------------

def _head_major(a, dtype=torch.float32):
    """A (B, H, S, Dh) numpy array as a view of a (B, S, H, Dh) tensor."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                            ).to(dtype).transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Dh", tflash.HEAD_DIMS)
def test_kernel_wrapper_takes_head_major_views(dtype, Dh):
    """A transposed (B, S, H, Dh) view passes every layout check and meets
    only the refusal of CPU tensors."""
    q = torch.zeros((2, 10, 4, Dh), dtype=dtype).transpose(1, 2)
    k = torch.zeros((2, 12, 2, Dh), dtype=dtype).transpose(1, 2)
    assert not q.is_contiguous()
    tflash.check_args(q, k, k, 0, 12)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, k, k)


def test_kernel_wrapper_refuses_bad_strides():
    ok = torch.zeros((1, 10, 4, 64)).transpose(1, 2)
    wide = torch.zeros((1, 10, 4, 66))          # rows of 264 bytes
    flat = torch.zeros(1 * 4 * 10 * 64 + 1)
    bad = [
        (ok.transpose(2, 3), "last dimension must be contiguous"),
        (wide[..., :64].transpose(1, 2), "multiples of 16 bytes"),
        (torch.zeros((1, 1, 10, 64)).expand(1, 4, 10, 64),
         "multiples of 16 bytes"),
        (flat[1:].view(1, 4, 10, 64), "16-byte aligned"),
    ]
    for q, msg in bad:
        with pytest.raises(ValueError, match=msg):
            tflash.flash_attention(q, ok, ok)
        with pytest.raises(ValueError, match=msg):
            tflash.flash_attention(ok, q[:, :4], q[:, :4])


@pytest.mark.parametrize("B,Hq,Hkv,S,Dh,causal,win", CASES)
def test_flash_op_on_head_major_views_matches_jax(B, Hq, Hkv, S, Dh, causal,
                                                  win):
    """ops.flash_attention on transposed (B, S, H, Dh) views equals the JAX
    op on the same numbers laid out (B, H, S, Dh)."""
    q, k, v = _qkv(B, Hq, Hkv, S, S + 7, Dh, seed=S + Dh + 1)
    want = _jax(jops.flash_attention, q, k, v, causal=causal, window=win,
                block_q=64, block_k=64)
    got = tops.flash_attention(_head_major(q), _head_major(k),
                               _head_major(v), causal=causal, window=win)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL,
                               rtol=F32_TOL)


def test_output_for_follows_q():
    """o lies as q does when q is a transposed (B, S, H, Dh) view (so the
    caller's transpose back is free), else it is contiguous."""
    contiguous = torch.zeros((2, 4, 10, 32))
    view = torch.zeros((2, 10, 4, 32)).transpose(1, 2)
    sliced = torch.zeros((2, 10, 4, 40))[..., :32].transpose(1, 2)
    for q, head_major in ((contiguous, False), (view, True),
                          (sliced, False)):
        o = tflash.output_for(q)
        assert o.shape == q.shape and o.dtype == q.dtype
        assert o.transpose(1, 2).is_contiguous() == head_major
        assert o.is_contiguous() != head_major


def test_kernel_strides():
    view = torch.zeros((2, 10, 4, 32)).transpose(1, 2)
    assert tflash.kernel_strides(view) == (10 * 4 * 32, 32, 4 * 32)
    # a dimension of size 1 takes the contiguous stride, whatever torch says
    one = torch.zeros((1, 10, 1, 32)).transpose(1, 2)
    assert tflash.kernel_strides(one) == (10 * 32, 10 * 32, 32)
    lone = torch.zeros((1, 4, 1, 32))
    assert tflash.kernel_strides(lone) == (4 * 32, 32, 32)


def test_attention_block_passes_views(monkeypatch):
    """The prefill hands the kernel head-major views of its (B, S, H, Dh)
    projections, no copies, and its output matches the copying layout."""
    from repro_torch import forward, get_smoke_config, init_params
    from repro_torch.models import attention
    cfg = get_smoke_config("chatglm3-6b")
    model = init_params(cfg, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24))
    seen = []
    plain = attention.ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append([t.transpose(1, 2).is_contiguous() and not
                     t.is_contiguous() for t in (q, k, v)])
        return plain(q.contiguous(), k.contiguous(), v.contiguous(), **kw)
    want, _ = forward(cfg, model, {"tokens": tokens})
    monkeypatch.setattr(attention.ops, "flash_attention", spy)
    got, _ = forward(cfg, model, {"tokens": tokens})
    assert seen == [[True, True, True]] * cfg.num_layers
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)
