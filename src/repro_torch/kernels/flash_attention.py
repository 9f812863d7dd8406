"""Hand-written CUDA flash attention (prefill) and its launch wrapper.

``flash_attention`` (``csrc/flash_attention.cu``) replaces the Pallas TPU
kernel ``repro/kernels/flash_attention.py::flash_attention``: online-softmax
attention with GQA, causal, sliding-window and ``kv_len`` masks, and
skipping of the kv tiles a q tile cannot attend. It is built and bound by
:mod:`repro_torch.kernels.build` and runs on PyTorch's current stream.

Shapes as the JAX kernel: q (B, Hq, S, Dh), k/v (B, Hkv, T, Dh), f32 or
bf16, Hq % Hkv == 0, Dh in :data:`HEAD_DIMS`. Any layout whose last
dimension has stride 1 and whose other strides are multiples of 16 bytes
is read where it lies, a ``(B, S, H, Dh)`` tensor seen through
``.transpose(1, 2)`` included, so a model need not copy its projections
head-major; the output then lies the same way (:func:`output_for`). The
bf16 kernel runs on wgmma and TMA (tensor maps over these strides). S and
T are taken as they are (the JAX op pads them to block multiples; the
kernel masks its ragged tiles). Scores, softmax statistics and the sum
are f32; the output is in q's dtype. Positions run from 0 for q and k
alike, as in the TPU kernel, so with S != T it computes
:func:`~repro_torch.kernels.ref.flash_attention_ref`, not
:func:`~repro_torch.kernels.ref.ref_attention` (ROADMAP F2). No atomics:
each result repeats bit for bit. A failed launch raises; nothing here
falls back to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import FLASH_ATTENTION, check_card, ptr, stream_of

# the head dims with a kernel instance: those of the repository's configs
# (128 the transformers', 80 zamba2-2.7b's shared blocks', 64
# whisper-medium's, 32 the smoke configs'); at 80 the bf16 kernel runs in
# the 128-column layout (csrc/flash_attention.cu)
HEAD_DIMS = (32, 64, 80, 128)
DTYPES = (torch.float32, torch.bfloat16)


def check_args(q, k, v, window, kv_len) -> None:
    """Raise on anything the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous "
                             f"(stride 1), got strides {t.stride()}")
        if any(n > 1 and (st <= 0 or st * t.element_size() % 16)
               for n, st in zip(t.shape[:3], t.stride()[:3])):
            raise ValueError(f"{name}'s strides {t.stride()} must be "
                             f"positive multiples of 16 bytes")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k, v lie on different devices")
    B, Hq, S, Dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"({B}, Hkv, T, {Dh})")
    Hkv, T = k.shape[1], k.shape[2]
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} is not one of {HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q-heads {Hq} must be a multiple of kv-heads {Hkv}")
    if min(B, Hq, S, T) == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"batch {B} or heads {Hq} above the grid's 65535")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if not 0 <= kv_len <= T:
        raise ValueError(f"kv_len {kv_len} outside [0, {T}]")


def kernel_strides(t) -> tuple[int, int, int]:
    """The (batch, head, row) element strides the kernel takes for a 4-D
    tensor. A dimension of size 1 is given the stride a contiguous tensor
    would have there: it is never stepped, and the tensor maps want
    multiples of 16 bytes."""
    B, H, S, Dh = t.shape
    contiguous = (H * S * Dh, S * Dh, Dh)
    return tuple(t.stride(d) if t.shape[d] > 1 else contiguous[d]
                 for d in range(3))


def output_for(q):
    """An empty output for ``q``: (B, S, Hq, Dh) storage returned as
    ``.transpose(1, 2)`` when q is such a view of a (B, S, Hq, Dh) tensor,
    so that the caller's transpose back is free; else contiguous."""
    B, Hq, S, Dh = q.shape
    if not q.is_contiguous() and q.transpose(1, 2).is_contiguous():
        return torch.empty((B, S, Hq, Dh), dtype=q.dtype,
                           device=q.device).transpose(1, 2)
    return torch.empty((B, Hq, S, Dh), dtype=q.dtype, device=q.device)


def flash_attention(q, k, v, *, causal=True, window=0, scale=None,
                    kv_len=None):
    """Attention on the card: (B, Hq, S, Dh) in q's dtype, laid out as
    :func:`output_for` says.

    ``window > 0`` keeps keys with q_pos - k_pos < window; keys at or past
    ``kv_len`` (default T) are never attended; ``scale`` defaults to
    Dh ** -0.5.
    """
    kv_len = k.shape[2] if kv_len is None else int(kv_len)
    check_args(q, k, v, window, kv_len)
    dev = q.device
    check_card(dev)
    B, Hq, S, Dh = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    scale = Dh ** -0.5 if scale is None else float(scale)
    o = output_for(q)
    strides = (ctypes.c_longlong * 12)(*kernel_strides(q), *kernel_strides(k),
                                       *kernel_strides(v), *kernel_strides(o))
    with torch.cuda.device(dev):
        FLASH_ATTENTION.launch(ptr(q), ptr(k), ptr(v), ptr(o), strides, B, Hq,
                               Hkv, S, T, Dh, kv_len, int(bool(causal)),
                               int(window), scale,
                               int(q.dtype == torch.bfloat16), stream_of(dev))
    return o
