"""Hand-written CUDA kernels for the dense GLM Hessian-vector product, and
their launch wrappers.

The PCG inner loop's  H u = X diag(c) X^T u / n + lam u  on a dense
feature-major ``X (d, n)``, in three kernels in ``csrc/``, each built and
bound by :mod:`repro_torch.kernels.build` and called on PyTorch's current
stream:

* ``xt_u``     (``csrc/xt_u.cu``) — pass A ``z = X^T u``; replaces
  ``repro/kernels/glm_hvp.py::xt_u``.
* ``x_cz``     (``csrc/x_cz.cu``) — pass B ``y = X (c .* z)``, the scale
  fused; replaces ``repro/kernels/glm_hvp.py::x_cz``.
* ``x_c_xt_u`` (``csrc/x_c_xt_u.cu``) — the fused one-pass
  ``y = X (c .* (X^T u))`` from column panels held in shared memory;
  replaces ``repro/kernels/glm_hvp.py::x_c_xt_u``.

``X`` may be any row-major f32 view (``X.stride(1) == 1``), such as a
DiSCO-S shard's column slice of the whole matrix: the kernels take its row
stride and handle ragged edges, so nothing is padded or copied per call.
All three accumulate in f32 and need no atomics: each result is
repeatable bit for bit on a given card. A failed launch raises; nothing
here falls back to the plain versions in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.build import (X_C_XT_U, X_CZ, XT_U, check_card,
                                       check_tensor, ptr, stream_of)

THREADS = 256            # threads per CTA of xt_u and x_cz
FUSED_THREADS = 1024     # threads per CTA of x_c_xt_u
SMEM_LIMIT = 232_448     # shared memory one CTA can opt into on sm_90 (227 KB)
SMEM_PER_SM = 233_472    # shared memory of one SM for resident CTAs (228 KB)
PANEL_WIDTHS = (32, 16, 8, 4)   # x_c_xt_u panel columns, widest first


def fused_smem_bytes(d: int, bn: int, threads: int = FUSED_THREADS) -> int:
    """Shared memory of one ``x_c_xt_u`` CTA: the (d, bn) panel, the
    CTA's partial y (d,), the warps' column partials and c .* z."""
    return 4 * (d * bn + d + (threads // 32 + 1) * bn)


def fused_panel_width(d: int) -> int | None:
    """The fit rule of the fused kernel: the widest panel whose working
    set fits one CTA's shared memory, or None when even 4 columns do not
    (d above about 11,000); then the HVP takes the two-pass route."""
    for bn in PANEL_WIDTHS:
        if fused_smem_bytes(d, bn) <= SMEM_LIMIT:
            return bn
    return None


def xt_u_slices(d: int, n: int, sm_count: int) -> int:
    """Row slices of ``xt_u``: 1 when the column strips alone fill the
    card (8 resident CTAs of 256 threads per SM), else enough slices of at
    least 64 rows to do so."""
    strips = -(-n // (4 * THREADS))
    want = 8 * sm_count
    if strips >= want:
        return 1
    return max(1, min(-(-want // strips), -(-d // 64), 65_535))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_matrix(X, device) -> int:
    """Check a row-major f32 matrix on ``device``; return its row stride."""
    if not isinstance(X, torch.Tensor):
        raise TypeError("X must be a tensor")
    if X.device != device:
        raise ValueError(f"X is on {X.device}, expected {device}")
    if X.dtype != torch.float32:
        raise TypeError(f"X must be torch.float32, got {X.dtype}")
    if X.dim() != 2:
        raise ValueError(f"X must be 2-D, got {tuple(X.shape)}")
    d, n = X.shape
    if n > 1 and X.stride(1) != 1:
        raise ValueError("X must be row-major (X.stride(1) == 1)")
    ld = X.stride(0) if d > 1 else n
    if ld < n:
        raise ValueError(f"X's row stride {ld} is shorter than a row ({n})")
    return ld


def _check_vector(name, v, length, device):
    if v is None:
        return
    check_tensor(name, v, torch.float32, 1, device)
    if v.shape[0] != length:
        raise ValueError(f"len({name}) = {v.shape[0]}, expected {length}")


def xt_u(X, u):
    """z = X^T u on the card.  X (d, n) row-major f32, u (d,) -> z (n,)."""
    dev = X.device
    check_card(dev)
    ld = _check_matrix(X, dev)
    d, n = X.shape
    _check_vector("u", u, d, dev)
    z = torch.empty(n, dtype=torch.float32, device=dev)
    if d == 0 or n == 0:
        return z.zero_()
    slices = xt_u_slices(d, n, _sm_count(dev.index or 0))
    part = (torch.empty((slices, n), dtype=torch.float32, device=dev)
            if slices > 1 else None)
    with torch.cuda.device(dev):
        XT_U.launch(ptr(X), ld, ptr(u), ptr(z), ptr(part), d, n, slices,
                    THREADS, stream_of(dev))
    return z


def x_cz(X, c, z):
    """y = X (c .* z) on the card.  X (d, n) row-major f32, c (optional)
    and z (n,) -> y (d,)."""
    dev = X.device
    check_card(dev)
    ld = _check_matrix(X, dev)
    d, n = X.shape
    _check_vector("z", z, n, dev)
    _check_vector("c", c, n, dev)
    y = torch.empty(d, dtype=torch.float32, device=dev)
    if d == 0 or n == 0:
        return y.zero_()
    with torch.cuda.device(dev):
        X_CZ.launch(ptr(X), ld, ptr(c), ptr(z), ptr(y), d, n, THREADS,
                    stream_of(dev))
    return y


def x_c_xt_u(X, c, u, *, _block_n: int | None = None):
    """y = X (c .* (X^T u)) on the card, in one pass over X.

    X (d, n) row-major f32, c (optional, n,), u (d,) -> y (d,). The panel
    is :func:`fused_panel_width` columns wide; raises ValueError when no
    panel fits shared memory. ``_block_n`` (4, 8, 16 or 32) overrides the
    width for the checks that hold every width at one ``d``; no solver
    path sets it.
    """
    dev = X.device
    check_card(dev)
    ld = _check_matrix(X, dev)
    d, n = X.shape
    _check_vector("u", u, d, dev)
    _check_vector("c", c, n, dev)
    bn = fused_panel_width(d) if _block_n is None else _block_n
    if bn not in PANEL_WIDTHS or fused_smem_bytes(d, bn) > SMEM_LIMIT:
        raise ValueError(f"no x_c_xt_u panel fits shared memory at d = {d} "
                         f"(block_n = {bn})")
    y = torch.empty(d, dtype=torch.float32, device=dev)
    if d == 0 or n == 0:
        return y.zero_()
    per_sm = max(1, min(SMEM_PER_SM // (fused_smem_bytes(d, bn) + 1024),
                        2048 // FUSED_THREADS))
    grid = min(-(-n // bn), per_sm * _sm_count(dev.index or 0))
    part = torch.empty((grid, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        X_C_XT_U.launch(ptr(X), ld, ptr(c), ptr(u), ptr(y), ptr(part), d, n,
                        bn, grid, FUSED_THREADS, stream_of(dev))
    return y
