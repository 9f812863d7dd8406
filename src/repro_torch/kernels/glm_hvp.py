"""Hand-written CUDA kernels for the dense GLM Hessian-vector product, and
their launch wrappers.

The PCG inner loop's  H u = X diag(c) X^T u / n + lam u  on a dense
feature-major ``X (d, n)``, in six kernels in ``csrc/``, each built and
bound by :mod:`repro_torch.kernels.build` and called on PyTorch's current
stream:

* ``xt_u``     (``csrc/xt_u.cu``) — pass A ``z = X^T u``; replaces
  ``repro/kernels/glm_hvp.py::xt_u``.
* ``x_cz``     (``csrc/x_cz.cu``) — pass B ``y = X (c .* z)``, the scale
  fused; replaces ``repro/kernels/glm_hvp.py::x_cz``.
* ``x_c_xt_u`` (``csrc/x_c_xt_u.cu``) — the fused one-pass
  ``y = X (c .* (X^T u))`` from column panels held in shared memory;
  replaces ``repro/kernels/glm_hvp.py::x_c_xt_u``.
* ``xt_multi``   (``csrc/xt_multi.cu``) — the s-step pass A ``Z = X^T U``
  over s vectors; replaces ``repro/kernels/glm_hvp.py::xt_multi``.
* ``x_cz_multi`` (``csrc/x_cz_multi.cu``) — the s-step pass B
  ``Y = X (c .* Z)``; replaces ``repro/kernels/glm_hvp.py::x_cz_multi``.
* ``x_c_xt_multi`` (``csrc/x_c_xt_multi.cu``) — the fused one-pass
  ``Y = X (c .* (X^T U))`` over s vectors, from column panels held in
  shared memory; replaces ``repro/kernels/glm_hvp.py::x_c_xt_multi``.

``xt_u`` and ``x_cz`` share one design (``csrc/dense_stream.cuh``): a
persistent grid of :func:`~repro_torch.kernels.sparse_hvp.default_ctas`
CTAs (one per SM) over pieces of :data:`TILE_ROWS` x :data:`TILE_COLS`
of X, split evenly by :func:`dense_split`, fed by a ring of bulk copies,
the units (row groups of ``x_cz``, column chunks of ``xt_u``) cut between
CTAs summed in CTA order by a second kernel of the same launch call.
:data:`last_path` says whether a call took the bulk copies or the direct
path (shapes a bulk copy cannot take).

``X`` may be any row-major f32 view (``X.stride(1) == 1``), such as a
DiSCO-S shard's column slice of the whole matrix: the kernels take its row
stride and handle ragged edges, so nothing is padded or copied per call.
``U`` and ``Z`` of the multi-vector kernels are row-major blocks of 1 to
:data:`~repro_torch.kernels.build.MAX_COLS` columns with any row stride.
All six accumulate in f32 and need no atomics: each result is
repeatable bit for bit on a given card. A failed launch raises; nothing
here falls back to the plain versions in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.build import (X_C_XT_MULTI, X_C_XT_U, X_CZ,
                                       X_CZ_MULTI, XT_MULTI, XT_U,
                                       check_card, check_columns,
                                       check_tensor, ptr, stream_of)
from repro_torch.kernels.sparse_hvp import default_ctas

THREADS = 256            # threads per CTA of xt_multi, x_cz_multi
FUSED_THREADS = 1024     # threads per CTA of x_c_xt_u
SMEM_LIMIT = 232_448     # shared memory one CTA can opt into on sm_90 (227 KB)
SMEM_PER_SM = 233_472    # shared memory of one SM for resident CTAs (228 KB)
PANEL_WIDTHS = (32, 16, 8, 4)   # x_c_xt_u panel columns, widest first
# the piece of xt_u and x_cz (kTileRows, kTileCols in csrc/dense_stream.cuh)
TILE_ROWS = 16
TILE_COLS = 1536
PATHS = ("direct", "bulk")  # the copy paths, by the code the kernels report
# the copy path of each streaming kernel's last launch
last_path: dict[str, str | None] = dict.fromkeys(("xt_u", "x_cz"))


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


def fused_multi_threads(s: int) -> int:
    """Threads per CTA of ``x_c_xt_multi`` at s columns (``threads_for``
    in ``csrc/x_c_xt_multi.cu``): 1024 up to s = 5, 512 above, where the
    per-thread sums would spill at 1024 threads' register budget."""
    return 1024 if s <= 5 else 512


def fused_multi_smem_bytes(d: int, bn: int, s: int) -> int:
    """Shared memory of one ``x_c_xt_multi`` CTA: the (d, bn) panel, the
    CTA's partial Y (d, s), the warps' column partials and c .* Z."""
    return 4 * (d * bn + d * s + (fused_multi_threads(s) // 32 + 1) * bn * s)


def fused_multi_panel_width(d: int, s: int) -> int | None:
    """The fit rule of the fused multi-vector kernel at s columns: the
    widest panel whose working set fits one CTA's shared memory (8 columns
    at d = 4096 and s = 5, 4 at s = 8), or None when even 4 do not; then
    the product takes the two-pass route."""
    for bn in PANEL_WIDTHS:
        if fused_multi_smem_bytes(d, bn, s) <= SMEM_LIMIT:
            return bn
    return None


def _grid(dev, n: int, bn: int, smem: int, threads: int) -> int:
    """CTAs of a persistent panel kernel: as many as are resident at once
    (by shared memory and threads), at most one per panel."""
    per_sm = max(1, min(SMEM_PER_SM // (smem + 1024), 2048 // threads))
    return min(-(-n // bn), per_sm * _sm_count(dev.index or 0))


def xt_u_slices(d: int, n: int, sm_count: int) -> int:
    """Row slices of ``xt_multi``: 1 when the column strips alone fill the
    card (8 resident CTAs of 256 threads per SM), else enough slices of at
    least 64 rows to do so."""
    strips = -(-n // (4 * THREADS))
    want = 8 * sm_count
    if strips >= want:
        return 1
    return max(1, min(-(-want // strips), -(-d // 64), 65_535))


class DenseSplit(NamedTuple):
    """How ``xt_u`` or ``x_cz`` splits an X of ``groups`` row groups of
    ``tile_rows`` rows by ``chunks`` column chunks of ``tile_cols`` over
    ``ctas`` CTAs (``csrc/dense_stream.cuh``).

    Pieces are numbered chunk-major for ``xt_u`` (``by_chunk``: a unit is a
    column chunk, the run of pieces whose sums add to its z) and
    row-group-major for ``x_cz`` (a unit is a row group). CTA ``k`` takes
    pieces ``[bound(k), bound(k + 1))``; the kernel computes the same
    bounds. A unit cut by range boundaries is summed from its CTAs'
    partials in the order :meth:`fixup` gives.
    """
    by_chunk: bool
    groups: int
    chunks: int
    ctas: int
    tile_rows: int
    tile_cols: int

    @property
    def pieces(self) -> int:
        return self.groups * self.chunks

    @property
    def units(self) -> int:
        return self.chunks if self.by_chunk else self.groups

    @property
    def per_unit(self) -> int:
        return self.groups if self.by_chunk else self.chunks

    @property
    def unit_len(self) -> int:
        """Outputs of a unit: a chunk's columns or a row group's rows."""
        return self.tile_cols if self.by_chunk else self.tile_rows

    def bound(self, k: int) -> int:
        """The first piece of CTA ``k``'s range."""
        return k * self.pieces // self.ctas

    def piece(self, t: int) -> tuple[int, int]:
        """(row group, column chunk) of piece ``t``."""
        if self.by_chunk:
            return t % self.groups, t // self.groups
        return t // self.chunks, t % self.chunks

    def owner(self, t: int) -> int:
        """The CTA whose range holds piece ``t``: the largest ``k`` with
        ``bound(k) <= t``, that is ``k * pieces < (t + 1) * ctas``."""
        return ((t + 1) * self.ctas - 1) // self.pieces

    def fixup(self, unit: int) -> list[tuple[int, int]]:
        """The (CTA, scratch slot) partials that sum to a cut unit, in
        the order the fix-up adds them; empty for a unit that lies wholly
        in one CTA's range (written there). Slot 0 holds a CTA's first
        unit, slot 1 its last."""
        base = unit * self.per_unit
        k0, k1 = self.owner(base), self.owner(base + self.per_unit - 1)
        if k0 == k1:
            return []
        return [(k, 0 if self.bound(k) >= base else 1)
                for k in range(k0, k1 + 1)
                if self.bound(k) < self.bound(k + 1)]


@functools.lru_cache(maxsize=1024)
def dense_split(kernel: str, d: int, n: int, ctas: int) -> DenseSplit:
    """The split of ``kernel`` (``"xt_u"`` or ``"x_cz"``) over a (d, n) X
    and ``ctas`` CTAs, in pieces of :data:`TILE_ROWS` x :data:`TILE_COLS`;
    cached per shape."""
    if kernel not in ("xt_u", "x_cz"):
        raise ValueError(f"no dense split for {kernel!r}")
    if d < 1 or n < 1 or ctas < 1:
        raise ValueError(f"d = {d}, n = {n} and ctas = {ctas} must be "
                         f"positive")
    return DenseSplit(kernel == "xt_u", -(-d // TILE_ROWS),
                      -(-n // TILE_COLS), ctas, TILE_ROWS, TILE_COLS)


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


def _stream(kernel, name, X, ld, vecs, out, ctas):
    """Launch ``xt_u`` or ``x_cz`` on its split; record the path."""
    d, n = X.shape
    dev = X.device
    if ctas is None:
        ctas = default_ctas(dev)
    split = dense_split(name, d, n, ctas)
    scratch = torch.empty(split.ctas * 2 * split.unit_len,
                          dtype=torch.float32, device=dev)
    path = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        kernel.launch(ptr(X), ld, *map(ptr, vecs), ptr(out), ptr(scratch),
                      d, n, split.ctas, split.tile_rows, split.tile_cols,
                      ctypes.byref(path), stream_of(dev))
    last_path[name] = PATHS[path.value]
    return out


def xt_u(X, u, *, _ctas: int | None = None):
    """z = X^T u on the card.  X (d, n) row-major f32, u (d,) -> z (n,).
    ``_ctas`` overrides the CTA count (one per SM) for the checks that
    hold the split at other counts; no solver path sets it."""
    dev = X.device
    check_card(dev)
    ld = _check_matrix(X, dev)
    d, n = X.shape
    _check_vector("u", u, d, dev)
    z = torch.empty(n, dtype=torch.float32, device=dev)
    if d == 0 or n == 0:
        return z.zero_()
    return _stream(XT_U, "xt_u", X, ld, (u,), z, _ctas)


def x_cz(X, c, z, *, _ctas: int | None = None):
    """y = X (c .* z) on the card.  X (d, n) row-major f32, c (optional)
    and z (n,) -> y (d,). ``_ctas`` as for :func:`xt_u`."""
    dev = X.device
    check_card(dev)
    ld = _check_matrix(X, dev)
    d, n = X.shape
    _check_vector("z", z, n, dev)
    _check_vector("c", c, n, dev)
    y = torch.empty(d, dtype=torch.float32, device=dev)
    if d == 0 or n == 0:
        return y.zero_()
    return _stream(X_CZ, "x_cz", X, ld, (c, z), y, _ctas)


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
    grid = _grid(dev, n, bn, fused_smem_bytes(d, bn), FUSED_THREADS)
    part = torch.empty((grid, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        X_C_XT_U.launch(ptr(X), ld, ptr(c), ptr(u), ptr(y), ptr(part), d, n,
                        bn, grid, FUSED_THREADS, stream_of(dev))
    return y


def xt_multi(X, U):
    """Z = X^T U on the card.  X (d, n) row-major f32, U (d, s) row-major
    (any row stride) -> Z (n, s)."""
    dev = X.device
    check_card(dev)
    ld = _check_matrix(X, dev)
    d, n = X.shape
    s, ldu = check_columns("U", U, d, dev)
    Z = torch.empty((n, s), dtype=torch.float32, device=dev)
    if d == 0 or n == 0:
        return Z.zero_()
    slices = xt_u_slices(d, n, _sm_count(dev.index or 0))
    part = (torch.empty((slices, n, s), dtype=torch.float32, device=dev)
            if slices > 1 else None)
    with torch.cuda.device(dev):
        XT_MULTI.launch(ptr(X), ld, ptr(U), ldu, ptr(Z), ptr(part), d, n, s,
                        slices, THREADS, stream_of(dev))
    return Z


def x_cz_multi(X, c, Z):
    """Y = X (c[:, None] .* Z) on the card.  X (d, n) row-major f32, c
    (optional, n,), Z (n, s) row-major (any row stride) -> Y (d, s)."""
    dev = X.device
    check_card(dev)
    ld = _check_matrix(X, dev)
    d, n = X.shape
    s, ldz = check_columns("Z", Z, n, dev)
    _check_vector("c", c, n, dev)
    Y = torch.empty((d, s), dtype=torch.float32, device=dev)
    if d == 0 or n == 0:
        return Y.zero_()
    with torch.cuda.device(dev):
        X_CZ_MULTI.launch(ptr(X), ld, ptr(c), ptr(Z), ldz, ptr(Y), d, n, s,
                          THREADS, stream_of(dev))
    return Y


def x_c_xt_multi(X, c, U, *, _block_n: int | None = None):
    """Y = X (c[:, None] .* (X^T U)) on the card, in one pass over X.

    X (d, n) row-major f32, c (optional, n,), U (d, s) row-major (any row
    stride, 1 to :data:`~repro_torch.kernels.build.MAX_COLS` columns) ->
    Y (d, s). The panel is :func:`fused_multi_panel_width` columns wide;
    raises ValueError when no panel fits shared memory. ``_block_n`` (4,
    8, 16 or 32) overrides the width for the checks that hold every width
    at one ``d``; no solver path sets it.
    """
    dev = X.device
    check_card(dev)
    ld = _check_matrix(X, dev)
    d, n = X.shape
    s, ldu = check_columns("U", U, d, dev)
    _check_vector("c", c, n, dev)
    bn = fused_multi_panel_width(d, s) if _block_n is None else _block_n
    if bn not in PANEL_WIDTHS or fused_multi_smem_bytes(d, bn, s) > SMEM_LIMIT:
        raise ValueError(f"no x_c_xt_multi panel fits shared memory at "
                         f"d = {d}, s = {s} (block_n = {bn})")
    Y = torch.empty((d, s), dtype=torch.float32, device=dev)
    if d == 0 or n == 0:
        return Y.zero_()
    threads = fused_multi_threads(s)
    grid = _grid(dev, n, bn, fused_multi_smem_bytes(d, bn, s), threads)
    part = torch.empty((grid, d, s), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        X_C_XT_MULTI.launch(ptr(X), ld, ptr(c), ptr(U), ldu, ptr(Y),
                            ptr(part), d, n, s, bn, grid, threads,
                            stream_of(dev))
    return Y
