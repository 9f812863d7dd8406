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
  ``y = X (c .* (X^T u))``, a column panel shared by a thread-block
  cluster; replaces ``repro/kernels/glm_hvp.py::x_c_xt_u``.
* ``xt_multi``   (``csrc/xt_multi.cu``) — the s-step pass A ``Z = X^T U``
  over s vectors; replaces ``repro/kernels/glm_hvp.py::xt_multi``.
* ``x_cz_multi`` (``csrc/x_cz_multi.cu``) — the s-step pass B
  ``Y = X (c .* Z)``; replaces ``repro/kernels/glm_hvp.py::x_cz_multi``.
* ``x_c_xt_multi`` (``csrc/x_c_xt_multi.cu``) — the fused one-pass
  ``Y = X (c .* (X^T U))`` over s vectors, as ``x_c_xt_u``; replaces
  ``repro/kernels/glm_hvp.py::x_c_xt_multi``.

``xt_u`` and ``x_cz`` share one design (``csrc/dense_stream.cuh``): a
persistent grid of :func:`~repro_torch.kernels.sparse_hvp.default_ctas`
CTAs (one per SM) over pieces of :data:`TILE_ROWS` x :data:`TILE_COLS`
of X, split evenly by :func:`dense_split`, fed by a ring of bulk copies,
the units (row groups of ``x_cz``, column chunks of ``xt_u``) cut between
CTAs summed in CTA order by a second kernel of the same launch call.
:data:`last_path` says whether a call took the bulk copies or the direct
path (shapes a bulk copy cannot take).

``xt_multi`` and ``x_cz_multi`` share the same kind of design
(``csrc/dense_multi.cuh``) over s columns: pieces of long rows (short
and wide for ``xt_multi``, whose unit is a column chunk; tall for
``x_cz_multi``, whose unit is a row group) split evenly by
:func:`multi_split`, a producer warp's bulk copies into a ring of two or
three stages, the piece's block
of U or of c .* Z staged once into shared memory, the f32 tiles on the
CUDA cores and the bf16 tiles on the tensor cores (``mma.sync``), cut
units summed in CTA order; :data:`last_path` says which copy path ran.

``x_c_xt_u`` and ``x_c_xt_multi`` share another (``csrc/fused_stream.cuh``):
a cluster of Q CTAs walks column panels of X, each CTA holding a slice of
every panel's rows, brought in by TMA; only a panel's partial ``X^T U``
crosses the cluster, through distributed shared memory, and the clusters'
partial ``Y`` are added in cluster order. :func:`fused_plan` (the fit
rule) picks Q, the panel width and the ring's stages from d and s;
:func:`fused_split` is the panels' split over the clusters;
:data:`last_path` and :data:`last_fused` say what a call ran.

All six also take bf16 tiles (``DiscoConfig.hvp_dtype='bfloat16'``)
through bf16 instances of the same designs (``csrc/xt_u_bf16.cu``,
``x_cz_bf16.cu``, ``x_c_xt_u_bf16.cu``, ``xt_multi_bf16.cu``,
``x_cz_multi_bf16.cu``, ``x_c_xt_multi_bf16.cu``), dispatched by X's
dtype; they round the vector operand to bf16 where the TPU kernels round
it (u, U at entry; c .* z, c .* Z, or z, Z alone, before pass B), so every
product is exact in f32. The one-pass kernels' bf16 instances take panels
of 64 (or 32) columns, so a row of a panel is 128 (or 64) bytes as at
f32 (:data:`FUSED_WIDTHS_BY_DTYPE`); ``cz_out=`` hands their rounded
``c .* z`` back for the checks.

``X`` may be any row-major view (``X.stride(1) == 1``), such as a
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

from repro_torch.kernels.build import (MAX_COLS, X_C_XT_MULTI,
                                       X_C_XT_MULTI_BF16, X_C_XT_U,
                                       X_C_XT_U_BF16, X_CZ, X_CZ_BF16,
                                       X_CZ_MULTI, X_CZ_MULTI_BF16, XT_MULTI,
                                       XT_MULTI_BF16, XT_U, XT_U_BF16,
                                       check_card, check_columns,
                                       check_tensor, ptr, stream_of)
from repro_torch.kernels.sparse_hvp import default_ctas

SMEM_LIMIT = 232_448     # shared memory one CTA can opt into on sm_90 (227 KB)
# the piece of xt_u and x_cz (kTileRows, kTileCols in csrc/dense_stream.cuh)
# at every tile dtype: bf16 keeps the elements, so a stage holds half the
# bytes and the ring more stages (keeping the bytes would double x_cz's
# f32 z and c beside the piece, past two stages in 227 KB)
TILE_ROWS = 16
TILE_COLS = 1536
TILE_DTYPES = (torch.float32, torch.bfloat16)   # the tiles the kernels take
# the ring of xt_u and x_cz (kMaxStages, kBarrierBytes, kThreads in
# csrc/dense_stream.cuh)
DENSE_MAX_STAGES = 4
DENSE_BARRIER_BYTES = 128
DENSE_THREADS = 384
# the pieces of xt_multi and x_cz_multi (csrc/dense_multi.cuh:
# k{Xt,Cz}RowBytes{F32,Bf16}, k{Xt,Cz}Rows{F32,Bf16}): (rows, bytes of a
# tile row) at f32 and at bf16; and their ring (kThreads, kMaxStages,
# kBarrierBytes, kRowPad: the bytes after each tile row in a stage)
MULTI_PIECES = {"xt_multi": ((16, 4096), (32, 2048)),
                "x_cz_multi": ((40, 2048), (96, 1024))}
MULTI_THREADS = 256
MULTI_MAX_STAGES = 4
MULTI_BARRIER_BYTES = 128
MULTI_ROW_PAD = 16
# each kernel by tile dtype
_BY_DTYPE = {
    "xt_u": {torch.float32: XT_U, torch.bfloat16: XT_U_BF16},
    "x_cz": {torch.float32: X_CZ, torch.bfloat16: X_CZ_BF16},
    "xt_multi": {torch.float32: XT_MULTI, torch.bfloat16: XT_MULTI_BF16},
    "x_cz_multi": {torch.float32: X_CZ_MULTI,
                   torch.bfloat16: X_CZ_MULTI_BF16},
    "x_c_xt_u": {torch.float32: X_C_XT_U, torch.bfloat16: X_C_XT_U_BF16},
    "x_c_xt_multi": {torch.float32: X_C_XT_MULTI,
                     torch.bfloat16: X_C_XT_MULTI_BF16},
}
# the fused kernels' plan (csrc/fused_stream.cuh: kThreads, kRowQuantum,
# kSlots, kMaxStages, kBarrierBytes)
FUSED_THREADS = 256      # consumer threads of a CTA (and a producer warp)
FUSED_ROW_QUANTUM = 256  # a CTA's rows of a panel are a multiple
FUSED_SLOTS = 4          # exchange slots of a CTA
FUSED_MAX_STAGES = 4
FUSED_BARRIER_BYTES = 128
CLUSTER_SIZES = (1, 2, 4, 8)
# panel columns by tile dtype, widest first (kWide, kNarrow): rows of 128
# and 64 bytes, a consumer thread's 16-byte read 4 f32 or 8 bf16 columns
FUSED_WIDTHS_BY_DTYPE = {torch.float32: (32, 16), torch.bfloat16: (64, 32)}
FUSED_WIDTHS = FUSED_WIDTHS_BY_DTYPE[torch.float32]
PATHS = ("direct", "bulk")  # the copy paths, by the code the kernels report
# the copy path of each streaming kernel's last launch ("bulk": bulk or TMA
# copies), by kernel name
last_path: dict[str, str | None] = dict.fromkeys(
    ("xt_u", "x_cz", "xt_u_bf16", "x_cz_bf16", "x_c_xt_u", "x_c_xt_multi",
     "x_c_xt_u_bf16", "x_c_xt_multi_bf16", "xt_multi", "x_cz_multi",
     "xt_multi_bf16", "x_cz_multi_bf16"))


def fused_max_groups(s: int) -> int:
    """Row groups (a CTA's rows over :data:`FUSED_ROW_QUANTUM`) a fused CTA
    holds at s columns (``max_groups`` in ``csrc/fused_stream.cuh``): the
    partial Y of a thread's rows is groups x s registers."""
    return 6 if s == 1 else 5 if s <= 3 else 4 if s <= 5 else 3


def fused_padded(s: int) -> int:
    """Floats a row of U's slice takes in shared memory (``padded``)."""
    return s if s <= 2 else 4 if s <= 4 else 8


def _round_up(x: int, to: int) -> int:
    return -(-x // to) * to


def fused_rows(d: int, cluster: int) -> int:
    """Rows of X a CTA of a cluster holds: ceil(d / cluster), rounded up to
    :data:`FUSED_ROW_QUANTUM` (rows past d read as zeros)."""
    return _round_up(max(1, -(-d // cluster)), FUSED_ROW_QUANTUM)


def fused_smem_bytes(rows: int, bn: int, stages: int, s: int = 1,
                     dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of a fused CTA on the TMA path (``layout`` in
    ``csrc/fused_stream.cuh``): barriers, exchange slots, the warps'
    column partials and c .* z (bn x s f32 each), U's slice (f32), then
    the ring of ``stages`` panels' slices at ``dtype``'s element size."""
    e = 4 * bn * s
    return (FUSED_BARRIER_BYTES + _round_up(FUSED_SLOTS * e, 128)
            + _round_up(FUSED_THREADS // 32 * e, 128) + _round_up(e, 128)
            + _round_up(4 * rows * fused_padded(s), 128)
            + dtype.itemsize * stages * rows * bn)


class FusedPlan(NamedTuple):
    """A fused call's shape on the card: ``cluster`` CTAs share each panel
    of ``bn`` columns, each holding ``rows`` of its rows, with a ring of
    ``stages`` stages."""
    cluster: int
    bn: int
    stages: int
    rows: int

    @property
    def groups(self) -> int:
        return self.rows // FUSED_ROW_QUANTUM

    @property
    def lag(self) -> int:
        """1: pass 2 of a panel runs after pass 1 of the next (three stages
        or more), else 0."""
        return 1 if self.stages >= 3 else 0


@functools.lru_cache(maxsize=1024)
def fused_plan(d: int, s: int = 1, cluster: int | None = None,
               dtype: torch.dtype = torch.float32) -> FusedPlan | None:
    """The fit rule of the fused kernels at d rows, s columns and tile
    ``dtype``: the widest panel of the dtype's
    (:data:`FUSED_WIDTHS_BY_DTYPE`), on the smallest cluster, whose ring
    of three stages (the pipelined exchange) fits one CTA's shared memory
    beside the rest; else the same with two stages; None when nothing
    fits, and then the product takes the two-pass route. The reach is the
    same at both dtypes, set by the rows a thread's registers hold: d up
    to 12,288 at one column, 10,240 at two and three, 8,192 at four and
    five, 6,144 at six to eight (every shape the panels of earlier
    versions took, and more). At bf16 a panel of 64 columns is the bytes
    of 32 f32 ones, so up to s = 5 each bf16 plan is the f32 plan with the
    panel twice as wide (at d = 4,096: clusters of 8, 64 columns, three
    64 KB stages). From s = 6 on the exchange's 64 s f32 partials leave
    no room for three such stages beside U's slice, and the rule takes
    32-column panels there (at d = 4,096: four 32 KB stages).
    ``cluster`` restricts the choice to one cluster size (checks only)."""
    if dtype not in FUSED_WIDTHS_BY_DTYPE:
        raise TypeError(f"no fused plan for {dtype} tiles")
    sizes = CLUSTER_SIZES if cluster is None else (cluster,)
    for least in (3, 2):
        for bn in FUSED_WIDTHS_BY_DTYPE[dtype]:
            for q in sizes:
                rows = fused_rows(d, q)
                if rows // FUSED_ROW_QUANTUM > fused_max_groups(s):
                    continue
                free = SMEM_LIMIT - fused_smem_bytes(rows, bn, 0, s, dtype)
                stages = min(FUSED_MAX_STAGES,
                             free // (dtype.itemsize * rows * bn))
                if stages >= least:
                    return FusedPlan(q, bn, stages, rows)
    return None


class FusedSplit(NamedTuple):
    """The panels of ``bn`` columns of an n-column X over ``clusters``
    clusters: cluster ``k`` takes panels ``[bound(k), bound(k + 1))``
    (``csrc/fused_stream.cuh`` computes the same bounds)."""
    n: int
    bn: int
    clusters: int

    @property
    def panels(self) -> int:
        return -(-self.n // self.bn)

    def bound(self, k: int) -> int:
        return k * self.panels // self.clusters

    def owner(self, t: int) -> int:
        """The cluster whose range holds panel ``t``."""
        return ((t + 1) * self.clusters - 1) // self.panels

    def columns(self, t: int) -> tuple[int, int]:
        """The columns [lo, hi) of panel ``t`` (the last one ragged)."""
        return t * self.bn, min(self.n, (t + 1) * self.bn)


@functools.lru_cache(maxsize=1024)
def fused_split(n: int, bn: int, clusters: int) -> FusedSplit:
    """The split of the fused kernels' panels; cached per shape."""
    if n < 1 or bn < 1 or clusters < 1:
        raise ValueError(f"n = {n}, bn = {bn} and clusters = {clusters} "
                         f"must be positive")
    return FusedSplit(n, bn, clusters)


class FusedLaunch(NamedTuple):
    """What a fused call ran: its plan, the clusters and the copy path."""
    plan: FusedPlan
    clusters: int
    path: str


# the last launch of each fused kernel, by kernel name
last_fused: dict[str, FusedLaunch | None] = dict.fromkeys(
    ("x_c_xt_u", "x_c_xt_multi", "x_c_xt_u_bf16", "x_c_xt_multi_bf16"))


class DenseSplit(NamedTuple):
    """How ``xt_u`` or ``x_cz`` (``csrc/dense_stream.cuh``), or
    ``xt_multi`` or ``x_cz_multi`` (``csrc/dense_multi.cuh``), splits an X
    of ``groups`` row groups of ``tile_rows`` rows by ``chunks`` column
    chunks of ``tile_cols`` over ``ctas`` CTAs.

    Pieces are numbered chunk-major for ``xt_u`` and ``xt_multi``
    (``by_chunk``: a unit is a column chunk, the run of pieces whose sums
    add to its z or its rows of Z) and row-group-major for ``x_cz`` and
    ``x_cz_multi`` (a unit is a row group). CTA ``k`` takes
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
        """Outputs of a unit: a chunk's columns or a row group's rows (each
        s floats for the multi-vector kernels)."""
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
def dense_split(kernel: str, d: int, n: int, ctas: int,
                dtype: torch.dtype = torch.float32) -> DenseSplit:
    """The split of ``kernel`` (``"xt_u"`` or ``"x_cz"``) over a (d, n) X
    of tile dtype ``dtype`` (one of :data:`TILE_DTYPES`, whose pieces are
    the same) and ``ctas`` CTAs, in pieces of :data:`TILE_ROWS` x
    :data:`TILE_COLS`; cached per shape."""
    if kernel not in ("xt_u", "x_cz"):
        raise ValueError(f"no dense split for {kernel!r}")
    if dtype not in TILE_DTYPES:
        raise TypeError(f"no dense split for {dtype} tiles")
    if d < 1 or n < 1 or ctas < 1:
        raise ValueError(f"d = {d}, n = {n} and ctas = {ctas} must be "
                         f"positive")
    return DenseSplit(kernel == "xt_u", -(-d // TILE_ROWS),
                      -(-n // TILE_COLS), ctas, TILE_ROWS, TILE_COLS)


def dense_stages(kernel: str, dtype: torch.dtype) -> int:
    """Stages of the bulk-copy ring of ``kernel`` (``"xt_u"`` or
    ``"x_cz"``) at tile dtype ``dtype`` in the shared memory one CTA an SM
    can opt into: ``run`` in ``csrc/dense_stream.cuh`` sizes it so.
    A stage holds a piece of X, and for ``x_cz`` the chunk's f32 z and c:
    2 at f32, 4 (``xt_u``) and 3 (``x_cz``) at bf16."""
    cols = TILE_COLS
    xt = kernel == "xt_u"
    row_threads = DENSE_THREADS // (cols // 4)     # kRowThreads
    # the consumers' reduction space: a row of sums per row thread
    # (xt_u), a sum per warp and row (x_cz)
    red = (row_threads * cols * 4 if xt
           else DENSE_THREADS // 32 * (TILE_ROWS // row_threads) * 4)
    ring_off = DENSE_BARRIER_BYTES + _round_up(red, 128)
    stage = _round_up(TILE_ROWS * cols * dtype.itemsize
                      + (0 if xt else 2 * 4 * cols), 128)
    return min(DENSE_MAX_STAGES, (SMEM_LIMIT - ring_off) // stage)


def multi_tile(kernel: str, dtype: torch.dtype) -> tuple[int, int]:
    """(rows, columns) of a piece of ``kernel`` (``"xt_multi"`` or
    ``"x_cz_multi"``) at tile dtype ``dtype`` (``tile_rows`` and
    ``tile_cols`` in ``csrc/dense_multi.cuh``): ``xt_multi`` 16 x 1024 at
    f32 and 32 x 1024 at bf16 (64 KB), ``x_cz_multi`` 40 x 512 at f32
    (rows of 2 KB) and 96 x 512 at bf16 (rows of 1 KB)."""
    if kernel not in MULTI_PIECES:
        raise ValueError(f"no multi-vector split for {kernel!r}")
    if dtype not in TILE_DTYPES:
        raise TypeError(f"no multi-vector split for {dtype} tiles")
    rows, row_bytes = MULTI_PIECES[kernel][TILE_DTYPES.index(dtype)]
    return rows, row_bytes // dtype.itemsize


@functools.lru_cache(maxsize=1024)
def multi_split(kernel: str, d: int, n: int, ctas: int,
                dtype: torch.dtype = torch.float32) -> DenseSplit:
    """The split of ``kernel`` (``"xt_multi"`` or ``"x_cz_multi"``) over a
    (d, n) X of tile dtype ``dtype`` and ``ctas`` CTAs, in the pieces of
    :func:`multi_tile`; cached per shape. The bounds, the owners and the
    fix-up order are :class:`DenseSplit`'s; a unit's outputs are
    ``unit_len`` rows of s floats."""
    rows, cols = multi_tile(kernel, dtype)
    if d < 1 or n < 1 or ctas < 1:
        raise ValueError(f"d = {d}, n = {n} and ctas = {ctas} must be "
                         f"positive")
    return DenseSplit(kernel == "xt_multi", -(-d // rows), -(-n // cols),
                      ctas, rows, cols)


def multi_stages(kernel: str, dtype: torch.dtype) -> int:
    """Stages of the bulk-copy ring of ``kernel`` (``"xt_multi"`` or
    ``"x_cz_multi"``) at tile dtype ``dtype`` in the shared memory one CTA
    can opt into, as ``run`` in ``csrc/dense_multi.cuh`` sizes it: the
    barriers, two buffers of kMaxCols staged vector rows (U's rows of a
    group, or c .* Z of a chunk's columns, each 16 bytes longer), then
    stages of a piece whose rows are MULTI_ROW_PAD bytes longer: 3 for
    ``xt_multi`` (64 KB pieces), 2 for ``x_cz_multi`` (80 KB and 96 KB
    pieces)."""
    rows, cols = multi_tile(kernel, dtype)
    size = dtype.itemsize
    length = rows if kernel == "xt_multi" else cols
    vec = _round_up(MAX_COLS * (length + 16 // size) * size, 128)
    ring_off = MULTI_BARRIER_BYTES + 2 * vec
    stage = rows * (cols * size + MULTI_ROW_PAD)
    return min(MULTI_MAX_STAGES, (SMEM_LIMIT - ring_off) // stage)


def dense_path(X, *vectors) -> str:
    """The copy path ``xt_u`` or ``x_cz`` takes for X (and its f32
    vectors c, z) as ``run`` in ``csrc/dense_stream.cuh`` decides it:
    "bulk" when each row of X is a whole number of 16-byte units (n and
    the row stride multiples of 4 at f32, 8 at bf16) and X and the
    vectors are 16-byte aligned, else "direct". ``xt_multi`` and
    ``x_cz_multi`` (``run`` in ``csrc/dense_multi.cuh``) take the same
    rule on X alone (``dense_path(X)``): they stage their vector blocks by
    ordinary loads, whatever their strides and alignment."""
    d, n = X.shape
    ld = X.stride(0) if d > 1 else n
    per = 16 // X.element_size()
    aligned = all(v.data_ptr() % 16 == 0 for v in (X, *vectors)
                  if v is not None)
    return "bulk" if n % per == 0 and ld % per == 0 and aligned else "direct"


def fused_path(X) -> str:
    """The copy path ``x_c_xt_u`` or ``x_c_xt_multi`` takes for X as
    ``run`` in ``csrc/fused_stream.cuh`` decides it: "bulk" (TMA) when the
    row stride is a whole number of 16-byte units (a multiple of 4
    elements at f32, 8 at bf16) and X is 16-byte aligned, else
    "direct"."""
    d, n = X.shape
    ld = X.stride(0) if d > 1 else n
    aligned = X.data_ptr() % 16 == 0
    return "bulk" if ld * X.element_size() % 16 == 0 and aligned \
        else "direct"


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_matrix(X, device) -> int:
    """Check a row-major f32 or bf16 matrix on ``device``; return its
    row stride."""
    if not isinstance(X, torch.Tensor):
        raise TypeError("X must be a tensor")
    if X.device != device:
        raise ValueError(f"X is on {X.device}, expected {device}")
    if X.dtype not in TILE_DTYPES:
        raise TypeError(f"X must be torch.float32 or torch.bfloat16, got "
                        f"{X.dtype}")
    if X.dim() != 2:
        raise ValueError(f"X must be 2-D, got {tuple(X.shape)}")
    d, n = X.shape
    if n > 1 and X.stride(1) != 1:
        raise ValueError("X must be row-major (X.stride(1) == 1)")
    ld = X.stride(0) if d > 1 else n
    if ld < n:
        raise ValueError(f"X's row stride {ld} is shorter than a row ({n})")
    return ld


def _kernel(name, X):
    """The kernel ``name`` for X's tile dtype (:func:`_check_matrix` has
    checked that it is one of :data:`TILE_DTYPES`)."""
    return _BY_DTYPE[name][X.dtype]


def _check_vector(name, v, length, device):
    if v is None:
        return
    check_tensor(name, v, torch.float32, 1, device)
    if v.shape[0] != length:
        raise ValueError(f"len({name}) = {v.shape[0]}, expected {length}")


def _stream(name, X, ld, vecs, out, ctas):
    """Launch ``xt_u`` or ``x_cz`` (the instance for X's tile dtype) on
    its split; record the path."""
    d, n = X.shape
    dev = X.device
    kernel = _kernel(name, X)
    if ctas is None:
        ctas = default_ctas(dev)
    split = dense_split(name, d, n, ctas, X.dtype)
    scratch = torch.empty(split.ctas * 2 * split.unit_len,
                          dtype=torch.float32, device=dev)
    path = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        kernel.launch(ptr(X), ld, *map(ptr, vecs), ptr(out), ptr(scratch),
                      d, n, split.ctas, split.tile_rows, split.tile_cols,
                      ctypes.byref(path), stream_of(dev))
    last_path[kernel.name] = PATHS[path.value]
    return out


def xt_u(X, u, *, _ctas: int | None = None):
    """z = X^T u on the card.  X (d, n) row-major f32 or bf16 (u then
    rounded to bf16, as the TPU kernel does), u (d,) -> z (n,) f32.
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
    return _stream("xt_u", X, ld, (u,), z, _ctas)


def x_cz(X, c, z, *, _ctas: int | None = None):
    """y = X (c .* z) on the card.  X (d, n) row-major f32 or bf16 (c .* z
    then rounded to bf16, z alone without c), c (optional) and z (n,) ->
    y (d,) f32. ``_ctas`` as for :func:`xt_u`."""
    dev = X.device
    check_card(dev)
    ld = _check_matrix(X, dev)
    d, n = X.shape
    _check_vector("z", z, n, dev)
    _check_vector("c", c, n, dev)
    y = torch.empty(d, dtype=torch.float32, device=dev)
    if d == 0 or n == 0:
        return y.zero_()
    return _stream("x_cz", X, ld, (c, z), y, _ctas)


def _plan(name, X, s, cluster):
    d = X.shape[0]
    plan = fused_plan(d, s, cluster, dtype=X.dtype)
    if plan is None:
        raise ValueError(f"no {name} plan fits shared memory at d = {d}, "
                         f"s = {s}, {X.dtype} tiles (cluster = {cluster})")
    return plan


def _check_cz_out(cz_out, shape, device):
    """``cz_out``: None, or a contiguous f32 buffer of ``shape`` for the
    hand-off."""
    if cz_out is None:
        return
    check_tensor("cz_out", cz_out, torch.float32, len(shape), device)
    if tuple(cz_out.shape) != shape:
        raise ValueError(f"cz_out is {tuple(cz_out.shape)}, expected "
                         f"{shape}")


def _fused(name, X, ld, c, U, ldu, out, cz_out, plan, clusters):
    """Launch ``x_c_xt_u`` or ``x_c_xt_multi`` (the instance for X's tile
    dtype) on ``plan``; record the path and the clusters. ``clusters``
    (None: as many as the card holds at once) sizes the scratch of the
    clusters' partials."""
    d, n = X.shape
    s = out.shape[1] if out.dim() == 2 else 1
    dev = X.device
    kernel = _kernel(name, X)
    cap = max(1, _sm_count(dev.index or 0) // plan.cluster)
    scratch = torch.empty((max(cap, clusters or 0), d, s),
                          dtype=torch.float32, device=dev)
    path, used = ctypes.c_int(-1), ctypes.c_int(0)
    tail = (plan.cluster, plan.bn, plan.stages, clusters or 0, cap,
            ctypes.byref(path), ctypes.byref(used), stream_of(dev))
    with torch.cuda.device(dev):
        if name == "x_c_xt_u":
            kernel.launch(ptr(X), ld, ptr(c), ptr(U), ptr(out), ptr(cz_out),
                          ptr(scratch), d, n, *tail)
        else:
            kernel.launch(ptr(X), ld, ptr(c), ptr(U), ldu, ptr(out),
                          ptr(cz_out), ptr(scratch), d, n, s, *tail)
    last_path[kernel.name] = PATHS[path.value]
    last_fused[kernel.name] = FusedLaunch(plan, used.value,
                                          last_path[kernel.name])
    return out


def x_c_xt_u(X, c, u, *, cz_out=None, _cluster: int | None = None,
             _clusters: int | None = None):
    """y = X (c .* (X^T u)) on the card, in one pass over X.

    X (d, n) row-major f32 or bf16 (u then rounded to bf16, and c .* z, z
    alone without c, between the passes, as the TPU kernel does), c
    (optional, n,), u (d,) -> y (d,) f32. The plan is :func:`fused_plan`'s
    at X's dtype; raises ValueError when none fits shared memory.
    ``cz_out``: an optional f32 (n,) buffer that receives the hand-off
    c .* z as pass 2 used it (rounded at bf16), for the checks; no solver
    path passes one. ``_cluster`` fixes the cluster size and
    ``_clusters`` the number of clusters, for the checks that hold every
    plan and split; no solver path sets them.
    """
    dev = X.device
    check_card(dev)
    ld = _check_matrix(X, dev)
    d, n = X.shape
    _check_vector("u", u, d, dev)
    _check_vector("c", c, n, dev)
    _check_cz_out(cz_out, (n,), dev)
    plan = _plan("x_c_xt_u", X, 1, _cluster)
    y = torch.empty(d, dtype=torch.float32, device=dev)
    if d == 0 or n == 0:
        return y.zero_()
    return _fused("x_c_xt_u", X, ld, c, u, 1, y, cz_out, plan, _clusters)


def _multi(name, X, ld, c, V, ldv, out, ctas):
    """Launch ``xt_multi`` or ``x_cz_multi`` (the instance for X's tile
    dtype) on its split; record the path."""
    d, n = X.shape
    s = out.shape[1]
    dev = X.device
    kernel = _kernel(name, X)
    if ctas is None:
        ctas = default_ctas(dev)
    split = multi_split(name, d, n, ctas, X.dtype)
    scratch = torch.empty(split.ctas * 2 * split.unit_len * s,
                          dtype=torch.float32, device=dev)
    path = ctypes.c_int(-1)
    head = ((ptr(X), ld, ptr(V), ldv) if name == "xt_multi"
            else (ptr(X), ld, ptr(c), ptr(V), ldv))
    with torch.cuda.device(dev):
        kernel.launch(*head, ptr(out), ptr(scratch), d, n, s, split.ctas,
                      split.tile_rows, split.tile_cols, ctypes.byref(path),
                      stream_of(dev))
    last_path[kernel.name] = PATHS[path.value]
    return out


def xt_multi(X, U, *, _ctas: int | None = None):
    """Z = X^T U on the card.  X (d, n) row-major f32 or bf16 (U then
    rounded to bf16), U (d, s) row-major (any row stride) -> Z (n, s)
    f32. ``_ctas`` overrides the CTA count (one per SM) for the checks
    that hold the split at other counts; no solver path sets it."""
    dev = X.device
    check_card(dev)
    ld = _check_matrix(X, dev)
    d, n = X.shape
    s, ldu = check_columns("U", U, d, dev)
    Z = torch.empty((n, s), dtype=torch.float32, device=dev)
    if d == 0 or n == 0:
        return Z.zero_()
    return _multi("xt_multi", X, ld, None, U, ldu, Z, _ctas)


def x_cz_multi(X, c, Z, *, _ctas: int | None = None):
    """Y = X (c[:, None] .* Z) on the card.  X (d, n) row-major f32 or
    bf16 (c .* Z then rounded to bf16, Z alone without c), c (optional,
    n,), Z (n, s) row-major (any row stride) -> Y (d, s) f32. ``_ctas`` as
    for :func:`xt_multi`."""
    dev = X.device
    check_card(dev)
    ld = _check_matrix(X, dev)
    d, n = X.shape
    s, ldz = check_columns("Z", Z, n, dev)
    _check_vector("c", c, n, dev)
    Y = torch.empty((d, s), dtype=torch.float32, device=dev)
    if d == 0 or n == 0:
        return Y.zero_()
    return _multi("x_cz_multi", X, ld, c, Z, ldz, Y, _ctas)


def x_c_xt_multi(X, c, U, *, cz_out=None, _cluster: int | None = None,
                 _clusters: int | None = None):
    """Y = X (c[:, None] .* (X^T U)) on the card, in one pass over X.

    X (d, n) row-major f32 or bf16 (U, and c .* Z, then rounded to bf16
    as in :func:`x_c_xt_u`), c (optional, n,), U (d, s) row-major (any row
    stride, 1 to :data:`~repro_torch.kernels.build.MAX_COLS` columns) ->
    Y (d, s) f32. The plan is :func:`fused_plan`'s at s columns and X's
    dtype; raises ValueError when none fits shared memory. ``cz_out``: an
    optional f32 (n, s) buffer for the hand-off, as for :func:`x_c_xt_u`;
    ``_cluster`` and ``_clusters`` as there.
    """
    dev = X.device
    check_card(dev)
    ld = _check_matrix(X, dev)
    d, n = X.shape
    s, ldu = check_columns("U", U, d, dev)
    _check_vector("c", c, n, dev)
    _check_cz_out(cz_out, (n, s), dev)
    plan = _plan("x_c_xt_multi", X, s, _cluster)
    Y = torch.empty((d, s), dtype=torch.float32, device=dev)
    if d == 0 or n == 0:
        return Y.zero_()
    return _fused("x_c_xt_multi", X, ld, c, U, ldu, Y, cz_out, plan,
                  _clusters)
