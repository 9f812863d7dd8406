"""Hand-written CUDA kernels for the blocked-ELL sparse HVP, their launch
wrappers, and the live-tile schedule of a layout.

Four kernels, in ``csrc/``, each built and bound by
:mod:`repro_torch.kernels.build` and called on PyTorch's current stream:

* ``ell_mv``  (``csrc/ell_mv.cu``) — ``y = A (c .* v)`` on a blocked-ELL
  operand; replaces ``repro/kernels/sparse_hvp.py::ell_mv``.
* ``ell_hvp`` (``csrc/ell_hvp.cu``) — the fused ``y = A (c .* (A^T u))``
  from the transposed layout alone; replaces
  ``repro/kernels/sparse_hvp.py::ell_hvp``.
* ``ell_mm``  (``csrc/ell_mm.cu``) — ``Y = A (c .* V)`` over s vectors;
  replaces ``repro/kernels/sparse_hvp.py::ell_mm``.
* ``ell_hvp_mm`` (``csrc/ell_hvp_mm.cu``) — the fused
  ``Y = A (c .* (A^T U))`` over s vectors from the transposed layout;
  replaces ``repro/kernels/sparse_hvp.py::ell_hvp_mm``.

``ell_mv`` and ``ell_mm`` share one design (``csrc/ell_stream.cuh``): a
persistent grid of CTAs over the layout's live tiles, split evenly by
:func:`ell_schedule`, fed by a ring of bulk copies. A schedule is built
once per layout (the solver keeps it in :class:`EllPair` ``sched`` /
``schedT``) and passed with every call; without one the wrapper takes the
schedule that counts every slot live, which reads what the layout stores,
padding included.

Each takes f32 or bf16 tiles (``DiscoConfig.hvp_dtype``): the tile type is
a template parameter of its design, instantiated for both, and a bf16
layout launches the bf16 instance (``ell_mv_bf16`` and so on, each
counted on its own). Vectors, sums and outputs are f32 either way. At bf16
the kernels round where the TPU kernels round (ROADMAP F10): the vector a
tile multiplies (``c .* v``; ``u`` and ``c .* z`` in the fused HVP) goes
to bf16 first, so every product is exact in f32 and the sums are f32, as
the plain versions in :mod:`repro_torch.kernels.ref` compute.

``ell_hvp`` and ``ell_hvp_mm`` share another (``csrc/ell_hvp_stream.cuh``):
one cooperative persistent grid that walks the transposed layout's live
tiles in steps of :func:`ell_hvp_schedule` (runs of whole row-blocks
whose tiles fit in ``step_bytes``, a share of the card's L2), pass A of
the next step between pass A and pass B of each, so that pass B re-reads
a step's tiles from L2. The solver keeps that schedule in
:class:`EllPair` ``hvp_sched``; without one the wrapper takes the one
that counts every slot live.

The multi-vector kernels take the true ``s`` (1 to
:data:`~repro_torch.kernels.build.MAX_COLS`) and a row-major block with
any row stride; nothing is padded.

A failed launch raises; nothing here falls back to the plain versions in
:mod:`repro_torch.kernels.ref`. Each wrapper counts its launches
(:func:`repro_torch.kernels.build.launch_counts`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (ELL_HVP, ELL_HVP_BF16, ELL_HVP_MM,
                                       ELL_HVP_MM_BF16, ELL_MM, ELL_MM_BF16,
                                       ELL_MV, ELL_MV_BF16, MAX_COLS,
                                       check_card,
                                       check_columns, check_tensor, ptr,
                                       stream_of)

# CTAs of the four kernels per SM: their ring takes most of an SM's
# shared memory (three 64 KB stages at 128 x 128 tiles)
CTAS_PER_SM = 1
H100_SMS = 132         # the SM count a schedule built on the CPU assumes
H100_L2_BYTES = 50 * 2**20   # the L2 a step schedule built on the CPU assumes
# step_bytes as a share of the L2: the step pass B re-reads and the step
# pass A fetches meanwhile fit together, with a quarter of the L2 to spare
STEP_L2_SHARE = (3, 8)
# partial-sum sets of ell_hvp / ell_hvp_mm, one per step in flight
# (kScratchSets in csrc/ell_hvp_stream.cuh)
SCRATCH_SETS = 4
_SCHEDULE_CHUNK = 1 << 26   # tile elements tested for nonzeros at a time
PATHS = ("direct", "bulk")  # the kernels' copy paths, by the code they report
TILE_DTYPES = (torch.float32, torch.bfloat16)   # the tiles the kernels take
# each kernel by tile dtype
_BY_DTYPE = {
    "ell_mv": {torch.float32: ELL_MV, torch.bfloat16: ELL_MV_BF16},
    "ell_mm": {torch.float32: ELL_MM, torch.bfloat16: ELL_MM_BF16},
    "ell_hvp": {torch.float32: ELL_HVP, torch.bfloat16: ELL_HVP_BF16},
    "ell_hvp_mm": {torch.float32: ELL_HVP_MM,
                   torch.bfloat16: ELL_HVP_MM_BF16},
}
# the copy path of each kernel's last launch, by kernel name
last_path: dict[str, str | None] = dict.fromkeys(
    k.name for kernels in _BY_DTYPE.values() for k in kernels.values())


def default_ctas(device) -> int:
    """CTAs of an ``ell_mv`` / ``ell_mm`` schedule on ``device``:
    :data:`CTAS_PER_SM` on each of the card's SMs; on the CPU, as for an
    H100 (132 SMs), so a schedule built there is the card's."""
    device = torch.device(device)
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    else:
        sms = H100_SMS
    return sms * CTAS_PER_SM


def ell_schedule(data, cols, ctas: int) -> torch.Tensor:
    """The live-tile schedule of a blocked-ELL layout, for ``ctas`` CTAs.

    A row-block's live slots are its slots up to and including the last
    one holding a nonzero tile (for :func:`ell_from_csr` layouts, exactly
    its real tiles; a zero tile before a nonzero one counts). Plain torch
    on the layout's device, reading it once; built once per layout.

    Returns one int32 tensor ``[live (nb), prefix (nb + 1), bounds
    (ctas + 1)]``: each row-block's live count, their prefix sums, and
    the CTAs' contiguous ranges ``[bounds[k], bounds[k + 1])`` of the
    flattened live-tile sequence, sizes differing by at most one (empty
    when there are fewer live tiles than CTAs).
    """
    if data.dim() != 4 or tuple(cols.shape) != tuple(data.shape[:2]):
        raise ValueError(f"data {tuple(data.shape)} / cols "
                         f"{tuple(cols.shape)} is not a blocked-ELL layout")
    nb, w, br, bc = data.shape
    if w < 1 or ctas < 1:
        raise ValueError(f"W = {w} and ctas = {ctas} must be positive")
    return _schedule(_live_counts(data), ctas)


def _live_counts(data):
    """Each row-block's live count: its slots up to and including the
    last one holding a nonzero tile."""
    nb, w, br, bc = data.shape
    flat = data.reshape(nb, w, br * bc)
    nonzero = torch.empty((nb, w), dtype=torch.bool, device=data.device)
    step = max(1, _SCHEDULE_CHUNK // max(1, flat[0].numel()))
    for i in range(0, nb, step):
        nonzero[i:i + step] = (flat[i:i + step] != 0).any(dim=2)
    slot = torch.arange(1, w + 1, device=data.device)
    return (nonzero * slot).amax(dim=1)


def _schedule(live, ctas):
    prefix = torch.zeros(live.numel() + 1, dtype=torch.int64,
                         device=live.device)
    torch.cumsum(live, 0, out=prefix[1:])
    bounds = torch.arange(ctas + 1, device=live.device) * prefix[-1] // ctas
    return torch.cat([live, prefix, bounds]).to(torch.int32)


def schedule_parts(sched, nb: int):
    """``(live, prefix, bounds)`` views of a schedule of ``nb``
    row-blocks."""
    return sched[:nb], sched[nb:2 * nb + 1], sched[2 * nb + 1:]


_EVERY_SLOT: dict = {}


def _every_slot_schedule(nb, w, dev):
    """The schedule that counts every slot live (cached per shape)."""
    key = (nb, w, str(dev))
    if key not in _EVERY_SLOT:
        live = torch.full((nb,), w, dtype=torch.int64, device=dev)
        _EVERY_SLOT[key] = _schedule(live, default_ctas(dev))
    return _EVERY_SLOT[key]


def _check_schedule(sched, nb, w, dev) -> tuple[torch.Tensor, int]:
    """The schedule to launch with (every slot live for None), and its
    CTA count."""
    if sched is None:
        sched = _every_slot_schedule(nb, w, dev)
    else:
        check_tensor("sched", sched, torch.int32, 1, dev)
    ctas = sched.shape[0] - 2 * nb - 2
    if ctas < 1:
        raise ValueError(f"sched of length {sched.shape[0]} does not fit "
                         f"{nb} row-blocks")
    return sched, ctas


def default_step_bytes(device) -> int:
    """The ``step_bytes`` of an ``ell_hvp`` schedule on ``device``:
    :data:`STEP_L2_SHARE` of the card's L2; on the CPU, of an H100's
    (50 MiB), so a schedule built there is the card's."""
    device = torch.device(device)
    if device.type == "cuda":
        l2 = torch.cuda.get_device_properties(device).L2_cache_size
    else:
        l2 = H100_L2_BYTES
    num, den = STEP_L2_SHARE
    return l2 * num // den


class HvpSchedule:
    """The step schedule of ``ell_hvp`` / ``ell_hvp_mm`` on one transposed
    layout (:func:`ell_hvp_schedule`), and the state its kernels keep
    between calls.

    ``table`` (int32, on the layout's device): ``[live (nb), prefix
    (nb + 1), first (steps + 1), bounds (steps * (ctas + 1))]``: each
    row-block's live count and their prefix sums, the first row-block of
    each step (``first[steps] = nb``), and per step the CTAs' ranges
    ``[bounds[i, k], bounds[i, k + 1])`` of the live-tile sequence.
    ``state`` (int32 ``(2 nb,)``): the row-blocks' arrival counters, zero
    between calls, and their ready flags, each the ``epoch`` of the call
    that last wrote the row-block's ``c .* z``. Each call takes the next
    epoch (:meth:`next_epoch`), so calls with one schedule run one at a
    time, in stream order (no CUDA graph replays a captured epoch).
    """

    def __init__(self, table, nb: int, ctas: int, steps: int,
                 step_bytes: int, state=None):
        self.table = table
        self.nb, self.ctas, self.steps = nb, ctas, steps
        self.step_bytes = step_bytes
        # a zeroed (2 nb,) int32 tensor the caller owns (the streamed data
        # plane zeroes one with each payload), else a new one
        self.state = (torch.zeros(2 * nb, dtype=torch.int32,
                                  device=table.device)
                      if state is None else state)
        self.epoch = 0

    def parts(self):
        """``(live, prefix, first, bounds)`` views of the table, bounds as
        ``(steps, ctas + 1)``."""
        nb, s = self.nb, self.steps
        t = self.table
        return (t[:nb], t[nb:2 * nb + 1], t[2 * nb + 1:2 * nb + s + 2],
                t[2 * nb + s + 2:].reshape(s, self.ctas + 1))

    def next_epoch(self) -> int:
        self.epoch = self.epoch % (2**31 - 2) + 1
        return self.epoch


def ell_hvp_schedule(dataT, colsT, ctas: int | None = None,
                     step_bytes: int | None = None, *,
                     live=None) -> HvpSchedule:
    """The step schedule of a transposed blocked-ELL layout for
    ``ell_hvp`` / ``ell_hvp_mm``, for ``ctas`` CTAs (default
    :func:`default_ctas`).

    Live counts as :func:`ell_schedule` takes them (``live``: those of
    the layout's :func:`ell_schedule`, to skip the pass over the tiles).
    A step is a run of consecutive row-blocks whose live tiles (at the
    layout's element size: a step holds up to twice as many bf16 tiles) fit in
    ``step_bytes`` (default :func:`default_step_bytes`); a row-block
    larger than that is a step alone, and row-blocks without live tiles
    join the step they fall in. Each step's live tiles are split over the
    CTAs in contiguous ranges whose sizes differ by at most one. Plain
    torch; one copy of the live counts to the host; built once per
    layout.
    """
    if dataT.dim() != 4 or tuple(colsT.shape) != tuple(dataT.shape[:2]):
        raise ValueError(f"dataT {tuple(dataT.shape)} / colsT "
                         f"{tuple(colsT.shape)} is not a blocked-ELL layout")
    nb, w, r, c = dataT.shape
    dev = dataT.device
    ctas = default_ctas(dev) if ctas is None else ctas
    step_bytes = default_step_bytes(dev) if step_bytes is None else step_bytes
    if w < 1 or ctas < 1 or step_bytes < 1:
        raise ValueError(f"W = {w}, ctas = {ctas} and step_bytes = "
                         f"{step_bytes} must be positive")
    if live is None:
        live = _live_counts(dataT)
    return _hvp_schedule(live.to(torch.int64), r * c * dataT.element_size(),
                         ctas, step_bytes)


def _hvp_schedule(live, tile_bytes, ctas, step_bytes):
    table, steps = hvp_table(live, tile_bytes, ctas, step_bytes)
    return HvpSchedule(table, live.numel(), ctas, steps, step_bytes)


def hvp_table(live, tile_bytes: int, ctas: int, step_bytes: int):
    """``(table, steps)`` of :class:`HvpSchedule` from the live counts
    ``live`` (int64), on ``live``'s device; a CPU ``live`` costs no device
    sync (the streamed data plane builds each chunk's table on the host
    and copies it with the chunk)."""
    counts = live.tolist()
    first, acc = [0], 0
    for j, n in enumerate(counts):
        b = n * tile_bytes
        if n and acc and acc + b > step_bytes:
            first.append(j)
            acc = 0
        acc += b
    first.append(len(counts))
    dev = live.device
    prefix = torch.zeros(len(counts) + 1, dtype=torch.int64, device=dev)
    torch.cumsum(live, 0, out=prefix[1:])
    first_t = torch.tensor(first, dtype=torch.int64, device=dev)
    lo, hi = prefix[first_t[:-1]], prefix[first_t[1:]]
    k = torch.arange(ctas + 1, device=dev)
    bounds = lo[:, None] + k[None, :] * (hi - lo)[:, None] // ctas
    table = torch.cat([live, prefix, first_t, bounds.reshape(-1)])
    return table.to(torch.int32), len(first) - 1


def schedule_from_live(live, ctas: int) -> torch.Tensor:
    """The :func:`ell_schedule` table from the live counts ``live``
    (int64) alone, on ``live``'s device."""
    return _schedule(live, ctas)


# the shared memory one CTA can opt into on sm_90 (227 KB), and the
# constants of csrc/ell_tiles.cuh the fused kernels' launch plans with
SMEM_OPTIN = 232_448
_KTHREADS = 512
_KBARRIER_BYTES = 128


def _round_up(x: int, to: int) -> int:
    return -(-x // to) * to


def ell_hvp_fits(br: int, bc: int, s: int = 1, dtype=torch.float32,
                 ctas: int | None = None) -> bool:
    """Whether one ``ell_hvp`` / ``ell_hvp_mm`` launch takes a
    transposed layout of ``(bc, br)`` tiles (``br`` the forward tiles'
    rows, ``bc`` their columns) at ``s`` columns and ``ctas`` CTAs
    (default an H100's), without a card.

    The rule of the launch in ``csrc/ell_hvp_stream.cuh`` (``run``): its
    fixed shared memory, everything before the ring (the barriers, the
    staged ``u`` rows and ``c .* z`` of a tile row, the column sums, the
    CTA ranges), must fit the 227 KB a CTA can opt into, which the direct
    path needs, and one launch takes at most
    :data:`~repro_torch.kernels.build.MAX_COLS` columns. The ring itself
    only chooses between the bulk and the direct path, which give the
    same product. The reference's rule (``repro.kernels.ops
    .ell_fused_fits``) budgets a TPU's VMEM for a whole tile row and the
    resident vectors, so the two can choose differently; either choice
    computes the same product.
    """
    if dtype not in TILE_DTYPES:
        raise ValueError(f"tile dtype {dtype} is not one of {TILE_DTYPES}")
    if s < 1 or s > MAX_COLS:
        return False
    ctas = H100_SMS * CTAS_PER_SM if ctas is None else ctas
    R, C = bc, br
    groups = max(1, _KTHREADS // C)
    czs_off = _KBARRIER_BYTES + _round_up(s * C * 4, 128)
    red_off = czs_off + _round_up(R * s * 4, 128)
    bnd_off = red_off + _round_up(max(groups * C * s, 4 * _KTHREADS) * 4,
                                  128)
    ring_off = bnd_off + _round_up((ctas + 1) * 4, 128)
    return ring_off <= SMEM_OPTIN


_EVERY_SLOT_HVP: dict = {}


def _check_hvp_schedule(sched, dataT) -> HvpSchedule:
    """The step schedule to launch with (every slot live for None, cached
    per shape and device)."""
    nb, w, r, c = dataT.shape
    dev = dataT.device
    if sched is None:
        tile_bytes = r * c * dataT.element_size()
        key = (nb, w, tile_bytes, str(dev))
        if key not in _EVERY_SLOT_HVP:
            live = torch.full((nb,), w, dtype=torch.int64, device=dev)
            _EVERY_SLOT_HVP[key] = _hvp_schedule(
                live, tile_bytes, default_ctas(dev), default_step_bytes(dev))
        return _EVERY_SLOT_HVP[key]
    if not isinstance(sched, HvpSchedule):
        raise TypeError("sched must be an HvpSchedule (ell_hvp_schedule)")
    check_tensor("sched.table", sched.table, torch.int32, 1, dev)
    if sched.nb != nb:
        raise ValueError(f"sched has {sched.nb} row-blocks, the layout {nb}")
    return sched


def ell_mv(data, cols, v, c=None, *, sched=None, out_dtype=torch.float32):
    """y = A @ (c .* v) for a blocked-ELL operand, on the card.

    data : (nb, W, br, bc) f32 or bf16 tiles;  cols : (nb, W) int32
    v    : (ncb * bc,) f32 input vector (padded length)
    c    : optional (ncb * bc,) f32 per-element scale (fused in-kernel)
    sched: the layout's :func:`ell_schedule`; None reads every slot
    returns (nb * br,) in ``out_dtype`` (f32 accumulation; no atomics)
    """
    dev = data.device
    _check_layout(data, cols, dev)
    nb, w, br, bc = data.shape
    check_tensor("v", v, torch.float32, 1, dev)
    if v.shape[0] % bc or v.shape[0] == 0:
        raise ValueError(f"len(v) = {v.shape[0]} is not a positive multiple "
                         f"of {bc}")
    if c is not None:
        check_tensor("c", c, torch.float32, 1, dev)
        if c.shape != v.shape:
            raise ValueError(f"c {tuple(c.shape)} != v {tuple(v.shape)}")
    y = torch.empty(nb * br, dtype=torch.float32, device=dev)
    if nb == 0:
        return y.to(out_dtype)
    sched, ctas = _check_schedule(sched, nb, w, dev)
    scratch = torch.empty(ctas * 2 * br, dtype=torch.float32, device=dev)
    path = ctypes.c_int(-1)
    kernel = _BY_DTYPE["ell_mv"][data.dtype]
    with torch.cuda.device(dev):
        kernel.launch(ptr(data), ptr(cols), ptr(sched), ctas, ptr(v), ptr(c),
                      ptr(y), ptr(scratch), nb, w, br, bc, v.shape[0] // bc,
                      ctypes.byref(path), stream_of(dev))
    last_path[kernel.name] = PATHS[path.value]
    return y.to(out_dtype)


def ell_hvp(dataT, colsT, u, c=None, *, sched=None,
            out_dtype=torch.float32, cz_out=None):
    """One-pass blocked-ELL HVP on the card: y = A (c .* (A^T u)).

    dataT/colsT : the *transposed* blocked-ELL layout of A, shapes
    (ncb, WT, bc, br) / (ncb, WT), f32 or bf16 tiles. u : (nrb * br,)
    over A's padded row axis; c : optional (ncb * bc,) scale over A's
    padded column axis. sched : the layout's :func:`ell_hvp_schedule`;
    None reads every slot. cz_out : optional zeroed (ncb * bc,) f32
    tensor that receives the hand-off ``c .* z`` between the passes
    (rounded to the tile dtype; row-blocks without live tiles keep
    their zeros), for checks. Returns (nrb * br,) in ``out_dtype`` (f32
    accumulation; z summed in a fixed order, the scatter into y by f32
    atomics, so y repeats to f32 rounding, not bit for bit).
    """
    dev = dataT.device
    _check_layout(dataT, colsT, dev)
    ncb, wt, bc, br = dataT.shape
    check_tensor("u", u, torch.float32, 1, dev)
    if u.shape[0] % br or u.shape[0] == 0:
        raise ValueError(f"len(u) = {u.shape[0]} is not a positive "
                         f"multiple of {br}")
    if c is not None:
        check_tensor("c", c, torch.float32, 1, dev)
        if c.shape[0] != ncb * bc:
            raise ValueError(f"len(c) = {c.shape[0]} != {ncb * bc}")
    y = torch.zeros(u.shape[0], dtype=torch.float32, device=dev)
    if ncb == 0:
        return y.to(out_dtype)
    sched = _check_hvp_schedule(sched, dataT)
    cz, scratch = _hvp_buffers(sched, bc, 1, dev, cz_out)
    path = ctypes.c_int(-1)
    kernel = _BY_DTYPE["ell_hvp"][dataT.dtype]
    with torch.cuda.device(dev):
        kernel.launch(ptr(dataT), ptr(colsT), ptr(sched.table),
                      ptr(sched.state), sched.ctas, sched.steps,
                      sched.next_epoch(), ptr(u), ptr(c), ptr(y), ptr(cz),
                      ptr(scratch), ncb, wt, bc, br, u.shape[0] // br,
                      ctypes.byref(path), stream_of(dev))
    last_path[kernel.name] = PATHS[path.value]
    return y.to(out_dtype)


def _hvp_buffers(sched, bc, s, dev, cz_out=None):
    """The per-call buffers of ell_hvp / ell_hvp_mm: c .* z of every
    row-block (nb, bc, s) (``cz_out`` when given), and the partial z of
    the row-blocks cut by a CTA range (SCRATCH_SETS, ctas, 2 slots, bc,
    s)."""
    if cz_out is None:
        cz = torch.empty(sched.nb * bc * s, dtype=torch.float32, device=dev)
    else:
        check_tensor("cz_out", cz_out, torch.float32, 1, dev)
        if cz_out.shape[0] != sched.nb * bc * s:
            raise ValueError(f"len(cz_out) = {cz_out.shape[0]} != "
                             f"{sched.nb * bc * s}")
        cz = cz_out
    scratch = torch.empty(SCRATCH_SETS * 2 * sched.ctas * bc * s,
                          dtype=torch.float32, device=dev)
    return cz, scratch


def _check_layout(data, cols, dev):
    check_card(dev)
    check_tensor("data", data, TILE_DTYPES, 4, dev)
    check_tensor("cols", cols, torch.int32, 2, dev)
    if tuple(cols.shape) != tuple(data.shape[:2]):
        raise ValueError(f"cols {tuple(cols.shape)} != "
                         f"{tuple(data.shape[:2])}")


def ell_mm(data, cols, V, c=None, *, sched=None, out_dtype=torch.float32):
    """Y = A @ (c[:, None] .* V) over s vectors, on the card.

    data : (nb, W, br, bc) f32 or bf16 tiles;  cols : (nb, W) int32
    V    : (ncb * bc, s) f32, row-major with any row stride
    c    : optional (ncb * bc,) f32 scale (fused in-kernel)
    sched: the layout's :func:`ell_schedule`; None reads every slot
    returns (nb * br, s) in ``out_dtype`` (f32 accumulation; no atomics)
    """
    dev = data.device
    _check_layout(data, cols, dev)
    nb, w, br, bc = data.shape
    if V.dim() != 2 or V.shape[0] % bc or V.shape[0] == 0:
        raise ValueError(f"V {tuple(V.shape)} is not (k * {bc}, s)")
    s, ldv = check_columns("V", V, V.shape[0], dev)
    if c is not None:
        check_tensor("c", c, torch.float32, 1, dev)
        if c.shape[0] != V.shape[0]:
            raise ValueError(f"len(c) = {c.shape[0]} != {V.shape[0]}")
    Y = torch.empty((nb * br, s), dtype=torch.float32, device=dev)
    if nb == 0:
        return Y.to(out_dtype)
    sched, ctas = _check_schedule(sched, nb, w, dev)
    scratch = torch.empty(ctas * 2 * br * s, dtype=torch.float32, device=dev)
    # floats readable from V's first element on (the bulk copies take
    # whole (bc, ldv) spans of V)
    v_len = V.untyped_storage().nbytes() // 4 - V.storage_offset()
    path = ctypes.c_int(-1)
    kernel = _BY_DTYPE["ell_mm"][data.dtype]
    with torch.cuda.device(dev):
        kernel.launch(ptr(data), ptr(cols), ptr(sched), ctas, ptr(V), ldv,
                      v_len, ptr(c), ptr(Y), ptr(scratch), nb, w, br, bc,
                      V.shape[0] // bc, s, ctypes.byref(path),
                      stream_of(dev))
    last_path[kernel.name] = PATHS[path.value]
    return Y.to(out_dtype)


def ell_hvp_mm(dataT, colsT, U, c=None, *, sched=None,
               out_dtype=torch.float32, cz_out=None):
    """One-pass blocked-ELL multi-vector HVP on the card:
    Y = A (c .* (A^T U)).

    dataT/colsT : the transposed layout of A, (ncb, WT, bc, br) /
    (ncb, WT), f32 or bf16 tiles. U : (nrb * br, s) row-major with any
    row stride; c : optional (ncb * bc,); sched as for :func:`ell_hvp`;
    cz_out : optional zeroed (ncb * bc * s,) f32 tensor that receives
    the hand-off ``c .* Z``, row-major (ncb * bc, s), as for
    :func:`ell_hvp`. Returns (nrb * br, s) in ``out_dtype`` (f32
    accumulation; repeats to f32 rounding, as :func:`ell_hvp`).
    """
    dev = dataT.device
    _check_layout(dataT, colsT, dev)
    ncb, wt, bc, br = dataT.shape
    if U.dim() != 2 or U.shape[0] % br or U.shape[0] == 0:
        raise ValueError(f"U {tuple(U.shape)} is not (k * {br}, s), k > 0")
    s, ldu = check_columns("U", U, U.shape[0], dev)
    if c is not None:
        check_tensor("c", c, torch.float32, 1, dev)
        if c.shape[0] != ncb * bc:
            raise ValueError(f"len(c) = {c.shape[0]} != {ncb * bc}")
    Y = torch.zeros((U.shape[0], s), dtype=torch.float32, device=dev)
    if ncb == 0:
        return Y.to(out_dtype)
    sched = _check_hvp_schedule(sched, dataT)
    cz, scratch = _hvp_buffers(sched, bc, s, dev, cz_out)
    # floats readable from U's first element on (the bulk copies take
    # whole (br, ldu) spans of U)
    u_len = U.untyped_storage().nbytes() // 4 - U.storage_offset()
    path = ctypes.c_int(-1)
    kernel = _BY_DTYPE["ell_hvp_mm"][dataT.dtype]
    with torch.cuda.device(dev):
        kernel.launch(ptr(dataT), ptr(colsT), ptr(sched.table),
                      ptr(sched.state), sched.ctas, sched.steps,
                      sched.next_epoch(), ptr(U), ldu, u_len, ptr(c),
                      ptr(Y), ptr(cz), ptr(scratch), ncb, wt, bc, br,
                      U.shape[0] // br, s, ctypes.byref(path),
                      stream_of(dev))
    last_path[kernel.name] = PATHS[path.value]
    return Y.to(out_dtype)
