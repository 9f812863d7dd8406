"""The streamed data plane: a store's chunks, in a balanced schedule, moved
onto the device a few steps ahead of the kernels (the JAX package's
``repro.data.stream``).

:mod:`repro_torch.data.store` keeps the dataset on disk in fixed-width,
memory-mappable CSR chunks; this module turns a store and a chunk-granular
load-balanced :class:`repro_torch.data.partition.Partition` into a
**schedule** (``(m, T)`` chunk ids: step ``t`` holds the ``t``-th chunk of
every shard) and streams it through a background producer thread that runs
up to ``prefetch_depth`` steps ahead of the consumer::

    producer thread: memmap read -> tile plan (host) -> pinned staging
        -> copy stream: CSR values + plan -> tile fill (device) -> ready
    consumer: waits on `ready` on its own stream, runs K1 / K2 / K6 / K7
        on step t while steps t+1 .. t+k load

Only the CSR crosses PCIe: each chunk's values, the flat destination of
each value in its ``(nb, W, br, bc)`` tile array, the column-block ids
and the schedules the kernels read (built on the host from the live
counts, so no device read is needed). The tiles, nearly all zeros, are
assembled on the device by :func:`repro_torch.data.sparse.ell_fill`
(plain torch: ``zero_`` and ``scatter_``). Every chunk pads to the
store-wide widths ``w_fwd`` / ``w_tr``, so one payload shape covers the
whole stream and the plan owns a fixed ring of device buffers for it.

On a CUDA device the pipeline is ordered by events, never by host waits
on the consumer's side:

* the copy stream records a *ready* event after a payload's fill; the
  consumer's stream waits on it (``wait_event``);
* when the consumer takes the next payload, a *release* event is recorded
  on its stream for the previous one; the copy stream waits on it before
  it refills that device buffer;
* the producer thread waits (on the host, polling the event) for the copy
  out of a pinned staging set to finish before it overwrites the set.

On the CPU the same code runs without pinning, streams or events, each
payload in tensors of its own. A failed pin, copy or fill raises; nothing
falls back to tiles built on the host.

Peak data-plane memory is ``O(nl * chunk_size * prefetch_depth)``, set by
the schedule step of the ``nl`` shards this process streams (all ``m``
in one process, its own in a multi-process solve), never by the
dataset; :class:`PrefetchStats` measures it in the reference's terms (a
payload's bytes are those of its stacked tiles and column ids).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import queue
import threading
import time
from typing import Callable, Iterator, NamedTuple

import numpy as np
import torch

from repro_torch.data.partition import Partition, chunk_partition
from repro_torch.data.sparse import (CSRMatrix, ell_fill, ell_plan,
                                     ell_tile_widths, pad_csr_rows)
from repro_torch.data.store import ShardStore
from repro_torch.kernels.sparse_hvp import (HvpSchedule, default_ctas,
                                            default_step_bytes,
                                            ell_hvp_fits, hvp_table,
                                            schedule_from_live)
from repro_torch.obs import tracer as obs
from repro_torch.robust.faults import FaultInjector, TransientIOError
from repro_torch.robust.retry import RetryPolicy, call_with_retries
from repro_torch.robust.straggler import ChunkTimingLedger
from repro_torch.utils.device import resolve_device

# the layouts of a stream kind, as (payload key of the tiles, of the
# column ids, of the live-tile schedule)
_LAYOUTS = {"fwd": ("data", "cols", "sched"),
            "tr": ("dataT", "colsT", "schedT")}
_KINDS = {"fwd": ("fwd",), "tr": ("tr",), "both": ("fwd", "tr")}
_ALIGN = 256            # bytes between the segments of a staged payload
# bytes of chunk plans a plan keeps on the host between passes: a chunk's
# index structure never changes, so a kept plan saves its planning on
# every later pass; chunks past the budget are planned on every pass, as
# the reference builds its tiles
PLAN_CACHE_BYTES = 1 << 30
# chunks whose memory maps a plan keeps open between reads, the least
# recently read dropped first: a chunk's three maps hold an open file
# each, so the maps never hold more than 192 files whatever the store's
# chunk count; the chunks past it are opened again on every read
MAP_CACHE_CHUNKS = 64


# ---------------------------------------------------------------------------
# prefetcher
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PrefetchStats:
    """Byte ledger of a streaming pipeline (thread-safe).

    ``live_bytes`` counts payloads currently resident: queued by the
    producer thread, in flight, or held by the consumer (the consumer's
    previous payload is released when it takes the next). ``peak_bytes``
    is the high-water mark; ``max_step_bytes`` the largest single payload
    (one schedule step of the shards this process streams).
    """

    passes: int = 0
    steps: int = 0
    bytes_loaded: int = 0
    live_bytes: int = 0
    peak_bytes: int = 0
    max_step_bytes: int = 0
    # the port's own: the producer's host seconds (read + plan + enqueue),
    # its seconds waiting for a free device buffer or pinned set (on a
    # card), and the bytes it staged (what crosses PCIe on a card)
    host_s: float = 0.0
    wait_s: float = 0.0
    staged_bytes: int = 0

    def __post_init__(self):
        self._lock = threading.Lock()

    def _hosted(self, seconds: float, waited: float, staged: int):
        with self._lock:
            self.host_s += seconds
            self.wait_s += waited
            self.staged_bytes += staged

    def _produced(self, nbytes: int):
        with self._lock:
            self.steps += 1
            self.bytes_loaded += nbytes
            self.live_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            self.max_step_bytes = max(self.max_step_bytes, nbytes)

    def _released(self, nbytes: int):
        with self._lock:
            self.live_bytes -= nbytes


class _Cancelled(Exception):
    """The pass was abandoned while the producer waited for a buffer."""


class ChunkPrefetcher:
    """Background-thread, depth-``k`` prefetch pipeline over a schedule.

    ``load_fn(t)`` returns ``(payload, nbytes)`` for step ``t``. The
    producer thread runs up to ``depth`` payloads ahead of the consumer (a
    bounded queue is the back-pressure). Iterating yields payloads in
    schedule order; at most ``depth + 2`` are resident (queue, producer,
    consumer) and ``stats`` records the byte high-water mark. Producer
    exceptions re-raise in the consumer.

    ``retry`` (a :class:`repro_torch.robust.retry.RetryPolicy`) retries a
    step's load inside the producer on transient I/O failures
    (``OSError`` and :class:`repro_torch.robust.faults.TransientIOError`).

    ``on_take(payload)`` runs in the consumer when it takes a payload,
    ``on_release(payload)`` once the payload is let go (the consumer moved
    on, the pass ended or was abandoned, or the payload was never taken):
    the device plane's event hand-offs.

    A consumer that abandons a pass early must release the pipeline: call
    :meth:`close`, or use the instance as a context manager, which cancels
    the producer, drains the queue's byte ledger and joins the thread.
    """

    def __init__(self, load_fn: Callable[[int], tuple[object, int]],
                 n_steps: int, depth: int = 2,
                 stats: PrefetchStats | None = None,
                 retry: RetryPolicy | None = None, label: str = "",
                 on_take: Callable | None = None,
                 on_release: Callable | None = None):
        self._load_fn = load_fn
        self._n_steps = int(n_steps)
        self._depth = max(int(depth), 1)
        self.stats = stats if stats is not None else PrefetchStats()
        self._retry = retry
        self._label = label             # stream.pass span label (tracing)
        self._on_take = on_take
        self._on_release = on_release
        # set when the current pass is cancelled; a load_fn that blocks
        # may watch it
        self.cancel_event = threading.Event()
        self._threads: list[threading.Thread] = []
        self._passes: list = []          # the passes' live generators
        self._lock = threading.Lock()

    def close(self):
        """Cancel in-flight passes, release what they hold and join their
        producer threads. Idempotent; the prefetcher can start fresh passes
        afterwards."""
        self.cancel_event.set()
        with self._lock:
            passes, self._passes = self._passes, []
        for gen in passes:
            try:
                gen.close()              # runs the pass's clean-up
            except ValueError:           # executing in another thread
                pass
        with self._lock:
            threads, self._threads = self._threads, []
        for thread in threads:
            thread.join(timeout=30.0)

    def __enter__(self) -> "ChunkPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _load_step_hardened(self, t: int) -> tuple[object, int]:
        if self._retry is None:
            return self._load_fn(t)
        return call_with_retries(
            lambda: self._load_fn(t), self._retry,
            retryable=(TransientIOError, OSError))

    def _release(self, payload, nbytes: int) -> None:
        self.stats._released(nbytes)
        if self._on_release is not None:
            self._on_release(payload)

    def __iter__(self) -> Iterator[object]:
        gen = self._pass()
        with self._lock:                 # finished passes have no frame
            self._passes = [g for g in self._passes
                            if g.gi_frame is not None] + [gen]
        return gen

    def _pass(self) -> Iterator[object]:
        stats = self.stats
        with stats._lock:
            stats.passes += 1
        pass_t0 = time.perf_counter_ns() if obs.enabled() else None
        self.cancel_event.clear()
        cancel = self.cancel_event
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        done = object()

        def put(item) -> bool:
            # bounded put that gives up when the consumer walked away, so
            # an abandoned pass never leaves the producer blocked
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for t in range(self._n_steps):
                    if cancel.is_set():
                        return
                    payload, nbytes = self._load_step_hardened(t)
                    stats._produced(nbytes)
                    if not put((payload, nbytes)):
                        self._release(payload, nbytes)
                        return
                put(done)
            except BaseException as e:           # surfaced to the consumer
                put(e)

        def drain():                             # release queued payloads
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    return
                if isinstance(item, tuple):
                    self._release(*item)

        thread = threading.Thread(target=producer, daemon=True,
                                  name="repro-chunk-prefetch")
        with self._lock:
            self._threads.append(thread)
        thread.start()
        held = None
        try:
            while True:
                # the consumer asked for the next payload, so it is done
                # with the last: let it go before waiting, so that at
                # most depth + 2 are ever resident
                if held is not None:
                    self._release(*held)
                    held = None
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                held = item
                if self._on_take is not None:
                    self._on_take(item[0])
                yield item[0]
        finally:
            if held is not None:
                self._release(*held)
            cancel.set()
            drain()                              # unblocks a producer's put
            thread.join(timeout=30.0)
            drain()                              # what it put meanwhile
            with self._lock:
                if thread in self._threads:
                    self._threads.remove(thread)
            if pass_t0 is not None:
                # one span per pass, closed even on early abandonment
                obs.complete("stream.pass", pass_t0, label=self._label,
                             steps=self._n_steps)


# ---------------------------------------------------------------------------
# one step's host side: read, plan, pack
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _HostLayout:
    """One layout of one step, all shards: the stacked tile shape and each
    shard's chunk id and plan (and, in a fused stream, its K2 / K7 step
    table)."""

    shape: tuple                 # (m, nb, W, r, c)
    entries: list                # per shard (cid, _ChunkLayout)
    hvp: list | None = None      # per shard (table int32, steps)


@dataclasses.dataclass
class _HostStep:
    values: np.ndarray           # (nnz_step,) the step's values, f32
    layouts: dict                # 'fwd' / 'tr' -> _HostLayout
    tile_dtype: torch.dtype


@dataclasses.dataclass
class _ChunkLayout:
    """One chunk's plan in one layout, its K1 / K6 schedule and, by tile
    size, its K2 / K7 step tables: everything of the chunk that depends
    on its index structure only."""

    plan: object                 # EllPlan
    sched: np.ndarray            # int32
    hvp: dict                    # tile bytes -> (table int32, steps)

    @property
    def nbytes(self) -> int:
        return (self.plan.offsets.nbytes + self.plan.cols.nbytes
                + self.sched.nbytes)

    def hvp_table(self, tile_bytes: int, ctas: int, step_bytes: int):
        if tile_bytes not in self.hvp:
            table, steps = hvp_table(torch.from_numpy(self.plan.per_block),
                                     tile_bytes, ctas, step_bytes)
            self.hvp[tile_bytes] = (table.numpy(), steps)
        return self.hvp[tile_bytes]


class Payload(dict):
    """One step's stacked device arrays (``data`` / ``cols`` / ``sched``,
    ``dataT`` / ``colsT`` / ``schedT``, and ``hvp_sched``, a list of
    :class:`~repro_torch.kernels.sparse_hvp.HvpSchedule` per shard, in a
    fused stream), with the device plane's hand-off state."""

    slot: int | None = None
    ready: object = None
    staged: int = 0              # bytes that crossed to the device
    waited: float = 0.0          # the producer's seconds waiting for room


class _Slot:
    """One device buffer of the ring, and the event its last consumer
    recorded when it let the buffer go."""

    def __init__(self, nbytes: int, device):
        self.buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
        self.release = torch.cuda.Event()
        self.released = False           # `release` was ever recorded
        self.ready = torch.cuda.Event()


class PinnedStaging:
    """A pinned host buffer that ships several host arrays to the device
    in one copy: :meth:`stage` packs them at :data:`_ALIGN`-aligned
    offsets, copies the packed bytes with one ``copy_`` on the current
    stream and returns each array's view of the device buffer, in its own
    dtype and shape. ``copied`` is the event of the last copy out of the
    buffer, which must be done before the buffer is written again
    (:meth:`wait_free`)."""

    def __init__(self, nbytes: int):
        self.buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        self.host = self.buf.numpy()
        self.copied = torch.cuda.Event()
        self.used = False

    @staticmethod
    def nbytes(arrays) -> int:
        """Bytes ``arrays`` take staged, the padding between them
        included."""
        return _segments([a.nbytes for a in arrays])[-1][1]

    def wait_free(self, cancel: threading.Event | None = None) -> None:
        """Wait until the last copy out of the buffer is done (polled, so
        no synchronizing call is made); raises ``_Cancelled`` if ``cancel``
        is set meanwhile."""
        while self.used and not self.copied.query():
            if cancel is not None and cancel.is_set():
                raise _Cancelled()
            time.sleep(5e-5)

    def stage(self, arrays, dst: torch.Tensor) -> list[torch.Tensor]:
        """Copy contiguous host ``arrays`` to the front of ``dst`` (a uint8
        device tensor of at least :meth:`nbytes` bytes) in one copy on the
        current stream; returns their views of ``dst``."""
        segs = _segments([a.nbytes for a in arrays])
        staged = segs[-1][1]
        for a, (lo, hi) in zip(arrays, segs):
            self.host[lo:hi] = a.reshape(-1).view(np.uint8)
        dst[:staged].copy_(self.buf[:staged], non_blocking=True)
        self.copied.record(torch.cuda.current_stream(dst.device))
        self.used = True
        return [dst[lo:hi].view(_torch_dtype(a.dtype)).view(a.shape)
                for a, (lo, hi) in zip(arrays, segs)]


def _segments(sizes: list[int]) -> list[tuple[int, int]]:
    """``(start, stop)`` byte ranges of consecutive segments of ``sizes``
    bytes, each start a multiple of :data:`_ALIGN`."""
    out, pos = [], 0
    for n in sizes:
        out.append((pos, pos + n))
        pos = -(-(pos + n) // _ALIGN) * _ALIGN
    return out


class _DevicePlane:
    """The CUDA half of a plan's data plane: the copy stream, a ring of
    ``depth + 2`` device buffers (free ones in a queue) and as many pinned
    staging sets, all owned for the plan's lifetime and sized for its
    largest payload, so no tensor the consumer's stream reads is ever
    freed under it."""

    def __init__(self, plan: "StreamPlan", device: torch.device):
        self.device = device
        n = plan.prefetch_depth + 2
        with torch.cuda.device(device):
            self.copy = torch.cuda.Stream(device)
            self.staged_max = plan._staged_bytes_max()
            tiles = sum(plan._tile_bytes(lay, torch.float32)
                        for lay in ("fwd", "tr"))
            state = plan.n_local * 2 * plan._nb("tr") * 4
            # the staging, then the tiles and the fused kernels' state
            self.slot_bytes = self.staged_max + tiles + state + 4 * _ALIGN
            self.slots = [_Slot(self.slot_bytes, device) for _ in range(n)]
            self.pinned = [PinnedStaging(self.staged_max)
                           for _ in range(n)]
        self.free: queue.Queue = queue.Queue()
        for i in range(n):
            self.free.put(i)
        self._next_pin = 0
        self._lock = threading.Lock()
        self.waits: list | None = None   # (before, after) event pairs

    def acquire(self, cancel: threading.Event | None) -> int:
        while True:
            try:
                return self.free.get(timeout=0.05)
            except queue.Empty:
                if cancel is not None and cancel.is_set():
                    raise _Cancelled()

    def _pinned_set(self, cancel) -> PinnedStaging:
        with self._lock:
            pin = self.pinned[self._next_pin]
            self._next_pin = (self._next_pin + 1) % len(self.pinned)
        # a host wait in the producer, off the consumer: the last copy out
        # of this set must be done before it is overwritten
        pin.wait_free(cancel)
        return pin

    def stage(self, plan: "StreamPlan", host: _HostStep,
              cancel: threading.Event | None) -> Payload:
        """Copy one step to a free device buffer and fill its tiles there,
        on the copy stream; returns the payload (views of the buffer)."""
        t0 = time.perf_counter()
        slot_id = self.acquire(cancel)
        waited = time.perf_counter() - t0
        try:
            return self._stage(plan, host, slot_id, cancel, waited)
        except BaseException:
            self.free.put(slot_id)
            raise

    def _stage(self, plan, host, slot_id, cancel, waited) -> Payload:
        slot = self.slots[slot_id]
        arrays, index = _step_arrays(host)
        staged = PinnedStaging.nbytes(arrays)
        t0 = time.perf_counter()
        pin = self._pinned_set(cancel)
        waited += time.perf_counter() - t0
        dev = self.device
        with torch.cuda.device(dev), torch.cuda.stream(self.copy):
            if slot.released:
                self.copy.wait_event(slot.release)
            # the column ids, schedules and step tables are used where
            # they landed; the tiles and the fused kernels' state follow
            views = pin.stage(arrays, slot.buf)
            pos = -(-staged // _ALIGN) * _ALIGN

            def region(nbytes, dtype, shape):
                nonlocal pos
                out = slot.buf[pos:pos + nbytes].view(dtype).view(shape)
                pos = -(-(pos + nbytes) // _ALIGN) * _ALIGN
                return out

            payload = Payload()
            vals = views[0].to(host.tile_dtype)
            for lay, hl in host.layouts.items():
                ix = index[lay]
                tiles = region(int(np.prod(hl.shape))
                               * _itemsize(host.tile_dtype),
                               host.tile_dtype, hl.shape)
                tiles.zero_()
                if vals.numel():
                    tiles.view(-1).scatter_(0, views[ix.offsets], vals)
                kd, kc, ks = _LAYOUTS[lay]
                payload[kd] = tiles
                payload[kc], payload[ks] = views[ix.cols], views[ix.sched]
                if ix.tables is not None:
                    m, nb = hl.shape[:2]
                    state = region(m * 2 * nb * 4, torch.int32, (m, 2 * nb))
                    state.zero_()
                    payload["hvp_sched"] = _hvp_schedules(
                        plan, hl, views[ix.tables], ix.spans, state)
            if pos > slot.buf.numel():
                raise RuntimeError(f"a payload of {pos} bytes overran its "
                                   f"{slot.buf.numel()}-byte buffer")
            slot.ready.record(self.copy)
        payload.slot = slot_id
        payload.ready = slot.ready
        payload.staged = staged
        payload.waited = waited
        return payload

    def on_take(self, payload: Payload) -> None:
        stream = torch.cuda.current_stream(self.device)
        if self.waits is None:
            stream.wait_event(payload.ready)
            return
        # measured: events around the wait, whose gap is the time the
        # consumer's stream stood waiting for the payload
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(stream)
        stream.wait_event(payload.ready)
        b.record(stream)
        self.waits.append((a, b))

    def on_release(self, payload: Payload) -> None:
        slot = self.slots[payload.slot]
        slot.release.record(torch.cuda.current_stream(self.device))
        slot.released = True
        self.free.put(payload.slot)


class _Index(NamedTuple):
    """Where one layout's arrays sit in :func:`_step_arrays`' list, and
    each shard's ``(start, stop, steps)`` in the step tables."""

    offsets: int
    cols: int
    sched: int
    tables: int | None
    spans: list | None


def _step_arrays(host: _HostStep) -> tuple[list, dict]:
    """What of one step crosses to the device, in staging order: the
    values, then for each layout the tile destination of every value
    (one flat array into the stacked ``(m, nb, W, r, c)`` tiles), the
    ``(m, nb, W)`` column ids, the ``(m, L)`` K1 / K6 schedules and, in a
    fused stream, every shard's K2 / K7 step table end to end. Returns
    ``(arrays, {layout: _Index})``."""
    arrays, index = [host.values], {}
    for lay, hl in host.layouts.items():
        per = int(np.prod(hl.shape[1:]))
        plans = [e.plan for _, e in hl.entries]
        first = len(arrays)
        arrays += [np.concatenate([p.offsets + s * per
                                   for s, p in enumerate(plans)]),
                   np.stack([p.cols for p in plans]),
                   np.stack([e.sched for _, e in hl.entries])]
        tables = spans = None
        if hl.hvp is not None:
            tables, spans, start = len(arrays), [], 0
            for table, steps in hl.hvp:
                spans.append((start, start + len(table), steps))
                start += len(table)
            arrays.append(np.concatenate([t for t, _ in hl.hvp]))
        index[lay] = _Index(first, first + 1, first + 2, tables, spans)
    return arrays, index


def _hvp_schedules(plan: "StreamPlan", hl: _HostLayout, tables, spans,
                   state=None) -> list:
    """Each shard's :class:`HvpSchedule` over its span of ``tables`` (and
    its row of ``state``, else a state of its own)."""
    return [HvpSchedule(tables[a:b], hl.shape[1], plan._ctas, steps,
                        plan._step_bytes,
                        state=None if state is None else state[s])
            for s, (a, b, steps) in enumerate(spans)]


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _cpu_payload(plan: "StreamPlan", host: _HostStep) -> Payload:
    """The payload of one step on the CPU: tensors of its own."""
    arrays, index = _step_arrays(host)
    t = [torch.from_numpy(a) for a in arrays]
    payload = Payload()
    for lay, hl in host.layouts.items():
        ix = index[lay]
        kd, kc, ks = _LAYOUTS[lay]
        payload[kd] = ell_fill(_Flat(hl.shape, arrays[ix.offsets]), t[0],
                               dtype=host.tile_dtype)
        payload[kc], payload[ks] = t[ix.cols], t[ix.sched]
        if ix.tables is not None:
            payload["hvp_sched"] = _hvp_schedules(plan, hl, t[ix.tables],
                                                  ix.spans)
    payload.staged = sum(a.nbytes for a in arrays)
    return payload


class _Flat(NamedTuple):
    """A stacked layout's shape and offsets in :func:`ell_fill`'s plan
    terms."""

    shape: tuple
    offsets: np.ndarray


class _HostCache:
    """What a plan keeps on the host between passes, shared by the plans
    :func:`replan_streams` derives from it: chunk plans within
    :data:`PLAN_CACHE_BYTES` (a running count of their bytes), and the
    memory maps of the :data:`MAP_CACHE_CHUNKS` chunks read last."""

    def __init__(self):
        self.lock = threading.Lock()
        self.plans: dict = {}            # (cid, layout) -> _ChunkLayout
        self.plan_bytes = 0
        self.maps: collections.OrderedDict = collections.OrderedDict()

    def plan(self, key):
        with self.lock:
            return self.plans.get(key)

    def keep_plan(self, key, entry: "_ChunkLayout") -> None:
        with self.lock:
            if key not in self.plans \
                    and self.plan_bytes + entry.nbytes <= PLAN_CACHE_BYTES:
                self.plans[key] = entry
                self.plan_bytes += entry.nbytes

    def map(self, cid: int):
        with self.lock:
            csr = self.maps.get(cid)
            if csr is not None:
                self.maps.move_to_end(cid)
            return csr

    def keep_map(self, cid: int, csr: CSRMatrix) -> None:
        # a dropped chunk's maps close once the step that read it lets
        # go of its arrays
        with self.lock:
            self.maps[cid] = csr
            self.maps.move_to_end(cid)
            while len(self.maps) > MAP_CACHE_CHUNKS:
                self.maps.popitem(last=False)


# ---------------------------------------------------------------------------
# stream plan (store + partition -> schedule + stacked payloads)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StreamPlan:
    """Everything a streaming solve needs to walk a store.

    Built by :func:`plan_streams`. ``schedule[s, t]`` is the store chunk
    id computed by shard ``s`` at step ``t`` (``-1`` = synthetic empty
    chunk, from padding the chunk count to a multiple of ``m``);
    ``local`` the shards this process streams (all ``m`` by default; a
    rank of a multi-process solve streams its own), whose chunks fill a
    payload's ``(n_local, ...)`` stacks in order; the
    ``partition`` is the matching index-level permutation, identical to
    what the in-memory solver derives at ``partition_block = chunk_size``
    granularity. ``w_fwd``/``w_tr`` are the store-wide max ELL widths
    every chunk pads to, fixing one payload shape. ``device`` is where
    payloads are assembled (``'cpu'`` or a CUDA device).
    """

    store: ShardStore
    partition: Partition
    schedule: np.ndarray          # (m, T) int64 chunk ids, -1 = empty
    m: int
    chunk_size: int
    block_rows: int               # ELL tile rows (feature axis)
    block_cols: int               # ELL tile cols (sample axis)
    w_fwd: int
    w_tr: int
    prefetch_depth: int = 2
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))
    hvp_dtype: torch.dtype | None = None   # HVP tiles' dtype (bf16)
    stats: PrefetchStats = dataclasses.field(default_factory=PrefetchStats)
    timing_ledger: ChunkTimingLedger | None = None  # per-chunk seconds
    fault_injector: FaultInjector | None = None     # test-only failure hook
    retry: RetryPolicy | None = None      # per-step retry/backoff/deadline
    local: tuple | None = None    # the shards streamed here (None = all)
    # the device plane (CUDA), made at the first pass, and the host's
    # chunk plans and memory maps, shared by the plans replan_streams
    # derives
    _plane: _DevicePlane | None = dataclasses.field(
        default=None, repr=False, compare=False)
    _cache: _HostCache = dataclasses.field(default_factory=_HostCache,
                                           repr=False, compare=False)

    @property
    def shards(self) -> tuple:
        """The global indices of the shards this process streams."""
        return tuple(range(self.m)) if self.local is None \
            else tuple(self.local)

    @property
    def n_local(self) -> int:
        """How many shards this process streams (a payload's stack)."""
        return len(self.shards)

    @property
    def n_steps(self) -> int:
        """T — schedule steps per full pass (chunks per shard)."""
        return int(self.schedule.shape[1])

    @property
    def width_local(self) -> int:
        """Indices of the chunked axis each shard owns (T * chunk_size)."""
        return self.n_steps * self.chunk_size

    @property
    def axis_padded(self) -> int:
        """Padded length of the chunked (sharded) axis (m * width_local)."""
        return self.m * self.width_local

    @property
    def other_padded(self) -> int:
        """Padded length of the non-chunked axis (to its tile edge)."""
        other = self.store.other_dim
        edge = (self.block_cols if self.store.axis == "features"
                else self.block_rows)
        return max(-(-other // edge), 1) * edge

    @property
    def _ctas(self) -> int:
        return default_ctas(self.device)

    @property
    def _step_bytes(self) -> int:
        return default_step_bytes(self.device)

    def tile_dtype(self, hvp: bool = False) -> torch.dtype:
        """The tiles' dtype: ``hvp_dtype`` in an HVP pass when one is set,
        else f32 (the dtype the kernels take; the store's values are cast
        to it)."""
        return self.hvp_dtype if hvp and self.hvp_dtype is not None \
            else torch.float32

    def fused_hvp_fits(self, u_len: int, s: int = 1) -> bool:
        """Whether the one-pass fused kernels (K2 ``ell_hvp`` / K7
        ``ell_hvp_mm``) take THIS plan's transposed chunk layout at ``s``
        columns: :func:`repro_torch.kernels.sparse_hvp.ell_hvp_fits` on the
        tile shape every chunk pads to and the HVP tiles' dtype, so the
        fused-or-two-pass choice is made once per stream, never per chunk.
        ``u_len`` (the probe vector's length) is the reference's argument;
        the kernels keep ``u`` in global memory, so it does not enter the
        rule."""
        del u_len
        return ell_hvp_fits(self.block_rows, self.block_cols, s,
                            self.tile_dtype(hvp=True), self._ctas)

    # -- geometry of a chunk's layouts --------------------------------------
    def _dims(self, layout: str) -> tuple[int, int, int, int]:
        """``(rows, cols, r, c)`` of a chunk's local matrix in ``layout``:
        'fwd' the forward layout of the shard's local (feature-major)
        matrix, 'tr' its transpose."""
        br, bc = self.block_rows, self.block_cols
        if self.store.axis == "features":
            d_loc, n_loc = self.chunk_size, self.other_padded
        else:
            d_loc, n_loc = self.other_padded, self.chunk_size
        if layout == "fwd":
            return d_loc, n_loc, br, bc
        return n_loc, d_loc, bc, br

    def _nb(self, layout: str) -> int:
        rows, _, r, _ = self._dims(layout)
        return -(-rows // r)

    def _layout_shape(self, layout: str) -> tuple[int, int, int, int, int]:
        _, _, r, c = self._dims(layout)
        w = self.w_fwd if layout == "fwd" else self.w_tr
        return self.n_local, self._nb(layout), w, r, c

    def _tile_bytes(self, layout: str, dtype: torch.dtype) -> int:
        return int(np.prod(self._layout_shape(layout))) * _itemsize(dtype)

    def _staged_bytes_max(self) -> int:
        """Bytes of the largest staged step: ``n_local`` times the
        store's largest chunk nnz in values and both layouts' offsets, the
        column ids, the schedules and the fused kernels' step tables."""
        nnz = self.n_local * int(self.store.chunk_nnz.max(initial=0))
        ctas = self._ctas
        sizes = [nnz * 4]
        for lay in ("fwd", "tr"):
            m, nb, w, _, _ = self._layout_shape(lay)
            sizes += [nnz * 8, m * nb * w * 4, m * (2 * nb + ctas + 2) * 4]
        nbT = self._nb("tr")
        # a step table: live, prefix, first (steps + 1 <= nb + 1), bounds
        # per step
        sizes.append(self.n_local * (3 * nbT + 2 + nbT * (ctas + 1)) * 4)
        return sum(-(-n // _ALIGN) * _ALIGN for n in sizes) + _ALIGN

    # -- the host half of a step --------------------------------------------
    def _chunk_slab(self, cid: int) -> CSRMatrix:
        """Chunk ``cid`` as a full-width (chunk_size-row) CSR slab; id
        ``-1`` (or a ragged final chunk) pads with empty rows."""
        if cid < 0:
            return CSRMatrix(indptr=np.zeros(self.chunk_size + 1, np.int64),
                             indices=np.zeros(0, np.int32),
                             data=np.zeros(0, self.store.dtype),
                             shape=(self.chunk_size, self.store.other_dim))
        return pad_csr_rows(self._read(int(cid)), self.chunk_size)

    def _read(self, cid: int) -> CSRMatrix:
        """Chunk ``cid`` from the store: a read opens its memory maps
        (``ShardStore.chunk_csr``) unless they are among the
        :data:`MAP_CACHE_CHUNKS` kept from the last reads; kept maps are
        read again and their checksums checked again (the store's
        ``verify``), which saves the file opens and header parses."""
        csr = self._cache.map(cid)
        if csr is None:
            csr = self.store.chunk_csr(cid)
            self._cache.keep_map(cid, csr)
        elif self.store.verify:
            self.store.check_chunk(cid, dict(indptr=csr.indptr,
                                             indices=csr.indices,
                                             data=csr.data))
        return csr

    def _chunk_read(self, cid: int, layouts, shard: int = -1):
        """One chunk read from the store and planned in ``layouts``:
        ``(values, {layout: _ChunkLayout})``. The chunk slab's rows are the
        chunked axis, so a samples chunk is the transpose of its local
        (feature-major) matrix.

        Real chunks (``cid >= 0``) pass through the fault injector's
        ``on_chunk_read`` hook, and their measured read + plan seconds
        feed the ``timing_ledger`` (what the elastic re-planner balances
        on); each is a ``stream.chunk_load`` span when tracing is on."""
        with obs.span("stream.chunk_load", cid=int(cid), shard=int(shard),
                      layouts="+".join(layouts)):
            t0 = time.monotonic()
            if cid >= 0 and self.fault_injector is not None:
                self.fault_injector.on_chunk_read(int(cid))
            slab = self._chunk_slab(cid)
            plans = {lay: self._chunk_layout(cid, slab, lay)
                     for lay in layouts}
            values = np.asarray(slab.data, np.float32)
            if cid >= 0 and self.timing_ledger is not None:
                self.timing_ledger.observe(int(cid), time.monotonic() - t0)
        return values, plans

    def _chunk_layout(self, cid: int, slab: CSRMatrix,
                      lay: str) -> "_ChunkLayout":
        """Chunk ``cid``'s plan in ``lay`` and its K1 / K6 schedule: from
        the plan cache, or planned from the slab's index structure (and
        cached while the cache's byte budget lasts: a chunk's index
        structure never changes, so later passes skip the planning)."""
        key = (int(cid), lay)
        hit = self._cache.plan(key)
        if hit is not None:
            return hit
        _, _, r, c = self._dims(lay)
        w = self.w_fwd if lay == "fwd" else self.w_tr
        padded = CSRMatrix(slab.indptr, slab.indices, slab.data,
                           (slab.shape[0], self.other_padded))
        plan = ell_plan(padded, r, c, w,
                        transpose=(lay == "fwd") == (self.store.axis
                                                     == "samples"))
        sched = schedule_from_live(torch.from_numpy(plan.per_block),
                                   self._ctas).numpy()
        entry = _ChunkLayout(plan, sched, {})
        self._cache.keep_plan(key, entry)
        return entry

    def _host_step(self, t: int, kind: str, hvp: bool = False,
                   fused: bool = False) -> _HostStep:
        """Step ``t`` of ``kind`` on the host: the chunk of every shard
        streamed here read and planned, stacked into the staging arrays,
        with the K1 / K6 schedules and, for a fused stream, the K2 / K7
        step tables, built from the host's live counts."""
        layouts = _KINDS[kind]
        cids = [int(self.schedule[s, t]) for s in self.shards]
        per_shard = [self._chunk_read(cid, layouts, shard=s)
                     for s, cid in zip(self.shards, cids)]
        tile_dtype = self.tile_dtype(hvp)
        out = {}
        for lay in layouts:
            shape = self._layout_shape(lay)
            entries = [(cid, p[lay]) for cid, (_, p) in zip(cids, per_shard)]
            tile_bytes = shape[3] * shape[4] * _itemsize(tile_dtype)
            tables = None
            if fused and lay == "tr":
                tables = [e.hvp_table(tile_bytes, self._ctas,
                                      self._step_bytes) for _, e in entries]
            out[lay] = _HostLayout(shape=shape, entries=entries, hvp=tables)
        values = [v for v, _ in per_shard]
        return _HostStep(values=np.concatenate(values),
                         layouts=out,
                         tile_dtype=tile_dtype)

    def _load_step(self, t: int, kind: str, hvp: bool = False,
                   fused: bool = False,
                   cancel: threading.Event | None = None
                   ) -> tuple[Payload, int]:
        """Step ``t`` of ``kind`` as a payload on the plan's device, and
        its bytes in the ledger's terms (the stacked tiles and column
        ids)."""
        t0 = time.perf_counter()
        host = self._host_step(t, kind, hvp, fused)
        nbytes = sum(int(np.prod(hl.shape)) * _itemsize(host.tile_dtype)
                     + int(np.prod(hl.shape[:3])) * 4
                     for hl in host.layouts.values())
        if self.device.type == "cuda":
            payload = self._device_plane().stage(self, host, cancel)
        else:
            payload = _cpu_payload(self, host)
        self.stats._hosted(time.perf_counter() - t0 - payload.waited,
                           payload.waited, payload.staged)
        return payload, nbytes

    def time_waits(self, on: bool = True) -> None:
        """Measure (CUDA) the time the consumer's stream waits for each
        payload, from the next pass on; :meth:`waited_ms` reads it."""
        self._device_plane().waits = [] if on else None

    def waited_ms(self) -> float:
        """Milliseconds the consumer's stream stood waiting for payloads
        since :meth:`time_waits` (synchronizes); resets the tally."""
        plane = self._device_plane()
        pairs, plane.waits = plane.waits or [], (
            [] if plane.waits is not None else None)
        torch.cuda.synchronize(self.device)
        return sum(a.elapsed_time(b) for a, b in pairs)

    def _device_plane(self) -> _DevicePlane:
        if self._plane is None:
            self._plane = _DevicePlane(self, self.device)
        return self._plane

    def stream(self, kind: str = "both", hvp: bool = False,
               fused: bool = False) -> ChunkPrefetcher:
        """One pass of the schedule through the prefetch pipeline.

        ``kind`` selects the layouts streamed: ``'fwd'`` (keys ``data`` /
        ``cols`` / ``sched``: drives ``X v``), ``'tr'`` (``dataT`` /
        ``colsT`` / ``schedT``: ``X^T u``) or ``'both'``; each payload
        holds ``(n_local, ...)``-stacked tensors for one step. ``hvp=True``
        marks a Hessian-vector-product pass, whose tiles are in
        ``hvp_dtype`` when one is set (margins and gradient passes stay
        f32). ``fused=True`` (with ``'tr'``) adds ``hvp_sched``, each
        shard's step schedule for the one-pass kernels.

        Returns the :class:`ChunkPrefetcher` itself: a consumer that may
        stop early must ``close()`` it or use it as a context manager.
        A payload's tensors are valid until the consumer takes the next.
        """
        if kind not in _KINDS:
            raise ValueError(f"unknown stream kind {kind!r}")
        cuda = self.device.type == "cuda"
        plane = self._device_plane() if cuda else None
        pf = ChunkPrefetcher(
            None, self.n_steps, depth=self.prefetch_depth, stats=self.stats,
            retry=self.retry, label=kind + ("+hvp" if hvp else ""),
            on_take=plane.on_take if cuda else None,
            on_release=plane.on_release if cuda else None)
        pf._load_fn = lambda t: self._load_step(t, kind, hvp, fused,
                                                cancel=pf.cancel_event)
        return pf


def _global_ell_widths(store: ShardStore, br: int, bc: int
                       ) -> tuple[int, int]:
    """Store-wide max ELL widths for a ``(br, bc)`` tiling.

    The first planning against a store scans every chunk's index
    structure (values are never read) and persists the result in a
    sidecar next to ``meta.json`` (the reference's file name and keys, so
    either package reads the other's), so repeat solves plan from headers
    alone. Cache writes are best-effort (a read-only store just rescans).
    """
    cache_path = os.path.join(store.path, f"ell_widths.{br}x{bc}.json")
    key = dict(n_chunks=store.n_chunks, nnz=store.nnz)
    try:
        with open(cache_path) as f:
            cached = json.load(f)
        if all(cached.get(k) == v for k, v in key.items()):
            return int(cached["w_fwd"]), int(cached["w_tr"])
    except (OSError, ValueError, KeyError):
        pass
    w_fwd, w_tr = 1, 1
    for i in range(store.n_chunks):
        slab = store.chunk_csr(i)
        if store.axis == "features":
            wf, wt = ell_tile_widths(slab, br, bc)
        else:
            wt, wf = ell_tile_widths(slab, bc, br)
        w_fwd, w_tr = max(w_fwd, wf), max(w_tr, wt)
    try:
        with open(cache_path, "w") as f:
            json.dump(dict(w_fwd=w_fwd, w_tr=w_tr, **key), f)
    except OSError:
        pass
    return w_fwd, w_tr


def _schedule_from_partition(part: Partition, chunk_size: int,
                             n_chunks: int) -> np.ndarray:
    """The ``(m, T)`` chunk-id schedule realizing a chunk-granular
    partition: shard ``s``'s chunks in the partition's within-shard order
    (ascending id for nnz plans, descending measured cost after an
    elastic re-plan), padded ids (``>= n_chunks``) mapped to ``-1``
    (synthetic empty chunks)."""
    width = part.width
    T = width // chunk_size
    starts = (np.arange(part.m)[:, None] * width
              + np.arange(T)[None, :] * chunk_size)
    schedule = part.perm[starts] // chunk_size
    return np.where(schedule < n_chunks, schedule, -1)


def plan_streams(store: ShardStore, m: int, strategy: str = "lpt",
                 block_rows: int = 128, block_cols: int = 128,
                 prefetch_depth: int = 2, device=None,
                 hvp_dtype: torch.dtype | None = None,
                 timing_ledger: ChunkTimingLedger | None = None,
                 fault_injector: FaultInjector | None = None,
                 retry: RetryPolicy | None = None,
                 chunk_cost: np.ndarray | None = None,
                 local=None) -> StreamPlan:
    """Plan a balanced streaming solve over ``store`` for ``m`` shards.

    Reads only the store *header* plus each chunk's index structure (to
    size the global ELL widths), no values. The chunk-granular LPT
    assignment (:func:`repro_torch.data.partition.chunk_partition`)
    balances per-shard nnz as the in-memory path does at ``partition_block
    = chunk_size``; the schedule lists every shard's chunks in ascending
    id order, matching the in-memory local row layout.

    ``chunk_size`` must be a multiple of the chunked axis' tile edge
    (``block_rows`` for a features store, ``block_cols`` for samples) so
    chunk boundaries never split a tile. ``device`` is where payloads are
    assembled: by default the card (raising when there is none);
    ``'cpu'`` assembles them on the host for the plain versions. ``hvp_dtype`` (e.g. ``torch.bfloat16``)
    is the tiles' dtype in HVP passes (``stream(..., hvp=True)``); f32 or
    None is a no-op.

    Robustness (all optional): ``timing_ledger`` collects per-chunk
    measured seconds, ``fault_injector`` threads a fault plan into the
    read path, ``retry`` hardens each step's load with bounded retries,
    backoff and a deadline, and ``chunk_cost`` balances the LPT on
    measured cost instead of header nnz (what :func:`replan_streams`
    passes). ``local`` (the global indices of the shards this process
    holds, e.g. a ``DistributedGroup``'s ``local``) restricts the streams
    to those shards' chunks; the plan itself is of all ``m``.
    """
    edge = block_rows if store.axis == "features" else block_cols
    if store.chunk_size % edge != 0:
        raise ValueError(
            f"store chunk_size {store.chunk_size} must be a multiple of "
            f"the {store.axis}-axis ELL tile edge {edge}")
    part = chunk_partition(store.chunk_nnz, store.chunk_size,
                           store.n_items, m, strategy,
                           chunk_cost=chunk_cost)
    schedule = _schedule_from_partition(part, store.chunk_size,
                                        store.n_chunks)
    w_fwd, w_tr = _global_ell_widths(store, block_rows, block_cols)
    if hvp_dtype == torch.float32:
        hvp_dtype = None
    return StreamPlan(store=store, partition=part, schedule=schedule,
                      m=m, chunk_size=store.chunk_size,
                      block_rows=block_rows, block_cols=block_cols,
                      w_fwd=w_fwd, w_tr=w_tr,
                      prefetch_depth=prefetch_depth,
                      device=resolve_device(device),
                      hvp_dtype=hvp_dtype, timing_ledger=timing_ledger,
                      fault_injector=fault_injector, retry=retry,
                      local=None if local is None else tuple(local))


def replan_streams(plan: StreamPlan,
                   chunk_cost: np.ndarray) -> StreamPlan:
    """Re-balance an existing plan on *measured* per-chunk costs.

    The elastic re-planner's workhorse
    (:meth:`repro_torch.robust.straggler.ElasticReplanner.maybe_replan`):
    re-runs the chunk-granular LPT with ``chunk_cost`` (nonnegative ints,
    e.g. nanoseconds from the timing ledger) as the balance quantity and
    returns a new :class:`StreamPlan` with the new partition and
    schedule. Everything else (store, ELL widths, byte and timing
    ledgers, fault injector, retry policy, staging dtype, the device
    plane) is carried over, so streams from the new plan continue the old
    one's. No chunk data moves: only the chunk->shard membership (and the
    matching index permutation) changes.
    """
    part = chunk_partition(plan.store.chunk_nnz, plan.chunk_size,
                           plan.store.n_items, plan.m, "lpt",
                           chunk_cost=chunk_cost)
    schedule = _schedule_from_partition(part, plan.chunk_size,
                                        plan.store.n_chunks)
    return dataclasses.replace(plan, partition=part, schedule=schedule)
