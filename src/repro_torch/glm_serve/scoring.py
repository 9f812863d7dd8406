"""Batched sparse scoring: feature-vector requests through K1 ``ell_mv``.

Inference for a fitted GLM is one sparse dot a request, ``margin = <x,
w>``. A batch of requests packed as the rows of a ``(B, d)`` sparse matrix
scores with one :func:`repro_torch.kernels.ops.ell_matvec` against the
weight vector: one kernel launch for the whole batch, the amortization the
serving cost model (:func:`repro_torch.core.comm.glm_serving_throughput`)
describes. The port of ``repro.glm_serve.scoring``.

Pieces:

* :class:`ScoreRequest`: one request, the sparse feature vector.
* :class:`RequestPacker`: requests -> fixed-shape blocked-ELL tiles, the
  reference's ``(data, cols)`` bit for bit (short batches padded with
  empty rows, tile lists to a fixed width, padding slots zero), as tensors
  on the packer's device. The tiles are built where they are used: the
  host plans the batch's CSR (:func:`repro_torch.data.sparse.ell_plan`,
  from the index structure alone), and on the card only the values, their
  tile offsets, the column-block ids and the live-tile schedule cross
  PCIe, in one copy from a pinned staging buffer; the card zeroes the
  tiles and scatters the values (:func:`repro_torch.data.sparse.ell_fill`).
* :func:`oracle_margins`: the NumPy oracle the tests and the card's checks
  compare against.
* :class:`ScoringEngine`: weights (from a
  :class:`repro_torch.glm_serve.registry.ModelRegistry` or given directly)
  + packer + one K1 launch a tick + the loss link (predict /
  predict_proba as :class:`repro_torch.core.glm.GLMProblem`), with a hot
  swap of a newly published version between ticks.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.losses import get_loss
from repro_torch.data.sparse import (CSRMatrix, EllPlan, ell_fill, ell_plan,
                                     hvp_tile_dtype)
from repro_torch.data.stream import PinnedStaging
from repro_torch.kernels import ops as kops
from repro_torch.kernels.sparse_hvp import default_ctas, schedule_from_live
from repro_torch.obs import tracer as obs
from repro_torch.utils.device import resolve_device

@dataclasses.dataclass(frozen=True)
class ScoreRequest:
    """One scoring request: a sparse feature vector.

    ``indices`` are 0-based feature ids (unique, any order), ``values``
    the matching feature values. An empty request (no features) is valid
    and scores to margin 0.
    """

    indices: np.ndarray
    values: np.ndarray

    @classmethod
    def from_dense(cls, x: np.ndarray) -> "ScoreRequest":
        """Build from a dense (d,) feature vector, dropping zeros."""
        x = np.asarray(x)
        idx = np.nonzero(x)[0]
        return cls(indices=idx.astype(np.int64), values=x[idx])

    @property
    def nnz(self) -> int:
        """Stored nonzeros of the request."""
        return int(len(self.values))


def oracle_margins(requests: Sequence[ScoreRequest], w: np.ndarray
                   ) -> np.ndarray:
    """NumPy reference margins ``<x_i, w>``: each a float64 dot over the
    request's stored features, cast to ``w.dtype``."""
    w = np.asarray(w)
    w64 = w.astype(np.float64)
    out = np.zeros(len(requests), np.float64)
    for i, r in enumerate(requests):
        if r.nnz:
            out[i] = np.dot(np.asarray(r.values, np.float64),
                            w64[np.asarray(r.indices, np.int64)])
    return out.astype(w.dtype)


class RequestPacker:
    """Packs up to ``batch`` requests into fixed-shape ELL tiles.

    The batch matrix is ``R: (batch, d)``, one request a row; margins are
    ``R @ w``, so the forward blocked-ELL layout of ``R`` (row-blocks of
    ``block_b`` requests, column blocks of ``block_d`` features) drives
    K1 directly. Shapes are fixed per packer: rows pad to
    ``ceil(batch / block_b) * block_b`` (missing requests are empty rows),
    the tile lists to ``width`` (default: the number of feature blocks,
    always enough). A denser-than-``width`` pack raises; an empty batch
    gives all-zero tiles and scores to zeros.

    ``dtype`` is the request values' and the margins' dtype (values are
    cast to it first, as the reference casts them); the tiles are
    ``tile_dtype``, ``torch.float32`` (default) or ``torch.bfloat16``, the
    tile types K1 takes. ``device``: where the tiles are built (default
    the card; ``'cpu'`` for the plain versions).
    """

    def __init__(self, d: int, batch: int, block_b: int = 8,
                 block_d: int = 128, width: int | None = None,
                 dtype=np.float32, tile_dtype=None, device=None):
        if d <= 0 or batch <= 0:
            raise ValueError(f"need d > 0 and batch > 0, got d={d}, "
                             f"batch={batch}")
        self.d = d
        self.batch = batch
        self.block_b = block_b
        self.block_d = block_d
        self.dtype = np.dtype(dtype)
        self.tile_dtype = torch.float32 if tile_dtype is None else tile_dtype
        if self.tile_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"tile_dtype must be torch.float32 or "
                             f"torch.bfloat16, got {self.tile_dtype}")
        self.device = resolve_device(device)
        self.n_row_blocks = -(-batch // block_b)
        self.n_col_blocks = max(-(-d // block_d), 1)
        self.batch_padded = self.n_row_blocks * block_b
        self.d_padded = self.n_col_blocks * block_d
        self.width = width if width is not None else self.n_col_blocks
        if not 1 <= self.width <= self.n_col_blocks:
            raise ValueError(
                f"width must be in [1, {self.n_col_blocks}], got "
                f"{self.width}")
        self.ctas = default_ctas(self.device)
        self._pin: PinnedStaging | None = None   # the card's staging
        self.staged_bytes = 0          # bytes the last pack copied to the card

    def validate(self, r: ScoreRequest, label: str = "request"
                 ) -> np.ndarray:
        """Check one request's feature ids (in range, no duplicates, as
        many as values); returns them as int64. A duplicate would land
        twice on one tile offset, where the scatter keeps one of the two
        (on the card, either), so it is refused here and at the
        scheduler's admission."""
        idx = np.asarray(r.indices, np.int64)
        if len(idx) and (idx.min() < 0 or idx.max() >= self.d):
            raise ValueError(
                f"{label} has feature ids outside [0, {self.d})")
        if len(idx) != len(np.unique(idx)):
            raise ValueError(f"{label} has duplicate feature ids")
        if len(idx) != len(np.asarray(r.values)):
            raise ValueError(
                f"{label} has {len(idx)} indices but "
                f"{len(np.asarray(r.values))} values")
        return idx

    def plan(self, requests: Sequence[ScoreRequest]
             ) -> tuple[EllPlan, np.ndarray]:
        """The batch's :class:`EllPlan` (from its ``(batch_padded, d)``
        CSR, rows in request order) and its values, in the plan's order,
        cast to ``dtype``. Host numpy."""
        if len(requests) > self.batch:
            raise ValueError(f"{len(requests)} requests > batch size "
                             f"{self.batch}")
        indptr = np.zeros(self.batch_padded + 1, np.int64)
        idx_l, val_l = [], []
        for i, r in enumerate(requests):
            idx = self.validate(r, label=f"request {i}")
            indptr[i + 1] = len(idx)
            idx_l.append(idx)
            val_l.append(np.asarray(r.values, self.dtype))
        np.cumsum(indptr, out=indptr)
        indices = np.concatenate(idx_l) if idx_l else np.zeros(0, np.int64)
        values = (np.concatenate(val_l) if val_l
                  else np.zeros(0, self.dtype))
        csr = CSRMatrix(indptr=indptr, indices=indices, data=values,
                        shape=(self.batch_padded, self.d))
        return ell_plan(csr, self.block_b, self.block_d,
                        width=self.width), values

    def pack_scheduled(self, requests: Sequence[ScoreRequest]
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(data, cols, sched)`` of a batch on the packer's device:
        :meth:`pack`'s tiles and the live-tile schedule K1 walks (from the
        plan's ``per_block``, no read of the tiles)."""
        plan, values = self.plan(requests)
        sched = schedule_from_live(torch.from_numpy(plan.per_block),
                                   self.ctas)
        vals = np.asarray(values, np.float32)
        cols = torch.from_numpy(plan.cols)
        if self.device.type == "cuda":
            offsets, vals, sched, cols = self._stage(
                (np.asarray(plan.offsets, np.int64), vals, sched.numpy(),
                 plan.cols))
            plan = plan._replace(offsets=offsets)
        data = ell_fill(plan, vals, device=self.device, dtype=self.tile_dtype)
        return data, cols, sched

    def _stage(self, arrays) -> list[torch.Tensor]:
        """``arrays`` on the card in one copy from the pinned staging
        buffer, which grows by doubling and is reused once its last copy
        is done (polled; after a tick's margins came back it long is)."""
        nbytes = PinnedStaging.nbytes(arrays)
        pin = self._pin
        if pin is None or pin.buf.numel() < nbytes:
            grown = 2 * pin.buf.numel() if pin is not None else 1 << 16
            pin = self._pin = PinnedStaging(max(nbytes, grown))
        pin.wait_free()
        self.staged_bytes = nbytes
        return pin.stage(arrays, torch.empty(nbytes, dtype=torch.uint8,
                                             device=self.device))

    def pack(self, requests: Sequence[ScoreRequest]
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """ELL ``(data, cols)`` of a batch (shapes fixed per packer), on
        the packer's device.

        data : (n_row_blocks, width, block_b, block_d) of ``tile_dtype``
        cols : (n_row_blocks, width) int32
        """
        data, cols, _ = self.pack_scheduled(requests)
        return data, cols

    def pad_weights(self, w: np.ndarray) -> torch.Tensor:
        """``(d,)`` weights zero-padded to ``(d_padded,)``, as the f32
        vector K1 takes, on the packer's device."""
        w = np.asarray(w, self.dtype)
        if w.shape != (self.d,):
            raise ValueError(f"weights shape {w.shape} != ({self.d},)")
        wp = np.pad(w, (0, self.d_padded - self.d)).astype(np.float32)
        return torch.from_numpy(wp).to(self.device)


class ScoringEngine:
    """Micro-batch scoring over a published model's weights.

    Args:
        model: a :class:`repro_torch.glm_serve.registry.ModelRegistry`
            (its active version is loaded, and :meth:`maybe_reload`
            swaps in newly activated versions between ticks), or a plain
            ``(d,)`` weight array.
        loss: loss name for the prediction link; defaults to the registry
            model's ``cfg.loss`` (required for raw weights).
        batch: requests a scoring tick (the micro-batch width).
        block_b / block_d / width: the packer's tile geometry
            (:class:`RequestPacker`).
        hvp_dtype: the tiles' dtype, 'float32' (default) or 'bfloat16':
            at bf16 the tick runs K1's bf16 instance, which rounds ``w``
            to bf16 where the TPU kernel rounds ``c .* v``; margins are
            f32 sums either way.
        device: where ticks run (default the card; ``'cpu'`` runs the
            plain version of K1). Nothing falls back to the CPU.

    A tick is one K1 launch on the batch's tiles with its live-tile
    schedule, then one copy of the margins to the host.
    """

    def __init__(self, model, loss: str | None = None, *,
                 batch: int = 64, block_b: int = 8, block_d: int = 128,
                 width: int | None = None, hvp_dtype: str = "float32",
                 device=None):
        from repro_torch.glm_serve.registry import ModelRegistry

        self.device = resolve_device(device)
        self.registry = model if isinstance(model, ModelRegistry) else None
        if self.registry is not None:
            pub = self.registry.load()
            self.version: int | None = pub.version
            w = pub.w
            loss = loss or pub.cfg.loss
        else:
            self.version = None
            w = np.asarray(model)
            if loss is None:
                raise ValueError("loss is required when constructing "
                                 "from raw weights")
        self.loss = get_loss(loss)
        w = np.asarray(w)
        dtype = w.dtype if np.issubdtype(w.dtype, np.floating) \
            else np.float32
        self.hvp_dtype = hvp_dtype
        self.packer = RequestPacker(len(w), batch, block_b=block_b,
                                    block_d=block_d, width=width,
                                    dtype=dtype,
                                    tile_dtype=hvp_tile_dtype(hvp_dtype),
                                    device=self.device)
        self.w = w
        self._w_dev = self.packer.pad_weights(self.w)
        self.reloads = 0

    @property
    def batch(self) -> int:
        """Requests a tick (the packer's batch width)."""
        return self.packer.batch

    def maybe_reload(self) -> bool:
        """Swap in a newly activated registry version, if any (a
        ``serve.hot_swap`` span). Same-dimension weights keep the packer;
        a dimension change rebuilds it. Returns True iff a swap happened;
        a no-op without a registry."""
        if self.registry is None:
            return False
        v = self.registry.active_version()
        if v is None or v == self.version:
            return False
        with obs.span("serve.hot_swap", version=int(v)):
            pub = self.registry.load(v)
            if len(pub.w) != self.packer.d:
                self.packer = RequestPacker(
                    len(pub.w), self.packer.batch,
                    block_b=self.packer.block_b,
                    block_d=self.packer.block_d,
                    dtype=self.packer.dtype,
                    tile_dtype=self.packer.tile_dtype,
                    device=self.device)
            self.w = np.asarray(pub.w)
            self._w_dev = self.packer.pad_weights(self.w)
            self.version = v
            self.reloads += 1
        return True

    def score(self, requests: Sequence[ScoreRequest]) -> np.ndarray:
        """Margins ``<x_i, w>`` for any number of requests, ``batch`` a
        tick: each tick one K1 launch and one copy back to the host."""
        out = np.zeros(len(requests), self.packer.dtype)
        for lo in range(0, len(requests), self.packer.batch):
            part = requests[lo: lo + self.packer.batch]
            data, cols, sched = self.packer.pack_scheduled(part)
            y = kops.ell_matvec(data, cols, self._w_dev, sched=sched)
            out[lo: lo + len(part)] = y[: len(part)].cpu().numpy()
        return out

    def predict(self, requests: Sequence[ScoreRequest]) -> np.ndarray:
        """Predicted labels: +-1 by the margin's sign for classification
        losses (ties to +1), the margin for 'quadratic' (the reference
        engine's rule)."""
        a = self.score(requests)
        if self.loss.name == "quadratic":
            return a
        return np.where(a >= 0, 1.0, -1.0).astype(a.dtype)

    def predict_proba(self, requests: Sequence[ScoreRequest]
                      ) -> np.ndarray:
        """P(y = +1 | x) = sigmoid(margin) in float64, cast back;
        'logistic' loss only."""
        if self.loss.name != "logistic":
            raise ValueError(
                f"predict_proba needs the 'logistic' loss, engine uses "
                f"{self.loss.name!r}")
        a = self.score(requests)
        p = 1.0 / (1.0 + np.exp(-a.astype(np.float64)))
        return p.astype(a.dtype)
