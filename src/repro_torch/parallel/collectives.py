"""Collectives over the shards of one solve.

The counterpart of the JAX package's one-axis mesh (``launch/mesh.py``)
and of ``shard_map`` + ``lax.psum``. :class:`InProcessGroup` holds ``m``
shards as tensors on one device: a sharded quantity is a sequence (or a
stacked tensor) with one entry per shard, and :meth:`all_reduce` is the
ordered sum ``shard 0 + shard 1 + ...``, so a given ``m`` gives the same
numbers on every run. With it, DiSCO-S and DiSCO-F at m = 1 or m = 4 run
on one card.
"""
from __future__ import annotations

from typing import Sequence

import torch


class InProcessGroup:
    """``size`` shards living in this process on one device."""

    def __init__(self, size: int = 1):
        if int(size) < 1:
            raise ValueError(f"group size must be >= 1, got {size}")
        self.size = int(size)

    def all_reduce(self, parts: Sequence[torch.Tensor] | torch.Tensor
                   ) -> torch.Tensor:
        """Sum of the per-shard ``parts`` in shard order (the identity on
        a group of one)."""
        if len(parts) != self.size:
            raise ValueError(f"all_reduce got {len(parts)} parts for a "
                             f"group of {self.size}")
        out = parts[0]
        for s in range(1, self.size):
            out = out + parts[s]
        return out
