"""Shard groups and their collectives."""
from repro_torch.parallel.collectives import InProcessGroup

__all__ = ["InProcessGroup"]
