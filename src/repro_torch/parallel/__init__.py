"""Shard groups and their collectives, and the launcher of one process a
shard."""
from repro_torch.parallel.collectives import (DistributedGroup,
                                              InProcessGroup)

__all__ = ["InProcessGroup", "DistributedGroup"]
