"""Robustness layer of the port (the JAX package's ``repro.robust``):
fault injection, retrying I/O and checkpoint/resume.

* :mod:`repro_torch.robust.faults`: a deterministic, seedable
  fault-injection harness (:class:`FaultPlan` / :class:`FaultInjector`)
  and real on-disk damage for the shard store's checksums.
* :mod:`repro_torch.robust.retry`: :class:`RetryPolicy`, bounded retries
  with exponential backoff and a per-step deadline.
* :mod:`repro_torch.robust.straggler`: :class:`ChunkTimingLedger`
  (per-chunk observed load seconds) and :class:`ElasticReplanner`, which
  re-runs the chunk-granular LPT on measured cost when the observed
  shard imbalance of a streamed solve exceeds a threshold.
* :mod:`repro_torch.robust.checkpoint`: atomic (fsync + rename)
  outer-loop checkpoints, the persistence half of
  ``DiscoSolver.fit(checkpoint_dir=..., resume=True)``.
"""
from repro_torch.robust.checkpoint import (CheckpointState,
                                           latest_checkpoint,
                                           load_checkpoint,
                                           save_checkpoint)
from repro_torch.robust.faults import (ChunkCorruptionError, ChunkReadError,
                                       FaultInjector, FaultPlan,
                                       SimulatedCrash, SimulatedKill,
                                       TransientIOError, corrupt_chunk_file,
                                       crashpoint, truncate_chunk_file)
from repro_torch.robust.retry import (RetryPolicy, StepDeadlineExceeded,
                                      call_with_retries)
from repro_torch.robust.straggler import (ChunkTimingLedger,
                                          ElasticReplanner, ReplanEvent,
                                          barrier_seconds)

__all__ = [
    "ChunkCorruptionError", "ChunkReadError", "FaultInjector", "FaultPlan",
    "SimulatedCrash", "SimulatedKill", "TransientIOError",
    "corrupt_chunk_file", "crashpoint", "truncate_chunk_file",
    "RetryPolicy", "StepDeadlineExceeded", "call_with_retries",
    "ChunkTimingLedger", "ElasticReplanner", "ReplanEvent",
    "barrier_seconds",
    "CheckpointState", "latest_checkpoint", "load_checkpoint",
    "save_checkpoint",
]
