"""Atomic outer-loop checkpoints of a damped-Newton solve (the JAX
package's ``repro.robust.checkpoint``, the same on-disk format).

A solve's durable state is small: the iterate ``w``, the RNG key, the
per-iteration history and the communication ledger; the data is rebuilt
from its source and PCG restarts every outer iteration. Layout::

    ckpt/
      it-00000003/          one complete outer-iteration snapshot
        state.json          header: format version, next_iter, key,
                            history, ledger, replan events, cfg
        w.npy               iterate, byte-exact, ORIGINAL feature order
      it-00000004/ ...
      LATEST                text pointer to the newest complete snapshot

Write protocol (crash-safe at every boundary): stage under a dot-prefixed
temporary directory, fsync every file, fsync the staged directory, rename
it into place, fsync the parent, then rewrite ``LATEST`` through a
temporary file, fsync and ``os.replace``. :func:`load_checkpoint` follows
only ``LATEST``, which names only a complete snapshot. The newest
:data:`KEEP` snapshots are kept. A checkpoint written by either package
loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np

from repro_torch.obs import tracer as obs

CHECKPOINT_VERSION = 1
KEEP = 2           # retained snapshots (latest + one safety margin)
_STATE = "state.json"
_W = "w.npy"
_LATEST = "LATEST"


def fsync_file(path: str):
    """fsync one file's contents to stable storage."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str):
    """fsync a directory entry (makes renames and creates inside it
    durable)."""
    fsync_file(path)


@dataclasses.dataclass
class CheckpointState:
    """Everything ``DiscoSolver.fit(resume=True)`` needs to continue.

    Attributes:
        next_iter: the outer iteration the resumed loop starts at.
        w: (d,) iterate in original feature order.
        key: PRNG key data (uint32, the reference's format).
        history: per-iteration stats dicts accumulated so far.
        ledger: communication totals so far
            (``rounds`` / ``floats`` / ``spmd_collectives``).
        replan_events: elastic re-plan records so far (plain dicts).
        cfg: the solve's config as a dict; resume refuses a mismatch.
    """

    next_iter: int
    w: np.ndarray
    key: np.ndarray
    history: list[dict]
    ledger: dict
    replan_events: list[dict]
    cfg: dict


def _snap_dir(path: str, it: int) -> str:
    return os.path.join(path, f"it-{it:08d}")


def save_checkpoint(path: str, state: CheckpointState) -> str:
    """Durably persist ``state`` under ``path`` (the module's write
    protocol, inside a ``ckpt.write`` span); returns the snapshot
    directory. Snapshots older than the newest :data:`KEEP` are pruned."""
    with obs.span("ckpt.write", next_iter=int(state.next_iter)):
        return _save_checkpoint(path, state)


def _save_checkpoint(path: str, state: CheckpointState) -> str:
    os.makedirs(path, exist_ok=True)
    it = int(state.next_iter)
    tmp = os.path.join(path, f".tmp-it-{it:08d}")
    if os.path.isdir(tmp):                     # leftover from a crash
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.save(os.path.join(tmp, _W), np.asarray(state.w))
    key = np.asarray(state.key)
    header = dict(
        format_version=CHECKPOINT_VERSION,
        next_iter=it,
        key=[int(v) for v in key.ravel()],
        key_dtype=str(key.dtype),
        history=state.history,
        ledger=dict(state.ledger),
        replan_events=list(state.replan_events),
        cfg=dict(state.cfg),
    )
    with open(os.path.join(tmp, _STATE), "w") as f:
        json.dump(header, f, indent=1, default=float)
        f.flush()
        os.fsync(f.fileno())
    fsync_file(os.path.join(tmp, _W))
    fsync_dir(tmp)
    final = _snap_dir(path, it)
    if os.path.isdir(final):                   # re-save of the same iter
        shutil.rmtree(final)
    os.rename(tmp, final)
    fsync_dir(path)

    ptr_tmp = os.path.join(path, f".{_LATEST}.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(f"{it}\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(ptr_tmp, os.path.join(path, _LATEST))
    fsync_dir(path)

    for old in sorted(_snapshots(path))[:-KEEP]:
        shutil.rmtree(_snap_dir(path, old), ignore_errors=True)
    return final


def _snapshots(path: str) -> list[int]:
    try:
        names = os.listdir(path)
    except FileNotFoundError:
        return []
    return [int(name[3:]) for name in names
            if name.startswith("it-") and name[3:].isdigit()]


def latest_checkpoint(path: str) -> int | None:
    """``next_iter`` of the newest complete snapshot, or None."""
    try:
        with open(os.path.join(path, _LATEST)) as f:
            return int(f.read().strip())
    except (FileNotFoundError, ValueError):
        return None


def load_checkpoint(path: str) -> CheckpointState | None:
    """Load the snapshot ``LATEST`` points at; None when there is none."""
    it = latest_checkpoint(path)
    if it is None:
        return None
    snap = _snap_dir(path, it)
    with open(os.path.join(snap, _STATE)) as f:
        header = json.load(f)
    if header.get("format_version") != CHECKPOINT_VERSION:
        raise ValueError(
            f"checkpoint {snap!r} has format "
            f"{header.get('format_version')!r}; this reader supports "
            f"format {CHECKPOINT_VERSION}")
    w = np.load(os.path.join(snap, _W))
    key = np.asarray(header["key"],
                     np.dtype(header.get("key_dtype", "uint32")))
    return CheckpointState(
        next_iter=int(header["next_iter"]), w=w, key=key,
        history=list(header["history"]), ledger=dict(header["ledger"]),
        replan_events=list(header.get("replan_events", [])),
        cfg=dict(header["cfg"]))
