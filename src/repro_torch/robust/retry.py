"""Bounded retries with exponential backoff and a per-step deadline (the
JAX package's ``repro.robust.retry``).

A retryable step is attempted up to ``max_retries + 1`` times with
exponentially growing sleeps between attempts, and the whole step, sleeps
included, must finish inside ``deadline_s`` or the error is escalated
(a hung disk surfaces as a loud failure, not a silent stall). Only
*transient* errors are retried (``OSError`` and
:class:`repro_torch.robust.faults.TransientIOError` by the caller's
choice); everything else propagates at once. Each caught failure emits
an ``io.retry`` instant and adds to the ``io.retries`` counter.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch.obs import tracer as obs


class StepDeadlineExceeded(RuntimeError):
    """A retried step ran out of its wall-clock budget (hung I/O)."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry, backoff and deadline knobs of one retryable step.

    Attributes:
        max_retries: additional attempts after the first failure (0
            disables retrying).
        backoff_s: sleep before the first retry.
        backoff_factor: multiplier applied to the sleep per retry.
        deadline_s: wall-clock budget for the step across all attempts
            and sleeps; ``0`` means none. Exceeding it raises
            :class:`StepDeadlineExceeded` chained to the last error.
        sleep: injectable sleep function (tests pass a recorder).
    """

    max_retries: int = 3
    backoff_s: float = 0.05
    backoff_factor: float = 2.0
    deadline_s: float = 0.0
    sleep: Callable[[float], None] = time.sleep

    def backoff_schedule(self) -> list[float]:
        """The sleeps (seconds) between successive attempts."""
        return [self.backoff_s * self.backoff_factor ** i
                for i in range(self.max_retries)]


def call_with_retries(fn: Callable[[], object], policy: RetryPolicy,
                      *, retryable: tuple[type[BaseException], ...]
                      = (OSError,), clock: Callable[[], float]
                      = time.monotonic):
    """Run ``fn()`` under ``policy`` and return its result.

    Retries only exceptions in ``retryable``. Raises the last error once
    the retries are spent, or :class:`StepDeadlineExceeded` (chained to
    the last error, if any) once ``policy.deadline_s`` is spent,
    whichever comes first.
    """
    start = clock()
    last: BaseException | None = None
    for attempt in range(policy.max_retries + 1):
        if policy.deadline_s > 0 and clock() - start > policy.deadline_s:
            raise StepDeadlineExceeded(
                f"step exceeded its {policy.deadline_s:.3g}s deadline "
                f"after {attempt} attempt(s)") from last
        try:
            return fn()
        except retryable as e:
            last = e
            obs.instant("io.retry", attempt=attempt,
                        error=type(e).__name__)
            obs.count("io.retries")
            if attempt >= policy.max_retries:
                raise
            policy.sleep(policy.backoff_s
                         * policy.backoff_factor ** attempt)
    raise last  # unreachable; keeps type checkers honest
