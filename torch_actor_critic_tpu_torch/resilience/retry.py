"""Bounded retry-with-backoff for flaky checkpoint IO.

Long preemptible runs checkpoint to network filesystems (GCS fuse,
NFS) whose transient failures — timeouts, connection resets, 5xx
surfacing as ``OSError`` — are routine over a multi-day horizon. The
reference has no story at all: one failed MLflow write kills the run.
Here every checkpoint save/restore goes through :func:`call_with_retries`
(``utils/checkpoint.py``), so a transient fault costs one backoff
sleep instead of the run.

Deterministic by design: the caller injects the ``sleep`` function, so
tests drive the retry ladder with zero real waiting (the
no-sleeps-flakiness rule in ``tests/test_resilience.py``).
"""

from __future__ import annotations

import logging
import time
import typing as t

logger = logging.getLogger(__name__)

__all__ = ["call_with_retries"]


def call_with_retries(
    fn: t.Callable[[], t.Any],
    *,
    attempts: int = 3,
    base_delay_s: float = 0.5,
    retry_on: t.Tuple[type, ...] = (OSError,),
    give_up_on: t.Tuple[type, ...] = (FileNotFoundError,),
    sleep: t.Callable[[float], None] = time.sleep,
    what: str = "checkpoint IO",
):
    """Run ``fn`` with up to ``attempts`` tries and exponential backoff.

    ``retry_on`` classifies transient faults; ``give_up_on`` carves out
    subclasses that are deterministic, not transient (a half-written
    checkpoint raises ``FileNotFoundError`` — an ``OSError`` subclass —
    on every read; retrying it only delays the fallback to the previous
    epoch). The final failure re-raises the original exception so
    callers keep their error taxonomy.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    for attempt in range(attempts):
        try:
            return fn()
        except give_up_on:
            raise
        except retry_on as e:
            if attempt == attempts - 1:
                raise
            delay = base_delay_s * (2**attempt)
            logger.warning(
                "%s failed (attempt %d/%d): %s — retrying in %.2fs",
                what, attempt + 1, attempts, e, delay,
            )
            sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
