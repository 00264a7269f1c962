"""Preemption-aware shutdown: SIGTERM/SIGINT -> save -> requeue exit
(copied from the JAX package's ``resilience/preemption.py``; it imports
the standard library only).

Preemptible cloud GPUs hand the host a SIGTERM and a grace window. The
contract:

- :class:`PreemptionGuard` installs idempotent SIGTERM/SIGINT
  handlers that only set a flag (async-signal-safe; no IO in the
  handler). The trainer polls the flag at safe boundaries, on the main
  thread, never inside a burst:

  * **first signal** — graceful: finish the current epoch, take the
    regular end-of-epoch checkpoint synchronously, exit. Epochs are
    replayable units (epoch-boundary env reseeding,
    ``sac/trainer.py``), so resume is bitwise-lossless.
  * **second signal** — urgent: checkpoint at the next *update-window*
    boundary (staging just flushed, burst complete — the safe step
    boundary) and exit immediately. The learner state is still
    lossless; only the un-stepped tail of the epoch's env interaction
    is skipped on resume.

- :class:`Preempted` unwinds the training loop after the emergency
  save; ``train.py`` maps it to :data:`REQUEUE_EXIT_CODE` (75,
  BSD ``EX_TEMPFAIL`` — the classic "transient, try again" code) so
  schedulers can distinguish *requeue me* from a crash and restart
  with ``--run <id>`` for a lossless resume.
"""

from __future__ import annotations

import logging
import signal
import threading
import typing as t

logger = logging.getLogger(__name__)

__all__ = ["REQUEUE_EXIT_CODE", "Preempted", "PreemptionGuard"]

# BSD EX_TEMPFAIL: "temporary failure, retry later" — distinct from
# every Python/pytest/segfault exit code a crash would produce.
REQUEUE_EXIT_CODE = 75


class Preempted(RuntimeError):
    """Training was interrupted by a preemption signal *after* the
    emergency checkpoint landed; carries the requeue exit code."""

    def __init__(self, epoch: int, urgent: bool = False):
        self.epoch = epoch
        self.urgent = urgent
        self.exit_code = REQUEUE_EXIT_CODE
        super().__init__(
            f"preempted at epoch {epoch} "
            f"({'window' if urgent else 'epoch'} boundary); state saved, "
            f"exit with code {REQUEUE_EXIT_CODE} to requeue"
        )


class PreemptionGuard:
    """Signal-flag bridge between the OS and the training loop.

    ``install()`` replaces the handlers (saving the previous ones for
    ``uninstall()``); :meth:`request_preemption` is the programmatic
    path used by the fault-injection harness and by embedders that
    learn of preemption through an API instead of a signal (GCE
    metadata server, k8s preStop hook).
    """

    def __init__(
        self,
        signals: t.Sequence[int] = (signal.SIGTERM, signal.SIGINT),
    ):
        self.signals = tuple(signals)
        self._count = 0
        self._event = threading.Event()
        self._previous: dict = {}
        self.exit_code = REQUEUE_EXIT_CODE

    # ------------------------------------------------------------ handlers

    def _handle(self, signum, frame) -> None:  # noqa: ARG002
        # Flag-only: logging/IO is not async-signal-safe.
        self._count += 1
        self._event.set()

    def install(self) -> "PreemptionGuard":
        for sig in self.signals:
            try:
                self._previous[sig] = signal.signal(sig, self._handle)
            except ValueError:
                # Not the main thread (embedded trainer): signal-based
                # delivery is unavailable, request_preemption still works.
                logger.warning(
                    "cannot install handler for signal %s outside the "
                    "main thread; use request_preemption()", sig,
                )
        return self

    def uninstall(self) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # ------------------------------------------------------------- queries

    def request_preemption(self, urgent: bool = False) -> None:
        """Programmatic trigger: one call == one signal; ``urgent=True``
        counts as two (skip straight to the window-boundary save)."""
        self._count += 2 if urgent else 1
        self._event.set()

    @property
    def triggered(self) -> bool:
        """At least one signal: save and exit at the next epoch boundary."""
        return self._count >= 1

    @property
    def urgent(self) -> bool:
        """Repeated signals: save and exit at the next window boundary."""
        return self._count >= 2

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the first signal (monitoring threads)."""
        return self._event.wait(timeout)
