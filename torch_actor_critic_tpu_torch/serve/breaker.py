"""Per-slot engine circuit breaker: fail fast, probe, recover.

An engine that has started failing — poisoned params emitting NaN
actions, an accelerator fault, a wedged runtime — fails *slowly*: every
request still pays queueing plus a doomed forward before erroring. The
breaker is the standard containment state machine (closed → open →
half-open) applied to the policy engine, with the failure predicate
coming from the serving path itself: a forward that raised, or one
whose in-graph fused all-finite reduction flagged non-finite actions
(:class:`~torch_actor_critic_tpu_torch.serve.admission.NonFiniteActionError`).

States:

- **closed** — healthy. Failures are counted; ``fail_threshold``
  *consecutive* failures trip the breaker (one transient fault in a
  stream of successes never does — success resets the streak).
- **open** — every request for the slot is shed immediately
  (503 + ``Retry-After`` = remaining cooldown) with no engine work.
  After ``cooldown_s`` the breaker lazily enters half-open on the next
  ``allow()``.
- **half-open** — exactly ``probe_quota`` request groups are let
  through as probes; the rest keep shedding. A probe success closes
  the breaker (full recovery); a probe failure re-opens it for another
  cooldown.

Deterministic by construction: the clock is injected (``clock``), so
tests drive open→half-open transitions by advancing a fake clock —
the no-sleeps rule of ``tests/test_resilience.py`` carried over to
``tests/test_overload.py``. Thread-safe: one lock guards every
transition; the dispatcher thread records outcomes while HTTP handler
threads read ``admits()``.

Every transition emits a structured event dict through ``on_event``
(the registry wires this to its bounded event log and the process
logger; ``/metrics`` exports per-slot state/trips/probes via
``ModelRegistry.breaker_stats``).
"""

from __future__ import annotations

import logging
import threading
import time
import typing as t

logger = logging.getLogger(__name__)

__all__ = ["CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    def __init__(
        self,
        fail_threshold: int = 5,
        cooldown_s: float = 5.0,
        probe_quota: int = 1,
        clock: t.Callable[[], float] = time.monotonic,
        on_event: t.Callable[[dict], None] | None = None,
        name: str = "default",
    ):
        if fail_threshold < 1:
            raise ValueError(
                f"fail_threshold must be >= 1, got {fail_threshold}"
            )
        if cooldown_s <= 0:
            raise ValueError(f"cooldown_s must be > 0, got {cooldown_s}")
        if probe_quota < 1:
            raise ValueError(f"probe_quota must be >= 1, got {probe_quota}")
        self.fail_threshold = int(fail_threshold)
        self.cooldown_s = float(cooldown_s)
        self.probe_quota = int(probe_quota)
        self.name = name
        self._clock = clock
        self.on_event = on_event
        self._lock = threading.Lock()
        self._state = CLOSED  # guarded-by: _lock
        self._consecutive_failures = 0  # guarded-by: _lock
        self._opened_at: float | None = None  # guarded-by: _lock
        self._probes_inflight = 0  # guarded-by: _lock
        self.trips_total = 0  # guarded-by: _lock
        self.probes_total = 0  # guarded-by: _lock
        self.failures_total = 0  # guarded-by: _lock
        self.successes_total = 0  # guarded-by: _lock

    # ------------------------------------------------------------- events

    def _emit(self, event: str, **fields):
        """Build + deliver one transition event. Callers hold
        ``self._lock`` (every emit sits inside a state transition), so
        the snapshot fields are consistent; the ``on_event`` sink is
        therefore invoked under the breaker lock and must not call
        back into this breaker."""
        payload = dict(
            event=event, breaker=self.name, state=self._state,
            consecutive_failures=self._consecutive_failures,
            trips_total=self.trips_total, **fields,
        )
        if self.on_event is not None:
            try:
                self.on_event(payload)
            except Exception:  # noqa: BLE001 — a broken event sink must
                logger.exception("breaker event sink failed")  # not
                # take the state machine down with it

    # -------------------------------------------------------------- state

    def _refresh_locked(self, now: float):
        """Lazy open → half-open transition once the cooldown elapsed
        (no timer thread: the next admission check performs it)."""
        if (
            self._state == OPEN
            and self._opened_at is not None
            and now - self._opened_at >= self.cooldown_s
        ):
            self._state = HALF_OPEN
            self._probes_inflight = 0
            self._emit("breaker_half_open")

    @property
    def state(self) -> str:
        with self._lock:
            self._refresh_locked(self._clock())
            return self._state

    def retry_after_s(self) -> float:
        """Seconds until a retry could plausibly be admitted: remaining
        cooldown when open, one cooldown's worth of patience otherwise."""
        with self._lock:
            now = self._clock()
            self._refresh_locked(now)
            if self._state == OPEN and self._opened_at is not None:
                return max(0.0, self.cooldown_s - (now - self._opened_at))
            return self.cooldown_s

    def admits(self) -> bool:
        """Submit-time check (non-consuming): False only while hard
        open. Half-open admits — queued requests become probe
        candidates; :meth:`allow` rations the actual probes."""
        with self._lock:
            self._refresh_locked(self._clock())
            return self._state != OPEN

    def allow(self) -> bool:
        """Dispatch-time check, called once per request group. Closed
        always allows; open never does; half-open allows up to
        ``probe_quota`` concurrent probe groups."""
        with self._lock:
            self._refresh_locked(self._clock())
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                return False
            if self._probes_inflight >= self.probe_quota:
                return False
            self._probes_inflight += 1
            self.probes_total += 1
            self._emit("breaker_probe")
            return True

    # ------------------------------------------------------------ outcomes

    def record_success(self):
        with self._lock:
            self.successes_total += 1
            self._consecutive_failures = 0
            if self._state == HALF_OPEN:
                self._state = CLOSED
                self._opened_at = None
                self._probes_inflight = 0
                self._emit("breaker_close")

    def record_failure(self, error: BaseException | None = None):
        with self._lock:
            self.failures_total += 1
            self._consecutive_failures += 1
            if self._state == HALF_OPEN:
                # The probe failed: back to a full cooldown.
                self._state = OPEN
                self._opened_at = self._clock()
                self.trips_total += 1
                self._probes_inflight = 0
                self._emit("breaker_reopen", error=repr(error)[:200])
            elif (
                self._state == CLOSED
                and self._consecutive_failures >= self.fail_threshold
            ):
                self._state = OPEN
                self._opened_at = self._clock()
                self.trips_total += 1
                self._emit("breaker_open", error=repr(error)[:200])

    # ------------------------------------------------------------ snapshot

    def snapshot(self) -> dict:
        """The ``/metrics`` view of this breaker."""
        with self._lock:
            self._refresh_locked(self._clock())
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "failures_total": self.failures_total,
                "successes_total": self.successes_total,
                "trips_total": self.trips_total,
                "probes_total": self.probes_total,
                "fail_threshold": self.fail_threshold,
                "cooldown_s": self.cooldown_s,
            }
