"""SLO-driven elasticity: the actuator over the obs plane (a copy of the
JAX package's ``elastic/controller.py``).

The sensor is the ``obs/`` run-wide plane, whose
:class:`~torch_actor_critic_tpu_torch.obs.slo.SLOEngine` emits exactly-once
``slo_breach``/``slo_recovered`` events. This module consumes them:
:class:`ElasticController` subscribes to the collector's per-scrape
window (:attr:`ObsCollector.window_hook`) and turns breach/recover
edges plus the fleet-aggregated signals (goodput, shed rate, queue
depth, p99) into spawn/drain decisions executed through an *actuator*
— the serving plane's :class:`~torch_actor_critic_tpu_torch.elastic.serving.
FleetScaler` (WarmPool draw -> router admission; drain-based scale-in).
The training plane's manager (degrade to the surviving actor slice)
waits for the port's actor fleet.

Anti-flap machinery, all provable with an injected clock:

- **min/max replica bounds** — the controller never scales outside
  ``[min_replicas, max_replicas]``;
- **per-rule cooldowns** — a rule whose breach just spawned a worker
  cannot re-trigger until ``scale_out_cooldown_s`` elapses (a second,
  different rule still can); an attempt that added *no* capacity
  (``bounded`` hold, ``no_spare`` draw, actuator fault) retries after
  the much shorter ``scale_out_retry_backoff_s`` instead, so recovery
  is not silenced for a full cooldown that bought nothing;
- **hysteresis windows** — scale-in requires ``scale_in_ok_windows``
  consecutive all-green scrape windows AND a per-worker queue depth
  below ``queue_low_watermark``, then its own cooldown.

Every decision is a :class:`DecisionLog` record: a schema-stable dict
(:data:`DECISION_FIELDS`) forwarded to the telemetry recorder as an
``elastic_decision`` event and convertible to Perfetto spans on the
elastic lane (:func:`~torch_actor_critic_tpu_torch.telemetry.traceview.
elastic_decision_events`). Runbook: docs/RESILIENCE.md "Elasticity".
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
import typing as t

logger = logging.getLogger(__name__)

__all__ = [
    "DECISION_FIELDS",
    "DecisionLog",
    "ElasticController",
    "ElasticPolicy",
]

# Every decision record carries at least these keys — the schema the
# telemetry event, the Perfetto converter and the smoke assert against.
DECISION_FIELDS = (
    "seq", "time", "plane", "action", "reason", "rule",
    "replicas_before", "replicas_after", "outcome",
)

_ACTIONS = ("scale_out", "scale_in", "degrade", "readmit")


@dataclasses.dataclass(frozen=True)
class ElasticPolicy:
    """Knobs of the scale state machine (docs/RESILIENCE.md table).

    ``scale_out_rules`` names the SLO rules whose *breach* edge
    requests capacity — by default the serving trio the router's
    aggregated /metrics exposes (goodput floor, p99 ceiling, shed-rate
    ceiling). Rules not listed still breach and alert; they just never
    spawn a worker."""

    min_replicas: int = 1
    max_replicas: int = 4
    scale_out_rules: t.Tuple[str, ...] = (
        "goodput_floor", "p99_ceiling", "shed_rate_ceiling",
    )
    scale_out_cooldown_s: float = 10.0
    # A scale-out attempt that added no capacity (max_replicas hold,
    # no warm spare, actuator fault) retries after this much shorter
    # backoff instead of the full cooldown — a spare becoming ready or
    # a replica dying right after the attempt is not silenced for the
    # whole cooldown, and a persistent hold still cannot spam every
    # window.
    scale_out_retry_backoff_s: float = 2.0
    scale_in_cooldown_s: float = 30.0
    scale_in_ok_windows: int = 5
    queue_low_watermark: float = 1.0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}"
            )
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) must be >= "
                f"min_replicas ({self.min_replicas})"
            )
        if self.scale_in_ok_windows < 1:
            raise ValueError(
                "scale_in_ok_windows must be >= 1, got "
                f"{self.scale_in_ok_windows}"
            )
        for f in (
            "scale_out_cooldown_s",
            "scale_out_retry_backoff_s",
            "scale_in_cooldown_s",
        ):
            if getattr(self, f) < 0:
                raise ValueError(f"{f} must be >= 0")


class DecisionLog:
    """Bounded, counted record of every elastic decision.

    One log per run, shared by the serving controller and the training
    manager so the Perfetto export shows both planes' decisions on one
    elastic lane. Records carry perf-clock bounds (``t0``/``dur_s``)
    for the trace converter plus the wall time the telemetry event
    stamps."""

    def __init__(self, capacity: int = 1024, telemetry=None):
        self.telemetry = telemetry
        self._lock = threading.Lock()
        self._records: collections.deque = (  # guarded-by: _lock
            collections.deque(maxlen=capacity)
        )
        self._seq = 0  # guarded-by: _lock
        self._counts: t.Dict[str, int] = {}  # guarded-by: _lock

    def record(
        self,
        action: str,
        plane: str,
        reason: str,
        rule: str | None = None,
        replicas_before: int = 0,
        replicas_after: int = 0,
        outcome: str = "ok",
        t0: float | None = None,
        dur_s: float = 0.0,
        **extra,
    ) -> dict:
        if action not in _ACTIONS:
            raise ValueError(
                f"unknown elastic action {action!r}; one of {_ACTIONS}"
            )
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._counts[action] = self._counts.get(action, 0) + 1
            if outcome != "ok":
                key = f"{action}_{outcome}"
                self._counts[key] = self._counts.get(key, 0) + 1
        rec = {
            "seq": seq,
            "time": time.time(),
            "plane": plane,
            "action": action,
            "reason": reason,
            "rule": rule,
            "replicas_before": int(replicas_before),
            "replicas_after": int(replicas_after),
            "outcome": outcome,
            "t0": time.perf_counter() if t0 is None else t0,
            "dur_s": float(dur_s),
        }
        rec.update(extra)
        with self._lock:
            self._records.append(rec)
        logger.info(
            "elastic %s [%s]: %s (rule=%s, replicas %d -> %d, %s)",
            action, plane, reason, rule, replicas_before,
            replicas_after, outcome,
        )
        if self.telemetry is not None:
            fields = {k: v for k, v in rec.items() if k not in ("t0",)}
            self.telemetry.event("elastic_decision", **fields)
        return rec

    def records(self) -> t.List[dict]:
        with self._lock:
            return list(self._records)

    def counts(self) -> t.Dict[str, int]:
        with self._lock:
            out = dict(self._counts)
            out["decisions_total"] = self._seq
        return out


class ElasticController:
    """The scale state machine over one actuator.

    ``actuator`` provides ``replicas() -> int``, ``queue_depth() ->
    float`` (fleet-total backlog), ``scale_out(reason) -> dict`` and
    ``scale_in(reason) -> dict`` — each returning at least an
    ``outcome`` (plus e.g. the worker name). :meth:`observe_window` is
    wired as the obs collector's ``window_hook``: it runs on the scrape
    thread, so actuators must be non-blocking beyond a bounded draw
    timeout (drain waits happen on reaper threads, never here)."""

    def __init__(
        self,
        actuator,
        policy: ElasticPolicy | None = None,
        log: DecisionLog | None = None,
        plane: str = "serve",
        clock: t.Callable[[], float] = time.monotonic,
    ):
        self.actuator = actuator
        self.policy = policy if policy is not None else ElasticPolicy()
        self.log = log if log is not None else DecisionLog()
        self.plane = plane
        self._clock = clock
        self._lock = threading.Lock()
        self._active_breaches: t.Set[str] = set()  # guarded-by: _lock
        # Per-rule next-eligible time: a successful spawn pushes it out
        # by the full cooldown, a failed/bounded attempt only by the
        # short retry backoff.
        self._next_eligible: t.Dict[str, float] = {}  # guarded-by: _lock
        self._last_scale_in = -float("inf")  # guarded-by: _lock
        self._ok_streak = 0  # guarded-by: _lock
        self.windows_total = 0  # guarded-by: _lock
        self.bounded_total = 0  # guarded-by: _lock
        self.last_action: str | None = None  # guarded-by: _lock
        self.last_rule: str | None = None  # guarded-by: _lock

    # ------------------------------------------------------------ windows

    def observe_window(self, row: dict) -> t.List[dict]:
        """One scrape window: fold the SLO edges into breach state,
        then run the state machine. Returns the decisions taken (empty
        most windows). Never raises — the obs scrape loop must outlive
        a bad actuation."""
        try:
            return self._observe(row)
        except Exception:  # noqa: BLE001 — an actuator fault is logged, never a scrape-loop crash
            logger.exception("elastic window actuation failed")
            return []

    def _observe(self, row: dict) -> t.List[dict]:
        slo = row.get("slo") or {}
        events = slo.get("events") or []
        now = self._clock()
        with self._lock:
            self.windows_total += 1
            for ev in events:
                rule = ev.get("rule")
                if ev.get("type") == "slo_breach":
                    self._active_breaches.add(rule)
                elif ev.get("type") == "slo_recovered":
                    self._active_breaches.discard(rule)
            active = set(self._active_breaches)
            if active:
                self._ok_streak = 0
            else:
                self._ok_streak += 1
            ok_streak = self._ok_streak
        decisions: t.List[dict] = []
        out = self._maybe_scale_out(active, now)
        if out is not None:
            decisions.append(out)
        if not decisions and not active:
            inn = self._maybe_scale_in(ok_streak, now)
            if inn is not None:
                decisions.append(inn)
        return decisions

    def _maybe_scale_out(
        self, active: t.Set[str], now: float
    ) -> dict | None:
        pol = self.policy
        # First eligible active rule — a rule that just fired does not
        # silence a second, different breach. Eligibility is stamped
        # pessimistically at the retry backoff here (so a bounded hold,
        # a no-spare draw or an actuator fault cannot retry every
        # window) and upgraded to the full cooldown only once the
        # attempt actually adds capacity.
        with self._lock:
            rule = None
            for r in pol.scale_out_rules:
                if r not in active:
                    continue
                if now < self._next_eligible.get(r, -float("inf")):
                    continue
                rule = r
                self._next_eligible[r] = (
                    now + pol.scale_out_retry_backoff_s
                )
                break
        if rule is None:
            return None
        before = int(self.actuator.replicas())
        if before >= pol.max_replicas:
            with self._lock:
                self.bounded_total += 1
            logger.warning(
                "elastic: rule %s breached but fleet is at max_replicas"
                " (%d); holding", rule, pol.max_replicas,
            )
            return None
        t0 = time.perf_counter()
        result = self.actuator.scale_out(reason=f"slo_breach:{rule}")
        dur = time.perf_counter() - t0
        outcome = str(result.get("outcome", "ok"))
        if outcome in ("spawned", "ok"):
            with self._lock:
                self._next_eligible[rule] = (
                    now + pol.scale_out_cooldown_s
                )
        rec = self.log.record(
            "scale_out", self.plane, f"slo_breach:{rule}", rule=rule,
            replicas_before=before,
            replicas_after=int(self.actuator.replicas()),
            outcome=outcome,
            t0=t0, dur_s=dur,
            **{k: v for k, v in result.items() if k != "outcome"},
        )
        with self._lock:
            self.last_action, self.last_rule = "scale_out", rule
        return rec

    def _maybe_scale_in(self, ok_streak: int, now: float) -> dict | None:
        pol = self.policy
        if ok_streak < pol.scale_in_ok_windows:
            return None
        before = int(self.actuator.replicas())
        if before <= pol.min_replicas:
            return None
        with self._lock:
            if now - self._last_scale_in < pol.scale_in_cooldown_s:
                return None
        depth = float(self.actuator.queue_depth())
        if depth > pol.queue_low_watermark * before:
            return None
        with self._lock:
            self._last_scale_in = now
            self._ok_streak = 0  # re-arm the hysteresis window
        t0 = time.perf_counter()
        result = self.actuator.scale_in(
            reason=f"ok_windows:{ok_streak}"
        )
        dur = time.perf_counter() - t0
        rec = self.log.record(
            "scale_in", self.plane, f"ok_windows:{ok_streak}",
            rule=None, replicas_before=before,
            replicas_after=int(self.actuator.replicas()),
            outcome=str(result.get("outcome", "ok")),
            t0=t0, dur_s=dur,
            **{k: v for k, v in result.items() if k != "outcome"},
        )
        with self._lock:
            self.last_action, self.last_rule = "scale_in", None
        return rec

    # ------------------------------------------------------------ metrics

    def snapshot(self) -> dict:
        """Controller state for the router ``fleet`` /metrics section
        and the trainer's ``elastic/`` columns."""
        counts = self.log.counts()
        with self._lock:
            out = {
                "replicas": int(self.actuator.replicas()),
                "windows_total": self.windows_total,
                "bounded_total": self.bounded_total,
                "ok_streak": self._ok_streak,
                "active_breach_rules": len(self._active_breaches),
                "last_action": self.last_action,
                "last_rule": self.last_rule,
            }
        for action in _ACTIONS:
            out[f"{action}_total"] = counts.get(action, 0)
        out["decisions_total"] = counts["decisions_total"]
        return out
