"""Declarative SLO engine over the aggregated obs series (a copy of the
JAX package's ``obs/slo.py``: the same grammar, error text and default
rules).

Rules (``--slo-config`` JSON or :func:`default_rules`) are evaluated
once per collector scrape window against the composite row the
:class:`~torch_actor_critic_tpu_torch.obs.collector.ObsCollector` assembles
(``learner.*`` / ``fleet.*`` / ``serve.*`` dotted paths). Each rule is
a small hysteresis state machine:

- **arm-on-first-pass**: a rule emits nothing until its path first
  exists AND passes — so a goodput floor does not "breach" while the
  fleet is still warming up, and chip-only rules (MFU floor) stay
  silent on CPU runs (``missing_ok``).
- **hysteresis**: ``breach_windows`` consecutive failing windows flip
  an armed rule to breached (one ``slo_breach`` event);
  ``recover_windows`` consecutive passing windows flip it back (one
  ``slo_recovered``). A flapping signal cannot emit an event storm.
- **delta mode**: cumulative counters (``sheds_total``) are judged on
  their per-window increase, not their lifetime value.

The event stream is the exact interface the elastic controller
(:mod:`~torch_actor_critic_tpu_torch.elastic.controller`) subscribes to; :meth:`SLOEngine.report` is the run-exit table.

Rule grammar (JSON list; docs/OBSERVABILITY.md "Run-wide plane")::

    [{"name": "goodput_floor",
      "path": "serve.requests_per_sec",   # dotted into the obs row
      "op": "min",                         # min: value >= threshold ok
      "threshold": 0.5,                    # max: value <= threshold ok
      "mode": "value",                     # or "delta" (per-window)
      "breach_windows": 2,
      "recover_windows": 2,
      "missing_ok": true}]
"""

from __future__ import annotations

import json
import logging
import time
import typing as t

logger = logging.getLogger(__name__)

__all__ = ["SLOEngine", "SLORule", "default_rules", "load_rules"]

_OPS = ("min", "max")
_MODES = ("value", "delta")


class SLORule:
    """One declarative rule: ``op='min'`` passes while the value stays
    at or above ``threshold`` (a floor), ``op='max'`` while it stays at
    or below (a ceiling). Booleans at the path coerce to 0/1, so an
    invariant like ``conservation_ok`` is ``op='min', threshold=1``."""

    def __init__(
        self,
        name: str,
        path: str,
        op: str,
        threshold: float,
        breach_windows: int = 2,
        recover_windows: int = 2,
        mode: str = "value",
        missing_ok: bool = True,
    ):
        if not name or not path:
            raise ValueError("SLO rule needs a name and a path")
        if op not in _OPS:
            raise ValueError(
                f"SLO rule {name!r}: op must be one of {_OPS}, got {op!r}"
            )
        if mode not in _MODES:
            raise ValueError(
                f"SLO rule {name!r}: mode must be one of {_MODES}, "
                f"got {mode!r}"
            )
        if breach_windows < 1 or recover_windows < 1:
            raise ValueError(
                f"SLO rule {name!r}: breach/recover windows must be "
                f">= 1, got {breach_windows}/{recover_windows}"
            )
        self.name = name
        self.path = path
        self.op = op
        self.threshold = float(threshold)
        self.breach_windows = int(breach_windows)
        self.recover_windows = int(recover_windows)
        self.mode = mode
        self.missing_ok = bool(missing_ok)

    def to_dict(self) -> dict:
        return {
            "name": self.name, "path": self.path, "op": self.op,
            "threshold": self.threshold, "mode": self.mode,
            "breach_windows": self.breach_windows,
            "recover_windows": self.recover_windows,
            "missing_ok": self.missing_ok,
        }

    def passes(self, value: float) -> bool:
        if self.op == "min":
            return value >= self.threshold
        return value <= self.threshold


_RULE_KEYS = frozenset(
    ("name", "path", "op", "threshold", "breach_windows",
     "recover_windows", "mode", "missing_ok")
)

# Appended to every grammar error so a typo'd config tells the operator
# the whole vocabulary, not just what broke.
_GRAMMAR_HINT = (
    f"valid keys: {sorted(_RULE_KEYS)}; comparators (op): "
    f"{list(_OPS)}; modes: {list(_MODES)}"
)


def _rule_label(i: int, spec: t.Any) -> str:
    """Name the offending rule in errors: its 'name' when it has one,
    its position otherwise."""
    name = spec.get("name") if isinstance(spec, dict) else None
    return f"rule {i} ({name!r})" if name else f"rule {i}"


def load_rules(path: str) -> t.List[SLORule]:
    """Parse an ``--slo-config`` JSON file. Grammar errors are
    ``ValueError`` at startup — a malformed SLO config should fail the
    run before it silently monitors nothing — and every one names the
    offending rule and lists the valid keys/comparators."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"cannot load SLO config {path}: {e}") from e
    if not isinstance(raw, list):
        raise ValueError(
            f"SLO config {path}: expected a JSON list of rules, got "
            f"{type(raw).__name__}"
        )
    rules = []
    for i, spec in enumerate(raw):
        label = _rule_label(i, spec)
        if not isinstance(spec, dict):
            raise ValueError(
                f"SLO config {path}: {label} is not an object; "
                f"{_GRAMMAR_HINT}"
            )
        unknown = set(spec) - _RULE_KEYS
        if unknown:
            raise ValueError(
                f"SLO config {path}: {label} has unknown keys "
                f"{sorted(unknown)}; {_GRAMMAR_HINT}"
            )
        missing = [k for k in ("name", "path") if not spec.get(k)]
        if "threshold" not in spec:
            missing.append("threshold")
        if missing:
            raise ValueError(
                f"SLO config {path}: {label} is missing "
                f"{', '.join(repr(k) for k in missing)}; "
                f"{_GRAMMAR_HINT}"
            )
        try:
            rules.append(SLORule(**spec))
        except ValueError as e:
            raise ValueError(
                f"SLO config {path}: {label}: {e}; {_GRAMMAR_HINT}"
            ) from e
        except TypeError as e:
            # Wrong-typed values (a dict threshold, a list for an int
            # field): float()/int() raise TypeError — surface it as
            # the same startup ValueError the rest of the grammar uses.
            raise ValueError(
                f"SLO config {path}: {label} has a wrong-typed value "
                f"({e}); {_GRAMMAR_HINT}"
            ) from e
    names = [r.name for r in rules]
    dupes = sorted({n for n in names if names.count(n) > 1})
    if dupes:
        raise ValueError(
            f"SLO config {path}: duplicate rule names {dupes}"
        )
    return rules


def default_rules() -> t.List[SLORule]:
    """Built-in rule set over the collector's canonical source names
    (``learner``/``fleet``/``serve``). Every rule is ``missing_ok`` and
    arm-on-first-pass, so each engages only when its plane actually
    reports — the MFU floor stays silent on CPU runs, the serving rules
    on serve-less runs."""
    return [
        # Training goodput: post-warmup env throughput must not collapse.
        SLORule("goodput_floor", "learner.metrics.env_steps_per_sec",
                "min", 1.0),
        # Serving tail latency ceiling (fleet-merged histogram).
        SLORule("p99_ceiling", "serve.p99_ms", "max", 500.0),
        # Shed RATE ceiling: per-window increase of the cumulative
        # counter — a burst of load shedding, not lifetime totals.
        SLORule("shed_rate_ceiling", "serve.sheds_total", "max", 500.0,
                mode="delta"),
        # Actor staleness: the staging gate's lag tail (epochs behind).
        SLORule("actor_staleness_ceiling",
                "learner.decoupled.staging.actor_lag.actor_lag_p95",
                "max", 16.0),
        # Cross-process conservation invariant (transport /healthz).
        SLORule("conservation_ok", "fleet.healthz.conservation_ok",
                "min", 1.0, breach_windows=1),
        # Chip-run MFU floor; the path only exists when cost
        # attribution reports (telemetry on, real device peaks).
        SLORule("mfu_floor", "learner.metrics.cost/epoch_mfu",
                "min", 0.05),
    ]


def dig(row: t.Mapping[str, t.Any], path: str) -> t.Optional[float]:
    """Resolve a dotted path to a numeric leaf (bools coerce to 0/1);
    None when the path is absent or non-numeric."""
    node: t.Any = row
    for part in path.split("."):
        if not isinstance(node, t.Mapping) or part not in node:
            return None
        node = node[part]
    if isinstance(node, bool):
        return float(node)
    if isinstance(node, (int, float)):
        return float(node)
    return None


class _RuleState:
    __slots__ = (
        "armed", "breached", "ok_streak", "bad_streak", "breaches",
        "recoveries", "last_value", "prev_raw", "worst",
    )

    def __init__(self):
        self.armed = False
        self.breached = False
        self.ok_streak = 0
        self.bad_streak = 0
        self.breaches = 0
        self.recoveries = 0
        self.last_value: float | None = None
        self.prev_raw: float | None = None  # delta-mode memory
        self.worst: float | None = None


class SLOEngine:
    """Evaluate a rule set once per scrape window; emit exactly one
    structured event per state transition. Single-threaded by design:
    only the collector's scrape thread calls :meth:`observe`."""

    def __init__(
        self,
        rules: t.Sequence[SLORule],
        clock: t.Callable[[], float] = time.time,
    ):
        self.rules = list(rules)
        self._clock = clock
        self._state = {r.name: _RuleState() for r in self.rules}
        self.windows_evaluated = 0

    def observe(self, row: t.Mapping[str, t.Any]) -> t.List[dict]:
        """One scrape window: returns the (possibly empty) list of
        ``slo_breach``/``slo_recovered`` events this window caused."""
        self.windows_evaluated += 1
        events: t.List[dict] = []
        now = self._clock()
        for rule in self.rules:
            st = self._state[rule.name]
            raw = dig(row, rule.path)
            if raw is None:
                # Absent path: no verdict this window (missing_ok), or
                # a hard failing window when the rule demands the path.
                if rule.missing_ok or not st.armed:
                    continue
                value = None
            elif rule.mode == "delta":
                prev, st.prev_raw = st.prev_raw, raw
                if prev is None:
                    continue  # first sample: no window delta yet
                value = raw - prev
            else:
                value = raw
            ok = value is not None and rule.passes(value)
            st.last_value = value
            if value is not None:
                worse = (
                    st.worst is None
                    or (rule.op == "min" and value < st.worst)
                    or (rule.op == "max" and value > st.worst)
                )
                if worse:
                    st.worst = value
            if not st.armed:
                if ok:
                    st.armed = True
                    st.ok_streak = 1
                continue
            if st.breached:
                if ok:
                    st.ok_streak += 1
                    if st.ok_streak >= rule.recover_windows:
                        st.breached = False
                        st.bad_streak = 0
                        st.recoveries += 1
                        events.append(self._event(
                            "slo_recovered", rule, value, now
                        ))
                else:
                    st.ok_streak = 0
            else:
                if ok:
                    st.bad_streak = 0
                else:
                    st.bad_streak += 1
                    st.ok_streak = 0
                    if st.bad_streak >= rule.breach_windows:
                        st.breached = True
                        st.breaches += 1
                        events.append(self._event(
                            "slo_breach", rule, value, now
                        ))
        return events

    def _event(self, type_, rule, value, now) -> dict:
        ev = {
            "type": type_,
            "time": now,
            "rule": rule.name,
            "path": rule.path,
            "op": rule.op,
            "mode": rule.mode,
            "threshold": rule.threshold,
            "value": value,
            "window": self.windows_evaluated,
        }
        log = logger.warning if type_ == "slo_breach" else logger.info
        log(
            "SLO %s: %s (%s %s %g, observed %s)",
            "BREACH" if type_ == "slo_breach" else "recovered",
            rule.name, rule.path,
            ">=" if rule.op == "min" else "<=",
            rule.threshold, value,
        )
        return ev

    # ------------------------------------------------------------- reports

    def snapshot(self) -> dict:
        """``/metrics``-style summary: per-rule state + run totals."""
        rules = {}
        for rule in self.rules:
            st = self._state[rule.name]
            rules[rule.name] = {
                "path": rule.path,
                "op": rule.op,
                "threshold": rule.threshold,
                "armed": st.armed,
                "breached": st.breached,
                "breaches_total": st.breaches,
                "recoveries_total": st.recoveries,
                "last_value": st.last_value,
            }
        return {
            "windows_evaluated": self.windows_evaluated,
            "breaches_total": sum(
                s.breaches for s in self._state.values()
            ),
            "active_breaches": sum(
                1 for s in self._state.values() if s.breached
            ),
            "rules": rules,
        }

    def report(self) -> str:
        """Run-exit SLO table (logged by the trainer's close)."""
        header = (
            f"{'rule':<26} {'state':<10} {'breaches':>8} "
            f"{'recovered':>9} {'worst':>12} {'threshold':>10}"
        )
        lines = [
            f"SLO report ({self.windows_evaluated} windows):", header,
            "-" * len(header),
        ]
        for rule in self.rules:
            st = self._state[rule.name]
            state = (
                "BREACHED" if st.breached
                else "ok" if st.armed else "unarmed"
            )
            worst = "-" if st.worst is None else f"{st.worst:.4g}"
            lines.append(
                f"{rule.name:<26} {state:<10} {st.breaches:>8} "
                f"{st.recoveries:>9} {worst:>12} {rule.threshold:>10g}"
            )
        return "\n".join(lines)
