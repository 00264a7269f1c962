"""Host-side early-warning monitor over the epoch diagnostic stream.

The divergence sentinel (resilience/sentinel.py) is a *lagging*
detector: it fires when the training state already holds a NaN. The
monitor watches the per-epoch diagnostic aggregates for the patterns
that PRECEDE that NaN — a gradient-norm spike, a policy-entropy
collapse, a drifting Q bias — and emits ``early_warning`` telemetry
events plus :meth:`DivergenceSentinel.note_warning` bookkeeping, so an
operator (or an alerting rule over ``telemetry.jsonl``) sees trouble
epochs before the sentinel has to roll anything back.

Detection is a robust deviation rule, not fixed thresholds: each
watched key keeps an EMA of its value and of its absolute deviation
(an online MAD analogue), and a warning fires when the new value
departs from the EMA by more than ``k`` deviations in the configured
direction. This adapts to any env's loss/reward scale — the same rule
works on Pendulum (rewards O(10)) and dm_control (rewards O(1)) — and
a fired value is clipped before it updates the baseline, so one spike
cannot poison the EMA into accepting the next one. Everything is plain
deterministic float arithmetic: unit-testable with scripted sequences
(tests/test_diagnostics.py).

A copy of the JAX package's ``diagnostics/monitor.py``, which imports
no JAX; the port keeps its own so it imports nothing of that package.
"""

from __future__ import annotations

import math
import typing as t

__all__ = ["DEFAULT_RULES", "DriftDetector", "EarlyWarningMonitor"]

# (kind, metric key, direction): `high` fires on upward excursions,
# `low` on downward, `shift` on either. Keys absent from a run's
# metrics (e.g. `entropy` under TD3) simply never arm.
DEFAULT_RULES: t.Tuple[t.Tuple[str, str, str], ...] = (
    ("grad_spike", "diag/grad_norm_q", "high"),
    ("grad_spike", "diag/grad_norm_pi", "high"),
    ("entropy_collapse", "entropy", "low"),
    ("q_bias_drift", "diag/q_bias", "shift"),
    # Decoupled plane (decoupled/): mean per-transition generation lag
    # drifting upward is the leading indicator of a sick actor↔serving
    # link — degraded actors feed ever-staler data until the admission
    # gate starts dropping it. Key absent outside decoupled runs.
    ("actor_lag_drift", "decoupled/actor_lag_mean", "high"),
)


class DriftDetector:
    """One-key robust deviation detector (EMA + EMA-of-|dev|)."""

    def __init__(
        self,
        kind: str,
        key: str,
        direction: str,
        k: float = 6.0,
        warmup: int = 3,
        alpha: float = 0.3,
    ):
        if direction not in ("high", "low", "shift"):
            raise ValueError(f"direction must be high/low/shift, got {direction!r}")
        self.kind = kind
        self.key = key
        self.direction = direction
        self.k = float(k)
        self.warmup = int(warmup)
        self.alpha = float(alpha)
        self.n = 0
        self.ema: float | None = None
        self.dev = 0.0

    def update(self, value: float) -> t.Optional[dict]:
        """Feed one epoch aggregate; returns a warning dict when the
        value breaches the deviation envelope, else None."""
        value = float(value)
        if not math.isfinite(value):
            # Non-finite is the sentinel's jurisdiction; the detector
            # keeps its baseline untouched.
            return None
        self.n += 1
        if self.ema is None:
            self.ema = value
            return None
        # Deviation floor: 5% of the baseline magnitude, so a key that
        # has been perfectly flat (dev ~ 0) still needs a material move
        # to fire, and a zero-baseline key doesn't fire on noise.
        spread = max(self.dev, 0.05 * abs(self.ema) + 1e-6)
        delta = value - self.ema
        fired: t.Optional[dict] = None
        if self.n > self.warmup:
            breach = (
                delta > self.k * spread
                if self.direction == "high"
                else -delta > self.k * spread
                if self.direction == "low"
                else abs(delta) > self.k * spread
            )
            if breach:
                fired = {
                    "kind": self.kind,
                    "key": self.key,
                    "value": value,
                    "baseline": self.ema,
                    "spread": spread,
                }
        # A fired value updates the baseline clipped to the envelope —
        # adapting to a genuine regime change over a few epochs while
        # refusing to swallow a one-epoch spike whole.
        upd = value
        if fired is not None:
            upd = min(max(value, self.ema - 3 * spread), self.ema + 3 * spread)
        self.dev += self.alpha * (abs(upd - self.ema) - self.dev)
        self.ema += self.alpha * (upd - self.ema)
        return fired


class EarlyWarningMonitor:
    """Rule set of :class:`DriftDetector` over the epoch diagnostics."""

    def __init__(
        self,
        rules: t.Sequence[t.Tuple[str, str, str]] = DEFAULT_RULES,
        k: float = 6.0,
        warmup: int = 3,
    ):
        self.detectors = [
            DriftDetector(kind, key, direction, k=k, warmup=warmup)
            for kind, key, direction in rules
        ]
        self.fired_total = 0

    def update(self, metrics: t.Mapping[str, t.Any]) -> t.List[dict]:
        """Feed one epoch's reduced diagnostics; returns the warnings
        that fired this epoch (possibly empty)."""
        out = []
        for d in self.detectors:
            if d.key in metrics:
                w = d.update(float(metrics[d.key]))
                if w is not None:
                    out.append(w)
        self.fired_total += len(out)
        return out
