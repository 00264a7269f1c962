"""Phase span/counter recorder for the training hot loop (port of
``telemetry/recorder.py``).

Design constraints (the JAX package's, kept):

- **Zero code when disabled.** The Trainer stores ``telemetry=None``
  and every instrumentation point is ``if rec is not None: rec.lap(i)``
  over a loop-local — one always-false predicted branch per phase mark,
  no calls, no allocation, no events. Disabled-mode metrics are
  byte-identical to an uninstrumented build (pinned by
  tests/test_telemetry.py).
- **No host<->device syncs when enabled.** Every measurement is a
  ``time.perf_counter()`` read; nothing here fetches a device value or
  synchronizes a stream, so ``burst_dispatch`` measures exactly what it
  says — the host's enqueue of the burst — and the queued device work
  surfaces later under ``drain``. Reading allocator watermarks
  (:mod:`memory`) is likewise a host-side query.
- **No per-step allocation when enabled.** Laps accumulate into
  preallocated per-phase lists and a preallocated :class:`SpanRing`
  (fixed numpy arrays, wrapping cursor). Events (which do allocate)
  are emitted once per epoch, off the step path.

The lap model: phases *partition* the instrumented region. ``lap(i)``
charges everything since the previous lap (or :meth:`mark`) to phase
``i``, so the per-epoch phase sums add up to ~the epoch wall time and
the breakdown answers "where did the time go" without leaving gaps.
Named spans for a device trace (:meth:`TelemetryRecorder.annotate`) are
``torch.profiler.record_function`` ranges.
"""

from __future__ import annotations

import logging
import time
import typing as t

import numpy as np

from torch_actor_critic_tpu_torch.telemetry.costmodel import (
    PHASE_PLANES,
    classify_epoch,
)
from torch_actor_critic_tpu_torch.telemetry.memory import (
    device_memory_watermarks,
    reset_peak_watermarks,
)
from torch_actor_critic_tpu_torch.telemetry.profiler import ProfilerWindow
from torch_actor_critic_tpu_torch.telemetry.sinks import JsonlSink, format_summary

logger = logging.getLogger(__name__)

__all__ = ["PHASES", "PhaseTimer", "SpanRing", "TelemetryRecorder"]

# The Trainer step taxonomy (docs/OBSERVABILITY.md): indices
# are the lap() argument — integer phase ids keep the hot path free of
# dict lookups.
PHASES: t.Tuple[str, ...] = (
    "act",            # policy forward (and its action's copy to the host)
    "env_step",       # pool.step + normalize + episode bookkeeping
    "stage",          # staging-list -> chunk stacking
    "place_chunk",    # host->device copy of the chunk
    "burst_dispatch", # the host's enqueue of push/update_burst
    "drain",          # the epoch's wait for the device (true burst cost)
    "sentinel",       # divergence check (+ rollback when it fires)
    "checkpoint",     # the checkpoint save's host part
)
SCHEMA_VERSION = 1
# The phases' indices, for ``lap``.
(PH_ACT, PH_ENV, PH_STAGE, PH_PLACE, PH_BURST, PH_DRAIN, PH_SENTINEL,
 PH_CKPT) = range(len(PHASES))


class PhaseTimer:
    """Monotonic lap timer over a fixed phase set.

    ``lap(i)`` charges ``now - last_mark`` to phase ``i`` and advances
    the mark; ``mark()`` advances it without charging (used at region
    entry). Plain Python float/list arithmetic: ~0.5us per lap, no
    allocation beyond float boxing.
    """

    __slots__ = ("n", "sums", "counts", "maxs", "_t_mark", "_clock")

    def __init__(self, n_phases: int, clock: t.Callable[[], float] = time.perf_counter):
        self.n = n_phases
        self._clock = clock
        self.sums = [0.0] * n_phases
        self.counts = [0] * n_phases
        self.maxs = [0.0] * n_phases
        self._t_mark = clock()

    def mark(self) -> float:
        self._t_mark = t0 = self._clock()
        return t0

    def lap(self, phase: int) -> float:
        now = self._clock()
        dt = now - self._t_mark
        self._t_mark = now
        self.sums[phase] += dt
        self.counts[phase] += 1
        if dt > self.maxs[phase]:
            self.maxs[phase] = dt
        return dt

    def reset(self) -> None:
        for i in range(self.n):
            self.sums[i] = 0.0
            self.counts[i] = 0
            self.maxs[i] = 0.0
        self._t_mark = self._clock()

    def stats(self, names: t.Sequence[str]) -> dict:
        return {
            names[i]: {
                "total_s": self.sums[i],
                "count": self.counts[i],
                "max_s": self.maxs[i],
            }
            for i in range(self.n)
            if self.counts[i]
        }


class SpanRing:
    """Preallocated ring of the most recent spans.

    Three fixed numpy arrays (phase id, start time, duration) and a
    wrapping cursor: recording is three scalar stores, reading
    (:meth:`spans`) materializes only on demand. This is the drill-down
    companion to the per-epoch aggregates — "which individual step
    stalled" — without ever growing.
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._phase = np.zeros(capacity, np.int16)
        self._t0 = np.zeros(capacity, np.float64)
        self._dur = np.zeros(capacity, np.float64)
        self._cursor = 0
        self.total = 0

    def record(self, phase: int, t0: float, dur: float) -> None:
        i = self._cursor
        self._phase[i] = phase
        self._t0[i] = t0
        self._dur[i] = dur
        self._cursor = (i + 1) % self.capacity
        self.total += 1

    def spans(self) -> t.List[t.Tuple[int, float, float]]:
        """Retained spans, oldest first."""
        n = min(self.total, self.capacity)
        if n < self.capacity:
            idx = range(n)
        else:
            idx = [(self._cursor + k) % self.capacity for k in range(n)]
        return [
            (int(self._phase[i]), float(self._t0[i]), float(self._dur[i]))
            for i in idx
        ]


class TelemetryRecorder:
    """The Trainer-facing facade: phase timer + span ring + counters +
    device memory watermarks + profiler window + JSONL sink.

    ``run_dir=None`` keeps everything in memory (non-coordinator hosts,
    unit tests); otherwise events stream to ``<run_dir>/telemetry.jsonl``
    and the ``--profile-epochs`` trace to ``<run_dir>/trace`` (the card
    traced too when ``device`` is a CUDA device). With ``trace_export``,
    :meth:`close` writes the Perfetto timeline there: this recorder's
    phase spans and the watchdog's captures and builds. A trainer builds
    its recorder with :meth:`for_run`.
    """

    def __init__(
        self,
        run_dir: t.Any | None = None,
        phases: t.Sequence[str] = PHASES,
        ring_capacity: int = 4096,
        profile_epochs: t.Optional[t.Tuple[int, int]] = None,
        clock: t.Callable[[], float] = time.perf_counter,
        sink_max_bytes: int = 0,
        device=None,
        trace_export: str | None = None,
    ):
        self.phases = tuple(phases)
        self.trace_export = trace_export
        # Events from other planes (a trainer's extra_trace_events), merged
        # into the exported timeline.
        self.extra_events: t.List[dict] = []
        self._clock = clock
        self.timer = PhaseTimer(len(self.phases), clock)
        self.ring = SpanRing(ring_capacity)
        self.counters: t.Dict[str, float] = {}
        self.epochs_recorded = 0
        # Run-level accumulation (summary()/snapshot() aggregate the
        # whole run even though the timer resets per epoch).
        self._run_sums = [0.0] * len(self.phases)
        self._run_counts = [0] * len(self.phases)
        self._run_maxs = [0.0] * len(self.phases)
        self._t_epoch: float | None = None
        self.last_memory: dict | None = None
        # Host/device/input epoch attribution (costmodel.classify_epoch)
        # — rolling counts per class plus frac sums, surfaced by
        # summary() and carried on every epoch event.
        self.last_attribution: dict | None = None
        self._attr_counts: t.Dict[str, int] = {}
        self._attr_frac_sums = {"device": 0.0, "host": 0.0, "input": 0.0}

        self.sink = (
            JsonlSink(
                str(run_dir) + "/telemetry.jsonl",
                max_bytes=sink_max_bytes,
            )
            if run_dir is not None else None
        )
        self.profiler = ProfilerWindow(
            profile_epochs,
            (str(run_dir) + "/trace") if run_dir is not None else None,
            device,
        )
        if self.sink is not None:
            self.sink.write({
                "type": "run_start",
                "schema": SCHEMA_VERSION,
                "time": time.time(),
                "phases": list(self.phases),
                "profile_epochs": (
                    list(profile_epochs) if profile_epochs else None
                ),
            })

    @classmethod
    def for_run(
        cls,
        config,
        tracker=None,
        profile_epochs: t.Optional[t.Tuple[int, int]] = None,
        trace_export: str | None = None,
        device=None,
    ) -> "TelemetryRecorder | None":
        """A run's recorder, when ``config.telemetry``, a profile window
        or a trace export asks for one (else ``None``): under the
        tracker's run directory when it logs, rotating at
        ``config.telemetry_max_mb``, tracing ``device``. A trace export
        installs the watchdog, whose captures and builds make the
        timeline's compile lane."""
        if not (config.telemetry or profile_epochs or trace_export):
            return None
        if trace_export:
            from torch_actor_critic_tpu_torch.diagnostics.watchdog import get_watchdog

            get_watchdog().install()
        return cls(
            run_dir=tracker.run_dir if tracker is not None and tracker.enabled else None,
            profile_epochs=profile_epochs,
            sink_max_bytes=int(config.telemetry_max_mb * 1e6),
            device=device, trace_export=trace_export,
        )

    # -------------------------------------------------- hot-path recording

    def mark(self) -> None:
        """Advance the lap mark without charging a phase (region entry)."""
        self.timer.mark()

    def lap(self, phase: int) -> None:
        """Charge time since the previous lap/mark to ``phase``.

        Inlined timer + ring update (same-module peers): this runs up
        to a few times per Trainer step, and the flattened body saves
        two method dispatches over ``timer.lap`` + ``ring.record``.
        """
        timer = self.timer
        now = timer._clock()
        t0 = timer._t_mark
        dt = now - t0
        timer._t_mark = now
        timer.sums[phase] += dt
        timer.counts[phase] += 1
        if dt > timer.maxs[phase]:
            timer.maxs[phase] = dt
        ring = self.ring
        i = ring._cursor
        ring._phase[i] = phase
        ring._t0[i] = t0
        ring._dur[i] = dt
        ring._cursor = (i + 1) % ring.capacity
        ring.total += 1

    def inc(self, name: str, value: float = 1.0) -> None:
        """Bump a named counter (epoch-granularity: not for the step
        path — counters allocate on first use)."""
        self.counters[name] = self.counters.get(name, 0.0) + value

    def annotate(self, name: str):
        """Named ``torch.profiler.record_function`` range — a labeled
        span in a captured trace; near-free when no trace is active."""
        import torch

        return torch.profiler.record_function(name)

    # ------------------------------------------------------ epoch boundary

    def epoch_begin(self, epoch: int) -> None:
        reset_peak_watermarks()
        self.profiler.epoch_begin(epoch)
        self._t_epoch = self.timer.mark()

    def epoch_end(self, epoch: int, extra: t.Mapping[str, t.Any] | None = None) -> dict:
        """Fold the epoch's laps into the run totals, sample the device
        memory watermarks (the epoch's peaks), emit the epoch event, stop an expiring profiler
        window, and reset the epoch timer. Returns the event dict."""
        now = self._clock()
        wall_s = now - self._t_epoch if self._t_epoch is not None else 0.0
        phases = self.timer.stats(self.phases)
        for i in range(len(self.phases)):
            self._run_sums[i] += self.timer.sums[i]
            self._run_counts[i] += self.timer.counts[i]
            if self.timer.maxs[i] > self._run_maxs[i]:
                self._run_maxs[i] = self.timer.maxs[i]
        self.last_memory = device_memory_watermarks()
        self.epochs_recorded += 1
        event: dict = {
            "type": "epoch",
            "epoch": int(epoch),
            "time": time.time(),
            "wall_s": round(wall_s, 6),
            "phases": {
                k: {
                    "total_s": round(v["total_s"], 6),
                    "count": v["count"],
                    "max_s": round(v["max_s"], 6),
                }
                for k, v in phases.items()
            },
        }
        # Host/device/input attribution rides the epoch event whenever
        # the phase taxonomy is the Trainer's (custom phase sets skip
        # it rather than misclassify).
        if wall_s > 0 and any(p in PHASE_PLANES for p in phases):
            attr = classify_epoch(phases, wall_s)
            event["attribution"] = attr
            self.last_attribution = attr
            self._attr_counts[attr["class"]] = (
                self._attr_counts.get(attr["class"], 0) + 1
            )
            self._attr_frac_sums["device"] += attr["device_busy_frac"]
            self._attr_frac_sums["host"] += attr["host_frac"]
            self._attr_frac_sums["input"] += attr["input_frac"]
        if extra:
            event.update({k: v for k, v in extra.items()})
        if self.counters:
            event["counters"] = dict(self.counters)
        if self.last_memory is not None:
            event["memory"] = self.last_memory
        if self.sink is not None:
            self.sink.write(event)
        self.profiler.epoch_end(epoch)
        self.timer.reset()
        return event

    def event(self, type_: str, **fields) -> None:
        """Emit an ad-hoc event (rollbacks, preemption, reloads)."""
        if self.sink is not None:
            self.sink.write({"type": type_, "time": time.time(), **fields})

    # ------------------------------------------------------------- reports

    def run_stats(self) -> dict:
        return {
            self.phases[i]: {
                "total_s": self._run_sums[i],
                "count": self._run_counts[i],
                "max_s": self._run_maxs[i],
            }
            for i in range(len(self.phases))
            if self._run_counts[i]
        }

    def snapshot(self) -> dict:
        """``/metrics``-style dict (the serving plane merges this under
        a ``training`` key — one schema across both planes)."""
        phases = {}
        for name, p in self.run_stats().items():
            phases[name] = {
                "total_s": round(p["total_s"], 6),
                "count": p["count"],
                "mean_ms": round(1e3 * p["total_s"] / p["count"], 3),
                "max_ms": round(1e3 * p["max_s"], 3),
            }
        out: dict = {
            "epochs_total": self.epochs_recorded,
            "spans_total": self.ring.total,
            "phases": phases,
        }
        if self.counters:
            out["counters"] = dict(self.counters)
        if self.last_memory is not None:
            out["memory"] = self.last_memory
        if self.sink is not None:
            out["events_written"] = self.sink.events_written
            if self.sink.rotations:
                out["sink_rotations_total"] = self.sink.rotations
        return out

    def attribution_summary(self) -> dict | None:
        """Rolling host/device/input attribution over the recorded
        epochs: per-class epoch counts and mean plane fractions, or
        None before the first attributed epoch."""
        n = sum(self._attr_counts.values())
        if not n:
            return None
        return {
            "epochs": n,
            "by_class": dict(self._attr_counts),
            "mean_device_busy_frac": round(
                self._attr_frac_sums["device"] / n, 4
            ),
            "mean_host_frac": round(self._attr_frac_sums["host"] / n, 4),
            "mean_input_frac": round(self._attr_frac_sums["input"] / n, 4),
        }

    def summary(self) -> str:
        """Human phase-breakdown table over the whole run, plus the
        rolling host/device/input attribution when recorded."""
        out = format_summary(self.run_stats(), self.counters)
        attr = self.attribution_summary()
        if attr is not None:
            classes = ", ".join(
                f"{k} x{v}" for k, v in sorted(attr["by_class"].items())
            )
            out += (
                f"\nepoch attribution: {classes} | mean fracs: device "
                f"{attr['mean_device_busy_frac']:.0%}, host "
                f"{attr['mean_host_frac']:.0%}, input "
                f"{attr['mean_input_frac']:.0%}"
            )
        return out

    def close(self) -> None:
        """Stop a trace left open, write the timeline of
        ``trace_export`` and close the sink."""
        self.profiler.close()
        if self.trace_export is not None:
            self._export_timeline(self.trace_export)
            self.trace_export = None
        if self.sink is not None:
            self.sink.close()

    def _export_timeline(self, path: str) -> dict:
        from torch_actor_critic_tpu_torch.diagnostics.watchdog import get_watchdog
        from torch_actor_critic_tpu_torch.telemetry.traceview import (
            compile_events,
            export_trace,
            training_events,
        )

        summary = export_trace(path, training_events(self),
                               compile_events(get_watchdog().compile_log()), self.extra_events)
        logger.info("trace exported to %s (%d train / %d compile spans) — load at "
                    "chrome://tracing or https://ui.perfetto.dev", summary["path"],
                    summary["train_spans"], summary["compile_spans"])
        return summary
