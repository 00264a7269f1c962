"""Cross-plane Perfetto (chrome://tracing) trace export.

A copy of the JAX package's ``telemetry/traceview.py``, which imports
no JAX. The port's serving CLI writes request spans and router hops
with it (``--trace-export``); the train CLI's ``--trace-export`` writes
the training lane from the recorder's span ring (:func:`training_events`)
and the compile lane from the watchdog's log (:func:`compile_events`:
the port's CUDA-graph captures and kernel builds, where JAX's are XLA
compiles).

The phase aggregates answer "where did the epoch go"; this module
answers "show me" — one ``trace_event``-format JSON timeline merging:

- **training phase spans** from the recorder's :class:`SpanRing`
  (every individual ``act``/``env_step``/``burst_dispatch``/... lap,
  not the per-epoch sums);
- **serving per-request spans** from a :class:`RequestSpanLog` the
  micro-batcher fills when one is attached: queue → collect →
  forward → respond per request, under its ``X-Request-Id``, so a
  slow (or shed) response can be correlated with exactly what the
  dispatcher and engine were doing;
- **compile events** from the watchdog's bounded ring (the port's
  CUDA-graph captures and kernel builds) — a stall sits ON the same
  timeline as the step or request that paid it.

Load the output at ``chrome://tracing`` or https://ui.perfetto.dev.
``--trace-export PATH`` on the train and serving CLIs writes it at exit.

Timestamps: span sources use ``time.perf_counter`` (monotonic), the
watchdog uses ``time.time``; both are mapped onto the wall clock via
one process-wide anchor captured at first use, so all planes of one
process share a timeline. Merging traces from *different* processes
is subject to their wall-clock skew — fine for eyeballs, not for
sub-millisecond cross-process ordering.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
import typing as t

logger = logging.getLogger(__name__)

__all__ = [
    "RequestSpanLog",
    "compile_events",
    "elastic_decision_events",
    "export_trace",
    "router_hop_events",
    "serve_request_events",
    "span_event",
    "staging_span_events",
    "training_events",
]

# trace_event pids: one fake "process" lane per plane. Actor
# subprocesses get dynamic pids ACTOR_PID_BASE + actor_id, so a fleet
# run's merged timeline shows each actor as its own process lane.
TRAIN_PID = 1
SERVE_PID = 2
XLA_PID = 3
ROUTER_PID = 4
TRANSPORT_PID = 5
ELASTIC_PID = 6
ACTOR_PID_BASE = 100

_ANCHOR: t.Tuple[float, float] | None = None
_ANCHOR_LOCK = threading.Lock()


def _anchor() -> t.Tuple[float, float]:
    """(wall_time, perf_counter) captured once per process — the
    affine map between the monotonic span clocks and the wall clock."""
    global _ANCHOR
    with _ANCHOR_LOCK:
        if _ANCHOR is None:
            _ANCHOR = (time.time(), time.perf_counter())
        return _ANCHOR


def perf_to_us(t_perf: float) -> float:
    """Monotonic (perf_counter) seconds -> wall-clock microseconds."""
    wall0, perf0 = _anchor()
    return (wall0 + (t_perf - perf0)) * 1e6


def span_event(
    name: str,
    ts_us: float,
    dur_us: float,
    pid: int,
    tid: int,
    args: dict | None = None,
) -> t.List[dict]:
    """One span as a paired B/E event couple (Perfetto renders pairs
    and complete events identically; pairs survive naive line-oriented
    tooling better and are what tests pin). Zero-length spans get a
    0.5us floor so the E never sorts ahead of its own B (export_trace
    orders E-before-B at equal timestamps)."""
    begin = {"name": name, "ph": "B", "ts": ts_us, "pid": pid, "tid": tid}
    if args:
        begin["args"] = args
    end = {
        "name": name, "ph": "E", "ts": ts_us + max(dur_us, 0.5),
        "pid": pid, "tid": tid,
    }
    return [begin, end]


def training_events(recorder) -> t.List[dict]:
    """The recorder's span ring as trace events: every retained
    individual phase lap, labeled with its phase name, on the train
    pid (one tid — the host loop is single-threaded)."""
    events: t.List[dict] = []
    phases = recorder.phases
    for phase, t0, dur in recorder.ring.spans():
        name = phases[phase] if 0 <= phase < len(phases) else f"phase{phase}"
        events.extend(span_event(
            name, perf_to_us(t0), dur * 1e6, TRAIN_PID, 0
        ))
    return events


class RequestSpanLog:
    """Bounded per-request span recording for the serving plane.

    The batcher stamps each request's lifecycle (submit → collect →
    forward → done, or a shed/expiry outcome) into one dict per
    request; memory is bounded (``capacity`` newest records survive).
    Recording is a deque append under a lock — the serving hot path
    pays it only when a log is attached (``--trace-export``); with
    none attached the batcher's pointer check is the whole cost,
    the same contract as ``telemetry=None``."""

    def __init__(self, capacity: int = 2048):
        self._records: collections.deque = (  # guarded-by: _lock
            collections.deque(maxlen=capacity)
        )
        self._lock = threading.Lock()

    def record(self, rec: dict) -> None:
        with self._lock:
            self._records.append(rec)

    def records(self) -> t.List[dict]:
        with self._lock:
            return list(self._records)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


# Per-request stage boundaries -> child span (name, start key, end key).
_REQUEST_STAGES = (
    ("queue", "t_enq", "t_collect"),
    ("collect", "t_collect", "t_dispatch"),
    ("forward", "t_dispatch", "t_forward_end"),
    ("respond", "t_forward_end", "t_done"),
)


def serve_request_events(records: t.Iterable[dict]) -> t.List[dict]:
    """Request-span records -> trace events: one enclosing ``request``
    span per record plus its stage children, on a per-request tid so
    concurrent requests render as parallel lanes. Shed/expired
    requests (no dispatch timestamps) still produce their enclosing
    span with the outcome in ``args`` — the 429/503 IS on the
    timeline."""
    events: t.List[dict] = []
    for i, rec in enumerate(records):
        t0 = rec.get("t_enq")
        t_end = rec.get("t_done")
        if t0 is None:
            continue
        if t_end is None:
            # Shed before completion: close the span at the last known
            # timestamp so the trace stays well-formed.
            t_end = max(
                (rec[k] for _, _, k in _REQUEST_STAGES if rec.get(k)),
                default=t0,
            )
        tid = i % 64  # bounded lanes; B/E pairs on one lane may nest
        args = {
            k: rec[k]
            for k in ("request_id", "slot", "rows", "bucket", "outcome",
                      "generation")
            if rec.get(k) is not None
        }
        # The enclosing span opens 1us early and closes 1us late so its
        # children nest STRICTLY inside it — shared boundary timestamps
        # would otherwise interleave the B/E pairs under the export's
        # E-before-B tie ordering.
        events.extend(span_event(
            "request", perf_to_us(t0) - 1.0, (t_end - t0) * 1e6 + 2.0,
            SERVE_PID, tid, args=args,
        ))
        for name, k0, k1 in _REQUEST_STAGES:
            s0, s1 = rec.get(k0), rec.get(k1)
            if s0 is None or s1 is None:
                continue
            events.extend(span_event(
                name, perf_to_us(s0), (s1 - s0) * 1e6, SERVE_PID, tid,
            ))
    return events


def router_hop_events(records: t.Iterable[dict]) -> t.List[dict]:
    """Fleet-router hop records -> trace events on the router pid.

    Each record is one proxy attempt the router's span log captured:
    ``{request_id, worker, t_route, t_done, outcome}``. The span is
    named ``hop <worker>`` and carries the base ``X-Request-Id`` in
    ``args`` — the same id the worker saw hop-tagged
    (``<rid>><worker>``), so the router hop, the worker's ``request``
    span and the engine forward stitch into one request's timeline
    when the exports are merged (docs/SERVING.md "Fleet"). Wall-clock
    skew between the router and worker *processes* bounds the stitch
    accuracy, as for every cross-process merge (module docstring)."""
    events: t.List[dict] = []
    for i, rec in enumerate(records):
        t0 = rec.get("t_route")
        t1 = rec.get("t_done")
        if t0 is None or t1 is None:
            continue
        args = {
            k: rec[k]
            for k in ("request_id", "worker", "outcome")
            if rec.get(k) is not None
        }
        events.extend(span_event(
            f"hop {rec.get('worker', '?')}", perf_to_us(t0),
            (t1 - t0) * 1e6, ROUTER_PID, i % 64, args=args,
        ))
    return events


def staging_span_events(
    records: t.Iterable[dict], pid: int
) -> t.List[dict]:
    """Staging-plane span records -> trace events on ``pid``.

    Accepts the records all three staging planes produce (trace
    stitching, docs/OBSERVABILITY.md "Run-wide plane"): each has a
    ``name`` plus either absolute microsecond timestamps
    (``ts_us``/``dur_us`` — actor processes anchor their own wall
    clock before writing, so their files merge without this process's
    anchor) or perf-clock bounds (``t0``/``t1`` — the transport's
    ingest spans and the learner's drain windows, mapped through this
    process's anchor). Stitch ids ride in ``args``: an actor push and
    the transport ingest carry the same ``span_id``
    (``a<actor>.<incarnation>.<seq>``); a learner ``drain_window``
    carries the ``span_ids`` it consumed."""
    events: t.List[dict] = []
    for i, rec in enumerate(records):
        name = rec.get("name")
        if not name:
            continue
        if rec.get("ts_us") is not None:
            ts_us = float(rec["ts_us"])
            dur_us = float(rec.get("dur_us", 0.0))
        elif rec.get("t0") is not None and rec.get("t1") is not None:
            ts_us = perf_to_us(float(rec["t0"]))
            dur_us = (float(rec["t1"]) - float(rec["t0"])) * 1e6
        else:
            continue
        args = {
            k: rec[k]
            for k in ("span_id", "span_ids", "actor_id", "incarnation",
                      "seq", "entries", "outcome", "os_pid")
            if rec.get(k) is not None
        }
        events.extend(span_event(
            str(name), ts_us, dur_us, pid, i % 64, args=args or None,
        ))
    return events


def elastic_decision_events(
    records: t.Iterable[dict], pid: int = ELASTIC_PID
) -> t.List[dict]:
    """Elastic :class:`~torch_actor_critic_tpu_torch.elastic.controller.
    DecisionLog` records -> trace events on the elastic lane.

    Each decision (``scale_out``/``scale_in``/``degrade``/``readmit``)
    renders as one span named ``elastic <action>`` whose args carry
    the schema fields (rule, reason, replicas before/after, outcome),
    so a spawn sits on the same timeline as the breach that caused it
    and the drain that later reversed it. Serving decisions land on
    tid 0, training decisions on tid 1 — two sub-lanes of one elastic
    process lane."""
    events: t.List[dict] = []
    for rec in records:
        t0 = rec.get("t0")
        if t0 is None:
            continue
        args = {
            k: rec[k]
            for k in ("seq", "plane", "action", "reason", "rule",
                      "replicas_before", "replicas_after", "outcome",
                      "worker", "actor_id", "epoch")
            if rec.get(k) is not None
        }
        events.extend(span_event(
            f"elastic {rec.get('action', '?')}", perf_to_us(float(t0)),
            float(rec.get("dur_s", 0.0)) * 1e6, pid,
            1 if rec.get("plane") == "train" else 0, args=args,
        ))
    return events


def compile_events(records: t.Iterable[dict]) -> t.List[dict]:
    """Watchdog compile records (``{source, time, duration_s}``, wall
    clock) -> trace events on the XLA pid. The monitoring event fires
    when the compile FINISHES, so the span runs [time - duration,
    time]."""
    events: t.List[dict] = []
    for rec in records:
        end_wall = float(rec.get("time", 0.0))
        dur = float(rec.get("duration_s", 0.0))
        if end_wall <= 0:
            continue
        events.extend(span_event(
            f"compile {rec.get('source', 'unattributed')}",
            (end_wall - dur) * 1e6, dur * 1e6, XLA_PID, 0,
        ))
    return events


def _metadata_events(extra_pids: t.Iterable[int] = ()) -> t.List[dict]:
    named = {
        TRAIN_PID: "train", SERVE_PID: "serve", XLA_PID: "xla-compile",
        ROUTER_PID: "router", TRANSPORT_PID: "staging-transport",
        ELASTIC_PID: "elastic",
    }
    rows = list(named.items())
    for pid in sorted(set(extra_pids) - set(named)):
        # Dynamic lanes: actor subprocess pids, anything else numeric.
        rows.append((
            pid,
            f"actor{pid - ACTOR_PID_BASE}" if pid >= ACTOR_PID_BASE
            else f"pid{pid}",
        ))
    return [
        {
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": name},
        }
        for pid, name in rows
    ]


def export_trace(path: str | os.PathLike, *event_lists: t.List[dict]) -> dict:
    """Merge event lists, sort by timestamp (E-before-B at equal ts so
    zero-length neighbors never interleave as crossed pairs), and
    write one Perfetto-loadable JSON object. Returns a small summary
    (counts per pid) for logging/smoke assertions."""
    events: t.List[dict] = []
    for lst in event_lists:
        events.extend(lst)
    spans = [e for e in events if e.get("ph") in ("B", "E")]
    spans.sort(key=lambda e: (e["ts"], 0 if e["ph"] == "E" else 1))
    merged = _metadata_events(e["pid"] for e in spans) + spans
    payload = {"traceEvents": merged, "displayTimeUnit": "ms"}
    path = str(path)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f)
    by_pid: t.Dict[int, int] = {}
    for e in spans:
        if e["ph"] == "B":
            by_pid[e["pid"]] = by_pid.get(e["pid"], 0) + 1
    summary = {
        "path": path,
        "spans_total": sum(by_pid.values()),
        "train_spans": by_pid.get(TRAIN_PID, 0),
        "serve_spans": by_pid.get(SERVE_PID, 0),
        "compile_spans": by_pid.get(XLA_PID, 0),
        "router_spans": by_pid.get(ROUTER_PID, 0),
        "transport_spans": by_pid.get(TRANSPORT_PID, 0),
        "elastic_spans": by_pid.get(ELASTIC_PID, 0),
        "actor_spans": sum(
            n for p, n in by_pid.items() if p >= ACTOR_PID_BASE
        ),
        "pids": sorted(by_pid),
    }
    logger.info(
        "trace exported: %s (%d train / %d serve / %d compile spans)",
        path, summary["train_spans"], summary["serve_spans"],
        summary["compile_spans"],
    )
    return summary
