"""Cross-process trace collection: actor span files -> one timeline (a
copy of the JAX package's ``obs/tracecollect.py``; the port has no
actor fleet yet, so nothing of it writes such files).

Actor subprocesses cannot hand span buffers to the learner in memory,
so each remote staging client of a fleet run (when a fleet run has tracing on) appends its ``stage_push`` spans to
``<run_dir>/stage_spans/actor<id>-<incarnation>.spans.jsonl`` — one
line per successful push, with **absolute** microsecond timestamps
(each actor anchors its own wall clock via
:func:`~torch_actor_critic_tpu_torch.telemetry.traceview.perf_to_us` before
writing, so the files need no alien perf anchor to interpret) and the
``a<actor>.<incarnation>.<seq>`` span id that the transport's ingest
span and the learner's ``drain_window`` span also carry. At export
time :func:`actor_span_events` sweeps the directory and converts every
record onto that actor's own trace lane (``ACTOR_PID_BASE + actor_id``)
— merged with the learner's in-process buffers by ``export_trace``,
this is the one-screen fleet timeline the smoke asserts on.

A malformed line or unreadable file is skipped with a debug log,
never a raise: trace export runs in the run-exit path and must not
mask the run's real outcome.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import typing as t

from torch_actor_critic_tpu_torch.telemetry.traceview import (
    ACTOR_PID_BASE,
    staging_span_events,
)

__all__ = ["actor_span_events"]

logger = logging.getLogger(__name__)


def actor_span_events(trace_dir: str | os.PathLike) -> t.List[dict]:
    """Read every ``*.spans.jsonl`` under ``trace_dir`` and return the
    trace events, each actor on its own ``ACTOR_PID_BASE + actor_id``
    lane. Missing directory -> empty list (a fleet run that never
    staged anything still exports cleanly)."""
    events: t.List[dict] = []
    pattern = os.path.join(str(trace_dir), "*.spans.jsonl")
    for path in sorted(glob.glob(pattern)):
        records: t.List[dict] = []
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        logger.debug("skipping bad span line in %s", path)
                        continue
                    if isinstance(rec, dict):
                        records.append(rec)
        except OSError as e:
            logger.debug("cannot read span file %s: %s", path, e)
            continue
        by_pid: t.Dict[int, t.List[dict]] = {}
        for rec in records:
            aid = rec.get("actor_id")
            pid = (
                ACTOR_PID_BASE + int(aid) if isinstance(aid, int)
                else ACTOR_PID_BASE
            )
            by_pid.setdefault(pid, []).append(rec)
        for pid, recs in sorted(by_pid.items()):
            events.extend(staging_span_events(recs, pid=pid))
    return events
