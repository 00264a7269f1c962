"""Telemetry sinks: JSONL event stream + human summary table.

The JSONL stream is the machine interface — one self-describing JSON
object per line, append-only, flushed per event so external pollers can
``tail -f`` a live run (the same contract as the Tracker's
``metrics.jsonl`` mirror). :func:`json_sanitize` keeps every line
strict-JSON parseable: Python's ``json`` happily emits ``NaN`` /
``Infinity`` literals that most parsers (jq, browsers, Rust serde)
reject, so non-finite floats are mapped to ``None`` before they reach
disk. Schema documented in docs/OBSERVABILITY.md.

A copy of the JAX package's ``telemetry/sinks.py``, which imports no
JAX; the port keeps its own so it imports nothing of that package.
"""

from __future__ import annotations

import json
import math
import os
import time
import typing as t

__all__ = ["JsonlSink", "format_summary", "json_sanitize"]


def json_sanitize(value: t.Any) -> t.Any:
    """Recursively make ``value`` strict-JSON safe: non-finite floats
    become ``None``; numpy scalars become Python scalars; unknown
    objects become their ``repr``."""
    if isinstance(value, dict):
        return {str(k): json_sanitize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [json_sanitize(v) for v in value]
    if isinstance(value, bool) or value is None or isinstance(value, (int, str)):
        return value
    if isinstance(value, float):
        return value if math.isfinite(value) else None
    # numpy scalars (and 0-d arrays) expose item(); anything else is
    # stringified rather than crashing the event write.
    item = getattr(value, "item", None)
    if callable(item):
        try:
            return json_sanitize(item())
        except (TypeError, ValueError):
            pass
    return repr(value)


class JsonlSink:
    """Append-only JSONL event writer, one flush per event.

    Lazily opens on first write (a disabled-tracking run never creates
    the file), creates parent directories, and never raises out of
    :meth:`write` — losing a telemetry line must not kill an epoch.

    ``max_bytes > 0`` enables size-based rotation (``--telemetry-max-mb``)
    so multi-hour fleet runs bound their event-stream footprint: when the
    next line would cross the limit the current file is renamed to
    ``<path>.1`` (one generation kept — worst case ~2x ``max_bytes`` on
    disk) and the fresh file opens with a counted ``sink_rotated`` marker
    line, so a rotation is visible in the stream it truncated. Default
    off: the append-only "one file per run" contract is unchanged unless
    asked for.
    """

    def __init__(self, path: str | os.PathLike, max_bytes: int = 0):
        self.path = str(path)
        self.max_bytes = int(max_bytes)
        self._fh: t.Optional[t.TextIO] = None
        self._bytes = 0
        self.events_written = 0
        self.write_errors = 0
        self.rotations = 0

    def write(self, event: dict) -> None:
        try:
            if self._fh is None:
                parent = os.path.dirname(self.path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                self._fh = open(self.path, "a")
                try:
                    self._bytes = os.path.getsize(self.path)
                except OSError:
                    self._bytes = 0
            data = json.dumps(json_sanitize(event)) + "\n"
            if (
                self.max_bytes > 0
                and self._bytes > 0
                and self._bytes + len(data) > self.max_bytes
            ):
                self._rotate()
            self._fh.write(data)
            self._fh.flush()
            self._bytes += len(data)
            self.events_written += 1
        except OSError:
            self.write_errors += 1

    def _rotate(self) -> None:
        self._fh.close()
        os.replace(self.path, self.path + ".1")
        self._fh = open(self.path, "a")
        self._bytes = 0
        self.rotations += 1
        marker = json.dumps(
            {"type": "sink_rotated", "time": time.time(),
             "rotations": self.rotations}
        ) + "\n"
        self._fh.write(marker)
        self._bytes += len(marker)

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None


def format_summary(
    phases: t.Mapping[str, dict],
    counters: t.Mapping[str, float] | None = None,
    title: str = "telemetry summary",
) -> str:
    """Human phase-breakdown table from recorder phase stats
    (``{name: {"total_s", "count", "max_s"}}``). Percentages are of the
    instrumented total, so they answer "where does the time go" —
    docs/OBSERVABILITY.md explains how to read it."""
    total = sum(p.get("total_s", 0.0) for p in phases.values()) or 1.0
    width = max([len(n) for n in phases] + [5])
    lines = [
        title,
        f"{'phase':<{width}}  {'total_s':>9}  {'%':>6}  {'count':>8}  "
        f"{'mean_ms':>9}  {'max_ms':>9}",
    ]
    for name, p in phases.items():
        tot, cnt = p.get("total_s", 0.0), p.get("count", 0)
        lines.append(
            f"{name:<{width}}  {tot:>9.3f}  {100 * tot / total:>5.1f}%  "
            f"{cnt:>8d}  "
            f"{(1e3 * tot / cnt if cnt else 0.0):>9.3f}  "
            f"{1e3 * p.get('max_s', 0.0):>9.3f}"
        )
    lines.append(f"{'total':<{width}}  {total:>9.3f}")
    for name, v in (counters or {}).items():
        lines.append(f"{name:<{width}}  {v}")
    return "\n".join(lines)
