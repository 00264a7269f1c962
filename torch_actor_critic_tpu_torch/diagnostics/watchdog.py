"""Process-wide stall watchdog: CUDA-graph captures and kernel builds
(port of ``diagnostics/watchdog.py``).

The JAX package's watchdog counts XLA backend compiles, the multi-second
stalls that a steady run must not pay. The port compiles no programs;
the events that stall a step on the card are:

- a CUDA-graph capture (:meth:`~..sac.graph.BurstGraph._capture`: the
  warm-up update and the capture), labelled by the graph's source:
  ``train/burst`` for a learner's update burst, ``train/acting`` for the
  fused loop's acting step;
- a kernel library build (``ops/_kernels.build_all``: one ``nvcc`` per
  source), labelled ``kernels/build``.

Each event is counted under its label (an explicit one, else the
innermost :meth:`RecompilationWatchdog.source` of the thread, else
``unattributed``), as ``warmup`` inside :meth:`~RecompilationWatchdog.
expected` and ``live`` otherwise. Sources that declared themselves
**steady** (:meth:`~RecompilationWatchdog.mark_steady` with their label
prefix) flag any later live event as an anomaly: logged, counted and
written to ``telemetry.jsonl``. The trainer marks ``train/`` steady one
epoch after its first update epoch, so a capture after that (a state
or ring replaced under the graph) is an anomaly.

Nothing is recorded until :meth:`~RecompilationWatchdog.install`; the
trainer installs the process's watchdog (:func:`get_watchdog`) when a
diagnostics tier is on. The keys keep the JAX names where the meaning
carries over (``by_source``, ``anomalies``, ``compile_log``); the
counts are ``captures_total``, ``live_captures``, ``warmup_captures``,
``post_steady_captures`` and ``builds_total`` where JAX has
``compiles_total``, ``live_compiles``, ``warmup_compiles`` and
``post_steady_compiles``.

The cold-start counters (:mod:`~..aot`) keep JAX's keys:
``bundle_hits`` (programs a verified warm-start bundle warmed),
``bundle_rejected`` and ``bundle_reject_reasons`` (bundles refused on a
fingerprint, library or signature mismatch), ``cache_hits_total`` (a
kernel library found on disk, in the armed bundle or the library cache)
and ``cache_misses_total`` (a library that had to be built). The port
adds ``bundle_library_hits``, the cache hits served from a bundle's
``kernels/``. These count whether or not the watchdog is installed.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
import typing as t

logger = logging.getLogger(__name__)

__all__ = ["RecompilationWatchdog", "get_watchdog"]

_UNATTRIBUTED = "unattributed"
BUILD_SOURCE = "kernels/build"
_MAX_ANOMALIES = 100  # bounded memory; the counter keeps the true total
_MAX_COMPILE_LOG = 256  # newest event records kept for the trace
_MAX_REJECT_REASONS = 20  # newest bundle-rejection reasons kept


class _SourceCtx:
    """Reentrant, reusable context manager pushing a source label onto
    the owning watchdog's thread-local stack."""

    __slots__ = ("_wd", "_label")

    def __init__(self, wd: "RecompilationWatchdog", label: str):
        self._wd = wd
        self._label = label

    def __enter__(self):
        stack = getattr(self._wd._tls, "stack", None)
        if stack is None:
            stack = self._wd._tls.stack = []
        stack.append(self._label)
        return self

    def __exit__(self, *exc):
        self._wd._tls.stack.pop()
        return False


class _ExpectedCtx:
    __slots__ = ("_wd",)

    def __init__(self, wd: "RecompilationWatchdog"):
        self._wd = wd

    def __enter__(self):
        self._wd._tls.expected = getattr(self._wd._tls, "expected", 0) + 1
        return self

    def __exit__(self, *exc):
        self._wd._tls.expected -= 1
        return False


class RecompilationWatchdog:
    def __init__(self):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.installed = False  # guarded-by: _lock
        self.captures_total = 0  # guarded-by: _lock
        self.builds_total = 0  # guarded-by: _lock
        self.by_source: t.Dict[str, int] = {}  # guarded-by: _lock
        self.stall_time_s = 0.0  # guarded-by: _lock
        self.live_captures = 0  # guarded-by: _lock
        self.warmup_captures = 0  # guarded-by: _lock
        self.post_steady_total = 0  # guarded-by: _lock
        self.anomalies: t.List[dict] = []  # guarded-by: _lock
        self._live_by_source: t.Dict[str, int] = {}  # guarded-by: _lock
        self._steady_prefixes: t.Set[str] = set()  # guarded-by: _lock
        self._compile_log: collections.deque = (  # guarded-by: _lock
            collections.deque(maxlen=_MAX_COMPILE_LOG)
        )
        self.bundle_hits = 0  # guarded-by: _lock
        self.bundle_rejected = 0  # guarded-by: _lock
        self._bundle_reject_reasons: collections.deque = (  # guarded-by: _lock
            collections.deque(maxlen=_MAX_REJECT_REASONS)
        )
        self.cache_hits_total = 0  # guarded-by: _lock
        self.cache_misses_total = 0  # guarded-by: _lock
        self.bundle_library_hits = 0  # guarded-by: _lock

    def install(self) -> "RecompilationWatchdog":
        """Start recording (idempotent)."""
        with self._lock:
            self.installed = True
        return self

    # ------------------------------------------------------- attribution

    def source(self, label: str) -> _SourceCtx:
        """Context manager attributing unlabelled events in the dynamic
        extent of the with-block (same thread) to ``label``."""
        return _SourceCtx(self, label)

    def expected(self) -> _ExpectedCtx:
        """Context manager marking events as expected (``warmup``):
        counted, never flagged as steady-state anomalies."""
        return _ExpectedCtx(self)

    def mark_steady(self, prefix: str) -> None:
        """Declare sources starting with ``prefix`` steady: every later
        live event attributed to them is an anomaly."""
        with self._lock:
            self._steady_prefixes.add(prefix)

    def clear_steady(self, prefix: str) -> None:
        with self._lock:
            self._steady_prefixes.discard(prefix)

    # ------------------------------------------------------------ events

    def note_capture(self, secs: float, label: str | None = None) -> None:
        """One CUDA-graph capture that took ``secs`` (its warm-up
        included)."""
        self._note(secs, label, build=False)

    def note_build(self, secs: float, label: str = BUILD_SOURCE) -> None:
        """One kernel library build that took ``secs``."""
        self._note(secs, label, build=True)

    def _note(self, secs: float, label: str | None, build: bool) -> None:
        stack = getattr(self._tls, "stack", None)
        src = label or (stack[-1] if stack else _UNATTRIBUTED)
        expected = getattr(self._tls, "expected", 0) > 0
        with self._lock:
            if not self.installed:
                return
            if build:
                self.builds_total += 1
            else:
                self.captures_total += 1
                if expected:
                    self.warmup_captures += 1
                else:
                    self.live_captures += 1
            self.by_source[src] = self.by_source.get(src, 0) + 1
            self.stall_time_s += secs
            if not expected:
                self._live_by_source[src] = self._live_by_source.get(src, 0) + 1
            self._compile_log.append({
                "source": src,
                "time": time.time(),  # the event is noted at its END
                "duration_s": round(secs, 4),
                "expected": expected,
                "kind": "build" if build else ("warmup" if expected else "live"),
            })
            steady = not expected and any(src.startswith(p) for p in self._steady_prefixes)
            if not steady:
                return
            self.post_steady_total += 1
            anomaly = {
                "source": src,
                "time": time.time(),
                "duration_s": round(secs, 3),
                "count_at": self.captures_total + self.builds_total,
            }
            if len(self.anomalies) < _MAX_ANOMALIES:
                self.anomalies.append(anomaly)
        logger.warning(
            "steady-state %s from %s (%.2fs): a graph that should be replayed was "
            "captured again (or a kernel rebuilt) on the hot path — check for a state, "
            "optimizer or ring replaced under the graph",
            "kernel build" if build else "CUDA-graph capture", src, secs,
        )

    # ------------------------------------------------------- cold start

    def note_bundle_hit(self, n: int = 1) -> None:
        """Count ``n`` programs warmed from a verified warm-start bundle."""
        with self._lock:
            self.bundle_hits += int(n)

    def note_bundle_rejected(self, reason: str) -> None:
        """Count one refused bundle; the caller falls back to the library
        cache (and ``nvcc``) for the same kernels."""
        with self._lock:
            self.bundle_rejected += 1
            self._bundle_reject_reasons.append(str(reason)[:300])
        logger.warning("warm-start bundle REJECTED (the kernel libraries come from the cache "
                       "or nvcc instead): %s", reason)

    def note_cache_probe(self, hit: bool, from_bundle: bool = False) -> None:
        """One kernel library looked up on disk: found (``hit``; in the
        armed bundle with ``from_bundle``) or to be built."""
        with self._lock:
            if hit:
                self.cache_hits_total += 1
                self.bundle_library_hits += int(from_bundle)
            else:
                self.cache_misses_total += 1

    # ----------------------------------------------------------- reports

    def compile_log(self) -> t.List[dict]:
        """The newest event records (bounded ring), each ``{source, time,
        duration_s, expected, kind}`` — the trace export's compile lane
        (``time`` is the event's END on the wall clock)."""
        with self._lock:
            return [dict(r) for r in self._compile_log]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "captures_total": self.captures_total,
                "builds_total": self.builds_total,
                "stall_time_s": round(self.stall_time_s, 3),
                "by_source": dict(self.by_source),
                "live_captures": self.live_captures,
                "warmup_captures": self.warmup_captures,
                "live_by_source": dict(self._live_by_source),
                "post_steady_captures": self.post_steady_total,
                "anomalies": list(self.anomalies),
                "bundle_hits": self.bundle_hits,
                "bundle_rejected": self.bundle_rejected,
                "bundle_reject_reasons": list(self._bundle_reject_reasons),
                "cache_hits_total": self.cache_hits_total,
                "cache_misses_total": self.cache_misses_total,
                "bundle_library_hits": self.bundle_library_hits,
            }

    def live_captures_for(self, prefix: str = "") -> int:
        """Live (not expected) events under sources starting with
        ``prefix`` ("" = every source)."""
        with self._lock:
            return sum(n for src, n in self._live_by_source.items() if src.startswith(prefix))

    def assert_zero_live(self, prefix: str = "") -> None:
        """Raise if any live event has been attributed to sources under
        ``prefix``."""
        live = self.live_captures_for(prefix)
        if live:
            with self._lock:
                offenders = {src: n for src, n in self._live_by_source.items()
                             if src.startswith(prefix)}
            raise AssertionError(
                f"live_captures == 0 violated: {live} live event(s) under prefix "
                f"{prefix!r} ({offenders})"
            )

    def reset(self) -> None:
        """Zero all counts and steady regimes (test isolation; the
        installation is left in place)."""
        with self._lock:
            self.captures_total = 0
            self.builds_total = 0
            self.by_source = {}
            self.stall_time_s = 0.0
            self.live_captures = 0
            self.warmup_captures = 0
            self.post_steady_total = 0
            self.anomalies = []
            self._live_by_source = {}
            self._steady_prefixes = set()
            self._compile_log.clear()
            self.bundle_hits = 0
            self.bundle_rejected = 0
            self._bundle_reject_reasons.clear()
            self.cache_hits_total = 0
            self.cache_misses_total = 0
            self.bundle_library_hits = 0


_WATCHDOG: RecompilationWatchdog | None = None
_SINGLETON_LOCK = threading.Lock()


def get_watchdog() -> RecompilationWatchdog:
    """The process-wide watchdog (created lazily, recording nothing
    until someone calls :meth:`~RecompilationWatchdog.install`)."""
    global _WATCHDOG
    with _SINGLETON_LOCK:
        if _WATCHDOG is None:
            _WATCHDOG = RecompilationWatchdog()
        return _WATCHDOG
