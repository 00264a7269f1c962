"""Run-scoped metrics aggregator: one scraper thread, every plane (a
copy of the JAX package's ``obs/collector.py``).

The :class:`ObsCollector` owns the run-wide time series. Sources are
registered by name as either an in-process callable (the learner's own
``TelemetryRecorder.snapshot()`` — no HTTP round trip to yourself) or a
URL scraped over stdlib HTTP (:func:`http_source`: the serve router's
fleet-aggregated ``/metrics``, the staging transport's ``/metrics`` +
``/healthz``). On a fixed interval the scrape thread:

1. snapshots every source — a dead or unreachable target is a counted
   ``scrape_failed`` on that source (``live=False``, ``last_error``),
   never a raise and never a silent gap in the series;
2. folds the flattened snapshots through the plane-generic
   :func:`~torch_actor_critic_tpu_torch.obs.merge.aggregate_snapshots`
   (dynamic mode: every ``*_total``-shaped counter sums, histograms
   bucket-merge, restarts never double-count);
3. evaluates the SLO rule set against the composite row, forwarding
   any ``slo_breach``/``slo_recovered`` events to the telemetry
   recorder;
4. appends the row to ``obs.jsonl`` and publishes it on the
   collector's own ``/metrics`` endpoint (``--obs-port``).

The trainer mirrors :meth:`metrics_columns` into metrics.jsonl as
``obs/`` columns, so the aggregated plane rides the same artifact
every other metric does. Threading: scrape state is guarded by
``_lock``; the HTTP handler only reads under the same lock.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import typing as t
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from torch_actor_critic_tpu_torch.obs.merge import aggregate_snapshots, flatten_numeric
from torch_actor_critic_tpu_torch.obs.slo import SLOEngine, default_rules
from torch_actor_critic_tpu_torch.telemetry.sinks import JsonlSink, json_sanitize

__all__ = ["ObsCollector", "http_source"]

logger = logging.getLogger(__name__)

Source = t.Callable[[], t.Optional[t.Dict[str, t.Any]]]


def http_source(
    url: str,
    paths: t.Tuple[str, ...] = ("/metrics",),
    timeout_s: float = 2.0,
) -> Source:
    """Scrape callable over one process's stdlib-HTTP endpoints.

    The first path's JSON body is the snapshot; each extra path (e.g.
    ``/healthz``) is fetched too and nested under its name with the
    leading slash stripped — so the transport's conservation probe
    lands at ``<source>.healthz.conservation_ok``. Any failure raises
    out to the collector, which records it as a scrape failure."""
    base = url.rstrip("/")
    if "://" not in base:
        base = "http://" + base

    def scrape() -> t.Dict[str, t.Any]:
        out: t.Dict[str, t.Any] = {}
        for i, path in enumerate(paths):
            with urllib.request.urlopen(base + path, timeout=timeout_s) as r:
                body = json.loads(r.read().decode())
            if i == 0:
                out = body if isinstance(body, dict) else {"value": body}
            else:
                out[path.strip("/")] = body
        return out

    return scrape


class ObsCollector:
    """Aggregator thread + ``obs.jsonl`` writer + ``/metrics`` server.

    Built unstarted; :meth:`start` launches the scrape loop (the
    trainer calls it at ``train()`` entry, after every subclass has
    finished wiring its sources). :meth:`close` is idempotent and safe
    on a never-started collector."""

    def __init__(
        self,
        interval_s: float = 2.0,
        run_dir: t.Optional[str] = None,
        port: int = 0,
        rules: t.Optional[t.Sequence] = None,
        telemetry: t.Optional[t.Any] = None,
        max_bytes: int = 0,
    ):
        self.interval_s = float(interval_s)
        self.telemetry = telemetry
        self.slo = SLOEngine(default_rules() if rules is None else rules)
        self.sink = (
            JsonlSink(str(run_dir) + "/obs.jsonl", max_bytes=max_bytes)
            if run_dir is not None else None
        )
        self._lock = threading.Lock()
        self._sources: t.Dict[str, Source] = {}  # guarded-by: _lock
        self._stats: t.Dict[str, dict] = {}  # guarded-by: _lock
        self.scrapes_total = 0  # guarded-by: _lock
        self.scrape_failed_total = 0  # guarded-by: _lock
        self.slo_events_total = 0  # guarded-by: _lock
        self.last_scrape_ms = 0.0  # guarded-by: _lock
        self._last_row: t.Optional[dict] = None  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: t.Optional[threading.Thread] = None  # guarded-by: _lock
        # Per-window subscriber (the elastic controller's
        # observe_window). None by default: with no hook attached the
        # pointer check is the whole cost — the --elastic off contract.
        self.window_hook: t.Optional[t.Callable[[dict], t.Any]] = None
        self.port = 0
        self._server: t.Optional[ThreadingHTTPServer] = self._build_server(
            port
        )  # guarded-by: _lock

    # ------------------------------------------------------------- sources

    def add_source(self, name: str, source: t.Union[str, Source]):
        """Register a plane. A string is a base URL (scraped via
        :func:`http_source`); a callable returns the snapshot dict
        directly (or raises / returns None → counted failure)."""
        if isinstance(source, str):
            source = http_source(source)
        with self._lock:
            self._sources[name] = source
            self._stats.setdefault(name, {
                "scrapes": 0, "failures": 0, "live": False,
                "last_error": None, "last_scrape_ms": 0.0,
            })

    def remove_source(self, name: str) -> None:
        """Forget a plane (elastic scale-in: a drained worker stops
        being scraped instead of turning into a permanent counted
        failure). Its stats row is dropped too — source flapping is
        covered by the merge-layer tests: totals over the survivors
        never go negative and a re-added source re-enters the sum
        fresh."""
        with self._lock:
            self._sources.pop(name, None)
            self._stats.pop(name, None)

    def source_names(self) -> t.Tuple[str, ...]:
        with self._lock:
            return tuple(self._sources)

    # -------------------------------------------------------------- scrape

    def scrape_once(self) -> dict:
        """One window: scrape every source, merge, evaluate SLOs,
        persist. Never raises — a failing source is a counted
        ``scrape_failed`` entry; everything else proceeds."""
        t0 = time.perf_counter()
        with self._lock:
            sources = dict(self._sources)
        snaps: t.Dict[str, t.Optional[dict]] = {}
        raw: t.Dict[str, t.Optional[dict]] = {}
        for name, source in sources.items():
            s0 = time.perf_counter()
            err = None
            try:
                snap = source()
                if snap is not None and not isinstance(snap, dict):
                    snap = {"value": snap}
            except Exception as e:  # noqa: BLE001 - any source failure is a counted scrape_failed, never a crash
                snap, err = None, f"{type(e).__name__}: {e}"[:200]
            elapsed_ms = round(1e3 * (time.perf_counter() - s0), 3)
            raw[name] = snap
            snaps[name] = flatten_numeric(snap) if snap is not None else None
            with self._lock:
                st = self._stats.setdefault(name, {"scrapes": 0, "failures": 0})
                st["scrapes"] = st.get("scrapes", 0) + 1
                st["live"] = snap is not None
                st["last_scrape_ms"] = elapsed_ms
                if snap is None:
                    st["failures"] = st.get("failures", 0) + 1
                    st["last_error"] = err or "source returned None"
                    self.scrape_failed_total += 1
                else:
                    st["last_error"] = None
        merged = aggregate_snapshots(snaps, sum_keys=None)
        row: t.Dict[str, t.Any] = {
            "type": "obs",
            "time": time.time(),
            "sources": self._source_stats(),
            "merged": merged,
        }
        # Per-plane nested snapshots ride alongside the merged fold so
        # SLO paths can address one plane (``fleet.healthz.…``) or the
        # cross-plane totals (``merged.…``).
        for name, snap in raw.items():
            if name not in row:
                row[name] = snap if snap is not None else {"unreachable": True}
        events = self.slo.observe(row)
        slo_snap = self.slo.snapshot()
        row["slo"] = {
            "breaches_total": slo_snap["breaches_total"],
            "active_breaches": slo_snap["active_breaches"],
            "events": events,
        }
        if self.telemetry is not None:
            for ev in events:
                fields = {k: v for k, v in ev.items() if k != "type"}
                self.telemetry.event(ev["type"], **fields)
        scrape_ms = round(1e3 * (time.perf_counter() - t0), 3)
        with self._lock:
            self.scrapes_total += 1
            self.slo_events_total += len(events)
            self.last_scrape_ms = scrape_ms
            self._last_row = row
        if self.sink is not None:
            self.sink.write(row)
        hook = self.window_hook
        if hook is not None:
            try:
                hook(row)
            except Exception:  # noqa: BLE001 - a bad subscriber must not break the scrape series
                logger.exception("obs window hook failed")
        return row

    def _source_stats(self) -> dict:
        with self._lock:
            return {name: dict(st) for name, st in self._stats.items()}

    def metrics_columns(self) -> t.Dict[str, t.Any]:
        """The ``obs/`` columns the trainer mirrors into metrics.jsonl
        each epoch — the stable, flat summary of the plane."""
        with self._lock:
            stats = {n: dict(s) for n, s in self._stats.items()}
            out = {
                "obs/scrapes_total": self.scrapes_total,
                "obs/scrape_failed_total": self.scrape_failed_total,
                "obs/sources_total": len(stats),
                "obs/sources_live": sum(
                    1 for s in stats.values() if s.get("live")
                ),
                "obs/scrape_ms": self.last_scrape_ms,
            }
        slo = self.slo.snapshot()
        out["obs/slo_breaches_total"] = slo["breaches_total"]
        out["obs/slo_active"] = slo["active_breaches"]
        return out

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "ObsCollector":
        """Launch the scrape thread (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return self
            thread = threading.Thread(
                target=self._loop, name="obs-collector", daemon=True
            )
            self._thread = thread
        thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 - the collector thread must outlive any single bad window
                logger.exception("obs scrape window failed")
            self._stop.wait(self.interval_s)

    def _build_server(self, port: int) -> ThreadingHTTPServer:
        collector = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence stdlib access log
                pass

            def do_GET(self):  # noqa: N802 - stdlib handler API
                if self.path not in ("/metrics", "/healthz"):
                    self.send_error(404)
                    return
                if self.path == "/healthz":
                    with collector._lock:
                        live = sum(
                            1 for s in collector._stats.values()
                            if s.get("live")
                        )
                        total = len(collector._stats)
                    body = {"ok": True, "sources_live": live,
                            "sources_total": total}
                else:
                    with collector._lock:
                        body = {
                            "scrapes_total": collector.scrapes_total,
                            "scrape_failed_total": (
                                collector.scrape_failed_total
                            ),
                            "last_scrape_ms": collector.last_scrape_ms,
                            "sources": {
                                n: dict(s)
                                for n, s in collector._stats.items()
                            },
                            "last": collector._last_row,
                        }
                    body["slo"] = collector.slo.snapshot()
                data = json.dumps(json_sanitize(body)).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        server.daemon_threads = True
        self.port = server.server_address[1]
        threading.Thread(
            target=server.serve_forever, name="obs-http", daemon=True
        ).start()
        return server

    @property
    def address(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def close(self):
        """Stop the thread, take one final scrape if none ever ran,
        close the sink and server. Safe to call twice or unstarted."""
        self._stop.set()
        # Swap the handles out under the lock, then join/shutdown outside
        # it — the scrape loop and HTTP handler both take ``_lock``.
        with self._lock:
            thread, self._thread = self._thread, None
            server, self._server = self._server, None
        if thread is not None:
            thread.join(timeout=max(5.0, 2 * self.interval_s))
        if server is not None:
            server.shutdown()
            server.server_close()
        if self.sink is not None:
            self.sink.close()
