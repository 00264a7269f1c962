"""Multi-process fleet router: health-gated membership over N workers.

A copy of the JAX package's ``serve/router.py``, which imports no JAX;
its imports name the port's modules, and its HTTP servers listen with a
deeper backlog (:class:`BurstHTTPServer`).

One worker process drives one accelerator's engines well; "millions of
users" needs N of them behind something that knows which ones are
alive. :class:`FleetRouter` is that something — a thin stdlib-HTTP
layer (no web framework; same constraint as
:class:`~torch_actor_critic_tpu_torch.serve.server.PolicyServer`) in front
of N serving workers:

- **Membership** is health-gated: a poll thread GETs each worker's
  ``/healthz`` every ``poll_interval_s`` and runs the state machine

  ::

      admitted ──(healthz 503 "draining")──────► ejected(draining)
      admitted ──(every slot breaker open)─────► ejected(breaker_open)
      admitted ──(eject_after conn failures)───► ejected(unreachable)
      ejected  ──(healthz 200, breaker closed)─► admitted

  Ejection only stops NEW routing — requests already proxied to a
  draining worker finish there (the worker's own drain answers them).
- **Routing**: least last-known queue depth among admitted workers,
  round-robin on ties. A proxy attempt that fails at the connection
  level ejects the worker immediately and **fails over** to the next
  admitted worker — a request the router accepted is retried until a
  worker answers or every worker has been tried, which is what makes
  a mid-flood worker kill invisible to clients (``make fleet-smoke``).
  429s relay as-is (per-worker admission said *rate*, not *health* —
  the client's Retry-After dance handles it); 503s fail over.
- **Request identity**: the client's ``X-Request-Id`` (or a generated
  one) gains a ``>workerN`` hop tag per proxy attempt, echoed on the
  response and handed to the worker — so the router hop span, the
  worker's batcher spans and the engine forward stitch into ONE
  request timeline in the PR-7 Perfetto export
  (:func:`~torch_actor_critic_tpu_torch.telemetry.traceview.router_hop_events`).
- **Fleet /metrics**: per-worker snapshots are fetched live and folded
  by :func:`~torch_actor_critic_tpu_torch.serve.metrics.aggregate_snapshots`
  — counters summed, latency histograms merged bucket-wise, every
  input kept per-worker-labelled, restarts never double-counted.
- **Rolling reload** (``POST /reload``): one worker at a time — eject
  from rotation (new traffic drains away; in-flight finishes), trigger
  the worker's validated hot-reload, wait for ``/healthz`` to confirm,
  re-admit. A worker whose reload is rejected (NaN checkpoint) keeps
  its last-good generation and rejoins; the fleet never serves a
  mixed-health rotation and never drops an accepted request.

Entry point: ``python -m torch_actor_critic_tpu_torch.serve --fleet N``
(spawns the workers and this router; docs/SERVING.md "Fleet").
"""

from __future__ import annotations

import http.client
import json
import logging
import threading
import time
import typing as t
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib import error as urlerr
from urllib import request as urlreq

from torch_actor_critic_tpu_torch.serve.metrics import aggregate_snapshots

logger = logging.getLogger(__name__)

__all__ = ["BurstHTTPServer", "FleetRouter", "WorkerState"]


class BurstHTTPServer(ThreadingHTTPServer):
    """The stdlib threading server with a listen backlog of 128 (its
    default is 5): a burst of concurrent connections waits to be
    accepted instead of being reset by the kernel, so admission control
    (the queue capacity's 429) decides what a burst gets. The router and
    the worker servers use it; the JAX package's use the default."""

    request_queue_size = 128
    daemon_threads = True


class WorkerState:
    """One worker's membership record."""

    def __init__(self, name: str, url: str):
        self.name = name
        self.url = url.rstrip("/")
        self.admitted = True
        self.reason: str | None = None  # why ejected
        self.admin_hold = False  # rolling-reload: poll may not re-admit
        self.consecutive_failures = 0
        self.queue_depth = 0  # last-polled, routing signal
        self.routed_total = 0
        self.transitions = 0
        self.last_health: dict | None = None

    def view(self) -> dict:
        return {
            "url": self.url,
            "admitted": self.admitted,
            "reason": self.reason,
            "queue_depth": self.queue_depth,
            "routed_total": self.routed_total,
            "transitions": self.transitions,
        }


class FleetRouter:
    """Health-gated routing over N ``PolicyServer`` workers.

    ``workers`` is a list of base URLs (``http://host:port``), named
    ``w0..wN-1`` in order. ``port=0`` binds an ephemeral router port
    (read ``.port``/``.address`` back — the test/smoke path).
    """

    def __init__(
        self,
        workers: t.Sequence[str],
        host: str = "127.0.0.1",
        port: int = 0,
        poll_interval_s: float = 1.0,
        eject_after: int = 2,
        request_timeout_s: float = 30.0,
        health_timeout_s: float = 2.0,
        span_log=None,
    ):
        if not workers:
            raise ValueError("FleetRouter needs at least one worker URL")
        self.workers: t.Dict[str, WorkerState] = {
            f"w{i}": WorkerState(f"w{i}", url)
            for i, url in enumerate(workers)
        }
        self.poll_interval_s = float(poll_interval_s)
        self.eject_after = int(eject_after)
        self.request_timeout_s = float(request_timeout_s)
        self.health_timeout_s = float(health_timeout_s)
        self.span_log = span_log
        self._lock = threading.Lock()
        self._rr = 0  # guarded-by: _lock
        self._reload_lock = threading.Lock()
        self._poll_stop = threading.Event()
        self._poller: threading.Thread | None = None  # guarded-by: _lock
        self.routed_total = 0  # guarded-by: _lock
        self.failovers_total = 0  # guarded-by: _lock
        self.no_worker_total = 0  # guarded-by: _lock
        # Injectable extra /metrics section: a fleet CLI points this at
        # the warm pool + elastic controller so their counters ride
        # the fleet-aggregated payload under ``fleet``. None (the
        # default) adds no key — the --elastic off key-pin contract.
        self.fleet_extra: t.Callable[[], dict] | None = None
        router = self

        class Handler(BaseHTTPRequestHandler):
            timeout = router.request_timeout_s

            def log_message(self, fmt, *args):  # noqa: A003
                logger.debug("router http: " + fmt, *args)

            def _send(self, code, payload, headers=None):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — stdlib API
                if self.path == "/healthz":
                    view = router.membership()
                    healthy = view["admitted_workers"]
                    self._send(
                        200 if healthy else 503,
                        dict(
                            view,
                            status="ok" if healthy else "no_workers",
                        ),
                        headers=None if healthy else {"Retry-After": "1"},
                    )
                elif self.path == "/metrics":
                    self._send(200, router.aggregate_metrics())
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):  # noqa: N802 — stdlib API
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length) if length else b"{}"
                if self.path == "/act":
                    code, payload, headers = router.route_act(
                        raw, self.headers.get("X-Request-Id")
                    )
                    self._send(code, payload, headers=headers)
                elif self.path == "/reload":
                    self._send(200, {"reload": router.rolling_reload()})
                else:
                    self._send(404, {"error": f"no route {self.path}"})

        self._httpd = BurstHTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None  # guarded-by: _lock

    # ---------------------------------------------------------- membership

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def _set_admitted(self, w: WorkerState, admitted: bool, reason=None):
        """Callers hold ``self._lock``."""
        if w.admitted == admitted:
            w.reason = reason if not admitted else None
            return
        w.admitted = admitted
        w.reason = reason if not admitted else None
        w.transitions += 1
        logger.warning(
            "worker %s (%s) %s%s", w.name, w.url,
            "re-admitted" if admitted else "EJECTED",
            "" if admitted else f" ({reason})",
        )

    def _poll_worker(self, w: WorkerState):
        try:
            with urlreq.urlopen(
                w.url + "/healthz", timeout=self.health_timeout_s
            ) as resp:
                health = json.loads(resp.read())
            code = 200
        except urlerr.HTTPError as e:
            try:
                health = json.loads(e.read())
            except (ValueError, OSError):
                health = {}
            code = e.code
        except (urlerr.URLError, OSError, ValueError):
            with self._lock:
                w.consecutive_failures += 1
                w.last_health = None
                if (
                    w.admitted
                    and w.consecutive_failures >= self.eject_after
                ):
                    self._set_admitted(w, False, "unreachable")
            return
        slots = health.get("slots") or {}
        breakers_open = bool(slots) and all(
            s.get("breaker") == "open" for s in slots.values()
        )
        with self._lock:
            w.consecutive_failures = 0
            w.last_health = health
            w.queue_depth = int(health.get("queue_depth") or 0)
            if health.get("status") == "draining" or code == 503:
                self._set_admitted(w, False, "draining")
            elif breakers_open:
                # Every slot's engine is tripped: the worker answers
                # healthz but can serve nothing — out of rotation
                # until a probe recovers some slot.
                self._set_admitted(w, False, "breaker_open")
            elif not w.admin_hold:
                self._set_admitted(w, True)

    def poll_once(self):
        """One membership sweep over every worker (the poll thread's
        body; tests call it directly for deterministic transitions)."""
        for w in list(self.workers.values()):
            self._poll_worker(w)

    def add_worker(self, url: str) -> str:
        """Admit a worker at runtime (warm-pool scale-up / dead-worker
        replacement, docs/SERVING.md "Cold start"): registers the URL
        under the next free ``wN`` name and health-polls it once so an
        already-warm worker enters rotation immediately. Returns the
        assigned name."""
        with self._lock:
            idx = 0
            while f"w{idx}" in self.workers:
                idx += 1
            name = f"w{idx}"
            w = WorkerState(name, url)
            self.workers[name] = w
        logger.info("router: worker %s added at %s", name, url)
        self._poll_worker(w)
        return name

    def drain_worker(self, name: str) -> str | None:
        """Hold a worker out of rotation for an elastic scale-in: eject
        with ``admin_hold`` set so the poll thread cannot re-admit it
        while it drains. New traffic routes elsewhere immediately;
        requests the worker already accepted finish there (its own
        PR-5 graceful drain answers them once it is SIGTERMed — the
        caller's next step). Returns the worker URL, or None for an
        unknown name."""
        with self._lock:
            w = self.workers.get(name)
            if w is None:
                return None
            w.admin_hold = True
            self._set_admitted(w, False, "scale_in")
            return w.url

    def remove_worker(self, name: str) -> None:
        """Forget a worker after its drain completed (elastic scale-in
        teardown). Only a held-out or ejected worker may be removed —
        removing an admitted one would drop routed requests, which the
        drain path exists to prevent."""
        with self._lock:
            w = self.workers.get(name)
            if w is None:
                raise KeyError(f"no worker named {name!r}")
            if w.admitted and not w.admin_hold:
                raise ValueError(
                    f"worker {name} is still admitted; drain_worker() "
                    "it first"
                )
            del self.workers[name]
        logger.info("router: worker %s removed", name)

    def membership(self) -> dict:
        with self._lock:
            views = {n: w.view() for n, w in self.workers.items()}
            routed, failovers = self.routed_total, self.failovers_total
        return {
            "workers": views,
            "admitted_workers": sum(
                1 for v in views.values() if v["admitted"]
            ),
            "routed_total": routed,
            "failovers_total": failovers,
        }

    # ------------------------------------------------------------- routing

    def _pick_locked(self, exclude: t.Set[str]) -> WorkerState | None:
        """Least last-known queue depth among admitted workers not yet
        tried for this request; round-robin on ties."""
        names = list(self.workers)
        n = len(names)
        best = None
        for off in range(n):
            w = self.workers[names[(self._rr + off) % n]]
            if not w.admitted or w.name in exclude:
                continue
            if best is None or w.queue_depth < best.queue_depth:
                best = w
        if best is not None:
            self._rr = (names.index(best.name) + 1) % n
        return best

    def route_act(
        self, body: bytes, request_id: str | None
    ) -> t.Tuple[int, dict, dict]:
        """Proxy one /act: ``(status, payload, response_headers)``.

        Fails over across admitted workers on connection errors (the
        worker is ejected on the spot) and 503s; relays 429 and 4xx
        as-is. The hop-tagged request id is echoed so the client sees
        which worker answered."""
        rid = request_id or uuid.uuid4().hex[:16]
        tried: t.Set[str] = set()
        last: t.Tuple[int, dict, dict] | None = None
        for _attempt in range(len(self.workers)):
            with self._lock:
                w = self._pick_locked(tried)
                if w is not None:
                    w.routed_total += 1
                    self.routed_total += 1
                    if _attempt:
                        self.failovers_total += 1
            if w is None:
                break
            tried.add(w.name)
            hop_rid = f"{rid}>{w.name}"
            t0 = time.perf_counter()
            try:
                req = urlreq.Request(
                    w.url + "/act", data=body,
                    headers={
                        "Content-Type": "application/json",
                        "X-Request-Id": hop_rid,
                    },
                )
                with urlreq.urlopen(
                    req, timeout=self.request_timeout_s
                ) as resp:
                    payload = json.loads(resp.read())
                self._note_hop(rid, w.name, t0, "ok")
                return 200, payload, {"X-Request-Id": hop_rid}
            except urlerr.HTTPError as e:
                try:
                    payload = json.loads(e.read())
                except (ValueError, OSError):
                    payload = {"error": f"worker {w.name} HTTP {e.code}"}
                headers = {"X-Request-Id": hop_rid}
                ra = e.headers.get("Retry-After") if e.headers else None
                if ra:
                    headers["Retry-After"] = ra
                self._note_hop(rid, w.name, t0, f"http_{e.code}")
                if e.code == 503:
                    # Draining / breaker-open / backend timeout: this
                    # worker cannot serve it NOW — another may. Keep
                    # the response in case every worker says 503.
                    last = (e.code, payload, headers)
                    continue
                # 429 (rate) and client errors (4xx) relay unchanged:
                # retrying elsewhere would either pile onto a
                # saturated fleet or repeat a malformed request.
                return e.code, payload, headers
            except (urlerr.URLError, OSError, http.client.HTTPException, ValueError) as e:
                # Connection-level death, a response cut short by it
                # (IncompleteRead, a truncated JSON body) included: eject
                # NOW (the poll thread would take poll_interval to
                # notice) and fail over.
                with self._lock:
                    self._set_admitted(w, False, "unreachable")
                self._note_hop(rid, w.name, t0, "unreachable")
                logger.warning(
                    "worker %s unreachable mid-request (%r); failing "
                    "over", w.name, e,
                )
                last = (
                    503,
                    {
                        "error": f"worker {w.name} unreachable",
                        "reason": "worker_unreachable",
                        "request_id": rid,
                    },
                    {"Retry-After": "1", "X-Request-Id": hop_rid},
                )
                continue
        if last is not None:
            return last
        with self._lock:
            self.no_worker_total += 1
        return (
            503,
            {
                "error": "no admitted workers in the fleet",
                "reason": "no_workers",
                "request_id": rid,
            },
            {"Retry-After": "1", "X-Request-Id": rid},
        )

    def _note_hop(self, rid, worker, t0, outcome):
        if self.span_log is None:
            return
        now = time.perf_counter()
        self.span_log.record({
            "request_id": rid, "worker": worker,
            "t_route": t0, "t_done": now, "outcome": outcome,
        })

    # ------------------------------------------------------------- metrics

    def _fetch_worker_metrics(self, w: WorkerState) -> dict | None:
        try:
            with urlreq.urlopen(
                w.url + "/metrics", timeout=self.health_timeout_s
            ) as resp:
                return json.loads(resp.read())
        except (urlerr.URLError, OSError, ValueError):
            return None

    def aggregate_metrics(self) -> dict:
        """The fleet ``/metrics`` payload: per-worker snapshots folded
        by :func:`aggregate_snapshots` (sums for counters, merged
        latency buckets — a restarted worker's reset counters simply
        re-enter the sum, never double-counted), plus the router's own
        membership/routing counters under ``router`` and, when
        ``fleet_extra`` is attached, the warm-pool/elastic section
        under ``fleet`` (spare count, last-refill status, controller
        counters — docs/SERVING.md "Fleet")."""
        snaps = {
            w.name: self._fetch_worker_metrics(w)
            for w in list(self.workers.values())
        }
        out = aggregate_snapshots(snaps)
        with self._lock:
            no_worker = self.no_worker_total
        out["router"] = dict(self.membership(), no_worker_total=no_worker)
        extra = self.fleet_extra
        if extra is not None:
            try:
                out["fleet"] = extra()
            except Exception:  # noqa: BLE001 - metrics must not fail on a torn-down pool
                logger.exception("fleet extra metrics section failed")
        return out

    # ------------------------------------------------------ rolling reload

    def rolling_reload(
        self, settle_timeout_s: float = 10.0
    ) -> t.Dict[str, dict]:
        """Hot-reload the fleet one worker at a time, zero dropped
        requests: eject from rotation (new traffic routes elsewhere;
        in-flight requests finish on the worker), POST its ``/reload``
        (the worker-side validated hot-reload: a NaN checkpoint is
        rejected there and last-good keeps serving), wait for
        ``/healthz`` to confirm it is serving, re-admit. Serialized
        per-fleet (the lock): two concurrent rolling reloads would
        otherwise eject two workers at once. Workers an elastic drain
        already holds (``admin_hold`` set) are skipped, and a drain
        that grabs a worker mid-reload keeps its hold — the reload
        never re-admits a scale-in victim."""
        out: t.Dict[str, dict] = {}
        with self._reload_lock:
            for name in list(self.workers):
                w = self.workers.get(name)
                if w is None:
                    continue  # removed while the reload walked the fleet
                with self._lock:
                    if w.admin_hold:
                        # Already held out by an elastic drain: the
                        # victim may be SIGTERMed mid-exit; POSTing
                        # /reload at it and clearing its hold below
                        # would re-admit a dying worker and break the
                        # drain reaper's remove_worker.
                        out[name] = {"skipped": "admin_hold"}
                        continue
                    w.admin_hold = True
                    self._set_admitted(w, False, "rolling_reload")
                status: dict = {}
                try:
                    req = urlreq.Request(
                        w.url + "/reload", data=b"{}",
                        headers={"Content-Type": "application/json"},
                    )
                    with urlreq.urlopen(
                        req, timeout=max(self.request_timeout_s, 30.0)
                    ) as resp:
                        status["reload"] = json.loads(
                            resp.read()
                        ).get("reload")
                except (urlerr.URLError, OSError, ValueError) as e:
                    status["error"] = repr(e)[:200]
                # Confirm the worker is serving again before re-admit.
                deadline = time.monotonic() + settle_timeout_s
                healthy = False
                while time.monotonic() < deadline:
                    try:
                        with urlreq.urlopen(
                            w.url + "/healthz",
                            timeout=self.health_timeout_s,
                        ) as resp:
                            healthy = (
                                json.loads(resp.read()).get("status")
                                == "ok"
                            )
                        if healthy:
                            break
                    except (urlerr.URLError, OSError, ValueError):
                        pass
                    time.sleep(0.05)
                with self._lock:
                    if w.reason == "scale_in":
                        # An elastic drain grabbed this worker while
                        # the reload waited on it; the hold (and the
                        # eventual removal) belongs to the drain
                        # reaper now — do not clear it or re-admit.
                        status["readmitted"] = False
                        status["drained"] = True
                    else:
                        w.admin_hold = False
                        if healthy:
                            self._set_admitted(w, True)
                        status["readmitted"] = healthy
                out[name] = status
        return out

    # --------------------------------------------------------------- admin

    def start(self):
        """Serve + poll on daemon threads (tests, smoke)."""
        self._poll_stop.clear()

        def poll_loop():
            while not self._poll_stop.wait(timeout=self.poll_interval_s):
                try:
                    self.poll_once()
                except Exception:  # noqa: BLE001 — pragma: no cover —
                    # membership must survive any one bad poll
                    logger.exception("membership poll failed; will retry")

        with self._lock:
            poller = self._poller = threading.Thread(
                target=poll_loop, name="fleet-membership", daemon=True
            )
            http = self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="fleet-router",
                daemon=True,
            )
        poller.start()
        http.start()
        return self

    def serve_forever(self):
        """Block serving until interrupted (the CLI path)."""
        self.start()
        with self._lock:
            http = self._thread
        try:
            http.join()
        except KeyboardInterrupt:  # pragma: no cover — operator stop
            pass
        finally:
            self.close()

    def close(self):
        self._poll_stop.set()
        # Swap the handle out under the lock, join OUTSIDE it: the
        # poll loop's poll_once() takes _lock per worker.
        with self._lock:
            poller, self._poller = self._poller, None
        if poller is not None:
            poller.join(timeout=10.0)
        self._httpd.shutdown()
        self._httpd.server_close()
        with self._lock:
            http, self._thread = self._thread, None
        if http is not None:
            http.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
