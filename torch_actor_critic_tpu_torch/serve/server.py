"""JSON frontends over the batcher: in-process client and HTTP server.

Port of ``serve/server.py``, single device: ``/act``, ``/healthz``,
``/metrics``, ``/reload`` and the SIGTERM drain. Not ported yet: the
engine-per-device fleet (``devices > 1``), sub-mesh/precision tiers, the
transition flywheel (``/outcome``), per-request span logs, the XLA
watchdog and cost sections of ``/metrics``, and visual (pytree)
observations.

:class:`PolicyClient` is the zero-copy path for tests, benchmarks and
co-located actors: observations go straight into the micro-batching
queue as numpy arrays.

:class:`PolicyServer` is a stdlib ``ThreadingHTTPServer`` speaking
JSON — deliberately dependency-free (the container bakes no web
framework) and good for tens of thousands of requests/sec of small
observations, since each handler thread only parses JSON and parks on
a Future while the single dispatcher thread does the real (batched)
work:

- ``POST /act``     ``{"obs": [...] | {"features": [...], "frame": [...]},
  "deterministic": bool, "model": "default"}`` ->
  ``{"action": [...], "generation": N, "model": "..."}``
- ``GET /healthz``  liveness + per-slot generation/epoch (``draining``
  with HTTP 503 once a drain has started, so load balancers eject the
  replica while in-flight work finishes)
- ``GET /metrics``  :meth:`~torch_actor_critic_tpu_torch.serve.metrics.ServeMetrics.snapshot`
- ``POST /reload``  force a checkpoint poll now (hot-reload check)

Overload contract (docs/SERVING.md "Overload & degradation"): a
request the admission layer rejects at submit time — queue full or
deadline infeasible — answers **429** + ``Retry-After`` (the service
is healthy, the rate is not); a request the service cannot currently
serve — breaker open, draining, expired in queue, backend timeout —
answers **503** + ``Retry-After``. Every rejection carries the
structured :class:`~torch_actor_critic_tpu_torch.serve.admission.ShedError`
payload (``reason``, ``retry_after_s``).
"""

from __future__ import annotations

import json
import logging
import math
import random
import signal
import threading
import time
import typing as t
import uuid
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from torch_actor_critic_tpu_torch.serve.admission import (
    SUBMIT_SHED_REASONS,
    ShedError,
)
from torch_actor_critic_tpu_torch.serve.batcher import ActResult, MicroBatcher
from torch_actor_critic_tpu_torch.serve.metrics import ServeMetrics
from torch_actor_critic_tpu_torch.serve.registry import ModelRegistry

logger = logging.getLogger(__name__)

__all__ = ["PolicyClient", "PolicyServer", "install_drain_handler"]


class PolicyClient:
    """Access to the serving stack, in-process or over HTTP.

    **In-process mode** (``PolicyClient(registry, batcher)``): the
    zero-copy path — observations go straight into the micro-batching
    queue. One per process is enough; it is thread-safe.

    **HTTP mode** (``PolicyClient(url="http://host:port")``): the
    remote path actors and smoke harnesses use against a worker or a
    fleet router.

    **Retry semantics are transport-agnostic** (the decoupled
    actor/learner contract, docs/RESILIENCE.md): in BOTH modes ``act``
    retries rejected requests with **jittered backoff** honoring the
    server's own retry hint — the ``Retry-After`` header on the wire,
    the structured :class:`~torch_actor_critic_tpu_torch.serve.admission.
    ShedError` ``retry_after_s`` in-process: on a retryable rejection
    the client sleeps ``max(hint, backoff·2^attempt)`` plus up to 25%
    jitter (decorrelates a herd of clients all told "retry in 1s"),
    for at most ``retries`` retry attempts — and is
    **deadline-aware**: the ``timeout`` passed to ``act`` is the
    caller's total budget, so a retry that could not complete before
    the deadline is never started and the last rejection (its
    ``ShedError`` taxonomy preserved) is raised instead. 4xx client
    errors and 5xx server faults — ``ValueError``/engine faults
    in-process — are never retried (retrying a malformed request or a
    broken engine is not backoff's job). Pass ``retries=0`` for the
    fail-fast behavior; :class:`PolicyServer`'s internal client does
    (the HTTP frontend IS the admission layer — retrying server-side
    would double-count sheds and hide backpressure from remote
    clients).
    """

    def __init__(
        self,
        registry: ModelRegistry | None = None,
        batcher: MicroBatcher | None = None,
        url: str | None = None,
        retries: int = 3,
        backoff_s: float = 0.25,
        sleep: t.Callable[[float], None] = time.sleep,
        rng: random.Random | None = None,
    ):
        if (url is None) == (batcher is None):
            raise ValueError(
                "pass either (registry, batcher) for in-process mode "
                "or url= for HTTP mode"
            )
        self.registry = registry
        self.batcher = batcher
        self.url = url.rstrip("/") if url is not None else None
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self._sleep = sleep
        self._rng = rng if rng is not None else random.Random()
        self.retries_total = 0

    def act(
        self,
        obs: t.Any,
        deterministic: bool = True,
        slot: str = "default",
        timeout: float | None = 30.0,
        request_id: str | None = None,
    ) -> ActResult:
        """``request_id`` travels as ``X-Request-Id`` in HTTP mode."""
        if self.url is not None:
            return self._act_http(
                obs, deterministic, slot, timeout, request_id
            )
        return self._act_inprocess(obs, deterministic, slot, timeout)

    def act_async(
        self, obs: t.Any, deterministic: bool = True, slot: str = "default",
    ):
        if self.url is not None:
            raise RuntimeError(
                "act_async is in-process only; HTTP mode callers run "
                "act() on their own threads"
            )
        return self.batcher.submit(obs, deterministic, slot)

    # ----------------------------------------------------- in-process mode

    def _act_inprocess(self, obs, deterministic, slot, timeout):
        """In-process ``act`` with the SAME bounded, deadline-aware
        retry/backoff contract as HTTP mode: a structured rejection
        (``ShedError`` — queue full, breaker open, draining, expired)
        is retried up to ``retries`` times with jittered backoff off
        the shed's own ``retry_after_s`` hint, never past the caller's
        ``timeout``; the last rejection is re-raised with its taxonomy
        intact. Engine faults and request-shape errors propagate
        unretried (the 5xx/4xx analogue)."""
        deadline = (
            time.perf_counter() + timeout if timeout is not None else None
        )
        attempt = 0
        while True:
            remaining = (
                deadline - time.perf_counter()
                if deadline is not None else None
            )
            if remaining is not None and remaining <= 0:
                raise ShedError(
                    "deadline_infeasible",
                    f"client deadline of {timeout:.3f}s exhausted "
                    f"before attempt {attempt + 1}",
                )
            try:
                return self.batcher.act(
                    obs, deterministic, slot, timeout=remaining
                )
            except ShedError as e:
                if attempt >= self.retries:
                    raise
                delay = max(
                    e.retry_after_s, self.backoff_s * (2 ** attempt)
                )
                delay *= 1.0 + 0.25 * self._rng.random()  # jitter
                if deadline is not None and (
                    time.perf_counter() + delay >= deadline
                ):
                    # Never retry past the caller's deadline: raise
                    # the rejection we have (taxonomy intact) instead
                    # of one we'd manufacture by timing out mid-retry.
                    raise
                self.retries_total += 1
                attempt += 1
                self._sleep(delay)

    # ---------------------------------------------------------- HTTP mode

    def _act_http(self, obs, deterministic, slot, timeout, request_id):
        import urllib.error as urlerr
        import urllib.request as urlreq

        raw_obs = np.asarray(obs).tolist()
        body = json.dumps({
            "obs": raw_obs, "deterministic": bool(deterministic),
            "model": slot,
        }).encode()
        deadline = (
            time.perf_counter() + timeout if timeout is not None else None
        )
        attempt = 0
        while True:
            remaining = (
                deadline - time.perf_counter()
                if deadline is not None else None
            )
            if remaining is not None and remaining <= 0:
                raise ShedError(
                    "deadline_infeasible",
                    f"client deadline of {timeout:.3f}s exhausted "
                    f"before attempt {attempt + 1}",
                )
            headers = {"Content-Type": "application/json"}
            if request_id is not None:
                headers["X-Request-Id"] = request_id
            try:
                req = urlreq.Request(
                    self.url + "/act", data=body, headers=headers
                )
                with urlreq.urlopen(
                    req, timeout=remaining if remaining is not None else 30.0
                ) as resp:
                    out = json.loads(resp.read())
                epoch = out.get("epoch")
                return ActResult(
                    np.asarray(out["action"], dtype=np.float32),
                    int(out.get("generation", 0)),
                    int(epoch) if epoch is not None else None,
                )
            except urlerr.HTTPError as e:
                try:
                    payload = json.loads(e.read())
                except (ValueError, OSError):
                    payload = {}
                if e.code not in (429, 503):
                    raise RuntimeError(
                        f"/act failed with HTTP {e.code}: "
                        f"{payload.get('error', '')}"
                    ) from None
                reason = payload.get("reason", f"http_{e.code}")
                if attempt >= self.retries:
                    raise ShedError(
                        reason,
                        payload.get(
                            "error",
                            f"rejected with {e.code} after "
                            f"{attempt + 1} attempts",
                        ),
                        retry_after_s=float(
                            payload.get("retry_after_s", 1.0)
                        ),
                        detail=payload,
                    ) from None
                ra = e.headers.get("Retry-After") if e.headers else None
                delay = max(
                    float(ra) if ra else 0.0,
                    self.backoff_s * (2 ** attempt),
                )
                delay *= 1.0 + 0.25 * self._rng.random()  # jitter
                if deadline is not None and (
                    time.perf_counter() + delay >= deadline
                ):
                    # Never retry past the caller's deadline: raise
                    # the rejection we have instead of one we'd
                    # manufacture by timing out mid-retry.
                    raise ShedError(
                        reason,
                        payload.get(
                            "error",
                            f"rejected with {e.code}; deadline too "
                            "near to honor Retry-After",
                        ),
                        retry_after_s=delay,
                        detail=payload,
                    ) from None
                self.retries_total += 1
                attempt += 1
                self._sleep(delay)


def _parse_obs(raw, obs_spec):
    """JSON observation -> numpy array of ``obs_spec``'s dtype: a
    (nested) list, one observation or a batch of them."""
    if isinstance(raw, dict):
        raise ValueError(
            "visual (pytree) observations are not served by the port yet; "
            "send obs as a (nested) list"
        )
    return np.asarray(raw, dtype=obs_spec.dtype)


class PolicyServer:
    """HTTP frontend owning the registry's batcher + metrics.

    ``port=0`` binds an ephemeral port (read it back from ``.port`` —
    the serve-smoke and test harness path). ``start()`` serves on a
    daemon thread; ``serve_forever()`` blocks (the CLI path).
    """

    def __init__(
        self,
        registry: ModelRegistry,
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        metrics: ServeMetrics | None = None,
        seed: int = 0,
        request_timeout_s: float = 30.0,
        act_timeout_s: float = 30.0,
        extra_snapshot: t.Callable[[], dict] | None = None,
        capacity: int = 1024,
        mode: str = "continuous",
    ):
        self.registry = registry
        # Co-located processes (a trainer serving its own policy, a
        # custom health exporter) merge their own snapshot into
        # /metrics under their own keys.
        self.extra_snapshot = extra_snapshot
        # Per-connection socket timeout + bounded wait on the batcher
        # future: without these one stalled client (or a wedged engine)
        # pins a ThreadingHTTPServer handler thread FOREVER — the
        # stdlib default is no timeout at all — and a few thousand such
        # clients exhaust the thread pool, i.e. a trivial slow-loris.
        self.request_timeout_s = float(request_timeout_s)
        self.act_timeout_s = float(act_timeout_s)
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.batcher = MicroBatcher(
            registry, max_batch=max_batch, max_wait_ms=max_wait_ms,
            metrics=self.metrics, seed=seed, capacity=capacity, mode=mode,
        )
        # retries=0: the frontend must surface sheds to remote clients
        # immediately (THEY own retry policy); a retrying internal
        # client would double-count sheds and sit on handler threads.
        self.client = PolicyClient(registry, self.batcher, retries=0)
        # Graceful-drain state (docs/SERVING.md "Overload &
        # degradation"): once draining, /healthz answers 503 so load
        # balancers stop routing here, new /act requests are shed with
        # 503 + Retry-After, and the queue flushes through the engine
        # before the process exits — rolling restarts drop zero
        # accepted requests.
        self._draining = False  # guarded-by: _drain_lock
        self._drain_lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            # Socket timeout for the whole connection (stdlib applies
            # the class attribute via connection.settimeout in setup();
            # handle_one_request maps the timeout to close_connection),
            # so a client that stops sending mid-request releases its
            # handler thread instead of wedging it forever.
            timeout = server.request_timeout_s

            # Keep the stdlib's per-request stderr lines out of the
            # serving hot path; route to logging at debug level.
            def log_message(self, fmt, *args):  # noqa: A003
                logger.debug("http: " + fmt, *args)

            def _send(
                self,
                code: int,
                payload: dict,
                headers: dict | None = None,
            ):
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
                    draining = server.draining
                    self._send(
                        503 if draining else 200,
                        {
                            "status": "draining" if draining else "ok",
                            "queue_depth": server.batcher.queue_depth(),
                            "slots": server.registry.slots(),
                        },
                        headers={"Retry-After": "1"} if draining else None,
                    )
                elif self.path == "/metrics":
                    snap = server.metrics.snapshot()
                    # First-use accounting per bucket (serve/engine.py):
                    # `live_compiles` > 0 means a real request ran a
                    # bucket first.
                    comp = server.registry.compile_stats()
                    snap["compiles_total"] = comp["compiles_total"]
                    snap["live_compiles"] = comp["live_compiles"]
                    snap["bundle_compiles"] = comp.get("bundle_compiles", 0)
                    snap["compiles"] = comp["slots"]
                    # Overload containment state: admission bound and
                    # per-slot breaker trips/probes/state.
                    snap["queue_capacity"] = server.batcher.capacity
                    snap["draining"] = server.draining
                    snap["breakers"] = server.registry.breaker_stats()
                    if server.extra_snapshot is not None:
                        try:
                            snap.update(server.extra_snapshot())
                        except Exception as e:  # noqa: BLE001 — the
                            # base snapshot must survive a broken hook
                            snap["extra_snapshot_error"] = repr(e)[:200]
                    self._send(200, snap)
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):  # noqa: N802 — stdlib API
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(length) if length else b"{}"
                    body = json.loads(raw or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    self._send(400, {"error": f"bad JSON body: {e}"})
                    return
                if self.path == "/act":
                    self._act(body)
                elif self.path == "/reload":
                    self._send(200, {
                        "reload": server.registry.reload(body.get("model"))
                    })
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def _act(self, body: dict):
                # Correlation id: client-supplied X-Request-Id or a
                # generated one; echoed on EVERY response (incl. 429/
                # 503) and into the shed/timeout log lines, so a
                # rejection can be matched to its request.
                rid = self.headers.get("X-Request-Id") or uuid.uuid4().hex[:16]
                rid_hdr = {"X-Request-Id": rid}
                if server.draining:
                    logger.warning(
                        "shed request_id=%s reason=draining", rid
                    )
                    self._send(
                        503,
                        {
                            "error": "server is draining; not accepting "
                                     "new requests",
                            "reason": "draining",
                            "request_id": rid,
                        },
                        headers={"Retry-After": "1", **rid_hdr},
                    )
                    return
                slot = body.get("model", "default")
                try:
                    engine, _, _ = server.registry.acquire(slot)
                except KeyError as e:
                    self._send(404, {"error": str(e)}, headers=rid_hdr)
                    return
                if "obs" not in body:
                    self._send(400, {"error": 'missing "obs"'}, headers=rid_hdr)
                    return
                try:
                    obs = _parse_obs(body["obs"], engine.obs_spec)
                    res = server.client.act(
                        obs,
                        deterministic=bool(body.get("deterministic", True)),
                        slot=slot,
                        timeout=server.act_timeout_s,
                        request_id=rid,
                    )
                except ShedError as e:
                    # Admission control / breaker / drain: submit-time
                    # rejections (queue_full, deadline_infeasible) are
                    # 429 — the service is healthy, the RATE is not;
                    # everything else (breaker_open, draining, expired
                    # in queue) is 503 — back off and let the load
                    # balancer try another replica. Both carry
                    # Retry-After from the shed's own estimate.
                    code = 429 if e.reason in SUBMIT_SHED_REASONS else 503
                    retry_after = max(1, math.ceil(e.retry_after_s))
                    logger.warning(
                        "shed request_id=%s slot=%s reason=%s -> %d",
                        rid, slot, e.reason, code,
                    )
                    self._send(
                        code, dict(e.to_payload(), request_id=rid),
                        headers={"Retry-After": str(retry_after), **rid_hdr},
                    )
                    return
                except FutureTimeoutError:
                    # Batcher overload/stall is transient, not a server
                    # bug: 503 + Retry-After tells well-behaved clients
                    # (and load balancers) to back off and retry, where
                    # a generic 500 reads as "broken, page someone".
                    logger.warning(
                        "timeout request_id=%s slot=%s after %.1fs",
                        rid, slot, server.act_timeout_s,
                    )
                    self._send(
                        503,
                        {
                            "error": "policy backend timed out; retry",
                            "timeout_s": server.act_timeout_s,
                            "request_id": rid,
                        },
                        headers={"Retry-After": "1", **rid_hdr},
                    )
                    return
                except (ValueError, TypeError) as e:
                    self._send(400, {"error": str(e)}, headers=rid_hdr)
                    return
                except Exception as e:  # noqa: BLE001 — engine failure
                    logger.exception("act failed (request_id=%s)", rid)
                    self._send(
                        500, {"error": repr(e)[:500], "request_id": rid},
                        headers=rid_hdr,
                    )
                    return
                self._send(200, {
                    "action": np.asarray(res.action).tolist(),
                    "generation": res.generation,
                    "epoch": res.epoch,
                    "model": slot,
                }, headers=rid_hdr)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None  # guarded-by: _drain_lock
        # shutdown() on a loop that NEVER ran blocks forever (stdlib
        # waits on the flag only serve_forever sets); close() skips it
        # unless one of the serve entry points actually started.
        self._loop_started = False  # guarded-by: _drain_lock

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self):
        """Serve on a background daemon thread (tests, smoke)."""
        with self._drain_lock:
            self._loop_started = True
            thread = self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="policy-http",
                daemon=True,
            )
        thread.start()
        return self

    def serve_forever(self):
        """Block serving until interrupted (the CLI path)."""
        with self._drain_lock:
            self._loop_started = True
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:  # pragma: no cover — operator stop
            pass
        finally:
            self.close()

    @property
    def draining(self) -> bool:
        with self._drain_lock:
            return self._draining

    def drain(self, flush_timeout_s: float = 30.0) -> dict:
        """Graceful drain: stop admitting, flush, report.

        From the first call, ``/healthz`` answers 503 ``draining`` (the
        load balancer ejects this replica) and new ``/act`` requests
        are shed with 503 + ``Retry-After`` — then every request
        already accepted flushes through the engine (the batcher close
        path answers its whole queue before joining), so in-flight HTTP
        handlers parked on Futures all complete normally. Idempotent;
        returns what happened so the caller (SIGTERM handler, tests)
        can assert zero accepted requests were dropped."""
        with self._drain_lock:
            first = not self._draining
            self._draining = True
        if first:
            logger.info(
                "draining: admissions stopped, flushing %d queued "
                "requests", self.batcher.queue_depth(),
            )
        self.batcher.close(timeout=flush_timeout_s)
        remaining = self.batcher.queue_depth()
        if remaining:  # pragma: no cover — only a wedged engine
            logger.warning(
                "drain flush left %d requests unanswered after %.1fs",
                remaining, flush_timeout_s,
            )
        snap = self.metrics.snapshot()
        return {
            "drained": remaining == 0,
            "queued_at_exit": remaining,
            "responses_total": snap["responses_total"],
            "sheds_total": snap["sheds_total"],
        }

    def close(self, thread_join_timeout_s: float = 10.0) -> dict:
        """Stop everything; returns a structured result. A server
        thread that survives its join (a handler wedged past every
        timeout) is LOGGED and surfaced in the result instead of
        silently leaking — the caller deciding to exit anyway should
        know a non-daemon-joinable thread is still out there."""
        result = {"server_thread_stopped": True}
        # Read/clear the lifecycle handles under the lock; shutdown()
        # and join() run OUTSIDE it — a wedged handler wanting the
        # drain lock must never deadlock close().
        with self._drain_lock:
            loop_started = self._loop_started
            thread, self._thread = self._thread, None
        if loop_started:
            self._httpd.shutdown()
        self._httpd.server_close()
        if thread is not None:
            thread.join(timeout=thread_join_timeout_s)
            if thread.is_alive():
                logger.warning(
                    "server thread %r still alive after %.1fs join "
                    "(daemon=%s) — leaking it; a handler is wedged "
                    "past its timeouts",
                    thread.name, thread_join_timeout_s, thread.daemon,
                )
                result["server_thread_stopped"] = False
                result["server_thread"] = {
                    "name": thread.name,
                    "daemon": thread.daemon,
                }
        self.batcher.close()
        self.registry.close()
        return result

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def install_drain_handler(
    server: PolicyServer,
    signals: t.Sequence[int] = (signal.SIGTERM,),
    flush_timeout_s: float = 30.0,
) -> t.Callable[[], None]:
    """SIGTERM → graceful drain → clean exit (the rolling-restart
    contract): admissions stop (503 + ``Retry-After``; ``/healthz``
    flips to ``draining``), the queue flushes through the engine, the
    HTTP loop is released — ``serve_forever`` returns, ``close()`` runs
    and the process exits 0 having answered every accepted request.

    The drain runs on a helper thread: a Python signal handler executes
    on the main thread, which for the CLI is the one blocked inside
    ``serve_forever`` — flushing there would deadlock. Must be called
    from the main thread (stdlib ``signal`` requirement). Returns the
    drain trigger so tests can invoke the same path directly."""

    def _drain_and_release():
        try:
            info = server.drain(flush_timeout_s=flush_timeout_s)
            logger.info("drain complete: %s", info)
        finally:
            # Releases serve_forever(); its finally-close() handles the
            # rest. Safe when start() was used instead: shutdown() of a
            # stopped loop is a no-op.
            server._httpd.shutdown()

    def _handler(signum, frame):  # pragma: no cover — exercised via
        # the direct trigger in tests (signal delivery itself is the
        # stdlib's contract, not ours)
        logger.info("signal %d: starting graceful drain", signum)
        threading.Thread(
            target=_drain_and_release, name="drain", daemon=True
        ).start()

    for sig in signals:
        signal.signal(sig, _handler)
    return lambda: threading.Thread(
        target=_drain_and_release, name="drain", daemon=True
    ).start()
