"""Networked staging transport: actor processes push into the learner
(port of the JAX package's ``decoupled/transport.py``; the ``/stage`` wire
format is that package's, byte for byte, so either package's actor feeds
either package's learner).

The process-fleet link of the decoupled plane (docs/RESILIENCE.md
"Decoupled-plane failure modes"): :class:`StagingTransportServer` is a
stdlib HTTP frontend the learner owns, exposing its
:class:`~torch_actor_critic_tpu_torch.decoupled.staging.StagingBuffer` to
actor subprocesses; :class:`RemoteStagingClient` is the actor-side
counterpart that duck-types ``StagingBuffer.put`` so an unmodified
:class:`~torch_actor_critic_tpu_torch.decoupled.actor.ActorWorker` stages
over the wire exactly as it does in-process. Design contract:

- **Bitwise fidelity**: transition arrays travel as base64 raw bytes +
  dtype + shape per leaf — no float->decimal->float round trip — so a
  staged-then-checkpointed tail restores bit-identical whether it was
  produced by the inline actor or a remote process.
- **Strict admission**: a push whose payload is malformed — bad JSON,
  missing fields, wrong dtype/shape, truncated bytes — is rejected
  with **400 before any counter moves**: a poison push cannot corrupt
  the conservation invariant (regression-tested).
- **Idempotent ingestion**: every push carries ``(actor_id,
  incarnation, seq)``; the server keeps a per-actor watermark advanced
  only on *accepted* stagings, so a retried push (response lost in
  flight, learner restarted mid-request) is answered ``duplicate`` and
  never double-staged — the sequence-number audit is exact. A push
  from a superseded incarnation (a SIGKILL-reaped actor's zombie
  request) is answered **410** and never staged.
- **Backpressure over the wire**: the buffer's counted policies map to
  status codes — paused buffer -> **503** + ``Retry-After`` (actors
  idle-spin), shed -> **429** + ``Retry-After``.
- **Bounded retry**: the client retries connection-level failures and
  5xx with jittered exponential backoff (PolicyClient's semantics), never
  past its per-push budget — retrying longer than an epoch only feeds
  the staleness gate — and surfaces exhaustion as
  :class:`StagingUnavailable`, which the ActorWorker's idle-spin
  already handles by retrying the SAME transition (same ``seq``, so
  recovery cannot double-ingest).

The server also proxies ``POST /act`` to the learner's serving plane
(so actor subprocesses run a plain HTTP
:class:`~torch_actor_critic_tpu_torch.serve.server.PolicyClient` against one
base URL), accepts ``POST /heartbeat`` for the fleet supervisor's
liveness table, and reports everything on ``GET /metrics``.
"""

from __future__ import annotations

import base64
import binascii
import collections
import json
import logging
import math
import random
import threading
import time
import typing as t
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from torch_actor_critic_tpu_torch.core.types import MultiObservation
from torch_actor_critic_tpu_torch.decoupled.staging import (
    StagingBuffer,
    StagingUnavailable,
)
from torch_actor_critic_tpu_torch.serve.admission import (
    SUBMIT_SHED_REASONS,
    ShedError,
)

logger = logging.getLogger(__name__)

__all__ = [
    "RemoteStagingClient",
    "StagingTransportServer",
    "canonical_transition",
    "decode_transition",
    "encode_transition",
]

TRANSITION_FIELDS = ("obs", "actions", "rewards", "next_obs", "done")


# --------------------------------------------------------------- wire codec


def _encode_array(x: np.ndarray) -> dict:
    x = np.ascontiguousarray(x)
    return {
        "dtype": str(x.dtype),
        "shape": list(x.shape),
        "data": base64.b64encode(x.tobytes()).decode("ascii"),
    }


def _decode_array(enc: t.Any, dtype, shape: tuple) -> np.ndarray:
    """Decode one leaf, validating dtype/shape/length against the
    expectation BEFORE touching any buffer state — every mismatch is a
    ``ValueError`` the endpoint maps to a counter-neutral 400."""
    if not isinstance(enc, dict):
        raise ValueError(f"array encoding must be a dict, got {type(enc)}")
    want = np.dtype(dtype)
    if str(enc.get("dtype")) != str(want):
        raise ValueError(
            f"dtype mismatch: got {enc.get('dtype')!r}, expected {want}"
        )
    got_shape = tuple(int(d) for d in enc.get("shape", ()))
    if got_shape != tuple(shape):
        raise ValueError(
            f"shape mismatch: got {got_shape}, expected {tuple(shape)}"
        )
    try:
        raw = base64.b64decode(enc.get("data", ""), validate=True)
    except (binascii.Error, TypeError) as e:
        raise ValueError(f"bad base64 array data: {e}") from None
    expected = int(np.prod(shape, dtype=np.int64)) * want.itemsize
    if len(raw) != expected:
        raise ValueError(
            f"array data is {len(raw)} bytes, expected {expected}"
        )
    # .copy(): frombuffer views the b64 bytes read-only; staging owns a
    # writable array like every locally-produced transition.
    return np.frombuffer(raw, dtype=want).reshape(shape).copy()


def _encode_obs(obs: t.Any) -> t.Any:
    if hasattr(obs, "features"):  # MultiObservation pytree
        return {
            "features": _encode_array(np.asarray(obs.features)),
            "frame": _encode_array(np.asarray(obs.frame)),
        }
    return _encode_array(np.asarray(obs))


def _decode_obs(raw: t.Any, obs_spec, n_envs: int) -> t.Any:
    if isinstance(obs_spec, MultiObservation):
        if not isinstance(raw, dict) or set(raw) != {"features", "frame"}:
            raise ValueError(
                'visual obs must encode {"features": ..., "frame": ...}'
            )
        return MultiObservation(
            features=_decode_array(
                raw["features"], obs_spec.features.dtype,
                (n_envs,) + tuple(obs_spec.features.shape),
            ),
            frame=_decode_array(
                raw["frame"], obs_spec.frame.dtype,
                (n_envs,) + tuple(obs_spec.frame.shape),
            ),
        )
    return _decode_array(
        raw, obs_spec.dtype, (n_envs,) + tuple(obs_spec.shape)
    )


def canonical_transition(transition: tuple, obs_spec) -> tuple:
    """Pin a transition's dtypes to the env spec (obs leaves to the
    spec dtype, everything else float32) — the shared canonical form
    both planes stage, so checkpointed staging arrays restore against
    a shape/dtype-stable abstract tree regardless of producer."""
    obs, actions, rewards, next_obs, done = transition
    return (
        _cast_obs(obs, obs_spec),
        np.asarray(actions, np.float32),
        np.asarray(rewards, np.float32),
        _cast_obs(next_obs, obs_spec),
        np.asarray(done, np.float32),
    )


def _cast_obs(obs: t.Any, obs_spec) -> t.Any:
    """``obs`` with each leaf in its spec leaf's dtype."""
    if isinstance(obs_spec, MultiObservation):
        return MultiObservation(
            np.asarray(obs.features, dtype=obs_spec.features.dtype),
            np.asarray(obs.frame, dtype=obs_spec.frame.dtype),
        )
    return np.asarray(obs, dtype=obs_spec.dtype)


def encode_transition(transition: tuple) -> dict:
    """Canonical transition tuple -> JSON-ready wire dict (base64 raw
    bytes per leaf; bitwise-exact round trip)."""
    obs, actions, rewards, next_obs, done = transition
    return {
        "obs": _encode_obs(obs),
        "actions": _encode_array(np.asarray(actions)),
        "rewards": _encode_array(np.asarray(rewards)),
        "next_obs": _encode_obs(next_obs),
        "done": _encode_array(np.asarray(done)),
    }


def decode_transition(
    raw: t.Any, obs_spec, n_envs: int, act_dim: int
) -> tuple:
    """Wire dict -> transition tuple, validated leaf-by-leaf against
    the learner's env spec; raises ``ValueError`` on ANY malformation
    (the 400 path — nothing is staged, no counter moves)."""
    if not isinstance(raw, dict):
        raise ValueError(f"transition must be a dict, got {type(raw)}")
    missing = [f for f in TRANSITION_FIELDS if f not in raw]
    if missing:
        raise ValueError(f"transition missing fields {missing}")
    n = int(n_envs)
    return (
        _decode_obs(raw["obs"], obs_spec, n),
        _decode_array(raw["actions"], np.float32, (n, int(act_dim))),
        _decode_array(raw["rewards"], np.float32, (n,)),
        _decode_obs(raw["next_obs"], obs_spec, n),
        _decode_array(raw["done"], np.float32, (n,)),
    )


def _require_int(body: dict, key: str, minimum: int | None = None) -> int:
    v = body.get(key)
    if not isinstance(v, int) or isinstance(v, bool):
        raise ValueError(f'"{key}" must be an integer, got {v!r}')
    if minimum is not None and v < minimum:
        raise ValueError(f'"{key}" must be >= {minimum}, got {v}')
    return v


# ------------------------------------------------------------- server side


class _ActorEntry:
    """Liveness + idempotency state for one fleet actor. Every field is
    guarded by the owning server's ``_lock``; ``lock`` additionally
    serializes this actor's dedup-check -> stage -> watermark-advance
    sequences end-to-end WITHOUT holding the global lock across a
    (possibly blocking) ``staging.put`` — one actor waiting out
    backpressure must not stall every other actor's pushes and
    heartbeats. Ordering: ``lock`` before ``_lock``, never the
    reverse."""

    __slots__ = (
        "lock", "incarnation", "seq", "accepted_total",
        "duplicates_total", "pid", "steps", "last_heartbeat",
        "heartbeats_total", "hb_incarnation",
    )

    def __init__(self, incarnation: int, now: float):
        self.lock = threading.Lock()
        self.incarnation = incarnation
        # The incarnation whose heartbeat ``last_heartbeat`` is: a retire
        # bumps ``incarnation`` (the fence) but not this, so the
        # supervisor never reads a reaped actor's old heartbeat as its
        # successor's and gives a fresh spawn its start-up grace. (The
        # JAX transport reports the fence incarnation, and a respawned
        # actor whose start takes longer than the heartbeat deadline is
        # then declared dead before its first beat, again and again.)
        self.hb_incarnation = incarnation
        self.seq = -1  # highest ACCEPTED seq for this incarnation
        self.accepted_total = 0
        self.duplicates_total = 0
        self.pid = 0
        self.steps = 0
        self.last_heartbeat = now
        self.heartbeats_total = 0


class StagingTransportServer:
    """Learner-side HTTP endpoint for the actor-process fleet.

    Routes (all JSON):

    - ``POST /stage`` — push one canonical transition (module
      docstring wire contract). 200 ``{"accepted": true, "duplicate":
      bool}`` / 400 malformed / 410 superseded incarnation / 429 shed
      / 503 paused.
    - ``POST /heartbeat`` — liveness ping ``{actor_id, incarnation,
      pid, steps}`` feeding the supervisor's deadline check.
    - ``POST /act`` — proxy into the learner's serving plane via the
      injected ``act`` callable, same surface as ``PolicyServer /act``
      (actors run a plain HTTP PolicyClient against this one URL).
    - ``GET /healthz``, ``GET /metrics``.

    Dedup check -> staging insert -> watermark advance run under a
    **per-actor lock**, so concurrent retries of the same
    ``(incarnation, seq)`` — a client timing out while its first
    request is still in flight — can never double-stage, while a
    ``block``-backpressure wait stalls only that actor's lane, never
    other actors' pushes or anyone's heartbeats (those take only the
    global ``_lock``). A push whose incarnation was superseded *during*
    its staging wait is swept back out of the buffer (counted
    ``dropped_dead_actor``) and answered 410 — the retire-time purge
    plus this post-put fence together guarantee nothing from a reaped
    actor survives.
    """

    def __init__(
        self,
        staging: StagingBuffer,
        obs_spec,
        n_envs: int,
        act_dim: int,
        act: t.Callable[..., t.Any] | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        request_timeout_s: float = 30.0,
        clock: t.Callable[[], float] = time.monotonic,
    ):
        self.staging = staging
        self.obs_spec = obs_spec
        self.n_envs = int(n_envs)
        self.act_dim = int(act_dim)
        self._act = act
        self._clock = clock
        self.request_timeout_s = float(request_timeout_s)
        self._lock = threading.Lock()
        self._actors: t.Dict[int, _ActorEntry] = {}  # guarded-by: _lock
        # Transport-level outcomes (conservation lives in the staging
        # counters; these account for what never reached the buffer).
        self.pushes_total = 0  # guarded-by: _lock
        self.accepted_total = 0  # guarded-by: _lock
        self.duplicate_pushes_total = 0  # guarded-by: _lock
        self.rejected_malformed_total = 0  # guarded-by: _lock
        self.rejected_zombie_total = 0  # guarded-by: _lock
        self.unavailable_503_total = 0  # guarded-by: _lock
        self.shed_429_total = 0  # guarded-by: _lock
        self.heartbeats_total = 0  # guarded-by: _lock
        self.acts_total = 0  # guarded-by: _lock
        # Trace stitching: when a RequestSpanLog is attached
        # (fleet runs with tracing on), every ACCEPTED push records an
        # ingest span carrying its ``a<actor>.<incarnation>.<seq>``
        # span id, and the id queues for the learner to tag onto the
        # drain window that consumes it. Default None — the staging
        # hot path pays one pointer check, the ``telemetry=None``
        # contract.
        self.span_log = None  # RequestSpanLog | None
        self._recent_span_ids: t.Deque[str] = (  # guarded-by: _lock
            collections.deque(maxlen=4096)
        )
        server = self

        class Handler(BaseHTTPRequestHandler):
            # Per-connection socket timeout (same slow-loris rationale
            # as PolicyServer): a stalled actor releases its handler
            # thread instead of pinning it.
            timeout = server.request_timeout_s

            def log_message(self, fmt, *args):  # noqa: A003
                logger.debug("transport http: " + fmt, *args)

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
                    paused = server.staging.paused
                    # Health, not just liveness: the probe
                    # carries the conservation invariant and depth so
                    # one GET distinguishes "up" from "healthy" — the
                    # ObsCollector scrapes this and the SLO engine
                    # alarms on conservation_ok going false.
                    self._send(200, {
                        "status": "paused" if paused else "ok",
                        "staging_depth": server.staging.depth(),
                        "conservation_ok": (
                            server.staging.conservation_holds()
                        ),
                        "actors": len(server.liveness()),
                    })
                elif self.path == "/metrics":
                    self._send(200, {
                        "transport": server.snapshot(),
                        "staging": server.staging.snapshot(),
                    })
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):  # noqa: N802 — stdlib API
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(length) if length else b"{}"
                    body = json.loads(raw or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                except (ValueError, json.JSONDecodeError) as e:
                    if self.path == "/stage":
                        server._note_malformed()
                    self._send(400, {"error": f"bad JSON body: {e}"})
                    return
                if self.path == "/stage":
                    code, payload, headers = server.handle_stage(body)
                    self._send(code, payload, headers=headers)
                elif self.path == "/heartbeat":
                    code, payload = server.handle_heartbeat(body)
                    self._send(code, payload)
                elif self.path == "/act":
                    self._proxy_act(body)
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def _proxy_act(self, body: dict):
                if server._act is None:
                    self._send(404, {
                        "error": "this transport has no serving proxy",
                    })
                    return
                if "obs" not in body:
                    self._send(400, {"error": 'missing "obs"'})
                    return
                from torch_actor_critic_tpu_torch.serve.server import _parse_obs

                try:
                    obs = _parse_obs(body["obs"], server.obs_spec)
                    res = server._act(
                        obs, bool(body.get("deterministic", False))
                    )
                except ShedError as e:
                    code = (
                        429 if e.reason in SUBMIT_SHED_REASONS else 503
                    )
                    self._send(
                        code, e.to_payload(),
                        headers={"Retry-After": str(
                            max(1, math.ceil(e.retry_after_s))
                        )},
                    )
                    return
                except FutureTimeoutError:
                    self._send(
                        503,
                        {"error": "policy backend timed out; retry"},
                        headers={"Retry-After": "1"},
                    )
                    return
                except (ValueError, TypeError) as e:
                    self._send(400, {"error": str(e)})
                    return
                except Exception as e:  # noqa: BLE001 — engine fault
                    logger.exception("transport /act proxy failed")
                    self._send(500, {"error": repr(e)[:500]})
                    return
                server._note_act()
                self._send(200, {
                    "action": np.asarray(res.action).tolist(),
                    "generation": int(res.generation),
                    "epoch": res.epoch,
                })

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None  # guarded-by: _lock

    # --------------------------------------------------------- endpoints

    def _note_malformed(self) -> None:
        with self._lock:
            self.pushes_total += 1
            self.rejected_malformed_total += 1

    def _note_act(self) -> None:
        with self._lock:
            self.acts_total += 1

    def handle_stage(
        self, body: dict
    ) -> t.Tuple[int, dict, dict | None]:
        """Validate -> dedup -> stage -> advance watermark; returns
        ``(status, payload, headers)``. Exposed for direct unit tests —
        the HTTP handler is a thin shim over this."""
        span_log = self.span_log
        t_ingest = time.perf_counter() if span_log is not None else 0.0
        try:
            actor_id = _require_int(body, "actor_id", minimum=0)
            incarnation = _require_int(body, "incarnation", minimum=0)
            seq = _require_int(body, "seq", minimum=0)
            generation = _require_int(body, "generation")
            epoch = body.get("epoch")
            if epoch is not None and (
                not isinstance(epoch, int) or isinstance(epoch, bool)
            ):
                raise ValueError(f'"epoch" must be an int or null, got '
                                 f'{epoch!r}')
            transition = decode_transition(
                body.get("transition"), self.obs_spec,
                self.n_envs, self.act_dim,
            )
        except ValueError as e:
            # The poison-push contract: reject BEFORE any buffer or
            # watermark state moves — conservation counters untouched.
            self._note_malformed()
            return 400, {"error": str(e)}, None
        with self._lock:
            entry = self._actors.get(actor_id)
            if entry is None:
                entry = self._actors[actor_id] = _ActorEntry(
                    incarnation, self._clock()
                )
        with entry.lock:
            with self._lock:
                self.pushes_total += 1
                if incarnation < entry.incarnation:
                    # A SIGKILL-reaped actor's zombie request: its
                    # staged tail was purged; nothing from it may land
                    # again.
                    self.rejected_zombie_total += 1
                    return 410, {
                        "error": "incarnation superseded",
                        "incarnation": entry.incarnation,
                    }, None
                if incarnation > entry.incarnation:
                    entry.incarnation = incarnation
                    entry.seq = -1
                if seq <= entry.seq:
                    # Retried push whose original was ACCEPTED
                    # (response lost in flight): answer success, stage
                    # nothing.
                    self.duplicate_pushes_total += 1
                    entry.duplicates_total += 1
                    return 200, {
                        "accepted": True, "duplicate": True,
                    }, None
            try:
                # Outside _lock: a block-policy wait stalls only this
                # actor's lane (entry.lock), never heartbeats or other
                # actors. Same-actor retries still serialize here.
                accepted = self.staging.put(
                    transition, generation=generation, epoch=epoch,
                    actor_id=actor_id,
                )
            except StagingUnavailable:
                with self._lock:
                    self.unavailable_503_total += 1
                return 503, {
                    "error": "staging paused (learner checkpointing "
                             "or draining); retry",
                    "reason": "staging_paused",
                }, {"Retry-After": "1"}
            if not accepted:
                with self._lock:
                    self.shed_429_total += 1
                return 429, {
                    "error": "staging backpressure shed",
                    "reason": "staging_shed",
                }, {"Retry-After": "1"}
            landed = False
            with self._lock:
                if entry.incarnation != incarnation:
                    # Superseded mid-put: retire_actor's purge ran
                    # before this landed. Sweep it back out (counted
                    # dropped_dead_actor — conservation intact) and
                    # fence the zombie.
                    self.rejected_zombie_total += 1
                    superseded = entry.incarnation
                else:
                    entry.seq = seq
                    entry.accepted_total += 1
                    self.accepted_total += 1
                    landed = True
                    if span_log is not None:
                        self._recent_span_ids.append(
                            f"a{actor_id}.{incarnation}.{seq}"
                        )
            if landed:
                if span_log is not None:
                    span_log.record({
                        "name": "stage_ingest",
                        "t0": t_ingest,
                        "t1": time.perf_counter(),
                        "span_id": f"a{actor_id}.{incarnation}.{seq}",
                        "actor_id": actor_id,
                        "incarnation": incarnation,
                        "seq": seq,
                        "outcome": "accepted",
                    })
                return 200, {
                    "accepted": True, "duplicate": False,
                }, None
            # Still under entry.lock: the successor incarnation's
            # pushes are queued behind this lane, so the sweep can only
            # catch the zombie's own transition, never theirs.
            self.staging.purge_actor(actor_id)
            return 410, {
                "error": "incarnation superseded",
                "incarnation": superseded,
            }, None

    def handle_heartbeat(self, body: dict) -> t.Tuple[int, dict]:
        try:
            actor_id = _require_int(body, "actor_id", minimum=0)
            incarnation = _require_int(body, "incarnation", minimum=0)
        except ValueError as e:
            return 400, {"error": str(e)}
        with self._lock:
            entry = self._actors.get(actor_id)
            if entry is None:
                entry = self._actors[actor_id] = _ActorEntry(
                    incarnation, self._clock()
                )
            if incarnation < entry.incarnation:
                self.rejected_zombie_total += 1
                return 410, {
                    "error": "incarnation superseded",
                    "incarnation": entry.incarnation,
                }
            if incarnation > entry.incarnation:
                entry.incarnation = incarnation
                entry.seq = -1
            entry.last_heartbeat = self._clock()
            entry.hb_incarnation = incarnation
            entry.pid = int(body.get("pid", 0))
            entry.steps = int(body.get("steps", 0))
            entry.heartbeats_total += 1
            self.heartbeats_total += 1
            return 200, {"ok": True}

    # -------------------------------------------------- supervisor bridge

    def liveness(self) -> t.Dict[int, dict]:
        """Per-actor liveness view for the fleet supervisor's deadline
        check: heartbeat age (via the injected clock), the incarnation
        that heartbeat came from, pid, reported steps."""
        now = self._clock()
        with self._lock:
            return {
                aid: {
                    "age_s": now - e.last_heartbeat,
                    "incarnation": e.hb_incarnation,
                    "pid": e.pid,
                    "steps": e.steps,
                }
                for aid, e in self._actors.items()
            }

    def retire_actor(self, actor_id: int, incarnation: int) -> int:
        """Supersede a dead actor's incarnation, then purge its staged
        tail; returns the purge count. The watermark bump happens
        FIRST (under ``_lock``, serialized with every in-flight stage)
        so a zombie request racing the purge is 410-rejected instead
        of re-staging after the purge swept."""
        with self._lock:
            entry = self._actors.get(actor_id)
            if entry is None:
                # The actor died before ever making contact (e.g. the
                # spawn-grace deadline): fence it anyway so a late
                # first push from the reaped process cannot land.
                entry = _ActorEntry(incarnation, self._clock())
                self._actors[actor_id] = entry
            if entry.incarnation <= incarnation:
                entry.incarnation = incarnation + 1
                entry.seq = -1
        return self.staging.purge_actor(actor_id)

    # ------------------------------------------------- checkpoint bridge

    def watermarks(self) -> dict:
        """JSON-ready per-actor idempotency state for the checkpoint:
        a resumed learner restores these so a push retried across its
        restart is still deduplicated (keys stringified for JSON)."""
        with self._lock:
            return {
                str(aid): {
                    "incarnation": e.incarnation,
                    "seq": e.seq,
                    "accepted_total": e.accepted_total,
                    "duplicates_total": e.duplicates_total,
                }
                for aid, e in self._actors.items()
            }

    def load_watermarks(self, marks: t.Mapping[str, t.Any]) -> None:
        now = self._clock()
        with self._lock:
            for aid, m in (marks or {}).items():
                entry = _ActorEntry(int(m.get("incarnation", 0)), now)
                entry.seq = int(m.get("seq", -1))
                entry.accepted_total = int(m.get("accepted_total", 0))
                entry.duplicates_total = int(m.get("duplicates_total", 0))
                self._actors[int(aid)] = entry

    # ----------------------------------------------------- introspection

    def take_recent_span_ids(self) -> t.List[str]:
        """Drain the span ids of pushes accepted since the last call —
        the learner tags them onto the drain-window span that consumed
        them (trace stitching). Empty unless a span_log is attached."""
        with self._lock:
            ids = list(self._recent_span_ids)
            self._recent_span_ids.clear()
        return ids

    def snapshot(self) -> dict:
        now = self._clock()
        with self._lock:
            return {
                "pushes_total": self.pushes_total,
                "accepted_total": self.accepted_total,
                "duplicate_pushes_total": self.duplicate_pushes_total,
                "rejected_malformed_total": self.rejected_malformed_total,
                "rejected_zombie_total": self.rejected_zombie_total,
                "unavailable_503_total": self.unavailable_503_total,
                "shed_429_total": self.shed_429_total,
                "heartbeats_total": self.heartbeats_total,
                "acts_total": self.acts_total,
                "actors": {
                    str(aid): {
                        "incarnation": e.incarnation,
                        "seq": e.seq,
                        "accepted_total": e.accepted_total,
                        "duplicates_total": e.duplicates_total,
                        "pid": e.pid,
                        "steps": e.steps,
                        "heartbeat_age_s": now - e.last_heartbeat,
                        "heartbeats_total": e.heartbeats_total,
                    }
                    for aid, e in self._actors.items()
                },
            }

    # ---------------------------------------------------------- lifecycle

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "StagingTransportServer":
        thread = threading.Thread(
            target=self._httpd.serve_forever, name="staging-transport",
            daemon=True,
        )
        with self._lock:
            self._thread = thread
        thread.start()
        return self

    def close(self, thread_join_timeout_s: float = 10.0) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        if thread is not None:
            thread.join(timeout=thread_join_timeout_s)
            if thread.is_alive():  # pragma: no cover — wedged handler
                logger.warning(
                    "transport thread still alive after %.1fs join; "
                    "leaking it", thread_join_timeout_s,
                )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -------------------------------------------------------------- actor side


class RemoteStagingClient:
    """Actor-process staging handle: ``put`` pushes one transition to
    the learner's :class:`StagingTransportServer`, with the module
    docstring's retry/idempotency contract. Duck-types
    ``StagingBuffer.put`` so :class:`ActorWorker.stage` drives it
    unmodified; a paused/unreachable learner surfaces as
    :class:`StagingUnavailable` and the worker's existing idle-spin
    retries the SAME transition (same ``seq`` — dedup makes the retry
    safe even when the first attempt was accepted and only the
    response was lost).

    ``post`` is the transport seam: a callable ``(path, payload,
    timeout_s) -> (status, payload_dict)`` raising ``OSError`` on
    connection-level failure. The default is a stdlib urllib POST;
    :class:`~torch_actor_critic_tpu_torch.resilience.faultinject.
    FlakyTransport` wraps it to inject drops/latency underneath the
    retry loop.
    """

    def __init__(
        self,
        url: str,
        actor_id: int,
        incarnation: int = 0,
        retry_budget_s: float = 2.0,
        request_timeout_s: float = 5.0,
        backoff_s: float = 0.05,
        sleep: t.Callable[[float], None] = time.sleep,
        rng: random.Random | None = None,
        post: t.Callable[..., t.Tuple[int, dict]] | None = None,
        start_seq: int = 0,
    ):
        if retry_budget_s <= 0:
            raise ValueError(
                f"retry_budget_s must be > 0, got {retry_budget_s}"
            )
        self.url = url.rstrip("/")
        self.actor_id = int(actor_id)
        self.incarnation = int(incarnation)
        self.retry_budget_s = float(retry_budget_s)
        self.request_timeout_s = float(request_timeout_s)
        self.backoff_s = float(backoff_s)
        self._sleep = sleep
        self._rng = rng if rng is not None else random.Random()
        self._post = post if post is not None else self._http_post
        self._next_seq = int(start_seq)
        # Trace stitching: when set, a callable fed one record
        # per ACCEPTED push — the actor loop points it at a JsonlSink
        # under the run dir so the learner's trace export can stitch
        # this process's ``stage_push`` spans (same
        # ``a<actor>.<incarnation>.<seq>`` id the transport stamps on
        # its ingest span) into the one run timeline. Default None:
        # the push hot path pays one pointer check.
        self.span_sink: t.Callable[[dict], None] | None = None
        # Counted outcomes (client side of the sequence audit).
        self.pushes_total = 0
        self.accepted_total = 0
        self.duplicates_total = 0
        self.shed_total = 0
        self.retries_total = 0
        self.unavailable_total = 0
        self.heartbeat_failures_total = 0

    def _http_post(
        self, path: str, payload: dict, timeout_s: float
    ) -> t.Tuple[int, dict]:
        import urllib.error as urlerr
        import urllib.request as urlreq

        req = urlreq.Request(
            self.url + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            with urlreq.urlopen(req, timeout=timeout_s) as resp:
                return resp.status, json.loads(resp.read())
        except urlerr.HTTPError as e:
            try:
                body = json.loads(e.read())
            except (ValueError, OSError):
                body = {}
            return e.code, body

    # -------------------------------------------------------------- push

    def put(
        self,
        transition: tuple,
        generation: int = 0,
        epoch: int | None = None,
        timeout_s: float | None = None,
        actor_id: int = -1,
    ) -> bool:
        """Push one tagged transition; True = accepted (or already
        accepted — a deduplicated retry), False = shed by the server's
        backpressure policy. Raises :class:`StagingUnavailable` when
        the learner is paused/unreachable past the retry budget — the
        caller keeps the transition and calls again (same ``seq``).
        ``actor_id`` is accepted for ``StagingBuffer.put`` duck-parity
        and ignored: this client IS one actor."""
        del actor_id  # the constructor's actor identity is authoritative
        seq = self._next_seq
        payload = {
            "actor_id": self.actor_id,
            "incarnation": self.incarnation,
            "seq": seq,
            "generation": int(generation),
            "epoch": int(epoch) if epoch is not None else None,
            "transition": encode_transition(transition),
        }
        budget = float(
            timeout_s if timeout_s is not None else self.retry_budget_s
        )
        deadline = time.monotonic() + budget
        attempt = 0
        self.pushes_total += 1
        t_push = (
            time.perf_counter() if self.span_sink is not None else 0.0
        )
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self.unavailable_total += 1
                raise StagingUnavailable(
                    f"push retry budget of {budget:.2f}s exhausted "
                    f"(seq {seq}); retry the same transition"
                )
            try:
                status, out = self._post(
                    "/stage", payload,
                    min(self.request_timeout_s, remaining),
                )
            except (OSError, FutureTimeoutError, TimeoutError) as e:
                # Connection-level failure: the push may or may not
                # have landed — retry the SAME seq (dedup absorbs the
                # ambiguity) within the budget.
                retry_after = 0.0
                err: t.Any = e
            else:
                if status == 200:
                    self._next_seq = seq + 1
                    if out.get("duplicate"):
                        self.duplicates_total += 1
                    else:
                        self.accepted_total += 1
                    if self.span_sink is not None:
                        self._record_push_span(t_push, seq, out)
                    return True
                if status == 429:
                    # Counted server-side shed; the transition is gone
                    # by policy, not by accident — move on.
                    self._next_seq = seq + 1
                    self.shed_total += 1
                    return False
                if status == 503:
                    # Paused buffer / learner draining: idle-spin land.
                    self.unavailable_total += 1
                    raise StagingUnavailable(
                        out.get("error", "staging paused; retry")
                    )
                if status == 410:
                    raise RuntimeError(
                        "this actor incarnation was superseded by the "
                        "supervisor; exiting is the only correct move"
                    )
                if status < 500:
                    # 4xx: a malformed push is a BUG — surface it.
                    raise ValueError(
                        f"stage push rejected with HTTP {status}: "
                        f"{out.get('error', '')}"
                    )
                retry_after = 1.0
                err = f"HTTP {status}: {out.get('error', '')}"
            delay = max(retry_after, self.backoff_s * (2 ** attempt))
            delay *= 1.0 + 0.25 * self._rng.random()  # jitter
            if time.monotonic() + delay >= deadline:
                self.unavailable_total += 1
                raise StagingUnavailable(
                    f"staging push failing ({err}) and the "
                    f"{budget:.2f}s retry budget is exhausted; retry "
                    "the same transition"
                )
            self.retries_total += 1
            attempt += 1
            self._sleep(delay)

    def _record_push_span(self, t_push: float, seq: int, out: dict):
        """One accepted push -> one span record, with ABSOLUTE
        microsecond timestamps (this process anchors its own wall
        clock) so the learner-side trace merge needs no alien perf
        anchor. Sink failures must not break staging."""
        import os

        from torch_actor_critic_tpu_torch.telemetry.traceview import perf_to_us

        try:
            self.span_sink({
                "name": "stage_push",
                "ts_us": perf_to_us(t_push),
                "dur_us": (time.perf_counter() - t_push) * 1e6,
                "span_id": (
                    f"a{self.actor_id}.{self.incarnation}.{seq}"
                ),
                "actor_id": self.actor_id,
                "incarnation": self.incarnation,
                "seq": seq,
                "outcome": (
                    "duplicate" if out.get("duplicate") else "accepted"
                ),
                "os_pid": os.getpid(),
            })
        except Exception:  # noqa: BLE001 - tracing must never fail a push
            logger.debug("push span record failed", exc_info=True)

    # --------------------------------------------------------- heartbeat

    def heartbeat(self, pid: int, steps: int) -> bool:
        """One liveness ping; False on delivery failure (counted, never
        raised — heartbeat LOSS is precisely the signal the supervisor
        acts on, so the actor must not die of it). A 410 means this
        incarnation was superseded and is re-raised as RuntimeError."""
        try:
            status, _ = self._post(
                "/heartbeat",
                {
                    "actor_id": self.actor_id,
                    "incarnation": self.incarnation,
                    "pid": int(pid),
                    "steps": int(steps),
                },
                self.request_timeout_s,
            )
        except (OSError, FutureTimeoutError, TimeoutError):
            self.heartbeat_failures_total += 1
            return False
        if status == 410:
            raise RuntimeError(
                "heartbeat rejected: this actor incarnation was "
                "superseded by the supervisor"
            )
        if status != 200:
            self.heartbeat_failures_total += 1
            return False
        return True

    def stats(self) -> dict:
        return {
            "actor_id": self.actor_id,
            "incarnation": self.incarnation,
            "next_seq": self._next_seq,
            "pushes_total": self.pushes_total,
            "accepted_total": self.accepted_total,
            "duplicates_total": self.duplicates_total,
            "shed_total": self.shed_total,
            "retries_total": self.retries_total,
            "unavailable_total": self.unavailable_total,
            "heartbeat_failures_total": self.heartbeat_failures_total,
        }
