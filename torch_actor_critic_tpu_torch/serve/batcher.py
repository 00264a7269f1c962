"""Thread-safe micro-batching queue in front of the policy engine.

Port of ``serve/batcher.py``: the same grouping, admission, deadline,
breaker and per-request span semantics. An observation is a numpy
array (flat or history) or a :class:`MultiObservation` of two (a visual
slot's features and uint8 frame), batched along the leading axis of
every leaf. The sampled-action stream is one ``torch.Generator`` on the
engine's device, seeded from ``seed`` at first use (it serves every
slot; a graphed engine borrows its state for each sampled replay) and
saved/restored through :meth:`MicroBatcher.export_key` /
:meth:`MicroBatcher.import_key` (``get_state``/``set_state``).

The server-side dynamic-batching pattern (TorchBeast, arXiv:1910.03552;
Podracer, arXiv:2104.06272): concurrent ``act(obs)`` calls land in one
queue, and a single dispatcher thread coalesces them into engine
forwards of up to ``max_batch`` rows — waiting at most ``max_wait_ms``
past the oldest queued request before flushing whatever it has. One
forward per coalesced group amortizes dispatch latency across every
caller in it; the engine pads the group to its bucket shape
(:mod:`~torch_actor_critic_tpu_torch.serve.engine`), and responses are
sliced back per request, so callers never observe the batching.

Grouping rules:

- only requests with the same ``(slot, deterministic)`` share a
  forward (different slots are different params; the deterministic
  flag is a static compile argument);
- a request with more rows than ``max_batch`` is **split** into
  max_batch-sized engine calls and its rows reassembled in order;
- queue order is preserved within a group, and every request —
  including ones drained during shutdown — gets its future resolved:
  nothing is dropped.

Two collection **modes** (docs/SERVING.md "Continuous batching"):

- ``"continuous"`` (default) — admit-into-next-dispatch: whenever the
  engine is free, everything queued is dispatched immediately, up to
  the bucket ladder's top. The *forward itself* is the batching
  window: rows arriving while the engine runs the previous group form
  the next one, so sustained load still fills buckets while a lone
  request at low load pays zero coalescing wait (p50 drops by
  ``max_wait_ms``). Selection is priority-ordered off the
  requests' deadline metadata — the request nearest its deadline picks the
  ``(slot, deterministic)`` class and orders the group, so
  near-deadline rows preempt batch-filling instead of aging out
  behind deadline-free traffic.
- ``"group"`` — the original boundary-waiting semantics, kept as a
  compat mode and pinned by tests: the dispatcher holds the forming
  group up to ``max_wait_ms`` past the oldest request hoping to fill
  ``max_batch`` rows, strict FIFO within a class.

Responses are **bitwise identical across modes** for deterministic
requests: grouping only changes which padded forward a row rides in,
and the engine's row-wise/batch-shape-invariance guarantee
(:mod:`~torch_actor_critic_tpu_torch.serve.engine`) makes that invisible
(pinned by tests/test_fleet.py).

Each response carries the model **generation** it was computed under
(:mod:`~torch_actor_critic_tpu_torch.serve.registry`): the dispatcher
captures ``(engine, params, generation)`` once per group, so a
hot-reload swap mid-group simply means the group finishes on the old
weights and the next group picks up the new ones.

Admission control (docs/SERVING.md "Overload & degradation"): the
queue is **bounded** (``capacity``) and every request may carry a
deadline. Submit-time rejection — queue full, deadline provably
infeasible at the measured service rate, draining, or the slot's
circuit breaker open — raises a structured
:class:`~torch_actor_critic_tpu_torch.serve.admission.ShedError` instead of
queueing work that cannot be served in time; requests whose deadline
expires *while queued* are purged at group-collection time (futures
failed, never dispatched), so the accelerator only ever runs live
work. The circuit breaker
(:mod:`~torch_actor_critic_tpu_torch.serve.breaker`) is consulted once per
group: open means the whole group fails fast with 503-semantics, and
engine outcomes (success / raised / non-finite actions) feed back into
it.
"""

from __future__ import annotations

import collections
import threading
import time
import typing as t
from concurrent.futures import Future

import numpy as np
import torch

from torch_actor_critic_tpu_torch.core.types import MultiObservation
from torch_actor_critic_tpu_torch.serve.admission import (
    BreakerOpenError,
    ShedError,
)
from torch_actor_critic_tpu_torch.serve.engine import obs_rows
from torch_actor_critic_tpu_torch.serve.metrics import ServeMetrics

__all__ = ["MicroBatcher", "ActResult"]


def _concat(obs_list):
    """Requests' observations joined along the batch axis, leaf by leaf."""
    if isinstance(obs_list[0], MultiObservation):
        return MultiObservation(
            np.concatenate([o.features for o in obs_list], axis=0),
            np.concatenate([o.frame for o in obs_list], axis=0),
        )
    return np.concatenate(obs_list, axis=0)


def _slice(obs, lo: int, hi: int):
    if isinstance(obs, MultiObservation):
        return MultiObservation(obs.features[lo:hi], obs.frame[lo:hi])
    return obs[lo:hi]


class ActResult(t.NamedTuple):
    """One resolved ``act`` call: the action rows (leading axis matches
    the request's), the model generation that computed them, and the
    training epoch those params were published at (``None`` for params
    that never came from a checkpoint/publish — e.g. directly-seeded
    test slots). Decoupled actors stamp every transition with these two
    (docs/RESILIENCE.md "Decoupled-plane failure modes"): the epoch is
    the durable staleness key (it survives a serving-worker restart,
    which resets the per-process generation counter)."""

    action: np.ndarray
    generation: int
    epoch: int | None = None


class _Request:
    __slots__ = (
        "obs", "rows", "slot", "deterministic", "future", "t_enq",
        "deadline", "request_id", "t_collect",
    )

    def __init__(
        self, obs, rows, slot, deterministic, deadline_s=None,
        request_id=None,
    ):
        self.obs = obs
        self.rows = rows
        self.slot = slot
        self.deterministic = deterministic
        self.future: Future = Future()
        self.t_enq = time.perf_counter()
        # Absolute perf_counter deadline; None = the caller will wait
        # forever, so the request can never expire in the queue.
        self.deadline = (
            self.t_enq + deadline_s if deadline_s is not None else None
        )
        # Correlation id for the per-request trace span and the shed/
        # breaker records (the HTTP frontend's X-Request-Id).
        self.request_id = request_id
        self.t_collect: float | None = None


class MicroBatcher:
    """Coalesces concurrent policy requests into bucketed forwards.

    ``registry`` resolves slot names to ``(engine, params, generation)``
    (:class:`~torch_actor_critic_tpu_torch.serve.registry.ModelRegistry`).
    ``max_batch`` bounds rows per engine call; ``max_wait_ms`` bounds
    the queueing latency added to the OLDEST request in a group (a lone
    request never waits longer than the deadline) — ``"group"`` mode
    only; ``"continuous"`` mode (the default, see the module docstring)
    never waits on a non-empty queue. ``seed`` seeds the sampled-action
    generator. ``capacity`` bounds the number of QUEUED requests —
    the overload backstop: submit past it raises
    :class:`~torch_actor_critic_tpu_torch.serve.admission.ShedError`
    (``queue_full``) instead of growing host memory without bound.
    """

    def __init__(
        self,
        registry,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        metrics: ServeMetrics | None = None,
        seed: int = 0,
        capacity: int = 1024,
        span_log=None,
        mode: str = "continuous",
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if mode not in ("continuous", "group"):
            raise ValueError(
                f"mode must be 'continuous' or 'group', got {mode!r}"
            )
        self.registry = registry
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.capacity = int(capacity)
        self.mode = mode
        self.metrics = metrics if metrics is not None else ServeMetrics()
        # Optional per-request span recording
        # (telemetry.traceview.RequestSpanLog): every instrumentation
        # point below is one `is not None` check when detached.
        self.span_log = span_log
        self._seed = int(seed)
        # Created on the first sampled group, on that engine's device;
        # a state imported before then is applied at creation.
        self._generator: torch.Generator | None = None  # guarded-by: _lock
        self._pending_state: torch.Tensor | None = None  # guarded-by: _lock
        self._queue: collections.deque[_Request] = (  # guarded-by: _lock
            collections.deque()
        )
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        # Measured service rate (EMA of seconds per dispatched row),
        # written by the dispatcher after each group, read under the
        # lock by submit-time deadline-feasibility checks.
        self._ema_row_s: float | None = None  # guarded-by: _lock
        self._ema_samples = 0  # guarded-by: _lock
        # Rows popped off the queue but not yet resolved (the group
        # currently inside the engine). The fleet's least-loaded
        # dispatcher reads load_rows() = queued + in-flight: a replica
        # mid-forward with an empty queue is NOT idle.
        self._inflight_rows = 0  # guarded-by: _lock
        self._running = True  # guarded-by: _lock
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="micro-batcher", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------- submit

    def submit(
        self,
        obs: t.Any,
        deterministic: bool = True,
        slot: str = "default",
        deadline_s: float | None = None,
        request_id: str | None = None,
    ) -> Future:
        """Enqueue one request; returns a Future resolving to
        :class:`ActResult`. ``obs`` is a single observation or a
        batch of them (leading axis); the response's leading axis
        matches the request's.

        ``deadline_s`` is the caller's patience: past it the request is
        worthless, so it is rejected up front when provably infeasible
        at the measured service rate, and purged (future failed, never
        dispatched) if it expires while queued. Admission failures
        raise :class:`~torch_actor_critic_tpu_torch.serve.admission.ShedError`
        with a machine-readable reason. ``request_id`` threads through
        the per-request trace span and shed records."""
        engine, _, _ = self.registry.acquire(slot)  # validates slot name
        breaker = self.registry.breaker(slot)
        if breaker is not None and not breaker.admits():
            # Fail fast while the slot's engine is tripped open: no
            # queue slot, no accelerator work, a concrete retry hint.
            self.metrics.record_shed("breaker_open")
            self._note_shed(request_id, slot, "breaker_open")
            raise BreakerOpenError(
                slot, breaker.retry_after_s(), breaker.state
            )
        obs, rows, batched = self._ensure_batched(engine, obs)
        req = _Request(
            obs, rows, slot, bool(deterministic), deadline_s,
            request_id=request_id,
        )
        outer: Future = Future()

        def _copy(f: Future):
            err = f.exception()
            if err is not None:
                outer.set_exception(err)
                return
            res: ActResult = f.result()
            action = res.action if batched else res.action[0]
            outer.set_result(ActResult(action, res.generation, res.epoch))

        req.future.add_done_callback(_copy)
        with self._nonempty:
            # Checked under the lock: a request enqueued after close()
            # flipped the flag would never be drained.
            if not self._running:
                raise ShedError(
                    "draining",
                    "MicroBatcher is closed (draining); not accepting "
                    "new requests",
                )
            if len(self._queue) >= self.capacity:
                self.metrics.record_shed("queue_full")
                self._note_shed(request_id, slot, "queue_full")
                raise ShedError(
                    "queue_full",
                    f"admission queue is at capacity "
                    f"({self.capacity} requests); retry with backoff",
                    retry_after_s=self._est_backlog_wait_locked() or 1.0,
                    detail={
                        "queue_depth": len(self._queue),
                        "capacity": self.capacity,
                    },
                )
            if deadline_s is not None and self._ema_samples >= 3:
                est_wait = (
                    sum(r.rows for r in self._queue) + rows
                ) * self._ema_row_s
                if est_wait > deadline_s:
                    self.metrics.record_shed("deadline_infeasible")
                    self._note_shed(request_id, slot, "deadline_infeasible")
                    raise ShedError(
                        "deadline_infeasible",
                        f"deadline of {deadline_s:.3f}s cannot be met: "
                        f"estimated completion {est_wait:.3f}s at the "
                        "current service rate; shedding instead of "
                        "serving a dead request",
                        retry_after_s=est_wait,
                        detail={"estimated_wait_s": round(est_wait, 4)},
                    )
            self._queue.append(req)
            self.metrics.record_enqueue(len(self._queue))
            self._nonempty.notify()
        return outer

    def act(
        self,
        obs: t.Any,
        deterministic: bool = True,
        slot: str = "default",
        timeout: float | None = 30.0,
        request_id: str | None = None,
    ) -> ActResult:
        """Blocking :meth:`submit`. The timeout doubles as the request
        deadline: a caller that stops waiting leaves no orphan behind —
        its queued request is purged at group-collection time instead
        of burning a forward on an answer nobody reads."""
        return self.submit(
            obs, deterministic, slot, deadline_s=timeout,
            request_id=request_id,
        ).result(timeout=timeout)

    def _note_shed(self, request_id, slot, reason):
        """One submit-time shed into the span log (when attached)."""
        if self.span_log is None:
            return
        now = time.perf_counter()
        self.span_log.record({
            "request_id": request_id, "slot": slot, "rows": 0,
            "t_enq": now, "t_done": now, "outcome": reason,
        })

    def _est_backlog_wait_locked(self) -> float | None:
        """Estimated seconds to drain the current queue (None until the
        service-rate EMA has warmed up). Callers hold ``self._lock``."""
        if self._ema_row_s is None:
            return None
        return sum(r.rows for r in self._queue) * self._ema_row_s

    def _ensure_batched(self, engine, obs):
        """(batched_obs, n_rows, was_batched) — an unbatched observation
        (leaf ndim == spec ndim) gains a leading axis of 1. Every leaf's
        trailing shape is checked against the slot's spec: a malformed
        request is a client error (HTTP 400), never an engine fault that
        would count toward the breaker."""
        spec = engine.obs_spec
        visual = isinstance(spec, MultiObservation)
        if visual != isinstance(obs, MultiObservation):
            raise ValueError(
                f"observation {type(obs).__name__} does not match the slot's "
                f"{'visual' if visual else 'flat'} observation spec"
            )
        if visual:
            leaves = [np.asarray(obs.features), np.asarray(obs.frame)]
            specs = [spec.features, spec.frame]
        else:
            leaves, specs = [np.asarray(obs)], [spec]
        batched = None
        for leaf, s in zip(leaves, specs):
            spec_ndim = len(s.shape)
            if tuple(leaf.shape[leaf.ndim - spec_ndim:]) != tuple(s.shape):
                raise ValueError(
                    f"observation shape {leaf.shape} does not end in the "
                    f"slot's observation shape {tuple(s.shape)}"
                )
            if leaf.ndim not in (spec_ndim, spec_ndim + 1):
                raise ValueError(
                    f"observation rank {leaf.ndim} matches neither the spec "
                    f"rank {spec_ndim} (single) nor {spec_ndim + 1} (batched)"
                )
            this = leaf.ndim == spec_ndim + 1
            if batched is not None and this != batched:
                raise ValueError("observation leaves disagree on the batch axis")
            batched = this
        if not batched:
            leaves = [leaf[None] for leaf in leaves]
        if visual:
            out = MultiObservation(*leaves)
            if obs_rows(out) != len(out.frame):
                raise ValueError("observation leaves disagree on the batch size")
        else:
            out = leaves[0]
        return out, obs_rows(out), batched

    # ----------------------------------------------------------- dispatch

    def _dispatch_loop(self):
        while True:
            group = self._collect_group()
            if group is None:
                return
            if group:  # may be empty when every queued request expired
                try:
                    self._run_group(group)
                finally:
                    with self._lock:
                        self._inflight_rows -= sum(r.rows for r in group)

    def _purge_expired_locked(self) -> None:
        """Fail and drop every queued request whose deadline has
        passed — the satellite fix for the timed-out-client leak: an
        abandoned ``act()`` used to stay queued and still burn a device
        forward on an answer nobody reads. Purged requests never reach
        the engine; counted as ``shed_expired_total``. Callers hold
        ``self._lock``."""
        if not any(r.deadline is not None for r in self._queue):
            return
        now = time.perf_counter()
        expired = [
            r for r in self._queue
            if r.deadline is not None and now >= r.deadline
        ]
        if not expired:
            return
        live = [r for r in self._queue if r not in expired]
        self._queue.clear()
        self._queue.extend(live)
        self.metrics.record_expired(len(expired))
        for r in expired:
            if self.span_log is not None:
                self.span_log.record({
                    "request_id": r.request_id, "slot": r.slot,
                    "rows": r.rows, "t_enq": r.t_enq, "t_done": now,
                    "outcome": "expired",
                })
            if not r.future.done():
                r.future.set_exception(ShedError(
                    "expired",
                    f"request deadline passed after "
                    f"{now - r.t_enq:.3f}s in queue; purged before "
                    "dispatch",
                ))

    def _collect_group(self) -> t.List[_Request] | None:
        """Block for the next dispatchable same-``(slot,
        deterministic)`` group of queued requests — boundary-waiting in
        ``"group"`` mode, immediate in ``"continuous"`` mode. Expired
        requests are purged here — group-collection time — so the
        engine only ever runs live work. ``None`` means shutdown with
        an empty queue; an empty list means everything queued had
        expired."""
        with self._nonempty:
            while True:
                self._purge_expired_locked()
                if self._queue:
                    break
                if not self._running:
                    return None
                self._nonempty.wait(timeout=0.05)
            if self.mode == "continuous":
                group = self._collect_continuous_locked()
            else:
                group = self._collect_boundary_locked()
            if group:
                self._inflight_rows += sum(r.rows for r in group)
                if self.span_log is not None:
                    t_collect = time.perf_counter()
                    for r in group:
                        r.t_collect = t_collect
            return group

    @staticmethod
    def _urgency(r: _Request) -> t.Tuple[bool, float, float]:
        """Priority key: earliest deadline first; deadline-free
        requests after every deadlined one, FIFO among themselves."""
        return (r.deadline is None, r.deadline or 0.0, r.t_enq)

    def _collect_continuous_locked(self) -> t.List[_Request]:
        """Admit-into-next-dispatch: take everything queued for the
        most urgent request's ``(slot, deterministic)`` class — most
        urgent first — up to ``max_batch`` rows, with NO coalescing
        wait. The engine's forward time is the batching window: rows
        that arrived while the previous group ran ride this one, a
        lone request at low load dispatches immediately, and a
        near-deadline request preempts batch-filling by deadline-free
        traffic. Callers hold ``self._lock``."""
        head = min(self._queue, key=self._urgency)
        cls = (head.slot, head.deterministic)
        candidates = sorted(
            (r for r in self._queue
             if (r.slot, r.deterministic) == cls),
            key=self._urgency,
        )
        group: t.List[_Request] = []
        rows = 0
        for r in candidates:
            if group and rows + r.rows > self.max_batch:
                break  # a later dispatch picks it up (an oversized
                # head is taken alone and chunked by _run_group)
            group.append(r)
            rows += r.rows
            if rows >= self.max_batch:
                break
        taken = {id(r) for r in group}
        live = [r for r in self._queue if id(r) not in taken]
        self._queue.clear()
        self._queue.extend(live)
        return group

    def _collect_boundary_locked(self) -> t.List[_Request]:
        """The compat ``"group"`` mode: hold the forming group up to
        ``max_wait_ms`` past the oldest request hoping to fill
        ``max_batch`` rows; strict FIFO within the head's class.
        Callers hold ``self._lock``."""
        head = self._queue[0]
        deadline = head.t_enq + self.max_wait_s

        def ready_rows():
            rows = 0
            for r in self._queue:
                if (r.slot, r.deterministic) != (
                    head.slot, head.deterministic
                ):
                    break
                rows += r.rows
            return rows

        # A single oversized request flushes immediately (it fills
        # max_batch on its own); otherwise wait for more rows until
        # the head's deadline.
        while self._running and ready_rows() < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            self._nonempty.wait(timeout=remaining)
        # Final purge before dispatch: whatever expired during the
        # coalescing wait is failed now, never forwarded.
        self._purge_expired_locked()
        if not self._queue:
            return []
        head = self._queue[0]  # the purge may have changed the head
        group: t.List[_Request] = []
        rows = 0
        while self._queue:
            r = self._queue[0]
            if (r.slot, r.deterministic) != (head.slot, head.deterministic):
                break
            if group and rows + r.rows > self.max_batch:
                break  # next group picks it up (oversized head is
                # taken alone and chunked by _run_group)
            group.append(self._queue.popleft())
            rows += r.rows
            if rows >= self.max_batch:
                break
        return group

    def _next_key(self, engine) -> torch.Generator:
        """The sampled-action generator, created on ``engine``'s device
        at first use. Under the lock: :meth:`import_key` may restore a
        saved state from another thread."""
        with self._lock:
            if self._generator is None:
                gen = torch.Generator(device=engine.device)
                gen.manual_seed(self._seed)
                if self._pending_state is not None:
                    gen.set_state(self._pending_state)
                    self._pending_state = None
                self._generator = gen
            return self._generator

    def _slot_epoch(self, slot_name: str) -> int | None:
        """The slot's published training epoch, when the registry
        exposes one (``ModelRegistry.epoch_of``). Read next to
        ``acquire`` rather than inside it so the registry interface
        stays duck-type compatible with older views; a swap landing
        between the two reads can mis-stamp at most one group by one
        publish — and the decoupled loop acts and publishes on one
        thread, where the race cannot occur."""
        epoch_of = getattr(self.registry, "epoch_of", None)
        if epoch_of is None:
            return None
        try:
            return epoch_of(slot_name)
        except Exception:  # noqa: BLE001 — stamping must never fail a group
            return None

    # --------------------------------------------------- sampled-key state

    def export_key(self) -> list:
        """The sampled-action generator state as a JSON-ready list of
        bytes (``torch.Generator.get_state``), so a resumed process
        continues the same stream. Before the first sampled group this
        is the state a fresh generator seeded with ``seed`` would have."""
        with self._lock:
            if self._generator is not None:
                state = self._generator.get_state()
            elif self._pending_state is not None:
                state = self._pending_state
            else:
                state = torch.Generator().manual_seed(self._seed).get_state()
            return state.tolist()

    def import_key(self, data) -> None:
        """Restore the generator state from :meth:`export_key` output."""
        state = torch.tensor(data, dtype=torch.uint8)
        with self._lock:
            if self._generator is not None:
                self._generator.set_state(state)
            else:
                self._pending_state = state

    def _run_group(self, group: t.List[_Request]):
        slot_name = group[0].slot
        breaker = self.registry.breaker(slot_name)
        if breaker is not None and not breaker.allow():
            # Tripped (or half-open past its probe quota): queued
            # requests for the slot fail fast — no engine work at all.
            err = BreakerOpenError(
                slot_name, breaker.retry_after_s(), breaker.state
            )
            now = time.perf_counter()
            for r in group:
                if not r.future.done():
                    r.future.set_exception(err)
                self.metrics.record_shed("breaker_open")
                if self.span_log is not None:
                    self.span_log.record({
                        "request_id": r.request_id, "slot": r.slot,
                        "rows": r.rows, "t_enq": r.t_enq,
                        "t_collect": r.t_collect, "t_done": now,
                        "outcome": "breaker_open",
                    })
            return
        try:
            engine, params, generation = self.registry.acquire(slot_name)
            epoch = self._slot_epoch(slot_name)
            det = group[0].deterministic
            obs = group[0].obs
            if len(group) > 1:
                obs = _concat([r.obs for r in group])
            total = sum(r.rows for r in group)
            # Chunk and run one padded forward per chunk. The chunk
            # size honors BOTH ceilings: the batcher's max_batch (only
            # an oversized single request exceeds it) and the engine's
            # own max_batch — a slot may be registered with a smaller
            # bucket ladder than the server-wide batcher, and chunks
            # larger than its top bucket would make bucket_for raise.
            chunk_rows = min(self.max_batch, engine.max_batch)
            outs = []
            t_fwd = time.perf_counter()
            group_bucket = engine.bucket_for(min(chunk_rows, total))
            for lo in range(0, total, chunk_rows):
                chunk = _slice(obs, lo, lo + chunk_rows)
                n = min(chunk_rows, total - lo)
                t_chunk = time.perf_counter()
                outs.append(engine.act(
                    params, chunk,
                    None if det else self._next_key(engine),
                    deterministic=det,
                ))
                self.metrics.record_batch(
                    rows=n, bucket=engine.bucket_for(n),
                    dur_s=time.perf_counter() - t_chunk,
                )
            t_fwd_end = time.perf_counter()
            self._note_service_rate(t_fwd_end - t_fwd, total)
            action = outs[0] if len(outs) == 1 else np.concatenate(outs, 0)
            done_t = time.perf_counter()
            lo = 0
            for r in group:
                r.future.set_result(
                    ActResult(action[lo:lo + r.rows], generation, epoch)
                )
                self.metrics.record_done((done_t - r.t_enq) * 1e3)
                if self.span_log is not None:
                    self.span_log.record({
                        "request_id": r.request_id, "slot": r.slot,
                        "rows": r.rows, "bucket": group_bucket,
                        "generation": generation, "t_enq": r.t_enq,
                        "t_collect": r.t_collect, "t_dispatch": t_fwd,
                        "t_forward_end": t_fwd_end, "t_done": done_t,
                        "outcome": "ok",
                    })
                lo += r.rows
            if breaker is not None:
                breaker.record_success()
        except Exception as e:  # noqa: BLE001 — the dispatcher must
            # survive a bad request/params; every caller sees the error.
            if breaker is not None and not isinstance(
                e, (KeyError, ValueError, TypeError)
            ):
                # Engine health, not request shape: forwards that raise
                # and non-finite action outputs count toward the trip
                # threshold; malformed requests / unknown slots do not.
                breaker.record_failure(e)
            now = time.perf_counter()
            for r in group:
                if not r.future.done():
                    r.future.set_exception(e)
                self.metrics.record_error()
                if self.span_log is not None:
                    self.span_log.record({
                        "request_id": r.request_id, "slot": r.slot,
                        "rows": r.rows, "t_enq": r.t_enq,
                        "t_collect": r.t_collect, "t_done": now,
                        "outcome": "error",
                    })

    def _note_service_rate(self, dt_s: float, rows: int):
        """Fold one group's measured seconds-per-row into the EMA the
        submit-time deadline-feasibility check reads."""
        if rows <= 0 or dt_s <= 0:
            return
        per_row = dt_s / rows
        with self._lock:
            self._ema_row_s = (
                per_row if self._ema_row_s is None
                else 0.8 * self._ema_row_s + 0.2 * per_row
            )
            self._ema_samples += 1

    # -------------------------------------------------------------- admin

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def load_rows(self) -> int:
        """Queued + in-flight rows — the backlog the engine still owes.
        The fleet's least-loaded dispatcher scores replicas by
        ``load_rows() x ema_row_s`` (estimated seconds to clear)."""
        with self._lock:
            return sum(r.rows for r in self._queue) + self._inflight_rows

    @property
    def ema_row_s(self) -> float | None:
        """Measured seconds-per-row EMA (None until the first group)."""
        with self._lock:
            return self._ema_row_s

    def close(self, timeout: float = 10.0):
        """Stop accepting work, flush everything queued, join the
        dispatcher. Queued requests are answered, never dropped."""
        with self._nonempty:
            self._running = False
            self._nonempty.notify_all()
        self._thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
