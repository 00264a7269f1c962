"""Supervised actor-process fleet: ``train --actors N`` (port of the JAX
package's ``decoupled/fleet.py``).

Scales the decoupled actor/learner from threads to *processes* the way
``serve --fleet N`` scaled serving (Sebulba arXiv:2104.06272 /
TorchBeast arXiv:1910.03552). Actor processes never touch the card: they
are spawned with ``CUDA_VISIBLE_DEVICES`` blank and act over HTTP through
the learner's ``/act`` proxy into its own serving plane, so their
host-only acting is the design, not a CPU fallback. Three pieces:

- :func:`actor_main` — the subprocess entry point: its own env pool,
  acting over HTTP through the learner's serving proxy
  (:class:`~torch_actor_critic_tpu_torch.serve.server.PolicyClient` against
  the transport's ``/act``), staging over the wire through a
  :class:`~torch_actor_critic_tpu_torch.decoupled.transport.
  RemoteStagingClient`, a heartbeat thread feeding the supervisor's
  liveness table, SIGTERM -> graceful stop. When the learner is away
  the actor **degrades to local acting** (uniform-random actions — a
  fleet actor owns no weights — stamped untagged like warmup, so the
  staleness gate treats them as degraded data) and re-homes on
  the first successful probe.
- :class:`FleetSupervisor` — liveness-gated supervision: an actor
  that misses its heartbeat deadline (or whose process died) is
  **declared dead**, SIGKILL-reaped, its staged tail purged
  (``dropped_dead_actor_total`` — the conservation invariant's new
  term), and **restarted with jittered exponential backoff** up to
  ``--actor-max-restarts``, counted as ``decoupled/actor_restarts``.
  Every restart is a new *incarnation*: the transport's watermark bump
  happens before the purge, so a zombie push from the reaped process
  can never land after its tail was swept.
- :class:`FleetTrainer` — a :class:`DecoupledTrainer` that owns the
  transport server and the supervisor. The learner's own inline actor
  keeps collecting (``actor_id=-1``); fleet transitions are additional
  feed into the SAME bounded staging buffer, under the same counted
  backpressure, staleness gate, and the extended invariant checked
  every epoch::

      staged == drained + dropped_stale + dropped_backpressure
                + dropped_dead_actor + depth

  Checkpoints additionally carry the transport's per-actor dedup
  watermarks, so a push retried across a learner SIGTERM->resume
  (requeue 75) is still deduplicated — zero accepted transitions lost
  AND zero double-ingested, sequence-number audit exact
  (tests/test_torch_actor_fleet.py).
"""

from __future__ import annotations

import logging
import os
import random
import signal
import threading
import time
import typing as t

from torch_actor_critic_tpu_torch.decoupled.learner import DecoupledTrainer
from torch_actor_critic_tpu_torch.decoupled.transport import (
    RemoteStagingClient,
    StagingTransportServer,
)
from torch_actor_critic_tpu_torch.envs.vec_env import host_only_children

logger = logging.getLogger(__name__)

__all__ = ["FleetSupervisor", "FleetTrainer", "actor_main"]

# Fault-injection hook (resilience/faultinject.py FlakyTransport): a
# spawned actor whose environment carries TAC_FLAKY_PUSH wraps its
# staging POST with scheduled drops/latency — a transport flap,
# injected under the retry loop like a real bad NIC.
FLAKY_PUSH_ENV = "TAC_FLAKY_PUSH"


def _maybe_flaky_post(client: RemoteStagingClient, actor_id: int):
    spec = os.environ.get(FLAKY_PUSH_ENV, "")
    if not spec:
        return
    from torch_actor_critic_tpu_torch.resilience.faultinject import FlakyTransport

    opts = dict(
        kv.split("=", 1) for kv in spec.split(",") if "=" in kv
    )
    client._post = FlakyTransport(
        client._post,
        drop_rate=float(opts.get("drop_rate", 0.0)),
        latency_s=float(opts.get("latency_s", 0.0)),
        rng=random.Random(int(opts.get("seed", 0)) + actor_id),
    )
    logger.info(
        "actor %d: flaky push transport injected (%s)", actor_id, spec
    )


def _actor_loop(
    actor_id: int,
    incarnation: int,
    url: str,
    env_name: str,
    n_envs: int,
    base_seed: int,
    stop: threading.Event,
    options: t.Mapping[str, t.Any] | None = None,
) -> dict:
    """The actor's collection loop, factored out of the process shim so
    tests can drive it on a thread against a real transport server.
    Returns the worker/client stats for the caller's audit."""
    from torch_actor_critic_tpu_torch.decoupled.actor import ActorWorker
    from torch_actor_critic_tpu_torch.envs.vec_env import make_env_pool
    from torch_actor_critic_tpu_torch.serve.server import PolicyClient

    opts = dict(options or {})
    staging = RemoteStagingClient(
        url,
        actor_id=actor_id,
        incarnation=incarnation,
        retry_budget_s=float(opts.get("push_retry_s", 2.0)),
        rng=random.Random(base_seed),
    )
    trace_dir = opts.get("trace_dir")
    span_sink = None
    if trace_dir:
        # Trace stitching: one spans file per (actor, incarnation),
        # absolute-µs records the learner's trace export merges onto
        # this actor's own timeline lane (obs/tracecollect.py).
        from torch_actor_critic_tpu_torch.telemetry.sinks import JsonlSink

        span_sink = JsonlSink(os.path.join(
            str(trace_dir),
            f"actor{actor_id}-{incarnation}.spans.jsonl",
        ))
        staging.span_sink = span_sink.write
    _maybe_flaky_post(staging, actor_id)
    client = PolicyClient(url=url, retries=1, backoff_s=0.05)
    pool = make_env_pool(env_name, n_envs, base_seed=base_seed)
    worker = ActorWorker(
        client,
        staging,
        # A fleet actor owns no weights: degraded acting is uniform
        # env-space sampling, untagged (generation 0, epoch None) like
        # warmup — lag 0 through the admission gate, honestly counted
        # in fallback_actions_total.
        fallback=lambda obs, deterministic: (
            pool.sample_actions(), 0, None
        ),
        act_timeout_s=float(opts.get("act_timeout_s", 5.0)),
        probe_every=int(opts.get("probe_every", 8)),
    )
    hb_interval = float(opts.get("heartbeat_interval_s", 0.5))

    def hb_loop():
        while not stop.is_set():
            try:
                staging.heartbeat(
                    os.getpid(),
                    worker.serving_actions_total
                    + worker.fallback_actions_total,
                )
            except RuntimeError:
                # Superseded incarnation: the supervisor already
                # replaced this actor — stop producing.
                logger.warning(
                    "actor %d inc %d superseded; stopping",
                    actor_id, incarnation,
                )
                stop.set()
                break
            stop.wait(hb_interval)

    hb = threading.Thread(
        target=hb_loop, name=f"actor{actor_id}-heartbeat", daemon=True
    )
    hb.start()
    try:
        steps = worker.run(
            pool, stop,
            seeds=[base_seed + i for i in range(n_envs)],
            max_steps=opts.get("max_steps"),
            sample_until=int(opts.get("sample_until", 0)),
        )
    finally:
        stop.set()
        hb.join(timeout=5.0)
        if span_sink is not None:
            span_sink.close()
        close = getattr(pool, "close", None)
        if close is not None:
            close()
    return {
        "steps": steps,
        "worker": worker.stats(),
        "staging": staging.stats(),
    }


def actor_main(
    actor_id: int,
    incarnation: int,
    url: str,
    env_name: str,
    n_envs: int,
    base_seed: int,
    options: dict | None = None,
) -> None:
    """Subprocess entry point (multiprocessing ``spawn`` target):
    installs SIGTERM/SIGINT -> graceful stop, runs :func:`_actor_loop`,
    exits 0 on a clean roll-down. Crashes propagate as a nonzero exit
    the supervisor observes and restarts."""
    logging.basicConfig(
        level=logging.INFO,
        format=f"[actor {actor_id}.{incarnation}] %(message)s",
    )
    # The learner's kernel-library cache, inherited through the env var
    # (JAX's actor joins its compile cache here). The port's actor
    # launches no kernel today (it acts over HTTP and steps numpy envs);
    # joining keeps any it ever launches off nvcc.
    from torch_actor_critic_tpu_torch.aot.cache import enable_cache_from_env

    enable_cache_from_env()
    stop = threading.Event()

    def _stop_handler(signum, frame):  # pragma: no cover — signal path
        # is exercised end to end by chip_smoke.py's fleet run
        del frame
        logger.info("actor %d: signal %d, rolling down", actor_id, signum)
        stop.set()

    signal.signal(signal.SIGTERM, _stop_handler)
    signal.signal(signal.SIGINT, _stop_handler)
    stats = _actor_loop(
        actor_id, incarnation, url, env_name, n_envs, base_seed,
        stop, options,
    )
    logger.info(
        "actor %d inc %d done: %d steps, %d accepted, %d duplicates, "
        "%d shed",
        actor_id, incarnation, stats["steps"],
        stats["staging"]["accepted_total"],
        stats["staging"]["duplicates_total"],
        stats["staging"]["shed_total"],
    )


class FleetSupervisor:
    """Liveness-gated actor supervision with bounded, jittered restarts.

    ``spawn(actor_id, incarnation) -> proc`` returns a started process
    handle (``pid`` / ``is_alive()`` / ``join(timeout)``); ``liveness()
    -> {actor_id: {"age_s", "incarnation", ...}}`` is the transport's
    heartbeat table; ``on_death(actor_id, incarnation) -> purged`` runs
    after the kill+join (the transport retire: watermark bump + staged-
    tail purge). ``clock``/``sleeper``/``kill`` are injectable so the
    deadline/backoff machinery is provable with fake processes and a
    fake clock (tests/test_torch_actor_fleet.py).

    Death verdicts per poll: a process that is no longer alive, or a
    live one whose newest heartbeat **for the current incarnation** is
    older than ``heartbeat_timeout_s``, is declared dead, SIGKILLed
    (idempotent for already-dead), joined, retired, and — up to
    ``max_restarts`` per slot — respawned as incarnation+1 after a
    jittered exponential backoff. A slot past its budget is abandoned
    loudly (``gave_up``). Fresh spawns get ``grace_s`` to first
    heartbeat (process start + imports are not a liveness failure).
    """

    def __init__(
        self,
        spawn: t.Callable[[int, int], t.Any],
        n_actors: int,
        liveness: t.Callable[[], t.Dict[int, dict]],
        on_death: t.Callable[[int, int], int],
        heartbeat_timeout_s: float = 3.0,
        max_restarts: int = 3,
        backoff_s: float = 0.5,
        max_backoff_s: float = 8.0,
        poll_interval_s: float = 0.25,
        grace_s: float = 60.0,
        clock: t.Callable[[], float] = time.monotonic,
        kill: t.Callable[[int, int], None] = os.kill,
        rng: random.Random | None = None,
    ):
        if n_actors < 1:
            raise ValueError(f"n_actors must be >= 1, got {n_actors}")
        self._spawn = spawn
        self.n_actors = int(n_actors)
        self._liveness = liveness
        self._on_death = on_death
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.max_restarts = int(max_restarts)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.poll_interval_s = float(poll_interval_s)
        self.grace_s = float(grace_s)
        self._clock = clock
        self._kill = kill
        self._rng = rng if rng is not None else random.Random()
        self._lock = threading.Lock()
        self._procs: t.Dict[int, t.Any] = {}  # guarded-by: _lock
        self._incarnation: t.Dict[int, int] = {}  # guarded-by: _lock
        self._spawned_at: t.Dict[int, float] = {}  # guarded-by: _lock
        self._restarts: t.Dict[int, int] = {}  # guarded-by: _lock
        self._respawn_at: t.Dict[int, float] = {}  # guarded-by: _lock
        self._gave_up: t.Set[int] = set()  # guarded-by: _lock
        self.restarts_total = 0  # guarded-by: _lock
        self.deaths_total = 0  # guarded-by: _lock
        self.purged_on_death_total = 0  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None  # guarded-by: _lock

    # ---------------------------------------------------------- lifecycle

    def start(
        self, start_incarnations: t.Mapping[int, int] | None = None
    ) -> "FleetSupervisor":
        """Spawn the full fleet and begin supervising on a daemon
        thread. ``start_incarnations`` seeds per-slot incarnation
        numbers ABOVE any checkpoint-restored transport watermark, so
        respawned-after-resume actors are not mistaken for zombies."""
        base = dict(start_incarnations or {})
        now = self._clock()
        with self._lock:
            for aid in range(self.n_actors):
                inc = int(base.get(aid, 0))
                self._incarnation[aid] = inc
                self._restarts[aid] = 0
                proc = self._spawn(aid, inc)
                self._procs[aid] = proc
                self._spawned_at[aid] = now
                logger.info(
                    "spawned actor %d (incarnation %d, pid %s)",
                    aid, inc, getattr(proc, "pid", "?"),
                )
        self._stop.clear()
        thread = threading.Thread(
            target=self._monitor_loop, name="fleet-supervisor",
            daemon=True,
        )
        with self._lock:
            self._thread = thread
        thread.start()
        return self

    def _monitor_loop(self):
        while not self._stop.is_set():
            self.poll_once()
            self._stop.wait(self.poll_interval_s)

    def poll_once(self) -> None:
        """One supervision pass (the monitor thread's body; tests call
        it directly with an injected clock)."""
        live = self._liveness()
        now = self._clock()
        with self._lock:
            for aid in range(self.n_actors):
                if aid in self._gave_up:
                    continue
                if aid in self._respawn_at:
                    self._respawn_due_locked(aid, now)
                    continue
                proc = self._procs.get(aid)
                if proc is None:
                    continue
                inc = self._incarnation[aid]
                if not proc.is_alive():
                    self._declare_dead_locked(
                        aid, now, reason="process exited "
                        f"(exitcode {getattr(proc, 'exitcode', '?')})",
                    )
                    continue
                info = live.get(aid)
                if info is not None and info["incarnation"] == inc:
                    if info["age_s"] > self.heartbeat_timeout_s:
                        self._declare_dead_locked(
                            aid, now,
                            reason=f"heartbeat {info['age_s']:.2f}s "
                            "past deadline",
                        )
                elif now - self._spawned_at[aid] > max(
                    self.grace_s, self.heartbeat_timeout_s
                ):
                    self._declare_dead_locked(
                        aid, now, reason="no heartbeat since spawn",
                    )

    def _declare_dead_locked(
        self, aid: int, now: float, reason: str
    ) -> None:
        """Kill/reap/retire one actor and schedule (or refuse) its
        restart. Callers hold ``self._lock``."""
        proc = self._procs.pop(aid)
        inc = self._incarnation[aid]
        self.deaths_total += 1
        logger.warning(
            "actor %d (incarnation %d, pid %s) declared DEAD: %s",
            aid, inc, getattr(proc, "pid", "?"), reason,
        )
        try:
            self._kill(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, OSError):
            pass  # already reaped — SIGKILL is idempotent here
        proc.join(timeout=10.0)
        # Retire AFTER the join: the process is provably gone, so the
        # purge sweeps everything it will ever have staged (any zombie
        # request still in a handler is 410-fenced by the watermark
        # bump inside on_death).
        self.purged_on_death_total += self._on_death(aid, inc)
        if self._restarts[aid] >= self.max_restarts:
            self._gave_up.add(aid)
            logger.error(
                "actor %d exhausted its %d-restart budget; abandoning "
                "the slot (the fleet keeps training on the survivors)",
                aid, self.max_restarts,
            )
            return
        delay = min(
            self.backoff_s * (2 ** self._restarts[aid]),
            self.max_backoff_s,
        ) * (1.0 + 0.5 * self._rng.random())  # jitter
        self._respawn_at[aid] = now + delay
        logger.info(
            "actor %d restart %d/%d scheduled in %.2fs",
            aid, self._restarts[aid] + 1, self.max_restarts, delay,
        )

    def _respawn_due_locked(self, aid: int, now: float) -> None:
        """Respawn a scheduled slot once its backoff expired. Callers
        hold ``self._lock``."""
        if now < self._respawn_at[aid]:
            return
        del self._respawn_at[aid]
        inc = self._incarnation[aid] + 1
        self._incarnation[aid] = inc
        self._restarts[aid] += 1
        self.restarts_total += 1
        proc = self._spawn(aid, inc)
        self._procs[aid] = proc
        self._spawned_at[aid] = now
        logger.info(
            "respawned actor %d as incarnation %d (pid %s, restart %d)",
            aid, inc, getattr(proc, "pid", "?"), self._restarts[aid],
        )

    def readmit(self, aid: int) -> bool:
        """Elastic re-admission of an abandoned slot (docs/RESILIENCE.md
        "Elasticity"): clear the exhausted restart budget and respawn
        the slot at the next incarnation — the watermark fence still
        holds because the incarnation strictly increases past every
        retired one. Called at epoch boundaries by the
        TrainingElasticManager; returns False for a slot that never
        gave up (nothing to re-admit)."""
        with self._lock:
            if aid not in self._gave_up:
                return False
            self._gave_up.discard(aid)
            self._restarts[aid] = 0
            self._respawn_at.pop(aid, None)
            inc = self._incarnation.get(aid, 0) + 1
            self._incarnation[aid] = inc
            proc = self._spawn(aid, inc)
            self._procs[aid] = proc
            self._spawned_at[aid] = self._clock()
        logger.info(
            "re-admitted actor %d as incarnation %d (pid %s); restart "
            "budget reset", aid, inc, getattr(proc, "pid", "?"),
        )
        return True

    def shutdown(self, term_timeout_s: float = 10.0) -> None:
        """Roll the fleet down: stop supervising, SIGTERM every live
        actor (graceful stop -> flush), join, SIGKILL stragglers."""
        self._stop.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=term_timeout_s)
        with self._lock:
            procs = list(self._procs.items())
        for aid, proc in procs:
            if not proc.is_alive():
                continue
            try:
                self._kill(proc.pid, signal.SIGTERM)
            except (ProcessLookupError, OSError):
                continue
        for aid, proc in procs:
            proc.join(timeout=term_timeout_s)
            if proc.is_alive():
                logger.warning(
                    "actor %d ignored SIGTERM for %.1fs; SIGKILL",
                    aid, term_timeout_s,
                )
                try:
                    self._kill(proc.pid, signal.SIGKILL)
                except (ProcessLookupError, OSError):
                    pass
                proc.join(timeout=5.0)

    # ----------------------------------------------------- introspection

    def stats(self) -> dict:
        with self._lock:
            return {
                "restarts_total": self.restarts_total,
                "deaths_total": self.deaths_total,
                "purged_on_death_total": self.purged_on_death_total,
                "gave_up": sorted(self._gave_up),
                "alive": sum(
                    1 for p in self._procs.values() if p.is_alive()
                ),
                "actors": {
                    aid: {
                        "incarnation": self._incarnation.get(aid, 0),
                        "restarts": self._restarts.get(aid, 0),
                        "pid": getattr(
                            self._procs.get(aid), "pid", None
                        ),
                        "alive": (
                            aid in self._procs
                            and self._procs[aid].is_alive()
                        ),
                    }
                    for aid in range(self.n_actors)
                },
            }

    def load_stats(self, stats: t.Mapping[str, t.Any]) -> None:
        """Restore the monotone counters from a checkpoint so
        ``decoupled/actor_restarts`` keeps counting across a learner
        resume instead of resetting to zero."""
        with self._lock:
            self.restarts_total = int(stats.get("restarts_total", 0))
            self.deaths_total = int(stats.get("deaths_total", 0))
            self.purged_on_death_total = int(
                stats.get("purged_on_death_total", 0)
            )


class FleetTrainer(DecoupledTrainer):
    """DecoupledTrainer + a supervised actor-process fleet.

    The learner keeps its hardened inline collection loop
    (``actor_id=-1``); ``config.actors`` subprocesses feed the same
    staging buffer over the networked transport. Checkpoints grow the
    transport watermarks and supervisor counters; saves pause the
    buffer so the exported tail + watermark state is one consistent
    cut (in-flight pushes get 503 and retry the same seq — accepted
    exactly once, before or after the cut, never both).
    """

    def __init__(self, *args, spawn=None, **kwargs):
        super().__init__(*args, **kwargs)
        cfg = self.config
        self.transport = StagingTransportServer(
            staging=self.staging,
            obs_spec=self.pool.obs_spec,
            n_envs=self.population,
            act_dim=self.pool.act_dim,
            act=self._serve_act,
            port=cfg.fleet_port,
        ).start()
        self._spawn_override = spawn
        self.supervisor = FleetSupervisor(
            spawn=self._spawn_actor,
            n_actors=cfg.actors,
            liveness=self.transport.liveness,
            on_death=self.transport.retire_actor,
            heartbeat_timeout_s=cfg.heartbeat_timeout_s,
            max_restarts=cfg.actor_max_restarts,
        )
        self._restored_incarnations: t.Dict[int, int] = {}
        self._fleet_started = False
        # Elastic degrade/re-admit (docs/RESILIENCE.md "Elasticity").
        # Off (the default) constructs nothing: no decision log, no
        # elastic/ metric keys — the key-pin contract matches the
        # obs-off one.
        self.elastic = None
        if cfg.elastic == "on":
            from torch_actor_critic_tpu_torch.elastic import (
                DecisionLog,
                TrainingElasticManager,
            )

            self.elastic = TrainingElasticManager(
                supervisor=self.supervisor,
                n_actors=cfg.actors,
                log=DecisionLog(telemetry=self.telemetry),
                readmit_epochs=cfg.elastic_readmit_epochs,
            )
        # Run-wide obs plane: the collector (built in Trainer.__init__,
        # started at train() entry) scrapes the transport's /metrics +
        # /healthz — staging conservation and per-actor liveness land
        # in the aggregated series as the ``fleet`` source.
        if self.obs is not None:
            from torch_actor_critic_tpu_torch.obs import http_source

            self.obs.add_source(
                "fleet",
                http_source(
                    self.transport.address, ("/metrics", "/healthz")
                ),
            )
        # Trace stitching: with telemetry on, the transport records
        # ingest spans + queues accepted span ids, the learner tags
        # drain windows with the ids they consumed, and actor
        # subprocesses append their push spans under the run dir —
        # merged into one timeline by extra_trace_events().
        self._stage_spans = None
        self._trace_dir = None
        if self.telemetry is not None:
            from torch_actor_critic_tpu_torch.telemetry.traceview import (
                RequestSpanLog,
            )

            self.transport.span_log = RequestSpanLog(4096)
            self._stage_spans = RequestSpanLog(2048)
            tracker = self.tracker
            if tracker is not None and getattr(tracker, "run_dir", None):
                self._trace_dir = os.path.join(
                    str(tracker.run_dir), "stage_spans"
                )
        logger.info(
            "actor fleet: %d actors, transport at %s, heartbeat "
            "%.2fs/%.2fs, max restarts %d",
            cfg.actors, self.transport.address,
            cfg.heartbeat_interval_s, cfg.heartbeat_timeout_s,
            cfg.actor_max_restarts,
        )

    # ------------------------------------------------------------- fleet

    def _serve_act(self, obs, deterministic):
        """The transport's /act proxy: actor subprocesses act through
        the learner's own serving plane (registry + micro-batcher —
        the exact stack the inline actor uses)."""
        return self.client.act(
            obs, deterministic=deterministic,
            timeout=self.config.actor_timeout_s,
        )

    def _spawn_actor(self, actor_id: int, incarnation: int):
        if self._spawn_override is not None:
            return self._spawn_override(actor_id, incarnation)
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        proc = ctx.Process(
            target=actor_main,
            args=(
                actor_id,
                incarnation,
                self.transport.address,
                # The env with its history stack: an actor's observations
                # must have the learner's shape (the JAX trainer passes
                # the bare env name, which a history run's transport
                # refuses as malformed).
                self.pool_name,
                self.population,
                # Disjoint from the learner's env seeds (seed + 10000k)
                # and stable per (actor, incarnation) so restarts are
                # reproducible.
                self.seed + 20000 + 1000 * actor_id + incarnation,
            ),
            kwargs={"options": {
                "heartbeat_interval_s": self.config.heartbeat_interval_s,
                "act_timeout_s": self.config.actor_timeout_s,
                "push_retry_s": self.config.actor_push_retry_s,
                "trace_dir": self._trace_dir,
            }},
            daemon=True,
        )
        # Host only: the actor acts over HTTP and steps numpy envs.
        with host_only_children():
            proc.start()
        return proc

    def train(
        self, on_epoch: t.Callable[[int, dict], None] | None = None,
        render: bool = False,
    ) -> dict:
        if not self._fleet_started:
            self._fleet_started = True
            self.supervisor.start(
                start_incarnations=self._restored_incarnations
            )
        return super().train(on_epoch, render)

    # ----------------------------------------------------- trace stitching

    def _drain_window(self, staging):
        """Tag each drain window with the span ids of the fleet pushes
        accepted since the last one — the learner-side end of the
        actor-push -> transport-ingest -> drain stitch. No span log
        attached = exactly the parent's behavior."""
        if self._stage_spans is None:
            return super()._drain_window(staging)
        t0 = time.perf_counter()
        chunk = super()._drain_window(staging)
        if chunk is not None:
            span_ids = self.transport.take_recent_span_ids()
            self._stage_spans.record({
                "name": "drain_window",
                "t0": t0,
                "t1": time.perf_counter(),
                "span_ids": span_ids,
                "entries": self.config.update_every,
            })
        return chunk

    def extra_trace_events(self) -> t.List[dict]:
        """Staging-plane spans for the merged run timeline: transport
        ingest spans, learner drain windows, and every actor process's
        push-span file."""
        from torch_actor_critic_tpu_torch.obs.tracecollect import actor_span_events
        from torch_actor_critic_tpu_torch.telemetry.traceview import (
            TRAIN_PID,
            TRANSPORT_PID,
            staging_span_events,
        )

        events = list(super().extra_trace_events())
        if self.transport.span_log is not None:
            events.extend(staging_span_events(
                self.transport.span_log.records(), pid=TRANSPORT_PID
            ))
        if self._stage_spans is not None:
            events.extend(staging_span_events(
                self._stage_spans.records(), pid=TRAIN_PID
            ))
        if self._trace_dir is not None:
            events.extend(actor_span_events(self._trace_dir))
        if self.elastic is not None:
            from torch_actor_critic_tpu_torch.telemetry.traceview import (
                elastic_decision_events,
            )

            events.extend(elastic_decision_events(
                self.elastic.log.records()
            ))
        return events

    # --------------------------------------------------------- checkpoint

    def _save_checkpoint(self, epoch: int, step: int) -> None:
        # One consistent cut across counters, queue contents and dedup
        # watermarks: pause admissions (in-flight pushes 503-retry the
        # same seq) for the synchronous slice of the save (the host
        # copies; the files are written in the background).
        was_paused = self.staging.paused
        if not was_paused:
            self.staging.pause()
        try:
            return super()._save_checkpoint(epoch, step)
        finally:
            if not was_paused:
                self.staging.resume()

    def _checkpoint_extra(self, step: int) -> dict:
        extra = super()._checkpoint_extra(step)
        extra["decoupled"]["transport_watermarks"] = (
            self.transport.watermarks()
        )
        extra["decoupled"]["fleet"] = self.supervisor.stats()
        if self.elastic is not None:
            # Degraded topology rides the checkpoint: a learner that
            # saved with slots degraded resumes degraded and re-admits
            # on its own epoch schedule.
            extra["decoupled"]["elastic"] = self.elastic.snapshot()
        return extra

    def _restore_extras(self, meta: dict, arrays) -> None:
        super()._restore_extras(meta, arrays)
        dec = meta.get("decoupled") or {}
        marks = dec.get("transport_watermarks") or {}
        self.transport.load_watermarks(marks)
        # Respawned actors must start ABOVE every restored watermark
        # incarnation — otherwise the zombie fence rejects them.
        self._restored_incarnations = {
            int(aid): int(m.get("incarnation", 0)) + 1
            for aid, m in marks.items()
        }
        self.supervisor.load_stats(dec.get("fleet") or {})
        if self.elastic is not None:
            self.elastic.restore(dec.get("elastic"))
        if marks:
            logger.info(
                "restored transport watermarks for %d actors; "
                "respawns start at incarnations %s",
                len(marks), self._restored_incarnations,
            )

    # ------------------------------------------------------ epoch metrics

    def _epoch_boundary_hook(
        self, epoch, sentinel_ok, saved, last_metrics, rec
    ) -> None:
        super()._epoch_boundary_hook(
            epoch, sentinel_ok, saved, last_metrics, rec
        )
        tsnap = self.transport.snapshot()
        sup = self.supervisor.stats()
        last_metrics.update({
            "decoupled/actor_restarts": sup["restarts_total"],
            "decoupled/fleet_alive": sup["alive"],
            "decoupled/fleet_deaths_total": sup["deaths_total"],
            "decoupled/transport_accepted_total":
                tsnap["accepted_total"],
            "decoupled/transport_duplicate_pushes_total":
                tsnap["duplicate_pushes_total"],
            "decoupled/transport_rejected_malformed_total":
                tsnap["rejected_malformed_total"],
            "decoupled/transport_rejected_zombie_total":
                tsnap["rejected_zombie_total"],
        })
        # Per-actor lag labels (docs/OBSERVABILITY.md): sequence
        # watermark + heartbeat age per live fleet actor, keyed by
        # actor id — the per-actor view of "who is falling behind".
        for aid, a in tsnap["actors"].items():
            last_metrics[f"decoupled/actor{aid}_seq"] = float(a["seq"])
            last_metrics[f"decoupled/actor{aid}_heartbeat_age_s"] = (
                round(float(a["heartbeat_age_s"]), 3)
            )
        if self.elastic is not None:
            # Degrade newly abandoned slots, re-admit served ones —
            # the training-plane actuation point (epoch boundaries
            # only, so a re-admitted slice joins at a clean cut).
            self.elastic.poll_epoch(int(epoch))
            last_metrics.update(self.elastic.metrics())
        if rec is not None:
            rec.event(
                "fleet", epoch=int(epoch), transport=tsnap,
                supervisor=sup,
            )

    # ------------------------------------------------------ introspection

    def metrics_snapshot(self) -> dict:
        snap = super().metrics_snapshot()
        snap["decoupled"]["transport"] = self.transport.snapshot()
        snap["decoupled"]["fleet"] = self.supervisor.stats()
        if self.elastic is not None:
            snap["decoupled"]["elastic"] = self.elastic.snapshot()
        return snap

    def close(self):
        if self._fleet_started:
            self._fleet_started = False
            self.supervisor.shutdown()
        self.transport.close()
        super().close()

