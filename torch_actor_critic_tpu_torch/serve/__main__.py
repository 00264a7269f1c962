"""Policy-inference service CLI of the port (counterpart of ``serve.py``).

Two ways to point it at a model:

    # a tracked training run (<runs-root>/<experiment>/<run_id>, as the
    # port's train CLI writes it): env and config are read from the run
    python -m torch_actor_critic_tpu_torch.serve --run <id> \\
        [--experiment Default] [--runs-root runs]

    # a bare port checkpoint dir + explicit flat-obs geometry
    python -m torch_actor_critic_tpu_torch.serve --ckpt-dir DIR \\
        --obs-dim 3 --act-dim 1 --act-limit 2.0

Serves the newest epoch of a port actor checkpoint
(:mod:`torch_actor_critic_tpu_torch.utils.checkpoint`) over HTTP, with
hot-reload polling, and prints ``{"serving": <url>, "slots": ...}`` on
one line once it accepts requests. The model geometry comes from the
checkpoint's stored config, as the trainer builds it: ``history_len >
1`` is a sequence policy over ``(history_len, obs_dim)`` observations,
``algorithm="td3"`` TD3's deterministic actor, and a run on a pixel env
the visual actor over ``{"features", "frame"}`` observations (its spec
from one throwaway env of the port's own pool). SIGTERM drains (answers
every accepted request) and exits 0.

``--devices N`` (or ``all``) serves N engine replicas in this process
behind one admission layer (:mod:`.fleet`; on the CPU the N replicas
share the one host device); ``--serve-precision bf16|int8`` builds
every engine at that precision tier (:mod:`.sharded`); ``--submesh``
takes only ``1x1``; ``--fleet N``
spawns N worker processes on ephemeral ports and fronts them with the
health-gated router (:mod:`.router`) on ``--port``; ``--trace-export
PATH`` writes the request spans (or the router's hops, and the elastic
decisions) as a Perfetto trace at exit. Runs on the GPU unless
``--device cpu`` is given; the workers of ``--fleet`` share the card.

With ``--fleet N``: ``--obs`` runs the run-wide observability plane
(:mod:`~torch_actor_critic_tpu_torch.obs`: a collector thread scrapes
the router's and every worker's ``/metrics`` every ``--obs-interval``
seconds, merges them, evaluates the SLO rules of ``--slo-config`` (the
JAX grammar; default :func:`~..obs.slo.default_rules`) and serves the
merged view on ``--obs-port``); ``--warm-pool K`` keeps K warmed spare
workers off-rotation (:class:`~..aot.WarmPool`), one of which replaces
a worker that dies; ``--elastic on`` (needs both) scales the fleet
between ``--elastic-min`` and ``--elastic-max`` workers
(:class:`~..elastic.ElasticController` over a
:class:`~..elastic.FleetScaler`): a breached scale-out rule draws a
spare into rotation, ``--elastic-in-windows`` all-green windows drain
the newest worker. The router's ``/metrics`` then carries a ``fleet``
section (the pool's, the scaler's and the controller's counters). Off,
each of them constructs nothing.

``--log-transitions DIR`` logs served transitions into a replay disk
tier at DIR (:class:`~..replay.TransitionLogger`): every
``--log-sample-every``-th answered ``/act`` is noted under its
``X-Request-Id``, ``POST /outcome`` completes it, ``/metrics`` has a
``flywheel`` section, chunk files rotate out past ``--log-max-bytes``,
and the SIGTERM drain flushes the partial chunk; ``train --offline
--offline-dataset DIR`` trains from it. Under ``--fleet N`` worker ``i``
logs to ``DIR/worker-i``, as the JAX CLI does.

Cold start (:mod:`~torch_actor_critic_tpu_torch.aot`): ``--compile-cache
DIR`` builds and finds the kernel libraries in DIR (exported as
``TAC_COMPILE_CACHE`` to every child; without the flag a process joins
the directory its parent exported); ``--warm-start DIR|auto`` loads a
warm-start bundle (``auto``: ``<ckpt parent>/warm_start``, where ``train
--emit-bundle true`` writes it) before any engine is built: a bundle
whose fingerprint or libraries do not fit is rejected and counted
(``/metrics`` ``xla.bundle_rejected``), a fitting one supplies the
kernel libraries (no ``nvcc``) and, on one f32 replica, verifies every
program's signature at warm-up. Both flags reach ``--fleet`` workers and
warm spares through their argv.

Not ported, and refused with ``NotImplementedError`` naming their
ROADMAP queue: sub-meshes larger than 1x1 (queue 6) and ``--sanitize``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import typing as t

logger = logging.getLogger("serve")

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_arguments(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("Batched policy-inference service (PyTorch port).")
    src = p.add_argument_group("model source")
    src.add_argument("--run", type=str, default=None,
                     help="Tracked run id to serve (reads env + config)")
    src.add_argument("--experiment", default="Default")
    src.add_argument("--runs-root", default="runs")
    src.add_argument("--ckpt-dir", type=str, default=None,
                     help="Port actor checkpoint dir (epoch_<N>/actor.pt + "
                          "meta.json); needs --obs-dim/--act-dim")
    src.add_argument("--obs-dim", type=int, default=None)
    src.add_argument("--act-dim", type=int, default=None)
    src.add_argument("--act-limit", type=float, default=1.0)
    srv = p.add_argument_group("serving")
    srv.add_argument("--device", default=None,
                     help="torch device; default cuda (fails without a GPU)")
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument("--port", type=int, default=8321)
    srv.add_argument("--max-batch", type=int, default=64)
    srv.add_argument("--max-wait-ms", type=float, default=2.0)
    srv.add_argument("--batch-mode", choices=("continuous", "group"),
                     default="continuous")
    srv.add_argument("--devices", default="1",
                     help="Engine replicas in THIS process: an int or "
                          "'all' (one per visible card) behind a shared "
                          "admission layer and least-loaded dispatch")
    srv.add_argument("--submesh", default="1x1", metavar="TPxFSDP",
                     help="Devices per replica; only 1x1 is ported")
    srv.add_argument("--serve-precision", choices=("f32", "bf16", "int8"),
                     default="f32",
                     help="Numeric serving tier: f32 is bitwise the "
                          "single-device engine; bf16 computes at bf16 "
                          "width; int8 serves per-channel weight-"
                          "quantized params (dequantized in the graph)")
    srv.add_argument("--buckets", type=str, default=None,
                     help="Comma-separated bucket sizes (default: powers "
                          "of two from 2 up to max-batch)")
    srv.add_argument("--poll-interval", type=float, default=5.0,
                     help="Checkpoint hot-reload poll seconds (0 = off)")
    srv.add_argument("--seed", type=int, default=0,
                     help="Seed of the sampled-action generator")
    srv.add_argument("--sanitize", choices=("off", "on"), default="off",
                     help="Not ported (the JAX transfer guard)")
    srv.add_argument("--request-timeout", type=float, default=30.0,
                     help="Per-connection socket timeout in seconds")
    srv.add_argument("--act-timeout", type=float, default=30.0,
                     help="Max seconds to wait on the batcher before "
                          "answering 503 + Retry-After (also the request "
                          "deadline)")
    srv.add_argument("--trace-export", metavar="PATH", default=None,
                     help="Write a Perfetto (chrome://tracing) trace of the "
                          "per-request spans (router hops under --fleet) to "
                          "PATH at exit")
    aot = p.add_argument_group("cold start")
    aot.add_argument("--warm-start", metavar="DIR", default=None,
                     help="Warm-start bundle dir, or 'auto' (<ckpt parent>/"
                          "warm_start): its kernel libraries replace nvcc and "
                          "its program signatures are checked at warm-up; a "
                          "bundle that does not fit is rejected and counted")
    aot.add_argument("--compile-cache", metavar="DIR", default=None,
                     help="Kernel-library cache dir shared by this process and "
                          "its children (default: the package's _build/)")
    flt = p.add_argument_group("fleet (multi-process)")
    flt.add_argument("--fleet", type=int, default=0,
                     help="Spawn N worker processes and front them with the "
                          "health-gated fleet router on --port")
    flt.add_argument("--router-poll", type=float, default=1.0,
                     help="Fleet membership /healthz poll interval seconds")
    flt.add_argument("--warm-pool", type=int, default=0,
                     help="Keep N warmed spare workers (booted, graphs "
                          "captured) off-rotation behind the router; a dead "
                          "worker is replaced by drawing a spare")
    flt.add_argument("--obs", action="store_true",
                     help="Run-wide observability plane: a collector thread "
                          "scrapes the router and every worker's /metrics, "
                          "merges them, evaluates SLO rules and serves the "
                          "merged view on its own /metrics")
    flt.add_argument("--obs-port", type=int, default=0,
                     help="Port of the obs collector's endpoint (0 = "
                          "ephemeral; printed in the fleet's startup JSON)")
    flt.add_argument("--obs-interval", type=float, default=2.0,
                     help="Obs collector scrape interval seconds")
    flt.add_argument("--slo-config", metavar="PATH", default=None,
                     help="JSON list of SLO rules for the obs collector "
                          "(obs/slo.py grammar; default: the built-in rules)")
    flt.add_argument("--elastic", choices=("off", "on"), default="off",
                     help="SLO-driven autoscaling: a breached scale-out rule "
                          "draws a warm spare into rotation; sustained green "
                          "windows drain the newest worker. Needs --obs and "
                          "--warm-pool >= 1")
    flt.add_argument("--elastic-min", type=int, default=1,
                     help="Elastic lower replica bound")
    flt.add_argument("--elastic-max", type=int, default=4,
                     help="Elastic upper replica bound (breaches past it are "
                          "counted as bounded, not actuated)")
    flt.add_argument("--elastic-out-cooldown", type=float, default=10.0,
                     help="Per-rule scale-out cooldown seconds")
    flt.add_argument("--elastic-in-cooldown", type=float, default=30.0,
                     help="Scale-in cooldown seconds")
    flt.add_argument("--elastic-in-windows", type=int, default=5,
                     help="Consecutive all-green scrape windows before a "
                          "scale-in is considered")
    ovl = p.add_argument_group("overload & degradation")
    ovl.add_argument("--queue-capacity", type=int, default=1024)
    ovl.add_argument("--breaker-threshold", type=int, default=5)
    ovl.add_argument("--breaker-cooldown", type=float, default=5.0)
    ovl.add_argument("--reload-retries", type=int, default=1)
    ovl.add_argument("--reload-retry-backoff", type=float, default=0.5)
    ovl.add_argument("--drain-timeout", type=float, default=30.0)
    fwl = p.add_argument_group("data flywheel")
    fwl.add_argument("--log-transitions", metavar="DIR", default=None,
                     help="Log served transitions (obs/action from /act, outcome "
                          "from POST /outcome) into a replay disk tier at DIR — "
                          "the chunk format train --offline consumes")
    fwl.add_argument("--log-sample-every", type=int, default=1,
                     help="Keep every Nth answered /act (1 = keep all)")
    fwl.add_argument("--log-max-bytes", type=int, default=0,
                     help="Disk-tier byte budget for the transition log; oldest "
                          "chunk files rotate out past it (0 = unbounded)")
    return p.parse_args(argv)


_NOT_PORTED = (
    ("sanitize", "off", "--sanitize (the JAX transfer guard)", None),
)

# Flags that act on the fleet process only: with --fleet N the parent
# owns them, and a worker's argv drops them (_worker_argv).
_FLEET_FLAGS = (
    "--fleet", "--port", "--router-poll", "--trace-export", "--warm-pool",
    "--obs-port", "--obs-interval", "--slo-config", "--elastic",
    "--elastic-min", "--elastic-max", "--elastic-out-cooldown",
    "--elastic-in-cooldown", "--elastic-in-windows",
)


def check_ported(args: argparse.Namespace) -> t.Tuple[int, int]:
    """Refuse what the port does not serve; returns the sub-mesh."""
    from torch_actor_critic_tpu_torch.serve.sharded import check_submesh

    for name, off, what, queue in _NOT_PORTED:
        if getattr(args, name) != off:
            where = f" (ROADMAP queue {queue})" if queue else ""
            raise NotImplementedError(f"{what} is not ported{where}")
    try:
        submesh = tuple(int(x) for x in args.submesh.lower().split("x"))
        if len(submesh) != 2:
            raise ValueError
    except ValueError:
        raise SystemExit(
            f"--submesh wants TPxFSDP (e.g. 1x1), got {args.submesh!r}"
        ) from None
    if not args.fleet and (args.obs or args.warm_pool or args.elastic == "on"):
        raise SystemExit("--obs, --warm-pool and --elastic act on a fleet: pass --fleet N")
    if args.warm_pool < 0:
        raise SystemExit(f"--warm-pool must be >= 0, got {args.warm_pool}")
    if args.obs_interval <= 0:
        raise SystemExit(f"--obs-interval must be > 0, got {args.obs_interval}")
    if args.slo_config is not None and not args.obs:
        raise SystemExit("--slo-config needs --obs (the collector evaluates the rules)")
    if args.elastic == "on":
        if not args.obs:
            raise SystemExit(
                "--elastic on needs --obs (the controller consumes the obs "
                "collector's SLO scrape windows)")
        if args.warm_pool < 1:
            raise SystemExit(
                "--elastic on needs --warm-pool >= 1 (scale-out draws warm "
                "spares; it never cold-spawns on the serving path)")
    return check_submesh(submesh)


def obs_spec_for(config, obs_dim: int):
    """The served observation spec of a bare checkpoint: ``(history_len,
    obs_dim)`` for a sequence policy (``history_len > 1``), else
    ``(obs_dim,)``."""
    import numpy as np

    from torch_actor_critic_tpu_torch.serve.engine import ObsSpec

    shape = (
        (config.history_len, obs_dim) if config.history_len > 1 else (obs_dim,)
    )
    return ObsSpec(shape, np.float32)


def resolve_model(args: argparse.Namespace):
    """``(actor_def, obs_spec, act_dim, act_limit, ckpt_dir)`` from the
    CLI's model source (JAX ``serve.py`` ``_resolve_model``)."""
    from torch_actor_critic_tpu_torch.core.types import MultiObservation
    from torch_actor_critic_tpu_torch.models import build_actor
    from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer
    from torch_actor_critic_tpu_torch.utils.config import SACConfig

    if args.run is not None:
        from torch_actor_critic_tpu_torch.envs.vec_env import make_env_pool
        from torch_actor_critic_tpu_torch.utils.tracking import Tracker

        tracker = Tracker.load(args.run, experiment=args.experiment, root=args.runs_root)
        params = tracker.params()
        env_name = params.get("environment", "Humanoid-v5")
        config = SACConfig.from_json(json.dumps(params.get("config", {})))
        if config.history_len > 1:
            # The trainer's own wrapping: a sequence run is served over
            # (history_len, obs_dim) windows.
            env_name = f"{env_name}|history:{config.history_len}"
        # One throwaway env for its specs; closed before serving.
        pool = make_env_pool(env_name, 1, base_seed=0)
        try:
            obs_spec, act_dim, act_limit = pool.obs_spec, pool.act_dim, pool.act_limit
        finally:
            pool.close()
        ckpt_dir = str(tracker.artifact_path("checkpoints"))
        logger.info("serving run %s (%s)", args.run, env_name)
    else:
        if args.ckpt_dir is None:
            raise SystemExit("pass --run or --ckpt-dir (see --help)")
        if args.obs_dim is None or args.act_dim is None:
            raise SystemExit("--ckpt-dir needs --obs-dim and --act-dim")
        meta = Checkpointer(args.ckpt_dir).peek_meta()
        config = (
            SACConfig.from_json(meta["config"]) if meta.get("config") else SACConfig()
        )
        obs_spec = obs_spec_for(config, args.obs_dim)
        act_dim, act_limit, ckpt_dir = args.act_dim, args.act_limit, args.ckpt_dir
    shapes = (obs_spec.map(lambda s: tuple(s.shape))
              if isinstance(obs_spec, MultiObservation) else tuple(obs_spec.shape))
    actor_def = build_actor(config, shapes, act_dim, act_limit)
    return actor_def, obs_spec, act_dim, act_limit, ckpt_dir


def cold_start(args: argparse.Namespace, ckpt_dir: str, device):
    """Arm the kernel-library cache and the warm-start bundle before any
    engine is built (JAX ``serve.py``'s order). Returns the checked
    bundle, or None (no ``--warm-start``, no bundle there, or one
    rejected: counted on the watchdog, the kernels then come from the
    cache or ``nvcc``)."""
    from torch_actor_critic_tpu_torch.aot import (
        BundleMismatchError,
        default_bundle_dir,
        enable_cache_from_env,
        enable_persistent_cache,
        load_bundle,
    )
    from torch_actor_critic_tpu_torch.diagnostics.watchdog import get_watchdog

    if args.compile_cache:
        enable_persistent_cache(args.compile_cache)
    else:
        enable_cache_from_env()
    if not args.warm_start:
        return None
    bundle_dir = (default_bundle_dir(ckpt_dir) if args.warm_start == "auto"
                  else args.warm_start)
    try:
        bundle = load_bundle(bundle_dir)
        bundle.check(device)
    except FileNotFoundError as e:
        logger.warning("no warm-start bundle: %s", e)
        return None
    except BundleMismatchError as e:
        get_watchdog().note_bundle_rejected(f"{bundle_dir}: {e.reason}")
        return None
    bundle.arm()
    logger.info("warm-start bundle %s armed (%d programs)", bundle_dir, len(bundle.programs()))
    return bundle


def _devices(args, device_type: str):
    """``--devices`` as the server's ``devices``: None for one replica;
    on the CPU, N replicas of the one host device."""
    from torch_actor_critic_tpu_torch.serve.fleet import local_devices

    have = local_devices(device_type)
    n = len(have) if args.devices == "all" else int(args.devices)
    if n < 1:
        raise SystemExit(f"--devices must be >= 1, got {n}")
    if device_type == "cpu":
        return [have[0]] * n if n > 1 else None
    if n > len(have):
        raise SystemExit(f"--devices {n}: only {len(have)} {device_type} device(s)")
    return n if n > 1 else None


def build_server(args: argparse.Namespace, span_log=None):
    """Registry + warmed slot + (not yet started) server from parsed
    CLI args: the path :func:`main` serves, shared with smoke scripts.
    Returns ``(server, info)``."""
    from torch_actor_critic_tpu_torch.serve import (
        CircuitBreaker,
        ModelRegistry,
        PolicyServer,
    )

    check_ported(args)
    actor_def, obs_spec, act_dim, act_limit, ckpt_dir = resolve_model(args)
    buckets = (
        [int(b) for b in args.buckets.split(",")] if args.buckets else None
    )
    registry = ModelRegistry(
        reload_retries=args.reload_retries,
        reload_retry_backoff_s=args.reload_retry_backoff,
        device=args.device,
        precision=args.serve_precision,
    )
    devices = _devices(args, registry.device.type)
    bundle = cold_start(args, ckpt_dir, registry.device)
    info = registry.register(
        "default", actor_def, obs_spec,
        ckpt_dir=ckpt_dir, max_batch=args.max_batch, buckets=buckets,
        breaker=CircuitBreaker(
            fail_threshold=args.breaker_threshold,
            cooldown_s=args.breaker_cooldown,
        ),
        # The fleet's replicas serve every forward (and warm their own
        # buckets); warming the registry's engine too would capture
        # graphs nothing replays.
        warmup=devices is None,
        # The bundle's programs are one f32 engine's (the JAX CLI also
        # bundles the unsharded f32 forward only); other tiers still
        # load the bundle's libraries.
        bundle=bundle if args.serve_precision == "f32" else None,
    )
    if args.poll_interval > 0:
        registry.start_polling(args.poll_interval)
    server = PolicyServer(
        registry, host=args.host, port=args.port,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        seed=args.seed,
        request_timeout_s=args.request_timeout,
        act_timeout_s=args.act_timeout,
        capacity=args.queue_capacity,
        span_log=span_log,
        mode=args.batch_mode,
        devices=devices,
        transition_logger=transition_logger(args, obs_spec, act_dim, act_limit),
    )
    return server, info


def transition_logger(args: argparse.Namespace, obs_spec, act_dim: int, act_limit: float):
    """``--log-transitions DIR``'s :class:`~..replay.TransitionLogger`
    over the served slot's spec (``None`` without the flag)."""
    if not args.log_transitions:
        return None
    from torch_actor_critic_tpu_torch.replay import TransitionLogger

    out = TransitionLogger(
        args.log_transitions, obs_spec, act_dim, act_limit=act_limit,
        sample_every=args.log_sample_every, max_bytes=args.log_max_bytes,
    )
    logger.info("transition flywheel: logging 1/%d served acts to %s (budget %s)",
                args.log_sample_every, args.log_transitions,
                args.log_max_bytes or "unbounded")
    return out


# ------------------------------------------------------------------ fleet


def _worker_argv(argv, worker: int | None = None):
    """One fleet worker's argv: the parent's args minus the fleet flags
    (:data:`_FLEET_FLAGS`; the router writes its own trace), with an
    ephemeral port (each worker prints its address; the parent reads it
    back); worker ``worker`` logs transitions under
    ``<--log-transitions>/worker-<worker>``."""
    import sys

    src = list(sys.argv[1:] if argv is None else argv)
    out, skip = [], False
    for a in src:
        if skip:
            skip = False
            continue
        if a in _FLEET_FLAGS:
            skip = True
            continue
        if a == "--obs" or a.split("=", 1)[0] in _FLEET_FLAGS:
            continue
        out.append(a)
    if worker is not None:
        for i, a in enumerate(out):
            if a == "--log-transitions" and i + 1 < len(out):
                out[i + 1] = os.path.join(out[i + 1], f"worker-{worker}")
            elif a.startswith("--log-transitions="):
                out[i] = "--log-transitions=" + os.path.join(a.split("=", 1)[1],
                                                             f"worker-{worker}")
    return out + ["--port", "0"]


def _await_worker_ready(proc, idx: int, timeout_s: float = 300.0) -> str:
    """The worker's serving address from its startup JSON line; raises
    RuntimeError if it dies or stays silent past the deadline. A daemon
    thread then keeps draining its stdout (a full pipe would wedge it)."""
    import threading
    import time

    address, deadline = None, time.time() + timeout_s
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"fleet worker {idx} exited rc={proc.returncode} "
                    "before becoming ready"
                )
            time.sleep(0.1)
            continue
        if line.startswith("{"):
            try:
                address = json.loads(line)["serving"]
                break
            except (json.JSONDecodeError, KeyError):
                continue
    if address is None:
        raise RuntimeError(f"fleet worker {idx} never printed its address")

    def _pump(stream=proc.stdout, i=idx):
        for out_line in stream:
            logger.debug("worker %d: %s", i, out_line.rstrip())

    threading.Thread(target=_pump, daemon=True).start()
    return address


def _spawn_worker(argv, worker: int | None = None):
    """One worker (number ``worker``): ``python -m
    torch_actor_critic_tpu_torch.serve`` on an ephemeral port."""
    import subprocess
    import sys

    return subprocess.Popen(
        [sys.executable, "-m", "torch_actor_critic_tpu_torch.serve"]
        + _worker_argv(argv, worker),
        stdout=subprocess.PIPE, stderr=None, text=True, cwd=_REPO,
    )


def run_fleet(args, argv) -> None:
    """``--fleet N``: spawn N workers, front them with the router.

    Each worker is a full serving process (own engines, drain, breaker
    and reload machinery); the router owns membership and rolling
    reload. SIGTERM to THIS process rolls the fleet down: the workers
    (and any warm spare) get SIGTERM (their drain answers everything
    accepted), then the router stops. A worker dying on its own is not
    fatal: membership ejects it and the others keep serving; with
    ``--warm-pool K`` a warmed spare is drawn to replace it. ``--obs``
    and ``--elastic on`` wire the collector and the controller as JAX
    ``serve.py`` ``run_fleet`` does."""
    import itertools
    import signal
    import subprocess
    import threading

    from torch_actor_critic_tpu_torch.serve.router import FleetRouter

    check_ported(args)
    if args.compile_cache:
        # Exported to every worker and spare (their argv carries it too).
        from torch_actor_critic_tpu_torch.aot import enable_persistent_cache

        enable_persistent_cache(args.compile_cache)
    workers = [_spawn_worker(argv, i) for i in range(args.fleet)]
    worker_lock = threading.Lock()
    try:
        addresses = [_await_worker_ready(proc, i) for i, proc in enumerate(workers)]
    except BaseException:
        for proc in workers:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        raise
    logger.info("fleet up: %d workers %s", len(addresses), addresses)
    span_log = None
    if args.trace_export:
        from torch_actor_critic_tpu_torch.telemetry.traceview import RequestSpanLog

        span_log = RequestSpanLog()
    router = FleetRouter(
        addresses, host=args.host, port=args.port,
        poll_interval_s=args.router_poll,
        request_timeout_s=args.request_timeout,
        span_log=span_log,
    )
    router.poll_once()

    # The run-wide obs plane: one collector thread scrapes the router's
    # aggregated /metrics and every worker's own, merges them and
    # evaluates the SLO rules. A worker dying mid-scrape is a counted
    # scrape failure, never a collector crash.
    obs = None
    if args.obs:
        from torch_actor_critic_tpu_torch.obs import ObsCollector, http_source, load_rules

        obs = ObsCollector(
            interval_s=args.obs_interval, port=args.obs_port,
            rules=load_rules(args.slo_config) if args.slo_config else None,
        )
        obs.add_source("router", http_source(router.address))
        for i, addr in enumerate(addresses):
            obs.add_source(f"w{i}", http_source(addr))
        obs.start()
        logger.info("obs collector serving on %s", obs.address)

    # Warm spares: each a booted worker with its graphs captured, off
    # rotation; the monitor below draws one when a live worker dies.
    pool = scaler = controller = decision_log = None
    # Every spare ever spawned: the teardown's last sweep (a spare still
    # booting when the pool shuts down outlives the pool's join).
    spares: list = []
    worker_names: t.Dict[int, str] = {}  # id(proc) -> router name
    monitor_stop = threading.Event()
    if args.warm_pool > 0:
        from torch_actor_critic_tpu_torch.aot import WarmPool

        spare_idx = itertools.count(args.fleet)

        def _spawn_spare():
            idx = next(spare_idx)
            proc = _spawn_worker(argv, idx)
            with worker_lock:
                spares.append(proc)
            try:
                return proc, _await_worker_ready(proc, idx)
            except BaseException:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
                raise

        def _kill_worker(proc):
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(timeout=args.drain_timeout + 30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=30)

        pool = WarmPool(_spawn_spare, _kill_worker, size=args.warm_pool)

        # The controller rides the obs scrape thread (window_hook); with
        # --elastic off the hook stays None.
        if args.elastic == "on":
            from torch_actor_critic_tpu_torch.elastic import (
                DecisionLog,
                ElasticController,
                ElasticPolicy,
                FleetScaler,
            )

            decision_log = DecisionLog()

            def _on_drain_select(name, proc):
                # Disown the scale-in victim BEFORE its SIGTERM, so its
                # exit never reads as a crash the monitor would
                # "replace" from the pool.
                worker_names.pop(id(proc), None)
                with worker_lock:
                    if proc in workers:
                        workers.remove(proc)

            scaler = FleetScaler(
                router, pool, obs=obs,
                drain_exit_timeout_s=args.drain_timeout + 30,
                obs_source=http_source,
                on_drain_select=_on_drain_select,
            )
            for i, (proc, addr) in enumerate(zip(workers, addresses)):
                worker_names[id(proc)] = f"w{i}"
                scaler.register(f"w{i}", proc, addr)
            controller = ElasticController(
                scaler,
                policy=ElasticPolicy(
                    min_replicas=args.elastic_min,
                    max_replicas=args.elastic_max,
                    scale_out_cooldown_s=args.elastic_out_cooldown,
                    scale_in_cooldown_s=args.elastic_in_cooldown,
                    scale_in_ok_windows=args.elastic_in_windows,
                ),
                log=decision_log, plane="serve",
            )
            obs.window_hook = controller.observe_window
            logger.info(
                "elastic controller on: replicas [%d, %d], out-cooldown %.1fs, in after "
                "%d green windows + %.1fs cooldown", args.elastic_min, args.elastic_max,
                args.elastic_out_cooldown, args.elastic_in_windows, args.elastic_in_cooldown,
            )

        def _monitor():
            handled = set()
            while not monitor_stop.wait(max(args.router_poll, 0.2)):
                with worker_lock:
                    dead = [p for p in workers
                            if p.poll() is not None and id(p) not in handled]
                for proc in dead:
                    handled.add(id(proc))
                    if scaler is not None:
                        # The scaler stops counting the corpse before the
                        # controller's next window.
                        dead_name = worker_names.pop(id(proc), None)
                        if dead_name is not None:
                            scaler.forget(dead_name)
                    drawn = pool.draw(timeout=30.0)
                    if drawn is None:
                        logger.warning("worker pid %d died and no warm spare was ready; "
                                       "relying on the surviving workers", proc.pid)
                        continue
                    with worker_lock:
                        workers.append(drawn.handle)
                    name = router.add_worker(drawn.address)
                    worker_names[id(drawn.handle)] = name
                    if scaler is not None:
                        scaler.register(name, drawn.handle, drawn.address)
                    if obs is not None:
                        obs.add_source(name, http_source(drawn.address))
                    logger.info("worker pid %d died; warm spare admitted as %s at %s "
                                "(pool: %s)", proc.pid, name, drawn.address, pool.stats())

        threading.Thread(target=_monitor, name="warm-pool-monitor", daemon=True).start()

        # The router's /metrics grows a "fleet" section; with no pool
        # the hook stays None and the key absent.
        def _fleet_extra():
            out = {"warm_pool": pool.stats()}
            if scaler is not None:
                out["scaler"] = scaler.stats()
            if controller is not None:
                out["elastic"] = controller.snapshot()
            return out

        router.fleet_extra = _fleet_extra

    torn_down = threading.Lock()

    def _teardown(signum=None, frame=None):
        if not torn_down.acquire(blocking=False):
            return
        monitor_stop.set()
        if obs is not None:
            # No scale decision races the teardown's drain.
            obs.window_hook = None
        with worker_lock:
            procs = list(workers)
            idle = [p for p in spares if p not in procs]
        # Spares first (a booting one would hold the pool's join), then
        # the pool stops refilling.
        for proc in idle:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        if pool is not None:
            pool.shutdown()
        procs.extend(idle)
        if scaler is not None:
            # Elastic-spawned workers live in the scaler's registry.
            known = {id(p) for p in procs}
            procs.extend(h for h in scaler.handles() if id(h) not in known)
        logger.info("fleet teardown: draining %d workers", len(procs))
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in procs:
            try:
                proc.wait(timeout=args.drain_timeout + 30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        if scaler is not None:
            scaler.shutdown(join_timeout=5.0)
        router._httpd.shutdown()

    signal.signal(signal.SIGTERM, lambda s, f: threading.Thread(
        target=_teardown, daemon=True).start())
    with worker_lock:
        pids = [proc.pid for proc in workers]
    print(json.dumps({
        "router": router.address,
        "workers": {f"w{i}": a for i, a in enumerate(addresses)},
        "pids": pids,
        "warm_pool": pool.stats() if pool is not None else None,
        "obs": obs.address if obs is not None else None,
        "elastic": args.elastic,
    }), flush=True)
    try:
        router.serve_forever()
    finally:
        _teardown()
        if obs is not None:
            obs.close()
            for line in obs.slo.report().splitlines():
                logger.info("%s", line)
        if span_log is not None:
            from torch_actor_critic_tpu_torch.telemetry.traceview import (
                elastic_decision_events,
                export_trace,
                router_hop_events,
            )

            groups = [router_hop_events(span_log.records())]
            if decision_log is not None:
                groups.append(elastic_decision_events(decision_log.records()))
            summary = export_trace(args.trace_export, *groups)
            logger.info("router trace exported to %s (%d hop spans, %d elastic spans)",
                        summary["path"], summary["router_spans"],
                        summary.get("elastic_spans", 0))


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_arguments(argv)
    if args.fleet and args.fleet > 0:
        run_fleet(args, argv)
        return
    from torch_actor_critic_tpu_torch.serve import install_drain_handler

    span_log = None
    if args.trace_export:
        from torch_actor_critic_tpu_torch.telemetry.traceview import RequestSpanLog

        span_log = RequestSpanLog()
    server, info = build_server(args, span_log=span_log)
    logger.info("model loaded: %s", info)
    install_drain_handler(server, flush_timeout_s=args.drain_timeout)
    print(json.dumps({
        "serving": server.address, "slots": server.registry.slots(),
    }), flush=True)
    try:
        server.serve_forever()
    finally:
        if server.transition_logger is not None:
            # The partial chunk, so a drained worker's last transitions
            # reach the dataset.
            server.transition_logger.close()
        if span_log is not None:
            from torch_actor_critic_tpu_torch.telemetry.traceview import (
                export_trace,
                serve_request_events,
            )

            summary = export_trace(
                args.trace_export, serve_request_events(span_log.records()))
            logger.info("trace exported to %s (%d request spans)",
                        summary["path"], summary["serve_spans"])


if __name__ == "__main__":
    main()
