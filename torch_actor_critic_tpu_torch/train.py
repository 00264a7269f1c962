"""Training CLI of the port (port of ``train.py``)::

    python -m torch_actor_critic_tpu_torch.train --environment Pendulum-v1 \\
        --history-len 16 [--device cpu|cuda] [--seed N] [--runs-root DIR]

    # the visual (pixel) policy, frames sampled through the kernel K1
    python -m torch_actor_critic_tpu_torch.train \\
        --environment PixelPendulumBalanceNumpy-v0 --filters 16,32 \\
        --kernel-sizes 4,3 --strides 2,2 --cnn-dense-size 128 \\
        --cnn-features 64 --normalize-pixels true --frame-augment shift \\
        --learn-alpha true --pixel-pipeline fused

    # TD3 (its DDPG corner: --policy-delay 1 --target-noise 0 --num-qs 1),
    # flat or visual; a history (--history-len > 1) raises ValueError
    python -m torch_actor_critic_tpu_torch.train --algorithm td3 \
        --environment PendulumNumpy-v1

    # resume a run where its newest checkpoint left it
    python -m torch_actor_critic_tpu_torch.train --run <id> [--runs-root DIR]

    # the fused on-device loop: 16 pendulum twins, replay and learner on
    # the card (a history and TD3 as above; PixelPendulum[Balance]-v0 too)
    python -m torch_actor_critic_tpu_torch.train --on-device true \
        --environment Pendulum-v1 --history-len 8 [--on-device-envs 16] [--utd 1]

    # a fused population of 32 SAC members with on-device PBT (the
    # cheetah twin; --history-len 8 on Pendulum-v1 trains the sequence stack,
    # PixelPendulum[Balance]-v0 the visual one; --algorithm td3 TD3 members)
    python -m torch_actor_critic_tpu_torch.train --on-device true \
        --environment HalfCheetah-v5 --population 32 --pbt-every 5 --pbt-quantile 0.25

    # a host-loop population: 4 members, one host env each, one learner
    # burst for all of them (--history-len 16 the sequence members; a pixel
    # env the visual ones; --algorithm td3 TD3 members)
    python -m torch_actor_critic_tpu_torch.train --environment PendulumNumpy-v1 \
        --population 4

    # the host envs in worker processes of their own (the native parallel
    # pool), acting one update window stale beside the burst; with or
    # without --population
    python -m torch_actor_critic_tpu_torch.train --environment PendulumNumpy-v1 \
        --population 4 --parallel-envs true --actor-param-lag true

    # the observability plane (every trainer, at any population): phase
    # spans, memory watermarks and cost events in <run>/telemetry.jsonl,
    # in-graph diagnostics, a device trace of epoch 1 under <run>/trace/,
    # and a Perfetto timeline at exit
    python -m torch_actor_critic_tpu_torch.train --environment PendulumNumpy-v1 \
        --history-len 16 --telemetry true --diagnostics full \
        --profile-epochs 1:2 --trace-export trace.json

    # a host population under the plane: each diag/* reduced over the
    # members too (the mean of the members' own gradient norms, ...),
    # reward_m{i} in obs.jsonl's learner source
    python -m torch_actor_critic_tpu_torch.train --environment PendulumNumpy-v1 \
        --population 4 --telemetry true --diagnostics light --obs true

    # a fused population with PBT: one pbt event per exploit/explore step
    # and a train/population_epoch cost event per epoch
    python -m torch_actor_critic_tpu_torch.train --on-device true \
        --environment HalfCheetah-v5 --population 32 --pbt-every 5 --telemetry true

Every ``SACConfig`` field is a flag (``--batch-size``, ``--learn-alpha
true``, ...), built by the JAX CLI's loop. ``--run <id>`` takes the
config, environment and seed from the run's stored params (the flags
are ignored, as in the JAX CLI) and resumes from its newest checkpoint
(full state: learner, replay ring, step counter, normalizer, acting
generator), training ``epochs`` more epochs. A SIGTERM/SIGINT finishes
the epoch, saves it and exits with code 75 (a second signal saves at
the next update window); ``--no-preemption-guard`` leaves the signals
alone. A pixel env
(``PixelPendulum[Balance]-v0`` over gymnasium,
``PixelPendulum[Balance]Numpy-v0`` without it) selects the visual models
and a uint8 frame ring. Runs on the card unless
``--device cpu`` is given; without a card and without that flag it
exits non-zero. Prints one JSON line per epoch and a final line naming
the checkpoint directory (and, with ``--eval-episodes N``, the return of
N deterministic evaluation episodes), which ``python -m
torch_actor_critic_tpu_torch.serve --ckpt-dir DIR`` serves.
``--no-save-buffer`` leaves the replay ring out of the checkpoints (a
resumed run starts with an empty ring, as in JAX).

``--on-device true`` routes to the fused loop
(:func:`~.sac.ondevice.train_on_device`) before the host trainer, as the
JAX CLI does, for an env with an on-device twin (``Pendulum-v1``,
``PixelPendulum[Balance]-v0`` and the port's ``...Numpy`` names for
them); another env raises, naming the twins. There the preemption guard
is not installed and ``--eval-episodes`` is ignored (as in JAX);
``run_agent`` evaluates the run on the host env. With ``--population N``
> 1 it routes to the fused population
(:func:`~.sac.ondevice.train_population_on_device`, per-member metrics
``loss_q_m0``, ... and, with ``--pbt-every K``, an on-device PBT step
every K epochs); ``run_agent`` evaluates one member of it. Without
``--on-device``, ``--population N`` > 1 trains N members in the host
trainer (one env each; per-member metrics ``reward_m0``, ...;
``--eval-episodes`` reports each member under ``per_member``), as the
JAX CLI does; ``--pbt-every`` there raises ``ValueError``, as in JAX.
The scenario envs and ``--devices`` > 1 raise ``NotImplementedError``.

``--compile-cache DIR`` builds and finds the kernel libraries in DIR
(exported as ``TAC_COMPILE_CACHE`` to every child), so a learner
restarted with ``--run <id>`` builds none; ``--emit-bundle true`` writes
a warm-start bundle for ``serve --warm-start auto`` next to the
checkpoints at the first epoch with updates (``--bundle-max-batch``
sets its bucket ladder; the host trainer only, as in JAX).

``--telemetry true`` (implied by ``--profile-epochs`` and
``--trace-export``) streams the trainer's telemetry to
``<run>/telemetry.jsonl``: a ``run_start`` line; per epoch an ``epoch``
event (the eight phases' seconds, counts and maxima, the host/device/
input attribution, the card's memory watermarks; on the fused loop the
epoch's launch and read as ``burst_dispatch`` and ``drain``), a
``cost`` event (the update burst's — or fused epoch's — counted FLOPs
and bytes, achieved rate and MFU against the card's peak) and, with
``--diagnostics light|full``, a ``diagnostics`` event (the epoch's
reduced in-graph metrics; ``full`` adds the |TD| histogram);
``early_warning``, ``recompile_anomaly``, ``rollback`` and
``preempted`` as they happen. ``--profile-epochs A:B`` writes a
``torch.profiler`` Chrome trace of epochs ``[A, B)`` to
``<run>/trace/``; ``--profile DIR`` one of the whole run to
``DIR/trace.json``; ``--trace-export PATH`` a Perfetto timeline of the
recorded phase spans and the watchdog's captures and builds at exit.
A population runs all of these on the host loop, and ``--obs true``:
one stacked update is counted (every member's work), and each
``diag/*`` column is reduced over the bursts and the members, as the
JAX trainer reduces them. The fused population (``--on-device true
--population N``) runs ``--telemetry``, ``--profile-epochs`` and
``--trace-export``, its epoch's cost as ``train/population_epoch`` and
a ``pbt`` event per exploit/explore step (``epoch``, ``exploited``,
``src``, ``ready``, ``return_ema``, ``hyperparams``); its
``--diagnostics`` runs at ``off`` with a warning, as JAX's does, and it
refuses ``--obs`` (JAX's fused loop builds no collector).

``--replay-tiers host|disk`` puts the host and disk tiers under the
ring (``--replay-refill R`` pushes R host rows back into it after each
window's burst; ``--replay-prefetch false`` samples them synchronously):
each epoch's line adds the ``replay/*`` columns. ``--offline true
--offline-dataset DIR --offline-reg none|bc|cql`` trains from a disk tier
alone (the trainer's spill, or ``serve --log-transitions``, of either
package), with no env and no ring: one JSON line per burst, then the
final line naming the checkpoint, which ``serve --run`` serves::

    python -m torch_actor_critic_tpu_torch.train --environment PendulumNumpy-v1 \
        --history-len 16 --replay-tiers disk --replay-refill 2
    python -m torch_actor_critic_tpu_torch.train --environment PendulumNumpy-v1 \
        --history-len 16 --offline true --offline-dataset DIR --offline-reg cql

``--decoupled true`` acts through the serving plane (an in-process
registry and micro-batcher on the card, or the worker at ``--serve-url
URL``, whose reload poller takes each epoch's checkpoint as the publish),
stages tagged transitions in a bounded buffer behind a staleness gate
(``--max-actor-lag``, ``--staging-capacity``, ``--staging-policy``) and
publishes each validated epoch; ``--actors N`` adds N supervised actor
processes (host only: they act over HTTP through the learner's ``/act``
proxy) feeding the same buffer over the staging transport; ``--elastic
on`` (with ``--actors`` >= 1) degrades to the surviving actor slice when a
slot exhausts its restarts and re-admits it after
``--elastic-readmit-epochs``. Each epoch's line adds the ``decoupled/*``
columns (and ``elastic/*``). SIGTERM and ``--run <id>`` resume them with
the staged tail, the transport's dedup watermarks and the serving
generator::

    python -m torch_actor_critic_tpu_torch.train --environment PendulumNumpy-v1 \
        --history-len 16 --decoupled true
    python -m torch_actor_critic_tpu_torch.train --environment PendulumNumpy-v1 \
        --history-len 16 --actors 2 --elastic on

``--render`` renders env 0 after each lockstep step of the host loop, as
the JAX CLI does: dm_control envs (``dm:<domain>:<task>``,
``DeepMindWallRunner-v0``) and the port's own envs through their no-op
paths; a gymnasium env is built with ``render_mode="human"`` when a
display is there, and otherwise the run warns and trains headless::

    python -m torch_actor_critic_tpu_torch.train --environment dm:cheetah:run \
        --learn-alpha true --render

Not ported: ``--devices`` > 1, ``--fsdp``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging

from torch_actor_critic_tpu_torch.utils.config import SACConfig

logger = logging.getLogger(__name__)


def parse_arguments(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        "Actor-critic (SAC or TD3) trainer of the PyTorch port (one CUDA device)."
    )
    parser.add_argument("--experiment", default="Default", help="Experiment name")
    parser.add_argument(
        "--run", default=None,
        help="Resume this run id (config, environment and seed from its stored params)",
    )
    parser.add_argument(
        "--no-preemption-guard", dest="preemption_guard", action="store_false",
        help="Do not turn SIGTERM/SIGINT into a checkpoint and exit code 75",
    )
    parser.add_argument(
        "--disable-logging", dest="logging", action="store_false",
        help="Turn off file tracking",
    )
    parser.add_argument(
        "--render", dest="render", action="store_true", help="Render the environment"
    )
    parser.add_argument("--environment", default="HalfCheetah-v5", help="Environment to use")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--devices", type=int, default=1,
        help="Devices to train on; only 1 is ported",
    )
    parser.add_argument(
        "--no-save-buffer", dest="save_buffer", action="store_false",
        help="Leave the replay ring out of the checkpoints",
    )
    parser.add_argument("--runs-root", default="runs", help="Tracking root directory")
    parser.add_argument(
        "--profile", metavar="DIR", default=None,
        help="Write a torch.profiler Chrome trace of the whole run to DIR/trace.json "
        "(profile short runs: --epochs 2 --steps-per-epoch 500)",
    )
    parser.add_argument(
        "--profile-epochs", metavar="A:B", default=None,
        help="Trace the half-open epoch window A:B into <run_dir>/trace (a "
        "torch.profiler Chrome trace); implies --telemetry true",
    )
    parser.add_argument(
        "--trace-export", metavar="PATH", default=None,
        help="Write a Perfetto (chrome://tracing) timeline to PATH at exit: every "
        "recorded training phase span and the watchdog's graph captures and kernel "
        "builds; implies --telemetry true",
    )
    parser.add_argument(
        "--device", default=None,
        help="cuda (default; fails without a card) or cpu",
    )
    parser.add_argument(
        "--precision", choices=("f32", "bf16"), default=None,
        help="Alias of --compute-dtype",
    )
    parser.add_argument(
        "--eval-episodes", type=int, default=0,
        help="After training, roll out this many deterministic episodes "
        "(episode i reset with seed + 12345 + i, as the JAX package's "
        "evidence runs do) and report their return",
    )
    # Every SACConfig field becomes a flag (--batch-size, --learn-alpha, ...).
    for f in dataclasses.fields(SACConfig):
        flag = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(f.default, bool):
            parser.add_argument(
                flag, type=lambda s: s.lower() in ("1", "true", "yes"), default=None
            )
        elif isinstance(f.default, tuple):
            parser.add_argument(
                flag, type=lambda s: tuple(int(x) for x in s.split(",")), default=None
            )
        elif f.name == "target_entropy":
            parser.add_argument(flag, type=float, default=None)
        else:
            parser.add_argument(flag, type=type(f.default), default=None)
    parser.set_defaults(logging=True, preemption_guard=True, save_buffer=True, render=False)
    return parser.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> SACConfig:
    overrides = {
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(SACConfig)
        if getattr(args, f.name, None) is not None
    }
    if args.precision is not None:
        want = {"f32": "float32", "bf16": "bfloat16"}[args.precision]
        have = overrides.get("compute_dtype")
        if have is not None and {"f32": "float32", "bf16": "bfloat16"}.get(have, have) != want:
            raise ValueError(
                f"--precision {args.precision} conflicts with "
                f"--compute-dtype {have}; pass one"
            )
        overrides["compute_dtype"] = want
    return SACConfig(**overrides)


def run_setup(args: argparse.Namespace):
    """``(config, env_name, seed, tracker, checkpointer)`` from parsed CLI
    args: with ``--run`` the run's stored params give the config,
    environment and seed; else the flags do, and a new run stores them."""
    from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer
    from torch_actor_critic_tpu_torch.utils.tracking import Tracker

    if args.devices != 1:
        raise NotImplementedError(
            f"--devices {args.devices}: training on more than one device is not ported yet")
    if args.run is not None:
        tracker = Tracker.load(args.run, experiment=args.experiment, root=args.runs_root)
        stored = tracker.params()
        config = SACConfig.from_json(json.dumps(stored.get("config", {})))
        env_name = stored.get("environment", args.environment)
        seed = stored.get("seed", args.seed)
    else:
        config = config_from_args(args)
        env_name, seed = args.environment, args.seed
        tracker = Tracker(
            experiment=args.experiment, root=args.runs_root, enabled=args.logging
        )
        tracker.log_params({
            "environment": env_name,
            "config": json.loads(config.to_json()),
            "buffer_size": config.buffer_size,
            "seed": seed,
        })
    cold_start(config)
    checkpointer = Checkpointer(tracker.artifact_path("checkpoints"),
                                save_buffer=args.save_buffer)
    return config, env_name, seed, tracker, checkpointer


def cold_start(config) -> None:
    """Arm the kernel-library cache before anything launches a kernel
    (JAX ``train.py``'s order): ``compile_cache`` (a ``--run`` restart
    reads it from the run's stored config) is exported to every child
    (fleet actors, the run's serve workers); without it, a process
    joins the directory its parent exported."""
    from torch_actor_critic_tpu_torch.aot import enable_cache_from_env, enable_persistent_cache

    if config.compile_cache:
        enable_persistent_cache(config.compile_cache)
    else:
        enable_cache_from_env()


def observability(args: argparse.Namespace, config) -> dict:
    """The trainer's keyword arguments for ``--profile-epochs`` and
    ``--trace-export`` (each implies ``--telemetry true``: the trainer
    builds its recorder with ``TelemetryRecorder.for_run``), at any
    population."""
    from torch_actor_critic_tpu_torch.telemetry.profiler import parse_profile_epochs

    window = parse_profile_epochs(getattr(args, "profile_epochs", None))
    trace_export = getattr(args, "trace_export", None)
    if not (config.telemetry or window or trace_export):
        return {}
    return {"profile_epochs": window, "trace_export": trace_export}


def raise_trace_buffer(args: argparse.Namespace) -> None:
    """For a profiled run on the card (``--profile``, ``--profile-epochs``),
    Kineto's device buffer raised (``trace_buffers``) once, before the
    process's first trace, unless the process names a Kineto config."""
    import os

    import torch

    from torch_actor_critic_tpu_torch.telemetry.profiler import trace_buffers

    if not (args.profile or args.profile_epochs) or "KINETO_CONFIG" in os.environ:
        return
    if torch.device(args.device or "cuda").type == "cuda":
        trace_buffers()


def profiled(args: argparse.Namespace, fn):
    """``fn()``, under a whole-run ``torch.profiler`` trace written to
    ``DIR/trace.json`` with ``--profile DIR``."""
    if getattr(args, "profile", None) is None:
        return fn()
    import os

    from torch_actor_critic_tpu_torch.telemetry.profiler import start_profile, stop_profile

    device = args.device or "cuda"
    prof = start_profile(device)
    try:
        return fn()
    finally:
        path = stop_profile(prof, os.path.join(args.profile, "trace.json"), device)
        logger.info("profiler trace written to %s", path)


def trainer_class(config) -> type:
    """The trainer the config selects, as the JAX CLI picks it (a resume
    takes it from the run's stored config): ``--actors N`` the supervised
    actor fleet over the decoupled learner, ``--decoupled true`` the
    decoupled learner (serving in-process, or at ``--serve-url``), else
    the lockstep trainer."""
    if config.actors > 0:
        from torch_actor_critic_tpu_torch.decoupled import FleetTrainer

        logger.info(
            "actor fleet: %d supervised actor processes, max_restarts=%d, heartbeat="
            "%.2fs/%.2fs, staging=%d (%s), elastic %s",
            config.actors, config.actor_max_restarts, config.heartbeat_interval_s,
            config.heartbeat_timeout_s, config.resolved_staging_capacity,
            config.staging_policy, config.elastic,
        )
        return FleetTrainer
    if config.decoupled:
        from torch_actor_critic_tpu_torch.decoupled import DecoupledTrainer

        logger.info(
            "decoupled actor/learner: serving=%s, max_actor_lag=%d, staging=%d (%s)",
            config.serve_url or "in-process", config.max_actor_lag,
            config.resolved_staging_capacity, config.staging_policy,
        )
        return DecoupledTrainer
    from torch_actor_critic_tpu_torch.sac.trainer import Trainer

    return Trainer


def build_trainer(args: argparse.Namespace, preemption=None, setup=None):
    """Tracker, checkpointer and trainer (:func:`trainer_class`) from
    parsed CLI args — the path :func:`main` trains, shared with smoke
    scripts. With
    ``--run`` the run's stored params give the config, environment and
    seed, and the trainer is restored from the run's newest checkpoint.
    ``setup`` is :func:`run_setup`'s result, when the caller has it.
    Returns ``(trainer, tracker)``."""
    config, env_name, seed, tracker, checkpointer = setup or run_setup(args)
    trainer_cls = trainer_class(config)
    trainer = trainer_cls(
        env_name, config,
        tracker=tracker if args.logging else None,
        checkpointer=checkpointer,
        seed=seed, device=args.device, preemption=preemption, render=args.render,
        **observability(args, config),
    )
    if args.run is not None and trainer.checkpointer.latest_epoch() is not None:
        start = trainer.restore()
        logger.info("resumed run %s at epoch %d", tracker.run_id, start)
    return trainer, tracker


def report(epoch: int, metrics: dict) -> None:
    """One JSON line per epoch; a population's member curves
    (``reward_m{i}``, and the fused one's ``loss_q_m{i}``, ...) are keys
    of it."""
    print(json.dumps({"epoch": epoch, **metrics}), flush=True)


def train_on_device_cli(args: argparse.Namespace, setup) -> dict:
    """The ``--on-device true`` path: the fused loop on the run's twin,
    or with ``--population`` > 1 the fused population (``setup`` is
    :func:`run_setup`'s result); prints one JSON line per epoch and the
    final line."""
    from torch_actor_critic_tpu_torch.sac.ondevice import (
        train_on_device,
        train_population_on_device,
    )

    config, env_name, seed, tracker, checkpointer = setup
    logger.info("on-device training: %s (run %s, population %d)", env_name, tracker.run_id,
                config.population)
    kwargs = observability(args, config)
    train_fn = train_population_on_device if config.population > 1 else train_on_device
    metrics = profiled(args, lambda: train_fn(
        env_name, config, tracker=tracker if args.logging else None,
        checkpointer=checkpointer, seed=seed, device=args.device, on_epoch=report, **kwargs,
    ))
    print(json.dumps({
        "run": tracker.run_id, "checkpoint_dir": str(checkpointer.directory),
        "final": metrics, "eval": None,
    }), flush=True)
    return metrics


def train_offline_cli(args: argparse.Namespace, setup) -> dict:
    """The ``--offline true`` path: regularized SAC from the disk tier at
    ``--offline-dataset`` (``setup`` is :func:`run_setup`'s result), with
    a telemetry recorder under ``--telemetry true``; prints one JSON line
    per burst and the final line."""
    from torch_actor_critic_tpu_torch.replay.offline import train_offline
    from torch_actor_critic_tpu_torch.telemetry.recorder import TelemetryRecorder

    config, _, seed, tracker, checkpointer = setup
    logger.info("offline training from %s (reg=%s x %g, %d steps, run %s)",
                config.offline_dataset or "<unset>", config.offline_reg,
                config.offline_reg_weight, config.offline_steps, tracker.run_id)
    telemetry = TelemetryRecorder.for_run(
        config, tracker if args.logging else None, device=args.device)
    try:
        metrics = profiled(args, lambda: train_offline(
            config, tracker=tracker if args.logging else None, checkpointer=checkpointer,
            seed=seed, telemetry=telemetry, device=args.device, on_epoch=report))
    finally:
        if telemetry is not None:
            telemetry.close()
    print(json.dumps({
        "run": tracker.run_id, "checkpoint_dir": str(checkpointer.directory),
        "final": metrics, "eval": None,
    }), flush=True)
    return metrics


def main(argv=None) -> dict:
    from torch_actor_critic_tpu_torch.resilience.preemption import (
        Preempted,
        PreemptionGuard,
    )

    logging.basicConfig(level=logging.INFO)
    args = parse_arguments(argv)
    raise_trace_buffer(args)
    # --offline / --on-device, or the stored config of the --run it resumes
    setup = run_setup(args)
    if setup[0].offline:
        return train_offline_cli(args, setup)
    if setup[0].on_device:
        return train_on_device_cli(args, setup)
    guard = PreemptionGuard().install() if args.preemption_guard else None
    try:
        trainer, tracker = build_trainer(args, preemption=guard, setup=setup)
        logger.info(
            "training %s on %s (run %s)", trainer.env_name, trainer.device, tracker.run_id
        )
        try:
            metrics = profiled(args, lambda: trainer.train(on_epoch=report, render=args.render))
            evaluation = (
                trainer.evaluate(args.eval_episodes, deterministic=True,
                                 seed=trainer.seed + 12345)
                if args.eval_episodes > 0 else None
            )
        except Preempted as p:
            logger.warning(
                "%s — resume with: python -m torch_actor_critic_tpu_torch.train "
                "--run %s --runs-root %s", p, tracker.run_id, args.runs_root,
            )
            raise SystemExit(p.exit_code)
        finally:
            trainer.close()
    finally:
        if guard is not None:
            guard.uninstall()
    print(json.dumps({
        "run": tracker.run_id,
        "checkpoint_dir": str(trainer.checkpointer.directory),
        "final": metrics,
        "eval": evaluation,
    }), flush=True)
    return metrics


if __name__ == "__main__":
    main()
