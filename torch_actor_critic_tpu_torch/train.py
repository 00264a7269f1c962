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

Not ported: ``--devices`` > 1, ``--fsdp``, the profile and trace flags,
``--render``.
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
    parser.set_defaults(logging=True, preemption_guard=True, save_buffer=True)
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
    checkpointer = Checkpointer(tracker.artifact_path("checkpoints"),
                                save_buffer=args.save_buffer)
    return config, env_name, seed, tracker, checkpointer


def build_trainer(args: argparse.Namespace, preemption=None, setup=None):
    """Tracker, checkpointer and :class:`Trainer` from parsed CLI args —
    the path :func:`main` trains, shared with smoke scripts. With
    ``--run`` the run's stored params give the config, environment and
    seed, and the trainer is restored from the run's newest checkpoint.
    ``setup`` is :func:`run_setup`'s result, when the caller has it.
    Returns ``(trainer, tracker)``."""
    from torch_actor_critic_tpu_torch.sac.trainer import Trainer

    config, env_name, seed, tracker, checkpointer = setup or run_setup(args)
    trainer = Trainer(
        env_name, config,
        tracker=tracker if args.logging else None,
        checkpointer=checkpointer,
        seed=seed, device=args.device, preemption=preemption,
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
    train_fn = train_population_on_device if config.population > 1 else train_on_device
    metrics = train_fn(
        env_name, config, tracker=tracker if args.logging else None,
        checkpointer=checkpointer, seed=seed, device=args.device, on_epoch=report,
    )
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
    # --on-device, or the stored config of the --run it resumes
    setup = run_setup(args)
    if setup[0].on_device:
        return train_on_device_cli(args, setup)
    guard = PreemptionGuard().install() if args.preemption_guard else None
    try:
        trainer, tracker = build_trainer(args, preemption=guard, setup=setup)
        logger.info(
            "training %s on %s (run %s)", trainer.env_name, trainer.device, tracker.run_id
        )
        try:
            metrics = trainer.train(on_epoch=report)
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
