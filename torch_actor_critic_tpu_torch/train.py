"""Training CLI of the port (port of ``train.py``)::

    python -m torch_actor_critic_tpu_torch.train --environment Pendulum-v1 \\
        --history-len 16 [--device cpu|cuda] [--seed N] [--runs-root DIR]

    # the visual (pixel) policy, frames sampled through the kernel K1
    python -m torch_actor_critic_tpu_torch.train \\
        --environment PixelPendulumBalanceNumpy-v0 --filters 16,32 \\
        --kernel-sizes 4,3 --strides 2,2 --cnn-dense-size 128 \\
        --cnn-features 64 --normalize-pixels true --frame-augment shift \\
        --learn-alpha true --pixel-pipeline fused

    # resume a run where its newest checkpoint left it
    python -m torch_actor_critic_tpu_torch.train --run <id> [--runs-root DIR]

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

Not ported: ``--devices``/``--fsdp``, ``--no-save-buffer``, the
profile and trace flags, ``--render``.
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
        "Soft Actor-Critic trainer of the PyTorch port (one CUDA device)."
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
    parser.set_defaults(logging=True, preemption_guard=True)
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


def build_trainer(args: argparse.Namespace, preemption=None):
    """Tracker, checkpointer and :class:`Trainer` from parsed CLI args —
    the path :func:`main` trains, shared with smoke scripts. With
    ``--run`` the run's stored params give the config, environment and
    seed, and the trainer is restored from the run's newest checkpoint.
    Returns ``(trainer, tracker)``."""
    from torch_actor_critic_tpu_torch.sac.trainer import Trainer
    from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer
    from torch_actor_critic_tpu_torch.utils.tracking import Tracker

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
    trainer = Trainer(
        env_name, config,
        tracker=tracker if args.logging else None,
        checkpointer=Checkpointer(tracker.artifact_path("checkpoints")),
        seed=seed, device=args.device, preemption=preemption,
    )
    if args.run is not None and trainer.checkpointer.latest_epoch() is not None:
        start = trainer.restore()
        logger.info("resumed run %s at epoch %d", tracker.run_id, start)
    return trainer, tracker


def main(argv=None) -> dict:
    from torch_actor_critic_tpu_torch.resilience.preemption import (
        Preempted,
        PreemptionGuard,
    )

    logging.basicConfig(level=logging.INFO)
    args = parse_arguments(argv)
    guard = PreemptionGuard().install() if args.preemption_guard else None
    try:
        trainer, tracker = build_trainer(args, preemption=guard)
        logger.info(
            "training %s on %s (run %s)", trainer.env_name, trainer.device, tracker.run_id
        )

        def report(epoch: int, metrics: dict) -> None:
            print(json.dumps({"epoch": epoch, **metrics}), flush=True)

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
