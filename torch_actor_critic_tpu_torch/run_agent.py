"""Evaluation CLI of the port (port of ``run_agent.py``)::

    python -m torch_actor_critic_tpu_torch.run_agent --run <id> \\
        [--episodes N] [--seed S] [--headless] [--random] [--device cpu|cuda]

Loads the run's stored params (environment, config, seed), builds the
run's learner from its config (SAC or TD3: a TD3 run gets the
deterministic actor), restores it from its newest checkpoint (not the
replay ring), rolls out ``--episodes`` episodes with the deterministic
policy (``--random``: sampled actions, TD3's with its exploration
noise) and prints their mean return, spread and length as one
JSON line. ``--seed S`` resets episode ``i`` with ``S + i`` and seeds
the acting generator, so two invocations print the same line.
Rendering is on by default and ``--headless`` turns it off, as in the JAX
CLI: the trainer decides once whether the env can render (dm_control and
the port's own envs through their no-op paths, a gymnasium env with
``render_mode="human"`` only where a display is there, else a warning
and a headless rollout), and each evaluated step renders. Runs on the
card unless ``--device cpu`` is given; without a card and without that
flag it exits non-zero.

A fused population run (``--on-device true --population`` > 1, SAC or
TD3, flat, history or pixel) is evaluated one member at a time:
``--member i`` (default: the best by the checkpoint's PBT return EMA,
member 0 without one) is exported beside the run
(:func:`~.utils.checkpoint.export_member_checkpoint`, under
``artifacts/member_<i>``, which the serving CLI serves too) and
evaluated from there; the JSON line names it as ``member``. A host-loop
population run (``--population`` > 1 without ``--on-device``) is
evaluated as the JAX CLI evaluates it: every member on its own env, the
JSON line with ``per_member`` returns (its checkpoint is no population
export's source, as JAX's is not).
"""

from __future__ import annotations

import argparse
import json
import logging

from torch_actor_critic_tpu_torch.utils.config import SACConfig

logger = logging.getLogger(__name__)


def parse_arguments(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser("Actor-critic (SAC or TD3) evaluation of the PyTorch port.")
    parser.add_argument("--run", type=str, required=True, help="Run id to evaluate")
    parser.add_argument("--experiment", default="Default", help="Experiment name")
    parser.add_argument("--runs-root", default="runs")
    parser.add_argument("--episodes", type=int, default=100, help="Number of test episodes")
    parser.add_argument(
        "--headless", action="store_false", dest="render", help="Disable rendering"
    )
    parser.add_argument(
        "--random", action="store_false", dest="deterministic", help="Stochastic policy"
    )
    parser.add_argument(
        "--seed", type=int, default=None,
        help="Seed episode resets (episode i uses seed+i) and the acting generator",
    )
    parser.add_argument(
        "--device", default=None, help="cuda (default; fails without a card) or cpu"
    )
    parser.add_argument(
        "--member", type=int, default=None,
        help="A population run's member to evaluate (default: the best by its return EMA)",
    )
    parser.set_defaults(render=True, deterministic=True)
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    from torch_actor_critic_tpu_torch.sac.trainer import Trainer
    from torch_actor_critic_tpu_torch.utils.checkpoint import (
        Checkpointer,
        export_member_checkpoint,
    )
    from torch_actor_critic_tpu_torch.utils.tracking import Tracker

    logging.basicConfig(level=logging.INFO)
    args = parse_arguments(argv)
    tracker = Tracker.load(args.run, experiment=args.experiment, root=args.runs_root)
    params = tracker.params()
    env_name = params.get("environment", "Humanoid-v5")  # the JAX CLI's fallback
    config = SACConfig.from_json(json.dumps(params.get("config", {})))
    ckpt_dir, member = tracker.artifact_path("checkpoints"), None
    if config.population > 1 and config.on_device:
        probe = Checkpointer(ckpt_dir).peek_meta()
        ema = (probe.get("pbt") or {}).get("return_ema")
        member = args.member if args.member is not None else (
            max(range(len(ema)), key=ema.__getitem__) if ema else 0)
        export = tracker.artifact_path(f"member_{member}")
        export_member_checkpoint(ckpt_dir, export, member=member)
        ckpt_dir, config = export, config.replace(population=1, pbt_every=0)
    trainer = Trainer(
        env_name, config, checkpointer=Checkpointer(ckpt_dir),
        seed=params.get("seed", 0), device=args.device, render=args.render,
    )
    try:
        trainer.restore(include_buffer=False)
        logger.info("evaluating run %s on %s (%s)", args.run, env_name, trainer.device)
        metrics = trainer.evaluate(
            episodes=args.episodes, deterministic=args.deterministic, seed=args.seed,
            render=args.render,
        )
    finally:
        trainer.close()
    if member is not None:
        metrics["member"] = member
    print(json.dumps(metrics), flush=True)
    return metrics


if __name__ == "__main__":
    main()
