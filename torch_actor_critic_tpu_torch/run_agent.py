"""Evaluation CLI of the port (port of ``run_agent.py``)::

    python -m torch_actor_critic_tpu_torch.run_agent --run <id> \\
        [--episodes N] [--seed S] [--random] [--device cpu|cuda]

Loads the run's stored params (environment, config, seed), builds the
run's learner from its config (SAC or TD3: a TD3 run gets the
deterministic actor), restores it from its newest checkpoint (not the
replay ring), rolls out ``--episodes`` episodes with the deterministic
policy (``--random``: sampled actions, TD3's with its exploration
noise) and prints their mean return, spread and length as one
JSON line. ``--seed S`` resets episode ``i`` with ``S + i`` and seeds
the acting generator, so two invocations print the same line.
``--headless`` is accepted and has no effect (the port does not
render). Runs on the card unless ``--device cpu`` is given; without a
card and without that flag it exits non-zero.
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
    parser.add_argument("--headless", action="store_true", help="Accepted; nothing renders")
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
    parser.set_defaults(deterministic=True)
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    from torch_actor_critic_tpu_torch.sac.trainer import Trainer
    from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer
    from torch_actor_critic_tpu_torch.utils.tracking import Tracker

    logging.basicConfig(level=logging.INFO)
    args = parse_arguments(argv)
    tracker = Tracker.load(args.run, experiment=args.experiment, root=args.runs_root)
    params = tracker.params()
    env_name = params.get("environment", "Humanoid-v5")  # the JAX CLI's fallback
    config = SACConfig.from_json(json.dumps(params.get("config", {})))
    trainer = Trainer(
        env_name, config, checkpointer=Checkpointer(tracker.artifact_path("checkpoints")),
        seed=params.get("seed", 0), device=args.device,
    )
    try:
        trainer.restore(include_buffer=False)
        logger.info("evaluating run %s on %s (%s)", args.run, env_name, trainer.device)
        metrics = trainer.evaluate(
            episodes=args.episodes, deterministic=args.deterministic, seed=args.seed
        )
    finally:
        trainer.close()
    print(json.dumps(metrics), flush=True)
    return metrics


if __name__ == "__main__":
    main()
