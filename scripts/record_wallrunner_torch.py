"""Record real ``DeepMindWallRunner-v0`` transitions into a fixture.

The card's machine has no dm_control, so the wall-runner reaches it only
through transitions recorded here, on a host that has dm_control and a
GL stack (EGL headless):

    MUJOCO_GL=egl python scripts/record_wallrunner_torch.py \\
        --steps 256 --seed 0 --out tests/data/wallrunner_s0.npz

The env is the port's (:class:`torch_actor_critic_tpu_torch.envs.
wall_runner.DeepMindWallRunner`), reset once with ``--seed`` and acted
on with its own ``sample_action`` (a generator seeded with the env).
The file holds ``steps + 1`` observation rows and ``steps`` action
slots: slot ``i`` acts on row ``i`` and row ``i + 1`` is what it
observed. When an episode ends at slot ``i`` (row ``i + 1`` its last
observation), slot ``i + 1`` is the reset: row ``i + 2`` is the new
episode's first observation (``episode_starts[i + 2]``), and the slot's
action, reward and flags are zeros. A slot ``i`` is a transition iff
``not episode_starts[i + 1]`` (:func:`transitions`). Keys:

- ``features`` float32 ``(steps + 1, 168)``, ``frames`` uint8
  ``(steps + 1, 64, 64, 3)``, ``episode_starts`` bool ``(steps + 1,)``;
- ``actions`` float32 ``(steps, 56)``, ``rewards`` float32
  ``(steps,)``, ``terminated`` and ``truncated`` bool ``(steps,)``.

It imports numpy, dm_control and the port, nothing else of the repo.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def record(steps: int, seed: int = 0) -> dict:
    """``steps`` action slots of the wall-runner from ``reset(seed)``, as
    the module docstring lays them out."""
    from torch_actor_critic_tpu_torch.envs.wall_runner import ACT_DIM, DeepMindWallRunner

    env = DeepMindWallRunner(seed=seed)
    obs = env.reset(seed=seed)
    features, frames, starts = [obs.features], [obs.frame], [True]
    actions = np.zeros((steps, ACT_DIM), np.float32)
    rewards = np.zeros(steps, np.float32)
    terminated = np.zeros(steps, bool)
    truncated = np.zeros(steps, bool)
    ended = False
    for i in range(steps):
        if ended:
            obs, ended = env.reset(), False
            starts.append(True)
        else:
            actions[i] = env.sample_action()
            obs, r, term, trunc = env.step(actions[i])
            rewards[i], terminated[i], truncated[i] = r, term, trunc
            ended = term or trunc
            starts.append(False)
        features.append(obs.features)
        frames.append(obs.frame)
    env.close()
    return {
        "features": np.stack(features).astype(np.float32),
        "frames": np.stack(frames).astype(np.uint8),
        "episode_starts": np.asarray(starts, bool),
        "actions": actions,
        "rewards": rewards,
        "terminated": terminated,
        "truncated": truncated,
    }


def transitions(data) -> dict:
    """The fixture's transitions: ``features``, ``frames``,
    ``next_features``, ``next_frames``, ``actions``, ``rewards``,
    ``terminated``, ``truncated``, one row per slot that is not a
    reset."""
    keep = ~np.asarray(data["episode_starts"][1:], bool)
    return {
        "features": data["features"][:-1][keep],
        "frames": data["frames"][:-1][keep],
        "next_features": data["features"][1:][keep],
        "next_frames": data["frames"][1:][keep],
        "actions": data["actions"][keep],
        "rewards": data["rewards"][keep],
        "terminated": data["terminated"][keep],
        "truncated": data["truncated"][keep],
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=256)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="tests/data/wallrunner_s0.npz")
    args = parser.parse_args(argv)
    data = record(args.steps, args.seed)
    np.savez_compressed(args.out, **data)
    n = int((~data["episode_starts"][1:]).sum())
    print(f"{args.out}: {n} transitions, {int(data['episode_starts'].sum())} episodes, "
          f"{os.path.getsize(args.out)} bytes")


if __name__ == "__main__":
    main()
