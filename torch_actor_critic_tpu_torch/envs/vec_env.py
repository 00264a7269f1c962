"""Lockstep host env pools (port of ``envs/vec_env.py``:
``SequentialEnvPool`` and ``make_env_pool``).

Protocol: ``obs_spec`` / ``act_dim`` / ``act_limit`` / ``n``;
``reset_all(seeds)``, ``reset_at(i, seed)``, ``step(actions)``,
``step_at(i, action)``, ``sample_actions()``, ``close()``. The parallel pool over the native shared-memory runtime
is not ported: ``parallel=True`` raises (the JAX package falls back to
the sequential pool with a warning; the port does not substitute).
"""

from __future__ import annotations

import typing as t

import numpy as np

from torch_actor_critic_tpu_torch.core.types import MultiObservation
from torch_actor_critic_tpu_torch.envs.wrappers import make_env


def stack_obs(obs: t.Sequence) -> t.Any:
    """Stack observations on a new leading axis, leaf by leaf for
    :class:`MultiObservation` observations (each leaf keeps its dtype)."""
    if isinstance(obs[0], MultiObservation):
        return MultiObservation(
            np.stack([o.features for o in obs]), np.stack([o.frame for o in obs])
        )
    return np.stack(obs)


class SequentialEnvPool:
    """In-process lockstep batch of ``n`` envs; env ``i`` is seeded
    ``base_seed + 10000 * i``."""

    def __init__(self, env_name: str, n: int, base_seed: int = 0):
        self.n = n
        self.envs = [make_env(env_name, seed=base_seed + 10000 * i) for i in range(n)]
        e0 = self.envs[0]
        self.obs_spec, self.act_dim, self.act_limit = e0.obs_spec, e0.act_dim, e0.act_limit

    def reset_all(self, seeds: t.Sequence[int | None] | None = None) -> np.ndarray:
        seeds = seeds or [None] * self.n
        return stack_obs([e.reset(seed=s) for e, s in zip(self.envs, seeds)])

    def reset_at(self, i: int, seed: int | None = None) -> np.ndarray:
        return self.envs[i].reset(seed=seed)

    def step(self, actions: np.ndarray):
        out = [e.step(a) for e, a in zip(self.envs, actions)]
        obs = stack_obs([o[0] for o in out])
        r = np.asarray([o[1] for o in out], np.float32)
        term = np.asarray([o[2] for o in out], bool)
        trunc = np.asarray([o[3] for o in out], bool)
        return obs, r, term, trunc

    def step_at(self, i: int, action: np.ndarray):
        return self.envs[i].step(action)

    def sample_actions(self) -> np.ndarray:
        return np.stack([e.sample_action() for e in self.envs])

    def close(self):
        for e in self.envs:
            e.close()


def make_env_pool(
    env_name: str,
    n: int,
    base_seed: int = 0,
    parallel: bool = False,
) -> SequentialEnvPool:
    """Pool factory: the sequential pool; ``parallel=True`` raises until
    the native runtime is ported."""
    if parallel:
        raise NotImplementedError(
            "parallel env pools (the native shared-memory runtime) are not "
            "ported yet; run with parallel_envs=False"
        )
    return SequentialEnvPool(env_name, n, base_seed=base_seed)
