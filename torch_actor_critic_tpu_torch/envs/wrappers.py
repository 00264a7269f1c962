"""Host-side environment adapters (port of ``envs/wrappers.py``).

Every env family is normalised to the protocol the trainer consumes:

- ``reset(seed) -> obs``
- ``step(action) -> (obs, reward, terminated, truncated)``
- ``obs_spec`` (:class:`ObsSpec`), ``act_dim``, ``act_limit``
- ``sample_action()``, a uniform random action

``make_env`` builds gymnasium envs by name (gymnasium is imported only
then, and a missing gymnasium raises: no env is substituted), the
port's numpy pendulum :class:`~.pendulum.PendulumNumpy` under its own
name, the pixel pendulums of :mod:`.pixel_pendulum` (observations are
:class:`~..core.types.MultiObservation` values, ``obs_spec`` one of
:class:`ObsSpec` leaves), and ``"<name>|history:N"`` wraps a flat env in
:class:`HistoryEnv`. dm_control and the wall-runner are not ported.
"""

from __future__ import annotations

import typing as t

import numpy as np


class ObsSpec(t.NamedTuple):
    """One observation's shape and dtype (the JAX package's
    ``jax.ShapeDtypeStruct``)."""

    shape: t.Tuple[int, ...]
    dtype: t.Any = np.float32


class GymnasiumEnv:
    """Adapter over ``gymnasium.make``."""

    def __init__(self, name: str, seed: int | None = None):
        import gymnasium

        self.name = name
        self.env = gymnasium.make(name)
        # Seed the warmup action sampler so fixed-seed runs reproduce.
        self.env.action_space.seed(seed)
        space = self.env.action_space
        self.act_dim = int(space.shape[0])
        self.act_limit = float(space.high[0])
        obs_dim = int(self.env.observation_space.shape[0])
        self.obs_spec = ObsSpec((obs_dim,), np.float32)

    def reset(self, seed: int | None = None) -> np.ndarray:
        obs, _ = self.env.reset(seed=seed)
        return np.asarray(obs, np.float32)

    def step(self, action: np.ndarray):
        obs, reward, terminated, truncated, _ = self.env.step(np.asarray(action))
        return np.asarray(obs, np.float32), float(reward), bool(terminated), bool(truncated)

    def sample_action(self) -> np.ndarray:
        return np.asarray(self.env.action_space.sample(), np.float32)

    def close(self):
        self.env.close()


class HistoryEnv:
    """Sliding-window observation history: base obs ``(D,)`` becomes
    ``(horizon, D)`` with the newest frame last; reset fills the window
    with the initial observation."""

    def __init__(self, env, horizon: int):
        if not isinstance(env.obs_spec, ObsSpec) or len(env.obs_spec.shape) != 1:
            raise ValueError(
                "HistoryEnv requires a flat array observation; got "
                f"{env.obs_spec}"
            )
        self.env = env
        self.horizon = int(horizon)
        self.name = f"{env.name}|history:{horizon}"
        self.act_dim = env.act_dim
        self.act_limit = env.act_limit
        base = env.obs_spec
        self.obs_spec = ObsSpec((self.horizon,) + tuple(base.shape), base.dtype)
        self._hist: np.ndarray | None = None

    def reset(self, seed: int | None = None) -> np.ndarray:
        obs = self.env.reset(seed)
        self._hist = np.tile(obs[None], (self.horizon,) + (1,) * obs.ndim)
        return self._hist.copy()

    def step(self, action: np.ndarray):
        obs, reward, terminated, truncated = self.env.step(action)
        self._hist = np.roll(self._hist, -1, axis=0)
        self._hist[-1] = obs
        return self._hist.copy(), reward, terminated, truncated

    def sample_action(self) -> np.ndarray:
        return self.env.sample_action()

    def close(self):
        self.env.close()


_NOT_PORTED = ("DeepMindWallRunner-v0",)

# name -> (gymnasium physics?, balance start?)
_PIXEL_ENVS = {
    "PixelPendulum-v0": (True, False),
    "PixelPendulumBalance-v0": (True, True),
    "PixelPendulumNumpy-v0": (False, False),
    "PixelPendulumBalanceNumpy-v0": (False, True),
}


def is_visual_env(name: str) -> bool:
    """Mixed-observation envs, which need the visual model and buffer."""
    return name in _PIXEL_ENVS or name in _NOT_PORTED


def make_env(name: str, seed: int | None = None):
    """Single env factory. ``"<base>|history:N"`` wraps the base env in
    :class:`HistoryEnv`."""
    if "|history:" in name:
        base_name, _, horizon = name.rpartition("|history:")
        return HistoryEnv(make_env(base_name, seed=seed), int(horizon))
    if name == "PendulumNumpy-v1":
        from torch_actor_critic_tpu_torch.envs.pendulum import PendulumNumpy

        return PendulumNumpy(seed=seed)
    if name in _PIXEL_ENVS:
        from torch_actor_critic_tpu_torch.envs import pixel_pendulum

        gym_physics, balance = _PIXEL_ENVS[name]
        cls = pixel_pendulum.PixelPendulum if gym_physics else pixel_pendulum.PixelPendulumNumpy
        return cls(seed=seed, balance=balance)
    if name.startswith("dm:") or name in _NOT_PORTED:
        raise NotImplementedError(
            f"env {name!r} (dm_control / the wall-runner) is not ported yet"
        )
    return GymnasiumEnv(name, seed=seed)
