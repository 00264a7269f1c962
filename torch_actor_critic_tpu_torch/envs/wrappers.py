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
:class:`ObsSpec` leaves), dm_control suite tasks as ``"dm:<domain>:<task>"``
(:class:`DmControlEnv`), the CMU-humanoid wall-runner as
``"DeepMindWallRunner-v0"`` (:mod:`.wall_runner`), and
``"<name>|history:N"`` wraps a flat env in :class:`HistoryEnv`.

dm_control pins its OpenGL platform when it is first imported, so
:func:`ensure_headless_gl` runs before every dm_control import: on a host
without a display it defaults ``MUJOCO_GL`` to ``egl``, and env worker
processes inherit the variable.
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

    def __init__(self, name: str, seed: int | None = None, **kwargs):
        import gymnasium

        self.name = name
        # kwargs reach gymnasium.make: the trainer passes render_mode="human"
        # when it may render (gymnasium draws only in a mode set at
        # construction).
        self.env = gymnasium.make(name, **kwargs)
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

    def render(self):
        return self.env.render()

    def close(self):
        self.env.close()


def ensure_headless_gl() -> None:
    """Default ``MUJOCO_GL=egl`` on a host without a display, before the
    first dm_control import in the process.

    dm_control pins its OpenGL platform at import time: a dm env built
    first without this latches the backend to glfw, and a later camera
    env (the wall-runner's egocentric view) then fails to render. A value
    already set (``disabled`` for physics-only runs, ``osmesa``) is kept.
    """
    import os

    if "MUJOCO_GL" not in os.environ and "DISPLAY" not in os.environ:
        os.environ["MUJOCO_GL"] = "egl"


def reseed_dm_env(env, seed: int | None) -> None:
    """Reseed a dm_control environment in place, suite or composer.

    dm_control has no ``reset(seed)``: a suite env draws from its task's
    ``RandomState``, a composer env from its own; replacing it reseeds.
    ``seed=None`` leaves the env as it is.
    """
    if seed is None:
        return
    rs = np.random.RandomState(seed)
    task = getattr(env, "task", None)
    if task is not None and hasattr(task, "_random"):
        task._random = rs  # suite control.Environment
    elif hasattr(env, "_random_state"):
        env._random_state = rs  # composer.Environment


def dm_step_flags(ts) -> t.Tuple[bool, bool]:
    """``(terminated, truncated)`` of a dm_control time step: the last
    step is terminal only at discount 0; a last step at discount 1 is the
    time limit's truncation, which keeps the bootstrap."""
    terminated = bool(ts.last() and ts.discount == 0.0)
    return terminated, bool(ts.last() and not terminated)


class DmControlEnv:
    """A dm_control suite task, its observation dict flattened in key
    order into one float32 vector. ``sample_action`` draws uniformly in
    the action spec's bounds from a generator seeded with the env (and
    reseeded by a seeded ``reset``)."""

    def __init__(self, domain: str, task: str, seed: int | None = None):
        ensure_headless_gl()
        from dm_control import suite

        self.name = f"dm:{domain}:{task}"
        self.env = suite.load(domain, task, task_kwargs={"random": seed})
        spec = self.env.action_spec()
        self.act_dim = int(np.prod(spec.shape))
        self.act_limit = float(spec.maximum[0])
        self._action_spec = spec
        self._rng = np.random.default_rng(seed)
        obs_dim = sum(int(np.prod(v.shape)) if v.shape else 1
                      for v in self.env.observation_spec().values())
        self.obs_spec = ObsSpec((obs_dim,), np.float32)

    @staticmethod
    def _flatten(obs_dict) -> np.ndarray:
        return np.concatenate([np.ravel(np.asarray(v, np.float32)) for v in obs_dict.values()])

    def reset(self, seed: int | None = None) -> np.ndarray:
        if seed is not None:
            reseed_dm_env(self.env, seed)
            self._rng = np.random.default_rng(seed)
        return self._flatten(self.env.reset().observation)

    def step(self, action: np.ndarray):
        ts = self.env.step(np.asarray(action))
        terminated, truncated = dm_step_flags(ts)
        return self._flatten(ts.observation), float(ts.reward or 0.0), terminated, truncated

    def sample_action(self) -> np.ndarray:
        spec = self._action_spec
        return self._rng.uniform(spec.minimum, spec.maximum).astype(np.float32)

    def render(self):
        """No-op: dm_control draws only into camera observations."""

    def close(self):
        pass


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

    def render(self):
        return self.env.render()

    def close(self):
        self.env.close()


WALL_RUNNER = "DeepMindWallRunner-v0"

# name -> (gymnasium physics?, balance start?)
_PIXEL_ENVS = {
    "PixelPendulum-v0": (True, False),
    "PixelPendulumBalance-v0": (True, True),
    "PixelPendulumNumpy-v0": (False, False),
    "PixelPendulumBalanceNumpy-v0": (False, True),
}


def is_visual_env(name: str) -> bool:
    """Mixed-observation envs, which need the visual model and buffer."""
    return name in _PIXEL_ENVS or name == WALL_RUNNER


def is_dm_env(name: str) -> bool:
    """Envs on dm_control physics, which pay rewards in [0, 1] a step and
    render through their own no-op paths."""
    return name.startswith("dm:") or name == WALL_RUNNER


def renders_itself(name: str) -> bool:
    """Envs whose ``render()`` is their own no-op path, which renders
    without a display: dm_control's, the pixel pendulums and the numpy
    pendulum. Any other name is a gymnasium env, which draws only when
    built with a ``render_mode``."""
    base = name.partition("|history:")[0]
    return is_dm_env(base) or is_visual_env(base) or base == "PendulumNumpy-v1"


def make_env(name: str, seed: int | None = None, **kwargs):
    """Single env factory. ``"<base>|history:N"`` wraps the base env in
    :class:`HistoryEnv`. ``kwargs`` reach the gymnasium envs'
    ``gymnasium.make`` (``render_mode``); the port's own envs take
    none."""
    if "|history:" in name:
        base_name, _, horizon = name.rpartition("|history:")
        return HistoryEnv(make_env(base_name, seed=seed, **kwargs), int(horizon))
    if name == "PendulumNumpy-v1":
        from torch_actor_critic_tpu_torch.envs.pendulum import PendulumNumpy

        return PendulumNumpy(seed=seed)
    if name in _PIXEL_ENVS:
        from torch_actor_critic_tpu_torch.envs import pixel_pendulum

        gym_physics, balance = _PIXEL_ENVS[name]
        cls = pixel_pendulum.PixelPendulum if gym_physics else pixel_pendulum.PixelPendulumNumpy
        return cls(seed=seed, balance=balance)
    if name == WALL_RUNNER:
        from torch_actor_critic_tpu_torch.envs.wall_runner import DeepMindWallRunner

        return DeepMindWallRunner(seed=seed)
    if name.startswith("dm:"):
        _, domain, task = name.split(":")
        return DmControlEnv(domain, task, seed=seed)
    return GymnasiumEnv(name, seed=seed, **kwargs)
