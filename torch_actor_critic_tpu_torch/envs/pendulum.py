"""Pendulum swing-up as a host numpy env, for machines without gymnasium.

The dynamics, reward, reset distribution and 200-step truncation of the
JAX package's ``envs/ondevice.py::PendulumJax`` (its twin of
gymnasium's ``Pendulum-v1``), in float32 numpy behind the host env
protocol of :mod:`.wrappers`. It answers only to its own name,
``PendulumNumpy-v1``: ``make_env("Pendulum-v1")`` is gymnasium's.
"""

from __future__ import annotations

import numpy as np

from torch_actor_critic_tpu_torch.envs.wrappers import ObsSpec

_F = np.float32


class PendulumNumpy:
    """theta'' = 3g/(2l) sin(theta) + 3/(m l^2) u, dt 0.05, torque and
    speed clipped, reward -(angle^2 + 0.1 theta_dot^2 + 0.001 u^2);
    episodes only truncate."""

    name = "PendulumNumpy-v1"
    obs_spec = ObsSpec((3,), np.float32)
    act_dim = 1
    act_limit = 2.0
    max_episode_steps = 200

    max_speed = _F(8.0)
    dt = _F(0.05)
    _gravity_term = _F(3.0 * 10.0 / (2.0 * 1.0))  # 3 g / (2 l)
    _torque_term = _F(3.0 / (1.0 * 1.0**2))  # 3 / (m l^2)
    _pi = _F(np.pi)
    _two_pi = _F(2 * np.pi)

    def __init__(self, seed: int | None = None):
        self._rng = np.random.default_rng(seed)
        self._action_rng = np.random.default_rng(seed)
        self.theta = _F(0.0)
        self.theta_dot = _F(0.0)
        self.steps = 0

    def _obs(self) -> np.ndarray:
        return np.array(
            [np.cos(self.theta), np.sin(self.theta), self.theta_dot], np.float32
        )

    def reset(self, seed: int | None = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.theta = _F(self._rng.uniform(-np.pi, np.pi))
        self.theta_dot = _F(self._rng.uniform(-1.0, 1.0))
        self.steps = 0
        return self._obs()

    def set_state(self, theta: float, theta_dot: float) -> np.ndarray:
        """Place the pendulum (tests start both twins from one state)."""
        self.theta, self.theta_dot, self.steps = _F(theta), _F(theta_dot), 0
        return self._obs()

    def step(self, action: np.ndarray):
        th, thdot = self.theta, self.theta_dot
        u = np.clip(np.asarray(action, np.float32).reshape(-1)[0],
                    _F(-self.act_limit), _F(self.act_limit))
        angle = ((th + self._pi) % self._two_pi) - self._pi
        reward = -(angle**2 + _F(0.1) * thdot**2 + _F(0.001) * u**2)
        thdot = thdot + self.dt * (self._gravity_term * np.sin(th) + self._torque_term * u)
        thdot = np.clip(thdot, -self.max_speed, self.max_speed)
        self.theta = _F(th + self.dt * thdot)
        self.theta_dot = _F(thdot)
        self.steps += 1
        truncated = self.steps >= self.max_episode_steps
        return self._obs(), float(reward), False, bool(truncated)

    def sample_action(self) -> np.ndarray:
        return self._action_rng.uniform(
            -self.act_limit, self.act_limit, (self.act_dim,)
        ).astype(np.float32)

    def render(self):
        """No-op: the numpy pendulum draws nothing."""

    def close(self):
        pass
