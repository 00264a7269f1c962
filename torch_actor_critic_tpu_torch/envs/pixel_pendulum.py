"""Pendulum from pixels (port of ``envs/pixel_pendulum.py``).

The observation is a :class:`~..core.types.MultiObservation`: a 32×32×3
uint8 frame whose three channels hold an anti-aliased raster of the rod
at t-2, t-1 and t (so angular velocity and its trend are visible in one
frame), and, as ``features``, only the previous action. Angle and
velocity never appear as scalars.

- :func:`render_rod` — the numpy rasteriser, bit-identical to the JAX
  package's (float32 throughout); :func:`render_rod_torch`, the same
  raster for a batch of angles as tensors (the on-device twins'
  renderer, :mod:`.ondevice`).
- :class:`PixelPendulum` — over gymnasium's ``Pendulum-v1``, as in the
  JAX package (``PixelPendulum-v0``; ``balance=True`` is
  ``PixelPendulumBalance-v0``: resets near upright).
- :class:`PixelPendulumNumpy` — the same task over the port's numpy
  physics :class:`~.pendulum.PendulumNumpy` (the JAX package's
  ``PendulumJax`` dynamics), for machines without gymnasium: the host
  form of ``envs/ondevice.PixelPendulumJax``/``PixelPendulumBalanceJax``.
  It answers only to ``PixelPendulumNumpy-v0`` and
  ``PixelPendulumBalanceNumpy-v0``.
"""

from __future__ import annotations

import numpy as np
import torch

from torch_actor_critic_tpu_torch.core.types import MultiObservation
from torch_actor_critic_tpu_torch.envs.pendulum import PendulumNumpy
from torch_actor_critic_tpu_torch.envs.wrappers import ObsSpec

SIZE = 32  # frame is SIZE x SIZE x 3
ROD_HALF_WIDTH = 1.5  # px; rasterised by distance to the segment
ROD_LEN_FRAC = 0.42  # rod length as a fraction of the frame size


def render_rod(theta: float, size: int = SIZE) -> np.ndarray:
    """The rod at angle ``theta`` (from upright, counter-clockwise) as a
    uint8 ``(size, size)`` image: 255 inside, a linear anti-aliased
    falloff over the one-pixel edge band (it carries the sub-pixel pose),
    0 beyond."""
    c = (size - 1) / 2.0
    length = size * ROD_LEN_FRAC
    theta32 = np.float32(theta)
    tip = np.array(
        [c - length * np.cos(theta32), c + length * np.sin(theta32)],
        np.float32,
    )
    pivot = np.array([c, c], np.float32)
    rows, cols = np.mgrid[0:size, 0:size].astype(np.float32)
    p = np.stack([rows, cols], axis=-1)  # (size, size, 2)
    seg = tip - pivot
    seg_len2 = np.float32(seg @ seg)
    t = np.clip(((p - pivot) @ seg) / seg_len2, np.float32(0), np.float32(1))
    closest = pivot + t[..., None] * seg
    dist = np.sqrt(np.sum((p - closest) ** 2, axis=-1))
    shade = np.clip(ROD_HALF_WIDTH + 1.0 - dist, 0.0, 1.0)
    return np.round(shade * 255).astype(np.uint8)


def render_rod_torch(theta: torch.Tensor, size: int = SIZE) -> torch.Tensor:
    """:func:`render_rod` for a batch: ``theta`` ``(n,)`` gives ``(n, size,
    size)`` uint8 frames on its device, computed in float32 as the
    numpy and JAX rasterisers are, then rounded and cast (the port of
    the JAX package's ``render_rod_jax``)."""
    c = (size - 1) / 2.0
    length = size * ROD_LEN_FRAC
    theta = theta.to(torch.float32)
    tip_r = c - length * torch.cos(theta)  # (n,)
    tip_c = c + length * torch.sin(theta)
    seg_r, seg_c = tip_r - c, tip_c - c
    seg_len2 = seg_r * seg_r + seg_c * seg_c
    grid = torch.arange(size, dtype=torch.float32, device=theta.device)
    d_r = (grid - c)[None, :, None]  # pixel minus pivot, rows
    d_c = (grid - c)[None, None, :]
    seg_r, seg_c, seg_len2 = (x[:, None, None] for x in (seg_r, seg_c, seg_len2))
    t_par = torch.clamp((d_r * seg_r + d_c * seg_c) / seg_len2, 0.0, 1.0)
    rows = grid[None, :, None]
    cols = grid[None, None, :]
    dist = torch.sqrt((rows - (c + t_par * seg_r)) ** 2 + (cols - (c + t_par * seg_c)) ** 2)
    shade = torch.clamp(ROD_HALF_WIDTH + 1.0 - dist, 0.0, 1.0)
    return torch.round(shade * 255).to(torch.uint8)


class _PixelObs:
    """The frame stack and last action shared by both pixel pendulums."""

    act_dim = 1
    size = SIZE

    def _spec(self) -> MultiObservation:
        return MultiObservation(
            features=ObsSpec((self.act_dim,), np.float32),
            frame=ObsSpec((self.size, self.size, 3), np.uint8),
        )

    def _reset_rods(self, theta: float) -> MultiObservation:
        rod = render_rod(theta, self.size)
        self._rods = [rod, rod, rod]  # no motion yet
        self._last_action = np.zeros(self.act_dim, np.float32)
        return self._obs()

    def _push_rod(self, theta: float, action) -> None:
        self._rods = [self._rods[1], self._rods[2], render_rod(theta, self.size)]
        self._last_action = np.asarray(action, np.float32).reshape(self.act_dim)

    def _obs(self) -> MultiObservation:
        return MultiObservation(
            features=self._last_action.copy(), frame=np.stack(self._rods, axis=-1)
        )


class PixelPendulum(_PixelObs):
    """gymnasium's Pendulum-v1 seen through :func:`render_rod`.
    ``balance=True`` starts each episode near upright (theta ~
    U(±0.15π), theta_dot ~ U(±0.2), drawn from the env's seeded
    generator)."""

    def __init__(self, seed: int | None = None, balance: bool = False):
        import gymnasium

        self.env = gymnasium.make("Pendulum-v1")
        self.env.action_space.seed(seed)
        self.balance = balance
        self.name = "PixelPendulumBalance-v0" if balance else "PixelPendulum-v0"
        self.act_limit = float(self.env.action_space.high[0])
        self.obs_spec = self._spec()
        self._reset_rods(0.0)

    def _theta(self) -> float:
        return float(self.env.unwrapped.state[0])

    def reset(self, seed: int | None = None) -> MultiObservation:
        self.env.reset(seed=seed)
        if self.balance:
            rng = self.env.unwrapped.np_random
            self.env.unwrapped.state = np.array([
                rng.uniform(-0.15 * np.pi, 0.15 * np.pi),
                rng.uniform(-0.2, 0.2),
            ])
        return self._reset_rods(self._theta())

    def set_state(self, theta: float, theta_dot: float) -> MultiObservation:
        """Place the pendulum at rest in the frame (tests start twins
        from one state)."""
        self.env.unwrapped.state = np.array([theta, theta_dot])
        return self._reset_rods(self._theta())

    def step(self, action: np.ndarray):
        _, reward, terminated, truncated, _ = self.env.step(np.asarray(action, np.float32))
        self._push_rod(self._theta(), action)
        return self._obs(), float(reward), bool(terminated), bool(truncated)

    def sample_action(self) -> np.ndarray:
        return np.asarray(self.env.action_space.sample(), np.float32)

    def close(self):
        self.env.close()


class PixelPendulumNumpy(_PixelObs):
    """The pixel pendulum over :class:`~.pendulum.PendulumNumpy`'s
    float32 physics; resets draw ``(theta, theta_dot)`` from the seeded
    generator, near upright with ``balance=True``. Episodes truncate at
    200 steps."""

    def __init__(self, seed: int | None = None, balance: bool = False):
        self.physics = PendulumNumpy(seed=seed)
        self.balance = balance
        self.name = "PixelPendulumBalanceNumpy-v0" if balance else "PixelPendulumNumpy-v0"
        self.act_limit = self.physics.act_limit
        self.obs_spec = self._spec()
        self._reset_rods(0.0)

    def reset(self, seed: int | None = None) -> MultiObservation:
        ph = self.physics
        if seed is not None:
            ph._rng = np.random.default_rng(seed)
        if self.balance:
            theta = ph._rng.uniform(-0.15 * np.pi, 0.15 * np.pi)
            theta_dot = ph._rng.uniform(-0.2, 0.2)
        else:
            theta = ph._rng.uniform(-np.pi, np.pi)
            theta_dot = ph._rng.uniform(-1.0, 1.0)
        return self.set_state(theta, theta_dot)

    def set_state(self, theta: float, theta_dot: float) -> MultiObservation:
        self.physics.set_state(theta, theta_dot)
        return self._reset_rods(float(self.physics.theta))

    def step(self, action: np.ndarray):
        _, reward, terminated, truncated = self.physics.step(action)
        self._push_rod(float(self.physics.theta), action)
        return self._obs(), reward, terminated, truncated

    def sample_action(self) -> np.ndarray:
        return self.physics.sample_action()

    def close(self):
        pass
