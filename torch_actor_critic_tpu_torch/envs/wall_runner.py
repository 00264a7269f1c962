"""dm_control CMU-humanoid wall-runner with egocentric vision (port of
``envs/wall_runner.py``).

Wraps ``basic_cmu_2019.cmu_humanoid_run_walls()``: the 12 named walker
sensor groups (:data:`SENSOR_KEYS`, in the reference's order) are joined
into a 168-dim float32 feature vector and paired with the 64x64
egocentric camera frame, kept HWC uint8 (the camera's own format and the
replay ring's), as a :class:`~..core.types.MultiObservation`. Actions
are 56-dim in [-1, 1]. The camera needs a GL context: on a host without
a display ``MUJOCO_GL`` defaults to ``egl``
(:func:`~.wrappers.ensure_headless_gl`).
"""

from __future__ import annotations

import typing as t

import numpy as np

from torch_actor_critic_tpu_torch.core.types import MultiObservation
from torch_actor_critic_tpu_torch.envs.wrappers import (
    ObsSpec,
    dm_step_flags,
    ensure_headless_gl,
    reseed_dm_env,
)

# The 12 sensor groups, in the reference's order.
SENSOR_KEYS = (
    "walker/appendages_pos",
    "walker/body_height",
    "walker/end_effectors_pos",
    "walker/joints_pos",
    "walker/joints_vel",
    "walker/sensors_accelerometer",
    "walker/sensors_force",
    "walker/sensors_gyro",
    "walker/sensors_torque",
    "walker/sensors_touch",
    "walker/sensors_velocimeter",
    "walker/world_zaxis",
)

FEATURE_DIM = 168
FRAME_SHAPE = (64, 64, 3)  # HWC uint8
ACT_DIM = 56


class DeepMindWallRunner:
    """Humanoid wall-running with proprioceptive features and pixels."""

    name = "DeepMindWallRunner-v0"

    def __init__(self, seed: int | None = None):
        ensure_headless_gl()
        from dm_control.locomotion.examples import basic_cmu_2019

        self.env = basic_cmu_2019.cmu_humanoid_run_walls(random_state=seed)
        self.act_dim = ACT_DIM
        self.act_limit = 1.0
        self._rng = np.random.default_rng(seed)
        self.obs_spec = MultiObservation(
            features=ObsSpec((FEATURE_DIM,), np.float32),
            frame=ObsSpec(FRAME_SHAPE, np.uint8),
        )

    def _process(self, obs: t.Mapping[str, np.ndarray]) -> MultiObservation:
        """The sensor groups joined (``body_height`` is a scalar, raised
        to one element) and the camera frame as it comes."""
        features = np.concatenate(
            [np.atleast_1d(np.asarray(obs[k], np.float32)).ravel() for k in SENSOR_KEYS]
        )
        frame = np.asarray(obs["walker/egocentric_camera"], np.uint8)
        return MultiObservation(features=features, frame=frame)

    def reset(self, seed: int | None = None) -> MultiObservation:
        if seed is not None:
            reseed_dm_env(self.env, seed)
            self._rng = np.random.default_rng(seed)
        return self._process(self.env.reset().observation)

    def step(self, action: np.ndarray):
        ts = self.env.step(np.asarray(action))
        terminated, truncated = dm_step_flags(ts)
        return self._process(ts.observation), float(ts.reward or 0.0), terminated, truncated

    def sample_action(self) -> np.ndarray:
        return self._rng.uniform(-1.0, 1.0, ACT_DIM).astype(np.float32)

    def render(self):
        """No-op, as the reference's."""

    def close(self):
        pass
