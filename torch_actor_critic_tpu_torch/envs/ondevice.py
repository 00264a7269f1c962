"""On-device environments (port of ``envs/ondevice.py``): batched tensor
twins of the pendulum tasks and of the planar cheetah that step on the card beside the learner, so
the fused loop (:mod:`..sac.ondevice`) collects, pushes and trains with
no host env in the way.

Protocol (class methods over a batch of ``n`` envs):

- ``reset(n, generator=None, device=None, pose=None) -> EnvState``;
- ``step(state, action, pose=None) -> (EnvState, StepOut)`` — auto-resets
  ended episodes (the returned state holds the next episode's first
  state there); ``StepOut.next_obs`` is the pre-reset observation, the
  one replay stores. A pendulum episode only truncates, so
  ``StepOut.terminated`` stays 0.

Every tensor of a state has a leading ``n`` axis. Reset randomness: the
JAX package keeps one PRNG key per env; the port keeps one
``torch.Generator`` for the batch (``EnvState.rng``). Every step draws a
fresh pose for every env (:meth:`PendulumTorch.sample_pose`) and
``torch.where`` keeps it where an episode ended, so a step is one static
program with no host branch (a CUDA graph can hold it). The
distributions are JAX's; the streams differ, so tests inject the draws
(``pose``).

Registry: the JAX names this port serves (``Pendulum-v1``,
``PixelPendulum-v0``, ``PixelPendulumBalance-v0``) and the port's
no-gymnasium names for the same dynamics (``PendulumNumpy-v1``,
``PixelPendulum[Balance]Numpy-v0``), so a run named after a host env the
card's machine can build is evaluated there by ``run_agent``; and
``HalfCheetah-v3/-v4/-v5`` and ``cheetah-run-jax`` for the cheetah twin
(surrogate dynamics, see :class:`CheetahRunTorch`).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import typing as t

import torch

from torch_actor_critic_tpu_torch.core.types import MultiObservation
from torch_actor_critic_tpu_torch.envs.pixel_pendulum import SIZE, render_rod_torch

logger = logging.getLogger(__name__)


def tree_map(fn, x):
    """``fn`` over the tensors of a state field: a tensor, a tuple, a
    :class:`MultiObservation` or a nested :class:`EnvState`."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        return tuple(tree_map(fn, y) for y in x)
    if isinstance(x, MultiObservation):
        return x.map(lambda y: tree_map(fn, y))
    if isinstance(x, EnvState):
        return x.map(fn)
    raise TypeError(f"not a state field: {type(x).__name__}")


def tree_leaves(x) -> t.List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [leaf for y in x for leaf in tree_leaves(y)]
    if isinstance(x, MultiObservation):
        return tree_leaves(x.features) + tree_leaves(x.frame)
    if isinstance(x, EnvState):
        return x.leaves()
    raise TypeError(f"not a state field: {type(x).__name__}")


def select(cond: torch.Tensor, a, b):
    """``torch.where(cond, a, b)`` leaf by leaf, ``cond`` ``(n,)``
    broadcast over each leaf's trailing axes."""
    def pick(x, y):
        return torch.where(cond.reshape(cond.shape + (1,) * (x.dim() - 1)), x, y)

    if isinstance(a, torch.Tensor):
        return pick(a, b)
    if isinstance(a, tuple):
        return tuple(select(cond, x, y) for x, y in zip(a, b, strict=True))
    if isinstance(a, MultiObservation):
        return MultiObservation(select(cond, a.features, b.features),
                                select(cond, a.frame, b.frame))
    return EnvState(inner=select(cond, a.inner, b.inner), obs=select(cond, a.obs, b.obs),
                    step_count=pick(a.step_count, b.step_count),
                    episode_return=pick(a.episode_return, b.episode_return), rng=a.rng)


@dataclasses.dataclass
class EnvState:
    """A batch of env states: the physics (``inner``: a tuple of tensors,
    or the base env's state under :func:`history_env`), the observation,
    the step in the episode (int32) and the running return (f32), each
    with a leading ``n_envs`` axis; ``rng``, the batch's reset generator
    (carried by every step, not a leaf)."""

    inner: t.Any
    obs: t.Any
    step_count: torch.Tensor
    episode_return: torch.Tensor
    rng: torch.Generator | None = None

    def map(self, fn) -> "EnvState":
        return EnvState(inner=tree_map(fn, self.inner), obs=tree_map(fn, self.obs),
                        step_count=fn(self.step_count),
                        episode_return=fn(self.episode_return), rng=self.rng)

    def leaves(self) -> t.List[torch.Tensor]:
        return [*tree_leaves(self.inner), *tree_leaves(self.obs), self.step_count,
                self.episode_return]

    def clone(self, _gens: dict | None = None) -> "EnvState":
        """An independent copy: every leaf, and a new generator at this
        one's state (one for each generator object, so a history state
        and the base state it wraps share their copy as they share the
        original)."""
        gens = {} if _gens is None else _gens
        rng = self.rng
        if rng is not None:
            if id(rng) not in gens:
                gens[id(rng)] = torch.Generator(device=rng.device)
                gens[id(rng)].set_state(rng.get_state())
            rng = gens[id(rng)]
        inner = (self.inner.clone(gens) if isinstance(self.inner, EnvState)
                 else tree_map(torch.clone, self.inner))
        return EnvState(inner=inner, obs=tree_map(torch.clone, self.obs),
                        step_count=self.step_count.clone(),
                        episode_return=self.episode_return.clone(), rng=rng)

    def copy_(self, other: "EnvState") -> None:
        """Write ``other``'s leaves into this state's tensors, in place (a
        captured acting step holds their addresses)."""
        for dst, src in zip(self.leaves(), other.leaves(), strict=True):
            dst.copy_(src)

    def state_dict(self) -> dict:
        """A host snapshot for a checkpoint: every leaf, in
        :meth:`leaves`' order, and the reset generator's state."""
        return {"leaves": [x.detach().to("cpu", copy=True) for x in self.leaves()],
                "rng": None if self.rng is None else self.rng.get_state()}

    def load_state_dict_(self, saved: t.Mapping[str, t.Any]) -> None:
        """Restore :meth:`state_dict`'s snapshot in place (a captured
        acting step holds these tensors and this generator)."""
        leaves = self.leaves()
        if len(leaves) != len(saved["leaves"]):
            raise ValueError(f"env snapshot holds {len(saved['leaves'])} leaves, "
                             f"the state {len(leaves)}")
        for dst, src in zip(leaves, saved["leaves"]):
            if dst.shape != src.shape:
                raise ValueError(f"env snapshot leaf {tuple(src.shape)} != {tuple(dst.shape)}")
            dst.copy_(src)
        if self.rng is not None and saved["rng"] is not None:
            self.rng.set_state(saved["rng"])


@dataclasses.dataclass
class StepOut:
    """What the loop takes from one step of the batch."""

    next_obs: t.Any  # pre-reset next observation (what replay stores)
    reward: torch.Tensor
    terminated: torch.Tensor  # f32 0/1: the Bellman mask (not truncation)
    ended: torch.Tensor  # bool: the episode finished; the env auto-reset
    final_return: torch.Tensor  # the episode's return; meaningful where ended


def _uniform_pose(n, generator, device, theta_max: float, theta_dot_max: float):
    """``(n, 2)`` ``(theta, theta_dot)`` uniform in ``±theta_max``,
    ``±theta_dot_max``: one ``(n, 2)`` uniform draw from ``generator``."""
    u = torch.rand((n, 2), generator=generator, device=device)
    return torch.stack([u[:, 0] * (2 * theta_max) - theta_max,
                        u[:, 1] * (2 * theta_dot_max) - theta_dot_max], dim=-1)


class PendulumTorch:
    """Pendulum swing-up (the dynamics of gymnasium's ``Pendulum-v1``, as
    the JAX package's ``PendulumJax``): theta'' = 3g/(2l) sin(theta) +
    3/(m l^2) u, dt 0.05, torque and speed clipped, reward -(angle^2 +
    0.1 theta_dot^2 + 0.001 u^2), 200-step truncation, auto-reset."""

    obs_dim = 3
    act_dim = 1
    act_limit = 2.0
    max_episode_steps = 200

    max_speed = 8.0
    dt = 0.05
    g = 10.0
    m = 1.0
    length = 1.0

    @classmethod
    def sample_pose(cls, n: int, generator: torch.Generator | None, device=None) -> torch.Tensor:
        """``(n, 2)`` reset poses: theta ~ U(±pi), theta_dot ~ U(±1)."""
        return _uniform_pose(n, generator, device, math.pi, 1.0)

    @classmethod
    def _obs(cls, theta, theta_dot):
        return torch.stack([torch.cos(theta), torch.sin(theta), theta_dot], dim=-1)

    @classmethod
    def _from_pose(cls, pose: torch.Tensor) -> EnvState:
        theta, theta_dot = pose[:, 0].contiguous(), pose[:, 1].contiguous()
        n = theta.shape[0]
        return EnvState(
            inner=(theta, theta_dot), obs=cls._obs(theta, theta_dot),
            step_count=torch.zeros(n, dtype=torch.int32, device=theta.device),
            episode_return=torch.zeros(n, dtype=torch.float32, device=theta.device),
        )

    @classmethod
    def reset(cls, n: int, generator: torch.Generator | None = None, device=None,
              pose: torch.Tensor | None = None) -> EnvState:
        if pose is None:
            pose = cls.sample_pose(n, generator, device)
        state = cls._from_pose(pose)
        state.rng = generator
        return state

    @classmethod
    def step(cls, state: EnvState, action: torch.Tensor, pose: torch.Tensor | None = None):
        theta, theta_dot = state.inner
        u = torch.clamp(action[:, 0], -cls.act_limit, cls.act_limit)
        angle = torch.remainder(theta + math.pi, 2 * math.pi) - math.pi
        reward = -(angle**2 + 0.1 * theta_dot**2 + 0.001 * u**2)

        theta_dot = theta_dot + cls.dt * (
            3.0 * cls.g / (2.0 * cls.length) * torch.sin(theta)
            + 3.0 / (cls.m * cls.length**2) * u
        )
        theta_dot = torch.clamp(theta_dot, -cls.max_speed, cls.max_speed)
        theta = theta + cls.dt * theta_dot

        step_count = state.step_count + 1
        ended = step_count >= cls.max_episode_steps  # truncation only
        stepped = EnvState(
            inner=(theta, theta_dot), obs=cls._obs(theta, theta_dot), step_count=step_count,
            episode_return=state.episode_return + reward, rng=state.rng,
        )
        if pose is None:
            pose = cls.sample_pose(theta.shape[0], state.rng, theta.device)
        next_state = select(ended, cls._from_pose(pose), stepped)
        out = StepOut(next_obs=stepped.obs, reward=reward,
                      terminated=torch.zeros_like(reward), ended=ended,
                      final_return=stepped.episode_return)
        return next_state, out


class PixelPendulumTorch:
    """The pixel pendulum on the card (the JAX package's
    ``PixelPendulumJax``): a 32x32x3 uint8 frame of the rod at t-2, t-1
    and t rendered by :func:`~.pixel_pendulum.render_rod_torch`, and as
    ``features`` only the previous action; physics from
    :class:`PendulumTorch`. ``inner`` is ``(theta, theta_dot, hist)``,
    ``hist`` ``(n, 2)`` the two poses behind the current one."""

    act_dim = 1
    act_limit = 2.0
    max_episode_steps = 200

    @classmethod
    def obs_spec(cls) -> MultiObservation:
        """The observation's shapes, as the port's ``build_models`` takes
        them."""
        return MultiObservation(features=(cls.act_dim,), frame=(SIZE, SIZE, 3))

    @classmethod
    def sample_pose(cls, n: int, generator: torch.Generator | None, device=None) -> torch.Tensor:
        """The reset distribution, the only point subclasses change
        (reset and the in-step auto-reset both draw through it): the
        full circle, as Pendulum-v1."""
        return _uniform_pose(n, generator, device, math.pi, 1.0)

    @classmethod
    def _obs(cls, thetas: t.Sequence[torch.Tensor], last_action: torch.Tensor) -> MultiObservation:
        """The observation from the (t-2, t-1, t) poses."""
        n = thetas[0].shape[0]
        frames = render_rod_torch(torch.stack(thetas, dim=1).reshape(-1))
        frame = frames.reshape(n, 3, SIZE, SIZE).permute(0, 2, 3, 1).contiguous()
        return MultiObservation(
            features=last_action.reshape(n, cls.act_dim).to(torch.float32), frame=frame)

    @classmethod
    def _from_pose(cls, pose: torch.Tensor) -> EnvState:
        theta, theta_dot = pose[:, 0].contiguous(), pose[:, 1].contiguous()
        n = theta.shape[0]
        zeros = torch.zeros((n, cls.act_dim), dtype=torch.float32, device=theta.device)
        # No motion at reset: all three rod channels show the same pose.
        return EnvState(
            inner=(theta, theta_dot, torch.stack([theta, theta], dim=1)),
            obs=cls._obs((theta, theta, theta), zeros),
            step_count=torch.zeros(n, dtype=torch.int32, device=theta.device),
            episode_return=torch.zeros(n, dtype=torch.float32, device=theta.device),
        )

    @classmethod
    def reset(cls, n: int, generator: torch.Generator | None = None, device=None,
              pose: torch.Tensor | None = None) -> EnvState:
        if pose is None:
            pose = cls.sample_pose(n, generator, device)
        state = cls._from_pose(pose)
        state.rng = generator
        return state

    @classmethod
    def step(cls, state: EnvState, action: torch.Tensor, pose: torch.Tensor | None = None):
        theta, theta_dot, hist = state.inner
        n = theta.shape[0]
        if pose is None:
            pose = cls.sample_pose(n, state.rng, theta.device)
        flat = EnvState(inner=(theta, theta_dot), obs=PendulumTorch._obs(theta, theta_dot),
                        step_count=state.step_count, episode_return=state.episode_return,
                        rng=state.rng)
        # The flat step's auto-reset takes this class's pose.
        next_flat, out = PendulumTorch.step(flat, action, pose=pose)
        n_theta, n_theta_dot = next_flat.inner
        # The pre-reset pose, from the flat pre-reset observation (the
        # raster is 2pi-periodic, so atan2(sin, cos) serves).
        stepped_theta = torch.atan2(out.next_obs[:, 1], out.next_obs[:, 0])
        # Pre-reset observation (what replay stores): poses at (t-1, t,
        # t+1), features the action just taken.
        stepped_obs = cls._obs((hist[:, 1], theta, stepped_theta), action)
        # A fresh episode starts with no motion and no previous action.
        fresh_obs = cls._obs((n_theta, n_theta, n_theta),
                             torch.zeros((n, cls.act_dim), dtype=torch.float32,
                                         device=theta.device))
        next_obs = select(out.ended, fresh_obs, stepped_obs)
        # hist holds the two poses behind the current one.
        next_hist = select(out.ended, torch.stack([n_theta, n_theta], dim=1),
                           torch.stack([hist[:, 1], theta], dim=1))
        next_state = EnvState(inner=(n_theta, n_theta_dot, next_hist), obs=next_obs,
                              step_count=next_flat.step_count,
                              episode_return=next_flat.episode_return, rng=state.rng)
        return next_state, dataclasses.replace(out, next_obs=stepped_obs)


class PixelPendulumBalanceTorch(PixelPendulumTorch):
    """The balance start (``PixelPendulumBalance-v0``'s twin): poses near
    upright, theta ~ U(±0.15 pi), theta_dot ~ U(±0.2), at reset and at
    the auto-reset."""

    @classmethod
    def sample_pose(cls, n: int, generator: torch.Generator | None, device=None) -> torch.Tensor:
        return _uniform_pose(n, generator, device, 0.15 * math.pi, 0.2)


class CheetahRunTorch:
    """Planar cheetah locomotion on the card (the JAX package's
    ``CheetahRunJax``), interface-identical to gymnasium's
    ``HalfCheetah``: ``qpos`` = [x, z, pitch, bthigh, bshin, bfoot,
    fthigh, fshin, ffoot] (9), ``qvel`` the matching rates (9); obs
    ``concat(qpos[1:], qvel)`` (17); 6 joint torques in [-1, 1]; reward
    ``dx / dt - 0.1 ||u||^2``; dt 0.05 as 5 substeps of 0.01; never
    terminates, truncates at 1000 steps.

    The dynamics are JAX's surrogate, not MuJoCo: torque-driven
    spring-damper joints with soft range limits, a sigmoid contact weight
    per foot from the leg kinematics, tanh stick-slip friction, a ±25
    velocity clip and semi-implicit Euler. Shapes and throughput carry
    over to the real task; returns do not. ``inner`` is ``(qpos, qvel)``,
    each ``(n, 9)``; a reset pose is ``(n, 16)``: 7 joint and pitch
    offsets uniform in ±0.1, then 9 velocities, normals × 0.1."""

    obs_dim = 17
    act_dim = 6
    act_limit = 1.0
    max_episode_steps = 1000

    dt = 0.05
    n_substeps = 5
    gravity = 9.81
    mass = 14.0

    # Per joint, [bthigh, bshin, bfoot, fthigh, fshin, ffoot] (JAX's values).
    gear = (130.0, 100.0, 90.0, 130.0, 100.0, 70.0)
    joint_k = 100.0
    joint_d = 12.0
    joint_range = (1.05, 1.1, 0.8, 1.0, 1.2, 0.9)

    z_rest = 0.6
    ground_k = 4000.0
    ground_d = 100.0
    friction_mu = 0.8
    slip_v0 = 0.5
    pitch_k = 40.0
    pitch_d = 6.0

    @classmethod
    def sample_pose(cls, n: int, generator: torch.Generator | None, device=None) -> torch.Tensor:
        """``(n, 16)`` reset poses: ``U(±0.1)`` offsets of ``qpos[2:]``,
        then ``0.1 N(0, 1)`` velocities."""
        u = torch.rand((n, 7), generator=generator, device=device)
        v = torch.randn((n, 9), generator=generator, device=device)
        return torch.cat([u * 0.2 - 0.1, 0.1 * v], dim=-1)

    @classmethod
    def _obs(cls, qpos, qvel):
        return torch.cat([qpos[:, 1:], qvel], dim=-1)

    @classmethod
    def _from_pose(cls, pose: torch.Tensor) -> EnvState:
        n = pose.shape[0]
        head = torch.zeros((n, 2), dtype=torch.float32, device=pose.device)
        head[:, 1] = cls.z_rest
        qpos = torch.cat([head, pose[:, :7]], dim=-1)
        qvel = pose[:, 7:].contiguous()
        return EnvState(
            inner=(qpos, qvel), obs=cls._obs(qpos, qvel),
            step_count=torch.zeros(n, dtype=torch.int32, device=pose.device),
            episode_return=torch.zeros(n, dtype=torch.float32, device=pose.device),
        )

    @classmethod
    def reset(cls, n: int, generator: torch.Generator | None = None, device=None,
              pose: torch.Tensor | None = None) -> EnvState:
        if pose is None:
            pose = cls.sample_pose(n, generator, device)
        state = cls._from_pose(pose)
        state.rng = generator
        return state

    _consts: t.ClassVar[dict] = {}  # (gear, joint_range) by device, made outside any capture

    @classmethod
    def _gear_and_range(cls, device: torch.device) -> t.Tuple[torch.Tensor, torch.Tensor]:
        """The per-joint constants as f32 tensors on ``device``, made once
        (a captured step must not copy from the host)."""
        key = str(device)
        if key not in cls._consts:
            cls._consts[key] = tuple(torch.tensor(v, dtype=torch.float32, device=device)
                                     for v in (cls.gear, cls.joint_range))
        return cls._consts[key]

    @classmethod
    def _foot_heights(cls, qpos: torch.Tensor) -> torch.Tensor:
        """``(n, 2)`` back and front foot clearance: thigh and shin
        flexion shorten the leg, the ankle retracts the foot."""
        z, pitch = qpos[:, 1], qpos[:, 2]
        bthigh, bshin, bfoot = qpos[:, 3], qpos[:, 4], qpos[:, 5]
        fthigh, fshin, ffoot = qpos[:, 6], qpos[:, 7], qpos[:, 8]
        h_back = (z - cls.z_rest * torch.cos(bthigh + 0.5 * bshin + 0.3 * pitch)
                  + 0.25 * (1.0 - torch.cos(bfoot)))
        h_front = (z - cls.z_rest * torch.cos(fthigh + 0.5 * fshin - 0.3 * pitch)
                   + 0.25 * (1.0 - torch.cos(ffoot)))
        return torch.stack([h_back, h_front], dim=-1)

    @classmethod
    def _substep(cls, qpos, qvel, u, h: float, gear, joint_range):
        pitch = qpos[:, 2]
        joints = qpos[:, 3:]
        vx, vz, pitch_dot = qvel[:, 0], qvel[:, 1], qvel[:, 2]
        joint_vel = qvel[:, 3:]

        over = torch.clamp_min(torch.abs(joints) - joint_range, 0.0)
        limit_torque = -300.0 * over * torch.sign(joints)
        joint_acc = gear * u - cls.joint_k * joints - cls.joint_d * joint_vel + limit_torque

        foot_h = cls._foot_heights(qpos)
        contact = torch.sigmoid(-foot_h / 0.03)
        penetration = torch.clamp_min(-foot_h, 0.0)
        normal = contact * (cls.ground_k * penetration - cls.ground_d * vz[:, None])
        normal = torch.clamp_min(normal, 0.0)

        combo_vel = torch.stack([
            joint_vel[:, 0] + 0.5 * joint_vel[:, 1] + 0.3 * pitch_dot,
            joint_vel[:, 3] + 0.5 * joint_vel[:, 4] - 0.3 * pitch_dot,
        ], dim=-1)
        combo_ang = torch.stack([
            joints[:, 0] + 0.5 * joints[:, 1] + 0.3 * pitch,
            joints[:, 3] + 0.5 * joints[:, 4] - 0.3 * pitch,
        ], dim=-1)
        foot_vx = vx[:, None] + cls.z_rest * torch.cos(combo_ang) * combo_vel
        f_x = torch.sum(-cls.friction_mu * normal * torch.tanh(foot_vx / cls.slip_v0), dim=-1)
        acc_x = f_x / cls.mass
        acc_z = -cls.gravity + torch.sum(normal, dim=-1) / cls.mass
        acc_pitch = (0.08 * (cls.gear[0] * u[:, 0] + cls.gear[3] * u[:, 3])
                     - cls.pitch_k * pitch - cls.pitch_d * pitch_dot)

        acc = torch.cat([torch.stack([acc_x, acc_z, acc_pitch], dim=-1), joint_acc], dim=-1)
        qvel = torch.clamp(acc * h + qvel, -25.0, 25.0)
        return qpos + h * qvel, qvel  # semi-implicit Euler

    @classmethod
    def step(cls, state: EnvState, action: torch.Tensor, pose: torch.Tensor | None = None):
        qpos, qvel = state.inner
        u = torch.clamp(action, -cls.act_limit, cls.act_limit)
        x_before = qpos[:, 0]
        h = cls.dt / cls.n_substeps
        gear, joint_range = cls._gear_and_range(u.device)
        for _ in range(cls.n_substeps):
            qpos, qvel = cls._substep(qpos, qvel, u, h, gear, joint_range)
        reward = (qpos[:, 0] - x_before) / cls.dt - 0.1 * torch.sum(u**2, dim=-1)

        step_count = state.step_count + 1
        ended = step_count >= cls.max_episode_steps  # truncation only
        stepped = EnvState(
            inner=(qpos, qvel), obs=cls._obs(qpos, qvel), step_count=step_count,
            episode_return=state.episode_return + reward, rng=state.rng,
        )
        if pose is None:
            pose = cls.sample_pose(qpos.shape[0], state.rng, qpos.device)
        next_state = select(ended, cls._from_pose(pose), stepped)
        out = StepOut(next_obs=stepped.obs, reward=reward,
                      terminated=torch.zeros_like(reward), ended=ended,
                      final_return=stepped.episode_return)
        return next_state, out


ON_DEVICE_ENVS = {
    "Pendulum-v1": PendulumTorch,
    "PendulumNumpy-v1": PendulumTorch,
    "PixelPendulum-v0": PixelPendulumTorch,
    "PixelPendulumNumpy-v0": PixelPendulumTorch,
    "PixelPendulumBalance-v0": PixelPendulumBalanceTorch,
    "PixelPendulumBalanceNumpy-v0": PixelPendulumBalanceTorch,
    "HalfCheetah-v3": CheetahRunTorch,
    "HalfCheetah-v4": CheetahRunTorch,
    "HalfCheetah-v5": CheetahRunTorch,
    "cheetah-run-jax": CheetahRunTorch,
}

# Twins the JAX package has and this port does not yet, by what they wait for.
NOT_PORTED_ENVS = dict.fromkeys(
    ("multi-pendulum-2", "multi-pendulum-4", "hurdle-runner", "pendulum-multitask"),
    "the scenario envs")

# Names whose twin's dynamics are a surrogate of the env they answer to.
_SURROGATE_DYNAMICS = {"HalfCheetah-v3", "HalfCheetah-v4", "HalfCheetah-v5"}


def known_on_device_envs() -> t.List[str]:
    return sorted(ON_DEVICE_ENVS)


def get_on_device_env(name: str):
    """The twin of ``name``; None when it has none. A name whose twin the
    JAX package has and the port does not yet raises
    ``NotImplementedError`` naming what it waits for. A gymnasium
    ``HalfCheetah`` name resolves to :class:`CheetahRunTorch` with a
    warning: its dynamics are a surrogate, so its returns are not
    MuJoCo's."""
    if name in NOT_PORTED_ENVS:
        raise NotImplementedError(
            f"the on-device twin of {name!r} is not ported yet ({NOT_PORTED_ENVS[name]}); "
            f"ported twins: {known_on_device_envs()}"
        )
    env = ON_DEVICE_ENVS.get(name)
    if name in _SURROGATE_DYNAMICS:
        logger.warning(
            "on-device env for %r uses SURROGATE dynamics (%s): throughput comparisons "
            "are valid, return values are NOT comparable to MuJoCo %s. Use the host "
            "loop (on_device=False) for physics-parity returns.", name, env.__name__, name)
    return env


def history_env(base_cls, horizon: int):
    """A sliding-window history over an on-device env class (the twin of
    the host ``HistoryEnv`` wrapper): observations become ``(horizon,
    obs_dim)`` windows, newest last, filled with the first observation
    on (auto-)reset and rolled on every step; the base state rides in
    ``inner``. The pushed ``next_obs`` is the window before the reset."""
    horizon = int(horizon)
    if horizon < 2:
        raise ValueError(f"history_env needs horizon >= 2, got {horizon}")
    if hasattr(base_cls, "obs_spec"):
        raise ValueError(
            f"history_env: {base_cls.__name__} has pytree (visual) observations; the "
            "sequence stack windows flat vectors only (as the host trainer's history path)"
        )

    class HistoryTorch:
        obs_dim = base_cls.obs_dim  # per-timestep width
        obs_shape = (horizon, base_cls.obs_dim)
        act_dim = base_cls.act_dim
        act_limit = base_cls.act_limit
        max_episode_steps = base_cls.max_episode_steps
        sample_pose = base_cls.sample_pose

        @classmethod
        def _fill(cls, obs):
            return obs[:, None].expand(obs.shape[0], horizon, *obs.shape[1:]).contiguous()

        @classmethod
        def _wrap(cls, s: EnvState, window: torch.Tensor) -> EnvState:
            return EnvState(inner=s, obs=window, step_count=s.step_count.clone(),
                            episode_return=s.episode_return.clone(), rng=s.rng)

        @classmethod
        def reset(cls, n: int, generator: torch.Generator | None = None, device=None,
                  pose: torch.Tensor | None = None) -> EnvState:
            s = base_cls.reset(n, generator, device, pose)
            return cls._wrap(s, cls._fill(s.obs))

        @classmethod
        def step(cls, state: EnvState, action: torch.Tensor, pose: torch.Tensor | None = None):
            s_next, out = base_cls.step(state.inner, action, pose)
            pushed = torch.cat([state.obs[:, 1:], out.next_obs[:, None]], dim=1)
            window = select(out.ended, cls._fill(s_next.obs), pushed)
            return cls._wrap(s_next, window), dataclasses.replace(out, next_obs=pushed)

    HistoryTorch.__name__ = f"History{horizon}x{base_cls.__name__}"
    HistoryTorch.__qualname__ = HistoryTorch.__name__
    return HistoryTorch
