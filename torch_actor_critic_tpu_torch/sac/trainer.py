"""End-to-end SAC or TD3 training on one device (port of
``sac/trainer.py``'s ``Trainer``: ``train`` and ``evaluate``, and
``make_learner``, the one algorithm dispatch).

The host loop is the JAX trainer's, step for step: a lockstep step
counter, uniform random actions for the first ``start_steps`` steps,
the ``max_ep_len`` done-bypass (an episode cut by the length cap stores
``done = 0``), epoch-end resets seeded by :meth:`Trainer._epoch_seed`,
an update window every ``update_every`` steps (``(step + 1) %
update_every == 0``) that pushes the staged transitions and, once
``step > update_after``, runs a burst of ``updates_per_window``
gradient steps on the device (on the card, replays of one captured
update: :meth:`~.algorithm.Learner.update_burst`). Acting between bursts
reads the parameters the replays updated in place; the burst's metrics
are new tensors, read once at epoch end, outside the graph, as the
sentinel is.

Acting runs on the training device through the same kernels as the
learner (the JAX trainer's ``host_actor`` CPU mirror is accepted and
has no effect): SAC samples its squashed Gaussian, TD3 adds its clipped
exploration noise, both drawn from the acting generator; evaluation is
deterministic. ``algorithm="td3"`` takes the flat and visual stacks; a
history raises ``ValueError``, as in JAX.

The resilience path is the JAX trainer's. At each epoch boundary the
divergence sentinel (``sentinel=True``) runs one all-finite pass over
the learner state, the replay ring and the epoch's losses; a
non-finite epoch rolls back, in place, to the newest checkpoint
(:meth:`Trainer._rollback`), within ``max_rollbacks`` consecutive
rollbacks (:class:`~..resilience.sentinel.TrainingDiverged` past them,
or with nothing to roll back to). Only sentinel-validated epochs are
saved, every ``save_every`` epochs and always at the last, as full
state (:class:`~..utils.checkpoint.Checkpointer`: the learner, the ring,
the step counter, the normalizer and the acting generator), so the
port's serving CLI serves what was trained and :meth:`Trainer.restore`
resumes it. A :class:`~..resilience.preemption.PreemptionGuard`
(``preemption=``) is polled at safe boundaries, never inside a burst:
after one signal the epoch finishes, is saved and
:class:`~..resilience.preemption.Preempted` is raised; after two, the
save happens at the next update-window boundary. A resumed run equals
the uninterrupted one bitwise when it resumes from an epoch boundary
and ``steps_per_epoch % update_every == 0``: transitions staged in a
half window are not checkpointed (nor are they by the JAX trainer).

``normalize_observations`` selects the JAX trainer's normalizer: Welford
statistics for flat observations, for the ``features`` leaf of visual
ones, none (with a warning) for a history stack.

A visual env (a :class:`~..core.types.MultiObservation` spec) gets the
visual models and a ring with **uint8** frames: staged frames stay
uint8 on their way to the device, acting feeds uint8 frames (the CNN
decodes them), and ``pixel_pipeline="fused"`` samples through the
kernel K1. ``frame_augment``/``pixel_pipeline`` on a non-visual env
raise ``ValueError`` at construction, as in JAX.

Config fields this slice does not implement raise
``NotImplementedError`` naming the field when they are not at their
defaults (:data:`NOT_PORTED`). ``on_device`` selects the fused loop
(:mod:`.ondevice`) in the train CLI; the host trainer ignores it, as
JAX's does.

Checkpoints are written asynchronously (:meth:`~..utils.checkpoint.
Checkpointer.save`); the trainer waits for the write in flight before
any restore or rollback, before it raises ``Preempted`` and at the end
of :meth:`Trainer.train`.
"""

from __future__ import annotations

import logging
import time
import typing as t

import numpy as np
import torch

from torch_actor_critic_tpu_torch.buffer.replay import (
    init_replay_buffer,
    init_visual_replay_buffer,
    push,
)
from torch_actor_critic_tpu_torch.core.types import Batch, MultiObservation, tree_map
from torch_actor_critic_tpu_torch.envs.vec_env import make_env_pool, stack_obs
from torch_actor_critic_tpu_torch.models import build_models
from torch_actor_critic_tpu_torch.resilience.preemption import Preempted, PreemptionGuard
from torch_actor_critic_tpu_torch.resilience.sentinel import (
    DivergenceSentinel,
    TrainingDiverged,
)
from torch_actor_critic_tpu_torch.sac.algorithm import SAC, Learner
from torch_actor_critic_tpu_torch.td3 import TD3
from torch_actor_critic_tpu_torch.utils.config import SACConfig
from torch_actor_critic_tpu_torch.utils.device import resolve_device
from torch_actor_critic_tpu_torch.utils.normalize import (
    FeaturesNormalizer,
    IdentityNormalizer,
    WelfordNormalizer,
)

logger = logging.getLogger(__name__)

# SACConfig fields whose non-default values select machinery this slice
# does not port. (Fields that only parameterise one of these, such as
# staging_policy under decoupled, are inert without it, as in JAX.)
NOT_PORTED = (
    "population",
    "pbt_every", "ma_critic", "task_embed_dim", "actor_param_lag",
    "parallel_envs", "decoupled", "serve_url", "actors",
    "elastic", "replay_tiers", "replay_refill", "offline", "telemetry",
    "diagnostics", "sanitize", "compile_cache", "emit_bundle", "obs",
    "obs_scrape", "slo_config",
)


def check_ported(config: SACConfig) -> None:
    """Raise ``NotImplementedError`` naming the first non-default field
    of :data:`NOT_PORTED`."""
    defaults = SACConfig()
    for name in NOT_PORTED:
        value = getattr(config, name)
        if value != getattr(defaults, name):
            raise NotImplementedError(
                f"SACConfig.{name}={value!r} is not ported yet (default "
                f"{getattr(defaults, name)!r})"
            )


def make_learner(config: SACConfig, act_dim: int) -> Learner:
    """The one algorithm dispatch, as the JAX trainer's: ``config.algorithm``
    picks :class:`~..td3.TD3` or :class:`~.algorithm.SAC`."""
    if config.algorithm == "td3":
        return TD3(config, act_dim)
    return SAC(config, act_dim)


class Trainer:
    """SAC or TD3 on one device with one host env. Per-run seeds: model init
    from ``seed``, the learner's generator from ``seed + 1``, acting from
    ``seed + 2``; the env at epoch ``e`` resets with
    :meth:`_epoch_seed`."""

    def __init__(
        self,
        env_name: str,
        config: SACConfig | None = None,
        tracker=None,
        checkpointer=None,
        seed: int = 0,
        device: str | torch.device | None = None,
        preemption: PreemptionGuard | None = None,
    ):
        self.config = config or SACConfig()
        check_ported(self.config)
        self.device = resolve_device(device)
        self.env_name = env_name
        self.seed = seed
        self.tracker = tracker
        self.checkpointer = checkpointer
        cfg = self.config
        pool_name = (
            f"{env_name}|history:{cfg.history_len}" if cfg.history_len > 1 else env_name
        )
        self.pool = make_env_pool(pool_name, 1, base_seed=seed, parallel=cfg.parallel_envs)
        spec = self.pool.obs_spec
        obs_shape = (
            spec.map(lambda leaf: tuple(leaf.shape))
            if isinstance(spec, MultiObservation) else tuple(spec.shape)
        )
        self.obs_shape = obs_shape
        if cfg.normalize_observations and isinstance(spec, MultiObservation):
            self.normalizer = FeaturesNormalizer(spec.features.shape[0])
        elif cfg.normalize_observations and len(spec.shape) == 1:
            self.normalizer = WelfordNormalizer(spec.shape[0])
        else:
            # History stacks run unnormalized (windows replay PAST
            # observations; normalizing them with later statistics leaks).
            if cfg.normalize_observations:
                logger.warning(
                    "normalize_observations=True ignored: obs spec %s is a history "
                    "stack, which runs unnormalized", tuple(spec.shape),
                )
            self.normalizer = IdentityNormalizer()
        self.sac = make_learner(cfg, self.pool.act_dim)
        actor, critic = build_models(
            cfg, obs_shape, self.pool.act_dim, self.pool.act_limit,
            generator=torch.Generator().manual_seed(seed),
        )
        self.state = self.sac.init_state(
            actor.to(self.device), critic.to(self.device),
            torch.Generator(device=self.device).manual_seed(seed + 1),
        )
        self._act_gen = torch.Generator(device=self.device).manual_seed(seed + 2)
        if isinstance(obs_shape, MultiObservation):
            self.buffer = init_visual_replay_buffer(
                cfg.buffer_size, obs_shape.features[0], obs_shape.frame,
                self.pool.act_dim, self.device,
            )
        else:
            self.buffer = init_replay_buffer(
                cfg.buffer_size, obs_shape, self.pool.act_dim, self.device
            )
        self.start_epoch = 0
        self._resume_step: int | None = None
        self.sentinel = DivergenceSentinel(cfg.max_rollbacks) if cfg.sentinel else None
        self.preemption = preemption

    # ------------------------------------------------------------ helpers

    def _epoch_seed(self, epoch: int) -> int:
        """Env seed at the start of ``epoch``: a pure function of (run
        seed, epoch)."""
        return self.seed + 1_000_003 * epoch

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        """A host array on the device: uint8 frames stay uint8 (4x fewer
        bytes; the model or the ring decodes them), the rest float32."""
        x = np.asarray(x)
        x = torch.from_numpy(x if x.dtype == np.uint8 else x.astype(np.float32))
        if self.device.type == "cuda":
            x = x.pin_memory()
        return x.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def _policy_actions(self, obs_batch, deterministic: bool = False) -> np.ndarray:
        """Actions for a batch of observations (array or
        :class:`MultiObservation` of arrays)."""
        obs = tree_map(self._to_device, obs_batch)
        action, _ = self.state.actor(
            obs, generator=None if deterministic else self._act_gen,
            deterministic=deterministic, with_logprob=False,
        )
        return action.cpu().numpy()

    def _place_chunk(self, staging: t.List[tuple]) -> Batch:
        """Stack one window of staged transitions into a chunk on the
        device, each leaf in its own dtype (frames uint8)."""

        def field(i):
            return tree_map(self._to_device, stack_obs([tr[i] for tr in staging]))

        return Batch(
            states=field(0), actions=field(1), rewards=field(2),
            next_states=field(3), done=field(4),
        )

    # --------------------------------------------------------- resilience

    def _checkpoint_extra(self, step: int) -> dict:
        """The JSON metadata saved beside the arrays: the config, the
        normalizer's statistics, the lockstep step counter (warm-up and
        update gates continue on resume) and the acting generator's
        state (the exploration stream continues bitwise)."""
        return {
            "config": self.config.to_json(),
            "normalizer": self.normalizer.state_dict(),
            "step": int(step),
            "act_key": self._act_gen.get_state().tolist(),
            "act_key_device": self._act_gen.device.type,
        }

    def _save_checkpoint(self, epoch: int, step: int) -> None:
        self.checkpointer.save(epoch, self.state, self.buffer,
                               extra=self._checkpoint_extra(step))

    def _load_checkpoint(self, epoch: int | None = None, include_buffer: bool = True) -> dict:
        """Restore the learner (and the ring, with ``include_buffer``),
        the normalizer and the acting generator in place from the
        checkpointer; shared by :meth:`restore` and :meth:`_rollback`.
        A checkpoint of another algorithm raises ``ValueError`` before
        any array is read. Returns the checkpoint's meta."""
        self.checkpointer.wait()
        meta_probe = self.checkpointer.peek_meta(epoch)
        if meta_probe.get("config"):
            saved_algo = SACConfig.from_json(meta_probe["config"]).algorithm
            if saved_algo != self.config.algorithm:
                raise ValueError(
                    f"checkpoint was written by algorithm={saved_algo!r} but this "
                    f"trainer is configured for {self.config.algorithm!r}; pass "
                    f"--algorithm {saved_algo} to resume it"
                )
        self.state, buffer, meta = self.checkpointer.restore(
            self.state, self.buffer if include_buffer else None, epoch=epoch)
        if buffer is not None:
            self.buffer = buffer
        if meta.get("normalizer"):
            self.normalizer.load_state_dict(meta["normalizer"])
        if meta.get("act_key"):
            if meta.get("act_key_device") == self._act_gen.device.type:
                self._act_gen.set_state(torch.tensor(meta["act_key"], dtype=torch.uint8))
            else:
                logger.warning(
                    "the checkpoint's acting generator lived on %r; this trainer's "
                    "is on %r and keeps its own state",
                    meta.get("act_key_device"), self._act_gen.device.type,
                )
        return meta

    def _rollback(self) -> int:
        """Divergence recovery: restore the newest (sentinel-validated)
        checkpoint in place — parameters, optimizer moments AND the
        replay ring (a poisoned ring would re-diverge on the next unlucky
        sample) — and report its epoch."""
        if self.checkpointer is not None:
            self.checkpointer.wait()
        if self.checkpointer is None or self.checkpointer.latest_epoch() is None:
            raise TrainingDiverged(
                "training state is non-finite and there is no checkpoint to roll "
                "back to (no checkpointer configured, or divergence before the "
                "first save)"
            )
        meta = self._load_checkpoint(epoch=None, include_buffer=True)
        return int(meta["epoch"])

    # -------------------------------------------------------------- train

    def train(self, on_epoch: t.Callable[[int, dict], None] | None = None) -> dict:
        """Run ``config.epochs`` epochs from ``start_epoch``; returns the
        last epoch's metrics. ``on_epoch(epoch, metrics)`` is called
        after each epoch."""
        cfg = self.config
        # A resumed run continues the checkpointed step counter, so the
        # warm-up and the update gates are not replayed.
        step = (self._resume_step if self._resume_step is not None
                else self.start_epoch * cfg.steps_per_epoch)
        # An epoch-boundary checkpoint's normalizer has already counted
        # this reset (the uninterrupted run's epoch-end reset); counting
        # it again would break the bitwise resume. (The JAX trainer counts
        # it twice.)
        counted = self._resume_step == self.start_epoch * cfg.steps_per_epoch
        obs = self.normalizer.normalize(self.pool.reset_at(
            0, seed=self._epoch_seed(self.start_epoch if cfg.epoch_reseed else 0)
        ), update=not counted)
        ep_ret, ep_len = 0.0, 0
        staging: t.List[tuple] = []
        last_metrics: dict = {}
        episode_rewards: list = []
        episode_lengths: list = []
        last_epoch = self.start_epoch + cfg.epochs - 1

        t_epoch = time.time()
        for e in range(self.start_epoch, last_epoch + 1):
            losses_q: t.List[torch.Tensor] = []
            losses_pi: t.List[torch.Tensor] = []
            for t_ in range(cfg.steps_per_epoch):
                if step < cfg.start_steps:
                    action = self.pool.sample_actions()[0]
                else:
                    action = self._policy_actions(stack_obs([obs]))[0]
                epoch_ended = t_ == cfg.steps_per_epoch - 1
                next_obs, reward, terminated, truncated = self.pool.step_at(0, action)
                next_obs = self.normalizer.normalize(next_obs, update=True)
                ep_len += 1
                ep_ret += reward
                # max_ep_len bypass: an episode cut by the length cap is a
                # truncation, so the bootstrap is not zeroed.
                hit_cap = ep_len >= cfg.max_ep_len
                done_for_buffer = np.float32(terminated and not hit_cap)
                staging.append((obs, action, np.float32(reward), next_obs, done_for_buffer))
                if terminated or truncated or hit_cap or epoch_ended:
                    episode_rewards.append(float(ep_ret))
                    episode_lengths.append(ep_len)
                    reset_seed = (
                        self._epoch_seed(e + 1) if epoch_ended and cfg.epoch_reseed else None
                    )
                    next_obs = self.normalizer.normalize(
                        self.pool.reset_at(0, seed=reset_seed), update=True)
                    ep_ret, ep_len = 0.0, 0
                obs = next_obs

                window_full = (step + 1) % cfg.update_every == 0
                if window_full:
                    chunk = self._place_chunk(staging)
                    del staging[:]
                    if step > cfg.update_after:
                        self.state, self.buffer, m = self.sac.update_burst(
                            self.state, self.buffer, chunk, cfg.updates_per_window
                        )
                        # Device scalars; read once at epoch end.
                        losses_q.append(m["loss_q"])
                        losses_pi.append(m["loss_pi"])
                    else:
                        self.buffer = push(self.buffer, chunk)
                step += 1

                # Urgent preemption (a second signal): the window boundary
                # is the safe step boundary (staging just flushed, the burst
                # done), so save now and unwind. The learner state is
                # lossless; the epoch's un-stepped env tail is skipped on
                # resume.
                if window_full and self.preemption is not None and self.preemption.urgent:
                    if self.checkpointer is not None:
                        self._synchronize()
                        self._save_checkpoint(e, step)
                        self.checkpointer.wait()
                    raise Preempted(epoch=e, urgent=True)

            self._synchronize()
            dt = time.time() - t_epoch
            grad_steps = len(losses_q) * cfg.updates_per_window
            rew = np.asarray(episode_rewards, np.float64)
            last_metrics = {
                "episode_length": float(np.mean(episode_lengths)) if episode_lengths else 0.0,
                "reward": float(rew.mean()) if rew.size else 0.0,
                "reward_std": float(rew.std()) if rew.size else 0.0,
                "reward_min": float(rew.min()) if rew.size else 0.0,
                "reward_max": float(rew.max()) if rew.size else 0.0,
                "loss_q": float(torch.stack(losses_q).mean()) if losses_q else 0.0,
                "loss_pi": float(torch.stack(losses_pi).mean()) if losses_pi else 0.0,
                "env_steps_per_sec": cfg.steps_per_epoch / dt,
                "grad_steps_per_sec": grad_steps / dt,
            }
            # Divergence sentinel: one all-finite pass over the learner
            # state, the ring and this epoch's losses, BEFORE anything is
            # saved, so every checkpoint on disk is sentinel-validated and
            # the newest is the last good one.
            t_sentinel = time.perf_counter()
            sentinel_ok = True
            if self.sentinel is not None:
                sentinel_ok = self.sentinel.check(
                    self.state, self.buffer.data, losses_q, losses_pi)
                if not sentinel_ok:
                    # Budget first: raises TrainingDiverged once exhausted.
                    self.sentinel.note_divergence(f"state at epoch {e}")
                    rolled_to = self._rollback()
                    logger.warning(
                        "epoch %d: non-finite training state; rolled back to "
                        "checkpoint epoch %d (rollback %d, %d consecutive), "
                        "skipping the save", e, rolled_to,
                        self.sentinel.total_rollbacks, self.sentinel.consecutive,
                    )
                else:
                    self.sentinel.note_good()
                last_metrics["rollbacks"] = self.sentinel.total_rollbacks
            last_metrics["sentinel_s"] = round(time.perf_counter() - t_sentinel, 4)

            # The last epoch always saves, so a short run leaves a
            # checkpoint to serve, evaluate and resume.
            saved_this_epoch = False
            t_save = time.perf_counter()
            if sentinel_ok and self.checkpointer is not None and (
                e % cfg.save_every == 0 or e == last_epoch
            ):
                self._save_checkpoint(e, step)
                saved_this_epoch = True
            # save_s: the training thread's time in save (the host copies,
            # and the wait for the write before); the write itself runs in
            # the background, and save_write_s is the newest finished one's
            last_metrics["save_s"] = round(time.perf_counter() - t_save, 4)
            if self.checkpointer is not None and self.checkpointer.last_write_s is not None:
                last_metrics["save_write_s"] = round(self.checkpointer.last_write_s, 4)
            if self.tracker is not None:
                self.tracker.log_metrics(last_metrics, e)
            if on_epoch is not None:
                on_epoch(e, dict(last_metrics))

            # Graceful preemption (one signal): the epoch is complete and,
            # if it passed the sentinel, saved: the lossless exit point.
            if self.preemption is not None and self.preemption.triggered:
                if sentinel_ok and self.checkpointer is not None and not saved_this_epoch:
                    self._save_checkpoint(e, step)
                if self.checkpointer is not None:
                    self.checkpointer.wait()
                raise Preempted(epoch=e)
            episode_rewards, episode_lengths = [], []
            t_epoch = time.time()
        if self.checkpointer is not None:
            self.checkpointer.wait()
        return last_metrics

    def _synchronize(self) -> None:
        """Wait for the device's queued work (bursts, pushes)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- resume

    def restore(self, epoch: int | None = None, include_buffer: bool = True) -> int:
        """Resume the full state (ring, normalizer and acting generator
        included) from the checkpointer, newest epoch by default;
        returns the epoch :meth:`train` starts at. ``include_buffer=False``
        restores the learner only (the evaluation CLI)."""
        if self.checkpointer is None:
            raise ValueError("no checkpointer configured")
        meta = self._load_checkpoint(epoch, include_buffer)
        self.start_epoch = int(meta["epoch"]) + 1
        self._resume_step = int(meta["step"])
        return self.start_epoch

    # ----------------------------------------------------------- evaluate

    def evaluate(
        self, episodes: int = 10, deterministic: bool = True, seed: int | None = None
    ) -> dict:
        """Rollouts of the current policy. Episode ``i`` resets with
        ``seed + i``, and the acting generator is re-seeded from ``seed``
        for the evaluation (then restored)."""
        saved = self._act_gen
        if seed is not None:
            self._act_gen = torch.Generator(device=self.device).manual_seed(seed)
        try:
            returns, lengths = [], []
            for i in range(episodes):
                obs = self.normalizer.normalize(
                    self.pool.reset_at(0, seed=None if seed is None else seed + i),
                    update=False)
                ret, length, done = 0.0, 0, False
                while not done:
                    action = self._policy_actions(stack_obs([obs]), deterministic)[0]
                    obs, reward, terminated, truncated = self.pool.step_at(0, action)
                    obs = self.normalizer.normalize(obs, update=False)
                    ret += reward
                    length += 1
                    done = terminated or truncated or length >= self.config.max_ep_len
                returns.append(ret)
                lengths.append(length)
        finally:
            self._act_gen = saved
        return {
            "ep_ret_mean": float(np.mean(returns)),
            "ep_ret_std": float(np.std(returns)),
            "ep_len_mean": float(np.mean(lengths)),
        }

    def close(self) -> None:
        self.pool.close()

