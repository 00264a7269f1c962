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

The envs step in lockstep, one ``pool.step(actions)`` a step for all of
them (``parallel_envs`` selects the native parallel pool,
:class:`~..envs.vec_env.ParallelEnvPool`, one worker process per env),
and an env whose episode ended is reset alone (``reset_at``).

``actor_param_lag`` acts one update window stale, so the env loop never
waits for a burst, as the JAX trainer's flag does. The trainer keeps an
acting snapshot of the actor (for a population, the member-stacked
actor). Before each burst, once ``step + 1 >= start_steps``, the
snapshot is refreshed from the **pre-burst** parameters by ``copy_`` on
the main stream, after the acting stream's last reads, and an event is
recorded behind the copy. On the card acting then runs on a stream of
its own that waits on that event and reads only the snapshot, so its
``.cpu()`` waits for the acting kernels alone; and a burst that only
replays its graph is spread over the window
(:meth:`~.algorithm.Learner.start_burst`): each lockstep step enqueues
its next replays, at most a couple queued on the device at a time, so
an acting step waits for one replay, not for the whole burst queued
ahead of it (nor is the host held by a full launch queue, which JAX's
asynchronous dispatch never is). The window's boundary enqueues what is
left and takes the burst's state, ring and losses, as do a save, the
epoch's end, an evaluation and a restore. A burst that captures, and
every burst on the CPU, runs at once. Without the flag acting reads the
live parameters on the main stream and every burst runs at once.
Evaluation and a restore (a rollback too) mark the snapshot stale, so
the next acting step refreshes it from the current parameters (JAX's
``_host_params = None``); warm-up acting, which is random, takes no
snapshot. A lag run's resume is therefore not bitwise with the
uninterrupted run (the resumed window acts on the post-burst
parameters), as in JAX.

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

``population = P > 1`` trains ``P`` independent members in lockstep, as
the JAX trainer's population mode: one env per member (env ``i`` seeded
as JAX seeds slot ``i``), one member-stacked learner
(:class:`~..parallel.population.PopulationLearner` over
:class:`~.population.PopulationSAC` or :class:`~.population.PopulationTD3`:
one burst, one CUDA graph, for every member), rings ``(P, capacity,
...)``, member ``i`` acting on row ``i`` through the stacked actor, a
:class:`~..utils.normalize.PerMemberNormalizer` on flat observations
(visual and history observations run unnormalized, with JAX's warning),
``reward_m{i}`` per member in each epoch's metrics, ``grad_steps`` ×
``P``, and :meth:`Trainer.evaluate` returning each member's returns
(``per_member``). Its checkpoints hold what JAX's do: the stacked
learner, the member rings, the normalizer and the acting generator.

Config fields this slice does not implement raise
``NotImplementedError`` naming the field when they are not at their
defaults (:data:`NOT_PORTED`); ``pbt_every`` raises here (PBT runs over
the fused population). ``on_device`` selects the fused loop
(:mod:`.ondevice`) in the train CLI; the host trainer ignores it, as
JAX's does.

Checkpoints are written asynchronously (:meth:`~..utils.checkpoint.
Checkpointer.save`); the trainer waits for the write in flight before
any restore or rollback, before it raises ``Preempted`` and at the end
of :meth:`Trainer.train`.
"""

from __future__ import annotations

import copy
import itertools
import logging
import time
import typing as t

import numpy as np
import torch

from torch_actor_critic_tpu_torch.buffer.replay import (
    init_replay_buffer,
    init_visual_replay_buffer,
    push,
    warn_if_buffer_exceeds_hbm,
)
from torch_actor_critic_tpu_torch.core.types import Batch, MultiObservation, tree_map
from torch_actor_critic_tpu_torch.envs.vec_env import make_env_pool, stack_obs
from torch_actor_critic_tpu_torch.models import build_models
from torch_actor_critic_tpu_torch.parallel.population import PopulationLearner
from torch_actor_critic_tpu_torch.resilience.preemption import Preempted, PreemptionGuard
from torch_actor_critic_tpu_torch.resilience.sentinel import (
    DivergenceSentinel,
    TrainingDiverged,
)
from torch_actor_critic_tpu_torch.sac.algorithm import SAC, Burst, Learner, Metrics
from torch_actor_critic_tpu_torch.sac.population import make_population_learner
from torch_actor_critic_tpu_torch.td3 import TD3
from torch_actor_critic_tpu_torch.utils.config import SACConfig
from torch_actor_critic_tpu_torch.utils.device import resolve_device
from torch_actor_critic_tpu_torch.utils.normalize import (
    FeaturesNormalizer,
    IdentityNormalizer,
    PerMemberNormalizer,
    WelfordNormalizer,
)

logger = logging.getLogger(__name__)

# SACConfig fields whose non-default values select machinery this slice
# does not port. (Fields that only parameterise one of these, such as
# staging_policy under decoupled, are inert without it, as in JAX.)
NOT_PORTED = (
    "population",
    "pbt_every", "ma_critic", "task_embed_dim",
    "decoupled", "serve_url", "actors",
    "elastic", "replay_tiers", "replay_refill", "offline", "telemetry",
    "diagnostics", "sanitize", "compile_cache", "emit_bundle", "obs",
    "obs_scrape", "slo_config",
)


# What the fused population (sac/ondevice.py) ports of NOT_PORTED; the
# host trainer's population allows the first.
POPULATION_FIELDS = ("population", "pbt_every")


def check_ported(config: SACConfig, allow: t.Sequence[str] = ()) -> None:
    """Raise ``NotImplementedError`` naming the first non-default field
    of :data:`NOT_PORTED` not in ``allow`` (the fused population's
    entry point allows :data:`POPULATION_FIELDS`, the host trainer
    ``population``)."""
    defaults = SACConfig()
    for name in NOT_PORTED:
        value = getattr(config, name)
        if name in allow or value == getattr(defaults, name):
            continue
        if name == "pbt_every":
            raise NotImplementedError(
                f"SACConfig.pbt_every={value!r}: PBT exploit/explore runs in-graph over the "
                "fused population loop (on_device=True, --on-device true); the host-loop "
                "population trains N fixed-hyperparam seeds"
            )
        raise NotImplementedError(
            f"SACConfig.{name}={value!r} is not ported yet (default "
            f"{getattr(defaults, name)!r})"
        )


def save_metrics(checkpointer, t_save: float, saved: bool) -> dict:
    """An epoch's checkpoint seconds, from ``t_save`` (``perf_counter``
    before the save): ``save_s``, the training thread's time in ``save``
    less its wait for the write before (the host copies; before saves
    were asynchronous, ``save_s`` included the write);
    ``save_wait_s``, that wait for the background write; and
    ``save_write_s``, the newest finished write's seconds (absent until
    one has finished)."""
    wait = checkpointer.last_wait_s if saved else 0.0
    out = {"save_s": round(time.perf_counter() - t_save - wait, 4),
           "save_wait_s": round(wait, 4)}
    if checkpointer.last_write_s is not None:
        out["save_write_s"] = round(checkpointer.last_write_s, 4)
    return out


def make_learner(config: SACConfig, act_dim: int) -> Learner:
    """The one algorithm dispatch, as the JAX trainer's: ``config.algorithm``
    picks :class:`~..td3.TD3` or :class:`~.algorithm.SAC`."""
    if config.algorithm == "td3":
        return TD3(config, act_dim)
    return SAC(config, act_dim)


class Trainer:
    """SAC or TD3 on one device with one host env, or with one env per
    member of a ``population``. Per-run seeds: model init from ``seed``
    (a population's member ``i`` from ``member_seed(seed, i)``), the
    learner's generator from ``seed + 1``, acting from ``seed + 2``; env
    ``i`` at epoch ``e`` resets with :meth:`_epoch_seed`."""

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
        check_ported(self.config, allow=("population",))
        self.device = resolve_device(device)
        self.env_name = env_name
        self.seed = seed
        self.tracker = tracker
        self.checkpointer = checkpointer
        cfg = self.config
        # One env per population member (env i is member i).
        self.population = cfg.population
        pool_name = (
            f"{env_name}|history:{cfg.history_len}" if cfg.history_len > 1 else env_name
        )
        self.pool = make_env_pool(pool_name, self.population, base_seed=seed,
                                  parallel=cfg.parallel_envs, seed_stride=10000,
                                  timeout_s=cfg.env_timeout_s,
                                  start_method=cfg.env_start_method)
        spec = self.pool.obs_spec
        obs_shape = (
            spec.map(lambda leaf: tuple(leaf.shape))
            if isinstance(spec, MultiObservation) else tuple(spec.shape)
        )
        self.obs_shape = obs_shape
        visual = isinstance(spec, MultiObservation)
        flat = not visual and len(spec.shape) == 1
        if cfg.normalize_observations and flat and self.population > 1:
            # One estimate per member: pooling would couple the members
            # through their input scaling.
            self.normalizer = PerMemberNormalizer(self.population, spec.shape[0])
        elif cfg.normalize_observations and flat:
            self.normalizer = WelfordNormalizer(spec.shape[0])
        elif cfg.normalize_observations and self.population > 1:
            logger.warning(
                "normalize_observations=True ignored for population > 1 with obs spec %s: "
                "only flat observations have a per-member normalizer; running unnormalized",
                obs_shape,
            )
            self.normalizer = IdentityNormalizer()
        elif cfg.normalize_observations and visual:
            self.normalizer = FeaturesNormalizer(spec.features.shape[0])
        else:
            # History stacks run unnormalized (windows replay PAST
            # observations; normalizing them with later statistics leaks).
            if cfg.normalize_observations:
                logger.warning(
                    "normalize_observations=True ignored: obs spec %s is a history "
                    "stack, which runs unnormalized", tuple(spec.shape),
                )
            self.normalizer = IdentityNormalizer()
        act_dim = self.pool.act_dim
        self.dp: PopulationLearner | None = None
        if self.population > 1:
            self.sac = make_population_learner(cfg, act_dim, self.population)
            self.dp = PopulationLearner(self.sac, self.population)
            self.state = self.dp.init_state(seed, obs_shape, act_dim, self.pool.act_limit,
                                            self.device)
        else:
            self.sac = make_learner(cfg, act_dim)
            actor, critic = build_models(
                cfg, obs_shape, act_dim, self.pool.act_limit,
                generator=torch.Generator().manual_seed(seed),
            )
            self.state = self.sac.init_state(
                actor.to(self.device), critic.to(self.device),
                torch.Generator(device=self.device).manual_seed(seed + 1),
            )
        self._act_gen = torch.Generator(device=self.device).manual_seed(seed + 2)
        # actor_param_lag: the acting snapshot, stale until first refreshed;
        # on the card, the acting stream and the event behind each refresh.
        self._acting: torch.nn.Module | None = None
        self._acting_fresh = False
        self._act_stream = self._acting_ready = None
        self._pending: Burst | None = None  # a burst spread over the window
        if cfg.actor_param_lag:
            self._acting = copy.deepcopy(self.state.actor).requires_grad_(False)
            if self.device.type == "cuda":
                # High priority: an acting step's kernels go ahead of the
                # burst's waiting ones.
                self._act_stream = torch.cuda.Stream(self.device, priority=-1)
                self._acting_ready = torch.cuda.Event()
        if self.dp is not None:
            # Each member owns a full buffer_size ring (warned about at
            # buffer_size · P).
            self.buffer = self.dp.init_buffer(cfg.buffer_size, obs_shape, act_dim, self.device)
        else:
            warn_if_buffer_exceeds_hbm(cfg.buffer_size, obs_shape, act_dim, self.device,
                                       advice="reduce --buffer-size")
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

    def _epoch_seed(self, epoch: int, i: int = 0) -> int:
        """Env ``i``'s seed at the start of ``epoch``: a pure function of
        (run seed, epoch, env), as the JAX trainer's."""
        return self.seed + 1_000_003 * epoch + 10_000 * i

    def _normalize(self, x, update: bool, member: int) -> t.Any:
        """Env ``member``'s observation through the normalizer (its own
        statistics in a population)."""
        if self.population > 1:
            return self.normalizer.normalize(x, update=update, member=member)
        return self.normalizer.normalize(x, update=update)

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
        """Actions, one row per env, for a batch of the envs' observations
        (array or :class:`MultiObservation` of arrays); in a population
        member ``i`` acts on row ``i``. Under ``actor_param_lag`` through
        the acting snapshot (refreshed first if stale), on the card on
        the acting stream."""
        if self._acting is None:
            return self._act(self.state.actor, obs_batch, deterministic)
        if not self._acting_fresh:
            self._refresh_acting()
        if self._act_stream is None:
            return self._act(self._acting, obs_batch, deterministic)
        with torch.cuda.stream(self._act_stream):
            self._act_stream.wait_event(self._acting_ready)
            return self._act(self._acting, obs_batch, deterministic)

    def _act(self, actor: torch.nn.Module, obs_batch, deterministic: bool) -> np.ndarray:
        obs = tree_map(self._to_device, obs_batch)
        if self.dp is not None:
            action = self.dp.select_action(self.state, obs, self._act_gen, deterministic,
                                           actor=actor)
        else:
            action, _ = actor(
                obs, generator=None if deterministic else self._act_gen,
                deterministic=deterministic, with_logprob=False,
            )
        return action.cpu().numpy()

    def _burst(self, chunk: Batch, num_updates: int) -> Metrics | None:
        """A burst over the staged ``chunk``: under ``actor_param_lag``, on
        the card, one that only replays is spread over the next window
        (returns ``None``; :meth:`_finish_burst` takes it back); any other
        runs now (returns its metrics)."""
        if (self._acting is None or self.device.type != "cuda"
                or self.sac.would_capture(self.state, self.buffer, num_updates)):
            self.state, self.buffer, m = self.sac.update_burst(self.state, self.buffer, chunk,
                                                               num_updates)
            return m
        self._pending = self.sac.start_burst(self.state, self.buffer, chunk, num_updates)
        self._pending.advance()
        return None

    def _finish_burst(self) -> Metrics | None:
        """Enqueue what is left of the spread burst and take its state and
        ring; returns its metrics (``None`` without one)."""
        if self._pending is None:
            return None
        pending, self._pending = self._pending, None
        self.state, self.buffer, m = pending.finish()
        return m

    @torch.no_grad()
    def _refresh_acting(self) -> None:
        """``actor_param_lag``: copy the live actor's parameters and
        buffers into the acting snapshot on the main stream, once the
        acting stream's reads of it are done, and record the event the
        acting stream waits on."""
        if self._act_stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self._act_stream)
        live = self.state.actor
        for dst, src in zip(itertools.chain(self._acting.parameters(), self._acting.buffers()),
                            itertools.chain(live.parameters(), live.buffers()), strict=True):
            dst.copy_(src)
        if self._acting_ready is not None:
            self._acting_ready.record(torch.cuda.current_stream(self.device))
        self._acting_fresh = True

    def _place_chunk(self, staging: t.List[t.List[tuple]]) -> Batch:
        """Stack one window of each env's staged transitions into a chunk
        on the device, each leaf in its own dtype (frames uint8): ``(window,
        ...)`` leaves, a population's ``(P, window, ...)``."""

        def field(k):
            per_env = [stack_obs([tr[k] for tr in env_staging]) for env_staging in staging]
            return per_env[0] if self.dp is None else stack_obs(per_env)

        chunk = Batch(states=field(0), actions=field(1), rewards=field(2),
                      next_states=field(3), done=field(4))
        return chunk.map(self._to_device)

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
        self._finish_burst()
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
        self._acting_fresh = False  # the next acting step reads the restored actor
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
        n = self.population
        start_seed_epoch = self.start_epoch if cfg.epoch_reseed else 0
        obs = [self._normalize(self.pool.reset_at(i, seed=self._epoch_seed(start_seed_epoch, i)),
                               update=not counted, member=i) for i in range(n)]
        ep_ret, ep_len = [0.0] * n, [0] * n
        staging: t.List[t.List[tuple]] = [[] for _ in range(n)]
        last_metrics: dict = {}
        episode_rewards: list = []
        episode_lengths: list = []
        # A population's per-member returns: its P learning curves.
        member_rewards: t.List[list] = [[] for _ in range(n)]
        last_epoch = self.start_epoch + cfg.epochs - 1

        def take(m: Metrics | None) -> None:
            # A burst's losses: device scalars, read once at epoch end.
            if m is not None:
                losses_q.append(m["loss_q"])
                losses_pi.append(m["loss_pi"])

        t_epoch = time.time()
        for e in range(self.start_epoch, last_epoch + 1):
            losses_q: t.List[torch.Tensor] = []
            losses_pi: t.List[torch.Tensor] = []
            for t_ in range(cfg.steps_per_epoch):
                if step < cfg.start_steps:
                    actions = self.pool.sample_actions()
                else:
                    actions = self._policy_actions(stack_obs(obs))
                if self._pending is not None:
                    self._pending.advance()
                epoch_ended = t_ == cfg.steps_per_epoch - 1
                # One lockstep dispatch for every env; then each env's
                # bookkeeping, and a reset for each episode that ended.
                next_batch, rewards, terms, truncs = self.pool.step(actions)
                for i in range(n):
                    next_obs = self._normalize(tree_map(lambda x: x[i], next_batch),
                                               update=True, member=i)
                    reward = float(rewards[i])
                    terminated, truncated = bool(terms[i]), bool(truncs[i])
                    ep_len[i] += 1
                    ep_ret[i] += reward
                    # max_ep_len bypass: an episode cut by the length cap is
                    # a truncation, so the bootstrap is not zeroed.
                    hit_cap = ep_len[i] >= cfg.max_ep_len
                    done_for_buffer = np.float32(terminated and not hit_cap)
                    staging[i].append((obs[i], actions[i], np.float32(reward), next_obs,
                                       done_for_buffer))
                    if terminated or truncated or hit_cap or epoch_ended:
                        episode_rewards.append(float(ep_ret[i]))
                        episode_lengths.append(ep_len[i])
                        member_rewards[i].append(float(ep_ret[i]))
                        reset_seed = (self._epoch_seed(e + 1, i)
                                      if epoch_ended and cfg.epoch_reseed else None)
                        next_obs = self._normalize(self.pool.reset_at(i, seed=reset_seed),
                                                   update=True, member=i)
                        ep_ret[i], ep_len[i] = 0.0, 0
                    obs[i] = next_obs

                window_full = (step + 1) % cfg.update_every == 0
                if window_full:
                    chunk = self._place_chunk(staging)
                    for env_staging in staging:
                        del env_staging[:]
                    take(self._finish_burst())
                    if step > cfg.update_after:
                        if self._acting is not None and step + 1 >= cfg.start_steps:
                            # The next window acts on these pre-burst
                            # parameters while the burst runs.
                            self._refresh_acting()
                        take(self._burst(chunk, cfg.updates_per_window))
                    else:
                        self.buffer = push(self.buffer, chunk)
                step += 1

                # Urgent preemption (a second signal): the window boundary
                # is the safe step boundary (staging just flushed, the burst
                # done), so save now and unwind. The learner state is
                # lossless; the epoch's un-stepped env tail is skipped on
                # resume.
                if window_full and self.preemption is not None and self.preemption.urgent:
                    take(self._finish_burst())
                    if self.checkpointer is not None:
                        self._synchronize()
                        self._save_checkpoint(e, step)
                        self.checkpointer.wait()
                    raise Preempted(epoch=e, urgent=True)

            take(self._finish_burst())
            self._synchronize()
            dt = time.time() - t_epoch
            # Every member's updates count.
            grad_steps = len(losses_q) * cfg.updates_per_window * self.population
            rew = np.asarray(episode_rewards, np.float64)
            last_metrics = {
                "episode_length": float(np.mean(episode_lengths)) if episode_lengths else 0.0,
                "reward": float(rew.mean()) if rew.size else 0.0,
                "reward_std": float(rew.std()) if rew.size else 0.0,
                "reward_min": float(rew.min()) if rew.size else 0.0,
                "reward_max": float(rew.max()) if rew.size else 0.0,
                "loss_q": float(torch.stack(losses_q).mean()) if losses_q else 0.0,
                "loss_pi": float(torch.stack(losses_pi).mean()) if losses_pi else 0.0,
                "env_steps_per_sec": cfg.steps_per_epoch * n / dt,  # every env's steps
                "grad_steps_per_sec": grad_steps / dt,
            }
            if self.population > 1:
                # Per-member epoch-mean returns: the P learning curves.
                for i, rewards in enumerate(member_rewards):
                    if rewards:
                        last_metrics[f"reward_m{i}"] = float(np.mean(rewards))
                member_rewards = [[] for _ in range(n)]
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
            if self.checkpointer is not None:
                last_metrics.update(save_metrics(self.checkpointer, t_save, saved_this_epoch))
            else:
                last_metrics["save_s"] = round(time.perf_counter() - t_save, 4)
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
        for the evaluation (then restored). A population evaluates every
        member (:meth:`_evaluate_population`)."""
        saved = self._act_gen
        # Evaluation acts on the current parameters, also under the lag.
        self._finish_burst()
        self._acting_fresh = False
        if seed is not None:
            self._act_gen = torch.Generator(device=self.device).manual_seed(seed)
        try:
            if self.dp is not None:
                return self._evaluate_population(episodes, deterministic, seed)
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

    def _evaluate_population(self, episodes: int, deterministic: bool,
                             seed: int | None) -> dict:
        """Member ``i``'s policy rolls out ``episodes`` episodes on env
        ``i``; episode ``j`` resets every member's env with ``seed + j``
        (the same env realizations across members, so their differences
        measure the policies). A finished member's row stays in the
        batch and its action is dropped. Returns the aggregate stats and
        ``per_member`` mean/std, as the JAX trainer's."""
        n = self.population
        member_returns: t.List[list] = [[] for _ in range(n)]
        member_lengths: t.List[list] = [[] for _ in range(n)]
        obs = [self._normalize(self.pool.reset_at(i, seed=seed), update=False, member=i)
               for i in range(n)]
        rets, lens, ep_idx = [0.0] * n, [0] * n, [0] * n
        while any(idx < episodes for idx in ep_idx):
            actions = self._policy_actions(stack_obs(obs), deterministic)
            for i in range(n):
                if ep_idx[i] >= episodes:
                    continue
                o, r, terminated, truncated = self.pool.step_at(i, actions[i])
                obs[i] = self._normalize(o, update=False, member=i)
                rets[i] += r
                lens[i] += 1
                if terminated or truncated or lens[i] >= self.config.max_ep_len:
                    member_returns[i].append(rets[i])
                    member_lengths[i].append(lens[i])
                    ep_idx[i] += 1
                    if ep_idx[i] < episodes:
                        ep_seed = None if seed is None else seed + ep_idx[i]
                        obs[i] = self._normalize(self.pool.reset_at(i, seed=ep_seed),
                                                 update=False, member=i)
                        rets[i], lens[i] = 0.0, 0
        all_returns = [r for m in member_returns for r in m]
        all_lengths = [x for m in member_lengths for x in m]
        return {
            "ep_ret_mean": float(np.mean(all_returns)),
            "ep_ret_std": float(np.std(all_returns)),
            "ep_len_mean": float(np.mean(all_lengths)),
            "per_member": [{"ep_ret_mean": float(np.mean(m)), "ep_ret_std": float(np.std(m))}
                           for m in member_returns],
        }

    def close(self) -> None:
        self.pool.close()

