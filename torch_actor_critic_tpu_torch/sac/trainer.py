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
its next replays before it acts, at most a couple queued on the device
at a time, so the acting kernels run beside them and an acting step
waits for one replay, not for the whole burst queued ahead of it (nor
is the host held by a full launch queue, which JAX's asynchronous
dispatch never is). The window's boundary enqueues what is
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

Rendering (``render=True``, JAX's ``render``) is decided once, at
construction: envs that render through their own no-op paths (dm_control,
the wall-runner, the pixel pendulums, the numpy pendulum) render; a
gymnasium env is built with ``render_mode="human"`` when a display is
there (gymnasium draws only in a mode set at construction) and otherwise
runs headless with a warning. ``train(render=True)`` renders env 0 after
each lockstep step, ``evaluate(render=True)`` each evaluated env after its
step. Fixed-temperature SAC on a dm_control env warns, as JAX's does:
its [0, 1] rewards are swamped by the entropy bonus.

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

Observability (JAX's ``telemetry``/``diagnostics``, at any population).
With a
:class:`~..telemetry.recorder.TelemetryRecorder` (built by
``TelemetryRecorder.for_run`` for ``telemetry=True``, a
``profile_epochs`` window or a ``trace_export`` path) the loop
laps its eight phases (``act``, ``env_step``, ``stage``,
``place_chunk``, ``burst_dispatch`` — the host's enqueue of the burst —,
``drain`` — the epoch's wait for the device and its one read —,
``sentinel``, ``checkpoint``) into ``telemetry.jsonl`` with the epoch's
device-memory watermarks, and the first update is counted into the cost
registry (``train/update``; the burst's cost is ``updates_per_window``
of it), so each update epoch adds ``cost/update_burst_*`` metrics and a
``cost`` event (MFU against the card's peak at ``compute_dtype``). With
a ``diagnostics`` tier each burst's metric rows (the in-graph
diagnostics and the aux metrics) stay on the device and are read once
at the epoch's end, in the same transfer as the losses; the epoch's
reduction lands in the metrics (``diag/*``), the |TD| histogram
(``full``) is merged into a ``FixedBucketHistogram``, an
:class:`~..diagnostics.monitor.EarlyWarningMonitor` turns the stream
into ``early_warning`` events that feed the sentinel's
``note_warning``, and the process's watchdog counts CUDA-graph captures
and kernel builds (``watchdog_captures``, ``watchdog_live_captures``,
``watchdog_builds``), marking ``train/`` steady one epoch after the
first update epoch, so a later capture is a ``recompile_anomaly`` event.
With telemetry and diagnostics off none of this runs. A population runs
all of it as one learner does: its one stacked update is the counted
one (every member's work), each burst's rows hold ``(P,)`` values (one
per member, as JAX's ``vmap`` of the solo burst gives them), and the
epoch's :func:`~..diagnostics.ingraph.reduce_metric_rows` reduces over
the bursts and the members, as JAX's does: ``diag/grad_norm_q`` is the
mean of the members' own norms. There are no per-member ``diag/*``
columns (nor in JAX); the members' curves are the ``reward_m{i}``.

The run-wide obs plane (JAX's ``obs``, ``obs_scrape``, ``slo_config``;
the host trainer, at any population): an
:class:`~..obs.collector.ObsCollector`, started at :meth:`Trainer.train`
and closed by :meth:`Trainer.close`, scrapes a ``learner`` source (the
telemetry snapshot and the last epoch's numeric columns) and any
``name=url`` extras every ``obs_interval_s`` into ``<run>/obs.jsonl``,
evaluates the SLO rules (``slo_breach``/``slo_recovered`` events go to
``telemetry.jsonl`` too) and mirrors its ``obs/`` columns into each
epoch's metrics (a population's ``reward_m{i}`` among them). The fused
loop refuses it: JAX's builds no collector there.

Tiered replay (JAX's ``replay_tiers``/``replay_refill``, the solo
trainer only; the config refuses a population and ``on_device``, as
JAX's does): :func:`~..replay.build_tiered_replay` builds a host shadow
of the device ring, the host tier and, with ``"disk"``, the disk tier.
Every staged window is ingested on the host (the shadow sees the ring's
pushes in the ring's order), rows the ring overwrites spill down the
tiers, and with ``replay_refill > 0`` a
:class:`~..replay.RefillPrefetcher` chunk of host rows is pushed into
the ring in place after each window's burst (a burst spread over the
next window under ``actor_param_lag`` takes it when it finishes, so the
push is ordered after its last replay; a captured burst graph reads the
same tensors, so nothing recaptures). Each epoch adds the ``replay/*``
columns and, with telemetry, one ``replay`` event; the checkpoint meta
holds the tiers' counters (``replay_tiers``), and a restore moves the
resident host rows to ``dropped_restart``. With ``replay_tiers="off"``
none of it exists.

The decoupled actor/learner plane (:mod:`..decoupled`: ``decoupled``,
``serve_url``, ``actors``, ``elastic``) is a subclass over this loop's
seams, as in JAX: ``_stage`` and ``_drain_window`` (a ``None`` window
skips the boundary's device work), ``_epoch_boundary_hook`` (after the
save, before the metrics are logged), ``_checkpoint_arrays`` /
``_checkpoint_abstract_arrays`` / ``_restore_extras`` (``arrays.pt``
and the meta), ``publish_params`` (a snapshot of the actor for the
serving plane), ``metrics_snapshot`` and ``extra_trace_events``. The
lockstep trainer's own seams keep it as it was, bitwise.

Config fields this slice does not implement raise
``NotImplementedError`` naming the field when they are not at their
defaults (:data:`NOT_PORTED`); ``pbt_every`` raises here (PBT runs over
the fused population). ``on_device`` selects the fused loop
(:mod:`.ondevice`) in the train CLI; the host trainer ignores it, as
JAX's does.

Cold start (:mod:`~..aot`): ``emit_bundle`` writes a warm-start bundle
next to the checkpoints (``<run>/artifacts/warm_start``) once, at the
first epoch with updates, from the actor's weights then (one solo
learner; a population's members are served one at a time and get
none); a failed build is logged and training goes on, as JAX's does.
``compile_cache`` (armed by the train CLI before the trainer is built)
also installs the watchdog, so every epoch reports ``watchdog_builds``,
``watchdog_cache_hits``, ``watchdog_cache_misses``,
``watchdog_bundle_hits`` and ``watchdog_bundle_rejected`` (a diagnostics
tier reports them too).

Checkpoints are written asynchronously (:meth:`~..utils.checkpoint.
Checkpointer.save`); the trainer waits for the write in flight before
any restore or rollback, before it raises ``Preempted`` and at the end
of :meth:`Trainer.train`.
"""

from __future__ import annotations

import copy
import itertools
import logging
import os
import sys
import time
import typing as t

import numpy as np
import torch

from torch_actor_critic_tpu_torch.buffer.replay import (
    init_replay_buffer,
    init_visual_replay_buffer,
    nbytes,
    push,
    warn_if_buffer_exceeds_hbm,
)
from torch_actor_critic_tpu_torch.core.types import Batch, MultiObservation, tree_map
from torch_actor_critic_tpu_torch.diagnostics.ingraph import (
    host_read,
    make_td_histogram,
    reduce_metric_rows,
)
from torch_actor_critic_tpu_torch.diagnostics.monitor import EarlyWarningMonitor
from torch_actor_critic_tpu_torch.diagnostics.watchdog import get_watchdog
from torch_actor_critic_tpu_torch.envs.vec_env import make_env_pool, stack_obs
from torch_actor_critic_tpu_torch.envs.wrappers import is_dm_env, renders_itself
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
from torch_actor_critic_tpu_torch.telemetry.costmodel import (
    Peaks,
    get_cost_registry,
    roofline,
    roofline_metrics,
)
from torch_actor_critic_tpu_torch.telemetry.recorder import (
    PH_ACT,
    PH_BURST,
    PH_CKPT,
    PH_DRAIN,
    PH_ENV,
    PH_PLACE,
    PH_SENTINEL,
    PH_STAGE,
    TelemetryRecorder,
)
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
# obs_interval_s under obs, are inert without it, as in JAX.)
NOT_PORTED = (
    "population",
    "pbt_every", "ma_critic", "task_embed_dim",
    "telemetry",
    "diagnostics", "sanitize", "obs", "obs_scrape", "slo_config",
)


# What the fused population (sac/ondevice.py) ports of NOT_PORTED; the
# host trainer's population allows the first.
POPULATION_FIELDS = ("population", "pbt_every")
# Telemetry and the diagnostics tiers: every trainer ports them, at any
# population (the fused population runs its diagnostics at "off", as
# JAX's does).
TELEMETRY_FIELDS = ("telemetry", "diagnostics")
# The run-wide obs plane: the host trainer ports it at any population;
# the fused loop refuses it (JAX's builds no collector).
OBS_FIELDS = ("obs", "obs_scrape", "slo_config")


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
        if name in OBS_FIELDS:
            raise NotImplementedError(
                f"SACConfig.{name}={value!r} on the fused on-device loop: the run-wide obs "
                "plane runs on the host trainer, the solo host trainer and a host population "
                "alike (the JAX package's fused loop builds no collector either)")
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


# The cost registry's names of one update and of one burst of them.
UPDATE_COST, BURST_COST = "train/update", "train/update_burst"


def epoch_fetch(losses_q: t.List[torch.Tensor], losses_pi: t.List[torch.Tensor],
                rows: t.List[Metrics]) -> t.Tuple[float, float, t.List[dict]]:
    """The epoch's one device-to-host read (:func:`~..diagnostics.ingraph.
    host_read`): the bursts' mean ``loss_q`` and ``loss_pi`` (f32 means on
    the device) and every burst's metric rows (``rows``, each a dict of
    device tensors). Returns the two means (0.0 without bursts) and the
    rows as host numpy arrays."""
    if not losses_q:
        return 0.0, 0.0, []
    host = host_read({"loss_q": torch.stack(losses_q).mean(),
                      "loss_pi": torch.stack(losses_pi).mean(),
                      **{k: torch.stack([r[k] for r in rows]) for k in (rows[0] if rows else ())}})
    loss_q, loss_pi = float(host.pop("loss_q")), float(host.pop("loss_pi"))
    return loss_q, loss_pi, [{k: v[i] for k, v in host.items()} for i in range(len(rows))]


def ring_leaf(x) -> np.ndarray:
    """A host leaf in its ring dtype: uint8 frames stay uint8, the rest
    float32."""
    x = np.asarray(x)
    return x if x.dtype == np.uint8 else x.astype(np.float32)


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
        profile_epochs: t.Optional[t.Tuple[int, int]] = None,
        trace_export: str | None = None,
        env_kwargs: dict | None = None,
        render: bool = False,
    ):
        self.config = config or SACConfig()
        check_ported(self.config, allow=("population",) + TELEMETRY_FIELDS + OBS_FIELDS)
        self.device = resolve_device(device)
        self.env_name = env_name
        self.seed = seed
        self._render_ok = False
        if render:
            if renders_itself(env_name):
                self._render_ok = True
            elif os.environ.get("DISPLAY") or sys.platform == "darwin":
                env_kwargs = {**(env_kwargs or {}), "render_mode": "human"}
                self._render_ok = True
            else:
                logger.warning(
                    "rendering requested but no display is available; running headless")
        if self.config.algorithm == "sac" and not self.config.learn_alpha and is_dm_env(env_name):
            # dm_control pays [0, 1] a step; the fixed alpha=0.2 entropy
            # bonus is of that order and swamps it.
            logger.warning(
                "%s pays dm_control-scale rewards ([0, 1] per step) and SAC is running with "
                "a FIXED entropy temperature alpha=%g; the entropy bonus is likely to swamp "
                "the reward signal (measured: eval 0.6 vs 310.4 on dm:cheetah:run at 100k "
                "steps). Pass --learn-alpha true to tune the temperature automatically.",
                env_name, self.config.alpha,
            )
        self.tracker = tracker
        self.checkpointer = checkpointer
        cfg = self.config
        # One env per population member (env i is member i).
        self.population = cfg.population
        pool_name = (
            f"{env_name}|history:{cfg.history_len}" if cfg.history_len > 1 else env_name
        )
        self.pool_name = pool_name  # the env with its history stack, as actors make it
        self.pool = make_env_pool(pool_name, self.population, base_seed=seed,
                                  parallel=cfg.parallel_envs, seed_stride=10000,
                                  timeout_s=cfg.env_timeout_s,
                                  start_method=cfg.env_start_method, env_kwargs=env_kwargs)
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
        # Tiered replay: the device ring's host shadow, the host and disk
        # tiers and the refill (None when off: the loop is then exactly
        # the trainer without tiers).
        self.tiered = self._prefetcher = None
        self._refill_due = False
        if cfg.replay_tiers != "off":
            from torch_actor_critic_tpu_torch.replay import (
                RefillPrefetcher,
                build_tiered_replay,
            )

            self.tiered = build_tiered_replay(
                cfg, spec, act_dim, hbm_capacity=self.buffer.capacity,
                act_limit=float(self.pool.act_limit),
                run_dir=(str(tracker.run_dir)
                         if tracker is not None and tracker.enabled else None),
                seed=seed,
            )
            if cfg.replay_refill > 0:
                self._prefetcher = RefillPrefetcher(
                    self.tiered, self.population, cfg.replay_refill,
                    async_prefetch=cfg.replay_prefetch)
        self.start_epoch = 0
        # The epoch the loop is in (the decoupled staging gate's staleness
        # reference).
        self._epoch = 0
        self._resume_step: int | None = None
        self.sentinel = DivergenceSentinel(cfg.max_rollbacks) if cfg.sentinel else None
        self.preemption = preemption
        # Observability: None when off, and then the loop's only cost is
        # one `rec is not None` check per phase mark.
        self.telemetry = telemetry = TelemetryRecorder.for_run(
            cfg, tracker, profile_epochs, trace_export, self.device)
        if telemetry is not None:
            self.sac.cost.request(UPDATE_COST)
        self._peaks: Peaks | None = None
        if cfg.diagnostics != "off":
            self.monitor = EarlyWarningMonitor()
            self.td_hist = make_td_histogram()
        else:
            self.monitor = self.td_hist = None
        self.watchdog = None
        if cfg.diagnostics != "off" or cfg.compile_cache:
            self.watchdog = get_watchdog().install()
            self._wd_anomalies_seen = len(self.watchdog.snapshot()["anomalies"])
        self._bundle_emitted = not cfg.emit_bundle
        self._first_update_epoch: int | None = None
        # The run-wide obs plane: built here, started at train() entry,
        # None when off (no thread, no socket, no obs/ metric keys).
        self.obs = None
        self._obs_last_metrics: t.Dict[str, t.Any] = {}
        if cfg.obs:
            from torch_actor_critic_tpu_torch.obs import ObsCollector, load_rules

            self.obs = ObsCollector(
                interval_s=cfg.obs_interval_s,
                run_dir=tracker.run_dir if tracker is not None and tracker.enabled else None,
                port=cfg.obs_port,
                rules=load_rules(cfg.slo_config) if cfg.slo_config else None,
                telemetry=self.telemetry,
                max_bytes=int(cfg.telemetry_max_mb * 1e6),
            )
            self.obs.add_source("learner", self._obs_learner_source)
            for pair in filter(None, cfg.obs_scrape.split(",")):
                name, _, url = pair.partition("=")
                self.obs.add_source(name.strip(), url.strip())

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
        x = torch.from_numpy(ring_leaf(x))
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
        ring, then push the window's refill if one is due (ordered after
        the burst's last replay); returns the burst's metrics (``None``
        without one)."""
        m = None
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self.state, self.buffer, m = pending.finish()
        if self._refill_due:
            self._refill_due = False
            self._refill()
        return m

    def _refill(self) -> None:
        """Host → device refill: the prefetcher's next chunk (if one is
        ready) pushed into the ring in place, its rows re-entering the
        waterfall as the shadow's next push."""
        local = self._prefetcher.poll_local_chunk()
        if local is None:
            return
        from torch_actor_critic_tpu_torch.replay import batch_to_rows

        rows = batch_to_rows(local, n_lead=2)
        self.buffer = self._prefetcher.push_into(self.buffer, rows)
        self.tiered.note_refill(rows)

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

    @torch.no_grad()
    def publish_params(self) -> t.Dict[str, torch.Tensor]:
        """A snapshot of the actor's parameters and buffers for the serving
        plane (JAX's ``_fetch_params_single_transfer``): fresh tensors in a
        new mapping, cloned on the learner's stream, so a later burst, which
        writes the live ones in place, never reaches what was published. The
        caller takes it after :meth:`_finish_burst`."""
        return {k: v.detach().clone() for k, v in self.state.actor.state_dict().items()}

    # Staging seams (the decoupled learner overrides them: its staging is
    # a bounded StagingBuffer with backpressure and a staleness gate).
    # The lockstep trainer appends each env's transition to its list and
    # drains exactly one full window at every window boundary.

    def _stage(self, staging: t.List[t.List[tuple]], transitions: t.List[tuple]) -> None:
        """Admit one lockstep step's transitions, one per env."""
        for env_staging, tr in zip(staging, transitions, strict=True):
            env_staging.append(tr)

    def _drain_window(self, staging: t.List[t.List[tuple]]) -> Batch | None:
        """One update window as a host chunk, or ``None`` to skip this
        window boundary's device work (the decoupled gate may leave less
        than a window; the chunk's shape, and so the burst's graph, never
        varies). The lockstep trainer always has exactly one window."""
        chunk = self._stage_chunk(staging)
        for env_staging in staging:
            del env_staging[:]
        return chunk

    def _stage_chunk(self, staging: t.List[t.List[tuple]]) -> Batch:
        """Stack one window of each env's staged transitions into a host
        chunk, each leaf in its own dtype (frames uint8): ``(window, ...)``
        leaves, a population's ``(P, window, ...)``;
        ``chunk.map(self._to_device)`` places it on the device."""

        def field(k):
            per_env = [stack_obs([tr[k] for tr in env_staging]) for env_staging in staging]
            return per_env[0] if self.dp is None else stack_obs(per_env)

        return Batch(states=field(0), actions=field(1), rewards=field(2),
                     next_states=field(3), done=field(4))

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
            # The tiers' counters only: the disk tier persists itself, and
            # the host rows are declared lost (dropped_restart) at restore.
            **({"replay_tiers": self.tiered.meta_state()} if self.tiered is not None else {}),
        }

    def _checkpoint_arrays(self) -> t.Mapping[str, t.Any] | None:
        """Named objects for the checkpoint's ``arrays.pt`` (the decoupled
        learner's staged but undrained transitions); ``None`` = none."""
        return None

    def _checkpoint_abstract_arrays(self, meta_probe: dict) -> t.Mapping[str, t.Any] | None:
        """The live objects :meth:`_checkpoint_arrays` named, sized from the
        checkpoint's meta, to restore ``arrays.pt`` into; ``None`` = none."""
        return None

    def _restore_extras(self, meta: dict, arrays: t.Mapping[str, t.Any] | None) -> None:
        """Apply what a subclass saved beyond the base trainer's state
        (the decoupled learner's staging, publish counters and serving
        generator)."""

    def _emit_warm_start_bundle(self, epoch: int) -> None:
        """``emit_bundle``: build the warm-start bundle next to the
        checkpoints (:func:`~..aot.bundle.emit_bundle`) from the actor's
        weights now, once. Non-fatal: a failed build is logged and never
        retried, and the checkpoint is untouched either way."""
        self._bundle_emitted = True
        if self.checkpointer is None:
            return
        if self.population > 1:
            logger.warning("emit_bundle: a population's members are served one at a time "
                           "(run_agent --member exports one); no bundle is written")
            return
        from torch_actor_critic_tpu_torch.aot.bundle import default_bundle_dir, emit_bundle
        from torch_actor_critic_tpu_torch.models import build_actor

        try:
            actor_def = build_actor(self.config, self.obs_shape, self.pool.act_dim,
                                    self.pool.act_limit)
            params = {k: v.detach().clone() for k, v in self.state.actor.state_dict().items()}
            bundle = emit_bundle(self.checkpointer.directory, actor_def, self.pool.obs_spec,
                                 params, max_batch=self.config.bundle_max_batch,
                                 device=self.device)
            logger.info("epoch %d: warm-start bundle emitted at %s (%d programs, %d "
                        "libraries): serve --warm-start auto builds no kernel", epoch,
                        bundle.root, len(bundle.programs()), len(bundle.libraries()))
        except Exception:  # noqa: BLE001 — the bundle is an artifact, not training state
            logger.exception("epoch %d: warm-start bundle at %s failed; training continues "
                             "(serve workers will resolve their kernels from the cache or "
                             "nvcc)", epoch, default_bundle_dir(self.checkpointer.directory))

    def _save_checkpoint(self, epoch: int, step: int) -> None:
        self.checkpointer.save(epoch, self.state, self.buffer,
                               extra=self._checkpoint_extra(step),
                               arrays=self._checkpoint_arrays())

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
        abstract_arrays = self._checkpoint_abstract_arrays(meta_probe)
        self.state, buffer, meta, *arrays = self.checkpointer.restore(
            self.state, self.buffer if include_buffer else None, epoch=epoch,
            abstract_arrays=abstract_arrays)
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
        if self.tiered is not None and meta.get("replay_tiers"):
            self.tiered.load_meta(meta["replay_tiers"])
        self._restore_extras(meta, arrays[0] if arrays else None)
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

    def train(self, on_epoch: t.Callable[[int, dict], None] | None = None,
              render: bool = False) -> dict:
        """Run ``config.epochs`` epochs from ``start_epoch``; returns the
        last epoch's metrics. ``on_epoch(epoch, metrics)`` is called
        after each epoch. ``render`` renders env 0 after each lockstep
        step, where construction allowed it."""
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
        # Loop-local alias: each phase mark is one `is not None` check when off.
        rec = self.telemetry
        diag_rows: t.List[Metrics] = []
        if self.obs is not None:
            self.obs.start()

        def take(m: Metrics | None) -> None:
            # A burst's losses (and, with diagnostics, its other metric
            # rows): device tensors, read once at epoch end.
            if m is not None:
                losses_q.append(m["loss_q"])
                losses_pi.append(m["loss_pi"])
                if self.monitor is not None:
                    diag_rows.append({k: v for k, v in m.items()
                                      if k not in ("loss_q", "loss_pi")})

        t_epoch = time.time()
        for e in range(self.start_epoch, last_epoch + 1):
            self._epoch = e
            if rec is not None:
                rec.epoch_begin(e)
            losses_q: t.List[torch.Tensor] = []
            losses_pi: t.List[torch.Tensor] = []
            for t_ in range(cfg.steps_per_epoch):
                if self._pending is not None:
                    # Replays first: the acting step below then runs on its
                    # stream while they do.
                    self._pending.advance()
                    if rec is not None:
                        rec.lap(PH_BURST)
                if step < cfg.start_steps:
                    actions = self.pool.sample_actions()
                else:
                    actions = self._policy_actions(stack_obs(obs))
                if rec is not None:
                    rec.lap(PH_ACT)
                epoch_ended = t_ == cfg.steps_per_epoch - 1
                # One lockstep dispatch for every env; then each env's
                # bookkeeping, and a reset for each episode that ended.
                next_batch, rewards, terms, truncs = self.pool.step(actions)
                transitions = []
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
                    transitions.append((obs[i], actions[i], np.float32(reward), next_obs,
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
                self._stage(staging, transitions)
                if render and self._render_ok:
                    self.pool.render_at(0)
                if rec is not None:
                    rec.lap(PH_ENV)

                window_full = (step + 1) % cfg.update_every == 0
                host_chunk = None
                if window_full:
                    host_chunk = self._drain_window(staging)
                    if rec is not None:
                        rec.lap(PH_STAGE)
                # No chunk (the decoupled gate left less than a window): this
                # boundary's device work is skipped; staging keeps the rest.
                if host_chunk is not None:
                    chunk = host_chunk.map(self._to_device)
                    if rec is not None:
                        rec.lap(PH_PLACE)
                    take(self._finish_burst())
                    if self.tiered is not None:
                        # The shadow sees the ring's pushes in the ring's
                        # order: a refill due after the last burst went in
                        # just above, this chunk goes in next.
                        self.tiered.ingest_chunk(host_chunk.map(ring_leaf))
                    if step > cfg.update_after:
                        if self._acting is not None and step + 1 >= cfg.start_steps:
                            # The next window acts on these pre-burst
                            # parameters while the burst runs.
                            self._refresh_acting()
                        if rec is None:
                            take(self._burst(chunk, cfg.updates_per_window))
                        else:
                            with rec.annotate("train/update_burst"):
                                take(self._burst(chunk, cfg.updates_per_window))
                    else:
                        self.buffer = push(self.buffer, chunk)
                    if self._prefetcher is not None:
                        # Refill after the burst: a burst spread over the
                        # next window (actor_param_lag) takes it when it
                        # finishes, any other now.
                        self._refill_due = True
                        if self._pending is None:
                            self._finish_burst()
                    if rec is not None:
                        rec.lap(PH_BURST)
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
                    if rec is not None:
                        rec.event("preempted", epoch=e, urgent=True)
                    raise Preempted(epoch=e, urgent=True)

            take(self._finish_burst())
            self._synchronize()
            # The epoch's one read: the losses and the diagnostic rows.
            loss_q, loss_pi, host_rows = epoch_fetch(losses_q, losses_pi, diag_rows)
            diag_rows = []
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
                "loss_q": loss_q,
                "loss_pi": loss_pi,
                "env_steps_per_sec": cfg.steps_per_epoch * n / dt,  # every env's steps
                "grad_steps_per_sec": grad_steps / dt,
            }
            if self.tiered is not None:
                # Keys only with tiers on: the tiers' depths, flows and
                # conservation verdict, the refill's counters and the
                # ring's measured bytes.
                last_metrics.update(self.tiered.metrics())
                if self._prefetcher is not None:
                    last_metrics.update(self._prefetcher.metrics())
                last_metrics["replay/hbm_bytes"] = float(nbytes(self.buffer))
                if rec is not None:
                    rec.event("replay", epoch=e, **self.tiered.snapshot())
            if self.population > 1:
                # Per-member epoch-mean returns: the P learning curves.
                for i, rewards in enumerate(member_rewards):
                    if rewards:
                        last_metrics[f"reward_m{i}"] = float(np.mean(rewards))
                member_rewards = [[] for _ in range(n)]
            if self.monitor is not None:
                self._note_diagnostics(rec, last_metrics, host_rows, e)
            if self.watchdog is not None:
                self._note_watchdog(rec, last_metrics, e)
            if rec is not None:
                rec.lap(PH_DRAIN)
                self._note_epoch_cost(rec, last_metrics, len(losses_q), e)
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
                    if rec is not None:
                        rec.event("rollback", epoch=e, rolled_to=rolled_to)
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
            if rec is not None:
                rec.lap(PH_SENTINEL)

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
            if not self._bundle_emitted and losses_q:
                self._emit_warm_start_bundle(e)
            if rec is not None:
                rec.lap(PH_CKPT)
            # The decoupled learner publishes the epoch and adds its
            # staging metrics here (a no-op for the lockstep trainer).
            self._epoch_boundary_hook(e, sentinel_ok, saved_this_epoch, last_metrics, rec)
            # The obs plane's flat summary rides this epoch's row, and the
            # row goes back to the learner source (the paths SLO rules
            # address as learner.metrics.<key>).
            if self.obs is not None:
                last_metrics.update(self.obs.metrics_columns())
                self._obs_last_metrics = dict(last_metrics)
            if self.tracker is not None:
                self.tracker.log_metrics(last_metrics, e)
            if on_epoch is not None:
                on_epoch(e, dict(last_metrics))
            if rec is not None:
                env_steps = cfg.steps_per_epoch * n
                rec.inc("env_steps", env_steps)
                rec.inc("grad_steps", grad_steps)
                extra = {"step": step, "env_steps": env_steps, "grad_steps": grad_steps,
                         "env_steps_per_sec": round(last_metrics["env_steps_per_sec"], 2),
                         "saved": saved_this_epoch}
                if self.watchdog is not None:
                    extra["watchdog_captures"] = last_metrics["watchdog_captures"]
                ev = rec.epoch_end(e, extra=extra)
                attr = ev.get("attribution")
                if attr is not None:
                    logger.info("epoch %d attribution: %s (device %.0f%%, host %.0f%%, "
                                "input %.0f%%)", e, attr["class"],
                                100 * attr["device_busy_frac"], 100 * attr["host_frac"],
                                100 * attr["input_frac"])
            # Steady marking: the first update epoch captures the burst's
            # graph; one epoch later the regime is steady, and any later
            # capture under train/ is an anomaly.
            if self.watchdog is not None:
                if losses_q and self._first_update_epoch is None:
                    self._first_update_epoch = e
                elif self._first_update_epoch is not None and e > self._first_update_epoch:
                    self.watchdog.mark_steady("train/")

            # Graceful preemption (one signal): the epoch is complete and,
            # if it passed the sentinel, saved: the lossless exit point.
            if self.preemption is not None and self.preemption.triggered:
                if sentinel_ok and self.checkpointer is not None and not saved_this_epoch:
                    self._save_checkpoint(e, step)
                if self.checkpointer is not None:
                    self.checkpointer.wait()
                if rec is not None:
                    rec.event("preempted", epoch=e, urgent=False)
                raise Preempted(epoch=e)
            episode_rewards, episode_lengths = [], []
            t_epoch = time.time()
        if self.checkpointer is not None:
            self.checkpointer.wait()
        # One final window while the run is alive: a run shorter than the
        # scrape interval still ends with a row that saw its metrics.
        if self.obs is not None:
            self.obs.scrape_once()
        return last_metrics

    def _synchronize(self) -> None:
        """Wait for the device's queued work (bursts, pushes)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _epoch_boundary_hook(self, epoch: int, sentinel_ok: bool, saved: bool,
                             last_metrics: dict, rec) -> None:
        """Called once an epoch, after the sentinel and the save and before
        the metrics are logged (the decoupled learner publishes the epoch
        to its serving plane and adds its ``decoupled/*`` metrics)."""

    # ------------------------------------------------------ observability

    def metrics_snapshot(self) -> dict:
        """A ``/metrics``-mergeable view of planes beyond the learner (the
        decoupled staging and transport); empty for the lockstep trainer."""
        return {}

    def extra_trace_events(self) -> t.List[dict]:
        """Trace events beyond this process's recorder (the fleet's
        staging spans and actor span files), merged into the
        ``trace_export`` timeline at :meth:`close`."""
        return []

    def _obs_learner_source(self) -> dict:
        """The learner plane's snapshot for the obs collector: the
        telemetry snapshot, :meth:`metrics_snapshot` and the numeric
        columns of the last logged epoch (``learner.metrics.<key>`` to an
        SLO rule)."""
        out: t.Dict[str, t.Any] = {}
        if self.telemetry is not None:
            out["telemetry"] = self.telemetry.snapshot()
        out.update(self.metrics_snapshot())
        if self._obs_last_metrics:
            out["metrics"] = {k: v for k, v in self._obs_last_metrics.items()
                              if isinstance(v, (int, float, bool))}
        return out

    def _note_diagnostics(self, rec, last_metrics: dict, rows: t.List[dict], epoch: int) -> None:
        """The epoch's diagnostics (diagnostics tier on): the host rows
        reduced by suffix into the metrics, the |TD| counts merged into
        :attr:`td_hist` and the early-warning monitor (its warnings to
        the sentinel and to telemetry)."""
        if rows:
            reduced = reduce_metric_rows(rows)
            hist = reduced.pop("diag/td_hist", None)
            if hist is not None:
                self.td_hist.merge_counts(
                    hist, total=float(reduced.get("diag/td_abs_sum", 0.0)),
                    vmin=float(reduced.get("diag/td_abs_min", np.inf)),
                    vmax=float(reduced.get("diag/td_abs_max", 0.0)))
            for k, v in reduced.items():
                last_metrics[k] = float(v)
            for w in self.monitor.update(reduced):
                logger.warning("early warning %s: %s=%.4g vs baseline %.4g (deviation "
                               "envelope %.4g) — a leading indicator", w["kind"], w["key"],
                               w["value"], w["baseline"], w["spread"])
                if self.sentinel is not None:
                    self.sentinel.note_warning(w["kind"])
                if rec is not None:
                    rec.event("early_warning", epoch=epoch, **w)
            last_metrics["early_warnings"] = (self.sentinel.warnings_total
                                              if self.sentinel is not None
                                              else self.monitor.fired_total)
            if rec is not None:
                rec.event("diagnostics", epoch=epoch,
                          metrics={k: float(v) for k, v in reduced.items()},
                          td_hist=(self.td_hist.snapshot(prefix="td_abs_", unit="")
                                   if hist is not None else None))

    def _note_watchdog(self, rec, last_metrics: dict, epoch: int) -> None:
        """The watchdog's counts (captures, kernel builds, the library
        cache's hits and misses, the bundle's) and its new anomalies."""
        snap = self.watchdog.snapshot()
        last_metrics["watchdog_captures"] = snap["captures_total"]
        last_metrics["watchdog_live_captures"] = snap["live_captures"]
        last_metrics["watchdog_builds"] = snap["builds_total"]
        for key in ("cache_hits", "cache_misses"):
            last_metrics[f"watchdog_{key}"] = snap[f"{key}_total"]
        for key in ("bundle_hits", "bundle_rejected"):
            last_metrics[f"watchdog_{key}"] = snap[key]
        new = snap["anomalies"][self._wd_anomalies_seen:]
        self._wd_anomalies_seen = len(snap["anomalies"])
        if rec is not None:
            for a in new:
                rec.event("recompile_anomaly", epoch=epoch, **a)

    def _note_epoch_cost(self, rec, last_metrics: dict, n_bursts: int, epoch: int) -> None:
        """Per-epoch cost attribution (telemetry on): the burst's cost
        (``updates_per_window`` counted updates, registered as
        ``train/update_burst``) against the epoch's burst_dispatch + drain
        time; ``cost/update_burst_*`` metrics and one ``cost`` event."""
        registry = get_cost_registry()
        update = registry.get(UPDATE_COST)
        if n_bursts == 0 or update is None:
            return
        k = self.config.updates_per_window
        cost = {"flops": update["flops"] * k, "bytes_accessed": update["bytes_accessed"] * k}
        if registry.get(BURST_COST) != cost:
            registry.register(BURST_COST, cost)
        if self._peaks is None:
            self._peaks = Peaks.detect(self.config.compute_dtype)
        burst_s = rec.timer.sums[PH_BURST] + rec.timer.sums[PH_DRAIN]
        rl = roofline(cost, burst_s, calls=n_bursts, peaks=self._peaks,
                      compute_dtype=self.config.compute_dtype)
        last_metrics.update(roofline_metrics("update_burst", cost, rl))
        rec.event("cost", epoch=int(epoch), programs={BURST_COST: rl, UPDATE_COST: update},
                  device_kind=self._peaks.device_kind, compute_dtype=self.config.compute_dtype)

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
        self, episodes: int = 10, deterministic: bool = True, seed: int | None = None,
        render: bool = False,
    ) -> dict:
        """Rollouts of the current policy. Episode ``i`` resets with
        ``seed + i``, and the acting generator is re-seeded from ``seed``
        for the evaluation (then restored). A population evaluates every
        member (:meth:`_evaluate_population`). ``render`` renders each
        step, where construction allowed it."""
        render = render and self._render_ok
        saved = self._act_gen
        # Evaluation acts on the current parameters, also under the lag.
        self._finish_burst()
        self._acting_fresh = False
        if seed is not None:
            self._act_gen = torch.Generator(device=self.device).manual_seed(seed)
        try:
            if self.dp is not None:
                return self._evaluate_population(episodes, deterministic, seed, render)
            returns, lengths = [], []
            for i in range(episodes):
                obs = self.normalizer.normalize(
                    self.pool.reset_at(0, seed=None if seed is None else seed + i),
                    update=False)
                ret, length, done = 0.0, 0, False
                while not done:
                    action = self._policy_actions(stack_obs([obs]), deterministic)[0]
                    obs, reward, terminated, truncated = self.pool.step_at(0, action)
                    if render:
                        self.pool.render_at(0)
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
                             seed: int | None, render: bool = False) -> dict:
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
                if render:
                    self.pool.render_at(i)
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
        """Release the env pool and finish telemetry (flush the JSONL sink,
        stop a profiler trace left open); the steady regime of ``train/``
        belongs to this trainer's graphs, so it is cleared."""
        if self.watchdog is not None:
            self.watchdog.clear_steady("train/")
        if self._prefetcher is not None:
            self._prefetcher.close()
        if self.tiered is not None:
            self.tiered.close()
        if self.obs is not None:
            # One final window (a run shorter than the interval still
            # gets a row), then the run-exit SLO table.
            if self.obs.scrapes_total == 0:
                self.obs.scrape_once()
            self.obs.close()
            for line in self.obs.slo.report().splitlines():
                logger.info("%s", line)
        if self.telemetry is not None:
            if self.telemetry.trace_export is not None:
                self.telemetry.extra_events = self.extra_trace_events()
            self.telemetry.close()
        self.pool.close()

