"""The fused on-device loop (port of ``sac/ondevice.py``, one device):
env, replay and learner all on the card, so the host only launches and
reads one epoch's metrics.

``n_envs`` on-device twins (:mod:`..envs.ondevice`) step as one batch.
A window of ``update_every`` acting steps writes its transitions into a
preallocated chunk at a device counter (row ``t * n_envs + i``, the JAX
loop's order); the learner's :meth:`~.algorithm.Learner.update_burst`
then pushes the chunk and runs ``updates_per_window`` updates (the
captured update's replays, on the card). Warm-up windows act uniformly
and only push. Episode counts, returns and loss sums accumulate on the
device; nothing in an epoch reads a value back to the host.

On the card one acting step — the batch's policy sample (uniform in
warm-up), the twins' step, the transition's write at the counter and the
in-place update of the env states — is captured once per (state, env
states, warm-up flag) as a CUDA graph, with the acting and the env
generators registered, and replayed for every step of a window
(:class:`~.graph.BurstGraph`). The CPU, a test hook (``noise``,
``poses``, ``indices``, ``eps``, ``offsets``) or ``eager=True`` runs the
same step eagerly. The push stays outside the graph: it builds its
indices from the host cursor, which the host knows because a window's
chunk has a fixed size. A failed capture raises; nothing falls back.

A population (:class:`PopulationOnDeviceLoop`, ``--population N``) is
the same loop with the member axis in every tensor: ``N`` members'
member-stacked learner (:class:`~.population.PopulationSAC` or
:class:`~.population.PopulationTD3`), rings ``(N, capacity, ...)`` (a
pixel twin's frames uint8, gathered for every member by one K1 launch
over the member-folded ring), and one env batch of ``N·n_envs`` twins
(member ``i``'s envs are rows ``i·n_envs`` on), so one captured acting step and
one captured update advance every member; each attention layer is one
kernel launch for the whole population. Members share no state: a
member's draws are its slice of one population-wide draw (from the
learner's, the acting and the env generators), so no member's draws
depend on another member's state. With ``pbt_every > 0``, the members'
hyperparameters (``TrainState.hyperparams``, ``(N,)``) start jittered
and :meth:`PopulationOnDeviceLoop.pbt_step` runs the exploit/explore
step on the device, in place, into the tensors the graphs hold.

Not ported: the mesh (``mesh`` raises), the scenario loop, the
cost-model telemetry and the ``pbt`` telemetry events (they wait for the
telemetry module).
"""

from __future__ import annotations

import logging
import math
import time
import typing as t

import torch

from torch_actor_critic_tpu_torch.buffer.replay import (
    init_replay_buffer,
    init_visual_replay_buffer,
    push,
    warn_if_buffer_exceeds_hbm,
)
from torch_actor_critic_tpu_torch.core.types import (
    Batch,
    BufferState,
    MultiObservation,
    PBTState,
    TrainState,
    tree_map,
)
from torch_actor_critic_tpu_torch.diagnostics.ingraph import split_member_metrics
from torch_actor_critic_tpu_torch.envs.ondevice import (
    EnvState,
    get_on_device_env,
    history_env,
    known_on_device_envs,
)
from torch_actor_critic_tpu_torch.models import build_models
from torch_actor_critic_tpu_torch.models.population import build_population_models
from torch_actor_critic_tpu_torch.sac.algorithm import Learner
from torch_actor_critic_tpu_torch.sac.graph import BurstGraph, MetricStack
from torch_actor_critic_tpu_torch.sac.population import (
    make_population_learner,
    member_seed,
    member_tensors,
)
from torch_actor_critic_tpu_torch.sac.trainer import (
    POPULATION_FIELDS,
    check_ported,
    make_learner,
    save_metrics,
)
from torch_actor_critic_tpu_torch.utils.checkpoint import member_state_dict
from torch_actor_critic_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

Metrics = t.Dict[str, torch.Tensor]

# The acting step's per-step statistics among the stack's rows.
_STATS = ("episodes_sum", "return_sum")


def _env_obs_spec(env_cls):
    """The twin's observation shape as ``build_models`` takes it: a
    :class:`MultiObservation` of shapes for a pixel twin, else
    ``obs_shape`` (a history) or ``(obs_dim,)``."""
    if hasattr(env_cls, "obs_spec"):
        return env_cls.obs_spec()
    return tuple(getattr(env_cls, "obs_shape", (env_cls.obs_dim,)))


class _SpecView:
    """What ``build_models`` takes from an env, read off a twin class."""

    def __init__(self, env_cls):
        self.obs_shape = _env_obs_spec(env_cls)
        self.act_dim = env_cls.act_dim
        self.act_limit = env_cls.act_limit


def _wrap_and_build(env_cls, config) -> t.Tuple[t.Any, Learner]:
    """The twin, history-wrapped when ``config.history_len > 1``, and its
    learner (:func:`~.trainer.make_learner`: SAC or TD3)."""
    if config.history_len > 1:
        env_cls = history_env(env_cls, config.history_len)
    return env_cls, make_learner(config, env_cls.act_dim)


def warmup_steps(start_steps: int, update_every: int) -> int:
    """The policy-free steps per env: ``start_steps`` rounded down to an
    ``update_every`` multiple, at least one window."""
    return max(update_every, (start_steps // update_every) * update_every)


def _obs_rows(prefix: str, obs) -> t.Dict[str, torch.Tensor]:
    if isinstance(obs, MultiObservation):
        return {f"{prefix}.features": obs.features, f"{prefix}.frame": obs.frame}
    return {prefix: obs}


def window_chunk(rows: t.Mapping[str, torch.Tensor], members: int | None = None) -> Batch:
    """The window's transitions as one chunk: each ``(update_every,
    n_envs, ...)`` row stack flattened to row ``t * n_envs + i``; a
    population's ``(update_every, P, n_envs, ...)`` stacks to ``(P,
    update_every·n_envs, ...)``, the same rows per member."""
    def flat(key):
        v = rows[key]
        if members is not None:
            return v.transpose(0, 1).reshape(members, v.shape[0] * v.shape[2], *v.shape[3:])
        return v.reshape(v.shape[0] * v.shape[1], *v.shape[2:])

    def obs(prefix):
        if f"{prefix}.frame" in rows:
            return MultiObservation(flat(f"{prefix}.features"), flat(f"{prefix}.frame"))
        return flat(prefix)

    return Batch(states=obs("states"), actions=flat("actions"), rewards=flat("rewards"),
                 next_states=obs("next_states"), done=flat("done"))


def act_graph_key(state: TrainState, env_states: EnvState, act_gen: torch.Generator) -> tuple:
    """What a captured acting step reads and writes, compared by
    identity: the state, the actor and its tensors, the env states and
    their tensors, and both generators."""
    return (state, state.actor, *state.actor.parameters(), *state.actor.buffers(),
            env_states, env_states.rng, *env_states.leaves(), act_gen)


class OnDeviceLoop:
    """Collect and update on one device. ``n_envs`` twins step as a
    batch; every ``update_every`` steps their transitions are pushed and
    a burst of updates runs, the reference's cadence."""

    members: int | None = None  # a population's member count

    def __init__(self, sac: Learner, env_cls, n_envs: int = 16, mesh=None,
                 device: str | torch.device | None = None):
        if mesh is not None:
            raise NotImplementedError(
                "the fused loop over a mesh (data-parallel envs and replay shards) is not "
                "ported yet; run it on one device"
            )
        self.sac = sac
        self.env = env_cls
        self.n_envs = int(n_envs)
        self.device = resolve_device(device)
        self.act_graphs: t.Dict[bool, BurstGraph] = {}  # by warm-up flag
        self.act_captures = 0

    # ------------------------------------------------------------------ init

    def init(
        self, seed: int = 0, buffer_capacity: int = 1_000_000
    ) -> t.Tuple[TrainState, BufferState, EnvState, torch.Generator]:
        """The learner state (models from ``seed``, the learner's
        generator ``seed + 1``), an empty ring, the reset env batch (its
        generator ``seed + 3``) and the acting generator (``seed + 2``)."""
        dev = self.device
        spec = _SpecView(self.env)
        actor, critic = build_models(self.sac.config, spec.obs_shape, spec.act_dim,
                                     spec.act_limit, generator=torch.Generator().manual_seed(seed))
        state = self.sac.init_state(actor.to(dev), critic.to(dev),
                                    torch.Generator(device=dev).manual_seed(seed + 1))
        warn_if_buffer_exceeds_hbm(buffer_capacity, spec.obs_shape, spec.act_dim, dev,
                                   advice="reduce buffer_capacity (or history_len)")
        if isinstance(spec.obs_shape, MultiObservation):
            (features,) = spec.obs_shape.features
            ring = init_visual_replay_buffer(buffer_capacity, features, spec.obs_shape.frame,
                                             spec.act_dim, dev)
        else:
            ring = init_replay_buffer(buffer_capacity, spec.obs_shape, spec.act_dim, dev)
        env_gen = torch.Generator(device=dev).manual_seed(seed + 3)
        env_states = self.env.reset(self.n_envs, generator=env_gen, device=dev)
        act_gen = torch.Generator(device=dev).manual_seed(seed + 2)
        return state, ring, env_states, act_gen

    # ----------------------------------------------------------------- epoch

    def _members(self, x):
        """An env-batch tensor ``(P·n_envs, ...)`` (or each leaf of a
        :class:`MultiObservation`) as ``(P, n_envs, ...)`` in a
        population; as it is otherwise."""
        if self.members is None:
            return x
        return tree_map(lambda v: v.reshape(self.members, -1, *v.shape[1:]), x)

    def _per_member_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum() if self.members is None else self._members(x).sum(dim=-1)

    def _act_step(self, state: TrainState, env_states: EnvState, act_gen: torch.Generator,
                  stack: MetricStack, warmup: bool, noise: torch.Tensor | None = None,
                  pose: torch.Tensor | None = None) -> None:
        """One step of the batch: actions (uniform in warm-up: ``u · 2
        limit - limit`` from ``noise`` or the acting generator; else the
        policy's sample, its noise ``noise`` or drawn), the twins' step
        (reset poses ``pose`` or drawn), the transition written as the
        stack's row, and the env states updated in place. A population's
        actions and rows are ``(P, n_envs, ...)`` (``noise`` too), its
        episode statistics ``(P,)``."""
        env, obs = self.env, self._members(env_states.obs)
        if warmup:
            lead = (self.n_envs,) if self.members is None else (self.members, self.n_envs)
            u = noise if noise is not None else torch.rand(
                (*lead, env.act_dim), generator=act_gen, device=self.device)
            actions = u * (2 * env.act_limit) - env.act_limit
        else:
            with torch.no_grad():
                actions, _ = state.actor(obs, generator=None if noise is not None else act_gen,
                                         eps=noise, with_logprob=False)
        nxt, out = env.step(env_states, actions.reshape(-1, env.act_dim), pose=pose)
        ended = out.ended.to(torch.float32)
        m = self._members
        stack.write({
            **_obs_rows("states", obs), "actions": actions, "rewards": m(out.reward),
            **_obs_rows("next_states", m(out.next_obs)), "done": m(out.terminated),
            "episodes_sum": self._per_member_sum(ended),
            "return_sum": self._per_member_sum(ended * out.final_return),
        })
        env_states.copy_(nxt)

    def _collect(self, state, env_states, act_gen, update_every: int, warmup: bool,
                 eager: bool, noise=None, poses=None) -> t.Dict[str, torch.Tensor]:
        """One window of acting steps; returns the stack's rows."""
        def step(stack, t_=None):
            self._act_step(state, env_states, act_gen, stack, warmup,
                           noise=None if t_ is None or noise is None else noise[t_],
                           pose=None if t_ is None or poses is None else poses[t_])

        hooked = noise is not None or poses is not None
        if eager or hooked or self.device.type != "cuda":
            stack = MetricStack(update_every, self.device)
            for t_ in range(update_every):
                step(stack, t_)
            return stack.rows
        key = act_graph_key(state, env_states, act_gen)
        graph = self.act_graphs.get(warmup)
        if graph is None or not graph.serves(key, update_every):
            self.act_graphs.pop(warmup, None)  # its memory pool goes before the next capture
            graph = BurstGraph(step, key, update_every, (act_gen, env_states.rng))
            graph.play()
            self.act_graphs[warmup] = graph
            self.act_captures += 1
        else:
            graph.play()
        return graph.stack.rows

    def epoch(
        self,
        state: TrainState,
        ring: BufferState,
        env_states: EnvState,
        act_gen: torch.Generator,
        steps: int,
        update_every: int = 50,
        warmup: bool = False,
        *,
        eager: bool = False,
        noise: torch.Tensor | None = None,
        poses: torch.Tensor | None = None,
        indices: torch.Tensor | None = None,
        eps: torch.Tensor | None = None,
        offsets: torch.Tensor | None = None,
    ) -> t.Tuple[TrainState, BufferState, EnvState, torch.Generator, Metrics]:
        """``steps`` steps of the env batch (``steps x n_envs``
        transitions), a burst after every ``update_every``; ``warmup``
        acts uniformly and only pushes. Returns the state, ring, env
        states and acting generator (each updated in place) and the
        epoch's metrics as device scalars: ``loss_q`` and ``loss_pi``
        averaged over the windows, ``episodes`` ended, and ``reward``,
        their mean return (NaN when none ended).

        Test hooks (the eager path): ``noise`` ``(steps, n_envs,
        act_dim)`` each step's uniform draw (warm-up) or policy noise;
        ``poses`` ``(steps, n_envs, 2)`` each step's reset poses;
        ``indices``, ``eps``, ``offsets`` each window's burst hooks
        (:meth:`~.algorithm.Learner.update_burst`) on a leading window
        axis."""
        n_windows, rem = divmod(steps, update_every)
        if rem:
            raise ValueError(f"steps={steps} not a multiple of update_every={update_every}")
        num_updates = self.sac.config.replace(update_every=update_every).updates_per_window
        zero = torch.zeros(() if self.members is None else (self.members,),
                           dtype=torch.float32, device=self.device)
        loss_q, loss_pi, episodes, returns = (zero.clone() for _ in range(4))

        def window(hook, w, per):
            return None if hook is None else hook[w * per:(w + 1) * per]

        for w in range(n_windows):
            rows = self._collect(state, env_states, act_gen, update_every, warmup, eager,
                                 noise=window(noise, w, update_every),
                                 poses=window(poses, w, update_every))
            episodes += rows["episodes_sum"].sum(dim=0)
            returns += rows["return_sum"].sum(dim=0)
            chunk = window_chunk({k: v for k, v in rows.items() if k not in _STATS},
                                 self.members)
            if warmup:
                ring = push(ring, chunk)
                continue
            state, ring, m = self.sac.update_burst(
                state, ring, chunk, num_updates,
                indices=None if indices is None else indices[w],
                eps=None if eps is None else eps[w],
                offsets=None if offsets is None else offsets[w], eager=eager,
            )
            loss_q += m["loss_q"]
            loss_pi += m["loss_pi"]
        metrics = {
            "loss_q": loss_q / n_windows,
            "loss_pi": loss_pi / n_windows,
            "episodes": episodes,
            # NaN, not 0, when no episode ended: a silent 0 reads as a
            # perfect score on a reward-negative task.
            "reward": torch.where(episodes > 0, returns / episodes.clamp(min=1.0),
                                  torch.full_like(returns, math.nan)),
        }
        return state, ring, env_states, act_gen, metrics


class PopulationOnDeviceLoop(OnDeviceLoop):
    """``n_members`` complete fused training runs advanced by one loop
    (the JAX package's ``PopulationOnDeviceLoop``): every tensor carries
    the member axis, so each captured acting step and each captured
    update serves the whole population. Members share nothing: their
    own env batches, rings, Adam states and hyperparameters; a member's
    output does not depend on what the other members hold. With
    ``pbt=True`` the hyperparameters are per member and
    :meth:`pbt_step` exploits and explores on the device."""

    def __init__(self, sac: Learner, env_cls, n_members: int, n_envs: int = 16,
                 pbt: bool = False, mesh=None, device: str | torch.device | None = None):
        if n_members < 1:
            raise ValueError(f"n_members must be >= 1, got {n_members}")
        if mesh is not None:
            raise NotImplementedError(
                "the member axis over a mesh is not ported yet; run the population on "
                "one device")
        super().__init__(sac, env_cls, n_envs=n_envs, device=device)
        self.members = int(n_members)
        self.pbt = bool(pbt)

    def init(
        self, seed: int = 0, buffer_capacity: int = 1_000_000,
    ) -> t.Tuple[TrainState, BufferState, EnvState, torch.Generator, PBTState]:
        """The member-stacked learner state (member ``i``'s models from
        :func:`member_seed`, the learner's generator ``seed + 1``), empty
        rings of ``buffer_capacity`` rows per member, the reset batch of
        ``n_members · n_envs`` twins (generator ``seed + 3``), the acting
        generator (``seed + 2``) and the PBT state (generator ``seed +
        4``). With ``pbt``, the hyperparameters start jittered
        (:meth:`init_hyperparams`)."""
        dev, p = self.device, self.members
        spec = _SpecView(self.env)
        warn_if_buffer_exceeds_hbm(buffer_capacity * p, spec.obs_shape, spec.act_dim, dev,
                                   advice="reduce buffer_capacity (or population)")
        gens = [torch.Generator().manual_seed(member_seed(seed, i)) for i in range(p)]
        actor, critic = build_population_models(self.sac.config, spec.obs_shape, spec.act_dim,
                                                spec.act_limit, gens)
        state = self.sac.init_state(actor.to(dev), critic.to(dev),
                                    torch.Generator(device=dev).manual_seed(seed + 1))
        if isinstance(spec.obs_shape, MultiObservation):
            (features,) = spec.obs_shape.features
            ring = init_visual_replay_buffer(buffer_capacity, features, spec.obs_shape.frame,
                                             spec.act_dim, dev, members=p)
        else:
            ring = init_replay_buffer(buffer_capacity, spec.obs_shape, spec.act_dim, dev,
                                      members=p)
        env_gen = torch.Generator(device=dev).manual_seed(seed + 3)
        env_states = self.env.reset(p * self.n_envs, generator=env_gen, device=dev)
        act_gen = torch.Generator(device=dev).manual_seed(seed + 2)
        pbt_state = PBTState.zeros(p, torch.Generator(device=dev).manual_seed(seed + 4))
        if self.pbt:
            state.hyperparams = self.init_hyperparams(pbt_state.generator)
        return state, ring, env_states, act_gen, pbt_state

    def init_hyperparams(self, generator: torch.Generator) -> t.Dict[str, torch.Tensor]:
        """Per-member starting hyperparameters: each configured value
        (:meth:`~.algorithm.SAC.default_hyperparams`) times
        ``pbt_perturb ** u``, ``u`` uniform in ``[-1, 1)`` per member,
        drawn from ``generator`` in sorted key order, so the population
        starts diverse."""
        base = self.sac.default_hyperparams(self.device)
        perturb = float(self.sac.config.pbt_perturb)
        return {k: base[k] * perturb ** (torch.rand(self.members, generator=generator,
                                                    device=self.device) * 2 - 1)
                for k in sorted(base)}

    # ------------------------------------------------------------------- pbt

    def update_ema(self, pbt_state: PBTState, metrics: Metrics) -> PBTState:
        """Fold an epoch's per-member mean returns into the ranking EMA,
        in place on the device: a member's first contribution seeds it,
        later ones blend at ``pbt_ema``; a member with no finished episode
        keeps its estimate, uncounted."""
        tau = float(self.sac.config.pbt_ema)
        has = metrics["episodes"] > 0
        ema, reward = pbt_state.return_ema, metrics["reward"]
        blended = torch.where(pbt_state.ema_count == 0, reward, (1.0 - tau) * ema + tau * reward)
        # reward is NaN for a member without episodes; where() never selects it.
        ema.copy_(torch.where(has, blended, ema))
        pbt_state.ema_count.add_(has.to(torch.int32))
        return pbt_state

    @torch.no_grad()
    def pbt_step(self, state: TrainState, pbt_state: PBTState,
                 pick: torch.Tensor | None = None, signs: torch.Tensor | None = None
                 ) -> t.Dict[str, torch.Tensor]:
        """One exploit/explore step on the device, in place.

        Rank members by ``return_ema``; each of the bottom
        ``max(1, int(P · pbt_quantile))`` copies a uniformly drawn member
        of as many at the top: every network tensor, ``log_alpha`` and
        ALL Adam state (:func:`~.population.member_tensors`, each an
        ``index_select`` along the member axis, then ``copy_`` into the
        tensor the captured graphs hold), its hyperparameters the
        winner's times ``pbt_perturb ** ±1`` (a fair sign each), and the
        winner's EMA. Identity until every member is ranked. Losers keep
        their rings, and no generator is copied or touched (a member's
        draws are its slice of population-wide draws). The step count
        stays lockstep.

        Draws from ``pbt_state.generator``: the winner picks ``(n_cut,)``,
        then the signs ``(n_hyperparams or 1, P)``; test hooks ``pick``
        and ``signs`` (±1) replace them. Returns the event: ``src`` (each
        member's source), ``exploited``, ``factors``, the ranking
        ``return_ema`` and ``ready``, device tensors."""
        cfg, p, dev = self.sac.config, self.members, pbt_state.return_ema.device
        n_cut = max(1, int(p * cfg.pbt_quantile))
        gen = pbt_state.generator
        ema = pbt_state.return_ema
        ready = (pbt_state.ema_count > 0).all()
        order = torch.argsort(ema, stable=True)  # ascending, as jnp.argsort
        bottom, top = order[:n_cut], order[p - n_cut:]
        if pick is None:
            pick = torch.randint(0, n_cut, (n_cut,), generator=gen, device=dev)
        hp = state.hyperparams
        n_hp = max(len(hp or {}), 1)
        if signs is None:
            signs = torch.randint(0, 2, (n_hp, p), generator=gen, device=dev) * 2 - 1
        factors = float(cfg.pbt_perturb) ** signs.to(device=dev, dtype=torch.float32)
        identity = torch.arange(p, device=dev)
        src = identity.index_put((bottom,), top[pick.to(dev)])
        src = torch.where(ready, src, identity)
        exploited = src != identity
        for x in member_tensors(state):
            x.copy_(x.index_select(0, src))
        for i, k in enumerate(sorted(hp or {})):
            hp[k].copy_(torch.where(exploited, hp[k].index_select(0, src) * factors[i], hp[k]))
        ranked = ema.clone()
        # Losers compete as their new selves, not on their old score.
        ema.copy_(torch.where(exploited, ema.index_select(0, src), ema))
        return {"src": src, "exploited": exploited, "factors": factors, "return_ema": ranked,
                "ready": ready}

    # ----------------------------------------------------------- extraction

    def extract_member(self, state: TrainState, member: int) -> TrainState:
        """Member ``member``'s standalone SAC or TD3 state, on the
        population's device: its slice of the networks, targets, ``log_alpha`` and
        Adam states (:func:`~..utils.checkpoint.member_state_dict`), its
        hyperparameters (0-d), the step counts, and a new generator at
        the population's state. A lone :class:`OnDeviceLoop`, the
        serving CLI and ``run_agent`` take it."""
        spec = _SpecView(self.env)
        actor, critic = build_models(self.sac.config, spec.obs_shape, spec.act_dim,
                                     spec.act_limit)
        solo = make_learner(self.sac.config, spec.act_dim).init_state(
            actor.to(self.device), critic.to(self.device),
            torch.Generator(device=state.generator.device))
        solo.load_state_dict_(member_state_dict(state.state_dict(), member))
        if state.hyperparams is not None:
            solo.hyperparams = {k: v[member].clone() for k, v in state.hyperparams.items()}
        return solo


def train_on_device(
    env_name: str,
    config,
    tracker=None,
    checkpointer=None,
    seed: int = 0,
    device: str | torch.device | None = None,
    mesh=None,
    on_epoch: t.Callable[[int, dict], None] | None = None,
) -> dict:
    """The host side of the fused loop: a warm-up epoch of
    ``warmup_steps(start_steps, update_every)`` uniform steps, then
    ``epochs`` epochs of ``steps_per_epoch`` steps of the
    ``on_device_envs`` twins, each read back once for its metrics
    (``env_steps_per_sec``, ``grad_steps_per_sec``, the graphs'
    captures). Saves learner and ring every ``save_every`` epochs and at
    the last (asynchronously; a saving epoch's metrics add
    :func:`~.trainer.save_metrics`), with the acting steps per env taken
    so far as ``step``; resumes learner and ring from the newest checkpoint with
    the envs reset again, as JAX's ``train_on_device`` does. Raises
    ``FloatingPointError`` on a non-finite ``loss_q`` (after that
    epoch's save, as JAX's). Returns the last epoch's metrics."""
    check_ported(config)
    env_cls = get_on_device_env(env_name)
    if env_cls is None:
        raise ValueError(
            f"{env_name!r} has no on-device twin; on-device training supports "
            f"{known_on_device_envs()}"
        )
    env_cls, learner = _wrap_and_build(env_cls, config)
    loop = OnDeviceLoop(learner, env_cls, n_envs=config.on_device_envs, mesh=mesh, device=device)
    state, ring, env_states, act_gen = loop.init(seed, buffer_capacity=config.buffer_size)
    start_epoch, env_steps = 0, 0
    if checkpointer is not None:
        checkpointer.wait()
        if checkpointer.latest_epoch() is not None:
            state, ring, meta = checkpointer.restore(state, ring)
            start_epoch, env_steps = int(meta["epoch"]) + 1, int(meta.get("step", 0))
            logger.info("resumed the learner and the ring at epoch %d", start_epoch)

    if start_epoch == 0:
        n_warmup = warmup_steps(config.start_steps, config.update_every)
        state, ring, env_states, act_gen, _ = loop.epoch(
            state, ring, env_states, act_gen, steps=n_warmup,
            update_every=config.update_every, warmup=True,
        )
        env_steps += n_warmup

    keys = ("loss_q", "loss_pi", "episodes", "reward")
    last_epoch = start_epoch + config.epochs - 1
    metrics: dict = {}
    for e in range(start_epoch, last_epoch + 1):
        t0 = time.time()
        state, ring, env_states, act_gen, m = loop.epoch(
            state, ring, env_states, act_gen, steps=config.steps_per_epoch,
            update_every=config.update_every,
        )
        metrics = dict(zip(keys, torch.stack([m[k] for k in keys]).tolist()))  # the one read
        dt = time.time() - t0
        env_steps += config.steps_per_epoch
        metrics["env_steps_per_sec"] = config.steps_per_epoch * loop.n_envs / dt
        metrics["grad_steps_per_sec"] = (
            (config.steps_per_epoch // config.update_every) * config.updates_per_window / dt)
        metrics["graph_captures"] = learner.graph_captures
        metrics["act_graph_captures"] = loop.act_captures
        # The last epoch always saves: a short run leaves a checkpoint.
        if checkpointer is not None and (e % config.save_every == 0 or e == last_epoch):
            t_save = time.perf_counter()
            checkpointer.save(e, state, ring,
                              extra={"config": config.to_json(), "step": env_steps,
                                     "on_device": True})
            metrics.update(save_metrics(checkpointer, t_save, saved=True))
        if tracker is not None:
            tracker.log_metrics(metrics, e)
        if on_epoch is not None:
            on_epoch(e, dict(metrics))
        if not math.isfinite(metrics["loss_q"]):
            raise FloatingPointError(f"loss_q diverged at epoch {e}: {metrics}")
    if checkpointer is not None:
        checkpointer.wait()
    return metrics


def train_population_on_device(
    env_name: str,
    config,
    tracker=None,
    checkpointer=None,
    seed: int = 0,
    device: str | torch.device | None = None,
    mesh=None,
    on_epoch: t.Callable[[int, dict], None] | None = None,
) -> dict:
    """The host side of the fused population (the JAX package's
    ``train_population_on_device``): ``config.population`` members, each
    epoch one pass of the population loop, every ``pbt_every`` epochs
    (counted from epoch 0, so a resumed run exploits at the same epochs)
    one :meth:`PopulationOnDeviceLoop.pbt_step` after the EMA update.

    Each epoch's metrics are read once and logged in the per-member
    layout (:func:`~..diagnostics.ingraph.split_member_metrics`:
    ``loss_q_m0``, ..., and the aggregates), with ``pbt_exploits`` on PBT
    epochs and aggregate ``env_steps_per_sec`` and
    ``grad_steps_per_sec`` (both × P). Saves every ``save_every`` epochs
    and at the last, asynchronously: the stacked learner state with its
    hyperparameters, the rings (unless the checkpointer leaves them
    out), the env states, the acting generator and the PBT state, with
    ``population`` and the PBT ranking in the meta; a resumed run
    continues where the saved one was, and a checkpoint of another
    population raises ``ValueError``. A non-finite member ``loss_q``
    raises ``FloatingPointError`` naming the members (after that epoch's
    save). The ``pbt`` telemetry events wait for the telemetry module.
    Returns the last epoch's metrics."""
    check_ported(config, allow=POPULATION_FIELDS)
    env_cls = get_on_device_env(env_name)
    if env_cls is None:
        raise ValueError(
            f"{env_name!r} has no on-device twin; on-device training supports "
            f"{known_on_device_envs()}"
        )
    if config.history_len > 1:
        env_cls = history_env(env_cls, config.history_len)
    p = config.population
    learner = make_population_learner(config, env_cls.act_dim, p)
    loop = PopulationOnDeviceLoop(learner, env_cls, p, n_envs=config.on_device_envs,
                                  pbt=config.pbt_every > 0, mesh=mesh, device=device)
    state, ring, env_states, act_gen, pbt_state = loop.init(seed, config.buffer_size)
    arrays = {"env_states": env_states, "act_gen": act_gen, "pbt_state": pbt_state}
    start_epoch, env_steps = 0, 0
    if checkpointer is not None:
        checkpointer.wait()
        if checkpointer.latest_epoch() is not None:
            saved_pop = int(checkpointer.peek_meta().get("population", 1))
            if saved_pop != p:
                raise ValueError(f"checkpoint holds a population of {saved_pop}; this run "
                                 f"is configured for {p}")
            state, ring, meta, _ = checkpointer.restore(state, ring, abstract_arrays=arrays)
            start_epoch, env_steps = int(meta["epoch"]) + 1, int(meta.get("step", 0))
            logger.info("resumed the population at epoch %d", start_epoch)

    if start_epoch == 0:
        n_warmup = warmup_steps(config.start_steps, config.update_every)
        state, ring, env_states, act_gen, _ = loop.epoch(
            state, ring, env_states, act_gen, steps=n_warmup,
            update_every=config.update_every, warmup=True,
        )
        env_steps += n_warmup

    keys = ("loss_q", "loss_pi", "episodes", "reward")
    last_epoch = start_epoch + config.epochs - 1
    windows = config.steps_per_epoch // config.update_every
    metrics: dict = {}
    for e in range(start_epoch, last_epoch + 1):
        t0 = time.time()
        state, ring, env_states, act_gen, m = loop.epoch(
            state, ring, env_states, act_gen, steps=config.steps_per_epoch,
            update_every=config.update_every,
        )
        loop.update_ema(pbt_state, m)
        event = None
        if config.pbt_every > 0 and (e + 1) % config.pbt_every == 0:
            event = loop.pbt_step(state, pbt_state)
        read = [m[k] for k in keys] + ([event["exploited"].float()] if event else [])
        host = torch.stack(read).tolist()  # the one read
        dt = time.time() - t0
        env_steps += config.steps_per_epoch
        metrics = split_member_metrics(dict(zip(keys, host)))
        metrics["env_steps_per_sec"] = config.steps_per_epoch * loop.n_envs * p / dt
        metrics["grad_steps_per_sec"] = windows * config.updates_per_window * p / dt
        metrics["graph_captures"] = learner.graph_captures
        metrics["act_graph_captures"] = loop.act_captures
        if event is not None:
            metrics["pbt_exploits"] = int(sum(host[-1]))
        if checkpointer is not None and (e % config.save_every == 0 or e == last_epoch):
            t_save = time.perf_counter()
            checkpointer.save(
                e, state, ring,
                extra={"config": config.to_json(), "step": env_steps, "on_device": True,
                       "population": p,
                       "pbt": {"return_ema": pbt_state.return_ema.tolist(),
                               "ema_count": pbt_state.ema_count.tolist()}},
                arrays=arrays,
            )
            metrics.update(save_metrics(checkpointer, t_save, saved=True))
        if tracker is not None:
            tracker.log_metrics(metrics, e)
        if on_epoch is not None:
            on_epoch(e, dict(metrics))
        bad = [i for i in range(p) if not math.isfinite(metrics[f"loss_q_m{i}"])]
        if bad:
            raise FloatingPointError(
                f"loss_q diverged at epoch {e} for members {bad}: "
                f"{ {k: v for k, v in metrics.items() if k.startswith('loss_q')} }")
    if checkpointer is not None:
        checkpointer.wait()
    return metrics
