"""The SAC learner: state init, one update step and the update burst
(port of ``sac/algorithm.py``).

One update runs in the JAX package's order: the critic step, then the
actor step on the UPDATED critic, then the optional temperature step,
then the polyak target update, then the device step (one kernel:
``TrainState.device_step += 1``). Each network has its own
``torch.optim.Adam(lr, eps=1e-8)`` (optax's ``adam`` defaults; the two
order their float ops differently, so parity with optax is a tolerance).
Gradients are taken with ``torch.autograd.grad`` with respect to one
network's parameters; during the actor step the critic's parameters are
frozen, so its attention runs forward-only.

A burst pushes a chunk, then runs ``num_updates`` steps, each sampling
its batch on the device. Nothing in a burst reads a value back to the
host: metrics stay device scalars, are stacked, and are reduced once by
key suffix. On the card :meth:`Learner.update_burst` (SAC's and TD3's)
runs the burst as one
device program, as the JAX package jits its ``lax.scan``: one update
(:func:`update_step`) captured in a CUDA graph and replayed for every
update (:mod:`.graph`); the Adam instances are ``capturable`` there.
The CPU, and every test hook that injects per-update data, take the
eager loop (:func:`run_update_burst`); both draw the same rows, shifts
and noise from the same generator state. On a visual ring with
``pixel_pipeline="fused"`` the batch comes from
:func:`~..buffer.replay.sample_fused_visual` (frames gathered, shifted
and decoded by the kernel K1); with the reference pipeline and
``frame_augment="shift"`` the update shifts the sampled uint8 frames
itself (:func:`~..ops.augment.augment_batch`).

A state may carry per-run hyperparameters (``TrainState.hyperparams``,
:meth:`SAC.default_hyperparams`: the two learning rates and the live
temperature knob) as device tensors that override the config's scalars
in the update; a population's are ``(P,)``, one value per member. With
them the Adam steps of actor and critic take their rate from a tensor
(:func:`dynamic_lr_step`), so one captured update serves every rate.

``diagnostics`` ``"light"``/``"full"`` adds the JAX learner's in-graph
learning-health metrics to each update's rows (:func:`_shared_diagnostics`
and the gradient and update norms; ``diag/param_norm`` after each burst;
a population's per member, :func:`member_shared_diagnostics` and the
learner's ``diag_*`` reductions).
They only read what the update computes (gradients, the Q surface, the
backup, the policy's actions, the parameters before and after each
step), so the parameters after a burst are bitwise those of ``"off"``,
whose update is unchanged: the same kernels, the same metric keys.
"""

from __future__ import annotations

import contextlib
import copy
import math
import typing as t
import warnings

import torch
from torch import nn

from torch_actor_critic_tpu_torch.buffer.replay import push, sample, sample_fused_visual
from torch_actor_critic_tpu_torch.core.types import Batch, BufferState, TrainState
from torch_actor_critic_tpu_torch.diagnostics import ingraph as diag
from torch_actor_critic_tpu_torch.diagnostics.ingraph import reduce_burst_metrics
from torch_actor_critic_tpu_torch.ops.augment import augment_batch
from torch_actor_critic_tpu_torch.ops.polyak import polyak_update_
from torch_actor_critic_tpu_torch.sac import losses
from torch_actor_critic_tpu_torch.sac.graph import BurstGraph, MetricStack
from torch_actor_critic_tpu_torch.telemetry.costmodel import PendingCount

Metrics = t.Dict[str, torch.Tensor]

ADAM_EPS = 1e-8  # optax.adam's and torch's default

# The warm-up update of a capture and the eager burst on the card step the
# very capturable Adam a graph holds; torch's advice to drop `capturable`
# when stepping outside a capture does not apply to them.
_CAPTURABLE_OUTSIDE_CAPTURE = "This instance was constructed with capturable=True"


def _step(opt: torch.optim.Optimizer) -> None:
    """``opt.step()``, without torch's warning against stepping a
    capturable optimizer outside a capture."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_CAPTURABLE_OUTSIDE_CAPTURE,
                                category=UserWarning)
        opt.step()


def _set_grads(params: t.Sequence[torch.Tensor], grads: t.Sequence[torch.Tensor]) -> None:
    """Store each gradient with its parameter's strides, as ``.backward()``
    would. A stacked critic weight's gradient comes out of the batched
    product transposed (or, for a width-1 output, with another stride on
    that axis), and one gradient whose strides differ from its
    parameter's sends Adam's multi-tensor passes over the whole list down
    their per-tensor path on the card."""
    for p, g in zip(params, grads):
        p.grad = g if g.stride() == p.stride() else torch.empty_like(p).copy_(g)


@torch.no_grad()
def dynamic_lr_step(opt: torch.optim.Adam, lr: torch.Tensor | None) -> None:
    """One step of ``opt`` (an Adam) at the rate ``lr``, a device tensor:
    0-d for one learner, ``(P,)`` for a member-stacked one (each
    parameter's leading axis is the member axis; the rate broadcasts per
    member). ``lr=None`` is ``opt.step()`` at the configured rate.

    The JAX package's ``dynamic_lr_step`` replays optax's adam with a
    traced rate. ``torch.optim.Adam`` takes one rate per parameter group
    (a capturable one, at most a one-element tensor), so this repeats
    capturable Adam's arithmetic over the optimizer's own state (created
    as Adam's first step would, the step count on the parameter's
    device): ``step += 1``, ``m = lerp(m, g, 1 - b1)``, ``v = b2 v + (1 -
    b2) g²``, then ``p -= lr / (1 - b1^step) · m / (sqrt(v) / sqrt(1 -
    b2^step) + eps)``, each on the device, so a CUDA graph holds it and a
    restored or exploited state is read in place. At the configured rate
    it equals ``opt.step()`` to float rounding, not bitwise: the rate and
    the bias corrections are f32 tensors here, host doubles in
    ``torch.optim.Adam``'s non-capturable step."""
    if lr is None:
        _step(opt)
        return
    for group in opt.param_groups:
        b1, b2 = group["betas"]
        eps = group["eps"]
        for p in group["params"]:
            if p.grad is None:
                continue
            st = opt.state[p]
            if not st:
                st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            step, m, v = st["step"], st["exp_avg"], st["exp_avg_sq"]
            step.add_(1)
            m.lerp_(p.grad, 1 - b1)
            v.mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
            rate = lr.reshape(lr.shape + (1,) * (p.dim() - lr.dim()))
            step_size = rate / (1 - b1 ** step)
            denom = (v.sqrt() / (1 - b2 ** step).sqrt()).add_(eps)
            p.sub_(step_size * (m / denom))


def make_adam(params, lr: float, device: torch.device) -> torch.optim.Adam:
    """``Adam(lr, eps=1e-8)``, ``capturable`` on the card (its step count a
    device tensor, its bias correction on the device) so a CUDA graph can
    hold it; the plain one on the CPU, which refuses ``capturable``."""
    return torch.optim.Adam(params, lr=lr, eps=ADAM_EPS, capturable=device.type == "cuda")


class Learner:
    """What SAC and TD3 share: the config, the action size, and the burst
    (:meth:`update_burst`) over the subclass's ``update``. A subclass
    gives ``init_state``, ``update`` and :meth:`burst_noise`.
    ``cost.request(name)`` counts the next eager update (its batch's
    sampling included) into the cost registry under ``name``
    (:class:`~..telemetry.costmodel.PendingCount`)."""

    def __init__(self, config, act_dim: int):
        self.config = config
        self.act_dim = act_dim
        self.graph: BurstGraph | None = None  # the last captured burst
        self.graph_captures = 0
        self.cost = PendingCount()

    # The diagnostics' reductions of one learner's tensors; a population
    # (sac/population.py) reduces each member's on its own.
    diag_norm = staticmethod(diag.global_norm)
    diag_update_ratio = staticmethod(diag.update_ratio)

    def diag_shared(self, *args) -> Metrics:
        """:func:`_shared_diagnostics` of one learner's update."""
        return _shared_diagnostics(self.config, *args)

    def burst_diagnostics(self, state: TrainState, metrics: Metrics) -> Metrics:
        """A burst's reduced metrics, with ``diag/param_norm`` (actor and
        critic, after the burst) when a diagnostics tier is on."""
        if self.config.diagnostics != "off":
            metrics["diag/param_norm"] = self.diag_norm(
                [*state.actor.parameters(), *state.critic.parameters()])
        return metrics

    def burst_noise(self, eps: torch.Tensor) -> t.Dict[str, torch.Tensor]:
        """``update``'s noise arguments from one update's slice of a
        burst's ``eps`` test hook."""
        raise NotImplementedError

    def start_burst(self, state: TrainState, buffer_state: BufferState, chunk: Batch,
                    num_updates: int) -> "Burst":
        """:meth:`update_burst` spread over the caller's loop, for a burst
        that only replays (:meth:`would_capture` is false): pushes the
        chunk and starts the burst on the graph that serves it
        (:meth:`~.graph.BurstGraph.start`). The returned :class:`Burst`
        enqueues its next replays at each ``advance()``; ``finish()``
        enqueues the rest and returns ``(state, buffer_state, metrics)``
        as :meth:`update_burst` does."""
        if self.would_capture(state, buffer_state, num_updates):
            raise ValueError("this burst captures a graph: run it with update_burst")
        buffer_state = push(buffer_state, chunk)
        self.graph.start(num_updates)
        return Burst(self, self.graph, state, buffer_state)

    def would_capture(self, state: TrainState, buffer_state: BufferState,
                      num_updates: int) -> bool:
        """Whether :meth:`update_burst` of ``num_updates`` updates over
        ``state`` and ``buffer_state`` would capture a graph: a ring on the
        card and no graph yet that serves them (a push keeps the ring's
        tensors, so the key is the same after it). The eager loop never
        captures."""
        if buffer_state.data.rewards.device.type != "cuda":
            return False
        return self.graph is None or not self.graph.serves(graph_key(state, buffer_state),
                                                           num_updates)

    def update_burst(
        self,
        state: TrainState,
        buffer_state: BufferState,
        chunk: Batch,
        num_updates: int,
        indices: torch.Tensor | None = None,
        eps: torch.Tensor | None = None,
        offsets: torch.Tensor | None = None,
        eager: bool = False,
    ) -> t.Tuple[TrainState, BufferState, Metrics]:
        """Push a chunk, then ``num_updates`` gradient steps; metrics
        reduced over the burst.

        A ring on the card runs as a CUDA graph (:mod:`.graph`); a CPU
        ring, a burst given a test hook (``indices``/``eps``/``offsets``,
        see :func:`run_update_burst`), or ``eager=True`` takes the eager
        loop. The graph is captured once per (state, ring) and replayed
        across bursts of up to the ``num_updates`` it was captured for
        (a larger burst captures again, for its size; alternating sizes
        then replay that one graph); another key (:func:`graph_key`:
        those objects and every tensor of them the update reads or
        writes) captures anew (``graph_captures`` counts). A failed
        capture or replay raises, with ``state.step`` counting the
        updates that ran."""
        hooked = indices is not None or eps is not None or offsets is not None
        if eager or hooked or buffer_state.data.rewards.device.type != "cuda":
            state, buffer_state, metrics = run_update_burst(
                self.update, self.config, state, buffer_state, chunk, num_updates,
                indices=indices, eps=eps, offsets=offsets, noise=self.burst_noise,
                scope=self.cost.scope,
            )
            return state, buffer_state, self.burst_diagnostics(state, metrics)
        buffer_state = push(buffer_state, chunk)
        key = graph_key(state, buffer_state)
        step = state.step
        graph = self.graph
        if graph is None or not graph.serves(key, num_updates):
            self.graph = None  # its memory pool goes before the next capture
            graph = BurstGraph(
                lambda stack: update_step(self.update, self.config, state, buffer_state, stack,
                                          scope=self.cost.scope),
                key, num_updates, state.generator,
            )
        try:
            metrics = graph.run(num_updates)
        finally:
            state.step = step + graph.ran  # the capture counted a step it did not run
        if graph is not self.graph:
            graph.key = graph_key(state, buffer_state)  # now with the warm-up's Adam state
            self.graph = graph
            self.graph_captures += 1
        return state, buffer_state, self.burst_diagnostics(state, metrics)


class Burst:
    """A burst in flight (:meth:`Learner.start_burst`): ``state.step``
    counts the updates enqueued so far."""

    def __init__(self, learner: Learner, graph: BurstGraph, state: TrainState,
                 buffer_state: BufferState):
        self.learner, self.graph, self.state, self.buffer_state = (
            learner, graph, state, buffer_state)
        self._step = state.step

    def advance(self) -> None:
        self._enqueue(wait=False)

    def finish(self) -> t.Tuple[TrainState, BufferState, Metrics]:
        self._enqueue(wait=True)
        metrics = self.graph.stack.reduce(self.graph.ran)
        return self.state, self.buffer_state, self.learner.burst_diagnostics(self.state, metrics)

    def _enqueue(self, wait: bool) -> None:
        try:
            self.graph.advance(wait)
        finally:
            self.state.step = self._step + self.graph.ran


class SAC(Learner):
    """SAC over an actor ``actor(obs, generator=, eps=) -> (action,
    logp)`` and an ensemble critic ``critic(obs, action) -> (num_qs, B)``
    — the same contract as the JAX learner's module defs."""

    def __init__(self, config, act_dim: int):
        super().__init__(config, act_dim)
        self.target_entropy = (
            config.target_entropy
            if config.target_entropy is not None
            else -float(act_dim)
        )

    def burst_noise(self, eps: torch.Tensor) -> t.Dict[str, torch.Tensor]:
        """``eps`` ``(2, B, act_dim)``: ``(eps_q, eps_pi)``."""
        return {"eps_q": eps[0], "eps_pi": eps[1]}

    def default_hyperparams(self, device=None) -> t.Dict[str, torch.Tensor]:
        """The PBT-perturbable hyperparameters at their configured values,
        f32 0-d tensors on ``device``: ``actor_lr``, ``critic_lr``, and
        ``target_entropy`` when the temperature is learned, ``alpha`` when
        it is fixed. In ``TrainState.hyperparams`` they override the
        config's scalars in :meth:`update`."""
        cfg = self.config
        hp = {"actor_lr": cfg.lr, "critic_lr": cfg.lr}
        if cfg.learn_alpha:
            hp["target_entropy"] = self.target_entropy
        else:
            hp["alpha"] = cfg.alpha
        return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in hp.items()}

    def init_state(
        self, actor: nn.Module, critic: nn.Module, generator: torch.Generator
    ) -> TrainState:
        """The learner state over built modules (already on the training
        device). The target critic starts as a copy of the critic. On
        the card each Adam is ``capturable`` (its step count a device
        tensor, its bias correction on the device), so a CUDA graph can
        hold it, and the eager burst runs the same kernels; on the CPU,
        which refuses ``capturable``, it is the plain one."""
        device = next(critic.parameters()).device
        target = copy.deepcopy(critic).requires_grad_(False)
        log_alpha = torch.full(
            (), math.log(self.config.alpha), dtype=torch.float32, device=device,
            requires_grad=True,
        )

        lr = self.config.lr
        return TrainState(
            step=0,
            actor=actor,
            critic=critic,
            target_critic=target,
            pi_opt=make_adam(actor.parameters(), lr, device),
            q_opt=make_adam(critic.parameters(), lr, device),
            log_alpha=log_alpha,
            alpha_opt=make_adam([log_alpha], lr, device),
            generator=generator,
        )

    def update(
        self,
        state: TrainState,
        batch: Batch,
        eps_q: torch.Tensor | None = None,
        eps_pi: torch.Tensor | None = None,
    ) -> t.Tuple[TrainState, Metrics]:
        """One gradient step. ``eps_q`` (the next-action noise of the
        critic loss) and ``eps_pi`` (the policy-loss noise) default to
        draws from ``state.generator``; tests inject JAX's. With
        ``frame_augment != "none"`` under the reference pixel pipeline,
        the batch's frames are shifted here (offsets drawn from the
        generator after the noise); fused frames arrive shifted."""
        cfg = self.config
        gen = state.generator
        if cfg.frame_augment != "none" and cfg.pixel_pipeline != "fused":
            eps_q, eps_pi = (
                e if e is not None else torch.randn(
                    batch.actions.shape, generator=gen, device=batch.actions.device)
                for e in (eps_q, eps_pi)
            )
            batch = augment_batch(batch, cfg.frame_augment, cfg.augment_pad, generator=gen)
        if eps_q is None:
            eps_q = torch.randn(
                batch.actions.shape, generator=gen, device=batch.actions.device
            )
        if eps_pi is None:
            eps_pi = torch.randn(
                batch.actions.shape, generator=gen, device=batch.actions.device
            )
        hp = state.hyperparams or {}
        alpha = state.log_alpha.detach().exp() if cfg.learn_alpha else hp.get("alpha", cfg.alpha)
        diagnose = cfg.diagnostics != "off"
        dm: Metrics = {}

        # --- critic step ---
        q_params = list(state.critic.parameters())
        loss_q, q_aux = losses.critic_loss(
            state.critic, actor=state.actor, target_critic=state.target_critic,
            batch=batch, alpha=alpha, gamma=cfg.gamma,
            reward_scale=cfg.reward_scale, eps=eps_q, diagnostics=diagnose,
        )
        diag_q, diag_backup = q_aux.pop("diag_q", None), q_aux.pop("diag_backup", None)
        q_grads = torch.autograd.grad(loss_q, q_params)
        if diagnose:
            dm["diag/grad_norm_q"] = self.diag_norm(q_grads)
            q_before = diag.snapshot(q_params)
        _set_grads(q_params, q_grads)
        dynamic_lr_step(state.q_opt, hp.get("critic_lr"))
        if diagnose:
            dm["diag/update_ratio_q"] = self.diag_update_ratio(q_params, q_before)

        # --- actor step, on the updated critic (frozen: grads w.r.t. the
        # actor's parameters only) ---
        pi_params = list(state.actor.parameters())
        state.critic.requires_grad_(False)
        try:
            loss_pi, pi_aux = losses.actor_loss(
                state.actor, critic=state.critic, batch=batch, alpha=alpha,
                parity_pi_obs=cfg.parity_pi_obs, eps=eps_pi, diagnostics=diagnose,
            )
            pi_grads = torch.autograd.grad(loss_pi, pi_params)
        finally:
            state.critic.requires_grad_(True)
        diag_pi = pi_aux.pop("diag_pi", None)
        if diagnose:
            dm["diag/grad_norm_pi"] = self.diag_norm(pi_grads)
            pi_before = diag.snapshot(pi_params)
        _set_grads(pi_params, pi_grads)
        dynamic_lr_step(state.pi_opt, hp.get("actor_lr"))
        if diagnose:
            dm["diag/update_ratio_pi"] = self.diag_update_ratio(pi_params, pi_before)

        # --- entropy temperature ---
        if cfg.learn_alpha:
            (a_grad,) = torch.autograd.grad(
                losses.alpha_loss(
                    state.log_alpha, pi_aux["logp_pi"],
                    hp.get("target_entropy", self.target_entropy),
                ),
                [state.log_alpha],
            )
            if diagnose:
                dm["diag/grad_norm_alpha"] = a_grad.abs()
                log_alpha_abs = state.log_alpha.detach().abs()
            state.log_alpha.grad = a_grad
            _step(state.alpha_opt)
            if diagnose:
                dm["diag/update_ratio_alpha"] = diag.norm_ratio(
                    diag.scalar_adam_step(state.alpha_opt), log_alpha_abs)
            alpha_metric = state.log_alpha.detach().exp()
        elif "alpha" in hp:
            alpha_metric = hp["alpha"].clone()
        else:
            alpha_metric = torch.full((), cfg.alpha, device=batch.rewards.device)

        # --- polyak target update ---
        polyak_update_(
            state.critic.parameters(), state.target_critic.parameters(), cfg.polyak
        )
        state.device_step.add_(1)
        state.step += 1
        metrics = {
            "loss_q": loss_q.detach(),
            "loss_pi": loss_pi.detach(),
            "alpha": alpha_metric,
            **q_aux,
            **pi_aux,
        }
        if diagnose:
            metrics.update(dm)
            metrics.update(self.diag_shared(loss_q, loss_pi, diag_q, diag_backup, diag_pi,
                                            state.actor.act_limit))
        return state, metrics


def _shared_diagnostics(
    config,
    loss_q: torch.Tensor,
    loss_pi: torch.Tensor,
    diag_q: torch.Tensor | None,
    diag_backup: torch.Tensor | None,
    diag_pi: torch.Tensor | None,
    act_limit: float,
) -> Metrics:
    """The in-graph diagnostics SAC and TD3 share (the JAX function) of
    one learner's update: :func:`member_shared_diagnostics` of a
    population of one."""
    def one(x):
        return None if x is None else x[None]

    m = member_shared_diagnostics(config, one(loss_q), one(loss_pi), one(diag_q),
                                  one(diag_backup), one(diag_pi), act_limit)
    return {k: v if k.endswith("_hist") else v[0] for k, v in m.items()}


def member_shared_diagnostics(
    config,
    loss_q: torch.Tensor,
    loss_pi: torch.Tensor,
    diag_q: torch.Tensor | None,
    diag_backup: torch.Tensor | None,
    diag_pi: torch.Tensor | None,
    act_limit: float,
) -> Metrics:
    """The shared in-graph diagnostics of a member-stacked update, each
    over member ``i``'s slice alone, ``(P,)``: the per-burst loss maxima
    (the losses ``(P,)``), the Q statistics of the raw ``(P, num_qs, B)``
    surface against the ``(P, B)`` backup (minimum, maximum, the
    ensemble's mean per-sample spread, online-vs-target bias), the
    policy's tanh saturation (its actions ``(P, B, act)``) and, at
    ``full``, the |TD| histogram — one ``(n_buckets + 2,)`` count vector,
    the members' counts summed — with its exact minimum, maximum and
    sum."""
    metrics: Metrics = {"loss_q_max": loss_q.detach(), "loss_pi_max": loss_pi.detach()}
    if diag_q is not None and diag_backup is not None:
        flat_q = diag_q.reshape(diag_q.shape[0], -1)
        metrics.update({
            "diag/q_min": flat_q.amin(dim=1),
            "diag/q_max": flat_q.amax(dim=1),
            "diag/q_spread": (diag_q.amax(dim=1) - diag_q.amin(dim=1)).mean(dim=-1),
            "diag/q_bias": flat_q.mean(dim=1) - diag_backup.mean(dim=-1),
        })
        if config.diagnostics == "full":
            abs_td = (diag_q - diag_backup[:, None, :]).abs()
            flat_td = abs_td.reshape(abs_td.shape[0], -1)
            metrics.update({
                "diag/td_hist": diag.bucket_counts(abs_td),
                "diag/td_abs_min": flat_td.amin(dim=1),
                "diag/td_abs_max": flat_td.amax(dim=1),
                "diag/td_abs_sum": flat_td.sum(dim=1),
            })
    if diag_pi is not None:
        metrics["diag/act_sat"] = diag.member_saturation_fraction(diag_pi, act_limit)
    return metrics


def graph_key(state: TrainState, buffer_state: BufferState) -> tuple:
    """What a captured update reads and writes, compared by identity
    (:meth:`~.graph.BurstGraph.serves`): the learner state's
    (:func:`state_key`), then the ring's leaves and device size. A
    restore that copies into those tensors
    (:meth:`~..core.types.TrainState.load_state_dict_`,
    :func:`~..buffer.replay.load_buffer_`) keeps the graph; one that
    replaced any of them (``Optimizer.load_state_dict`` builds new state
    tensors) is never replayed onto: the next burst captures anew."""
    return (*state_key(state), buffer_state.data, buffer_state.device_size,
            *buffer_state.data.leaves())


def state_key(state: TrainState) -> tuple:
    """The learner state's part of a graph key: the state and its
    modules (the target actor too, for TD3), optimizers, ``log_alpha``,
    device step and generator; every parameter, module buffer, Adam
    state tensor and hyperparameter."""
    modules = state.modules()
    opts = (state.pi_opt, state.q_opt, state.alpha_opt)
    return (
        state, *modules, *opts, state.log_alpha, state.device_step, state.generator,
        *(state.hyperparams or {}).values(),
        *(x for m in modules for x in (*m.parameters(), *m.buffers())),
        *(x for opt in opts for st in opt.state.values() for x in st.values()),
    )


def sample_update_batch(
    config,
    buffer_state: BufferState,
    generator: torch.Generator | None = None,
    indices: torch.Tensor | None = None,
    offsets: torch.Tensor | None = None,
) -> Batch:
    """One update's batch: through the fused pixel pipeline
    (:func:`~..buffer.replay.sample_fused_visual`) on a visual ring with
    ``pixel_pipeline="fused"``, else :func:`~..buffer.replay.sample`;
    drawn from ``generator`` or at the given ``indices``/``offsets``."""
    draw = {"generator": generator} if indices is None else {"indices": indices}
    if config.pixel_pipeline == "fused" and buffer_state.visual:
        return sample_fused_visual(
            buffer_state, config.batch_size, out_dtype=config.model_dtype,
            augment=config.frame_augment, pad=config.augment_pad,
            normalize=config.normalize_pixels, offsets=offsets, **draw,
        )
    return sample(buffer_state, config.batch_size, **draw)


def update_step(
    update_fn: t.Callable[..., t.Tuple[TrainState, Metrics]],
    config,
    state: TrainState,
    buffer_state: BufferState,
    stack: MetricStack,
    scope: t.Callable[[], t.ContextManager] = contextlib.nullcontext,
) -> None:
    """One update as the burst's CUDA graph captures it: a batch drawn
    from ``state.generator``, the update, and its metrics written at the
    stack's device counter. The eager loop's update, but for where the
    metrics go. The batch and the update run under ``scope()`` (the
    learner's pending cost count)."""
    with scope():
        batch = sample_update_batch(config, buffer_state, generator=state.generator)
        _, metrics = update_fn(state, batch)
    stack.write(metrics)


def run_update_burst(
    update_fn: t.Callable[..., t.Tuple[TrainState, Metrics]],
    config,
    state: TrainState,
    buffer_state: BufferState,
    chunk: Batch,
    num_updates: int,
    indices: torch.Tensor | None = None,
    eps: torch.Tensor | None = None,
    offsets: torch.Tensor | None = None,
    noise: t.Callable[[torch.Tensor], t.Dict[str, torch.Tensor]] | None = None,
    scope: t.Callable[[], t.ContextManager] = contextlib.nullcontext,
) -> t.Tuple[TrainState, BufferState, Metrics]:
    """The eager push-then-loop burst (the CPU's, and the card's with
    ``eager=True``). Test hooks: ``indices`` ``(K, B)`` are the
    replay rows of each update (instead of draws from
    ``state.generator``), ``eps[i]`` each update's noise, which
    ``noise(eps[i])`` turns into ``update_fn``'s keyword arguments (the
    learner's ``burst_noise``; SAC's takes ``(2, B, act_dim)``, ``(eps_q,
    eps_pi)``), ``offsets`` ``(K, 2, B, 2)`` each fused visual update's
    DrQ shifts of states and next states. Each update's batch and update
    run under ``scope()`` (the learner's pending cost count)."""
    buffer_state = push(buffer_state, chunk)
    rows = []
    for i in range(num_updates):
        with scope():
            batch = sample_update_batch(
                config, buffer_state,
                generator=state.generator if indices is None else None,
                indices=None if indices is None else indices[i],
                offsets=None if offsets is None else offsets[i],
            )
            state, metrics = update_fn(state, batch, **({} if eps is None else noise(eps[i])))
        rows.append(metrics)
    stacked = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    return state, buffer_state, reduce_burst_metrics(stacked)
