"""SAC over a population: ``P`` members' learners in one member-stacked
state, one update for all of them (the learner half of the JAX package's
``PopulationOnDeviceLoop``, which ``vmap`` s SAC's update over the member
axis).

The models are :mod:`..models.population`'s, every tensor with the
member axis first; the burst, its CUDA graph and the replay sampling are
the solo learner's (:meth:`~.algorithm.Learner.update_burst`; a member
ring's batch is ``(P, B, ...)``, member ``i``'s rows from its own ring).
Each member's losses are its own: ``loss_q``, ``loss_pi`` and the
temperature loss are ``(P,)``, and the gradient is taken of their SUM,
so member ``i``'s gradient is exactly its own loss's (a mean over
members would scale every member's gradient by ``1/P``). Adam is
elementwise, so one Adam over the stacked parameters is ``P`` members'
Adams; with per-member learning rates (``TrainState.hyperparams``, each
``(P,)``) the steps go through :func:`~.algorithm.dynamic_lr_step`. The
update's metrics are ``(P,)`` each.

:class:`PopulationTD3` is TD3's update over member-stacked deterministic
actors, their target actors and critics: its losses ``(P,)``, the
smoothing noise ``target_noise`` a ``(P,)`` hyperparameter broadcast per
member, and the policy delay one select on the shared lockstep
``device_step``, as under JAX's ``vmap``. :func:`make_population_learner`
picks one of the two from the config, and :func:`member_seed` seeds
member ``i``'s models.

A ``diagnostics`` tier (``light``/``full``) adds the solo update's
in-graph metrics, each one value per member as under JAX's ``vmap`` of
the solo update: the gradient norms and update ratios per member
(:func:`~..diagnostics.ingraph.member_global_norm`,
:func:`~..diagnostics.ingraph.member_update_ratio`; the temperature's
step is already elementwise over the ``(P,)`` ``log_alpha``), the
shared Q, TD and saturation statistics over each member's own slice
(:func:`~.algorithm.member_shared_diagnostics`) and ``diag/param_norm``
per member after a burst. The |TD| histogram is one count vector for
all members.
They only read, so the parameters after a burst are bitwise those of
``off``, whose update, metric keys and captured graph are unchanged.
"""

from __future__ import annotations

import copy
import math
import typing as t

import torch
from torch import nn

from torch_actor_critic_tpu_torch.core.types import Batch, TrainState
from torch_actor_critic_tpu_torch.diagnostics import ingraph as diag
from torch_actor_critic_tpu_torch.ops.augment import augment_batch
from torch_actor_critic_tpu_torch.ops.polyak import polyak_update_
from torch_actor_critic_tpu_torch.sac.algorithm import (
    SAC,
    Learner,
    Metrics,
    _set_grads,
    _step,
    dynamic_lr_step,
    make_adam,
    member_shared_diagnostics,
)
from torch_actor_critic_tpu_torch.td3.algorithm import TD3


def member_seed(seed: int, member: int) -> int:
    """The model-init seed of a population's member ``member``: member 0
    is initialised as a lone learner seeded ``seed`` is."""
    return seed * 65_536 + member


class MemberDiagnostics:
    """The diagnostics' reductions of a member-stacked learner, one
    value per member (mixed in before :class:`~.algorithm.Learner`)."""

    diag_norm = staticmethod(diag.member_global_norm)
    diag_update_ratio = staticmethod(diag.member_update_ratio)

    def diag_shared(self, *args) -> Metrics:
        return member_shared_diagnostics(self.config, *args)


def make_population_learner(config, act_dim: int, members: int) -> Learner:
    """:class:`PopulationTD3` for ``algorithm="td3"``, else
    :class:`PopulationSAC`: ``members`` learners in one."""
    cls = PopulationTD3 if config.algorithm == "td3" else PopulationSAC
    return cls(config, act_dim, members)


class PopulationSAC(MemberDiagnostics, SAC):
    """SAC for ``members`` learners over member-stacked models: an actor
    ``actor(obs (P, B, ...)) -> ((P, B, act), (P, B))`` and a critic
    ensemble ``critic(obs, action) -> (P, num_qs, B)``."""

    def __init__(self, config, act_dim: int, members: int):
        if config.algorithm != "sac":
            raise ValueError(f"PopulationSAC trains SAC members, not {config.algorithm!r}; "
                             "make_population_learner picks the learner")
        super().__init__(config, act_dim)
        self.members = int(members)

    def init_state(self, actor: nn.Module, critic: nn.Module,
                   generator: torch.Generator) -> TrainState:
        """:meth:`SAC.init_state` over stacked modules, with ``log_alpha``
        ``(P,)``."""
        device = next(critic.parameters()).device
        log_alpha = torch.full((self.members,), math.log(self.config.alpha),
                               dtype=torch.float32, device=device, requires_grad=True)
        lr = self.config.lr
        return TrainState(
            step=0, actor=actor, critic=critic,
            target_critic=copy.deepcopy(critic).requires_grad_(False),
            pi_opt=make_adam(actor.parameters(), lr, device),
            q_opt=make_adam(critic.parameters(), lr, device),
            log_alpha=log_alpha, alpha_opt=make_adam([log_alpha], lr, device),
            generator=generator,
        )

    def update(
        self,
        state: TrainState,
        batch: Batch,
        eps_q: torch.Tensor | None = None,
        eps_pi: torch.Tensor | None = None,
    ) -> t.Tuple[TrainState, Metrics]:
        """One gradient step of every member, in SAC's order (critic,
        actor on the updated critic, temperature, polyak). The batch is
        ``(P, B, ...)``; ``eps_q``/``eps_pi`` ``(P, B, act_dim)`` default
        to one draw each from ``state.generator``. Frames of the reference
        pixel pipeline are shifted here, as :meth:`SAC.update` does (the
        offsets drawn after the noise, ``(P·B, 2)`` per leaf)."""
        cfg = self.config
        gen = state.generator
        shape, device = batch.actions.shape, batch.actions.device
        if cfg.frame_augment != "none" and cfg.pixel_pipeline != "fused":
            eps_q, eps_pi = (e if e is not None else torch.randn(shape, generator=gen,
                                                                 device=device)
                             for e in (eps_q, eps_pi))
            batch = augment_batch(batch, cfg.frame_augment, cfg.augment_pad, generator=gen)
        if eps_q is None:
            eps_q = torch.randn(shape, generator=gen, device=device)
        if eps_pi is None:
            eps_pi = torch.randn(shape, generator=gen, device=device)
        hp = state.hyperparams or {}
        if cfg.learn_alpha:
            alpha = state.log_alpha.detach().exp()[:, None]
        else:
            alpha = hp["alpha"][:, None] if "alpha" in hp else cfg.alpha
        diagnose = cfg.diagnostics != "off"
        dm: Metrics = {}

        # --- critic step: each member's sum_i mean((Q_i - backup)^2) ---
        with torch.no_grad():
            next_action, next_logp = state.actor(batch.next_states, eps=eps_q)
            q_target = state.target_critic(batch.next_states, next_action)  # (P, Q, B)
            backup = cfg.reward_scale * batch.rewards + cfg.gamma * (1.0 - batch.done) * (
                q_target.amin(dim=1) - alpha * next_logp)
        q_params = list(state.critic.parameters())
        q = state.critic(batch.states, batch.actions)
        loss_q = ((q - backup[:, None, :]) ** 2).mean(dim=-1).sum(dim=-1)  # (P,)
        q_grads = torch.autograd.grad(loss_q.sum(), q_params)
        if diagnose:
            dm["diag/grad_norm_q"] = self.diag_norm(q_grads)
            q_before = diag.snapshot(q_params)
        _set_grads(q_params, q_grads)
        dynamic_lr_step(state.q_opt, hp.get("critic_lr"))
        if diagnose:
            dm["diag/update_ratio_q"] = self.diag_update_ratio(q_params, q_before)

        # --- actor step on the updated critic (frozen) ---
        pi_params = list(state.actor.parameters())
        pi_obs = batch.next_states if cfg.parity_pi_obs else batch.states
        state.critic.requires_grad_(False)
        try:
            pi, logp_pi = state.actor(pi_obs, eps=eps_pi)
            q_pi = state.critic(batch.states, pi).amin(dim=1)
            loss_pi = (alpha * logp_pi - q_pi).mean(dim=-1)  # (P,)
            pi_grads = torch.autograd.grad(loss_pi.sum(), pi_params)
        finally:
            state.critic.requires_grad_(True)
        if diagnose:
            dm["diag/grad_norm_pi"] = self.diag_norm(pi_grads)
            pi_before = diag.snapshot(pi_params)
        _set_grads(pi_params, pi_grads)
        dynamic_lr_step(state.pi_opt, hp.get("actor_lr"))
        if diagnose:
            dm["diag/update_ratio_pi"] = self.diag_update_ratio(pi_params, pi_before)
        logp = logp_pi.detach().mean(dim=-1)

        # --- entropy temperature ---
        if cfg.learn_alpha:
            target_entropy = hp.get("target_entropy", self.target_entropy)
            loss_alpha = -state.log_alpha * (logp + target_entropy)
            (a_grad,) = torch.autograd.grad(loss_alpha.sum(), [state.log_alpha])
            if diagnose:
                dm["diag/grad_norm_alpha"] = a_grad.abs()
                log_alpha_abs = state.log_alpha.detach().abs()
            state.log_alpha.grad = a_grad
            _step(state.alpha_opt)
            if diagnose:
                # Elementwise over the (P,) log_alpha: one ratio per member.
                dm["diag/update_ratio_alpha"] = diag.norm_ratio(
                    diag.scalar_adam_step(state.alpha_opt), log_alpha_abs)
            alpha_metric = state.log_alpha.detach().exp()
        elif "alpha" in hp:
            alpha_metric = hp["alpha"].clone()
        else:
            alpha_metric = torch.full((self.members,), cfg.alpha, device=device)

        polyak_update_(state.critic.parameters(), state.target_critic.parameters(),
                       cfg.polyak)
        state.device_step.add_(1)
        state.step += 1
        metrics = {
            "loss_q": loss_q.detach(), "loss_pi": loss_pi.detach(), "alpha": alpha_metric,
            "q_mean": q.detach().mean(dim=(1, 2)), "backup_mean": backup.mean(dim=-1),
            "logp_pi": logp, "entropy": -logp,
        }
        if diagnose:
            metrics.update(dm)
            metrics.update(self.diag_shared(loss_q, loss_pi, q.detach(), backup, pi.detach(),
                                            state.actor.act_limit))
        return state, metrics


class PopulationTD3(MemberDiagnostics, TD3):
    """TD3 for ``members`` learners over member-stacked models: a
    deterministic actor ``actor(obs (P, B, ...)) -> ((P, B, act), None)``,
    its target, and a critic ensemble ``(P, num_qs, B)``. :meth:`TD3.update`
    as it is: its losses (:mod:`~..td3.losses`, over the leading member
    axis) and their metrics are ``(P,)``, ``target_noise`` one per member;
    the policy delay selects on the shared ``device_step``, so every
    member applies or skips its actor step at the same update."""

    def __init__(self, config, act_dim: int, members: int):
        if config.algorithm != "td3":
            raise ValueError(f"PopulationTD3 trains TD3 members, not {config.algorithm!r}; "
                             "make_population_learner picks the learner")
        super().__init__(config, act_dim)
        self.members = int(members)

    def init_state(self, actor: nn.Module, critic: nn.Module,
                   generator: torch.Generator) -> TrainState:
        """:meth:`TD3.init_state` over stacked modules, with its inert
        ``log_alpha`` ``(P,)``, as the JAX population's."""
        state = super().init_state(actor, critic, generator)
        device = state.log_alpha.device
        state.log_alpha = torch.zeros((self.members,), dtype=torch.float32, device=device)
        state.alpha_opt = make_adam([state.log_alpha], self.config.lr, device)
        return state


def member_tensors(state: TrainState) -> t.Iterator[torch.Tensor]:
    """Every tensor of a population state with the member axis first:
    the networks' parameters and buffers (a TD3 target actor's too),
    each Adam's moments, and ``log_alpha`` (the Adam step counts are the
    lockstep 0-d ones)."""
    for module in state.modules():
        yield from module.parameters()
        yield from module.buffers()
    for opt in (state.pi_opt, state.q_opt, state.alpha_opt):
        for st in opt.state.values():
            yield from (v for v in st.values() if v.dim() > 0)
    yield state.log_alpha
