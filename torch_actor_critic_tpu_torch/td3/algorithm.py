"""The TD3 learner (port of ``td3/algorithm.py``): Twin Delayed DDPG
(Fujimoto et al. 2018) over the same state, replay, burst and trainer as
SAC; ``SACConfig.algorithm = "td3"`` selects it.

One update runs in the JAX package's order: the critic step (target
policy smoothing, :mod:`.losses`); the actor's gradient on the UPDATED
critic, with the critic frozen; the candidate actor step; the select;
then the polyak update of the target actor, from the selected actor,
and of the target critic, both under the select.

The policy delay is decided on the device, as the JAX package's
``_select_tree(do_pi, ...)`` over ``(step + 1) % policy_delay == 0``:
``do_pi`` is computed from ``TrainState.device_step``, which every
update increments in place, so a CUDA graph replay (:mod:`..sac.graph`)
reads the true step, across bursts and resumes. The candidate actor
step always runs; on a skipped update ``torch.where`` puts back every
actor parameter, every ``pi_opt`` state tensor (``exp_avg``,
``exp_avg_sq`` and ``step``, which a capturable Adam steps
unconditionally) and leaves both targets, each bitwise what it was; an
applied update is bitwise an unconditional one. Skipped steps thus
freeze the policy optimizer, as the canonical algorithm does. The CPU's
eager loop runs the same select: no host branch reads the step.

``pi_opt``'s state is created at init (zeros, step 0: what Adam's lazy
init would make), so the pre-step copies the select reads exist from the
first update on; they are allocated inside each update (from a captured
graph's pool on replays). ``dynamic_lr_step`` and the PBT
hyperparameters are not ported; ``diagnostics != "off"`` raises.
"""

from __future__ import annotations

import copy
import typing as t

import torch
from torch import nn

from torch_actor_critic_tpu_torch.core.types import Batch, TrainState
from torch_actor_critic_tpu_torch.ops.augment import augment_batch
from torch_actor_critic_tpu_torch.ops.polyak import polyak_select_, select_
from torch_actor_critic_tpu_torch.sac.algorithm import (
    Learner,
    Metrics,
    _set_grads,
    _step,
    make_adam,
)
from torch_actor_critic_tpu_torch.td3 import losses

ADAM_STATE = ("step", "exp_avg", "exp_avg_sq")


def init_adam_state_(opt: torch.optim.Adam) -> None:
    """Create each parameter's Adam state as Adam's first step would:
    zero moments and a zero ``step`` (on the parameter's device when
    capturable, else on the CPU)."""
    scalar = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
    for group in opt.param_groups:
        on_param = group["capturable"] or group["fused"]
        for p in group["params"]:
            if not opt.state[p]:
                opt.state[p] = {
                    "step": torch.zeros((), dtype=scalar,
                                        device=p.device if on_param else "cpu"),
                    "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
                }


class TD3(Learner):
    """TD3 over a deterministic actor ``actor(obs, generator=,
    deterministic=, with_logprob=, eps=) -> (action, None)`` and an
    ensemble critic ``critic(obs, action) -> (num_qs, B)``."""

    def burst_noise(self, eps: torch.Tensor) -> t.Dict[str, torch.Tensor]:
        """``eps`` ``(B, act_dim)``: the update's smoothing noise."""
        return {"eps_q": eps}

    def init_state(
        self, actor: nn.Module, critic: nn.Module, generator: torch.Generator
    ) -> TrainState:
        """The learner state over built modules (already on the training
        device): both targets start as copies of their online nets, one
        Adam per network (capturable on the card), ``pi_opt``'s state
        created; ``log_alpha`` (0.0) and its Adam are inert slots, as
        the JAX TD3 state's."""
        device = next(critic.parameters()).device
        lr = self.config.lr
        pi_opt = make_adam(actor.parameters(), lr, device)
        init_adam_state_(pi_opt)
        log_alpha = torch.zeros((), dtype=torch.float32, device=device)
        return TrainState(
            step=0,
            actor=actor,
            critic=critic,
            target_critic=copy.deepcopy(critic).requires_grad_(False),
            pi_opt=pi_opt,
            q_opt=make_adam(critic.parameters(), lr, device),
            log_alpha=log_alpha,
            alpha_opt=make_adam([log_alpha], lr, device),
            generator=generator,
            target_actor=copy.deepcopy(actor).requires_grad_(False),
        )

    def update(
        self, state: TrainState, batch: Batch, eps_q: torch.Tensor | None = None
    ) -> t.Tuple[TrainState, Metrics]:
        """One gradient step: the critic always; the actor, ``pi_opt``
        and both targets where ``(device_step + 1) % policy_delay == 0``.
        ``eps_q`` (the smoothing noise, standard normal, the actions'
        shape) defaults to a draw from ``state.generator``; tests inject
        JAX's. With ``frame_augment != "none"`` under the reference
        pixel pipeline the batch's frames are shifted here (offsets drawn
        after the noise); fused frames arrive shifted."""
        cfg = self.config
        gen = state.generator
        act_limit = state.actor.act_limit
        if eps_q is None:
            eps_q = torch.randn(batch.actions.shape, generator=gen,
                                device=batch.actions.device)
        if cfg.frame_augment != "none" and cfg.pixel_pipeline != "fused":
            batch = augment_batch(batch, cfg.frame_augment, cfg.augment_pad, generator=gen)

        # --- critic step (every update) ---
        q_params = list(state.critic.parameters())
        loss_q, q_aux = losses.critic_loss(
            state.critic, target_actor=state.target_actor,
            target_critic=state.target_critic, batch=batch, act_limit=act_limit,
            target_noise=cfg.target_noise, noise_clip=cfg.noise_clip,
            gamma=cfg.gamma, reward_scale=cfg.reward_scale, eps=eps_q,
        )
        _set_grads(q_params, torch.autograd.grad(loss_q, q_params))
        _step(state.q_opt)

        # --- candidate actor step, on the updated critic (frozen) ---
        do_pi = (state.device_step + 1) % cfg.policy_delay == 0
        pi_params = list(state.actor.parameters())
        held = pi_params + [state.pi_opt.state[p][k] for p in pi_params for k in ADAM_STATE]
        with torch.no_grad():
            before = [torch.empty_like(x) for x in held]
            torch._foreach_copy_(before, held)
        state.critic.requires_grad_(False)
        try:
            loss_pi, pi_aux = losses.actor_loss(state.actor, critic=state.critic, batch=batch)
            _set_grads(pi_params, torch.autograd.grad(loss_pi, pi_params))
        finally:
            state.critic.requires_grad_(True)
        _step(state.pi_opt)

        # --- the select, then both targets under it ---
        select_(do_pi, held, before, out=held)
        polyak_select_(state.actor.parameters(), state.target_actor.parameters(),
                       cfg.polyak, do_pi)
        polyak_select_(state.critic.parameters(), state.target_critic.parameters(),
                       cfg.polyak, do_pi)
        state.device_step.add_(1)
        state.step += 1
        metrics = {"loss_q": loss_q.detach(), "loss_pi": loss_pi.detach(), **q_aux, **pi_aux}
        return state, metrics
