"""TD3 losses (port of ``td3/losses.py``).

Same math and operand order as the JAX functions. The target-policy
smoothing noise is an explicit ``eps`` (the tests inject JAX's normals)
or is drawn from an explicit ``generator``. The backup is computed under
``no_grad`` (the JAX ``stop_gradient``); gradients are taken by the
caller with respect to one network's parameters only.

Both losses take leading axes before the ensemble's: a solo critic's
``(num_qs, B)`` gives 0-d losses, a population's ``(P, num_qs, B)``
gives ``(P,)`` ones (each member's own), with ``target_noise`` a float,
a 0-d tensor or one value per member.
"""

from __future__ import annotations

import typing as t

import torch
from torch import nn

from torch_actor_critic_tpu_torch.core.types import Batch


def critic_loss(
    critic: nn.Module,
    *,
    target_actor: nn.Module,
    target_critic: nn.Module,
    batch: Batch,
    act_limit: float,
    target_noise: float | torch.Tensor,
    noise_clip: float,
    gamma: float,
    reward_scale: float,
    eps: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    diagnostics: bool = False,
) -> t.Tuple[torch.Tensor, t.Dict[str, torch.Tensor]]:
    """Twin-critic Bellman MSE with target-policy smoothing:
    ``a' = clip(pi_targ(s') + clip(target_noise * act_limit * eps,
    ±noise_clip * act_limit), ±act_limit)``, ``backup = reward_scale * r
    + gamma * (1 - done) * min_i Q_targ_i(s', a')``, ``loss = sum_i
    mean((Q_i(s, a) - backup)^2)``. ``eps`` (standard normal, the
    action's shape) or a draw from ``generator``. A ``(P,)``
    ``target_noise`` scales member ``i``'s noise by its own value.
    ``diagnostics`` adds the detached Q surface and the backup under
    ``diag_q``/``diag_backup`` (the caller pops them)."""
    with torch.no_grad():
        next_action, _ = target_actor(
            batch.next_states, deterministic=True, with_logprob=False
        )
        if eps is None:
            eps = torch.randn(next_action.shape, generator=generator,
                              device=next_action.device)
        if isinstance(target_noise, torch.Tensor):
            target_noise = target_noise.reshape(
                target_noise.shape + (1,) * (eps.dim() - target_noise.dim()))
        noise = torch.clamp(
            target_noise * act_limit * eps,
            -noise_clip * act_limit,
            noise_clip * act_limit,
        )
        next_action = torch.clamp(next_action + noise, -act_limit, act_limit)
        q_target = target_critic(batch.next_states, next_action)
        backup = reward_scale * batch.rewards + gamma * (1.0 - batch.done) * (
            q_target.amin(dim=-2)
        )
    q = critic(batch.states, batch.actions)  # (..., num_qs, B)
    loss = ((q - backup.unsqueeze(-2)) ** 2).mean(dim=-1).sum(dim=-1)
    aux = {"q_mean": q.detach().mean(dim=(-2, -1)), "backup_mean": backup.mean(dim=-1)}
    if diagnostics:
        aux["diag_q"] = q.detach()
        aux["diag_backup"] = backup
    return loss, aux


def actor_loss(
    actor: nn.Module,
    *,
    critic: nn.Module,
    batch: Batch,
    diagnostics: bool = False,
) -> t.Tuple[torch.Tensor, t.Dict[str, torch.Tensor]]:
    """Deterministic policy gradient loss ``-mean(Q_1(s, pi(s)))``: the
    FIRST critic head, not the min (the twin debiases the backup, not the
    policy objective). The caller differentiates with respect to the
    actor's parameters only. ``diagnostics`` adds the detached policy
    actions under ``diag_pi``."""
    pi, _ = actor(batch.states, deterministic=True, with_logprob=False)
    q_pi = critic(batch.states, pi).select(-2, 0)  # (..., B)
    loss = -q_pi.mean(dim=-1)
    aux = {"q_pi_mean": q_pi.detach().mean(dim=-1)}
    if diagnostics:
        aux["diag_pi"] = pi.detach()
    return loss, aux
