"""TD3 losses (port of ``td3/losses.py``).

Same math and operand order as the JAX functions. The target-policy
smoothing noise is an explicit ``eps`` (the tests inject JAX's normals)
or is drawn from an explicit ``generator``. The backup is computed under
``no_grad`` (the JAX ``stop_gradient``); gradients are taken by the
caller with respect to one network's parameters only.
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
    target_noise: float,
    noise_clip: float,
    gamma: float,
    reward_scale: float,
    eps: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> t.Tuple[torch.Tensor, t.Dict[str, torch.Tensor]]:
    """Twin-critic Bellman MSE with target-policy smoothing:
    ``a' = clip(pi_targ(s') + clip(target_noise * act_limit * eps,
    ±noise_clip * act_limit), ±act_limit)``, ``backup = reward_scale * r
    + gamma * (1 - done) * min_i Q_targ_i(s', a')``, ``loss = sum_i
    mean((Q_i(s, a) - backup)^2)``. ``eps`` (standard normal, the
    action's shape) or a draw from ``generator``."""
    with torch.no_grad():
        next_action, _ = target_actor(
            batch.next_states, deterministic=True, with_logprob=False
        )
        if eps is None:
            eps = torch.randn(next_action.shape, generator=generator,
                              device=next_action.device)
        noise = torch.clamp(
            target_noise * act_limit * eps,
            -noise_clip * act_limit,
            noise_clip * act_limit,
        )
        next_action = torch.clamp(next_action + noise, -act_limit, act_limit)
        q_target = target_critic(batch.next_states, next_action)
        backup = reward_scale * batch.rewards + gamma * (1.0 - batch.done) * (
            q_target.amin(dim=0)
        )
    q = critic(batch.states, batch.actions)  # (num_qs, B)
    loss = ((q - backup[None, :]) ** 2).mean(dim=-1).sum()
    aux = {"q_mean": q.detach().mean(), "backup_mean": backup.mean()}
    return loss, aux


def actor_loss(
    actor: nn.Module,
    *,
    critic: nn.Module,
    batch: Batch,
) -> t.Tuple[torch.Tensor, t.Dict[str, torch.Tensor]]:
    """Deterministic policy gradient loss ``-mean(Q_1(s, pi(s)))``: the
    FIRST critic head, not the min (the twin debiases the backup, not the
    policy objective). The caller differentiates with respect to the
    actor's parameters only."""
    pi, _ = actor(batch.states, deterministic=True, with_logprob=False)
    q_pi = critic(batch.states, pi)[0]  # (B,)
    loss = -q_pi.mean()
    return loss, {"q_pi_mean": q_pi.detach().mean()}
