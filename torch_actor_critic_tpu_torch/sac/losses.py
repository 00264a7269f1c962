"""SAC losses (port of ``sac/losses.py``).

Same math and operand order as the JAX functions. The actor's noise is
an explicit ``eps`` (the tests inject JAX's normals) or is drawn from an
explicit ``generator``. The critic's ``(num_qs, B)`` output is reduced
by ``min`` over axis 0. The Bellman backup is computed under
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
    actor: nn.Module,
    target_critic: nn.Module,
    batch: Batch,
    alpha: float | torch.Tensor,
    gamma: float,
    reward_scale: float,
    eps: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    diagnostics: bool = False,
    keep_q: bool = False,
) -> t.Tuple[torch.Tensor, t.Dict[str, torch.Tensor]]:
    """Twin-critic Bellman MSE: ``sum_i mean((Q_i(s, a) - backup)^2)``
    with ``backup = reward_scale * r + gamma * (1 - done) *
    (min_i Q_targ_i(s', a') - alpha * logp(a'|s'))``, ``a' ~ pi(.|s')``.
    ``diagnostics`` adds the detached ``(num_qs, B)`` Q surface and the
    backup under ``diag_q``/``diag_backup`` (the caller pops them);
    ``keep_q`` the ``(num_qs, B)`` Q surface itself, in the graph, under
    ``q`` (the offline learner's CQL gap reads it)."""
    with torch.no_grad():
        next_action, next_logp = actor(
            batch.next_states, generator=generator, eps=eps
        )
        q_target = target_critic(batch.next_states, next_action)
        q_target_min = q_target.amin(dim=0)
        backup = reward_scale * batch.rewards + gamma * (1.0 - batch.done) * (
            q_target_min - alpha * next_logp
        )
    q = critic(batch.states, batch.actions)  # (num_qs, B)
    loss = ((q - backup[None, :]) ** 2).mean(dim=-1).sum()
    aux = {"q_mean": q.detach().mean(), "backup_mean": backup.mean()}
    if diagnostics:
        aux["diag_q"] = q.detach()
        aux["diag_backup"] = backup
    if keep_q:
        aux["q"] = q
    return loss, aux


def actor_loss(
    actor: nn.Module,
    *,
    critic: nn.Module,
    batch: Batch,
    alpha: float | torch.Tensor,
    parity_pi_obs: bool = False,
    eps: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    diagnostics: bool = False,
) -> t.Tuple[torch.Tensor, t.Dict[str, torch.Tensor]]:
    """Policy loss ``mean(alpha * logp_pi - min_i Q_i(s, pi))``. The
    caller differentiates with respect to the actor's parameters only.
    ``diagnostics`` adds the detached policy actions under ``diag_pi``."""
    pi_obs = batch.next_states if parity_pi_obs else batch.states
    pi, logp_pi = actor(pi_obs, generator=generator, eps=eps)
    q_pi = critic(batch.states, pi)
    q_pi_min = q_pi.amin(dim=0)
    loss = (alpha * logp_pi - q_pi_min).mean()
    logp = logp_pi.detach().mean()
    aux = {"logp_pi": logp, "entropy": -logp}
    if diagnostics:
        aux["diag_pi"] = pi.detach()
    return loss, aux


def alpha_loss(
    log_alpha: torch.Tensor, logp_pi: torch.Tensor, target_entropy: float
) -> torch.Tensor:
    """Learned-temperature loss ``-log_alpha * (logp_pi + H_target)``."""
    return -log_alpha * (logp_pi.detach() + target_entropy)
