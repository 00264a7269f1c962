"""MLP actors (port of ``models/actor.py``): the squashed-Gaussian
``Actor`` of SAC and the ``DeterministicActor`` of TD3."""

from __future__ import annotations

import typing as t

import torch
from torch import nn

from torch_actor_critic_tpu_torch.models.mlp import MLP, Dense, init_generator
from torch_actor_critic_tpu_torch.ops.distributions import (
    squashed_gaussian_sample,
)


class Actor(nn.Module):
    """ReLU MLP trunk, separate ``mu``/``log_std`` heads, squashed
    Gaussian. Matmuls run in ``dtype``; the distribution math is f32."""

    def __init__(
        self,
        obs_dim: int,
        act_dim: int,
        hidden_sizes: t.Sequence[int] = (256, 256),
        act_limit: float = 1.0,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        gen = init_generator(generator)
        self.trunk = MLP(
            obs_dim, hidden_sizes, activate_final=True, dtype=dtype, generator=gen
        )
        width = hidden_sizes[-1] if hidden_sizes else obs_dim
        self.mu = Dense(width, act_dim, dtype=dtype, generator=gen)
        self.log_std = Dense(width, act_dim, dtype=dtype, generator=gen)
        self.act_limit = float(act_limit)

    def forward(
        self,
        obs: torch.Tensor,
        generator: torch.Generator | None = None,
        deterministic: bool = False,
        with_logprob: bool = True,
        eps: torch.Tensor | None = None,
    ):
        h = self.trunk(obs)
        mu = self.mu(h).float()
        log_std = self.log_std(h).float()
        return squashed_gaussian_sample(
            mu, log_std, self.act_limit, deterministic, with_logprob,
            generator=generator, eps=eps,
        )


def clipped_noise_action(
    mu: torch.Tensor,
    act_limit: float,
    act_noise: float,
    deterministic: bool,
    module_name: str,
    generator: torch.Generator | None = None,
    eps: torch.Tensor | None = None,
) -> torch.Tensor:
    """The TD3 head shared by the flat and visual actors: ``tanh(mu) *
    act_limit``, plus ``act_noise * act_limit * eps`` clipped back to the
    action box when acting. The noise is a standard-normal ``eps`` of
    ``mu``'s shape or a draw from ``generator`` (exactly one of them)."""
    action = torch.tanh(mu) * act_limit
    if deterministic:
        return action
    if (generator is None) == (eps is None):
        raise ValueError(
            f"{module_name} needs exactly one of `generator` or `eps` for "
            "exploration noise; pass deterministic=True for the noiseless policy"
        )
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
    noise = act_noise * act_limit * eps.to(mu.dtype)
    return torch.clamp(action + noise, -act_limit, act_limit)


class DeterministicActor(nn.Module):
    """TD3's deterministic tanh policy: a ReLU MLP trunk and one ``mu``
    head, ``tanh(mu) * act_limit``, with clipped Gaussian exploration
    noise (std ``act_noise * act_limit``) unless ``deterministic``.
    Returns ``(action, None)``: the log-prob slot only keeps the actor
    contract shared with the stochastic policies."""

    def __init__(
        self,
        obs_dim: int,
        act_dim: int,
        hidden_sizes: t.Sequence[int] = (256, 256),
        act_limit: float = 1.0,
        act_noise: float = 0.1,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        gen = init_generator(generator)
        self.trunk = MLP(
            obs_dim, hidden_sizes, activate_final=True, dtype=dtype, generator=gen
        )
        width = hidden_sizes[-1] if hidden_sizes else obs_dim
        self.mu = Dense(width, act_dim, dtype=dtype, generator=gen)
        self.act_limit = float(act_limit)
        self.act_noise = float(act_noise)

    def forward(
        self,
        obs: torch.Tensor,
        generator: torch.Generator | None = None,
        deterministic: bool = False,
        with_logprob: bool = True,  # noqa: ARG002 — contract only
        eps: torch.Tensor | None = None,
    ):
        mu = self.mu(self.trunk(obs)).float()
        action = clipped_noise_action(
            mu, self.act_limit, self.act_noise, deterministic, type(self).__name__,
            generator=generator, eps=eps,
        )
        return action, None
