"""Squashed-Gaussian MLP actor (port of ``models/actor.py::Actor``)."""

from __future__ import annotations

import typing as t

import torch
from torch import nn

from torch_actor_critic_tpu_torch.models.mlp import MLP, Dense
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
    ):
        super().__init__()
        self.trunk = MLP(obs_dim, hidden_sizes, activate_final=True, dtype=dtype)
        width = hidden_sizes[-1] if hidden_sizes else obs_dim
        self.mu = Dense(width, act_dim, dtype=dtype)
        self.log_std = Dense(width, act_dim, dtype=dtype)
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
