"""Q-critics (port of ``models/critic.py``).

``Critic`` is a ReLU MLP over ``concat([obs, action])`` with a linear
scalar output, cast to f32. ``DoubleCritic`` holds ``num_qs``
independent critics in an ``nn.ModuleList`` and returns
``(num_qs, batch)``; the JAX package vmaps one parameter-stacked critic
instead (``weights.load_jax_critic_params`` slices its ``ensemble``
axis).
"""

from __future__ import annotations

import typing as t

import torch
from torch import nn

from torch_actor_critic_tpu_torch.models.mlp import MLP, init_generator


class Critic(nn.Module):
    """Single Q-network: ``Q(s, a) -> (batch,)`` in f32."""

    def __init__(
        self,
        obs_dim: int,
        act_dim: int,
        hidden_sizes: t.Sequence[int] = (256, 256),
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.trunk = MLP(
            obs_dim + act_dim, tuple(hidden_sizes) + (1,), activate_final=False,
            dtype=dtype, generator=init_generator(generator),
        )

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        x = torch.cat([obs, action], dim=-1)
        return self.trunk(x).float().squeeze(-1)


class DoubleCritic(nn.Module):
    """Ensemble of ``num_qs`` independent critics; ``(num_qs, ...)``."""

    def __init__(
        self,
        obs_dim: int,
        act_dim: int,
        hidden_sizes: t.Sequence[int] = (256, 256),
        num_qs: int = 2,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        gen = init_generator(generator)
        self.ensemble = nn.ModuleList(
            Critic(obs_dim, act_dim, hidden_sizes, dtype, gen) for _ in range(num_qs)
        )

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return torch.stack([c(obs, action) for c in self.ensemble])
