"""Q-critics (port of ``models/critic.py``).

``Critic`` is a ReLU MLP over ``concat([obs, action])`` with a linear
scalar output, cast to f32. ``DoubleCritic`` is ``num_qs`` of them with
their parameters stacked on a leading axis, as the JAX package's
``nn.vmap`` over ``Critic`` holds them: each layer is one batched
product for the whole ensemble, and the output is ``(num_qs, batch)``.
Member ``i`` is drawn as the ``i``-th of ``num_qs`` ``Critic`` s built
one after another from the generator.
"""

from __future__ import annotations

import typing as t

import torch
from torch import nn

from torch_actor_critic_tpu_torch.models.mlp import (
    MLP,
    StackedMLP,
    init_generator,
    stack_members_,
)


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
    """Ensemble of ``num_qs`` critics, parameters stacked on a leading
    axis; ``Q(s, a) -> (num_qs, ...)`` in f32."""

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
        self.num_qs = num_qs
        self.trunk = StackedMLP(
            num_qs, obs_dim + act_dim, tuple(hidden_sizes) + (1,),
            activate_final=False, dtype=dtype,
        )
        stack_members_(self, [
            Critic(obs_dim, act_dim, hidden_sizes, dtype, gen) for _ in range(num_qs)
        ])

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        x = torch.cat([obs, action], dim=-1)
        q = self.trunk(x.reshape(-1, x.shape[-1])).float()  # (num_qs, N, 1)
        return q.reshape(self.num_qs, *x.shape[:-1])
