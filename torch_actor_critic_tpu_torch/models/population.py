"""A population's models: ``P`` members' actors and critic ensembles with
their parameters stacked on a leading member axis, as the JAX package's
``vmap`` over the member axis holds them (``sac/ondevice.py``'s
``PopulationOnDeviceLoop``).

Every tensor of a member-stacked model has ``P`` first: the actor's
parameters are ``(P, ...)`` and the critic ensemble's ``(P, num_qs,
...)``, so member ``i``'s parameters are slice ``i`` of each, and its
actor and critic are exactly :func:`~.build_models`'s (the parameter
names match; :func:`build_population_models` copies ``P`` built members
in with :func:`~.mlp.stack_members_`). Each layer is one batched product
for the whole population, and each attention layer ONE call with the
member axis folded into the batch: the actor's ``(P·B, H, T, d)``, the
critics' ``(P·Q·B, H, T, d)``. The kernels treat every (batch, head)
row on its own, so each member gets what it would get alone.

Inputs carry the member axis too: observations ``(P, B, ...)``, actions
``(P, B, act_dim)``; the actor returns ``(P, B, act_dim)`` actions and
``(P, B)`` log-probabilities, the critic ``(P, num_qs, B)``. The flat
and sequence stacks are ported; the visual one waits (grouped
convolutions).
"""

from __future__ import annotations

import typing as t

import torch
import torch.nn.functional as F
from torch import nn

from torch_actor_critic_tpu_torch.core.types import MultiObservation
from torch_actor_critic_tpu_torch.models.mlp import StackedDense, StackedMLP, stack_members_
from torch_actor_critic_tpu_torch.models.sequence import AttentionFn, StackedSequenceTrunk, default_attention
from torch_actor_critic_tpu_torch.ops.distributions import squashed_gaussian_sample


def _sample(module, h, generator, deterministic, with_logprob, eps):
    mu = module.mu(h).float()
    log_std = module.log_std(h).float()
    return squashed_gaussian_sample(mu, log_std, module.act_limit, deterministic,
                                    with_logprob, generator=generator, eps=eps)


class PopulationActor(nn.Module):
    """``P`` :class:`~.actor.Actor` s: ``(P, N, obs_dim)`` in."""

    def __init__(self, members: int, obs_dim: int, act_dim: int,
                 hidden_sizes: t.Sequence[int] = (256, 256), act_limit: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.trunk = StackedMLP(members, obs_dim, hidden_sizes, activate_final=True, dtype=dtype)
        width = hidden_sizes[-1] if hidden_sizes else obs_dim
        self.mu = StackedDense(members, width, act_dim, dtype=dtype)
        self.log_std = StackedDense(members, width, act_dim, dtype=dtype)
        self.act_limit = float(act_limit)

    def forward(self, obs, generator=None, deterministic=False, with_logprob=True, eps=None):
        return _sample(self, self.trunk(obs), generator, deterministic, with_logprob, eps)


class PopulationSequenceActor(nn.Module):
    """``P`` :class:`~.sequence.SequenceActor` s: ``(P, B, T, obs_dim)``
    histories in, acting for each history's latest step."""

    def __init__(self, members: int, obs_dim: int, act_dim: int, d_model: int = 128,
                 num_heads: int = 4, num_layers: int = 2, max_len: int = 512,
                 act_limit: float = 1.0, attention_fn: AttentionFn = default_attention,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.trunk = StackedSequenceTrunk(members, obs_dim, d_model, num_heads, num_layers,
                                          max_len, attention_fn, dtype=dtype)
        self.mu = StackedDense(members, d_model, act_dim, dtype=dtype)
        self.log_std = StackedDense(members, d_model, act_dim, dtype=dtype)
        self.act_limit = float(act_limit)

    def forward(self, obs_seq, generator=None, deterministic=False, with_logprob=True, eps=None):
        h = self.trunk(obs_seq)[..., -1, :]
        return _sample(self, h, generator, deterministic, with_logprob, eps)


class PopulationDoubleCritic(nn.Module):
    """``P`` :class:`~.critic.DoubleCritic` s: parameters ``(P, num_qs,
    ...)``; ``(P, B, obs_dim)``, ``(P, B, act_dim)`` in, ``(P, num_qs,
    B)`` out. Each member's input is read by its ``num_qs`` critics."""

    def __init__(self, members: int, obs_dim: int, act_dim: int,
                 hidden_sizes: t.Sequence[int] = (256, 256), num_qs: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_qs = num_qs
        self.trunk = StackedMLP((members, num_qs), obs_dim + act_dim,
                                tuple(hidden_sizes) + (1,), activate_final=False, dtype=dtype)

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        x = torch.cat([obs, action], dim=-1)  # (P, B, in)
        p, b, n_in = x.shape
        q = self.trunk(x[:, None].expand(p, self.num_qs, b, n_in)).float()
        return q.squeeze(-1)


class PopulationSequenceDoubleCritic(nn.Module):
    """``P`` :class:`~.sequence.SequenceDoubleCritic` s: parameters
    ``(P, num_qs, ...)``; ``(P, B, T, obs_dim)`` histories and ``(P, B,
    act_dim)`` actions in, ``(P, num_qs, B)`` out."""

    def __init__(self, members: int, obs_dim: int, act_dim: int, d_model: int = 128,
                 num_heads: int = 4, num_layers: int = 2, max_len: int = 512,
                 hidden: int = 256, num_qs: int = 2,
                 attention_fn: AttentionFn = default_attention,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_qs = num_qs
        lead = (members, num_qs)
        self.trunk = StackedSequenceTrunk(lead, obs_dim, d_model, num_heads, num_layers,
                                          max_len, attention_fn, dtype=dtype)
        self.fc = StackedDense(lead, d_model + act_dim, hidden, dtype=dtype)
        self.out = StackedDense(lead, hidden, 1, dtype=dtype)

    def forward(self, obs_seq: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        p, q = obs_seq.shape[0], self.num_qs
        h = self.trunk(obs_seq[:, None].expand(p, q, *obs_seq.shape[1:]))[..., -1, :]
        a = action[:, None].expand(p, q, *action.shape[1:]).to(h.dtype)
        x = torch.cat([h, a], dim=-1)
        return self.out(F.relu(self.fc(x))).float().squeeze(-1)


def build_population_models(
    config,
    obs_shape: t.Sequence[int],
    act_dim: int,
    act_limit: float,
    generators: t.Sequence[torch.Generator],
) -> t.Tuple[nn.Module, nn.Module]:
    """``(actor, critic)`` of ``len(generators)`` members: member ``i``
    is :func:`~.build_models` 's pair drawn from ``generators[i]``,
    copied into slice ``i`` of the stacked modules. A flat ``(obs_dim,)``
    observation gives :class:`PopulationActor` and
    :class:`PopulationDoubleCritic`, a ``(T, obs_dim)`` history the
    sequence pair; a visual observation and TD3 raise
    ``NotImplementedError``."""
    from torch_actor_critic_tpu_torch.models import build_models

    if isinstance(obs_shape, MultiObservation):
        raise NotImplementedError(
            "the visual (pixel) population is not ported yet: it waits for grouped "
            "convolutions and K1 over a member-offset ring")
    if config.algorithm == "td3":
        raise NotImplementedError("the TD3 population is not ported yet; train SAC members")
    singles = [build_models(config, obs_shape, act_dim, act_limit, generator=g)
               for g in generators]
    p, dtype = len(generators), config.model_dtype
    if len(obs_shape) == 2:
        horizon, obs_dim = obs_shape
        seq = dict(d_model=config.seq_d_model, num_heads=config.seq_num_heads,
                   num_layers=config.seq_num_layers, max_len=horizon, dtype=dtype)
        actor = PopulationSequenceActor(p, obs_dim, act_dim, act_limit=act_limit, **seq)
        critic = PopulationSequenceDoubleCritic(p, obs_dim, act_dim, num_qs=config.num_qs, **seq)
    else:
        actor = PopulationActor(p, obs_shape[0], act_dim, config.hidden_sizes, act_limit, dtype)
        critic = PopulationDoubleCritic(p, obs_shape[0], act_dim, config.hidden_sizes,
                                        config.num_qs, dtype)
    stack_members_(actor, [a for a, _ in singles])
    stack_members_(critic, [c for _, c in singles])
    return actor, critic
