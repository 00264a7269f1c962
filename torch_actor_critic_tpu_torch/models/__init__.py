"""Policy and critic modules of the port and the model dispatch."""

from __future__ import annotations

import typing as t

import torch
from torch import nn

from torch_actor_critic_tpu_torch.models.actor import Actor
from torch_actor_critic_tpu_torch.models.critic import Critic, DoubleCritic
from torch_actor_critic_tpu_torch.models.mlp import MLP, Dense, init_generator
from torch_actor_critic_tpu_torch.models.sequence import (
    MultiHeadAttention,
    SequenceActor,
    SequenceCritic,
    SequenceDoubleCritic,
    SequenceTrunk,
    TransformerBlock,
)

__all__ = [
    "Actor", "Critic", "Dense", "DoubleCritic", "MLP", "MultiHeadAttention",
    "SequenceActor", "SequenceCritic", "SequenceDoubleCritic", "SequenceTrunk",
    "TransformerBlock", "build_actor", "build_models",
]


def _check_supported(config, obs_shape: t.Tuple[int, ...]) -> None:
    if config.algorithm != "sac":
        raise NotImplementedError(
            f"algorithm={config.algorithm!r} is not ported yet (SAC only)"
        )
    if len(obs_shape) not in (1, 2):
        raise NotImplementedError(
            f"observation shape {obs_shape} (visual stack) is not ported yet"
        )


def build_models(
    config,
    obs_shape: t.Sequence[int],
    act_dim: int,
    act_limit: float,
    generator: torch.Generator | None = None,
) -> t.Tuple[nn.Module, nn.Module]:
    """``(actor, critic)`` as the JAX trainer's ``build_models`` builds
    them (``sac/trainer.py``, flat and sequence branches): a flat
    ``(obs_dim,)`` obs gives :class:`Actor` + :class:`DoubleCritic`, a
    ``(T, obs_dim)`` history :class:`SequenceActor` +
    :class:`SequenceDoubleCritic` with ``max_len = T``. Both draw their
    init from ``generator`` (None: seeded 0), actor first. TD3, visual,
    multi-agent and task-embedding models raise ``NotImplementedError``.
    """
    obs_shape = tuple(obs_shape)
    gen = init_generator(generator)
    actor = build_actor(config, obs_shape, act_dim, act_limit, gen)
    dtype = config.model_dtype
    if len(obs_shape) == 2:
        horizon, obs_dim = obs_shape
        critic = SequenceDoubleCritic(
            obs_dim, act_dim,
            d_model=config.seq_d_model,
            num_heads=config.seq_num_heads,
            num_layers=config.seq_num_layers,
            max_len=horizon,
            num_qs=config.num_qs,
            dtype=dtype,
            generator=gen,
        )
    else:
        critic = DoubleCritic(
            obs_shape[0], act_dim, hidden_sizes=config.hidden_sizes,
            num_qs=config.num_qs, dtype=dtype, generator=gen,
        )
    return actor, critic


def build_actor(
    config,
    obs_shape: t.Sequence[int],
    act_dim: int,
    act_limit: float,
    generator: torch.Generator | None = None,
) -> nn.Module:
    """The actor half of :func:`build_models` (the serving callers, which
    load their params from a checkpoint)."""
    obs_shape = tuple(obs_shape)
    _check_supported(config, obs_shape)
    gen = init_generator(generator)
    dtype = config.model_dtype
    if len(obs_shape) == 2:
        horizon, obs_dim = obs_shape
        return SequenceActor(
            obs_dim, act_dim,
            d_model=config.seq_d_model,
            num_heads=config.seq_num_heads,
            num_layers=config.seq_num_layers,
            max_len=horizon,
            act_limit=act_limit,
            dtype=dtype,
            generator=gen,
        )
    return Actor(
        obs_shape[0], act_dim, hidden_sizes=config.hidden_sizes,
        act_limit=act_limit, dtype=dtype, generator=gen,
    )
