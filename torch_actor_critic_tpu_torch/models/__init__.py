"""Policy modules of the port and the actor-side model dispatch."""

from __future__ import annotations

import typing as t

from torch import nn

from torch_actor_critic_tpu_torch.models.actor import Actor
from torch_actor_critic_tpu_torch.models.mlp import MLP, Dense
from torch_actor_critic_tpu_torch.models.sequence import (
    MultiHeadAttention,
    SequenceActor,
    SequenceTrunk,
    TransformerBlock,
)

__all__ = [
    "Actor", "Dense", "MLP", "MultiHeadAttention", "SequenceActor",
    "SequenceTrunk", "TransformerBlock", "build_models",
]


def build_models(
    config, obs_shape: t.Sequence[int], act_dim: int, act_limit: float
) -> nn.Module:
    """The actor the JAX trainer's ``build_models`` would build
    (``sac/trainer.py``), actor side only: a flat ``(obs_dim,)`` obs
    gives :class:`Actor`, a ``(T, obs_dim)`` history gives
    :class:`SequenceActor` with ``max_len = T``."""
    obs_shape = tuple(obs_shape)
    dtype = config.model_dtype
    if config.algorithm != "sac":
        raise NotImplementedError(
            f"algorithm={config.algorithm!r} is not ported yet (SAC actors only)"
        )
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
        )
    if len(obs_shape) == 1:
        return Actor(
            obs_shape[0], act_dim, hidden_sizes=config.hidden_sizes,
            act_limit=act_limit, dtype=dtype,
        )
    raise NotImplementedError(
        f"observation shape {obs_shape} (visual stack) is not ported yet"
    )
