"""Policy and critic modules of the port and the model dispatch."""

from __future__ import annotations

import typing as t

import torch
from torch import nn

from torch_actor_critic_tpu_torch.core.types import MultiObservation
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
from torch_actor_critic_tpu_torch.models.visual import (
    SimpleCNN,
    VisualActor,
    VisualCritic,
    VisualDoubleCritic,
)

__all__ = [
    "Actor", "Critic", "Dense", "DoubleCritic", "MLP", "MultiHeadAttention",
    "SequenceActor", "SequenceCritic", "SequenceDoubleCritic", "SequenceTrunk",
    "SimpleCNN", "TransformerBlock", "VisualActor", "VisualCritic",
    "VisualDoubleCritic", "build_actor", "build_models",
]

ObsShape = t.Union[t.Sequence[int], MultiObservation]


def _check_supported(config, obs_shape: ObsShape) -> None:
    if config.algorithm != "sac":
        raise NotImplementedError(
            f"algorithm={config.algorithm!r} is not ported yet (SAC only)"
        )
    visual = isinstance(obs_shape, MultiObservation)
    # The JAX trainer's construction gates: either pixel option on a
    # flat/sequence observation would silently do nothing.
    if config.frame_augment != "none" and not visual:
        raise ValueError(
            f"frame_augment={config.frame_augment!r} requires a visual (frame) "
            f"observation; got observation shape {obs_shape}"
        )
    if config.pixel_pipeline == "fused" and not visual:
        raise ValueError(
            "pixel_pipeline='fused' requires a visual (frame) observation; got "
            f"observation shape {obs_shape}"
        )
    if not visual and len(obs_shape) not in (1, 2):
        raise NotImplementedError(
            f"observation shape {obs_shape}: a frame needs a MultiObservation "
            "(features, frame) spec to select the visual family"
        )


def _visual_kwargs(config, obs_shape: MultiObservation) -> dict:
    (features_dim,) = obs_shape.features
    return dict(
        features_dim=features_dim, frame_shape=tuple(obs_shape.frame),
        hidden_sizes=config.hidden_sizes, filters=config.filters,
        kernel_sizes=config.kernel_sizes, strides=config.strides,
        cnn_features=config.cnn_features, cnn_dense_size=config.cnn_dense_size,
        normalize_pixels=config.normalize_pixels, dtype=config.model_dtype,
    )


def _shape(obs_shape: ObsShape) -> ObsShape:
    if isinstance(obs_shape, MultiObservation):
        return obs_shape.map(tuple)
    return tuple(obs_shape)


def build_models(
    config,
    obs_shape: ObsShape,
    act_dim: int,
    act_limit: float,
    generator: torch.Generator | None = None,
) -> t.Tuple[nn.Module, nn.Module]:
    """``(actor, critic)`` as the JAX trainer's ``build_models`` builds
    them (``sac/trainer.py``, visual, sequence and flat branches): a
    :class:`MultiObservation` of shapes ``(features=(F,), frame=(H, W,
    C))`` gives :class:`VisualActor` + :class:`VisualDoubleCritic`, a
    flat ``(obs_dim,)`` obs :class:`Actor` + :class:`DoubleCritic`, a
    ``(T, obs_dim)`` history :class:`SequenceActor` +
    :class:`SequenceDoubleCritic` with ``max_len = T``; the flat and
    sequence critics stack their ``config.num_qs`` members' parameters
    on a leading axis (any ``num_qs >= 1``), the visual one keeps them
    unrolled. Both draw their init from ``generator`` (None: seeded 0),
    actor first, then the critics one after another.
    ``frame_augment``/``pixel_pipeline`` on a non-visual observation
    raise ``ValueError``; TD3, multi-agent and task-embedding models
    ``NotImplementedError``.
    """
    obs_shape = _shape(obs_shape)
    gen = init_generator(generator)
    actor = build_actor(config, obs_shape, act_dim, act_limit, gen)
    dtype = config.model_dtype
    if isinstance(obs_shape, MultiObservation):
        critic = VisualDoubleCritic(
            act_dim=act_dim, num_qs=config.num_qs, generator=gen,
            **_visual_kwargs(config, obs_shape),
        )
    elif len(obs_shape) == 2:
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
    obs_shape: ObsShape,
    act_dim: int,
    act_limit: float,
    generator: torch.Generator | None = None,
) -> nn.Module:
    """The actor half of :func:`build_models` (the serving callers, which
    load their params from a checkpoint)."""
    obs_shape = _shape(obs_shape)
    _check_supported(config, obs_shape)
    gen = init_generator(generator)
    dtype = config.model_dtype
    if isinstance(obs_shape, MultiObservation):
        return VisualActor(
            act_dim=act_dim, act_limit=act_limit, generator=gen,
            **_visual_kwargs(config, obs_shape),
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
            generator=gen,
        )
    return Actor(
        obs_shape[0], act_dim, hidden_sizes=config.hidden_sizes,
        act_limit=act_limit, dtype=dtype, generator=gen,
    )
