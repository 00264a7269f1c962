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
``(P, B)`` log-probabilities (TD3's deterministic actors ``None``), the
critic ``(P, num_qs, B)``.

The visual stack (:class:`PopulationVisualActor`,
:class:`PopulationDeterministicVisualActor`,
:class:`PopulationVisualDoubleCritic`) runs each convolution of its
member-stacked :class:`StackedSimpleCNN` as ONE grouped convolution:
the members' frames laid out as ``(B, P·C, H, W)`` channels, the
weights ``(P·O, C, k, k)``, ``groups=P``, so member ``i``'s output
channels read its input channels alone. The flatten keeps Flax's
``(H', W', C)`` order per member. The visual critic ensemble stays
unrolled over ``num_qs`` as the solo one is, each of its critics
stacked over ``P``.
"""

from __future__ import annotations

import typing as t

import torch
import torch.nn.functional as F
from torch import nn

from torch_actor_critic_tpu_torch.core.types import MultiObservation
from torch_actor_critic_tpu_torch.models.actor import clipped_noise_action
from torch_actor_critic_tpu_torch.models.mlp import StackedDense, StackedMLP, stack_members_
from torch_actor_critic_tpu_torch.models.sequence import AttentionFn, StackedSequenceTrunk, default_attention
from torch_actor_critic_tpu_torch.models.visual import conv_output_size
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


class PopulationDeterministicActor(nn.Module):
    """``P`` :class:`~.actor.DeterministicActor` s (TD3): ``(P, N,
    obs_dim)`` in, ``((P, N, act_dim), None)`` out."""

    def __init__(self, members: int, obs_dim: int, act_dim: int,
                 hidden_sizes: t.Sequence[int] = (256, 256), act_limit: float = 1.0,
                 act_noise: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.trunk = StackedMLP(members, obs_dim, hidden_sizes, activate_final=True, dtype=dtype)
        width = hidden_sizes[-1] if hidden_sizes else obs_dim
        self.mu = StackedDense(members, width, act_dim, dtype=dtype)
        self.act_limit = float(act_limit)
        self.act_noise = float(act_noise)

    def forward(self, obs, generator=None, deterministic=False, with_logprob=True, eps=None):
        mu = self.mu(self.trunk(obs)).float()
        return clipped_noise_action(mu, self.act_limit, self.act_noise, deterministic,
                                    type(self).__name__, generator=generator, eps=eps), None


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


class StackedConv(nn.Module):
    """``P`` VALID :class:`~.visual.Conv` s as one grouped convolution:
    ``weight (P, O, C, k, k)``, ``bias (P, O)``, float32, computed in
    ``dtype``; ``(B, P·C, H, W)`` in, ``(B, P·O, H', W')`` out."""

    def __init__(self, members: int, in_ch: int, out_ch: int, kernel: int, stride: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(members, out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(members, out_ch))
        self.stride = stride
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        p, o, c, k, _ = self.weight.shape
        return F.conv2d(x.to(dt), self.weight.to(dt).reshape(p * o, c, k, k),
                        self.bias.to(dt).reshape(p * o), self.stride, groups=p)


class StackedSimpleCNN(nn.Module):
    """``P`` :class:`~.visual.SimpleCNN` s over ``(P, B, H, W, C)``
    frames: grouped convolutions (:class:`StackedConv`), each member's
    output flattened in Flax's ``(H', W', C)`` order, then stacked Dense
    layers; ``(P, B, out_features)`` out."""

    def __init__(self, members: int, frame_shape: t.Sequence[int],
                 filters: t.Sequence[int] = (32, 64, 64),
                 kernel_sizes: t.Sequence[int] = (8, 4, 3),
                 strides: t.Sequence[int] = (4, 2, 1), dense_size: int = 512,
                 out_features: int = 1, normalize_pixels: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        h, w, c = frame_shape
        flat = conv_output_size((h, w), filters, kernel_sizes, strides)
        chans = [c, *filters]
        self.convs = nn.ModuleList(
            StackedConv(members, a, b, k, s, dtype=dtype)
            for a, b, k, s in zip(chans[:-1], chans[1:], kernel_sizes, strides))
        self.dense = StackedDense(members, flat, dense_size, dtype=dtype)
        self.out = StackedDense(members, dense_size, out_features, dtype=dtype)
        self.normalize_pixels = normalize_pixels

    def forward(self, frame: torch.Tensor) -> torch.Tensor:
        if frame.is_floating_point():
            x = frame  # decoded (and normalised) by the fused pixel pipeline
        else:
            x = frame.float()
            if self.normalize_pixels:
                x = x / 255.0
        p, b, h, w, c = x.shape
        # (P, B, H, W, C) -> (B, H, W, P·C), a channels-last NCHW view.
        x = x.permute(1, 2, 3, 0, 4).reshape(b, h, w, p * c).permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        _, po, h2, w2 = x.shape
        x = x.reshape(b, p, po // p, h2, w2).permute(1, 0, 3, 4, 2).reshape(p, b, -1)
        return self.out(self.dense(x))


class _PopulationVisualTrunk(nn.Module):
    """The member-stacked MLP(features) ⊕ CNN(frame) embedding of the
    visual actors."""

    def __init__(self, members, features_dim, frame_shape, hidden_sizes, filters, kernel_sizes,
                 strides, cnn_features, cnn_dense_size, normalize_pixels, dtype):
        super().__init__()
        self.trunk = StackedMLP(members, features_dim, hidden_sizes, activate_final=True,
                                dtype=dtype)
        self.visual_network = StackedSimpleCNN(members, frame_shape, filters, kernel_sizes,
                                               strides, cnn_dense_size, cnn_features,
                                               normalize_pixels, dtype=dtype)
        self.width = (hidden_sizes[-1] if hidden_sizes else features_dim) + cnn_features

    def embed(self, obs: MultiObservation) -> torch.Tensor:
        x = self.trunk(obs.features)
        return torch.cat([x, self.visual_network(obs.frame).to(x.dtype)], dim=-1)


class PopulationVisualActor(_PopulationVisualTrunk):
    """``P`` :class:`~.visual.VisualActor` s: a :class:`MultiObservation`
    of ``(P, B, F)`` features and ``(P, B, H, W, C)`` frames in."""

    def __init__(self, members: int, features_dim: int, frame_shape: t.Sequence[int],
                 act_dim: int, hidden_sizes=(256, 256), act_limit: float = 1.0,
                 filters=(32, 64, 64), kernel_sizes=(8, 4, 3), strides=(4, 2, 1),
                 cnn_features: int = 1, cnn_dense_size: int = 512,
                 normalize_pixels: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__(members, features_dim, frame_shape, hidden_sizes, filters,
                         kernel_sizes, strides, cnn_features, cnn_dense_size,
                         normalize_pixels, dtype)
        self.mu = StackedDense(members, self.width, act_dim, dtype=dtype)
        self.log_std = StackedDense(members, self.width, act_dim, dtype=dtype)
        self.act_limit = float(act_limit)

    def forward(self, obs, generator=None, deterministic=False, with_logprob=True, eps=None):
        return _sample(self, self.embed(obs), generator, deterministic, with_logprob, eps)


class PopulationDeterministicVisualActor(_PopulationVisualTrunk):
    """``P`` :class:`~.visual.DeterministicVisualActor` s (TD3)."""

    def __init__(self, members: int, features_dim: int, frame_shape: t.Sequence[int],
                 act_dim: int, hidden_sizes=(256, 256), act_limit: float = 1.0,
                 act_noise: float = 0.1, filters=(32, 64, 64), kernel_sizes=(8, 4, 3),
                 strides=(4, 2, 1), cnn_features: int = 1, cnn_dense_size: int = 512,
                 normalize_pixels: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__(members, features_dim, frame_shape, hidden_sizes, filters,
                         kernel_sizes, strides, cnn_features, cnn_dense_size,
                         normalize_pixels, dtype)
        self.mu = StackedDense(members, self.width, act_dim, dtype=dtype)
        self.act_limit = float(act_limit)
        self.act_noise = float(act_noise)

    def forward(self, obs, generator=None, deterministic=False, with_logprob=True, eps=None):
        mu = self.mu(self.embed(obs)).float()
        return clipped_noise_action(mu, self.act_limit, self.act_noise, deterministic,
                                    type(self).__name__, generator=generator, eps=eps), None


class PopulationVisualCritic(nn.Module):
    """``P`` :class:`~.visual.VisualCritic` s: ``(P, B)`` out."""

    def __init__(self, members: int, features_dim: int, frame_shape: t.Sequence[int],
                 act_dim: int, hidden_sizes=(256, 256), filters=(32, 64, 64),
                 kernel_sizes=(8, 4, 3), strides=(4, 2, 1), cnn_features: int = 1,
                 cnn_dense_size: int = 512, normalize_pixels: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.trunk = StackedMLP(members, features_dim + act_dim, tuple(hidden_sizes) + (1,),
                                activate_final=True, dtype=dtype)
        self.visual_network = StackedSimpleCNN(members, frame_shape, filters, kernel_sizes,
                                               strides, cnn_dense_size, cnn_features,
                                               normalize_pixels, dtype=dtype)
        self.final = StackedDense(members, 1 + cnn_features, 1, dtype=dtype)

    def forward(self, obs: MultiObservation, action: torch.Tensor) -> torch.Tensor:
        x = self.trunk(torch.cat([obs.features, action], dim=-1))
        x = torch.cat([x, self.visual_network(obs.frame).to(x.dtype)], dim=-1)
        return self.final(x).float().squeeze(-1)


class PopulationVisualDoubleCritic(nn.Module):
    """``P`` :class:`~.visual.VisualDoubleCritic` s: ``num_qs`` critics
    unrolled (``ensemble.{i}``), each stacked over ``P``; ``(P, num_qs,
    B)`` out."""

    def __init__(self, members: int, features_dim: int, frame_shape: t.Sequence[int],
                 act_dim: int, num_qs: int = 2, **kw):
        super().__init__()
        self.ensemble = nn.ModuleList(
            PopulationVisualCritic(members, features_dim, frame_shape, act_dim, **kw)
            for _ in range(num_qs))

    def forward(self, obs: MultiObservation, action: torch.Tensor) -> torch.Tensor:
        return torch.stack([c(obs, action) for c in self.ensemble], dim=1)


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
    observation gives :class:`PopulationActor` (TD3:
    :class:`PopulationDeterministicActor`) and
    :class:`PopulationDoubleCritic`, a ``(T, obs_dim)`` history the
    sequence pair (SAC only, as :func:`~.build_models`), a
    :class:`MultiObservation` the visual pair."""
    from torch_actor_critic_tpu_torch.models import _visual_kwargs, build_models

    singles = [build_models(config, obs_shape, act_dim, act_limit, generator=g)
               for g in generators]
    p, dtype = len(generators), config.model_dtype
    td3 = config.algorithm == "td3"
    if isinstance(obs_shape, MultiObservation):
        kw = _visual_kwargs(config, obs_shape.map(tuple))
        if td3:
            actor = PopulationDeterministicVisualActor(p, act_dim=act_dim, act_limit=act_limit,
                                                       act_noise=config.act_noise, **kw)
        else:
            actor = PopulationVisualActor(p, act_dim=act_dim, act_limit=act_limit, **kw)
        critic = PopulationVisualDoubleCritic(p, act_dim=act_dim, num_qs=config.num_qs, **kw)
    elif len(obs_shape) == 2:
        horizon, obs_dim = obs_shape
        seq = dict(d_model=config.seq_d_model, num_heads=config.seq_num_heads,
                   num_layers=config.seq_num_layers, max_len=horizon, dtype=dtype)
        actor = PopulationSequenceActor(p, obs_dim, act_dim, act_limit=act_limit, **seq)
        critic = PopulationSequenceDoubleCritic(p, obs_dim, act_dim, num_qs=config.num_qs, **seq)
    else:
        if td3:
            actor = PopulationDeterministicActor(p, obs_shape[0], act_dim, config.hidden_sizes,
                                                 act_limit, config.act_noise, dtype)
        else:
            actor = PopulationActor(p, obs_shape[0], act_dim, config.hidden_sizes, act_limit,
                                    dtype)
        critic = PopulationDoubleCritic(p, obs_shape[0], act_dim, config.hidden_sizes,
                                        config.num_qs, dtype)
    stack_members_(actor, [a for a, _ in singles])
    stack_members_(critic, [c for _, c in singles])
    return actor, critic
