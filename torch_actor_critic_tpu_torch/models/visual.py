"""CNN models for mixed features + pixel observations (port of
``models/visual.py``).

- :func:`conv_output_size` — flattened size after the VALID conv stack.
- :class:`SimpleCNN` — conv trunk (ReLU after each conv) → flatten →
  ``Dense(dense_size)`` → ``Dense(out_features)``.
- :class:`VisualActor` — MLP(features) ⊕ CNN(frame) → squashed Gaussian.
- :class:`VisualCritic` / :class:`VisualDoubleCritic` — the reference's
  critic: ReLU through every MLP layer *including* the width-1 output,
  then concat with the CNN embedding and a ``final`` Dense.

Frames are NHWC at every public function, as in the JAX package.
Inside :class:`SimpleCNN` ``x.permute(0, 3, 1, 2)`` is a channels-last
NCHW view, which cuDNN takes without a copy; the conv output is
flattened in Flax's ``(H', W', C)`` order (``permute(0, 2, 3, 1)``) so
carried-over Dense weights compute the same function. uint8 frames (the
acting path) are decoded in the model (``float32``, then ``/ 255`` with
``normalize_pixels``); float frames come from the fused pixel pipeline
already decoded and pass through, so ``normalize`` applies exactly once
on each path. Convolutions and Dense layers run in ``dtype`` over
float32 parameters.
"""

from __future__ import annotations

import math
import typing as t

import torch
import torch.nn.functional as F
from torch import nn

from torch_actor_critic_tpu_torch.core.types import MultiObservation
from torch_actor_critic_tpu_torch.models.mlp import MLP, Dense, init_generator
from torch_actor_critic_tpu_torch.ops.distributions import squashed_gaussian_sample


def conv_output_size(
    image_hw: t.Tuple[int, int],
    filters: t.Sequence[int],
    kernel_sizes: t.Sequence[int],
    strides: t.Sequence[int],
) -> int:
    """Flattened size after the VALID conv stack: ``d' = floor((d - k) /
    s + 1)`` per spatial dim, channels the last filter count."""
    h, w = image_hw
    c = filters[0]
    for f, k, s in zip(filters, kernel_sizes, strides):
        c = f
        h = int(math.floor((h - k) / s + 1))
        w = int(math.floor((w - k) / s + 1))
    return int(c * h * w)


class Conv(nn.Conv2d):
    """VALID ``nn.Conv2d`` computing in ``dtype`` over float32 params,
    init ``U(±1/sqrt(k·k·in))`` for weight and bias (torch's default,
    which the JAX package copies) from an explicit generator. Flax conv
    kernels are ``(kh, kw, in, out)``; this weight is ``(out, in, kh, kw)``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=0, device="meta")
        self.to_empty(device="cpu")
        gen = init_generator(generator)
        bound = 1.0 / math.sqrt(kernel * kernel * in_ch)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=gen)
            self.bias.uniform_(-bound, bound, generator=gen)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride)


class SimpleCNN(nn.Module):
    """Conv trunk → flatten → ``Dense(dense_size)`` → ``Dense(out_features)``
    over NHWC ``frame_shape`` ``(H, W, C)`` frames."""

    def __init__(
        self,
        frame_shape: t.Sequence[int],
        filters: t.Sequence[int] = (32, 64, 64),
        kernel_sizes: t.Sequence[int] = (8, 4, 3),
        strides: t.Sequence[int] = (4, 2, 1),
        dense_size: int = 512,
        out_features: int = 1,
        normalize_pixels: bool = False,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        gen = init_generator(generator)
        h, w, c = frame_shape
        flat = conv_output_size((h, w), filters, kernel_sizes, strides)
        if flat <= 0:
            raise ValueError(
                f"SimpleCNN: the conv geometry (kernels {tuple(kernel_sizes)}, strides "
                f"{tuple(strides)}) reduces a {h}x{w} frame to nothing; shrink "
                "kernels/strides (SACConfig.filters/kernel_sizes/strides) or use "
                "larger frames."
            )
        chans = [c, *filters]
        self.convs = nn.ModuleList(
            Conv(a, b, k, s, dtype=dtype, generator=gen)
            for a, b, k, s in zip(chans[:-1], chans[1:], kernel_sizes, strides)
        )
        self.dense = Dense(flat, dense_size, dtype=dtype, generator=gen)
        self.out = Dense(dense_size, out_features, dtype=dtype, generator=gen)
        self.normalize_pixels = normalize_pixels

    def forward(self, frame: torch.Tensor) -> torch.Tensor:
        if frame.is_floating_point():
            x = frame  # decoded (and normalised) by the fused pixel pipeline
        else:
            x = frame.float()
            if self.normalize_pixels:
                x = x / 255.0
        x = x.permute(0, 3, 1, 2)  # NHWC -> a channels-last NCHW view
        for conv in self.convs:
            x = F.relu(conv(x))
        x = x.permute(0, 2, 3, 1).flatten(1)  # Flax's (H', W', C) order
        return self.out(self.dense(x))


def _batched(obs: MultiObservation, *rest):
    """Add a batch axis to unbatched inputs; returns ``(unbatched,
    features, frame, *rest)``."""
    features, frame = obs.features, obs.frame
    unbatched = features.dim() == 1
    if unbatched:
        features = features[None]
        rest = tuple(r[None] for r in rest)
    if frame.dim() == 3:
        frame = frame[None]
    return (unbatched, features, frame, *rest)


class VisualActor(nn.Module):
    """Squashed-Gaussian policy over a :class:`MultiObservation`: MLP
    trunk on ``features`` ⊕ CNN embedding of ``frame`` before the
    ``mu``/``log_std`` heads."""

    def __init__(
        self,
        features_dim: int,
        frame_shape: t.Sequence[int],
        act_dim: int,
        hidden_sizes: t.Sequence[int] = (256, 256),
        act_limit: float = 1.0,
        filters: t.Sequence[int] = (32, 64, 64),
        kernel_sizes: t.Sequence[int] = (8, 4, 3),
        strides: t.Sequence[int] = (4, 2, 1),
        cnn_features: int = 1,
        cnn_dense_size: int = 512,
        normalize_pixels: bool = False,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        gen = init_generator(generator)
        self.trunk = MLP(features_dim, hidden_sizes, activate_final=True,
                         dtype=dtype, generator=gen)
        self.visual_network = SimpleCNN(
            frame_shape, filters, kernel_sizes, strides, cnn_dense_size,
            cnn_features, normalize_pixels, dtype=dtype, generator=gen,
        )
        width = (hidden_sizes[-1] if hidden_sizes else features_dim) + cnn_features
        self.mu = Dense(width, act_dim, dtype=dtype, generator=gen)
        self.log_std = Dense(width, act_dim, dtype=dtype, generator=gen)
        self.act_limit = float(act_limit)

    def forward(
        self,
        obs: MultiObservation,
        generator: torch.Generator | None = None,
        deterministic: bool = False,
        with_logprob: bool = True,
        eps: torch.Tensor | None = None,
    ):
        unbatched, features, frame = _batched(obs)
        x = self.trunk(features)
        x = torch.cat([x, self.visual_network(frame).to(x.dtype)], dim=-1)
        mu = self.mu(x).float()
        log_std = self.log_std(x).float()
        if eps is not None and unbatched:
            eps = eps[None]
        action, logp = squashed_gaussian_sample(
            mu, log_std, self.act_limit, deterministic, with_logprob,
            generator=generator, eps=eps,
        )
        if unbatched:
            action = action[0]
            logp = logp[0] if logp is not None else None
        return action, logp


class VisualCritic(nn.Module):
    """``Q(s, a) -> (batch,)`` in f32: MLP over ``concat(features,
    action)`` with ReLU after every layer including the width-1 output
    (the reference's quirk), ⊕ the CNN embedding, then ``final``."""

    def __init__(
        self,
        features_dim: int,
        frame_shape: t.Sequence[int],
        act_dim: int,
        hidden_sizes: t.Sequence[int] = (256, 256),
        filters: t.Sequence[int] = (32, 64, 64),
        kernel_sizes: t.Sequence[int] = (8, 4, 3),
        strides: t.Sequence[int] = (4, 2, 1),
        cnn_features: int = 1,
        cnn_dense_size: int = 512,
        normalize_pixels: bool = False,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        gen = init_generator(generator)
        self.trunk = MLP(features_dim + act_dim, tuple(hidden_sizes) + (1,),
                         activate_final=True, dtype=dtype, generator=gen)
        self.visual_network = SimpleCNN(
            frame_shape, filters, kernel_sizes, strides, cnn_dense_size,
            cnn_features, normalize_pixels, dtype=dtype, generator=gen,
        )
        self.final = Dense(1 + cnn_features, 1, dtype=dtype, generator=gen)

    def forward(self, obs: MultiObservation, action: torch.Tensor) -> torch.Tensor:
        unbatched, features, frame, action = _batched(obs, action)
        x = self.trunk(torch.cat([features, action], dim=-1))
        x = torch.cat([x, self.visual_network(frame).to(x.dtype)], dim=-1)
        q = self.final(x).float().squeeze(-1)
        return q[0] if unbatched else q


class VisualDoubleCritic(nn.Module):
    """``num_qs`` independent visual critics; ``(num_qs, ...)``. The
    JAX package unrolls them as ``ensemble_{i}`` (no stacked axis)."""

    def __init__(self, features_dim: int, frame_shape: t.Sequence[int], act_dim: int,
                 num_qs: int = 2, generator: torch.Generator | None = None, **kw):
        super().__init__()
        gen = init_generator(generator)
        self.ensemble = nn.ModuleList(
            VisualCritic(features_dim, frame_shape, act_dim, generator=gen, **kw)
            for _ in range(num_qs)
        )

    def forward(self, obs: MultiObservation, action: torch.Tensor) -> torch.Tensor:
        return torch.stack([c(obs, action) for c in self.ensemble])
