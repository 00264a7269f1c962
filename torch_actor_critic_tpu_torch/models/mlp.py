"""MLP trunk (port of ``models/mlp.py``).

``Dense`` is ``nn.Linear`` with torch's default init — the JAX package
copies that init (``U(±1/sqrt(fan_in))`` for weight and bias), so both
sides start from the same distribution. Parameters are stored float32
whatever the compute dtype; the matmul runs in ``dtype``, as Flax's
``nn.Dense(dtype=..., param_dtype=float32)`` does.
"""

from __future__ import annotations

import typing as t

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` over float32 parameters.

    Flax Dense kernels are ``(in, out)`` under the inner names
    ``col``/``row``/``Dense_0``; ``nn.Linear.weight`` is ``(out, in)``
    (``weights.py`` transposes when bridging).
    """

    def __init__(
        self, in_features: int, out_features: int,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class MLP(nn.Module):
    """Plain ReLU MLP; ReLU after every layer when ``activate_final``
    (the actor trunk), else after all but the last."""

    def __init__(
        self,
        in_features: int,
        hidden_sizes: t.Sequence[int],
        activate_final: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        widths = [in_features, *hidden_sizes]
        self.layers = nn.ModuleList(
            Dense(a, b, dtype=dtype) for a, b in zip(widths[:-1], widths[1:])
        )
        self.activate_final = activate_final

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if self.activate_final or i < n - 1:
                x = F.relu(x)
        return x
