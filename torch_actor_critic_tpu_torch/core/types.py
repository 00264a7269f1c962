"""Core state types of the learner (port of ``core/types.py``).

Plain dataclasses of tensors in place of the JAX package's pytrees.
``Batch`` and ``BufferState`` keep the JAX field names and layouts;
``TrainState`` holds the live modules and optimizers (PyTorch's
parameters are mutable, so an update changes the state in place and
returns it) and the ``torch.Generator`` that replaces the PRNG key.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass
class Batch:
    """A batch of transitions (or a chunk of them to push): leading
    axis = transition. ``done`` is the Bellman mask in f32."""

    states: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    next_states: torch.Tensor
    done: torch.Tensor

    def map(self, fn) -> "Batch":
        return Batch(*(fn(getattr(self, f.name)) for f in dataclasses.fields(self)))


@dataclasses.dataclass
class BufferState:
    """Replay ring on the device plus its cursor. ``ptr``/``size`` are
    host integers: the host drives every push, so it knows them without
    reading the device (the JAX package traces them as device scalars)."""

    data: Batch
    ptr: int  # next write slot
    size: int  # valid rows (<= capacity)

    @property
    def capacity(self) -> int:
        return self.data.rewards.shape[0]


@dataclasses.dataclass
class TrainState:
    """The complete learner state: actor, critic, target critic, one
    Adam per network, the entropy temperature, the gradient-step count
    and the generator every update draws its indices and noise from."""

    step: int
    actor: nn.Module
    critic: nn.Module
    target_critic: nn.Module
    pi_opt: torch.optim.Adam
    q_opt: torch.optim.Adam
    log_alpha: torch.Tensor  # 0-d f32 leaf; exp() is the temperature
    alpha_opt: torch.optim.Adam
    generator: torch.Generator
