"""Core state types of the learner (port of ``core/types.py``).

Plain dataclasses of tensors in place of the JAX package's pytrees.
``Batch`` and ``BufferState`` keep the JAX field names and layouts;
``TrainState`` holds the live modules and optimizers (PyTorch's
parameters are mutable, so an update changes the state in place and
returns it) and the ``torch.Generator`` that replaces the PRNG key.

An observation is a tensor (flat or history) or a
:class:`MultiObservation` (features + uint8 HWC frame);
:func:`tree_map` and :func:`tree_leaves` walk either, so one ``Batch``
serves both, as one pytree does in the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import typing as t

import torch
from torch import nn


@dataclasses.dataclass
class MultiObservation:
    """Mixed proprioceptive + pixel observation: ``features`` a flat
    float vector, ``frame`` an HWC image (uint8 from the env and in the
    replay ring; float once the fused pixel pipeline has decoded it).
    The leaves may be tensors, numpy arrays or, for a spec, shapes."""

    features: t.Any
    frame: t.Any

    def map(self, fn) -> "MultiObservation":
        return MultiObservation(fn(self.features), fn(self.frame))


def tree_map(fn, obs):
    """``fn`` over the leaves of an observation (a :class:`MultiObservation`
    or a single array)."""
    return obs.map(fn) if isinstance(obs, MultiObservation) else fn(obs)


def tree_leaves(obs) -> list:
    return [obs.features, obs.frame] if isinstance(obs, MultiObservation) else [obs]


@dataclasses.dataclass
class Batch:
    """A batch of transitions (or a chunk of them to push): leading
    axis = transition. ``done`` is the Bellman mask in f32;
    ``states``/``next_states`` are observations (tensor or
    :class:`MultiObservation`)."""

    states: t.Any
    actions: torch.Tensor
    rewards: torch.Tensor
    next_states: t.Any
    done: torch.Tensor

    def map(self, fn) -> "Batch":
        """``fn`` over every leaf, into :class:`MultiObservation` fields."""
        return Batch(*(tree_map(fn, getattr(self, f.name))
                       for f in dataclasses.fields(self)))

    def leaves(self) -> list:
        return [leaf for f in dataclasses.fields(self)
                for leaf in tree_leaves(getattr(self, f.name))]


@dataclasses.dataclass
class BufferState:
    """Replay ring on the device plus its cursor. ``ptr``/``size`` are
    host integers: the host drives every push, so it knows them without
    reading the device. ``device_size`` mirrors ``size`` as a 0-d int64
    tensor on the ring's device, which sampling reads (the JAX package
    traces ``size`` as a device scalar): a captured update reads it at
    replay time, so :func:`~..buffer.replay.push` updates it in place
    and every ``BufferState`` of one ring shares that one tensor."""

    data: Batch
    ptr: int  # next write slot
    size: int  # valid rows (<= capacity)
    device_size: torch.Tensor  # 0-d int64, == size

    @property
    def capacity(self) -> int:
        return self.data.rewards.shape[0]

    @property
    def visual(self) -> bool:
        return isinstance(self.data.states, MultiObservation)

    def clone(self) -> "BufferState":
        """An independent copy: every ring leaf and the device size."""
        return BufferState(self.data.map(torch.clone), self.ptr, self.size,
                           self.device_size.clone())


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

    def clone(self) -> "TrainState":
        """An independent copy to run from: the modules, the target
        critic, ``log_alpha``, each Adam state (its moments and its
        ``step``, a device tensor when capturable) over the copied
        parameters, and a new generator at this one's state."""
        gen = torch.Generator(device=self.generator.device)
        gen.set_state(self.generator.get_state())
        return copy.deepcopy(self, memo={id(self.generator): gen})
