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
import warnings

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

    def named_leaves(self) -> t.List[t.Tuple[str, t.Any]]:
        """``(name, leaf)`` in :meth:`leaves`' order; a
        :class:`MultiObservation` field's leaves are ``<field>.features``
        and ``<field>.frame``."""
        out = []
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if isinstance(value, MultiObservation):
                out += [(f"{f.name}.features", value.features), (f"{f.name}.frame", value.frame)]
            else:
                out.append((f.name, value))
        return out


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

    def state_dict(self) -> dict:
        """A host snapshot for a checkpoint: the cursor and rows
        ``[0, size)`` of every leaf (the rows past ``size`` are never
        written, so they are zero; :func:`~..buffer.replay.load_buffer_`
        zeroes them)."""
        return {
            "capacity": self.capacity, "ptr": self.ptr, "size": self.size,
            "leaves": {name: leaf[:self.size].detach().to("cpu", copy=True)
                       for name, leaf in self.data.named_leaves()},
        }


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

    def state_dict(self) -> dict:
        """A host snapshot of the whole state, for a checkpoint: the
        three networks' state dicts, each Adam's (moments and ``step``
        tensor), ``log_alpha``, the step count and the generator's state
        (a uint8 tensor) with its device type."""
        def host(x):
            return x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x

        def adam(opt):
            saved = opt.state_dict()
            return {"state": {i: {k: host(v) for k, v in st.items()}
                              for i, st in saved["state"].items()},
                    "param_groups": saved["param_groups"]}

        return {
            "step": int(self.step),
            **{name: {k: host(v) for k, v in getattr(self, name).state_dict().items()}
               for name in ("actor", "critic", "target_critic")},
            **{name: adam(getattr(self, name)) for name in ("pi_opt", "q_opt", "alpha_opt")},
            "log_alpha": host(self.log_alpha),
            "generator": self.generator.get_state(),
            "generator_device": self.generator.device.type,
        }

    def load_state_dict_(self, saved: t.Mapping[str, t.Any]) -> None:
        """Restore :meth:`state_dict`'s snapshot **in place**, from any
        device: the modules through ``load_state_dict`` (which copies),
        every Adam state tensor by ``copy_`` into the tensor the
        optimizer (and a captured burst's CUDA graph) holds,
        ``log_alpha`` by ``copy_``, the generator by ``set_state``, and
        ``step``. An Adam without state yet (a fresh learner, which no
        graph has captured) gets new tensors, placed as it would place
        them: ``step`` on the parameter's device when capturable, on the
        CPU otherwise. A snapshot whose generator lived on another
        device type leaves the generator as it is (the two devices'
        streams differ anyway).

        One case cannot be written in place: a snapshot whose Adam had
        no state yet clears the live Adam's (a fresh Adam, as the
        snapshot's was). A burst graph that held the cleared tensors
        then no longer serves (its key, :func:`~..sac.algorithm.
        graph_key`, holds them) and the next burst captures anew. A
        snapshot of another model raises (``load_state_dict``'s
        ``RuntimeError``, or ``ValueError`` for an optimizer)."""
        for name in ("actor", "critic", "target_critic"):
            getattr(self, name).load_state_dict(saved[name])
        with torch.no_grad():
            self.log_alpha.copy_(saved["log_alpha"])
        for name in ("pi_opt", "q_opt", "alpha_opt"):
            _load_adam_(getattr(self, name), saved[name])
        if saved["generator_device"] == self.generator.device.type:
            self.generator.set_state(saved["generator"])
        else:
            warnings.warn(
                f"the checkpoint's learner generator lived on "
                f"{saved['generator_device']!r}; this learner's is on "
                f"{self.generator.device.type!r} and keeps its own state"
            )
        self.step = int(saved["step"])


def _load_adam_(opt: torch.optim.Optimizer, saved: t.Mapping[str, t.Any]) -> None:
    """One Adam's snapshot into ``opt`` (see
    :meth:`TrainState.load_state_dict_`)."""
    groups = list(zip(opt.param_groups, saved["param_groups"], strict=True))
    params = [(group, p) for group, _ in groups for p in group["params"]]
    ids = [i for _, g in groups for i in g["params"]]
    if len(ids) != len(params):
        raise ValueError(f"optimizer snapshot holds {len(ids)} parameters, "
                         f"the optimizer {len(params)}")
    if not saved["state"]:
        opt.state.clear()
        return
    for i, (group, p) in zip(ids, params):
        src = saved["state"][i]
        dst = opt.state.get(p)
        if dst:
            if dst.keys() != src.keys():
                raise ValueError(f"optimizer state keys {sorted(src)} != {sorted(dst)}")
            for k, v in src.items():
                if dst[k].shape != v.shape:
                    raise ValueError(f"optimizer state {k!r}: shape {tuple(v.shape)} != "
                                     f"{tuple(dst[k].shape)}")
                dst[k].copy_(v)
        else:
            on_param = group.get("capturable") or group.get("fused")
            opt.state[p] = {
                k: v.to(p.device if (k != "step" or on_param) else "cpu", copy=True)
                for k, v in src.items()
            }
