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
    and every ``BufferState`` of one ring shares that one tensor.

    A population's rings are one ``BufferState`` whose leaves are ``(P,
    capacity, ...)`` (:attr:`members` is ``P``): the members push in
    lockstep, so one cursor serves them all."""

    data: Batch
    ptr: int  # next write slot
    size: int  # valid rows (<= capacity)
    device_size: torch.Tensor  # 0-d int64, == size

    @property
    def capacity(self) -> int:
        return self.data.rewards.shape[-1]

    @property
    def members(self) -> int | None:
        """``P`` for a population's stacked rings, else None."""
        rewards = self.data.rewards
        return rewards.shape[0] if rewards.dim() == 2 else None

    @property
    def visual(self) -> bool:
        return isinstance(self.data.states, MultiObservation)

    def clone(self) -> "BufferState":
        """An independent copy: every ring leaf and the device size."""
        return BufferState(self.data.map(torch.clone), self.ptr, self.size,
                           self.device_size.clone())

    def state_dict(self, host: t.Dict[str, torch.Tensor] | None = None) -> dict:
        """A host snapshot for a checkpoint: the cursor and rows
        ``[0, size)`` of every leaf (the rows past ``size`` are never
        written, so they are zero; :func:`~..buffer.replay.load_buffer_`
        zeroes them).

        ``host`` holds reusable host tensors by leaf name (a
        checkpointer's, kept across saves, pinned for a ring on the
        card; without it the buffers are this snapshot's own): a leaf
        whose entry is missing or of another shape or dtype gets one of
        the ring's shape, the rows are copied into it, and the
        snapshot's leaf is a tensor over the first ``size`` rows of its
        storage, so ``torch.save`` writes those rows alone. A
        population's leaf is ``(P, size, ...)``, rows ``[0, size)`` of
        every member, in a host buffer of exactly that shape. The copy is
        complete when this returns."""
        keep = host is not None
        host = host if keep else {}
        leaves = {}
        for name, leaf in self.data.named_leaves():
            shape = leaf.shape
            if self.members is not None:
                shape = (shape[0], self.size, *shape[2:])
            buf = host.get(name)
            if buf is None or buf.shape != shape or buf.dtype != leaf.dtype:
                buf = host[name] = torch.empty(shape, dtype=leaf.dtype,
                                               pin_memory=keep and leaf.is_cuda)
            if self.members is not None:
                buf.copy_(leaf[:, :self.size], non_blocking=True)
                leaves[name] = buf
                continue
            buf[:self.size].copy_(leaf[:self.size], non_blocking=True)
            leaves[name] = _leading_rows(buf, self.size)
        if self.device_size.is_cuda:
            torch.cuda.current_stream(self.device_size.device).synchronize()
        return {"capacity": self.capacity, "ptr": self.ptr, "size": self.size,
                "leaves": leaves}


def _leading_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` rows of contiguous ``x`` as a tensor over a slice
    of its storage: shares its memory, and ``torch.save`` writes only
    those rows (a view ``x[:n]`` would write the whole storage)."""
    shape = (n, *x.shape[1:])
    if n == 0:
        return torch.empty(shape, dtype=x.dtype)
    nbytes = n * x[0].numel() * x.element_size()
    return torch.empty(0, dtype=x.dtype).set_(x.untyped_storage()[:nbytes], 0, shape)


@dataclasses.dataclass
class TrainState:
    """The complete learner state: actor, critic, target critic (and,
    for TD3, target actor), one Adam per network, the entropy
    temperature, the gradient-step count and the generator every update
    draws its indices and noise from.

    ``step`` is the host's count; ``device_step`` mirrors it as a 0-d
    int64 tensor on the critic's device, which an update increments in
    place: a captured update reads it at replay time (TD3's policy delay
    is a select on it), as sampling reads ``BufferState.device_size``.
    ``target_actor`` is ``None`` for SAC, as the JAX state's
    ``target_actor_params``. ``hyperparams`` holds per-run
    hyperparameters as f32 device tensors (``(P,)`` in a population,
    one value per member), read by the update in place of the config's
    scalars; ``None`` (the default) uses the config.

    A population's state is this class over member-stacked modules
    (:mod:`..models.population`): every parameter, Adam moment,
    ``log_alpha`` and hyperparameter has the member axis first; ``step``
    and ``device_step`` are the lockstep count, and ``generator`` draws
    every member's rows and noise in one draw."""

    step: int
    actor: nn.Module
    critic: nn.Module
    target_critic: nn.Module
    pi_opt: torch.optim.Adam
    q_opt: torch.optim.Adam
    log_alpha: torch.Tensor  # 0-d f32 leaf; exp() is the temperature
    alpha_opt: torch.optim.Adam
    generator: torch.Generator
    device_step: torch.Tensor | None = None  # 0-d int64, == step; None: made from step
    target_actor: nn.Module | None = None
    hyperparams: t.Dict[str, torch.Tensor] | None = None

    def __post_init__(self):
        if self.device_step is None:
            device = next(self.critic.parameters()).device
            self.device_step = torch.full((), int(self.step), dtype=torch.int64, device=device)

    def module_names(self) -> t.Tuple[str, ...]:
        """The networks' fields: actor, critic, target critic, then the
        target actor when there is one."""
        names = ("actor", "critic", "target_critic")
        return names + (("target_actor",) if self.target_actor is not None else ())

    def modules(self) -> t.List[nn.Module]:
        return [getattr(self, name) for name in self.module_names()]

    def clone(self) -> "TrainState":
        """An independent copy to run from: the modules, the targets,
        ``log_alpha``, each Adam state (its moments and its ``step``, a
        device tensor when capturable) over the copied parameters, the
        device step, and a new generator at this one's state."""
        gen = torch.Generator(device=self.generator.device)
        gen.set_state(self.generator.get_state())
        return copy.deepcopy(self, memo={id(self.generator): gen})

    def state_dict(self) -> dict:
        """A host snapshot of the whole state, for a checkpoint: the
        networks' state dicts (``target_actor`` only when there is one),
        each Adam's (moments and ``step`` tensor), ``log_alpha``, the
        step count and the device step, the generator's state (a
        uint8 tensor) with its device type, and the hyperparameters when
        there are any."""
        def host(x):
            return x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x

        def adam(opt):
            saved = opt.state_dict()
            return {"state": {i: {k: host(v) for k, v in st.items()}
                              for i, st in saved["state"].items()},
                    "param_groups": saved["param_groups"]}

        return {
            "step": int(self.step),
            "device_step": host(self.device_step),
            **{name: {k: host(v) for k, v in getattr(self, name).state_dict().items()}
               for name in self.module_names()},
            **{name: adam(getattr(self, name)) for name in ("pi_opt", "q_opt", "alpha_opt")},
            "log_alpha": host(self.log_alpha),
            "generator": self.generator.get_state(),
            "generator_device": self.generator.device.type,
            **({} if self.hyperparams is None else
               {"hyperparams": {k: host(v) for k, v in self.hyperparams.items()}}),
        }

    def load_state_dict_(self, saved: t.Mapping[str, t.Any]) -> None:
        """Restore :meth:`state_dict`'s snapshot **in place**, from any
        device: the modules through ``load_state_dict`` (which copies),
        every Adam state tensor by ``copy_`` into the tensor the
        optimizer (and a captured burst's CUDA graph) holds,
        ``log_alpha`` and ``device_step`` by ``copy_`` (a snapshot
        without ``device_step`` gives it ``step``), the generator by
        ``set_state``, and ``step``. An Adam without state yet (a fresh
        learner, which no graph has captured) gets new tensors, placed
        as it would place them: ``step`` on the parameter's device when
        capturable, on the CPU otherwise. A snapshot whose generator
        lived on another device type leaves the generator as it is (the
        two devices' streams differ anyway).

        One case cannot be written in place: a snapshot whose Adam had
        no state yet clears the live Adam's (a fresh Adam, as the
        snapshot's was). A burst graph that held the cleared tensors
        then no longer serves (its key, :func:`~..sac.algorithm.
        graph_key`, holds them) and the next burst captures anew. A
        snapshot of another model raises (``load_state_dict``'s
        ``RuntimeError``, or ``ValueError`` for an optimizer, or for a
        target actor or hyperparameters present on one side only).
        Hyperparameters are copied in place."""
        if ("target_actor" in saved) != (self.target_actor is not None):
            raise ValueError(
                "learner snapshot and state disagree on a target actor (TD3 has "
                "one, SAC none): a snapshot of another algorithm"
            )
        saved_hp = saved.get("hyperparams")
        if (saved_hp is None) != (self.hyperparams is None) or (
                saved_hp is not None and saved_hp.keys() != self.hyperparams.keys()):
            raise ValueError(
                f"learner snapshot hyperparameters {sorted(saved_hp or ())} != the "
                f"state's {sorted(self.hyperparams or ())}")
        for name in self.module_names():
            getattr(self, name).load_state_dict(saved[name])
        with torch.no_grad():
            self.log_alpha.copy_(saved["log_alpha"])
            self.device_step.copy_(saved.get("device_step", torch.tensor(saved["step"])))
            for k, v in (saved_hp or {}).items():
                self.hyperparams[k].copy_(v)
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


@dataclasses.dataclass
class PBTState:
    """On-device population-based-training bookkeeping (port of the JAX
    ``PBTState``): ``return_ema`` ``(P,)`` f32, the per-member episode
    return EMA the exploit ranks on; ``ema_count`` ``(P,)`` int32, the
    epochs that contributed (a member with none is unranked, and exploit
    waits until every member is ranked); ``generator``, the stream of
    the winner picks and the explore factors (the JAX state's key)."""

    return_ema: torch.Tensor
    ema_count: torch.Tensor
    generator: torch.Generator

    @classmethod
    def zeros(cls, members: int, generator: torch.Generator) -> "PBTState":
        device = generator.device
        return cls(torch.zeros(members, dtype=torch.float32, device=device),
                   torch.zeros(members, dtype=torch.int32, device=device), generator)

    def state_dict(self) -> dict:
        return {"return_ema": self.return_ema.detach().to("cpu", copy=True),
                "ema_count": self.ema_count.detach().to("cpu", copy=True),
                "generator": self.generator.get_state()}

    def load_state_dict_(self, saved: t.Mapping[str, t.Any]) -> None:
        """Restore :meth:`state_dict`'s snapshot in place."""
        self.return_ema.copy_(saved["return_ema"])
        self.ema_count.copy_(saved["ema_count"])
        self.generator.set_state(saved["generator"])


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
