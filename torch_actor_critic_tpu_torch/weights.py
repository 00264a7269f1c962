"""Bridge the JAX package's Flax params and learner state into the
port's modules.

The input is a Flax param dict (or a JAX ``TrainState``) whose leaves
are numpy arrays (the caller converts, e.g.
``jax.tree_util.tree_map(np.asarray, params)``); this module never
imports JAX. Flax ``Dense`` kernels are ``(in, out)`` under an inner
name ``col``/``row``/``Dense_0``; ``nn.Linear.weight`` is ``(out, in)``,
so kernels are transposed (on their last two axes). LayerNorm ``scale``
is ``weight``. A vmapped Flax critic ensemble carries a leading
``num_qs`` axis on every leaf under ``ensemble``, and so do the port's
stacked ``DoubleCritic``/``SequenceDoubleCritic``: each leaf loads as it
is. The visual critic ensemble is unrolled in both (``ensemble_{i}``
subtrees, ``ensemble.{i}`` members). Conv kernels ``(kh, kw, in, out)`` become
``nn.Conv2d`` weights ``(out, in, kh, kw)``. optax's Adam
state (``mu``/``nu``/``count``) maps through the same names onto
``torch.optim.Adam``'s ``exp_avg``/``exp_avg_sq``/``step``. The
deterministic (TD3) actors have one head, ``Dense_0`` -> ``mu``.
"""

from __future__ import annotations

import typing as t

import numpy as np
import torch
from torch import nn

from torch_actor_critic_tpu_torch.core.types import TrainState
from torch_actor_critic_tpu_torch.models import build_actor
from torch_actor_critic_tpu_torch.models.actor import Actor, DeterministicActor
from torch_actor_critic_tpu_torch.models.critic import DoubleCritic
from torch_actor_critic_tpu_torch.models.sequence import (
    SequenceActor,
    SequenceDoubleCritic,
)
from torch_actor_critic_tpu_torch.models.visual import (
    DeterministicVisualActor,
    VisualActor,
    VisualDoubleCritic,
)
from torch_actor_critic_tpu_torch.utils.config import SACConfig


def _dense(tree: t.Mapping) -> t.Dict[str, np.ndarray]:
    """``{weight, bias}`` of a wrapped Flax ``Dense`` (one inner
    ``nn.Dense`` named by its tensor-parallel role)."""
    (inner,) = tree.values()
    return {
        "weight": np.swapaxes(np.asarray(inner["kernel"]), -1, -2),
        "bias": np.asarray(inner["bias"]),
    }


def _layer_norm(tree: t.Mapping) -> t.Dict[str, np.ndarray]:
    return {"weight": np.asarray(tree["scale"]), "bias": np.asarray(tree["bias"])}


def _flat(prefix: str, parts: t.Mapping[str, np.ndarray]) -> t.Dict[str, np.ndarray]:
    return {f"{prefix}.{k}": v for k, v in parts.items()}


def _mlp_state(prefix: str, mlp: t.Mapping) -> t.Dict[str, np.ndarray]:
    out: t.Dict[str, np.ndarray] = {}
    for i in range(len(mlp)):
        out.update(_flat(f"{prefix}.layers.{i}", _dense(mlp[f"Dense_{i}"])))
    return out


def _actor_state(p: t.Mapping) -> t.Dict[str, np.ndarray]:
    """A flat or a visual actor: ``MLP_0`` trunk (plus the CNN
    ``visual_network``), ``Dense_0``/``Dense_1`` heads (a deterministic
    actor's ``Dense_0`` alone)."""
    out = _mlp_state("trunk", p["MLP_0"])
    if "visual_network" in p:
        out.update(_cnn_state("visual_network", p["visual_network"]))
    out.update(_flat("mu", _dense(p["Dense_0"])))
    if "Dense_1" in p:
        out.update(_flat("log_std", _dense(p["Dense_1"])))
    return out


def _cnn_state(prefix: str, cnn: t.Mapping) -> t.Dict[str, np.ndarray]:
    """A Flax ``SimpleCNN``: ``conv_{i}`` kernels ``(kh, kw, in, out)``
    -> ``(out, in, kh, kw)``, then the two wrapped Dense layers."""
    out: t.Dict[str, np.ndarray] = {}
    n_convs = sum(1 for k in cnn if k.startswith("conv_"))
    for i in range(n_convs):
        conv = cnn[f"conv_{i}"]
        out[f"{prefix}.convs.{i}.weight"] = np.asarray(conv["kernel"]).transpose(3, 2, 0, 1)
        out[f"{prefix}.convs.{i}.bias"] = np.asarray(conv["bias"])
    out.update(_flat(f"{prefix}.dense", _dense(cnn["Dense_0"])))
    out.update(_flat(f"{prefix}.out", _dense(cnn["Dense_1"])))
    return out


def _trunk_state(prefix: str, trunk: t.Mapping) -> t.Dict[str, np.ndarray]:
    out = _flat(f"{prefix}.embed", _dense(trunk["Dense_0"]))
    out[f"{prefix}.pos_embedding"] = np.asarray(trunk["pos_embedding"])
    n_layers = sum(1 for k in trunk if k.startswith("TransformerBlock_"))
    for i in range(n_layers):
        blk = trunk[f"TransformerBlock_{i}"]
        pre = f"{prefix}.blocks.{i}"
        out.update(_flat(f"{pre}.ln1", _layer_norm(blk["LayerNorm_0"])))
        out.update(_flat(f"{pre}.ln2", _layer_norm(blk["LayerNorm_1"])))
        mha = blk["MultiHeadAttention_0"]
        for j, name in enumerate(("q", "k", "v", "o")):
            out.update(_flat(f"{pre}.attn.{name}", _dense(mha[f"Dense_{j}"])))
        out.update(_flat(f"{pre}.fc1", _dense(blk["Dense_0"])))
        out.update(_flat(f"{pre}.fc2", _dense(blk["Dense_1"])))
    out.update(_flat(f"{prefix}.ln_f", _layer_norm(trunk["LayerNorm_0"])))
    return out


def _sequence_actor_state(p: t.Mapping) -> t.Dict[str, np.ndarray]:
    out = _trunk_state("trunk", p["_trunk"])
    out.update(_flat("mu", _dense(p["_mu"])))
    out.update(_flat("log_std", _dense(p["_log_std"])))
    return out


def _critic_state(module: nn.Module, p: t.Mapping) -> t.Dict[str, np.ndarray]:
    """Names of the port's ensemble critic -> arrays of the Flax tree
    ``p``: its ``ensemble`` subtree already carries the stacked
    critics' num_qs axis; a visual ensemble is unrolled into
    ``ensemble_{i}`` subtrees."""
    if isinstance(module, VisualDoubleCritic):
        out: t.Dict[str, np.ndarray] = {}
        for i in range(len(module.ensemble)):
            pre, one = f"ensemble.{i}", p[f"ensemble_{i}"]
            out.update(_mlp_state(f"{pre}.trunk", one["MLP_0"]))
            out.update(_cnn_state(f"{pre}.visual_network", one["visual_network"]))
            out.update(_flat(f"{pre}.final", _dense(one["final"])))
        return out
    stacked = p["ensemble"]
    if isinstance(module, SequenceDoubleCritic):
        out = _trunk_state("trunk", stacked["SequenceTrunk_0"])
        out.update(_flat("fc", _dense(stacked["Dense_0"])))
        out.update(_flat("out", _dense(stacked["Dense_1"])))
        return out
    return _mlp_state("trunk", stacked["MLP_0"])


# The actors whose Flax tree is ``MLP_0`` (+ ``visual_network``) and Dense heads.
_MLP_ACTORS = (Actor, VisualActor, DeterministicActor, DeterministicVisualActor)


def _named_arrays(module: nn.Module, params_tree: t.Mapping) -> t.Dict[str, np.ndarray]:
    """The port's parameter names of ``module`` -> the matching arrays
    of a Flax tree (params, or an optimizer moment of the same shape)."""
    p = params_tree.get("params", params_tree)
    if isinstance(module, SequenceActor):
        return _sequence_actor_state(p)
    if isinstance(module, _MLP_ACTORS):
        return _actor_state(p)
    if isinstance(module, (DoubleCritic, SequenceDoubleCritic, VisualDoubleCritic)):
        return _critic_state(module, p)
    raise TypeError(f"no Flax param mapping for {type(module).__name__}")


def _load(module: nn.Module, params_tree: t.Mapping) -> nn.Module:
    state = _named_arrays(module, params_tree)
    ref = module.state_dict()
    module.load_state_dict(
        {
            k: torch.as_tensor(np.array(v), dtype=ref[k].dtype, device=ref[k].device)
            for k, v in state.items()  # np.array: a writable copy
        },
        strict=True,
    )
    return module


def load_jax_actor_params(module: nn.Module, params_tree: t.Mapping) -> nn.Module:
    """Copy a Flax actor param dict (``{"params": ...}`` or its inner
    dict, numpy leaves) into ``module`` in place; every parameter must
    be covered (strict)."""
    if not isinstance(module, (SequenceActor, *_MLP_ACTORS)):
        raise TypeError(f"no Flax actor mapping for {type(module).__name__}")
    return _load(module, params_tree)


def load_jax_critic_params(module: nn.Module, params_tree: t.Mapping) -> nn.Module:
    """Copy a Flax ``DoubleCritic``/``SequenceDoubleCritic`` param dict
    into the port's stacked ensemble in place, the ``ensemble`` subtree's
    num_qs axis as it is (a ``VisualDoubleCritic``'s member ``i`` from
    ``ensemble_{i}``) (strict)."""
    if not isinstance(module, (DoubleCritic, SequenceDoubleCritic, VisualDoubleCritic)):
        raise TypeError(f"no Flax critic mapping for {type(module).__name__}")
    return _load(module, params_tree)


def _adam_state(opt_state) -> t.Any:
    """The ``ScaleByAdamState`` (``count``/``mu``/``nu``) inside an optax
    ``adam`` chain state."""
    for part in opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,):
        if all(hasattr(part, f) for f in ("count", "mu", "nu")):
            return part
    raise TypeError(f"no Adam moments in optimizer state {type(opt_state).__name__}")


def _has_adam_state(opt_state) -> bool:
    parts = opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,)
    return any(all(hasattr(part, f) for f in ("count", "mu", "nu")) for part in parts)


def _load_adam(opt: torch.optim.Adam, module_or_param, opt_state) -> None:
    adam = _adam_state(opt_state)
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    if isinstance(module_or_param, nn.Module):
        mu = _named_arrays(module_or_param, adam.mu)
        nu = _named_arrays(module_or_param, adam.nu)
        pairs = [(p, mu[n], nu[n]) for n, p in module_or_param.named_parameters()]
    else:
        pairs = [(module_or_param, adam.mu, adam.nu)]
    capturable = opt.defaults["capturable"]  # a capturable Adam counts on the device
    for p, m, v in pairs:
        opt.state[p] = {
            "step": step.to(p.device) if capturable else step.clone(),
            "exp_avg": torch.as_tensor(np.array(m), dtype=p.dtype, device=p.device),
            "exp_avg_sq": torch.as_tensor(np.array(v), dtype=p.dtype, device=p.device),
        }


def train_state_from_jax(
    jax_state, sac, actor: nn.Module, critic: nn.Module,
    generator: torch.Generator,
) -> TrainState:
    """The port's :class:`TrainState` carrying a JAX ``TrainState``
    (numpy leaves): actor, critic and target critic params (and a TD3
    state's target actor), ``log_alpha``, every Adam state and the step
    (host and device), over the built ``actor``/``critic`` (on their
    device) and the learner ``sac`` (a SAC or a TD3). A TD3 state's
    temperature Adam is optax's ``EmptyState``: the port's stays empty.
    Both sides then start an update from the same state."""
    state = sac.init_state(actor, critic, generator)
    if (jax_state.target_actor_params is None) != (state.target_actor is None):
        raise ValueError("the JAX state and the learner disagree on a target actor")
    load_jax_actor_params(actor, jax_state.actor_params)
    load_jax_critic_params(critic, jax_state.critic_params)
    load_jax_critic_params(state.target_critic, jax_state.target_critic_params)
    if state.target_actor is not None:
        load_jax_actor_params(state.target_actor, jax_state.target_actor_params)
    with torch.no_grad():
        state.log_alpha.fill_(float(np.asarray(jax_state.log_alpha)))
    _load_adam(state.pi_opt, actor, jax_state.pi_opt_state)
    _load_adam(state.q_opt, critic, jax_state.q_opt_state)
    if _has_adam_state(jax_state.alpha_opt_state):
        _load_adam(state.alpha_opt, state.log_alpha, jax_state.alpha_opt_state)
    state.step = int(np.asarray(jax_state.step))
    state.device_step.fill_(state.step)
    return state


def actor_from_jax(
    params_tree: t.Mapping,
    config: SACConfig,
    obs_shape: t.Sequence[int],
    act_dim: int,
    act_limit: float,
) -> nn.Module:
    """Build the port's actor for ``config``/``obs_shape`` (the same
    dispatch as the JAX trainer's ``build_models``) and load the Flax
    params into it."""
    actor = build_actor(config, obs_shape, act_dim, act_limit)
    return load_jax_actor_params(actor, params_tree)
