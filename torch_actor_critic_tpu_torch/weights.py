"""Bridge the JAX package's Flax actor params into the port's modules.

The input is a Flax param dict whose leaves are numpy arrays (the
caller converts, e.g. ``jax.tree_util.tree_map(np.asarray, params)``);
this module never imports JAX. Flax ``Dense`` kernels are ``(in, out)``
under an inner name ``col``/``row``/``Dense_0``; ``nn.Linear.weight``
is ``(out, in)``, so kernels are transposed. LayerNorm ``scale`` is
``weight``.
"""

from __future__ import annotations

import typing as t

import numpy as np
import torch
from torch import nn

from torch_actor_critic_tpu_torch.models import build_models
from torch_actor_critic_tpu_torch.models.actor import Actor
from torch_actor_critic_tpu_torch.models.sequence import SequenceActor
from torch_actor_critic_tpu_torch.utils.config import SACConfig


def _dense(tree: t.Mapping) -> t.Dict[str, np.ndarray]:
    """``{weight, bias}`` of a wrapped Flax ``Dense`` (one inner
    ``nn.Dense`` named by its tensor-parallel role)."""
    (inner,) = tree.values()
    return {
        "weight": np.asarray(inner["kernel"]).T,
        "bias": np.asarray(inner["bias"]),
    }


def _layer_norm(tree: t.Mapping) -> t.Dict[str, np.ndarray]:
    return {"weight": np.asarray(tree["scale"]), "bias": np.asarray(tree["bias"])}


def _flat(prefix: str, parts: t.Mapping[str, np.ndarray]) -> t.Dict[str, np.ndarray]:
    return {f"{prefix}.{k}": v for k, v in parts.items()}


def _actor_state(p: t.Mapping) -> t.Dict[str, np.ndarray]:
    out: t.Dict[str, np.ndarray] = {}
    mlp = p["MLP_0"]
    for i in range(len(mlp)):
        out.update(_flat(f"trunk.layers.{i}", _dense(mlp[f"Dense_{i}"])))
    out.update(_flat("mu", _dense(p["Dense_0"])))
    out.update(_flat("log_std", _dense(p["Dense_1"])))
    return out


def _sequence_actor_state(p: t.Mapping) -> t.Dict[str, np.ndarray]:
    trunk = p["_trunk"]
    out = _flat("trunk.embed", _dense(trunk["Dense_0"]))
    out["trunk.pos_embedding"] = np.asarray(trunk["pos_embedding"])
    n_layers = sum(1 for k in trunk if k.startswith("TransformerBlock_"))
    for i in range(n_layers):
        blk = trunk[f"TransformerBlock_{i}"]
        pre = f"trunk.blocks.{i}"
        out.update(_flat(f"{pre}.ln1", _layer_norm(blk["LayerNorm_0"])))
        out.update(_flat(f"{pre}.ln2", _layer_norm(blk["LayerNorm_1"])))
        mha = blk["MultiHeadAttention_0"]
        for j, name in enumerate(("q", "k", "v", "o")):
            out.update(_flat(f"{pre}.attn.{name}", _dense(mha[f"Dense_{j}"])))
        out.update(_flat(f"{pre}.fc1", _dense(blk["Dense_0"])))
        out.update(_flat(f"{pre}.fc2", _dense(blk["Dense_1"])))
    out.update(_flat("trunk.ln_f", _layer_norm(trunk["LayerNorm_0"])))
    out.update(_flat("mu", _dense(p["_mu"])))
    out.update(_flat("log_std", _dense(p["_log_std"])))
    return out


def load_jax_actor_params(module: nn.Module, params_tree: t.Mapping) -> nn.Module:
    """Copy a Flax actor param dict (``{"params": ...}`` or its inner
    dict, numpy leaves) into ``module`` in place; every parameter must
    be covered (strict)."""
    p = params_tree.get("params", params_tree)
    if isinstance(module, SequenceActor):
        state = _sequence_actor_state(p)
    elif isinstance(module, Actor):
        state = _actor_state(p)
    else:
        raise TypeError(f"no Flax param mapping for {type(module).__name__}")
    ref = module.state_dict()
    module.load_state_dict(
        {
            k: torch.as_tensor(np.array(v), dtype=ref[k].dtype)  # np.array: a writable copy
            for k, v in state.items()
        },
        strict=True,
    )
    return module


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
    actor = build_models(config, obs_shape, act_dim, act_limit)
    return load_jax_actor_params(actor, params_tree)
