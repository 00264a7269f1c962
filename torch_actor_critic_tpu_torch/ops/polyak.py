"""Polyak (exponential moving average) target update (port of
``ops/polyak.py``).

``target = polyak * target + (1 - polyak) * source``, leaf by leaf, in
the JAX package's operand order. The port updates the target in place
under ``no_grad`` (three fused multi-tensor passes) instead of building
a new pytree.
"""

from __future__ import annotations

import typing as t

import torch


@torch.no_grad()
def polyak_update_(
    source: t.Iterable[torch.Tensor], target: t.Iterable[torch.Tensor], polyak: float
) -> None:
    """``target[i] <- polyak * target[i] + (1 - polyak) * source[i]``."""
    tgt = list(target)
    src = list(source)
    if len(tgt) != len(src):
        raise ValueError(f"polyak: {len(src)} source vs {len(tgt)} target tensors")
    torch._foreach_mul_(tgt, polyak)
    torch._foreach_add_(tgt, torch._foreach_mul(src, 1.0 - polyak))
