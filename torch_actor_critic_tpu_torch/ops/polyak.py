"""Polyak (exponential moving average) target update (port of
``ops/polyak.py``).

``target = polyak * target + (1 - polyak) * source``, leaf by leaf, in
the JAX package's operand order. The port updates the target in place
under ``no_grad`` (three fused multi-tensor passes) instead of building
a new pytree. :func:`polyak_select_` is TD3's conditional update: the
same values where a device predicate holds, the target untouched where
it does not.
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


@torch.no_grad()
def polyak_select_(
    source: t.Iterable[torch.Tensor], target: t.Iterable[torch.Tensor], polyak: float,
    pred: torch.Tensor,
) -> None:
    """:func:`polyak_update_` where the 0-d bool ``pred`` holds, nothing
    where it does not, decided on the device (a CUDA graph replays it).
    The candidate is computed out of place with the same passes, so an
    applied update is bitwise :func:`polyak_update_`'s; ``torch.where``
    then writes it, or the target's own bits, into the target."""
    tgt = list(target)
    src = list(source)
    if len(tgt) != len(src):
        raise ValueError(f"polyak: {len(src)} source vs {len(tgt)} target tensors")
    new = torch._foreach_mul(tgt, polyak)
    torch._foreach_add_(new, torch._foreach_mul(src, 1.0 - polyak))
    select_(pred, new, tgt, out=tgt)


@torch.no_grad()
def select_(
    pred: torch.Tensor,
    on_true: t.Sequence[torch.Tensor],
    on_false: t.Sequence[torch.Tensor],
    out: t.Sequence[torch.Tensor],
) -> None:
    """``out[i] <- where(pred, on_true[i], on_false[i])``, one kernel per
    tensor (``out[i]`` may be either input): exact for every value, -0.0
    and NaN included, which a 0/1 ``lerp`` or ``a * p + b * (1 - p)`` is
    not."""
    for a, b, o in zip(on_true, on_false, out, strict=True):
        torch.where(pred, a, b, out=o)
