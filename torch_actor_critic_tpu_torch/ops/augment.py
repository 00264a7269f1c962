"""DrQ random-shift augmentation for pixel RL (port of ``ops/augment.py``).

Pad the frame by ``pad`` pixels (edge-replicate) and crop back at a
per-example offset uniform over ``[0, 2·pad]`` (Kostrikov et al., "Image
Augmentation Is All You Need"). The offsets are an argument of
:func:`random_shift`, so tests hand it the very draw JAX made;
:func:`shift_offsets` draws them from an explicit ``torch.Generator``.

:func:`augment_batch` serves ``pixel_pipeline="reference"`` with
``frame_augment="shift"``; the fused pipeline shifts inside the replay
gather instead (:mod:`.pixels`).
"""

from __future__ import annotations

import torch

from torch_actor_critic_tpu_torch.core.types import Batch, MultiObservation


def shift_offsets(
    n: int, pad: int = 4, generator: torch.Generator | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """``(n, 2)`` int32 crop offsets, uniform over ``[0, 2·pad]``."""
    return torch.randint(
        0, 2 * pad + 1, (n, 2), generator=generator, device=device,
        dtype=torch.int32,
    )


def random_shift(frames: torch.Tensor, offsets: torch.Tensor, pad: int = 4) -> torch.Tensor:
    """Edge-pad ``(..., B, H, W, C)`` frames by ``pad`` and crop each
    example at its ``(dy, dx)`` row of ``offsets`` (flattened leading
    axes, ``(N, 2)``). Any dtype: shifting moves values, no arithmetic."""
    *_, h, w, c = frames.shape
    flat = frames.reshape(-1, h, w, c)
    n = flat.shape[0]
    dev = flat.device
    # Edge padding as clamped indices, then a per-example crop.
    pad_h = torch.arange(-pad, h + pad, device=dev).clamp(0, h - 1)
    pad_w = torch.arange(-pad, w + pad, device=dev).clamp(0, w - 1)
    padded = flat[:, pad_h][:, :, pad_w]
    offsets = offsets.to(device=dev, dtype=torch.long)
    rows = offsets[:, 0, None] + torch.arange(h, device=dev)  # (N, H)
    cols = offsets[:, 1, None] + torch.arange(w, device=dev)  # (N, W)
    out = padded[torch.arange(n, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]
    return out.reshape(frames.shape)


def augment_batch(
    batch: Batch, mode: str, pad: int = 4,
    generator: torch.Generator | None = None,
    offsets: torch.Tensor | None = None,
) -> Batch:
    """``mode="shift"``: random-shift ``states.frame`` and
    ``next_states.frame`` with independent offsets (DrQ's K=M=1), from
    ``offsets`` ``(2, B, 2)`` when given, else two draws from
    ``generator`` (a population's ``(P, B)`` batch: ``(2, P·B, 2)``).
    ``"none"`` and non-visual batches pass through."""
    if mode == "none" or not isinstance(batch.states, MultiObservation):
        return batch
    if mode != "shift":
        raise ValueError(f"unknown frame_augment mode {mode!r}")
    n = batch.rewards.numel()
    if offsets is None:
        dev = batch.rewards.device
        offsets = torch.stack([shift_offsets(n, pad, generator, dev) for _ in range(2)])
    return Batch(
        states=MultiObservation(
            batch.states.features, random_shift(batch.states.frame, offsets[0], pad)
        ),
        actions=batch.actions,
        rewards=batch.rewards,
        next_states=MultiObservation(
            batch.next_states.features,
            random_shift(batch.next_states.frame, offsets[1], pad),
        ),
        done=batch.done,
    )
