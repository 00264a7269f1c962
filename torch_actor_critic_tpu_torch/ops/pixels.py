"""The fused replay-gather → DrQ shift → uint8 decode → cast pixel
pipeline: the plain version and the CUDA kernel K1 (port of
``ops/pixels.py``).

For example ``b``, stack slot ``s``, row ``y``, column ``x``, channel
``c``::

    out[b, y, x, s·C + c] = decode(ring[rows[b, s], sy, sx, c])
    rows[b, s] = (idx[b] - (S-1-s)) mod capacity      (floor-mod)
    sy = clip(y + off[b, 0] - pad, 0, H-1)            (sx likewise)
    decode(v) = (out_dtype) v, then / (out_dtype) 255 when normalize

- :func:`gather_frames_reference` — the plain PyTorch version (gather,
  clipped-index shift, cast), kept beside the kernel; the CPU tests hold
  it bitwise to the JAX package's.
- :func:`fused_frame_gather` — the dispatch: CPU tensors run the plain
  version, CUDA tensors the hand-written kernel ``csrc/pixels.cu`` (the
  port of the TPU kernel ``_pixel_kernel``); a build or launch failure
  raises, nothing falls back. (The kernel stages a block's source rows
  in shared memory, so it refuses a frame whose S stack rows exceed
  the card's 227 KB of it.) Under a
  :class:`~..telemetry.costmodel.CostCount` both routes count K1's
  formula work and none of their own ops.
- :func:`fused_frame_gather_pair` — the same for a batch's two frame
  leaves (states, next states) at the same rows: one launch for both.
- :func:`member_frame_gather_pair` — a population's: its ``(P,
  capacity, ...)`` member rings viewed as one ``(P·capacity, ...)``
  ring, gathered at rows of that view (member ``i``'s at ``i·capacity +
  local``, folded by ``buffer.replay.fold_member_rows``), so one launch
  gathers both leaves of every member (``B' = P·B``). The folded ring
  wraps at the folded capacity, so a stacked gather would read the
  previous member's ring: it takes ``frame_stack=1`` only (what training
  gathers).

Bit contract: the kernel and the plain version agree bitwise for every
(out_dtype, normalize, augment, frame_stack). The divide is IEEE
``v / 255`` in the output type's arithmetic (bf16: divided in f32,
rounded once), as the JAX package's ``_decode`` computes it op by op.
(Under ``jit``, XLA rewrites the f32 divide into a multiply by
``1/255``, 1 ulp off on 126 of the 256 values; the port keeps the
divide.)
"""

from __future__ import annotations

import typing as t

import torch

from torch_actor_critic_tpu_torch.ops import _kernels
from torch_actor_critic_tpu_torch.telemetry import costmodel

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def stack_rows(idx: torch.Tensor, frame_stack: int, capacity: int) -> torch.Tensor:
    """Ring rows of a stacked gather ``(B, S)``, oldest first, ``idx``
    itself last; torch's ``%`` is floor-mod, as jnp's is."""
    if frame_stack < 1:
        raise ValueError(f"frame_stack must be >= 1, got {frame_stack}")
    back = torch.arange(frame_stack - 1, -1, -1, dtype=idx.dtype, device=idx.device)
    return (idx[:, None] - back[None, :]) % capacity


def _decode(x: torch.Tensor, normalize: bool, out_dtype: torch.dtype) -> torch.Tensor:
    """uint8 -> ``out_dtype`` (exact: integers <= 255 fit bf16), then
    ``/ 255`` in that type."""
    x = x.to(out_dtype)
    if normalize:
        x = x / torch.tensor(255.0, dtype=out_dtype, device=x.device)
    return x


def _clipped_axis_indices(offsets: torch.Tensor, length: int, pad: int) -> torch.Tensor:
    """``clip(i + off - pad, 0, length-1)`` per example: edge-pad by
    ``pad`` and crop at ``off``, without the padded frame."""
    i = torch.arange(length, device=offsets.device)
    return (i[None, :] + offsets[:, None].long() - pad).clamp(0, length - 1)


def gather_frames_reference(
    ring: torch.Tensor,
    idx: torch.Tensor,
    offsets: torch.Tensor | None = None,
    pad: int = 4,
    normalize: bool = False,
    out_dtype: torch.dtype = torch.float32,
    frame_stack: int = 1,
) -> torch.Tensor:
    """K1's plain version. ``ring`` uint8 ``(capacity, H, W, C)``,
    ``idx`` ``(B,)``, ``offsets`` ``(B, 2)`` in ``[0, 2·pad]`` (None: no
    shift); returns ``(B, H, W, frame_stack·C)`` in ``out_dtype``."""
    b = idx.shape[0]
    capacity, h, w, c = ring.shape
    rows = stack_rows(idx.long(), frame_stack, capacity)
    frames = ring.index_select(0, rows.reshape(-1)).reshape(b, frame_stack, h, w, c)
    if offsets is not None:
        ys = _clipped_axis_indices(offsets[:, 0], h, pad)
        xs = _clipped_axis_indices(offsets[:, 1], w, pad)
        frames = torch.gather(frames, 2, ys[:, None, :, None, None].expand_as(frames))
        frames = torch.gather(frames, 3, xs[:, None, None, :, None].expand_as(frames))
    out = _decode(frames, normalize, out_dtype)
    # (B, S, H, W, C) -> (B, H, W, S·C): newest frame in the last C channels.
    return out.permute(0, 2, 3, 1, 4).reshape(b, h, w, frame_stack * c)


def _check_leaf(name: str, ring: torch.Tensor, idx: torch.Tensor, offsets, out_dtype) -> None:
    """Raise on what neither the kernel nor the plain version takes."""
    if ring.dtype != torch.uint8:
        raise ValueError(
            f"{name} decodes uint8 replay frames, got {ring.dtype}; "
            "the replay ring stores frames as uint8 by design (buffer/replay.py)"
        )
    if ring.dim() != 4 or idx.dim() != 1:
        raise ValueError(
            f"{name}: ring must be (capacity, H, W, C) and idx (B,); "
            f"got {tuple(ring.shape)} and {tuple(idx.shape)}"
        )
    if out_dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name}: out_dtype {out_dtype} (float32 or bfloat16)")
    b = idx.shape[0]
    if offsets is not None and tuple(offsets.shape) != (b, 2):
        raise ValueError(f"{name}: offsets must be ({b}, 2), got {tuple(offsets.shape)}")
    if ring.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: ring on {ring.device} (cpu or cuda)")


def _note_work(ring, idx, shift: bool, out_dtype, frame_stack: int, leaves: int):
    """K1's formula work (:func:`~..telemetry.costmodel.pixel_gather_work`)
    to an active cost count, on either route; returns the count."""
    return costmodel.note_kernel("pixel_gather", costmodel.pixel_gather_work, idx.shape[0],
                                 tuple(ring.shape[1:]), frame_stack, out_dtype, shift, leaves)


def _launch(rings, idx, offsets, pad, normalize, out_dtype, frame_stack) -> t.List[torch.Tensor]:
    """One launch of ``csrc/pixels.cu`` for one or two leaves on the
    card, each ``(ring, offsets)`` gathered at the rows ``idx``."""
    if frame_stack < 1:
        raise ValueError(f"frame_stack must be >= 1, got {frame_stack}")
    device = rings[0].device
    for name, x in (("idx", idx), *(("offsets", o) for o in offsets)):
        if x is not None and x.device != device:
            raise ValueError(f"fused_frame_gather: {name} is not on the ring's device")
    fn = _kernels.load("pixel_gather")
    capacity, h, w, c = rings[0].shape
    b = idx.shape[0]
    rings = [r.contiguous() for r in rings]
    idx = idx.to(torch.int64).contiguous()
    offsets = [None if o is None else o.to(torch.int32).contiguous() for o in offsets]
    outs = [torch.empty((b, h, w, frame_stack * c), dtype=out_dtype, device=device)
            for _ in rings]
    if b == 0:
        return outs

    # Each leaf's pointer, None where there is no second leaf or no shift.
    (ring0, ring1), (off0, off1), (out0, out1) = (
        [None if x is None else x.data_ptr() for x in (*xs, None)[:2]]
        for xs in (rings, offsets, outs)
    )
    _kernels.launch("pixel_gather", fn, device, (
        ring0, ring1, idx.data_ptr(), off0, off1, out0, out1, len(rings),
        capacity, h, w, c, b, frame_stack, pad, _KERNEL_DTYPES[out_dtype], int(bool(normalize)),
        torch.cuda.current_stream(device).cuda_stream,
    ), f"{len(rings)} x ring {tuple(rings[0].shape)}, B={b}, S={frame_stack}, {out_dtype}")
    return outs


def fused_frame_gather(
    ring: torch.Tensor,
    idx: torch.Tensor,
    offsets: torch.Tensor | None = None,
    pad: int = 4,
    normalize: bool = False,
    out_dtype: torch.dtype = torch.float32,
    frame_stack: int = 1,
) -> torch.Tensor:
    """Gather, shift, decode and cast the frames of replay rows ``idx``
    (see :func:`gather_frames_reference`). A CPU ring runs the plain
    version; a CUDA ring launches ``csrc/pixels.cu``."""
    _check_leaf("fused_frame_gather", ring, idx, offsets, out_dtype)
    count = _note_work(ring, idx, offsets is not None, out_dtype, frame_stack, leaves=1)
    with costmodel.paused(count):
        if ring.device.type == "cpu":
            return gather_frames_reference(
                ring, idx, offsets, pad, normalize, out_dtype, frame_stack
            )
        return _launch([ring], idx, [offsets], pad, normalize, out_dtype, frame_stack)[0]


def fused_frame_gather_pair(
    rings: t.Sequence[torch.Tensor],
    idx: torch.Tensor,
    offsets: t.Sequence[torch.Tensor | None] | None = None,
    pad: int = 4,
    normalize: bool = False,
    out_dtype: torch.dtype = torch.float32,
    frame_stack: int = 1,
) -> t.Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_frame_gather` of two frame leaves (a batch's states
    and next states: rings of one shape on one device) at the same rows
    ``idx``, each with its own ``offsets`` (``None``: no shift for
    either). CPU rings run the plain version per leaf; CUDA rings take
    one launch of ``csrc/pixels.cu`` for both."""
    rings = tuple(rings)
    offsets = (None, None) if offsets is None else tuple(offsets)
    if len(rings) != 2 or len(offsets) != 2:
        raise ValueError(
            f"fused_frame_gather_pair: two rings and two offsets, got "
            f"{len(rings)} and {len(offsets)}"
        )
    if rings[0].shape != rings[1].shape or rings[0].device != rings[1].device:
        raise ValueError(
            "fused_frame_gather_pair: the two rings differ in shape or device: "
            f"{tuple(rings[0].shape)} on {rings[0].device}, "
            f"{tuple(rings[1].shape)} on {rings[1].device}"
        )
    for ring, offs in zip(rings, offsets):
        _check_leaf("fused_frame_gather_pair", ring, idx, offs, out_dtype)
    count = _note_work(rings[0], idx, offsets[0] is not None, out_dtype, frame_stack, leaves=2)
    with costmodel.paused(count):
        if rings[0].device.type == "cpu":
            return tuple(
                gather_frames_reference(ring, idx, offs, pad, normalize, out_dtype, frame_stack)
                for ring, offs in zip(rings, offsets)
            )
        return tuple(_launch(rings, idx, offsets, pad, normalize, out_dtype, frame_stack))


def member_frame_gather_pair(
    rings: t.Sequence[torch.Tensor],
    rows: torch.Tensor,
    offsets: t.Sequence[torch.Tensor | None] | None = None,
    pad: int = 4,
    normalize: bool = False,
    out_dtype: torch.dtype = torch.float32,
    frame_stack: int = 1,
) -> t.Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_frame_gather_pair` of a population's two member-stacked
    frame leaves ``(P, capacity, H, W, C)``: the rings folded to one
    ``(P·capacity, H, W, C)`` ring and gathered at ``rows`` ``(P·B,)``,
    rows of the folded ring (member ``i``'s ``B`` rows from its own ring,
    :func:`~..buffer.replay.fold_member_rows`), in ONE call (one launch
    of K1 on the card), each leaf with its shifts ``offsets`` ``(P·B,
    2)`` or ``(P, B, 2)`` (``None``: no shift). Returns ``(P, B, H, W,
    C)`` per leaf. ``frame_stack > 1`` raises ``ValueError``: the folded
    ring wraps at ``P·capacity``, so member ``i``'s first rows would
    stack frames of member ``i - 1``."""
    if frame_stack != 1:
        raise ValueError(
            f"member_frame_gather_pair: frame_stack={frame_stack} on a member-folded ring; "
            "its rows wrap at the folded capacity, so a stack would cross into the previous "
            "member's ring (training gathers with frame_stack=1)")
    rings = tuple(rings)
    if (any(r.dim() != 5 for r in rings) or rows.dim() != 1
            or rows.numel() % rings[0].shape[0]):
        raise ValueError(
            "member_frame_gather_pair: rings must be (P, capacity, H, W, C) and rows (P·B,); "
            f"got {[tuple(r.shape) for r in rings]} and {tuple(rows.shape)}")
    p, capacity = rings[0].shape[:2]
    offsets = (None, None) if offsets is None else tuple(offsets)
    folded = fused_frame_gather_pair(
        [r.reshape(p * capacity, *r.shape[2:]) for r in rings], rows,
        [None if o is None else o.reshape(-1, 2) for o in offsets],
        pad=pad, normalize=normalize, out_dtype=out_dtype)
    return tuple(x.reshape(p, -1, *x.shape[1:]) for x in folded)
