"""Device-resident uniform-sampling ring replay buffer (port of
``buffer/replay.py``: ``init_replay_buffer``, ``init_visual_replay_buffer``,
``push``, ``sample``, ``sample_fused_visual``), and the in-place
restore of a checkpointed ring (:func:`load_buffer_`).

The ring lives on the training device: ``device=None`` means the card,
as for the port's other entry points (``utils/device.resolve_device``),
and a CPU ring is asked for by name. :func:`push` writes a chunk at
``(ptr + arange(n)) % capacity`` — in place into the ring (the JAX
package donates the buffer to get the same effect) — and returns the
advanced cursor, with the ring's device size updated in place.
:func:`sample` draws uniformly with replacement over ``[0, size)`` from
an explicit ``torch.Generator``, or gathers given ``indices`` (the
tests inject JAX's). The draw reads the size from the device
(:func:`draw_rows`), so an update captured in a CUDA graph samples
from the size of the ring at replay time. Observations are tensors or
:class:`~..core.types.MultiObservation` values; every leaf keeps its own
dtype in the ring (a visual ring stores **uint8** HWC frames beside f32
features). :func:`sample_fused_visual` gathers the frames through the
fused pixel pipeline (K1, one launch for both frame leaves). The
striped variant is not ported.

A population's rings (``members=P`` at init) are one ring of ``(P,
capacity, ...)`` leaves: a chunk ``(P, n, ...)`` is pushed at one cursor
for every member (they push in lockstep), and a batch is ``(P, B)``
rows, each member's drawn from its own ring; a visual population's
frames are gathered for every member by one call of
:func:`~..ops.pixels.member_frame_gather_pair` (one K1 launch over the
member-folded ring). :func:`estimate_buffer_bytes`
and :func:`warn_if_buffer_exceeds_hbm` size a ring before it is made,
:func:`nbytes` measures one that was.
"""

from __future__ import annotations

import logging
import math
import typing as t

import torch

from torch_actor_critic_tpu_torch.core.types import Batch, BufferState, MultiObservation
from torch_actor_critic_tpu_torch.ops.augment import shift_offsets
from torch_actor_critic_tpu_torch.ops.pixels import (
    fused_frame_gather_pair,
    member_frame_gather_pair,
)
from torch_actor_critic_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def _zero_size(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=device)


def estimate_buffer_bytes(capacity: int, obs_shape, act_dim: int) -> int:
    """Device bytes of a ring of ``capacity`` transitions: two
    observation copies (state, next state), the action, reward and done
    per row (``obs_shape`` a shape, or a :class:`MultiObservation` of
    shapes whose frame is uint8)."""
    if isinstance(obs_shape, MultiObservation):
        obs_bytes = math.prod(obs_shape.features) * 4 + math.prod(obs_shape.frame)
    else:
        obs_bytes = math.prod(obs_shape) * 4
    return capacity * (2 * obs_bytes + act_dim * 4 + 2 * 4)


def nbytes(state: BufferState) -> int:
    """Measured bytes of a live ring's tensors: every leaf of ``data``
    and the device size, the as-allocated companion to
    :func:`estimate_buffer_bytes` (which counts the rows alone). A
    population's ring has one cursor for all members, where the JAX
    package keeps one per member."""
    return sum(leaf.nbytes for _, leaf in state.data.named_leaves()) + state.device_size.nbytes


def warn_if_buffer_exceeds_hbm(
    capacity: int, obs_shape, act_dim: int, device=None,
    advice: str = "reduce buffer capacity or history_len",
) -> None:
    """Warn when a ring of ``capacity`` rows would take more than half of
    the card's memory (``torch.cuda.mem_get_info``'s total), where the
    parameters, optimizer states and the update's intermediates share
    the rest; ``advice`` names the caller's knobs. Nothing on the CPU."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return
    _, total = torch.cuda.mem_get_info(device)
    need = estimate_buffer_bytes(capacity, obs_shape, act_dim)
    if need > 0.5 * total:
        logger.warning(
            "replay ring needs ~%.1f GB of ~%.1f GB device memory; params, optimizer "
            "state and update intermediates share the rest — %s if allocation fails",
            need / 1024**3, total / 1024**3, advice)


def init_replay_buffer(
    capacity: int,
    obs_shape: t.Sequence[int],
    act_dim: int,
    device: torch.device | str | None = None,
    members: int | None = None,
) -> BufferState:
    """An empty float32 ring of ``capacity`` transitions of ``obs_shape``
    observations, on ``device`` (``None``: the card; raises without
    one); with ``members=P``, a population's ``(P, capacity, ...)``
    rings."""
    device = resolve_device(device)
    lead = (capacity,) if members is None else (members, capacity)

    def zeros(*shape):
        return torch.zeros((*lead, *shape), dtype=torch.float32, device=device)

    data = Batch(
        states=zeros(*obs_shape),
        actions=zeros(act_dim),
        rewards=zeros(),
        next_states=zeros(*obs_shape),
        done=zeros(),
    )
    return BufferState(data=data, ptr=0, size=0, device_size=_zero_size(device))


def init_visual_replay_buffer(
    capacity: int,
    feature_dim: int,
    frame_shape: t.Sequence[int],
    act_dim: int,
    device: torch.device | str | None = None,
    members: int | None = None,
) -> BufferState:
    """An empty mixed-observation ring: f32 ``(feature_dim,)`` features
    and **uint8** ``frame_shape`` (H, W, C) frames, on ``device``
    (``None``: the card; raises without one); with ``members=P``, a
    population's ``(P, capacity, ...)`` rings."""
    device = resolve_device(device)
    lead = (capacity,) if members is None else (members, capacity)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros((*lead, *shape), dtype=dtype, device=device)

    def obs():
        return MultiObservation(features=zeros(feature_dim),
                                frame=zeros(*frame_shape, dtype=torch.uint8))

    data = Batch(states=obs(), actions=zeros(act_dim), rewards=zeros(),
                 next_states=obs(), done=zeros())
    return BufferState(data=data, ptr=0, size=0, device_size=_zero_size(device))


def push(state: BufferState, chunk: Batch) -> BufferState:
    """Append ``n`` transitions, overwriting the oldest on wrap. Each
    leaf is written in its ring's dtype; the device size is filled in
    place (a captured update holds that tensor's address). A
    population's chunk is ``(P, n, ...)``, written at the one cursor of
    every member's ring."""
    capacity = state.capacity
    n = chunk.rewards.shape[-1]
    axis = 0 if state.members is None else 1
    if n > capacity:
        # Duplicate scatter indices would overwrite in unspecified order.
        raise ValueError(
            f"push: chunk of {n} transitions exceeds buffer capacity "
            f"{capacity}; use a larger buffer or smaller chunks."
        )
    device = state.data.rewards.device
    idx = (torch.arange(n, device=device) + state.ptr) % capacity
    for ring, new in zip(state.data.leaves(), chunk.leaves()):
        ring.index_copy_(axis, idx, new.to(ring.device, ring.dtype))
    size = min(state.size + n, capacity)
    state.device_size.fill_(size)
    return BufferState(
        data=state.data, ptr=(state.ptr + n) % capacity, size=size,
        device_size=state.device_size,
    )


def load_buffer_(state: BufferState, saved: t.Mapping[str, t.Any]) -> BufferState:
    """Restore :meth:`~..core.types.BufferState.state_dict`'s snapshot
    into ``state``'s ring **in place** (a captured update holds its
    addresses): rows ``[0, size)`` of every leaf (of every member's ring,
    in a population) copied, the rest zeroed, the device size filled;
    returns the ring at the saved cursor. A snapshot of another
    capacity, leaf set, member count, row shape or dtype raises
    ``ValueError``."""
    if int(saved["capacity"]) != state.capacity:
        raise ValueError(f"replay snapshot capacity {saved['capacity']} != ring "
                         f"capacity {state.capacity}")
    size = int(saved["size"])
    rings = dict(state.data.named_leaves())
    if set(saved["leaves"]) != set(rings):
        raise ValueError(f"replay snapshot leaves {sorted(saved['leaves'])} != "
                         f"ring leaves {sorted(rings)}")
    k = 0 if state.members is None else 1  # the row axis
    for name, ring in rings.items():
        src = saved["leaves"][name]
        if (tuple(src.shape) != (*ring.shape[:k], size, *ring.shape[k + 1:])
                or src.dtype != ring.dtype):
            raise ValueError(f"replay snapshot leaf {name!r}: {src.dtype} "
                             f"{tuple(src.shape)} does not fit the ring's {ring.dtype} "
                             f"{tuple(ring.shape)} at size {size}")
    for name, ring in rings.items():
        rows = ring if k == 0 else ring.transpose(0, 1)
        rows[:size].copy_(saved["leaves"][name] if k == 0 else
                          saved["leaves"][name].transpose(0, 1))
        rows[size:].zero_()
    state.device_size.fill_(size)
    return BufferState(data=state.data, ptr=int(saved["ptr"]), size=size,
                       device_size=state.device_size)


def draw_rows(state: BufferState, batch_size: int, generator: torch.Generator) -> torch.Tensor:
    """``(batch_size,)`` int64 rows uniform over ``[0, size)`` (``(P,
    batch_size)`` for a population, one draw), against the ring's device
    size: ``floor(u · size)`` for ``u`` uniform f64 in ``[0, 1)``
    (uniform to 2⁻⁵³, no modulo bias), clamped to ``size - 1`` against
    rounding. No host read, so a CUDA graph can capture it; the eager
    path draws the same rows from the same generator state."""
    shape = (batch_size,) if state.members is None else (state.members, batch_size)
    u = torch.rand(shape, dtype=torch.float64, generator=generator,
                   device=state.device_size.device)
    return torch.minimum((u * state.device_size).long(), state.device_size - 1)


def fold_member_rows(indices: torch.Tensor, capacity: int) -> torch.Tensor:
    """A population's rows ``(P, B)`` (member ``i``'s rows of its own
    ring) as rows of the member-folded ``(P·capacity, ...)`` view of its
    rings: ``i·capacity + indices[i]``, flattened to ``(P·B,)``."""
    p = indices.shape[0]
    return (indices + torch.arange(p, device=indices.device)[:, None] * capacity).reshape(-1)


def _take_folded(ring: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Member-stacked ``ring`` ``(P, capacity, ...)`` at folded ``rows``:
    ``(P, B, ...)``."""
    return ring.reshape(-1, *ring.shape[2:]).index_select(0, rows).reshape(
        ring.shape[0], -1, *ring.shape[2:])


def _indices(state: BufferState, batch_size: int, generator, indices) -> torch.Tensor:
    if (generator is None) == (indices is None):
        raise ValueError("sample: pass exactly one of generator / indices")
    if state.size == 0:
        raise ValueError("sample: replay buffer is empty (size == 0).")
    if indices is None:
        return draw_rows(state, batch_size, generator)
    return torch.as_tensor(indices, device=state.data.rewards.device, dtype=torch.long)


def sample(
    state: BufferState,
    batch_size: int,
    generator: torch.Generator | None = None,
    indices: torch.Tensor | None = None,
) -> Batch:
    """A uniform batch over ``[0, size)`` drawn from ``generator``, or
    the rows ``indices`` when given (exactly one of the two). A
    population's batch is ``(P, batch_size, ...)``: row ``indices[i, j]``
    of member ``i``'s ring, one gather over the ``(P·capacity, ...)``
    view."""
    indices = _indices(state, batch_size, generator, indices)
    if state.members is None:
        return state.data.map(lambda ring: ring.index_select(0, indices))
    rows = fold_member_rows(indices, state.capacity)
    return state.data.map(lambda ring: _take_folded(ring, rows))


def sample_fused_visual(
    state: BufferState,
    batch_size: int,
    out_dtype: torch.dtype,
    augment: str = "none",
    pad: int = 4,
    normalize: bool = False,
    generator: torch.Generator | None = None,
    indices: torch.Tensor | None = None,
    offsets: torch.Tensor | None = None,
) -> Batch:
    """:func:`sample` for a visual ring through the fused pixel pipeline
    (:func:`~..ops.pixels.fused_frame_gather_pair`, one launch of the
    kernel K1 on the card): the non-frame leaves gather as in
    :func:`sample`; both frame leaves are gathered, DrQ-shifted
    (``augment="shift"``), decoded and cast to ``out_dtype`` in one
    pass, so the sampled frames never exist as uint8 or f32 copies in
    device memory.

    Draws from ``generator``: the rows, then (with a shift) the states'
    and the next states' offsets. Test hooks: ``indices`` ``(B,)`` and
    ``offsets`` ``(2, B, 2)`` replace the draws (the JAX package splits
    its key three ways instead: rows, state shift, next-state shift).

    A population's rings give ``(P, B, ...)`` leaves: rows ``(P, B)``
    (one draw), offsets ``(P·B, 2)`` per leaf (one draw each; hook
    ``(2, P, B, 2)``), and both frame leaves of every member gathered by
    one :func:`~..ops.pixels.member_frame_gather_pair` call, every leaf
    at the same folded rows (:func:`fold_member_rows`)."""
    if not state.visual:
        raise ValueError(
            "sample_fused_visual needs a MultiObservation (frame) buffer; got "
            f"{type(state.data.states).__name__}"
        )
    if augment not in ("none", "shift"):
        raise ValueError(f"unknown frame_augment mode {augment!r}")
    idx = _indices(state, batch_size, generator, indices)
    if augment == "none":
        offs = (None, None)
    elif offsets is None:
        if generator is None:
            raise ValueError("sample_fused_visual: a shift needs offsets or a generator")
        offs = tuple(shift_offsets(idx.numel(), pad, generator, idx.device) for _ in range(2))
    else:
        offs = tuple(offsets[i].to(idx.device).reshape(-1, 2) for i in range(2))
    d = state.data
    if state.members is None:
        def take(ring):
            return ring.index_select(0, idx)

        gather = fused_frame_gather_pair
    else:
        idx = fold_member_rows(idx, state.capacity)

        def take(ring):
            return _take_folded(ring, idx)

        gather = member_frame_gather_pair
    frames = gather(
        (d.states.frame, d.next_states.frame), idx, offs, pad=pad,
        normalize=normalize, out_dtype=out_dtype,
    )
    return Batch(
        states=MultiObservation(take(d.states.features), frames[0]),
        actions=take(d.actions),
        rewards=take(d.rewards),
        next_states=MultiObservation(take(d.next_states.features), frames[1]),
        done=take(d.done),
    )
