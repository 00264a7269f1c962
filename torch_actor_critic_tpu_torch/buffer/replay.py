"""Device-resident uniform-sampling ring replay buffer (port of
``buffer/replay.py``: ``init_replay_buffer``, ``push``, ``sample``).

The ring lives on the training device. :func:`push` writes a chunk at
``(ptr + arange(n)) % capacity`` — in place into the ring (the JAX
package donates the buffer to get the same effect) — and returns the
advanced cursor. :func:`sample` draws uniformly with replacement over
``[0, size)`` from an explicit ``torch.Generator``, or gathers given
``indices`` (the tests inject JAX's). The striped and visual variants
are not ported.
"""

from __future__ import annotations

import typing as t

import torch

from torch_actor_critic_tpu_torch.core.types import Batch, BufferState


def init_replay_buffer(
    capacity: int,
    obs_shape: t.Sequence[int],
    act_dim: int,
    device: torch.device | str = "cpu",
) -> BufferState:
    """An empty float32 ring of ``capacity`` transitions of ``obs_shape``
    observations."""

    def zeros(*shape):
        return torch.zeros((capacity, *shape), dtype=torch.float32, device=device)

    data = Batch(
        states=zeros(*obs_shape),
        actions=zeros(act_dim),
        rewards=zeros(),
        next_states=zeros(*obs_shape),
        done=zeros(),
    )
    return BufferState(data=data, ptr=0, size=0)


def push(state: BufferState, chunk: Batch) -> BufferState:
    """Append ``n`` transitions, overwriting the oldest on wrap."""
    capacity = state.capacity
    n = chunk.rewards.shape[0]
    if n > capacity:
        # Duplicate scatter indices would overwrite in unspecified order.
        raise ValueError(
            f"push: chunk of {n} transitions exceeds buffer capacity "
            f"{capacity}; use a larger buffer or smaller chunks."
        )
    device = state.data.rewards.device
    idx = (torch.arange(n, device=device) + state.ptr) % capacity
    for name in ("states", "actions", "rewards", "next_states", "done"):
        ring = getattr(state.data, name)
        ring.index_copy_(0, idx, getattr(chunk, name).to(ring.device, ring.dtype))
    return BufferState(
        data=state.data, ptr=(state.ptr + n) % capacity,
        size=min(state.size + n, capacity),
    )


def sample(
    state: BufferState,
    batch_size: int,
    generator: torch.Generator | None = None,
    indices: torch.Tensor | None = None,
) -> Batch:
    """A uniform batch over ``[0, size)`` drawn from ``generator``, or
    the rows ``indices`` when given (exactly one of the two)."""
    if (generator is None) == (indices is None):
        raise ValueError("sample: pass exactly one of generator / indices")
    if state.size == 0:
        raise ValueError("sample: replay buffer is empty (size == 0).")
    device = state.data.rewards.device
    if indices is None:
        indices = torch.randint(
            0, state.size, (batch_size,), generator=generator, device=device
        )
    else:
        indices = torch.as_tensor(indices, device=device, dtype=torch.long)
    return state.data.map(lambda ring: ring.index_select(0, indices))
