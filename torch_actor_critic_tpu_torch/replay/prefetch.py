"""Host → device refill for the tiered store (port of
``replay/prefetch.py``).

The refill half of the waterfall: a background thread samples the host
tier into ready-to-push ``(n_envs, refill_rows)`` numpy chunks and parks
them in a depth-2 queue, so when the train loop reaches a window
boundary the sample is already drawn. The thread only ever touches host
memory; the train loop performs the device push (:meth:`RefillPrefetcher.
push_into`), after the window's burst.

On the card the push goes through preallocated buffers, one pair per
queue slot: a pinned host buffer, into which the chunk is written, and a
device buffer of the same shapes. The host→device copy of a slot runs
``non_blocking`` on a copy stream of its own, so it may overlap the
burst's replays on the compute stream; the compute stream waits for the
copy's event, then :func:`~..buffer.replay.push` writes the rows into
the ring in place (``index_copy_`` into the very tensors a captured
burst reads, so no capture follows). A slot's pinned buffer is written
again only after its copy's event has completed, and its device buffer
only after the push that read it. On the CPU the chunk is pushed
directly.

With ``replay_prefetch=False`` the sampler runs synchronously at the
boundary, which makes refill chunks a pure function of the pushes and
the seed (bitwise the JAX package's). Either way the metric names are
the JAX package's: ``replay/refills_served``,
``replay/prefetch_stalls_total``, ``replay/prefetch_hit_rate``.
"""

from __future__ import annotations

import queue
import threading
import time
import typing as t

import numpy as np
import torch

from torch_actor_critic_tpu_torch.buffer.replay import push
from torch_actor_critic_tpu_torch.core.types import Batch, BufferState
from torch_actor_critic_tpu_torch.replay.diskstore import rows_to_batch

if t.TYPE_CHECKING:
    from torch_actor_critic_tpu_torch.replay.tiers import TieredReplay

__all__ = ["RefillPrefetcher"]


class _Slot:
    """One queue slot's staging pair: ``host`` (pinned) and ``dev``
    Batches of one refill chunk's shapes and dtypes, the event recorded
    behind the slot's copy (``copied``) and the one behind the push that
    read ``dev`` (``free``)."""

    def __init__(self, like: Batch, device: torch.device):
        self.host = like.map(lambda x: torch.empty(x.shape, dtype=x.dtype, pin_memory=True))
        self.dev = like.map(lambda x: torch.empty(x.shape, dtype=x.dtype, device=device))
        self.copied = torch.cuda.Event()
        self.free = torch.cuda.Event()


class RefillPrefetcher:
    """Samples the host tier into refill chunks ahead of the loop.

    ``refill_rows`` is rows per env per window (config
    ``replay_refill``); a refill chunk has leading axes ``(n_envs,
    refill_rows)``, the JAX package's layout (the port's solo trainer
    has one env).
    """

    def __init__(
        self,
        tiered: "TieredReplay",
        n_envs: int,
        refill_rows: int,
        async_prefetch: bool = True,
        depth: int = 2,
        idle_sleep_s: float = 0.005,
    ):
        if refill_rows < 1:
            raise ValueError(
                f"refill_rows must be >= 1, got {refill_rows}"
            )
        self.tiered = tiered
        self.n_envs = int(n_envs)
        self.refill_rows = int(refill_rows)
        self.async_prefetch = bool(async_prefetch)
        self.depth = max(1, int(depth))
        self._idle_sleep_s = float(idle_sleep_s)
        self._q: "queue.Queue[Batch]" = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # The card's staging pairs, made at the first push; the next to use.
        self._slots: t.List[_Slot] = []
        self._next = 0
        self._copy_stream: torch.cuda.Stream | None = None
        self.refills_served = 0
        self.stalls_total = 0
        self.requests_total = 0
        if self.async_prefetch:
            self._thread = threading.Thread(
                target=self._run, name="replay-prefetch", daemon=True
            )
            self._thread.start()

    # ------------------------------------------------------------ sampling

    def _sample_local_chunk(self) -> Batch | None:
        """One ``(n_envs, refill_rows)`` numpy chunk off the host tier,
        or ``None`` while it is still empty."""
        rows = self.tiered.sample_refill(self.n_envs * self.refill_rows)
        if rows is None:
            return None
        lead = (self.n_envs, self.refill_rows)
        return rows_to_batch(rows).map(lambda x: np.asarray(x).reshape(lead + x.shape[1:]))

    def _run(self) -> None:
        while not self._stop.is_set():
            if self._q.full():
                time.sleep(self._idle_sleep_s)
                continue
            chunk = self._sample_local_chunk()
            if chunk is None:
                time.sleep(self._idle_sleep_s)
                continue
            try:
                self._q.put(chunk, timeout=0.1)
            except queue.Full:
                pass

    def poll_local_chunk(self) -> Batch | None:
        """The train loop's boundary call: the staged chunk if one is
        ready. Synchronous mode samples on demand; async mode never
        blocks — an empty queue after the host tier warmed up counts a
        prefetch stall and skips this boundary."""
        self.requests_total += 1
        if not self.async_prefetch:
            return self._sample_local_chunk()
        try:
            chunk = self._q.get_nowait()
        except queue.Empty:
            if self.tiered.host.size > 0:
                self.stalls_total += 1
            return None
        return chunk

    # -------------------------------------------------------- device push

    def push_into(self, buffer: BufferState, rows: t.Mapping[str, np.ndarray]) -> BufferState:
        """Push flat-key host ``rows`` (a refill chunk's, its leading axes
        merged) into ``buffer``'s ring in place; returns the advanced
        ring. On the card through the next staging slot (module
        docstring); on the CPU directly."""
        chunk = rows_to_batch(rows).map(torch.from_numpy)
        device = buffer.device_size.device
        if device.type != "cuda":
            out = push(buffer, chunk)
        else:
            out = self._push_staged(buffer, chunk, device)
        self.refills_served += 1
        return out

    def _push_staged(self, buffer: BufferState, chunk: Batch, device: torch.device) -> BufferState:
        if not self._slots:
            self._slots = [_Slot(chunk, device) for _ in range(self.depth)]
            self._copy_stream = torch.cuda.Stream(device)
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        # The pinned buffer is rewritten only once its last copy is done.
        slot.copied.synchronize()
        for h, x in zip(slot.host.leaves(), chunk.leaves(), strict=True):
            h.copy_(x)
        with torch.cuda.stream(self._copy_stream):
            # ... and the device buffer once the push that read it is done.
            self._copy_stream.wait_event(slot.free)
            for d, h in zip(slot.dev.leaves(), slot.host.leaves(), strict=True):
                d.copy_(h, non_blocking=True)
            slot.copied.record(self._copy_stream)
        compute = torch.cuda.current_stream(device)
        compute.wait_event(slot.copied)
        out = push(buffer, slot.dev)
        slot.free.record(compute)
        return out

    # ------------------------------------------------------- observability

    def metrics(self) -> dict:
        served = max(self.requests_total, 1)
        return {
            "replay/refills_served": float(self.refills_served),
            "replay/prefetch_stalls_total": float(self.stalls_total),
            "replay/prefetch_hit_rate": float(
                1.0 - self.stalls_total / served
            ),
        }

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
