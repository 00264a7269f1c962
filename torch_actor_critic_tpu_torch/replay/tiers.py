"""Device ring ↔ host ↔ disk tiered experience store (port of
``replay/tiers.py``).

The storage hierarchy behind the device ring: tier 0 is the port's
:class:`~torch_actor_critic_tpu_torch.core.types.BufferState`
(``buffer/replay.py``, untouched); this module adds the host-RAM tier
and glues the disk tier (:mod:`~torch_actor_critic_tpu_torch.replay.
diskstore`) underneath with **counted waterfall spill**: every chunk the
trainer stages is also pushed through a host-side *shadow* of the device
ring, rows the shadow overwrites spill to the host ring, rows the host
ring overwrites spill to disk (or are counted dropped when no disk tier
is attached). Refill (:mod:`~torch_actor_critic_tpu_torch.replay.
prefetch`) draws from the host tier back into the device ring and
re-enters the same waterfall, so recirculated rows stay accounted.

The shadow has the device ring's capacity and pointer arithmetic, so
spill is *what the device ring actually forgot*, without ever reading
device memory back.

Conservation invariant, per tier and across tier boundaries::

    shadow.received == pushed_fresh + refill            (sources)
    ring.received   == ring.size + ring.evicted + ring.dropped_restart
    host.received   == shadow.evicted
    host.evicted    == disk.received_since_attach + dropped_nodisk

``dropped_restart`` counts rows resident at checkpoint time that a
restart cannot restore (host tiers are not checkpointed as arrays;
only counters ride the checkpoint meta); the invariant survives
restarts because those rows are moved from ``size`` to
``dropped_restart`` at restore.

Everything here is host-side numpy under one lock (the prefetch thread
samples while the train loop ingests) and the draws are
``numpy.random.default_rng(seed)``'s, as in the JAX package, so the
counters, host samples and refill chunks are bitwise that package's on
the same pushes. Nothing here touches the device, so
``replay_tiers="off"`` is exactly the trainer without tiers.
"""

from __future__ import annotations

import threading
import typing as t

import numpy as np

from torch_actor_critic_tpu_torch.buffer.striped import route_rows_to_stripes
from torch_actor_critic_tpu_torch.replay.diskstore import (
    DiskTier,
    batch_to_rows,
    concat_rows,
    rows_count,
    slice_rows,
)

__all__ = [
    "HostRing",
    "StripedHostRing",
    "TieredReplay",
    "REPLAY_PRIORITIES",
]

REPLAY_PRIORITIES = ("uniform", "recent")


class HostRing:
    """Numpy ring over flat-key rows; ``push`` returns what it evicted.

    Pointer arithmetic mirrors ``buffer/replay.py push`` exactly
    (write at ``(ptr + arange(n)) % capacity``, advance, saturate) so
    the shadow instance tracks the device ring's overwrite behavior
    row-for-row. Arrays are allocated lazily from the first pushed
    chunk's shapes/dtypes.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._data: t.Dict[str, np.ndarray] | None = None
        self.ptr = 0
        self.size = 0
        self.received_total = 0
        self.evicted_total = 0
        self.dropped_restart_total = 0

    def _ensure(self, rows: t.Mapping[str, np.ndarray]) -> None:
        if self._data is None:
            self._data = {
                k: np.zeros((self.capacity,) + v.shape[1:], v.dtype)
                for k, v in rows.items()
            }

    def _gather(self, idx: np.ndarray) -> t.Dict[str, np.ndarray]:
        assert self._data is not None
        return {k: v[idx] for k, v in self._data.items()}

    def push(
        self, rows: t.Mapping[str, np.ndarray]
    ) -> t.Dict[str, np.ndarray] | None:
        """Store ``rows``; returns the overwritten rows (oldest first)
        or ``None`` when nothing was evicted."""
        n = rows_count(rows)
        if n == 0:
            return None
        self._ensure(rows)
        assert self._data is not None
        self.received_total += n
        if n >= self.capacity:
            # The incoming chunk alone wraps the ring: everything
            # resident is lost, plus the first n-capacity incoming rows
            # (exactly what the modular scatter overwrites — later
            # duplicate indices win).
            evicted_parts = []
            if self.size:
                start = (self.ptr - self.size) % self.capacity
                valid = (start + np.arange(self.size)) % self.capacity
                evicted_parts.append(self._gather(valid))
            spill_in = n - self.capacity
            if spill_in:
                evicted_parts.append(slice_rows(rows, slice(0, spill_in)))
            kept = slice_rows(rows, slice(n - self.capacity, n))
            for k in self._data:
                self._data[k][...] = kept[k]
            self.ptr = 0
            self.size = self.capacity
            self.evicted_total += sum(
                rows_count(p) for p in evicted_parts
            )
            if not evicted_parts:
                return None
            return (
                evicted_parts[0] if len(evicted_parts) == 1
                else concat_rows(evicted_parts)
            )
        overwritten = max(0, self.size + n - self.capacity)
        evicted = None
        if overwritten:
            start = (self.ptr - self.size) % self.capacity
            old_idx = (start + np.arange(overwritten)) % self.capacity
            evicted = self._gather(old_idx)
            self.evicted_total += overwritten
        idx = (self.ptr + np.arange(n)) % self.capacity
        for k, v in self._data.items():
            v[idx] = rows[k]
        self.ptr = (self.ptr + n) % self.capacity
        self.size = min(self.size + n, self.capacity)
        return evicted

    def sample(
        self,
        rng: np.random.Generator,
        n: int,
        priority: str = "uniform",
    ) -> t.Dict[str, np.ndarray]:
        """Draw ``n`` rows with replacement. ``priority="recent"``
        restricts the draw to the newest half of the valid region
        (freshest-data-wins refill for fast-moving policies)."""
        if self.size == 0 or self._data is None:
            raise ValueError("host ring is empty")
        if priority not in REPLAY_PRIORITIES:
            raise ValueError(
                f"priority must be one of {REPLAY_PRIORITIES}, got "
                f"{priority!r}"
            )
        window = self.size if priority == "uniform" else max(1, self.size // 2)
        # Offsets back from the newest row; the valid region ends at ptr.
        offs = rng.integers(0, window, size=n)
        idx = (self.ptr - 1 - offs) % self.capacity
        return self._gather(idx)

    def note_restart(self) -> None:
        """Resident rows did not survive a restart: move them from
        ``size`` into ``dropped_restart_total`` so conservation holds
        on the restored counters."""
        self.dropped_restart_total += self.size
        self.size = 0
        self.ptr = 0
        self._data = None

    def conservation_holds(self) -> bool:
        return self.received_total == (
            self.size + self.evicted_total + self.dropped_restart_total
        )

    def snapshot(self) -> dict:
        return {
            "rows": self.size,
            "capacity": self.capacity,
            "received_total": self.received_total,
            "evicted_total": self.evicted_total,
            "dropped_restart_total": self.dropped_restart_total,
        }

    def restore_counters(self, snap: t.Mapping[str, t.Any]) -> None:
        """Adopt a checkpointed :meth:`snapshot` (counters only) and
        declare the resident rows lost (:meth:`note_restart`) — the
        restart path of ``TieredReplay.load_meta``."""
        self.received_total = int(snap.get("received_total", 0))
        self.evicted_total = int(snap.get("evicted_total", 0))
        self.dropped_restart_total = int(
            snap.get("dropped_restart_total", 0)
        )
        self.size = int(snap.get("rows", 0))
        self.note_restart()


class StripedHostRing:
    """Per-task host tier: one :class:`HostRing` per stripe, rows routed
    by the task one-hot (``buffer/striped.py`` convention, trailing
    ``n_stripes`` dims of the flat observation).

    Same interface as :class:`HostRing`, so :class:`TieredReplay`'s
    waterfall and flow equations hold unchanged over the aggregate
    counters — the generalization is in ``push`` (stripe→tier routing:
    spilled rows land in *their task's* host ring) and ``sample``
    (task-balanced draw: ``n // n_stripes`` rows per non-empty stripe,
    remainder spread across the first ones), so refill keeps the
    per-task replay striping guarantee even when one stripe has spilled
    far more than the others.
    """

    def __init__(self, capacity: int, n_stripes: int):
        if n_stripes < 2:
            raise ValueError(
                f"striped host tier needs >= 2 stripes, got {n_stripes}"
            )
        per_stripe = max(1, int(capacity) // int(n_stripes))
        self.n_stripes = int(n_stripes)
        self.capacity = per_stripe * self.n_stripes
        self.stripes = [HostRing(per_stripe) for _ in range(self.n_stripes)]

    # Aggregate counters: TieredReplay's conservation equations are
    # over sums, so the single-ring algebra carries over verbatim.
    @property
    def size(self) -> int:
        return sum(r.size for r in self.stripes)

    @property
    def received_total(self) -> int:
        return sum(r.received_total for r in self.stripes)

    @property
    def evicted_total(self) -> int:
        return sum(r.evicted_total for r in self.stripes)

    @property
    def dropped_restart_total(self) -> int:
        return sum(r.dropped_restart_total for r in self.stripes)

    def push(
        self, rows: t.Mapping[str, np.ndarray]
    ) -> t.Dict[str, np.ndarray] | None:
        evicted_parts = []
        for stripe, part in enumerate(
            route_rows_to_stripes(rows, self.n_stripes)
        ):
            if part is None:
                continue
            evicted = self.stripes[stripe].push(part)
            if evicted is not None:
                evicted_parts.append(evicted)
        if not evicted_parts:
            return None
        return (
            evicted_parts[0] if len(evicted_parts) == 1
            else concat_rows(evicted_parts)
        )

    def sample(
        self,
        rng: np.random.Generator,
        n: int,
        priority: str = "uniform",
    ) -> t.Dict[str, np.ndarray]:
        """Task-balanced draw over the non-empty stripes (an empty
        stripe's share is spread over the others — a task that never
        spilled cannot stall refill for the rest)."""
        live = [r for r in self.stripes if r.size > 0]
        if not live:
            raise ValueError("striped host tier is empty")
        base, rem = divmod(n, len(live))
        parts = []
        for i, ring in enumerate(live):
            quota = base + (1 if i < rem else 0)
            if quota:
                parts.append(ring.sample(rng, quota, priority=priority))
        return concat_rows(parts)

    def note_restart(self) -> None:
        for ring in self.stripes:
            ring.note_restart()

    def conservation_holds(self) -> bool:
        return all(r.conservation_holds() for r in self.stripes)

    def snapshot(self) -> dict:
        return {
            "rows": self.size,
            "capacity": self.capacity,
            "received_total": self.received_total,
            "evicted_total": self.evicted_total,
            "dropped_restart_total": self.dropped_restart_total,
            "stripes": [r.snapshot() for r in self.stripes],
        }

    def restore_counters(self, snap: t.Mapping[str, t.Any]) -> None:
        """Adopt a checkpointed snapshot. Per-stripe splits restore
        exactly when present; an aggregate-only snapshot (or one from a
        different stripe count) lands whole on stripe 0 — the flow
        equations are over sums, so conservation is preserved either
        way."""
        per = snap.get("stripes")
        if isinstance(per, list) and len(per) == self.n_stripes:
            for ring, sub in zip(self.stripes, per):
                ring.restore_counters(dict(sub or {}))
            return
        self.stripes[0].restore_counters(snap)
        for ring in self.stripes[1:]:
            ring.restore_counters({})


class TieredReplay:
    """The tier stack + the counted spill/refill waterfall.

    ``hbm_capacity`` is the device ring's capacity (its real one: the
    shadow must evict exactly when the ring overwrites); ``disk=None`` runs in
    host-only mode (``replay_tiers=host``) where rows falling off the
    host ring are counted ``dropped_nodisk_total`` instead of spilled.
    """

    def __init__(
        self,
        hbm_capacity: int,
        host_capacity: int,
        disk: DiskTier | None = None,
        priority: str = "uniform",
        seed: int = 0,
        n_stripes: int = 0,
    ):
        if priority not in REPLAY_PRIORITIES:
            raise ValueError(
                f"priority must be one of {REPLAY_PRIORITIES}, got "
                f"{priority!r}"
            )
        self._lock = threading.Lock()
        self.shadow = HostRing(hbm_capacity)
        # n_stripes > 0: the host tier keeps per-task sub-rings (rows
        # routed by the buffer/striped.py one-hot convention) so refill
        # sampling stays task-balanced even when one stripe spilled.
        self.host: HostRing | StripedHostRing = (
            StripedHostRing(host_capacity, n_stripes) if n_stripes
            else HostRing(host_capacity)
        )
        self.disk = disk
        self.priority = priority
        self._rng = np.random.default_rng(seed)
        self.pushed_total = 0  # fresh env rows entering the waterfall
        self.refill_total = 0  # recirculated rows re-entering it
        self.dropped_nodisk_total = 0
        # Disk rows present before this stack attached (a reopened
        # flywheel dir) are not part of THIS stack's flow equations.
        self._disk_received0 = disk.received_total if disk else 0

    # ------------------------------------------------------------ waterfall

    def _waterfall_locked(self, rows: t.Mapping[str, np.ndarray]) -> None:
        spilled = self.shadow.push(rows)
        if spilled is None:
            return
        to_disk = self.host.push(spilled)
        if to_disk is None:
            return
        if self.disk is not None:
            self.disk.append(to_disk)
        else:
            self.dropped_nodisk_total += rows_count(to_disk)

    def ingest_rows(self, rows: t.Mapping[str, np.ndarray]) -> int:
        """Fresh experience (the trainer's drained window, already in
        row form) enters the waterfall."""
        n = rows_count(rows)
        with self._lock:
            self.pushed_total += n
            self._waterfall_locked(rows)
        return n

    def ingest_chunk(self, chunk, n_lead: int = 1) -> int:
        """Fresh experience as a host ``Batch`` chunk with ``n_lead``
        leading axes (the port's solo trainer stages ``(window, ...)``
        chunks: ``n_lead=1``; the JAX trainer's ``(n_envs, window)``
        ones take 2)."""
        return self.ingest_rows(batch_to_rows(chunk, n_lead=n_lead))

    def note_refill(self, rows: t.Mapping[str, np.ndarray]) -> int:
        """Rows the prefetcher pushed back into the device ring re-enter
        the waterfall (they now occupy ring slots and will overwrite
        older rows exactly like fresh ones)."""
        n = rows_count(rows)
        with self._lock:
            self.refill_total += n
            self._waterfall_locked(rows)
        return n

    def sample_refill(self, n: int) -> t.Dict[str, np.ndarray] | None:
        """Draw ``n`` rows from the host tier for refill, or ``None``
        while the host tier is still empty."""
        with self._lock:
            if self.host.size == 0:
                return None
            return self.host.sample(self._rng, n, priority=self.priority)

    # ----------------------------------------------------------- invariant

    def conservation_holds(self) -> bool:
        with self._lock:
            return self.conservation_locked()

    # ------------------------------------------------------- observability

    def metrics(self) -> dict:
        """metrics.jsonl columns (``replay/`` namespace)."""
        with self._lock:
            out = {
                "replay/hbm_rows": float(self.shadow.size),
                "replay/host_rows": float(self.host.size),
                "replay/pushed_total": float(self.pushed_total),
                "replay/refill_rows_total": float(self.refill_total),
                "replay/spilled_host_total": float(
                    self.shadow.evicted_total
                ),
                "replay/conservation_ok": float(self.conservation_locked()),
            }
            if self.disk is not None:
                out["replay/disk_rows"] = float(self.disk.rows)
                out["replay/disk_bytes"] = float(self.disk.bytes_used)
                out["replay/spilled_disk_total"] = float(
                    self.disk.received_total - self._disk_received0
                )
                out["replay/disk_evicted_rows_total"] = float(
                    self.disk.evicted_rows_total
                )
            else:
                out["replay/dropped_nodisk_total"] = float(
                    self.dropped_nodisk_total
                )
            return out

    def conservation_locked(self) -> bool:
        # metrics() already holds the (non-reentrant) lock; re-derive
        # without re-locking.
        disk_ok = True
        disk_received = 0
        if self.disk is not None:
            disk_ok = self.disk.conservation_holds()
            disk_received = self.disk.received_total - self._disk_received0
        return (
            self.shadow.conservation_holds()
            and self.host.conservation_holds()
            and self.shadow.received_total
            == self.pushed_total + self.refill_total
            and self.host.received_total == self.shadow.evicted_total
            and self.host.evicted_total
            == disk_received + self.dropped_nodisk_total
            and disk_ok
        )

    def snapshot(self) -> dict:
        """Structured state for ``replay`` telemetry events."""
        with self._lock:
            out = {
                "hbm": self.shadow.snapshot(),
                "host": self.host.snapshot(),
                "priority": self.priority,
                "pushed_total": self.pushed_total,
                "refill_total": self.refill_total,
                "dropped_nodisk_total": self.dropped_nodisk_total,
                "conservation_ok": self.conservation_locked(),
            }
            if self.disk is not None:
                out["disk"] = self.disk.snapshot()
            return out

    # ------------------------------------------------- checkpoint bridge

    def meta_state(self) -> dict:
        """JSON-safe counters for checkpoint metadata. Tier CONTENTS
        are not checkpointed: the disk tier is already durable (it
        reopens from its own manifest) and the host/shadow rows are
        declared ``dropped_restart`` at restore — the invariant, not
        the rows, survives."""
        with self._lock:
            return {
                "pushed_total": self.pushed_total,
                "refill_total": self.refill_total,
                "dropped_nodisk_total": self.dropped_nodisk_total,
                "shadow": self.shadow.snapshot(),
                "host": self.host.snapshot(),
            }

    def load_meta(self, meta: t.Mapping[str, t.Any]) -> None:
        with self._lock:
            self.pushed_total = int(meta.get("pushed_total", 0))
            self.refill_total = int(meta.get("refill_total", 0))
            self.dropped_nodisk_total = int(
                meta.get("dropped_nodisk_total", 0)
            )
            for ring, key in ((self.shadow, "shadow"), (self.host, "host")):
                ring.restore_counters(dict(meta.get(key) or {}))
            # Disk rows were durable across the restart: everything the
            # host tier ever evicted toward disk is still accounted by
            # the reopened DiskTier counters.
            self._disk_received0 = 0
            if self.disk is not None:
                self._disk_received0 = self.disk.received_total - (
                    self.host.evicted_total - self.dropped_nodisk_total
                )

    def close(self) -> None:
        if self.disk is not None:
            self.disk.close()
