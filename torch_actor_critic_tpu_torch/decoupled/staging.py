"""Bounded, thread-safe transition staging between actors and learner.

The decoupled plane's middle link (port of the JAX package's
``decoupled/staging.py``): actors :meth:`StagingBuffer.put` batched transitions
tagged with the policy **generation** and published **epoch** that
produced them; the learner :meth:`StagingBuffer.pop_window`-drains
fixed-size windows into the existing replay/update path. Every way a
transition can leave the buffer is an explicit, counted policy — never
an accident:

- **Backpressure** (``policy``) when the buffer is full at ``put``:

  * ``"block"`` — the actor waits (bounded by ``block_timeout_s``) for
    the learner to drain; a timed-out wait sheds the transition.
    Counted ``blocked_total`` / ``shed_total``.
  * ``"drop_oldest"`` — evict the oldest staged transition to admit
    the new one (freshest-data-wins). Counted
    ``dropped_backpressure_total``.
  * ``"shed"`` — refuse the new transition (``put`` returns False).
    Counted ``shed_total``.

- **Bounded-staleness admission gate** (``max_lag``): at drain time,
  any staged transition whose published epoch is more than ``max_lag``
  epochs behind the learner's current epoch is dropped and counted
  (``dropped_stale_total``) — off-policy drift is a knob
  (``--max-actor-lag``), not an accident. Transitions with no epoch
  tag (random warmup actions, pre-first-publish) carry zero lag.

- **Pause/resume**: the learner (or its preemption path) ``pause()``-s
  the buffer; ``put`` then raises :class:`StagingUnavailable` and a
  remote/threaded actor idle-spins until ``resume()`` reopens it —
  actors survive a learner restart without losing their own envs.

- **Dead-actor purge** (``purge_actor``): when the fleet supervisor
  declares an actor process dead (missed heartbeat deadline,
  ``decoupled/fleet.py``), its not-yet-drained transitions are removed
  and counted (``dropped_dead_actor_total``) — a dead actor's tail is
  an explicit accounting entry, never silent residue trained on after
  its producer was SIGKILL-reaped. Transitions carry the producing
  ``actor_id`` (``-1`` = the learner's own inline actor).

Per-transition **generation-lag accounting** rides the shared
:class:`~torch_actor_critic_tpu_torch.telemetry.histogram.
FixedBucketHistogram` schema (``actor_lag`` on metrics.jsonl, epoch
telemetry events and ``/metrics``), so staleness is observable with
the same estimator as every other histogram in the system.

Conservation invariant (the "zero transitions lost" proof the chaos
smoke asserts — now spanning process boundaries)::

    staged_total == drained_total + dropped_stale_total
                    + dropped_backpressure_total
                    + dropped_dead_actor_total + depth()

Everything here is deterministic and injectable (no hidden clocks): the
only wait is the ``block`` policy's bounded condition wait.
"""

from __future__ import annotations

import collections
import threading
import time
import typing as t

import numpy as np

from torch_actor_critic_tpu_torch.core.types import MultiObservation
from torch_actor_critic_tpu_torch.telemetry.histogram import FixedBucketHistogram

__all__ = ["StagedTransition", "StagingBuffer", "StagingUnavailable"]

# Lag histogram bucket spec: lags are small integers; lo=1 puts lag 0
# in the (exact-min) underflow bucket and growth=2 gives exact bounds
# at 1, 2, 4, ... — merges across checkpoints require this spec.
_LAG_HIST_SPEC = dict(lo=1.0, hi=4096.0, growth=2.0)

BACKPRESSURE_POLICIES = ("block", "drop_oldest", "shed")


def _stack(xs: t.Sequence[t.Any]) -> t.Any:
    """Stack transitions' leaves on a new leading axis (leaf by leaf for
    a :class:`MultiObservation`)."""
    if isinstance(xs[0], MultiObservation):
        return MultiObservation(np.stack([x.features for x in xs], axis=0),
                                np.stack([x.frame for x in xs], axis=0))
    return np.stack(xs, axis=0)


def _row(x: t.Any, i: int) -> t.Any:
    """Row ``i`` of a stacked leaf (or of each leaf of a
    :class:`MultiObservation`)."""
    if isinstance(x, MultiObservation):
        return MultiObservation(np.asarray(x.features)[i], np.asarray(x.frame)[i])
    return np.asarray(x)[i]


class StagingUnavailable(RuntimeError):
    """The buffer is paused/closed (learner restarting or shutting
    down): actors should idle-spin with backoff and retry the SAME
    transition — nothing is lost to a learner restart."""


class StagedTransition(t.NamedTuple):
    """One staged lockstep step: the batched transition tuple
    ``(obs, actions, rewards, next_obs, done)`` (leading axis = envs)
    plus the policy provenance tags and the producing actor
    (``actor_id=-1`` = the learner's inline actor)."""

    transition: tuple
    generation: int
    epoch: int | None
    actor_id: int = -1


class StagingBuffer:
    def __init__(
        self,
        capacity: int,
        policy: str = "block",
        max_lag: int | None = None,
        block_timeout_s: float = 1.0,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if policy not in BACKPRESSURE_POLICIES:
            raise ValueError(
                f"policy must be one of {BACKPRESSURE_POLICIES}, got "
                f"{policy!r}"
            )
        if max_lag is not None and max_lag < 0:
            raise ValueError(f"max_lag must be >= 0, got {max_lag}")
        self.capacity = int(capacity)
        self.policy = policy
        self.max_lag = max_lag
        self.block_timeout_s = float(block_timeout_s)
        self._q: collections.deque[StagedTransition] = (  # guarded-by: _cond
            collections.deque()
        )
        self._cond = threading.Condition()
        self._closed = False  # guarded-by: _cond
        # Counted outcomes (the conservation invariant; module docstring).
        self.staged_total = 0  # guarded-by: _cond
        self.drained_total = 0  # guarded-by: _cond
        self.dropped_stale_total = 0  # guarded-by: _cond
        self.dropped_backpressure_total = 0  # guarded-by: _cond
        self.dropped_dead_actor_total = 0  # guarded-by: _cond
        self.shed_total = 0  # guarded-by: _cond
        self.blocked_total = 0  # guarded-by: _cond
        self.lag_hist = FixedBucketHistogram(  # guarded-by: _cond
            **_LAG_HIST_SPEC
        )

    # ------------------------------------------------------------ actors

    def put(
        self,
        transition: tuple,
        generation: int = 0,
        epoch: int | None = None,
        timeout_s: float | None = None,
        actor_id: int = -1,
    ) -> bool:
        """Stage one tagged transition; returns True when accepted.

        A full buffer applies the configured backpressure policy (see
        module docstring). A paused buffer raises
        :class:`StagingUnavailable` — the actor keeps the transition
        and retries after the learner reopens."""
        with self._cond:
            if self._closed:
                raise StagingUnavailable(
                    "staging buffer is paused (learner away); retry "
                    "after resume()"
                )
            if len(self._q) >= self.capacity:
                if self.policy == "shed":
                    self.shed_total += 1
                    return False
                if self.policy == "drop_oldest":
                    self._q.popleft()
                    self.dropped_backpressure_total += 1
                else:  # block (bounded)
                    self.blocked_total += 1
                    budget = float(
                        timeout_s if timeout_s is not None
                        else self.block_timeout_s
                    )
                    t_end = time.monotonic() + budget
                    while (
                        len(self._q) >= self.capacity and not self._closed
                    ):
                        remaining = t_end - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(remaining)
                    if self._closed:
                        raise StagingUnavailable(
                            "staging buffer paused while blocked on "
                            "backpressure; retry after resume()"
                        )
                    if len(self._q) >= self.capacity:
                        # Bounded block: a wait that never drained is a
                        # shed, loudly counted — never a deadlock.
                        self.shed_total += 1
                        return False
            self._q.append(
                StagedTransition(
                    transition, int(generation),
                    int(epoch) if epoch is not None else None,
                    int(actor_id),
                )
            )
            self.staged_total += 1
            self._cond.notify_all()
            return True

    # ----------------------------------------------------------- learner

    @staticmethod
    def _lag(entry: StagedTransition, current_epoch: int | None) -> int:
        if entry.epoch is None or current_epoch is None:
            return 0
        return max(0, int(current_epoch) - int(entry.epoch))

    def pop_window(
        self, k: int, current_epoch: int | None = None
    ) -> t.List[StagedTransition] | None:
        """Drain exactly ``k`` admitted transitions (oldest first), or
        ``None`` when fewer are available — windows are fixed-size so
        the learner's chunk shapes (and jit cache) never vary.

        The bounded-staleness gate runs first: staged transitions whose
        lag against ``current_epoch`` exceeds ``max_lag`` are dropped
        and counted. Each drained transition's lag is recorded in the
        ``actor_lag`` histogram — by construction every recorded lag is
        ``<= max_lag``."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        with self._cond:
            if self.max_lag is not None and current_epoch is not None:
                kept = [
                    e for e in self._q
                    if self._lag(e, current_epoch) <= self.max_lag
                ]
                n_dropped = len(self._q) - len(kept)
                if n_dropped:
                    self.dropped_stale_total += n_dropped
                    self._q = collections.deque(kept)
            if len(self._q) < k:
                return None
            out = [self._q.popleft() for _ in range(k)]
            for e in out:
                self.lag_hist.record(float(self._lag(e, current_epoch)))
            self.drained_total += len(out)
            self._cond.notify_all()
            return out

    def purge_actor(self, actor_id: int) -> int:
        """Drop every staged transition produced by ``actor_id``
        (counted ``dropped_dead_actor_total``); returns how many were
        purged. The fleet supervisor calls this when it declares an
        actor process dead — the orphaned tail leaves the buffer as an
        explicit conservation entry, not as training data from a
        producer that no longer exists."""
        with self._cond:
            kept = [e for e in self._q if e.actor_id != int(actor_id)]
            n_purged = len(self._q) - len(kept)
            if n_purged:
                self.dropped_dead_actor_total += n_purged
                self._q = collections.deque(kept)
                self._cond.notify_all()
            return n_purged

    # ------------------------------------------------------ pause/resume

    def pause(self) -> None:
        """Stop admitting (learner checkpointing/restarting): actors
        get :class:`StagingUnavailable` and idle-spin; staged
        transitions stay put for the checkpoint."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def resume(self) -> None:
        with self._cond:
            self._closed = False
            self._cond.notify_all()

    @property
    def paused(self) -> bool:
        with self._cond:
            return self._closed

    # ----------------------------------------------------- introspection

    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    def snapshot(self) -> dict:
        """Counters + the lag histogram in ``/metrics`` form — merged
        into serving ``/metrics`` via ``extra_snapshot`` and streamed
        as per-epoch ``decoupled`` telemetry events."""
        with self._cond:
            return {
                "depth": len(self._q),
                "capacity": self.capacity,
                "policy": self.policy,
                "max_lag": self.max_lag,
                "staged_total": self.staged_total,
                "drained_total": self.drained_total,
                "dropped_stale_total": self.dropped_stale_total,
                "dropped_backpressure_total":
                    self.dropped_backpressure_total,
                "dropped_dead_actor_total": self.dropped_dead_actor_total,
                "shed_total": self.shed_total,
                "blocked_total": self.blocked_total,
                "actor_lag": self.lag_hist.snapshot(
                    prefix="actor_lag_", unit=""
                ),
            }

    def conservation_holds(self) -> bool:
        """The zero-loss invariant (module docstring) — every accepted
        transition is accounted for."""
        with self._cond:
            return self.staged_total == (
                self.drained_total
                + self.dropped_stale_total
                + self.dropped_backpressure_total
                + self.dropped_dead_actor_total
                + len(self._q)
            )

    # ------------------------------------------------- checkpoint bridge

    def meta_state(self) -> dict:
        """JSON-ready counters + lag histogram + queue length, saved in
        checkpoint metadata (the queue CONTENTS ride the checkpoint's
        ``arrays`` item via :meth:`export_arrays`)."""
        with self._cond:
            return {
                "count": len(self._q),
                "staged_total": self.staged_total,
                "drained_total": self.drained_total,
                "dropped_stale_total": self.dropped_stale_total,
                "dropped_backpressure_total":
                    self.dropped_backpressure_total,
                "dropped_dead_actor_total": self.dropped_dead_actor_total,
                "shed_total": self.shed_total,
                "blocked_total": self.blocked_total,
                "lag_hist": self.lag_hist.raw_counts(),
            }

    def load_meta(self, meta: t.Mapping[str, t.Any]) -> None:
        with self._cond:
            self.staged_total = int(meta.get("staged_total", 0))
            self.drained_total = int(meta.get("drained_total", 0))
            self.dropped_stale_total = int(
                meta.get("dropped_stale_total", 0)
            )
            self.dropped_backpressure_total = int(
                meta.get("dropped_backpressure_total", 0)
            )
            self.dropped_dead_actor_total = int(
                meta.get("dropped_dead_actor_total", 0)
            )
            self.shed_total = int(meta.get("shed_total", 0))
            self.blocked_total = int(meta.get("blocked_total", 0))
            self.lag_hist = FixedBucketHistogram(**_LAG_HIST_SPEC)
            if meta.get("lag_hist"):
                self.lag_hist.merge_raw(meta["lag_hist"])

    _ARRAY_FIELDS = ("obs", "actions", "rewards", "next_obs", "done")

    def export_arrays(self) -> dict | None:
        """The queued transitions as stacked arrays (leading axis = queue
        position; a :class:`MultiObservation` of them for visual obs) for
        the checkpoint's ``arrays.pt``, or ``None`` when empty. Epoch
        ``None`` serializes as ``-1``."""
        with self._cond:
            if not self._q:
                return None
            entries = list(self._q)
        out: dict = {}
        for i, field in enumerate(self._ARRAY_FIELDS):
            out[field] = _stack([e.transition[i] for e in entries])
        out["generation"] = np.asarray(
            [e.generation for e in entries], np.int64
        )
        out["epoch"] = np.asarray(
            [-1 if e.epoch is None else e.epoch for e in entries], np.int64
        )
        out["actor_id"] = np.asarray(
            [e.actor_id for e in entries], np.int64
        )
        return out

    def import_arrays(self, arrays: t.Mapping[str, t.Any]) -> int:
        """Rebuild the queue (in order) from :meth:`export_arrays`
        output; returns the number of transitions restored. Replaces
        any current contents — the restore path owns the queue."""
        generations = np.asarray(arrays["generation"])
        epochs = np.asarray(arrays["epoch"])
        count = int(generations.shape[0])
        # Pre-fleet checkpoints carry no actor_id item: everything
        # staged then was the learner's inline actor (-1).
        actor_ids = (
            np.asarray(arrays["actor_id"]) if "actor_id" in arrays
            else np.full((count,), -1, np.int64)
        )
        entries = []
        for i in range(count):
            txn = tuple(
                _row(arrays[field], i) for field in self._ARRAY_FIELDS
            )
            ep = int(epochs[i])
            entries.append(
                StagedTransition(txn, int(generations[i]),
                                 None if ep < 0 else ep,
                                 int(actor_ids[i]))
            )
        with self._cond:
            self._q = collections.deque(entries)
            self._cond.notify_all()
        return count
