"""Serve-side transition logging — the data flywheel's intake (port of
``replay/flywheel.py``).

A production policy fleet answers orders of magnitude more ``/act``
requests than any training run steps its envs; this module captures a
bounded, sampled slice of that traffic as training data in the SAME
disk-tier chunk format the trainer's spill path writes
(:mod:`~torch_actor_critic_tpu_torch.replay.diskstore`), so ``train
--offline`` (of either package) consumes fleet experience and trainer
spill identically.

Placement: BEHIND the admission layer (serve/server.py wires
``note_act`` after a successful ``client.act`` only) — shed, expired
and breaker-refused requests never produce rows, so the dataset
reflects actions the policy actually served.

A transition needs two halves the HTTP plane sees at different times:
``note_act`` records (obs, action) under the request id at answer
time; ``note_outcome`` (the new ``POST /outcome`` route) completes it
with (reward, next_obs, done) when the caller reports what happened.
Pending halves live in a bounded FIFO map — a client that never
reports an outcome costs one slot until eviction (counted
``pending_evicted_total``), never unbounded host RAM. Completed
transitions batch into ``chunk_rows``-row files; ``sample_every=N``
keeps every Nth answered request (traffic downsampling).

Thread-safe throughout: the HTTP server handles requests on many
threads and ``/metrics`` snapshots concurrently.
"""

from __future__ import annotations

import threading
import typing as t
from collections import OrderedDict

import numpy as np

from torch_actor_critic_tpu_torch.core.types import MultiObservation
from torch_actor_critic_tpu_torch.replay.diskstore import (
    DiskTier,
    concat_rows,
    obs_spec_to_json,
)

__all__ = ["TransitionLogger"]


def _obs_rows(prefix: str, obs: t.Any) -> t.Dict[str, np.ndarray]:
    """One observation (single row, no leading axis) -> flat row keys
    with a length-1 leading axis."""
    if isinstance(obs, MultiObservation):
        return {
            f"{prefix}.features": np.asarray(obs.features)[None],
            f"{prefix}.frame": np.asarray(obs.frame)[None],
        }
    return {prefix: np.asarray(obs)[None]}


class TransitionLogger:
    """Bounded, sampled (obs, action, outcome) logger over a DiskTier."""

    def __init__(
        self,
        directory: str,
        obs_spec: t.Any,
        act_dim: int,
        act_limit: float = 1.0,
        sample_every: int = 1,
        max_bytes: int = 0,
        max_pending: int = 1024,
        chunk_rows: int = 256,
    ):
        if sample_every < 1:
            raise ValueError(
                f"sample_every must be >= 1, got {sample_every}"
            )
        self._lock = threading.Lock()
        self.tier = DiskTier(directory, max_bytes=max_bytes, policy="fifo")
        self.tier.ensure_meta({
            "obs": obs_spec_to_json(obs_spec),
            "act_dim": int(act_dim),
            "act_limit": float(act_limit),
            "source": "flywheel",
        })
        self.sample_every = int(sample_every)
        self.max_pending = int(max_pending)
        self.chunk_rows = int(chunk_rows)
        # request_id -> (obs, action); FIFO-bounded.
        self._pending: "OrderedDict[str, tuple]" = OrderedDict()
        self._rows: t.List[t.Dict[str, np.ndarray]] = []
        self._seen = 0
        self.acts_seen_total = 0
        self.acts_sampled_total = 0
        self.outcomes_total = 0
        self.outcomes_unmatched_total = 0
        self.pending_evicted_total = 0
        self.logged_rows_total = 0

    # -------------------------------------------------------------- intake

    def note_act(self, request_id: str, obs: t.Any, action: t.Any) -> None:
        """Record the answered half of a transition (sampled)."""
        with self._lock:
            self.acts_seen_total += 1
            self._seen += 1
            if self._seen % self.sample_every != 0:
                return
            self.acts_sampled_total += 1
            self._pending[request_id] = (obs, np.asarray(action))
            while len(self._pending) > self.max_pending:
                self._pending.popitem(last=False)
                self.pending_evicted_total += 1

    def note_outcome(
        self,
        request_id: str,
        reward: float,
        next_obs: t.Any,
        done: bool,
    ) -> bool:
        """Complete a pending transition; returns True when the request
        id matched a sampled, still-pending act."""
        with self._lock:
            self.outcomes_total += 1
            pending = self._pending.pop(request_id, None)
            if pending is None:
                self.outcomes_unmatched_total += 1
                return False
            obs, action = pending
            row = dict(_obs_rows("states", obs))
            row.update(_obs_rows("next_states", next_obs))
            row["actions"] = np.asarray(action, np.float32).reshape(1, -1)
            row["rewards"] = np.asarray([reward], np.float32)
            row["done"] = np.asarray([float(bool(done))], np.float32)
            self._rows.append(row)
            self.logged_rows_total += 1
            flush_now = len(self._rows) >= self.chunk_rows
            if flush_now:
                rows, self._rows = self._rows, []
            else:
                rows = None
        if rows:
            self._append(rows)
        return True

    def _append(self, rows: t.List[t.Dict[str, np.ndarray]]) -> None:
        self.tier.append(concat_rows(rows))

    def flush(self) -> int:
        """Write any buffered rows out as a (possibly short) chunk."""
        with self._lock:
            rows, self._rows = self._rows, []
        if rows:
            self._append(rows)
        return len(rows)

    # ------------------------------------------------------- observability

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "sample_every": self.sample_every,
                "acts_seen_total": self.acts_seen_total,
                "acts_sampled_total": self.acts_sampled_total,
                "outcomes_total": self.outcomes_total,
                "outcomes_unmatched_total": self.outcomes_unmatched_total,
                "pending": len(self._pending),
                "pending_evicted_total": self.pending_evicted_total,
                "logged_rows_total": self.logged_rows_total,
                "buffered_rows": len(self._rows),
            }
        out["disk"] = self.tier.snapshot()
        return out

    def close(self) -> None:
        self.flush()
        self.tier.close()
