"""Append-only chunked disk tier for the tiered experience store (port of
``replay/diskstore.py``).

The coldest tier of :mod:`torch_actor_critic_tpu_torch.replay`:
transitions that fell off the host ring land here as
``chunk-NNNNNNNN.npz`` files plus one ``manifest.jsonl`` line per
append, under a directory with a ``meta.json`` schema descriptor. The
same format serves three producers —

- the training-side spill flow (:class:`~torch_actor_critic_tpu_torch.replay.
  tiers.TieredReplay` with ``replay_tiers=disk``),
- the serve-side flywheel logger (:mod:`~torch_actor_critic_tpu_torch.replay.
  flywheel`), and
- anything external that writes conforming chunks —

so ``train --offline`` reads one format regardless of where the
experience came from.

**The on-disk format is the JAX package's, byte for byte**: the file
names, the ``meta.json`` keys, the manifest lines and the ``npz`` keys
(dots mangled to ``__``) are the same, so a directory written by either
package reads in the other.

**Counters reconstruct from the manifest.** Eviction deletes a chunk's
*file* but never its manifest line; reopening a directory replays the
manifest in order and classifies every line: rows whose file still
exists are resident, rows whose file is gone were evicted, and
``{"event": "drop"}`` lines record rows the ``stop`` policy refused
(offered but never stored, so not part of ``received_total``). The
per-tier conservation invariant therefore survives process death::

    received_total == rows (resident) + evicted_rows_total

**Row format** (shared with the host tier): a *rows* value is a dict of
numpy arrays under flat keys — ``"states"``/``"next_states"`` for flat
observations or ``"states.features"``/``"states.frame"`` (dito
``next_states.*``) for :class:`~torch_actor_critic_tpu_torch.core.types.
MultiObservation` — plus ``"actions"``, ``"rewards"``, ``"done"``; the
leading axis is the row count. :func:`batch_to_rows` /
:func:`rows_to_batch` convert to/from the port's ``Batch`` (numpy or
host-tensor leaves).
"""

from __future__ import annotations

import json
import threading
import typing as t
from collections import OrderedDict
from pathlib import Path

import numpy as np

from torch_actor_critic_tpu_torch.core.types import Batch, MultiObservation

__all__ = [
    "DiskTier",
    "batch_to_rows",
    "rows_to_batch",
    "rows_count",
    "rows_nbytes",
    "concat_rows",
    "slice_rows",
    "obs_spec_to_json",
    "obs_spec_from_json",
    "DISK_EVICTION_POLICIES",
]

DISK_EVICTION_POLICIES = ("fifo", "stop")

_OBS_KEYS = ("states", "next_states")


# ------------------------------------------------------------- row format


def _leading(x: np.ndarray, n_lead: int) -> np.ndarray:
    """Merge ``n_lead`` leading axes into one row axis."""
    x = np.asarray(x)
    if n_lead == 1:
        return x
    return x.reshape((-1,) + x.shape[n_lead:])


def batch_to_rows(chunk: Batch, n_lead: int = 1) -> t.Dict[str, np.ndarray]:
    """``Batch`` pytree -> flat-key host rows.

    ``n_lead=2`` merges the trainer's ``(n_envs, window)`` chunk axes
    into one row axis (row order: env-major, matching the device ring's
    vmapped per-shard push order within a shard).
    """
    rows: t.Dict[str, np.ndarray] = {}
    for key in _OBS_KEYS:
        obs = getattr(chunk, key)
        if isinstance(obs, MultiObservation):
            rows[f"{key}.features"] = _leading(obs.features, n_lead)
            rows[f"{key}.frame"] = _leading(obs.frame, n_lead)
        else:
            rows[key] = _leading(obs, n_lead)
    rows["actions"] = _leading(chunk.actions, n_lead)
    rows["rewards"] = _leading(chunk.rewards, n_lead)
    rows["done"] = _leading(chunk.done, n_lead)
    return rows


def rows_to_batch(rows: t.Mapping[str, np.ndarray]) -> Batch:
    """Flat-key host rows -> ``Batch`` (numpy leaves)."""

    def obs(key):
        if key in rows:
            return np.asarray(rows[key])
        return MultiObservation(
            features=np.asarray(rows[f"{key}.features"]),
            frame=np.asarray(rows[f"{key}.frame"]),
        )

    return Batch(
        states=obs("states"),
        actions=np.asarray(rows["actions"]),
        rewards=np.asarray(rows["rewards"]),
        next_states=obs("next_states"),
        done=np.asarray(rows["done"]),
    )


def rows_count(rows: t.Mapping[str, np.ndarray]) -> int:
    return int(next(iter(rows.values())).shape[0])


def rows_nbytes(rows: t.Mapping[str, np.ndarray]) -> int:
    return int(sum(np.asarray(v).nbytes for v in rows.values()))


def concat_rows(
    parts: t.Sequence[t.Mapping[str, np.ndarray]],
) -> t.Dict[str, np.ndarray]:
    if not parts:
        raise ValueError("concat_rows: empty sequence")
    return {
        k: np.concatenate([np.asarray(p[k]) for p in parts], axis=0)
        for k in parts[0]
    }


def slice_rows(
    rows: t.Mapping[str, np.ndarray], idx: t.Any
) -> t.Dict[str, np.ndarray]:
    """Gather rows at ``idx`` (an index array or slice)."""
    return {k: np.asarray(v)[idx] for k, v in rows.items()}


# --------------------------------------------------------- spec round-trip


def obs_spec_to_json(obs_spec: t.Any) -> dict:
    """Observation spec -> the ``meta.json`` descriptor."""
    if isinstance(obs_spec, MultiObservation):
        return {
            "kind": "multi",
            "features_shape": list(obs_spec.features.shape),
            "features_dtype": np.dtype(obs_spec.features.dtype).name,
            "frame_shape": list(obs_spec.frame.shape),
            "frame_dtype": np.dtype(obs_spec.frame.dtype).name,
        }
    return {
        "kind": "flat",
        "shape": list(obs_spec.shape),
        "dtype": np.dtype(obs_spec.dtype).name,
    }


def obs_spec_from_json(desc: t.Mapping[str, t.Any]) -> t.Any:
    """The ``meta.json`` descriptor -> the port's observation spec: an
    :class:`~..envs.wrappers.ObsSpec` (shape and numpy dtype), or a
    :class:`MultiObservation` of two (where the JAX package builds
    ``jax.ShapeDtypeStruct`` s)."""
    from torch_actor_critic_tpu_torch.envs.wrappers import ObsSpec

    if desc["kind"] == "multi":
        return MultiObservation(
            features=ObsSpec(tuple(desc["features_shape"]), np.dtype(desc["features_dtype"])),
            frame=ObsSpec(tuple(desc["frame_shape"]), np.dtype(desc["frame_dtype"])),
        )
    return ObsSpec(tuple(desc["shape"]), np.dtype(desc["dtype"]))


# ---------------------------------------------------------------- the tier


class DiskTier:
    """One chunked on-disk transition store under ``directory``.

    Thread-safe (the flywheel appends from HTTP handler threads while
    ``/metrics`` snapshots). ``max_bytes=0`` means unbounded; with a
    bound, ``policy="fifo"`` deletes oldest chunk files (manifest lines
    stay — that IS the eviction record) and ``policy="stop"`` refuses
    new appends (counted ``dropped_rows_total``). At least one resident
    chunk is always kept under ``fifo`` so the tier cannot evict itself
    empty.
    """

    SCHEMA = 1

    def __init__(
        self,
        directory: str | Path,
        max_bytes: int = 0,
        policy: str = "fifo",
        cache_chunks: int = 4,
    ):
        if policy not in DISK_EVICTION_POLICIES:
            raise ValueError(
                f"disk policy must be one of {DISK_EVICTION_POLICIES}, "
                f"got {policy!r}"
            )
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_bytes = int(max_bytes)
        self.policy = policy
        self._lock = threading.Lock()
        # (seq, path, rows, nbytes) of RESIDENT chunks, oldest first.
        self._chunks: t.List[t.Tuple[int, Path, int, int]] = []
        self._cache: "OrderedDict[int, dict]" = OrderedDict()
        self._cache_chunks = max(1, int(cache_chunks))
        self._next_seq = 0  # guarded-by: _lock
        self.received_total = 0  # guarded-by: _lock
        self.evicted_rows_total = 0  # guarded-by: _lock
        self.evicted_files_total = 0  # guarded-by: _lock
        self.dropped_rows_total = 0  # guarded-by: _lock
        self._meta: dict | None = None  # guarded-by: _lock
        with self._lock:
            self._reopen_locked()

    # -------------------------------------------------------------- reopen

    @property
    def _meta_path(self) -> Path:
        return self.directory / "meta.json"

    @property
    def _manifest_path(self) -> Path:
        return self.directory / "manifest.jsonl"

    def _reopen_locked(self) -> None:
        """Reconstruct counters + the resident chunk list from the
        manifest (module docstring: eviction keeps manifest lines)."""
        if self._meta_path.exists():
            self._meta = json.loads(self._meta_path.read_text())
        if not self._manifest_path.exists():
            return
        for line in self._manifest_path.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("event") == "drop":
                self.dropped_rows_total += int(rec["rows"])
                continue
            seq, rows = int(rec["seq"]), int(rec["rows"])
            self._next_seq = max(self._next_seq, seq + 1)
            self.received_total += rows
            path = self.directory / rec["file"]
            if path.exists():
                self._chunks.append(
                    (seq, path, rows, int(rec.get("nbytes", 0)))
                )
            else:
                self.evicted_rows_total += rows
                self.evicted_files_total += 1

    # ---------------------------------------------------------------- meta

    @property
    def meta(self) -> dict | None:
        with self._lock:
            return self._meta

    def ensure_meta(self, meta: t.Mapping[str, t.Any]) -> None:
        """Write ``meta.json`` on first use, validate on reopen — two
        writers with different geometry must fail loudly, not produce a
        dataset that silently mixes shapes."""
        with self._lock:
            meta = dict(meta, schema=self.SCHEMA)
            if self._meta is None:
                self._meta = meta
                self._meta_path.write_text(json.dumps(meta, indent=2))
                return
            for key in ("obs", "act_dim"):
                if key in meta and self._meta.get(key) != meta[key]:
                    raise ValueError(
                        f"disk tier at {self.directory} was written with "
                        f"{key}={self._meta.get(key)!r}; this writer has "
                        f"{key}={meta[key]!r}"
                    )

    # -------------------------------------------------------------- append

    def append(self, rows: t.Mapping[str, np.ndarray]) -> int:
        """Append one chunk of rows; returns the rows actually stored
        (0 when the ``stop`` policy refused them)."""
        n = rows_count(rows)
        if n == 0:
            return 0
        with self._lock:
            if (
                self.policy == "stop"
                and self.max_bytes
                and self._bytes_locked() + rows_nbytes(rows) > self.max_bytes
            ):
                self.dropped_rows_total += n
                self._manifest_append({"event": "drop", "rows": n})
                return 0
            seq = self._next_seq
            self._next_seq += 1
            path = self.directory / f"chunk-{seq:08d}.npz"
            # npz keys cannot hold dots; mangle and restore on load.
            np.savez(
                path, **{k.replace(".", "__"): v for k, v in rows.items()}
            )
            nbytes = path.stat().st_size
            self._chunks.append((seq, path, n, nbytes))
            self.received_total += n
            self._manifest_append(
                {"seq": seq, "file": path.name, "rows": n, "nbytes": nbytes}
            )
            if self.policy == "fifo" and self.max_bytes:
                self._evict_over_budget_locked()
            return n

    def _manifest_append(self, rec: dict) -> None:
        with self._manifest_path.open("a") as f:
            f.write(json.dumps(rec) + "\n")

    def _bytes_locked(self) -> int:
        return sum(c[3] for c in self._chunks)

    def _evict_over_budget_locked(self) -> None:
        while len(self._chunks) > 1 and self._bytes_locked() > self.max_bytes:
            seq, path, rows, _ = self._chunks.pop(0)
            path.unlink(missing_ok=True)
            self._cache.pop(seq, None)
            self.evicted_rows_total += rows
            self.evicted_files_total += 1

    # --------------------------------------------------------------- reads

    def _load_chunk_locked(self, seq: int, path: Path) -> dict:
        cached = self._cache.get(seq)
        if cached is not None:
            self._cache.move_to_end(seq)
            return cached
        with np.load(path) as z:
            rows = {k.replace("__", "."): z[k] for k in z.files}
        self._cache[seq] = rows
        while len(self._cache) > self._cache_chunks:
            self._cache.popitem(last=False)
        return rows

    def sample(self, rng: np.random.Generator, n: int) -> dict:
        """Uniform draw of ``n`` rows (with replacement) over every
        resident chunk, via one global row index per draw."""
        with self._lock:
            chunks = list(self._chunks)
            if not chunks:
                raise ValueError(
                    f"disk tier at {self.directory} holds no resident rows"
                )
            total = sum(c[2] for c in chunks)
            flat = rng.integers(0, total, size=n)
            starts = np.cumsum([0] + [c[2] for c in chunks])
            which = np.searchsorted(starts, flat, side="right") - 1
            parts = []
            for ci in np.unique(which):
                seq, path, _, _ = chunks[ci]
                local = flat[which == ci] - starts[ci]
                parts.append(
                    slice_rows(self._load_chunk_locked(seq, path), local)
                )
            out = concat_rows(parts)
        # Restore draw order (parts were grouped by chunk).
        order = np.argsort(np.argsort(which, kind="stable"), kind="stable")
        return slice_rows(out, order)

    def read_all(self, max_rows: int | None = None) -> dict:
        """Every resident row, manifest order (oldest first) — the
        ``--offline`` load path."""
        with self._lock:
            chunks = list(self._chunks)
            if not chunks:
                raise ValueError(
                    f"disk tier at {self.directory} holds no resident rows"
                )
            parts, got = [], 0
            for seq, path, rows, _ in chunks:
                parts.append(self._load_chunk_locked(seq, path))
                got += rows
                if max_rows is not None and got >= max_rows:
                    break
        out = concat_rows(parts)
        if max_rows is not None:
            out = slice_rows(out, slice(0, max_rows))
        return out

    # --------------------------------------------------------- accounting

    @property
    def rows(self) -> int:
        with self._lock:
            return sum(c[2] for c in self._chunks)

    @property
    def files(self) -> int:
        with self._lock:
            return len(self._chunks)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes_locked()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "rows": sum(c[2] for c in self._chunks),
                "files": len(self._chunks),
                "bytes": self._bytes_locked(),
                "max_bytes": self.max_bytes,
                "policy": self.policy,
                "received_total": self.received_total,
                "evicted_rows_total": self.evicted_rows_total,
                "evicted_files_total": self.evicted_files_total,
                "dropped_rows_total": self.dropped_rows_total,
            }

    def conservation_holds(self) -> bool:
        with self._lock:
            return self.received_total == (
                sum(c[2] for c in self._chunks)
                + self.evicted_rows_total
            ) and self.dropped_rows_total >= 0

    def close(self) -> None:
        with self._lock:
            self._cache.clear()
