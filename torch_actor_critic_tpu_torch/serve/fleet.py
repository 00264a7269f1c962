"""Engine-per-device replication behind one shared admission layer
(port of ``serve/fleet.py``).

:class:`EngineFleet` builds one engine **replica per device** — its own
bucket ladder and CUDA graphs, its own params copy placed on that
device, its own dispatcher thread — and routes every submit through a
**least-loaded dispatcher**:

- **Replica** = ``(device, per-device registry view, MicroBatcher)``.
  The registry view (:class:`_ReplicaRegistry`) satisfies the interface
  the batcher consumes (``acquire``/``breaker``), so each replica is a
  complete single-device serving stack.
- **Params placement is keyed on ``(generation, precision)``**:
  ``acquire`` compares the shared registry's generation and the
  replica engine's tier against the cached placement and re-places on
  change — a hot-reload swap reaches every replica on its next
  dispatch, and a tier change can never serve stale-dtype params.
- **Least-loaded dispatch**: score = ``load_rows() x ema_row_s``; ties
  (all idle) break round-robin.
- **Health gating**: each replica owns its own per-slot circuit breaker;
  the dispatcher skips replicas whose breaker does not admit. Only when
  EVERY replica is open does the fleet shed with
  :class:`~.admission.BreakerOpenError`.
- **Shared admission**: one fleet-wide ``capacity`` over the sum of
  replica queues, one shared :class:`ServeMetrics`.

Every replica is a twin of the slot's engine (:meth:`~.engine.PolicyEngine.replicate`),
so it serves at the registry's precision tier on one device: a 1x1
sub-mesh, the only kind the port has.

Devices: on the card, ``torch.cuda.device_count()`` of them (an int N
takes the first N). The CPU has one torch device where the JAX tests
force eight virtual ones, so an explicit device list may repeat a
device (``["cpu", "cpu"]``, or two replicas on one card): each entry is
a replica.
"""

from __future__ import annotations

import threading
import typing as t
from concurrent.futures import Future

import torch

from torch_actor_critic_tpu_torch.serve.admission import (
    BreakerOpenError,
    ShedError,
)
from torch_actor_critic_tpu_torch.serve.batcher import ActResult, MicroBatcher
from torch_actor_critic_tpu_torch.serve.breaker import CircuitBreaker
from torch_actor_critic_tpu_torch.serve.engine import PolicyEngine
from torch_actor_critic_tpu_torch.serve.metrics import ServeMetrics

__all__ = ["EngineFleet", "local_devices"]

# Pessimistic seconds-per-row placeholder while a replica's EMA warms
# up: a replica with backlog whose service rate is unknown yields to
# any idle or measured peer, while an idle cold fleet still spreads
# round-robin (0 rows x anything = 0).
_DEFAULT_ROW_S = 1.0


def local_devices(device_type: str) -> t.List[torch.device]:
    """Every device of ``device_type``: the visible cards for ``cuda``,
    the one host device for ``cpu``."""
    if device_type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


class _ReplicaRegistry:
    """A per-device view over the shared :class:`ModelRegistry`:
    ``acquire`` answers with THIS replica's engine and a device-placed
    params copy (cached, re-placed when the slot's generation or the
    engine's precision moves), ``breaker`` with this replica's own
    per-slot breaker."""

    def __init__(self, base, device, index: int, metrics=None):
        self._base = base
        self.device = torch.device(device)
        self.index = index
        self.metrics = metrics
        self._engines: t.Dict[str, PolicyEngine] = {}  # guarded-by: _lock
        # name -> (generation, precision, placed)
        self._params: t.Dict[str, t.Tuple[int, str, t.Any]] = {}  # guarded-by: _lock
        self._breakers: t.Dict[str, CircuitBreaker] = {}  # guarded-by: _lock
        self.transfer_bytes_total = 0  # guarded-by: _lock
        self.last_transfer_bytes = 0  # guarded-by: _lock
        self.placements_total = 0  # guarded-by: _lock
        self._lock = threading.Lock()

    def acquire(self, name: str = "default"):
        base_engine, params, generation = self._base.acquire(name)
        with self._lock:
            engine = self._engines.get(name)
            if engine is None:
                # A fresh twin of the shared slot engine (its tier
                # included) on this device.
                engine = base_engine.replicate(device=self.device)
                self._engines[name] = engine
            cached = self._params.get(name)
            if cached is None or cached[:2] != (generation, engine.precision):
                # One placement per reload per replica, on its next
                # dispatch — never on the reload path itself.
                placed, nbytes = engine.place_params(params)
                self._params[name] = (generation, engine.precision, placed)
                self.transfer_bytes_total += nbytes
                self.last_transfer_bytes = nbytes
                self.placements_total += 1
                if self.metrics is not None:
                    self.metrics.record_transfer(nbytes)
            return engine, self._params[name][2], generation

    def epoch_of(self, name: str = "default") -> int | None:
        return self._base.epoch_of(name)

    def breaker(self, name: str = "default") -> CircuitBreaker | None:
        base = self._base.breaker(name)
        if base is None:
            return None
        with self._lock:
            b = self._breakers.get(name)
            if b is None:
                # The slot breaker's thresholds and clock, this
                # replica's own state; events go to the shared log.
                b = CircuitBreaker(
                    fail_threshold=base.fail_threshold,
                    cooldown_s=base.cooldown_s,
                    probe_quota=base.probe_quota,
                    clock=base._clock,
                    name=f"{name}@r{self.index}",
                )
                b.on_event = lambda ev: self._base.note_breaker_event(
                    dict(ev, slot=name, replica=self.index)
                )
                self._breakers[name] = b
            return b

    def warmup(self, name: str = "default", **kwargs) -> list:
        engine, params, _ = self.acquire(name)
        return engine.warmup(params, **kwargs)

    def breaker_stats(self) -> dict:
        with self._lock:
            return {name: b.snapshot() for name, b in self._breakers.items()}

    def compile_stats(self) -> dict:
        with self._lock:
            engines = dict(self._engines)
        return {name: e.compile_stats() for name, e in engines.items()}

    def transfer_stats(self) -> dict:
        with self._lock:
            return {
                "transfer_bytes_total": self.transfer_bytes_total,
                "last_transfer_bytes": self.last_transfer_bytes,
                "placements_total": self.placements_total,
            }


class _Replica:
    __slots__ = ("index", "device", "registry", "batcher", "dispatched")

    def __init__(self, index, device, registry, batcher):
        self.index = index
        self.device = device
        self.registry = registry
        self.batcher = batcher
        self.dispatched = 0  # requests routed here (fleet-lock guarded)


class EngineFleet:
    """N single-device serving stacks behind one admission layer.

    Duck-types the :class:`MicroBatcher` surface the server consumes
    (``submit``/``act``/``queue_depth``/``close``/``capacity``/
    ``metrics``/``mode``). ``devices``: None (every device of the
    registry's type), an int (the first N) or an explicit list (which
    may repeat a device). ``capacity`` bounds the SUM of replica queues,
    checked atomically with routing.
    """

    def __init__(
        self,
        registry,
        devices: t.Sequence | int | None = None,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        metrics: ServeMetrics | None = None,
        seed: int = 0,
        capacity: int = 1024,
        span_log=None,
        mode: str = "continuous",
    ):
        device_type = getattr(registry, "device", torch.device("cpu")).type
        if devices is None or isinstance(devices, int):
            have = local_devices(device_type)
            n = len(have) if devices is None else int(devices)
            if n > len(have):
                raise ValueError(
                    f"{n} replicas asked of {len(have)} {device_type} device(s); "
                    "pass an explicit device list to put several on one device"
                )
            devices = have[:n]
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("EngineFleet needs at least one device")
        self.registry = registry
        self.capacity = int(capacity)
        self.max_batch = int(max_batch)
        self.mode = mode
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.span_log = span_log
        self._lock = threading.Lock()
        self._rr = 0  # round-robin cursor for idle ties; guarded-by: _lock
        self._running = True  # guarded-by: _lock
        # Append-only during __init__, immutable after.
        self._replicas: t.List[_Replica] = []
        for i, dev in enumerate(devices):
            view = _ReplicaRegistry(registry, dev, i, metrics=self.metrics)
            batcher = MicroBatcher(
                view, max_batch=max_batch, max_wait_ms=max_wait_ms,
                metrics=self.metrics, seed=seed * 7919 + i,
                capacity=capacity, span_log=span_log, mode=mode,
            )
            self._replicas.append(_Replica(i, dev, view, batcher))

    @property
    def n_replicas(self) -> int:
        return len(self._replicas)

    def warmup(self, slots: t.Sequence[str] | None = None, **kwargs) -> dict:
        """Warm (on CUDA: capture) every replica's buckets for ``slots``
        (default: all registered)."""
        if slots is None:
            slots = list(self.registry.slots())
        return {
            f"r{rep.index}": {
                s: len(rep.registry.warmup(s, **kwargs)) for s in slots
            }
            for rep in self._replicas
        }

    # ------------------------------------------------------------- routing

    def _pick_locked(self, slot: str):
        """Least-loaded admitting replica, or None when every replica's
        breaker for ``slot`` refuses traffic."""
        n = len(self._replicas)
        best, best_score = None, None
        for off in range(n):
            rep = self._replicas[(self._rr + off) % n]
            br = rep.registry.breaker(slot)
            if br is not None and not br.admits():
                continue  # out of rotation until its half-open probe
            ema = rep.batcher.ema_row_s
            score = rep.batcher.load_rows() * (
                ema if ema is not None else _DEFAULT_ROW_S
            )
            if best_score is None or score < best_score:
                best, best_score = rep, score
        if best is not None:
            self._rr = (best.index + 1) % n
        return best

    def submit(
        self,
        obs: t.Any,
        deterministic: bool = True,
        slot: str = "default",
        deadline_s: float | None = None,
        request_id: str | None = None,
    ) -> Future:
        """Route one request to the least-loaded healthy replica;
        returns that replica's batcher Future."""
        with self._lock:
            if not self._running:
                raise ShedError(
                    "draining",
                    "EngineFleet is closed (draining); not accepting "
                    "new requests",
                )
            total = sum(rep.batcher.queue_depth() for rep in self._replicas)
            if total >= self.capacity:
                self.metrics.record_shed("queue_full")
                raise ShedError(
                    "queue_full",
                    f"fleet admission queue is at capacity "
                    f"({self.capacity} requests across "
                    f"{len(self._replicas)} replicas); retry with "
                    "backoff",
                    retry_after_s=1.0,
                    detail={"queue_depth": total, "capacity": self.capacity},
                )
            rep = self._pick_locked(slot)
            if rep is None:
                brs = [r.registry.breaker(slot) for r in self._replicas]
                retry = min(
                    (b.retry_after_s() for b in brs if b is not None),
                    default=1.0,
                )
                self.metrics.record_shed("breaker_open")
                raise BreakerOpenError(slot, retry, "open")
            rep.dispatched += 1
            return rep.batcher.submit(
                obs, deterministic, slot, deadline_s=deadline_s,
                request_id=request_id,
            )

    def act(
        self,
        obs: t.Any,
        deterministic: bool = True,
        slot: str = "default",
        timeout: float | None = 30.0,
        request_id: str | None = None,
    ) -> ActResult:
        """Blocking :meth:`submit`; the timeout doubles as the deadline."""
        return self.submit(
            obs, deterministic, slot, deadline_s=timeout, request_id=request_id,
        ).result(timeout=timeout)

    # --------------------------------------------------------------- admin

    def queue_depth(self) -> int:
        return sum(rep.batcher.queue_depth() for rep in self._replicas)

    def load_rows(self) -> int:
        return sum(rep.batcher.load_rows() for rep in self._replicas)

    def replica_stats(self) -> t.List[dict]:
        """Per-replica view for ``/metrics`` ``fleet``."""
        out = []
        for rep in self._replicas:
            ema = rep.batcher.ema_row_s
            out.append({
                "replica": rep.index,
                "device": str(rep.device),
                "queue_depth": rep.batcher.queue_depth(),
                "load_rows": rep.batcher.load_rows(),
                "ema_row_s": round(ema, 6) if ema is not None else None,
                "dispatched_total": rep.dispatched,
                "breakers": {
                    name: s["state"]
                    for name, s in rep.registry.breaker_stats().items()
                },
            })
        return out

    def sharding_stats(self) -> dict:
        """The ``/metrics`` ``sharding`` section: the sub-mesh shape
        (1x1), the tier, per-replica placement bytes."""
        per_replica = []
        for rep in self._replicas:
            entry = {"replica": rep.index}
            entry.update(rep.registry.transfer_stats())
            entry["devices"] = [str(rep.device)]
            per_replica.append(entry)
        return {
            "submesh": {"tp": 1, "fsdp": 1},
            "devices_per_replica": 1,
            "replicas": len(self._replicas),
            "precision": self.registry.precision,
            "per_replica": per_replica,
        }

    def compile_stats(self) -> dict:
        reps = {
            f"r{rep.index}": rep.registry.compile_stats()
            for rep in self._replicas
        }
        totals = [s for per in reps.values() for s in per.values()]
        return {
            "compiles_total": sum(s["compiles_total"] for s in totals),
            "live_compiles": sum(s["live_compiles"] for s in totals),
            "replicas": reps,
        }

    def close(self, timeout: float = 10.0):
        """Stop admitting, then flush every replica's queue."""
        with self._lock:
            self._running = False
        for rep in self._replicas:
            rep.batcher.close(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
