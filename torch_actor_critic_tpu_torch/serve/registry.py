"""Multi-slot model registry with validated checkpoint hot-reload.

Port of ``serve/registry.py``: the same slots, generations, NaN-gated
swaps, per-slot breakers and polling. It reads the port's own actor
checkpoints (:mod:`torch_actor_critic_tpu_torch.utils.checkpoint`:
``epoch_<N>/actor.pt`` + ``meta.json``) — Orbax is JAX and cannot be
read here. Every engine it builds runs on the registry's ``device``
(``cuda`` unless the caller names the CPU); params are placed there at
register and reload time through ``engine.prepare_params``. The
sharded-restore and warm-start-bundle hooks are not ported.

A serving process holds one or more named **slots** (e.g. ``default``,
``canary``), each an immutable-at-a-glance triple
``(engine, params, generation)``. Swaps are atomic: the triple is
replaced in one reference assignment under the slot lock, the
generation counter increments, and any batch already dispatched keeps
the triple it captured — in-flight requests finish on the OLD weights
and nothing is ever dropped or recompiled mid-request (the engine and
its bucket ladder survive a swap; only params change).

Hot-reload sources a slot from the training run's checkpoint
directory (:class:`~torch_actor_critic_tpu_torch.utils.checkpoint.Checkpointer`
layout): :meth:`reload` checks ``latest_step`` against the slot's
loaded epoch and swaps when the trainer has written a newer one —
called manually (the HTTP ``/reload`` endpoint) or by the background
poller (:meth:`start_polling`).

Every swap is **sentinel-validated** (docs/RESILIENCE.md): the
all-finite reduction
(:func:`~torch_actor_critic_tpu_torch.resilience.sentinel.tree_all_finite`)
runs over restored params *before* the atomic swap. A NaN-corrupted
checkpoint — the exact fault the training-side sentinel rolls back
from — is ``rejected`` and the slot keeps serving its **last-good
generation**; reload reports the rejection instead of poisoning every
subsequent response. Reload IO additionally gets the
:mod:`~torch_actor_critic_tpu_torch.resilience.retry` transient-fault policy
(bounded retry with backoff), and each slot reloads independently: one
slot's failure never aborts the others
(per-slot ``{ok|noop|rejected|error}`` statuses).

Each slot also owns a :class:`~torch_actor_critic_tpu_torch.serve.breaker.
CircuitBreaker` the micro-batcher consults per group; breaker
transitions land in a bounded event log (:meth:`breaker_events`) and
per-slot state/trips/probes export via :meth:`breaker_stats` onto
``/metrics``.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
import typing as t

from torch_actor_critic_tpu_torch.resilience.retry import call_with_retries
from torch_actor_critic_tpu_torch.resilience.sentinel import tree_all_finite
from torch_actor_critic_tpu_torch.serve.breaker import CircuitBreaker
from torch_actor_critic_tpu_torch.serve.engine import PolicyEngine
from torch_actor_critic_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["ModelRegistry"]


class _Slot:
    __slots__ = (
        "engine", "state", "checkpointer", "lock", "breaker",
        "reload_rejected_total",
    )

    def __init__(self, engine, params, epoch, checkpointer, breaker):
        self.engine = engine
        # (params, generation, epoch): swapped as ONE tuple so readers
        # can never observe a params/generation mismatch.
        self.state = (params, 0, epoch)
        self.checkpointer = checkpointer
        self.breaker = breaker
        self.reload_rejected_total = 0
        self.lock = threading.Lock()


class ModelRegistry:
    def __init__(
        self,
        reload_retries: int = 1,
        reload_retry_backoff_s: float = 0.5,
        sleep: t.Callable[[float], None] = time.sleep,
        device=None,
    ):
        self.device = resolve_device(device)
        self._slots: t.Dict[str, _Slot] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._poller: threading.Thread | None = None  # guarded-by: _lock
        self._poll_stop = threading.Event()
        # Transient-IO policy for hot-reload (resilience/retry.py):
        # each slot's probe+restore gets `reload_retries` extra
        # attempts with exponential backoff before the error lands in
        # its status. `sleep` is injectable so tests drive the ladder
        # without real waiting.
        self._reload_retries = int(reload_retries)
        self._reload_retry_backoff_s = float(reload_retry_backoff_s)
        self._sleep = sleep
        # Bounded breaker-transition log: the telemetry-events view of
        # every slot breaker (each entry is a JSONL-ready dict), capped
        # so a flapping breaker cannot grow host memory.
        self._breaker_events: collections.deque = (  # guarded-by: _lock
            collections.deque(maxlen=256)
        )

    # ------------------------------------------------------- registration

    def register(
        self,
        name: str,
        actor_def,
        obs_spec,
        params=None,
        ckpt_dir: str | None = None,
        max_batch: int = 64,
        buckets: t.Sequence[int] | None = None,
        warmup: bool = True,
        replace: bool = False,
        breaker: CircuitBreaker | None = None,
    ) -> dict:
        """Create a slot. ``params`` (a state dict) seeds it directly
        (tests/bench); ``ckpt_dir`` loads the latest epoch from a port
        checkpoint dir and arms
        hot-reload for it. Exactly one of the two is required.
        ``warmup`` compiles every bucket before the slot goes live, so
        the first live request never pays a compile. ``breaker``
        overrides the slot's default circuit breaker (tests inject one
        with a fake clock).

        Registering a name that already exists raises unless
        ``replace=True`` — a silent overwrite would discard the old
        slot's engine/checkpointer and restart its generation counter
        at 0, which clients tracking generations would see as the
        counter going backwards. With ``replace=True`` the displaced
        slot's checkpointer is closed and the replacement is logged."""
        if (params is None) == (ckpt_dir is None):
            raise ValueError("pass exactly one of params / ckpt_dir")
        with self._lock:
            exists = name in self._slots
        if exists and not replace:
            raise ValueError(
                f"model slot {name!r} already registered; pass "
                "replace=True to displace it (resets its generation "
                "counter to 0)"
            )
        engine = PolicyEngine(
            actor_def, obs_spec, max_batch=max_batch, buckets=buckets,
            device=self.device,
        )
        checkpointer = None
        epoch = None
        if ckpt_dir is not None:
            from torch_actor_critic_tpu_torch.utils.checkpoint import (
                Checkpointer,
            )

            checkpointer = Checkpointer(ckpt_dir)
            params, meta = checkpointer.restore_actor_params()
            epoch = meta["epoch"]
        params = engine.prepare_params(params)
        # A slot must never go live on poisoned weights: the same
        # sentinel that validates every hot-reload validates the
        # initial load (a NaN checkpoint fails registration loudly
        # instead of serving NaN actions until someone notices).
        if not tree_all_finite(params):
            if checkpointer is not None:
                checkpointer.close()
            raise ValueError(
                f"refusing to register slot {name!r}: params contain "
                "non-finite values (divergence sentinel, "
                "docs/RESILIENCE.md)"
            )
        if breaker is None:
            breaker = CircuitBreaker(name=name)
        breaker.name = name
        user_hook = breaker.on_event

        def _hook(event, _user=user_hook, _slot=name):
            self._note_breaker_event(dict(event, slot=_slot))
            if _user is not None:
                _user(event)

        breaker.on_event = _hook
        if warmup:
            engine.warmup(params)
        slot = _Slot(engine, params, epoch, checkpointer, breaker)
        with self._lock:
            displaced = self._slots.get(name)
            self._slots[name] = slot
        if displaced is not None:
            logger.warning(
                "slot %r replaced; generation counter restarts at 0",
                name,
            )
            if displaced.checkpointer is not None:
                displaced.checkpointer.close()
        logger.info(
            "registered slot %r (epoch=%s, buckets=%s, warmup=%s)",
            name, epoch, engine.buckets, warmup,
        )
        return {"slot": name, "epoch": epoch, "generation": 0}

    # ------------------------------------------------------------ reading

    def _slot(self, name: str) -> _Slot:
        # Under the registry lock: a lookup racing register(...,
        # replace=True) must see either the old slot or the new one,
        # never a half-updated dict view. Callers never hold _lock
        # here (found by tac-lint, unlocked-guarded-access).
        with self._lock:
            try:
                return self._slots[name]
            except KeyError:
                raise KeyError(
                    f"unknown model slot {name!r}; have "
                    f"{sorted(self._slots)}"
                ) from None

    def acquire(self, name: str = "default"):
        """``(engine, params, generation)`` — the triple a batch runs
        with. The caller keeps these references for the whole forward;
        a concurrent swap cannot mutate them."""
        slot = self._slot(name)
        with slot.lock:
            params, generation, _ = slot.state
        return slot.engine, params, generation

    def epoch_of(self, name: str = "default") -> int | None:
        """The training epoch the slot's current params were published
        at (``None`` for directly-seeded slots that never saw a
        checkpoint or publish). The batcher stamps every response with
        this (:class:`~torch_actor_critic_tpu_torch.serve.batcher.ActResult`
        ``.epoch``) so decoupled actors can tag transitions with a
        staleness key that survives serving-process restarts — the
        generation counter is per-process, the epoch is durable."""
        slot = self._slot(name)
        with slot.lock:
            return slot.state[2]

    def breaker(self, name: str = "default") -> CircuitBreaker | None:
        """The slot's circuit breaker (None only for foreign slots —
        every registered slot has one)."""
        with self._lock:
            slot = self._slots.get(name)
        return slot.breaker if slot is not None else None

    def slots(self) -> t.Dict[str, dict]:
        """Health/introspection view of every slot."""
        out = {}
        with self._lock:
            items = list(self._slots.items())
        for name, slot in items:
            with slot.lock:
                _, generation, epoch = slot.state
                rejected = slot.reload_rejected_total
            out[name] = {
                "generation": generation,
                "epoch": epoch,
                "hot_reload": slot.checkpointer is not None,
                "buckets": list(slot.engine.buckets),
                "compiled": sorted(
                    [list(k) for k in slot.engine.compiled_buckets()]
                ),
                "breaker": slot.breaker.state,
                "reload_rejected_total": rejected,
                "bundle_loaded": slot.engine.bundle_loaded,
            }
        return out

    def compile_stats(self) -> dict:
        """Service-wide first-use ("compile") accounting: total + per-slot,
        per-bucket warmup/live breakdown (``/metrics`` feeds the
        recompilation watchdog's view with this; a nonzero
        ``live_compiles`` is the silently-recompiling-bucket signal —
        docs/OBSERVABILITY.md)."""
        with self._lock:
            items = list(self._slots.items())
        slots = {name: slot.engine.compile_stats() for name, slot in items}
        return {
            "compiles_total": sum(s["compiles_total"] for s in slots.values()),
            "live_compiles": sum(s["live_compiles"] for s in slots.values()),
            "bundle_compiles": sum(
                s.get("bundle_compiles", 0) for s in slots.values()
            ),
            "slots": slots,
        }

    # ----------------------------------------------------- circuit breaker

    def _note_breaker_event(self, event: dict):
        event = dict(event, ts=time.time())
        with self._lock:
            self._breaker_events.append(event)
        logger.warning("breaker event: %s", event)

    def note_breaker_event(self, event: dict):
        """Record one breaker transition into the bounded event log —
        the hook per-device replica breakers
        (:mod:`~torch_actor_critic_tpu.serve.fleet`) report through,
        so fleet and slot breaker events share one telemetry stream
        (entries carry ``replica`` when a replica emitted them)."""
        self._note_breaker_event(event)

    def breaker_events(self) -> t.List[dict]:
        """The most recent breaker transitions (bounded), each a
        JSONL-ready telemetry event dict."""
        with self._lock:
            return list(self._breaker_events)

    def breaker_stats(self) -> dict:
        """Per-slot breaker state for ``/metrics``: state machine
        position, trip/probe totals, thresholds."""
        with self._lock:
            items = list(self._slots.items())
        slots = {name: slot.breaker.snapshot() for name, slot in items}
        with self._lock:
            events_total = len(self._breaker_events)
        return {
            "trips_total": sum(s["trips_total"] for s in slots.values()),
            "open_slots": sorted(
                name for name, s in slots.items() if s["state"] != "closed"
            ),
            "events_total": events_total,
            "slots": slots,
        }

    # --------------------------------------------------------- hot reload

    def swap(
        self,
        name: str,
        params,
        epoch: int | None = None,
        validate: bool = True,
    ) -> int:
        """Atomically install new params; returns the new generation.

        ``validate`` runs the all-finite sentinel first and raises
        ``ValueError`` (no swap, last-good params keep serving) on
        non-finite params. Only the fault-injection harness passes
        ``validate=False`` — to plant the poisoned weights the breaker
        and reload tests need."""
        slot = self._slot(name)
        params = slot.engine.prepare_params(params)
        if validate and not tree_all_finite(params):
            raise ValueError(
                f"refusing to swap slot {name!r}: params contain "
                "non-finite values; the current generation keeps "
                "serving (divergence sentinel, docs/RESILIENCE.md)"
            )
        with slot.lock:
            _, generation, old_epoch = slot.state
            slot.state = (
                params, generation + 1,
                epoch if epoch is not None else old_epoch,
            )
            return generation + 1

    def _reload_slot(self, name: str, slot: _Slot) -> dict:
        """One slot's reload attempt -> its status dict. Never raises:
        ``{ok|noop|rejected|error}`` so multi-slot reloads always
        complete for every slot."""
        if slot.checkpointer is None:
            return {
                "status": "noop", "reloaded": False,
                "reason": "no checkpoint dir",
            }
        with slot.lock:
            _, generation, loaded_epoch = slot.state

        def probe_and_restore():
            # Refresh (a no-op for the port's checkpoints, which cache
            # nothing) to see epochs another process wrote.
            slot.checkpointer.refresh()
            latest = slot.checkpointer.latest_epoch()
            if latest is None or (
                loaded_epoch is not None and latest <= loaded_epoch
            ):
                return None
            # Restore OUTSIDE the slot lock: a slow checkpoint
            # read must not stall acquire() (live traffic keeps
            # flowing on the old params until the swap below).
            return latest, slot.checkpointer.restore_actor_params(latest)

        try:
            out = call_with_retries(
                probe_and_restore,
                attempts=self._reload_retries + 1,
                base_delay_s=self._reload_retry_backoff_s,
                sleep=self._sleep,
                what=f"slot {name!r} hot-reload",
            )
            if out is None:
                return {
                    "status": "noop", "reloaded": False,
                    "epoch": loaded_epoch, "generation": generation,
                }
            latest, (params, meta) = out
            params = slot.engine.prepare_params(params)
            # Sentinel gate BEFORE the swap (deterministic — never
            # retried): a NaN-corrupted checkpoint keeps the previous
            # generation serving and the rejection is reported, not
            # raised mid-serve.
            if not tree_all_finite(params):
                with slot.lock:
                    slot.reload_rejected_total += 1
                logger.warning(
                    "slot %r reload REJECTED: epoch %s params are "
                    "non-finite; generation %s (last good) keeps "
                    "serving",
                    name, latest, generation,
                )
                return {
                    "status": "rejected", "reloaded": False,
                    "epoch": latest, "generation": generation,
                    "reason": "non-finite parameters (all-finite "
                              "sentinel); last-good generation kept",
                }
            generation = self.swap(name, params, epoch=latest, validate=False)
            logger.info(
                "slot %r hot-reloaded epoch %s (generation %s)",
                name, latest, generation,
            )
            return {
                "status": "ok", "reloaded": True,
                "epoch": latest, "generation": generation,
            }
        except Exception as e:  # noqa: BLE001 — a half-written or
            # corrupt checkpoint must not take serving down; the
            # slot keeps its current params and reports the error.
            logger.warning("slot %r reload failed: %r", name, e)
            return {
                "status": "error", "reloaded": False,
                "error": repr(e)[:200],
            }

    def reload(self, name: str | None = None) -> t.Dict[str, dict]:
        """Check checkpoint-backed slots for a newer epoch; swap those
        that have one (sentinel-validated). Returns per-slot
        ``{ok|noop|rejected|error}`` statuses — one slot's failure
        never aborts reloading the remaining slots."""
        with self._lock:
            names = [name] if name is not None else list(self._slots)
        out = {}
        for n in names:
            try:
                out[n] = self._reload_slot(n, self._slot(n))
            except Exception as e:  # noqa: BLE001 — isolation: even a
                # failure OUTSIDE the per-slot path (unknown name,
                # a concurrently-removed slot) costs one status entry
                out[n] = {
                    "status": "error", "reloaded": False,
                    "error": repr(e)[:200],
                }
        return out

    def start_polling(self, interval_s: float = 5.0):
        """Background hot-reload: poll checkpoint dirs every
        ``interval_s`` seconds. The watcher never dies to one bad
        poll — reload already isolates per-slot failures, and any
        error that still escapes is logged and the next tick polls
        again."""
        def loop():
            while not self._poll_stop.wait(timeout=interval_s):
                try:
                    self.reload()
                except Exception:  # noqa: BLE001 — pragma: no cover —
                    # reload() isolates per-slot errors; this is the
                    # watcher's own last line of defense
                    logger.exception("hot-reload poll failed; will retry")

        with self._lock:
            if self._poller is not None:
                raise RuntimeError("poller already running")
            self._poll_stop.clear()
            self._poller = threading.Thread(
                target=loop, name="ckpt-poller", daemon=True
            )
            poller = self._poller
        poller.start()

    def stop_polling(self):
        # Swap the handle out under the lock, join OUTSIDE it: the
        # poller's reload() briefly takes _lock, so joining while
        # holding it would stall the stop by up to one full poll.
        with self._lock:
            poller = self._poller
            self._poller = None
        if poller is None:
            return
        self._poll_stop.set()
        poller.join(timeout=10.0)

    def close(self):
        self.stop_polling()
        with self._lock:
            slots = list(self._slots.values())
        for slot in slots:
            if slot.checkpointer is not None:
                slot.checkpointer.close()
