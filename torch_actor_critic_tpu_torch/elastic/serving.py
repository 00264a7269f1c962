"""Serving-plane elastic actuator: warm-pool spawn, drain-based kill (a
copy of the JAX package's ``elastic/serving.py``).

:class:`FleetScaler` is the actuator that ``python -m
torch_actor_critic_tpu_torch.serve --elastic on`` hands the
:class:`~torch_actor_critic_tpu_torch.elastic.controller.
ElasticController`:

- **scale-out** draws an already-listening, already-warm worker from
  the :class:`~torch_actor_critic_tpu_torch.aot.prefork.WarmPool`
  (no spare ready inside ``draw_timeout_s`` is a counted ``no_spare``
  outcome, never a block on the scrape thread) and admits it through
  the router's health-gated membership
  (:meth:`FleetRouter.add_worker`), registering it as an obs scrape
  source so the new worker's metrics join the aggregated series the
  SLO engine watches.
- **scale-in** never drops an accepted request: the victim is first
  held out of rotation (:meth:`FleetRouter.drain_worker` — admin-hold
  eject, so the poll thread cannot re-admit it), *then* SIGTERMed so
  its own graceful drain answers everything already accepted,
  and only after the process exits is it forgotten
  (:meth:`FleetRouter.remove_worker`, obs source removed). The
  exit-wait runs on a per-drain reaper thread — the controller's
  scrape-thread call returns immediately.

The scaler is generic over opaque worker handles (``terminate`` /
``wait_exit`` / ``force_kill`` injectable), mirroring the WarmPool
contract, so the whole scale state machine is provable with fake
processes (tests/test_torch_elastic.py).
"""

from __future__ import annotations

import logging
import threading
import time
import typing as t

logger = logging.getLogger(__name__)

__all__ = ["FleetScaler"]


def _default_terminate(handle) -> None:
    handle.terminate()


def _default_force_kill(handle) -> None:
    handle.kill()


def _default_wait_exit(handle, timeout: float) -> bool:
    try:
        handle.wait(timeout=timeout)
        return True
    except Exception:  # noqa: BLE001 — subprocess.TimeoutExpired et al.
        return False


class FleetScaler:
    """Owns the mapping router-name -> worker handle and executes the
    controller's spawn/drain decisions through the existing machinery
    (WarmPool, FleetRouter, ObsCollector)."""

    def __init__(
        self,
        router,
        pool,
        obs=None,
        terminate: t.Callable[[t.Any], None] = _default_terminate,
        wait_exit: t.Callable[[t.Any, float], bool] = _default_wait_exit,
        force_kill: t.Callable[[t.Any], None] = _default_force_kill,
        draw_timeout_s: float = 5.0,
        drain_exit_timeout_s: float = 60.0,
        obs_source: t.Callable[[str], t.Any] | None = None,
        on_drain_select: t.Callable[[str, t.Any], None] | None = None,
    ):
        self.router = router
        self.pool = pool
        self.obs = obs
        self._terminate = terminate
        self._wait_exit = wait_exit
        self._force_kill = force_kill
        self.draw_timeout_s = float(draw_timeout_s)
        self.drain_exit_timeout_s = float(drain_exit_timeout_s)
        # Fired with (name, handle) the moment scale_in picks a victim,
        # BEFORE the SIGTERM: a supervisor that also watches worker
        # processes (the serve CLI's warm-pool monitor) must stop tracking
        # the victim here, or its post-drain exit looks like a crash
        # and gets "replaced" from the warm pool — negating the
        # scale-in in a drain->replace flap loop.
        self._on_drain_select = on_drain_select
        # How to build an obs source from a worker address; defaults to
        # a plain /metrics scrape (the serve CLI passes http_source).
        self._obs_source = obs_source or (lambda addr: addr)
        self._lock = threading.Lock()
        self._workers: t.Dict[str, t.Tuple[t.Any, str]] = {}  # guarded-by: _lock
        self._draining: t.Set[str] = set()  # guarded-by: _lock
        self._reapers: t.List[threading.Thread] = []  # guarded-by: _lock
        self.spawned_total = 0  # guarded-by: _lock
        self.drained_total = 0  # guarded-by: _lock
        self.no_spare_total = 0  # guarded-by: _lock
        self.force_kills_total = 0  # guarded-by: _lock

    # ----------------------------------------------------------- registry

    def register(self, name: str, handle, address: str) -> None:
        """Tell the scaler about a worker it did not spawn (the initial
        ``--fleet N`` set, the monitor's dead-worker replacements)."""
        with self._lock:
            self._workers[name] = (handle, address)

    def forget(self, name: str) -> None:
        """Drop a worker that died outside the scaler's control (the
        monitor already replaced it)."""
        with self._lock:
            self._workers.pop(name, None)
            self._draining.discard(name)

    def is_draining(self, name: str) -> bool:
        """True while ``name`` is a scale-in victim whose drain reaper
        has not finished — its process exit is expected, not a crash."""
        with self._lock:
            return name in self._draining

    def replicas(self) -> int:
        with self._lock:
            return len(self._workers) - len(self._draining)

    def queue_depth(self) -> float:
        """Fleet-total last-polled backlog across admitted workers —
        the controller's scale-in low-watermark signal."""
        view = self.router.membership()["workers"]
        return float(sum(
            w.get("queue_depth", 0)
            for w in view.values() if w.get("admitted")
        ))

    # ---------------------------------------------------------- actuation

    def scale_out(self, reason: str = "") -> dict:
        worker = self.pool.draw(timeout=self.draw_timeout_s)
        if worker is None:
            with self._lock:
                self.no_spare_total += 1
            logger.warning(
                "elastic scale-out (%s): no warm spare ready within "
                "%.1fs", reason, self.draw_timeout_s,
            )
            return {"outcome": "no_spare"}
        name = self.router.add_worker(worker.address)
        with self._lock:
            self._workers[name] = (worker.handle, worker.address)
            self.spawned_total += 1
        if self.obs is not None:
            self.obs.add_source(name, self._obs_source(worker.address))
        logger.info(
            "elastic scale-out (%s): admitted %s at %s",
            reason, name, worker.address,
        )
        return {"outcome": "spawned", "worker": name,
                "address": worker.address}

    def scale_in(self, reason: str = "") -> dict:
        """Pick the most recently added admitted worker, hold it out of
        rotation, SIGTERM it (its own graceful drain answers accepted
        requests) and hand the exit-wait to a reaper thread."""
        view = self.router.membership()["workers"]
        with self._lock:
            candidates = [
                n for n in self._workers
                if n not in self._draining and view.get(n, {}).get("admitted")
            ]
            if not candidates:
                return {"outcome": "no_candidate"}
            name = candidates[-1]
            handle, address = self._workers[name]
            self._draining.add(name)
            self.drained_total += 1
        self.router.drain_worker(name)
        if self._on_drain_select is not None:
            # Before the SIGTERM, while the victim is provably alive:
            # the supervisor disowns it here so the exit the drain is
            # about to cause can never read as a crash to replace.
            try:
                self._on_drain_select(name, handle)
            except Exception:  # noqa: BLE001 — a supervisor hiccup must not abort the drain
                logger.exception(
                    "elastic scale-in: on_drain_select(%s) failed", name
                )
        try:
            self._terminate(handle)
        except Exception:  # noqa: BLE001 — already-dead victim: the reaper still cleans up
            logger.exception("elastic scale-in: SIGTERM of %s failed", name)
        reaper = threading.Thread(
            target=self._reap, args=(name, handle),
            name=f"elastic-drain-{name}", daemon=True,
        )
        with self._lock:
            self._reapers = [r for r in self._reapers if r.is_alive()]
            self._reapers.append(reaper)
        reaper.start()
        logger.info(
            "elastic scale-in (%s): draining %s at %s",
            reason, name, address,
        )
        return {"outcome": "draining", "worker": name,
                "address": address}

    def _reap(self, name: str, handle) -> None:
        exited = self._wait_exit(handle, self.drain_exit_timeout_s)
        if not exited:
            # The drain deadline passed with requests still unanswered
            # or a hung worker: escalate. Admissions stopped at the
            # SIGTERM, so nothing new was accepted since.
            logger.warning(
                "elastic scale-in: %s did not exit within %.1fs; "
                "force-killing", name, self.drain_exit_timeout_s,
            )
            with self._lock:
                self.force_kills_total += 1
            try:
                self._force_kill(handle)
            except Exception:  # noqa: BLE001 — the victim may have exited between the wait and the kill
                logger.exception(
                    "elastic scale-in: force-kill of %s failed", name
                )
            self._wait_exit(handle, 5.0)
        # Drop the scaler's own registry entry and obs source BEFORE
        # router.remove_worker frees the "wN" name: the reverse order
        # races a concurrent add_worker that reclaims the name, whose
        # fresh registration/source these cleanups would then delete.
        if self.obs is not None:
            self.obs.remove_source(name)
        with self._lock:
            self._workers.pop(name, None)
            self._draining.discard(name)
        try:
            self.router.remove_worker(name)
        except (KeyError, ValueError):
            pass  # already forgotten (teardown race)
        logger.info("elastic scale-in: %s drained and removed", name)

    def handles(self) -> t.List[t.Any]:
        """Every handle the scaler knows — the teardown sweep: workers
        the scaler spawned live here, not in the caller's spawn-order
        list."""
        with self._lock:
            return [h for h, _ in self._workers.values()]

    # ------------------------------------------------------------ metrics

    def stats(self) -> dict:
        with self._lock:
            return {
                "workers": len(self._workers),
                "draining": len(self._draining),
                "spawned_total": self.spawned_total,
                "drained_total": self.drained_total,
                "no_spare_total": self.no_spare_total,
                "force_kills_total": self.force_kills_total,
            }

    def shutdown(self, join_timeout: float = 15.0) -> None:
        """Join in-flight drain reapers (teardown path). Deadline is
        shared across reapers — teardown SIGTERMs every worker anyway."""
        deadline = time.monotonic() + join_timeout
        with self._lock:
            reapers = list(self._reapers)
        for r in reapers:
            r.join(timeout=max(0.0, deadline - time.monotonic()))
