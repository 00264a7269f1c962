"""Pre-forked warm worker pool: pay the spawn before you need it (a copy
of the JAX package's ``aot/prefork.py``).

A fleet scale-up or kill-replacement otherwise pays process spawn,
import, CUDA context and graph captures *on the serving path*. The
:class:`WarmPool` moves that cost off-path: a background thread keeps
``size`` spare workers booted (listening, their graphs captured), and
the router draws an already-listening process in O(queue-pop) when it
needs one.

The pool is deliberately generic over a ``spawn`` callable returning
``(handle, address)`` and a ``kill`` callable taking the handle — in
``python -m torch_actor_critic_tpu_torch.serve --warm-pool N`` these
wrap the real worker-subprocess launcher; in tests they can be
in-process fakes. The pool never
inspects the handle.
"""

from __future__ import annotations

import logging
import threading
import time
import typing as t

logger = logging.getLogger(__name__)

__all__ = ["WarmPool", "WarmWorker"]

# Back off after a failed spawn so a persistently-broken launcher logs
# a complaint per attempt instead of busy-spinning the thread.
_SPAWN_RETRY_DELAY_S = 1.0


class WarmWorker(t.NamedTuple):
    """One spare: the launcher's opaque handle plus where it listens."""

    handle: t.Any
    address: str


class WarmPool:
    """Keep ``size`` pre-spawned warm workers ready to draw.

    ``spawn()`` must return ``(handle, address)`` for a worker that is
    READY (listening, warmed) — the pool counts readiness as the
    launcher's problem, which is what makes the draw O(1).
    ``kill(handle)`` tears one down (shutdown path and unclaimed
    spares).
    """

    def __init__(
        self,
        spawn: t.Callable[[], t.Tuple[t.Any, str]],
        kill: t.Callable[[t.Any], None],
        size: int,
        name: str = "warm-pool",
    ):
        if size < 0:
            raise ValueError(f"pool size must be >= 0, got {size}")
        self._spawn = spawn
        self._kill = kill
        self.size = int(size)
        self.name = name
        self._cv = threading.Condition()
        self._spares: t.List[WarmWorker] = []  # guarded-by: _cv
        self._stopped = False  # guarded-by: _cv
        self.spawned = 0  # guarded-by: _cv
        self.drawn = 0  # guarded-by: _cv
        self.spawn_failures = 0  # guarded-by: _cv
        # Last refill attempt, for the router's fleet /metrics section:
        # did it succeed, when (monotonic), and the failure detail if
        # not — so "the pool is quietly broken" is visible to the
        # elastic controller's operators, not just this process's log.
        self.last_refill_ok: bool | None = None  # guarded-by: _cv
        self.last_refill_at: float | None = None  # guarded-by: _cv
        self.last_refill_error: str | None = None  # guarded-by: _cv
        self._thread: threading.Thread | None = None
        if self.size > 0:
            self._thread = threading.Thread(
                target=self._refill_loop, name=name, daemon=True
            )
            self._thread.start()

    # ------------------------------------------------------------ refill

    def _refill_loop(self) -> None:
        while True:
            with self._cv:
                while not self._stopped and len(self._spares) >= self.size:
                    self._cv.wait()
                if self._stopped:
                    return
            # Spawn OUTSIDE the lock: a worker boot takes seconds and
            # draw() must stay responsive for already-ready spares.
            try:
                handle, address = self._spawn()
            except Exception as e:  # noqa: BLE001 — launcher owns the detail
                logger.exception("%s: spare worker spawn failed", self.name)
                with self._cv:
                    self.spawn_failures += 1
                    self.last_refill_ok = False
                    self.last_refill_at = time.monotonic()
                    self.last_refill_error = (
                        f"{type(e).__name__}: {e}"[:200]
                    )
                    if self._stopped:
                        return
                # Plain sleep (not cv.wait): back off even when draws
                # keep notifying.
                threading.Event().wait(_SPAWN_RETRY_DELAY_S)
                continue
            with self._cv:
                if self._stopped:
                    break
                self._spares.append(WarmWorker(handle, address))
                self.spawned += 1
                self.last_refill_ok = True
                self.last_refill_at = time.monotonic()
                self.last_refill_error = None
                self._cv.notify_all()
        # Stopped mid-spawn: the fresh worker is ours to reap.
        try:
            self._kill(handle)
        except Exception:  # noqa: BLE001
            logger.exception("%s: kill of orphan spare failed", self.name)

    # ------------------------------------------------------------- draws

    def draw(self, timeout: float | None = None) -> WarmWorker | None:
        """Pop a ready spare (blocking up to ``timeout`` for the refill
        thread if none is ready). Returns None on timeout, on a
        zero-size pool, or after shutdown. The caller owns the worker
        from here — the pool immediately begins spawning a
        replacement."""
        if self.size == 0:
            return None
        with self._cv:
            if not self._spares and not self._stopped:
                self._cv.wait(timeout)
            if self._stopped or not self._spares:
                return None
            worker = self._spares.pop(0)
            self.drawn += 1
            self._cv.notify_all()  # wake the refill thread
            return worker

    def stats(self) -> dict:
        """Pool counters for /metrics: ready spares, lifetime spawns /
        draws / spawn failures, and the last refill attempt's status
        (ok flag, age in seconds, error detail if it failed)."""
        with self._cv:
            age = (
                None if self.last_refill_at is None
                else round(time.monotonic() - self.last_refill_at, 3)
            )
            return {
                "size": self.size,
                "ready": len(self._spares),
                "spawned": self.spawned,
                "drawn": self.drawn,
                "spawn_failures": self.spawn_failures,
                "last_refill_ok": self.last_refill_ok,
                "last_refill_age_s": age,
                "last_refill_error": self.last_refill_error,
            }

    # ---------------------------------------------------------- shutdown

    def shutdown(self, join_timeout: float = 10.0) -> None:
        """Stop refilling and kill every unclaimed spare."""
        with self._cv:
            if self._stopped:
                return
            self._stopped = True
            spares, self._spares = self._spares, []
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(join_timeout)
        for worker in spares:
            try:
                self._kill(worker.handle)
            except Exception:  # noqa: BLE001
                logger.exception(
                    "%s: kill of spare %s failed", self.name, worker.address
                )
