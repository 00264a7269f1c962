"""Fault injection: drive real failure modes through a real Trainer
(port of the parts of the JAX package's ``resilience/faultinject.py``
that the port's trainer runs):

- **NaN batches** — :class:`FaultyEnvPool` wraps an env pool and
  corrupts scheduled step outputs (rewards/observations), exercising
  the divergence sentinel + rollback path.
- **Signals** — :meth:`FaultyEnvPool.call_at` runs a callback at an
  exact pool step (``os.kill(os.getpid(), signal.SIGTERM)``, or
  ``guard.request_preemption()``), exercising the preemption
  save/requeue path deterministically: everything keys off step counts,
  never wall-clock sleeps.
- **Checkpoint IO faults** — :func:`make_flaky` wraps any callable to
  fail its first N calls (the transient-IO retry path);
  :func:`corrupt_checkpoint` damages an on-disk epoch the way a save
  cut short does, exercising the fallback to the previous epoch.
- **Serving and the decoupled plane** — :class:`FaultyEngine` (scheduled
  forward failures), :class:`LossyLink` (a lossy actor↔serving link),
  :class:`FlakyTransport` (a lossy staging-push link), :func:`kill_actor`
  and :func:`kill_env_worker` (SIGKILL and reap), :func:`nan_params`
  (poisoned weights) and :func:`flood` (a burst past admission). Their
  seeded ``random.Random`` schedules are the JAX package's.

Injection is compositional: build a normal Trainer, then
``trainer.pool = FaultyEnvPool(trainer.pool, ...)``.
"""

from __future__ import annotations

import os
import signal
import typing as t
from pathlib import Path

import numpy as np

from torch_actor_critic_tpu_torch.core.types import MultiObservation

__all__ = [
    "FaultyEngine",
    "FaultyEnvPool",
    "FlakyTransport",
    "LossyLink",
    "corrupt_checkpoint",
    "flood",
    "kill_actor",
    "kill_env_worker",
    "make_flaky",
    "nan_params",
]


class FaultyEnvPool:
    """Protocol-transparent env-pool wrapper with step-scheduled faults.

    Wraps any object implementing the pool protocol
    (``envs/vec_env.py``); every attribute not overridden here proxies
    to the wrapped pool, so the trainer cannot tell the difference.
    Step numbering counts ``step()`` calls on THIS wrapper, starting at
    0 — i.e. the trainer's lockstep steps (evaluation's ``step_at`` is
    not counted).
    """

    def __init__(self, pool: t.Any):
        self._pool = pool
        self._step_count = 0
        self._before: t.Dict[int, t.List[t.Callable[[], None]]] = {}
        self._corrupt: t.Dict[int, t.List[t.Callable]] = {}

    def call_at(self, step: int, fn: t.Callable[[], None]) -> "FaultyEnvPool":
        """Run ``fn()`` immediately before pool step ``step`` executes."""
        self._before.setdefault(step, []).append(fn)
        return self

    def nan_rewards_at(self, step: int, envs: t.Sequence[int] | None = None) -> "FaultyEnvPool":
        """Replace the scheduled step's rewards with NaN (all envs by
        default)."""

        def corrupt(obs, rewards, terms, truncs):
            rewards = np.array(rewards, np.float32)
            rewards[list(envs) if envs is not None else slice(None)] = np.nan
            return obs, rewards, terms, truncs

        self._corrupt.setdefault(step, []).append(corrupt)
        return self

    def nan_obs_at(self, step: int, envs: t.Sequence[int] | None = None) -> "FaultyEnvPool":
        """NaN the scheduled step's next observations (their float
        leaves; uint8 frames cannot hold NaN), all envs by default."""
        rows = list(envs) if envs is not None else slice(None)

        def poison(x):
            x = np.array(x)
            if np.issubdtype(x.dtype, np.floating):
                x[rows] = np.nan
            return x

        def corrupt(obs, rewards, terms, truncs):
            obs = obs.map(poison) if isinstance(obs, MultiObservation) else poison(obs)
            return obs, rewards, terms, truncs

        self._corrupt.setdefault(step, []).append(corrupt)
        return self

    def step(self, actions):
        n = self._step_count
        self._step_count += 1
        for fn in self._before.pop(n, []):
            fn()
        out = self._pool.step(actions)
        for corrupt in self._corrupt.pop(n, []):
            out = corrupt(*out)
        return out

    def __getattr__(self, name: str):
        return getattr(self._pool, name)


class FaultyEngine:
    """Protocol-transparent :class:`PolicyEngine` wrapper with
    scheduled forward failures — the engine-fault injector for the
    circuit-breaker path.

    Wraps a real engine (every attribute proxies through, so the
    batcher cannot tell the difference) and makes the next ``n``
    ``act`` calls raise. Register the wrapped slot, then::

        faulty = FaultyEngine(registry._slots["default"].engine)
        registry._slots["default"].engine = faulty      # tests only
        faulty.fail_next(5)                             # trips breaker

    Counting is on ``act`` calls on THIS wrapper, so tests can assert
    exactly how many forwards the engine actually ran (e.g. that a
    purged request never reached it).
    """

    def __init__(self, engine: t.Any):
        self._engine = engine
        self._fail_left = 0
        self._exc_factory: t.Callable[[], BaseException] = lambda: (
            RuntimeError("injected engine forward failure")
        )
        self.calls_total = 0
        self.failures_injected = 0

    def fail_next(
        self,
        n: int,
        exc_factory: t.Callable[[], BaseException] | None = None,
    ) -> "FaultyEngine":
        """Make the next ``n`` forwards raise (cumulative with any
        already scheduled)."""
        self._fail_left += int(n)
        if exc_factory is not None:
            self._exc_factory = exc_factory
        return self

    def act(self, *args, **kwargs):
        self.calls_total += 1
        if self._fail_left > 0:
            self._fail_left -= 1
            self.failures_injected += 1
            raise self._exc_factory()
        return self._engine.act(*args, **kwargs)

    def __getattr__(self, name: str):
        return getattr(self._engine, name)


class LossyLink:
    """Protocol-transparent lossy/slow network link between a policy
    client and its server — the actor↔serving fault injector for the
    decoupled plane (docs/RESILIENCE.md "Decoupled-plane failure
    modes").

    Wraps anything with an ``act(...)`` method (a
    :class:`~torch_actor_critic_tpu_torch.serve.server.PolicyClient` in
    either transport mode, a :class:`~torch_actor_critic_tpu_torch.serve.
    batcher.MicroBatcher`, a whole
    :class:`~torch_actor_critic_tpu_torch.serve.fleet.EngineFleet`) and, per
    call, injects configurable **latency** (``latency_s``, via the
    injectable ``sleep``) and **drops** — a dropped call raises
    ``ConnectionError`` (an ``OSError``, exactly what a real dead link
    surfaces through urllib), so the caller's degradation path runs,
    not a special test path. Drops are either probabilistic
    (``drop_rate`` with a seedable ``rng``) or exactly scheduled
    (:meth:`drop_next` — the deterministic mode the step-synchronized
    tests use). Usable standalone::

        link = LossyLink(client, latency_s=0.05, drop_rate=0.3,
                         rng=random.Random(0))
        actor = ActorWorker(link, staging, fallback=...)

    Counting is on calls through THIS wrapper (``calls_total`` /
    ``drops_injected``) so tests can assert exactly which calls died.
    """

    def __init__(
        self,
        client: t.Any,
        drop_rate: float = 0.0,
        latency_s: float = 0.0,
        rng=None,
        sleep: t.Callable[[float], None] = None,
    ):
        if not 0.0 <= drop_rate <= 1.0:
            raise ValueError(f"drop_rate must be in [0, 1], got {drop_rate}")
        import random as _random
        import time as _time

        self._client = client
        self.drop_rate = float(drop_rate)
        self.latency_s = float(latency_s)
        self._rng = rng if rng is not None else _random.Random()
        self._sleep = sleep if sleep is not None else _time.sleep
        self._drop_left = 0
        self.calls_total = 0
        self.drops_injected = 0
        self.latency_injected_s = 0.0

    def drop_next(self, n: int) -> "LossyLink":
        """Deterministically drop the next ``n`` calls (cumulative with
        any already scheduled; takes precedence over ``drop_rate``)."""
        self._drop_left += int(n)
        return self

    def act(self, *args, **kwargs):
        self.calls_total += 1
        if self.latency_s > 0.0:
            self.latency_injected_s += self.latency_s
            self._sleep(self.latency_s)
        dropped = False
        if self._drop_left > 0:
            self._drop_left -= 1
            dropped = True
        elif self.drop_rate > 0.0 and self._rng.random() < self.drop_rate:
            dropped = True
        if dropped:
            self.drops_injected += 1
            raise ConnectionError(
                "injected lossy link: request dropped in flight "
                f"(call {self.calls_total})"
            )
        return self._client.act(*args, **kwargs)

    def __getattr__(self, name: str):
        return getattr(self._client, name)


class FlakyTransport:
    """Lossy/slow staging-push link: the LossyLink pattern moved from
    the acting path to the transport POST path (docs/RESILIENCE.md
    "Decoupled-plane failure modes", transport-flap row).

    Wraps the :class:`~torch_actor_critic_tpu_torch.decoupled.transport.
    RemoteStagingClient` ``post`` callable (``post(path, payload,
    timeout_s) -> (status, body)``) and, per call, injects configurable
    **latency** (``latency_s``, via the injectable ``sleep``) and
    **drops** — a dropped call raises ``ConnectionError`` (an
    ``OSError``, what a real dead link surfaces through urllib), so the
    client's jittered retry/backoff + the server's sequence-number
    dedup run, not a special test path. Drops are probabilistic
    (``drop_rate`` with a seedable ``rng``) or exactly scheduled
    (:meth:`drop_next`). Inject either directly::

        client._post = FlakyTransport(client._post, drop_rate=0.3)

    or, for spawned fleet actors, via the ``TAC_FLAKY_PUSH`` env var
    (``"drop_rate=0.3,latency_s=0.01,seed=0"`` — decoupled/fleet.py),
    which flaps the whole fleet's push path.
    """

    def __init__(
        self,
        post: t.Callable,
        drop_rate: float = 0.0,
        latency_s: float = 0.0,
        rng=None,
        sleep: t.Callable[[float], None] = None,
    ):
        if not 0.0 <= drop_rate <= 1.0:
            raise ValueError(f"drop_rate must be in [0, 1], got {drop_rate}")
        import random as _random
        import time as _time

        self._post = post
        self.drop_rate = float(drop_rate)
        self.latency_s = float(latency_s)
        self._rng = rng if rng is not None else _random.Random()
        self._sleep = sleep if sleep is not None else _time.sleep
        self._drop_left = 0
        self.calls_total = 0
        self.drops_injected = 0
        self.latency_injected_s = 0.0

    def drop_next(self, n: int) -> "FlakyTransport":
        """Deterministically drop the next ``n`` POSTs (cumulative;
        takes precedence over ``drop_rate``)."""
        self._drop_left += int(n)
        return self

    def __call__(self, path: str, payload: dict, timeout_s: float):
        self.calls_total += 1
        if self.latency_s > 0.0:
            self.latency_injected_s += self.latency_s
            self._sleep(self.latency_s)
        dropped = False
        if self._drop_left > 0:
            self._drop_left -= 1
            dropped = True
        elif self.drop_rate > 0.0 and self._rng.random() < self.drop_rate:
            dropped = True
        if dropped:
            self.drops_injected += 1
            raise ConnectionError(
                "injected flaky transport: POST dropped in flight "
                f"({path}, call {self.calls_total})"
            )
        return self._post(path, payload, timeout_s)


def kill_actor(
    target: t.Any, idx: int | None = None, join_timeout_s: float = 10.0
) -> int:
    """SIGKILL a fleet actor process and reap it.

    ``target`` is either a :class:`~torch_actor_critic_tpu_torch.decoupled.
    fleet.FleetSupervisor` with ``idx`` naming the actor slot, or a raw
    pid (``idx`` omitted). Joining before returning makes the death
    *observable*: the supervisor's next liveness poll deterministically
    finds a dead process (not a maybe-dead one), so the
    kill→purge→restart→dedup chain is step-synchronized in tests.
    Returns the killed pid.
    """
    if idx is not None:
        with target._lock:
            proc = target._procs.get(idx)
        if proc is None:
            raise ValueError(f"supervisor has no live actor in slot {idx}")
        pid = proc.pid
        os.kill(pid, signal.SIGKILL)
        proc.join(timeout=join_timeout_s)
        if proc.is_alive():  # pragma: no cover — SIGKILL cannot be blocked
            raise RuntimeError(f"actor {idx} (pid {pid}) survived SIGKILL")
        return pid
    pid = int(target)
    os.kill(pid, signal.SIGKILL)
    # Raw-pid mode: not our child (e.g. the smoke killing across a
    # process boundary) — waitpid would raise; the kernel reaps it.
    return pid


def nan_params(params: t.Mapping[str, t.Any], fraction_leaf: int = 0) -> dict:
    """NaN-poison a params mapping (a state dict of tensors or arrays):
    every float leaf (or just leaf index ``fraction_leaf`` onward, in the
    mapping's order — one poisoned leaf is enough for the sentinel)
    becomes all-NaN, in a new mapping of new tensors. The non-finite-output
    injector: swap the result into a serving slot
    (``registry.swap(..., validate=False)``) and the engine's all-finite
    flag reports every forward to the circuit breaker; a validated swap
    or publish refuses it."""
    import torch

    out = {}
    for i, (name, x) in enumerate(params.items()):
        if isinstance(x, torch.Tensor):
            poison = i >= fraction_leaf and x.is_floating_point()
            out[name] = torch.full_like(x, float("nan")) if poison else x.clone()
        else:
            x = np.asarray(x)
            poison = i >= fraction_leaf and np.issubdtype(x.dtype, np.floating)
            out[name] = np.full_like(x, np.nan) if poison else x.copy()
    return out


def flood(
    submit: t.Callable[..., t.Any],
    obs: t.Any,
    n_requests: int,
    **submit_kwargs,
) -> t.Tuple[list, list]:
    """Fire ``n_requests`` submits back-to-back (far past service
    rate) and return ``(futures, shed_errors)`` — accepted requests'
    futures versus the structured rejections admission control
    answered instead of queueing. ``submit`` is typically
    ``MicroBatcher.submit``; any exception that is not a rejection
    propagates (a flood must not hide real bugs)."""
    from torch_actor_critic_tpu_torch.serve.admission import ShedError

    futures, sheds = [], []
    for _ in range(int(n_requests)):
        try:
            futures.append(submit(obs, **submit_kwargs))
        except ShedError as e:
            sheds.append(e)
    return futures, sheds


def kill_env_worker(pool, idx: int, join_timeout_s: float = 10.0) -> int:
    """SIGKILL worker ``idx`` of a :class:`ParallelEnvPool` and reap it.

    Joining before returning makes the death *observable* — the next
    pool operation deterministically times out and diagnoses a dead
    worker (with its exit code) instead of racing the kernel. Returns
    the worker's exit code (``-SIGKILL``).
    """
    proc = pool._procs[idx]
    os.kill(proc.pid, signal.SIGKILL)
    proc.join(timeout=join_timeout_s)
    if proc.is_alive():  # pragma: no cover — SIGKILL cannot be blocked
        raise RuntimeError(f"worker {idx} survived SIGKILL")
    return proc.exitcode


def make_flaky(
    fn: t.Callable,
    failures: int,
    exc_factory: t.Callable[[], BaseException] = lambda: OSError(
        "injected transient checkpoint IO failure"
    ),
) -> t.Callable:
    """Wrap ``fn`` so its first ``failures`` calls raise, then it
    delegates — the transient-IO model for the retry path."""
    state = {"left": failures}

    def wrapper(*args, **kwargs):
        if state["left"] > 0:
            state["left"] -= 1
            raise exc_factory()
        return fn(*args, **kwargs)

    return wrapper


def corrupt_checkpoint(directory: str | Path, epoch: int, mode: str = "drop-item") -> Path:
    """Damage the on-disk epoch ``epoch`` of a
    :class:`~..utils.checkpoint.Checkpointer` like a save cut short:

    - ``"drop-item"``: remove ``state.pt`` (the learner state never
      landed);
    - ``"drop-meta"``: remove ``meta.json`` (cut even earlier: the epoch
      is unreadable at probe time);
    - ``"truncate"``: zero-truncate every ``.pt`` file (the structure
      exists, the bytes do not).

    Returns the corrupted epoch directory."""
    epoch_dir = Path(directory) / f"epoch_{int(epoch)}"
    if not epoch_dir.is_dir():
        raise FileNotFoundError(f"no checkpoint epoch dir {epoch_dir}")
    if mode == "drop-item":
        (epoch_dir / "state.pt").unlink()
    elif mode == "drop-meta":
        (epoch_dir / "meta.json").unlink()
    elif mode == "truncate":
        for f in epoch_dir.glob("*.pt"):
            f.write_bytes(b"")
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return epoch_dir
