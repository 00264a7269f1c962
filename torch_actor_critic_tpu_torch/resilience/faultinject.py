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

Injection is compositional: build a normal Trainer, then
``trainer.pool = FaultyEnvPool(trainer.pool, ...)``.
"""

from __future__ import annotations

import typing as t
from pathlib import Path

import numpy as np

from torch_actor_critic_tpu_torch.core.types import MultiObservation

__all__ = ["FaultyEnvPool", "make_flaky", "corrupt_checkpoint"]


class FaultyEnvPool:
    """Protocol-transparent env-pool wrapper with step-scheduled faults.

    The port's trainer drives its one env through ``step_at(0,
    action)`` and ``reset_at``; step numbering counts ``step_at`` calls
    on THIS wrapper, starting at 0 — i.e. the trainer's lockstep steps.
    Every attribute not overridden here proxies to the wrapped pool.
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

    def nan_rewards_at(self, step: int) -> "FaultyEnvPool":
        """Replace the scheduled step's reward with NaN."""

        def corrupt(obs, reward, terminated, truncated):
            return obs, np.float32(np.nan), terminated, truncated

        self._corrupt.setdefault(step, []).append(corrupt)
        return self

    def nan_obs_at(self, step: int) -> "FaultyEnvPool":
        """NaN the scheduled step's next observation (its float leaves;
        uint8 frames cannot hold NaN)."""

        def poison(x):
            x = np.array(x)
            if np.issubdtype(x.dtype, np.floating):
                x[...] = np.nan
            return x

        def corrupt(obs, reward, terminated, truncated):
            obs = obs.map(poison) if isinstance(obs, MultiObservation) else poison(obs)
            return obs, reward, terminated, truncated

        self._corrupt.setdefault(step, []).append(corrupt)
        return self

    def step_at(self, i: int, action):
        n = self._step_count
        self._step_count += 1
        for fn in self._before.pop(n, []):
            fn()
        out = self._pool.step_at(i, action)
        for corrupt in self._corrupt.pop(n, []):
            out = corrupt(*out)
        return out

    def __getattr__(self, name: str):
        return getattr(self._pool, name)


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
