"""Actor-side of the decoupled plane: act through serving, degrade, re-home
(port of the JAX package's ``decoupled/actor.py``).

:class:`ActorWorker` owns the actor↔serving link (docs/RESILIENCE.md
"Decoupled-plane failure modes"): action selection goes through a
:class:`~torch_actor_critic_tpu_torch.serve.server.PolicyClient` (in-process
against a co-located registry, or HTTP against a worker / the fleet
router — the client's retry/backoff is transport-agnostic), and every
response's ``(generation, epoch)`` stamps the transitions it produces.

On serving unavailability — breaker open, drain, timeout, connection
loss, or a lossy link — the worker **degrades instead of stalling
envs**: the client's own bounded, deadline-aware retry runs first;
when that fails, acting falls back to a **last-known local param
snapshot** (the callable the learner hands it), whose transitions are
staleness-stamped with the snapshot's publish epoch so the staging
gate — not luck — bounds how much degraded data enters training. While
degraded, the serving plane is re-probed every ``probe_every`` acting
steps (cheap: one bounded call) and the worker **re-homes** on the
first success. Every state change is counted
(``degradations_total``/``fallback_actions_total``/``rehomes_total``).

:meth:`run` is the standalone loop for remote/threaded actors: step a
pool, stage tagged transitions, and — when the staging buffer is
paused because the learner is checkpointing or restarting —
**idle-spin with bounded backoff and reconnect**, retrying the SAME
transition so a learner restart loses nothing actor-side.
"""

from __future__ import annotations

import logging
import time
import typing as t
from concurrent.futures import TimeoutError as FutureTimeoutError

import numpy as np

from torch_actor_critic_tpu_torch.core.types import MultiObservation, tree_map
from torch_actor_critic_tpu_torch.decoupled.staging import (
    StagingBuffer,
    StagingUnavailable,
)
from torch_actor_critic_tpu_torch.serve.admission import ShedError

logger = logging.getLogger(__name__)

__all__ = ["ActorWorker"]

# Serving-unavailability classes the degradation path absorbs: sheds
# (breaker/drain/queue/deadline taxonomy), connection-level failures
# (OSError covers urllib's URLError and injected lossy links), backend
# timeouts, and engine faults surfaced as RuntimeError (the HTTP 5xx
# analogue). Request-shape errors (ValueError/TypeError) propagate —
# falling back would hide a real bug.
_DEGRADABLE = (
    ShedError, OSError, FutureTimeoutError, TimeoutError, RuntimeError,
)


def _set_row(obs: t.Any, i: int, value: t.Any) -> None:
    """Write ``value`` into row ``i`` of a batched observation in place
    (leaf by leaf for a :class:`MultiObservation`)."""
    if isinstance(obs, MultiObservation):
        obs.features[i] = value.features
        obs.frame[i] = value.frame
    else:
        obs[i] = value


class ActorWorker:
    """One host actor: envs in, tagged transitions out, via serving.

    ``fallback(obs, deterministic) -> (actions, generation, epoch)`` is
    the local-snapshot acting path (the learner supplies one built on
    its own param mirror, stamped with the last published generation/
    epoch); ``fallback=None`` makes serving failures fatal (a pure
    remote actor with no weights of its own).
    """

    def __init__(
        self,
        client,
        staging: StagingBuffer,
        fallback: t.Callable[..., tuple] | None = None,
        slot: str = "default",
        act_timeout_s: float = 5.0,
        probe_every: int = 8,
        idle_backoff_s: float = 0.05,
        max_idle_backoff_s: float = 1.0,
        sleep: t.Callable[[float], None] = time.sleep,
    ):
        if probe_every < 1:
            raise ValueError(f"probe_every must be >= 1, got {probe_every}")
        self.client = client
        self.staging = staging
        self.fallback = fallback
        self.slot = slot
        self.act_timeout_s = float(act_timeout_s)
        self.probe_every = int(probe_every)
        self.idle_backoff_s = float(idle_backoff_s)
        self.max_idle_backoff_s = float(max_idle_backoff_s)
        self._sleep = sleep
        self.degraded = False
        self.last_error: str | None = None
        self._since_probe = 0
        # Counted link-state outcomes.
        self.serving_actions_total = 0
        self.fallback_actions_total = 0
        self.degradations_total = 0
        self.rehomes_total = 0
        self.probes_total = 0
        self.idle_spins_total = 0

    # ------------------------------------------------------------- acting

    def act(
        self, obs: t.Any, deterministic: bool = False
    ) -> t.Tuple[np.ndarray, int, int | None, str]:
        """Select actions for a batched observation; returns
        ``(actions, generation, epoch, source)`` where ``source`` is
        ``"serving"`` or ``"fallback"``. Never stalls the env loop on a
        dead serving plane: while degraded only every ``probe_every``-th
        call pays a (bounded) serving attempt."""
        if self.degraded:
            self._since_probe += 1
            if self._since_probe < self.probe_every:
                return self._act_fallback(obs, deterministic)
            self._since_probe = 0
            self.probes_total += 1
        try:
            res = self.client.act(
                obs, deterministic=deterministic, slot=self.slot,
                timeout=self.act_timeout_s,
            )
        except _DEGRADABLE as e:
            self.last_error = f"{type(e).__name__}: {e}"
            if self.fallback is None:
                raise
            if not self.degraded:
                self.degraded = True
                self.degradations_total += 1
                self._since_probe = 0
                logger.warning(
                    "serving plane unavailable (%s); degrading to the "
                    "local param snapshot (probing every %d steps)",
                    self.last_error, self.probe_every,
                )
            return self._act_fallback(obs, deterministic)
        if self.degraded:
            self.degraded = False
            self.rehomes_total += 1
            logger.info(
                "serving plane recovered after %d fallback actions; "
                "re-homed", self.fallback_actions_total,
            )
        self.serving_actions_total += 1
        return (
            np.asarray(res.action), int(res.generation), res.epoch,
            "serving",
        )

    def _act_fallback(self, obs, deterministic):
        self.fallback_actions_total += 1
        actions, generation, epoch = self.fallback(obs, deterministic)
        return np.asarray(actions), int(generation), epoch, "fallback"

    # ------------------------------------------------------------ staging

    def stage(
        self, transition: tuple, generation: int, epoch: int | None,
        stop: t.Optional[t.Any] = None,
    ) -> bool:
        """Put one tagged transition, idle-spinning with bounded
        backoff while the staging buffer is paused (learner away).
        Returns False only when ``stop`` was set before the buffer
        reopened — the transition is then abandoned by shutdown, not
        lost to a restart."""
        backoff = self.idle_backoff_s
        while stop is None or not stop.is_set():
            try:
                self.staging.put(
                    transition, generation=generation, epoch=epoch
                )
                return True
            except StagingUnavailable:
                self.idle_spins_total += 1
                self._sleep(backoff)
                backoff = min(backoff * 2, self.max_idle_backoff_s)
        return False

    # ----------------------------------------------------- standalone loop

    def run(
        self,
        pool,
        stop,
        seeds: t.Sequence[int],
        max_steps: int | None = None,
        sample_until: int = 0,
    ) -> int:
        """Standalone collection loop (remote/threaded actors): step
        the pool, stage tagged transitions, reset finished episodes.
        ``stop`` is a ``threading.Event``; ``seeds`` seed the pool's
        envs; the first ``sample_until`` steps act randomly (warmup).
        Returns the number of lockstep steps taken. The trainer-driven
        path does NOT use this — the :class:`~torch_actor_critic_tpu_torch.
        decoupled.learner.DecoupledTrainer` drives acting inline
        through :meth:`act`/:meth:`stage` so its loop keeps the
        hardened epoch machinery."""
        obs = pool.reset_all(list(seeds))
        steps = 0
        while not stop.is_set() and (
            max_steps is None or steps < max_steps
        ):
            if steps < sample_until:
                actions, gen, epoch = pool.sample_actions(), 0, None
            else:
                actions, gen, epoch, _ = self.act(obs)
            next_obs, rewards, terms, truncs = pool.step(actions)
            terms = np.asarray(terms, bool)
            truncs = np.asarray(truncs, bool)
            transition = (
                obs,
                np.asarray(actions),
                np.asarray(rewards, np.float32),
                tree_map(np.array, next_obs),
                terms.astype(np.float32),
            )
            if not self.stage(transition, gen, epoch, stop=stop):
                break
            ended = terms | truncs
            for i in map(int, np.flatnonzero(ended)):
                _set_row(next_obs, i, pool.reset_at(i))
            obs = next_obs
            steps += 1
        return steps

    # ------------------------------------------------------ introspection

    def stats(self) -> dict:
        return {
            "degraded": self.degraded,
            "last_error": self.last_error,
            "serving_actions_total": self.serving_actions_total,
            "fallback_actions_total": self.fallback_actions_total,
            "degradations_total": self.degradations_total,
            "rehomes_total": self.rehomes_total,
            "probes_total": self.probes_total,
            "idle_spins_total": self.idle_spins_total,
        }

    def load_stats(self, stats: t.Mapping[str, t.Any]) -> None:
        """Restore the counted link-state totals from a checkpoint (the
        degraded flag itself is live state — a resumed learner's actor
        re-probes from scratch)."""
        for key in (
            "serving_actions_total", "fallback_actions_total",
            "degradations_total", "rehomes_total", "probes_total",
            "idle_spins_total",
        ):
            if key in stats:
                setattr(self, key, int(stats[key]))
