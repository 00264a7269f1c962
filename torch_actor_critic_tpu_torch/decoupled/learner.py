"""Decoupled learner: the hardened Trainer loop over the serving plane
(port of the JAX package's ``decoupled/learner.py``).

:class:`DecoupledTrainer` keeps every hardened piece of the host
:class:`~torch_actor_critic_tpu_torch.sac.trainer.Trainer` — divergence
sentinel, preemption guard, telemetry phases, diagnostics, cost
attribution, tiered replay, bitwise resume — and replaces only the data
path through the trainer's seams (``_stage``, ``_drain_window``,
``_epoch_boundary_hook``, the checkpoint seams):

- **Acting** goes through a :class:`~torch_actor_critic_tpu_torch.serve.
  server.PolicyClient` (an in-process registry and micro-batcher built
  here, or HTTP at ``config.serve_url``) via an :class:`~.actor.
  ActorWorker` — bounded retry, graceful degradation to the learner's own
  parameters (staleness-stamped), re-homing. On the card the in-process
  engine replays one CUDA graph per bucket; its parameters are the
  engine's own buffers, refilled from each publish.
- **Staging** is the bounded :class:`~.staging.StagingBuffer`: every
  transition is tagged with the serving response's ``(generation,
  epoch)``, drained in fixed windows through the bounded-staleness gate
  into the unchanged replay and update path. A boundary where the gate
  leaves less than a window skips its device work: no chunk of another
  shape reaches the burst, so its CUDA graph is never captured again.
- **Publishing**: each sentinel-validated epoch swaps a snapshot of the
  actor (:meth:`~..sac.trainer.Trainer.publish_params`: new tensors in a
  new mapping, cloned after the epoch's last burst on the learner's
  stream) into the registry through the validated hot swap; a non-finite
  publish is *rejected* and actors keep acting on the last good one. The
  learner's live parameters are the burst graph's static inputs, written
  in place by every replay, so they are never handed over. In
  ``serve_url`` mode the epoch checkpoint IS the publish: the remote
  worker's reload poller picks it up.
- **One card, two threads**: the batcher's thread replays the engine's
  graphs while the training thread runs the bursts. A burst that captures
  its graph does so with the engine quiesced (:meth:`_burst` holds it in
  ``PolicyEngine.quiesced``), so no launch, synchronization or allocation of
  the serving thread can fall inside the capture; requests that arrive
  meanwhile wait, and none fails.
- **Fault tolerance**: checkpoints also carry the staged but undrained
  transitions (``arrays.pt``), the staging counters and lag histogram,
  and the batcher's sampled-action generator, so a SIGTERM on the
  learner (requeue code 75) loses no accepted transition and the replay
  stream is **bitwise** across the resume.
"""

from __future__ import annotations

import copy
import logging
import typing as t

import numpy as np
import torch

from torch_actor_critic_tpu_torch.core.types import MultiObservation, tree_map
from torch_actor_critic_tpu_torch.decoupled.actor import ActorWorker
from torch_actor_critic_tpu_torch.decoupled.staging import StagingBuffer
from torch_actor_critic_tpu_torch.decoupled.transport import canonical_transition
from torch_actor_critic_tpu_torch.envs.vec_env import stack_obs
from torch_actor_critic_tpu_torch.sac.trainer import Trainer

logger = logging.getLogger(__name__)

__all__ = ["DecoupledTrainer", "StagedArrays"]


class StagedArrays:
    """The staged tail as a named checkpoint object (``arrays.pt``):
    :meth:`state_dict` holds :meth:`StagingBuffer.export_arrays`' arrays
    as tensors (bitwise; a visual obs as ``{"features", "frame"}``), and
    :meth:`load_state_dict_` takes them back for :meth:`arrays`."""

    def __init__(self, arrays: t.Mapping[str, t.Any] | None = None):
        self._arrays = dict(arrays or {})

    def state_dict(self) -> dict:
        def leaf(x):
            if isinstance(x, MultiObservation):
                return {"features": torch.from_numpy(np.ascontiguousarray(x.features)),
                        "frame": torch.from_numpy(np.ascontiguousarray(x.frame))}
            return torch.from_numpy(np.ascontiguousarray(x))

        return {k: leaf(v) for k, v in self._arrays.items()}

    def load_state_dict_(self, saved: t.Mapping[str, t.Any]) -> None:
        def leaf(x):
            if isinstance(x, dict):
                return MultiObservation(x["features"].numpy(), x["frame"].numpy())
            return x.numpy()

        self._arrays = {k: leaf(v) for k, v in saved.items()}

    def arrays(self) -> dict:
        return self._arrays


class DecoupledTrainer(Trainer):
    """Trainer whose actors act through the serving plane.

    Accepts every :class:`Trainer` argument; ``client`` injects a
    pre-built :class:`PolicyClient` (tests wrap it in the lossy-link
    fault injector), otherwise ``config.serve_url`` selects HTTP mode
    and the default builds a co-located in-process serving plane
    (registry + micro-batcher) that doubles as this process's policy
    service — ``metrics_snapshot`` plugs into a ``PolicyServer``'s
    ``extra_snapshot`` to put staging and staleness on ``/metrics``.
    """

    def __init__(self, *args, client=None, **kwargs):
        super().__init__(*args, **kwargs)
        cfg = self.config
        self.staging = StagingBuffer(
            capacity=cfg.resolved_staging_capacity,
            policy=cfg.staging_policy,
            max_lag=cfg.max_actor_lag,
        )
        self._published_generation = 0
        self._published_epoch: int | None = None
        self._publish_rejected_total = 0
        self._collecting = False
        self._last_tag: t.Tuple[int, int | None] = (0, None)
        self.registry = None
        self.batcher = None
        self._owns_plane = False
        if client is not None:
            self.client = client
        elif cfg.serve_url:
            from torch_actor_critic_tpu_torch.serve.server import PolicyClient

            self.client = PolicyClient(url=cfg.serve_url, retries=1, backoff_s=0.1)
        else:
            self._build_inprocess_plane()
        self.actor = ActorWorker(
            self.client,
            self.staging,
            fallback=self._local_fallback,
            act_timeout_s=cfg.actor_timeout_s,
            probe_every=4,
        )

    def _build_inprocess_plane(self) -> None:
        """Co-located serving plane: one registry slot holding a copy of
        this learner's actor module, behind a real micro-batcher — the
        stack the serve CLI runs, so "training feeds serving" is one code
        path whether the fleet is in-process or remote. On the card the
        slot's warm-up captures its graphs here (2 a bucket)."""
        from torch_actor_critic_tpu_torch.serve.batcher import MicroBatcher
        from torch_actor_critic_tpu_torch.serve.registry import ModelRegistry
        from torch_actor_critic_tpu_torch.serve.server import PolicyClient

        serve_batch = max(self.population, 1)
        self.registry = ModelRegistry(device=self.device)
        # The engine runs a copy of the module (it sets eval mode and
        # calls it functionally on published parameters): the learner's
        # own module is never touched by the serving thread.
        actor_def = copy.deepcopy(self.state.actor).requires_grad_(False)
        self.registry.register(
            "default",
            actor_def,
            self.pool.obs_spec,
            params=self.publish_params(),
            max_batch=serve_batch,
            warmup=True,
        )
        self.batcher = MicroBatcher(self.registry, max_batch=serve_batch, seed=self.seed + 7919)
        self.client = PolicyClient(self.registry, self.batcher, retries=1, backoff_s=0.05)
        self._owns_plane = True

    # ------------------------------------------------------------- acting

    def _local_fallback(self, obs, deterministic):
        """Degraded-mode acting: the learner-local path the base trainer
        uses (its live actor, or the acting snapshot under
        ``actor_param_lag``), stamped with the last PUBLISHED generation
        and epoch — what degraded transitions honestly are to the gate."""
        actions = Trainer._policy_actions(self, obs, deterministic)
        return actions, self._published_generation, self._published_epoch

    def _policy_actions(self, obs_batch, deterministic: bool = False) -> np.ndarray:
        if deterministic or not self._collecting:
            # Evaluation (and any deterministic rollout) reads the
            # current learner parameters directly, as the lockstep trainer.
            return super()._policy_actions(obs_batch, deterministic)
        actions, generation, epoch, _ = self.actor.act(obs_batch, deterministic=False)
        self._last_tag = (generation, epoch)
        return np.asarray(actions)

    def train(self, on_epoch: t.Callable[[int, dict], None] | None = None,
              render: bool = False) -> dict:
        self._collecting = True
        try:
            return super().train(on_epoch, render)
        finally:
            self._collecting = False

    def _burst(self, chunk, num_updates: int):
        """The base burst; one that captures its graph runs with the
        in-process engine quiesced (:meth:`PolicyEngine.quiesced`), so the
        serving thread launches nothing while the training thread captures."""
        quiesce = (self.registry is not None and self.device.type == "cuda"
                   and self.sac.would_capture(self.state, self.buffer, num_updates))
        if not quiesce:
            return super()._burst(chunk, num_updates)
        engine, _, _ = self.registry.acquire("default")
        with engine.quiesced():
            return super()._burst(chunk, num_updates)

    # ------------------------------------------------------------ staging

    def _canonical_transition(self, transition: tuple) -> tuple:
        """Pin the staged dtypes to the env spec (obs leaves to the spec's
        dtype, the rest float32), so checkpointed staging arrays restore at
        one shape and dtype whatever a normalizer produced."""
        return canonical_transition(transition, self.pool.obs_spec)

    def _stage(self, staging, transitions) -> None:
        # `staging` (the base loop's per-env lists) is unused: transitions
        # live in the bounded buffer, under its backpressure policy, as one
        # batched transition a step (leading axis = env).
        generation, epoch = self._last_tag
        batched = (
            stack_obs([tr[0] for tr in transitions]),
            np.stack([np.asarray(tr[1]) for tr in transitions]),
            np.asarray([tr[2] for tr in transitions], np.float32),
            stack_obs([tr[3] for tr in transitions]),
            np.asarray([tr[4] for tr in transitions], np.float32),
        )
        self.staging.put(self._canonical_transition(batched),
                         generation=generation, epoch=epoch)

    def _drain_window(self, staging):
        entries = self.staging.pop_window(self.config.update_every, current_epoch=self._epoch)
        if entries is None:
            return None
        return self._build_chunk([e.transition for e in entries])

    def _build_chunk(self, transitions: t.Sequence[tuple]):
        """A window of batched transitions as the base trainer's host
        chunk: each env's rows, stacked in order (the lockstep chunk's
        layout and dtypes)."""
        n = self.population
        per_env = [
            [(tree_map(lambda x, i=i: x[i], tr[0]), tr[1][i], tr[2][i],
              tree_map(lambda x, i=i: x[i], tr[3]), tr[4][i]) for tr in transitions]
            for i in range(n)
        ]
        return self._stage_chunk(per_env)

    # --------------------------------------------------------- publishing

    def _publish_epoch(self, epoch: int, saved: bool) -> None:
        if self.registry is not None:
            try:
                generation = self.registry.swap(
                    "default", self.publish_params(), epoch=int(epoch))
            except ValueError as e:
                # The validated hot swap: a non-finite publish is rejected;
                # the slot keeps serving the last good parameters and
                # actors never see the poison.
                self._publish_rejected_total += 1
                logger.warning(
                    "epoch %d publish REJECTED (%s); actors keep acting on "
                    "generation %d (epoch %s)",
                    epoch, e, self._published_generation, self._published_epoch,
                )
                return
            self._published_generation += 1
            self._published_epoch = int(epoch)
            logger.debug("published epoch %d as generation %d", epoch, generation)
        elif saved:
            # Remote serving: the epoch checkpoint IS the publish — the
            # worker's hot-reload poller validates and swaps it.
            self._published_generation += 1
            self._published_epoch = int(epoch)

    def _epoch_boundary_hook(self, epoch, sentinel_ok, saved, last_metrics, rec) -> None:
        if sentinel_ok:
            self._publish_epoch(epoch, saved)
        snap = self.staging.snapshot()
        actor = self.actor.stats()
        lag = snap["actor_lag"]
        last_metrics.update({
            "decoupled/staged_total": snap["staged_total"],
            "decoupled/drained_total": snap["drained_total"],
            "decoupled/dropped_stale_total": snap["dropped_stale_total"],
            "decoupled/dropped_backpressure_total": snap["dropped_backpressure_total"],
            "decoupled/dropped_dead_actor_total": snap["dropped_dead_actor_total"],
            "decoupled/shed_total": snap["shed_total"],
            "decoupled/blocked_total": snap["blocked_total"],
            "decoupled/staging_depth": snap["depth"],
            # The conservation invariant, checked every epoch: staged ==
            # drained + dropped_stale + dropped_backpressure +
            # dropped_dead_actor + depth.
            "decoupled/conservation_ok": float(self.staging.conservation_holds()),
            "decoupled/actor_lag_mean": lag.get("actor_lag_mean", 0.0),
            "decoupled/actor_lag_p95": lag.get("actor_lag_p95", 0.0),
            "decoupled/actor_lag_max": lag.get("actor_lag_max", 0.0),
            "decoupled/serving_actions_total": actor["serving_actions_total"],
            "decoupled/fallback_actions_total": actor["fallback_actions_total"],
            "decoupled/degradations_total": actor["degradations_total"],
            "decoupled/rehomes_total": actor["rehomes_total"],
            "decoupled/degraded": float(actor["degraded"]),
            "decoupled/published_generation": self._published_generation,
            "decoupled/publish_rejected_total": self._publish_rejected_total,
            "decoupled/client_retries_total": self.client.retries_total,
        })
        # Lag drift is a leading indicator of a sick actor↔serving link (a
        # degraded fleet keeps feeding ever-staler data until the gate
        # bites): it goes through the early-warning monitor into the
        # sentinel, like the in-graph diagnostics.
        if self.monitor is not None:
            for w in self.monitor.update(
                    {"decoupled/actor_lag_mean": lag.get("actor_lag_mean", 0.0)}):
                logger.warning(
                    "early warning %s: %s=%.4g vs baseline %.4g (deviation envelope "
                    "%.4g) — actor staleness drifting",
                    w["kind"], w["key"], w["value"], w["baseline"], w["spread"],
                )
                if self.sentinel is not None:
                    self.sentinel.note_warning(w["kind"])
                if rec is not None:
                    rec.event("early_warning", epoch=int(epoch), **w)
        if rec is not None:
            rec.event(
                "decoupled", epoch=int(epoch), staging=snap, actor=actor,
                published_generation=self._published_generation,
                publish_rejected_total=self._publish_rejected_total,
            )

    # --------------------------------------------------------- checkpoint

    def _checkpoint_extra(self, step: int) -> dict:
        extra = super()._checkpoint_extra(step)
        dec = {
            "staging": self.staging.meta_state(),
            "published_generation": self._published_generation,
            "published_epoch": self._published_epoch,
            "publish_rejected_total": self._publish_rejected_total,
            "actor": self.actor.stats(),
        }
        if self.batcher is not None:
            # The serving plane's sampled-action generator is part of the
            # run: a resume continues its stream bitwise.
            dec["batcher_key"] = self.batcher.export_key()
        extra["decoupled"] = dec
        return extra

    def _checkpoint_arrays(self):
        arrays = self.staging.export_arrays()
        return None if arrays is None else {"staging": StagedArrays(arrays)}

    def _checkpoint_abstract_arrays(self, meta_probe: dict):
        dec = (meta_probe or {}).get("decoupled") or {}
        count = int((dec.get("staging") or {}).get("count", 0))
        return {"staging": StagedArrays()} if count else None

    def _restore_extras(self, meta: dict, arrays) -> None:
        dec = meta.get("decoupled") or {}
        if dec.get("staging"):
            self.staging.load_meta(dec["staging"])
        if arrays is not None:
            restored = self.staging.import_arrays(arrays["staging"].arrays())
            logger.info(
                "restored %d staged transitions from the checkpoint (zero accepted "
                "transitions lost across the restart)", restored,
            )
        self._published_generation = int(dec.get("published_generation", 0))
        self._published_epoch = dec.get("published_epoch")
        self._publish_rejected_total = int(dec.get("publish_rejected_total", 0))
        self.actor.load_stats(dec.get("actor") or {})
        if self.batcher is not None and dec.get("batcher_key"):
            self.batcher.import_key(dec["batcher_key"])
        if self.registry is not None:
            # Refresh the co-located slot to the restored weights, so
            # serving resumes from the checkpointed policy.
            try:
                self.registry.swap("default", self.publish_params(), epoch=meta.get("epoch"))
            except ValueError as e:  # pragma: no cover — a restored
                # checkpoint is sentinel-validated; belt and braces
                logger.warning(
                    "restored params rejected by the serving sentinel (%s); the slot "
                    "keeps its current params", e,
                )

    # ------------------------------------------------------- introspection

    def metrics_snapshot(self) -> dict:
        """``/metrics``-mergeable view of the decoupled plane — pass as
        ``PolicyServer(extra_snapshot=...)`` so a co-located server reports
        staging depth, backpressure counts and the actor-lag histogram next
        to its serving metrics."""
        return {
            "decoupled": {
                "staging": self.staging.snapshot(),
                "actor": self.actor.stats(),
                "published_generation": self._published_generation,
                "published_epoch": self._published_epoch,
                "publish_rejected_total": self._publish_rejected_total,
            }
        }

    def close(self) -> None:
        if self._owns_plane:
            self._owns_plane = False
            try:
                self.batcher.close()
            finally:
                self.registry.close()
        super().close()
