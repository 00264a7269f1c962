"""Training-plane elasticity: degrade to the surviving slice, re-admit
at an epoch boundary (port of the JAX package's ``elastic/training.py``).

The :class:`~torch_actor_critic_tpu_torch.decoupled.fleet.FleetSupervisor`
survives actor deaths with bounded restarts; a slot past its budget is
abandoned (``gave_up``) and its staged tail purged — the conservation
invariant's ``dropped_dead_actor`` term is exactly the lost slice's term,
so the ledger stays green through the loss. The elastic layer on top:

- :meth:`TrainingElasticManager.poll_epoch` runs at every epoch
  boundary. A newly abandoned slot becomes a counted ``degrade``
  decision (the run now trains on the surviving slice); a slot that
  has served ``readmit_epochs`` degraded epochs is re-admitted through
  the supervisor's budget-reset respawn (:meth:`FleetSupervisor.readmit`)
  as a counted ``readmit`` decision.
- Checkpoints carry the degraded topology: :meth:`snapshot` stamps the
  degraded slot table plus the process topology, and :meth:`restore`
  rebuilds it on resume, so a learner that checkpointed degraded resumes
  degraded and re-admits on its own schedule, not by accident. The port
  trains in one process (:func:`single_process_topology`); the JAX
  package stamps its ``jax.distributed`` topology here, which the port's
  multi-device training (ROADMAP queue 1 item 6) extends.

Decisions share the run's :class:`~torch_actor_critic_tpu_torch.elastic.
controller.DecisionLog`, so train-plane degradations land on the same
Perfetto elastic lane as the serving plane's spawns and drains.
"""

from __future__ import annotations

import logging
import typing as t

from torch_actor_critic_tpu_torch.elastic.controller import DecisionLog

logger = logging.getLogger(__name__)

__all__ = ["TrainingElasticManager", "single_process_topology"]


def single_process_topology() -> dict:
    """The port's training topology: one process on one device, under the
    keys of the JAX package's ``parallel.distributed.topology_snapshot``."""
    return {"process_count": 1, "process_index": 0, "local_device_count": 1,
            "global_device_count": 1}


class TrainingElasticManager:
    """Epoch-boundary degrade/re-admit over a :class:`FleetSupervisor`.

    ``supervisor`` needs ``stats()`` (``gave_up``, ``alive``,
    ``purged_on_death_total``, per-actor ``actors``) and ``readmit(aid)
    -> bool``. ``topology`` is injectable for tests; the default stamps
    the port's one process (:func:`single_process_topology`).
    """

    def __init__(
        self,
        supervisor,
        n_actors: int,
        log: DecisionLog | None = None,
        readmit_epochs: int = 1,
        topology: t.Callable[[], dict] | None = None,
    ):
        if readmit_epochs < 1:
            raise ValueError(
                f"readmit_epochs must be >= 1, got {readmit_epochs}"
            )
        self.supervisor = supervisor
        self.n_actors = int(n_actors)
        self.log = log if log is not None else DecisionLog()
        self.readmit_epochs = int(readmit_epochs)
        self._topology = topology if topology is not None else single_process_topology
        # aid -> {"epoch": degrade epoch, "incarnation": at degrade}.
        # Single-threaded access: poll_epoch/snapshot/restore all run
        # on the learner's epoch-boundary path.
        self._degraded: t.Dict[int, dict] = {}

    # ------------------------------------------------------------- epochs

    def poll_epoch(self, epoch: int) -> t.List[dict]:
        """One epoch-boundary pass: degrade newly abandoned slots,
        re-admit slots whose penance is served. Returns the decisions
        taken (most epochs: none)."""
        stats = self.supervisor.stats()
        gave_up = set(stats.get("gave_up") or ())
        decisions: t.List[dict] = []
        for aid in sorted(gave_up - set(self._degraded)):
            before = self.n_actors - len(self._degraded)
            actor = (stats.get("actors") or {}).get(aid, {})
            self._degraded[aid] = {
                "epoch": int(epoch),
                "incarnation": int(actor.get("incarnation", 0)),
            }
            decisions.append(self.log.record(
                "degrade", "train", "restart_budget_exhausted",
                rule=None, replicas_before=before,
                replicas_after=before - 1, outcome="degraded",
                actor_id=int(aid), epoch=int(epoch),
                purged_on_death_total=int(
                    stats.get("purged_on_death_total", 0)
                ),
            ))
        for aid in sorted(self._degraded):
            if aid not in gave_up:
                # The supervisor recovered the slot some other way
                # (e.g. an operator readmit); just stop tracking it.
                self._degraded.pop(aid)
                continue
            if epoch - self._degraded[aid]["epoch"] < self.readmit_epochs:
                continue
            before = self.n_actors - len(self._degraded)
            ok = bool(self.supervisor.readmit(aid))
            if not ok:
                continue
            info = self._degraded.pop(aid)
            decisions.append(self.log.record(
                "readmit", "train",
                f"degraded_epochs:{int(epoch) - info['epoch']}",
                rule=None, replicas_before=before,
                replicas_after=before + 1, outcome="readmitted",
                actor_id=int(aid), epoch=int(epoch),
            ))
        return decisions

    # --------------------------------------------------------- checkpoint

    def snapshot(self) -> dict:
        """The checkpoint-carried degraded topology: which slots are
        degraded (and since when), how many survive, and the process
        topology the checkpoint was cut under."""
        return {
            "n_actors": self.n_actors,
            "degraded": {
                str(aid): dict(info)
                for aid, info in sorted(self._degraded.items())
            },
            "surviving": self.n_actors - len(self._degraded),
            "readmit_epochs": self.readmit_epochs,
            "topology": self._topology(),
        }

    def restore(self, state: t.Mapping[str, t.Any] | None) -> None:
        """Rebuild the degraded-slot table from a checkpoint so a
        resume continues the degraded run instead of resetting the
        re-admission clock."""
        if not state:
            return
        self._degraded = {
            int(aid): dict(info)
            for aid, info in (state.get("degraded") or {}).items()
        }
        saved = state.get("topology") or {}
        live = self._topology()
        if saved and saved.get("process_count") != live.get(
            "process_count"
        ):
            logger.warning(
                "resuming under a different process topology than the "
                "checkpoint was cut under (%s hosts -> %s)",
                saved.get("process_count"), live.get("process_count"),
            )
        if self._degraded:
            logger.info(
                "restored degraded topology: slots %s degraded, %d of "
                "%d surviving", sorted(self._degraded),
                self.n_actors - len(self._degraded), self.n_actors,
            )

    # ------------------------------------------------------------ metrics

    def metrics(self) -> dict:
        """The ``elastic/`` columns FleetTrainer mirrors into
        metrics.jsonl each epoch (absent entirely when elastic is off —
        the key-pin contract)."""
        counts = self.log.counts()
        return {
            "elastic/degraded_slots": len(self._degraded),
            "elastic/surviving": self.n_actors - len(self._degraded),
            "elastic/degrade_total": counts.get("degrade", 0),
            "elastic/readmit_total": counts.get("readmit", 0),
            "elastic/decisions_total": counts.get("decisions_total", 0),
        }
