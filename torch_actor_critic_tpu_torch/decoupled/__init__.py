"""Decoupled actor/learner plane (port of the JAX package's
``decoupled/``): actors act through the serving plane, transitions flow
through a bounded staging buffer with a staleness admission gate, and
the learner publishes epochs through the validated hot swap.
``--actors N`` scales the actor side to a supervised process fleet over
a networked staging transport (``fleet.py`` / ``transport.py``):
heartbeat liveness, SIGKILL-reap and jittered-backoff restarts, and
idempotent per-actor sequence-numbered ingestion, with the conservation
invariant extended across process boundaries."""

from torch_actor_critic_tpu_torch.decoupled.actor import ActorWorker
from torch_actor_critic_tpu_torch.decoupled.fleet import (
    FleetSupervisor,
    FleetTrainer,
    actor_main,
)
from torch_actor_critic_tpu_torch.decoupled.learner import DecoupledTrainer
from torch_actor_critic_tpu_torch.decoupled.staging import (
    StagedTransition,
    StagingBuffer,
    StagingUnavailable,
)
from torch_actor_critic_tpu_torch.decoupled.transport import (
    RemoteStagingClient,
    StagingTransportServer,
)

__all__ = [
    "ActorWorker",
    "DecoupledTrainer",
    "FleetSupervisor",
    "FleetTrainer",
    "RemoteStagingClient",
    "StagedTransition",
    "StagingBuffer",
    "StagingTransportServer",
    "StagingUnavailable",
    "actor_main",
]
