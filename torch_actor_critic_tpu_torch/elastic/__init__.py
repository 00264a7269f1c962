"""Elastic fleets: the actuator over the obs plane.

``python -m torch_actor_critic_tpu_torch.serve --elastic on`` scales the
serving fleet with load (:class:`ElasticController` over a
:class:`FleetScaler`); ``python -m torch_actor_critic_tpu_torch.train
--actors N --elastic on`` degrades to the surviving actor slice when a
slot exhausts its restarts and re-admits it at an epoch boundary
(:class:`TrainingElasticManager`). Off (the default) constructs nothing:
no threads, no sockets, no metric keys.
"""

from torch_actor_critic_tpu_torch.elastic.controller import (
    DECISION_FIELDS,
    DecisionLog,
    ElasticController,
    ElasticPolicy,
)
from torch_actor_critic_tpu_torch.elastic.serving import FleetScaler
from torch_actor_critic_tpu_torch.elastic.training import TrainingElasticManager

__all__ = [
    "DECISION_FIELDS",
    "DecisionLog",
    "ElasticController",
    "ElasticPolicy",
    "FleetScaler",
    "TrainingElasticManager",
]
