"""Elastic serving fleet: the actuator over the obs plane.

``python -m torch_actor_critic_tpu_torch.serve --elastic on`` scales the
serving fleet with load (:class:`ElasticController` over a
:class:`FleetScaler`). Off (the default) constructs nothing: no
threads, no sockets, no metric keys. The JAX package's training-plane
manager (``TrainingElasticManager``: degrade to the surviving actor
slice) waits for the port's actor fleet, ROADMAP queue 1 item 8.
"""

from torch_actor_critic_tpu_torch.elastic.controller import (
    DECISION_FIELDS,
    DecisionLog,
    ElasticController,
    ElasticPolicy,
)
from torch_actor_critic_tpu_torch.elastic.serving import FleetScaler

__all__ = [
    "DECISION_FIELDS",
    "DecisionLog",
    "ElasticController",
    "ElasticPolicy",
    "FleetScaler",
]
