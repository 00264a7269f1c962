"""Batched policy-inference service of the port (port of ``serve/``).

- :mod:`.engine` — the padded, bucketed policy forward with its
  on-device all-finite flag;
- :mod:`.batcher` — the micro-batching queue (continuous and group
  modes), admission control and deadlines;
- :mod:`.registry` — model slots with validated checkpoint hot-reload;
- :mod:`.server` — the stdlib HTTP frontend and the in-process client;
- :mod:`.fleet` — engine-per-device replication behind one admission
  layer, least-loaded and breaker-gated;
- :mod:`.sharded` — what the f32/bf16/int8 precision tiers do to the
  params and the module (an engine's ``precision``; sub-meshes above
  1x1 are not ported);
- :mod:`.router` — the multi-process fleet router (``--fleet N``);
- :mod:`.metrics`, :mod:`.admission`, :mod:`.breaker` — copied from the
  JAX package, which has no JAX in them.

Entry point: ``python -m torch_actor_critic_tpu_torch.serve``.
"""

from torch_actor_critic_tpu_torch.serve.admission import (  # noqa: F401
    BreakerOpenError,
    NonFiniteActionError,
    ShedError,
)
from torch_actor_critic_tpu_torch.serve.batcher import MicroBatcher  # noqa: F401
from torch_actor_critic_tpu_torch.serve.breaker import CircuitBreaker  # noqa: F401
from torch_actor_critic_tpu_torch.serve.engine import (  # noqa: F401
    ObsSpec,
    PolicyEngine,
)
from torch_actor_critic_tpu_torch.serve.fleet import EngineFleet  # noqa: F401
from torch_actor_critic_tpu_torch.serve.metrics import (  # noqa: F401
    ServeMetrics,
    aggregate_snapshots,
)
from torch_actor_critic_tpu_torch.serve.registry import ModelRegistry  # noqa: F401
from torch_actor_critic_tpu_torch.serve.router import FleetRouter  # noqa: F401
from torch_actor_critic_tpu_torch.serve.server import (  # noqa: F401
    PolicyClient,
    PolicyServer,
    install_drain_handler,
)
from torch_actor_critic_tpu_torch.serve.sharded import PRECISIONS  # noqa: F401
