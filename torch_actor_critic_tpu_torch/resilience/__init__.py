"""Preemption-safe, self-healing training (port of the JAX package's
``resilience/``):

- :mod:`.sentinel` — divergence detection + bounded
  rollback-to-last-good-checkpoint policy;
- :mod:`.preemption` — SIGTERM/SIGINT -> emergency save -> distinct
  requeue exit code;
- :mod:`.retry` — bounded retry-with-backoff for flaky checkpoint IO;
- :mod:`.faultinject` — the harness that injects NaN batches, signals
  and checkpoint IO faults into a real Trainer.
"""

from torch_actor_critic_tpu_torch.resilience.preemption import (
    REQUEUE_EXIT_CODE,
    Preempted,
    PreemptionGuard,
)
from torch_actor_critic_tpu_torch.resilience.retry import call_with_retries
from torch_actor_critic_tpu_torch.resilience.sentinel import (
    DivergenceSentinel,
    TrainingDiverged,
    tree_all_finite,
)

__all__ = [
    "REQUEUE_EXIT_CODE",
    "Preempted",
    "PreemptionGuard",
    "DivergenceSentinel",
    "TrainingDiverged",
    "tree_all_finite",
    "call_with_retries",
]
