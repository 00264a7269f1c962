"""Run-wide observability plane (a copy of the JAX package's ``obs/``,
which imports no JAX; only its imports name the port's modules).

Everything before this package observes ONE process: a `/metrics`
endpoint per serve worker, one ``telemetry.jsonl`` per learner, one
Perfetto export per process. A fleet run is a learner + N actor
subprocesses + a router + M serve workers — and "why is the learner
starved" needs all of them on one screen. Three pillars:

- :mod:`~torch_actor_critic_tpu_torch.obs.merge` — the fleet aggregation
  semantics (counter-sum over CURRENT snapshots, bucket-wise histogram
  merge, restart no-double-count) lifted out of ``serve/metrics`` so
  they apply to every plane, not just serving.
- :mod:`~torch_actor_critic_tpu_torch.obs.collector` — a run-scoped scraper
  thread folding every process's ``/metrics`` (+ in-process callables)
  into one time series: ``obs.jsonl``, an aggregated ``/metrics``
  endpoint, and ``obs/`` columns in metrics.jsonl. A dead target is a
  counted ``scrape_failed``, never a crash or a silent gap.
- :mod:`~torch_actor_critic_tpu_torch.obs.slo` — declarative SLO rules over
  the aggregated series, evaluated per scrape window with hysteresis,
  emitting ``slo_breach``/``slo_recovered`` events — the interface the
  elastic controller (:mod:`~torch_actor_critic_tpu_torch.elastic`)
  subscribes to.

Plus :mod:`~torch_actor_critic_tpu_torch.obs.tracecollect`, which merges
per-process trace buffers (learner, actors, staging transport) into
the one Perfetto timeline ``--trace-export`` writes.
"""

from torch_actor_critic_tpu_torch.obs.collector import ObsCollector, http_source
from torch_actor_critic_tpu_torch.obs.merge import aggregate_snapshots
from torch_actor_critic_tpu_torch.obs.slo import (
    SLOEngine,
    SLORule,
    default_rules,
    load_rules,
)
from torch_actor_critic_tpu_torch.obs.tracecollect import actor_span_events

__all__ = [
    "ObsCollector",
    "SLOEngine",
    "SLORule",
    "actor_span_events",
    "aggregate_snapshots",
    "default_rules",
    "http_source",
    "load_rules",
]
