"""Observability for training and serving (port of ``telemetry/``).

- :mod:`recorder` — phase timers over a preallocated span ring,
  aggregated per epoch; no host-device synchronization and no per-step
  allocation when on; the trainer holds ``telemetry=None`` when off.
- :mod:`histogram` — the fixed-bucket histogram shared by serving's
  latencies and training's |TD| errors.
- :mod:`memory` — per-epoch device memory watermarks from the caching
  allocator (``None`` on the CPU).
- :mod:`profiler` — ``torch.profiler``: the ``--profile-epochs A:B``
  window, with the lead-in, tail and buffer a trace on the card needs.
- :mod:`sinks` — the JSONL event stream and the summary table.
- :mod:`costmodel` — counted FLOPs and bytes per program (K1–K4 by
  formula), roofline and MFU against the card's peaks, host/device/input
  epoch attribution.
- :mod:`traceview` — the Perfetto export of training phase spans,
  serving request spans and the watchdog's events on one timeline.
"""

from torch_actor_critic_tpu_torch.telemetry.costmodel import (
    CostCount,
    CostRegistry,
    Peaks,
    classify_epoch,
    get_cost_registry,
    roofline,
)
from torch_actor_critic_tpu_torch.telemetry.histogram import FixedBucketHistogram
from torch_actor_critic_tpu_torch.telemetry.memory import device_memory_watermarks
from torch_actor_critic_tpu_torch.telemetry.profiler import (
    ProfilerWindow,
    parse_profile_epochs,
)
from torch_actor_critic_tpu_torch.telemetry.recorder import (
    PHASES,
    PhaseTimer,
    SpanRing,
    TelemetryRecorder,
)
from torch_actor_critic_tpu_torch.telemetry.sinks import (
    JsonlSink,
    format_summary,
    json_sanitize,
)
from torch_actor_critic_tpu_torch.telemetry.traceview import (
    RequestSpanLog,
    export_trace,
)

__all__ = [
    "PHASES",
    "CostCount",
    "CostRegistry",
    "FixedBucketHistogram",
    "JsonlSink",
    "Peaks",
    "PhaseTimer",
    "ProfilerWindow",
    "RequestSpanLog",
    "SpanRing",
    "TelemetryRecorder",
    "classify_epoch",
    "device_memory_watermarks",
    "export_trace",
    "format_summary",
    "get_cost_registry",
    "json_sanitize",
    "parse_profile_epochs",
    "roofline",
]
