"""Serving metrics: queue depth, batch occupancy, rate, latency tails.

A single lock-guarded accumulator shared by the batcher and the HTTP
frontend. Latencies feed a **fixed-bucket** log-spaced histogram
(:class:`~torch_actor_critic_tpu_torch.telemetry.histogram.FixedBucketHistogram`
— the same estimator the training telemetry snapshot uses, so both
planes report percentiles through one schema, docs/OBSERVABILITY.md):
constant memory at any request volume, Prometheus-style cumulative
semantics (percentiles are over the process lifetime, never reset).
Total counters never reset either; :meth:`snapshot` derives
requests/sec over the window between snapshots (falling back to the
lifetime rate on the first call).

Port note: copied from the JAX package. :meth:`ServeMetrics.cost_snapshot`
is the per-bucket roofline of ``/metrics`` ``costs``: each bucket's
forward cost, counted once at the engine's warm-up
(``serve/forward[bN]`` in the cost registry), over the forward times
``record_batch`` keeps, against the card's peaks at the served
precision's compute dtype. :func:`aggregate_snapshots` delegates to
:func:`~torch_actor_critic_tpu_torch.obs.merge.aggregate_snapshots`
with the serving key set, as the JAX package's does.
"""

from __future__ import annotations

import threading
import time
import typing as t

from torch_actor_critic_tpu_torch.telemetry.histogram import FixedBucketHistogram

__all__ = ["ServeMetrics", "aggregate_snapshots"]

# Monotonic counters a fleet aggregate sums over its CURRENT workers:
# a worker that restarted resets its own counters, so the fleet total
# reflects the live processes and never double-counts a dead one.
_SUM_KEYS = (
    "requests_total", "responses_total", "errors_total", "batches_total",
    "queue_depth", "sheds_total", "shed_expired_total",
    "compiles_total", "live_compiles",
    "reload_transfer_bytes_total", "param_placements_total",
)


class ServeMetrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._t_start = time.perf_counter()
        self._t_snapshot = self._t_start  # guarded-by: _lock
        self.requests_total = 0  # guarded-by: _lock
        self.responses_total = 0  # guarded-by: _lock
        self.errors_total = 0  # guarded-by: _lock
        self.batches_total = 0  # guarded-by: _lock
        self.rows_total = 0  # guarded-by: _lock
        self.padded_rows_total = 0  # bucket sizes sum; guarded-by: _lock
        self.queue_depth = 0  # guarded-by: _lock
        # Admission-control accounting (docs/SERVING.md "Overload &
        # degradation"): submit-time rejections by reason, plus
        # accepted-then-purged requests whose deadline expired in the
        # queue (the device never ran them).
        self.sheds_total = 0  # guarded-by: _lock
        self.shed_by_reason: t.Dict[str, int] = {}  # guarded-by: _lock
        self.shed_expired_total = 0  # guarded-by: _lock
        self._responses_at_snapshot = 0  # guarded-by: _lock
        self._snapshots_taken = 0  # guarded-by: _lock
        self._latency = FixedBucketHistogram()  # guarded-by: _lock
        # Per-bucket measured forward time (the engine calls'
        # durations the dispatcher reports; also the seconds-per-row
        # EMA the fleet scores replicas with).
        self._bucket_time: t.Dict[int, t.Dict[str, float]] = {}  # guarded-by: _lock
        # Params-placement accounting (sub-mesh serving,
        # docs/SERVING.md "Sharded serving & precision tiers"): bytes
        # actually moved by generation-/precision-keyed device_puts —
        # the counter the one-transfer-per-device hot-reload contract
        # is asserted against.
        self.reload_transfer_bytes_total = 0  # guarded-by: _lock
        self.param_placements_total = 0  # guarded-by: _lock
        # The roofline's peaks (costmodel.Peaks, read once) at the
        # served forward's compute dtype (the server sets it from its
        # precision tier).
        self._peaks = None  # guarded-by: _lock
        self.compute_dtype = "float32"

    # ----------------------------------------------------------- recording

    def record_enqueue(self, depth: int):
        with self._lock:
            self.requests_total += 1
            self.queue_depth = depth

    def record_batch(self, rows: int, bucket: int, dur_s: float = 0.0):
        with self._lock:
            self.batches_total += 1
            self.rows_total += rows
            if dur_s > 0.0:
                agg = self._bucket_time.setdefault(
                    bucket, {"calls": 0, "rows": 0, "total_s": 0.0}
                )
                agg["calls"] += 1
                agg["rows"] += rows
                agg["total_s"] += dur_s
            self.padded_rows_total += bucket

    def record_done(self, latency_ms: float):
        with self._lock:
            self.responses_total += 1
            self._latency.record(latency_ms)

    def record_error(self):
        with self._lock:
            self.errors_total += 1

    def record_shed(self, reason: str):
        """One request rejected by admission control (submit time) or
        failed fast by the circuit breaker (dispatch time)."""
        with self._lock:
            self.sheds_total += 1
            self.shed_by_reason[reason] = (
                self.shed_by_reason.get(reason, 0) + 1
            )

    def record_transfer(self, nbytes: int):
        """One params placement (a replica's generation- or
        precision-keyed ``device_put``) of ``nbytes`` actual bytes."""
        with self._lock:
            self.reload_transfer_bytes_total += int(nbytes)
            self.param_placements_total += 1

    def record_expired(self, n: int = 1):
        """Accepted requests purged at group-collection time because
        their deadline passed while queued — never dispatched."""
        with self._lock:
            self.shed_expired_total += n
            self.sheds_total += n
            self.shed_by_reason["expired"] = (
                self.shed_by_reason.get("expired", 0) + n
            )

    # ------------------------------------------------------------ snapshot

    def cost_snapshot(self) -> t.Dict[str, t.Any]:
        """Per-bucket live roofline for ``/metrics`` ``costs``: each
        bucket's registered forward cost (``serve/forward[bN]``, counted
        at engine warm-up) against its measured cumulative forward
        time — achieved FLOP/s, arithmetic intensity, MFU and the
        compute-/memory-bound class when the card's peaks are known.
        Buckets with no registered cost or no traffic are omitted."""
        from torch_actor_critic_tpu_torch.telemetry.costmodel import (
            Peaks,
            get_cost_registry,
            roofline,
        )

        with self._lock:
            buckets = {b: dict(agg) for b, agg in self._bucket_time.items()}
            if self._peaks is None:
                self._peaks = Peaks.detect(self.compute_dtype)
            peaks = self._peaks
        registry = get_cost_registry()
        out: t.Dict[str, t.Any] = {}
        for b, agg in sorted(buckets.items()):
            cost = registry.get(f"serve/forward[b{b}]")
            if cost is None or agg["total_s"] <= 0.0:
                continue
            entry = roofline(cost, agg["total_s"], calls=int(agg["calls"]), peaks=peaks,
                             compute_dtype=self.compute_dtype)
            entry["rows"] = int(agg["rows"])
            out[f"b{b}"] = entry
        return out

    def snapshot(self) -> t.Dict[str, t.Any]:
        """Point-in-time metrics dict (the ``/metrics`` payload and the
        bench JSON's ``serving`` keys)."""
        with self._lock:
            now = time.perf_counter()
            window_s = now - self._t_snapshot
            window_responses = self.responses_total - self._responses_at_snapshot
            lifetime_s = now - self._t_start
            first_snapshot = self._snapshots_taken == 0
            self._snapshots_taken += 1
            self._t_snapshot = now
            self._responses_at_snapshot = self.responses_total
            out = {
                "requests_total": self.requests_total,
                "responses_total": self.responses_total,
                "errors_total": self.errors_total,
                "batches_total": self.batches_total,
                "queue_depth": self.queue_depth,
                "sheds_total": self.sheds_total,
                "shed_by_reason": dict(self.shed_by_reason),
                "shed_expired_total": self.shed_expired_total,
                "reload_transfer_bytes_total": (
                    self.reload_transfer_bytes_total
                ),
                "param_placements_total": self.param_placements_total,
                "uptime_s": round(lifetime_s, 3),
                # Occupancy: real rows per dispatched row slot — 1.0
                # means every forward ran a full bucket, low values mean
                # deadline flushes of tiny batches (tune max_wait_ms).
                "mean_batch_occupancy": (
                    round(self.rows_total / self.padded_rows_total, 4)
                    if self.padded_rows_total else None
                ),
                "mean_rows_per_batch": (
                    round(self.rows_total / self.batches_total, 2)
                    if self.batches_total else None
                ),
                # Rate over the window since the previous snapshot. The
                # lifetime fallback applies ONLY to the very first
                # snapshot (no window exists yet); afterwards an idle
                # window honestly reports 0.0 instead of echoing a
                # stale lifetime rate.
                "requests_per_sec": round(
                    (self.responses_total / lifetime_s
                     if lifetime_s > 1e-9 else 0.0)
                    if first_snapshot
                    else (window_responses / window_s
                          if window_s > 1e-9 else 0.0),
                    2,
                ),
            }
            # Latency tails AND the mean from the same fixed-bucket
            # histogram: p50/p95/p99 interpolated (error bounded by the
            # ~19% bucket width), mean/max exact side counters.
            if self._latency.count:
                p50, p95, p99 = self._latency.percentiles((50, 95, 99))
                out.update(
                    mean_ms=round(self._latency.mean, 3),
                    p50_ms=round(p50, 3),
                    p95_ms=round(p95, 3),
                    p99_ms=round(p99, 3),
                    max_ms=round(self._latency.max, 3),
                )
            # The mergeable histogram state (counts vector + spec):
            # a fleet router folds every worker's export into ONE
            # histogram, so fleet percentiles come from the same
            # estimator — never from averaging per-worker percentiles,
            # which is statistically meaningless.
            out["latency_hist"] = self._latency.raw_counts()
        return out

    def bucket_times(self) -> t.Dict[str, t.Dict[str, float]]:
        """Per-bucket engine calls, rows and cumulative seconds."""
        with self._lock:
            return {f"b{b}": dict(agg) for b, agg in sorted(self._bucket_time.items())}


def aggregate_snapshots(
    workers: t.Mapping[str, t.Optional[t.Mapping[str, t.Any]]],
) -> t.Dict[str, t.Any]:
    """Fold per-worker ``/metrics`` snapshots into one fleet view.

    Counters are summed over the CURRENT snapshots and every input is
    kept, per-worker-labelled, under ``workers`` — a worker that
    restarted resets its own counters, so the totals can never
    double-count a dead incarnation. ``requests_per_sec`` is the sum of
    the workers' window rates (rates of disjoint streams add). Latency
    percentiles come from merging every worker's raw bucket counts into
    one :class:`FixedBucketHistogram` — the histogram one process would
    have built from all the samples. A worker whose snapshot failed
    (``None``) appears as ``{"unreachable": true}`` and contributes
    nothing; a histogram that fails to merge is recorded as
    ``latency_merge_error``, never raised.

    A thin delegate over the plane-generic
    :func:`torch_actor_critic_tpu_torch.obs.merge.aggregate_snapshots`
    that pins the serving key set."""
    from torch_actor_critic_tpu_torch.obs.merge import (
        aggregate_snapshots as merge_snapshots,
    )

    return merge_snapshots(
        workers,
        sum_keys=_SUM_KEYS,
        rate_keys=("requests_per_sec",),
        merge_dict_keys=("shed_by_reason",),
        hist_key="latency_hist",
        label_keys=_SUM_KEYS + (
            "requests_per_sec", "shed_by_reason", "uptime_s",
            "p50_ms", "p99_ms", "queue_capacity", "draining",
        ),
        sources_key="workers",
        reporting_key="workers_reporting",
    )
