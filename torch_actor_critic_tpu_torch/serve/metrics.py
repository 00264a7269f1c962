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

Port note: copied from the JAX package without its cost roofline
(``cost_snapshot``, which reads XLA cost analyses). The per-bucket
forward times ``record_batch`` takes are kept (``bucket_times``) for
it. :func:`aggregate_snapshots` folds the JAX package's
``obs/merge.aggregate_snapshots`` (with the serving key set) into this
module.
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
    ``latency_merge_error``, never raised."""
    label_keys = _SUM_KEYS + (
        "requests_per_sec", "shed_by_reason", "uptime_s",
        "p50_ms", "p99_ms", "queue_capacity", "draining",
    )
    out: t.Dict[str, t.Any] = {k: 0 for k in _SUM_KEYS}
    out["shed_by_reason"] = {}
    out["requests_per_sec"] = 0.0
    per_worker: t.Dict[str, t.Any] = {}
    merged = FixedBucketHistogram()
    merge_error = None
    for name, snap in workers.items():
        if snap is None:
            per_worker[name] = {"unreachable": True}
            continue
        per_worker[name] = {k: snap.get(k) for k in label_keys if k in snap}
        for k in _SUM_KEYS:
            v = snap.get(k)
            if isinstance(v, (int, float)):
                out[k] = out.get(k, 0) + int(v)
        for reason, n in (snap.get("shed_by_reason") or {}).items():
            out["shed_by_reason"][reason] = out["shed_by_reason"].get(reason, 0) + int(n)
        rv = snap.get("requests_per_sec")
        if isinstance(rv, (int, float)):
            out["requests_per_sec"] = round(out["requests_per_sec"] + float(rv), 2)
        hist = snap.get("latency_hist")
        if hist is not None:
            try:
                merged.merge_raw(hist)
            except (ValueError, KeyError, TypeError) as e:
                merge_error = repr(e)[:200]
    if merged.count:
        p50, p95, p99 = merged.percentiles((50, 95, 99))
        out.update(
            mean_ms=round(merged.mean, 3), p50_ms=round(p50, 3),
            p95_ms=round(p95, 3), p99_ms=round(p99, 3),
            max_ms=round(merged.max, 3),
        )
    out["latency_hist"] = merged.raw_counts()
    if merge_error is not None:
        out["latency_merge_error"] = merge_error
    out["workers"] = per_worker
    out["workers_reporting"] = sum(
        1 for v in per_worker.values() if not v.get("unreachable")
    )
    return out
