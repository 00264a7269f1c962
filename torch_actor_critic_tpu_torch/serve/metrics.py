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
(``cost_snapshot``, which reads XLA cost analyses) and without the
fleet aggregate (``aggregate_snapshots``); both wait for later slices.
"""

from __future__ import annotations

import threading
import time
import typing as t

from torch_actor_critic_tpu_torch.telemetry.histogram import FixedBucketHistogram

__all__ = ["ServeMetrics"]


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

    def record_batch(self, rows: int, bucket: int):
        with self._lock:
            self.batches_total += 1
            self.rows_total += rows
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

