"""Fixed-bucket latency histogram: percentiles without unbounded lists.

Geometric (log-spaced) bucket bounds give a constant *relative* error
per estimate — the right trade for latencies, where 1.05ms vs 1.25ms is
noise but 10ms vs 50ms is the story. Memory is a fixed ``O(n_buckets)``
int array regardless of how many samples are recorded, so a serving
process that handles a billion requests holds exactly the same
footprint as one that handled ten.

Shared by :class:`~torch_actor_critic_tpu_torch.serve.metrics.ServeMetrics`
(request latencies) and the training-side
:class:`~torch_actor_critic_tpu.telemetry.recorder.TelemetryRecorder`
snapshot schema, so both planes report percentiles from the same
estimator (docs/OBSERVABILITY.md "unified schema").

Not internally locked: callers that share an instance across threads
guard it with their own lock (``ServeMetrics`` already holds one around
every recording path).
"""

from __future__ import annotations

import math
import typing as t

__all__ = ["FixedBucketHistogram", "geometric_bucket_count"]


def geometric_bucket_count(lo: float, hi: float, growth: float) -> int:
    """Number of geometric (interior) buckets covering ``[lo, hi)`` at
    ratio ``growth`` — shared with the in-graph TD-error histogram
    (:mod:`torch_actor_critic_tpu.diagnostics.ingraph`) so the device
    counts vector and the host merge target always agree on length."""
    return int(math.ceil((math.log(hi) - math.log(lo)) / math.log(growth)))


class FixedBucketHistogram:
    """Bounded-memory histogram over ``(0, +inf)`` values.

    Bucket ``i`` covers ``[lo * growth**i, lo * growth**(i+1))``; one
    underflow bucket catches values below ``lo`` and one overflow
    bucket values past the top bound. ``growth=2**0.25`` (~19% bucket
    width) bounds percentile error to under one bucket width while
    keeping the default 0.01ms..120s span under ~100 counters.
    """

    def __init__(
        self,
        lo: float = 0.01,
        hi: float = 120_000.0,
        growth: float = 2 ** 0.25,
    ):
        if not (lo > 0 and hi > lo and growth > 1):
            raise ValueError(
                f"need 0 < lo < hi and growth > 1, got lo={lo} hi={hi} "
                f"growth={growth}"
            )
        self._lo = float(lo)
        self._log_lo = math.log(lo)
        self._log_growth = math.log(growth)
        n = geometric_bucket_count(lo, hi, growth)
        # index 0 = underflow (< lo), 1..n = geometric, n+1 = overflow.
        self._counts = [0] * (n + 2)
        self._n = n
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = 0.0

    @property
    def n_buckets(self) -> int:
        """Geometric (interior) bucket count; the full counts vector is
        ``n_buckets + 2`` (underflow + overflow)."""
        return self._n

    # ------------------------------------------------------------ recording

    def merge_counts(
        self,
        counts: t.Sequence[int],
        total: float = 0.0,
        vmin: float = math.inf,
        vmax: float = 0.0,
    ) -> None:
        """Fold a pre-bucketed counts vector into this histogram — the
        host-side half of the in-graph TD-error histogram
        (docs/OBSERVABILITY.md "Learning-health diagnostics"): the
        device reduces samples to a ``n_buckets + 2`` int vector under
        the SAME bucket spec (lo/growth/n), and this merge keeps the
        one-estimator-one-schema contract without ever materializing
        the raw samples host-side. ``total``/``vmin``/``vmax`` carry the
        exact side statistics the device reduced alongside the counts
        (defaults leave them untouched for count-only merges)."""
        if len(counts) != len(self._counts):
            raise ValueError(
                f"counts vector of length {len(counts)} does not match "
                f"this histogram's {len(self._counts)} buckets — merge "
                "requires an identical (lo, hi, growth) bucket spec"
            )
        merged = 0
        for i, c in enumerate(counts):
            c = int(c)
            self._counts[i] += c
            merged += c
        self.count += merged
        self.total += float(total)
        if merged:
            if vmin < self.min:
                self.min = float(vmin)
            if vmax > self.max:
                self.max = float(vmax)

    def record(self, value: float) -> None:
        v = float(value)
        if v < 0.0 or v != v:  # negative or NaN: clock skew, not data
            return
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v < self._lo:
            self._counts[0] += 1
            return
        i = int((math.log(v) - self._log_lo) / self._log_growth) + 1
        if i > self._n:
            i = self._n + 1
        self._counts[i] += 1

    # ----------------------------------------------------------- estimation

    def _bound(self, i: int) -> float:
        """Lower bound of geometric bucket index ``i`` (1-based)."""
        return math.exp(self._log_lo + (i - 1) * self._log_growth)

    def percentile(self, q: float) -> float | None:
        """Estimated ``q``-th percentile (``0 <= q <= 100``), or None on
        an empty histogram. Interpolates linearly inside the bucket;
        the underflow/overflow buckets clamp to the exact min/max."""
        if self.count == 0:
            return None
        rank = q / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            if seen + c >= rank:
                if i == 0:
                    return self.min
                if i == self._n + 1:
                    return self.max
                lo, hi = self._bound(i), self._bound(i + 1)
                frac = (rank - seen) / c
                # Clamp to the observed extremes: a lone sample in a
                # bucket is better reported as itself than as the
                # bucket's geometric interior.
                return min(max(lo + frac * (hi - lo), self.min), self.max)
            seen += c
        return self.max

    def percentiles(self, qs: t.Sequence[float]) -> t.List[float | None]:
        return [self.percentile(q) for q in qs]

    @property
    def mean(self) -> float | None:
        return self.total / self.count if self.count else None

    # ------------------------------------------------------------- export

    def snapshot(
        self, prefix: str = "", round_to: int = 3, unit: str = "ms"
    ) -> dict:
        """``/metrics``-style keys: count/mean/p50/p95/p99/max (+prefix).
        Percentile keys are present only when samples exist. ``unit``
        names the value suffix (``"ms"`` for latencies; pass ``""`` for
        unitless quantities like TD-error magnitudes)."""
        sfx = f"_{unit}" if unit else ""
        out: dict = {f"{prefix}count": self.count}
        if self.count:
            p50, p95, p99 = self.percentiles((50, 95, 99))
            out.update({
                f"{prefix}mean{sfx}": round(self.mean, round_to),
                f"{prefix}p50{sfx}": round(p50, round_to),
                f"{prefix}p95{sfx}": round(p95, round_to),
                f"{prefix}p99{sfx}": round(p99, round_to),
                f"{prefix}max{sfx}": round(self.max, round_to),
            })
        return out

    def spec(self) -> dict:
        """The bucket spec two histograms must share to merge:
        ``{lo, growth, n_buckets}`` (``hi`` is derived). Serialized
        alongside :meth:`raw_counts` in cross-process exports so the
        merging side can verify compatibility instead of silently
        folding counts into the wrong bounds."""
        return {
            "lo": self._lo,
            "growth": round(math.exp(self._log_growth), 12),
            "n_buckets": self._n,
        }

    def raw_counts(self) -> dict:
        """The full mergeable state as JSON-ready scalars: the counts
        vector (underflow + geometric + overflow) plus the exact side
        statistics and the bucket :meth:`spec`. A fleet router folds N
        workers' exports into one histogram via :meth:`merge_counts`
        (docs/SERVING.md "Fleet"), giving fleet-level percentiles from
        the same estimator each worker reports — impossible to
        reconstruct from the workers' individual percentiles."""
        return {
            "counts": list(self._counts),
            "total": self.total,
            "min": self.min if self.count else None,
            "max": self.max,
            "spec": self.spec(),
        }

    def merge_raw(self, raw: t.Mapping[str, t.Any]) -> None:
        """Fold one :meth:`raw_counts` export into this histogram,
        validating the bucket spec first."""
        spec = raw.get("spec") or {}
        mine = self.spec()
        if (
            spec.get("n_buckets") != mine["n_buckets"]
            or abs(spec.get("lo", -1.0) - mine["lo"]) > 1e-12
            or abs(spec.get("growth", -1.0) - mine["growth"]) > 1e-9
        ):
            raise ValueError(
                f"histogram spec mismatch: cannot merge {spec} into "
                f"{mine}"
            )
        vmin = raw.get("min")
        self.merge_counts(
            raw["counts"],
            total=float(raw.get("total", 0.0)),
            vmin=math.inf if vmin is None else float(vmin),
            vmax=float(raw.get("max", 0.0)),
        )

    def buckets(self) -> t.List[t.Tuple[float, int]]:
        """Non-empty ``(upper_bound, count)`` pairs, for export/debug.
        The overflow bucket reports ``inf`` as its bound."""
        out = []
        for i, c in enumerate(self._counts):
            if not c:
                continue
            bound = (
                self._lo if i == 0
                else math.inf if i == self._n + 1
                else self._bound(i + 1)
            )
            out.append((bound, c))
        return out
