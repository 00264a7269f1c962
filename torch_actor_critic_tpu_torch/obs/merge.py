"""Plane-generic snapshot aggregation.

The fleet-fold semantics built for serving — lifted here so every
plane merges the same way (a copy of the JAX package's
``obs/merge.py``):

- **Counters sum over the CURRENT snapshots**, never over deltas: a
  restarted source resets its own counters, so the aggregate reflects
  exactly what the live processes report and can never double-count a
  dead incarnation.
- **Latency histograms merge bucket-wise**
  (:meth:`FixedBucketHistogram.merge_raw`) and percentiles come from
  the merged estimator — identical to the histogram one process would
  have built from all the samples. Percentiles are never averaged
  (statistically meaningless). A spec-mismatched histogram becomes a
  recorded ``latency_merge_error``, never a raise.
- **Rates of disjoint streams add** (``requests_per_sec``).
- **A dead source stays in the output** as ``{"unreachable": true}``
  and contributes nothing to the totals — partial failure is visible,
  not silent.

``serve/metrics.aggregate_snapshots`` is now a thin delegate passing
the serving key set (its output equals the JAX package's on the
same snapshots); the ObsCollector calls the dynamic mode
(``sum_keys=None``) over flattened cross-plane snapshots.
"""

from __future__ import annotations

import typing as t

from torch_actor_critic_tpu_torch.telemetry.histogram import FixedBucketHistogram

__all__ = ["aggregate_snapshots", "flatten_numeric"]


def flatten_numeric(
    snap: t.Mapping[str, t.Any], sep: str = "/", max_depth: int = 3
) -> t.Dict[str, t.Any]:
    """Flatten a nested snapshot to one level of ``a/b/c`` keys,
    keeping numeric leaves plus any top-level ``latency_hist`` (the
    mergeable histogram state rides through un-flattened so
    :func:`aggregate_snapshots` can fold it)."""
    out: t.Dict[str, t.Any] = {}

    def walk(node: t.Mapping[str, t.Any], prefix: str, depth: int):
        for k, v in node.items():
            key = f"{prefix}{sep}{k}" if prefix else str(k)
            if isinstance(v, dict):
                if k == "latency_hist":
                    if not prefix:
                        out[key] = v
                elif depth < max_depth:
                    walk(v, key, depth + 1)
            elif isinstance(v, bool):
                out[key] = int(v)
            elif isinstance(v, (int, float)):
                out[key] = v

    walk(snap, "", 1)
    return out


def _dynamic_sum_key(key: str) -> bool:
    """Counter-shaped keys in dynamic (``sum_keys=None``) mode: the
    monotonic ``*_total`` family plus the gauge-style depth/compile
    keys every plane shares. Classified on the LEAF name so flattened
    paths (``staging/staged_total``) match like flat ones."""
    leaf = key.rsplit("/", 1)[-1]
    return leaf.endswith("_total") or leaf in (
        "queue_depth", "depth", "live_compiles",
    )


def aggregate_snapshots(
    sources: t.Mapping[str, t.Optional[t.Mapping[str, t.Any]]],
    *,
    sum_keys: t.Optional[t.Tuple[str, ...]] = None,
    rate_keys: t.Tuple[str, ...] = ("requests_per_sec",),
    merge_dict_keys: t.Tuple[str, ...] = (),
    hist_key: str = "latency_hist",
    label_keys: t.Optional[t.Tuple[str, ...]] = None,
    sources_key: str = "sources",
    reporting_key: str = "sources_reporting",
) -> t.Dict[str, t.Any]:
    """Fold per-source snapshots into one aggregate view.

    ``sum_keys`` names the counters to sum (each initialized to 0 even
    when absent everywhere — the serving contract); ``None`` sums every
    counter-shaped numeric key discovered in the live snapshots
    (``*_total`` / depth / ``live_compiles``), the cross-plane mode.
    ``rate_keys`` add (rates of disjoint streams), rounded to 2 as the
    fleet aggregate always did; ``merge_dict_keys`` name str->count
    dicts merged by key (``shed_by_reason``). ``label_keys`` selects
    the per-source labelled subset kept under ``sources_key`` (``None``
    keeps each full snapshot). A ``None`` snapshot is an unreachable
    source: labelled, counted out of ``reporting_key``, contributing
    nothing. This function never raises on malformed input — a
    histogram that fails to merge is a recorded
    ``latency_merge_error``."""
    dynamic = sum_keys is None
    out: t.Dict[str, t.Any] = {} if dynamic else {k: 0 for k in sum_keys}
    for k in merge_dict_keys:
        out[k] = {}
    for k in rate_keys:
        out[k] = 0.0
    skip = set(rate_keys) | set(merge_dict_keys) | {hist_key}
    per_source: t.Dict[str, t.Any] = {}
    merged = FixedBucketHistogram()
    merge_error = None
    for name, snap in sources.items():
        if snap is None:
            per_source[name] = {"unreachable": True}
            continue
        per_source[name] = (
            dict(snap) if label_keys is None
            else {k: snap.get(k) for k in label_keys if k in snap}
        )
        keys: t.Iterable[str] = (
            [k for k in snap if k not in skip and _dynamic_sum_key(k)]
            if dynamic else sum_keys
        )
        for k in keys:
            v = snap.get(k)
            if isinstance(v, (int, float)):
                out[k] = out.get(k, 0) + int(v)
        for dk in merge_dict_keys:
            for reason, n in (snap.get(dk) or {}).items():
                out[dk][reason] = out[dk].get(reason, 0) + int(n)
        for rk in rate_keys:
            rv = snap.get(rk)
            if isinstance(rv, (int, float)):
                out[rk] = round(out[rk] + float(rv), 2)
        hist = snap.get(hist_key)
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
    out[hist_key] = merged.raw_counts()
    if merge_error is not None:
        out["latency_merge_error"] = merge_error
    out[sources_key] = per_source
    out[reporting_key] = sum(
        1 for v in per_source.values() if not v.get("unreachable")
    )
    return out
