"""Burst-metric reduction by key suffix (port of the reduction half of
``diagnostics/ingraph.py``), and a population's per-member metric
layout (:func:`split_member_metrics`).

A metric's reduction over the updates of a burst lives in its name:

==========  =============================
suffix       reduction over the burst axis
==========  =============================
``_max``     ``max``
``_min``     ``min``
``_sum``     ``sum``
``_hist``    ``sum`` (bucket axis kept)
(default)    ``mean``
==========  =============================

The in-graph diagnostics themselves (gradient norms, TD histogram) are
not ported; ``diagnostics != "off"`` raises in the learner.
"""

from __future__ import annotations

import math
import typing as t

import torch


def reduction_for(key: str) -> str:
    """Reduction kind (``mean``/``max``/``min``/``sum``) for a metric
    key, per the suffix convention above."""
    if key.endswith("_max"):
        return "max"
    if key.endswith("_min"):
        return "min"
    if key.endswith("_sum") or key.endswith("_hist"):
        return "sum"
    return "mean"


def reduce_burst_metrics(metrics: t.Dict[str, torch.Tensor]) -> t.Dict[str, torch.Tensor]:
    """Reduce stacked burst metrics (leading axis = update step) by key
    suffix, on the device (no host sync)."""
    out = {}
    for k, v in metrics.items():
        r = reduction_for(k)
        if r == "sum":
            out[k] = v.sum(dim=0)
        elif r == "max":
            out[k] = v.amax(dim=0)
        elif r == "min":
            out[k] = v.amin(dim=0)
        else:
            out[k] = v.mean(dim=0)
    return out


def split_member_metrics(metrics: t.Mapping[str, t.Any]) -> dict:
    """A population epoch's metrics in the JAX package's per-member
    layout (host side): each ``(P,)`` value becomes ``{key}_m{i}``
    floats (a trailing axis averaged), plus a population aggregate under
    ``key``, reduced per the suffix convention over the FINITE members
    only (a member with no finished episode reports a NaN ``reward``);
    NaN when none is finite. Scalars pass through as floats; ``_hist``
    keys sum their member axis and keep the bucket axis."""
    out: dict = {}
    for k, v in metrics.items():
        arr = torch.as_tensor(v, dtype=torch.float64).cpu()
        if arr.dim() == 0:
            out[k] = float(arr)
            continue
        if k.endswith("_hist"):
            out[k] = arr.reshape(-1, arr.shape[-1]).sum(dim=0).tolist()
            continue
        for i, x in enumerate(arr.reshape(arr.shape[0], -1).mean(dim=1).tolist()):
            out[f"{k}_m{i}"] = x
        finite = arr[torch.isfinite(arr)]
        if finite.numel() == 0:
            out[k] = math.nan
            continue
        r = reduction_for(k)
        out[k] = float(finite.sum() if r == "sum" else finite.max() if r == "max"
                       else finite.min() if r == "min" else finite.mean())
    return out
