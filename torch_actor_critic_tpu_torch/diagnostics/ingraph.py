"""Burst-metric reduction by key suffix (port of the reduction half of
``diagnostics/ingraph.py``).

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
