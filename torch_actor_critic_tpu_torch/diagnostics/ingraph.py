"""In-graph learning-health reductions (port of
``diagnostics/ingraph.py``), the burst-metric reduction by key suffix,
a population's per-member metric layout (:func:`split_member_metrics`)
and the primitives' per-member forms (``member_*``: member-stacked
tensors, member axis first, one value per member).

Everything but the host-side helpers runs inside the update a burst's
CUDA graph captures: a gradient global norm or a TD-error histogram is a
few reductions over tensors the update already has, written into the
burst's metric rows; the host reads them once, at the epoch's end, with
the losses. Nothing here synchronizes: :func:`bucket_counts` scatters
into a fixed-size tensor where ``torch.bincount`` would read its
output's size back to the host.

A metric's reduction over the updates of a burst, and over the bursts
of an epoch (:func:`reduce_metric_rows`), lives in its name:

==========  =============================
suffix       reduction
==========  =============================
``_max``     ``max``
``_min``     ``min``
``_sum``     ``sum``
``_hist``    ``sum`` (bucket axis kept)
(default)    ``mean``
==========  =============================

None of the base metric keys (``loss_q``, ``q_mean``, ...) match a
special suffix, so ``diagnostics="off"`` reduces exactly as before.
The TD-error histogram buckets |TD| with the geometric bucket spec of
:class:`~..telemetry.histogram.FixedBucketHistogram`, so the host
merges the device counts straight into it
(:meth:`~..telemetry.histogram.FixedBucketHistogram.merge_counts`).
``cross_replica_reduce``/``replica_skew`` wait for data parallelism
(ROADMAP queue 1 item 6).

A population's update (``sac/population.py``) reduces each member on
its own, as the JAX package's ``vmap`` of the solo update does: every
``diag/*`` value of a member-stacked update is ``(P,)``, and the epoch's
:func:`reduce_metric_rows` reduces over the bursts and the members
alike. Its |TD| histogram is one count vector for all members (the
host sums the member axis anyway): :func:`bucket_counts` over the
member-stacked errors, whose counts are exactly the sum of the
members' own.
"""

from __future__ import annotations

import math
import typing as t

import numpy as np
import torch

from torch_actor_critic_tpu_torch.telemetry.histogram import (
    FixedBucketHistogram,
    geometric_bucket_count,
)

# TD-error magnitude bucket spec (the JAX package's): |TD| from 1e-3 to
# 1e4 at ~19%-wide geometric buckets; the under/overflow buckets catch
# the rest, with exact min/max side stats.
TD_HIST_LO = 1e-3
TD_HIST_HI = 1e4
TD_HIST_GROWTH = 2 ** 0.25
TD_HIST_BUCKETS = geometric_bucket_count(TD_HIST_LO, TD_HIST_HI, TD_HIST_GROWTH)


def make_td_histogram() -> FixedBucketHistogram:
    """Host-side merge target matching :func:`bucket_counts`' spec."""
    return FixedBucketHistogram(lo=TD_HIST_LO, hi=TD_HIST_HI, growth=TD_HIST_GROWTH)


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


def host_read(tensors: t.Mapping[str, torch.Tensor]) -> t.Dict[str, np.ndarray]:
    """Device tensors read to the host in ONE transfer (flattened into
    one f64 tensor: exact for f32 values and integer counts), each
    returned as a numpy array of its shape."""
    keys = list(tensors)
    flat = torch.cat([tensors[k].reshape(-1).double() for k in keys]).cpu().numpy()
    out, at = {}, 0
    for k in keys:
        n = tensors[k].numel()
        out[k] = flat[at:at + n].reshape(tensors[k].shape)
        at += n
    return out


def reduce_metric_rows(rows: t.Sequence[t.Mapping[str, t.Any]]) -> dict:
    """Host-side epoch aggregation over per-burst metric rows (numpy
    arrays or host tensors): the suffix rules, over every axis but a
    ``_hist`` key's trailing bucket axis."""
    out: dict = {}
    for k in rows[0]:
        arr = np.stack([np.asarray(r[k]) for r in rows])
        r = reduction_for(k)
        if k.endswith("_hist"):
            out[k] = arr.reshape(-1, arr.shape[-1]).sum(axis=0)
        elif r == "sum":
            out[k] = arr.sum()
        elif r == "max":
            out[k] = arr.max()
        elif r == "min":
            out[k] = arr.min()
        else:
            out[k] = arr.mean()
    return out


# ----------------------------------------------------------- primitives


def global_norm(tensors: t.Iterable[torch.Tensor]) -> torch.Tensor:
    """L2 norm over every floating tensor of ``tensors`` as one vector,
    accumulated in f32: each tensor's norm (one multi-tensor kernel),
    then the norm of those. A stacked critic ensemble's leaves give the
    same value as the unstacked ones."""
    xs = [x.detach().float() for x in tensors if x.is_floating_point()]
    if not xs:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack(torch._foreach_norm(xs)).norm()


def norm_ratio(update_norm: torch.Tensor, params_norm: torch.Tensor) -> torch.Tensor:
    """Update-to-param ratio ``||update|| / ||params||`` (the JAX
    function, over norms): healthy Adam training sits near 1e-3."""
    return update_norm / (params_norm + 1e-12)


@torch.no_grad()
def snapshot(tensors: t.Sequence[torch.Tensor]) -> t.List[torch.Tensor]:
    """Copies of ``tensors`` (one multi-tensor copy; inside a captured
    update they come from the graph's pool)."""
    before = [torch.empty_like(x) for x in tensors]
    torch._foreach_copy_(before, [x.detach() for x in tensors])
    return before


@torch.no_grad()
def update_ratio(params: t.Sequence[torch.Tensor], before: t.Sequence[torch.Tensor]
                 ) -> torch.Tensor:
    """``||params - before|| / ||before||``: the step the optimizer just
    applied (``before`` its :func:`snapshot` of the parameters) over the
    parameters it started from — JAX's ``norm_ratio(updates, params)``.
    Optax hands its ``updates`` out; torch's Adam steps in place, so the
    update is read back as the difference, which is the applied step to
    the parameters' rounding."""
    delta = torch._foreach_sub([p.detach() for p in params], list(before))
    return norm_ratio(global_norm(delta), global_norm(before))


@torch.no_grad()
def scalar_adam_step(opt: torch.optim.Adam) -> torch.Tensor:
    """The size of the step an Adam over ONE scalar parameter just took,
    from its state: ``lr / (1 - b1^t) · |m| / (sqrt(v) / sqrt(1 - b2^t) +
    eps)``. (A scalar such as ``log_alpha`` is far larger than its step,
    so :func:`update_ratio`'s difference would keep too few of the step's
    digits.)"""
    group = opt.param_groups[0]
    (p,) = group["params"]
    st = opt.state[p]
    b1, b2 = group["betas"]
    step = st["step"].to(p.device, torch.float32)
    denom = st["exp_avg_sq"].sqrt() / (1 - b2 ** step).sqrt() + group["eps"]
    return group["lr"] / (1 - b1 ** step) * st["exp_avg"].abs() / denom


def bucket_counts(
    values: torch.Tensor,
    lo: float = TD_HIST_LO,
    growth: float = TD_HIST_GROWTH,
    n_buckets: int = TD_HIST_BUCKETS,
) -> torch.Tensor:
    """On-device fixed-bucket histogram of ``|values|``: an int32
    ``(n_buckets + 2,)`` count vector (underflow, the geometric interior,
    overflow) under ``FixedBucketHistogram.record``'s indexing, by one
    scatter-add into a tensor of fixed size (integer atomics: the counts
    are exact and do not depend on the order). Non-finite samples are
    dropped (they are the divergence sentinel's business)."""
    v = values.detach().float().abs().reshape(-1)
    valid = torch.isfinite(v)
    v = torch.where(valid, v, torch.full_like(v, lo))
    idx = torch.floor(
        (torch.log(torch.clamp(v, min=lo * 0.5)) - math.log(lo)) / math.log(growth)
    ).to(torch.int32) + 1
    idx = torch.where(v < lo, torch.zeros_like(idx), idx.clamp(1, n_buckets + 1))
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    counts = torch.zeros(n_buckets + 2, dtype=torch.int32, device=v.device)
    return counts.scatter_add_(0, idx.long(), valid.to(torch.int32))


# ------------------------------------------------ per-member primitives


def member_global_norm(tensors: t.Iterable[torch.Tensor]) -> torch.Tensor:
    """:func:`global_norm` per member of member-stacked tensors (member
    axis first), in f32: the floating tensors' ``(P, -1)`` rows joined
    into one ``(P, N)`` matrix (one copy), then each row's L2 norm (one
    reduction). Returns ``(P,)``; member ``i``'s value is
    :func:`global_norm` of the tensors' ``[i]`` slices: two kernels for
    any number of tensors, where a reduction per tensor is one each."""
    xs = [x.detach().float() for x in tensors if x.is_floating_point()]
    return torch.cat([x.reshape(x.shape[0], -1) for x in xs], dim=1).norm(dim=1)


@torch.no_grad()
def member_update_ratio(params: t.Sequence[torch.Tensor], before: t.Sequence[torch.Tensor]
                        ) -> torch.Tensor:
    """:func:`update_ratio` per member: ``(P,)``."""
    delta = torch._foreach_sub([p.detach() for p in params], list(before))
    return norm_ratio(member_global_norm(delta), member_global_norm(before))


def member_saturation_fraction(actions: torch.Tensor, act_limit: float,
                               threshold: float = 0.99) -> torch.Tensor:
    """Fraction of each member's action components pinned against the
    tanh squash (``|a| > threshold * act_limit``) of ``(P, ...)``
    actions: ``(P,)`` (JAX's ``saturation_fraction`` per member)."""
    pinned = (actions.abs() > threshold * act_limit).float()
    return pinned.reshape(pinned.shape[0], -1).mean(dim=1)
