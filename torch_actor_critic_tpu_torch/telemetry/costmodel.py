"""Per-program compute-cost attribution: FLOPs, bytes, roofline, MFU
(port of ``telemetry/costmodel.py``).

The JAX package reads a compiled program's FLOPs and bytes from XLA's
cost analysis. The port has no compiled program to ask, so it counts
one eager run of the program:

- :class:`CostCount` — a ``TorchDispatchMode`` that sums the FLOPs of
  the ATen ops it sees (``torch.utils.flop_counter``'s formulas: the
  matrix products and convolutions) and, for every op that is not a
  view, the bytes of its tensor inputs and outputs. The hand-written
  kernels K1–K4 are ctypes calls, not ATen ops, so the counter cannot
  see them: their wrappers (``ops/attention.py``, ``ops/pixels.py``)
  report their work by formula (:func:`attention_fwd_work`,
  :func:`attention_bwd_work`, :func:`pixel_gather_work`) through
  :func:`note_kernel`, and run their own ATen ops (padding, output
  allocation, and on the CPU the plain versions) under
  :meth:`CostCount.paused`. A counted update therefore registers the
  same FLOPs and bytes whether the kernels or their plain versions ran,
  and causal attention counts only the visible (q, k) pairs the
  kernels compute, where the plain versions form the full score
  matrix. Bytes are an over-estimate, as the JAX package's lowered
  analysis is: every counted op's inputs are read and its outputs
  written once, with no fusion and no cache.
- :class:`CostRegistry` — the process-wide registry
  (:func:`get_cost_registry`) of per-call costs by program name
  (``train/update``, ``train/update_burst``, ``train/ondevice_epoch``).
  A program registers once, from an eager call: never inside a CUDA
  graph capture, never from replays (a replay calls no Python).
- :func:`roofline` — a registered cost and a measured span duration
  give achieved FLOP/s, arithmetic intensity, MFU and the
  compute-/memory-bound class against :class:`Peaks`.
- :class:`Peaks` — the card's published peaks by
  ``torch.cuda.get_device_name()``: an H100 SXM ("H100 80GB HBM3") has
  989e12 FLOP/s dense in bf16, 67e12 in f32 (the CUDA cores: the
  package turns TF32 off, so f32 products do not reach the tensor
  cores) and 3.35e12 B/s of HBM. The MFU denominator follows the
  program's compute dtype. ``TAC_PEAK_FLOPS`` / ``TAC_PEAK_BW``
  override both; an unknown card, or the CPU, gets ``None``.
  :func:`card_peaks` reads the same table without the overrides and
  adds the f32 rate of the hand-written kernels, which take f32
  products to the tensor cores as 3xTF32 (495e12 / 3 FLOP/s on an
  H100 SXM): the bound of a K2-K4 launch.
- :func:`classify_epoch` — host/device/input attribution of one host
  trainer epoch from its phase spans.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import typing as t

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_flatten

logger = logging.getLogger(__name__)

__all__ = [
    "CardPeaks",
    "CostCount",
    "CostRegistry",
    "Peaks",
    "PendingCount",
    "attention_bwd_work",
    "attention_fwd_work",
    "card_peaks",
    "classify_epoch",
    "get_cost_registry",
    "note_kernel",
    "paused",
    "peak_flops_for",
    "peak_hbm_bw_for",
    "pixel_gather_work",
    "roofline",
    "roofline_metrics",
]

class CardPeaks(t.NamedTuple):
    """A card's published dense peaks (NVIDIA's data sheets)."""

    tag: str  # matched as a substring of the lower-cased device name
    bf16: float  # FLOP/s, bf16 on the tensor cores
    f32: float  # FLOP/s, f32 on the CUDA cores (TF32 off: the package's f32)
    hbm_bw: float  # bytes/s
    # FLOP/s, f32 as 3xTF32 on the tensor cores (three TF32 products per
    # f32 product, TF32's rate / 3): the route K2-K4 take for f32.
    f32_3xtf32: float


_H100_SXM = (989e12, 67e12, 3.35e12, 495e12 / 3)
PEAKS_BY_NAME: t.Tuple[CardPeaks, ...] = (
    CardPeaks("h100 80gb hbm3", *_H100_SXM),
    CardPeaks("h100 sxm", *_H100_SXM),
)


def card_peaks(device_kind: str | None) -> CardPeaks | None:
    """The table's row for a card (no env overrides), or None."""
    kind = (device_kind or "").lower()
    return next((row for row in PEAKS_BY_NAME if row.tag in kind), None)


def peak_flops_for(device_kind: str | None, compute_dtype: str = "bfloat16") -> float | None:
    """Peak FLOP/s of a card at ``compute_dtype`` (``bfloat16`` or
    ``float32``); env ``TAC_PEAK_FLOPS`` wins."""
    env = os.environ.get("TAC_PEAK_FLOPS")
    if env:
        return float(env)
    row = card_peaks(device_kind)
    if row is None:
        return None
    return row.f32 if str(compute_dtype) in ("float32", "f32") else row.bf16


def peak_hbm_bw_for(device_kind: str | None) -> float | None:
    """Peak HBM bytes/s of a card (env ``TAC_PEAK_BW`` wins)."""
    env = os.environ.get("TAC_PEAK_BW")
    if env:
        return float(env)
    row = card_peaks(device_kind)
    return None if row is None else row.hbm_bw


class Peaks(t.NamedTuple):
    """The roofline denominators. ``flops`` in FLOP/s (at the program's
    compute dtype), ``hbm_bw`` in bytes/s; either may be None (the
    dependent metrics are then omitted)."""

    flops: float | None
    hbm_bw: float | None
    device_kind: str | None = None

    @classmethod
    def detect(cls, compute_dtype: str = "bfloat16") -> "Peaks":
        """Peaks of CUDA device 0 at ``compute_dtype`` (env overrides
        honoured); None entries on the CPU or an unknown card."""
        kind = torch.cuda.get_device_name(0) if torch.cuda.is_available() else None
        return cls(peak_flops_for(kind, compute_dtype), peak_hbm_bw_for(kind), kind)


# --------------------------------------------------- the kernels' formulas


def _itemsize(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


def _visible_pairs(tq: int, tk: int, causal: bool) -> int:
    """(q, k) pairs a forward computes: all of them, or under causality
    (query ``i`` sees keys ``0..i``) ``sum_i min(i + 1, tk)``."""
    if not causal:
        return tq * tk
    full = min(tq, tk)
    return full * (full + 1) // 2 + max(tq - tk, 0) * tk


def attention_fwd_work(shape, causal: bool, dtype: torch.dtype, lse: bool = False
                       ) -> t.Tuple[int, int]:
    """``(flops, bytes)`` of one K2 call on ``(B, H, Tq, Tk, d)``: the two
    products QKᵀ and PV over the visible (q, k) pairs (``4·d`` FLOPs a
    pair); q, k, v read once, o written once (and the f32 lse, with
    ``lse``)."""
    b, h, tq, tk, d = shape
    flops = 4 * d * _visible_pairs(tq, tk, causal) * b * h
    nbytes = (2 * tq + 2 * tk) * b * h * d * _itemsize(dtype) + (4 * b * h * tq if lse else 0)
    return flops, nbytes


def attention_bwd_work(shape, causal: bool, dtype: torch.dtype, kernel: str
                       ) -> t.Tuple[int, int]:
    """``(flops, bytes)`` of one backward kernel on ``(B, H, Tq, Tk, d)``:
    K3 (``flash_bwd_dq``) three products (s, dO·Vᵀ, ds·K) over the
    visible pairs plus Δ = rowsum(dO∘O) (``2d`` a row), reading q, o, dO,
    k, v and the f32 lse once and writing dq and the f32 Δ once; K4
    (``flash_bwd_dkv``) four (s, pᵀ·dO, dO·Vᵀ, dsᵀ·Q), reading q, dO, k,
    v, lse and Δ once and writing dk and dv once."""
    b, h, tq, tk, d = shape
    elt = _itemsize(dtype)
    products = 3 if kernel == "flash_bwd_dq" else 4
    flops = 2 * products * d * _visible_pairs(tq, tk, causal) * b * h
    if kernel == "flash_bwd_dq":
        flops += 2 * d * b * h * tq
        nbytes = (4 * tq + 2 * tk) * b * h * d * elt + 2 * b * h * tq * 4
    else:
        nbytes = (2 * tq + 4 * tk) * b * h * d * elt + 2 * b * h * tq * 4
    return flops, nbytes


def pixel_gather_work(batch: int, frame, stack: int, dtype: torch.dtype, shift: bool,
                      leaves: int = 1) -> t.Tuple[int, int]:
    """``(flops, bytes)`` of one K1 call: no arithmetic to speak of (0);
    per leaf the uint8 frames read once (``B·S·H·W·C``), its int32
    offsets read once and its output written once, and the int64 rows
    read once for all leaves."""
    h, w, c = frame
    elems = batch * stack * h * w * c
    per_leaf = elems + (8 * batch if shift else 0) + elems * _itemsize(dtype)
    return 0, 8 * batch + leaves * per_leaf


# ------------------------------------------------------------- the count


def _tensor_bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(x.numel() * x.element_size() for x in leaves if isinstance(x, torch.Tensor))


class CostCount(TorchDispatchMode):
    """Counts the FLOPs and bytes of the ATen ops run under it, plus the
    kernels' formula work reported by their wrappers
    (:func:`note_kernel`). ``with CostCount() as count: ...`` then
    :meth:`cost`. Autograd's backward runs under the same mode (its
    threads inherit the dispatch-mode stack), so a counted update's
    K3/K4 calls are seen too."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.kernels: t.Dict[str, int] = {}
        self.kernel_flops = 0
        self.kernel_bytes = 0
        self._paused = 0
        self._lock = threading.Lock()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused or func.is_view:
            return out
        from torch.utils.flop_counter import flop_registry

        formula = flop_registry.get(func.overloadpacket)
        flops = int(formula(*args, **kwargs, out_val=out)) if formula is not None else 0
        nbytes = _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        with self._lock:
            self.flops += flops
            self.bytes += nbytes
            self.ops += 1
        return out

    def add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        with self._lock:
            self.kernels[name] = self.kernels.get(name, 0) + 1
            self.kernel_flops += int(flops)
            self.kernel_bytes += int(nbytes)

    @contextlib.contextmanager
    def paused(self):
        """ATen ops inside are not counted (a wrapper's own ops: its
        work was counted by formula)."""
        with self._lock:
            self._paused += 1
        try:
            yield
        finally:
            with self._lock:
                self._paused -= 1

    def cost(self) -> dict:
        """``{flops, bytes_accessed, aten_flops, aten_bytes,
        kernel_flops, kernel_bytes, ops, kernels}``: the totals, their
        ATen and formula shares, the counted op count and each kernel's
        calls."""
        with self._lock:
            return {
                "flops": float(self.flops + self.kernel_flops),
                "bytes_accessed": float(self.bytes + self.kernel_bytes),
                "aten_flops": float(self.flops),
                "aten_bytes": float(self.bytes),
                "kernel_flops": float(self.kernel_flops),
                "kernel_bytes": float(self.kernel_bytes),
                "ops": self.ops,
                "kernels": dict(self.kernels),
            }


def active_count() -> CostCount | None:
    """The innermost :class:`CostCount` on the dispatch-mode stack, or
    ``None`` (the common case: one C call)."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostCount):
            return mode
    return None


def note_kernel(name: str, work: t.Callable[..., t.Tuple[int, int]], *args) -> CostCount | None:
    """A kernel wrapper's report: when a count is active, add ``work(*args)``
    (``(flops, bytes)``) under ``name``. Returns the count (``None``
    without one), for :func:`paused`."""
    count = active_count()
    if count is not None:
        count.add_kernel(name, *work(*args))
    return count


def paused(count: CostCount | None):
    """``count.paused()``, or a null context without a count."""
    return contextlib.nullcontext() if count is None else count.paused()


# ------------------------------------------------------------- roofline


def roofline(
    cost: t.Mapping[str, float],
    duration_s: float,
    calls: int = 1,
    peaks: Peaks | None = None,
    compute_dtype: str | None = None,
) -> dict:
    """One program's live roofline position (the JAX function, unchanged):
    ``cost`` a registry entry (per-call FLOPs/bytes), ``duration_s`` the
    measured time ``calls`` executions took. Returns achieved FLOP/s and
    bytes/s, arithmetic intensity and, with known peaks, MFU, HBM
    utilisation, the ridge point, the ``compute``/``memory`` class, the
    attainable FLOP/s and the roofline fraction."""
    def sig(x, digits=4):
        return float(f"{float(x):.{digits}g}")

    flops = float(cost.get("flops", 0.0))
    bytes_ = float(cost.get("bytes_accessed", 0.0))
    out = {
        "flops_per_call": flops,
        "bytes_per_call": bytes_,
        "calls": int(calls),
        "duration_s": round(float(duration_s), 6),
    }
    if compute_dtype is not None:
        out["compute_dtype"] = str(compute_dtype)
    if duration_s > 0 and calls > 0:
        out["achieved_flops_per_sec"] = flops * calls / duration_s
        out["achieved_bytes_per_sec"] = bytes_ * calls / duration_s
    ai = flops / bytes_ if bytes_ > 0 else None
    if ai is not None:
        out["arithmetic_intensity"] = sig(ai)
    if peaks is None:
        peaks = Peaks(None, None)
    if peaks.flops and "achieved_flops_per_sec" in out:
        out["mfu"] = sig(out["achieved_flops_per_sec"] / peaks.flops)
        out["peak_flops"] = peaks.flops
    if peaks.hbm_bw and "achieved_bytes_per_sec" in out:
        out["hbm_util"] = sig(out["achieved_bytes_per_sec"] / peaks.hbm_bw)
        out["peak_hbm_bw"] = peaks.hbm_bw
    if peaks.flops and peaks.hbm_bw and ai is not None:
        ridge = peaks.flops / peaks.hbm_bw
        out["ridge_flops_per_byte"] = sig(ridge)
        out["bound"] = "compute" if ai >= ridge else "memory"
        attainable = min(peaks.flops, ai * peaks.hbm_bw)
        out["attainable_flops_per_sec"] = attainable
        if "achieved_flops_per_sec" in out and attainable > 0:
            out["roofline_frac"] = sig(out["achieved_flops_per_sec"] / attainable)
    if "achieved_flops_per_sec" in out:
        out["achieved_flops_per_sec"] = round(out["achieved_flops_per_sec"])
        out["achieved_bytes_per_sec"] = round(out["achieved_bytes_per_sec"])
    return out


def roofline_metrics(prefix: str, cost: t.Mapping[str, float], rl: t.Mapping[str, t.Any]) -> dict:
    """An epoch's ``cost/<prefix>_*`` metrics from a program's per-call
    ``cost`` and its :func:`roofline`: GFLOPs a call, achieved GFLOP/s,
    and with their inputs known the arithmetic intensity, the MFU and
    whether the program is compute-bound (JAX's keys)."""
    out = {f"cost/{prefix}_gflops": cost["flops"] / 1e9,
           f"cost/{prefix}_achieved_gflops_s": rl.get("achieved_flops_per_sec", 0.0) / 1e9}
    for key, name in (("arithmetic_intensity", "ai"), ("mfu", "mfu")):
        if key in rl:
            out[f"cost/{prefix}_{name}"] = rl[key]
    if "bound" in rl:
        out[f"cost/{prefix}_compute_bound"] = float(rl["bound"] == "compute")
    return out


class CostRegistry:
    """Process-wide registry of per-call program costs by name (the
    watchdog's source names). Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._costs: t.Dict[str, dict] = {}  # guarded-by: _lock

    def register(self, name: str, cost: t.Mapping[str, t.Any]) -> None:
        with self._lock:
            self._costs[name] = dict(cost)
        logger.info("cost registry: %s = %.4g GFLOPs, %.4g MB accessed per call",
                    name, float(cost["flops"]) / 1e9, float(cost["bytes_accessed"]) / 1e6)

    def get(self, name: str) -> dict | None:
        with self._lock:
            c = self._costs.get(name)
        return dict(c) if c is not None else None

    def costs(self) -> t.Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._costs.items()}

    def reset(self) -> None:
        """Test isolation."""
        with self._lock:
            self._costs.clear()


_REGISTRY: CostRegistry | None = None
_SINGLETON_LOCK = threading.Lock()


def get_cost_registry() -> CostRegistry:
    """The process-wide cost registry (lazy, like the watchdog)."""
    global _REGISTRY
    with _SINGLETON_LOCK:
        if _REGISTRY is None:
            _REGISTRY = CostRegistry()
        return _REGISTRY


# ------------------------------------------------- host/device attribution

# Which side of the host/device boundary each trainer phase's time
# belongs to. Launches are asynchronous, so queued device work surfaces
# under `drain` (the epoch's wait for the device); `burst_dispatch` is
# the host's enqueue of the burst, charged to the device plane because
# it scales with device-work submission.
PHASE_PLANES: t.Mapping[str, str] = {
    "act": "host",
    "env_step": "host",
    "stage": "input",
    "place_chunk": "input",
    "burst_dispatch": "device",
    "drain": "device",
    "sentinel": "host",
    "checkpoint": "host",
}


def classify_epoch(
    phases: t.Mapping[str, t.Mapping[str, float]], wall_s: float
) -> dict:
    """Host/device/input attribution of one epoch from its phase stats
    (``{name: {"total_s": ...}}``): the device-busy fraction is
    burst+drain time over wall time; the class is the largest plane's
    (``host-bound`` / ``device-bound`` / ``input-bound``)."""
    sums = {"host": 0.0, "device": 0.0, "input": 0.0}
    for name, stats in phases.items():
        plane = PHASE_PLANES.get(name)
        if plane is not None:
            sums[plane] += float(stats.get("total_s", 0.0))
    wall = max(float(wall_s), 1e-12)
    fracs = {k: round(v / wall, 4) for k, v in sums.items()}
    bound = max(sums, key=sums.get)
    return {
        "class": f"{bound}-bound",
        "device_busy_frac": fracs["device"],
        "host_frac": fracs["host"],
        "input_frac": fracs["input"],
    }


class PendingCount:
    """A program to count once, at its next eager call: :meth:`request`
    names it, and the caller runs each call under :meth:`scope`, which
    is a null context unless a count is pending and the current stream
    is not capturing a CUDA graph. The counted call runs under the
    watchdog's ``expected`` and registers its :meth:`CostCount.cost` in
    the process's registry."""

    def __init__(self):
        self.name: str | None = None

    def request(self, name: str) -> None:
        self.name = name

    def scope(self):
        if self.name is None or (torch.cuda.is_available()
                                 and torch.cuda.is_current_stream_capturing()):
            return contextlib.nullcontext()
        return self._count()

    @contextlib.contextmanager
    def _count(self):
        from torch_actor_critic_tpu_torch.diagnostics.watchdog import get_watchdog

        name, self.name = self.name, None
        with get_watchdog().expected(), CostCount() as count:
            yield
        get_cost_registry().register(name, count.cost())
