"""Device memory watermarks from PyTorch's caching allocator (port of
``telemetry/memory.py``).

``torch.cuda.memory_stats`` is a host-side read of the allocator's
counters: it never synchronizes the device, so sampling once per epoch
costs nothing even with a burst in flight. The recorder samples the
watermarks at each epoch's end and resets the peaks at each epoch's
start (:func:`reset_peak_watermarks`), so an epoch event's peaks are
that epoch's own. The CPU has no such allocator: the result is ``None``
there, an honest "no device memory here" instead of zeros.
"""

from __future__ import annotations

import typing as t

import torch

__all__ = ["device_memory_watermarks", "reset_peak_watermarks"]


def _cuda_devices() -> t.List[int]:
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    return list(range(torch.cuda.device_count()))


def device_memory_watermarks() -> t.Optional[dict]:
    """The allocator's watermarks over the process's CUDA devices, or
    ``None`` without one (the CPU, or a process that never touched the
    card). Max-aggregated across devices (the question is how close the
    fullest device is to its limit): ``bytes_in_use_max`` and
    ``peak_bytes_in_use_max`` (allocated tensors), ``reserved_bytes_max``
    and ``peak_reserved_bytes_max`` (the allocator's segments),
    ``bytes_limit_min`` (the card's memory) and ``peak_frac_of_limit``."""
    per_device = []
    for i in _cuda_devices():
        s = torch.cuda.memory_stats(i)
        per_device.append({
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "reserved_bytes": s.get("reserved_bytes.all.current", 0),
            "peak_reserved_bytes": s.get("reserved_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        })
    if not per_device:
        return None
    out: dict = {"n_devices": len(per_device)}
    for key in ("bytes_in_use", "peak_bytes_in_use", "reserved_bytes", "peak_reserved_bytes"):
        out[f"{key}_max"] = int(max(s[key] for s in per_device))
    out["bytes_limit_min"] = int(min(s["bytes_limit"] for s in per_device))
    out["peak_frac_of_limit"] = round(out["peak_reserved_bytes_max"] / out["bytes_limit_min"], 4)
    return out


def reset_peak_watermarks() -> None:
    """Start a new peak window on every CUDA device (a no-op without
    one)."""
    for i in _cuda_devices():
        torch.cuda.reset_peak_memory_stats(i)
