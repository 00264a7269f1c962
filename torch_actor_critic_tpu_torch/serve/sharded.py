"""The serving precision tiers (port of ``serve/sharded.py``) at a 1x1
sub-mesh: one policy replica on one device. A
:class:`~.engine.PolicyEngine` built with ``precision=`` serves them;
this module holds what each tier does to the params and the module:

- **f32** is the single-device engine, bitwise.
- **bf16** rebuilds the actor at ``torch.bfloat16`` compute width
  (:func:`with_compute_dtype`, the modules' ``compute_dtype``):
  parameters stay f32 at rest, the casts happen inside the forward and
  the heads return f32. The sequence policy's attention (K2,
  ``csrc/flash_fwd.cu``) then runs in bf16.
- **int8** serves weight-quantized params: per-output-channel symmetric
  scales computed ONCE at register/reload time (:func:`quantize_params`),
  and the forward's first op dequantizes (:func:`dequantize_params`),
  inside the graph, so the weights sit in device memory as int8.

"Output channel" is the axis that maps to the Flax layout's LAST axis,
where the JAX package takes its scales: axis 0 of an ``nn.Linear`` or
``nn.Conv2d`` ``weight`` (``(out, in[, kh, kw])``; ``weights.py``
transposes Flax's ``(in, out)`` and ``(kh, kw, in, out)`` kernels), and
the last axis of any other leaf (the sequence trunk's position table,
stored as Flax stores it).

A sub-mesh larger than 1x1 (GSPMD tensor/FSDP sharding over several
devices) is not ported: :func:`check_submesh` refuses it, naming the
data-parallel and sharding queue.
"""

from __future__ import annotations

import copy
import typing as t

import torch

__all__ = [
    "Int8Param",
    "PRECISIONS",
    "channel_axis",
    "check_submesh",
    "dequantize_params",
    "quantize_params",
    "with_compute_dtype",
]

PRECISIONS = ("f32", "bf16", "int8")


def check_submesh(submesh) -> t.Tuple[int, int]:
    """``(tp, fsdp)``; anything but ``(1, 1)`` raises."""
    tp, fsdp = (int(x) for x in submesh)
    if (tp, fsdp) != (1, 1):
        raise NotImplementedError(
            f"sub-mesh {tp}x{fsdp}: serving one policy sharded over several "
            "devices is not ported (ROADMAP queue 6, data parallel and "
            "sharding); the port serves 1x1 sub-meshes"
        )
    return tp, fsdp


class Int8Param(t.NamedTuple):
    """One weight-quantized parameter: ``q`` the int8 tensor (the
    weight's shape), ``scale`` the f32 per-output-channel scales
    (length ``q.shape[axis]``), ``axis`` the output-channel axis."""

    q: torch.Tensor
    scale: torch.Tensor
    axis: int = 0


def channel_axis(name: str, leaf: torch.Tensor) -> int:
    """The axis of ``leaf`` that maps to the Flax layout's last axis."""
    return 0 if name.endswith(".weight") else leaf.dim() - 1


def _quantizable(leaf) -> bool:
    """Floating leaves of two or more dimensions (the matmul and conv
    weights, and the position table); biases and LayerNorm scales stay
    f32."""
    return isinstance(leaf, torch.Tensor) and leaf.dim() >= 2 and leaf.is_floating_point()


def _along(scale: torch.Tensor, axis: int, ndim: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[axis] = -1
    return scale.reshape(shape)


def quantize_params(params: t.Mapping[str, t.Any]) -> t.Dict[str, t.Any]:
    """Per-channel symmetric int8 weight quantization (register/reload
    time, never per request): for each quantizable leaf ``W`` the scale
    of channel ``c`` is ``max|W[c]| / 127`` with a 1e-12 floor, and
    ``q = clip(rint(W / scale), -127, 127)``; other leaves (an
    :class:`Int8Param` too) pass through."""
    out: t.Dict[str, t.Any] = {}
    for name, w in params.items():
        if not _quantizable(w):
            out[name] = w
            continue
        axis = channel_axis(name, w)
        w32 = w.float()
        dims = [d for d in range(w32.dim()) if d != axis]
        amax = w32.abs().amax(dim=dims)
        scale = torch.clamp(amax, min=1e-12) / 127.0
        q = torch.clamp(torch.round(w32 / _along(scale, axis, w32.dim())), -127, 127)
        out[name] = Int8Param(q.to(torch.int8), scale, axis)
    return out


def dequantize_params(params: t.Mapping[str, t.Any], dtype=torch.float32) -> t.Dict[str, torch.Tensor]:
    """The inverse of :func:`quantize_params`: ``q * scale`` in ``dtype``,
    unquantized leaves as they are."""
    return {
        name: (v.q.to(dtype) * _along(v.scale.to(dtype), v.axis, v.q.dim())
               if isinstance(v, Int8Param) else v)
        for name, v in params.items()
    }


def with_compute_dtype(module: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """A copy of ``module`` whose layers compute in ``dtype`` (the
    port's Dense/Conv ``compute_dtype`` and the sequence trunk's stream
    ``dtype``); its parameters stay as they are."""
    twin = copy.deepcopy(module)
    knobs = 0
    for m in twin.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
            knobs += 1
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = dtype
            knobs += 1
    if not knobs:
        raise ValueError(
            f"{type(module).__name__} has no compute-dtype knob; the bf16 "
            "serving tier needs a model built with one"
        )
    return twin
