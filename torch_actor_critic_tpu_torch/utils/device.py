"""Device selection for the port's entry points.

Every entry point runs on the card unless its caller names the CPU:
``device=None`` means ``cuda``, and a process without a usable card
raises instead of silently serving from host cores.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` selects ``cuda`` and
    raises when no card is visible (pass ``"cpu"`` to run on the host)."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU "
            "unless the caller asks for the CPU (device='cpu', "
            "--device cpu)"
        )
    return device
