"""All-finite check over parameter trees (port of
``resilience/sentinel.py::tree_all_finite``).

The serving registry's NaN gate: one fused reduction per tensor device,
read back once, over every floating leaf of the given state dicts /
tensors. Integer and bool leaves cannot hold NaN/inf and are skipped.
"""

from __future__ import annotations

import typing as t

import torch

__all__ = ["tree_all_finite"]


def _leaves(tree: t.Any) -> t.Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, t.Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield torch.as_tensor(tree)


def tree_all_finite(*trees: t.Any) -> bool:
    """True iff every floating-point leaf of every tree is finite."""
    flags = [
        torch.isfinite(x).all()
        for tree in trees
        for x in _leaves(tree)
        if x.is_floating_point() or x.is_complex()
    ]
    if not flags:
        return True
    by_device: t.Dict[torch.device, t.List[torch.Tensor]] = {}
    for f in flags:
        by_device.setdefault(f.device, []).append(f)
    return all(bool(torch.stack(fs).all()) for fs in by_device.values())
