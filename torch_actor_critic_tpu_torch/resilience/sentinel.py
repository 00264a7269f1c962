"""Divergence sentinel: detect non-finite training state, budget
rollbacks (port of ``resilience/sentinel.py``).

A single NaN reward poisons the twin-Q targets and from there every
parameter within a handful of updates. The sentinel makes divergence a
recoverable event:

- :func:`tree_all_finite` — one all-finite reduction over every
  floating leaf of the given trees (tensors, state dicts, modules,
  optimizers, the learner's and the ring's dataclasses, lists), read
  back once per device. Integer, bool and uint8 leaves (the frame ring)
  cannot hold NaN/inf and are skipped; so are generators. It is also
  the serving registry's NaN gate.
- :class:`DivergenceSentinel` — the skip-and-resume policy: every
  divergence is answered by a rollback to the last sentinel-validated
  checkpoint (the trainer only checkpoints states the sentinel has
  passed, so "latest checkpoint" and "last-good" are the same thing),
  bounded by ``max_rollbacks`` *consecutive* failures before the run
  aborts with :class:`TrainingDiverged`. A finite epoch resets the
  budget.

The replay ring is part of the checked state on purpose: a NaN
transition sits in the buffer waiting to be sampled long after the
step that produced it, so rolling back params while keeping a poisoned
buffer re-diverges on the next unlucky batch.
"""

from __future__ import annotations

import dataclasses
import typing as t

import torch
from torch import nn

__all__ = ["TrainingDiverged", "DivergenceSentinel", "tree_all_finite"]


class TrainingDiverged(RuntimeError):
    """Raised when divergence persists past the rollback budget (or no
    checkpoint exists to roll back to)."""


def _leaves(tree: t.Any) -> t.Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.state_dict(keep_vars=True).values()
    elif isinstance(tree, torch.optim.Optimizer):
        for state in tree.state.values():
            yield from _leaves(state)
    elif isinstance(tree, t.Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif tree is not None and not isinstance(tree, torch.Generator):
        yield torch.as_tensor(tree)


def tree_all_finite(*trees: t.Any) -> bool:
    """True iff every floating-point leaf of every tree is finite."""
    flags = [
        torch.isfinite(x.detach()).all()
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


class DivergenceSentinel:
    """Rollback budget + bookkeeping around :func:`tree_all_finite`.

    Also the accounting point for leading indicators reported through
    :meth:`note_warning` (no rollback, no budget consumed)."""

    def __init__(self, max_rollbacks: int = 3):
        if max_rollbacks < 0:
            raise ValueError(f"max_rollbacks must be >= 0, got {max_rollbacks}")
        self.max_rollbacks = max_rollbacks
        self.consecutive = 0
        self.total_rollbacks = 0
        self.warnings_total = 0
        self.warnings_by_kind: t.Dict[str, int] = {}

    def check(self, *trees: t.Any) -> bool:
        """One sentinel pass; ``False`` means the caller must roll back
        (or abort via :meth:`note_divergence`)."""
        return tree_all_finite(*trees)

    def note_good(self) -> None:
        """A validated interval closes any divergence streak."""
        self.consecutive = 0

    def note_warning(self, kind: str) -> None:
        """Record a leading-indicator warning."""
        self.warnings_total += 1
        self.warnings_by_kind[kind] = self.warnings_by_kind.get(kind, 0) + 1

    def note_divergence(self, where: str = "training state") -> None:
        """Account one divergence; raises :class:`TrainingDiverged`
        once the consecutive budget is exhausted."""
        self.consecutive += 1
        self.total_rollbacks += 1
        if self.consecutive > self.max_rollbacks:
            raise TrainingDiverged(
                f"non-finite {where} persisted through "
                f"{self.max_rollbacks} consecutive rollbacks — the fault "
                "is systematic (bad hyperparameters, a deterministic env "
                "bug), not transient; aborting instead of looping"
            )
