"""tac-lint for the PyTorch port: the codebase-native static-analysis
pass (a copy of the JAX package's ``analysis/`` over the port's idioms).

``python -m torch_actor_critic_tpu_torch.analysis [--json] [PATHS]``
runs six rule families over the port's package: capture-hygiene (host
syncs, clocks and global draws inside code a CUDA graph records, graphs
built per step, tensors a live graph reads rebound, the capture-site
table checked both ways), generator-discipline (every draw names a
``torch.Generator``; generators a capture draws from are registered),
lock-discipline (the ``# guarded-by:`` annotations of the threaded
serving and decoupled classes), contract-drift (each capture site's
watchdog note, cost registration and warm-start bundleability),
conventions (silent exception swallows, mutable defaults, the telemetry
suffix-key schema) and the suppression meta-rule.

The tier-1 wiring is ``tests/test_torch_analysis.py``'s whole-package
clean run: a new violation anywhere in the port fails ``pytest tests/``.
"""

from __future__ import annotations

import pathlib
import typing as t

from torch_actor_critic_tpu_torch.analysis import (
    capture,
    contracts,
    conventions,
    generators,
    locks,
)
from torch_actor_critic_tpu_torch.analysis.reachability import (
    ENTRY_POINTS,
    Project,
)
from torch_actor_critic_tpu_torch.analysis.walker import (
    ALL_RULES,
    RULE_FAMILIES,
    FileContext,
    Finding,
    family_of,
)

__all__ = [
    "ALL_RULES",
    "ENTRY_POINTS",
    "Finding",
    "RULE_FAMILIES",
    "family_of",
    "lint_paths",
    "lint_sources",
]

_FAMILY_CHECKS = (
    capture.check,
    locks.check,
    conventions.check,
    generators.check,
    contracts.check,
)


def _collect_files(paths: t.Sequence[str]) -> t.List[pathlib.Path]:
    out: t.List[pathlib.Path] = []
    for raw in paths:
        p = pathlib.Path(raw)
        if p.is_dir():
            out.extend(sorted(
                f for f in p.rglob("*.py") if "__pycache__" not in f.parts
            ))
        elif p.suffix == ".py":
            out.append(p)
    return out


def lint_sources(
    sources: t.Mapping[str, str],
    rules: t.Collection[str] | None = None,
) -> t.List[Finding]:
    """Lint in-memory sources (``{display_path: source}``). The unit
    the fixture tests drive; :func:`lint_paths` is a thin file-reading
    wrapper around it."""
    enabled = set(ALL_RULES if rules is None else rules)
    contexts = [
        FileContext(path, src) for path, src in sorted(sources.items())
    ]
    project = Project(contexts)
    findings: t.List[Finding] = []
    for check in _FAMILY_CHECKS:
        findings.extend(check(project))
    by_path = {c.path: c for c in contexts}
    kept = [
        f for f in findings
        if f.rule in enabled
        and (f.path not in by_path or not by_path[f.path].is_suppressed(f))
    ]
    # Malformed suppressions can never suppress themselves.
    if "bare-suppression" in enabled:
        for ctx in contexts:
            kept.extend(ctx.meta_findings)
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return kept


def lint_paths(
    paths: t.Sequence[str],
    rules: t.Collection[str] | None = None,
) -> t.List[Finding]:
    """Lint files/directories on disk; paths in findings are as given
    (relative stays relative, so ``file:line`` is clickable from the
    repo root)."""
    files = _collect_files(paths)
    sources = {f.as_posix(): f.read_text() for f in files}
    return lint_sources(sources, rules=rules)
