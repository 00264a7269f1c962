"""Convention lints: codebase-wide hygiene the planes rely on (a copy of
the JAX package's ``analysis/conventions.py``).

* ``silent-exception-swallow`` — ``except Exception: pass`` (or bare
  ``except:``) outside a shutdown path discards the only evidence a
  fault ever happened. The worked example is the vec_env worker
  config guard (envs/vec_env.py): a worker that silently failed to
  pin its CPU backend could grab the parent's accelerator and deadlock
  the handshake — the swallow hid exactly the context (worker index,
  exitcode) needed to debug it. Narrow the exception type or log it
  with enough context to act on; ``OSError``-narrow handlers and
  shutdown/teardown paths are exempt.
* ``mutable-default-arg`` — the classic: a list/dict/set default is
  evaluated once and shared across every call.
* ``suffix-reduction-mismatch`` — the telemetry suffix-key schema
  (diagnostics/ingraph.py ``reduction_for``): a ``*_max`` key
  aggregates by ``max`` downstream (scan-axis reduce, cross-replica
  collectives, host merges). Populating it with ``min(...)``/
  ``mean(...)`` (or ``*_min`` with ``max``, ``*_sum`` with ``mean``)
  produces a value whose downstream aggregation is incoherent — the
  number in metrics.jsonl is neither the max nor the mean of anything.
"""

from __future__ import annotations

import ast
import typing as t

from torch_actor_critic_tpu_torch.analysis.reachability import Project
from torch_actor_critic_tpu_torch.analysis.walker import (
    FileContext,
    Finding,
    dotted_name,
)

__all__ = ["check"]

FAMILY = "conventions"

_BROAD = frozenset({"Exception", "BaseException"})
_SHUTDOWN_MARKERS = (
    "close", "shutdown", "stop", "teardown", "drain", "kill",
    "cleanup", "__del__", "__exit__", "atexit", "terminate",
)
_MUTABLE_CTORS = frozenset({"list", "dict", "set", "collections.deque", "deque"})

# suffix -> reduction spellings that contradict it (the value feeding
# a *_max key may be anything, but a top-level call to one of these is
# an outright contradiction).
_SUFFIX_CONFLICTS: t.Dict[str, t.FrozenSet[str]] = {
    "_max": frozenset({"min", "mean", "average"}),
    "_min": frozenset({"max", "mean", "average"}),
    "_sum": frozenset({"mean", "average", "max", "min"}),
}


def check(project: Project) -> t.List[Finding]:
    findings: t.List[Finding] = []
    for ctx in project.files:
        _check_swallows(ctx, findings)
        _check_mutable_defaults(ctx, findings)
        _check_suffix_schema(ctx, findings)
    return findings


# ---------------------------------------------------------------- except


def _is_broad(handler: ast.ExceptHandler) -> bool:
    tp = handler.type
    if tp is None:
        return True
    names: t.List[str] = []
    if isinstance(tp, ast.Tuple):
        names = [dotted_name(e) or "" for e in tp.elts]
    else:
        names = [dotted_name(tp) or ""]
    return any(n.split(".")[-1] in _BROAD for n in names)


def _check_swallows(ctx: FileContext, findings: t.List[Finding]):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _is_broad(node):
            continue
        if not all(isinstance(s, ast.Pass) for s in node.body):
            continue
        enclosing = ctx.enclosing_function_names(node)
        if any(
            marker in name
            for name in enclosing
            for marker in _SHUTDOWN_MARKERS
        ):
            continue
        caught = "bare except" if node.type is None else (
            f"except {ast.unparse(node.type)}"
        )
        findings.append(Finding(
            "silent-exception-swallow", ctx.path,
            node.lineno, node.col_offset,
            f"{caught}: pass silently discards every failure on a "
            "non-shutdown path",
            "narrow the exception type, or log it with enough context "
            "to act on (the envs/vec_env.py worker-config guard is "
            "the worked example)",
        ))


# ------------------------------------------------------ mutable defaults


def _check_mutable_defaults(ctx: FileContext, findings: t.List[Finding]):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        defaults = list(node.args.defaults) + [
            d for d in node.args.kw_defaults if d is not None
        ]
        for d in defaults:
            mutable = isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(d, ast.Call)
                and dotted_name(d.func) in _MUTABLE_CTORS
            )
            if mutable:
                findings.append(Finding(
                    "mutable-default-arg", ctx.path, d.lineno, d.col_offset,
                    f"mutable default argument in {node.name}(): evaluated "
                    "once at def time and shared across every call",
                    "default to None and construct inside the body",
                ))


# -------------------------------------------------------- suffix schema


def _reduction_of(value: ast.AST) -> str | None:
    if not isinstance(value, ast.Call):
        return None
    name = dotted_name(value.func)
    if name is None:
        return None
    return name.split(".")[-1]


def _check_key_value(
    ctx: FileContext, key: str, value: ast.AST, findings: t.List[Finding]
):
    for suffix, conflicts in _SUFFIX_CONFLICTS.items():
        if not key.endswith(suffix):
            continue
        red = _reduction_of(value)
        if red in conflicts:
            findings.append(Finding(
                "suffix-reduction-mismatch", ctx.path,
                value.lineno, value.col_offset,
                f"metric key {key!r} aggregates by "
                f"{suffix[1:]!r} downstream (suffix convention, "
                f"diagnostics/ingraph.py) but is populated with "
                f"{red}(...)",
                f"rename the key or use the matching {suffix[1:]} "
                "reduction",
            ))
        return


def _check_suffix_schema(ctx: FileContext, findings: t.List[Finding]):
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if (
                    isinstance(k, ast.Constant)
                    and isinstance(k.value, str)
                    and v is not None
                ):
                    _check_key_value(ctx, k.value, v, findings)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if (
                    isinstance(target, ast.Subscript)
                    and isinstance(target.slice, ast.Constant)
                    and isinstance(target.slice.value, str)
                ):
                    _check_key_value(
                        ctx, target.slice.value, node.value, findings
                    )
