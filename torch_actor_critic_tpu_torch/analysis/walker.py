"""Shared AST infrastructure for the port's tac-lint pass (a copy of the
JAX package's ``analysis/walker.py``; the rule families are the port's).

One parse per file feeds every rule family: the AST itself, a parent
map (ast gives children only), a qualname index over every function
and class, the comment side-channel (``ast`` drops comments, so
suppressions and ``guarded-by`` annotations come from ``tokenize``),
and the per-line suppression table.

Suppression policy: ``# tac-lint: disable=<rule>`` on the offending
line, and every suppression MUST name at least one known rule — a bare
``# tac-lint: disable`` (or one naming an unknown rule) is itself a
finding (``bare-suppression``), so suppressions can never silently rot
into blanket waivers.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
import typing as t

__all__ = [
    "Finding",
    "FileContext",
    "FunctionInfo",
    "dotted_name",
    "iter_file_functions",
]

# Every rule id the pass can emit, grouped by family. capture.py,
# generators.py, locks.py, conventions.py and contracts.py each own
# their families; the walker owns the suppression meta-rule. One table
# so the CLI's --list-rules and the suppression validator share a
# source of truth. The JAX package's jit-hygiene, recompile-risk and
# donation-safety families became capture-hygiene (a CUDA graph is the
# port's compiled program), prng-discipline became generator-discipline;
# the rules with no counterpart yet are listed in ROADMAP.md.
RULE_FAMILIES: t.Dict[str, t.Tuple[str, ...]] = {
    "capture-hygiene": (
        "host-sync-in-capture",
        "wallclock-in-capture",
        "global-random-in-capture",
        "capture-in-loop",
        "rebind-under-graph",
        "stale-entry-point",
    ),
    "lock-discipline": (
        "unlocked-guarded-access",
        "unguarded-shared-attr",
        "unknown-guard",
    ),
    "generator-discipline": (
        "draw-without-generator",
        "unregistered-generator",
        "global-host-random",
    ),
    "contract-drift": (
        "missing-watchdog-scope",
        "missing-cost-registration",
        "stale-contract",
        "stale-bundle-manifest",
    ),
    "conventions": (
        "silent-exception-swallow",
        "mutable-default-arg",
        "suffix-reduction-mismatch",
    ),
    "meta": ("bare-suppression",),
}

ALL_RULES: t.FrozenSet[str] = frozenset(
    rule for rules in RULE_FAMILIES.values() for rule in rules
)


def family_of(rule: str) -> str:
    for family, rules in RULE_FAMILIES.items():
        if rule in rules:
            return family
    raise KeyError(f"unknown rule id {rule!r}")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding: ``file:line``, the rule id, what is wrong,
    and how to fix it (the hint is part of the contract — a finding
    without a next action just stalls the author)."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    hint: str = ""

    def format(self) -> str:
        out = f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}"
        if self.hint:
            out += f"  [fix: {self.hint}]"
        return out

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class FunctionInfo:
    """One function/method with its dotted qualname
    (``Class.method.inner`` — module level is just ``name``)."""

    qualname: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    class_name: str | None  # innermost enclosing class, if any


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: t.List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def iter_file_functions(tree: ast.Module) -> t.List[FunctionInfo]:
    out: t.List[FunctionInfo] = []

    def visit(node: ast.AST, prefix: str, cls: str | None):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                out.append(FunctionInfo(q, child, cls))
                visit(child, q + ".", cls)
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.", child.name)
            else:
                visit(child, prefix, cls)

    visit(tree, "", None)
    return out


_SUPPRESS_RE = re.compile(
    r"#\s*tac-lint:\s*disable\s*(?:=\s*(?P<rules>[A-Za-z0-9_\-, ]*))?"
)
_GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*(?P<lock>[A-Za-z_][A-Za-z0-9_]*)")


class FileContext:
    """Everything the rules need about one file, parsed once."""

    def __init__(self, path: str, source: str):
        # `path` is the display/relative path findings carry.
        self.path = path
        self.source = source
        self.tree: ast.Module = ast.parse(source, filename=path)
        self.functions = iter_file_functions(self.tree)
        self._parents: t.Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent
        # ---- comment side-channel -------------------------------------
        self.comments: t.Dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(io.StringIO(source).readline):
                if tok.type == tokenize.COMMENT:
                    self.comments[tok.start[0]] = tok.string
        except tokenize.TokenError:  # pragma: no cover - ast.parse ok'd it
            pass
        # line -> rules suppressed on that line; meta findings for
        # malformed suppressions are collected here (a suppression that
        # names nothing must not be able to suppress its own finding).
        self.suppressions: t.Dict[int, t.Set[str]] = {}
        self.meta_findings: t.List[Finding] = []
        self.guarded_by: t.Dict[int, str] = {}
        for line, comment in self.comments.items():
            g = _GUARDED_BY_RE.search(comment)
            if g:
                self.guarded_by[line] = g.group("lock")
            m = _SUPPRESS_RE.search(comment)
            if m is None:
                continue
            raw = m.group("rules") or ""
            names = [n.strip() for n in raw.split(",") if n.strip()]
            if not names:
                self.meta_findings.append(Finding(
                    "bare-suppression", path, line, 0,
                    "suppression names no rule",
                    "write `# tac-lint: disable=<rule-id>`; blanket "
                    "suppressions are not allowed",
                ))
                continue
            unknown = [n for n in names if n not in ALL_RULES]
            if unknown:
                self.meta_findings.append(Finding(
                    "bare-suppression", path, line, 0,
                    f"suppression names unknown rule(s): "
                    f"{', '.join(sorted(unknown))}",
                    "use a rule id from `python -m "
                    "torch_actor_critic_tpu_torch.analysis --list-rules`",
                ))
            known = {n for n in names if n in ALL_RULES}
            if known:
                self.suppressions.setdefault(line, set()).update(known)

    # ------------------------------------------------------------- helpers

    def parent(self, node: ast.AST) -> ast.AST | None:
        return self._parents.get(node)

    def ancestors(self, node: ast.AST) -> t.Iterator[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def enclosing_function(
        self, node: ast.AST
    ) -> t.Union[ast.FunctionDef, ast.AsyncFunctionDef, None]:
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    def enclosing_function_names(self, node: ast.AST) -> t.List[str]:
        """Names of every enclosing function, innermost first."""
        return [
            anc.name for anc in self.ancestors(node)
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]

    def is_suppressed(self, finding: Finding) -> bool:
        rules = self.suppressions.get(finding.line)
        return rules is not None and finding.rule in rules
