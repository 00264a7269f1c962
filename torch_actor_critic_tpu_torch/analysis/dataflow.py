"""Per-function def-use chains for the dataflow rule families (a copy of
the JAX package's ``analysis/dataflow.py``).

The syntactic rules look at a call shape or a lock scope; the dataflow
rules need to know what happens to a VALUE after a program point — "is
this tensor rebound while a live graph reads it". This module is the
shared engine: per-function, in-lexical-order event streams (binds/reads
of a tracked name) plus a conservative reachability predicate between
two events that understands the two control-flow facts straight-line
order gets wrong:

* **branch exclusivity** — events in the two arms of one ``if`` (or
  ``try``/``except``) never execute in sequence, so a key split in the
  ``if`` arm does not conflict with a split of the same key in the
  ``else`` arm;
* **early termination** — an arm that ends in ``return``/``raise``
  (/``continue``/``break``) never falls through, so an event inside it
  cannot reach an event after the ``if`` (the idiomatic
  ``if trivial: return early_result`` guard).

Everything stays within one function scope (nested ``def``/``lambda``
bodies are separate scopes, surfaced as ``closure`` events at the def
site). No interprocedural propagation: the rule families
stay conservative and their findings stay explainable.
"""

from __future__ import annotations

import ast
import dataclasses
import typing as t

from torch_actor_critic_tpu_torch.analysis.walker import FileContext

__all__ = [
    "NameEvent",
    "function_events",
    "tracked_key",
    "FlowScope",
]

# Statement types that terminate an arm: control never falls through
# to the statement after the enclosing if/try.
_TERMINATORS = (ast.Return, ast.Raise, ast.Continue, ast.Break)


def tracked_key(node: ast.AST) -> str | None:
    """The dataflow name of an expression we can track: a bare name
    (``buf``) or a depth-1 attribute (``self.state``, ``obj.buffer``).
    Deeper paths (``a.b.c``) are untracked — reads through them are
    views whose aliasing we cannot reason about conservatively."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        return f"{node.value.id}.{node.attr}"
    return None


@dataclasses.dataclass
class NameEvent:
    """One occurrence of a tracked name inside a function body."""

    key: str
    node: ast.AST          # the Name/Attribute occurrence
    stmt: ast.stmt         # enclosing statement (within the function)
    kind: str              # "store" | "load"
    closure: bool          # occurs inside a nested def/lambda


def _arm_of(stmts: t.Sequence[ast.stmt], node: ast.AST, parents) -> bool:
    """Is ``node`` (or an ancestor of it) one of ``stmts``?"""
    cur: ast.AST | None = node
    while cur is not None:
        if any(cur is s for s in stmts):
            return True
        cur = parents.get(cur)
    return False


def _arm_terminates(stmts: t.Sequence[ast.stmt]) -> bool:
    """Does this arm end without falling through?"""
    if not stmts:
        return False
    last = stmts[-1]
    if isinstance(last, _TERMINATORS):
        return True
    if isinstance(last, ast.If) and last.orelse:
        return _arm_terminates(last.body) and _arm_terminates(last.orelse)
    return False


class FlowScope:
    """Control-flow context for one function body.

    ``reaches(a, b)`` answers: can control flow from event/node ``a``
    to the *lexically later* event/node ``b`` in one pass through the
    function? False when they sit in mutually exclusive branch arms, or
    when every path from ``a`` terminates before ``b``'s position.
    """

    def __init__(self, ctx: FileContext, fn_node: ast.AST):
        self.ctx = ctx
        self.fn = fn_node
        self._parents = {}
        for parent in ast.walk(fn_node):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent

    # ------------------------------------------------------------ paths

    def _branch_path(
        self, node: ast.AST
    ) -> t.List[t.Tuple[ast.AST, str, t.Sequence[ast.stmt]]]:
        """(branch_node, arm_label, arm_stmts) for every enclosing
        if/try arm between ``node`` and the function root, outermost
        first."""
        out = []
        cur = self._parents.get(node)
        child = node
        while cur is not None and cur is not self.fn:
            if isinstance(cur, ast.If):
                if _arm_of(cur.body, child, self._parents):
                    out.append((cur, "body", cur.body))
                elif _arm_of(cur.orelse, child, self._parents):
                    out.append((cur, "orelse", cur.orelse))
            elif isinstance(cur, ast.Try):
                for label in ("body", "orelse", "finalbody"):
                    if _arm_of(getattr(cur, label), child, self._parents):
                        out.append((cur, label, getattr(cur, label)))
                        break
                else:
                    for h in cur.handlers:
                        if _arm_of(h.body, child, self._parents):
                            out.append((cur, f"handler:{id(h)}", h.body))
                            break
            child = cur
            cur = self._parents.get(cur)
        out.reverse()
        return out

    def statement_of(self, node: ast.AST) -> ast.stmt | None:
        cur: ast.AST | None = node
        while cur is not None and not isinstance(cur, ast.stmt):
            cur = self._parents.get(cur)
        return t.cast("ast.stmt | None", cur)

    def loops_enclosing(self, node: ast.AST) -> t.List[ast.AST]:
        """For/While loops between ``node`` and the function root,
        innermost first (``for``'s iter expression is evaluated once
        and is not part of the body)."""
        out = []
        cur = self._parents.get(node)
        child = node
        while cur is not None and cur is not self.fn:
            if isinstance(cur, (ast.For, ast.While)) and not (
                isinstance(cur, ast.For) and _arm_of(
                    [cur.iter], child, self._parents  # type: ignore[list-item]
                )
            ):
                out.append(cur)
            child = cur
            cur = self._parents.get(cur)
        return out

    # ---------------------------------------------------------- reaches

    def reaches(self, a: ast.AST, b: ast.AST) -> bool:
        """Can control pass from ``a`` to the lexically later ``b``?"""
        pa = self._branch_path(a)
        pb = self._branch_path(b)
        ib = {id(n): (arm, stmts) for n, arm, stmts in pb}
        for branch, arm, stmts in pa:
            hit = ib.get(id(branch))
            if hit is not None:
                if hit[0] != arm:
                    return False  # sibling arms: mutually exclusive
                continue
            # a's arm does not contain b: control must fall out of the
            # arm to reach b; a terminating arm never does. (A plain
            # `if` with a terminating body still reaches code after it
            # via the implicit else — but only for events NOT inside
            # the body, and a IS inside it.)
            if _arm_terminates(stmts):
                return False
        return True


def _in_closure(parents, fn_node: ast.AST, node: ast.AST) -> bool:
    cur = parents.get(node)
    while cur is not None and cur is not fn_node:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return True
        cur = parents.get(cur)
    return False


def function_events(
    scope: FlowScope, keys: t.Collection[str] | None = None
) -> t.List[NameEvent]:
    """Every bind/read of tracked names in the function, in lexical
    order. ``keys`` filters to a name set (None = all tracked names).
    Parameter bindings are emitted as stores at the ``def`` line."""
    fn = scope.fn
    events: t.List[NameEvent] = []
    args = getattr(fn, "args", None)
    if args is not None:
        all_args = (
            list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
            + ([args.vararg] if args.vararg else [])
            + ([args.kwarg] if args.kwarg else [])
        )
        for a in all_args:
            if keys is None or a.arg in keys:
                events.append(NameEvent(
                    a.arg, a, t.cast(ast.stmt, fn), "store", False
                ))
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute):
            if not isinstance(node.value, ast.Name):
                continue
            key = f"{node.value.id}.{node.attr}"
        elif isinstance(node, ast.Name):
            key = node.id
        else:
            continue
        if keys is not None and key not in keys:
            continue
        if isinstance(node, ast.Name):
            parent = scope._parents.get(node)
            if isinstance(parent, ast.Attribute) and parent.value is node:
                # `buffer.size` surfaces BOTH as the depth-1 attribute
                # event and as a LOAD of `buffer` — reading any
                # attribute of a tracked value reads the value (what
                # a dataflow rule must see). Skip only `self`
                # receivers (`self.x` is tracked as the attribute).
                if node.id == "self":
                    continue
                stmt = scope.statement_of(node)
                if stmt is None:
                    continue
                events.append(NameEvent(
                    key, node, stmt, "load",
                    _in_closure(scope._parents, fn, node),
                ))
                continue
        ctx_ = getattr(node, "ctx", None)
        kind = "store" if isinstance(ctx_, (ast.Store, ast.Del)) else "load"
        stmt = scope.statement_of(node)
        if stmt is None:
            continue
        events.append(NameEvent(
            key, node, stmt, kind,
            _in_closure(scope._parents, fn, node),
        ))
    # Within ONE statement, loads order before stores: Python evaluates
    # the RHS first, so `key, sub = split(key)` reads the old key and
    # THEN rebinds it — lexical column order would get that backwards.
    events.sort(key=lambda e: (
        getattr(e.stmt, "lineno", 0), getattr(e.stmt, "col_offset", 0),
        e.kind == "store",
        getattr(e.node, "lineno", 0), getattr(e.node, "col_offset", 0),
    ))
    return events
