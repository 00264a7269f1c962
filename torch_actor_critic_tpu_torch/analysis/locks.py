"""lock-discipline race detection for the threaded planes (a copy of the
JAX package's ``analysis/locks.py``).

The serving/decoupled planes (serve/batcher.py, serve/router.py,
serve/registry.py, serve/fleet.py, decoupled/staging.py) coordinate
threads through ``threading.Lock``/``Condition`` attributes. Lock
bugs are exactly the class a chaos smoke can't reliably reproduce —
so the discipline is declared in source and verified statically:

* Annotate a shared mutable attribute where it is initialized::

      self._queue = collections.deque()  # guarded-by: _lock

* Every later read/write of ``self._queue`` (outside ``__init__``
  statements, which run happens-before any thread start) must then be
  lexically inside ``with self._lock:`` (a ``Condition`` constructed
  over a lock counts as that lock; a bare ``Condition()`` is its own
  lock), or inside a **lock-holding method**: one whose name ends in
  ``_locked``, whose def-line carries ``# guarded-by: <lock>``, or
  whose docstring says ``Callers hold self.<lock>`` (the conventions
  this codebase already uses). Violations are
  ``unlocked-guarded-access``.
* In lock-owning classes, an *unannotated* attribute mutated from
  more than one method with at least one mutation outside any lock is
  ``unguarded-shared-attr`` — annotate it, or guard the stray write.
* ``unknown-guard`` — an annotation naming a lock the class never
  constructs is a typo that would silently verify nothing.

Known limitation: the checker reasons about
``self``-attribute access within the declaring class. Discipline on
foreign objects (``with slot.lock: slot.state = ...``) is out of
scope for the static pass and stays on the chaos smokes.
"""

from __future__ import annotations

import ast
import re
import typing as t

from torch_actor_critic_tpu_torch.analysis.reachability import Project
from torch_actor_critic_tpu_torch.analysis.walker import (
    FileContext,
    Finding,
    dotted_name,
)

__all__ = ["check"]

FAMILY = "lock-discipline"

_LOCK_CTORS = frozenset({
    "threading.Lock", "threading.RLock", "threading.Condition",
    "Lock", "RLock", "Condition",
})
_HOLDS_DOC_RE = re.compile(
    r"[Cc]allers?\s+hold(?:s)?\s+(?:``)?self\.([A-Za-z_][A-Za-z0-9_]*)"
)


class _ClassModel:
    def __init__(self, ctx: FileContext, node: ast.ClassDef):
        self.ctx = ctx
        self.node = node
        self.name = node.name
        # lock attr -> canonical lock attr (Condition(self._lock)
        # aliases _lock; a bare Condition() is its own canonical lock).
        self.locks: t.Dict[str, str] = {}
        # guarded attr -> canonical lock attr (from annotations).
        self.guarded: t.Dict[str, t.Tuple[str, int]] = {}
        self.methods: t.List[ast.FunctionDef] = [
            n for n in node.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        self.spawns_thread = any(
            isinstance(n, ast.Call)
            and (dotted_name(n.func) or "").endswith("Thread")
            for n in ast.walk(node)
        )
        self._collect_locks()
        self._collect_annotations()

    def owns(self, node: ast.AST) -> bool:
        """True when ``node``'s nearest enclosing class is this class —
        a nested ClassDef's ``self`` is NOT ours and is modeled
        separately."""
        for anc in self.ctx.ancestors(node):
            if isinstance(anc, ast.ClassDef):
                return anc is self.node
        return False  # pragma: no cover - we only walk our subtree

    def _self_assigns(self) -> t.Iterator[t.Tuple[str, ast.stmt]]:
        for node in ast.walk(self.node):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            if not self.owns(node):
                continue
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            for target in targets:
                name = dotted_name(target)
                if name and name.startswith("self.") and name.count(".") == 1:
                    yield name.split(".", 1)[1], node

    def _collect_locks(self):
        for attr, assign in self._self_assigns():
            v = assign.value
            if not isinstance(v, ast.Call):
                continue
            ctor = dotted_name(v.func)
            if ctor not in _LOCK_CTORS:
                continue
            canonical = attr
            if ctor.endswith("Condition") and v.args:
                inner = dotted_name(v.args[0])
                if inner and inner.startswith("self."):
                    canonical = inner.split(".", 1)[1]
            self.locks[attr] = canonical

    def _collect_annotations(self):
        for attr, assign in self._self_assigns():
            lock = self.ctx.guarded_by.get(assign.lineno)
            if lock is None and assign.end_lineno != assign.lineno:
                lock = self.ctx.guarded_by.get(assign.end_lineno or 0)
            if lock is None:
                continue
            self.guarded[attr] = (lock, assign.lineno)

    def canonical(self, lock: str) -> str:
        return self.locks.get(lock, lock)

    def holds(self, fn: ast.AST) -> t.Set[str]:
        """Canonical locks a method/function declares it is called
        under (name suffix, def-line annotation, docstring convention)."""
        out: t.Set[str] = set()
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return out
        if fn.name.endswith("_locked") and "_lock" in self.locks:
            out.add(self.canonical("_lock"))
        first_body_line = fn.body[0].lineno if fn.body else fn.lineno + 1
        for line in range(fn.lineno, first_body_line + 1):
            lock = self.ctx.guarded_by.get(line)
            if lock is not None:
                out.add(self.canonical(lock))
        doc = ast.get_docstring(fn)
        if doc:
            for m in _HOLDS_DOC_RE.finditer(doc):
                out.add(self.canonical(m.group(1)))
        return out


def _with_locks(ctx: FileContext, model: _ClassModel, node: ast.AST) -> t.Set[str]:
    """Canonical locks held lexically at ``node`` via enclosing
    ``with self.<lock>:`` blocks and lock-holding enclosing functions."""
    held: t.Set[str] = set()
    for anc in ctx.ancestors(node):
        if isinstance(anc, ast.With):
            for item in anc.items:
                name = dotted_name(item.context_expr)
                if name and name.startswith("self."):
                    attr = name.split(".", 1)[1]
                    if attr in model.locks:
                        held.add(model.canonical(attr))
        elif isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            held.update(model.holds(anc))
        elif isinstance(anc, ast.ClassDef):
            break
    return held


def _innermost_fn(ctx: FileContext, node: ast.AST) -> ast.AST | None:
    return ctx.enclosing_function(node)


def _method_of(model: _ClassModel, ctx: FileContext, node: ast.AST) -> str | None:
    """Name of the class-level method whose subtree contains node."""
    last = None
    for anc in ctx.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            last = anc
        elif isinstance(anc, ast.ClassDef):
            return last.name if (last is not None and last in model.node.body) else None
    return None


def check(project: Project) -> t.List[Finding]:
    findings: t.List[Finding] = []
    for ctx in project.files:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                _check_class(ctx, _ClassModel(ctx, node), findings)
    return findings


def _check_class(ctx: FileContext, model: _ClassModel, findings: t.List[Finding]):
    if not model.locks:
        # guarded-by annotations without any lock in the class are
        # reported; otherwise nothing to verify here.
        for attr, (lock, line) in model.guarded.items():
            findings.append(Finding(
                "unknown-guard", ctx.path, line, 0,
                f"{model.name}.{attr} declares guarded-by: {lock} but the "
                "class constructs no threading.Lock/RLock/Condition",
                "construct the lock, or drop the stale annotation",
            ))
        return

    canonical_locks = set(model.locks.values()) | set(model.locks)
    for attr, (lock, line) in model.guarded.items():
        if lock not in canonical_locks:
            findings.append(Finding(
                "unknown-guard", ctx.path, line, 0,
                f"{model.name}.{attr} declares guarded-by: {lock} but the "
                f"class only constructs {sorted(model.locks)}",
                "fix the annotation to name a real lock attribute",
            ))

    # -------------------------------------------- annotated-attr accesses
    mutations: t.Dict[str, t.Dict[str, t.List[t.Tuple[ast.AST, bool]]]] = {}
    for node in ast.walk(model.node):
        attr_node: ast.Attribute | None = None
        if isinstance(node, ast.Attribute):
            attr_node = node
        if attr_node is None or not model.owns(attr_node):
            continue
        name = dotted_name(attr_node)
        if not name or not name.startswith("self.") or name.count(".") != 1:
            continue
        attr = name.split(".", 1)[1]
        if attr in model.locks:
            continue
        fn = _innermost_fn(ctx, attr_node)
        in_init_body = (
            isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
            and fn.name == "__init__"
            and fn in model.node.body
        )
        is_store = isinstance(attr_node.ctx, (ast.Store, ast.Del))
        held = _with_locks(ctx, model, attr_node)

        if attr in model.guarded:
            lock, _ = model.guarded[attr]
            want = model.canonical(lock)
            if in_init_body:
                continue  # construction happens-before thread start
            if want not in held:
                access = "write of" if is_store else "read of"
                findings.append(Finding(
                    "unlocked-guarded-access", ctx.path,
                    attr_node.lineno, attr_node.col_offset,
                    f"{access} {model.name}.{attr} (guarded-by: {lock}) "
                    f"outside `with self.{lock}`",
                    f"take the lock, or mark the enclosing method "
                    f"lock-holding (`# guarded-by: {lock}` on the def "
                    "line / a 'Callers hold self."
                    f"{lock}' docstring) if every caller already holds it",
                ))
        elif is_store and not in_init_body:
            meth = _method_of(model, ctx, attr_node)
            if meth is not None and meth != "__init__":
                mutations.setdefault(attr, {}).setdefault(meth, []).append(
                    (attr_node, bool(held))
                )

    # ----------------------------------------------- unannotated shared
    for attr, by_method in sorted(mutations.items()):
        if len(by_method) < 2:
            continue
        unlocked = [
            node
            for sites in by_method.values()
            for node, held in sites
            if not held
        ]
        if not unlocked:
            continue  # every write is already lock-protected; the
            # annotation sweep picks these up, the rule stays quiet
        node = min(unlocked, key=lambda n: n.lineno)
        findings.append(Finding(
            "unguarded-shared-attr", ctx.path, node.lineno, node.col_offset,
            f"{model.name}.{attr} is mutated from "
            f"{len(by_method)} methods ({', '.join(sorted(by_method))}) "
            "with at least one write outside any lock, and carries no "
            "guarded-by annotation",
            "annotate the attribute (`# guarded-by: <lock>`) where it is "
            "initialized and guard every access, or confine mutation to "
            "one thread",
        ))
