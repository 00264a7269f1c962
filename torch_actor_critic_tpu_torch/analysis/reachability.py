"""Captured-code reachability: which functions run inside a CUDA graph
capture (the port's counterpart of the JAX package's traced-code
reachability, ``analysis/reachability.py``).

The capture-hygiene family only makes sense inside code that a graph
records: host code is free to call ``time.perf_counter`` or ``.item()``,
but inside a capture such a call either syncs the device mid-capture
(an error) or is recorded once and never again (a stale value). This
module computes the captured set:

* **Capture sites** — a ``with torch.cuda.graph(...)`` block (its body
  is captured), a ``torch.cuda.make_graphed_callables`` call, and a
  ``BurstGraph(step_fn, ...)`` construction (``sac/graph.py``: the
  step function is captured). The ``torch.cuda.graph`` inside
  ``BurstGraph._capture`` is the mechanism behind every ``BurstGraph``
  and not a site of its own (:data:`CAPTURE_MECHANISMS`).
* **Roots** — the functions a site hands to the capture (a lambda, a
  local ``def``, ``self._step_fn``) and every call in a captured
  ``with`` body.
* **Seeds** — the sites are keyed by the watchdog source each one
  reports (``serve/forward``, ``train/burst``, ``train/acting``,
  ``train/offline_burst``) in :data:`ENTRY_POINTS`, and the pass checks
  the table both ways (``stale-entry-point``): every row names a
  function that still holds a capture site, and every capture site in
  the package is in the table — a new capture cannot ship unchecked.
* **Closure** — call edges out of captured functions: plain local
  calls, ``self.method``, package-internal ``module.func`` via the
  import table, and a bounded last-resort heuristic for ``obj.method``
  calls (every package class defining that method, when at most 5 do
  and the candidate contains no overt host-side constructs).
"""

from __future__ import annotations

import ast
import typing as t

from torch_actor_critic_tpu_torch.analysis.walker import (
    FileContext,
    Finding,
    FunctionInfo,
    dotted_name,
)

__all__ = ["Project", "ENTRY_POINTS", "CAPTURE_MECHANISMS", "capture_sites"]

PACKAGE = "torch_actor_critic_tpu_torch"

# Calls whose extent is captured: the with-block context manager and
# the helper that graphs callables.
GRAPH_CONTEXTS: t.FrozenSet[str] = frozenset({"torch.cuda.graph", "cuda.graph"})
GRAPH_CALLABLES: t.FrozenSet[str] = frozenset({
    "torch.cuda.make_graphed_callables", "cuda.make_graphed_callables",
})
# The port's capturing constructor: its first argument (``step_fn``) is
# recorded by the graph.
BURST_GRAPHS: t.FrozenSet[str] = frozenset({"BurstGraph", "graph.BurstGraph"})
# Constructors of a graph object (the capture-in-loop rule).
GRAPH_OBJECTS: t.FrozenSet[str] = frozenset({
    "torch.cuda.CUDAGraph", "cuda.CUDAGraph", "CUDAGraph",
}) | BURST_GRAPHS

# (path suffix, qualname) of functions that implement capture on behalf
# of the sites that call them: their own torch.cuda.graph is not a site.
CAPTURE_MECHANISMS: t.FrozenSet[t.Tuple[str, str]] = frozenset({
    ("sac/graph.py", "BurstGraph._capture"),
})

# Watchdog source of each capture site -> (path suffix, qualname of the
# function holding the site). Checked both ways every run
# (stale-entry-point).
ENTRY_POINTS: t.Dict[str, t.Tuple[str, str]] = {
    "serve/forward": ("serve/engine.py", "PolicyEngine._capture"),
    # SAC's and TD3's update burst (TD3 inherits Learner.update_burst),
    # and a host population's member-stacked burst.
    "train/burst": ("sac/algorithm.py", "Learner.update_burst"),
    "train/acting": ("sac/ondevice.py", "OnDeviceLoop._collect"),
    "train/offline_burst": ("replay/offline.py", "OfflineLearner.burst"),
}

# Method names too generic for the cross-class fallback resolution.
_NOISE_METHODS = frozenset({
    "append", "extend", "get", "pop", "popleft", "items", "keys",
    "values", "update", "copy", "clear", "add", "remove", "join",
    "read", "write", "close", "record", "result", "put", "send",
    "recv", "start", "stop", "item", "mean", "max", "min", "sum",
    "reshape", "astype", "replace", "apply", "init", "split", "view",
    "snapshot", "format",
})

# Calls that mark a function as overtly host-side; a low-confidence
# (heuristic) edge into such a function is dropped.
_HOST_MARKERS = frozenset({
    "time.perf_counter", "time.time", "time.monotonic", "time.sleep",
    "print", "open", "get_watchdog", "logger.info", "logger.warning",
    "logger.debug", "logger.error", "torch.cuda.synchronize",
    "torch.cuda.graph", "torch.cuda.CUDAGraph", "BurstGraph",
    "threading.Thread", "subprocess.Popen",
})


def _call_names(node: ast.AST) -> t.Set[str]:
    out: t.Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            name = dotted_name(sub.func)
            if name:
                out.add(name)
    return out


def _is_wrapper(name: str | None, table: t.FrozenSet[str]) -> bool:
    if not name:
        return False
    if name in table:
        return True
    parts = name.split(".")
    return len(parts) >= 2 and ".".join(parts[-2:]) in table


class _ModuleIndex:
    """Per-file resolution tables."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.by_qualname: t.Dict[str, FunctionInfo] = {
            f.qualname: f for f in ctx.functions
        }
        self.by_last: t.Dict[str, t.List[FunctionInfo]] = {}
        for f in ctx.functions:
            self.by_last.setdefault(f.qualname.rsplit(".", 1)[-1], []).append(f)
        self.qual_of: t.Dict[ast.AST, str] = {
            f.node: f.qualname for f in ctx.functions
        }
        # alias -> package-internal module path ("a/b.py"), and
        # imported symbol -> (module path, symbol name).
        self.module_aliases: t.Dict[str, str] = {}
        self.symbol_imports: t.Dict[str, t.Tuple[str, str]] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.startswith(PACKAGE):
                        bound = alias.asname or alias.name.split(".")[0]
                        self.module_aliases[bound] = alias.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                if not node.module.startswith(PACKAGE):
                    continue
                for alias in node.names:
                    full = f"{node.module}.{alias.name}"
                    bound = alias.asname or alias.name
                    # `from pkg.x import y` binds y as either module
                    # pkg/x/y.py or symbol y in pkg/x.py; record both
                    # candidates, resolution tries module first.
                    self.module_aliases.setdefault(bound, full)
                    self.symbol_imports[bound] = (node.module, alias.name)


class Project:
    """All parsed files plus the project-level captured-set analysis."""

    def __init__(self, files: t.Sequence[FileContext]):
        self.files = list(files)
        self.by_path: t.Dict[str, FileContext] = {f.path: f for f in self.files}
        self.indexes: t.Dict[str, _ModuleIndex] = {
            f.path: _ModuleIndex(f) for f in self.files
        }
        # module dotted name -> path, for import resolution.
        self.module_paths: t.Dict[str, str] = {}
        for path in self.by_path:
            # Dotted from the package root, however the path was given
            # (relative from the repo root, or absolute).
            parts = path[:-3].split("/")
            if PACKAGE in parts:
                parts = parts[len(parts) - 1 - parts[::-1].index(PACKAGE):]
            mod = ".".join(parts)
            if mod.endswith(".__init__"):
                mod = mod[: -len(".__init__")]
            self.module_paths[mod] = path
        self.method_index: t.Dict[str, t.List[t.Tuple[str, FunctionInfo]]] = {}
        for path, ctx in self.by_path.items():
            for f in ctx.functions:
                if f.class_name and f.qualname == f"{f.class_name}.{f.node.name}":
                    self.method_index.setdefault(f.node.name, []).append(
                        (path, f)
                    )
        # class name -> names of its direct bases (by their last dotted part)
        self.class_bases: t.Dict[str, t.Set[str]] = {}
        for ctx in self.files:
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.ClassDef):
                    self.class_bases.setdefault(node.name, set()).update(
                        (dotted_name(b) or "").rsplit(".", 1)[-1] for b in node.bases
                    )
        self._captured: t.Dict[t.Tuple[str, str], FunctionInfo] | None = None
        self._sites: t.List[CaptureSite] | None = None

    # --------------------------------------------------------------- roots

    def _resolve_plain(
        self, path: str, site: ast.AST, name: str
    ) -> t.List[t.Tuple[str, FunctionInfo]]:
        """Scope-aware resolution of a bare-name function reference:
        a sibling/enclosing-scope nested def wins over module level;
        class methods never match a bare name (they need ``self.``);
        a ``from pkg.x import f`` symbol resolves cross-module."""
        idx = self.indexes[path]
        ctx = self.by_path[path]
        cands = idx.by_last.get(name, [])
        enclosing: t.List[str] = []
        for anc in ctx.ancestors(site):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = idx.qual_of.get(anc)
                if q:
                    enclosing.append(q)
        for q in enclosing:
            hits = [f for f in cands if f.qualname == f"{q}.{name}"]
            if hits:
                return [(path, f) for f in hits]
        hits = [f for f in cands if f.qualname == name]
        if hits:
            return [(path, f) for f in hits]
        sym = idx.symbol_imports.get(name)
        if sym is not None:
            mod, symbol = sym
            target = self.module_paths.get(f"{mod}.{symbol}")
            if target is None:
                target = self.module_paths.get(mod)
                if target is not None:
                    tf = self.indexes[target].by_qualname.get(symbol)
                    if tf is not None:
                        return [(target, tf)]
            return []
        return []

    def _function_for_arg(
        self, path: str, arg: ast.AST, site: ast.AST | None = None
    ) -> t.List[t.Tuple[str, FunctionInfo]]:
        """Resolve a wrapper's function-valued argument."""
        if isinstance(arg, ast.Call):
            name = dotted_name(arg.func)
            if name and name.rsplit(".", 1)[-1] in ("partial", "wraps"):
                if arg.args:
                    return self._function_for_arg(path, arg.args[0], site)
            return []
        name = dotted_name(arg)
        if name is None:
            return []
        if "." not in name:
            return self._resolve_plain(path, site if site is not None else arg, name)
        if name.startswith("self."):
            meth = name.split(".", 1)[1]
            return self._resolve_self(path, arg, meth)
        return self._resolve_dotted(path, name)

    def _resolve_dotted(
        self, path: str, name: str
    ) -> t.List[t.Tuple[str, FunctionInfo]]:
        """``alias.f`` / ``alias.sub.f`` / ``ClassName.m`` through the
        file's import table and class index."""
        idx = self.indexes[path]
        parts = name.split(".")
        hit = idx.by_qualname.get(name)
        if hit is not None:
            return [(path, hit)]
        head, meth = parts[0], parts[-1]
        mod = idx.module_aliases.get(head)
        if mod is not None:
            dotted = ".".join([mod] + parts[1:-1])
            target = self.module_paths.get(dotted)
            if target is not None:
                tf = self.indexes[target].by_qualname.get(meth)
                if tf is not None:
                    return [(target, tf)]
        if head in idx.symbol_imports and len(parts) == 2:
            mod_name, sym = idx.symbol_imports[head]
            target = self.module_paths.get(f"{mod_name}.{sym}")
            if target is not None:
                tf = self.indexes[target].by_qualname.get(meth)
                if tf is not None:
                    return [(target, tf)]
        return []

    def _sites_in_file(self, path: str) -> t.List["CaptureSite"]:
        ctx = self.by_path[path]
        mechanism = any(
            path.endswith(suffix) for suffix, _ in CAPTURE_MECHANISMS
        )
        sites: t.List[CaptureSite] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func)
            fn = ctx.enclosing_function(node)
            qual = next(
                (f.qualname for f in ctx.functions if f.node is fn), "<module>"
            )
            if mechanism and (
                any(path.endswith(s) and qual == q for s, q in CAPTURE_MECHANISMS)
            ):
                continue
            roots: t.List[t.Tuple[str, FunctionInfo]] = []
            if _is_wrapper(callee, GRAPH_CONTEXTS):
                with_node = ctx.parent(ctx.parent(node))
                if not (
                    isinstance(with_node, ast.With)
                    and any(i.context_expr is node for i in with_node.items)
                ):
                    continue
                cls = next(
                    (a.name for a in ctx.ancestors(node)
                     if isinstance(a, ast.ClassDef)), None,
                )
                # The with body is captured: a synthetic function over it.
                roots.append((path, FunctionInfo(
                    f"<capture:{with_node.lineno}>", with_node, cls,
                )))
                kind = "graph"
            elif _is_wrapper(callee, GRAPH_CALLABLES) or _is_wrapper(
                callee, BURST_GRAPHS
            ):
                cands = list(node.args[:1]) + [
                    k.value for k in node.keywords
                    if k.arg in ("step_fn", "callables")
                ]
                for arg in cands:
                    if isinstance(arg, ast.Lambda):
                        roots.append((path, FunctionInfo(
                            f"<lambda:{arg.lineno}>", arg, None
                        )))
                    else:
                        roots.extend(self._function_for_arg(path, arg, node))
                kind = "burst" if _is_wrapper(callee, BURST_GRAPHS) else "callables"
            else:
                continue
            sites.append(CaptureSite(path, qual, node, kind, roots))
        return sites

    def capture_sites(self) -> t.List["CaptureSite"]:
        """Every capture site in the linted files (module docstring)."""
        if self._sites is None:
            self._sites = [
                site for path in self.by_path for site in self._sites_in_file(path)
            ]
        return self._sites

    # ------------------------------------------------------------ resolve

    def _resolve_self(
        self, path: str, node: ast.AST, meth: str
    ) -> t.List[t.Tuple[str, FunctionInfo]]:
        return self._resolve_self2(path, node, meth)[0]

    def _resolve_self2(
        self, path: str, node: ast.AST, meth: str
    ) -> t.Tuple[t.List[t.Tuple[str, FunctionInfo]], bool]:
        """Resolve ``self.meth``; the bool says whether the hit is
        exact (own class) or a cross-class heuristic fallback."""
        ctx = self.by_path[path]
        cls = None
        for anc in ctx.ancestors(node):
            if isinstance(anc, ast.ClassDef):
                cls = anc.name
                break
        if cls is not None:
            hit = self.indexes[path].by_qualname.get(f"{cls}.{meth}")
            if hit is not None:
                return [(path, hit)], True
        return self._resolve_heuristic(meth), False

    def _subclasses(self, cls: str) -> t.Set[str]:
        out: t.Set[str] = set()
        todo = [cls]
        while todo:
            base = todo.pop()
            for name, bases in self.class_bases.items():
                if base in bases and name not in out:
                    out.add(name)
                    todo.append(name)
        return out

    def _overrides(
        self, path: str, node: ast.AST, meth: str
    ) -> t.List[t.Tuple[str, FunctionInfo]]:
        """``self.meth`` at ``node``: the enclosing class's own method and
        every subclass's override of it."""
        cls = next(
            (a.name for a in self.by_path[path].ancestors(node)
             if isinstance(a, ast.ClassDef)), None,
        )
        if cls is None:
            return []
        classes = {cls} | self._subclasses(cls)
        return [
            (p, f) for p, f in self.method_index.get(meth, [])
            if f.class_name in classes
        ]

    @staticmethod
    def _looks_host_side(fn: FunctionInfo) -> bool:
        """Overtly host-side: captures graphs or builds them (directly
        or via a ``_build*`` helper), takes wall-clock readings,
        synchronizes, logs. Used to prune LOW-CONFIDENCE (heuristic)
        reachability — exact edges are never pruned."""
        names = _call_names(fn.node)
        if names & _HOST_MARKERS:
            return True
        return any(
            n.rsplit(".", 1)[-1].startswith("_build") for n in names
        )

    def _resolve_heuristic(
        self, meth: str
    ) -> t.List[t.Tuple[str, FunctionInfo]]:
        if meth.startswith("__") or meth in _NOISE_METHODS:
            return []
        cands = self.method_index.get(meth, [])
        if not 1 <= len(cands) <= 5:
            return []
        return [
            (path, f) for path, f in cands if not self._looks_host_side(f)
        ]

    def _callees(
        self, path: str, fn: FunctionInfo
    ) -> t.Tuple[
        t.List[t.Tuple[str, FunctionInfo]],
        t.List[t.Tuple[str, FunctionInfo]],
    ]:
        """(exact_edges, heuristic_edges) out of ``fn``."""
        exact: t.List[t.Tuple[str, FunctionInfo]] = []
        heur: t.List[t.Tuple[str, FunctionInfo]] = []
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            # A method handed on as an argument (`update_step(self.update,
            # ...)`) runs in the capture too: the own class's, and every
            # subclass's override.
            for arg in list(node.args) + [k.value for k in node.keywords]:
                ref = dotted_name(arg)
                if ref is None or not (ref.startswith("self.") and ref.count(".") == 1):
                    continue
                exact.extend(self._overrides(path, arg, ref[5:]))
            name = dotted_name(node.func)
            if name is None or _is_wrapper(name, GRAPH_CONTEXTS | GRAPH_OBJECTS):
                continue
            if "." not in name:
                exact.extend(self._resolve_plain(path, node, name))
                continue
            parts = name.split(".")
            if parts[0] == "self" and len(parts) == 2:
                hits, confident = self._resolve_self2(path, node, parts[1])
                (exact if confident else heur).extend(hits)
                continue
            resolved = self._resolve_dotted(path, name)
            if resolved:
                exact.extend(resolved)
                continue
            heur.extend(self._resolve_heuristic(parts[-1]))
        return exact, heur

    # ------------------------------------------------------------ captured

    def captured(self) -> t.Dict[t.Tuple[str, str], FunctionInfo]:
        """(path, qualname) -> FunctionInfo for every captured function.

        Two-tier closure: exact edges (same-scope names, own-class
        ``self.method``, import-resolved ``module.func``) propagate
        unconditionally from the capture roots; heuristic (cross-class
        method-name) edges only admit functions that don't look
        host-side, and everything downstream of a heuristic edge stays
        under that filter — one low-confidence hop must not taint a
        whole host subsystem as captured."""
        if self._captured is not None:
            return self._captured
        seen: t.Dict[t.Tuple[str, str], FunctionInfo] = {}
        confident: t.Set[t.Tuple[str, str]] = set()
        work: t.List[t.Tuple[str, FunctionInfo, bool]] = []
        for site in self.capture_sites():
            work.extend((p, f, True) for p, f in site.roots)
        while work:
            path, fn, exact = work.pop()
            key = (path, fn.qualname)
            if key in seen and (not exact or key in confident):
                continue
            if not exact and self._looks_host_side(fn):
                continue
            seen[key] = fn
            if exact:
                confident.add(key)
            exact_edges, heur_edges = self._callees(path, fn)
            work.extend((p, f, exact) for p, f in exact_edges)
            work.extend((p, f, False) for p, f in heur_edges)
        self._captured = seen
        return seen


    # --------------------------------------------------------- entry seeds

    def entry_point_findings(self) -> t.List[Finding]:
        """``stale-entry-point``, both ways: every :data:`ENTRY_POINTS`
        row names an existing function that still holds a capture site,
        and every capture site in the package is some row's. Whole-package
        runs only (a fixture cannot tell a renamed site from an un-linted
        one)."""
        out: t.List[Finding] = []
        if not any(
            p.endswith(f"{PACKAGE}/__init__.py") for p in self.by_path
        ):
            return out
        sites = self.capture_sites()
        for identity, (suffix, qualname) in ENTRY_POINTS.items():
            path = next((p for p in self.by_path if p.endswith(suffix)), None)
            if path is None:
                out.append(Finding(
                    "stale-entry-point", suffix, 1, 0,
                    f"capture site {identity!r}: file {suffix!r} not found",
                    "update analysis/reachability.py ENTRY_POINTS",
                ))
                continue
            fn = next(
                (f for f in self.by_path[path].functions if f.qualname == qualname),
                None,
            )
            if fn is None:
                out.append(Finding(
                    "stale-entry-point", path, 1, 0,
                    f"capture site {identity!r}: function {qualname!r} no "
                    "longer exists",
                    "update analysis/reachability.py ENTRY_POINTS to the "
                    "renamed function",
                ))
                continue
            if not any(s.path == path and s.qualname == qualname for s in sites):
                out.append(Finding(
                    "stale-entry-point", path, fn.node.lineno, 0,
                    f"capture site {identity!r}: {qualname!r} no longer "
                    "captures a graph (torch.cuda.graph or BurstGraph)",
                    "update ENTRY_POINTS, or restore the capture",
                ))
        known = {(suffix, q) for suffix, q in ENTRY_POINTS.values()}
        for site in sites:
            if not any(
                site.path.endswith(suffix) and site.qualname == q
                for suffix, q in known
            ):
                out.append(Finding(
                    "stale-entry-point", site.path, site.node.lineno,
                    site.node.col_offset,
                    f"capture site in {site.qualname!r} is in no "
                    "ENTRY_POINTS row: its captured code is linted but its "
                    "watchdog source and contract are unchecked",
                    "add the site to analysis/reachability.py ENTRY_POINTS "
                    "and its row to analysis/contracts.py",
                ))
        return out


class CaptureSite(t.NamedTuple):
    """One capture: where (file, enclosing function, the call), its kind
    (``graph``: a with-block; ``burst``: a ``BurstGraph``;
    ``callables``: ``make_graphed_callables``) and its roots."""

    path: str
    qualname: str
    node: ast.Call
    kind: str
    roots: t.List[t.Tuple[str, FunctionInfo]]
