"""capture-hygiene rules: host-side constructs in code a CUDA graph
records, and graphs that are rebuilt or fed the wrong way.

The port's counterpart of the JAX package's ``jit_hygiene.py``,
``recompile.py`` and ``donation.py``: a CUDA graph is the port's
compiled program. Inside a function reachable from a capture site
(:mod:`~torch_actor_critic_tpu_torch.analysis.reachability`):

* ``host-sync-in-capture`` — ``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()``, ``torch.cuda.synchronize`` and ``bool``/``float``/``int``
  of a tensor expression (a call or a subscript of a value derived from
  the function's parameters): a device sync is illegal while a stream
  captures, and eagerly it holds the host every step.
* ``wallclock-in-capture`` — ``time.*``/``datetime.now``: read once at
  capture and never again by the replays.
* ``global-random-in-capture`` — a draw without ``generator=`` (or from
  ``random``/``np.random``): the replays would draw from a state the
  graph does not own. Draws name the registered generator.

And at the capture sites themselves:

* ``capture-in-loop`` — a graph (``torch.cuda.graph``, ``CUDAGraph()``,
  ``BurstGraph(...)``) constructed in a loop body: a capture per step,
  the counterpart of a jit built per step.
* ``rebind-under-graph`` — a tensor a live graph reads (a ``self``
  attribute its captured code reads) rebound with ``self.x = ...``
  outside ``__init__`` instead of updated in place with ``copy_``: the
  graph keeps reading the old storage. A first fill under ``if self.x
  is None`` is fine (nothing captured reads it yet). The counterpart of
  reusing a donated buffer.
* ``stale-entry-point`` — the capture-site table checked both ways
  (:meth:`~.reachability.Project.entry_point_findings`).
"""

from __future__ import annotations

import ast
import typing as t

from torch_actor_critic_tpu_torch.analysis.dataflow import FlowScope, function_events
from torch_actor_critic_tpu_torch.analysis.reachability import (
    GRAPH_CALLABLES,
    GRAPH_CONTEXTS,
    GRAPH_OBJECTS,
    Project,
    _is_wrapper,
)
from torch_actor_critic_tpu_torch.analysis.walker import (
    FileContext,
    Finding,
    dotted_name,
)

__all__ = ["check", "draw_without_generator", "host_random_call"]

FAMILY = "capture-hygiene"

_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_SYNC_CALLS = frozenset({"torch.cuda.synchronize", "cuda.synchronize"})
_CAST_BUILTINS = frozenset({"float", "int", "bool"})
_WALLCLOCK = frozenset({
    "time.time", "time.perf_counter", "time.monotonic", "time.sleep",
    "time.process_time", "time.time_ns", "time.perf_counter_ns",
    "datetime.now", "datetime.utcnow", "datetime.datetime.now",
    "datetime.datetime.utcnow",
})
# torch draws and in-place tensor draws that take ``generator=``.
_TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like",
})
_INPLACE_DRAWS = frozenset({
    "uniform_", "normal_", "random_", "exponential_", "bernoulli_",
    "geometric_", "cauchy_", "log_normal_",
})
# np.random / random attributes that construct explicit state, not draws.
_STATEFUL_CTORS = frozenset({
    "default_rng", "Generator", "SeedSequence", "PCG64", "Philox",
    "RandomState", "Random", "SystemRandom", "BitGenerator",
})
_STATIC_ATTRS = frozenset({"shape", "dtype", "ndim", "device", "is_cuda", "requires_grad"})


def draw_without_generator(node: ast.Call) -> str | None:
    """The draw's spelling when ``node`` is a torch draw without
    ``generator=`` (``torch.rand(...)``, ``x.normal_()``), else None."""
    if any(k.arg == "generator" for k in node.keywords):
        return None
    name = dotted_name(node.func) or ""
    parts = name.split(".")
    if len(parts) == 2 and parts[0] == "torch" and parts[1] in _TORCH_DRAWS:
        return name
    if isinstance(node.func, ast.Attribute) and node.func.attr in _INPLACE_DRAWS:
        return f".{node.func.attr}()"
    return None


def host_random_call(node: ast.Call) -> str | None:
    """``random.<draw>``/``np.random.<draw>`` on the global state, else
    None (an explicit ``default_rng(seed)`` and the like are fine)."""
    name = dotted_name(node.func) or ""
    parts = name.split(".")
    if parts[-1] in _STATEFUL_CTORS:
        return None
    if parts[0] == "random" and len(parts) == 2:
        return name
    if len(parts) == 3 and parts[0] in ("np", "numpy") and parts[1] == "random":
        return name
    return None


def _params(fn_node: ast.AST) -> t.Set[str]:
    args = getattr(fn_node, "args", None)
    if not isinstance(args, ast.arguments):
        return set()
    names = {a.arg for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]}
    names.update(a.arg for a in (args.vararg, args.kwarg) if a is not None)
    return names - {"self", "cls"}


def _reads(node: ast.AST, names: t.Set[str]) -> bool:
    if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
        return False
    if isinstance(node, ast.Name):
        return node.id in names
    return any(_reads(c, names) for c in ast.iter_child_nodes(node))


def _tensor_expr(node: ast.AST, tainted: t.Set[str]) -> bool:
    """A call or subscript over a parameter-derived value (a bare name
    may be a Python flag, as ``bool(deterministic)`` is)."""
    return isinstance(node, (ast.Call, ast.Subscript, ast.Compare)) and _reads(node, tainted)


def _tainted(fn_node: ast.AST) -> t.Set[str]:
    tainted = _params(fn_node)
    for _ in range(2):
        for node in ast.walk(fn_node):
            if isinstance(node, ast.Assign) and _reads(node.value, tainted):
                for target in node.targets:
                    tainted.update(n.id for n in ast.walk(target) if isinstance(n, ast.Name))
    return tainted


def _check_captured(project: Project, findings: t.List[Finding]) -> None:
    for (path, qualname), info in project.captured().items():
        ctx = project.by_path[path]
        tainted = _tainted(info.node)
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func) or ""
            where = f"captured code ({qualname})"
            if isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_METHODS \
                    and not node.args:
                findings.append(Finding(
                    "host-sync-in-capture", ctx.path, node.lineno, node.col_offset,
                    f".{node.func.attr}() in {where}: a device-to-host sync while the "
                    "stream captures",
                    "keep the value on the device (a tensor the graph writes, read "
                    "once after the replay)",
                ))
            elif name in _SYNC_CALLS or (
                name in _CAST_BUILTINS and node.args and _tensor_expr(node.args[0], tainted)
            ):
                findings.append(Finding(
                    "host-sync-in-capture", ctx.path, node.lineno, node.col_offset,
                    f"{name}(...) in {where}: a device sync while the stream captures",
                    "keep the value on the device; select with torch.where",
                ))
            elif name in _WALLCLOCK:
                findings.append(Finding(
                    "wallclock-in-capture", ctx.path, node.lineno, node.col_offset,
                    f"{name}() in {where}: read once at capture, never by a replay",
                    "time the replay from the host, around graph.replay()",
                ))
            else:
                draw = draw_without_generator(node) or host_random_call(node)
                if draw is not None:
                    findings.append(Finding(
                        "global-random-in-capture", ctx.path, node.lineno, node.col_offset,
                        f"{draw} in {where} draws from a state the graph does not own",
                        "pass generator= a torch.Generator the graph registers",
                    ))


def _check_loops(ctx: FileContext, findings: t.List[Finding]) -> None:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        if not (_is_wrapper(name, GRAPH_OBJECTS) or _is_wrapper(name, GRAPH_CONTEXTS)
                or _is_wrapper(name, GRAPH_CALLABLES)):
            continue
        for anc in ctx.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                break
            if isinstance(anc, (ast.For, ast.While)) and not (
                isinstance(anc, ast.For) and any(n is node for n in ast.walk(anc.iter))
            ):
                findings.append(Finding(
                    "capture-in-loop", ctx.path, node.lineno, node.col_offset,
                    f"{name} constructed in a loop body: a capture per iteration",
                    "capture once outside the loop (keyed on what it reads) and "
                    "replay inside it",
                ))
                break


def _self_attr(node: ast.AST) -> str | None:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _data_reads(node: ast.AST, parents: t.Mapping[ast.AST, ast.AST]) -> t.Set[str]:
    """``self.x`` loads under ``node`` that are not the callee of a call
    (``self.method(...)`` reads code, not a tensor)."""
    out = set()
    for sub in ast.walk(node):
        attr = _self_attr(sub)
        if attr is None or not isinstance(sub.ctx, ast.Load):
            continue
        parent = parents.get(sub)
        if isinstance(parent, ast.Call) and parent.func is sub:
            continue
        if isinstance(parent, ast.Attribute):  # self.x.y: x is read too
            grand = parents.get(parent)
            if isinstance(grand, ast.Call) and grand.func is parent:
                continue  # self.cost.scope(): a helper object, not a tensor
        out.add(attr)
    return out


def _graph_reads(project: Project, site, cls: ast.ClassDef) -> t.Set[str]:
    """The ``self`` attributes a site's captured code reads: in the
    captured with-body or the constructor's arguments, through the
    function's local aliases of them, and in captured methods of the
    same class."""
    ctx = project.by_path[site.path]
    fn = next((f.node for f in ctx.functions if f.qualname == site.qualname), None)
    if fn is None:
        return set()
    scope = FlowScope(ctx, fn)
    parents = scope._parents
    if site.kind == "graph":
        body = ctx.parent(ctx.parent(site.node))
        captured = list(body.body)
    else:
        captured = [site.node]
    reads: t.Set[str] = set()
    names: t.Set[str] = set()
    for stmt in captured:
        reads |= _data_reads(stmt, parents)
        names.update(n.id for n in ast.walk(stmt) if isinstance(n, ast.Name))
    for ev in function_events(scope, names):
        if ev.kind == "store" and isinstance(ev.stmt, ast.Assign):
            reads |= _data_reads(ev.stmt.value, parents)
    for (path, _), info in project.captured().items():
        if path == site.path and info.class_name == cls.name and any(
            a is cls for a in ctx.ancestors(info.node)
        ):
            reads |= _data_reads(info.node, ctx._parents)
    methods = {n.name for n in cls.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    return reads - methods


def _first_fill(ctx: FileContext, node: ast.AST, attr: str) -> bool:
    """Is ``node`` in the body of an ``if self.<attr> is None:``?"""
    for anc in ctx.ancestors(node):
        if isinstance(anc, ast.If) and any(
            _self_attr(n) == attr for n in ast.walk(anc.test)
        ) and any(
            isinstance(n, ast.Compare) and any(isinstance(o, ast.Is) for o in n.ops)
            and any(isinstance(c, ast.Constant) and c.value is None for c in n.comparators)
            for n in ast.walk(anc.test)
        ) and any(n is node for stmt in anc.body for n in ast.walk(stmt)):
            return True
        if isinstance(anc, ast.ClassDef):
            return False
    return False


def _check_rebinds(project: Project, findings: t.List[Finding]) -> None:
    for site in project.capture_sites():
        if site.kind not in ("graph", "burst"):
            continue
        ctx = project.by_path[site.path]
        cls = next((a for a in ctx.ancestors(site.node) if isinstance(a, ast.ClassDef)), None)
        if cls is None:
            continue
        reads = _graph_reads(project, site, cls)
        for node in ast.walk(cls):
            attr = _self_attr(node)
            if attr not in reads or not isinstance(node.ctx, ast.Store):
                continue
            fn = ctx.enclosing_function(node)
            if fn is None or (fn.name == "__init__" and fn in cls.body):
                continue
            if _first_fill(ctx, node, attr):
                continue
            findings.append(Finding(
                "rebind-under-graph", ctx.path, node.lineno, node.col_offset,
                f"self.{attr} is read by the graph captured in {site.qualname} and "
                f"rebound here: the graph keeps reading the old tensor",
                f"update it in place (self.{attr}.copy_(...)), or drop the graph so "
                "the next call captures anew",
            ))


def check(project: Project) -> t.List[Finding]:
    findings: t.List[Finding] = []
    _check_captured(project, findings)
    for ctx in project.files:
        _check_loops(ctx, findings)
    _check_rebinds(project, findings)
    findings.extend(project.entry_point_findings())
    return findings
