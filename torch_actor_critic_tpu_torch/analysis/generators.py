"""generator-discipline rules: every random draw names its generator
(the port's counterpart of the JAX package's ``prng.py``).

JAX threads explicit PRNG keys, and its rules catch a key consumed twice
or split without being replaced. A ``torch.Generator`` advances its own
state on every draw, so neither mistake exists here; the port's hazard
is the opposite one — a draw from PyTorch's or NumPy's global state,
which no checkpoint saves, no seed scopes, and no CUDA graph owns. The
port's rule is that every draw names a generator:

* ``draw-without-generator`` — a torch draw (``torch.rand``,
  ``torch.randint``, ``x.normal_()``, ...) without ``generator=``
  outside captured code (inside it, ``global-random-in-capture``
  reports it);
* ``global-host-random`` — a draw from ``random`` or ``np.random``'s
  global state (``np.random.default_rng(seed)`` and the other explicit
  constructors are fine);
* ``unregistered-generator`` — a generator a ``torch.cuda.graph``
  capture draws from (passed as ``generator=`` or as an argument named
  ``gen``/``generator``/``*_gen``) that the capturing function does not
  register with ``graph.register_generator_state`` (``serve/engine.py``
  ``PolicyEngine._capture`` does): the replays would repeat the capture's
  draws. A ``BurstGraph`` registers the generators it is given.
"""

from __future__ import annotations

import ast
import typing as t

from torch_actor_critic_tpu_torch.analysis.capture import (
    draw_without_generator,
    host_random_call,
)
from torch_actor_critic_tpu_torch.analysis.reachability import Project
from torch_actor_critic_tpu_torch.analysis.walker import Finding, dotted_name

__all__ = ["check"]

FAMILY = "generator-discipline"


def _generator_like(name: str | None) -> bool:
    last = (name or "").rsplit(".", 1)[-1]
    return last in ("gen", "generator") or last.endswith("_gen")


def _check_registration(project: Project, findings: t.List[Finding]) -> None:
    for site in project.capture_sites():
        if site.kind != "graph":
            continue
        ctx = project.by_path[site.path]
        with_node = ctx.parent(ctx.parent(site.node))
        fn = ctx.enclosing_function(site.node)
        registered = {
            dotted_name(n.args[0]) for n in ast.walk(fn)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "register_generator_state" and n.args
        }
        used: t.Dict[str, ast.AST] = {}
        for stmt in with_node.body:
            for call in ast.walk(stmt):
                if not isinstance(call, ast.Call):
                    continue
                for arg in [k.value for k in call.keywords if k.arg == "generator"] + [
                    a for a in call.args if _generator_like(dotted_name(a))
                ]:
                    name = dotted_name(arg)
                    if name is not None:
                        used.setdefault(name, arg)
        for name, arg in sorted(used.items()):
            if name not in registered:
                findings.append(Finding(
                    "unregistered-generator", ctx.path, arg.lineno, arg.col_offset,
                    f"generator {name!r} is drawn from inside the capture in "
                    f"{site.qualname} but never registered with the graph: every "
                    "replay repeats the capture's draws",
                    f"call graph.register_generator_state({name}) before capturing",
                ))


def check(project: Project) -> t.List[Finding]:
    findings: t.List[Finding] = []
    captured = project.captured()
    inside = {
        id(n) for info in captured.values() for n in ast.walk(info.node)
    }
    for ctx in project.files:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or id(node) in inside:
                continue
            draw = draw_without_generator(node)
            if draw is not None:
                findings.append(Finding(
                    "draw-without-generator", ctx.path, node.lineno, node.col_offset,
                    f"{draw} draws from PyTorch's global generator: no checkpoint saves "
                    "it and no seed scopes it",
                    "pass generator= the torch.Generator that owns this stream",
                ))
                continue
            draw = host_random_call(node)
            if draw is not None:
                findings.append(Finding(
                    "global-host-random", ctx.path, node.lineno, node.col_offset,
                    f"{draw} draws from a global random state",
                    "draw from an explicit np.random.default_rng(seed) / "
                    "random.Random(seed)",
                ))
    _check_registration(project, findings)
    return findings
