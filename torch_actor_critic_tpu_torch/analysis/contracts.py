"""contract-drift rules: the capture sites' wiring, checked as one table
(the port's copy of the JAX package's ``analysis/contracts.py``).

Every capture site owes two things beyond the graph itself: a
**watchdog note** under its identity (so a capture after the steady
regime is attributed and flagged, :mod:`~..diagnostics.watchdog`) and a
**cost registration** (so the roofline and MFU accounting see it,
:mod:`~..telemetry.costmodel`). :data:`ENTRY_POINT_CONTRACTS` makes the
wiring a checked table:

* ``stale-contract`` — the table and ``reachability.ENTRY_POINTS`` must
  cover exactly the same identities, and each row's identity literal
  must still be bound where the row says (an attribute or constant, or
  the literal itself in the file).
* ``missing-watchdog-scope`` — the file the row names no longer notes
  the capture to the watchdog (``note_capture(...)``, or a
  ``watchdog.source(...)`` scope) reading the identity.
* ``missing-cost-registration`` — the registering function the row
  names no longer calls ``register(...)`` with the row's cost name.
* ``stale-bundle-manifest`` — every row must carry an **explicit**
  ``bundleable=`` literal: the warm-start manifest (``aot/manifest.py``)
  is derived from this column.

The JAX package's ``incoherent-sharding`` waits for data-parallel
training on the port (ROADMAP queue 1 item 6). All checks run on
whole-package runs only (a fixture or single-file run cannot tell
missing wiring from un-linted wiring).
"""

from __future__ import annotations

import ast
import typing as t

from torch_actor_critic_tpu_torch.analysis.reachability import (
    ENTRY_POINTS,
    PACKAGE,
    Project,
)
from torch_actor_critic_tpu_torch.analysis.walker import (
    FileContext,
    Finding,
)

__all__ = ["check", "ENTRY_POINT_CONTRACTS"]

FAMILY = "contract-drift"


class ContractRow(t.NamedTuple):
    name_file: str                      # file binding the identity
    name_attr: str | None               # attr/constant assigned the
    #                                     literal (None: the literal
    #                                     itself appears in the file)
    scope_file: str                     # file noting the capture
    scope_ref: str | None               # attr the note reads (None:
    #                                     the literal itself)
    register_fn: t.Tuple[str, str]      # (file, qualname) registering
    register_ref: str | None            # attr the registration reads
    cost_name: str | None               # the cost registry's name (None:
    #                                     the identity itself)
    bundleable: bool                    # warm-start manifest column:
    #                                     True iff the programs are in
    #                                     the bundle (aot/manifest.py;
    #                                     stale-bundle-manifest requires
    #                                     an explicit literal)


# The checked wiring table, one row per reachability.ENTRY_POINTS
# identity (key sets must match — stale-contract otherwise).
ENTRY_POINT_CONTRACTS: t.Dict[str, ContractRow] = {
    "serve/forward": ContractRow(
        name_file="serve/engine.py", name_attr="TRACE_PREFIX",
        scope_file="serve/engine.py", scope_ref="trace_name",
        register_fn=("serve/engine.py", "PolicyEngine.count_cost"),
        register_ref="trace_name", cost_name=None,
        # The serving graphs at the bucket ladder: what a fresh worker
        # captures at warm-up, the bundle's reason to exist.
        bundleable=True,
    ),
    "train/burst": ContractRow(
        name_file="sac/graph.py", name_attr="BURST_SOURCE",
        scope_file="sac/graph.py", scope_ref="source",
        register_fn=("sac/trainer.py", "Trainer._note_epoch_cost"),
        register_ref="BURST_COST", cost_name="train/update_burst",
        # Training captures follow the run's config, not a fixed ladder:
        # they ride the shared kernel-library cache.
        bundleable=False,
    ),
    "train/acting": ContractRow(
        name_file="sac/ondevice.py", name_attr="ACT_SOURCE",
        scope_file="sac/graph.py", scope_ref="source",
        register_fn=("sac/ondevice.py", "_note_epoch_cost"),
        register_ref="EPOCH_COST", cost_name="train/ondevice_epoch",
        bundleable=False,
    ),
    "train/offline_burst": ContractRow(
        name_file="replay/offline.py", name_attr="BURST_COST",
        scope_file="sac/graph.py", scope_ref="source",
        register_fn=("replay/offline.py", "train_offline"),
        register_ref="BURST_COST", cost_name=None,
        bundleable=False,
    ),
}


def _find(project: Project, suffix: str) -> FileContext | None:
    path = next((p for p in project.by_path if p.endswith(suffix)), None)
    return project.by_path.get(path) if path else None


def _binds_literal(ctx: FileContext, attr: str | None, literal: str) -> bool:
    """Is ``<attr> = "<literal>"`` assigned in the file (also as one
    element of a tuple assignment)? With ``attr`` None: does the
    literal appear in the file at all?"""
    for node in ast.walk(ctx.tree):
        if attr is None:
            if isinstance(node, ast.Constant) and node.value == literal:
                return True
            continue
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            pairs = [(target, node.value)]
            if isinstance(target, ast.Tuple) and isinstance(node.value, ast.Tuple):
                pairs = list(zip(target.elts, node.value.elts))
            for tgt, value in pairs:
                name = tgt.attr if isinstance(tgt, ast.Attribute) else (
                    tgt.id if isinstance(tgt, ast.Name) else None
                )
                if name == attr and isinstance(value, ast.Constant) and value.value == literal:
                    return True
    return False


def _mentions_ref(node: ast.AST, ref: str | None, literal: str) -> bool:
    """Does the expression read the identity — the attr ``ref``
    (``self.epoch_cost_name``, ``self._trace_names[b]``) or the
    literal itself?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and sub.value == literal:
            return True
        if ref is not None and (
            (isinstance(sub, ast.Attribute) and sub.attr == ref)
            or (isinstance(sub, ast.Name) and sub.id == ref)
        ):
            return True
    return False


def _has_source_scope(
    ctx: FileContext, ref: str | None, literal: str
) -> bool:
    """A ``<x>.note_capture(...)`` or ``<x>.source(...)`` call reading
    the identity."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        # `get_watchdog().note_capture(...)` has a Call receiver, which
        # dotted_name cannot flatten — match on the attribute name.
        if not (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in ("source", "note_capture")
        ):
            continue
        args = list(node.args) + [k.value for k in node.keywords]
        if any(_mentions_ref(a, ref, literal) for a in args):
            return True
    return False


def _has_registration(
    ctx: FileContext, qualname: str, ref: str | None, literal: str
) -> t.Tuple[bool, bool]:
    """(fn_exists, registers): the named function exists and calls
    ``register`` with a name reading the identity."""
    fn = next((f for f in ctx.functions if f.qualname == qualname), None)
    if fn is None:
        return False, False
    for node in ast.walk(fn.node):
        if not isinstance(node, ast.Call):
            continue
        # `get_cost_registry().register(...)` has a Call receiver;
        # match on the attribute name like _has_source_scope.
        if not (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "register"
        ):
            continue
        if node.args and _mentions_ref(node.args[0], ref, literal):
            return True, True
        # The name may be hoisted into a local or a default argument
        # (`name: str = EPOCH_COST; registry.register(name, ...)`):
        # accept when the registering function reads the ref anywhere.
        if _mentions_ref(fn.node, ref, literal):
            return True, True
    return True, False


def _check_bundle_manifest(project: Project) -> t.List[Finding]:
    """stale-bundle-manifest: every ContractRow(...) literal in this
    file must pass ``bundleable=`` as an explicit keyword with a bool
    constant. The warm-start manifest (aot/manifest.py) is derived from
    that column; a row relying on a positional slip or a computed value
    would let a capture site ship without an auditable decision."""
    findings: t.List[Finding] = []
    ctx = _find(project, "analysis/contracts.py")
    if ctx is None:
        return findings
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        callee = node.func
        name = callee.attr if isinstance(callee, ast.Attribute) else (
            callee.id if isinstance(callee, ast.Name) else None
        )
        if name != "ContractRow":
            continue
        kw = next(
            (k for k in node.keywords if k.arg == "bundleable"), None
        )
        if kw is not None and (
            isinstance(kw.value, ast.Constant)
            and isinstance(kw.value.value, bool)
        ):
            continue
        findings.append(Finding(
            "stale-bundle-manifest", "analysis/contracts.py",
            node.lineno, node.col_offset,
            "ENTRY_POINT_CONTRACTS row without an explicit "
            "`bundleable=True/False` literal — the warm-start manifest "
            "cannot tell whether this capture site is bundled",
            "add `bundleable=` to the ContractRow with a literal bool "
            "(True only if aot/bundle.py bundles the programs)",
        ))
    return findings


def check(project: Project) -> t.List[Finding]:
    findings: t.List[Finding] = []
    if not any(
        p.endswith(f"{PACKAGE}/__init__.py") for p in project.by_path
    ):
        return findings
    findings.extend(_check_bundle_manifest(project))
    table_keys = set(ENTRY_POINT_CONTRACTS)
    entry_keys = set(ENTRY_POINTS)
    for missing in sorted(entry_keys - table_keys):
        findings.append(Finding(
            "stale-contract", "analysis/contracts.py", 1, 0,
            f"capture site {missing!r} has no ENTRY_POINT_CONTRACTS row "
            "(watchdog and cost wiring unchecked)",
            "add the row to analysis/contracts.py",
        ))
    for extra in sorted(table_keys - entry_keys):
        findings.append(Finding(
            "stale-contract", "analysis/contracts.py", 1, 0,
            f"ENTRY_POINT_CONTRACTS row {extra!r} matches no "
            "reachability.ENTRY_POINTS identity; the site it wired is gone",
            "remove the row, or restore the ENTRY_POINTS identity it "
            "describes",
        ))
    for identity in sorted(table_keys & entry_keys):
        row = ENTRY_POINT_CONTRACTS[identity]
        cost_name = row.cost_name or identity
        # --- identity binding -----------------------------------------
        name_ctx = _find(project, row.name_file)
        if name_ctx is None or not _binds_literal(name_ctx, row.name_attr, identity):
            findings.append(Finding(
                "stale-contract", row.name_file, 1, 0,
                f"capture site {identity!r}: identity is not bound as "
                f"{row.name_attr!r} in {row.name_file!r} any more",
                "update the binding (or the ENTRY_POINT_CONTRACTS row) so "
                "the identity has exactly one source of truth",
            ))
            continue
        # --- watchdog note --------------------------------------------
        scope_ctx = _find(project, row.scope_file)
        if scope_ctx is None or not _has_source_scope(scope_ctx, row.scope_ref, identity):
            findings.append(Finding(
                "missing-watchdog-scope", row.scope_file, 1, 0,
                f"capture site {identity!r}: no note_capture(...) reading "
                f"the identity in {row.scope_file!r} — a capture after the "
                "steady regime would go unattributed",
                "note each capture with get_watchdog().note_capture(secs, "
                "<identity>)",
            ))
        # --- cost registration ----------------------------------------
        reg_ctx = _find(project, row.register_fn[0])
        fn_exists, registers = (False, False) if reg_ctx is None else (
            _has_registration(reg_ctx, row.register_fn[1], row.register_ref, cost_name)
        )
        if not fn_exists or not registers:
            findings.append(Finding(
                "missing-cost-registration", row.register_fn[0], 1, 0,
                f"capture site {identity!r}: {row.register_fn[1]!r} no longer "
                f"registers the cost of {cost_name!r} — roofline and MFU "
                "accounting go blind for it",
                f"call get_cost_registry().register({cost_name!r}, cost) from "
                "the warm-up or epoch path",
            ))
    return findings
