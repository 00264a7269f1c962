"""CLI for the port's tac-lint pass:
``python -m torch_actor_critic_tpu_torch.analysis [--json] [PATHS]``.

Exit codes (text mode): 0 clean, 1 findings, 2 usage/parse error.
``--json`` mode is the machine contract: one JSON object ``{"clean",
"findings", "families", "exit_code"}`` on stdout, and a STABLE
per-family exit code — 0 clean, 2 usage/parse error,
``FAMILY_EXIT_CODES[family]`` when exactly one family has findings, 1
when several do. The codes are the JAX package's CLI's: a family that
replaces a JAX family keeps its code (capture-hygiene 10, the old
jit-hygiene's; generator-discipline 15, prng-discipline's).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from torch_actor_critic_tpu_torch.analysis import (
    ALL_RULES,
    RULE_FAMILIES,
    family_of,
    lint_paths,
)

# Stable per-family exit codes for --json mode. Append-only: new
# families take the next free code; renumbering breaks CI routing.
FAMILY_EXIT_CODES = {
    "capture-hygiene": 10,
    "lock-discipline": 12,
    "conventions": 13,
    "generator-discipline": 15,
    "contract-drift": 16,
    "meta": 17,
}


def exit_code_for(families: "dict[str, int]") -> int:
    """0 clean; the family's stable code when exactly one family has
    findings; 1 for a mixed set."""
    hit = [f for f, n in families.items() if n]
    if not hit:
        return 0
    if len(hit) == 1:
        return FAMILY_EXIT_CODES[hit[0]]
    return 1


def _default_paths() -> list:
    """The port's package, repo-relative when run from the root."""
    pkg = pathlib.Path(__file__).resolve().parent.parent
    try:
        return [pkg.relative_to(pathlib.Path.cwd()).as_posix()]
    except ValueError:
        return [pkg.as_posix()]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m torch_actor_critic_tpu_torch.analysis",
        description="tac-lint for the PyTorch port: capture-hygiene, "
        "generator-discipline, lock-discipline, contract-drift and "
        "convention checks",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files/directories to lint (default: the port's package)",
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="finding output format (json: the raw findings list)",
    )
    parser.add_argument(
        "--json", action="store_true", dest="json_mode",
        help="machine-readable mode: one JSON object {clean, findings, "
        "families, exit_code} and stable per-family exit codes",
    )
    parser.add_argument(
        "--select", default=None, metavar="RULES",
        help="comma-separated rule ids to run (default: all)",
    )
    parser.add_argument(
        "--disable", default=None, metavar="RULES",
        help="comma-separated rule ids to skip",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for family, rules in RULE_FAMILIES.items():
            print(f"{family}:")
            for rule in rules:
                print(f"  {rule}")
        return 0

    rules = set(ALL_RULES)
    for raw, keep in ((args.select, True), (args.disable, False)):
        if raw is None:
            continue
        names = {n.strip() for n in raw.split(",") if n.strip()}
        unknown = names - ALL_RULES
        if unknown:
            print(
                f"unknown rule id(s): {', '.join(sorted(unknown))} "
                "(see --list-rules)", file=sys.stderr,
            )
            return 2
        rules = (rules & names) if keep else (rules - names)

    paths = args.paths or _default_paths()
    try:
        findings = lint_paths(paths, rules=rules)
    except SyntaxError as e:
        print(f"parse error: {e}", file=sys.stderr)
        return 2

    if args.json_mode:
        families = {name: 0 for name in RULE_FAMILIES}
        for f in findings:
            families[family_of(f.rule)] += 1
        code = exit_code_for(families)
        print(json.dumps({
            "clean": not findings,
            "findings": [f.as_dict() for f in findings],
            "families": families,
            "exit_code": code,
        }, indent=2, sort_keys=True))
        return code
    if args.format == "json":
        print(json.dumps([f.as_dict() for f in findings], indent=2))
    else:
        for f in findings:
            print(f.format())
        n = len(findings)
        print(f"tac-lint: {n} finding{'s' if n != 1 else ''}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
