"""The port's tac-lint (``torch_actor_critic_tpu_torch/analysis``) on the
CPU: the whole port lints clean; the JAX package's fixtures for the
carried families (lock-discipline, conventions, the suppression policy)
give the same rule ids at the same lines through both analyzers; each
rule of the port's own families (capture-hygiene, generator-discipline)
has a flagged fixture and a clean one; the capture-site table is
checked both ways against the real package; the contract table's
matchers accept the port's spellings; every rule of JAX's catalog is
carried, replaced or listed in ROADMAP.md; and the CLI's exit codes.
"""

import pathlib
import re
import textwrap

import pytest

import torch_actor_critic_tpu_torch
from torch_actor_critic_tpu.analysis import RULE_FAMILIES as JAX_RULE_FAMILIES
from torch_actor_critic_tpu.analysis import lint_sources as jax_lint_sources
from torch_actor_critic_tpu_torch.analysis import (
    ALL_RULES,
    RULE_FAMILIES,
    lint_paths,
    lint_sources,
)
from torch_actor_critic_tpu_torch.analysis import reachability
from torch_actor_critic_tpu_torch.analysis.__main__ import FAMILY_EXIT_CODES, main

PKG = pathlib.Path(torch_actor_critic_tpu_torch.__file__).parent
REPO = PKG.parent


def lint_one(src: str, path: str = "fixture.py", rules=None):
    return lint_sources({path: textwrap.dedent(src)}, rules=rules)


def rules_and_lines(findings):
    return sorted((f.rule, f.line) for f in findings)


def flagged_lines(src: str):
    """Lines of a fixture marked ``# flagged``."""
    return [i for i, line in enumerate(textwrap.dedent(src).splitlines(), 1)
            if "# flagged" in line]


# ------------------------------------------------- the port as it stands


def test_the_whole_port_lints_clean():
    findings = lint_paths([str(PKG)])
    assert findings == [], "\n".join(f.format() for f in findings)


def test_cli_exits_zero_on_the_port_and_one_on_a_finding(tmp_path, capsys):
    assert main([str(PKG)]) == 0
    assert "0 findings" in capsys.readouterr().out
    bad = tmp_path / "bad.py"
    bad.write_text("def f(xs=[]):\n    return xs\n")
    assert main([str(bad)]) == 1
    assert "mutable-default-arg" in capsys.readouterr().out


def test_json_mode_per_family_exit_codes(tmp_path, capsys):
    import json

    clean = tmp_path / "clean.py"
    clean.write_text("def f():\n    return 1\n")
    assert main(["--json", str(clean)]) == 0
    assert json.loads(capsys.readouterr().out)["clean"]
    conv = tmp_path / "conv.py"
    conv.write_text("def f(xs=[]):\n    return xs\n")
    assert main(["--json", str(conv)]) == FAMILY_EXIT_CODES["conventions"] == 13
    capsys.readouterr()
    gen = tmp_path / "gen.py"
    gen.write_text("import torch\n\ndef f():\n    return torch.rand(3)\n")
    assert main(["--json", str(gen)]) == FAMILY_EXIT_CODES["generator-discipline"] == 15
    capsys.readouterr()
    assert main(["--json", str(conv), str(gen)]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["exit_code"] == 1 and len(out["findings"]) == 2
    assert main(["--select", "no-such-rule", str(clean)]) == 2


def test_exit_codes_are_the_jax_clis():
    from torch_actor_critic_tpu.analysis.__main__ import FAMILY_EXIT_CODES as JAX_CODES

    replaced = {"capture-hygiene": "jit-hygiene", "generator-discipline": "prng-discipline"}
    for family, code in FAMILY_EXIT_CODES.items():
        assert JAX_CODES[replaced.get(family, family)] == code
    assert set(FAMILY_EXIT_CODES) == set(RULE_FAMILIES)


def test_rule_catalog_covers_every_jax_rule():
    """Each JAX rule is carried (same id), replaced by a port rule, or
    listed in ROADMAP.md with its reason."""
    assert ALL_RULES == {r for rules in RULE_FAMILIES.values() for r in rules}
    roadmap = (REPO / "ROADMAP.md").read_text()
    for family, rules in JAX_RULE_FAMILIES.items():
        for rule in rules:
            assert rule in ALL_RULES or f"`{rule}`" in roadmap, (family, rule)


# ------------------------------------------- the JAX fixtures, both ways

_LOCKED_CLASS = """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._items = []  # guarded-by: _lock

        def add(self, x):
            {add_body}

        def drain(self):
            with self._lock:
                out, self._items = self._items, []
            return out
"""

JAX_FIXTURES = {
    "unlocked_guarded_access": _LOCKED_CLASS.format(add_body="self._items.append(x)"),
    "guarded_access_under_lock": _LOCKED_CLASS.format(
        add_body="with self._lock:\n                self._items.append(x)"),
    "lock_holding_method_conventions": """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0  # guarded-by: _lock

            def _bump_locked(self):
                self._n += 1

            def _peek(self):
                \"\"\"Callers hold ``self._lock``.\"\"\"
                return self._n

            def bump(self):
                with self._lock:
                    self._bump_locked()
                    return self._peek()
    """,
    "condition_aliases_its_lock": """
        import threading

        class Q:
            def __init__(self):
                self._lock = threading.Lock()
                self._nonempty = threading.Condition(self._lock)
                self._q = []  # guarded-by: _lock

            def put(self, x):
                with self._nonempty:
                    self._q.append(x)
    """,
    "unguarded_shared_attr": """
        import threading

        class Worker:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def on_request(self):
                self.count += 1

            def reset(self):
                self.count = 0
    """,
    "unknown_guard": """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._x = 0  # guarded-by: _mutex

            def get(self):
                with self._lock:
                    return self._x
    """,
    "silent_exception_swallow": """
        def handshake():
            try:
                risky()
            except Exception:
                pass
    """,
    "swallow_allowed_on_shutdown_and_narrow": """
        def close():
            try:
                flush()
            except Exception:
                pass

        def handshake():
            try:
                risky()
            except OSError:
                pass
    """,
    "mutable_default_arg": """
        def f(xs=[]):
            return xs
    """,
    "suffix_reduction_mismatch": """
        import numpy as np

        def metrics(x):
            return {
                "loss_max": np.min(x),
                "loss_min": np.min(x),
                "steps_sum": np.sum(x),
            }
    """,
    "bare_suppression": """
        def f(xs=[]):  # tac-lint: disable
            return xs
    """,
    "suppression_naming_unknown_rule": """
        def f(xs=[]):  # tac-lint: disable=definitely-not-a-rule
            return xs
    """,
    "named_suppression": """
        def f(xs=[]):  # tac-lint: disable=mutable-default-arg
            return xs
    """,
}


@pytest.mark.parametrize("name", sorted(JAX_FIXTURES))
def test_carried_families_agree_with_the_jax_analyzer(name):
    src = textwrap.dedent(JAX_FIXTURES[name])
    carried = {r for f in ("lock-discipline", "conventions", "meta")
               for r in RULE_FAMILIES[f]}
    jax = [f for f in jax_lint_sources({"fixture.py": src}) if f.rule in carried]
    port = lint_sources({"fixture.py": src})
    assert rules_and_lines(port) == rules_and_lines(jax)
    expect_clean = name in ("guarded_access_under_lock", "lock_holding_method_conventions",
                            "condition_aliases_its_lock", "swallow_allowed_on_shutdown_and_narrow",
                            "named_suppression")
    assert (port == []) == expect_clean


# ------------------------------------------------- the port's own rules

CAPTURE = {
    "host-sync-in-capture": ("""
        import torch

        def step(x):
            return x.sum().item()  # flagged

        def run(x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = step(x)
                torch.cuda.synchronize()  # flagged
    """, """
        import torch

        def step(x):
            return x.sum()

        def run(x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = step(x)
            g.replay()
            return y.item()
    """),
    "wallclock-in-capture": ("""
        import time

        import torch
        from torch_actor_critic_tpu_torch.sac.graph import BurstGraph

        def step(stack):
            stack.t = time.perf_counter()  # flagged

        def run(key, gen):
            return BurstGraph(lambda s: step(s), key, 4, gen)
    """, """
        import time

        import torch
        from torch_actor_critic_tpu_torch.sac.graph import BurstGraph

        def step(stack):
            stack.t = stack.t + 1

        def run(key, gen):
            t0 = time.perf_counter()
            graph = BurstGraph(lambda s: step(s), key, 4, gen)
            return graph, time.perf_counter() - t0
    """),
    "global-random-in-capture": ("""
        import torch
        from torch_actor_critic_tpu_torch.sac.graph import BurstGraph

        class Learner:
            def _step(self, stack):
                stack.noise = torch.randn(3)  # flagged

            def burst(self, key, gen):
                return BurstGraph(self._step, key, 4, gen)
    """, """
        import torch
        from torch_actor_critic_tpu_torch.sac.graph import BurstGraph

        class Learner:
            def _step(self, stack):
                stack.noise = torch.randn(3, generator=self.gen)

            def burst(self, key, gen):
                return BurstGraph(self._step, key, 4, gen)
    """),
    "capture-in-loop": ("""
        import torch

        def run(xs):
            for x in xs:
                g = torch.cuda.CUDAGraph()  # flagged
                g.replay()
    """, """
        import torch

        def run(xs):
            g = torch.cuda.CUDAGraph()
            for x in xs:
                g.replay()
    """),
    "rebind-under-graph": ("""
        import torch

        class Engine:
            def __init__(self):
                self.buf = torch.zeros(3)
                self.out = None

            def capture(self):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    self.out = self.buf * 2
                return graph

            def load(self, x):
                self.buf = x  # flagged
    """, """
        import torch

        class Engine:
            def __init__(self):
                self.buf = None
                self.out = None

            def capture(self):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    self.out = self.buf * 2
                return graph

            def load(self, x):
                if self.buf is None:
                    self.buf = x.clone()
                else:
                    self.buf.copy_(x)
    """),
}

GENERATORS = {
    "draw-without-generator": ("""
        import torch

        def noise(x):
            x.normal_()  # flagged
            return torch.randint(0, 4, (3,))  # flagged
    """, """
        import torch

        def noise(x, gen):
            x.normal_(generator=gen)
            return torch.randint(0, 4, (3,), generator=gen)
    """),
    "global-host-random": ("""
        import random

        import numpy as np

        def pick(xs):
            np.random.shuffle(xs)  # flagged
            return random.choice(xs)  # flagged
    """, """
        import random

        import numpy as np

        def pick(xs, seed):
            np.random.default_rng(seed).shuffle(xs)
            return random.Random(seed).choice(xs)
    """),
    "unregistered-generator": ("""
        import torch

        def capture(x, gen):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                y = torch.rand(3, generator=gen)  # flagged
            return graph, y
    """, """
        import torch

        def capture(x, gen):
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(gen)
            with torch.cuda.graph(graph):
                y = torch.rand(3, generator=gen)
            return graph, y
    """),
}


@pytest.mark.parametrize("rule", sorted({**CAPTURE, **GENERATORS}))
def test_each_port_rule_flags_its_fixture_and_passes_the_clean_one(rule):
    flagged, clean = {**CAPTURE, **GENERATORS}[rule]
    findings = lint_one(flagged)
    assert rules_and_lines(findings) == [(rule, n) for n in flagged_lines(flagged)], \
        [f.format() for f in findings]
    assert lint_one(clean) == [], [f.format() for f in lint_one(clean)]


def test_capture_hygiene_follows_calls_and_method_references():
    """The captured set reaches a helper through a subclass override
    handed on as an argument (``update_step(self.update, ...)``)."""
    findings = lint_one("""
        import torch
        from torch_actor_critic_tpu_torch.sac.graph import BurstGraph

        def update_step(update, stack):
            update(stack)

        class Learner:
            def burst(self, key, gen):
                return BurstGraph(lambda s: update_step(self.update, s), key, 4, gen)

        class SAC(Learner):
            def update(self, stack):
                return helper(stack)

        def helper(stack):
            return stack.loss.tolist()  # flagged
    """)
    assert [(f.rule, f.line) for f in findings] == [("host-sync-in-capture", 17)]


# ----------------------------------------- the capture-site table, both ways


def test_stale_entry_point_both_ways(monkeypatch):
    """A row naming no capture, and a capture in no row, each fail the
    whole-package run."""
    monkeypatch.setitem(reachability.ENTRY_POINTS, "serve/gone",
                        ("serve/engine.py", "PolicyEngine.warmup"))
    findings = [f for f in lint_paths([str(PKG)]) if f.rule == "stale-entry-point"]
    assert [f.message.split("'")[1] for f in findings] == ["serve/gone"]
    monkeypatch.delitem(reachability.ENTRY_POINTS, "serve/gone")
    monkeypatch.delitem(reachability.ENTRY_POINTS, "train/acting")
    findings = [f for f in lint_paths([str(PKG)]) if f.rule == "stale-entry-point"]
    assert len(findings) == 1 and findings[0].path.endswith("sac/ondevice.py")
    assert "OnDeviceLoop._collect" in findings[0].message


def test_every_capture_site_of_the_package_is_in_the_table():
    from torch_actor_critic_tpu_torch.analysis.walker import FileContext

    files = [p for p in PKG.rglob("*.py") if "__pycache__" not in p.parts]
    project = reachability.Project([FileContext(p.as_posix(), p.read_text()) for p in files])
    sites = {(s.path.split("torch_actor_critic_tpu_torch/")[1], s.qualname, s.kind)
             for s in project.capture_sites()}
    assert sites == {
        ("serve/engine.py", "PolicyEngine._capture", "graph"),
        ("sac/algorithm.py", "Learner.update_burst", "burst"),
        ("sac/ondevice.py", "OnDeviceLoop._collect", "burst"),
        ("replay/offline.py", "OfflineLearner.burst", "burst"),
    }
    assert {(p, q) for p, q, _ in sites} == set(reachability.ENTRY_POINTS.values())
    # The captured code reaches the learners' updates and the losses.
    captured = {q for _, q in project.captured()}
    assert {"SAC.update", "TD3.update", "OfflineLearner.update", "critic_loss",
            "PolicyEngine._forward"} <= captured


# -------------------------------------------------------- contract-drift


def test_contract_rules_skip_partial_runs():
    assert not any(f.rule in ("stale-contract", "missing-watchdog-scope",
                              "missing-cost-registration") for f in lint_one("x = 1\n"))


def test_contract_table_checked_on_package_runs():
    findings = lint_sources({"torch_actor_critic_tpu_torch/__init__.py": ""})
    assert {f.rule for f in findings} >= {"stale-contract"}


def test_contract_wiring_satisfiable_in_miniature():
    """serve/forward's full wiring in a miniature package: its row
    passes (the matchers accept the real spellings) while the rows whose
    files are absent fail."""
    findings = lint_sources({
        "torch_actor_critic_tpu_torch/__init__.py": "",
        "torch_actor_critic_tpu_torch/serve/engine.py": textwrap.dedent("""
            import torch
            from torch_actor_critic_tpu_torch.diagnostics.watchdog import get_watchdog

            class PolicyEngine:
                TRACE_PREFIX = "serve/forward"

                def trace_name(self, bucket):
                    return f"{self.TRACE_PREFIX}[b{bucket}]"

                def _capture(self, bucket):
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        self.out = self.x * 2
                    get_watchdog().note_capture(0.0, label=self.trace_name(bucket))

                def count_cost(self, bucket, cost):
                    get_cost_registry().register(self.trace_name(bucket), cost)
        """),
    })
    drifted = {f.message.split("'")[1] for f in findings
               if f.rule in ("stale-contract", "missing-watchdog-scope",
                             "missing-cost-registration")}
    assert "serve/forward" not in drifted
    assert {"train/burst", "train/acting", "train/offline_burst"} <= drifted


def test_stale_bundle_manifest_needs_an_explicit_literal():
    findings = lint_sources({
        "torch_actor_critic_tpu_torch/__init__.py": "",
        "torch_actor_critic_tpu_torch/analysis/contracts.py": textwrap.dedent("""
            ROWS = {
                "a": ContractRow(name_file="x.py", bundleable=True),
                "b": ContractRow(name_file="x.py"),
                "c": ContractRow(name_file="x.py", bundleable=FLAG),
            }
        """),
    })
    assert [f.line for f in findings if f.rule == "stale-bundle-manifest"] == [4, 5]


def test_the_contract_table_mirrors_the_entry_points():
    from torch_actor_critic_tpu_torch.analysis.contracts import ENTRY_POINT_CONTRACTS

    assert set(ENTRY_POINT_CONTRACTS) == set(reachability.ENTRY_POINTS)
    assert [k for k, row in ENTRY_POINT_CONTRACTS.items() if row.bundleable] == [
        "serve/forward"]


def test_suppressions_in_the_port_name_a_rule():
    n = sum(len(re.findall(r"tac-lint:\s*disable=", p.read_text()))
            for p in PKG.rglob("*.py") if "__pycache__" not in p.parts)
    assert n <= 10
