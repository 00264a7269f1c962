"""The port's run-wide obs plane (``obs/``) against the JAX package's, on
the CPU.

Each case runs the same inputs through both packages' modules and
compares the outputs exactly: the snapshot fold and ``flatten_numeric``
(the restart, flap, dead-source and histogram cases of
``tests/test_obs.py``), the SLO engine's event sequence, snapshot and
report on scripted series (hysteresis, delta mode, ``missing_ok``,
arm-on-first-pass; one injected clock), ``load_rules``' error text, the
trace collector's span files. The collector itself runs in both
packages over the same in-process and HTTP sources. Then the port's own
wiring: ``serve/metrics.aggregate_snapshots`` delegates to the obs
fold, the trainer's ``--obs`` writes ``obs.jsonl`` and ``obs/``
columns, and with the flags off nothing of the plane exists.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from torch_actor_critic_tpu.obs import collector as j_collector
from torch_actor_critic_tpu.obs import merge as j_merge
from torch_actor_critic_tpu.obs import slo as j_slo
from torch_actor_critic_tpu.obs import tracecollect as j_trace
from torch_actor_critic_tpu.serve import metrics as j_serve_metrics
from torch_actor_critic_tpu.telemetry.histogram import FixedBucketHistogram as JHist
from torch_actor_critic_tpu_torch.obs import collector as p_collector
from torch_actor_critic_tpu_torch.obs import merge as p_merge
from torch_actor_critic_tpu_torch.obs import slo as p_slo
from torch_actor_critic_tpu_torch.obs import tracecollect as p_trace
from torch_actor_critic_tpu_torch.sac.trainer import Trainer
from torch_actor_critic_tpu_torch.serve import metrics as p_serve_metrics
from torch_actor_critic_tpu_torch.telemetry.histogram import FixedBucketHistogram
from torch_actor_critic_tpu_torch.utils.config import SACConfig
from torch_actor_critic_tpu_torch.utils.tracking import Tracker


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hist(values, cls=FixedBucketHistogram):
    h = cls()
    for v in values:
        h.record(v)
    return h.raw_counts()


def _snap(i, extra=None):
    out = {"requests_total": 10 * (i + 1), "sheds_total": i, "queue_depth": 2,
           "requests_per_sec": 5.0, "latency_hist": _hist([1.0 * (i + 1)] * 10)}
    out.update(extra or {})
    return out


# ------------------------------------------------------------ the fold

FOLD_CASES = {
    "dying_worker": [{"w0": _snap(0), "w1": None, "w2": _snap(2)}],
    "missing_hist": [{"w0": {"requests_total": 3}, "w1": _snap(1)}],
    "restarted_worker": [{"w0": {"requests_total": 100}, "w1": {"requests_total": 50}},
                         {"w0": {"requests_total": 100}, "w1": {"requests_total": 7}}],
    "flapping_source": [
        {"a": {"requests_total": 100}, "b": {"requests_total": 50}},
        {"a": {"requests_total": 104}, "b": None},
        {"a": {"requests_total": 110}, "b": {"requests_total": 52}},
        {"a": {"requests_total": 115}},
        {"a": {"requests_total": 120}, "b": {"requests_total": 3}},
    ],
    "key_absent": [{"a": {"requests_total": 9}, "b": {}},
                   {"a": {"x_total": 4}, "b": {"y_total": 2}}],
    "hist_spec_mismatch": [{"w0": _snap(0), "w1": {"latency_hist": {
        "counts": [1, 2], "spec": {"lo": 0.5, "growth": 2.0, "n_buckets": 2}}}}],
    "dynamic_mode": [{"learner": {"telemetry/spans_total": 4, "depth": 3, "live_compiles": 1,
                                  "loss": 0.5, "staging/staged_total": 7},
                      "fleet": {"staging/staged_total": 2, "queue_depth": 5}}],
}


@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_fold_matches_jax(case):
    """Dynamic mode (the collector's) and the serving key set give the
    JAX fold's output on every window, and the serving delegate in
    ``serve/metrics`` equals JAX's."""
    for snaps in FOLD_CASES[case]:
        assert p_merge.aggregate_snapshots(snaps) == j_merge.aggregate_snapshots(snaps)
        assert (p_serve_metrics.aggregate_snapshots(snaps)
                == j_serve_metrics.aggregate_snapshots(snaps))
    if case == "flapping_source":
        totals = [p_merge.aggregate_snapshots(s)["requests_total"]
                  for s in FOLD_CASES[case]]
        assert totals == [150, 104, 162, 115, 123]


def test_histogram_state_merges_across_packages():
    """A port worker's histogram export folds into the JAX estimator and
    back: the spec and the counts are one format."""
    a, b = _hist([1.0, 2.0, 50.0]), _hist([3.0] * 5, cls=JHist)
    snaps = {"port": {"latency_hist": a}, "jax": {"latency_hist": b}}
    assert p_merge.aggregate_snapshots(snaps) == j_merge.aggregate_snapshots(snaps)
    assert sum(p_merge.aggregate_snapshots(snaps)["latency_hist"]["counts"]) == 8


def test_flatten_numeric_matches_jax():
    snap = {"a": {"b": {"c": 1, "d": {"too": {"deep": 2}}}, "ok": True},
            "latency_hist": _hist([1.0]), "name": "x", "rate": 2.5,
            "nested": {"latency_hist": _hist([2.0]), "n_total": 3}}
    for depth in (1, 2, 3):
        assert (p_merge.flatten_numeric(snap, max_depth=depth)
                == j_merge.flatten_numeric(snap, max_depth=depth))
    assert p_merge.flatten_numeric(snap)["a/ok"] == 1


# ------------------------------------------------------------- SLO rules

def _rules(mod):
    return [
        mod.SLORule("floor", "serve.rps", "min", 5.0, breach_windows=2, recover_windows=2),
        mod.SLORule("ceiling", "serve.p99", "max", 100.0, breach_windows=1, recover_windows=3),
        mod.SLORule("sheds", "router.sheds_total", "max", 0.0, mode="delta",
                    breach_windows=1, recover_windows=2),
        mod.SLORule("strict", "fleet.healthz.ok", "min", 1.0, missing_ok=False,
                    breach_windows=1, recover_windows=1),
        *mod.default_rules(),
    ]


def _series():
    """Scripted windows: warm-up without paths, arming, a flapping
    floor, a ceiling spike, a shed burst and its quiet, a strict path
    that goes missing after arming, a bool invariant."""
    rows = []
    for i in range(24):
        row = {"serve": {}, "router": {"sheds_total": 0}, "fleet": {"healthz": {}}}
        if i >= 2:
            row["serve"]["rps"] = [9, 9, 3, 3, 3, 9, 3, 9, 9, 9][i % 10]
        if i >= 3:
            row["serve"]["p99"] = 300.0 if i in (7, 8, 15) else 20.0
        row["router"]["sheds_total"] = 0 if i < 10 else (40 if i < 12 else 40 + (i >= 12) * 3)
        if i not in (18, 19):
            row["fleet"]["healthz"]["ok"] = i % 9 != 5
        if i >= 20:
            row["learner"] = {"metrics": {"cost/epoch_mfu": 0.02 + 0.01 * i,
                                          "env_steps_per_sec": 0.5}}
        rows.append(row)
    return rows


def test_slo_engine_emits_jax_events_on_a_scripted_series():
    engines = [mod.SLOEngine(_rules(mod), clock=lambda: 123.0) for mod in (j_slo, p_slo)]
    for i, row in enumerate(_series()):
        jev, pev = (e.observe(row) for e in engines)
        assert pev == jev, (i, pev, jev)
    assert engines[1].snapshot() == engines[0].snapshot()
    assert engines[1].report() == engines[0].report()
    snap = engines[1].snapshot()
    assert snap["breaches_total"] >= 4 and snap["rules"]["sheds"]["recoveries_total"] == 1
    # The default MFU floor arms only on a first pass: 0.22 at window 20.
    assert snap["rules"]["mfu_floor"]["armed"]


@pytest.mark.parametrize("path", ["serve.rps", "router.sheds_total", "fleet.healthz.ok",
                                  "a.b.c", "serve"])
def test_dig_matches_jax(path):
    row = {"serve": {"rps": 3}, "router": {"sheds_total": 2.5},
           "fleet": {"healthz": {"ok": True}}, "a": {"b": "str"}}
    assert p_slo.dig(row, path) == j_slo.dig(row, path)


BAD_RULES = {
    "unknown_key": [{"name": "g", "path": "a", "op": "min", "threshold": 1, "thresold": 2}],
    "missing_threshold": [{"name": "g", "path": "a", "op": "min"}],
    "missing_name_path": [{"op": "min", "threshold": 1}],
    "duplicate": [{"name": "g", "path": "a", "op": "min", "threshold": 1},
                  {"name": "g", "path": "b", "op": "max", "threshold": 2}],
    "not_a_list": {"name": "g"},
    "bad_op": [{"name": "r", "path": "a", "op": "between", "threshold": 1}],
    "bad_mode": [{"name": "r", "path": "a", "op": "min", "threshold": 1, "mode": "rate"}],
    "bad_windows": [{"name": "r", "path": "a", "op": "min", "threshold": 1,
                     "breach_windows": 0}],
    "wrong_type": [{"name": "r", "path": "a", "op": "min", "threshold": {"no": 1}}],
    "not_an_object": ["not-an-object"],
    "not_json": "{",
    "missing_file": None,
}


@pytest.mark.parametrize("case", sorted(BAD_RULES))
def test_load_rules_errors_match_jax(tmp_path, case):
    path = tmp_path / "slo.json"
    spec = BAD_RULES[case]
    if spec is not None:
        path.write_text(spec if isinstance(spec, str) else json.dumps(spec))
    errors = []
    for mod in (j_slo, p_slo):
        with pytest.raises(ValueError) as ei:
            mod.load_rules(str(path))
        errors.append(str(ei.value))
    assert errors[1] == errors[0]


def test_load_rules_parses_what_jax_parses(tmp_path):
    path = tmp_path / "slo.json"
    path.write_text(json.dumps([
        {"name": "shed_rate_ceiling", "path": "router.sheds_total", "op": "max",
         "threshold": 0, "mode": "delta", "breach_windows": 1, "recover_windows": 2},
        {"name": "p99", "path": "router.p99_ms", "op": "max", "threshold": 50,
         "missing_ok": False}]))
    got = [r.to_dict() for r in p_slo.load_rules(str(path))]
    assert got == [r.to_dict() for r in j_slo.load_rules(str(path))]
    assert ([r.to_dict() for r in p_slo.default_rules()]
            == [r.to_dict() for r in j_slo.default_rules()])


# ----------------------------------------------------------- collector

class _MetricsServer:
    """A stdlib HTTP process stand-in: ``/metrics`` and ``/healthz``."""

    def __init__(self, body):
        self.body = body
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):  # noqa: N802
                data = json.dumps(outer.body if self.path == "/metrics"
                                  else {"conservation_ok": True}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _scrape(mod, slo, tmp_path, url, dead_url):
    c = mod.ObsCollector(interval_s=60.0, run_dir=str(tmp_path), rules=[
        slo.SLORule("rps", "fleet.requests_per_sec", "min", 1.0, breach_windows=1)])
    try:
        c.add_source("learner", lambda: {"metrics": {"env_steps_per_sec": 4.0},
                                         "telemetry": {"spans_total": 3}})
        c.add_source("fleet", mod.http_source(url, paths=("/metrics", "/healthz")))
        c.add_source("dead", dead_url)
        c.add_source("broken", lambda: 1 / 0)
        rows = [c.scrape_once() for _ in range(3)]
        cols = c.metrics_columns()
        with open(tmp_path / "obs.jsonl") as f:
            lines = [json.loads(x) for x in f]
    finally:
        c.close()
    return rows, cols, lines


def test_collector_folds_sources_like_jax(tmp_path):
    """Both collectors over an in-process source, an HTTP source with an
    extra path, a dead URL and a raising callable: the same merged rows
    and per-plane views, the same ``obs/`` columns (apart from the
    scrape's own milliseconds), a dead source counted as
    ``scrape_failed`` on every window, one ``obs.jsonl`` line a window."""
    server = _MetricsServer({"requests_total": 5, "requests_per_sec": 2.0,
                             "latency_hist": _hist([1.0, 2.0])})
    dead = _MetricsServer({})
    dead_url = dead.url
    dead.close()
    try:
        out = {}
        for name, mod, slo in (("jax", j_collector, j_slo), ("port", p_collector, p_slo)):
            d = tmp_path / name
            d.mkdir()
            out[name] = _scrape(mod, slo, d, server.url, dead_url)
    finally:
        server.close()
    (jrows, jcols, jlines), (prows, pcols, plines) = out["jax"], out["port"]
    for jr, pr in zip(jrows, prows):
        for key in ("merged", "learner", "fleet", "dead", "broken"):
            assert pr[key] == jr[key], key
        assert pr["slo"] == jr["slo"]
        for src in ("learner", "fleet", "dead", "broken"):
            drop = ("last_scrape_ms", "last_error")
            assert ({k: v for k, v in pr["sources"][src].items() if k not in drop}
                    == {k: v for k, v in jr["sources"][src].items() if k not in drop})
    assert prows[-1]["fleet"]["healthz"] == {"conservation_ok": True}
    assert prows[-1]["sources"]["dead"]["failures"] == 3
    assert "ZeroDivisionError" in prows[-1]["sources"]["broken"]["last_error"]
    pcols.pop("obs/scrape_ms"), jcols.pop("obs/scrape_ms")
    assert pcols == jcols
    assert pcols["obs/scrape_failed_total"] == 6 and pcols["obs/sources_live"] == 2
    assert len(plines) == len(jlines) == 3 and all(r["type"] == "obs" for r in plines)


def test_collector_endpoint_window_hook_and_close():
    """Its own ``/metrics`` and ``/healthz``, a window hook that raises
    without breaking the series, and ``close`` twice."""
    import time
    import urllib.request

    seen = []
    c = p_collector.ObsCollector(interval_s=0.05)
    c.add_source("a", lambda: {"x_total": 1})

    def hook(row):
        seen.append(row["merged"]["x_total"])
        raise RuntimeError("a bad subscriber")

    c.window_hook = hook
    try:
        c.start()
        c.start()
        deadline = time.time() + 10
        while len(seen) < 3 and time.time() < deadline:
            time.sleep(0.02)
        body = json.loads(urllib.request.urlopen(c.address + "/metrics", timeout=5).read())
        health = json.loads(urllib.request.urlopen(c.address + "/healthz", timeout=5).read())
    finally:
        c.close()
        c.close()
    assert seen[:3] == [1, 1, 1] and body["scrapes_total"] >= 3
    assert health == {"ok": True, "sources_live": 1, "sources_total": 1}
    assert not [t for t in threading.enumerate() if t.name == "obs-collector" and t.is_alive()]


def test_actor_span_events_match_jax(tmp_path):
    rec = {"actor_id": 1, "incarnation": 0, "seq": 3, "ts_us": 1000.0, "dur_us": 5.0,
           "span_id": "a1.0.3", "n": 8}
    (tmp_path / "actor1-0.spans.jsonl").write_text(
        json.dumps(rec) + "\n{bad json\n\n" + json.dumps(dict(rec, seq=4, ts_us=2000.0)) + "\n")
    (tmp_path / "x.spans.jsonl").write_text(json.dumps(dict(rec, actor_id="?")) + "\n")
    assert p_trace.actor_span_events(tmp_path) == j_trace.actor_span_events(tmp_path)
    assert p_trace.actor_span_events(tmp_path / "missing") == []


# ------------------------------------------------------------ the trainer

def _obs_config(**kw):
    return SACConfig(history_len=1, hidden_sizes=(8,), batch_size=8, buffer_size=400,
                     epochs=2, steps_per_epoch=40, start_steps=10, update_after=10,
                     update_every=20, **kw)


def _plane_threads():
    return sorted(t.name for t in threading.enumerate()
                  if t.name in ("obs-collector", "obs-http", "warm-pool",
                                "warm-pool-monitor"))


def test_train_obs_writes_the_series_and_obs_columns(tmp_path):
    """``obs=True`` on the host trainer (the numpy pendulum): a
    ``learner`` source scraped into ``<run>/obs.jsonl`` (a row per
    window, the last epoch's columns under ``learner.metrics``), ``obs/``
    columns in every epoch's metrics, the collector's thread and socket
    gone after ``close``."""
    tracker = Tracker(root=str(tmp_path))
    trainer = Trainer("PendulumNumpy-v1", _obs_config(obs=True, obs_interval_s=0.05),
                      tracker=tracker, device="cpu")
    try:
        assert trainer.obs is not None and trainer.obs.port > 0
        trainer.train()
    finally:
        trainer.close()
    assert _plane_threads() == []
    with open(tracker.run_dir / "obs.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert rows and all(r["type"] == "obs" and r["sources"]["learner"]["live"] for r in rows)
    assert rows[-1]["learner"]["metrics"]["env_steps_per_sec"] > 0
    metrics = tracker.metrics()
    assert len(metrics) == 2
    for m in metrics:
        assert {"obs/scrapes_total", "obs/scrape_failed_total", "obs/sources_total",
                "obs/sources_live", "obs/scrape_ms", "obs/slo_breaches_total",
                "obs/slo_active"} <= set(m)
        assert m["obs/sources_total"] == 1 and m["obs/scrape_failed_total"] == 0


def test_train_obs_scrape_extra_and_slo_config(tmp_path):
    """``obs_scrape`` adds a URL source (a dead one is a counted
    failure); ``slo_config`` rules breach on the learner's columns and
    the events reach ``telemetry.jsonl``."""
    rules = tmp_path / "slo.json"
    rules.write_text(json.dumps([{"name": "fast", "path": "learner.metrics.env_steps_per_sec",
                                  "op": "min", "threshold": 1e9, "missing_ok": True},
                                 {"name": "finite", "path": "learner.metrics.loss_q",
                                  "op": "max", "threshold": -1e9, "missing_ok": True}]))
    tracker = Tracker(root=str(tmp_path))
    cfg = _obs_config(obs=True, obs_interval_s=0.05, telemetry=True,
                      obs_scrape="gone=http://127.0.0.1:9", slo_config=str(rules))
    trainer = Trainer("PendulumNumpy-v1", cfg, tracker=tracker, device="cpu")
    try:
        trainer.train()
        names = trainer.obs.source_names()
    finally:
        trainer.close()
    assert names == ("learner", "gone")
    m = tracker.metrics()[-1]
    assert m["obs/sources_total"] == 2 and m["obs/scrape_failed_total"] > 0
    # Arm-on-first-pass: neither rule ever passes, so neither breaches.
    assert m["obs/slo_breaches_total"] == 0
    with open(tracker.run_dir / "telemetry.jsonl") as f:
        types = {json.loads(line)["type"] for line in f}
    assert "slo_breach" not in types and "epoch" in types


def test_obs_off_constructs_nothing(tmp_path):
    """The off-parity contract: with ``obs`` unset the trainer builds no
    collector (no thread, no socket) and no epoch carries an ``obs/``
    key; the run's metric keys are those of a run without the plane."""
    tracker = Tracker(root=str(tmp_path))
    trainer = Trainer("PendulumNumpy-v1", _obs_config(), tracker=tracker, device="cpu")
    try:
        assert trainer.obs is None
        trainer.train()
        assert _plane_threads() == []
    finally:
        trainer.close()
    assert not (tracker.run_dir / "obs.jsonl").exists()
    for m in tracker.metrics():
        assert not [k for k in m if k.startswith("obs/")]


@pytest.mark.parametrize("population,on_device,match", [
    (2, True, "solo host trainer and a host population"), (1, True, "solo host trainer")])
def test_obs_refused_off_the_solo_host_trainer(population, on_device, match):
    """The fused loop refuses the obs plane at any population (JAX's fused
    loop builds no collector); the host trainer runs it at any
    population (:func:`test_train_population_obs_carries_the_member_curves`)."""
    assert on_device
    from torch_actor_critic_tpu_torch.sac.ondevice import (
        train_on_device,
        train_population_on_device,
    )

    train = train_population_on_device if population > 1 else train_on_device
    with pytest.raises(NotImplementedError, match=match):
        train("Pendulum-v1", _obs_config(obs=True, on_device=True, population=population),
              device="cpu")


def test_train_population_obs_carries_the_member_curves(tmp_path):
    """``train --population 2 --obs true`` on the CPU: the collector's
    ``obs.jsonl`` rows carry the learner source's last epoch with each
    member's ``reward_m{i}``, and every epoch's line the ``obs/`` columns."""
    from torch_actor_critic_tpu_torch import train as train_mod

    metrics = train_mod.main([
        "--environment", "PendulumNumpy-v1", "--population", "2", "--obs", "true",
        "--obs-interval-s", "0.05", "--device", "cpu", "--runs-root", str(tmp_path),
        "--hidden-sizes", "8", "--batch-size", "8", "--buffer-size", "400", "--epochs", "2",
        "--steps-per-epoch", "40", "--start-steps", "10", "--update-after", "10",
        "--update-every", "20", "--no-preemption-guard"])
    assert {"reward_m0", "reward_m1", "obs/scrapes_total"} <= set(metrics)
    assert _plane_threads() == []
    (run_dir,) = (tmp_path / "Default").iterdir()
    with open(run_dir / "obs.jsonl") as f:
        rows = [json.loads(line) for line in f]
    learner = [r["learner"]["metrics"] for r in rows if "metrics" in r.get("learner", {})]
    assert learner and {"reward_m0", "reward_m1"} <= set(learner[-1])
    assert learner[-1]["reward_m1"] == metrics["reward_m1"]
