"""The port's training telemetry against the JAX package's, on the CPU:
the phase timer, span ring, JSONL sink (with rotation) and recorder on
one scripted clock (exact: the same arithmetic), ``--profile-epochs``
parsing and the profiler window, and the plane end to end through the
train CLI — the host trainer (sequence and flat SAC, TD3, visual) and
the fused loop at population 1 — with ``--telemetry true --diagnostics
full --profile-epochs --trace-export``; a population refuses it.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from torch_actor_critic_tpu.telemetry import recorder as jrecorder
from torch_actor_critic_tpu.telemetry import sinks as jsinks
from torch_actor_critic_tpu.telemetry.profiler import (
    parse_profile_epochs as j_parse_profile_epochs,
)
from torch_actor_critic_tpu_torch import train as train_mod
from torch_actor_critic_tpu_torch.diagnostics.watchdog import RecompilationWatchdog
from torch_actor_critic_tpu_torch.sac.trainer import Trainer
from torch_actor_critic_tpu_torch.telemetry import (
    PHASES,
    JsonlSink,
    PhaseTimer,
    ProfilerWindow,
    SpanRing,
    TelemetryRecorder,
    device_memory_watermarks,
    format_summary,
    parse_profile_epochs,
)
from torch_actor_critic_tpu_torch.telemetry import traceview
from torch_actor_critic_tpu_torch.utils.config import SACConfig
from torch_actor_critic_tpu_torch.utils.tracking import Tracker


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_time(event):
    return {k: v for k, v in event.items() if k != "time"}


# ------------------------------------------------------------ primitives


@pytest.mark.parametrize("ticks,laps", [
    ([0.0, 1.0, 1.5, 4.0, 4.25, 10.25], [0, 1, 0, 2, None]),
    ([0.0, 0.1, 0.3, 0.3, 2.0, 2.5, 3.0], [2, 2, 1, None, 0, 1]),
])
def test_phase_timer_matches_jax(ticks, laps):
    port_clock, jax_clock = iter(ticks), iter(ticks)
    port = PhaseTimer(3, clock=lambda: next(port_clock))
    ref = jrecorder.PhaseTimer(3, clock=lambda: next(jax_clock))
    for lap in laps:
        if lap is None:
            assert port.mark() == ref.mark()
        else:
            assert port.lap(lap) == ref.lap(lap)
    assert (port.sums, port.counts, port.maxs) == (ref.sums, ref.counts, ref.maxs)
    assert port.stats(("a", "b", "c")) == ref.stats(("a", "b", "c"))


@pytest.mark.parametrize("capacity,n", [(4, 7), (4, 3), (1, 5)])
def test_span_ring_matches_jax(capacity, n):
    port, ref = SpanRing(capacity), jrecorder.SpanRing(capacity)
    for i in range(n):
        port.record(i % 3, float(i), 0.5 * i)
        ref.record(i % 3, float(i), 0.5 * i)
    assert port.spans() == ref.spans() and port.total == ref.total == n
    with pytest.raises(ValueError):
        SpanRing(0)


def test_jsonl_sink_rotation_and_sanitize_match_jax(tmp_path):
    events = [{"type": "epoch", "epoch": i, "x": float("nan") if i % 3 == 0 else i * 0.5,
               "v": [1.0, float("inf")], "pad": "y" * 40} for i in range(12)]
    sinks = {"port": JsonlSink(tmp_path / "p" / "t.jsonl", max_bytes=300),
             "jax": jsinks.JsonlSink(tmp_path / "j" / "t.jsonl", max_bytes=300)}
    for sink in sinks.values():
        for ev in events:
            sink.write(ev)
        sink.close()
    assert sinks["port"].rotations == sinks["jax"].rotations > 0
    assert sinks["port"].events_written == sinks["jax"].events_written
    for suffix in ("", ".1"):
        got = [_no_time(json.loads(x)) for x in
               (tmp_path / "p" / f"t.jsonl{suffix}").read_text().splitlines()]
        want = [_no_time(json.loads(x)) for x in
                (tmp_path / "j" / f"t.jsonl{suffix}").read_text().splitlines()]
        assert got == want


def test_recorder_matches_jax_on_one_clock(tmp_path):
    ticks = [float(i) * 0.25 for i in range(200)]
    port_clock, jax_clock = iter(ticks), iter(ticks)
    port = TelemetryRecorder(run_dir=tmp_path / "p", clock=lambda: next(port_clock),
                             ring_capacity=8)
    ref = jrecorder.TelemetryRecorder(run_dir=tmp_path / "j", clock=lambda: next(jax_clock),
                                      ring_capacity=8)
    for rec in (port, ref):
        for e in range(3):
            rec.epoch_begin(e)
            for phase in (0, 1, 0, 1, 2, 3, 4, 0, 1, 5, 6, 7)[: 6 + 3 * e]:
                rec.lap(phase)
            rec.inc("env_steps", 8)
            rec.event("rollback", epoch=e, rolled_to=e - 1)
            rec.epoch_end(e, extra={"step": 8 * (e + 1)})
        rec.close()
    assert port.snapshot() == ref.snapshot()
    assert port.summary() == ref.summary()
    assert port.ring.spans() == ref.ring.spans()
    got, want = ([_no_time(json.loads(x)) for x in
                  (tmp_path / side / "telemetry.jsonl").read_text().splitlines()]
                 for side in ("p", "j"))
    assert got == want
    assert format_summary(port.run_stats(), port.counters) == jsinks.format_summary(
        ref.run_stats(), ref.counters)
    assert list(PHASES) == list(jrecorder.PHASES)


@pytest.mark.parametrize("spec", [None, "", "3", "1:4", "0:1", "2:2", "-1:3", "a:b", "1:2:3"])
def test_parse_profile_epochs_matches_jax(spec):
    try:
        want = j_parse_profile_epochs(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match="profile-epochs"):
            parse_profile_epochs(spec)
        assert "profile-epochs" in str(e)
    else:
        assert parse_profile_epochs(spec) == want


def test_memory_watermarks_are_none_without_a_card():
    assert device_memory_watermarks() is None


def test_profiler_window_traces_its_epochs_only(tmp_path):
    window = ProfilerWindow((1, 3), tmp_path / "trace")
    x = torch.ones(8)
    for e in range(4):
        window.epoch_begin(e)
        with torch.profiler.record_function(f"epoch_{e}"):
            (x * e).sum()
        window.epoch_end(e)
    window.close()
    assert window.path == str(tmp_path / "trace" / "trace_epochs_1_3.json")
    names = {ev.get("name") for ev in json.loads(open(window.path).read())["traceEvents"]}
    assert {"epoch_1", "epoch_2"} <= names and not names & {"epoch_0", "epoch_3"}
    assert not ProfilerWindow((0, 1), None).enabled  # no run dir: warned and off


def test_trace_export_has_training_and_compile_lanes(tmp_path):
    ticks = iter(float(i) for i in range(50))
    rec = TelemetryRecorder(clock=lambda: next(ticks))
    rec.epoch_begin(0)
    for phase in (0, 1, 4, 5):
        rec.lap(phase)
    rec.epoch_end(0)
    wd = RecompilationWatchdog().install()
    wd.note_capture(0.4, "train/burst")
    wd.note_build(2.0)
    summary = traceview.export_trace(tmp_path / "t.json", traceview.training_events(rec),
                                     traceview.compile_events(wd.compile_log()))
    assert summary["train_spans"] == 4 and summary["compile_spans"] == 2
    names = {e["name"] for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"]}
    assert {"act", "drain", "compile train/burst", "compile kernels/build"} <= names


def test_for_run_builds_the_runs_one_recorder(tmp_path, monkeypatch):
    """``TelemetryRecorder.for_run``: None when nothing asks for one; else
    under the run directory, rotating at ``telemetry_max_mb``, its profile
    window tracing the host alone for a CPU run (no Kineto config set),
    and the timeline written at close."""
    monkeypatch.delenv("KINETO_CONFIG", raising=False)
    tracker = Tracker(experiment="t", root=tmp_path)
    assert TelemetryRecorder.for_run(SACConfig(), tracker) is None
    timeline = tmp_path / "timeline.json"
    rec = TelemetryRecorder.for_run(SACConfig(telemetry_max_mb=1.0), tracker, (0, 1),
                                    str(timeline), "cpu")
    assert rec.sink.max_bytes == 1_000_000
    rec.epoch_begin(0)
    rec.lap(0)
    rec.epoch_end(0)
    rec.close()
    assert (tracker.run_dir / "telemetry.jsonl").exists()
    assert [p.name for p in (tracker.run_dir / "trace").iterdir()] == ["trace_epochs_0_1.json"]
    assert "KINETO_CONFIG" not in os.environ
    lanes = {e["args"]["name"] for e in json.loads(timeline.read_text())["traceEvents"]
             if e["ph"] == "M"}
    assert {"train", "xla-compile"} <= lanes


# ------------------------------------------------------------ the trainer

TINY = dict(hidden_sizes=(16, 16), batch_size=16, epochs=2, steps_per_epoch=40,
            start_steps=10, update_after=10, update_every=10, buffer_size=500, max_ep_len=100)


@pytest.fixture(scope="module")
def off_and_on(tmp_path_factory):
    results = {}
    for mode in ("off", "on"):
        tracker = Tracker(experiment="t", root=tmp_path_factory.mktemp(f"tm_{mode}"))
        trainer = Trainer("PendulumNumpy-v1", SACConfig(**TINY, telemetry=mode == "on"),
                          tracker=tracker, seed=3, device="cpu")
        try:
            metrics = trainer.train()
        finally:
            trainer.close()
        results[mode] = (tracker, metrics, trainer.telemetry)
    return results


def test_telemetry_off_is_none_and_on_adds_only_cost_keys(off_and_on):
    tracker_off, m_off, rec_off = off_and_on["off"]
    tracker_on, m_on, rec_on = off_and_on["on"]
    assert rec_off is None and rec_on is not None
    assert sorted(m_off) == sorted(k for k in m_on if not k.startswith("cost/"))
    assert m_on["cost/update_burst_gflops"] > 0
    assert not (tracker_off.run_dir / "telemetry.jsonl").exists()
    assert (tracker_on.run_dir / "telemetry.jsonl").exists()


def test_epoch_events_partition_the_loop(off_and_on):
    tracker, _, rec = off_and_on["on"]
    events = [json.loads(x) for x in (tracker.run_dir / "telemetry.jsonl").read_text().splitlines()]
    assert events[0]["type"] == "run_start" and events[0]["schema"] == 1
    epochs = [e for e in events if e["type"] == "epoch"]
    assert len(epochs) == TINY["epochs"]
    for ev in epochs:
        assert set(ev["phases"]) == set(PHASES)
        for p in ev["phases"].values():
            assert p["count"] > 0 and 0.0 <= p["max_s"] <= p["total_s"] + 1e-12
        covered = sum(p["total_s"] for p in ev["phases"].values())
        assert 0.8 * ev["wall_s"] <= covered <= 1.1 * ev["wall_s"]
        assert ev["phases"]["act"]["count"] == TINY["steps_per_epoch"]
        assert ev["phases"]["burst_dispatch"]["count"] == (
            TINY["steps_per_epoch"] // TINY["update_every"])
        assert ev["phases"]["checkpoint"]["count"] == 1
        assert ev["attribution"]["class"].endswith("-bound")
        assert "memory" not in ev  # the CPU has no device allocator
    costs = [e for e in events if e["type"] == "cost"]
    assert [c["epoch"] for c in costs] == [0, 1]
    assert costs[0]["programs"]["train/update_burst"]["flops_per_call"] > 0
    assert rec.snapshot()["counters"]["env_steps"] == TINY["epochs"] * TINY["steps_per_epoch"]


def _events(run_dir):
    return [json.loads(x) for x in (run_dir / "telemetry.jsonl").read_text().splitlines()]


SEQ = ["--environment", "PendulumNumpy-v1", "--history-len", "4", "--seq-d-model", "16",
       "--seq-num-heads", "2", "--seq-num-layers", "1"]
FLAT = ["--environment", "PendulumNumpy-v1", "--hidden-sizes", "16,16"]
VISUAL = ["--environment", "PixelPendulumBalanceNumpy-v0", "--filters", "8,8",
          "--kernel-sizes", "4,3", "--strides", "2,2", "--cnn-dense-size", "32",
          "--cnn-features", "16", "--hidden-sizes", "16,16", "--normalize-pixels", "true",
          "--frame-augment", "shift", "--pixel-pipeline", "fused"]


@pytest.mark.parametrize("stack,extra", [
    (SEQ, []), (FLAT, ["--algorithm", "td3"]), (VISUAL, ["--learn-alpha", "true"]),
])
def test_train_cli_runs_the_plane(tmp_path, stack, extra):
    """``train --telemetry true --diagnostics full --profile-epochs 0:1
    --trace-export`` on the host trainer: every epoch's eight phases, one
    cost event per update epoch, a diagnostics event whose |TD| counts
    cover every update's batch and heads, a trace of epoch 0 under the
    run, and the timeline's training lane."""
    trace = tmp_path / "timeline.json"
    batch, window, updates_per_epoch = 8, 10, 4 * 10  # every window past step 5
    train_mod.main([*stack, *extra, "--device", "cpu", "--runs-root", str(tmp_path),
                    "--epochs", "2", "--steps-per-epoch", "40", "--start-steps", "10",
                    "--update-after", "5", "--update-every", str(window),
                    "--batch-size", str(batch), "--buffer-size", "400",
                    "--telemetry", "true", "--diagnostics", "full",
                    "--profile-epochs", "0:1", "--trace-export", str(trace),
                    "--no-preemption-guard"])
    (run_dir,) = (tmp_path / "Default").iterdir()
    events = _events(run_dir)
    epochs = [e for e in events if e["type"] == "epoch"]
    assert [set(e["phases"]) for e in epochs] == [set(PHASES)] * 2
    assert [e["epoch"] for e in events if e["type"] == "cost"] == [0, 1]
    diags = [e for e in events if e["type"] == "diagnostics"]
    assert [d["epoch"] for d in diags] == [0, 1]
    # The run's histogram: every update's batch and both critic heads so far.
    assert diags[0]["td_hist"]["td_abs_count"] == updates_per_epoch * batch * 2
    assert diags[1]["td_hist"]["td_abs_count"] == 2 * updates_per_epoch * batch * 2
    assert {"diag/grad_norm_q", "diag/q_bias", "diag/param_norm"} <= set(diags[1]["metrics"])
    traces = list((run_dir / "trace").glob("trace_epochs_0_1.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]
    timeline = json.loads(trace.read_text())["traceEvents"]
    lanes = {e["args"]["name"] for e in timeline if e["ph"] == "M"}
    assert {"train", "xla-compile"} <= lanes
    assert {e["name"] for e in timeline if e.get("pid") == traceview.TRAIN_PID
            and e["ph"] == "B"} >= {"act", "env_step", "burst_dispatch", "drain"}
    metrics = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert metrics[-1]["watchdog_captures"] == 0  # the CPU captures no graph


def test_fused_loop_runs_the_plane_at_population_one(tmp_path):
    trace = tmp_path / "timeline.json"
    train_mod.main([*SEQ[:2], "--environment", "Pendulum-v1", "--on-device", "true",
                    "--history-len", "4", "--seq-d-model", "16", "--seq-num-heads", "2",
                    "--seq-num-layers", "1", "--device", "cpu", "--runs-root", str(tmp_path),
                    "--epochs", "2", "--steps-per-epoch", "40", "--update-every", "20",
                    "--start-steps", "20", "--on-device-envs", "2", "--batch-size", "8",
                    "--buffer-size", "500", "--telemetry", "true", "--diagnostics", "full",
                    "--profile-epochs", "1:2", "--trace-export", str(trace)])
    (run_dir,) = (tmp_path / "Default").iterdir()
    events = _events(run_dir)
    epochs = [e for e in events if e["type"] == "epoch"]
    assert [e["epoch"] for e in epochs] == [0, 1]
    assert {"burst_dispatch", "drain", "checkpoint"} <= set(epochs[0]["phases"])
    costs = [e for e in events if e["type"] == "cost"]
    assert costs and costs[0]["programs"]["train/ondevice_epoch"]["flops_per_call"] > 0
    diags = [e for e in events if e["type"] == "diagnostics"]
    # Two windows of 20 updates an epoch, batch 8, two critic heads.
    assert [d["td_hist"]["td_abs_count"] for d in diags] == [2 * 20 * 8 * 2, 2 * 2 * 20 * 8 * 2]
    assert (run_dir / "trace" / "trace_epochs_1_2.json").exists()
    assert json.loads(trace.read_text())["traceEvents"]


@pytest.mark.parametrize("argv", [
    ["--population", "2", "--telemetry", "true"],
    ["--population", "2", "--diagnostics", "light"],
    ["--population", "2", "--trace-export", "x.json"],
    ["--population", "2", "--on-device", "true", "--profile-epochs", "0:1"],
    ["--population", "2", "--on-device", "true", "--diagnostics", "full"],
], ids=["host-telemetry", "host-diagnostics", "host-trace-export", "fused-profile",
        "fused-diagnostics"])
def test_populations_run_the_plane(tmp_path, caplog, argv):
    """Each flag a population used to refuse, through the CLI: the host
    population's epoch and cost events, its per-member-reduced
    ``diag/*`` columns and its timeline; the fused population's profile
    window, and its ``--diagnostics`` at ``off`` with JAX's warning."""
    fused = "--on-device" in argv
    argv = [a.replace("x.json", str(tmp_path / "x.json")) for a in argv]
    with caplog.at_level(logging.WARNING):
        metrics = train_mod.main([
            "--environment", "Pendulum-v1" if fused else "PendulumNumpy-v1",
            "--hidden-sizes", "8,8", "--device", "cpu", "--runs-root", str(tmp_path),
            "--epochs", "1", "--steps-per-epoch", "20", "--start-steps", "10",
            "--update-after", "5", "--update-every", "10", "--batch-size", "8",
            "--buffer-size", "200", "--on-device-envs", "2", "--no-preemption-guard", *argv])
    (run_dir,) = (tmp_path / "Default").iterdir()
    if fused:
        assert {"loss_q_m0", "loss_q_m1"} <= set(metrics)
    else:
        assert {"reward_m0", "reward_m1"} <= set(metrics)
    flag = argv[-2]
    if flag in ("--telemetry", "--trace-export", "--profile-epochs"):
        events = _events(run_dir)
        assert [e["epoch"] for e in events if e["type"] == "epoch"] == [0]
        cost = next(e for e in events if e["type"] == "cost")
        name = "train/population_epoch" if fused else "train/update_burst"
        assert cost["programs"][name]["flops_per_call"] > 0
    if flag == "--trace-export":
        assert json.loads((tmp_path / "x.json").read_text())["traceEvents"]
    if flag == "--profile-epochs":
        assert (run_dir / "trace" / "trace_epochs_0_1.json").exists()
    if flag == "--diagnostics" and not fused:
        assert metrics["diag/grad_norm_q"] > 0 and metrics["diag/param_norm"] > 0
        assert "diag/grad_norm_q_m0" not in metrics  # reduced over members, as JAX
    if flag == "--diagnostics" and fused:
        assert not [k for k in metrics if k.startswith("diag/")]
        assert "--diagnostics full on the fused population" in caplog.text
        assert "running at diagnostics=off" in caplog.text


def test_cli_routes_population_fused_and_emits_pbt_events(tmp_path):
    """The JAX test of the same name, through the port's CLI on the CPU:
    per-member metrics, a schema-valid ``pbt`` event per PBT step (its
    ``exploited`` the members whose ``src`` is another), the population
    epoch's cost, and a ``--run`` resume."""
    args = [
        "--environment", "Pendulum-v1", "--on-device", "true", "--population", "2",
        "--pbt-every", "1", "--pbt-quantile", "0.5", "--telemetry", "true",
        "--device", "cpu", "--runs-root", str(tmp_path), "--epochs", "2",
        "--steps-per-epoch", "100", "--update-every", "20", "--start-steps", "20",
        "--update-after", "0", "--batch-size", "8", "--buffer-size", "400",
        "--hidden-sizes", "16,16", "--on-device-envs", "2",
    ]
    metrics = train_mod.main(args)
    assert "loss_q_m0" in metrics and "loss_q_m1" in metrics
    (run_dir,) = (tmp_path / "Default").iterdir()
    events = _events(run_dir)
    pbt = [e for e in events if e.get("type") == "pbt"]
    assert [e["epoch"] for e in pbt] == [0, 1]
    for e in pbt:
        assert {"epoch", "exploited", "src", "ready", "return_ema", "hyperparams"} <= set(e)
        assert len(e["src"]) == 2 and len(e["return_ema"]) == 2
        assert e["exploited"] == [i for i, s in enumerate(e["src"]) if s != i]
        assert set(e["hyperparams"]) == {"actor_lr", "critic_lr", "alpha"}
        assert all(len(v) == 2 for v in e["hyperparams"].values())
    # The twin's 200-step episodes first end in epoch 1: both members are
    # ranked then, so its step exploits one member.
    assert not pbt[0]["ready"] and pbt[0]["exploited"] == []
    assert pbt[1]["ready"] and len(pbt[1]["exploited"]) == 1
    epochs = [e for e in events if e["type"] == "epoch"]
    assert [e["env_steps"] for e in epochs] == [100 * 2 * 2] * 2  # every member's envs
    assert all(e["programs"]["train/population_epoch"]["flops_per_call"] > 0
               for e in events if e["type"] == "cost")
    resumed = train_mod.main(["--run", run_dir.name, "--runs-root", str(tmp_path),
                              "--device", "cpu"])
    assert "loss_q_m0" in resumed
    pbt = [e for e in _events(run_dir) if e.get("type") == "pbt"]
    assert [e["epoch"] for e in pbt] == [0, 1, 2, 3]


def test_cost_and_diagnostic_keys_reach_metrics_jsonl(tmp_path):
    """The metrics a tier adds are plain floats in ``metrics.jsonl``; the
    |TD| histogram stays in ``telemetry.jsonl``."""
    train_mod.main([*FLAT, "--device", "cpu", "--runs-root", str(tmp_path), "--epochs", "1",
                    "--steps-per-epoch", "30", "--start-steps", "10", "--update-after", "5",
                    "--update-every", "10", "--batch-size", "8", "--buffer-size", "200",
                    "--diagnostics", "light", "--no-preemption-guard"])
    (run_dir,) = (tmp_path / "Default").iterdir()
    row = json.loads((run_dir / "metrics.jsonl").read_text().splitlines()[-1])
    assert "diag/td_hist" not in row and "diag/td_abs_sum" not in row
    assert np.isfinite(row["diag/grad_norm_q"]) and np.isfinite(row["diag/update_ratio_pi"])
    assert row["early_warnings"] == 0 and not (run_dir / "telemetry.jsonl").exists()


def test_profile_flag_traces_the_whole_run(tmp_path):
    """``--profile DIR``: one ``torch.profiler`` Chrome trace of the whole
    run in ``DIR/trace.json``, with telemetry off."""
    train_mod.main([*FLAT, "--device", "cpu", "--runs-root", str(tmp_path / "runs"),
                    "--epochs", "1", "--steps-per-epoch", "20", "--start-steps", "5",
                    "--update-after", "5", "--update-every", "10", "--batch-size", "8",
                    "--buffer-size", "100", "--profile", str(tmp_path / "prof"),
                    "--no-preemption-guard"])
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::addmm") for e in events)
    (run_dir,) = (tmp_path / "runs" / "Default").iterdir()
    assert not (run_dir / "telemetry.jsonl").exists()
