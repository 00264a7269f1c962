"""The port's elastic serving plane (``elastic/``, ``aot/prefork.py``)
against the JAX package's, on the CPU.

- ``ElasticController`` and ``DecisionLog``: the same window sequences
  through both packages' controllers, over the same fake actuator and
  one injected clock, give the same decisions (records without their
  clock fields), counts and snapshots.
- ``WarmPool``: the cases of ``tests/test_aot.py`` (zero size inert,
  spawn failures counted, draws refilled, spares reaped on shutdown).
- ``FleetScaler`` over the port's own router, with in-process port
  ``PolicyServer`` workers: scale-out admits a drawn worker and adds its
  obs source; scale-in drains before it terminates, and no accepted
  request is lost under load.
- The serve CLI end to end: ``--fleet 2 --obs --warm-pool 1 --elastic
  on`` at a small width scales out on a shed-rate breach (the warm
  spare drawn in) and back in once the sheds stop, losing no accepted
  request; with the flags off nothing of the plane exists.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_actor_critic_tpu.aot.prefork import WarmPool as JWarmPool
from torch_actor_critic_tpu.elastic import controller as j_controller
from torch_actor_critic_tpu_torch.aot import WarmPool, WarmWorker
from torch_actor_critic_tpu_torch.elastic import (
    DECISION_FIELDS,
    DecisionLog,
    ElasticController,
    ElasticPolicy,
    FleetScaler,
)
from torch_actor_critic_tpu_torch.elastic import controller as p_controller
from torch_actor_critic_tpu_torch.models import build_actor
from torch_actor_critic_tpu_torch.serve import ModelRegistry, PolicyServer
from torch_actor_critic_tpu_torch.serve.__main__ import check_ported, parse_arguments
from torch_actor_critic_tpu_torch.serve.engine import ObsSpec
from torch_actor_critic_tpu_torch.serve.router import FleetRouter
from torch_actor_critic_tpu_torch.utils.checkpoint import save_actor
from torch_actor_critic_tpu_torch.utils.config import SACConfig

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def wait_until(pred, timeout=60.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


# ----------------------------------------------------------- controller

class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _ev(kind, rule):
    return {"type": kind, "rule": rule, "path": "x", "op": "min", "mode": "value",
            "threshold": 1.0, "value": 0.0, "window": 1}


class _FakeActuator:
    """Replica arithmetic with scripted outcomes: ``no_spare`` while
    ``spares`` is 0, else ``spawned``."""

    def __init__(self, replicas=2, depth=0.0, spares=99):
        self._replicas = replicas
        self.depth = depth
        self.spares = spares

    def replicas(self):
        return self._replicas

    def queue_depth(self):
        return self.depth

    def scale_out(self, reason=""):
        if self.spares == 0:
            return {"outcome": "no_spare"}
        self.spares -= 1
        self._replicas += 1
        return {"outcome": "spawned", "worker": f"w{self._replicas - 1}"}

    def scale_in(self, reason=""):
        self._replicas -= 1
        return {"outcome": "draining", "worker": f"w{self._replicas}"}


B, R = "slo_breach", "slo_recovered"
# (clock advance, events, queue depth, spares) per window
SCRIPTS = {
    "out_then_in": [(1, [], 0, 9), (1, [(B, "shed_rate_ceiling")], 0, 9), (1, [], 0, 9),
                    (1, [(R, "shed_rate_ceiling")], 0, 9), (1, [], 0, 9), (1, [], 0, 9),
                    (31, [], 0, 9), (1, [], 0, 9), (1, [], 0, 9), (1, [], 0, 9)],
    "cooldown_per_rule": [(1, [(B, "p99_ceiling")], 0, 9), (1, [], 0, 9),
                          (1, [(B, "goodput_floor")], 0, 9), (5, [], 0, 9), (6, [], 0, 9),
                          (1, [(R, "p99_ceiling"), (R, "goodput_floor")], 0, 9)],
    "bounded_at_max": [(1, [(B, "shed_rate_ceiling")], 0, 9)] + [(11, [], 0, 9)] * 4,
    "no_spare_backoff": [(1, [(B, "p99_ceiling")], 0, 0), (1, [], 0, 0), (1.5, [], 0, 1),
                         (1, [], 0, 1), (10.5, [], 0, 1)],
    "unlisted_rule_blocks_scale_in": [(1, [(B, "conservation_ok")], 0, 9)]
                                     + [(40, [], 0, 9)] * 4,
    "watermark_blocks_scale_in": [(40, [], 5.0, 9)] * 4 + [(40, [], 0.5, 9)] * 3,
}


def _run_script(mod, script, replicas=2, **policy):
    clock = _Clock()
    act = _FakeActuator(replicas=replicas)
    log = mod.DecisionLog()
    pol = dict(min_replicas=1, max_replicas=4, scale_out_cooldown_s=10.0,
               scale_in_cooldown_s=30.0, scale_in_ok_windows=3, queue_low_watermark=1.0)
    pol.update(policy)
    ctl = mod.ElasticController(act, policy=mod.ElasticPolicy(**pol), log=log, clock=clock)
    decisions = []
    for advance, events, depth, spares in script:
        clock.t += advance
        act.depth, act.spares = depth, spares
        out = ctl.observe_window({"type": "obs", "slo": {"events": [
            _ev(kind, rule) for kind, rule in events]}})
        decisions.append([{k: v for k, v in d.items() if k not in ("time", "t0", "dur_s")}
                          for d in out])
    snap = ctl.snapshot()
    return decisions, snap, log.counts()


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_controller_decides_as_jax(case):
    policy = {"max_replicas": 3} if case == "bounded_at_max" else {}
    got = _run_script(p_controller, SCRIPTS[case], **policy)
    want = _run_script(j_controller, SCRIPTS[case], **policy)
    assert got == want
    decisions, snap, counts = got
    if case == "out_then_in":
        actions = [d["action"] for window in decisions for d in window]
        assert actions == ["scale_out", "scale_in", "scale_in"]
        assert snap["replicas"] == 1 and counts["decisions_total"] == 3
    if case == "bounded_at_max":
        assert snap["bounded_total"] >= 1


def test_decision_log_schema_and_telemetry():
    events = []

    class _Rec:
        def event(self, kind, **fields):
            events.append((kind, fields))

    log = DecisionLog(capacity=2, telemetry=_Rec())
    for i in range(3):
        rec = log.record("scale_out", "serve", f"slo_breach:r{i}", rule=f"r{i}",
                         replicas_before=i, replicas_after=i + 1,
                         outcome="ok" if i else "no_spare", worker=f"w{i}")
        assert set(DECISION_FIELDS) <= set(rec) and rec["worker"] == f"w{i}"
    assert [r["seq"] for r in log.records()] == [2, 3]
    assert log.counts() == {"scale_out": 3, "scale_out_no_spare": 1, "decisions_total": 3}
    assert [k for k, _ in events] == ["elastic_decision"] * 3
    assert "t0" not in events[0][1]
    with pytest.raises(ValueError, match="unknown elastic action"):
        log.record("explode", "serve", "x")
    for bad in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
                dict(scale_in_ok_windows=0), dict(scale_in_cooldown_s=-1)):
        with pytest.raises(ValueError):
            ElasticPolicy(**bad)
        with pytest.raises(ValueError):
            j_controller.ElasticPolicy(**bad)


def test_actuator_fault_is_contained():
    class _Broken(_FakeActuator):
        def scale_out(self, reason=""):
            raise RuntimeError("spawn exploded")

    ctl = ElasticController(_Broken(), clock=_Clock())
    assert ctl.observe_window({"slo": {"events": [_ev(B, "p99_ceiling")]}}) == []


# ------------------------------------------------------------ warm pool

@pytest.mark.parametrize("pool_cls", [WarmPool, JWarmPool], ids=["port", "jax"])
def test_warm_pool_cases(pool_cls):
    """Zero size inert; a failed spawn counted and retried; a draw
    refilled behind; unclaimed spares reaped on shutdown; draws refused
    after it."""
    zero = pool_cls(lambda: (_ for _ in ()).throw(AssertionError("spawned")),
                    lambda h: None, size=0)
    assert zero.draw() is None and zero.stats()["spawned"] == 0
    zero.shutdown()
    zero.shutdown()
    attempts, killed = [], []

    def flaky_spawn():
        attempts.append(1)
        if len(attempts) == 1:
            raise RuntimeError("boom")
        return len(attempts), f"inproc://{len(attempts)}"

    pool = pool_cls(flaky_spawn, killed.append, size=2)
    try:
        first = pool.draw(timeout=60)
        assert first is not None and first.address.startswith("inproc://")
        wait_until(lambda: pool.stats()["ready"] == 2, msg="refill")
        stats = pool.stats()
        assert (stats["spawn_failures"], stats["drawn"], stats["size"]) == (1, 1, 2)
        assert stats["spawned"] == 3 and stats["last_refill_ok"] is True
    finally:
        pool.shutdown()
    assert len(killed) == 2 and first.handle not in killed
    assert pool.draw(timeout=0.1) is None


def test_warm_pool_stats_keys_match_jax():
    port, jax_ = WarmPool(lambda: (1, "x"), lambda h: None, size=0), \
        JWarmPool(lambda: (1, "x"), lambda h: None, size=0)
    assert port.stats() == jax_.stats()
    assert WarmWorker(1, "a") == (1, "a")


# -------------------------------------------- the scaler over the router

OBS_DIM, ACT_DIM = 5, 2


def _worker():
    """One in-process port worker: a tiny flat actor served on the CPU."""
    cfg = SACConfig(hidden_sizes=(8, 8))
    actor = build_actor(cfg, (OBS_DIM,), ACT_DIM, 1.0,
                        generator=torch.Generator().manual_seed(0))
    reg = ModelRegistry(device="cpu")
    reg.register("default", actor, ObsSpec((OBS_DIM,)),
                 params={k: v.detach().clone() for k, v in actor.state_dict().items()},
                 max_batch=4, warmup=False)
    return PolicyServer(reg, port=0, max_batch=4, max_wait_ms=1.0).start()


class _FakeObs:
    def __init__(self):
        self.sources = {}

    def add_source(self, name, source):
        self.sources[name] = source

    def remove_source(self, name):
        self.sources.pop(name, None)


def _post(url, body, timeout=30.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def test_scaler_over_the_port_router_scales_out_and_in_without_loss():
    """Scale-out draws a warm in-process worker, admits it through the
    port's router and registers its obs source; scale-in of the newest
    worker under three clients' load holds it out of rotation, drains it
    (terminate = the server's own drain), reaps it, and every request is
    answered."""
    w0, w1, spare = _worker(), _worker(), _worker()
    servers = [w0, w1, spare]
    router = FleetRouter([w0.address, w1.address], poll_interval_s=30.0)
    router.poll_once()
    router.start()
    obs = _FakeObs()
    order = []

    def terminate(srv):
        order.append("terminate")
        srv.drain()
        srv.close()

    scaler = FleetScaler(
        router, WarmPool(lambda: (spare, spare.address), lambda h: None, size=1),
        obs=obs, terminate=terminate, wait_exit=lambda srv, timeout: True,
        force_kill=lambda srv: None,
        on_drain_select=lambda name, h: order.append(("disown", name)))
    scaler.register("w0", w0, w0.address)
    scaler.register("w1", w1, w1.address)
    body = {"obs": np.ones((OBS_DIM,), np.float32).tolist()}
    errors, answered, stop = [], [0], threading.Event()

    def load():
        while not stop.is_set():
            try:
                out = _post(router.address + "/act", body)
                assert len(out["action"]) == ACT_DIM
                answered[0] += 1
            except Exception as e:  # noqa: BLE001 — recorded, asserted
                errors.append(repr(e))

    herd = [threading.Thread(target=load) for _ in range(3)]
    try:
        out = scaler.scale_out(reason="slo_breach:shed_rate_ceiling")
        assert out["outcome"] == "spawned" and out["worker"] == "w2"
        assert scaler.replicas() == 3 and "w2" in obs.sources
        assert router.membership()["admitted_workers"] == 3
        for th in herd:
            th.start()
        wait_until(lambda: answered[0] >= 10, msg="load flowing")
        out = scaler.scale_in(reason="ok_windows:2")
        assert out == {"outcome": "draining", "worker": "w2", "address": spare.address}
        assert order == [("disown", "w2"), "terminate"]
        wait_until(lambda: "w2" not in router.membership()["workers"], msg="reap")
        before = answered[0]
        wait_until(lambda: answered[0] >= before + 10, msg="survivors serving")
        stop.set()
        for th in herd:
            th.join(timeout=30)
        assert errors == []
        assert scaler.replicas() == 2 and "w2" not in obs.sources
        assert scaler.stats() == {"workers": 2, "draining": 0, "spawned_total": 1,
                                  "drained_total": 1, "no_spare_total": 0,
                                  "force_kills_total": 0}
    finally:
        stop.set()
        scaler.shutdown()
        scaler.pool.shutdown()
        router.close()
        for srv in servers:
            try:
                srv.close()
            except Exception:  # noqa: BLE001 — the victim is closed already
                pass


def test_router_has_no_fleet_key_unless_extra_attached():
    w0 = _worker()
    router = FleetRouter([w0.address], poll_interval_s=30.0).start()
    try:
        router.poll_once()
        assert "fleet" not in router.aggregate_metrics()
        router.fleet_extra = lambda: {"warm_pool": {"ready": 1}}
        assert router.aggregate_metrics()["fleet"] == {"warm_pool": {"ready": 1}}
        router.fleet_extra = lambda: 1 / 0
        assert "fleet" not in router.aggregate_metrics()
    finally:
        router.close()
        w0.close()


# ------------------------------------------------------- the CLI end to end

def _serve_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "torch_actor_critic_tpu_torch.serve", *args], cwd=REPO,
        env=env, text=True, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)


def _metrics(url):
    return json.loads(urllib.request.urlopen(url + "/metrics", timeout=30).read())


def _children(pid):
    out = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                        out.append(int(entry))
            except (OSError, ValueError, IndexError):
                pass
    return out


def _kill_fleet(proc, children):
    """A failed test's cleanup: the fleet's children found before its
    parent is killed (they outlive it otherwise), then all of them."""
    if proc.poll() is None:
        children = set(children) | set(_children(proc.pid))
        proc.kill()
        proc.wait(timeout=30)
    for pid in children:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    proc.stdout.close()


def test_cli_fleet_scales_out_and_in_with_no_request_lost(tmp_path):
    """``serve --fleet 2 --obs --slo-config R --warm-pool 1 --elastic on
    --elastic-min 2`` on the CPU, a sequence policy at a small width:
    bursts of 96 concurrent requests overflow ``--queue-capacity 4``
    (the group batcher holds queued requests up to 20 ms; two steady
    clients alone never can), the ``shed_rate_ceiling`` rule (delta
    mode) breaches and the controller draws the warm spare (replicas 2
    -> 3); quiet windows recover the rule and the newest worker drains
    (3 -> 2). The elastic lane of the trace export holds both decisions.
    The steady clients lose nothing; the bursts' rejections are 429s.
    SIGTERM exits 0 and leaves no worker behind."""
    cfg = SACConfig(history_len=4, seq_d_model=16, seq_num_heads=2, seq_num_layers=1)
    ckpt = tmp_path / "ckpt"
    save_actor(str(ckpt), 1, build_actor(cfg, (4, 3), 1, 2.0,
                                         generator=torch.Generator().manual_seed(0)), cfg)
    rules = tmp_path / "slo.json"
    rules.write_text(json.dumps([{
        "name": "shed_rate_ceiling", "path": "router.sheds_total", "op": "max",
        "threshold": 0, "mode": "delta", "breach_windows": 1, "recover_windows": 2}]))
    trace = tmp_path / "trace.json"
    proc = _serve_cli(
        "--ckpt-dir", str(ckpt), "--obs-dim", "3", "--act-dim", "1", "--act-limit", "2.0",
        "--device", "cpu", "--port", "0", "--poll-interval", "0", "--max-batch", "4",
        "--queue-capacity", "4", "--batch-mode", "group", "--max-wait-ms", "20",
        "--fleet", "2", "--router-poll", "0.2", "--obs",
        "--obs-interval", "0.3", "--slo-config", str(rules), "--warm-pool", "1",
        "--elastic", "on", "--elastic-min", "2", "--elastic-max", "3",
        "--elastic-out-cooldown", "1", "--elastic-in-cooldown", "2",
        "--elastic-in-windows", "2", "--trace-export", str(trace))
    children = []
    try:
        ready = json.loads(proc.stdout.readline())
        router = ready["router"]
        assert ready["elastic"] == "on" and ready["obs"].startswith("http://")
        wait_until(lambda: _metrics(router)["fleet"]["warm_pool"]["ready"] == 1,
                   timeout=120, msg="the warm spare")
        body = {"obs": np.zeros((2, 4, 3), np.float32).tolist()}
        errors, answered, sheds, stop = [], [0], [0], threading.Event()

        def steady():
            # A 429 is a rejection before acceptance (the client retries,
            # as its Retry-After says); anything else is a lost request.
            while not stop.is_set():
                try:
                    assert len(_post(router + "/act", body)["action"]) == 2
                    answered[0] += 1
                except urllib.error.HTTPError as e:
                    if e.code != 429:
                        errors.append(f"steady HTTP {e.code}")
                except Exception as e:  # noqa: BLE001 — recorded, asserted
                    errors.append(repr(e)[:200])
                time.sleep(0.01)

        def burst_one():
            try:
                _post(router + "/act", body)
            except urllib.error.HTTPError as e:
                if e.code == 429:
                    sheds[0] += 1
                else:
                    errors.append(f"burst HTTP {e.code}")
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e)[:200])

        def elastic():
            return _metrics(router)["fleet"]["elastic"]

        herd = [threading.Thread(target=steady) for _ in range(2)]
        for th in herd:
            th.start()
        deadline = time.time() + 60
        while elastic()["scale_out_total"] == 0 and time.time() < deadline:
            shots = [threading.Thread(target=burst_one) for _ in range(96)]
            for th in shots:
                th.start()
            for th in shots:
                th.join(timeout=60)
            time.sleep(0.5)
        assert elastic()["scale_out_total"] == 1 and sheds[0] > 0, sheds
        wait_until(lambda: elastic()["scale_in_total"] == 1, timeout=60, msg="scale-in")
        wait_until(lambda: len(_metrics(router)["router"]["workers"]) == 2, timeout=60,
                   msg="the victim removed")
        stop.set()
        for th in herd:
            th.join(timeout=60)
        assert errors == [] and answered[0] > 0
        fleet = _metrics(router)["fleet"]
        assert fleet["scaler"]["spawned_total"] == 1 and fleet["scaler"]["drained_total"] == 1
        assert fleet["elastic"]["replicas"] == 2 and fleet["warm_pool"]["drawn"] == 1
        obs = json.loads(urllib.request.urlopen(ready["obs"] + "/metrics", timeout=30).read())
        rule = obs["slo"]["rules"]["shed_rate_ceiling"]
        assert rule["breaches_total"] >= 1 and rule["recoveries_total"] >= 1
        children = _children(proc.pid)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
        for pid in children:
            wait_until(lambda: not os.path.exists(f"/proc/{pid}"), timeout=30,
                       msg=f"worker {pid} gone")
    finally:
        _kill_fleet(proc, children)
    spans = [e for e in json.loads(trace.read_text())["traceEvents"]
             if e.get("name", "").startswith("elastic ") and e.get("ph") in ("B", "X")]
    moves = [(e["args"]["action"], e["args"]["replicas_before"], e["args"]["replicas_after"])
             for e in spans]
    assert moves == [("scale_out", 2, 3), ("scale_in", 3, 2)]


def test_cli_flags_off_construct_nothing(tmp_path):
    """``--fleet 2`` with the plane's flags off: the startup line names
    no pool and no collector, and the router's /metrics has no ``fleet``
    key (JAX's off-parity contract)."""
    cfg = SACConfig(hidden_sizes=(8,))
    ckpt = tmp_path / "ckpt"
    save_actor(str(ckpt), 1, build_actor(cfg, (3,), 1, 2.0,
                                         generator=torch.Generator().manual_seed(0)), cfg)
    proc = _serve_cli("--ckpt-dir", str(ckpt), "--obs-dim", "3", "--act-dim", "1",
                      "--device", "cpu", "--port", "0", "--poll-interval", "0",
                      "--max-batch", "2", "--fleet", "2", "--router-poll", "0.2")
    try:
        ready = json.loads(proc.stdout.readline())
        assert (ready["warm_pool"], ready["obs"], ready["elastic"]) == (None, None, "off")
        agg = _metrics(ready["router"])
        assert "fleet" not in agg and agg["workers_reporting"] == 2
        worker = _metrics(next(iter(ready["workers"].values())))
        assert worker["xla"]["captures_total"] == 0 and worker["costs"] == {}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    finally:
        _kill_fleet(proc, [])


@pytest.mark.parametrize("argv,message", [
    (["--elastic", "on", "--fleet", "2"], "needs --obs"),
    (["--elastic", "on", "--obs", "--fleet", "2"], "--warm-pool >= 1"),
    (["--obs"], "pass --fleet N"),
    (["--slo-config", "r.json", "--fleet", "2"], "needs --obs"),
    (["--obs", "--obs-interval", "0", "--fleet", "2"], "--obs-interval"),
])
def test_cli_plane_flags_validate(argv, message):
    with pytest.raises(SystemExit, match=message.replace("-", r"\-")):
        check_ported(parse_arguments(argv))
