"""The port's actor-process fleet (``decoupled/transport.py``,
``decoupled/fleet.py``, ``elastic/training.py``) against the JAX
package's, on the CPU.

- The ``/stage`` wire codec both ways: a JAX encode decodes bitwise in
  the port and the reverse, for flat and ``MultiObservation``
  observations, and both packages encode a transition to the same bytes.
- Over a real socket, a JAX ``RemoteStagingClient`` pushes to the port's
  ``StagingTransportServer`` and the port's client to the JAX server:
  accept, dedup of a retried push, 410 for a superseded incarnation, 400
  for a malformed body, conservation green.
- The transport's own contract on the port (dedup and seq audit, zombie
  fence and purge, 503/429, poison pushes, heartbeats, the checkpoint
  bridge) and the client's retry contract; ``FlakyTransport`` drops the
  calls JAX's drops under the same seed.
- ``FleetSupervisor``'s restart, deadline, backoff and give-up schedule
  and ``TrainingElasticManager``'s decisions equal JAX's under one
  injected clock and RNG.
- ``FleetTrainer`` with thread-backed actors (``spawn=``): trains through
  an actor death with the invariant intact (every audit read from ONE
  transport snapshot), resumes with its watermarks and deduplicates a
  push retried across the restart, and with ``elastic="on"`` degrades a
  slot past its budget and re-admits it at the next epoch.
- Real processes in two tests, each with its own time limit:
  ``kill_actor`` on spawned processes, and ``train --actors 1 --elastic
  on`` through the CLI (actor processes that never touch a card).

Everything compared across packages is compared exactly (bytes, counts,
schedules); nothing here has a float tolerance.
"""

import itertools
import json
import random
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from urllib import error as urlerr
from urllib import request as urlreq

import numpy as np
import pytest
import torch

from torch_actor_critic_tpu.core.types import MultiObservation as JMulti
from torch_actor_critic_tpu.decoupled import fleet as j_fleet
from torch_actor_critic_tpu.decoupled import staging as j_staging
from torch_actor_critic_tpu.decoupled import transport as j_transport
from torch_actor_critic_tpu.elastic import controller as j_controller
from torch_actor_critic_tpu.elastic import training as j_training
from torch_actor_critic_tpu.resilience import faultinject as j_fault
from torch_actor_critic_tpu_torch.core.types import MultiObservation
from torch_actor_critic_tpu_torch.decoupled import (
    FleetSupervisor,
    FleetTrainer,
    RemoteStagingClient,
    StagingBuffer,
    StagingTransportServer,
    StagingUnavailable,
)
from torch_actor_critic_tpu_torch.decoupled.fleet import _actor_loop
from torch_actor_critic_tpu_torch.decoupled.transport import (
    canonical_transition,
    decode_transition,
    encode_transition,
)
from torch_actor_critic_tpu_torch.elastic import DecisionLog, TrainingElasticManager
from torch_actor_critic_tpu_torch.resilience.faultinject import (
    FaultyEnvPool,
    FlakyTransport,
    kill_actor,
)
from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer
from torch_actor_critic_tpu_torch.utils.config import SACConfig

REPO = Path(__file__).resolve().parent.parent
ENV = "PendulumNumpy-v1"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Spec:
    """Minimal array obs spec (shape + dtype), as envs expose."""

    def __init__(self, shape, dtype=np.float32):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)


SPEC = _Spec((3,))
N_ENVS = 2
ACT_DIM = 1


def txn(i, n_envs=N_ENVS, obs_dim=3, act_dim=ACT_DIM):
    rng = np.random.default_rng(i)
    return (
        rng.standard_normal((n_envs, obs_dim)).astype(np.float32),
        rng.standard_normal((n_envs, act_dim)).astype(np.float32),
        rng.standard_normal((n_envs,)).astype(np.float32),
        rng.standard_normal((n_envs, obs_dim)).astype(np.float32),
        np.zeros((n_envs,), np.float32),
    )


def make_server(staging=None, spec=SPEC, act=None, **kw):
    staging = staging if staging is not None else StagingBuffer(8, policy="shed")
    return StagingTransportServer(staging, spec, n_envs=N_ENVS, act_dim=ACT_DIM, act=act, **kw)


def stage_body(i, actor_id=0, incarnation=0, seq=None, generation=1, epoch=0,
               transition=None):
    return {
        "actor_id": actor_id, "incarnation": incarnation,
        "seq": seq if seq is not None else i, "generation": generation, "epoch": epoch,
        "transition": encode_transition(transition if transition is not None else txn(i)),
    }


def assert_conserved(staging):
    assert staging.conservation_holds(), staging.snapshot()


def _no_sleep(_s):
    pass


# ------------------------------------------------------------ wire codec


def _multi_case(multi_cls, spec_cls):
    spec = multi_cls(features=spec_cls((3,)), frame=spec_cls((4, 4, 1), np.uint8))
    rng = np.random.default_rng(0)
    obs = multi_cls(features=rng.standard_normal((N_ENVS, 3)).astype(np.float32),
                    frame=rng.integers(0, 255, (N_ENVS, 4, 4, 1), dtype=np.uint8))
    tr = (obs, rng.standard_normal((N_ENVS, ACT_DIM)).astype(np.float32),
          rng.standard_normal(N_ENVS).astype(np.float32), obs, np.ones(N_ENVS, np.float32))
    return spec, tr


def _bits(x):
    x = np.asarray(x)
    return x.dtype, x.shape, x.tobytes()


@pytest.mark.parametrize("kind", ["flat", "multi"])
def test_codec_is_the_jax_codec_both_ways(kind):
    if kind == "flat":
        p_spec = j_spec = SPEC
        p_tr = j_tr = canonical_transition(txn(3), SPEC)
    else:
        p_spec, p_tr = _multi_case(MultiObservation, _Spec)
        j_spec, j_tr = _multi_case(JMulti, _Spec)
    p_enc, j_enc = encode_transition(p_tr), j_transport.encode_transition(j_tr)
    # The same bytes on the wire.
    assert json.dumps(p_enc, sort_keys=True) == json.dumps(j_enc, sort_keys=True)
    # JAX encode -> port decode and port encode -> JAX decode, bitwise.
    for out, ref in ((decode_transition(j_enc, p_spec, N_ENVS, ACT_DIM), p_tr),
                     (j_transport.decode_transition(p_enc, j_spec, N_ENVS, ACT_DIM), j_tr)):
        for a, b in zip(out, ref, strict=True):
            if hasattr(a, "features"):
                assert _bits(a.features) == _bits(b.features)
                assert _bits(a.frame) == _bits(b.frame) and a.frame.dtype == np.uint8
            else:
                assert _bits(a) == _bits(b)
    # Decoded arrays are owned and writable.
    decode_transition(j_enc, p_spec, N_ENVS, ACT_DIM)[1][0, 0] = 7.0


# ---------------------------------- across packages, over a real socket


def _lost_response_post(client):
    """The client's own HTTP post with the first call's response lost in
    flight (the request was delivered)."""
    calls = {"n": 0}
    real = client._http_post

    def post(path, payload, timeout_s):
        out = real(path, payload, timeout_s)
        calls["n"] += 1
        if calls["n"] == 1:
            raise ConnectionError("response lost in flight")
        return out

    return post


@pytest.mark.parametrize("direction", ["jax_client_to_port_server", "port_client_to_jax_server"])
def test_cross_package_push_over_a_socket(direction):
    if direction == "jax_client_to_port_server":
        staging = StagingBuffer(8, policy="shed")
        srv = StagingTransportServer(staging, SPEC, n_envs=N_ENVS, act_dim=ACT_DIM).start()
        client_cls, unavailable = j_transport.RemoteStagingClient, j_staging.StagingUnavailable
    else:
        staging = j_staging.StagingBuffer(8, policy="shed")
        srv = j_transport.StagingTransportServer(staging, SPEC, n_envs=N_ENVS,
                                                 act_dim=ACT_DIM).start()
        client_cls, unavailable = RemoteStagingClient, StagingUnavailable
    try:
        cli = client_cls(srv.address, actor_id=1, backoff_s=0.0001, sleep=_no_sleep)
        # Accept, then a push whose response was lost: retried with the
        # same seq, answered duplicate, staged once.
        assert cli.put(canonical_transition(txn(0), SPEC), generation=2, epoch=1) is True
        cli._post = _lost_response_post(cli)
        assert cli.put(canonical_transition(txn(1), SPEC), generation=2, epoch=1) is True
        assert cli.stats()["duplicates_total"] == 1 and cli.stats()["accepted_total"] == 1
        assert staging.staged_total == 2 and srv.snapshot()["duplicate_pushes_total"] == 1
        staged = list(staging._q)
        for entry, i in zip(staged, (0, 1), strict=True):
            assert entry.actor_id == 1 and (entry.generation, entry.epoch) == (2, 1)
            for a, b in zip(entry.transition, canonical_transition(txn(i), SPEC)):
                assert _bits(a) == _bits(b)
        # A malformed body: 400, no counter moves.
        before = staging.snapshot()
        for body in (b"{not json", json.dumps({**stage_body(5, actor_id=1, seq=5),
                                               "seq": "five"}).encode()):
            req = urlreq.Request(srv.address + "/stage", data=body,
                                 headers={"Content-Type": "application/json"})
            with pytest.raises(urlerr.HTTPError) as ei:
                urlreq.urlopen(req, timeout=5.0)
            assert ei.value.code == 400
        assert staging.snapshot() == before
        # A superseded incarnation: 410 (the client raises), nothing staged.
        assert srv.retire_actor(1, incarnation=0) == 2
        with pytest.raises(RuntimeError, match="superseded"):
            cli.put(canonical_transition(txn(2), SPEC))
        assert staging.depth() == 0 and staging.dropped_dead_actor_total == 2
        # A paused learner: the client surfaces StagingUnavailable.
        staging.pause()
        fresh = client_cls(srv.address, actor_id=1, incarnation=1, retry_budget_s=0.05,
                           backoff_s=0.0001, sleep=_no_sleep)
        with pytest.raises(unavailable):
            fresh.put(canonical_transition(txn(3), SPEC))
        staging.resume()
        assert fresh.put(canonical_transition(txn(3), SPEC)) is True
        snap = srv.snapshot()
        assert (snap["accepted_total"], snap["rejected_zombie_total"],
                snap["rejected_malformed_total"], snap["unavailable_503_total"]) == (3, 1, 2, 1)
        assert_conserved(staging)
    finally:
        srv.close()


# ------------------------------------------ the transport on the port


def test_stage_accept_dedup_seq_audit_and_zombie_fence():
    srv = make_server()
    assert srv.handle_stage(stage_body(0))[0] == 200
    assert srv.handle_stage(stage_body(1))[0] == 200
    code, payload, _ = srv.handle_stage(stage_body(1))
    assert code == 200 and payload["duplicate"] is True
    snap = srv.snapshot()
    assert (snap["accepted_total"], snap["duplicate_pushes_total"]) == (2, 1)
    assert snap["actors"]["0"]["seq"] == 1 and srv.staging.staged_total == 2
    assert srv.handle_stage(stage_body(0, actor_id=1))[0] == 200
    assert srv.retire_actor(0, incarnation=0) == 2
    assert srv.staging.depth() == 1 and srv.staging.dropped_dead_actor_total == 2
    assert srv.handle_stage(stage_body(9, seq=9))[0] == 410
    code, payload, _ = srv.handle_stage(stage_body(5, seq=0, incarnation=1))
    assert code == 200 and payload["duplicate"] is False
    assert_conserved(srv.staging)


def test_pause_maps_to_503_and_shed_to_429():
    srv = make_server(staging=StagingBuffer(2, policy="shed"))
    srv.staging.pause()
    code, _, headers = srv.handle_stage(stage_body(0))
    assert code == 503 and "Retry-After" in headers
    srv.staging.resume()
    assert srv.handle_stage(stage_body(0))[0] == 200
    assert srv.handle_stage(stage_body(1))[0] == 200
    code, _, headers = srv.handle_stage(stage_body(2))
    assert code == 429 and "Retry-After" in headers
    snap = srv.snapshot()
    assert (snap["unavailable_503_total"], snap["shed_429_total"], snap["accepted_total"]) == (
        1, 1, 2)
    assert_conserved(srv.staging)


def test_poison_push_cannot_corrupt_conservation():
    srv = make_server().start()
    try:
        assert srv.handle_stage(stage_body(0))[0] == 200
        before = srv.staging.snapshot()
        good = stage_body(1)
        poisons = []
        for key, val in [("actor_id", "zero"), ("actor_id", -1), ("seq", None), ("seq", True),
                         ("generation", "g"), ("epoch", "now"), ("transition", None),
                         ("transition", [1, 2, 3])]:
            poisons.append({**good, key: val})
        for mutate in [
            lambda tr: tr["actions"].update(dtype="float64"),
            lambda tr: tr["rewards"].update(shape=[N_ENVS, 1]),
            lambda tr: tr["done"].update(data=tr["done"]["data"][:-8]),
            lambda tr: tr["obs"].update(data="!!not-base64!!"),
            lambda tr: tr.pop("next_obs"),
        ]:
            b = stage_body(1)
            mutate(b["transition"])
            poisons.append(b)
        for b in poisons:
            assert srv.handle_stage(b)[0] == 400
        assert srv.staging.snapshot() == before
        snap = srv.snapshot()
        assert snap["rejected_malformed_total"] == len(poisons)
        assert snap["actors"]["0"]["seq"] == 0
        # /healthz carries the invariant; /metrics both snapshots.
        with urlreq.urlopen(srv.address + "/healthz", timeout=5) as r:
            health = json.loads(r.read())
        assert health["conservation_ok"] is True and health["staging_depth"] == 1
        with urlreq.urlopen(srv.address + "/metrics", timeout=5) as r:
            metrics = json.loads(r.read())
        assert metrics["transport"]["accepted_total"] == 1
    finally:
        srv.close()


def test_client_retry_contract():
    srv = make_server()
    calls = {"n": 0}

    def lossy_post(path, payload, timeout_s):
        status, out, _ = srv.handle_stage(payload)
        calls["n"] += 1
        if calls["n"] == 1:
            raise ConnectionError("response lost in flight")
        return status, out

    cli = RemoteStagingClient("http://unused", actor_id=0, backoff_s=0.0001, sleep=_no_sleep,
                              post=lossy_post)
    assert cli.put(canonical_transition(txn(0), SPEC), generation=1, epoch=0) is True
    assert cli.stats()["duplicates_total"] == 1 and srv.staging.staged_total == 1

    def dead_post(path, payload, timeout_s):
        raise ConnectionError("connection refused")

    cli = RemoteStagingClient("http://unused", actor_id=1, retry_budget_s=0.05,
                              backoff_s=0.001, sleep=_no_sleep, post=dead_post)
    tr = canonical_transition(txn(1), SPEC)
    with pytest.raises(StagingUnavailable):
        cli.put(tr, generation=1, epoch=0)
    seq = cli.stats()["next_seq"]
    cli._post = lambda p, b, t: srv.handle_stage(b)[:2]
    assert cli.put(tr, generation=1, epoch=0) is True and cli.stats()["next_seq"] == seq + 1
    assert_conserved(srv.staging)


def test_flaky_transport_drops_what_jax_drops_and_delivers_once():
    srv = make_server()
    port = FlakyTransport(lambda p, b, t: srv.handle_stage(b)[:2], drop_rate=0.4,
                          rng=random.Random(5), sleep=_no_sleep)
    ref = j_fault.FlakyTransport(lambda p, b, t: (200, {}), drop_rate=0.4,
                                 rng=random.Random(5), sleep=_no_sleep)
    port.drop_next(2)
    ref.drop_next(2)
    cli = RemoteStagingClient("http://unused", actor_id=3, retry_budget_s=30.0,
                              backoff_s=0.0001, sleep=_no_sleep, post=port)
    for i in range(6):
        assert cli.put(canonical_transition(txn(i), SPEC), generation=1, epoch=0) is True
    want = 0
    for _ in range(port.calls_total):
        try:
            ref("/stage", {}, 1.0)
        except OSError:
            want += 1
    assert port.drops_injected == want == ref.drops_injected >= 2
    assert srv.staging.staged_total == 6 and srv.snapshot()["actors"]["3"]["accepted_total"] == 6
    assert_conserved(srv.staging)


def test_flaky_push_hook_wraps_the_post_as_jax_does(monkeypatch):
    """``TAC_FLAKY_PUSH`` in a spawned actor's environment wraps its push
    in a ``FlakyTransport`` seeded ``seed + actor_id``: the same drops as
    the JAX package's hook."""
    from torch_actor_critic_tpu_torch.decoupled.fleet import FLAKY_PUSH_ENV, _maybe_flaky_post

    monkeypatch.setenv(FLAKY_PUSH_ENV, "drop_rate=0.5,latency_s=0,seed=3")
    drops = []
    for client_cls, hook in ((RemoteStagingClient, _maybe_flaky_post),
                             (j_transport.RemoteStagingClient, j_fleet._maybe_flaky_post)):
        cli = client_cls("http://unused", actor_id=2, post=lambda p, b, t: (200, {}))
        hook(cli, 2)
        seq = []
        for _ in range(30):
            try:
                cli._post("/stage", {}, 1.0)
                seq.append(0)
            except OSError:
                seq.append(1)
        drops.append(seq)
    assert drops[0] == drops[1] and 0 < sum(drops[0]) < 30
    monkeypatch.delenv(FLAKY_PUSH_ENV)
    cli = RemoteStagingClient("http://unused", actor_id=2, post=lambda p, b, t: (200, {}))
    post = cli._post
    _maybe_flaky_post(cli, 2)
    assert cli._post is post  # unset: nothing wrapped


def test_heartbeats_over_http_feed_liveness_and_fence_zombies():
    srv = make_server().start()
    try:
        cli = RemoteStagingClient(srv.address, actor_id=2, incarnation=5)
        assert cli.heartbeat(pid=4242, steps=17) is True
        live = srv.liveness()[2]
        assert (live["pid"], live["incarnation"], live["steps"]) == (4242, 5, 17)
        srv.retire_actor(2, incarnation=5)
        with pytest.raises(RuntimeError, match="superseded"):
            cli.heartbeat(pid=4242, steps=18)
        dead = RemoteStagingClient("http://127.0.0.1:1", actor_id=9)
        assert dead.heartbeat(pid=1, steps=0) is False
        assert dead.stats()["heartbeat_failures_total"] == 1
    finally:
        srv.close()


def test_staged_tail_and_watermarks_roundtrip():
    srv = make_server(staging=StagingBuffer(8, policy="shed"))
    for i in range(3):
        assert srv.handle_stage(stage_body(i, actor_id=i % 2, seq=i // 2))[0] == 200
    arrays = srv.staging.export_arrays()
    assert [int(a) for a in arrays["actor_id"]] == [0, 1, 0]
    st2 = StagingBuffer(8, policy="shed")
    st2.load_meta(srv.staging.meta_state())
    assert st2.import_arrays(arrays) == 3 and st2.snapshot() == srv.staging.snapshot()
    assert st2.purge_actor(0) == 2
    assert_conserved(st2)
    srv2 = make_server()
    srv2.load_watermarks(json.loads(json.dumps(srv.watermarks())))
    code, payload, _ = srv2.handle_stage(stage_body(0, actor_id=0, seq=0))
    assert code == 200 and payload["duplicate"] is True and srv2.staging.staged_total == 0
    assert {a: (m["incarnation"], m["seq"], m["accepted_total"])
            for a, m in srv.watermarks().items()} == {
        a: (m["incarnation"], m["seq"], m["accepted_total"]) for a, m in srv2.watermarks().items()}


# --------------------------------------------- supervisor and elastic


class _FakeProc:
    def __init__(self, pid):
        self.pid = pid
        self.alive = True
        self.exitcode = None

    def is_alive(self):
        return self.alive

    def join(self, timeout=None):
        pass


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _supervisor(cls, clock, liveness, max_restarts=2, **kw):
    spawned, kills, retired = [], [], []

    def spawn(aid, inc):
        proc = _FakeProc(pid=5000 + 100 * aid + inc)
        spawned.append((aid, inc, proc))
        return proc

    def on_death(aid, inc):
        retired.append((aid, inc))
        return 1

    sup = cls(spawn, n_actors=2, liveness=liveness, on_death=on_death,
              heartbeat_timeout_s=3.0, max_restarts=max_restarts, backoff_s=0.5,
              clock=clock, kill=lambda pid, sig: kills.append((pid, sig)),
              rng=random.Random(0), **kw)
    with sup._lock:
        for aid in range(sup.n_actors):
            sup._incarnation[aid] = 0
            sup._restarts[aid] = 0
            sup._procs[aid] = sup._spawn(aid, 0)
            sup._spawned_at[aid] = clock()
    return sup, spawned, retired, kills


def _supervisor_script(cls):
    """Deaths by exit, by a missed deadline and by no heartbeat since
    spawn, respawns after jittered backoffs, a give-up and a readmit,
    polled on a fake clock; returns everything observable."""
    clock, live = _Clock(), {}
    sup, spawned, retired, kills = _supervisor(cls, clock, lambda: live, max_restarts=2,
                                               grace_s=60.0)
    trace = []

    def poll(dt):
        clock.t += dt
        sup.poll_once()
        st = sup.stats()
        trace.append((clock.t, st["deaths_total"], st["restarts_total"], sorted(st["gave_up"]),
                      dict(sup._respawn_at), len(spawned)))

    spawned[0][2].alive = False  # actor 0 exits
    poll(0.0)
    poll(0.1)
    poll(0.8)
    live[0] = {"age_s": 2.0, "incarnation": 1, "pid": 1, "steps": 5}
    live[1] = {"age_s": 0.1, "incarnation": 0, "pid": 2, "steps": 5}
    poll(1.0)
    live[0]["age_s"] = 3.5  # wedged: past the deadline
    poll(0.0)
    for _ in range(8):
        poll(0.7)
    # Slot 0 again and again until its budget is gone.
    for _ in range(3):
        procs = [p for a, _i, p in spawned if a == 0]
        procs[-1].alive = False
        poll(0.0)
        poll(5.0)
    poll(61.0)  # actor 1's heartbeat is fresh, slot 0 abandoned
    readmitted = sup.readmit(0)
    trace.append(("readmit", readmitted, sup.readmit(1)))
    st = sup.stats()
    return (trace, [(a, i, p.pid) for a, i, p in spawned], retired, kills,
            {k: v for k, v in st.items() if k != "actors"},
            {a: {k: v for k, v in s.items() if k != "alive"} for a, s in st["actors"].items()})


def test_supervisor_schedule_equals_jax():
    got, want = _supervisor_script(FleetSupervisor), _supervisor_script(j_fleet.FleetSupervisor)
    assert got == want
    trace, spawned, retired, kills, stats, _ = got
    assert stats["deaths_total"] == 3 and stats["restarts_total"] == 2
    assert trace[-1] == ("readmit", True, False)  # slot 0 had given up, slot 1 had not
    assert all(sig == signal.SIGKILL for _pid, sig in kills)


class _FakeSupervisor:
    def __init__(self):
        self.gave_up = set()
        self.incarnation = {0: 0, 1: 0, 2: 0}
        self.readmits = []
        self.refuse = set()

    def stats(self):
        return {"gave_up": sorted(self.gave_up), "alive": 3 - len(self.gave_up),
                "purged_on_death_total": 7,
                "actors": {a: {"incarnation": i} for a, i in self.incarnation.items()}}

    def readmit(self, aid):
        if aid in self.refuse:
            return False
        self.readmits.append(aid)
        self.gave_up.discard(aid)
        self.incarnation[aid] += 1
        return True


def _elastic_script(manager_cls, log_cls):
    sup = _FakeSupervisor()
    topo = {"process_count": 1, "process_index": 0, "local_device_count": 1,
            "global_device_count": 1}
    mgr = manager_cls(sup, n_actors=3, log=log_cls(), readmit_epochs=2,
                      topology=lambda: dict(topo))
    out = []
    for epoch, event in enumerate([None, {0}, None, {2}, None, "refuse", None, None]):
        if isinstance(event, set):
            sup.gave_up |= event
        elif event == "refuse":
            sup.refuse.add(2)
        decisions = mgr.poll_epoch(epoch)
        out.append(([{k: v for k, v in d.items() if k not in ("t0", "dur_s", "time", "seq")}
                     for d in decisions], mgr.metrics(), mgr.snapshot()))
    restored = manager_cls(sup, n_actors=3, readmit_epochs=2, topology=lambda: dict(topo))
    restored.restore(mgr.snapshot())
    out.append((restored.snapshot(), sup.readmits))
    return out


def test_training_elastic_manager_decisions_equal_jax():
    got = _elastic_script(TrainingElasticManager, DecisionLog)
    want = _elastic_script(j_training.TrainingElasticManager, j_controller.DecisionLog)
    assert got == want
    actions = [d["action"] for epoch in got[:-1] for d in epoch[0]]
    assert actions == ["degrade", "degrade", "readmit"]
    assert got[-2][1]["elastic/degraded_slots"] == 1 and got[-1][1] == [0]


# ------------------------------------------------ FleetTrainer end to end


TINY_FLEET = dict(
    hidden_sizes=(16, 16), batch_size=16, epochs=2, steps_per_epoch=40, start_steps=10,
    update_after=10, update_every=10, buffer_size=500, max_ep_len=100, save_every=1,
    actors=2,
    # shed (not block): a full buffer must never wedge a transport handler
    # thread under test timing.
    staging_policy="shed", max_actor_lag=4, heartbeat_interval_s=0.1,
    heartbeat_timeout_s=30.0,  # thread actors: no liveness churn
)


class _ThreadProc:
    """Thread-backed stand-in for an actor process (the supervisor sees
    only ``pid``/``is_alive``/``join``). The fake pid makes ``os.kill``
    raise ProcessLookupError (handled as already reaped); ``join`` doubles
    as the stop signal."""

    _pids = itertools.count(2 ** 24)

    def __init__(self, body):
        self.pid = next(self._pids)
        self.exitcode = None
        self.stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(body,), daemon=True)
        self._thread.start()

    def _run(self, body):
        try:
            body(self.stop)
            self.exitcode = 0
        except Exception:  # noqa: BLE001 — surfaced through exitcode
            self.exitcode = 1
            raise

    def is_alive(self):
        return self._thread.is_alive()

    def join(self, timeout=None):
        self.stop.set()
        self._thread.join(timeout)


def make_fleet_trainer(ckpt_dir, seed=7, tracker=None, trace_export=None, **over):
    cfg = SACConfig(**{**TINY_FLEET, **over})
    ck = Checkpointer(ckpt_dir, retry_backoff_s=0.0) if ckpt_dir is not None else None
    procs = []

    def spawn(actor_id, incarnation):
        def body(stop):
            return _actor_loop(
                actor_id, incarnation, trainer.transport.address, ENV, 1,
                1000 + 10 * actor_id + incarnation, stop,
                options={"heartbeat_interval_s": 0.1, "act_timeout_s": 2.0,
                         "push_retry_s": 1.0, "probe_every": 4,
                         "trace_dir": trainer._trace_dir},
            )

        proc = _ThreadProc(body)
        procs.append(proc)
        return proc

    trainer = FleetTrainer(ENV, cfg, checkpointer=ck, seed=seed, spawn=spawn, device="cpu",
                           tracker=tracker, trace_export=trace_export)
    return trainer, procs


def _drive_supervisor_until(trainer, pred, timeout=20.0):
    deadline = time.time() + timeout
    while not pred(trainer.supervisor.stats()) and time.time() < deadline:
        trainer.supervisor.poll_once()
        time.sleep(0.02)


def test_fleet_trainer_trains_through_actor_death():
    trainer, procs = make_fleet_trainer(None)
    trainer.supervisor.backoff_s = 0.05

    def kill_one():
        procs[0].stop.set()  # a crash: the supervisor sees a dead "process"

    trainer.pool = FaultyEnvPool(trainer.pool).call_at(45, kill_one)
    try:
        out = trainer.train()
        assert out["decoupled/conservation_ok"] == 1.0
        assert trainer.staging.drained_total >= 2 * TINY_FLEET["steps_per_epoch"]
        assert_conserved(trainer.staging)
        _drive_supervisor_until(trainer, lambda st: st["restarts_total"] >= 1)
        st = trainer.supervisor.stats()
        assert st["deaths_total"] >= 1 and st["restarts_total"] >= 1
        assert st["actors"][0]["incarnation"] >= 1
        # Zero double-ingestion, every audit from ONE snapshot (taken
        # under the transport's lock): per-actor accepts sum to the total,
        # and a never-retired actor's watermark bounds its accepts.
        tsnap = trainer.transport.snapshot()
        assert tsnap["accepted_total"] > 0
        assert sum(a["accepted_total"] for a in tsnap["actors"].values()) == (
            tsnap["accepted_total"])
        for aid, a in tsnap["actors"].items():
            if st["actors"][int(aid)]["restarts"] == 0:
                assert a["accepted_total"] <= a["seq"] + 1
        m = trainer.metrics_snapshot()["decoupled"]
        assert m["fleet"]["deaths_total"] >= 1 and m["transport"]["accepted_total"] > 0
        assert out["decoupled/fleet_deaths_total"] >= 1 or st["deaths_total"] >= 1
    finally:
        trainer.close()
    assert all(not p.is_alive() for p in procs)


def test_fleet_checkpoint_resume_restores_watermarks_and_dedups(tmp_path):
    t1, _ = make_fleet_trainer(str(tmp_path))
    try:
        t1.train()
        marks1 = t1.transport.watermarks()
        assert any(int(m["seq"]) >= 0 for m in marks1.values())
    finally:
        t1.close()
    t2, _ = make_fleet_trainer(str(tmp_path))
    try:
        assert t2.restore() > 0
        marks2 = t2.transport.watermarks()
        for aid, m in marks1.items():
            assert marks2[aid]["incarnation"] == m["incarnation"]
            assert 0 <= marks2[aid]["seq"] <= m["seq"]
            assert t2._restored_incarnations[int(aid)] == int(m["incarnation"]) + 1
        assert_conserved(t2.staging)
        assert t2.supervisor.restarts_total == t1.supervisor.restarts_total
        aid = next(a for a, m in marks2.items() if int(m["seq"]) >= 0)
        staged_before = t2.staging.staged_total
        code, payload, _ = t2.transport.handle_stage(stage_body(
            0, actor_id=int(aid), incarnation=int(marks2[aid]["incarnation"]),
            seq=int(marks2[aid]["seq"]), transition=txn(0, n_envs=1)))
        assert code == 200 and payload["duplicate"] is True
        assert t2.staging.staged_total == staged_before
        if t2.staging.depth():  # room for the next push (the policy sheds)
            t2.staging.pop_window(t2.staging.depth())
        code, payload, _ = t2.transport.handle_stage(stage_body(
            1, actor_id=int(aid), incarnation=int(marks2[aid]["incarnation"]),
            seq=int(marks2[aid]["seq"]) + 1, transition=txn(1, n_envs=1)))
        assert code == 200 and payload["duplicate"] is False
        assert_conserved(t2.staging)
    finally:
        t2.close()


def test_elastic_fleet_degrades_and_readmits_at_epoch_boundaries():
    trainer, procs = make_fleet_trainer(None, epochs=3, elastic="on", actor_max_restarts=0)
    trainer.pool = FaultyEnvPool(trainer.pool).call_at(15, lambda: procs[0].stop.set())
    rows = []
    try:
        # The death is seen before epoch 0 ends: drive the supervisor from
        # a later step so the slot is abandoned by then.
        trainer.pool.call_at(
            30, lambda: _drive_supervisor_until(trainer, lambda st: 0 in st["gave_up"]))
        trainer.train(on_epoch=lambda e, m: rows.append(m))
        decisions = trainer.elastic.log.records()
        assert [d["action"] for d in decisions][:2] == ["degrade", "readmit"]
        assert rows[0]["elastic/degrade_total"] == 1 and rows[0]["elastic/degraded_slots"] == 1
        assert rows[1]["elastic/readmit_total"] == 1 and rows[1]["elastic/surviving"] == 2
        assert all(r["decoupled/conservation_ok"] == 1.0 for r in rows)
        snap = trainer.elastic.snapshot()
        assert snap["topology"]["process_count"] == 1
        assert trainer.supervisor.stats()["actors"][0]["incarnation"] == 1
    finally:
        trainer.close()


def test_fleet_trace_export_stitches_actor_transport_and_drain_spans(tmp_path):
    """With a trace export, the learner's timeline at close holds the
    transport's ingest spans, the drain windows and each actor's push
    spans (read from its span file), tied by ``a<actor>.<inc>.<seq>``."""
    from torch_actor_critic_tpu_torch.telemetry.traceview import ACTOR_PID_BASE, TRANSPORT_PID
    from torch_actor_critic_tpu_torch.utils.tracking import Tracker

    path = tmp_path / "timeline.json"
    trainer, _ = make_fleet_trainer(None, epochs=1, tracker=Tracker(root=str(tmp_path / "runs")),
                                    trace_export=str(path))
    try:
        trainer.pool = FaultyEnvPool(trainer.pool).call_at(5, lambda: _drive_supervisor_until(
            trainer, lambda st: trainer.transport.snapshot()["accepted_total"] >= 4))
        trainer.train()
    finally:
        trainer.close()
    events = json.loads(path.read_text())["traceEvents"]
    begins = [e for e in events if e.get("ph") == "B"]
    pids = {e["pid"] for e in begins}
    assert TRANSPORT_PID in pids and any(p >= ACTOR_PID_BASE for p in pids)
    ingest = {e["args"]["span_id"] for e in begins
              if e["pid"] == TRANSPORT_PID and "span_id" in e.get("args", {})}
    pushed = {e["args"]["span_id"] for e in begins
              if e["pid"] >= ACTOR_PID_BASE and "span_id" in e.get("args", {})}
    assert ingest and pushed and ingest & pushed
    assert any(e["name"] == "drain_window" for e in begins)


# ------------------------------------------------- real processes


def test_kill_actor_raw_pid_and_supervisor_slot():
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    p1 = ctx.Process(target=time.sleep, args=(60,), daemon=True)
    p1.start()
    try:
        assert kill_actor(p1.pid) == p1.pid
        p1.join(timeout=30.0)
        assert not p1.is_alive() and p1.exitcode == -signal.SIGKILL
        p2 = ctx.Process(target=time.sleep, args=(60,), daemon=True)
        p2.start()
        sup, _s, _r, _k = _supervisor(FleetSupervisor, _Clock(), lambda: {})
        with sup._lock:
            sup._procs[1] = p2
        assert kill_actor(sup, idx=1, join_timeout_s=30.0) == p2.pid
        assert not p2.is_alive() and p2.exitcode == -signal.SIGKILL
        with pytest.raises(ValueError, match="no live actor"):
            kill_actor(sup, idx=7)
    finally:
        for p in (p1,):
            if p.is_alive():
                p.kill()


# The CLI's main in a process of its own, its learner held after epoch 0
# until the transport has accepted an actor's push (at most 200 s). A spawned
# actor starts a fresh interpreter and imports torch; on a loaded host that
# took longer than the learner's three short epochs, which then ended with
# nothing pushed.
_HELD_CLI = """
import sys, time
from torch_actor_critic_tpu_torch import train
from torch_actor_critic_tpu_torch.decoupled import fleet
base = fleet.FleetTrainer.train
def held(self, on_epoch=None, render=False):
    def after(epoch, metrics):
        on_epoch(epoch, metrics)
        t0 = time.monotonic()
        while epoch == 0 and self.transport.snapshot()["accepted_total"] == 0:
            if time.monotonic() - t0 > 200:
                raise TimeoutError("no actor push accepted within 200 s")
            time.sleep(0.05)
    return base(self, after, render)
fleet.FleetTrainer.train = held
train.main(sys.argv[1:])
"""


def test_train_cli_actors_elastic_spawns_host_only_actor_processes(tmp_path):
    """``train --actors 1 --elastic on`` through the CLI's main in a
    process of its own (limit 240 s): the spawned actor feeds the learner
    over the transport, the run completes with conservation green, and
    the actor rolls down on the shutdown's SIGTERM. The learner waits
    after epoch 0 for the actor's first accepted push (``_HELD_CLI``), so
    how long the actor takes to start cannot decide the result. (It is
    started with ``CUDA_VISIBLE_DEVICES`` blank; the card's side of that
    is ``chip_smoke.py``'s.)"""
    cmd = [sys.executable, "-c", _HELD_CLI,
           "--environment", ENV, "--device", "cpu", "--epochs", "3",
           "--steps-per-epoch", "200", "--start-steps", "10", "--update-after", "10",
           "--update-every", "50", "--hidden-sizes", "16,16", "--batch-size", "16",
           "--buffer-size", "500", "--actors", "1", "--elastic", "on",
           "--staging-policy", "drop_oldest", "--runs-root", str(tmp_path)]
    env = {**__import__("os").environ, "OMP_NUM_THREADS": "1"}
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=240, cwd=REPO, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]
    epochs = [line for line in lines if "epoch" in line]
    assert [e["epoch"] for e in epochs] == [0, 1, 2]
    assert all(e["decoupled/conservation_ok"] == 1.0 for e in epochs)
    assert epochs[-1]["decoupled/transport_accepted_total"] > 0
    assert epochs[-1]["elastic/surviving"] == 1 and epochs[-1]["decoupled/fleet_alive"] == 1
    assert "spawned actor 0 (incarnation 0" in res.stderr
    assert "rolling down" in res.stderr  # the actor's own SIGTERM handler ran
