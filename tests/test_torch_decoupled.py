"""The port's decoupled actor/learner plane (``decoupled/staging.py``,
``actor.py``, ``learner.py``; ``resilience/faultinject.py``'s serving
and link injectors) against the JAX package's, on the CPU.

- ``StagingBuffer``: one scripted put / pop_window / purge_actor / pause
  sequence under each backpressure policy (``block``, ``drop_oldest``,
  ``shed``) through both packages' buffers gives equal snapshots, equal
  lag-histogram counts and bitwise ``export_arrays``; the JAX module's
  unit cases (bounded block, wake on drain, exact windows, stale gate,
  pause, the pause/resume race, the checkpoint round trip) on the port.
- ``LossyLink`` and ``FaultyEngine`` drop the same calls under the same
  seed as the JAX package's; ``nan_params`` poisons, ``flood`` counts.
- ``ActorWorker``: degrade, probe and re-home, idle-spin while paused
  (the JAX cases) — and the JAX worker's counters on the same script.
- A window drained from the port learner's staging is bitwise the chunk
  the JAX trainer's ``_build_chunk`` makes of the same staged
  transitions, and one update on it from the JAX learner's state (carried
  by ``weights.py``, its draws injected) agrees to 1e-5 / 1e-4.
- ``DecoupledTrainer`` on ``PendulumNumpy-v1``: trains through the
  serving plane; the stale gate drops in the real loop and a skipped
  window leaves the ring untouched; serving loss degrades and the run
  completes; a NaN publish is rejected and the last good generation
  serves; a publish never aliases the learner's live parameters; a
  SIGTERM resume is bitwise, the staged tail included; and with
  ``actor_param_lag``, ``replay_tiers``/``replay_refill`` and
  ``telemetry`` it runs as the JAX trainer composes them.

Tolerances: staging, codecs and schedules bitwise; the update 1e-5
absolute / 1e-4 relative, as every update parity of the port.
"""

import json
import os
import random
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_actor_critic_tpu.decoupled import actor as j_actor
from torch_actor_critic_tpu.decoupled import staging as j_staging
from torch_actor_critic_tpu.resilience import faultinject as j_fault
from torch_actor_critic_tpu.sac.algorithm import SAC as JSAC
from torch_actor_critic_tpu.sac.trainer import Trainer as JTrainer
from torch_actor_critic_tpu.sac.trainer import build_models as j_build_models
from torch_actor_critic_tpu.serve.batcher import ActResult as JActResult
from torch_actor_critic_tpu.utils.config import SACConfig as JSACConfig
from torch_actor_critic_tpu_torch.core.types import Batch
from torch_actor_critic_tpu_torch.decoupled import (
    ActorWorker,
    DecoupledTrainer,
    StagingBuffer,
    StagingUnavailable,
)
from torch_actor_critic_tpu_torch.decoupled.learner import StagedArrays
from torch_actor_critic_tpu_torch.diagnostics.monitor import EarlyWarningMonitor
from torch_actor_critic_tpu_torch.resilience import (
    REQUEUE_EXIT_CODE,
    Preempted,
    PreemptionGuard,
)
from torch_actor_critic_tpu_torch.resilience.faultinject import (
    FaultyEngine,
    FaultyEnvPool,
    LossyLink,
    flood,
    nan_params,
)
from torch_actor_critic_tpu_torch.serve.admission import ShedError
from torch_actor_critic_tpu_torch.serve.batcher import ActResult
from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer
from torch_actor_critic_tpu_torch.utils.config import SACConfig
from torch_actor_critic_tpu_torch.weights import _named_arrays, train_state_from_jax

ENV = "PendulumNumpy-v1"
TINY = dict(
    hidden_sizes=(16, 16),
    batch_size=16,
    epochs=3,
    steps_per_epoch=40,
    start_steps=10,
    update_after=10,
    update_every=10,
    buffer_size=500,
    max_ep_len=100,
    save_every=1,
    decoupled=True,
    max_actor_lag=4,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_trainer(ckpt_dir, seed=7, preemption=None, client=None, **over):
    cfg = SACConfig(**{**TINY, **over})
    ck = Checkpointer(ckpt_dir, retry_backoff_s=0.0) if ckpt_dir is not None else None
    return DecoupledTrainer(ENV, cfg, checkpointer=ck, seed=seed, preemption=preemption,
                            client=client, device="cpu")


def txn(i, n_envs=1, obs_dim=3, act_dim=1):
    """A tiny distinguishable batched transition."""
    rng = np.random.default_rng(i)
    return (
        rng.standard_normal((n_envs, obs_dim)).astype(np.float32),
        rng.standard_normal((n_envs, act_dim)).astype(np.float32),
        rng.standard_normal((n_envs,)).astype(np.float32),
        rng.standard_normal((n_envs, obs_dim)).astype(np.float32),
        (rng.uniform(size=n_envs) < 0.3).astype(np.float32),
    )


# ------------------------------------------------- staging against JAX's


def _script(buf, policy):
    """One scripted sequence of every staging operation; returns what
    each call returned (windows as their transitions' first obs)."""
    out = []
    for i in range(5):
        out.append(buf.put(txn(i), generation=i, epoch=i // 2, timeout_s=0.01,
                           actor_id=i % 2))
    out.append(buf.purge_actor(1))
    for i in range(5, 9):
        out.append(buf.put(txn(i), generation=i, epoch=None if i == 6 else 3,
                           timeout_s=0.01, actor_id=-1 if i % 3 else 0))
    w = buf.pop_window(2, current_epoch=4)
    out.append(None if w is None else [float(e.transition[0][0, 0]) for e in w])
    buf.pause()
    try:
        buf.put(txn(99))
        out.append("admitted while paused")
    except (StagingUnavailable, j_staging.StagingUnavailable):
        out.append("paused")
    buf.resume()
    out.append(buf.put(txn(9), generation=9, epoch=4, timeout_s=0.01))
    w = buf.pop_window(1, current_epoch=4)
    out.append(None if w is None else [float(e.transition[0][0, 0]) for e in w])
    out.append(buf.pop_window(50, current_epoch=4))
    for i in range(10, 12):  # a tail left staged, for export_arrays
        out.append(buf.put(txn(i), generation=i, epoch=4, timeout_s=0.01, actor_id=2))
    return out


def _assert_arrays_equal(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("policy", ["block", "drop_oldest", "shed"])
def test_staging_script_matches_jax(policy):
    port = StagingBuffer(capacity=4, policy=policy, max_lag=1, block_timeout_s=0.01)
    ref = j_staging.StagingBuffer(capacity=4, policy=policy, max_lag=1, block_timeout_s=0.01)
    assert _script(port, policy) == _script(ref, policy)
    assert port.snapshot() == ref.snapshot()
    assert port.meta_state() == ref.meta_state()
    assert port.lag_hist.raw_counts() == ref.lag_hist.raw_counts()
    assert port.conservation_holds() and ref.conservation_holds()
    _assert_arrays_equal(port.export_arrays(), ref.export_arrays())
    for e in (port.export_arrays(), ref.export_arrays()):
        assert e["obs"].dtype == np.float32 and e["generation"].dtype == np.int64


def test_staging_backpressure_shed_and_drop_oldest_counted():
    shed = StagingBuffer(capacity=2, policy="shed")
    assert shed.put(txn(0)) and shed.put(txn(1))
    assert not shed.put(txn(2))
    assert shed.shed_total == 1 and shed.staged_total == 2
    assert shed.conservation_holds()
    drop = StagingBuffer(capacity=2, policy="drop_oldest")
    assert drop.put(txn(0)) and drop.put(txn(1)) and drop.put(txn(2))
    assert drop.dropped_backpressure_total == 1
    assert drop.staged_total == 3 and drop.depth() == 2
    out = drop.pop_window(2)
    np.testing.assert_array_equal(out[0].transition[0], txn(1)[0])
    assert drop.conservation_holds()


def test_staging_block_policy_is_bounded_and_wakes_on_drain():
    st = StagingBuffer(capacity=1, policy="block", block_timeout_s=0.01)
    assert st.put(txn(0))
    assert not st.put(txn(1))  # the bounded wait expires: shed, counted
    assert st.blocked_total == 1 and st.shed_total == 1 and st.conservation_holds()
    st = StagingBuffer(capacity=1, policy="block", block_timeout_s=30.0)
    assert st.put(txn(0))
    accepted, done = [], threading.Event()

    def producer():
        accepted.append(st.put(txn(1)))
        done.set()

    thr = threading.Thread(target=producer, daemon=True)
    thr.start()
    assert st.pop_window(1) is not None
    assert done.wait(10.0)
    thr.join(10.0)
    assert accepted == [True] and st.depth() == 1 and st.conservation_holds()


def test_staging_exact_windows_stale_gate_and_pause():
    st = StagingBuffer(capacity=10)
    for i in range(3):
        st.put(txn(i))
    assert st.pop_window(4) is None and st.depth() == 3
    with pytest.raises(ValueError):
        st.pop_window(0)
    gate = StagingBuffer(capacity=16, max_lag=2)
    gate.put(txn(0), generation=1, epoch=0)   # lag 5 at epoch 5: stale
    gate.put(txn(1), generation=3, epoch=4)
    gate.put(txn(2), generation=4, epoch=5)
    gate.put(txn(3))                          # untagged: lag 0
    out = gate.pop_window(3, current_epoch=5)
    assert [e.generation for e in out] == [3, 4, 0]
    assert gate.dropped_stale_total == 1 and gate.conservation_holds()
    snap = gate.snapshot()["actor_lag"]
    assert snap["actor_lag_max"] <= 2 and snap["actor_lag_count"] == 3
    gate.pause()
    with pytest.raises(StagingUnavailable):
        gate.put(txn(4))
    gate.resume()
    assert gate.put(txn(4)) and not gate.paused


def test_staging_drop_oldest_conserves_under_pause_resume_race():
    st = StagingBuffer(capacity=4, policy="drop_oldest")
    n_producers, puts_each = 4, 60
    accepted = [0] * n_producers
    stop_flipping, producers_done = threading.Event(), threading.Event()
    windows = [0]

    def producer(slot):
        for i in range(puts_each):
            while True:
                try:
                    assert st.put(txn(i))
                    accepted[slot] += 1
                    break
                except StagingUnavailable:
                    pass

    def flipper():
        while not stop_flipping.is_set():
            st.pause()
            st.resume()

    def drainer():
        while not (producers_done.is_set() and st.depth() < 2):
            if st.pop_window(2) is not None:
                windows[0] += 1

    threads = [threading.Thread(target=producer, args=(s,), daemon=True)
               for s in range(n_producers)]
    threads += [threading.Thread(target=flipper, daemon=True),
                threading.Thread(target=drainer, daemon=True)]
    for thr in threads:
        thr.start()
    for thr in threads[:n_producers]:
        thr.join(30.0)
    producers_done.set()
    stop_flipping.set()
    for thr in threads[n_producers:]:
        thr.join(30.0)
    assert all(not thr.is_alive() for thr in threads)
    assert accepted == [puts_each] * n_producers
    assert st.staged_total == n_producers * puts_each
    assert st.drained_total == 2 * windows[0]
    assert st.conservation_holds()


def test_staging_arrays_round_trip_bitwise_and_through_a_checkpoint_item():
    st = StagingBuffer(capacity=8, max_lag=3)
    st.put(txn(0), generation=2, epoch=1)
    st.put(txn(1), generation=3, epoch=2, actor_id=4)
    st.put(txn(2))
    st.pop_window(1, current_epoch=2)
    arrays, meta = st.export_arrays(), st.meta_state()
    # Through the learner's checkpoint item: tensors and back, bitwise.
    item = StagedArrays()
    item.load_state_dict_(StagedArrays(arrays).state_dict())
    st2 = StagingBuffer(capacity=8, max_lag=3)
    st2.load_meta(meta)
    assert st2.import_arrays(item.arrays()) == 2
    assert st2.snapshot() == st.snapshot()
    for ea, eb in zip(st._q, st2._q, strict=True):
        assert (ea.generation, ea.epoch, ea.actor_id) == (eb.generation, eb.epoch, eb.actor_id)
        for xa, xb in zip(ea.transition, eb.transition, strict=True):
            np.testing.assert_array_equal(xa, xb)
    # The JAX buffer imports the port's export and the other way round.
    ref = j_staging.StagingBuffer(capacity=8, max_lag=3)
    ref.load_meta(meta)
    assert ref.import_arrays(arrays) == 2
    _assert_arrays_equal(ref.export_arrays(), arrays)
    assert StagingBuffer(capacity=2).export_arrays() is None


# ---------------------------------------------------- fault injectors


class _Echo:
    def act(self, obs, **kw):
        return ActResult(np.asarray(obs), 1, None)


def _drops(link, calls=40):
    out = []
    for _ in range(calls):
        try:
            link.act(np.zeros(2))
            out.append(0)
        except OSError:
            out.append(1)
    return out


def test_lossy_link_and_faulty_engine_drop_what_jax_drops():
    port = LossyLink(_Echo(), drop_rate=0.3, latency_s=0.25, rng=random.Random(11),
                     sleep=lambda s: None).drop_next(2)
    ref = j_fault.LossyLink(_Echo(), drop_rate=0.3, latency_s=0.25, rng=random.Random(11),
                            sleep=lambda s: None).drop_next(2)
    got, want = _drops(port), _drops(ref)
    assert got == want and sum(got) > 2
    assert (port.calls_total, port.drops_injected, port.latency_injected_s) == (
        ref.calls_total, ref.drops_injected, ref.latency_injected_s)
    with pytest.raises(ValueError):
        LossyLink(_Echo(), drop_rate=1.5)

    class _Engine:
        max_batch = 2

        def act(self, *a, **k):
            return "ok"

    outs = []
    for faulty in (FaultyEngine(_Engine()), j_fault.FaultyEngine(_Engine())):
        faulty.fail_next(2).fail_next(1)
        seq = []
        for _ in range(5):
            try:
                seq.append(faulty.act())
            except RuntimeError:
                seq.append("fail")
        outs.append((seq, faulty.calls_total, faulty.failures_injected, faulty.max_batch))
    assert outs[0] == outs[1] == (["fail"] * 3 + ["ok"] * 2, 5, 3, 2)


def test_nan_params_and_flood():
    params = {"w": torch.ones(2, 2), "steps": torch.tensor([3]), "b": np.ones(3, np.float32)}
    bad = nan_params(params)
    assert torch.isnan(bad["w"]).all() and np.isnan(bad["b"]).all()
    assert torch.equal(bad["steps"], params["steps"]) and torch.isfinite(params["w"]).all()
    assert bad["w"] is not params["w"]
    partial = nan_params(params, fraction_leaf=2)
    assert torch.isfinite(partial["w"]).all() and np.isnan(partial["b"]).all()
    calls = []

    def submit(obs, **kw):
        calls.append(kw)
        if len(calls) > 3:
            raise ShedError("queue_full", "full")
        return len(calls)

    futures, sheds = flood(submit, np.zeros(3), 5, deterministic=True)
    assert futures == [1, 2, 3] and len(sheds) == 2
    assert all(c == {"deterministic": True} for c in calls)


# ------------------------------------------------------- ActorWorker


class _FakeClient:
    def __init__(self, result_cls):
        self.fail_left = 0
        self.calls = 0
        self.retries_total = 0
        self._result = result_cls

    def act(self, obs, deterministic=True, slot="default", timeout=None, request_id=None):
        self.calls += 1
        if self.fail_left:
            self.fail_left -= 1
            raise ConnectionError("injected connection loss")
        return self._result(np.asarray(obs) * 0.0, 7, 3)


def _fallback(obs, deterministic):
    return np.asarray(obs) * 0.0 + 1.0, 2, 1


def test_actor_degrades_probes_and_rehomes_as_jax():
    traces = []
    for worker_cls, staging_cls, result_cls in (
            (ActorWorker, StagingBuffer, ActResult),
            (j_actor.ActorWorker, j_staging.StagingBuffer, JActResult)):
        client = _FakeClient(result_cls)
        worker = worker_cls(client, staging_cls(capacity=8), fallback=_fallback,
                            probe_every=3, sleep=lambda s: None)
        client.fail_left = 4
        obs = np.zeros((1, 3), np.float32)
        trace = [worker.act(obs)[1:] for _ in range(16)]
        traces.append((trace, worker.stats(), client.calls))
    assert traces[0] == traces[1]
    trace, stats, _ = traces[0]
    assert trace[0] == (2, 1, "fallback") and trace[-1] == (7, 3, "serving")
    assert stats["rehomes_total"] == 1 and not stats["degraded"]
    client = _FakeClient(ActResult)
    client.fail_left = 1
    with pytest.raises(ConnectionError):
        ActorWorker(client, StagingBuffer(capacity=2), fallback=None).act(np.zeros((1, 3)))


def test_actor_idle_spins_while_paused_and_reconnects():
    staging = StagingBuffer(capacity=8)
    actor = ActorWorker(_FakeClient(ActResult), staging, fallback=_fallback,
                        idle_backoff_s=0.0, sleep=lambda s: None)
    staging.pause()
    stop, done, result = threading.Event(), threading.Event(), []

    def worker():
        result.append(actor.stage(txn(0), generation=1, epoch=0, stop=stop))
        done.set()

    thr = threading.Thread(target=worker, daemon=True)
    thr.start()
    t_end = time.monotonic() + 10.0
    while actor.idle_spins_total == 0 and time.monotonic() < t_end:
        time.sleep(0)
    assert actor.idle_spins_total >= 1 and not done.is_set()
    staging.resume()
    assert done.wait(10.0)
    thr.join(10.0)
    assert result == [True] and staging.depth() == 1


def test_lag_drift_feeds_early_warning_monitor():
    mon = EarlyWarningMonitor(warmup=2)
    fired = []
    for lag in (1.0, 1.0, 1.0, 1.0, 40.0):
        fired += mon.update({"decoupled/actor_lag_mean": lag})
    assert any(w["kind"] == "actor_lag_drift" for w in fired)


# ---------------------------------------- drained window and one update


UPD = dict(hidden_sizes=(32, 32), batch_size=16, update_every=16, max_actor_lag=4,
           decoupled=True)


def test_drained_window_is_jax_chunk_and_one_update_matches_jax():
    """16 staged transitions drained as one window by the port learner and
    by the JAX trainer's chunk builder: bitwise; then one SAC update on
    that window from the JAX learner's state, its draws injected."""
    tr = DecoupledTrainer(ENV, SACConfig(**UPD), seed=0, device="cpu")
    ref = j_staging.StagingBuffer(capacity=64, max_lag=4)
    try:
        for i in range(20):
            tr.staging.put(txn(i), generation=i, epoch=1 if i < 2 else 3)
            ref.put(txn(i), generation=i, epoch=1 if i < 2 else 3)
        tr._epoch = 6  # epochs 1: lag 5 > 4, dropped by both gates
        chunk = tr._drain_window(None)
        entries = ref.pop_window(16, current_epoch=6)
        want = JTrainer._build_chunk(None, [e.transition for e in entries])
        assert tr.staging.snapshot() == ref.snapshot()
        for field in ("states", "actions", "rewards", "next_states", "done"):
            got, exp = getattr(chunk, field), np.asarray(getattr(want, field))[0]
            assert got.dtype == exp.dtype, field
            np.testing.assert_array_equal(got, exp, err_msg=field)
        # One update on the window from the JAX learner's initial state.
        jcfg = JSACConfig(**{k: v for k, v in UPD.items() if k != "decoupled"})
        import types

        env = types.SimpleNamespace(obs_spec=jax.ShapeDtypeStruct((3,), jnp.float32),
                                    act_dim=1, act_limit=2.0)
        actor_def, critic_def = j_build_models(jcfg, env)
        jsac = JSAC(jcfg, actor_def, critic_def, 1)
        state = jax.jit(jsac.init_state)(jax.random.PRNGKey(0), jnp.zeros((3,)))
        jbatch = jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x)[0]), want)
        new, jm = jax.jit(jsac.update)(state, jbatch)
        np_state = jax.tree_util.tree_map(np.asarray, state)
        ts = train_state_from_jax(np_state, tr.sac, tr.state.actor, tr.state.critic,
                                  torch.Generator())
        _, key_q, key_pi = jax.random.split(state.rng, 3)
        eps = [torch.from_numpy(np.array(jax.random.normal(k, (16, 1)))) for k in (key_q, key_pi)]
        batch = Batch(**{f: torch.from_numpy(np.array(getattr(chunk, f)))
                         for f in ("states", "actions", "rewards", "next_states", "done")})
        ts, tm = tr.sac.update(ts, batch, eps_q=eps[0], eps_pi=eps[1])
        for k in ("loss_q", "loss_pi", "q_mean", "backup_mean", "logp_pi", "alpha"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4,
                                       err_msg=k)
        for module, tree in ((ts.actor, new.actor_params), (ts.critic, new.critic_params),
                             (ts.target_critic, new.target_critic_params)):
            want_p = _named_arrays(module, jax.tree_util.tree_map(np.asarray, tree))
            for name, p in module.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(), want_p[name], atol=1e-5,
                                           rtol=1e-4, err_msg=name)
    finally:
        tr.close()


# ------------------------------------------------- trainer end to end


def test_decoupled_trainer_trains_through_the_serving_plane(tmp_path):
    tr = make_trainer(tmp_path / "ck", epochs=2)
    try:
        m = tr.train()
        assert np.isfinite(m["loss_q"])
        assert tr.actor.serving_actions_total == 2 * 40 - TINY["start_steps"]
        assert m["decoupled/staged_total"] == 80 and m["decoupled/conservation_ok"] == 1.0
        assert m["decoupled/actor_lag_max"] <= TINY["max_actor_lag"]
        assert m["decoupled/published_generation"] == 2
        assert m["decoupled/fallback_actions_total"] == 0
        assert tr.registry.epoch_of("default") == 1
        # The slot serves the published epoch: its params are the actor's.
        _, params, gen = tr.registry.acquire("default")
        assert gen == 2
        for k, v in tr.state.actor.state_dict().items():
            assert torch.equal(params[k], v) and params[k].data_ptr() != v.data_ptr()
        snap = tr.metrics_snapshot()["decoupled"]
        assert snap["staging"]["staged_total"] == 80 and snap["published_epoch"] == 1
    finally:
        tr.close()


def test_stale_gate_drops_in_the_real_loop_and_skips_windows(tmp_path):
    # max_actor_lag=0: after the first publish every served transition is
    # an epoch stale at some drains, so the gate drops them and windows
    # are skipped (no push, no burst: the chunk shape never varies).
    tr = make_trainer(tmp_path / "ck", epochs=3, max_actor_lag=0)
    pushes = []
    orig = tr.sac.update_burst

    def counted(state, buffer, chunk, n):
        pushes.append(chunk.rewards.shape)
        return orig(state, buffer, chunk, n)

    tr.sac.update_burst = counted
    try:
        m = tr.train()
        assert np.isfinite(m["loss_q"])
        assert m["decoupled/dropped_stale_total"] > 0 and tr.staging.conservation_holds()
        assert m["decoupled/actor_lag_max"] == 0.0
        assert set(pushes) == {(TINY["update_every"],)}
        # Every row that reached the ring was drained (no skipped window
        # pushed anything).
        assert int(tr.buffer.size) == min(m["decoupled/drained_total"], TINY["buffer_size"])
    finally:
        tr.close()


def test_serving_loss_degrades_and_run_completes(tmp_path):
    tr = make_trainer(tmp_path / "ck", epochs=2)
    link = LossyLink(tr.client).drop_next(10_000)
    tr.pool = FaultyEnvPool(tr.pool).call_at(20, lambda: setattr(tr.actor, "client", link))
    try:
        m = tr.train()
        assert np.isfinite(m["loss_q"])
        assert tr.actor.degradations_total >= 1
        assert m["decoupled/fallback_actions_total"] > 0 and m["decoupled/degraded"] == 1.0
        assert m["decoupled/actor_lag_max"] <= TINY["max_actor_lag"]
        assert tr.staging.conservation_holds()
    finally:
        tr.close()


def test_nan_publish_is_rejected_and_last_good_serves():
    tr = make_trainer(None, sentinel=False)
    try:
        gen0 = tr.registry.swap("default", tr.publish_params(), epoch=0)
        tr._published_generation = 1
        good = {k: v.clone() for k, v in tr.publish_params().items()}
        with torch.no_grad():
            for k, v in nan_params(tr.state.actor.state_dict()).items():
                tr.state.actor.state_dict()[k].copy_(v)
        tr._publish_epoch(1, saved=False)
        assert tr._publish_rejected_total == 1 and tr._published_generation == 1
        _, params, gen = tr.registry.acquire("default")
        assert gen == gen0 and tr.registry.epoch_of("default") == 0
        assert all(torch.equal(params[k], good[k]) for k in good)
        res = tr.client.act(np.zeros((1, 3), np.float32), deterministic=True)
        assert np.isfinite(res.action).all() and res.generation == gen0
    finally:
        tr.close()


def test_publish_is_a_snapshot_not_the_live_parameters():
    """A publish hands the serving plane new tensors: a later burst (which
    writes the live parameters in place) changes nothing served, and the
    served action equals the eager forward of the published snapshot."""
    tr = make_trainer(None, epochs=1)
    try:
        tr.train()
        published = tr.publish_params()
        tr.registry.swap("default", published, epoch=9)
        live = tr.state.actor.state_dict()
        assert all(published[k].data_ptr() != live[k].data_ptr() for k in live)
        obs = np.random.default_rng(0).standard_normal((1, 3)).astype(np.float32)
        before = tr.client.act(obs, deterministic=True).action
        with torch.no_grad():
            for p in tr.state.actor.parameters():
                p.add_(1.0)  # a burst's in-place write
        after = tr.client.act(obs, deterministic=True).action
        np.testing.assert_array_equal(before, after)
        engine, params, _ = tr.registry.acquire("default")
        np.testing.assert_array_equal(after, engine.forward_eager(params, obs))
    finally:
        tr.close()


def test_a_quiesced_engine_holds_forwards_until_released():
    """``PolicyEngine.quiesced``: an act sent while the block runs waits
    for its end, then is served (none fails)."""
    tr = make_trainer(None, epochs=1)
    try:
        engine, _, _ = tr.registry.acquire("default")
        obs = np.zeros((1, 3), np.float32)
        done = threading.Event()
        out = []

        def act():
            out.append(tr.client.act(obs, deterministic=True, timeout=30.0))
            done.set()

        with engine.quiesced():
            thread = threading.Thread(target=act, daemon=True)
            thread.start()
            assert not done.wait(0.3)
        assert done.wait(30.0)
        thread.join(5.0)
        assert len(out) == 1 and np.isfinite(out[0].action).all()
    finally:
        tr.close()


def _learner_arrays(tr) -> list:
    s = tr.state
    return ([t.detach().clone() for m in (s.actor, s.critic, s.target_critic)
             for t in m.state_dict().values()]
            + [s.log_alpha.detach().clone()]
            + [torch.as_tensor(x).clone() for x in tr.buffer.state_dict().values()
               if isinstance(x, torch.Tensor)])


def test_decoupled_sigterm_resume_is_bitwise_including_staging(tmp_path):
    """SIGTERM mid-epoch 1, requeue exit, resume: the learner and the ring
    equal an uninterrupted run's bitwise. steps_per_epoch=44 leaves the
    epoch-1 boundary (step 88) 8 transitions past the last window drain
    (step 80), so the staged tail and the batcher's sampled-action
    generator must round-trip."""
    over = dict(epochs=3, steps_per_epoch=44, save_every=10)
    tra = make_trainer(tmp_path / "a", **over)
    try:
        tra.train()
        ref = _learner_arrays(tra)
        ref_staged = tra.staging.staged_total
    finally:
        tra.close()
    guard = PreemptionGuard().install()
    trb = make_trainer(tmp_path / "b", preemption=guard, **over)
    trb.pool = FaultyEnvPool(trb.pool).call_at(50, lambda: os.kill(os.getpid(), signal.SIGTERM))
    try:
        with pytest.raises(Preempted) as ei:
            trb.train()
    finally:
        guard.uninstall()
        trb.close()
    assert ei.value.exit_code == REQUEUE_EXIT_CODE
    meta = trb.checkpointer.peek_meta()
    assert meta["epoch"] == 1
    dec = meta["decoupled"]
    assert dec["staging"]["count"] == 8 and dec["batcher_key"]
    trc = make_trainer(tmp_path / "b", **{**over, "epochs": 1})
    try:
        assert trc.restore() == 2
        assert trc.staging.depth() == 8
        trc.train()
        got = _learner_arrays(trc)
        assert trc.staging.staged_total == ref_staged and trc.staging.conservation_holds()
    finally:
        trc.close()
    assert len(ref) == len(got)
    for x, y in zip(ref, got):
        assert torch.equal(x, y)


# ------------------------------------ what JAX composes with decoupled


def test_decoupled_with_actor_param_lag_acts_through_serving():
    """JAX's DecoupledTrainer acts through serving whatever the lag flag;
    the lag's acting snapshot serves only the degraded fallback."""
    tr = make_trainer(None, epochs=2, actor_param_lag=True)
    try:
        m = tr.train()
        assert np.isfinite(m["loss_q"]) and m["decoupled/conservation_ok"] == 1.0
        assert m["decoupled/fallback_actions_total"] == 0
        assert tr.actor.serving_actions_total == 2 * 40 - TINY["start_steps"]
        # The fallback reads the acting snapshot, stamped with the last
        # published tags.
        actions, gen, epoch = tr._local_fallback(np.zeros((1, 3), np.float32), False)
        assert actions.shape == (1, 1) and (gen, epoch) == (2, 1)
        assert tr._acting_fresh
    finally:
        tr.close()


def test_decoupled_with_replay_tiers_and_refill(tmp_path):
    from torch_actor_critic_tpu_torch.utils.tracking import Tracker

    tracker = Tracker(root=str(tmp_path / "runs"))
    cfg = SACConfig(**{**TINY, "epochs": 2, "buffer_size": 30, "replay_tiers": "disk",
                       "replay_refill": 4, "replay_host_capacity": 20})
    tr = DecoupledTrainer(ENV, cfg, tracker=tracker, seed=3, device="cpu")
    try:
        m = tr.train()
        assert m["decoupled/conservation_ok"] == 1.0 and m["replay/conservation_ok"] == 1.0
        assert m["replay/refill_rows_total"] > 0
        # The shadow saw exactly the drained windows.
        assert m["replay/pushed_total"] == m["decoupled/drained_total"]
    finally:
        tr.close()


def test_decoupled_with_telemetry_emits_decoupled_events(tmp_path):
    from torch_actor_critic_tpu_torch.utils.tracking import Tracker

    tracker = Tracker(root=str(tmp_path / "runs"))
    tr = DecoupledTrainer(ENV, SACConfig(**{**TINY, "epochs": 2, "telemetry": True}),
                          tracker=tracker, seed=3, device="cpu")
    try:
        tr.train()
    finally:
        tr.close()
    events = [json.loads(line) for line in open(tracker.run_dir / "telemetry.jsonl")]
    dec = [e for e in events if e.get("type") == "decoupled"]
    assert [e["epoch"] for e in dec] == [0, 1]
    assert dec[-1]["staging"]["staged_total"] == 80 and dec[-1]["published_generation"] == 2
    assert any(e.get("type") == "epoch" for e in events)
