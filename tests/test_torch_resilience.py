"""The port's resilience path on the CPU: full-state checkpoints, resume,
divergence rollback and preemption, held to the JAX package's own
resilience tests (``tests/test_resilience.py``): the same ``TINY``
config, fault schedule and pinned numbers, on ``PendulumNumpy-v1``.

- NaN reward at step 50 -> exactly 1 rollback, finite ring; no
  checkpointer -> ``TrainingDiverged`` ("no checkpoint"); budget 1 with
  NaN at 50 and 90 -> "consecutive".
- SIGTERM at step 45 -> ``Preempted`` (epoch 1, code 75), meta step 80,
  resume at epoch 2, final state bitwise equal to the uninterrupted run
  (flat, sequence policy at small width, flat with the normalizer);
  urgent preemption at step 52 -> meta step 60.
- Transient IO retried; ``drop-item``/``truncate`` fall back to epoch 0,
  ``drop-meta`` is skipped, an explicit epoch never falls back.
- A restore writes into the live tensors (their addresses and the burst
  graph's key stay), ``Optimizer.load_state_dict`` would not.
- Beside the JAX package: the SIGTERM scenario's control flow on
  gymnasium's ``Pendulum-v1``, the sentinel's counters, and the
  normalizers' statistics and outputs (exactly).
"""

import copy
import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

from torch_actor_critic_tpu_torch import run_agent
from torch_actor_critic_tpu_torch import train as train_mod
from torch_actor_critic_tpu_torch.buffer.replay import sample
from torch_actor_critic_tpu_torch.core.types import MultiObservation
from torch_actor_critic_tpu_torch.resilience import (
    REQUEUE_EXIT_CODE,
    DivergenceSentinel,
    Preempted,
    PreemptionGuard,
    TrainingDiverged,
    call_with_retries,
    tree_all_finite,
)
from torch_actor_critic_tpu_torch.resilience.faultinject import (
    FaultyEnvPool,
    corrupt_checkpoint,
    make_flaky,
)
from torch_actor_critic_tpu_torch.sac.algorithm import graph_key
from torch_actor_critic_tpu_torch.sac.graph import BurstGraph
from torch_actor_critic_tpu_torch.sac.trainer import Trainer
from torch_actor_critic_tpu_torch.utils.checkpoint import (
    CheckpointFormatError,
    Checkpointer,
    save_actor,
)
from torch_actor_critic_tpu_torch.utils.config import SACConfig
from torch_actor_critic_tpu_torch.utils.normalize import (
    FeaturesNormalizer,
    IdentityNormalizer,
    WelfordNormalizer,
)

ENV = "PendulumNumpy-v1"

# tests/test_resilience.py's TINY
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
)
SEQUENCE = dict(history_len=4, seq_d_model=16, seq_num_heads=2, seq_num_layers=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_trainer(ckpt_dir, seed=7, preemption=None, env=ENV, **over):
    cfg = SACConfig(**{**TINY, **over})
    ck = Checkpointer(ckpt_dir, retry_backoff_s=0.0) if ckpt_dir is not None else None
    return Trainer(env, cfg, checkpointer=ck, seed=seed, device="cpu", preemption=preemption)


def comparable_state(tr) -> dict:
    """Everything that defines the learner and the host loop: the full
    TrainState (networks, target, Adam moments and steps, log α, step,
    generator), the ring and its cursors, the acting generator and the
    normalizer."""
    return {
        "state": tr.state.state_dict(), "buffer": tr.buffer.state_dict(),
        "device_size": int(tr.buffer.device_size),
        "act": tr._act_gen.get_state(), "normalizer": tr.normalizer.state_dict(),
    }


def assert_bitwise(a, b, path="") -> None:
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_bitwise(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_bitwise(x, y, f"{path}/{i}")
    else:
        assert a == b, (path, a, b)


# ------------------------------------------------- path 1: NaN -> rollback


def test_nan_batch_rolls_back_and_recovers(tmp_path):
    tr = make_trainer(tmp_path / "ck", epochs=4)
    # Step 50 is inside epoch 1 (steps 40..79): epoch 0's checkpoint exists.
    tr.pool = FaultyEnvPool(tr.pool).nan_rewards_at(50)
    try:
        metrics = tr.train()
        assert tr.sentinel.total_rollbacks == 1
        assert metrics["rollbacks"] == 1
        assert np.isfinite(metrics["loss_q"]) and np.isfinite(metrics["loss_pi"])
        # The ring was rolled back too: the poisoned row is gone.
        assert torch.isfinite(tr.buffer.data.rewards).all()
        assert tree_all_finite(tr.state, tr.buffer.data)
    finally:
        tr.close()


def test_divergence_without_checkpoint_aborts():
    tr = make_trainer(None, epochs=2)
    tr.pool = FaultyEnvPool(tr.pool).nan_rewards_at(5)
    try:
        with pytest.raises(TrainingDiverged, match="no checkpoint"):
            tr.train()
    finally:
        tr.close()


def test_rollback_budget_bounds_consecutive_divergence(tmp_path):
    tr = make_trainer(tmp_path / "ck", epochs=4, max_rollbacks=1)
    tr.pool = FaultyEnvPool(tr.pool).nan_rewards_at(50).nan_rewards_at(90)
    try:
        with pytest.raises(TrainingDiverged, match="consecutive"):
            tr.train()
    finally:
        tr.close()


def test_nan_observation_rolls_back_the_ring(tmp_path):
    """A NaN next observation sits in the ring's ``next_states``; the
    rollback restores the ring of epoch 0, whose rows are finite."""
    tr = make_trainer(tmp_path / "ck", epochs=3)
    tr.pool = FaultyEnvPool(tr.pool).nan_obs_at(60)
    try:
        tr.train()
        assert tr.sentinel.total_rollbacks == 1
        assert tree_all_finite(tr.buffer.data)
    finally:
        tr.close()


# --------------------------------- path 2: SIGTERM -> save -> requeue code


@pytest.mark.parametrize("variant", [
    "flat",
    "sequence",  # the plain attention path at small width
    "normalized",  # flat, with Welford statistics in the checkpoint
])
def test_sigterm_preemption_saves_and_resume_is_bitwise(tmp_path, variant):
    over = {"flat": {}, "sequence": SEQUENCE,
            "normalized": {"normalize_observations": True}}[variant]
    tra = make_trainer(tmp_path / "a", epochs=3, save_every=10, **over)
    try:
        tra.train()
        ref = comparable_state(tra)
    finally:
        tra.close()

    guard = PreemptionGuard().install()
    trb = make_trainer(tmp_path / "b", epochs=3, save_every=10, preemption=guard, **over)
    trb.pool = FaultyEnvPool(trb.pool).call_at(
        45, lambda: os.kill(os.getpid(), signal.SIGTERM))
    try:
        with pytest.raises(Preempted) as ei:
            trb.train()
    finally:
        guard.uninstall()
        trb.close()
    assert ei.value.exit_code == REQUEUE_EXIT_CODE
    assert ei.value.epoch == 1
    meta = trb.checkpointer.peek_meta()
    assert meta["epoch"] == 1
    assert meta["step"] == 80  # epoch boundary: 2 epochs x 40 steps
    assert meta["act_key"]

    trc = make_trainer(tmp_path / "b", epochs=1, save_every=10, **over)
    try:
        assert trc.restore() == 2
        assert trc._resume_step == 80
        trc.train()
        got = comparable_state(trc)
    finally:
        trc.close()
    assert_bitwise(ref, got)
    if variant == "normalized":
        assert isinstance(trc.normalizer, WelfordNormalizer) and got["normalizer"]["count"] > 0


def test_urgent_preemption_saves_at_window_boundary(tmp_path):
    guard = PreemptionGuard()  # never installed: API-driven preemption
    tr = make_trainer(tmp_path / "ck", epochs=3, save_every=10, preemption=guard)
    tr.pool = FaultyEnvPool(tr.pool).call_at(
        52, lambda: guard.request_preemption(urgent=True))
    try:
        with pytest.raises(Preempted) as ei:
            tr.train()
    finally:
        tr.close()
    assert ei.value.urgent
    meta = tr.checkpointer.peek_meta()
    assert meta["epoch"] == 1
    assert meta["step"] == 60  # first window boundary after step 52

    tr2 = make_trainer(tmp_path / "ck", epochs=1, save_every=10)
    try:
        assert tr2.restore() == 2
        assert tr2._resume_step == 60
        m = tr2.train()
        assert np.isfinite(m["loss_q"])
        assert int(tr2.state.step) > 50  # gradient steps continued
    finally:
        tr2.close()


def _cli_args(root, *extra):
    return ["--environment", ENV, "--device", "cpu", "--runs-root", str(root),
            "--epochs", "1", "--steps-per-epoch", "40", "--start-steps", "10",
            "--update-after", "10", "--update-every", "10", "--batch-size", "16",
            "--buffer-size", "100", "--hidden-sizes", "16,16", *extra]


def test_train_cli_maps_preempted_to_requeue_exit_code(tmp_path, monkeypatch):
    def fake_train(self, on_epoch=None):
        raise Preempted(epoch=0)

    monkeypatch.setattr(Trainer, "train", fake_train)
    prev = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as ei:
        train_mod.main(_cli_args(tmp_path))
    assert ei.value.code == REQUEUE_EXIT_CODE
    assert signal.getsignal(signal.SIGTERM) == prev  # the guard was uninstalled


def test_cli_resumes_a_run_and_run_agent_evaluates_it(tmp_path, capsys):
    """``train --run <id>`` continues from the run's checkpoint with its
    stored config (another epoch, step counter continued); ``run_agent
    --run <id> --seed 0`` prints the same line twice."""
    train_mod.main(_cli_args(tmp_path, "--seed", "3"))
    first = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    run = first[-1]["run"]
    assert [r["epoch"] for r in first[:-1]] == [0]
    train_mod.main(["--run", run, "--runs-root", str(tmp_path), "--device", "cpu",
                    "--epochs", "5"])  # --epochs is ignored: the stored config holds
    second = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [r["epoch"] for r in second[:-1]] == [1] and second[-1]["run"] == run
    meta = Checkpointer(second[-1]["checkpoint_dir"]).peek_meta()
    assert (meta["epoch"], meta["step"]) == (1, 80)
    evals = []
    for _ in range(2):
        run_agent.main(["--run", run, "--runs-root", str(tmp_path), "--device", "cpu",
                        "--episodes", "2", "--seed", "0", "--headless"])
        evals.append(capsys.readouterr().out.strip().splitlines()[-1])
    assert evals[0] == evals[1]
    out = json.loads(evals[0])
    assert out["ep_len_mean"] == 200.0 and np.isfinite(out["ep_ret_mean"])
    if not torch.cuda.is_available():  # both CLIs default to the card
        for main, argv in ((run_agent.main, ["--episodes", "1"]), (train_mod.main, [])):
            with pytest.raises(RuntimeError, match="CUDA"):
                main(["--run", run, "--runs-root", str(tmp_path), *argv])


def test_cli_resume_of_an_unknown_run_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        train_mod.main(["--run", "nosuchrun", "--runs-root", str(tmp_path), "--device", "cpu"])


# ------------------------- path 3: checkpoint IO retry / corrupt fallback


def _trained(tmp_path, epochs=2):
    tr = make_trainer(tmp_path / "ck", epochs=epochs)  # checkpoints 0 .. epochs-1
    try:
        tr.train()
    finally:
        tr.close()
    return tr


def test_checkpoint_save_and_restore_retry_transient_io(tmp_path):
    tr = make_trainer(None)
    try:
        ck = Checkpointer(tmp_path / "ck", retries=2, retry_backoff_s=0.0,
                          sleep=lambda s: None)
        ck._write_epoch = make_flaky(ck._write_epoch, failures=2)
        ck.save(0, tr.state, tr.buffer, wait=True)  # 2 failures < 3 attempts -> lands
        ck._read_json = make_flaky(ck._read_json, failures=2)
        assert ck.peek_meta(0)["epoch"] == 0
        ck._read_file = make_flaky(ck._read_file, failures=2)
        ck.restore(tr.state, tr.buffer, epoch=0)

        ck2 = Checkpointer(tmp_path / "ck2", retries=1, retry_backoff_s=0.0,
                           sleep=lambda s: None)
        ck2._write_epoch = make_flaky(ck2._write_epoch, failures=2)
        with pytest.raises(OSError, match="injected"):
            ck2.save(0, tr.state, tr.buffer, wait=True)
    finally:
        tr.close()


# ------------------------- the asynchronous save and --no-save-buffer


def _filled_trainer(tmp_path):
    """A trained tiny trainer (its ring partly filled) and no checkpointer."""
    tr = make_trainer(None, epochs=1)
    tr.train()
    return tr


def test_async_save_files_equal_a_synchronous_saves_bitwise(tmp_path):
    """The host copies are taken before ``save`` returns: the files of an
    async save equal a synchronous save's even when the live state and
    ring change right after ``save`` returns (as the next replay changes
    them in place)."""
    tr = _filled_trainer(tmp_path)
    try:
        sync = Checkpointer(tmp_path / "sync")
        sync.save(0, tr.state, tr.buffer, extra={"step": 1}, wait=True)
        gate = threading.Event()
        ck = Checkpointer(tmp_path / "async")
        real = ck._write_epoch

        def held(*a):
            gate.wait(timeout=60)
            return real(*a)

        ck._write_epoch = held
        ck.save(0, tr.state, tr.buffer, extra={"step": 1})
        with torch.no_grad():
            for p in tr.state.actor.parameters():
                p.add_(1.0)
            for leaf in tr.buffer.data.leaves():
                leaf.add_(1.0)
        gate.set()
        ck.wait()
        for name in ("actor.pt", "state.pt", "buffer.pt"):
            assert_bitwise(torch.load(tmp_path / "async" / "epoch_0" / name, weights_only=True),
                           torch.load(tmp_path / "sync" / "epoch_0" / name, weights_only=True),
                           name)
        assert ck.peek_meta(0) == sync.peek_meta(0)
        ring = torch.load(tmp_path / "async" / "epoch_0" / "buffer.pt", weights_only=True)
        assert ring["leaves"]["rewards"].shape == (tr.buffer.size,)  # rows [0, size) only
        # The host ring buffers are kept and reused by the next save.
        held_rows = dict(ck._host_ring)
        ck.save(1, tr.state, tr.buffer, wait=True)
        assert all(ck._host_ring[k] is v for k, v in held_rows.items())
    finally:
        tr.close()


def test_epochs_report_the_background_writes_seconds(tmp_path):
    """``save_s`` is the training thread's time in ``save``; the write
    runs in the background and ``save_write_s`` is the newest finished
    write's seconds: absent before any write has finished, then the
    checkpointer's ``last_write_s``."""
    seen = []
    tr = make_trainer(tmp_path / "ck", epochs=3)
    try:
        tr.train(on_epoch=lambda e, m: seen.append(m))
    finally:
        tr.close()
    assert all(m["save_s"] >= 0.0 for m in seen)
    # Each save first waits for the write before it, so from the second
    # epoch on a write has finished when the epoch reports.
    assert all(m["save_write_s"] > 0.0 for m in seen[1:])
    assert tr.checkpointer.last_write_s > 0.0


def test_latest_epoch_skips_an_epoch_whose_write_is_in_flight(tmp_path):
    tr = _filled_trainer(tmp_path)
    try:
        ck = Checkpointer(tmp_path / "ck")
        ck.save(0, tr.state, tr.buffer, wait=True)
        gate = threading.Event()
        real = ck._write_epoch

        def held(*a):
            gate.wait(timeout=60)
            return real(*a)

        ck._write_epoch = held
        ck.save(1, tr.state, tr.buffer)  # returns with the write held
        assert ck._writer.is_alive() and ck.latest_epoch() == 0
        gate.set()
        ck.wait()
        assert ck.latest_epoch() == 1
        gate.clear()
        ck.save(1, tr.state, tr.buffer)  # rewriting an epoch: skipped until its meta lands
        assert ck.latest_epoch() == 0
        gate.set()
        ck.wait()
        assert ck.latest_epoch() == 1
    finally:
        tr.close()


def test_a_failing_writer_surfaces_at_wait_after_the_retries(tmp_path):
    tr = _filled_trainer(tmp_path)
    try:
        ck = Checkpointer(tmp_path / "ck", retries=1, retry_backoff_s=0.0, sleep=lambda s: None)
        ck._write_epoch = make_flaky(ck._write_epoch, failures=2)
        ck.save(0, tr.state, tr.buffer)  # returns: the writer fails behind it
        with pytest.raises(OSError, match="injected"):
            ck.wait()
        ck.wait()  # raised once
        ck._write_epoch = make_flaky(ck._write_epoch, failures=5)
        ck.save(1, tr.state, tr.buffer)
        with pytest.raises(OSError, match="injected"):
            ck.save(2, tr.state, tr.buffer)  # the next save raises it first
        assert ck.latest_epoch() is None
    finally:
        tr.close()


def test_no_save_buffer_writes_no_ring_and_resumes_empty(tmp_path, capsys):
    argv = ["--environment", ENV, "--device", "cpu", "--runs-root", str(tmp_path),
            "--epochs", "1", "--steps-per-epoch", "40", "--start-steps", "10",
            "--update-after", "10", "--update-every", "10", "--batch-size", "16",
            "--hidden-sizes", "16,16", "--buffer-size", "500", "--no-save-buffer"]
    train_mod.main(argv)
    run_id = next((tmp_path / "Default").iterdir()).name
    epoch_dir = tmp_path / "Default" / run_id / "artifacts" / "checkpoints" / "epoch_0"
    assert sorted(p.name for p in epoch_dir.iterdir()) == ["actor.pt", "meta.json", "state.pt"]
    assert json.loads((epoch_dir / "meta.json").read_text())["buffer"] is False
    trainer, _ = train_mod.build_trainer(train_mod.parse_arguments(
        ["--run", run_id, "--runs-root", str(tmp_path), "--device", "cpu"]))
    try:
        assert trainer.start_epoch == 1 and trainer.state.step > 0
        assert trainer.buffer.size == 0 and int(trainer.buffer.device_size) == 0
        m = trainer.train()  # pushes its first window, then updates
        assert np.isfinite(m["loss_q"]) and trainer.buffer.size == 40
    finally:
        trainer.close()


def test_retry_backoff_is_exponential_and_fnf_gives_up():
    sleeps = []
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    assert call_with_retries(flaky, attempts=3, base_delay_s=0.5, sleep=sleeps.append) == "ok"
    assert sleeps == [0.5, 1.0]

    def missing():
        raise FileNotFoundError("gone for good")

    with pytest.raises(FileNotFoundError):
        call_with_retries(missing, attempts=3, base_delay_s=0.5, sleep=sleeps.append)
    assert sleeps == [0.5, 1.0]


@pytest.mark.parametrize("mode", ["drop-item", "truncate"])
def test_corrupt_newest_checkpoint_falls_back_to_previous(tmp_path, mode):
    _trained(tmp_path)
    corrupt_checkpoint(tmp_path / "ck", 1, mode=mode)
    tr2 = make_trainer(tmp_path / "ck", epochs=1)
    try:
        assert tr2.restore() == 1  # fell back: resumes AFTER epoch 0
        m = tr2.train()
        assert np.isfinite(m["loss_q"])
    finally:
        tr2.close()


def test_unreadable_meta_is_skipped_by_latest_epoch(tmp_path):
    _trained(tmp_path)
    corrupt_checkpoint(tmp_path / "ck", 1, mode="drop-meta")
    ck = Checkpointer(tmp_path / "ck")
    assert ck.latest_epoch() == 0
    assert ck.peek_meta()["epoch"] == 0


def test_explicit_epoch_never_falls_back(tmp_path):
    _trained(tmp_path)
    corrupt_checkpoint(tmp_path / "ck", 1, mode="drop-item")
    tr2 = make_trainer(tmp_path / "ck", epochs=1)
    try:
        with pytest.raises(FileNotFoundError):
            tr2.restore(epoch=1)
    finally:
        tr2.close()


def test_checkpoint_meta_carries_resume_state(tmp_path):
    _trained(tmp_path, epochs=1)
    meta = Checkpointer(tmp_path / "ck").peek_meta()
    assert meta["step"] == 40
    assert len(meta["act_key"]) == torch.Generator().get_state().numel()
    assert meta["act_key_device"] == "cpu"
    json.dumps(meta)  # the whole meta stays JSON-serializable


def test_checkpointer_keeps_the_newest_epochs(tmp_path):
    _trained(tmp_path, epochs=4)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "epoch_1", "epoch_2", "epoch_3"]


def test_checkpoint_of_another_algorithm_raises_before_reading_arrays(tmp_path):
    _trained(tmp_path, epochs=1)
    meta_path = tmp_path / "ck" / "epoch_0" / "meta.json"
    meta = json.loads(meta_path.read_text())
    meta["config"] = SACConfig(algorithm="td3").to_json()
    meta_path.write_text(json.dumps(meta))
    (tmp_path / "ck" / "epoch_0" / "state.pt").unlink()  # would raise otherwise
    tr = make_trainer(tmp_path / "ck")
    try:
        with pytest.raises(ValueError, match="algorithm='td3'"):
            tr.restore()
    finally:
        tr.close()


def test_an_actor_only_checkpoint_holds_no_learner_state(tmp_path):
    tr = make_trainer(tmp_path / "ck")
    try:
        save_actor(tmp_path / "ck", 0, tr.state.actor, tr.config)
        with pytest.raises(CheckpointFormatError, match="actor-only"):
            tr.restore()
    finally:
        tr.close()


# ------------------------------------------------ path 4: in-place restore


def _live_tensors(tr) -> list:
    st = tr.state
    return [
        *(x for m in (st.actor, st.critic, st.target_critic) for x in m.state_dict().values()),
        *(x for o in (st.pi_opt, st.q_opt, st.alpha_opt)
          for s in o.state.values() for x in s.values()),
        st.log_alpha, *tr.buffer.data.leaves(), tr.buffer.device_size,
    ]


def test_restore_writes_into_the_live_tensors(tmp_path):
    """A rollback restores into the tensors a captured burst holds: every
    parameter, Adam moment and step, log α, ring leaf and the device
    size keep their storage, the burst graph's key still serves, and
    the values are the checkpoint's, bitwise."""
    tr = make_trainer(tmp_path / "ck", epochs=1)
    try:
        tr.train()
        saved = comparable_state(tr)
        chunk = sample(tr.buffer, 10, generator=torch.Generator().manual_seed(0))
        # a burst moves every tensor: networks, Adam, the ring, its size
        tr.state, tr.buffer, _ = tr.sac.update_burst(tr.state, tr.buffer, chunk, 5)
        before = [x.data_ptr() for x in _live_tensors(tr)]
        key = graph_key(tr.state, tr.buffer)
        graph = BurstGraph(lambda stack: None, key, 10, tr.state.generator)
        tr.state, tr.buffer, _ = tr.checkpointer.restore(tr.state, tr.buffer, epoch=0)
        assert [x.data_ptr() for x in _live_tensors(tr)] == before
        assert graph.serves(graph_key(tr.state, tr.buffer), 10)
        saved.pop("act")  # the host loop's, restored by Trainer.restore
        saved.pop("normalizer")
        got = comparable_state(tr)
        got.pop("act")
        got.pop("normalizer")
        assert_bitwise(saved, got)
        # Optimizer.load_state_dict of a snapshot (here a copy, as read
        # from a file) builds new state tensors: a graph holding the old
        # ones must not serve.
        tr.state.q_opt.load_state_dict(copy.deepcopy(tr.state.q_opt.state_dict()))
        assert not graph.serves(graph_key(tr.state, tr.buffer), 10)
    finally:
        tr.close()


def test_restore_into_a_fresh_learner_and_of_a_stateless_adam(tmp_path):
    """A fresh trainer (no Adam state yet) gets new state tensors placed
    as Adam places them; a snapshot taken before any update clears the
    live Adam state, and a burst graph holding it no longer serves."""
    tr = make_trainer(tmp_path / "ck", epochs=1)
    fresh = make_trainer(None)
    try:
        empty = fresh.state.state_dict()
        tr.train()
        snap = tr.state.state_dict()
        fresh.state.load_state_dict_(snap)
        step = next(iter(fresh.state.q_opt.state.values()))["step"]
        assert step.device.type == "cpu" and step.dtype == torch.float32
        assert_bitwise(fresh.state.state_dict(), snap)
        graph = BurstGraph(lambda stack: None, graph_key(tr.state, tr.buffer), 10,
                           tr.state.generator)
        tr.state.load_state_dict_(empty)
        assert not tr.state.q_opt.state and tr.state.step == 0
        assert not graph.serves(graph_key(tr.state, tr.buffer), 10)
    finally:
        tr.close()
        fresh.close()


# -------------------------------------------------------- normalizer choice


def test_trainer_picks_the_jax_trainers_normalizer(caplog):
    cases = [
        (ENV, {}, WelfordNormalizer),
        (ENV, SEQUENCE, IdentityNormalizer),
        ("PixelPendulumBalanceNumpy-v0", dict(filters=(8,), kernel_sizes=(4,), strides=(2,),
                                              cnn_dense_size=16, cnn_features=8),
         FeaturesNormalizer),
    ]
    for env, over, kind in cases:
        tr = make_trainer(None, env=env, normalize_observations=True, buffer_size=10, **over)
        try:
            assert type(tr.normalizer) is kind
        finally:
            tr.close()
    assert "history stack" in caplog.text


# ----------------------------------------------------------- unit pieces


def test_tree_all_finite_skips_non_inexact_leaves():
    assert tree_all_finite({
        "i": torch.arange(3), "f": torch.ones(3), "b": torch.tensor([True]),
        "u8": torch.full((2,), 255, dtype=torch.uint8), "g": torch.Generator(), "n": 3,
    })
    assert not tree_all_finite({"f": torch.tensor([1.0, float("nan")])})
    assert not tree_all_finite(torch.tensor([float("inf")]))
    assert not tree_all_finite([MultiObservation(torch.tensor([float("nan")]),
                                                 torch.zeros(1, dtype=torch.uint8))])
    assert tree_all_finite()  # vacuously true


def test_sentinel_budget_resets_on_good_interval():
    s = DivergenceSentinel(max_rollbacks=1)
    s.note_divergence()
    s.note_good()  # a finite epoch closes the streak
    s.note_divergence()
    with pytest.raises(TrainingDiverged):
        s.note_divergence()
    assert s.total_rollbacks == 3


def test_guard_signal_escalation():
    prev = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard().install()
    try:
        assert not guard.triggered and not guard.urgent
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.triggered and not guard.urgent
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.urgent
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) == prev


# -------------------------------------------------- beside the JAX package


def test_sigterm_control_flow_matches_the_jax_trainer(tmp_path):
    """The JAX trainer and the port's, SIGTERM at step 45 of gymnasium's
    Pendulum-v1: the same epoch and exit code, the same meta epoch and
    step (every key of the JAX meta present in the port's), the same
    resume epoch and step."""
    from torch_actor_critic_tpu.parallel import make_mesh
    from torch_actor_critic_tpu.resilience.faultinject import FaultyEnvPool as JaxFaultyPool
    from torch_actor_critic_tpu.resilience.preemption import PreemptionGuard as JaxGuard
    from torch_actor_critic_tpu.sac.trainer import Trainer as JaxTrainer
    from torch_actor_critic_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
    from torch_actor_critic_tpu.utils.config import SACConfig as JaxConfig

    def jax_trainer(d, preemption=None):
        cfg = JaxConfig(**{**TINY, "save_every": 10})
        return JaxTrainer("Pendulum-v1", cfg, mesh=make_mesh(dp=1),
                          checkpointer=JaxCheckpointer(d, retry_backoff_s=0.0), seed=7,
                          preemption=preemption)

    def port_trainer(d, preemption=None):
        return make_trainer(d, env="Pendulum-v1", save_every=10, preemption=preemption)

    out = {}
    for name, build, guard_cls, faulty in (
            ("jax", jax_trainer, JaxGuard, JaxFaultyPool),
            ("port", port_trainer, PreemptionGuard, FaultyEnvPool)):
        guard = guard_cls()
        tr = build(tmp_path / name, preemption=guard)
        tr.pool = faulty(tr.pool).call_at(
            45, lambda: os.kill(os.getpid(), signal.SIGTERM))
        guard.install()
        try:
            with pytest.raises(Exception) as ei:
                tr.train()
        finally:
            guard.uninstall()
            tr.close()
        meta = tr.checkpointer.peek_meta()
        resumed = build(tmp_path / name)
        try:
            start = resumed.restore()
        finally:
            resumed.close()
        out[name] = {"raised": type(ei.value).__name__, "epoch": ei.value.epoch,
                     "code": ei.value.exit_code, "urgent": ei.value.urgent,
                     "meta": (meta["epoch"], meta["step"]), "keys": set(meta),
                     "resume": (start, resumed._resume_step)}
    jax_keys = out["jax"].pop("keys")
    assert jax_keys <= out["port"].pop("keys"), jax_keys
    assert out["port"] == out["jax"] == {
        "raised": "Preempted", "epoch": 1, "code": 75, "urgent": False,
        "meta": (1, 80), "resume": (2, 80)}


def test_sentinel_counters_match_the_jax_sentinel():
    """One sequence of checks (finite and non-finite trees) through both
    sentinels: the same verdicts, counters and the raise at the same
    call."""
    from torch_actor_critic_tpu.resilience.sentinel import (
        DivergenceSentinel as JaxSentinel,
    )
    from torch_actor_critic_tpu.resilience.sentinel import (
        TrainingDiverged as JaxDiverged,
    )

    rng = np.random.default_rng(0)
    pattern = [True, False, True, False, False, True, False, False, False]
    sentinels = {"jax": JaxSentinel(max_rollbacks=2), "port": DivergenceSentinel(2)}
    raised_at = {}
    for i, finite in enumerate(pattern):
        tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
                "i": np.arange(3), "loss": np.float32(1.5)}
        if not finite:
            tree["w"][1, 2] = np.nan if i % 2 else np.inf
        trees = {"jax": tree, "port": {k: torch.as_tensor(v) for k, v in tree.items()}}
        for name, s in sentinels.items():
            if name in raised_at:
                continue
            ok = s.check(trees[name])
            assert ok == finite
            try:
                s.note_good() if ok else s.note_divergence()
            except (JaxDiverged, TrainingDiverged):
                raised_at[name] = i
        counters = [(s.consecutive, s.total_rollbacks) for s in sentinels.values()]
        assert counters[0] == counters[1], (i, counters)
    assert raised_at == {"jax": 8, "port": 8}


def test_normalizers_equal_the_jax_normalizers_exactly():
    """One seeded stream of single observations and batches: the same
    statistics and the same outputs to the bit (the same numpy
    arithmetic), and each state dict loads into the other."""
    from torch_actor_critic_tpu.core.types import MultiObservation as JaxMultiObservation
    from torch_actor_critic_tpu.utils.normalize import (
        FeaturesNormalizer as JaxFeatures,
    )
    from torch_actor_critic_tpu.utils.normalize import (
        WelfordNormalizer as JaxWelford,
    )

    rng = np.random.default_rng(3)
    jw, pw = JaxWelford(5), WelfordNormalizer(5)
    jf, pf = JaxFeatures(4), FeaturesNormalizer(4)
    for i in range(40):
        shape = (5,) if i % 3 else (int(rng.integers(2, 6)), 5)
        x = (rng.standard_normal(shape) * 3 + 1.5).astype(np.float32)
        update = i % 7 != 6
        np.testing.assert_array_equal(jw.normalize(x, update=update),
                                      pw.normalize(x, update=update))
        feats = rng.standard_normal(4).astype(np.float32) * 10
        frame = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
        jo = jf.normalize(JaxMultiObservation(features=feats, frame=frame), update=update)
        po = pf.normalize(MultiObservation(feats, frame), update=update)
        np.testing.assert_array_equal(jo.features, po.features)
        assert po.frame is frame
    assert jw.state_dict() == pw.state_dict()
    assert jf.state_dict() == pf.state_dict()
    back, x = WelfordNormalizer(5), rng.standard_normal(5).astype(np.float32)
    back.load_state_dict(jw.state_dict())
    np.testing.assert_array_equal(back.normalize(x, update=False), jw.normalize(x, update=False))
