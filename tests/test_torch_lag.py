"""``actor_param_lag`` in the port's host trainer: acting one update window
stale (the JAX trainer's flag, ``tests/test_trainer.py::
test_actor_param_lag_trains_and_keeps_mirror_warm``).

On the CPU the acting snapshot is refreshed by ``copy_`` with no second
stream; the semantics held here are the card's too: the snapshot holds
the pre-burst parameters (never the live ones after a burst), each
window after a burst acts on the parameters from before it, evaluation
acts on the live ones, and a restore makes the next acting step read the
restored ones. The fused on-device entry points accept both host-loop
flags and ignore them, as JAX's fused loop does.
"""

import copy
import itertools

import numpy as np
import pytest
import torch

from torch_actor_critic_tpu_torch import train as train_mod
from torch_actor_critic_tpu_torch.sac.ondevice import train_on_device, train_population_on_device
from torch_actor_critic_tpu_torch.sac.trainer import NOT_PORTED, Trainer
from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer
from torch_actor_critic_tpu_torch.utils.config import SACConfig

TINY = dict(hidden_sizes=(16, 16), batch_size=8, epochs=1, steps_per_epoch=60,
            start_steps=20, update_after=20, update_every=10, buffer_size=200,
            actor_param_lag=True, save_every=1)
SEQ = dict(history_len=4, seq_d_model=16, seq_num_heads=2, seq_num_layers=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tensors(module) -> list:
    return [t.detach().clone() for t in itertools.chain(module.parameters(), module.buffers())]


def _equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _trainer(population: int = 1, ckpt=None, **over) -> Trainer:
    cfg = SACConfig(**{**TINY, "population": population, **over})
    return Trainer("PendulumNumpy-v1", cfg, seed=2, device="cpu",
                   checkpointer=None if ckpt is None else Checkpointer(ckpt, retry_backoff_s=0.0))


def _record(tr: Trainer) -> dict:
    """Wrap the burst, the snapshot's refresh and the acting of ``tr``:
    the actor's parameters at the start of each burst (under the lag, in
    the burst thread) and at each refresh, and for each policy step the
    actor it acted through, its observations, the acting generator's
    state, the actions and the counts of bursts and refreshes so far."""
    seen = {"pre_burst": [], "refreshed": [], "acts": []}
    burst, act, refresh = tr.sac.update_burst, tr._act, tr._refresh_acting

    def update_burst(*a, **k):
        seen["pre_burst"].append(_tensors(tr.state.actor))
        return burst(*a, **k)

    def record_refresh():
        seen["refreshed"].append(_tensors(tr.state.actor))
        refresh()

    def record_act(actor, obs_batch, deterministic):
        gen = tr._act_gen.get_state()
        out = act(actor, obs_batch, deterministic)
        seen["acts"].append({"actor": _tensors(actor), "obs": copy.deepcopy(obs_batch),
                             "gen": gen, "det": deterministic, "actions": out,
                             "bursts": len(seen["pre_burst"]),
                             "refreshes": len(seen["refreshed"])})
        return out

    tr.sac.update_burst, tr._act, tr._refresh_acting = update_burst, record_act, record_refresh
    return seen


@pytest.mark.parametrize("population,over", [(1, {}), (1, SEQ), (2, {})],
                         ids=["flat", "history", "population"])
def test_snapshot_is_the_pre_burst_actor_and_windows_act_on_it(population, over):
    tr = _trainer(population, **over)
    try:
        seen = _record(tr)
        metrics = tr.train()
        assert np.isfinite(metrics["loss_q"])
        pre, refreshed = seen["pre_burst"], seen["refreshed"]
        assert len(pre) == 4  # windows end at 9, 19, ..., 59; bursts once step > 20
        # The first acting step refreshed the stale snapshot from the live
        # actor; each later refresh took the actor from before a burst.
        assert len(refreshed) == 1 + len(pre)
        assert all(_equal(r, p) for r, p in zip(refreshed[1:], pre, strict=True))
        # After the epoch: the snapshot holds the parameters from before
        # the last burst, not the live ones.
        assert _equal(_tensors(tr._acting), pre[-1])
        assert not _equal(_tensors(tr._acting), _tensors(tr.state.actor))
        # Every policy step after burst k acted on the pre-burst-k actor, and
        # recomputing its actions from those parameters with the same
        # generator state gives the same actions.
        after = [a for a in seen["acts"] if a["refreshes"] > 1]
        assert after
        replica = copy.deepcopy(tr.state.actor)
        for a in after:
            want = pre[a["refreshes"] - 2]
            assert _equal(a["actor"], want)
            with torch.no_grad():
                for dst, src in zip(itertools.chain(replica.parameters(), replica.buffers()),
                                    want):
                    dst.copy_(src)
            tr._act_gen.set_state(a["gen"])
            with torch.inference_mode():
                again = tr._act(replica, a["obs"], a["det"])
            np.testing.assert_array_equal(again, a["actions"])
    finally:
        tr.close()


def test_without_the_flag_acting_reads_the_live_actor():
    tr = _trainer(actor_param_lag=False)
    try:
        seen = _record(tr)
        tr.train()
        assert tr._acting is None
        # The window after a burst acts on the post-burst parameters.
        after = [a for a in seen["acts"] if a["bursts"] > 0]
        assert after and not _equal(after[0]["actor"], seen["pre_burst"][after[0]["bursts"] - 1])
    finally:
        tr.close()


def test_evaluate_acts_on_the_live_parameters():
    tr = _trainer()
    try:
        tr.train()
        assert not _equal(_tensors(tr._acting), _tensors(tr.state.actor))
        seen = _record(tr)
        ev = tr.evaluate(episodes=1, deterministic=True, seed=7)
        assert np.isfinite(ev["ep_ret_mean"]) and seen["acts"]
        live = _tensors(tr.state.actor)
        assert all(_equal(a["actor"], live) for a in seen["acts"])
    finally:
        tr.close()


def test_restore_makes_the_next_acting_step_read_the_restored_actor(tmp_path):
    tr = _trainer(ckpt=tmp_path, epochs=2)
    try:
        tr.train()
        tr.checkpointer.wait()
        assert tr.restore(epoch=0) == 1
        restored = _tensors(tr.state.actor)
        assert not tr._acting_fresh
        obs = np.zeros((1, 3), np.float32)
        tr._policy_actions(obs, deterministic=True)
        assert _equal(_tensors(tr._acting), restored)
    finally:
        tr.close()


def test_warmup_acting_takes_no_snapshot():
    tr = _trainer(steps_per_epoch=20, start_steps=100, update_after=100)
    try:
        seen = _record(tr)
        tr.train()
        assert not seen["acts"] and not tr._acting_fresh
    finally:
        tr.close()


def test_the_host_loop_flags_are_ported():
    assert "parallel_envs" not in NOT_PORTED and "actor_param_lag" not in NOT_PORTED
    with pytest.raises(ValueError, match="actor_param_lag"):
        SACConfig(actor_param_lag=True, host_actor=False)


@pytest.mark.parametrize("population", [1, 2])
def test_the_train_cli_takes_both_flags(tmp_path, capsys, population):
    final = train_mod.main([
        "--environment", "PendulumNumpy-v1", "--device", "cpu", "--epochs", "1",
        "--steps-per-epoch", "40", "--start-steps", "10", "--update-after", "10",
        "--update-every", "10", "--hidden-sizes", "8", "--batch-size", "8",
        "--buffer-size", "100", "--runs-root", str(tmp_path), "--population",
        str(population), "--parallel-envs", "true", "--actor-param-lag", "true",
        "--env-start-method", "fork"])
    capsys.readouterr()
    assert np.isfinite(final["loss_q"])


@pytest.mark.parametrize("population", [1, 2])
def test_the_fused_loops_accept_and_ignore_the_host_loop_flags(population):
    """The on-device entry points take ``parallel_envs`` and
    ``actor_param_lag`` (the host trainer's) and train as without them:
    equal metrics from one seed."""
    base = dict(hidden_sizes=(16, 16), batch_size=8, epochs=1, steps_per_epoch=20,
                start_steps=10, update_after=10, update_every=10, buffer_size=100,
                on_device=True, on_device_envs=2, population=population)
    entry = train_population_on_device if population > 1 else train_on_device
    runs = [entry("Pendulum-v1", SACConfig(**base, **flags), seed=0, device="cpu")
            for flags in ({}, {"parallel_envs": True, "actor_param_lag": True})]
    for k in ("loss_q", "loss_pi", "reward"):  # reward is NaN: no episode ended
        np.testing.assert_array_equal(runs[0][k], runs[1][k])
