"""The port's env pools (``torch_actor_critic_tpu_torch/envs/vec_env.py``)
against the JAX package's, and the host trainer over the parallel pool.

The port's :class:`SequentialEnvPool` and :class:`ParallelEnvPool` (one
worker process per env over the port's own native runtime) are held to
the JAX :class:`SequentialEnvPool` bitwise on gymnasium's Pendulum-v1,
flat and as a history; the parallel pool's parent-side warm-up draws to
the JAX parallel pool's exactly; a visual env's two leaves (f32
features, uint8 frame) cross the shared block bitwise. Parallel pools
here fork (monkeypatched env factories reach the workers and startup is
fast; workers only step numpy envs); one test spawns, the default.
"""

import logging
import os
import signal
import time

import numpy as np
import pytest
import torch

from torch_actor_critic_tpu.envs.vec_env import ParallelEnvPool as JParallelEnvPool
from torch_actor_critic_tpu.envs.vec_env import SequentialEnvPool as JSequentialEnvPool
from torch_actor_critic_tpu_torch import native
from torch_actor_critic_tpu_torch.envs import vec_env
from torch_actor_critic_tpu_torch.envs.vec_env import (
    ParallelEnvPool,
    SequentialEnvPool,
    make_env_pool,
)
from torch_actor_critic_tpu_torch.sac.trainer import Trainer
from torch_actor_critic_tpu_torch.utils.config import SACConfig

needs_native = pytest.mark.skipif(native.load_runtime() is None,
                                  reason="native runtime unavailable (no g++)")

OBS, ACT = 5, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(obs):
    return [obs.features, obs.frame] if hasattr(obs, "frame") else [obs]


def _assert_same(a, b, f32_scalars: bool = False):
    """Bitwise equal step outputs (or observations), dtypes included.
    ``f32_scalars``: ``step_at``'s reward is compared in float32, in which
    the parallel pool carries it through shared memory (as the JAX
    package's does)."""
    if isinstance(a, tuple) and not hasattr(a, "frame"):
        for x, y in zip(a, b, strict=True):
            _assert_same(x, y, f32_scalars)
        return
    if isinstance(a, (float, bool)):
        assert type(a) is type(b)
        assert (np.float32(a) == np.float32(b)) if f32_scalars else a == b
        return
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


class FakeEnv:
    """A trajectory that is a pure function of the seed and the actions;
    raises on a poison action."""

    def __init__(self, seed=0):
        from torch_actor_critic_tpu_torch.envs.wrappers import ObsSpec

        self.seed0 = seed or 0
        self.act_dim, self.act_limit = ACT, 1.0
        self.obs_spec = ObsSpec((OBS,), np.float32)
        self._t, self._state = 0, None
        self._rng = np.random.default_rng(self.seed0)

    def reset(self, seed=None):
        self._t = 0
        self._state = np.full(OBS, float((self.seed0 if seed is None else seed) % 97), np.float32)
        return self._state.copy()

    def step(self, action):
        if float(action[0]) > 50.0:
            raise ValueError("poison action")
        self._t += 1
        self._state = (self._state * 0.9 + float(action.sum())).astype(np.float32)
        return self._state.copy(), float(self._state[0]), self._t % 13 == 0, False

    def sample_action(self):
        return self._rng.uniform(-1, 1, ACT).astype(np.float32)

    def render(self):
        pass

    def close(self):
        pass


@pytest.fixture
def fake_factory(monkeypatch):
    monkeypatch.setattr(vec_env, "make_env", lambda name, seed=None, **kw: FakeEnv(seed))


def _drive(pool, n, act_limit, seeds, steps=30):
    """reset_all, ``steps`` lockstep steps, a seeded reset_at and a step_at."""
    rng = np.random.default_rng(0)
    out = [pool.reset_all(seeds)]
    for _ in range(steps):
        out.append(pool.step(rng.uniform(-act_limit, act_limit, (n, 1)).astype(np.float32)))
    out.append(pool.reset_at(n // 2, seed=99))
    out.append(pool.step_at(n // 2, np.full(1, 0.5, np.float32)))
    return out


@needs_native
@pytest.mark.parametrize("env", ["Pendulum-v1", "Pendulum-v1|history:4", "dm:cartpole:balance"])
def test_pools_equal_the_jax_sequential_pool_bitwise(env):
    pytest.importorskip("dm_control" if env.startswith("dm:") else "gymnasium")
    n, base = 4, 3
    seeds = [base + 10000 * i for i in range(n)]
    ref = JSequentialEnvPool(env, n, base_seed=base)
    seq = SequentialEnvPool(env, n, base_seed=base)
    par = ParallelEnvPool(env, n, base_seed=base, timeout_s=60, start_method="fork")
    try:
        assert par.act_dim == seq.act_dim == ref.act_dim == 1
        assert par.obs_spec.shape == seq.obs_spec.shape == tuple(ref.obs_spec.shape)
        want = _drive(ref, n, ref.act_limit, seeds)
        for pool in (seq, par):
            for a, b in zip(_drive(pool, n, ref.act_limit, seeds), want, strict=True):
                _assert_same(a, b, f32_scalars=pool is par)
    finally:
        for pool in (ref, seq, par):
            pool.close()


@needs_native
def test_parallel_warmup_draws_equal_the_jax_parallel_pool(fake_factory, monkeypatch):
    """Both pools draw warm-up actions on the parent side from
    ``np.random.default_rng(base_seed)``: equal, draw for draw."""
    import torch_actor_critic_tpu.envs.wrappers as jax_wrappers

    monkeypatch.setattr(jax_wrappers, "make_env", lambda name, seed=None, **kw: FakeEnv(seed))
    ours = ParallelEnvPool("Fake-v0", 2, base_seed=11, timeout_s=60, start_method="fork")
    theirs = JParallelEnvPool("Fake-v0", 2, base_seed=11, timeout_s=60, start_method="fork")
    try:
        for _ in range(3):
            a, b = ours.sample_actions(), theirs.sample_actions()
            assert a.dtype == b.dtype == np.float32 and a.shape == (2, ACT)
            np.testing.assert_array_equal(a, b)
    finally:
        ours.close()
        theirs.close()


@needs_native
def test_visual_leaves_cross_shared_memory_bitwise():
    env, n = "PixelPendulumBalanceNumpy-v0", 3
    seq = SequentialEnvPool(env, n, base_seed=5)
    par = ParallelEnvPool(env, n, base_seed=5, timeout_s=60, start_method="fork")
    try:
        assert par.obs_spec.frame.dtype == np.uint8 and par.obs_spec.frame.shape == (32, 32, 3)
        assert par.obs_spec.features.dtype == np.float32
        seeds = [1, 2, 3]
        got, want = _drive(par, n, 2.0, seeds, steps=20), _drive(seq, n, 2.0, seeds, steps=20)
        for a, b in zip(got, want, strict=True):
            _assert_same(a, b, f32_scalars=True)
        assert got[1][0].frame.dtype == np.uint8 and got[1][0].frame.any()
    finally:
        par.close()
        seq.close()


@needs_native
def test_observations_are_copies_out_of_shared_memory(fake_factory):
    """The trainer stages a window of observations: a returned batch must
    not change under the next step."""
    par = ParallelEnvPool("Fake-v0", 2, base_seed=0, timeout_s=30, start_method="fork")
    try:
        first = par.reset_all()
        kept = first.copy()
        par.step(np.ones((2, ACT), np.float32))
        np.testing.assert_array_equal(first, kept)
    finally:
        par.close()


@needs_native
def test_worker_env_exception_is_reported(fake_factory):
    par = ParallelEnvPool("Fake-v0", 2, base_seed=0, timeout_s=30, start_method="fork")
    try:
        par.reset_all()
        poison = np.zeros((2, ACT), np.float32)
        poison[1, 0] = 100.0  # worker 1 raises
        with pytest.raises(RuntimeError, match="(?s)worker 1.*poison action"):
            par.step(poison)
    finally:
        par.close()


@needs_native
def test_dead_worker_is_diagnosed_by_index(fake_factory):
    par = ParallelEnvPool("Fake-v0", 3, base_seed=0, timeout_s=3, start_method="fork")
    try:
        par.reset_all()
        os.kill(par.pids[1], signal.SIGKILL)
        time.sleep(0.2)
        with pytest.raises(RuntimeError, match=r"worker 1 died \(exitcode -9\)"):
            par.step(np.zeros((3, ACT), np.float32))
    finally:
        par.close()
    assert all(not p.is_alive() for p in par._procs)


@needs_native
def test_spawned_workers_bootstrap_and_match_the_sequential_pool():
    """The default start method: workers boot a fresh interpreter with no
    card visible, resolve the env by name, and step as the sequential
    pool does, bitwise."""
    env, n = "PendulumNumpy-v1|history:16", 2
    seq = SequentialEnvPool(env, n, base_seed=5)
    par = ParallelEnvPool(env, n, base_seed=5, timeout_s=120)
    try:
        seeds = [5 + 10000 * i for i in range(n)]
        for a, b in zip(_drive(par, n, 2.0, seeds, steps=10),
                        _drive(seq, n, 2.0, seeds, steps=10), strict=True):
            _assert_same(a, b, f32_scalars=True)
    finally:
        par.close()
        seq.close()


_ORPHAN_SCRIPT = r"""
import multiprocessing, sys, time
import numpy as np
from torch_actor_critic_tpu_torch.envs import vec_env

if __name__ == "__main__":
    multiprocessing.get_context("forkserver").set_forkserver_preload([vec_env.__name__])
    pool = vec_env.ParallelEnvPool("PendulumNumpy-v1", 2, timeout_s=60,
                                   start_method=sys.argv[1])
    pool.reset_all()
    time.sleep(2.5)  # idle past the workers' 1 s wait slices
    pool.step(np.zeros((2, 1), np.float32))
    print(*pool.pids, flush=True)
    time.sleep(600)
"""


@needs_native
def test_workers_outlive_idle_waits_and_exit_with_their_pool(tmp_path):
    """A worker's OS parent is not the pool's process under a forkserver:
    workers idle past their wait slices still serve the pool, and exit
    once the pool's process is killed."""
    import subprocess
    import sys

    script = tmp_path / "pool.py"
    script.write_text(_ORPHAN_SCRIPT)
    proc = subprocess.Popen([sys.executable, str(script), "forkserver"],
                            stdout=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": os.getcwd()})
    try:
        pids = [int(x) for x in proc.stdout.readline().split()]
        assert len(pids) == 2 and all(os.path.exists(f"/proc/{pid}") for pid in pids)
    finally:
        proc.kill()
        proc.wait(timeout=30)
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and any(
            os.path.exists(f"/proc/{pid}") and "zombie" not in _state(pid) for pid in pids):
        time.sleep(0.2)
    assert not any(os.path.exists(f"/proc/{pid}") and "zombie" not in _state(pid)
                   for pid in pids)


def _state(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/status") as f:
            return next(line for line in f if line.startswith("State:"))
    except (FileNotFoundError, StopIteration):
        return "gone zombie"


def test_factory_gives_the_sequential_pool_for_one_env():
    pool = make_env_pool("PendulumNumpy-v1", 1, parallel=True)
    try:
        assert type(pool) is SequentialEnvPool
    finally:
        pool.close()


def test_factory_falls_back_with_a_warning_without_the_runtime(monkeypatch, caplog):
    monkeypatch.setattr(native, "load_runtime", lambda *a, **k: None)
    with caplog.at_level(logging.WARNING, logger=vec_env.logger.name):
        pool = make_env_pool("PendulumNumpy-v1", 2, parallel=True)
    try:
        assert type(pool) is SequentialEnvPool
        assert "native runtime unavailable; using SequentialEnvPool" in caplog.text
    finally:
        pool.close()


@needs_native
def test_factory_gives_the_parallel_pool(fake_factory):
    pool = make_env_pool("Fake-v0", 2, parallel=True, timeout_s=30, start_method="fork")
    try:
        assert type(pool) is ParallelEnvPool
    finally:
        pool.close()


# ------------------------------------------------------------- the trainer

TINY = dict(hidden_sizes=(16, 16), batch_size=8, epochs=1, steps_per_epoch=60,
            start_steps=20, update_after=20, update_every=10, buffer_size=200,
            population=2, env_timeout_s=60.0, env_start_method="fork")


def _snapshot(tr) -> dict:
    out = {f"{name}.{k}": v.clone() for name in ("actor", "critic", "target_critic")
           for k, v in getattr(tr.state, name).state_dict().items()}
    out.update({f"ring.{k}": v.clone() for k, v in tr.buffer.data.named_leaves()})
    out["log_alpha"] = tr.state.log_alpha.detach().clone()
    return out


def _train(parallel: bool, warmup_from_parent: bool = False, **over) -> tuple:
    tr = Trainer("PendulumNumpy-v1", SACConfig(**{**TINY, "parallel_envs": parallel, **over}),
                 seed=3, device="cpu")
    try:
        assert type(tr.pool) is (ParallelEnvPool if parallel else SequentialEnvPool)
        if warmup_from_parent:
            # The parallel pool's warm-up draws, on the sequential pool.
            rng, pool = np.random.default_rng(3), tr.pool
            pool.sample_actions = lambda: rng.uniform(
                -pool.act_limit, pool.act_limit, (pool.n, pool.act_dim)).astype(np.float32)
        metrics = tr.train()
        return _snapshot(tr), metrics, tr.state.step
    finally:
        tr.close()


@needs_native
@pytest.mark.parametrize("lag", [False, True], ids=["live", "actor_param_lag"])
def test_trainer_over_the_parallel_pool_is_reproducible_and_equals_the_sequential_one(lag):
    """A population of 2 over the parallel pool: two runs from one seed are
    bitwise equal, and equal the sequential pool's run given the same
    warm-up draws (so the same ring): every update after ``start_steps``,
    acting included, is the same; with the lag too, whose bursts run in
    a thread of their own."""
    a, metrics, updates = _train(True, actor_param_lag=lag)
    b, _, _ = _train(True, actor_param_lag=lag)
    c, _, _ = _train(False, warmup_from_parent=True, actor_param_lag=lag)
    assert updates == (60 - 20) // 10 * 10 and np.isfinite(metrics["loss_q"])
    for other in (b, c):
        assert a.keys() == other.keys()
        assert all(torch.equal(a[k], other[k]) for k in a), [
            k for k in a if not torch.equal(a[k], other[k])]
