"""The port's envs, trainer and train CLI on the CPU.

- ``HistoryEnv`` over gymnasium's Pendulum-v1 against the JAX
  package's, same seed: exact (same physics, same window arithmetic).
- ``PendulumNumpy`` (the port's host pendulum for machines without
  gymnasium) against the JAX package's ``PendulumJax``: one step from a
  shared state agrees to 1e-6 (float32 sin/cos of two libraries differ
  in the last ulp), and a 200-step trajectory under the same actions to
  1e-4 (those ulps grow along it); both truncate at step 200.
- A ``Trainer`` at a tiny size on the CPU runs, its losses are finite,
  and its checkpoint serves from the port's ``ModelRegistry``.
- The CLI exits 0 with ``--device cpu`` and non-zero without a card
  and without that flag.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_actor_critic_tpu.envs.ondevice import PendulumJax
from torch_actor_critic_tpu.envs.wrappers import make_env as jax_make_env
from torch_actor_critic_tpu_torch.envs.pendulum import PendulumNumpy
from torch_actor_critic_tpu_torch.envs.vec_env import make_env_pool
from torch_actor_critic_tpu_torch.envs.wrappers import HistoryEnv, make_env
from torch_actor_critic_tpu_torch.models import build_actor, build_models
from torch_actor_critic_tpu_torch.resilience import TrainingDiverged
from torch_actor_critic_tpu_torch.sac.trainer import (
    NOT_PORTED,
    OBS_FIELDS,
    TELEMETRY_FIELDS,
    Trainer,
)
from torch_actor_critic_tpu_torch.serve import ModelRegistry
from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer
from torch_actor_critic_tpu_torch.utils.config import SACConfig

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny ops: one intra-op thread avoids the oversubscription of
    several test workers each spinning a full thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- envs


def test_history_env_matches_jax_on_pendulum():
    port = make_env("Pendulum-v1|history:4", seed=3)
    ref = jax_make_env("Pendulum-v1|history:4", seed=3)
    assert isinstance(port, HistoryEnv)
    assert tuple(port.obs_spec.shape) == tuple(ref.obs_spec.shape) == (4, 3)
    np.testing.assert_array_equal(port.reset(seed=11), ref.reset(seed=11))
    rng = np.random.default_rng(0)
    for _ in range(30):
        a = rng.uniform(-2, 2, (1,)).astype(np.float32)
        got, want = port.step(a), ref.step(a)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    np.testing.assert_array_equal(port.sample_action(), ref.sample_action())


def test_numpy_pendulum_matches_pendulum_jax():
    state = PendulumJax.reset(jax.random.PRNGKey(3))
    env = PendulumNumpy(seed=0)
    rng = np.random.default_rng(1)
    traj = PendulumNumpy(seed=0)
    traj.set_state(float(state.inner[0]), float(state.inner[1]))
    for i in range(200):
        a = rng.uniform(-2.5, 2.5, (1,)).astype(np.float32)  # clipped to +-2
        env.set_state(float(state.inner[0]), float(state.inner[1]))
        env.steps = i
        state, out = PendulumJax.step(state, jnp.asarray(a))
        obs, reward, terminated, truncated = env.step(a)
        np.testing.assert_allclose(obs, np.asarray(out.next_obs), atol=1e-6, rtol=0)
        assert abs(reward - float(out.reward)) <= 1e-5
        assert terminated is False and truncated == bool(out.ended) == (i == 199)
        t_obs, t_reward, _, _ = traj.step(a)
        np.testing.assert_allclose(t_obs, np.asarray(out.next_obs), atol=1e-4, rtol=0)
    assert env.obs_spec.shape == (PendulumJax.obs_dim,)
    assert (env.act_dim, env.act_limit) == (PendulumJax.act_dim, PendulumJax.act_limit)


def test_numpy_pendulum_resets_from_its_seed():
    a, b = PendulumNumpy(seed=5), PendulumNumpy(seed=99)
    np.testing.assert_array_equal(a.reset(seed=7), b.reset(seed=7))
    o = a.reset(seed=7)
    assert -1.0 <= o[2] <= 1.0 and math.isclose(o[0] ** 2 + o[1] ** 2, 1.0, rel_tol=1e-5)


def test_pendulum_v1_needs_gymnasium(monkeypatch):
    """No substitute for gymnasium's Pendulum-v1: without the package,
    make_env raises."""
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    with pytest.raises(ImportError):
        make_env("Pendulum-v1")
    assert isinstance(make_env("PendulumNumpy-v1"), PendulumNumpy)


def test_unported_envs_and_parallel_pool_raise(monkeypatch):
    """The dm_control names, once refused, now dispatch to the ported envs
    (``tests/test_torch_dm_envs.py`` holds them to JAX's; the wall-runner
    is built there in a child with a GL context)."""
    from torch_actor_critic_tpu_torch.envs import wall_runner
    from torch_actor_critic_tpu_torch.envs.wrappers import DmControlEnv

    env = make_env("dm:cheetah:run")
    assert isinstance(env, DmControlEnv) and env.obs_spec.shape == (17,) and env.act_dim == 6
    monkeypatch.setattr(wall_runner, "DeepMindWallRunner", lambda seed=None: ("wall", seed))
    assert make_env("DeepMindWallRunner-v0", seed=3) == ("wall", 3)
    pool = make_env_pool("PendulumNumpy-v1|history:3", 2, base_seed=1)
    obs = pool.reset_all([1, 2])
    assert obs.shape == (2, 3, 3) and pool.sample_actions().shape == (2, 1)


# --------------------------------------------------------------- models


def test_model_init_is_seeded_by_an_explicit_generator():
    cfg = SACConfig(history_len=8, seq_d_model=16, seq_num_heads=2)
    rng_state = torch.random.get_rng_state()
    builds = [
        build_models(cfg, (8, 3), 1, 2.0, generator=torch.Generator().manual_seed(4))
        for _ in range(2)
    ]
    flat = build_models(SACConfig(hidden_sizes=(8,)), (3,), 1, 2.0)
    build_actor(cfg, (8, 3), 1, 2.0)
    assert torch.equal(torch.random.get_rng_state(), rng_state)
    for (a1, c1), (a2, c2) in [builds]:
        for m1, m2 in ((a1, a2), (c1, c2)):
            s1, s2 = m1.state_dict(), m2.state_dict()
            assert s1.keys() == s2.keys()
            assert all(torch.equal(s1[k], s2[k]) for k in s1)
    other = build_models(cfg, (8, 3), 1, 2.0, generator=torch.Generator().manual_seed(5))
    assert not torch.equal(other[0].trunk.pos_embedding, builds[0][0].trunk.pos_embedding)
    critic = builds[0][1]
    q0, q1 = critic.trunk.blocks[0].attn.q.weight  # the stacked members' slices
    assert not torch.equal(q0, q1)  # each draw advances the one generator
    assert flat[1].trunk.layers[0].weight.shape[0] == 2


def test_build_models_refuses_unported_families():
    # TD3 is ported for the flat and visual stacks; its sequence stack is
    # refused, as the JAX trainer refuses it.
    with pytest.raises(ValueError, match="sequence"):
        build_models(SACConfig(algorithm="td3"), (8, 3), 1, 1.0)
    # A frame alone does not select the visual family: that takes a
    # MultiObservation (features, frame) spec.
    with pytest.raises(NotImplementedError, match="MultiObservation"):
        build_models(SACConfig(), (8, 8, 3), 1, 1.0)


# -------------------------------------------------------------- trainer


def _tiny_config(**kw):
    base = dict(
        history_len=8, seq_d_model=16, seq_num_heads=2, seq_num_layers=1, epochs=1,
        steps_per_epoch=200, start_steps=50, update_after=50, update_every=25,
        buffer_size=1000, save_every=1,
    )
    return SACConfig(**{**base, **kw})


def test_trainer_trains_on_cpu_and_its_checkpoint_serves(tmp_path):
    ckpt = Checkpointer(tmp_path / "ckpt")
    trainer = Trainer("Pendulum-v1", _tiny_config(), checkpointer=ckpt, seed=1, device="cpu")
    rows = []
    try:
        metrics = trainer.train(on_epoch=lambda e, m: rows.append((e, m)))
        ev = trainer.evaluate(episodes=1, seed=0)
    finally:
        trainer.close()
    assert [e for e, _ in rows] == [0]
    assert all(math.isfinite(metrics[k]) for k in ("loss_q", "loss_pi", "reward"))
    assert metrics["loss_q"] > 0 and metrics["grad_steps_per_sec"] > 0
    # Windows at steps 24, 49, 74, ...: bursts once step > update_after.
    assert trainer.state.step == 6 * 25
    assert trainer.buffer.size == 200
    assert ev["ep_len_mean"] == 200.0 and math.isfinite(ev["ep_ret_mean"])
    reg = ModelRegistry(device="cpu")
    from torch_actor_critic_tpu_torch.serve import ObsSpec

    actor_def = build_actor(_tiny_config(), (8, 3), 1, 2.0)
    info = reg.register("default", actor_def, ObsSpec((8, 3), np.float32),
                        ckpt_dir=str(ckpt.directory), max_batch=4)
    assert info["epoch"] == 0
    state, meta = ckpt.restore_actor_params()
    live = trainer.state.actor.state_dict()
    assert all(torch.equal(state[k], live[k]) for k in live)


def test_trainer_without_updates_only_fills_the_buffer():
    cfg = _tiny_config(steps_per_epoch=60, start_steps=100, update_after=100, history_len=1,
                       hidden_sizes=(8,))
    trainer = Trainer("PendulumNumpy-v1", cfg, seed=0, device="cpu")
    try:
        metrics = trainer.train()
    finally:
        trainer.close()
    assert trainer.state.step == 0 and trainer.buffer.size == 50
    assert metrics["loss_q"] == 0.0 and metrics["episode_length"] == 60.0


@pytest.mark.parametrize("field,value", [
    ("ma_critic", "per_agent"), ("task_embed_dim", 8),
    ("sanitize", "on"), ("task_embed_dim", 1), ("task_embed_dim", 32),
])
def test_unported_config_fields_raise(field, value):
    assert field in NOT_PORTED
    with pytest.raises(NotImplementedError, match=field):
        Trainer("PendulumNumpy-v1", _tiny_config(**{field: value}), device="cpu")


@pytest.mark.parametrize("field,value", [
    ("diagnostics", "light"), ("telemetry", True), ("obs", True),
])
def test_population_host_trainer_runs_the_observability_fields(field, value):
    """Telemetry, the diagnostics tiers and the obs plane run on the host
    trainer at any population: a population of 2 builds what the solo
    trainer builds for the field and trains an epoch with it."""
    assert field in NOT_PORTED and field in TELEMETRY_FIELDS + OBS_FIELDS
    cfg = _tiny_config(**{field: value}, population=2, epochs=1, steps_per_epoch=20,
                       start_steps=10, update_after=10, update_every=10, hidden_sizes=(8,))
    trainer = Trainer("PendulumNumpy-v1", cfg, device="cpu")
    try:
        built = {"diagnostics": trainer.monitor, "telemetry": trainer.telemetry,
                 "obs": trainer.obs}[field]
        assert built is not None
        metrics = trainer.train()
    finally:
        trainer.close()
    assert {"reward_m0", "reward_m1"} <= set(metrics)
    if field == "diagnostics":
        assert metrics["diag/grad_norm_q"] > 0 and "diag/param_norm" in metrics
    if field == "obs":
        assert metrics["obs/sources_total"] == 1


@pytest.mark.parametrize("field,value", [
    ("frame_augment", "shift"), ("pixel_pipeline", "fused"),
])
def test_pixel_options_on_a_flat_env_raise(field, value):
    """The JAX trainer's construction gates: a pixel option on a
    non-visual env would silently do nothing."""
    assert field not in NOT_PORTED
    with pytest.raises(ValueError, match=field):
        Trainer("PendulumNumpy-v1", _tiny_config(**{field: value}), device="cpu")


def test_trainer_sentinel_raises_on_non_finite_params():
    trainer = Trainer("PendulumNumpy-v1", _tiny_config(steps_per_epoch=10), device="cpu")
    with torch.no_grad():
        next(trainer.state.actor.parameters()).fill_(float("nan"))
    try:
        with pytest.raises(TrainingDiverged, match="no checkpoint"):
            trainer.train()
    finally:
        trainer.close()


# ------------------------------------------------------------------ CLI


def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch_actor_critic_tpu_torch.train", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout,
    )


def test_cli_trains_on_cpu(tmp_path):
    res = _cli(
        "--environment", "Pendulum-v1", "--history-len", "4", "--device", "cpu",
        "--epochs", "1", "--steps-per-epoch", "60", "--start-steps", "20",
        "--update-after", "20", "--update-every", "20", "--seq-d-model", "16",
        "--seq-num-layers", "1", "--buffer-size", "100", "--runs-root", str(tmp_path),
        "--eval-episodes", "1",
    )
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [json.loads(x) for x in res.stdout.splitlines() if x.startswith("{")]
    assert lines[0]["epoch"] == 0 and math.isfinite(lines[0]["loss_q"])
    assert lines[-1]["eval"]["ep_len_mean"] == 200.0
    ckpt = Path(lines[-1]["checkpoint_dir"])
    assert (ckpt / "epoch_0" / "actor.pt").exists()
    params = json.loads(next(tmp_path.glob("Default/*/params.json")).read_text())
    assert params["config"]["history_len"] == 4


def test_cli_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present, so the default device works")
    res = _cli("--environment", "PendulumNumpy-v1", "--epochs", "1",
               "--runs-root", str(tmp_path), timeout=120)
    assert res.returncode != 0 and "CUDA" in res.stderr


def test_halfcheetah_schedule_matches_the_jax_trainer():
    """The JAX trainer and the port's on gymnasium's HalfCheetah-v5 for
    3000 env steps at PARITY.md's schedule (start = update_after = 1000,
    update_every 50, max_ep_len 1000; small widths, which the schedule
    does not read): the same count of uniform-random steps, gradient
    bursts at the same env steps with the same update counts, and the
    same ring ``done`` column, zero at the two truncations (rows 999 and
    1999: a length cut keeps the bootstrap). Observations are not
    compared: Threefry and Philox never draw the same actions."""
    pytest.importorskip("mujoco")
    from torch_actor_critic_tpu.parallel import make_mesh
    from torch_actor_critic_tpu.sac.trainer import Trainer as JaxTrainer
    from torch_actor_critic_tpu.utils.config import SACConfig as JaxConfig

    sched = dict(epochs=3, steps_per_epoch=1000, start_steps=1000, update_after=1000,
                 update_every=50, max_ep_len=1000, batch_size=16, hidden_sizes=(16, 16),
                 buffer_size=4000, save_every=100)
    runs = {}
    for name, build in (
            ("jax", lambda: JaxTrainer("HalfCheetah-v5", JaxConfig(**sched),
                                       mesh=make_mesh(dp=1), seed=0)),
            ("port", lambda: Trainer("HalfCheetah-v5", SACConfig(**sched), seed=0,
                                     device="cpu"))):
        tr = build()
        seen = {"steps": 0, "random": 0, "bursts": []}
        pool_step, sample = tr.pool.step, tr.pool.sample_actions

        def step(actions, _f=pool_step, _s=seen):
            _s["steps"] += 1
            return _f(actions)

        def random_actions(_f=sample, _s=seen):
            _s["random"] += 1
            return _f()

        tr.pool.step, tr.pool.sample_actions = step, random_actions
        if name == "jax":
            burst = tr.dp.update_burst

            def counted(state, buffer, chunk, n, _f=burst, _s=seen):
                _s["bursts"].append((_s["steps"], int(n)))
                return _f(state, buffer, chunk, n)

            tr.dp.update_burst = counted
        else:
            burst = tr._burst

            def counted(chunk, n, _f=burst, _s=seen):
                _s["bursts"].append((_s["steps"], int(n)))
                return _f(chunk, n)

            tr._burst = counted
        try:
            tr.train()
        finally:
            tr.close()
        seen["done"] = np.asarray(tr.buffer.data.done, np.float32).reshape(-1)[:3000]
        seen["size"] = int(np.asarray(tr.buffer.size).reshape(-1)[0])
        runs[name] = seen
    jax_run, port_run = runs["jax"], runs["port"]
    assert jax_run["steps"] == port_run["steps"] == 3000
    assert jax_run["random"] == port_run["random"] == 1000
    want = [(step, 50) for step in range(1050, 3001, 50)]
    assert jax_run["bursts"] == port_run["bursts"] == want
    assert jax_run["size"] == port_run["size"] == 3000
    np.testing.assert_array_equal(port_run["done"], jax_run["done"])
    assert port_run["done"][999] == port_run["done"][1999] == 0.0
