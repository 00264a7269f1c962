"""The port's dm_control envs, the CMU-humanoid wall-runner, rendering and
the dm-reward warning against the JAX package's, on the CPU.

- ``DmControlEnv`` (``dm:<domain>:<task>``), ``reseed_dm_env`` and
  ``HistoryEnv`` over a dm task: bitwise the JAX package's (the same
  dm_control physics; same seeds and actions).
- The wall-runner needs a GL context for its egocentric camera, and this
  test process runs with ``MUJOCO_GL=disabled`` (``tests/conftest.py``),
  so every wall-runner env is built in a child interpreter with
  ``MUJOCO_GL=egl``: the port's env against JAX's, bitwise; the recorder
  (``scripts/record_wallrunner_torch.py``) against its fixture
  (``tests/data/wallrunner_s0.npz``), bitwise; ``train`` and ``serve --run``
  of a short wall-runner run.
- One update at SACConfig's full default visual widths (the Atari trunk
  32/64/64, Dense 512, ``cnn_features`` 1, hidden 256-256) on the
  fixture's first 32 real transitions (168 features, 64x64x3 frames, act
  56), JAX's ``SAC`` against the port's with JAX's draws injected:
  losses and metrics atol 1e-5 / rtol 1e-4, parameters atol 1e-5 / rtol
  1e-4, log α 1e-6 (``tests/test_torch_visual.py``'s limits); Adam
  moments per tensor max|Δ| ≤ 1e-5 + 1e-4·max|ref|. At raw 0-255 pixels
  the conv trunk's weight gradients sum large terms that cancel: against
  a float64 run of the same update, JAX's f32 first moment of the
  critic's second conv is off by up to 4.1e-5 (of max 0.77) and the
  port's by 1.7e-7, so an element-wise rtol 1e-4 would measure JAX's
  rounding, not the port.
- The trainer's fixed-α warning on dm envs, a dm task training, and
  rendering through ``train --render``, ``Trainer(render=True)`` and
  ``run_agent`` on a host without a display.
"""

import functools
import json
import logging
import math
import os
import signal
import subprocess
import sys
import types
from pathlib import Path
from urllib import request as urlreq

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("dm_control")

from torch_actor_critic_tpu.buffer import replay as jreplay  # noqa: E402
from torch_actor_critic_tpu.core.types import Batch as JBatch  # noqa: E402
from torch_actor_critic_tpu.core.types import MultiObservation as JMulti  # noqa: E402
from torch_actor_critic_tpu.envs import wrappers as jwrappers  # noqa: E402
from torch_actor_critic_tpu.sac.algorithm import SAC as JSAC  # noqa: E402
from torch_actor_critic_tpu.sac.algorithm import run_update_burst as j_run_update_burst  # noqa: E402
from torch_actor_critic_tpu.sac.trainer import build_models as j_build_models  # noqa: E402
from torch_actor_critic_tpu.utils.config import SACConfig as JSACConfig  # noqa: E402
from torch_actor_critic_tpu_torch import run_agent  # noqa: E402
from torch_actor_critic_tpu_torch import train as train_mod  # noqa: E402
from torch_actor_critic_tpu_torch.buffer import replay  # noqa: E402
from torch_actor_critic_tpu_torch.core.types import Batch, MultiObservation  # noqa: E402
from torch_actor_critic_tpu_torch.envs import wrappers  # noqa: E402
from torch_actor_critic_tpu_torch.envs.wrappers import (  # noqa: E402
    DmControlEnv,
    HistoryEnv,
    ObsSpec,
    make_env,
)
from torch_actor_critic_tpu_torch.models import build_actor, build_models  # noqa: E402
from torch_actor_critic_tpu_torch.sac.algorithm import SAC  # noqa: E402
from torch_actor_critic_tpu_torch.sac.trainer import Trainer  # noqa: E402
from torch_actor_critic_tpu_torch.utils.checkpoint import restore_actor_params  # noqa: E402
from torch_actor_critic_tpu_torch.utils.config import SACConfig  # noqa: E402
from torch_actor_critic_tpu_torch.weights import (  # noqa: E402
    _adam_state,
    _named_arrays,
    train_state_from_jax,
)

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "data" / "wallrunner_s0.npz"
FEAT, FRAME, ACT = 168, (64, 64, 3), 56
BATCH = 32
# Tiny widths for trainer runs.
TINY = dict(hidden_sizes=(32, 32), batch_size=16, epochs=1, steps_per_epoch=60,
            start_steps=20, update_after=20, update_every=20, buffer_size=500,
            max_ep_len=200)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several test workers each spinning a full
    thread pool oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _egl_env() -> dict:
    """The environment of a child that renders the wall-runner's camera."""
    env = {k: v for k, v in os.environ.items() if k not in ("DISPLAY", "PYTHONPATH")}
    return {**env, "MUJOCO_GL": "egl", "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
            "PYTHONPATH": str(REPO)}


def _child(code: str, *args: str, timeout: int = 400) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code, *args], cwd=REPO, env=_egl_env(),
                          capture_output=True, text=True, timeout=timeout)


def _last_json(text: str) -> dict:
    return json.loads([line for line in text.splitlines() if line.startswith("{")][-1])


# ------------------------------------------------------------ dm suite


@pytest.mark.parametrize("name,seed", [("dm:cartpole:swingup", 7), ("dm:cheetah:run", 0)])
def test_dm_control_env_is_bitwise_the_jax_env(name, seed):
    port, ref = make_env(name, seed=seed), jwrappers.make_env(name, seed=seed)
    assert isinstance(port, DmControlEnv) and port.name == ref.name == name
    assert port.obs_spec == ObsSpec(tuple(ref.obs_spec.shape), np.float32)
    assert (port.act_dim, port.act_limit) == (ref.act_dim, ref.act_limit)
    # The warm-up sampler from construction, then reseeded by a seeded reset.
    for _ in range(3):
        np.testing.assert_array_equal(port.sample_action(), ref.sample_action())
    for reset_seed in (seed, seed + 11):
        o_p, o_r = port.reset(seed=reset_seed), ref.reset(seed=reset_seed)
        assert o_p.dtype == np.float32 and o_p.shape == port.obs_spec.shape
        np.testing.assert_array_equal(o_p, o_r)
        for _ in range(20):
            a = ref.sample_action()
            np.testing.assert_array_equal(port.sample_action(), a)
            got, want = port.step(a), ref.step(a)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:] and type(got[1]) is float
            assert type(got[2]) is bool and type(got[3]) is bool
    assert port.render() is None
    port.close()
    ref.close()


def test_dm_time_limit_is_a_truncation_like_jax():
    """cartpole ends by its time limit (1000 steps) at discount 1: a
    truncation that keeps the bootstrap, in both packages."""
    port, ref = make_env("dm:cartpole:balance", seed=2), jwrappers.make_env(
        "dm:cartpole:balance", seed=2)
    port.reset(seed=2), ref.reset(seed=2)
    zero = np.zeros(port.act_dim, np.float32)
    for step in range(1000):
        got, want = port.step(zero), ref.step(zero)
        assert got[1:] == want[1:]
    assert (step, got[2], got[3]) == (999, False, True)


def _composer_env(seed):
    from dm_control import composer
    from dm_control.locomotion.arenas import floors

    class Empty(composer.Task):
        def __init__(self):
            self._arena = floors.Floor()

        @property
        def root_entity(self):
            return self._arena

        def get_reward(self, physics):
            return 0.0

    return composer.Environment(task=Empty(), time_limit=1.0, random_state=seed)


@pytest.mark.parametrize("kind", ["suite", "composer"])
def test_reseed_dm_env_replaces_the_random_state_as_jax_does(kind):
    def build():
        if kind == "suite":
            from dm_control import suite

            return suite.load("cartpole", "swingup", task_kwargs={"random": 1})
        return _composer_env(1)

    def generator(env):
        return env.task._random if kind == "suite" else env._random_state

    port, ref = build(), build()
    wrappers.reseed_dm_env(port, None)  # no seed: untouched
    assert generator(port).uniform() == np.random.RandomState(1).uniform()
    wrappers.reseed_dm_env(port, 42)
    jwrappers.reseed_dm_env(ref, 42)
    want = np.random.RandomState(42).uniform(size=4)
    np.testing.assert_array_equal(generator(port).uniform(size=4), want)
    np.testing.assert_array_equal(generator(ref).uniform(size=4), want)
    if kind == "suite":
        wrappers.reseed_dm_env(port, 5)
        jwrappers.reseed_dm_env(ref, 5)
        np.testing.assert_array_equal(port.reset().observation["position"],
                                      ref.reset().observation["position"])


def test_dm_history_env_is_bitwise_the_jax_history_env():
    name = "dm:cheetah:run|history:4"
    port, ref = make_env(name, seed=3), jwrappers.make_env(name, seed=3)
    assert isinstance(port, HistoryEnv) and port.name == ref.name == name
    assert port.obs_spec == ObsSpec((4, 17), np.float32)
    np.testing.assert_array_equal(port.reset(seed=3), ref.reset(seed=3))
    for _ in range(12):
        a = ref.sample_action()
        np.testing.assert_array_equal(port.sample_action(), a)
        got, want = port.step(a), ref.step(a)
        assert got[0].shape == (4, 17)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


# ---------------------------------------------------------- wall-runner

_WALL_CHILD = r"""
import importlib.util, json, sys
import numpy as np
from torch_actor_critic_tpu_torch.core.types import MultiObservation
from torch_actor_critic_tpu_torch.envs import wall_runner as pw
from torch_actor_critic_tpu_torch.envs.wrappers import ObsSpec, is_visual_env, make_env
from torch_actor_critic_tpu.envs import wall_runner as jw

out = {"sensor_keys": list(pw.SENSOR_KEYS) == list(jw.SENSOR_KEYS),
       "consts": [pw.FEATURE_DIM, list(pw.FRAME_SHAPE), pw.ACT_DIM, jw.FEATURE_DIM,
                  list(jw.FRAME_SHAPE), jw.ACT_DIM],
       "visual": is_visual_env("DeepMindWallRunner-v0")}
port = make_env("DeepMindWallRunner-v0", seed=0)
ref = jw.DeepMindWallRunner(seed=0)
out["spec"] = (isinstance(port.obs_spec, MultiObservation)
               and port.obs_spec.features == ObsSpec((168,), np.float32)
               and port.obs_spec.frame == ObsSpec((64, 64, 3), np.uint8))
out["act"] = [port.act_dim, port.act_limit, ref.act_dim, ref.act_limit]

def same(a, b):
    return bool(a.features.dtype == np.float32 and a.features.shape == (168,)
                and a.frame.dtype == np.uint8 and a.frame.shape == (64, 64, 3)
                and np.array_equal(a.features, b.features) and np.array_equal(a.frame, b.frame))

checks, flags, resets, lit = [], [], 0, []
a, b = port.reset(seed=0), ref.reset(seed=0)
checks.append(same(a, b))
lit.append(float(a.frame.std()))
for i in range(20):
    act = ref.sample_action()
    checks.append(bool(np.array_equal(port.sample_action(), act)))
    (a, ra, ta, ua), (b, rb, tb, ub) = port.step(act), ref.step(act)
    checks.append(same(a, b))
    lit.append(float(a.frame.std()))
    flags.append([ra == rb, ta == tb, ua == ub, type(ra) is float, type(ta) is bool,
                  type(ua) is bool])
    if ta or ua:
        resets += 1
        checks.append(same(port.reset(), ref.reset()))
out.update(checks=checks, flags=flags, resets=resets, min_frame_std=min(lit),
           render=[port.render() is None, port.render() is None])

spec = importlib.util.spec_from_file_location("rec", "scripts/record_wallrunner_torch.py")
rec = importlib.util.module_from_spec(spec)
spec.loader.exec_module(rec)
got, want = rec.record(16, seed=0), np.load(sys.argv[1])
out["recorder"] = {k: bool(got[k].dtype == want[k].dtype and np.array_equal(
    got[k], want[k][:17] if k in ("features", "frames", "episode_starts") else want[k][:16]))
    for k in want.files}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def wall_child():
    res = _child(_WALL_CHILD, str(FIXTURE))
    assert res.returncode == 0, res.stderr[-4000:]
    return _last_json(res.stdout)


def test_wall_runner_is_bitwise_the_jax_env(wall_child):
    out = wall_child
    assert out["sensor_keys"] and out["visual"] and out["spec"]
    assert out["consts"] == [168, [64, 64, 3], 56] * 2
    assert out["act"] == [56, 1.0, 56, 1.0]
    assert len(out["checks"]) >= 41 and all(out["checks"])
    assert len(out["flags"]) == 20 and all(all(f) for f in out["flags"])
    assert out["min_frame_std"] > 0  # the camera rendered real frames
    assert out["render"] == [True, True]


def test_recorder_reproduces_the_fixture(wall_child):
    data = np.load(FIXTURE)
    assert set(wall_child["recorder"]) == set(data.files) == {
        "features", "frames", "episode_starts", "actions", "rewards", "terminated",
        "truncated"}
    assert all(wall_child["recorder"].values()), wall_child["recorder"]


def _fixture_transitions():
    spec = __import__("importlib.util").util.spec_from_file_location(
        "rec", REPO / "scripts" / "record_wallrunner_torch.py")
    rec = __import__("importlib.util").util.module_from_spec(spec)
    spec.loader.exec_module(rec)
    return rec.transitions(np.load(FIXTURE))


def test_fixture_layout():
    data = np.load(FIXTURE)
    n = data["actions"].shape[0]
    assert FIXTURE.stat().st_size <= 1.5e6
    assert data["features"].shape == (n + 1, FEAT) and data["features"].dtype == np.float32
    assert data["frames"].shape == (n + 1, *FRAME) and data["frames"].dtype == np.uint8
    assert data["actions"].shape == (n, ACT) and n >= 256
    starts = data["episode_starts"]
    assert starts[0] and starts.sum() >= 2
    ended = data["terminated"] | data["truncated"]
    # A slot after an ended episode is the reset; nothing else is.
    np.testing.assert_array_equal(starts[2:], ended[:-1])
    tr = _fixture_transitions()
    assert len(tr["rewards"]) == n - (starts[1:].sum())
    assert np.abs(tr["actions"]).max() <= 1.0 and np.isfinite(tr["features"]).all()


# ------------------------------------------------- full-width update


@functools.lru_cache(maxsize=None)
def _jax_wall_case(pipeline):
    jcfg = JSACConfig(batch_size=BATCH, pixel_pipeline=pipeline)
    env = types.SimpleNamespace(
        obs_spec=JMulti(features=jax.ShapeDtypeStruct((FEAT,), jnp.float32),
                        frame=jax.ShapeDtypeStruct(FRAME, jnp.uint8)),
        act_dim=ACT, act_limit=1.0)
    actor_def, critic_def = j_build_models(jcfg, env)
    jsac = JSAC(jcfg, actor_def, critic_def, ACT)
    example = JMulti(features=jnp.zeros((FEAT,)), frame=jnp.zeros(FRAME, jnp.uint8))
    state = jax.jit(jsac.init_state)(jax.random.PRNGKey(0), example)
    return jsac, state, SACConfig(batch_size=BATCH, pixel_pipeline=pipeline)


def _real_batch(lo=0, n=BATCH):
    tr = _fixture_transitions()
    sl = slice(lo, lo + n)
    return dict(
        states=dict(features=tr["features"][sl], frame=tr["frames"][sl]),
        actions=tr["actions"][sl], rewards=tr["rewards"][sl],
        next_states=dict(features=tr["next_features"][sl], frame=tr["next_frames"][sl]),
        done=tr["terminated"][sl].astype(np.float32))


def _jbatch(b):
    return JBatch(states=JMulti(**b["states"]), actions=b["actions"], rewards=b["rewards"],
                  next_states=JMulti(**b["next_states"]), done=b["done"])


def _tbatch(b):
    def obs(o):
        return MultiObservation(torch.from_numpy(np.array(o["features"])),
                                torch.from_numpy(np.array(o["frame"])))
    return Batch(states=obs(b["states"]), actions=torch.from_numpy(b["actions"]),
                 rewards=torch.from_numpy(b["rewards"]), next_states=obs(b["next_states"]),
                 done=torch.from_numpy(b["done"]))


def _port_state(pipeline):
    _, state, cfg = _jax_wall_case(pipeline)
    sac = SAC(cfg, ACT)
    actor, critic = build_models(cfg, MultiObservation((FEAT,), FRAME), ACT, 1.0)
    ts = train_state_from_jax(jax.tree_util.tree_map(np.asarray, state), sac, actor, critic,
                              torch.Generator())
    return sac, ts


def _noise(rng):
    rng, key_q, key_pi = jax.random.split(rng, 3)
    return rng, [torch.from_numpy(np.array(jax.random.normal(k, (BATCH, ACT))))
                 for k in (key_q, key_pi)]


def _assert_learner_matches(ts, new, tm, jm):
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4, err_msg=k)
    for module, tree, what in ((ts.actor, new.actor_params, "actor"),
                               (ts.critic, new.critic_params, "critic"),
                               (ts.target_critic, new.target_critic_params, "target")):
        want = _named_arrays(module, jax.tree_util.tree_map(np.asarray, tree))
        assert set(want) == {n for n, _ in module.named_parameters()}
        for name, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-5, rtol=1e-4,
                                       err_msg=f"{what} {name}")
    for opt, module, jopt in ((ts.pi_opt, ts.actor, new.pi_opt_state),
                              (ts.q_opt, ts.critic, new.q_opt_state)):
        adam = _adam_state(jax.tree_util.tree_map(np.asarray, jopt))
        for moment, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
            want = _named_arrays(module, moment)
            for name, p in module.named_parameters():
                err = np.abs(opt.state[p][key].numpy() - want[name]).max()
                assert err <= 1e-5 + 1e-4 * np.abs(want[name]).max(), (key, name, err)
    np.testing.assert_allclose(float(ts.log_alpha.detach()), float(new.log_alpha), atol=1e-6,
                               rtol=0)


def test_full_width_wall_runner_update_matches_jax():
    """SACConfig's default pipeline: the update takes the real uint8
    frames and the CNN decodes them (raw 0-255 pixels)."""
    jsac, state, _ = _jax_wall_case("reference")
    b = _real_batch()
    new, jm = jax.jit(jsac.update)(state, _jbatch(b))
    sac, ts = _port_state("reference")
    _, (eps_q, eps_pi) = _noise(state.rng)
    ts, tm = sac.update(ts, _tbatch(b), eps_q=eps_q, eps_pi=eps_pi)
    assert math.isfinite(float(tm["loss_q"])) and float(tm["loss_q"]) > 0
    _assert_learner_matches(ts, new, tm, jm)


def test_full_width_wall_runner_fused_burst_matches_jax():
    """The fused pipeline (the card's: K1 gathers and decodes the frames;
    here its plain version) over a ring of 48 real transitions, one
    update from JAX's rows."""
    jsac, state, _ = _jax_wall_case("fused")
    prefill, chunk = _real_batch(0, 32), _real_batch(32, 16)
    jbuf = jreplay.push(jreplay.init_visual_replay_buffer(48, FEAT, FRAME, ACT),
                        _jbatch(prefill))
    new, new_jbuf, jm = jax.jit(lambda s, buf, ch: j_run_update_burst(
        jsac.update, jsac.config, s, buf, ch, 1))(state, jbuf, _jbatch(chunk))
    # Without a shift the sample key draws the rows itself.
    rng, sample_key = jax.random.split(state.rng)
    indices = np.array(jax.random.randint(sample_key, (BATCH,), 0, 48))[None]
    _, eps = _noise(rng)
    sac, ts = _port_state("fused")
    buf = replay.push(replay.init_visual_replay_buffer(48, FEAT, FRAME, ACT, "cpu"),
                      _tbatch(prefill))
    ts, buf, tm = sac.update_burst(ts, buf, _tbatch(chunk), 1,
                                   indices=torch.from_numpy(indices),
                                   eps=torch.stack(eps)[None])
    for got, want in zip(buf.data.leaves(), jax.tree_util.tree_leaves(new_jbuf.data)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ts.step == int(new.step) == 1
    _assert_learner_matches(ts, new, tm, jm)


# ------------------------------------------------------------- trainer


def _warned(caplog) -> bool:
    return any("learn-alpha" in r.getMessage() for r in caplog.records)


def test_fixed_alpha_dm_control_warns(caplog, monkeypatch):
    """Fixed-α SAC on a dm_control env warns with the JAX trainer's
    advice; learned α, TD3 and gymnasium-scale rewards stay quiet."""
    monkeypatch.delenv("DISPLAY", raising=False)
    with caplog.at_level(logging.WARNING, logger="torch_actor_critic_tpu_torch"):
        Trainer("dm:cartpole:balance", SACConfig(**TINY), device="cpu").close()
    assert _warned(caplog)
    assert any("Pass --learn-alpha true to tune the temperature automatically."
               in r.getMessage() for r in caplog.records)
    for env, overrides in (
        ("dm:cartpole:balance", {"learn_alpha": True}),
        ("dm:cartpole:balance", {"algorithm": "td3"}),
        ("Pendulum-v1", {}),
        ("PixelPendulum-v0", {"filters": (8, 16), "kernel_sizes": (4, 3),
                              "strides": (2, 2), "cnn_dense_size": 32}),
    ):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="torch_actor_critic_tpu_torch"):
            Trainer(env, SACConfig(**{**TINY, **overrides}), device="cpu").close()
        assert not _warned(caplog), (env, overrides)


def test_dm_control_cheetah_run_trains():
    tr = Trainer("dm:cheetah:run", SACConfig(**TINY), device="cpu")
    try:
        metrics = tr.train()
        assert tr.state.step == 40
        assert math.isfinite(metrics["loss_q"])
        assert tr.buffer.size == 60
    finally:
        tr.close()


def test_trainer_renders_dm_envs_without_a_display(monkeypatch):
    """``render=True`` on a dm env needs no display (its no-op path):
    ``train(render=True)`` renders env 0 after every lockstep step and
    ``evaluate(render=True)`` every evaluated step."""
    monkeypatch.delenv("DISPLAY", raising=False)
    tr = Trainer("dm:cartpole:balance", SACConfig(**{**TINY, "learn_alpha": True}),
                 device="cpu", render=True)
    calls = []
    render_at = tr.pool.render_at
    monkeypatch.setattr(tr.pool, "render_at", lambda i: calls.append(i) or render_at(i))
    try:
        assert tr._render_ok
        tr.train(render=True)
        assert calls == [0] * TINY["steps_per_epoch"]
        calls.clear()
        tr.train(render=False)
        assert calls == []
        tr.evaluate(episodes=1, seed=0, render=True)
        assert calls == [0] * TINY["max_ep_len"]
    finally:
        tr.close()
    quiet = Trainer("dm:cartpole:balance", SACConfig(**{**TINY, "learn_alpha": True}),
                    device="cpu")
    assert not quiet._render_ok
    quiet.close()


def test_train_cli_render_on_a_headless_gymnasium_env_warns_and_trains(
        tmp_path, monkeypatch, caplog, capsys):
    monkeypatch.delenv("DISPLAY", raising=False)
    argv = ["--environment", "Pendulum-v1", "--device", "cpu", "--runs-root", str(tmp_path),
            "--epochs", "1", "--steps-per-epoch", "40", "--start-steps", "10",
            "--update-after", "10", "--update-every", "10", "--batch-size", "16",
            "--buffer-size", "100", "--hidden-sizes", "16,16", "--render"]
    assert train_mod.parse_arguments(argv).render
    assert not train_mod.parse_arguments(argv[:-1]).render
    with caplog.at_level(logging.WARNING, logger="torch_actor_critic_tpu_torch"):
        metrics = train_mod.main(argv)
    assert any("no display is available; running headless" in r.getMessage()
               for r in caplog.records)
    assert math.isfinite(metrics["loss_q"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["epoch"] for x in lines if "epoch" in x] == [0]


@pytest.mark.parametrize("env", ["Pendulum-v1", "dm:cartpole:balance"])
def test_run_agent_renders_by_default_and_headless_prints_the_same(
        env, tmp_path, monkeypatch, capsys):
    """``run_agent`` renders unless ``--headless``; on a host without a
    display both print the same line."""
    monkeypatch.delenv("DISPLAY", raising=False)
    train_mod.main(["--environment", env, "--device", "cpu", "--runs-root", str(tmp_path),
                    "--epochs", "1", "--steps-per-epoch", "40", "--start-steps", "10",
                    "--update-after", "10", "--update-every", "10", "--batch-size", "16",
                    "--buffer-size", "100", "--hidden-sizes", "16,16", "--max-ep-len", "30",
                    "--learn-alpha", "true"])
    run = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")][-1]
    base = ["--run", run["run"], "--runs-root", str(tmp_path), "--episodes", "2",
            "--seed", "0", "--device", "cpu"]
    assert run_agent.parse_arguments(base).render
    assert not run_agent.parse_arguments(base + ["--headless"]).render
    rendered = run_agent.main(base)
    first = capsys.readouterr().out.strip().splitlines()[-1]
    headless = run_agent.main(base + ["--headless"])
    second = capsys.readouterr().out.strip().splitlines()[-1]
    assert first == second and rendered == headless
    assert json.loads(first)["ep_len_mean"] == 30.0


# ------------------------------------------------------------- serving

_WALL_TRAIN = r"""
import sys
from torch_actor_critic_tpu_torch import train
train.main(["--environment", "DeepMindWallRunner-v0", "--device", "cpu",
            "--runs-root", sys.argv[1], "--epochs", "1", "--steps-per-epoch", "30",
            "--start-steps", "20", "--update-after", "20", "--update-every", "10",
            "--batch-size", "8", "--buffer-size", "100", "--hidden-sizes", "16,16",
            "--filters", "8,16", "--kernel-sizes", "8,4", "--strides", "4,2",
            "--cnn-dense-size", "32", "--learn-alpha", "true", "--pixel-pipeline", "fused"])
"""


def test_serve_run_of_a_wall_runner_run_answers_with_the_actors_action(tmp_path):
    """A short wall-runner run trained through the CLI (in a child with
    EGL); ``serve --run`` resolves its specs through the port's env and
    answers ``/act`` on a recorded observation with the actor's
    deterministic action (atol 1e-5: the engine pads to its bucket)."""
    res = _child(_WALL_TRAIN, str(tmp_path))
    assert res.returncode == 0, res.stderr[-4000:]
    run = _last_json(res.stdout)
    assert math.isfinite(run["final"]["loss_q"])
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch_actor_critic_tpu_torch.serve", "--run", run["run"],
         "--runs-root", str(tmp_path), "--device", "cpu", "--port", "0", "--max-batch", "4",
         "--poll-interval", "0"],
        cwd=REPO, env=_egl_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready = json.loads(proc.stdout.readline())
        data = np.load(FIXTURE)
        obs = {"features": data["features"][5].tolist(), "frame": data["frames"][5].tolist()}
        body = json.dumps({"obs": obs, "deterministic": True}).encode()
        req = urlreq.Request(ready["serving"] + "/act", data=body,
                             headers={"Content-Type": "application/json"})
        with urlreq.urlopen(req, timeout=60) as resp:
            got = np.asarray(json.loads(resp.read())["action"], np.float32)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()
    params = json.loads((Path(run["checkpoint_dir"]).parent.parent / "params.json").read_text())
    cfg = SACConfig.from_json(json.dumps(params["config"]))
    actor = build_actor(cfg, MultiObservation((FEAT,), FRAME), ACT, 1.0)
    state, _ = restore_actor_params(run["checkpoint_dir"])
    actor.load_state_dict(state)
    with torch.no_grad():
        want, _ = actor(MultiObservation(torch.from_numpy(data["features"][5]),
                                         torch.from_numpy(data["frames"][5])),
                        deterministic=True)
    assert got.shape == (ACT,)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=0)


def test_env_workers_inherit_headless_gl(monkeypatch):
    """Children started under ``host_only_children()`` on a host without a
    display get ``MUJOCO_GL=egl`` (what ``ensure_headless_gl`` sets before a
    dm_control import), a value already set is kept, and the parent's
    environment is restored."""
    from torch_actor_critic_tpu_torch.envs.vec_env import host_only_children

    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("MUJOCO_GL", raising=False)
    with host_only_children():
        assert os.environ["MUJOCO_GL"] == "egl"
    assert "MUJOCO_GL" not in os.environ
    wrappers.ensure_headless_gl()
    assert os.environ["MUJOCO_GL"] == "egl"
    monkeypatch.setenv("MUJOCO_GL", "disabled")
    wrappers.ensure_headless_gl()
    with host_only_children():
        assert os.environ["MUJOCO_GL"] == "disabled"
    monkeypatch.setenv("DISPLAY", ":0")
    monkeypatch.delenv("MUJOCO_GL")
    wrappers.ensure_headless_gl()
    with host_only_children():
        assert "MUJOCO_GL" not in os.environ


@pytest.mark.parametrize("history", [1, 4])
def test_serve_run_of_a_dm_run_serves_through_the_ported_env(history, tmp_path, capsys):
    """``serve --run`` of a ``dm:cheetah:run`` run (flat, and with a
    history) resolves its specs through the port's env and answers with
    the actor's deterministic action (atol 1e-5)."""
    from torch_actor_critic_tpu_torch.serve.__main__ import (
        build_server,
        parse_arguments,
        resolve_model,
    )

    train_mod.main(["--environment", "dm:cheetah:run", "--device", "cpu",
                    "--runs-root", str(tmp_path), "--epochs", "1", "--steps-per-epoch", "40",
                    "--start-steps", "10", "--update-after", "10", "--update-every", "10",
                    "--batch-size", "16", "--buffer-size", "100", "--hidden-sizes", "16,16",
                    "--learn-alpha", "true", "--history-len", str(history),
                    *(["--seq-d-model", "16", "--seq-num-heads", "2", "--seq-num-layers", "1"]
                      if history > 1 else [])])
    run = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")][-1]
    args = parse_arguments(["--run", run["run"], "--runs-root", str(tmp_path), "--device", "cpu",
                            "--port", "0", "--max-batch", "4", "--poll-interval", "0"])
    _, spec, act_dim, act_limit, _ = resolve_model(args)
    shape = (history, 17) if history > 1 else (17,)
    assert (tuple(spec.shape), act_dim, act_limit) == (shape, 6, 1.0)
    server, _ = build_server(args)
    server.start()
    try:
        obs = make_env(f"dm:cheetah:run|history:{history}" if history > 1 else "dm:cheetah:run",
                       seed=4).reset(seed=4)
        body = json.dumps({"obs": obs.tolist(), "deterministic": True}).encode()
        req = urlreq.Request(server.address + "/act", data=body,
                             headers={"Content-Type": "application/json"})
        with urlreq.urlopen(req, timeout=60) as resp:
            got = np.asarray(json.loads(resp.read())["action"], np.float32)
    finally:
        server.close()
    params = json.loads((Path(run["checkpoint_dir"]).parent.parent / "params.json").read_text())
    actor = build_actor(SACConfig.from_json(json.dumps(params["config"])), shape, 6, 1.0)
    actor.load_state_dict(restore_actor_params(run["checkpoint_dir"])[0])
    with torch.no_grad():
        want, _ = actor(torch.from_numpy(obs), deterministic=True)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=0)
