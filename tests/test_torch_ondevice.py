"""The port's on-device twins and fused loop against the JAX package's, on
the CPU (the loop runs eagerly here; its captured path is checked on the
card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``).

The twins draw their reset poses from one generator for the batch, JAX
from one key per env: each test rebuilds JAX's draws from its keys and
injects them (``pose``/``poses``), as it injects the acting noise (JAX's
``split`` of the acting key each step: ``uniform`` in warm-up, ``normal``
for the policy) and the bursts' replay rows and noise
(``tests/test_torch_td3.py``'s reproduction).

Tolerances: a twin's step from JAX's own state at that step
(teacher-forced, so chaos cannot amplify an ulp) f32 1e-6 absolute and
relative, step counts and ``ended`` exactly. Frames: ``render_rod_torch``
equals ``render_rod_jax`` exactly at the 64 angles tested; XLA's
``sin``/``cos`` and torch's differ by an ulp at some angles, which moves
an edge pixel of about 3 frames in 1000 by one count, so a frame elsewhere
is held to at most 1 count on at most 0.1% of its pixels. Loop epochs:
ring rows 1e-5·max(1, |x|), learner state at the optax limits already in
use (atol 1e-5, rtol 1e-4; attention key biases 2·lr per update, see
``tests/test_torch_sac.py``), metrics atol 1e-5 / rtol 1e-4, ``ptr``,
``size`` and ``episodes`` exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_actor_critic_tpu.core.types import MultiObservation as JMultiObservation
from torch_actor_critic_tpu.envs.ondevice import EnvState as JEnvState
from torch_actor_critic_tpu.envs.ondevice import (
    PendulumJax,
    PixelPendulumBalanceJax,
    PixelPendulumJax,
)
from torch_actor_critic_tpu.envs.ondevice import history_env as j_history_env
from torch_actor_critic_tpu.envs.pixel_pendulum import render_rod_jax
from torch_actor_critic_tpu.sac.ondevice import OnDeviceLoop as JOnDeviceLoop
from torch_actor_critic_tpu.sac.ondevice import _SpecView as JSpecView
from torch_actor_critic_tpu.sac.trainer import build_models as j_build_models
from torch_actor_critic_tpu.sac.trainer import make_learner as j_make_learner
from torch_actor_critic_tpu.utils.config import SACConfig as JSACConfig
from torch_actor_critic_tpu_torch import run_agent
from torch_actor_critic_tpu_torch import train as train_mod
from torch_actor_critic_tpu_torch.core.types import MultiObservation
from torch_actor_critic_tpu_torch.envs import ondevice as tenv
from torch_actor_critic_tpu_torch.envs.ondevice import (
    EnvState,
    PendulumTorch,
    PixelPendulumBalanceTorch,
    PixelPendulumTorch,
    history_env,
)
from torch_actor_critic_tpu_torch.envs.pixel_pendulum import render_rod_torch
from torch_actor_critic_tpu_torch.models import build_models
from torch_actor_critic_tpu_torch.sac.ondevice import (
    OnDeviceLoop,
    _wrap_and_build,
    train_on_device,
    warmup_steps,
)
from torch_actor_critic_tpu_torch.sac.trainer import make_learner
from torch_actor_critic_tpu_torch.utils.config import SACConfig
from torch_actor_critic_tpu_torch.weights import _adam_state, _named_arrays, train_state_from_jax

LR = 3e-4
FRAME_COUNTS, FRAME_SHARE = 1, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny ops: one intra-op thread avoids the oversubscription of
    several test workers each spinning a full thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------- helpers


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_env_state(js, rng=None):
    """A JAX env batch as the port's :class:`EnvState` (no PRNG keys)."""
    def conv(x):
        if isinstance(x, JEnvState):
            return EnvState(inner=conv(x.inner), obs=conv(x.obs), step_count=_t(x.step_count),
                            episode_return=_t(x.episode_return), rng=rng)
        if isinstance(x, tuple):
            return tuple(conv(y) for y in x)
        if isinstance(x, JMultiObservation):
            return MultiObservation(_t(x.features), _t(x.frame))
        return _t(x)

    return conv(js)


def _jax_leaves(x) -> list:
    """A JAX env state's arrays in :meth:`EnvState.leaves`' order."""
    if isinstance(x, JEnvState):
        return [*_jax_leaves(x.inner), *_jax_leaves(x.obs), x.step_count, x.episode_return]
    if isinstance(x, tuple):
        return [leaf for y in x for leaf in _jax_leaves(y)]
    if isinstance(x, JMultiObservation):
        return [x.features, x.frame]
    return [x]


def _assert_frames_close(got, want, what=""):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max(initial=0) <= FRAME_COUNTS, f"{what}: frame off by {d.max()} counts"
    assert (d > 0).mean() <= FRAME_SHARE, f"{what}: {(d > 0).mean():.2e} of pixels differ"


def _assert_leaf(got, want, what, atol=1e-6, rtol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if got.dtype == np.uint8:
        _assert_frames_close(got, want, what)
    elif np.issubdtype(got.dtype, np.floating):
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _assert_env_matches(es, jes, what="", **tol):
    for i, (a, b) in enumerate(zip(es.leaves(), _jax_leaves(jes), strict=True)):
        _assert_leaf(a.numpy(), b, f"{what} leaf {i}", **tol)


def _jax_poses(base_cls, rng):
    """Each env's next reset pose, ``(n, 2)``, as JAX's step draws it from
    the env's key: ``PendulumJax.reset(rng)``'s pose for the flat twin,
    ``_sample_pose(fold_in(rng, 0x9A1))`` for the pixel twins."""
    if issubclass(base_cls, PixelPendulumJax):
        th, thd = jax.vmap(lambda r: base_cls._sample_pose(jax.random.fold_in(r, 0x9A1)))(rng)
    else:
        th, thd = jax.vmap(base_cls.reset)(rng).inner
    return torch.from_numpy(np.stack([np.asarray(th), np.asarray(thd)], axis=-1))


# ------------------------------------------------------------- renderer


def test_render_rod_torch_equals_render_rod_jax():
    thetas = np.linspace(-7.0, 7.0, 64).astype(np.float32)
    got = render_rod_torch(torch.from_numpy(thetas)).numpy()
    assert got.shape == (64, 32, 32) and got.dtype == np.uint8
    for th, frame in zip(thetas, got):
        np.testing.assert_array_equal(frame, np.asarray(render_rod_jax(th)), err_msg=str(th))


# ---------------------------------------------------------------- twins

TWINS = {
    # name: (JAX class, port class, history horizon or None)
    "pendulum": (PendulumJax, PendulumTorch, None),
    "pixel": (PixelPendulumJax, PixelPendulumTorch, None),
    "pixel-balance": (PixelPendulumBalanceJax, PixelPendulumBalanceTorch, None),
    "history": (PendulumJax, PendulumTorch, 4),
}


@pytest.mark.parametrize("name", list(TWINS))
def test_twin_steps_match_jax_teacher_forced_through_an_auto_reset(name):
    """250 steps of 3 envs; the first ends at step 5, the others at 200:
    each step from JAX's state at that step, with JAX's reset draws."""
    jcls, tcls, horizon = TWINS[name]
    base = jcls
    if horizon:
        jcls, tcls = j_history_env(jcls, horizon), history_env(tcls, horizon)
    n = 3
    js = jax.vmap(jcls.reset)(jax.random.split(jax.random.key(3), n))
    count = jnp.array([195, 0, 0], jnp.int32)
    js = js.replace(step_count=count)
    if horizon:
        js = js.replace(inner=js.inner.replace(step_count=count))
    jstep = jax.jit(jax.vmap(jcls.step))
    rng = np.random.default_rng(0)
    ended_at = []
    for t_ in range(250):
        action = rng.uniform(-2.5, 2.5, (n, 1)).astype(np.float32)  # clipped at 2
        pose = _jax_poses(base, js.rng)
        state = _port_env_state(js)
        nxt, out = tcls.step(state, torch.from_numpy(action), pose=pose)
        js, jout = jstep(js, jnp.asarray(action))
        _assert_env_matches(nxt, js, f"{name} step {t_}")
        for field in ("next_obs", "reward", "terminated", "ended", "final_return"):
            got = getattr(out, field)
            want = getattr(jout, field)
            if isinstance(got, MultiObservation):
                _assert_leaf(got.features.numpy(), want.features, f"{field} step {t_}")
                _assert_leaf(got.frame.numpy(), want.frame, f"{field} step {t_}")
            else:
                _assert_leaf(got.numpy(), want, f"{field} step {t_}")
        ended_at += [(t_, i) for i in np.flatnonzero(np.asarray(jout.ended))]
    assert ended_at == [(4, 0), (199, 1), (199, 2), (204, 0)]


@pytest.mark.parametrize("name", list(TWINS))
def test_twin_reset_matches_jax_from_its_pose(name):
    jcls, tcls, horizon = TWINS[name]
    base = jcls
    if horizon:
        jcls, tcls = j_history_env(jcls, horizon), history_env(tcls, horizon)
    keys = jax.random.split(jax.random.key(5), 4)
    js = jax.vmap(jcls.reset)(keys)
    if issubclass(base, PixelPendulumJax):
        pose = jax.vmap(lambda k: base._sample_pose(jax.random.split(k)[0]))(keys)
    else:
        pose = jax.vmap(lambda k: tuple(jax.random.uniform(kk, (), minval=lo, maxval=hi) for kk, lo, hi in
                                        zip(jax.random.split(k, 3)[:2], (-jnp.pi, -1.0),
                                            (jnp.pi, 1.0))))(keys)
    pose = torch.from_numpy(np.stack([np.asarray(p) for p in pose], axis=-1))
    _assert_env_matches(tcls.reset(4, pose=pose), js, name)


def test_reset_poses_follow_the_jax_distributions():
    gen = torch.Generator().manual_seed(0)
    for cls, (th, thd) in ((PendulumTorch, (np.pi, 1.0)), (PixelPendulumTorch, (np.pi, 1.0)),
                           (PixelPendulumBalanceTorch, (0.15 * np.pi, 0.2))):
        pose = cls.sample_pose(20000, gen).numpy()
        for col, lim in ((0, th), (1, thd)):
            x = pose[:, col]
            assert np.abs(x).max() <= lim + 1e-6
            assert abs(x.mean()) < 0.03 * lim and abs(x.std() - lim / np.sqrt(3)) < 0.03 * lim


def test_twin_step_draws_its_poses_from_the_batch_generator():
    """Without injected poses a step draws one pose per env from the
    batch's generator: two batches at one generator state step alike."""
    states = [PixelPendulumTorch.reset(3, generator=torch.Generator().manual_seed(1))
              for _ in range(2)]
    for s in states:
        s.step_count.fill_(199)  # every env ends now
    outs = [PixelPendulumTorch.step(s, torch.ones(3, 1)) for s in states]
    for a, b in zip(outs[0][0].leaves(), outs[1][0].leaves()):
        assert torch.equal(a, b)
    assert bool(outs[0][1].ended.all()) and (outs[0][0].step_count == 0).all()


# -------------------------------------------------- twins: JAX's semantics


def test_pendulum_auto_reset():
    state = PendulumTorch.reset(1, generator=torch.Generator().manual_seed(0))
    action = torch.zeros(1, 1)
    for _ in range(PendulumTorch.max_episode_steps):
        state, out = PendulumTorch.step(state, action)
    assert bool(out.ended) and int(state.step_count) == 0
    assert float(state.episode_return) == 0.0 and float(out.final_return) < 0.0
    state, out = PendulumTorch.step(state, action)
    assert not bool(out.ended) and int(state.step_count) == 1


def test_registry():
    assert tenv.get_on_device_env("Pendulum-v1") is PendulumTorch
    assert tenv.get_on_device_env("PendulumNumpy-v1") is PendulumTorch
    assert tenv.get_on_device_env("PixelPendulumBalanceNumpy-v0") is PixelPendulumBalanceTorch
    assert tenv.get_on_device_env("Walker2d-v4") is None
    assert tenv.get_on_device_env("HalfCheetah-v5") is tenv.CheetahRunTorch
    assert tenv.get_on_device_env("cheetah-run-jax") is tenv.CheetahRunTorch
    for name in ("multi-pendulum-4", "hurdle-runner"):
        with pytest.raises(NotImplementedError, match="not ported"):
            tenv.get_on_device_env(name)


class TestHistoryEnv:
    def test_reset_fills_window_and_step_rolls(self):
        H = history_env(PendulumTorch, 4)
        assert H.obs_shape == (4, 3)
        s = H.reset(2, generator=torch.Generator().manual_seed(0))
        assert torch.equal(s.obs, s.inner.obs[:, None].expand(2, 4, 3))
        s2, out = H.step(s, torch.full((2, 1), 0.5))
        assert torch.equal(s2.obs[:, :-1], s.obs[:, 1:])
        assert torch.equal(s2.obs[:, -1], s2.inner.obs)
        assert torch.equal(out.next_obs, s2.obs)

    def test_auto_reset_refills_window(self):
        H = history_env(PendulumTorch, 3)
        s = H.reset(1, generator=torch.Generator().manual_seed(1))
        for _ in range(PendulumTorch.max_episode_steps):
            s, out = H.step(s, torch.full((1, 1), 0.1))
        assert bool(out.ended)
        assert torch.equal(s.obs, s.inner.obs[:, None].expand(1, 3, 3))
        assert not torch.allclose(out.next_obs[:, -1], s.obs[:, -1])  # the pre-reset frame

    def test_clone_copies_the_shared_generator_once(self):
        """A history state and its base state share one generator; their
        clone shares one new generator at its state, so the clone steps
        as the original does, apart from it."""
        H = history_env(PendulumTorch, 3)
        s = H.reset(2, generator=torch.Generator().manual_seed(4))
        c = s.clone()
        assert c.rng is c.inner.rng and c.rng is not s.rng
        for state in (s, c):
            state.inner.step_count.fill_(199)
            state.step_count.fill_(199)
        (a, _), (b, _) = H.step(s, torch.zeros(2, 1)), H.step(c, torch.zeros(2, 1))
        assert all(torch.equal(x, y) for x, y in zip(a.leaves(), b.leaves()))
        assert torch.equal(s.rng.get_state(), c.rng.get_state())

    def test_pixel_twin_is_rejected(self):
        with pytest.raises(ValueError, match="pytree"):
            history_env(PixelPendulumTorch, 8)


class TestPixelPendulumTorch:
    def test_env_semantics(self):
        st = PixelPendulumTorch.reset(1, generator=torch.Generator().manual_seed(0))
        assert st.obs.frame.dtype == torch.uint8 and st.obs.frame.shape == (1, 32, 32, 3)
        assert torch.equal(st.obs.frame[..., 0], st.obs.frame[..., 1])
        assert torch.equal(st.obs.features, torch.zeros(1, 1))
        moved = False
        for _ in range(5):
            st, out = PixelPendulumTorch.step(st, torch.full((1, 1), 1.5))
            moved = moved or bool((out.next_obs.frame[..., 0] != out.next_obs.frame[..., 1]).any())
        assert moved
        assert torch.equal(out.next_obs.features, torch.full((1, 1), 1.5))

    def test_temporal_channel_order(self):
        st = PixelPendulumTorch.reset(1, generator=torch.Generator().manual_seed(2))
        thetas = [float(st.inner[0])]
        for t_ in range(4):
            st, out = PixelPendulumTorch.step(st, torch.ones(1, 1))
            thetas.append(float(st.inner[0]))
            expected = [thetas[max(t_ - 1, 0)], thetas[t_], thetas[t_ + 1]]
            for c, th in enumerate(expected):
                assert torch.equal(out.next_obs.frame[0, ..., c],
                                   render_rod_torch(torch.tensor([th]))[0])

    def test_auto_reset_restores_motionless_frame(self):
        st = PixelPendulumTorch.reset(1, generator=torch.Generator().manual_seed(1))
        for _ in range(PixelPendulumTorch.max_episode_steps):
            st, out = PixelPendulumTorch.step(st, torch.full((1, 1), 2.0))
        assert bool(out.ended) and int(st.step_count) == 0
        assert torch.equal(st.obs.frame[..., 0], st.obs.frame[..., 1])
        assert torch.equal(st.obs.features, torch.zeros(1, 1))


def test_balance_twin_resets_near_upright_including_auto_reset():
    gen = torch.Generator().manual_seed(7)
    st = PixelPendulumBalanceTorch.reset(5, generator=gen)
    assert (st.inner[0].abs() < 0.15 * np.pi + 1e-6).all()
    for _ in range(PixelPendulumBalanceTorch.max_episode_steps):
        st, out = PixelPendulumBalanceTorch.step(st, torch.zeros(5, 1))
    assert bool(out.ended.all())
    assert (st.inner[0].abs() < 0.15 * np.pi + 1e-6).all()


# ------------------------------------------------------- loop vs JAX's

PIXEL = dict(filters=(8, 16), kernel_sizes=(4, 3), strides=(2, 2), cnn_dense_size=32,
             cnn_features=8, normalize_pixels=True, frame_augment="shift",
             pixel_pipeline="fused")
LOOPS = {
    # name: (config overrides, JAX env, port env, history horizon or None)
    "flat-sac": (dict(hidden_sizes=(16, 16)), PendulumJax, PendulumTorch, None),
    "history-sac": (dict(history_len=4, seq_d_model=16, seq_num_heads=2, seq_num_layers=1),
                    PendulumJax, PendulumTorch, 4),
    "flat-td3": (dict(algorithm="td3", hidden_sizes=(16, 16)), PendulumJax, PendulumTorch,
                 None),
    "pixel-td3": (dict(PIXEL, algorithm="td3", hidden_sizes=(16, 16)), PixelPendulumJax,
                  PixelPendulumTorch, None),
}
N_ENVS, UPDATE_EVERY, STEPS, BATCH, CAPACITY, PAD = 3, 5, 10, 8, 50, 4
# Env 0 ends in the warm-up epoch, env 2 in the trained one.
START_COUNTS = (193, 0, 188)


def _np_rows(buf) -> list:
    return [np.array(x) for x in jax.tree_util.tree_leaves(buf.data)]


def _assert_rows_match(ring, jrows, size, what):
    for (name, got), want in zip(ring.data.named_leaves(), jrows, strict=True):
        got, want = got[:size].numpy(), want[:size]
        if got.dtype == np.uint8:
            _assert_frames_close(got, want, f"{what} {name}")
        else:
            assert np.all(np.abs(got - want) <= 1e-5 * np.maximum(1.0, np.abs(want))), \
                f"{what} {name}: {np.abs(got - want).max()}"


def _assert_metrics_match(tm, jm, what):
    assert float(tm["episodes"]) == float(jm["episodes"]), what
    for k in ("loss_q", "loss_pi", "reward"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4,
                                   equal_nan=True, err_msg=f"{what} {k}")


def _assert_module_matches(module, tree, updates, what):
    want = _named_arrays(module, jax.tree_util.tree_map(np.asarray, tree))
    for name, p in module.named_parameters():
        got = p.detach().numpy()
        if name.endswith("attn.k.bias"):
            # Zero gradient in exact arithmetic (tests/test_torch_sac.py).
            assert np.abs(got - want[name]).max() <= 2 * LR * updates, f"{what}{name}"
        else:
            np.testing.assert_allclose(got, want[name], atol=1e-5, rtol=1e-4,
                                       err_msg=f"{what}{name}")


def _assert_learner_matches(ts, jts, updates):
    pairs = [("actor", "actor_params"), ("critic", "critic_params"),
             ("target_critic", "target_critic_params")]
    if ts.target_actor is not None:
        pairs.append(("target_actor", "target_actor_params"))
    for mine, theirs in pairs:
        _assert_module_matches(getattr(ts, mine), getattr(jts, theirs), updates, f"{mine} ")
    for opt, module, jopt in (("pi_opt", ts.actor, jts.pi_opt_state),
                              ("q_opt", ts.critic, jts.q_opt_state)):
        adam = _adam_state(jax.tree_util.tree_map(np.asarray, jopt))
        for moment, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
            want = _named_arrays(module, moment)
            for name, p in module.named_parameters():
                np.testing.assert_allclose(getattr(ts, opt).state[p][key].numpy(), want[name],
                                           atol=1e-5, rtol=1e-4, err_msg=f"{opt} {key} {name}")
    assert ts.step == int(ts.device_step) == int(jts.step) == updates


def _act_noise(key, steps, act_dim, warmup):
    """JAX's acting draws: ``key, k = split(key)`` each step, then
    ``uniform(k)`` (warm-up: the port scales it to the action box as JAX
    does) or ``normal(k)`` (the policy's noise)."""
    out = []
    for _ in range(steps):
        key, k_act = jax.random.split(key)
        draw = jax.random.uniform if warmup else jax.random.normal
        out.append(np.asarray(draw(k_act, (N_ENVS, act_dim))))
    return torch.from_numpy(np.stack(out))


def _burst_draws(rng, sizes, num_updates, act_dim, algorithm, fused):
    """Each window's replay rows, update noise and (fused) shifts as the
    JAX burst draws them from the learner key."""
    indices, eps, offsets = [], [], []
    for size in sizes:
        wi, we, wo = [], [], []
        for _ in range(num_updates):
            rng, sample_key = jax.random.split(rng)
            if fused:
                k_idx, k_s, k_n = jax.random.split(sample_key, 3)
                wo.append(np.stack([np.asarray(jax.random.randint(kk, (BATCH, 2), 0, 2 * PAD + 1))
                                    for kk in (k_s, k_n)]))
            else:
                k_idx = sample_key
            wi.append(np.asarray(jax.random.randint(k_idx, (BATCH,), 0, size)))
            if algorithm == "td3":
                rng, key_q = jax.random.split(rng)
                we.append(np.asarray(jax.random.normal(key_q, (BATCH, act_dim))))
            else:
                rng, key_q, key_pi = jax.random.split(rng, 3)
                we.append(np.stack([np.asarray(jax.random.normal(k, (BATCH, act_dim)))
                                    for k in (key_q, key_pi)]))
        indices.append(np.stack(wi))
        eps.append(np.stack(we))
        offsets.append(np.stack(wo) if wo else None)
    return (torch.from_numpy(np.stack(indices)), torch.from_numpy(np.stack(eps)),
            torch.from_numpy(np.stack(offsets)) if fused else None)


@pytest.mark.parametrize("name", list(LOOPS))
def test_loop_epochs_match_jax(name):
    """A warm-up and a trained epoch of two windows each against JAX's
    ``OnDeviceLoop.epoch``, with its draws injected."""
    overrides, jbase, tbase, horizon = LOOPS[name]
    jcfg = JSACConfig(batch_size=BATCH, update_every=UPDATE_EVERY, **overrides)
    jenv = j_history_env(jbase, horizon) if horizon else jbase
    actor_def, critic_def = j_build_models(jcfg, JSpecView(jenv))
    jlearner = j_make_learner(jcfg, actor_def, critic_def, jenv.act_dim)
    jloop = JOnDeviceLoop(jlearner, jenv, n_envs=N_ENVS)
    jts, jbuf, jes, jkey = jloop.init(jax.random.key(0), buffer_capacity=CAPACITY)
    count = jnp.array(START_COUNTS, jnp.int32)
    jes = jes.replace(step_count=count)
    if horizon:
        jes = jes.replace(inner=jes.inner.replace(step_count=count))

    cfg = SACConfig(batch_size=BATCH, update_every=UPDATE_EVERY, **overrides)
    env, learner = _wrap_and_build(tbase, cfg)
    loop = OnDeviceLoop(learner, env, n_envs=N_ENVS, device="cpu")
    _, ring, _, act_gen = loop.init(0, buffer_capacity=CAPACITY)
    shape = (tenv.MultiObservation(features=(1,), frame=(32, 32, 3)) if hasattr(env, "obs_spec")
             else getattr(env, "obs_shape", (env.obs_dim,)))
    actor, critic = build_models(cfg, shape, env.act_dim, env.act_limit)
    jts_np = jax.tree_util.tree_map(np.asarray, jts.replace(rng=jax.random.key_data(jts.rng)))
    state = train_state_from_jax(jts_np, learner, actor, critic, torch.Generator())
    es = _port_env_state(jes, rng=torch.Generator())
    fused = cfg.pixel_pipeline == "fused"
    act_dim = env.act_dim

    # Warm-up.
    noise, poses = _act_noise(jkey, STEPS, act_dim, True), _jax_poses(jbase, jes.rng)
    poses = poses.expand(STEPS, *poses.shape)
    jts, jbuf, jes1, jkey, jm = jloop.epoch(jts, jbuf, jes, jkey, steps=STEPS,
                                            update_every=UPDATE_EVERY, warmup=True)
    jrows, jsize, jptr = _np_rows(jbuf), int(jbuf.size), int(jbuf.ptr)
    jrng = jax.random.wrap_key_data(np.asarray(jax.random.key_data(jts.rng)))
    state, ring, es, act_gen, tm = loop.epoch(state, ring, es, act_gen, steps=STEPS,
                                              update_every=UPDATE_EVERY, warmup=True,
                                              noise=noise, poses=poses)
    assert (ring.ptr, ring.size) == (jptr, jsize) == (STEPS * N_ENVS,) * 2
    _assert_rows_match(ring, jrows, jsize, "warm-up ring")
    _assert_metrics_match(tm, jm, "warm-up")
    assert float(tm["episodes"]) == 1.0 and state.step == 0
    _assert_env_matches(es, jes1, "warm-up env", atol=1e-5, rtol=1e-5)

    # Trained.
    noise, poses = _act_noise(jkey, STEPS, act_dim, False), _jax_poses(jbase, jes1.rng)
    poses = poses.expand(STEPS, *poses.shape)
    per = cfg.updates_per_window
    sizes = [min(jsize + (w + 1) * UPDATE_EVERY * N_ENVS, CAPACITY)
             for w in range(STEPS // UPDATE_EVERY)]
    indices, eps, offsets = _burst_draws(jrng, sizes, per, act_dim, cfg.algorithm, fused)
    jts, jbuf, jes2, jkey, jm = jloop.epoch(jts, jbuf, jes1, jkey, steps=STEPS,
                                            update_every=UPDATE_EVERY)
    state, ring, es, act_gen, tm = loop.epoch(state, ring, es, act_gen, steps=STEPS,
                                              update_every=UPDATE_EVERY, noise=noise,
                                              poses=poses, indices=indices, eps=eps,
                                              offsets=offsets)
    assert (ring.ptr, ring.size) == (int(jbuf.ptr), int(jbuf.size))
    assert ring.size == CAPACITY and ring.ptr == 2 * STEPS * N_ENVS - CAPACITY  # wrapped
    _assert_rows_match(ring, _np_rows(jbuf), ring.size, "trained ring")
    _assert_metrics_match(tm, jm, "trained")
    assert float(tm["episodes"]) == 1.0
    _assert_learner_matches(state, jts, updates=per * STEPS // UPDATE_EVERY)


# ------------------------------------------- the loop's mechanics (JAX's)


def _loop(n_envs=8, **over):
    cfg = SACConfig(hidden_sizes=(32, 32), batch_size=32, **over)
    env, learner = _wrap_and_build(PendulumTorch, cfg)
    return OnDeviceLoop(learner, env, n_envs=n_envs, device="cpu")


def test_fused_epoch_mechanics():
    loop = _loop()
    ts, buf, es, gen = loop.init(0, buffer_capacity=10_000)
    ts, buf, es, gen, m = loop.epoch(ts, buf, es, gen, steps=50, warmup=True)
    assert buf.size == 50 * 8 and ts.step == 0
    ts, buf, es, gen, m = loop.epoch(ts, buf, es, gen, steps=100, update_every=50)
    assert ts.step == 100 and buf.size == 150 * 8
    assert np.isfinite(float(m["loss_q"])) and np.isfinite(float(m["loss_pi"]))
    assert loop.act_captures == 0  # the CPU runs the acting step eagerly


def test_fused_epoch_chunk_rows_are_in_jax_order():
    """Row ``t * n_envs + i`` of a window holds env ``i``'s step ``t``:
    each transition's ``next_states`` is the next row block's ``states``
    within an episode."""
    loop = _loop(n_envs=4)
    ts, buf, es, gen = loop.init(0, buffer_capacity=1_000)
    ts, buf, es, gen, _ = loop.epoch(ts, buf, es, gen, steps=10, update_every=10, warmup=True)
    d = buf.data
    assert torch.equal(d.next_states[:36], d.states[4:40])
    assert bool((d.actions[:40].abs() <= 2.0).all())


def test_fused_sequence_epoch():
    cfg = SACConfig(batch_size=16, history_len=4, seq_d_model=16, seq_num_heads=2,
                    seq_num_layers=1)
    env, learner = _wrap_and_build(PendulumTorch, cfg)
    loop = OnDeviceLoop(learner, env, n_envs=4, device="cpu")
    ts, buf, es, gen = loop.init(0, buffer_capacity=500)
    ts, buf, es, gen, _ = loop.epoch(ts, buf, es, gen, steps=20, update_every=10, warmup=True)
    ts, buf, es, gen, m = loop.epoch(ts, buf, es, gen, steps=20, update_every=10)
    assert np.isfinite(float(m["loss_q"])) and np.isfinite(float(m["loss_pi"]))
    assert buf.size == 160 and buf.data.states.shape[1:] == (4, 3)


def test_fused_loop_runs_td3_and_td3_visual():
    for env_cls, extra in ((PendulumTorch, {}),
                           (PixelPendulumTorch, {k: v for k, v in PIXEL.items()
                                                 if k not in ("frame_augment", "pixel_pipeline")})):
        cfg = SACConfig(algorithm="td3", hidden_sizes=(16, 16), batch_size=8, **extra)
        env, learner = _wrap_and_build(env_cls, cfg)
        loop = OnDeviceLoop(learner, env, n_envs=4, device="cpu")
        ts, buf, es, gen = loop.init(0, buffer_capacity=1000)
        ts, buf, es, gen, _ = loop.epoch(ts, buf, es, gen, steps=25, update_every=25, warmup=True)
        ts, buf, es, gen, m = loop.epoch(ts, buf, es, gen, steps=25, update_every=25)
        assert ts.step == 25, env_cls.__name__
        assert np.isfinite(float(m["loss_q"])) and np.isfinite(float(m["loss_pi"]))
        if env_cls is PixelPendulumTorch:
            assert buf.data.states.frame.dtype == torch.uint8


def test_loop_utd_scales_updates_and_reward_is_nan_without_episodes():
    loop = _loop(n_envs=2, utd=0.5)
    ts, buf, es, gen = loop.init(0, buffer_capacity=500)
    ts, buf, es, gen, m = loop.epoch(ts, buf, es, gen, steps=20, update_every=10, warmup=True)
    assert np.isnan(float(m["reward"])) and float(m["episodes"]) == 0.0
    ts, buf, es, gen, m = loop.epoch(ts, buf, es, gen, steps=20, update_every=10)
    assert ts.step == 10  # 2 windows x round(10 * 0.5)


def test_loop_rejects_a_mesh_and_a_partial_window():
    with pytest.raises(NotImplementedError, match="mesh"):
        OnDeviceLoop(make_learner(SACConfig(), 1), PendulumTorch, mesh=object(), device="cpu")
    loop = _loop(n_envs=2)
    ts, buf, es, gen = loop.init(0, buffer_capacity=100)
    with pytest.raises(ValueError, match="multiple"):
        loop.epoch(ts, buf, es, gen, steps=15, update_every=10, warmup=True)


def test_warmup_steps():
    assert warmup_steps(1000, 50) == 1000
    assert warmup_steps(20, 50) == 50
    assert warmup_steps(120, 50) == 100


@pytest.mark.slow
def test_fused_training_improves_return():
    """About 20k gradient steps of fused SAC must beat the random policy
    by a wide margin (random pendulum is about -1200 an episode); JAX's
    thresholds."""
    loop = _loop(n_envs=8)
    ts, buf, es, gen = loop.init(1, buffer_capacity=100_000)
    ts, buf, es, gen, _ = loop.epoch(ts, buf, es, gen, steps=200, warmup=True)
    first = None
    for _ in range(8):
        ts, buf, es, gen, m = loop.epoch(ts, buf, es, gen, steps=2500, update_every=50)
        if first is None:
            first = float(m["reward"])
    assert float(m["reward"]) > first + 100.0, (first, float(m["reward"]))
    assert float(m["reward"]) > -1000.0, float(m["reward"])


# ------------------------------------------------ train_on_device, CLI

CLI_ARGS = ["--on-device", "true", "--on-device-envs", "2", "--epochs", "1",
            "--steps-per-epoch", "40", "--update-every", "20", "--start-steps", "20",
            "--update-after", "20", "--batch-size", "16", "--buffer-size", "500",
            "--hidden-sizes", "16,16", "--device", "cpu"]


def test_on_device_run_evaluates_through_host_eval_cli(tmp_path, capsys):
    metrics = train_mod.main(["--environment", "Pendulum-v1", "--devices", "1",
                              "--runs-root", str(tmp_path), *CLI_ARGS])
    assert np.isfinite(metrics["loss_q"]) and metrics["act_graph_captures"] == 0
    run_id = next((tmp_path / "Default").iterdir()).name
    epoch_dir = tmp_path / "Default" / run_id / "artifacts" / "checkpoints" / "epoch_0"
    assert sorted(p.name for p in epoch_dir.iterdir()) == [
        "actor.pt", "buffer.pt", "meta.json", "state.pt"]
    meta = json.loads((epoch_dir / "meta.json").read_text())
    assert meta["step"] == 60 and meta["buffer"] and meta["on_device"]
    capsys.readouterr()
    out = run_agent.main(["--run", run_id, "--runs-root", str(tmp_path), "--episodes", "2",
                          "--headless", "--seed", "0", "--device", "cpu"])
    assert np.isfinite(out["ep_ret_mean"]) and out["ep_len_mean"] == 200.0


def test_on_device_cli_resumes_learner_and_ring(tmp_path, capsys):
    """``--run`` resumes through the fused loop (the stored config says
    so): learner and ring from the checkpoint, no second warm-up."""
    train_mod.main(["--environment", "PendulumNumpy-v1", "--runs-root", str(tmp_path),
                    *CLI_ARGS])
    run_id = next((tmp_path / "Default").iterdir()).name
    capsys.readouterr()
    metrics = train_mod.main(["--run", run_id, "--runs-root", str(tmp_path), "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["epoch"] for x in lines[:-1]] == [1] and np.isfinite(metrics["loss_q"])
    ck = tmp_path / "Default" / run_id / "artifacts" / "checkpoints"
    meta = json.loads((ck / "epoch_1" / "meta.json").read_text())
    assert meta["step"] == 100  # 20 warm-up + 40 + 40: the warm-up ran once
    ring = torch.load(ck / "epoch_1" / "buffer.pt", weights_only=True)
    assert ring["size"] == 200  # 100 steps x 2 envs, the resumed ring kept


def test_on_device_no_save_buffer_resumes_with_an_empty_ring(tmp_path, monkeypatch):
    train_mod.main(["--environment", "PendulumNumpy-v1", "--runs-root", str(tmp_path),
                    "--no-save-buffer", *CLI_ARGS])
    run_id = next((tmp_path / "Default").iterdir()).name
    ck = tmp_path / "Default" / run_id / "artifacts" / "checkpoints"
    assert not (ck / "epoch_0" / "buffer.pt").exists()
    sizes = []
    real = OnDeviceLoop.epoch

    def spy(self, state, ring, *a, **k):
        sizes.append(ring.size)
        return real(self, state, ring, *a, **k)

    monkeypatch.setattr(OnDeviceLoop, "epoch", spy)
    train_mod.main(["--run", run_id, "--runs-root", str(tmp_path), "--device", "cpu",
                    "--no-save-buffer"])
    assert sizes == [0]  # the resumed epoch starts from an empty ring


@pytest.mark.parametrize("argv,err,match", [
    (["--environment", "Walker2d-v4"], ValueError, "PixelPendulumBalance-v0"),
    # The cheetah twin's TD3 population trains; TD3 with a history raises, as in JAX.
    (["--environment", "HalfCheetah-v5", "--population", "2", "--algorithm", "td3",
      "--history-len", "4"], ValueError, "flat and visual"),
    (["--environment", "multi-pendulum-4"], NotImplementedError, "scenario"),
    # The pixel population trains; the default conv stack does not fit its 32x32 frames.
    (["--environment", "PixelPendulumNumpy-v0", "--population", "2"], ValueError,
     "reduces a 32x32 frame to nothing"),
    (["--environment", "Pendulum-v1", "--devices", "2"], NotImplementedError, "--devices"),
])
def test_on_device_cli_raises_for_what_it_does_not_run(tmp_path, argv, err, match):
    with pytest.raises(err, match=match):
        train_mod.main([*argv, "--runs-root", str(tmp_path), *CLI_ARGS])


def test_train_on_device_raises_on_a_diverged_loss(tmp_path, monkeypatch):
    cfg = SACConfig(on_device=True, on_device_envs=2, epochs=1, steps_per_epoch=20,
                    update_every=10, start_steps=10, batch_size=8, buffer_size=100,
                    hidden_sizes=(8,), reward_scale=float("nan"))
    with pytest.raises(FloatingPointError, match="loss_q"):
        train_on_device("PendulumNumpy-v1", cfg, device="cpu")
