"""The port's visual models, visual SAC update, fused visual burst and
visual trainer against the JAX package's, on the CPU.

JAX models are initialised from a seed and their Flax params (for the
update, the whole JAX ``TrainState`` with its optax Adam states) are
carried into the port by ``weights.py``. Inputs are numpy from a seed;
the fused burst's rows and DrQ offsets are JAX's own draws (``rng,
sample_key = split(rng)``, then ``k_idx, k_s, k_n = split(sample_key,
3)`` as ``sample_fused_visual`` splits them) and the actor noise the
update draws (``rng, key_q, key_pi = split(rng, 3)``), injected into the
port. JAX samples through its jnp reference on the CPU.

Tolerances: forwards 1e-5·max(1, max|ref|) in f32 (raw 0–255 pixels make
large activations; the convolutions sum in another order); the update
and burst as ``tests/test_torch_sac.py``: losses and metrics atol 1e-5 /
rtol 1e-4, parameters and Adam moments atol 1e-5 / rtol 1e-4. Under
``jit`` XLA decodes f32 ``v / 255`` as ``v * (1/255)`` (1 ulp), inside
those limits.
"""

import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_actor_critic_tpu.buffer import replay as jreplay
from torch_actor_critic_tpu.core.types import Batch as JBatch
from torch_actor_critic_tpu.core.types import MultiObservation as JMultiObservation
from torch_actor_critic_tpu.models.visual import conv_output_size as j_conv_output_size
from torch_actor_critic_tpu.sac.algorithm import SAC as JSAC
from torch_actor_critic_tpu.sac.algorithm import run_update_burst as j_run_update_burst
from torch_actor_critic_tpu.sac.trainer import build_models as j_build_models
from torch_actor_critic_tpu.utils.config import SACConfig as JSACConfig
from torch_actor_critic_tpu_torch.buffer import replay
from torch_actor_critic_tpu_torch.core.types import Batch, MultiObservation
from torch_actor_critic_tpu_torch.models import VisualActor, VisualDoubleCritic, build_models
from torch_actor_critic_tpu_torch.models.visual import conv_output_size
from torch_actor_critic_tpu_torch.ops import _kernels
from torch_actor_critic_tpu_torch.sac.algorithm import SAC
from torch_actor_critic_tpu_torch.sac.trainer import Trainer
from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer
from torch_actor_critic_tpu_torch.utils.config import SACConfig
from torch_actor_critic_tpu_torch.weights import (
    _adam_state,
    _named_arrays,
    load_jax_actor_params,
    load_jax_critic_params,
    train_state_from_jax,
)

ACT_LIMIT, BATCH, PAD = 2.0, 8, 4
PIXEL_CONV = dict(filters=(16, 32), kernel_sizes=(4, 3), strides=(2, 2),
                  cnn_dense_size=128, cnn_features=64, normalize_pixels=True)
CASES = {
    # name: (config overrides, features dim, frame shape, act dim)
    # the JAX package's PIXEL_RECIPE on PixelPendulum's 32x32x3 frames
    "pixel": (dict(PIXEL_CONV, hidden_sizes=(32, 32), frame_augment="shift",
                   learn_alpha=True, pixel_pipeline="fused"), 1, (32, 32, 3), 1),
    # SACConfig's default visual widths (the Atari trunk, raw 0-255 pixels)
    # on the wall-runner's 64x64x3 frame, narrow MLP and features
    "atari": (dict(hidden_sizes=(32, 32)), 6, (64, 64, 3), 2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny ops: one intra-op thread avoids the oversubscription of
    several test workers each spinning a full thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    overrides, feat, frame, act_dim = CASES[name]
    jcfg = JSACConfig(batch_size=BATCH, **overrides)
    env = types.SimpleNamespace(
        obs_spec=JMultiObservation(
            features=jax.ShapeDtypeStruct((feat,), jnp.float32),
            frame=jax.ShapeDtypeStruct(frame, jnp.uint8),
        ),
        act_dim=act_dim, act_limit=ACT_LIMIT,
    )
    actor_def, critic_def = j_build_models(jcfg, env)
    jsac = JSAC(jcfg, actor_def, critic_def, act_dim)
    example = JMultiObservation(features=jnp.zeros((feat,)), frame=jnp.zeros(frame, jnp.uint8))
    state = jax.jit(jsac.init_state)(jax.random.PRNGKey(0), example)
    shape = MultiObservation(features=(feat,), frame=frame)
    return jsac, state, SACConfig(batch_size=BATCH, **overrides), shape, act_dim


def _obs(n, feat, frame, seed, decoded=False):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (n, *frame), dtype=np.uint8)
    return dict(features=rng.standard_normal((n, feat)).astype(np.float32),
                frame=(f.astype(np.float32) / np.float32(255)) if decoded else f)


def _batch(name, n, seed, decoded=False):
    _, _, _, shape, act_dim = _jax_case(name)
    (feat,), frame = shape.features, shape.frame
    rng = np.random.default_rng(seed + 1000)
    return dict(states=_obs(n, feat, frame, seed, decoded),
                actions=rng.uniform(-ACT_LIMIT, ACT_LIMIT, (n, act_dim)).astype(np.float32),
                rewards=rng.standard_normal(n).astype(np.float32),
                next_states=_obs(n, feat, frame, seed + 1, decoded),
                done=(rng.uniform(size=n) < 0.25).astype(np.float32))


def _jbatch(b):
    return JBatch(states=JMultiObservation(**b["states"]), actions=b["actions"],
                  rewards=b["rewards"], next_states=JMultiObservation(**b["next_states"]),
                  done=b["done"])


def _tobs(o):
    return MultiObservation(torch.from_numpy(np.array(o["features"])),
                            torch.from_numpy(np.array(o["frame"])))


def _tbatch(b):
    return Batch(states=_tobs(b["states"]), actions=torch.from_numpy(b["actions"]),
                 rewards=torch.from_numpy(b["rewards"]), next_states=_tobs(b["next_states"]),
                 done=torch.from_numpy(b["done"]))


def _port_state(name, jax_state=None):
    jsac, state, cfg, shape, act_dim = _jax_case(name)
    sac = SAC(cfg, act_dim)
    actor, critic = build_models(cfg, shape, act_dim, ACT_LIMIT)
    ts = train_state_from_jax(_np_tree(jax_state if jax_state is not None else state),
                              sac, actor, critic, torch.Generator())
    return sac, ts


def _noise(rng_key, act_dim):
    rng, key_q, key_pi = jax.random.split(rng_key, 3)
    eps = [torch.from_numpy(np.array(jax.random.normal(k, (BATCH, act_dim))))
           for k in (key_q, key_pi)]
    return rng, eps[0], eps[1]


def _assert_close(got, want, what):
    lim = 1e-5 * max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= lim, (what, np.abs(got - want).max(), lim)


def _assert_module_matches(module, tree, what=""):
    want = _named_arrays(module, _np_tree(tree))
    assert set(want) == {n for n, _ in module.named_parameters()}
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-5, rtol=1e-4,
                                   err_msg=f"{what}{name}")


def _assert_adam_matches(opt, module, jax_opt_state, what=""):
    adam = _adam_state(_np_tree(jax_opt_state))
    for moment, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
        want = _named_arrays(module, moment)
        for name, p in module.named_parameters():
            np.testing.assert_allclose(opt.state[p][key].numpy(), want[name], atol=1e-5,
                                       rtol=1e-4, err_msg=f"{what}{key} {name}")


# --------------------------------------------------------------- models


@pytest.mark.parametrize("geometry", [((32, 32), (16, 32), (4, 3), (2, 2)),
                                      ((64, 64), (32, 64, 64), (8, 4, 3), (4, 2, 1)),
                                      ((84, 60), (32, 64, 64), (8, 4, 3), (4, 2, 1))])
def test_conv_output_size_matches_jax(geometry):
    assert conv_output_size(*geometry) == j_conv_output_size(*geometry)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("decoded", [False, True])
def test_visual_actor_and_critic_forwards_match_jax(name, decoded):
    """uint8 frames (the acting path: the CNN decodes) and float frames
    (the fused pipeline: decoded upstream, passed through)."""
    jsac, state, cfg, shape, act_dim = _jax_case(name)
    actor, critic = build_models(cfg, shape, act_dim, ACT_LIMIT)
    assert isinstance(actor, VisualActor) and isinstance(critic, VisualDoubleCritic)
    load_jax_actor_params(actor, _np_tree(state.actor_params))
    load_jax_critic_params(critic, _np_tree(state.critic_params))
    b = _batch(name, 4, seed=1, decoded=decoded and cfg.normalize_pixels)
    jobs, tobs = JMultiObservation(**b["states"]), _tobs(b["states"])
    key = jax.random.PRNGKey(3)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (4, act_dim))))
    want_q = np.asarray(jax.jit(jsac.critic_def.apply)(state.critic_params, jobs, b["actions"]))
    want_a, want_logp = jax.jit(jsac.actor_def.apply)(state.actor_params, jobs, key)
    want_det, _ = jax.jit(functools.partial(jsac.actor_def.apply, deterministic=True))(
        state.actor_params, jobs)
    with torch.no_grad():
        got_q = critic(tobs, torch.from_numpy(b["actions"]))
        got_a, got_logp = actor(tobs, eps=eps)
        got_det, _ = actor(tobs, deterministic=True)
    assert got_q.shape == (2, 4) and got_a.shape == (4, act_dim)
    _assert_close(got_q.numpy(), want_q, "q")
    _assert_close(got_a.numpy(), np.asarray(want_a), "action")
    _assert_close(got_logp.numpy(), np.asarray(want_logp), "logp")
    _assert_close(got_det.numpy(), np.asarray(want_det), "deterministic action")
    assert not np.allclose(got_q[0].numpy(), got_q[1].numpy())
    # Unbatched inputs come back unbatched.
    one = MultiObservation(tobs.features[0], tobs.frame[0])
    with torch.no_grad():
        q1 = critic(one, torch.from_numpy(b["actions"][0]))
        a1, _ = actor(one, deterministic=True)
    assert q1.shape == (2,) and a1.shape == (act_dim,)
    _assert_close(q1.numpy(), want_q[:, 0], "unbatched q")


# --------------------------------------------------------------- update


def test_one_fused_visual_update_matches_jax():
    """The fused pipeline's update: frames arrive decoded (and shifted),
    and the update consumes no augmentation draw."""
    name = "pixel"
    jsac, state, cfg, shape, act_dim = _jax_case(name)
    b = _batch(name, BATCH, seed=5, decoded=True)
    new, jm = jax.jit(jsac.update)(state, _jbatch(b))
    sac, ts = _port_state(name)
    _, eps_q, eps_pi = _noise(state.rng, act_dim)
    ts, tm = sac.update(ts, _tbatch(b), eps_q=eps_q, eps_pi=eps_pi)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4, err_msg=k)
    _assert_module_matches(ts.actor, new.actor_params, "actor ")
    _assert_module_matches(ts.critic, new.critic_params, "critic ")
    _assert_module_matches(ts.target_critic, new.target_critic_params, "target ")
    _assert_adam_matches(ts.pi_opt, ts.actor, new.pi_opt_state, "pi ")
    _assert_adam_matches(ts.q_opt, ts.critic, new.q_opt_state, "q ")
    np.testing.assert_allclose(float(ts.log_alpha.detach()), float(new.log_alpha), atol=1e-6, rtol=0)


def test_fused_visual_burst_matches_jax_with_its_draws():
    name = "pixel"
    jsac, state, cfg, shape, act_dim = _jax_case(name)
    (feat,), frame = shape.features, shape.frame
    capacity, prefill, n_chunk, k = 48, 30, 25, 2

    def chunk(n, seed):
        rng = np.random.default_rng(seed)
        return dict(states=_obs(n, feat, frame, seed), next_states=_obs(n, feat, frame, seed + 1),
                    actions=rng.uniform(-2, 2, (n, act_dim)).astype(np.float32),
                    rewards=rng.standard_normal(n).astype(np.float32),
                    done=(rng.uniform(size=n) < 0.2).astype(np.float32))

    jbuf = jreplay.push(jreplay.init_visual_replay_buffer(capacity, feat, frame, act_dim),
                        _jbatch(chunk(prefill, 6)))
    c = chunk(n_chunk, 8)  # wraps: 30 + 25 > 48
    burst = jax.jit(lambda s, buf, ch: j_run_update_burst(jsac.update, jsac.config, s, buf, ch, k))
    new, new_jbuf, jm = burst(state, jbuf, _jbatch(c))

    rng, size = state.rng, min(prefill + n_chunk, capacity)
    indices, eps, offsets = [], [], []
    for _ in range(k):
        rng, sample_key = jax.random.split(rng)
        k_idx, k_s, k_n = jax.random.split(sample_key, 3)
        offsets.append(np.stack([np.array(jax.random.randint(kk, (BATCH, 2), 0, 2 * PAD + 1))
                                 for kk in (k_s, k_n)]))
        indices.append(np.array(jax.random.randint(k_idx, (BATCH,), 0, size)))
        rng, eps_q, eps_pi = _noise(rng, act_dim)
        eps.append(torch.stack([eps_q, eps_pi]))

    sac, ts = _port_state(name)
    buf = replay.push(replay.init_visual_replay_buffer(capacity, feat, frame, act_dim, "cpu"),
                      _tbatch(chunk(prefill, 6)))
    before = dict(_kernels.launch_counts)
    ts, buf, tm = sac.update_burst(
        ts, buf, _tbatch(c), k, indices=torch.from_numpy(np.stack(indices)),
        eps=torch.stack(eps), offsets=torch.from_numpy(np.stack(offsets)),
    )
    assert dict(_kernels.launch_counts) == before  # CPU: the plain gather
    assert (buf.ptr, buf.size) == (int(new_jbuf.ptr), int(new_jbuf.size))
    for got, want in zip(buf.data.leaves(), jax.tree_util.tree_leaves(new_jbuf.data)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), atol=1e-5, rtol=1e-4, err_msg=key)
    assert ts.step == int(new.step) == k
    _assert_module_matches(ts.actor, new.actor_params, "actor ")
    _assert_module_matches(ts.critic, new.critic_params, "critic ")
    _assert_module_matches(ts.target_critic, new.target_critic_params, "target ")
    np.testing.assert_allclose(float(ts.log_alpha.detach()), float(new.log_alpha), atol=1e-6, rtol=0)


def test_reference_pipeline_shifts_frames_in_the_update():
    """``pixel_pipeline="reference"`` with a shift: the update draws the
    noise, then the offsets, and shifts the uint8 frames itself."""
    name = "pixel"
    _, _, cfg, shape, act_dim = _jax_case(name)
    cfg = cfg.replace(pixel_pipeline="reference")
    b = _tbatch(_batch(name, BATCH, seed=9))
    runs = []
    for _ in range(2):
        sac = SAC(cfg, act_dim)
        actor, critic = build_models(cfg, shape, act_dim, ACT_LIMIT)
        ts = sac.init_state(actor, critic, torch.Generator().manual_seed(3))
        ts, m = sac.update(ts, b)
        runs.append(m)
    assert all(math.isfinite(float(v)) for v in runs[0].values())
    assert float(runs[0]["loss_q"]) == float(runs[1]["loss_q"])  # seeded: reproducible


@pytest.mark.parametrize("visual", [False, True])
def test_replay_rings_default_to_the_card(monkeypatch, visual):
    """``device=None`` means the card, as for the port's other entry
    points: without one it raises; the CPU is asked for by name."""

    def init(**kw):
        if visual:
            return replay.init_visual_replay_buffer(8, 2, (4, 4, 3), 1, **kw)
        return replay.init_replay_buffer(8, (3,), 1, **kw)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init()
    buf = init(device="cpu")
    assert all(leaf.device.type == "cpu" for leaf in buf.data.leaves())
    assert buf.visual == visual and (buf.ptr, buf.size) == (0, 0)


# -------------------------------------------------------------- trainer


def test_visual_trainer_fills_a_uint8_ring_and_trains(tmp_path):
    cfg = SACConfig(**{**PIXEL_CONV, "filters": (8, 16), "cnn_dense_size": 32,
                       "cnn_features": 8}, hidden_sizes=(32, 32), frame_augment="shift",
                    learn_alpha=True, pixel_pipeline="fused", epochs=1, steps_per_epoch=120,
                    start_steps=50, update_after=50, update_every=20, buffer_size=200,
                    batch_size=16, save_every=1)
    ckpt = Checkpointer(tmp_path / "ckpt")
    trainer = Trainer("PixelPendulumBalanceNumpy-v0", cfg, checkpointer=ckpt, seed=1, device="cpu")
    try:
        metrics = trainer.train()
        ev = trainer.evaluate(episodes=1, seed=0)
    finally:
        trainer.close()
    frames = trainer.buffer.data.states.frame
    assert frames.dtype == torch.uint8 and frames.shape == (200, 32, 32, 3)
    assert trainer.buffer.size == 120 and int(frames[:120].max()) == 255
    assert trainer.state.step == 4 * 20  # windows ending at steps 59, 79, 99, 119
    assert all(math.isfinite(metrics[k]) for k in ("loss_q", "loss_pi", "reward"))
    assert ev["ep_len_mean"] == 200.0 and math.isfinite(ev["ep_ret_mean"])
    state, _ = ckpt.restore_actor_params()
    live = trainer.state.actor.state_dict()
    assert all(torch.equal(state[k], live[k]) for k in live)
