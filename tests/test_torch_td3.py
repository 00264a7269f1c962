"""The port's TD3 against the JAX package's, on the CPU, and TD3 through
the port's trainer, checkpoint and CLIs.

JAX models are initialised from a seed at a small size; their Flax
params, or a whole JAX TD3 ``TrainState`` (the target actor and the
optax Adam states included), are carried into the port by
``weights.py``. Batches are numpy from a seed. The noise JAX draws from
its keys is rebuilt from the same keys and injected into the port: the
exploration noise ``normal(key, action.shape)``, the update's smoothing
noise (``rng, key_q = split(rng)``; ``normal(key_q, (B, act_dim))``),
and a burst's replay rows and DrQ shifts (``rng, k = split(rng)``).
The fused visual pipeline runs its plain K1 version here.

Tolerances, as ``test_torch_sac.py``'s: forwards and losses 1e-5;
updated params and Adam moments atol 1e-5 / rtol 1e-4. The policy
delay's select is held exactly: on a skipped update the actor, every
``pi_opt`` state tensor and both targets are bitwise what they were.
"""

import functools
import json
import subprocess
import sys
import types
import urllib.request as urlreq
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_actor_critic_tpu.buffer import replay as jreplay
from torch_actor_critic_tpu.core.types import Batch as JBatch
from torch_actor_critic_tpu.core.types import MultiObservation as JMultiObservation
from torch_actor_critic_tpu.sac.algorithm import run_update_burst as j_run_update_burst
from torch_actor_critic_tpu.sac.trainer import build_models as j_build_models
from torch_actor_critic_tpu.sac.trainer import make_learner as j_make_learner
from torch_actor_critic_tpu.td3 import losses as jlosses
from torch_actor_critic_tpu.utils.config import SACConfig as JSACConfig
from torch_actor_critic_tpu_torch import run_agent
from torch_actor_critic_tpu_torch import train as train_mod
from torch_actor_critic_tpu_torch.buffer import replay
from torch_actor_critic_tpu_torch.core.types import Batch, MultiObservation
from torch_actor_critic_tpu_torch.envs.vec_env import make_env_pool
from torch_actor_critic_tpu_torch.models import (
    DeterministicActor,
    DeterministicVisualActor,
    build_actor,
    build_models,
)
from torch_actor_critic_tpu_torch.ops import _kernels
from torch_actor_critic_tpu_torch.sac.trainer import Trainer, make_learner
from torch_actor_critic_tpu_torch.td3 import TD3, losses
from torch_actor_critic_tpu_torch.td3.algorithm import ADAM_STATE
from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer
from torch_actor_critic_tpu_torch.utils.config import SACConfig
from torch_actor_critic_tpu_torch.weights import (
    _adam_state,
    _named_arrays,
    load_jax_actor_params,
    train_state_from_jax,
)

OBS_DIM, ACT_DIM, ACT_LIMIT, BATCH, PAD = 3, 2, 2.0, 16, 4
REPO = Path(__file__).resolve().parents[1]

PIXEL = dict(filters=(16, 32), kernel_sizes=(4, 3), strides=(2, 2), cnn_dense_size=128,
             cnn_features=64, normalize_pixels=True, frame_augment="shift",
             pixel_pipeline="fused")
CASES = {
    # name: (config overrides, obs shape: (obs_dim,) or (features, frame))
    "flat": (dict(hidden_sizes=(32, 32)), (OBS_DIM,)),
    "flat-d1": (dict(hidden_sizes=(32, 32), policy_delay=1), (OBS_DIM,)),
    "flat-d3": (dict(hidden_sizes=(32, 32), policy_delay=3), (OBS_DIM,)),
    # the DDPG corner (JAX tests/test_td3.py::test_ddpg_degenerate_config)
    "ddpg": (dict(hidden_sizes=(32, 32), policy_delay=1, target_noise=0.0, num_qs=1),
             (OBS_DIM,)),
    # the pixel recipe's conv widths on PixelPendulum's 32x32x3 frames
    "visual": (dict(PIXEL, hidden_sizes=(32, 32)), (1, (32, 32, 3))),
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


def _visual(name):
    return name == "visual"


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """JAX TD3 learner, its initial TrainState and jitted update, and the
    port's config and observation spec."""
    overrides, shape = CASES[name]
    jcfg = JSACConfig(algorithm="td3", batch_size=BATCH, **overrides)
    if _visual(name):
        feat, frame = shape
        spec = JMultiObservation(features=jax.ShapeDtypeStruct((feat,), jnp.float32),
                                 frame=jax.ShapeDtypeStruct(frame, jnp.uint8))
        example = JMultiObservation(features=jnp.zeros((feat,)),
                                    frame=jnp.zeros(frame, jnp.uint8))
        port_shape = MultiObservation(features=(feat,), frame=frame)
        act_dim = 1
    else:
        spec = jax.ShapeDtypeStruct(shape, jnp.float32)
        example, port_shape, act_dim = jnp.zeros(shape), shape, ACT_DIM
    env = types.SimpleNamespace(obs_spec=spec, act_dim=act_dim, act_limit=ACT_LIMIT)
    actor_def, critic_def = j_build_models(jcfg, env)
    jtd3 = j_make_learner(jcfg, actor_def, critic_def, act_dim)
    state = jax.jit(jtd3.init_state)(jax.random.PRNGKey(0), example)
    cfg = SACConfig(algorithm="td3", batch_size=BATCH, **overrides)
    return jtd3, state, jax.jit(jtd3.update), cfg, port_shape, act_dim


def _port_state(name, jax_state=None):
    _, state, _, cfg, shape, act_dim = _jax_case(name)
    td3 = TD3(cfg, act_dim)
    actor, critic = build_models(cfg, shape, act_dim, ACT_LIMIT)
    ts = train_state_from_jax(_np_tree(jax_state if jax_state is not None else state),
                              td3, actor, critic, torch.Generator())
    return td3, ts


def _obs(name, n, seed, decoded=False):
    rng = np.random.default_rng(seed)
    shape = CASES[name][1]
    if not _visual(name):
        return rng.standard_normal((n, *shape)).astype(np.float32)
    feat, frame = shape
    f = rng.integers(0, 256, (n, *frame), dtype=np.uint8)
    return dict(features=rng.standard_normal((n, feat)).astype(np.float32),
                frame=(f.astype(np.float32) / np.float32(255)) if decoded else f)


def _batch(name, n=BATCH, seed=0, decoded=False):
    act_dim = _jax_case(name)[5]
    rng = np.random.default_rng(seed + 1000)
    return dict(states=_obs(name, n, seed, decoded),
                actions=rng.uniform(-ACT_LIMIT, ACT_LIMIT, (n, act_dim)).astype(np.float32),
                rewards=rng.standard_normal(n).astype(np.float32),
                next_states=_obs(name, n, seed + 1, decoded),
                done=(rng.uniform(size=n) < 0.25).astype(np.float32))


def _jobs(o):
    return JMultiObservation(**o) if isinstance(o, dict) else o


def _tobs(o):
    if isinstance(o, dict):
        return MultiObservation(torch.from_numpy(np.array(o["features"])),
                                torch.from_numpy(np.array(o["frame"])))
    return torch.from_numpy(np.array(o))


def _jbatch(b):
    return JBatch(states=_jobs(b["states"]), actions=b["actions"], rewards=b["rewards"],
                  next_states=_jobs(b["next_states"]), done=b["done"])


def _tbatch(b):
    return Batch(states=_tobs(b["states"]), actions=torch.from_numpy(b["actions"]),
                 rewards=torch.from_numpy(b["rewards"]), next_states=_tobs(b["next_states"]),
                 done=torch.from_numpy(b["done"]))


def _smoothing_noise(rng_key, act_dim):
    """(next rng, eps_q) exactly as ``TD3.update`` draws them."""
    rng, key_q = jax.random.split(rng_key)
    return rng, torch.from_numpy(np.array(jax.random.normal(key_q, (BATCH, act_dim))))


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
            assert float(opt.state[p]["step"]) == float(adam.count), what


def _assert_state_matches(ts, new, what=""):
    _assert_module_matches(ts.actor, new.actor_params, f"{what}actor ")
    _assert_module_matches(ts.critic, new.critic_params, f"{what}critic ")
    _assert_module_matches(ts.target_actor, new.target_actor_params, f"{what}target actor ")
    _assert_module_matches(ts.target_critic, new.target_critic_params, f"{what}target ")
    _assert_adam_matches(ts.pi_opt, ts.actor, new.pi_opt_state, f"{what}pi ")
    _assert_adam_matches(ts.q_opt, ts.critic, new.q_opt_state, f"{what}q ")
    assert ts.step == int(ts.device_step) == int(new.step)


def _policy_tensors(ts) -> dict:
    """What a skipped update must leave bitwise: the actor, ``pi_opt``'s
    state and both targets."""
    out = {f"actor.{n}": p for n, p in ts.actor.named_parameters()}
    out.update({f"target_actor.{n}": p for n, p in ts.target_actor.named_parameters()})
    out.update({f"target_critic.{n}": p for n, p in ts.target_critic.named_parameters()})
    for i, p in enumerate(ts.actor.parameters()):
        out.update({f"pi_opt.{i}.{k}": ts.pi_opt.state[p][k] for k in ADAM_STATE})
    return {k: v.detach().clone() for k, v in out.items()}


# -------------------------------------------------------------- models


@pytest.mark.parametrize("name", ["flat", "visual"])
def test_deterministic_actor_forward_matches_jax(name):
    """Deterministic, and with JAX's exploration noise injected; the
    visual actor also unbatched. The noise is clipped to the box."""
    jtd3, state, _, cfg, shape, act_dim = _jax_case(name)
    actor = build_actor(cfg, shape, act_dim, ACT_LIMIT)
    assert isinstance(actor, DeterministicVisualActor if _visual(name) else DeterministicActor)
    load_jax_actor_params(actor, _np_tree(state.actor_params))
    obs = _obs(name, 5, seed=1)
    key = jax.random.PRNGKey(3)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (5, act_dim))))
    want_det, logp = jax.jit(functools.partial(jtd3.actor_def.apply, deterministic=True))(
        state.actor_params, _jobs(obs))
    want_noisy, _ = jax.jit(jtd3.actor_def.apply)(state.actor_params, _jobs(obs), key)
    with torch.no_grad():
        got_det, got_logp = actor(_tobs(obs), deterministic=True)
        got_noisy, _ = actor(_tobs(obs), eps=eps)
    assert logp is None and got_logp is None
    np.testing.assert_allclose(got_det.numpy(), np.asarray(want_det), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_noisy.numpy(), np.asarray(want_noisy), atol=1e-5, rtol=0)
    assert not np.allclose(got_noisy.numpy(), got_det.numpy())
    assert float(got_noisy.abs().max()) <= ACT_LIMIT
    with pytest.raises(ValueError, match="exactly one"):
        actor(_tobs(obs))
    if _visual(name):
        one = {k: v[0] for k, v in obs.items()}
        want1, _ = jax.jit(jtd3.actor_def.apply)(state.actor_params, _jobs(one), key)
        eps1 = torch.from_numpy(np.array(jax.random.normal(key, (1, act_dim))))[0]
        with torch.no_grad():
            got1, _ = actor(_tobs(one), eps=eps1)
        assert got1.shape == (act_dim,)
        np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=1e-5, rtol=0)


# -------------------------------------------------------------- losses


@pytest.mark.parametrize("target_noise,noise_clip", [
    (0.2, 0.5),  # SACConfig's defaults
    (0.5, 0.1),  # most smoothing noise clipped
    (0.5, 0.0),  # all of it clipped away
])
def test_losses_match_jax(target_noise, noise_clip):
    jtd3, state, _, cfg, shape, _ = _jax_case("flat")
    _, ts = _port_state("flat")
    b = _batch("flat", seed=3)
    key = jax.random.PRNGKey(7)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (BATCH, ACT_DIM))))
    kw = dict(act_limit=ACT_LIMIT, gamma=0.99, reward_scale=1.5)
    want_q, want_aux = jax.jit(functools.partial(
        jlosses.critic_loss, actor_apply=jtd3._actor_apply, critic_apply=jtd3._critic_apply,
        target_noise=target_noise, noise_clip=noise_clip, **kw,
    ))(state.critic_params, target_actor_params=state.target_actor_params,
       target_critic_params=state.target_critic_params, batch=_jbatch(b), key=key)
    got_q, got_aux = losses.critic_loss(
        ts.critic, target_actor=ts.target_actor, target_critic=ts.target_critic,
        batch=_tbatch(b), target_noise=target_noise, noise_clip=noise_clip, eps=eps, **kw)
    np.testing.assert_allclose(float(got_q.detach()), float(want_q), atol=1e-5, rtol=1e-5)
    for k in ("q_mean", "backup_mean"):
        np.testing.assert_allclose(float(got_aux[k]), float(want_aux[k]), atol=1e-5, rtol=1e-5)
    if noise_clip == 0.0:  # the clip removes the noise exactly
        noiseless, _ = losses.critic_loss(
            ts.critic, target_actor=ts.target_actor, target_critic=ts.target_critic,
            batch=_tbatch(b), target_noise=0.0, noise_clip=0.5, eps=eps, **kw)
        assert float(noiseless.detach()) == float(got_q.detach())
    # The backup carries no gradient, even into targets that asked for one.
    targets = list(ts.target_actor.parameters()) + list(ts.target_critic.parameters())
    for p in targets:
        p.requires_grad_(True)
    loss, _ = losses.critic_loss(
        ts.critic, target_actor=ts.target_actor, target_critic=ts.target_critic,
        batch=_tbatch(b), target_noise=target_noise, noise_clip=noise_clip, eps=eps, **kw)
    assert all(g is None for g in torch.autograd.grad(loss, targets, allow_unused=True))

    want_pi, want_pi_aux = jax.jit(functools.partial(
        jlosses.actor_loss, actor_apply=jtd3._actor_apply, critic_apply=jtd3._critic_apply,
    ))(state.actor_params, critic_params=state.critic_params, batch=_jbatch(b))
    got_pi, got_pi_aux = losses.actor_loss(ts.actor, critic=ts.critic, batch=_tbatch(b))
    np.testing.assert_allclose(float(got_pi.detach()), float(want_pi), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(got_pi_aux["q_pi_mean"]), float(want_pi_aux["q_pi_mean"]),
                               atol=1e-5, rtol=1e-5)


def test_losses_over_a_member_axis_are_each_members_own():
    """The losses over member-stacked models (a population's ``(P, num_qs,
    B)`` critic): ``(P,)`` losses and metrics, member ``i``'s computed with
    its own ``target_noise`` exactly as with that value given to all; a
    0-d ``target_noise`` tensor gives the float's loss."""
    from torch_actor_critic_tpu_torch.models.population import build_population_models

    p = 3
    cfg = SACConfig(algorithm="td3", hidden_sizes=(32, 32), population=p)
    actor, critic = build_population_models(
        cfg, (OBS_DIM,), ACT_DIM, ACT_LIMIT, [torch.Generator().manual_seed(i) for i in range(p)])
    target_actor, target_critic = build_population_models(
        cfg, (OBS_DIM,), ACT_DIM, ACT_LIMIT,
        [torch.Generator().manual_seed(10 + i) for i in range(p)])
    rng = np.random.default_rng(11)

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    batch = Batch(f32(p, BATCH, OBS_DIM), f32(p, BATCH, ACT_DIM).clamp(-ACT_LIMIT, ACT_LIMIT),
                  f32(p, BATCH), f32(p, BATCH, OBS_DIM),
                  torch.from_numpy((rng.random((p, BATCH)) < 0.2).astype(np.float32)))
    eps = f32(p, BATCH, ACT_DIM)
    kw = dict(target_actor=target_actor, target_critic=target_critic, batch=batch,
              act_limit=ACT_LIMIT, noise_clip=0.5, gamma=0.99, reward_scale=1.5, eps=eps)
    noise = torch.tensor([0.0, 0.2, 0.7])
    loss, aux = losses.critic_loss(critic, target_noise=noise, **kw)
    assert loss.shape == aux["q_mean"].shape == aux["backup_mean"].shape == (p,)
    for i in range(p):
        each, each_aux = losses.critic_loss(critic, target_noise=float(noise[i]), **kw)
        assert torch.equal(loss[i], each[i])
        assert torch.equal(aux["backup_mean"][i], each_aux["backup_mean"][i])
    same, _ = losses.critic_loss(critic, target_noise=torch.tensor(0.2), **kw)
    assert torch.equal(same, losses.critic_loss(critic, target_noise=0.2, **kw)[0])
    loss_pi, aux_pi = losses.actor_loss(actor, critic=critic, batch=batch)
    pi, _ = actor(batch.states, deterministic=True, with_logprob=False)
    want = -critic(batch.states, pi)[:, 0].mean(dim=-1)
    assert loss_pi.shape == aux_pi["q_pi_mean"].shape == (p,)
    assert torch.equal(loss_pi, want)


# -------------------------------------------------------------- update


@pytest.mark.parametrize("name", ["flat", "flat-d1"])
def test_one_update_matches_jax(name):
    """``flat``: step 0 of delay 2 skips the policy; ``flat-d1`` applies
    it (the DDPG corner's test below takes two updates)."""
    _, state, jupdate, cfg, shape, act_dim = _jax_case(name)
    b = _batch(name, seed=5)
    new, jm = jupdate(state, _jbatch(b))
    td3, ts = _port_state(name)
    before = _policy_tensors(ts)
    _, eps_q = _smoothing_noise(state.rng, act_dim)
    ts, tm = td3.update(ts, _tbatch(b), eps_q=eps_q)
    assert set(tm) == set(jm) == {"loss_q", "loss_pi", "q_mean", "backup_mean", "q_pi_mean"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4, err_msg=k)
    _assert_state_matches(ts, new)
    after = _policy_tensors(ts)
    skipped = [k for k in before if torch.equal(before[k], after[k])]
    if cfg.policy_delay == 2:
        assert skipped == list(before)
    else:
        assert not any(k.startswith("actor.") for k in skipped)


def test_policy_delay_cadence_over_six_updates():
    """JAX tests/test_td3.py::test_policy_delay_cadence with delay 3: the
    critic moves every update; the actor, ``pi_opt`` (its ``step`` i //
    3) and both targets only on every third, and are bitwise unchanged
    on the others. Every update's state is held to JAX's."""
    name = "flat-d3"
    _, jstate, jupdate, cfg, shape, act_dim = _jax_case(name)
    td3, ts = _port_state(name)
    for i in range(1, 7):
        b = _batch(name, seed=100 + i)
        _, eps_q = _smoothing_noise(jstate.rng, act_dim)
        jstate, _ = jupdate(jstate, _jbatch(b))
        before = _policy_tensors(ts)
        critic_before = [p.detach().clone() for p in ts.critic.parameters()]
        ts, _ = td3.update(ts, _tbatch(b), eps_q=eps_q)
        after = _policy_tensors(ts)
        applied = i % 3 == 0
        for k in before:
            assert torch.equal(before[k], after[k]) != applied, (i, k)
        assert all(not torch.equal(a, p.detach())
                   for a, p in zip(critic_before, ts.critic.parameters()))
        steps = {float(st["step"]) for st in ts.pi_opt.state.values()}
        assert steps == {float(i // 3)} == {float(_adam_state(jstate.pi_opt_state).count)}
        _assert_state_matches(ts, jstate, f"update {i}: ")


def test_ddpg_corner_matches_jax_over_two_updates():
    """policy_delay 1, target_noise 0, num_qs 1 (JAX
    tests/test_td3.py::test_ddpg_degenerate_config): the actor moves on
    every update, the backup is the one head's plain Q."""
    name = "ddpg"
    _, jstate, jupdate, _, _, act_dim = _jax_case(name)
    td3, ts = _port_state(name)
    assert next(ts.critic.parameters()).shape[0] == 1
    for i in range(2):
        b = _batch(name, seed=200 + i)
        _, eps_q = _smoothing_noise(jstate.rng, act_dim)
        jstate, jm = jupdate(jstate, _jbatch(b))
        actor_before = [p.detach().clone() for p in ts.actor.parameters()]
        ts, tm = td3.update(ts, _tbatch(b), eps_q=eps_q)
        assert all(not torch.equal(a, p.detach())
                   for a, p in zip(actor_before, ts.actor.parameters()))
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4)
    _assert_state_matches(ts, jstate)


def test_burst_of_three_matches_jax_with_injected_indices_and_eps():
    """The shared eager burst with TD3's noise hook (``eps`` ``(K, B,
    act_dim)``), over a wrapping push; three updates of delay 2 start and
    end on skipped steps."""
    name = "flat"
    jtd3, state, _, cfg, shape, act_dim = _jax_case(name)
    capacity, prefill = 64, 40
    spec = jax.ShapeDtypeStruct(shape, jnp.float32)
    jbuf = jreplay.push(jreplay.init_replay_buffer(capacity, spec, act_dim),
                        _jbatch(_batch(name, n=prefill, seed=6)))
    chunk = _batch(name, n=30, seed=8)  # wraps: 40 + 30 > 64
    burst = jax.jit(lambda s, buf, c: j_run_update_burst(jtd3.update, jtd3.config, s, buf, c, 3))
    new, new_jbuf, jm = burst(state, jbuf, _jbatch(chunk))

    rng, size = state.rng, min(prefill + 30, capacity)
    indices, eps = [], []
    for _ in range(3):
        rng, sample_key = jax.random.split(rng)
        indices.append(np.asarray(jax.random.randint(sample_key, (BATCH,), 0, size)))
        rng, eps_q = _smoothing_noise(rng, act_dim)
        eps.append(eps_q)

    td3, ts = _port_state(name)
    buf = replay.push(replay.init_replay_buffer(capacity, shape, act_dim, "cpu"),
                      _tbatch(_batch(name, n=prefill, seed=6)))
    ts, buf, tm = td3.update_burst(ts, buf, _tbatch(chunk), 3,
                                   indices=torch.from_numpy(np.stack(indices)),
                                   eps=torch.stack(eps))
    assert (buf.ptr, buf.size) == (int(new_jbuf.ptr), int(new_jbuf.size))
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4, err_msg=k)
    _assert_state_matches(ts, new)


def test_fused_visual_burst_matches_jax_with_its_draws():
    """Two fused visual updates (the second applies the policy): frames
    through the plain K1 on the CPU at JAX's rows and shifts."""
    name = "visual"
    jtd3, state, _, cfg, shape, act_dim = _jax_case(name)
    (feat,), frame = shape.features, shape.frame
    capacity, prefill, n_chunk, k = 48, 30, 25, 2
    jbuf = jreplay.push(jreplay.init_visual_replay_buffer(capacity, feat, frame, act_dim),
                        _jbatch(_batch(name, n=prefill, seed=6)))
    c = _batch(name, n=n_chunk, seed=8)  # wraps: 30 + 25 > 48
    burst = jax.jit(lambda s, buf, ch: j_run_update_burst(jtd3.update, jtd3.config, s, buf, ch, k))
    new, new_jbuf, jm = burst(state, jbuf, _jbatch(c))

    rng, size = state.rng, min(prefill + n_chunk, capacity)
    indices, eps, offsets = [], [], []
    for _ in range(k):
        rng, sample_key = jax.random.split(rng)
        k_idx, k_s, k_n = jax.random.split(sample_key, 3)
        offsets.append(np.stack([np.array(jax.random.randint(kk, (BATCH, 2), 0, 2 * PAD + 1))
                                 for kk in (k_s, k_n)]))
        indices.append(np.array(jax.random.randint(k_idx, (BATCH,), 0, size)))
        rng, eps_q = _smoothing_noise(rng, act_dim)
        eps.append(eps_q)

    td3, ts = _port_state(name)
    buf = replay.push(replay.init_visual_replay_buffer(capacity, feat, frame, act_dim, "cpu"),
                      _tbatch(_batch(name, n=prefill, seed=6)))
    before = dict(_kernels.launch_counts)
    ts, buf, tm = td3.update_burst(
        ts, buf, _tbatch(c), k, indices=torch.from_numpy(np.stack(indices)),
        eps=torch.stack(eps), offsets=torch.from_numpy(np.stack(offsets)))
    assert dict(_kernels.launch_counts) == before  # CPU: the plain gather
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), atol=1e-5, rtol=1e-4,
                                   err_msg=key)
    _assert_state_matches(ts, new)


def test_sequence_stack_is_rejected():
    """The JAX trainer's gate: TD3 takes the flat and visual stacks."""
    with pytest.raises(ValueError, match="sequence"):
        build_models(SACConfig(algorithm="td3"), (8, OBS_DIM), ACT_DIM, ACT_LIMIT)
    with pytest.raises(ValueError, match="sequence"):
        Trainer("PendulumNumpy-v1", SACConfig(algorithm="td3", history_len=4), device="cpu")
    with pytest.raises(ValueError, match="SAC-only"):
        SACConfig(algorithm="td3", learn_alpha=True)


def test_train_state_from_jax_carries_every_td3_field():
    """After one applied JAX update the target actor differs from the
    actor; the port's state carries both, the steps, the inert
    temperature slots and ``pi_opt``'s count."""
    name = "flat-d1"
    _, state, jupdate, cfg, _, _ = _jax_case(name)
    new, _ = jupdate(state, _jbatch(_batch(name, seed=9)))
    td3, ts = _port_state(name, new)
    assert isinstance(make_learner(cfg, ACT_DIM), TD3)
    _assert_state_matches(ts, new)
    assert not all(torch.equal(a, b) for a, b in zip(ts.actor.parameters(),
                                                      ts.target_actor.parameters()))
    assert not any(p.requires_grad for p in ts.target_actor.parameters())
    assert float(ts.log_alpha) == float(new.log_alpha) == 0.0
    assert not ts.alpha_opt.state  # JAX's EmptyState
    assert ts.device_step.dtype == torch.int64 and int(ts.device_step) == 1
    with pytest.raises(ValueError, match="target actor"):
        from torch_actor_critic_tpu_torch.sac.algorithm import SAC

        train_state_from_jax(_np_tree(new), SAC(SACConfig(hidden_sizes=(32, 32)), ACT_DIM),
                             *build_models(SACConfig(hidden_sizes=(32, 32)), (OBS_DIM,),
                                           ACT_DIM, ACT_LIMIT), torch.Generator())


# ------------------------------------------------------ trainer and CLIs

TINY = dict(algorithm="td3", hidden_sizes=(16, 16), batch_size=16, steps_per_epoch=40,
            start_steps=10, update_after=10, update_every=10, buffer_size=500,
            max_ep_len=100, save_every=10, policy_delay=3)


def _trainer(ckpt_dir, epochs, **over):
    cfg = SACConfig(**{**TINY, "epochs": epochs, **over})
    return Trainer("PendulumNumpy-v1", cfg, checkpointer=Checkpointer(ckpt_dir),
                   seed=5, device="cpu")


def _full_state(tr) -> dict:
    return {"state": tr.state.state_dict(), "buffer": tr.buffer.state_dict(),
            "act": tr._act_gen.get_state()}


def _assert_bitwise(a, b, path=""):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_bitwise(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise(x, y, f"{path}/{i}")
    else:
        assert a == b, (path, a, b)


def test_td3_trainer_runs_and_resumes_bitwise(tmp_path):
    """Two tiny epochs (10-update bursts against a delay of 3, so bursts
    start mid-cycle) uninterrupted, against one epoch, a fresh trainer's
    ``restore()`` and one more: equal to the bit in every leaf, the
    target actor and the device step included."""
    whole = _trainer(tmp_path / "a", epochs=2)
    try:
        m = whole.train()
        ref = _full_state(whole)
    finally:
        whole.close()
    assert np.isfinite(m["loss_q"]) and np.isfinite(m["loss_pi"])
    assert isinstance(whole.state.actor, DeterministicActor)
    assert whole.state.step == int(whole.state.device_step) == 70  # 7 bursts of 10
    assert "target_actor" in ref["state"] and int(ref["state"]["device_step"]) == 70
    assert {float(s["step"]) for s in whole.state.pi_opt.state.values()} == {70.0 // 3}

    first = _trainer(tmp_path / "b", epochs=1)
    try:
        first.train()
    finally:
        first.close()
    resumed = _trainer(tmp_path / "b", epochs=1)
    try:
        assert resumed.restore() == 1 and int(resumed.state.device_step) == 30
        resumed.train()
        got = _full_state(resumed)
    finally:
        resumed.close()
    _assert_bitwise(ref, got)


def test_checkpoint_of_the_other_algorithm_raises(tmp_path):
    """A SAC checkpoint given to a TD3 trainer raises ``ValueError`` before
    any array is read, and the reverse; so does a learner snapshot of the
    other algorithm given to ``load_state_dict_`` directly."""
    sac_cfg = {k: v for k, v in TINY.items() if k not in ("algorithm", "policy_delay")}
    for writer, reader in ((dict(sac_cfg, algorithm="sac"), TINY),
                           (TINY, dict(sac_cfg, algorithm="sac"))):
        d = tmp_path / writer["algorithm"]
        tr = Trainer("PendulumNumpy-v1", SACConfig(**{**writer, "epochs": 1}),
                     checkpointer=Checkpointer(d), seed=5, device="cpu")
        tr.train()
        snapshot = tr.state.state_dict()
        tr.close()
        other = Trainer("PendulumNumpy-v1", SACConfig(**{**reader, "epochs": 1}),
                        checkpointer=Checkpointer(d), seed=5, device="cpu")
        try:
            with pytest.raises(ValueError, match=f"algorithm='{writer['algorithm']}'"):
                other.restore()
            with pytest.raises(ValueError, match="target actor"):
                other.state.load_state_dict_(snapshot)
        finally:
            other.close()


def _rollout_return(actor, seed, episodes=2, max_len=200):
    """Deterministic returns of ``actor`` on the numpy pendulum, episode
    ``i`` reset with ``seed + i`` (``Trainer.evaluate``'s loop)."""
    pool = make_env_pool("PendulumNumpy-v1", 1, base_seed=0)
    rets = []
    for i in range(episodes):
        obs, ret = pool.reset_at(0, seed=seed + i), 0.0
        for _ in range(max_len):
            with torch.no_grad():
                a, _ = actor(torch.from_numpy(np.asarray(obs, np.float32))[None],
                             deterministic=True)
            obs, r, term, trunc = pool.step_at(0, a[0].numpy())
            ret += r
            if term or trunc:
                break
        rets.append(ret)
    pool.close()
    return float(np.mean(rets))


def test_run_agent_and_serve_a_td3_run(tmp_path, capsys):
    """``train --algorithm td3`` then, from its checkpoint: ``run_agent
    --run`` returns what ``DeterministicActor``'s forward earns, and the
    serving CLI answers ``/act`` with that forward's actions."""
    train_mod.main(["--environment", "PendulumNumpy-v1", "--device", "cpu",
                    "--runs-root", str(tmp_path), "--algorithm", "td3", "--epochs", "1",
                    "--steps-per-epoch", "40", "--start-steps", "10", "--update-after", "10",
                    "--update-every", "10", "--batch-size", "16", "--buffer-size", "100",
                    "--hidden-sizes", "16,16", "--seed", "3"])
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ckpt = Path(final["checkpoint_dir"])
    cfg = SACConfig.from_json(Checkpointer(ckpt).peek_meta()["config"])
    actor = build_actor(cfg, (OBS_DIM,), 1, 2.0)
    assert isinstance(actor, DeterministicActor)
    actor.load_state_dict(torch.load(ckpt / "epoch_0" / "actor.pt", weights_only=True))

    run_agent.main(["--run", final["run"], "--runs-root", str(tmp_path), "--device", "cpu",
                    "--episodes", "2", "--seed", "11"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ep_ret_mean"] == _rollout_return(actor, seed=11)

    proc = subprocess.Popen(
        [sys.executable, "-m", "torch_actor_critic_tpu_torch.serve", "--ckpt-dir", str(ckpt),
         "--obs-dim", str(OBS_DIM), "--act-dim", "1", "--act-limit", "2.0", "--port", "0",
         "--max-batch", "4", "--poll-interval", "0", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready = json.loads(proc.stdout.readline())
        obs = np.random.default_rng(0).standard_normal((3, OBS_DIM)).astype(np.float32)
        req = urlreq.Request(ready["serving"] + "/act", data=json.dumps(
            {"obs": obs.tolist(), "deterministic": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urlreq.urlopen(req, timeout=30) as resp:
            served = np.asarray(json.loads(resp.read())["action"], np.float32)
        with torch.no_grad():
            want, _ = actor(torch.from_numpy(obs), deterministic=True)
        np.testing.assert_allclose(served, want.numpy(), atol=1e-6, rtol=0)
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        proc.stdout.close()
        proc.stderr.close()


@pytest.mark.slow
def test_td3_solves_pendulum_numpy():
    """Counterpart of tests/test_td3.py::test_td3_solves_pendulum on the
    port's numpy pendulum: the same config, deterministic eval over 10
    episodes above -400."""
    cfg = SACConfig(algorithm="td3", epochs=6, steps_per_epoch=2500, start_steps=1000,
                    update_after=1000, update_every=50, batch_size=64, max_ep_len=200)
    tr = Trainer("PendulumNumpy-v1", cfg, seed=0, device="cpu")
    try:
        tr.train()
        ev = tr.evaluate(episodes=10, deterministic=True, seed=0)
    finally:
        tr.close()
    assert ev["ep_ret_mean"] > -400, ev
