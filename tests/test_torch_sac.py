"""The port's critics, losses, replay ring and SAC update against the
JAX package's, on the CPU.

JAX models are initialised from a seed at a small size and their Flax
params (and, for the update, the whole JAX ``TrainState`` with its
optax Adam states) are carried into the port by ``weights.py``. The
batch is numpy from a seed; the actor noise the JAX update draws from
its keys (``rng, key_q, key_pi = split(rng, 3)``; ``normal(key,
(B, act_dim))``) and the replay rows its burst draws (``rng, k =
split(rng)``; ``randint(k, (B,), 0, size)``) are rebuilt from the same
keys and injected into the port. JAX runs its own attention on the CPU
(the XLA path).

Tolerances: forwards and losses 1e-5 (f32 summation order); updated
params and Adam moments atol 1e-5 / rtol 1e-4 (optax and torch.optim
order Adam's float ops differently). One exception, by construction:
an attention key bias shifts every score of a query row equally, so
softmax makes its gradient exactly zero in exact arithmetic; both sides
see rounding noise (|g| ~ 1e-9, the size of Adam's eps), and Adam turns
that noise into a step of either sign up to ``lr``. Those entries are
held to the only bound that holds — at most ``2 * lr`` apart per
update — and their effect on every output is zero. Replay push/sample
is exact.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_actor_critic_tpu.buffer import replay as jreplay
from torch_actor_critic_tpu.core.types import Batch as JBatch
from torch_actor_critic_tpu.sac import losses as jlosses
from torch_actor_critic_tpu.sac.algorithm import SAC as JSAC
from torch_actor_critic_tpu.sac.algorithm import run_update_burst as j_run_update_burst
from torch_actor_critic_tpu.sac.trainer import build_models as j_build_models
from torch_actor_critic_tpu.utils.config import SACConfig as JSACConfig
from torch_actor_critic_tpu_torch.buffer import replay
from torch_actor_critic_tpu_torch.core.types import Batch
from torch_actor_critic_tpu_torch.diagnostics import ingraph as diag_mod
from torch_actor_critic_tpu_torch.models import build_models
from torch_actor_critic_tpu_torch.ops.polyak import polyak_update_
from torch_actor_critic_tpu_torch.sac import losses
from torch_actor_critic_tpu_torch.sac.algorithm import SAC
from torch_actor_critic_tpu_torch.utils.config import SACConfig
from torch_actor_critic_tpu_torch.weights import (
    _adam_state,
    _named_arrays,
    load_jax_actor_params,
    load_jax_critic_params,
    train_state_from_jax,
)

T, OBS_DIM, ACT_DIM, ACT_LIMIT, BATCH = 8, 3, 2, 2.0, 16
LR = 3e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny ops: one intra-op thread avoids the oversubscription of
    several test workers each spinning a full thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CASES = {
    # name: (config overrides, obs shape)
    "seq-fixed": (dict(history_len=T, seq_d_model=32, seq_num_heads=2, seq_num_layers=2), (T, OBS_DIM)),
    "seq-learned": (dict(history_len=T, seq_d_model=32, seq_num_heads=2, seq_num_layers=1,
                         learn_alpha=True), (T, OBS_DIM)),
    "flat-fixed": (dict(hidden_sizes=(32, 32)), (OBS_DIM,)),
    "flat-learned": (dict(hidden_sizes=(32, 32), learn_alpha=True), (OBS_DIM,)),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(obs_shape, n=BATCH, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        states=rng.standard_normal((n, *obs_shape)).astype(np.float32),
        actions=rng.uniform(-ACT_LIMIT, ACT_LIMIT, (n, ACT_DIM)).astype(np.float32),
        rewards=rng.standard_normal(n).astype(np.float32),
        next_states=rng.standard_normal((n, *obs_shape)).astype(np.float32),
        done=(rng.uniform(size=n) < 0.25).astype(np.float32),
    )


def _tbatch(b):
    return Batch(**{k: torch.from_numpy(np.array(v)) for k, v in b.items()})


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """JAX learner, its initial TrainState (jitted init) and config."""
    overrides, obs_shape = CASES[name]
    jcfg = JSACConfig(batch_size=BATCH, **overrides)
    env = types.SimpleNamespace(
        obs_spec=jax.ShapeDtypeStruct(obs_shape, jnp.float32),
        act_dim=ACT_DIM, act_limit=ACT_LIMIT,
    )
    actor_def, critic_def = j_build_models(jcfg, env)
    jsac = JSAC(jcfg, actor_def, critic_def, ACT_DIM)
    state = jax.jit(jsac.init_state)(jax.random.PRNGKey(0), jnp.zeros(obs_shape))
    return jsac, state, SACConfig(batch_size=BATCH, **overrides), obs_shape


def _port_state(name, jax_state=None):
    jsac, state, cfg, obs_shape = _jax_case(name)
    sac = SAC(cfg, ACT_DIM)
    actor, critic = build_models(cfg, obs_shape, ACT_DIM, ACT_LIMIT)
    ts = train_state_from_jax(
        _np_tree(jax_state if jax_state is not None else state), sac, actor, critic,
        torch.Generator(),
    )
    return sac, ts


def _update_noise(rng_key):
    """(next rng, eps_q, eps_pi) exactly as ``SAC.update`` draws them."""
    rng, key_q, key_pi = jax.random.split(rng_key, 3)
    eps = [torch.from_numpy(np.array(jax.random.normal(k, (BATCH, ACT_DIM))))
           for k in (key_q, key_pi)]
    return rng, eps[0], eps[1]


def _assert_module_matches(module, tree, steps=1, what=""):
    want = _named_arrays(module, _np_tree(tree))
    for name, p in module.named_parameters():
        got = p.detach().numpy()
        if name.endswith("attn.k.bias"):
            # Zero gradient in exact arithmetic: see the module docstring.
            assert np.abs(got - want[name]).max() <= 2 * LR * steps, f"{what}{name}"
        else:
            np.testing.assert_allclose(got, want[name], atol=1e-5, rtol=1e-4,
                                       err_msg=f"{what}{name}")


def _assert_adam_matches(opt, module, jax_opt_state, what=""):
    adam = _adam_state(_np_tree(jax_opt_state))
    for moment, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
        want = _named_arrays(module, moment)
        for name, p in module.named_parameters():
            np.testing.assert_allclose(
                opt.state[p][key].numpy(), want[name], atol=1e-5, rtol=1e-4,
                err_msg=f"{what}{key} {name}",
            )
            assert float(opt.state[p]["step"]) == float(adam.count)


# ------------------------------------------------------------- critics


@pytest.mark.parametrize("name", ["seq-learned", "flat-fixed"])
def test_double_critic_forward_matches_jax(name):
    jsac, state, cfg, obs_shape = _jax_case(name)
    _, critic = build_models(cfg, obs_shape, ACT_DIM, ACT_LIMIT)
    load_jax_critic_params(critic, _np_tree(state.critic_params))
    b = _batch(obs_shape, n=5, seed=1)
    want = np.asarray(jax.jit(jsac.critic_def.apply)(state.critic_params, b["states"], b["actions"]))
    with torch.no_grad():
        got = critic(torch.from_numpy(b["states"]), torch.from_numpy(b["actions"]))
    assert got.shape == (2, 5) and want.shape == (2, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # The two ensemble members really are different networks.
    assert not np.allclose(got[0].numpy(), got[1].numpy())


def test_sequence_critic_unbatched_history():
    jsac, state, cfg, obs_shape = _jax_case("seq-learned")
    _, critic = build_models(cfg, obs_shape, ACT_DIM, ACT_LIMIT)
    load_jax_critic_params(critic, _np_tree(state.critic_params))
    b = _batch(obs_shape, n=1, seed=2)
    want = np.asarray(jax.jit(jsac.critic_def.apply)(
        state.critic_params, b["states"][0], b["actions"][0]))
    with torch.no_grad():
        got = critic(torch.from_numpy(b["states"][0]), torch.from_numpy(b["actions"][0]))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# -------------------------------------------------------------- losses


@pytest.mark.parametrize("name", ["seq-learned", "flat-fixed"])
def test_losses_match_jax(name):
    jsac, state, cfg, obs_shape = _jax_case(name)
    sac, ts = _port_state(name)
    b = _batch(obs_shape, seed=3)
    key = jax.random.PRNGKey(7)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (BATCH, ACT_DIM))))
    jb = JBatch(**b)
    want_q, want_q_aux = jax.jit(functools.partial(
        jlosses.critic_loss, actor_apply=jsac._actor_apply,
        critic_apply=jsac._critic_apply, gamma=0.99, reward_scale=1.5,
    ))(
        state.critic_params, actor_params=state.actor_params,
        target_critic_params=state.target_critic_params, batch=jb, key=key,
        alpha=jnp.float32(0.2),
    )
    got_q, got_q_aux = losses.critic_loss(
        ts.critic, actor=ts.actor, target_critic=ts.target_critic, batch=_tbatch(b),
        alpha=0.2, gamma=0.99, reward_scale=1.5, eps=eps,
    )
    np.testing.assert_allclose(float(got_q.detach()), float(want_q), atol=1e-5, rtol=1e-5)
    for k in ("q_mean", "backup_mean"):
        np.testing.assert_allclose(float(got_q_aux[k]), float(want_q_aux[k]), atol=1e-5, rtol=1e-5)
    for parity in (False, True):
        want_pi, want_pi_aux = jax.jit(functools.partial(
            jlosses.actor_loss, actor_apply=jsac._actor_apply,
            critic_apply=jsac._critic_apply, parity_pi_obs=parity,
        ))(
            state.actor_params, critic_params=state.critic_params,
            batch=jb, key=key, alpha=jnp.float32(0.2),
        )
        got_pi, got_pi_aux = losses.actor_loss(
            ts.actor, critic=ts.critic, batch=_tbatch(b), alpha=0.2,
            parity_pi_obs=parity, eps=eps,
        )
        np.testing.assert_allclose(float(got_pi.detach()), float(want_pi), atol=1e-5, rtol=1e-5)
        for k in ("logp_pi", "entropy"):
            np.testing.assert_allclose(float(got_pi_aux[k]), float(want_pi_aux[k]), atol=1e-5, rtol=1e-5)
    la = np.float32(-1.3)
    want_a = jlosses.alpha_loss(jnp.asarray(la), jnp.float32(-0.7), -2.0)
    got_a = losses.alpha_loss(torch.tensor(la), torch.tensor(-0.7), -2.0)
    np.testing.assert_allclose(float(got_a), float(want_a), atol=1e-6, rtol=0)


def test_critic_loss_backup_carries_no_gradient():
    sac, ts = _port_state("flat-fixed")
    b = _tbatch(_batch((OBS_DIM,), seed=4))
    loss, _ = losses.critic_loss(
        ts.critic, actor=ts.actor, target_critic=ts.target_critic, batch=b,
        alpha=0.2, gamma=0.99, reward_scale=1.0, generator=torch.Generator().manual_seed(0),
    )
    grads = torch.autograd.grad(loss, list(ts.actor.parameters()), allow_unused=True)
    assert all(g is None for g in grads)


# -------------------------------------------------------------- update


@pytest.mark.parametrize("name", list(CASES))
def test_one_update_matches_jax(name):
    jsac, state, cfg, obs_shape = _jax_case(name)
    b = _batch(obs_shape, seed=5)
    new, jm = jax.jit(jsac.update)(state, JBatch(**b))
    sac, ts = _port_state(name)
    _, eps_q, eps_pi = _update_noise(state.rng)
    ts, tm = sac.update(ts, _tbatch(b), eps_q=eps_q, eps_pi=eps_pi)
    assert set(tm) == set(jm)
    for k in ("loss_q", "loss_pi", "q_mean", "backup_mean", "logp_pi", "alpha"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4, err_msg=k)
    assert ts.step == int(new.step) == 1
    _assert_module_matches(ts.actor, new.actor_params, what="actor ")
    _assert_module_matches(ts.critic, new.critic_params, what="critic ")
    _assert_module_matches(ts.target_critic, new.target_critic_params, what="target ")
    _assert_adam_matches(ts.pi_opt, ts.actor, new.pi_opt_state, "pi ")
    _assert_adam_matches(ts.q_opt, ts.critic, new.q_opt_state, "q ")
    np.testing.assert_allclose(float(ts.log_alpha.detach()), float(new.log_alpha), atol=1e-6, rtol=0)
    a_adam = _adam_state(_np_tree(new.alpha_opt_state))
    a_state = ts.alpha_opt.state.get(ts.log_alpha, {})
    if cfg.learn_alpha:
        np.testing.assert_allclose(float(a_state["exp_avg"]), float(a_adam.mu), atol=1e-6, rtol=1e-4)
        np.testing.assert_allclose(float(a_state["exp_avg_sq"]), float(a_adam.nu), atol=1e-8, rtol=1e-4)
    else:
        assert float(a_state["step"]) == float(a_adam.count) == 0


def test_burst_of_three_matches_jax_with_injected_indices_and_eps():
    name = "seq-learned"
    jsac, state, cfg, obs_shape = _jax_case(name)
    capacity, prefill = 64, 40
    spec = jax.ShapeDtypeStruct(obs_shape, jnp.float32)
    jbuf = jreplay.push(jreplay.init_replay_buffer(capacity, spec, ACT_DIM),
                        JBatch(**_batch(obs_shape, n=prefill, seed=6)))
    chunk = _batch(obs_shape, n=30, seed=8)  # wraps: 40 + 30 > 64
    burst = jax.jit(lambda s, buf, c: j_run_update_burst(jsac.update, jsac.config, s, buf, c, 3))
    new, new_jbuf, jm = burst(state, jbuf, JBatch(**chunk))

    rng, size = state.rng, min(prefill + 30, capacity)
    indices, eps = [], []
    for _ in range(3):
        rng, sample_key = jax.random.split(rng)
        indices.append(np.asarray(jax.random.randint(
            sample_key, (BATCH,), 0, jnp.maximum(jnp.int32(size), 1))))
        rng, eps_q, eps_pi = _update_noise(rng)
        eps.append(torch.stack([eps_q, eps_pi]))

    sac, ts = _port_state(name)
    buf = replay.push(replay.init_replay_buffer(capacity, obs_shape, ACT_DIM, "cpu"),
                      _tbatch(_batch(obs_shape, n=prefill, seed=6)))
    ts, buf, tm = sac.update_burst(
        ts, buf, _tbatch(chunk), 3,
        indices=torch.from_numpy(np.stack(indices)), eps=torch.stack(eps),
    )
    assert (buf.ptr, buf.size) == (int(new_jbuf.ptr), int(new_jbuf.size))
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4, err_msg=k)
    assert ts.step == int(new.step) == 3
    _assert_module_matches(ts.actor, new.actor_params, steps=3, what="actor ")
    _assert_module_matches(ts.critic, new.critic_params, steps=3, what="critic ")
    _assert_module_matches(ts.target_critic, new.target_critic_params, steps=3, what="target ")
    _assert_adam_matches(ts.q_opt, ts.critic, new.q_opt_state, "q ")
    np.testing.assert_allclose(float(ts.log_alpha.detach()), float(new.log_alpha), atol=1e-6, rtol=0)


def test_burst_metrics_reduce_by_suffix_on_device():
    from torch_actor_critic_tpu_torch.diagnostics.ingraph import reduce_burst_metrics, reduction_for

    stacked = {"loss_q": torch.tensor([1.0, 3.0]), "loss_q_max": torch.tensor([1.0, 3.0]),
               "x_min": torch.tensor([2.0, -1.0]), "n_sum": torch.tensor([2.0, 5.0])}
    out = reduce_burst_metrics(stacked)
    assert [float(out[k]) for k in stacked] == [2.0, 3.0, -1.0, 7.0]
    assert reduction_for("td_hist") == "sum"


def test_update_takes_no_gradient_into_the_critic_during_the_actor_step():
    sac, ts = _port_state("flat-fixed")
    critic_before = {n: p.detach().clone() for n, p in ts.critic.named_parameters()}
    ts.q_opt.step = lambda: None  # freeze the critic step: only the actor step moves
    ts, _ = sac.update(ts, _tbatch(_batch((OBS_DIM,), seed=9)),
                       eps_q=torch.zeros(BATCH, ACT_DIM), eps_pi=torch.zeros(BATCH, ACT_DIM))
    for n, p in ts.critic.named_parameters():
        assert torch.equal(p.detach(), critic_before[n]), n
        assert p.requires_grad


def test_diagnostics_tier_is_not_ported():
    """Every tier is ported now: the solo learner runs each of them
    (tests/test_torch_diagnostics.py), and so does a population's, one
    value per member (tests/test_torch_population_host.py); only an
    unknown tier is refused."""
    from torch_actor_critic_tpu_torch.sac.population import PopulationSAC, PopulationTD3

    for tier in ("off", "light", "full"):
        assert SAC(SACConfig(diagnostics=tier), ACT_DIM).config.diagnostics == tier
        pop = PopulationSAC(SACConfig(diagnostics=tier, population=2), ACT_DIM, 2)
        assert pop.config.diagnostics == tier and pop.members == 2
        assert pop.diag_norm is diag_mod.member_global_norm
        td3 = PopulationTD3(SACConfig(algorithm="td3", diagnostics=tier, population=2),
                            ACT_DIM, 2)
        assert td3.diag_update_ratio is diag_mod.member_update_ratio
    with pytest.raises(ValueError, match="diagnostics"):
        SACConfig(diagnostics="verbose")


# -------------------------------------------------------------- polyak


def test_polyak_matches_jax_operand_order():
    from torch_actor_critic_tpu.ops.polyak import polyak_update

    rng = np.random.default_rng(10)
    src = [rng.standard_normal((4, 3)).astype(np.float32), rng.standard_normal(5).astype(np.float32)]
    tgt = [rng.standard_normal((4, 3)).astype(np.float32), rng.standard_normal(5).astype(np.float32)]
    want = polyak_update([jnp.asarray(x) for x in src], [jnp.asarray(x) for x in tgt], 0.995)
    got = [torch.from_numpy(x.copy()) for x in tgt]
    polyak_update_([torch.from_numpy(x) for x in src], got, 0.995)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7, rtol=0)


# -------------------------------------------------------------- replay


def test_replay_push_wraparound_and_sample_are_exact():
    obs_shape, capacity = (T, OBS_DIM), 32
    spec = jax.ShapeDtypeStruct(obs_shape, jnp.float32)
    jbuf = jreplay.init_replay_buffer(capacity, spec, ACT_DIM)
    buf = replay.init_replay_buffer(capacity, obs_shape, ACT_DIM, "cpu")
    for i, n in enumerate((20, 20, 32, 7)):  # wraps twice; one full-ring chunk
        chunk = _batch(obs_shape, n=n, seed=20 + i)
        jbuf = jreplay.push(jbuf, JBatch(**chunk))
        buf = replay.push(buf, _tbatch(chunk))
        assert (buf.ptr, buf.size) == (int(jbuf.ptr), int(jbuf.size))
        for f in ("states", "actions", "rewards", "next_states", "done"):
            np.testing.assert_array_equal(getattr(buf.data, f).numpy(),
                                          np.asarray(getattr(jbuf.data, f)))
    key = jax.random.PRNGKey(3)
    want = jreplay.sample(jbuf, key, BATCH)
    idx = np.array(jax.random.randint(key, (BATCH,), 0, jnp.maximum(jbuf.size, 1)))
    got = replay.sample(buf, BATCH, indices=torch.from_numpy(idx))
    for f in ("states", "actions", "rewards", "next_states", "done"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    drawn = replay.sample(buf, BATCH, generator=torch.Generator().manual_seed(0))
    assert drawn.states.shape == (BATCH, T, OBS_DIM)


def test_replay_rejects_oversized_chunk_and_empty_sample():
    buf = replay.init_replay_buffer(4, (OBS_DIM,), ACT_DIM, "cpu")
    with pytest.raises(ValueError, match="empty"):
        replay.sample(buf, 2, generator=torch.Generator())
    with pytest.raises(ValueError, match="capacity"):
        replay.push(buf, _tbatch(_batch((OBS_DIM,), n=5)))
    with pytest.raises(ValueError, match="exactly one"):
        replay.sample(buf, 2)


# ------------------------------------------------- weights / state bridge


def test_train_state_from_jax_carries_every_field():
    jsac, state, cfg, obs_shape = _jax_case("flat-learned")
    sac, ts = _port_state("flat-learned")
    _assert_module_matches(ts.actor, state.actor_params)
    _assert_module_matches(ts.target_critic, state.target_critic_params)
    assert not any(p.requires_grad for p in ts.target_critic.parameters())
    assert float(ts.log_alpha.detach()) == pytest.approx(float(np.log(np.float32(0.2))))
    with pytest.raises(TypeError):
        load_jax_actor_params(ts.critic, _np_tree(state.actor_params))


# ------------------------------------------- HalfCheetah widths (PARITY.md:155-165)

HC_OBS, HC_ACT, HC_LIMIT, HC_BATCH, HC_CHAIN = 17, 6, 1.0, 64, 20


@functools.lru_cache(maxsize=None)
def _hc_case():
    """The JAX learner and its initial state at HalfCheetah-v5's widths
    and PARITY.md's reference configuration (``SACConfig``'s defaults:
    hidden 256-256, batch 64, alpha 0.2 fixed, gamma 0.99, polyak 0.995,
    lr 3e-4)."""
    jcfg = JSACConfig(batch_size=HC_BATCH)
    assert (jcfg.hidden_sizes, jcfg.alpha, jcfg.gamma, jcfg.polyak, jcfg.lr,
            jcfg.learn_alpha) == ((256, 256), 0.2, 0.99, 0.995, 3e-4, False)
    env = types.SimpleNamespace(obs_spec=jax.ShapeDtypeStruct((HC_OBS,), jnp.float32),
                                act_dim=HC_ACT, act_limit=HC_LIMIT)
    actor_def, critic_def = j_build_models(jcfg, env)
    jsac = JSAC(jcfg, actor_def, critic_def, HC_ACT)
    state = jax.jit(jsac.init_state)(jax.random.PRNGKey(0), jnp.zeros((HC_OBS,)))
    return jsac, state


def _hc_port(state):
    cfg = SACConfig(batch_size=HC_BATCH)
    sac = SAC(cfg, HC_ACT)
    actor, critic = build_models(cfg, (HC_OBS,), HC_ACT, HC_LIMIT)
    return sac, train_state_from_jax(_np_tree(state), sac, actor, critic, torch.Generator())


def _hc_batch(seed):
    rng = np.random.default_rng(seed)
    return dict(
        states=rng.standard_normal((HC_BATCH, HC_OBS)).astype(np.float32),
        actions=rng.uniform(-HC_LIMIT, HC_LIMIT, (HC_BATCH, HC_ACT)).astype(np.float32),
        rewards=rng.standard_normal(HC_BATCH).astype(np.float32),
        next_states=rng.standard_normal((HC_BATCH, HC_OBS)).astype(np.float32),
        done=(rng.uniform(size=HC_BATCH) < 0.05).astype(np.float32),
    )


def _hc_noise(rng_key):
    rng, key_q, key_pi = jax.random.split(rng_key, 3)
    eps = [torch.from_numpy(np.array(jax.random.normal(k, (HC_BATCH, HC_ACT))))
           for k in (key_q, key_pi)]
    return key_q, key_pi, eps[0], eps[1]


def test_one_update_at_halfcheetah_widths_matches_jax():
    """One update at obs 17, act 6, hidden 256-256, batch 64 with JAX's
    weights and normals: the losses, every gradient (the critic's at the
    initial parameters, the actor's on the updated critic, as both
    updates take them), every parameter and Adam moment after the step,
    to 1e-5 / 1e-4."""
    jsac, state = _hc_case()
    b = _hc_batch(100)
    key_q, key_pi, eps_q, eps_pi = _hc_noise(state.rng)
    new, jm = jax.jit(jsac.update)(state, JBatch(**b))
    kw = dict(actor_apply=jsac._actor_apply, critic_apply=jsac._critic_apply,
              batch=JBatch(**b), alpha=jnp.float32(0.2))
    (_, _), q_grads = jax.value_and_grad(jlosses.critic_loss, has_aux=True)(
        state.critic_params, actor_params=state.actor_params,
        target_critic_params=state.target_critic_params, key=key_q, gamma=0.99,
        reward_scale=1.0, **kw)
    (_, _), pi_grads = jax.value_and_grad(jlosses.actor_loss, has_aux=True)(
        state.actor_params, critic_params=new.critic_params, key=key_pi, **kw)
    sac, ts = _hc_port(state)
    ts, tm = sac.update(ts, _tbatch(b), eps_q=eps_q, eps_pi=eps_pi)
    for k in ("loss_q", "loss_pi", "q_mean", "backup_mean", "logp_pi"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4, err_msg=k)
    for module, grads, what in ((ts.critic, q_grads, "critic"), (ts.actor, pi_grads, "actor")):
        want = _named_arrays(module, _np_tree(grads))
        for name, p in module.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[name], atol=1e-5, rtol=1e-4,
                                       err_msg=f"{what} grad {name}")
    _assert_module_matches(ts.actor, new.actor_params, what="actor ")
    _assert_module_matches(ts.critic, new.critic_params, what="critic ")
    _assert_module_matches(ts.target_critic, new.target_critic_params, what="target ")
    _assert_adam_matches(ts.pi_opt, ts.actor, new.pi_opt_state, "pi ")
    _assert_adam_matches(ts.q_opt, ts.critic, new.q_opt_state, "q ")


def test_chain_of_updates_at_halfcheetah_widths_matches_jax():
    """HC_CHAIN updates on as many seeded batches, JAX's normals injected
    at each. Every update's losses agree to 1e-5 / 1e-4, as one update's
    do. The parameters are held by the change the chain made to each
    tensor: ``||Δ_port - Δ_jax|| / ||Δ_jax|| <= 1e-3`` for every tensor
    of the actor, the critics and the target critics. Elementwise 1e-5 /
    1e-4 does not hold after the second update, for a reason a fault
    would not explain: a critic unit whose pre-activation sits at ReLU's
    kink on a batch row passes that row's gradient on one side and not
    the other (f32 rounding of the same sum in another order), and Adam
    turns the different gradient into a different step for that unit's
    weights alone. At these seeds that is unit 49 of head 1: its tensors
    reach 6.9e-4 of their change (7.0e-5 absolute) after 20 updates,
    every other tensor 1.1e-5. A fault in the losses, the step order or
    the polyak update moves every tensor's change by far more than 1e-3
    of itself."""
    jsac, state = _hc_case()
    sac, ts = _hc_port(state)
    start = {name: _named_arrays(module, _np_tree(tree)) for name, module, tree in (
        ("actor", ts.actor, state.actor_params), ("critic", ts.critic, state.critic_params),
        ("target", ts.target_critic, state.target_critic_params))}
    update = jax.jit(jsac.update)
    jstate = state
    for i in range(HC_CHAIN):
        b = _hc_batch(100 + i)
        _, _, eps_q, eps_pi = _hc_noise(jstate.rng)
        jstate, jm = update(jstate, JBatch(**b))
        ts, tm = sac.update(ts, _tbatch(b), eps_q=eps_q, eps_pi=eps_pi)
        for k in ("loss_q", "loss_pi"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4,
                                       err_msg=f"update {i} {k}")
    assert ts.step == int(jstate.step) == HC_CHAIN
    for name, module, tree in (("actor", ts.actor, jstate.actor_params),
                               ("critic", ts.critic, jstate.critic_params),
                               ("target", ts.target_critic, jstate.target_critic_params)):
        want = _named_arrays(module, _np_tree(tree))
        for pname, p in module.named_parameters():
            moved_jax = want[pname] - start[name][pname]
            moved_port = p.detach().numpy() - start[name][pname]
            rel = np.linalg.norm(moved_port - moved_jax) / np.linalg.norm(moved_jax)
            assert rel <= 1e-3, f"{name} {pname}: change off by {rel:.3g} of itself"
