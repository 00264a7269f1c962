"""The port's fused population (``--on-device true --population N``)
against the JAX package's, on the CPU: the CheetahRun twin, the
hyperparameters, the member-stacked update, the PBT step, a population
epoch, the checkpoint and the CLI. The loop runs eagerly here; its
captured path is checked on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.

As in ``tests/test_torch_ondevice.py``, the port draws from one
generator where JAX splits a key per env or per member, so every test
that holds the port to JAX rebuilds JAX's draws from its keys and
injects them: the twins' reset poses, the acting noise, the replay rows
and update noise of each member (from that member's key), and the PBT
step's winner picks and explore signs. JAX's own stacked-vs-solo
population test is a known failure on this jax, so the port is held to
JAX's population, never bitwise to JAX's solo runs.

Tolerances: the cheetah twin teacher-forced from JAX's state each step,
state leaves 1e-5 absolute and relative (five stiff contact substeps
carry a 1-ulp difference of a transcendental to a few ulps), the reward
``4 ulp(|x|) / dt + 1e-5`` absolute (it is a difference of positions
over dt), step counts and ``ended`` exactly. The update and the epoch:
learner state atol 1e-5 / rtol 1e-4 (attention key biases 2·lr per
update, see ``tests/test_torch_sac.py``), ring rows 1e-5·max(1, |x|),
metrics atol 1e-5 / rtol 1e-4, cursors and episode counts exactly. The
functional Adam against ``torch.optim.Adam`` at the configured rate:
moments bitwise, parameters atol 1e-8 / rtol 1e-6, a few ulps (the rate
and bias corrections are f32 tensors in one and host doubles in the
other, which can round a parameter's step one ulp apart); over a burst,
where later gradients follow those parameters, moments atol 1e-8 /
rtol 1e-5. The
PBT step exactly; member independence and checkpoint resume bitwise.
"""

import functools
import json
import subprocess
import sys
import urllib.request as urlreq
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_actor_critic_tpu.diagnostics.ingraph import split_member_metrics as j_split
from torch_actor_critic_tpu.core.types import MultiObservation as JMultiObservation
from torch_actor_critic_tpu.envs.ondevice import CheetahRunJax, PendulumJax, PixelPendulumJax
from torch_actor_critic_tpu.envs.ondevice import EnvState as JEnvState
from torch_actor_critic_tpu.envs.ondevice import history_env as j_history_env
from torch_actor_critic_tpu.sac.ondevice import PBTState as JPBTState
from torch_actor_critic_tpu.sac.ondevice import PopulationOnDeviceLoop as JPopulationLoop
from torch_actor_critic_tpu.sac.ondevice import _SpecView as JSpecView
from torch_actor_critic_tpu.sac.trainer import build_models as j_build_models
from torch_actor_critic_tpu.sac.trainer import make_learner as j_make_learner
from torch_actor_critic_tpu.utils.config import SACConfig as JSACConfig
from torch_actor_critic_tpu_torch import run_agent
from torch_actor_critic_tpu_torch import train as train_mod
from torch_actor_critic_tpu_torch.buffer import replay
from torch_actor_critic_tpu_torch.core.types import Batch, MultiObservation, PBTState
from torch_actor_critic_tpu_torch.diagnostics.ingraph import split_member_metrics
from torch_actor_critic_tpu_torch.envs import ondevice as tenv
from torch_actor_critic_tpu_torch.envs.ondevice import (
    CheetahRunTorch,
    EnvState,
    PendulumTorch,
    PixelPendulumTorch,
    history_env,
)
from torch_actor_critic_tpu_torch.models import build_models
from torch_actor_critic_tpu_torch.models.population import build_population_models
from torch_actor_critic_tpu_torch.sac.algorithm import SAC, dynamic_lr_step
from torch_actor_critic_tpu_torch.sac.ondevice import (
    OnDeviceLoop,
    PopulationOnDeviceLoop,
    train_population_on_device,
)
from torch_actor_critic_tpu_torch.sac.population import PopulationSAC, make_population_learner
from torch_actor_critic_tpu_torch.sac.trainer import make_learner
from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer, export_member_checkpoint
from torch_actor_critic_tpu_torch.utils.config import SACConfig
from torch_actor_critic_tpu_torch.weights import _adam_state, _named_arrays, train_state_from_jax

REPO = Path(__file__).resolve().parents[1]
LR = 3e-4
N_ENVS, UPDATE_EVERY, STEPS, BATCH, CAPACITY = 3, 5, 10, 8, 50
HIDDEN = (16, 16)
SEQ = dict(history_len=4, seq_d_model=16, seq_num_heads=2, seq_num_layers=1)
PIXEL = dict(filters=(8, 16), kernel_sizes=(4, 3), strides=(2, 2), cnn_dense_size=32,
             cnn_features=8, normalize_pixels=True, frame_augment="shift",
             pixel_pipeline="fused")
PAD = 4
# A rendered frame may differ from JAX's by one count in a few pixels.
FRAME_COUNTS, FRAME_SHARE = 1, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, what, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol,
                               equal_nan=True, err_msg=what)


# ------------------------------------------------------------ the twin


def _cheetah_pose(key):
    """The pose JAX's ``CheetahRunJax.reset(key)`` draws, as the port's
    ``(16,)``: the 7 offsets, then the 9 velocities."""
    k_pos, k_vel, _ = jax.random.split(key, 3)
    return jnp.concatenate([jax.random.uniform(k_pos, (7,), minval=-0.1, maxval=0.1),
                            0.1 * jax.random.normal(k_vel, (9,))])


def _cheetah_state(js) -> EnvState:
    return EnvState(inner=tuple(_t(x) for x in js.inner), obs=_t(js.obs),
                    step_count=_t(js.step_count), episode_return=_t(js.episode_return))


def test_cheetah_twin_matches_jax_teacher_forced_through_a_truncation():
    """1100 steps of 3 envs from step counts (990, 0, 5): env 0 truncates
    at step 9 and 1009, env 2 at 994, env 1 at 999; each step from JAX's
    state, with JAX's reset draws."""
    n = 3
    js = jax.vmap(CheetahRunJax.reset)(jax.random.split(jax.random.key(0), n))
    js = js.replace(step_count=jnp.array([990, 0, 5], jnp.int32))
    jstep = jax.jit(jax.vmap(CheetahRunJax.step))
    poses = jax.jit(jax.vmap(_cheetah_pose))
    rng = np.random.default_rng(0)
    ended_at = []
    for t_ in range(1100):
        action = rng.uniform(-1.2, 1.2, (n, 6)).astype(np.float32)  # clipped at 1
        # |x| after the step is at most |x| before plus 25 · dt.
        x = np.abs(np.asarray(js.inner[0])[:, 0]) + 2.0
        nxt, out = CheetahRunTorch.step(_cheetah_state(js), torch.from_numpy(action),
                                        pose=_t(poses(js.rng)))
        js, jout = jstep(js, jnp.asarray(action))
        for got, want, what in ((nxt.inner[0], js.inner[0], "qpos"),
                                (nxt.inner[1], js.inner[1], "qvel"), (nxt.obs, js.obs, "obs"),
                                (out.next_obs, jout.next_obs, "next_obs")):
            _close(got, want, f"{what} step {t_}", atol=1e-5, rtol=1e-5)
        bound = 4 * np.spacing(x.astype(np.float32)) / 0.05 + 1e-5
        assert np.all(np.abs(out.reward.numpy() - np.asarray(jout.reward)) <= bound), t_
        _close(out.final_return, jout.final_return, f"return step {t_}", atol=1e-3, rtol=1e-5)
        np.testing.assert_array_equal(nxt.step_count.numpy(), np.asarray(js.step_count))
        np.testing.assert_array_equal(out.ended.numpy(), np.asarray(jout.ended))
        assert not out.terminated.any()
        ended_at += [(t_, i) for i in np.flatnonzero(np.asarray(jout.ended))]
    assert ended_at == [(9, 0), (994, 2), (999, 1), (1009, 0)]


def test_cheetah_reset_from_jax_pose_and_registry():
    keys = jax.random.split(jax.random.key(5), 4)
    js = jax.vmap(CheetahRunJax.reset)(keys)
    state = CheetahRunTorch.reset(4, pose=_t(jax.vmap(_cheetah_pose)(keys)))
    for got, want in zip((*state.inner, state.obs, state.step_count, state.episode_return),
                         (*js.inner, js.obs, js.step_count, js.episode_return)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for name in ("HalfCheetah-v3", "HalfCheetah-v4", "HalfCheetah-v5", "cheetah-run-jax"):
        assert tenv.get_on_device_env(name) is CheetahRunTorch
    pose = CheetahRunTorch.sample_pose(20000, torch.Generator().manual_seed(0)).numpy()
    assert np.abs(pose[:, :7]).max() <= 0.1 and abs(pose[:, 7:].std() - 0.1) < 0.005


# ---------------------------------------------------- hyperparameters


def _burst(learner, state, seed=0, n=3):
    """Three eager updates from a fixed chunk, rows and noise."""
    obs = (3,)
    rng = np.random.default_rng(seed)
    chunk = Batch(states=torch.from_numpy(rng.standard_normal((10, *obs)).astype(np.float32)),
                  actions=torch.from_numpy(rng.uniform(-1, 1, (10, 1)).astype(np.float32)),
                  rewards=torch.from_numpy(rng.standard_normal(10).astype(np.float32)),
                  next_states=torch.from_numpy(rng.standard_normal((10, *obs))
                                               .astype(np.float32)),
                  done=torch.zeros(10))
    ring = replay.init_replay_buffer(64, obs, 1, device="cpu")
    indices = torch.from_numpy(rng.integers(0, 10, (n, BATCH)))
    eps = torch.from_numpy(rng.standard_normal((n, 2, BATCH, 1)).astype(np.float32))
    if learner.config.algorithm == "td3":
        eps = eps[:, 0]
    return learner.update_burst(state, ring, chunk, n, indices=indices, eps=eps)


def _solo(algorithm, seed=0):
    cfg = SACConfig(algorithm=algorithm, hidden_sizes=HIDDEN, batch_size=BATCH)
    learner = make_learner(cfg, 1)
    actor, critic = build_models(cfg, (3,), 1, 2.0, generator=torch.Generator().manual_seed(seed))
    return learner, learner.init_state(actor, critic, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("algorithm", ["sac", "td3"])
def test_default_hyperparams_are_neutral(algorithm):
    """A state carrying the configured values as hyperparameters updates
    as one without, to the functional Adam's rounding: a parameter may
    step one ulp apart, and the next gradients and moments follow it."""
    learner, plain = _solo(algorithm)
    with_hp = plain.clone()
    with_hp.hyperparams = learner.default_hyperparams()
    want = {"sac": {"actor_lr", "critic_lr", "alpha"},
            "td3": {"actor_lr", "critic_lr", "target_noise"}}[algorithm]
    assert set(with_hp.hyperparams) == want
    plain, _, mp = _burst(learner, plain)
    with_hp, _, mh = _burst(learner, with_hp)
    for name in plain.module_names():
        for (n, a), b in zip(getattr(plain, name).named_parameters(),
                             getattr(with_hp, name).parameters()):
            _close(b.detach(), a.detach(), f"{name}.{n}", atol=1e-8, rtol=1e-6)
    for opt in ("pi_opt", "q_opt"):
        for a, b in zip(getattr(plain, opt).state.values(), getattr(with_hp, opt).state.values()):
            for k in ("exp_avg", "exp_avg_sq"):
                _close(b[k], a[k], f"{opt} {k}", atol=1e-8, rtol=1e-5)
    _close(mh["loss_q"], mp["loss_q"], "loss_q", atol=1e-6, rtol=1e-6)


def test_hyperparams_steer_the_solo_update():
    learner, base = _solo("sac")
    hp = learner.default_hyperparams()
    frozen = base.clone()
    frozen.hyperparams = {**hp, "actor_lr": torch.tensor(0.0)}
    frozen, _, _ = _burst(learner, frozen)
    for a, b in zip(frozen.actor.parameters(), base.actor.parameters()):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(frozen.critic.parameters(),
                                                      base.critic.parameters()))
    losses = []
    for alpha in (0.01, 5.0):
        s = base.clone()
        s.hyperparams = {**hp, "alpha": torch.tensor(alpha)}
        losses.append(float(_burst(learner, s)[2]["loss_pi"]))
    assert losses[0] != losses[1]


def test_functional_adam_equals_torch_adam_at_the_configured_rate():
    rng = np.random.default_rng(0)
    params = [torch.nn.Parameter(torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
              for s in ((3, 4), (4,))]
    twins = [torch.nn.Parameter(p.detach().clone()) for p in params]
    ref = torch.optim.Adam(params, lr=LR, eps=1e-8)
    fun = torch.optim.Adam(twins, lr=LR, eps=1e-8)
    for _ in range(5):
        grads = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
                 for p in params]
        for p, q, g in zip(params, twins, grads):
            p.grad, q.grad = g.clone(), g.clone()
        ref.step()
        dynamic_lr_step(fun, torch.tensor(LR, dtype=torch.float32))
    for p, q in zip(params, twins):
        _close(q.detach(), p.detach(), "param", atol=1e-8, rtol=1e-6)
        a, b = ref.state[p], fun.state[q]
        assert torch.equal(a["exp_avg"], b["exp_avg"]) and torch.equal(a["exp_avg_sq"],
                                                                       b["exp_avg_sq"])
        assert float(a["step"]) == float(b["step"]) == 5.0


# ------------------------------------------ the member-stacked update

def _jax_learner(over):
    cfg = JSACConfig(batch_size=BATCH, hidden_sizes=HIDDEN, **over)
    env = j_history_env(PendulumJax, over["history_len"]) if "history_len" in over else PendulumJax
    actor_def, critic_def = j_build_models(cfg, JSpecView(env))
    return j_make_learner(cfg, actor_def, critic_def, 1), env


def _port_population(over, p, jax_state, pbt=False, base=PendulumTorch):
    cfg = SACConfig(batch_size=BATCH, hidden_sizes=HIDDEN, **over)
    env = history_env(base, over["history_len"]) if "history_len" in over else base
    shape = env.obs_spec() if hasattr(env, "obs_spec") else getattr(env, "obs_shape",
                                                                     (env.obs_dim,))
    learner = make_population_learner(cfg, 1, p)
    actor, critic = build_population_models(cfg, shape, 1, 2.0,
                                            [torch.Generator() for _ in range(p)])
    jts = jax_state.replace(rng=jax.random.key_data(jax_state.rng))
    state = train_state_from_jax(_np(jts), learner, actor, critic, torch.Generator())
    return learner, state, env


UPDATE_CASES = {
    "flat-fixed": dict(learn_alpha=False),
    "seq-learned": dict(learn_alpha=True, **SEQ),
}


@functools.lru_cache(maxsize=None)
def _jax_population(name, p=3):
    """JAX's learner and a member-stacked state of ``p`` members with
    jittered hyperparameters, member 2's actor_lr set to 0."""
    over = UPDATE_CASES[name]
    jsac, jenv = _jax_learner(over)
    jts = JPopulationLoop(jsac, jenv, p, n_envs=2, pbt=True).init(jax.random.key(1), 16)[0]
    hp = {k: np.asarray(v).copy() for k, v in jts.hyperparams.items()}
    hp["actor_lr"][2] = 0.0
    return jsac, jts.replace(hyperparams={k: jnp.asarray(v) for k, v in hp.items()})


def _pop_batch(p, obs_shape, seed=1):
    rng = np.random.default_rng(seed)
    return {k: v.astype(np.float32) for k, v in dict(
        states=rng.standard_normal((p, BATCH, *obs_shape)),
        actions=rng.uniform(-2, 2, (p, BATCH, 1)),
        rewards=rng.standard_normal((p, BATCH)),
        next_states=rng.standard_normal((p, BATCH, *obs_shape)),
        done=(rng.uniform(size=(p, BATCH)) < 0.25)).items()}


def _jax_noise(jts, p):
    """Each member's ``(eps_q, eps_pi)`` as JAX's update draws them from
    the member's key, stacked ``(2, P, B, 1)``."""
    out = []
    for i in range(p):
        _, kq, kp = jax.random.split(jts.rng[i], 3)
        out.append([np.asarray(jax.random.normal(k, (BATCH, 1))) for k in (kq, kp)])
    return _t(np.stack(out, axis=1))


@pytest.mark.parametrize("name", list(UPDATE_CASES))
def test_member_hyperparams_steer_the_update_as_jax(name):
    """Three members, each with its own actor_lr, critic_lr and alpha or
    target entropy (member 2's actor_lr 0): one stacked update against
    JAX's update of each member under its hyperparameters."""
    from torch_actor_critic_tpu.core.types import Batch as JBatch

    over, p = UPDATE_CASES[name], 3
    jsac, jts = _jax_population(name)
    learner, state, env = _port_population(over, p, jts)
    b = _pop_batch(p, getattr(env, "obs_shape", (3,)))
    eps = _jax_noise(jts, p)
    actor_before = [x.detach().clone() for x in state.actor.parameters()]
    state, m = learner.update(state, Batch(**{k: _t(v) for k, v in b.items()}),
                              eps_q=eps[0], eps_pi=eps[1])
    jupdate = jax.jit(jsac.update)
    for i in range(p):
        member = jax.tree_util.tree_map(lambda x: x[i], jts)
        new, jm = jupdate(member, JBatch(**{k: jnp.asarray(v[i]) for k, v in b.items()}))
        for mod, tree in (("actor", new.actor_params), ("critic", new.critic_params)):
            module = getattr(state, mod)
            want = _named_arrays(module, jax.tree_util.tree_map(lambda x: x[None], _np(tree)))
            for n, t_ in module.named_parameters():
                got = t_.detach().numpy()[i]
                if n.endswith("attn.k.bias"):
                    assert np.abs(got - want[n][0]).max() <= 2 * LR, n
                else:
                    _close(got, want[n][0], f"member {i} {mod}.{n}")
        for k in ("loss_q", "loss_pi", "alpha"):
            _close(m[k][i], jm[k], f"member {i} {k}")
    # Member 2's actor_lr of 0 froze its actor, and only its.
    for now, before in zip(state.actor.parameters(), actor_before):
        assert torch.equal(now[2], before[2]) and not torch.equal(now[0], before[0])


@pytest.mark.parametrize("name", list(UPDATE_CASES))
def test_stacked_gradients_and_moments_equal_each_members_solo_update(name):
    """The per-member gradients and Adam moments of one stacked update
    equal each member's solo update from the same slices, each under its
    member's hyperparameters: the loss is the sum of the members' own
    losses (a mean would scale every gradient by 1/P, which Adam's step
    nearly hides)."""
    over, p = UPDATE_CASES[name], 3
    _, jts = _jax_population(name)
    learner, state, env = _port_population(over, p, jts)
    shape = getattr(env, "obs_shape", (3,))
    b = _pop_batch(p, shape, seed=3)
    eps = np.random.default_rng(4).standard_normal((2, p, BATCH, 1)).astype(np.float32)
    state, m = learner.update(state, Batch(**{k: _t(v) for k, v in b.items()}),
                              eps_q=_t(eps[0]), eps_pi=_t(eps[1]))
    cfg = SACConfig(batch_size=BATCH, hidden_sizes=HIDDEN, **over)
    solo_learner = SAC(cfg, 1)
    for i in range(p):
        member = jax.tree_util.tree_map(lambda x: x[i], jts)
        actor, critic = build_models(cfg, shape, 1, 2.0)
        solo = train_state_from_jax(
            _np(member.replace(rng=jax.random.key_data(member.rng))), solo_learner, actor,
            critic, torch.Generator())
        solo, sm = solo_learner.update(
            solo, Batch(**{k: _t(v[i]) for k, v in b.items()}), eps_q=_t(eps[0, i]),
            eps_pi=_t(eps[1, i]))
        for mod, opt in (("actor", "pi_opt"), ("critic", "q_opt")):
            pop_mod, solo_mod = getattr(state, mod), getattr(solo, mod)
            solo_params = dict(solo_mod.named_parameters())
            for n, pp in pop_mod.named_parameters():
                sp = solo_params[n]
                _close(pp.grad[i], sp.grad, f"member {i} grad {mod}.{n}", atol=1e-6, rtol=1e-4)
                for k in ("exp_avg", "exp_avg_sq"):
                    _close(getattr(state, opt).state[pp][k][i], getattr(solo, opt).state[sp][k],
                           f"member {i} {k} {mod}.{n}", atol=1e-7, rtol=1e-4)
                if n.endswith("attn.k.bias"):  # zero gradient in exact arithmetic
                    assert (pp.detach()[i] - sp.detach()).abs().max() <= 2 * LR, n
                else:
                    _close(pp.detach()[i], sp.detach(), f"member {i} {mod}.{n}", atol=1e-6,
                           rtol=1e-5)
        _close(state.log_alpha.detach()[i], solo.log_alpha.detach(), "log_alpha", atol=1e-7)
        for k in ("loss_q", "loss_pi", "q_mean", "backup_mean", "logp_pi", "alpha"):
            _close(m[k][i], sm[k], f"member {i} {k}", atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------- PBT


@functools.lru_cache(maxsize=None)
def _jax_pbt_state(p, algorithm="sac"):
    over = dict(population=p, on_device=True, pbt_every=1, algorithm=algorithm)
    jsac, jenv = _jax_learner(over)
    return JPopulationLoop(jsac, jenv, p, n_envs=2, pbt=True).init(jax.random.key(7), 16)[0]


def _pbt_loop(p, quantile, algorithm="sac"):
    over = dict(population=p, on_device=True, pbt_every=1, pbt_quantile=quantile,
                pbt_perturb=1.25, algorithm=algorithm)
    jsac, jenv = _jax_learner(over)
    jpop = JPopulationLoop(jsac, jenv, p, n_envs=2, pbt=True)
    jts = _jax_pbt_state(p, algorithm)
    learner, state, env = _port_population(over, p, jts)
    loop = PopulationOnDeviceLoop(learner, env, p, n_envs=2, pbt=True, device="cpu")
    # Distinct Adam moments per member, so a copy shows.
    for opt in (state.pi_opt, state.q_opt, state.alpha_opt):
        for st in opt.state.values():
            st["exp_avg"].copy_(torch.randn(st["exp_avg"].shape,
                                            generator=torch.Generator().manual_seed(3)))
    return jpop, jts, loop, state


PBT_CASES = {
    # name: (P, quantile, return_ema, ema_count)
    "one-each-end": (4, 0.25, [0.0, 10.0, 5.0, 3.0], [1, 1, 1, 1]),
    "half": (4, 0.5, [2.0, -1.0, 7.0, 7.0], [2, 1, 3, 1]),
    "gated": (3, 0.34, [0.0, 5.0, 1.0], [1, 0, 1]),
    # TD3 members: the target actor is copied, target_noise perturbed.
    "td3-half": (4, 0.5, [2.0, -1.0, 7.0, 7.0], [2, 1, 3, 1]),
}


@pytest.mark.parametrize("name", list(PBT_CASES))
def test_pbt_step_matches_jax(name):
    p, quantile, ema, count = PBT_CASES[name]
    algorithm = "td3" if name.startswith("td3") else "sac"
    jpop, jts, loop, state = _pbt_loop(p, quantile, algorithm)
    if algorithm == "td3":
        assert set(state.hyperparams) == {"actor_lr", "critic_lr", "target_noise"}
    key = jax.random.key(8)
    jps = JPBTState(return_ema=jnp.array(ema, jnp.float32),
                    ema_count=jnp.array(count, jnp.int32), rng=key)
    jnew, jps_new, jev = jpop.pbt_step(jts, jps)
    n_cut = max(1, int(p * quantile))
    _, k_pick, k_fac = jax.random.split(key, 3)
    pick = _t(jax.random.randint(k_pick, (n_cut,), 0, n_cut))
    signs = _t(jax.random.choice(k_fac, jnp.array([-1.0, 1.0]), (len(jts.hyperparams), p)))
    ps = PBTState(torch.tensor(ema), torch.tensor(count, dtype=torch.int32),
                  torch.Generator())
    gen_state = ps.generator.get_state()
    before = state.clone()
    ev = loop.pbt_step(state, ps, pick=pick, signs=signs)
    np.testing.assert_array_equal(ev["src"].numpy(), np.asarray(jev["src"]))
    np.testing.assert_array_equal(ev["exploited"].numpy(), np.asarray(jev["exploited"]))
    assert bool(ev["ready"]) == bool(jev["ready"])
    np.testing.assert_array_equal(ps.return_ema.numpy(), np.asarray(jps_new.return_ema))
    np.testing.assert_array_equal(ps.ema_count.numpy(), np.asarray(jps_new.ema_count))
    for k, v in state.hyperparams.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jnew.hyperparams[k]), err_msg=k)
    src = ev["src"].tolist()
    for name_ in state.module_names():
        for (n, now), old in zip(getattr(state, name_).named_parameters(),
                                 getattr(before, name_).parameters()):
            for i, s in enumerate(src):
                assert torch.equal(now[i], old[s]), f"{name_}.{n} member {i}"
        want = _named_arrays(getattr(state, name_), _np(getattr(
            jnew, {"actor": "actor_params", "critic": "critic_params",
                   "target_critic": "target_critic_params",
                   "target_actor": "target_actor_params"}[name_])))
        for n, now in getattr(state, name_).named_parameters():
            np.testing.assert_array_equal(now.detach().numpy(), want[n])
    for opt in ("pi_opt", "q_opt", "alpha_opt"):
        for now, old in zip(getattr(state, opt).state.values(),
                            getattr(before, opt).state.values()):
            for k in ("exp_avg", "exp_avg_sq"):
                for i, s in enumerate(src):
                    assert torch.equal(now[k][i], old[k][s]), f"{opt} {k} member {i}"
            assert torch.equal(now["step"], old["step"])
    for i, s in enumerate(src):
        assert torch.equal(state.log_alpha[i], before.log_alpha[s])
    assert state.step == before.step and torch.equal(ps.generator.get_state(), gen_state)


def test_update_ema_matches_jax():
    jsac, jenv = _jax_learner(dict(population=2, on_device=True, pbt_every=1))
    jpop = JPopulationLoop(jsac, jenv, 2, n_envs=2, pbt=True)
    loop = _small_loop(p=2, pbt=True)
    jps = JPBTState(return_ema=jnp.zeros(2), ema_count=jnp.zeros(2, jnp.int32),
                    rng=jax.random.key(0))
    ps = PBTState.zeros(2, torch.Generator())
    for episodes, reward in (([2.0, 0.0], [-100.0, np.nan]), ([1.0, 0.0], [-50.0, np.nan]),
                             ([0.0, 3.0], [np.nan, -7.5]), ([4.0, 1.0], [-20.25, 3.0])):
        m = {"episodes": np.array(episodes, np.float32), "reward": np.array(reward, np.float32)}
        jps = jpop.update_ema(jps, {k: jnp.asarray(v) for k, v in m.items()})
        loop.update_ema(ps, {k: _t(v) for k, v in m.items()})
        np.testing.assert_array_equal(ps.return_ema.numpy(), np.asarray(jps.return_ema))
        np.testing.assert_array_equal(ps.ema_count.numpy(), np.asarray(jps.ema_count))


def test_init_hyperparams_start_within_one_perturbation():
    cfg = SACConfig(hidden_sizes=HIDDEN, batch_size=BATCH, population=64, on_device=True,
                    pbt_every=1, pbt_perturb=1.25)
    loop = PopulationOnDeviceLoop(PopulationSAC(cfg, 1, 64), PendulumTorch, 64, n_envs=2,
                                  pbt=True, device="cpu")
    hp = loop.init_hyperparams(torch.Generator().manual_seed(0))
    base = loop.sac.default_hyperparams()
    assert set(hp) == {"actor_lr", "critic_lr", "alpha"}
    for k, v in hp.items():
        ratio = (v / base[k]).numpy()
        assert ratio.min() >= 1 / 1.25 - 1e-6 and ratio.max() <= 1.25 + 1e-6
        assert len(set(v.tolist())) == 64


# -------------------------------------------------------------- epochs

LOOPS = {
    # name: (config overrides, JAX base env, port base env, start step counts)
    "flat": (dict(), PendulumJax, PendulumTorch, [[193, 0, 188], [0, 190, 195]]),
    "history": (SEQ, PendulumJax, PendulumTorch, [[0, 193, 188], [194, 0, 0]]),
    "pixel": (dict(PIXEL, learn_alpha=True), PixelPendulumJax, PixelPendulumTorch,
              [[193, 0, 188], [0, 190, 195]]),
    "td3": (dict(algorithm="td3", policy_delay=2), PendulumJax, PendulumTorch,
            [[0, 193, 188], [194, 0, 0]]),
}


def _jax_poses(rng, base=PendulumJax):
    """Each env's next reset pose as JAX's step draws it from the env's
    key (a pixel twin from ``fold_in(rng, 0x9A1)``)."""
    if issubclass(base, PixelPendulumJax):
        th, thd = jax.vmap(lambda r: base._sample_pose(jax.random.fold_in(r, 0x9A1)))(rng)
    else:
        th, thd = jax.vmap(base.reset)(rng).inner
    return np.stack([np.asarray(th), np.asarray(thd)], axis=-1)


def _act_noise(key, warmup):
    out = []
    for _ in range(STEPS):
        key, k_act = jax.random.split(key)
        draw = jax.random.uniform if warmup else jax.random.normal
        out.append(np.asarray(draw(k_act, (N_ENVS, 1))))
    return np.stack(out)


def _burst_draws(rng, sizes, num_updates, algorithm="sac", fused=False):
    """A member's rows, update noise and (fused) shifts of each window, as
    JAX's burst draws them from the member's key."""
    indices, eps, offsets = [], [], []
    for size in sizes:
        wi, we, wo = [], [], []
        for _ in range(num_updates):
            rng, sample_key = jax.random.split(rng)
            k_idx = sample_key
            if fused:
                k_idx, k_s, k_n = jax.random.split(sample_key, 3)
                wo.append(np.stack([np.asarray(jax.random.randint(k, (BATCH, 2), 0, 2 * PAD + 1))
                                    for k in (k_s, k_n)]))
            wi.append(np.asarray(jax.random.randint(k_idx, (BATCH,), 0, size)))
            if algorithm == "td3":
                rng, key_q = jax.random.split(rng)
                we.append(np.asarray(jax.random.normal(key_q, (BATCH, 1))))
            else:
                rng, key_q, key_pi = jax.random.split(rng, 3)
                we.append(np.stack([np.asarray(jax.random.normal(k, (BATCH, 1)))
                                    for k in (key_q, key_pi)]))
        indices.append(np.stack(wi))
        eps.append(np.stack(we))
        offsets.append(np.stack(wo) if wo else None)
    return np.stack(indices), np.stack(eps), (np.stack(offsets) if fused else None)


def _flat_members(x):
    if isinstance(x, JMultiObservation):
        return MultiObservation(_flat_members(x.features), _flat_members(x.frame))
    x = np.asarray(x)
    return torch.from_numpy(np.array(x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])))


def _assert_close_or_frames(got, want, what):
    """Floats to the epoch's tolerance; uint8 frames within a count in a
    few pixels (the twins' renders), integers exactly."""
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype == np.uint8:
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max(initial=0) <= FRAME_COUNTS and (d > 0).mean() <= FRAME_SHARE, what
    else:
        _close(got, want, what, atol=1e-5, rtol=1e-5)


def _port_env(jes) -> EnvState:
    """A member-stacked JAX env batch as the port's one batch of
    ``P·n_envs`` envs."""
    inner = (_port_env(jes.inner) if isinstance(jes.inner, JEnvState)
             else tuple(_flat_members(x) for x in jes.inner))
    return EnvState(inner=inner, obs=_flat_members(jes.obs),
                    step_count=_flat_members(jes.step_count),
                    episode_return=_flat_members(jes.episode_return), rng=torch.Generator())


def _jax_env_leaves(jes) -> list:
    inner = (_jax_env_leaves(jes.inner) if isinstance(jes.inner, JEnvState)
             else [_flat_members(x) for x in jes.inner])
    obs = _flat_members(jes.obs)
    obs = [obs.features, obs.frame] if isinstance(obs, MultiObservation) else [obs]
    return [*inner, *obs, _flat_members(jes.step_count), _flat_members(jes.episode_return)]


def _set_counts(jes, counts):
    count = jnp.array(counts, jnp.int32)
    jes = jes.replace(step_count=count)
    if isinstance(jes.inner, JEnvState):
        jes = jes.replace(inner=jes.inner.replace(step_count=count))
    return jes


def _member_draws(jkeys, jrng_env, p, warmup, base=PendulumJax):
    noise = np.stack([_act_noise(jkeys[i], warmup) for i in range(p)], axis=1)
    poses = np.concatenate([_jax_poses(jrng_env[i], base) for i in range(p)])
    return _t(noise), _t(np.broadcast_to(poses, (STEPS, *poses.shape)))


def _assert_rows(ring, jbuf, size, what):
    for (name, got), want in zip(ring.data.named_leaves(),
                                 jax.tree_util.tree_leaves(jbuf.data), strict=True):
        got, want = got[:, :size].numpy(), np.asarray(want)[:, :size]
        if got.dtype == np.uint8:
            _assert_close_or_frames(got, want, f"{what} {name}")
            continue
        assert np.all(np.abs(got - want) <= 1e-5 * np.maximum(1.0, np.abs(want))), \
            f"{what} {name}: {np.abs(got - want).max()}"


def _assert_metrics(m, jm, what):
    np.testing.assert_array_equal(m["episodes"].numpy(), np.asarray(jm["episodes"]))
    for k in ("loss_q", "loss_pi", "reward"):
        _close(m[k], jm[k], f"{what} {k}")


@pytest.mark.parametrize("name", list(LOOPS))
def test_population_epoch_matches_jax(name):
    """A warm-up and a trained epoch (two windows each) of a population
    of 2 against JAX's ``PopulationOnDeviceLoop.epoch``, each member's
    draws rebuilt from its keys and injected: flat, history and pixel
    SAC (frames gathered by the member fold, shifted) and flat TD3."""
    over, jbase, tbase, counts = LOOPS[name]
    p = 2
    jcfg = JSACConfig(batch_size=BATCH, update_every=UPDATE_EVERY, hidden_sizes=HIDDEN,
                      population=p, on_device=True, **over)
    jenv = j_history_env(jbase, over["history_len"]) if "history_len" in over else jbase
    actor_def, critic_def = j_build_models(jcfg, JSpecView(jenv))
    jsac = j_make_learner(jcfg, actor_def, critic_def, 1)
    jpop = JPopulationLoop(jsac, jenv, p, n_envs=N_ENVS)
    jts, jbuf, jes, jkeys, _ = jpop.init(jax.random.key(0), buffer_capacity=CAPACITY)
    jes = _set_counts(jes, counts)
    learner, state, env = _port_population(
        dict(population=p, on_device=True, update_every=UPDATE_EVERY, **over), p, jts,
        base=tbase)
    loop = PopulationOnDeviceLoop(learner, env, p, n_envs=N_ENVS, device="cpu")
    _, ring, _, act_gen, _ = loop.init(0, CAPACITY)
    es = _port_env(jes)
    jrng_env = jes.inner.rng if isinstance(jes.inner, JEnvState) else jes.rng

    noise, poses = _member_draws(jkeys, jrng_env, p, warmup=True, base=jbase)
    jts, jbuf, jes1, jkeys, jm = jpop.epoch(jts, jbuf, jes, jkeys, steps=STEPS,
                                            update_every=UPDATE_EVERY, warmup=True)
    state, ring, es, act_gen, m = loop.epoch(state, ring, es, act_gen, steps=STEPS,
                                             update_every=UPDATE_EVERY, warmup=True,
                                             noise=noise, poses=poses)
    size = STEPS * N_ENVS
    assert (ring.ptr, ring.size) == (size, size)
    assert np.all(np.asarray(jbuf.size) == size) and np.all(np.asarray(jbuf.ptr) == size)
    _assert_rows(ring, jbuf, size, "warm-up ring")
    _assert_metrics(m, jm, "warm-up")
    for i, (a, b) in enumerate(zip(es.leaves(), _jax_env_leaves(jes1), strict=True)):
        _assert_close_or_frames(a, b, f"warm-up env leaf {i}")

    jrng_env = jes1.inner.rng if isinstance(jes1.inner, JEnvState) else jes1.rng
    noise, poses = _member_draws(jkeys, jrng_env, p, warmup=False, base=jbase)
    per = learner.config.updates_per_window
    sizes = [min(size + (w + 1) * UPDATE_EVERY * N_ENVS, CAPACITY)
             for w in range(STEPS // UPDATE_EVERY)]
    fused = jcfg.pixel_pipeline == "fused"
    draws = [_burst_draws(jts.rng[i], sizes, per, jcfg.algorithm, fused) for i in range(p)]
    indices = _t(np.stack([d[0] for d in draws], axis=2))  # (W, K, P, B)
    # (W, K, [2,] P, B, 1): the member axis before the batch's
    eps = _t(np.stack([d[1] for d in draws], axis=-3))
    offsets = _t(np.stack([d[2] for d in draws], axis=3)) if fused else None  # (W, K, 2, P, B, 2)
    jts, jbuf, jes2, jkeys, jm = jpop.epoch(jts, jbuf, jes1, jkeys, steps=STEPS,
                                            update_every=UPDATE_EVERY)
    state, ring, es, act_gen, m = loop.epoch(state, ring, es, act_gen, steps=STEPS,
                                             update_every=UPDATE_EVERY, noise=noise,
                                             poses=poses, indices=indices, eps=eps,
                                             offsets=offsets)
    assert ring.size == CAPACITY and np.all(np.asarray(jbuf.ptr) == ring.ptr)
    _assert_rows(ring, jbuf, CAPACITY, "trained ring")
    _assert_metrics(m, jm, "trained")
    updates = per * STEPS // UPDATE_EVERY
    pairs = [("actor", jts.actor_params), ("critic", jts.critic_params),
             ("target_critic", jts.target_critic_params)]
    if state.target_actor is not None:
        pairs.append(("target_actor", jts.target_actor_params))
    for mod, tree in pairs:
        module = getattr(state, mod)
        want = _named_arrays(module, _np(tree))
        for n, t_ in module.named_parameters():
            if n.endswith("attn.k.bias"):
                assert np.abs(t_.detach().numpy() - want[n]).max() <= 2 * LR * updates
            else:
                _close(t_.detach(), want[n], f"{mod}.{n}")
    for opt, module, jopt in (("pi_opt", state.actor, jts.pi_opt_state),
                              ("q_opt", state.critic, jts.q_opt_state)):
        adam = _adam_state(_np(jopt))
        for moment, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
            want = _named_arrays(module, moment)
            for n, t_ in module.named_parameters():
                _close(getattr(state, opt).state[t_][key], want[n], f"{opt} {key} {n}")
    _close(state.log_alpha.detach(), jts.log_alpha, "log_alpha")
    assert state.step == updates and np.all(np.asarray(jts.step) == updates)


def _small_loop(p=3, pbt=False, env=PendulumTorch, **over):
    cfg = SACConfig(hidden_sizes=HIDDEN, batch_size=BATCH, population=p, on_device=True,
                    pbt_every=1 if pbt else 0, **over)
    return PopulationOnDeviceLoop(PopulationSAC(cfg, env.act_dim, p), env, p, n_envs=2,
                                  pbt=pbt, device="cpu")


def _clone_all(state, ring, es, gen):
    g = torch.Generator()
    g.set_state(gen.get_state())
    return state.clone(), ring.clone(), es.clone(), g


def test_member_independence_is_bitwise():
    """Member 0's whole epoch output is bitwise the same whatever members
    1 and 2 hold: their parameters, Adam states, rings and env states
    replaced by other values change nothing of member 0's."""
    loop = _small_loop()
    st, ring, es, gen, _ = loop.init(0, 200)
    st, ring, es, gen, _ = loop.epoch(st, ring, es, gen, steps=10, update_every=5, warmup=True)
    st, ring, es, gen, _ = loop.epoch(st, ring, es, gen, steps=10, update_every=5)
    runs = []
    for perturb in (False, True):
        s, r, e, g = _clone_all(st, ring, es, gen)
        if perturb:
            with torch.no_grad():
                for x in [*s.actor.parameters(), *s.critic.parameters(),
                          *(v for o in (s.pi_opt, s.q_opt) for st_ in o.state.values()
                            for v in (st_["exp_avg"], st_["exp_avg_sq"]))]:
                    x[1:].mul_(1.5).add_(0.25)
                for leaf in r.data.leaves():
                    leaf[1:].mul_(-2.0)
                for leaf in e.leaves():
                    if leaf.dtype == torch.float32:
                        leaf[2:].mul_(0.5)
        s, r, e, g, m = loop.epoch(s, r, e, g, steps=10, update_every=5)
        runs.append((s, r, e, m))
    (s0, r0, e0, m0), (s1, r1, e1, m1) = runs
    for a, b in zip([*s0.actor.parameters(), *s0.critic.parameters(), s0.log_alpha],
                    [*s1.actor.parameters(), *s1.critic.parameters(), s1.log_alpha]):
        assert torch.equal(a[0], b[0])
    for a, b in zip(r0.data.leaves(), r1.data.leaves()):
        assert torch.equal(a[0], b[0])
    for a, b in zip(e0.leaves(), e1.leaves()):
        assert torch.equal(a[:2], b[:2])
    for k in m0:
        np.testing.assert_array_equal(m0[k][0].numpy(), m1[k][0].numpy(), err_msg=k)


def test_a_member_runs_as_a_solo_loop_given_its_weights_and_draws():
    """Member 1 of a population, extracted, runs a solo ``OnDeviceLoop``
    epoch fed member 1's slice of the population's draws, to the
    update's tolerance."""
    loop = _small_loop()
    st, ring, es, gen, _ = loop.init(2, 200)
    st, ring, es, gen, _ = loop.epoch(st, ring, es, gen, steps=10, update_every=5, warmup=True)
    solo_state = loop.extract_member(st, 1)
    solo_ring = replay.init_replay_buffer(200, (3,), 1, device="cpu")
    solo_ring = replay.push(solo_ring, Batch(*(x[1, :ring.size] for x in ring.data.leaves())))
    solo_env = EnvState(inner=tuple(x[2:4].clone() for x in es.inner), obs=es.obs[2:4].clone(),
                        step_count=es.step_count[2:4].clone(),
                        episode_return=es.episode_return[2:4].clone(), rng=torch.Generator())
    rng = np.random.default_rng(0)
    k = loop.sac.config.replace(update_every=5).updates_per_window
    noise = rng.standard_normal((10, 3, 2, 1)).astype(np.float32)
    poses = rng.uniform(-1, 1, (10, 6, 2)).astype(np.float32)
    indices = rng.integers(0, ring.size, (2, k, 3, BATCH))
    eps = rng.standard_normal((2, k, 2, 3, BATCH, 1)).astype(np.float32)
    st, ring, es, gen, m = loop.epoch(st, ring, es, gen, steps=10, update_every=5,
                                      noise=_t(noise), poses=_t(poses), indices=_t(indices),
                                      eps=_t(eps))
    solo_loop = OnDeviceLoop(SAC(loop.sac.config, 1), PendulumTorch, n_envs=2, device="cpu")
    solo_state, solo_ring, solo_env, _, sm = solo_loop.epoch(
        solo_state, solo_ring, solo_env, torch.Generator(), steps=10, update_every=5,
        noise=_t(noise[:, 1]), poses=_t(poses[:, 2:4]), indices=_t(indices[:, :, 1]),
        eps=_t(eps[:, :, :, 1]))
    for mod in ("actor", "critic", "target_critic"):
        solo_params = dict(getattr(solo_state, mod).named_parameters())
        for n, t_ in getattr(st, mod).named_parameters():
            _close(t_.detach()[1], solo_params[n].detach(), f"{mod}.{n}")
    for a, b in zip(ring.data.leaves(), solo_ring.data.leaves()):
        _close(a[1, :ring.size], b[:ring.size], "ring")
    for k in ("loss_q", "loss_pi", "episodes"):
        _close(m[k][1], sm[k], k)


def test_population_rings_push_and_sample_per_member():
    ring = replay.init_replay_buffer(5, (2,), 1, device="cpu", members=3)
    assert ring.members == 3 and ring.capacity == 5
    for start in (0, 4):
        chunk = Batch(states=torch.arange(3 * 4 * 2, dtype=torch.float32).reshape(3, 4, 2)
                      + 100 * start, actions=torch.zeros(3, 4, 1),
                      rewards=torch.arange(12, dtype=torch.float32).reshape(3, 4) + 100 * start,
                      next_states=torch.zeros(3, 4, 2), done=torch.zeros(3, 4))
        ring = replay.push(ring, chunk)
    assert (ring.ptr, ring.size, int(ring.device_size)) == (3, 5, 5)
    np.testing.assert_array_equal(ring.data.rewards[1].numpy(), [405, 406, 407, 7, 404])
    idx = torch.tensor([[0, 4], [3, 3], [1, 2]])
    got = replay.sample(ring, 2, indices=idx)
    for i in range(3):
        assert torch.equal(got.rewards[i], ring.data.rewards[i][idx[i]])
        assert torch.equal(got.states[i], ring.data.states[i][idx[i]])
    rows = replay.draw_rows(ring, 7, torch.Generator().manual_seed(0))
    assert rows.shape == (3, 7) and int(rows.max()) < 5
    saved = ring.state_dict()
    assert saved["leaves"]["states"].shape == (3, 5, 2)
    fresh = replay.load_buffer_(replay.init_replay_buffer(5, (2,), 1, device="cpu", members=3),
                                saved)
    for a, b in zip(fresh.data.leaves(), ring.data.leaves()):
        assert torch.equal(a, b)
    assert replay.estimate_buffer_bytes(10**6, (17,), 6) == 10**6 * (2 * 17 * 4 + 6 * 4 + 8)


def test_split_member_metrics_matches_jax():
    metrics = {"loss_q": np.array([1.0, 3.0, 2.5], np.float32),
               "loss_q_max": np.array([2.0, 5.0, 1.0], np.float32),
               "episodes_sum": np.array([0.0, 4.0, 1.0], np.float32),
               "reward": np.array([np.nan, -10.0, -4.0], np.float32),
               "none": np.array([np.nan, np.nan, np.nan], np.float32),
               "scalar": np.float32(7.0)}
    got = split_member_metrics({k: torch.as_tensor(v) for k, v in metrics.items()})
    want = j_split(metrics)
    assert set(got) == set(want)
    for k, v in want.items():
        _close(got[k], v, k, atol=0, rtol=1e-6)


# ----------------------------------------- training runs, checkpoint, CLI


def _run_config(epochs, **over):
    return SACConfig(population=3, on_device=True, on_device_envs=2, pbt_every=2,
                     pbt_quantile=0.34, pbt_ema=0.5, hidden_sizes=HIDDEN, batch_size=BATCH,
                     epochs=epochs, steps_per_epoch=20, update_every=10, start_steps=10,
                     update_after=0, buffer_size=400, save_every=1, **over)


@pytest.fixture(scope="module")
def resumed_vs_straight(tmp_path_factory):
    """Run A: 3 epochs straight. Run B: 2 epochs, then a new
    ``train_population_on_device`` call resumes it for 1 more."""
    root = tmp_path_factory.mktemp("popckpt")
    torch.set_num_threads(1)
    m_a = train_population_on_device("Pendulum-v1", _run_config(3),
                                     checkpointer=Checkpointer(root / "a"), seed=3, device="cpu")
    train_population_on_device("Pendulum-v1", _run_config(2),
                               checkpointer=Checkpointer(root / "b"), seed=3, device="cpu")
    m_b = train_population_on_device("Pendulum-v1", _run_config(1),
                                     checkpointer=Checkpointer(root / "b"), seed=3, device="cpu")
    return root, m_a, m_b


def test_population_checkpoint_resume_is_bitwise(resumed_vs_straight):
    root, m_a, m_b = resumed_vs_straight
    for k, v in m_a.items():
        if k.endswith("_per_sec") or k.startswith("save_"):
            continue
        assert m_b[k] == v or (np.isnan(v) and np.isnan(m_b[k])), (k, v, m_b[k])
    losses = [m_a[f"loss_q_m{i}"] for i in range(3)]
    assert all(np.isfinite(losses)) and len(set(losses)) == 3
    a = torch.load(root / "a" / "epoch_2" / "state.pt", weights_only=True)
    b = torch.load(root / "b" / "epoch_2" / "state.pt", weights_only=True)
    for name in ("actor", "critic", "target_critic"):
        for k in a[name]:
            assert torch.equal(a[name][k], b[name][k]), f"{name}.{k}"
    for k in a["hyperparams"]:
        assert torch.equal(a["hyperparams"][k], b["hyperparams"][k])
    meta = json.loads((root / "a" / "epoch_2" / "meta.json").read_text())
    assert meta["population"] == 3 and len(meta["pbt"]["return_ema"]) == 3
    with pytest.raises(ValueError, match="population of 3"):
        train_population_on_device("Pendulum-v1", _run_config(1).replace(population=2),
                                   checkpointer=Checkpointer(root / "a"), seed=3, device="cpu")


def test_member_export_serves_and_evaluates(resumed_vs_straight, tmp_path):
    root, _, _ = resumed_vs_straight
    member, epoch = export_member_checkpoint(root / "a", tmp_path / "export")
    meta = json.loads((root / "a" / "epoch_2" / "meta.json").read_text())
    assert member == int(np.argmax(meta["pbt"]["return_ema"])) and epoch == 2
    one = torch.load(tmp_path / "export" / "epoch_2" / "actor.pt", weights_only=True)
    pop = torch.load(root / "a" / "epoch_2" / "actor.pt", weights_only=True)
    for k, v in one.items():
        assert torch.equal(v, pop[k][member])
    cfg = SACConfig.from_json(Checkpointer(tmp_path / "export").peek_meta()["config"])
    assert cfg.population == 1 and cfg.pbt_every == 0
    learner, state = _solo("sac")
    Checkpointer(tmp_path / "export").restore(state)  # a standalone learner reads it
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch_actor_critic_tpu_torch.serve", "--ckpt-dir",
         str(tmp_path / "export"), "--obs-dim", "3", "--act-dim", "1", "--act-limit", "2.0",
         "--port", "0", "--max-batch", "4", "--poll-interval", "0", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready = json.loads(proc.stdout.readline())
        obs = np.random.default_rng(0).standard_normal((3, 3)).astype(np.float32)
        req = urlreq.Request(ready["serving"] + "/act", data=json.dumps(
            {"obs": obs.tolist(), "deterministic": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urlreq.urlopen(req, timeout=30) as resp:
            served = np.asarray(json.loads(resp.read())["action"], np.float32)
        with torch.no_grad():
            want, _ = state.actor(torch.from_numpy(obs), deterministic=True)
        np.testing.assert_allclose(served, want.numpy(), atol=1e-6, rtol=0)
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        proc.stdout.close()
        proc.stderr.close()


CLI = ["--environment", "Pendulum-v1", "--on-device", "true", "--population", "2",
       "--pbt-every", "1", "--pbt-quantile", "0.5", "--device", "cpu", "--epochs", "2",
       "--steps-per-epoch", "20", "--update-every", "10", "--start-steps", "10",
       "--update-after", "0", "--batch-size", "8", "--buffer-size", "400", "--hidden-sizes",
       "16,16", "--on-device-envs", "2"]


def test_cli_routes_the_population_and_run_agent_evaluates_a_member(tmp_path, capsys):
    metrics = train_mod.main([*CLI, "--runs-root", str(tmp_path)])
    assert {"loss_q_m0", "loss_q_m1", "pbt_exploits", "save_s", "save_wait_s"} <= set(metrics)
    run_dir = next((tmp_path / "Default").iterdir())
    lines = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    keys = set().union(*(set(x.get("metrics", x)) for x in lines))
    assert {"loss_q_m0", "loss_q_m1", "pbt_exploits"} <= keys
    capsys.readouterr()
    out = run_agent.main(["--run", run_dir.name, "--runs-root", str(tmp_path), "--episodes",
                          "1", "--seed", "0", "--device", "cpu", "--member", "1"])
    assert out["member"] == 1 and np.isfinite(out["ep_ret_mean"])
    assert (run_dir / "artifacts" / "member_1" / "epoch_1" / "actor.pt").exists()
    resumed = train_mod.main(["--run", run_dir.name, "--runs-root", str(tmp_path),
                              "--device", "cpu"])
    assert "loss_q_m1" in resumed


@pytest.mark.parametrize("argv,match", [
    (["--environment", "Pendulum-v1", "--population", "2"], "host-loop population"),
    (["--environment", "PixelPendulumNumpy-v0", "--population", "2", "--on-device", "true",
      "--filters", "8,16", "--kernel-sizes", "4,3", "--strides", "2,2", "--cnn-dense-size", "16",
      "--cnn-features", "4", "--frame-augment", "shift", "--pixel-pipeline", "fused"],
     "visual"),
    (["--environment", "PendulumNumpy-v1", "--population", "2", "--on-device", "true",
      "--algorithm", "td3"], "TD3 population"),
])
def test_populations_not_ported_raise(tmp_path, argv, match):
    """The three populations this test once pinned as refused — the
    host-loop one, the visual fused one and the TD3 fused one (``match``
    names each) — now train through the CLI, one epoch each, every
    member's loss finite; the member axis over a mesh still raises."""
    final = train_mod.main([*argv, "--runs-root", str(tmp_path), "--device", "cpu", "--epochs",
                            "1", "--steps-per-epoch", "20", "--update-every", "10",
                            "--start-steps", "10", "--update-after", "10", "--hidden-sizes",
                            "8", "--buffer-size", "100", "--batch-size", "8",
                            *(["--on-device-envs", "2"] if "--on-device" in argv else [])])
    if match == "host-loop population":
        assert {"reward_m0", "reward_m1"} <= set(final) and np.isfinite(final["loss_q"])
    else:
        assert all(np.isfinite(final[f"loss_q_m{i}"]) for i in range(2)), final
    with pytest.raises(NotImplementedError, match="mesh"):
        PopulationOnDeviceLoop(PopulationSAC(SACConfig(), 1, 2), PendulumTorch, 2, mesh=object(),
                               device="cpu")


MODEL_CASES = {
    # name: (config overrides, observation shape)
    "visual-sac": (dict(PIXEL), MultiObservation(features=(1,), frame=(32, 32, 3))),
    "visual-td3": (dict(PIXEL, algorithm="td3"), MultiObservation(features=(1,),
                                                                   frame=(32, 32, 3))),
    "flat-td3": (dict(algorithm="td3"), (3,)),
}


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_stacked_models_equal_each_members_own(name):
    """Member ``i`` of the stacked actor and critic (grouped convolutions,
    per-member flatten, unrolled visual critics) computes what
    ``build_models``' member ``i`` computes on its slice: on uint8 frames
    (acting) and decoded float frames (the fused pipeline)."""
    over, shape = MODEL_CASES[name]
    cfg = SACConfig(hidden_sizes=HIDDEN, **over)
    gens = [torch.Generator().manual_seed(10 + i) for i in range(3)]
    actor, critic = build_population_models(cfg, shape, 1, 2.0, gens)
    singles = [build_models(cfg, shape, 1, 2.0, generator=torch.Generator().manual_seed(10 + i))
               for i in range(3)]
    rng = np.random.default_rng(2)
    if isinstance(shape, MultiObservation):
        frames = rng.integers(0, 256, (3, 5, 32, 32, 3), dtype=np.uint8)
        inputs = [MultiObservation(_t(rng.standard_normal((3, 5, 1)).astype(np.float32)), f)
                  for f in (_t(frames), _t(frames).float() / 255.0)]
    else:
        inputs = [_t(rng.standard_normal((3, 5, 3)).astype(np.float32))]
    act = _t(rng.uniform(-2, 2, (3, 5, 1)).astype(np.float32))
    eps = _t(rng.standard_normal((3, 5, 1)).astype(np.float32))
    for obs in inputs:
        with torch.no_grad():
            a, _ = actor(obs, eps=eps, with_logprob=False)
            q = critic(obs, act)
            assert a.shape == (3, 5, 1) and q.shape == (3, cfg.num_qs, 5)
            for i, (sa, sc) in enumerate(singles):
                one = (MultiObservation(obs.features[i], obs.frame[i])
                       if isinstance(obs, MultiObservation) else obs[i])
                _close(a[i], sa(one, eps=eps[i], with_logprob=False)[0], f"actor {i}",
                       atol=1e-6, rtol=1e-5)
                _close(q[i], sc(one, act[i]), f"critic {i}", atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("extra", [
    ["--algorithm", "td3", "--environment", "PendulumNumpy-v1"],
    ["--environment", "PixelPendulumNumpy-v0", "--filters", "8,16", "--kernel-sizes", "4,3",
     "--strides", "2,2", "--cnn-dense-size", "16", "--cnn-features", "4", "--frame-augment",
     "shift", "--pixel-pipeline", "fused"],
], ids=["td3", "pixel"])
def test_td3_and_pixel_population_members_export_and_evaluate(tmp_path, capsys, extra):
    """A fused TD3 or pixel population with PBT trains through the CLI;
    ``run_agent --member 1`` exports member 1 (a TD3 member with its
    target actor) and evaluates it on the host env; the export restores
    into a standalone learner equal to the population's slice."""
    train_mod.main([*extra, "--on-device", "true", "--population", "3", "--pbt-every", "1",
                    "--runs-root", str(tmp_path), "--device", "cpu", "--epochs", "2",
                    "--steps-per-epoch", "20", "--update-every", "10", "--start-steps", "10",
                    "--hidden-sizes", "8", "--buffer-size", "100", "--batch-size", "8",
                    "--on-device-envs", "2"])
    (run_dir,) = (tmp_path / "Default").iterdir()
    capsys.readouterr()
    out = run_agent.main(["--run", run_dir.name, "--runs-root", str(tmp_path), "--episodes",
                          "1", "--seed", "0", "--device", "cpu", "--member", "1"])
    assert out["member"] == 1 and np.isfinite(out["ep_ret_mean"])
    saved = torch.load(run_dir / "artifacts" / "checkpoints" / "epoch_1" / "state.pt",
                       weights_only=True)
    exported = torch.load(run_dir / "artifacts" / "member_1" / "epoch_1" / "state.pt",
                          weights_only=True)
    td3 = "td3" in extra
    assert ("target_actor" in exported) == td3
    for mod in ("actor", "critic", "target_critic", *(("target_actor",) if td3 else ())):
        for k, v in exported[mod].items():
            assert torch.equal(v, saved[mod][k][1]), f"{mod}.{k}"


def test_population_raises_naming_the_diverged_members():
    cfg = _run_config(1, reward_scale=float("nan")).replace(pbt_every=0)
    with pytest.raises(FloatingPointError, match=r"members \[0, 1, 2\]"):
        train_population_on_device("PendulumNumpy-v1", cfg, device="cpu")


def test_cheetah_population_trains_on_the_cpu():
    loop = _small_loop(p=2, pbt=True, env=CheetahRunTorch)
    st, ring, es, gen, ps = loop.init(0, 100)
    assert ring.data.states.shape == (2, 100, 17) and es.obs.shape == (4, 17)
    st, ring, es, gen, _ = loop.epoch(st, ring, es, gen, steps=10, update_every=5, warmup=True)
    st, ring, es, gen, m = loop.epoch(st, ring, es, gen, steps=10, update_every=5)
    assert m["loss_q"].shape == (2,) and bool(torch.isfinite(m["loss_q"]).all())
