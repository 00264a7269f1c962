"""The port's host-loop population (``train --population N`` without
``--on-device``) against the JAX package's, on the CPU: the
``PerMemberNormalizer``, a ``PopulationLearner`` burst member by member
for flat, sequence and visual SAC and flat and visual TD3, K1's plain
path over the member-folded ring, the host trainer end to end, its
resume, evaluation and CLI, and what still raises.

As in ``tests/test_torch_population.py``, the port draws a population's
rows, update noise and shifts as one draw where JAX splits a key per
member, so every test that holds the port to JAX rebuilds each member's
draws from its key and injects them.

Tolerances: the normalizer and K1's plain path bitwise; the burst's
learner state and metrics atol 1e-5 / rtol 1e-4, the limits of
``tests/test_torch_sac.py`` (an attention key bias, whose gradient is
zero in exact arithmetic, within 2·lr per update); ring rows
1e-5·max(1, |x|) (frames exactly); the trainer's resume bitwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_actor_critic_tpu.core.types import Batch as JBatch
from torch_actor_critic_tpu.core.types import MultiObservation as JMultiObservation
from torch_actor_critic_tpu.envs.ondevice import PendulumJax, PixelPendulumJax
from torch_actor_critic_tpu.envs.ondevice import history_env as j_history_env
from torch_actor_critic_tpu.ops.pixels import fused_frame_gather as j_fused_frame_gather
from torch_actor_critic_tpu.parallel.population import PopulationLearner as JPopulationLearner
from torch_actor_critic_tpu.sac.ondevice import _SpecView as JSpecView
from torch_actor_critic_tpu.sac.trainer import build_models as j_build_models
from torch_actor_critic_tpu.sac.trainer import make_learner as j_make_learner
from torch_actor_critic_tpu.utils.config import SACConfig as JSACConfig
from torch_actor_critic_tpu.utils.normalize import PerMemberNormalizer as JPerMemberNormalizer
from torch_actor_critic_tpu_torch import run_agent
from torch_actor_critic_tpu_torch import train as train_mod
from torch_actor_critic_tpu_torch.buffer.replay import fold_member_rows, push
from torch_actor_critic_tpu_torch.core.types import Batch, MultiObservation
from torch_actor_critic_tpu_torch.models.population import build_population_models
from torch_actor_critic_tpu_torch.ops.pixels import (
    gather_frames_reference,
    member_frame_gather_pair,
)
from torch_actor_critic_tpu_torch.parallel.population import PopulationLearner
from torch_actor_critic_tpu_torch.sac.population import (
    PopulationSAC,
    PopulationTD3,
    make_population_learner,
)
from torch_actor_critic_tpu_torch.sac.trainer import Trainer
from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer, export_member_checkpoint
from torch_actor_critic_tpu_torch.utils.config import SACConfig
from torch_actor_critic_tpu_torch.utils.normalize import IdentityNormalizer, PerMemberNormalizer
from torch_actor_critic_tpu_torch.weights import _adam_state, _named_arrays, train_state_from_jax

LR = 3e-4
P, BATCH, WINDOW, CAPACITY, UPDATES, PAD = 3, 8, 6, 40, 3, 4
HIDDEN = (16, 16)
SEQ = dict(history_len=4, seq_d_model=16, seq_num_heads=2, seq_num_layers=1)
PIXEL = dict(filters=(8, 16), kernel_sizes=(4, 3), strides=(2, 2), cnn_dense_size=32,
             cnn_features=8, normalize_pixels=True, frame_augment="shift",
             pixel_pipeline="fused")


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
                               err_msg=what)


# ------------------------------------------------------ the normalizer


def test_per_member_normalizer_matches_jax_bitwise():
    """Lockstep batches, single members' resets and evaluation reads, and
    a state_dict round trip: the port's statistics and outputs equal
    JAX's to the bit."""
    rng = np.random.default_rng(0)
    mine, theirs = PerMemberNormalizer(4, 3), JPerMemberNormalizer(4, 3)
    for step in range(30):
        x = rng.standard_normal((4, 3)) * (1 + step) + step
        np.testing.assert_array_equal(mine.normalize(x), theirs.normalize(x))
        i = step % 4
        one = rng.standard_normal(3) * 5
        update = step % 3 != 0
        np.testing.assert_array_equal(mine.normalize(one, update=update, member=i),
                                      theirs.normalize(one, update=update, member=i))
        np.testing.assert_array_equal(mine.normalize(x, update=False),
                                      theirs.normalize(x, update=False))
    for k in ("mean", "m2", "count"):
        np.testing.assert_array_equal(getattr(mine, k), getattr(theirs, k))
    assert mine.state_dict() == theirs.state_dict()
    again = PerMemberNormalizer(4, 3)
    again.load_state_dict(mine.state_dict())
    x = rng.standard_normal((4, 3))
    np.testing.assert_array_equal(again.normalize(x), theirs.normalize(x))
    with pytest.raises(ValueError, match="member-aligned"):
        mine.normalize(np.zeros((3, 3)))
    with pytest.raises(ValueError, match="n_members"):
        PerMemberNormalizer(0, 3)


# ------------------------------------------- the PopulationLearner burst

BURSTS = {
    # name: (config overrides, JAX env, port observation shape)
    "flat-sac": (dict(hidden_sizes=HIDDEN), PendulumJax, (3,)),
    "sequence-sac": (dict(learn_alpha=True, **SEQ), PendulumJax, (4, 3)),
    "visual-sac": (dict(PIXEL, hidden_sizes=HIDDEN, learn_alpha=True), PixelPendulumJax,
                   MultiObservation(features=(1,), frame=(32, 32, 3))),
    "flat-td3": (dict(algorithm="td3", hidden_sizes=HIDDEN, policy_delay=2), PendulumJax,
                 (3,)),
    "visual-td3": (dict(PIXEL, algorithm="td3", hidden_sizes=HIDDEN, policy_delay=2),
                   PixelPendulumJax, MultiObservation(features=(1,), frame=(32, 32, 3))),
}


def _jax_setup(name):
    over, jbase, _ = BURSTS[name]
    jcfg = JSACConfig(batch_size=BATCH, update_every=WINDOW, population=P, **over)
    jenv = j_history_env(jbase, over["history_len"]) if "history_len" in over else jbase
    actor_def, critic_def = j_build_models(jcfg, JSpecView(jenv))
    jsac = j_make_learner(jcfg, actor_def, critic_def, 1)
    return jcfg, jenv, jsac


def _jax_obs_spec(shape):
    if isinstance(shape, MultiObservation):
        return JMultiObservation(features=jax.ShapeDtypeStruct(shape.features, jnp.float32),
                                 frame=jax.ShapeDtypeStruct(shape.frame, jnp.uint8))
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _chunk(shape, seed):
    """A ``(P, WINDOW, ...)`` numpy chunk: frames uint8, the rest f32."""
    rng = np.random.default_rng(seed)
    lead = (P, WINDOW)

    def obs():
        if isinstance(shape, MultiObservation):
            return MultiObservation(
                rng.standard_normal((*lead, *shape.features)).astype(np.float32),
                rng.integers(0, 256, (*lead, *shape.frame), dtype=np.uint8))
        return rng.standard_normal((*lead, *shape)).astype(np.float32)

    return Batch(states=obs(), actions=rng.uniform(-2, 2, (*lead, 1)).astype(np.float32),
                 rewards=rng.standard_normal(lead).astype(np.float32), next_states=obs(),
                 done=(rng.uniform(size=lead) < 0.2).astype(np.float32))


def _to_jax(chunk):
    def conv(x):
        if isinstance(x, MultiObservation):
            return JMultiObservation(jnp.asarray(x.features), jnp.asarray(x.frame))
        return jnp.asarray(x)
    return JBatch(*(conv(getattr(chunk, f)) for f in
                    ("states", "actions", "rewards", "next_states", "done")))


def _member_burst_draws(rng, size, algorithm, fused):
    """One member's rows, update noise and (fused) shifts of a burst of
    ``UPDATES``, as JAX's burst draws them from the member's key."""
    indices, eps, offsets = [], [], []
    for _ in range(UPDATES):
        rng, sample_key = jax.random.split(rng)
        if fused:
            k_idx, k_s, k_n = jax.random.split(sample_key, 3)
            offsets.append(np.stack([np.asarray(jax.random.randint(k, (BATCH, 2), 0, 2 * PAD + 1))
                                     for k in (k_s, k_n)]))
        else:
            k_idx = sample_key
        indices.append(np.asarray(jax.random.randint(k_idx, (BATCH,), 0, size)))
        if algorithm == "td3":
            rng, key_q = jax.random.split(rng)
            eps.append(np.asarray(jax.random.normal(key_q, (BATCH, 1))))
        else:
            rng, key_q, key_pi = jax.random.split(rng, 3)
            eps.append(np.stack([np.asarray(jax.random.normal(k, (BATCH, 1)))
                                 for k in (key_q, key_pi)]))
    return indices, eps, offsets


@functools.lru_cache(maxsize=None)
def _jax_burst(name):
    """JAX's population of ``P`` after one burst of ``UPDATES`` on a
    fresh ring, its state before, the chunk and every member's draws."""
    over, _, shape = BURSTS[name]
    jcfg, jenv, jsac = _jax_setup(name)
    jpop = JPopulationLearner(jsac, P)
    example = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                     _jax_obs_spec(shape))
    jts0 = jpop.init_state(jax.random.key(3), example)
    jbuf = jpop.init_buffer(CAPACITY, _jax_obs_spec(shape), 1)
    chunk = _chunk(shape, seed=5)
    draws = [_member_burst_draws(jts0.rng[i], WINDOW, jcfg.algorithm,
                                 jcfg.pixel_pipeline == "fused") for i in range(P)]
    before = _np(jts0.replace(rng=jax.random.key_data(jts0.rng)))  # the burst donates jts0
    jts, jbuf, jm = jpop.update_burst(jts0, jbuf, _to_jax(chunk), UPDATES)
    return before, jts, jbuf, jm, chunk, draws


def _port_learner(name, jts0):
    over, _, shape = BURSTS[name]
    cfg = SACConfig(batch_size=BATCH, update_every=WINDOW, population=P, **over)
    learner = PopulationLearner(make_population_learner(cfg, 1, P), P)
    actor, critic = build_population_models(cfg, shape, 1, 2.0,
                                            [torch.Generator() for _ in range(P)])
    state = train_state_from_jax(jts0, learner.learner, actor, critic, torch.Generator())
    return learner, state, shape


def _assert_members(state, jts, updates):
    pairs = [("actor", "actor_params"), ("critic", "critic_params"),
             ("target_critic", "target_critic_params")]
    if state.target_actor is not None:
        pairs.append(("target_actor", "target_actor_params"))
    for mine, theirs in pairs:
        module = getattr(state, mine)
        want = _named_arrays(module, _np(getattr(jts, theirs)))
        for n, p in module.named_parameters():
            for i in range(P):
                got, w = p.detach().numpy()[i], want[n][i]
                if n.endswith("attn.k.bias"):
                    assert np.abs(got - w).max() <= 2 * LR * updates, f"{mine}.{n}"
                else:
                    _close(got, w, f"member {i} {mine}.{n}")
    for opt, module, jopt in (("pi_opt", state.actor, jts.pi_opt_state),
                              ("q_opt", state.critic, jts.q_opt_state)):
        adam = _adam_state(_np(jopt))
        for moment, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
            want = _named_arrays(module, moment)
            for n, p in module.named_parameters():
                _close(getattr(state, opt).state[p][key], want[n], f"{opt} {key} {n}")
    _close(state.log_alpha.detach(), jts.log_alpha, "log_alpha")


@pytest.mark.parametrize("name", list(BURSTS))
def test_population_learner_burst_matches_jax_member_by_member(name):
    """One burst of 3 updates of a population of 3 from JAX's member-stacked
    state (weights carried across), each member's draws rebuilt from its
    key: every member's networks, targets, Adam moments, ``log_alpha``,
    ring and losses against JAX's ``PopulationLearner``."""
    jts0, jts, jbuf, jm, chunk, draws = _jax_burst(name)
    learner, state, shape = _port_learner(name, jts0)
    ring = learner.init_buffer(CAPACITY, shape, 1, torch.device("cpu"))
    hooks = {"indices": _t(np.stack([np.stack(d[0]) for d in draws], axis=1))}  # (K, P, B)
    eps = np.stack([np.stack(d[1]) for d in draws], axis=-3)  # (K, [2,] P, B, 1)
    hooks["eps"] = _t(eps)
    if draws[0][2]:
        hooks["offsets"] = _t(np.stack([np.stack(d[2]) for d in draws], axis=2))  # (K, 2, P, B, 2)
    state, ring, m = learner.learner.update_burst(state, ring, chunk.map(torch.from_numpy),
                                                  UPDATES, **hooks)
    assert state.step == UPDATES and int(state.device_step) == UPDATES
    assert (ring.ptr, ring.size, ring.members) == (WINDOW, WINDOW, P)
    assert np.all(np.asarray(jbuf.size) == WINDOW)
    for (leaf, got), want in zip(ring.data.named_leaves(), jax.tree_util.tree_leaves(jbuf.data),
                                 strict=True):
        np.testing.assert_array_equal(got[:, :WINDOW].numpy(), np.asarray(want)[:, :WINDOW],
                                      err_msg=leaf)
    _assert_members(state, jts, UPDATES)
    for k in ("loss_q", "loss_pi"):
        assert m[k].shape == (P,)
        _close(m[k], jm[k], k)


def test_population_learner_api():
    """``select_action`` acts member i on row i through the stacked actor
    (deterministic rows equal a wider batch's to rounding), the learner's
    bursts of alternating sizes over the member rings run eagerly on the
    CPU, and a mesh or a learner of another member count raises."""
    learner, state, _ = _port_learner("flat-sac", _jax_burst("flat-sac")[0])
    obs = torch.randn(P, 3, generator=torch.Generator().manual_seed(0))
    act = learner.select_action(state, obs, deterministic=True)
    assert act.shape == (P, 1)
    whole, _ = state.actor(obs[:, None].expand(P, 2, 3).contiguous(), deterministic=True,
                           with_logprob=False)
    torch.testing.assert_close(act, whole[:, 0], rtol=1e-5, atol=1e-6)
    noisy = learner.select_action(state, obs, torch.Generator().manual_seed(1))
    assert noisy.shape == (P, 1) and not torch.equal(noisy, act)
    ring = learner.init_buffer(CAPACITY, (3,), 1, torch.device("cpu"))
    ring = push(ring, _chunk((3,), 1).map(torch.from_numpy))
    for n in (2, 3, 2):
        state, ring, m = learner.learner.update_burst(
            state, ring, _chunk((3,), n).map(torch.from_numpy), n)
        assert m["loss_q"].shape == (P,)
    assert state.step == 7 and ring.size == 4 * WINDOW and learner.learner.graph_captures == 0
    with pytest.raises(NotImplementedError, match="mesh"):
        PopulationLearner(learner.learner, P, mesh=object())
    with pytest.raises(ValueError, match="members"):
        PopulationLearner(learner.learner, P + 1)
    with pytest.raises(ValueError, match="trains SAC members, not 'td3'"):
        PopulationSAC(SACConfig(algorithm="td3"), 1, P)
    with pytest.raises(ValueError, match="trains TD3 members, not 'sac'"):
        PopulationTD3(SACConfig(), 1, P)


# ------------------------------------------------- K1 at the member fold

FOLDS = {
    # name: (out dtype, normalize, shift)
    "f32-shift-normalized": (torch.float32, True, True),
    "bf16-shift": (torch.bfloat16, False, True),
    "f32-plain": (torch.float32, False, False),
}


@pytest.mark.parametrize("name", list(FOLDS))
def test_member_fold_plain_path_matches_jax_vmapped_gather_bitwise(name):
    """Both frame leaves of 3 members' rings ``(3, 20, 32, 32, 3)`` at 3·8
    rows, through the member fold's plain path, against JAX's gather
    vmapped over the members, to the bit."""
    out_dtype, normalize, shift = FOLDS[name]
    rng = np.random.default_rng(7)
    rings = [rng.integers(0, 256, (P, 20, 32, 32, 3), dtype=np.uint8) for _ in range(2)]
    idx = rng.integers(0, 20, (P, BATCH))
    offs = [rng.integers(0, 2 * PAD + 1, (P, BATCH, 2)) for _ in range(2)] if shift else None
    got = member_frame_gather_pair([torch.from_numpy(r) for r in rings],
                                   fold_member_rows(torch.from_numpy(idx), 20),
                                   None if offs is None else [torch.from_numpy(o) for o in offs],
                                   pad=PAD, normalize=normalize, out_dtype=out_dtype)
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[out_dtype]
    for leaf in range(2):
        def one(ring, i, o):
            return j_fused_frame_gather(ring, i, o, pad=PAD, normalize=normalize,
                                        out_dtype=jdtype)
        want = jax.vmap(one, in_axes=(0, 0, 0 if shift else None))(
            jnp.asarray(rings[leaf]), jnp.asarray(idx, jnp.int32),
            None if offs is None else jnp.asarray(offs[leaf], jnp.int32))
        assert got[leaf].shape == (P, BATCH, 32, 32, 3) and got[leaf].dtype == out_dtype
        np.testing.assert_array_equal(got[leaf].float().numpy(),
                                      np.asarray(want.astype(jnp.float32)), err_msg=f"leaf {leaf}")
        # Member i's rows are its own ring's: the solo plain path on slice i.
        for i in range(P):
            solo = gather_frames_reference(
                torch.from_numpy(rings[leaf][i]), torch.from_numpy(idx[i]),
                None if offs is None else torch.from_numpy(offs[leaf][i]), PAD, normalize,
                out_dtype)
            assert torch.equal(got[leaf][i], solo)


def test_member_fold_refuses_a_frame_stack():
    rings = [torch.zeros((2, 10, 8, 8, 3), dtype=torch.uint8)] * 2
    rows = torch.zeros((8,), dtype=torch.long)
    with pytest.raises(ValueError, match="frame_stack=3.*previous member"):
        member_frame_gather_pair(rings, rows, frame_stack=3)
    with pytest.raises(ValueError, match=r"\(P, capacity, H, W, C\)"):
        member_frame_gather_pair([r[0] for r in rings], rows)
    with pytest.raises(ValueError, match=r"rows \(P·B,\)"):
        member_frame_gather_pair(rings, rows.reshape(2, 4))


# ------------------------------------------------------ the host trainer

TINY = dict(hidden_sizes=HIDDEN, batch_size=16, epochs=2, steps_per_epoch=40, start_steps=10,
            update_after=10, update_every=10, buffer_size=500, max_ep_len=100)
ENV = "PendulumNumpy-v1"


def _trainer(ckpt=None, seed=0, env=ENV, **over):
    cfg = SACConfig(**{**TINY, "population": P, **over})
    return Trainer(env, cfg, seed=seed, device="cpu",
                   checkpointer=None if ckpt is None else Checkpointer(ckpt, retry_backoff_s=0.0))


@pytest.fixture(scope="module")
def pop_trained():
    tr = _trainer()
    metrics = tr.train()
    yield tr, metrics
    tr.close()


def test_population_trainer_end_to_end(pop_trained):
    """JAX's ``test_population_trainer_end_to_end``: 80 lockstep steps,
    windows at steps 9, 19, ..., 79, bursts once step > 10: 7 bursts of
    10 updates; ``reward_m{i}`` per member; members differ."""
    tr, metrics = pop_trained
    assert tr.state.step == 70 and int(tr.state.device_step) == 70
    assert isinstance(tr.dp, PopulationLearner) and tr.pool.n == P
    assert tr.buffer.members == P and tr.buffer.size == 80
    for i in range(P):
        assert f"reward_m{i}" in metrics
    assert metrics["grad_steps_per_sec"] > 0
    w = tr.state.actor.trunk.layers[0].weight
    assert not torch.allclose(w[0], w[1]) and not torch.allclose(w[1], w[2])
    rows = tr.buffer.data.states[:, :80]
    assert not torch.equal(rows[0], rows[1])


def test_population_eval_per_member(pop_trained):
    tr, _ = pop_trained
    ev = tr.evaluate(episodes=2, deterministic=True, seed=99)
    assert len(ev["per_member"]) == P
    assert np.isfinite(ev["ep_ret_mean"]) and ev["ep_len_mean"] == 100.0
    assert ev == tr.evaluate(episodes=2, deterministic=True, seed=99)
    member_means = [m["ep_ret_mean"] for m in ev["per_member"]]
    assert ev["ep_ret_mean"] == pytest.approx(np.mean(member_means))


def test_population_trainer_is_reproducible_at_a_fixed_seed(pop_trained):
    tr, metrics = pop_trained
    again = _trainer()
    try:
        m2 = again.train()
        for a, b in zip(tr.state.state_dict()["actor"].values(),
                        again.state.state_dict()["actor"].values()):
            assert torch.equal(a, b)
        assert {k: v for k, v in metrics.items() if "per_sec" not in k and not
                k.endswith("_s")} == {k: v for k, v in m2.items()
                                      if "per_sec" not in k and not k.endswith("_s")}
    finally:
        again.close()


@pytest.mark.parametrize("over,normalizer", [
    (dict(normalize_observations=True), PerMemberNormalizer),
    (dict(normalize_observations=True, **SEQ), IdentityNormalizer),
])
def test_population_trainer_picks_the_jax_normalizer(over, normalizer, caplog):
    tr = _trainer(**over)
    try:
        assert type(tr.normalizer) is normalizer
        if normalizer is IdentityNormalizer:
            assert "per-member normalizer" in caplog.text
    finally:
        tr.close()


def _state_of(tr) -> dict:
    return {"state": tr.state.state_dict(), "buffer": tr.buffer.state_dict(),
            "act": tr._act_gen.get_state(), "normalizer": tr.normalizer.state_dict()}


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


@pytest.mark.parametrize("over", [dict(normalize_observations=True), dict(algorithm="td3")],
                         ids=["sac-normalized", "td3"])
def test_population_resume_is_bitwise(tmp_path, over):
    """Three epochs straight against two, a restore into a new trainer
    and one more: the stacked learner, the member rings, the
    per-member normalizer and the acting generator bitwise; the
    checkpoint holds what JAX's does (no ``population`` in its meta, so
    no member export, as in JAX)."""
    straight = _trainer(tmp_path / "a", epochs=3, **over)
    try:
        straight.train()
        want = _state_of(straight)
    finally:
        straight.close()
    first = _trainer(tmp_path / "b", epochs=2, **over)
    try:
        first.train()
    finally:
        first.close()
    meta = first.checkpointer.peek_meta()
    assert meta["step"] == 80 and "population" not in meta and meta["normalizer"] is not None
    with pytest.raises(ValueError, match="not a population checkpoint"):
        export_member_checkpoint(tmp_path / "b", tmp_path / "x")
    resumed = _trainer(tmp_path / "b", epochs=1, **over)
    try:
        assert resumed.restore() == 2
        resumed.train()
        _assert_bitwise(want, _state_of(resumed))
    finally:
        resumed.close()


def test_population_nan_rolls_back_the_stacked_state_and_rings(tmp_path):
    """A NaN reward in epoch 1 (member 0's at lockstep step 50; the
    wrapper counts the pool's lockstep steps) poisons member 0's ring
    and, through the burst, the stacked learner: the sentinel rolls every
    member back to epoch 0's checkpoint in place and training goes on."""
    from torch_actor_critic_tpu_torch.resilience.faultinject import FaultyEnvPool
    from torch_actor_critic_tpu_torch.resilience.sentinel import tree_all_finite

    tr = _trainer(tmp_path, epochs=4, save_every=1)
    tr.pool = FaultyEnvPool(tr.pool).nan_rewards_at(50, envs=[0])
    try:
        metrics = tr.train()
        assert tr.sentinel.total_rollbacks == 1 and metrics["rollbacks"] == 1
        assert np.isfinite(metrics["loss_q"]) and tree_all_finite(tr.state, tr.buffer.data)
    finally:
        tr.close()


def test_cli_trains_a_host_population_resumes_and_evaluates(tmp_path, capsys):
    """``train --population 2`` without ``--on-device`` trains in the host
    trainer and prints each member's curve; ``--run`` resumes it and
    ``run_agent`` evaluates every member (``per_member``)."""
    argv = ["--environment", ENV, "--population", "2", "--device", "cpu", "--epochs", "1",
            "--steps-per-epoch", "40", "--update-every", "10", "--start-steps", "10",
            "--update-after", "10", "--hidden-sizes", "8", "--batch-size", "8",
            "--buffer-size", "100", "--runs-root", str(tmp_path), "--eval-episodes", "1"]
    final = train_mod.main(argv)
    assert {"reward_m0", "reward_m1"} <= set(final)
    out = capsys.readouterr().out.splitlines()
    assert len(out[-1].split('"per_member"')) == 2
    (run_dir,) = (tmp_path / "Default").iterdir()
    resumed = train_mod.main(["--run", run_dir.name, "--runs-root", str(tmp_path),
                              "--device", "cpu"])
    assert "reward_m1" in resumed
    capsys.readouterr()
    ev = run_agent.main(["--run", run_dir.name, "--runs-root", str(tmp_path), "--episodes",
                         "1", "--seed", "0", "--device", "cpu"])
    assert len(ev["per_member"]) == 2 and "member" not in ev


@pytest.mark.parametrize("argv,err,match", [
    (["--population", "2", "--pbt-every", "1"], ValueError, "pass --on-device true"),
    (["--population", "2", "--algorithm", "td3", "--history-len", "4"], ValueError,
     "algorithm='td3' supports flat and visual"),
])
def test_what_the_host_population_still_refuses(tmp_path, argv, err, match):
    with pytest.raises(err, match=match):
        train_mod.main(["--environment", ENV, *argv, "--runs-root", str(tmp_path), "--device",
                        "cpu", "--epochs", "1", "--steps-per-epoch", "20", "--update-every",
                        "10", "--hidden-sizes", "8", "--buffer-size", "100"])
