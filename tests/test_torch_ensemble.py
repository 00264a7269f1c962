"""The port's parameter-stacked critic ensembles against the JAX
package's vmapped ones, on the CPU.

``DoubleCritic`` and ``SequenceDoubleCritic`` of both packages hold
every parameter with a leading ``num_qs`` axis; the port's sequence
critic runs each layer's attention once for the whole ensemble, with
``num_qs`` folded into the batch axis. JAX modules are initialised from
a seed at a small size, their Flax params are bridged by ``weights.py``,
and both sides see the same numpy inputs. JAX runs its attention on the
CPU's XLA path, the port its kernels' plain versions.

Tolerances, stated as ``tol · max(1, max|want|)``: f32 forwards and
gradients 1e-5 (summation order); bf16 forwards 3e-2, as the bf16
actor's (bf16 keeps ~3 significant digits and the two frameworks round
at slightly different points). A seeded build is held bitwise against
the members that single critics draw one after another from the same
generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_actor_critic_tpu.models import DoubleCritic as JaxDoubleCritic
from torch_actor_critic_tpu.models import SequenceDoubleCritic as JaxSequenceDoubleCritic
from torch_actor_critic_tpu_torch.models import (
    Critic,
    DoubleCritic,
    SequenceCritic,
    SequenceDoubleCritic,
)
from torch_actor_critic_tpu_torch.models.mlp import StackedDense
from torch_actor_critic_tpu_torch.models.sequence import plain_attention
from torch_actor_critic_tpu_torch.weights import _named_arrays, load_jax_critic_params

T, OBS_DIM, ACT_DIM, BATCH = 8, 3, 2, 5
SEQ = dict(d_model=32, num_heads=2, num_layers=2, max_len=T, hidden=32)
HIDDEN = (32, 16)
F32_TOL, BF16_TOL = 1e-5, 3e-2


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


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    lim = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= lim, f"{what}: max abs err {err} > {lim}"


def _inputs(family, seed=0):
    rng = np.random.default_rng(seed)
    shape = (BATCH, T, OBS_DIM) if family == "sequence" else (BATCH, OBS_DIM)
    obs = rng.standard_normal(shape).astype(np.float32)
    act = rng.uniform(-1, 1, (BATCH, ACT_DIM)).astype(np.float32)
    return obs, act


def _jax_critic(family, num_qs, dtype=jnp.float32, seed=0):
    if family == "sequence":
        module = JaxSequenceDoubleCritic(num_qs=num_qs, dtype=dtype, **SEQ)
    else:
        module = JaxDoubleCritic(hidden_sizes=HIDDEN, num_qs=num_qs, dtype=dtype)
    obs, act = _inputs(family)
    params = module.init(jax.random.key(seed), jnp.asarray(obs), jnp.asarray(act))
    return module, params


def _port_critic(family, num_qs, dtype=torch.float32, generator=None, **kw):
    if family == "sequence":
        return SequenceDoubleCritic(OBS_DIM, ACT_DIM, num_qs=num_qs, dtype=dtype,
                                    generator=generator, **SEQ, **kw)
    return DoubleCritic(OBS_DIM, ACT_DIM, hidden_sizes=HIDDEN, num_qs=num_qs,
                        dtype=dtype, generator=generator)


def _objective(q, coef, q_min):
    """A scalar that reads every member and the ensemble minimum
    ``q_min``, as the actor loss does (``min_i Q_i(s, π(s))``)."""
    return (q * coef).sum() + q_min.sum()


@pytest.mark.parametrize("num_qs", [2, 3])
@pytest.mark.parametrize("family", ["flat", "sequence"])
def test_stacked_critic_forward_and_gradients_match_jax(family, num_qs):
    jmod, params = _jax_critic(family, num_qs)
    critic = load_jax_critic_params(_port_critic(family, num_qs), _np_tree(params))
    obs, act = _inputs(family, seed=1)
    coef = np.random.default_rng(2).standard_normal((num_qs, BATCH)).astype(np.float32)

    def loss(p, o, a):
        q = jmod.apply(p, o, a)
        return _objective(q, coef, q.min(axis=0))

    want_q = np.asarray(jmod.apply(params, obs, act))
    g_params, g_obs, g_act = jax.grad(loss, argnums=(0, 1, 2))(params, obs, act)

    o, a = (torch.from_numpy(x).requires_grad_() for x in (obs, act))
    q = critic(o, a)
    assert q.shape == (num_qs, BATCH) and q.dtype == torch.float32
    _close(q.detach().numpy(), want_q, F32_TOL, "Q")
    assert not np.allclose(want_q[0], want_q[1])  # the members really differ
    names, tensors = zip(*critic.named_parameters())
    grads = torch.autograd.grad(
        _objective(q, torch.from_numpy(coef), q.amin(0)), [*tensors, o, a])
    # History and action are shared by every member: their gradients sum
    # the members'.
    _close(grads[-2].numpy(), g_obs, F32_TOL, "d/d obs")
    _close(grads[-1].numpy(), g_act, F32_TOL, "d/d action")
    want = _named_arrays(critic, _np_tree(g_params))
    for name, g in zip(names, grads):
        _close(g.numpy(), want[name], F32_TOL, f"d/d {name}")


@pytest.mark.parametrize("num_qs", [2, 3])
def test_stacked_critics_take_one_unbatched_input(num_qs):
    for family in ("flat", "sequence"):
        jmod, params = _jax_critic(family, num_qs)
        critic = load_jax_critic_params(_port_critic(family, num_qs), _np_tree(params))
        obs, act = _inputs(family, seed=3)
        want = np.asarray(jmod.apply(params, obs[0], act[0]))
        with torch.no_grad():
            got = critic(torch.from_numpy(obs[0]), torch.from_numpy(act[0]))
        assert got.shape == (num_qs,)
        _close(got.numpy(), want, F32_TOL, family)


@pytest.mark.parametrize("family", ["flat", "sequence"])
def test_stacked_critic_bf16_compute_matches_jax(family):
    jmod, params = _jax_critic(family, 2, dtype=jnp.bfloat16)
    critic = load_jax_critic_params(
        _port_critic(family, 2, dtype=torch.bfloat16), _np_tree(params))
    obs, act = _inputs(family, seed=4)
    want = np.asarray(jmod.apply(params, obs, act))
    with torch.no_grad():
        got = critic(torch.from_numpy(obs), torch.from_numpy(act))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    _close(got.numpy(), want, BF16_TOL, family)


@pytest.mark.parametrize("num_qs", [1, 2, 3])
@pytest.mark.parametrize("family", ["flat", "sequence"])
def test_seeded_stacked_build_equals_the_members_drawn_one_by_one(family, num_qs):
    """Member i of a seeded ensemble is, bitwise, the i-th single critic
    built one after another from a generator with the same seed, and
    both builds leave the generator in the same state."""
    stacked_gen, member_gen = (torch.Generator().manual_seed(7) for _ in range(2))
    stacked = _port_critic(family, num_qs, generator=stacked_gen)
    if family == "sequence":
        members = [SequenceCritic(OBS_DIM, ACT_DIM, generator=member_gen, **SEQ)
                   for _ in range(num_qs)]
    else:
        members = [Critic(OBS_DIM, ACT_DIM, HIDDEN, generator=member_gen)
                   for _ in range(num_qs)]
    assert torch.equal(stacked_gen.get_state(), member_gen.get_state())
    params = dict(stacked.named_parameters())
    for i, member in enumerate(members):
        theirs = dict(member.named_parameters())
        assert theirs.keys() == params.keys()
        for name, p in params.items():
            assert p.shape == (num_qs, *theirs[name].shape), name
            assert torch.equal(p[i], theirs[name]), (i, name)


@pytest.mark.parametrize("num_qs", [1, 2, 3])
def test_sequence_critic_attention_runs_once_per_layer_for_all_members(num_qs):
    seen = []

    def counting_attention(q, k, v, causal=True):
        seen.append(tuple(q.shape))
        return plain_attention(q, k, v, causal)

    critic = _port_critic("sequence", num_qs, attention_fn=counting_attention)
    obs, act = _inputs("sequence", seed=5)
    q = critic(torch.from_numpy(obs), torch.from_numpy(act))
    q.sum().backward()
    heads = SEQ["num_heads"]
    want = (num_qs * BATCH, heads, T, SEQ["d_model"] // heads)
    assert seen == [want] * SEQ["num_layers"]


@pytest.mark.parametrize("num_qs", [2, 3])
def test_each_stacked_member_equals_it_computed_alone(num_qs):
    """Slice i through a single SequenceCritic gives row i of the
    stacked output: folding the members into the attention's batch
    axis mixes nothing between them."""
    critic = _port_critic("sequence", num_qs, generator=torch.Generator().manual_seed(3))
    obs, act = (torch.from_numpy(x) for x in _inputs("sequence", seed=6))
    with torch.no_grad():
        q = critic(obs, act)
        for i in range(num_qs):
            alone = SequenceCritic(OBS_DIM, ACT_DIM, **SEQ)
            alone.load_state_dict({k: v[i] for k, v in critic.state_dict().items()})
            _close(q[i].numpy(), alone(obs, act).numpy(), F32_TOL, f"member {i}")


def test_stacked_dense_takes_shared_and_stacked_inputs():
    layer = StackedDense(3, 4, 5)
    with torch.no_grad():
        layer.weight.normal_(generator=torch.Generator().manual_seed(0))
        layer.bias.normal_(generator=torch.Generator().manual_seed(1))
    x = torch.randn(6, 4, generator=torch.Generator().manual_seed(2))
    shared = layer(x)
    stacked = layer(x.expand(3, 6, 4))
    want = torch.einsum("ni,qoi->qno", x, layer.weight) + layer.bias[:, None]
    assert shared.shape == stacked.shape == (3, 6, 5)
    torch.testing.assert_close(shared, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(stacked, want, rtol=0, atol=1e-6)
    assert layer(x.expand(3, 2, 6, 4)).shape == (3, 2, 6, 5)
    with pytest.raises(ValueError, match="leading axis"):
        layer(torch.zeros(2, 6, 4))


@pytest.mark.parametrize("family", ["flat", "sequence"])
def test_update_stores_critic_gradients_in_parameter_layout(family):
    """A stacked weight's gradient leaves the batched product
    transposed; the update stores every gradient laid out as its
    parameter, which Adam's multi-tensor passes need on the card."""
    from torch_actor_critic_tpu_torch.core.types import Batch
    from torch_actor_critic_tpu_torch.models import build_models
    from torch_actor_critic_tpu_torch.sac.algorithm import SAC
    from torch_actor_critic_tpu_torch.utils.config import SACConfig

    if family == "sequence":
        cfg = SACConfig(history_len=T, seq_d_model=16, seq_num_heads=2, seq_num_layers=1)
        obs_shape = (T, OBS_DIM)
    else:
        cfg = SACConfig(hidden_sizes=(16, 16))
        obs_shape = (OBS_DIM,)
    actor, critic = build_models(cfg, obs_shape, ACT_DIM, 1.0)
    names, params = zip(*critic.named_parameters())
    obs, act = (torch.from_numpy(x) for x in _inputs(family, seed=7))
    raw = torch.autograd.grad(critic(obs, act).sum(), params)
    assert any(g.stride() != p.stride() for g, p in zip(raw, params))
    sac = SAC(cfg, ACT_DIM)
    state = sac.init_state(actor, critic, torch.Generator().manual_seed(0))
    batch = Batch(states=obs, actions=act, rewards=torch.zeros(BATCH),
                  next_states=obs, done=torch.zeros(BATCH))
    sac.update(state, batch)
    for name, p in zip(names, params):
        assert p.grad is not None and p.grad.stride() == p.stride(), name
