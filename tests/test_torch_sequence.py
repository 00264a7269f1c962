"""The port's policy modules against the JAX package's, on the CPU.

JAX ``SequenceActor``/``Actor`` are initialised from a seed at a small
size, their Flax params are bridged into the port through
``weights.py``, and both sides act on the same numpy observations.
Deterministic actions agree to 1e-5 (f32 summation order). Sampled
actions use the very normals JAX draws (``eps`` injected into the
port): actions 1e-5, log-probs 1e-4 (the log-prob sums several f32
terms of magnitude ~10). The bf16 compute case is held at 3e-2: bf16
keeps ~3 significant digits and the two frameworks round at slightly
different points (bias add, LayerNorm output).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_actor_critic_tpu.models import Actor as JaxActor
from torch_actor_critic_tpu.models import SequenceActor as JaxSequenceActor
from torch_actor_critic_tpu.ops import distributions as jdist
from torch_actor_critic_tpu.utils.config import SACConfig as JaxSACConfig
from torch_actor_critic_tpu_torch.models import (
    Actor,
    DoubleCritic,
    SequenceActor,
    SequenceDoubleCritic,
    build_actor,
    build_models,
)
from torch_actor_critic_tpu_torch.ops import distributions as tdist
from torch_actor_critic_tpu_torch.utils.config import SACConfig
from torch_actor_critic_tpu_torch.weights import actor_from_jax, load_jax_actor_params

T, OBS_DIM, ACT_DIM, ACT_LIMIT = 8, 3, 2, 2.0
REPO = Path(__file__).resolve().parent.parent


def _np_params(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_sequence_actor(num_layers, dtype=jnp.float32, seed=0):
    actor = JaxSequenceActor(
        act_dim=ACT_DIM, d_model=32, num_heads=2, num_layers=num_layers,
        max_len=T, act_limit=ACT_LIMIT, dtype=dtype,
    )
    params = actor.init(jax.random.key(seed), jnp.zeros((T, OBS_DIM)), jax.random.key(1))
    return actor, params


def _port_sequence_actor(params, num_layers, dtype=torch.float32):
    module = SequenceActor(
        OBS_DIM, ACT_DIM, d_model=32, num_heads=2, num_layers=num_layers,
        max_len=T, act_limit=ACT_LIMIT, dtype=dtype,
    )
    return load_jax_actor_params(module, _np_params(params)).eval()


def _obs(batch, seed=0):
    rng = np.random.default_rng(seed)
    shape = (T, OBS_DIM) if batch is None else (batch, T, OBS_DIM)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_sequence_actor_deterministic_matches_jax(num_layers):
    jactor, params = _jax_sequence_actor(num_layers)
    port = _port_sequence_actor(params, num_layers)
    obs = _obs(5)
    want_a, want_logp = jactor.apply(params, obs, None, deterministic=True)
    with torch.no_grad():
        got_a, got_logp = port(torch.from_numpy(obs), deterministic=True)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_logp.numpy(), np.asarray(want_logp), atol=1e-4, rtol=0)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_sequence_actor_sampled_matches_jax_with_injected_eps(num_layers):
    jactor, params = _jax_sequence_actor(num_layers)
    port = _port_sequence_actor(params, num_layers)
    obs = _obs(6, seed=1)
    key = jax.random.key(42)
    want_a, want_logp = jactor.apply(params, obs, key, deterministic=False)
    eps = np.array(jax.random.normal(key, (6, ACT_DIM)))
    with torch.no_grad():
        got_a, got_logp = port(torch.from_numpy(obs), eps=torch.from_numpy(eps))
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_logp.numpy(), np.asarray(want_logp), atol=1e-4, rtol=0)


def test_sequence_actor_unbatched_history_matches_jax():
    """``(T, D)`` input: both sides add and drop a batch axis."""
    jactor, params = _jax_sequence_actor(2)
    port = _port_sequence_actor(params, 2)
    obs = _obs(None, seed=2)
    want_a, want_logp = jactor.apply(params, obs, None, deterministic=True)
    with torch.no_grad():
        got_a, got_logp = port(torch.from_numpy(obs), deterministic=True)
    assert got_a.shape == (ACT_DIM,) and got_logp.shape == ()
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_logp.numpy(), np.asarray(want_logp), atol=1e-4, rtol=0)
    key = jax.random.key(5)
    want_s, _ = jactor.apply(params, obs, key, deterministic=False)
    eps = np.array(jax.random.normal(key, (1, ACT_DIM)))
    with torch.no_grad():
        got_s, _ = port(torch.from_numpy(obs), eps=torch.from_numpy(eps))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5, rtol=0)


def test_sequence_actor_bf16_compute_matches_jax():
    jactor, params = _jax_sequence_actor(2, dtype=jnp.bfloat16)
    port = _port_sequence_actor(params, 2, dtype=torch.bfloat16)
    obs = _obs(4, seed=3)
    want_a, _ = jactor.apply(params, obs, None, deterministic=True)
    with torch.no_grad():
        got_a, _ = port(torch.from_numpy(obs), deterministic=True, with_logprob=False)
    assert got_a.dtype == torch.float32  # the head casts mu to f32
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), atol=3e-2, rtol=0)


def test_sequence_actor_rejects_history_longer_than_max_len():
    _, params = _jax_sequence_actor(1)
    port = _port_sequence_actor(params, 1)
    with pytest.raises(ValueError, match="max_len"):
        port(torch.zeros((1, T + 1, OBS_DIM)), deterministic=True)


@pytest.mark.parametrize("deterministic", [True, False])
def test_flat_actor_matches_jax(deterministic):
    jactor = JaxActor(act_dim=ACT_DIM, hidden_sizes=(32, 16), act_limit=ACT_LIMIT)
    params = jactor.init(jax.random.key(0), jnp.zeros((OBS_DIM,)), jax.random.key(1))
    port = load_jax_actor_params(
        Actor(OBS_DIM, ACT_DIM, hidden_sizes=(32, 16), act_limit=ACT_LIMIT),
        _np_params(params),
    )
    obs = np.random.default_rng(4).standard_normal((7, OBS_DIM)).astype(np.float32)
    key = jax.random.key(9)
    want_a, want_logp = jactor.apply(params, obs, key, deterministic=deterministic)
    eps = None if deterministic else torch.from_numpy(
        np.array(jax.random.normal(key, (7, ACT_DIM)))
    )
    with torch.no_grad():
        got_a, got_logp = port(torch.from_numpy(obs), deterministic=deterministic, eps=eps)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_logp.numpy(), np.asarray(want_logp), atol=1e-4, rtol=0)


def test_distribution_primitives_match_jax():
    rng = np.random.default_rng(5)
    u, mu = (rng.standard_normal((9, 4)).astype(np.float32) * 3 for _ in range(2))
    log_std = rng.uniform(-25, 5, (9, 4)).astype(np.float32)
    clipped = np.clip(log_std, -20, 2)
    np.testing.assert_allclose(
        tdist.gaussian_log_prob(*map(torch.from_numpy, (u, mu, clipped))).numpy(),
        np.asarray(jdist.gaussian_log_prob(u, mu, clipped)), rtol=1e-5, atol=1e-3,
    )
    np.testing.assert_allclose(
        tdist.tanh_log_prob_correction(torch.from_numpy(u)).numpy(),
        np.asarray(jdist.tanh_log_prob_correction(u)), atol=1e-5, rtol=0,
    )
    a, logp = tdist.squashed_gaussian_sample(
        torch.from_numpy(mu), torch.from_numpy(log_std), ACT_LIMIT,
        eps=torch.from_numpy(u),
    )
    assert float(a.abs().max()) <= ACT_LIMIT and torch.isfinite(logp).all()


def test_sampling_needs_exactly_one_noise_source():
    mu = torch.zeros(2, 1)
    with pytest.raises(ValueError):
        tdist.squashed_gaussian_sample(mu, mu, 1.0)
    with pytest.raises(ValueError):
        tdist.squashed_gaussian_sample(
            mu, mu, 1.0, generator=torch.Generator(), eps=torch.zeros(2, 1)
        )
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a1, _ = tdist.squashed_gaussian_sample(mu, mu, 1.0, generator=g1)
    a2, _ = tdist.squashed_gaussian_sample(mu, mu, 1.0, generator=g2)
    assert torch.equal(a1, a2)  # the explicit generator, not the global RNG


@pytest.mark.parametrize(
    "path", sorted(REPO.glob("runs/*/s0/params.json")), ids=lambda p: p.parts[-3]
)
def test_committed_run_configs_load_and_round_trip(path):
    text = path.read_text()
    port = SACConfig.from_json(text)
    ref = JaxSACConfig.from_json(text)
    assert json.loads(port.to_json()) == json.loads(ref.to_json())
    assert SACConfig.from_json(port.to_json()) == port


def test_config_model_dtype_maps_to_torch():
    assert SACConfig().model_dtype == torch.float32
    assert SACConfig(compute_dtype="bf16").model_dtype == torch.bfloat16
    assert SACConfig().resolved_burst_unroll == 1


def test_build_models_dispatch_and_actor_from_jax():
    cfg = SACConfig(history_len=T, seq_d_model=32, seq_num_heads=2, seq_num_layers=1)
    seq, seq_critic = build_models(cfg, (T, OBS_DIM), ACT_DIM, ACT_LIMIT)
    assert isinstance(seq, SequenceActor) and seq.trunk.max_len == T
    assert len(seq.trunk.blocks) == 1 and seq.act_limit == ACT_LIMIT
    assert isinstance(seq_critic, SequenceDoubleCritic) and seq_critic.fc.weight.shape[0] == 2
    flat, flat_critic = build_models(SACConfig(hidden_sizes=(16,)), (OBS_DIM,), ACT_DIM, 1.0)
    assert isinstance(flat, Actor) and isinstance(flat_critic, DoubleCritic)
    assert isinstance(build_actor(cfg, (T, OBS_DIM), ACT_DIM, ACT_LIMIT), SequenceActor)
    _, params = _jax_sequence_actor(1)
    bridged = actor_from_jax(_np_params(params), cfg, (T, OBS_DIM), ACT_DIM, ACT_LIMIT)
    np.testing.assert_array_equal(
        bridged.trunk.pos_embedding.detach().numpy(),
        np.asarray(params["params"]["_trunk"]["pos_embedding"]),
    )
