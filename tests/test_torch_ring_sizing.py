"""Replay-ring sizing (``buffer/replay.py``: ``estimate_buffer_bytes``,
``nbytes``, ``warn_if_buffer_exceeds_hbm``) against the JAX package's, and
the warning at its call sites.

The estimate counts two observation copies per row plus the action,
reward and done; ``nbytes`` measures a live ring. The port's ring has a
device size where the JAX ring has ``ptr`` and ``size`` scalars (8 bytes
either way); a population's ring has one cursor for all members where
the JAX package keeps one per member. The warning fires above half the
card's memory (``torch.cuda.mem_get_info``'s total) and is a no-op on
the CPU.
"""

import logging

import jax
import jax.numpy as jnp
import pytest
import torch

from torch_actor_critic_tpu.buffer import replay as jreplay
from torch_actor_critic_tpu.core.types import MultiObservation as JMultiObservation
from torch_actor_critic_tpu_torch.buffer import replay
from torch_actor_critic_tpu_torch.core.types import MultiObservation
from torch_actor_critic_tpu_torch.sac.population import make_population_learner
from torch_actor_critic_tpu_torch.sac.trainer import Trainer
from torch_actor_critic_tpu_torch.utils.config import SACConfig

H100_TOTAL = 85_017_755_648  # 79.18 GiB, torch.cuda.mem_get_info's total on an H100 80GB HBM3

# name -> (port obs shape, JAX obs spec, act_dim)
RINGS = {
    "flat": ((3,), jax.ShapeDtypeStruct((3,), jnp.float32), 1),
    "history16": ((16, 3), jax.ShapeDtypeStruct((16, 3), jnp.float32), 1),
    "pixel": (MultiObservation((1,), (32, 32, 3)),
              JMultiObservation(jax.ShapeDtypeStruct((1,), jnp.float32),
                                jax.ShapeDtypeStruct((32, 32, 3), jnp.uint8)), 1),
    "wall": (MultiObservation((168,), (64, 64, 3)),
             JMultiObservation(jax.ShapeDtypeStruct((168,), jnp.float32),
                               jax.ShapeDtypeStruct((64, 64, 3), jnp.uint8)), 56),
}


def _rings(name, capacity, members=None):
    shape, spec, act = RINGS[name]
    if isinstance(shape, MultiObservation):
        ours = replay.init_visual_replay_buffer(capacity, shape.features[0], shape.frame, act,
                                                "cpu", members=members)
        theirs = jreplay.init_visual_replay_buffer(capacity, spec.features.shape[0],
                                                   spec.frame.shape, act)
    else:
        ours = replay.init_replay_buffer(capacity, shape, act, "cpu", members=members)
        theirs = jreplay.init_replay_buffer(capacity, spec, act)
    if members is not None:  # JAX's PopulationLearner.init_buffer: every leaf member-stacked
        theirs = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x[None], (members,) + x.shape), theirs)
    return ours, theirs


@pytest.mark.parametrize("name", list(RINGS))
@pytest.mark.parametrize("capacity", [1, 37, 10**6])
def test_estimate_equals_the_jax_estimate(name, capacity):
    shape, spec, act = RINGS[name]
    assert replay.estimate_buffer_bytes(capacity, shape, act) == \
        jreplay.estimate_buffer_bytes(capacity, spec, act)


@pytest.mark.parametrize("name", list(RINGS))
@pytest.mark.parametrize("members", [None, 4])
def test_nbytes_of_a_live_ring_equals_the_jax_rings(name, members):
    capacity = 50
    ours, theirs = _rings(name, capacity, members)
    p = members or 1
    # The rows: exactly the estimate at capacity · P, as JAX's.
    shape, _, act = RINGS[name]
    rows = sum(x.nbytes for _, x in ours.data.named_leaves())
    assert rows == replay.estimate_buffer_bytes(capacity * p, shape, act)
    assert rows == sum(int(x.nbytes) for x in jax.tree_util.tree_leaves(theirs.data))
    # The cursor: the port's one device size, JAX's ptr and size per member.
    assert replay.nbytes(ours) == rows + 8
    assert jreplay.nbytes(theirs) == rows + 8 * p


def _patched_card(monkeypatch, total=H100_TOTAL):
    calls = []

    def mem_get_info(device=None):
        calls.append(device)
        return total // 2, total

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    return calls


@pytest.mark.parametrize("members,warns", [(4, False), (8, True)])
def test_the_host_pixel_population_verdicts_at_a_million_rows(monkeypatch, caplog, members,
                                                              warns):
    """The host pixel population at the CLI's 10^6 rows per member:
    4 members need ~24.7 GB, under half of an H100's 79.18 GiB (no
    warning); 8 need ~49.3 GB (warns)."""
    calls = _patched_card(monkeypatch)
    shape = RINGS["pixel"][0]
    with caplog.at_level(logging.WARNING, logger=replay.logger.name):
        replay.warn_if_buffer_exceeds_hbm(10**6 * members, shape, 1, "cuda",
                                          advice="reduce --buffer-size or --population")
    assert calls == [torch.device("cuda")]
    assert ("reduce --buffer-size or --population" in caplog.text) is warns


def test_the_warning_is_a_noop_on_the_cpu(monkeypatch, caplog):
    calls = _patched_card(monkeypatch, total=1)
    with caplog.at_level(logging.WARNING, logger=replay.logger.name):
        replay.warn_if_buffer_exceeds_hbm(10**6, (3,), 1, "cpu")
    assert calls == [] and not caplog.text


def test_every_ring_allocation_site_warns_first(monkeypatch):
    """The solo trainer (``buffer_size``), the host population
    (``buffer_size · P``) and both on-device loops ask before they
    allocate."""
    from torch_actor_critic_tpu_torch.envs.ondevice import get_on_device_env
    from torch_actor_critic_tpu_torch.parallel import population
    from torch_actor_critic_tpu_torch.sac import ondevice, trainer

    seen = []

    def record(capacity, obs_shape, act_dim, device=None, advice=""):
        seen.append((capacity, advice))

    for mod in (trainer, ondevice, population):
        monkeypatch.setattr(mod, "warn_if_buffer_exceeds_hbm", record)
    cfg = SACConfig(hidden_sizes=(8,), buffer_size=300)
    Trainer("PendulumNumpy-v1", cfg, device="cpu").close()
    Trainer("PendulumNumpy-v1", SACConfig(hidden_sizes=(8,), buffer_size=300, population=3),
            device="cpu").close()
    env = get_on_device_env("Pendulum-v1")
    ondevice.OnDeviceLoop(trainer.make_learner(cfg, env.act_dim), env, n_envs=2,
                          device="cpu").init(0, buffer_capacity=200)
    pop = make_population_learner(cfg, env.act_dim, 2)
    ondevice.PopulationOnDeviceLoop(pop, env, 2, n_envs=2, device="cpu").init(
        0, buffer_capacity=100)
    assert [c for c, _ in seen] == [300, 900, 200, 200]
    assert "population" in seen[1][1] and "population" in seen[3][1]
