"""The port's cost model (``telemetry/costmodel.py``) on the CPU.

``classify_epoch`` and ``roofline`` against the JAX package's on the same
inputs (exact: the same float arithmetic); the card's peaks by name and
the environment overrides; the kernels' formulas against the visible
(q, k) pairs; and the counted cost of one SAC update on the sequence
policy: the same FLOPs and bytes whatever the kernels' plain versions
compute inside (their ATen ops are not counted: the kernels report their
work by formula), causal attention counting the visible pairs only, and
the FLOPs equal to an analytic count from the widths (exact: integer
products).
"""

import numpy as np
import pytest
import torch

from torch_actor_critic_tpu.telemetry import costmodel as jcost
from torch_actor_critic_tpu_torch.buffer import replay
from torch_actor_critic_tpu_torch.core.types import Batch
from torch_actor_critic_tpu_torch.models import build_models
from torch_actor_critic_tpu_torch.ops import attention as attn
from torch_actor_critic_tpu_torch.ops import pixels
from torch_actor_critic_tpu_torch.sac.algorithm import SAC
from torch_actor_critic_tpu_torch.telemetry import costmodel
from torch_actor_critic_tpu_torch.utils.config import SACConfig

B, T, OBS, ACT, D, H, L, Q = 8, 6, 3, 2, 16, 2, 2, 2
HIDDEN = 256  # the sequence critic's head width (models/sequence.py)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PHASE_CASES = [
    ({"act": {"total_s": 1.0}, "env_step": {"total_s": 2.0}, "drain": {"total_s": 0.5}}, 4.0),
    ({"burst_dispatch": {"total_s": 3.0}, "drain": {"total_s": 2.5}, "stage": {"total_s": 0.1},
      "place_chunk": {"total_s": 0.2}, "sentinel": {"total_s": 0.01}}, 6.0),
    ({"stage": {"total_s": 5.0}, "checkpoint": {"total_s": 1.0}, "unknown": {"total_s": 9.0}},
     7.0),
]


@pytest.mark.parametrize("phases,wall", PHASE_CASES)
def test_classify_epoch_matches_jax(phases, wall):
    assert costmodel.classify_epoch(phases, wall) == jcost.classify_epoch(phases, wall)
    assert costmodel.PHASE_PLANES == jcost.PHASE_PLANES


@pytest.mark.parametrize("cost,duration,calls,peaks", [
    ({"flops": 3.0e9, "bytes_accessed": 2.0e8}, 0.5, 4, (989e12, 3.35e12)),
    ({"flops": 1.5e7, "bytes_accessed": 9.0e8}, 0.01, 1, (67e12, 3.35e12)),
    ({"flops": 2.0e6, "bytes_accessed": 0.0}, 1.0, 2, (None, None)),
    ({"flops": 5.0e9, "bytes_accessed": 1.0e9}, 0.0, 3, (1e12, None)),
])
def test_roofline_matches_jax(cost, duration, calls, peaks):
    got = costmodel.roofline(cost, duration, calls=calls, peaks=costmodel.Peaks(*peaks),
                             compute_dtype="float32")
    want = jcost.roofline(cost, duration, calls=calls, peaks=jcost.Peaks(*peaks),
                          compute_dtype="float32")
    assert got == want


def test_peaks_by_card_name_and_overrides(monkeypatch):
    monkeypatch.delenv("TAC_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("TAC_PEAK_BW", raising=False)
    name = "NVIDIA H100 80GB HBM3"
    assert costmodel.peak_flops_for(name, "bfloat16") == 989e12
    assert costmodel.peak_flops_for(name, "float32") == 67e12
    assert costmodel.peak_hbm_bw_for(name) == 3.35e12
    assert costmodel.card_peaks(name).f32_3xtf32 == 495e12 / 3  # the kernels' f32 route
    for unknown in (None, "cpu", "NVIDIA A100-SXM4-80GB"):
        assert costmodel.peak_flops_for(unknown) is None
        assert costmodel.peak_hbm_bw_for(unknown) is None
    assert costmodel.Peaks.detect("float32") == costmodel.Peaks(None, None, None)  # no card
    monkeypatch.setenv("TAC_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("TAC_PEAK_BW", "2e11")
    assert costmodel.peak_flops_for(None) == 1e12 and costmodel.peak_hbm_bw_for(None) == 2e11
    assert costmodel.card_peaks(name).bf16 == 989e12  # the table: no overrides


@pytest.mark.parametrize("tq,tk,causal", [(16, 16, True), (16, 16, False), (5, 9, True),
                                          (9, 5, True), (1, 1, True)])
def test_attention_formulas_count_the_visible_pairs(tq, tk, causal):
    pairs = sum(1 for i in range(tq) for j in range(tk) if not causal or j <= i)
    b, h, d = 3, 2, 16
    flops, nbytes = costmodel.attention_fwd_work((b, h, tq, tk, d), causal, torch.float32)
    assert flops == 4 * d * pairs * b * h
    assert nbytes == 4 * b * h * d * (2 * tq + 2 * tk)
    dq, _ = costmodel.attention_bwd_work((b, h, tq, tk, d), causal, torch.bfloat16,
                                         "flash_bwd_dq")
    dkv, _ = costmodel.attention_bwd_work((b, h, tq, tk, d), causal, torch.bfloat16,
                                          "flash_bwd_dkv")
    assert dq == 6 * d * pairs * b * h + 2 * d * b * h * tq
    assert dkv == 8 * d * pairs * b * h


def test_pixel_formula_counts_bytes_only():
    flops, nbytes = costmodel.pixel_gather_work(4, (8, 8, 3), 2, torch.bfloat16, True, leaves=2)
    elems = 4 * 2 * 8 * 8 * 3
    assert flops == 0 and nbytes == 8 * 4 + 2 * (elems + 8 * 4 + 2 * elems)


def test_wrappers_report_by_formula_and_hide_their_own_ops():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, H, T, D // H, generator=g, requires_grad=True) for _ in range(3))
    with costmodel.CostCount() as count:
        attn.attention(q, k, v, causal=True).sum().backward()
    c = count.cost()
    assert c["kernels"] == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    assert c["aten_flops"] == 0  # the plain versions' products are not counted
    shape = (B, H, T, T, D // H)
    assert c["kernel_flops"] == sum(
        f(shape, True, torch.float32, *extra)[0]
        for f, extra in ((costmodel.attention_fwd_work, (True,)),
                         (costmodel.attention_bwd_work, ("flash_bwd_dq",)),
                         (costmodel.attention_bwd_work, ("flash_bwd_dkv",))))
    ring = torch.randint(0, 256, (20, 8, 8, 3), dtype=torch.uint8, generator=g)
    idx = torch.randint(0, 20, (5,), generator=g)
    with costmodel.CostCount() as count:
        pixels.fused_frame_gather_pair([ring, ring], idx, normalize=True)
    c = count.cost()
    assert c["kernels"] == {"pixel_gather": 1} and c["aten_bytes"] == 0
    assert c["kernel_bytes"] == costmodel.pixel_gather_work(5, (8, 8, 3), 1, torch.float32,
                                                            False, leaves=2)[1]
    with costmodel.CostCount() as count:
        (q @ k.transpose(-1, -2)).sum()
    assert count.cost()["aten_flops"] == 2 * B * H * T * T * (D // H)


def _sequence_update():
    cfg = SACConfig(history_len=T, seq_d_model=D, seq_num_heads=H, seq_num_layers=L,
                    num_qs=Q, batch_size=B, learn_alpha=True)
    actor, critic = build_models(cfg, (T, OBS), ACT, 2.0,
                                 generator=torch.Generator().manual_seed(0))
    sac = SAC(cfg, ACT)
    state = sac.init_state(actor, critic, torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    chunk = Batch(states=torch.randn(32, T, OBS, generator=g),
                  actions=torch.rand(32, ACT, generator=g) * 4 - 2,
                  rewards=torch.randn(32, generator=g),
                  next_states=torch.randn(32, T, OBS, generator=g), done=torch.zeros(32))
    buf = replay.init_replay_buffer(64, (T, OBS), ACT, "cpu")
    registry = costmodel.get_cost_registry()
    registry.reset()
    sac.cost.request("train/update")
    sac.update_burst(state, buf, chunk, 2)
    assert sac.cost.name is None  # counted once
    return registry.get("train/update")


def _analytic_sequence_update_flops() -> int:
    """The FLOPs of one SAC update on the sequence policy from its widths:
    every dense layer's product (2·rows·in·out, and as much again for each
    of its input and weight gradients that autograd takes) and the
    attention kernels' products over the causal pairs."""
    n, hd, pairs = B * T, D // H, T * (T + 1) // 2

    def dense(rows, i, o):
        return 2 * rows * i * o

    def trunk(m):  # forward of m members' trunks
        return m * (dense(n, OBS, D) + L * (4 * dense(n, D, D) + 2 * dense(n, D, 4 * D))) \
            + L * 4 * hd * pairs * B * m * H

    def trunk_backward(m):  # weight and input gradients; none into the observations
        weights = m * (dense(n, OBS, D) + L * (4 * dense(n, D, D) + 2 * dense(n, D, 4 * D)))
        inputs = m * L * (4 * dense(n, D, D) + 2 * dense(n, D, 4 * D))
        return weights + inputs + L * (14 * hd * pairs + 2 * hd * T) * B * m * H

    actor_head = 2 * dense(B, D, ACT)
    critic_head = Q * (dense(B, D + ACT, HIDDEN) + dense(B, HIDDEN, 1))
    backup = trunk(1) + actor_head + trunk(Q) + critic_head       # no grad
    critic_step = trunk(Q) + critic_head + trunk_backward(Q) + 2 * critic_head
    # The actor step's critic is frozen: its trunk runs forward only, its
    # head passes the action's gradient back.
    actor_step = trunk(1) + actor_head + trunk(Q) + critic_head + critic_head \
        + trunk_backward(1) + 2 * actor_head
    return backup + critic_step + actor_step


def test_sequence_update_cost_is_route_independent_and_analytic(monkeypatch):
    base = _sequence_update()
    assert base["kernels"] == {"flash_fwd": 4 * L + L, "flash_bwd_dq": 2 * L,
                               "flash_bwd_dkv": 2 * L}
    assert base["flops"] == _analytic_sequence_update_flops()
    assert base["flops"] == base["aten_flops"] + base["kernel_flops"]

    # Plain versions that compute the same results through other ops (the
    # full score matrix, extra copies): the count does not move.
    def fwd(q, k, v, causal, scale):
        out, lse = attn.reference_attention(q, k, v, causal=causal, return_lse=True)
        return out.clone() * 1.0, lse.clone()

    plain_dq = attn._plain_flash_bwd_dq

    def bwd_dq(q, k, v, o, do, lse, causal, scale):
        dq, delta = plain_dq(q, k, v, o, do, lse, causal, scale)
        return (dq @ torch.eye(dq.shape[-1])), delta + 0.0

    monkeypatch.setattr(attn, "_plain_flash_fwd", fwd)
    monkeypatch.setattr(attn, "_plain_flash_bwd_dq", bwd_dq)
    other = _sequence_update()
    for key in ("flops", "bytes_accessed", "aten_flops", "aten_bytes", "kernel_flops",
                "kernel_bytes", "ops", "kernels"):
        assert other[key] == base[key], key
    np.testing.assert_array_less(0, base["bytes_accessed"])


def _counted_update(cfg, obs_shape, members):
    """The counted cost of one update (its batch's sampling included) of a
    lone learner (``members=0``) or of a member-stacked population."""
    from torch_actor_critic_tpu_torch.parallel.population import PopulationLearner
    from torch_actor_critic_tpu_torch.sac.population import make_population_learner
    from torch_actor_critic_tpu_torch.sac.trainer import make_learner

    g = torch.Generator().manual_seed(2)
    lead = (members, 32) if members else (32,)
    chunk = Batch(states=torch.randn(*lead, *obs_shape, generator=g),
                  actions=torch.rand(*lead, ACT, generator=g) * 4 - 2,
                  rewards=torch.randn(*lead, generator=g),
                  next_states=torch.randn(*lead, *obs_shape, generator=g),
                  done=torch.zeros(lead))
    if members:
        pop = PopulationLearner(make_population_learner(cfg, ACT, members), members)
        learner = pop.learner
        state = pop.init_state(0, obs_shape, ACT, 2.0, torch.device("cpu"))
        buf = pop.init_buffer(64, obs_shape, ACT, torch.device("cpu"))
    else:
        learner = make_learner(cfg, ACT)
        actor, critic = build_models(cfg, obs_shape, ACT, 2.0,
                                     generator=torch.Generator().manual_seed(0))
        state = learner.init_state(actor, critic, torch.Generator().manual_seed(1))
        buf = replay.init_replay_buffer(64, obs_shape, ACT, "cpu")
    registry = costmodel.get_cost_registry()
    registry.reset()
    learner.cost.request("train/update")
    learner.update_burst(state, buf, chunk, 2)
    return registry.get("train/update")


@pytest.mark.parametrize("name", ["flat-sac", "sequence-sac", "flat-td3"])
def test_stacked_update_counts_every_member(name):
    """One stacked update of a population of 3 counts 3 times the FLOPs of
    one lone learner's update at the same widths (within 1%): the cost a
    population's ``train/update`` registers is every member's work, K2–K4
    at their folded shapes included."""
    over = {"flat-sac": dict(hidden_sizes=(32, 32), learn_alpha=True),
            "sequence-sac": dict(history_len=T, seq_d_model=D, seq_num_heads=H,
                                 seq_num_layers=L, learn_alpha=True),
            "flat-td3": dict(hidden_sizes=(32, 32), algorithm="td3")}[name]
    obs_shape = (T, OBS) if "history_len" in over else (OBS,)
    solo = _counted_update(SACConfig(num_qs=Q, batch_size=B, **over), obs_shape, 0)
    pop = _counted_update(SACConfig(num_qs=Q, batch_size=B, population=3, **over),
                          obs_shape, 3)
    assert solo["flops"] > 0
    np.testing.assert_allclose(pop["flops"], 3 * solo["flops"], rtol=0.01)
    if "history_len" in over:
        assert pop["kernels"] == solo["kernels"]  # one launch a layer for all members
        np.testing.assert_allclose(pop["kernel_flops"], 3 * solo["kernel_flops"], rtol=0.01)
