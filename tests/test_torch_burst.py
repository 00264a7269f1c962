"""The port's update burst as the CUDA graph captures it, on the CPU.

On the card ``SAC.update_burst`` captures one update (``update_step``:
sample, critic, actor and α steps, polyak, and the write of its metrics
at a device counter) and replays it; the CPU runs the eager loop. Here
the captured body runs eagerly for K steps and must equal the eager
burst bitwise: parameters, Adam states, metrics and the generator. The
ring's device size, which the graph reads at replay time, is checked
across pushes and wraps, and the capture-safe row draw for range and
uniformity. The eager burst against the JAX burst stays in
``tests/test_torch_sac.py`` and ``tests/test_torch_visual.py``; the
graph itself runs on the card (``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest
import torch

from torch_actor_critic_tpu_torch.buffer import replay
from torch_actor_critic_tpu_torch.core.types import Batch, MultiObservation
from torch_actor_critic_tpu_torch.models import build_models
from torch_actor_critic_tpu_torch.sac.algorithm import SAC, update_step
from torch_actor_critic_tpu_torch.sac.graph import BurstGraph, MetricStack
from torch_actor_critic_tpu_torch.utils.config import SACConfig

BATCH, ACT_DIM, CAPACITY = 8, 2, 64
CASES = {
    # name: (config overrides, observation shape)
    "flat": (dict(hidden_sizes=(32, 32)), (3,)),
    "sequence": (dict(history_len=4, seq_d_model=16, seq_num_heads=2, seq_num_layers=1,
                      learn_alpha=True), (4, 3)),
    "visual-fused": (dict(filters=(8, 16), kernel_sizes=(4, 3), strides=(2, 2),
                          cnn_dense_size=32, cnn_features=16, normalize_pixels=True,
                          hidden_sizes=(32, 32), frame_augment="shift", learn_alpha=True,
                          pixel_pipeline="fused"),
                     MultiObservation((2,), (16, 16, 3))),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny ops: one intra-op thread avoids the oversubscription of
    several test workers each spinning a full thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chunk(shape, n, seed):
    rng = np.random.default_rng(seed)

    def obs():
        if isinstance(shape, MultiObservation):
            return MultiObservation(
                torch.from_numpy(rng.standard_normal((n, *shape.features)).astype(np.float32)),
                torch.from_numpy(rng.integers(0, 256, (n, *shape.frame), dtype=np.uint8)))
        return torch.from_numpy(rng.standard_normal((n, *shape)).astype(np.float32))

    return Batch(
        states=obs(),
        actions=torch.from_numpy(rng.uniform(-2, 2, (n, ACT_DIM)).astype(np.float32)),
        rewards=torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
        next_states=obs(),
        done=torch.from_numpy((rng.uniform(size=n) < 0.25).astype(np.float32)),
    )


def _ring(shape):
    if isinstance(shape, MultiObservation):
        return replay.init_visual_replay_buffer(CAPACITY, shape.features[0], shape.frame,
                                                ACT_DIM, "cpu")
    return replay.init_replay_buffer(CAPACITY, shape, ACT_DIM, "cpu")


def _learner(name):
    """The SAC learner of case ``name`` and a ring holding 40 rows, from
    fixed seeds: two calls build equal learners."""
    overrides, shape = CASES[name]
    cfg = SACConfig(batch_size=BATCH, **overrides)
    sac = SAC(cfg, ACT_DIM)
    actor, critic = build_models(cfg, shape, ACT_DIM, 2.0,
                                 generator=torch.Generator().manual_seed(0))
    state = sac.init_state(actor, critic, torch.Generator().manual_seed(1))
    return sac, state, replay.push(_ring(shape), _chunk(shape, 40, seed=2))


def _opt_states(opt):
    return [opt.state[p] for group in opt.param_groups for p in group["params"]]


def _assert_same_learner(a, b):
    for part in ("actor", "critic", "target_critic"):
        theirs = dict(getattr(b, part).named_parameters())
        for n, p in getattr(a, part).named_parameters():
            assert torch.equal(p, theirs[n]), (part, n)
    assert torch.equal(a.log_alpha, b.log_alpha)
    for opt in ("pi_opt", "q_opt", "alpha_opt"):
        for sa, sb in zip(_opt_states(getattr(a, opt)), _opt_states(getattr(b, opt)), strict=True):
            assert sa.keys() == sb.keys(), opt
            for k in sa:
                assert torch.equal(torch.as_tensor(sa[k]), torch.as_tensor(sb[k])), (opt, k)
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


# ----------------------------------------------------------- device size


@pytest.mark.parametrize("name", ["flat", "visual-fused"])
def test_push_fills_the_device_size_in_place_across_wrap(name):
    shape = CASES[name][1]
    buf = _ring(shape)
    size_t = buf.device_size
    ptr = size_t.data_ptr()
    assert size_t.dtype == torch.int64 and size_t.dim() == 0 and int(size_t) == 0
    pushed = 0
    for i, n in enumerate((20, 30, 40, 64, 5)):  # wraps at 64, 128; one full-ring chunk
        buf = replay.push(buf, _chunk(shape, n, seed=10 + i))
        pushed += n
        assert buf.device_size is size_t and size_t.data_ptr() == ptr
        assert int(size_t) == buf.size == min(pushed, CAPACITY)
        assert buf.ptr == pushed % CAPACITY


# ------------------------------------------------------------- row draws


def test_draw_rows_stay_in_range_after_pushes_and_wraps():
    buf = _ring((3,))
    gen = torch.Generator().manual_seed(0)
    for i, n in enumerate((1, 4, 30, 40, 64, 9)):
        buf = replay.push(buf, _chunk((3,), n, seed=i))
        rows = replay.draw_rows(buf, 4096, gen)
        assert rows.dtype == torch.int64 and rows.shape == (4096,)
        assert int(rows.min()) >= 0 and int(rows.max()) < buf.size
        if buf.size > 1:
            assert int(rows.max()) == buf.size - 1  # the top row is reachable


def test_draw_rows_repeat_from_one_generator_state():
    buf = replay.push(_ring((3,)), _chunk((3,), 50, seed=0))
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    first = replay.draw_rows(buf, 256, gen)
    gen.set_state(state)
    assert torch.equal(replay.draw_rows(buf, 256, gen), first)
    drawn = replay.sample(buf, 256, generator=gen.set_state(state))
    assert torch.equal(drawn.rewards, buf.data.rewards[first])


def test_draw_rows_are_roughly_uniform():
    """A loose chi-square over 50 rows from 100k draws: the statistic has
    49 degrees of freedom (mean 49, sd 9.9); 100 is beyond p = 1e-5."""
    buf = replay.push(_ring((3,)), _chunk((3,), 50, seed=0))
    rows = replay.draw_rows(buf, 100_000, torch.Generator().manual_seed(7))
    counts = torch.bincount(rows, minlength=50).double()
    assert counts.shape == (50,)
    expected = rows.numel() / 50
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 100.0, chi2


# ------------------------------------------------ the captured body, eager


@pytest.mark.parametrize("name", list(CASES))
def test_captured_body_run_eagerly_equals_the_eager_burst_bitwise(name):
    """``update_step`` — what the CUDA graph holds — run K times with a
    ``MetricStack`` equals the eager burst loop from the same state and
    generator: parameters, Adam states, log α, step, generator and the
    reduced metrics, bitwise."""
    k = 3
    shape = CASES[name][1]
    chunk = _chunk(shape, 30, seed=3)  # wraps: 40 + 30 > 64
    sac, eager, buf_e = _learner(name)
    eager, buf_e, want = sac.update_burst(eager, buf_e, chunk, k)

    sac_b, body, buf_b = _learner(name)
    buf_b = replay.push(buf_b, chunk)
    stack = MetricStack(k, "cpu")
    for _ in range(k):
        update_step(sac_b.update, sac_b.config, body, buf_b, stack)
    assert int(stack.step) == k
    got = stack.reduce()

    _assert_same_learner(body, eager)
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert (buf_b.ptr, buf_b.size, int(buf_b.device_size)) == (buf_e.ptr, buf_e.size, buf_e.size)


def test_metric_stack_writes_rows_at_its_counter():
    stack = MetricStack(3, "cpu")
    for i in range(3):
        stack.write({"loss_q": torch.tensor(float(i + 1)), "x_max": torch.tensor(float(-i))})
    assert torch.equal(stack.rows["loss_q"], torch.tensor([1.0, 2.0, 3.0]))
    out = stack.reduce()
    assert float(out["loss_q"]) == 2.0 and float(out["x_max"]) == 0.0
    stack.step.zero_()
    stack.write({"loss_q": torch.tensor(9.0), "x_max": torch.tensor(0.0)})
    assert torch.equal(stack.rows["loss_q"], torch.tensor([9.0, 2.0, 3.0]))


# ------------------------------------------------------ state, dispatch


def test_cloned_learner_and_ring_run_the_same_burst_apart():
    """``TrainState.clone`` and ``BufferState.clone`` give copies that share
    no tensor with the original and run the same burst to the same bits:
    the captured-versus-eager comparison on the card starts from them."""
    sac, state, buf = _learner("sequence")
    state, buf, _ = sac.update_burst(state, buf, _chunk((4, 3), 10, seed=4), 2)
    twin, twin_buf = state.clone(), buf.clone()
    assert twin.generator is not state.generator
    assert twin_buf.device_size is not buf.device_size
    ours = {p.data_ptr() for p in (*state.actor.parameters(), *state.critic.parameters())}
    assert not ours & {p.data_ptr() for p in (*twin.actor.parameters(), *twin.critic.parameters())}
    for opt, module in ((twin.q_opt, twin.critic), (twin.pi_opt, twin.actor)):
        params = [p for group in opt.param_groups for p in group["params"]]
        assert all(a is b for a, b in zip(params, module.parameters(), strict=True))
        assert all(p in opt.state for p in params)
    chunk = _chunk((4, 3), 10, seed=5)
    state, buf, m = sac.update_burst(state, buf, chunk, 3)
    twin, twin_buf, m_twin = sac.update_burst(twin, twin_buf, chunk, 3)
    _assert_same_learner(twin, state)
    assert all(torch.equal(m[k], m_twin[k]) for k in m)
    assert all(torch.equal(a, b) for a, b in zip(buf.data.leaves(), twin_buf.data.leaves()))


def test_adam_stays_the_plain_one_on_the_cpu():
    _, state, _ = _learner("flat")
    for opt in (state.pi_opt, state.q_opt, state.alpha_opt):
        assert opt.defaults["capturable"] is False


def test_eager_keyword_on_the_cpu_runs_the_same_eager_loop():
    """On the CPU every burst is the eager loop: ``eager=True`` changes
    nothing there and builds no graph."""
    sac, state, buf = _learner("flat")
    twin, twin_buf = state.clone(), buf.clone()
    chunk = _chunk((3,), 4, seed=6)
    state, buf, m = sac.update_burst(state, buf, chunk, 2)
    twin, twin_buf, m_twin = sac.update_burst(twin, twin_buf, chunk, 2, eager=True)
    _assert_same_learner(twin, state)
    assert all(torch.equal(m[k], m_twin[k]) for k in m)
    assert state.step == 2 and sac.graph is None and sac.graph_captures == 0


def test_burst_graph_serves_only_its_own_objects_and_length():
    a, b = object(), object()
    graph = BurstGraph(lambda stack: None, (a, b), 4, torch.Generator())
    assert graph.serves((a, b), 4)
    assert not graph.serves((a, b), 5)
    assert not graph.serves((a, object()), 4)
    assert not graph.serves((a,), 4)
    with pytest.raises(ValueError, match="num_updates"):
        BurstGraph(lambda stack: None, (a,), 0, torch.Generator())
