"""The port's learning-health diagnostics against the JAX package's, on
the CPU: the in-graph metrics of one SAC, one TD3 (a skipped and an
applied policy step) and one fused visual SAC update at
``diagnostics="full"``, ``diag/param_norm`` after a burst, the |TD|
histogram's buckets, the suffix reductions, the early-warning monitor on
the JAX tests' scripted streams, and the watchdog's counts.

JAX's ``TrainState`` (params and optax Adam states) is carried into the
port by ``weights.py``; batches are numpy from a seed, and the noise JAX
draws from its keys is injected. Tolerances: gradient and parameter
norms, Q statistics and saturation rtol 1e-5 (f32 summation order);
update ratios rtol 1e-4 (optax and torch.optim order Adam's float ops
differently); the |TD| histogram, the suffix reductions and the monitor
exact. ``off`` keeps the historical keys, and ``light``/``full`` leave
the parameters bitwise those of ``off``.
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
from torch_actor_critic_tpu.core.types import MultiObservation as JMultiObservation
from torch_actor_critic_tpu.diagnostics import ingraph as jdiag
from torch_actor_critic_tpu.diagnostics import monitor as jmonitor
from torch_actor_critic_tpu.sac.algorithm import run_update_burst as j_run_update_burst
from torch_actor_critic_tpu.sac.trainer import build_models as j_build_models
from torch_actor_critic_tpu.sac.trainer import make_learner as j_make_learner
from torch_actor_critic_tpu.utils.config import SACConfig as JSACConfig
from torch_actor_critic_tpu_torch.buffer import replay
from torch_actor_critic_tpu_torch.core.types import Batch, MultiObservation
from torch_actor_critic_tpu_torch.diagnostics import ingraph as diag
from torch_actor_critic_tpu_torch.diagnostics import monitor
from torch_actor_critic_tpu_torch.diagnostics.watchdog import RecompilationWatchdog
from torch_actor_critic_tpu_torch.models import build_models
from torch_actor_critic_tpu_torch.resilience.sentinel import DivergenceSentinel
from torch_actor_critic_tpu_torch.sac.trainer import make_learner
from torch_actor_critic_tpu_torch.utils.config import SACConfig
from torch_actor_critic_tpu_torch.weights import train_state_from_jax

OBS_DIM, ACT_DIM, ACT_LIMIT, BATCH = 3, 2, 2.0, 16
PIXEL = dict(filters=(16, 32), kernel_sizes=(4, 3), strides=(2, 2), cnn_dense_size=128,
             cnn_features=64, normalize_pixels=True, frame_augment="shift",
             pixel_pipeline="fused", hidden_sizes=(32, 32))
CASES = {
    # name: (config overrides, obs shape: (obs_dim,) or (features, frame), act dim)
    "sac": (dict(hidden_sizes=(32, 32), learn_alpha=True), (OBS_DIM,), ACT_DIM),
    "td3": (dict(hidden_sizes=(32, 32), algorithm="td3", policy_delay=2), (OBS_DIM,), ACT_DIM),
    "visual": (dict(PIXEL, learn_alpha=True), (1, (32, 32, 3)), 1),
}
NORMS = ("diag/grad_norm_q", "diag/grad_norm_pi", "diag/grad_norm_alpha", "diag/q_min",
         "diag/q_max", "diag/q_spread", "diag/q_bias", "diag/act_sat", "diag/td_abs_min",
         "diag/td_abs_max", "diag/td_abs_sum", "loss_q_max", "loss_pi_max", "diag/param_norm")
RATIOS = ("diag/update_ratio_q", "diag/update_ratio_pi", "diag/update_ratio_alpha")
# The metric keys of an update at "off" (the historical set).
OFF_KEYS = {
    "sac": {"loss_q", "loss_pi", "alpha", "q_mean", "backup_mean", "logp_pi", "entropy"},
    "td3": {"loss_q", "loss_pi", "q_mean", "backup_mean", "q_pi_mean"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _visual(name):
    return name == "visual"


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    overrides, shape, act_dim = CASES[name]
    jcfg = JSACConfig(batch_size=BATCH, diagnostics="full", **overrides)
    if _visual(name):
        feat, frame = shape
        spec = JMultiObservation(features=jax.ShapeDtypeStruct((feat,), jnp.float32),
                                 frame=jax.ShapeDtypeStruct(frame, jnp.uint8))
        example = JMultiObservation(features=jnp.zeros((feat,)), frame=jnp.zeros(frame, jnp.uint8))
    else:
        spec, example = jax.ShapeDtypeStruct(shape, jnp.float32), jnp.zeros(shape)
    env = types.SimpleNamespace(obs_spec=spec, act_dim=act_dim, act_limit=ACT_LIMIT)
    actor_def, critic_def = j_build_models(jcfg, env)
    learner = j_make_learner(jcfg, actor_def, critic_def, act_dim)
    state = jax.jit(learner.init_state)(jax.random.PRNGKey(0), example)
    return learner, state, jax.jit(learner.update)


def _port(name, tier="full"):
    """The port's learner at ``tier`` over JAX's initial state."""
    overrides, shape, act_dim = CASES[name]
    cfg = SACConfig(batch_size=BATCH, diagnostics=tier, **overrides)
    port_shape = MultiObservation(features=(shape[0],), frame=shape[1]) if _visual(name) else shape
    learner = make_learner(cfg, act_dim)
    actor, critic = build_models(cfg, port_shape, act_dim, ACT_LIMIT)
    ts = train_state_from_jax(jax.tree_util.tree_map(np.asarray, _jax_case(name)[1]), learner,
                              actor, critic, torch.Generator())
    return learner, ts


def _obs(name, n, seed):
    rng = np.random.default_rng(seed)
    shape = CASES[name][1]
    if not _visual(name):
        return rng.standard_normal((n, *shape)).astype(np.float32)
    feat, frame = shape
    frames = rng.integers(0, 256, (n, *frame), dtype=np.uint8)
    return dict(features=rng.standard_normal((n, feat)).astype(np.float32),
                frame=frames.astype(np.float32) / np.float32(255))  # decoded, as fused


def _batch(name, n=BATCH, seed=0):
    act_dim = CASES[name][2]
    rng = np.random.default_rng(seed + 1000)
    return dict(states=_obs(name, n, seed),
                actions=rng.uniform(-ACT_LIMIT, ACT_LIMIT, (n, act_dim)).astype(np.float32),
                rewards=(3 * rng.standard_normal(n)).astype(np.float32),
                next_states=_obs(name, n, seed + 1),
                done=(rng.uniform(size=n) < 0.25).astype(np.float32))


def _jbatch(b):
    def obs(o):
        return JMultiObservation(**o) if isinstance(o, dict) else o
    return JBatch(states=obs(b["states"]), actions=b["actions"], rewards=b["rewards"],
                  next_states=obs(b["next_states"]), done=b["done"])


def _tbatch(b):
    def obs(o):
        if isinstance(o, dict):
            return MultiObservation(torch.from_numpy(o["features"]), torch.from_numpy(o["frame"]))
        return torch.from_numpy(o)
    return Batch(states=obs(b["states"]), actions=torch.from_numpy(b["actions"]),
                 rewards=torch.from_numpy(b["rewards"]), next_states=obs(b["next_states"]),
                 done=torch.from_numpy(b["done"]))


def _noise(name, rng):
    """``(next rng, update kwargs)``: the noise JAX's update draws."""
    act_dim = CASES[name][2]
    if CASES[name][0].get("algorithm") == "td3":
        rng, key_q = jax.random.split(rng)
        return rng, {"eps_q": torch.from_numpy(np.array(
            jax.random.normal(key_q, (BATCH, act_dim))))}
    rng, key_q, key_pi = jax.random.split(rng, 3)
    eps = [torch.from_numpy(np.array(jax.random.normal(k, (BATCH, act_dim))))
           for k in (key_q, key_pi)]
    return rng, {"eps_q": eps[0], "eps_pi": eps[1]}


def _assert_diagnostics_match(tm, jm, what=""):
    for k in NORMS:
        if k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{what}{k}")
    for k in RATIOS:
        if k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-9,
                                       err_msg=f"{what}{k}")
    np.testing.assert_array_equal(np.asarray(tm["diag/td_hist"]), np.asarray(jm["diag/td_hist"]))


@pytest.mark.parametrize("name", ["sac", "td3", "visual"])
def test_update_diagnostics_match_jax(name):
    """Each in-graph diagnostic of an update at "full" (for TD3 a skipped,
    then an applied policy step) against JAX's."""
    _, state, update = _jax_case(name)
    learner, ts = _port(name)
    rng = state.rng
    for i in range(2 if name == "td3" else 1):
        b = _batch(name, seed=5 + i)
        state, jm = update(state, _jbatch(b))
        rng, noise = _noise(name, rng)
        ts, tm = learner.update(ts, _tbatch(b), **noise)
        assert set(tm) == set(jm)
        _assert_diagnostics_match(tm, jm, f"{name} update {i}: ")
        assert int(np.asarray(jm["diag/td_hist"]).sum()) == BATCH * learner.config.num_qs


def test_burst_param_norm_and_metrics_match_jax():
    name = "sac"
    learner_j, state, _ = _jax_case(name)
    capacity = 64
    spec = jax.ShapeDtypeStruct((OBS_DIM,), jnp.float32)
    prefill = _batch(name, n=40, seed=6)
    jbuf = jreplay.push(jreplay.init_replay_buffer(capacity, spec, ACT_DIM), _jbatch(prefill))
    chunk = _batch(name, n=20, seed=8)
    burst = jax.jit(lambda s, buf, c: j_run_update_burst(
        learner_j.update, learner_j.config, s, buf, c, 3))
    new, _, jm = burst(state, jbuf, _jbatch(chunk))

    rng, indices, eps = state.rng, [], []
    for _ in range(3):
        rng, sample_key = jax.random.split(rng)
        indices.append(np.asarray(jax.random.randint(sample_key, (BATCH,), 0, 60)))
        rng, noise = _noise(name, rng)
        eps.append(torch.stack([noise["eps_q"], noise["eps_pi"]]))
    learner, ts = _port(name)
    buf = replay.push(replay.init_replay_buffer(capacity, (OBS_DIM,), ACT_DIM, "cpu"),
                      _tbatch(prefill))
    ts, buf, tm = learner.update_burst(ts, buf, _tbatch(chunk), 3,
                                       indices=torch.from_numpy(np.stack(indices)),
                                       eps=torch.stack(eps))
    assert set(tm) == set(jm)
    _assert_diagnostics_match(tm, jm, "burst: ")
    assert int(np.asarray(tm["diag/td_hist"]).sum()) == 3 * BATCH * 2


def _bursts(name, tier, n_bursts=2, updates=4):
    learner, ts = _port(name, tier)
    ts.generator.manual_seed(7)
    obs_shape = CASES[name][1]
    if _visual(name):
        feat, frame = obs_shape
        ring = replay.init_visual_replay_buffer(64, feat, frame, CASES[name][2], "cpu")
    else:
        ring = replay.init_replay_buffer(64, obs_shape, CASES[name][2], "cpu")
    metrics = []
    for i in range(n_bursts):
        b = _batch(name, n=20, seed=30 + i)
        if _visual(name):
            for key in ("states", "next_states"):
                b[key]["frame"] = np.round(b[key]["frame"] * 255).astype(np.uint8)
        ts, ring, m = learner.update_burst(ts, ring, _tbatch(b), updates)
        metrics.append(m)
    return ts, metrics


@pytest.mark.parametrize("name", ["sac", "td3", "visual"])
def test_tiers_only_read_off_keys_unchanged(name):
    """``off`` keeps the historical keys; ``light``/``full`` add only
    diagnostics and leave every parameter and Adam moment bitwise
    ``off``'s after two bursts."""
    off, m_off = _bursts(name, "off")
    want = OFF_KEYS["td3" if name == "td3" else "sac"]
    assert set(m_off[0]) == want
    for tier in ("light", "full"):
        st, m = _bursts(name, tier)
        extra = set(m[0]) - want
        assert all(k.startswith("diag/") or k.endswith("_max") for k in extra), extra
        assert ("diag/td_hist" in extra) == (tier == "full")
        for a, b in ((off.actor, st.actor), (off.critic, st.critic),
                     (off.target_critic, st.target_critic)):
            for x, y in zip(a.parameters(), b.parameters()):
                assert torch.equal(x, y), tier
        for opt_a, opt_b in ((off.q_opt, st.q_opt), (off.pi_opt, st.pi_opt)):
            for sa, sb in zip(opt_a.state.values(), opt_b.state.values()):
                assert all(torch.equal(sa[k], sb[k]) for k in sa)
        for x, y in zip(m_off, m):
            assert all(torch.equal(x[k], y[k]) for k in want)


def test_bucket_counts_match_jax_exactly():
    lo, growth = diag.TD_HIST_LO, diag.TD_HIST_GROWTH
    top = diag.TD_HIST_HI
    edges = np.array([0.0, lo, lo / 2, lo * growth, top, top * 0.999999, top * 10, np.inf,
                      -np.inf, np.nan, -1.0, 1.0, 1e-30], np.float32)
    rng = np.random.default_rng(0)
    spread = (rng.standard_normal(20000) * 10.0 ** rng.uniform(-5, 6, 20000)).astype(np.float32)
    for values in (edges, spread):
        want = np.asarray(jdiag.bucket_counts(jnp.asarray(values)))
        got = diag.bucket_counts(torch.from_numpy(values)).numpy()
        assert got.dtype == np.int32 and got.shape == (diag.TD_HIST_BUCKETS + 2,)
        np.testing.assert_array_equal(got, want)
    counts = diag.bucket_counts(torch.from_numpy(edges)).numpy()
    assert counts.sum() == 10  # inf, -inf and nan dropped
    assert counts[0] == 3  # 0, lo/2 and 1e-30 underflow


@pytest.mark.parametrize("members", [2, 3])
def test_member_primitives_match_the_solo_ones_per_member(members):
    """The per-member primitives of a member-stacked learner against the
    solo ones on each member's slice: the global norm, the update ratio,
    the action saturation one value per member (f32 rounding apart);
    the shared Q/TD statistics against JAX's on each member's slice, and
    the one |TD| count vector exactly the sum of JAX's per member."""
    from torch_actor_critic_tpu.sac.algorithm import _shared_diagnostics as j_shared
    from torch_actor_critic_tpu_torch.sac.algorithm import member_shared_diagnostics

    g = torch.Generator().manual_seed(members)
    shapes = [(members, 8, 5), (members, 5), (members, 2, 3, 4), (members,)]
    params = [torch.randn(s, generator=g) * 3 for s in shapes]
    before = [p - 1e-3 * torch.randn(p.shape, generator=g) for p in params]
    got = diag.member_global_norm(params)
    assert got.shape == (members,) and got.dtype == torch.float32
    got_ratio = diag.member_update_ratio(params, before)
    for i in range(members):
        np.testing.assert_allclose(float(got[i]), float(diag.global_norm([p[i] for p in params])),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            float(got_ratio[i]),
            float(diag.update_ratio([p[i] for p in params], [b[i] for b in before])), rtol=1e-5)

    cfg = SACConfig(diagnostics="full")
    q = torch.randn(members, 2, BATCH, generator=g) * 10.0 ** torch.randn(members, 2, BATCH,
                                                                          generator=g)
    backup = torch.randn(members, BATCH, generator=g) * 5
    actions = torch.randn(members, BATCH, ACT_DIM, generator=g) * ACT_LIMIT * 1.5
    loss_q, loss_pi = torch.rand(members, generator=g), torch.randn(members, generator=g)
    sat = diag.member_saturation_fraction(actions, ACT_LIMIT)
    pop = member_shared_diagnostics(cfg, loss_q, loss_pi, q, backup, actions, ACT_LIMIT)
    hist = pop.pop("diag/td_hist")
    jcfg = JSACConfig(diagnostics="full")
    solo = [{k: np.asarray(v) for k, v in j_shared(
        jcfg, *(jnp.asarray(x[i].numpy()) for x in (loss_q, loss_pi, q, backup, actions)),
        ACT_LIMIT).items()} for i in range(members)]
    np.testing.assert_array_equal(hist.numpy(), sum(s["diag/td_hist"] for s in solo))
    assert int(hist.sum()) == members * 2 * BATCH
    assert set(pop) == set(solo[0]) - {"diag/td_hist"}
    for i in range(members):
        assert float(sat[i]) == float(jdiag.saturation_fraction(
            jnp.asarray(actions[i].numpy()), ACT_LIMIT))
        for k, v in pop.items():
            assert v.shape == (members,), k
            np.testing.assert_allclose(float(v[i]), float(solo[i][k]), rtol=1e-6, atol=1e-6,
                                       err_msg=f"member {i} {k}")


def test_td_histogram_merges_into_the_shared_schema():
    hist = diag.make_td_histogram()
    jhist = jdiag.make_td_histogram()
    values = np.abs(np.random.default_rng(1).standard_normal(500)).astype(np.float32) * 5
    counts = diag.bucket_counts(torch.from_numpy(values)).numpy()
    for h in (hist, jhist):
        h.merge_counts(counts, total=float(values.sum()), vmin=float(values.min()),
                       vmax=float(values.max()))
    assert hist.snapshot(prefix="td_abs_", unit="") == jhist.snapshot(prefix="td_abs_", unit="")


def test_suffix_reductions_and_metric_rows_match_jax():
    for key in ("loss_q", "q_mean", "loss_q_max", "diag/q_min", "diag/td_hist",
                "diag/td_abs_sum", "x_min_y"):
        assert diag.reduction_for(key) == jdiag.reduction_for(key)
    stacked = {"loss_q": np.array([1.0, 3.0, 2.0], np.float32),
               "loss_q_max": np.array([1.0, 3.0, 2.0], np.float32),
               "diag/q_min": np.array([1.0, -3.0, 2.0], np.float32),
               "diag/td_abs_sum": np.array([1.5, 2.5, 3.0], np.float32),
               "diag/td_hist": np.ones((3, 4), np.int32)}
    got = diag.reduce_burst_metrics({k: torch.from_numpy(v) for k, v in stacked.items()})
    want = jdiag.reduce_burst_metrics({k: jnp.asarray(v) for k, v in stacked.items()})
    for k in stacked:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    rows = [{"a_max": np.asarray(1.0), "b": np.asarray(2.0), "h_hist": np.ones((2, 4))},
            {"a_max": np.asarray(5.0), "b": np.asarray(4.0), "h_hist": np.ones((2, 4))}]
    got, want = diag.reduce_metric_rows(rows), jdiag.reduce_metric_rows(rows)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


# The JAX tests' scripted streams (tests/test_diagnostics.py:332-390).
DRIFT_STREAMS = [
    (("grad_spike", "diag/grad_norm_q", "high", 6, 3),
     [1.0, 50.0, 1.0, 1.05, 0.95, 1.0, 100.0, 1.0]),
    (("entropy_collapse", "entropy", "low", 6, 2), [1.0, 1.0, 1.01, 0.99, 1.0, -2.0, 1.0]),
    (("q_bias_drift", "diag/q_bias", "shift", 6, 2), [-0.5, -0.5, -0.52, -0.48, -0.5, -8.0]),
    (("q_bias_drift", "diag/q_bias", "shift", 6, 2), [-0.5, -0.5, -0.52, -0.48, -0.5, 7.0]),
    (("grad_spike", "diag/grad_norm_pi", "high", 6, 3), [1.0, float("nan"), 2.0, float("inf")]),
]


@pytest.mark.parametrize("spec,stream", DRIFT_STREAMS)
def test_drift_detector_matches_jax(spec, stream):
    kind, key, direction, k, warmup = spec
    port = monitor.DriftDetector(kind, key, direction, k=k, warmup=warmup)
    ref = jmonitor.DriftDetector(kind, key, direction, k=k, warmup=warmup)
    fired = [port.update(v) for v in stream]
    assert fired == [ref.update(v) for v in stream]
    assert (port.ema, port.dev, port.n) == (ref.ema, ref.dev, ref.n)


def test_monitor_feeds_the_sentinel_as_jax_does():
    assert monitor.DEFAULT_RULES == jmonitor.DEFAULT_RULES
    port, ref = monitor.EarlyWarningMonitor(k=6, warmup=2), jmonitor.EarlyWarningMonitor(k=6,
                                                                                      warmup=2)
    sentinel = DivergenceSentinel()
    calm = {"diag/grad_norm_q": 1.0, "diag/grad_norm_pi": 1.0, "entropy": 0.5,
            "diag/q_bias": -0.1}
    for epoch in [calm] * 5 + [dict(calm, **{"diag/grad_norm_q": 500.0}),
                               {"diag/grad_norm_q": float("nan")}]:
        ws = port.update(epoch)
        assert ws == ref.update(epoch)
        for w in ws:
            sentinel.note_warning(w["kind"])
    assert port.fired_total == ref.fired_total == 1
    assert sentinel.warnings_by_kind == {"grad_spike": 1} and sentinel.consecutive == 0


def test_watchdog_counts_attributes_and_flags_a_steady_recapture():
    wd = RecompilationWatchdog()
    wd.note_capture(1.0, "train/burst")  # not installed: nothing recorded
    assert wd.snapshot()["captures_total"] == 0
    wd.install()
    wd.note_capture(0.5, "train/burst")
    wd.note_capture(0.2, "train/acting")
    wd.note_build(3.0)
    with wd.source("train/eval"):
        wd.note_capture(0.1)
    with wd.expected():
        wd.note_capture(0.1, "train/burst")
    snap = wd.snapshot()
    assert snap["captures_total"] == 4 and snap["builds_total"] == 1
    assert snap["by_source"] == {"train/burst": 2, "train/acting": 1, "kernels/build": 1,
                                 "train/eval": 1}
    assert snap["live_captures"] == 3 and snap["warmup_captures"] == 1
    assert snap["anomalies"] == [] and snap["post_steady_captures"] == 0
    wd.mark_steady("train/")
    with wd.expected():
        wd.note_capture(0.1, "train/burst")  # expected: never an anomaly
    wd.note_build(2.0)  # outside the steady prefix
    assert wd.snapshot()["anomalies"] == []
    wd.note_capture(0.3, "train/burst")  # a forced recapture in steady state
    snap = wd.snapshot()
    assert snap["post_steady_captures"] == 1
    assert [a["source"] for a in snap["anomalies"]] == ["train/burst"]
    with pytest.raises(AssertionError, match="train/burst"):
        wd.assert_zero_live("train/burst")
    assert [r["kind"] for r in wd.compile_log()] == [
        "live", "live", "build", "live", "warmup", "warmup", "build", "live"]
    wd.clear_steady("train/")
    wd.note_capture(0.3, "train/burst")
    assert wd.snapshot()["post_steady_captures"] == 1
    wd.reset()
    assert wd.snapshot()["captures_total"] == 0 and wd.installed
