"""The port's serving plane on the CPU, held against the JAX package:
the precision tiers (``serve/sharded.py``), visual ``/act``, ``serve
--run``, the engine fleet (``serve/fleet.py``), the fleet router
(``serve/router.py``), fleet metrics aggregation and the trace export
(``telemetry/traceview.py``).

Same weights on both sides (Flax params bridged through ``weights.py``)
and the same numpy inputs from a seed. Tolerances: int8 tier against
JAX's int8 tier 1e-5 (f32 summation order over identical dequantized
weights); bf16 tier against JAX's bf16 tier 2e-2 (bf16 rounding);
visual forwards 1e-4. The int8 quantization itself (``q`` and the
scales) and the metrics aggregate are compared exactly. The fleet and
router behaviours are those of ``tests/test_fleet.py`` and
``tests/test_serve_sharded.py`` that apply at a 1x1 sub-mesh, with
replicas on one repeated host device (``["cpu", "cpu"]``): torch has
one CPU device where the JAX tests force eight.
"""

import functools
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
from pathlib import Path
from urllib import request as urlreq

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_actor_critic_tpu.core.types import MultiObservation as JMultiObservation
from torch_actor_critic_tpu.parallel.sharding import make_submesh
from torch_actor_critic_tpu.sac.trainer import build_models as j_build_models
from torch_actor_critic_tpu.serve.engine import PolicyEngine as JaxPolicyEngine
from torch_actor_critic_tpu.serve.metrics import aggregate_snapshots as j_aggregate
from torch_actor_critic_tpu.serve.sharded import Int8Param as JInt8Param
from torch_actor_critic_tpu.serve.sharded import ShardedPolicyEngine as JaxShardedEngine
from torch_actor_critic_tpu.serve.sharded import quantize_params as j_quantize
from torch_actor_critic_tpu.telemetry import traceview as jtv
from torch_actor_critic_tpu.utils.config import SACConfig as JSACConfig
from torch_actor_critic_tpu_torch.core.types import MultiObservation
from torch_actor_critic_tpu_torch.models import build_actor
from torch_actor_critic_tpu_torch.serve import (
    BreakerOpenError,
    CircuitBreaker,
    EngineFleet,
    FleetRouter,
    ModelRegistry,
    ObsSpec,
    PolicyClient,
    PolicyEngine,
    PolicyServer,
    ServeMetrics,
    ShedError,
    aggregate_snapshots,
)
from torch_actor_critic_tpu_torch.serve.__main__ import (
    build_server,
    check_ported,
    parse_arguments,
)
from torch_actor_critic_tpu_torch.serve.fleet import _ReplicaRegistry
from torch_actor_critic_tpu_torch.serve.server import _parse_obs
from torch_actor_critic_tpu_torch.serve.sharded import (
    Int8Param,
    _along,
    check_submesh,
    dequantize_params,
    quantize_params,
)
from torch_actor_critic_tpu_torch.telemetry import traceview as tv
from torch_actor_critic_tpu_torch.telemetry.histogram import FixedBucketHistogram
from torch_actor_critic_tpu_torch.utils.checkpoint import save_actor
from torch_actor_critic_tpu_torch.utils.config import SACConfig
from torch_actor_critic_tpu_torch.utils.tracking import Tracker
from torch_actor_critic_tpu_torch.weights import _named_arrays, actor_from_jax

REPO = Path(__file__).resolve().parent.parent
ACT_LIMIT = 2.0
PIXEL_ENV = "PixelPendulumBalanceNumpy-v0"
CONV = dict(filters=(8, 16), kernel_sizes=(4, 3), strides=(2, 2), cnn_dense_size=32,
            cnn_features=16, normalize_pixels=True)

# name: (config overrides, obs shape (or (features, frame)), act dim)
CASES = {
    "flat": (dict(hidden_sizes=(32, 32)), (17,), 6),
    "sequence": (dict(history_len=8, seq_d_model=32, seq_num_heads=2, seq_num_layers=2),
                 (8, 3), 1),
    "visual": (dict(hidden_sizes=(32, 32), **CONV), ((1,), (32, 32, 3)), 1),
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


@functools.lru_cache(maxsize=None)
def _case(name):
    """``(jax actor, jax params, jax spec, port actor, port spec, act_dim)``
    on the same weights."""
    overrides, shape, act_dim = CASES[name]
    visual = name == "visual"
    if visual:
        (feat,), frame = shape
        jspec = JMultiObservation(features=jax.ShapeDtypeStruct((feat,), jnp.float32),
                                  frame=jax.ShapeDtypeStruct(frame, jnp.uint8))
        example = JMultiObservation(features=jnp.zeros((feat,)),
                                    frame=jnp.zeros(frame, jnp.uint8))
        spec = MultiObservation(ObsSpec((feat,)), ObsSpec(frame, np.uint8))
        obs_shape = MultiObservation((feat,), frame)
    else:
        jspec = jax.ShapeDtypeStruct(shape, jnp.float32)
        example = jnp.zeros(shape)
        spec, obs_shape = ObsSpec(shape), shape
    env = types.SimpleNamespace(obs_spec=jspec, act_dim=act_dim, act_limit=ACT_LIMIT)
    jactor, _ = j_build_models(JSACConfig(**overrides), env)
    jparams = jactor.init(jax.random.key(0), example, jax.random.key(1))
    port = actor_from_jax(_np_tree(jparams), SACConfig(**overrides), obs_shape,
                          act_dim, ACT_LIMIT)
    return jactor, jparams, jspec, port, spec, act_dim


def _state(actor):
    return {k: v.detach().clone() for k, v in actor.state_dict().items()}


def _obs(name, n, seed=0):
    """``(port obs, jax obs)`` of ``n`` rows."""
    _, shape, _ = CASES[name]
    rng = np.random.default_rng(seed)
    if name == "visual":
        (feat,), frame = shape
        f = rng.standard_normal((n, feat)).astype(np.float32)
        px = rng.integers(0, 256, (n, *frame), dtype=np.uint8)
        return MultiObservation(f, px), JMultiObservation(features=f, frame=px)
    x = rng.standard_normal((n, *shape)).astype(np.float32)
    return x, x


def _http(url, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urlreq.Request(url, data=data, headers={"Content-Type": "application/json",
                                                  **(headers or {})})
    with urlreq.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def wait_until(pred, timeout=30.0, msg="condition never held"):
    deadline = time.time() + timeout
    while not pred():
        assert time.time() < deadline, msg
        time.sleep(0.002)


# ------------------------------------------------------- precision tiers


@pytest.mark.parametrize("name", list(CASES))
def test_quantize_params_equals_jax_in_the_flax_layout(name):
    """q and the per-channel scales equal the JAX package's exactly,
    once JAX's are mapped into the port's layout — every Dense, conv and
    the sequence trunk's position table quantized, the rest untouched."""
    _, jparams, _, port, _, _ = _case(name)
    jq = j_quantize(jparams)
    is8 = lambda x: isinstance(x, JInt8Param)  # noqa: E731
    q_tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x.q, np.float32) if is8(x) else np.asarray(x), jq, is_leaf=is8)
    s_tree = jax.tree_util.tree_map(
        lambda x: np.broadcast_to(np.asarray(x.scale), x.q.shape) if is8(x)
        else np.zeros(np.shape(x), np.float32), jq, is_leaf=is8)
    want_q, want_s = _named_arrays(port, q_tree), _named_arrays(port, s_tree)
    got = quantize_params(_state(port))
    n_jax = sum(is8(x) for x in jax.tree_util.tree_leaves(jq, is_leaf=is8))
    n_port = 0
    for key, v in got.items():
        if isinstance(v, Int8Param):
            n_port += 1
            assert v.q.dtype == torch.int8 and v.scale.dtype == torch.float32
            np.testing.assert_array_equal(v.q.numpy().astype(np.float32), want_q[key])
            np.testing.assert_array_equal(
                _along(v.scale, v.axis, v.q.dim()).expand(v.q.shape).numpy(), want_s[key])
        else:
            assert not want_s[key].any(), f"{key}: JAX quantized it, the port did not"
            np.testing.assert_array_equal(v.numpy(), want_q[key])
    assert n_port == n_jax >= 3
    if name == "sequence":
        assert isinstance(got["trunk.pos_embedding"], Int8Param)
    if name == "visual":
        assert isinstance(got["visual_network.convs.0.weight"], Int8Param)


def test_int8_round_trip_within_half_a_step():
    """|W - q*scale| <= scale/2 elementwise; 1-D leaves pass through."""
    _, _, _, port, _, _ = _case("visual")
    state = _state(port)
    q = quantize_params(state)
    deq = dequantize_params(q)
    for key, w in state.items():
        if isinstance(q[key], Int8Param):
            scale = _along(q[key].scale, q[key].axis, w.dim())
            assert bool(((w - deq[key]).abs() <= scale * 0.5 + 1e-7).all()), key
        else:
            assert torch.equal(deq[key], w)


@pytest.mark.parametrize("name", list(CASES))
def test_int8_tier_matches_jax_int8_tier(name):
    jactor, jparams, jspec, port, spec, _ = _case(name)
    obs, jobs = _obs(name, 5, seed=1)
    jeng = JaxShardedEngine(jactor, jspec, make_submesh(jax.devices()[:1], 1, 1),
                            precision="int8", max_batch=8, fsdp_min_bytes=0)
    jplaced, _ = jeng.place_params(jparams)
    want = jeng.act(jplaced, jobs, None, deterministic=True)
    eng = PolicyEngine(port, spec, precision="int8", max_batch=8, device="cpu")
    placed, nbytes = eng.place_params(_state(port))
    np.testing.assert_allclose(eng.act(placed, obs), want, atol=1e-5, rtol=0)
    _, nbytes_f32 = PolicyEngine(port, spec, max_batch=8,
                                 device="cpu").place_params(_state(port))
    assert nbytes < nbytes_f32 / 3
    # A fleet replica places the registry's already quantized params:
    # they pass through unchanged.
    again, nbytes_again = eng.place_params(placed)
    assert nbytes_again == nbytes
    for key, v in placed.items():
        assert type(again[key]) is type(v)
        assert torch.equal(dequantize_params(again)[key], dequantize_params(placed)[key])


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_tier_matches_jax_bf16_tier(name):
    jactor, jparams, jspec, port, spec, _ = _case(name)
    obs, jobs = _obs(name, 6, seed=2)
    jeng = JaxShardedEngine(jactor, jspec, make_submesh(jax.devices()[:1], 1, 1),
                            precision="bf16", max_batch=8, fsdp_min_bytes=0)
    jplaced, _ = jeng.place_params(jparams)
    want = jeng.act(jplaced, jobs, None, deterministic=True)
    eng = PolicyEngine(port, spec, precision="bf16", max_batch=8, device="cpu")
    placed, _ = eng.place_params(_state(port))
    got = eng.act(placed, obs)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    f32 = PolicyEngine(port, spec, max_batch=8, device="cpu").act(_state(port), obs)
    assert not np.array_equal(got, f32), "bf16 tier bitwise the f32 tier"
    assert all(p.dtype == torch.float32 for p in placed.values())


def test_f32_tier_is_bitwise_the_single_device_engine():
    """Every bucket, padded and exact fits, deterministic and sampled
    (one generator state)."""
    _, _, _, port, spec, _ = _case("sequence")
    base = PolicyEngine(port, spec, max_batch=8, device="cpu")
    eng = PolicyEngine(port, spec, precision="f32", max_batch=8, device="cpu")
    assert eng.buckets == base.buckets and base.precision == "f32"
    params = _state(port)
    placed, _ = eng.place_params(params)
    for bucket in eng.buckets:
        for rows in sorted({max(1, bucket - 1), bucket}):
            obs, _ = _obs("sequence", rows, seed=bucket * 10 + rows)
            np.testing.assert_array_equal(eng.act(placed, obs), base.act(params, obs))
            g1 = torch.Generator().manual_seed(bucket)
            g2 = torch.Generator().manual_seed(bucket)
            np.testing.assert_array_equal(eng.act(placed, obs, g1, deterministic=False),
                                          base.act(params, obs, g2, deterministic=False))


def test_submesh_above_one_by_one_raises_naming_its_queue():
    _, _, _, port, spec, _ = _case("flat")
    with pytest.raises(NotImplementedError, match="queue 6"):
        check_submesh((2, 2))
    with pytest.raises(NotImplementedError, match="queue 6"):
        check_submesh((1, 2))
    assert check_submesh((1, 1)) == (1, 1)
    with pytest.raises(ValueError, match="precision"):
        PolicyEngine(port, spec, precision="fp8", device="cpu")
    with pytest.raises(ValueError, match="precision"):
        ModelRegistry(device="cpu", precision="fp8")


# ---------------------------------------------------------- visual /act


def test_parse_obs_takes_visual_dicts_and_refuses_mismatches():
    _, _, _, _, spec, _ = _case("visual")
    obs = _parse_obs({"features": [[0.5]], "frame": np.zeros((1, 32, 32, 3)).tolist()}, spec)
    assert isinstance(obs, MultiObservation)
    assert obs.features.dtype == np.float32 and obs.frame.dtype == np.uint8
    for bad in ([[1.0]], {"features": [[1.0]]}, {"features": [1], "frame": [2], "x": 0}):
        with pytest.raises(ValueError):
            _parse_obs(bad, spec)
    with pytest.raises(ValueError):
        _parse_obs({"features": [1], "frame": [2]}, ObsSpec((3,)))


def test_served_pixel_actor_matches_jax_engine_over_http():
    """A visual slot over HTTP answers what the JAX engine answers for
    the same bridged params (batched and single observations); a
    malformed observation is a 400 and never trips the breaker."""
    jactor, jparams, jspec, port, spec, act_dim = _case("visual")
    obs, jobs = _obs("visual", 3, seed=4)
    jeng = JaxPolicyEngine(jactor, jspec, max_batch=4)
    want = jeng.act(jparams, jobs, deterministic=True)
    reg = ModelRegistry(device="cpu")
    reg.register("default", port, spec, params=_state(port), max_batch=4)
    server = PolicyServer(reg, port=0, max_batch=4).start()
    try:
        body = {"features": obs.features.tolist(), "frame": obs.frame.tolist()}
        got = _http(server.address + "/act", {"obs": body, "deterministic": True})
        np.testing.assert_allclose(np.asarray(got["action"]), want, atol=1e-4, rtol=0)
        one = _http(server.address + "/act", {"obs": {
            "features": obs.features[0].tolist(), "frame": obs.frame[0].tolist()}})
        assert np.asarray(one["action"]).shape == (act_dim,)
        np.testing.assert_allclose(np.asarray(one["action"]), want[0], atol=1e-4, rtol=0)
        sampled = _http(server.address + "/act", {"obs": body, "deterministic": False})
        assert np.all(np.abs(np.asarray(sampled["action"])) <= ACT_LIMIT)
        for bad in ({"features": obs.features.tolist()}, obs.features.tolist(),
                    {"features": obs.features.tolist(),
                     "frame": np.zeros((3, 8, 8, 3)).tolist()}):
            with pytest.raises(urlreq.HTTPError) as err:
                _http(server.address + "/act", {"obs": bad})
            assert err.value.code == 400
        assert reg.breaker("default").state == "closed"
    finally:
        server.close()
        reg.close()


def _pixel_run(root, run_id="pix"):
    """A tracked pixel-env run with one saved epoch, as the train CLI
    lays it out."""
    overrides, _, _ = CASES["visual"]
    cfg = SACConfig(**overrides)
    tracker = Tracker(run_id=run_id, root=root)
    tracker.log_params({"environment": PIXEL_ENV, "config": json.loads(cfg.to_json()),
                        "seed": 0})
    actor = build_actor(cfg, MultiObservation((1,), (32, 32, 3)), 1, ACT_LIMIT,
                        generator=torch.Generator().manual_seed(3))
    save_actor(tracker.artifact_path("checkpoints"), 1, actor, cfg)
    return actor


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_serve_run_resolves_a_pixel_run(tmp_path, precision):
    """``--run`` on a pixel-env run: env and config from the run, the
    observation spec from one throwaway env of the port's pool; the
    served actions equal the actor's own forward (f32) or its forward on
    the dequantized weights (int8)."""
    actor = _pixel_run(tmp_path)
    args = parse_arguments(["--run", "pix", "--runs-root", str(tmp_path), "--device", "cpu",
                            "--port", "0", "--poll-interval", "0", "--max-batch", "4",
                            "--serve-precision", precision])
    server, info = build_server(args)
    server.start()
    try:
        assert info["epoch"] == 1
        obs, _ = _obs("visual", 3, seed=7)
        got = _http(server.address + "/act", {"obs": {
            "features": obs.features.tolist(), "frame": obs.frame.tolist()}})
        state = _state(actor)
        if precision == "int8":
            state = dequantize_params(quantize_params(state))
            snap = _http(server.address + "/metrics")
            # One engine at the tier, no fleet in between.
            assert snap["sharding"]["precision"] == "int8" and "fleet" not in snap
            assert server.registry.acquire()[0].precision == "int8"
            f32_bytes = sum(v.numel() * v.element_size() for v in state.values())
            held = snap["sharding"]["per_replica"][0]["slot_bytes"]["default"]
            assert 0 < held < f32_bytes / 3
        actor.load_state_dict(state)
        with torch.inference_mode():
            want, _ = actor(MultiObservation(torch.from_numpy(obs.features),
                                             torch.from_numpy(obs.frame)),
                            deterministic=True, with_logprob=False)
        np.testing.assert_allclose(np.asarray(got["action"]), want.numpy(), atol=1e-4, rtol=0)
    finally:
        server.close()
        server.registry.close()


def _cli(*args, **kw):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", *args], cwd=REPO, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, **kw,
    )


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=30)
    for stream in (proc.stdout, proc.stderr):
        if stream is not None:
            stream.close()


def test_serve_run_of_a_cpu_trained_run_drains_on_sigterm(tmp_path):
    """A tiny run trained by the port's train CLI, served by ``--run``
    (its history config served over (history_len, obs_dim) windows),
    answers, then drains on SIGTERM with exit 0 and writes its trace."""
    train = _cli(
        "torch_actor_critic_tpu_torch.train", "--environment", "PendulumNumpy-v1",
        "--history-len", "4", "--seq-d-model", "16", "--seq-num-heads", "2",
        "--seq-num-layers", "1", "--device", "cpu", "--epochs", "1",
        "--steps-per-epoch", "40", "--start-steps", "20", "--update-after", "20",
        "--update-every", "20", "--batch-size", "8", "--buffer-size", "200",
        "--runs-root", str(tmp_path))
    try:
        out, err = train.communicate(timeout=600)
    finally:
        _stop(train)
    assert train.returncode == 0, err[-2000:]
    (run_id,) = [p.name for p in (tmp_path / "Default").iterdir()]
    trace = tmp_path / "trace.json"
    proc = _cli("torch_actor_critic_tpu_torch.serve", "--run", run_id, "--runs-root",
                str(tmp_path), "--device", "cpu", "--port", "0", "--poll-interval", "0",
                "--max-batch", "4", "--trace-export", str(trace))
    try:
        ready = json.loads(proc.stdout.readline())
        obs = np.random.default_rng(0).standard_normal((2, 4, 3)).astype(np.float32)
        act = np.asarray(_http(ready["serving"] + "/act", {"obs": obs.tolist()})["action"])
        assert act.shape == (2, 1) and np.all(np.abs(act) <= 2.0)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    finally:
        _stop(proc)
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "request" for e in events)


def test_cli_flags_parse_and_validate():
    args = parse_arguments(["--ckpt-dir", "/tmp/x", "--obs-dim", "4", "--act-dim", "2"])
    assert (args.submesh, args.serve_precision, args.devices) == ("1x1", "f32", "1")
    assert (args.request_timeout, args.act_timeout, args.fleet) == (30.0, 30.0, 0)
    assert check_ported(args) == (1, 1)
    args = parse_arguments(["--ckpt-dir", "/tmp/x", "--obs-dim", "4", "--act-dim", "2",
                            "--devices", "all", "--submesh", "2x2",
                            "--serve-precision", "bf16"])
    assert (args.submesh, args.serve_precision) == ("2x2", "bf16")
    with pytest.raises(NotImplementedError, match="queue 6"):
        check_ported(args)
    with pytest.raises(SystemExit):
        parse_arguments(["--ckpt-dir", "/tmp/x", "--serve-precision", "fp64"])
    with pytest.raises(SystemExit):
        check_ported(parse_arguments(["--submesh", "two"]))
    # The cold-start flags are ported: they parse and validate.
    for flag, dest, value in ((["--warm-start", "auto"], "warm_start", "auto"),
                              (["--compile-cache", "d"], "compile_cache", "d")):
        args = parse_arguments(flag)
        assert getattr(args, dest) == value and check_ported(args) == (1, 1)
    # The transition flywheel is ported: its flags parse and validate.
    args = parse_arguments(["--log-transitions", "d", "--log-sample-every", "4"])
    assert check_ported(args) == (1, 1)
    assert (args.log_transitions, args.log_sample_every, args.log_max_bytes) == ("d", 4, 0)
    # The obs plane, the warm pool and elastic serving are ported: with a
    # fleet they parse and validate.
    fleet = ["--ckpt-dir", "/tmp/x", "--obs-dim", "4", "--act-dim", "2", "--fleet", "2"]
    for flag in (["--obs"], ["--warm-pool", "1"],
                 ["--obs", "--warm-pool", "1", "--elastic", "on", "--slo-config", "r.json"]):
        args = parse_arguments(fleet + flag)
        assert check_ported(args) == (1, 1)
    assert (args.obs, args.warm_pool, args.elastic, args.slo_config) == (True, 1, "on", "r.json")
    assert (args.obs_interval, args.elastic_min, args.elastic_max) == (2.0, 1, 4)


# ------------------------------------------------ engine-per-device fleet

OBS_DIM, ACT_DIM = 17, 6
OBS = np.ones((OBS_DIM,), np.float32)
FLAT_CFG = SACConfig(hidden_sizes=(32, 32))


def _flat_actor(seed=0):
    return build_actor(FLAT_CFG, (OBS_DIM,), ACT_DIM, 1.0,
                       generator=torch.Generator().manual_seed(seed))


def make_registry(breaker=None, precision="f32"):
    actor = _flat_actor()
    reg = ModelRegistry(device="cpu", precision=precision)
    reg.register("default", actor, ObsSpec((OBS_DIM,)), params=_state(actor),
                 max_batch=4, warmup=False, breaker=breaker)
    return reg, actor


def stall_replica(fleet, index, slot="default"):
    engine, _, _ = fleet._replicas[index].registry.acquire(slot)
    release = threading.Event()
    real_act = engine.act

    def stalled(*args, **kwargs):
        release.wait(30.0)
        return real_act(*args, **kwargs)

    engine.act = stalled
    return release


class _FakeLoadBatcher:
    def __init__(self, load=0, ema=None):
        self._load, self._ema, self.submits, self.mode = load, ema, 0, "continuous"

    def load_rows(self):
        return self._load

    @property
    def ema_row_s(self):
        return self._ema

    def queue_depth(self):
        return 0

    def submit(self, *a, **k):
        from concurrent.futures import Future

        self.submits += 1
        f = Future()
        f.set_result(None)
        return f

    def close(self, timeout=10.0):
        pass


def _fake_fleet(loads_emas):
    reg, _ = make_registry()
    fleet = EngineFleet(reg, devices=["cpu"] * len(loads_emas), max_batch=4)
    fakes = []
    for rep, (load, ema) in zip(fleet._replicas, loads_emas):
        rep.batcher.close()
        rep.batcher = _FakeLoadBatcher(load, ema)
        fakes.append(rep.batcher)
    return reg, fleet, fakes


def test_least_loaded_scoring_is_load_times_ema():
    reg, fleet, fakes = _fake_fleet([(8, 0.001), (2, 0.1)])
    try:
        for _ in range(3):
            fleet.submit(OBS)
        assert [f.submits for f in fakes] == [3, 0]
    finally:
        fleet.close()
        reg.close()


def test_least_loaded_unmeasured_backlog_yields_and_idle_ties_spread():
    reg, fleet, fakes = _fake_fleet([(1, None), (3, 0.001)])
    try:
        fleet.submit(OBS)
        assert fakes[1].submits == 1
    finally:
        fleet.close()
        reg.close()
    reg2, fleet2, fakes2 = _fake_fleet([(0, None)] * 3)
    try:
        for _ in range(6):
            fleet2.submit(OBS)
        assert [f.submits for f in fakes2] == [2, 2, 2]
    finally:
        fleet2.close()
        reg2.close()


def test_stalled_replica_traffic_flows_to_free_replica():
    reg, _ = make_registry()
    with EngineFleet(reg, devices=["cpu", "cpu"], max_batch=4, capacity=64) as fleet:
        release = stall_replica(fleet, 0)
        try:
            blocked = fleet.submit(OBS)
            assert fleet._replicas[0].dispatched == 1
            wait_until(lambda: fleet._replicas[0].batcher.load_rows() == 1
                       and fleet._replicas[0].batcher.queue_depth() == 0)
            for _ in range(5):
                assert fleet.act(OBS, timeout=30.0).action.shape == (ACT_DIM,)
            assert fleet._replicas[0].dispatched == 1
            assert fleet._replicas[1].dispatched == 5
            release.set()
            assert blocked.result(timeout=30.0).action.shape == (ACT_DIM,)
        finally:
            release.set()
    reg.close()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def test_breaker_open_replica_ejected_then_readmitted():
    clock = FakeClock()
    reg, _ = make_registry(breaker=CircuitBreaker(fail_threshold=1, cooldown_s=10.0,
                                                  clock=clock))
    with EngineFleet(reg, devices=["cpu", "cpu"], max_batch=4, capacity=64) as fleet:
        br0 = fleet._replicas[0].registry.breaker("default")
        br1 = fleet._replicas[1].registry.breaker("default")
        assert br0.fail_threshold == 1 and br0._clock is clock
        br0.record_failure(RuntimeError("injected device fault"))
        assert br0.state == "open"
        futures = [fleet.submit(OBS) for _ in range(4)]
        assert fleet._replicas[0].dispatched == 0
        assert fleet._replicas[1].dispatched == 4
        for f in futures:
            assert f.result(timeout=30.0).action.shape == (ACT_DIM,)
        br1.record_failure(RuntimeError("injected device fault"))
        with pytest.raises(BreakerOpenError) as e:
            fleet.submit(OBS)
        assert e.value.reason == "breaker_open"
        assert fleet.metrics.snapshot()["shed_by_reason"]["breaker_open"] == 1
        clock.advance(10.0)
        assert fleet.act(OBS, timeout=30.0).action.shape == (ACT_DIM,)
        assert fleet.act(OBS, timeout=30.0).action.shape == (ACT_DIM,)
        wait_until(lambda: br0.state == "closed" and br1.state == "closed")
        evs = [e for e in reg.breaker_events() if "replica" in e]
        assert any(e["event"] == "breaker_open" for e in evs)
    reg.close()


def test_fleet_shared_admission_bound_and_generation_propagation():
    reg, actor = make_registry()
    with EngineFleet(reg, devices=["cpu", "cpu"], max_batch=4, capacity=4) as fleet:
        rel0, rel1 = stall_replica(fleet, 0), stall_replica(fleet, 1)
        try:
            blockers = [fleet.submit(OBS) for _ in range(2)]
            wait_until(lambda: fleet.queue_depth() == 0)
            queued = [fleet.submit(OBS) for _ in range(4)]
            with pytest.raises(ShedError) as e:
                fleet.submit(OBS)
            assert e.value.reason == "queue_full" and e.value.detail["capacity"] == 4
            rel0.set()
            rel1.set()
            for f in blockers + queued:
                assert f.result(timeout=30.0).generation == 0
        finally:
            rel0.set()
            rel1.set()
        assert reg.swap("default", _state(actor)) == 1
        for _ in range(2):
            assert fleet.act(OBS, timeout=30.0).generation == 1
    reg.close()


def test_fleet_replicas_answer_what_one_engine_answers():
    """Replica engines are fresh twins of the slot engine: every answer
    of a two-replica fleet equals the single engine's (deterministic)."""
    reg, actor = make_registry()
    engine, params, _ = reg.acquire()
    rng = np.random.default_rng(5)
    obs = rng.standard_normal((6, OBS_DIM)).astype(np.float32)
    with EngineFleet(reg, devices=["cpu", "cpu"], max_batch=4) as fleet:
        got = [fleet.act(o, timeout=30.0).action for o in obs]
        assert {r.dispatched for r in fleet._replicas} == {3}
    np.testing.assert_allclose(np.stack(got), engine.act(params, obs[:4]).tolist()
                               + engine.act(params, obs[4:]).tolist(), atol=1e-6, rtol=0)
    reg.close()


# --------------------------------------------- placement cache and tiers


def test_placement_cache_keys_on_generation_and_precision():
    reg, actor = make_registry()
    view = _ReplicaRegistry(reg, "cpu", 0)
    _, placed_a, gen_a = view.acquire()
    assert view.placements_total == 1
    _, placed_b, _ = view.acquire()
    assert view.placements_total == 1 and placed_b is placed_a
    reg.swap("default", _state(actor))
    _, _, gen_b = view.acquire()
    assert gen_b == gen_a + 1 and view.placements_total == 2
    eng = view._engines["default"]
    view._engines["default"] = PolicyEngine(
        eng.actor_def, eng.obs_spec, precision="int8", max_batch=eng.max_batch,
        buckets=eng.buckets, device="cpu")
    _, placed_c, _ = view.acquire()
    assert view.placements_total == 3
    assert any(isinstance(v, Int8Param) for v in placed_c.values())
    reg.close()


def _poisoned(actor):
    bad = _state(actor)
    bad["mu.weight"] = torch.full_like(bad["mu.weight"], float("nan"))
    return bad


def test_tier_reload_one_placement_per_replica_and_nan_rejected(tmp_path):
    """An int8 fleet: one placement per replica per generation; a NaN
    checkpoint is rejected before any replica sees it, and every replica
    keeps answering the last good weights bitwise."""
    save_actor(tmp_path, 1, _flat_actor(0), FLAT_CFG)
    reg = ModelRegistry(device="cpu", precision="int8")
    reg.register("default", _flat_actor(9), ObsSpec((OBS_DIM,)), ckpt_dir=str(tmp_path),
                 max_batch=4, warmup=False)
    metrics = ServeMetrics()
    with EngineFleet(reg, devices=["cpu", "cpu"], max_batch=4, metrics=metrics) as fleet:
        before = [fleet.act(OBS, timeout=30.0) for _ in range(2)]
        snap = metrics.snapshot()
        assert snap["param_placements_total"] == 2
        initial = snap["reload_transfer_bytes_total"]
        save_actor(tmp_path, 2, _poisoned(_flat_actor(1)), FLAT_CFG)
        assert reg.reload()["default"]["status"] == "rejected"
        after = [fleet.act(OBS, timeout=30.0) for _ in range(2)]
        for a, b in zip(after, before):
            assert a.generation == b.generation == 0
            np.testing.assert_array_equal(a.action, b.action)
        assert metrics.snapshot()["param_placements_total"] == 2
        save_actor(tmp_path, 3, _flat_actor(2), FLAT_CFG)
        assert reg.reload()["default"]["status"] == "ok"
        for _ in range(2):
            assert fleet.act(OBS, timeout=30.0).generation == 1
        snap = metrics.snapshot()
        assert snap["param_placements_total"] == 4
        assert snap["reload_transfer_bytes_total"] == 2 * initial
        for rep in fleet.sharding_stats()["per_replica"]:
            assert rep["placements_total"] == 2
    reg.close()


def test_precision_only_fleet_uses_single_device_submeshes():
    reg, _ = make_registry(precision="bf16")
    with EngineFleet(reg, devices=["cpu", "cpu"], max_batch=4) as fleet:
        assert fleet.n_replicas == 2
        assert np.isfinite(fleet.act(OBS, timeout=30.0).action).all()
        assert {rep.registry.acquire()[0].precision for rep in fleet._replicas} == {"bf16"}
        stats = fleet.sharding_stats()
        assert stats["precision"] == "bf16" and stats["devices_per_replica"] == 1
        assert stats["submesh"] == {"tp": 1, "fsdp": 1}
    reg.close()


def test_metrics_fleet_and_sharding_sections_over_http():
    reg, _ = make_registry(precision="int8")
    server = PolicyServer(reg, port=0, max_batch=4, devices=["cpu", "cpu"]).start()
    try:
        out = _http(server.address + "/act", {"obs": OBS.tolist()})
        assert len(out["action"]) == ACT_DIM
        snap = _http(server.address + "/metrics")
        sh = snap["sharding"]
        assert sh["submesh"] == {"tp": 1, "fsdp": 1} and sh["precision"] == "int8"
        assert sh["replicas"] == 2 and all(r["devices"] == ["cpu"] for r in sh["per_replica"])
        assert snap["reload_transfer_bytes_total"] > 0
        assert len(snap["fleet"]["replicas"]) == 2
        assert snap["fleet"]["compiles"]["live_compiles"] == 0
        assert snap["fleet"]["compiles"]["compiles_total"] == 2 * 2 * 2  # 2 replicas x 2 buckets
    finally:
        server.close()
        reg.close()


# ------------------------------------------------------------ fleet router


def _worker(params=None, ckpt_dir=None, span_log=None):
    reg = ModelRegistry(device="cpu")
    reg.register("default", _flat_actor(), ObsSpec((OBS_DIM,)), params=params,
                 ckpt_dir=ckpt_dir, max_batch=4, warmup=False)
    return PolicyServer(reg, port=0, max_batch=4, max_wait_ms=1.0,
                        span_log=span_log).start()


def test_router_routes_ejects_killed_worker_and_failover_zero_drops():
    params = _state(_flat_actor())
    w0, w1 = _worker(params=params), _worker(params=params)
    router = FleetRouter([w0.address, w1.address], poll_interval_s=30.0)
    router.poll_once()
    router.start()
    try:
        client = PolicyClient(url=router.address, retries=2)
        for _ in range(4):
            assert client.act(OBS, timeout=30.0).action.shape == (ACT_DIM,)
        view = router.membership()
        assert view["admitted_workers"] == 2
        assert {w["routed_total"] for w in view["workers"].values()} == {2}
        w0.close()
        for _ in range(4):
            assert client.act(OBS, timeout=30.0).action.shape == (ACT_DIM,)
        view = router.membership()
        assert view["workers"]["w0"]["admitted"] is False
        assert view["workers"]["w0"]["reason"] == "unreachable"
        assert router.failovers_total >= 1
        health = _http(router.address + "/healthz")
        assert health["status"] == "ok" and health["admitted_workers"] == 1
    finally:
        router.close()
        w1.close()


def test_router_fails_over_a_response_cut_short_by_a_dying_worker():
    """A worker killed while it writes an answer leaves the router a
    truncated response (``IncompleteRead``): the router ejects it and
    answers from another worker, as for a refused connection."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Dying(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, body: bytes, length: int):
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(length))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # healthy until it answers an /act
            body = json.dumps({"status": "ok", "slots": {}}).encode()
            self._send(body, len(body))

        def do_POST(self):
            self.rfile.read(int(self.headers["Content-Length"]))
            self._send(b'{"action": [0.1', 1000)  # then the connection dies
            self.close_connection = True

    dying = ThreadingHTTPServer(("127.0.0.1", 0), Dying)
    threading.Thread(target=dying.serve_forever, daemon=True).start()
    w1 = _worker(params=_state(_flat_actor()))
    router = FleetRouter([f"http://127.0.0.1:{dying.server_address[1]}", w1.address],
                         poll_interval_s=30.0)
    router.poll_once()
    router.start()
    try:
        assert router.membership()["admitted_workers"] == 2
        for _ in range(2):
            out = _http(router.address + "/act", {"obs": OBS.tolist()})
            assert len(out["action"]) == ACT_DIM
        view = router.membership()
        assert view["workers"]["w0"]["admitted"] is False
        assert view["workers"]["w0"]["reason"] == "unreachable"
        assert router.failovers_total >= 1
    finally:
        router.close()
        w1.close()
        dying.shutdown()
        dying.server_close()


def test_router_hop_tags_stitch_router_and_worker_spans():
    worker_log = tv.RequestSpanLog()
    w0 = _worker(params=_state(_flat_actor()), span_log=worker_log)
    router_log = tv.RequestSpanLog()
    router = FleetRouter([w0.address], poll_interval_s=30.0, span_log=router_log)
    router.poll_once()
    router.start()
    try:
        req = urlreq.Request(
            router.address + "/act", data=json.dumps({"obs": OBS.tolist()}).encode(),
            headers={"Content-Type": "application/json", "X-Request-Id": "trace-me"})
        with urlreq.urlopen(req, timeout=30) as resp:
            assert resp.headers["X-Request-Id"] == "trace-me>w0"
            assert len(json.loads(resp.read())["action"]) == ACT_DIM
        recs = router_log.records()
        assert recs[-1]["request_id"] == "trace-me" and recs[-1]["worker"] == "w0"
        assert recs[-1]["outcome"] == "ok"
        wait_until(lambda: len(worker_log) >= 1)
        wrec = worker_log.records()[-1]
        assert wrec["request_id"] == "trace-me>w0" and wrec["outcome"] == "ok"
        assert wrec["t_enq"] <= wrec["t_collect"] <= wrec["t_dispatch"] <= wrec["t_done"]
        events = tv.router_hop_events(recs)
        assert [e["ph"] for e in events] == ["B", "E"] and events[0]["name"] == "hop w0"
    finally:
        router.close()
        w0.close()


def test_rolling_reload_zero_dropped_requests(tmp_path):
    dirs = [tmp_path / "a", tmp_path / "b"]
    for i, d in enumerate(dirs):
        save_actor(d, 0, _flat_actor(i), FLAT_CFG)
    workers = [_worker(ckpt_dir=str(d)) for d in dirs]
    router = FleetRouter([w.address for w in workers], poll_interval_s=30.0)
    router.poll_once()
    router.start()
    errors, answered = [], [0]
    stop = threading.Event()

    def load_loop():
        client = PolicyClient(url=router.address, retries=3)
        while not stop.is_set():
            try:
                assert client.act(OBS, timeout=30.0).action.shape == (ACT_DIM,)
                answered[0] += 1
            except Exception as e:  # noqa: BLE001 — recorded, asserted
                errors.append(repr(e))

    try:
        for i, d in enumerate(dirs):
            save_actor(d, 1, _flat_actor(10 + i), FLAT_CFG)
        herd = [threading.Thread(target=load_loop) for _ in range(3)]
        for th in herd:
            th.start()
        wait_until(lambda: answered[0] >= 3)
        out = router.rolling_reload(settle_timeout_s=30.0)
        stop.set()
        for th in herd:
            th.join(timeout=30.0)
        assert set(out) == {"w0", "w1"}
        for name, status in out.items():
            assert status["readmitted"] is True, (name, status)
            assert status["reload"]["default"]["status"] == "ok"
            assert status["reload"]["default"]["epoch"] == 1
        assert errors == [], errors[:3]
        assert router.membership()["admitted_workers"] == 2
        for w in workers:
            slot = _http(w.address + "/healthz")["slots"]["default"]
            assert (slot["generation"], slot["epoch"]) == (1, 1)
        agg = _http(router.address + "/metrics")
        per = [_http(w.address + "/metrics")["responses_total"] for w in workers]
        assert agg["responses_total"] == sum(per) >= answered[0]
    finally:
        stop.set()
        router.close()
        for w in workers:
            w.close()


# ------------------------------------------------------- /metrics merging


def _metrics_pair(seed):
    rng = np.random.default_rng(seed)
    ma, mb = ServeMetrics(), ServeMetrics()
    for v in rng.uniform(0.5, 20.0, size=400):
        ma.record_done(float(v))
    for v in rng.uniform(5.0, 300.0, size=300):
        mb.record_done(float(v))
    ma.record_shed("queue_full")
    mb.record_shed("queue_full")
    mb.record_shed("breaker_open")
    mb.record_transfer(1024)
    return ma.snapshot(), mb.snapshot()


def test_aggregate_snapshots_equals_jax_on_the_same_snapshots():
    snap_a, snap_b = _metrics_pair(0)
    for workers in ({"w0": snap_a, "w1": snap_b, "w2": None}, {"w0": snap_a},
                    {"w0": None}, {}):
        assert aggregate_snapshots(workers) == j_aggregate(workers)
    agg = aggregate_snapshots({"w0": snap_a, "w1": snap_b})
    ref = FixedBucketHistogram()
    rng = np.random.default_rng(0)
    for v in np.concatenate([rng.uniform(0.5, 20.0, size=400), rng.uniform(5.0, 300.0, size=300)]):
        ref.record(float(v))
    assert agg["responses_total"] == 700 and agg["sheds_total"] == 3
    assert agg["latency_hist"]["counts"] == ref.raw_counts()["counts"]
    assert agg["p99_ms"] == round(ref.percentiles((99,))[0], 3)
    assert agg["reload_transfer_bytes_total"] == 1024


def test_aggregate_snapshots_restart_never_double_counts():
    m = ServeMetrics()
    for _ in range(5):
        m.record_done(1.0)
    assert aggregate_snapshots({"w0": m.snapshot()})["responses_total"] == 5
    fresh = ServeMetrics()
    fresh.record_done(1.0)
    after = aggregate_snapshots({"w0": fresh.snapshot()})
    assert after["responses_total"] == 1
    assert after["workers"]["w0"]["responses_total"] == 1


# ---------------------------------------------------------- trace export


def _span_records():
    recs = [
        {"request_id": "a", "slot": "default", "rows": 2, "bucket": 2, "generation": 0,
         "t_enq": 10.0, "t_collect": 10.001, "t_dispatch": 10.002,
         "t_forward_end": 10.004, "t_done": 10.005, "outcome": "ok"},
        {"request_id": "b", "slot": "default", "rows": 0, "t_enq": 10.01,
         "t_done": 10.01, "outcome": "queue_full"},
        {"request_id": "c", "slot": "default", "rows": 1, "t_enq": 10.02,
         "t_collect": 10.03, "t_done": None, "outcome": "error"},
    ]
    hops = [{"request_id": "a", "worker": "w0", "t_start": 9.99, "t_end": 10.006,
             "outcome": "ok", "attempt": 0}]
    return recs, hops


def test_export_trace_equals_jax_on_the_same_records(tmp_path, monkeypatch):
    monkeypatch.setattr(tv, "_ANCHOR", (1.7e9, 5.0))
    monkeypatch.setattr(jtv, "_ANCHOR", (1.7e9, 5.0))
    recs, hops = _span_records()
    log, jlog = tv.RequestSpanLog(), jtv.RequestSpanLog()
    for r in recs:
        log.record(dict(r))
        jlog.record(dict(r))
    assert log.records() == jlog.records()
    got = tv.export_trace(tmp_path / "p.json", tv.serve_request_events(log.records()),
                          tv.router_hop_events(hops))
    want = jtv.export_trace(tmp_path / "j.json", jtv.serve_request_events(jlog.records()),
                            jtv.router_hop_events(hops))
    assert {k: v for k, v in got.items() if k != "path"} == \
        {k: v for k, v in want.items() if k != "path"}
    assert json.loads((tmp_path / "p.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())


def test_server_span_log_records_served_and_shed_requests():
    """With a span log attached the batcher records every served request
    under its X-Request-Id; a queue_full shed lands on the same log."""
    reg, _ = make_registry()
    log = tv.RequestSpanLog()
    server = PolicyServer(reg, port=0, max_batch=4, span_log=log, capacity=1).start()
    try:
        _http(server.address + "/act", {"obs": OBS.tolist()}, {"X-Request-Id": "r1"})
        wait_until(lambda: len(log) >= 1)
        rec = log.records()[-1]
        assert rec["request_id"] == "r1" and rec["outcome"] == "ok" and rec["bucket"] == 2
        server.batcher._note_shed("r2", "default", "queue_full")
        assert log.records()[-1]["outcome"] == "queue_full"
        events = tv.serve_request_events(log.records())
        assert {e["args"]["request_id"] for e in events
                if e.get("name") == "request" and e["ph"] == "B"} == {"r1", "r2"}
    finally:
        server.close()
        reg.close()
