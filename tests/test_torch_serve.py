"""The port's serving stack on the CPU: engine, registry, HTTP server,
CLI, and the import isolation of the whole port.

Every forward here runs on the CPU (``device="cpu"``), where attention
is the plain version; the card path is driven by ``chip_smoke.py``.
Served deterministic actions are held against the JAX ``PolicyEngine``
for the same (bridged) params and observations at 1e-5 (f32 summation
order); padding invariance across buckets at 1e-6 (the CPU matmul may
block differently per batch size — the JAX package pins its own
engine bitwise on XLA:CPU, which the port does not claim).
"""

import ast
import json
import math
import os
import signal
import subprocess
import sys
from pathlib import Path
from urllib import request as urlreq

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_actor_critic_tpu.models import SequenceActor as JaxSequenceActor
from torch_actor_critic_tpu.serve.engine import PolicyEngine as JaxPolicyEngine
from torch_actor_critic_tpu.serve.engine import default_buckets as jax_default_buckets
from torch_actor_critic_tpu_torch.models import build_models
from torch_actor_critic_tpu_torch.serve import (
    MicroBatcher,
    ModelRegistry,
    NonFiniteActionError,
    ObsSpec,
    PolicyEngine,
    PolicyServer,
)
from torch_actor_critic_tpu_torch.serve.engine import default_buckets
from torch_actor_critic_tpu_torch.serve.server import _parse_obs
from torch_actor_critic_tpu_torch.utils.checkpoint import (
    Checkpointer,
    latest_epoch,
    restore_actor_params,
    save_actor,
)
from torch_actor_critic_tpu_torch.utils.config import SACConfig
from torch_actor_critic_tpu_torch.weights import actor_from_jax

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "torch_actor_critic_tpu_torch"
T, OBS_DIM, ACT_DIM, ACT_LIMIT = 8, 3, 1, 2.0
CFG = SACConfig(history_len=T, seq_d_model=32, seq_num_heads=2, seq_num_layers=2)
SPEC = ObsSpec((T, OBS_DIM), np.float32)


def _actor(seed=0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build_models(CFG, SPEC.shape, ACT_DIM, ACT_LIMIT)


def _obs(n, seed=0):
    shape = SPEC.shape if n is None else (n, *SPEC.shape)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _params(actor):
    return {k: v.detach().clone() for k, v in actor.state_dict().items()}


def _poisoned(params):
    bad = dict(params)
    bad["mu.weight"] = torch.full_like(bad["mu.weight"], float("nan"))
    return bad


def _http(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urlreq.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urlreq.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


# ------------------------------------------------------------------ engine


@pytest.mark.parametrize("max_batch", [1, 2, 5, 48, 64])
def test_default_buckets_match_jax_ladder(max_batch):
    assert default_buckets(max_batch) == jax_default_buckets(max_batch)


def test_engine_padding_invariance_across_buckets():
    actor = _actor()
    params = _params(actor)
    eng = PolicyEngine(actor, SPEC, max_batch=16, device="cpu")
    obs = _obs(5)
    batched = eng.act(params, obs, deterministic=True)  # bucket 8, 3 pad rows
    assert eng.bucket_for(5) == 8 and batched.shape == (5, ACT_DIM)
    for i in range(5):
        single = eng.act(params, obs[i:i + 1], deterministic=True)  # bucket 2
        np.testing.assert_allclose(single[0], batched[i], atol=1e-6, rtol=0)


def test_engine_max_batch_one_pads_to_bucket_two():
    actor = _actor()
    eng = PolicyEngine(actor, SPEC, max_batch=1, device="cpu")
    assert eng.buckets == (2,)
    out = eng.act(_params(actor), _obs(1), deterministic=True)
    assert out.shape == (1, ACT_DIM)
    assert eng.compiled_buckets() == {(2, True)}


def test_engine_nan_params_raise_non_finite():
    actor = _actor()
    eng = PolicyEngine(actor, SPEC, max_batch=4, device="cpu")
    with pytest.raises(NonFiniteActionError):
        eng.act(_poisoned(_params(actor)), _obs(3), deterministic=True)


def test_engine_sampled_needs_generator_and_is_reproducible():
    actor = _actor()
    params = _params(actor)
    eng = PolicyEngine(actor, SPEC, max_batch=4, device="cpu")
    with pytest.raises(ValueError):
        eng.act(params, _obs(2), None, deterministic=False)
    a = eng.act(params, _obs(2), torch.Generator().manual_seed(1), deterministic=False)
    b = eng.act(params, _obs(2), torch.Generator().manual_seed(1), deterministic=False)
    np.testing.assert_array_equal(a, b)
    assert np.all(np.abs(a) <= ACT_LIMIT)


def test_engine_warmup_counts_every_bucket_once():
    actor = _actor()
    eng = PolicyEngine(actor, SPEC, max_batch=8, device="cpu")
    warmed = eng.warmup(_params(actor))
    assert warmed == [(b, d) for b in (2, 4, 8) for d in (True, False)]
    stats = eng.compile_stats()
    assert stats["compiles_total"] == 6 and stats["live_compiles"] == 0
    assert set(stats) == {
        "compiles_total", "live_compiles", "bundle_compiles", "bundle_loaded", "buckets",
    }
    assert stats["buckets"]["4"] == {"warmup": 2, "live": 0, "bundle": 0}


def test_entry_points_refuse_to_start_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PolicyEngine(_actor(), SPEC)
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelRegistry()


# ------------------------------------------------------------- checkpoints


def test_checkpoint_round_trip_and_latest(tmp_path):
    actor = _actor()
    assert latest_epoch(tmp_path) is None
    save_actor(tmp_path, 1, actor, CFG)
    save_actor(tmp_path, 3, actor, CFG)
    (tmp_path / "epoch_7").mkdir()  # half-written: no meta.json
    assert latest_epoch(tmp_path) == 3
    state, meta = restore_actor_params(tmp_path)
    assert meta["epoch"] == 3 and SACConfig.from_json(meta["config"]) == CFG
    for k, v in actor.state_dict().items():
        assert torch.equal(state[k], v)


# ---------------------------------------------------------------- registry


def test_registry_reload_rejects_nan_and_keeps_last_good(tmp_path):
    actor = _actor()
    save_actor(tmp_path, 1, actor, CFG)
    reg = ModelRegistry(device="cpu")
    info = reg.register("default", actor, SPEC, ckpt_dir=str(tmp_path), max_batch=4)
    assert info == {"slot": "default", "epoch": 1, "generation": 0}
    engine, params0, gen0 = reg.acquire()
    before = engine.act(params0, _obs(2), deterministic=True)
    assert reg.reload()["default"]["status"] == "noop"

    save_actor(tmp_path, 2, _poisoned(_params(actor)), CFG)
    status = reg.reload()["default"]
    assert status["status"] == "rejected" and status["generation"] == 0
    _, params, gen = reg.acquire()
    assert gen == 0 and params is params0
    assert reg.slots()["default"]["reload_rejected_total"] == 1

    save_actor(tmp_path, 3, _actor(seed=1), CFG)
    status = reg.reload()["default"]
    assert status == {"status": "ok", "reloaded": True, "epoch": 3, "generation": 1}
    engine, params, gen = reg.acquire()
    assert gen == 1 and reg.epoch_of() == 3
    after = engine.act(params, _obs(2), deterministic=True)
    assert not np.allclose(before, after)
    reg.close()


def test_registry_refuses_nan_registration_and_nan_swap(tmp_path):
    actor = _actor()
    save_actor(tmp_path, 1, _poisoned(_params(actor)), CFG)
    reg = ModelRegistry(device="cpu")
    with pytest.raises(ValueError, match="non-finite"):
        reg.register("bad", actor, SPEC, ckpt_dir=str(tmp_path), warmup=False)
    reg.register("good", actor, SPEC, params=_params(actor), warmup=False)
    with pytest.raises(ValueError, match="non-finite"):
        reg.swap("good", _poisoned(_params(actor)))
    assert reg.swap("good", _params(_actor(seed=2)), epoch=5) == 1
    assert reg.epoch_of("good") == 5


# ----------------------------------------------------------------- batcher


@pytest.mark.parametrize("mode", ["continuous", "group"])
def test_batcher_serves_both_modes_and_splits_oversized(mode):
    actor = _actor()
    params = _params(actor)
    reg = ModelRegistry(device="cpu")
    reg.register("default", actor, SPEC, params=params, max_batch=4, warmup=False)
    with MicroBatcher(reg, max_batch=4, max_wait_ms=1.0, mode=mode) as batcher:
        obs = _obs(10, seed=3)
        res = batcher.act(obs, deterministic=True)  # 10 rows > max_batch 4
        single = batcher.act(obs[0], deterministic=True)  # unbatched
    assert res.action.shape == (10, ACT_DIM) and single.action.shape == (ACT_DIM,)
    want = reg.acquire()[0].act(params, obs[:4], deterministic=True)
    np.testing.assert_allclose(res.action[:4], want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(single.action, res.action[0], atol=1e-6, rtol=0)


def test_batcher_generator_state_round_trips():
    actor = _actor()
    reg = ModelRegistry(device="cpu")
    reg.register("default", actor, SPEC, params=_params(actor), max_batch=4, warmup=False)
    obs = _obs(3, seed=4)
    with MicroBatcher(reg, seed=7) as a:
        first = a.act(obs, deterministic=False).action
        state = a.export_key()
        second = a.act(obs, deterministic=False).action
    with MicroBatcher(reg, seed=7) as b:
        np.testing.assert_array_equal(b.act(obs, deterministic=False).action, first)
    with MicroBatcher(reg, seed=123) as c:
        c.import_key(state)
        np.testing.assert_array_equal(c.act(obs, deterministic=False).action, second)
    assert not np.array_equal(first, second)


def test_parse_obs_rejects_pytree_observations():
    assert _parse_obs([[1, 2, 3]], ObsSpec((3,))).dtype == np.float32
    with pytest.raises(ValueError):
        _parse_obs({"features": [1], "frame": [2]}, ObsSpec((3,)))


# --------------------------------------------------------------- HTTP path


def test_http_server_endpoints(tmp_path):
    actor = _actor()
    save_actor(tmp_path, 1, actor, CFG)
    reg = ModelRegistry(device="cpu")
    reg.register("default", actor, SPEC, ckpt_dir=str(tmp_path), max_batch=8)
    server = PolicyServer(reg, port=0, max_batch=8).start()
    try:
        obs = _obs(3, seed=5)
        det = _http(server.address + "/act", {"obs": obs.tolist(), "deterministic": True})
        assert det["generation"] == 0 and det["epoch"] == 1 and det["model"] == "default"
        assert np.asarray(det["action"]).shape == (3, ACT_DIM)
        sam = _http(server.address + "/act", {"obs": obs.tolist(), "deterministic": False})
        act = np.asarray(sam["action"])
        assert act.shape == (3, ACT_DIM) and np.all(np.abs(act) <= ACT_LIMIT)
        health = _http(server.address + "/healthz")
        assert health["status"] == "ok" and health["slots"]["default"]["epoch"] == 1
        save_actor(tmp_path, 2, _actor(seed=3), CFG)
        reload = _http(server.address + "/reload", {})
        assert reload["reload"]["default"]["status"] == "ok"
        assert _http(server.address + "/act", {"obs": obs.tolist()})["generation"] == 1
        metrics = _http(server.address + "/metrics")
        assert metrics["responses_total"] == 3 and metrics["errors_total"] == 0
        assert metrics["live_compiles"] == 0 and metrics["p50_ms"] > 0
        with pytest.raises(urlreq.HTTPError) as err:
            _http(server.address + "/act", {"obs": [[1.0]]})
        assert err.value.code == 400
    finally:
        assert server.close()["server_thread_stopped"]


def test_served_sequence_action_matches_jax_policy_engine():
    """The acceptance bar: JAX SequenceActor params, bridged into the
    port and served over HTTP, answer what the JAX engine answers."""
    jactor = JaxSequenceActor(
        act_dim=ACT_DIM, d_model=32, num_heads=2, num_layers=2, max_len=T,
        act_limit=ACT_LIMIT,
    )
    jparams = jactor.init(jax.random.key(0), jnp.zeros((T, OBS_DIM)), jax.random.key(1))
    obs = _obs(5, seed=6)
    want = JaxPolicyEngine(
        jactor, jax.ShapeDtypeStruct((T, OBS_DIM), jnp.float32), max_batch=8
    ).act(jparams, obs, deterministic=True)
    port = actor_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), CFG, (T, OBS_DIM), ACT_DIM, ACT_LIMIT
    )
    reg = ModelRegistry(device="cpu")
    reg.register("default", port, SPEC, params=_params(port), max_batch=8)
    server = PolicyServer(reg, port=0, max_batch=8).start()
    try:
        got = _http(server.address + "/act", {"obs": obs.tolist(), "deterministic": True})
    finally:
        server.close()
    np.testing.assert_allclose(np.asarray(got["action"]), want, atol=1e-5, rtol=0)


# --------------------------------------------------------------------- CLI


def _cli(ckpt, *extra):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.Popen(
        [sys.executable, "-m", "torch_actor_critic_tpu_torch.serve",
         "--ckpt-dir", str(ckpt), "--obs-dim", str(OBS_DIM),
         "--act-dim", str(ACT_DIM), "--act-limit", str(ACT_LIMIT),
         "--port", "0", "--max-batch", "4", "--poll-interval", "0", *extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def test_cli_serves_and_drains_on_sigterm(tmp_path):
    save_actor(tmp_path, 1, _actor(), CFG)
    proc = _cli(tmp_path, "--device", "cpu")
    try:
        line = proc.stdout.readline()
        ready = json.loads(line)
        assert ready["slots"]["default"]["epoch"] == 1
        out = _http(ready["serving"] + "/act", {"obs": _obs(None).tolist()})
        assert np.asarray(out["action"]).shape == (ACT_DIM,)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


def test_cli_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present, so the default device works")
    save_actor(tmp_path, 1, _actor(), CFG)
    proc = _cli(tmp_path)
    try:
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode != 0 and "CUDA" in err


# ------------------------------------------------------- import isolation

_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "torch_actor_critic_tpu")


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in _FORBIDDEN


def test_port_and_chip_smoke_import_no_jax():
    """Importing every module of the port (and chip_smoke.py) loads
    neither JAX nor the JAX package — in a fresh interpreter, since this
    test process already imported both."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import torch_actor_critic_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{_FORBIDDEN!r})\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 20  # every submodule was walked


def test_no_port_file_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            offenders += [f"{path.name}: {n}" for n in names if _forbidden(n)]
    assert not offenders, offenders


def test_latency_hist_snapshot_shape():
    """/metrics latency comes from the copied fixed-bucket histogram."""
    from torch_actor_critic_tpu_torch.serve.metrics import ServeMetrics

    m = ServeMetrics()
    for ms in (1.0, 2.0, 4.0):
        m.record_done(ms)
    snap = m.snapshot()
    assert snap["responses_total"] == 3 and math.isclose(snap["max_ms"], 4.0)
    assert snap["p50_ms"] <= snap["p99_ms"]


def test_checkpointer_surface_matches_registry_use(tmp_path):
    ckpt = Checkpointer(tmp_path)
    with pytest.raises(FileNotFoundError):
        ckpt.peek_meta()
    ckpt.save(4, _actor(), CFG)
    ckpt.refresh()
    assert ckpt.latest_epoch() == 4 and ckpt.peek_meta()["epoch"] == 4
    state, meta = ckpt.restore_actor_params()
    assert meta["epoch"] == 4 and "trunk.pos_embedding" in state
    ckpt.close()
