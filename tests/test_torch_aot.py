"""The port's ``aot/`` on the CPU, held against the JAX package's
(``tests/test_aot.py``): the manifest derived from the analyzer's
checked tables, the warm-start bundle's layout, checks and rejections,
a bundle-armed warm-up (bundle hits, no builds, actions bitwise the
unbundled engine's and within 1e-6 of JAX's ``PolicyEngine`` on the same
weights), the registry's counted fallback, the warm pool, ``serve
--warm-start auto``, ``train --emit-bundle`` and a learner restarted on
``--compile-cache``, and the kernel libraries' resolution order (bundle,
cache, ``nvcc``) with stand-in libraries and a stand-in compiler: the
CPU has no ``nvcc`` and launches no kernel.
"""

import json
import logging
import os
import shutil
import signal
import stat
import subprocess
import sys
from pathlib import Path
from urllib import request as urlreq

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_actor_critic_tpu import aot as jax_aot
from torch_actor_critic_tpu.models import SequenceActor as JaxSequenceActor
from torch_actor_critic_tpu.serve.engine import PolicyEngine as JaxPolicyEngine
from torch_actor_critic_tpu_torch import aot
from torch_actor_critic_tpu_torch.analysis.reachability import ENTRY_POINTS
from torch_actor_critic_tpu_torch.aot import bundle as bundle_mod
from torch_actor_critic_tpu_torch.aot.manifest import program_filename, program_name
from torch_actor_critic_tpu_torch.diagnostics.watchdog import get_watchdog
from torch_actor_critic_tpu_torch.ops import _kernels
from torch_actor_critic_tpu_torch.serve import ModelRegistry, ObsSpec, PolicyEngine
from torch_actor_critic_tpu_torch.serve.engine import default_buckets
from torch_actor_critic_tpu_torch.utils.checkpoint import save_actor
from torch_actor_critic_tpu_torch.utils.config import SACConfig
from torch_actor_critic_tpu_torch.weights import actor_from_jax

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
T, OBS_DIM, ACT_DIM, ACT_LIMIT = 8, 3, 1, 2.0
CFG = SACConfig(history_len=T, seq_d_model=32, seq_num_heads=2, seq_num_layers=2)
SPEC = ObsSpec((T, OBS_DIM), np.float32)


def _jax_actor_and_params(seed=0):
    jactor = JaxSequenceActor(act_dim=ACT_DIM, d_model=32, num_heads=2, num_layers=2,
                              max_len=T, act_limit=ACT_LIMIT)
    jparams = jactor.init(jax.random.key(seed), jnp.zeros((T, OBS_DIM)), jax.random.key(1))
    return jactor, jparams


def _port_actor(jparams, config=CFG):
    return actor_from_jax(jax.tree_util.tree_map(np.asarray, jparams), config,
                          (T, OBS_DIM), ACT_DIM, ACT_LIMIT)


def _params(actor):
    return {k: v.detach().clone() for k, v in actor.state_dict().items()}


def _obs(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, T, OBS_DIM)).astype(np.float32)


def _stand_in_libraries(directory: Path) -> None:
    """A file under this tree's name for every kernel source: what a
    cache holds after a build (the CPU launches none of them)."""
    directory.mkdir(parents=True, exist_ok=True)
    for source in _kernels.sources():
        (directory / _kernels.lib_name(source)).write_bytes(b"stand-in for " + source.encode())


@pytest.fixture
def loader_state():
    """Leave the kernel loader as found: no cache dir chosen, no bundle
    armed, nothing resolved or loaded, the env var unset."""
    yield
    aot.cache.disable_persistent_cache()
    _kernels.arm_bundle(None)
    for name in [n for n in _kernels._loaded if n == "empty"]:
        _kernels._loaded.pop(name)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """One bundle for the read-only tests: build_bundle over stand-in
    libraries in a cache directory, on the CPU."""
    base = tmp_path_factory.mktemp("aot")
    _stand_in_libraries(base / "cache")
    jactor, jparams = _jax_actor_and_params()
    actor = _port_actor(jparams)
    _kernels.set_cache_dir(base / "cache")
    try:
        bundle = aot.build_bundle(base / "warm_start", actor, SPEC, _params(actor),
                                  max_batch=4, device="cpu")
    finally:
        _kernels.set_cache_dir(None)
    return bundle, actor, jactor, jparams


# ---------------------------------------------------------------- manifest


def test_manifest_matches_entry_points_exactly():
    table = aot.entry_point_table()
    assert set(table) == set(ENTRY_POINTS)
    assert all(isinstance(v, bool) for v in table.values())
    assert table["serve/forward"] is True
    assert aot.bundled_entry_points() == ("serve/forward",) == jax_aot.bundled_entry_points()
    assert not any(v for k, v in table.items() if k.startswith("train/"))


def test_manifest_raises_on_table_divergence(monkeypatch):
    import torch_actor_critic_tpu_torch.aot.manifest as manifest_mod

    monkeypatch.setattr(manifest_mod, "ENTRY_POINTS",
                        dict(ENTRY_POINTS, **{"serve/new_thing": ("x.py", "f")}))
    with pytest.raises(aot.ManifestError, match="serve/new_thing"):
        manifest_mod.entry_point_table()


def test_program_naming_keeps_jax_format():
    from torch_actor_critic_tpu.aot.manifest import program_filename as jax_filename
    from torch_actor_critic_tpu.aot.manifest import program_name as jax_name

    for bucket, det in ((4, True), (16, False), (64, True)):
        name = program_name("serve/forward", bucket, det)
        assert name == jax_name("serve/forward", bucket, det)
        assert program_filename(name) == jax_filename(name).replace(".jexp", ".sig.json")
    assert program_name("serve/forward", 4, True) == "serve/forward[b4].det"


@pytest.mark.parametrize("max_batch", [1, 4, 64])
@pytest.mark.parametrize("det_only", [False, True])
def test_serve_programs_equal_jax_for_the_engine_ladder(max_batch, det_only):
    buckets = PolicyEngine(_port_actor(_jax_actor_and_params()[1]), SPEC,
                           max_batch=max_batch, device="cpu").buckets
    assert buckets == default_buckets(max_batch)
    got = [(s.name, s.identity, s.bucket, s.deterministic)
           for s in aot.serve_programs(buckets, det_only)]
    want = [(s.name, s.identity, s.bucket, s.deterministic)
            for s in jax_aot.serve_programs(buckets, det_only)]
    assert got == want and len(got) == len(buckets) * (1 if det_only else 2)


# ------------------------------------------------------------------ bundle


def test_bundle_layout_and_manifest(built):
    bundle, _, _, _ = built
    manifest = json.loads((bundle.root / "MANIFEST.json").read_text())
    assert manifest["format"] == 1 and manifest["buckets"] == [2, 4]
    assert manifest["max_batch"] == 4 and manifest["deterministic_only"] is False
    assert manifest["entry_points"] == aot.entry_point_table()
    assert manifest["fingerprint"] == aot.environment_fingerprint("cpu")
    assert set(manifest["fingerprint"]) == {"format", "torch", "cuda", "device_name",
                                            "capability", "device_count", "mesh_shape",
                                            "kernel_digest"}
    assert manifest["kernels"] == {s: _kernels.lib_name(s) for s in _kernels.sources()}
    assert sorted(p.name for p in bundle.kernels_dir.iterdir()) == sorted(
        manifest["kernels"].values())
    assert list(manifest["programs"]) == [s.name for s in aot.serve_programs((2, 4))]
    for name, entry in manifest["programs"].items():
        assert entry["file"] == program_filename(name)
        assert json.loads((bundle.root / "programs" / entry["file"]).read_text()) == \
            entry["signature"]
        sig = entry["signature"]
        assert sig["obs"] == [[[entry["bucket"], T, OBS_DIM], "float32"]]
        assert sig["deterministic"] == entry["deterministic"]
        assert sig["precision"] == "f32" and "mu.weight" in sig["params"]
    bundle.check("cpu")


def _stale(bundle, tmp_path, edit):
    root = tmp_path / "stale"
    shutil.copytree(bundle.root, root)
    manifest = json.loads((root / "MANIFEST.json").read_text())
    edit(root, manifest)
    (root / "MANIFEST.json").write_text(json.dumps(manifest))
    return root


def _set_fingerprint(root, m):
    m["fingerprint"]["torch"] = "0.0.0-elsewhere"


def _future_format(root, m):
    m["format"] = 2


def _drop_library(root, m):
    (root / "kernels" / m["kernels"]["flash_fwd"]).unlink()


def _other_sources(root, m):
    m["kernels"]["flash_bwd"] = "libflash_bwd_0000000000000000.so"


@pytest.mark.parametrize("edit,match,at", [
    (_set_fingerprint, "torch: bundle='0.0.0-elsewhere'", "check"),
    (_future_format, "format 2", "load"),
    (_drop_library, "flash_fwd", "check"),
    (_other_sources, "flash_bwd", "check"),
])
def test_environment_drift_rejected_naming_the_cause(built, tmp_path, edit, match, at):
    root = _stale(built[0], tmp_path, edit)
    with pytest.raises(aot.BundleMismatchError, match=match):
        aot.load_bundle(root).check("cpu")
    if at == "check":
        aot.load_bundle(root)  # the manifest itself still loads


def test_missing_manifest_is_no_bundle(tmp_path):
    with pytest.raises(FileNotFoundError, match="MANIFEST.json"):
        aot.load_bundle(tmp_path)


@pytest.mark.parametrize("drift,match", [
    ("obs_spec", "signature mismatch"),
    ("bucket_ladder", "no program 'serve/forward\\[b8\\].det'"),
    ("param_shapes", "signature mismatch"),
    ("precision", "signature mismatch"),
])
def test_program_drift_rejected_before_any_dispatch(built, loader_state, drift, match):
    bundle, actor, _, _ = built
    engine_kw = dict(max_batch=4, device="cpu")
    # The check runs before any forward, so the actor need not fit the spec.
    spec = ObsSpec((T, OBS_DIM + 1), np.float32) if drift == "obs_spec" else SPEC
    if drift == "bucket_ladder":
        engine_kw["max_batch"] = 8
    if drift == "param_shapes":
        cfg = CFG.replace(seq_d_model=16)
        from torch_actor_critic_tpu_torch.models import build_actor

        actor = build_actor(cfg, (T, OBS_DIM), ACT_DIM, ACT_LIMIT)
    if drift == "precision":
        engine_kw["precision"] = "bf16"
    engine = PolicyEngine(actor, spec, **engine_kw)
    with pytest.raises(aot.BundleMismatchError, match=match):
        engine.warmup(engine.prepare_params(_params(actor)), bundle=bundle)
    assert engine.compile_stats()["compiles_total"] == 0  # nothing dispatched
    assert _kernels._bundle_dir is None  # and nothing armed


def test_bundle_armed_warmup_counts_hits_no_builds_and_matches(built, loader_state):
    bundle, actor, jactor, jparams = built
    wd = get_watchdog().install()
    wd.reset()
    params = _params(actor)
    engine = PolicyEngine(actor, SPEC, max_batch=4, device="cpu")
    engine.warmup(params, bundle=bundle)
    n_programs = len(aot.serve_programs(engine.buckets))
    stats = engine.compile_stats()
    assert stats["bundle_loaded"] is True and stats["bundle_compiles"] == n_programs
    assert sum(b["warmup"] for b in stats["buckets"].values()) == 0
    assert stats["live_compiles"] == 0
    snap = wd.snapshot()
    assert snap["bundle_hits"] == n_programs and snap["builds_total"] == 0
    assert snap["bundle_rejected"] == 0 and snap["live_captures"] == 0
    assert _kernels._bundle_dir == bundle.kernels_dir
    plain = PolicyEngine(actor, SPEC, max_batch=4, device="cpu")
    plain.warmup(params)
    obs = _obs(3, seed=4)
    got = engine.act(params, obs)
    assert np.array_equal(got, plain.act(params, obs))
    gen_a, gen_b = (torch.Generator().manual_seed(5) for _ in range(2))
    assert np.array_equal(engine.act(params, obs, gen_a, False),
                          plain.act(params, obs, gen_b, False))
    want = JaxPolicyEngine(jactor, jax.ShapeDtypeStruct((T, OBS_DIM), jnp.float32),
                           max_batch=4).act(jparams, obs, deterministic=True)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_registry_rejection_counts_and_serves(built, tmp_path, loader_state):
    bundle, actor, _, _ = built
    root = _stale(bundle, tmp_path, lambda r, m: m["programs"]["serve/forward[b2].det"][
        "signature"]["params"].update({"mu.weight": [[9, 9], "float32"]}))
    broken = aot.load_bundle(root)
    broken.check("cpu")  # the environment fits; the program does not
    broken.arm()
    wd = get_watchdog().install()
    wd.reset()
    reg = ModelRegistry(device="cpu")
    try:
        reg.register("default", actor, SPEC, params=_params(actor), max_batch=4,
                     bundle=broken)
        snap = wd.snapshot()
        assert snap["bundle_rejected"] == 1 and snap["bundle_hits"] == 0
        assert any("signature mismatch" in r and "slot 'default'" in r
                   for r in snap["bundle_reject_reasons"])
        assert _kernels._bundle_dir is None  # the slot's kernels come from the cache
        assert reg.slots()["default"]["bundle_loaded"] is False
        engine, params, _ = reg.acquire("default")
        stats = engine.compile_stats()
        assert stats["bundle_compiles"] == 0
        assert sum(b["warmup"] for b in stats["buckets"].values()) == 4
        act = engine.act(params, _obs(2))
        assert np.isfinite(act).all() and engine.compile_stats()["live_compiles"] == 0
    finally:
        reg.close()


def test_warm_pool_draw_with_a_bundle_answers_its_first_act(built, loader_state):
    bundle, actor, _, _ = built
    params = _params(actor)
    killed = []

    def spawn():
        engine = PolicyEngine(actor, SPEC, max_batch=4, device="cpu")
        engine.warmup(params, bundle=bundle)
        return engine, f"inproc://{id(engine)}"

    pool = aot.WarmPool(spawn, killed.append, size=1)
    try:
        worker = pool.draw(timeout=120)
        assert worker is not None
        act = worker.handle.act(params, _obs(1))
        assert act.shape == (1, ACT_DIM) and np.isfinite(act).all()
        stats = worker.handle.compile_stats()
        assert stats["bundle_loaded"] is True and stats["live_compiles"] == 0
    finally:
        pool.shutdown()


def _http(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urlreq.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urlreq.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def test_serve_warm_start_auto_resolves_the_checkpoints_parent(built, tmp_path):
    """``serve --warm-start auto`` loads ``<ckpt parent>/warm_start``
    (where ``train --emit-bundle`` writes it), counts its programs as
    bundle hits on ``/metrics`` and builds nothing."""
    bundle, actor, _, _ = built
    ckpt = tmp_path / "run" / "checkpoints"
    save_actor(ckpt, 1, actor, CFG)
    assert aot.default_bundle_dir(ckpt) == tmp_path / "run" / "warm_start"
    shutil.copytree(bundle.root, tmp_path / "run" / "warm_start")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop(aot.CACHE_ENV_VAR, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch_actor_critic_tpu_torch.serve", "--ckpt-dir", str(ckpt),
         "--obs-dim", str(OBS_DIM), "--act-dim", str(ACT_DIM), "--act-limit", str(ACT_LIMIT),
         "--port", "0", "--max-batch", "4", "--poll-interval", "0", "--device", "cpu",
         "--warm-start", "auto", "--compile-cache", str(tmp_path / "cache")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["slots"]["default"]["bundle_loaded"] is True
        out = _http(ready["serving"] + "/act", {"obs": _obs(4).tolist()})
        assert np.asarray(out["action"]).shape == (4, ACT_DIM)
        xla = _http(ready["serving"] + "/metrics")["xla"]
        assert (xla["bundle_hits"], xla["bundle_rejected"], xla["builds_total"]) == (4, 0, 0)
        assert (tmp_path / "cache").is_dir()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


def test_cli_cold_start_counts_a_rejected_bundle_and_serves_without_it(built, tmp_path,
                                                                       loader_state):
    from torch_actor_critic_tpu_torch.serve.__main__ import cold_start, parse_arguments

    root = _stale(built[0], tmp_path, _set_fingerprint)
    wd = get_watchdog()
    wd.reset()
    args = parse_arguments(["--ckpt-dir", "x", "--warm-start", str(root),
                            "--compile-cache", str(tmp_path / "c")])
    assert cold_start(args, "x", "cpu") is None
    snap = wd.snapshot()
    assert snap["bundle_rejected"] == 1 and "torch" in snap["bundle_reject_reasons"][-1]
    assert os.environ[aot.CACHE_ENV_VAR] == str(tmp_path / "c")
    assert _kernels.cache_dir() == tmp_path / "c" and _kernels._bundle_dir is None
    args = parse_arguments(["--ckpt-dir", str(tmp_path / "none" / "ckpt"), "--warm-start",
                            "auto"])
    assert cold_start(args, args.ckpt_dir, "cpu") is None  # no bundle there: a warning
    assert wd.snapshot()["bundle_rejected"] == 1


# ------------------------------------------------------------------ train


def _tiny(**kw):
    base = dict(history_len=4, seq_d_model=16, seq_num_heads=2, seq_num_layers=1,
                hidden_sizes=(16, 16), batch_size=16, epochs=2, steps_per_epoch=40,
                start_steps=10, update_after=50, update_every=10, buffer_size=500,
                save_every=1, bundle_max_batch=4)
    return SACConfig(**{**base, **kw})


def test_emit_bundle_writes_once_at_the_first_update_epoch(tmp_path, monkeypatch, loader_state):
    from torch_actor_critic_tpu_torch.sac.trainer import Trainer
    from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer

    _stand_in_libraries(tmp_path / "cache")
    aot.enable_persistent_cache(str(tmp_path / "cache"))
    calls = []
    real = bundle_mod.build_bundle

    def spy(*a, **kw):
        calls.append(len(epochs))  # epochs reported before the build
        return real(*a, **kw)

    monkeypatch.setattr(bundle_mod, "build_bundle", spy)
    epochs = []
    ckpt = Checkpointer(tmp_path / "run" / "checkpoints")
    tr = Trainer("PendulumNumpy-v1", _tiny(emit_bundle=True, epochs=3), checkpointer=ckpt,
                 seed=3, device="cpu")
    try:
        tr.train(on_epoch=lambda e, m: epochs.append(e))
    finally:
        tr.close()
    # Epoch 0 (steps 0-39) runs no update; epoch 1 is the first with
    # updates, and builds the bundle after its save, before it reports.
    assert epochs == [0, 1, 2] and calls == [1]
    b = aot.load_bundle(tmp_path / "run" / "warm_start")
    b.check("cpu")
    assert list(b.programs()) == [s.name for s in aot.serve_programs((2, 4))]
    assert b.libraries() == {s: _kernels.lib_name(s) for s in _kernels.sources()}


def test_emit_bundle_failure_is_logged_and_training_goes_on(tmp_path, monkeypatch, caplog,
                                                           loader_state):
    from torch_actor_critic_tpu_torch.sac.trainer import Trainer
    from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer

    aot.enable_persistent_cache(str(tmp_path / "empty-cache"))

    def no_nvcc():
        raise _kernels.KernelBuildError("nvcc not found (stand-in)")

    monkeypatch.setattr(_kernels, "_nvcc", no_nvcc)
    ckpt = Checkpointer(tmp_path / "run" / "checkpoints")
    tr = Trainer("PendulumNumpy-v1", _tiny(emit_bundle=True), checkpointer=ckpt, seed=3,
                 device="cpu")
    with caplog.at_level(logging.ERROR):
        try:
            metrics = tr.train()
        finally:
            tr.close()
    assert np.isfinite(metrics["loss_q"]) and ckpt.peek_meta()["epoch"] == 1
    assert any("warm-start bundle" in r.getMessage() and r.exc_info for r in caplog.records)
    assert not (tmp_path / "run" / "warm_start" / "MANIFEST.json").exists()


def test_learner_restart_on_the_compile_cache_resumes_bitwise(tmp_path, loader_state):
    """``train --compile-cache DIR`` arms and exports the cache; a
    ``--run`` restart takes it from the run's config, reports the
    cache's counts (no builds) and resumes bitwise: the restarted run's
    last epoch equals the uninterrupted run's."""
    from torch_actor_critic_tpu_torch import train as train_cli

    cache = str(tmp_path / "cache")
    common = ["--environment", "PendulumNumpy-v1", "--history-len", "4", "--device", "cpu",
              "--seq-d-model", "16", "--seq-num-heads", "2", "--seq-num-layers", "1",
              "--batch-size", "16", "--steps-per-epoch", "40", "--start-steps", "10",
              "--update-after", "10", "--update-every", "10", "--buffer-size", "500",
              "--seed", "4", "--compile-cache", cache]
    straight = train_cli.main([*common, "--epochs", "2", "--runs-root", str(tmp_path / "a")])
    assert os.environ[aot.CACHE_ENV_VAR] == cache and aot.current_cache_dir() == cache
    aot.cache.disable_persistent_cache()
    train_cli.main([*common, "--epochs", "1", "--runs-root", str(tmp_path / "b")])
    aot.cache.disable_persistent_cache()
    (run_id,) = os.listdir(tmp_path / "b" / "Default")
    get_watchdog().reset()
    restarted = train_cli.main(["--run", run_id, "--runs-root", str(tmp_path / "b"),
                                "--device", "cpu"])
    assert aot.current_cache_dir() == cache  # from the stored config
    for key in ("loss_q", "loss_pi", "reward"):
        assert restarted[key] == straight[key]
    assert restarted["watchdog_builds"] == 0 and restarted["watchdog_cache_misses"] == 0
    assert restarted["watchdog_bundle_rejected"] == 0


# ---------------------------------------------------------- library resolution


def _stand_in_nvcc(directory: Path) -> Path:
    """A compiler that writes its ``-o`` file: the build path without
    the CUDA toolkit."""
    script = directory / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then shift; out=\"$1\"; fi; shift; done\n"
        "echo built > \"$out\"\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return script


def test_library_resolution_bundle_then_cache_then_nvcc(tmp_path, monkeypatch, loader_state):
    wd = get_watchdog().install()
    wd.reset()
    bundle_dir, cache = tmp_path / "bundle" / "kernels", tmp_path / "cache"
    bundle_dir.mkdir(parents=True)
    cache.mkdir()
    (bundle_dir / _kernels.lib_name("flash_fwd")).write_bytes(b"bundled")
    (cache / _kernels.lib_name("flash_fwd")).write_bytes(b"cached")
    (cache / _kernels.lib_name("flash_bwd")).write_bytes(b"cached")
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(_stand_in_nvcc(tmp_path)))
    aot.enable_persistent_cache(str(cache))
    _kernels.arm_bundle(bundle_dir)
    assert _kernels.library("flash_fwd") == bundle_dir / _kernels.lib_name("flash_fwd")
    assert _kernels.library("flash_bwd") == cache / _kernels.lib_name("flash_bwd")
    built = _kernels.build_all(["pixel_gather"])
    assert set(built) == {"pixels"}
    assert (cache / _kernels.lib_name("pixels")).read_text() == "built\n"
    assert aot.cache_entries(str(cache)) == 3
    assert _kernels.library("flash_fwd") == bundle_dir / _kernels.lib_name("flash_fwd")
    snap = wd.snapshot()
    assert (snap["cache_hits_total"], snap["bundle_library_hits"],
            snap["cache_misses_total"], snap["builds_total"]) == (2, 1, 1, 1)
    # A new process with the cache now full: every source a hit, no build.
    _kernels.arm_bundle(None)
    _stand_in_nvcc(tmp_path).unlink()
    assert _kernels.build_all(["flash_fwd", "flash_bwd_dq", "pixel_gather"]) == {}
    assert wd.snapshot()["cache_misses_total"] == 1


def test_no_bundle_no_cache_no_nvcc_raises(tmp_path, monkeypatch, loader_state):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    aot.enable_persistent_cache(str(tmp_path / "cache"))
    with pytest.raises(_kernels.KernelBuildError, match="nvcc not found"):
        _kernels.library("flash_fwd")


def test_a_bundled_library_is_what_load_opens(tmp_path, loader_state):
    """A real shared library in a bundle's ``kernels/`` (the empty
    kernel's C symbol, built by g++): ``load`` opens the bundle's file."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build a stand-in library")
    kernels_dir = tmp_path / "kernels"
    kernels_dir.mkdir()
    src = tmp_path / "floor.c"
    src.write_text("int tac_empty(int g, int b, int s, void *st) { return g * 0 + 7 - 7; }\n")
    out = kernels_dir / _kernels.lib_name("floor")
    subprocess.run([gxx, "-x", "c", "-shared", "-fPIC", "-o", str(out), str(src)], check=True)
    aot.enable_persistent_cache(str(tmp_path / "cache"))
    _kernels.arm_bundle(kernels_dir)
    _kernels._loaded.pop("empty", None)
    fn = _kernels.load("empty")
    assert fn(1, 1, 0, None) == 0
    assert _kernels.library("floor") == out
