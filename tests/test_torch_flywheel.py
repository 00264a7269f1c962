"""The port's serve-side transition flywheel (``replay/flywheel.py``,
``POST /outcome``, ``serve --log-transitions``) against the JAX
package's, on the CPU.

One act/outcome script (sampling every Nth act, a bounded pending map,
chunked flushes) goes through both ``TransitionLogger`` s, flat and
visual: the same counters and the same chunk rows, bitwise. Then the
port's CPU server over HTTP: ``/act`` under an ``X-Request-Id``,
``/outcome`` echoing it, the ``flywheel`` section of ``/metrics``, the
400/404 answers; and the CLI: ``serve --log-transitions DIR
--log-sample-every 2``, SIGTERM, the drain's flush of the partial chunk,
then ``train --offline --offline-reg bc`` from that directory.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path
from urllib import error as urlerr
from urllib import request as urlreq

import numpy as np
import pytest
import torch

from torch_actor_critic_tpu import replay as jreplay
from torch_actor_critic_tpu.core.types import MultiObservation as JMulti
from torch_actor_critic_tpu_torch import replay
from torch_actor_critic_tpu_torch.core.types import MultiObservation
from torch_actor_critic_tpu_torch.envs.wrappers import ObsSpec
from torch_actor_critic_tpu_torch.models import build_actor
from torch_actor_critic_tpu_torch.utils.checkpoint import save_actor
from torch_actor_critic_tpu_torch.utils.config import SACConfig

REPO = Path(__file__).resolve().parents[1]
OBS_DIM, ACT_DIM, ACT_LIMIT, T = 3, 1, 2.0, 4
CFG = SACConfig(history_len=T, seq_d_model=16, seq_num_heads=2, seq_num_layers=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(logger, obs_of, n=8):
    """The JAX test's script: n acts, outcomes for an evicted, an
    unsampled and three pending ids, then a flush."""
    for i in range(n):
        logger.note_act(f"r{i}", obs_of(i), np.asarray([0.5 + i]))
    results = [logger.note_outcome(rid, -2.0, obs_of(100 + k), k % 2 == 0)
               for k, rid in enumerate(("r1", "r0", "r3", "r5", "r7"))]
    before = logger.tier.rows
    flushed = logger.flush()
    return results, before, flushed


def _flat(i):
    return np.arange(OBS_DIM, dtype=np.float32) + i


def _visual(mod):
    def obs(i):
        rng = np.random.default_rng(i)
        return mod(rng.standard_normal(5).astype(np.float32),
                   rng.integers(0, 256, (6, 6, 3), dtype=np.uint8))
    return obs


@pytest.mark.parametrize("kind", ["flat", "visual"])
def test_flywheel_script_is_jax_bitwise(tmp_path, kind):
    import jax

    if kind == "flat":
        specs = (ObsSpec((OBS_DIM,)), jax.ShapeDtypeStruct((OBS_DIM,), np.float32))
        obs = (_flat, _flat)
    else:
        specs = (MultiObservation(ObsSpec((5,)), ObsSpec((6, 6, 3), np.uint8)),
                 JMulti(jax.ShapeDtypeStruct((5,), np.float32),
                        jax.ShapeDtypeStruct((6, 6, 3), np.uint8)))
        obs = (_visual(MultiObservation), _visual(JMulti))
    out = []
    for mod, spec, obs_of, name in zip((replay, jreplay), specs, obs, ("port", "jax")):
        logger = mod.TransitionLogger(str(tmp_path / name), obs_spec=spec, act_dim=ACT_DIM,
                                      sample_every=2, max_pending=3, chunk_rows=4)
        results, before, flushed = _script(logger, obs_of)
        out.append((logger, results, before, flushed, logger.tier.read_all(),
                    logger.snapshot()))
    (port, results, before, flushed, rows, snap), (_, jresults, jbefore, jflushed, jrows,
                                                   jsnap) = out
    # Every 2nd act sampled (r1, r3, r5, r7); the 3-slot pending map
    # evicted r1 when r7 arrived; r0 was never sampled.
    assert results == jresults == [False, False, True, True, True]
    assert (before, flushed) == (jbefore, jflushed) == (0, 3)
    assert port.acts_sampled_total == 4 and port.pending_evicted_total == 1
    assert port.outcomes_unmatched_total == 2
    assert rows.keys() == jrows.keys()
    for k in rows:
        assert rows[k].dtype == jrows[k].dtype and np.array_equal(rows[k], jrows[k]), k
    np.testing.assert_array_equal(rows["rewards"], [-2.0, -2.0, -2.0])
    np.testing.assert_array_equal(rows["done"], [1.0, 0.0, 1.0])
    assert port.tier.meta == jreplay.DiskTier(tmp_path / "jax").meta
    assert port.tier.meta["source"] == "flywheel"
    strip = ("disk",)
    assert ({k: v for k, v in snap.items() if k not in strip}
            == {k: v for k, v in jsnap.items() if k not in strip})
    assert snap["disk"]["rows"] == jsnap["disk"]["rows"] == 3
    port.close()
    with pytest.raises(ValueError, match="sample_every"):
        replay.TransitionLogger(str(tmp_path / "x"), ObsSpec((3,)), 1, sample_every=0)


def test_flywheel_chunks_at_chunk_rows_and_rotates_under_a_budget(tmp_path):
    logger = replay.TransitionLogger(str(tmp_path / "f"), ObsSpec((OBS_DIM,)), ACT_DIM,
                                     chunk_rows=2, max_bytes=1)
    for i in range(7):
        logger.note_act(f"a{i}", _flat(i), np.asarray([0.1]))
        assert logger.note_outcome(f"a{i}", float(i), _flat(i + 1), False)
    # Full chunks flush as they fill; the byte budget keeps one file.
    snap = logger.snapshot()
    assert snap["logged_rows_total"] == 7 and snap["buffered_rows"] == 1
    assert snap["disk"]["received_total"] == 6 and snap["disk"]["files"] == 1
    logger.close()
    assert replay.DiskTier(tmp_path / "f").received_total == 7


def _http(url, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urlreq.Request(url, data=data, headers={"Content-Type": "application/json",
                                                  **(headers or {})})
    with urlreq.urlopen(req, timeout=30) as r:
        return json.loads(r.read()), dict(r.headers)


def _http_status(url, body):
    try:
        _http(url, body)
    except urlerr.HTTPError as e:
        return e.code
    return 200


def _checkpoint(root):
    actor = build_actor(CFG, (T, OBS_DIM), ACT_DIM, ACT_LIMIT,
                        generator=torch.Generator().manual_seed(0))
    save_actor(root, 1, actor, CFG)
    return ["--ckpt-dir", str(root), "--obs-dim", str(OBS_DIM), "--act-dim", str(ACT_DIM),
            "--act-limit", str(ACT_LIMIT)]


def test_outcome_over_http_on_the_cpu_server(tmp_path):
    from torch_actor_critic_tpu_torch.serve.__main__ import build_server, parse_arguments

    src = _checkpoint(tmp_path / "ckpt")
    args = parse_arguments(src + ["--device", "cpu", "--port", "0", "--poll-interval", "0",
                                  "--max-batch", "4", "--log-transitions",
                                  str(tmp_path / "fly"), "--log-sample-every", "2"])
    server, _ = build_server(args)
    server.start()
    rng = np.random.default_rng(0)
    try:
        matched = 0
        for i in range(6):
            obs = rng.standard_normal((T, OBS_DIM)).astype(np.float32)
            out, headers = _http(server.address + "/act", {"obs": obs.tolist()},
                                 {"X-Request-Id": f"q{i}"})
            assert headers["X-Request-Id"] == f"q{i}"
            res, _ = _http(server.address + "/outcome", {
                "request_id": f"q{i}", "reward": float(i),
                "next_obs": rng.standard_normal((T, OBS_DIM)).tolist(), "done": False})
            assert res == {"logged": i % 2 == 1, "request_id": f"q{i}"}
            matched += res["logged"]
        metrics, _ = _http(server.address + "/metrics")
        fly = metrics["flywheel"]
        assert (fly["acts_seen_total"], fly["acts_sampled_total"]) == (6, 3)
        assert fly["logged_rows_total"] == matched == 3 and fly["buffered_rows"] == 3
        assert _http_status(server.address + "/outcome", {"reward": 1.0}) == 400
        assert _http_status(server.address + "/outcome",
                            {"request_id": "q1", "reward": 1.0}) == 400
        # An id never answered is no error: downsampling drops ids by design.
        res, _ = _http(server.address + "/outcome", {
            "request_id": "q9", "reward": 1.0, "next_obs": [[1.0]]})
        assert res == {"logged": False, "request_id": "q9"}
    finally:
        server.close()
        server.transition_logger.close()
    rows = replay.DiskTier(tmp_path / "fly").read_all()
    assert rows["states"].shape == (3, T, OBS_DIM)
    np.testing.assert_array_equal(rows["rewards"], [1.0, 3.0, 5.0])
    # Without the flag there is no /outcome and no flywheel section.
    args = parse_arguments(src + ["--device", "cpu", "--port", "0", "--poll-interval", "0"])
    server, _ = build_server(args)
    server.start()
    try:
        assert server.transition_logger is None
        assert _http_status(server.address + "/outcome", {"request_id": "x"}) == 404
        assert "flywheel" not in _http(server.address + "/metrics")[0]
    finally:
        server.close()


def test_cli_logs_drains_on_sigterm_and_trains_offline(tmp_path, capsys):
    """``serve --log-transitions DIR --log-sample-every 2``: 10 /act +
    /outcome pairs, SIGTERM; the drain flushes the partial chunk (rows
    on disk = matched outcomes = acts / 2), and ``train --offline
    --offline-reg bc`` trains from DIR for 2 bursts."""
    from torch_actor_critic_tpu_torch import train as train_cli

    fly = tmp_path / "fly"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch_actor_critic_tpu_torch.serve",
         *_checkpoint(tmp_path / "ckpt"), "--port", "0", "--max-batch", "4",
         "--poll-interval", "0", "--device", "cpu", "--log-transitions", str(fly),
         "--log-sample-every", "2"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    rng = np.random.default_rng(1)
    try:
        address = json.loads(proc.stdout.readline())["serving"]
        logged = 0
        for i in range(10):
            _, headers = _http(address + "/act", {
                "obs": rng.standard_normal((T, OBS_DIM)).tolist(), "deterministic": False})
            res, _ = _http(address + "/outcome", {
                "request_id": headers["X-Request-Id"], "reward": -1.0,
                "next_obs": rng.standard_normal((T, OBS_DIM)).tolist(), "done": i == 9})
            logged += res["logged"]
        assert not list(fly.glob("chunk-*.npz"))  # 5 rows, under a 256-row chunk
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()
    tier = replay.DiskTier(fly)
    assert logged == 5 and tier.rows == 5 and tier.files == 1
    m = train_cli.main(["--environment", "PendulumNumpy-v1", "--history-len", str(T),
                        "--seq-d-model", "16", "--seq-num-heads", "2", "--seq-num-layers",
                        "1", "--device", "cpu", "--runs-root", str(tmp_path / "runs"),
                        "--offline", "true", "--offline-dataset", str(fly), "--offline-reg",
                        "bc", "--offline-steps", "4", "--update-every", "2",
                        "--batch-size", "4"])
    assert m["offline/steps"] == 4.0 and m["offline/dataset_rows"] == 5.0
    assert np.isfinite(m["loss_q"]) and np.isfinite(m["offline/bc_mse"])
    capsys.readouterr()


def test_fleet_workers_log_under_their_own_directory():
    from torch_actor_critic_tpu_torch.serve.__main__ import _worker_argv

    argv = ["--run", "r", "--fleet", "2", "--log-transitions", "/d", "--obs"]
    assert _worker_argv(argv, 1) == ["--run", "r", "--log-transitions",
                                     os.path.join("/d", "worker-1"), "--port", "0"]
    assert _worker_argv(["--log-transitions=/d"], 0) == [
        "--log-transitions=" + os.path.join("/d", "worker-0"), "--port", "0"]
    assert _worker_argv(["--log-transitions", "/d"]) == ["--log-transitions", "/d",
                                                         "--port", "0"]
