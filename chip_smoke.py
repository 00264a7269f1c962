"""GPU smoke of the PyTorch port: build, check and time its kernels, then
serve the sequence policy over HTTP through the port's CLI path.

    python3 chip_smoke.py [--seed 0]

Needs one CUDA card and the CUDA toolkit (nvcc); imports nothing of JAX
or of the JAX package. Phases, one JSON line each:

1. device — the card (``nvidia-smi`` name and power limit on its own line);
2. build — compiles every kernel of the port from ``csrc/`` (one nvcc per
   source, in parallel) and reports the seconds;
3. kernel_vs_plain — each kernel against its plain PyTorch version on the
   card, at the serving shape and the bench shapes: max abs error (f32 <=
   1e-4, summation order; bf16 <= 2e-2, the bf16 rounding of p), and
   median CUDA-event times of the kernel, the plain version and one
   PyTorch library call of the same function (``library_ms``, a
   yardstick only: the port never calls it);
4. serve — the full-width sequence policy (d_model 64, 4 heads, 2 layers,
   history 16, obs 3, act 1, act_limit 2.0, f32, max_batch 64) from
   ``--seed``, saved as a port checkpoint and served by the CLI's own
   ``build_server`` on 127.0.0.1:0: /act with 1, 3 and 64 rows and one
   unbatched history, deterministic and sampled; every action finite and
   within the limit, deterministic actions equal to the same weights'
   plain-attention forward on the card (1e-4), the flash launch count
   at least num_layers x forwards; /metrics latency and rate; then 16
   64-row requests under ``torch.profiler`` (wall vs device-busy time per
   request, top kernels) and the engine's forward alone (host wall time).

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failed check raises: the exit
code is non-zero and the last line is not printed.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request

import torch

H100_F32_FLOPS = 67e12      # H100 SXM, f32 outside the tensor cores
H100_BF16_FLOPS = 989e12    # H100 SXM, bf16 dense tensor cores
H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3

SERVE_SHAPE = (64, 4, 16, 16)   # max_batch x heads x history x head_dim
BENCH_SHAPE = (4, 8, 2048, 64)  # bench.py's attention shape
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, iters: int, reps: int = 5) -> float:
    """Median over ``reps`` of the mean CUDA-event time of ``iters``
    back-to-back calls, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(fn, iters: int, name: str = ""):
    """Mean device time per call of the kernels whose name contains
    ``name`` (all kernels by default), from a ``torch.profiler`` trace of
    ``iters`` calls — the CUDA-event times above include the host's
    launch overhead. None when the trace holds no device events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(t for key, t, _ in device_kernels(prof) if name in key)
    return total_us / iters / 1e3 if total_us > 0 else None


def device_kernels(prof):
    """``(name, device_us, calls)`` of the kernels in a trace. Only
    device-side rows: a host op's row also carries its kernels' time, so
    summing every row would count each kernel twice."""
    from torch.autograd import DeviceType

    return [
        (e.key, e.device_time_total, e.count) for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.device_time_total > 0
    ]


def host_ops(prof, n: int, top: int = 8):
    """The ``top`` host ops by self CPU time, per call of the profiled
    region (``n`` regions)."""
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return [
        {"name": e.key[:60], "self_cpu_ms": e.self_cpu_time_total / n / 1e3,
         "calls": e.count / n}
        for e in rows[:top]
    ]


def attention_bound(shape, causal: bool, dtype) -> tuple:
    """(bound_ms, bound_by): the larger of bytes moved (q, k, v read once,
    o written once) over HBM rate and the two products' FLOPs (only the
    visible (q, k) pairs under causality) over the dtype's peak."""
    b, h, t, d = shape
    nbytes = 4 * b * h * t * d * torch.finfo(dtype).bits // 8
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 4 * d * pairs * b * h
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({
        "phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
        "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
    })
    return smi


def phase_build(kernels) -> None:
    t0 = time.perf_counter()
    built = kernels.build_all()
    regs = [
        ln.strip() for log in kernels.build_logs.values()
        for ln in log.splitlines() if "registers" in ln
    ]
    emit({
        "phase": "build", "seconds": round(time.perf_counter() - t0, 3),
        "built": built, "ptxas": regs,
    })


def phase_kernel_vs_plain(attn, seed: int) -> dict:
    """Every shape's check and times; returns the serving shape's row."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [
        (SERVE_SHAPE, True, torch.float32, 200),
        (BENCH_SHAPE, True, torch.float32, 5),
        (BENCH_SHAPE, False, torch.float32, 5),
        (BENCH_SHAPE, True, torch.bfloat16, 5),
        (BENCH_SHAPE, False, torch.bfloat16, 5),
        ((4, 8, 1000, 64), True, torch.float32, 10),   # ragged T
        ((2, 3, 37, 24), False, torch.bfloat16, 50),   # ragged T, padded d
    ]
    rows = []
    for shape, causal, dtype, iters in cases:
        q, k, v = (
            torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for _ in range(3)
        )
        out = attn.flash_attention_forward(q, k, v, causal)
        ref = attn.attention(q, k, v, causal, impl="plain")
        torch.cuda.synchronize()
        check(out.shape == ref.shape and out.dtype == dtype, f"{shape} shape/dtype")
        err = (out.float() - ref.float()).abs().max().item()
        check(math.isfinite(err) and err <= TOL[dtype],
              f"flash_fwd {shape} causal={causal} {dtype}: max abs err {err}")
        bound_ms, bound_by = attention_bound(shape, causal, dtype)
        row = {
            "phase": "kernel_vs_plain", "kernel": "flash_fwd",
            "shape": list(shape), "causal": causal, "dtype": str(dtype),
            "max_abs_err": err, "tol": TOL[dtype],
            "kernel_ms": time_ms(
                lambda: attn.flash_attention_forward(q, k, v, causal), iters),
            "plain_ms": time_ms(
                lambda: attn.attention(q, k, v, causal, impl="plain"), iters),
            "library_ms": time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=causal), iters),
            "kernel_device_ms": device_ms(
                lambda: attn.flash_attention_forward(q, k, v, causal), iters,
                "flash_fwd_kernel"),
            "plain_device_ms": device_ms(
                lambda: attn.attention(q, k, v, causal, impl="plain"), iters),
            "library_device_ms": device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=causal), iters),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        emit(row)
        rows.append(row)
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return rows[0]


def post(url: str, body: dict) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def profile_requests(address, rng, history, obs_dim, n=16) -> dict:
    """``n`` sequential 64-row deterministic /act requests under
    ``torch.profiler``: wall time per request, device-busy time per
    request (sum of kernel times) and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    obs = rng.standard_normal((64, history, obs_dim)).astype("float32").tolist()
    body = {"obs": obs, "deterministic": True}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            post(address + "/act", body)
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kern = sorted(
        ((key, us / n / 1e3, calls / n) for key, us, calls in device_kernels(prof)),
        key=lambda x: -x[1],
    )
    busy_ms = sum(k[1] for k in kern)
    return {
        "requests": n, "wall_ms_per_request": wall_ms,
        "device_busy_ms_per_request": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms > 0 else None,
        "top_kernels_ms_per_request": [
            {"name": k[0][:80], "ms": k[1], "calls": k[2]} for k in kern[:8]
        ],
    }


def phase_serve(seed: int, kernels) -> int:
    """Drive the CLI's serving path; returns the flash launches counted
    from server start to the last answered request."""
    import numpy as np

    from torch_actor_critic_tpu_torch.models import build_models
    from torch_actor_critic_tpu_torch.models.sequence import plain_attention
    from torch_actor_critic_tpu_torch.serve.__main__ import (
        build_server,
        parse_arguments,
    )
    from torch_actor_critic_tpu_torch.utils.checkpoint import save_actor
    from torch_actor_critic_tpu_torch.utils.config import SACConfig

    history, obs_dim, act_dim, act_limit = 16, 3, 1, 2.0
    config = SACConfig(history_len=history)  # seq widths: 64 / 4 heads / 2 layers
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        actor = build_models(config, (history, obs_dim), act_dim, act_limit)
    ckpt = tempfile.mkdtemp(prefix="tac_chip_smoke_")
    try:
        save_actor(ckpt, 1, actor, config)
        args = parse_arguments([
            "--ckpt-dir", ckpt, "--obs-dim", str(obs_dim),
            "--act-dim", str(act_dim), "--act-limit", str(act_limit),
            "--host", "127.0.0.1", "--port", "0", "--device", "cuda",
            "--poll-interval", "0", "--seed", str(seed),
        ])
        kernels.reset_launch_counts()
        server, info = build_server(args)  # registers + warms every bucket
        server.start()
        try:
            at_start = kernels.launch_counts["flash_fwd"]
            rng = np.random.default_rng(seed)
            plain = build_models(config, (history, obs_dim), act_dim, act_limit)
            for blk in plain.trunk.blocks:
                blk.attn.attention_fn = plain_attention
            plain.load_state_dict(actor.state_dict())
            plain = plain.to("cuda").eval()
            requests = []
            lat = []
            for rows in (1, 3, 64, None):
                obs = rng.standard_normal(
                    (history, obs_dim) if rows is None else (rows, history, obs_dim)
                ).astype(np.float32)
                for det in (True, False):
                    t0 = time.perf_counter()
                    out = post(server.address + "/act",
                               {"obs": obs.tolist(), "deterministic": det})
                    lat.append((time.perf_counter() - t0) * 1e3)
                    act = np.asarray(out["action"], dtype=np.float32)
                    want = (act_dim,) if rows is None else (rows, act_dim)
                    check(act.shape == want, f"/act shape {act.shape} != {want}")
                    check(bool(np.all(np.isfinite(act))), "non-finite action")
                    check(bool(np.all(np.abs(act) <= act_limit)), "action out of range")
                    err = None
                    if det:
                        with torch.inference_mode():
                            ref, _ = plain(torch.from_numpy(obs).cuda(),
                                           deterministic=True, with_logprob=False)
                        err = float(np.abs(act - ref.cpu().numpy()).max())
                        check(err <= 1e-4, f"served vs plain forward: {err}")
                    requests.append({"rows": rows, "deterministic": det,
                                     "max_abs_err_vs_plain": err})
            launches_requests = kernels.launch_counts["flash_fwd"] - at_start
            metrics = json.loads(urllib.request.urlopen(
                server.address + "/metrics", timeout=60).read())
            forwards = metrics["batches_total"]
            layers = config.seq_num_layers
            check(launches_requests >= layers * forwards,
                  f"flash launches {launches_requests} < {layers} x {forwards} forwards")
            check(metrics["errors_total"] == 0, "serving errors")
            before = kernels.launch_counts["flash_fwd"]
            profile = profile_requests(server.address, rng, history, obs_dim)
            check(kernels.launch_counts["flash_fwd"] - before
                  >= layers * profile["requests"],
                  "profiled requests did not run the flash kernel")
            # The engine's forward alone (no HTTP, JSON or queue): host
            # wall time of one padded 64-row deterministic act().
            engine, params, _ = server.registry.acquire()
            obs64 = rng.standard_normal((64, history, obs_dim)).astype(np.float32)
            act_ms = []
            for _ in range(20):
                t0 = time.perf_counter()
                engine.act(params, obs64, deterministic=True)
                act_ms.append((time.perf_counter() - t0) * 1e3)
            from torch.profiler import ProfilerActivity, profile as tprofile

            with tprofile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    engine.act(params, obs64, deterministic=True)
            act_host_ops = host_ops(prof, 10)
            launches = kernels.launch_counts["flash_fwd"]
            emit({
                "phase": "serve", "slot": info, "requests": requests,
                "forwards": forwards, "flash_launches_total": launches,
                "flash_launches_warmup": at_start,
                "flash_launches_requests": launches_requests,
                "p50_ms": metrics.get("p50_ms"), "p99_ms": metrics.get("p99_ms"),
                "requests_per_sec": metrics.get("requests_per_sec"),
                "client_median_ms": statistics.median(lat),
                "live_compiles": metrics["live_compiles"],
                "profile_64_rows_deterministic": profile,
                "engine_act_64_rows_median_ms": statistics.median(act_ms),
                "engine_act_host_ops": act_host_ops,
            })
        finally:
            closed = server.close()
            check(closed["server_thread_stopped"], "server thread did not stop")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return launches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the GPU only",
              file=sys.stderr)
        return 2
    import torch_actor_critic_tpu_torch  # noqa: F401  (sets full-f32 matmuls)
    from torch_actor_critic_tpu_torch.ops import _kernels
    from torch_actor_critic_tpu_torch.ops import attention as attn

    smi = phase_device()
    phase_build(_kernels)
    serve_row = phase_kernel_vs_plain(attn, args.seed)
    launches = phase_serve(args.seed, _kernels)
    check(launches > 0, "the serving path launched no flash_fwd kernel")
    emit({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "torch_actor_critic_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "torch_actor_critic_tpu/ops/attention.py:428",
        "launches": launches,
        "max_abs_err": serve_row["max_abs_err"],
        "ms": serve_row["kernel_ms"],
        "kernel_ms": serve_row["kernel_ms"],
        "plain_ms": serve_row["plain_ms"],
        "bound_ms": serve_row["bound_ms"],
        "bound_by": serve_row["bound_by"],
        "library_ms": serve_row["library_ms"],
        "shape": serve_row["shape"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
