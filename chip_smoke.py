"""GPU smoke of the PyTorch port: build, check and time its kernels,
serve the sequence policy over HTTP through the port's CLI path (graphs,
tiers, the pixel recipe, a two-worker fleet), train
it with SAC through the train CLI's path, then train the visual (pixel)
policy through the same path and run visual bursts at full width, then
preempt, resume, roll back and evaluate training runs from full-state
checkpoints, then train TD3 on the flat and visual stacks, then run the
fused on-device loop (env twins, replay and learner on the card), then
its population with PBT.

    python3 chip_smoke.py [--seed 0]

Needs one CUDA card and the CUDA toolkit (nvcc); imports nothing of JAX
or of the JAX package. Phases, one JSON line each:

1. device — the card (``nvidia-smi`` name and power limit on its own line);
2. build — compiles every kernel source of the port from ``csrc/`` (one
   nvcc per source, in parallel) and reports the seconds;
   floor — the device time of an empty kernel (``csrc/floor.cu``) at the
   attention kernels' main-path grid (64 blocks of 128 threads), without
   and with K3's shared memory there, at the stacked critics' grid (128
   blocks) and at one block: the launch latency no kernel design
   removes; beside it K2, K3 and K4 at the main shape and at the
   critics' folded shape on the model's views, each launched alone,
   back to back, and in turn as a training step launches them;
3. kernel_vs_plain — each kernel against its plain PyTorch version on the
   card, at the training/serving shape (64, 4, 16, 16) — for K2 first on
   the model's split (B, T, H, d) views, where one call must be exactly
   one device kernel (``kernels_per_call``, ``torch.profiler``) — at the
   stacked critics' folded shape (128, 4, 16, 16) on the views the
   training config's critic itself hands its first attention call
   (``critic_views``: num_qs 2 × batch 64; one device kernel a K2 call,
   two a backward call), and the bench shapes: max abs error (f32 <=
   1e-4, summation order, and K2's f32 rows <= 1e-5, which its 3xTF32
   products meet and one TF32 pass would not; bf16 <= 2e-2, the bf16 rounding of p and ds; the backward
   kernels' limits scale by max(1, max|plain|), their f32 rows also
   <= 1e-5·max(1, max|plain|); K3's Δ is held to its plain version's
   too), bitwise-equal repeat runs of the backward — first on the
   model's views, where one backward call must be exactly two device
   kernels (K3 and K4) — and
   the device time per call (``torch.profiler``) of the kernel, the plain
   version and one PyTorch library call (``library_ms``: SDPA forward, or
   SDPA's backward for the two backward kernels; a yardstick only, the
   port never calls it), with CUDA-event times per call, host launch
   included, beside them as ``*_event_ms``;
4. serve — the full-width sequence policy (d_model 64, 4 heads, 2 layers,
   history 16, obs 3, act 1, act_limit 2.0, f32, max_batch 64) from
   ``--seed``, saved as a port checkpoint and served by the CLI's own
   ``build_server`` on 127.0.0.1:0: /act with 1, 3 and 64 rows and one
   unbatched history, deterministic and sampled, then 16 64-row
   requests, the server's startup and all these under one device trace;
   every (bucket, deterministic) forward one CUDA graph captured at
   warmup (2 x buckets captures, none live, 2L K2 launches per capture
   through the wrappers and none per served request; on the device L
   for each capture's warm-up, warmup replay and served forward);
   every action finite and within the limit, deterministic actions
   equal to the same weights' plain-attention forward on the card
   (1e-4); captured == eager
   bitwise at every bucket, deterministic and sampled from one generator
   state; a reload under traffic (a batch held at the engine's door
   answers on its old weights bitwise, nothing recaptured, no request
   lost); the engine's host time per 64-row forward and /act p50/p99,
   eager against captured; 16 64-row requests under ``torch.profiler``
   (wall vs device-busy time per request, top kernels); the bf16 tier
   (K2 in bf16 at (64, 4, 16, 16) on the model's views against its
   plain version, 2e-2; served actions within 2e-2 of f32's and not
   bitwise them) and the int8 tier (actions equal to the dequantized
   f32 forward, 1e-4; params bytes on the card under a third of
   f32's), each through the CLI's ``--serve-precision`` on one engine
   at the tier, its startup and 17 64-row forwards traced as above; the
   pixel recipe through ``--run`` on a run saved as the train CLI lays
   one out (``{"features", "frame"}`` requests equal to the actor's own
   forward, 1e-4); ``--fleet 2`` on the one card (64 routed requests, a
   rolling /reload under traffic, the router's /metrics totals equal to
   the workers' sum, a worker killed under traffic with no request
   lost, SIGTERM exit 0);
5. train — the same policy and its twin sequence critic (one stacked
   ensemble) at SACConfig's widths (batch 64, update_every 50), trained
   through the train CLI's ``build_trainer`` on
   ``PendulumNumpy-v1|history:16`` (the port's numpy twin of
   Pendulum-v1; the card's machine has no gymnasium) for 1000 steps, the
   first 500 random: 500 gradient steps (cut from 1000 to keep the whole
   smoke near 5 minutes). The run is traced (``torch.profiler``): its
   bursts are CUDA graph replays, which launch the kernels without
   calling their wrappers, so its launches are read from the device
   trace by kernel symbol. Checks: finite losses, every kernel launched
   by its wrapper and run on the device, the device's launches equal to
   the wrappers' plus those of the replays, the checkpoint restores,
   launches per update exactly 5L forward and 2L each backward kernel, whatever Q
   (one call a layer serves the whole critic ensemble), one critic
   forward exactly L K2 launches and its backward L K3 and L K4, each
   member of the stacked critic equal to its slices run alone through a
   single ``SequenceCritic`` (1e-5·max(1, max|q|)), and,
   from one state, the critic's and actor's parameter gradients with the
   kernels against those with plain attention (1e-4·max(1, max|g|)) and
   then one update with each (params 1e-4; attention key biases, whose
   gradient is zero in exact arithmetic, 2·lr; outputs 1e-4). Training's
   bursts run as CUDA graph replays (``SAC.update_burst``): from clones
   of one state and ring, two captured bursts must equal two eager ones
   (``eager=True``) to the bit (parameters, Adam moments and steps,
   log α, generator, metrics), and the graph captured at training's
   first burst must serve every later one; one Adam step, capturable
   (the card's) against plain (the CPU's, held to optax by the tier-1
   tests), within those tests' limits (atol 1e-5, rtol 1e-4). Reports,
   for each burst mode in turn, gradient steps per second, one profiled
   burst (exact launches per update from its device trace, device busy
   vs idle, kernels per update, the top ones; idle also against the
   unprofiled bursts' time); acting steps per second; the device
   kernels of one stacked critic forward and of one forward + backward;
   and those of one Adam step of the actor and of the critic, plain and
   capturable;
   graph_push — a replay after a push samples the grown ring (a flat
   learner at SACConfig's widths, every transition terminal, rewards
   marking the rows pushed after the capture);
6. kernel_vs_plain for K1 (``pixel_gather``, run before serving) — the
   fused replay-gather → DrQ shift → decode kernel against its plain
   version, **bitwise** (``torch.equal``), at the pixel recipe's training
   shape (ring (24000, 32, 32, 3), B 64, f32, /255, shift pad 4), the same
   with a 3-frame stack over wrap-around rows, and the wall-runner shapes
   (ring (20000, 64, 64, 3), B 32 f32 and B 512 bf16 with shift and /255),
   one leaf a call; then the training shape and wall B 512 bf16 with both
   frame leaves in one launch (``*_pair``, each leaf bitwise; the plain
   version is two calls); device ms of kernel and plain version; bound =
   bytes (uint8 read, rows/offsets read, output written; rows once for
   both leaves) / 3.35 TB/s; ``library_ms`` null: no single PyTorch call
   gathers, shifts, decodes and casts;
7. train_visual — the JAX package's pixel recipe (conv 16,32 / 4,3 /
   2,2, Dense 128, cnn_features 64, /255, DrQ shift, learned α, fused
   pixel pipeline, hidden 256-256, batch 64, buffer 24000) through
   ``build_trainer`` on ``PixelPendulumBalanceNumpy-v0`` for 2000 steps,
   the first 1000 random: 1000 gradient steps. Checks: finite losses,
   exactly 1 K1 launch per update (both frame leaves), the checkpoint
   restores, and from one state the gradients (1e-4·max(1, max|g|)) and
   one update (params and outputs 1e-4, log α 1e-6) with K1's frames
   against the plain gather's; the captured against the eager burst as
   for the sequence policy, both on cuDNN's deterministic algorithms (its
   default convolution backward may sum in another order run to run: the
   row also gives two default eager runs against each other, and holds
   one replayed update on the default algorithms against one eager update
   to the one-update limits above); the traced run and the Adam step as
   for the sequence policy; reports both burst modes as above;
8. visual_burst — SACConfig's default visual widths (Atari trunk, Dense
   512, cnn_features 1) on the wall-runner geometry (168 features, 64x64x3
   frame, act_dim 56) with synthetic transitions, as ``bench.py``'s
   ``bench_visual`` (the card's machine has no dm_control): 25-update
   fused bursts at B 32 f32 and B 512 bf16; captured against eager as in
   train_visual; each burst mode's finite losses, 1 K1 launch per update
   in its device trace,
   gradient steps per second and one profiled burst;
9. resume — full-state checkpoints on the card under captured bursts,
   at the sequence training widths (200-step epochs, update_every 50):
   3 epochs uninterrupted (A) against a run preempted by a real SIGTERM
   in epoch 1 (B: ``Preempted``, exit code 75, checkpoint at epoch 1,
   step 400) and a fresh trainer resumed from it for the last epoch (C,
   traced): every leaf of C equal to A's to the bit, one capture each,
   K2/K3/K4 launches per update from the device trace; C's checkpoint
   restored exactly into a CPU trainer; ``run_agent`` twice on C's run,
   the same line; a NaN reward in epoch 2 of a 4-epoch run (D) rolled
   back in place to epoch 1: bitwise equal to the checkpoint on disk, no
   new capture, and one burst through the old graph equal to one eager
   burst from a clone; the pixel recipe, 2 epochs against 1 + resume + 1
   on cuDNN's deterministic algorithms, bitwise, 1 K1 launch per update.
   Reports ``save_s``, ``sentinel_s``, restore seconds and checkpoint
   bytes beside the card's name and power limit;
10. train_td3 — TD3 through ``build_trainer(--algorithm td3)``: flat at
   SACConfig's defaults (hidden 256,256, batch 64, policy_delay 2) on
   ``PendulumNumpy-v1``, 500 gradient steps, traced; from clones of its
   state, captured against eager bursts to the bit over 25-update bursts
   (odd starts) and with policy_delay 3, one capture each; one replayed
   update at a skipped step leaves the actor, ``pi_opt`` and both
   targets bitwise and moves the critic; visual at the pixel recipe's
   widths (learn_alpha off), 500 gradient steps, traced: exactly 1 K1
   launch per update, captured == eager on cuDNN's deterministic
   algorithms; the wall-runner geometry at B 32 f32 in 25-update bursts;
   a flat ``--run`` resume bitwise (the target actor and the device step
   included). Each cell's burst modes timed and profiled (beside a SAC
   flat learner's), one line each before the last with the card;
11. on_device — the fused loop (``sac/ondevice.py``, ``envs/ondevice.py``),
   in a child process of its own (a fresh CUDA context and profiler):
   K2 at history 8 on the acting batch (16, 4, 8, 16), the update batch
   (64, 4, 8, 16) and the critics' fold (128, 4, 8, 16), K3/K4 at the
   last two, against their plain versions at the limits of 3; the twins
   on the card against the CPU (floats 1e-5, frames at most 1 count on
   at most 0.1% of the pixels, the renderer on 4096 angles); four cells
   at SACConfig's widths with 16 twins, update_every 50, utd 1 and a
   10^6-row ring (the sequence policy at history 8, the pixel recipe on
   ``PixelPendulumBalanceNumpy-v0``, flat SAC, flat TD3): a warm-up
   epoch that launches none of K1-K4 (traced in the sequence cell),
   a captured against an eager epoch from clones to the bit (learner,
   ring, env states, the three generators; the pixel cell on cuDNN's
   deterministic algorithms), a traced 1000-step epoch whose device
   launches are exactly L K2 per acting step and 5L K2, 2L K3, 2L K4
   (or 1 K1) per update, and whose device idle share is read from its
   own trace; the same epoch untraced and timed (env and gradient steps
   per second) beside the captured burst alone and the host trainer's
   epoch,
   an epoch under ``torch.cuda.set_sync_debug_mode("error")``; the async
   save of the full history-8 ring (seconds in ``save`` and to ``wait``,
   bytes) and ``save_buffer=False``; ``train --on-device true`` then
   ``--run <id>``;
12. population — the fused population (``--population N``,
   ``sac/population.py``, ``PopulationOnDeviceLoop``), in a child
   process of its own: K2 at the folded shapes of a history-8 population
   of 8 (acting (128, 4, 8, 16), update (512, ...), critics (1024,
   ...)) and at the critics' fold of 32 (4096, ...), K3/K4 at the
   update and critics' folds, against their plain versions at the
   limits of 3; the README's command (the cheetah twin, P = 32, 10^6
   rows per member, ``--pbt-every 1``) through ``train.main`` for two
   1000-step epochs, each PBT step checked in place (an exploited
   member's networks and all its Adam state bitwise its winner's, its
   hyperparameters the winner's times exactly 1.25^±1, rings and
   generators untouched; at least one exploit), ``loss_q_m0`` ...
   ``loss_q_m31`` finite in ``metrics.jsonl``; a captured against an
   eager history-8 population epoch, to the bit, and a member against a
   lone ``OnDeviceLoop`` given its weights and draws, to 1e-4; the
   sequence cell (P = 8, history 8, 10^6 rows per member): a traced
   1000-step epoch whose launches are L K2 per acting step and 5L K2, 2L
   K3, 2L K4 per update, the same per update at P = 32, then save, run,
   restore in place under the graphs and run again, bitwise; untraced
   flat-cell rates and device memory at P = 1, 8, 32, one line each
   with the card.

Then the ``{"kernels": [...]}`` line (``ms``, ``plain_ms`` and
``library_ms`` are device times; K2-K4's numbers are those of their rows
on the model's views; K1's row is ``train_pair``, what the main path
launches, with the launches of train_visual, the visual resume,
train_td3's visual run and the on-device pixel cell; K2-K4's include
the population's traced sequence epoch; every ``launches`` is counted
in the main path's runs from device traces: serving's (f32 and int8
tiers) over each server's startup and traced forwards, training's, the
resumed runs' and the on-device epochs'; ``flash_fwd_bf16`` is K2 in
bf16 at the bf16 serving tier's shape, with that tier's traced
launches),
the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failed check raises: the exit
code is non-zero and the last line is not printed.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import itertools
import json
import logging
import math
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch

# H100 SXM, f32-accurate products: 3xTF32 on the tensor cores (three TF32
# products per f32 product, 495 / 3 TFLOP/s) is faster than the CUDA
# cores' 67 TFLOP/s, and K2 takes that route.
H100_F32_FLOPS = 495e12 / 3
H100_BF16_FLOPS = 989e12    # H100 SXM, bf16 dense tensor cores
H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3

SERVE_SHAPE = (64, 4, 16, 16)   # max_batch x heads x history x head_dim
TRAIN_SHAPE = SERVE_SHAPE       # batch_size 64 x heads x history x head_dim
# The stacked critics' attention: num_qs 2 folded into the batch axis.
CRITIC_SHAPE = (2 * TRAIN_SHAPE[0], *TRAIN_SHAPE[1:])
BENCH_SHAPE = (4, 8, 2048, 64)  # bench.py's attention shape
# The port's host pendulum (the JAX package's PendulumJax dynamics): the
# card's machine has no gymnasium, whose Pendulum-v1 it stands in for.
TRAIN_ENV = "PendulumNumpy-v1"
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# f32 rows are also held to 1e-5 (K2) and 1e-5·max(1, max|plain|) (K3 with
# its Δ, K4): 3xTF32 products err by ~1e-6, a single TF32 pass by ~1e-3.
F32_GUARD = 1e-5
MAIN_GRID = (64, 128)  # K2-K4's blocks x threads at the main path's shape
CRITIC_GRID = (128, 128)  # the same at CRITIC_SHAPE
# K3's dynamic shared memory there in f32: four warps, each with its 16
# Q and dO rows and one 16-row K/V tile, rows padded to 20 floats.
K3_SMEM = 4 * (2 * 16 + 2 * 16) * 20 * 4


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


def device_ms(fn, iters: int, name: str = "", attempts: int = 4) -> float:
    """Mean device time per call of the kernels whose name contains
    ``name`` (all kernels by default), from a ``torch.profiler`` trace of
    ``iters`` calls — the CUDA-event times above include the host's
    launch overhead. A trace that comes back without device events (the
    profiler now and then drops a whole session's kernels) is taken
    again, up to ``attempts`` traces; fails a check when none holds such
    time."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(t for key, t, _ in device_kernels(prof) if name in key)
        if total_us > 0:
            return total_us / iters / 1e3
        print(f"chip_smoke: trace {attempt} of {attempts} held no device time "
              f"of {name or 'any kernel'!r}", file=sys.stderr, flush=True)
    check(False, f"the profiler traced no device time of {name or 'any kernel'!r} "
                 f"in {attempts} traces")
    return 0.0


def device_kernels(prof):
    """``(name, device_us, calls)`` of the kernels in a trace. Only
    device-side rows: a host op's row also carries its kernels' time, so
    summing every row would count each kernel twice; and no user
    annotations (``Optimizer.step#Adam.step`` spans its kernels on the
    device timeline and would count them again).

    Read from the profiler's raw events, not ``key_averages()``: the
    same rows (``key_averages_rows`` is the check), without building
    the host's event tree, whose cost grows faster than the events (a
    1000-step on-device epoch's trace took ~100 s to average)."""
    from torch.autograd import DeviceType

    rows: dict = {}
    for e in prof.profiler.kineto_results.events():
        hidden = getattr(e, "is_hidden_event", lambda: False)()  # as key_averages
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation() or hidden
                or e.name().startswith("Optimizer.")):
            continue
        us, n = rows.get(e.name(), (0.0, 0))
        rows[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    named: dict = {}  # keyed as key_averages keys them: demangled
    for raw, (us, n) in rows.items():
        key = torch._C._demangle(raw) if len(raw) > 1 else raw
        us0, n0 = named.get(key, (0.0, 0))
        named[key] = (us0 + us, n0 + n)
    return [(name, us, n) for name, (us, n) in named.items() if us > 0]


def key_averages_rows(prof):
    """``device_kernels``' rows as ``key_averages()`` gives them."""
    from torch.autograd import DeviceType

    return [
        (e.key, e.device_time_total, e.count) for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
        and not e.key.startswith("Optimizer.")
    ]


def phase_trace_reader() -> dict:
    """``device_kernels`` against ``key_averages_rows`` on one trace of
    what the smoke traces: eager kernels, an Adam step (its user
    annotation) and three replays of a CUDA graph. Names and calls
    equal, device times within 1e-3 us a call (the two sum differently)."""
    from torch.profiler import ProfilerActivity, profile

    w = torch.randn(256, 256, device="cuda", requires_grad=True)
    opt = torch.optim.Adam([w], lr=1e-3)
    x = torch.randn(64, 256, device="cuda")
    static = torch.empty(64, 256, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        static.copy_(torch.tanh(x @ w.detach()) * 2)  # warm-up before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static.copy_(torch.tanh(x @ w.detach()) * 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trace_lead_in()
        (x @ w).square().sum().backward()
        opt.step()
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
    fast = {k: (us, n) for k, us, n in device_kernels(prof)}
    slow = {k: (us, n) for k, us, n in key_averages_rows(prof)}
    check(fast.keys() == slow.keys() and all(
        fast[k][1] == slow[k][1] and abs(fast[k][0] - slow[k][0]) <= 1e-3 * fast[k][1]
        for k in fast),
        f"device_kernels {fast} != key_averages {slow}")
    out = {"phase": "trace_reader", "rows": len(fast),
           "calls": sum(n for _, n in fast.values())}
    emit(out)
    return out


# The kernels' device symbols, as a trace names them.
KERNEL_SYMBOLS = {"flash_fwd": "flash_fwd_kernel", "flash_bwd_dq": "flash_bwd_dq_kernel",
                  "flash_bwd_dkv": "flash_bwd_dkv_kernel", "pixel_gather": "pixel_gather_kernel"}


def trace_lead_in(n: int = 32) -> None:
    """The start of a trace: ``n`` empty kernels (``csrc/floor.cu``), a
    synchronize and 20 ms of host sleep. The card's profiler can lose a
    trace's first kernels (one K1 launch of an eager visual burst's 50,
    in each of two runs); this gives it kernels to lose, which
    ``traced_rows`` leaves out."""
    from torch_actor_critic_tpu_torch.ops import _kernels

    fn = _kernels.load("empty")
    device = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(device).cuda_stream
    for _ in range(n):
        _kernels.launch("empty", fn, device, (1, 32, 0, stream), "lead-in")
    torch.cuda.synchronize()
    time.sleep(0.02)


def trace_tail() -> None:
    """The end of a trace: one spin kernel (``torch.cuda._sleep``) on the
    current stream after the traced work, and a synchronize. A trace
    that lost its end lacks it, and ``traced_rows`` then reads nothing."""
    torch.cuda._sleep(1)
    torch.cuda.synchronize()


def traced_rows(prof):
    """``device_kernels`` of a trace that began with ``trace_lead_in``
    and ended with ``trace_tail``, without the lead-in's empty kernels
    and the tail's spin kernel; no rows when the tail's kernel is
    missing, since a trace that lost its end counts no launches."""
    rows = device_kernels(prof)
    if not any("spin_kernel" in key for key, _, _ in rows):
        return []
    return [row for row in rows if "empty_kernel" not in row[0] and "spin_kernel" not in row[0]]


def trace_buffers(mb: int = 1024) -> None:
    """Lets the profiler (Kineto) keep ``mb`` MB of device records in a
    trace, where it keeps 128 MB by default and can stop recording past
    them. A traced 1000-step on-device sequence epoch holds about
    916,000 kernels, near that default. Kineto holds the size in bytes
    in a 32-bit int, so ``mb`` stays below 2048 (4096 wraps to 0 MB).
    Kineto reads the file that ``KINETO_CONFIG`` names when the
    process's first trace starts; the on-device child inherits it."""
    conf = os.path.join(tempfile.mkdtemp(prefix="tac_chip_kineto_"), "kineto.conf")
    with open(conf, "w") as f:
        f.write(f"ACTIVITIES_MAX_GPU_BUFFER_SIZE_MB={mb}\n")
    os.environ["KINETO_CONFIG"] = conf


def launches_by_symbol(rows) -> dict:
    """Each kernel's launches in a trace's ``device_kernels`` rows, found
    by its device symbol: what ran on the card, CUDA graph replays
    included (a replay calls no wrapper, so ``launch_counts`` misses
    it)."""
    return {name: sum(n for key, _, n in rows if sym in key)
            for name, sym in KERNEL_SYMBOLS.items()}


def traced(fn, what: str, discard=None, attempts: int = 3, on_trace=None):
    """``fn()`` under ``torch.profiler``, between ``trace_lead_in`` and
    ``trace_tail``; returns its result and the kernels' launches the
    trace saw (``launches_by_symbol``). A trace with no device kernel at
    all (the card's profiler now and then drops all of a trace's) or
    without the tail's is not read: ``discard(result)`` runs, then
    ``fn()`` again, up to ``attempts`` times. ``on_trace(prof)`` reads
    the trace that was kept."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trace_lead_in()
            out = fn()
            torch.cuda.synchronize()
            trace_tail()
        rows = traced_rows(prof)
        if rows:
            if on_trace is not None:
                on_trace(prof)
            return out, launches_by_symbol(rows)
        print(f"chip_smoke: {what}: trace {attempt} of {attempts} held no device kernel "
              "or lost its end",
              file=sys.stderr, flush=True)
        if discard is not None:
            discard(out)
    check(False, f"{what}: the profiler traced no device kernel in {attempts} traces")
    return None, {}


def check_through_graphs(what: str, device: dict, wrapped: dict, per_update: dict,
                         updates: int, captures: int) -> None:
    """The device's launches of a run whose bursts were CUDA graphs
    against its wrappers' counts: every update launched ``per_update`` of
    each kernel, the wrappers saw the eager ones (warm-ups, acting) and
    one update's recorded at each capture, and the replays
    (``updates`` less the warm-ups) ran on the device without them."""
    from torch_actor_critic_tpu_torch.sac.graph import WARMUP_UPDATES

    replays = updates - captures * WARMUP_UPDATES
    want = {k: wrapped.get(k, 0) + (replays - captures) * n for k, n in per_update.items()}
    got = {k: device.get(k, 0) for k in per_update}
    check(got == want, f"{what}: device launches {got} != {want} (wrappers {wrapped}, "
                       f"{updates} updates, {captures} captures)")


def adam_parity(module, opt, lr: float, gen) -> dict:
    """One Adam step from ``opt``'s state, on one set of random gradients:
    the capturable Adam the card's learner steps (step count and bias
    correction on the device) against the plain one the CPU steps, which
    the tier-1 tests hold to optax. Fails unless the parameters and both
    moments agree within those tests' limits, atol 1e-5 and rtol 1e-4;
    returns each quantity's largest |gap| / (1e-5 + 1e-4·|plain|)."""
    import copy

    from torch_actor_critic_tpu_torch.sac.algorithm import ADAM_EPS

    grads = [torch.randn(p.shape, generator=gen, device="cuda") for p in module.parameters()]
    runs = []
    for capturable in (True, False):
        params = [p.detach().clone().requires_grad_(True) for p in module.parameters()]
        adam = torch.optim.Adam(params, lr=lr, eps=ADAM_EPS, capturable=capturable)
        saved = copy.deepcopy(opt.state_dict())
        for group in saved["param_groups"]:
            group["capturable"] = capturable
        for st in saved["state"].values():
            st["step"] = st["step"].to("cuda" if capturable else "cpu")
        adam.load_state_dict(saved)
        for p, g in zip(params, grads):
            p.grad = g.clone()
        adam.step()
        runs.append({"params": params,
                     "exp_avg": [adam.state[p]["exp_avg"] for p in params],
                     "exp_avg_sq": [adam.state[p]["exp_avg_sq"] for p in params]})
    got, want = runs
    out = {"tensors": len(grads), "step": float(next(iter(opt.state.values()))["step"])}
    for key in ("params", "exp_avg", "exp_avg_sq"):
        out[key] = max(((a.detach() - b.detach()).abs() / (1e-5 + 1e-4 * b.detach().abs()))
                       .max().item() for a, b in zip(got[key], want[key]))
    check(max(out[k] for k in ("params", "exp_avg", "exp_avg_sq")) <= 1.0,
          f"capturable vs plain Adam step: {out}")
    return out


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


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_device() -> str:
    smi = nvidia_smi()
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


def phase_floor(kernels, attn, seed: int) -> dict:
    """The device time of one empty kernel at the attention kernels'
    main-path grid (with no dynamic shared memory and with K3's), at the
    stacked critics' grid and at one block, and of K2, K3 and K4 at
    TRAIN_SHAPE and CRITIC_SHAPE on the model's views: each alone, back
    to back, and in turn as the backward and a training step launch
    them. The wrappers' launches are recorded once and replayed, so only
    the kernels run between the profiled calls."""
    fn = kernels.load("empty")
    device = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(device).cuda_stream
    row = {"phase": "floor", "kernel": "empty_kernel (csrc/floor.cu)"}
    for label, (grid, block), smem in (("main_grid", MAIN_GRID, 0),
                                       ("main_grid_k3_smem", MAIN_GRID, K3_SMEM),
                                       ("critic_grid", CRITIC_GRID, 0),
                                       ("one_block", (1, MAIN_GRID[1]), 0)):
        def launch():
            kernels.launch("empty", fn, device, (grid, block, smem, stream), f"{grid}x{block}")

        row[label] = {"grid": grid, "block": block, "smem": smem,
                      "ms": device_ms(launch, 200, "empty_kernel"),
                      "event_ms": time_ms(launch, 200)}

    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    row["attention"] = [_floor_attention(kernels, attn, shape, gen)
                        for shape in (TRAIN_SHAPE, CRITIC_SHAPE)]
    emit(row)
    return row


def _floor_attention(kernels, attn, shape, gen) -> dict:
    """K2, K3 and K4 at ``shape`` on the model's views, replayed alone and
    in turn (``phase_floor``)."""
    b, h, t, d = shape
    q, k, v, do = (torch.randn((b, t, h * d), generator=gen, device="cuda")
                   .reshape(b, t, h, d).transpose(1, 2) for _ in range(4))
    recorded, launch = [], kernels.launch

    def record(name, fn, device, args, note):
        recorded.append((name, fn, args))
        launch(name, fn, device, args, note)

    kernels.launch = record
    try:
        out, lse = attn.flash_attention_forward(q, k, v, True, return_lse=True)
        grads = attn.flash_attention_backward(q, k, v, out, lse, do, True)
    finally:
        kernels.launch = launch
    torch.cuda.synchronize()

    def replay(*names):
        calls = [(fn, args) for name, fn, args in recorded if name in names]

        def run():
            for fn, args in calls:
                check(fn(*args) == 0, f"replayed launch of {names} failed")
        return run

    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    part = {
        "shape": list(shape), "causal": True, "dtype": "torch.float32",
        "layout": "views",
        "alone_ms": {n: device_ms(replay(n), 200, n + "_kernel") for n in names},
        "backward_in_turn_ms": {n: device_ms(replay(*names[1:]), 200, n + "_kernel")
                                for n in names[1:]},
        "step_in_turn_ms": {n: device_ms(replay(*names), 200, n + "_kernel")
                            for n in names},
    }
    del q, k, v, do, out, lse, grads
    return part


def kernels_per_call(fn, calls: int = 10, attempts: int = 8) -> int:
    """Device kernels launched by one ``fn()``: the kernels of ``calls``
    calls in one ``torch.profiler`` trace over ``calls``, rounded. The
    profiler on the card now and then drops a whole trace's kernels or
    its end (the trace is taken again, up to ``attempts`` traces) or a
    trace's first few (a K3 + K4 call alone came back as one kernel in
    every trace of a run; 14 kernels for 10 backward calls in another):
    the trace opens with ``trace_lead_in``'s kernels for it to lose and
    closes with ``trace_tail``, and ``traced_rows`` leaves both out. One
    more kernel per call still shows as ``calls`` more."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trace_lead_in()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            trace_tail()
        total = sum(n for _, _, n in traced_rows(prof))
        if total:
            if total % calls:
                print(f"chip_smoke: {total} device kernels in a trace of {calls} calls",
                      file=sys.stderr, flush=True)
            return round(total / calls)
    check(False, f"the profiler traced no device kernel in {attempts} traces")
    return 0


def critic_views(seed: int, history: int = TRAIN_SHAPE[2]):
    """q, k, v as the training config's stacked sequence critic (at
    ``history``) hands them to its first attention call on a random
    batch: ``(num_qs·B, H, T, d)`` views of its projections. The
    attention itself runs plain."""
    from torch_actor_critic_tpu_torch.models import build_models
    from torch_actor_critic_tpu_torch.models.sequence import (
        StackedMultiHeadAttention,
        plain_attention,
    )
    from torch_actor_critic_tpu_torch.utils.config import SACConfig

    cfg = SACConfig(history_len=history)
    _, critic = build_models(cfg, (cfg.history_len, 3), 1, 2.0,
                             generator=torch.Generator().manual_seed(seed))
    seen = []

    def capture(q, k, v, causal=True):
        seen.append((q, k, v))
        return plain_attention(q, k, v, causal)

    for m in critic.modules():
        if isinstance(m, StackedMultiHeadAttention):
            m.attention_fn = capture
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    obs = torch.randn((cfg.batch_size, cfg.history_len, 3), generator=gen, device="cuda")
    act = torch.rand((cfg.batch_size, 1), generator=gen, device="cuda") * 4 - 2
    with torch.no_grad():
        critic.cuda()(obs, act)
    q, k, v = seen[0]
    want = (*CRITIC_SHAPE[:2], history, CRITIC_SHAPE[3])
    check(len(seen) == cfg.seq_num_layers and tuple(q.shape) == want,
          f"stacked critic: {len(seen)} attention calls on {tuple(q.shape)}, expected "
          f"{cfg.seq_num_layers} on {want}")
    return q, k, v


def _operands(layout, shape, dtype, gen, critic_qkv, n):
    """``n`` operands of ``shape``: the critic's own q, k, v (then a
    cotangent in their layout), the model's split views, or contiguous."""
    b, h, t, d = shape
    if layout == "critic_views":
        extra = (torch.randn((b, t, h * d), generator=gen, device="cuda")
                 .reshape(b, t, h, d).transpose(1, 2) for _ in range(n - 3))
        return (*critic_qkv, *extra)
    return tuple(
        (torch.randn((b, t, h * d), generator=gen, device="cuda")
         .reshape(b, t, h, d).transpose(1, 2) if layout == "views"
         else torch.randn(shape, generator=gen, device="cuda")).to(dtype)
        for _ in range(n)
    )


def phase_kernel_vs_plain(attn, seed: int, critic_qkv, cases=None) -> dict:
    """Every shape's check and times; returns the first case's row (by
    default the serving shape on the model's split views, the main
    path's operands)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = cases or [
        # (shape, causal, dtype, iters, layout): "views" are the model's
        # split (B, T, H, d) projections, transposed to (B, H, T, d);
        # "critic_views" the stacked critic's own (critic_views()).
        (SERVE_SHAPE, True, torch.float32, 200, "views"),
        (CRITIC_SHAPE, True, torch.float32, 200, "critic_views"),
        (SERVE_SHAPE, True, torch.float32, 200, "contiguous"),
        (BENCH_SHAPE, True, torch.float32, 5, "contiguous"),
        (BENCH_SHAPE, False, torch.float32, 5, "contiguous"),
        (BENCH_SHAPE, True, torch.bfloat16, 5, "contiguous"),
        (BENCH_SHAPE, False, torch.bfloat16, 5, "contiguous"),
        ((4, 8, 1000, 64), True, torch.float32, 10, "contiguous"),   # ragged T
        ((2, 3, 37, 24), False, torch.bfloat16, 50, "contiguous"),   # ragged T, padded d
    ]
    rows = []
    for shape, causal, dtype, iters, layout in cases:
        q, k, v = _operands(layout, shape, dtype, gen, critic_qkv, 3)
        out = attn.flash_attention_forward(q, k, v, causal)
        ref = attn.attention(q, k, v, causal, impl="plain")
        torch.cuda.synchronize()
        check(out.shape == ref.shape and out.dtype == dtype, f"{shape} shape/dtype")
        err = (out.float() - ref.float()).abs().max().item()
        check(math.isfinite(err) and err <= TOL[dtype],
              f"flash_fwd {shape} causal={causal} {dtype}: max abs err {err}")
        if dtype == torch.float32:
            check(err <= F32_GUARD,
                  f"flash_fwd {shape} f32: max abs err {err} > {F32_GUARD} "
                  "(a single TF32 pass?)")
        bound_ms, bound_by = attention_bound(shape, causal, dtype)

        def kernel():
            return attn.flash_attention_forward(q, k, v, causal)

        def plain():
            return attn.attention(q, k, v, causal, impl="plain")

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal)

        per_call = None
        if layout != "contiguous":
            per_call = kernels_per_call(kernel)
            check(per_call == 1, f"flash_fwd on the model's {layout}: {per_call} "
                                 "device kernels per call, expected 1")
        row = {
            "phase": "kernel_vs_plain", "kernel": "flash_fwd",
            "shape": list(shape), "causal": causal, "dtype": str(dtype),
            "layout": layout, "kernels_per_call": per_call,
            "max_abs_err": err, "tol": TOL[dtype],
            "f32_guard": F32_GUARD if dtype == torch.float32 else None,
            "kernel_ms": device_ms(kernel, iters, "flash_fwd_kernel"),
            "plain_ms": device_ms(plain, iters),
            "library_ms": device_ms(library, iters),
            "kernel_event_ms": time_ms(kernel, iters),
            "plain_event_ms": time_ms(plain, iters),
            "library_event_ms": time_ms(library, iters),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        emit(row)
        rows.append(row)
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return rows[0]


def bwd_bound(shape, causal: bool, dtype, kernel: str) -> tuple:
    """(bound_ms, bound_by) of one backward kernel: bytes moved over HBM
    rate — K3 reads q, k, v, O, dO and the f32 lse once and writes dq
    and the f32 Δ once; K4 reads q, k, v, dO, lse and Δ once and writes
    dk and dv once — and its FLOPs over the dtype's peak: K3 three
    products (s, dO·Vᵀ, ds·K) over the visible (q, k) pairs only under
    causality, plus Δ = rowsum(dO∘O) (2d per row); K4 four (s, pᵀ·dO,
    dO·Vᵀ, dsᵀ·Q)."""
    b, h, t, d = shape
    elt = torch.finfo(dtype).bits // 8
    rows = b * h * t
    products = 3 if kernel == "flash_bwd_dq" else 4
    nbytes = 6 * rows * d * elt + 2 * rows * 4
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 2 * products * d * pairs * b * h
    if kernel == "flash_bwd_dq":
        flops += 2 * d * rows
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_bwd_vs_plain(attn, seed: int, critic_qkv, cases=None) -> dict:
    """K3 and K4 against their plain versions on the card: error within
    TOL x max(1, max|plain|) (f32 also F32_GUARD x max(1, ...)), K3's
    Δ too, bitwise-equal repeat runs, and times; on the model's views
    one backward call must be two device kernels. Returns the views
    row of each kernel (the main path's operands) by name."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    cases = cases or [
        # (shape, causal, dtype, iters, layout): "views" are the model's
        # split (B, T, H, d) projections and head-merge cotangent;
        # "critic_views" the stacked critic's own q, k, v.
        (TRAIN_SHAPE, True, torch.float32, 200, "views"),
        (CRITIC_SHAPE, True, torch.float32, 200, "critic_views"),
        (TRAIN_SHAPE, True, torch.float32, 200, "contiguous"),
        (BENCH_SHAPE, True, torch.float32, 5, "contiguous"),
        (BENCH_SHAPE, False, torch.float32, 5, "contiguous"),
        (BENCH_SHAPE, True, torch.bfloat16, 5, "contiguous"),
        (BENCH_SHAPE, False, torch.bfloat16, 5, "contiguous"),
        ((4, 8, 1000, 64), True, torch.float32, 10, "contiguous"),   # ragged T
        ((2, 3, 37, 24), True, torch.float32, 50, "contiguous"),     # ragged T, padded d
        ((2, 3, 37, 24), False, torch.bfloat16, 50, "contiguous"),
    ]
    view_rows = {}
    for shape, causal, dtype, iters, layout in cases:
        d = shape[-1]
        q, k, v, do = _operands(layout, shape, dtype, gen, critic_qkv, 4)
        out, lse = attn.flash_attention_forward(q, k, v, causal, return_lse=True)

        def backward():
            return attn.flash_attention_backward(q, k, v, out, lse, do, causal)

        got = attn.flash_attention_backward(q, k, v, out, lse, do, causal)
        again = attn.flash_attention_backward(q, k, v, out, lse, do, causal)
        deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
        check(deterministic, f"flash backward {shape} {dtype}: repeat runs differ")
        scale = 1.0 / math.sqrt(d)
        want_dq, delta = attn._plain_flash_bwd_dq(q, k, v, out, do, lse, causal, scale)
        plain_args = (q, k, v, do, lse, delta, causal, scale)
        want_dk, want_dv = attn._plain_flash_bwd_dkv(*plain_args)
        torch.cuda.synchronize()
        errs = {}
        for name, pairs in (("flash_bwd_dq", [(got[0], want_dq), (got[3], delta)]),
                            ("flash_bwd_dkv", [(got[1], want_dk), (got[2], want_dv)])):
            err, lim = 0.0, 0.0
            for g, w in pairs:
                check(g.shape == w.shape and g.dtype == w.dtype, f"{name} {shape} shape/dtype")
                e = (g.float() - w.float()).abs().max().item()
                wmax = max(1.0, w.float().abs().max().item())
                lim = max(lim, TOL[dtype] * wmax)
                check(math.isfinite(e) and e <= TOL[dtype] * wmax,
                      f"{name} {shape} causal={causal} {dtype}: max abs err {e} > "
                      f"{TOL[dtype] * wmax}")
                if dtype == torch.float32:
                    check(e <= F32_GUARD * wmax,
                          f"{name} {shape} f32: max abs err {e} > {F32_GUARD * wmax} "
                          "(a single TF32 pass?)")
                err = max(err, e)
            errs[name] = (err, lim)
        per_call = None
        if layout != "contiguous":
            per_call = kernels_per_call(backward)
            check(per_call == 2, f"flash backward on the model's {layout}: {per_call} "
                                 "device kernels per call, expected 2 (K3, K4)")
        qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal)

        def library():
            return torch.autograd.grad(sdpa_out, (qs, ks, vs), do, retain_graph=True)

        library_ms = device_ms(library, iters)
        library_event_ms = time_ms(library, iters)
        backward_event_ms = time_ms(backward, iters)
        plain = {
            "flash_bwd_dq": lambda: attn._plain_flash_bwd_dq(
                q, k, v, out, do, lse, causal, scale),
            "flash_bwd_dkv": lambda: attn._plain_flash_bwd_dkv(*plain_args),
        }
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            bound_ms, bound_by = bwd_bound(shape, causal, dtype, name)
            kernel_ms = device_ms(backward, iters, name + "_kernel")
            row = {
                "phase": "kernel_vs_plain", "kernel": name, "shape": list(shape),
                "causal": causal, "dtype": str(dtype), "layout": layout,
                "kernels_per_call": per_call,
                "max_abs_err": errs[name][0], "tol": errs[name][1],
                "f32_guard": F32_GUARD if dtype == torch.float32 else None,
                "deterministic": deterministic,
                "kernel_ms": kernel_ms,
                "plain_ms": device_ms(plain[name], iters),
                "library_ms": library_ms,
                "library": "scaled_dot_product_attention backward (dq, dk, dv)",
                # the whole backward wrapper (K3 and K4), host included
                "backward_wrapper_event_ms": backward_event_ms,
                "plain_event_ms": time_ms(plain[name], iters),
                "library_event_ms": library_event_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            emit(row)
            if layout == "views":
                view_rows[name] = row
        del q, k, v, do, out, lse, got, again, want_dq, want_dk, want_dv
        del qs, ks, vs, sdpa_out, delta
    torch.cuda.empty_cache()
    return view_rows


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


SERVE_TRACED = 16  # 64-row requests in the serving trace
SERVE_TIMED = 300  # 64-row requests per mode for /act p50/p99


def _serve_args(extra) -> list:
    return ["--host", "127.0.0.1", "--port", "0", "--device", "cuda",
            "--poll-interval", "0", *extra]


def _plain_sequence(config, actor, state=None):
    """The served sequence actor with plain attention, on the card."""
    from torch_actor_critic_tpu_torch.models import build_actor
    from torch_actor_critic_tpu_torch.models.sequence import plain_attention

    plain = build_actor(config, (16, 3), 1, 2.0)
    for blk in plain.trunk.blocks:
        blk.attn.attention_fn = plain_attention
    plain.load_state_dict(actor.state_dict() if state is None else state)
    return plain.to("cuda").eval()


def _latencies(address, body, n: int) -> dict:
    """``n`` sequential requests: the client's wall time of each (JSON
    and HTTP included) and the server's own latency of these requests
    (its histogram's counts before and after, the difference's p50 and
    p99: submit to answer, the batcher and the engine)."""
    from torch_actor_critic_tpu_torch.telemetry.histogram import FixedBucketHistogram

    def hist():
        snap = json.loads(urllib.request.urlopen(address + "/metrics", timeout=60).read())
        return snap["latency_hist"]

    before, lat = hist()["counts"], []
    for _ in range(n):
        t0 = time.perf_counter()
        post(address + "/act", body)
        lat.append((time.perf_counter() - t0) * 1e3)
    after = hist()
    server = FixedBucketHistogram()
    # The lifetime min and max bound these requests' own: the estimate
    # clamps to them only in the under- and overflow buckets.
    server.merge_counts([a - b for a, b in zip(after["counts"], before)],
                        vmin=after["min"], vmax=after["max"])
    p50, p99 = server.percentiles((50, 99))
    return {"requests": n, "client_p50_ms": statistics.median(lat),
            "client_p99_ms": sorted(lat)[min(n - 1, int(0.99 * n))],
            "server_p50_ms": p50, "server_p99_ms": p99}


def _serve_traced(kernels, args, drive, what: str) -> tuple:
    """The CLI's server built, started and driven (``drive(server)``)
    under ONE device trace: its warm-up captures and every served
    forward. Returns ``(server, info, drive's result, wrapped, device,
    forwards)``: the K2 wrapper launches at start (each capture's eager
    warm-up and recorded forward), the K2 launches the trace counted
    and the forwards the server ran."""
    from torch_actor_critic_tpu_torch.serve.__main__ import build_server

    def run():
        kernels.reset_launch_counts()
        server, info = build_server(args)  # registers, captures every (bucket, det)
        server.start()
        wrapped = kernels.launch_counts["flash_fwd"]
        return server, info, drive(server), wrapped

    def discard(out):
        out[0].close()
        out[0].registry.close()

    (server, info, driven, wrapped), counted = traced(run, what, discard=discard)
    snap = json.loads(urllib.request.urlopen(server.address + "/metrics", timeout=60).read())
    return server, info, driven, wrapped, counted.get("flash_fwd", 0), snap["batches_total"]


def _check_served_launches(what, engine, layers, wrapped, device, forwards, want_forwards):
    """Each capture: one eager warm-up forward and the recorded one
    through the wrappers; on the device the warm-up, then one replay per
    warmed pair and per served forward: L K2 each."""
    n_pairs = 2 * len(engine.buckets)
    check(wrapped == 2 * layers * n_pairs,
          f"{what}: warm-up K2 wrapper launches {wrapped} != {2 * layers * n_pairs}")
    check(forwards == want_forwards, f"{what}: {forwards} forwards, expected {want_forwards}")
    check(device == layers * (2 * n_pairs + forwards),
          f"{what}: {device} K2 launches traced over {n_pairs} captures and {forwards} "
          f"served forwards, expected exactly {layers} a forward")


def _graphs_vs_eager(engine, params, rng) -> dict:
    """Every bucket's captured graph against the eager forward, bitwise,
    deterministic and sampled (one generator state for both)."""
    gen = engine.generator
    checked = 0
    for bucket in engine.buckets:
        for rows in sorted({max(1, bucket - 1), bucket}):
            obs = rng.standard_normal((rows, 16, 3)).astype("float32")
            got = engine.act(params, obs)
            want = engine.forward_eager(params, obs)
            check(bool((got == want).all()), f"bucket {bucket}: captured != eager (deterministic)")
            state = gen.get_state()
            got = engine.act(params, obs, gen, deterministic=False)
            after = gen.get_state()
            gen.set_state(state)
            want = engine.forward_eager(params, obs, gen, deterministic=False)
            check(bool((got == want).all()), f"bucket {bucket}: captured != eager (sampled)")
            check(torch.equal(after, gen.get_state()),
                  f"bucket {bucket}: the sampled graph left the generator elsewhere")
            checked += 2
    return {"buckets": list(engine.buckets), "pairs_checked": checked}


def _reload_under_traffic(server, ckpt, config, seed, rng, obs64) -> dict:
    """Hold the engine's door on one dispatched batch, publish and reload
    a new epoch while clients keep sending, then open it: the held batch
    answers on its old weights bitwise, later ones on the new; nothing is
    captured anew and no request fails."""
    import threading

    from torch_actor_critic_tpu_torch.models import build_actor
    from torch_actor_critic_tpu_torch.utils.checkpoint import save_actor

    engine, old, gen0 = server.registry.acquire()
    stats0, graphs0 = engine.compile_stats(), engine.graph_count()
    copies0 = engine.param_copies_total
    want_old = engine.forward_eager(old, obs64)
    new_actor = build_actor(config, (16, 3), 1, 2.0,
                            generator=torch.Generator().manual_seed(seed + 1))
    save_actor(ckpt, 2, new_actor, config)
    release, entered = threading.Event(), threading.Event()
    real_act = engine.act

    def held(*a, **k):
        if not entered.is_set():
            entered.set()
            release.wait(60)
        return real_act(*a, **k)

    errors, answered, stop = [], [0], threading.Event()

    def traffic():
        body = {"obs": rng.standard_normal((8, 16, 3)).astype("float32").tolist()}
        while not stop.is_set():
            try:
                post(server.address + "/act", body)
                answered[0] += 1
            except Exception as e:  # noqa: BLE001 — counted, checked below
                errors.append(repr(e)[:200])

    engine.act = held
    try:
        fut = server.batcher.submit(obs64)
        check(entered.wait(60), "the held batch never reached the engine")
        clients = [threading.Thread(target=traffic) for _ in range(2)]
        for th in clients:
            th.start()
        reload = post(server.address + "/reload", {})
        check(reload["reload"]["default"]["status"] == "ok", f"reload: {reload}")
        release.set()
        res = fut.result(timeout=60)
        time.sleep(0.3)
        stop.set()
        for th in clients:
            th.join(timeout=60)
    finally:
        release.set()
        stop.set()
        engine.act = real_act
    check(res.generation == gen0, f"held batch generation {res.generation} != {gen0}")
    check(bool((res.action == want_old).all()), "the held batch did not answer on its old weights")
    _, new, gen1 = server.registry.acquire()
    fresh = server.client.act(obs64)
    check(fresh.generation == gen1 == gen0 + 1, "the reload did not reach the engine")
    check(bool((fresh.action == engine.forward_eager(new, obs64)).all()),
          "after the reload: captured != eager on the new weights")
    check(not errors, f"requests failed across the reload: {errors[:3]}")
    check(engine.compile_stats() == stats0 and engine.graph_count() == graphs0,
          "the reload captured anew")
    return new_actor, {"answered_during": answered[0], "errors": len(errors),
                       "param_copies": engine.param_copies_total - copies0,
                       "captures": engine.compile_stats()["compiles_total"]}


def _tiers(kernels, attn, ckpt, config, actor, seed, rng, f32_actions, obs64, smi) -> dict:
    """The bf16 and int8 tiers, each served by the CLI's server under a
    device trace (startup and SERVE_TRACED 64-row forwards, exactly L K2
    each): bf16's K2 runs in bf16 (row held to its plain version;
    actions within 2e-2 of f32's, not bitwise them); int8's actions
    equal the forward on the dequantized f32 weights, its params under
    a third of f32's bytes on the device."""
    from torch_actor_critic_tpu_torch.serve.__main__ import parse_arguments
    from torch_actor_critic_tpu_torch.serve.sharded import dequantize_params, quantize_params

    layers = config.seq_num_layers
    body = {"obs": obs64.tolist(), "deterministic": True}
    out = {}
    bf16_row = phase_kernel_vs_plain(attn, seed, None, cases=[
        (SERVE_SHAPE, True, torch.bfloat16, 200, "views")])

    def drive(server):
        got = np.asarray(post(server.address + "/act", body)["action"], dtype=np.float32)
        for _ in range(SERVE_TRACED):
            post(server.address + "/act", body)
        return got

    for precision in ("bf16", "int8"):
        args = parse_arguments(_serve_args([
            "--ckpt-dir", ckpt, "--obs-dim", "3", "--act-dim", "1", "--act-limit", "2.0",
            "--seed", str(seed), "--serve-precision", precision]))
        server, _, got, wrapped, device, forwards = _serve_traced(
            kernels, args, drive, f"serve {precision}")
        try:
            engine = server.registry.acquire()[0]
            check(engine.precision == precision, f"{precision}: engine at {engine.precision}")
            snap = json.loads(urllib.request.urlopen(server.address + "/metrics", timeout=60).read())
            check("fleet" not in snap, f"{precision}: a one-card tier went through a fleet")
            check(snap["live_compiles"] == 0 and snap["compiles_total"] == 2 * len(engine.buckets),
                  f"{precision}: captures {snap['compiles']}")
            _check_served_launches(f"serve {precision}", engine, layers, wrapped, device,
                                   forwards, SERVE_TRACED + 1)
            placed = snap["sharding"]["per_replica"][0]["slot_bytes"]["default"]
            f32_bytes = sum(v.numel() * v.element_size() for v in actor.state_dict().values())
            row = {"precision": precision, "placed_bytes": placed, "f32_bytes": f32_bytes,
                   "launches": device, "forwards_traced": forwards,
                   "k2_per_forward_traced": (device - layers * 2 * 2 * len(engine.buckets))
                   / forwards, "captures": snap["compiles_total"]}
            if precision == "bf16":
                gap = float(np.abs(got - f32_actions).max())
                check(gap <= 2e-2 and not np.array_equal(got, f32_actions),
                      f"bf16 tier vs f32: max gap {gap} (bitwise: {np.array_equal(got, f32_actions)})")
                row["max_abs_vs_f32"] = gap
                row["latency"] = _latencies(server.address, body, SERVE_TIMED // 3)
            else:
                deq = dequantize_params(quantize_params(
                    {k: v.cuda() for k, v in actor.state_dict().items()}))
                plain = _plain_sequence(config, actor, {k: v.cpu() for k, v in deq.items()})
                with torch.inference_mode():
                    want, _ = plain(torch.from_numpy(obs64).cuda(), deterministic=True)
                err = float(np.abs(got - want.cpu().numpy()).max())
                check(err <= 1e-4, f"int8 tier vs the dequantized f32 forward: {err}")
                check(placed < f32_bytes / 3, f"int8 placed {placed} B, f32 {f32_bytes} B")
                row["max_abs_vs_dequantized"] = err
            row["nvidia_smi"] = smi
            emit({"phase": "serve_tier", **row})
            out[precision] = row
        finally:
            server.close()
            server.registry.close()
    out["bf16_row"] = bf16_row
    return out


def _pixel_run(seed, root) -> tuple:
    """A pixel-recipe run saved as the train CLI lays one out."""
    from torch_actor_critic_tpu_torch import train as train_cli
    from torch_actor_critic_tpu_torch.core.types import MultiObservation
    from torch_actor_critic_tpu_torch.models import build_actor
    from torch_actor_critic_tpu_torch.utils.checkpoint import save_actor
    from torch_actor_critic_tpu_torch.utils.tracking import Tracker

    cfg = train_cli.config_from_args(train_cli.parse_arguments(VISUAL_ARGS))
    tracker = Tracker(run_id="pixel", root=root)
    tracker.log_params({"environment": VISUAL_ENV, "config": json.loads(cfg.to_json()),
                        "seed": seed})
    actor = build_actor(cfg, MultiObservation((1,), (32, 32, 3)), 1, 2.0,
                        generator=torch.Generator().manual_seed(seed + 7))
    save_actor(tracker.artifact_path("checkpoints"), 1, actor, cfg)
    return actor, cfg


def _visual_run(seed, rng, root) -> dict:
    """``serve --run`` on a pixel-recipe run: ``{"features", "frame"}``
    requests answered as the actor's own eager forward answers (1e-4)."""
    from torch_actor_critic_tpu_torch.core.types import MultiObservation
    from torch_actor_critic_tpu_torch.serve.__main__ import build_server, parse_arguments

    actor, cfg = _pixel_run(seed, root)
    server, info = build_server(parse_arguments(_serve_args(
        ["--run", "pixel", "--runs-root", root, "--seed", str(seed)])))
    server.start()
    try:
        engine = server.registry.acquire()[0]
        check(engine.graph_count() == 2 * len(engine.buckets), "visual: not every pair captured")
        ref = actor.to("cuda").eval()
        errs = []
        for rows in (1, 5, 64):
            feats = rng.standard_normal((rows, 1)).astype(np.float32)
            frames = rng.integers(0, 256, (rows, 32, 32, 3), dtype=np.uint8)
            got = np.asarray(post(server.address + "/act", {"obs": {
                "features": feats.tolist(), "frame": frames.tolist()}})["action"],
                dtype=np.float32)
            with torch.inference_mode():
                want, _ = ref(MultiObservation(torch.from_numpy(feats).cuda(),
                                               torch.from_numpy(frames).cuda()),
                              deterministic=True, with_logprob=False)
            errs.append(float(np.abs(got - want.cpu().numpy()).max()))
            check(errs[-1] <= 1e-4, f"visual --run vs the actor's forward ({rows} rows): {errs[-1]}")
        row = {"phase": "serve_visual_run", "slot": info, "max_abs_err": max(errs),
               "config": {"filters": list(cfg.filters), "cnn_dense_size": cfg.cnn_dense_size,
                          "cnn_features": cfg.cnn_features, "hidden_sizes": list(cfg.hidden_sizes)}}
        emit(row)
        return row
    finally:
        server.close()
        server.registry.close()


def _fleet(ckpt, config, seed, rng) -> dict:
    """``serve --fleet 2`` on the one card: routed requests, a rolling
    reload under traffic, the router's /metrics totals against the
    workers' own, a worker killed under traffic with no request lost,
    and SIGTERM rolling the fleet down with exit 0."""
    import signal
    import threading

    from torch_actor_critic_tpu_torch.models import build_actor
    from torch_actor_critic_tpu_torch.utils.checkpoint import save_actor

    here = os.path.dirname(os.path.abspath(__file__))
    ready: dict = {}
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch_actor_critic_tpu_torch.serve", "--ckpt-dir", ckpt,
         "--obs-dim", "3", "--act-dim", "1", "--act-limit", "2.0", "--port", "0",
         "--poll-interval", "0", "--fleet", "2", "--router-poll", "0.2"],
        cwd=here, stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=here),
    )
    try:
        t0 = time.perf_counter()
        ready = json.loads(proc.stdout.readline())
        up_s = time.perf_counter() - t0
        router = ready["router"]
        body = {"obs": rng.standard_normal((8, 16, 3)).astype("float32").tolist()}
        errors, answered, stop = [], [0], threading.Event()

        def traffic(n=None):
            done = 0
            while (n is None and not stop.is_set()) or (n is not None and done < n):
                try:
                    out = post(router + "/act", body)
                    check(len(out["action"]) == 8, "fleet: wrong answer shape")
                    answered[0] += 1
                except Exception as e:  # noqa: BLE001 — counted, checked below
                    errors.append(repr(e)[:200])
                done += 1

        herd = [threading.Thread(target=traffic, args=(16,)) for _ in range(4)]
        for th in herd:
            th.start()
        for th in herd:
            th.join(timeout=120)
        check(answered[0] == 64 and not errors, f"fleet: 64 routed, {answered[0]} answered, {errors[:3]}")
        save_actor(ckpt, 3, build_actor(config, (16, 3), 1, 2.0,
                                        generator=torch.Generator().manual_seed(seed + 3)), config)
        herd = [threading.Thread(target=traffic) for _ in range(2)]
        for th in herd:
            th.start()
        rolled = post(router + "/reload", {})["reload"]
        time.sleep(0.5)
        stop.set()
        for th in herd:
            th.join(timeout=120)
        check(set(rolled) == {"w0", "w1"} and all(
            s["readmitted"] and s["reload"]["default"]["status"] == "ok" and
            s["reload"]["default"]["epoch"] == 3 for s in rolled.values()),
            f"rolling reload: {rolled}")
        check(not errors, f"fleet: requests lost in the rolling reload: {errors[:3]}")
        agg = json.loads(urllib.request.urlopen(router + "/metrics", timeout=60).read())
        per = [json.loads(urllib.request.urlopen(a + "/metrics", timeout=60).read())
               for a in ready["workers"].values()]
        for key in ("responses_total", "requests_total", "batches_total"):
            check(agg[key] == sum(p[key] for p in per),
                  f"fleet /metrics {key}: {agg[key]} != {[p[key] for p in per]}")
        before_kill = answered[0]
        stop.clear()
        herd = [threading.Thread(target=traffic) for _ in range(3)]
        for th in herd:
            th.start()
        time.sleep(0.3)
        os.kill(ready["pids"][0], signal.SIGKILL)
        time.sleep(1.0)
        stop.set()
        for th in herd:
            th.join(timeout=120)
        check(not errors, f"fleet: requests lost when a worker died: {errors[:3]}")
        health = json.loads(urllib.request.urlopen(router + "/healthz", timeout=60).read())
        check(health["admitted_workers"] == 1, f"fleet: dead worker still admitted: {health}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        check(rc == 0, f"fleet: exit code {rc} after SIGTERM")
        row = {"phase": "serve_fleet", "workers": 2, "startup_s": up_s,
               "answered_total": answered[0], "answered_after_kill": answered[0] - before_kill,
               "lost": len(errors), "rolling_reload": {k: v["readmitted"] for k, v in rolled.items()},
               "aggregate_responses_total": agg["responses_total"],
               "workers_responses_total": [p["responses_total"] for p in per], "exit_code": rc}
        emit(row)
        return row
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        for pid in ready.get("pids", []):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        proc.stdout.close()


def phase_serve(seed: int, kernels, attn, smi: str) -> dict:
    """The serving plane through the CLI's ``build_server``: every
    (bucket, deterministic) forward one CUDA graph captured at warmup,
    served requests against the plain forward, the startup and the
    served forwards under one device trace (exactly L K2 launches a
    forward), captured == eager at every bucket, a reload under
    traffic, eager against captured host and /act times, the bf16 and
    int8 tiers, the pixel recipe through ``--run`` and ``--fleet 2``.
    Returns the traced K2 launches of the f32 (with int8) and bf16
    serving paths and the bf16 K2 row."""
    from torch_actor_critic_tpu_torch.models import build_actor
    from torch_actor_critic_tpu_torch.serve.__main__ import parse_arguments
    from torch_actor_critic_tpu_torch.utils.checkpoint import save_actor
    from torch_actor_critic_tpu_torch.utils.config import SACConfig

    history, obs_dim, act_dim, act_limit = 16, 3, 1, 2.0
    config = SACConfig(history_len=history)  # seq widths: 64 / 4 heads / 2 layers
    layers = config.seq_num_layers
    actor = build_actor(config, (history, obs_dim), act_dim, act_limit,
                        generator=torch.Generator().manual_seed(seed))
    ckpt = tempfile.mkdtemp(prefix="tac_chip_smoke_")
    runs = tempfile.mkdtemp(prefix="tac_chip_runs_")
    rng = np.random.default_rng(seed)
    try:
        save_actor(ckpt, 1, actor, config)
        args = parse_arguments(_serve_args([
            "--ckpt-dir", ckpt, "--obs-dim", str(obs_dim),
            "--act-dim", str(act_dim), "--act-limit", str(act_limit), "--seed", str(seed)]))
        plain = _plain_sequence(config, actor)
        obs64 = rng.standard_normal((64, history, obs_dim)).astype(np.float32)
        body = {"obs": obs64.tolist(), "deterministic": True}

        def drive(server):
            """The checked requests, then SERVE_TRACED 64-row ones."""
            requests, lat = [], []
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
            for _ in range(SERVE_TRACED):
                post(server.address + "/act", body)
            return requests, lat

        # The main path: startup (every capture) and the served forwards,
        # their K2 launches counted from one device trace.
        server, info, (requests, lat), at_start, launches, forwards = _serve_traced(
            kernels, args, drive, "serve")
        try:
            engine, params, _ = server.registry.acquire()
            n_pairs = 2 * len(engine.buckets)
            stats = engine.compile_stats()
            check(engine.graphed and engine.graph_count() == n_pairs
                  and stats["compiles_total"] == n_pairs and stats["live_compiles"] == 0,
                  f"warmup captured {engine.graph_count()} graphs, stats {stats}")
            check(kernels.launch_counts["flash_fwd"] == at_start,
                  "a served request launched K2 outside its graph")
            _check_served_launches("serve", engine, layers, at_start, launches, forwards,
                                   len(requests) + SERVE_TRACED)
            versus = _graphs_vs_eager(engine, params, rng)
            profile = profile_requests(server.address, rng, history, obs_dim)
            host = {}
            for mode, fn in (("captured", engine.act), ("eager", engine.forward_eager)):
                ms = []
                for _ in range(50):
                    t0 = time.perf_counter()
                    fn(params, obs64)
                    ms.append((time.perf_counter() - t0) * 1e3)
                host[mode] = statistics.median(ms)
            latency = {"captured": _latencies(server.address, body, SERVE_TIMED)}
            real_act = engine.act
            engine.act = engine.forward_eager  # the eager engine, for the comparison alone
            try:
                latency["eager"] = _latencies(server.address, body, SERVE_TIMED)
            finally:
                engine.act = real_act
            latency["captured_again"] = _latencies(server.address, body, SERVE_TIMED)
            served_actor, reload = _reload_under_traffic(server, ckpt, config, seed, rng, obs64)
            # The tiers below serve the newest epoch, the reload's.
            f32_actions = np.asarray(post(server.address + "/act", body)["action"],
                                     dtype=np.float32)
            metrics = json.loads(urllib.request.urlopen(
                server.address + "/metrics", timeout=60).read())
            check(metrics["errors_total"] == 0, "serving errors")
            check(metrics["live_compiles"] == 0, f"live captures: {metrics['live_compiles']}")
            emit({
                "phase": "serve", "slot": info, "requests": requests,
                "graphs": engine.graph_count(), "compile_stats": engine.compile_stats(),
                "forwards": metrics["batches_total"], "flash_launches_traced": launches,
                "flash_wrapper_launches_warmup": at_start, "traced_forwards": forwards,
                "graphs_vs_eager": versus,
                "reload_under_traffic": reload,
                "p50_ms": metrics.get("p50_ms"), "p99_ms": metrics.get("p99_ms"),
                "client_median_ms": statistics.median(lat),
                "live_compiles": metrics["live_compiles"],
                "profile_64_rows_deterministic": profile,
                "engine_host_ms_64_rows": host, "act_64_rows": latency,
                "bucket_forward": metrics.get("bucket_forward"), "nvidia_smi": smi,
            })
        finally:
            closed = server.close()
            check(closed["server_thread_stopped"], "server thread did not stop")
            server.registry.close()
        tiers = _tiers(kernels, attn, ckpt, config, served_actor, seed, rng, f32_actions,
                       obs64, smi)
        _visual_run(seed, rng, runs)
        _fleet(ckpt, config, seed, rng)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        shutil.rmtree(runs, ignore_errors=True)
    return {"flash_fwd": launches + tiers["int8"]["launches"],
            "flash_fwd_bf16": tiers["bf16"]["launches"], "bf16_row": tiers["bf16_row"]}


def _param_gap(a, b) -> tuple:
    """(max abs gap over parameters, the same over attention key
    biases) between two modules of one structure."""
    gap, kbias = 0.0, 0.0
    pb = dict(b.named_parameters())
    for name, p in a.named_parameters():
        e = (p.detach() - pb[name].detach()).abs().max().item()
        if name.endswith("attn.k.bias"):
            kbias = max(kbias, e)
        else:
            gap = max(gap, e)
    return gap, kbias


def phase_train(seed: int, kernels) -> dict:
    """Train the full-width sequence policy through train.py's own
    path; returns the kernels' launch counts of that run."""
    import copy

    from torch_actor_critic_tpu_torch import train as train_cli
    from torch_actor_critic_tpu_torch.buffer.replay import sample
    from torch_actor_critic_tpu_torch.models import build_models
    from torch_actor_critic_tpu_torch.models.sequence import (
        MultiHeadAttention,
        StackedMultiHeadAttention,
        plain_attention,
    )
    from torch_actor_critic_tpu_torch.sac.algorithm import SAC
    from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer

    runs = tempfile.mkdtemp(prefix="tac_chip_train_")
    try:
        args = train_cli.parse_arguments([
            "--environment", TRAIN_ENV, "--history-len", "16", "--device", "cuda",
            "--seed", str(seed), "--epochs", "1", "--steps-per-epoch", "1000",
            "--start-steps", "500", "--update-after", "500", "--runs-root", runs,
        ])

        def drive():
            trainer, _ = train_cli.build_trainer(args)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            metrics = trainer.train(
                on_epoch=lambda e, m: emit({"phase": "train_epoch", "epoch": e, **m}))
            torch.cuda.synchronize()
            return trainer, metrics, time.perf_counter() - t0, dict(kernels.launch_counts)

        # The main path, traced: its replays launch the kernels without
        # the wrappers, so the launches are read from the device trace.
        (trainer, metrics, train_s, wrapped), launches = traced(
            drive, "train", discard=lambda out: out[0].close())
        cfg = trainer.config
        layers, q = cfg.seq_num_layers, cfg.num_qs
        for key in ("loss_q", "loss_pi", "reward"):
            check(math.isfinite(metrics[key]), f"train: {key} = {metrics[key]}")
        updates = trainer.state.step
        check(updates == 500, f"train: {updates} gradient steps, expected 500")
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            check(wrapped.get(name, 0) > 0, f"train: {name} never launched by its wrapper")
            check(launches[name] > 0, f"train: {name} never ran on the device")

        # The saved actor restores through the serving read path.
        restored, meta = Checkpointer(trainer.checkpointer.directory).restore_actor_params()
        live = trainer.state.actor.state_dict()
        check(all(torch.equal(restored[k], live[k].cpu()) for k in live),
              "checkpoint does not restore the trained actor")

        # Launches per update, exactly, whatever Q: forward 5L (actor on the
        # next states, target critic, critic, actor, frozen critic), dQ and
        # dK/dV 2L (critic, actor); one call a layer serves all Q critics.
        gen = torch.Generator(device="cuda").manual_seed(seed + 5)
        batch = sample(trainer.buffer, cfg.batch_size, generator=gen)
        kernels.reset_launch_counts()
        n_upd = 5
        for _ in range(n_upd):
            trainer.sac.update(trainer.state, batch)
        torch.cuda.synchronize()
        per_update = {k: v / n_upd for k, v in kernels.launch_counts.items()}
        want = {"flash_fwd": 5 * layers, "flash_bwd_dq": 2 * layers,
                "flash_bwd_dkv": 2 * layers}
        check(per_update == want, f"launches per update {per_update} != {want}")
        check_through_graphs("train", launches, wrapped, want, updates,
                             trainer.sac.graph_captures)
        stacked = _check_stacked_critic(trainer, batch, kernels)

        # One update from one state, with the kernels and with plain attention.
        obs_shape = trainer.obs_shape
        act_dim, act_limit = trainer.pool.act_dim, trainer.pool.act_limit

        def replica(attention_fn):
            actor, critic = build_models(cfg, obs_shape, act_dim, act_limit)
            if attention_fn is not None:
                for m in (*actor.modules(), *critic.modules()):
                    if isinstance(m, (MultiHeadAttention, StackedMultiHeadAttention)):
                        m.attention_fn = attention_fn
            actor.load_state_dict(trainer.state.actor.state_dict())
            critic.load_state_dict(trainer.state.critic.state_dict())
            st = trainer.sac.init_state(actor.cuda(), critic.cuda(), gen)
            st.target_critic.load_state_dict(trainer.state.target_critic.state_dict())
            for mine, theirs in ((st.pi_opt, trainer.state.pi_opt),
                                 (st.q_opt, trainer.state.q_opt)):
                mine.load_state_dict(copy.deepcopy(theirs.state_dict()))
            return st

        idx = torch.randint(0, trainer.buffer.size, (cfg.batch_size,),
                            generator=gen, device="cuda")
        batch = sample(trainer.buffer, cfg.batch_size, indices=idx)
        eps_q, eps_pi = (torch.randn((cfg.batch_size, act_dim), generator=gen,
                                     device="cuda") for _ in range(2))

        with_kernels, with_plain = replica(None), replica(plain_attention)
        grads_k = _sac_grads(with_kernels, cfg, batch, eps_q, eps_pi)
        trainer.sac.update(with_kernels, batch, eps_q=eps_q, eps_pi=eps_pi)
        kernels.reset_launch_counts()
        grads_p = _sac_grads(with_plain, cfg, batch, eps_q, eps_pi)
        trainer.sac.update(with_plain, batch, eps_q=eps_q, eps_pi=eps_pi)
        torch.cuda.synchronize()
        check(sum(kernels.launch_counts.values()) == 0,
              "the plain-attention gradients or update launched a kernel")
        grad_gaps = {}
        for part in ("critic", "actor"):
            gap = max((a - b).abs().max().item()
                      for a, b in zip(grads_k[part], grads_p[part]))
            lim = 1e-4 * max(1.0, max(b.abs().max().item() for b in grads_p[part]))
            check(gap <= lim, f"kernel vs plain {part} gradients: gap {gap} > {lim}")
            grad_gaps[part] = {"max_gap": gap, "limit": lim}
        gaps = {}
        for part in ("actor", "critic", "target_critic"):
            gaps[part] = _param_gap(getattr(with_kernels, part), getattr(with_plain, part))
        worst = max(g for g, _ in gaps.values())
        worst_kbias = max(kb for _, kb in gaps.values())
        check(worst <= 1e-4, f"kernel vs plain update: param gap {worst}")
        check(worst_kbias <= 2 * cfg.lr, f"key-bias gap {worst_kbias} > 2 lr")
        with torch.no_grad():
            a_k, _ = with_kernels.actor(batch.states, deterministic=True)
            a_p, _ = with_plain.actor(batch.states, deterministic=True)
            q_k = with_kernels.critic(batch.states, batch.actions)
            q_p = with_plain.critic(batch.states, batch.actions)
        out_gap = max((a_k - a_p).abs().max().item(), (q_k - q_p).abs().max().item())
        check(out_gap <= 1e-4, f"kernel vs plain update: output gap {out_gap}")

        # From one cloned state, the captured burst against the eager one;
        # then each mode's bursts alone, timed and profiled.
        per = cfg.updates_per_window
        same = compare_bursts(
            lambda: SAC(cfg, act_dim), trainer.state, trainer.buffer,
            [sample(trainer.buffer, cfg.update_every, generator=gen) for _ in range(2)], per)
        chunk = sample(trainer.buffer, cfg.update_every, generator=gen)

        def burst(eager):
            trainer.state, trainer.buffer, m = trainer.sac.update_burst(
                trainer.state, trainer.buffer, chunk, per, eager=eager)
            return m

        modes = burst_modes(kernels, burst, per, 4, want)
        # The graph captured at the first burst of training served every
        # later one, here too.
        check(trainer.sac.graph_captures == 1,
              f"train: {trainer.sac.graph_captures} captures, expected 1")
        captured = modes["captured"]
        adam_kernels = {part: adam_step_kernels(getattr(trainer.state, part))
                        for part in ("actor", "critic")}
        adam = {part: adam_parity(getattr(trainer.state, part), getattr(trainer.state, opt),
                                  cfg.lr, gen)
                for part, opt in (("actor", "pi_opt"), ("critic", "q_opt"))}

        # Acting alone: policy forward on the card + the host env step.
        obs = trainer.pool.reset_all([seed])
        t0 = time.perf_counter()
        for _ in range(200):
            obs, *_ = trainer.pool.step(trainer._policy_actions(obs))
        act_steps_per_s = 200 / (time.perf_counter() - t0)
        trainer.close()
        emit({
            "phase": "train", "env": TRAIN_ENV, "config": {
                "d_model": cfg.seq_d_model, "heads": cfg.seq_num_heads,
                "layers": layers, "history": cfg.history_len, "num_qs": q,
                "batch_size": cfg.batch_size, "update_every": cfg.update_every,
                "steps": cfg.steps_per_epoch, "start_steps": cfg.start_steps,
            },
            "train_wall_s": train_s, "gradient_steps": updates,
            "epoch_grad_steps_per_sec": metrics["grad_steps_per_sec"],
            "epoch_env_steps_per_sec": metrics["env_steps_per_sec"],
            "launches": launches, "wrapper_launches": wrapped,
            "launches_per_update": per_update, "stacked_critic": stacked,
            "kernel_vs_plain_update": {
                "max_param_gap": worst, "max_key_bias_gap": worst_kbias,
                "max_output_gap": out_gap, "gradients": grad_gaps,
                "by_module": {k: {"params": g, "key_bias": kb} for k, (g, kb) in gaps.items()},
            },
            "checkpoint_epoch": meta["epoch"],
            "burst_ms": captured["burst_ms"],
            "burst_grad_steps_per_sec": captured["grad_steps_per_sec"],
            "device_kernels_per_update": captured["device_kernels_per_update"],
            "device_idle_share": captured["device_idle_share"],
            "graph_captures": trainer.sac.graph_captures, "captured_vs_eager": same,
            "bursts": modes,
            "adam_step_device_kernels": adam_kernels,
            "adam_capturable_vs_plain": adam,
            "acting_env_steps_per_sec": act_steps_per_s,
        })
        return launches
    finally:
        shutil.rmtree(runs, ignore_errors=True)


def _check_stacked_critic(trainer, batch, kernels) -> dict:
    """The trained stacked critic on the card: one forward launches L K2
    kernels and its backward L K3 and L K4, for all Q members at once;
    each member's Q equals its slices run alone through a single
    ``SequenceCritic`` (1e-5·max(1, max|q|)). Reports the device kernels
    of one forward and of one forward + backward."""
    from torch_actor_critic_tpu_torch.models.sequence import SequenceCritic

    cfg, critic = trainer.config, trainer.state.critic
    layers = cfg.seq_num_layers
    kernels.reset_launch_counts()
    with torch.no_grad():
        q_all = critic(batch.states, batch.actions)
    torch.cuda.synchronize()
    forward = dict(kernels.launch_counts)
    check(forward == {"flash_fwd": layers},
          f"stacked critic forward launched {forward}, expected {layers} flash_fwd")
    kernels.reset_launch_counts()
    critic(batch.states, batch.actions).sum().backward()
    torch.cuda.synchronize()
    critic.zero_grad(set_to_none=True)
    with_grad = dict(kernels.launch_counts)
    want = {"flash_fwd": layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
    check(with_grad == want, f"stacked critic forward + backward launched {with_grad}, "
                             f"expected {want}")
    obs_dim, act_dim = batch.states.shape[-1], batch.actions.shape[-1]
    gap, lim = 0.0, 1e-5 * max(1.0, q_all.abs().max().item())
    for i in range(critic.num_qs):
        alone = SequenceCritic(
            obs_dim, act_dim, cfg.seq_d_model, cfg.seq_num_heads, layers,
            cfg.history_len, hidden=critic.fc.weight.shape[1], dtype=cfg.model_dtype,
        )
        alone.load_state_dict({k: v[i] for k, v in critic.state_dict().items()})
        with torch.no_grad():
            q_i = alone.cuda()(batch.states, batch.actions)
        gap = max(gap, (q_all[i] - q_i).abs().max().item())
    check(gap <= lim, f"stacked critic vs its members alone: gap {gap} > {lim}")

    def forward_only():
        with torch.no_grad():
            critic(batch.states, batch.actions)

    def forward_backward():
        critic(batch.states, batch.actions).sum().backward()

    device_kernels = {"forward": kernels_per_call(forward_only),
                      "forward_backward": kernels_per_call(forward_backward)}
    critic.zero_grad(set_to_none=True)
    return {"num_qs": critic.num_qs, "forward_launches": forward,
            "forward_backward_launches": with_grad,
            "device_kernels": device_kernels,
            "member_alone_max_gap": gap, "member_alone_limit": lim}


# ------------------------------------------------------------------ visual

PIXEL_PAD = 4
# (label, ring shape, batch, dtype, normalize, shift, frame_stack, leaves,
# iters): the pixel recipe's training shape (train_visual's batches), the same
# with a 3-frame stack over wrap-around rows, and the wall-runner geometry at
# the two visual_burst points, one leaf a call; then the training shape and the
# B 512 wall-runner burst with both frame leaves (states, next states) in one
# launch, as sample_fused_visual launches K1.
PIXEL_CASES = [
    ("train", (24000, 32, 32, 3), 64, torch.float32, True, True, 1, 1, 200),
    ("train_stack3", (24000, 32, 32, 3), 64, torch.float32, True, True, 3, 1, 200),
    ("wall_b32", (20000, 64, 64, 3), 32, torch.float32, False, False, 1, 1, 200),
    ("wall_b512_bf16", (20000, 64, 64, 3), 512, torch.bfloat16, True, True, 1, 1, 50),
    ("train_pair", (24000, 32, 32, 3), 64, torch.float32, True, True, 1, 2, 200),
    ("wall_b512_bf16_pair", (20000, 64, 64, 3), 512, torch.bfloat16, True, True, 1, 2, 50),
]
VISUAL_ENV = "PixelPendulumBalanceNumpy-v0"
# The JAX package's PIXEL_RECIPE, the configuration of runs/pixelbal-wide/.
VISUAL_ARGS = [
    "--environment", VISUAL_ENV, "--filters", "16,32", "--kernel-sizes", "4,3",
    "--strides", "2,2", "--cnn-dense-size", "128", "--cnn-features", "64",
    "--normalize-pixels", "true", "--frame-augment", "shift", "--learn-alpha", "true",
    "--pixel-pipeline", "fused",
]
WALL_FEATURES, WALL_FRAME, WALL_ACT_DIM = 168, (64, 64, 3), 56  # envs/wall_runner.py


def pixel_bound(batch: int, frame, stack: int, dtype, shift: bool, leaves: int = 1) -> tuple:
    """(bound_ms, "bytes"): per leaf, the uint8 frames read once (B·S·H·W·C),
    its int32 offsets read once and its output written once; the int64 rows
    read once for all leaves; over HBM rate. The kernel does no arithmetic
    to speak of."""
    h, w, c = frame
    elems = batch * stack * h * w * c
    per_leaf = elems + (8 * batch if shift else 0) + elems * torch.finfo(dtype).bits // 8
    nbytes = 8 * batch + leaves * per_leaf
    return nbytes / H100_BYTES_PER_S * 1e3, "bytes"


def phase_pixel_vs_plain(pixels, seed: int) -> dict:
    """K1 against its plain version on the card: bitwise equality (each
    leaf of a pair) and device times. Each timed call gathers other rows
    (``iters`` draws cycled), as each update does. Returns the rows by
    label."""
    from torch_actor_critic_tpu_torch.ops.augment import shift_offsets

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    rows = {}
    rings = {}
    for label, ring_shape, b, dtype, normalize, shift, stack, leaves, iters in PIXEL_CASES:
        if ring_shape not in rings:
            rings.clear()
            torch.cuda.empty_cache()
            pair = []
            for _ in range(2):  # the states' and the next states' rings
                ring = torch.randint(0, 256, ring_shape, generator=gen, device="cuda",
                                     dtype=torch.uint8)
                ring[1].view(-1)[:256] = torch.arange(256, device="cuda", dtype=torch.uint8)
                pair.append(ring)
            rings[ring_shape] = pair
        pair = rings[ring_shape][:leaves]
        draws = []
        for i in range(iters):
            idx = torch.randint(0, ring_shape[0], (b,), generator=gen, device="cuda")
            if i == 0:
                idx[:2] = torch.tensor([0, 1], device="cuda")  # wrap-around, all values
            offs = [shift_offsets(b, PIXEL_PAD, gen, "cuda") if shift else None
                    for _ in range(leaves)]
            draws.append((idx, offs))
        kw = dict(pad=PIXEL_PAD, normalize=normalize, out_dtype=dtype, frame_stack=stack)

        def kernel(i):
            idx, offs = draws[i % iters]
            if leaves == 2:
                return pixels.fused_frame_gather_pair(pair, idx, offs, **kw)
            return (pixels.fused_frame_gather(pair[0], idx, offs[0], **kw),)

        def plain(i):
            idx, offs = draws[i % iters]
            return tuple(pixels.gather_frames_reference(r, idx, o, **kw)
                         for r, o in zip(pair, offs))

        got, want = kernel(0), plain(0)
        torch.cuda.synchronize()
        err = 0.0
        for leaf, (g, w) in enumerate(zip(got, want)):
            check(g.dtype == dtype and g.shape == w.shape,
                  f"pixel_gather {label} leaf {leaf} shape/dtype")
            check(torch.equal(g, w), f"pixel_gather {label} leaf {leaf}: kernel != plain version")
            err = max(err, (g.float() - w.float()).abs().max().item())
        turn = iter(range(10 ** 9))
        bound_ms, bound_by = pixel_bound(b, ring_shape[1:], stack, dtype, shift, leaves)
        row = {
            "phase": "kernel_vs_plain", "kernel": "pixel_gather", "case": label,
            "ring": list(ring_shape), "batch": b, "dtype": str(dtype),
            "normalize": normalize, "shift": shift, "frame_stack": stack, "leaves": leaves,
            "bitwise_equal": True, "max_abs_err": err,
            "kernel_ms": device_ms(lambda: kernel(next(turn)), iters, "pixel_gather_kernel"),
            "plain_ms": device_ms(lambda: plain(next(turn)), iters),
            # No single PyTorch call gathers rows, shifts, decodes and casts.
            "library_ms": None,
            "kernel_event_ms": time_ms(lambda: kernel(next(turn)), iters),
            "plain_event_ms": time_ms(lambda: plain(next(turn)), iters),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": [b, *ring_shape[1:3], stack * ring_shape[3]],
        }
        emit(row)
        rows[label] = row
        del got, want, draws
    rings.clear()
    torch.cuda.empty_cache()
    return rows


def _visual_replica(trainer, gen):
    """A fresh learner state on the card holding ``trainer``'s networks,
    optimizer states and temperature."""
    import copy

    from torch_actor_critic_tpu_torch.models import build_models

    cfg = trainer.config
    actor, critic = build_models(cfg, trainer.obs_shape, trainer.pool.act_dim,
                                 trainer.pool.act_limit)
    actor.load_state_dict(trainer.state.actor.state_dict())
    critic.load_state_dict(trainer.state.critic.state_dict())
    st = trainer.sac.init_state(actor.cuda(), critic.cuda(), gen)
    st.target_critic.load_state_dict(trainer.state.target_critic.state_dict())
    with torch.no_grad():
        st.log_alpha.copy_(trainer.state.log_alpha)
    for mine, theirs in ((st.pi_opt, trainer.state.pi_opt), (st.q_opt, trainer.state.q_opt),
                         (st.alpha_opt, trainer.state.alpha_opt)):
        mine.load_state_dict(copy.deepcopy(theirs.state_dict()))
    return st


def _sac_grads(st, cfg, batch, eps_q, eps_pi) -> dict:
    """The critic's and the actor's loss gradients w.r.t. their own
    parameters, as the update takes them."""
    from torch_actor_critic_tpu_torch.sac import losses

    alpha = st.log_alpha.detach().exp() if cfg.learn_alpha else cfg.alpha
    loss_q, _ = losses.critic_loss(
        st.critic, actor=st.actor, target_critic=st.target_critic, batch=batch,
        alpha=alpha, gamma=cfg.gamma, reward_scale=cfg.reward_scale, eps=eps_q)
    g_q = torch.autograd.grad(loss_q, list(st.critic.parameters()))
    st.critic.requires_grad_(False)
    try:
        loss_pi, _ = losses.actor_loss(
            st.actor, critic=st.critic, batch=batch, alpha=alpha,
            parity_pi_obs=cfg.parity_pi_obs, eps=eps_pi)
        g_pi = torch.autograd.grad(loss_pi, list(st.actor.parameters()))
    finally:
        st.critic.requires_grad_(True)
    return {"critic": g_q, "actor": g_pi}


def profile_burst(burst, per: int, attempts: int = 4) -> dict:
    """One burst of ``per`` updates under ``torch.profiler``: wall vs
    device-busy time, the kernels per update, and each hand-written
    kernel's launches per update by its device symbol, in a trace that
    begins with ``trace_lead_in`` and ends with ``trace_tail``. A trace
    with no device kernel or without the tail's is taken again with
    another burst, up to ``attempts``."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trace_lead_in()
            t0 = time.perf_counter()
            burst()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            trace_tail()
        rows = traced_rows(prof)
        if rows:
            break
        print(f"chip_smoke: burst trace {attempt} of {attempts} held no device kernel "
              "or lost its end",
              file=sys.stderr, flush=True)
    check(bool(rows), f"the profiler traced no device kernel of a burst in {attempts} traces")
    kern = sorted(((key, us / per / 1e3, calls / per) for key, us, calls in rows),
                  key=lambda x: -x[1])
    busy_ms = sum(k[1] for k in kern) * per
    return {
        "launches_per_update": {k: n / per for k, n in launches_by_symbol(rows).items()},
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "top_kernels_ms_per_update": [
            {"name": k[0][:80], "ms": k[1], "calls": k[2]} for k in kern[:10]
        ],
        "device_kernels_per_update": sum(k[2] for k in kern),
        "host_ops_per_update": host_ops(prof, per, top=10),
    }


def _learner_gaps(a, b) -> dict:
    """Max abs gap of two learner states: parameters (actor, critic,
    targets: TD3's target actor too), Adam states (moments and device
    step), log α; and whether their generators' states (seed and offset)
    and step counts (host and device) agree."""
    def gap(x, y):
        return (torch.as_tensor(x).double() - torch.as_tensor(y).double()).abs().max().item()

    def opt_states(st, opt):
        o = getattr(st, opt)
        return [o.state[p] for g in o.param_groups for p in g["params"]]

    return {
        "params": max(gap(p, q) for ma, mb in zip(a.modules(), b.modules(), strict=True)
                      for p, q in zip(ma.parameters(), mb.parameters(), strict=True)),
        "adam": max(gap(x[k], y[k]) for opt in ("pi_opt", "q_opt", "alpha_opt")
                    for x, y in zip(opt_states(a, opt), opt_states(b, opt), strict=True)
                    for k in x),
        "log_alpha": gap(a.log_alpha, b.log_alpha),
        "same_generator": torch.equal(a.generator.get_state(), b.generator.get_state()),
        "same_step": a.step == b.step and torch.equal(a.device_step, b.device_step),
    }


BITWISE = {"params": 0.0, "adam": 0.0, "log_alpha": 0.0, "same_generator": True,
           "same_step": True}


def package_cudnn() -> dict:
    """The cuDNN setting the port's package sets on import (deterministic
    algorithms, no benchmark), checked in force: every visual run here is
    bitwise run to run on it, without the smoke setting it."""
    got = {"deterministic": torch.backends.cudnn.deterministic,
           "benchmark": torch.backends.cudnn.benchmark}
    check(got == {"deterministic": True, "benchmark": False},
          f"the package's cuDNN setting is not in force: {got}")
    return got


@contextlib.contextmanager
def default_cudnn():
    """cuDNN's default algorithms (not deterministic), for the rows that
    show what they gave before the package selected the deterministic
    ones; the package's setting is back on exit."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def compare_bursts(make_sac, state, ring, chunks, per: int, eager_twice: bool = False,
                   with_default_cudnn: bool = False) -> dict:
    """From clones of one learner state and ring (``TrainState.clone``,
    ``BufferState.clone``: modules, target, Adam states with their device
    steps, log α, the generator; the ring with its device size),
    ``len(chunks)`` bursts of ``per`` updates as CUDA graph replays (the
    first: 1 warm-up update, the capture, per - 1 replays; the next all
    replays) and through the eager loop (``eager=True``), on the
    package's cuDNN setting (``package_cudnn``). Fails unless every
    parameter, Adam moment and step, log α, the generator's state, the
    step count and every burst metric agree to the bit, with one capture.
    ``eager_twice``: two eager runs against each other too, to the bit (a
    visual update's convolution backward is bitwise run to run on the
    package's setting only). ``with_default_cudnn``: the row also holds
    what cuDNN's default algorithms give, two eager runs against each
    other and one replayed update against one eager update
    (``one_update_default_cudnn``)."""
    def run(eager):
        sac, st, buf = make_sac(), state.clone(), ring.clone()
        metrics = []
        for chunk in chunks:
            st, buf, m = sac.update_burst(st, buf, chunk, per, eager=eager)
            metrics.append(m)
        torch.cuda.synchronize()
        return st, metrics, sac.graph_captures

    cudnn = package_cudnn()
    eager, m_eager, _ = run(True)
    graph, m_graph, captures = run(False)
    gaps = _learner_gaps(graph, eager)
    row = {"bursts": len(chunks), "updates_per_burst": per, "cudnn": cudnn,
           "captures": captures, **gaps,
           "metrics_bitwise": all(torch.equal(g[k], e[k])
                                  for g, e in zip(m_graph, m_eager) for k in e)}
    check(captures == 1 and gaps == BITWISE and row["metrics_bitwise"],
          f"captured vs eager burst from one state: {row}")
    if eager_twice:
        row["eager_vs_eager"] = _learner_gaps(eager, run(True)[0])
        check(row["eager_vs_eager"] == BITWISE,
              f"two eager bursts from one state on the package's cuDNN setting: {row}")
    if with_default_cudnn:
        with default_cudnn():
            row["eager_vs_eager_default_cudnn"] = _learner_gaps(run(True)[0], run(True)[0])
            row["one_update_default_cudnn"] = one_update_default_cudnn(make_sac, state, ring,
                                                                       chunks)
    return row


def cudnn_cost(make_sac, state, ring, chunk, per: int, n_bursts: int = 4) -> dict:
    """Captured-burst gradient steps per second on the package's cuDNN
    setting against cuDNN's default algorithms, from clones of one state:
    each run captures its own graph (cuDNN picks its algorithms at the
    capture) and times ``n_bursts`` bursts of ``per`` updates, in the
    order package, default, default, package; each setting reports the
    mean of its two runs."""
    def rate(default: bool) -> float:
        with default_cudnn() if default else contextlib.nullcontext():
            sac, st, buf = make_sac(), state.clone(), ring.clone()
            st, buf, _ = sac.update_burst(st, buf, chunk, per)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_bursts):
                st, buf, _ = sac.update_burst(st, buf, chunk, per)
            torch.cuda.synchronize()
            return n_bursts * per / (time.perf_counter() - t0)

    runs = {"package": [], "default": []}
    for name in ("package", "default", "default", "package"):
        runs[name].append(rate(name == "default"))
    out = {f"{k}_grad_steps_per_sec": statistics.mean(v) for k, v in runs.items()}
    out["package_over_default"] = (out["package_grad_steps_per_sec"]
                                   / out["default_grad_steps_per_sec"])
    return {**out, "runs": runs, "updates_per_burst": per}


def one_update_default_cudnn(make_sac, state, ring, chunks) -> dict:
    """The captured update on cuDNN's default algorithms, where it is not
    bitwise run to run: from a clone of one state, a 1-update burst
    (the warm-up and the capture), then from one state one replay
    against one eager update on the same chunk. Held to the limits of
    the repo's one-update check of two summation orders (the
    kernel-vs-plain update): parameters 1e-4, log α 1e-6, every metric
    1e-4·max(1, |eager|), Adam moments 1e-4·max(1, max|eager|) per
    tensor; the generator and step exactly."""
    sac, st, buf = make_sac(), state.clone(), ring.clone()
    st, buf, _ = sac.update_burst(st, buf, chunks[0], 1)
    twin, twin_buf = st.clone(), buf.clone()
    st, buf, m_graph = sac.update_burst(st, buf, chunks[1], 1)
    twin, twin_buf, m_eager = sac.update_burst(twin, twin_buf, chunks[1], 1, eager=True)
    torch.cuda.synchronize()
    gaps = _learner_gaps(st, twin)
    moments = max(
        ((x[k] - y[k]).abs().max() / y[k].abs().max().clamp(min=1.0)).item()
        for opt in ("pi_opt", "q_opt", "alpha_opt")
        for p, q in zip(*([p for g in getattr(s, opt).param_groups for p in g["params"]]
                          for s in (st, twin)), strict=True)
        for x, y in [(getattr(st, opt).state[p], getattr(twin, opt).state[q])]
        for k in ("exp_avg", "exp_avg_sq") if k in y)
    metrics = max(((m_graph[k] - m_eager[k]).abs() / m_eager[k].abs().clamp(min=1.0)).max().item()
                  for k in m_eager)
    row = {**gaps, "adam_moments_rel": moments, "metrics_rel": metrics,
           "captures": sac.graph_captures}
    check(row["captures"] == 1 and gaps["params"] <= 1e-4 and gaps["log_alpha"] <= 1e-6
          and moments <= 1e-4 and metrics <= 1e-4 and gaps["same_generator"]
          and gaps["same_step"], f"one captured update on cuDNN's default algorithms: {row}")
    return row


def burst_modes(kernels, burst, per: int, n_bursts: int, per_update: dict) -> dict:
    """The captured (default) and the eager burst of one workload, in
    turn: one burst to warm up (the captured one captures there unless
    it has a graph), ``n_bursts`` timed (host clock to a synchronize),
    then one profiled burst: device kernels, busy and idle per update,
    and exactly ``per_update`` launches of each named kernel per update
    in its device trace. The wrappers count those launches in the eager
    mode and none in the captured one (a replay calls no wrapper)."""
    out = {}
    for mode, eager in (("captured", False), ("eager", True)):
        burst(eager)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(n_bursts):
            m = burst(eager)
        torch.cuda.synchronize()
        burst_s = (time.perf_counter() - t0) / n_bursts
        wrapped = {k: kernels.launch_counts.get(k, 0) / (per * n_bursts) for k in per_update}
        want = per_update if eager else dict.fromkeys(per_update, 0)
        check(wrapped == want, f"{mode} burst: wrapper launches per update {wrapped} != {want}")
        check(all(math.isfinite(float(v)) for v in m.values()), f"{mode} burst metrics not finite")
        profiled = profile_burst(lambda: burst(eager), per)
        got = {k: profiled["launches_per_update"][k] for k in per_update}
        check(got == per_update,
              f"{mode} burst: device launches per update {got} != {per_update}")
        busy_ms = profiled["device_busy_ms"] / per
        out[mode] = {
            "burst_ms": burst_s * 1e3, "grad_steps_per_sec": per / burst_s,
            "launches_per_update": got, "wrapper_launches_per_update": wrapped,
            "device_kernels_per_update": profiled["device_kernels_per_update"],
            "device_busy_ms_per_update": busy_ms,
            "device_idle_share": profiled["device_idle_share"],
            # the profiled burst's busy time against the unprofiled bursts'
            # wall time (the profiler slows the host)
            "device_idle_share_timed": 1.0 - busy_ms * per / (burst_s * 1e3),
            "profiled_burst": profiled,
        }
    return out


def adam_step_kernels(module) -> dict:
    """Device kernels of one foreach Adam step over copies of
    ``module``'s parameters (random gradients in their strides): plain,
    as the CPU runs it, and capturable, as the card runs it."""
    out = {"tensors": len(list(module.parameters()))}
    for label, capturable in (("plain", False), ("capturable", True)):
        params = [p.detach().clone().requires_grad_(True) for p in module.parameters()]
        for p in params:
            p.grad = torch.randn_like(p)
        opt = torch.optim.Adam(params, lr=1e-4, foreach=True, capturable=capturable)
        out[label] = kernels_per_call(opt.step)
    return out


def phase_graph_push(seed: int) -> dict:
    """A replay after a push samples the grown ring: every transition is
    terminal, so an update's mean backup is its batch's mean reward, 0 on
    the ring's first 128 rows and 1 on the 1920 pushed after the capture.
    A graph that froze the size at capture would draw none of them
    (``backup_mean`` exactly 0); the expected share is 1920/2048. A flat
    learner at SACConfig's widths on Pendulum's dimensions."""
    from torch_actor_critic_tpu_torch.buffer.replay import init_replay_buffer, push
    from torch_actor_critic_tpu_torch.core.types import Batch
    from torch_actor_critic_tpu_torch.models import build_models
    from torch_actor_critic_tpu_torch.sac.algorithm import SAC
    from torch_actor_critic_tpu_torch.utils.config import SACConfig

    cfg = SACConfig()
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    actor, critic = build_models(cfg, (3,), 1, 2.0, generator=torch.Generator().manual_seed(seed))
    sac = SAC(cfg, 1)
    state = sac.init_state(actor.cuda(), critic.cuda(),
                           torch.Generator(device="cuda").manual_seed(seed + 1))

    def chunk(n, reward):
        return Batch(states=torch.randn((n, 3), generator=gen, device="cuda"),
                     actions=torch.rand((n, 1), generator=gen, device="cuda") * 4 - 2,
                     rewards=torch.full((n,), reward, device="cuda"),
                     next_states=torch.randn((n, 3), generator=gen, device="cuda"),
                     done=torch.ones(n, device="cuda"))

    ring = push(init_replay_buffer(4096, (3,), 1, "cuda"), chunk(64, 0.0))
    state, ring, first = sac.update_burst(state, ring, chunk(64, 0.0), 8)
    state, ring, grown = sac.update_burst(state, ring, chunk(1920, 1.0), 8)
    row = {"phase": "graph_push", "size_at_capture": 128, "size_after_push": ring.size,
           "captures": sac.graph_captures, "backup_mean_at_capture": float(first["backup_mean"]),
           "backup_mean_after_push": float(grown["backup_mean"]), "expected": 1920 / 2048}
    check(row["captures"] == 1 and ring.size == 2048 and row["backup_mean_at_capture"] == 0.0
          and 0.85 < row["backup_mean_after_push"] <= 1.0,
          f"a replay after a push did not sample the grown ring: {row}")
    emit(row)
    return row


def phase_train_visual(seed: int, kernels) -> dict:
    """Train the pixel recipe's visual policy through train.py's own path
    on the numpy pixel pendulum; returns the kernels' launch counts of
    that run."""
    from torch_actor_critic_tpu_torch import train as train_cli
    from torch_actor_critic_tpu_torch.buffer.replay import sample, sample_fused_visual
    from torch_actor_critic_tpu_torch.core.types import Batch, MultiObservation
    from torch_actor_critic_tpu_torch.ops.augment import shift_offsets
    from torch_actor_critic_tpu_torch.ops.pixels import gather_frames_reference
    from torch_actor_critic_tpu_torch.sac.algorithm import SAC
    from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer

    runs = tempfile.mkdtemp(prefix="tac_chip_train_visual_")
    try:
        args = train_cli.parse_arguments([
            *VISUAL_ARGS, "--device", "cuda", "--seed", str(seed), "--epochs", "1",
            "--steps-per-epoch", "2000", "--start-steps", "1000", "--update-after", "1000",
            "--buffer-size", "24000", "--runs-root", runs,
        ])

        def drive():
            trainer, _ = train_cli.build_trainer(args)
            check(trainer.buffer.data.states.frame.dtype == torch.uint8,
                  "visual ring is not uint8")
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            metrics = trainer.train(
                on_epoch=lambda e, m: emit({"phase": "train_visual_epoch", "epoch": e, **m}))
            torch.cuda.synchronize()
            return trainer, metrics, time.perf_counter() - t0, dict(kernels.launch_counts)

        # The main path, traced, as for the sequence policy.
        (trainer, metrics, train_s, wrapped), launches = traced(
            drive, "train_visual", discard=lambda out: out[0].close())
        cfg = trainer.config
        for key in ("loss_q", "loss_pi", "reward"):
            check(math.isfinite(metrics[key]), f"train_visual: {key} = {metrics[key]}")
        updates = trainer.state.step
        check(updates == 1000, f"train_visual: {updates} gradient steps, expected 1000")
        check(wrapped.get("pixel_gather", 0) > 0, "train_visual: K1 never launched by its wrapper")
        check(launches["pixel_gather"] == updates,
              f"train_visual: pixel_gather ran {launches['pixel_gather']} times on the "
              f"device, expected 1 per update ({updates})")
        check_through_graphs("train_visual", launches, wrapped, {"pixel_gather": 1}, updates,
                             trainer.sac.graph_captures)

        restored, meta = Checkpointer(trainer.checkpointer.directory).restore_actor_params()
        live = trainer.state.actor.state_dict()
        check(all(torch.equal(restored[k], live[k].cpu()) for k in live),
              "train_visual: checkpoint does not restore the trained actor")

        # One state, one batch: its frames from K1 and from the plain gather.
        gen = torch.Generator(device="cuda").manual_seed(seed + 6)
        b, buf = cfg.batch_size, trainer.buffer
        idx = torch.randint(0, buf.size, (b,), generator=gen, device="cuda")
        offsets = torch.stack([shift_offsets(b, cfg.augment_pad, gen, "cuda") for _ in range(2)])
        kernels.reset_launch_counts()
        with_kernel = sample_fused_visual(
            buf, b, cfg.model_dtype, cfg.frame_augment, cfg.augment_pad,
            cfg.normalize_pixels, indices=idx, offsets=offsets)
        check(kernels.launch_counts["pixel_gather"] == 1, "fused sample: not 1 K1 launch")
        frames = [
            gather_frames_reference(ring, idx, offs, cfg.augment_pad, cfg.normalize_pixels,
                                    cfg.model_dtype)
            for ring, offs in ((buf.data.states.frame, offsets[0]),
                               (buf.data.next_states.frame, offsets[1]))
        ]
        with_plain = Batch(
            states=MultiObservation(with_kernel.states.features, frames[0]),
            actions=with_kernel.actions, rewards=with_kernel.rewards,
            next_states=MultiObservation(with_kernel.next_states.features, frames[1]),
            done=with_kernel.done)
        check(torch.equal(with_kernel.states.frame, frames[0])
              and torch.equal(with_kernel.next_states.frame, frames[1]),
              "train_visual: K1 frames != plain gather frames")
        act_dim = trainer.pool.act_dim
        eps_q, eps_pi = (torch.randn((b, act_dim), generator=gen, device="cuda")
                         for _ in range(2))
        st_k, st_p = _visual_replica(trainer, gen), _visual_replica(trainer, gen)
        grads_k = _sac_grads(st_k, cfg, with_kernel, eps_q, eps_pi)
        grads_p = _sac_grads(st_p, cfg, with_plain, eps_q, eps_pi)
        grad_gaps = {}
        for part in ("critic", "actor"):
            gap = max((x - y).abs().max().item() for x, y in zip(grads_k[part], grads_p[part]))
            lim = 1e-4 * max(1.0, max(y.abs().max().item() for y in grads_p[part]))
            check(gap <= lim, f"train_visual: K1 vs plain {part} gradients: {gap} > {lim}")
            grad_gaps[part] = {"max_gap": gap, "limit": lim}
        trainer.sac.update(st_k, with_kernel, eps_q=eps_q, eps_pi=eps_pi)
        trainer.sac.update(st_p, with_plain, eps_q=eps_q, eps_pi=eps_pi)
        gaps = {part: _param_gap(getattr(st_k, part), getattr(st_p, part))[0]
                for part in ("actor", "critic", "target_critic")}
        worst = max(gaps.values())
        check(worst <= 1e-4, f"train_visual: K1 vs plain update: param gap {worst}")
        alpha_gap = abs(st_k.log_alpha.item() - st_p.log_alpha.item())
        check(alpha_gap <= 1e-6, f"train_visual: log_alpha gap {alpha_gap}")
        with torch.no_grad():
            a_k, _ = st_k.actor(with_kernel.states, deterministic=True)
            a_p, _ = st_p.actor(with_plain.states, deterministic=True)
            q_k = st_k.critic(with_kernel.states, with_kernel.actions)
            q_p = st_p.critic(with_plain.states, with_plain.actions)
        out_gap = max((a_k - a_p).abs().max().item(), (q_k - q_p).abs().max().item())
        check(out_gap <= 1e-4, f"train_visual: K1 vs plain update: output gap {out_gap}")
        del st_k, st_p, grads_k, grads_p

        # From one cloned state, the captured burst against the eager one;
        # then each mode's bursts alone (1 K1 launch per update), timed
        # and profiled.
        per = cfg.updates_per_window
        same = compare_bursts(
            lambda: SAC(cfg, act_dim), trainer.state, trainer.buffer,
            [sample(buf, cfg.update_every, generator=gen) for _ in range(2)], per,
            eager_twice=True)
        chunk = sample(buf, cfg.update_every, generator=gen)

        def burst(eager):
            trainer.state, trainer.buffer, m = trainer.sac.update_burst(
                trainer.state, trainer.buffer, chunk, per, eager=eager)
            return m

        cost = cudnn_cost(lambda: SAC(cfg, act_dim), trainer.state, trainer.buffer, chunk, per)
        modes = burst_modes(kernels, burst, per, 4, {"pixel_gather": 1})
        check(trainer.sac.graph_captures == 1,
              f"train_visual: {trainer.sac.graph_captures} captures, expected 1")
        captured = modes["captured"]
        adam = {part: adam_parity(getattr(trainer.state, part), getattr(trainer.state, opt),
                                  cfg.lr, gen)
                for part, opt in (("actor", "pi_opt"), ("critic", "q_opt"))}

        obs = trainer.pool.reset_all([seed])
        t0 = time.perf_counter()
        for _ in range(200):
            obs, *_ = trainer.pool.step(trainer._policy_actions(obs))
        act_steps_per_s = 200 / (time.perf_counter() - t0)
        trainer.close()
        emit({
            "phase": "train_visual", "env": VISUAL_ENV, "args": VISUAL_ARGS, "config": {
                "filters": cfg.filters, "kernel_sizes": cfg.kernel_sizes,
                "strides": cfg.strides, "cnn_dense_size": cfg.cnn_dense_size,
                "cnn_features": cfg.cnn_features, "hidden_sizes": cfg.hidden_sizes,
                "batch_size": cfg.batch_size, "buffer_size": cfg.buffer_size,
                "steps": cfg.steps_per_epoch, "start_steps": cfg.start_steps,
            },
            "train_wall_s": train_s, "gradient_steps": updates,
            "epoch_grad_steps_per_sec": metrics["grad_steps_per_sec"],
            "epoch_env_steps_per_sec": metrics["env_steps_per_sec"],
            "launches": launches, "wrapper_launches": wrapped,
            "pixel_gather_per_update": launches["pixel_gather"] / updates,
            "kernel_vs_plain_update": {
                "max_param_gap": worst, "log_alpha_gap": alpha_gap,
                "max_output_gap": out_gap, "gradients": grad_gaps, "by_module": gaps,
            },
            "checkpoint_epoch": meta["epoch"],
            "burst_ms": captured["burst_ms"],
            "burst_grad_steps_per_sec": captured["grad_steps_per_sec"],
            "device_kernels_per_update": captured["device_kernels_per_update"],
            "device_idle_share": captured["device_idle_share"],
            "graph_captures": trainer.sac.graph_captures, "captured_vs_eager": same,
            "cudnn_cost": cost, "bursts": modes, "adam_capturable_vs_plain": adam,
            "acting_env_steps_per_sec": act_steps_per_s,
        })
        return launches
    finally:
        shutil.rmtree(runs, ignore_errors=True)


def phase_visual_burst(seed: int, kernels) -> list:
    """Fused-pipeline bursts at the repo's full visual width: SACConfig's
    default visual widths (Atari trunk 32/64/64, kernels 8/4/3, strides
    4/2/1, Dense 512, cnn_features 1) on the wall-runner geometry (168
    features, 64x64x3 frame, act_dim 56), synthetic transitions as
    bench.py's bench_visual makes them (the card's machine has no
    dm_control). B 32 f32 as bench_visual runs it; B 512 bf16 with the
    shift and /255."""
    from torch_actor_critic_tpu_torch.buffer.replay import init_visual_replay_buffer, push
    from torch_actor_critic_tpu_torch.core.types import Batch, MultiObservation
    from torch_actor_critic_tpu_torch.models import build_models
    from torch_actor_critic_tpu_torch.sac.algorithm import SAC
    from torch_actor_critic_tpu_torch.utils.config import SACConfig

    gen = torch.Generator(device="cuda").manual_seed(seed + 7)

    def chunk(n):
        def obs():
            return MultiObservation(
                torch.randn((n, WALL_FEATURES), generator=gen, device="cuda"),
                torch.randint(0, 256, (n, *WALL_FRAME), generator=gen, device="cuda",
                              dtype=torch.uint8))
        return Batch(
            states=obs(),
            actions=torch.tanh(torch.randn((n, WALL_ACT_DIM), generator=gen, device="cuda")),
            rewards=torch.randn(n, generator=gen, device="cuda"), next_states=obs(),
            done=torch.zeros(n, device="cuda"))

    rows = []
    burst_len, n_bursts = 25, 3
    for bsz, dtype, augment, normalize in ((32, "float32", "none", False),
                                           (512, "bfloat16", "shift", True)):
        cfg = SACConfig(batch_size=bsz, compute_dtype=dtype, pixel_pipeline="fused",
                        frame_augment=augment, normalize_pixels=normalize)
        shape = MultiObservation((WALL_FEATURES,), WALL_FRAME)
        actor, critic = build_models(cfg, shape, WALL_ACT_DIM, 1.0,
                                     generator=torch.Generator().manual_seed(seed))
        sac = SAC(cfg, WALL_ACT_DIM)
        state = sac.init_state(actor.cuda(), critic.cuda(),
                               torch.Generator(device="cuda").manual_seed(seed + 1))
        buf = push(init_visual_replay_buffer(20000, WALL_FEATURES, WALL_FRAME,
                                             WALL_ACT_DIM, "cuda"), chunk(2000))
        same = compare_bursts(lambda: SAC(cfg, WALL_ACT_DIM), state, buf,
                              [chunk(burst_len) for _ in range(2)], burst_len,
                              eager_twice=True, with_default_cudnn=bsz == 32)
        cost = cudnn_cost(lambda: SAC(cfg, WALL_ACT_DIM), state, buf, chunk(burst_len),
                          burst_len)
        chunks = [chunk(burst_len) for _ in range(8)]
        turn = iter(range(10 ** 9))

        def burst(eager):
            nonlocal state, buf
            state, buf, m = sac.update_burst(state, buf, chunks[next(turn) % len(chunks)],
                                             burst_len, eager=eager)
            return m

        # Each mode: one burst to warm up (cuDNN picks its algorithms; the
        # graph is captured), then timed bursts and one profiled.
        modes = burst_modes(kernels, burst, burst_len, n_bursts, {"pixel_gather": 1})
        captured = modes["captured"]
        check(sac.graph_captures == 1, f"visual_burst B{bsz}: {sac.graph_captures} captures")
        row = {
            "phase": "visual_burst", "batch": bsz, "dtype": dtype, "frame_augment": augment,
            "normalize_pixels": normalize, "features": WALL_FEATURES,
            "frame": list(WALL_FRAME), "act_dim": WALL_ACT_DIM, "widths": {
                "filters": cfg.filters, "kernel_sizes": cfg.kernel_sizes,
                "strides": cfg.strides, "cnn_dense_size": cfg.cnn_dense_size,
                "cnn_features": cfg.cnn_features, "hidden_sizes": cfg.hidden_sizes,
            },
            "burst_updates": burst_len, "burst_ms": captured["burst_ms"],
            "grad_steps_per_sec": captured["grad_steps_per_sec"],
            "device_kernels_per_update": captured["device_kernels_per_update"],
            "device_idle_share": captured["device_idle_share"],
            "graph_captures": sac.graph_captures, "captured_vs_eager": same,
            "cudnn_cost": cost, "bursts": modes,
        }
        emit(row)
        rows.append(row)
        del state, buf, chunks, actor, critic
        torch.cuda.empty_cache()
    return rows


# The resume phase's runs: the README's sequence policy at SACConfig's widths,
# 200-step epochs, 50-step update windows (50-update captured bursts).
RESUME_ARGS = [
    "--environment", TRAIN_ENV, "--history-len", "16", "--device", "cuda",
    "--epochs", "3", "--steps-per-epoch", "200", "--start-steps", "100",
    "--update-after", "100", "--update-every", "50", "--save-every", "10",
]


def learner_snapshot(trainer) -> dict:
    """Every leaf that defines a run's state, on the host: the learner
    (parameters, target, the three Adam states with their steps, log α,
    the step count, the learner generator), the ring's rows, ``ptr``,
    ``size`` and device size, and the acting generator."""
    return {"state": trainer.state.state_dict(), "buffer": trainer.buffer.state_dict(),
            "device_size": int(trainer.buffer.device_size),
            "act": trainer._act_gen.get_state()}


def bitwise_diff(a, b, path="") -> list:
    """The paths at which two snapshots differ (tensors by ``torch.equal``
    and dtype, everything else by ``==``)."""
    if isinstance(a, torch.Tensor):
        same = (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a.cpu(), b.cpu()))
        return [] if same else [path]
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            return [path]
        return [d for k in a for d in bitwise_diff(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [path]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in bitwise_diff(x, y, f"{path}/{i}")]
    return [] if a == b else [path]


def phase_resume(seed: int, kernels, smi: str) -> dict:
    """Full-state checkpoint, resume, rollback and preemption on the card,
    under captured bursts, through the train CLI's ``build_trainer``:

    A. 3 epochs, uninterrupted;
    B. the same seed with a ``PreemptionGuard`` installed and a real
       SIGTERM sent by ``FaultyEnvPool.call_at`` at step 250 (epoch 1):
       ``Preempted``, exit code 75, the checkpoint at epoch 1, step 400;
    C. a fresh ``Trainer`` on B's checkpoints: ``restore()`` returns 2,
       one epoch, traced; every leaf equal to A's to the bit (parameters,
       target, Adam moments and steps, log α, step, both generators, the
       ring, ptr, size, device size), one capture in A and in C, and
       K2/K3/K4 launches per update from the device trace
       (``check_through_graphs``);
    D. ``save_every`` 1 and a NaN reward at step 450 (epoch 2), 4 epochs:
       one rollback; right after it the state equals the epoch-1
       checkpoint on disk to the bit, no new capture, and one captured
       burst from it (replays of the graph captured before the rollback)
       equals one eager burst from its clone to the bit; finite final
       metrics;
    visual: the pixel recipe, 2 epochs of 200 steps against 1 + resume +
       1, on cuDNN's deterministic algorithms, bitwise; the resumed run
       traced, exactly 1 K1 launch per update;
    card to CPU: C's checkpoint restored into a CPU trainer: parameters,
       target, Adam moments and steps, log α and the ring exactly C's;
    run_agent: the evaluation CLI twice on C's run (``--episodes 2 --seed
       0``, on the card), one identical, finite JSON line each.

    Returns the kernels' launch counts of C's and the visual resume's
    runs (the wrappers set to 0 just before each, the device traces read
    just after)."""
    import os
    import signal
    from pathlib import Path

    from torch_actor_critic_tpu_torch import train as train_cli
    from torch_actor_critic_tpu_torch.buffer.replay import sample
    from torch_actor_critic_tpu_torch.resilience import Preempted, PreemptionGuard
    from torch_actor_critic_tpu_torch.resilience.faultinject import FaultyEnvPool
    from torch_actor_critic_tpu_torch.sac.algorithm import SAC
    from torch_actor_critic_tpu_torch.sac.trainer import Trainer
    from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer

    runs = tempfile.mkdtemp(prefix="tac_chip_resume_")
    row = {"phase": "resume", "card": smi}
    try:
        def cli_args(*extra):
            return train_cli.parse_arguments([*RESUME_ARGS, "--seed", str(seed),
                                              "--runs-root", runs, *extra])

        def fresh(config, directory, device="cuda", epochs=1):
            return Trainer(TRAIN_ENV, config.replace(epochs=epochs),
                           checkpointer=Checkpointer(directory), seed=seed, device=device)

        # A: uninterrupted.
        epochs_a = []
        a, _ = train_cli.build_trainer(cli_args())
        a.train(on_epoch=lambda e, m: epochs_a.append(m))
        torch.cuda.synchronize()
        ref, captures_a, cfg = learner_snapshot(a), a.sac.graph_captures, a.config
        act_dim = a.pool.act_dim
        a.close()
        check(captures_a == 1, f"resume A: {captures_a} captures, expected 1")

        # B: a real SIGTERM inside epoch 1.
        guard = PreemptionGuard()
        b, tracker_b = train_cli.build_trainer(cli_args(), preemption=guard)
        b.pool = FaultyEnvPool(b.pool).call_at(250, lambda: os.kill(os.getpid(), signal.SIGTERM))
        preempted = None
        guard.install()
        try:
            b.train()
        except Preempted as p:
            preempted = p
        finally:
            guard.uninstall()
            b.close()
        check(preempted is not None and preempted.epoch == 1 and not preempted.urgent
              and preempted.exit_code == 75, f"resume B: preempted {preempted!r}")
        directory = b.checkpointer.directory
        meta = b.checkpointer.peek_meta()
        check((meta["epoch"], meta["step"]) == (1, 400), f"resume B: meta {meta}")
        ckpt_bytes = {f.name: f.stat().st_size for f in (directory / "epoch_1").iterdir()}

        # C: a fresh trainer on B's checkpoints, one epoch, traced (a
        # retaken trace starts again from the restore).
        def drive():
            c = fresh(cfg, directory)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start = c.restore()
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            restored_step = c.state.step
            kernels.reset_launch_counts()
            metrics = c.train()
            torch.cuda.synchronize()
            return c, metrics, dict(kernels.launch_counts), start, restore_s, restored_step

        def discard(out):  # a lost trace: its epoch-2 save goes with it
            out[0].close()
            shutil.rmtree(directory / "epoch_2")

        (c, metrics_c, wrapped, start, restore_s, restored_step), launches = traced(
            drive, "resume", discard=discard)
        check(start == 2 and c._resume_step == 400, f"resume C: restore() -> {start}")
        updates = c.state.step - restored_step
        diff = bitwise_diff(ref, learner_snapshot(c))
        check(not diff, f"resume C differs from A at {diff[:8]}")
        check(c.sac.graph_captures == 1, f"resume C: {c.sac.graph_captures} captures")
        check(all(math.isfinite(metrics_c[k]) for k in ("loss_q", "loss_pi")),
              f"resume C: metrics {metrics_c}")
        per_update = {"flash_fwd": 5 * cfg.seq_num_layers, "flash_bwd_dq": 2 * cfg.seq_num_layers,
                      "flash_bwd_dkv": 2 * cfg.seq_num_layers}
        check_through_graphs("resume", launches, wrapped, per_update, updates,
                             c.sac.graph_captures)
        row.update({
            "resumed_epoch": start, "resumed_step": c._resume_step, "updates": updates,
            "bitwise_vs_uninterrupted": True, "graph_captures": [captures_a, c.sac.graph_captures],
            "launches": launches, "wrapper_launches": wrapped,
            "save_s": epochs_a[-1]["save_s"], "save_s_epoch0": epochs_a[0]["save_s"],
            "sentinel_s": [m["sentinel_s"] for m in epochs_a],
            "restore_s": restore_s, "checkpoint_bytes": ckpt_bytes,
        })

        # Card to CPU: C's checkpoint (epoch 2) into a CPU trainer.
        host = fresh(cfg, directory, device="cpu")
        check(host.restore() == 3, "card to CPU: restore() != 3")
        def exact_part(st):
            # The networks, Adam moments and steps, log α and the step count:
            # not the generator (each device has its own kind) nor Adam's
            # hyperparameters (capturable on the card only).
            full = st.state_dict()
            return {**{k: full[k] for k in ("step", "actor", "critic", "target_critic",
                                            "log_alpha")},
                    **{k: full[k]["state"] for k in ("pi_opt", "q_opt", "alpha_opt")}}

        diff = bitwise_diff(exact_part(c.state), exact_part(host.state))
        diff += bitwise_diff(c.buffer.state_dict(), host.buffer.state_dict(), "/buffer")
        check(not diff, f"card to CPU restore differs at {diff[:8]}")
        steps = {str(s["step"].device) for o in ("pi_opt", "q_opt")
                 for s in getattr(host.state, o).state.values()}
        host.close()
        c.close()
        row["card_to_cpu"] = {"exact": True, "adam_step_devices_on_cpu": sorted(steps)}

        # run_agent on C's run, twice, on the card.
        evals = []
        for _ in range(2):
            res = subprocess.run(
                [sys.executable, "-m", "torch_actor_critic_tpu_torch.run_agent",
                 "--run", tracker_b.run_id, "--runs-root", runs, "--episodes", "2",
                 "--seed", "0"],
                cwd=str(Path(__file__).resolve().parent), capture_output=True, text=True,
                timeout=300)
            check(res.returncode == 0, f"run_agent exited {res.returncode}: {res.stderr[-2000:]}")
            evals.append(res.stdout.strip().splitlines()[-1])
        out = json.loads(evals[0])
        check(evals[0] == evals[1] and all(math.isfinite(v) for v in out.values()),
              f"run_agent: {evals}")
        row["run_agent"] = out

        # D: a NaN reward in epoch 2, rolled back in place to epoch 1.
        runs_d = tempfile.mkdtemp(prefix="tac_chip_rollback_", dir=runs)
        d, _ = train_cli.build_trainer(train_cli.parse_arguments([
            *RESUME_ARGS, "--seed", str(seed), "--runs-root", runs_d, "--epochs", "4",
            "--save-every", "1"]))
        d.pool = FaultyEnvPool(d.pool).nan_rewards_at(450)
        rollback = d._rollback
        seen = {}

        def checked_rollback():
            before = d.sac.graph_captures
            epoch = rollback()
            torch.cuda.synchronize()
            on_disk = d.checkpointer.directory / f"epoch_{epoch}"
            saved = {"state": torch.load(on_disk / "state.pt", weights_only=True),
                     "buffer": torch.load(on_disk / "buffer.pt", weights_only=True)}
            live = {"state": d.state.state_dict(), "buffer": d.buffer.state_dict()}
            seen["epoch"], seen["diff"] = epoch, bitwise_diff(saved, live)
            seen["device_size"] = int(d.buffer.device_size) == saved["buffer"]["size"]
            # One burst through the graph captured before the rollback, on
            # the restored tensors, against one eager burst from a clone.
            gen = torch.Generator(device="cuda").manual_seed(seed + 9)
            chunk = sample(d.buffer, cfg.update_every, generator=gen)
            twin, twin_ring = d.state.clone(), d.buffer.clone()
            graph = d.sac.graph
            d.state, d.buffer, m_graph = d.sac.update_burst(
                d.state, d.buffer, chunk, cfg.updates_per_window)
            twin, twin_ring, m_eager = SAC(cfg, act_dim).update_burst(
                twin, twin_ring, chunk, cfg.updates_per_window, eager=True)
            torch.cuda.synchronize()
            seen["same_graph"] = d.sac.graph is graph
            seen["burst"] = {**_learner_gaps(d.state, twin), "metrics_bitwise": all(
                torch.equal(m_graph[k], m_eager[k]) for k in m_eager)}
            seen["captures"] = (before, d.sac.graph_captures)
            rollback()  # back to the checkpoint: training goes on from it
            return epoch

        d._rollback = checked_rollback
        metrics_d = d.train()
        torch.cuda.synchronize()
        check(d.sentinel.total_rollbacks == 1 and metrics_d["rollbacks"] == 1,
              f"rollback D: {d.sentinel.total_rollbacks} rollbacks")
        check(seen["epoch"] == 1 and not seen["diff"] and seen["device_size"],
              f"rollback D: the rolled-back state differs from epoch 1 at {seen['diff'][:8]}")
        check(seen["captures"] == (1, 1) and seen["same_graph"] and d.sac.graph_captures == 1,
              f"rollback D: captures {seen['captures']}, then {d.sac.graph_captures}")
        burst = seen["burst"]
        check(burst.pop("metrics_bitwise") and burst == BITWISE,
              f"rollback D: captured vs eager burst {burst}")
        check(all(math.isfinite(metrics_d[k]) for k in ("loss_q", "loss_pi", "reward")),
              f"rollback D: final metrics {metrics_d}")
        d.close()
        row["rollback"] = {"rolled_to": seen["epoch"], "bitwise_vs_checkpoint": True,
                           "captures": d.sac.graph_captures, "burst_vs_eager": BITWISE,
                           "final_loss_q": metrics_d["loss_q"]}

        row["visual"], visual_launches = _visual_resume(seed, kernels, runs)
        emit(row)
        return {**launches, "pixel_gather": visual_launches["pixel_gather"]}
    finally:
        shutil.rmtree(runs, ignore_errors=True)


def _visual_resume(seed: int, kernels, runs: str):
    """The pixel recipe, 2 epochs of 200 steps uninterrupted against 1
    epoch, a fresh trainer's ``restore()`` and 1 more (traced), on the
    package's cuDNN setting: bitwise, 1 K1 launch per update."""
    from torch_actor_critic_tpu_torch import train as train_cli
    from torch_actor_critic_tpu_torch.sac.trainer import Trainer
    from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer

    def build(epochs):
        args = train_cli.parse_arguments([
            *VISUAL_ARGS, "--device", "cuda", "--seed", str(seed), "--epochs", str(epochs),
            "--steps-per-epoch", "200", "--start-steps", "100", "--update-after", "100",
            "--update-every", "50", "--buffer-size", "24000", "--runs-root", runs])
        return train_cli.build_trainer(args)[0]

    cudnn = package_cudnn()
    whole = build(2)
    whole.train()
    torch.cuda.synchronize()
    ref = learner_snapshot(whole)
    whole.close()
    first = build(1)
    first.train()
    first.close()
    cfg, directory = first.config, first.checkpointer.directory

    def drive():
        resumed = Trainer(VISUAL_ENV, cfg, checkpointer=Checkpointer(directory),
                          seed=seed, device="cuda")
        start = resumed.restore()
        restored_step = resumed.state.step
        kernels.reset_launch_counts()
        resumed.train()
        torch.cuda.synchronize()
        return resumed, start, restored_step, dict(kernels.launch_counts)

    def discard(out):  # a lost trace: its epoch-1 save goes with it
        out[0].close()
        shutil.rmtree(directory / "epoch_1")

    (resumed, start, restored_step, wrapped), launches = traced(
        drive, "visual resume", discard=discard)
    check(start == 1, f"visual resume: restore() -> {start}")
    updates = resumed.state.step - restored_step
    diff = bitwise_diff(ref, learner_snapshot(resumed))
    check(not diff, f"visual resume differs from the uninterrupted run at {diff[:8]}")
    check(launches["pixel_gather"] == updates,
          f"visual resume: {launches['pixel_gather']} K1 launches for {updates} updates")
    check_through_graphs("visual resume", launches, wrapped, {"pixel_gather": 1}, updates,
                         resumed.sac.graph_captures)
    captures = resumed.sac.graph_captures
    resumed.close()
    return ({"bitwise_vs_uninterrupted": True, "cudnn": cudnn, "updates": updates,
             "pixel_gather_per_update": launches["pixel_gather"] / updates,
             "graph_captures": captures}, launches)


# The train_td3 phase's runs: SACConfig's defaults (hidden 256,256, batch 64,
# policy_delay 2) with TD3 on the flat pendulum, through the train CLI.
TD3_ARGS = ["--algorithm", "td3", "--environment", TRAIN_ENV, "--device", "cuda"]
# The pixel recipe's widths with TD3: learn_alpha off (TD3 has no temperature;
# the later flag wins).
TD3_VISUAL_ARGS = [*VISUAL_ARGS, "--learn-alpha", "false", "--algorithm", "td3",
                   "--device", "cuda"]


def policy_tensors(st) -> dict:
    """What a skipped TD3 update must leave bitwise: the actor, the
    capturable ``pi_opt``'s state (moments and device ``step``) and both
    targets; copies."""
    out = {f"actor.{n}": p for n, p in st.actor.named_parameters()}
    out.update({f"target_actor.{n}": p for n, p in st.target_actor.named_parameters()})
    out.update({f"target_critic.{n}": p for n, p in st.target_critic.named_parameters()})
    for i, p in enumerate(st.actor.parameters()):
        out.update({f"pi_opt.{i}.{k}": v for k, v in st.pi_opt.state[p].items()})
    return {k: v.detach().clone() for k, v in out.items()}


def skipped_replay(make_td3, state, ring, chunk) -> dict:
    """From a clone of ``state``: one-update bursts through one graph
    (the first one's warm-up runs an update eagerly and captures) up to
    a skipped step (``(device_step + 1) % delay != 0``); there one
    replayed update must leave the actor, ``pi_opt`` and both targets
    bitwise as they were and move the critic; the next applied update,
    also a replay, must move them."""
    td3, st, buf = make_td3(), state.clone(), ring.clone()
    delay = td3.config.policy_delay

    def replay(applied):
        nonlocal st, buf
        while ((int(st.device_step) + 1) % delay == 0) != applied:
            st, buf, _ = td3.update_burst(st, buf, chunk, 1)
        step = int(st.device_step)
        before, critic = policy_tensors(st), [p.detach().clone() for p in st.critic.parameters()]
        st, buf, _ = td3.update_burst(st, buf, chunk, 1)
        torch.cuda.synchronize()
        after = policy_tensors(st)
        return {"step": step, "tensors": len(before),
                "moved": sum(not torch.equal(before[k], after[k]) for k in before),
                "critic_moved": all(not torch.equal(c, p)
                                    for c, p in zip(critic, st.critic.parameters()))}

    st, buf, _ = td3.update_burst(st, buf, chunk, 1)
    row = {"skipped": replay(applied=False), "applied": replay(applied=True)}
    row["captures"] = td3.graph_captures
    check(row["skipped"]["moved"] == 0 and row["skipped"]["critic_moved"]
          and row["captures"] == 1 and row["applied"]["moved"] > 0
          and row["applied"]["critic_moved"],
          f"train_td3: a skipped replay moved the policy, or an applied one did not: {row}")
    return row


def phase_train_td3(seed: int, kernels, smi: str) -> dict:
    """TD3 on the card, through the train CLI's ``build_trainer``:

    flat — SACConfig's defaults (hidden 256,256, batch 64, policy_delay
       2) on ``PendulumNumpy-v1``, 600 steps, 500 gradient steps in
       50-update captured bursts (the run traced); then, from clones of
       the trained state and ring, captured against eager bursts to the
       bit over three 25-update bursts (the second starts on an odd
       step) and over two with policy_delay 3, one capture each; one
       replayed update at a skipped step on a clone leaves the actor,
       ``pi_opt`` and both targets bitwise, the critic moved; each burst
       mode timed and profiled, beside a SAC flat learner's;
    visual — the pixel recipe's widths (learn_alpha off) on
       ``PixelPendulumBalanceNumpy-v0``, 600 steps, 500 gradient steps,
       traced: exactly 1 K1 launch per update; captured against eager to
       the bit on cuDNN's deterministic algorithms; each burst mode;
    wall — the wall-runner geometry at B 32 f32 (SACConfig's visual
       widths), 25-update bursts in each mode, 1 K1 launch per update;
    resume — flat TD3 with 25-update windows, 2 epochs of 200 steps
       against 1 epoch, ``train --run`` and 1 more: every leaf (the
       target actor and the device step included) to the bit, one
       capture each; the checkpoint's bytes.

    Returns the kernels' launches of the traced visual run."""
    from torch_actor_critic_tpu_torch import train as train_cli
    from torch_actor_critic_tpu_torch.buffer.replay import (
        init_visual_replay_buffer,
        push,
        sample,
    )
    from torch_actor_critic_tpu_torch.core.types import Batch, MultiObservation
    from torch_actor_critic_tpu_torch.models import build_models
    from torch_actor_critic_tpu_torch.sac.algorithm import SAC
    from torch_actor_critic_tpu_torch.td3 import TD3
    from torch_actor_critic_tpu_torch.utils.config import SACConfig

    runs = tempfile.mkdtemp(prefix="tac_chip_td3_")
    row = {"phase": "train_td3", "card": smi}
    try:
        def cli(*extra):
            return train_cli.parse_arguments([*extra, "--seed", str(seed), "--runs-root", runs])

        def train(args, what, per_update):
            """One traced run of the train CLI's trainer; checks its
            losses and launches through the graphs."""
            def drive():
                trainer, tracker = train_cli.build_trainer(args)
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                metrics = trainer.train()
                torch.cuda.synchronize()
                return (trainer, tracker, metrics, time.perf_counter() - t0,
                        dict(kernels.launch_counts))

            (trainer, tracker, metrics, wall_s, wrapped), launches = traced(
                drive, what, discard=lambda out: out[0].close())
            for key in ("loss_q", "loss_pi", "reward"):
                check(math.isfinite(metrics[key]), f"{what}: {key} = {metrics[key]}")
            check(type(trainer.sac) is TD3, f"{what}: learner {type(trainer.sac).__name__}")
            updates = trainer.state.step
            check(updates == int(trainer.state.device_step) == 500,
                  f"{what}: {updates} gradient steps, device step "
                  f"{int(trainer.state.device_step)}, expected 500")
            check_through_graphs(what, launches, wrapped, per_update, updates,
                                 trainer.sac.graph_captures)
            check(trainer.sac.graph_captures == 1,
                  f"{what}: {trainer.sac.graph_captures} captures")
            return trainer, {"train_wall_s": wall_s, "gradient_steps": updates,
                             "epoch_grad_steps_per_sec": metrics["grad_steps_per_sec"],
                             "launches": launches, "wrapper_launches": wrapped,
                             "loss_q": metrics["loss_q"], "loss_pi": metrics["loss_pi"]}

        steps = ["--epochs", "1", "--steps-per-epoch", "600", "--start-steps", "100",
                 "--update-after", "100"]

        # Flat.
        flat, row["flat"] = train(cli(*TD3_ARGS, *steps), "train_td3 flat", {})
        cfg, act_dim = flat.config, flat.pool.act_dim
        gen = torch.Generator(device="cuda").manual_seed(seed + 11)
        chunks = [sample(flat.buffer, 50, generator=gen) for _ in range(3)]
        row["flat"]["captured_vs_eager"] = compare_bursts(
            lambda: TD3(cfg, act_dim), flat.state, flat.buffer, chunks, 25)
        cfg3 = cfg.replace(policy_delay=3)
        row["flat"]["captured_vs_eager_delay3"] = compare_bursts(
            lambda: TD3(cfg3, act_dim), flat.state, flat.buffer, chunks[:2], 25)
        row["flat"]["skipped_replay"] = skipped_replay(
            lambda: TD3(cfg, act_dim), flat.state, flat.buffer, chunks[0])

        def flat_burst(learner, st, buf):  # training's 50-update bursts
            def burst(eager):
                nonlocal st, buf
                st, buf, m = learner.update_burst(st, buf, chunks[0], 50, eager=eager)
                return m
            return burst

        row["flat"]["bursts"] = burst_modes(
            kernels, flat_burst(flat.sac, flat.state, flat.buffer), 50, 4, {})
        sac_actor, sac_critic = build_models(SACConfig(), (3,), act_dim, 2.0,
                                             generator=torch.Generator().manual_seed(seed))
        sac = SAC(SACConfig(), act_dim)
        sac_state = sac.init_state(sac_actor.cuda(), sac_critic.cuda(),
                                   torch.Generator(device="cuda").manual_seed(seed + 1))
        row["flat"]["sac_bursts"] = burst_modes(
            kernels, flat_burst(sac, sac_state, flat.buffer.clone()), 50, 4, {})
        check(flat.sac.graph_captures == 1 and sac.graph_captures == 1,
              f"train_td3 flat: captures {flat.sac.graph_captures}, SAC {sac.graph_captures}")
        flat.close()
        del sac_state, sac

        # Visual.
        visual, row["visual"] = train(
            cli(*TD3_VISUAL_ARGS, *steps, "--buffer-size", "24000"), "train_td3 visual",
            {"pixel_gather": 1})
        launches = row["visual"]["launches"]
        check(launches["pixel_gather"] == visual.state.step,
              f"train_td3 visual: {launches['pixel_gather']} K1 launches for "
              f"{visual.state.step} updates")
        row["visual"]["pixel_gather_per_update"] = launches["pixel_gather"] / visual.state.step
        vcfg, vact = visual.config, visual.pool.act_dim
        row["visual"]["captured_vs_eager"] = compare_bursts(
            lambda: TD3(vcfg, vact), visual.state, visual.buffer,
            [sample(visual.buffer, 50, generator=gen) for _ in range(2)], 25,
            eager_twice=True)
        vchunk = sample(visual.buffer, 50, generator=gen)

        def visual_burst(eager):
            visual.state, visual.buffer, m = visual.sac.update_burst(
                visual.state, visual.buffer, vchunk, 50, eager=eager)
            return m

        row["visual"]["bursts"] = burst_modes(kernels, visual_burst, 50, 4, {"pixel_gather": 1})
        check(visual.sac.graph_captures == 1,
              f"train_td3 visual: {visual.sac.graph_captures} captures")
        visual.close()

        # Wall-runner geometry, B 32 f32.
        wcfg = SACConfig(algorithm="td3", batch_size=32, pixel_pipeline="fused")
        shape = MultiObservation((WALL_FEATURES,), WALL_FRAME)
        actor, critic = build_models(wcfg, shape, WALL_ACT_DIM, 1.0,
                                     generator=torch.Generator().manual_seed(seed))
        wall = TD3(wcfg, WALL_ACT_DIM)
        wstate = wall.init_state(actor.cuda(), critic.cuda(),
                                 torch.Generator(device="cuda").manual_seed(seed + 1))

        def wall_chunk(n):
            def obs():
                return MultiObservation(
                    torch.randn((n, WALL_FEATURES), generator=gen, device="cuda"),
                    torch.randint(0, 256, (n, *WALL_FRAME), generator=gen, device="cuda",
                                  dtype=torch.uint8))
            return Batch(
                states=obs(), actions=torch.tanh(
                    torch.randn((n, WALL_ACT_DIM), generator=gen, device="cuda")),
                rewards=torch.randn(n, generator=gen, device="cuda"), next_states=obs(),
                done=torch.zeros(n, device="cuda"))

        wring = push(init_visual_replay_buffer(20000, WALL_FEATURES, WALL_FRAME, WALL_ACT_DIM,
                                               "cuda"), wall_chunk(2000))
        wchunk = wall_chunk(25)

        def wall_burst(eager):
            nonlocal wstate, wring
            wstate, wring, m = wall.update_burst(wstate, wring, wchunk, 25, eager=eager)
            return m

        row["wall_b32"] = {"bursts": burst_modes(kernels, wall_burst, 25, 3, {"pixel_gather": 1}),
                           "graph_captures": wall.graph_captures}
        check(wall.graph_captures == 1, f"train_td3 wall: {wall.graph_captures} captures")
        del wstate, wring, actor, critic
        torch.cuda.empty_cache()

        # Resume: 2 epochs against 1 + `train --run` + 1.
        epochs = ["--steps-per-epoch", "200", "--start-steps", "100", "--update-after", "100",
                  "--update-every", "25", "--save-every", "10"]
        whole, _ = train_cli.build_trainer(cli(*TD3_ARGS, *epochs, "--epochs", "2"))
        whole.train()
        torch.cuda.synchronize()
        ref, captures_a = learner_snapshot(whole), whole.sac.graph_captures
        whole.close()
        first, tracker = train_cli.build_trainer(cli(*TD3_ARGS, *epochs, "--epochs", "1"))
        first.train()
        first.close()
        directory = first.checkpointer.directory
        ckpt_bytes = {f.name: f.stat().st_size for f in (directory / "epoch_0").iterdir()}
        resumed, _ = train_cli.build_trainer(train_cli.parse_arguments(
            ["--run", tracker.run_id, "--runs-root", runs]))
        check(resumed.start_epoch == 1 and int(resumed.state.device_step) == 100,
              f"train_td3 resume: start epoch {resumed.start_epoch}, device step "
              f"{int(resumed.state.device_step)}")
        resumed.train()
        torch.cuda.synchronize()
        diff = bitwise_diff(ref, learner_snapshot(resumed))
        check(not diff, f"train_td3 resume differs from the uninterrupted run at {diff[:8]}")
        check("target_actor" in ref["state"] and int(ref["state"]["device_step"]) == 300,
              f"train_td3 resume: device step {int(ref['state']['device_step'])}")
        check(captures_a == resumed.sac.graph_captures == 1,
              f"train_td3 resume: captures {captures_a}, {resumed.sac.graph_captures}")
        row["resume"] = {"bitwise_vs_uninterrupted": True, "updates": resumed.state.step,
                         "graph_captures": [captures_a, resumed.sac.graph_captures],
                         "checkpoint_bytes": ckpt_bytes}
        resumed.close()

        for cell in ("flat", "visual", "wall_b32"):
            for mode in ("captured", "eager"):
                b = row[cell]["bursts"][mode]
                print(f"train_td3 {cell} {mode}: {b['grad_steps_per_sec']:.2f} steps/s, "
                      f"{b['device_kernels_per_update']:.2f} device kernels per update, "
                      f"idle {b['device_idle_share']:.3f} ({smi})", flush=True)
        emit(row)
        return row["visual"]["launches"]
    finally:
        shutil.rmtree(runs, ignore_errors=True)



# The fused on-device loop's cells: the README's sequence command, the
# pixel recipe on the balance twin, flat SAC and flat TD3 (SACConfig's
# widths: hidden 256,256, batch 64, d_model 64, 4 heads, 2 layers), each
# with 16 twins, update_every 50, utd 1 and the config's 10^6-row ring.
ONDEVICE_CELLS = {
    "sequence": ["--environment", TRAIN_ENV, "--history-len", "8"],
    "pixel": VISUAL_ARGS,
    "flat_sac": ["--environment", TRAIN_ENV],
    "flat_td3": ["--environment", TRAIN_ENV, "--algorithm", "td3"],
}
ONDEVICE_STEPS = 1000  # the traced and the timed epoch: 1000 acting steps, 1000 updates
T8_SHAPE = (64, 4, 8, 16)  # batch 64 x heads x history 8 x head_dim
T8_ACT_SHAPE = (16, 4, 8, 16)  # the 16 twins' acting forward
T8_CRITIC_SHAPE = (128, 4, 8, 16)  # num_qs 2 x batch 64, folded


def traced_run(fn, what: str, attempts: int = 3):
    """``fn()`` under ``torch.profiler`` between ``trace_lead_in`` and
    ``trace_tail``: its result, the kernels' launches by symbol, the
    device-busy ms, the wall ms to a synchronize, and the trace's own
    cost (seconds to stop the profiler and to read its rows, its device
    kernels, which attempt it was). A trace with no device kernel or
    without the tail's is taken again (``fn`` runs again)."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trace_lead_in()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            trace_tail()
            t_stop = time.perf_counter()
        t_read = time.perf_counter()
        rows = traced_rows(prof)
        cost = {"stop_s": t_read - t_stop, "read_s": time.perf_counter() - t_read,
                "device_kernels": sum(n for _, _, n in rows), "attempt": attempt}
        if rows:
            busy_ms = sum(us for _, us, _ in rows) / 1e3
            return out, launches_by_symbol(rows), busy_ms, wall_ms, cost
        print(f"chip_smoke: {what}: trace {attempt} of {attempts} held no device kernel "
              "or lost its end",
              file=sys.stderr, flush=True)
    check(False, f"{what}: the profiler traced no device kernel in {attempts} traces")
    return None, {}, 0.0, 0.0, {}


def _frames_gap(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(max |a - b| in counts, share of differing pixels) of uint8 frames."""
    d = (a.int() - b.int()).abs()
    return int(d.max().item()) if d.numel() else 0, float((d > 0).float().mean().item())


def twins_on_the_card(seed: int) -> dict:
    """Each twin's step on the card against the same step on the CPU from
    the same states, actions and reset poses, at every step of 210 CPU
    steps of 16 envs (one ends at step 5, the rest at 200): floats 1e-5
    (absolute and relative), counts and ``ended`` exactly, frames at
    most 1 count on at most 0.1% of the pixels; and the renderer on 4096
    angles on the card against the CPU's."""
    from torch_actor_critic_tpu_torch.envs.ondevice import (
        PendulumTorch,
        PixelPendulumBalanceTorch,
        PixelPendulumTorch,
        StepOut,
        history_env,
        tree_leaves,
    )
    from torch_actor_critic_tpu_torch.envs.pixel_pendulum import render_rod_torch

    out = {}
    gen = torch.Generator().manual_seed(seed + 21)
    thetas = torch.rand(4096, generator=gen) * 14 - 7
    counts, share = _frames_gap(render_rod_torch(thetas.cuda()).cpu(), render_rod_torch(thetas))
    check(counts <= 1 and share <= 1e-3,
          f"render_rod_torch on the card: {counts} counts off on {share:.2e} of the pixels")
    out["renderer"] = {"angles": 4096, "max_counts_off": counts, "pixel_share_off": share,
                       "bitwise": counts == 0}
    for name, cls in (("pendulum", PendulumTorch), ("pixel", PixelPendulumTorch),
                      ("pixel_balance", PixelPendulumBalanceTorch),
                      ("history8", history_env(PendulumTorch, 8))):
        state = cls.reset(16, generator=gen)
        state.step_count[0] = 195
        if name == "history8":
            state.inner.step_count[0] = 195
        worst, frames = 0.0, (0, 0.0)
        for t_ in range(210):
            action = torch.rand((16, 1), generator=gen) * 5 - 2.5
            pose = cls.sample_pose(16, gen)
            card, card_out = cls.step(state.map(lambda x: x.cuda()), action.cuda(),
                                      pose=pose.cuda())
            state, host_out = cls.step(state, action, pose=pose)
            pairs = list(zip(card.leaves(), state.leaves()))
            pairs += [(tree_leaves(getattr(card_out, f))[i], tree_leaves(getattr(host_out, f))[i])
                      for f in StepOut.__dataclass_fields__
                      for i in range(len(tree_leaves(getattr(host_out, f))))]
            for a, b in pairs:
                a = a.cpu()
                if b.dtype == torch.uint8:
                    c, s = _frames_gap(a, b)
                    frames = (max(frames[0], c), max(frames[1], s))
                elif b.is_floating_point():
                    gap = ((a - b).abs() / (1 + b.abs())).max().item()
                    worst = max(worst, gap)
                else:
                    check(torch.equal(a, b), f"twin {name} step {t_}: {a} != {b}")
        check(worst <= 1e-5 and frames[0] <= 1 and frames[1] <= 1e-3,
              f"twin {name} on the card: float gap {worst}, frames {frames}")
        out[name] = {"steps": 210, "envs": 16, "max_rel_gap": worst,
                     "max_frame_counts_off": frames[0], "max_frame_pixel_share_off": frames[1]}
    return out


def _ondevice_snapshot(state, ring, es, act_gen, metrics) -> dict:
    return {"state": state.state_dict(), "ring": ring.state_dict(),
            "device_size": int(ring.device_size), "env": [x.cpu() for x in es.leaves()],
            "env_gen": es.rng.get_state(), "act_gen": act_gen.get_state(),
            # NaN (a reward with no episode ended) compares by its mask
            "metrics": [{k: (v.nan_to_num().cpu(), v.isnan().cpu()) for k, v in m.items()}
                        for m in metrics]}


def _clone_gen(gen):
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def ondevice_captured_vs_eager(make_loop, parts) -> dict:
    """From clones of one learner state, ring, env batch and acting
    generator, two 100-step epochs (two windows each) with the acting
    steps and the bursts as CUDA graph replays, and the same epochs
    eagerly, on the package's cuDNN setting: learner, ring, env states,
    the three generators and the metrics to the bit; one capture of each
    graph."""
    cudnn = package_cudnn()
    runs, captures = {}, None
    for eager in (True, False):
        loop = make_loop()
        state, ring, es, act_gen = parts
        run = (state.clone(), ring.clone(), es.clone(), _clone_gen(act_gen))
        metrics = []
        for _ in range(2):
            *run, m = loop.epoch(*run, steps=100, update_every=50, eager=eager)
            metrics.append(m)
        torch.cuda.synchronize()
        runs[eager] = _ondevice_snapshot(*run, metrics)
        if not eager:
            captures = (loop.act_captures, loop.sac.graph_captures)
        del loop, run
    diff = bitwise_diff(runs[False], runs[True])
    check(not diff and captures == (1, 1),
          f"captured vs eager on-device epochs: differ at {diff[:8]}, captures {captures}")
    return {"epochs": 2, "steps_per_epoch": 100, "bitwise": True,
            "captures": {"acting": captures[0], "burst": captures[1]}, "cudnn": cudnn}


def _timed_epoch(loop, parts, steps: int) -> tuple:
    """One untraced epoch timed by the host clock to a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    *parts, m = loop.epoch(*parts, steps=steps, update_every=50)
    torch.cuda.synchronize()
    return parts, m, time.perf_counter() - t0


def _host_trainer_epoch(cli, args) -> dict:
    """The host ``Trainer`` at the same config (one env, 2 epochs of 300
    steps, the first 100 random): its second epoch's rates."""
    from torch_actor_critic_tpu_torch import train as train_cli

    seen = []
    trainer, _ = train_cli.build_trainer(cli(*args, "--epochs", "2", "--steps-per-epoch", "300",
                                             "--start-steps", "100", "--update-after", "100"))
    try:
        trainer.train(on_epoch=lambda e, m: seen.append(m))
    finally:
        trainer.close()
    return {"env_steps_per_sec": seen[-1]["env_steps_per_sec"],
            "grad_steps_per_sec": seen[-1]["grad_steps_per_sec"]}


def _burst_rate(learner, state, ring, gen) -> float:
    """Gradient steps per second of the captured 50-update burst alone,
    at the cell's config, from clones (four timed bursts after one)."""
    from torch_actor_critic_tpu_torch.buffer.replay import sample

    st, buf = state.clone(), ring.clone()
    chunk = sample(buf, 50 * 16, generator=gen)  # one window of the 16 twins
    st, buf, _ = learner.update_burst(st, buf, chunk, 50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        st, buf, _ = learner.update_burst(st, buf, chunk, 50)
    torch.cuda.synchronize()
    return 200 / (time.perf_counter() - t0)


def _full_ring_save(state, ring, smi: str) -> dict:
    """The async save of the full ring: fills it to capacity with random
    rows, then times ``save`` (the host copies) and ``wait`` (the
    background write), twice (the second reuses the host buffers); then
    ``save_buffer=False`` writes no ``buffer.pt``."""
    from torch_actor_critic_tpu_torch.buffer.replay import push
    from torch_actor_critic_tpu_torch.core.types import Batch
    from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer

    gen = torch.Generator(device="cuda").manual_seed(5)
    n = 50_000
    ring = ring.clone()

    def rand(*shape):
        return torch.randn((n, *shape), generator=gen, device="cuda")

    obs = tuple(ring.data.states.shape[1:])
    while ring.size < ring.capacity:
        ring = push(ring, Batch(rand(*obs), rand(1), rand(), rand(*obs), torch.zeros(n, device="cuda")))
    torch.cuda.synchronize()
    directory = tempfile.mkdtemp(prefix="tac_chip_ondevice_ckpt_")
    try:
        ck = Checkpointer(directory)
        saves = []
        for epoch in range(2):
            t0 = time.perf_counter()
            ck.save(epoch, state, ring)
            t_save = time.perf_counter() - t0
            ck.wait()
            saves.append({"save_s": t_save, "until_wait_s": time.perf_counter() - t0})
        ring_file = f"{directory}/epoch_1/buffer.pt"
        nbytes = {f: os.path.getsize(f"{directory}/epoch_1/{f}")
                  for f in ("actor.pt", "state.pt", "buffer.pt")}
        restored = torch.load(ring_file, weights_only=True)
        check(restored["size"] == ring.capacity and torch.equal(
            restored["leaves"]["rewards"][-5:], ring.data.rewards[-5:].cpu()),
            "the full-ring save does not read back")
        bare = Checkpointer(f"{directory}/bare", save_buffer=False)
        bare.save(0, state, ring, wait=True)
        check(not os.path.exists(f"{directory}/bare/epoch_0/buffer.pt"),
              "save_buffer=False wrote buffer.pt")
        return {"rows": ring.capacity, "saves": saves, "bytes": nbytes,
                "no_save_buffer_writes_no_ring": True, "card": smi}
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def _cli_resume(seed: int) -> dict:
    """``train --on-device true`` for one short epoch, then ``train --run
    <id>``: the resumed run restores learner and ring, runs no warm-up
    and captures each graph once."""
    from torch_actor_critic_tpu_torch import train as train_cli

    runs = tempfile.mkdtemp(prefix="tac_chip_ondevice_run_")
    try:
        common = ["--runs-root", runs, "--seed", str(seed)]
        first = train_cli.main(["--on-device", "true", "--environment", TRAIN_ENV,
                                "--history-len", "8", "--epochs", "1", "--steps-per-epoch",
                                "100", "--start-steps", "50", "--buffer-size", "100000",
                                *common])
        (run_id,) = os.listdir(f"{runs}/Default")
        resumed = train_cli.main(["--run", run_id, *common])
        meta = json.loads(open(f"{runs}/Default/{run_id}/artifacts/checkpoints/epoch_1/"
                               "meta.json").read())
        check(meta["step"] == 250 and resumed["graph_captures"] == 1
              and resumed["act_graph_captures"] == 1 and math.isfinite(resumed["loss_q"]),
              f"on-device --run resume: meta {meta.get('step')}, {resumed}")
        return {"first": first, "resumed": resumed, "resumed_epoch": meta["epoch"]}
    finally:
        shutil.rmtree(runs, ignore_errors=True)


def phase_on_device(seed: int, kernels, attn, smi: str) -> dict:
    """The fused on-device loop on the card (``sac/ondevice.py``):

    - K2 at history 8 on the acting batch (16), the update batch (64) and
      the stacked critics' fold (128, the critic's own views), K3/K4 at
      64 and 128, each against its plain version at the earlier phases'
      limits, with times;
    - the twins on the card against the CPU (``twins_on_the_card``);
    - per cell (``ONDEVICE_CELLS``): the ring's device bytes
      (``mem_get_info``); the warm-up epoch of 1000 uniform steps, traced
      in the sequence cell (it launches no kernel); a captured against
      an eager 100-step epoch from clones, to the bit (the pixel cell on
      cuDNN's deterministic algorithms); a traced 1000-step epoch whose
      device launches are
      exactly L K2 per acting step and 5L K2 + 2L K3 + 2L K4 per update
      (sequence, L = 2: K2 = 12·S, K3 = K4 = 4·S) or 1 K1 per update
      (pixel), the wrappers having seen one warm-up and one capture of
      each graph, and whose device idle share is 1 - busy / wall of that
      traced run; the same epoch untraced and timed (env and gradient
      steps per second, and the traced wall over this one: the
      profiler's stretch); an epoch under ``torch.cuda.set_sync_debug_mode
      ("error")``; the captured burst alone and the host ``Trainer``'s
      epoch at the same config; each part's seconds;
    - the async save of the full history-8 ring and ``save_buffer=False``;
    - ``train --on-device true`` then ``train --run <id>``.

    Returns the traced trained epochs' K1-K4 launches, summed."""
    from torch_actor_critic_tpu_torch import train as train_cli
    from torch_actor_critic_tpu_torch.envs.ondevice import get_on_device_env
    from torch_actor_critic_tpu_torch.sac.ondevice import (
        OnDeviceLoop,
        _wrap_and_build,
        warmup_steps,
    )

    row = {"phase": "on_device", "card": smi, "seconds": {}}
    t_phase = time.perf_counter()
    qkv8 = critic_views(seed, history=8)
    fwd = phase_kernel_vs_plain(attn, seed, qkv8, cases=[
        (T8_ACT_SHAPE, True, torch.float32, 50, "views"),
        (T8_SHAPE, True, torch.float32, 50, "views"),
        (T8_CRITIC_SHAPE, True, torch.float32, 50, "critic_views"),
    ])
    bwd = phase_bwd_vs_plain(attn, seed, qkv8, cases=[
        (T8_CRITIC_SHAPE, True, torch.float32, 50, "critic_views"),
        (T8_SHAPE, True, torch.float32, 50, "views"),
    ])
    del qkv8
    row["kernels_t8"] = {"flash_fwd_act": fwd["shape"], "flash_bwd": bwd["flash_bwd_dq"]["shape"]}
    row["seconds"]["kernel_rows"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    row["twins"] = twins_on_the_card(seed)
    row["seconds"]["twins"] = time.perf_counter() - t0

    def cli(*extra):
        return train_cli.parse_arguments([*extra, "--seed", str(seed), "--device", "cuda"])

    totals = dict.fromkeys(KERNEL_SYMBOLS, 0)
    for name, args in ONDEVICE_CELLS.items():
        cfg = train_cli.config_from_args(cli(*args)).replace(on_device=True)
        env_name = args[args.index("--environment") + 1]
        env, learner = _wrap_and_build(get_on_device_env(env_name), cfg)
        layers = cfg.seq_num_layers if cfg.history_len > 1 else 0
        per_step = {"flash_fwd": layers}
        per_update = {"flash_fwd": 5 * layers, "flash_bwd_dq": 2 * layers,
                      "flash_bwd_dkv": 2 * layers,
                      "pixel_gather": int(cfg.pixel_pipeline == "fused")}
        seconds, t0 = {}, time.perf_counter()

        def lap(what):
            nonlocal t0
            seconds[what] = time.perf_counter() - t0
            t0 = time.perf_counter()

        def make_loop():
            return OnDeviceLoop(_wrap_and_build(get_on_device_env(env_name), cfg)[1], env,
                                n_envs=cfg.on_device_envs, device="cuda")

        loop = OnDeviceLoop(learner, env, n_envs=cfg.on_device_envs, device="cuda")
        free0 = torch.cuda.mem_get_info()[0]
        parts = loop.init(seed, buffer_capacity=cfg.buffer_size)
        torch.cuda.synchronize()
        cell = {"env": env_name, "algorithm": cfg.algorithm, "history_len": cfg.history_len,
                "n_envs": loop.n_envs, "update_every": cfg.update_every, "utd": cfg.utd,
                "ring_rows": cfg.buffer_size,
                "ring_bytes": sum(x.numel() * x.element_size() for x in parts[1].data.leaves()),
                "device_bytes_taken_by_init": free0 - torch.cuda.mem_get_info()[0]}
        n_warmup = warmup_steps(cfg.start_steps, cfg.update_every)

        def warm_up():
            return loop.epoch(*parts, steps=n_warmup, update_every=cfg.update_every,
                              warmup=True)[:4]

        if layers:
            parts, warm, *_ = traced_run(warm_up, f"on_device {name} warm-up")
            check(sum(warm.values()) == 0, f"on_device {name}: warm-up epoch launched {warm}")
            cell["warmup"] = {"steps": n_warmup, "launches": warm}
        else:
            parts = warm_up()
            cell["warmup"] = {"steps": n_warmup}
        lap("warmup")
        cell["captured_vs_eager"] = ondevice_captured_vs_eager(
            make_loop, parts)
        lap("captured_vs_eager")

        kernels.reset_launch_counts()
        steps = ONDEVICE_STEPS
        (parts, m), launches, busy_ms, wall_ms, trace_cost = traced_run(
            lambda: (lambda out: (out[:4], out[4]))(
                loop.epoch(*parts, steps=steps, update_every=cfg.update_every)),
            f"on_device {name}")
        wrapped = dict(kernels.launch_counts)
        updates = steps // cfg.update_every * cfg.updates_per_window
        want = {k: per_step.get(k, 0) * steps + per_update[k] * updates for k in KERNEL_SYMBOLS}
        want_wrapped = {k: 2 * (per_step.get(k, 0) + per_update[k]) for k in KERNEL_SYMBOLS}
        got_wrapped = {k: wrapped.get(k, 0) for k in KERNEL_SYMBOLS}
        check(launches == want and got_wrapped == want_wrapped,
              f"on_device {name}: device launches {launches} != {want} or wrappers "
              f"{got_wrapped} != {want_wrapped}")
        check(loop.act_captures == 2 and learner.graph_captures == 1,
              f"on_device {name}: captures {loop.act_captures}, {learner.graph_captures}")
        check(all(math.isfinite(float(m[k])) for k in ("loss_q", "loss_pi")),
              f"on_device {name}: losses {m}")
        for k in totals:
            totals[k] += launches[k]
        cell["traced_epoch"] = {"steps": steps, "updates": updates, "launches": launches,
                                "wrapper_launches": got_wrapped, "wall_ms": wall_ms,
                                "device_busy_ms": busy_ms,
                                "device_kernels": trace_cost.pop("device_kernels"),
                                "trace_attempt": trace_cost.pop("attempt"),
                                "device_idle_share": 1.0 - busy_ms / wall_ms,
                                "trace_cost_s": trace_cost}
        lap("traced_epoch")
        parts, m, dt = _timed_epoch(loop, parts, ONDEVICE_STEPS)
        updates = ONDEVICE_STEPS // cfg.update_every * cfg.updates_per_window
        cell["epoch"] = {
            "steps": ONDEVICE_STEPS, "seconds": dt,
            "env_steps_per_sec": ONDEVICE_STEPS * loop.n_envs / dt,
            "grad_steps_per_sec": updates / dt,
            # the profiler's stretch of the same epoch: its idle share
            # is read from the trace alone (busy time needs the trace)
            "traced_wall_over_timed": wall_ms / (dt * 1e3),
            "loss_q": float(m["loss_q"]), "reward": float(m["reward"]),
            "episodes": float(m["episodes"]),
        }
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            *parts, m = loop.epoch(*parts, steps=100, update_every=cfg.update_every)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(math.isfinite(float(m["loss_q"])), f"on_device {name}: sync-free epoch {m}")
        cell["sync_free_epoch"] = {"steps": 100, "sync_debug_mode": "error"}
        cell["captured_burst_grad_steps_per_sec"] = _burst_rate(
            learner, parts[0], parts[1], torch.Generator(device="cuda").manual_seed(seed + 9))
        lap("timed")
        if name == "sequence":
            row["full_ring_save"] = _full_ring_save(parts[0], parts[1], smi)
            lap("full_ring_save")
        del loop, learner, parts, make_loop
        torch.cuda.empty_cache()
        cell["host_trainer_epoch"] = _host_trainer_epoch(cli, args)
        lap("host_trainer")
        cell["vs_host_trainer"] = (cell["epoch"]["grad_steps_per_sec"]
                                   / cell["host_trainer_epoch"]["grad_steps_per_sec"])
        cell["vs_captured_burst"] = (cell["epoch"]["grad_steps_per_sec"]
                                     / cell["captured_burst_grad_steps_per_sec"])
        cell["seconds"] = seconds
        row[name] = cell
        print(f"on_device {name}: {cell['epoch']['env_steps_per_sec']:.1f} env steps/s, "
              f"{cell['epoch']['grad_steps_per_sec']:.2f} grad steps/s "
              f"({cell['vs_captured_burst']:.3f} of the captured burst, "
              f"{cell['vs_host_trainer']:.2f}x the host trainer), idle "
              f"{cell['traced_epoch']['device_idle_share']:.3f} (traced, "
              f"{cell['epoch']['traced_wall_over_timed']:.2f}x the untraced wall) "
              f"({smi})", flush=True)
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    row["cli_resume"] = _cli_resume(seed)
    row["seconds"]["cli_resume"] = time.perf_counter() - t0
    row["seconds"]["phase"] = time.perf_counter() - t_phase
    emit(row)
    return totals


def in_a_child(phase: str, seed: int, timeout: int) -> dict:
    """Phase ``phase`` in a process of its own (``--<phase>-phase``), so
    its rings and its profiler traces start from a fresh CUDA context
    after the earlier phases; the kernel libraries it loads are those
    ``phase_build`` left in ``_build/``. Its lines pass through; returns
    the launches its last line reports."""
    torch.cuda.empty_cache()  # the earlier phases' cached blocks, for the child's rings
    flag = f"--{phase.replace('_', '-')}-phase"
    res = subprocess.run([sys.executable, os.path.abspath(__file__), flag, "--seed", str(seed)],
                         capture_output=True, text=True, timeout=timeout)
    sys.stderr.write(res.stderr)
    lines = res.stdout.splitlines()
    print("\n".join(lines[:-1]), flush=True)
    check(res.returncode == 0 and lines, f"the {phase} phase exited {res.returncode}")
    return json.loads(lines[-1])[f"{phase}_launches"]


POP_FLAT_ARGS = ["--environment", "HalfCheetah-v5", "--on-device", "true", "--population", "32",
                 "--pbt-every", "1", "--pbt-quantile", "0.25"]
POP_SEQ_ARGS = ["--environment", TRAIN_ENV, "--on-device", "true", "--history-len", "8",
                "--population", "8"]
POP_STEPS = 1000  # a cheetah episode: every member ends one in each 1000-step epoch
# K2-K4 at the population's folded shapes (P = 8, history 8): the acting
# batch P·16, the update batch P·64, the critics' fold P·Q·64; and the
# critics' fold at P = 32 (grid and index range).
T8_POP_ACT_SHAPE = (8 * 16, 4, 8, 16)
T8_POP_SHAPE = (8 * 64, 4, 8, 16)
T8_POP_CRITIC_SHAPE = (8 * 2 * 64, 4, 8, 16)
T8_POP32_CRITIC_SHAPE = (32 * 2 * 64, 4, 8, 16)


def _ring_sums(ring) -> list:
    """Each member's f64 sum of every ring leaf: a ``(P,)`` fingerprint
    read without copying the ring."""
    return [leaf.reshape(leaf.shape[0], -1).sum(dim=1, dtype=torch.float64)
            for leaf in ring.data.leaves()]


class PBTChecks:
    """Wraps ``PopulationOnDeviceLoop.epoch`` and ``.pbt_step`` while a
    run trains through the CLI: each PBT step is checked right after it
    runs — each exploited member's networks, ``log_alpha`` and Adam
    state bitwise its winner's before the step, the others' untouched,
    its hyperparameters the winner's times exactly ``pbt_perturb ** ±1``
    (f32), every member's ring (by its sums) and the learner's, acting
    and env generators unchanged."""

    def __init__(self, loop_cls, perturb: float):
        self.loop_cls, self.perturb = loop_cls, perturb
        self.real = (loop_cls.epoch, loop_cls.pbt_step)
        self.steps, self.last = [], {}

    def __enter__(self):
        from torch_actor_critic_tpu_torch.sac.population import member_tensors

        real_epoch, real_pbt = self.real
        checks = self

        def epoch(loop, state, ring, env_states, act_gen, *a, **k):
            out = real_epoch(loop, state, ring, env_states, act_gen, *a, **k)
            checks.last = {"ring": out[1], "env_states": out[2], "act_gen": out[3]}
            return out

        def pbt_step(loop, state, pbt_state, **k):
            before = [x.clone() for x in member_tensors(state)]
            hp = {n: v.clone() for n, v in state.hyperparams.items()}
            sums = _ring_sums(checks.last["ring"])
            gens = [state.generator, checks.last["act_gen"], checks.last["env_states"].rng]
            gen_states = [g.get_state() for g in gens]
            ev = real_pbt(loop, state, pbt_state, **k)
            src = ev["src"].tolist()
            losers = [i for i, s in enumerate(src) if s != i]
            for a, b in zip(member_tensors(state), before, strict=True):
                check(all(torch.equal(a[i], b[s]) for i, s in enumerate(src)),
                      f"pbt_step: a member tensor {tuple(a.shape)} is not its source's")
            f32 = torch.tensor([checks.perturb, 1.0 / checks.perturb], dtype=torch.float32,
                               device="cuda")
            for n, v in state.hyperparams.items():
                for i, s in enumerate(src):
                    want = hp[n][s] * f32 if i in losers else hp[n][i:i + 1]
                    check(bool((v[i] == want).any()),
                          f"pbt_step: {n}[{i}] = {v[i].item()}, not {want.tolist()}")
            check(all(torch.equal(a, b) for a, b in zip(_ring_sums(checks.last["ring"]), sums)),
                  "pbt_step changed a ring")
            check(all(torch.equal(g.get_state(), s) for g, s in zip(gens, gen_states)),
                  "pbt_step moved a generator")
            checks.steps.append({"exploited": losers, "src": src,
                                 "ready": bool(ev["ready"]),
                                 "tensors_checked": len(before)})
            return ev

        self.loop_cls.epoch, self.loop_cls.pbt_step = epoch, pbt_step
        return self

    def __exit__(self, *exc):
        self.loop_cls.epoch, self.loop_cls.pbt_step = self.real


def _population_flat_cli(seed: int, smi: str) -> dict:
    """The README's command at P = 32 through ``train.main``: the cheetah
    twin, SACConfig's widths, 10^6 rows per member, a 1000-step warm-up
    and two 1000-step epochs, a PBT step after each (checked by
    :class:`PBTChecks`; the first exploits, since every member has ended
    an episode by then). ``metrics.jsonl`` holds ``loss_q_m0`` ...
    ``loss_q_m31``, all finite."""
    from torch_actor_critic_tpu_torch import train as train_cli
    from torch_actor_critic_tpu_torch.sac.ondevice import PopulationOnDeviceLoop

    runs = tempfile.mkdtemp(prefix="tac_chip_population_")
    try:
        t0 = time.perf_counter()
        with PBTChecks(PopulationOnDeviceLoop, 1.25) as pbt:
            final = train_cli.main([*POP_FLAT_ARGS, "--epochs", "2", "--steps-per-epoch",
                                    str(POP_STEPS), "--no-save-buffer", "--runs-root", runs,
                                    "--seed", str(seed)])
        seconds = time.perf_counter() - t0
        (run_id,) = os.listdir(f"{runs}/Default")
        rows = [json.loads(x) for x in
                open(f"{runs}/Default/{run_id}/metrics.jsonl").read().splitlines()]
        keys = set().union(*(set(r.get("metrics", r)) for r in rows))
        losses = [final[f"loss_q_m{i}"] for i in range(32)]
        check({f"loss_q_m{i}" for i in range(32)} <= keys and "pbt_exploits" in keys,
              f"population metrics.jsonl keys: {sorted(keys)[:12]}...")
        check(all(math.isfinite(x) for x in losses), f"population losses {losses}")
        check(len(pbt.steps) == 2 and pbt.steps[0]["exploited"],
              f"population PBT steps {pbt.steps}")
        return {"population": 32, "ring_rows_per_member": 10**6, "seconds": seconds,
                "pbt_steps": pbt.steps,
                "final": {k: final[k] for k in ("loss_q", "loss_pi", "reward", "episodes",
                                                "env_steps_per_sec", "grad_steps_per_sec",
                                                "pbt_exploits")},
                "card": smi}
    finally:
        shutil.rmtree(runs, ignore_errors=True)


def _population_loop(args, seed: int, buffer: int, members: int | None = None, pbt=False):
    from torch_actor_critic_tpu_torch import train as train_cli
    from torch_actor_critic_tpu_torch.envs.ondevice import get_on_device_env, history_env
    from torch_actor_critic_tpu_torch.sac.ondevice import PopulationOnDeviceLoop
    from torch_actor_critic_tpu_torch.sac.population import make_population_learner

    cfg = train_cli.config_from_args(train_cli.parse_arguments(
        [*args, "--seed", str(seed)])).replace(on_device=True, buffer_size=buffer)
    if members is not None:
        cfg = cfg.replace(population=members, pbt_every=cfg.pbt_every if members > 1 else 0)
    env = get_on_device_env(args[args.index("--environment") + 1])
    if cfg.history_len > 1:
        env = history_env(env, cfg.history_len)
    p = cfg.population
    return cfg, PopulationOnDeviceLoop(make_population_learner(cfg, env.act_dim, p), env, p,
                                       n_envs=cfg.on_device_envs, pbt=pbt, device="cuda")


def member_vs_solo(seed: int) -> dict:
    """Member 3 of a flat cheetah population of 8, extracted after a
    warm-up, against a lone ``OnDeviceLoop`` fed member 3's weights and
    its slice of the population's draws (acting noise, reset poses,
    replay rows, update noise), for two 50-step windows of 50 updates:
    every parameter within 1e-4 of the member's (batched products sum in
    another order than the lone ones)."""
    from torch_actor_critic_tpu_torch.buffer.replay import init_replay_buffer, push
    from torch_actor_critic_tpu_torch.core.types import Batch
    from torch_actor_critic_tpu_torch.envs.ondevice import EnvState
    from torch_actor_critic_tpu_torch.sac.algorithm import SAC
    from torch_actor_critic_tpu_torch.sac.ondevice import OnDeviceLoop

    cfg, loop = _population_loop(POP_FLAT_ARGS, seed, 20_000, members=8)
    p, n, m_ = 8, cfg.on_device_envs, 3
    state, ring, es, act_gen, _ = loop.init(seed, 20_000)
    state, ring, es, act_gen, _ = loop.epoch(state, ring, es, act_gen, steps=100,
                                             update_every=50, warmup=True)
    solo = loop.extract_member(state, m_)
    solo_ring = push(init_replay_buffer(20_000, (17,), 6, "cuda"),
                     Batch(*(x[m_, :ring.size] for x in ring.data.leaves())))
    rows = slice(m_ * n, (m_ + 1) * n)
    solo_es = EnvState(inner=tuple(x[rows].clone() for x in es.inner), obs=es.obs[rows].clone(),
                       step_count=es.step_count[rows].clone(),
                       episode_return=es.episode_return[rows].clone(),
                       rng=torch.Generator(device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    k = cfg.updates_per_window
    noise = torch.randn((100, p, n, 6), generator=gen, device="cuda")
    poses = loop.env.sample_pose(100 * p * n, gen, "cuda").reshape(100, p * n, 16)
    indices = (torch.rand((2, k, p, cfg.batch_size), generator=gen, device="cuda")
               * ring.size).long()
    eps = torch.randn((2, k, 2, p, cfg.batch_size, 6), generator=gen, device="cuda")
    state, ring, es, act_gen, m = loop.epoch(state, ring, es, act_gen, steps=100,
                                             update_every=50, noise=noise, poses=poses,
                                             indices=indices, eps=eps)
    solo_loop = OnDeviceLoop(SAC(cfg, 6), loop.env, n_envs=n, device="cuda")
    solo, solo_ring, solo_es, _, sm = solo_loop.epoch(
        solo, solo_ring, solo_es, torch.Generator(device="cuda"), steps=100, update_every=50,
        noise=noise[:, m_], poses=poses[:, rows], indices=indices[:, :, m_],
        eps=eps[:, :, :, m_])
    gaps = {}
    for mod in ("actor", "critic", "target_critic"):
        mine = dict(getattr(solo, mod).named_parameters())
        gaps[mod] = max((t_.detach()[m_] - mine[name].detach()).abs().max().item()
                        for name, t_ in getattr(state, mod).named_parameters())
    ring_gap = max((a[m_, :ring.size] - b[:ring.size]).abs().max().item()
                   for a, b in zip(ring.data.leaves(), solo_ring.data.leaves()))
    loss_gap = abs(float(m["loss_q"][m_]) - float(sm["loss_q"]))
    check(max(gaps.values()) <= 1e-4 and ring_gap <= 1e-4 and loss_gap <= 1e-4 * max(
        1.0, abs(float(sm["loss_q"]))),
        f"population member vs a lone loop: params {gaps}, ring {ring_gap}, loss {loss_gap}")
    return {"population": p, "member": m_, "updates": 2 * k, "max_param_gap": gaps,
            "max_ring_gap": ring_gap, "loss_q_gap": loss_gap, "tol": 1e-4}


def _population_counts(loop, parts, steps, kernels, what, per_step=None, per_update=None):
    """A traced ``steps``-step epoch (both graphs captured in it): its
    device launches, which must be exactly ``per_step`` of each kernel per
    acting step and ``per_update`` per update whatever P (by default the
    sequence cell's: L K2 per acting step, 5L K2, 2L K3, 2L K4 per
    update); and the wrappers' (one warm-up and one capture of each
    graph)."""
    cfg = loop.sac.config
    layers = cfg.seq_num_layers
    per_step = {"flash_fwd": layers} if per_step is None else per_step
    per_update = per_update or {"flash_fwd": 5 * layers, "flash_bwd_dq": 2 * layers,
                                "flash_bwd_dkv": 2 * layers}
    per_update = {k: per_update.get(k, 0) for k in KERNEL_SYMBOLS}
    kernels.reset_launch_counts()
    (parts, m), launches, busy_ms, wall_ms, cost = traced_run(
        lambda: (lambda out: (out[:4], out[4]))(
            loop.epoch(*parts, steps=steps, update_every=cfg.update_every)), what)
    wrapped = {k: kernels.launch_counts.get(k, 0) for k in KERNEL_SYMBOLS}
    updates = steps // cfg.update_every * cfg.updates_per_window
    want = {k: per_step.get(k, 0) * steps + per_update[k] * updates for k in KERNEL_SYMBOLS}
    want_wrapped = {k: 2 * (per_step.get(k, 0) + per_update[k]) for k in KERNEL_SYMBOLS}
    check(launches == want and wrapped == want_wrapped,
          f"{what}: device launches {launches} != {want} or wrappers {wrapped} != "
          f"{want_wrapped}")
    check(bool(torch.isfinite(m["loss_q"]).all()), f"{what}: losses {m['loss_q']}")
    return parts, m, {"population": loop.members, "steps": steps, "updates": updates,
                      "launches": launches, "wrapper_launches": wrapped,
                      "per_update": {k: n for k, n in per_update.items() if n},
                      "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                      "device_idle_share": 1.0 - busy_ms / wall_ms,
                      "device_kernels": cost["device_kernels"]}


def _resume_under_graphs(loop, parts, pbt_state) -> dict:
    """Save at an epoch (learner, rings, env states, acting generator,
    PBT state), run a 100-step epoch, restore the save in place under the
    captured graphs, run it again: the two bitwise equal, no recapture."""
    from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer

    state, ring, es, act_gen = parts
    arrays = {"env_states": es, "act_gen": act_gen, "pbt_state": pbt_state}
    captures = (loop.act_captures, loop.sac.graph_captures)
    directory = tempfile.mkdtemp(prefix="tac_chip_population_ckpt_")
    try:
        ck = Checkpointer(directory)
        t0 = time.perf_counter()
        ck.save(0, state, ring, arrays=arrays, wait=True)
        save_s = time.perf_counter() - t0
        runs = []
        for restore in (False, True):
            if restore:
                state, ring, _, _ = ck.restore(state, ring, abstract_arrays=arrays)
            out = loop.epoch(state, ring, es, act_gen, steps=100,
                             update_every=loop.sac.config.update_every)
            torch.cuda.synchronize()
            state, ring = out[0], out[1]
            runs.append({**_ondevice_snapshot(state, ring, es, act_gen, [out[4]]),
                         "pbt": pbt_state.state_dict()})
        diff = bitwise_diff(runs[0], runs[1])
        now = (loop.act_captures, loop.sac.graph_captures)
        check(not diff and now == captures,
              f"population resume under graphs: differs at {diff[:8]}, captures {captures} "
              f"-> {now}")
        return {"bitwise": True, "steps": 100, "save_s": save_s, "captures": list(now),
                "ring_rows_saved": ring.size}
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def _solo_cheetah_rate(cfg, seed: int) -> dict:
    """The lone ``OnDeviceLoop`` on the cheetah twin at the population's
    config, timed as ``_population_rates`` times a member count: what
    the member axis costs at P = 1."""
    from torch_actor_critic_tpu_torch.envs.ondevice import CheetahRunTorch
    from torch_actor_critic_tpu_torch.sac.algorithm import SAC
    from torch_actor_critic_tpu_torch.sac.ondevice import OnDeviceLoop

    cfg = cfg.replace(population=1, pbt_every=0)
    loop = OnDeviceLoop(SAC(cfg, 6), CheetahRunTorch, n_envs=cfg.on_device_envs, device="cuda")
    parts = loop.init(seed, 10**6)
    parts = loop.epoch(*parts, steps=1000, update_every=50, warmup=True)[:4]
    parts = loop.epoch(*parts, steps=POP_STEPS, update_every=50)[:4]
    parts, _, dt = _timed_epoch(loop, parts, POP_STEPS)
    updates = POP_STEPS // 50 * cfg.updates_per_window
    return {"seconds": dt, "grad_steps_per_sec": updates / dt,
            "burst_updates_per_sec": _burst_rate(
                loop.sac, parts[0], parts[1],
                torch.Generator(device="cuda").manual_seed(seed + 9))}


def _population_rates(seed: int, smi: str) -> dict:
    """Untraced flat-cell epochs at P = 1, 8, 32 (the cheetah twin,
    SACConfig's widths, 10^6 rows per member): after a 1000-step warm-up
    and one 1000-step epoch (which captures), one timed 1000-step epoch:
    aggregate env and gradient steps per second (both × P), the captured
    burst's updates per second alone (and at P = 1 the lone loop's
    epoch and burst on the same twin and config), and the
    device memory the population holds and at its peak, above what the
    process held before it was made."""
    import gc

    out = {}
    for p in (1, 8, 32):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        cfg, loop = _population_loop(POP_FLAT_ARGS, seed, 10**6, members=p)
        parts = loop.init(seed, 10**6)[:4]
        parts = loop.epoch(*parts, steps=1000, update_every=50, warmup=True)[:4]
        parts = loop.epoch(*parts, steps=POP_STEPS, update_every=50)[:4]
        parts, m, dt = _timed_epoch(loop, parts, POP_STEPS)
        updates = POP_STEPS // 50 * cfg.updates_per_window
        row = {"population": p, "seconds": dt,
               "env_steps_per_sec": POP_STEPS * loop.n_envs * p / dt,
               "grad_steps_per_sec": updates * p / dt,
               "updates_per_sec": updates / dt,
               "ring_bytes": sum(x.numel() * x.element_size() for x in parts[1].data.leaves()),
               "memory_allocated_bytes": torch.cuda.memory_allocated() - base,
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated() - base,
               "memory_before_bytes": base,
               "loss_q_finite": bool(torch.isfinite(m["loss_q"]).all())}
        check(row["loss_q_finite"], f"population rates P={p}: losses {m['loss_q']}")
        # The captured 50-update burst alone: what the epoch's acting adds.
        row["burst_updates_per_sec"] = _burst_rate(
            loop.sac, parts[0], parts[1], torch.Generator(device="cuda").manual_seed(seed + 9))
        if p == 1:
            row["solo_loop"] = _solo_cheetah_rate(cfg, seed)
        out[f"P{p}"] = row
        print(f"population P={p}: {row['env_steps_per_sec']:.1f} env steps/s, "
              f"{row['grad_steps_per_sec']:.1f} grad steps/s (x P; burst alone "
              f"{row['burst_updates_per_sec']:.1f} updates/s), "
              f"{row['max_memory_allocated_bytes'] / 2**30:.2f} GiB peak ({smi})", flush=True)
        del loop, parts
    return out


def phase_population(seed: int, kernels, attn, smi: str) -> dict:
    """The fused population (``--on-device true --population N``):

    - K2 at the folded shapes of a history-8 population of 8 (acting
      (128, 4, 8, 16), update (512, ...), critics (1024, ...)) and at the
      critics' fold of 32 (4096, ...), K3/K4 at the update and critics'
      folds, against their plain versions at the limits of 3, with times;
    - the README's command at P = 32 on the cheetah twin through
      ``train.main`` with each PBT step checked in place
      (:class:`PBTChecks`; at least one exploit);
    - a captured against an eager history-8 population epoch from clones,
      to the bit, and a member against a lone loop to 1e-4;
    - the sequence cell (P = 8, history 8, 10^6 rows per member): a traced
      1000-step epoch whose launches are L K2 per acting step and 5L K2,
      2L K3, 2L K4 per update, as at P = 32 in a traced 100-step epoch;
      then a save, an epoch, an in-place restore under the graphs and
      the epoch again, bitwise;
    - untraced flat-cell rates and memory at P = 1, 8, 32.

    Returns the sequence cell's traced launches."""
    from torch_actor_critic_tpu_torch.sac.ondevice import warmup_steps

    row = {"phase": "population", "card": smi, "seconds": {}}
    t_phase = t0 = time.perf_counter()

    def lap(what):
        nonlocal t0
        row["seconds"][what] = time.perf_counter() - t0
        t0 = time.perf_counter()

    fwd = phase_kernel_vs_plain(attn, seed, None, cases=[
        (T8_POP_ACT_SHAPE, True, torch.float32, 50, "views"),
        (T8_POP_SHAPE, True, torch.float32, 50, "views"),
        (T8_POP_CRITIC_SHAPE, True, torch.float32, 50, "views"),
        (T8_POP32_CRITIC_SHAPE, True, torch.float32, 20, "views"),
    ])
    bwd = phase_bwd_vs_plain(attn, seed, None, cases=[
        (T8_POP_SHAPE, True, torch.float32, 50, "views"),
        (T8_POP_CRITIC_SHAPE, True, torch.float32, 50, "views"),
        (T8_POP32_CRITIC_SHAPE, True, torch.float32, 20, "views"),
    ])
    row["kernels_t8_population"] = {"flash_fwd_act": fwd["shape"],
                                    "flash_bwd": bwd["flash_bwd_dq"]["shape"]}
    lap("kernel_rows")
    row["flat_cli"] = _population_flat_cli(seed, smi)
    lap("flat_cli")
    torch.cuda.empty_cache()

    cfg, _ = _population_loop(POP_SEQ_ARGS, seed, 100_000)

    def make_loop():
        return _population_loop(POP_SEQ_ARGS, seed, 100_000)[1]

    probe = make_loop()
    parts = probe.init(seed, 100_000)[:4]
    parts = probe.epoch(*parts, steps=100, update_every=50, warmup=True)[:4]
    row["captured_vs_eager"] = ondevice_captured_vs_eager(make_loop, parts)
    del probe, parts
    row["member_vs_solo"] = member_vs_solo(seed)
    lap("captured_vs_eager_and_solo")
    torch.cuda.empty_cache()

    cfg, loop = _population_loop(POP_SEQ_ARGS, seed, 10**6)
    free0 = torch.cuda.mem_get_info()[0]
    *parts, pbt_state = loop.init(seed, 10**6)
    n_warmup = warmup_steps(cfg.start_steps, cfg.update_every)
    parts = loop.epoch(*parts, steps=n_warmup, update_every=cfg.update_every, warmup=True)[:4]
    row["sequence"] = {"population": cfg.population, "ring_rows_per_member": 10**6,
                       "device_bytes_taken_by_init": free0 - torch.cuda.mem_get_info()[0]}
    parts, m, traced = _population_counts(loop, parts, POP_STEPS, kernels,
                                          "population sequence P=8")
    row["sequence"]["traced_epoch"] = traced
    lap("sequence_traced")
    row["sequence"]["resume_under_graphs"] = _resume_under_graphs(loop, parts, pbt_state)
    lap("resume")
    del loop, parts
    torch.cuda.empty_cache()
    cfg32, loop32 = _population_loop(POP_SEQ_ARGS, seed, 20_000, members=32)
    parts32 = loop32.init(seed, 20_000)[:4]
    parts32 = loop32.epoch(*parts32, steps=100, update_every=50, warmup=True)[:4]
    *_, traced32 = _population_counts(loop32, parts32, 100, kernels, "population sequence P=32")
    check(traced32["per_update"] == traced["per_update"],
          f"K2-K4 per update depend on P: {traced['per_update']} vs {traced32['per_update']}")
    row["sequence_p32_counts"] = traced32
    del loop32, parts32
    lap("sequence_p32_counts")
    torch.cuda.empty_cache()
    row["rates"] = _population_rates(seed, smi)
    lap("rates")
    row["seconds"]["phase"] = time.perf_counter() - t_phase
    emit(row)
    return traced["launches"]


# The host-loop populations, the pixel populations and the TD3 population:
# the sequence stack at SACConfig's widths (d_model 64, 4 heads, 2 layers,
# history 16, batch 64) with 4 members; the pixel recipe's with 4 members on
# the host loop and 8 on the fused loop; flat TD3 with 8 members and PBT.
# Rings hold the CLI's FUSED_RING rows per member, except where a check
# clones a pixel ring: a clone of the fused pixel population's 8 rings
# would not fit beside them in the card's 80 GB, and the host pixel
# population's member-vs-solo check ran out of memory at 10^6 rows (72.58
# of 79.18 GiB allocated on an NVIDIA H100 80GB HBM3, 700.00 W), so both
# check on CHECK_RING rows (the fused one trains, traces and times on
# FUSED_RING rows first).
FUSED_RING = 10**6
CHECK_RING = 20_000
HOST_POP = 4
HOST_SEQ_ARGS = ["--environment", TRAIN_ENV, "--history-len", "16",
                 "--population", str(HOST_POP)]
HOST_PIXEL_ARGS = [*VISUAL_ARGS, "--population", str(HOST_POP),
                   "--buffer-size", str(CHECK_RING)]
PIXEL_POP_ARGS = [*VISUAL_ARGS, "--on-device", "true", "--population", "8"]
TD3_POP_ARGS = ["--environment", TRAIN_ENV, "--on-device", "true", "--algorithm", "td3",
                "--population", "8", "--pbt-every", "1", "--pbt-quantile", "0.25"]
# K2-K4 at the host sequence population's folds: the acting batch P·1, the
# update batch P·64, the critics' fold P·Q·64 (heads 4, history 16, d 16).
HOST_POP_ACT_SHAPE = (HOST_POP, 4, 16, 16)
HOST_POP_SHAPE = (HOST_POP * 64, 4, 16, 16)
HOST_POP_CRITIC_SHAPE = (HOST_POP * 2 * 64, 4, 16, 16)
# K1 at the fused pixel population's fold: 8 members' full 10^6-row rings as
# one (8·10^6, 32, 32, 3) ring, 8·64 rows, both frame leaves in one launch.
FOLD_MEMBERS, FOLD_CAPACITY, FOLD_BATCH = 8, 10**6, 64


def pixel_fold_row(pixels, seed: int, iters: int = 200) -> dict:
    """K1 at the member fold (``member_frame_gather_pair``: ``FOLD_MEMBERS``
    rings of ``FOLD_CAPACITY`` rows viewed as one, ``FOLD_MEMBERS·64``
    rows, both leaves, shifted, normalized, f32) against the plain
    version on the folded ring at the folded rows: bitwise, with times
    and the bound."""
    from torch_actor_critic_tpu_torch.buffer.replay import fold_member_rows
    from torch_actor_critic_tpu_torch.ops.augment import shift_offsets

    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    p, cap, b = FOLD_MEMBERS, FOLD_CAPACITY, FOLD_BATCH
    rings = [torch.randint(0, 256, (p, cap, 32, 32, 3), generator=gen, device="cuda",
                           dtype=torch.uint8) for _ in range(2)]
    draws = []
    for i in range(iters):
        idx = torch.randint(0, cap, (p, b), generator=gen, device="cuda")
        if i == 0:
            idx[:, 0] = 0  # each member's first row: the fold's member boundaries
            idx[:, 1] = cap - 1
        draws.append((fold_member_rows(idx, cap),
                      [shift_offsets(p * b, PIXEL_PAD, gen, "cuda") for _ in range(2)]))
    kw = dict(pad=PIXEL_PAD, normalize=True, out_dtype=torch.float32)
    folded = [r.reshape(p * cap, 32, 32, 3) for r in rings]

    def kernel(i):
        rows, offs = draws[i % iters]
        return pixels.member_frame_gather_pair(rings, rows, offs, **kw)

    def plain(i):
        rows, offs = draws[i % iters]
        return tuple(pixels.gather_frames_reference(r, rows, o, **kw).reshape(p, b, 32, 32, 3)
                     for r, o in zip(folded, offs))

    got, want = kernel(0), plain(0)
    torch.cuda.synchronize()
    for leaf, (g, w) in enumerate(zip(got, want)):
        check(g.shape == (p, b, 32, 32, 3) and torch.equal(g, w),
              f"pixel_gather at the member fold, leaf {leaf}: kernel != plain version")
    turn = iter(range(10 ** 9))
    bound_ms, bound_by = pixel_bound(p * b, (32, 32, 3), 1, torch.float32, True, 2)
    row = {"phase": "kernel_vs_plain", "kernel": "pixel_gather", "case": "member_fold_pair",
           "ring": [p * cap, 32, 32, 3], "members": p, "batch": p * b, "leaves": 2,
           "bitwise_equal": True, "max_abs_err": 0.0,
           "kernel_ms": device_ms(lambda: kernel(next(turn)), iters, "pixel_gather_kernel"),
           "plain_ms": device_ms(lambda: plain(next(turn)), iters),
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
           "shape": [p * b, 32, 32, 3]}
    emit(row)
    del rings, folded, draws, got, want
    torch.cuda.empty_cache()
    return row


def _solo_from_member(learner_cfg, state, member: int, obs_shape, act_dim, act_limit):
    """A lone learner (SAC or TD3) holding member ``member``'s slice of a
    population state: networks, targets, Adam states, ``log_alpha``."""
    from torch_actor_critic_tpu_torch.models import build_models
    from torch_actor_critic_tpu_torch.sac.trainer import make_learner
    from torch_actor_critic_tpu_torch.utils.checkpoint import member_state_dict

    cfg = learner_cfg.replace(population=1, pbt_every=0)
    solo_learner = make_learner(cfg, act_dim)
    actor, critic = build_models(cfg, obs_shape, act_dim, act_limit)
    solo = solo_learner.init_state(actor.cuda(), critic.cuda(),
                                   torch.Generator(device="cuda"))
    solo.load_state_dict_(member_state_dict(state.state_dict(), member))
    if state.hyperparams is not None:
        solo.hyperparams = {k: v[member].clone() for k, v in state.hyperparams.items()}
    return solo_learner, solo


def burst_member_vs_solo(learner, state, ring, obs_shape, act_dim, act_limit, seed: int,
                         member: int = 1, updates: int = 20) -> dict:
    """Member ``member`` of a population burst against a lone learner given
    its weights, its ring's rows and its slice of the burst's draws (rows,
    update noise, shifts): one push of a sampled chunk and ``updates``
    updates from clones; every parameter within 1e-4, the losses within
    1e-4·max(1, |solo|)."""
    from torch_actor_critic_tpu_torch.buffer.replay import sample
    from torch_actor_critic_tpu_torch.core.types import BufferState

    cfg = learner.config
    gen = torch.Generator(device="cuda").manual_seed(seed + 41)
    pop, buf = state.clone(), ring.clone()
    p, b, n = learner.members, cfg.batch_size, 50
    chunk = sample(buf, n, generator=gen)
    solo_learner, solo = _solo_from_member(cfg, pop, member, obs_shape, act_dim, act_limit)
    # The member's ring as a lone one, at the population's cursor.
    solo_ring = BufferState(buf.data.map(lambda x: x[member].clone()), buf.ptr, buf.size,
                            buf.device_size.clone())
    size = min(buf.size + n, buf.capacity)
    indices = (torch.rand((updates, p, b), generator=gen, device="cuda") * size).long()
    td3 = cfg.algorithm == "td3"
    eps = torch.randn((updates, *(() if td3 else (2,)), p, b, act_dim), generator=gen,
                      device="cuda")
    fused = cfg.pixel_pipeline == "fused" and buf.visual
    offsets = (torch.randint(0, 2 * cfg.augment_pad + 1, (updates, 2, p, b, 2), generator=gen,
                             device="cuda") if fused and cfg.frame_augment == "shift" else None)
    pop, buf, m = learner.update_burst(pop, buf, chunk, updates, indices=indices, eps=eps,
                                       offsets=offsets)
    solo, solo_ring, sm = solo_learner.update_burst(
        solo, solo_ring, chunk.map(lambda x: x[member]), updates,
        indices=indices[:, member], eps=eps[:, member] if td3 else eps[:, :, member],
        offsets=None if offsets is None else offsets[:, :, member])
    torch.cuda.synchronize()
    gaps, kbias = {}, 0.0
    for mod in pop.module_names():
        mine = dict(getattr(solo, mod).named_parameters())
        gaps[mod] = 0.0
        for name, t_ in getattr(pop, mod).named_parameters():
            e = (t_.detach()[member] - mine[name].detach()).abs().max().item()
            if name.endswith("attn.k.bias"):  # zero gradient in exact arithmetic
                kbias = max(kbias, e)
            else:
                gaps[mod] = max(gaps[mod], e)
    loss_gap = max(abs(float(m[k][member]) - float(sm[k])) / max(1.0, abs(float(sm[k])))
                   for k in ("loss_q", "loss_pi"))
    check(max(gaps.values()) <= 1e-4 and loss_gap <= 1e-4 and kbias <= 2 * cfg.lr * updates,
          f"member {member} vs a lone learner: params {gaps}, key biases {kbias}, "
          f"losses {loss_gap}")
    return {"population": p, "member": member, "updates": updates, "max_param_gap": gaps,
            "max_key_bias_gap": kbias, "loss_rel_gap": loss_gap, "tol": 1e-4,
            "key_bias_tol": 2 * cfg.lr * updates}


def _host_population_run(kernels, args, what: str, per_step: dict, per_update: dict,
                         steps: int, start: int, runs: str, prepare=None, on_trace=None):
    """``train.build_trainer`` on ``args`` (one epoch of ``steps`` lockstep
    steps, ``start`` random), traced: every policy step of all members
    launched exactly ``per_step`` of each kernel (the wrappers' count,
    less the warm-up and captured updates') and every update exactly
    ``per_update`` (the device's count through the graphs against the
    wrappers'); returns the trainer and the run's row. ``prepare(trainer)``
    runs before the epoch, ``on_trace(prof)`` on the kept trace."""
    from torch_actor_critic_tpu_torch import train as train_cli
    from torch_actor_critic_tpu_torch.sac.graph import WARMUP_UPDATES

    cli = train_cli.parse_arguments([*args, "--device", "cuda", "--epochs", "1",
                                     "--steps-per-epoch", str(steps), "--start-steps",
                                     str(start), "--update-after", str(start),
                                     "--runs-root", runs])

    def drive():
        trainer, _ = train_cli.build_trainer(cli)
        if prepare is not None:
            prepare(trainer)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = trainer.train()
        torch.cuda.synchronize()
        return trainer, metrics, time.perf_counter() - t0, dict(kernels.launch_counts)

    (trainer, metrics, train_s, wrapped), launches = traced(
        drive, what, discard=lambda out: out[0].close(), on_trace=on_trace)
    cfg = trainer.config
    p = trainer.population
    updates = trainer.state.step
    check(updates == (steps - start) // cfg.update_every * cfg.updates_per_window
          and trainer.sac.graph_captures == 1,
          f"{what}: {updates} updates, {trainer.sac.graph_captures} captures")
    keys = {"loss_q", "loss_pi", *(f"reward_m{i}" for i in range(p))}
    check(keys <= set(metrics) and all(math.isfinite(metrics[k]) for k in keys),
          f"{what}: metrics {metrics}")
    # The eager launches: acting (one stacked forward a lockstep step for
    # all members), then each capture's warm-up and recorded update.
    recorded = trainer.sac.graph_captures * (WARMUP_UPDATES + 1)
    want_wrapped = {k: per_step.get(k, 0) * (steps - start) + recorded * n
                    for k, n in per_update.items()}
    check({k: wrapped.get(k, 0) for k in per_update} == want_wrapped,
          f"{what}: wrapper launches {wrapped} != {want_wrapped} ({steps - start} policy "
          f"steps of {per_step}, {recorded} eager updates)")
    check_through_graphs(what, launches, wrapped, per_update, updates,
                         trainer.sac.graph_captures)
    row = {"population": p, "steps": steps, "updates": updates, "train_s": train_s,
           "ring_rows_per_member": trainer.buffer.capacity,
           "ring_bytes": sum(x.nbytes for _, x in trainer.buffer.data.named_leaves()),
           "epoch_grad_steps_per_sec": metrics["grad_steps_per_sec"],
           "epoch_env_steps_per_sec": metrics["env_steps_per_sec"],
           "launches": launches, "wrapper_launches": wrapped,
           "per_step": per_step, "per_update": per_update,
           "rewards": [metrics[f"reward_m{i}"] for i in range(p)]}
    return trainer, row


def _captured_burst_rate(learner, state, ring, seed: int, per: int) -> float:
    """Updates per second of a captured ``per``-update burst alone, from
    clones (four timed after one that captures)."""
    from torch_actor_critic_tpu_torch.buffer.replay import sample

    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    st, buf = state.clone(), ring.clone()
    chunk = sample(buf, 50, generator=gen)
    st, buf, _ = learner.update_burst(st, buf, chunk, per)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        st, buf, _ = learner.update_burst(st, buf, chunk, per)
    torch.cuda.synchronize()
    return 4 * per / (time.perf_counter() - t0)


def host_populations(seed: int, kernels, smi: str) -> tuple:
    """The host-loop populations through the CLI's builders: the sequence
    stack (P = 4, history 16: exactly 10 K2 and 4 K3 / 4 K4 per update
    and 2 K2 per policy step for all members) and the pixel recipe (P = 4:
    exactly 1 K1 per update, none acting), each traced through its graphs, its captured burst against
    the eager one from clones (the pixel one on cuDNN's deterministic
    algorithms), a member against a lone learner, bursts of alternating
    sizes replaying one graph, an in-place restore under the graph with
    no capture, ``evaluate()``'s ``per_member``; gradient steps per second
    at P = 4 against the solo host trainer (P = 1). Returns the row and
    the traced launches."""
    from torch_actor_critic_tpu_torch import train as train_cli
    from torch_actor_critic_tpu_torch.buffer.replay import sample
    from torch_actor_critic_tpu_torch.sac.population import make_population_learner

    out, launches = {}, {}
    runs = tempfile.mkdtemp(prefix="tac_chip_host_population_")
    try:
        for name, args, per_step, per_update, steps, start in (
                ("sequence", HOST_SEQ_ARGS, {"flash_fwd": 2},
                 {"flash_fwd": 10, "flash_bwd_dq": 4, "flash_bwd_dkv": 4}, 300, 100),
                ("pixel", HOST_PIXEL_ARGS, {}, {"pixel_gather": 1}, 600, 200)):
            seen: dict = {}
            trainer, row = _host_population_run(
                kernels, [*args, "--seed", str(seed)], f"host population {name}", per_step,
                per_update, steps, start, runs,
                on_trace=(lambda prof: seen.update(stream_overlap(prof))) if per_step else None)
            if per_step:
                # Without actor_param_lag acting runs on the burst's stream.
                check(seen["side_stream_flash_fwd"] == 0 and seen["overlap_us"] == 0,
                      f"host population {name}: K2 off the burst's stream: {seen}")
                row["overlap"] = seen
            for k, v in row["launches"].items():
                launches[k] = launches.get(k, 0) + v
            cfg, act_dim = trainer.config, trainer.pool.act_dim
            gen = torch.Generator(device="cuda").manual_seed(seed + 13)
            row["captured_vs_eager"] = compare_bursts(
                lambda: make_population_learner(cfg, act_dim, HOST_POP), trainer.state,
                trainer.buffer, [sample(trainer.buffer, cfg.update_every, generator=gen)
                                 for _ in range(2)], cfg.updates_per_window,
                eager_twice=name == "pixel")
            row["member_vs_solo"] = burst_member_vs_solo(
                trainer.sac, trainer.state, trainer.buffer, trainer.obs_shape, act_dim,
                trainer.pool.act_limit, seed)
            # Alternating burst sizes replay the graph captured for the larger.
            chunk = sample(trainer.buffer, cfg.update_every, generator=gen)
            for n in (50, 20, 50, 20):
                trainer.state, trainer.buffer, m = trainer.sac.update_burst(
                    trainer.state, trainer.buffer, chunk, n)
            torch.cuda.synchronize()
            check(trainer.sac.graph_captures == 1 and bool(torch.isfinite(m["loss_q"]).all()),
                  f"host population {name}: {trainer.sac.graph_captures} captures after "
                  "bursts of 50 and 20")
            if name == "sequence":
                # Restored in place under the graph (the checkpoint's learner,
                # rings, normalizer and acting generator), the same burst twice:
                # bitwise, no new capture. (The pixel update's default cuDNN
                # convolutions are not bitwise run to run.)
                trainer.checkpointer.wait()
                snaps = []
                for _ in range(2):
                    trainer.restore()
                    trainer.state, trainer.buffer, _ = trainer.sac.update_burst(
                        trainer.state, trainer.buffer, chunk, cfg.updates_per_window)
                    torch.cuda.synchronize()
                    snaps.append(learner_snapshot(trainer))
                diff = bitwise_diff(*snaps)
                check(not diff and trainer.sac.graph_captures == 1,
                      f"host population {name}: restore under the graph differs at "
                      f"{diff[:8]}, {trainer.sac.graph_captures} captures")
                row["restore_under_graph"] = {"bitwise": True, "captures": 1}
            ev = trainer.evaluate(episodes=1, seed=seed)
            check(len(ev["per_member"]) == HOST_POP and math.isfinite(ev["ep_ret_mean"]),
                  f"host population {name}: evaluate {ev}")
            row["evaluate"] = ev
            row["burst_updates_per_sec"] = _captured_burst_rate(
                trainer.sac, trainer.state, trainer.buffer, seed, cfg.updates_per_window)
            row["burst_grad_steps_per_sec"] = row["burst_updates_per_sec"] * HOST_POP
            trainer.close()
            del trainer
            torch.cuda.empty_cache()
            # The solo host trainer (P = 1) at the same config.
            solo_args = [a for a in args if a not in ("--population", str(HOST_POP))]
            solo, _ = train_cli.build_trainer(train_cli.parse_arguments(
                [*solo_args, "--seed", str(seed), "--device", "cuda", "--epochs", "1",
                 "--steps-per-epoch", str(steps), "--start-steps", str(start),
                 "--update-after", str(start), "--runs-root", runs]))
            seen = solo.train()
            row["solo"] = {"epoch_grad_steps_per_sec": seen["grad_steps_per_sec"],
                           "epoch_env_steps_per_sec": seen["env_steps_per_sec"],
                           "burst_updates_per_sec": _captured_burst_rate(
                               solo.sac, solo.state, solo.buffer, seed,
                               solo.config.updates_per_window)}
            solo.close()
            del solo
            torch.cuda.empty_cache()
            print(f"host population {name} P={HOST_POP}: "
                  f"{row['epoch_grad_steps_per_sec']:.1f} grad steps/s (epoch, x P), "
                  f"{row['burst_grad_steps_per_sec']:.1f} (captured burst, x P); solo "
                  f"{row['solo']['epoch_grad_steps_per_sec']:.1f} / "
                  f"{row['solo']['burst_updates_per_sec']:.1f} ({smi})", flush=True)
            out[name] = row
    finally:
        shutil.rmtree(runs, ignore_errors=True)
    return out, launches


def _rate_row(loop, p: int, dt: float, updates: int) -> dict:
    return {"population": p, "seconds": dt, "grad_steps_per_sec": updates * p / dt,
            "env_steps_per_sec": 1000 * loop.n_envs * p / dt}


def _fused_rates(args, seed: int, warmup: int, members=(1, 8)) -> dict:
    """Untraced fused-population epochs at each P of ``members`` on
    ``FUSED_RING``-row rings: after a warm-up and one 1000-step epoch
    (which captures), one timed 1000-step epoch: aggregate gradient and
    env steps per second (both × P)."""
    out = {}
    for p in members:
        torch.cuda.empty_cache()
        cfg, loop = _population_loop(args, seed, FUSED_RING, members=p)
        parts = loop.init(seed, FUSED_RING)[:4]
        parts = loop.epoch(*parts, steps=warmup, update_every=50, warmup=True)[:4]
        parts = loop.epoch(*parts, steps=1000, update_every=50)[:4]
        parts, m, dt = _timed_epoch(loop, parts, 1000)
        check(bool(torch.isfinite(m["loss_q"]).all()), f"fused rates P={p}: {m['loss_q']}")
        out[f"P{p}"] = _rate_row(loop, p, dt, 1000 // 50 * cfg.updates_per_window)
        del loop, parts
    torch.cuda.empty_cache()
    return out


def fused_pixel_population(seed: int, kernels, smi: str) -> tuple:
    """The pixel recipe's fused population (P = 8, the balance twin) on
    ``FUSED_RING``-row rings: a traced 1000-step epoch with exactly 1 K1
    per update for all members (none per acting step), then a timed one
    (the P = 8 rate; P = 1 from :func:`_fused_rates`); on
    ``CHECK_RING``-row rings, captured against eager epochs on cuDNN's
    deterministic algorithms and a member against a lone learner."""
    from torch_actor_critic_tpu_torch.sac.ondevice import _SpecView

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, loop = _population_loop(PIXEL_POP_ARGS, seed, FUSED_RING)
    parts = loop.init(seed, FUSED_RING)[:4]
    ring_bytes = sum(x.nbytes for _, x in parts[1].data.named_leaves())
    parts = loop.epoch(*parts, steps=1000, update_every=50, warmup=True)[:4]
    parts, m, traced_row = _population_counts(loop, parts, 1000, kernels,
                                              "fused pixel population P=8", per_step={},
                                              per_update={"pixel_gather": 1})
    parts, m, dt = _timed_epoch(loop, parts, 1000)
    check(bool(torch.isfinite(m["loss_q"]).all()), f"fused pixel P=8: {m['loss_q']}")
    rates = {"P8": _rate_row(loop, 8, dt, 1000 // 50 * cfg.updates_per_window)}
    row = {"population": 8, "ring_rows_per_member": FUSED_RING, "ring_bytes": ring_bytes,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "check_ring_rows_per_member": CHECK_RING, "traced_epoch": traced_row}
    del loop, parts
    rates.update(_fused_rates(PIXEL_POP_ARGS, seed, 1000, members=(1,)))
    row["rates"] = rates
    cfg, loop = _population_loop(PIXEL_POP_ARGS, seed, CHECK_RING)
    parts = loop.init(seed, CHECK_RING)[:4]
    parts = loop.epoch(*parts, steps=1000, update_every=50, warmup=True)[:4]
    spec = _SpecView(loop.env)
    row["member_vs_solo"] = burst_member_vs_solo(loop.sac, parts[0], parts[1], spec.obs_shape,
                                                 spec.act_dim, spec.act_limit, seed)
    row["captured_vs_eager"] = ondevice_captured_vs_eager(
        lambda: _population_loop(PIXEL_POP_ARGS, seed, CHECK_RING)[1], parts)
    del loop, parts
    torch.cuda.empty_cache()
    print(f"fused pixel population: {rates['P8']['grad_steps_per_sec']:.1f} grad "
          f"steps/s at P=8 (x P), {rates['P1']['grad_steps_per_sec']:.1f} at P=1, rings "
          f"{ring_bytes / 2**30:.2f} GiB, peak {row['max_memory_allocated_bytes'] / 2**30:.2f} "
          f"GiB ({smi})", flush=True)
    return row, traced_row["launches"]


def fused_td3_population(seed: int, smi: str) -> dict:
    """The fused TD3 population with PBT (P = 8, the pendulum twin, rings
    of the CLI's default ``FUSED_RING`` rows) through ``train.main``: two
    1000-step epochs, a PBT step after each, each checked in place
    (:class:`PBTChecks`: the target actor among the member tensors,
    ``target_noise`` among the hyperparameters), at least one exploit;
    captured against eager epochs, a member against a lone learner, the
    rates at P = 1 and 8."""
    from torch_actor_critic_tpu_torch import train as train_cli
    from torch_actor_critic_tpu_torch.sac.ondevice import PopulationOnDeviceLoop, _SpecView

    runs = tempfile.mkdtemp(prefix="tac_chip_td3_population_")
    try:
        t0 = time.perf_counter()
        with PBTChecks(PopulationOnDeviceLoop, 1.25) as pbt:
            final = train_cli.main([*TD3_POP_ARGS, "--epochs", "2", "--steps-per-epoch", "1000",
                                    "--no-save-buffer", "--runs-root", runs,
                                    "--seed", str(seed)])
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(runs, ignore_errors=True)
    losses = [final[f"loss_q_m{i}"] for i in range(8)]
    check(all(math.isfinite(x) for x in losses), f"TD3 population losses {losses}")
    check(len(pbt.steps) == 2 and any(s["exploited"] for s in pbt.steps),
          f"TD3 population PBT steps {pbt.steps}")
    row = {"population": 8, "ring_rows_per_member": FUSED_RING, "seconds": seconds,
           "pbt_steps": pbt.steps,
           "final": {k: final[k] for k in ("loss_q", "loss_pi", "reward", "episodes",
                                           "grad_steps_per_sec", "pbt_exploits")}}
    cfg, loop = _population_loop(TD3_POP_ARGS, seed, FUSED_RING, pbt=True)
    parts = loop.init(seed, FUSED_RING)[:4]
    parts = loop.epoch(*parts, steps=1000, update_every=50, warmup=True)[:4]
    check("target_noise" in parts[0].hyperparams and parts[0].target_actor is not None,
          "TD3 population: no target_noise hyperparameter or target actor")
    spec = _SpecView(loop.env)
    row["member_vs_solo"] = burst_member_vs_solo(loop.sac, parts[0], parts[1], spec.obs_shape,
                                                 spec.act_dim, spec.act_limit, seed)
    row["captured_vs_eager"] = ondevice_captured_vs_eager(
        lambda: _population_loop(TD3_POP_ARGS, seed, FUSED_RING, pbt=True)[1], parts)
    del loop, parts
    row["rates"] = _fused_rates(TD3_POP_ARGS, seed, 1000)
    print(f"fused TD3 population: {row['rates']['P8']['grad_steps_per_sec']:.1f} grad steps/s "
          f"at P=8 (x P), {row['rates']['P1']['grad_steps_per_sec']:.1f} at P=1 ({smi})",
          flush=True)
    return row


def phase_populations(seed: int, kernels, attn, pixels, smi: str) -> dict:
    """The host-loop, pixel and TD3 populations:

    - K2 at the host sequence population's folds (acting (4, 4, 16, 16),
      update (256, ...), critics (512, ...)), K3/K4 at the update and
      critics' folds, against their plain versions; K1 at the fused pixel
      population's member fold, bitwise;
    - the host-loop populations (:func:`host_populations`);
    - the fused pixel population (:func:`fused_pixel_population`);
    - the fused TD3 population with PBT (:func:`fused_td3_population`).

    Returns the traced launches of the host populations and the fused
    pixel one."""
    row = {"phase": "populations", "card": smi, "seconds": {}}
    t_phase = t0 = time.perf_counter()

    def lap(what):
        nonlocal t0
        row["seconds"][what] = time.perf_counter() - t0
        t0 = time.perf_counter()

    fwd = phase_kernel_vs_plain(attn, seed, None, cases=[
        (HOST_POP_ACT_SHAPE, True, torch.float32, 100, "views"),
        (HOST_POP_SHAPE, True, torch.float32, 100, "views"),
        (HOST_POP_CRITIC_SHAPE, True, torch.float32, 100, "views"),
    ])
    bwd = phase_bwd_vs_plain(attn, seed, None, cases=[
        (HOST_POP_SHAPE, True, torch.float32, 100, "views"),
        (HOST_POP_CRITIC_SHAPE, True, torch.float32, 100, "views"),
    ])
    row["kernels_host_population"] = {"flash_fwd_act": fwd["shape"],
                                      "flash_bwd": bwd["flash_bwd_dq"]["shape"]}
    row["pixel_fold"] = pixel_fold_row(pixels, seed)
    lap("kernel_rows")
    row["host"], launches = host_populations(seed, kernels, smi)
    lap("host")
    row["fused_pixel"], pixel_launches = fused_pixel_population(seed, kernels, smi)
    launches["pixel_gather"] = launches.get("pixel_gather", 0) + pixel_launches["pixel_gather"]
    lap("fused_pixel")
    torch.cuda.empty_cache()
    row["fused_td3"] = fused_td3_population(seed, smi)
    lap("fused_td3")
    row["seconds"]["phase"] = time.perf_counter() - t_phase
    row["launches"] = launches
    emit(row)
    return launches


# The host env plane: the native parallel env pool (one worker process per
# env over the futex runtime, built from torch_actor_critic_tpu_torch/native)
# and acting one window stale on its own stream (actor_param_lag), on the
# host sequence population (HOST_SEQ_ARGS: P = 4, 300 lockstep steps) and the
# host pixel population (HOST_PIXEL_ARGS: P = 4, 600 steps); the pools at
# n = 4 on both envs for POOL_STEPS lockstep steps.
POOL_STEPS = 200
# The trainer runs fork their env workers from a forkserver that imported
# the pool once (phase_host_env_plane preloads it): a spawn imports torch in
# every worker, ~10 s a pool on the card's machine. The pools check spawns
# the first pool's workers (the default).
PARALLEL_ARGS = ["--parallel-envs", "true", "--env-start-method", "forkserver"]
LAG_ARGS = ["--actor-param-lag", "true"]
HOST_SEQ_CONFIGS = {"sequential": [], "parallel": PARALLEL_ARGS, "lag": LAG_ARGS,
                    "parallel_lag": [*PARALLEL_ARGS, *LAG_ARGS]}


def compute_app_pids() -> list:
    """The pids ``nvidia-smi`` lists as holding a compute context on the
    card (host pids: in a container they need not match its own)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout
    return sorted(int(x) for x in out.split() if x.strip().isdigit())


def nvidia_fds(pid: int) -> int:
    """How many of process ``pid``'s open files are the card's device
    nodes (``/dev/nvidia*``): a process holding a CUDA context has them
    open; one that never touched the card has none."""
    fds, n = f"/proc/{pid}/fd", 0
    for fd in os.listdir(fds):
        try:
            n += os.readlink(os.path.join(fds, fd)).startswith("/dev/nvidia")
        except FileNotFoundError:  # closed since the listing (the listing's own)
            pass
    return n


def _step_outputs_equal(a, b) -> bool:
    """Two pools' outputs (observations, or ``step``'s tuples) equal to the
    bit, each leaf in its own dtype."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_step_outputs_equal(x, y) for x, y in zip(a, b))
    if hasattr(a, "frame"):
        return (_step_outputs_equal(a.features, b.features)
                and _step_outputs_equal(a.frame, b.frame))
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def pools_on_the_card(seed: int) -> dict:
    """For each env (the history-16 pendulum's workers spawned, the
    default; the pixel twin's forked from the forkserver the trainer runs
    use, started here): ``make_env_pool(parallel=True)`` returns a
    ``ParallelEnvPool`` (so the sequential fallback cannot hide a failed
    build), none of its workers holds a context on the card (none is
    among ``nvidia-smi``'s compute apps or has a device node open, which
    the parent has), and it
    equals the sequential pool step for step, bitwise, over ``POOL_STEPS``
    lockstep steps of one action sequence; each pool's env steps/s."""
    from torch_actor_critic_tpu_torch import native
    from torch_actor_critic_tpu_torch.envs.vec_env import (
        ParallelEnvPool,
        SequentialEnvPool,
        make_env_pool,
    )

    t0 = time.perf_counter()
    check(native.load_runtime() is not None, "the native runtime did not build or load")
    here = os.path.dirname(os.path.abspath(__file__))
    out = {"runtime": {"library": os.path.relpath(native.lib_path(), here),
                       "build_and_load_s": time.perf_counter() - t0}}
    for env, method in ((f"{TRAIN_ENV}|history:16", "spawn"), (VISUAL_ENV, "forkserver")):
        t0 = time.perf_counter()
        par = make_env_pool(env, HOST_POP, base_seed=seed, parallel=True, start_method=method)
        start_s = time.perf_counter() - t0
        seq = SequentialEnvPool(env, HOST_POP, base_seed=seed)
        try:
            check(isinstance(par, ParallelEnvPool), f"{env}: make_env_pool gave {type(par)}")
            on_card = compute_app_pids()
            fds = {pid: nvidia_fds(pid) for pid in par.pids}
            check(not set(par.pids) & set(on_card) and not any(fds.values())
                  and nvidia_fds(os.getpid()) > 0,
                  f"{env}: env workers {par.pids} hold a context on the card (compute apps "
                  f"{on_card}, device files open {fds}, the parent's "
                  f"{nvidia_fds(os.getpid())})")
            rng = np.random.default_rng(seed)
            actions = [rng.uniform(-par.act_limit, par.act_limit,
                                   (HOST_POP, par.act_dim)).astype(np.float32)
                       for _ in range(POOL_STEPS)]
            seeds = [seed + 10000 * i for i in range(HOST_POP)]
            runs = {}
            for name, pool in (("parallel", par), ("sequential", seq)):
                first = pool.reset_all(seeds)
                t0 = time.perf_counter()
                steps = [pool.step(a) for a in actions]
                runs[name] = ([first, *steps], POOL_STEPS * HOST_POP / (time.perf_counter() - t0))
            same = all(_step_outputs_equal(x, y)
                       for x, y in zip(runs["parallel"][0], runs["sequential"][0]))
            check(same, f"{env}: the parallel pool differs from the sequential pool")
            out[env] = {"pool": type(par).__name__, "n": HOST_POP, "steps": POOL_STEPS,
                        "start_method": method, "start_s": start_s, "worker_pids": par.pids,
                        "compute_app_pids": on_card, "parent_pid": os.getpid(),
                        "worker_device_files": fds,
                        "parent_device_files": nvidia_fds(os.getpid()),
                        "bitwise_vs_sequential": True,
                        "parallel_env_steps_per_sec": runs["parallel"][1],
                        "sequential_env_steps_per_sec": runs["sequential"][1]}
        finally:
            par.close()
            seq.close()
    return out


def stream_overlap(prof) -> dict:
    """From a trace's raw device events: the K2 kernels on the streams that
    ran no K3 (the burst's streams run K3: its replays and its capture's
    warm-up), and how much of their time overlaps the union of the burst
    streams' kernels. Without the lag acting runs on the burst's stream
    and nothing can overlap."""
    from torch.autograd import DeviceType

    by_stream: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        by_stream.setdefault(e.device_resource_id(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    burst = {sid for sid, evs in by_stream.items()
             if any(KERNEL_SYMBOLS["flash_bwd_dq"] in name for *_, name in evs)}
    check(bool(burst), "the trace holds no K3 kernel")
    union: list = []
    for a, b, _ in sorted(ev for sid in burst for ev in by_stream[sid]):
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    starts = [a for a, _ in union]
    acting = [(a, b) for sid, evs in by_stream.items() if sid not in burst
              for a, b, name in evs if KERNEL_SYMBOLS["flash_fwd"] in name]
    overlaps = []
    for a, b in acting:
        i, ns = max(bisect.bisect_right(starts, a) - 1, 0), 0
        while i < len(union) and union[i][0] < b:
            ns += max(0, min(b, union[i][1]) - max(a, union[i][0]))
            i += 1
        overlaps.append(ns)
    return {"streams": len(by_stream), "burst_streams": len(burst),
            "side_stream_flash_fwd": len(acting),
            "overlapping_flash_fwd": sum(ns > 0 for ns in overlaps),
            "overlap_us": sum(overlaps) / 1e3,
            "side_stream_flash_fwd_us": sum(b - a for a, b in acting) / 1e3}


def _actor_tensors(module) -> list:
    return [t.detach().clone() for t in itertools.chain(module.parameters(), module.buffers())]


def _watch_bursts(trainer, actor: bool) -> dict:
    """Wrap ``trainer``'s bursts: the host's milliseconds in each burst run
    at once (``burst_ms``: the push and the replays' enqueue) and in each
    spread burst's ``finish`` at the window's end (``finish_ms``: what was
    left to enqueue), and, with ``actor``, the actor's parameters as they
    stand before each burst."""
    seen = {"pre": [], "burst_ms": [], "finish_ms": []}
    sac = trainer.sac
    update_burst, start_burst, finish = sac.update_burst, sac.start_burst, trainer._finish_burst

    def pre():
        if actor:
            seen["pre"].append(_actor_tensors(trainer.state.actor))

    def burst(*a, **k):
        pre()
        t0 = time.perf_counter()
        out = update_burst(*a, **k)
        seen["burst_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def start(*a, **k):
        pre()
        return start_burst(*a, **k)

    def finish_burst():
        t0 = time.perf_counter()
        m = finish()
        if m is not None:
            seen["finish_ms"].append((time.perf_counter() - t0) * 1e3)
        return m

    sac.update_burst, sac.start_burst, trainer._finish_burst = burst, start, finish_burst
    return seen


def host_sequence_plane(seed: int, kernels, runs: str) -> tuple:
    """The host sequence population in the four configurations of
    ``HOST_SEQ_CONFIGS``, each untraced for two epochs: the second epoch's
    rates (all policy steps, no capture) and the host's time in each
    burst (``_watch_bursts``). Parallel + lag traced too, for one epoch: 2
    K2 per policy step, 10 K2 and 4 K3 / 4 K4 per update through the
    graph; the acting stream's K2 kernels overlap the burst's (the
    populations phase's trace of the sequential configuration holds
    none off the burst's stream); the snapshot after the epoch is the
    actor from before the last burst, bitwise, not the live one; and the
    untraced run's first epoch leaves the same learner, ring and acting
    generator, bitwise."""
    from torch_actor_critic_tpu_torch import train as train_cli

    per_step = {"flash_fwd": 2}
    per_update = {"flash_fwd": 10, "flash_bwd_dq": 4, "flash_bwd_dkv": 4}
    bursts: dict = {}
    seen: dict = {}
    trainer, row = _host_population_run(
        kernels, [*HOST_SEQ_ARGS, *HOST_SEQ_CONFIGS["parallel_lag"], "--seed", str(seed)],
        "host_env_plane parallel_lag", per_step, per_update, 300, 100, runs,
        prepare=lambda tr: bursts.update(_watch_bursts(tr, actor=True)),
        on_trace=lambda prof: seen.update(stream_overlap(prof)))
    check(type(trainer.pool).__name__ == "ParallelEnvPool",
          f"host_env_plane parallel_lag: pool {type(trainer.pool).__name__}")
    check(seen["overlapping_flash_fwd"] > 0 and seen["overlap_us"] > 0,
          f"host_env_plane parallel_lag: no acting K2 overlapped the burst: {seen}")
    acting, live = _actor_tensors(trainer._acting), _actor_tensors(trainer.state.actor)
    same_pre = all(torch.equal(x, y) for x, y in zip(acting, bursts["pre"][-1], strict=True))
    differs = not all(torch.equal(x, y) for x, y in zip(acting, live, strict=True))
    check(same_pre and differs, "host_env_plane parallel_lag: the snapshot is "
          f"{'not ' if not same_pre else ''}the pre-burst actor, "
          f"{'equal to' if not differs else 'apart from'} the live one")
    row.update(snapshot={"equals_pre_last_burst": True, "differs_from_live": True,
                         "bursts": len(bursts["pre"])}, overlap=seen,
               burst_host_ms={"at_once": bursts["burst_ms"], "finish": bursts["finish_ms"]})
    launches, keep = dict(row["launches"]), learner_snapshot(trainer)
    trainer.close()
    del trainer
    torch.cuda.empty_cache()
    out = {"parallel_lag": {"traced": row}}
    # Untraced, two epochs: the first is the traced run's (for parallel +
    # lag, its end state bitwise the traced run's); the second, all policy
    # steps and no capture, gives the rates.
    for name, flags in HOST_SEQ_CONFIGS.items():
        cli = train_cli.parse_arguments([
            *HOST_SEQ_ARGS, *flags, "--seed", str(seed), "--device", "cuda", "--epochs", "2",
            "--steps-per-epoch", "300", "--start-steps", "100", "--update-after", "100",
            "--runs-root", runs])
        trainer, _ = train_cli.build_trainer(cli)
        check(type(trainer.pool).__name__ == ("ParallelEnvPool" if "parallel" in name
                                              else "SequentialEnvPool")
              and (trainer._acting is not None) == ("lag" in name)
              and not any(nvidia_fds(pid) for pid in getattr(trainer.pool, "pids", ())),
              f"host_env_plane {name}: pool {type(trainer.pool).__name__}, or a worker "
              "holds a device node")
        bursts = _watch_bursts(trainer, actor=False)
        first: dict = {}
        metrics = trainer.train(on_epoch=lambda e, m, first=first, trainer=trainer: first.update(
            {} if e else {"snapshot": learner_snapshot(trainer), "metrics": m}))
        torch.cuda.synchronize()
        row = out.setdefault(name, {})
        if name == "parallel_lag":
            diff = bitwise_diff(keep, first["snapshot"])
            check(not diff, f"host_env_plane {name}: two runs from one seed differ at "
                            f"{diff[:8]}")
            row["bitwise_vs_traced_run"] = True
        row.update(epoch_grad_steps_per_sec=metrics["grad_steps_per_sec"],
                   epoch_env_steps_per_sec=metrics["env_steps_per_sec"],
                   first_epoch_grad_steps_per_sec=first["metrics"]["grad_steps_per_sec"],
                   burst_host_ms={"at_once": bursts["burst_ms"],
                                  "finish": bursts["finish_ms"]})
        trainer.close()
        del trainer
        torch.cuda.empty_cache()
    return out, launches


def ring_sizing(trainers_rings: list) -> dict:
    """On the card, with nothing allocated for them: the warning's verdicts
    for the host pixel population's rings at the CLI's 10^6 rows per
    member, P = 4 (none) and P = 8 (warns); and ``nbytes`` of rings this
    phase allocated against ``estimate_buffer_bytes`` at capacity · P
    (plus the one device size)."""
    from torch_actor_critic_tpu_torch.buffer import replay
    from torch_actor_critic_tpu_torch.core.types import MultiObservation

    class Seen(logging.Handler):
        def __init__(self):
            super().__init__()
            self.records = []

        def emit(self, record):
            self.records.append(record.getMessage())

    seen = Seen()
    replay.logger.addHandler(seen)
    verdicts = {}
    try:
        for p in (4, 8):
            del seen.records[:]
            replay.warn_if_buffer_exceeds_hbm(10**6 * p, MultiObservation((1,), (32, 32, 3)), 1,
                                              "cuda", advice="reduce --buffer-size or "
                                              "--population")
            verdicts[f"P{p}"] = {
                "bytes": replay.estimate_buffer_bytes(10**6 * p,
                                                      MultiObservation((1,), (32, 32, 3)), 1),
                "warns": bool(seen.records), "message": seen.records[:1]}
    finally:
        replay.logger.removeHandler(seen)
    total = torch.cuda.mem_get_info()[1]
    check(not verdicts["P4"]["warns"] and verdicts["P8"]["warns"],
          f"ring warnings at 10^6 rows per member: {verdicts} (card total {total})")
    rings = []
    for what, ring, obs_shape, act_dim, members in trainers_rings:
        want = replay.estimate_buffer_bytes(ring.capacity * members, obs_shape, act_dim) + 8
        got = replay.nbytes(ring)
        check(got == want, f"{what}: nbytes {got} != estimate {want}")
        rings.append({"ring": what, "nbytes": got, "estimate_plus_size": want})
    return {"card_total_bytes": total, "verdicts": verdicts, "rings": rings}


def phase_host_env_plane(seed: int, kernels, smi: str) -> dict:
    """The host env plane on the card:

    - the native runtime built from the checkout, the parallel pool
      (``pools_on_the_card``);
    - the host sequence population in four configurations
      (``host_sequence_plane``);
    - the host pixel population with parallel + lag, 600 steps: 1 K1 per
      update, its rates; two eager updates of it from one state bitwise on
      the package's cuDNN setting;
    - ring sizing (``ring_sizing``).

    The trainers' workers fork from a forkserver that has imported the
    pool (``PARALLEL_ARGS``). Returns the traced launches."""
    from torch_actor_critic_tpu_torch.buffer.replay import sample
    from torch_actor_critic_tpu_torch.envs import vec_env
    from torch_actor_critic_tpu_torch.sac.population import make_population_learner

    multiprocessing.get_context("forkserver").set_forkserver_preload([vec_env.__name__])
    row = {"phase": "host_env_plane", "card": smi, "seconds": {}}
    t_phase = t0 = time.perf_counter()

    def lap(what):
        nonlocal t0
        row["seconds"][what] = time.perf_counter() - t0
        t0 = time.perf_counter()

    row["pools"] = pools_on_the_card(seed)
    emit({"phase": "host_env_plane.pools", **row["pools"]})
    lap("pools")
    runs = tempfile.mkdtemp(prefix="tac_chip_host_env_plane_")
    try:
        row["sequence"], launches = host_sequence_plane(seed, kernels, runs)
        lap("sequence")
        trainer, pixel = _host_population_run(
            kernels, [*HOST_PIXEL_ARGS, *PARALLEL_ARGS, *LAG_ARGS, "--seed", str(seed)],
            "host_env_plane pixel parallel_lag", {}, {"pixel_gather": 1}, 600, 200, runs)
        for k, v in pixel["launches"].items():
            launches[k] = launches.get(k, 0) + v
        cfg, act_dim = trainer.config, trainer.pool.act_dim
        check(type(trainer.pool).__name__ == "ParallelEnvPool" and trainer._acting is not None,
              f"host_env_plane pixel: pool {type(trainer.pool).__name__}")
        gen = torch.Generator(device="cuda").manual_seed(seed + 17)
        pixel["eager_updates"] = compare_bursts(
            lambda: make_population_learner(cfg, act_dim, HOST_POP), trainer.state,
            trainer.buffer, [sample(trainer.buffer, cfg.update_every, generator=gen)
                             for _ in range(2)], 1, eager_twice=True)
        lap("pixel")
        row["pixel"] = pixel
        row["ring_sizing"] = ring_sizing([
            ("host pixel population", trainer.buffer, trainer.obs_shape, act_dim, HOST_POP)])
        trainer.close()
        lap("ring_sizing")
    finally:
        shutil.rmtree(runs, ignore_errors=True)
    seq = row["sequence"]
    print("host env plane: host sequence population P=4, untraced epoch grad steps/s (x P) "
          "/ env steps/s: " + ", ".join(
              f"{k} {v['epoch_grad_steps_per_sec']:.1f} / {v['epoch_env_steps_per_sec']:.1f}"
              for k, v in seq.items()) + f"; pixel parallel+lag "
          f"{pixel['epoch_grad_steps_per_sec']:.1f}; pools (parallel / sequential env steps/s) "
          + ", ".join(f"{env} {r['parallel_env_steps_per_sec']:.0f} / "
                      f"{r['sequential_env_steps_per_sec']:.0f}"
                      for env, r in row["pools"].items() if env != "runtime")
          + f" ({smi})", flush=True)
    row["seconds"]["phase"] = time.perf_counter() - t_phase
    row["launches"] = launches
    emit(row)
    return launches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--on-device-phase", action="store_true",
                   help="Run only the on_device phase (the smoke starts it so, in a child)")
    p.add_argument("--population-phase", action="store_true",
                   help="Run only the population phase (the smoke starts it so, in a child)")
    p.add_argument("--populations-phase", action="store_true",
                   help="Run only the populations phase (the smoke starts it so, in a child)")
    p.add_argument("--host-env-plane-phase", action="store_true",
                   help="Run only the host_env_plane phase (the smoke starts it so, in a child)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the GPU only",
              file=sys.stderr)
        return 2
    trace_buffers()
    import torch_actor_critic_tpu_torch  # noqa: F401  (sets full-f32 matmuls)
    from torch_actor_critic_tpu_torch.ops import _kernels, pixels
    from torch_actor_critic_tpu_torch.ops import attention as attn

    if args.on_device_phase:
        launches = phase_on_device(args.seed, _kernels, attn, nvidia_smi())
        emit({"on_device_launches": launches})
        return 0
    if args.population_phase:
        launches = phase_population(args.seed, _kernels, attn, nvidia_smi())
        emit({"population_launches": launches})
        return 0
    if args.populations_phase:
        launches = phase_populations(args.seed, _kernels, attn, pixels, nvidia_smi())
        emit({"populations_launches": launches})
        return 0
    if args.host_env_plane_phase:
        launches = phase_host_env_plane(args.seed, _kernels, nvidia_smi())
        emit({"host_env_plane_launches": launches})
        return 0
    seconds, t_start = {}, time.perf_counter()

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        return out

    smi = timed("device", phase_device)
    timed("build", phase_build, _kernels)
    timed("trace_reader", phase_trace_reader)
    timed("floor", phase_floor, _kernels, attn, args.seed)
    critic_qkv = critic_views(args.seed)
    serve_row = timed("kernel_vs_plain", phase_kernel_vs_plain, attn, args.seed, critic_qkv)
    bwd_rows = timed("bwd_vs_plain", phase_bwd_vs_plain, attn, args.seed, critic_qkv)
    del critic_qkv
    pixel_row = timed("pixel_vs_plain", phase_pixel_vs_plain, pixels, args.seed)["train_pair"]
    serve = timed("serve", phase_serve, args.seed, _kernels, attn, smi)
    serve_launches = serve["flash_fwd"]
    check(serve_launches > 0, "the serving path launched no flash_fwd kernel")
    train_launches = timed("train", phase_train, args.seed, _kernels)
    timed("graph_push", phase_graph_push, args.seed)
    visual_launches = timed("train_visual", phase_train_visual, args.seed, _kernels)
    timed("visual_burst", phase_visual_burst, args.seed, _kernels)
    resume_launches = timed("resume", phase_resume, args.seed, _kernels, smi)
    td3_launches = timed("train_td3", phase_train_td3, args.seed, _kernels, smi)
    ondevice_launches = timed("on_device", in_a_child, "on_device", args.seed, 900)
    population_launches = timed("population", in_a_child, "population", args.seed, 600)
    populations_launches = timed("populations", in_a_child, "populations", args.seed, 600)
    plane_launches = timed("host_env_plane", in_a_child, "host_env_plane", args.seed, 400)
    emit({"phase": "seconds", **seconds, "total": time.perf_counter() - t_start})
    for more in (populations_launches, plane_launches):
        for k, v in more.items():
            population_launches[k] = population_launches.get(k, 0) + v
    fwd_launches = (serve_launches + train_launches["flash_fwd"] + resume_launches["flash_fwd"]
                    + ondevice_launches["flash_fwd"] + population_launches["flash_fwd"])
    rows = [
        ("flash_fwd", "flash_fwd.cu", "torch_actor_critic_tpu/ops/attention.py:428",
         fwd_launches, serve_row),
        # K2 in bf16 at the bf16 serving tier's shape: that tier's served forwards.
        ("flash_fwd_bf16", "flash_fwd.cu", "torch_actor_critic_tpu/ops/attention.py:428",
         serve["flash_fwd_bf16"], serve["bf16_row"]),
        ("flash_bwd_dq", "flash_bwd.cu", "torch_actor_critic_tpu/ops/attention.py:611",
         train_launches["flash_bwd_dq"] + resume_launches["flash_bwd_dq"]
         + ondevice_launches["flash_bwd_dq"] + population_launches["flash_bwd_dq"],
         bwd_rows["flash_bwd_dq"]),
        ("flash_bwd_dkv", "flash_bwd.cu", "torch_actor_critic_tpu/ops/attention.py:634",
         train_launches["flash_bwd_dkv"] + resume_launches["flash_bwd_dkv"]
         + ondevice_launches["flash_bwd_dkv"] + population_launches["flash_bwd_dkv"],
         bwd_rows["flash_bwd_dkv"]),
        ("pixel_gather", "pixels.cu", "torch_actor_critic_tpu/ops/pixels.py:261",
         visual_launches["pixel_gather"] + resume_launches["pixel_gather"]
         + td3_launches["pixel_gather"] + ondevice_launches["pixel_gather"]
         + population_launches.get("pixel_gather", 0), pixel_row),
    ]
    emit({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"torch_actor_critic_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": row["max_abs_err"],
            "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": row["shape"],
        }
        for name, source, replaces, launches, row in rows
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
