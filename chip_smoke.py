"""GPU smoke of the PyTorch port: build, check and time its kernels,
serve the sequence policy over HTTP through the port's CLI path, train
it with SAC through the train CLI's path, then train the visual (pixel)
policy through the same path and run visual bursts at full width, then
preempt, resume, roll back and evaluate training runs from full-state
checkpoints, then train TD3 on the flat and visual stacks, then run the
fused on-device loop (env twins, replay and learner on the card).

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
   unbatched history, deterministic and sampled; every action finite and
   within the limit, deterministic actions equal to the same weights'
   plain-attention forward on the card (1e-4), the flash launch count
   at least num_layers x forwards; /metrics latency and rate; then 16
   64-row requests under ``torch.profiler`` (wall vs device-busy time per
   request, top kernels) and the engine's forward alone (host wall time);
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
   ``--run <id>``.

Then the ``{"kernels": [...]}`` line (``ms``, ``plain_ms`` and
``library_ms`` are device times; K2-K4's numbers are those of their rows
on the model's views; K1's row is ``train_pair``, what the main path
launches, with the launches of train_visual, the visual resume,
train_td3's visual run and the on-device pixel cell; every ``launches``
is counted
in the main path's runs: serving's by the wrappers, as it runs no graph,
training's, the resumed runs' and the on-device epochs' from their
device traces),
the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failed check raises: the exit
code is non-zero and the last line is not printed.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request

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


def traced(fn, what: str, discard=None, attempts: int = 3):
    """``fn()`` under ``torch.profiler``, between ``trace_lead_in`` and
    ``trace_tail``; returns its result and the kernels' launches the
    trace saw (``launches_by_symbol``). A trace with no device kernel at
    all (the card's profiler now and then drops all of a trace's) or
    without the tail's is not read: ``discard(result)`` runs, then
    ``fn()`` again, up to ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trace_lead_in()
            out = fn()
            torch.cuda.synchronize()
            trace_tail()
        rows = traced_rows(prof)
        if rows:
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
    profiler on the card now and then drops a whole trace's kernels (the
    trace is taken again, up to ``attempts`` traces) or a trace's first
    few (a K3 + K4 call alone came back as one kernel in every trace of
    a run); one more kernel per call still shows as ``calls`` more."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(n for _, _, n in device_kernels(prof))
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


def phase_serve(seed: int, kernels) -> int:
    """Drive the CLI's serving path; returns the flash launches counted
    from server start to the last answered request."""
    import numpy as np

    from torch_actor_critic_tpu_torch.models import build_actor
    from torch_actor_critic_tpu_torch.models.sequence import plain_attention
    from torch_actor_critic_tpu_torch.serve.__main__ import (
        build_server,
        parse_arguments,
    )
    from torch_actor_critic_tpu_torch.utils.checkpoint import save_actor
    from torch_actor_critic_tpu_torch.utils.config import SACConfig

    history, obs_dim, act_dim, act_limit = 16, 3, 1, 2.0
    config = SACConfig(history_len=history)  # seq widths: 64 / 4 heads / 2 layers
    actor = build_actor(config, (history, obs_dim), act_dim, act_limit,
                        generator=torch.Generator().manual_seed(seed))
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
            plain = build_actor(config, (history, obs_dim), act_dim, act_limit)
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


def compare_bursts(make_sac, state, ring, chunks, per: int,
                   cudnn_deterministic: bool = False) -> dict:
    """From clones of one learner state and ring (``TrainState.clone``,
    ``BufferState.clone``: modules, target, Adam states with their device
    steps, log α, the generator; the ring with its device size),
    ``len(chunks)`` bursts of ``per`` updates as CUDA graph replays (the
    first: 1 warm-up update, the capture, per - 1 replays; the next all
    replays) and through the eager loop (``eager=True``). Fails unless
    every parameter, Adam moment and step, log α, the generator's state,
    the step count and every burst metric agree to the bit, with one
    capture. ``cudnn_deterministic``: both run on cuDNN's deterministic
    algorithms, as its default convolution backward may sum in another
    order run to run; the row then also holds two eager runs under the
    default against each other, and one replayed update under the
    default against one eager update (``one_update_default_cudnn``)."""
    def run(eager):
        sac, st, buf = make_sac(), state.clone(), ring.clone()
        metrics = []
        for chunk in chunks:
            st, buf, m = sac.update_burst(st, buf, chunk, per, eager=eager)
            metrics.append(m)
        torch.cuda.synchronize()
        return st, metrics, sac.graph_captures

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = cudnn_deterministic
    try:
        eager, m_eager, _ = run(True)
        graph, m_graph, captures = run(False)
    finally:
        torch.backends.cudnn.deterministic = saved
    gaps = _learner_gaps(graph, eager)
    row = {"bursts": len(chunks), "updates_per_burst": per,
           "cudnn_deterministic": cudnn_deterministic, "captures": captures, **gaps,
           "metrics_bitwise": all(torch.equal(g[k], e[k])
                                  for g, e in zip(m_graph, m_eager) for k in e)}
    check(captures == 1 and gaps == BITWISE and row["metrics_bitwise"],
          f"captured vs eager burst from one state: {row}")
    if cudnn_deterministic:
        row["eager_vs_eager_default_cudnn"] = _learner_gaps(run(True)[0], run(True)[0])
        row["one_update_default_cudnn"] = one_update_default_cudnn(make_sac, state, ring, chunks)
    return row


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
    metrics = max((abs(float(m_graph[k]) - float(m_eager[k])) / max(1.0, abs(float(m_eager[k])))
                   for k in m_eager))
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
            cudnn_deterministic=True)
        chunk = sample(buf, cfg.update_every, generator=gen)

        def burst(eager):
            trainer.state, trainer.buffer, m = trainer.sac.update_burst(
                trainer.state, trainer.buffer, chunk, per, eager=eager)
            return m

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
            "bursts": modes, "adam_capturable_vs_plain": adam,
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
                              cudnn_deterministic=True)
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
            "bursts": modes,
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
    epoch, a fresh trainer's ``restore()`` and 1 more (traced), on cuDNN's
    deterministic algorithms: bitwise, 1 K1 launch per update."""
    from torch_actor_critic_tpu_torch import train as train_cli
    from torch_actor_critic_tpu_torch.sac.trainer import Trainer
    from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer

    def build(epochs):
        args = train_cli.parse_arguments([
            *VISUAL_ARGS, "--device", "cuda", "--seed", str(seed), "--epochs", str(epochs),
            "--steps-per-epoch", "200", "--start-steps", "100", "--update-after", "100",
            "--update-every", "50", "--buffer-size", "24000", "--runs-root", runs])
        return train_cli.build_trainer(args)[0]

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
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
    finally:
        torch.backends.cudnn.deterministic = saved
    return ({"bitwise_vs_uninterrupted": True, "cudnn_deterministic": True, "updates": updates,
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
            cudnn_deterministic=True)
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


def ondevice_captured_vs_eager(make_loop, parts, cudnn_deterministic: bool) -> dict:
    """From clones of one learner state, ring, env batch and acting
    generator, two 100-step epochs (two windows each) with the acting
    steps and the bursts as CUDA graph replays, and the same epochs
    eagerly: learner, ring, env states, the three generators and the
    metrics to the bit; one capture of each graph."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = cudnn_deterministic
    runs, captures = {}, None
    try:
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
    finally:
        torch.backends.cudnn.deterministic = saved
    diff = bitwise_diff(runs[False], runs[True])
    check(not diff and captures == (1, 1),
          f"captured vs eager on-device epochs: differ at {diff[:8]}, captures {captures}")
    return {"epochs": 2, "steps_per_epoch": 100, "bitwise": True,
            "captures": {"acting": captures[0], "burst": captures[1]},
            "cudnn_deterministic": cudnn_deterministic}


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
            make_loop, parts, cudnn_deterministic=name == "pixel")
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


def on_device_in_a_child(seed: int) -> dict:
    """``phase_on_device`` in a process of its own (``--on-device-phase``),
    so its 6 GB pixel ring and its profiler traces start from a fresh
    CUDA context after the earlier phases; the kernel libraries it loads
    are those ``phase_build`` left in ``_build/``. Its lines pass through;
    returns the launches its last line reports."""
    torch.cuda.empty_cache()  # the earlier phases' cached blocks, for the child's rings
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--on-device-phase", "--seed", str(seed)],
        capture_output=True, text=True, timeout=900,
    )
    sys.stderr.write(res.stderr)
    lines = res.stdout.splitlines()
    print("\n".join(lines[:-1]), flush=True)
    check(res.returncode == 0 and lines, f"the on_device phase exited {res.returncode}")
    return json.loads(lines[-1])["on_device_launches"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--on-device-phase", action="store_true",
                   help="Run only the on_device phase (the smoke starts it so, in a child)")
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
    serve_launches = timed("serve", phase_serve, args.seed, _kernels)
    check(serve_launches > 0, "the serving path launched no flash_fwd kernel")
    train_launches = timed("train", phase_train, args.seed, _kernels)
    timed("graph_push", phase_graph_push, args.seed)
    visual_launches = timed("train_visual", phase_train_visual, args.seed, _kernels)
    timed("visual_burst", phase_visual_burst, args.seed, _kernels)
    resume_launches = timed("resume", phase_resume, args.seed, _kernels, smi)
    td3_launches = timed("train_td3", phase_train_td3, args.seed, _kernels, smi)
    ondevice_launches = timed("on_device", on_device_in_a_child, args.seed)
    emit({"phase": "seconds", **seconds, "total": time.perf_counter() - t_start})
    fwd_launches = (serve_launches + train_launches["flash_fwd"] + resume_launches["flash_fwd"]
                    + ondevice_launches["flash_fwd"])
    rows = [
        ("flash_fwd", "flash_fwd.cu", "torch_actor_critic_tpu/ops/attention.py:428",
         fwd_launches, serve_row),
        ("flash_bwd_dq", "flash_bwd.cu", "torch_actor_critic_tpu/ops/attention.py:611",
         train_launches["flash_bwd_dq"] + resume_launches["flash_bwd_dq"]
         + ondevice_launches["flash_bwd_dq"], bwd_rows["flash_bwd_dq"]),
        ("flash_bwd_dkv", "flash_bwd.cu", "torch_actor_critic_tpu/ops/attention.py:634",
         train_launches["flash_bwd_dkv"] + resume_launches["flash_bwd_dkv"]
         + ondevice_launches["flash_bwd_dkv"], bwd_rows["flash_bwd_dkv"]),
        ("pixel_gather", "pixels.cu", "torch_actor_critic_tpu/ops/pixels.py:261",
         visual_launches["pixel_gather"] + resume_launches["pixel_gather"]
         + td3_launches["pixel_gather"] + ondevice_launches["pixel_gather"], pixel_row),
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
