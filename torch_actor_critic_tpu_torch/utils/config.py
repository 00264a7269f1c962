"""Typed configuration (port of ``torch_actor_critic_tpu/utils/config.py``).

Every field, default, check and the JSON round-trip are the JAX
package's, so a run's stored config loads on either side; only the two
properties that asked JAX for a dtype or a backend are rewritten.

Replaces the reference's hardcoded hyperparameter dict
(ref ``main.py:147-160``) and scattered constants (lr ``main.py:93``,
buffer size ``main.py:140``, hidden sizes ``main.py:61``) with one
dataclass that round-trips through JSON for checkpoint/resume — the
reference round-trips params through MLflow *strings* and re-parses
them with ``int(float(v))`` heuristics (ref ``main.py:46-50``).

Defaults reproduce the reference run configuration exactly
(BASELINE.md "Reference run config").
"""

from __future__ import annotations

import dataclasses
import json
import typing as t


@dataclasses.dataclass
class SACConfig:
    # --- SAC hyperparameters (ref main.py:147-160) ---
    alpha: float = 0.2  # fixed entropy temperature (ref main.py:148)
    gamma: float = 0.99
    polyak: float = 0.995
    reward_scale: float = 1.0
    epochs: int = 1000
    batch_size: int = 64
    steps_per_epoch: int = 5000
    start_steps: int = 1000
    update_after: int = 1000
    update_every: int = 50
    max_ep_len: int = 5000
    save_every: int = 10

    # --- model / optimizer (ref main.py:61,93,140) ---
    lr: float = 3e-4
    hidden_sizes: t.Tuple[int, ...] = (256, 256)
    buffer_size: int = 1_000_000
    num_qs: int = 2  # ensemble size; 2 == reference DoubleCritic

    # --- extensions beyond the reference capability envelope ---
    # Algorithm family: "sac" (the reference's algorithm, parity) or
    # "td3" (extension — Twin Delayed DDPG over the same TrainState/
    # replay/burst/mesh machinery, torch_actor_critic_tpu/td3/).
    algorithm: str = "sac"
    # TD3 hyperparameters (Fujimoto et al. 2018 defaults); ignored
    # under algorithm="sac".
    policy_delay: int = 2      # critic steps per policy/target update
    act_noise: float = 0.1     # exploration noise std, x act_limit
    target_noise: float = 0.2  # target-policy smoothing std, x act_limit
    noise_clip: float = 0.5    # smoothing noise clip, x act_limit

    # Learned entropy temperature (SAC v2). The reference fixes
    # alpha=0.2; learn_alpha=False is parity mode.
    learn_alpha: bool = False
    target_entropy: t.Optional[float] = None  # default: -act_dim

    # Reference-quirk switch (SURVEY.md §7 item 4): the reference
    # samples pi from `next_state` but evaluates Q at `state` in the
    # policy loss (ref sac/algorithm.py:37-38). False (default) uses
    # `state` for both, matching spinningup; True reproduces the
    # reference exactly for return-parity runs.
    parity_pi_obs: bool = False

    # Visual stack (ref main.py:63-90: filters/kernels/strides passed to
    # the conv nets; defaults are the Atari-DQN trunk the reference
    # hardcodes at main.py:65-67)
    filters: t.Tuple[int, ...] = (32, 64, 64)
    kernel_sizes: t.Tuple[int, ...] = (8, 4, 3)
    strides: t.Tuple[int, ...] = (4, 2, 1)
    cnn_features: int = 1  # 1 == reference scalar-vision bottleneck
    cnn_dense_size: int = 512  # conv-trunk dense width (ref convolutional.py:36)
    # DrQ random-shift frame augmentation in the update path (pixel-RL
    # stabilizer, ops/augment.py). "none" = parity (the reference has
    # no augmentation); "shift" = DrQ K=M=1.
    frame_augment: str = "none"
    augment_pad: int = 4
    normalize_pixels: bool = False
    # Pixel hot path (ops/pixels.py, docs/SCALING.md "Mixed precision
    # & the pixel pipeline"). "reference" (parity default): sample
    # gathers uint8 frames and the CNN trunk decodes them to float32
    # in-graph — the historical path, bit-pinned. "fused": replay
    # gather + uint8 decode + DrQ shift + cast-to-compute-dtype run as
    # ONE fused gather (a Pallas kernel on TPU, the bitwise-equal jnp
    # reference elsewhere), so the sampled frame batch reaches the conv
    # towers in the compute dtype without ever materializing as f32 in
    # HBM. At compute_dtype=float32 with frame_augment="none" the two
    # pipelines are bitwise-identical per update (pinned by
    # tests/test_pixels.py); with augmentation the fused path draws its
    # shift offsets at sample time, so the PRNG streams differ by
    # construction. Visual observations only (build_models enforces).
    pixel_pipeline: str = "reference"

    # Sequence-policy extension: history_len > 1 wraps the env in a
    # sliding observation window (envs/wrappers.py HistoryEnv) and
    # dispatches to the causal-transformer SequenceActor/Critic stack
    # (models/sequence.py) — long-context capability the reference
    # lacks by construction (SURVEY.md §5). seq_* set the transformer
    # geometry.
    history_len: int = 1
    seq_d_model: int = 64
    seq_num_heads: int = 4
    seq_num_layers: int = 2

    # Fully-fused on-device training (sac/ondevice.py): env + replay +
    # learner compiled into one program per epoch. Only for envs with a
    # pure-JAX twin (envs/ondevice.py registry). on_device_envs is the
    # vectorized env batch per dp slice.
    on_device: bool = False
    on_device_envs: int = 16

    # Update-to-data ratio (REDQ-style, extension): gradient steps per
    # env step. The reference is pinned at 1 (update_every updates per
    # update_every steps, ref sac/algorithm.py:273-283); utd > 1 runs
    # round(update_every * utd) updates per window — the second lever
    # (after population) that converts idle MXU into learning. utd < 1
    # thins updates for env-bound setups. Must yield >= 1 update per
    # window.
    utd: float = 1.0

    # Population training (parallel/population.py): N completely
    # independent learners — own init, replay ring, optimizer and PRNG
    # streams per member — advanced by ONE vmapped compiled burst, so
    # the member matmuls batch onto the MXU together. The TPU-native
    # answer to multi-seed runs (the reference needs N full processes,
    # ref sac/mpi.py:10-34). Each member gets its own host env and its
    # own `buffer_size`-slot ring; metrics carry per-member curves.
    # Composes with on_device=True: the fused loop vmaps the ENTIRE
    # epoch program — envs, replay rings, PRNG streams and update
    # bursts — over the member axis (sac/ondevice.py
    # PopulationOnDeviceLoop), so N complete learning curves advance
    # per device dispatch.
    population: int = 1

    # On-device PBT (population-based training) exploit/explore over
    # the fused population loop: every pbt_every epochs members are
    # ranked by an in-loop episode-return EMA; each bottom-quantile
    # member copies params + optimizer state from a random top-quantile
    # member and multiplicatively perturbs its own hyperparameters
    # (lrs, alpha/target-entropy, TD3 target noise) by pbt_perturb^±1 —
    # all in-graph, no host round-trip (Jaderberg et al. 2017).
    # pbt_every=0 disables (the population stays N fixed-hyperparam
    # seeds). Requires population > 1 with on_device.
    pbt_every: int = 0
    pbt_quantile: float = 0.25  # exploit fraction at each end of the ranking
    pbt_perturb: float = 1.25   # multiplicative explore factor (>1)
    pbt_ema: float = 0.5        # EMA weight of each new epoch's mean return

    # --- scenarios/ (multi-agent / procedural / multi-task on-device
    # workloads, docs/SCENARIOS.md) ---
    # Multi-agent critic mode: "centralized" (CTDE — one twin critic
    # over the joint observation/action; the default) or "per_agent"
    # (VDN-style per-agent twin critics summed into the joint Q).
    # Ignored for envs without a multi-agent structure.
    ma_critic: str = "centralized"
    # Multi-task conditioning: 0 (default) feeds the task one-hot to
    # the policy/critics as ordinary observation features; > 0 projects
    # it through a learned linear embedding of this width first
    # (models/taskembed.py). Ignored for single-task envs.
    task_embed_dim: int = 0

    # Observation normalization (the reference ships a Welford
    # normalizer as dead code, ref sac/utils.py:27-65; here it's a
    # usable option).
    normalize_observations: bool = False

    # Network compute dtype — the mixed-precision training policy
    # (docs/SCALING.md "Mixed precision & the pixel pipeline"):
    # "float32" (parity default) or "bfloat16" (the MXU's native input
    # width — CNN-trunk convs and MLP matmuls run bf16 while params
    # (master weights), optimizer state, Bellman targets and all
    # loss/distribution math stay float32, so checkpoints are
    # precision-independent and no loss scaling is needed: bf16 shares
    # f32's 8-bit exponent, so there is no fp16-style underflow cliff
    # to scale away). The short aliases "f32"/"bf16" (the
    # `--precision` CLI spelling) normalize to the long names. The
    # torch reference has no mixed-precision path at all.
    compute_dtype: str = "float32"

    # Actor/learner split: run env-loop action selection on the host
    # CPU backend against a param mirror refreshed per update window,
    # instead of a per-step accelerator round trip.
    host_actor: bool = True

    # Overlap env stepping with the gradient burst (host_actor only):
    # the host mirror is refreshed from the PRE-burst params right
    # before each burst dispatches, so the env loop never waits for the
    # burst to finish — at the cost of acting with params one update
    # window stale (the reference acts on post-update params; off =
    # parity). Evaluation always refreshes to the current params.
    actor_param_lag: bool = False

    # lax.scan unroll factor for the fused gradient burst
    # (sac/algorithm.py update_burst). At the reference's tiny model
    # the per-step kernels are launch-bound on TPU; unrolling trades
    # compile time and code size for less loop overhead. 1 = plain
    # scan; 0 = auto (5 on the TPU backend — the chip-measured best at
    # the reference config, +12% over plain scan: burst_unroll section
    # of runs/tpu/bench_20260731T034827Z.json — 1 elsewhere, where the
    # gain is small and the unrolled scan body compiles ~3x slower). The knob
    # is semantics-preserving (exact-equality pinned in
    # tests/test_sac_update.py), so auto-tuning it is safe.
    burst_unroll: int = 0

    # Step the host env batch in parallel worker processes over the
    # native shared-memory runtime (envs/vec_env.py + native/). False =
    # in-process sequential stepping. The reference gets env parallelism
    # only as a side effect of whole-trainer MPI replication (ref
    # sac/mpi.py:10-34); here the host physics scales independently of
    # the learner mesh.
    parallel_envs: bool = False
    # Native-pool wait timeout: a worker that exceeds it is diagnosed
    # (hung vs dead) and surfaced as an error instead of deadlocking the
    # run (cf. the reference's per-step recv deadlock, SURVEY.md §5).
    env_timeout_s: float = 120.0
    # Worker bootstrap: "spawn" (default; workers never inherit live
    # TPU-client/jax state) or "fork" (fast startup; safe when envs are
    # pure numpy).
    env_start_method: str = "spawn"

    # --- resilience (resilience/, docs/RESILIENCE.md) ---
    # Divergence sentinel: one fused all-finite check over the learner
    # state + replay ring + epoch losses at every epoch boundary; a
    # non-finite epoch rolls back to the last sentinel-validated
    # checkpoint instead of poisoning the run (the reference trains on
    # NaNs forever). max_rollbacks bounds CONSECUTIVE rollbacks before
    # aborting with TrainingDiverged — a streak means the fault is
    # systematic, not transient.
    sentinel: bool = True
    max_rollbacks: int = 3
    # Reseed every env at each epoch boundary with a seed derived from
    # (run seed, epoch, slice). Epochs become replayable units — the
    # property that makes preemption resume bitwise-identical to an
    # uninterrupted run (envs carry no state across the checkpoint
    # boundary). False restores pre-resilience behavior: epoch-boundary
    # resets continue each env's internal RNG stream, so a resumed run
    # sees different env realizations than the run it resumes.
    epoch_reseed: bool = True

    # --- decoupled actor/learner (decoupled/, docs/RESILIENCE.md
    # "Decoupled-plane failure modes", docs/SERVING.md "Training feeds
    # serving") ---
    # Sebulba/TorchBeast-style split: actors fetch actions through the
    # serving plane (in-process registry+batcher by default, or the
    # HTTP worker/router at serve_url), stream tagged transitions into
    # a bounded staging buffer, and the learner publishes each epoch
    # to the registry via the validated hot-reload. Incompatible with
    # on_device (acting is fused into the device program there) and
    # population > 1.
    decoupled: bool = False
    # "" = build an in-process serving plane; otherwise the HTTP base
    # URL of a serve.py worker or fleet router whose slot this run's
    # checkpoints feed (the worker hot-reload-polls the run's ckpt dir).
    serve_url: str = ""
    # Bounded-staleness admission gate: staged transitions published
    # more than this many epochs before the learner's current epoch
    # are dropped (counted dropped_stale_total) at drain time. With
    # one publish per epoch this is exactly the registry-generation
    # lag. NOTE: in serve_url mode publishes happen on checkpoint
    # saves, so choose max_actor_lag > save_every there.
    max_actor_lag: int = 4
    # Staging queue bound; 0 = auto (4 x update_every, which keeps the
    # inline actor from ever blocking on its own learner).
    staging_capacity: int = 0
    # Backpressure when staging is full: "block" (bounded wait, then
    # shed), "drop_oldest" (freshest-data-wins), "shed" (refuse new).
    # All three are counted (decoupled/staging.py).
    staging_policy: str = "block"
    # Per-acting-call serving budget: the PolicyClient retries within
    # it (jittered backoff, deadline-aware) and past it the actor
    # degrades to its local param snapshot instead of stalling envs.
    actor_timeout_s: float = 5.0

    # --- actor-process fleet (decoupled/fleet.py, docs/RESILIENCE.md
    # "Decoupled-plane failure modes") ---
    # N > 0 spawns N supervised ActorWorker subprocesses on their own
    # env pools, acting through the learner's serving plane and pushing
    # transitions over the networked staging transport (HTTP, per-actor
    # monotonic sequence numbers for idempotent ingestion). Implies
    # decoupled=True. 0 = no fleet (inline actor only).
    actors: int = 0
    # Restart budget per actor slot: a dead actor (process exit or
    # missed heartbeat deadline) is SIGKILL-reaped, its staged tail
    # purged (dropped_dead_actor_total), and respawned with jittered
    # exponential backoff up to this many times; past it the slot is
    # abandoned and the fleet trains on the survivors.
    actor_max_restarts: int = 3
    # Actors POST /heartbeat every interval; the supervisor declares an
    # actor dead when its newest heartbeat is older than the timeout.
    # The timeout must exceed the interval with slack for scheduling
    # jitter (CPU CI boxes stall; 6x is a sane floor).
    heartbeat_interval_s: float = 0.5
    heartbeat_timeout_s: float = 3.0
    # Actor-side staging-push retry budget: transient failures (refused
    # connections, 5xx, learner checkpoint pauses) are retried with
    # jittered exponential backoff within this budget, then the actor
    # degrades to local acting and re-homes on recovery (the
    # in-process degrade semantics, across the wire).
    actor_push_retry_s: float = 2.0
    # Transport bind port for the staging/heartbeat/act endpoint;
    # 0 = ephemeral (the chaos smoke pins a port so a resumed learner
    # rebinds the same address and live actors reconnect).
    fleet_port: int = 0

    # --- tiered replay + offline training (replay/, docs/REPLAY.md) ---
    # Tier stack under the HBM ring: "off" (parity default — no host
    # mirroring, no extra metric keys, jit cache and replay stream
    # bitwise identical to pre-tier builds), "host" (HBM + host-RAM
    # ring; evictions past the host ring are counted and dropped), or
    # "disk" (host evictions spill to append-only chunk files under
    # replay_dir). Host-loop single-member training only.
    replay_tiers: str = "off"
    # Host-ring capacity in transitions; 0 = auto (= buffer_size, i.e.
    # the host tier holds as much again as the device ring).
    replay_host_capacity: int = 0
    # Disk-tier directory; "" = <run_dir>/replay under the tracker.
    replay_dir: str = ""
    # Disk-tier byte budget; 0 = unbounded. Over budget the eviction
    # policy applies per chunk file: "fifo" deletes oldest chunks,
    # "stop" refuses new appends (counted, never raises).
    replay_disk_bytes: int = 0
    replay_disk_policy: str = "fifo"
    # Host-tier sampling prior for refill draws: "uniform" over the
    # resident window or "recent" (newest half).
    replay_priority: str = "uniform"
    # Refill rows per env per update window pushed back HBM-ward from
    # the host tier (0 = archival only: tiers record spill but never
    # feed samples back, leaving the device stream bit-identical).
    replay_refill: int = 0
    # Stage refill chunks on a background thread (double-buffered) so
    # the host→device copy hides behind the update burst; False
    # samples synchronously at the window boundary (the measured
    # stall, bench.py --stage=replay).
    replay_prefetch: bool = True

    # Offline training (train.py --offline): no env in the loop — the
    # dataset is a replay disk tier (trainer spill or serve-side
    # flywheel), loaded to host RAM and sampled by a host RNG.
    offline: bool = False
    offline_dataset: str = ""
    # Off-support Q-overestimation counterweight: "none" (plain SAC
    # steps), "bc" (behavior-cloning MSE anchor on the actor), "cql"
    # (conservative logsumexp gap penalty on the critic).
    offline_reg: str = "none"
    offline_reg_weight: float = 1.0
    offline_steps: int = 10000

    # --- observability (telemetry/, docs/OBSERVABILITY.md) ---
    # Per-step phase spans (act/env_step/stage/place_chunk/
    # burst_dispatch/drain/sentinel/checkpoint), per-epoch device HBM
    # watermarks and a JSONL event stream under the tracker run dir.
    # Off by default: the disabled hot path carries zero telemetry work
    # (bench.py `telemetry_overhead` pins the enabled cost at <5%).
    telemetry: bool = False
    # Learning-health diagnostics tier (diagnostics/,
    # docs/OBSERVABILITY.md "Learning-health diagnostics"): in-graph
    # gradient/Q/entropy reductions fused into the update burst.
    #   "off"   — parity default: compiled graph, metric keys and jit
    #             cache bitwise identical to an uninstrumented build;
    #   "light" — scalar diagnostics (grad global-norms, update-to-
    #             param ratios, Q stats, action saturation, per-burst
    #             loss maxima) + dp replica-skew + the recompilation
    #             watchdog; bench.py `diagnostics_overhead` holds this
    #             within the 5% bar on the CPU smoke config;
    #   "full"  — light + the on-device fixed-bucket TD-error
    #             histogram (merged host-side into the telemetry
    #             histogram schema).
    # The tier is read at trace time, so it is part of the compiled
    # program's identity — flipping it can never alias a cache entry.
    diagnostics: str = "off"
    # Runtime transfer sanitizer (docs/ANALYSIS.md "Runtime
    # sanitizers"): "on" wraps the Trainer's device phases (the
    # update-burst/push dispatch and the epoch drain) in
    # jax.transfer_guard("disallow"), so an IMPLICIT host<->device
    # transfer on the hot path — numpy leaking into the jit, a stray
    # Python scalar — is a hard failure in smokes instead of an
    # invisible per-step transfer tax (the 0.02-MFU class). "off"
    # (default) is no-op parity: the dispatch sites are untouched and
    # the metric stream is bitwise identical (pinned by
    # tests/test_sanitize.py).
    sanitize: str = "off"
    # Cold-start machinery (aot/, docs/SERVING.md "Cold start &
    # warm-start bundles"): `compile_cache` points the persistent XLA
    # compilation cache at a directory shared by fleet workers,
    # spawned actors, and learner RESTARTS — a preempted learner
    # resumes compile-free because its epoch programs are already on
    # disk. The dir is published to child processes via
    # TAC_COMPILE_CACHE. Empty (default) leaves jax's cache config
    # untouched.
    compile_cache: str = ""
    # `--emit-bundle` writes a warm-start bundle next to the Orbax
    # checkpoint at the FIRST update epoch (the earliest moment real
    # actor params exist): serve.py --warm-start auto then answers its
    # first /act with zero live compiles. Requires checkpointing
    # (save_every > 0) for the checkpoint-adjacent location.
    emit_bundle: bool = False
    # Serve bucket ladder ceiling the emitted bundle pre-compiles for
    # (must match the serve worker's --max-batch for the bundle to
    # cover its buckets; smokes shrink it to keep the build cheap).
    bundle_max_batch: int = 64
    # Run-wide observability plane (obs/, docs/OBSERVABILITY.md
    # "Run-wide plane"): `--obs` starts the ObsCollector — a scraper
    # thread folding every process's /metrics (learner telemetry,
    # staging transport + actors, any `--obs-scrape` extras like the
    # serve router) into one obs.jsonl time series, an aggregated
    # /metrics endpoint on `--obs-port` (0 = ephemeral), and `obs/`
    # columns in metrics.jsonl. Off by default: zero threads, zero
    # sockets, metric keys identical to a build without the plane (pinned by
    # tests/test_obs.py; bench.py `obs_overhead` holds the enabled
    # cost within the 5% bar).
    obs: bool = False
    obs_interval_s: float = 2.0
    obs_port: int = 0
    # Extra scrape targets, comma-separated `name=http://host:port`
    # pairs — how a training-side collector watches a separately
    # launched serving fleet's router.
    obs_scrape: str = ""
    # SLO rules over the aggregated series (obs/slo.py grammar); empty
    # = built-in defaults (goodput floor, p99 ceiling, shed-rate
    # ceiling, actor staleness, conservation, MFU floor).
    slo_config: str = ""
    # Size-based rotation for telemetry.jsonl / obs.jsonl (MB; 0 =
    # off, the append-only one-file-per-run default). Rotation keeps
    # one `.1` generation and writes a counted `sink_rotated` marker.
    telemetry_max_mb: float = 0.0
    # Training-plane elasticity (elastic/, docs/RESILIENCE.md
    # "Elasticity"): with `--elastic on`, an actor slot that exhausts
    # its restart budget becomes a counted `degrade` decision (the run
    # trains on the surviving slice; the conservation ledger's
    # dropped_dead_actor term absorbs the lost slice), and the slot is
    # re-admitted with a reset budget after `elastic_readmit_epochs`
    # degraded epochs — at an epoch boundary, so the slice rejoins at
    # a clean cut. Checkpoints carry the degraded topology. Off (the
    # default) constructs nothing: no decision log, no elastic/ metric
    # keys (key-pin, tests/test_elastic_controller.py).
    elastic: str = "off"
    elastic_readmit_epochs: int = 1

    def __post_init__(self):
        if not (len(self.filters) == len(self.kernel_sizes) == len(self.strides)):
            raise ValueError(
                "filters/kernel_sizes/strides must have equal length, got "
                f"{len(self.filters)}/{len(self.kernel_sizes)}/{len(self.strides)}"
            )
        # `--precision {f32,bf16}` aliases normalize to the long names
        # so stored configs/checkpoints carry one canonical spelling.
        self.compute_dtype = {"f32": "float32", "bf16": "bfloat16"}.get(
            self.compute_dtype, self.compute_dtype
        )
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be 'float32'/'f32' or "
                f"'bfloat16'/'bf16', got {self.compute_dtype!r}"
            )
        if self.pixel_pipeline not in ("reference", "fused"):
            raise ValueError(
                f"pixel_pipeline must be 'reference' or 'fused', got "
                f"{self.pixel_pipeline!r}"
            )
        if self.algorithm not in ("sac", "td3"):
            raise ValueError(
                f"algorithm must be 'sac' or 'td3', got {self.algorithm!r}"
            )
        if self.policy_delay < 1:
            raise ValueError(
                f"policy_delay must be >= 1, got {self.policy_delay}"
            )
        if self.algorithm == "td3" and (self.learn_alpha or self.parity_pi_obs):
            # Same fail-at-construction policy as the visual/sequence
            # gate: a SAC-only opt-in silently doing nothing would let a
            # user believe the feature is active.
            raise ValueError(
                "learn_alpha and parity_pi_obs are SAC-only options; "
                "algorithm='td3' has no entropy temperature and no "
                "pi-loss observation quirk"
            )
        if self.frame_augment not in ("none", "shift"):
            raise ValueError(
                "frame_augment must be 'none' or 'shift', got "
                f"{self.frame_augment!r}"
            )
        if self.augment_pad < 1:
            raise ValueError(
                f"augment_pad must be >= 1, got {self.augment_pad}"
            )
        if self.burst_unroll < 0:
            raise ValueError(
                f"burst_unroll must be >= 0 (0 = auto), got {self.burst_unroll}"
            )
        if self.utd <= 0 or round(self.update_every * self.utd) < 1:
            raise ValueError(
                f"utd={self.utd} with update_every={self.update_every} "
                "yields no gradient steps per window; raise utd or "
                "update_every"
            )
        if self.population < 1:
            raise ValueError(
                f"population must be >= 1, got {self.population}"
            )
        if self.pbt_every < 0:
            raise ValueError(
                f"pbt_every must be >= 0 (0 = off), got {self.pbt_every}"
            )
        if self.pbt_every > 0 and self.population < 2:
            raise ValueError(
                "pbt_every > 0 needs a population to exploit/explore "
                f"over; got population={self.population}"
            )
        if self.pbt_every > 0 and not self.on_device:
            raise ValueError(
                "PBT exploit/explore runs in-graph over the fused "
                "population loop; pass --on-device true (the host-loop "
                "population trains N fixed-hyperparam seeds)"
            )
        if not 0.0 < self.pbt_quantile <= 0.5:
            raise ValueError(
                f"pbt_quantile must be in (0, 0.5], got {self.pbt_quantile}"
            )
        if self.pbt_perturb <= 1.0:
            raise ValueError(
                f"pbt_perturb must be > 1 (multiplicative explore "
                f"factor), got {self.pbt_perturb}"
            )
        if not 0.0 < self.pbt_ema <= 1.0:
            raise ValueError(
                f"pbt_ema must be in (0, 1], got {self.pbt_ema}"
            )
        if self.ma_critic not in ("centralized", "per_agent"):
            raise ValueError(
                f"ma_critic must be 'centralized' or 'per_agent', got "
                f"{self.ma_critic!r}"
            )
        if self.task_embed_dim < 0:
            raise ValueError(
                f"task_embed_dim must be >= 0 (0 = raw one-hot), got "
                f"{self.task_embed_dim}"
            )
        if self.diagnostics not in ("off", "light", "full"):
            raise ValueError(
                f"diagnostics must be 'off', 'light' or 'full', got "
                f"{self.diagnostics!r}"
            )
        if self.sanitize not in ("off", "on"):
            raise ValueError(
                f"sanitize must be 'off' or 'on', got {self.sanitize!r}"
            )
        if self.max_rollbacks < 0:
            raise ValueError(
                f"max_rollbacks must be >= 0, got {self.max_rollbacks}"
            )
        if self.staging_policy not in ("block", "drop_oldest", "shed"):
            raise ValueError(
                "staging_policy must be 'block', 'drop_oldest' or "
                f"'shed', got {self.staging_policy!r}"
            )
        if self.max_actor_lag < 0:
            raise ValueError(
                f"max_actor_lag must be >= 0, got {self.max_actor_lag}"
            )
        if self.staging_capacity < 0:
            raise ValueError(
                f"staging_capacity must be >= 0 (0 = auto), got "
                f"{self.staging_capacity}"
            )
        if self.actor_timeout_s <= 0:
            raise ValueError(
                f"actor_timeout_s must be > 0, got {self.actor_timeout_s}"
            )
        if self.actors < 0:
            raise ValueError(
                f"actors must be >= 0 (0 = no fleet), got {self.actors}"
            )
        if self.actors > 0:
            # --actors N is a decoupled-plane feature: the fleet feeds
            # the StagingBuffer and the learner's serving plane, so the
            # flag implies the split rather than erroring on it.
            self.decoupled = True
        if self.actor_max_restarts < 0:
            raise ValueError(
                f"actor_max_restarts must be >= 0, got "
                f"{self.actor_max_restarts}"
            )
        if self.heartbeat_interval_s <= 0:
            raise ValueError(
                f"heartbeat_interval_s must be > 0, got "
                f"{self.heartbeat_interval_s}"
            )
        if self.heartbeat_timeout_s <= self.heartbeat_interval_s:
            raise ValueError(
                f"heartbeat_timeout_s ({self.heartbeat_timeout_s}) must "
                f"exceed heartbeat_interval_s "
                f"({self.heartbeat_interval_s}); one missed beat is "
                "scheduling jitter, not death"
            )
        if self.actor_push_retry_s <= 0:
            raise ValueError(
                f"actor_push_retry_s must be > 0, got "
                f"{self.actor_push_retry_s}"
            )
        if not (0 <= self.fleet_port <= 65535):
            raise ValueError(
                f"fleet_port must be in [0, 65535], got {self.fleet_port}"
            )
        if self.obs_interval_s <= 0:
            raise ValueError(
                f"obs_interval_s must be > 0, got {self.obs_interval_s}"
            )
        if not (0 <= self.obs_port <= 65535):
            raise ValueError(
                f"obs_port must be in [0, 65535], got {self.obs_port}"
            )
        if self.telemetry_max_mb < 0:
            raise ValueError(
                f"telemetry_max_mb must be >= 0, got "
                f"{self.telemetry_max_mb}"
            )
        for pair in filter(None, self.obs_scrape.split(",")):
            if "=" not in pair:
                raise ValueError(
                    f"obs_scrape entries must be name=url pairs, got "
                    f"{pair!r}"
                )
        if self.elastic not in ("off", "on"):
            raise ValueError(
                f"elastic must be 'off' or 'on', got {self.elastic!r}"
            )
        if self.elastic == "on" and self.actors < 1:
            raise ValueError(
                "elastic is the fleet degrade/re-admit machinery; it "
                "needs an actor fleet (--actors >= 1)"
            )
        if self.elastic_readmit_epochs < 1:
            raise ValueError(
                f"elastic_readmit_epochs must be >= 1, got "
                f"{self.elastic_readmit_epochs}"
            )
        if self.decoupled:
            if self.on_device:
                raise ValueError(
                    "decoupled is the host-loop actor/learner split; "
                    "on_device fuses acting into the device program — "
                    "the two cannot compose. Pick one."
                )
            if self.population > 1:
                raise ValueError(
                    "decoupled does not compose with population > 1 "
                    "yet (per-member serving slots are not wired); run "
                    "members as separate decoupled processes instead"
                )
            if self.resolved_staging_capacity < self.update_every:
                raise ValueError(
                    f"staging_capacity={self.staging_capacity} is "
                    f"smaller than one update window "
                    f"(update_every={self.update_every}); the learner "
                    "could never drain a fixed-size window"
                )
        if self.replay_tiers not in ("off", "host", "disk"):
            raise ValueError(
                f"replay_tiers must be 'off', 'host' or 'disk', got "
                f"{self.replay_tiers!r}"
            )
        if self.replay_disk_policy not in ("fifo", "stop"):
            raise ValueError(
                f"replay_disk_policy must be 'fifo' or 'stop', got "
                f"{self.replay_disk_policy!r}"
            )
        if self.replay_priority not in ("uniform", "recent"):
            raise ValueError(
                f"replay_priority must be 'uniform' or 'recent', got "
                f"{self.replay_priority!r}"
            )
        if self.replay_host_capacity < 0:
            raise ValueError(
                f"replay_host_capacity must be >= 0 (0 = auto), got "
                f"{self.replay_host_capacity}"
            )
        if self.replay_disk_bytes < 0:
            raise ValueError(
                f"replay_disk_bytes must be >= 0 (0 = unbounded), got "
                f"{self.replay_disk_bytes}"
            )
        if self.replay_refill < 0:
            raise ValueError(
                f"replay_refill must be >= 0 (0 = archival only), got "
                f"{self.replay_refill}"
            )
        if self.replay_refill > 0 and self.replay_tiers == "off":
            raise ValueError(
                "replay_refill > 0 needs a tier stack to refill from; "
                "pass --replay-tiers host or disk"
            )
        if self.replay_tiers != "off":
            if self.on_device:
                raise ValueError(
                    "replay_tiers is the host-loop storage hierarchy; "
                    "on_device keeps the whole ring in the compiled "
                    "program — the two cannot compose"
                )
            if self.population > 1:
                raise ValueError(
                    "replay_tiers does not compose with population > 1 "
                    "(per-member tier stacks are not wired)"
                )
        if self.offline_reg not in ("none", "bc", "cql"):
            raise ValueError(
                f"offline_reg must be 'none', 'bc' or 'cql', got "
                f"{self.offline_reg!r}"
            )
        if self.offline_reg_weight < 0:
            raise ValueError(
                f"offline_reg_weight must be >= 0, got "
                f"{self.offline_reg_weight}"
            )
        if self.offline_steps < 1:
            raise ValueError(
                f"offline_steps must be >= 1, got {self.offline_steps}"
            )
        if self.offline:
            if self.on_device or self.decoupled or self.population > 1:
                raise ValueError(
                    "--offline trains from a disk tier with no env in "
                    "the loop; it does not compose with on_device, "
                    "decoupled or population > 1"
                )
        if self.actor_param_lag and not self.host_actor:
            raise ValueError(
                "actor_param_lag requires host_actor=True — the "
                "device-actor path reads post-burst params directly, so "
                "there is no mirror to run stale."
            )

    @property
    def updates_per_window(self) -> int:
        """Gradient steps per ``update_every``-step window:
        ``round(update_every * utd)``. At the default ``utd=1`` this is
        exactly the reference's one-update-per-env-step cadence."""
        return max(int(round(self.update_every * self.utd)), 1)

    @property
    def resolved_staging_capacity(self) -> int:
        """``staging_capacity`` with 0 resolved to ``4 x update_every``
        — enough headroom that the inline (same-thread) actor can
        always stage a full window past any gate-dropped leftovers
        without hitting its own backpressure policy."""
        return self.staging_capacity or 4 * self.update_every

    @property
    def resolved_burst_unroll(self) -> int:
        """``burst_unroll`` with 0 resolved to 1: the JAX package picks
        5 on its TPU backend; the port runs eagerly and has no scan to
        unroll, so the auto value is the plain loop."""
        return self.burst_unroll or 1

    @property
    def model_dtype(self):
        """The torch dtype models compute in (params always float32)."""
        import torch

        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "SACConfig":
        raw = json.loads(s)
        field_names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in field_names}
        for tup in ("hidden_sizes", "filters", "kernel_sizes", "strides"):
            if tup in kwargs:
                kwargs[tup] = tuple(kwargs[tup])
        return cls(**kwargs)

    def replace(self, **kwargs) -> "SACConfig":
        return dataclasses.replace(self, **kwargs)
