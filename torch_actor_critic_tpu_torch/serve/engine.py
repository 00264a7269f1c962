"""The policy forward over a bucketed set of batch shapes (port of
``serve/engine.py``).

Every batch is zero-padded up to a small fixed menu of power-of-two
**buckets** starting at 2, exactly as the JAX engine does, and the pad
is sliced off before the response leaves the engine; row ``i`` of the
output depends only on row ``i`` of the input. An observation is a
flat or history array, or a :class:`MultiObservation` of a feature
vector and a uint8 frame (the pixel recipe's visual actor); padding
maps over its leaves.

On a CUDA device each ``(bucket, deterministic)`` forward is ONE CUDA
graph — the port's counterpart of the JAX engine's jitted program per
bucket. :meth:`PolicyEngine.warmup` captures every pair once, each over
a static padded input buffer (one per bucket), the engine's static
parameter buffers and one static output that holds the actions and
their all-finite flag, so a served batch is: copy the padded rows in,
replay, ONE device->host copy out. The captures share one memory pool.
A capture first runs the forward eagerly on a side stream (kernel
builds, cuBLAS workspaces), then collects garbage and keeps the
collector off while the stream captures (a dead graph freed
mid-capture invalidates it). The sampled graphs register
:attr:`PolicyEngine.generator`; a sampled call with another generator
copies that generator's state in before the replay and the advanced
state back after it, so every caller's stream draws as an eager forward
would draw from it. A failed capture or replay raises: nothing on CUDA
falls back to the eager forward. :meth:`PolicyEngine.forward_eager`
is that eager forward, kept for the tests and the smoke to compare
against; the served path never calls it.

Hot reload never recaptures. The graphs read the static parameter
buffers, which hold the params of the engine's last forward: a forward
whose acquired params are another mapping copies them in first, under
the engine's forward lock, so a batch dispatched before a swap still
runs on the weights it acquired.

On the CPU the forward is eager (``torch.func.functional_call`` on the
actor module), as the tests need. First-seen ``(bucket, deterministic)``
forwards — on CUDA the captures — are counted as the JAX engine counts
its compiles (``compile_stats``): ``warmup`` outside traffic, ``live``
inside it. Each forward reduces an all-finite flag over its actions ON
the device; the flag rides the same device->host copy as the actions,
and a non-finite batch raises :class:`NonFiniteActionError` instead of
reaching a client.

``precision`` picks the numeric tier (:mod:`.sharded`): ``f32``;
``bf16``, the actor rebuilt at bf16 compute width (:attr:`apply_def`);
``int8``, params quantized by :meth:`prepare_params` at register/reload
time and dequantized by :meth:`materialize`, the forward's first op,
inside the graph.

The process's watchdog (:mod:`~..diagnostics.watchdog`, installed by the
engine as the JAX engine installs its own) counts each capture under
``serve/forward[bN]``, as ``warmup`` inside :meth:`PolicyEngine.warmup`
and ``live`` outside it; the server marks ``serve/`` steady once it
serves, so a later capture is an anomaly. Warm-up also counts each
bucket's deterministic forward once, eagerly and before its graph is
captured (:class:`~..telemetry.costmodel.CostCount`; K2 by formula),
into the cost registry as ``serve/forward[bN]``: the ``costs`` section
of ``/metrics``. Nothing is counted per request, and a reload keeps the
count (it copies into the same parameter buffers).

``warmup(params, bundle=...)`` takes a warm-start bundle
(:mod:`~..aot.bundle`): every program's signature (observation leaves
at the bucket, parameter buffers, precision, ``deterministic``) is
checked against the bundle before anything is dispatched, a mismatch
raising ``BundleMismatchError``; then the bundle's kernel libraries are
armed and the graphs captured as without one, counted under the
``bundle`` column of :meth:`PolicyEngine.compile_stats` and as
``bundle_hits`` on the watchdog (the captures stay ``warmup`` to it).

Not ported (JAX/XLA machinery): the transfer sanitizer, buffer donation.
"""

from __future__ import annotations

import contextlib
import gc
import logging
import threading
import time
import typing as t

import numpy as np
import torch
from torch.func import functional_call

from torch_actor_critic_tpu_torch.core.types import MultiObservation
from torch_actor_critic_tpu_torch.diagnostics.watchdog import get_watchdog
from torch_actor_critic_tpu_torch.serve.admission import NonFiniteActionError
from torch_actor_critic_tpu_torch.serve.sharded import (
    PRECISIONS,
    dequantize_params,
    quantize_params,
    with_compute_dtype,
)
from torch_actor_critic_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["ObsSpec", "PolicyEngine", "default_buckets", "obs_rows", "spec_of"]


class ObsSpec(t.NamedTuple):
    """One observation's shape and numpy dtype (the JAX package passes
    a ``jax.ShapeDtypeStruct``); a visual slot's spec is a
    :class:`MultiObservation` of two."""

    shape: t.Tuple[int, ...]
    dtype: t.Any = np.float32


def spec_of(spec) -> t.Any:
    """``spec`` (an ``ObsSpec``-like leaf or a :class:`MultiObservation`
    of them) with tuple shapes and numpy dtypes."""
    if isinstance(spec, MultiObservation):
        return spec.map(spec_of)
    return ObsSpec(tuple(spec.shape), np.dtype(spec.dtype))


def _leaves(x) -> list:
    return [x.features, x.frame] if isinstance(x, MultiObservation) else [x]


def _map(fn, x, *rest):
    """``fn`` over the leaves of ``x`` (and of ``rest``, in step)."""
    if isinstance(x, MultiObservation):
        return MultiObservation(
            fn(x.features, *(r.features for r in rest)),
            fn(x.frame, *(r.frame for r in rest)),
        )
    return fn(x, *rest)


def obs_rows(obs) -> int:
    """The leading (batch) axis of an observation's first leaf."""
    return int(np.shape(_leaves(obs)[0])[0])


def default_buckets(max_batch: int) -> t.Tuple[int, ...]:
    """Powers of two ``2, 4, ... , max_batch`` (``max_batch`` rounded up
    to the next power of two). The ladder starts at 2 even for
    ``max_batch=1``, as in the JAX engine, so a lone request is served
    by the same forward shape whatever the batch size setting."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    buckets = []
    b = 2
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(b)
    return tuple(buckets)


def _leaf_map(fn, params):
    """``fn`` over every tensor of a params mapping whose values are
    tensors or tuples of tensors (the int8 tier's ``Int8Param``)."""
    out = {}
    for k, v in params.items():
        if isinstance(v, tuple):
            out[k] = type(v)(*(fn(x) if isinstance(x, torch.Tensor) else x for x in v))
        else:
            out[k] = fn(v)
    return out


def param_leaves(params) -> t.List[torch.Tensor]:
    return [x for v in params.values()
            for x in (v if isinstance(v, tuple) else (v,)) if isinstance(x, torch.Tensor)]


class _BucketGraph(t.NamedTuple):
    graph: t.Any  # torch.cuda.CUDAGraph
    out: torch.Tensor  # (bucket * act_dim + 1,): actions, then the finite flag
    action_shape: t.Tuple[int, ...]


class PolicyEngine:
    """Bucketed ``(params, obs, generator) -> action`` for one actor.

    ``actor_def`` is an ``nn.Module`` honoring the port's actor
    contract ``forward(obs, generator, deterministic, with_logprob)``;
    ``obs_spec`` describes one observation (an :class:`ObsSpec` or a
    :class:`MultiObservation` of them). Thread-safe: forwards are
    serialized under a lock.
    """

    # Watchdog source and cost-registry prefix; per-bucket names are
    # f"{TRACE_PREFIX}[b{N}]".
    TRACE_PREFIX = "serve/forward"

    def __init__(
        self,
        actor_def: torch.nn.Module,
        obs_spec: t.Any,
        max_batch: int = 64,
        buckets: t.Sequence[int] | None = None,
        device: str | torch.device | None = None,
        precision: str = "f32",
    ):
        if precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS}, got {precision!r}"
            )
        self.precision = precision
        self.device = resolve_device(device)
        self.actor_def = actor_def.to(self.device).eval()
        # The module the forward runs: the bf16 tier's computes at bf16
        # width over the same f32 parameters.
        self.apply_def = (
            with_compute_dtype(self.actor_def, torch.bfloat16)
            if precision == "bf16" else self.actor_def
        )
        self.obs_spec = spec_of(obs_spec)
        self.max_batch = int(max_batch)
        self.buckets = tuple(sorted(set(
            int(b) for b in (buckets or default_buckets(self.max_batch))
        )))
        if self.buckets[0] < 1:
            raise ValueError(f"buckets must be >= 1, got {self.buckets}")
        if self.buckets[-1] < self.max_batch:
            raise ValueError(
                f"largest bucket {self.buckets[-1]} < max_batch "
                f"{self.max_batch}: requests between them could never "
                "be padded to a served shape"
            )
        # The sampled graphs' generator (registered at their capture);
        # a caller's generator lends it its state for each replay.
        self.generator = torch.Generator(device=self.device)
        self._graphed = self.device.type == "cuda"
        self._fwd_lock = threading.Lock()
        self._graphs: t.Dict[t.Tuple[int, bool], _BucketGraph] = {}  # guarded-by: _fwd_lock
        self._inputs: t.Dict[int, t.Any] = {}  # guarded-by: _fwd_lock
        self._pool = None  # guarded-by: _fwd_lock
        # The graphs' parameter buffers and the params mapping last
        # copied into them (held, so its identity cannot be reused).
        self._param_bufs: t.Dict[str, t.Any] | None = None  # guarded-by: _fwd_lock
        self._param_src: t.Any = None  # guarded-by: _fwd_lock
        self._lock = threading.Lock()
        self._compiled: set = set()  # {(bucket, det)}; guarded-by: _lock
        self._compile_counts: t.Dict[int, t.List[int]] = {}  # guarded-by: _lock
        self.compiles_total = 0  # guarded-by: _lock
        self.param_copies_total = 0  # guarded-by: _fwd_lock
        self._warmup_active = False  # guarded-by: _lock
        self._bundle_active = False  # guarded-by: _lock
        self._warmed = False  # guarded-by: _lock
        self.bundle_loaded = False  # guarded-by: _lock
        self._watchdog = get_watchdog().install()

    @property
    def graphed(self) -> bool:
        """True on CUDA: every forward is a graph replay."""
        return self._graphed

    def prepare_params(self, params: t.Mapping[str, t.Any]) -> t.Dict[str, t.Any]:
        """Checkpoint state dict -> what :meth:`act` consumes: every
        tensor on the engine's device, quantized by the int8 tier
        (register/reload time, never per request; already quantized
        leaves pass through)."""
        placed = _leaf_map(lambda x: x.to(self.device), params)
        return quantize_params(placed) if self.precision == "int8" else placed

    def place_params(self, params) -> t.Tuple[t.Dict[str, t.Any], int]:
        """:meth:`prepare_params` and the bytes the placement holds on
        the device (the ``/metrics`` ``sharding`` accounting)."""
        placed = self.prepare_params(params)
        return placed, sum(x.numel() * x.element_size() for x in param_leaves(placed))

    def materialize(self, params) -> t.Dict[str, torch.Tensor]:
        """The forward's first op: prepared params -> the state dict the
        module runs on (the int8 tier dequantizes)."""
        return dequantize_params(params) if self.precision == "int8" else params

    def replicate(self, device=None) -> "PolicyEngine":
        """A fresh engine with this one's configuration on ``device``
        (default: this engine's) and no graphs or accounting — the
        per-device replica constructor (:mod:`.fleet`)."""
        return PolicyEngine(
            self.actor_def, self.obs_spec, max_batch=self.max_batch,
            buckets=self.buckets,
            device=self.device if device is None else device,
            precision=self.precision,
        )

    # ----------------------------------------------------------- buckets

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (n must be <= max bucket)."""
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(
            f"batch of {n} rows exceeds the largest bucket "
            f"{self.buckets[-1]}; the batcher must split it first"
        )

    def compiled_buckets(self) -> t.FrozenSet[t.Tuple[int, bool]]:
        return frozenset(self._compiled)

    def compile_stats(self) -> dict:
        """First-seen ``(bucket, deterministic)`` forwards per bucket —
        the graph captures on CUDA — under the JAX engine's keys:
        ``live`` counts the ones a real request ran first (0 in a
        warmed service)."""
        with self._lock:
            return {
                "compiles_total": self.compiles_total,
                "live_compiles": sum(
                    c[1] for c in self._compile_counts.values()
                ),
                "bundle_compiles": sum(
                    c[2] for c in self._compile_counts.values()
                ),
                "bundle_loaded": self.bundle_loaded,
                "buckets": {
                    str(b): {"warmup": c[0], "live": c[1], "bundle": c[2]}
                    for b, c in sorted(self._compile_counts.items())
                },
            }

    def _note_compile(self, bucket: int, det: bool) -> None:
        with self._lock:
            key_ = (bucket, det)
            if key_ in self._compiled:
                return
            self._compiled.add(key_)
            counts = self._compile_counts.setdefault(bucket, [0, 0, 0])
            live = not self._warmup_active
            counts[2 if self._bundle_active else (1 if live else 0)] += 1
            self.compiles_total += 1
            if live and self._warmed:
                logger.warning(
                    "serving bucket %d (deterministic=%s) ran first "
                    "OUTSIDE warmup; add it to the warmup ladder",
                    bucket, det,
                )

    # ----------------------------------------------------------- forward

    def _pad(self, obs, n: int, bucket: int):
        def pad_leaf(x, spec):
            x = np.asarray(x, dtype=spec.dtype)
            if n == bucket:
                return np.ascontiguousarray(x)
            pad = np.zeros((bucket - n,) + x.shape[1:], dtype=x.dtype)
            return np.concatenate([x, pad], axis=0)

        if isinstance(self.obs_spec, MultiObservation) != isinstance(obs, MultiObservation):
            raise ValueError(
                f"observation {type(obs).__name__} does not match the slot's "
                f"spec {self.obs_spec}"
            )
        return _map(pad_leaf, obs, self.obs_spec)

    def _forward(self, params, x, generator, deterministic: bool) -> torch.Tensor:
        """The served function: actions then their all-finite flag, one
        f32 vector (so the host reads both in ONE copy)."""
        action, _ = functional_call(
            self.apply_def, dict(self.materialize(params)), (x,),
            {
                "generator": None if deterministic else generator,
                "deterministic": bool(deterministic),
                "with_logprob": False,
            },
        )
        flat = action.float().reshape(-1)
        finite = torch.isfinite(flat).all().float().reshape(1)
        return torch.cat([flat, finite])

    def _finish(self, host: np.ndarray, shape, n: int, bucket: int, det: bool):
        if host[-1] != 1.0:
            raise NonFiniteActionError(bucket, bool(det))
        return host[:-1].reshape(shape)[:n]

    def _eager(self, params, padded, generator, deterministic):
        x = _map(lambda a: torch.from_numpy(a).to(self.device), padded)
        with torch.inference_mode():
            vec = self._forward(params, x, generator, deterministic)
        host = vec.cpu().numpy()
        return host, (obs_rows(padded), (host.size - 1) // obs_rows(padded))

    def act(
        self,
        params,
        obs,
        generator: torch.Generator | None = None,
        deterministic: bool = True,
    ) -> np.ndarray:
        """One padded forward over ``n <= max bucket`` rows; returns the
        ``n`` action rows as float32 numpy. On CUDA a graph replay (the
        pair is captured first if warmup did not)."""
        n = obs_rows(obs)
        bucket = self.bucket_for(n)
        det = bool(deterministic)
        if not det and generator is None:
            raise ValueError("sampled serving needs a torch.Generator")
        padded = self._pad(obs, n, bucket)
        if not self._graphed:
            with self._fwd_lock:
                host, shape = self._eager(params, padded, generator, det)
            self._note_compile(bucket, det)
            return self._finish(host, shape, n, bucket, det)
        with self._fwd_lock, torch.inference_mode():
            entry = self._graphs.get((bucket, det))
            if entry is None:
                entry = self._capture(params, bucket, det)
            self._load_params(params)
            _map(lambda buf, a: buf.copy_(torch.from_numpy(a)), self._inputs[bucket], padded)
            lent = not det and generator is not self.generator
            if lent:
                self.generator.set_state(generator.get_state())
            entry.graph.replay()
            if lent:
                generator.set_state(self.generator.get_state())
            host = entry.out.cpu().numpy()
        return self._finish(host, entry.action_shape, n, bucket, det)

    def forward_eager(
        self,
        params,
        obs,
        generator: torch.Generator | None = None,
        deterministic: bool = True,
    ) -> np.ndarray:
        """The eager forward over the same padded rows, on any device:
        what a captured graph must reproduce bitwise. For tests and the
        smoke; the served path never calls it."""
        n = obs_rows(obs)
        bucket = self.bucket_for(n)
        if not deterministic and generator is None:
            raise ValueError("sampled serving needs a torch.Generator")
        with self._fwd_lock:
            host, shape = self._eager(
                params, self._pad(obs, n, bucket), generator, bool(deterministic))
        return self._finish(host, shape, n, bucket, bool(deterministic))

    # ------------------------------------------------------------ graphs

    def _load_params(self, params) -> None:
        """Make the graphs' parameter buffers hold ``params`` (a copy
        only when they hold another mapping). Callers hold
        ``self._fwd_lock``."""
        if params is self._param_src:
            return
        if self._param_bufs is None:
            self._param_bufs = _leaf_map(torch.clone, params)
        else:
            if set(params) != set(self._param_bufs):
                raise ValueError("params do not match the engine's graph buffers")
            for name, src in params.items():
                dst = self._param_bufs[name]
                for d, s in zip(dst if isinstance(dst, tuple) else (dst,),
                                src if isinstance(src, tuple) else (src,)):
                    if isinstance(d, torch.Tensor):
                        if d.shape != s.shape or d.dtype != s.dtype:
                            raise ValueError(
                                f"param {name}: {tuple(s.shape)} {s.dtype} does not match "
                                f"the graph buffer's {tuple(d.shape)} {d.dtype}")
                        d.copy_(s)
            self.param_copies_total += 1
        self._param_src = params

    def _input(self, bucket: int):
        """The bucket's static input buffer. Callers hold ``self._fwd_lock``."""
        if bucket not in self._inputs:
            self._inputs[bucket] = _map(
                lambda s: torch.zeros((bucket, *s.shape), device=self.device,
                                      dtype=torch.from_numpy(np.zeros((), s.dtype)).dtype),
                self.obs_spec,
            )
        return self._inputs[bucket]

    def _capture(self, params, bucket: int, det: bool) -> _BucketGraph:
        """Capture the ``(bucket, det)`` forward, noted to the watchdog
        with its warm-up run's time. Callers hold ``self._fwd_lock``."""
        t0 = time.perf_counter()
        self._load_params(params)
        x = self._input(bucket)
        p = self._param_bufs
        gen = None if det else self.generator
        device = self.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        # The warm-up's draws are put back: a capture leaves the
        # generator where it found it.
        state = gen.get_state() if gen is not None else None
        try:
            with torch.cuda.stream(stream):
                self._forward(p, x, gen, det)
            if gen is not None:
                gen.set_state(state)
            graph = torch.cuda.CUDAGraph()
            if gen is not None:
                graph.register_generator_state(gen)
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self._pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    out = self._forward(p, x, gen, det)
            finally:
                if collecting:
                    gc.enable()
        finally:
            torch.cuda.current_stream(device).wait_stream(stream)
        entry = _BucketGraph(graph, out, (bucket, (out.numel() - 1) // bucket))
        self._graphs[(bucket, det)] = entry
        self._note_compile(bucket, det)
        self._watchdog.note_capture(time.perf_counter() - t0, label=self.trace_name(bucket))
        return entry

    def trace_name(self, bucket: int) -> str:
        return f"{self.TRACE_PREFIX}[b{bucket}]"

    def graph_count(self) -> int:
        with self._fwd_lock:
            return len(self._graphs)

    @contextlib.contextmanager
    def quiesced(self):
        """Hold the engine still for the block: its forward lock is held
        and, on CUDA, the device synchronized first, so no forward of this
        engine launches, synchronizes or allocates until the block ends
        (another thread can capture a CUDA graph of its own meanwhile).
        Forwards that arrive in the block wait for it; none fails."""
        with self._fwd_lock:
            if self._graphed:
                torch.cuda.synchronize(self.device)
            yield

    # ------------------------------------------------------------ warmup

    def zero_obs(self, bucket: int):
        """``bucket`` rows of zeros in the slot's observation spec."""
        return _map(lambda s: np.zeros((bucket, *s.shape), s.dtype), self.obs_spec)

    def _verify_bundle(self, bundle, params, deterministic_only: bool,
                       buckets: t.Sequence[int] | None) -> None:
        """Every program this warm-up captures must be in ``bundle`` with
        this engine's signature; raises ``BundleMismatchError`` before
        anything is dispatched."""
        from torch_actor_critic_tpu_torch.aot.bundle import program_signature
        from torch_actor_critic_tpu_torch.aot.manifest import program_name

        for bucket in (buckets or self.buckets):
            for det in (True,) if deterministic_only else (True, False):
                bundle.verify_program(program_name(self.TRACE_PREFIX, bucket, det),
                                      program_signature(self, params, bucket, det))

    def warmup(
        self,
        params,
        deterministic_only: bool = False,
        buckets: t.Sequence[int] | None = None,
        bundle=None,
    ) -> t.List[t.Tuple[int, bool]]:
        """Run every ``(bucket, deterministic)`` forward once on zeros —
        on CUDA capture its graph — so no live request pays a first-use
        cost (kernel build, capture, allocator growth). Each bucket's
        forward is counted first (:meth:`count_cost`). Captures in here
        are ``warmup`` to the watchdog. With ``bundle`` (a checked
        :class:`~..aot.WarmStartBundle`) the programs are verified against
        it first and its kernel libraries armed (module docstring).
        Returns the shapes warmed."""
        if bundle is not None:
            self._verify_bundle(bundle, params, deterministic_only, buckets)
            bundle.arm()
        warmed = []
        with self._lock:
            self._warmup_active = True
            self._bundle_active = bundle is not None
        try:
            for bucket in (buckets or self.buckets):
                zero_obs = self.zero_obs(bucket)
                self.count_cost(params, zero_obs)
                for det in (True,) if deterministic_only else (True, False):
                    gen = None if det else self.generator
                    state = gen.get_state() if gen is not None else None
                    with self._watchdog.expected():
                        self.act(params, zero_obs, gen, det)
                    if gen is not None:
                        gen.set_state(state)
                    warmed.append((bucket, det))
        finally:
            with self._lock:
                self._warmup_active = False
                self._bundle_active = False
                self._warmed = True
                if bundle is not None:
                    self.bundle_loaded = True
        if bundle is not None:
            self._watchdog.note_bundle_hit(len(warmed))
        return warmed

    def count_cost(self, params, obs) -> dict:
        """Count one deterministic forward over ``obs``'s bucket eagerly
        (:class:`~..telemetry.costmodel.CostCount`: ATen ops by PyTorch's
        FLOP formulas, K2 by its wrapper's formula) and register it as
        ``serve/forward[bN]``. Warm-up calls it before the bucket's graph
        is captured; it must never run inside a capture or per request."""
        from torch_actor_critic_tpu_torch.telemetry.costmodel import CostCount, get_cost_registry

        n = obs_rows(obs)
        bucket = self.bucket_for(n)
        x = _map(lambda a: torch.from_numpy(a).to(self.device), self._pad(obs, n, bucket))
        with self._fwd_lock, torch.inference_mode(), CostCount() as count:
            self._forward(params, x, None, True)
        cost = count.cost()
        get_cost_registry().register(self.trace_name(bucket), cost)
        return cost
