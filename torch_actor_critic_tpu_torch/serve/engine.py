"""The policy forward over a bucketed set of batch shapes (port of
``serve/engine.py``).

Every batch is zero-padded up to a small fixed menu of power-of-two
**buckets** starting at 2, exactly as the JAX engine does, and the pad
is sliced off before the response leaves the engine; row ``i`` of the
output depends only on row ``i`` of the input. The JAX package pads so
XLA compiles a handful of programs; here the ladder keeps the kernels'
launch shapes to the same few, and keeps the per-bucket accounting
(``compile_stats``) comparable: a first-seen ``(bucket, deterministic)``
forward is counted as a "compile" — ``warmup`` outside traffic,
``live`` inside it. :meth:`warmup` runs every bucket once, which also
builds the CUDA kernels at first use.

``params`` is a state dict (name -> tensor on the engine's device) run
through ``torch.func.functional_call`` on the actor module, so a
registry swap replaces tensors without touching the module. Each
forward also reduces an all-finite flag over its actions ON the device;
the flag rides the same device->host copy as the actions, and a
non-finite batch raises :class:`NonFiniteActionError` instead of
reaching a client.

Not ported (JAX/XLA machinery): the recompile watchdog, cost
registration, the warm-start bundle, the transfer sanitizer, buffer
donation. Per-bucket CUDA graphs are later work.
"""

from __future__ import annotations

import logging
import threading
import typing as t

import numpy as np
import torch
from torch.func import functional_call

from torch_actor_critic_tpu_torch.serve.admission import NonFiniteActionError
from torch_actor_critic_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["ObsSpec", "PolicyEngine", "default_buckets"]


class ObsSpec(t.NamedTuple):
    """One observation's shape and numpy dtype (the JAX package passes
    a ``jax.ShapeDtypeStruct``)."""

    shape: t.Tuple[int, ...]
    dtype: t.Any = np.float32


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


class PolicyEngine:
    """Bucketed ``(params, obs, generator) -> action`` for one actor.

    ``actor_def`` is an ``nn.Module`` honoring the port's actor
    contract ``forward(obs, generator, deterministic, with_logprob)``;
    ``obs_spec`` describes one observation. Thread-safe: forwards are
    serialized under a lock (``functional_call`` swaps the module's
    tensors for the call's duration).
    """

    def __init__(
        self,
        actor_def: torch.nn.Module,
        obs_spec: ObsSpec,
        max_batch: int = 64,
        buckets: t.Sequence[int] | None = None,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.actor_def = actor_def.to(self.device).eval()
        self.obs_spec = ObsSpec(tuple(obs_spec.shape), np.dtype(obs_spec.dtype))
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
        self._fwd_lock = threading.Lock()
        self._lock = threading.Lock()
        self._compiled: set = set()  # {(bucket, det)}; guarded-by: _lock
        self._compile_counts: t.Dict[int, t.List[int]] = {}  # guarded-by: _lock
        self.compiles_total = 0  # guarded-by: _lock
        self._warmup_active = False  # guarded-by: _lock
        self._warmed = False  # guarded-by: _lock
        self.bundle_loaded = False  # no warm-start bundles in the port

    def prepare_params(self, params: t.Mapping[str, torch.Tensor]):
        """Checkpoint state dict -> what :meth:`act` consumes: every
        tensor on the engine's device (register/reload time, never per
        request)."""
        return {k: v.to(self.device) for k, v in params.items()}

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
        """First-seen ``(bucket, deterministic)`` forwards per bucket,
        under the JAX engine's keys: ``live`` counts the ones a real
        request ran first (0 in a warmed service)."""
        with self._lock:
            return {
                "compiles_total": self.compiles_total,
                "live_compiles": sum(
                    c[1] for c in self._compile_counts.values()
                ),
                "bundle_compiles": 0,
                "bundle_loaded": self.bundle_loaded,
                "buckets": {
                    str(b): {"warmup": c[0], "live": c[1], "bundle": c[2]}
                    for b, c in sorted(self._compile_counts.items())
                },
            }

    # ----------------------------------------------------------- forward

    def _pad(self, obs: np.ndarray, n: int, bucket: int) -> np.ndarray:
        obs = np.asarray(obs, dtype=self.obs_spec.dtype)
        if n == bucket:
            return obs
        pad = np.zeros((bucket - n,) + obs.shape[1:], dtype=obs.dtype)
        return np.concatenate([obs, pad], axis=0)

    def act(
        self,
        params: t.Mapping[str, torch.Tensor],
        obs: np.ndarray,
        generator: torch.Generator | None = None,
        deterministic: bool = True,
    ) -> np.ndarray:
        """One padded forward over ``n <= max bucket`` rows; returns the
        ``n`` action rows as float32 numpy."""
        n = int(np.shape(obs)[0])
        bucket = self.bucket_for(n)
        if not deterministic and generator is None:
            raise ValueError("sampled serving needs a torch.Generator")
        x = torch.from_numpy(self._pad(obs, n, bucket)).to(self.device)
        with self._fwd_lock, torch.inference_mode():
            action, _ = functional_call(
                self.actor_def, dict(params), (x,),
                {
                    "generator": None if deterministic else generator,
                    "deterministic": bool(deterministic),
                    "with_logprob": False,
                },
            )
            flat = action.float().reshape(-1)
            finite = torch.isfinite(flat).all().float().reshape(1)
            # Actions and their all-finite flag in ONE device->host copy.
            host = torch.cat([flat, finite]).cpu().numpy()
        with self._lock:
            key_ = (bucket, bool(deterministic))
            if key_ not in self._compiled:
                self._compiled.add(key_)
                counts = self._compile_counts.setdefault(bucket, [0, 0, 0])
                live = not self._warmup_active
                counts[1 if live else 0] += 1
                self.compiles_total += 1
                if live and self._warmed:
                    logger.warning(
                        "serving bucket %d (deterministic=%s) ran first "
                        "OUTSIDE warmup; add it to the warmup ladder",
                        bucket, deterministic,
                    )
        if host[-1] != 1.0:
            raise NonFiniteActionError(bucket, bool(deterministic))
        return host[:-1].reshape((bucket,) + tuple(action.shape[1:]))[:n]

    # ------------------------------------------------------------ warmup

    def warmup(
        self,
        params: t.Mapping[str, torch.Tensor],
        deterministic_only: bool = False,
        buckets: t.Sequence[int] | None = None,
    ) -> t.List[t.Tuple[int, bool]]:
        """Run every ``(bucket, deterministic)`` forward once on zeros,
        so no live request pays a first-use cost (kernel build, CUDA
        context, allocator growth). Returns the shapes warmed."""
        warmed = []
        gen = torch.Generator(device=self.device).manual_seed(0)
        with self._lock:
            self._warmup_active = True
        try:
            for bucket in (buckets or self.buckets):
                zero_obs = np.zeros(
                    (bucket,) + self.obs_spec.shape, self.obs_spec.dtype
                )
                for det in (True,) if deterministic_only else (True, False):
                    self.act(params, zero_obs, None if det else gen, det)
                    warmed.append((bucket, det))
        finally:
            with self._lock:
                self._warmup_active = False
                self._warmed = True
        return warmed
