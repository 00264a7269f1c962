"""aot/: the cold start as a build artifact (the port's counterpart of
the JAX package's ``aot/``).

A fresh serving worker, warm spare, actor process or restarted learner
would otherwise build the kernel libraries with ``nvcc`` (seconds to
minutes, and impossible on a host without the CUDA toolkit) before its
first launch:

- :mod:`~torch_actor_critic_tpu_torch.aot.manifest`: the programs to
  bundle, derived from the analyzer's checked tables
  (``analysis.reachability.ENTRY_POINTS`` joined with the ``bundleable``
  column of ``analysis.contracts.ENTRY_POINT_CONTRACTS``) and the serving
  bucket ladder;
- :mod:`~torch_actor_critic_tpu_torch.aot.bundle`: the ``warm_start``
  bundle next to a checkpoint (the built libraries, the programs'
  signatures, an environment fingerprint); ``serve --warm-start
  DIR|auto``, ``train --emit-bundle true``;
- :mod:`~torch_actor_critic_tpu_torch.aot.cache`: the kernel-library
  cache directory shared by a fleet and a restarted learner
  (``--compile-cache DIR``, ``TAC_COMPILE_CACHE``), its hits and misses
  counted on the watchdog;
- :mod:`~torch_actor_critic_tpu_torch.aot.prefork`: the pre-forked warm
  worker pool of the serve fleet (``serve --warm-pool N``).
"""

from torch_actor_critic_tpu_torch.aot.bundle import (
    BundleMismatchError,
    WarmStartBundle,
    build_bundle,
    check_fingerprint,
    default_bundle_dir,
    emit_bundle,
    environment_fingerprint,
    load_bundle,
)
from torch_actor_critic_tpu_torch.aot.cache import (
    CACHE_ENV_VAR,
    cache_entries,
    current_cache_dir,
    enable_cache_from_env,
    enable_persistent_cache,
)
from torch_actor_critic_tpu_torch.aot.manifest import (
    ManifestError,
    bundled_entry_points,
    entry_point_table,
    serve_programs,
)
from torch_actor_critic_tpu_torch.aot.prefork import WarmPool, WarmWorker

__all__ = [
    "BundleMismatchError",
    "WarmStartBundle",
    "build_bundle",
    "check_fingerprint",
    "default_bundle_dir",
    "emit_bundle",
    "environment_fingerprint",
    "load_bundle",
    "CACHE_ENV_VAR",
    "cache_entries",
    "current_cache_dir",
    "enable_cache_from_env",
    "enable_persistent_cache",
    "ManifestError",
    "bundled_entry_points",
    "entry_point_table",
    "serve_programs",
    "WarmPool",
    "WarmWorker",
]
