"""The kernel-library cache shared across processes (the port's
counterpart of the JAX package's persistent compilation cache,
``aot/cache.py``).

JAX persists compiled XLA programs; the port compiles no programs, but
every process that launches a kernel needs its ``nvcc``-built library.
The libraries live in one directory (:func:`~..ops._kernels.cache_dir`,
``_build/`` next to the package by default), named by a hash of their
sources and flags, so any number of processes share one directory
safely: a library found there is a cache hit, one built there a miss
(both counted on the watchdog, ``cache_hits_total`` and
``cache_misses_total``). :func:`enable_persistent_cache` points this
process at another directory (``serve --compile-cache DIR``, ``train
--compile-cache DIR``: a read-only install, or one directory for a whole
fleet) and exports it as :data:`CACHE_ENV_VAR`, so spawned children
(fleet workers, warm spares, actor processes, a restarted learner) join
it through :func:`enable_cache_from_env`.

Arm the cache before the first kernel launch: the loaded entry points
are kept for the whole process.
"""

from __future__ import annotations

import logging
import os

from torch_actor_critic_tpu_torch.ops import _kernels

logger = logging.getLogger(__name__)

__all__ = [
    "CACHE_ENV_VAR",
    "cache_entries",
    "current_cache_dir",
    "disable_persistent_cache",
    "enable_cache_from_env",
    "enable_persistent_cache",
]

CACHE_ENV_VAR = _kernels.CACHE_ENV_VAR


def enable_persistent_cache(cache_dir: str, export_env: bool = True) -> str:
    """Build into and look up kernel libraries in ``cache_dir`` (created
    if absent) and install the watchdog that counts the hits and misses.
    Returns the absolute directory; with ``export_env`` (default) it is
    published to :data:`CACHE_ENV_VAR` for spawned children."""
    from torch_actor_critic_tpu_torch.diagnostics.watchdog import get_watchdog

    cache_dir = os.path.abspath(cache_dir)
    os.makedirs(cache_dir, exist_ok=True)
    if _kernels._loaded:
        logger.warning("kernel library cache set to %s after kernels were loaded (%s): "
                       "those stay as loaded", cache_dir, sorted(_kernels._loaded))
    _kernels.set_cache_dir(cache_dir)
    if export_env:
        os.environ[CACHE_ENV_VAR] = cache_dir
    get_watchdog().install()
    logger.info("kernel library cache: %s", cache_dir)
    return cache_dir


def enable_cache_from_env() -> str | None:
    """Join the cache a parent published in :data:`CACHE_ENV_VAR`; None
    (and nothing changed) when it is unset or empty."""
    cache_dir = os.environ.get(CACHE_ENV_VAR, "")
    if not cache_dir:
        return None
    return enable_persistent_cache(cache_dir, export_env=False)


def disable_persistent_cache() -> None:
    """Back to the default directory, the variable unset (test isolation)."""
    _kernels.set_cache_dir(None)
    os.environ.pop(CACHE_ENV_VAR, None)


def current_cache_dir() -> str | None:
    """The directory :func:`enable_persistent_cache` chose, or the
    inherited :data:`CACHE_ENV_VAR`; None when this process builds into
    the default ``_build/``."""
    if _kernels._cache_dir is not None:
        return str(_kernels._cache_dir)
    return os.environ.get(CACHE_ENV_VAR) or None


def cache_entries(cache_dir: str) -> int:
    """Kernel libraries under ``cache_dir`` (0 for a missing directory)."""
    if not os.path.isdir(cache_dir):
        return 0
    return sum(1 for name in os.listdir(cache_dir)
               if name.endswith(".so") and os.path.isfile(os.path.join(cache_dir, name)))
