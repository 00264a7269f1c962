"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<source>.cu`` is a plain-C-interface source compiled by
``nvcc`` into its own shared library and bound with ``ctypes`` (no
PyTorch headers: a build takes seconds, not minutes); one source may
hold several kernels' entry points. Libraries are
built at first use into ``_build/`` next to the package, under a name
keyed on a hash of the sources and flags, so a fresh checkout builds
exactly once and an edited source rebuilds. Nothing here runs at
import time: the CPU tests import every module of the port.

:func:`build_all` starts one ``nvcc`` per source, all at once.
``launch_counts`` is the per-kernel count of launches: each wrapper
adds one where its kernel launches, and nowhere else. Under a CUDA
graph capture a wrapper's launch is recorded into the graph and counted
once; the graph's replays launch it again without the wrapper and are
not counted here (:mod:`..sac.graph`).

**Where a library comes from** (:mod:`..aot`). :func:`library` resolves
each source's library once per process, in this order: the armed
warm-start bundle's ``kernels/`` (:func:`arm_bundle`), then the library
cache directory (:func:`cache_dir`: the one :func:`set_cache_dir` chose,
else ``$TAC_COMPILE_CACHE``, else ``_build/``), then ``nvcc`` into the
cache directory. A library found is a cache hit, a build a miss; both
are counted on the process's watchdog. The names hash the sources, the
``.cuh`` headers and the flags, so a bundle or a cache built from other
sources holds no library this tree would load. Choose the directory and
arm a bundle before the first :func:`load`: loaded entry points are kept
for the whole process.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import typing as t
from pathlib import Path

from torch_actor_critic_tpu_torch.diagnostics.watchdog import get_watchdog

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> (source under csrc/, C symbol, argtypes): the ctypes
# signature of each kernel's entry point. Every pointer and the stream
# are c_void_p.
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES: t.Dict[str, t.Tuple[str, str, tuple]] = {
    "flash_fwd": (
        "flash_fwd", "tac_flash_fwd",
        (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, *(_L,) * 12, _P),
    ),
    "flash_bwd_dq": (
        "flash_bwd", "tac_flash_bwd_dq",
        (*(_P,) * 8, _I, _I, _I, _I, _I, _I, _I, _F, *(_L,) * 18, _P),
    ),
    "flash_bwd_dkv": (
        "flash_bwd", "tac_flash_bwd_dkv",
        (*(_P,) * 8, _I, _I, _I, _I, _I, _I, _I, _F, *(_L,) * 18, _P),
    ),
    # Two (ring, offsets, out) leaves share idx: ring0, ring1, idx, off0,
    # off1, out0, out1, leaves, capacity, H, W, C, B, S, pad, dtype,
    # normalize, stream.
    "pixel_gather": (
        "pixels", "tac_pixel_gather",
        (*(_P,) * 7, _I, _L, *(_I,) * 8, _P),
    ),
    # An empty kernel (grid, block, dynamic shared bytes, stream): the
    # launch-latency floor that chip_smoke.py reads the attention kernels'
    # times against.
    "empty": ("floor", "tac_empty", (_I, _I, _I, _P)),
}

launch_counts: t.Counter[str] = collections.Counter()

_lock = threading.RLock()
_loaded: t.Dict[str, t.Callable[..., int]] = {}
build_logs: t.Dict[str, str] = {}  # source -> nvcc's output (ptxas -v)
CACHE_ENV_VAR = "TAC_COMPILE_CACHE"
_cache_dir: Path | None = None  # set_cache_dir's choice
_bundle_dir: Path | None = None  # the armed bundle's kernels/
_resolved: t.Dict[str, Path] = {}  # source -> the library this process uses


class KernelBuildError(RuntimeError):
    """A kernel could not be compiled or loaded (no nvcc, a compile
    error, a missing symbol). Never caught to fall back to the plain
    version: a CUDA tensor runs the kernel or the call fails."""


def count_launch(name: str) -> None:
    launch_counts[name] += 1


def reset_launch_counts() -> None:
    launch_counts.clear()


def launch(name: str, fn, device, args, shape_note: str) -> None:
    """Call kernel ``name``'s entry point ``fn`` with ``args`` on
    ``device``, raise if the launch was refused (the C function returns
    ``cudaGetLastError()``), and count it."""
    import torch

    if device.index == torch.cuda.current_device():
        err = fn(*args)
    else:  # the runtime launches on the thread's current device
        with torch.cuda.device(device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err} ({shape_note})")
    count_launch(name)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise KernelBuildError(
            "nvcc not found (PATH or $CUDA_HOME/bin); the CUDA kernels "
            "build from csrc/ on a machine with the CUDA toolkit"
        )
    return found


def sources() -> t.Tuple[str, ...]:
    """Every kernel source under ``csrc/`` that :data:`SIGNATURES` names."""
    return tuple(sorted({src for src, _, _ in SIGNATURES.values()}))


def cache_dir() -> Path:
    """The library cache directory: :func:`set_cache_dir`'s, else
    ``$TAC_COMPILE_CACHE``, else ``_build/`` next to the package."""
    if _cache_dir is not None:
        return _cache_dir
    env = os.environ.get(CACHE_ENV_VAR, "")
    return Path(env) if env else BUILD_DIR


def set_cache_dir(path: str | os.PathLike | None) -> None:
    """Build into and look up libraries in ``path`` (None: back to the
    default). Sources not yet resolved in this process are looked up
    again there."""
    global _cache_dir
    with _lock:
        _cache_dir = None if path is None else Path(path)
        _resolved.clear()


def arm_bundle(kernels_dir: str | os.PathLike | None) -> None:
    """Look up libraries in a checked warm-start bundle's ``kernels/``
    before the cache (None disarms); arming the armed one again changes
    nothing."""
    global _bundle_dir
    new = None if kernels_dir is None else Path(kernels_dir)
    with _lock:
        if new != _bundle_dir:
            _bundle_dir = new
            _resolved.clear()


def source_digest() -> str:
    """One hash over every source, header and flag: the fingerprint's
    ``kernel_digest``."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()[:16]


def lib_name(source: str) -> str:
    """This tree's library file name for ``source``."""
    src = SRC_DIR / f"{source}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for extra in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(extra.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return f"lib{source}_{digest.hexdigest()[:16]}.so"


def _lib_path(source: str) -> Path:
    """Where ``source``'s library is cached (and built)."""
    return cache_dir() / lib_name(source)


def library(source: str) -> Path:
    """The library of ``source`` this process uses, built if neither the
    armed bundle nor the cache holds it."""
    with _lock:
        if source not in _resolved:
            build_all(names=[n for n, sig in SIGNATURES.items() if sig[0] == source])
        return _resolved[source]


def build_all(names: t.Iterable[str] | None = None) -> t.Dict[str, float]:
    """Resolve the library of every source of the kernels ``names`` (all
    by default): found in the armed bundle or the cache (a hit), else
    compiled there, all missing ones in parallel (one ``nvcc`` per
    source, started together; a miss). Returns ``{source: seconds}`` for
    the ones built, each also noted to the watchdog (``kernels/build``,
    :mod:`..diagnostics.watchdog`); raises :class:`KernelBuildError`
    with the compiler output on failure."""
    import time

    wd = get_watchdog()
    with _lock:
        pending = {}
        for source in sorted({SIGNATURES[n][0] for n in (names or SIGNATURES)}):
            if source in _resolved:
                continue
            cached = _lib_path(source)
            bundled = _bundle_dir / cached.name if _bundle_dir is not None else None
            found = next((p for p in (bundled, cached) if p is not None and p.exists()), None)
            wd.note_cache_probe(found is not None, from_bundle=found is not None
                                and found == bundled)
            if found is not None:
                _resolved[source] = found
            else:
                pending[source] = cached
        if not pending:
            return {}
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for source, out in pending.items():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".so.tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{source}.cu")]
            procs[source] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                ),
                tmp,
            )
        seconds = {}
        errors = []
        for source, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            build_logs[source] = log
            if proc.returncode != 0:
                errors.append(f"{source}: nvcc exited {proc.returncode}\n{log}")
                continue
            os.replace(tmp, pending[source])  # atomic: readers never see a partial .so
            _resolved[source] = pending[source]
            seconds[source] = time.perf_counter() - t0
            wd.note_build(seconds[source])
        if errors:
            raise KernelBuildError("kernel build failed:\n" + "\n".join(errors))
        return seconds


def load(name: str) -> t.Callable[..., int]:
    """The ctypes entry point of kernel ``name`` from its source's
    :func:`library` (built first if no bundle or cache holds it)."""
    fn = _loaded.get(name)
    if fn is not None:
        return fn
    with _lock:
        fn = _loaded.get(name)
        if fn is not None:
            return fn
        source, symbol, argtypes = SIGNATURES[name]
        path = library(source)
        try:
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, symbol)
        except (OSError, AttributeError) as e:
            raise KernelBuildError(f"cannot load kernel {name!r}: {e}") from e
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _loaded[name] = fn
        return fn
