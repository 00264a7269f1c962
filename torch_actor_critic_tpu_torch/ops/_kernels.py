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

_lock = threading.Lock()
_loaded: t.Dict[str, t.Callable[..., int]] = {}
build_logs: t.Dict[str, str] = {}  # source -> nvcc's output (ptxas -v)


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


def _lib_path(source: str) -> Path:
    src = SRC_DIR / f"{source}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for extra in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(extra.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source}_{digest.hexdigest()[:16]}.so"


def build_all(names: t.Iterable[str] | None = None) -> t.Dict[str, float]:
    """Compile every missing library of the kernels ``names`` (all by
    default) in parallel (one ``nvcc`` per source, started together)
    and wait for all of them. Returns ``{source: seconds}`` for the
    ones built, each also noted to the watchdog (``kernels/build``,
    :mod:`..diagnostics.watchdog`); raises :class:`KernelBuildError`
    with the compiler output on failure."""
    import time

    sources = sorted({SIGNATURES[n][0] for n in (names or SIGNATURES)})
    pending = {s: _lib_path(s) for s in sources if not _lib_path(s).exists()}
    if not pending:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for source, out in pending.items():
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
        seconds[source] = time.perf_counter() - t0
        get_watchdog().note_build(seconds[source])
    if errors:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(errors))
    return seconds


def load(name: str) -> t.Callable[..., int]:
    """The ctypes entry point of kernel ``name``, building its library
    first if this checkout has not yet."""
    fn = _loaded.get(name)
    if fn is not None:
        return fn
    with _lock:
        fn = _loaded.get(name)
        if fn is not None:
            return fn
        build_all([name])
        source, symbol, argtypes = SIGNATURES[name]
        try:
            lib = ctypes.CDLL(str(_lib_path(source)))
            fn = getattr(lib, symbol)
        except (OSError, AttributeError) as e:
            raise KernelBuildError(f"cannot load kernel {name!r}: {e}") from e
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _loaded[name] = fn
        return fn
