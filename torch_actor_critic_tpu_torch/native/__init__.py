"""ctypes loader for the native runtime (``libtacrt.so``; port of the JAX
package's ``native/__init__.py``, the port's own copy of
``tac_runtime.cpp`` beside it).

The library is tiny (one translation unit, no dependencies), so it is
built with ``g++`` at first use into ``_build/`` next to the package,
under a name keyed on a hash of the source (an edited source rebuilds),
one-time, ~1s. Set ``TAC_NATIVE_LIB`` to use a specific build (e.g. the
ASan variant from ``make asan`` in this directory).

``load_runtime`` returns ``None`` when the library is unavailable
(no compiler, non-Linux); callers fall back to pure-Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

logger = logging.getLogger(__name__)

_NATIVE_DIR = Path(__file__).parent
BUILD_DIR = _NATIVE_DIR.parent / "_build"
_LOCK = threading.Lock()
_CACHE: dict = {}

SOURCES = [_NATIVE_DIR / "tac_runtime.cpp"]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.tac_store_wake.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.tac_store_wake.restype = None
    lib.tac_load.argtypes = [ctypes.c_void_p]
    lib.tac_load.restype = ctypes.c_int32
    lib.tac_wait_ne.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64]
    lib.tac_wait_ne.restype = ctypes.c_int
    lib.tac_wait_all_eq.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.tac_wait_all_eq.restype = ctypes.c_int
    return lib


def lib_path() -> Path:
    """Where the loader builds the runtime: ``_build/libtacrt-<hash>.so``."""
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in SOURCES)).hexdigest()[:12]
    return BUILD_DIR / f"libtacrt-{digest}.so"


def _build(out: Path) -> bool:
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O2",
        "-Wall",
        "-fPIC",
        "-std=c++17",
        "-shared",
        "-o",
        str(out),
        *[str(s) for s in SOURCES],
    ]
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        # Build to a temp file then rename: concurrent builds (e.g.
        # spawned env workers racing the parent) each land a complete .so.
        with tempfile.NamedTemporaryFile(
            dir=out.parent, suffix=".so.tmp", delete=False
        ) as tmp:
            tmp_path = Path(tmp.name)
        cmd[cmd.index(str(out))] = str(tmp_path)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp_path, out)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        logger.debug("native build failed: %s", e)
        if "tmp_path" in locals():
            tmp_path.unlink(missing_ok=True)
        return False


def load_runtime(build_if_missing: bool = True) -> ctypes.CDLL | None:
    """Load (building if needed) the native runtime, or ``None``."""
    if not sys.platform.startswith("linux"):
        return None
    with _LOCK:
        if "lib" in _CACHE:
            return _CACHE["lib"]
        path = os.environ.get("TAC_NATIVE_LIB")
        cand = Path(path) if path else lib_path()
        if cand.exists():
            try:
                _CACHE["lib"] = _declare(ctypes.CDLL(str(cand)))
                return _CACHE["lib"]
            except OSError as e:
                logger.warning("failed to load %s: %s", cand, e)
        if build_if_missing and path is None:
            if _build(cand):
                try:
                    _CACHE["lib"] = _declare(ctypes.CDLL(str(cand)))
                    return _CACHE["lib"]
                except OSError as e:  # pragma: no cover
                    logger.warning("failed to load built %s: %s", cand, e)
        _CACHE["lib"] = None
        return None
