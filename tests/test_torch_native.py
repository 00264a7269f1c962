"""The port's copy of the native futex runtime
(``torch_actor_critic_tpu_torch/native``): byte for byte the JAX
package's source, built by its own loader into ``_build/``, and run
under AddressSanitizer as ``tests/test_native_asan.py`` runs the JAX
package's copy (store/load, a cross-thread ``wait_ne`` wake,
``wait_all_eq`` over a strided barrier, both timeout paths), loaded
through the port's loader with ``TAC_NATIVE_LIB``.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from torch_actor_critic_tpu_torch import native

REPO = Path(__file__).resolve().parent.parent
PORT_NATIVE = REPO / "torch_actor_critic_tpu_torch" / "native"

_EXERCISE = r"""
import importlib.util, sys, threading, time
import numpy as np

# The loader module alone (the package __init__ would import torch under ASan).
spec = importlib.util.spec_from_file_location("tac_native", sys.argv[1])
loader = importlib.util.module_from_spec(spec)
spec.loader.exec_module(loader)
lib = loader.load_runtime()
assert lib is not None

buf = np.zeros(64, np.int32)
base = buf.ctypes.data
lib.tac_store_wake(base, 7)
assert lib.tac_load(base) == 7
assert lib.tac_wait_ne(base, 7, 50) != 0

def waker():
    time.sleep(0.05)
    lib.tac_store_wake(base, 8)
t = threading.Thread(target=waker); t.start()
assert lib.tac_wait_ne(base, 7, 5000) == 0
t.join()
assert lib.tac_load(base) == 8

n, stride = 4, 16
words = np.zeros(64, np.int32)
targets = np.ones(64, np.int32)
wbase, tbase = words.ctypes.data, targets.ctypes.data
for i in range(n):
    lib.tac_store_wake(wbase + 4 * i * stride, 1)
lib.tac_store_wake(wbase + 4 * 2 * stride, 0)
def release():
    time.sleep(0.05)
    lib.tac_store_wake(wbase + 4 * 2 * stride, 1)
t = threading.Thread(target=release); t.start()
assert lib.tac_wait_all_eq(wbase, tbase, n, stride, 5000) == 0
t.join()
lib.tac_store_wake(wbase + 4 * 3 * stride, 0)
assert lib.tac_wait_all_eq(wbase, tbase, n, stride, 50) == -4
print("ASAN_EXERCISE_OK")
"""


def test_the_runtime_source_is_the_jax_packages_byte_for_byte():
    jax_native = REPO / "torch_actor_critic_tpu" / "native"
    assert (PORT_NATIVE / "tac_runtime.cpp").read_bytes() == (
        jax_native / "tac_runtime.cpp").read_bytes()
    assert "asan:" in (PORT_NATIVE / "Makefile").read_text()


def test_the_loader_builds_into_the_build_directory():
    if not sys.platform.startswith("linux"):
        pytest.skip("linux-only native runtime")
    lib = native.load_runtime()
    if lib is None:
        pytest.skip("no C++ compiler")
    path = native.lib_path()
    assert path.parent == REPO / "torch_actor_critic_tpu_torch" / "_build" and path.exists()
    assert lib.tac_load.restype is not None


def test_a_missing_tac_native_lib_loads_nothing_and_builds_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_CACHE", {})
    monkeypatch.setenv("TAC_NATIVE_LIB", str(tmp_path / "absent.so"))
    assert native.load_runtime() is None
    assert not list(tmp_path.iterdir())


def _libasan() -> str:
    try:
        out = subprocess.run([os.environ.get("CXX", "g++"), "-print-file-name=libasan.so"],
                             capture_output=True, text=True).stdout.strip()
    except FileNotFoundError:
        pytest.skip("C++ toolchain not available")
    if not out or not os.path.isabs(out) or not os.path.exists(out):
        pytest.skip("libasan not available")
    return out


def test_the_ports_runtime_under_asan(tmp_path):
    if not sys.platform.startswith("linux"):
        pytest.skip("linux-only native runtime")
    libasan = _libasan()
    # The Makefile's asan rule, into the test's directory.
    asan_so = tmp_path / "libtacrt_asan.so"
    build = subprocess.run(
        [os.environ.get("CXX", "g++"), "-O1", "-g", "-Wall", "-Wextra", "-fPIC", "-std=c++17",
         "-fsanitize=address", "-shared", "-o", str(asan_so),
         str(PORT_NATIVE / "tac_runtime.cpp")], capture_output=True, text=True)
    assert build.returncode == 0, build.stderr
    script = tmp_path / "exercise.py"
    script.write_text(_EXERCISE)
    env = {**os.environ, "LD_PRELOAD": libasan, "TAC_NATIVE_LIB": str(asan_so),
           "ASAN_OPTIONS": "detect_leaks=0,abort_on_error=1"}
    proc = subprocess.run([sys.executable, str(script), str(PORT_NATIVE / "__init__.py")],
                          capture_output=True, text=True, timeout=120, env=env)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert "ASAN_EXERCISE_OK" in out and "AddressSanitizer" not in out, out
