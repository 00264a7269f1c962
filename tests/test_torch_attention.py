"""The port's attention against the JAX package's, on the CPU.

Same numpy inputs (seeded) go through the JAX functions — the plain
``reference_attention`` and the Pallas ``flash_attention`` in interpret
mode, as tests/test_attention.py runs it — and through the port, whose
CPU path is its plain version. f32 agrees to 1e-5 (summation order).
bf16 is held at 2e-2 against JAX's flash kernel in bf16: both round the
probability tile to bf16 before P·V, and 2e-2 is a few bf16 ulps at
these magnitudes.

The CUDA kernel itself cannot run here (no card, no nvcc):
``chip_smoke.py`` holds it against the plain version on the card, and
tests/test_torch_gpu.py does the same when a card is present.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_actor_critic_tpu.ops import attention as jattn
from torch_actor_critic_tpu_torch.ops import _kernels
from torch_actor_critic_tpu_torch.ops import attention as tattn

B, H = 2, 2


def _qkv(t, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, H, t, d)).astype(np.float32) for _ in range(3))


def _torch(*xs, dtype=torch.float32):
    return tuple(torch.from_numpy(x).to(dtype) for x in xs)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("t", [8, 16, 40])
def test_reference_attention_matches_jax_reference(t, d, causal):
    q, k, v = _qkv(t, d, seed=t + d)
    want = np.asarray(jattn.reference_attention(q, k, v, causal))
    got = tattn.reference_attention(*_torch(q, k, v), causal).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("t", [8, 16, 40])
def test_attention_auto_matches_jax_flash_interpret(t, d, causal, dtype):
    q, k, v = _qkv(t, d, seed=100 + t + d)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jattn.flash_attention(
        *(jnp.asarray(x, dtype=jdt) for x in (q, k, v)), causal, None, None, True
    )
    got = tattn.attention(*_torch(q, k, v, dtype=tdt), causal)
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=tol, rtol=0
    )


@pytest.mark.parametrize(
    "q_offset,k_offset", [(0, 0), (8, 0), (0, 8), (16, 4)],
)
def test_reference_attention_offsets_match_jax(q_offset, k_offset):
    """Global q/k offsets, including rows that see no key at all
    (k_offset past the row's position), which must come out 0."""
    q, k, v = _qkv(8, 16, seed=7)
    want = np.asarray(
        jattn.reference_attention(q, k, v, True, q_offset=q_offset, k_offset=k_offset)
    )
    got = tattn.reference_attention(
        *_torch(q, k, v), True, q_offset=q_offset, k_offset=k_offset
    ).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if k_offset > q_offset:
        assert np.all(got[:, :, : k_offset - q_offset] == 0.0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_forward_lse_matches_jax_saved_lse(causal):
    q, k, v = _qkv(16, 16, seed=3)
    want_out, want_lse = jattn._flash_forward(
        *(jnp.asarray(x) for x in (q, k, v)), causal, None, None, True, save_lse=True
    )
    out, lse = tattn.flash_attention_forward(*_torch(q, k, v), causal, return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5, rtol=0)


def test_cpu_path_never_counts_a_launch():
    _kernels.reset_launch_counts()
    q, k, v = _torch(*_qkv(16, 16))
    tattn.attention(q, k, v, True)
    tattn.flash_attention_forward(q, k, v, False, return_lse=True)
    tattn.attention(q, k, v, True, impl="plain")
    assert _kernels.launch_counts["flash_fwd"] == 0


def _meta_qkv():
    return tuple(torch.empty((B, H, 16, 16), device="meta") for _ in range(3))


def test_non_cpu_tensor_without_kernel_build_raises(monkeypatch):
    """A tensor off the CPU goes to the kernel or fails: with no build
    available the loader's error surfaces, the plain version is never
    taken."""
    def no_build(name):
        raise _kernels.KernelBuildError(f"{name}: nvcc not found")

    def plain_forbidden(*a, **kw):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(_kernels, "load", no_build)
    monkeypatch.setattr(tattn, "reference_attention", plain_forbidden)
    with pytest.raises(_kernels.KernelBuildError):
        tattn.attention(*_meta_qkv(), True)


def test_non_cuda_device_is_rejected_by_the_wrapper(monkeypatch):
    """With a (fake) built kernel, a tensor that is neither CPU nor CUDA
    is refused before any launch — not silently served."""
    calls = []
    monkeypatch.setattr(_kernels, "load", lambda name: lambda *a: calls.append(a) or 0)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tattn.flash_attention_forward(*_meta_qkv(), True)
    assert calls == []


def test_attention_rejects_unknown_impl():
    with pytest.raises(ValueError):
        tattn.attention(*_torch(*_qkv(8, 16)), True, impl="xla")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_kernels, "_lib_path", lambda name: tmp_path / f"lib{name}.so")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(_kernels.KernelBuildError, match="nvcc"):
        _kernels.build_all(["flash_fwd"])


def test_library_name_is_keyed_on_the_source():
    path = _kernels._lib_path("flash_fwd")
    assert path.parent == _kernels.BUILD_DIR
    assert path.name.startswith("libflash_fwd_") and path.suffix == ".so"
    assert _kernels._lib_path("flash_fwd") == path  # stable for one source


def test_jax_flash_path_runs_on_cpu_backend():
    """Guard for the comparisons above: conftest pins JAX to the CPU."""
    assert jax.default_backend() == "cpu"
