"""The port's attention backward against the JAX package's, on the CPU.

The JAX side is ``jax.vjp`` of the Pallas ``flash_attention`` in
interpret mode with 8x8 blocks — its K3/K4 bodies (``_flash_bwd_dq_kernel``,
``_flash_bwd_dkv_kernel``) run, as tests/test_attention.py runs them.
The port's side is the plain version of each kernel
(``_plain_flash_bwd_dq``, fed JAX's own output and lse, which returns
Δ = rowsum(dO∘O) beside dQ as K3 does, held to JAX's Δ; and
``_plain_flash_bwd_dkv``, fed that Δ) and the ``FlashAttention``
Function, whose CPU launches are those plain versions — so the
Function's bookkeeping (saved lse, Δ, head-dim padding, the cotangent's
dtype, the model's (B, T, H, d) views) is what is checked here; the card
holds each kernel against the same plain functions
(tests/test_torch_gpu.py, chip_smoke.py). Cotangents are random, not
ones.

Tolerances: f32 1e-4 (JAX's own for its flash gradients); bf16 2e-2
against the JAX result in bf16 (a few bf16 ulps at these magnitudes;
both sides round p and ds to bf16 at the same points).
"""

import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_actor_critic_tpu.ops import attention as jattn
from torch_actor_critic_tpu_torch.ops import _kernels
from torch_actor_critic_tpu_torch.ops import attention as tattn

B, H = 2, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny ops: one intra-op thread avoids the oversubscription of
    several test workers each spinning a full thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(t, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, H, t, d)).astype(np.float32) for _ in range(4))
    return q, k, v, g


def _jax_vjp(q, k, v, g, causal, dtype=jnp.float32):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    out, vjp = jax.vjp(
        lambda a, b, c: jattn.flash_attention(a, b, c, causal, 8, 8, True), *args
    )
    return out, vjp(jnp.asarray(g, dtype))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [5, 16])
@pytest.mark.parametrize("t", [8, 16, 32])
def test_flash_gradients_match_jax_pallas_interpret(t, d, causal):
    q, k, v, g = _inputs(t, d, seed=10 * t + d + causal)
    want_out, (dq_w, dk_w, dv_w) = _jax_vjp(q, k, v, g, causal)

    # The Function (K2 forward, K3/K4 backward; plain versions on CPU).
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.attention(tq, tk, tv, causal)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    dq, dk, dv = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), _np(want_out), atol=1e-4, rtol=0)
    for got, want in ((dq, dq_w), (dk, dk_w), (dv, dv_w)):
        assert got.shape == (B, H, t, d) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4, rtol=0)

    # Each kernel's plain version alone, on JAX's output and saved lse;
    # K3's Δ against JAX's (``_flash_backward``'s rowsum(g∘o) in f32).
    _, lse = jattn._flash_forward(
        *(jnp.asarray(x) for x in (q, k, v)), causal, 8, 8, True, save_lse=True
    )
    want_delta = jnp.sum(
        jnp.asarray(g).astype(jnp.float32) * want_out.astype(jnp.float32), axis=-1
    )
    tq_, tk_, tv_, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tlse = torch.from_numpy(np.array(lse))
    scale = 1.0 / math.sqrt(d)
    pdq, delta = tattn._plain_flash_bwd_dq(
        tq_, tk_, tv_, torch.from_numpy(np.array(_np(want_out))), tg, tlse, causal, scale
    )
    assert delta.shape == (B, H, t) and delta.dtype == torch.float32
    np.testing.assert_allclose(delta.numpy(), np.asarray(want_delta), atol=1e-6, rtol=0)
    pdk, pdv = tattn._plain_flash_bwd_dkv(tq_, tk_, tv_, tg, tlse, delta, causal, scale)
    for got, want in ((pdq, dq_w), (pdk, dk_w), (pdv, dv_w)):
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [5, 16])
def test_flash_gradients_bf16_match_jax_pallas_interpret(d, causal):
    q, k, v, g = _inputs(16, d, seed=200 + d + causal)
    _, (dq_w, dk_w, dv_w) = _jax_vjp(q, k, v, g, causal, jnp.bfloat16)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v))
    out = tattn.attention(tq, tk, tv, causal)
    # An f32 cotangent over a bf16 output is cast to bf16 by the backward.
    dq, dk, dv = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for got, want in ((dq, dq_w), (dk, dk_w), (dv, dv_w)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), _np(want), atol=2e-2, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_function_saves_jax_lse(causal):
    q, k, v, _ = _inputs(16, 5, seed=7)
    _, want_lse = jattn._flash_forward(
        *(jnp.asarray(x) for x in (q, k, v)), causal, None, None, True, save_lse=True
    )
    out = tattn.attention(*(torch.from_numpy(x).requires_grad_() for x in (q, k, v)), causal)
    saved = out.grad_fn.saved_tensors
    lse = saved[-1]
    assert lse.dtype == torch.float32 and lse.shape == (B, H, 16)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5, rtol=0)


def test_no_grad_and_inference_take_the_forward_only_path():
    q, k, v, _ = _inputs(8, 16, seed=3)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with torch.no_grad():
        assert tattn.attention(tq, tk, tv, True).grad_fn is None
    with torch.inference_mode():
        assert tattn.attention(tq, tk, tv, True).grad_fn is None
    plain = (torch.from_numpy(x) for x in (q, k, v))
    assert tattn.attention(*plain, True).grad_fn is None


def test_cpu_backward_never_counts_a_launch():
    _kernels.reset_launch_counts()
    q, k, v, g = _inputs(16, 5, seed=4)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.attention(tq, tk, tv, True)
    torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    assert sum(_kernels.launch_counts.values()) == 0


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


def test_cuda_typed_backward_without_kernel_build_raises(monkeypatch):
    """A tensor off the CPU goes to K3/K4 or fails: with no build the
    loader's error surfaces, and no plain version is taken."""
    def no_build(name):
        raise _kernels.KernelBuildError(f"{name}: nvcc not found")

    def plain_forbidden(*a, **kw):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(_kernels, "load", no_build)
    monkeypatch.setattr(tattn, "_plain_flash_bwd_dq", plain_forbidden)
    monkeypatch.setattr(tattn, "_plain_flash_bwd_dkv", plain_forbidden)
    q = _meta(B, H, 16, 16)
    with pytest.raises(_kernels.KernelBuildError):
        tattn.flash_attention_backward(q, q, q, q, _meta(B, H, 16), q, True)


def test_backward_wrapper_rejects_non_cuda_operands(monkeypatch):
    calls = []
    monkeypatch.setattr(_kernels, "load", lambda name: lambda *a: calls.append(a) or 0)
    q = _meta(B, H, 16, 16)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tattn.flash_attention_backward(q, q, q, q, _meta(B, H, 16), q, True)
    with pytest.raises(ValueError, match="lse"):
        tattn.flash_attention_backward(q, q, q, q, _meta(B, H, 8), q, True)
    assert calls == []


def test_backward_kernels_are_registered_in_one_source():
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        source, symbol, argtypes = _kernels.SIGNATURES[name]
        assert source == "flash_bwd" and symbol == f"tac_{name}"
        assert (_kernels.SRC_DIR / "flash_bwd.cu").read_text().count(symbol) >= 1
    # 8 pointers, B, H, Tq, Tk, d, dtype, causal, scale, 6 x 3 strides, stream
    assert len(_kernels.SIGNATURES["flash_bwd_dq"][2]) == 35
    assert len(_kernels.SIGNATURES["flash_bwd_dkv"][2]) == 35


def test_floor_kernel_is_registered():
    source, symbol, argtypes = _kernels.SIGNATURES["empty"]
    assert (_kernels.SRC_DIR / f"{source}.cu").read_text().count(symbol) >= 1
    assert len(argtypes) == 4  # grid, block, dynamic shared bytes, stream


def test_kernel_sources_share_the_mma_header(monkeypatch, tmp_path):
    """K2-K4 include one header of tensor-core helpers; the library
    names hash it, so an edit there rebuilds both libraries."""
    for source in ("flash_fwd", "flash_bwd"):
        assert '#include "mma_sm90.cuh"' in (_kernels.SRC_DIR / f"{source}.cu").read_text()
    shutil.copytree(_kernels.SRC_DIR, tmp_path / "csrc")
    monkeypatch.setattr(_kernels, "SRC_DIR", tmp_path / "csrc")
    before = {s: _kernels._lib_path(s) for s in ("flash_fwd", "flash_bwd")}
    header = tmp_path / "csrc" / "mma_sm90.cuh"
    header.write_text(header.read_text() + "\n")
    assert all(_kernels._lib_path(s) != p for s, p in before.items())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_flash_backward_returns_plain_values_in_bhtd(causal, dtype):
    """On CPU tensors (the model's split (B, T, H, d) views, the
    cotangent a view too) the wrapper returns its plain versions'
    values, in the (B, H, T, d) shape, and K3's Δ."""
    rng = np.random.default_rng(12)

    def view():
        x = rng.standard_normal((B, 16, 64)).astype(np.float32)
        return torch.from_numpy(x).to(dtype).reshape(B, 16, 4, 16).transpose(1, 2)

    q, k, v, do = view(), view(), view(), view()
    out, lse = tattn.flash_attention_forward(q, k, v, causal, return_lse=True)
    dq, dk, dv, delta = tattn.flash_attention_backward(q, k, v, out, lse, do, causal)
    want_dq, want_delta = tattn._plain_flash_bwd_dq(q, k, v, out, do, lse, causal, 0.25)
    want_dk, want_dv = tattn._plain_flash_bwd_dkv(q, k, v, do, lse, want_delta, causal, 0.25)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv), (delta, want_delta)):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got, want)
    assert dq.shape == (B, 4, 16, 16) and delta.shape == (B, 4, 16)
