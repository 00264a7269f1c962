"""The port's CUDA kernel and GPU serving path, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card (the
kernels have no CPU mode). This file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest

Tolerances: f32 1e-4 against the plain version (summation order), bf16
2e-2 (the bf16 rounding of the probability tile), lse 1e-4.
"""

import numpy as np
import pytest
import torch

from torch_actor_critic_tpu_torch.models import build_models
from torch_actor_critic_tpu_torch.models.sequence import plain_attention
from torch_actor_critic_tpu_torch.ops import _kernels
from torch_actor_critic_tpu_torch.ops import attention as tattn
from torch_actor_critic_tpu_torch.serve import ObsSpec, PolicyEngine
from torch_actor_critic_tpu_torch.utils.config import SACConfig


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(64, 4, 16, 16), (2, 3, 100, 64), (1, 2, 37, 24), (1, 1, 5, 128)])
def test_flash_kernel_matches_plain(cuda, shape, dtype, tol):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype) for _ in range(3))
    for causal in (False, True):
        before = _kernels.launch_counts["flash_fwd"]
        out, lse = tattn.flash_attention_forward(q, k, v, causal, return_lse=True)
        assert _kernels.launch_counts["flash_fwd"] == before + 1
        ref, ref_lse = tattn.reference_attention(q, k, v, causal, return_lse=True)
        torch.cuda.synchronize()
        assert out.shape == ref.shape and out.dtype == dtype
        assert (out.float() - ref.float()).abs().max().item() <= tol
        assert (lse - ref_lse).abs().max().item() <= 1e-4


@pytest.mark.gpu
def test_flash_kernel_takes_strided_views(cuda):
    """q/k/v as the model makes them: (B, T, H, d) transposed views."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((8, 16, 4, 16), generator=gen, device=cuda).transpose(1, 2)
    assert not x.is_contiguous()
    out = tattn.attention(x, x, x, True)
    ref = tattn.attention(x, x, x, True, impl="plain")
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.gpu
def test_gpu_engine_serves_through_the_kernel(cuda):
    cfg = SACConfig(history_len=16)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        actor = build_models(cfg, (16, 3), 1, 2.0)
    plain = build_models(cfg, (16, 3), 1, 2.0)
    for blk in plain.trunk.blocks:
        blk.attn.attention_fn = plain_attention
    plain.load_state_dict(actor.state_dict())
    plain = plain.to(cuda).eval()
    eng = PolicyEngine(actor, ObsSpec((16, 3)), max_batch=64, device=cuda)
    params = eng.prepare_params(actor.state_dict())
    obs = np.random.default_rng(0).standard_normal((5, 16, 3)).astype(np.float32)
    before = _kernels.launch_counts["flash_fwd"]
    got = eng.act(params, obs, deterministic=True)
    assert _kernels.launch_counts["flash_fwd"] == before + cfg.seq_num_layers
    with torch.inference_mode():
        want, _ = plain(torch.from_numpy(obs).to(cuda), deterministic=True)
    np.testing.assert_allclose(got, want.cpu().numpy(), atol=1e-4, rtol=0)
    single = eng.act(params, obs[:1], deterministic=True)
    np.testing.assert_allclose(single[0], got[0], atol=1e-5, rtol=0)
