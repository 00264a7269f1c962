"""The port's CUDA kernels and its GPU serving and training paths, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card (the
kernels have no CPU mode). This file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest

K1 (``csrc/pixels.cu``) is exact integer selection and a correctly
rounded divide: it equals its plain version bitwise, and a visual update
fed by it equals one fed by the plain gather to the slice-2 limits
(cuDNN's convolution backward may sum in another order run to run).

Tolerances: f32 1e-4 against the plain version (summation order), bf16
2e-2 (the bf16 rounding of the probability tile), lse 1e-4; K2's f32
forward is held to 1e-5, which its 3xTF32 products meet (~5e-7) and a
single TF32 pass (~1e-3) would not; for the backward kernels (K3's Δ
included) those limits scale by max(1, max|plain|), f32 held to
1e-5·max(1, max|plain|) for the same reason. A full-width
update with the kernels agrees with the same update through plain
attention to 1e-4 in every parameter except the attention key biases,
whose gradient is zero in exact arithmetic (softmax ignores a per-row
shift), so Adam turns rounding noise into steps up to ``lr``: those
are held to 2·lr, and the updated networks' outputs to 1e-4.

A burst captured as a CUDA graph equals the eager burst from one cloned
state to the bit; the visual one runs both on cuDNN's deterministic
algorithms, as its default convolution backward is not bitwise run to
run. The serving engine's graphs (one per bucket and mode) equal its
eager forward to the bit, the sampled ones from one generator state.
"""

import math
import os

import numpy as np
import pytest
import torch

from torch_actor_critic_tpu_torch.models import build_actor
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
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [
    (64, 4, 16, 16), (2, 3, 100, 64), (1, 2, 37, 24), (1, 1, 5, 128),
    # Tq <= 16, four (batch*head) pairs per block, B*H not a multiple of 4
    (3, 1, 16, 16), (1, 1, 1, 32), (5, 3, 9, 64),
    # several double-buffered key tiles
    (1, 2, 1000, 32), (1, 2, 200, 128),
])
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width,offset,in_place", [(64, 0, True), (104, 8, True), (104, 1, False)])
def test_flash_kernel_takes_strided_views(cuda, dtype, width, offset, in_place):
    """q/k/v as the model makes them: (B, T, H, d) transposed views of a
    (B, T, width) buffer, here also sliced with a storage offset. Read
    in place when base and strides stay 16-byte aligned, copied first
    when they do not; both match the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = []
    for _ in range(3):
        wide = torch.randn((3, 20, width), generator=gen, device=cuda).to(dtype)
        qkv.append(wide[:, :, offset:offset + 64].reshape(3, 20, 4, 16).transpose(1, 2))
    assert not qkv[0].is_contiguous() and qkv[0].storage_offset() == offset
    assert all(tattn._reads_in_place(x) is in_place for x in qkv)
    out, lse = tattn.flash_attention_forward(*qkv, True, return_lse=True)
    ref, ref_lse = tattn.reference_attention(*qkv, True, return_lse=True)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4


def _device_kernels(fn, calls=10, attempts=8):
    """``(name, calls)`` of the device kernels one ``fn()`` launched:
    each kernel's count in one ``torch.profiler`` trace of ``calls``
    calls over ``calls``, rounded (a trace can lose its first few
    kernels, or all of them: an empty trace is retaken, up to
    ``attempts`` in all)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, round(e.count / calls)) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
        rows = [(key, n) for key, n in rows if n]
        if rows:
            return rows
    return []


@pytest.mark.gpu
def test_flash_forward_on_model_views_is_one_kernel(cuda):
    """At the serving shape, on the model's split (B, T, H, d) views, one
    K2 call is one device kernel: no copy before it and none after."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn((64, 16, 64), generator=gen, device=cuda)
               .reshape(64, 16, 4, 16).transpose(1, 2) for _ in range(3))
    assert all(tattn._reads_in_place(x) for x in (q, k, v))
    tattn.flash_attention_forward(q, k, v, True)
    torch.cuda.synchronize()
    rows = _device_kernels(lambda: tattn.flash_attention_forward(q, k, v, True))
    assert len(rows) == 1 and rows[0][1] == 1 and "flash_fwd_kernel" in rows[0][0], rows


@pytest.mark.gpu
def test_mha_output_reaches_o_without_a_copy(cuda):
    """The attention output is a (B, H, T, d) view of (B, T, H, d)
    memory, so MultiHeadAttention's merge of the heads is a view: the
    o projection reads the kernel's output buffer itself."""
    from torch_actor_critic_tpu_torch.models.sequence import MultiHeadAttention

    mha = MultiHeadAttention(64, 4, generator=torch.Generator().manual_seed(0)).to(cuda)
    seen = {}

    def attention_fn(q, k, v, causal=True):
        seen["out"] = tattn.attention(q, k, v, causal)
        return seen["out"]

    mha.attention_fn = attention_fn
    mha.o.register_forward_pre_hook(lambda mod, args: seen.__setitem__("o_in", args[0]))
    with torch.inference_mode():
        mha(torch.randn((8, 16, 64), device=cuda))
    assert seen["o_in"].data_ptr() == seen["out"].data_ptr()


@pytest.mark.gpu
def test_gpu_engine_serves_through_the_kernel(cuda):
    cfg = SACConfig(history_len=16)
    actor = build_actor(cfg, (16, 3), 1, 2.0, generator=torch.Generator().manual_seed(0))
    plain = build_actor(cfg, (16, 3), 1, 2.0)
    for blk in plain.trunk.blocks:
        blk.attn.attention_fn = plain_attention
    plain.load_state_dict(actor.state_dict())
    plain = plain.to(cuda).eval()
    eng = PolicyEngine(actor, ObsSpec((16, 3)), max_batch=64, device=cuda)
    params = eng.prepare_params(actor.state_dict())
    obs = np.random.default_rng(0).standard_normal((5, 16, 3)).astype(np.float32)
    before = _kernels.launch_counts["flash_fwd"]
    got = eng.act(params, obs, deterministic=True)
    # The first act captures its bucket's graph: the wrapper counts the
    # eager warm-up's launches and the capture's; a replay calls none.
    assert _kernels.launch_counts["flash_fwd"] == before + 2 * cfg.seq_num_layers
    eng.act(params, obs, deterministic=True)
    assert _kernels.launch_counts["flash_fwd"] == before + 2 * cfg.seq_num_layers
    rows = dict(_device_kernels(lambda: eng.act(params, obs, deterministic=True)))
    assert sum(n for key, n in rows.items() if "flash_fwd_kernel" in key) == cfg.seq_num_layers
    with torch.inference_mode():
        want, _ = plain(torch.from_numpy(obs).to(cuda), deterministic=True)
    np.testing.assert_allclose(got, want.cpu().numpy(), atol=1e-4, rtol=0)
    single = eng.act(params, obs[:1], deterministic=True)
    np.testing.assert_allclose(single[0], got[0], atol=1e-5, rtol=0)


TRAIN_SHAPE = (64, 4, 16, 16)


def _plain_backward(q, k, v, out, lse, do, causal):
    """K3's and K4's plain versions on the wrapper's padded operands:
    ``(dq, dk, dv, Δ)``."""
    d = q.shape[-1]
    dp = next(x for x in (16, 32, 64, 128) if x >= d)
    pad = (lambda x: torch.nn.functional.pad(x, (0, dp - d))) if dp != d else (lambda x: x)
    q, k, v, out, do = (pad(x) for x in (q, k, v, out, do))
    scale = 1.0 / math.sqrt(d)
    dq, delta = tattn._plain_flash_bwd_dq(q, k, v, out, do, lse, causal, scale)
    dk, dv = tattn._plain_flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq[..., :d], dk[..., :d], dv[..., :d], delta


def _assert_backward_close(got, want, dtype):
    """Each of dq, dk, dv and Δ within TOL x max(1, max|plain|); f32 also
    within 1e-5 x max(1, max|plain|), which 3xTF32 meets and a single
    TF32 pass would not."""
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        w = w.float()
        limit = tol * max(1.0, w.abs().max().item())
        assert (g.float() - w).abs().max().item() <= limit


@pytest.mark.gpu
@pytest.mark.parametrize("shape,causal,dtype", [
    (TRAIN_SHAPE, True, torch.float32),
    ((4, 8, 2048, 64), True, torch.float32),
    ((4, 8, 2048, 64), False, torch.float32),
    ((4, 8, 2048, 64), True, torch.bfloat16),
    ((4, 8, 2048, 64), False, torch.bfloat16),
    ((4, 8, 1000, 64), True, torch.float32),
    ((1, 2, 37, 24), False, torch.bfloat16),
    # packed (Tq, Tk <= 16), B*H not a multiple of 4
    ((3, 5, 16, 16), True, torch.float32),
    ((3, 5, 16, 16), False, torch.bfloat16),
    ((2, 3, 9, 32), True, torch.bfloat16),
    # several double-buffered tiles on both sides
    ((2, 3, 100, 64), True, torch.float32),
    ((2, 3, 100, 64), False, torch.bfloat16),
    ((1, 2, 200, 32), True, torch.bfloat16),
    ((1, 2, 200, 128), True, torch.float32),
    ((1, 2, 200, 128), False, torch.float32),
    ((1, 2, 100, 128), True, torch.bfloat16),
])
def test_flash_backward_kernels_match_plain_and_repeat_bitwise(cuda, shape, causal, dtype):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, do = (torch.randn(shape, generator=gen, device=cuda).to(dtype) for _ in range(4))
    out, lse = tattn.flash_attention_forward(q, k, v, causal, return_lse=True)
    before = dict(_kernels.launch_counts)
    got = tattn.flash_attention_backward(q, k, v, out, lse, do, causal)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert _kernels.launch_counts[name] == before.get(name, 0) + 1
    again = tattn.flash_attention_backward(q, k, v, out, lse, do, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = _plain_backward(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    _assert_backward_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width,offset,in_place", [(64, 0, True), (104, 8, True), (104, 1, False)])
def test_flash_backward_takes_strided_views(cuda, dtype, width, offset, in_place):
    """q/k/v and dO as the model hands them over: (B, T, H, d) transposed
    views of (B, T, width) buffers, here also sliced with a storage
    offset. Read in place when base and strides stay 16-byte aligned,
    copied first when they do not; dq/dk/dv come back as (B, H, T, d)
    views of (B, T, H, d) memory; both match the plain versions."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    views = []
    for _ in range(4):
        wide = torch.randn((3, 20, width), generator=gen, device=cuda).to(dtype)
        views.append(wide[:, :, offset:offset + 64].reshape(3, 20, 4, 16).transpose(1, 2))
    q, k, v, do = views
    assert not do.is_contiguous() and do.storage_offset() == offset
    assert all(tattn._reads_in_place(x) is in_place for x in views)
    out, lse = tattn.flash_attention_forward(q, k, v, True, return_lse=True)
    got = tattn.flash_attention_backward(q, k, v, out, lse, do, True)
    assert all(g.transpose(1, 2).is_contiguous() for g in got[:3])
    want = _plain_backward(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    _assert_backward_close(got, want, dtype)


@pytest.mark.gpu
def test_flash_backward_on_model_views_is_two_kernels(cuda):
    """At the training shape, on the model's split (B, T, H, d) views
    (dO too, as the head merge's backward hands it over), one backward
    call is two device kernels, K3 and K4: no copy, no Δ kernel."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k, v, do = (torch.randn((64, 16, 64), generator=gen, device=cuda)
                   .reshape(64, 16, 4, 16).transpose(1, 2) for _ in range(4))
    out, lse = tattn.flash_attention_forward(q, k, v, True, return_lse=True)

    def backward():
        return tattn.flash_attention_backward(q, k, v, out, lse, do, True)

    backward()
    torch.cuda.synchronize()
    rows = _device_kernels(backward)
    assert len(rows) == 2 and all(n == 1 for _, n in rows), rows
    for name in ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"):
        assert sum(name in key for key, _ in rows) == 1, rows


@pytest.mark.gpu
def test_mha_input_gradients_reach_qkv_without_a_copy(cuda, monkeypatch):
    """dq/dk/dv are (B, H, T, d) views of (B, T, H, d) memory, so the
    backward of MultiHeadAttention's head split is a view: the q, k and
    v projections receive the kernels' output buffers themselves."""
    from torch_actor_critic_tpu_torch.models.sequence import MultiHeadAttention

    mha = MultiHeadAttention(64, 4, generator=torch.Generator().manual_seed(0)).to(cuda)
    seen = {}
    backward = tattn.flash_attention_backward

    def recording_backward(*args, **kwargs):
        seen["dqkv"] = backward(*args, **kwargs)
        return seen["dqkv"]

    monkeypatch.setattr(tattn, "flash_attention_backward", recording_backward)
    for name in ("q", "k", "v"):
        def hook(mod, args, out, name=name):
            out.register_hook(lambda g: seen.__setitem__(name, g))
        getattr(mha, name).register_forward_hook(hook)
    x = torch.randn((8, 16, 64), device=cuda)
    mha(x).square().sum().backward()
    for name, g in zip("qkv", seen["dqkv"]):
        assert seen[name].data_ptr() == g.data_ptr(), name


@pytest.mark.gpu
def test_attention_grad_runs_the_kernels_on_strided_cotangents(cuda):
    """The model's MHA hands back a strided cotangent (its output is
    transposed); the Function launches K2, K3 and K4 once each."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((8, 16, 4, 16), generator=gen, device=cuda).transpose(1, 2)
    q, k, v = (x.clone().requires_grad_() for _ in range(3))
    before = dict(_kernels.launch_counts)
    out = tattn.attention(q, k, v, True)
    loss = out.transpose(1, 2).reshape(8, 16, 64).square().sum()
    grads = torch.autograd.grad(loss, (q, k, v))
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert _kernels.launch_counts[name] == before.get(name, 0) + 1
    qp, kp, vp = (x.clone().requires_grad_() for _ in range(3))
    ref = tattn.attention(qp, kp, vp, True, impl="plain")
    want = torch.autograd.grad(ref.transpose(1, 2).reshape(8, 16, 64).square().sum(), (qp, kp, vp))
    for g, w in zip(grads, want):
        assert (g - w).abs().max().item() <= 1e-4 * max(1.0, w.abs().max().item())


def _with_attention(attention_fn, *modules):
    """Point every (stacked) MultiHeadAttention of ``modules`` at
    ``attention_fn``."""
    from torch_actor_critic_tpu_torch.models.sequence import (
        MultiHeadAttention,
        StackedMultiHeadAttention,
    )

    for module in modules:
        for m in module.modules():
            if isinstance(m, (MultiHeadAttention, StackedMultiHeadAttention)):
                m.attention_fn = attention_fn
    return modules


@pytest.mark.gpu
@pytest.mark.parametrize("num_qs", [2, 3])
def test_stacked_sequence_critic_kernels_match_plain_attention(cuda, num_qs):
    """The full-width stacked critic runs one K2 a layer for all its
    members, and one K3 and one K4 a layer in the backward; its Q and
    its gradients (parameters, shared history, shared action) match the
    same critic through plain attention to 1e-4·max(1, max|plain|)."""
    from torch_actor_critic_tpu_torch.models import build_models

    cfg = SACConfig(history_len=16, num_qs=num_qs)
    layers = cfg.seq_num_layers

    def critic(attention_fn=None):
        _, c = build_models(cfg, (16, 3), 1, 2.0, generator=torch.Generator().manual_seed(0))
        if attention_fn is not None:
            _with_attention(attention_fn, c)
        return c.to(cuda)

    rng = np.random.default_rng(num_qs)
    obs = torch.from_numpy(rng.standard_normal((64, 16, 3)).astype(np.float32)).to(cuda)
    act = torch.from_numpy(rng.uniform(-2, 2, (64, 1)).astype(np.float32)).to(cuda)
    coef = torch.from_numpy(rng.standard_normal((num_qs, 64)).astype(np.float32)).to(cuda)
    with_kernels, with_plain = critic(), critic(plain_attention)
    before = dict(_kernels.launch_counts)
    with torch.no_grad():
        with_kernels(obs, act)
    assert _kernels.launch_counts["flash_fwd"] == before.get("flash_fwd", 0) + layers

    def grads(c):
        o, a = obs.clone().requires_grad_(), act.clone().requires_grad_()
        q = c(o, a)
        loss = (q * coef).sum() + q.amin(0).sum()
        return q.detach(), torch.autograd.grad(loss, [*c.parameters(), o, a])

    before = dict(_kernels.launch_counts)
    qk, gk = grads(with_kernels)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert _kernels.launch_counts[name] == before.get(name, 0) + layers, name
    before = dict(_kernels.launch_counts)
    qp, gp = grads(with_plain)
    assert dict(_kernels.launch_counts) == before
    assert qk.shape == (num_qs, 64)
    assert (qk - qp).abs().max().item() <= 1e-4 * max(1.0, qp.abs().max().item())
    names = [n for n, _ in with_kernels.named_parameters()] + ["obs", "action"]
    for name, g, w in zip(names, gk, gp):
        assert (g - w).abs().max().item() <= 1e-4 * max(1.0, w.abs().max().item()), name


@pytest.mark.gpu
def test_full_width_update_with_kernels_matches_plain_attention(cuda):
    from torch_actor_critic_tpu_torch.core.types import Batch
    from torch_actor_critic_tpu_torch.models import build_models
    from torch_actor_critic_tpu_torch.sac.algorithm import SAC

    cfg = SACConfig(history_len=16)
    sac = SAC(cfg, 1)

    def state(attention_fn):
        actor, critic = build_models(cfg, (16, 3), 1, 2.0,
                                     generator=torch.Generator().manual_seed(0))
        if attention_fn is not None:
            _with_attention(attention_fn, actor, critic)
        return sac.init_state(actor.to(cuda), critic.to(cuda),
                              torch.Generator(device=cuda).manual_seed(1))

    rng = np.random.default_rng(0)
    b = Batch(
        states=torch.from_numpy(rng.standard_normal((64, 16, 3)).astype(np.float32)),
        actions=torch.from_numpy(rng.uniform(-2, 2, (64, 1)).astype(np.float32)),
        rewards=torch.from_numpy(rng.standard_normal(64).astype(np.float32)),
        next_states=torch.from_numpy(rng.standard_normal((64, 16, 3)).astype(np.float32)),
        done=torch.zeros(64),
    ).map(lambda t: t.to(cuda))
    eps = [torch.from_numpy(rng.standard_normal((64, 1)).astype(np.float32)).to(cuda)
           for _ in range(2)]
    with_kernels, with_plain = state(None), state(plain_attention)
    before = dict(_kernels.launch_counts)
    sac.update(with_kernels, b, eps_q=eps[0], eps_pi=eps[1])
    # One call a layer serves both critics: forward 5L, each backward 2L.
    layers = cfg.seq_num_layers
    assert _kernels.launch_counts["flash_bwd_dq"] == before.get("flash_bwd_dq", 0) + 2 * layers
    assert _kernels.launch_counts["flash_fwd"] == before.get("flash_fwd", 0) + 5 * layers
    sac.update(with_plain, b, eps_q=eps[0], eps_pi=eps[1])
    for part in ("actor", "critic", "target_critic"):
        theirs = dict(getattr(with_plain, part).named_parameters())
        for name, p in getattr(with_kernels, part).named_parameters():
            gap = (p - theirs[name]).abs().max().item()
            assert gap <= (2 * cfg.lr if name.endswith("attn.k.bias") else 1e-4), (part, name, gap)
    with torch.no_grad():
        qk = with_kernels.critic(b.states, b.actions)
        qp = with_plain.critic(b.states, b.actions)
    assert (qk - qp).abs().max().item() <= 1e-4


# ------------------------------------------------------------------ K1


PIXEL_CASES = [
    # ring shape, batch, output dtype
    ((24000, 32, 32, 3), 64, torch.float32),    # the pixel recipe's training shape
    ((24000, 32, 32, 3), 64, torch.bfloat16),
    ((20000, 64, 64, 3), 32, torch.float32),    # the wall-runner geometry
    ((20000, 64, 64, 3), 512, torch.bfloat16),
    ((64, 12, 20, 3), 5, torch.bfloat16),       # ragged H != W; rows of 60 bytes
    ((50, 7, 9, 1), 6, torch.float32),          # C = 1, odd W: 1-byte loads
    ((50, 7, 9, 1), 6, torch.bfloat16),
    ((40, 10, 6, 4), 5, torch.bfloat16),        # C = 4: the generic build
    ((30, 9, 11, 2), 7, torch.float32),         # W*C = 22: no 16- or 4-byte loads
]


def _pixel_inputs(cuda, ring_shape, batch, seed=4):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    ring = torch.randint(0, 256, ring_shape, generator=gen, device=cuda, dtype=torch.uint8)
    n = min(256, ring[1].numel())
    ring[1].view(-1)[:n] = torch.arange(n, device=cuda, dtype=torch.uint8)  # every value
    idx = torch.randint(0, ring_shape[0], (batch,), generator=gen, device=cuda)
    idx[:2] = torch.tensor([0, 1], device=cuda)  # wrap-around when S = 3
    return gen, ring, idx


def _pixel_pads(ring_shape):
    """No shift, then shifts at pad 4, pad 0 and a pad wider than W/2."""
    return (None, 4, 0, ring_shape[2] // 2 + 3)


@pytest.mark.gpu
@pytest.mark.parametrize("ring_shape,batch,dtype", PIXEL_CASES)
def test_pixel_gather_kernel_is_bitwise_its_plain_version(cuda, ring_shape, batch, dtype):
    from torch_actor_critic_tpu_torch.ops.augment import shift_offsets
    from torch_actor_critic_tpu_torch.ops.pixels import (
        fused_frame_gather,
        gather_frames_reference,
    )

    gen, ring, idx = _pixel_inputs(cuda, ring_shape, batch)
    for normalize in (False, True):
        for stack in (1, 3):
            for pad in _pixel_pads(ring_shape):
                offsets = None if pad is None else shift_offsets(batch, pad, gen, cuda)
                pad = 4 if pad is None else pad
                before = _kernels.launch_counts["pixel_gather"]
                got = fused_frame_gather(ring, idx, offsets, pad, normalize, dtype, stack)
                assert _kernels.launch_counts["pixel_gather"] == before + 1
                want = gather_frames_reference(ring, idx, offsets, pad, normalize, dtype, stack)
                torch.cuda.synchronize()
                assert got.dtype == dtype and got.shape == want.shape
                assert torch.equal(got, want), (normalize, stack, pad, offsets is None)


@pytest.mark.gpu
@pytest.mark.parametrize("ring_shape,batch,dtype", [PIXEL_CASES[0], PIXEL_CASES[3],
                                                    PIXEL_CASES[4], PIXEL_CASES[7]])
def test_pixel_gather_pair_is_one_launch_and_bitwise_per_leaf(cuda, ring_shape, batch, dtype):
    """Both frame leaves in one launch, each its plain version bitwise,
    the second leaf with its own ring and offsets (or none)."""
    from torch_actor_critic_tpu_torch.ops.augment import shift_offsets
    from torch_actor_critic_tpu_torch.ops.pixels import (
        fused_frame_gather_pair,
        gather_frames_reference,
    )

    gen, ring, idx = _pixel_inputs(cuda, ring_shape, batch)
    rings = (ring, torch.randint(0, 256, ring_shape, generator=gen, device=cuda,
                                 dtype=torch.uint8))
    for stack in (1, 3):
        for offsets in ((shift_offsets(batch, 4, gen, cuda), shift_offsets(batch, 4, gen, cuda)),
                        (shift_offsets(batch, 4, gen, cuda), None), None):
            before = _kernels.launch_counts["pixel_gather"]
            got = fused_frame_gather_pair(rings, idx, offsets, 4, True, dtype, stack)
            assert _kernels.launch_counts["pixel_gather"] == before + 1
            for g, r, o in zip(got, rings, offsets or (None, None)):
                want = gather_frames_reference(r, idx, o, 4, True, dtype, stack)
                torch.cuda.synchronize()
                assert g.dtype == dtype and g.shape == want.shape
                assert torch.equal(g, want), (stack, o is None)


@pytest.mark.gpu
def test_visual_update_with_the_kernel_matches_the_plain_gather(cuda):
    """The pixel recipe's fused update on the card, its frames from K1
    and from the plain gather (bitwise equal), from one state."""
    from torch_actor_critic_tpu_torch.buffer.replay import (
        init_visual_replay_buffer,
        push,
        sample_fused_visual,
    )
    from torch_actor_critic_tpu_torch.core.types import Batch, MultiObservation
    from torch_actor_critic_tpu_torch.models import build_models
    from torch_actor_critic_tpu_torch.ops.augment import shift_offsets
    from torch_actor_critic_tpu_torch.ops.pixels import gather_frames_reference
    from torch_actor_critic_tpu_torch.sac.algorithm import SAC

    cfg = SACConfig(filters=(16, 32), kernel_sizes=(4, 3), strides=(2, 2), cnn_dense_size=128,
                    cnn_features=64, normalize_pixels=True, frame_augment="shift",
                    learn_alpha=True, pixel_pipeline="fused")
    shape = MultiObservation((1,), (32, 32, 3))
    sac = SAC(cfg, 1)

    def state():
        actor, critic = build_models(cfg, shape, 1, 2.0, generator=torch.Generator().manual_seed(0))
        return sac.init_state(actor.to(cuda), critic.to(cuda),
                              torch.Generator(device=cuda).manual_seed(1))

    gen = torch.Generator(device=cuda).manual_seed(2)
    n = 2000

    def obs():
        return MultiObservation(
            torch.randn((n, 1), generator=gen, device=cuda),
            torch.randint(0, 256, (n, 32, 32, 3), generator=gen, device=cuda, dtype=torch.uint8))

    buf = push(init_visual_replay_buffer(n, 1, (32, 32, 3), 1, cuda), Batch(
        states=obs(), actions=torch.rand((n, 1), generator=gen, device=cuda) * 4 - 2,
        rewards=torch.randn(n, generator=gen, device=cuda), next_states=obs(),
        done=torch.zeros(n, device=cuda)))
    idx = torch.randint(0, n, (64,), generator=gen, device=cuda)
    offsets = torch.stack([shift_offsets(64, 4, gen, cuda) for _ in range(2)])
    before = _kernels.launch_counts["pixel_gather"]
    with_kernel = sample_fused_visual(buf, 64, torch.float32, "shift", 4, True,
                                      indices=idx, offsets=offsets)
    assert _kernels.launch_counts["pixel_gather"] == before + 1  # both leaves, one launch
    frames = [gather_frames_reference(ring, idx, offs, 4, True, torch.float32)
              for ring, offs in ((buf.data.states.frame, offsets[0]),
                                 (buf.data.next_states.frame, offsets[1]))]
    with_plain = Batch(
        states=MultiObservation(with_kernel.states.features, frames[0]),
        actions=with_kernel.actions, rewards=with_kernel.rewards,
        next_states=MultiObservation(with_kernel.next_states.features, frames[1]),
        done=with_kernel.done)
    assert torch.equal(with_kernel.states.frame, frames[0])
    assert torch.equal(with_kernel.next_states.frame, frames[1])
    eps = [torch.randn((64, 1), generator=gen, device=cuda) for _ in range(2)]
    a, b = state(), state()
    sac.update(a, with_kernel, eps_q=eps[0], eps_pi=eps[1])
    sac.update(b, with_plain, eps_q=eps[0], eps_pi=eps[1])
    for part in ("actor", "critic", "target_critic"):
        theirs = dict(getattr(b, part).named_parameters())
        for name, p in getattr(a, part).named_parameters():
            gap = (p - theirs[name]).abs().max().item()
            assert gap <= 1e-4, (part, name, gap)
    assert abs(a.log_alpha.item() - b.log_alpha.item()) <= 1e-6


# ------------------------------------------------------- the captured burst

# name: (SACConfig overrides, observation shape); act_dim 1
BURST_CASES = {
    "flat": ({}, (3,)),
    "sequence": (dict(history_len=16), (16, 3)),
    "visual-fused": (dict(filters=(16, 32), kernel_sizes=(4, 3), strides=(2, 2),
                          cnn_dense_size=128, cnn_features=64, normalize_pixels=True,
                          frame_augment="shift", learn_alpha=True, pixel_pipeline="fused"),
                     ((1,), (32, 32, 3))),
}


def _burst_chunk(cuda, shape, n, gen, reward=None, done=None):
    from torch_actor_critic_tpu_torch.core.types import Batch, MultiObservation

    def obs():
        if isinstance(shape, MultiObservation):
            return MultiObservation(
                torch.randn((n, *shape.features), generator=gen, device=cuda),
                torch.randint(0, 256, (n, *shape.frame), generator=gen, device=cuda,
                              dtype=torch.uint8))
        return torch.randn((n, *shape), generator=gen, device=cuda)

    return Batch(
        states=obs(), actions=torch.rand((n, 1), generator=gen, device=cuda) * 4 - 2,
        rewards=(torch.randn(n, generator=gen, device=cuda) if reward is None
                 else torch.full((n,), reward, device=cuda)),
        next_states=obs(),
        done=torch.full((n,), 0.0 if done is None else done, device=cuda))


def _burst_learner(cuda, name, capacity=4096, prefill=2000, **cfg_kw):
    """A learner of case ``name`` at the repo's widths on the card and a
    ring holding ``prefill`` random transitions; returns (config, shape,
    state, ring, generator for chunks)."""
    from torch_actor_critic_tpu_torch.buffer.replay import (
        init_replay_buffer,
        init_visual_replay_buffer,
        push,
    )
    from torch_actor_critic_tpu_torch.core.types import MultiObservation
    from torch_actor_critic_tpu_torch.models import build_models
    from torch_actor_critic_tpu_torch.sac.trainer import make_learner

    overrides, shape = BURST_CASES[name]
    cfg = SACConfig(**{**overrides, **cfg_kw})
    if isinstance(shape[0], tuple):
        shape = MultiObservation(*shape)
        ring = init_visual_replay_buffer(capacity, shape.features[0], shape.frame, 1, cuda)
    else:
        ring = init_replay_buffer(capacity, shape, 1, cuda)
    actor, critic = build_models(cfg, shape, 1, 2.0, generator=torch.Generator().manual_seed(0))
    state = make_learner(cfg, 1).init_state(actor.to(cuda), critic.to(cuda),
                                            torch.Generator(device=cuda).manual_seed(1))
    gen = torch.Generator(device=cuda).manual_seed(2)
    if prefill:
        ring = push(ring, _burst_chunk(cuda, shape, prefill, gen))
    return cfg, shape, state, ring, gen


def _learner_gaps(a, b) -> dict:
    """Max abs gap of two learner states: parameters (actor, critic,
    targets), Adam states (moments and step), log α; and whether the
    generators and step counts (host and device) agree."""
    def gap(x, y):
        return (torch.as_tensor(x).double() - torch.as_tensor(y).double()).abs().max().item()

    params = max(gap(p, q) for ma, mb in zip(a.modules(), b.modules(), strict=True)
                 for p, q in zip(ma.parameters(), mb.parameters(), strict=True))
    adam = max(
        gap(sa[k], sb[k])
        for opt in ("pi_opt", "q_opt", "alpha_opt")
        for pa, pb in zip(*([p for g in getattr(s, opt).param_groups for p in g["params"]]
                            for s in (a, b)), strict=True)
        for sa, sb in [(getattr(a, opt).state[pa], getattr(b, opt).state[pb])]
        for k in sa
    )
    return {"params": params, "adam": adam, "log_alpha": gap(a.log_alpha, b.log_alpha),
            "same_generator": torch.equal(a.generator.get_state(), b.generator.get_state()),
            "same_step": a.step == b.step and torch.equal(a.device_step, b.device_step)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(BURST_CASES))
def test_captured_burst_equals_the_eager_burst_bitwise(cuda, name):
    """From one cloned state and ring, two bursts of 5 updates as CUDA
    graph replays (the first: 1 warm-up update, the capture, 4 replays;
    the second: 5 replays) and through the eager loop: the same
    parameters, Adam states, log α, step, generator and metrics, to the
    bit. cuDNN's default convolution backward may sum in another order
    run to run, so the visual case runs both with cuDNN's deterministic
    algorithms."""
    from torch_actor_critic_tpu_torch.sac.algorithm import SAC

    cfg, shape, state, ring, gen = _burst_learner(cuda, name)
    chunks = [_burst_chunk(cuda, shape, 50, gen) for _ in range(2)]
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for captured in (False, True):
            sac, st, buf = SAC(cfg, 1), state.clone(), ring.clone()
            metrics = []
            for chunk in chunks:
                st, buf, m = sac.update_burst(st, buf, chunk, 5, eager=not captured)
                metrics.append(m)
            runs[captured] = (st, metrics, sac.graph_captures)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (eager, m_eager, _), (graph, m_graph, captures) = runs[False], runs[True]
    torch.cuda.synchronize()
    assert captures == 1 and graph.step == eager.step == 10
    gaps = _learner_gaps(graph, eager)
    assert gaps == {"params": 0.0, "adam": 0.0, "log_alpha": 0.0, "same_generator": True,
                    "same_step": True}, gaps
    for mg, me in zip(m_graph, m_eager):
        assert mg.keys() == me.keys()
        assert all(torch.equal(mg[k], me[k]) for k in me), {k: (mg[k], me[k]) for k in me}


# the kernels' device symbols, as a trace names them
KERNEL_SYMBOLS = {"flash_fwd": "flash_fwd_kernel", "flash_bwd_dq": "flash_bwd_dq_kernel",
                  "flash_bwd_dkv": "flash_bwd_dkv_kernel", "pixel_gather": "pixel_gather_kernel"}


@pytest.mark.gpu
def test_a_capture_collects_dead_graphs_first_and_not_during(cuda):
    """A CUDA graph dead in a reference cycle is freed by the cyclic
    collector, and freeing one while a stream captures fails the
    capture. A burst's capture collects before it begins (the dead graph
    is gone when the captured step runs, even with the collector off)
    and keeps the collector off while it runs, then as it was."""
    import gc
    import weakref

    from torch_actor_critic_tpu_torch.sac.graph import BurstGraph

    class Cycle:
        pass

    x = torch.zeros(4, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    seen = []

    def step(stack):
        seen.append((gc.isenabled(), dead() is None))
        x.add_(torch.rand(4, generator=gen, device=cuda))
        stack.write({"x": x.sum()})

    for enabled in (False, True):
        seen.clear()
        cycle = Cycle()
        cycle.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(cycle.graph):
            x.mul_(1)
        cycle.self = cycle
        dead = weakref.ref(cycle)
        del cycle
        (gc.enable if enabled else gc.disable)()
        try:
            burst = BurstGraph(step, key=(), num_updates=3, generators=gen)
            burst.run()
            torch.cuda.synchronize()
            after = gc.isenabled()
        finally:
            gc.enable()
        assert after == enabled and burst.ran == 3
        # the warm-up step, then the captured one (replays call no step)
        assert len(seen) == 2 and seen[1] == (False, True), seen
        if not enabled:
            assert seen[0] == (False, False)


@pytest.mark.gpu
@pytest.mark.parametrize("name,per_update", [
    ("sequence", {"flash_fwd": 10, "flash_bwd_dq": 4, "flash_bwd_dkv": 4}),
    ("visual-fused", {"pixel_gather": 1}),
])
def test_captured_burst_replays_launch_the_kernels_of_every_update(cuda, name, per_update):
    """The wrappers count the first burst's warm-up launches and its
    capture's (each recorded into the graph), and nothing of a replay;
    the device trace of a burst of 6 replays holds 6 updates' launches
    of each kernel."""
    from torch_actor_critic_tpu_torch.sac.algorithm import SAC

    cfg, shape, state, ring, gen = _burst_learner(cuda, name)
    sac = SAC(cfg, 1)
    before = dict(_kernels.launch_counts)
    state, ring, _ = sac.update_burst(state, ring, _burst_chunk(cuda, shape, 50, gen), 6)
    torch.cuda.synchronize()
    got = {k: _kernels.launch_counts[k] - before.get(k, 0) for k in per_update}
    assert got == {k: 2 * n for k, n in per_update.items()}, got
    before = dict(_kernels.launch_counts)
    chunk = _burst_chunk(cuda, shape, 50, gen)

    def burst():
        nonlocal state, ring
        state, ring, _ = sac.update_burst(state, ring, chunk, 6)

    rows = _device_kernels(burst, calls=1)
    seen = {k: sum(n for key, n in rows if KERNEL_SYMBOLS[k] in key) for k in per_update}
    assert seen == {k: 6 * n for k, n in per_update.items()}, rows
    assert dict(_kernels.launch_counts) == before
    assert sac.graph_captures == 1


@pytest.mark.gpu
def test_burst_graph_is_captured_once_per_state_ring_and_length(cuda):
    from torch_actor_critic_tpu_torch.buffer.replay import push
    from torch_actor_critic_tpu_torch.sac.algorithm import SAC

    cfg, shape, state, ring, gen = _burst_learner(cuda, "flat")
    sac = SAC(cfg, 1)

    def burst(st, buf, k):
        return sac.update_burst(st, buf, _burst_chunk(cuda, shape, 10, gen), k)

    for _ in range(3):  # across bursts, and across pushes outside a burst
        state, ring, _ = burst(state, ring, 4)
        ring = push(ring, _burst_chunk(cuda, shape, 7, gen))
    assert sac.graph_captures == 1
    state, ring, _ = burst(state, ring, 6)  # another length
    state, ring, _ = burst(state, ring, 6)
    assert sac.graph_captures == 2
    twin, twin_ring = state.clone(), ring.clone()  # another state and ring
    burst(twin, twin_ring, 6)
    assert sac.graph_captures == 3
    state, ring, _ = burst(state, ring, 6)  # one graph is kept: the last
    assert sac.graph_captures == 4 and state.step == 4 * 3 + 6 * 3


@pytest.mark.gpu
def test_a_failed_capture_raises_and_runs_no_eager_update(cuda):
    """An error inside the capture propagates; the burst runs no update
    beyond its warm-up, keeps no graph and counts no capture."""
    from torch_actor_critic_tpu_torch.sac.algorithm import SAC

    cfg, shape, state, ring, gen = _burst_learner(cuda, "flat")
    twin, twin_ring = state.clone(), ring.clone()
    chunk = _burst_chunk(cuda, shape, 10, gen)
    sac = SAC(cfg, 1)
    update = sac.update

    def refusing_update(st, batch, **kw):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("refused under capture")
        return update(st, batch, **kw)

    sac.update = refusing_update
    with pytest.raises(RuntimeError, match="refused under capture"):
        sac.update_burst(state, ring, chunk, 8)
    assert sac.graph is None and sac.graph_captures == 0
    SAC(cfg, 1).update_burst(twin, twin_ring, chunk, 1, eager=True)  # the warm-up alone
    torch.cuda.synchronize()
    gaps = _learner_gaps(state, twin)
    assert (gaps["params"], gaps["adam"], state.step) == (0.0, 0.0, 1), gaps


@pytest.mark.gpu
def test_a_replay_after_a_push_samples_the_grown_ring(cuda):
    """Every transition is terminal, so a batch's mean backup is its mean
    reward: 0 on the first 128 rows, 1 on the 1920 pushed after the
    capture. Replays that read a frozen size would see none of them."""
    from torch_actor_critic_tpu_torch.buffer.replay import push
    from torch_actor_critic_tpu_torch.sac.algorithm import SAC

    cfg, shape, state, ring, gen = _burst_learner(cuda, "flat", prefill=0)
    ring = push(ring, _burst_chunk(cuda, shape, 64, gen, reward=0.0, done=1.0))
    sac = SAC(cfg, 1)
    state, ring, first = sac.update_burst(
        state, ring, _burst_chunk(cuda, shape, 64, gen, reward=0.0, done=1.0), 8)
    assert ring.size == 128 and float(first["backup_mean"]) == 0.0
    state, ring, grown = sac.update_burst(
        state, ring, _burst_chunk(cuda, shape, 1920, gen, reward=1.0, done=1.0), 8)
    assert sac.graph_captures == 1 and ring.size == 2048
    share = float(grown["backup_mean"])  # 1920/2048 = 0.9375 expected, sd ~0.011
    assert 0.85 < share <= 1.0, share


@pytest.mark.gpu
def test_capturable_adam_step_matches_the_plain_adam(cuda):
    """One Adam step from a trained learner's Adam states, on the same
    gradients: the capturable Adam the card's learner steps (its step
    count and bias correction on the device) against the plain Adam the
    CPU steps, which the tier-1 tests hold to optax, at their limits
    (atol 1e-5, rtol 1e-4) on the parameters and both moments."""
    import copy

    from torch_actor_critic_tpu_torch.sac.algorithm import ADAM_EPS, SAC

    cfg, shape, state, ring, gen = _burst_learner(cuda, "sequence")
    state, ring, _ = SAC(cfg, 1).update_burst(state, ring, _burst_chunk(cuda, shape, 50, gen), 20)
    for module, opt in ((state.critic, state.q_opt), (state.actor, state.pi_opt)):
        grads = [torch.randn(p.shape, generator=gen, device=cuda) for p in module.parameters()]
        runs = []
        for capturable in (True, False):
            params = [p.detach().clone().requires_grad_(True) for p in module.parameters()]
            adam = torch.optim.Adam(params, lr=cfg.lr, eps=ADAM_EPS, capturable=capturable)
            saved = copy.deepcopy(opt.state_dict())
            for group in saved["param_groups"]:
                group["capturable"] = capturable
            for st in saved["state"].values():
                st["step"] = st["step"].to(cuda if capturable else "cpu")
            adam.load_state_dict(saved)
            for p, g in zip(params, grads):
                p.grad = g.clone()
            adam.step()
            runs.append([(p, adam.state[p]["exp_avg"], adam.state[p]["exp_avg_sq"])
                         for p in params])
        for got, want in zip(*runs):
            for a, b in zip(got, want):
                torch.testing.assert_close(a.detach(), b.detach(), atol=1e-5, rtol=1e-4)


# ------------------------------------------- full-state checkpoint, resume

# tests/test_resilience.py's TINY schedule with the sequence policy at a
# small width: on the card its attention runs through K2-K4 and its bursts
# are CUDA graph replays.
RESUME_CFG = dict(hidden_sizes=(16, 16), batch_size=16, epochs=3, steps_per_epoch=40,
                  start_steps=10, update_after=10, update_every=10, buffer_size=500,
                  max_ep_len=100, save_every=10, history_len=4, seq_d_model=16,
                  seq_num_heads=2, seq_num_layers=1)


def _resume_trainer(device, ckpt_dir, preemption=None, **over):
    from torch_actor_critic_tpu_torch.sac.trainer import Trainer
    from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer

    return Trainer("PendulumNumpy-v1", SACConfig(**{**RESUME_CFG, **over}),
                   checkpointer=Checkpointer(ckpt_dir, retry_backoff_s=0.0), seed=7,
                   device=device, preemption=preemption)


def _snapshot(tr) -> dict:
    return {"state": tr.state.state_dict(), "buffer": tr.buffer.state_dict(),
            "device_size": int(tr.buffer.device_size), "act": tr._act_gen.get_state()}


def _diff(a, b, path="") -> list:
    if isinstance(a, torch.Tensor):
        return [] if a.dtype == b.dtype and torch.equal(a, b) else [path]
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return [path]
        return [d for k in a for d in _diff(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        return [d for i, (x, y) in enumerate(zip(a, b, strict=True))
                for d in _diff(x, y, f"{path}/{i}")]
    return [] if a == b else [path]


@pytest.mark.gpu
def test_resume_under_captured_bursts_is_bitwise(cuda, tmp_path):
    """3 epochs uninterrupted against a run preempted in epoch 1 (the
    programmatic path of the guard) and a fresh trainer resumed from its
    checkpoint for the last epoch: every leaf equal to the bit, one
    capture in each run."""
    from torch_actor_critic_tpu_torch.resilience import Preempted, PreemptionGuard
    from torch_actor_critic_tpu_torch.resilience.faultinject import FaultyEnvPool

    a = _resume_trainer(cuda, tmp_path / "a")
    a.train()
    ref, captures = _snapshot(a), a.sac.graph_captures
    a.close()
    guard = PreemptionGuard()
    b = _resume_trainer(cuda, tmp_path / "b", preemption=guard)
    b.pool = FaultyEnvPool(b.pool).call_at(45, guard.request_preemption)
    with pytest.raises(Preempted):
        b.train()
    b.close()
    c = _resume_trainer(cuda, tmp_path / "b", epochs=1)
    assert c.restore() == 2 and c._resume_step == 80
    c.train()
    torch.cuda.synchronize()
    assert _diff(ref, _snapshot(c)) == []
    assert captures == c.sac.graph_captures == 1
    c.close()


@pytest.mark.gpu
def test_rollback_in_place_keeps_the_graph_and_equals_an_eager_burst(cuda, tmp_path):
    """A NaN reward in epoch 1 rolls back to epoch 0 in place: the
    rolled-back state is the checkpoint's to the bit, no burst is
    captured anew, and one burst through the graph captured before the
    rollback equals one eager burst from a clone of the rolled-back
    state, to the bit."""
    from torch_actor_critic_tpu_torch.buffer.replay import sample
    from torch_actor_critic_tpu_torch.resilience.faultinject import FaultyEnvPool
    from torch_actor_critic_tpu_torch.sac.algorithm import SAC

    tr = _resume_trainer(cuda, tmp_path / "ck", save_every=1, epochs=3)
    tr.pool = FaultyEnvPool(tr.pool).nan_rewards_at(50)
    rollback, seen = tr._rollback, {}

    def checked_rollback():
        epoch = rollback()
        on_disk = tr.checkpointer.directory / f"epoch_{epoch}"
        saved = torch.load(on_disk / "state.pt", weights_only=True)
        seen["diff"] = _diff(saved, tr.state.state_dict())
        graph, cfg = tr.sac.graph, tr.config
        chunk = sample(tr.buffer, 10, generator=torch.Generator(device=cuda).manual_seed(3))
        twin, twin_ring = tr.state.clone(), tr.buffer.clone()
        tr.state, tr.buffer, m_graph = tr.sac.update_burst(tr.state, tr.buffer, chunk, 10)
        twin, twin_ring, m_eager = SAC(cfg, 1).update_burst(twin, twin_ring, chunk, 10,
                                                            eager=True)
        torch.cuda.synchronize()
        seen["same_graph"] = tr.sac.graph is graph
        seen["gaps"] = _learner_gaps(tr.state, twin)
        seen["metrics"] = all(torch.equal(m_graph[k], m_eager[k]) for k in m_eager)
        rollback()
        return epoch

    tr._rollback = checked_rollback
    metrics = tr.train()
    tr.close()
    assert tr.sentinel.total_rollbacks == 1 and seen["diff"] == []
    assert seen["same_graph"] and tr.sac.graph_captures == 1
    assert seen["gaps"] == {"params": 0.0, "adam": 0.0, "log_alpha": 0.0,
                            "same_generator": True, "same_step": True}, seen["gaps"]
    assert seen["metrics"] and math.isfinite(metrics["loss_q"])


@pytest.mark.gpu
def test_card_checkpoint_restores_on_the_cpu(cuda, tmp_path):
    """A checkpoint written on the card restores into a CPU trainer: the
    networks, Adam moments and step values, log α, the step count and
    the ring exactly; each Adam's step lands where a CPU Adam keeps it."""
    card = _resume_trainer(cuda, tmp_path / "ck", epochs=1)
    card.train()
    host = _resume_trainer("cpu", tmp_path / "ck")
    assert host.restore() == 1

    def exact(st):
        full = st.state_dict()
        return {**{k: full[k] for k in ("step", "actor", "critic", "target_critic", "log_alpha")},
                **{k: full[k]["state"] for k in ("pi_opt", "q_opt", "alpha_opt")}}

    assert _diff(exact(card.state), exact(host.state)) == []
    assert _diff(card.buffer.state_dict(), host.buffer.state_dict()) == []
    step = next(iter(host.state.q_opt.state.values()))["step"]
    # windows at steps 19, 29 and 39 (after update_after 10): 3 bursts of 10
    assert step.device.type == "cpu" and float(step) == host.state.step == 30
    card.close()
    host.close()


# ------------------------------------------------------------------ TD3

TD3_CASES = {"flat": dict(algorithm="td3"),
             "visual-fused": dict(algorithm="td3", learn_alpha=False)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(TD3_CASES))
def test_captured_td3_burst_equals_the_eager_burst_bitwise(cuda, name):
    """TD3 (policy delay 2) from one cloned state and ring: two bursts of
    25 updates, so the second starts on an odd step, as CUDA graph
    replays and through the eager loop, on cuDNN's deterministic
    algorithms: every parameter (both targets), Adam state, the steps
    (the device one needs no correction after the capture, which runs
    nothing), the generator and the metrics to the bit."""
    from torch_actor_critic_tpu_torch.td3 import TD3

    cfg, shape, state, ring, gen = _burst_learner(cuda, name, **TD3_CASES[name])
    chunks = [_burst_chunk(cuda, shape, 50, gen) for _ in range(2)]
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for captured in (False, True):
            td3, st, buf = TD3(cfg, 1), state.clone(), ring.clone()
            metrics = []
            for chunk in chunks:
                st, buf, m = td3.update_burst(st, buf, chunk, 25, eager=not captured)
                metrics.append(m)
            runs[captured] = (st, metrics, td3.graph_captures)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (eager, m_eager, _), (graph, m_graph, captures) = runs[False], runs[True]
    torch.cuda.synchronize()
    assert captures == 1 and graph.step == int(graph.device_step) == 50
    assert {float(s["step"]) for s in graph.pi_opt.state.values()} == {25.0}
    gaps = _learner_gaps(graph, eager)
    assert gaps == {"params": 0.0, "adam": 0.0, "log_alpha": 0.0, "same_generator": True,
                    "same_step": True}, gaps
    for mg, me in zip(m_graph, m_eager):
        assert mg.keys() == me.keys() == {"loss_q", "loss_pi", "q_mean", "backup_mean",
                                          "q_pi_mean"}
        assert all(torch.equal(mg[k], me[k]) for k in me), {k: (mg[k], me[k]) for k in me}


def _td3_policy(st) -> dict:
    """The tensors a skipped TD3 update must leave bitwise: the actor,
    the capturable ``pi_opt``'s state (its ``step`` a device tensor) and
    both targets."""
    out = {f"actor.{n}": p for n, p in st.actor.named_parameters()}
    out.update({f"target_actor.{n}": p for n, p in st.target_actor.named_parameters()})
    out.update({f"target_critic.{n}": p for n, p in st.target_critic.named_parameters()})
    for i, p in enumerate(st.actor.parameters()):
        out.update({f"pi_opt.{i}.{k}": v for k, v in st.pi_opt.state[p].items()})
    return {k: v.detach().clone() for k, v in out.items()}


@pytest.mark.gpu
def test_a_skipped_td3_replay_leaves_the_policy_bitwise(cuda):
    """One-update bursts through one graph (delay 2): the first burst's
    warm-up runs step 0 and captures; the replay of step 1 applies the
    policy, the replay of step 2 skips it: the actor, ``pi_opt``'s step
    tensors and moments and both targets bitwise unchanged, the critic
    moved."""
    from torch_actor_critic_tpu_torch.td3 import TD3

    cfg, shape, state, ring, gen = _burst_learner(cuda, "flat", algorithm="td3")
    td3 = TD3(cfg, 1)
    state, ring, _ = td3.update_burst(state, ring, _burst_chunk(cuda, shape, 10, gen), 1)
    moved = {}
    for step in (1, 2):
        before = _td3_policy(state)
        critic = [p.detach().clone() for p in state.critic.parameters()]
        state, ring, _ = td3.update_burst(state, ring, _burst_chunk(cuda, shape, 10, gen), 1)
        torch.cuda.synchronize()
        after = _td3_policy(state)
        moved[step] = {k for k in before if not torch.equal(before[k], after[k])}
        assert all(not torch.equal(c, p) for c, p in zip(critic, state.critic.parameters()))
        assert state.step == int(state.device_step) == step + 1
    assert td3.graph_captures == 1
    assert moved[1] == set(before) and moved[2] == set()
    assert {float(s["step"]) for s in state.pi_opt.state.values()} == {1.0}
    assert all(s["step"].device.type == "cuda" for s in state.pi_opt.state.values())


@pytest.mark.gpu
def test_td3_state_restored_in_place_keeps_the_graph(cuda):
    """A TD3 learner snapshot (target actor and device step included)
    restored in place under the captured graph: no new capture, and the
    next burst from it equals, to the bit, the burst first run from the
    same snapshot."""
    from torch_actor_critic_tpu_torch.buffer.replay import load_buffer_
    from torch_actor_critic_tpu_torch.td3 import TD3

    cfg, shape, state, ring, gen = _burst_learner(cuda, "flat", algorithm="td3")
    td3 = TD3(cfg, 1)
    chunk = _burst_chunk(cuda, shape, 50, gen)
    state, ring, _ = td3.update_burst(state, ring, chunk, 25)
    saved, saved_ring = state.state_dict(), ring.state_dict()
    runs = []
    for _ in range(2):
        state.load_state_dict_(saved)
        ring = load_buffer_(ring, saved_ring)
        assert int(state.device_step) == 25
        state, ring, m = td3.update_burst(state, ring, chunk, 25)
        torch.cuda.synchronize()
        runs.append((state.state_dict(), {k: v.clone() for k, v in m.items()}))
    assert td3.graph_captures == 1
    assert _diff(runs[0], runs[1]) == []
    assert int(runs[0][0]["device_step"]) == 50


# ------------------------------------------------ the fused on-device loop

# The README's on-device history length: a new sequence length for K2-K4.
T8_SHAPES = [(16, 4, 8, 16), (64, 4, 8, 16), (128, 4, 8, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", T8_SHAPES)
def test_kernels_at_history_8_match_plain(cuda, shape):
    """K2-K4 at the acting batch (16), the update batch (64) and the
    stacked critics' fold (128) of history 8, on the model's split views."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    b, h, t, d = shape
    q, k, v, do = (torch.randn((b, t, h * d), generator=gen, device=cuda)
                   .reshape(b, t, h, d).transpose(1, 2) for _ in range(4))
    out, lse = tattn.flash_attention_forward(q, k, v, True, return_lse=True)
    ref, ref_lse = tattn.reference_attention(q, k, v, True, return_lse=True)
    got = tattn.flash_attention_backward(q, k, v, out, lse, do, True)
    want = _plain_backward(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-5
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    _assert_backward_close(got, want, torch.float32)


ONDEVICE_CASES = {
    "flat": dict(hidden_sizes=(64, 64), batch_size=32),
    "sequence": dict(history_len=8, seq_d_model=64, seq_num_heads=4, seq_num_layers=2,
                     batch_size=32),
}


def _ondevice_loop(cuda, cfg):
    from torch_actor_critic_tpu_torch.envs.ondevice import PendulumTorch
    from torch_actor_critic_tpu_torch.sac.ondevice import OnDeviceLoop, _wrap_and_build

    env, learner = _wrap_and_build(PendulumTorch, cfg)
    return OnDeviceLoop(learner, env, n_envs=16, device=cuda)


def _gen_clone(gen):
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def _ondevice_snapshot(state, ring, es, act_gen, metrics) -> dict:
    return {"state": state.state_dict(), "ring": ring.state_dict(),
            "device_size": int(ring.device_size), "env": [x.cpu() for x in es.leaves()],
            "env_gen": es.rng.get_state(), "act_gen": act_gen.get_state(),
            # NaN (a reward with no episode ended) compares by its mask
            "metrics": [{k: (v.nan_to_num().cpu(), v.isnan().cpu()) for k, v in m.items()}
                        for m in metrics]}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(ONDEVICE_CASES))
def test_captured_on_device_epochs_equal_the_eager_epochs_bitwise(cuda, name):
    """From one initial state, a warm-up and two trained epochs with the
    acting steps and the bursts as CUDA graph replays, against the same
    epochs run eagerly: learner, ring, env states, the three generators
    and the metrics to the bit; one capture of each graph."""
    cfg = SACConfig(update_every=10, **ONDEVICE_CASES[name])
    state, ring, es, act_gen = _ondevice_loop(cuda, cfg).init(0, buffer_capacity=2000)
    runs = {}
    for eager in (True, False):
        loop = _ondevice_loop(cuda, cfg)
        parts = (state.clone(), ring.clone(), es.clone(), _gen_clone(act_gen))
        metrics = []
        for steps, warmup in ((20, True), (30, False), (30, False)):
            *parts, m = loop.epoch(*parts, steps=steps, update_every=10, warmup=warmup,
                                   eager=eager)
            metrics.append(m)
        torch.cuda.synchronize()
        runs[eager] = _ondevice_snapshot(*parts, metrics)
        if not eager:
            assert loop.act_captures == 2 and loop.sac.graph_captures == 1
    assert _diff(runs[False], runs[True]) == []
    assert runs[False]["state"]["step"] == 60 and runs[False]["ring"]["size"] == 80 * 16


@pytest.mark.gpu
def test_an_on_device_epoch_does_not_synchronize(cuda):
    """Once its graphs are captured, an epoch of the sequence cell runs
    under ``set_sync_debug_mode("error")``: nothing reads the device."""
    cfg = SACConfig(update_every=10, **ONDEVICE_CASES["sequence"])
    loop = _ondevice_loop(cuda, cfg)
    parts = loop.init(0, buffer_capacity=2000)
    for steps, warmup in ((20, True), (20, False)):
        *parts, _ = loop.epoch(*parts, steps=steps, update_every=10, warmup=warmup)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        *parts, m = loop.epoch(*parts, steps=20, update_every=10)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert math.isfinite(float(m["loss_q"])) and parts[0].step == 40
    assert loop.act_captures == 2 and loop.sac.graph_captures == 1


# ------------------------------------------------ the fused population


def _population_loop(cuda, members, pbt=False, **over):
    from torch_actor_critic_tpu_torch.envs.ondevice import PendulumTorch, history_env
    from torch_actor_critic_tpu_torch.sac.ondevice import PopulationOnDeviceLoop
    from torch_actor_critic_tpu_torch.sac.population import PopulationSAC

    cfg = SACConfig(update_every=10, population=members, on_device=True,
                    pbt_every=1 if pbt else 0, **over)
    env = history_env(PendulumTorch, cfg.history_len) if cfg.history_len > 1 else PendulumTorch
    return PopulationOnDeviceLoop(PopulationSAC(cfg, 1, members), env, members, n_envs=4,
                                  pbt=pbt, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(ONDEVICE_CASES))
def test_captured_population_epochs_equal_the_eager_epochs_bitwise(cuda, name):
    """A population of 3 with PBT hyperparameters: a warm-up and two
    trained epochs as CUDA graph replays against the same epochs run
    eagerly, from one initial state, to the bit; one capture of each
    graph."""
    loop = _population_loop(cuda, 3, pbt=True, **ONDEVICE_CASES[name])
    state, ring, es, act_gen, _ = loop.init(0, buffer_capacity=500)
    runs = {}
    for eager in (True, False):
        loop = _population_loop(cuda, 3, pbt=True, **ONDEVICE_CASES[name])
        parts = (state.clone(), ring.clone(), es.clone(), _gen_clone(act_gen))
        metrics = []
        for steps, warmup in ((20, True), (30, False), (30, False)):
            *parts, m = loop.epoch(*parts, steps=steps, update_every=10, warmup=warmup,
                                   eager=eager)
            metrics.append(m)
        torch.cuda.synchronize()
        runs[eager] = _ondevice_snapshot(*parts, metrics)
        if not eager:
            assert loop.act_captures == 2 and loop.sac.graph_captures == 1
    assert _diff(runs[False], runs[True]) == []
    assert runs[False]["ring"]["leaves"]["rewards"].shape == (3, 80 * 4)


def _flash_launches(fn) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lead_in = torch.zeros(1, device="cuda")
        for _ in range(64):  # the profiler can lose a trace's first kernels
            lead_in.add_(1)
        fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"), 0)
    for e in prof.key_averages():
        for k in out:
            if e.device_type == DeviceType.CUDA and k in e.key:
                out[k] += e.count
    return out


@pytest.mark.gpu
def test_attention_launches_per_update_do_not_grow_with_the_population(cuda):
    """A captured epoch of the history-8 population launches L K2 per
    acting step and 5L K2, 2L K3, 2L K4 per update, at P = 2 as at P = 6:
    the member axis is folded into each call's batch."""
    counts = {}
    for p in (2, 6):
        loop = _population_loop(cuda, p, **ONDEVICE_CASES["sequence"])
        parts = loop.init(0, buffer_capacity=500)[:4]
        for steps, warmup in ((20, True), (20, False)):
            parts = loop.epoch(*parts, steps=steps, update_every=10, warmup=warmup)[:4]
        torch.cuda.synchronize()
        counts[p] = _flash_launches(
            lambda: loop.epoch(*parts, steps=20, update_every=10))
    layers, updates = 2, 20
    want = {"flash_fwd_kernel": layers * 20 + 5 * layers * updates,
            "flash_bwd_dq_kernel": 2 * layers * updates,
            "flash_bwd_dkv_kernel": 2 * layers * updates}
    assert counts[2] == counts[6] == want, counts


@pytest.mark.gpu
def test_an_exploit_under_the_graphs_is_seen_by_the_next_replay(cuda):
    """After the graphs are captured, a PBT step writes in place: the
    next captured epoch equals an eager epoch run from a clone of the
    exploited state, with no new capture, and the loser starts it as its
    winner."""
    loop = _population_loop(cuda, 4, pbt=True, hidden_sizes=(64, 64), batch_size=32)
    state, ring, es, act_gen, ps = loop.init(0, buffer_capacity=500)
    for steps, warmup in ((20, True), (20, False)):
        state, ring, es, act_gen, _ = loop.epoch(state, ring, es, act_gen, steps=steps,
                                                 update_every=10, warmup=warmup)
    ps.return_ema.copy_(torch.tensor([0.0, 10.0, 5.0, 3.0]))
    ps.ema_count.fill_(1)
    ev = loop.pbt_step(state, ps)
    assert ev["exploited"].tolist() == [True, False, False, False] and int(ev["src"][0]) == 1
    for x in state.actor.parameters():
        assert torch.equal(x[0], x[1])
    eager_loop = _population_loop(cuda, 4, pbt=True, hidden_sizes=(64, 64), batch_size=32)
    clone = (state.clone(), ring.clone(), es.clone(), _gen_clone(act_gen))
    *got, m = loop.epoch(state, ring, es, act_gen, steps=20, update_every=10)
    *want, wm = eager_loop.epoch(*clone, steps=20, update_every=10, eager=True)
    torch.cuda.synchronize()
    assert loop.act_captures == 2 and loop.sac.graph_captures == 1
    assert _diff(_ondevice_snapshot(*got, [m]), _ondevice_snapshot(*want, [wm])) == []


# ------------------------------- the host, pixel and TD3 populations

PIXEL_SMALL = dict(filters=(8, 16), kernel_sizes=(4, 3), strides=(2, 2), cnn_dense_size=32,
                   cnn_features=8, normalize_pixels=True, frame_augment="shift",
                   pixel_pipeline="fused", hidden_sizes=(64, 64), batch_size=32)
HOST_POPULATION_CASES = {
    # name: (config overrides, observation shape: a flat dim, a history, or pixels)
    "sequence": (dict(ONDEVICE_CASES["sequence"], history_len=8), (8, 3)),
    "pixel": (PIXEL_SMALL, "pixel"),
    "td3": (dict(algorithm="td3", hidden_sizes=(64, 64), batch_size=32), (3,)),
}


def _host_population(cuda, name, members=3):
    from torch_actor_critic_tpu_torch.core.types import MultiObservation
    from torch_actor_critic_tpu_torch.parallel.population import PopulationLearner
    from torch_actor_critic_tpu_torch.sac.population import make_population_learner

    over, shape = HOST_POPULATION_CASES[name]
    if shape == "pixel":
        shape = MultiObservation(features=(1,), frame=(32, 32, 3))
    cfg = SACConfig(update_every=10, population=members, **over)
    learner = PopulationLearner(make_population_learner(cfg, 1, members), members)
    state = learner.init_state(0, shape, 1, 2.0, torch.device(cuda))
    ring = learner.init_buffer(500, shape, 1, torch.device(cuda))
    return learner, state, ring, shape


def _host_chunk(shape, members, n, seed):
    from torch_actor_critic_tpu_torch.core.types import Batch, MultiObservation

    g = torch.Generator().manual_seed(seed)

    def obs():
        if isinstance(shape, MultiObservation):
            return MultiObservation(torch.randn((members, n, 1), generator=g),
                                    torch.randint(0, 256, (members, n, 32, 32, 3), generator=g,
                                                  dtype=torch.uint8))
        return torch.randn((members, n, *shape), generator=g)

    return Batch(obs(), torch.rand((members, n, 1), generator=g) * 4 - 2,
                 torch.randn((members, n), generator=g), obs(),
                 (torch.rand((members, n), generator=g) < 0.1).float()).map(
        lambda x: x.to("cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(HOST_POPULATION_CASES))
def test_captured_host_population_bursts_equal_the_eager_bursts_bitwise(cuda, name):
    """A ``PopulationLearner`` of 3 (sequence, pixel, TD3): three bursts
    of 20 updates as CUDA graph replays against the eager bursts from
    one state, to the bit (the pixel one on cuDNN's deterministic
    algorithms); one capture; then bursts of 10 and 20 replay that graph."""
    from torch_actor_critic_tpu_torch.buffer.replay import push

    learner, state, ring, shape = _host_population(cuda, name)
    ring = push(ring, _host_chunk(shape, 3, 40, 0))
    chunks = [_host_chunk(shape, 3, 10, i + 1) for i in range(3)]
    runs, saved = {}, torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for eager in (True, False):
            pop = _host_population(cuda, name)[0].learner
            st, buf = state.clone(), ring.clone()
            metrics = []
            for chunk in chunks:
                st, buf, m = pop.update_burst(st, buf, chunk, 20, eager=eager)
                metrics.append(m)
            torch.cuda.synchronize()
            runs[eager] = {"state": st.state_dict(), "ring": buf.state_dict(),
                           "metrics": [{k: v.cpu() for k, v in m.items()} for m in metrics]}
            if not eager:
                assert pop.graph_captures == 1
                for n in (10, 20, 10):
                    st, buf, m = pop.update_burst(st, buf, chunks[0], n)
                assert pop.graph_captures == 1 and bool(torch.isfinite(m["loss_q"]).all())
    finally:
        torch.backends.cudnn.deterministic = saved
    assert _diff(runs[False], runs[True]) == []
    assert runs[False]["state"]["step"] == 60


@pytest.mark.gpu
def test_member_fold_gathers_every_member_in_one_launch_bitwise(cuda):
    """K1 over 4 member rings folded into one: one launch for both leaves
    of every member, bitwise each member's plain gather of its own ring;
    a frame stack raises."""
    from torch_actor_critic_tpu_torch.buffer.replay import fold_member_rows
    from torch_actor_critic_tpu_torch.ops.augment import shift_offsets
    from torch_actor_critic_tpu_torch.ops.pixels import (
        gather_frames_reference,
        member_frame_gather_pair,
    )

    g = torch.Generator(device=cuda).manual_seed(0)
    rings = [torch.randint(0, 256, (4, 300, 32, 32, 3), generator=g, device=cuda,
                           dtype=torch.uint8) for _ in range(2)]
    idx = torch.randint(0, 300, (4, 64), generator=g, device=cuda)
    idx[:, 0], idx[:, 1] = 0, 299
    offs = [shift_offsets(4 * 64, 4, g, cuda) for _ in range(2)]
    _kernels.reset_launch_counts()
    got = member_frame_gather_pair(rings, fold_member_rows(idx, 300), offs, pad=4,
                                   normalize=True)
    assert _kernels.launch_counts["pixel_gather"] == 1
    for leaf in range(2):
        for i in range(4):
            want = gather_frames_reference(rings[leaf][i], idx[i],
                                           offs[leaf].reshape(4, 64, 2)[i], 4, True)
            assert torch.equal(got[leaf][i], want)
    with pytest.raises(ValueError, match="previous member"):
        member_frame_gather_pair(rings, fold_member_rows(idx, 300), offs, frame_stack=2)


def _pixel_or_td3_loop(cuda, name, members, pbt=False):
    from torch_actor_critic_tpu_torch.envs.ondevice import PendulumTorch, PixelPendulumTorch
    from torch_actor_critic_tpu_torch.sac.ondevice import PopulationOnDeviceLoop
    from torch_actor_critic_tpu_torch.sac.population import make_population_learner

    over, _ = HOST_POPULATION_CASES[name]
    env = PixelPendulumTorch if name == "pixel" else PendulumTorch
    cfg = SACConfig(update_every=10, population=members, on_device=True,
                    pbt_every=1 if pbt else 0, **over)
    return PopulationOnDeviceLoop(make_population_learner(cfg, 1, members), env, members,
                                  n_envs=4, pbt=pbt, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["pixel", "td3"])
def test_captured_pixel_and_td3_population_epochs_equal_the_eager_epochs(cuda, name):
    """A fused pixel or TD3 population of 3 with PBT hyperparameters: a
    warm-up and two trained epochs as CUDA graph replays against the same
    epochs run eagerly, from one state, to the bit (cuDNN deterministic);
    one capture of each graph; then a PBT exploit in place (the target
    actor and ``target_noise`` too) seen by the next replay."""
    loop = _pixel_or_td3_loop(cuda, name, 3, pbt=True)
    state, ring, es, act_gen, ps = loop.init(0, buffer_capacity=500)
    runs, saved = {}, torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for eager in (True, False):
            loop = _pixel_or_td3_loop(cuda, name, 3, pbt=True)
            parts = (state.clone(), ring.clone(), es.clone(), _gen_clone(act_gen))
            metrics = []
            for steps, warmup in ((20, True), (30, False), (30, False)):
                *parts, m = loop.epoch(*parts, steps=steps, update_every=10, warmup=warmup,
                                       eager=eager)
                metrics.append(m)
            torch.cuda.synchronize()
            runs[eager] = _ondevice_snapshot(*parts, metrics)
            if not eager:
                assert loop.act_captures == 2 and loop.sac.graph_captures == 1
                captured = parts
        assert _diff(runs[False], runs[True]) == []
        st = captured[0]
        ps.return_ema.copy_(torch.tensor([0.0, 10.0, 5.0], device=cuda))
        ps.ema_count.fill_(1)
        ev = loop.pbt_step(st, ps)
        assert ev["exploited"].tolist() == [True, False, False]
        for mod in st.modules():
            for x in mod.parameters():
                assert torch.equal(x[0], x[1])
        *_, m = loop.epoch(*captured, steps=20, update_every=10)
        torch.cuda.synchronize()
        assert loop.act_captures == 2 and loop.sac.graph_captures == 1
        assert bool(torch.isfinite(m["loss_q"]).all())
    finally:
        torch.backends.cudnn.deterministic = saved


@pytest.mark.gpu
def test_host_population_trains_resumes_and_evaluates_on_the_card(cuda, tmp_path):
    """``Trainer`` with ``population=3`` on the card: an epoch, a restore
    in place under the captured graph, another epoch with no new
    capture; ``evaluate`` per member."""
    from torch_actor_critic_tpu_torch.sac.trainer import Trainer
    from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer

    cfg = SACConfig(**{**RESUME_CFG, "epochs": 1, "population": 3,
                       "normalize_observations": True})
    tr = Trainer("PendulumNumpy-v1", cfg, device=cuda, checkpointer=Checkpointer(tmp_path))
    try:
        tr.train()
        assert tr.sac.graph_captures == 1
        tr.restore()
        m = tr.train()
        assert tr.sac.graph_captures == 1 and {"reward_m0", "reward_m2"} <= set(m)
        ev = tr.evaluate(episodes=1, seed=0)
        assert len(ev["per_member"]) == 3
    finally:
        tr.close()


# ----------------------------------------------------- the serving plane

SERVE_CFG = SACConfig(history_len=16)


def _served_actor(seed=0):
    return build_actor(SERVE_CFG, (16, 3), 1, 2.0, generator=torch.Generator().manual_seed(seed))


def _serve_obs(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 16, 3)).astype(np.float32)


@pytest.mark.gpu
def test_engine_graphs_equal_eager_at_every_bucket(cuda):
    """Every (bucket, deterministic) forward is one captured graph, taken
    at warmup; each replay equals the eager forward bitwise, the sampled
    ones from one generator state (which both leave where they found it
    plus one forward's draws)."""
    eng = PolicyEngine(_served_actor(), ObsSpec((16, 3)), max_batch=64, device=cuda)
    params = eng.prepare_params(_served_actor().state_dict())
    warmed = eng.warmup(params)
    stats = eng.compile_stats()
    assert len(warmed) == 2 * len(eng.buckets) == eng.graph_count()
    assert stats["compiles_total"] == 2 * len(eng.buckets) and stats["live_compiles"] == 0
    gen = eng.generator
    for i, bucket in enumerate(eng.buckets):
        for rows in sorted({max(1, bucket - 1), bucket}):
            obs = _serve_obs(rows, seed=10 * i + rows)
            np.testing.assert_array_equal(
                eng.act(params, obs), eng.forward_eager(params, obs))
            state = gen.get_state()
            got = eng.act(params, obs, gen, deterministic=False)
            after = gen.get_state()
            gen.set_state(state)
            want = eng.forward_eager(params, obs, gen, deterministic=False)
            np.testing.assert_array_equal(got, want)
            assert torch.equal(after, gen.get_state())
    assert eng.compile_stats() == stats and eng.graph_count() == 2 * len(eng.buckets)
    # Any other generator lends its state to the replay: the same draws
    # as the engine's own from that state, and it advances as they do.
    other = torch.Generator(device=cuda)
    state = gen.get_state()
    other.set_state(state)
    obs = _serve_obs(3, seed=99)
    lent = eng.act(params, obs, other, deterministic=False)
    gen.set_state(state)
    np.testing.assert_array_equal(lent, eng.act(params, obs, gen, deterministic=False))
    assert torch.equal(other.get_state(), gen.get_state())


@pytest.mark.gpu
def test_engine_reload_keeps_graphs_and_inflight_batch_keeps_old_weights(cuda):
    """A hot-reload swap captures nothing; a batch the batcher dispatched
    before the swap (its engine call held at the door) is answered on
    the weights it acquired, bitwise, and the next on the new ones."""
    import threading

    from torch_actor_critic_tpu_torch.serve import MicroBatcher, ModelRegistry

    reg = ModelRegistry(device=cuda)
    reg.register("default", _served_actor(0), ObsSpec((16, 3)),
                 params=_served_actor(0).state_dict(), max_batch=64)
    engine, old, _ = reg.acquire()
    captures = engine.compile_stats()["compiles_total"]
    obs = _serve_obs(7, seed=3)
    want_old = engine.forward_eager(old, obs)
    release, entered = threading.Event(), threading.Event()
    real_act = engine.act

    def held(*a, **k):
        entered.set()
        release.wait(30)
        return real_act(*a, **k)

    engine.act = held
    with MicroBatcher(reg, max_batch=64) as mb:
        fut = mb.submit(obs)
        assert entered.wait(30)
        reg.swap("default", _served_actor(5).state_dict())
        release.set()
        res = fut.result(timeout=60)
        engine.act = real_act
        assert res.generation == 0
        np.testing.assert_array_equal(res.action, want_old)
        _, new, gen = reg.acquire()
        res2 = mb.act(obs, timeout=60)
        assert gen == res2.generation == 1
        np.testing.assert_array_equal(res2.action, engine.forward_eager(new, obs))
        assert not np.array_equal(res2.action, want_old)
    assert engine.compile_stats()["compiles_total"] == captures
    assert engine.compile_stats()["live_compiles"] == 0
    reg.close()


@pytest.mark.gpu
def test_sampled_serving_on_every_slot_and_after_a_replacement(cuda):
    """One batcher generator serves sampled requests to two slots, each
    engine's graphs borrowing its state; a slot re-registered with
    ``replace=True`` (a new engine, a new engine generator) still serves
    them. Each answer equals the eager forward from the state the
    batcher's generator held before it."""
    from torch_actor_critic_tpu_torch.serve import MicroBatcher, ModelRegistry

    reg = ModelRegistry(device=cuda)
    for name, seed in (("default", 0), ("canary", 1)):
        reg.register(name, _served_actor(seed), ObsSpec((16, 3)),
                     params=_served_actor(seed).state_dict(), max_batch=64)
    obs = _serve_obs(5, seed=4)
    mirror = torch.Generator(device=cuda).manual_seed(3)  # the batcher's stream
    with MicroBatcher(reg, max_batch=64, seed=3) as mb:
        for step, slot in enumerate(("default", "canary", "default", "replaced", "canary")):
            if slot == "replaced":
                slot = "default"
                reg.register(slot, _served_actor(2), ObsSpec((16, 3)),
                             params=_served_actor(2).state_dict(), max_batch=64,
                             replace=True)
            engine, params, _ = reg.acquire(slot)
            want = engine.forward_eager(params, obs, mirror, deterministic=False)
            got = mb.act(obs, deterministic=False, slot=slot, timeout=60)
            np.testing.assert_array_equal(got.action, want, err_msg=f"request {step}")
            assert torch.equal(torch.tensor(mb.export_key(), dtype=torch.uint8),
                               mirror.get_state())
        assert reg.compile_stats()["live_compiles"] == 0
    reg.close()


@pytest.mark.gpu
def test_flash_bf16_on_the_serving_views(cuda):
    """K2 in bf16 at the bf16 tier's serving shape, on the model's split
    views: one kernel, within 2e-2 of its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k, v = (torch.randn((64, 16, 64), generator=gen, device=cuda).to(torch.bfloat16)
               .reshape(64, 16, 4, 16).transpose(1, 2) for _ in range(3))
    out = tattn.flash_attention_forward(q, k, v, True)
    ref = tattn.reference_attention(q, k, v, True)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    rows = _device_kernels(lambda: tattn.flash_attention_forward(q, k, v, True))
    assert len(rows) == 1 and "flash_fwd_kernel" in rows[0][0], rows


@pytest.mark.gpu
def test_precision_tiers_on_the_card(cuda):
    """bf16: K2 runs in bf16 inside the graphs, actions within 2e-2 of
    f32 and not bitwise them. int8: equal to the forward on the
    dequantized f32 weights (1e-4), under a third of f32's bytes."""
    from torch_actor_critic_tpu_torch.serve.sharded import dequantize_params

    actor = _served_actor(1)
    state = actor.state_dict()
    obs = _serve_obs(64, seed=9)
    f32 = PolicyEngine(actor, ObsSpec((16, 3)), max_batch=64, device=cuda)
    p32 = f32.prepare_params(state)
    a32 = f32.act(p32, obs)
    bf16 = PolicyEngine(actor, ObsSpec((16, 3)), precision="bf16", max_batch=64,
                        device=cuda)
    p16, _ = bf16.place_params(state)
    seen = []
    real = tattn.flash_attention_forward

    def spy(q, *a, **k):
        seen.append(q.dtype)
        return real(q, *a, **k)

    tattn.flash_attention_forward = spy
    try:
        a16 = bf16.act(p16, obs)
    finally:
        tattn.flash_attention_forward = real
    assert seen and set(seen) == {torch.bfloat16}
    assert np.abs(a16 - a32).max() <= 2e-2 and not np.array_equal(a16, a32)
    i8 = PolicyEngine(actor, ObsSpec((16, 3)), precision="int8", max_batch=64,
                      device=cuda)
    p8, nbytes8 = i8.place_params(state)
    _, nbytes32 = f32.place_params(state)
    assert nbytes8 < nbytes32 / 3
    a8 = i8.act(p8, obs)
    deq = PolicyEngine(actor, ObsSpec((16, 3)), max_batch=64, device=cuda)
    np.testing.assert_allclose(a8, deq.act(dequantize_params(p8), obs), atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_fleet_of_two_workers_on_the_card(cuda, tmp_path):
    """``serve --fleet 2`` on the one card: the router answers, both
    workers serve, SIGTERM rolls the fleet down with exit 0."""
    import json
    import os
    import signal
    import subprocess
    import sys
    from pathlib import Path
    from urllib import request as urlreq

    from torch_actor_critic_tpu_torch.utils.checkpoint import save_actor

    save_actor(tmp_path, 1, _served_actor(), SERVE_CFG)
    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch_actor_critic_tpu_torch.serve", "--ckpt-dir",
         str(tmp_path), "--obs-dim", "3", "--act-dim", "1", "--act-limit", "2.0",
         "--port", "0", "--poll-interval", "0", "--fleet", "2", "--router-poll", "0.2"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=str(repo)),
        stdout=subprocess.PIPE, text=True,
    )
    try:
        ready = json.loads(proc.stdout.readline())
        for _ in range(8):
            req = urlreq.Request(
                ready["router"] + "/act",
                data=json.dumps({"obs": _serve_obs(4).tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            out = json.loads(urlreq.urlopen(req, timeout=60).read())
            assert np.asarray(out["action"]).shape == (4, 1)
        snap = json.loads(urlreq.urlopen(ready["router"] + "/metrics", timeout=60).read())
        assert snap["responses_total"] == 8 and snap["workers_reporting"] == 2
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()


def _compute_app_pids() -> set:
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout
    return {int(x) for x in out.split() if x.strip().isdigit()}


@pytest.mark.gpu
def test_spawned_env_workers_hold_no_cuda_context(cuda):
    """The parallel pool's workers, spawned by a process that holds a CUDA
    context, open none of their own (the pool hides every card from
    them), and step as the sequential pool does, bitwise."""
    from torch_actor_critic_tpu_torch.envs.vec_env import ParallelEnvPool, SequentialEnvPool

    torch.zeros(1, device=cuda)
    env = "PendulumNumpy-v1|history:16"
    par = ParallelEnvPool(env, 2, base_seed=3, timeout_s=120)
    seq = SequentialEnvPool(env, 2, base_seed=3)
    def device_files(pid):  # the card's device nodes the process holds open
        fds, n = f"/proc/{pid}/fd", 0
        for fd in os.listdir(fds):
            try:
                n += os.readlink(os.path.join(fds, fd)).startswith("/dev/nvidia")
            except FileNotFoundError:  # closed since the listing
                pass
        return n

    try:
        assert not _compute_app_pids() & set(par.pids)
        assert device_files(os.getpid()) > 0
        assert [device_files(pid) for pid in par.pids] == [0, 0]
        np.testing.assert_array_equal(par.reset_all([1, 2]), seq.reset_all([1, 2]))
        rng = np.random.default_rng(0)
        for _ in range(20):
            a = rng.uniform(-2, 2, (2, 1)).astype(np.float32)
            for x, y in zip(par.step(a), seq.step(a)):
                np.testing.assert_array_equal(x, y)
    finally:
        par.close()
        seq.close()


@pytest.mark.gpu
def test_lagged_acting_overlaps_the_burst_on_its_own_stream(cuda):
    """``actor_param_lag`` on the card: a host sequence population's acting
    K2 kernels run on a stream other than the burst's and overlap the
    burst's kernels in a device trace; after the epoch the snapshot is the
    actor from before the last burst, bitwise, not the live one. (A trace
    the profiler lost is taken again, up to three times.)"""
    import bisect
    import itertools

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from torch_actor_critic_tpu_torch.sac.trainer import Trainer

    def tensors(m):
        return [t.detach().clone() for t in itertools.chain(m.parameters(), m.buffers())]

    cfg = SACConfig(history_len=16, population=4, epochs=1, steps_per_epoch=200, start_steps=50,
                    update_after=50, update_every=50, buffer_size=1000, actor_param_lag=True)
    for _ in range(3):
        tr = Trainer("PendulumNumpy-v1", cfg, seed=0, device=cuda)
        pre = []

        def before(fn):
            def call(*a, **k):
                pre.append(tensors(tr.state.actor))
                return fn(*a, **k)
            return call

        tr.sac.update_burst = before(tr.sac.update_burst)
        tr.sac.start_burst = before(tr.sac.start_burst)
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                tr.train()
                torch.cuda.synchronize()
            acting, live = tensors(tr._acting), tensors(tr.state.actor)
            assert all(torch.equal(x, y) for x, y in zip(acting, pre[-1], strict=True))
            assert not all(torch.equal(x, y) for x, y in zip(acting, live, strict=True))
        finally:
            tr.close()
        streams: dict = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
                streams.setdefault(e.device_resource_id(), []).append(
                    (e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        # The burst's streams ran K3 (its replays, its capture's warm-up).
        burst_streams = {s for s, evs in streams.items()
                         if any("flash_bwd_dq_kernel" in n for *_, n in evs)}
        if not burst_streams:
            continue  # a lost trace
        spans = sorted((a, b) for s in burst_streams for a, b, _ in streams[s])
        side = [(a, b) for s, evs in streams.items() if s not in burst_streams
                for a, b, n in evs if "flash_fwd_kernel" in n]
        assert side
        starts = [a for a, _ in spans]
        ends = list(itertools.accumulate((b for _, b in spans), max))

        def overlaps(a, b):  # a burst kernel starts before b and ends after a
            i = bisect.bisect_left(starts, b)
            return i > 0 and ends[i - 1] > a

        assert any(overlaps(a, b) for a, b in side)
        return
    pytest.fail("three traces held no burst")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(HOST_POPULATION_CASES))
def test_a_burst_spread_over_a_loop_equals_the_burst_at_once(cuda, name):
    """``Learner.start_burst``: after one captured burst, a burst of 20
    replays enqueued a few at a time (``advance``, as the host trainer's
    acting lag spreads it over a window) and finished equals the same
    burst through ``update_burst`` from a clone of one state, to the bit;
    each ``advance`` leaves at most ``INFLIGHT`` replays unfinished."""
    from torch_actor_critic_tpu_torch.buffer.replay import push
    from torch_actor_critic_tpu_torch.sac.graph import INFLIGHT

    learner, state, ring, shape = _host_population(cuda, name)
    pop = learner.learner
    ring = push(ring, _host_chunk(shape, 3, 40, 0))
    state, ring, _ = pop.update_burst(state, ring, _host_chunk(shape, 3, 10, 1), 20)
    chunk = _host_chunk(shape, 3, 10, 2)
    other = _host_population(cuda, name)[0].learner  # its own graph for the clone
    st, buf, want = other.update_burst(state.clone(), ring.clone(), chunk, 20)
    ref = {"state": st.state_dict(), "ring": buf.state_dict()}
    with pytest.raises(ValueError, match="captures"):
        pop.start_burst(state, ring, chunk, 40)
    burst = pop.start_burst(state, ring, chunk, 20)
    while burst.graph.ran < 20:
        burst.advance()
        unfinished = sum(not e.query() for e in burst.graph._inflight)
        assert unfinished <= INFLIGHT
    state, ring, got = burst.finish()
    torch.cuda.synchronize()
    assert pop.graph_captures == 1 and state.step == 40
    assert _diff({"state": state.state_dict(), "ring": ring.state_dict()}, ref) == []
    assert all(torch.equal(got[k], want[k]) for k in want)
