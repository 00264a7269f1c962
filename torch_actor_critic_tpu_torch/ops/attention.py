"""Scaled-dot-product attention: the plain version and the CUDA kernel.

Port of ``ops/attention.py``. All functions take the JAX layout
``(batch, heads, seq, head_dim)``.

- :func:`reference_attention` — the plain PyTorch version: the dense
  ``(Tq, Tk)`` score matrix, causal mask with global ``q_offset`` /
  ``k_offset``, rows with no visible key set to 0. The CPU path, and
  the yardstick the kernel is held against on the card.
- :func:`flash_attention_forward` — the wrapper of the hand-written
  Hopper kernel ``csrc/flash_fwd.cu`` (the port of the TPU kernel
  ``_flash_kernel``). It takes the plain version only for tensors on
  the CPU; a CUDA tensor launches the kernel or raises.
- :func:`attention` — the dispatch the models call.

``blockwise_attention``/``online_block_update`` (the training and ring
paths) are not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from torch_actor_critic_tpu_torch.ops import _kernels

_KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _plain_softmax_pv(scores, v, out_dtype, return_lse):
    """Finish attention from f32 ``scores`` (``-inf`` where masked) the
    way the kernel does: unnormalised ``p = exp(s - max)``, normaliser
    summed in f32, ``p`` rounded to the input dtype before ``P·V``
    (bf16 inputs; the TPU kernel's ``_acc_dot`` rule), f32 accumulation,
    all-masked rows -> 0."""
    m = scores.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(scores - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    p_v = p.to(v.dtype).float() if v.dtype != torch.float32 else p
    acc = torch.matmul(p_v, v.float())
    out = (acc / torch.where(l == 0, torch.ones_like(l), l)).to(out_dtype)
    if not return_lse:
        return out
    lse = torch.where(
        l == 0, torch.full_like(l, float("-inf")), m_safe + torch.log(l)
    )
    return out, lse.squeeze(-1)


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    q_offset: int = 0,
    k_offset: int = 0,
    return_lse: bool = False,
):
    """Plain ``softmax(QKᵀ/sqrt(d))V`` with the full score matrix, f32
    scores and accumulation; the output has ``q``'s dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        q_pos = q_offset + torch.arange(tq, device=q.device)[:, None]
        k_pos = k_offset + torch.arange(tk, device=q.device)[None, :]
        scores = scores.masked_fill(q_pos < k_pos, float("-inf"))
    return _plain_softmax_pv(scores, v, q.dtype, return_lse)


def flash_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    return_lse: bool = False,
):
    """Flash-attention forward: ``out`` (q's dtype) and, with
    ``return_lse``, the f32 per-row logsumexp ``(B, H, Tq)``.

    On CPU tensors this is the plain version (the CPU has no kernel).
    Any other device runs ``csrc/flash_fwd.cu``: q/k/v must be CUDA,
    one dtype (float32 or bfloat16), head dim <= 128 (zero-padded to
    the next of 16/32/64/128; the scale keeps the logical head dim).
    A build or launch failure raises; nothing falls back.
    """
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal, return_lse=return_lse)
    fn = _kernels.load("flash_fwd")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"flash_attention_forward: {name} is not a CUDA tensor")
        if x.dim() != 4:
            raise ValueError(
                f"flash_attention_forward: {name} must be (B, H, T, d), "
                f"got shape {tuple(x.shape)}"
            )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise ValueError(
            "flash_attention_forward: q/k/v must share one dtype, float32 "
            f"or bfloat16; got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention_forward: q/k/v on different devices")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape != k.shape:
        raise ValueError(
            "flash_attention_forward: shapes disagree: "
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if tq < 1 or tk < 1 or d > _KERNEL_HEAD_DIMS[-1]:
        raise ValueError(
            f"flash_attention_forward: needs T >= 1 and d <= 128, got "
            f"Tq={tq}, Tk={tk}, d={d}"
        )
    scale = 1.0 / math.sqrt(d)
    dp = next(x for x in _KERNEL_HEAD_DIMS if x >= d)
    if dp != d:
        q, k, v = (F.pad(x, (0, dp - d)) for x in (q, k, v))
    # The kernel reads float4/uint2 vectors: contiguous and 16-byte
    # aligned (a view with a storage offset may not be).
    q, k, v = (x.contiguous() for x in (q, k, v))
    q, k, v = (x.clone() if x.data_ptr() % 16 else x for x in (q, k, v))
    out = torch.empty((b, h, tq, dp), dtype=q.dtype, device=q.device)
    lse = (
        torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
        if return_lse else None
    )
    args = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        b * h, tq, tk, dp, _KERNEL_DTYPES[q.dtype], int(bool(causal)),
        scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if q.device.index == torch.cuda.current_device():
        err = fn(*args)
    else:  # the runtime launches on the thread's current device
        with torch.cuda.device(q.device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(
            f"flash_fwd launch failed: cudaError {err} "
            f"(B·H={b * h}, Tq={tq}, Tk={tk}, d={dp}, {q.dtype})"
        )
    _kernels.count_launch("flash_fwd")
    if dp != d:
        out = out[..., :d]
    return (out, lse) if return_lse else out


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    impl: str = "auto",
) -> torch.Tensor:
    """``'auto'``: the flash kernel on a CUDA tensor, the plain version
    on a CPU tensor. ``'plain'`` forces the plain version on any device
    (the tests' and ``chip_smoke.py``'s comparison)."""
    if impl == "plain":
        return reference_attention(q, k, v, causal)
    if impl != "auto":
        raise ValueError(f"attention impl must be 'auto' or 'plain', got {impl!r}")
    return flash_attention_forward(q, k, v, causal)
