"""Scaled-dot-product attention: the plain versions and the CUDA kernels.

Port of ``ops/attention.py``. All public functions take the JAX layout
``(batch, heads, seq, head_dim)``.

- :func:`reference_attention` — the plain dense version: the full
  ``(Tq, Tk)`` score matrix, causal mask with global ``q_offset`` /
  ``k_offset``, rows with no visible key set to 0. ``impl='plain'``.
- :func:`flash_attention_forward` — the wrapper of the hand-written
  Hopper kernel ``csrc/flash_fwd.cu`` (K2, the port of the TPU kernel
  ``_flash_kernel``).
- :func:`flash_attention_backward` — the kernels ``csrc/flash_bwd.cu``:
  K3 (``_flash_bwd_dq_kernel``), which also computes Δ = rowsum(dO∘O)
  in f32 and writes it out, then K4 (``_flash_bwd_dkv_kernel``), which
  reads that Δ. Two device kernels per call on the model's views.
- :class:`FlashAttention` — the ``autograd.Function`` joining the two
  (the port of ``flash_attention``'s ``custom_vjp``).
- :func:`attention` — the dispatch the models call.

Each wrapper validates and zero-pads the head dim to 16/32/64/128 (the
scale keeps the logical head dim), then launches: on CPU tensors the
plain version of that one kernel (``_plain_flash_fwd``,
``_plain_flash_bwd_dq``, ``_plain_flash_bwd_dkv``, same signatures and
the same bf16 rounding), on CUDA tensors the kernel. A build or launch
failure raises; nothing falls back.

``blockwise_attention``/``online_block_update`` (the ring path) are
not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from torch_actor_critic_tpu_torch.ops import _kernels
from torch_actor_critic_tpu_torch.telemetry import costmodel

_KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An f32 intermediate as a product with a ``dtype`` operand sees
    it: rounded to bf16 for bf16 operands (the TPU kernels' ``_acc_dot``
    rule), unchanged for f32."""
    return x.to(dtype).float() if dtype != torch.float32 else x


def _plain_softmax_pv(scores, v, out_dtype, return_lse):
    """Finish attention from f32 ``scores`` (``-inf`` where masked) the
    way the kernel does: unnormalised ``p = exp(s - max)``, normaliser
    summed in f32, ``p`` rounded to the input dtype before ``P·V``
    (bf16 inputs), f32 accumulation, all-masked rows -> 0."""
    m = scores.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(scores - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(_operand(p, v.dtype), v.float())
    out = (acc / torch.where(l == 0, torch.ones_like(l), l)).to(out_dtype)
    if not return_lse:
        return out
    lse = torch.where(
        l == 0, torch.full_like(l, float("-inf")), m_safe + torch.log(l)
    )
    return out, lse.squeeze(-1)


def _scores(q, k, causal: bool, scale: float, q_offset: int = 0, k_offset: int = 0):
    """f32 ``QKᵀ·scale``, ``-inf`` where the causal mask (global
    positions ``q_offset + i`` vs ``k_offset + j``) hides a key."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        q_pos = q_offset + torch.arange(s.shape[-2], device=q.device)[:, None]
        k_pos = k_offset + torch.arange(s.shape[-1], device=q.device)[None, :]
        s = s.masked_fill(q_pos < k_pos, float("-inf"))
    return s


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
    scores = _scores(q, k, causal, 1.0 / math.sqrt(q.shape[-1]), q_offset, k_offset)
    return _plain_softmax_pv(scores, v, q.dtype, return_lse)


# ------------------------------------------------- plain versions of K2-K4
# Same signatures as the kernels' wrappers see them: head-dim-padded
# (B, H, T, dp) operands, the logical scale, f32 (B, H, Tq) lse/Δ.


def _plain_flash_fwd(q, k, v, causal: bool, scale: float):
    """K2's plain version: ``(out, lse)``."""
    return _plain_softmax_pv(_scores(q, k, causal, scale), v, q.dtype, return_lse=True)


def _plain_probs(q, k, lse, causal: bool, scale: float) -> torch.Tensor:
    """``p = exp(s - lse)`` from the saved lse, 0 where masked or where
    the forward saw no key (lse = -inf)."""
    s = _scores(q, k, causal, scale)
    lse = torch.where(torch.isneginf(lse), torch.full_like(lse, float("inf")), lse)
    return torch.exp(s - lse[..., None])


def _plain_flash_bwd_dq(q, k, v, o, do, lse, causal: bool, scale: float):
    """K3's plain version: ``(dQ, Δ)`` with ``Δ = rowsum(dO∘O)`` in f32
    and ``dQ = (p∘(dO·Vᵀ − Δ))·K · scale``."""
    delta = (do.float() * o.float()).sum(dim=-1)
    p = _plain_probs(q, k, lse, causal, scale)
    dpv = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dpv - delta[..., None])
    dq = (torch.matmul(_operand(ds, k.dtype), k.float()) * scale).to(q.dtype)
    return dq, delta


def _plain_flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float):
    """K4's plain version: ``(dK, dV)`` with ``dV = pᵀ·dO`` and
    ``dK = (p∘(dO·Vᵀ − Δ))ᵀ·Q · scale``."""
    p = _plain_probs(q, k, lse, causal, scale)
    dv = torch.matmul(_operand(p, do.dtype).transpose(-1, -2), do.float())
    dpv = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dpv - delta[..., None])
    dk = torch.matmul(_operand(ds, q.dtype).transpose(-1, -2), q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------- the wrappers


def _check_qkv(where: str, q, k, v) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 4:
            raise ValueError(
                f"{where}: {name} must be (B, H, T, d), got shape {tuple(x.shape)}"
            )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise ValueError(
            f"{where}: q/k/v must share one dtype, float32 or bfloat16; "
            f"got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError(f"{where}: q/k/v on different devices")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape != k.shape:
        raise ValueError(
            f"{where}: shapes disagree: q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if tq < 1 or tk < 1 or d > _KERNEL_HEAD_DIMS[-1]:
        raise ValueError(
            f"{where}: needs T >= 1 and d <= 128, got Tq={tq}, Tk={tk}, d={d}"
        )


def _padded(d: int) -> int:
    return next(x for x in _KERNEL_HEAD_DIMS if x >= d)


def _pad(dp: int, *xs: torch.Tensor):
    return tuple(F.pad(x, (0, dp - x.shape[-1])) if x.shape[-1] != dp else x
                 for x in xs)


def _reads_in_place(x: torch.Tensor) -> bool:
    """Whether K2-K4 can read the 4-D tensor ``x`` where it lies:
    a unit-stride last dim, and a base and (batch, head, seq) strides
    that are whole 16-byte copies (``cp.async`` reads 16 bytes at a time).
    A stride of a size-1 dim is never applied, so it does not count."""
    if x.stride(-1) != 1 or x.data_ptr() % 16:
        return False
    return all(
        n == 1 or (s * x.element_size()) % 16 == 0
        for n, s in zip(x.shape[:-1], x.stride()[:-1])
    )


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernels can read it in place (the model's
    split ``(B, T, H, d)`` views), else a contiguous, aligned copy."""
    if _reads_in_place(x):
        return x
    x = x.contiguous()
    return x if _reads_in_place(x) else x.clone()


def _bthd(b: int, h: int, t: int, d: int, like: torch.Tensor) -> torch.Tensor:
    """An uninitialised ``(B, H, T, d)`` view of ``(B, T, H, d)`` memory
    with ``like``'s dtype and device."""
    return torch.empty((b, t, h, d), dtype=like.dtype, device=like.device).transpose(1, 2)


def flash_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    return_lse: bool = False,
):
    """Flash-attention forward: ``out`` (q's dtype) and, with
    ``return_lse``, the f32 per-row logsumexp ``(B, H, Tq)``.

    q/k/v: one dtype (float32 or bfloat16), head dim <= 128. On CPU
    tensors the launch is :func:`_plain_flash_fwd` (the CPU has no
    kernel); any other device runs ``csrc/flash_fwd.cu`` and must be
    CUDA. The kernel reads q/k/v through their strides where
    :func:`_reads_in_place` allows (the model's split views do). Both
    routes return ``out`` as the ``(B, H, T, d)`` view of a ``(B, T, H,
    d)`` tensor (the plain version's result is copied there), so what
    follows runs the same ops on either. Under a
    :class:`~..telemetry.costmodel.CostCount` the call counts K2's
    formula work and none of its own ops. A build or launch failure
    raises; nothing falls back.
    """
    on_cpu = q.device.type == "cpu"
    fn = None if on_cpu else _kernels.load("flash_fwd")
    _check_qkv("flash_attention_forward", q, k, v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    count = costmodel.note_kernel("flash_fwd", costmodel.attention_fwd_work,
                                  (b, h, tq, tk, d), causal, q.dtype, return_lse)
    with costmodel.paused(count):
        scale = 1.0 / math.sqrt(d)
        dp = _padded(d)
        q, k, v = _pad(dp, q, k, v)
        # Written in the model's (B, T, H, d) layout: its merge of the
        # heads back into (B, T, D) is then a view, not a copy.
        out = _bthd(b, h, tq, dp, q)
        lse = (
            torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
            if return_lse else None
        )
        if on_cpu:
            plain_out, plain_lse = _plain_flash_fwd(q, k, v, causal, scale)
            out.copy_(plain_out)
            if lse is not None:
                lse.copy_(plain_lse)
        else:
            if not (q.is_cuda and k.is_cuda and v.is_cuda):
                raise ValueError("flash_attention_forward: an operand is not a CUDA tensor")
            q, k, v = (_kernel_view(x) for x in (q, k, v))
            _kernels.launch("flash_fwd", fn, q.device, (
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if lse is not None else None,
                b, h, tq, tk, dp, _KERNEL_DTYPES[q.dtype], int(bool(causal)), scale,
                *(s for x in (q, k, v, out) for s in x.stride()[:3]),
                torch.cuda.current_stream(q.device).cuda_stream,
            ), f"B={b}, H={h}, Tq={tq}, Tk={tk}, d={dp}, {q.dtype}")
        if dp != d:
            out = out[..., :d]
    return (out, lse) if return_lse else out


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool = False,
):
    """``(dq, dk, dv, delta)``: the gradients of attention from the
    forward's ``o`` and f32 ``lse`` and the cotangent ``do``, in
    q's/k's/v's dtypes, and K3's f32 Δ = rowsum(dO∘O), ``(B, H, Tq)``.

    ``do`` is cast to q's dtype (an f32 loss over a bf16 output must not
    make the kernels downcast a real input). K3 computes Δ for its rows
    (zero head-dim padding leaves it unchanged) and K4 reads it: on CPU
    tensors their plain versions run. The kernels read q/k/v/o/dO through
    their strides where :func:`_reads_in_place` allows (the model's views
    do) and write dq/dk/dv as ``(B, H, T, d)`` views of ``(B, T, H, d)``
    tensors (on both routes: the plain versions' results are copied
    there), so the backward of the model's head split is a view. Under a
    :class:`~..telemetry.costmodel.CostCount` the call counts K3's and
    K4's formula work and none of its own ops.
    """
    on_cpu = q.device.type == "cpu"
    fns = None if on_cpu else (
        _kernels.load("flash_bwd_dq"), _kernels.load("flash_bwd_dkv"),
    )
    _check_qkv("flash_attention_backward", q, k, v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(
            "flash_attention_backward: o and do must have q's shape "
            f"{tuple(q.shape)}, got {tuple(o.shape)} and {tuple(do.shape)}"
        )
    if lse.shape != (b, h, tq) or lse.dtype != torch.float32:
        raise ValueError(
            "flash_attention_backward: lse must be f32 (B, H, Tq), got "
            f"{lse.dtype} {tuple(lse.shape)}"
        )
    count = costmodel.note_kernel("flash_bwd_dq", costmodel.attention_bwd_work,
                                  (b, h, tq, tk, d), causal, q.dtype, "flash_bwd_dq")
    costmodel.note_kernel("flash_bwd_dkv", costmodel.attention_bwd_work,
                          (b, h, tq, tk, d), causal, q.dtype, "flash_bwd_dkv")
    with costmodel.paused(count):
        do = do.to(q.dtype)
        scale = 1.0 / math.sqrt(d)
        dp = _padded(d)
        q, k, v, o, do = _pad(dp, q, k, v, o.to(q.dtype), do)
        delta = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
        dq = _bthd(b, h, tq, dp, q)
        dk = _bthd(b, h, tk, dp, k)
        dv = _bthd(b, h, tk, dp, v)
        if on_cpu:
            plain_dq, plain_delta = _plain_flash_bwd_dq(q, k, v, o, do, lse, causal, scale)
            plain_dk, plain_dv = _plain_flash_bwd_dkv(q, k, v, do, lse, plain_delta, causal,
                                                      scale)
            for x, y in ((dq, plain_dq), (delta, plain_delta), (dk, plain_dk), (dv, plain_dv)):
                x.copy_(y)
        else:
            if not all(x.is_cuda for x in (q, k, v, o, do, lse)):
                raise ValueError("flash_attention_backward: an operand is not a CUDA tensor")
            q, k, v, o, do = (_kernel_view(x) for x in (q, k, v, o, do))
            lse = lse.contiguous()
            common = (b, h, tq, tk, dp, _KERNEL_DTYPES[q.dtype], int(bool(causal)), scale)
            stream = torch.cuda.current_stream(q.device).cuda_stream
            note = f"B={b}, H={h}, Tq={tq}, Tk={tk}, d={dp}, {q.dtype}"
            _kernels.launch("flash_bwd_dq", fns[0], q.device, (
                *(x.data_ptr() for x in (q, k, v, o, do, lse, delta, dq)), *common,
                *(s for x in (q, k, v, o, do, dq) for s in x.stride()[:3]), stream,
            ), note)
            _kernels.launch("flash_bwd_dkv", fns[1], q.device, (
                *(x.data_ptr() for x in (q, k, v, do, lse, delta, dk, dv)), *common,
                *(s for x in (q, k, v, do, dk, dv) for s in x.stride()[:3]), stream,
            ), note)
        if dp != d:
            dq, dk, dv = dq[..., :d], dk[..., :d], dv[..., :d]
    return dq, dk, dv, delta


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward in kernels: the forward is K2
    with the lse saved, the backward :func:`flash_attention_backward`
    (K3 and K4), recomputing the probabilities from the lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_attention_forward(q, k, v, causal, return_lse=True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv, _ = flash_attention_backward(q, k, v, out, lse, do, ctx.causal)
        return dq, dk, dv, None


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    impl: str = "auto",
) -> torch.Tensor:
    """``'auto'``: the flash kernels — :class:`FlashAttention` when grad
    is enabled and an input requires grad (K2 then K3/K4 in the
    backward), else the forward alone (serving under ``inference_mode``
    is exactly the forward-only path). Their plain versions run on CPU
    tensors. ``'plain'`` forces :func:`reference_attention` on any
    device, differentiated by autograd (the tests' and
    ``chip_smoke.py``'s comparison)."""
    if impl == "plain":
        return reference_attention(q, k, v, causal)
    if impl != "auto":
        raise ValueError(f"attention impl must be 'auto' or 'plain', got {impl!r}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    return flash_attention_forward(q, k, v, causal)
