"""Sequence (causal-transformer) policy over observation histories.

Port of ``models/sequence.py`` (single device): ``MultiHeadAttention``,
``TransformerBlock``, ``SequenceTrunk`` and ``SequenceActor``. The
attention runs through :func:`~torch_actor_critic_tpu_torch.ops.attention.attention`
— the hand-written CUDA kernel on the card, the plain version on the
CPU. The ``sp_axis`` ring path and the critics wait for later slices.

Flax divergences this module reproduces on purpose:
- ``nn.LayerNorm`` uses eps = 1e-6 (torch's default is 1e-5), computes
  its statistics in f32 and returns f32 over f32 params;
- ``flax.linen.gelu`` is the tanh approximation;
- ``pos_embedding`` is a ``(max_len, d_model)`` table, added and then
  cast to the compute dtype;
- the heads cast ``mu``/``log_std`` to f32 before the distribution math.
"""

from __future__ import annotations

import typing as t

import torch
import torch.nn.functional as F
from torch import nn

from torch_actor_critic_tpu_torch.models.mlp import Dense
from torch_actor_critic_tpu_torch.ops.attention import attention as sdpa
from torch_actor_critic_tpu_torch.ops.distributions import (
    squashed_gaussian_sample,
)

# attention_fn(q, k, v, causal) -> out, all (batch, heads, seq, head_dim)
AttentionFn = t.Callable[..., torch.Tensor]

FLAX_LN_EPS = 1e-6


def default_attention(q, k, v, causal=True):
    return sdpa(q, k, v, causal=causal)


def plain_attention(q, k, v, causal=True):
    """The plain version on any device (parity checks on the card)."""
    return sdpa(q, k, v, causal=causal, impl="plain")


def _auto_batch(obs_seq: torch.Tensor):
    """``(unbatched, obs_seq)``: an unbatched ``(T, D)`` history gains a
    leading batch axis."""
    unbatched = obs_seq.dim() == 2
    return unbatched, (obs_seq[None] if unbatched else obs_seq)


class LayerNorm(nn.LayerNorm):
    """Flax ``nn.LayerNorm``: eps 1e-6, f32 statistics and output."""

    def __init__(self, d: int):
        super().__init__(d, eps=FLAX_LN_EPS)  # Flax eps 1e-6; torch's default is 1e-5

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        )


class MultiHeadAttention(nn.Module):
    """Causal MHA; projections are ``Dense`` (``nn.Linear``), the
    attention itself is ``attention_fn``."""

    def __init__(
        self, d_model: int, num_heads: int,
        attention_fn: AttentionFn = default_attention,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} % num_heads {num_heads} != 0")
        self.num_heads = num_heads
        self.attention_fn = attention_fn
        self.q = Dense(d_model, d_model, dtype=dtype)
        self.k = Dense(d_model, d_model, dtype=dtype)
        self.v = Dense(d_model, d_model, dtype=dtype)
        self.o = Dense(d_model, d_model, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d_model = x.shape
        hd = d_model // self.num_heads

        def split(y):  # (B, T, D) -> (B, H, T, d)
            return y.reshape(b, s, self.num_heads, hd).transpose(1, 2)

        out = self.attention_fn(
            split(self.q(x)), split(self.k(x)), split(self.v(x)), causal=True
        )
        return self.o(out.transpose(1, 2).reshape(b, s, d_model))


class TransformerBlock(nn.Module):
    """Pre-LN block: LN → MHA → residual, LN → GELU(tanh) MLP → residual."""

    def __init__(
        self, d_model: int, num_heads: int, mlp_ratio: int = 4,
        attention_fn: AttentionFn = default_attention,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.ln1 = LayerNorm(d_model)
        self.attn = MultiHeadAttention(d_model, num_heads, attention_fn, dtype)
        self.ln2 = LayerNorm(d_model)
        self.fc1 = Dense(d_model, mlp_ratio * d_model, dtype=dtype)
        self.fc2 = Dense(mlp_ratio * d_model, d_model, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        # flax.linen.gelu is the tanh approximation, not torch's erf default.
        h = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(h)


class SequenceTrunk(nn.Module):
    """Embed + positional table + N causal blocks + final LayerNorm."""

    def __init__(
        self, obs_dim: int, d_model: int = 128, num_heads: int = 4,
        num_layers: int = 2, max_len: int = 512,
        attention_fn: AttentionFn = default_attention,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.max_len = max_len
        self.dtype = dtype
        self.embed = Dense(obs_dim, d_model, dtype=dtype)
        self.pos_embedding = nn.Parameter(torch.randn(max_len, d_model) * 0.02)
        self.blocks = nn.ModuleList(
            TransformerBlock(d_model, num_heads, attention_fn=attention_fn, dtype=dtype)
            for _ in range(num_layers)
        )
        self.ln_f = LayerNorm(d_model)

    def forward(self, obs_seq: torch.Tensor, pos_offset: int = 0) -> torch.Tensor:
        s = obs_seq.shape[1]
        if pos_offset + s > self.max_len:
            raise ValueError(
                f"history length {s} (offset {pos_offset}) exceeds "
                f"max_len={self.max_len}"
            )
        x = self.embed(obs_seq)
        pos = self.pos_embedding[pos_offset:pos_offset + s]
        # The f32 (max_len, d_model) table is added, THEN the sum is cast
        # to the compute dtype (Flax promotes a bf16 stream to f32 here).
        x = (x + pos[None]).to(self.dtype)
        for block in self.blocks:
            x = block(x)
        return self.ln_f(x)


class SequenceActor(nn.Module):
    """Squashed-Gaussian policy conditioned on a ``(B, T, obs_dim)``
    history; acts for the latest timestep."""

    def __init__(
        self, obs_dim: int, act_dim: int, d_model: int = 128,
        num_heads: int = 4, num_layers: int = 2, max_len: int = 512,
        act_limit: float = 1.0,
        attention_fn: AttentionFn = default_attention,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.trunk = SequenceTrunk(
            obs_dim, d_model, num_heads, num_layers, max_len, attention_fn,
            dtype=dtype,
        )
        self.mu = Dense(d_model, act_dim, dtype=dtype)
        self.log_std = Dense(d_model, act_dim, dtype=dtype)
        self.act_limit = float(act_limit)

    def head(
        self, h: torch.Tensor, generator=None, deterministic=False,
        with_logprob=True, eps=None,
    ):
        # Flax casts mu/log_std to f32: the distribution math never runs bf16.
        mu = self.mu(h).float()
        log_std = self.log_std(h).float()
        return squashed_gaussian_sample(
            mu, log_std, self.act_limit, deterministic, with_logprob,
            generator=generator, eps=eps,
        )

    def forward(
        self,
        obs_seq: torch.Tensor,
        generator: torch.Generator | None = None,
        deterministic: bool = False,
        with_logprob: bool = True,
        eps: torch.Tensor | None = None,
    ):
        unbatched, obs_seq = _auto_batch(obs_seq)
        if unbatched and eps is not None:
            eps = eps.reshape(1, -1)
        h = self.trunk(obs_seq)[:, -1]
        action, logp = self.head(h, generator, deterministic, with_logprob, eps)
        if unbatched:
            action = action.squeeze(0)
            logp = logp.squeeze(0) if logp is not None else None
        return action, logp
