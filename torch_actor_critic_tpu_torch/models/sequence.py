"""Sequence (causal-transformer) policy over observation histories.

Port of ``models/sequence.py`` (single device): ``MultiHeadAttention``,
``TransformerBlock``, ``SequenceTrunk``, ``SequenceActor``,
``SequenceCritic`` and ``SequenceDoubleCritic``, and the stacked
building blocks of the last (``StackedLayerNorm``,
``StackedMultiHeadAttention``, ``StackedTransformerBlock``,
``StackedSequenceTrunk``). The attention runs
through :func:`~torch_actor_critic_tpu_torch.ops.attention.attention` —
the hand-written CUDA kernels on the card (forward, and under grad the
two backward kernels), their plain versions on the CPU. The ``sp_axis``
ring path waits for a later slice.

The critic ensemble holds its ``num_qs`` critics' parameters stacked on
a leading axis, as the JAX package's ``nn.vmap`` over ``SequenceCritic``
does, and its activations as ``(num_qs, B, T, d_model)``. Each layer's
products are one batched product for the whole ensemble, and its
attention is one call with ``num_qs`` folded into the batch axis:
``(num_qs·B, H, T, d)`` views of the projections, the same strides the
kernels read in place for one critic. The kernels treat every (batch,
head) row on its own, so each member gets what it would get alone.
Member ``i`` is drawn as the ``i``-th of ``num_qs`` ``SequenceCritic`` s
built one after another from the generator.

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

from torch_actor_critic_tpu_torch.models.mlp import (
    Dense,
    StackedDense,
    init_generator,
    stack_members_,
)
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
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} % num_heads {num_heads} != 0")
        gen = init_generator(generator)
        self.num_heads = num_heads
        self.attention_fn = attention_fn
        self.q = Dense(d_model, d_model, dtype=dtype, generator=gen)
        self.k = Dense(d_model, d_model, dtype=dtype, generator=gen)
        self.v = Dense(d_model, d_model, dtype=dtype, generator=gen)
        self.o = Dense(d_model, d_model, dtype=dtype, generator=gen)

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
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        gen = init_generator(generator)
        self.ln1 = LayerNorm(d_model)
        self.attn = MultiHeadAttention(d_model, num_heads, attention_fn, dtype, gen)
        self.ln2 = LayerNorm(d_model)
        self.fc1 = Dense(d_model, mlp_ratio * d_model, dtype=dtype, generator=gen)
        self.fc2 = Dense(mlp_ratio * d_model, d_model, dtype=dtype, generator=gen)

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
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        gen = init_generator(generator)
        self.max_len = max_len
        self.dtype = dtype
        self.embed = Dense(obs_dim, d_model, dtype=dtype, generator=gen)
        self.pos_embedding = nn.Parameter(
            torch.randn(max_len, d_model, generator=gen) * 0.02
        )
        self.blocks = nn.ModuleList(
            TransformerBlock(
                d_model, num_heads, attention_fn=attention_fn, dtype=dtype,
                generator=gen,
            )
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
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        gen = init_generator(generator)
        self.trunk = SequenceTrunk(
            obs_dim, d_model, num_heads, num_layers, max_len, attention_fn,
            dtype=dtype, generator=gen,
        )
        self.mu = Dense(d_model, act_dim, dtype=dtype, generator=gen)
        self.log_std = Dense(d_model, act_dim, dtype=dtype, generator=gen)
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


class SequenceCritic(nn.Module):
    """Q(h_T, a): the trunk encodes the history, the last token's
    representation is concatenated with the action and scored by a
    ReLU layer of ``hidden`` units and a linear output; Q is f32."""

    def __init__(
        self, obs_dim: int, act_dim: int, d_model: int = 128,
        num_heads: int = 4, num_layers: int = 2, max_len: int = 512,
        hidden: int = 256,
        attention_fn: AttentionFn = default_attention,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        gen = init_generator(generator)
        self.trunk = SequenceTrunk(
            obs_dim, d_model, num_heads, num_layers, max_len, attention_fn,
            dtype=dtype, generator=gen,
        )
        self.fc = Dense(d_model + act_dim, hidden, dtype=dtype, generator=gen)
        self.out = Dense(hidden, 1, dtype=dtype, generator=gen)

    def forward(self, obs_seq: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        unbatched, obs_seq = _auto_batch(obs_seq)
        if unbatched:
            action = action[None]
        h = self.trunk(obs_seq)[:, -1]
        x = torch.cat([h, action.to(h.dtype)], dim=-1)
        q = self.out(F.relu(self.fc(x))).float().squeeze(-1)
        return q.squeeze(0) if unbatched else q


def _members(num_qs: int | t.Sequence[int]) -> t.Tuple[int, ...]:
    return (num_qs,) if isinstance(num_qs, int) else tuple(num_qs)


class StackedLayerNorm(nn.Module):
    """``num_qs`` Flax LayerNorms (eps 1e-6, f32 statistics and output)
    over a ``(*members, ..., d)`` input; ``weight``/``bias`` are
    ``(*members, d)`` (``num_qs`` an int or a tuple of member axes)."""

    def __init__(self, num_qs: int | t.Sequence[int], d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(*_members(num_qs), d))
        self.bias = nn.Parameter(torch.zeros(*_members(num_qs), d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = self.weight.shape[:-1]
        shape = (*lead,) + (1,) * (x.dim() - len(lead) - 1) + (x.shape[-1],)
        y = F.layer_norm(x.float(), x.shape[-1:], eps=FLAX_LN_EPS)
        return torch.addcmul(self.bias.view(shape), y, self.weight.view(shape))


class StackedMultiHeadAttention(nn.Module):
    """:class:`MultiHeadAttention` over ``num_qs`` members: ``(*members,
    B, T, D)`` in and out, projections :class:`StackedDense`, and ONE
    ``attention_fn`` call on ``(Q·B, H, T, d)`` (a population's ``(P·Q·B,
    H, T, d)``)."""

    def __init__(
        self, num_qs: int | t.Sequence[int], d_model: int, num_heads: int,
        attention_fn: AttentionFn = default_attention,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} % num_heads {num_heads} != 0")
        self.num_heads = num_heads
        self.attention_fn = attention_fn
        self.q, self.k, self.v, self.o = (
            StackedDense(num_qs, d_model, d_model, dtype=dtype) for _ in range(4)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, d_model = x.shape[-2:]
        hd = d_model // self.num_heads

        def split(y):  # (..., B, T, D) -> (Q·B, H, T, d), a view
            return y.reshape(-1, s, self.num_heads, hd).transpose(1, 2)

        out = self.attention_fn(
            split(self.q(x)), split(self.k(x)), split(self.v(x)), causal=True
        )
        return self.o(out.transpose(1, 2).reshape(x.shape))


class StackedTransformerBlock(nn.Module):
    """:class:`TransformerBlock` over ``num_qs`` members."""

    def __init__(
        self, num_qs: int | t.Sequence[int], d_model: int, num_heads: int, mlp_ratio: int = 4,
        attention_fn: AttentionFn = default_attention,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.ln1 = StackedLayerNorm(num_qs, d_model)
        self.attn = StackedMultiHeadAttention(num_qs, d_model, num_heads, attention_fn, dtype)
        self.ln2 = StackedLayerNorm(num_qs, d_model)
        self.fc1 = StackedDense(num_qs, d_model, mlp_ratio * d_model, dtype=dtype)
        self.fc2 = StackedDense(num_qs, mlp_ratio * d_model, d_model, dtype=dtype)

    forward = TransformerBlock.forward


class StackedSequenceTrunk(nn.Module):
    """:class:`SequenceTrunk` over ``num_qs`` members (an int or a tuple
    of member axes): a shared ``(B, T, obs_dim)`` history or a stacked
    ``(*members, B, T, obs_dim)`` one in, ``(*members, B, T, d_model)``
    out; ``pos_embedding`` is ``(*members, max_len, d_model)``."""

    def __init__(
        self, num_qs: int | t.Sequence[int], obs_dim: int, d_model: int = 128, num_heads: int = 4,
        num_layers: int = 2, max_len: int = 512,
        attention_fn: AttentionFn = default_attention,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.max_len = max_len
        self.dtype = dtype
        self.embed = StackedDense(num_qs, obs_dim, d_model, dtype=dtype)
        self.pos_embedding = nn.Parameter(torch.empty(*_members(num_qs), max_len, d_model))
        self.blocks = nn.ModuleList(
            StackedTransformerBlock(
                num_qs, d_model, num_heads, attention_fn=attention_fn, dtype=dtype,
            )
            for _ in range(num_layers)
        )
        self.ln_f = StackedLayerNorm(num_qs, d_model)

    def forward(self, obs_seq: torch.Tensor, pos_offset: int = 0) -> torch.Tensor:
        b, s, obs_dim = obs_seq.shape[-3:]
        if pos_offset + s > self.max_len:
            raise ValueError(
                f"history length {s} (offset {pos_offset}) exceeds "
                f"max_len={self.max_len}"
            )
        if obs_seq.dim() == 3:  # shared by every member
            x = self.embed(obs_seq.reshape(b * s, obs_dim)).unflatten(-2, (b, s))
        else:
            x = self.embed(obs_seq)
        pos = self.pos_embedding[..., pos_offset:pos_offset + s, :].unsqueeze(-3)
        # Added in f32, then cast, as SequenceTrunk does.
        x = (x + pos).to(self.dtype)
        for block in self.blocks:
            x = block(x)
        return self.ln_f(x)


class SequenceDoubleCritic(nn.Module):
    """``num_qs`` :class:`SequenceCritic` s, parameters stacked on a
    leading axis; returns ``(num_qs, B)`` (``(num_qs,)`` for one
    unbatched history). History and action are shared by every member."""

    def __init__(
        self, obs_dim: int, act_dim: int, d_model: int = 128,
        num_heads: int = 4, num_layers: int = 2, max_len: int = 512,
        hidden: int = 256, num_qs: int = 2,
        attention_fn: AttentionFn = default_attention,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        gen = init_generator(generator)
        self.num_qs = num_qs
        self.trunk = StackedSequenceTrunk(
            num_qs, obs_dim, d_model, num_heads, num_layers, max_len, attention_fn,
            dtype=dtype,
        )
        self.fc = StackedDense(num_qs, d_model + act_dim, hidden, dtype=dtype)
        self.out = StackedDense(num_qs, hidden, 1, dtype=dtype)
        stack_members_(self, [
            SequenceCritic(
                obs_dim, act_dim, d_model, num_heads, num_layers, max_len,
                hidden, attention_fn, dtype, gen,
            )
            for _ in range(num_qs)
        ])

    def forward(self, obs_seq: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        unbatched, obs_seq = _auto_batch(obs_seq)
        if unbatched:
            action = action[None]
        h = self.trunk(obs_seq)[:, :, -1]  # (Q, B, d_model)
        a = action.to(h.dtype).expand(self.num_qs, *action.shape)
        x = torch.cat([h, a], dim=-1)
        q = self.out(F.relu(self.fc(x))).float().squeeze(-1)
        return q.squeeze(1) if unbatched else q
