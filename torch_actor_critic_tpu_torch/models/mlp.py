"""MLP trunk (port of ``models/mlp.py``).

``Dense`` is ``nn.Linear`` with torch's default init distribution —
``U(±1/sqrt(fan_in))`` for weight and bias, which the JAX package
copies — drawn from an explicit ``torch.Generator``, never the global
RNG. Parameters are stored float32 whatever the compute dtype; the
matmul runs in ``dtype``, as Flax's ``nn.Dense(dtype=...,
param_dtype=float32)`` does.

Every module of the port takes ``generator=``; ``None`` means a fresh
generator seeded 0 (:func:`init_generator`), so a build is reproducible
and leaves the global RNG untouched.

``StackedDense`` and ``StackedMLP`` are ``num_qs`` of them with one
leading parameter axis, as the JAX package's ``nn.vmap`` over a critic
stacks them (``variable_axes={"params": 0}``). They draw nothing
themselves: an ensemble builds its members one after another from its
generator and copies them in with :func:`stack_members_`, so a seeded
ensemble holds exactly the members a list of single modules would.
"""

from __future__ import annotations

import math
import typing as t

import torch
import torch.nn.functional as F
from torch import nn


def init_generator(generator: torch.Generator | None) -> torch.Generator:
    """``generator``, or a fresh CPU generator seeded 0 when None."""
    return generator if generator is not None else torch.Generator().manual_seed(0)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` over float32 parameters.

    Flax Dense kernels are ``(in, out)`` under the inner names
    ``col``/``row``/``Dense_0``; ``nn.Linear.weight`` is ``(out, in)``
    (``weights.py`` transposes when bridging).
    """

    def __init__(
        self, in_features: int, out_features: int,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        # nn.Linear initialises from the global RNG; on the meta device
        # it draws nothing, and the real init below uses `generator`.
        super().__init__(in_features, out_features, device="meta")
        self.to_empty(device="cpu")
        gen = init_generator(generator)
        bound = 1.0 / math.sqrt(in_features)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=gen)
            self.bias.uniform_(-bound, bound, generator=gen)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class MLP(nn.Module):
    """Plain ReLU MLP; ReLU after every layer when ``activate_final``
    (the actor trunk), else after all but the last."""

    def __init__(
        self,
        in_features: int,
        hidden_sizes: t.Sequence[int],
        activate_final: bool = True,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        gen = init_generator(generator)
        widths = [in_features, *hidden_sizes]
        self.layers = nn.ModuleList(
            Dense(a, b, dtype=dtype, generator=gen)
            for a, b in zip(widths[:-1], widths[1:])
        )
        self.activate_final = activate_final

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if self.activate_final or i < n - 1:
                x = F.relu(x)
        return x


class StackedDense(nn.Module):
    """``num_qs`` :class:`Dense` layers in one: ``weight (Q, out, in)``,
    ``bias (Q, out)``, float32, the products in ``dtype``. ``num_qs``
    may be a tuple of member axes, as a population's critic ensemble
    ``(P, Q)`` is: ``weight (P, Q, out, in)``, one batched product over
    all ``P·Q`` members.

    ``forward`` takes a stacked ``(*members, ..., in)`` input (member
    ``i``'s rows through member ``i``'s weights, one batched product) or
    one shared ``(N, in)`` input that every member reads (``in_axes=None``
    under ``vmap``: one product against all members' weights at once);
    either returns ``(*members, ..., out)``. Uninitialised until
    :func:`stack_members_` fills it.
    """

    def __init__(
        self, num_qs: int | t.Sequence[int], in_features: int, out_features: int,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        members = (num_qs,) if isinstance(num_qs, int) else tuple(num_qs)
        self.weight = nn.Parameter(torch.empty(*members, out_features, in_features))
        self.bias = nn.Parameter(torch.empty(*members, out_features))
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        *lead, n_out, n_in = self.weight.shape
        q = math.prod(lead)
        w = self.weight.to(dt).reshape(q, n_out, n_in)
        b = self.bias.to(dt).reshape(q, n_out)
        if x.dim() == 2:  # shared: (N, in) @ (in, Q*out), viewed as (Q, N, out)
            y = F.linear(x.to(dt), w.reshape(q * n_out, n_in), b.reshape(q * n_out))
            return y.unflatten(-1, (q, n_out)).transpose(0, 1).reshape(*lead, -1, n_out)
        if list(x.shape[:len(lead)]) != lead:
            raise ValueError(f"stacked input {tuple(x.shape)} has no leading axis (or axes) {tuple(lead)}")
        y = torch.baddbmm(b.unsqueeze(1), x.to(dt).reshape(q, -1, n_in), w.transpose(1, 2))
        return y.reshape(*x.shape[:-1], n_out)


class StackedMLP(nn.Module):
    """:class:`MLP` over ``num_qs`` members (an int or a tuple of member
    axes): ``layers`` are :class:`StackedDense`; the first takes a
    shared ``(N, in)`` input or a stacked one, the output is ``(Q, N,
    out)``."""

    def __init__(
        self,
        num_qs: int | t.Sequence[int],
        in_features: int,
        hidden_sizes: t.Sequence[int],
        activate_final: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        widths = [in_features, *hidden_sizes]
        self.layers = nn.ModuleList(
            StackedDense(num_qs, a, b, dtype=dtype)
            for a, b in zip(widths[:-1], widths[1:])
        )
        self.activate_final = activate_final

    forward = MLP.forward


def stack_members_(stacked: nn.Module, members: t.Sequence[nn.Module]) -> None:
    """Copy each member's parameters into slice ``i`` of ``stacked``'s
    parameter of the same name. Every name must match both ways. A
    member may itself be stacked (a population stacks whole critic
    ensembles)."""
    named = [dict(m.named_parameters()) for m in members]
    params = dict(stacked.named_parameters())
    for i, member in enumerate(named):
        if member.keys() != params.keys():
            raise ValueError(
                f"member {i} has parameters {sorted(member.keys() ^ params.keys())} "
                "that the stacked module does not, or the reverse"
            )
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.stack([member[name] for member in named]))
