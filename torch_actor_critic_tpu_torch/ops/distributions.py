"""Squashed-Gaussian primitives (port of ``ops/distributions.py``).

Same math as the JAX package: log-std clipped to ``[-20, 2]``,
reparameterized ``u = mu + sigma * eps``, ``a = tanh(u) * act_limit``,
and the softplus-form tanh correction WITHOUT the ``act_limit`` term
(the reference's and spinningup's convention, kept for parity).

The noise comes from an explicit ``torch.Generator`` or an explicit
``eps`` tensor — never the global RNG — so tests can inject the very
normals JAX drew.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LOG_STD_MIN = -20.0
LOG_STD_MAX = 2.0

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def gaussian_log_prob(
    u: torch.Tensor, mu: torch.Tensor, log_std: torch.Tensor
) -> torch.Tensor:
    """Diagonal-Gaussian log-density, summed over the trailing axis."""
    z = (u - mu) / torch.exp(log_std)
    return torch.sum(-0.5 * z * z - log_std - _LOG_SQRT_2PI, dim=-1)


def tanh_log_prob_correction(u: torch.Tensor) -> torch.Tensor:
    """``sum(2 * (log 2 - u - softplus(-2u)))`` over the trailing axis —
    the stable form of ``sum(log(1 - tanh(u)^2))``."""
    return torch.sum(2.0 * (math.log(2.0) - u - F.softplus(-2.0 * u)), dim=-1)


def squashed_gaussian_sample(
    mu: torch.Tensor,
    log_std: torch.Tensor,
    act_limit: float,
    deterministic: bool = False,
    with_logprob: bool = True,
    generator: torch.Generator | None = None,
    eps: torch.Tensor | None = None,
):
    """``(action, log_prob)`` of a tanh-squashed Gaussian; ``log_prob``
    is ``None`` without ``with_logprob``. A sampled call needs exactly
    one noise source: ``generator`` (drawn on ``mu``'s device) or a
    standard-normal ``eps`` of ``mu``'s shape."""
    log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
    if deterministic:
        u = mu
    else:
        if (generator is None) == (eps is None):
            raise ValueError(
                "squashed_gaussian_sample: a sampled action needs exactly "
                "one of `generator` or `eps` (deterministic=False)"
            )
        if eps is None:
            eps = torch.randn(
                mu.shape, generator=generator, device=mu.device, dtype=mu.dtype
            )
        u = mu + torch.exp(log_std) * eps.to(mu.dtype)
    action = torch.tanh(u) * act_limit
    logprob = None
    if with_logprob:
        logprob = gaussian_log_prob(u, mu, log_std) - tanh_log_prob_correction(u)
    return action, logprob
