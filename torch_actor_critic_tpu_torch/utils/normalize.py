"""Online observation normalization (Welford) — port of the JAX
package's ``utils/normalize.py``: :class:`WelfordNormalizer`,
:class:`FeaturesNormalizer`, :class:`PerMemberNormalizer` and
:class:`IdentityNormalizer`, with the
same numpy arithmetic, so their statistics and outputs equal the JAX
package's exactly.

Host-side numpy (it runs in the env loop on single observations);
state is a plain JSON-able dict so it checkpoints with the rest of the
run (``meta.json``'s ``normalizer``). The port trains in one process,
so ``sync_global`` has nothing to merge.
"""

from __future__ import annotations

import typing as t

import numpy as np

from torch_actor_critic_tpu_torch.core.types import MultiObservation

__all__ = ["WelfordNormalizer", "FeaturesNormalizer", "PerMemberNormalizer",
           "IdentityNormalizer"]


class WelfordNormalizer:
    """y = (x - mean) / sqrt(var + eps), statistics updated online."""

    def __init__(self, dim: int, eps: float = 1e-8):
        self.mean = np.zeros(dim, np.float64)
        self.m2 = np.zeros(dim, np.float64)
        self.count = 0
        self.eps = eps

    def normalize(self, x: np.ndarray, update: bool = True) -> np.ndarray:
        """Accepts one observation ``(dim,)`` or a batch ``(n, dim)``.
        The batched update is Chan's parallel merge, which reduces
        exactly to Welford's single-sample recurrence at n=1."""
        x = np.asarray(x, np.float64)
        if update:
            xb = x if x.ndim == 2 else x[None]
            n = xb.shape[0]
            b_mean = xb.mean(axis=0)
            b_m2 = ((xb - b_mean) ** 2).sum(axis=0)
            delta = b_mean - self.mean
            total = self.count + n
            self.mean = self.mean + delta * n / total
            self.m2 = self.m2 + b_m2 + delta**2 * self.count * n / total
            self.count = total
        var = self.m2 / max(self.count, 1)
        return ((x - self.mean) / np.sqrt(var + self.eps)).astype(np.float32)

    def sync_global(self) -> None:
        """One process: every sample is already in the local estimate."""

    def state_dict(self) -> dict:
        return {"mean": self.mean.tolist(), "m2": self.m2.tolist(), "count": self.count}

    def load_state_dict(self, d: t.Mapping) -> None:
        self.mean = np.asarray(d["mean"], np.float64)
        self.m2 = np.asarray(d["m2"], np.float64)
        self.count = int(d["count"])


class FeaturesNormalizer:
    """Welford normalization of the ``features`` leaf of a
    :class:`~..core.types.MultiObservation`; frames pass through
    untouched (they have their own whitening path, ``normalize_pixels``
    and DrQ, and keep their uint8 ring layout)."""

    def __init__(self, feature_dim: int, eps: float = 1e-8):
        self.inner = WelfordNormalizer(feature_dim, eps)

    def normalize(self, obs: MultiObservation, update: bool = True) -> MultiObservation:
        return MultiObservation(
            features=self.inner.normalize(obs.features, update=update), frame=obs.frame
        )

    def sync_global(self) -> None:
        self.inner.sync_global()

    def state_dict(self) -> dict:
        return {"features": self.inner.state_dict()}

    def load_state_dict(self, d: t.Mapping) -> None:
        self.inner.load_state_dict(d["features"])


class PerMemberNormalizer:
    """One independent Welford estimate per population member (a host-loop
    population's flat observations): pooling one estimate would couple
    the members through their input scaling. A lockstep ``(P, dim)``
    batch is ``P`` single-sample updates, one per member's own estimate,
    in one numpy op; ``member=i`` normalizes one ``(dim,)`` observation
    with (and optionally into) member ``i``'s statistics, the reset and
    evaluation path."""

    def __init__(self, n_members: int, dim: int, eps: float = 1e-8):
        if n_members < 1:
            raise ValueError(f"n_members must be >= 1, got {n_members}")
        self.n_members = n_members
        self.mean = np.zeros((n_members, dim), np.float64)
        self.m2 = np.zeros((n_members, dim), np.float64)
        self.count = np.zeros(n_members, np.int64)
        self.eps = eps

    def _apply(self, x, idx):
        var = self.m2[idx] / np.maximum(self.count[idx, None], 1)
        return ((x - self.mean[idx]) / np.sqrt(var + self.eps)).astype(np.float32)

    def normalize(self, x: np.ndarray, update: bool = True,
                  member: int | None = None) -> np.ndarray:
        x = np.asarray(x, np.float64)
        if member is not None:
            idx = np.array([member])
            xb = x[None]
        else:
            if x.ndim != 2 or x.shape[0] != self.n_members:
                raise ValueError(
                    f"expected a ({self.n_members}, dim) member-aligned batch or member=i "
                    f"with one observation; got shape {x.shape}")
            idx = np.arange(self.n_members)
            xb = x
        if update:
            # Welford's single-sample recurrence, one row per selected member.
            self.count[idx] += 1
            delta = xb - self.mean[idx]
            self.mean[idx] += delta / self.count[idx, None]
            self.m2[idx] += delta * (xb - self.mean[idx])
        out = self._apply(xb, idx)
        return out[0] if member is not None else out

    def sync_global(self) -> None:
        """One process: nothing to merge."""

    def state_dict(self) -> dict:
        return {"mean": self.mean.tolist(), "m2": self.m2.tolist(),
                "count": self.count.tolist()}

    def load_state_dict(self, d: t.Mapping) -> None:
        self.mean = np.asarray(d["mean"], np.float64)
        self.m2 = np.asarray(d["m2"], np.float64)
        self.count = np.asarray(d["count"], np.int64)


class IdentityNormalizer:
    """Pass-through."""

    def normalize(self, x, update: bool = True, member: int | None = None):
        return x

    def sync_global(self) -> None:
        pass

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, d: t.Mapping) -> None:
        pass
