"""Tiered experience store: device ring ↔ host RAM ↔ disk (port of the
JAX package's ``replay/``).

The device ring (:mod:`torch_actor_critic_tpu_torch.buffer.replay`)
stays tier 0, untouched; this package adds the host-side hierarchy
underneath it — a host-RAM ring shadowing the device ring's eviction
stream (:class:`~.tiers.HostRing`), an append-only chunked disk tier
(:class:`~.diskstore.DiskTier`, the JAX package's on-disk format),
counted spill/refill flows with a per-tier conservation invariant
(:class:`~.tiers.TieredReplay`), the host → device refill through
pinned staging slots (:class:`~.prefetch.RefillPrefetcher`), a
serve-side transition logger in the same chunk format
(:class:`~.flywheel.TransitionLogger`), and ``train --offline``
(:mod:`~.offline`), regularized SAC from a disk tier alone. All of it is
off by default: with ``replay_tiers="off"`` the trainer builds none of
it.
"""

from __future__ import annotations

import os
import typing as t

from torch_actor_critic_tpu_torch.replay.diskstore import (
    DISK_EVICTION_POLICIES,
    DiskTier,
    batch_to_rows,
    concat_rows,
    obs_spec_from_json,
    obs_spec_to_json,
    rows_count,
    rows_nbytes,
    rows_to_batch,
    slice_rows,
)
from torch_actor_critic_tpu_torch.replay.flywheel import TransitionLogger
from torch_actor_critic_tpu_torch.replay.offline import (
    OFFLINE_REGULARIZERS,
    OfflineLearner,
    train_offline,
)
from torch_actor_critic_tpu_torch.replay.prefetch import RefillPrefetcher
from torch_actor_critic_tpu_torch.replay.tiers import (
    REPLAY_PRIORITIES,
    HostRing,
    StripedHostRing,
    TieredReplay,
)

__all__ = [
    "DISK_EVICTION_POLICIES",
    "DiskTier",
    "HostRing",
    "OFFLINE_REGULARIZERS",
    "OfflineLearner",
    "REPLAY_PRIORITIES",
    "RefillPrefetcher",
    "StripedHostRing",
    "TieredReplay",
    "TransitionLogger",
    "batch_to_rows",
    "build_tiered_replay",
    "concat_rows",
    "obs_spec_from_json",
    "obs_spec_to_json",
    "rows_count",
    "rows_nbytes",
    "rows_to_batch",
    "slice_rows",
    "train_offline",
]


def build_tiered_replay(
    config,
    obs_spec: t.Any,
    act_dim: int,
    hbm_capacity: int,
    act_limit: float = 1.0,
    run_dir: str | None = None,
    seed: int = 0,
    n_stripes: int = 0,
) -> TieredReplay:
    """Construct the tier stack the config asks for.

    ``replay_tiers="host"`` builds the device ring's shadow and the host
    tier only (spill past the host ring is counted
    ``dropped_nodisk_total``); ``"disk"`` adds the chunked disk tier at
    ``replay_dir`` (default: ``<run_dir>/replay``) and stamps its meta so
    ``--offline`` can later rebuild the models from the directory alone.
    ``hbm_capacity`` is the device ring's real capacity. ``n_stripes >
    0`` gives the host tier per-task sub-rings so refill stays
    task-balanced. Callers gate on ``config.replay_tiers != "off"``.
    """
    disk = None
    if config.replay_tiers == "disk":
        directory = config.replay_dir
        if not directory:
            if not run_dir:
                raise ValueError(
                    "replay_tiers='disk' needs --replay-dir (no tracker "
                    "run dir to default under)"
                )
            directory = os.path.join(run_dir, "replay")
        disk = DiskTier(
            directory,
            max_bytes=config.replay_disk_bytes,
            policy=config.replay_disk_policy,
        )
        disk.ensure_meta({
            "obs": obs_spec_to_json(obs_spec),
            "act_dim": int(act_dim),
            "act_limit": float(act_limit),
            "source": "trainer",
        })
    host_capacity = config.replay_host_capacity or config.buffer_size
    return TieredReplay(
        hbm_capacity=hbm_capacity,
        host_capacity=host_capacity,
        disk=disk,
        priority=config.replay_priority,
        seed=seed,
        n_stripes=n_stripes,
    )
