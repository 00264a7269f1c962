"""The port's tiered replay store (``replay/``) against the JAX package's,
on the CPU.

Each case of the JAX package's ``tests/test_replay.py`` for the tiers,
the disk tier, striping and the prefetcher runs here on the port, with
that test's assertions; the same pushes then go through the JAX objects
too, and the counters, the host samples and the refill chunks must agree
bitwise (the host side is numpy on ``default_rng(seed)`` in both). A
disk directory written by either package reads in the other, in the
``flat`` and ``multi`` (uint8 frame) kinds. At the trainer: tiers off
adds no ``replay/`` column; archival tiers (``replay_refill=0``) train
bitwise as tiers off; a synchronous refill recirculates with every flow
counted, also across a checkpoint restart; a population and the
on-device loop refuse the tiers, as in JAX.
"""

import json
import time

import numpy as np
import pytest
import torch

from torch_actor_critic_tpu import replay as jreplay
from torch_actor_critic_tpu.buffer import striped as jstriped
from torch_actor_critic_tpu.core.types import Batch as JBatch
from torch_actor_critic_tpu.core.types import MultiObservation as JMulti
from torch_actor_critic_tpu_torch import replay
from torch_actor_critic_tpu_torch.buffer import striped
from torch_actor_critic_tpu_torch.buffer.replay import init_replay_buffer, push
from torch_actor_critic_tpu_torch.core.types import Batch, MultiObservation
from torch_actor_critic_tpu_torch.envs.wrappers import ObsSpec
from torch_actor_critic_tpu_torch.replay import (
    DiskTier,
    HostRing,
    RefillPrefetcher,
    StripedHostRing,
    TieredReplay,
    batch_to_rows,
    rows_count,
    rows_to_batch,
)
from torch_actor_critic_tpu_torch.replay.diskstore import concat_rows
from torch_actor_critic_tpu_torch.sac.trainer import Trainer
from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer
from torch_actor_critic_tpu_torch.utils.config import SACConfig
from torch_actor_critic_tpu_torch.utils.tracking import Tracker

OBS_DIM = 3
ACT_DIM = 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny ops: one intra-op thread avoids the oversubscription of
    several test workers each spinning a full thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_rows(n, start=0, obs_dim=OBS_DIM):
    """Full Batch-format rows; states[:, 0] carries the row id so
    eviction order is checkable by value."""
    ids = np.arange(start, start + n, dtype=np.float32)
    states = np.zeros((n, obs_dim), np.float32)
    states[:, 0] = ids
    return {
        "states": states,
        "actions": ids.reshape(n, 1) * 0.1,
        "rewards": -ids,
        "next_states": states + 1.0,
        "done": np.zeros(n, np.float32),
    }


def row_ids(rows):
    return np.asarray(rows["states"])[:, 0].astype(int).tolist()


def same_rows(a, b):
    """Two row dicts (or None) bitwise equal, key by key."""
    if a is None or b is None:
        return a is None and b is None
    return a.keys() == b.keys() and all(
        np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        and np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def tiers_state(t):
    """Everything a TieredReplay reports: snapshot, metrics, meta."""
    return t.snapshot(), t.metrics(), t.meta_state()


def both(fn):
    """``fn(module)`` on the port's replay package and on the JAX one."""
    return fn(replay), fn(jreplay)


# ---------------------------------------------------------------- HostRing


def test_host_ring_eviction_is_oldest_first():
    def run(m):
        ring = m.HostRing(4)
        assert ring.push(make_rows(3)) is None  # 0,1,2 — fits
        evicted = ring.push(make_rows(3, start=3))  # 3,4,5 -> evicts 0,1
        return ring, evicted

    (ring, evicted), (jring, jevicted) = both(run)
    assert row_ids(evicted) == [0, 1]
    assert ring.size == 4 and ring.received_total == 6
    assert ring.evicted_total == 2
    assert ring.conservation_holds()
    assert same_rows(evicted, jevicted) and ring.snapshot() == jring.snapshot()


def test_host_ring_whole_ring_wrap():
    """A chunk >= capacity replaces everything: evicted is every resident
    row plus the chunk's own overwritten head, oldest first."""
    def run(m):
        ring = m.HostRing(4)
        ring.push(make_rows(4))
        evicted = ring.push(make_rows(6, start=4))
        return ring, evicted, ring.sample(np.random.default_rng(0), 32)

    (ring, evicted, kept), (jring, jevicted, jkept) = both(run)
    assert row_ids(evicted) == [0, 1, 2, 3, 4, 5]
    assert ring.size == 4 and ring.evicted_total == 6
    assert ring.conservation_holds()
    assert set(row_ids(kept)) <= {6, 7, 8, 9}
    assert same_rows(evicted, jevicted) and same_rows(kept, jkept)


def test_host_ring_recent_priority_samples_newest_half():
    def run(m):
        ring = m.HostRing(8)
        ring.push(make_rows(8))
        return (ring.sample(np.random.default_rng(0), 64, priority="recent"),
                ring.sample(np.random.default_rng(0), 256, priority="uniform"))

    (recent, uniform), (jrecent, juniform) = both(run)
    assert set(row_ids(recent)) <= {4, 5, 6, 7}
    assert set(row_ids(uniform)) == set(range(8))
    assert same_rows(recent, jrecent) and same_rows(uniform, juniform)
    ring = HostRing(2)
    ring.push(make_rows(1))
    with pytest.raises(ValueError, match="priority"):
        ring.sample(np.random.default_rng(0), 1, priority="newest")


def test_host_ring_restart_counters_conserve():
    def run(m):
        ring = m.HostRing(4)
        ring.push(make_rows(6))
        fresh = m.HostRing(4)
        fresh.restore_counters(ring.snapshot())
        return fresh

    fresh, jfresh = both(run)
    assert fresh.size == 0
    assert fresh.dropped_restart_total == 4
    assert fresh.received_total == 6 and fresh.evicted_total == 2
    assert fresh.conservation_holds()
    assert fresh.snapshot() == jfresh.snapshot()


# ---------------------------------------------------------- striped host


def striped_rows(n, task, n_stripes, start=0):
    """Rows whose flat observation ends in the task one-hot."""
    rows = make_rows(n, start=start, obs_dim=OBS_DIM + n_stripes)
    rows["states"][:, OBS_DIM:] = 0.0
    rows["states"][:, OBS_DIM + task] = 1.0
    rows["next_states"] = rows["states"].copy()
    return rows


def sampled_tasks(rows, n_stripes):
    return np.argmax(np.asarray(rows["states"])[:, OBS_DIM:], axis=-1)


def test_rows_task_ids_and_routing():
    rows = concat_rows([
        striped_rows(4, task=0, n_stripes=3),
        striped_rows(2, task=2, n_stripes=3, start=4),
    ])
    assert striped.rows_task_ids(rows, 3).tolist() == [0, 0, 0, 0, 2, 2]
    np.testing.assert_array_equal(striped.rows_task_ids(rows, 3),
                                  jstriped.rows_task_ids(rows, 3))
    parts = striped.route_rows_to_stripes(rows, 3)
    assert rows_count(parts[0]) == 4
    assert parts[1] is None  # empty stripe: no zero-row dict
    assert rows_count(parts[2]) == 2
    assert row_ids(parts[2]) == [4, 5]
    for p, j in zip(parts, jstriped.route_rows_to_stripes(rows, 3)):
        assert same_rows(p, j)
    # A history of flat observations: the newest step's one-hot.
    hist = {"states": np.repeat(rows["states"][:, None], 4, axis=1)}
    np.testing.assert_array_equal(striped.rows_task_ids(hist, 3),
                                  jstriped.rows_task_ids(hist, 3))


def test_striped_host_ring_balance_after_one_stripe_floods():
    """One task spilling far more than the others must not dominate
    refill: the balanced draw gives every live stripe an equal quota."""
    def run(m):
        ring = m.StripedHostRing(30, n_stripes=3)
        ring.push(striped_rows(40, task=0, n_stripes=3))
        ring.push(striped_rows(6, task=1, n_stripes=3, start=40))
        ring.push(striped_rows(6, task=2, n_stripes=3, start=46))
        return ring, ring.sample(np.random.default_rng(0), 12)

    (ring, got), (jring, jgot) = both(run)
    assert ring.conservation_holds()
    assert ring.evicted_total == 30
    assert np.bincount(sampled_tasks(got, 3), minlength=3).tolist() == [4, 4, 4]
    assert same_rows(got, jgot) and ring.snapshot() == jring.snapshot()


def test_striped_host_ring_empty_stripe_share_is_spread():
    def run(m):
        ring = m.StripedHostRing(30, n_stripes=3)
        ring.push(striped_rows(8, task=0, n_stripes=3))
        ring.push(striped_rows(8, task=2, n_stripes=3, start=8))
        return ring.sample(np.random.default_rng(0), 10)

    got, jgot = both(run)
    counts = np.bincount(sampled_tasks(got, 3), minlength=3)
    assert counts[1] == 0 and counts[0] + counts[2] == 10
    assert abs(int(counts[0]) - int(counts[2])) <= 1
    assert same_rows(got, jgot)
    with pytest.raises(ValueError, match="2 stripes"):
        StripedHostRing(30, n_stripes=1)


def test_striped_snapshot_restores_per_stripe():
    ring = StripedHostRing(30, n_stripes=3)
    ring.push(striped_rows(7, task=1, n_stripes=3))
    snap = ring.snapshot()
    jring = jreplay.StripedHostRing(30, n_stripes=3)
    jring.push(striped_rows(7, task=1, n_stripes=3))
    assert snap == jring.snapshot()
    fresh = StripedHostRing(30, n_stripes=3)
    fresh.restore_counters(snap)
    assert fresh.stripes[1].received_total == 7
    assert fresh.stripes[1].dropped_restart_total == 7
    assert fresh.conservation_holds()
    # Stripe-count mismatch: the aggregate lands on stripe 0, sums conserve.
    other = StripedHostRing(30, n_stripes=2)
    other.restore_counters(snap)
    assert other.received_total == 7
    assert other.conservation_holds()


# ----------------------------------------------------------- the waterfall


def test_waterfall_host_only_counts_dropped():
    def run(m):
        tiered = m.TieredReplay(hbm_capacity=8, host_capacity=16, disk=None)
        for i in range(5):
            tiered.ingest_rows(make_rows(8, start=8 * i))
        return tiered

    tiered, jtiered = both(run)
    assert tiered.pushed_total == 40
    assert tiered.shadow.evicted_total == 32
    assert tiered.host.received_total == 32
    assert tiered.host.evicted_total == 16
    assert tiered.dropped_nodisk_total == 16
    assert tiered.conservation_holds()
    m = tiered.metrics()
    assert m["replay/conservation_ok"] == 1.0
    assert m["replay/dropped_nodisk_total"] == 16.0
    assert "replay/disk_rows" not in m
    assert tiers_state(tiered) == tiers_state(jtiered)


def test_waterfall_spills_to_disk_and_refills(tmp_path):
    def run(m, root):
        disk = m.DiskTier(root)
        tiered = m.TieredReplay(hbm_capacity=8, host_capacity=16, disk=disk)
        for i in range(5):
            tiered.ingest_rows(make_rows(8, start=8 * i))
        before = tiered.metrics()
        received = disk.received_total
        rows = tiered.sample_refill(5)
        tiered.note_refill(rows)
        return tiered, received, before, rows

    tiered, received, m, rows = run(replay, tmp_path / "port")
    jtiered, _, jm, jrows = run(jreplay, tmp_path / "jax")
    assert received == 16  # host overflow landed on disk
    assert tiered.dropped_nodisk_total == 0
    assert m["replay/spilled_disk_total"] == 16.0
    assert rows_count(rows) == 5
    assert tiered.refill_total == 5
    assert tiered.shadow.received_total == 45
    assert tiered.conservation_holds()
    assert same_rows(rows, jrows)
    # Byte counts differ by path length in the npz's zip headers only
    # when the names differ; the counters must not.
    strip = ("replay/disk_bytes",)
    assert ({k: v for k, v in m.items() if k not in strip}
            == {k: v for k, v in jm.items() if k not in strip})
    assert tiered.snapshot()["hbm"] == jtiered.snapshot()["hbm"]
    assert tiered.snapshot()["host"] == jtiered.snapshot()["host"]
    tiered.close()
    jtiered.close()


def test_waterfall_long_run_is_bitwise_jax():
    """Random pushes and refills of random sizes through both waterfalls:
    every counter, every refill chunk and every host sample agree."""
    rng = np.random.default_rng(7)
    ops, start = [], 0
    for _ in range(60):
        n = int(rng.integers(1, 13))
        ops.append(("ingest", start, n))
        start += n
        if rng.uniform() < 0.5:
            ops.append(("refill", None, int(rng.integers(1, 6))))

    def run(m, priority):
        tiered = m.TieredReplay(hbm_capacity=11, host_capacity=17, priority=priority, seed=3)
        out = []
        for op, s, n in ops:
            if op == "ingest":
                tiered.ingest_rows(make_rows(n, start=s))
            else:
                rows = tiered.sample_refill(n)
                if rows is not None:
                    tiered.note_refill(rows)
                out.append(rows)
        return tiered, out

    for priority in ("uniform", "recent"):
        (t, out), (jt, jout) = run(replay, priority), run(jreplay, priority)
        assert len(out) == len(jout) and all(same_rows(a, b) for a, b in zip(out, jout))
        assert tiers_state(t) == tiers_state(jt)
        assert t.conservation_holds()
        assert sum(r is not None for r in out) > 10


def test_waterfall_restart_conserves_across_checkpoint(tmp_path):
    disk = DiskTier(tmp_path / "tier")
    tiered = TieredReplay(hbm_capacity=8, host_capacity=16, disk=disk)
    for i in range(5):
        tiered.ingest_rows(make_rows(8, start=8 * i))
    meta = tiered.meta_state()
    tiered.close()
    # The checkpoint meta is JSON: the JAX package's load_meta takes it too.
    meta = json.loads(json.dumps(meta))

    resumed = TieredReplay(hbm_capacity=8, host_capacity=16, disk=DiskTier(tmp_path / "tier"))
    resumed.load_meta(meta)
    jresumed = jreplay.TieredReplay(hbm_capacity=8, host_capacity=16,
                                    disk=jreplay.DiskTier(tmp_path / "tier"))
    jresumed.load_meta(meta)
    assert resumed.host.dropped_restart_total == 16
    assert resumed.shadow.dropped_restart_total == 8
    assert resumed.pushed_total == 40
    assert resumed.conservation_holds()
    assert resumed.meta_state() == jresumed.meta_state()
    resumed.ingest_rows(make_rows(8, start=40))
    assert resumed.conservation_holds()
    resumed.close()
    jresumed.close()


def test_waterfall_striped_host_tier_balances_refill():
    def run(m):
        tiered = m.TieredReplay(hbm_capacity=6, host_capacity=30, n_stripes=3)
        for task in (0, 0, 0, 1, 2, 0):
            tiered.ingest_rows(striped_rows(6, task=task, n_stripes=3))
        return tiered, tiered.sample_refill(12)

    (tiered, got), (jtiered, jgot) = both(run)
    assert tiered.conservation_holds()
    assert np.bincount(sampled_tasks(got, 3), minlength=3).tolist() == [4, 4, 4]
    assert same_rows(got, jgot) and tiers_state(tiered) == tiers_state(jtiered)


# ---------------------------------------------------------------- DiskTier


def test_disk_tier_append_sample_read_all(tmp_path):
    tier = DiskTier(tmp_path / "t")
    tier.append(make_rows(10))
    tier.append(make_rows(10, start=10))
    assert tier.rows == 20 and tier.files == 2
    assert row_ids(tier.read_all()) == list(range(20))
    assert row_ids(tier.read_all(max_rows=5)) == [0, 1, 2, 3, 4]
    got = tier.sample(np.random.default_rng(0), 64)
    assert rows_count(got) == 64
    assert set(row_ids(got)) <= set(range(20))
    one = tier.sample(np.random.default_rng(1), 1)
    assert one["rewards"][0] == -float(row_ids(one)[0])
    assert tier.conservation_holds()
    # The JAX tier over the same directory draws the same rows.
    jtier = jreplay.DiskTier(tmp_path / "t")
    assert same_rows(got, jtier.sample(np.random.default_rng(0), 64))
    assert tier.snapshot() == jtier.snapshot()
    tier.close()
    jtier.close()


def test_disk_tier_fifo_eviction_keeps_one_chunk(tmp_path):
    tier = DiskTier(tmp_path / "t", max_bytes=1, policy="fifo")
    for i in range(3):
        tier.append(make_rows(10, start=10 * i))
    assert tier.files == 1
    assert tier.evicted_rows_total == 20 and tier.evicted_files_total == 2
    assert tier.received_total == 30
    assert tier.conservation_holds()
    assert row_ids(tier.read_all()) == list(range(20, 30))
    tier.close()


def test_disk_tier_stop_policy_counts_drops(tmp_path):
    tier = DiskTier(tmp_path / "t", max_bytes=1, policy="stop")
    assert tier.append(make_rows(10)) == 0
    assert tier.dropped_rows_total == 10
    assert tier.received_total == 0 and tier.rows == 0
    assert tier.conservation_holds()
    tier.close()
    with pytest.raises(ValueError, match="policy"):
        DiskTier(tmp_path / "u", policy="lru")


def test_disk_tier_reopen_reconstructs_counters(tmp_path):
    tier = DiskTier(tmp_path / "t", max_bytes=1, policy="fifo")
    for i in range(3):
        tier.append(make_rows(10, start=10 * i))
    tier.close()
    again = DiskTier(tmp_path / "t")
    assert again.received_total == 30
    assert again.evicted_rows_total == 20
    assert again.rows == 10
    assert again.conservation_holds()
    again.append(make_rows(10, start=30))
    assert row_ids(again.read_all()) == list(range(20, 40))
    again.close()
    # The JAX package's tier reconstructs the same counters from it.
    assert jreplay.DiskTier(tmp_path / "t").snapshot() == DiskTier(tmp_path / "t").snapshot()
    stopper = DiskTier(tmp_path / "s", max_bytes=1, policy="stop")
    stopper.append(make_rows(4))
    stopper.close()
    assert DiskTier(tmp_path / "s").dropped_rows_total == 4


def test_disk_tier_meta_mismatch_fails_loudly(tmp_path):
    tier = DiskTier(tmp_path / "t")
    tier.ensure_meta({"obs": {"kind": "flat"}, "act_dim": 1})
    with pytest.raises(ValueError, match="act_dim"):
        tier.ensure_meta({"obs": {"kind": "flat"}, "act_dim": 2})
    tier.close()
    # A JAX writer with another geometry fails on the port's meta too.
    with pytest.raises(ValueError, match="act_dim"):
        jreplay.DiskTier(tmp_path / "t").ensure_meta({"obs": {"kind": "flat"}, "act_dim": 3})


def test_batch_rows_round_trip_merges_leading_axes():
    n_envs, window = 2, 5
    shape = (n_envs, window)
    chunk = Batch(
        states=np.arange(n_envs * window * OBS_DIM, dtype=np.float32).reshape(shape + (OBS_DIM,)),
        actions=np.ones(shape + (ACT_DIM,), np.float32),
        rewards=np.arange(n_envs * window, dtype=np.float32).reshape(shape),
        next_states=np.zeros(shape + (OBS_DIM,), np.float32),
        done=np.zeros(shape, np.float32),
    )
    rows = batch_to_rows(chunk, n_lead=2)
    assert rows_count(rows) == n_envs * window
    back = rows_to_batch(rows)
    np.testing.assert_array_equal(back.states, chunk.states.reshape(-1, OBS_DIM))
    np.testing.assert_array_equal(back.rewards, chunk.rewards.reshape(-1))
    jchunk = JBatch(**{k: getattr(chunk, k) for k in
                       ("states", "actions", "rewards", "next_states", "done")})
    assert same_rows(rows, jreplay.batch_to_rows(jchunk, n_lead=2))


# --------------------------------------------- one on-disk format, both packages


def _multi_rows(n, start, frame=(8, 8, 3)):
    rng = np.random.default_rng(start)
    return {
        "states.features": rng.standard_normal((n, 5)).astype(np.float32),
        "states.frame": rng.integers(0, 256, (n, *frame), dtype=np.uint8),
        "actions": rng.uniform(-1, 1, (n, 2)).astype(np.float32),
        "rewards": rng.standard_normal(n).astype(np.float32),
        "next_states.features": rng.standard_normal((n, 5)).astype(np.float32),
        "next_states.frame": rng.integers(0, 256, (n, *frame), dtype=np.uint8),
        "done": (rng.uniform(size=n) < 0.2).astype(np.float32),
    }


@pytest.mark.parametrize("kind", ["flat", "multi"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_disk_directory_reads_in_the_other_package(tmp_path, kind, writer):
    """A directory written by one package (meta, manifest, npz chunks
    with dot-mangled keys) reads in the other: the same rows bitwise,
    the same counters, the same spec; the writers' files are byte-equal
    but for the npz archives' zip timestamps."""
    if kind == "flat":
        spec_p, spec_j = ObsSpec((OBS_DIM,), np.float32), None
        parts = [make_rows(6), make_rows(5, start=6)]
    else:
        spec_p = MultiObservation(ObsSpec((5,), np.float32), ObsSpec((8, 8, 3), np.uint8))
        parts = [_multi_rows(6, 0), _multi_rows(5, 1)]
    import jax

    spec_j = (jax.ShapeDtypeStruct((OBS_DIM,), np.float32) if kind == "flat" else
              JMulti(jax.ShapeDtypeStruct((5,), np.float32),
                     jax.ShapeDtypeStruct((8, 8, 3), np.uint8)))
    write_m, read_m = (jreplay, replay) if writer == "jax" else (replay, jreplay)
    meta = {"obs": write_m.obs_spec_to_json(spec_j if writer == "jax" else spec_p),
            "act_dim": 2, "act_limit": 1.0, "source": "test"}
    assert replay.obs_spec_to_json(spec_p) == jreplay.obs_spec_to_json(spec_j)
    tier = write_m.DiskTier(tmp_path / "d", max_bytes=0)
    tier.ensure_meta(meta)
    for p in parts:
        tier.append(p)
    tier.close()
    other = read_m.DiskTier(tmp_path / "d")
    other.ensure_meta(meta)  # the same geometry validates
    assert other.snapshot() == write_m.DiskTier(tmp_path / "d").snapshot()
    assert same_rows(other.read_all(), concat_rows(parts))
    back = replay.obs_spec_from_json(other.meta["obs"] if read_m is replay
                                     else DiskTier(tmp_path / "d").meta["obs"])
    if kind == "flat":
        assert back == ObsSpec((OBS_DIM,), np.dtype(np.float32))
    else:
        assert back.frame == ObsSpec((8, 8, 3), np.dtype(np.uint8))
        assert back.features == ObsSpec((5,), np.dtype(np.float32))
    lines = [json.loads(x) for x in (tmp_path / "d" / "manifest.jsonl").read_text().splitlines()]
    assert [x["file"] for x in lines] == ["chunk-00000000.npz", "chunk-00000001.npz"]
    assert json.loads((tmp_path / "d" / "meta.json").read_text())["schema"] == 1
    other.close()


# -------------------------------------------------------------- prefetcher


def warm_tiered(m=replay):
    tiered = m.TieredReplay(hbm_capacity=8, host_capacity=64)
    for i in range(5):
        tiered.ingest_rows(make_rows(8, start=8 * i))
    return tiered  # host tier holds 32 spilled rows


def test_prefetcher_sync_samples_on_demand():
    pf = RefillPrefetcher(warm_tiered(), n_envs=2, refill_rows=3, async_prefetch=False)
    jpf = jreplay.RefillPrefetcher(warm_tiered(jreplay), n_envs=2, refill_rows=3,
                                   async_prefetch=False)
    for _ in range(3):
        chunk, jchunk = pf.poll_local_chunk(), jpf.poll_local_chunk()
        assert chunk is not None
        assert chunk.rewards.shape == (2, 3)
        assert chunk.states.shape == (2, 3, OBS_DIM)
        assert same_rows(batch_to_rows(chunk, n_lead=2),
                         jreplay.batch_to_rows(jchunk, n_lead=2))
    assert pf.requests_total == 3 and pf.stalls_total == 0
    assert pf.metrics() == jpf.metrics()
    pf.close()
    jpf.close()


def test_prefetcher_async_stages_and_counts_stalls():
    pf = RefillPrefetcher(warm_tiered(), n_envs=2, refill_rows=3, async_prefetch=True)
    deadline = time.monotonic() + 5.0
    chunk = None
    while chunk is None and time.monotonic() < deadline:
        chunk = pf.poll_local_chunk()
        if chunk is None:
            time.sleep(0.01)
    assert chunk is not None, "async prefetcher never staged a chunk"
    assert chunk.rewards.shape == (2, 3)
    pf.close()  # thread stopped: the queue drains, then stalls count
    while pf.poll_local_chunk() is not None:
        pass
    assert pf.stalls_total >= 1
    m = pf.metrics()
    assert m["replay/refills_served"] == 0.0
    assert 0.0 <= m["replay/prefetch_hit_rate"] <= 1.0


def test_prefetcher_empty_host_is_not_a_stall():
    tiered = TieredReplay(hbm_capacity=8, host_capacity=64)
    tiered.ingest_rows(make_rows(4))
    pf = RefillPrefetcher(tiered, n_envs=2, refill_rows=3)
    assert pf.poll_local_chunk() is None
    assert pf.stalls_total == 0
    pf.close()
    with pytest.raises(ValueError, match="refill_rows"):
        RefillPrefetcher(tiered, n_envs=1, refill_rows=0, async_prefetch=False)


def test_prefetcher_push_into_is_the_ring_push():
    """On the CPU the refill push is ``buffer/replay.push`` of the same
    rows: the ring and its device size as a direct push leaves them."""
    pf = RefillPrefetcher(warm_tiered(), n_envs=1, refill_rows=5, async_prefetch=False)
    rows = batch_to_rows(pf.poll_local_chunk(), n_lead=2)
    ring = init_replay_buffer(12, (OBS_DIM,), ACT_DIM, "cpu")
    ring = push(ring, rows_to_batch(make_rows(9, start=100)).map(torch.from_numpy))
    want = push(ring.clone(), rows_to_batch(rows).map(torch.from_numpy))
    got = pf.push_into(ring, rows)
    assert (got.ptr, got.size, int(got.device_size)) == (want.ptr, want.size, 12) == (2, 12, 12)
    assert all(torch.equal(a, b) for a, b in zip(got.data.leaves(), want.data.leaves()))
    assert pf.refills_served == 1
    pf.close()


def test_async_refill_conserves_under_contention():
    """The prefetch thread samples the host tier while more ingesting
    threads than cores push and note refills, with a short switch
    interval: every flow stays counted and conservation holds."""
    import os
    import sys
    import threading

    tiered = TieredReplay(hbm_capacity=16, host_capacity=24, seed=1)
    pf = RefillPrefetcher(tiered, n_envs=1, refill_rows=3, async_prefetch=True,
                          idle_sleep_s=0.0)
    workers, chunks, served = (os.cpu_count() or 1) + 2, 60, []
    errors = []

    def ingest(w):
        try:
            for i in range(chunks):
                tiered.ingest_rows(make_rows(4, start=10_000 * w + 4 * i))
                assert tiered.conservation_holds()
        except AssertionError as e:  # reported below, with the thread's id
            errors.append((w, e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ingest, args=(w,)) for w in range(workers)]
        for th in threads:
            th.start()
        deadline = time.monotonic() + 30.0
        while any(th.is_alive() for th in threads) and time.monotonic() < deadline:
            chunk = pf.poll_local_chunk()
            if chunk is not None:
                served.append(tiered.note_refill(batch_to_rows(chunk, n_lead=2)))
        for th in threads:
            th.join(timeout=30.0)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
        pf.close()
    assert not errors
    assert tiered.pushed_total == workers * chunks * 4
    assert tiered.refill_total == sum(served) == 3 * len(served) > 0
    assert tiered.shadow.received_total == tiered.pushed_total + tiered.refill_total
    assert tiered.conservation_holds()
    assert pf.requests_total >= len(served) + pf.stalls_total


# ----------------------------------------------- trainer: tiers at the loop

TINY_TR = dict(
    hidden_sizes=(32, 32), batch_size=32, epochs=2, steps_per_epoch=60, start_steps=20,
    update_after=20, update_every=10, buffer_size=100, max_ep_len=100,
)
PIN_KEYS = ("loss_q", "loss_pi", "reward")


def run_trainer(tmp_path, name, checkpointer=None, epochs=None, **overrides):
    cfg = SACConfig(**{**TINY_TR, **overrides, **({"epochs": epochs} if epochs else {})})
    tracker = Tracker(experiment="test", root=tmp_path / name)
    tr = Trainer("PendulumNumpy-v1", cfg, tracker=tracker, device="cpu",
                 checkpointer=checkpointer)
    try:
        tr.train()
    finally:
        tr.close()
    return tracker.metrics(), tr


def test_trainer_tiers_off_is_bitwise_and_emits_no_replay_columns(tmp_path):
    """Tiers off writes exactly today's columns, and the host tier on does
    not move the training stream by a bit; archival tiers
    (``replay_refill=0``, a disk tier) leave the parameters bitwise too."""
    rows_off, tr_off = run_trainer(tmp_path, "off")
    rows_host, _ = run_trainer(tmp_path, "host", replay_tiers="host")
    rows_disk, tr_disk = run_trainer(tmp_path, "disk", replay_tiers="disk")
    assert not any(k.startswith("replay/") for r in rows_off for k in r)
    assert len(rows_off) == len(rows_host) == len(rows_disk)
    for ra, rb, rc in zip(rows_off, rows_host, rows_disk):
        for key in PIN_KEYS:
            assert ra[key] == rb[key] == rc[key], key
    for a, b in zip(tr_off.state.actor.parameters(), tr_disk.state.actor.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(tr_off.buffer.data.leaves(), tr_disk.buffer.data.leaves()):
        assert torch.equal(a, b)
    last = rows_host[-1]
    assert last["replay/conservation_ok"] == 1.0
    assert last["replay/spilled_host_total"] > 0
    assert last["replay/hbm_bytes"] > 0
    disk = rows_disk[-1]
    # 120 rows through a 100-row ring and a 100-row host tier: 20 spilled
    # to the host, none yet to disk; the default directory is the run's.
    assert (disk["replay/spilled_host_total"], disk["replay/spilled_disk_total"]) == (20.0, 0.0)
    assert disk["replay/conservation_ok"] == 1.0
    run_dir = next((tmp_path / "disk" / "test").iterdir())
    assert json.loads((run_dir / "replay" / "meta.json").read_text())["source"] == "trainer"


def test_trainer_refill_recirculates_with_conservation(tmp_path):
    """Refill on (synchronous, for determinism): host rows flow back into
    the ring, losses stay finite, every flow stays counted; two runs
    from one seed are bitwise the same."""
    kw = dict(replay_tiers="disk", replay_refill=2, replay_prefetch=False,
              replay_host_capacity=30, buffer_size=50)
    rows, tr = run_trainer(tmp_path, "refill", **kw)
    again, _ = run_trainer(tmp_path, "again", **kw)
    last = rows[-1]
    assert np.isfinite(last["loss_q"]) and np.isfinite(last["loss_pi"])
    assert last["replay/refill_rows_total"] > 0
    assert last["replay/refills_served"] > 0
    assert last["replay/spilled_disk_total"] > 0
    assert last["replay/conservation_ok"] == 1.0
    # One refill a window once the host tier holds rows, 2 rows each; the
    # ring saw every fresh row and every refilled one.
    assert last["replay/refill_rows_total"] == 2 * last["replay/refills_served"]
    assert tr.tiered.shadow.received_total == 120 + last["replay/refill_rows_total"]
    def stream(r):  # every column but the clocks
        return {k: v for k, v in r.items() if not k.endswith(("_per_sec", "_s")) and k != "time"}

    assert [stream(a) for a in rows] == [stream(b) for b in again]


def test_trainer_async_refill_keeps_the_invariant(tmp_path):
    """The default asynchronous prefetch: when the thread samples is not
    fixed, so the run is held to the invariant and the counters — every
    boundary a refill or a counted stall, each refill 2 rows."""
    rows, tr = run_trainer(tmp_path, "async", replay_tiers="host", replay_refill=2,
                           buffer_size=50)
    last = rows[-1]
    assert last["replay/conservation_ok"] == 1.0
    assert last["replay/refills_served"] > 0
    assert last["replay/refill_rows_total"] == 2 * last["replay/refills_served"]
    assert tr._prefetcher.requests_total == 12  # one a window: 120 steps / 10
    assert (last["replay/refills_served"] + last["replay/prefetch_stalls_total"]
            <= tr._prefetcher.requests_total)
    assert tr.tiered.shadow.received_total == 120 + last["replay/refill_rows_total"]


def test_trainer_sync_refill_conserves_across_a_checkpoint_restart(tmp_path):
    """Save with tiers on, restore into a new trainer (its counters from
    the checkpoint meta, the host rows declared lost), train on: the
    invariant holds and the disk tier's rows carried over."""
    kw = dict(replay_tiers="disk", replay_refill=2, replay_prefetch=False,
              replay_host_capacity=30, buffer_size=50, replay_dir=str(tmp_path / "tier"),
              save_every=1)
    ckpt = Checkpointer(tmp_path / "ckpt")
    rows, tr = run_trainer(tmp_path, "first", checkpointer=ckpt, **kw)
    saved = ckpt.peek_meta()["replay_tiers"]
    assert saved["pushed_total"] == 120 and saved["host"]["rows"] > 0
    cfg = SACConfig(**{**TINY_TR, **kw})
    resumed = Trainer("PendulumNumpy-v1", cfg, device="cpu", checkpointer=ckpt)
    try:
        resumed.restore()
        t = resumed.tiered
        assert t.host.size == 0 and t.host.dropped_restart_total == saved["host"]["rows"]
        assert t.shadow.dropped_restart_total == saved["shadow"]["rows"]
        assert t.conservation_holds()
        m = resumed.train()
    finally:
        resumed.close()
    assert m["replay/conservation_ok"] == 1.0
    assert m["replay/pushed_total"] == 240.0
    assert m["replay/refill_rows_total"] > rows[-1]["replay/refill_rows_total"]
    assert DiskTier(tmp_path / "tier").received_total == m["replay/spilled_disk_total"]


def test_tiers_refuse_a_population_and_the_on_device_loop():
    with pytest.raises(ValueError, match="population"):
        SACConfig(replay_tiers="host", population=2)
    with pytest.raises(ValueError, match="on_device"):
        SACConfig(replay_tiers="disk", on_device=True)
    with pytest.raises(ValueError, match="tier stack"):
        SACConfig(replay_refill=2)
    with pytest.raises(ValueError, match="replay-dir"):
        replay.build_tiered_replay(SACConfig(replay_tiers="disk"), ObsSpec((3,)), 1, 8)
