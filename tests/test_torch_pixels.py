"""The port's fused pixel pipeline (K1's plain version), DrQ shift, visual
replay ring and pixel pendulums against the JAX package's, on the CPU.

All inputs are numpy from a seed (JAX's own draws where the contract is
"the same draw": shift offsets and sampled rows come from JAX's keys and
are injected into the port).

- K1's plain version (``ops/pixels.gather_frames_reference``, which the
  wrapper runs for CPU tensors) is **bitwise** equal to JAX's
  ``gather_frames_reference`` run op by op, for f32/bf16 × normalize ×
  shift × frame_stack ∈ {1, 3}, a ragged H ≠ W, wrap-around rows
  ``idx < S-1`` and all 256 uint8 values; and bitwise equal to the
  Pallas kernel in interpret mode, except that the interpreter (a jitted
  program) lets XLA rewrite the f32 ``v / 255`` as ``v * (1/255)``: that
  case is pinned bitwise to the multiply and to within 1 ulp of the
  port's IEEE divide.
- ``stack_rows``, ``random_shift``, ``augment_batch``, push/sample and
  ``sample_fused_visual``: exact.
- ``render_rod`` bitwise; the gymnasium ``PixelPendulum`` (balance and
  swing-up) step for step: frames exact, rewards 1e-6.
  ``PixelPendulumNumpy`` (float32 physics) against it (gymnasium's state
  is float64) from one set state over 50 steps: rewards 1e-3, frames at
  most 2 grey levels apart on a pixel (the rod's anti-aliased edge moves
  with the last bits of theta).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_actor_critic_tpu.buffer import replay as jreplay
from torch_actor_critic_tpu.core.types import Batch as JBatch
from torch_actor_critic_tpu.core.types import MultiObservation as JMultiObservation
from torch_actor_critic_tpu.envs.pixel_pendulum import PixelPendulum as JPixelPendulum
from torch_actor_critic_tpu.envs.pixel_pendulum import render_rod as j_render_rod
from torch_actor_critic_tpu.ops import augment as jaugment
from torch_actor_critic_tpu.ops import pixels as jpixels
from torch_actor_critic_tpu_torch.buffer import replay
from torch_actor_critic_tpu_torch.core.types import Batch, MultiObservation
from torch_actor_critic_tpu_torch.envs.pixel_pendulum import (
    PixelPendulum,
    PixelPendulumNumpy,
    render_rod,
)
from torch_actor_critic_tpu_torch.envs.vec_env import make_env_pool
from torch_actor_critic_tpu_torch.envs.wrappers import is_visual_env, make_env
from torch_actor_critic_tpu_torch.ops import _kernels, augment, pixels

CAP, H, W, C = 64, 12, 20, 3  # ragged H != W
PAD = 3
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny ops: one intra-op thread avoids the oversubscription of
    several test workers each spinning a full thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ring(seed=0, cap=CAP, h=H, w=W, c=C):
    ring = np.random.default_rng(seed).integers(0, 256, (cap, h, w, c), dtype=np.uint8)
    ring[5].reshape(-1)[:256] = np.arange(256, dtype=np.uint8)  # every value
    return ring


IDX = np.array([0, 1, 5, 63, 31, 31], np.int32)  # 0 and 1 wrap when S = 3


def _offsets(seed, n=len(IDX)):
    return np.array(jaugment.shift_offsets(jax.random.key(seed), n, PAD))


def _port(ring, idx, offsets, **kw):
    return pixels.fused_frame_gather(
        torch.from_numpy(ring), torch.from_numpy(idx),
        None if offsets is None else torch.from_numpy(offsets), pad=PAD, **kw,
    )


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


# ----------------------------------------------------------- K1, plain


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("frame_stack", [1, 3])
def test_plain_gather_is_bitwise_jax_reference(dtype, normalize, shift, frame_stack):
    jdt, tdt = DTYPES[dtype]
    ring = _ring()
    offsets = _offsets(1) if shift else None
    want = jpixels.gather_frames_reference(
        jnp.asarray(ring), jnp.asarray(IDX), None if offsets is None else jnp.asarray(offsets),
        pad=PAD, normalize=normalize, out_dtype=jdt, frame_stack=frame_stack,
    )
    before = dict(_kernels.launch_counts)
    got = _port(ring, IDX, offsets, normalize=normalize, out_dtype=tdt, frame_stack=frame_stack)
    assert dict(_kernels.launch_counts) == before  # the CPU runs no kernel
    assert got.dtype == tdt and tuple(got.shape) == want.shape == (len(IDX), H, W, frame_stack * C)
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("frame_stack", [1, 3])
def test_plain_gather_matches_the_pallas_kernel_in_interpret_mode(dtype, normalize, shift, frame_stack):
    jdt, tdt = DTYPES[dtype]
    ring = _ring(seed=2)
    offsets = _offsets(3) if shift else None
    pallas = _f32(jpixels.fused_frame_gather(
        jnp.asarray(ring), jnp.asarray(IDX), None if offsets is None else jnp.asarray(offsets),
        pad=PAD, normalize=normalize, out_dtype=jdt, frame_stack=frame_stack,
        impl="pallas", interpret=True,
    ))
    got = _f32(_port(ring, IDX, offsets, normalize=normalize, out_dtype=tdt, frame_stack=frame_stack))
    if dtype == "f32" and normalize:
        # The interpreter is a jitted program, and XLA turns the f32
        # divide by the constant 255 into a multiply by its reciprocal.
        raw = _f32(_port(ring, IDX, offsets, normalize=False, out_dtype=tdt, frame_stack=frame_stack))
        np.testing.assert_array_equal(pallas, raw * np.float32(1 / 255))
        ulps = np.abs(got.view(np.int32) - pallas.view(np.int32))
        assert ulps.max() <= 1
    else:
        np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_of_all_256_values_is_bitwise_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    ring = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    idx = np.zeros(1, np.int32)
    for normalize in (False, True):
        want = jpixels.gather_frames_reference(
            jnp.asarray(ring), jnp.asarray(idx), normalize=normalize, out_dtype=jdt)
        got = _port(ring, idx, None, normalize=normalize, out_dtype=tdt)
        np.testing.assert_array_equal(_f32(got), _f32(want))
    assert _f32(got).reshape(-1)[255] == 1.0


def test_stack_rows_is_floor_mod_like_jax():
    idx = np.array([0, 1, 2, 9, 63], np.int32)
    for s in (1, 3, 5):
        want = np.asarray(jpixels.stack_rows(jnp.asarray(idx), s, 64))
        got = pixels.stack_rows(torch.from_numpy(idx).long(), s, 64)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got >= 0).all()
    with pytest.raises(ValueError, match="frame_stack"):
        pixels.stack_rows(torch.zeros(2, dtype=torch.long), 0, 64)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    ring = torch.zeros((4, 8, 8, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="uint8"):
        pixels.fused_frame_gather(ring, torch.zeros(2, dtype=torch.long))
    ring = ring.to(torch.uint8)
    with pytest.raises(ValueError, match="offsets"):
        pixels.fused_frame_gather(ring, torch.zeros(2, dtype=torch.long),
                                  torch.zeros((3, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="out_dtype"):
        pixels.fused_frame_gather(ring, torch.zeros(2, dtype=torch.long), out_dtype=torch.float16)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("frame_stack", [1, 3])
def test_pair_gather_is_bitwise_two_jax_references(dtype, normalize, shift, frame_stack):
    """Both frame leaves from one call (one launch on the card) equal two
    calls of JAX's reference; rows 0 and 1 wrap when S = 3."""
    jdt, tdt = DTYPES[dtype]
    rings = (_ring(seed=4), _ring(seed=5))
    offsets = (_offsets(6), _offsets(7)) if shift else (None, None)
    before = dict(_kernels.launch_counts)
    got = pixels.fused_frame_gather_pair(
        tuple(torch.from_numpy(r) for r in rings), torch.from_numpy(IDX),
        None if not shift else tuple(torch.from_numpy(o) for o in offsets),
        pad=PAD, normalize=normalize, out_dtype=tdt, frame_stack=frame_stack,
    )
    assert dict(_kernels.launch_counts) == before  # the CPU runs no kernel
    assert len(got) == 2
    for g, ring, offs in zip(got, rings, offsets):
        want = jpixels.gather_frames_reference(
            jnp.asarray(ring), jnp.asarray(IDX), None if offs is None else jnp.asarray(offs),
            pad=PAD, normalize=normalize, out_dtype=jdt, frame_stack=frame_stack,
        )
        assert g.dtype == tdt and tuple(g.shape) == want.shape
        np.testing.assert_array_equal(_f32(g), _f32(want))


@pytest.mark.parametrize("case", ["shape", "device", "offsets", "dtype", "count"])
def test_pair_wrapper_rejects_what_the_kernel_does_not_take(case):
    ring = torch.zeros((4, 8, 8, 3), dtype=torch.uint8)
    idx = torch.zeros(2, dtype=torch.long)
    rings, offsets, match = (ring, ring.clone()), None, "uint8"
    if case == "shape":
        rings, match = (ring, torch.zeros((4, 8, 9, 3), dtype=torch.uint8)), "shape or device"
    elif case == "device":
        rings, match = (ring, ring.to("meta")), "shape or device"
    elif case == "offsets":
        offsets = (torch.zeros((2, 2), dtype=torch.int32), torch.zeros((3, 2), dtype=torch.int32))
        match = "offsets"
    elif case == "dtype":
        rings = (ring.float(), ring.float())
    else:
        rings, match = (ring,), "two rings"
    with pytest.raises(ValueError, match=match):
        pixels.fused_frame_gather_pair(rings, idx, offsets)


def test_pixel_gather_signature_matches_the_c_entry():
    """``SIGNATURES["pixel_gather"]`` has one argtype per parameter of
    the ``extern "C"`` entry in ``csrc/pixels.cu``."""
    import re

    source, symbol, argtypes = _kernels.SIGNATURES["pixel_gather"]
    text = (_kernels.SRC_DIR / f"{source}.cu").read_text()
    entry = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert entry is not None
    params = [p.strip() for p in entry.group(1).split(",")]
    assert len(params) == len(argtypes) == 18
    for param, argtype in zip(params, argtypes):
        is_pointer = "*" in param
        assert (argtype is _kernels.ctypes.c_void_p) == is_pointer, param


# ------------------------------------------------------------- DrQ shift


def test_random_shift_matches_jax_for_jax_offsets():
    frames = np.random.default_rng(4).integers(0, 256, (2, 5, H, W, C), dtype=np.uint8)
    key = jax.random.key(6)
    want = jaugment.random_shift(jnp.asarray(frames), key, PAD)
    offsets = np.array(jaugment.shift_offsets(key, 10, PAD))  # the draw inside random_shift
    got = augment.random_shift(torch.from_numpy(frames), torch.from_numpy(offsets), PAD)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The fused gather's clipped-index shift is the same function.
    flat = frames.reshape(10, H, W, C)
    gathered = _port(flat, np.arange(10, dtype=np.int32), offsets, normalize=False,
                     out_dtype=torch.float32)
    np.testing.assert_array_equal(gathered.numpy(), got.reshape(10, H, W, C).numpy().astype(np.float32))


def test_shift_offsets_range_and_augment_batch_matches_jax():
    draws = augment.shift_offsets(4000, PAD, torch.Generator().manual_seed(0))
    assert draws.dtype == torch.int32 and int(draws.min()) == 0 and int(draws.max()) == 2 * PAD
    b = _visual_chunk(4, seed=7)
    key = jax.random.key(8)
    want = jaugment.augment_batch(_jbatch(b), key, "shift", PAD)
    k_s, k_n = jax.random.split(key)
    offsets = torch.from_numpy(np.stack([np.array(jaugment.shift_offsets(k, 4, PAD))
                                         for k in (k_s, k_n)]))
    got = augment.augment_batch(_tbatch(b), "shift", PAD, offsets=offsets)
    np.testing.assert_array_equal(got.states.frame.numpy(), np.asarray(want.states.frame))
    np.testing.assert_array_equal(got.next_states.frame.numpy(), np.asarray(want.next_states.frame))
    assert augment.augment_batch(_tbatch(b), "none", PAD).states.frame is not None
    with pytest.raises(ValueError, match="frame_augment"):
        augment.augment_batch(_tbatch(b), "crop", PAD)


# ---------------------------------------------------------- visual ring


def _visual_chunk(n, seed, feat=2, frame=(H, W, C), act_dim=1):
    rng = np.random.default_rng(seed)

    def obs():
        return dict(features=rng.standard_normal((n, feat)).astype(np.float32),
                    frame=rng.integers(0, 256, (n, *frame), dtype=np.uint8))

    return dict(states=obs(), actions=rng.uniform(-1, 1, (n, act_dim)).astype(np.float32),
                rewards=rng.standard_normal(n).astype(np.float32), next_states=obs(),
                done=(rng.uniform(size=n) < 0.2).astype(np.float32))


def _jbatch(b):
    return JBatch(states=JMultiObservation(**b["states"]), actions=b["actions"],
                  rewards=b["rewards"], next_states=JMultiObservation(**b["next_states"]),
                  done=b["done"])


def _tbatch(b):
    def t(x):
        return torch.from_numpy(np.array(x))

    return Batch(states=MultiObservation(t(b["states"]["features"]), t(b["states"]["frame"])),
                 actions=t(b["actions"]), rewards=t(b["rewards"]),
                 next_states=MultiObservation(t(b["next_states"]["features"]),
                                              t(b["next_states"]["frame"])),
                 done=t(b["done"]))


def test_visual_ring_push_sample_and_fused_sample_match_jax():
    cap = 16
    jbuf = jreplay.init_visual_replay_buffer(cap, 2, (H, W, C), 1)
    buf = replay.init_visual_replay_buffer(cap, 2, (H, W, C), 1, device="cpu")
    assert buf.data.states.frame.dtype == torch.uint8 and buf.visual
    for i, n in enumerate((10, 10)):  # wraps
        chunk = _visual_chunk(n, seed=10 + i)
        jbuf = jreplay.push(jbuf, _jbatch(chunk))
        buf = replay.push(buf, _tbatch(chunk))
    assert (buf.ptr, buf.size) == (int(jbuf.ptr), int(jbuf.size))
    for got, want in zip(buf.data.leaves(), jax.tree_util.tree_leaves(jbuf.data)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    key = jax.random.key(11)
    idx = np.array(jax.random.randint(key, (6,), 0, cap))
    plain = replay.sample(buf, 6, indices=torch.from_numpy(idx))
    for got, want in zip(plain.leaves(), jax.tree_util.tree_leaves(jreplay.sample(jbuf, key, 6))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    for dtype, augment_mode, normalize in (("f32", "shift", True), ("bf16", "none", False)):
        jdt, tdt = DTYPES[dtype]
        want = jreplay.sample_fused_visual(jbuf, key, 6, out_dtype=jdt, augment=augment_mode,
                                           pad=PAD, normalize=normalize, impl="xla")
        if augment_mode == "shift":
            k_idx, k_s, k_n = jax.random.split(key, 3)
            offsets = torch.from_numpy(np.stack([np.array(jaugment.shift_offsets(k, 6, PAD))
                                                 for k in (k_s, k_n)]))
        else:
            k_idx, offsets = key, None
        idx = np.array(jax.random.randint(k_idx, (6,), 0, cap))
        got = replay.sample_fused_visual(buf, 6, tdt, augment_mode, PAD, normalize,
                                         indices=torch.from_numpy(idx), offsets=offsets)
        assert got.states.frame.dtype == tdt
        for g, w in zip(got.leaves(), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(_f32(g), _f32(w))

    drawn = replay.sample_fused_visual(buf, 5, torch.float32, "shift", PAD, True,
                                       generator=torch.Generator().manual_seed(0))
    assert drawn.next_states.frame.shape == (5, H, W, C)
    assert float(drawn.states.frame.max()) <= 1.0
    with pytest.raises(ValueError, match="MultiObservation"):
        replay.sample_fused_visual(replay.init_replay_buffer(4, (3,), 1, "cpu"), 2, torch.float32,
                                   generator=torch.Generator())
    with pytest.raises(ValueError, match="offsets or a generator"):
        replay.sample_fused_visual(buf, 2, torch.float32, "shift", indices=torch.zeros(2))


# ------------------------------------------------------------ pixel envs


def test_render_rod_is_bitwise_jax():
    for theta in (0.0, 0.3, -1.2, np.pi, 2.5, -3.0, 1e-4):
        np.testing.assert_array_equal(render_rod(theta), j_render_rod(theta))
    np.testing.assert_array_equal(render_rod(0.7, size=20), j_render_rod(0.7, size=20))


@pytest.mark.parametrize("balance", [False, True])
def test_pixel_pendulum_matches_jax_step_for_step(balance):
    port = make_env("PixelPendulumBalance-v0" if balance else "PixelPendulum-v0", seed=3)
    ref = JPixelPendulum(seed=3, balance=balance)
    assert isinstance(port, PixelPendulum) and port.name == ref.name
    assert port.obs_spec.frame.shape == ref.obs_spec.frame.shape == (32, 32, 3)
    assert port.obs_spec.frame.dtype == np.uint8 and port.obs_spec.features.shape == (1,)
    for ep in range(2):
        got, want = port.reset(seed=11 + ep), ref.reset(seed=11 + ep)
        np.testing.assert_array_equal(got.frame, want.frame)
        np.testing.assert_array_equal(got.features, want.features)
        for _ in range(25):
            a = port.sample_action()
            np.testing.assert_array_equal(a, ref.sample_action())
            (g, gr, gt, gtr), (w, wr, wt, wtr) = port.step(a), ref.step(a)
            np.testing.assert_array_equal(g.frame, w.frame)
            np.testing.assert_array_equal(g.features, w.features)
            assert abs(gr - wr) <= 1e-6 and (gt, gtr) == (wt, wtr)
    port.close()
    ref.close()


@pytest.mark.parametrize("balance", [False, True])
def test_numpy_pixel_pendulum_tracks_the_gymnasium_one(balance):
    gym_env, np_env = PixelPendulum(seed=0, balance=balance), PixelPendulumNumpy(seed=0, balance=balance)
    gym_env.reset(seed=0)
    rng = np.random.default_rng(5)
    theta, theta_dot = 0.4, -0.3
    a0, b0 = gym_env.set_state(theta, theta_dot), np_env.set_state(theta, theta_dot)
    np.testing.assert_array_equal(a0.frame, b0.frame)
    for _ in range(50):
        act = rng.uniform(-2, 2, (1,)).astype(np.float32)
        (a, ra, _, _), (b, rb, tb, _) = gym_env.step(act), np_env.step(act)
        assert abs(ra - rb) <= 1e-3 and tb is False
        assert np.abs(a.frame.astype(int) - b.frame.astype(int)).max() <= 2
        np.testing.assert_array_equal(a.features, b.features)
    obs = np_env.reset(seed=9)
    np.testing.assert_array_equal(obs.frame, PixelPendulumNumpy(seed=1, balance=balance).reset(seed=9).frame)
    assert obs.frame.dtype == np.uint8 and (obs.frame[..., 0] == obs.frame[..., 2]).all()
    gym_env.close()


def test_visual_env_names_and_pool():
    assert is_visual_env("PixelPendulumBalanceNumpy-v0") and not is_visual_env("Pendulum-v1")
    assert isinstance(make_env("PixelPendulumNumpy-v0"), PixelPendulumNumpy)
    assert make_env("PixelPendulumBalanceNumpy-v0").balance
    pool = make_env_pool("PixelPendulumBalanceNumpy-v0", 2, base_seed=1)
    obs = pool.reset_all([1, 2])
    assert isinstance(obs, MultiObservation)
    assert obs.frame.shape == (2, 32, 32, 3) and obs.frame.dtype == np.uint8
    assert obs.features.shape == (2, 1) and obs.features.dtype == np.float32
    nxt, r, term, trunc = pool.step(pool.sample_actions())
    assert nxt.frame.shape == (2, 32, 32, 3) and r.shape == (2,)
    with pytest.raises(ValueError, match="flat"):
        make_env("PixelPendulumNumpy-v0|history:4")
