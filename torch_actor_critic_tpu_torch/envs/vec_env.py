"""Lockstep host env pools (port of ``envs/vec_env.py``).

- :class:`SequentialEnvPool`: the in-process lockstep batch (no native
  dependency; the default, and the fallback).
- :class:`ParallelEnvPool`: one **worker process per env** stepping in
  parallel. Commands and acks are int32 words in POSIX shared memory
  synchronised by futex wait/wake (the port's own copy of the native
  runtime, :mod:`..native`); actions and observations cross process
  boundaries as rows of batched shared-memory arrays, each observation
  leaf in its own dtype (a :class:`~..core.types.MultiObservation`'s
  f32 features and uint8 frame are two leaves). Worker startup (env
  construction, the spec exchange) uses a one-time ``multiprocessing``
  pipe off the hot path.

Both expose one protocol: ``obs_spec`` / ``act_dim`` / ``act_limit`` /
``n``; ``reset_all(seeds)``, ``reset_at(i, seed)``, ``step(actions)``,
``step_at(i, action)``, ``sample_actions()``, ``render_at(i)``,
``close()``.

Workers are host-side env steppers and never open a CUDA context: they
are spawned (by default) with ``CUDA_VISIBLE_DEVICES`` blank, resolve
the env by name through :func:`~.wrappers.make_env`, and import torch
for the CPU only. Every native wait has a timeout; on expiry the pool
checks the worker and raises a ``RuntimeError`` naming it. A worker
whose env raises reports the traceback through its pipe instead of
hanging the barrier; workers exit when their parent is gone; teardown is
bounded (CLOSE, then terminate, then kill).

:func:`make_env_pool` returns the parallel pool for ``parallel`` and
``n > 1`` when the runtime loads, else the sequential pool (with a
warning where the runtime could not load, as in the JAX package).
"""

from __future__ import annotations

import atexit
import contextlib
import logging
import multiprocessing as mp
import os
import threading
import typing as t
from multiprocessing import shared_memory

import numpy as np

from torch_actor_critic_tpu_torch.core.types import MultiObservation
from torch_actor_critic_tpu_torch.envs.wrappers import ObsSpec, ensure_headless_gl, make_env

logger = logging.getLogger(__name__)

CMD_STEP = 1
CMD_RESET = 2
CMD_RENDER = 3
CMD_CLOSE = 4

# int32 words per worker in the control block (64 B: one cache line, no
# false sharing between workers' futex words).
CTRL_STRIDE = 16
_SEQ, _CMD, _ACK, _ERR = 0, 1, 2, 3

_ALIGN = 64


_CHILD_ENV_LOCK = threading.Lock()


@contextlib.contextmanager
def host_only_children():
    """The environment of processes started inside the block (each child
    snapshots ``os.environ`` at ``start()``): spawned children boot a fresh
    interpreter that does not inherit the parent's ``sys.path``, so the
    package root goes on ``PYTHONPATH``; and ``CUDA_VISIBLE_DEVICES`` is
    blank, so no child ever holds a context on the card (env workers,
    actor processes). On a host without a display ``MUJOCO_GL`` is
    ``egl`` in the children, as :func:`~.wrappers.ensure_headless_gl`
    would set it, so a dm_control env built in a worker renders headless.
    Serialized across threads; the parent's environment is restored on
    exit."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with _CHILD_ENV_LOCK:
        overrides = {
            "PYTHONPATH": pkg_root
            + (os.pathsep + os.environ["PYTHONPATH"] if os.environ.get("PYTHONPATH") else ""),
            "CUDA_VISIBLE_DEVICES": "",
        }
        if "MUJOCO_GL" not in os.environ and "DISPLAY" not in os.environ:
            overrides["MUJOCO_GL"] = "egl"
        saved = {k: os.environ.get(k) for k in overrides}
        os.environ.update(overrides)
        try:
            yield
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


def stack_obs(obs: t.Sequence) -> t.Any:
    """Stack observations on a new leading axis, leaf by leaf for
    :class:`MultiObservation` observations (each leaf keeps its dtype)."""
    if isinstance(obs[0], MultiObservation):
        return MultiObservation(
            np.stack([o.features for o in obs]), np.stack([o.frame for o in obs])
        )
    return np.stack(obs)


def _obs_leaves(obs) -> list:
    """Deterministic leaf order for the one structured observation type."""
    if isinstance(obs, MultiObservation):
        return [obs.features, obs.frame]
    return [obs]


def _rebuild_obs(kind: str, leaves: list):
    if kind == "multiobs":
        return MultiObservation(features=leaves[0], frame=leaves[1])
    return leaves[0]


def _spec_message(env) -> dict:
    """Picklable description of an env's interface (worker -> parent)."""
    spec = env.obs_spec
    kind = "multiobs" if isinstance(spec, MultiObservation) else "array"
    leaves = [(tuple(s.shape), np.dtype(s.dtype).str) for s in _obs_leaves(spec)]
    return {
        "kind": kind,
        "leaves": leaves,
        "act_dim": int(env.act_dim),
        "act_limit": float(env.act_limit),
    }


def _spec_pytree(msg: dict):
    leaves = [ObsSpec(tuple(shape), np.dtype(dt)) for shape, dt in msg["leaves"]]
    return _rebuild_obs(msg["kind"], leaves)


def _layout(n: int, act_dim: int, leaves: t.Sequence[t.Tuple[tuple, str]]):
    """(offset, shape, dtype) table for the single shared-memory block."""
    fields: dict = {}
    off = n * CTRL_STRIDE * 4  # control block first
    for name, shape, dtype in [
        ("actions", (n, act_dim), "<f4"),
        ("rewards", (n,), "<f4"),
        ("terminated", (n,), "|u1"),
        ("truncated", (n,), "|u1"),
        ("seeds", (n,), "<i8"),
        *[(f"obs_{k}", (n, *shape), dt) for k, (shape, dt) in enumerate(leaves)],
    ]:
        off = (off + _ALIGN - 1) // _ALIGN * _ALIGN
        fields[name] = (off, shape, dtype)
        off += int(np.prod(shape)) * np.dtype(dtype).itemsize
    return fields, off


def _views(buf, n: int, fields: dict):
    """ctrl int32 view + named np views over one shm buffer."""
    ctrl = np.frombuffer(buf, dtype=np.int32, count=n * CTRL_STRIDE)
    data = {
        name: np.frombuffer(
            buf, dtype=np.dtype(dt), count=int(np.prod(shape)), offset=off
        ).reshape(shape)
        for name, (off, shape, dt) in fields.items()
    }
    return ctrl, data


class SequentialEnvPool:
    """In-process lockstep batch of ``n`` envs; env ``i`` is seeded
    ``base_seed + seed_stride * i``. ``timeout_s`` and ``start_method``
    are the parallel pool's and ignored here."""

    def __init__(
        self,
        env_name: str,
        n: int,
        base_seed: int = 0,
        seed_stride: int = 10000,
        timeout_s: float = 120.0,
        start_method: str = "spawn",
        env_kwargs: dict | None = None,
    ):
        self.n = n
        self.envs = [
            make_env(env_name, seed=base_seed + seed_stride * i, **(env_kwargs or {}))
            for i in range(n)
        ]
        e0 = self.envs[0]
        self.obs_spec, self.act_dim, self.act_limit = e0.obs_spec, e0.act_dim, e0.act_limit

    def reset_all(self, seeds: t.Sequence[int | None] | None = None):
        seeds = seeds or [None] * self.n
        return stack_obs([e.reset(seed=s) for e, s in zip(self.envs, seeds)])

    def reset_at(self, i: int, seed: int | None = None):
        return self.envs[i].reset(seed=seed)

    def step(self, actions: np.ndarray):
        out = [e.step(a) for e, a in zip(self.envs, actions)]
        obs = stack_obs([o[0] for o in out])
        r = np.asarray([o[1] for o in out], np.float32)
        term = np.asarray([o[2] for o in out], bool)
        trunc = np.asarray([o[3] for o in out], bool)
        return obs, r, term, trunc

    def step_at(self, i: int, action: np.ndarray):
        return self.envs[i].step(action)

    def sample_actions(self) -> np.ndarray:
        return np.stack([e.sample_action() for e in self.envs])

    def render_at(self, i: int):
        return self.envs[i].render()

    def close(self):
        for e in self.envs:
            e.close()


def _serve(lib, idx: int, env, conn, shm, n: int, fields: dict):
    """Worker command loop. All shm views live in THIS frame so they are
    released (np arrays holding buffer exports die with the frame) before
    the caller closes the mapping."""
    ctrl, data = _views(shm.buf, n, fields)
    obs_views = [data[f"obs_{k}"] for k in range(len(data) - 5)]
    base = ctrl.ctypes.data

    def addr(word):
        return base + (idx * CTRL_STRIDE + word) * 4

    conn.send(("ready", None))
    last = 0
    while True:
        # 1s wait slices so an orphaned worker notices parent death (the
        # pool's process, which a forkserver's worker does not have as its
        # OS parent: multiprocessing's parent sentinel tracks it).
        if lib.tac_wait_ne(addr(_SEQ), last, 1000) != 0:
            if not mp.parent_process().is_alive():
                logger.warning("env worker %d orphaned; exiting", idx)
                return
            continue
        last = int(lib.tac_load(addr(_SEQ)))
        cmd = int(ctrl[idx * CTRL_STRIDE + _CMD])
        ctrl[idx * CTRL_STRIDE + _ERR] = 0
        stop = False
        try:
            if cmd == CMD_STEP:
                obs, r, term, trunc = env.step(data["actions"][idx].copy())
                for view, leaf in zip(obs_views, _obs_leaves(obs)):
                    view[idx] = leaf
                data["rewards"][idx] = r
                data["terminated"][idx] = term
                data["truncated"][idx] = trunc
            elif cmd == CMD_RESET:
                s = int(data["seeds"][idx])
                obs = env.reset(seed=None if s < 0 else s)
                for view, leaf in zip(obs_views, _obs_leaves(obs)):
                    view[idx] = leaf
            elif cmd == CMD_RENDER:
                env.render()
            elif cmd == CMD_CLOSE:
                stop = True
        except Exception:  # noqa: BLE001 — report, don't hang the barrier
            import traceback

            ctrl[idx * CTRL_STRIDE + _ERR] = 1
            try:
                conn.send(("error", traceback.format_exc()))
            except OSError:  # pragma: no cover
                pass
        lib.tac_store_wake(addr(_ACK), last)
        if stop:
            return


def _worker_main(
    idx: int,
    env_name: str,
    seed: int,
    conn,
    env_kwargs: dict | None = None,
):
    """Env worker: build env, handshake spec, then serve futex commands.
    (The parent spawned it with ``CUDA_VISIBLE_DEVICES`` blank, so the
    torch it imports sees no card.)"""
    from torch_actor_critic_tpu_torch.native import load_runtime

    shm = None
    env = None
    try:
        lib = load_runtime()
        if lib is None:  # parent checked before spawning; defensive
            conn.send(("error", "native runtime unavailable in worker"))
            return
        ensure_headless_gl()  # before any dm_control import in this process
        env = make_env(env_name, seed=seed, **(env_kwargs or {}))
        conn.send(("spec", _spec_message(env)))
        shm_name, n, fields = conn.recv()
        shm = shared_memory.SharedMemory(name=shm_name)
        _serve(lib, idx, env, conn, shm, n, fields)
    finally:
        if env is not None:
            env.close()
        if shm is not None:
            shm.close()
        conn.close()


class ParallelEnvPool:
    """One worker process per env over shared memory + futex sync.

    Observations come back as copies (``np.array`` of the shared views):
    the trainer stages them across a whole update window, and a view
    would be overwritten under it by the next step. Warm-up actions are
    drawn on the parent side from ``np.random.default_rng(base_seed)``
    (:meth:`sample_actions`), so they differ from the sequential pool's
    per-env draws, as in the JAX package."""

    def __init__(
        self,
        env_name: str,
        n: int,
        base_seed: int = 0,
        seed_stride: int = 10000,
        timeout_s: float = 120.0,
        start_method: str = "spawn",
        env_kwargs: dict | None = None,
    ):
        from torch_actor_critic_tpu_torch.native import load_runtime

        lib = load_runtime()
        if lib is None:
            raise RuntimeError(
                "ParallelEnvPool needs the native runtime "
                "(torch_actor_critic_tpu_torch/native, built with g++) "
                "or use SequentialEnvPool."
            )
        self._lib = lib
        self.n = n
        self.env_name = env_name
        self._env_kwargs = dict(env_kwargs or {})
        self.timeout_ms = int(timeout_s * 1000)
        # spawn (default): workers never inherit the parent's CUDA state
        # across a fork; env construction is paid once, in parallel.
        ctx = mp.get_context(start_method)
        self._conns, self._procs = [], []
        with host_only_children():
            self._spawn_workers(ctx, n, env_name, base_seed, seed_stride)

        try:
            specs = [self._recv(i, "spec") for i in range(n)]
            msg = specs[0]
            self.act_dim = msg["act_dim"]
            self.act_limit = msg["act_limit"]
            self.obs_spec = _spec_pytree(msg)
            self._kind = msg["kind"]
            self._rng = np.random.default_rng(base_seed)

            fields, size = _layout(n, self.act_dim, msg["leaves"])
            self._shm = shared_memory.SharedMemory(create=True, size=size)
            self._ctrl, self._data = _views(self._shm.buf, n, fields)
            self._obs_views = [self._data[f"obs_{k}"] for k in range(len(msg["leaves"]))]
            self._ctrl_base = self._ctrl.ctypes.data
            for conn in self._conns:
                conn.send((self._shm.name, n, fields))
            for i in range(n):
                self._recv(i, "ready")
        except Exception:
            # A failed handshake must not strand parked workers (close()
            # is not reachable yet): tear everything down, then re-raise,
            # with each worker's exitcode on record.
            for p in self._procs:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=2)
            logger.warning(
                "vec_env handshake failed; worker exitcodes: %s",
                [p.exitcode for p in self._procs],
            )
            for conn in self._conns:
                conn.close()
            if hasattr(self, "_shm"):
                try:
                    del self._ctrl, self._data, self._obs_views
                except AttributeError:
                    pass
                self._shm.close()
                self._shm.unlink()
            raise
        self._closed = False
        atexit.register(self.close)

    @property
    def pids(self) -> t.List[int]:
        """The worker processes' pids, env ``i``'s at ``i``."""
        return [p.pid for p in self._procs]

    # ------------------------------------------------------------ plumbing

    def _spawn_workers(self, ctx, n, env_name, base_seed, seed_stride):
        for i in range(n):
            parent_conn, child_conn = ctx.Pipe()
            p = ctx.Process(
                target=_worker_main,
                args=(i, env_name, base_seed + seed_stride * i, child_conn, self._env_kwargs),
                daemon=True,
                name=f"tac-env-{i}",
            )
            p.start()
            child_conn.close()
            self._conns.append(parent_conn)
            self._procs.append(p)

    def _recv(self, i: int, expect: str):
        if not self._conns[i].poll(self.timeout_ms / 1000):
            raise RuntimeError(
                f"env worker {i} did not respond during handshake "
                f"(alive={self._procs[i].is_alive()})"
            )
        tag, payload = self._conns[i].recv()
        if tag == "error":
            raise RuntimeError(f"env worker {i} failed:\n{payload}")
        assert tag == expect, (tag, expect)
        return payload

    def _addr(self, i: int, word: int) -> int:
        return self._ctrl_base + (i * CTRL_STRIDE + word) * 4

    def _dispatch(self, workers: t.Sequence[int], cmd: int):
        for i in workers:
            self._ctrl[i * CTRL_STRIDE + _CMD] = cmd
            seq = int(self._ctrl[i * CTRL_STRIDE + _SEQ]) + 1
            self._lib.tac_store_wake(self._addr(i, _SEQ), seq)

    def _diagnose(self, i: int) -> t.NoReturn:
        alive = self._procs[i].is_alive()
        detail = ""
        try:
            if self._conns[i].poll(0):
                tag, payload = self._conns[i].recv()
                if tag == "error":
                    detail = f"\nworker traceback:\n{payload}"
        except (EOFError, OSError):  # pipe died with the worker
            pass
        if alive:
            state = "hung"
        else:
            # Reap first so exitcode is populated (a SIGKILLed child is
            # a zombie until joined); negative exitcode == -signal.
            self._procs[i].join(timeout=1)
            state = f"died (exitcode {self._procs[i].exitcode})"
        raise RuntimeError(
            f"env worker {i} {state} "
            f"(env={self.env_name}, timeout={self.timeout_ms}ms){detail}"
        )

    def _wait(self, workers: t.Sequence[int]):
        if list(workers) == list(range(self.n)):
            r = self._lib.tac_wait_all_eq(
                self._addr(0, _ACK), self._addr(0, _SEQ), self.n, CTRL_STRIDE,
                self.timeout_ms,
            )
            if r != 0:
                self._diagnose(-r - 1)
        else:
            for i in workers:
                want = int(self._ctrl[i * CTRL_STRIDE + _SEQ])
                while True:
                    got = int(self._lib.tac_load(self._addr(i, _ACK)))
                    if got == want:
                        break
                    if self._lib.tac_wait_ne(self._addr(i, _ACK), got, self.timeout_ms) != 0:
                        self._diagnose(i)
        for i in workers:
            if self._ctrl[i * CTRL_STRIDE + _ERR]:
                self._diagnose(i)

    def _obs_stacked(self):
        return _rebuild_obs(self._kind, [np.array(v) for v in self._obs_views])

    def _obs_row(self, i: int):
        return _rebuild_obs(self._kind, [np.array(v[i]) for v in self._obs_views])

    # ------------------------------------------------------------- protocol

    def reset_all(self, seeds: t.Sequence[int | None] | None = None):
        seeds = seeds or [None] * self.n
        self._data["seeds"][:] = [-1 if s is None else s for s in seeds]
        self._dispatch(range(self.n), CMD_RESET)
        self._wait(range(self.n))
        return self._obs_stacked()

    def reset_at(self, i: int, seed: int | None = None):
        self._data["seeds"][i] = -1 if seed is None else seed
        self._dispatch([i], CMD_RESET)
        self._wait([i])
        return self._obs_row(i)

    def step(self, actions: np.ndarray):
        self._data["actions"][:] = actions
        self._dispatch(range(self.n), CMD_STEP)
        self._wait(range(self.n))
        return (
            self._obs_stacked(),
            np.array(self._data["rewards"]),
            np.array(self._data["terminated"], bool),
            np.array(self._data["truncated"], bool),
        )

    def step_at(self, i: int, action: np.ndarray):
        self._data["actions"][i] = action
        self._dispatch([i], CMD_STEP)
        self._wait([i])
        return (
            self._obs_row(i),
            float(self._data["rewards"][i]),
            bool(self._data["terminated"][i]),
            bool(self._data["truncated"][i]),
        )

    def sample_actions(self) -> np.ndarray:
        """Uniform warm-up actions, drawn parent-side: these envs all have
        symmetric bounded Box spaces."""
        return self._rng.uniform(
            -self.act_limit, self.act_limit, (self.n, self.act_dim)
        ).astype(np.float32)

    def render_at(self, i: int):
        self._dispatch([i], CMD_RENDER)
        self._wait([i])

    def close(self):
        """Bounded teardown, safe after worker death: every wait below
        carries a timeout and escalates (CLOSE -> terminate -> kill), so
        a worker that died mid-episode, or one wedged inside an env step,
        can never hang shutdown."""
        if getattr(self, "_closed", True):
            return
        self._closed = True
        atexit.unregister(self.close)
        try:
            # A worker that died mid-episode may have left a traceback in
            # its pipe: surface it as a warning.
            for i, conn in enumerate(self._conns):
                try:
                    if conn.poll(0):
                        tag, payload = conn.recv()
                        if tag == "error":
                            logger.warning("env worker %d reported during close:\n%s",
                                           i, payload)
                except (EOFError, OSError):  # died without a message
                    pass
            live = [i for i, p in enumerate(self._procs) if p.is_alive()]
            self._dispatch(live, CMD_CLOSE)
            for p in self._procs:
                p.join(timeout=2)
            for escalate in ("terminate", "kill"):
                stragglers = [p for p in self._procs if p.is_alive()]
                if not stragglers:
                    break
                for p in stragglers:
                    getattr(p, escalate)()
                for p in stragglers:
                    p.join(timeout=2)
            dead = {i: p.exitcode for i, p in enumerate(self._procs)
                    if p.exitcode not in (0, None)}
            if dead:
                logger.warning(
                    "env workers exited abnormally: %s",
                    ", ".join(f"worker {i}: exitcode {c}" for i, c in dead.items()),
                )
        finally:
            for conn in self._conns:
                conn.close()
            del self._ctrl, self._data, self._obs_views
            self._shm.close()
            try:
                self._shm.unlink()
            except FileNotFoundError:  # pragma: no cover
                pass


def make_env_pool(
    env_name: str,
    n: int,
    base_seed: int = 0,
    parallel: bool = False,
    **kwargs,
):
    """Pool factory; falls back to sequential when the native runtime is
    unavailable (with a warning) or the pool has a single env (process
    overhead > win)."""
    if parallel and n > 1:
        from torch_actor_critic_tpu_torch.native import load_runtime

        if load_runtime() is not None:
            return ParallelEnvPool(env_name, n, base_seed=base_seed, **kwargs)
        logger.warning(
            "parallel_envs requested but native runtime unavailable; "
            "using SequentialEnvPool"
        )
    return SequentialEnvPool(env_name, n, base_seed=base_seed, **kwargs)
