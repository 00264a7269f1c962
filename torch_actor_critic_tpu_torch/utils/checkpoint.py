"""The port's checkpoints: the complete training state, and the actor
the serving registry reads.

Orbax (the JAX package's format) cannot be read without JAX, so the
port keeps its own layout, one directory per epoch::

    <dir>/epoch_<N>/actor.pt    # the actor's state_dict: what serving reads
    <dir>/epoch_<N>/state.pt    # TrainState.state_dict(): the three
                                # networks, the three Adam states with their
                                # step tensors, log_alpha, the gradient-step
                                # count and the learner generator's state
    <dir>/epoch_<N>/buffer.pt   # BufferState.state_dict(): ring rows [0, size),
                                # ptr, size (absent with save_buffer=False)
    <dir>/epoch_<N>/arrays.pt   # save(arrays=): a population's env states,
                                # acting generator and PBT state (absent
                                # without them)
    <dir>/epoch_<N>/meta.json   # {"epoch", "ckpt_format", "buffer" (whether
                                # buffer.pt was written), and the trainer's
                                # extra: "step", "config", "normalizer",
                                # "act_key", ...}

``meta.json`` is written last, so an epoch whose meta is missing or
unreadable is a half-written save and is skipped (:meth:`Checkpointer.
latest_epoch`). Files are written with ``torch.save`` from host copies
and read with ``torch.load(weights_only=True, map_location="cpu")``, so
a checkpoint written on the card restores on the CPU and the reverse.

:meth:`Checkpointer.save` is asynchronous unless ``wait=True``, as the
JAX ``Checkpointer``'s: it takes the host copies on the calling thread
(the next update rewrites the parameters, the Adam states and the ring
in place), removes the epoch's old meta, and leaves the files and the
meta to one background writer. The ring is copied into host buffers the
checkpointer keeps across saves (pinned for a ring on the card), one per
leaf, so a large ring costs no new host allocation per save.
:meth:`Checkpointer.wait` joins the writer; a second save waits for the
first; a write that fails after the retries raises out of the next
``save`` or ``wait``. ``save_buffer=False`` writes no ``buffer.pt``: a
restore then leaves the live ring as it is (empty in a new process), as
in JAX. ``save(arrays=)`` and ``restore(abstract_arrays=)`` carry the
rest of a run's state, as JAX's do: each named object (an env state
batch, a :class:`~..core.types.PBTState`, or a ``torch.Generator``) is
snapshotted by its ``state_dict()`` (a generator by ``get_state()``) and
restored in place. :func:`export_member_checkpoint` writes one member
of a population checkpoint as a standalone learner's.
:meth:`Checkpointer.restore` writes into the live state in place
(:meth:`~..core.types.TrainState.load_state_dict_`,
:func:`~..buffer.replay.load_buffer_`): a captured burst's CUDA graph
holds those tensors' addresses. With ``epoch=None`` it falls back past
an epoch whose meta or files fail to read; an explicit epoch never
falls back. Every read and write goes through
:func:`~..resilience.retry.call_with_retries`.

:func:`save_actor` writes an actor-only epoch (``actor.pt`` +
``meta.json``) for callers without a learner; the serving read path
(``latest_epoch``, ``restore_actor_params``, ``refresh``, ``close``)
reads either kind and returns ``(state_dict, meta)`` with ``meta``
carrying ``epoch`` and the config JSON under ``config``, as the JAX
registry and CLI read them.
"""

from __future__ import annotations

import json
import logging
import re
import shutil
import threading
import time
import typing as t
from pathlib import Path

import torch

from torch_actor_critic_tpu_torch.buffer.replay import load_buffer_
from torch_actor_critic_tpu_torch.core.types import BufferState, TrainState
from torch_actor_critic_tpu_torch.resilience.retry import call_with_retries

logger = logging.getLogger(__name__)

__all__ = [
    "CKPT_FORMAT", "CheckpointFormatError", "Checkpointer", "export_member_checkpoint",
    "save_actor", "latest_epoch", "restore_actor_params",
]

# The full-state layout's version, bumped on any change to state.pt's or
# buffer.pt's structure. Actor-only epochs (save_actor) carry none.
CKPT_FORMAT = 1
# Epochs a Checkpointer keeps, newest first (the JAX package's default):
# the newest is the rollback target, and a 10^6-row ring is ~0.4 GB a save
# (~6.1 GB for the pixel twins' uint8 frames).
MAX_TO_KEEP = 3

_EPOCH_DIR = re.compile(r"^epoch_(\d+)$")


class CheckpointFormatError(ValueError):
    """The epoch holds no full state this build reads (an actor-only
    epoch, or another ``ckpt_format``). Not retried and not fallen back
    from: every epoch of a run shares its writer's format."""


def _epoch_dir(directory: Path, epoch: int) -> Path:
    return directory / f"epoch_{int(epoch)}"


def _read_meta(directory: Path, epoch: int) -> dict:
    return json.loads((_epoch_dir(directory, epoch) / "meta.json").read_text())


def _write_meta(out: Path, meta: dict) -> None:
    tmp = out / "meta.json.tmp"
    tmp.write_text(json.dumps(meta))
    tmp.replace(out / "meta.json")  # last: its presence marks a complete save


def _load(path: Path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _snapshot(obj) -> t.Any:
    """A host snapshot of a named array object: a generator's state, or
    the object's ``state_dict()``."""
    return obj.get_state() if isinstance(obj, torch.Generator) else obj.state_dict()


def _restore_(obj, saved) -> None:
    if isinstance(obj, torch.Generator):
        obj.set_state(saved)
    else:
        obj.load_state_dict_(saved)


def _host_copy(state: t.Mapping[str, torch.Tensor]) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in state.items()}


def save_actor(
    directory: str | Path,
    epoch: int,
    actor: torch.nn.Module | t.Mapping[str, torch.Tensor],
    config=None,
    extra: t.Mapping[str, t.Any] | None = None,
) -> Path:
    """Write ``epoch``'s actor state dict and meta (an actor-only
    epoch); returns the epoch dir. ``config`` (a ``SACConfig``) is
    stored as JSON under ``config``."""
    state = actor.state_dict() if isinstance(actor, torch.nn.Module) else actor
    out = _epoch_dir(Path(directory), epoch)
    out.mkdir(parents=True, exist_ok=True)
    torch.save(_host_copy(state), out / "actor.pt")
    meta = dict(extra or {}, epoch=int(epoch))
    if config is not None:
        meta["config"] = config.to_json()
    _write_meta(out, meta)
    return out


def _all_epochs(directory: Path) -> t.List[int]:
    """Every epoch directory's number, newest first."""
    if not directory.is_dir():
        return []
    return sorted(
        (int(m.group(1)) for p in directory.iterdir() if (m := _EPOCH_DIR.match(p.name))),
        reverse=True,
    )


def _valid_epochs(directory: Path, read_meta=None) -> t.Iterator[int]:
    """Epochs newest-first whose meta reads."""
    read_meta = read_meta or (lambda epoch: _read_meta(directory, epoch))
    for epoch in _all_epochs(directory):
        try:
            read_meta(epoch)
        except (OSError, ValueError) as e:
            logger.warning(
                "checkpoint epoch %s under %s is unreadable (%s); skipping it",
                epoch, directory, e,
            )
            continue
        yield epoch


def latest_epoch(directory: str | Path) -> int | None:
    """Newest readable epoch under ``directory`` (None when none)."""
    return next(_valid_epochs(Path(directory)), None)


def restore_actor_params(
    directory: str | Path, epoch: int | None = None
) -> t.Tuple[t.Dict[str, torch.Tensor], dict]:
    """``(state_dict on CPU, meta)`` of ``epoch`` (newest readable when
    None, falling back past epochs whose arrays fail to load)."""
    directory = Path(directory)
    if epoch is not None:
        state = _load(_epoch_dir(directory, epoch) / "actor.pt")
        return state, dict(_read_meta(directory, epoch), epoch=int(epoch))
    last_err: Exception | None = None
    for step in _valid_epochs(directory):
        try:
            return restore_actor_params(directory, step)
        except (OSError, RuntimeError, ValueError) as e:
            logger.warning(
                "actor restore from epoch %d under %s failed (%s); "
                "falling back to the previous epoch", step, directory, e,
            )
            last_err = e
    if last_err is not None:
        raise last_err
    raise FileNotFoundError(f"no checkpoints under {directory}")


class Checkpointer:
    """Full-state checkpoints of one run under ``directory``, with the
    JAX ``Checkpointer``'s surface: :meth:`save`, :meth:`peek_meta`,
    :meth:`latest_epoch`, :meth:`restore`, :meth:`restore_actor_params`,
    :meth:`wait`, :meth:`close`. Saves are asynchronous unless
    ``wait=True`` and keep the :data:`MAX_TO_KEEP` newest epochs;
    ``save_buffer=False`` leaves the ring out. IO is retried with
    backoff (``resilience/retry.py``)."""

    def __init__(
        self,
        directory: str | Path,
        save_buffer: bool = True,
        retries: int = 2,
        retry_backoff_s: float = 0.5,
        sleep: t.Callable[[float], None] = time.sleep,
    ):
        self.directory = Path(directory).absolute()
        self.save_buffer = bool(save_buffer)
        self._retries = int(retries)
        self._retry_backoff_s = float(retry_backoff_s)
        self._sleep = sleep
        self._writer: threading.Thread | None = None
        self._write_error: BaseException | None = None
        self._host_ring: t.Dict[str, torch.Tensor] = {}  # reused across saves
        # Seconds the newest finished write took (files, meta and the
        # pruning of old epochs), off the training thread unless ``wait``.
        self.last_write_s: float | None = None
        # Seconds the newest save blocked on the write before it.
        self.last_wait_s: float = 0.0

    def _retry(self, fn, what: str):
        return call_with_retries(
            fn, attempts=self._retries + 1,
            base_delay_s=self._retry_backoff_s, sleep=self._sleep, what=what,
        )

    # ---------------------------------------------------------------- write

    def save(
        self,
        epoch: int,
        state: TrainState,
        buffer: BufferState | None = None,
        extra: t.Mapping[str, t.Any] | None = None,
        wait: bool = False,
        arrays: t.Mapping[str, t.Any] | None = None,
    ) -> Path:
        """Write ``epoch``'s full state (and the ring, when given and
        ``save_buffer``; and ``arrays``, named objects with a
        ``state_dict()`` or generators), meta last; then drop the epochs
        beyond :data:`MAX_TO_KEEP`. Returns the epoch dir.

        First waits for the save in flight (raising its error; the wait's
        seconds are :attr:`last_wait_s`). The host copies are complete
        when this returns; the files are written by a background writer
        unless ``wait``, which writes them here and raises a failed
        write's error."""
        t0 = time.perf_counter()
        self.wait()
        self.last_wait_s = time.perf_counter() - t0
        files = {"actor.pt": _host_copy(state.actor.state_dict()),
                 "state.pt": state.state_dict()}
        if buffer is not None and self.save_buffer:
            files["buffer.pt"] = buffer.state_dict(host=self._host_ring)
        if arrays is not None:
            files["arrays.pt"] = {k: _snapshot(v) for k, v in arrays.items()}
        meta = dict(extra or {}, epoch=int(epoch), ckpt_format=CKPT_FORMAT,
                    buffer="buffer.pt" in files)
        out = _epoch_dir(self.directory, epoch)
        # Incomplete until the writer rewrites it: latest_epoch skips it now.
        (out / "meta.json").unlink(missing_ok=True)

        def write() -> None:
            t0 = time.perf_counter()
            self._retry(lambda: self._write_epoch(epoch, files, meta),
                        what=f"checkpoint save (epoch {epoch})")
            for old in _all_epochs(self.directory)[MAX_TO_KEEP:]:
                shutil.rmtree(_epoch_dir(self.directory, old), ignore_errors=True)
            self.last_write_s = time.perf_counter() - t0

        if wait:
            write()
        else:
            self._writer = threading.Thread(target=self._run_writer, args=(write,),
                                            name=f"checkpoint-epoch-{epoch}")
            self._writer.start()
        return out

    def _run_writer(self, write: t.Callable[[], None]) -> None:
        try:
            write()
        except Exception as e:  # noqa: BLE001 — the next save or wait raises it
            self._write_error = e

    def _write_epoch(self, epoch: int, files: t.Mapping[str, t.Any], meta: dict) -> Path:
        out = _epoch_dir(self.directory, epoch)
        out.mkdir(parents=True, exist_ok=True)
        (out / "meta.json").unlink(missing_ok=True)  # incomplete until rewritten
        for name, obj in files.items():
            torch.save(obj, out / name)
        _write_meta(out, meta)
        return out

    def wait(self) -> None:
        """Join the save in flight; raise its write error, once."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        error, self._write_error = self._write_error, None
        if error is not None:
            raise error

    # ----------------------------------------------------------------- read

    # The raw IO, each call retried by its caller.

    def _read_json(self, epoch: int) -> dict:
        return _read_meta(self.directory, epoch)

    def _read_file(self, path: Path):
        return _load(path)

    def _meta(self, epoch: int) -> dict:
        return self._retry(lambda: self._read_json(epoch),
                           what=f"checkpoint metadata read (epoch {epoch})")

    def latest_epoch(self) -> int | None:
        """Newest epoch whose meta reads (a half-written newest epoch is
        skipped with a warning)."""
        return next(_valid_epochs(self.directory, self._meta), None)

    def peek_meta(self, epoch: int | None = None) -> dict:
        """The epoch's ``meta.json`` alone (``epoch=None``: the newest
        readable one), so callers can check what wrote it before any
        array is read."""
        epoch = epoch if epoch is not None else self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return dict(self._meta(epoch), epoch=int(epoch))

    def _read(self, epoch: int, include_buffer: bool,
              include_arrays: bool = False) -> t.Tuple[dict, dict | None, dict]:
        """``(state dict, ring dict or None, meta)`` of ``epoch``, all on
        the host (with ``include_arrays``, ``arrays.pt`` under the meta's
        ``_arrays``); nothing is applied."""
        meta = self.peek_meta(epoch)
        found = meta.get("ckpt_format")
        if found != CKPT_FORMAT:
            raise CheckpointFormatError(
                f"checkpoint at {self.directory} epoch {epoch} has format {found!r}; "
                f"this build reads full-state format {CKPT_FORMAT} (an actor-only "
                "epoch, written by save_actor, holds no learner state)"
            )
        out = _epoch_dir(self.directory, epoch)
        state = self._retry(lambda: self._read_file(out / "state.pt"),
                            what=f"checkpoint restore (epoch {epoch})")
        buffer = None
        if include_buffer and meta.get("buffer", True):
            buffer = self._retry(lambda: self._read_file(out / "buffer.pt"),
                                 what=f"replay restore (epoch {epoch})")
        if include_arrays:
            arrays = self._retry(lambda: self._read_file(out / "arrays.pt"),
                                 what=f"arrays restore (epoch {epoch})")
            meta = dict(meta, _arrays=arrays)
        return state, buffer, meta

    def restore(
        self,
        state: TrainState,
        buffer: BufferState | None = None,
        epoch: int | None = None,
        abstract_arrays: t.Mapping[str, t.Any] | None = None,
    ) -> tuple:
        """Restore ``(state, buffer, meta)`` in place: the networks,
        target, Adam states, ``log_alpha``, step count and generator of
        ``state`` (:meth:`~..core.types.TrainState.load_state_dict_`),
        and, when ``buffer`` is given and the epoch holds a ring, the ring
        (:func:`~..buffer.replay.load_buffer_`; an epoch saved with
        ``save_buffer=False`` leaves ``buffer`` as it is). With
        ``abstract_arrays`` (the live objects :meth:`save`'s ``arrays``
        named), each is restored in place too and the result is a
        4-tuple ending with them.

        ``epoch=None`` takes the newest epoch, falling back past one
        whose meta or files fail to read (a save cut short): losing one
        ``save_every`` interval beats losing the run. An explicit epoch
        never falls back. Every file is read before anything is
        written, so a failed read leaves the live state untouched."""
        include_buffer = buffer is not None
        include_arrays = abstract_arrays is not None
        if epoch is not None:
            saved = self._read(epoch, include_buffer, include_arrays)
        else:
            saved, last_err = None, None
            for candidate in _valid_epochs(self.directory, self._meta):
                try:
                    saved = self._read(candidate, include_buffer, include_arrays)
                    break
                except CheckpointFormatError:
                    raise
                except Exception as e:  # noqa: BLE001 — any failed read makes
                    # the epoch unusable, whatever torch.load raises for it
                    logger.warning(
                        "checkpoint epoch %d under %s failed to restore (%s: %s); "
                        "falling back to the previous epoch",
                        candidate, self.directory, type(e).__name__, e,
                    )
                    last_err = e
            if saved is None:
                if last_err is not None:
                    raise last_err
                raise FileNotFoundError(f"no checkpoints under {self.directory}")
        saved_state, saved_buffer, meta = saved
        saved_arrays = meta.pop("_arrays", None)
        if include_arrays and set(saved_arrays) != set(abstract_arrays):
            raise ValueError(f"checkpoint arrays {sorted(saved_arrays)} != "
                             f"{sorted(abstract_arrays)}")
        state.load_state_dict_(saved_state)
        if saved_buffer is not None:
            buffer = load_buffer_(buffer, saved_buffer)
        if not include_arrays:
            return state, buffer, meta
        for name, live in abstract_arrays.items():
            _restore_(live, saved_arrays[name])
        return state, buffer, meta, abstract_arrays

    def restore_actor_params(self, epoch: int | None = None):
        return self._retry(
            lambda: restore_actor_params(self.directory, epoch),
            what=f"actor restore (epoch {epoch})",
        )

    def refresh(self) -> None:
        """Nothing cached: every read lists the directory afresh."""

    def close(self) -> None:
        """Join the save in flight (raising its error)."""
        self.wait()


# The state.pt entries whose tensors carry a population's member axis.
_MEMBER_MODULES = ("actor", "critic", "target_critic", "target_actor")
_MEMBER_OPTS = ("pi_opt", "q_opt", "alpha_opt")


def member_state_dict(saved: t.Mapping[str, t.Any], member: int) -> dict:
    """Member ``member``'s standalone learner snapshot from a
    population's :meth:`~..core.types.TrainState.state_dict`: slice
    ``member`` of every network tensor, Adam moment and ``log_alpha``
    (Adam's 0-d ``step``, the step counts and the generator are the
    population's lockstep ones); the hyperparameters are dropped (a
    standalone learner reads its config)."""
    out = {k: v for k, v in saved.items() if k != "hyperparams"}
    for name in _MEMBER_MODULES:
        if name in saved:
            out[name] = {k: v[member].clone() for k, v in saved[name].items()}
    for name in _MEMBER_OPTS:
        opt = saved[name]
        out[name] = {"param_groups": opt["param_groups"],
                     "state": {i: {k: v[member].clone() if v.dim() else v.clone()
                                   for k, v in st.items()}
                               for i, st in opt["state"].items()}}
    out["log_alpha"] = saved["log_alpha"][member].clone()
    return out


def export_member_checkpoint(
    src_directory: str | Path,
    dst_directory: str | Path,
    member: int | None = None,
    epoch: int | None = None,
) -> t.Tuple[int, int]:
    """Write one member of a population checkpoint as a standalone
    learner's full-state epoch (``actor.pt``, ``state.pt``,
    ``meta.json``; no ring) under ``dst_directory``, which the serving
    CLI, ``run_agent`` and a standalone :meth:`Checkpointer.restore`
    read. ``member=None`` picks the best member by the checkpoint's PBT
    return EMA (member 0 when the run kept none). The meta's config has
    ``population=1`` and ``pbt_every=0``, and ``exported_member`` names
    the member. Returns ``(member, epoch)``."""
    from torch_actor_critic_tpu_torch.utils.config import SACConfig

    src = Checkpointer(src_directory, save_buffer=False)
    epoch = epoch if epoch is not None else src.latest_epoch()
    if epoch is None:
        raise FileNotFoundError(f"no checkpoints under {src.directory}")
    saved, _, meta = src._read(epoch, include_buffer=False)
    population = int(meta.get("population", 1))
    if population < 2:
        raise ValueError(f"checkpoint at {src.directory} epoch {epoch} is not a population "
                         f"checkpoint (population={population})")
    if member is None:
        ema = (meta.get("pbt") or {}).get("return_ema")
        member = max(range(population), key=lambda i: ema[i]) if ema else 0
    if not 0 <= member < population:
        raise ValueError(f"member {member} out of range for population {population}")
    state = member_state_dict(saved, member)
    config = SACConfig.from_json(meta["config"]).replace(population=1, pbt_every=0)
    out = _epoch_dir(Path(dst_directory), epoch)
    out.mkdir(parents=True, exist_ok=True)
    torch.save(state["actor"], out / "actor.pt")
    torch.save(state, out / "state.pt")
    _write_meta(out, {"epoch": int(epoch), "ckpt_format": CKPT_FORMAT, "buffer": False,
                      "config": config.to_json(), "step": meta.get("step", 0),
                      "exported_member": member, "population": population})
    return member, int(epoch)
