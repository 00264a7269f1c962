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
                                # ptr, size
    <dir>/epoch_<N>/meta.json   # {"epoch", "ckpt_format", and the trainer's
                                # extra: "step", "config", "normalizer",
                                # "act_key", ...}

``meta.json`` is written last, so an epoch whose meta is missing or
unreadable is a half-written save and is skipped (:meth:`Checkpointer.
latest_epoch`). Files are written with ``torch.save`` from host copies
and read with ``torch.load(weights_only=True, map_location="cpu")``, so
a checkpoint written on the card restores on the CPU and the reverse.
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
import time
import typing as t
from pathlib import Path

import torch

from torch_actor_critic_tpu_torch.buffer.replay import load_buffer_
from torch_actor_critic_tpu_torch.core.types import BufferState, TrainState
from torch_actor_critic_tpu_torch.resilience.retry import call_with_retries

logger = logging.getLogger(__name__)

__all__ = [
    "CKPT_FORMAT", "CheckpointFormatError", "Checkpointer", "save_actor",
    "latest_epoch", "restore_actor_params",
]

# The full-state layout's version, bumped on any change to state.pt's or
# buffer.pt's structure. Actor-only epochs (save_actor) carry none.
CKPT_FORMAT = 1
# Epochs a Checkpointer keeps, newest first (the JAX package's default):
# the newest is the rollback target, and a 10^6-row ring is ~0.4 GB a save.
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
    :meth:`wait`, :meth:`close`. Saves are synchronous and keep the
    :data:`MAX_TO_KEEP` newest epochs. IO is retried with backoff
    (``resilience/retry.py``)."""

    def __init__(
        self,
        directory: str | Path,
        retries: int = 2,
        retry_backoff_s: float = 0.5,
        sleep: t.Callable[[float], None] = time.sleep,
    ):
        self.directory = Path(directory).absolute()
        self._retries = int(retries)
        self._retry_backoff_s = float(retry_backoff_s)
        self._sleep = sleep

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
    ) -> Path:
        """Write ``epoch``'s full state (and the ring, when given) from
        host copies, meta last; then drop the epochs beyond
        :data:`MAX_TO_KEEP`. Returns the epoch dir."""
        files = {"actor.pt": _host_copy(state.actor.state_dict()),
                 "state.pt": state.state_dict()}
        if buffer is not None:
            files["buffer.pt"] = buffer.state_dict()
        meta = dict(extra or {}, epoch=int(epoch), ckpt_format=CKPT_FORMAT)
        out = self._retry(lambda: self._write_epoch(epoch, files, meta),
                          what=f"checkpoint save (epoch {epoch})")
        for old in _all_epochs(self.directory)[MAX_TO_KEEP:]:
            shutil.rmtree(_epoch_dir(self.directory, old), ignore_errors=True)
        return out

    def _write_epoch(self, epoch: int, files: t.Mapping[str, t.Any], meta: dict) -> Path:
        out = _epoch_dir(self.directory, epoch)
        out.mkdir(parents=True, exist_ok=True)
        (out / "meta.json").unlink(missing_ok=True)  # incomplete until rewritten
        for name, obj in files.items():
            torch.save(obj, out / name)
        _write_meta(out, meta)
        return out

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

    def _read(self, epoch: int, include_buffer: bool) -> t.Tuple[dict, dict | None, dict]:
        """``(state dict, ring dict or None, meta)`` of ``epoch``, all on
        the host; nothing is applied."""
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
        if include_buffer:
            buffer = self._retry(lambda: self._read_file(out / "buffer.pt"),
                                 what=f"replay restore (epoch {epoch})")
        return state, buffer, meta

    def restore(
        self,
        state: TrainState,
        buffer: BufferState | None = None,
        epoch: int | None = None,
    ) -> t.Tuple[TrainState, BufferState | None, dict]:
        """Restore ``(state, buffer, meta)`` in place: the networks,
        target, Adam states, ``log_alpha``, step count and generator of
        ``state`` (:meth:`~..core.types.TrainState.load_state_dict_`),
        and, when ``buffer`` is given, the ring
        (:func:`~..buffer.replay.load_buffer_`).

        ``epoch=None`` takes the newest epoch, falling back past one
        whose meta or files fail to read (a save cut short): losing one
        ``save_every`` interval beats losing the run. An explicit epoch
        never falls back. Every file is read before anything is
        written, so a failed read leaves the live state untouched."""
        include_buffer = buffer is not None
        if epoch is not None:
            saved = self._read(epoch, include_buffer)
        else:
            saved, last_err = None, None
            for candidate in _valid_epochs(self.directory, self._meta):
                try:
                    saved = self._read(candidate, include_buffer)
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
        state.load_state_dict_(saved_state)
        if saved_buffer is not None:
            buffer = load_buffer_(buffer, saved_buffer)
        return state, buffer, meta

    def restore_actor_params(self, epoch: int | None = None):
        return self._retry(
            lambda: restore_actor_params(self.directory, epoch),
            what=f"actor restore (epoch {epoch})",
        )

    def refresh(self) -> None:
        """Nothing cached: every read lists the directory afresh."""

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing held open."""
