"""The port's actor checkpoints: what the serving registry reads.

Orbax (the JAX package's format) cannot be read without JAX, so the
port keeps its own layout, one directory per epoch::

    <dir>/epoch_<N>/actor.pt     # the actor's state_dict (torch.save)
    <dir>/epoch_<N>/meta.json    # {"epoch": N, "config": "<SACConfig JSON>", ...}

``meta.json`` is written last, so an epoch whose meta is missing or
unreadable is a half-written save and is skipped. The registry uses
:class:`Checkpointer` through the same method names as the JAX one
(``latest_epoch``, ``restore_actor_params``, ``refresh``, ``close``);
``restore_actor_params`` returns ``(state_dict, meta)`` with ``meta``
carrying ``epoch`` and the config JSON under ``config``, as the JAX
registry and CLI read them.
"""

from __future__ import annotations

import json
import logging
import re
import time
import typing as t
from pathlib import Path

import torch

from torch_actor_critic_tpu_torch.resilience.retry import call_with_retries

logger = logging.getLogger(__name__)

__all__ = ["Checkpointer", "save_actor", "latest_epoch", "restore_actor_params"]

_EPOCH_DIR = re.compile(r"^epoch_(\d+)$")


def _epoch_dir(directory: Path, epoch: int) -> Path:
    return directory / f"epoch_{int(epoch)}"


def _read_meta(directory: Path, epoch: int) -> dict:
    return json.loads((_epoch_dir(directory, epoch) / "meta.json").read_text())


def save_actor(
    directory: str | Path,
    epoch: int,
    actor: torch.nn.Module | t.Mapping[str, torch.Tensor],
    config=None,
    extra: t.Mapping[str, t.Any] | None = None,
) -> Path:
    """Write ``epoch``'s actor state dict and meta; returns the epoch
    dir. ``config`` (a ``SACConfig``) is stored as JSON under
    ``config``."""
    state = actor.state_dict() if isinstance(actor, torch.nn.Module) else actor
    out = _epoch_dir(Path(directory), epoch)
    out.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state.items()}, out / "actor.pt")
    meta = dict(extra or {}, epoch=int(epoch))
    if config is not None:
        meta["config"] = config.to_json()
    tmp = out / "meta.json.tmp"
    tmp.write_text(json.dumps(meta))
    tmp.replace(out / "meta.json")  # last: its presence marks a complete save
    return out


def _valid_epochs(directory: Path) -> t.Iterator[int]:
    """Epochs newest-first whose meta reads."""
    if not directory.is_dir():
        return
    epochs = sorted(
        (int(m.group(1)) for p in directory.iterdir()
         if (m := _EPOCH_DIR.match(p.name))),
        reverse=True,
    )
    for epoch in epochs:
        try:
            _read_meta(directory, epoch)
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
        state = torch.load(
            _epoch_dir(directory, epoch) / "actor.pt",
            map_location="cpu", weights_only=True,
        )
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
    """Directory handle with the JAX ``Checkpointer``'s read surface,
    IO retried with backoff (``resilience/retry.py``)."""

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

    def save(self, epoch: int, actor, config=None, extra=None) -> Path:
        return self._retry(
            lambda: save_actor(self.directory, epoch, actor, config, extra),
            what=f"checkpoint save (epoch {epoch})",
        )

    def latest_epoch(self) -> int | None:
        return latest_epoch(self.directory)

    def peek_meta(self, epoch: int | None = None) -> dict:
        epoch = epoch if epoch is not None else self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return dict(_read_meta(self.directory, epoch), epoch=int(epoch))

    def restore_actor_params(self, epoch: int | None = None):
        return self._retry(
            lambda: restore_actor_params(self.directory, epoch),
            what=f"actor restore (epoch {epoch})",
        )

    def refresh(self) -> None:
        """Nothing cached: every read lists the directory afresh."""

    def close(self) -> None:
        """Nothing held open."""
