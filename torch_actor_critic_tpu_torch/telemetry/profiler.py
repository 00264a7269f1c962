"""``torch.profiler`` integration: an epoch-windowed device trace (port
of ``telemetry/profiler.py``).

- :func:`parse_profile_epochs` — the ``--profile-epochs A:B`` syntax
  (half-open, python-slice style; a bare ``A`` means one epoch), the
  JAX function unchanged.
- :class:`ProfilerWindow` — starts a ``torch.profiler`` trace at the
  first epoch inside the window and stops it after the last, writing a
  Chrome trace (``chrome://tracing``, https://ui.perfetto.dev) under
  the run directory's ``trace/``. Resume-aware as JAX's: a run restored
  inside the window starts capturing at once, and :meth:`close` stops a
  trace left open by a short or preempted run.

A trace covers the device only for a run on a CUDA device
(``device=``); a run on the CPU traces the host alone, card or no card.
The card's profiler can lose a trace's first kernels and, past its
buffer, its end (ROADMAP "Profiler traces can come back empty"), so a
trace on the card opens with :func:`trace_lead_in` (empty kernels to
lose) and closes with :func:`trace_tail` (a spin kernel whose absence
shows a lost end); the entry point raises Kineto's device buffer once,
before the process's first trace (:func:`trace_buffers`).
``chip_smoke.py`` takes its traces the same way.
"""

from __future__ import annotations

import logging
import os
import tempfile
import time
import typing as t

import torch

logger = logging.getLogger(__name__)

__all__ = ["ProfilerWindow", "parse_profile_epochs", "start_profile", "stop_profile",
           "trace_buffers", "trace_lead_in", "trace_tail"]


def parse_profile_epochs(spec: str | None) -> t.Optional[t.Tuple[int, int]]:
    """``"A:B"`` -> ``(A, B)`` (half-open); ``"A"`` -> ``(A, A+1)``;
    ``None``/empty -> ``None`` (no profiling)."""
    if not spec:
        return None
    parts = spec.split(":")
    try:
        if len(parts) == 1:
            a = int(parts[0])
            b = a + 1
        elif len(parts) == 2:
            a, b = int(parts[0]), int(parts[1])
        else:
            raise ValueError(spec)
    except ValueError:
        raise ValueError(
            f"--profile-epochs expects 'A:B' or 'A' (epochs, half-open), got {spec!r}"
        ) from None
    if a < 0 or b <= a:
        raise ValueError(f"--profile-epochs window must satisfy 0 <= A < B, got {spec!r}")
    return a, b


def trace_lead_in(n: int = 32) -> None:
    """The start of a trace on the card: ``n`` empty kernels
    (``csrc/floor.cu``), a synchronize and 20 ms of host sleep. The
    card's profiler can lose a trace's first kernels (one K1 launch of
    an eager visual burst's 50, in each of two runs); this gives it
    kernels to lose."""
    from torch_actor_critic_tpu_torch.ops import _kernels

    fn = _kernels.load("empty")
    device = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(device).cuda_stream
    for _ in range(n):
        _kernels.launch("empty", fn, device, (1, 32, 0, stream), "lead-in")
    torch.cuda.synchronize()
    time.sleep(0.02)


def trace_tail() -> None:
    """The end of a trace on the card: one spin kernel
    (``torch.cuda._sleep``) on the current stream after the traced work,
    and a synchronize. A trace that lost its end lacks it."""
    torch.cuda._sleep(1)
    torch.cuda.synchronize()


def trace_buffers(mb: int = 1024, directory: str | None = None) -> None:
    """Lets the profiler (Kineto) keep ``mb`` MB of device records in a
    trace, where it keeps 128 MB by default and can stop recording past
    them (a traced 1000-step on-device sequence epoch holds about
    916,000 kernels, near that default). Kineto holds the size in bytes
    in a 32-bit int, so ``mb`` stays below 2048 (4096 wraps to 0 MB).
    Kineto reads the file that ``KINETO_CONFIG`` names when the
    process's first trace starts, and child processes inherit it; the
    file goes into ``directory`` (a new temporary one by default)."""
    directory = directory or tempfile.mkdtemp(prefix="tac_kineto_")
    os.makedirs(directory, exist_ok=True)
    conf = os.path.join(directory, "kineto.conf")
    with open(conf, "w") as f:
        f.write(f"ACTIVITIES_MAX_GPU_BUFFER_SIZE_MB={mb}\n")
    os.environ["KINETO_CONFIG"] = conf


def _on_card(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def start_profile(device=None) -> "torch.profiler.profile":
    """A started ``torch.profiler`` trace of the host and, for a CUDA
    ``device``, of the card (opened with :func:`trace_lead_in`)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = _on_card(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
    prof.start()
    if cuda:
        trace_lead_in()
    return prof


def stop_profile(prof, path: str, device=None) -> str:
    """Close a :func:`start_profile` trace (:func:`trace_tail` first for
    a CUDA ``device``) and write it to ``path`` as a Chrome trace."""
    if _on_card(device):
        trace_tail()
    prof.stop()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
    return path


class ProfilerWindow:
    """Capture one trace over the epoch window ``[start, stop)`` into
    ``log_dir`` (``trace_epochs_<start>_<stop>.json``): the host and,
    for a CUDA ``device`` (the run's), the card."""

    def __init__(
        self,
        epochs: t.Optional[t.Tuple[int, int]],
        log_dir: str | os.PathLike | None,
        device=None,
    ):
        self.window = tuple(int(e) for e in epochs) if epochs else None
        self.log_dir = str(log_dir) if log_dir is not None else None
        self.enabled = self.window is not None and self.log_dir is not None
        if epochs and self.log_dir is None:
            logger.warning(
                "--profile-epochs %s ignored: no run directory to write "
                "the trace into (tracking disabled?)", epochs,
            )
        self.device = device
        self.path: str | None = None
        self._prof = None
        self._done = False

    def epoch_begin(self, epoch: int) -> None:
        if not self.enabled or self._prof is not None or self._done:
            return
        start, stop = self.window
        if start <= epoch < stop:
            self._prof = start_profile(self.device)
            logger.info("profiler: trace started at epoch %d (window %d:%d) -> %s",
                        epoch, start, stop, self.log_dir)

    def epoch_end(self, epoch: int) -> None:
        if self._prof is not None and epoch >= self.window[1] - 1:
            self._stop()

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        start, stop = self.window
        self.path = stop_profile(
            prof, os.path.join(self.log_dir, f"trace_epochs_{start}_{stop}.json"), self.device)
        self._done = True
        logger.info("profiler: trace written to %s", self.path)

    def close(self) -> None:
        """Finalize a still-open trace (run ended inside the window)."""
        if self._prof is not None:
            self._stop()
