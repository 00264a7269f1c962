"""The update burst as one device program: one update captured as a CUDA
graph and replayed for every update of a burst — the port's counterpart
of the JAX burst's ``jax.jit(lax.scan(update))``
(``torch_actor_critic_tpu/sac/algorithm.py:421-470``).

A :class:`BurstGraph` holds a step function — for SAC one whole update
and the write of its metrics (:func:`~.algorithm.update_step`). Its
first burst runs the step eagerly on a side stream
(:data:`WARMUP_UPDATES` real updates of the burst: PyTorch's CUDA-graph
rules ask for it, and it creates Adam's lazy state, loads the kernel
libraries and sets up cuBLAS's workspaces), captures one more call as a
``torch.cuda.CUDAGraph`` and replays it for the rest; every later burst
is replays only. A capture executes nothing. The step's generators are
registered with the graph (the learner's, for an update; the acting and
the env generators, for the fused loop's acting step), so every replay
draws fresh rows, shifts and noise, and leaves each generator where the
eager loop would.

The graph reads and writes fixed addresses: the parameters and Adam
states (updated in place), the replay ring and its device size (``push``
writes both in place), and a :class:`MetricStack` whose device counter
says which row a replay writes. What the update allocates comes from the
graph's private pool and is rewritten by every replay; the burst's
reduced metrics are new tensors. A failed capture or replay raises:
nothing falls back to the eager loop, and the updates that did run stay
run (:attr:`BurstGraph.ran` counts them).

A burst can also be spread over the caller's loop (:meth:`BurstGraph.
start`, then :meth:`BurstGraph.advance` as the loop goes): at most
:data:`INFLIGHT` of its replays are queued on the device at a time, so
work on another stream (the host trainer's acting under
``actor_param_lag``) runs between them instead of waiting behind the
whole burst, and the host is never held by a full launch queue.

The fused on-device loop (:mod:`.ondevice`) holds its acting step in a
second ``BurstGraph``: one vectorized env step, its transition written
as row ``step`` of the window chunk (the stack's rows), replayed once per
step of a window (:meth:`BurstGraph.play`).

The kernel wrappers count the warm-up's launches and the capture's (each
records its launch into the graph); a replay launches the graph's kernels
without calling a wrapper, so ``_kernels.launch_counts`` does not see
them: a device trace (``torch.profiler``) does.
"""

from __future__ import annotations

import collections
import gc
import typing as t

import torch

from torch_actor_critic_tpu_torch.diagnostics.ingraph import reduce_burst_metrics

WARMUP_UPDATES = 1
# Replays of a spread burst queued on the device at a time (BurstGraph.start).
INFLIGHT = 2


class MetricStack:
    """The ``(K, ...)`` metric rows of a burst of ``K`` updates and
    ``step``, the ``(1,)`` int64 device counter of the row the next
    update writes (reset before each burst). The rows are allocated at
    the first write, in its metrics' shapes and dtypes."""

    def __init__(self, num_updates: int, device: torch.device | str):
        self.num_updates = num_updates
        self.step = torch.zeros(1, dtype=torch.int64, device=device)
        self.rows: t.Dict[str, torch.Tensor] | None = None

    def write(self, metrics: t.Mapping[str, torch.Tensor]) -> None:
        """Row ``step`` of every metric, then ``step += 1``, on the
        device: a graph replays it at the counter's value."""
        if self.rows is None:
            self.rows = {k: v.new_empty((self.num_updates, *v.shape))
                         for k, v in metrics.items()}
        for k, v in metrics.items():
            self.rows[k].index_copy_(0, self.step, v.unsqueeze(0))
        self.step.add_(1)

    def reduce(self, rows: int | None = None) -> t.Dict[str, torch.Tensor]:
        """The burst's metrics (its first ``rows`` rows, all by default),
        reduced by key suffix into new tensors: the eager loop's reduction
        of the same stacked values."""
        return reduce_burst_metrics(
            self.rows if rows is None else {k: v[:rows] for k, v in self.rows.items()})


class BurstGraph:
    """``step_fn(stack)`` captured once and replayed for each of
    ``num_updates`` updates a burst. ``key`` holds the objects the
    capture read (state, modules, optimizers, ring): the graph serves a
    burst only over those same objects (:meth:`serves`), of at most
    ``num_updates`` updates (its metric stack's rows), so bursts of
    alternating sizes replay one graph. ``generators`` (one or several)
    are those the step draws from."""

    def __init__(
        self,
        step_fn: t.Callable[[MetricStack], None],
        key: t.Sequence[object],
        num_updates: int,
        generators: torch.Generator | t.Sequence[torch.Generator],
    ):
        if num_updates < WARMUP_UPDATES:
            raise ValueError(f"a captured burst needs num_updates >= {WARMUP_UPDATES}, "
                             f"got {num_updates}")
        if isinstance(generators, torch.Generator):
            generators = (generators,)
        self.key = tuple(key)
        self.num_updates = num_updates
        self.generators = tuple(generators)
        self.stack = MetricStack(num_updates, self.generators[0].device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.ran = 0  # updates the last burst ran (warm-up and replays)
        self._step_fn = step_fn
        self._todo = 0  # the burst's updates
        self._inflight: t.Deque[torch.cuda.Event] = collections.deque()

    def serves(self, key: t.Sequence[object], num_updates: int) -> bool:
        return (num_updates <= self.num_updates and len(key) == len(self.key)
                and all(a is b for a, b in zip(key, self.key)))

    def run(self, num_updates: int | None = None) -> t.Dict[str, torch.Tensor]:
        """One burst of ``num_updates`` steps (:meth:`play`); returns the
        reduced metrics."""
        self.play(num_updates)
        return self.stack.reduce(self.ran)

    def play(self, num_updates: int | None = None) -> None:
        """The counter reset, the warm-up and the capture if there is no
        graph yet, then a replay for every other step, ``num_updates``
        steps in all (at most the stack's rows; all of them by default);
        the stack's rows hold what each step wrote."""
        n = self.num_updates if num_updates is None else num_updates
        if not WARMUP_UPDATES <= n <= self.num_updates:
            raise ValueError(f"a burst of {n} steps on a graph of {self.num_updates} rows")
        self.stack.step.zero_()
        self.ran = 0
        if self.graph is None:
            self._capture()
        self._todo = n
        self.advance(wait=True)

    def start(self, num_updates: int) -> None:
        """Begin a burst of ``num_updates`` replays of the graph (which must
        exist: a capture runs in :meth:`play`) that :meth:`advance` enqueues
        as the caller's loop goes."""
        if self.graph is None or not 1 <= num_updates <= self.num_updates:
            raise ValueError(f"cannot spread a burst of {num_updates} steps over "
                             f"{'no graph' if self.graph is None else self.num_updates}")
        self.stack.step.zero_()
        self.ran = 0
        self._todo = num_updates

    def advance(self, wait: bool = False) -> None:
        """Enqueue the burst's next replays: while fewer than
        :data:`INFLIGHT` of them are unfinished on the device, or, with
        ``wait``, all that are left (the launch queue holds the host when
        full)."""
        inflight = self._inflight
        while self.ran < self._todo:
            if not wait:
                while inflight and inflight[0].query():
                    inflight.popleft()
                if len(inflight) >= INFLIGHT:
                    return
            self.graph.replay()
            self.ran += 1
            if not wait:
                inflight.append(torch.cuda.Event())
                inflight[-1].record()
        inflight.clear()

    def _capture(self) -> None:
        device = self.stack.step.device
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        try:
            with torch.cuda.stream(stream):
                for _ in range(WARMUP_UPDATES):
                    self._step_fn(self.stack)
                    self.ran += 1
            graph = torch.cuda.CUDAGraph()
            for generator in self.generators:
                graph.register_generator_state(generator)
            # A dead CUDA graph in a reference cycle is freed by the cyclic
            # collector, and freeing one while a stream captures fails the
            # capture: collect before it, and not during it.
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, stream=stream):
                    self._step_fn(self.stack)
            finally:
                if collecting:
                    gc.enable()
        finally:
            torch.cuda.current_stream(device).wait_stream(stream)
        self.graph = graph
