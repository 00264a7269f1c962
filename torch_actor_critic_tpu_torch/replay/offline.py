"""``train --offline``: regularized SAC from a disk tier, no env (port of
``replay/offline.py``).

The flywheel's consuming end. A :class:`~.diskstore.DiskTier` written by
either producer — the trainer's spill path or the serve-side
:class:`~.flywheel.TransitionLogger`, of either package — becomes the
whole dataset: its chunks load into host RAM once, a host
``numpy.random.default_rng(seed)`` draws each burst's index batches (the
JAX package's draws, bitwise), and the learner runs bursts of
regularized SAC updates. There is no ring: the dataset is the buffer.

Naive SAC on a fixed dataset overestimates Q off-support;
``offline_reg`` counters it:

- ``bc``: a behavior-cloning anchor on the actor,
  ``weight · mean((π(s) − a_data)²)`` added to the policy loss;
- ``cql``: a conservative penalty on the critic,
  ``weight · mean(logsumexp_a Q(s, a) − Q(s, a_data))`` over
  :data:`CQL_NUM_RANDOM` uniform proposals plus one policy action;
- ``none``: plain :meth:`~..sac.algorithm.SAC.update` steps.

The CQL candidates are folded into the batch: one critic call over
``(K + 1)·B`` rows (the states repeated, candidate-major), where the
JAX package ``vmap`` s the critic over the ``K + 1`` action sets; on the
sequence critic that is one attention call a layer on ``(num_qs·(K +
1)·B, H, T, d)`` views. ``Q(s, a_data)`` is the critic loss's own
forward (the JAX package evaluates it a second time). Noise and
proposals come from the learner's generator (critic noise, policy noise,
then for ``cql`` the proposals and the policy action's noise);
:meth:`OfflineLearner.update` takes them as keyword hooks so tests
inject the JAX package's draws.

A burst's ``(K, B, ...)`` batches are copied into a device staging
tensor at a fixed address, with one pinned ``non_blocking`` copy per
leaf (the pinned buffer is rewritten only once its last copy has
completed); each update reads its slice at the burst's device counter.
On the card the burst is replays of one captured update
(:class:`~..sac.graph.BurstGraph`, watchdog source
``train/offline_burst``), as the online burst; the last, shorter burst
replays the same graph. The CPU, and ``eager=True``, run the same
update eagerly. With a telemetry recorder the first update is counted
once (``train/offline_update``) and the burst's cost registered as
``train/offline_burst``.
"""

from __future__ import annotations

import logging
import typing as t

import numpy as np
import torch

from torch_actor_critic_tpu_torch.core.types import Batch, MultiObservation, tree_map
from torch_actor_critic_tpu_torch.diagnostics.ingraph import host_read
from torch_actor_critic_tpu_torch.ops.polyak import polyak_update_
from torch_actor_critic_tpu_torch.replay.diskstore import (
    DiskTier,
    obs_spec_from_json,
    rows_count,
    rows_to_batch,
    slice_rows,
)
from torch_actor_critic_tpu_torch.sac import losses
from torch_actor_critic_tpu_torch.sac.algorithm import (
    Metrics,
    _set_grads,
    _step,
    dynamic_lr_step,
    state_key,
)
from torch_actor_critic_tpu_torch.sac.graph import BurstGraph, MetricStack
from torch_actor_critic_tpu_torch.telemetry.costmodel import get_cost_registry
from torch_actor_critic_tpu_torch.utils.config import SACConfig
from torch_actor_critic_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["CQL_NUM_RANDOM", "OFFLINE_REGULARIZERS", "OfflineLearner", "train_offline"]

OFFLINE_REGULARIZERS = ("none", "bc", "cql")

# Uniform action proposals per state for the CQL logsumexp (plus one
# policy action), as in the JAX package.
CQL_NUM_RANDOM = 4

# The cost registry's names of one offline update and of one burst of them.
UPDATE_COST, BURST_COST = "train/offline_update", "train/offline_burst"


def obs_shapes(obs_spec: t.Any) -> t.Any:
    """A spec's shapes, as ``build_models`` takes them."""
    if isinstance(obs_spec, MultiObservation):
        return obs_spec.map(lambda s: tuple(s.shape))
    return tuple(obs_spec.shape)


def _repeat(obs: t.Any, n: int) -> t.Any:
    """``n`` copies of a batch of observations along the batch axis."""
    return tree_map(lambda x: x.repeat(n, *([1] * (x.dim() - 1))), obs)


class OfflineLearner:
    """Regularized SAC over a fixed host-resident dataset: the models
    (from ``seed``, as the trainer builds them), the learner
    (:meth:`state`; its generator from ``seed + 1``) and the burst."""

    burst_cost_name = BURST_COST

    def __init__(
        self,
        config: SACConfig,
        obs_spec: t.Any,
        act_dim: int,
        act_limit: float = 1.0,
        device: str | torch.device | None = None,
        seed: int = 0,
    ):
        from torch_actor_critic_tpu_torch.models import build_models
        from torch_actor_critic_tpu_torch.sac.trainer import make_learner

        if config.offline_reg not in OFFLINE_REGULARIZERS:
            raise ValueError(
                f"offline_reg must be one of {OFFLINE_REGULARIZERS}, "
                f"got {config.offline_reg!r}"
            )
        if config.offline_reg != "none" and config.algorithm != "sac":
            raise ValueError(
                f"offline_reg={config.offline_reg!r} regularizes SAC's squashed-Gaussian "
                f"policy; algorithm={config.algorithm!r} takes offline_reg='none'")
        self.config = config
        self.obs_spec = obs_spec
        self.act_dim = int(act_dim)
        self.act_limit = float(act_limit)
        self.device = resolve_device(device)
        actor, critic = build_models(config, obs_shapes(obs_spec), self.act_dim,
                                     self.act_limit,
                                     generator=torch.Generator().manual_seed(seed))
        self.sac = make_learner(config, self.act_dim)
        self.state = self.sac.init_state(
            actor.to(self.device), critic.to(self.device),
            torch.Generator(device=self.device).manual_seed(seed + 1))
        # Updates a burst holds (the last burst may hold fewer).
        self.burst_len = max(1, min(config.update_every, config.offline_steps))
        self.graph: BurstGraph | None = None
        self.graph_captures = 0
        self._staging: Batch | None = None  # (burst_len, B, ...) on the device
        self._pinned: Batch | None = None  # its pinned host twin (the card only)
        self._copied: torch.cuda.Event | None = None

    # ------------------------------------------------------------- update

    def update(
        self,
        state,
        batch: Batch,
        eps_q: torch.Tensor | None = None,
        eps_pi: torch.Tensor | None = None,
        proposals: torch.Tensor | None = None,
        eps_cql: torch.Tensor | None = None,
    ) -> t.Tuple[t.Any, Metrics]:
        """One regularized step: ``offline_reg="none"`` is
        :meth:`SAC.update`; ``bc``/``cql`` run the same critic → actor →
        temperature → polyak sequence with the penalty in the
        regularized loss. Hooks (default: draws from
        ``state.generator``, in this order): ``eps_q``, ``eps_pi``
        ``(B, act_dim)``; for ``cql``, ``proposals`` ``(K, B, act_dim)``
        uniform in ``[-act_limit, act_limit)`` and ``eps_cql`` ``(B,
        act_dim)``, the policy action's noise."""
        cfg = self.config
        reg = cfg.offline_reg
        if reg == "none":
            return self.sac.update(state, batch, eps_q=eps_q, eps_pi=eps_pi)
        gen, shape = state.generator, batch.actions.shape
        device = batch.actions.device

        def normal(eps):
            return eps if eps is not None else torch.randn(shape, generator=gen, device=device)

        eps_q, eps_pi = normal(eps_q), normal(eps_pi)
        if reg == "cql":
            if proposals is None:
                proposals = (torch.rand((CQL_NUM_RANDOM, *shape), generator=gen, device=device)
                             * (2 * self.act_limit) - self.act_limit)
            eps_cql = normal(eps_cql)
        weight = float(cfg.offline_reg_weight)
        alpha = state.log_alpha.detach().exp() if cfg.learn_alpha else cfg.alpha

        # --- critic step (+ the CQL gap) ---
        q_params = list(state.critic.parameters())
        loss_q, q_aux = losses.critic_loss(
            state.critic, actor=state.actor, target_critic=state.target_critic,
            batch=batch, alpha=alpha, gamma=cfg.gamma, reward_scale=cfg.reward_scale,
            eps=eps_q, keep_q=reg == "cql",
        )
        if reg == "cql":
            gap = self._cql_gap(state, batch, q_aux.pop("q"), proposals, eps_cql)
            loss_q = loss_q + weight * gap
            q_aux["offline/cql_gap"] = gap.detach()
        _set_grads(q_params, torch.autograd.grad(loss_q, q_params))
        dynamic_lr_step(state.q_opt, None)

        # --- actor step (+ the BC anchor), on the updated, frozen critic ---
        pi_params = list(state.actor.parameters())
        state.critic.requires_grad_(False)
        try:
            pi, logp_pi = state.actor(batch.next_states if cfg.parity_pi_obs else batch.states,
                                      eps=eps_pi)
            q_pi = state.critic(batch.states, pi)
            loss_pi = (alpha * logp_pi - q_pi.amin(dim=0)).mean()
            logp = logp_pi.detach().mean()
            pi_aux = {"logp_pi": logp, "entropy": -logp}
            if reg == "bc":
                bc = ((pi - batch.actions) ** 2).mean()
                loss_pi = loss_pi + weight * bc
                pi_aux["offline/bc_mse"] = bc.detach()
            pi_grads = torch.autograd.grad(loss_pi, pi_params)
        finally:
            state.critic.requires_grad_(True)
        _set_grads(pi_params, pi_grads)
        dynamic_lr_step(state.pi_opt, None)

        # --- temperature (as online) ---
        if cfg.learn_alpha:
            (a_grad,) = torch.autograd.grad(
                losses.alpha_loss(state.log_alpha, pi_aux["logp_pi"], self.sac.target_entropy),
                [state.log_alpha],
            )
            state.log_alpha.grad = a_grad
            _step(state.alpha_opt)
            alpha_metric = state.log_alpha.detach().exp()
        else:
            alpha_metric = torch.full((), cfg.alpha, device=device)

        polyak_update_(state.critic.parameters(), state.target_critic.parameters(), cfg.polyak)
        state.device_step.add_(1)
        state.step += 1
        return state, {"loss_q": loss_q.detach(), "loss_pi": loss_pi.detach(),
                       "alpha": alpha_metric, **q_aux, **pi_aux}

    def _cql_gap(self, state, batch: Batch, q_data: torch.Tensor, proposals: torch.Tensor,
                 eps_cql: torch.Tensor) -> torch.Tensor:
        """``mean(logsumexp over the K + 1 candidates of Q(s, a) −
        Q(s, a_data))``: the candidates (the proposals, then the current
        policy's action, no gradient through it) as one critic call over
        ``(K + 1)·B`` rows."""
        with torch.no_grad():
            pi_actions, _ = state.actor(batch.states, eps=eps_cql)
        cand = torch.cat([proposals, pi_actions[None]])  # (K + 1, B, act_dim)
        k1, b = cand.shape[:2]
        q_cand = state.critic(_repeat(batch.states, k1), cand.reshape(k1 * b, -1))
        lse = torch.logsumexp(q_cand.reshape(q_cand.shape[0], k1, b), dim=1)  # (num_qs, B)
        return (lse - q_data).mean()

    # -------------------------------------------------------------- burst

    def stage(self, batches: Batch) -> int:
        """Copy a burst's host batches (numpy or CPU tensors, ``(k, B,
        ...)``, ``k <= burst_len``) into the device staging tensors;
        returns ``k``."""
        k = int(batches.rewards.shape[0])
        if not 1 <= k <= self.burst_len:
            raise ValueError(f"a burst of {k} updates; this learner's bursts hold "
                             f"1..{self.burst_len}")
        host = batches.map(torch.as_tensor)
        if self._staging is None:
            def alloc(x, **kw):
                return torch.empty((self.burst_len, *x.shape[1:]), dtype=x.dtype, **kw)

            self._staging = host.map(lambda x: alloc(x, device=self.device))
            if self.device.type == "cuda":
                self._pinned = host.map(lambda x: alloc(x, pin_memory=True))
                self._copied = torch.cuda.Event()
        if self._pinned is None:
            for dst, src in zip(self._staging.leaves(), host.leaves(), strict=True):
                dst[:k].copy_(src)
            return k
        # The pinned buffer is rewritten only once its last copy is done;
        # the copy is ordered after the last burst's replays (one stream).
        self._copied.synchronize()
        for pin, dev, src in zip(self._pinned.leaves(), self._staging.leaves(), host.leaves(),
                                 strict=True):
            pin[:k].copy_(src)
            dev[:k].copy_(pin[:k], non_blocking=True)
        self._copied.record()
        return k

    def _step_fn(self, stack: MetricStack) -> None:
        """One update as the burst graph captures it: the batch at the
        stack's device counter, the update, its metrics into the stack."""
        with self.sac.cost.scope():
            batch = self._staging.map(lambda x: x.index_select(0, stack.step).squeeze(0))
            _, metrics = self.update(self.state, batch)
        stack.write(metrics)

    def burst(self, batches: Batch, eager: bool = False) -> Metrics:
        """One burst over ``batches`` (``(k, B, ...)`` on the host): staged,
        then ``k`` updates — replays of the captured update on the card,
        the same update eagerly on the CPU or with ``eager``; returns the
        metrics reduced over the burst (device tensors)."""
        k = self.stage(batches)
        state = self.state
        if eager or self.device.type != "cuda":
            stack = MetricStack(self.burst_len, self.device)
            for _ in range(k):
                self._step_fn(stack)
            return stack.reduce(k)
        key = (*state_key(state), *self._staging.leaves())
        graph = self.graph
        if graph is None or not graph.serves(key, k):
            self.graph = None  # its memory pool goes before the next capture
            graph = BurstGraph(self._step_fn, key, self.burst_len, state.generator,
                               source=self.burst_cost_name)
        step = state.step
        try:
            metrics = graph.run(k)
        finally:
            state.step = step + graph.ran  # the capture counted a step it did not run
        if graph is not self.graph:
            graph.key = (*state_key(state), *self._staging.leaves())  # with Adam's state
            self.graph = graph
            self.graph_captures += 1
        return metrics


# ------------------------------------------------------------------- run


def _stack_batches(
    rows: t.Mapping[str, np.ndarray],
    sampler: np.random.Generator,
    num_updates: int,
    batch_size: int,
) -> Batch:
    """``num_updates`` independent uniform batches, stacked into one
    ``(num_updates, B, ...)`` host Batch (one host→device copy per
    burst); the draws are the JAX package's."""
    n = rows_count(rows)
    idx = sampler.integers(0, n, size=num_updates * batch_size)
    lead = (num_updates, batch_size)
    return rows_to_batch(slice_rows(rows, idx)).map(
        lambda x: np.asarray(x).reshape(lead + x.shape[1:]))


def load_dataset(directory: str) -> t.Tuple[dict, t.Any, int, float]:
    """A disk tier as ``(rows, obs_spec, act_dim, act_limit)``: every
    resident row (manifest order) and the geometry its ``meta.json``
    records."""
    tier = DiskTier(directory)
    try:
        meta = tier.meta
        if meta is None:
            raise ValueError(
                f"offline dataset {directory!r} has no meta.json (not a replay disk tier?)")
        rows = tier.read_all()
        if rows_count(rows) == 0:
            raise ValueError(f"offline dataset {directory!r} is empty")
        return (rows, obs_spec_from_json(meta["obs"]), int(meta["act_dim"]),
                float(meta.get("act_limit", 1.0)))
    finally:
        tier.close()


def train_offline(
    config: SACConfig,
    tracker=None,
    checkpointer=None,
    seed: int = 0,
    telemetry=None,
    device: str | torch.device | None = None,
    on_epoch: t.Callable[[int, dict], None] | None = None,
) -> dict:
    """The ``train --offline`` entry: disk tier in, checkpoint out (the
    port's format, with the JAX package's ``offline`` meta, so ``run_agent
    --run`` and ``serve --run`` load it). ``offline_steps`` updates in
    bursts of ``min(update_every, offline_steps)``; one metrics row per
    burst (``on_epoch(burst, row)``, the tracker's metrics, a telemetry
    ``offline`` event). Returns the last row (host floats)."""
    if not config.offline_dataset:
        raise ValueError("--offline requires --offline-dataset DIR")
    rows, obs_spec, act_dim, act_limit = load_dataset(config.offline_dataset)
    n_rows = rows_count(rows)
    learner = OfflineLearner(config, obs_spec, act_dim, act_limit, device=device, seed=seed)
    if telemetry is not None:
        learner.sac.cost.request(UPDATE_COST)
    sampler = np.random.default_rng(seed)
    total = int(config.offline_steps)
    logger.info("offline: %d rows, %d steps (bursts of %d), reg=%s(%.3g)", n_rows, total,
                learner.burst_len, config.offline_reg, config.offline_reg_weight)
    done_steps, epoch = 0, 0
    last_metrics: dict = {}
    while done_steps < total:
        k = min(learner.burst_len, total - done_steps)
        metrics = learner.burst(_stack_batches(rows, sampler, k, config.batch_size))
        done_steps += k
        if telemetry is not None and epoch == 0:
            update = get_cost_registry().get(UPDATE_COST)
            if update is not None:
                get_cost_registry().register(BURST_COST, {
                    "flops": update["flops"] * learner.burst_len,
                    "bytes_accessed": update["bytes_accessed"] * learner.burst_len})
        last_metrics = {m: float(v) for m, v in host_read(
            {m: v for m, v in metrics.items() if v.dim() == 0}).items()}
        last_metrics["offline/steps"] = float(done_steps)
        last_metrics["offline/dataset_rows"] = float(n_rows)
        if tracker is not None:
            tracker.log_metrics(last_metrics, epoch)
        if telemetry is not None:
            telemetry.event("offline", epoch=epoch, steps=done_steps,
                            loss_q=last_metrics.get("loss_q"),
                            loss_pi=last_metrics.get("loss_pi"))
        if on_epoch is not None:
            on_epoch(epoch, dict(last_metrics))
        epoch += 1

    if checkpointer is not None:
        checkpointer.save(
            epoch, learner.state, None,
            extra={
                "config": config.to_json(),
                "offline": {"dataset": config.offline_dataset, "steps": done_steps,
                            "reg": config.offline_reg},
                "step": done_steps,
            },
            wait=True,
        )
    return last_metrics
