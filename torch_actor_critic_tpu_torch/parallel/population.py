"""The host-loop population (port of ``parallel/population.py``'s
``PopulationLearner``): ``P`` independent learners advanced by one
member-stacked learner, which the host :class:`~..sac.trainer.Trainer`
drives when ``population > 1`` without ``on_device``.

The learner is :class:`~..sac.population.PopulationSAC` or
:class:`~..sac.population.PopulationTD3` (every parameter, Adam moment
and metric with the member axis first; each member's loss its own), its
rings ``(P, capacity, ...)`` pushed at one cursor. This class builds the
state and the rings and acts; the burst and the warm-up push are the
learner's own (:meth:`~..sac.algorithm.Learner.update_burst`,
:func:`~..buffer.replay.push`), which take the member axis as it comes.
Where the JAX package ``vmap`` s the solo burst and jits it per
``num_updates``, here a burst on the card is the solo learner's CUDA
graph, one for all members: one captured update, replayed
``num_updates`` times, so bursts of alternating sizes replay the graph
captured for the largest (the learner's ``graph_captures`` counts the
captures). Each attention layer is one K2/K3/K4 launch for every
member, each visual update one K1 launch.

Members share nothing: their own initial models (member ``i`` from
:func:`~..sac.population.member_seed`), rings, Adam states and metrics;
a member's draws (rows, update noise, shifts, acting noise) are its
slice of one population-wide draw. ``mesh`` raises: the member axis
over devices is not ported.
"""

from __future__ import annotations

import torch

from torch_actor_critic_tpu_torch.buffer.replay import (
    init_replay_buffer,
    init_visual_replay_buffer,
    warn_if_buffer_exceeds_hbm,
)
from torch_actor_critic_tpu_torch.core.types import (
    BufferState,
    MultiObservation,
    TrainState,
    tree_map,
)
from torch_actor_critic_tpu_torch.models.population import build_population_models
from torch_actor_critic_tpu_torch.sac.algorithm import Learner
from torch_actor_critic_tpu_torch.sac.population import member_seed


class PopulationLearner:
    """``n_members`` independent learners over one member-stacked
    ``learner`` (``learner.members == n_members``). All states carry a
    leading member axis."""

    def __init__(self, learner: Learner, n_members: int, mesh=None):
        if n_members < 1:
            raise ValueError(f"n_members must be >= 1, got {n_members}")
        if mesh is not None:
            raise NotImplementedError(
                "the population's member axis over a mesh is not ported yet; train the "
                "population on one device")
        if getattr(learner, "members", None) != n_members:
            raise ValueError(f"the learner holds {getattr(learner, 'members', None)} members, "
                             f"not {n_members}")
        self.learner = learner
        self.config = learner.config
        self.n_members = n_members

    def init_state(self, seed: int, obs_shape, act_dim: int, act_limit: float,
                   device: torch.device) -> TrainState:
        """Member ``i``'s models from :func:`member_seed` ``(seed, i)`` (member
        0 as a lone learner seeded ``seed``), the learner's generator
        ``seed + 1``, as the fused population."""
        gens = [torch.Generator().manual_seed(member_seed(seed, i))
                for i in range(self.n_members)]
        actor, critic = build_population_models(self.config, obs_shape, act_dim, act_limit, gens)
        return self.learner.init_state(actor.to(device), critic.to(device),
                                       torch.Generator(device=device).manual_seed(seed + 1))

    def init_buffer(self, capacity_per_member: int, obs_shape, act_dim: int,
                    device: torch.device) -> BufferState:
        """Member-stacked rings ``(P, capacity, ...)``: each member owns
        its full ``capacity`` rows, so the device memory scales with
        ``P`` (warned about at ``capacity · P``)."""
        warn_if_buffer_exceeds_hbm(capacity_per_member * self.n_members, obs_shape, act_dim,
                                   device, advice="reduce --buffer-size or --population")
        if isinstance(obs_shape, MultiObservation):
            (features,) = obs_shape.features
            return init_visual_replay_buffer(capacity_per_member, features, obs_shape.frame,
                                             act_dim, device, members=self.n_members)
        return init_replay_buffer(capacity_per_member, obs_shape, act_dim, device,
                                  members=self.n_members)

    @torch.inference_mode()
    def select_action(self, state: TrainState, obs, generator: torch.Generator | None = None,
                      deterministic: bool = False,
                      actor: torch.nn.Module | None = None) -> torch.Tensor:
        """Member ``i``'s policy acts on observation row ``i``: ``obs``
        ``(P, ...)`` on the device goes through the stacked actor as a
        ``(P, 1, ...)`` batch (a sequence member's acting: one K2 launch
        a layer for all members); returns ``(P, act_dim)``. The noise is
        one ``(P, 1, act_dim)`` draw from ``generator``. ``actor``, when
        given, acts instead of ``state.actor`` (the trainer's acting
        snapshot under ``actor_param_lag``)."""
        obs = tree_map(lambda x: x[:, None], obs)
        actor = state.actor if actor is None else actor
        action, _ = actor(obs, generator=None if deterministic else generator,
                          deterministic=deterministic, with_logprob=False)
        return action[:, 0]
