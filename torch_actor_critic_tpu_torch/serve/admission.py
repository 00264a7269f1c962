"""Admission-control error taxonomy for the serving plane.

Under overload a service has exactly three honest answers: do the work,
reject it *now* with a signal the client can act on, or (worst) accept
it and fail it later after burning resources nobody benefits from. The
seed batcher only knew the first and third — an unbounded queue grew
host memory without bound under any sustained burst past service rate,
and a request whose client had already timed out still occupied the
queue and a device forward. These exceptions are the vocabulary of the
second answer; every one carries a machine-readable ``reason`` and a
``retry_after_s`` hint so the HTTP frontend can map it onto the
standard overload contract (429/503 + ``Retry-After``,
docs/SERVING.md "Overload & degradation"):

- ``queue_full`` / ``deadline_infeasible`` — rejected at submit time
  (the server's fault domain is healthy, the *rate* is not): HTTP 429.
- ``expired`` — accepted but purged at group-collection time because
  the request's own deadline passed while it was queued; the device never
  ran it. Surfaces as 503 (the client already waited its budget).
- ``draining`` — the process is shutting down and not admitting new
  work: HTTP 503 (a load balancer should route elsewhere).
- ``breaker_open`` (:class:`BreakerOpenError`) — the slot's engine is
  tripped (:mod:`~torch_actor_critic_tpu_torch.serve.breaker`): HTTP 503.
  From an :class:`~torch_actor_critic_tpu.serve.fleet.EngineFleet`
  this means EVERY replica's breaker refused — one tripped replica is
  silently routed around.

The fleet router (:mod:`~torch_actor_critic_tpu.serve.router`) adds
two reasons of its own on the wire, both 503 + ``Retry-After``:
``no_workers`` (every worker ejected from membership) and
``worker_unreachable`` (the last proxy attempt died at the connection
level after failover exhausted the admitted set).

:class:`NonFiniteActionError` is the engine-side fault the breaker
counts: the forward's own on-device all-finite reduction (the
divergence sentinel's predicate) found NaN/inf in the action output —
poisoned params or a numerics bug, never a client error.
"""

from __future__ import annotations

import typing as t

__all__ = [
    "ShedError",
    "BreakerOpenError",
    "NonFiniteActionError",
    "SUBMIT_SHED_REASONS",
]

# Reasons rejected before the request entered the queue — the 429
# family (client should back off and retry); everything else is 503.
SUBMIT_SHED_REASONS = ("queue_full", "deadline_infeasible")


class ShedError(RuntimeError):
    """A request rejected (or purged) by admission control.

    ``reason`` is one of ``queue_full``, ``deadline_infeasible``,
    ``expired``, ``draining``, ``breaker_open``; ``retry_after_s`` is
    the server's best estimate of when retrying could succeed (the
    ``Retry-After`` header, floored at 1 s on the wire).
    """

    def __init__(
        self,
        reason: str,
        message: str,
        retry_after_s: float = 1.0,
        detail: t.Mapping[str, t.Any] | None = None,
    ):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = float(retry_after_s)
        self.detail = dict(detail or {})

    def to_payload(self) -> dict:
        """The structured JSON body the HTTP frontend answers with."""
        return dict(
            self.detail,
            error=str(self),
            reason=self.reason,
            retry_after_s=round(self.retry_after_s, 3),
        )


class BreakerOpenError(ShedError):
    """The slot's circuit breaker is open (or its half-open probe quota
    is spent): fail fast with 503 instead of queueing work the engine
    would only fail slowly."""

    def __init__(self, slot: str, retry_after_s: float, state: str):
        super().__init__(
            "breaker_open",
            f"model slot {slot!r} circuit breaker is {state}; "
            "the engine is failing and traffic is shed until a probe "
            "succeeds",
            retry_after_s=retry_after_s,
            detail={"slot": slot, "breaker_state": state},
        )
        self.slot = slot
        self.state = state


class NonFiniteActionError(RuntimeError):
    """The engine forward produced NaN/inf action rows (detected by the
    in-graph fused all-finite reduction). Counted as an engine failure
    by the circuit breaker — a response containing NaN must never reach
    a client."""

    def __init__(self, bucket: int, deterministic: bool):
        super().__init__(
            f"policy forward returned non-finite actions "
            f"(bucket={bucket}, deterministic={deterministic}) — "
            "poisoned params or a numerics fault; the response was "
            "withheld and the failure reported to the circuit breaker"
        )
        self.bucket = bucket
        self.deterministic = deterministic
