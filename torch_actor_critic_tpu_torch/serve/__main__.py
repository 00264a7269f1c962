"""Policy-inference service CLI of the port (counterpart of ``serve.py``).

    python -m torch_actor_critic_tpu_torch.serve --ckpt-dir DIR \\
        --obs-dim 3 --act-dim 1 --act-limit 2.0 --port 0 [--device cuda|cpu]

Serves the newest epoch of a port actor checkpoint
(:mod:`torch_actor_critic_tpu_torch.utils.checkpoint`) over HTTP, with
hot-reload polling, and prints ``{"serving": <url>, "slots": ...}`` on
one line once it accepts requests. The model geometry comes from the
checkpoint's stored config; a config with ``history_len > 1`` is a
sequence policy served over ``(history_len, obs_dim)`` observations, as
the trainer builds it. SIGTERM drains (answers every accepted request)
and exits 0.

The single-process subset of ``serve.py``'s flags; ``--run``, fleets,
sub-meshes, precision tiers, warm starts, the flywheel and trace export
are not ported yet. Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import logging

logger = logging.getLogger("serve")


def parse_arguments(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("Batched policy-inference service (PyTorch port).")
    src = p.add_argument_group("model source")
    src.add_argument("--ckpt-dir", type=str, required=True,
                     help="Port actor checkpoint dir (epoch_<N>/actor.pt + meta.json)")
    src.add_argument("--obs-dim", type=int, required=True)
    src.add_argument("--act-dim", type=int, required=True)
    src.add_argument("--act-limit", type=float, default=1.0)
    srv = p.add_argument_group("serving")
    srv.add_argument("--device", default=None,
                     help="torch device; default cuda (fails without a GPU)")
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument("--port", type=int, default=8321)
    srv.add_argument("--max-batch", type=int, default=64)
    srv.add_argument("--max-wait-ms", type=float, default=2.0)
    srv.add_argument("--batch-mode", choices=("continuous", "group"),
                     default="continuous")
    srv.add_argument("--buckets", type=str, default=None,
                     help="Comma-separated bucket sizes (default: powers "
                          "of two from 2 up to max-batch)")
    srv.add_argument("--poll-interval", type=float, default=5.0,
                     help="Checkpoint hot-reload poll seconds (0 = off)")
    srv.add_argument("--seed", type=int, default=0,
                     help="Seed of the sampled-action generator")
    srv.add_argument("--request-timeout", type=float, default=30.0)
    srv.add_argument("--act-timeout", type=float, default=30.0)
    ovl = p.add_argument_group("overload & degradation")
    ovl.add_argument("--queue-capacity", type=int, default=1024)
    ovl.add_argument("--breaker-threshold", type=int, default=5)
    ovl.add_argument("--breaker-cooldown", type=float, default=5.0)
    ovl.add_argument("--reload-retries", type=int, default=1)
    ovl.add_argument("--reload-retry-backoff", type=float, default=0.5)
    ovl.add_argument("--drain-timeout", type=float, default=30.0)
    return p.parse_args(argv)


def obs_spec_for(config, obs_dim: int):
    """The served observation spec: ``(history_len, obs_dim)`` for a
    sequence policy (``history_len > 1``), else ``(obs_dim,)``."""
    import numpy as np

    from torch_actor_critic_tpu_torch.serve.engine import ObsSpec

    shape = (
        (config.history_len, obs_dim) if config.history_len > 1 else (obs_dim,)
    )
    return ObsSpec(shape, np.float32)


def build_server(args: argparse.Namespace):
    """Registry + warmed slot + (not yet started) server from parsed
    CLI args: the path :func:`main` serves, shared with smoke scripts.
    Returns ``(server, info)``."""
    from torch_actor_critic_tpu_torch.models import build_actor
    from torch_actor_critic_tpu_torch.serve import (
        CircuitBreaker,
        ModelRegistry,
        PolicyServer,
    )
    from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer
    from torch_actor_critic_tpu_torch.utils.config import SACConfig

    meta = Checkpointer(args.ckpt_dir).peek_meta()
    config = (
        SACConfig.from_json(meta["config"]) if meta.get("config") else SACConfig()
    )
    obs_spec = obs_spec_for(config, args.obs_dim)
    actor_def = build_actor(config, obs_spec.shape, args.act_dim, args.act_limit)
    buckets = (
        [int(b) for b in args.buckets.split(",")] if args.buckets else None
    )
    registry = ModelRegistry(
        reload_retries=args.reload_retries,
        reload_retry_backoff_s=args.reload_retry_backoff,
        device=args.device,
    )
    info = registry.register(
        "default", actor_def, obs_spec,
        ckpt_dir=args.ckpt_dir, max_batch=args.max_batch, buckets=buckets,
        breaker=CircuitBreaker(
            fail_threshold=args.breaker_threshold,
            cooldown_s=args.breaker_cooldown,
        ),
    )
    if args.poll_interval > 0:
        registry.start_polling(args.poll_interval)
    server = PolicyServer(
        registry, host=args.host, port=args.port,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        seed=args.seed,
        request_timeout_s=args.request_timeout,
        act_timeout_s=args.act_timeout,
        capacity=args.queue_capacity,
        mode=args.batch_mode,
    )
    return server, info


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_arguments(argv)
    from torch_actor_critic_tpu_torch.serve import install_drain_handler

    server, info = build_server(args)
    logger.info("model loaded: %s", info)
    install_drain_handler(server, flush_timeout_s=args.drain_timeout)
    print(json.dumps({
        "serving": server.address, "slots": server.registry.slots(),
    }), flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
