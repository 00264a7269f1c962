"""aot/: the pre-forked warm worker pool of the serve fleet.

Of the JAX package's ``aot/`` (warm-start bundles, the persistent
compilation cache, the bundle manifest, the warm pool) the port has the
pool (:mod:`~torch_actor_critic_tpu_torch.aot.prefork`, ``serve
--warm-pool N``): scale-up and kill-replacement draw an already-warm
worker instead of paying spawn, import and graph captures on the
serving path. ``--warm-start`` and ``--compile-cache`` wait for ROADMAP
queue 1 item 10.
"""

from torch_actor_critic_tpu_torch.aot.prefork import WarmPool, WarmWorker

__all__ = ["WarmPool", "WarmWorker"]
