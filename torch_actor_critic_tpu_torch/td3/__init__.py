"""TD3 (Twin Delayed DDPG), the second algorithm family (port of
``td3/``): the same state, replay, burst and trainer as SAC, selected
with ``SACConfig.algorithm = "td3"`` (``--algorithm td3``)."""

from torch_actor_critic_tpu_torch.td3 import losses  # noqa: F401
from torch_actor_critic_tpu_torch.td3.algorithm import TD3  # noqa: F401
