"""PyTorch + CUDA port of :mod:`torch_actor_critic_tpu` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module
layout and names so each counterpart is found at the same path. It
imports ``torch``, numpy and the standard library only — never JAX and
never a module of the JAX package (tests/test_torch_serve.py pins it).

It serves a causal-transformer (sequence) policy over HTTP and trains
it with SAC on one device, the attention's forward and backward in
hand-written CUDA kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``,
wrapped by :mod:`.ops.attention`).
"""

import torch

# Full-f32 matmuls and convolutions: the parity tolerances against the
# JAX reference (1e-5 on CPU, 1e-4 on the card) assume no TF32
# rounding. PyTorch's matmul default is already False; cuDNN's is True.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
