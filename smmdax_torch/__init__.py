"""smmdax_torch: the PyTorch / CUDA port of smmdax for NVIDIA Hopper.

The JAX package ``smmdax`` is the reference this port is held against;
the port imports nothing of it.  Public functions keep its layouts
(NHWC images, (B, d) features), and its entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""

from smmdax_torch.configs import Config  # noqa: F401
