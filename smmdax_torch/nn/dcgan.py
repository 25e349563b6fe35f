"""DCGAN generator and critic (port of ``smmdax/nn/dcgan.py``).

The generator projects z to a base grid and doubles the resolution with
4x4 stride-2 transposed convolutions (BN + ReLU, tanh output); the critic
mirrors it with 4x4 stride-2 convolutions + lrelu(0.2) and ends in a
linear map to ``dof_dim`` features.  The number of blocks follows
``output_size`` (28 -> 2 on a 7x7 base, 32 -> 3, 64 -> 4, 160 -> 5 on a
5x5 base).

Public layout is NHWC, as in the JAX package; inside, activations are
NCHW.  The projection is reshaped as NHWC and the critic flattens NHWC
before its head, as flax does, so converted dense weights need no row
permutation.  Under a bf16 ``dtype`` the parameters stay float32, the
images come out of tanh in float32 and the features are cast to float32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from smmdax_torch.kernels.kernels import at_least_f32
from smmdax_torch.nn.layers import BatchNorm, ConvTranspose, SNConv, SNDense

Tensor = torch.Tensor

_STDDEV = 0.02          # flax normal(0.02), the DCGAN kernel init


def _base_and_blocks(output_size: int) -> Tuple[int, int]:
    """(base grid size, #stride-2 blocks) with base in {4, 5}."""
    for base in (4, 5, 3, 6, 7):
        n = output_size / base
        k = int(round(math.log2(n))) if n > 1 else 0
        if base * (2 ** k) == output_size and k >= 1:
            return base, k
    raise ValueError(f"output_size {output_size} not reachable from a 3..7 base grid")


class DCGANGenerator(nn.Module):
    def __init__(self, output_size: int = 32, c_dim: int = 3, gf_dim: int = 64,
                 z_dim: int = 128, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.base, n_up = _base_and_blocks(output_size)
        width = gf_dim * (2 ** (n_up - 1))
        self.width0 = width
        self.n_blocks = n_up - 1
        self.project = SNDense(z_dim, self.base * self.base * width, dtype=dtype,
                               stddev=_STDDEV, generator=generator)
        self.bn_in = BatchNorm(width, dtype=dtype)
        for i in range(self.n_blocks):
            setattr(self, f"deconv{i}", ConvTranspose(width, width // 2, dtype=dtype,
                                                      generator=generator))
            setattr(self, f"bn{i}", BatchNorm(width // 2, dtype=dtype))
            width //= 2
        self.deconv_out = ConvTranspose(width, c_dim, dtype=dtype, generator=generator)

    def forward(self, z: Tensor, train: bool = True,
                update_stats: bool = False, axis=None) -> Tensor:
        """z (B, z_dim) -> images (B, H, W, C) in [-1, 1], float32.
        ``update_stats`` updates the BN running averages (train mode);
        ``axis`` gives every BN layer the global batch's statistics."""
        x = self.project(z)
        x = x.reshape(-1, self.base, self.base, self.width0).permute(0, 3, 1, 2)
        x = torch.relu(self.bn_in(x, train, update_stats, axis))
        for i in range(self.n_blocks):
            x = getattr(self, f"deconv{i}")(x)
            x = torch.relu(getattr(self, f"bn{i}")(x, train, update_stats, axis))
        x = self.deconv_out(x)
        return torch.tanh(at_least_f32(x)).permute(0, 2, 3, 1)


class DCGANDiscriminator(nn.Module):
    """Critic: stride-2 conv stack -> ``dof_dim`` feature head; ``use_sn``
    spectrally normalises every weight, ``update_sn`` keeps the power
    iteration's new ``u``."""

    def __init__(self, output_size: int = 32, df_dim: int = 64, dof_dim: int = 16,
                 use_sn: bool = False, sn_iters: int = 1, c_dim: int = 3,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        base, n_down = _base_and_blocks(output_size)
        sn = dict(use_sn=use_sn, sn_iters=sn_iters, dtype=dtype, stddev=_STDDEV,
                  generator=generator)
        self.n_blocks = n_down
        cin, width = c_dim, df_dim
        for i in range(n_down):
            setattr(self, f"conv{i}", SNConv(cin, width, 4, stride=2, **sn))
            cin, width = width, width * 2
        self.head = SNDense(base * base * cin, dof_dim, **sn)

    def forward(self, x: Tensor, update_sn: bool = False) -> Tensor:
        """images (B, H, W, C) -> features (B, dof_dim), float32."""
        x = x.permute(0, 3, 1, 2)
        for i in range(self.n_blocks):
            x = nn.functional.leaky_relu(getattr(self, f"conv{i}")(x, update_sn), 0.2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return at_least_f32(self.head(x, update_sn))
