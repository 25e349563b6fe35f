"""SN-GAN-style residual generator and critic (port of
``smmdax/nn/resnet.py``).

Public layout is NHWC, as in the JAX package: the generator returns
(B, H, W, C) images and the critic takes them.  Inside, activations are
NCHW (one permute at each end).  Submodule names follow the flax tree
(``project``, ``block0.conv1``, ``bn_out``, ...), so converted weights
map name for name.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from smmdax_torch.kernels.kernels import at_least_f32
from smmdax_torch.nn.layers import (BatchNorm, SNConv, SNDense, avg_pool_2x,
                                    upsample_nearest)

Tensor = torch.Tensor


def _base_and_blocks(output_size: int) -> Tuple[int, int]:
    """(base grid size, #stride-2 blocks) with base in {4, 5}; a copy of
    ``smmdax.nn.dcgan._base_and_blocks``."""
    for base in (4, 5, 3, 6, 7):
        n = output_size / base
        k = int(round(math.log2(n))) if n > 1 else 0
        if base * (2 ** k) == output_size and k >= 1:
            return base, k
    raise ValueError(f"output_size {output_size} not reachable from a 3..7 base grid")


def _gen_widths(gf_dim: int, n_up: int) -> List[int]:
    return [gf_dim * (2 ** (n_up - 1 - i)) for i in range(n_up)]


def _disc_widths(df_dim: int, n_down: int) -> List[int]:
    return [df_dim * (2 ** i) for i in range(n_down)]


class GenBlock(nn.Module):
    """Pre-activation residual up-block: BN-ReLU-up-conv-BN-ReLU-conv."""

    def __init__(self, in_features: int, features: int, upsample: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.upsample = upsample
        self.bn1 = BatchNorm(in_features, dtype=dtype)
        self.conv1 = SNConv(in_features, features, 3, dtype=dtype, generator=generator)
        self.bn2 = BatchNorm(features, dtype=dtype)
        self.conv2 = SNConv(features, features, 3, dtype=dtype, generator=generator)
        self.conv_sc = (SNConv(in_features, features, 1, dtype=dtype, generator=generator)
                        if in_features != features else None)

    def forward(self, x: Tensor, train: bool = True,
                update_stats: bool = False) -> Tensor:
        h = torch.relu(self.bn1(x, train, update_stats))
        if self.upsample:
            h = upsample_nearest(h)
        h = self.conv1(h)
        h = torch.relu(self.bn2(h, train, update_stats))
        h = self.conv2(h)
        sc = upsample_nearest(x) if self.upsample else x
        if self.conv_sc is not None:
            sc = self.conv_sc(sc)
        return h + sc


class DiscBlock(nn.Module):
    """Residual down-block: ReLU-conv-ReLU-conv-pool (+1x1 shortcut)."""

    def __init__(self, in_features: int, features: int, downsample: bool = True,
                 first: bool = False, use_sn: bool = False, sn_iters: int = 1,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.downsample = downsample
        self.first = first
        sn = dict(use_sn=use_sn, sn_iters=sn_iters, dtype=dtype, generator=generator)
        self.conv1 = SNConv(in_features, features, 3, **sn)
        self.conv2 = SNConv(features, features, 3, **sn)
        self.conv_sc = (SNConv(in_features, features, 1, **sn)
                        if first or in_features != features else None)

    def forward(self, x: Tensor, update_sn: bool = False) -> Tensor:
        h = x if self.first else torch.relu(x)
        h = self.conv1(h, update_sn)
        h = self.conv2(torch.relu(h), update_sn)
        if self.downsample:
            h = avg_pool_2x(h)
        sc = x
        if self.first:
            # optimized block: pool first, then widen
            if self.downsample:
                sc = avg_pool_2x(sc)
            sc = self.conv_sc(sc, update_sn)
        else:
            if self.conv_sc is not None:
                sc = self.conv_sc(sc, update_sn)
            if self.downsample:
                sc = avg_pool_2x(sc)
        return h + sc


class ResNetGenerator(nn.Module):
    def __init__(self, output_size: int = 32, c_dim: int = 3, gf_dim: int = 64,
                 z_dim: int = 128, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.base, n_up = _base_and_blocks(output_size)
        # CIFAR-10 SN-GAN uses a flat 256-wide trunk; deeper variants taper
        widths: Sequence[int] = ([4 * gf_dim] * n_up if n_up <= 3
                                 else _gen_widths(gf_dim, n_up))
        self.width0 = widths[0]
        self.n_blocks = n_up
        self.project = SNDense(z_dim, self.base * self.base * widths[0],
                               dtype=dtype, generator=generator)
        cin = widths[0]
        for i, w in enumerate(widths):
            setattr(self, f"block{i}", GenBlock(cin, w, dtype=dtype, generator=generator))
            cin = w
        self.bn_out = BatchNorm(cin, dtype=dtype)
        self.conv_out = SNConv(cin, c_dim, 3, dtype=dtype, generator=generator)

    def forward(self, z: Tensor, train: bool = True,
                update_stats: bool = False) -> Tensor:
        """z (B, z_dim) -> images (B, H, W, C) in [-1, 1], float32.
        ``update_stats`` updates the BN running averages (train mode)."""
        x = self.project(z)
        x = x.reshape(-1, self.base, self.base, self.width0).permute(0, 3, 1, 2)
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x, train, update_stats)
        x = torch.relu(self.bn_out(x, train, update_stats))
        x = self.conv_out(x)
        return torch.tanh(at_least_f32(x)).permute(0, 2, 3, 1)


class ResNetDiscriminator(nn.Module):
    def __init__(self, output_size: int = 32, df_dim: int = 64, dof_dim: int = 16,
                 use_sn: bool = False, sn_iters: int = 1, c_dim: int = 3,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _, n_down = _base_and_blocks(output_size)
        sn = dict(use_sn=use_sn, sn_iters=sn_iters, dtype=dtype, generator=generator)
        if n_down <= 3:
            # CIFAR-10 SN-GAN schedule: 128-wide, two extra no-down blocks
            w = 2 * df_dim
            blocks = [DiscBlock(c_dim, w, downsample=True, first=True, **sn),
                      DiscBlock(w, w, downsample=True, **sn),
                      DiscBlock(w, w, downsample=False, **sn),
                      DiscBlock(w, w, downsample=False, **sn)]
            cin = w
        else:
            blocks, cin = [], c_dim
            for i, w in enumerate(_disc_widths(df_dim, n_down)):
                blocks.append(DiscBlock(cin, w, downsample=True, first=(i == 0), **sn))
                cin = w
        self.n_blocks = len(blocks)
        for i, blk in enumerate(blocks):
            setattr(self, f"block{i}", blk)
        # the feature head runs in float32: MMD math is always f32
        self.head = SNDense(cin, dof_dim, use_sn=use_sn, sn_iters=sn_iters,
                            generator=generator)

    def forward(self, x: Tensor, update_sn: bool = False) -> Tensor:
        """images (B, H, W, C) -> features (B, dof_dim), float32."""
        x = x.permute(0, 3, 1, 2)
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x, update_sn)
        x = torch.relu(x)
        x = torch.sum(at_least_f32(x), dim=(2, 3))     # global sum pool
        return at_least_f32(self.head(x, update_sn))
