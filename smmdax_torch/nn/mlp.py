"""Small MLP generator and critic for the 1-D GaussianMix toy (port of
``smmdax/nn/mlp.py``): float32, normal(0.02) kernels, no BatchNorm."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from smmdax_torch.nn.layers import SNDense

Tensor = torch.Tensor

_STDDEV = 0.02


class MLPGenerator(nn.Module):
    def __init__(self, out_dim: int = 1, hidden: Sequence[int] = (64, 64),
                 z_dim: int = 16, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_hidden = len(hidden)
        cin = z_dim
        for i, h in enumerate(hidden):
            setattr(self, f"fc{i}", SNDense(cin, h, stddev=_STDDEV, generator=generator))
            cin = h
        self.out = SNDense(cin, out_dim, stddev=_STDDEV, generator=generator)

    def forward(self, z: Tensor, train: bool = True,
                update_stats: bool = False, axis=None) -> Tensor:
        """z (B, z_dim) -> samples (B, out_dim) in [-1, 1].  ``train``,
        ``update_stats`` and ``axis`` are accepted for the generators'
        common call and change nothing (no BatchNorm)."""
        x = z
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"fc{i}")(x))
        return torch.tanh(self.out(x))


class MLPDiscriminator(nn.Module):
    def __init__(self, in_dim: int = 1, dof_dim: int = 8,
                 hidden: Sequence[int] = (64, 64), use_sn: bool = False,
                 sn_iters: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__()
        sn = dict(use_sn=use_sn, sn_iters=sn_iters, stddev=_STDDEV, generator=generator)
        self.n_hidden = len(hidden)
        cin = in_dim
        for i, h in enumerate(hidden):
            setattr(self, f"fc{i}", SNDense(cin, h, **sn))
            cin = h
        self.head = SNDense(cin, dof_dim, **sn)

    def forward(self, x: Tensor, update_sn: bool = False) -> Tensor:
        """samples (B, ...) -> features (B, dof_dim)."""
        x = x.reshape(x.shape[0], -1)
        for i in range(self.n_hidden):
            x = nn.functional.leaky_relu(getattr(self, f"fc{i}")(x, update_sn), 0.2)
        return self.head(x, update_sn)
