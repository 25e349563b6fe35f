"""Low-level layers: spectrally-normalized dense/conv, flax-style
BatchNorm, and resampling helpers (port of ``smmdax/nn/layers.py``).

Layouts inside the networks are NCHW; weights are torch's (out, in) and
OIHW.  Semantics follow the flax modules exactly:

* Spectral norm: ``u`` is a registered buffer.  EVERY forward runs
  ``sn_iters`` power-iteration steps from the stored ``u`` and divides
  the weight by the resulting sigma; only an ``update_sn=True`` call
  writes the new ``u`` back.  sigma has stop-gradient on ``u`` and ``v``
  and stays differentiable (twice) in the weight.
* Under a bf16 ``dtype`` the parameters stay float32; the input and the
  normalised weight are cast to bf16 for the product.
* ``BatchNorm`` is flax ``nn.BatchNorm``: float32 statistics with
  var = E[x^2] - E[x]^2 clamped at 0, eps 1e-5, and running averages
  ``0.99 * old + 0.01 * batch`` of the mean and the BIASED variance
  (torch's built-in BN keeps the unbiased one).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from smmdax_torch.kernels.kernels import at_least_f32

Tensor = torch.Tensor


def l2_normalize(v: Tensor, eps: float = 1e-12) -> Tensor:
    return v * torch.rsqrt(torch.sum(v * v) + eps)


def power_iteration(w_mat: Tensor, u: Tensor, n_iters: int = 1,
                    eps: float = 1e-12) -> Tuple[Tensor, Tensor]:
    """Power iteration for the top singular value of ``w_mat`` (rows, out)
    from the right-singular estimate ``u`` (out,).  Returns (sigma,
    new_u): sigma is differentiable in ``w_mat`` with u, v held constant."""
    with torch.no_grad():
        for _ in range(n_iters):
            v = l2_normalize(w_mat @ u, eps)
            u = l2_normalize(w_mat.T @ v, eps)
        v = l2_normalize(w_mat @ u, eps)
    sigma = v @ (w_mat @ u)
    return sigma, u


def glorot_uniform_(w: Tensor, fan_in: int, fan_out: int,
                    generator: Optional[torch.Generator]) -> Tensor:
    """flax ``glorot_uniform`` (variance scaling 1, fan_avg, uniform)."""
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return w.uniform_(-bound, bound, generator=generator)


class _SNMixin:
    """Spectral-norm machinery shared by SNDense and SNConv."""

    def _init_sn(self, out_features: int, use_sn: bool, sn_iters: int,
                 generator: Optional[torch.Generator]) -> None:
        self.use_sn = use_sn
        self.sn_iters = sn_iters
        if use_sn:
            self.register_buffer(
                "u", l2_normalize(torch.randn(out_features, generator=generator)))

    def _normalized_weight(self, update_sn: bool) -> Tensor:
        w = self.weight
        if not self.use_sn:
            return w
        # (rows, out): the JAX kernel's reshape(-1, out) up to a row order
        # that sigma does not depend on
        w_mat = w.reshape(w.shape[0], -1).T
        sigma, new_u = power_iteration(w_mat, self.u, self.sn_iters)
        if update_sn:
            with torch.no_grad():
                self.u.copy_(new_u)
        return w / sigma


class SNDense(nn.Module, _SNMixin):
    """Dense layer (weight (out, in)) with optional spectral norm."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 use_sn: bool = False, sn_iters: int = 1,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(glorot_uniform_(
            torch.empty(features, in_features), in_features, features, generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self._init_sn(features, use_sn, sn_iters, generator)

    def forward(self, x: Tensor, update_sn: bool = False) -> Tensor:
        w = self._normalized_weight(update_sn)
        if self.dtype is not None:
            x = x.to(self.dtype)
            w = w.to(self.dtype)
        y = x @ w.T
        if self.bias is not None:
            y = y + (self.bias.to(self.dtype) if self.dtype is not None else self.bias)
        return y


class SNConv(nn.Module, _SNMixin):
    """Stride-1 SAME 2-D convolution (NCHW, weight OIHW) with optional
    spectral norm."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 use_bias: bool = True, use_sn: bool = False, sn_iters: int = 1,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("SAME padding here needs an odd kernel size")
        self.dtype = dtype
        self.padding = kernel_size // 2
        rf = kernel_size * kernel_size
        self.weight = nn.Parameter(glorot_uniform_(
            torch.empty(features, in_features, kernel_size, kernel_size),
            in_features * rf, features * rf, generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self._init_sn(features, use_sn, sn_iters, generator)

    def forward(self, x: Tensor, update_sn: bool = False) -> Tensor:
        w = self._normalized_weight(update_sn)
        if self.dtype is not None:
            x = x.to(self.dtype)
            w = w.to(self.dtype)
        y = F.conv2d(x, w, padding=self.padding)
        if self.bias is not None:
            b = self.bias.to(self.dtype) if self.dtype is not None else self.bias
            y = y + b[:, None, None]
        return y


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over NCHW (see the module docstring)."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None,
                 momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: Tensor, train: bool, update_stats: bool = False) -> Tensor:
        xf = at_least_f32(x)
        if train:
            mean = xf.mean(dim=(0, 2, 3))
            mean2 = (xf * xf).mean(dim=(0, 2, 3))
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            if update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.copy_(m * self.mean + (1 - m) * mean)
                    self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y if self.dtype is None else y.to(self.dtype)


def upsample_nearest(x: Tensor, factor: int = 2) -> Tensor:
    """Nearest-neighbour upsample of an NCHW tensor."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def avg_pool_2x(x: Tensor) -> Tensor:
    """2x2 mean pool, stride 2 (NCHW)."""
    return F.avg_pool2d(x, kernel_size=2, stride=2)
