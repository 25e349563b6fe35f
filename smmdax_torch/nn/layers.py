"""Low-level layers: spectrally-normalized dense/conv, flax-style
BatchNorm, and resampling helpers (port of ``smmdax/nn/layers.py``).

Layouts inside the networks are NCHW; weights are torch's (out, in),
OIHW and, for the transposed convolution, (in, out, H, W).  Semantics
follow the flax modules exactly:

* Spectral norm: ``u`` is a registered buffer.  EVERY forward runs
  ``sn_iters`` power-iteration steps from the stored ``u`` and divides
  the weight by the resulting sigma; only an ``update_sn=True`` call
  writes the new ``u`` back.  sigma has stop-gradient on ``u`` and ``v``
  and stays differentiable (twice) in the weight.
* Under a bf16 ``dtype`` the parameters stay float32; the input and the
  normalised weight are cast to bf16 for the product.
* Initial kernels are flax's ``glorot_uniform`` (the ResNet) or, with
  ``stddev``, ``normal(stddev)`` (the DCGAN and MLP networks'
  ``normal(0.02)``).
* ``ConvTranspose`` is flax ``nn.ConvTranspose`` (4x4, stride 2, SAME),
  which does not flip its kernel: the (in, out, H, W) weight is the HWIO
  kernel flipped in H and W (``smmdax_torch.convert`` does it).
* ``BatchNorm`` is flax ``nn.BatchNorm``: float32 statistics with
  var = E[x^2] - E[x]^2 clamped at 0, eps 1e-5, and running averages
  ``0.99 * old + 0.01 * batch`` of the mean and the BIASED variance
  (torch's built-in BN keeps the unbiased one).  Called with a data
  ``axis`` (GSPMD mode over ranks), the training-mode statistics are
  those of the GLOBAL batch: the ranks' sums of x and x^2 are psum'd
  and divided by the global count, as XLA partitions flax's reduction
  over a sharded batch; the backward is the psum's transpose.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from smmdax_torch import tracing
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


def _init_kernel(shape, fan_in: int, fan_out: int, stddev: Optional[float],
                 generator: Optional[torch.Generator]) -> nn.Parameter:
    """glorot_uniform, or normal(stddev) when ``stddev`` is given."""
    w = torch.empty(shape)
    if stddev is None:
        return nn.Parameter(glorot_uniform_(w, fan_in, fan_out, generator))
    with torch.no_grad():
        return nn.Parameter(w.normal_(0.0, stddev, generator=generator))


def _same_pad(kernel_size: int, stride: int, size: int) -> int:
    """XLA's SAME padding of one side, for sizes where it is symmetric."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel_size - size, 0)
    if total % 2:
        raise ValueError(f"SAME padding of a {kernel_size}-wide kernel at stride "
                         f"{stride} over {size} is asymmetric")
    return total // 2


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
        with tracing.span("nn.spectral"):
            # (rows, out): the JAX kernel's reshape(-1, out) up to a row
            # order that sigma does not depend on
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
                 dtype: Optional[torch.dtype] = None, stddev: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = _init_kernel((features, in_features), in_features, features,
                                   stddev, generator)
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
    """SAME 2-D convolution (NCHW, weight OIHW) with optional spectral
    norm: stride 1 with an odd kernel, or a stride whose SAME padding is
    symmetric at the input's size (the DCGAN critic's 4x4 / 2 on even
    sizes)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 use_bias: bool = True, use_sn: bool = False, sn_iters: int = 1,
                 dtype: Optional[torch.dtype] = None, stride: int = 1,
                 stddev: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if stride == 1 and kernel_size % 2 != 1:
            raise ValueError("SAME padding at stride 1 needs an odd kernel size")
        self.dtype = dtype
        self.kernel_size = kernel_size
        self.stride = stride
        rf = kernel_size * kernel_size
        self.weight = _init_kernel((features, in_features, kernel_size, kernel_size),
                                   in_features * rf, features * rf, stddev, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self._init_sn(features, use_sn, sn_iters, generator)

    def forward(self, x: Tensor, update_sn: bool = False) -> Tensor:
        w = self._normalized_weight(update_sn)
        if self.dtype is not None:
            x = x.to(self.dtype)
            w = w.to(self.dtype)
        pad = [_same_pad(self.kernel_size, self.stride, n) for n in x.shape[2:]]
        y = F.conv2d(x, w, stride=self.stride, padding=pad)
        if self.bias is not None:
            b = self.bias.to(self.dtype) if self.dtype is not None else self.bias
            y = y + b[:, None, None]
        return y


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` at 4x4, stride 2, SAME (NCHW, weight (in,
    out, H, W), normal(0.02) init): doubles H and W."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = _init_kernel((in_features, features, 4, 4), 0, 0, 0.02, generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: Tensor) -> Tensor:
        w, b = self.weight, self.bias
        if self.dtype is not None:
            x, w, b = x.to(self.dtype), w.to(self.dtype), b.to(self.dtype)
        return F.conv_transpose2d(x, w, stride=2, padding=1) + b[:, None, None]


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

    def forward(self, x: Tensor, train: bool, update_stats: bool = False,
                axis=None) -> Tensor:
        """``axis``: a ``DataAxis`` whose ranks hold the other blocks of
        the batch (statistics over the global batch), or None."""
        xf = at_least_f32(x)
        if train:
            if axis is None:
                mean = xf.mean(dim=(0, 2, 3))
                mean2 = (xf * xf).mean(dim=(0, 2, 3))
            else:
                sums = torch.stack([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))])
                count = xf.shape[0] * xf.shape[2] * xf.shape[3] * axis.size
                mean, mean2 = axis.psum(sums) / count
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
