"""The layers that the plain reference networks (``arch/<name>.py``) share.

Functional PyTorch over one flat dict of parameters and buffers keyed by
the port's state-dict names, NCHW inside the networks.  ``cast`` is
applied to both operands of every convolution and dense product that the
configuration runs in its compute dtype: the identity cast to bfloat16
for the reference (``to_bf16``), a coarser one for the control
(``to_fp8_scaled``), None in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Params = Dict[str, Tensor]
Cast = Callable[[Tensor], Tensor]

BN_MOMENTUM = 0.99
BN_EPS = 1e-5
SN_EPS = 1e-12


def to_bf16(t: Tensor) -> Tensor:
    return t.to(torch.bfloat16)


def _fp8(t: Tensor, dtype: torch.dtype, top: float) -> Tensor:
    """``t`` rounded to the float8 ``dtype`` with one scale per tensor
    (its largest magnitude to ``top``), back in float32."""
    t32 = t.float()
    scale = torch.clamp_min(t32.abs().amax(), 1e-30) / top
    return (t32 / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    """The operand of an fp8 product: float8 e4m3 forward, and its
    gradient in float8 e5m2, each scaled per tensor (the usual fp8
    training recipe); held in bfloat16."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t, torch.float8_e4m3fn, 448.0).to(torch.bfloat16)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0).to(g.dtype)


def to_fp8_scaled(t: Tensor) -> Tensor:
    """What an fp8 convolution or product would multiply (the control)."""
    return _Fp8.apply(t)


def base_and_blocks(output_size: int) -> Tuple[int, int]:
    """(base grid, number of 2x resamplings): output_size = base * 2^k."""
    for base in (4, 5, 3, 6, 7):
        n = output_size / base
        k = int(round(math.log2(n))) if n > 1 else 0
        if base * (2 ** k) == output_size and k >= 1:
            return base, k
    raise ValueError(f"output_size {output_size} not reachable from a 3..7 base grid")


# ---------------------------------------------------------------------------
# initial weights


def _glorot(shape, fan_in: int, fan_out: int, g: torch.Generator) -> Tensor:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-bound, bound, generator=g)


def _l2n(v: Tensor) -> Tensor:
    return v * torch.rsqrt(torch.sum(v * v) + SN_EPS)


def bn_params(p: Params, name: str, ch: int) -> None:
    """A BatchNorm layer's scale 1, bias 0 and running averages 0 and 1."""
    p[f"{name}.scale"] = torch.ones(ch)
    p[f"{name}.bias"] = torch.zeros(ch)
    p[f"{name}.mean"] = torch.zeros(ch)
    p[f"{name}.var"] = torch.ones(ch)


BUFFER_SUFFIXES = (".mean", ".var", ".u")


def is_buffer(name: str) -> bool:
    return name.endswith(BUFFER_SUFFIXES)


# ---------------------------------------------------------------------------
# layers


def _same_pad(k: int, size: int, stride: int = 1) -> int:
    """XLA's SAME padding of one side, where it is symmetric."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    if total % 2:
        raise ValueError(f"SAME padding of a {k}-wide kernel at stride {stride} over "
                         f"{size} is asymmetric")
    return total // 2


def sn_weight(p: Params, name: str, iters: int, new_u: Optional[Params]) -> Tensor:
    """The kernel divided by its top singular value, from ``iters`` power
    iterations on the stored ``u`` (u, v held constant in the gradient);
    ``new_u`` receives the iterated ``u``."""
    w = p[f"{name}.weight"]
    u = p[f"{name}.u"]
    w_mat = w.reshape(w.shape[0], -1).T
    with torch.no_grad():
        for _ in range(iters):
            v = _l2n(w_mat @ u)
            u = _l2n(w_mat.T @ v)
        v = _l2n(w_mat @ u)
    if new_u is not None:
        new_u[f"{name}.u"] = u
    return w / (v @ (w_mat @ u))


def conv(p: Params, name: str, x: Tensor, cast: Optional[Cast], sn_iters: int = 0,
         new_u: Optional[Params] = None, stride: int = 1) -> Tensor:
    """SAME convolution, weight OIHW; spectrally normalised when
    ``sn_iters``."""
    w = sn_weight(p, name, sn_iters, new_u) if sn_iters else p[f"{name}.weight"]
    b = p[f"{name}.bias"]
    if cast is not None:
        x, w, b = cast(x), cast(w), b.to(torch.bfloat16)
    k = w.shape[-1]
    pad = [_same_pad(k, s, stride) for s in x.shape[2:]]
    return F.conv2d(x, w, stride=stride, padding=pad) + b[:, None, None]


def dense(p: Params, name: str, x: Tensor, cast: Optional[Cast], sn_iters: int = 0,
          new_u: Optional[Params] = None) -> Tensor:
    """x @ W.T + b, weight (out, in); spectrally normalised when
    ``sn_iters``."""
    w = sn_weight(p, name, sn_iters, new_u) if sn_iters else p[f"{name}.weight"]
    b = p[f"{name}.bias"]
    if cast is not None:
        x, w, b = cast(x), cast(w), b.to(torch.bfloat16)
    return x @ w.T + b


def batch_norm(p: Params, name: str, x: Tensor, train: bool, update: Optional[Params],
               low: bool) -> Tensor:
    xf = x.float()
    if train:
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
        if update is not None:
            with torch.no_grad():
                update[f"{name}.mean"] = (BN_MOMENTUM * p[f"{name}.mean"]
                                          + (1 - BN_MOMENTUM) * mean)
                update[f"{name}.var"] = (BN_MOMENTUM * p[f"{name}.var"]
                                         + (1 - BN_MOMENTUM) * var)
    else:
        mean, var = p[f"{name}.mean"], p[f"{name}.var"]
    mul = torch.rsqrt(var + BN_EPS) * p[f"{name}.scale"]
    y = (xf - mean[:, None, None]) * mul[:, None, None] + p[f"{name}.bias"][:, None, None]
    return y.to(torch.bfloat16) if low else y


def _up(x: Tensor) -> Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
