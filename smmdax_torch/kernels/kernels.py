"""Pairwise kernel matrices over critic features (dense torch oracle).

Port of ``smmdax/kernels/kernels.py``: Gaussian/RBF and rational-quadratic
mixtures (rq optionally plus ``add_dot * <x, y>``), the dot kernel and the
energy-distance kernel.  Distances come from one matrix product plus
rank-1 norm broadcasts, as in the JAX package.

The JAX package runs these products at HIGHEST precision.  On the card a
float32 ``matmul`` stays full float32 only while
``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default);
``_f32_dot`` refuses to run with TF32 on rather than lose the digits the
d^2 expansion needs.  Everything here is float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

Tensor = torch.Tensor

# Self-distance guard for the energy-distance kernel: k(x,x) = -sqrt(eps).
# The CUDA pair-sum kernels use the same constant.
DIST_EPS = 1e-8


class KernelBlocks(NamedTuple):
    """The three Gram blocks plus the constant diagonal value k(x, x)
    (None when it depends on the data: dot, or rq with add_dot)."""

    k_xx: Tensor
    k_xy: Tensor
    k_yy: Tensor
    k_diag: Optional[float]


def at_least_f32(x: Tensor) -> Tensor:
    """``x`` in float32, or wider if it already is (float64 references)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _f32_dot(x: Tensor, y: Tensor) -> Tensor:
    """x @ y.T in full float32."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "kernel distances need full-f32 products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    return x @ y.T


def sq_dists(x: Tensor, y: Tensor) -> Tensor:
    """Pairwise squared Euclidean distances, (m, d) x (n, d) -> (m, n),
    clamped at 0 against cancellation."""
    x = at_least_f32(x)
    y = at_least_f32(y)
    xx = torch.sum(x * x, dim=1)[:, None]
    yy = torch.sum(y * y, dim=1)[None, :]
    return torch.clamp_min(xx + yy - 2.0 * _f32_dot(x, y), 0.0)


def _mix_rbf(d2: Tensor, sigmas: Sequence[float],
             wts: Optional[Sequence[float]]) -> Tensor:
    if wts is None:
        wts = [1.0] * len(sigmas)
    k = torch.zeros_like(d2)
    for sigma, w in zip(sigmas, wts):
        gamma = 1.0 / (2.0 * float(sigma) ** 2)
        k = k + float(w) * torch.exp(-gamma * d2)
    return k


def _mix_rq(d2: Tensor, alphas: Sequence[float],
            wts: Optional[Sequence[float]], add_dot: float = 0.0,
            dot: Optional[Tensor] = None) -> Tensor:
    """sum_a w_a (1 + d2 / (2a))^-a  [+ add_dot * <x, y>]."""
    if wts is None:
        wts = [1.0] * len(alphas)
    k = torch.zeros_like(d2)
    for alpha, w in zip(alphas, wts):
        a = float(alpha)
        k = k + float(w) * torch.exp(-a * torch.log1p(d2 / (2.0 * a)))
    if add_dot and dot is not None:
        k = k + add_dot * dot
    return k


def mix_rbf_kernel(x: Tensor, y: Tensor,
                   sigmas: Sequence[float] = (1.0, 2.0, 4.0, 8.0, 16.0),
                   wts: Optional[Sequence[float]] = None) -> KernelBlocks:
    k_xx = _mix_rbf(sq_dists(x, x), sigmas, wts)
    k_xy = _mix_rbf(sq_dists(x, y), sigmas, wts)
    k_yy = _mix_rbf(sq_dists(y, y), sigmas, wts)
    diag = float(sum(wts)) if wts is not None else float(len(sigmas))
    return KernelBlocks(k_xx, k_xy, k_yy, diag)


def mix_rq_kernel(x: Tensor, y: Tensor,
                  alphas: Sequence[float] = (0.2, 0.5, 1.0, 2.0, 5.0),
                  wts: Optional[Sequence[float]] = None,
                  add_dot: float = 0.0) -> KernelBlocks:
    dot_xx = dot_xy = dot_yy = None
    if add_dot:
        x32, y32 = at_least_f32(x), at_least_f32(y)
        dot_xx = _f32_dot(x32, x32)
        dot_xy = _f32_dot(x32, y32)
        dot_yy = _f32_dot(y32, y32)
    k_xx = _mix_rq(sq_dists(x, x), alphas, wts, add_dot, dot_xx)
    k_xy = _mix_rq(sq_dists(x, y), alphas, wts, add_dot, dot_xy)
    k_yy = _mix_rq(sq_dists(y, y), alphas, wts, add_dot, dot_yy)
    diag = float(sum(wts)) if wts is not None else float(len(alphas))
    return KernelBlocks(k_xx, k_xy, k_yy, None if add_dot else diag)


def dot_kernel(x: Tensor, y: Tensor) -> KernelBlocks:
    x, y = at_least_f32(x), at_least_f32(y)
    return KernelBlocks(_f32_dot(x, x), _f32_dot(x, y), _f32_dot(y, y), None)


def distance_kernel(x: Tensor, y: Tensor) -> KernelBlocks:
    """k(x,y) = -||x - y||; self-distances pinned to exactly sqrt(eps)."""
    eps = DIST_EPS
    diag = -float(eps) ** 0.5

    def self_block(v: Tensor) -> Tensor:
        d2 = sq_dists(v, v)
        eye = torch.eye(d2.shape[0], dtype=torch.bool, device=d2.device)
        return -torch.sqrt(d2.masked_fill(eye, 0.0) + eps)

    k_xy = -torch.sqrt(sq_dists(x, y) + eps)
    return KernelBlocks(self_block(x), k_xy, self_block(y), diag)


def kernel_cross(name: str, x: Tensor, y: Tensor, *,
                 rbf_sigmas: Sequence[float] = (1.0, 2.0, 4.0, 8.0, 16.0),
                 rq_alphas: Sequence[float] = (0.2, 0.5, 1.0, 2.0, 5.0),
                 add_dot: float = 0.0) -> Tensor:
    """Just the (m, n) cross Gram block K_XY (used by the witness fn)."""
    if name == "gaussian":
        return _mix_rbf(sq_dists(x, y), rbf_sigmas, None)
    if name == "rq":
        dot = _f32_dot(at_least_f32(x), at_least_f32(y)) if add_dot else None
        return _mix_rq(sq_dists(x, y), rq_alphas, None, add_dot, dot)
    if name == "dot":
        return _f32_dot(at_least_f32(x), at_least_f32(y))
    if name == "distance":
        return -torch.sqrt(sq_dists(x, y) + DIST_EPS)
    raise ValueError(f"unknown kernel {name!r}")


def kernel_matrices(name: str, x: Tensor, y: Tensor, *,
                    rbf_sigmas: Sequence[float] = (1.0, 2.0, 4.0, 8.0, 16.0),
                    rq_alphas: Sequence[float] = (0.2, 0.5, 1.0, 2.0, 5.0),
                    add_dot: float = 0.0) -> KernelBlocks:
    """Dispatch over {gaussian, rq, dot, distance}; ``add_dot`` is rq only."""
    if name == "gaussian":
        return mix_rbf_kernel(x, y, sigmas=rbf_sigmas)
    if name == "rq":
        return mix_rq_kernel(x, y, alphas=rq_alphas, add_dot=add_dot)
    if name == "dot":
        return dot_kernel(x, y)
    if name == "distance":
        return distance_kernel(x, y)
    raise ValueError(f"unknown kernel {name!r}")
