"""Unbiased and biased MMD^2 from Gram blocks (port of
``smmdax/kernels/mmd.py``; the Sutherland variance and t-ratio wait for
the tmmd slice)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from smmdax_torch.kernels.kernels import KernelBlocks

Tensor = torch.Tensor


class MMDSums(NamedTuple):
    """Off-diagonal sums of K_XX / K_YY, the full sum of K_XY, and the
    sample counts m, n."""

    sum_xx: Tensor
    sum_yy: Tensor
    sum_xy: Tensor
    m: float
    n: float


def _offdiag_sum(k: Tensor, k_diag: Optional[float]) -> Tensor:
    total = torch.sum(k)
    if k_diag is None:
        return total - torch.trace(k)
    return total - k.shape[0] * k_diag


def mmd_sums(blocks: KernelBlocks) -> MMDSums:
    return MMDSums(
        _offdiag_sum(blocks.k_xx, blocks.k_diag),
        _offdiag_sum(blocks.k_yy, blocks.k_diag),
        torch.sum(blocks.k_xy),
        float(blocks.k_xx.shape[0]),
        float(blocks.k_yy.shape[0]),
    )


def mmd2_from_sums(s: MMDSums, biased: bool = False,
                   diag_xx=None, diag_yy=None) -> Tensor:
    """MMD^2 from sufficient statistics; the biased V-statistic adds the
    supplied diagonal sums back."""
    m, n = s.m, s.n
    if biased:
        dxx = 0.0 if diag_xx is None else diag_xx
        dyy = 0.0 if diag_yy is None else diag_yy
        return ((s.sum_xx + dxx) / (m * m)
                + (s.sum_yy + dyy) / (n * n)
                - 2.0 * s.sum_xy / (m * n))
    return (s.sum_xx / (m * (m - 1.0))
            + s.sum_yy / (n * (n - 1.0))
            - 2.0 * s.sum_xy / (m * n))


def mmd2(blocks: KernelBlocks, biased: bool = False) -> Tensor:
    """Unbiased (default) or biased MMD^2 from full Gram blocks."""
    s = mmd_sums(blocks)
    if biased:
        if blocks.k_diag is None:
            dxx = torch.trace(blocks.k_xx)
            dyy = torch.trace(blocks.k_yy)
        else:
            dxx = blocks.k_xx.shape[0] * blocks.k_diag
            dyy = blocks.k_yy.shape[0] * blocks.k_diag
        return mmd2_from_sums(s, biased=True, diag_xx=dxx, diag_yy=dyy)
    return mmd2_from_sums(s, biased=False)
