"""Unbiased and biased MMD^2 from Gram blocks, the Sutherland variance
estimate of MMD^2_u and the t-ratio of the tmmd model (port of
``smmdax/kernels/mmd.py``).

The variance estimator is written over sufficient statistics
(``VarStats``): sums and dot products of Gram row sums, all additive over
row blocks, so the data-parallel ring (``smmdax_torch.parallel.ring``)
builds the same statistics from its blocks plus one all-reduce."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from smmdax_torch.kernels.kernels import KernelBlocks

Tensor = torch.Tensor

_MIN_VAR_EST = 1e-8


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


def mmd2_from_blocks(k_xx: Tensor, k_xy: Tensor, k_yy: Tensor,
                     k_diag: Optional[float] = None,
                     biased: bool = False) -> Tensor:
    """``mmd2`` of the Gram blocks given one by one."""
    return mmd2(KernelBlocks(k_xx, k_xy, k_yy, k_diag), biased=biased)


class VarStats(NamedTuple):
    """Sufficient statistics of the Sutherland variance estimator
    (``kt_*`` exclude the diagonal).  Every field is a sum over blocks of
    the global Gram matrices, so sharded partial sums add up exactly."""

    m: float               # sample count (the estimator needs m == n)
    kt_xx_sum: Tensor      # sum of off-diagonal K_XX
    kt_yy_sum: Tensor
    k_xy_sum: Tensor       # full sum of K_XY
    kt_xx_2_sum: Tensor    # sums of squared off-diagonal entries
    kt_yy_2_sum: Tensor
    k_xy_2_sum: Tensor
    dot_xx_rows: Tensor    # <row_sums(K~_XX), row_sums(K~_XX)>
    dot_yy_rows: Tensor
    dot_xy_rows: Tensor    # <row_sums(K_XY), row_sums(K_XY)>  (per x)
    dot_xy_cols: Tensor    # <col_sums(K_XY), col_sums(K_XY)>  (per y)
    dot_xx_xy: Tensor      # <row_sums(K~_XX), row_sums(K_XY)>
    dot_yy_xy: Tensor      # <row_sums(K~_YY), col_sums(K_XY)>
    sum_diag_x: Tensor     # diagonal sums (biased estimator only)
    sum_diag_y: Tensor


def var_stats_from_blocks(blocks: KernelBlocks) -> VarStats:
    """Reduce full Gram blocks to the sufficient statistics."""
    k_xx, k_xy, k_yy, k_diag = blocks
    m = k_xx.shape[0]
    if k_yy.shape[0] != m:
        raise ValueError("variance estimator requires m == n")
    mf = float(m)

    if k_diag is None:
        diag_x = torch.diagonal(k_xx)
        diag_y = torch.diagonal(k_yy)
        sum_diag_x = torch.sum(diag_x)
        sum_diag_y = torch.sum(diag_y)
        sum_diag2_x = torch.sum(diag_x * diag_x)
        sum_diag2_y = torch.sum(diag_y * diag_y)
    else:
        diag_x = diag_y = k_diag
        sum_diag_x = sum_diag_y = torch.tensor(mf * k_diag, dtype=k_xx.dtype,
                                               device=k_xx.device)
        sum_diag2_x = sum_diag2_y = mf * k_diag * k_diag

    kt_xx_sums = torch.sum(k_xx, dim=1) - diag_x      # row sums, no diagonal
    kt_yy_sums = torch.sum(k_yy, dim=1) - diag_y
    k_xy_sums_0 = torch.sum(k_xy, dim=0)              # over x -> per y
    k_xy_sums_1 = torch.sum(k_xy, dim=1)              # over y -> per x

    return VarStats(
        m=mf,
        kt_xx_sum=torch.sum(kt_xx_sums),
        kt_yy_sum=torch.sum(kt_yy_sums),
        k_xy_sum=torch.sum(k_xy_sums_0),
        kt_xx_2_sum=torch.sum(k_xx * k_xx) - sum_diag2_x,
        kt_yy_2_sum=torch.sum(k_yy * k_yy) - sum_diag2_y,
        k_xy_2_sum=torch.sum(k_xy * k_xy),
        dot_xx_rows=torch.dot(kt_xx_sums, kt_xx_sums),
        dot_yy_rows=torch.dot(kt_yy_sums, kt_yy_sums),
        dot_xy_rows=torch.dot(k_xy_sums_1, k_xy_sums_1),
        dot_xy_cols=torch.dot(k_xy_sums_0, k_xy_sums_0),
        dot_xx_xy=torch.dot(kt_xx_sums, k_xy_sums_1),
        dot_yy_xy=torch.dot(kt_yy_sums, k_xy_sums_0),
        sum_diag_x=sum_diag_x,
        sum_diag_y=sum_diag_y,
    )


def mmd2_and_variance_from_stats(s: VarStats, biased: bool = False
                                 ) -> Tuple[Tensor, Tensor]:
    """MMD^2 and its variance estimate from the sufficient statistics
    (Sutherland et al., ICLR 2017, arXiv:1611.04488, appendix A)."""
    mf = s.m
    if biased:
        mmd2_val = ((s.kt_xx_sum + s.sum_diag_x) / (mf * mf)
                    + (s.kt_yy_sum + s.sum_diag_y) / (mf * mf)
                    - 2.0 * s.k_xy_sum / (mf * mf))
    else:
        mmd2_val = (s.kt_xx_sum / (mf * (mf - 1.0))
                    + s.kt_yy_sum / (mf * (mf - 1.0))
                    - 2.0 * s.k_xy_sum / (mf * mf))

    var_est = (
        2.0 / (mf**2 * (mf - 1.0)**2)
        * (2.0 * s.dot_xx_rows - s.kt_xx_2_sum
           + 2.0 * s.dot_yy_rows - s.kt_yy_2_sum)
        - (4.0 * mf - 6.0) / (mf**3 * (mf - 1.0)**3)
        * (s.kt_xx_sum**2 + s.kt_yy_sum**2)
        + 4.0 * (mf - 2.0) / (mf**3 * (mf - 1.0)**2)
        * (s.dot_xy_rows + s.dot_xy_cols)
        - 4.0 * (mf - 3.0) / (mf**3 * (mf - 1.0)**2) * s.k_xy_2_sum
        - (8.0 * mf - 12.0) / (mf**5 * (mf - 1.0)) * s.k_xy_sum**2
        + 8.0 / (mf**3 * (mf - 1.0))
        * (1.0 / mf * (s.kt_xx_sum + s.kt_yy_sum) * s.k_xy_sum
           - s.dot_xx_xy - s.dot_yy_xy)
    )
    return mmd2_val, var_est


def mmd2_and_variance(blocks: KernelBlocks, biased: bool = False
                      ) -> Tuple[Tensor, Tensor]:
    """MMD^2 and the variance estimate of MMD^2_u (needs m == n)."""
    return mmd2_and_variance_from_stats(var_stats_from_blocks(blocks),
                                        biased=biased)


def ratio_from(val: Tensor, var: Tensor,
               min_var_est: float = _MIN_VAR_EST) -> Tensor:
    """mmd2 / sqrt(max(var, min_var_est))."""
    return val / torch.sqrt(torch.clamp_min(var, min_var_est))


def mmd2_and_ratio(blocks: KernelBlocks, biased: bool = False,
                   min_var_est: float = _MIN_VAR_EST) -> Tuple[Tensor, Tensor]:
    """The t-statistic-like objective mmd2 / sqrt(var) of the tmmd model."""
    val, var = mmd2_and_variance(blocks, biased=biased)
    return val, ratio_from(val, var, min_var_est)
