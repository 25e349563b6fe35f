"""Ring (block-row) global-batch MMD^2 and t-ratio estimators (port of
``smmdax/parallel/ring.py``).

Called by every rank of a ``DataAxis`` with its own row block of critic
features.  Over ``size`` rotations (``ppermute_next``) each rank computes
its row block of the three global Gram blocks against every column block
as it arrives, accumulating only partial sums (or row statistics), never
a (B_g, B_g) matrix; one ``psum`` then gives the global sufficient
statistics.  The result is the single-device global-batch estimator.

Differentiable: the backward of the shift is the reverse shift and that
of ``psum`` is ``psum`` (``smmdax_torch.parallel.collectives``), so each
rank's gradient of the global loss, averaged over ranks, is the global
gradient.

The order of the rotation and its diagonal handling follow the JAX
package exactly: the own block (``t == 0``) masks the diagonal, the
column sums of K_XY travel with the y block (a ring reduce) and complete
the ring home, and ``dot`` is the empty rq mixture with ``add_dot = 1``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from smmdax_torch.cuda.mmd_kernel import (kernel_diag, make_pair_stats,
                                          make_pair_sum, make_row_stats)
from smmdax_torch.kernels import kernel_cross
from smmdax_torch.kernels.mmd import (MMDSums, VarStats,
                                      mmd2_and_variance_from_stats,
                                      mmd2_from_sums, ratio_from)
from smmdax_torch.parallel.collectives import DataAxis

Tensor = torch.Tensor

# Kernels the ring estimators (and their fused CUDA block paths) serve:
# the whole loss surface.  Data-dependent diagonals (rq + add_dot, dot)
# are handled by masked exclusion, computed traces and psum'd norms.
RING_KERNELS = ("gaussian", "rq", "distance", "dot")


def _block_sum(name: str, a: Tensor, b: Tensor, exclude_diag: bool,
               rbf_sigmas, rq_alphas, use_pallas: bool = False,
               add_dot: float = 0.0) -> Tensor:
    if use_pallas and name in RING_KERNELS:
        params = rbf_sigmas if name == "gaussian" else rq_alphas
        return make_pair_sum(name, params, exclude_diag, add_dot=add_dot)(a, b)
    k = kernel_cross(name, a, b, rbf_sigmas=rbf_sigmas, rq_alphas=rq_alphas,
                     add_dot=add_dot)
    s = torch.sum(k)
    if exclude_diag:
        s = s - torch.trace(k)
    return s


def ring_mmd_sums(x_loc: Tensor, y_loc: Tensor, axis: DataAxis,
                  kernel: str = "rq",
                  rbf_sigmas: Sequence[float] = (1.0, 2.0, 4.0, 8.0, 16.0),
                  rq_alphas: Sequence[float] = (0.2, 0.5, 1.0, 2.0, 5.0),
                  use_pallas: bool = False,
                  add_dot: float = 0.0) -> MMDSums:
    """Global MMD sufficient statistics from this rank's (b, d) fake and
    (b_r, d) real feature blocks: psum'd off-diagonal sums and the global
    counts, for ``mmd2_from_sums``."""
    x_buf, y_buf = x_loc, y_loc
    sxx = syy = sxy = None
    for t in range(axis.size):
        own = t == 0
        b_xx = _block_sum(kernel, x_loc, x_buf, own, rbf_sigmas, rq_alphas,
                          use_pallas, add_dot)
        b_yy = _block_sum(kernel, y_loc, y_buf, own, rbf_sigmas, rq_alphas,
                          use_pallas, add_dot)
        b_xy = _block_sum(kernel, x_loc, y_buf, False, rbf_sigmas, rq_alphas,
                          use_pallas, add_dot)
        sxx = b_xx if own else sxx + b_xx
        syy = b_yy if own else syy + b_yy
        sxy = b_xy if own else sxy + b_xy
        if t + 1 < axis.size:     # the last rotation's blocks would go unused
            x_buf = axis.ppermute_next(x_buf)
            y_buf = axis.ppermute_next(y_buf)
    sxx, syy, sxy = axis.psum(torch.stack([sxx, syy, sxy]))
    return MMDSums(sxx, syy, sxy, float(x_loc.shape[0] * axis.size),
                   float(y_loc.shape[0] * axis.size))


def ring_mmd2(x_loc: Tensor, y_loc: Tensor, axis: DataAxis,
              kernel: str = "rq",
              rbf_sigmas: Sequence[float] = (1.0, 2.0, 4.0, 8.0, 16.0),
              rq_alphas: Sequence[float] = (0.2, 0.5, 1.0, 2.0, 5.0),
              biased: bool = False, use_pallas: bool = False,
              add_dot: float = 0.0) -> Tensor:
    """Global-batch MMD^2 from per-rank features.  The unbiased estimator
    excludes diagonals by mask or trace; the biased one adds the diagonal
    back from the local traces, psum'd (computed, so add_dot's
    w * ||x||^2 term is included)."""
    sums = ring_mmd_sums(x_loc, y_loc, axis, kernel, rbf_sigmas, rq_alphas,
                         use_pallas=use_pallas, add_dot=add_dot)
    if biased:
        kw = dict(rbf_sigmas=rbf_sigmas, rq_alphas=rq_alphas, add_dot=add_dot)
        diag_xx, diag_yy = axis.psum(torch.stack([
            torch.trace(kernel_cross(kernel, x_loc, x_loc, **kw)),
            torch.trace(kernel_cross(kernel, y_loc, y_loc, **kw))]))
        return mmd2_from_sums(sums, biased=True, diag_xx=diag_xx,
                              diag_yy=diag_yy)
    return mmd2_from_sums(sums, biased=False)


def _const_diag(kernel: str, rbf_sigmas, rq_alphas) -> float:
    """k(x, x) of the constant-diagonal kernels the ring serves."""
    if kernel not in RING_KERNELS:
        raise ValueError(
            f"ring estimators need a constant-diagonal kernel, got {kernel!r}")
    return kernel_diag(kernel, rbf_sigmas if kernel == "gaussian" else rq_alphas)


def ring_var_stats(x_loc: Tensor, y_loc: Tensor, axis: DataAxis,
                   kernel: str = "rq",
                   rbf_sigmas: Sequence[float] = (1.0, 2.0, 4.0, 8.0, 16.0),
                   rq_alphas: Sequence[float] = (0.2, 0.5, 1.0, 2.0, 5.0),
                   use_pallas: bool = False,
                   add_dot: float = 0.0) -> VarStats:
    """Global t-ratio sufficient statistics from per-rank features.

    * per-local-row sums of K~_XX, K~_YY and K_XY stay on the rank that
      owns the rows and collect every column block as it rotates past;
    * the per-y column sums of K_XY travel with the rotating y block and
      arrive home complete after the full cycle;
    * squared-entry sums accumulate as scalars.

    One psum over the scalars and the local dot products gives the exact
    global statistics.  Needs equal sample counts (m == n)."""
    if x_loc.shape[0] != y_loc.shape[0]:
        raise ValueError("t-ratio variance estimator requires m == n")
    if kernel == "dot":
        # the canonical empty-mixture form: constant diagonal 0, the whole
        # kernel rides the add_dot terms below
        kernel, rq_alphas, add_dot = "rq", (), 1.0
    diag = _const_diag(kernel, rbf_sigmas, rq_alphas)

    if use_pallas and kernel in RING_KERNELS:
        # fused block statistics: row sums and sum of squares without the
        # (b, b) block in device memory; the masked diagonal replaces the
        # subtraction.  The xy block takes its column sums from the same
        # sweep.
        kp = rbf_sigmas if kernel == "gaussian" else rq_alphas
        rs_own = make_row_stats(kernel, kp, exclude_diag=True, add_dot=add_dot)
        rs_off = make_row_stats(kernel, kp, exclude_diag=False, add_dot=add_dot)
        ps_off = make_pair_stats(kernel, kp, exclude_diag=False, add_dot=add_dot)

        def block_stats(a, c, own, want_cols=False):
            if want_cols:
                return ps_off(a, c)
            rows, sq = (rs_own if own else rs_off)(a, c)
            return rows, None, sq
    else:
        def block_stats(a, c, own, want_cols=False):
            k = kernel_cross(kernel, a, c, rbf_sigmas=rbf_sigmas,
                             rq_alphas=rq_alphas, add_dot=add_dot)
            rows = torch.sum(k, dim=1)
            cols = torch.sum(k, dim=0) if want_cols else None
            sq = torch.sum(k * k)
            if own:
                # subtract the COMPUTED diagonal, not the ideal constant:
                # self-distances carry float32 cancellation residue
                dvec = torch.diagonal(k)
                rows = rows - dvec
                sq = sq - torch.sum(dvec * dvec)
            return rows, cols, sq

    x_buf, y_buf = x_loc, y_loc
    for t in range(axis.size):
        own = t == 0
        r_xx, _, s_xx = block_stats(x_loc, x_buf, own)
        r_yy, _, s_yy = block_stats(y_loc, y_buf, own)
        r_xy, c_xy, s_xy = block_stats(x_loc, y_buf, False, want_cols=True)
        if own:
            xx_rows, yy_rows, xy_rows, xy_cols = r_xx, r_yy, r_xy, c_xy
            kxx2, kyy2, kxy2 = s_xx, s_yy, s_xy
        else:
            xx_rows, yy_rows, xy_rows = xx_rows + r_xx, yy_rows + r_yy, xy_rows + r_xy
            xy_cols = xy_cols + c_xy
            kxx2, kyy2, kxy2 = kxx2 + s_xx, kyy2 + s_yy, kxy2 + s_xy
        if t + 1 < axis.size:     # the last rotation's blocks would go unused
            x_buf = axis.ppermute_next(x_buf)
            y_buf = axis.ppermute_next(y_buf)
        # xy_cols rides with y_buf: after size shifts it is home, holding
        # the full column sums of this rank's y rows
        xy_cols = axis.ppermute_next(xy_cols)

    # yy_rows indexes the local y too, so <yy_rows, xy_cols> pairs rank by rank
    x32, y32 = x_loc.float(), y_loc.float()
    local = torch.stack([
        torch.sum(xx_rows), torch.sum(yy_rows), torch.sum(xy_rows),
        kxx2, kyy2, kxy2,
        torch.dot(xx_rows, xx_rows), torch.dot(yy_rows, yy_rows),
        torch.dot(xy_rows, xy_rows), torch.dot(xy_cols, xy_cols),
        torch.dot(xx_rows, xy_rows), torch.dot(yy_rows, xy_cols),
        torch.sum(x32 * x32), torch.sum(y32 * y32)])
    (kt_xx_sum, kt_yy_sum, k_xy_sum, kt_xx_2_sum, kt_yy_2_sum, k_xy_2_sum,
     dot_xx_rows, dot_yy_rows, dot_xy_rows, dot_xy_cols, dot_xx_xy, dot_yy_xy,
     norms_x, norms_y) = axis.psum(local)

    m = float(x_loc.shape[0] * axis.size)
    # diagonal sums (the biased estimator only): the constant mixture part
    # plus, with add_dot, w * ||x||^2 over the global batch
    sum_diag_x = m * diag + (add_dot * norms_x if add_dot else 0.0)
    sum_diag_y = m * diag + (add_dot * norms_y if add_dot else 0.0)
    return VarStats(
        m=m, kt_xx_sum=kt_xx_sum, kt_yy_sum=kt_yy_sum, k_xy_sum=k_xy_sum,
        kt_xx_2_sum=kt_xx_2_sum, kt_yy_2_sum=kt_yy_2_sum, k_xy_2_sum=k_xy_2_sum,
        dot_xx_rows=dot_xx_rows, dot_yy_rows=dot_yy_rows,
        dot_xy_rows=dot_xy_rows, dot_xy_cols=dot_xy_cols,
        dot_xx_xy=dot_xx_xy, dot_yy_xy=dot_yy_xy,
        sum_diag_x=sum_diag_x, sum_diag_y=sum_diag_y)


def ring_mmd2_and_ratio(x_loc: Tensor, y_loc: Tensor, axis: DataAxis,
                        kernel: str = "rq",
                        rbf_sigmas: Sequence[float] = (1.0, 2.0, 4.0, 8.0, 16.0),
                        rq_alphas: Sequence[float] = (0.2, 0.5, 1.0, 2.0, 5.0),
                        min_var_est: float = 1e-8,
                        use_pallas: bool = False,
                        add_dot: float = 0.0) -> Tuple[Tensor, Tensor]:
    """Global-batch (MMD^2, t-ratio) from per-rank features: the ring form
    of ``smmdax_torch.kernels.mmd.mmd2_and_ratio`` (the tmmd model under
    data parallelism, no gathered Gram blocks)."""
    stats = ring_var_stats(x_loc, y_loc, axis, kernel, rbf_sigmas, rq_alphas,
                           use_pallas=use_pallas, add_dot=add_dot)
    val, var = mmd2_and_variance_from_stats(stats, biased=False)
    return val, ratio_from(val, var, min_var_est)
