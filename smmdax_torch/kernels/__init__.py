"""Pairwise kernels and MMD estimators: the dense torch oracle that the
fused CUDA path (``smmdax_torch.cuda``) is held against."""

from smmdax_torch.kernels.kernels import (  # noqa: F401
    DIST_EPS,
    KernelBlocks,
    distance_kernel,
    dot_kernel,
    kernel_cross,
    kernel_matrices,
    mix_rbf_kernel,
    mix_rq_kernel,
    sq_dists,
)
from smmdax_torch.kernels.mmd import (  # noqa: F401
    MMDSums,
    mmd2,
    mmd2_from_sums,
    mmd_sums,
)
from smmdax_torch.kernels.smmd import smmd_scale  # noqa: F401
