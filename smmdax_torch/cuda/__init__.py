"""Hand-written CUDA kernels of the MMD hot path (the counterpart of
``smmdax.pallas``): fused pair sums, block statistics and their
gradients, built with ``nvcc`` at first use (``smmdax_torch.cuda.build``)."""

from smmdax_torch.cuda.dispatch import should_use_pallas  # noqa: F401
from smmdax_torch.cuda.mmd_kernel import (  # noqa: F401
    fused_mmd2,
    make_fused_mmd_sums,
    make_pair_stats,
    make_pair_sum,
    make_row_stats,
    pair_block_stats,
    pair_block_stats_grad,
    pair_stats,
    pair_stats_grad_a,
    pair_sum,
    pair_sum_grad,
    pair_sum_grad_a,
)
