"""Hand-written CUDA kernels of the MMD hot path (the counterpart of
``smmdax.pallas``): fused pair sums and their gradient, built with
``nvcc`` at first use (``smmdax_torch.cuda.build``)."""

from smmdax_torch.cuda.dispatch import should_use_pallas  # noqa: F401
from smmdax_torch.cuda.mmd_kernel import (  # noqa: F401
    fused_mmd2,
    make_fused_mmd_sums,
    pair_sum,
    pair_sum_grad_a,
)
