"""Data parallelism over ``torch.distributed``: the ``DataAxis``
collectives and the ring global-batch estimators (the counterpart of
``smmdax.parallel``)."""

from smmdax_torch.parallel.collectives import DataAxis, init_data_axis  # noqa: F401
from smmdax_torch.parallel.ring import (  # noqa: F401
    RING_KERNELS,
    ring_mmd2,
    ring_mmd2_and_ratio,
    ring_mmd_sums,
    ring_var_stats,
)
