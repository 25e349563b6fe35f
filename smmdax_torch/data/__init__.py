"""Data sources and transforms of the port."""

from smmdax_torch.data.pipeline import (  # noqa: F401
    ArraySource,
    macro_batch_at,
    macro_batches,
    make_dataset,
    materialize_u8,
)
from smmdax_torch.data.synthetic import SyntheticImages  # noqa: F401
from smmdax_torch.data.transforms import normalize_uint8  # noqa: F401
