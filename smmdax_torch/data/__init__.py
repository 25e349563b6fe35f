"""Data sources and transforms of the port."""

from smmdax_torch.data.pipeline import macro_batch_at  # noqa: F401
from smmdax_torch.data.synthetic import SyntheticImages  # noqa: F401
from smmdax_torch.data.transforms import normalize_uint8  # noqa: F401
