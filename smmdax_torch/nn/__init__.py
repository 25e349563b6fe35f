"""Networks of the port (resnet arm)."""

from smmdax_torch.nn.registry import build_models  # noqa: F401
