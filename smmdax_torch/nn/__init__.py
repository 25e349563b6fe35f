"""Networks of the port: the SN ResNet, DCGAN and the toy MLP."""

from smmdax_torch.nn.registry import build_models  # noqa: F401
