"""Plain reference of the DCGAN pair (``"architecture": "dcgan"``).

Written from the DCGAN equations (Radford, Metz & Chintala 2016,
arXiv:1511.06434) as the port lays them out, with ``output_size = base *
2^n`` (``layers.base_and_blocks``):

* generator: a dense projection of z to a base x base x (gf_dim *
  2^(n-1)) grid (reshaped NHWC, as flax does), BatchNorm and ReLU; then
  n - 1 transposed convolutions that halve the width, each followed by
  BatchNorm and ReLU, and one to ``c_dim`` channels; tanh;
* critic: n 4x4 stride-2 SAME convolutions of widths df_dim * 2^i, each
  followed by lrelu(0.2); the NHWC flatten; a dense head to ``dof_dim``.
  Under ``sn-smmd`` every critic weight is spectrally normalised.

The transposed convolution is flax's ``nn.ConvTranspose`` at 4x4, stride
2, SAME, which does not flip its kernel (``deconv``).  Initial weights:
``normal(0.02)`` for every kernel, zero biases, BatchNorm scale 1 and
bias 0, drawn in the port's order (the projection, each transposed
convolution, then each critic convolution with its ``u`` after its
kernel, then the head and its ``u``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..layers import (Cast, Params, Tensor, _l2n, base_and_blocks, batch_norm, bn_params, conv,
                      dense)

STDDEV = 0.02


def _normal(shape, g: torch.Generator) -> Tensor:
    return torch.empty(shape).normal_(0.0, STDDEV, generator=g)


def init_weights(c: dict, seed: int) -> Tuple[Params, Params]:
    """(generator, critic) weights and buffers for config ``c``, drawn on
    the CPU from ``seed`` in the order described in the module docstring."""
    g = torch.Generator().manual_seed(seed)
    base, n = base_and_blocks(c["output_size"])
    width = c["gf_dim"] * 2 ** (n - 1)
    gp: Params = {"project.weight": _normal((base * base * width, c["z_dim"]), g),
                  "project.bias": torch.zeros(base * base * width)}
    bn_params(gp, "bn_in", width)
    for i in range(n - 1):
        gp[f"deconv{i}.weight"] = _normal((width, width // 2, 4, 4), g)
        gp[f"deconv{i}.bias"] = torch.zeros(width // 2)
        bn_params(gp, f"bn{i}", width // 2)
        width //= 2
    gp["deconv_out.weight"] = _normal((width, c["c_dim"], 4, 4), g)
    gp["deconv_out.bias"] = torch.zeros(c["c_dim"])

    dp: Params = {}
    sn = c["model"] == "sn-smmd"

    def layer(name: str, shape) -> None:
        dp[f"{name}.weight"] = _normal(shape, g)
        dp[f"{name}.bias"] = torch.zeros(shape[0])
        if sn:
            dp[f"{name}.u"] = _l2n(torch.randn(shape[0], generator=g))

    cin, width = c["c_dim"], c["df_dim"]
    for i in range(n):
        layer(f"conv{i}", (width, cin, 4, 4))
        cin, width = width, 2 * width
    layer("head", (c["dof_dim"], base * base * cin))
    return gp, dp


def deconv(p: Params, name: str, x: Tensor, cast: Optional[Cast]) -> Tensor:
    """flax's transposed convolution, 4x4, stride 2, SAME: the input
    dilated by 2, padded by 2 on each side, correlated with the HWIO kernel
    K unflipped.  The port holds K flipped in H and W as torch's (in, out,
    4, 4) transposed-convolution weight; ``conv_transpose2d`` flips it
    back, and its padding 1 is 4 - 1 - 2."""
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if cast is not None:
        x, w, b = cast(x), cast(w), b.to(torch.bfloat16)
    return F.conv_transpose2d(x, w, stride=2, padding=1) + b[:, None, None]


def generator(c: dict, p: Params, z: Tensor, train: bool, cast: Optional[Cast],
              update: Optional[Params] = None) -> Tensor:
    """z (B, z_dim) -> images (B, H, W, C) float32 in [-1, 1]; ``update``
    receives the new BN running averages."""
    base, n = base_and_blocks(c["output_size"])
    low = cast is not None
    x = dense(p, "project", z, cast)
    x = x.reshape(-1, base, base, c["gf_dim"] * 2 ** (n - 1)).permute(0, 3, 1, 2)
    x = torch.relu(batch_norm(p, "bn_in", x, train, update, low))
    for i in range(n - 1):
        x = deconv(p, f"deconv{i}", x, cast)
        x = torch.relu(batch_norm(p, f"bn{i}", x, train, update, low))
    x = deconv(p, "deconv_out", x, cast)
    return torch.tanh(x.float()).permute(0, 2, 3, 1)


def critic(c: dict, p: Params, x: Tensor, cast: Optional[Cast],
           new_u: Optional[Params] = None) -> Tensor:
    """images (B, H, W, C) -> features (B, dof_dim) float32."""
    _, n = base_and_blocks(c["output_size"])
    it = c.get("sn_iters", 1) if c["model"] == "sn-smmd" else 0
    x = x.permute(0, 3, 1, 2)
    for i in range(n):
        x = F.leaky_relu(conv(p, f"conv{i}", x, cast, it, new_u, stride=2), 0.2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return dense(p, "head", x, cast, it, new_u).float()
