"""Plain reference of the SN-GAN ResNet pair (``"architecture":
"resnet"``).

Written from the model's equations (Arbel et al. 2018, arXiv:1805.11565;
SN-GAN ResNet blocks) in the layout the port documents.  Initial weights:
flax's ``glorot_uniform`` for every kernel, zero biases, BatchNorm scale
1 and bias 0, and under ``sn-smmd`` each critic layer's ``u`` drawn after
its kernel as a normalised standard normal.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..layers import (Cast, Params, Tensor, _glorot, _l2n, _up, base_and_blocks, batch_norm,
                      bn_params, conv, sn_weight)


def gen_widths(gf_dim: int, n_up: int) -> List[int]:
    if n_up <= 3:
        return [4 * gf_dim] * n_up
    return [gf_dim * (2 ** (n_up - 1 - i)) for i in range(n_up)]


def disc_blocks(df_dim: int, c_dim: int, n_down: int) -> List[Tuple[int, int, bool, bool]]:
    """(in, out, downsample, first) of every critic block."""
    if n_down <= 3:
        w = 2 * df_dim
        return [(c_dim, w, True, True), (w, w, True, False),
                (w, w, False, False), (w, w, False, False)]
    out, cin = [], c_dim
    for i in range(n_down):
        w = df_dim * (2 ** i)
        out.append((cin, w, True, i == 0))
        cin = w
    return out


def init_weights(c: dict, seed: int) -> Tuple[Params, Params]:
    """(generator, critic) weights and buffers for config ``c``, drawn on
    the CPU from ``seed`` in the order described in the module docstring."""
    g = torch.Generator().manual_seed(seed)
    base, n = base_and_blocks(c["output_size"])
    gp: Params = {}
    widths = gen_widths(c["gf_dim"], n)
    gp["project.weight"] = _glorot((base * base * widths[0], c["z_dim"]), c["z_dim"],
                                   base * base * widths[0], g)
    gp["project.bias"] = torch.zeros(base * base * widths[0])

    def conv_params(p: Params, name: str, cin: int, cout: int, k: int, sn: bool) -> None:
        p[f"{name}.weight"] = _glorot((cout, cin, k, k), cin * k * k, cout * k * k, g)
        p[f"{name}.bias"] = torch.zeros(cout)
        if sn:
            p[f"{name}.u"] = _l2n(torch.randn(cout, generator=g))

    cin = widths[0]
    for i, w in enumerate(widths):
        bn_params(gp, f"block{i}.bn1", cin)
        conv_params(gp, f"block{i}.conv1", cin, w, 3, False)
        bn_params(gp, f"block{i}.bn2", w)
        conv_params(gp, f"block{i}.conv2", w, w, 3, False)
        if cin != w:
            conv_params(gp, f"block{i}.conv_sc", cin, w, 1, False)
        cin = w
    bn_params(gp, "bn_out", cin)
    conv_params(gp, "conv_out", cin, c["c_dim"], 3, False)

    dp: Params = {}
    sn = c["model"] == "sn-smmd"
    for i, (ci, co, _, first) in enumerate(disc_blocks(c["df_dim"], c["c_dim"], n)):
        conv_params(dp, f"block{i}.conv1", ci, co, 3, sn)
        conv_params(dp, f"block{i}.conv2", co, co, 3, sn)
        if first or ci != co:
            conv_params(dp, f"block{i}.conv_sc", ci, co, 1, sn)
        cin = co
    dp["head.weight"] = _glorot((c["dof_dim"], cin), cin, c["dof_dim"], g)
    dp["head.bias"] = torch.zeros(c["dof_dim"])
    if sn:
        dp["head.u"] = _l2n(torch.randn(c["dof_dim"], generator=g))
    return gp, dp


def generator(c: dict, p: Params, z: Tensor, train: bool, cast: Optional[Cast],
              update: Optional[Params] = None) -> Tensor:
    """z (B, z_dim) -> images (B, H, W, C) float32 in [-1, 1]; ``update``
    receives the new BN running averages."""
    base, n = base_and_blocks(c["output_size"])
    widths = gen_widths(c["gf_dim"], n)
    low = cast is not None
    w, b = p["project.weight"], p["project.bias"]
    if low:
        z, w, b = cast(z), cast(w), b.to(torch.bfloat16)
    x = (z @ w.T + b).reshape(-1, base, base, widths[0]).permute(0, 3, 1, 2)
    cin = widths[0]
    for i, wd in enumerate(widths):
        h = torch.relu(batch_norm(p, f"block{i}.bn1", x, train, update, low))
        h = conv(p, f"block{i}.conv1", _up(h), cast)
        h = torch.relu(batch_norm(p, f"block{i}.bn2", h, train, update, low))
        h = conv(p, f"block{i}.conv2", h, cast)
        sc = _up(x)
        if cin != wd:
            sc = conv(p, f"block{i}.conv_sc", sc, cast)
        x = h + sc
        cin = wd
    x = torch.relu(batch_norm(p, "bn_out", x, train, update, low))
    x = conv(p, "conv_out", x, cast)
    return torch.tanh(x.float()).permute(0, 2, 3, 1)


def critic(c: dict, p: Params, x: Tensor, cast: Optional[Cast],
           new_u: Optional[Params] = None) -> Tensor:
    """images (B, H, W, C) -> features (B, dof_dim) float32."""
    _, n = base_and_blocks(c["output_size"])
    it = c.get("sn_iters", 1) if c["model"] == "sn-smmd" else 0
    x = x.permute(0, 3, 1, 2)
    for i, (ci, co, down, first) in enumerate(disc_blocks(c["df_dim"], c["c_dim"], n)):
        h = x if first else torch.relu(x)
        h = conv(p, f"block{i}.conv1", h, cast, it, new_u)
        h = conv(p, f"block{i}.conv2", torch.relu(h), cast, it, new_u)
        if down:
            h = F.avg_pool2d(h, 2, 2)
        sc = x
        if first:
            if down:
                sc = F.avg_pool2d(sc, 2, 2)
            sc = conv(p, f"block{i}.conv_sc", sc, cast, it, new_u)
        else:
            if ci != co:
                sc = conv(p, f"block{i}.conv_sc", sc, cast, it, new_u)
            if down:
                sc = F.avg_pool2d(sc, 2, 2)
        x = h + sc
    x = torch.sum(torch.relu(x).float(), dim=(2, 3))
    w = sn_weight(p, "head", it, new_u) if it else p["head.weight"]
    return x @ w.T + p["head.bias"]
