"""Plain Inception-v3 (pool3 and logits) and the score math, the
scoring cell's reference.

The network is torchvision's ``inception_v3`` in float32 with TF32 off,
its BatchNorms folded into the convolutions in float32 numpy from a
torchvision-layout weights file (the file the benchmark writes and both
sides read).  The spec table and forward follow torchvision's module
layout (padding, strides, branch order, average pools that count padded
zeros, BN eps 1e-3).  Images in [-1, 1] are resized to 299 x 299
bilinearly (half-pixel centres, no antialiasing) after ImageNet
normalisation, and torchvision's ``transform_input`` remap is applied.

The scores are computed in float64 on the device: FID from the two sets'
means and covariances (the trace of sqrtm of the product from the
eigenvalues of the symmetrised product), KID as the unbiased polynomial
MMD^2 averaged over the subsets ``default_rng(0)`` draws, IS over 10
splits.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3
Params = Dict[str, Dict[str, torch.Tensor]]


def _a(prefix, c_in, c_pool):
    return {f"{prefix}.branch1x1": (c_in, 64, (1, 1), (1, 1), (0, 0)),
            f"{prefix}.branch5x5_1": (c_in, 48, (1, 1), (1, 1), (0, 0)),
            f"{prefix}.branch5x5_2": (48, 64, (5, 5), (1, 1), (2, 2)),
            f"{prefix}.branch3x3dbl_1": (c_in, 64, (1, 1), (1, 1), (0, 0)),
            f"{prefix}.branch3x3dbl_2": (64, 96, (3, 3), (1, 1), (1, 1)),
            f"{prefix}.branch3x3dbl_3": (96, 96, (3, 3), (1, 1), (1, 1)),
            f"{prefix}.branch_pool": (c_in, c_pool, (1, 1), (1, 1), (0, 0))}


def _c(prefix, c7):
    return {f"{prefix}.branch1x1": (768, 192, (1, 1), (1, 1), (0, 0)),
            f"{prefix}.branch7x7_1": (768, c7, (1, 1), (1, 1), (0, 0)),
            f"{prefix}.branch7x7_2": (c7, c7, (1, 7), (1, 1), (0, 3)),
            f"{prefix}.branch7x7_3": (c7, 192, (7, 1), (1, 1), (3, 0)),
            f"{prefix}.branch7x7dbl_1": (768, c7, (1, 1), (1, 1), (0, 0)),
            f"{prefix}.branch7x7dbl_2": (c7, c7, (7, 1), (1, 1), (3, 0)),
            f"{prefix}.branch7x7dbl_3": (c7, c7, (1, 7), (1, 1), (0, 3)),
            f"{prefix}.branch7x7dbl_4": (c7, c7, (7, 1), (1, 1), (3, 0)),
            f"{prefix}.branch7x7dbl_5": (c7, 192, (1, 7), (1, 1), (0, 3)),
            f"{prefix}.branch_pool": (768, 192, (1, 1), (1, 1), (0, 0))}


def _e(prefix, c_in):
    return {f"{prefix}.branch1x1": (c_in, 320, (1, 1), (1, 1), (0, 0)),
            f"{prefix}.branch3x3_1": (c_in, 384, (1, 1), (1, 1), (0, 0)),
            f"{prefix}.branch3x3_2a": (384, 384, (1, 3), (1, 1), (0, 1)),
            f"{prefix}.branch3x3_2b": (384, 384, (3, 1), (1, 1), (1, 0)),
            f"{prefix}.branch3x3dbl_1": (c_in, 448, (1, 1), (1, 1), (0, 0)),
            f"{prefix}.branch3x3dbl_2": (448, 384, (3, 3), (1, 1), (1, 1)),
            f"{prefix}.branch3x3dbl_3a": (384, 384, (1, 3), (1, 1), (0, 1)),
            f"{prefix}.branch3x3dbl_3b": (384, 384, (3, 1), (1, 1), (1, 0)),
            f"{prefix}.branch_pool": (c_in, 192, (1, 1), (1, 1), (0, 0))}


SPECS = {"Conv2d_1a_3x3": (3, 32, (3, 3), (2, 2), (0, 0)),
         "Conv2d_2a_3x3": (32, 32, (3, 3), (1, 1), (0, 0)),
         "Conv2d_2b_3x3": (32, 64, (3, 3), (1, 1), (1, 1)),
         "Conv2d_3b_1x1": (64, 80, (1, 1), (1, 1), (0, 0)),
         "Conv2d_4a_3x3": (80, 192, (3, 3), (1, 1), (0, 0))}
SPECS.update(_a("Mixed_5b", 192, 32))
SPECS.update(_a("Mixed_5c", 256, 64))
SPECS.update(_a("Mixed_5d", 288, 64))
SPECS.update({"Mixed_6a.branch3x3": (288, 384, (3, 3), (2, 2), (0, 0)),
              "Mixed_6a.branch3x3dbl_1": (288, 64, (1, 1), (1, 1), (0, 0)),
              "Mixed_6a.branch3x3dbl_2": (64, 96, (3, 3), (1, 1), (1, 1)),
              "Mixed_6a.branch3x3dbl_3": (96, 96, (3, 3), (2, 2), (0, 0))})
SPECS.update(_c("Mixed_6b", 128))
SPECS.update(_c("Mixed_6c", 160))
SPECS.update(_c("Mixed_6d", 160))
SPECS.update(_c("Mixed_6e", 192))
SPECS.update({"Mixed_7a.branch3x3_1": (768, 192, (1, 1), (1, 1), (0, 0)),
              "Mixed_7a.branch3x3_2": (192, 320, (3, 3), (2, 2), (0, 0)),
              "Mixed_7a.branch7x7x3_1": (768, 192, (1, 1), (1, 1), (0, 0)),
              "Mixed_7a.branch7x7x3_2": (192, 192, (1, 7), (1, 1), (0, 3)),
              "Mixed_7a.branch7x7x3_3": (192, 192, (7, 1), (1, 1), (3, 0)),
              "Mixed_7a.branch7x7x3_4": (192, 192, (3, 3), (2, 2), (0, 0))})
SPECS.update(_e("Mixed_7b", 1280))
SPECS.update(_e("Mixed_7c", 2048))

CLASSES = 1000


def load(path: str, device) -> Params:
    """Folded float32 weights from a torchvision-layout ``.npz``."""
    out: Params = {}
    with np.load(path) as z:
        for name in SPECS:
            w = z[f"{name}.conv.weight"].astype(np.float32)
            scale = (z[f"{name}.bn.weight"].astype(np.float32)
                     / np.sqrt(z[f"{name}.bn.running_var"].astype(np.float32) + np.float32(BN_EPS)))
            b = (z[f"{name}.bn.bias"].astype(np.float32)
                 - z[f"{name}.bn.running_mean"].astype(np.float32) * scale)
            out[name] = {"w": torch.from_numpy(w * scale[:, None, None, None]).to(device),
                         "b": torch.from_numpy(b).to(device)}
        out["fc"] = {"w": torch.from_numpy(np.ascontiguousarray(
                         z["fc.weight"].astype(np.float32).T)).to(device),
                     "b": torch.from_numpy(z["fc.bias"].astype(np.float32)).to(device)}
    return out


def meta_params() -> Params:
    """Weights of the right shapes on the meta device (FLOP counting)."""
    p = {n: {"w": torch.empty((co, ci, *k), device="meta"), "b": torch.empty(co, device="meta")}
         for n, (ci, co, k, _, _) in SPECS.items()}
    p["fc"] = {"w": torch.empty((2048, CLASSES), device="meta"),
               "b": torch.empty(CLASSES, device="meta")}
    return p


def _conv(p: Params, name: str, x):
    _, _, _, stride, pad = SPECS[name]
    return F.relu(F.conv2d(x, p[name]["w"], p[name]["b"], stride=stride, padding=pad))


def _avg(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def forward(p: Params, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """NHWC images in [-1, 1] -> (pool3, logits)."""
    mean = torch.tensor([0.485, 0.456, 0.406], dtype=images.dtype, device=images.device)
    std = torch.tensor([0.229, 0.224, 0.225], dtype=images.dtype, device=images.device)
    x = (((images + 1.0) * 0.5 - mean) / std).permute(0, 3, 1, 2)
    if x.shape[2] != 299:
        x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False)
    x = torch.stack([x[:, 0] * (0.229 / 0.5) + (0.485 - 0.5) / 0.5,
                     x[:, 1] * (0.224 / 0.5) + (0.456 - 0.5) / 0.5,
                     x[:, 2] * (0.225 / 0.5) + (0.406 - 0.5) / 0.5], dim=1)
    for n in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
        x = _conv(p, n, x)
    x = F.max_pool2d(x, 3, 2)
    x = F.max_pool2d(_conv(p, "Conv2d_4a_3x3", _conv(p, "Conv2d_3b_1x1", x)), 3, 2)
    for pre in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        b3 = _conv(p, f"{pre}.branch3x3dbl_2", _conv(p, f"{pre}.branch3x3dbl_1", x))
        x = torch.cat([_conv(p, f"{pre}.branch1x1", x),
                       _conv(p, f"{pre}.branch5x5_2", _conv(p, f"{pre}.branch5x5_1", x)),
                       _conv(p, f"{pre}.branch3x3dbl_3", b3),
                       _conv(p, f"{pre}.branch_pool", _avg(x))], dim=1)
    b3 = _conv(p, "Mixed_6a.branch3x3dbl_2", _conv(p, "Mixed_6a.branch3x3dbl_1", x))
    x = torch.cat([_conv(p, "Mixed_6a.branch3x3", x), _conv(p, "Mixed_6a.branch3x3dbl_3", b3),
                   F.max_pool2d(x, 3, 2)], dim=1)
    for pre in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        b7, bd = x, x
        for i in (1, 2, 3):
            b7 = _conv(p, f"{pre}.branch7x7_{i}", b7)
        for i in (1, 2, 3, 4, 5):
            bd = _conv(p, f"{pre}.branch7x7dbl_{i}", bd)
        x = torch.cat([_conv(p, f"{pre}.branch1x1", x), b7, bd,
                       _conv(p, f"{pre}.branch_pool", _avg(x))], dim=1)
    b7 = x
    for i in (1, 2, 3, 4):
        b7 = _conv(p, f"Mixed_7a.branch7x7x3_{i}", b7)
    x = torch.cat([_conv(p, "Mixed_7a.branch3x3_2", _conv(p, "Mixed_7a.branch3x3_1", x)), b7,
                   F.max_pool2d(x, 3, 2)], dim=1)
    for pre in ("Mixed_7b", "Mixed_7c"):
        b3 = _conv(p, f"{pre}.branch3x3_1", x)
        bd = _conv(p, f"{pre}.branch3x3dbl_2", _conv(p, f"{pre}.branch3x3dbl_1", x))
        x = torch.cat([_conv(p, f"{pre}.branch1x1", x),
                       _conv(p, f"{pre}.branch3x3_2a", b3), _conv(p, f"{pre}.branch3x3_2b", b3),
                       _conv(p, f"{pre}.branch3x3dbl_3a", bd),
                       _conv(p, f"{pre}.branch3x3dbl_3b", bd),
                       _conv(p, f"{pre}.branch_pool", _avg(x))], dim=1)
    pool3 = x.mean(dim=(2, 3))
    return pool3, pool3 @ p["fc"]["w"] + p["fc"]["b"]


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def features(p: Params, images: torch.Tensor, batch: int = 64):
    """(pool3, softmax probabilities) in float32, ``batch`` at a time."""
    pools, probs = [], []
    with torch.no_grad(), no_tf32():
        for i in range(0, len(images), batch):
            f, logits = forward(p, images[i:i + batch].float())
            pools.append(f)
            probs.append(torch.softmax(logits, dim=1))
    return torch.cat(pools), torch.cat(probs)


# ---------------------------------------------------------------------------
# scores, float64


def fid(real: torch.Tensor, fake: torch.Tensor, dtype=torch.float64) -> float:
    """FID; the means and covariances in ``dtype``, the rest in float64."""
    def stats(x):
        x = x.to(dtype)
        mu = x.mean(0)
        xc = x - mu
        return mu.double(), (xc.T @ xc / (len(x) - 1)).double()

    m1, s1 = stats(real)
    m2, s2 = stats(fake)
    w1, v1 = torch.linalg.eigh(s1)
    root1 = (v1 * torch.sqrt(torch.clamp_min(w1, 0.0))) @ v1.T
    w = torch.linalg.eigvalsh(root1 @ s2 @ root1)
    tr = torch.sqrt(torch.clamp_min(w, 0.0)).sum()
    d = m1 - m2
    return float(d @ d + torch.trace(s1) + torch.trace(s2) - 2.0 * tr)


def kid(real: torch.Tensor, fake: torch.Tensor, subset: int, subsets: int,
        dtype=torch.float64) -> float:
    """Mean over ``subsets`` of the unbiased MMD^2 with k = (x.y / d + 1)^3,
    the Gram blocks in ``dtype``."""
    rng = np.random.default_rng(0)
    m = min(subset, len(real), len(fake))
    r, f = real.to(dtype), fake.to(dtype)
    d = r.shape[1]
    vals = []
    for _ in range(subsets):
        ir = torch.from_numpy(rng.choice(len(real), m, replace=False)).to(real.device)
        jf = torch.from_numpy(rng.choice(len(fake), m, replace=False)).to(real.device)
        x, y = r[ir], f[jf]
        kxx, kyy, kxy = [(a @ b.T / d + 1.0) ** 3 for a, b in ((x, x), (y, y), (x, y))]
        vals.append(float((kxx.sum() - kxx.trace()) / (m * (m - 1))
                          + (kyy.sum() - kyy.trace()) / (m * (m - 1)) - 2.0 * kxy.mean()))
    return float(np.mean(vals))


def inception_score(probs: torch.Tensor, splits: int = 10, dtype=torch.float64) -> float:
    p = probs.to(dtype)
    n = len(p)
    scores = []
    for i in range(splits):
        part = p[i * n // splits:(i + 1) * n // splits]
        py = part.mean(0, keepdim=True)
        kl = part * (torch.log(part + 1e-12) - torch.log(py + 1e-12))
        scores.append(float(torch.exp(kl.sum(1).mean())))
    return float(np.mean(scores))
