"""Image transforms on torch tensors (port of ``smmdax/data/transforms.py``).

Batches are (B, H, W, C), as in the JAX package, on the caller's device.
The random transforms draw from an explicit ``torch.Generator``, or take
their flags and offsets as arguments (JAX's threefry draws cannot be
reproduced, so the tests pass the same flags and offsets to both).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def normalize_uint8(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [-1, 1], exact at both endpoints."""
    return (x.float() - 127.5) / 127.5


def center_crop(x: torch.Tensor, crop: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, crop, crop, C) center crop."""
    h, w = x.shape[1], x.shape[2]
    top, left = (h - crop) // 2, (w - crop) // 2
    return x[:, top:top + crop, left:left + crop, :]


def resize_down_pow2(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """Antialiased power-of-two downsize by mean pooling (e.g. CelebA 160
    -> 80)."""
    h = x.shape[1]
    factor = h // out_size
    if factor * out_size != h or factor & (factor - 1):
        raise ValueError(f"resize_down_pow2 needs H == out*2^k, got {h}->{out_size}")
    while x.shape[1] > out_size:
        b, hh, ww, c = x.shape
        x = x.reshape(b, hh // 2, 2, ww // 2, 2, c).mean(dim=(2, 4))
    return x


def triangle_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of ``jax.image.resize``'s
    antialiased bilinear (triangle) filter along one axis, computed in
    float32 as JAX computes them: the kernel widened by the downscale
    factor, each column normalised to sum 1, columns whose sample lies
    outside the input zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


def resize_bilinear(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """General bilinear resize of (B, H, W, C) to (B, out, out, C), as
    ``jax.image.resize(..., "bilinear")`` (antialiased): one weight matrix
    per axis."""
    x = x.float() if not x.is_floating_point() else x
    h, w = x.shape[1], x.shape[2]
    if h != out_size:
        wh = torch.from_numpy(triangle_weights(h, out_size)).to(x)
        x = torch.einsum("bhwc,hy->bywc", x, wh)
    if w != out_size:
        ww = torch.from_numpy(triangle_weights(w, out_size)).to(x)
        x = torch.einsum("bhwc,wx->bhxc", x, ww)
    return x


def random_flip(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                flips: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample horizontal flip, where ``flips`` (B,) bool is set, or
    with probability 1/2 each from ``generator``."""
    if flips is None:
        flips = torch.rand(x.shape[0], generator=generator, device=x.device) < 0.5
    return torch.where(flips.to(x.device).view(-1, 1, 1, 1), x.flip(2), x)


def random_crop(x: torch.Tensor, crop: int, generator: Optional[torch.Generator] = None,
                tops: Optional[torch.Tensor] = None,
                lefts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample crop of side ``crop`` at (``tops``, ``lefts``), or at
    offsets drawn uniformly from ``generator``."""
    b, h, w = x.shape[0], x.shape[1], x.shape[2]
    if tops is None:
        tops = torch.randint(0, h - crop + 1, (b,), generator=generator, device=x.device)
    if lefts is None:
        lefts = torch.randint(0, w - crop + 1, (b,), generator=generator, device=x.device)
    rows = tops.to(x.device).view(b, 1) + torch.arange(crop, device=x.device)
    cols = lefts.to(x.device).view(b, 1) + torch.arange(crop, device=x.device)
    idx = torch.arange(b, device=x.device).view(b, 1, 1)
    return x[idx, rows.view(b, crop, 1), cols.view(b, 1, crop)]


def standard_pipeline(raw_uint8: torch.Tensor, generator: Optional[torch.Generator] = None, *,
                      crop: Optional[int] = None, out_size: Optional[int] = None,
                      flip: bool = False,
                      flips: Optional[torch.Tensor] = None) -> torch.Tensor:
    """normalize -> [center crop] -> [resize: mean pooling for 2^k ratios,
    else bilinear] -> [flip], as the JAX package's ``standard_pipeline``."""
    x = normalize_uint8(raw_uint8)
    if crop is not None and crop != x.shape[1]:
        x = center_crop(x, crop)
    if out_size is not None and out_size != x.shape[1]:
        h = x.shape[1]
        if h % out_size == 0 and ((h // out_size) & (h // out_size - 1)) == 0:
            x = resize_down_pow2(x, out_size)
        else:
            x = resize_bilinear(x, out_size)
    if flip:
        x = random_flip(x, generator, flips)
    return x
