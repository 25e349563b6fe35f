"""Procedural image source (numpy copy of ``smmdax/data/synthetic.py``'s
``SyntheticImages``): the same (seed, key) gives bit-identical batches
in both packages."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

Array = np.ndarray


class SyntheticImages:
    """K random smooth blob prototypes plus per-sample color jitter and
    circular shift, in [-1, 1] (or uint8 through ``batch_u8``)."""

    def __init__(self, size: int = 32, channels: int = 3,
                 num_prototypes: int = 64, seed: int = 0):
        self.size = size
        self.channels = channels
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        protos = np.zeros((num_prototypes, size, size, channels), np.float32)
        for p in range(num_prototypes):
            img = np.zeros((size, size, channels), np.float32)
            for _ in range(self._rng.integers(2, 6)):
                cx, cy = self._rng.uniform(0.15, 0.85, 2)
                s = self._rng.uniform(0.05, 0.3)
                bump = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s)))
                color = self._rng.uniform(-1, 1, channels).astype(np.float32)
                img += bump[..., None] * color
            m = np.abs(img).max() + 1e-6
            protos[p] = img / m
        self.protos = protos

    @property
    def sample_shape(self) -> Tuple[int, ...]:
        return (self.size, self.size, self.channels)

    def _draw(self, n: int, key: Optional[int]):
        """One prototype+shift gather plus the per-sample jitter."""
        rng = self._rng if key is None else np.random.default_rng(
            (self.seed, key))
        idx = rng.integers(0, len(self.protos), size=n)
        gain = rng.uniform(0.7, 1.0, (n, 1, 1, 1)).astype(np.float32)
        bias = rng.uniform(-0.1, 0.1, (n, 1, 1, 1)).astype(np.float32)
        shifts = rng.integers(-4, 5, size=(n, 2))
        ar = np.arange(self.size)
        row_idx = (ar[None, :] - shifts[:, 0:1]) % self.size
        col_idx = (ar[None, :] - shifts[:, 1:2]) % self.size
        imgs = self.protos[idx[:, None, None],
                           row_idx[:, :, None], col_idx[:, None, :]]
        return imgs, gain, bias

    def batch(self, n: int, key: Optional[int] = None) -> Array:
        imgs, gain, bias = self._draw(n, key)
        return np.clip(imgs * gain + bias, -1.0, 1.0)

    def batch_u8(self, n: int, key: Optional[int] = None) -> Array:
        """Exactly ``round((batch(n, key) + 1) * 127.5)`` as uint8."""
        imgs, gain, bias = self._draw(n, key)
        out = np.rint(imgs * (gain * 127.5) + (bias + 1.0) * 127.5)
        np.clip(out, 0.0, 255.0, out=out)
        return out.astype(np.uint8)
