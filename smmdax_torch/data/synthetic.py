"""Procedural data sources (numpy copies of ``smmdax/data/synthetic.py``):
the 1-D ``GaussianMix`` toy and ``SyntheticImages``.  The same (seed, key)
gives bit-identical batches in both packages."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

Array = np.ndarray


class GaussianMix:
    """1-D Gaussian mixture (means in [-0.8, 0.8], stddev 0.07): float32
    samples (B, dim), inside the generator's tanh range."""

    def __init__(self, means: Sequence[float] = (-0.8, -0.3, 0.3, 0.8),
                 stddev: float = 0.07, dim: int = 1, seed: int = 0):
        self.means = np.asarray(means, np.float32)
        self.stddev = float(stddev)
        self.dim = dim
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    @property
    def sample_shape(self) -> Tuple[int, ...]:
        return (self.dim,)

    def batch(self, n: int, key: Optional[int] = None,
              rows: Optional[Array] = None) -> Array:
        """n samples, or the ``rows`` of them (every draw of the n made)."""
        rng = self._rng if key is None else np.random.default_rng((self.seed, key))
        comp = rng.integers(0, len(self.means), size=n)
        noise = rng.standard_normal((n, self.dim)).astype(np.float32)
        if rows is not None:
            comp, noise = comp[rows], noise[rows]
        x = self.means[comp][:, None] + self.stddev * noise
        return x.astype(np.float32)


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

    def _draw(self, n: int, key: Optional[int], rows: Optional[Array] = None):
        """One prototype+shift gather plus the per-sample jitter, of the
        n samples or of their ``rows`` (every draw of the n is made)."""
        rng = self._rng if key is None else np.random.default_rng(
            (self.seed, key))
        idx = rng.integers(0, len(self.protos), size=n)
        gain = rng.uniform(0.7, 1.0, (n, 1, 1, 1)).astype(np.float32)
        bias = rng.uniform(-0.1, 0.1, (n, 1, 1, 1)).astype(np.float32)
        shifts = rng.integers(-4, 5, size=(n, 2))
        if rows is not None:
            idx, gain, bias, shifts = idx[rows], gain[rows], bias[rows], shifts[rows]
        ar = np.arange(self.size)
        row_idx = (ar[None, :] - shifts[:, 0:1]) % self.size
        col_idx = (ar[None, :] - shifts[:, 1:2]) % self.size
        imgs = self.protos[idx[:, None, None],
                           row_idx[:, :, None], col_idx[:, None, :]]
        return imgs, gain, bias

    def batch(self, n: int, key: Optional[int] = None,
              rows: Optional[Array] = None) -> Array:
        imgs, gain, bias = self._draw(n, key, rows)
        return np.clip(imgs * gain + bias, -1.0, 1.0)

    def batch_u8(self, n: int, key: Optional[int] = None,
                 rows: Optional[Array] = None) -> Array:
        """Exactly ``round((batch(n, key) + 1) * 127.5)`` as uint8."""
        imgs, gain, bias = self._draw(n, key, rows)
        out = np.rint(imgs * (gain * 127.5) + (bias + 1.0) * 127.5)
        np.clip(out, 0.0, 255.0, out=out)
        return out.astype(np.uint8)
