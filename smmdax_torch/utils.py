"""Image grids, PNG files, metric logging and timers (copy of
``smmdax/utils.py``).

The machine with the card has neither PIL nor TensorFlow, so PNGs are
written with the standard library (``zlib`` + ``struct``: 8-bit grey or
RGB, no interlace), and ``MetricWriter(tensorboard=True)`` raises instead
of writing event files.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Dict, Optional

import numpy as np

Array = np.ndarray


def inverse_transform(images: Array) -> Array:
    """[-1, 1] -> [0, 1]."""
    return (np.asarray(images) + 1.0) / 2.0


def make_grid(images: Array, nrow: Optional[int] = None, pad: int = 2) -> Array:
    """(N, H, W, C) in [0,1] -> one (gh, gw, C) montage in [0,1]."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    if nrow is None:
        nrow = int(np.ceil(np.sqrt(n)))
    ncol = int(np.ceil(n / nrow))
    grid = np.ones((ncol * (h + pad) + pad, nrow * (w + pad) + pad, c),
                   images.dtype)
    for i in range(n):
        r, col = divmod(i, nrow)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y:y + h, x:x + w] = images[i]
    return grid


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, pixels: Array) -> None:
    """Write (H, W) grey or (H, W, 3) RGB uint8 pixels as a PNG file."""
    pixels = np.ascontiguousarray(pixels)
    if pixels.dtype != np.uint8 or pixels.ndim not in (2, 3) or (
            pixels.ndim == 3 and pixels.shape[2] != 3):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, got "
                         f"{pixels.dtype} {pixels.shape}")
    h, w = pixels.shape[:2]
    color = 0 if pixels.ndim == 2 else 2
    rows = pixels.reshape(h, -1)
    # every scanline starts with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(raw, 6))
                + _png_chunk(b"IEND", b""))


def save_images(images: Array, path: str, nrow: Optional[int] = None) -> None:
    """Save a [-1,1] image batch as one PNG montage."""
    grid = make_grid(inverse_transform(images), nrow=nrow)
    arr = (np.clip(grid, 0, 1) * 255).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, arr)


class MetricWriter:
    """Metrics as JSONL on disk, and as stdout lines."""

    def __init__(self, log_dir: str, run_name: str, also_stdout: bool = True,
                 tensorboard: bool = False):
        if tensorboard:
            raise NotImplementedError(
                "tensorboard=True: the port has no TensorBoard writer yet (it "
                "needs one without TensorFlow, ROADMAP A.15); the JSONL log "
                "under log_dir holds every metric")
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{run_name}.jsonl")
        self._fh = open(self.path, "a", buffering=1)
        self.also_stdout = also_stdout

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in metrics.items()}}
        self._fh.write(json.dumps(rec) + "\n")
        if self.also_stdout:
            body = " ".join(
                f"{k}={v}" if isinstance(v, int) else f"{k}={v:.5g}"
                for k, v in rec.items() if k not in ("time",))
            print(f"[smmdax_torch] {body}", flush=True)

    def close(self) -> None:
        self._fh.close()


class StepTimer:
    """Wall-clock images/sec accounting for the train loop."""

    def __init__(self):
        self.t0 = time.time()
        self.images = 0

    def add(self, n: int) -> None:
        self.images += n

    def rate(self) -> float:
        dt = time.time() - self.t0
        return self.images / dt if dt > 0 else 0.0

    def reset(self) -> None:
        self.t0 = time.time()
        self.images = 0
