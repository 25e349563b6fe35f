"""Image grids, PNG files, metric logging and timers (copy of
``smmdax/utils.py``).

The machine with the card has neither PIL nor TensorFlow, so PNGs are
written with the standard library (``zlib`` + ``struct``: 8-bit grey or
RGB, no interlace) and read the same way (8-bit grey, RGB or RGBA, no
interlace, every row filter), and ``MetricWriter(tensorboard=True)``
raises instead of writing event files.
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


_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}          # colour type -> channels


def read_png(path: str) -> Array:
    """(H, W, 3) uint8 RGB pixels of an 8-bit non-interlaced grey, RGB or
    RGBA PNG: grey is repeated over the three channels and alpha dropped,
    as PIL's ``convert("RGB")`` does.  Other PNGs raise
    NotImplementedError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace or color not in _PNG_CHANNELS:
        raise NotImplementedError(
            f"{path}: PNG of bit depth {depth}, colour type {color}, interlace "
            f"{interlace}; the port reads 8-bit non-interlaced grey, RGB and RGBA "
            "(ROADMAP: image readers)")
    bpp = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * bpp)
    out = np.zeros((h, w * bpp), np.uint8)
    prior = np.zeros(w * bpp, np.int32)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if kind == 0:                                    # None
            cur = line
        elif kind == 1:                                  # Sub: running sum per channel
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:                                  # Up
            cur = (line + prior) & 0xFF
        elif kind in (3, 4):                             # Average, Paeth: left to right
            cur = line.copy()
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for x in range(0, w * bpp, bpp):
                up = prior[x:x + bpp]
                if kind == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - up_left
                    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up, up_left))
                cur[x:x + bpp] = (line[x:x + bpp] + pred) & 0xFF
                left, up_left = cur[x:x + bpp], up
        else:
            raise ValueError(f"{path}: row {y} has filter type {kind}")
        out[y] = cur
        prior = cur
    pixels = out.reshape(h, w, bpp)
    if bpp == 1:
        return np.repeat(pixels, 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def save_images(images: Array, path: str, nrow: Optional[int] = None) -> None:
    """Save a [-1,1] image batch as one PNG montage."""
    grid = make_grid(inverse_transform(images), nrow=nrow)
    arr = (np.clip(grid, 0, 1) * 255).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, arr)


class MetricWriter:
    """Metrics as JSONL on disk, and as stdout lines.  Over several ranks
    only rank 0's writer writes (the metrics are global); the others
    write nothing and create no file."""

    def __init__(self, log_dir: str, run_name: str, also_stdout: bool = True,
                 tensorboard: bool = False, rank: int = 0):
        if tensorboard:
            raise NotImplementedError(
                "tensorboard=True: the port has no TensorBoard writer yet (it "
                "needs one without TensorFlow, ROADMAP: a TensorBoard writer); the JSONL log "
                "under log_dir holds every metric")
        self.enabled = rank == 0
        self.also_stdout = also_stdout
        self.path = os.path.join(log_dir, f"{run_name}.jsonl")
        self._fh = None
        if not self.enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._fh = open(self.path, "a", buffering=1)

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        if not self.enabled:
            return
        rec = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in metrics.items()}}
        self._fh.write(json.dumps(rec) + "\n")
        if self.also_stdout:
            body = " ".join(
                f"{k}={v}" if isinstance(v, int) else f"{k}={v:.5g}"
                for k, v in rec.items() if k not in ("time",))
            print(f"[smmdax_torch] {body}", flush=True)

    def close(self) -> None:
        if self._fh is not None:
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
