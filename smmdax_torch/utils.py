"""Image grids, PNG files, metric logging and timers (copy of
``smmdax/utils.py``).

The machine with the card has neither PIL nor TensorFlow, so PNGs are
written with the standard library (``zlib`` + ``struct``: 8-bit grey or
RGB, no interlace) and read without PIL, to PIL's bytes: every colour type
(grey, RGB, palette, grey+alpha, RGBA) at every bit depth (1, 2, 4, 8,
16), Adam7 or not, every row filter.  ``read_png`` reads a file with the
native decoder (``data/native.py``, ``data/_native/png.cpp``);
``decode_png`` is its plain numpy version, and ``png_parts`` the chunk
walk and inflate that both share.  ``MetricWriter(tensorboard=True)``
writes TF2's event files with the standard library (``tfevents.py``).
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


_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}          # colour type -> channels
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_MAX_PIXELS = 178956970        # PIL refuses more: 2 * Image.MAX_IMAGE_PIXELS
# Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def read_png(path: str) -> Array:
    """(H, W, 3) uint8 RGB pixels of the PNG file at ``path``, as PIL's
    ``convert("RGB")`` gives them (the native decoder,
    ``data.native.decode_png``)."""
    from smmdax_torch.data.native import decode_png as native_decode_png
    with open(path, "rb") as f:
        return native_decode_png(f.read(), path)


def png_parts(data: bytes, path: str = "PNG data"):
    """A PNG's chunks: ``(width, height, depth, colour type, interlace,
    palette, image data)``, the palette (256, 3) uint8 from PLTE (black
    past its entries, as PIL's), the image data the IDAT chunks inflated.
    Corrupt or invalid files raise ValueError."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    palette = np.zeros((256, 3), np.uint8)
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR" and len(body) == 13:
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            entries = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)[:256]
            palette[:len(entries)] = entries
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, compression, filtering, interlace = header
    if w == 0 or h == 0 or w * h > _MAX_PIXELS or depth not in _PNG_DEPTHS.get(color, ()) or \
            compression or filtering or interlace > 1:
        raise ValueError(f"{path}: invalid PNG header (size {w}x{h}, bit depth {depth}, "
                         f"colour type {color}, methods {compression}/{filtering}/{interlace})")
    inflate = zlib.decompressobj()
    try:
        raw = inflate.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data: {e}") from e
    if not inflate.eof:
        raise ValueError(f"{path}: truncated PNG image data")
    return w, h, depth, color, interlace, palette, raw


def _png_unfilter(rows: Array, bpp: int, path: str) -> Array:
    """(rows, 1 + n) filtered scanlines -> (rows, n) bytes."""
    out = np.zeros((rows.shape[0], rows.shape[1] - 1), np.uint8)
    prior = np.zeros(rows.shape[1] - 1, np.int32)
    for y, (kind, line) in enumerate(zip(rows[:, 0], rows[:, 1:].astype(np.int32))):
        if kind == 0:                                    # None
            cur = line
        elif kind == 1:                                  # Sub: running sum per byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:                                  # Up
            cur = (line + prior) & 0xFF
        elif kind in (3, 4):                             # Average, Paeth: left to right
            cur = line.copy()
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for x in range(0, len(line), bpp):
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
    return out


def _png_rgb(img: Array, width: int, color: int, depth: int, palette: Array) -> Array:
    """(rows, n) unfiltered bytes -> (rows, width, 3) uint8, as PIL's modes
    and their conversion to RGB give them."""
    rows = img.shape[0]
    if depth < 8:                          # grey or palette, most significant bits first
        bits = np.unpackbits(img, axis=1)[:, :width * depth].reshape(rows, width, depth)
        v = (bits.astype(np.int64) << np.arange(depth - 1, -1, -1)).sum(axis=2)
        if color == 3:
            return palette[v]
        return np.repeat((v * (255 // ((1 << depth) - 1))).astype(np.uint8)[..., None], 3, 2)
    ch = _PNG_CHANNELS[color]
    if depth == 16:
        pairs = img.reshape(rows, width, ch, 2).astype(np.int64)
        if color == 0:                     # "I;16" -> RGB clips
            v = pairs[..., 0, 0] * 256 + pairs[..., 0, 1]
            return np.repeat(np.minimum(v, 255).astype(np.uint8)[..., None], 3, 2)
        px = pairs[..., 0].astype(np.uint8)                  # the high byte
    else:
        px = img.reshape(rows, width, ch)
    if color == 3:
        return palette[px[..., 0]]
    if ch <= 2:                            # grey (+ alpha)
        return np.repeat(px[..., :1], 3, 2)
    return np.ascontiguousarray(px[..., :3])


def decode_png(data: bytes, path: str = "PNG data") -> Array:
    """(H, W, 3) uint8 RGB pixels of a PNG's bytes, PIL's
    ``convert("RGB")``: every colour type and bit depth, Adam7 or not,
    every row filter; grey repeated over the three channels, palette
    indices looked up, 16-bit samples by their high byte (16-bit grey
    clipped to 255), alpha and tRNS dropped.  The plain version of
    ``data.native.decode_png``; corrupt files raise ValueError."""
    w, h, depth, color, interlace, palette, raw = png_parts(data, path)
    bits = _PNG_CHANNELS[color] * depth
    bpp = max(1, bits // 8)
    out = np.zeros((h, w, 3), np.uint8)
    pos = 0
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
        if pw == 0 or ph == 0:             # an empty pass has no rows
            continue
        n = (pw * bits + 7) // 8
        if len(raw) - pos < (n + 1) * ph:
            raise ValueError(f"{path}: truncated PNG image data")
        rows = np.frombuffer(raw, np.uint8, (n + 1) * ph, pos).reshape(ph, n + 1)
        pos += (n + 1) * ph
        out[y0::dy, x0::dx] = _png_rgb(_png_unfilter(rows, bpp, path), pw, color, depth, palette)
    return out


def save_images(images: Array, path: str, nrow: Optional[int] = None) -> None:
    """Save a [-1,1] image batch as one PNG montage."""
    grid = make_grid(inverse_transform(images), nrow=nrow)
    arr = (np.clip(grid, 0, 1) * 255).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, arr)


class MetricWriter:
    """Metrics as JSONL on disk, and as stdout lines; with ``tensorboard``
    also as TensorBoard event files under ``log_dir/tb/run_name``, flushed
    after every write, as the JAX package's ``tf.summary`` writer.  Over
    several ranks only rank 0's writer writes (the metrics are global); the
    others write nothing and create no file."""

    def __init__(self, log_dir: str, run_name: str, also_stdout: bool = True,
                 tensorboard: bool = False, rank: int = 0):
        self.enabled = rank == 0
        self.also_stdout = also_stdout
        self.path = os.path.join(log_dir, f"{run_name}.jsonl")
        self._fh = None
        self._tb = None
        if not self.enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._fh = open(self.path, "a", buffering=1)
        if tensorboard:
            from smmdax_torch.tfevents import EventFileWriter
            self._tb = EventFileWriter(os.path.join(log_dir, "tb", run_name))

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
        if self._tb is not None:
            self._tb.scalars(step, metrics)
            self._tb.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
        if self._tb is not None:
            self._tb.close()


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
