"""Animated GIF89a files with numpy and the standard library.

The JAX package stitches the toy's frames with PIL (``convert("P")``, then
``save(save_all=True, duration=..., loop=0)``); the machine with the card
has no PIL, so this module writes the file PIL would read the same way:

* the canvas is the first frame's size; every frame is drawn at the top
  left, cut to the canvas, and a smaller one leaves the rest of the canvas
  as the frame before it drew it (disposal 0, as PIL writes them);
* a frame equal to the one before it is not written again: the one before
  it is shown for both durations, as PIL merges them;
* each frame has its own palette: its colours where it has at most 256,
  else a median cut to 256 (each box split at the weighted median of its
  longest axis, the box with the most pixels times extent first) with
  every colour mapped to its nearest entry;
* LZW codes of 3 to 12 bits, a clear code whenever the table is full;
* the ``NETSCAPE2.0`` extension with a loop count of 0 (for ever), and a
  graphic control extension per frame with the delay in centiseconds.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np

Array = np.ndarray


def median_cut(colors: Array, counts: Array, n: int = 256) -> Array:
    """A palette of at most ``n`` colours for the (k, 3) uint8 ``colors``
    seen ``counts`` times each, in integer arithmetic (the same palette on
    every machine)."""
    colors = colors.astype(np.int64)
    counts = counts.astype(np.int64)

    def scored(b):   # (pixels x extent of the longest axis, box)
        c = colors[b]
        return (int((c.max(0) - c.min(0)).max()) * int(counts[b].sum()) if len(b) > 1 else 0, b)

    boxes = [scored(np.arange(len(colors)))]
    while len(boxes) < n:
        best = max(range(len(boxes)), key=lambda i: boxes[i][0])
        if boxes[best][0] == 0:
            break
        _, b = boxes.pop(best)
        c = colors[b]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        order = b[np.argsort(c[:, axis], kind="stable")]
        cum = np.cumsum(counts[order])
        cut = int(np.searchsorted(2 * cum, cum[-1])) + 1
        cut = min(max(cut, 1), len(order) - 1)
        boxes += [scored(order[:cut]), scored(order[cut:])]
    boxes = [b for _, b in boxes]
    pal = [((colors[b] * counts[b, None]).sum(0) + counts[b].sum() // 2) // counts[b].sum()
           for b in boxes]
    return np.array(pal).astype(np.uint8)


def quantize(rgb: Array) -> Tuple[Array, Array]:
    """(H, W, 3) uint8 -> (palette (k, 3) uint8 with k <= 256, indices (H,
    W) uint8); exact where the frame has at most 256 colours."""
    flat = np.ascontiguousarray(rgb).reshape(-1, 3)
    packed = (flat[:, 0].astype(np.uint32) << 16) | (flat[:, 1].astype(np.uint32) << 8) | flat[:, 2]
    uniq, inverse, counts = np.unique(packed, return_inverse=True, return_counts=True)
    colors = np.stack([(uniq >> 16) & 255, (uniq >> 8) & 255, uniq & 255], 1).astype(np.uint8)
    if len(colors) <= 256:
        return colors, inverse.astype(np.uint8).reshape(rgb.shape[:2])
    pal = median_cut(colors, counts)
    nearest = np.empty(len(colors), np.uint8)
    p = pal.astype(np.int32)
    for s in range(0, len(colors), 4096):
        c = colors[s:s + 4096].astype(np.int32)
        d = ((c[:, None, :] - p[None, :, :]) ** 2).sum(-1)
        nearest[s:s + 4096] = np.argmin(d, 1)
    return pal, nearest[inverse].reshape(rgb.shape[:2])


def lzw(indices: Array, min_size: int) -> bytes:
    """GIF's LZW coding of the palette indices, packed least significant
    bit first."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nacc = 0

    def emit(code: int, size: int) -> None:
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    size = min_size + 1
    table = {}
    next_code = eoi + 1
    emit(clear, size)
    data = indices.tobytes()
    prefix = data[0]
    for b in data[1:]:
        key = (prefix << 8) | b
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix, size)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << size) and size < 12:
                size += 1
        else:
            emit(clear, size)
            table.clear()
            next_code = eoi + 1
            size = min_size + 1
        prefix = b
    emit(prefix, size)
    emit(eoi, size)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def _blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def write_gif(path: str, frames: Sequence[Array], duration_ms: int) -> None:
    """Frames of (H, W, 3) uint8 -> an animated GIF at ``path``, looping
    for ever (PIL's ``loop=0``)."""
    h, w = frames[0].shape[:2]
    kept: List[Tuple[Array, int]] = []
    for f in frames:
        f = np.ascontiguousarray(f[:h, :w])
        if kept and kept[-1][0].shape == f.shape and np.array_equal(kept[-1][0], f):
            kept[-1] = (kept[-1][0], kept[-1][1] + duration_ms)
        else:
            kept.append((f, duration_ms))
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", w, h, 0, 0, 0))
    out += b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    for f, ms in kept:
        pal, idx = quantize(f)
        bits = max(1, int(np.ceil(np.log2(max(len(pal), 2)))))
        table = np.zeros((1 << bits, 3), np.uint8)
        table[:len(pal)] = pal
        out += b"!\xf9\x04\x00" + struct.pack("<H", int(round(ms / 10))) + b"\x00\x00"
        fh, fw = f.shape[:2]
        out += b"," + struct.pack("<HHHHB", 0, 0, fw, fh, 0x80 | (bits - 1)) + table.tobytes()
        min_size = max(2, bits)
        out += bytes([min_size]) + _blocks(lzw(idx, min_size))
    out += b";"
    with open(path, "wb") as fh_:
        fh_.write(bytes(out))
