"""Image decoding and PIL's bilinear resize, without PIL.

The JAX package decodes with PIL and resizes with ``Image.BILINEAR``; the
machine with the card has no PIL, and batches must stay byte-identical
to the JAX package's.  So:

* ``decode_image`` reads JPEG, PNG and webp with the native decoders
  (``data/native.py``, PIL's bytes): every JPEG PIL decodes (Huffman or
  arithmetic coded, sequential, progressive or lossless, 8-bit, every
  integral sampling layout; grey, YCbCr, RGB, CMYK and YCCK), the rest
  raising ``JPEGUnsupported`` as PIL raises; PNG of every colour type and
  bit depth, Adam7 or not; webp lossy or lossless, still or animated (its
  first frame).  Any other format raises.
* ``resize_bilinear_pil`` is Pillow's ``ImagingResample`` with the
  bilinear filter: per axis, the triangle filter's support widened by the
  downscale factor, weights normalised in float64 and turned into fixed
  point with 22 fractional bits (rounded half away from zero), computed
  here as Pillow computes them; the horizontal pass first, rounded to
  uint8, then the vertical one, each summing from ``1 << 21``, shifting
  right by 22 and clipping.  The passes run in the native library
  (``data/native.py``); ``resize_bilinear_pil_plain`` is the same in numpy,
  the plain version the tests hold them to.
* ``center_crop_resize`` is the JAX package's crop clamped to the shorter
  side, then that resize.
"""

from __future__ import annotations

import concurrent.futures as cf
import functools
import math
from typing import Optional, Tuple

import numpy as np

from smmdax_torch.data.jpeg import PACK_ROUTE

Array = np.ndarray

_PRECISION_BITS = 32 - 8 - 2

# threads of a source's decode pool (the JAX package's LSUN default)
DECODE_THREADS = 8


class DecodePool:
    """Decodes the drawn items of a batch in a pool of threads (the native
    decoder and resize release the GIL)."""

    def __init__(self, threads: int = DECODE_THREADS):
        self._pool = cf.ThreadPoolExecutor(max_workers=threads)

    def decode_into(self, fn, items, out: Array) -> Array:
        """``out[i] = fn(items[i])``, decoded in the pool."""
        for i, arr in enumerate(self._pool.map(fn, items)):
            out[i] = arr
        return out


def decode_image(data: bytes) -> Array:
    """Encoded image bytes -> (H, W, 3) uint8 RGB, as PIL's
    ``Image.open(...).convert("RGB")`` gives them."""
    head = bytes(data[:16])
    if head[:2] == b"\xff\xd8":
        from smmdax_torch.data.native import decode_jpeg
        return decode_jpeg(data)
    if head[:8] == b"\x89PNG\r\n\x1a\n":
        from smmdax_torch.data.native import decode_png
        return decode_png(data)
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        from smmdax_torch.data.native import decode_webp
        return decode_webp(data)
    raise NotImplementedError(
        f"image format with header {head[:8]!r}: the port decodes JPEG, PNG and webp; "
        f"{PACK_ROUTE}")


@functools.lru_cache(maxsize=64)
def _coeffs(in_size: int, out_size: int) -> Tuple[Array, Array]:
    """(taps index (out, k), fixed-point weights (out, k)) of one axis, as
    Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the box
    (0, in_size); taps past a pixel's span have weight 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int32)
    kk = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(1.0 - abs((x + xmin - center + 0.5) * ss), 0.0) for x in range(xmax)]
        ww = 0.0
        for v in w:                       # in order, as the C loop sums
            ww += v
        for x, v in enumerate(w):
            k = v / ww if ww != 0.0 else v
            kk[xx, x] = int(-0.5 + k * (1 << _PRECISION_BITS)) if k < 0 else \
                int(0.5 + k * (1 << _PRECISION_BITS))
            idx[xx, x] = xmin + x
    return idx, kk


def _pass(img: Array, axis: int, out_size: int) -> Array:
    idx, kk = _coeffs(img.shape[axis], out_size)
    taps = np.take(img.astype(np.int64), idx, axis=axis)        # axis -> (out, k)
    shape = [1] * taps.ndim
    shape[axis], shape[axis + 1] = kk.shape
    acc = (taps * kk.reshape(shape)).sum(axis=axis + 1) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear_pil(u8: Array, size: Tuple[int, int]) -> Array:
    """(H, W, C) or (H, W) uint8 -> (h, w[, C]) for ``size = (w, h)``,
    equal byte for byte to PIL's ``resize(size, Image.BILINEAR)``."""
    from smmdax_torch.data.native import resize_pil
    w, h = size
    ih, iw = u8.shape[:2]
    if (ih, iw) == (h, w):
        return np.array(u8)
    return resize_pil(u8, size, _coeffs(iw, w), _coeffs(ih, h))


def resize_bilinear_pil_plain(u8: Array, size: Tuple[int, int]) -> Array:
    """``resize_bilinear_pil`` in numpy: its plain version."""
    w, h = size
    out = np.asarray(u8)
    if out.shape[1] != w:
        out = _pass(out, 1, w)
    if out.shape[0] != h:
        out = _pass(out, 0, h)
    return out if out is not u8 else out.copy()


def center_crop_resize(u8: Array, size: int, crop: Optional[int] = None) -> Array:
    """(H, W, C) uint8 -> center crop of side ``crop`` (clamped to the
    shorter side; default the shorter side) -> bilinear resize to (size,
    size), as the JAX package's ``center_crop_resize`` on a PIL image."""
    h, w = u8.shape[:2]
    c = min(w, h) if crop is None else min(crop, w, h)
    left, top = (w - c) // 2, (h - c) // 2
    img = u8[top:top + c, left:left + c]
    if size != c:
        return resize_bilinear_pil(img, (size, size))
    return np.ascontiguousarray(img)
