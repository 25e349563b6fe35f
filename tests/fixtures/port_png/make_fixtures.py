"""Write the PNG fixtures of the port's PNG decoder and their manifest.

    python tests/fixtures/port_png/make_fixtures.py

Needs PIL (and numpy and the JAX package).  The images are
``tools/make_assets.py``'s procedural fields, quantised to the layout's
levels, written:

* by PIL's own encoder: palette (``P``) at 1, 2, 4 and 8 bits with and
  without ``tRNS``, grey at 1 and 16 bits, grey+alpha at 8 bits, and
  256x256 palette and 16-bit grey files (the sizes that ``chip_smoke.py``
  times);
* by hand (``encode``, below), for what PIL's ``save`` cannot ask for:
  Adam7 interlacing (grey, palette and RGBA, images narrower than 8 px
  whose late passes are empty, and a 256x256 RGB file), grey at 2 and 4
  bits, RGB, RGBA and grey+alpha at 16 bits, and every row filter (None,
  Sub, Up, Average, Paeth) in turn.

``manifest.json`` records, for each file, the SHA-256 of PIL's decoded RGB
bytes and of the JAX package's ``center_crop_resize`` of them at 160
(crop 160) and at 64 (the shorter side), so that a machine without PIL can
hold the port to PIL's bytes.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))

# name, (h, w), PIL mode, save options ("pil"), or colour type, bit depth
# and Adam7 ("hand"); the filters cycle None, Sub, Up, Average, Paeth row
# by row in every hand-written file
PIL_FILES = [
    ("p1_37x21.png", (21, 37), "P", dict(bits=1)),
    ("p2_37x21.png", (21, 37), "P", dict(bits=2)),
    ("p4_45x33.png", (33, 45), "P", dict(bits=4)),
    ("p8_45x33.png", (33, 45), "P", dict()),
    ("p1_trns_37x21.png", (21, 37), "P", dict(bits=1, transparency=0)),
    ("p4_trns_45x33.png", (33, 45), "P", dict(bits=4, transparency=bytes(range(0, 256, 16)))),
    ("p8_trns_45x33.png", (33, 45), "P", dict(transparency=3)),
    ("l1_37x21.png", (21, 37), "1", dict()),
    ("l16_45x33.png", (33, 45), "I;16", dict()),
    ("la8_31x23.png", (23, 31), "LA", dict()),
    ("rgb16_31x23.png", (23, 31), "RGB;16", dict()),      # written by hand: PIL saves 8 bits
    ("rgba16_31x23.png", (23, 31), "RGBA;16", dict()),
    ("p8_256x256.png", (256, 256), "P", dict()),
    ("l16_256x256.png", (256, 256), "I;16", dict()),
]
HAND_FILES = [
    ("filters_rgb8_40x30.png", (30, 40), 2, 8, False),
    ("filters_l4_29x20.png", (20, 29), 0, 4, False),
    ("l2_37x21.png", (21, 37), 0, 2, False),
    ("la16_29x20.png", (20, 29), 4, 16, False),
    ("adam7_l8_33x29.png", (29, 33), 0, 8, True),
    ("adam7_p2_37x21.png", (21, 37), 3, 2, True),
    ("adam7_rgba8_31x23.png", (23, 31), 6, 8, True),
    ("adam7_rgb8_5x9.png", (9, 5), 2, 8, True),
    ("adam7_l1_3x3.png", (3, 3), 0, 1, True),
    ("adam7_rgb8_256x256.png", (256, 256), 2, 8, True),
]


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def pil_hashes(data: bytes) -> dict:
    """PIL's decoded RGB bytes and the JAX package's crops of them."""
    from PIL import Image

    sys.path.insert(0, ROOT)
    from smmdax.data.pipeline import center_crop_resize
    img = Image.open(io.BytesIO(data)).convert("RGB")
    return dict(width=img.size[0], height=img.size[1], rgb_sha256=sha(np.asarray(img)),
                crop160_sha256=sha(np.asarray(center_crop_resize(img, 160, crop=160))),
                crop64_sha256=sha(np.asarray(center_crop_resize(img, 64))))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter_row(kind: int, line: np.ndarray, prior: np.ndarray, bpp: int) -> bytes:
    """One scanline under a PNG filter (the encoder's side of the decoder's
    unfiltering)."""
    x = line.astype(np.int32)
    up = prior.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
    up_left = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) >> 1
    else:
        p = left + up - up_left
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
    return bytes([kind]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes()


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(rows, n) sample values -> (rows, bytes) scanlines at ``depth``."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(samples.shape[0], -1)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = (samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(samples.shape[0], -1).astype(np.uint8), axis=1)


def encode(samples: np.ndarray, color: int, depth: int, interlace: bool,
           palette: np.ndarray = None) -> bytes:
    """A PNG of (h, w, channels) sample values, Adam7 or not, its rows
    filtered None, Sub, Up, Average, Paeth in turn."""
    h, w = samples.shape[:2]
    ch = CHANNELS[color]
    bpp = max(1, ch * depth // 8)
    raw, n = bytearray(), 0
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        lines = _pack(sub.reshape(sub.shape[0], -1), depth)
        prior = np.zeros(lines.shape[1], np.uint8)
        for line in lines:
            raw += _filter_row(n % 5, line, prior, bpp)
            prior, n = line, n + 1
    head = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace))
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", head)
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + _chunk(b"IDAT", zlib.compress(bytes(raw), 9)) + _chunk(b"IEND", b"")


def _levels(rgb: np.ndarray, n: int) -> np.ndarray:
    """uint8 -> ``n`` evenly spaced levels 0..n-1."""
    return (rgb.astype(np.int64) * n // 256)


def pil_file(rng, h: int, w: int, mode: str, opts: dict) -> bytes:
    from PIL import Image
    from tools.make_assets import _proc_image
    rgb = _proc_image(rng, h, w)
    grey = rgb.mean(axis=2)
    if mode == "P":
        colours = 1 << opts.get("bits", 8)
        img = Image.fromarray(rgb).quantize(min(colours, 256))
    elif mode == "1":
        img = Image.fromarray((grey > 127).astype(np.uint8) * 255).convert("1")
    elif mode == "L":
        img = Image.fromarray(grey.astype(np.uint8))
    elif mode == "I;16":          # values over 255 too, which PIL's RGB clips
        v = (grey ** 2 / 40).astype(np.uint16) // 4 * 4
        img = Image.frombytes("I;16", (w, h), v.astype("<u2").tobytes())
    elif mode == "LA":
        a = (np.arange(w)[None, :] * 9 % 256 * np.ones((h, 1))).astype(np.uint8)
        img = Image.fromarray(np.stack([grey.astype(np.uint8), a], -1), "LA")
    else:                         # RGB;16 / RGBA;16: raw 16-bit big-endian samples
        ch = 3 if mode == "RGB;16" else 4
        s = np.concatenate([rgb.astype(np.uint16) * 257 + rng.integers(0, 200, (h, w, 3)),
                            np.full((h, w, 1), 40000, np.uint16)], -1)[..., :ch]
        # PIL saves RGB and RGBA at 8 bits: the 16-bit files are written here
        return encode(s, 2 if ch == 3 else 6, 16, False)
    buf = io.BytesIO()
    img.save(buf, format="PNG", **opts)
    return buf.getvalue()


def hand_file(rng, h: int, w: int, color: int, depth: int, interlace: bool) -> bytes:
    from tools.make_assets import _proc_image
    rgb = _proc_image(rng, h, w)
    if color == 3:
        n = 1 << depth
        palette = rng.integers(0, 256, (n, 3))
        return encode(_levels(rgb[..., :1], n), color, depth, interlace, palette)
    ch = CHANNELS[color]
    alpha = (np.arange(w)[None, :, None] * 13 % 256 * np.ones((h, 1, 1))).astype(np.int64)
    s = np.concatenate([rgb.astype(np.int64), alpha], -1)
    if ch <= 2:
        s = np.concatenate([rgb.astype(np.int64).mean(axis=2, keepdims=True).astype(np.int64),
                            alpha], -1)[..., :ch]
    else:
        s = s[..., :ch]
    if depth == 16:
        s = s * 257 + rng.integers(0, 256, s.shape)
    elif depth < 8:
        s = _levels(s, 1 << depth)
    elif h * w > 4096:            # 16 levels a channel: a 256 px file of ~70 KB
        s = s // 16 * 16
    return encode(s, color, depth, interlace)


def main() -> None:
    sys.path.insert(0, ROOT)
    rng = np.random.default_rng(1212)
    entries = []
    for name, (h, w), mode, opts in PIL_FILES:
        data = pil_file(rng, h, w, mode, opts)
        entries.append(dict(name=name, encoder="pil", mode=mode,
                            options={k: (list(v) if isinstance(v, bytes) else v)
                                     for k, v in opts.items()}))
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        entries[-1].update(pil_hashes(data))
    for name, (h, w), color, depth, interlace in HAND_FILES:
        data = hand_file(rng, h, w, color, depth, interlace)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        entries.append(dict(name=name, encoder="hand", colour_type=color, bit_depth=depth,
                            adam7=interlace, **pil_hashes(data)))
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump({"generator": "tests/fixtures/port_png/make_fixtures.py",
                   "files": entries}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
