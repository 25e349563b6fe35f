"""Write the webp fixtures of the port's webp decoder and their manifest.

    python tests/fixtures/port_webp/make_fixtures.py

Needs PIL with webp support (and numpy and the JAX package).  The images
are ``tools/make_assets.py``'s procedural fields, a sharp-edged pattern
(so that B_PRED sub-blocks and the loop filters run), random RGB, smooth
gradients and few-colour images, encoded:

* lossy through PIL at qualities 5 / 50 / 75 / 100 and methods 0 / 4 / 6,
  sizes 1x1 to 256x256 and 256x341 (LSUN's shorter side), and RGBA with
  ``exact`` (a ``VP8X`` file with an ``ALPH`` chunk);
* lossy through PIL's own libwebp (``WebPEncode`` by ``ctypes``) for what
  PIL's ``save`` cannot ask for: 2, 4 and 8 token partitions, the simple
  loop filter, filter strength 0 and sharpness above 0;
* lossless through PIL: random RGB at 96x128, 2, 4 and 16 colours (colour
  indexing with 8, 4 and 2 pixels per byte), a gradient, RGBA, methods 0
  and 6, and a 256x256 field at 16 levels a channel (the size that
  ``chip_smoke.py`` times);
* animations, of which the port reads the first frame as PIL shows it:
  lossy, lossless, with alpha (lossy and lossless), 256x256 (the size that
  ``chip_smoke.py`` times), and two built here from still frames (a first
  frame smaller than the canvas at an offset, a non-zero ANIM background,
  the blend flag on and off).

``manifest.json`` records, for each file, the SHA-256 of PIL's decoded RGB
bytes and of the JAX package's ``center_crop_resize`` of them at 64 (the
shorter side, LSUN's), so that a machine without PIL can hold the port to
PIL's bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import json
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))

# name, (h, w), image kind, encoder ("pil" save options or "lib" WebPConfig fields)
LOSSY = [
    ("lossy_q5_m4_61x47.webp", (47, 61), "edges", dict(quality=5, method=4)),
    ("lossy_q50_m0_61x47.webp", (47, 61), "edges", dict(quality=50, method=0)),
    ("lossy_q75_m4_61x47.webp", (47, 61), "edges", dict(quality=75, method=4)),
    ("lossy_q100_m6_61x47.webp", (47, 61), "edges", dict(quality=100, method=6)),
    ("lossy_q75_1x1.webp", (1, 1), "proc", dict(quality=75)),
    ("lossy_q60_13x7.webp", (7, 13), "edges", dict(quality=60)),
    ("lossy_q30_17x9.webp", (9, 17), "proc", dict(quality=30)),
    ("lossy_q75_256x341.webp", (341, 256), "proc", dict(quality=75)),
    ("lossy_q75_256x256.webp", (256, 256), "proc", dict(quality=75)),
    ("lossy_flat_skip_q50_m0_128x128.webp", (128, 128), "flat", dict(quality=50, method=0)),
    ("lossy_alpha_exact_33x29.webp", (29, 33), "rgba", dict(quality=75, exact=True)),
]
LOSSY_LIB = [
    ("lossy_parts2_64x96.webp", (96, 64), "edges", dict(partitions=1, method=0)),
    ("lossy_parts4_64x96.webp", (96, 64), "edges", dict(partitions=2, method=0)),
    ("lossy_parts8_64x160.webp", (160, 64), "edges", dict(partitions=3, method=0)),
    ("lossy_simple_filter_61x47.webp", (47, 61), "edges", dict(filter_type=0, filter_strength=60)),
    ("lossy_filter0_61x47.webp", (47, 61), "edges", dict(filter_strength=0)),
    ("lossy_sharp3_61x47.webp", (47, 61), "edges", dict(filter_sharpness=3, filter_strength=50)),
    ("lossy_sharp7_simple_61x47.webp", (47, 61), "edges",
     dict(filter_type=0, filter_sharpness=7, filter_strength=100)),
]
LOSSLESS = [
    ("lossless_random_96x128.webp", (96, 128), "random", dict(lossless=True)),
    ("lossless_2colours_37x21.webp", (21, 37), "colours2", dict(lossless=True)),
    ("lossless_4colours_37x21.webp", (21, 37), "colours4", dict(lossless=True)),
    ("lossless_16colours_45x33.webp", (33, 45), "colours16", dict(lossless=True)),
    ("lossless_gradient_m6_64x48.webp", (48, 64), "gradient", dict(lossless=True, method=6,
                                                                   quality=100)),
    ("lossless_proc_m0_50x40.webp", (40, 50), "proc", dict(lossless=True, method=0)),
    ("lossless_rgba_31x23.webp", (23, 31), "rgba", dict(lossless=True)),
    ("lossless_levels16_256x256.webp", (256, 256), "proc16", dict(lossless=True)),
]
# animations, whose first frame PIL shows: name, (h, w), image kind, PIL
# save options; "hand" files are built here (``animation``): a first frame
# smaller than its canvas at an offset, over a non-zero ANIM background,
# with the frame's blend flag on or off
ANIMATED = [
    ("animated_lossy_16x16.webp", (16, 16), "proc", dict(duration=100, loop=0)),
    ("animated_lossless_40x30.webp", (30, 40), "proc", dict(lossless=True, duration=80)),
    ("animated_alpha_lossy_33x29.webp", (29, 33), "rgba", dict(quality=75, duration=80)),
    ("animated_alpha_lossless_31x23.webp", (23, 31), "rgba", dict(lossless=True, exact=True,
                                                                 duration=80)),
    ("animated_lossy_256x256.webp", (256, 256), "proc", dict(quality=40, method=0,
                                                             duration=80)),
]
HAND_ANIMATED = [
    ("animated_offset_blend_alpha_64x48.webp", (48, 64), "rgba", dict(quality=70, exact=True),
     (10, 6), 0),
    ("animated_offset_noblend_lossless_64x48.webp", (48, 64), "rgba",
     dict(lossless=True, exact=True), (22, 14), 2),
]


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def make_image(rng, h: int, w: int, kind: str) -> np.ndarray:
    from tools.make_assets import _proc_image
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "proc":
        return _proc_image(rng, h, w)
    if kind == "proc16":   # 16 levels a channel: a 256 px lossless file of ~40 KB
        return _proc_image(rng, h, w) // 16 * 16
    if kind == "random":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "gradient":
        return np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                         (xx + yy) * 127 // max(w + h - 2, 1)], -1).astype(np.uint8)
    if kind == "flat":
        a = np.full((h, w, 3), (90, 140, 200), np.uint8)
        a[h // 3:2 * h // 3, w // 4:3 * w // 4] = (230, 40, 20)
        return a
    if kind.startswith("colours"):
        pal = rng.integers(0, 256, (int(kind[7:]), 3), dtype=np.uint8)
        return pal[rng.integers(0, len(pal), (h, w))]
    if kind == "rgba":
        a = np.concatenate([_proc_image(rng, h, w), np.zeros((h, w, 1), np.uint8)], -1)
        a[..., 3] = np.where((xx + yy) % 5 == 0, 0, 255 - (xx * 7) % 200)
        return a
    # "edges": a checker of sharp edges with diagonals and noise
    a = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (xx + yy) * 7 % 256], -1)
    a[(xx // 5 + yy // 3) % 2 == 0] = (250, 10, 30)
    a[(xx - yy) % 11 == 0] = (0, 0, 0)
    return (a + rng.integers(-20, 20, a.shape)).clip(0, 255).astype(np.uint8)


class _Config(ctypes.Structure):
    """libwebp's WebPConfig (encode.h), followed by spare room."""
    _fields_ = [(n, ctypes.c_float if n in ("quality", "target_PSNR") else ctypes.c_int)
                for n in ("lossless quality method image_hint target_size target_PSNR segments "
                          "sns_strength filter_strength filter_sharpness filter_type autofilter "
                          "alpha_compression alpha_filtering alpha_quality pass_ show_compressed "
                          "preprocessing partitions partition_limit emulate_jpeg_size "
                          "thread_level low_memory near_lossless exact use_delta_palette "
                          "use_sharp_yuv qmin qmax").split()] + [("_spare", ctypes.c_int * 32)]


class _Picture(ctypes.Structure):
    """The head of libwebp's WebPPicture, up to the writer, then spare room."""
    _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int),
                ("y", ctypes.c_void_p), ("u", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("y_stride", ctypes.c_int), ("uv_stride", ctypes.c_int),
                ("a", ctypes.c_void_p), ("a_stride", ctypes.c_int), ("pad1", ctypes.c_uint32 * 2),
                ("argb", ctypes.c_void_p), ("argb_stride", ctypes.c_int),
                ("pad2", ctypes.c_uint32 * 3), ("writer", ctypes.c_void_p),
                ("custom_ptr", ctypes.c_void_p), ("_spare", ctypes.c_uint8 * 1024)]


class _MemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32 * 4)]


def _pil_libwebp() -> ctypes.CDLL:
    import PIL
    libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs")
    names = os.listdir(libs)
    for f in names:   # libwebp's dependency first, visible to it
        if f.startswith("libsharpyuv"):
            ctypes.CDLL(os.path.join(libs, f), mode=ctypes.RTLD_GLOBAL)
    return ctypes.CDLL(os.path.join(libs, next(f for f in names if f.startswith("libwebp-"))))


def lib_encode(rgb: np.ndarray, quality: float = 75, **fields) -> bytes:
    """Lossy webp of (h, w, 3) uint8 through PIL's bundled libwebp, with
    WebPConfig fields that PIL's ``save`` does not pass."""
    lib = _pil_libwebp()
    abi = (0x0210, 0x020f, 0x020e)
    cfg = _Config()
    if not any(lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, ctypes.c_float(quality), v)
               for v in abi):
        raise RuntimeError("WebPConfigInit failed")
    for k, v in fields.items():
        setattr(cfg, k, v)
    if not lib.WebPValidateConfig(ctypes.byref(cfg)):
        raise RuntimeError(f"invalid WebPConfig {fields}")
    pic = _Picture()
    if not any(lib.WebPPictureInitInternal(ctypes.byref(pic), v) for v in abi):
        raise RuntimeError("WebPPictureInit failed")
    h, w, _ = rgb.shape
    pic.width, pic.height = w, h
    rgb = np.ascontiguousarray(rgb)
    writer = _MemoryWriter()
    try:
        if not lib.WebPPictureImportRGB(ctypes.byref(pic), rgb.ctypes.data_as(ctypes.c_void_p),
                                        w * 3):
            raise RuntimeError("WebPPictureImportRGB failed")
        lib.WebPMemoryWriterInit(ctypes.byref(writer))
        pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
        pic.custom_ptr = ctypes.addressof(writer)
        if not lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)):
            raise RuntimeError("WebPEncode failed")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(writer))


def pil_hashes(data: bytes) -> dict:
    """PIL's decoded RGB bytes and the JAX package's 64 px crop of them."""
    from PIL import Image
    sys.path.insert(0, ROOT)
    from smmdax.data.pipeline import center_crop_resize
    img = Image.open(io.BytesIO(data)).convert("RGB")
    return dict(width=img.size[0], height=img.size[1], rgb_sha256=sha(np.asarray(img)),
                crop64_sha256=sha(np.asarray(center_crop_resize(img, 64))))


def pil_encode(arr: np.ndarray, **opts) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr, "RGBA" if arr.shape[-1] == 4 else "RGB").save(buf, format="WEBP", **opts)
    return buf.getvalue()


def _chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")


def _le24(v: int) -> bytes:
    return struct.pack("<I", v)[:3]


def animation(canvas, frames, background=(10, 20, 30, 255)) -> bytes:
    """An animated webp of ``canvas`` (w, h): VP8X (animation and alpha
    flags), ANIM with ``background`` (RGBA), and one ANMF per (x, y, still
    webp, flags) frame, the still file's image chunks (ALPH, VP8 / VP8L)
    inside it."""
    cw, ch = canvas
    body = _chunk(b"VP8X", bytes([0x12, 0, 0, 0]) + _le24(cw - 1) + _le24(ch - 1))
    r, g, b, a = background
    body += _chunk(b"ANIM", bytes([b, g, r, a, 0, 0]))
    for x, y, still, flags in frames:
        chunks = still[12:]
        if chunks[:4] == b"VP8X":
            chunks = chunks[18:]
        w, h = _still_size(still)
        body += _chunk(b"ANMF", _le24(x // 2) + _le24(y // 2) + _le24(w - 1) + _le24(h - 1)
                       + _le24(100) + bytes([flags]) + chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _still_size(data: bytes) -> tuple:
    from PIL import Image
    return Image.open(io.BytesIO(data)).size


def main() -> None:
    from PIL import Image

    sys.path.insert(0, ROOT)
    rng = np.random.default_rng(1010)
    entries = []
    for group, encoder in ((LOSSY, "pil"), (LOSSY_LIB, "libwebp"), (LOSSLESS, "pil")):
        for name, (h, w), kind, opts in group:
            arr = make_image(rng, h, w, kind)
            data = pil_encode(arr, **opts) if encoder == "pil" else lib_encode(arr, **opts)
            with open(os.path.join(HERE, name), "wb") as f:
                f.write(data)
            entries.append(dict(name=name, encoder=encoder, options=opts, **pil_hashes(data)))
    for name, (h, w), kind, opts in ANIMATED:
        frames = [make_image(rng, h, w, kind) for _ in range(2)]
        frames = [Image.fromarray(a, "RGBA" if a.shape[-1] == 4 else "RGB") for a in frames]
        buf = io.BytesIO()
        frames[0].save(buf, format="WEBP", save_all=True, append_images=frames[1:], **opts)
        data = buf.getvalue()
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        entries.append(dict(name=name, encoder="pil", options=opts, **pil_hashes(data)))
    for name, (h, w), kind, opts, (x, y), flags in HAND_ANIMATED:
        first = pil_encode(make_image(rng, h // 2, w // 2, kind), **opts)
        second = pil_encode(make_image(rng, h, w, "proc"), quality=60)
        data = animation((w, h), [(x, y, first, flags), (0, 0, second, 0)])
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        entries.append(dict(name=name, encoder="hand", options=opts, offset=[x, y],
                            blend=flags & 2 == 0, **pil_hashes(data)))
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump({"generator": "tests/fixtures/port_webp/make_fixtures.py",
                   "files": entries}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
