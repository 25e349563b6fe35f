"""Build and load the native image libraries (``data/_native/*.cpp``).

Four sources, each its own library: ``jpeg.cpp`` (the JPEG decoder and
PIL's bilinear resize), ``webp.cpp`` (the webp decoder: lossless, lossy,
and an animation's first frame), ``png.cpp`` (PNG's filters, Adam7 and
samples to RGB, after Python's ``zlib`` has inflated the image data) and
``jpeg_encode.cpp`` (the baseline JPEG encoder of the asset tools).
Each is compiled with ``g++ -O3 -shared -fPIC`` at first use into
``smmdax_torch/_build/`` (listed in ``.gitignore``), under a name hashed
from the source, the flags and the machine, and bound with ``ctypes``
(plain C interface).  The compiler writes to a temporary name that
``os.replace`` then moves into place, so processes building at once never
load half a file.  A ``ctypes`` call releases the GIL: a pool of threads
decodes (or encodes) side by side.

There is no fallback: if a library cannot be built or loaded, decoding
and encoding raise.  The plain JPEG and PNG decoders (``data/jpeg.py``,
``utils.decode_png``) are the references the tests hold the native ones
to, never substitutes for them, and so is the plain encoder
(``data/jpeg_encode.py``) to the native one; every decoder is held to
PIL's decodes and the encoder to PIL's files (live in the tests, as
recorded digests on a machine without PIL).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

from smmdax_torch.data.jpeg import unsupported

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(PACKAGE_DIR, "data", "_native")
SOURCE = os.path.join(NATIVE_DIR, "jpeg.cpp")
WEBP_SOURCE = os.path.join(NATIVE_DIR, "webp.cpp")
PNG_SOURCE = os.path.join(NATIVE_DIR, "png.cpp")
ENCODE_SOURCE = os.path.join(NATIVE_DIR, "jpeg_encode.cpp")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB = None
_WEBP_LIB = None
_PNG_LIB = None
_ENCODE_LIB = None
_ERRLEN = 512


def library_path(source: str = None, stem: str = "libjpeg_decode") -> str:
    with open(SOURCE if source is None else source, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(FLAGS).encode() + platform.machine().encode())
    return os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")


def build(source: str = None, stem: str = "libjpeg_decode", what: str = "JPEG decoder") -> str:
    """Compile a library (the JPEG one by default) if it is not current;
    its path.  Every failure raises ``RuntimeError``: a missing source or
    compiler is not the missing dataset that a ``FileNotFoundError`` would
    announce."""
    source = SOURCE if source is None else source
    try:
        out = library_path(source, stem)
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
            proc = subprocess.run(["g++", *FLAGS, source, "-o", tmp],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build the {what}:\n{proc.stderr}")
            os.replace(tmp, out)
    except OSError as e:
        raise RuntimeError(f"cannot build the {what} from {source}: {e}") from e
    return out


def _load(source: str, stem: str, what: str) -> ctypes.CDLL:
    path = build(source, stem, what)
    try:
        return ctypes.CDLL(path)
    except OSError as e:
        raise RuntimeError(f"cannot load the {what} {path}: {e}") from e


def library() -> ctypes.CDLL:
    """The loaded JPEG decoder and resize, built first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = _load(SOURCE, "libjpeg_decode", "JPEG decoder")
            for name in ("smm_jpeg_size", "smm_jpeg_decode", "smm_resize_pil"):
                getattr(lib, name).restype = ctypes.c_int
            lib.smm_jpeg_size.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                          ctypes.c_char_p, ctypes.c_int]
            lib.smm_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
            i32, ptr = ctypes.c_int, ctypes.c_void_p
            lib.smm_resize_pil.argtypes = [ptr, i32, i32, i32, ctypes.c_int64, ptr, i32, i32,
                                           ptr, ptr, i32, ptr, ptr, i32]
            _LIB = lib
        return _LIB


def webp_library() -> ctypes.CDLL:
    """The loaded webp decoder, built first if needed."""
    global _WEBP_LIB
    with _LOCK:
        if _WEBP_LIB is None:
            lib = _load(WEBP_SOURCE, "libwebp_decode", "webp decoder")
            for name in ("smm_webp_size", "smm_webp_decode"):
                getattr(lib, name).restype = ctypes.c_int
            lib.smm_webp_size.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                          ctypes.c_char_p, ctypes.c_int]
            lib.smm_webp_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
            _WEBP_LIB = lib
        return _WEBP_LIB


def png_library() -> ctypes.CDLL:
    """The loaded PNG decoder, built first if needed."""
    global _PNG_LIB
    with _LOCK:
        if _PNG_LIB is None:
            lib = _load(PNG_SOURCE, "libpng_decode", "PNG decoder")
            lib.smm_png_decode.restype = ctypes.c_int
            i32, ptr = ctypes.c_int, ctypes.c_void_p
            lib.smm_png_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32, i32, i32, i32,
                                           i32, ptr, ptr, ctypes.c_char_p, i32]
            _PNG_LIB = lib
        return _PNG_LIB


def encode_library() -> ctypes.CDLL:
    """The loaded JPEG encoder, built first if needed."""
    global _ENCODE_LIB
    with _LOCK:
        if _ENCODE_LIB is None:
            lib = _load(ENCODE_SOURCE, "libjpeg_encode", "JPEG encoder")
            lib.smm_jpeg_encode.restype = ctypes.c_int
            lib.smm_jpeg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int64, ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_void_p),
                                            ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
                                            ctypes.c_int]
            lib.smm_jpeg_free.restype = None
            lib.smm_jpeg_free.argtypes = [ctypes.c_void_p]
            _ENCODE_LIB = lib
        return _ENCODE_LIB


def _raise(code: int, err) -> None:
    msg = err.value.decode(errors="replace")
    if code == 1:      # a layout PIL refuses too
        raise unsupported(msg)
    raise ValueError(f"corrupt JPEG: {msg}")


def _decode(size_fn, decode_fn, data: bytes, fail) -> np.ndarray:
    data = bytes(data)
    err = ctypes.create_string_buffer(_ERRLEN)
    wh = np.zeros(2, np.int32)
    code = size_fn(data, len(data), wh.ctypes.data, err, _ERRLEN)
    if code:
        fail(code, err)
    out = np.empty((int(wh[1]), int(wh[0]), 3), np.uint8)
    code = decode_fn(data, len(data), out.ctypes.data, out.nbytes, err, _ERRLEN)
    if code:
        fail(code, err)
    return out


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, equal to PIL's
    ``Image.open(...).convert("RGB")``.  A file PIL does not decode either
    raises ``JPEGUnsupported`` (a ``NotImplementedError``) saying so;
    corrupt data the decoder cannot follow raises ``ValueError``."""
    lib = library()
    return _decode(lib.smm_jpeg_size, lib.smm_jpeg_decode, data, _raise)


def _raise_webp(code: int, err) -> None:
    raise ValueError(f"corrupt webp: {err.value.decode(errors='replace')}")


def decode_webp(data: bytes) -> np.ndarray:
    """webp bytes (lossy or lossless, simple or extended, or an animation,
    whose first frame is read) -> (H, W, 3) uint8 RGB, equal to PIL's
    ``Image.open(...).convert("RGB")``.  Corrupt data raises
    ``ValueError``."""
    lib = webp_library()
    return _decode(lib.smm_webp_size, lib.smm_webp_decode, data, _raise_webp)


def decode_png(data: bytes, path: str = "PNG data") -> np.ndarray:
    """PNG bytes (every colour type and bit depth, Adam7 or not) -> (H, W,
    3) uint8 RGB, equal to PIL's ``Image.open(...).convert("RGB")``.
    Corrupt data raises ``ValueError``."""
    from smmdax_torch.utils import png_parts
    w, h, depth, color, interlace, palette, raw = png_parts(bytes(data), path)
    lib = png_library()
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib.smm_png_decode(raw, len(raw), w, h, depth, color, interlace, palette.ctypes.data,
                          out.ctypes.data, err, _ERRLEN):
        raise ValueError(f"{path}: corrupt PNG: {err.value.decode(errors='replace')}")
    return out


def encode_jpeg(u8: np.ndarray, quality: int) -> bytes:
    """(H, W, 3) uint8 RGB -> exactly the bytes of PIL's
    ``Image.fromarray(u8).save(buf, format="JPEG", quality=quality)``:
    baseline, 4:2:0, the standard Huffman tables.  Other input (not uint8,
    not RGB, quality outside 1..100) raises ``ValueError``."""
    from smmdax_torch.data.jpeg_encode import check_input
    check_input(u8, quality)
    if u8.strides[1] != 3 or u8.strides[2] != 1 or u8.strides[0] <= 0:
        u8 = np.ascontiguousarray(u8)
    lib = encode_library()
    out, n = ctypes.c_void_p(), ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib.smm_jpeg_encode(u8.ctypes.data, u8.shape[0], u8.shape[1], u8.strides[0], int(quality),
                           ctypes.byref(out), ctypes.byref(n), err, _ERRLEN):
        raise ValueError(f"encode_jpeg: {err.value.decode(errors='replace')}")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.smm_jpeg_free(out)


def resize_pil(u8: np.ndarray, size, xcoeffs, ycoeffs) -> np.ndarray:
    """The integer passes of PIL's bilinear resample of (H, W[, C]) uint8
    (rows may be strided) to ``size = (w, h)``, on (tap index, fixed-point
    weight) tables of each axis that the caller computes as Pillow does."""
    w, h = size
    u8 = np.asarray(u8)
    c = u8.shape[2] if u8.ndim == 3 else 1
    if u8.dtype != np.uint8 or u8.strides[0] <= 0 or u8.strides[1] != c or (
            u8.ndim == 3 and u8.strides[2] != 1):
        u8 = np.ascontiguousarray(u8, np.uint8)
    ih, iw = u8.shape[:2]
    out = np.empty((h, w) + u8.shape[2:], np.uint8)
    (xi, xk), (yi, yk) = xcoeffs, ycoeffs
    library().smm_resize_pil(u8.ctypes.data, ih, iw, c, u8.strides[0], out.ctypes.data, h, w,
                             xi.ctypes.data, xk.ctypes.data, xi.shape[1],
                             yi.ctypes.data, yk.ctypes.data, yi.shape[1])
    return out
