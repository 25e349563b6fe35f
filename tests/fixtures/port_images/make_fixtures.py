"""Write the JPEG fixtures of the port's image decoder and their manifest.

    python tests/fixtures/port_images/make_fixtures.py

Needs PIL (and numpy).  The images are ``tools/make_assets.py``'s
procedural fields (``_proc_image``), encoded by PIL in the layouts the
port's decoder reads: baseline and progressive, CelebA's 178x218 at
quality 75 4:2:0, LSUN's 256x256 at quality 85, 4:2:2, 4:4:4, grey, odd
sizes, restart intervals, optimized Huffman tables, CMYK, RGB kept without
the YCbCr transform; by hand edits of PIL's files (``patch``), YCCK and a
YCbCr file with an Adobe marker; and the layouts it once refused, their
headers patched (lossless, hierarchical, arithmetic, 12-bit, 4:4:0) or a
progressive file cut short, which PIL refuses (lossless over DCT data,
hierarchical, 12-bit) or decodes (arithmetic decoding of Huffman data,
4:4:0, libjpeg's block smoothing); the layouts PIL decodes but never
writes are in ``tests/fixtures/port_jpeg_layouts/``.
``manifest.json`` records, for each file, the SHA-256 of PIL's decoded
RGB bytes and of the JAX package's ``center_crop_resize`` of them at 160
(crop 160, CelebA's) and at 64 (the shorter side, LSUN's), so that a
machine without PIL can hold the port to PIL's bytes.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))

# name, (h, w), PIL save options, PIL mode, and the hand edit made to
# PIL's file (``patch``, below); the "refuse_" files are the layouts the
# port's decoder once refused: those PIL fails on too must raise
# JPEGUnsupported, the others (arithmetic-coded Huffman data, 4:4:0, unsent
# bits) decode to PIL's bytes
FIXTURES = [
    ("celeba_0.jpg", (218, 178), dict(quality=75, subsampling=2), "RGB", None),
    ("celeba_1.jpg", (218, 178), dict(quality=75, subsampling=2), "RGB", None),
    ("celeba_2.jpg", (218, 178), dict(quality=75, subsampling=2), "RGB", None),
    ("lsun_0.jpg", (256, 256), dict(quality=85), "RGB", None),
    ("lsun_1.jpg", (256, 256), dict(quality=85), "RGB", None),
    ("s422_61x47.jpg", (47, 61), dict(quality=90, subsampling=1), "RGB", None),
    ("s444_53x37.jpg", (37, 53), dict(quality=95, subsampling=0), "RGB", None),
    ("grey_45x33.jpg", (33, 45), dict(quality=80), "L", None),
    ("odd_1x1.jpg", (1, 1), dict(quality=75), "RGB", None),
    ("odd_13x7.jpg", (7, 13), dict(quality=60), "RGB", None),
    ("odd_9x17.jpg", (17, 9), dict(quality=30, subsampling=1), "RGB", None),
    ("restart_blocks_56x40.jpg", (40, 56), dict(quality=85, restart_marker_blocks=2), "RGB",
     None),
    ("restart_rows_70x35.jpg", (35, 70), dict(quality=70, subsampling=1,
                                              restart_marker_rows=1), "RGB", None),
    ("optimized_33x29.jpg", (29, 33), dict(quality=85, optimize=True), "RGB", None),
    ("q100_24x24.jpg", (24, 24), dict(quality=100, subsampling=0), "RGB", None),
    ("q10_30x30.jpg", (30, 30), dict(quality=10), "RGB", None),
    ("progressive_16x16.jpg", (16, 16), dict(quality=75, progressive=True), "RGB", None),
    ("cmyk_16x16.jpg", (16, 16), dict(quality=75), "CMYK", None),
    # progressive: 4:2:0 at CelebA's and LSUN's sizes (the ones chip_smoke.py
    # times), 4:2:2, 4:4:4, grey, odd sizes, optimized tables, restarts
    ("progressive_celeba_178x218.jpg", (218, 178), dict(quality=75, subsampling=2,
                                                       progressive=True), "RGB", None),
    ("progressive_lsun_256x256.jpg", (256, 256), dict(quality=85, subsampling=2,
                                                     progressive=True), "RGB", None),
    ("progressive_s422_61x47.jpg", (47, 61), dict(quality=90, subsampling=1, progressive=True),
     "RGB", None),
    ("progressive_s444_53x37.jpg", (37, 53), dict(quality=95, subsampling=0, progressive=True),
     "RGB", None),
    ("progressive_grey_45x33.jpg", (33, 45), dict(quality=80, progressive=True), "L", None),
    ("progressive_odd_1x1.jpg", (1, 1), dict(quality=75, progressive=True), "RGB", None),
    ("progressive_odd_13x7.jpg", (7, 13), dict(quality=60, progressive=True), "RGB", None),
    ("progressive_optimized_33x29.jpg", (29, 33), dict(quality=85, optimize=True,
                                                      progressive=True), "RGB", None),
    ("progressive_restart_blocks_56x40.jpg", (40, 56), dict(quality=85, progressive=True,
                                                           restart_marker_blocks=3), "RGB", None),
    ("progressive_restart_rows_70x35.jpg", (35, 70), dict(quality=70, subsampling=1,
                                                         progressive=True,
                                                         restart_marker_rows=1), "RGB", None),
    # colour transforms: CMYK (Adobe transform 0, which PIL writes), YCCK
    # (the transform byte set to 2), RGB without the YCbCr transform, and a
    # 4:2:0 YCbCr file with an Adobe marker (transform 1) inserted
    ("cmyk_256x256.jpg", (256, 256), dict(quality=85), "CMYK", None),
    ("cmyk_45x33.jpg", (33, 45), dict(quality=90), "CMYK", None),
    ("cmyk_progressive_37x21.jpg", (21, 37), dict(quality=80, progressive=True), "CMYK", None),
    ("ycck_45x33.jpg", (33, 45), dict(quality=90), "CMYK", "ycck"),
    ("rgb_keep_40x30.jpg", (30, 40), dict(quality=85, keep_rgb=True), "RGB", None),
    ("rgb_keep_progressive_29x20.jpg", (20, 29), dict(quality=85, keep_rgb=True,
                                                     progressive=True), "RGB", None),
    ("adobe_ycc_61x47.jpg", (47, 61), dict(quality=80, subsampling=2), "RGB", "adobe1"),
    # sequential files of several scans, written by hand (``encode_scans``):
    # 4:2:0 as three non-interleaved scans, 4:2:2 as Y then Cb and Cr
    # interleaved, with a restart interval
    ("sequential_3scans_61x47.jpg", (47, 61), dict(subsampling=2, scans=[[0], [1], [2]]),
     "RGB", "hand"),
    ("sequential_2scans_restart_45x33.jpg", (33, 45),
     dict(subsampling=1, scans=[[0], [1, 2]], restart=3), "RGB", "hand"),
    # refused: headers patched to processes PIL cannot write, 12-bit
    # samples, 4:4:0 sampling, and a progressive file cut after its third
    # scan (bits of the first AC coefficients unsent: libjpeg smooths it)
    ("refuse_lossless_sof3.jpg", (16, 16), dict(quality=75), "RGB", "sof3"),
    ("refuse_hierarchical_sof5.jpg", (16, 16), dict(quality=75), "RGB", "sof5"),
    ("refuse_arithmetic_sof9.jpg", (16, 16), dict(quality=75), "RGB", "sof9"),
    ("refuse_12bit_sof1.jpg", (16, 16), dict(quality=75), "RGB", "12bit"),
    ("refuse_s440_16x16.jpg", (16, 16), dict(quality=75), "RGB", "440"),
    ("refuse_unsent_bits_32x24.jpg", (24, 32), dict(quality=75, progressive=True), "RGB",
     "unsent"),
]


def _segments(data: bytes) -> list:
    """(offset of the marker, marker, length) of each segment before EOI."""
    out, i = [], 2
    while i < len(data) - 1:
        if data[i] != 0xFF or data[i + 1] in (0x00, 0xFF) or 0xD0 <= data[i + 1] <= 0xD7:
            i += 1
            continue
        m = data[i + 1]
        if m == 0xD9:
            break
        length = data[i + 2] << 8 | data[i + 3]
        out.append((i, m, length))
        i += 2 + length
    return out


_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def _blocks(plane: np.ndarray, bh: int, bw: int, q: np.ndarray) -> np.ndarray:
    """A plane, edge-replicated to (bh, bw) blocks, through a float DCT and
    quantized: (bh, bw, 64) coefficients in zigzag order."""
    h, w = plane.shape
    p = np.pad(plane, ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge") - 128.0
    k = np.arange(8)
    c = np.sqrt(2 / 8) * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    c[0] /= np.sqrt(2)
    blocks = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
    coef = np.einsum("ui,abij,vj->abuv", c, blocks, c).reshape(bh, bw, 64)
    return np.round(coef / q.reshape(64)).astype(np.int64)[..., _ZIGZAG]


def _category(v: int) -> tuple:
    """(size category, its extra bits) of a coefficient difference."""
    n = abs(v).bit_length()
    return n, (v if v >= 0 else v + (1 << n) - 1)


def encode_scans(rgb: np.ndarray, subsampling: int, scans: list, restart: int = 0) -> bytes:
    """A sequential JPEG of ``rgb`` whose components are coded in
    ``scans`` (lists of component indices), each of one component walking
    its own extent, each of several interleaved in MCUs; luma 2x2
    (``subsampling`` 2) or 2x1 (1) against 1x1 chroma; one quantization
    table of 8s and one DC and one AC Huffman table holding the symbols
    used, every code of one length."""
    h, w = rgb.shape[:2]
    x = rgb.astype(np.float64)
    ycc = [0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2],
           128 - 0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2],
           128 + 0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2]]
    hs, vs = (2, 2) if subsampling == 2 else (2, 1)
    mcux, mcuy = -(-w // (8 * hs)), -(-h // (8 * vs))
    q = np.full(64, 8)
    comps = []
    for ci, plane in enumerate(ycc):
        ch, cv = (hs, vs) if ci == 0 else (1, 1)
        if ci:   # chroma averaged over the luma factors, its own extent
            dh, dw = -(-h // vs), -(-w // hs)
            plane = np.pad(plane, ((0, dh * vs - h), (0, dw * hs - w)), mode="edge")
            plane = plane.reshape(dh, vs, dw, hs).mean(axis=(1, 3))
        comps.append(dict(h=ch, v=cv, ew=-(-(w * ch) // (8 * hs)), eh=-(-(h * cv) // (8 * vs)),
                          coef=_blocks(plane, mcuy * cv, mcux * ch, q)))

    def units(scan):
        """The blocks of a scan in coding order, one list per MCU."""
        if len(scan) == 1:
            c = comps[scan[0]]
            return [[(scan[0], c["coef"][y, x])] for y in range(c["eh"]) for x in range(c["ew"])]
        return [[(ci, comps[ci]["coef"][my * comps[ci]["v"] + v, mx * comps[ci]["h"] + u])
                 for ci in scan for v in range(comps[ci]["v"]) for u in range(comps[ci]["h"])]
                for my in range(mcuy) for mx in range(mcux)]

    def symbols(scan):
        """(DC size, DC bits, [(AC symbol, bits, size)]) per block, per MCU."""
        out, pred = [], {}
        for m, mcu in enumerate(units(scan)):
            if m == 0 or (restart and m % restart == 0):
                pred = {ci: 0 for ci in scan}
            coded = []
            for ci, zz in mcu:
                n, bits = _category(int(zz[0]) - pred[ci])
                pred[ci] = int(zz[0])
                ac, run = [], 0
                for v in zz[1:]:
                    if v == 0:
                        run += 1
                        continue
                    while run > 15:
                        ac.append((0xF0, 0, 0))
                        run -= 16
                    size, extra = _category(int(v))
                    ac.append(((run << 4) | size, extra, size))
                    run = 0
                if run:
                    ac.append((0x00, 0, 0))
                coded.append((n, bits, ac))
            out.append(coded)
        return out

    coded = [symbols(sc) for sc in scans]
    dc_syms = sorted({n for c in coded for mcu in c for n, _, _ in mcu})
    ac_syms = sorted({s for c in coded for mcu in c for _, _, ac in mcu for s, _, _ in ac})
    dc_len, ac_len = 4, 8                  # every code of one length, none all ones

    def dht(tc, syms, length):
        counts = [0] * 16
        counts[length - 1] = len(syms)
        return bytes([tc << 4]) + bytes(counts) + bytes(syms)

    def segment(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    out = b"\xff\xd8" + segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += segment(0xDB, b"\x00" + bytes(q[_ZIGZAG].tolist()))
    out += segment(0xC0, bytes([8]) + struct.pack(">HH", h, w) + bytes(
        [3, 1, (hs << 4) | vs, 0, 2, 0x11, 0, 3, 0x11, 0]))
    out += segment(0xC4, dht(0, dc_syms, dc_len) + dht(1, ac_syms, ac_len))
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    for i, sc in enumerate(scans):
        out += segment(0xDA, bytes([len(sc)]) + b"".join(bytes([ci + 1, 0]) for ci in sc)
                       + b"\x00\x3f\x00")
        bits, data = [], bytearray()

        def flush():
            bits.extend([1] * (-len(bits) % 8))
            for j in range(0, len(bits), 8):
                byte = int("".join(map(str, bits[j:j + 8])), 2)
                data.append(byte)
                if byte == 0xFF:
                    data.append(0)
            bits.clear()

        def put(value, n):
            bits.extend((value >> (n - 1 - j)) & 1 for j in range(n))

        for m, mcu in enumerate(coded[i]):
            if restart and m and m % restart == 0:
                flush()
                data += bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            for n, extra, ac in mcu:
                put(dc_syms.index(n), dc_len)
                put(extra, n)
                for sym, extra_ac, size in ac:
                    put(ac_syms.index(sym), ac_len)
                    put(extra_ac, size)
        flush()
        out += bytes(data)
    return out + b"\xff\xd9"


def patch(data: bytes, edit: str) -> bytes:
    """A hand edit of PIL's JPEG."""
    segs = _segments(data)
    sof = next(i for i, m, _ in segs if m in (0xC0, 0xC2))
    d = bytearray(data)
    if edit == "ycck":             # Adobe transform 2: libjpeg reads YCCK
        i = data.index(b"Adobe")
        d[i + 11] = 2
    elif edit == "adobe1":         # an APP14 "Adobe" marker with transform 1 after JFIF
        app0 = next(i + 2 + n for i, m, n in segs if m == 0xE0)
        d[app0:app0] = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x01"
    elif edit in ("sof3", "sof5", "sof9"):
        d[sof + 1] = {"sof3": 0xC3, "sof5": 0xC5, "sof9": 0xC9}[edit]
    elif edit == "12bit":
        d[sof + 1], d[sof + 4] = 0xC1, 12
    elif edit == "440":            # luma 1x2 against 1x1 chroma
        d[sof + 11] = 0x12
    elif edit == "unsent":         # the first three scans, then EOI
        sos = [i for i, m, _ in segs if m == 0xDA]
        d = d[:sos[3]] + b"\xff\xd9"
    return bytes(d)


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


def pil_refuses(data: bytes) -> bool:
    from PIL import Image
    try:
        Image.open(io.BytesIO(data)).convert("RGB")
    except Exception:
        return True
    return False


def main() -> None:
    from PIL import Image

    sys.path.insert(0, ROOT)
    from tools.make_assets import _proc_image
    rng = np.random.default_rng(909)
    entries = []
    for name, (h, w), opts, mode, edit in FIXTURES:
        img = Image.fromarray(_proc_image(rng, h, w)).convert(mode)
        if edit == "hand":
            data = encode_scans(np.asarray(img), **opts)
        else:
            buf = io.BytesIO()
            img.save(buf, format="JPEG", **opts)
            data = buf.getvalue() if edit is None else patch(buf.getvalue(), edit)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        entry = dict(name=name, options=opts, mode=mode)
        if edit:
            entry["edit"] = edit
        if name.startswith("refuse_") and pil_refuses(data):
            entry["refuse"] = "JPEGUnsupported"
        else:
            entry.update(pil_hashes(data))
        entries.append(entry)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump({"generator": "tests/fixtures/port_images/make_fixtures.py",
                   "files": entries}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
