"""Write the JPEG layout fixtures that PIL decodes but never writes, and
their manifest.

    python tests/fixtures/port_jpeg_layouts/make_fixtures.py

Needs PIL, ``gcc`` and libjpeg(-turbo)'s development files (``jpeglib.h``
and ``-ljpeg``, built with arithmetic coding), and the JAX package for the
crops of the hashes.  Two writers make the files, from
``tools/make_assets.py``'s procedural fields:

* ``jpeg_writer.c`` (libjpeg's compressor, built here into a temporary
  directory, never in a test or on the card): arithmetic-coded sequential
  and progressive files with restart intervals and DAC conditioning, the
  sampling layouts PIL does not write (4:4:0, 4:1:1, 4:1:0, chroma above
  1x1, luma 3x1, four components sampled), and progressive scan scripts
  that leave coefficient bits unsent, which libjpeg smooths;
* ``encode_lossless`` (below): lossless files, predictors 1-7, point
  transforms 0-2, restart intervals, grey, RGB, CMYK and sampled layouts;
  and ``encode_reordered``: a PIL file's coefficients re-encoded with the
  port's Huffman coder (``smmdax_torch/data/jpeg_encode.py``) in scans
  that name their components out of the frame's order.

Files named ``refuse_*`` are ones PIL fails on (and so must the port,
with ``JPEGUnsupported``); the script checks that PIL raises on them.
``manifest.json`` records, for every other file, the SHA-256 of PIL's
decoded RGB bytes and of the JAX package's ``center_crop_resize`` of them
at 160 (crop 160) and at 64, so that the machine without PIL can hold the
port to PIL's bytes.
"""

from __future__ import annotations

import io
import json
import os
import struct
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))

# libjpeg's progressive scripts (component indices joined by dots, then Ss,
# Se, Ah, Al): "luma_ac_unsent" leaves the last bit of luma AC 1-63 unsent
# (AC bits still missing: the 5-estimate smoothing), "dc_only" sends the DC
# alone (no AC: the DC is smoothed too), "dc_bits" the DC less its last bit
# and the AC in full, "chroma_ac_missing" no chroma AC at all
SCRIPTS = {
    "luma_ac_unsent": "0.1.2:0:0:0:1;0:1:5:0:2;2:1:63:0:1;1:1:63:0:1;0:6:63:0:2;0:1:63:2:1;"
                      "0.1.2:0:0:1:0;2:1:63:1:0;1:1:63:1:0",
    "dc_only": "0.1.2:0:0:0:0",
    "dc_bits": "0.1.2:0:0:0:1;0:1:63:0:0;1:1:63:0:0;2:1:63:0:0",
    "chroma_ac_missing": "0.1.2:0:0:0:0;0:1:5:0:0;0:6:63:0:0",
    "grey_ac_unsent": "0:0:0:0:0;0:1:9:0:1;0:10:63:0:0",
}

# name, (h, w), writer, options.  Writer "c": jpeg_writer.c with space
# (ycc / rgb / grey / cmyk / ycck), quality, arith, progressive, restart
# (MCUs) or restart_rows, sampling ("HxV,..."), dac ("tbl:L:U:K,..."),
# scans (a script above).  "lossless": encode_lossless's options.
# "reorder": PIL's baseline file at quality 85 in the given scans.  "patch":
# a hand edit of another fixture's bytes.
FIXTURES = [
    # arithmetic coding, sequential (SOF9) and progressive (SOF10)
    ("arith_seq_48x40.jpg", (40, 48), "c", dict(arith=1)),
    ("arith_seq_restart_dac_61x47.jpg", (47, 61), "c",
     dict(arith=1, restart=3, dac="0:2:6:3,1:1:3:12,2:0:0:1")),
    ("arith_seq_s444_q95_33x29.jpg", (29, 33), "c", dict(arith=1, quality=95, sampling="1x1,1x1,1x1")),
    ("arith_seq_grey_45x33.jpg", (33, 45), "c", dict(arith=1, space="grey", restart=2)),
    ("arith_seq_cmyk_37x21.jpg", (21, 37), "c", dict(arith=1, space="cmyk")),
    ("arith_seq_ycck_s422_29x20.jpg", (20, 29), "c", dict(arith=1, space="ycck",
                                                           sampling="2x1,1x1,1x1,2x1")),
    ("arith_seq_rgb_1x1.jpg", (1, 1), "c", dict(arith=1, space="rgb")),
    ("arith_prog_56x40.jpg", (40, 56), "c", dict(arith=1, progressive=1)),
    ("arith_prog_restart_dac_53x37.jpg", (37, 53), "c",
     dict(arith=1, progressive=1, restart_rows=1, dac="0:0:15:63,1:4:9:1,2:3:3:20")),
    ("arith_prog_s422_q30_13x7.jpg", (7, 13), "c", dict(arith=1, progressive=1, quality=30,
                                                        sampling="2x1,1x1,1x1")),
    ("arith_prog_grey_40x33.jpg", (33, 40), "c", dict(arith=1, progressive=1, space="grey")),
    ("arith_prog_cmyk_24x24.jpg", (24, 24), "c", dict(arith=1, progressive=1, space="cmyk")),
    # at CelebA's size, for the card's timing
    ("arith_seq_celeba_178x218.jpg", (218, 178), "c", dict(arith=1)),
    ("arith_prog_celeba_178x218.jpg", (218, 178), "c", dict(arith=1, progressive=1)),
    # sampling layouts PIL does not write
    ("s440_48x40.jpg", (40, 48), "c", dict(sampling="1x2,1x1,1x1")),
    ("s440_progressive_37x21.jpg", (21, 37), "c", dict(sampling="1x2,1x1,1x1", progressive=1)),
    ("s411_64x32.jpg", (32, 64), "c", dict(sampling="4x1,1x1,1x1")),
    ("s410_61x47.jpg", (47, 61), "c", dict(sampling="4x2,1x1,1x1", restart=2)),
    ("s311_45x33.jpg", (33, 45), "c", dict(sampling="3x1,1x1,1x1")),
    ("s114_20x29.jpg", (29, 20), "c", dict(sampling="1x4,1x1,1x1")),
    ("chroma_2x2_40x33.jpg", (33, 40), "c", dict(sampling="1x1,2x2,2x2")),
    ("mixed_2x2_1x2_2x1_31x23.jpg", (23, 31), "c", dict(sampling="2x2,1x2,2x1")),
    ("narrow_s420_2x9.jpg", (9, 2), "c", dict(sampling="2x2,1x1,1x1")),
    ("cmyk_s2211_45x33.jpg", (33, 45), "c", dict(space="cmyk", sampling="2x2,1x1,1x1,2x2")),
    ("ycck_s2111_37x21.jpg", (21, 37), "c", dict(space="ycck", sampling="2x1,1x1,1x1,2x1",
                                                 progressive=1)),
    ("arith_s440_restart_37x21.jpg", (21, 37), "c", dict(arith=1, sampling="1x2,1x1,1x1",
                                                         restart=1)),
    # progressive files with bits still unsent: libjpeg smooths them
    ("smooth_luma_ac_48x40.jpg", (40, 48), "c", dict(scans="luma_ac_unsent", progressive=1)),
    ("smooth_dc_only_61x47.jpg", (47, 61), "c", dict(scans="dc_only", progressive=1)),
    ("smooth_dc_only_s420_35x19.jpg", (19, 35), "c", dict(scans="dc_only", progressive=1,
                                                          sampling="2x2,1x1,1x1")),
    ("smooth_dc_bits_45x33.jpg", (33, 45), "c", dict(scans="dc_bits", progressive=1,
                                                     restart=2)),
    ("smooth_chroma_ac_missing_33x29.jpg", (29, 33), "c",
     dict(scans="chroma_ac_missing", progressive=1, sampling="2x1,1x1,1x1")),
    ("smooth_grey_16x64.jpg", (64, 16), "c", dict(scans="grey_ac_unsent", progressive=1,
                                                  space="grey")),
    ("smooth_arith_dc_only_29x20.jpg", (20, 29), "c", dict(scans="dc_only", progressive=1,
                                                           arith=1)),
    ("smooth_arith_luma_ac_37x21.jpg", (21, 37), "c", dict(scans="luma_ac_unsent",
                                                           progressive=1, arith=1)),
    ("smooth_celeba_178x218.jpg", (218, 178), "c", dict(scans="luma_ac_unsent", progressive=1)),
    # lossless (SOF3)
    ("lossless_p1_rgb_33x29.jpg", (29, 33), "lossless", dict(psv=1, pt=0)),
    ("lossless_p2_grey_40x33.jpg", (33, 40), "lossless", dict(psv=2, pt=0, space="grey")),
    ("lossless_p3_pt1_31x23.jpg", (23, 31), "lossless", dict(psv=3, pt=1)),
    ("lossless_p4_restart_45x33.jpg", (33, 45), "lossless", dict(psv=4, pt=0, restart_rows=3)),
    ("lossless_p5_adobe_rgb_29x20.jpg", (20, 29), "lossless", dict(psv=5, pt=2, adobe=0)),
    ("lossless_p6_cmyk_24x24.jpg", (24, 24), "lossless", dict(psv=6, pt=0, space="cmyk")),
    ("lossless_p7_s420_37x21.jpg", (21, 37), "lossless", dict(psv=7, pt=1,
                                                               sampling="2x2,1x1,1x1")),
    ("lossless_p1_rgb_ids_s422_1x1.jpg", (1, 1), "lossless", dict(psv=1, pt=0, ids=b"RGB",
                                                                  sampling="2x1,1x1,1x1")),
    ("lossless_64x64.jpg", (64, 64), "lossless", dict(psv=6, pt=0)),
    # scans out of the frame's order, as far as libjpeg-turbo's get_sos takes them
    ("reorder_y_crcb_45x33.jpg", (33, 45), "reorder", dict(scans=[[0], [2, 1]])),
    ("reorder_cr_y_cb_restart_40x30.jpg", (30, 40), "reorder",
     dict(scans=[[2], [0], [1]], restart=2)),
    ("reorder_crcb_y_s422_29x20.jpg", (20, 29), "reorder", dict(scans=[[2, 1], [0]],
                                                                  subsampling=1)),
    # what PIL refuses too
    ("refuse_scan_order_y_cr_cb_24x16.jpg", (16, 24), "reorder", dict(scans=[[0, 2, 1]])),
    ("refuse_fractional_s3121_16x16.jpg", (16, 16), "patch",
     dict(source="arith_seq_48x40.jpg", factors=[0x31, 0x21, 0x11])),
    ("refuse_lossless_ycc_16x16.jpg", (16, 16), "lossless", dict(psv=1, pt=0, jfif=True)),
    ("refuse_lossless_ycck_16x16.jpg", (16, 16), "lossless", dict(psv=1, pt=0, space="cmyk",
                                                                  adobe=2)),
    ("refuse_lossless_arith_sof11_16x16.jpg", (16, 16), "patch",
     dict(source="lossless_p1_rgb_33x29.jpg", sof=0xCB)),
    ("refuse_hierarchical_sof6_16x16.jpg", (16, 16), "patch",
     dict(source="arith_prog_56x40.jpg", sof=0xC6)),
    ("refuse_hierarchical_sof7_16x16.jpg", (16, 16), "patch",
     dict(source="lossless_p1_rgb_33x29.jpg", sof=0xC7)),
    ("refuse_hierarchical_arith_sof13_16x16.jpg", (16, 16), "patch",
     dict(source="arith_seq_48x40.jpg", sof=0xCD)),
    ("refuse_hierarchical_arith_sof14_16x16.jpg", (16, 16), "patch",
     dict(source="arith_prog_56x40.jpg", sof=0xCE)),
    ("refuse_hierarchical_arith_sof15_16x16.jpg", (16, 16), "patch",
     dict(source="lossless_p1_rgb_33x29.jpg", sof=0xCF)),
    ("refuse_jpg_sof8_16x16.jpg", (16, 16), "patch", dict(source="arith_seq_48x40.jpg",
                                                          sof=0xC8)),
    ("refuse_dnl_height_16x16.jpg", (16, 16), "patch", dict(source="arith_seq_48x40.jpg",
                                                            height=0)),
    ("refuse_2_components_16x16.jpg", (16, 16), "patch", dict(source="arith_seq_48x40.jpg",
                                                              components=2)),
    ("refuse_12bit_lossless_16x16.jpg", (16, 16), "patch",
     dict(source="lossless_p1_rgb_33x29.jpg", precision=12)),
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


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _category(v: int) -> tuple:
    """(size category, its extra bits) of a difference."""
    n = abs(v).bit_length()
    return n, (v if v >= 0 else v + (1 << n) - 1)


def _factors(sampling: str, n: int) -> list:
    if not sampling:
        return [(1, 1)] * n
    return [tuple(int(x) for x in f.split("x")) for f in sampling.split(",")]


def component_planes(img: np.ndarray, factors: list) -> list:
    """Each component's own extent, ceil(W * h / hmax) x ceil(H * v /
    vmax), by point sampling (any samples do: PIL is the reference)."""
    h, w = img.shape[:2]
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    out = []
    for ci, (hs, vs) in enumerate(factors):
        cw, ch = -(-w * hs // hmax), -(-h * vs // vmax)
        ys = np.minimum((np.arange(ch) * vmax) // vs, h - 1)
        xs = np.minimum((np.arange(cw) * hmax) // hs, w - 1)
        plane = img if img.ndim == 2 else img[..., ci]
        out.append(plane[np.ix_(ys, xs)])
    return out


def encode_lossless(img: np.ndarray, psv: int, pt: int, sampling: str = "",
                    restart_rows: int = 0, ids: bytes = b"", jfif: bool = False,
                    adobe=None) -> bytes:
    """A lossless (SOF3) JPEG of ``img`` (H x W grey, or x 3 / x 4): one
    interleaved scan with predictor ``psv`` and point transform ``pt``,
    restart intervals of ``restart_rows`` MCU rows; the standard luma DC
    Huffman table codes the differences (libjpeg's jclhuff.c / jcdiffct.c
    in reverse of jdlossls.c's undifferencing)."""
    from smmdax_torch.data.jpeg_encode import DC_LUMA, _Bits, _Huffman
    h, w = img.shape[:2]
    nc = 1 if img.ndim == 2 else img.shape[2]
    factors = _factors(sampling, nc)
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    planes = component_planes(img, factors)
    single = nc == 1
    mcux = planes[0].shape[1] if single else -(-w // hmax)
    mcuy = planes[0].shape[0] if single else -(-h // vmax)
    restart = restart_rows * mcux
    diffs = []
    for ci, plane in enumerate(planes):
        x = plane.astype(np.int64) >> pt
        vs = 1 if single else factors[ci][1]
        first_rows = restart_rows * vs
        d = np.zeros_like(x)
        for r in range(x.shape[0]):
            first = r == 0 or (first_rows and r % first_rows == 0)
            for c in range(x.shape[1]):
                if first:
                    pred = (1 << (8 - pt - 1)) if c == 0 else x[r, c - 1]
                elif c == 0:
                    pred = x[r - 1, 0]
                else:
                    ra, rb, rc = int(x[r, c - 1]), int(x[r - 1, c]), int(x[r - 1, c - 1])
                    pred = (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                            rb + ((ra - rc) >> 1), (ra + rb) >> 1)[psv - 1]
                d[r, c] = ((int(x[r, c]) - pred + 32768) & 0xFFFF) - 32768
        diffs.append(d)
    table = _Huffman(DC_LUMA)
    bits, data = _Bits(), bytearray()
    for m in range(mcux * mcuy):
        if restart and m and m % restart == 0:
            data += bits.flush() + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            bits = _Bits()
        my, mx = divmod(m, mcux)
        for ci, d in enumerate(diffs):
            hs, vs = (1, 1) if single else factors[ci]
            for v in range(vs):
                for u in range(hs):
                    r, c = my * vs + v, mx * hs + u
                    val = int(d[r, c]) if r < d.shape[0] and c < d.shape[1] else 0
                    n, extra = _category(val)
                    bits.put(table.code[n], table.size[n])
                    if n:
                        bits.put(extra & ((1 << n) - 1), n)
    data += bits.flush()
    ids = ids or bytes(range(1, nc + 1))
    out = b"\xff\xd8"
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    out += _segment(0xC3, struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([ids[ci], (factors[ci][0] << 4) | factors[ci][1], 0]) for ci in range(nc)))
    out += _segment(0xC4, bytes([0x00, *DC_LUMA[0], *DC_LUMA[1]]))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    out += _segment(0xDA, bytes([nc]) + b"".join(bytes([ids[ci], 0]) for ci in range(nc))
                    + bytes([psv, 0, pt]))
    return out + bytes(data) + b"\xff\xd9"


def encode_reordered(pil_jpeg: bytes, scans: list, restart: int = 0) -> bytes:
    """PIL's baseline file (standard Huffman tables) with its coefficients
    re-encoded in ``scans`` (lists of frame component indices, in the
    order the scan names them): an interleaved scan's MCU follows the
    scan's order, a scan of one component walks its own extent."""
    from smmdax_torch.data import jpeg as plain
    from smmdax_torch.data.jpeg_encode import (AC_CHROMA, AC_LUMA, DC_CHROMA, DC_LUMA, ZIGZAG,
                                               _Bits, _encode_block, _Huffman)
    hd = plain._parse(pil_jpeg)
    comps = hd["comps"]
    tables = [(_Huffman(DC_LUMA), _Huffman(AC_LUMA)), (_Huffman(DC_CHROMA), _Huffman(AC_CHROMA))]
    head = b"".join(pil_jpeg[i:i + 2 + n] for i, m, n in _segments(pil_jpeg)
                    if m in (0xE0, 0xDB, 0xC0, 0xC4))
    out = b"\xff\xd8" + head
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    for scan in scans:
        out += _segment(0xDA, bytes([len(scan)]) + b"".join(
            bytes([comps[ci]["id"], 0x00 if ci == 0 else 0x11]) for ci in scan) + b"\x00\x3f\x00")
        if len(scan) == 1:
            c = comps[scan[0]]
            mcus = [[(0, scan[0], y, x)] for y in range(c["eh"]) for x in range(c["ew"])]
        else:
            mcus = [[(p, ci, my * comps[ci]["v"] + v, mx * comps[ci]["h"] + u)
                     for p, ci in enumerate(scan) for v in range(comps[ci]["v"])
                     for u in range(comps[ci]["h"])]
                    for my in range(hd["mcuy"]) for mx in range(hd["mcux"])]
        bits, data, last = _Bits(), bytearray(), [0] * len(scan)
        for m, mcu in enumerate(mcus):
            if restart and m and m % restart == 0:
                data += bits.flush() + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
                bits, last = _Bits(), [0] * len(scan)
            for p, ci, y, x in mcu:
                zz = comps[ci]["coef"][y, x][ZIGZAG].tolist()
                dc, ac = tables[0 if ci == 0 else 1]
                _encode_block(bits, zz, last[p], dc, ac)
                last[p] = zz[0]
        out += bytes(data + bits.flush())
    return out + b"\xff\xd9"


def _write_c(writer: str, img: np.ndarray, tmp: str, space="ycc", quality=75, arith=0,
             progressive=0, restart=0, restart_rows=0, sampling="", dac="", scans="") -> bytes:
    raw, out = os.path.join(tmp, "in.raw"), os.path.join(tmp, "out.jpg")
    with open(raw, "wb") as f:
        f.write(np.ascontiguousarray(img).tobytes())
    h, w = img.shape[:2]
    nc = 1 if img.ndim == 2 else img.shape[2]
    subprocess.run([writer, raw, out, str(w), str(h), str(nc), space, str(quality), str(arith),
                    str(progressive), str(restart), str(restart_rows), sampling or "-",
                    dac or "-", SCRIPTS[scans] if scans else "-"], check=True)
    with open(out, "rb") as f:
        return f.read()


def _patch(data: bytes, sof=None, height=None, components=None, precision=None,
           factors=None) -> bytes:
    """A hand edit of the frame header: its marker, height, component
    count (the frame cut to its first two components), precision or the
    components' sampling factors."""
    i = next(i for i, m, _ in _segments(data) if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xCC))
    d = bytearray(data)
    if sof is not None:
        d[i + 1] = sof
    if height is not None:
        d[i + 5:i + 7] = struct.pack(">H", height)
    if precision is not None:
        d[i + 4] = precision
    if components is not None:
        d[i + 9] = components
    for c, f in enumerate(factors or ()):
        d[i + 11 + 3 * c] = f
    return bytes(d)


def _image(rng, h: int, w: int, space: str) -> np.ndarray:
    from tools.make_assets import _proc_image
    rgb = _proc_image(rng, h, w)
    if space == "grey":
        return rgb[..., 0].copy()
    if space in ("cmyk", "ycck"):
        return np.concatenate([255 - rgb, rgb[..., :1] // 2 + 64], axis=2)
    return rgb


def make(name: str, hw: tuple, kind: str, opts: dict, rng, writer: str, tmp: str,
         done: dict) -> bytes:
    from PIL import Image
    h, w = hw
    if kind == "c":
        return _write_c(writer, _image(rng, h, w, opts.get("space", "ycc")), tmp, **opts)
    if kind == "lossless":
        opts = dict(opts)
        return encode_lossless(_image(rng, h, w, opts.pop("space", "rgb")), **opts)
    if kind == "reorder":
        buf = io.BytesIO()
        Image.fromarray(_image(rng, h, w, "ycc")).save(
            buf, format="JPEG", quality=85, subsampling=opts.get("subsampling", 2))
        return encode_reordered(buf.getvalue(), opts["scans"], opts.get("restart", 0))
    opts = dict(opts)
    return _patch(done[opts.pop("source")], **opts)


def sha(a: np.ndarray) -> str:
    import hashlib
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
    sys.path.insert(0, ROOT)
    rng = np.random.default_rng(1515)
    entries, done = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        writer = os.path.join(tmp, "jpeg_writer")
        subprocess.run(["gcc", "-O2", os.path.join(HERE, "jpeg_writer.c"), "-ljpeg", "-o",
                        writer], check=True)
        for name, hw, kind, opts in FIXTURES:
            data = make(name, hw, kind, opts, rng, writer, tmp, done)
            done[name] = data
            with open(os.path.join(HERE, name), "wb") as f:
                f.write(data)
            entry = dict(name=name, writer=kind, options={k: (v.decode() if isinstance(v, bytes)
                                                              else v) for k, v in opts.items()})
            if name.startswith("refuse_"):
                if not pil_refuses(data):
                    raise SystemExit(f"{name}: PIL decodes it")
                entry["refuse"] = "JPEGUnsupported"
            else:
                entry.update(pil_hashes(data))
            entries.append(entry)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump({"generator": "tests/fixtures/port_jpeg_layouts/make_fixtures.py",
                   "files": entries}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
