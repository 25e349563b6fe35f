"""The plain baseline JPEG encoder, in Python and numpy.

``encode_jpeg(u8, quality)`` returns exactly the bytes of PIL's
``Image.fromarray(u8).save(buf, format="JPEG", quality=quality)`` (Pillow
on libjpeg-turbo at its defaults): an (H, W, 3) uint8 RGB image, baseline,
YCbCr 4:2:0, the standard Huffman tables of the JPEG spec (Annex K), no
``optimize``, no ``progressive``, no restart markers.  That is all the
asset tools ask of PIL (``smmdax_torch/tools/make_assets.py``); anything
else raises.  Each step is libjpeg-turbo's, named beside its code.

It is the reference for the native encoder (``data/_native/jpeg_encode.cpp``,
``data.native.encode_jpeg``), which the tools use; the Huffman coding runs
coefficient by coefficient in Python, so this one is for small images and
nothing outside the tests calls it.
"""

from __future__ import annotations

import struct

import numpy as np

from smmdax_torch.data.jpeg import NATURAL

Array = np.ndarray

ZIGZAG = NATURAL[:64]               # zigzag index -> natural index

# jcparam.c std_luminance_quant_tbl / std_chrominance_quant_tbl (natural order)
STD_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
STD_CHROMA_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.int64)

# jstdhuff.c: (codes of each length 1..16, symbols) of DC / AC, luma / chroma
DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12)))
AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), tuple(bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")))
AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), tuple(bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")))

# jfdctint.c: 13 constant bits, 2 pass-1 bits, and FIX(c) of its constants
CONST_BITS, PASS1_BITS = 13, 2
F0298, F0390, F0541, F0765 = 2446, 3196, 4433, 6270
F0899, F1175, F1501, F1847 = 7373, 9633, 12299, 15137
F1961, F2053, F2562, F3072 = 16069, 16819, 20995, 25172


def check_input(u8, quality) -> None:
    """What the encoder accepts: (H, W, 3) uint8 with 1 <= H, W <= 65535,
    quality an int in 1..100.  Anything else raises ``ValueError``."""
    if not isinstance(u8, np.ndarray) or u8.dtype != np.uint8:
        raise ValueError(f"encode_jpeg takes a uint8 array, not {getattr(u8, 'dtype', type(u8))}")
    if u8.ndim != 3 or u8.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) RGB, not shape {u8.shape}")
    if not (1 <= u8.shape[0] <= 65535 and 1 <= u8.shape[1] <= 65535):
        raise ValueError(f"encode_jpeg: image size {u8.shape[1]}x{u8.shape[0]} out of range")
    if isinstance(quality, bool) or not isinstance(quality, (int, np.integer)) \
            or not 1 <= quality <= 100:
        raise ValueError(f"encode_jpeg: quality must be an int in 1..100, not {quality!r}")


def quant_tables(quality: int) -> tuple:
    """jcparam.c ``jpeg_set_quality(cinfo, quality, force_baseline=TRUE)``:
    ``jpeg_quality_scaling`` (5000 / q below 50, else 200 - 2q), then
    ``(std * scale + 50) / 100`` clamped to [1, 255]; natural order."""
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return tuple(np.clip((std * scale + 50) // 100, 1, 255)
                 for std in (STD_LUMA_QUANT, STD_CHROMA_QUANT))


def rgb_to_ycc(u8: Array) -> tuple:
    """jccolor.c ``rgb_ycc_convert``: 16-bit fixed point; Y rounds with
    ONE_HALF, Cb and Cr with CBCR_OFFSET + ONE_HALF - 1."""
    def fix(v: float) -> int:
        return int(v * (1 << 16) + 0.5)

    r, g, b = (u8[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.50000) * b + offset + half - 1) >> 16
    cr = (fix(0.50000) * r - fix(0.41869) * g - fix(0.08131) * b + offset + half - 1) >> 16
    return y, cb, cr


def _pad_edge(p: Array, rows: int, cols: int) -> Array:
    """Replicates the last row down to ``rows`` and the last column right
    to ``cols`` (``expand_bottom_edge`` / ``expand_right_edge``)."""
    return np.pad(p, ((0, rows - p.shape[0]), (0, cols - p.shape[1])), mode="edge")


def h2v2_downsample(p: Array, out_rows: int, out_cols: int) -> Array:
    """jcsample.c ``h2v2_downsample`` of a full-size plane (its rows already
    made even by jcprepct.c), after ``expand_right_edge`` to 2 * out_cols:
    the bias alternates 1, 2 along a row.  Then jcprepct.c pads the output
    to a whole iMCU row (``out_rows``) by replicating its last row."""
    p = _pad_edge(p, p.shape[0], 2 * out_cols)
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = 1 + (np.arange(out_cols) & 1)
    return _pad_edge((s + bias) >> 2, out_rows, out_cols)


def _descale(x: Array, n: int) -> Array:
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d: list, pass1: bool) -> list:
    """One pass of jfdctint.c ``jpeg_fdct_islow`` on the eight inputs."""
    sh = CONST_BITS - PASS1_BITS if pass1 else CONST_BITS + PASS1_BITS
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if pass1:
        out[0] = (tmp10 + tmp11) << PASS1_BITS
        out[4] = (tmp10 - tmp11) << PASS1_BITS
    else:
        out[0] = _descale(tmp10 + tmp11, PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, PASS1_BITS)
    z1 = (tmp12 + tmp13) * F0541
    out[2] = _descale(z1 + tmp13 * F0765, sh)
    out[6] = _descale(z1 - tmp12 * F1847, sh)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * F1175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * F0298, tmp5 * F2053, tmp6 * F3072, tmp7 * F1501
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    out[7] = _descale(tmp4 + z1 + z3, sh)
    out[5] = _descale(tmp5 + z2 + z4, sh)
    out[3] = _descale(tmp6 + z2 + z3, sh)
    out[1] = _descale(tmp7 + z1 + z4, sh)
    return out


def fdct_islow(blocks: Array) -> Array:
    """(N, 8, 8) samples minus 128 (int64) -> (N, 8, 8) coefficients scaled
    by 8, as jfdctint.c: rows first, then columns."""
    rows = _fdct_1d([blocks[:, :, c] for c in range(8)], True)
    ws = np.stack(rows, axis=2)
    cols = _fdct_1d([ws[:, r, :] for r in range(8)], False)
    return np.stack(cols, axis=1)


def divisors(qtable: Array) -> tuple:
    """jcdctmgr.c ``compute_reciprocal`` of each divisor ``8 * q`` (the FDCT's
    scale folded in), as the SIMD build keeps them (16-bit DCTELEM):
    (reciprocal, correction, total shift) per natural index."""
    recip, corr, shift = [], [], []
    for q in qtable.tolist():
        d = 8 * q
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:                      # a power of two
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq)
        corr.append(c)
        shift.append(r)
    return tuple(np.array(v, np.int64) for v in (recip, corr, shift))


def quantize(coef: Array, div: tuple) -> Array:
    """jcdctmgr.c ``quantize``: |x| + correction, times the reciprocal,
    shifted right; the sign put back.  (N, 64) natural order."""
    recip, corr, shift = div
    mag = ((np.abs(coef) + corr) * recip) >> shift
    return np.where(coef < 0, -mag, mag)


def _component_blocks(plane: Array, bh: int, bw: int, div: tuple) -> Array:
    """A padded plane -> (bh, bw, 64) quantized blocks (natural order)."""
    blocks = (plane[:bh * 8, :bw * 8] - 128).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
    coef = fdct_islow(blocks.reshape(-1, 8, 8)).reshape(-1, 64)
    return quantize(coef, div).reshape(bh, bw, 64)


class _Huffman:
    """jchuff.c ``jpeg_make_c_derived_tbl``: symbol -> (code, size)."""

    def __init__(self, spec: tuple):
        counts, symbols = spec
        self.code, self.size = {}, {}
        code, k = 0, 0
        for length, n in enumerate(counts, 1):
            for _ in range(n):
                self.code[symbols[k]], self.size[symbols[k]] = code, length
                code += 1
                k += 1
            code <<= 1


class _Bits:
    """jchuff.c's bit buffer: bytes out, a 0x00 stuffed after every 0xFF,
    the last byte padded with 1-bits."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code: int, size: int) -> None:
        self.acc = (self.acc << size) | code
        self.n += size
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _encode_block(bits: _Bits, zz: list, last_dc: int, dc: _Huffman, ac: _Huffman) -> None:
    """jchuff.c ``encode_one_block``: the DC difference, then run-lengths
    with ZRL only before a nonzero coefficient, and EOB after the last."""
    v = zz[0] - last_dc
    nbits = abs(v).bit_length()
    bits.put(dc.code[nbits], dc.size[nbits])
    if nbits:
        bits.put((v - 1 if v < 0 else v) & ((1 << nbits) - 1), nbits)
    run = 0
    for k in range(1, 64):
        v = zz[k]
        if v == 0:
            run += 1
            continue
        while run > 15:
            bits.put(ac.code[0xF0], ac.size[0xF0])
            run -= 16
        nbits = abs(v).bit_length()
        sym = (run << 4) + nbits
        bits.put(ac.code[sym], ac.size[sym])
        bits.put((v - 1 if v < 0 else v) & ((1 << nbits) - 1), nbits)
        run = 0
    if run:
        bits.put(ac.code[0], ac.size[0])


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def headers(w: int, h: int, qtables: tuple) -> bytes:
    """jcmarker.c: SOI, APP0 JFIF 1.01 (units 0, density 1x1, no thumbnail),
    one DQT per table (zigzag order), SOF0 (Y 2x2 on table 0, Cb and Cr 1x1
    on table 1), DHT DC0, AC0, DC1, AC1, and SOS."""
    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, q in enumerate(qtables):
        out.append(_segment(0xDB, bytes([t]) + bytes(q[ZIGZAG].astype(np.uint8))))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                        + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for cls_id, (counts, symbols) in ((0x00, DC_LUMA), (0x10, AC_LUMA),
                                      (0x01, DC_CHROMA), (0x11, AC_CHROMA)):
        out.append(_segment(0xC4, bytes([cls_id, *counts, *symbols])))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    return b"".join(out)


def encode_jpeg(u8: Array, quality: int) -> bytes:
    """(H, W, 3) uint8 RGB -> PIL's JPEG bytes at ``quality`` (baseline,
    4:2:0, standard Huffman tables)."""
    check_input(u8, quality)
    h, w = u8.shape[:2]
    qtables = quant_tables(int(quality))
    divs = [divisors(q) for q in qtables]
    mcu_rows, mcu_cols = -(-h // 16), -(-w // 16)
    y, cb, cr = rgb_to_ycc(u8)
    # jcprepct.c: the last row replicated to an even count (the row group)
    even = h + (h & 1)
    # luma: full size, expand_right_edge to whole blocks, rows to the iMCU row
    ybh, ybw = -(-h // 8), -(-w // 8)
    yb = _component_blocks(_pad_edge(y, 16 * mcu_rows, 8 * ybw), ybh, ybw, divs[0])
    chroma = [_component_blocks(h2v2_downsample(_pad_edge(p, even, w), 8 * mcu_rows,
                                                 8 * mcu_cols), mcu_rows, mcu_cols, divs[1])
              for p in (cb, cr)]
    tables = ((_Huffman(DC_LUMA), _Huffman(AC_LUMA)), (_Huffman(DC_CHROMA), _Huffman(AC_CHROMA)))
    bits = _Bits()
    last = [0, 0, 0]
    zz_y = yb[:, :, ZIGZAG].tolist()
    zz_c = [c[:, :, ZIGZAG].tolist() for c in chroma]
    for r in range(mcu_rows):
        for c in range(mcu_cols):
            # jccoefct.c compress_data: a block past the last block column or
            # row is a dummy, zero but for a DC copied from the block before
            mcu = []
            for dy in range(2):
                for dx in range(2):
                    by, bx = 2 * r + dy, 2 * c + dx
                    if by < ybh and bx < ybw:
                        mcu.append(zz_y[by][bx])
                    else:
                        mcu.append([mcu[-1][0]] + [0] * 63)
            dc, ac = tables[0]
            for blk in mcu:
                _encode_block(bits, blk, last[0], dc, ac)
                last[0] = blk[0]
            dc, ac = tables[1]
            for i, zz in enumerate(zz_c, 1):
                blk = zz[r][c]
                _encode_block(bits, blk, last[i], dc, ac)
                last[i] = blk[0]
    return headers(w, h, qtables) + bits.flush() + b"\xff\xd9"
