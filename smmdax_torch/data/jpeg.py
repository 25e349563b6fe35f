"""The plain baseline JPEG decoder, in Python and numpy.

The reference for the native decoder (``data/_native/jpeg.cpp``, loaded by
``data/native.py``): the same layouts, the same refusals, the same bytes,
which are PIL's (libjpeg-turbo at its defaults: the ISLOW integer IDCT,
fancy chroma upsampling, the fixed-point YCbCr -> RGB tables).  The
Huffman decoding runs bit by bit in Python, so it is for small images: the
tests and ``chip_smoke.py`` hold the native decoder to it.  Nothing on the
training path calls it.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

Array = np.ndarray

# zigzag index -> natural (row-major) index, past 63 clamped as libjpeg's
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63] + [63] * 16)

_SOF_NAMES = {0xC2: "progressive JPEG", 0xC3: "lossless JPEG",
              **{m: "hierarchical JPEG" for m in (0xC5, 0xC6, 0xC7)},
              **{m: "arithmetic-coded JPEG" for m in (0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF)}}


class JPEGUnsupported(NotImplementedError):
    """A JPEG this decoder does not read (and will not read differently
    from PIL)."""


# what works meanwhile for a dataset the port cannot decode
PACK_ROUTE = ("pack the dataset once with `python -m smmdax.data.convert` on a host with PIL, "
              "then train from the packed cache, which the port reads with numpy alone")


def unsupported(what: str) -> JPEGUnsupported:
    """The refusal of a JPEG layout, naming its ROADMAP item."""
    return JPEGUnsupported(f"{what}: the port's JPEG decoder reads baseline 8-bit 4:4:4, "
                           f"4:2:2, 4:2:0 and grey (ROADMAP: progressive JPEG); {PACK_ROUTE}")


class _Huffman:
    def __init__(self, counts: bytes, vals: bytes):
        self.maxcode = [-1] * 17
        self.valoffset = [0] * 17
        self.vals = vals
        code = k = 0
        for length in range(1, 17):
            self.valoffset[length] = k - code
            n = counts[length - 1]
            if n:
                code += n
                k += n
                if code > (1 << length):
                    raise ValueError("bad Huffman table")
                self.maxcode[length] = code - 1
            code <<= 1


class _Bits:
    """Unstuffed bits of one restart interval, zeros past its end."""

    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8)).tolist()
        self.pos = 0

    def bit(self) -> int:
        b = self.bits[self.pos] if self.pos < len(self.bits) else 0
        self.pos += 1
        return b

    def receive(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def decode(self, t: _Huffman) -> int:
        code = 0
        for length in range(1, 17):
            code = (code << 1) | self.bit()
            if code <= t.maxcode[length]:
                return t.vals[(t.valoffset[length] + code) & 0xFF]
        raise ValueError("corrupt Huffman code")


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _intervals(data: bytes, start: int) -> List[bytes]:
    """The entropy-coded data from ``start``, unstuffed and split at its
    restart markers; ends at the first other marker."""
    out, cur, i, n = [], bytearray(), start, len(data)
    while i < n:
        b = data[i]
        i += 1
        if b != 0xFF:
            cur.append(b)
            continue
        while i < n and data[i] == 0xFF:
            i += 1
        nxt = data[i] if i < n else 0xD9
        i += 1
        if nxt == 0:
            cur.append(0xFF)
        elif 0xD0 <= nxt <= 0xD7:
            out.append(bytes(cur))
            cur = bytearray()
        else:
            break
    out.append(bytes(cur))
    return out


def _parse(data: bytes) -> Tuple[Dict, int]:
    if len(data) < 4 or data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (no SOI marker)")
    hd = dict(quant={}, dc={}, ac={}, restart=0, jfif=False, adobe=False, comps=None)
    i, n = 2, len(data)
    while True:
        while i < n and data[i] != 0xFF:
            i += 1
        while i < n and data[i] == 0xFF:
            i += 1
        if i >= n:
            raise ValueError("truncated JPEG: no scan")
        m = data[i]
        i += 1
        if m == 0xD8 or 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        if m == 0xD9:
            raise ValueError("truncated JPEG: EOI before the scan")
        (length,) = struct.unpack(">H", data[i:i + 2])
        if length < 2 or i + length > n:
            raise ValueError("truncated JPEG segment")
        s = data[i + 2:i + length]
        if m in (0xC0, 0xC1):
            if s[0] != 8:
                raise unsupported(f"{s[0]}-bit JPEG samples")
            hd["height"], hd["width"] = struct.unpack(">HH", s[1:5])
            nf = s[5]
            if hd["height"] == 0 or hd["width"] == 0:
                raise unsupported("JPEG with its height in a DNL marker, or of zero size")
            if nf not in (1, 3):
                raise unsupported(f"{nf}-component JPEG (CMYK or other)")
            hd["comps"] = [dict(id=s[6 + 3 * c], h=s[7 + 3 * c] >> 4, v=s[7 + 3 * c] & 15,
                                tq=s[8 + 3 * c]) for c in range(nf)]
        elif m in _SOF_NAMES:
            raise unsupported(_SOF_NAMES[m])
        elif m == 0xC4:
            k = 0
            while k < len(s):
                tc, th = s[k] >> 4, s[k] & 15
                counts = s[k + 1:k + 17]
                total = sum(counts)
                (hd["dc"] if tc == 0 else hd["ac"])[th] = _Huffman(counts, s[k + 17:k + 17 + total])
                k += 17 + total
        elif m == 0xDB:
            k = 0
            while k < len(s):
                pq, tq = s[k] >> 4, s[k] & 15
                if pq:
                    zz = np.frombuffer(s[k + 1:k + 129], ">u2").astype(np.int64)
                else:
                    zz = np.frombuffer(s[k + 1:k + 65], np.uint8).astype(np.int64)
                q = np.zeros(64, np.int64)
                q[NATURAL[:64]] = zz
                hd["quant"][tq] = q
                k += 1 + 64 * (pq + 1)
        elif m == 0xDD:
            (hd["restart"],) = struct.unpack(">H", s[:2])
        elif m == 0xE0:
            hd["jfif"] = hd["jfif"] or s[:5] == b"JFIF\0"
        elif m == 0xEE:
            hd["adobe"] = hd["adobe"] or s[:5] == b"Adobe"
        elif m == 0xDA:
            if hd["comps"] is None:
                raise ValueError("scan before the frame header")
            ns = s[0]
            if ns != len(hd["comps"]):
                raise unsupported("JPEG with several scans (non-interleaved sequential)")
            for c in range(ns):
                comp = hd["comps"][c]
                if comp["id"] != s[1 + 2 * c]:
                    raise unsupported("JPEG scan in another order than its frame")
                comp["td"], comp["ta"] = s[2 + 2 * c] >> 4, s[2 + 2 * c] & 15
            return hd, i + length
        i += length


def _check_layout(hd: Dict) -> None:
    comps = hd["comps"]
    if hd["adobe"]:
        raise unsupported("JPEG with an Adobe colour transform marker (CMYK/Adobe)")
    if len(comps) == 3:
        y, cb, cr = comps
        if (cb["h"], cb["v"], cr["h"], cr["v"]) != (1, 1, 1, 1) or \
                (y["h"], y["v"]) not in ((1, 1), (2, 1), (2, 2)):
            raise unsupported(
                f"JPEG sampling layout {y['h']}x{y['v']},{cb['h']}x{cb['v']},"
                f"{cr['h']}x{cr['v']} (the decoder reads 4:4:4, 4:2:2 and 4:2:0)")
        if not hd["jfif"] and (y["id"], cb["id"], cr["id"]) == (82, 71, 66):
            raise unsupported("JPEG stored as RGB (no YCbCr transform)")


def _descale(x: Array, n: int) -> Array:
    return (x + (1 << (n - 1))) >> n


def _idct_1d(i: List[Array]) -> List[Array]:
    """jidctint.c's butterfly on the eight inputs (each an array)."""
    z1 = (i[2] + i[6]) * 4433
    tmp2 = z1 + i[6] * -15137
    tmp3 = z1 + i[2] * 6270
    tmp0 = (i[0] + i[4]) << 13
    tmp1 = (i[0] - i[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = i[7], i[5], i[3], i[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
    z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def idct_islow(blocks: Array) -> Array:
    """(N, 8, 8) dequantized coefficients (int64, natural order) -> (N, 8,
    8) uint8 samples, as libjpeg's ISLOW IDCT and range limit give them."""
    cols = _idct_1d([blocks[:, r, :] for r in range(8)])
    ws = np.stack([_descale(o, 11) for o in cols], axis=1)        # pass 1, by columns
    rows = _idct_1d([ws[:, :, c] for c in range(8)])
    out = np.stack([_descale(o, 18) for o in rows], axis=2)        # pass 2, by rows
    v = out & 1023
    v = np.where(v >= 512, v - 1024, v) + 128
    return np.clip(v, 0, 255).astype(np.uint8)


def _decode_planes(data: bytes, hd: Dict, start: int) -> List[Array]:
    comps = hd["comps"]
    if len(comps) == 1:
        comps[0]["h"] = comps[0]["v"] = 1
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux = -(-hd["width"] // (8 * hmax))
    mcuy = -(-hd["height"] // (8 * vmax))
    coefs = [np.zeros((mcuy * c["v"], mcux * c["h"], 64), np.int64) for c in comps]
    intervals = _intervals(data, start)
    ri = hd["restart"]
    bits, pred, interval = _Bits(intervals[0]), [0] * len(comps), 0
    for m in range(mcux * mcuy):
        if ri and m and m % ri == 0:
            interval += 1
            if interval >= len(intervals):
                raise ValueError("missing restart marker")
            bits, pred = _Bits(intervals[interval]), [0] * len(comps)
        my, mx = divmod(m, mcux)
        for ci, c in enumerate(comps):
            dct, act = hd["dc"][c["td"]], hd["ac"][c["ta"]]
            for v in range(c["v"]):
                for h in range(c["h"]):
                    blk = coefs[ci][my * c["v"] + v, mx * c["h"] + h]
                    s = bits.decode(dct)
                    pred[ci] += _extend(bits.receive(s), s) if s else 0
                    blk[0] = ((pred[ci] + 0x8000) & 0xFFFF) - 0x8000   # a JCOEF, 16 bits
                    k = 1
                    while k < 64:
                        rs = bits.decode(act)
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            blk[NATURAL[k]] = _extend(bits.receive(s), s)
                        elif r == 15:
                            k += 15
                        else:
                            break
                        k += 1
    planes = []
    for ci, c in enumerate(comps):
        bh, bw, _ = coefs[ci].shape
        q = hd["quant"][c["tq"]].reshape(8, 8)
        blocks = idct_islow(coefs[ci].reshape(-1, 8, 8) * q)
        planes.append(blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8))
    return planes


def _upsample(p: Array, ratio_h: int, ratio_v: int, width: int, height: int) -> Array:
    """A chroma plane (its real extent) -> (height, width), as jdsample.c's
    fancy upsampling (plain replication when it is at most 2 wide)."""
    p = p.astype(np.int64)
    dh, dw = p.shape
    if ratio_h == 1:
        return p[:height, :width]
    if ratio_v == 2:
        up = np.repeat(p, 2, axis=0)
        if dw > 2:
            i = np.arange(2 * dh) >> 1
            other = np.where(np.arange(2 * dh) & 1, np.minimum(i + 1, dh - 1), np.maximum(i - 1, 0))
            up = p[i] * 3 + p[other]
    else:
        up = p
    if dw <= 2:
        return np.repeat(up, 2, axis=1)[:height, :width]
    prev = np.concatenate([up[:, :1], up[:, :-1]], axis=1)
    nxt = np.concatenate([up[:, 1:], up[:, -1:]], axis=1)
    out = np.empty((up.shape[0], 2 * dw), np.int64)
    if ratio_v == 2:
        out[:, 0::2] = (up * 3 + prev + 8) >> 4
        out[:, 1::2] = (up * 3 + nxt + 7) >> 4
        out[:, 0] = (up[:, 0] * 4 + 8) >> 4
        out[:, -1] = (up[:, -1] * 4 + 7) >> 4
    else:
        out[:, 0::2] = (up * 3 + prev + 1) >> 2
        out[:, 1::2] = (up * 3 + nxt + 2) >> 2
        out[:, 0] = up[:, 0]
        out[:, -1] = up[:, -1]
    return out[:height, :width]


def _ycc_tables() -> Tuple[Array, Array, Array, Array]:
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v: float) -> int:
        return int(v * (1 << 16) + 0.5)

    half = 1 << 15
    return ((fix(1.40200) * x + half) >> 16, (fix(1.77200) * x + half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + half)


def decode_jpeg(data: bytes) -> Array:
    """JPEG bytes -> (H, W, 3) uint8 RGB, PIL's bytes.  Unsupported
    layouts raise ``JPEGUnsupported`` (a ``NotImplementedError``)."""
    hd, start = _parse(bytes(data))
    _check_layout(hd)
    for c in hd["comps"]:
        if c["tq"] not in hd["quant"] or c["td"] not in hd["dc"] or c["ta"] not in hd["ac"]:
            raise ValueError("missing quantization or Huffman table")
    planes = _decode_planes(bytes(data), hd, start)
    w, h = hd["width"], hd["height"]
    y = planes[0][:h, :w].astype(np.int64)
    if len(planes) == 1:
        return np.repeat(y[..., None], 3, axis=2).astype(np.uint8)
    rh, rv = hd["comps"][0]["h"], hd["comps"][0]["v"]
    dw, dh = -(-w // rh), -(-h // rv)
    cb = _upsample(planes[1][:dh, :dw], rh, rv, w, h)
    cr = _upsample(planes[2][:dh, :dw], rh, rv, w, h)
    cr_r, cb_b, cr_g, cb_g = _ycc_tables()
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb]], axis=2)
    return np.clip(rgb, 0, 255).astype(np.uint8)
