"""The plain JPEG decoder, in Python and numpy.

The reference for the native decoder (``data/_native/jpeg.cpp``, loaded by
``data/native.py``): the same layouts, the same refusals, the same bytes,
which are PIL's (libjpeg-turbo at its defaults: the ISLOW integer IDCT,
fancy chroma upsampling, the fixed-point YCbCr -> RGB tables, and PIL's
own CMYK -> RGB).  It reads sequential and progressive 8-bit files: every
scan into per-component coefficient buffers, then the IDCT; grey, YCbCr,
RGB, CMYK and YCCK as libjpeg's ``default_decompress_parms`` picks them.
The Huffman decoding runs bit by bit in Python, so it is for small images:
the tests and ``chip_smoke.py`` hold the native decoder to it.  Nothing on
the training path calls it.
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

_SOF_NAMES = {0xC3: "lossless JPEG",
              **{m: "hierarchical JPEG" for m in (0xC5, 0xC6, 0xC7)},
              **{m: "arithmetic-coded JPEG" for m in (0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF)}}

# the ROADMAP item that lists the layouts still refused
ROADMAP_ITEM = "JPEG layouts still refused"


class JPEGUnsupported(NotImplementedError):
    """A JPEG this decoder does not read (and will not read differently
    from PIL)."""


# what works meanwhile for a dataset the port cannot decode
PACK_ROUTE = ("pack the dataset once with `python -m smmdax.data.convert` on a host with PIL, "
              "then train from the packed cache, which the port reads with numpy alone")


def unsupported(what: str) -> JPEGUnsupported:
    """The refusal of a JPEG layout, naming its ROADMAP item."""
    return JPEGUnsupported(f"{what}: the port's JPEG decoder reads baseline and progressive "
                           f"8-bit grey, YCbCr 4:4:4 / 4:2:2 / 4:2:0, RGB, CMYK and YCCK "
                           f"(ROADMAP: {ROADMAP_ITEM}); {PACK_ROUTE}")


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


def _jcoef(v: int) -> int:
    """A JCOEF: 16 bits, two's complement."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _intervals(data: bytes, start: int) -> Tuple[List[bytes], int]:
    """The entropy-coded data from ``start``, unstuffed and split at its
    restart markers, and the offset of the marker that ends it."""
    out, cur, i, n = [], bytearray(), start, len(data)
    end = n
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
            end = i - 2
            break
    out.append(bytes(cur))
    return out, end


def _read_frame(hd: Dict, m: int, s: bytes) -> None:
    if hd["sof"]:
        raise ValueError("a second frame header")
    if len(s) < 6 or len(s) < 6 + 3 * s[5]:
        raise ValueError("short frame header")
    if s[0] != 8:
        raise unsupported(f"{s[0]}-bit JPEG samples")
    hd["sof"] = m
    hd["height"], hd["width"] = h, w = struct.unpack(">HH", s[1:5])
    nf = s[5]
    if h == 0 or w == 0:
        raise unsupported("JPEG with its height in a DNL marker, or of zero size")
    if nf not in (1, 3, 4):
        raise unsupported(f"{nf}-component JPEG")
    comps = [dict(id=s[6 + 3 * c], h=s[7 + 3 * c] >> 4, v=s[7 + 3 * c] & 15, tq=s[8 + 3 * c],
                  quant=None, bits=[-1] * 64) for c in range(nf)]
    if nf == 1:                       # one component: one block per MCU
        comps[0]["h"] = comps[0]["v"] = 1
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    hd["mcux"], hd["mcuy"] = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    for c in comps:
        c["ew"], c["eh"] = -(-(w * c["h"]) // (8 * hmax)), -(-(h * c["v"]) // (8 * vmax))
        c["coef"] = np.zeros((hd["mcuy"] * c["v"], hd["mcux"] * c["h"], 64), np.int64)
    hd["comps"] = comps


def _check_layout(hd: Dict) -> None:
    """libjpeg's default_decompress_parms, then the layouts held to PIL."""
    comps = hd["comps"]
    if len(comps) == 1:
        hd["space"] = "grey"
        return
    sampling = ",".join(f"{c['h']}x{c['v']}" for c in comps)
    chroma_1x1 = all((c["h"], c["v"]) == (1, 1) for c in comps[1:])
    if len(comps) == 4:
        if not chroma_1x1 or (comps[0]["h"], comps[0]["v"]) != (1, 1):
            raise unsupported(f"4-component JPEG sampling layout {sampling} (the decoder reads "
                              f"CMYK and YCCK at 1x1)")
        hd["space"] = "ycck" if hd["adobe"] and hd["transform"] != 0 else "cmyk"
        return
    if not chroma_1x1 or (comps[0]["h"], comps[0]["v"]) not in ((1, 1), (2, 1), (2, 2)):
        raise unsupported(f"JPEG sampling layout {sampling} (the decoder reads 4:4:4, 4:2:2 "
                          f"and 4:2:0)")
    if hd["jfif"]:
        hd["space"] = "ycbcr"
    elif hd["adobe"]:
        hd["space"] = "rgb" if hd["transform"] == 0 else "ycbcr"
    else:
        rgb = tuple(c["id"] for c in comps) == (82, 71, 66)
        hd["space"] = "rgb" if rgb else "ycbcr"


def _read_scan(hd: Dict, s: bytes) -> Dict:
    ns = s[0]
    if not 1 <= ns <= 4 or len(s) < 1 + 2 * ns + 3:
        raise ValueError("bad scan header")
    comps = []
    for c in range(ns):
        comp = next((cc for cc in hd["comps"] if cc["id"] == s[1 + 2 * c]), None)
        if comp is None or any(comp is k for k in comps):
            raise ValueError("scan names an unknown component, or one twice")
        comp["td"], comp["ta"] = s[2 + 2 * c] >> 4, s[2 + 2 * c] & 15
        comps.append(comp)
    ss, se, ah, al = s[1 + 2 * ns], s[2 + 2 * ns], s[3 + 2 * ns] >> 4, s[3 + 2 * ns] & 15
    progressive = hd["sof"] == 0xC2
    if not progressive:        # one scan of every component, or several scans of some
        order = [next(k for k, f in enumerate(hd["comps"]) if f is c) for c in comps]
        if order != sorted(order):
            raise unsupported("JPEG scan in another order than its frame")
        if (ss, se, ah, al) != (0, 63, 0, 0):
            raise ValueError("baseline scan with a spectral selection")
    else:                              # jdphuff.c's start_pass_phuff_decoder
        bad = se != 0 if ss == 0 else (ss > se or se > 63 or ns != 1)
        if bad or (ah != 0 and al != ah - 1) or al > 13:
            raise ValueError("bad progressive scan parameters")
    for c in comps:
        if c["quant"] is None:         # latched at the component's first scan
            if c["tq"] not in hd["quant"]:
                raise ValueError("missing quantization table")
            c["quant"] = hd["quant"][c["tq"]].copy()
        needs_dc = not progressive or (ss == 0 and ah == 0)
        needs_ac = not progressive or ss > 0
        if (needs_dc and c["td"] not in hd["dc"]) or (needs_ac and c["ta"] not in hd["ac"]):
            raise ValueError("missing Huffman table")
        if needs_dc and max(hd["dc"][c["td"]].vals, default=0) > 15:
            raise ValueError("bad DC Huffman table")
        if progressive:
            c["bits"][ss:se + 1] = [al] * (se - ss + 1)
    return dict(comps=comps, ss=ss, se=se, ah=ah, al=al, progressive=progressive)


class _Scan:
    """The bit reader and EOB run of a scan."""

    def __init__(self, bits: _Bits):
        self.bits, self.eobrun = bits, 0


def _walk(hd: Dict, comps: List[Dict], intervals: List[bytes], block) -> None:
    """Every MCU of a scan, restart intervals included: ``block(st, comp,
    blk)`` decodes one block.  One component walks its own extent, a block
    per MCU (non-interleaved)."""
    single = len(comps) == 1
    mcux, mcuy = (comps[0]["ew"], comps[0]["eh"]) if single else (hd["mcux"], hd["mcuy"])
    ri, interval = hd["restart"], 0
    st = _Scan(_Bits(intervals[0]))
    for c in comps:
        c["pred"] = 0
    for m in range(mcux * mcuy):
        if ri and m and m % ri == 0:
            interval += 1
            if interval >= len(intervals):
                raise ValueError("missing restart marker")
            st = _Scan(_Bits(intervals[interval]))
            for c in comps:
                c["pred"] = 0
        my, mx = divmod(m, mcux)
        if single:
            block(st, comps[0], comps[0]["coef"][my, mx])
            continue
        for c in comps:
            for v in range(c["v"]):
                for h in range(c["h"]):
                    block(st, c, c["coef"][my * c["v"] + v, mx * c["h"] + h])


def _add_dc(st: _Scan, c: Dict, t: _Huffman) -> None:
    s = st.bits.decode(t)
    c["pred"] += _extend(st.bits.receive(s), s) if s else 0
    if not -2**31 <= c["pred"] < 2**31:
        raise ValueError("DC coefficient out of range")


def _decode_scan(hd: Dict, sc: Dict, intervals: List[bytes]) -> None:
    """jdhuff.c (sequential) and jdphuff.c (progressive) into the
    coefficient buffers."""
    ss, se, al = sc["ss"], sc["se"], sc["al"]
    p1, m1 = 1 << al, -1 << al

    def sequential(st, c, blk):
        _add_dc(st, c, hd["dc"][c["td"]])
        blk[0] = _jcoef(c["pred"])
        act, k = hd["ac"][c["ta"]], 1
        while k < 64:
            rs = st.bits.decode(act)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                blk[NATURAL[k]] = _extend(st.bits.receive(s), s)
            elif r == 15:
                k += 15
            else:
                break
            k += 1

    def dc_first(st, c, blk):
        _add_dc(st, c, hd["dc"][c["td"]])
        blk[0] = _jcoef(c["pred"] << al)

    def dc_refine(st, c, blk):
        if st.bits.bit():
            blk[0] = _jcoef(int(blk[0]) | p1)

    def ac_first(st, c, blk):
        if st.eobrun > 0:
            st.eobrun -= 1
            return
        act, k = hd["ac"][c["ta"]], ss
        while k <= se:
            rs = st.bits.decode(act)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                blk[NATURAL[k]] = _jcoef(_extend(st.bits.receive(s), s) << al)
            elif r == 15:
                k += 15
            else:
                st.eobrun = (1 << r) + (st.bits.receive(r) if r else 0) - 1
                break
            k += 1

    def correct(st, blk, pos):
        if st.bits.bit() and (int(blk[pos]) & p1) == 0:
            blk[pos] = _jcoef(int(blk[pos]) + (p1 if blk[pos] >= 0 else m1))

    def ac_refine(st, c, blk):
        act, k = hd["ac"][c["ta"]], ss
        if st.eobrun == 0:
            while k <= se:
                rs = st.bits.decode(act)
                r, s = rs >> 4, rs & 15
                if s:                  # a newly nonzero coefficient: +-1 at this bit
                    s = p1 if st.bits.bit() else m1
                elif r != 15:
                    st.eobrun = (1 << r) + (st.bits.receive(r) if r else 0)
                    break
                while k <= se:         # pass r zeros, correcting nonzeros on the way
                    pos = NATURAL[k]
                    if blk[pos] != 0:
                        correct(st, blk, pos)
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    blk[NATURAL[k]] = s
                k += 1
        if st.eobrun > 0:
            for k in range(k, se + 1):
                if blk[NATURAL[k]] != 0:
                    correct(st, blk, NATURAL[k])
            st.eobrun -= 1

    if not sc["progressive"]:
        block = sequential
    elif ss == 0:
        block = dc_first if sc["ah"] == 0 else dc_refine
    else:
        block = ac_first if sc["ah"] == 0 else ac_refine
    _walk(hd, sc["comps"], intervals, block)


def _check_complete(hd: Dict) -> None:
    """jdcoefct.c's smoothing_ok: libjpeg smooths a progressive file whose
    first AC coefficients still miss bits; that is refused."""
    if hd["sof"] != 0xC2:
        return
    useful = False
    for c in hd["comps"]:
        if c["quant"] is None or (c["quant"][NATURAL[:10]] == 0).any() or c["bits"][0] < 0:
            return
        useful = useful or any(b != 0 for b in c["bits"][1:10])
    if useful:
        raise unsupported("progressive JPEG whose scans leave coefficient bits unsent (libjpeg "
                          "smooths its blocks)")


def _parse(data: bytes) -> Dict:
    """Walks the markers to EOI, decoding every scan into the coefficient
    buffers as it comes."""
    if len(data) < 4 or data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (no SOI marker)")
    hd = dict(quant={}, dc={}, ac={}, restart=0, jfif=False, adobe=False, transform=0,
              comps=None, sof=0, scans=0)
    i, n = 2, len(data)
    while True:
        while i < n and data[i] != 0xFF:
            i += 1
        while i < n and data[i] == 0xFF:
            i += 1
        if i >= n:
            if hd["scans"]:
                return hd
            raise ValueError("truncated JPEG: no scan")
        m = data[i]
        i += 1
        if m == 0xD8 or 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        if m == 0xD9:
            if hd["scans"]:
                return hd
            raise ValueError("truncated JPEG: EOI before the scan")
        (length,) = struct.unpack(">H", data[i:i + 2])
        if length < 2 or i + length > n:
            raise ValueError("truncated JPEG segment")
        s = data[i + 2:i + length]
        if m in (0xC0, 0xC1, 0xC2):
            _read_frame(hd, m, s)
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
        elif m == 0xE0 and not hd["scans"]:     # examine_app0 / _app14 read 14 / 12 bytes
            hd["jfif"] = hd["jfif"] or (len(s) >= 14 and s[:5] == b"JFIF\0")
        elif m == 0xEE and not hd["scans"] and len(s) >= 12 and s[:5] == b"Adobe":
            hd["adobe"], hd["transform"] = True, s[11]
        elif m == 0xDA:
            if hd["comps"] is None:
                raise ValueError("scan before the frame header")
            if not hd["scans"]:
                _check_layout(hd)
            sc = _read_scan(hd, s)
            intervals, end = _intervals(data, i + length)
            _decode_scan(hd, sc, intervals)
            hd["scans"] += 1
            if not sc["progressive"] and len(sc["comps"]) == len(hd["comps"]):
                return hd                       # one scan holds the whole image
            i = end
            continue
        i += length


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


def _planes(hd: Dict) -> List[Array]:
    """Each component's extent through the IDCT, with its latched table."""
    planes = []
    for c in hd["comps"]:
        eh, ew = c["eh"], c["ew"]
        blocks = c["coef"][:eh, :ew].reshape(-1, 8, 8) * c["quant"].reshape(8, 8)
        planes.append(idct_islow(blocks).reshape(eh, ew, 8, 8).transpose(0, 2, 1, 3)
                      .reshape(eh * 8, ew * 8))
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


def _muldiv255(a: Array, b: Array) -> Array:
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def decode_jpeg(data: bytes) -> Array:
    """JPEG bytes -> (H, W, 3) uint8 RGB, PIL's bytes.  Unsupported
    layouts raise ``JPEGUnsupported`` (a ``NotImplementedError``)."""
    hd = _parse(bytes(data))
    _check_complete(hd)
    planes = _planes(hd)
    w, h = hd["width"], hd["height"]
    y = planes[0][:h, :w].astype(np.int64)
    if hd["space"] == "grey":
        return np.repeat(y[..., None], 3, axis=2).astype(np.uint8)
    cr_r, cb_b, cr_g, cb_g = _ycc_tables()
    if hd["space"] in ("cmyk", "ycck"):
        c, m, yy, k = (p[:h, :w].astype(np.int64) for p in planes)
        if hd["space"] == "ycck":        # jdcolor.c's ycck_cmyk_convert
            c, m, yy = (np.clip(255 - (c + t), 0, 255) for t in (
                cr_r[yy], (cb_g[m] + cr_g[yy]) >> 16, cb_b[m]))
        # PIL reads CMYK inverted ("CMYK;I") and converts with cmyk2rgb
        rgb = np.stack([k - _muldiv255(255 - ch, k) for ch in (c, m, yy)], axis=2)
        return np.clip(rgb, 0, 255).astype(np.uint8)
    rh, rv = hd["comps"][0]["h"], hd["comps"][0]["v"]
    dw, dh = -(-w // rh), -(-h // rv)
    cb = _upsample(planes[1][:dh, :dw], rh, rv, w, h)
    cr = _upsample(planes[2][:dh, :dw], rh, rv, w, h)
    if hd["space"] == "rgb":
        return np.stack([y, cb, cr], axis=2).astype(np.uint8)
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb]], axis=2)
    return np.clip(rgb, 0, 255).astype(np.uint8)
