"""The plain JPEG decoder, in Python and numpy.

The reference for the native decoder (``data/_native/jpeg.cpp``, loaded by
``data/native.py``): the same layouts, the same refusals, the same bytes,
which are PIL's (Pillow 12.1 on libjpeg-turbo 3.1 at its defaults: the
ISLOW integer IDCT, block smoothing of progressive files that still miss
bits, fancy upsampling, the fixed-point YCbCr -> RGB tables, and PIL's own
CMYK -> RGB).  It reads every JPEG that PIL decodes: 8-bit sequential and
progressive files, Huffman or arithmetic coded, and lossless files; every
scan into per-component coefficient (or sample) buffers, then the IDCT;
every integral sampling layout; grey, YCbCr, RGB, CMYK and YCCK as
libjpeg's ``default_decompress_parms`` picks them.  It refuses what PIL
refuses too (``JPEGUnsupported``): other sample precisions, hierarchical
and arithmetic-coded lossless processes, 2-component files, fractional
sampling ratios, a height held in a DNL marker, and colour conversion in a
lossless file.  The entropy decoding runs bit by bit in Python, so it is
for small images: the tests and ``chip_smoke.py`` hold the native decoder
to it.  Nothing on the training path calls it.

Corrupt data: a bad Huffman code or a restart marker out of place raises
``ValueError``; arithmetic-coded data that overflows (libjpeg's
``JWRN_ARITH_BAD_CODE``) zeroes the rest of its restart interval as
libjpeg does, and decodes to PIL's bytes.
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
_NAT = NATURAL.tolist()

# the frame headers libjpeg-turbo reads: Huffman sequential / progressive,
# lossless, arithmetic sequential / progressive
_SOF_READ = (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA)
# and those it refuses (jdmarker.c read_markers, jdmaster.c master_selection)
_SOF_REFUSED = {**{m: "hierarchical (differential) JPEG" for m in (0xC5, 0xC6, 0xC7)},
                0xC8: "JPEG of the reserved JPG process",
                0xCB: "arithmetic-coded lossless JPEG",
                **{m: "hierarchical (differential) arithmetic-coded JPEG"
                   for m in (0xCD, 0xCE, 0xCF)}}

# jaricom.c jpeg_aritab, the JPEG spec's Table D.2: (Qe, Next_Index_LPS,
# Next_Index_MPS, Switch_MPS) of each probability state; 113 is the fixed
# probability 0.5
_ARITAB = (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0),
)
# (Qe, next state after an LPS with the switch in bit 7, next after an MPS)
_QM = [(qe, (sw << 7) | lps, mps) for qe, lps, mps, sw in _ARITAB]


class JPEGUnsupported(NotImplementedError):
    """A JPEG that PIL does not decode either (and so neither does the JAX
    package, which opens every image through PIL)."""


# what works meanwhile for a dataset the port cannot decode
PACK_ROUTE = ("pack the dataset once with `python -m smmdax.data.convert` on a host with PIL, "
              "then train from the packed cache, which the port reads with numpy alone")


def unsupported(what: str) -> JPEGUnsupported:
    """The refusal of a JPEG that PIL refuses as well."""
    return JPEGUnsupported(f"{what}: PIL (libjpeg-turbo) cannot decode this JPEG either, so "
                           f"neither can the JAX package, which opens every image through PIL; "
                           f"re-encode such files first, or {PACK_ROUTE}")


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
    """jdmarker.c get_sof, and jdinput.c initial_setup's geometry."""
    if hd["sof"]:
        raise ValueError("a second frame header")
    if len(s) < 6 or len(s) < 6 + 3 * s[5]:
        raise ValueError("short frame header")
    if s[0] != 8:
        raise unsupported(f"{s[0]}-bit JPEG samples (PIL reads 8-bit JPEGs only)")
    hd["sof"] = m
    hd["progressive"] = m in (0xC2, 0xCA)
    hd["arith"] = m in (0xC9, 0xCA)
    hd["lossless"] = m == 0xC3
    hd["height"], hd["width"] = h, w = struct.unpack(">HH", s[1:5])
    nf = s[5]
    if h == 0 or w == 0:
        raise unsupported("JPEG with its height in a DNL marker, or of zero size")
    if nf not in (1, 3, 4):
        raise unsupported(f"{nf}-component JPEG (PIL reads 1, 3 and 4 components)")
    comps = [dict(id=s[6 + 3 * c], h=s[7 + 3 * c] >> 4, v=s[7 + 3 * c] & 15, tq=s[8 + 3 * c],
                  quant=None, bits=[-1] * 64) for c in range(nf)]
    if any(not (1 <= c["h"] <= 4 and 1 <= c["v"] <= 4) for c in comps):
        raise ValueError("bad sampling factors in the frame header")
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    # an iMCU row is 8 sample rows of the largest factor (1 row when lossless)
    unit = 1 if hd["lossless"] else 8
    hd["hmax"], hd["vmax"] = hmax, vmax
    hd["mcux"], hd["mcuy"] = -(-w // (unit * hmax)), -(-h // (unit * vmax))
    for c in comps:
        # blocks (samples when lossless) of the component's own extent
        c["ew"] = -(-(w * c["h"]) // (unit * hmax))
        c["eh"] = -(-(h * c["v"]) // (unit * vmax))
        shape = (hd["mcuy"] * c["v"], hd["mcux"] * c["h"])
        c["coef"] = np.zeros(shape if hd["lossless"] else shape + (64,), np.int64)
    hd["comps"] = comps


def _check_layout(hd: Dict) -> None:
    """jdapimin.c default_decompress_parms, then what jdmaster.c refuses:
    a fractional sampling ratio (jdsample.c jinit_upsampler) and, in a
    lossless file, any colour conversion (PIL asks for RGB, CMYK or grey)."""
    comps = hd["comps"]
    if len(comps) == 1:
        hd["space"] = "grey"
    elif len(comps) == 4:
        hd["space"] = "ycck" if hd["adobe"] and hd["transform"] != 0 else "cmyk"
    elif hd["jfif"]:
        hd["space"] = "ycbcr"
    elif hd["adobe"]:
        hd["space"] = "rgb" if hd["transform"] == 0 else "ycbcr"
    elif tuple(c["id"] for c in comps) == (82, 71, 66):
        hd["space"] = "rgb"
    else:       # ids 1, 2, 3 or unknown: YCbCr, but RGB in a lossless file
        hd["space"] = "rgb" if hd["lossless"] else "ycbcr"
    if hd["lossless"] and hd["space"] in ("ycbcr", "ycck"):
        raise unsupported(f"lossless JPEG in {hd['space'].upper()} (libjpeg-turbo converts no "
                          f"colour in lossless mode)")
    for c in comps:
        if hd["hmax"] % c["h"] or hd["vmax"] % c["v"]:
            sampling = ",".join(f"{k['h']}x{k['v']}" for k in comps)
            raise unsupported(f"JPEG sampling layout {sampling} (a fractional upsampling ratio)")


def _find_component(hd: Dict, cur: List, cc: int) -> Dict:
    """jdmarker.c get_sos: the first frame component of id ``cc`` whose
    own index is not a scan position filled already (libjpeg-turbo's
    check against repeated ids), among the first four."""
    for ci, comp in enumerate(hd["comps"][:4]):
        if comp["id"] == cc and cur[ci] is None:
            return comp
    if any(comp["id"] == cc for comp in hd["comps"][:4]):
        raise unsupported("JPEG scan naming a component after the scan position of its own "
                          "frame index is taken (libjpeg-turbo's get_sos looks it up there)")
    raise ValueError("scan names an unknown component")


def _read_scan(hd: Dict, s: bytes) -> Dict:
    """jdmarker.c get_sos, and the checks of each entropy decoder's
    start_pass (jdhuff.c, jdphuff.c, jdarith.c, jdlhuff.c / jdlossls.c)."""
    ns = s[0]
    if not 1 <= ns <= 4 or len(s) < 1 + 2 * ns + 3:
        raise ValueError("bad scan header")
    cur = [None] * 4
    for i in range(ns):
        comp = _find_component(hd, cur, s[1 + 2 * i])
        cur[i] = comp
        comp["td"], comp["ta"] = s[2 + 2 * i] >> 4, s[2 + 2 * i] & 15
    comps = cur[:ns]
    ss, se, ah, al = s[1 + 2 * ns], s[2 + 2 * ns], s[3 + 2 * ns] >> 4, s[3 + 2 * ns] & 15
    progressive, arith = hd["progressive"], hd["arith"]
    if hd["lossless"]:                 # jdlossls.c start_pass_lossless
        if not 1 <= ss <= 7 or se != 0 or ah != 0 or al >= 8:
            raise ValueError("bad lossless scan parameters")
    elif progressive:                  # start_pass of jdphuff.c / jdarith.c
        bad = se != 0 if ss == 0 else (ss > se or se > 63 or ns != 1)
        if bad or (ah != 0 and al != ah - 1) or al > 13:
            raise ValueError("bad progressive scan parameters")
    # a sequential scan's Ss, Se, Ah and Al are not checked (a warning only)
    for c in comps:
        if not hd["lossless"] and c["quant"] is None:   # latched at the first scan
            if c["tq"] not in hd["quant"]:
                raise ValueError("missing quantization table")
            c["quant"] = hd["quant"][c["tq"]].copy()
        needs_dc = not progressive or (ss == 0 and ah == 0)
        needs_ac = not hd["lossless"] and (not progressive or ss > 0)
        if arith:
            if c["td"] > 15 or c["ta"] > 15:
                raise ValueError("bad arithmetic table id")
        else:
            if (needs_dc and c["td"] not in hd["dc"]) or (needs_ac and c["ta"] not in hd["ac"]):
                raise ValueError("missing Huffman table")
            if needs_dc and max(hd["dc"][c["td"]].vals, default=0) > (16 if hd["lossless"]
                                                                      else 15):
                raise ValueError("bad DC Huffman table")
        if progressive:                # the progression status
            c["bits"][ss:se + 1] = [al] * (se - ss + 1)
    return dict(comps=comps, ss=ss, se=se, ah=ah, al=al)


def _mcus(hd: Dict, comps: List[Dict]):
    """Every MCU of a scan, as the (scan position, component, block row,
    block column) of its blocks.  One component walks its own extent, a
    block per MCU (non-interleaved); several walk the frame's MCUs, each
    component's blocks in the scan's order."""
    if len(comps) == 1:
        c = comps[0]
        for my in range(c["eh"]):
            for mx in range(c["ew"]):
                yield [(0, c, my, mx)]
        return
    for my in range(hd["mcuy"]):
        for mx in range(hd["mcux"]):
            yield [(p, c, my * c["v"] + v, mx * c["h"] + h) for p, c in enumerate(comps)
                   for v in range(c["v"]) for h in range(c["h"])]


# ---------------------------------------------------------------------------
# Huffman: jdhuff.c (sequential) and jdphuff.c (progressive)


def _decode_huffman_scan(hd: Dict, sc: Dict, data: bytes, start: int) -> int:
    """One Huffman scan into the coefficient buffers; the offset of the
    marker that ends it."""
    intervals, end = _intervals(data, start)
    ss, se, al = sc["ss"], sc["se"], sc["al"]
    p1, m1 = 1 << al, -1 << al
    preds = [0] * len(sc["comps"])
    st = dict(bits=_Bits(intervals[0]), eobrun=0)

    def dc_diff(c) -> int:
        t = hd["dc"][c["td"]]
        s = st["bits"].decode(t)
        return _extend(st["bits"].receive(s), s) if s else 0

    def add_dc(pos, c) -> None:
        preds[pos] += dc_diff(c)
        if not -2**31 <= preds[pos] < 2**31:
            raise ValueError("DC coefficient out of range")

    def sequential(pos, c, blk):
        add_dc(pos, c)
        blk[0] = _jcoef(preds[pos])
        bits, act, k = st["bits"], hd["ac"][c["ta"]], 1
        while k < 64:
            rs = bits.decode(act)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                blk[_NAT[k]] = _extend(bits.receive(s), s)
            elif r == 15:
                k += 15
            else:
                break
            k += 1

    def dc_first(pos, c, blk):
        add_dc(pos, c)
        blk[0] = _jcoef(preds[pos] << al)

    def dc_refine(pos, c, blk):
        if st["bits"].bit():
            blk[0] = _jcoef(int(blk[0]) | p1)

    def ac_first(pos, c, blk):
        if st["eobrun"] > 0:
            st["eobrun"] -= 1
            return
        bits, act, k = st["bits"], hd["ac"][c["ta"]], ss
        while k <= se:
            rs = bits.decode(act)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                blk[_NAT[k]] = _jcoef(_extend(bits.receive(s), s) << al)
            elif r == 15:
                k += 15
            else:
                st["eobrun"] = (1 << r) + (bits.receive(r) if r else 0) - 1
                break
            k += 1

    def correct(blk, pos):
        if st["bits"].bit() and (int(blk[pos]) & p1) == 0:
            blk[pos] = _jcoef(int(blk[pos]) + (p1 if blk[pos] >= 0 else m1))

    def ac_refine(pos_, c, blk):
        bits, act, k = st["bits"], hd["ac"][c["ta"]], ss
        if st["eobrun"] == 0:
            while k <= se:
                rs = bits.decode(act)
                r, s = rs >> 4, rs & 15
                if s:                  # a newly nonzero coefficient: +-1 at this bit
                    s = p1 if bits.bit() else m1
                elif r != 15:
                    st["eobrun"] = (1 << r) + (bits.receive(r) if r else 0)
                    break
                while k <= se:         # pass r zeros, correcting nonzeros on the way
                    pos = _NAT[k]
                    if blk[pos] != 0:
                        correct(blk, pos)
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    blk[_NAT[k]] = s
                k += 1
        if st["eobrun"] > 0:
            for k in range(k, se + 1):
                if blk[_NAT[k]] != 0:
                    correct(blk, _NAT[k])
            st["eobrun"] -= 1

    if not hd["progressive"]:
        block = sequential
    elif ss == 0:
        block = dc_first if sc["ah"] == 0 else dc_refine
    else:
        block = ac_first if sc["ah"] == 0 else ac_refine
    ri, interval = hd["restart"], 0
    for m, mcu in enumerate(_mcus(hd, sc["comps"])):
        if ri and m and m % ri == 0:
            interval += 1
            if interval >= len(intervals):
                raise ValueError("missing restart marker")
            st.update(bits=_Bits(intervals[interval]), eobrun=0)
            preds = [0] * len(preds)
        for pos, c, by, bx in mcu:
            block(pos, c, c["coef"][by, bx])
    return end


# ---------------------------------------------------------------------------
# arithmetic: jdarith.c


class _Arith:
    """jdarith.c's decoder state over the entropy-coded data from ``pos``:
    the C and A registers, the bit counter ``ct`` (-1 after corrupt
    data), and the marker met in the data (zeros are fed after it)."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos
        self.marker = 0
        self.c = self.a = 0
        self.ct = -16
        self.next_restart = 0

    def _byte(self) -> int:
        """jdarith.c get_byte, with its handling of 0xFF."""
        if self.marker:
            return 0
        data, n = self.data, len(self.data)
        if self.pos >= n:
            self.marker = 0xD9
            return 0
        b = data[self.pos]
        self.pos += 1
        if b != 0xFF:
            return b
        while self.pos < n and data[self.pos] == 0xFF:
            self.pos += 1
        nxt = data[self.pos] if self.pos < n else 0xD9
        self.pos += 1
        if nxt == 0:
            return 0xFF
        self.marker = nxt
        return 0

    def decode(self, st: List[int], i: int) -> int:
        """jdarith.c arith_decode: one binary decision on statistics bin
        ``st[i]`` (its state index, the MPS sense in bit 7)."""
        while self.a < 0x8000:
            self.ct -= 1
            if self.ct < 0:
                self.c = (self.c << 8) | self._byte()
                self.ct += 8
                if self.ct < 0:
                    self.ct += 1
                    if self.ct == 0:
                        self.a = 0x8000          # two initial bytes read
            self.a <<= 1
        sv = st[i]
        qe, nl, nm = _QM[sv & 0x7F]
        temp = self.a - qe
        self.a = temp
        temp <<= self.ct
        if self.c >= temp:
            self.c -= temp
            if self.a < qe:                      # conditional LPS exchange
                self.a = qe
                st[i] = (sv & 0x80) ^ nm
            else:
                self.a = qe
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif self.a < 0x8000:                    # conditional MPS exchange
            if self.a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        return sv >> 7

    def restart(self) -> None:
        """jdmarker.c read_restart_marker: the next marker (bytes before
        it skipped, as next_marker does) must be the expected RSTn."""
        if not self.marker:
            data, n = self.data, len(self.data)
            while True:
                while self.pos < n and data[self.pos] != 0xFF:
                    self.pos += 1
                while self.pos < n and data[self.pos] == 0xFF:
                    self.pos += 1
                if self.pos >= n:
                    raise ValueError("missing restart marker")
                self.pos += 1
                if data[self.pos - 1] != 0:
                    self.marker = data[self.pos - 1]
                    break
        if self.marker != 0xD0 + self.next_restart:
            raise ValueError("restart marker out of order")
        self.marker = 0
        self.next_restart = (self.next_restart + 1) & 7
        self.c = self.a = 0
        self.ct = -16


_FIXED = [113]        # jdarith.c fixed_bin: probability 0.5, never adapted


def _decode_arith_scan(hd: Dict, sc: Dict, data: bytes, start: int) -> int:
    """One arithmetic-coded scan into the coefficient buffers (jdarith.c
    decode_mcu, decode_mcu_DC_first, _AC_first, _DC_refine, _AC_refine);
    the offset of the marker that ends it."""
    comps, ss, se, ah, al = sc["comps"], sc["ss"], sc["se"], sc["ah"], sc["al"]
    progressive = hd["progressive"]
    ar = _Arith(data, start)
    uses_dc = not progressive or (ss == 0 and ah == 0)
    uses_ac = not progressive or ss > 0
    dc_stats, ac_stats = hd["dc_stats"], hd["ac_stats"]
    last_dc = [0] * len(comps)
    context = [0] * len(comps)

    def reset_statistics():
        for pos, c in enumerate(comps):
            if uses_dc:
                dc_stats[c["td"]] = [0] * 64
                last_dc[pos] = context[pos] = 0
            if uses_ac:
                ac_stats[c["ta"]] = [0] * 256

    def dc_value(pos, c) -> bool:
        """Figures F.19-F.24: the DC difference into last_dc; False after
        a magnitude overflow."""
        tbl = c["td"]
        st = dc_stats[tbl]
        i = context[pos]
        if ar.decode(st, i) == 0:
            context[pos] = 0
            return True
        sign = ar.decode(st, i + 1)
        i += 2 + sign
        m = ar.decode(st, i)
        if m:
            i = 20                                # Table F.4: X1 = 20
            while ar.decode(st, i):
                m <<= 1
                if m == 0x8000:
                    return False
                i += 1
        if m < (1 << hd["dac_l"][tbl]) >> 1:      # F.1.4.4.1.2: conditioning category
            context[pos] = 0
        elif m > (1 << hd["dac_u"][tbl]) >> 1:
            context[pos] = 12 + sign * 4
        else:
            context[pos] = 4 + sign * 4
        v = m
        i += 14
        m >>= 1
        while m:
            if ar.decode(st, i):
                v |= m
            m >>= 1
        v += 1
        last_dc[pos] = (last_dc[pos] + (-v if sign else v)) & 0xFFFF
        return True

    def ac_values(c, blk, lo, hi, shift) -> bool:
        """Figure F.20 over coefficients lo..hi; False after a spectral or
        magnitude overflow."""
        tbl = c["ta"]
        st = ac_stats[tbl]
        k = lo
        while k <= hi:
            i = 3 * (k - 1)
            if ar.decode(st, i):                  # EOB
                break
            while ar.decode(st, i + 1) == 0:
                i += 3
                k += 1
                if k > hi:
                    return False
            sign = ar.decode(_FIXED, 0)
            i += 2
            m = ar.decode(st, i)
            if m and ar.decode(st, i):
                m <<= 1
                i = 189 if k <= hd["dac_k"][tbl] else 217
                while ar.decode(st, i):
                    m <<= 1
                    if m == 0x8000:
                        return False
                    i += 1
            v = m
            i += 14
            m >>= 1
            while m:
                if ar.decode(st, i):
                    v |= m
                m >>= 1
            v += 1
            blk[_NAT[k]] = _jcoef((-v if sign else v) << shift)
            k += 1
        return True

    def ac_refine(c, blk) -> bool:
        tbl = c["ta"]
        st = ac_stats[tbl]
        p1, m1 = 1 << al, -1 << al
        kex = se                                  # the previous stage's end of block
        while kex > 0 and not blk[_NAT[kex]]:
            kex -= 1
        k = ss
        while k <= se:
            i = 3 * (k - 1)
            if k > kex and ar.decode(st, i):      # EOB
                break
            while True:
                pos = _NAT[k]
                if blk[pos]:                      # previously nonzero: a correction bit
                    if ar.decode(st, i + 2):
                        blk[pos] = _jcoef(int(blk[pos]) + (m1 if blk[pos] < 0 else p1))
                    break
                if ar.decode(st, i + 1):          # newly nonzero
                    blk[pos] = m1 if ar.decode(_FIXED, 0) else p1
                    break
                i += 3
                k += 1
                if k > se:
                    return False
            k += 1
        return True

    def mcu(blocks) -> None:
        if ar.ct == -1:                           # after corrupt data: nothing
            return
        for pos, c, by, bx in blocks:
            blk = c["coef"][by, bx]
            if not progressive:
                if not dc_value(pos, c):
                    ar.ct = -1
                    return
                blk[0] = _jcoef(last_dc[pos])
                if not ac_values(c, blk, 1, 63, 0):
                    ar.ct = -1
                    return
            elif ss == 0 and ah == 0:
                if not dc_value(pos, c):
                    ar.ct = -1
                    return
                blk[0] = _jcoef(last_dc[pos] << al)
            elif ss == 0:
                if ar.decode(_FIXED, 0):
                    blk[0] = _jcoef(int(blk[0]) | (1 << al))
            elif ah == 0:
                if not ac_values(c, blk, ss, se, al):
                    ar.ct = -1
                    return
            elif not ac_refine(c, blk):
                ar.ct = -1
                return

    reset_statistics()
    ri, to_go = hd["restart"], hd["restart"]
    for blocks in _mcus(hd, comps):
        if ri:
            if to_go == 0:                        # jdarith.c process_restart
                ar.restart()
                reset_statistics()
                to_go = ri
            to_go -= 1
        mcu(blocks)
    return _intervals(data, start)[1]


# ---------------------------------------------------------------------------
# lossless: jdlhuff.c, jddiffct.c, jdlossls.c


def _undifference(diff: List[int], prev: List[int], psv: int, first: bool,
                  initial: int) -> List[int]:
    """jdlossls.c: one row of samples (mod 2^16) from its differences, by
    the first-row undifferencer (``initial``, then predictor 1) or by
    predictor ``psv`` (the first column by predictor 2)."""
    out = [0] * len(diff)
    if first:
        ra = (diff[0] + initial) & 0xFFFF
        out[0] = ra
        for x in range(1, len(diff)):
            ra = (diff[x] + ra) & 0xFFFF
            out[x] = ra
        return out
    rb = prev[0]
    ra = (diff[0] + rb) & 0xFFFF
    out[0] = ra
    for x in range(1, len(diff)):
        rc, rb = rb, prev[x]
        pred = (ra if psv == 1 else rb if psv == 2 else rc if psv == 3 else
                ra + rb - rc if psv == 4 else ra + ((rb - rc) >> 1) if psv == 5 else
                rb + ((ra - rc) >> 1) if psv == 6 else (ra + rb) >> 1)
        ra = (diff[x] + pred) & 0xFFFF
        out[x] = ra
    return out


def _decode_lossless_scan(hd: Dict, sc: Dict, data: bytes, start: int) -> int:
    """One lossless scan: jddiffct.c decompress_data per iMCU row (the
    difference rows of each MCU row, restart intervals counted in MCU
    rows), then jdlossls.c's undifferencing and point transform of each
    component row into its sample buffer."""
    comps, psv, pt = sc["comps"], sc["ss"], sc["al"]
    intervals, end = _intervals(data, start)
    single = len(comps) == 1
    mcux = comps[0]["ew"] if single else hd["mcux"]
    ri = hd["restart"]
    if ri % mcux:
        raise ValueError("lossless restart interval not a whole number of MCU rows")
    initial = 1 << (8 - pt - 1)
    diffs = {id(c): np.zeros(c["coef"].shape, np.int64) for c in comps}
    for c in hd["comps"]:         # jdlossls.c start_pass_lossless: a first row next
        c["first"] = True
    bits, interval, rows_to_go = _Bits(intervals[0]), 0, ri // mcux
    t = hd["mcuy"]
    for imcu in range(t):
        if single:
            c = comps[0]
            n_rows = c["v"] if imcu < t - 1 else (c["eh"] % c["v"] or c["v"])
        else:
            n_rows = 1
        for y in range(n_rows):
            if ri:
                if rows_to_go == 0:              # jddiffct.c process_restart
                    interval += 1
                    if interval >= len(intervals):
                        raise ValueError("missing restart marker")
                    bits = _Bits(intervals[interval])
                    for c in hd["comps"]:
                        c["first"] = True
                    rows_to_go = ri // mcux
            for mx in range(mcux):               # jdlhuff.c decode_mcus
                if single:
                    units = [(comps[0], imcu * comps[0]["v"] + y, mx)]
                else:
                    units = [(c, imcu * c["v"] + v, mx * c["h"] + h) for c in comps
                             for v in range(c["v"]) for h in range(c["h"])]
                for c, r, x in units:
                    s = bits.decode(hd["dc"][c["td"]])
                    d = 0
                    if s == 16:
                        d = 32768
                    elif s:
                        d = _extend(bits.receive(s), s)
                    diffs[id(c)][r, x] = d
            if ri:
                rows_to_go -= 1
        for c in comps:                          # undifference the iMCU row
            rows = c["v"] if imcu < t - 1 else (c["eh"] % c["v"] or c["v"])
            for y in range(rows):
                r = imcu * c["v"] + y
                ew = c["ew"]
                prev = c["undiff"] if "undiff" in c else [0] * ew
                row = _undifference(diffs[id(c)][r, :ew].tolist(), prev, psv, c["first"],
                                    initial)
                c["first"] = False
                c["undiff"] = row
                c["coef"][r, :ew] = [(v << pt) & 0xFF for v in row]
    return end


# ---------------------------------------------------------------------------


def _get_dac(hd: Dict, s: bytes) -> None:
    """jdmarker.c get_dac: conditioning of arithmetic tables 0-15 (DC: L
    and U) and 16-31 (AC: Kx)."""
    if len(s) % 2:
        raise ValueError("bad DAC marker length")
    for k in range(0, len(s), 2):
        index, val = s[k], s[k + 1]
        if index >= 32:
            raise ValueError("bad DAC table index")
        if index >= 16:
            hd["dac_k"][index - 16] = val
        else:
            hd["dac_l"][index], hd["dac_u"][index] = val & 15, val >> 4
            if (val & 15) > (val >> 4):
                raise ValueError("bad DAC value")


def _parse(data: bytes) -> Dict:
    """Walks the markers to EOI, decoding every scan into the coefficient
    buffers as it comes."""
    if len(data) < 4 or data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (no SOI marker)")
    hd = dict(quant={}, dc={}, ac={}, restart=0, jfif=False, adobe=False, transform=0,
              comps=None, sof=0, scans=0, dac_l=[0] * 16, dac_u=[1] * 16,
              dac_k=[5] * 16, dc_stats={}, ac_stats={})
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
        if m in _SOF_READ:
            _read_frame(hd, m, s)
        elif m in _SOF_REFUSED:
            raise unsupported(_SOF_REFUSED[m])
        elif m == 0xC4:
            k = 0
            while k < len(s):
                tc, th = s[k] >> 4, s[k] & 15
                counts = s[k + 1:k + 17]
                total = sum(counts)
                (hd["dc"] if tc == 0 else hd["ac"])[th] = _Huffman(counts, s[k + 17:k + 17 + total])
                k += 17 + total
        elif m == 0xCC:
            _get_dac(hd, s)
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
            decode = (_decode_lossless_scan if hd["lossless"] else
                      _decode_arith_scan if hd["arith"] else _decode_huffman_scan)
            end = decode(hd, sc, data, i + length)
            hd["scans"] += 1
            if not hd["progressive"] and len(sc["comps"]) == len(hd["comps"]):
                return hd                       # one scan holds the whole image
            i = end
            continue
        i += length


# ---------------------------------------------------------------------------
# the IDCT and block smoothing (jidctint.c, jdcoefct.c)


def _descale(x: Array, n: int) -> Array:
    return (x + (1 << (n - 1))) >> n


def _wrap16(x: Array) -> Array:
    return ((x + 32768) & 0xFFFF) - 32768


def _idct_1d(i: List[Array]) -> List[Array]:
    """jidctint.c's butterfly on the eight inputs (each an array), in the
    arrangement of libjpeg-turbo's x86-64 SIMD version (jidctint-avx2.asm),
    the IDCT PIL runs: the products distributed so that no sum is formed
    before a multiply, and in0 +- in4, in7 + in3 and in5 + in1 summed in 16
    bits.  For the coefficients an encoder writes this is jidctint.c's
    result exactly; for corrupt data it is PIL's."""
    tmp2 = i[2] * 4433 + i[6] * (4433 - 15137)
    tmp3 = i[2] * (4433 + 6270) + i[6] * 4433
    tmp0 = _wrap16(i[0] + i[4]) << 13
    tmp1 = _wrap16(i[0] - i[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = i[7], i[5], i[3], i[1]
    z3, z4 = _wrap16(t0 + t2), _wrap16(t1 + t3)
    z3, z4 = z3 * (9633 - 16069) + z4 * 9633, z3 * 9633 + z4 * (9633 - 3196)
    a0 = t0 * (2446 - 7373) + t3 * -7373 + z3
    a3 = t0 * -7373 + t3 * (12299 - 7373) + z4
    a1 = t1 * (16819 - 20995) + t2 * -20995 + z4
    a2 = t1 * -20995 + t2 * (25172 - 20995) + z3
    return [tmp10 + a3, tmp11 + a2, tmp12 + a1, tmp13 + a0,
            tmp13 - a0, tmp12 - a1, tmp11 - a2, tmp10 - a3]


def idct_islow(coef: Array, quant: Array) -> Array:
    """(N, 8, 8) coefficients and their (8, 8) table (int64, natural order)
    -> (N, 8, 8) uint8 samples, as libjpeg-turbo's SIMD ISLOW IDCT gives
    them: dequantized in 16 bits; a block whose rows 1-7 are all zero takes
    pass 1's shortcut (the DC row shifted left by 2 in 16 bits); each
    pass's output saturated to 16 bits, the last then to -128..127."""
    deq = _wrap16(coef * quant)
    cols = _idct_1d([deq[:, r, :] for r in range(8)])
    ws = np.stack([np.clip(_descale(o, 11), -32768, 32767) for o in cols], axis=1)
    flat = (coef[:, 1:, :] == 0).all(axis=(1, 2))
    ws[flat] = _wrap16(deq[flat, 0:1, :] << 2)
    rows = _idct_1d([ws[:, :, c] for c in range(8)])
    out = np.stack([np.clip(_descale(o, 18), -32768, 32767) for o in rows], axis=2)
    return (np.clip(out, -128, 127) + 128).astype(np.uint8)


# natural positions of zigzag coefficients 1-9: AC01, AC10, AC20, AC11,
# AC02, AC03, AC12, AC21, AC30; SAVED_COEFS is 10 with the DC
_Q_POS = (1, 8, 16, 9, 2, 3, 10, 17, 24)

# jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1+): the weights of
# the 5x5 DC neighbourhood (rows top to bottom) behind each estimate; the
# first set when some AC coefficients of the band were sent, the second
# (with the DC itself and AC03-AC30) when none of AC01-AC30 was
_SMOOTH_AC = {
    1: [[0] * 5, [0] * 5, [-7, 50, 0, -50, 7], [0] * 5, [0] * 5],
    8: [[0, 0, -7, 0, 0], [0, 0, 50, 0, 0], [0] * 5, [0, 0, -50, 0, 0], [0, 0, 7, 0, 0]],
    16: [[0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0], [0, 0, 13, 0, 0], [0, 0, -1, 0, 0]],
    9: [[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0] * 5, [1, -10, 0, 10, -1], [0, 1, 0, -1, 0]],
    2: [[0] * 5, [0] * 5, [-1, 13, -24, 13, -1], [0] * 5, [0] * 5],
}
_SMOOTH_DC_ONLY = {
    1: [[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3], [-3, 13, 0, -13, 3],
        [-1, -1, 0, 1, 1]],
    8: [[-1, -3, -3, -3, -1], [-1, 13, 38, 13, -1], [0] * 5, [1, -13, -38, -13, 1],
        [1, 3, 3, 3, 1]],
    16: [[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0], [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]],
    9: [[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0] * 5, [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]],
    2: [[0] * 5, [0, 2, -5, 2, 0], [1, 7, -14, 7, 1], [0, 2, -5, 2, 0], [0] * 5],
    3: [[0] * 5, [0, 1, 0, -1, 0], [0, 2, 0, -2, 0], [0, 1, 0, -1, 0], [0] * 5],
    10: [[0] * 5, [0, 1, -3, 1, 0], [0] * 5, [0, -1, 3, -1, 0], [0] * 5],
    17: [[0] * 5, [0, 1, 0, -1, 0], [0, -3, 0, 3, 0], [0, 1, 0, -1, 0], [0] * 5],
    24: [[0] * 5, [0, 1, 2, 1, 0], [0] * 5, [0, -1, -2, -1, 0], [0] * 5],
    0: [[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6], [-8, 42, 152, 42, -8], [-6, 6, 42, 6, -6],
        [-2, -6, -8, -6, -2]],
}


def _smoothing_ok(hd: Dict) -> bool:
    """jdcoefct.c smoothing_ok: a progressive file whose components all
    have their DC and first nine AC quantizers nonzero, a DC sent, and
    some of AC01-AC30 still missing bits."""
    if not hd["progressive"]:
        return False
    useful = False
    for c in hd["comps"]:
        if c["quant"] is None or (c["quant"][NATURAL[:10]] == 0).any() or c["bits"][0] < 0:
            return False
        useful = useful or any(b != 0 for b in c["bits"][1:10])
    return useful


def _predict(num: int, q: int, al: int) -> int:
    """An estimate from ``num``, rounded, limited below the bits not yet
    sent (``al`` > 0), as decompress_smooth_data forms it."""
    pred = ((q << 7) + abs(num)) // (q << 8)
    if al > 0 and pred >= (1 << al):
        pred = (1 << al) - 1
    return pred if num >= 0 else -pred


def _smooth(hd: Dict, c: Dict) -> Array:
    """jdcoefct.c decompress_smooth_data for one component: its extent's
    blocks with the estimated coefficients, read from the buffer block by
    block as libjpeg reads it (the neighbourhood's rows from the block row
    computed with the iMCU row's count of block rows, the columns clamped
    to the extent).  libjpeg smooths the rows past the last one a scan
    decoded from real data with the bits of the scan before; this decoder
    feeds zeros past the end instead, so only a Huffman scan cut short can
    tell the two apart (arithmetic scans never run short in libjpeg)."""
    coef, bits, q = c["coef"], c["bits"], c["quant"]
    ew, eh, v, t = c["ew"], c["eh"], c["v"], hd["mcuy"]
    change_dc = all(b == -1 for b in bits[1:10])
    weights = _SMOOTH_DC_ONLY if change_dc else _SMOOTH_AC
    out = coef[:eh, :ew].copy()
    dcs = coef[..., 0]
    for r in range(t):
        block_rows = v if r < t - 1 else (eh % v or v)
        image_block_rows = block_rows * t
        for b in range(block_rows):
            row = r * v + b
            image_row = r * block_rows + b
            prev = row - 1 if image_row > 0 else row
            prev2 = row - 2 if image_row > 1 else prev
            nxt = row + 1 if image_row < image_block_rows - 1 else row
            nxt2 = row + 2 if image_row < image_block_rows - 2 else nxt
            rows = (prev2, prev, row, nxt, nxt2)
            for x in range(ew):
                cols = [min(max(x + dx, 0), ew - 1) for dx in (-2, -1, 0, 1, 2)]
                dc = [[int(dcs[rr, cc]) for cc in cols] for rr in rows]
                blk = out[row, x]
                for k, pos in enumerate(_Q_POS, 1):
                    if pos not in weights:
                        continue
                    al = bits[k]
                    if al != 0 and blk[pos] == 0:
                        w = weights[pos]
                        s = sum(w[i][j] * dc[i][j] for i in range(5) for j in range(5))
                        blk[pos] = _jcoef(_predict(int(q[0]) * s, int(q[pos]), al))
                if change_dc:
                    w = weights[0]
                    s = sum(w[i][j] * dc[i][j] for i in range(5) for j in range(5))
                    blk[0] = _jcoef(_predict(int(q[0]) * s, int(q[0]), 0))
    return out


def _planes(hd: Dict) -> List[Array]:
    """Each component's extent as samples: through the IDCT with its
    latched table (smoothed first where libjpeg smooths), or the lossless
    samples as they are."""
    if hd["lossless"]:
        return [c["coef"][:c["eh"], :c["ew"]] for c in hd["comps"]]
    smooth = _smoothing_ok(hd)
    planes = []
    for c in hd["comps"]:
        eh, ew = c["eh"], c["ew"]
        blocks = _smooth(hd, c) if smooth else c["coef"][:eh, :ew]
        planes.append(idct_islow(blocks.reshape(-1, 8, 8), c["quant"].reshape(8, 8))
                      .reshape(eh, ew, 8, 8).transpose(0, 2, 1, 3).reshape(eh * 8, ew * 8))
    return planes


# ---------------------------------------------------------------------------
# upsampling (jdsample.c) and colour conversion (jdcolor.c, Pillow's Convert.c)


def _upsample(p: Array, h_expand: int, v_expand: int, dw: int, dh: int, width: int,
              height: int, fancy: bool) -> Array:
    """A component's plane (its downsampled extent dh x dw) -> (height,
    width), by the method jdsample.c jinit_upsampler picks for its ratio:
    fullsize; h2v1 and h2v2 fancy (triangle) when the plane is more than 2
    wide; h1v2 fancy (4:4:0); else int_upsample's replication."""
    p = p[:dh, :dw].astype(np.int64)
    if h_expand == 1 and v_expand == 1:
        return p[:height, :width]
    if fancy and h_expand == 1 and v_expand == 2:           # h1v2_fancy_upsample
        i = np.arange(2 * dh) >> 1
        odd = np.arange(2 * dh) & 1
        other = np.where(odd, np.minimum(i + 1, dh - 1), np.maximum(i - 1, 0))
        return ((p[i] * 3 + p[other] + 1 + odd[:, None]) >> 2)[:height, :width]
    if not (fancy and h_expand == 2 and v_expand in (1, 2) and dw > 2):
        return np.repeat(np.repeat(p, v_expand, axis=0), h_expand, axis=1)[:height, :width]
    if v_expand == 2:
        i = np.arange(2 * dh) >> 1
        other = np.where(np.arange(2 * dh) & 1, np.minimum(i + 1, dh - 1), np.maximum(i - 1, 0))
        up = p[i] * 3 + p[other]
    else:
        up = p
    prev = np.concatenate([up[:, :1], up[:, :-1]], axis=1)
    nxt = np.concatenate([up[:, 1:], up[:, -1:]], axis=1)
    out = np.empty((up.shape[0], 2 * dw), np.int64)
    if v_expand == 2:                                       # h2v2_fancy_upsample
        out[:, 0::2] = (up * 3 + prev + 8) >> 4
        out[:, 1::2] = (up * 3 + nxt + 7) >> 4
        out[:, 0] = (up[:, 0] * 4 + 8) >> 4
        out[:, -1] = (up[:, -1] * 4 + 7) >> 4
    else:                                                   # h2v1_fancy_upsample
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
    """JPEG bytes -> (H, W, 3) uint8 RGB, PIL's bytes.  Files PIL does not
    decode either raise ``JPEGUnsupported`` (a ``NotImplementedError``)."""
    hd = _parse(bytes(data))
    planes = _planes(hd)
    w, h = hd["width"], hd["height"]
    # fancy upsampling needs the DCT's 8x8 output (jdsample.c do_fancy)
    fancy = not hd["lossless"]
    full = []
    for c, p in zip(hd["comps"], planes):
        dw = -(-(w * c["h"]) // hd["hmax"])
        dh = -(-(h * c["v"]) // hd["vmax"])
        full.append(_upsample(p, hd["hmax"] // c["h"], hd["vmax"] // c["v"], dw, dh, w, h,
                              fancy))
    if hd["space"] == "grey":
        return np.repeat(full[0][..., None], 3, axis=2).astype(np.uint8)
    cr_r, cb_b, cr_g, cb_g = _ycc_tables()
    if hd["space"] in ("cmyk", "ycck"):
        c, m, yy, k = full
        if hd["space"] == "ycck":        # jdcolor.c's ycck_cmyk_convert
            c, m, yy = (np.clip(255 - (c + t), 0, 255) for t in (
                cr_r[yy], (cb_g[m] + cr_g[yy]) >> 16, cb_b[m]))
        # PIL reads CMYK inverted ("CMYK;I") and converts with cmyk2rgb
        rgb = np.stack([k - _muldiv255(255 - ch, k) for ch in (c, m, yy)], axis=2)
        return np.clip(rgb, 0, 255).astype(np.uint8)
    y, cb, cr = full
    if hd["space"] == "rgb":
        return np.stack([y, cb, cr], axis=2).astype(np.uint8)
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb]], axis=2)
    return np.clip(rgb, 0, 255).astype(np.uint8)
