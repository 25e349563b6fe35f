// JPEG decoder whose output equals PIL's byte for byte.
//
// PIL (Pillow 12.1) decodes with libjpeg-turbo 3.1 at its defaults, and
// this file reproduces those defaults exactly: the ISLOW integer IDCT (13
// constant bits, 2 pass-1 bits) as its x86-64 SIMD version computes it,
// libjpeg-turbo 2.1+'s block smoothing of progressive files whose first AC coefficients
// still miss bits (jdcoefct.c decompress_smooth_data, its 5x5 DC
// neighbourhood), the upsampling method jdsample.c picks for each
// component's ratio ("fancy" triangle h2v1 / h2v2 when the plane is more
// than 2 samples wide, h1v2 for 4:4:0, replication otherwise; context rows
// replicated at the top and bottom of the image), and the fixed-point
// YCbCr -> RGB tables (16 scale bits).  Grey images come out as RGB with
// the grey value in every channel, as PIL's convert("RGB") gives them.
//
// Covered: every JPEG PIL decodes.  Sequential (SOF0 / SOF1) and
// progressive (SOF2) Huffman coding (jdhuff.c, jdphuff.c), sequential and
// progressive arithmetic coding (SOF9 / SOF10, jdarith.c: the QM decoder,
// the DC and AC statistics and their DAC conditioning, the reset at each
// restart, and its corrupt-data path, which zeroes the rest of a restart
// interval), and lossless files (SOF3, jdlhuff.c / jddiffct.c /
// jdlossls.c: predictors 1-7, the point transform, restart intervals
// counted in MCU rows), 8-bit samples; every scan up to EOI (interleaved
// in the scan's own component order as jdmarker.c's get_sos looks the
// components up, or of one component walking its own extent) goes into
// per-component coefficient (or sample) buffers, and the IDCT runs once at
// the end.  Every integral sampling layout.  Colour spaces as libjpeg's
// default_decompress_parms picks them: grey; three components as YCbCr
// (JFIF, Adobe transform 1) or RGB (Adobe transform 0, component ids R, G,
// B, or a lossless file without markers); four as CMYK (Adobe transform
// 0, or no Adobe marker) or YCCK (any other transform), which PIL reads
// inverted and converts with its own cmyk2rgb.  Byte stuffing, fill bytes,
// tables between scans, any image size.  Refused with status 1, as PIL
// refuses them: other sample precisions, 2-component files, hierarchical
// and arithmetic lossless processes, a height in a DNL marker, fractional
// sampling ratios, colour conversion in a lossless file, and a scan naming
// a component where get_sos cannot take it.
//
// Also here: the two integer passes of PIL's bilinear resample (horizontal
// first, rounded to uint8 between them), on fixed-point weights that the
// caller computes as Pillow does (smmdax_torch/data/image.py).
//
// Plain C interface for ctypes; a call holds no global state, so threads
// may decode side by side.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kUnsupported = 1;
constexpr int kMalformed = 2;
constexpr int64_t kMaxPixels = 178956970;   // 2 * PIL's Image.MAX_IMAGE_PIXELS

struct Failure {
  int code;
  std::string msg;
};

[[noreturn]] void unsupported(const std::string& msg) { throw Failure{kUnsupported, msg}; }
[[noreturn]] void malformed(const std::string& msg) { throw Failure{kMalformed, msg}; }

// zigzag index -> natural (row-major) index; entries past 63 catch a
// corrupt run length as libjpeg's table does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool present = false;
  int32_t maxcode[17];     // largest code of each length, -1 if none
  int32_t valoffset[17];   // index into vals of a length's first code, minus that code
  uint8_t vals[256];
  int nvals = 0;
  uint8_t fast_len[512];   // 9-bit lookahead: code length (0: longer than 9)
  uint8_t fast_val[512];
};

void build_huffman(Huffman& t, const uint8_t* counts, const uint8_t* vals, int nvals) {
  std::memset(t.fast_len, 0, sizeof t.fast_len);
  std::memset(t.vals, 0, sizeof t.vals);
  std::memcpy(t.vals, vals, nvals);
  t.nvals = nvals;
  int32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    t.valoffset[len] = k - code;
    if (counts[len - 1]) {
      for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
        if (code >= (1 << len)) malformed("bad Huffman table");
        if (len <= 9) {
          int shift = 9 - len;
          for (int j = 0; j < (1 << shift); ++j) {
            t.fast_len[(code << shift) | j] = static_cast<uint8_t>(len);
            t.fast_val[(code << shift) | j] = vals[k];
          }
        }
      }
      t.maxcode[len] = code - 1;
    } else {
      t.maxcode[len] = -1;
    }
    code <<= 1;
  }
  t.present = true;
}

// Entropy-coded data: 0xFF 0x00 is a stuffed 0xFF, runs of 0xFF are fill
// bytes, any other 0xFF xx is a marker, after which zero bits are fed (as
// libjpeg feeds them).
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int nbits = 0;
  int marker = -1;   // the marker code met, -1 while none

  void fill() {
    while (nbits <= 56) {
      uint32_t byte = 0;
      if (marker < 0 && p < end) {
        byte = *p++;
        if (byte == 0xFF) {
          while (p < end && *p == 0xFF) ++p;
          uint32_t next = p < end ? *p++ : 0xD9;
          if (next != 0) {
            marker = static_cast<int>(next);
            byte = 0;
          }
        }
      }
      buf |= static_cast<uint64_t>(byte) << (56 - nbits);
      nbits += 8;
    }
  }

  uint32_t bits(int n) {   // n in 1..16
    if (nbits < n) fill();
    uint32_t v = static_cast<uint32_t>(buf >> (64 - n));
    buf <<= n;
    nbits -= n;
    return v;
  }

  int decode(const Huffman& t) {
    if (nbits < 16) fill();
    uint32_t look = static_cast<uint32_t>(buf >> (64 - 9));
    int len = t.fast_len[look];
    if (len) {
      buf <<= len;
      nbits -= len;
      return t.fast_val[look];
    }
    uint32_t code16 = static_cast<uint32_t>(buf >> 48);
    for (len = 10; len <= 16; ++len) {
      int32_t code = static_cast<int32_t>(code16 >> (16 - len));
      if (code <= t.maxcode[len]) {
        buf <<= len;
        nbits -= len;
        return t.vals[(t.valoffset[len] + code) & 0xFF];
      }
    }
    malformed("corrupt Huffman code");
  }

  // the restart marker ends the interval: drop the padding bits, find the
  // marker (skipping anything before it, as libjpeg does) and go past it
  void restart(int expected) {
    buf = 0;
    nbits = 0;
    if (marker < 0) {
      while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0 && p[1] != 0xFF)) ++p;
      if (p + 1 >= end) malformed("missing restart marker");
      marker = p[1];
      p += 2;
    }
    if (marker != 0xD0 + expected) malformed("restart marker out of order");
    marker = -1;
  }
};

inline int extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? static_cast<int>(v) - (1 << s) + 1 : static_cast<int>(v);
}

// ---------------------------------------------------------------------------
// jdarith.c's arithmetic decoder

// jaricom.c jpeg_aritab, the JPEG spec's Table D.2: Qe, Next_Index_LPS,
// Next_Index_MPS and Switch_MPS of each probability state; 113 is the
// fixed probability 0.5
struct QState {
  uint16_t qe;
  uint8_t lps, mps, sw;
};
const QState kAritab[114] = {
    {0x5a1d, 1, 1, 1}, {0x2586, 14, 2, 0}, {0x1114, 16, 3, 0}, {0x080b, 18, 4, 0},
    {0x03d8, 20, 5, 0}, {0x01da, 23, 6, 0}, {0x00e5, 25, 7, 0}, {0x006f, 28, 8, 0},
    {0x0036, 30, 9, 0}, {0x001a, 33, 10, 0}, {0x000d, 35, 11, 0}, {0x0006, 9, 12, 0},
    {0x0003, 10, 13, 0}, {0x0001, 12, 13, 0}, {0x5a7f, 15, 15, 1}, {0x3f25, 36, 16, 0},
    {0x2cf2, 38, 17, 0}, {0x207c, 39, 18, 0}, {0x17b9, 40, 19, 0}, {0x1182, 42, 20, 0},
    {0x0cef, 43, 21, 0}, {0x09a1, 45, 22, 0}, {0x072f, 46, 23, 0}, {0x055c, 48, 24, 0},
    {0x0406, 49, 25, 0}, {0x0303, 51, 26, 0}, {0x0240, 52, 27, 0}, {0x01b1, 54, 28, 0},
    {0x0144, 56, 29, 0}, {0x00f5, 57, 30, 0}, {0x00b7, 59, 31, 0}, {0x008a, 60, 32, 0},
    {0x0068, 62, 33, 0}, {0x004e, 63, 34, 0}, {0x003b, 32, 35, 0}, {0x002c, 33, 9, 0},
    {0x5ae1, 37, 37, 1}, {0x484c, 64, 38, 0}, {0x3a0d, 65, 39, 0}, {0x2ef1, 67, 40, 0},
    {0x261f, 68, 41, 0}, {0x1f33, 69, 42, 0}, {0x19a8, 70, 43, 0}, {0x1518, 72, 44, 0},
    {0x1177, 73, 45, 0}, {0x0e74, 74, 46, 0}, {0x0bfb, 75, 47, 0}, {0x09f8, 77, 48, 0},
    {0x0861, 78, 49, 0}, {0x0706, 79, 50, 0}, {0x05cd, 48, 51, 0}, {0x04de, 50, 52, 0},
    {0x040f, 50, 53, 0}, {0x0363, 51, 54, 0}, {0x02d4, 52, 55, 0}, {0x025c, 53, 56, 0},
    {0x01f8, 54, 57, 0}, {0x01a4, 55, 58, 0}, {0x0160, 56, 59, 0}, {0x0125, 57, 60, 0},
    {0x00f6, 58, 61, 0}, {0x00cb, 59, 62, 0}, {0x00ab, 61, 63, 0}, {0x008f, 61, 32, 0},
    {0x5b12, 65, 65, 1}, {0x4d04, 80, 66, 0}, {0x412c, 81, 67, 0}, {0x37d8, 82, 68, 0},
    {0x2fe8, 83, 69, 0}, {0x293c, 84, 70, 0}, {0x2379, 86, 71, 0}, {0x1edf, 87, 72, 0},
    {0x1aa9, 87, 73, 0}, {0x174e, 72, 74, 0}, {0x1424, 72, 75, 0}, {0x119c, 74, 76, 0},
    {0x0f6b, 74, 77, 0}, {0x0d51, 75, 78, 0}, {0x0bb6, 77, 79, 0}, {0x0a40, 77, 48, 0},
    {0x5832, 80, 81, 1}, {0x4d1c, 88, 82, 0}, {0x438e, 89, 83, 0}, {0x3bdd, 90, 84, 0},
    {0x34ee, 91, 85, 0}, {0x2eae, 92, 86, 0}, {0x299a, 93, 87, 0}, {0x2516, 86, 71, 0},
    {0x5570, 88, 89, 1}, {0x4ca9, 95, 90, 0}, {0x44d9, 96, 91, 0}, {0x3e22, 97, 92, 0},
    {0x3824, 99, 93, 0}, {0x32b4, 99, 94, 0}, {0x2e17, 93, 86, 0}, {0x56a8, 95, 96, 1},
    {0x4f46, 101, 97, 0}, {0x47e5, 102, 98, 0}, {0x41cf, 103, 99, 0}, {0x3c3d, 104, 100, 0},
    {0x375e, 99, 93, 0}, {0x5231, 105, 102, 0}, {0x4c0f, 106, 103, 0}, {0x4639, 107, 104, 0},
    {0x415e, 103, 99, 0}, {0x5627, 105, 106, 1}, {0x50e7, 108, 107, 0}, {0x4b85, 109, 103, 0},
    {0x5597, 110, 109, 0}, {0x504f, 111, 107, 0}, {0x5a10, 110, 111, 1}, {0x5522, 112, 109, 0},
    {0x59eb, 112, 111, 1}, {0x5a1d, 113, 113, 0},
};

struct ArithDecoder {
  const uint8_t* p;
  const uint8_t* end;
  int marker = 0;       // libjpeg's unread_marker: zeros are fed after it
  int64_t c = 0;        // C register: base of the interval and the bit buffer
  int64_t a = 0;        // A register: the interval's size, normalized
  int ct = -16;         // bits left in C's buffer part; -16 at a start, -1 after corrupt data
  int next_restart = 0;

  // jdarith.c get_byte with the handling of 0xFF around it
  int byte() {
    if (marker) return 0;
    if (p >= end) {
      marker = 0xD9;
      return 0;
    }
    int b = *p++;
    if (b != 0xFF) return b;
    while (p < end && *p == 0xFF) ++p;
    int next = p < end ? *p++ : 0xD9;
    if (next == 0) return 0xFF;
    marker = next;
    return 0;
  }

  // jdarith.c arith_decode: one binary decision on the statistics bin *st
  // (its state index, the MPS sense in bit 7)
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;   // two initial bytes read
      }
      a <<= 1;
    }
    int sv = *st;
    const QState& q = kAritab[sv & 0x7F];
    int64_t qe = q.qe;
    int nl = (q.sw << 7) | q.lps, nm = q.mps;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {                    // conditional LPS exchange
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {           // conditional MPS exchange
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // jdmarker.c read_restart_marker (the next marker, bytes before it
  // skipped as next_marker does, must be the expected RSTn), then the
  // registers of process_restart
  void restart() {
    if (!marker) {
      while (true) {
        while (p < end && *p != 0xFF) ++p;
        while (p < end && *p == 0xFF) ++p;
        if (p >= end) malformed("missing restart marker");
        int m = *p++;
        if (m != 0) {
          marker = m;
          break;
        }
      }
    }
    if (marker != 0xD0 + next_restart) malformed("restart marker out of order");
    marker = 0;
    next_restart = (next_restart + 1) & 7;
    c = a = 0;
    ct = -16;
  }
};

// ---------------------------------------------------------------------------
// jidctint.c's ISLOW IDCT, in the arrangement of libjpeg-turbo's x86-64
// SIMD version (jidctint-avx2.asm), the IDCT PIL runs: the products
// distributed so that no sum is formed before a multiply, the dequantized
// coefficients and in0 +- in4, in7 + in3 and in5 + in1 in 16 bits, each
// pass's output saturated to 16 bits (the last then to -128..127), and a
// block whose coefficient rows 1-7 are all zero taking pass 1's shortcut
// (the DC row shifted left by 2, in 16 bits).  For the coefficients an
// encoder writes that is jidctint.c's result; for corrupt data, PIL's.

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }
inline int64_t wrap16(int64_t x) { return static_cast<int16_t>(static_cast<uint16_t>(x)); }
inline int16_t sat16(int64_t x) {
  return static_cast<int16_t>(x < -32768 ? -32768 : x > 32767 ? 32767 : x);
}

// the 1-D butterfly: the eight inputs, out the eight sums before the
// final descale
inline void idct_1d(int64_t i0, int64_t i1, int64_t i2, int64_t i3, int64_t i4, int64_t i5,
                    int64_t i6, int64_t i7, int64_t out[8]) {
  int64_t tmp2 = i2 * FIX_0_541196100 + i6 * (FIX_0_541196100 - FIX_1_847759065);
  int64_t tmp3 = i2 * (FIX_0_541196100 + FIX_0_765366865) + i6 * FIX_0_541196100;
  int64_t tmp0 = wrap16(i0 + i4) * (int64_t{1} << kConstBits);
  int64_t tmp1 = wrap16(i0 - i4) * (int64_t{1} << kConstBits);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

  int64_t z3 = wrap16(i7 + i3), z4 = wrap16(i5 + i1);
  int64_t z3m = z3 * (FIX_1_175875602 - FIX_1_961570560) + z4 * FIX_1_175875602;
  int64_t z4m = z3 * FIX_1_175875602 + z4 * (FIX_1_175875602 - FIX_0_390180644);
  int64_t a0 = i7 * (FIX_0_298631336 - FIX_0_899976223) + i1 * -FIX_0_899976223 + z3m;
  int64_t a3 = i7 * -FIX_0_899976223 + i1 * (FIX_1_501321110 - FIX_0_899976223) + z4m;
  int64_t a1 = i5 * (FIX_2_053119869 - FIX_2_562915447) + i3 * -FIX_2_562915447 + z4m;
  int64_t a2 = i5 * -FIX_2_562915447 + i3 * (FIX_3_072711026 - FIX_2_562915447) + z3m;

  out[0] = tmp10 + a3;
  out[7] = tmp10 - a3;
  out[1] = tmp11 + a2;
  out[6] = tmp11 - a2;
  out[2] = tmp12 + a1;
  out[5] = tmp12 - a1;
  out[3] = tmp13 + a0;
  out[4] = tmp13 - a0;
}

// coef in natural order, quant in natural order; 8x8 samples to dst
void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* dst, int stride) {
  int16_t ws[64];
  int64_t o[8];
  bool flat = true;   // rows 1-7 all zero
  for (int k = 8; k < 64 && flat; ++k) flat = coef[k] == 0;
  for (int c = 0; c < 8; ++c) {
    int64_t in[8];
    for (int r = 0; r < 8; ++r) in[r] = wrap16(static_cast<int64_t>(coef[r * 8 + c]) * quant[r * 8 + c]);
    if (flat) {
      int16_t dc = static_cast<int16_t>(wrap16(in[0] * 4));
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    idct_1d(in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], o);
    for (int r = 0; r < 8; ++r) ws[r * 8 + c] = sat16(descale(o[r], kConstBits - kPass1Bits));
  }
  for (int r = 0; r < 8; ++r) {
    const int16_t* w = ws + r * 8;
    idct_1d(w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], o);
    uint8_t* out = dst + r * stride;
    for (int c = 0; c < 8; ++c) {
      int v = sat16(descale(o[c], kConstBits + kPass1Bits + 3));
      out[c] = static_cast<uint8_t>((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
    }
  }
}

// ---------------------------------------------------------------------------

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;          // entropy tables of the current scan
  int bw = 0, bh = 0;          // blocks (lossless: samples) per line and column of the buffer
  int ew = 0, eh = 0;          // blocks (samples) of the component's own extent
  std::vector<int16_t> coef;   // bh x bw blocks of 64 coefficients, natural order
  uint16_t quant[64] = {};     // latched at the component's first scan, as libjpeg does
  bool latched = false;
  int coef_bits[64] = {};      // progressive: Al of the last scan that sent each coefficient
  std::vector<uint8_t> plane;  // samples after the IDCT (lossless: as decoded), `stride` apart
  int stride = 0;
  // lossless: the differences of the current iMCU row, the row above, and
  // whether the next row is a first row (jdlossls.c's first-row undifferencer)
  std::vector<int> diff;
  std::vector<int> undiff;
  bool first_row = true;
};

enum ColorSpace { kGrey, kYCbCr, kRGB, kCMYK, kYCCK };

struct Header {
  int width = 0, height = 0;
  int sof = 0;
  bool progressive = false, arith = false, lossless = false;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  uint16_t quant[4][64];
  bool quant_set[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  uint8_t dac_l[16], dac_u[16], dac_k[16];   // arithmetic conditioning (jdmarker.c get_dac)
  uint8_t dc_stats[16][64], ac_stats[16][256];
  bool jfif = false;
  bool adobe = false;
  int adobe_transform = 0;
  ColorSpace space = kGrey;
  int scans = 0;
  Header() {
    // jdmarker.c get_soi's defaults
    std::fill(dac_l, dac_l + 16, 0);
    std::fill(dac_u, dac_u + 16, 1);
    std::fill(dac_k, dac_k + 16, 5);
  }
};

inline uint16_t be16(const uint8_t* p) { return static_cast<uint16_t>((p[0] << 8) | p[1]); }

const char* refused_sof(int m) {
  switch (m) {
    case 0xC5: case 0xC6: case 0xC7: return "hierarchical (differential) JPEG";
    case 0xC8: return "JPEG of the reserved JPG process";
    case 0xCB: return "arithmetic-coded lossless JPEG";
    case 0xCD: case 0xCE: case 0xCF: return "hierarchical (differential) arithmetic-coded JPEG";
    default: return nullptr;
  }
}

std::string sampling(const Header& hd) {
  std::string s;
  for (const auto& c : hd.comps)
    s += (s.empty() ? "" : ",") + std::to_string(c.h) + "x" + std::to_string(c.v);
  return s;
}

// jdmarker.c get_sof and jdinput.c initial_setup: size, components, and
// the coefficient (lossless: sample) buffers
void read_frame(Header& hd, int m, const uint8_t* s, size_t sl, bool size_only) {
  if (hd.sof) malformed("a second frame header");
  if (sl < 6) malformed("short frame header");
  if (s[0] != 8)
    unsupported(std::to_string(s[0]) + "-bit JPEG samples (PIL reads 8-bit JPEGs only)");
  hd.sof = m;
  hd.progressive = m == 0xC2 || m == 0xCA;
  hd.arith = m == 0xC9 || m == 0xCA;
  hd.lossless = m == 0xC3;
  hd.height = be16(s + 1);
  hd.width = be16(s + 3);
  int nf = s[5];
  if (hd.height == 0 || hd.width == 0)
    unsupported("JPEG with its height in a DNL marker, or of zero size");
  // PIL refuses an image of more than 2 * Image.MAX_IMAGE_PIXELS
  if (static_cast<int64_t>(hd.width) * hd.height > kMaxPixels)
    malformed("image of more pixels than PIL opens");
  if (nf != 1 && nf != 3 && nf != 4)
    unsupported(std::to_string(nf) + "-component JPEG (PIL reads 1, 3 and 4 components)");
  if (sl < 6 + 3 * static_cast<size_t>(nf)) malformed("short frame header");
  hd.comps.clear();
  for (int c = 0; c < nf; ++c) {
    Component comp;
    comp.id = s[6 + 3 * c];
    comp.h = s[7 + 3 * c] >> 4;
    comp.v = s[7 + 3 * c] & 15;
    comp.tq = s[8 + 3 * c];
    if (comp.h < 1 || comp.h > 4 || comp.v < 1 || comp.v > 4 || comp.tq > 3)
      malformed("bad component in the frame header");
    hd.comps.push_back(comp);
  }
  if (size_only) return;
  for (const auto& c : hd.comps) {
    hd.hmax = std::max(hd.hmax, c.h);
    hd.vmax = std::max(hd.vmax, c.v);
  }
  // an iMCU row is 8 sample rows of the largest factor (1 row when lossless)
  int unit = hd.lossless ? 1 : 8;
  hd.mcux = (hd.width + unit * hd.hmax - 1) / (unit * hd.hmax);
  hd.mcuy = (hd.height + unit * hd.vmax - 1) / (unit * hd.vmax);
  for (auto& c : hd.comps) {
    c.bw = hd.mcux * c.h;
    c.bh = hd.mcuy * c.v;
    // jdinput.c: ceil(ceil(width * h / hmax) / 8) blocks
    c.ew = static_cast<int>((int64_t{hd.width} * c.h + unit * hd.hmax - 1) / (unit * hd.hmax));
    c.eh = static_cast<int>((int64_t{hd.height} * c.v + unit * hd.vmax - 1) / (unit * hd.vmax));
    if (hd.lossless) {
      c.stride = c.bw;
      c.plane.assign(static_cast<size_t>(c.bw) * c.bh, 0);
      c.diff.assign(static_cast<size_t>(c.bw) * c.v, 0);
      c.undiff.assign(c.ew, 0);
    } else {
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    }
    std::fill(c.coef_bits, c.coef_bits + 64, -1);
  }
}

// jdapimin.c default_decompress_parms, then what jdmaster.c refuses: a
// fractional upsampling ratio (jdsample.c jinit_upsampler) and, in a
// lossless file, any colour conversion (PIL asks for RGB, CMYK or grey)
void check_layout(Header& hd) {
  auto& cs = hd.comps;
  if (cs.size() == 1) {
    hd.space = kGrey;
  } else if (cs.size() == 4) {
    hd.space = hd.adobe && hd.adobe_transform != 0 ? kYCCK : kCMYK;
  } else if (hd.jfif) {
    hd.space = kYCbCr;
  } else if (hd.adobe) {
    hd.space = hd.adobe_transform == 0 ? kRGB : kYCbCr;
  } else if (cs[0].id == 'R' && cs[1].id == 'G' && cs[2].id == 'B') {
    hd.space = kRGB;
  } else {   // ids 1, 2, 3 or unknown: YCbCr, but RGB in a lossless file
    hd.space = hd.lossless ? kRGB : kYCbCr;
  }
  if (hd.lossless && (hd.space == kYCbCr || hd.space == kYCCK))
    unsupported(std::string("lossless JPEG in ") +
                        (hd.space == kYCbCr ? "YCbCr" : "YCCK") +
                        " (libjpeg-turbo converts no colour in lossless mode)");
  for (const auto& c : cs)
    if (hd.hmax % c.h || hd.vmax % c.v)
      unsupported("JPEG sampling layout " + sampling(hd) +
                          " (a fractional upsampling ratio)");
}

struct Scan {
  int ns = 0;
  Component* comps[4];
  int ss = 0, se = 63, ah = 0, al = 0;
};

// jdmarker.c get_sos, and the checks of each entropy decoder's start_pass
// (jdhuff.c, jdphuff.c, jdarith.c, jdlhuff.c / jdlossls.c)
Scan read_scan(Header& hd, const uint8_t* s, size_t sl) {
  if (sl < 1) malformed("short scan header");
  Scan sc;
  sc.ns = s[0];
  if (sc.ns < 1 || sc.ns > 4) malformed("bad component count in the scan header");
  if (sl < 1 + 2 * static_cast<size_t>(sc.ns) + 3) malformed("short scan header");
  int nf = static_cast<int>(hd.comps.size());
  for (int i = 0; i < sc.ns; ++i) {
    int id = s[1 + 2 * i];
    // the first frame component of this id whose own index is not a scan
    // position filled already (libjpeg-turbo's guard against repeated
    // ids), among the first four
    Component* comp = nullptr;
    bool known = false;
    for (int ci = 0; ci < nf && ci < 4; ++ci) {
      if (hd.comps[ci].id != id) continue;
      known = true;
      if (ci >= i) {
        comp = &hd.comps[ci];
        break;
      }
    }
    if (comp == nullptr) {
      if (known)
        unsupported("JPEG scan naming a component after the scan position of its own "
                            "frame index is taken (libjpeg-turbo's get_sos looks it up there)");
      malformed("scan names an unknown component");
    }
    sc.comps[i] = comp;
    comp->td = s[2 + 2 * i] >> 4;
    comp->ta = s[2 + 2 * i] & 15;
  }
  const uint8_t* t = s + 1 + 2 * sc.ns;
  sc.ss = t[0];
  sc.se = t[1];
  sc.ah = t[2] >> 4;
  sc.al = t[2] & 15;
  if (hd.lossless) {   // jdlossls.c start_pass_lossless
    if (sc.ss < 1 || sc.ss > 7 || sc.se != 0 || sc.ah != 0 || sc.al >= 8)
      malformed("bad lossless scan parameters");
  } else if (hd.progressive) {
    bool dc = sc.ss == 0;
    bool bad = dc ? sc.se != 0 : (sc.ss > sc.se || sc.se > 63 || sc.ns != 1);
    if (sc.ah != 0 && sc.al != sc.ah - 1) bad = true;
    if (sc.al > 13) bad = true;
    if (bad) malformed("bad progressive scan parameters");
  }
  // a sequential scan's Ss, Se, Ah and Al are not checked (a warning only)
  for (int c = 0; c < sc.ns; ++c) {
    Component& comp = *sc.comps[c];
    if (!hd.lossless && !comp.latched) {
      if (!hd.quant_set[comp.tq]) malformed("missing quantization table");
      std::memcpy(comp.quant, hd.quant[comp.tq], sizeof comp.quant);
      comp.latched = true;
    }
    bool needs_dc = !hd.progressive || (sc.ss == 0 && sc.ah == 0);
    bool needs_ac = !hd.lossless && (!hd.progressive || sc.ss > 0);
    if (hd.arith) {
      if (comp.td > 15 || comp.ta > 15) malformed("bad arithmetic table id in the scan");
    } else {
      if ((needs_dc && (comp.td > 3 || !hd.dc[comp.td].present)) ||
          (needs_ac && (comp.ta > 3 || !hd.ac[comp.ta].present)))
        malformed("missing Huffman table");
      if (needs_dc)   // jdhuff.c's jpeg_make_d_derived_tbl
        for (int k = 0; k < hd.dc[comp.td].nvals; ++k)
          if (hd.dc[comp.td].vals[k] > (hd.lossless ? 16 : 15)) malformed("bad DC Huffman table");
    }
    if (hd.progressive)
      for (int k = sc.ss; k <= sc.se; ++k) comp.coef_bits[k] = sc.al;
  }
  return sc;
}

inline int16_t jcoef(int v) { return static_cast<int16_t>(v); }   // a JCOEF, 16 bits

// Every MCU of a scan in order: `mcu(m)` at its start (restarts), then
// `block(pos, c, blk)` for each of its blocks, pos the block's component's
// place in the scan.  A scan of one component walks its own extent, one
// block per MCU (non-interleaved).
template <typename Mcu, typename Block>
void walk_scan(Header& hd, const Scan& sc, Mcu&& mcu, Block&& block) {
  bool single = sc.ns == 1;
  int mcux = single ? sc.comps[0]->ew : hd.mcux;
  int mcuy = single ? sc.comps[0]->eh : hd.mcuy;
  long total = static_cast<long>(mcux) * mcuy;
  for (long m = 0; m < total; ++m) {
    if (!mcu(m)) continue;
    int my = static_cast<int>(m / mcux), mx = static_cast<int>(m % mcux);
    if (single) {
      Component& c = *sc.comps[0];
      block(0, c, c.coef.data() + (static_cast<size_t>(my) * c.bw + mx) * 64);
      continue;
    }
    for (int ci = 0; ci < sc.ns; ++ci) {
      Component& c = *sc.comps[ci];
      for (int v = 0; v < c.v; ++v)
        for (int h = 0; h < c.h; ++h)
          block(ci, c, c.coef.data() +
                           (static_cast<size_t>(my * c.v + v) * c.bw + mx * c.h + h) * 64);
    }
  }
}

inline int dc_diff(BitReader& br, const Huffman& t) {
  int s = br.decode(t);
  return s ? extend(br.bits(s), s) : 0;
}

inline void add_dc(int& pred, int diff) {
  // jdhuff.c refuses a DC predictor that overflows an int
  if ((pred >= 0 && diff > INT_MAX - pred) || (pred < 0 && diff < INT_MIN - pred))
    malformed("DC coefficient out of range");
  pred += diff;
}

// jdhuff.c (sequential) and jdphuff.c (progressive) into the coefficient
// buffers
void decode_huffman_scan(const uint8_t* d, size_t n, size_t start, Header& hd, const Scan& sc) {
  BitReader br{d + start, d + n};
  int eobrun = 0, restarts = 0;
  int pred[4] = {0, 0, 0, 0};   // DC predictions, one per scan position
  auto mcu = [&](long m) {
    if (hd.restart_interval && m > 0 && m % hd.restart_interval == 0) {
      br.restart(restarts & 7);
      ++restarts;
      std::fill(pred, pred + 4, 0);
      eobrun = 0;
    }
    return true;
  };
  const int ss = sc.ss, se = sc.se, al = sc.al;
  if (!hd.progressive) {
    walk_scan(hd, sc, mcu, [&](int pos, Component& c, int16_t* blk) {
      add_dc(pred[pos], dc_diff(br, hd.dc[c.td]));
      blk[0] = jcoef(pred[pos]);
      const Huffman& act = hd.ac[c.ta];
      for (int k = 1; k < 64; ++k) {
        int rs = br.decode(act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = jcoef(extend(br.bits(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    });
  } else if (ss == 0 && sc.ah == 0) {             // DC first
    walk_scan(hd, sc, mcu, [&](int pos, Component& c, int16_t* blk) {
      add_dc(pred[pos], dc_diff(br, hd.dc[c.td]));
      blk[0] = jcoef(static_cast<int>(static_cast<unsigned>(pred[pos]) << al));
    });
  } else if (ss == 0) {                            // DC refinement
    walk_scan(hd, sc, mcu, [&](int, Component&, int16_t* blk) {
      if (br.bits(1)) blk[0] = jcoef(blk[0] | (1 << al));
    });
  } else if (sc.ah == 0) {                         // AC first
    walk_scan(hd, sc, mcu, [&](int, Component& c, int16_t* blk) {
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      const Huffman& act = hd.ac[c.ta];
      for (int k = ss; k <= se; ++k) {
        int rs = br.decode(act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          unsigned v = static_cast<unsigned>(extend(br.bits(s), s));
          blk[kNatural[k]] = jcoef(static_cast<int>(v << al));
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += static_cast<int>(br.bits(r));
          --eobrun;
          break;
        }
      }
    });
  } else {                                         // AC refinement
    const int p1 = 1 << al, m1 = -(1 << al);
    walk_scan(hd, sc, mcu, [&](int, Component& c, int16_t* blk) {
      const Huffman& act = hd.ac[c.ta];
      auto correct = [&](int16_t& coef) {
        if (br.bits(1) && (coef & p1) == 0) coef = jcoef(coef + (coef >= 0 ? p1 : m1));
      };
      int k = ss;
      if (eobrun == 0) {
        for (; k <= se; ++k) {
          int rs = br.decode(act);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            s = br.bits(1) ? p1 : m1;   // a newly nonzero coefficient is +-1 at this bit
          } else if (r != 15) {
            eobrun = 1 << r;
            if (r) eobrun += static_cast<int>(br.bits(r));
            break;
          }
          // pass r zero coefficients, correcting the nonzero ones on the way
          do {
            int16_t& coef = blk[kNatural[k]];
            if (coef != 0) {
              correct(coef);
            } else if (--r < 0) {
              break;
            }
            ++k;
          } while (k <= se);
          if (s) blk[kNatural[k]] = jcoef(s);
        }
      }
      if (eobrun > 0) {
        for (; k <= se; ++k) {
          int16_t& coef = blk[kNatural[k]];
          if (coef != 0) correct(coef);
        }
        --eobrun;
      }
    });
  }
}

// jdarith.c (decode_mcu, decode_mcu_DC_first, _AC_first, _DC_refine,
// _AC_refine) into the coefficient buffers.  A spectral or magnitude
// overflow (JWRN_ARITH_BAD_CODE) sets ct to -1, and the MCUs after it
// decode nothing until the next restart.
void decode_arith_scan(const uint8_t* d, size_t n, size_t start, Header& hd, const Scan& sc) {
  ArithDecoder ar{d + start, d + n};
  const int ss = sc.ss, se = sc.se, ah = sc.ah, al = sc.al;
  const bool uses_dc = !hd.progressive || (ss == 0 && ah == 0);
  const bool uses_ac = !hd.progressive || ss > 0;
  int last_dc[4] = {0, 0, 0, 0}, context[4] = {0, 0, 0, 0};
  uint8_t fixed_bin = 113;   // probability 0.5, never adapted
  auto reset_statistics = [&]() {
    for (int pos = 0; pos < sc.ns; ++pos) {
      const Component& c = *sc.comps[pos];
      if (uses_dc) {
        std::memset(hd.dc_stats[c.td], 0, 64);
        last_dc[pos] = context[pos] = 0;
      }
      if (uses_ac) std::memset(hd.ac_stats[c.ta], 0, 256);
    }
  };
  // Figures F.19-F.24: the DC difference into last_dc; false after a
  // magnitude overflow
  auto dc_value = [&](int pos, const Component& c) {
    int tbl = c.td;
    uint8_t* st = hd.dc_stats[tbl] + context[pos];
    if (ar.decode(st) == 0) {
      context[pos] = 0;
      return true;
    }
    int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m) {
      st = hd.dc_stats[tbl] + 20;   // Table F.4: X1 = 20
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    if (m < static_cast<int>((1L << hd.dac_l[tbl]) >> 1))       // F.1.4.4.1.2
      context[pos] = 0;
    else if (m > static_cast<int>((1L << hd.dac_u[tbl]) >> 1))
      context[pos] = 12 + sign * 4;
    else
      context[pos] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    last_dc[pos] = (last_dc[pos] + v) & 0xffff;
    return true;
  };
  // Figure F.20 over coefficients lo..hi, each shifted by `shift`; false
  // after a spectral or magnitude overflow
  auto ac_values = [&](const Component& c, int16_t* blk, int lo, int hi, int shift) {
    int tbl = c.ta;
    for (int k = lo; k <= hi; ++k) {
      uint8_t* st = hd.ac_stats[tbl] + 3 * (k - 1);
      if (ar.decode(st)) break;   // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > hi) return false;
      }
      int sign = ar.decode(&fixed_bin);
      st += 2;
      int m = ar.decode(st);
      if (m && ar.decode(st)) {
        m <<= 1;
        st = hd.ac_stats[tbl] + (k <= hd.dac_k[tbl] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) return false;
          st += 1;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = jcoef(static_cast<int>(static_cast<unsigned>(v) << shift));
    }
    return true;
  };
  auto ac_refine = [&](const Component& c, int16_t* blk) {
    int tbl = c.ta;
    const int p1 = 1 << al, m1 = -(1 << al);
    int kex = se;   // the previous stage's end of block
    while (kex > 0 && !blk[kNatural[kex]]) --kex;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = hd.ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;   // EOB
      while (true) {
        int16_t& coef = blk[kNatural[k]];
        if (coef) {   // previously nonzero: a correction bit
          if (ar.decode(st + 2)) coef = jcoef(coef + (coef < 0 ? m1 : p1));
          break;
        }
        if (ar.decode(st + 1)) {   // newly nonzero
          coef = jcoef(ar.decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) return false;
      }
    }
    return true;
  };
  reset_statistics();
  int to_go = hd.restart_interval;
  auto mcu = [&](long) {
    if (hd.restart_interval) {
      if (to_go == 0) {   // jdarith.c process_restart
        ar.restart();
        reset_statistics();
        to_go = hd.restart_interval;
      }
      --to_go;
    }
    return ar.ct != -1;   // after corrupt data: nothing
  };
  walk_scan(hd, sc, mcu, [&](int pos, Component& c, int16_t* blk) {
    if (ar.ct == -1) return;
    bool ok = true;
    if (!hd.progressive) {
      ok = dc_value(pos, c);
      if (ok) {
        blk[0] = jcoef(last_dc[pos]);
        ok = ac_values(c, blk, 1, 63, 0);
      }
    } else if (ss == 0 && ah == 0) {
      ok = dc_value(pos, c);
      if (ok) blk[0] = jcoef(static_cast<int>(static_cast<unsigned>(last_dc[pos]) << al));
    } else if (ss == 0) {
      if (ar.decode(&fixed_bin)) blk[0] = jcoef(blk[0] | (1 << al));
    } else if (ah == 0) {
      ok = ac_values(c, blk, ss, se, al);
    } else {
      ok = ac_refine(c, blk);
    }
    if (!ok) ar.ct = -1;
  });
}

// jdlossls.c: one row of samples (mod 2^16) from its differences, by the
// first-row undifferencer (`initial`, then predictor 1) or by predictor
// psv, the first column by predictor 2 (the sample above)
void undifference(const int* diff, std::vector<int>& row, int n, int psv, bool first,
                  int initial) {
  if (first) {
    int ra = (diff[0] + initial) & 0xFFFF;
    row[0] = ra;
    for (int x = 1; x < n; ++x) row[x] = ra = (diff[x] + ra) & 0xFFFF;
    return;
  }
  int64_t rb = row[0];
  int64_t ra = (diff[0] + rb) & 0xFFFF;
  row[0] = static_cast<int>(ra);
  for (int x = 1; x < n; ++x) {
    int64_t rc = rb;
    rb = row[x];   // still the row above here
    int64_t pred;
    switch (psv) {
      case 1: pred = ra; break;
      case 2: pred = rb; break;
      case 3: pred = rc; break;
      case 4: pred = ra + rb - rc; break;
      case 5: pred = ra + ((rb - rc) >> 1); break;
      case 6: pred = rb + ((ra - rc) >> 1); break;
      default: pred = (ra + rb) >> 1; break;
    }
    ra = (diff[x] + pred) & 0xFFFF;
    row[x] = static_cast<int>(ra);
  }
}

// One lossless scan: jddiffct.c decompress_data per iMCU row (the
// difference rows of each MCU row from jdlhuff.c decode_mcus, restart
// intervals counted in MCU rows), then jdlossls.c's undifferencing and
// point transform of each component row into its samples
void decode_lossless_scan(const uint8_t* d, size_t n, size_t start, Header& hd, const Scan& sc) {
  BitReader br{d + start, d + n};
  const bool single = sc.ns == 1;
  const int mcux = single ? sc.comps[0]->ew : hd.mcux;
  const int ri = hd.restart_interval;
  if (ri % mcux) malformed("lossless restart interval not a whole number of MCU rows");
  const int psv = sc.ss, pt = sc.al, initial = 1 << (8 - pt - 1);
  for (auto& c : hd.comps) c.first_row = true;   // jdlossls.c start_pass_lossless
  int rows_to_go = ri / mcux, restarts = 0;
  const int t = hd.mcuy;
  for (int imcu = 0; imcu < t; ++imcu) {
    int n_rows = 1;
    if (single) {
      const Component& c = *sc.comps[0];
      n_rows = imcu < t - 1 ? c.v : (c.eh % c.v ? c.eh % c.v : c.v);
    }
    for (int y = 0; y < n_rows; ++y) {
      if (ri) {
        if (rows_to_go == 0) {   // jddiffct.c process_restart
          br.restart(restarts & 7);
          ++restarts;
          for (auto& c : hd.comps) c.first_row = true;
          rows_to_go = ri / mcux;
        }
      }
      for (int mx = 0; mx < mcux; ++mx) {   // jdlhuff.c decode_mcus
        auto one = [&](Component& c, int row, int x) {
          int s = br.decode(hd.dc[c.td]);
          int v = 0;
          if (s == 16)
            v = 32768;
          else if (s)
            v = extend(br.bits(s), s);
          c.diff[static_cast<size_t>(row) * c.bw + x] = v;
        };
        if (single) {
          one(*sc.comps[0], y, mx);
          continue;
        }
        for (int ci = 0; ci < sc.ns; ++ci) {
          Component& c = *sc.comps[ci];
          for (int v = 0; v < c.v; ++v)
            for (int h = 0; h < c.h; ++h) one(c, v, mx * c.h + h);
        }
      }
      if (ri) --rows_to_go;
    }
    for (int ci = 0; ci < sc.ns; ++ci) {   // undifference the iMCU row
      Component& c = *sc.comps[ci];
      int rows = imcu < t - 1 ? c.v : (c.eh % c.v ? c.eh % c.v : c.v);
      for (int y = 0; y < rows; ++y) {
        int r = imcu * c.v + y;
        undifference(c.diff.data() + static_cast<size_t>(y) * c.bw, c.undiff, c.ew, psv,
                     c.first_row, initial);
        c.first_row = false;
        uint8_t* out = c.plane.data() + static_cast<size_t>(r) * c.stride;
        for (int x = 0; x < c.ew; ++x) out[x] = static_cast<uint8_t>(c.undiff[x] << pt);
      }
    }
  }
}

// the offset of the marker that ends the entropy-coded data from `i`
size_t scan_end(const uint8_t* d, size_t n, size_t i) {
  while (i + 1 < n) {
    if (d[i] == 0xFF && d[i + 1] != 0 && d[i + 1] != 0xFF && (d[i + 1] < 0xD0 || d[i + 1] > 0xD7))
      return i;
    ++i;
  }
  return n;
}

// Walks the markers to EOI (or to the frame header's size only),
// decoding every scan into the coefficient buffers as it comes.
void parse(const uint8_t* d, size_t n, Header& hd, bool size_only) {
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) malformed("not a JPEG (no SOI marker)");
  size_t i = 2;
  while (true) {
    while (i < n && d[i] != 0xFF) ++i;   // tolerate bytes between segments
    while (i < n && d[i] == 0xFF) ++i;
    if (i >= n) {
      if (hd.scans) return;               // no EOI after the last scan
      malformed("truncated JPEG: no scan");
    }
    int m = d[i++];
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    if (m == 0xD9) {
      if (hd.scans) return;
      malformed("truncated JPEG: EOI before the scan");
    }
    if (i + 2 > n) malformed("truncated JPEG segment");
    size_t len = be16(d + i);
    if (len < 2 || i + len > n) malformed("truncated JPEG segment");
    const uint8_t* s = d + i + 2;
    size_t sl = len - 2;
    if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 || m == 0xCA) {
      read_frame(hd, m, s, sl, size_only);
      if (size_only) return;
    } else if (const char* what = refused_sof(m)) {
      unsupported(what);
    } else if (m == 0xC4) {
      size_t k = 0;
      while (k < sl) {
        if (k + 17 > sl) malformed("short Huffman table");
        int tc = s[k] >> 4, th = s[k] & 15;
        if (tc > 1 || th > 3) malformed("bad Huffman table id");
        int total = 0;
        for (int j = 0; j < 16; ++j) total += s[k + 1 + j];
        if (total > 256 || k + 17 + total > sl) malformed("short Huffman table");
        build_huffman(tc == 0 ? hd.dc[th] : hd.ac[th], s + k + 1, s + k + 17, total);
        k += 17 + total;
      }
    } else if (m == 0xCC) {   // jdmarker.c get_dac
      if (sl % 2) malformed("bad DAC marker length");
      for (size_t k = 0; k < sl; k += 2) {
        int index = s[k], val = s[k + 1];
        if (index >= 32) malformed("bad DAC table index");
        if (index >= 16) {
          hd.dac_k[index - 16] = static_cast<uint8_t>(val);
        } else {
          hd.dac_l[index] = static_cast<uint8_t>(val & 15);
          hd.dac_u[index] = static_cast<uint8_t>(val >> 4);
          if ((val & 15) > (val >> 4)) malformed("bad DAC value");
        }
      }
    } else if (m == 0xDB) {
      size_t k = 0;
      while (k < sl) {
        int pq = s[k] >> 4, tq = s[k] & 15;
        if (tq > 3 || pq > 1) malformed("bad quantization table id");
        size_t need = 1 + 64 * (pq + 1);
        if (k + need > sl) malformed("short quantization table");
        for (int j = 0; j < 64; ++j)
          hd.quant[tq][kNatural[j]] = pq ? be16(s + k + 1 + 2 * j) : s[k + 1 + j];
        hd.quant_set[tq] = true;
        k += need;
      }
    } else if (m == 0xDD) {
      if (sl < 2) malformed("short restart interval");
      hd.restart_interval = be16(s);
    } else if (m == 0xE0 && !hd.scans) {
      // jdmarker.c's examine_app0 / examine_app14 read 14 and 12 bytes
      if (sl >= 14 && std::memcmp(s, "JFIF\0", 5) == 0) hd.jfif = true;
    } else if (m == 0xEE && !hd.scans) {
      if (sl >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
        hd.adobe = true;
        hd.adobe_transform = s[11];
      }
    } else if (m == 0xDA) {
      if (!hd.sof) malformed("scan before the frame header");
      if (!hd.scans) check_layout(hd);
      Scan sc = read_scan(hd, s, sl);
      if (hd.lossless)
        decode_lossless_scan(d, n, i + len, hd, sc);
      else if (hd.arith)
        decode_arith_scan(d, n, i + len, hd, sc);
      else
        decode_huffman_scan(d, n, i + len, hd, sc);
      ++hd.scans;
      if (!hd.progressive && sc.ns == static_cast<int>(hd.comps.size()))
        return;                           // one scan holds the whole image
      i = scan_end(d, n, i + len);
      continue;
    }
    i += len;
  }
}

// ---------------------------------------------------------------------------
// block smoothing (jdcoefct.c, libjpeg-turbo 2.1+) and the IDCT

// jdcoefct.c smoothing_ok: a progressive file whose components all have
// their DC and first nine AC quantizers nonzero, a DC sent, and some of
// AC01-AC30 (zigzag 1-9) still missing bits
bool smoothing_ok(const Header& hd) {
  if (!hd.progressive) return false;
  static const int kSaved[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};   // zigzag 0..9
  bool useful = false;
  for (const auto& c : hd.comps) {
    if (!c.latched) return false;
    for (int k : kSaved)
      if (c.quant[k] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    for (int k = 1; k < 10; ++k) useful = useful || c.coef_bits[k] != 0;
  }
  return useful;
}

// decompress_smooth_data's estimates: the weights of the 5x5 DC
// neighbourhood (rows top to bottom) behind each coefficient, by natural
// position; the first five when some of AC01-AC30 were sent, all ten (the
// DC too) when none was
struct Estimate {
  int zz, pos;
  int16_t w[5][5];
};
const Estimate kSmoothAC[5] = {
    {1, 1, {{0, 0, 0, 0, 0}, {0, 0, 0, 0, 0}, {-7, 50, 0, -50, 7}, {0, 0, 0, 0, 0},
            {0, 0, 0, 0, 0}}},
    {2, 8, {{0, 0, -7, 0, 0}, {0, 0, 50, 0, 0}, {0, 0, 0, 0, 0}, {0, 0, -50, 0, 0},
            {0, 0, 7, 0, 0}}},
    {3, 16, {{0, 0, -1, 0, 0}, {0, 0, 13, 0, 0}, {0, 0, -24, 0, 0}, {0, 0, 13, 0, 0},
             {0, 0, -1, 0, 0}}},
    {4, 9, {{0, -1, 0, 1, 0}, {-1, 10, 0, -10, 1}, {0, 0, 0, 0, 0}, {1, -10, 0, 10, -1},
            {0, 1, 0, -1, 0}}},
    {5, 2, {{0, 0, 0, 0, 0}, {0, 0, 0, 0, 0}, {-1, 13, -24, 13, -1}, {0, 0, 0, 0, 0},
            {0, 0, 0, 0, 0}}},
};
// the DC's weights sum to 256; it is listed apart below
const Estimate kSmoothDCOnly[9] = {
    {1, 1, {{-1, -1, 0, 1, 1}, {-3, 13, 0, -13, 3}, {-3, 38, 0, -38, 3}, {-3, 13, 0, -13, 3},
            {-1, -1, 0, 1, 1}}},
    {2, 8, {{-1, -3, -3, -3, -1}, {-1, 13, 38, 13, -1}, {0, 0, 0, 0, 0}, {1, -13, -38, -13, 1},
            {1, 3, 3, 3, 1}}},
    {3, 16, {{0, 0, 1, 0, 0}, {0, 2, 7, 2, 0}, {0, -5, -14, -5, 0}, {0, 2, 7, 2, 0},
             {0, 0, 1, 0, 0}}},
    {4, 9, {{-1, 0, 0, 0, 1}, {0, 9, 0, -9, 0}, {0, 0, 0, 0, 0}, {0, -9, 0, 9, 0},
            {1, 0, 0, 0, -1}}},
    {5, 2, {{0, 0, 0, 0, 0}, {0, 2, -5, 2, 0}, {1, 7, -14, 7, 1}, {0, 2, -5, 2, 0},
            {0, 0, 0, 0, 0}}},
    {6, 3, {{0, 0, 0, 0, 0}, {0, 1, 0, -1, 0}, {0, 2, 0, -2, 0}, {0, 1, 0, -1, 0},
            {0, 0, 0, 0, 0}}},
    {7, 10, {{0, 0, 0, 0, 0}, {0, 1, -3, 1, 0}, {0, 0, 0, 0, 0}, {0, -1, 3, -1, 0},
             {0, 0, 0, 0, 0}}},
    {8, 17, {{0, 0, 0, 0, 0}, {0, 1, 0, -1, 0}, {0, -3, 0, 3, 0}, {0, 1, 0, -1, 0},
             {0, 0, 0, 0, 0}}},
    {9, 24, {{0, 0, 0, 0, 0}, {0, 1, 2, 1, 0}, {0, 0, 0, 0, 0}, {0, -1, -2, -1, 0},
             {0, 0, 0, 0, 0}}},
};
const int16_t kSmoothDC[5][5] = {{-2, -6, -8, -6, -2}, {-6, 6, 42, 6, -6}, {-8, 42, 152, 42, -8},
                                {-6, 6, 42, 6, -6}, {-2, -6, -8, -6, -2}};

// an estimate from num, rounded, limited below the bits not yet sent (al
// > 0)
inline int predict(int64_t num, int64_t q, int al) {
  int64_t mag = ((q << 7) + (num >= 0 ? num : -num)) / (q << 8);
  if (al > 0 && mag >= (int64_t{1} << al)) mag = (int64_t{1} << al) - 1;
  return static_cast<int>(num >= 0 ? mag : -mag);
}

inline int64_t weigh(const int16_t w[5][5], const int dc[5][5]) {
  int64_t s = 0;
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 5; ++j) s += w[i][j] * dc[i][j];
  return s;
}

// The IDCT of every block of each component's extent into its plane;
// jdcoefct.c decompress_smooth_data's estimates first where libjpeg
// smooths, each block's 5x5 DC neighbourhood read from the buffer as
// libjpeg reads it: the rows from the block row computed with the iMCU
// row's own count of block rows, the columns clamped to the extent.
void idct_planes(Header& hd) {
  const bool smooth = smoothing_ok(hd);
  for (auto& c : hd.comps) {
    c.stride = c.bw * 8;
    c.plane.assign(static_cast<size_t>(c.stride) * c.bh * 8, 0);
    auto out = [&](int by, int bx) {
      return c.plane.data() + static_cast<size_t>(by) * 8 * c.stride + bx * 8;
    };
    auto block = [&](int by, int bx) {
      return c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64;
    };
    if (!smooth) {
      for (int by = 0; by < c.eh; ++by)
        for (int bx = 0; bx < c.ew; ++bx) idct_islow(block(by, bx), c.quant, out(by, bx), c.stride);
      continue;
    }
    bool change_dc = true;
    for (int k = 1; k < 10; ++k) change_dc = change_dc && c.coef_bits[k] == -1;
    const Estimate* est = change_dc ? kSmoothDCOnly : kSmoothAC;
    const int n_est = change_dc ? 9 : 5;
    const int64_t q00 = c.quant[0];
    const int t = hd.mcuy;
    int16_t ws[64];
    int dc[5][5];
    for (int r = 0; r < t; ++r) {
      int block_rows = r < t - 1 ? c.v : (c.eh % c.v ? c.eh % c.v : c.v);
      int image_block_rows = block_rows * t;
      for (int b = 0; b < block_rows; ++b) {
        int row = r * c.v + b, image_row = r * block_rows + b;
        int rows[5];
        rows[1] = image_row > 0 ? row - 1 : row;
        rows[0] = image_row > 1 ? row - 2 : rows[1];
        rows[2] = row;
        rows[3] = image_row < image_block_rows - 1 ? row + 1 : row;
        rows[4] = image_row < image_block_rows - 2 ? row + 2 : rows[3];
        for (int x = 0; x < c.ew; ++x) {
          for (int i = 0; i < 5; ++i)
            for (int j = 0; j < 5; ++j)
              dc[i][j] = block(rows[i], std::min(std::max(x + j - 2, 0), c.ew - 1))[0];
          std::memcpy(ws, block(row, x), sizeof ws);
          for (int e = 0; e < n_est; ++e) {
            int al = c.coef_bits[est[e].zz];
            if (al != 0 && ws[est[e].pos] == 0)
              ws[est[e].pos] = jcoef(predict(q00 * weigh(est[e].w, dc), c.quant[est[e].pos], al));
          }
          if (change_dc) ws[0] = jcoef(predict(q00 * weigh(kSmoothDC, dc), q00, 0));
          idct_islow(ws, c.quant, out(row, x), c.stride);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// upsampling (jdsample.c) and colour conversion (jdcolor.c)

enum Method { kFullsize, kH2V1Fancy, kH2V2Fancy, kH1V2Fancy, kReplicate };

// jdsample.c jinit_upsampler's choice for one component
struct Upsampler {
  Method method;
  int h_expand, v_expand, dw, dh;   // ratios, and the downsampled extent
};

Upsampler upsampler(const Header& hd, const Component& c) {
  Upsampler u;
  u.h_expand = hd.hmax / c.h;
  u.v_expand = hd.vmax / c.v;
  u.dw = static_cast<int>((int64_t{hd.width} * c.h + hd.hmax - 1) / hd.hmax);
  u.dh = static_cast<int>((int64_t{hd.height} * c.v + hd.vmax - 1) / hd.vmax);
  // fancy upsampling needs the DCT's 8x8 output (do_fancy), so not lossless
  bool fancy = !hd.lossless;
  if (u.h_expand == 1 && u.v_expand == 1)
    u.method = kFullsize;
  else if (u.h_expand == 2 && u.v_expand == 1 && fancy && u.dw > 2)
    u.method = kH2V1Fancy;
  else if (u.h_expand == 1 && u.v_expand == 2 && fancy)
    u.method = kH1V2Fancy;
  else if (u.h_expand == 2 && u.v_expand == 2 && fancy && u.dw > 2)
    u.method = kH2V2Fancy;
  else
    u.method = kReplicate;   // h2v1_upsample, h2v2_upsample, int_upsample
  return u;
}

// output row y of a component: a pointer into its plane (fullsize) or into
// `row` (width >= the image's), written here
const uint8_t* upsample_row(const Component& c, const Upsampler& u, int y, int width,
                            std::vector<int>& colsum, uint8_t* row) {
  const uint8_t* plane = c.plane.data();
  auto line = [&](int i) { return plane + static_cast<size_t>(i) * c.stride; };
  const int dw = u.dw, dh = u.dh;
  switch (u.method) {
    case kFullsize:
      return line(y);
    case kReplicate: {
      const uint8_t* in = line(y / u.v_expand);
      if (u.h_expand == 1) return in;
      for (int ox = 0; ox < width; ++ox) row[ox] = in[ox / u.h_expand];
      return row;
    }
    case kH1V2Fancy: {   // the nearer row weighs 3, the farther 1
      int i = y >> 1;
      int other = (y & 1) ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
      int bias = (y & 1) ? 2 : 1;
      const uint8_t* near = line(i);
      const uint8_t* far = line(other);
      for (int x = 0; x < width; ++x)
        row[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
      return row;
    }
    case kH2V1Fancy: {
      const uint8_t* in = line(y);
      for (int ox = 0; ox < width; ++ox) {
        int j = ox >> 1;
        if ((ox & 1) == 0)
          row[ox] = j == 0 ? in[0] : static_cast<uint8_t>((in[j] * 3 + in[j - 1] + 1) >> 2);
        else
          row[ox] = j == dw - 1 ? in[j] : static_cast<uint8_t>((in[j] * 3 + in[j + 1] + 2) >> 2);
      }
      return row;
    }
    case kH2V2Fancy: {   // the nearer row weighs 3, the farther 1
      int i = y >> 1;
      int other = (y & 1) ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
      const uint8_t* near = line(i);
      const uint8_t* far = line(other);
      for (int x = 0; x < dw; ++x) colsum[x] = near[x] * 3 + far[x];
      for (int ox = 0; ox < width; ++ox) {
        int j = ox >> 1;
        if ((ox & 1) == 0)
          row[ox] = static_cast<uint8_t>(
              j == 0 ? (colsum[0] * 4 + 8) >> 4 : (colsum[j] * 3 + colsum[j - 1] + 8) >> 4);
        else
          row[ox] = static_cast<uint8_t>(
              j == dw - 1 ? (colsum[j] * 4 + 7) >> 4 : (colsum[j] * 3 + colsum[j + 1] + 7) >> 4);
      }
      return row;
    }
  }
  return row;
}

struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t{1} << (kScale - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1L << kScale) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};

const ColorTables& tables() {
  static const ColorTables t;
  return t;
}

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// Pillow's MULDIV255 (ImagingUtils.h): a * b / 255, rounded
inline int muldiv255(int a, int b) {
  int t = a * b + 128;
  return ((t >> 8) + t) >> 8;
}

// PIL reads CMYK inverted ("CMYK;I", Adobe's convention) and converts it
// with Convert.c's cmyk2rgb
inline void cmyk_to_rgb(int c, int m, int y, int k, uint8_t* o) {
  int nk = k;   // 255 - (255 - k)
  o[0] = clamp255(nk - muldiv255(255 - c, nk));
  o[1] = clamp255(nk - muldiv255(255 - m, nk));
  o[2] = clamp255(nk - muldiv255(255 - y, nk));
}

void to_rgb(const Header& hd, uint8_t* out) {
  const int w = hd.width, h = hd.height;
  const int nc = static_cast<int>(hd.comps.size());
  const ColorTables& t = tables();
  Upsampler ups[4];
  std::vector<uint8_t> rows[4];
  int widest = 1;
  for (int c = 0; c < nc; ++c) {
    ups[c] = upsampler(hd, hd.comps[c]);
    rows[c].resize(static_cast<size_t>(w) + 8);
    widest = std::max(widest, ups[c].dw);
  }
  std::vector<int> colsum(widest + 1);
  const uint8_t* p[4];
  for (int y = 0; y < h; ++y) {
    for (int c = 0; c < nc; ++c)
      p[c] = upsample_row(hd.comps[c], ups[c], y, w, colsum, rows[c].data());
    uint8_t* o = out + static_cast<size_t>(y) * w * 3;
    switch (hd.space) {
      case kGrey:
        for (int x = 0; x < w; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = p[0][x];
        break;
      case kRGB:
        for (int x = 0; x < w; ++x) {
          o[3 * x] = p[0][x];
          o[3 * x + 1] = p[1][x];
          o[3 * x + 2] = p[2][x];
        }
        break;
      case kYCbCr:
        for (int x = 0; x < w; ++x) {
          int l = p[0][x], b = p[1][x], r = p[2][x];
          o[3 * x] = clamp255(l + t.cr_r[r]);
          o[3 * x + 1] = clamp255(l + static_cast<int>((t.cb_g[b] + t.cr_g[r]) >> 16));
          o[3 * x + 2] = clamp255(l + t.cb_b[b]);
        }
        break;
      case kCMYK:
      case kYCCK:
        for (int x = 0; x < w; ++x) {
          int c0 = p[0][x], c1 = p[1][x], c2 = p[2][x], k = p[3][x];
          if (hd.space == kYCCK) {   // jdcolor.c's ycck_cmyk_convert
            int l = c0, cb = c1, cr = c2;
            c0 = clamp255(255 - (l + t.cr_r[cr]));
            c1 = clamp255(255 - (l + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
            c2 = clamp255(255 - (l + t.cb_b[cb]));
          }
          cmyk_to_rgb(c0, c1, c2, k, o + 3 * x);
        }
        break;
    }
  }
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
}

// one pass of ImagingResampleHorizontal/Vertical_8bpc along the axis of
// `n` samples at stride `step`: out[o] = clip8(2^21 + sum_t in[idx[o, t]] * k[o, t])
inline void resample_line(const uint8_t* in, int64_t step, uint8_t* out, int64_t out_step,
                          int n_out, const int32_t* idx, const int32_t* kk, int ksize) {
  for (int o = 0; o < n_out; ++o) {
    int32_t acc = 1 << 21;
    const int32_t* ix = idx + static_cast<int64_t>(o) * ksize;
    const int32_t* k = kk + static_cast<int64_t>(o) * ksize;
    for (int t = 0; t < ksize; ++t) acc += in[ix[t] * step] * k[t];
    out[o * out_step] = static_cast<uint8_t>(acc <= 0 ? 0 : acc >= (1 << 30) ? 255 : acc >> 22);
  }
}

}  // namespace

extern "C" {

// PIL's BILINEAR resize of an h x w x c uint8 image whose rows lie
// `row_stride` bytes apart, to oh x ow x c (contiguous) at `out`.  The
// horizontal pass runs when ow != w, the vertical when oh != h; each
// takes (out, ksize) tap indices and fixed-point weights.
int smm_resize_pil(const uint8_t* in, int h, int w, int c, int64_t row_stride, uint8_t* out,
                   int oh, int ow, const int32_t* xidx, const int32_t* xk, int kx,
                   const int32_t* yidx, const int32_t* yk, int ky) {
  std::vector<uint8_t> tmp;
  const uint8_t* src = in;
  int64_t src_stride = row_stride;
  if (ow != w) {
    uint8_t* dst = out;
    if (oh != h) {
      tmp.resize(static_cast<size_t>(h) * ow * c);
      dst = tmp.data();
    }
    for (int y = 0; y < h; ++y)
      for (int ch = 0; ch < c; ++ch)
        resample_line(in + y * row_stride + ch, c, dst + static_cast<int64_t>(y) * ow * c + ch, c,
                      ow, xidx, xk, kx);
    if (oh == h) return kOk;
    src = dst;
    src_stride = static_cast<int64_t>(ow) * c;
  }
  if (oh != h) {   // row by row, so that each tap reads a whole source row
    int64_t line = static_cast<int64_t>(ow) * c;
    std::vector<int32_t> acc(line);
    for (int o = 0; o < oh; ++o) {
      std::fill(acc.begin(), acc.end(), 1 << 21);
      for (int t = 0; t < ky; ++t) {
        const uint8_t* row = src + yidx[static_cast<int64_t>(o) * ky + t] * src_stride;
        int32_t k = yk[static_cast<int64_t>(o) * ky + t];
        for (int64_t x = 0; x < line; ++x) acc[x] += row[x] * k;
      }
      uint8_t* dst = out + o * line;
      for (int64_t x = 0; x < line; ++x)
        dst[x] = static_cast<uint8_t>(acc[x] <= 0 ? 0 : acc[x] >= (1 << 30) ? 255 : acc[x] >> 22);
    }
  }
  return kOk;
}


// width and height of a JPEG from its frame header
int smm_jpeg_size(const uint8_t* data, int64_t len, int32_t* wh, char* err, int errlen) {
  try {
    Header hd;
    parse(data, static_cast<size_t>(len), hd, true);
    wh[0] = hd.width;
    wh[1] = hd.height;
    return kOk;
  } catch (const Failure& f) {
    set_error(err, errlen, f.msg);
    return f.code;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return kMalformed;
  }
}

// decode to height x width x 3 RGB bytes at `out` (cap bytes)
int smm_jpeg_decode(const uint8_t* data, int64_t len, uint8_t* out, int64_t cap, char* err,
                    int errlen) {
  try {
    Header hd;
    {
      Header size;
      parse(data, static_cast<size_t>(len), size, true);
      if (static_cast<int64_t>(size.width) * size.height * 3 > cap)
        malformed("output buffer too small");
    }
    parse(data, static_cast<size_t>(len), hd, false);
    if (!hd.lossless) idct_planes(hd);
    to_rgb(hd, out);
    return kOk;
  } catch (const Failure& f) {
    set_error(err, errlen, f.msg);
    return f.code;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return kMalformed;
  }
}

}  // extern "C"
