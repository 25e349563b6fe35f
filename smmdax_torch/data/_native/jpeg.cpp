// JPEG decoder whose output equals PIL's byte for byte.
//
// PIL decodes with libjpeg-turbo at its defaults, and this file reproduces
// those defaults exactly: the ISLOW integer IDCT (13 constant bits, 2
// pass-1 bits) with its range-limit table, "fancy" triangle upsampling of
// 4:2:2 and 4:2:0 chroma (context rows replicated at the top and bottom of
// the image, plain replication when the chroma plane is at most 2 samples
// wide), and the fixed-point YCbCr -> RGB tables (16 scale bits).  Grey
// images come out as RGB with the grey value in every channel, as PIL's
// convert("RGB") gives them.
//
// Covered: sequential (SOF0 / SOF1) and progressive (SOF2) Huffman coding,
// 8-bit samples; every scan up to EOI (interleaved, or of one component
// walking its own extent, sequential scans too) goes into per-component
// int16 coefficient buffers (jdhuff.c, jdphuff.c: DC first and refinement scans,
// AC first scans with EOB runs, AC refinement with its correction bits,
// restart intervals), and the IDCT runs once at the end.  Colour spaces as
// libjpeg's default_decompress_parms picks them: grey; three components
// as YCbCr (JFIF, Adobe transform 1) or RGB (Adobe transform 0, or
// component ids R, G, B), luma sampled 1x1, 2x1 or 2x2 against 1x1;
// four components at 1x1 as CMYK (Adobe transform 0, or no Adobe marker)
// or YCCK (any other transform), which PIL reads inverted and converts
// with its own cmyk2rgb.  Byte stuffing, fill bytes, tables between scans,
// any image size.  Refused with status 1, never decoded differently:
// arithmetic coding, lossless, hierarchical, 12-bit, other sampling
// layouts, a scan naming its components out of the frame's order, and a progressive file whose
// scans leave the first AC coefficients' bits unsent (libjpeg smooths its
// blocks then).
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
// jidctint.c's ISLOW IDCT

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

// libjpeg's post-IDCT range limit: the 10-bit wrapped value, read as
// signed, plus 128, clamped to 0..255
inline uint8_t idct_limit(int64_t x) {
  int v = static_cast<int>(x & 1023);
  if (v >= 512) v -= 1024;
  v += 128;
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

// the same 1-D butterfly for columns and rows: in[0..7] at stride, out
// the eight sums before the final descale
inline void idct_1d(int64_t i0, int64_t i1, int64_t i2, int64_t i3, int64_t i4, int64_t i5,
                    int64_t i6, int64_t i7, int64_t out[8]) {
  int64_t z1 = (i2 + i6) * FIX_0_541196100;
  int64_t tmp2 = z1 + i6 * -FIX_1_847759065;
  int64_t tmp3 = z1 + i2 * FIX_0_765366865;
  int64_t tmp0 = (i0 + i4) * (int64_t{1} << kConstBits);
  int64_t tmp1 = (i0 - i4) * (int64_t{1} << kConstBits);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

  tmp0 = i7;
  tmp1 = i5;
  tmp2 = i3;
  tmp3 = i1;
  z1 = tmp0 + tmp3;
  int64_t z2 = tmp1 + tmp2, z3 = tmp0 + tmp2, z4 = tmp1 + tmp3;
  int64_t z5 = (z3 + z4) * FIX_1_175875602;
  tmp0 *= FIX_0_298631336;
  tmp1 *= FIX_2_053119869;
  tmp2 *= FIX_3_072711026;
  tmp3 *= FIX_1_501321110;
  z1 *= -FIX_0_899976223;
  z2 *= -FIX_2_562915447;
  z3 *= -FIX_1_961570560;
  z4 *= -FIX_0_390180644;
  z3 += z5;
  z4 += z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;

  out[0] = tmp10 + tmp3;
  out[7] = tmp10 - tmp3;
  out[1] = tmp11 + tmp2;
  out[6] = tmp11 - tmp2;
  out[2] = tmp12 + tmp1;
  out[5] = tmp12 - tmp1;
  out[3] = tmp13 + tmp0;
  out[4] = tmp13 - tmp0;
}

// coef in natural order, quant in natural order; 8x8 samples to dst
void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* dst, int stride) {
  int32_t ws[64];
  int64_t o[8];
  for (int c = 0; c < 8; ++c) {
    int64_t in[8];
    for (int r = 0; r < 8; ++r) in[r] = static_cast<int64_t>(coef[r * 8 + c]) * quant[r * 8 + c];
    idct_1d(in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], o);
    for (int r = 0; r < 8; ++r)
      ws[r * 8 + c] = static_cast<int32_t>(descale(o[r], kConstBits - kPass1Bits));
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + r * 8;
    idct_1d(w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], o);
    uint8_t* out = dst + r * stride;
    for (int c = 0; c < 8; ++c) out[c] = idct_limit(descale(o[c], kConstBits + kPass1Bits + 3));
  }
}

// ---------------------------------------------------------------------------

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;          // Huffman tables of the current scan
  int bw = 0, bh = 0;          // blocks per line and per column of the buffer (whole MCUs)
  int ew = 0, eh = 0;          // blocks of the component's own extent (non-interleaved scans)
  std::vector<int16_t> coef;   // bh x bw blocks of 64 coefficients, natural order
  uint16_t quant[64] = {};     // latched at the component's first scan, as libjpeg does
  bool latched = false;
  int coef_bits[64] = {};      // progressive: Al of the last scan that sent each coefficient
  std::vector<uint8_t> plane;  // (bh * 8) x (bw * 8) samples after the IDCT
  int dc_pred = 0;
};

enum ColorSpace { kGrey, kYCbCr, kRGB, kCMYK, kYCCK };

struct Header {
  int width = 0, height = 0;
  int sof = 0;                 // 0xC0 / 0xC1 sequential, 0xC2 progressive
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  uint16_t quant[4][64];
  bool quant_set[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool jfif = false;
  bool adobe = false;
  int adobe_transform = 0;
  ColorSpace space = kGrey;
  int scans = 0;
  bool progressive() const { return sof == 0xC2; }
};

inline uint16_t be16(const uint8_t* p) { return static_cast<uint16_t>((p[0] << 8) | p[1]); }

const char* sof_name(int m) {
  switch (m) {
    case 0xC3: return "lossless JPEG";
    case 0xC5: case 0xC6: case 0xC7: return "hierarchical JPEG";
    case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
      return "arithmetic-coded JPEG";
    default: return "JPEG of an unknown process";
  }
}

std::string sampling(const Header& hd) {
  std::string s;
  for (const auto& c : hd.comps)
    s += (s.empty() ? "" : ",") + std::to_string(c.h) + "x" + std::to_string(c.v);
  return s;
}

// the frame header: size, components, and the coefficient buffers
void read_frame(Header& hd, int m, const uint8_t* s, size_t sl, bool size_only) {
  if (hd.sof) malformed("a second frame header");
  if (sl < 6) malformed("short frame header");
  if (s[0] != 8) unsupported(std::to_string(s[0]) + "-bit JPEG samples");
  hd.sof = m;
  hd.height = be16(s + 1);
  hd.width = be16(s + 3);
  int nf = s[5];
  if (hd.height == 0 || hd.width == 0)
    unsupported("JPEG with its height in a DNL marker, or of zero size");
  // PIL refuses an image of more than 2 * Image.MAX_IMAGE_PIXELS
  if (static_cast<int64_t>(hd.width) * hd.height > kMaxPixels)
    malformed("image of more pixels than PIL opens");
  if (nf != 1 && nf != 3 && nf != 4)
    unsupported(std::to_string(nf) + "-component JPEG");
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
  if (nf == 1) hd.comps[0].h = hd.comps[0].v = 1;   // one component: one block per MCU
  for (const auto& c : hd.comps) {
    hd.hmax = std::max(hd.hmax, c.h);
    hd.vmax = std::max(hd.vmax, c.v);
  }
  hd.mcux = (hd.width + 8 * hd.hmax - 1) / (8 * hd.hmax);
  hd.mcuy = (hd.height + 8 * hd.vmax - 1) / (8 * hd.vmax);
  for (auto& c : hd.comps) {
    c.bw = hd.mcux * c.h;
    c.bh = hd.mcuy * c.v;
    // jdinput.c: ceil(ceil(width * h / hmax) / 8) blocks
    c.ew = static_cast<int>((int64_t{hd.width} * c.h + 8 * hd.hmax - 1) / (8 * hd.hmax));
    c.eh = static_cast<int>((int64_t{hd.height} * c.v + 8 * hd.vmax - 1) / (8 * hd.vmax));
    c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    std::fill(c.coef_bits, c.coef_bits + 64, -1);
  }
}

// libjpeg's default_decompress_parms (jdapimin.c), then the layouts this
// decoder holds to PIL; anything else is refused
void check_layout(Header& hd) {
  auto& cs = hd.comps;
  if (cs.size() == 1) {
    hd.space = kGrey;
    return;
  }
  bool chroma_1x1 = true;
  for (size_t c = 1; c < cs.size(); ++c) chroma_1x1 = chroma_1x1 && cs[c].h == 1 && cs[c].v == 1;
  if (cs.size() == 4) {
    if (!chroma_1x1 || cs[0].h != 1 || cs[0].v != 1)
      unsupported("4-component JPEG sampling layout " + sampling(hd) +
                  " (the decoder reads CMYK and YCCK at 1x1)");
    hd.space = hd.adobe && hd.adobe_transform != 0 ? kYCCK : kCMYK;
    return;
  }
  const auto& y = cs[0];
  bool luma_ok = (y.h == 1 && y.v == 1) || (y.h == 2 && y.v == 1) || (y.h == 2 && y.v == 2);
  if (!chroma_1x1 || !luma_ok)
    unsupported("JPEG sampling layout " + sampling(hd) +
                " (the decoder reads 4:4:4, 4:2:2 and 4:2:0)");
  if (hd.jfif)
    hd.space = kYCbCr;
  else if (hd.adobe)
    hd.space = hd.adobe_transform == 0 ? kRGB : kYCbCr;
  else
    hd.space = cs[0].id == 'R' && cs[1].id == 'G' && cs[2].id == 'B' ? kRGB : kYCbCr;
}

struct Scan {
  int ns = 0;
  Component* comps[4];
  int ss = 0, se = 63, ah = 0, al = 0;
};

Scan read_scan(Header& hd, const uint8_t* s, size_t sl) {
  if (sl < 1) malformed("short scan header");
  Scan sc;
  sc.ns = s[0];
  if (sc.ns < 1 || sc.ns > 4) malformed("bad component count in the scan header");
  if (sl < 1 + 2 * static_cast<size_t>(sc.ns) + 3) malformed("short scan header");
  for (int c = 0; c < sc.ns; ++c) {
    int id = s[1 + 2 * c];
    Component* comp = nullptr;
    for (auto& cc : hd.comps)
      if (cc.id == id) comp = &cc;
    if (comp == nullptr) malformed("scan names an unknown component");
    for (int k = 0; k < c; ++k)
      if (sc.comps[k] == comp) malformed("scan names a component twice");
    sc.comps[c] = comp;
    comp->td = s[2 + 2 * c] >> 4;
    comp->ta = s[2 + 2 * c] & 15;
    if (comp->td > 3 || comp->ta > 3) malformed("bad Huffman table id in the scan");
  }
  const uint8_t* t = s + 1 + 2 * sc.ns;
  sc.ss = t[0];
  sc.se = t[1];
  sc.ah = t[2] >> 4;
  sc.al = t[2] & 15;
  if (!hd.progressive()) {   // one scan of every component, or several scans of some
    for (int c = 1; c < sc.ns; ++c)
      if (sc.comps[c] <= sc.comps[c - 1])
        unsupported("JPEG scan in another order than its frame");
    if (sc.ss != 0 || sc.se != 63 || sc.ah != 0 || sc.al != 0)
      malformed("baseline scan with a spectral selection");
  } else {
    // jdphuff.c's start_pass_phuff_decoder
    bool dc = sc.ss == 0;
    bool bad = dc ? sc.se != 0 : (sc.ss > sc.se || sc.se > 63 || sc.ns != 1);
    if (sc.ah != 0 && sc.al != sc.ah - 1) bad = true;
    if (sc.al > 13) bad = true;
    if (bad) malformed("bad progressive scan parameters");
  }
  for (int c = 0; c < sc.ns; ++c) {
    Component& comp = *sc.comps[c];
    if (!comp.latched) {
      if (!hd.quant_set[comp.tq]) malformed("missing quantization table");
      std::memcpy(comp.quant, hd.quant[comp.tq], sizeof comp.quant);
      comp.latched = true;
    }
    bool needs_dc = !hd.progressive() || (sc.ss == 0 && sc.ah == 0);
    bool needs_ac = !hd.progressive() || sc.ss > 0;
    if ((needs_dc && !hd.dc[comp.td].present) || (needs_ac && !hd.ac[comp.ta].present))
      malformed("missing Huffman table");
    if (needs_dc)   // jdhuff.c's jpeg_make_d_derived_tbl
      for (int k = 0; k < hd.dc[comp.td].nvals; ++k)
        if (hd.dc[comp.td].vals[k] > 15) malformed("bad DC Huffman table");
    if (hd.progressive())
      for (int k = sc.ss; k <= sc.se; ++k) comp.coef_bits[k] = sc.al;
  }
  return sc;
}

inline int16_t jcoef(int v) { return static_cast<int16_t>(v); }   // a JCOEF, 16 bits

// Every MCU of a scan in order, restart intervals included: `block(c,
// blk)` decodes one block of scan component c.  A scan of one component
// walks its own extent, one block per MCU (non-interleaved).
template <typename Block>
void walk_scan(Header& hd, const Scan& sc, BitReader& br, int& eobrun, Block&& block) {
  bool single = sc.ns == 1;
  int mcux = single ? sc.comps[0]->ew : hd.mcux;
  int mcuy = single ? sc.comps[0]->eh : hd.mcuy;
  int restarts = 0;
  long total = static_cast<long>(mcux) * mcuy;
  for (int c = 0; c < sc.ns; ++c) sc.comps[c]->dc_pred = 0;
  eobrun = 0;
  for (long m = 0; m < total; ++m) {
    if (hd.restart_interval && m > 0 && m % hd.restart_interval == 0) {
      br.restart(restarts & 7);
      ++restarts;
      for (int c = 0; c < sc.ns; ++c) sc.comps[c]->dc_pred = 0;
      eobrun = 0;
    }
    int my = static_cast<int>(m / mcux), mx = static_cast<int>(m % mcux);
    if (single) {
      Component& c = *sc.comps[0];
      block(c, c.coef.data() + (static_cast<size_t>(my) * c.bw + mx) * 64);
      continue;
    }
    for (int ci = 0; ci < sc.ns; ++ci) {
      Component& c = *sc.comps[ci];
      for (int v = 0; v < c.v; ++v)
        for (int h = 0; h < c.h; ++h)
          block(c, c.coef.data() +
                       (static_cast<size_t>(my * c.v + v) * c.bw + mx * c.h + h) * 64);
    }
  }
}

inline int dc_diff(BitReader& br, const Huffman& t) {
  int s = br.decode(t);
  return s ? extend(br.bits(s), s) : 0;
}

inline void add_dc(Component& c, int diff) {
  // jdhuff.c refuses a DC predictor that overflows an int
  if ((c.dc_pred >= 0 && diff > INT_MAX - c.dc_pred) ||
      (c.dc_pred < 0 && diff < INT_MIN - c.dc_pred))
    malformed("DC coefficient out of range");
  c.dc_pred += diff;
}

// jdhuff.c (sequential) and jdphuff.c (progressive) into the coefficient
// buffers
void decode_scan(const uint8_t* d, size_t n, size_t start, Header& hd, const Scan& sc) {
  BitReader br{d + start, d + n};
  int eobrun = 0;
  const int ss = sc.ss, se = sc.se, al = sc.al;
  if (!hd.progressive()) {
    walk_scan(hd, sc, br, eobrun, [&](Component& c, int16_t* blk) {
      add_dc(c, dc_diff(br, hd.dc[c.td]));
      blk[0] = jcoef(c.dc_pred);
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
    walk_scan(hd, sc, br, eobrun, [&](Component& c, int16_t* blk) {
      add_dc(c, dc_diff(br, hd.dc[c.td]));
      blk[0] = jcoef(static_cast<int>(static_cast<unsigned>(c.dc_pred) << al));
    });
  } else if (ss == 0) {                            // DC refinement
    walk_scan(hd, sc, br, eobrun, [&](Component&, int16_t* blk) {
      if (br.bits(1)) blk[0] = jcoef(blk[0] | (1 << al));
    });
  } else if (sc.ah == 0) {                         // AC first
    walk_scan(hd, sc, br, eobrun, [&](Component& c, int16_t* blk) {
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
    walk_scan(hd, sc, br, eobrun, [&](Component& c, int16_t* blk) {
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

// jdcoefct.c's smoothing_ok: libjpeg smooths the blocks of a progressive
// file whose first AC coefficients still miss bits, which this decoder
// does not reproduce
void check_complete(const Header& hd) {
  if (!hd.progressive()) return;
  static const int kSaved[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};   // zigzag 0..9
  bool useful = false;
  for (const auto& c : hd.comps) {
    if (!c.latched) return;
    for (int k : kSaved)
      if (c.quant[k] == 0) return;
    if (c.coef_bits[0] < 0) return;
    for (int k = 1; k < 10; ++k) useful = useful || c.coef_bits[k] != 0;
  }
  if (useful)
    unsupported("progressive JPEG whose scans leave coefficient bits unsent (libjpeg smooths "
                "its blocks)");
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
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      read_frame(hd, m, s, sl, size_only);
      if (size_only) return;
    } else if ((m >= 0xC3 && m <= 0xCB && m != 0xC4 && m != 0xC8) || (m >= 0xCD && m <= 0xCF)) {
      unsupported(sof_name(m));
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
      decode_scan(d, n, i + len, hd, sc);
      ++hd.scans;
      if (!hd.progressive() && sc.ns == static_cast<int>(hd.comps.size()))
        return;                           // one scan holds the whole image
      i = scan_end(d, n, i + len);
      continue;
    }
    i += len;
  }
}

// the IDCT of every block of each component's extent into its plane
void idct_planes(Header& hd) {
  for (auto& c : hd.comps) {
    int stride = c.bw * 8;
    c.plane.assign(static_cast<size_t>(stride) * c.bh * 8, 0);
    for (int by = 0; by < c.eh; ++by)
      for (int bx = 0; bx < c.ew; ++bx)
        idct_islow(c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64, c.quant,
                   c.plane.data() + static_cast<size_t>(by) * 8 * stride + bx * 8, stride);
  }
}

// ---------------------------------------------------------------------------
// upsampling (jdsample.c) and colour conversion (jdcolor.c)

// one upsampled chroma row of the output: `row` of width >= width
void upsample_row(const Component& c, int ratio_h, int ratio_v, int dw, int dh, int y,
                  int width, std::vector<int>& colsum, uint8_t* row) {
  int stride = c.bw * 8;
  if (ratio_h == 1) {   // 4:4:4
    std::memcpy(row, c.plane.data() + static_cast<size_t>(y) * stride, width);
    return;
  }
  bool fancy = dw > 2;
  if (ratio_v == 1) {   // 4:2:2, h2v1
    const uint8_t* in = c.plane.data() + static_cast<size_t>(y) * stride;
    for (int ox = 0; ox < width; ++ox) {
      int j = ox >> 1;
      if (!fancy) {
        row[ox] = in[j];
      } else if ((ox & 1) == 0) {
        row[ox] = j == 0 ? in[0] : static_cast<uint8_t>((in[j] * 3 + in[j - 1] + 1) >> 2);
      } else {
        row[ox] = j == dw - 1 ? in[j] : static_cast<uint8_t>((in[j] * 3 + in[j + 1] + 2) >> 2);
      }
    }
    return;
  }
  // 4:2:0, h2v2: the nearer chroma row weighs 3, the farther 1
  int i = y >> 1;
  if (!fancy) {
    const uint8_t* in = c.plane.data() + static_cast<size_t>(i) * stride;
    for (int ox = 0; ox < width; ++ox) row[ox] = in[ox >> 1];
    return;
  }
  int other = (y & 1) ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
  const uint8_t* near = c.plane.data() + static_cast<size_t>(i) * stride;
  const uint8_t* far = c.plane.data() + static_cast<size_t>(other) * stride;
  for (int x = 0; x < dw; ++x) colsum[x] = near[x] * 3 + far[x];
  for (int ox = 0; ox < width; ++ox) {
    int j = ox >> 1;
    if ((ox & 1) == 0) {
      row[ox] = static_cast<uint8_t>(
          j == 0 ? (colsum[0] * 4 + 8) >> 4 : (colsum[j] * 3 + colsum[j - 1] + 8) >> 4);
    } else {
      row[ox] = static_cast<uint8_t>(
          j == dw - 1 ? (colsum[j] * 4 + 7) >> 4 : (colsum[j] * 3 + colsum[j + 1] + 7) >> 4);
    }
  }
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
  int w = hd.width, h = hd.height;
  const Component& yc = hd.comps[0];
  int ystride = yc.bw * 8;
  const ColorTables& t = tables();
  if (hd.space == kGrey) {
    for (int y = 0; y < h; ++y) {
      const uint8_t* in = yc.plane.data() + static_cast<size_t>(y) * ystride;
      uint8_t* o = out + static_cast<size_t>(y) * w * 3;
      for (int x = 0; x < w; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = in[x];
    }
    return;
  }
  if (hd.space == kCMYK || hd.space == kYCCK) {   // four planes at 1x1
    for (int y = 0; y < h; ++y) {
      const uint8_t* p[4];
      for (int c = 0; c < 4; ++c)
        p[c] = hd.comps[c].plane.data() + static_cast<size_t>(y) * hd.comps[c].bw * 8;
      uint8_t* o = out + static_cast<size_t>(y) * w * 3;
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
    }
    return;
  }
  int ratio_h = yc.h, ratio_v = yc.v;
  // the other planes' real extent: libjpeg's downsampled_width / _height
  int dw = (w + ratio_h - 1) / ratio_h, dh = (h + ratio_v - 1) / ratio_v;
  int padded = 2 * (dw + 1);
  std::vector<uint8_t> cb(padded), cr(padded);
  std::vector<int> colsum(dw + 1);
  for (int y = 0; y < h; ++y) {
    upsample_row(hd.comps[1], ratio_h, ratio_v, dw, dh, y, w, colsum, cb.data());
    upsample_row(hd.comps[2], ratio_h, ratio_v, dw, dh, y, w, colsum, cr.data());
    const uint8_t* yy = yc.plane.data() + static_cast<size_t>(y) * ystride;
    uint8_t* o = out + static_cast<size_t>(y) * w * 3;
    if (hd.space == kRGB) {
      for (int x = 0; x < w; ++x) {
        o[3 * x] = yy[x];
        o[3 * x + 1] = cb[x];
        o[3 * x + 2] = cr[x];
      }
      continue;
    }
    for (int x = 0; x < w; ++x) {
      int l = yy[x], b = cb[x], r = cr[x];
      o[3 * x] = clamp255(l + t.cr_r[r]);
      o[3 * x + 1] = clamp255(l + static_cast<int>((t.cb_g[b] + t.cr_g[r]) >> 16));
      o[3 * x + 2] = clamp255(l + t.cb_b[b]);
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
    check_complete(hd);
    idct_planes(hd);
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
