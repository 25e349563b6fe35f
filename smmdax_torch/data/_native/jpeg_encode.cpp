// Baseline JPEG encoder whose output equals PIL's byte for byte.
//
// PIL's Image.save(format="JPEG", quality=q) runs libjpeg-turbo at its
// defaults, and this file reproduces exactly that and nothing more: RGB
// input, 8 bits, YCbCr 4:2:0 (Y 2x2 on quantization table 0, Cb and Cr 1x1
// on table 1), baseline sequential Huffman coding with the standard tables
// of the JPEG spec (Annex K), no optimized tables, no progression, no
// restart markers, a JFIF 1.01 APP0 with density 1x1 and units 0.  Each
// step carries the name of the libjpeg-turbo function it follows.  The
// plain version is smmdax_torch/data/jpeg_encode.py.
//
// Plain C interface for ctypes; a call holds no global state, so threads
// may encode side by side.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// zigzag index -> natural (row-major) index
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jcparam.c std_luminance_quant_tbl / std_chrominance_quant_tbl (natural order)
const int kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99,
    99, 99, 47, 66, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jstdhuff.c: codes of each length 1..16, then the symbols
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// jchuff.c jpeg_make_c_derived_tbl: symbol -> (code, size)
struct Huff {
  uint32_t code[256];
  uint8_t size[256];
  Huff(const uint8_t* bits, const uint8_t* vals) {
    std::memset(code, 0, sizeof(code));
    std::memset(size, 0, sizeof(size));
    uint32_t c = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len - 1]; ++i, ++k, ++c) {
        code[vals[k]] = c;
        size[vals[k]] = static_cast<uint8_t>(len);
      }
      c <<= 1;
    }
  }
};

// jchuff.c's bit buffer: a 0x00 stuffed after every 0xFF byte, the last
// byte padded with 1-bits (flush_bits)
struct Bits {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int n = 0;
  explicit Bits(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t code, int size) {
    acc = (acc << size) | code;
    n += size;
    while (n >= 8) {
      n -= 8;
      uint8_t b = static_cast<uint8_t>(acc >> n);
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
    }
    acc &= (uint64_t(1) << n) - 1;
  }
  void flush() {
    if (n) put((1u << (8 - n)) - 1, 8 - n);
  }
};

inline int nbits_of(int v) {
  int m = v < 0 ? -v : v, n = 0;
  while (m) {
    ++n;
    m >>= 1;
  }
  return n;
}

// jchuff.c encode_one_block: the DC difference, then run-lengths with ZRL
// only before a nonzero coefficient, EOB after the last nonzero one
void encode_block(Bits& bits, const int16_t* blk, int last_dc, const Huff& dc, const Huff& ac) {
  int v = blk[0] - last_dc;
  int nb = nbits_of(v);
  bits.put(dc.code[nb], dc.size[nb]);
  if (nb) bits.put(static_cast<uint32_t>(v < 0 ? v - 1 : v) & ((1u << nb) - 1), nb);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    v = blk[kNatural[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bits.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    nb = nbits_of(v);
    int sym = (run << 4) + nb;
    bits.put(ac.code[sym], ac.size[sym]);
    bits.put(static_cast<uint32_t>(v < 0 ? v - 1 : v) & ((1u << nb) - 1), nb);
    run = 0;
  }
  if (run) bits.put(ac.code[0], ac.size[0]);
}

// jfdctint.c jpeg_fdct_islow: 13 constant bits, 2 pass-1 bits; rows, then
// columns; the output is the DCT scaled by 8
const int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
              F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
              F2562 = 20995, F3072 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

void fdct_islow(int32_t* data) {
  for (int pass = 0; pass < 2; ++pass) {
    const int stride = pass == 0 ? 1 : 8, step = pass == 0 ? 8 : 1;
    const int sh = pass == 0 ? CONST_BITS - PASS1_BITS : CONST_BITS + PASS1_BITS;
    for (int i = 0; i < 8; ++i) {
      int32_t* d = data + i * step;
      int32_t tmp0 = d[0] + d[7 * stride], tmp7 = d[0] - d[7 * stride];
      int32_t tmp1 = d[stride] + d[6 * stride], tmp6 = d[stride] - d[6 * stride];
      int32_t tmp2 = d[2 * stride] + d[5 * stride], tmp5 = d[2 * stride] - d[5 * stride];
      int32_t tmp3 = d[3 * stride] + d[4 * stride], tmp4 = d[3 * stride] - d[4 * stride];
      int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        d[0] = (tmp10 + tmp11) * (1 << PASS1_BITS);
        d[4 * stride] = (tmp10 - tmp11) * (1 << PASS1_BITS);
      } else {
        d[0] = descale(tmp10 + tmp11, PASS1_BITS);
        d[4 * stride] = descale(tmp10 - tmp11, PASS1_BITS);
      }
      int32_t z1 = (tmp12 + tmp13) * F0541;
      d[2 * stride] = descale(z1 + tmp13 * F0765, sh);
      d[6 * stride] = descale(z1 - tmp12 * F1847, sh);
      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int32_t z5 = (z3 + z4) * F1175;
      tmp4 *= F0298;
      tmp5 *= F2053;
      tmp6 *= F3072;
      tmp7 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 = z3 * -F1961 + z5;
      z4 = z4 * -F0390 + z5;
      d[7 * stride] = descale(tmp4 + z1 + z3, sh);
      d[5 * stride] = descale(tmp5 + z2 + z4, sh);
      d[3 * stride] = descale(tmp6 + z2 + z3, sh);
      d[stride] = descale(tmp7 + z1 + z4, sh);
    }
  }
}

// jcdctmgr.c compute_reciprocal of the divisor 8 * q (the FDCT's scale
// folded in), as the SIMD build keeps it (16-bit DCTELEM): reciprocal,
// correction and the total shift
struct Divisors {
  uint32_t recip[64], corr[64];
  int shift[64];
  explicit Divisors(const int* q) {
    for (int i = 0; i < 64; ++i) {
      uint32_t d = 8u * static_cast<uint32_t>(q[i]);
      int b = 31 - __builtin_clz(d);
      int r = 16 + b;
      uint32_t fq = (1u << r) / d, fr = (1u << r) % d, c = d / 2;
      if (fr == 0) {  // a power of two
        fq >>= 1;
        --r;
      } else if (fr <= d / 2) {
        ++c;
      } else {
        ++fq;
      }
      recip[i] = fq;
      corr[i] = c;
      shift[i] = r;
    }
  }
};

// jcdctmgr.c forward_DCT on the block at (by, bx) of a padded plane: samples
// minus 128, the FDCT, then quantize (|x| + correction, times the
// reciprocal, shifted right, the sign put back); natural order
void forward_dct(const uint8_t* plane, int stride, int by, int bx, const Divisors& dv,
                 int16_t* out) {
  int32_t ws[64];
  for (int r = 0; r < 8; ++r) {
    const uint8_t* row = plane + static_cast<int64_t>(by * 8 + r) * stride + bx * 8;
    for (int c = 0; c < 8; ++c) ws[r * 8 + c] = static_cast<int32_t>(row[c]) - 128;
  }
  fdct_islow(ws);
  for (int i = 0; i < 64; ++i) {
    int32_t t = ws[i];
    uint32_t mag = static_cast<uint32_t>(t < 0 ? -t : t);
    uint32_t q = static_cast<uint32_t>((uint64_t(mag + dv.corr[i]) * dv.recip[i]) >> dv.shift[i]);
    out[i] = static_cast<int16_t>(t < 0 ? -static_cast<int32_t>(q) : static_cast<int32_t>(q));
  }
}

void segment(std::vector<uint8_t>& out, uint8_t marker, const std::vector<uint8_t>& body) {
  size_t len = body.size() + 2;
  out.push_back(0xFF);
  out.push_back(marker);
  out.push_back(static_cast<uint8_t>(len >> 8));
  out.push_back(static_cast<uint8_t>(len & 0xFF));
  out.insert(out.end(), body.begin(), body.end());
}

void dht(std::vector<uint8_t>& out, uint8_t cls_id, const uint8_t* bits, const uint8_t* vals,
         int nvals) {
  std::vector<uint8_t> body{cls_id};
  body.insert(body.end(), bits, bits + 16);
  body.insert(body.end(), vals, vals + nvals);
  segment(out, 0xC4, body);
}

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, errlen - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// Encodes an h x w RGB image (rows `row_stride` bytes apart, pixels 3
// bytes) at `quality` into a buffer it allocates: *out and *out_len on
// success (status 0; free it with smm_jpeg_free), status 2 with a message
// in `err` for input the encoder does not take.
int smm_jpeg_encode(const uint8_t* rgb, int h, int w, int64_t row_stride, int quality,
                    uint8_t** out, int64_t* out_len, char* err, int errlen) {
  if (h < 1 || w < 1 || h > 65535 || w > 65535) {
    set_error(err, errlen, "image size out of range");
    return 2;
  }
  if (quality < 1 || quality > 100) {
    set_error(err, errlen, "quality must be in 1..100");
    return 2;
  }
  // jcparam.c jpeg_set_quality(force_baseline=TRUE): jpeg_quality_scaling,
  // then (std * scale + 50) / 100 clamped to [1, 255]
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  int qt[2][64];
  for (int i = 0; i < 64; ++i) {
    for (int t = 0; t < 2; ++t) {
      long v = (static_cast<long>(t == 0 ? kStdLuma[i] : kStdChroma[i]) * scale + 50) / 100;
      qt[t][i] = static_cast<int>(v < 1 ? 1 : (v > 255 ? 255 : v));
    }
  }
  const Divisors dv0(qt[0]), dv1(qt[1]);
  const int mcu_rows = (h + 15) / 16, mcu_cols = (w + 15) / 16;
  const int ybh = (h + 7) / 8, ybw = (w + 7) / 8;
  // planes padded as libjpeg pads them: Y to whole blocks (expand_right_edge)
  // and to the iMCU row (the last row replicated, jcprepct.c); chroma at
  // half size over whole MCUs
  const int yh = 16 * mcu_rows, yw = 8 * ybw;
  const int ch = 8 * mcu_rows, cw = 8 * mcu_cols;
  std::vector<uint8_t> yp(static_cast<size_t>(yh) * yw), cbp(static_cast<size_t>(ch) * cw),
      crp(static_cast<size_t>(ch) * cw);
  // jccolor.c rgb_ycc_convert: 16-bit fixed point; Y rounds with ONE_HALF,
  // Cb and Cr with CBCR_OFFSET + ONE_HALF - 1
  const int32_t R_Y = 19595, G_Y = 38470, B_Y = 7471, R_CB = -11059, G_CB = -21709,
                HALF_B = 32768, R_CR = 32768, G_CR = -27439, B_CR = -5329;
  const int32_t ONE_HALF = 1 << 15, CBCR_OFFSET = 128 << 16;
  // the colour-converted rows, one extra replicated when h is odd (the row
  // group jcprepct.c fills), each expand_right_edge'd to 2 * cw
  const int even = h + (h & 1), cwide = 2 * cw;
  std::vector<uint8_t> cbf(static_cast<size_t>(even) * cwide), crf(static_cast<size_t>(even) * cwide);
  for (int r = 0; r < h; ++r) {
    const uint8_t* src = rgb + static_cast<int64_t>(r) * row_stride;
    uint8_t* yrow = yp.data() + static_cast<size_t>(r) * yw;
    uint8_t* cbrow = cbf.data() + static_cast<size_t>(r) * cwide;
    uint8_t* crrow = crf.data() + static_cast<size_t>(r) * cwide;
    for (int c = 0; c < w; ++c) {
      int32_t R = src[3 * c], G = src[3 * c + 1], B = src[3 * c + 2];
      yrow[c] = static_cast<uint8_t>((R_Y * R + G_Y * G + B_Y * B + ONE_HALF) >> 16);
      cbrow[c] = static_cast<uint8_t>(
          (R_CB * R + G_CB * G + HALF_B * B + CBCR_OFFSET + ONE_HALF - 1) >> 16);
      crrow[c] = static_cast<uint8_t>(
          (R_CR * R + G_CR * G + B_CR * B + CBCR_OFFSET + ONE_HALF - 1) >> 16);
    }
    for (int c = w; c < yw; ++c) yrow[c] = yrow[w - 1];
    for (int c = w; c < cwide; ++c) {
      cbrow[c] = cbrow[w - 1];
      crrow[c] = crrow[w - 1];
    }
  }
  for (int r = h; r < yh; ++r)
    std::memcpy(yp.data() + static_cast<size_t>(r) * yw,
                yp.data() + static_cast<size_t>(h - 1) * yw, yw);
  if (even != h) {
    std::memcpy(cbf.data() + static_cast<size_t>(h) * cwide,
                cbf.data() + static_cast<size_t>(h - 1) * cwide, cwide);
    std::memcpy(crf.data() + static_cast<size_t>(h) * cwide,
                crf.data() + static_cast<size_t>(h - 1) * cwide, cwide);
  }
  // jcsample.c h2v2_downsample: the bias alternates 1, 2 along a row; then
  // the output padded to the iMCU row by replicating its last row
  const int crows = even / 2;
  for (int t = 0; t < 2; ++t) {
    const std::vector<uint8_t>& full = t == 0 ? cbf : crf;
    std::vector<uint8_t>& dst = t == 0 ? cbp : crp;
    for (int r = 0; r < crows; ++r) {
      const uint8_t* a = full.data() + static_cast<size_t>(2 * r) * cwide;
      const uint8_t* b = a + cwide;
      uint8_t* o = dst.data() + static_cast<size_t>(r) * cw;
      int bias = 1;
      for (int c = 0; c < cw; ++c) {
        o[c] = static_cast<uint8_t>((a[2 * c] + a[2 * c + 1] + b[2 * c] + b[2 * c + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
    for (int r = crows; r < ch; ++r)
      std::memcpy(dst.data() + static_cast<size_t>(r) * cw,
                  dst.data() + static_cast<size_t>(crows - 1) * cw, cw);
  }

  std::vector<uint8_t> buf;
  buf.reserve(static_cast<size_t>(h) * w / 2 + 1024);
  // jcmarker.c: SOI, APP0 JFIF 1.01, DQT per table (zigzag), SOF0, DHT DC0,
  // AC0, DC1, AC1, SOS
  buf.push_back(0xFF);
  buf.push_back(0xD8);
  segment(buf, 0xE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
  for (int t = 0; t < 2; ++t) {
    std::vector<uint8_t> body{static_cast<uint8_t>(t)};
    for (int k = 0; k < 64; ++k) body.push_back(static_cast<uint8_t>(qt[t][kNatural[k]]));
    segment(buf, 0xDB, body);
  }
  segment(buf, 0xC0,
          {8, static_cast<uint8_t>(h >> 8), static_cast<uint8_t>(h & 0xFF),
           static_cast<uint8_t>(w >> 8), static_cast<uint8_t>(w & 0xFF), 3, 1, 0x22, 0, 2, 0x11,
           1, 3, 0x11, 1});
  dht(buf, 0x00, kDcLumaBits, kDcVals, 12);
  dht(buf, 0x10, kAcLumaBits, kAcLumaVals, 162);
  dht(buf, 0x01, kDcChromaBits, kDcVals, 12);
  dht(buf, 0x11, kAcChromaBits, kAcChromaVals, 162);
  segment(buf, 0xDA, {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0});

  const Huff dcl(kDcLumaBits, kDcVals), acl(kAcLumaBits, kAcLumaVals);
  const Huff dcc(kDcChromaBits, kDcVals), acc(kAcChromaBits, kAcChromaVals);
  Bits bits(buf);
  int last[3] = {0, 0, 0};
  int16_t mcu[4][64], blk[64];
  for (int mr = 0; mr < mcu_rows; ++mr) {
    for (int mc = 0; mc < mcu_cols; ++mc) {
      // jccoefct.c compress_data: a block past the component's last block
      // column or row is a dummy, zero but for a DC copied from the block
      // before it in the MCU
      for (int dy = 0; dy < 2; ++dy) {
        for (int dx = 0; dx < 2; ++dx) {
          int n = dy * 2 + dx, by = 2 * mr + dy, bx = 2 * mc + dx;
          if (by < ybh && bx < ybw) {
            forward_dct(yp.data(), yw, by, bx, dv0, mcu[n]);
          } else {
            std::memset(mcu[n], 0, sizeof(mcu[n]));
            mcu[n][0] = mcu[n - 1][0];
          }
        }
      }
      for (int n = 0; n < 4; ++n) {
        encode_block(bits, mcu[n], last[0], dcl, acl);
        last[0] = mcu[n][0];
      }
      for (int t = 0; t < 2; ++t) {
        forward_dct(t == 0 ? cbp.data() : crp.data(), cw, mr, mc, dv1, blk);
        encode_block(bits, blk, last[1 + t], dcc, acc);
        last[1 + t] = blk[0];
      }
    }
  }
  bits.flush();
  buf.push_back(0xFF);
  buf.push_back(0xD9);
  uint8_t* mem = new uint8_t[buf.size()];
  std::memcpy(mem, buf.data(), buf.size());
  *out = mem;
  *out_len = static_cast<int64_t>(buf.size());
  return 0;
}

void smm_jpeg_free(uint8_t* p) { delete[] p; }

}  // extern "C"
