// PNG pixel decoder whose RGB output equals PIL's byte for byte.
//
// The caller (smmdax_torch/data/native.py) walks the chunks and inflates
// the IDAT stream with Python's zlib; this file takes the inflated bytes
// and does the rest, as Pillow's PNG plugin and its conversion to RGB do:
//
// * the five row filters (None, Sub, Up, Average, Paeth) over
//   max(1, bits per pixel / 8) bytes;
// * Adam7 de-interlacing: seven passes, each filtered on its own, a pass
//   that is empty at a width or height under 8 carrying no rows;
// * samples to RGB: grey at 1 / 2 / 4 bits scaled x255 / x85 / x17 (PIL's
//   "1", "L;2", "L;4"), 16-bit grey clipped to 255 ("I;16" -> RGB), 16-bit
//   RGB, RGBA and grey+alpha by their high byte, palette indices at 1 / 2 /
//   4 / 8 bits through the 256-entry palette the caller passes (black past
//   the PLTE chunk's entries), alpha and tRNS dropped.
//
// Corrupt input fails with status 2 and a reason: short image data and
// unknown filter types.  Plain C interface for ctypes; a call holds no
// global state, so threads may decode side by side.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kMalformed = 2;

struct Failure {
  int code;
  std::string msg;
};

[[noreturn]] void malformed(const std::string& msg) { throw Failure{kMalformed, msg}; }

inline int channels(int color) {
  switch (color) {
    case 0: case 3: return 1;
    case 2: return 3;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

bool depth_ok(int color, int depth) {
  switch (color) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// one row in place: `row` of `n` bytes after its filter byte, `prior` the
// row above (unfiltered; zeros for a pass's first row)
void unfilter(int kind, uint8_t* row, const uint8_t* prior, size_t n, size_t bpp) {
  switch (kind) {
    case 0:
      return;
    case 1:
      for (size_t i = bpp; i < n; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - bpp]);
      return;
    case 2:
      for (size_t i = 0; i < n; ++i) row[i] = static_cast<uint8_t>(row[i] + prior[i]);
      return;
    case 3:
      for (size_t i = 0; i < n; ++i) {
        int left = i >= bpp ? row[i - bpp] : 0;
        row[i] = static_cast<uint8_t>(row[i] + ((left + prior[i]) >> 1));
      }
      return;
    case 4:
      for (size_t i = 0; i < n; ++i) {
        int left = i >= bpp ? row[i - bpp] : 0, up_left = i >= bpp ? prior[i - bpp] : 0;
        row[i] = static_cast<uint8_t>(row[i] + paeth(left, prior[i], up_left));
      }
      return;
    default:
      malformed("unknown PNG filter type " + std::to_string(kind));
  }
}

// the RGB of pixel x of an unfiltered row
inline void pixel(const uint8_t* row, int x, int color, int depth, const uint8_t* palette,
                  uint8_t* o) {
  if (depth < 8) {   // grey or palette, 1 / 2 / 4 bits, most significant first
    int per = 8 / depth, shift = 8 - depth * (x % per + 1);
    int v = (row[x / per] >> shift) & ((1 << depth) - 1);
    if (color == 3) {
      std::memcpy(o, palette + 3 * v, 3);
    } else {
      o[0] = o[1] = o[2] = static_cast<uint8_t>(v * (255 / ((1 << depth) - 1)));
    }
    return;
  }
  int step = depth / 8;
  const uint8_t* p = row + static_cast<size_t>(x) * channels(color) * step;
  switch (color) {
    case 0:
      o[0] = o[1] = o[2] = step == 1 ? p[0] : (p[0] == 0 ? p[1] : 255);
      return;
    case 3:
      std::memcpy(o, palette + 3 * p[0], 3);
      return;
    case 4:
      o[0] = o[1] = o[2] = p[0];
      return;
    default:   // 2, 6: the high byte of each sample
      o[0] = p[0];
      o[1] = p[step];
      o[2] = p[2 * step];
  }
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
}

}  // namespace

extern "C" {

// The inflated IDAT bytes `raw` of a width x height PNG of bit `depth`,
// colour type `color` and `interlace` method, with `palette` 256 x 3 RGB
// entries, to height x width x 3 RGB bytes at `out`.
int smm_png_decode(const uint8_t* raw, int64_t rawlen, int width, int height, int depth,
                   int color, int interlace, const uint8_t* palette, uint8_t* out, char* err,
                   int errlen) {
  static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                   {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  static const int kWhole[1][4] = {{0, 0, 1, 1}};
  try {
    if (width <= 0 || height <= 0) malformed("PNG of zero size");
    if (!depth_ok(color, depth))
      malformed("PNG of bit depth " + std::to_string(depth) + " and colour type " +
                std::to_string(color));
    if (interlace != 0 && interlace != 1) malformed("unknown PNG interlace method");
    const int bits = channels(color) * depth;
    const size_t bpp = bits >= 8 ? static_cast<size_t>(bits / 8) : 1;
    const int (*passes)[4] = interlace ? kAdam7 : kWhole;
    const int npasses = interlace ? 7 : 1;
    size_t pos = 0;
    std::vector<uint8_t> prior, row;
    for (int p = 0; p < npasses; ++p) {
      const int xo = passes[p][0], yo = passes[p][1], dx = passes[p][2], dy = passes[p][3];
      const int pw = width > xo ? (width - xo + dx - 1) / dx : 0;
      const int ph = height > yo ? (height - yo + dy - 1) / dy : 0;
      if (pw == 0 || ph == 0) continue;   // an empty pass has no rows, not even filter bytes
      const size_t n = (static_cast<size_t>(pw) * bits + 7) / 8;
      if (static_cast<uint64_t>(rawlen) - pos < (n + 1) * static_cast<uint64_t>(ph))
        malformed("truncated PNG image data");
      prior.assign(n, 0);
      row.resize(n);
      for (int y = 0; y < ph; ++y) {
        int kind = raw[pos];
        std::memcpy(row.data(), raw + pos + 1, n);
        pos += n + 1;
        unfilter(kind, row.data(), prior.data(), n, bpp);
        uint8_t* o = out + (static_cast<size_t>(yo + y * dy) * width + xo) * 3;
        for (int x = 0; x < pw; ++x) pixel(row.data(), x, color, depth, palette, o + 3 * x * dx);
        prior.swap(row);
      }
    }
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
