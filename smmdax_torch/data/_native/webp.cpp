// WebP decoder whose RGB output equals PIL's byte for byte.
//
// PIL decodes webp with libwebp at its defaults, and a still image's RGB
// is fixed by the two bitstream specifications plus libwebp's output
// stage, which this file reproduces:
//
// * the RIFF container: a simple lossy ("VP8 "), simple lossless ("VP8L")
//   or extended ("VP8X") file.  ICCP, EXIF, XMP, ALPH and unknown chunks
//   are skipped (the alpha plane does not change the RGB that
//   convert("RGB") keeps).  Of an animation (ANIM, ANMF), the first frame
//   on its canvas, as libwebp's WebPAnimDecoder composes frame 0.
// * VP8L, lossless (RFC 9649): the predictor, cross-colour,
//   subtract-green and colour-indexing transforms, the colour cache, meta
//   prefix codes and LZ77 backward references.  Exact by definition.
// * VP8, lossy key frames (RFC 6386), which the spec defines bit-exactly,
//   with libwebp's choices where it has them: no inner-edge filtering of a
//   macroblock whose coefficients are all zero (unless it is B_PRED), no
//   loop filter at all when the frame's filter level is 0, intra
//   prediction from the unfiltered reconstruction.
// * libwebp's output: "fancy" upsampling of U and V (the 9-3-3-1 filter
//   of dsp/upsampling.c, the first and last rows mirrored) and the 14-bit
//   fixed-point YUV -> RGB of dsp/yuv.h; no dithering (PIL asks none).
//
// Corrupt input fails with status 2 and a reason: every chunk size, table
// index and copy is checked, bit readers feed zeros past their buffer and
// the decoder then refuses, so nothing reads past the input.
//
// Plain C interface for ctypes; a call holds no global state, so threads
// may decode side by side.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kMalformed = 2;
constexpr int64_t kMaxPixels = 178956970;   // 2 * PIL's Image.MAX_IMAGE_PIXELS

struct Failure {
  int code;
  std::string msg;
};

[[noreturn]] void malformed(const std::string& msg) { throw Failure{kMalformed, msg}; }

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) { return le24(p) | (static_cast<uint32_t>(p[3]) << 24); }

// ---------------------------------------------------------------------------
// Tables.  kCodeToPlane is RFC 9649's distance map, each (dx, dy) stored as
// (dy << 4) | (8 - dx); the rest are RFC 6386's.

const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
const uint8_t kCoeffsProba0[1056] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
const uint8_t kCoeffsUpdateProba[1056] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kBModesProba[900] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// ---------------------------------------------------------------------------
// The container.

struct Bitstream {
  bool lossless = false;
  const uint8_t* data = nullptr;
  size_t size = 0;
  int canvas_w = 0, canvas_h = 0;   // from VP8X, 0 without it
  bool animated = false;            // the first ANMF frame's bitstream, at its offset
  int frame_x = 0, frame_y = 0;
};

// the image chunk ("VP8 " or "VP8L") among the chunks of [pos, end),
// skipping ALPH and unknown ones; false if there is none
bool image_chunk(const uint8_t* d, size_t pos, size_t end, Bitstream& bs) {
  while (end - pos >= 8) {
    const uint8_t* tag = d + pos;
    uint32_t size = le32(d + pos + 4);
    if (size > end - pos - 8) malformed("truncated file: chunk past the end of the data");
    if (!std::memcmp(tag, "VP8 ", 4) || !std::memcmp(tag, "VP8L", 4)) {
      bs.lossless = tag[3] == 'L';
      bs.data = d + pos + 8;
      bs.size = size;
      return true;
    }
    size_t step = 8 + static_cast<size_t>(size) + (size & 1);
    if (step > end - pos) malformed("truncated file: chunk padding past the end of the data");
    pos += step;
  }
  return false;
}

Bitstream parse_container(const uint8_t* d, size_t n) {
  if (n < 12 || std::memcmp(d, "RIFF", 4) != 0 || std::memcmp(d + 8, "WEBP", 4) != 0)
    malformed("not a RIFF WEBP file");
  uint32_t riff = le32(d + 4);
  if (riff < 12) malformed("RIFF size too small");
  if (riff > n - 8) malformed("truncated file: RIFF size past the end of the data");
  size_t end = 8 + static_cast<size_t>(riff);   // bytes past the RIFF payload are ignored
  size_t pos = 12;
  Bitstream bs;
  bool first = true, anim_flag = false, anim_chunk = false;
  while (true) {
    if (end - pos < 8) malformed("truncated file: no VP8 or VP8L chunk");
    const uint8_t* tag = d + pos;
    uint32_t size = le32(d + pos + 4);
    if (size > end - pos - 8) malformed("truncated file: chunk past the end of the data");
    const uint8_t* body = d + pos + 8;
    if (!std::memcmp(tag, "VP8 ", 4) || !std::memcmp(tag, "VP8L", 4)) {
      if (anim_flag) malformed("image chunk outside the frames of an animation");
      bs.lossless = tag[3] == 'L';
      bs.data = body;
      bs.size = size;
      return bs;
    }
    if (!std::memcmp(tag, "ANIM", 4)) {
      if (size < 6) malformed("bad ANIM chunk size");
      anim_chunk = true;   // its background colour and loop count do not change frame 0
    } else if (!std::memcmp(tag, "ANMF", 4)) {
      // libwebp's demux: ANIM first, the VP8X animation flag set, the
      // frame's size its bitstream's, inside the canvas
      if (!anim_flag || !anim_chunk) malformed("ANMF chunk outside an animation");
      if (size < 16) malformed("bad ANMF chunk size");
      bs.animated = true;
      bs.frame_x = 2 * static_cast<int>(le24(body));
      bs.frame_y = 2 * static_cast<int>(le24(body + 3));
      if (!image_chunk(d, pos + 8 + 16, pos + 8 + size, bs))
        malformed("ANMF frame without an image chunk");
      return bs;
    } else if (!std::memcmp(tag, "VP8X", 4)) {
      if (!first) malformed("VP8X chunk not first");
      if (size != 10) malformed("bad VP8X chunk size");
      anim_flag = body[0] & 0x02;
      bs.canvas_w = static_cast<int>(le24(body + 4)) + 1;
      bs.canvas_h = static_cast<int>(le24(body + 7)) + 1;
      if (static_cast<int64_t>(bs.canvas_w) * bs.canvas_h > kMaxPixels)
        malformed("canvas of more pixels than PIL opens");
    } else if (first) {
      malformed("unknown first chunk");
    }
    first = false;
    size_t step = 8 + static_cast<size_t>(size) + (size & 1);
    if (step > end - pos) malformed("truncated file: chunk padding past the end of the data");
    pos += step;
  }
}

// ---------------------------------------------------------------------------
// VP8L, lossless.

// Bits least significant first; zeros past the end, where `eos` turns true
// once a bit there is consumed.
struct LBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  uint64_t val = 0;
  int nbits = 0;
  uint64_t consumed = 0;

  LBits(const uint8_t* data, size_t size) : p(data), n(size) {}

  void fill() {
    while (nbits <= 56) {
      uint64_t byte = pos < n ? p[pos] : 0;
      ++pos;
      val |= byte << nbits;
      nbits += 8;
    }
  }
  uint32_t peek(int k) {   // k <= 32
    if (nbits < k) fill();
    return static_cast<uint32_t>(val & ((uint64_t{1} << k) - 1));
  }
  void skip(int k) {
    val >>= k;
    nbits -= k;
    consumed += k;
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
  bool eos() const { return consumed > 8 * static_cast<uint64_t>(n); }
};

constexpr int kMaxCodeLength = 15;
constexpr int kRootBits = 8;

// A canonical prefix code: codes of up to kRootBits from a lookup on the
// next bits, longer ones bit by bit; a one-symbol code takes no bits.
struct Huffman {
  int single = -1;
  uint32_t root[1 << kRootBits];   // (length << 16) | symbol; length 0: longer code
  uint16_t count[kMaxCodeLength + 1];
  std::vector<uint16_t> sorted;

  // false where libwebp's VP8LBuildHuffmanTable refuses: no symbol, a
  // length past 15, or a code that is not complete
  bool build(const int* lengths, int n) {
    std::memset(count, 0, sizeof count);
    int nsym = 0;
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > kMaxCodeLength || lengths[s] < 0) return false;
      if (lengths[s]) {
        ++count[lengths[s]];
        ++nsym;
        single = s;
      }
    }
    if (nsym == 0) return false;
    if (nsym == 1) return true;
    single = -1;
    int64_t left = 1;
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      left = 2 * left - count[len];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    uint16_t offset[kMaxCodeLength + 2];
    offset[1] = 0;
    for (int len = 1; len <= kMaxCodeLength; ++len) offset[len + 1] = offset[len] + count[len];
    sorted.assign(nsym, 0);
    for (int s = 0; s < n; ++s)
      if (lengths[s]) sorted[offset[lengths[s]]++] = static_cast<uint16_t>(s);
    // root table: canonical codes, bit-reversed since the stream is read
    // least significant bit first
    std::memset(root, 0, sizeof root);
    uint32_t code = 0;
    int k = 0;
    for (int len = 1; len <= kRootBits; ++len) {
      for (int i = 0; i < count[len]; ++i, ++k, ++code) {
        uint32_t rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (uint32_t j = rev; j < (1u << kRootBits); j += 1u << len)
          root[j] = (static_cast<uint32_t>(len) << 16) | sorted[k];
      }
      code <<= 1;
    }
    return true;
  }

  int read(LBits& br) const {
    if (single >= 0) return single;
    uint32_t e = root[br.peek(kRootBits)];
    if (e >> 16) {
      br.skip(static_cast<int>(e >> 16));
      return static_cast<int>(e & 0xffff);
    }
    uint32_t bits = br.peek(kMaxCodeLength);
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      code |= (bits >> (len - 1)) & 1;
      int c = count[len];
      if (code - first < c) {
        br.skip(len);
        return sorted[index + code - first];
      }
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    return 0;   // not reached: the code is complete
  }
};

constexpr int kNumLiteralCodes = 256;
constexpr int kNumLengthCodes = 24;
constexpr int kNumDistanceCodes = 40;
constexpr int kMaxCacheBits = 11;
const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

struct HGroup {
  Huffman codes[5];   // green (+ lengths + cache), red, blue, alpha, distance
};

struct Transform {
  int type;
  int bits = 0;
  int xsize = 0;
  std::vector<uint32_t> data;
};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

class VP8LDecoder {
 public:
  VP8LDecoder(const uint8_t* d, size_t n) : br_(d, n) {}

  void header(int& w, int& h) {
    if (br_.read(8) != 0x2f) malformed("bad VP8L signature");
    w = static_cast<int>(br_.read(14)) + 1;
    h = static_cast<int>(br_.read(14)) + 1;
    br_.read(1);   // alpha hint
    if (br_.read(3) != 0) malformed("bad VP8L version");
  }

  // ARGB of the whole image, w x h
  std::vector<uint32_t> decode(int w, int h) {
    std::vector<uint32_t> out;
    stream(w, h, true, out);
    return out;
  }

 private:
  LBits br_;
  unsigned seen_ = 0;
  std::vector<Transform> transforms_;
  std::vector<int> lengths_;

  void check() {
    if (br_.eos()) malformed("truncated VP8L bitstream");
  }

  void read_code(int alphabet, Huffman& h) {
    lengths_.assign(std::max(alphabet, 256), 0);
    if (br_.read(1)) {   // simple code: one or two symbols of length 1
      int nsym = static_cast<int>(br_.read(1)) + 1;
      int first_bits = br_.read(1) ? 8 : 1;
      lengths_[br_.read(first_bits)] = 1;
      if (nsym == 2) lengths_[br_.read(8)] = 1;
    } else {
      int cl_lengths[19] = {0};
      int ncodes = static_cast<int>(br_.read(4)) + 4;
      for (int i = 0; i < ncodes; ++i) cl_lengths[kCodeLengthOrder[i]] = br_.read(3);
      Huffman cl;
      if (!cl.build(cl_lengths, 19)) malformed("bad code-length code");
      int max_symbol = alphabet;
      if (br_.read(1)) {
        int nbits = 2 + 2 * static_cast<int>(br_.read(3));
        max_symbol = 2 + static_cast<int>(br_.read(nbits));
        if (max_symbol > alphabet) malformed("bad max_symbol");
      }
      int prev = 8;
      int s = 0;
      while (s < alphabet) {
        if (max_symbol-- == 0) break;
        int len = cl.read(br_);
        if (len < 16) {
          lengths_[s++] = len;
          if (len) prev = len;
        } else {
          static const int kExtra[3] = {2, 3, 7};
          static const int kOffset[3] = {3, 3, 11};
          int repeat = static_cast<int>(br_.read(kExtra[len - 16])) + kOffset[len - 16];
          if (s + repeat > alphabet) malformed("code lengths past the alphabet");
          int v = len == 16 ? prev : 0;
          while (repeat-- > 0) lengths_[s++] = v;
        }
        check();
      }
    }
    check();
    if (!h.build(lengths_.data(), alphabet)) malformed("bad prefix code");
  }

  // the prefix-code groups of an image of xsize x ysize; the entropy image
  // (group of each tile) when meta codes are allowed and present
  void read_codes(int xsize, int ysize, int cache_bits, bool allow_meta, std::vector<HGroup>& groups,
                  std::vector<uint32_t>& meta, int& meta_bits, int& meta_xsize) {
    meta_bits = 0;
    meta_xsize = 0;
    meta.clear();
    int ngroups = 1;
    if (allow_meta && br_.read(1)) {
      meta_bits = static_cast<int>(br_.read(3)) + 2;
      meta_xsize = subsample(xsize, meta_bits);
      int meta_ysize = subsample(ysize, meta_bits);
      stream(meta_xsize, meta_ysize, false, meta);
      for (auto& g : meta) {
        g = (g >> 8) & 0xffff;
        ngroups = std::max(ngroups, static_cast<int>(g) + 1);
      }
    }
    // groups the entropy image names get a slot; the others are read and
    // dropped (as libwebp does)
    std::vector<int> slot(ngroups, -1);
    int used = 0;
    if (meta.empty()) {
      slot[0] = used++;
    } else {
      for (auto& g : meta) {
        if (slot[g] < 0) slot[g] = used++;
        g = static_cast<uint32_t>(slot[g]);
      }
    }
    groups.assign(used, HGroup());
    HGroup scratch;
    const int alphabets[5] = {kNumLiteralCodes + kNumLengthCodes + (cache_bits ? 1 << cache_bits : 0),
                              256, 256, 256, kNumDistanceCodes};
    for (int g = 0; g < ngroups; ++g) {
      HGroup& dst = slot[g] >= 0 ? groups[slot[g]] : scratch;
      for (int j = 0; j < 5; ++j) read_code(alphabets[j], dst.codes[j]);
    }
  }

  void read_transform(int& xsize, int ysize) {
    int type = static_cast<int>(br_.read(2));
    if (seen_ & (1u << type)) malformed("transform repeated");
    seen_ |= 1u << type;
    Transform t;
    t.type = type;
    t.xsize = xsize;
    if (type == 0 || type == 1) {   // predictor, cross-colour
      t.bits = static_cast<int>(br_.read(3)) + 2;
      stream(subsample(xsize, t.bits), subsample(ysize, t.bits), false, t.data);
    } else if (type == 3) {          // colour indexing
      int ncolors = static_cast<int>(br_.read(8)) + 1;
      t.bits = ncolors > 16 ? 0 : ncolors > 4 ? 1 : ncolors > 2 ? 2 : 3;
      std::vector<uint32_t> pal;
      stream(ncolors, 1, false, pal);
      // palette deltas undone per byte; entries past ncolors transparent black
      t.data.assign(static_cast<size_t>(1) << (8 >> t.bits), 0);
      for (int i = 0; i < ncolors; ++i) {
        uint32_t c = pal[i];
        if (i > 0) {
          uint32_t p = t.data[i - 1];
          c = (((c & 0xff00ff00u) + (p & 0xff00ff00u)) & 0xff00ff00u) |
              (((c & 0x00ff00ffu) + (p & 0x00ff00ffu)) & 0x00ff00ffu);
        }
        t.data[i] = c;
      }
      xsize = subsample(xsize, t.bits);
    }
    transforms_.push_back(std::move(t));
  }

  void stream(int xsize, int ysize, bool level0, std::vector<uint32_t>& out) {
    int tx = xsize;
    if (level0) {
      while (br_.read(1)) {
        if (transforms_.size() >= 4) malformed("too many transforms");
        read_transform(tx, ysize);
        check();
      }
    }
    int cache_bits = 0;
    if (br_.read(1)) {
      cache_bits = static_cast<int>(br_.read(4));
      if (cache_bits < 1 || cache_bits > kMaxCacheBits) malformed("bad colour cache size");
    }
    std::vector<HGroup> groups;
    std::vector<uint32_t> meta;
    int meta_bits, meta_xsize;
    read_codes(tx, ysize, cache_bits, level0, groups, meta, meta_bits, meta_xsize);
    check();
    out.assign(static_cast<size_t>(tx) * ysize, 0);
    pixels(out.data(), tx, ysize, cache_bits, groups, meta, meta_bits, meta_xsize);
    if (level0) {
      for (int i = static_cast<int>(transforms_.size()) - 1; i >= 0; --i)
        inverse(transforms_[i], ysize, out);
    }
  }

  static inline uint32_t prefix_value(int symbol, LBits& br) {
    if (symbol < 4) return static_cast<uint32_t>(symbol) + 1;
    int extra = (symbol - 2) >> 1;
    uint32_t offset = static_cast<uint32_t>(2 + (symbol & 1)) << extra;
    return offset + br.read(extra) + 1;
  }

  void pixels(uint32_t* data, int w, int h, int cache_bits, const std::vector<HGroup>& groups,
              const std::vector<uint32_t>& meta, int meta_bits, int meta_xsize) {
    const size_t total = static_cast<size_t>(w) * h;
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
    const int shift = 32 - cache_bits;
    auto insert = [&](uint32_t argb) {
      if (cache_size) cache[(argb * 0x1e35a7bdu) >> shift] = argb;
    };
    size_t pos = 0;
    int x = 0, y = 0;
    while (pos < total) {
      const HGroup& g = meta.empty()
          ? groups[0]
          : groups[meta[static_cast<size_t>(y >> meta_bits) * meta_xsize + (x >> meta_bits)]];
      int code = g.codes[0].read(br_);
      if (code < kNumLiteralCodes) {
        uint32_t r = g.codes[1].read(br_);
        uint32_t b = g.codes[2].read(br_);
        uint32_t a = g.codes[3].read(br_);
        uint32_t argb = (a << 24) | (r << 16) | (static_cast<uint32_t>(code) << 8) | b;
        data[pos++] = argb;
        insert(argb);
        if (++x == w) {
          x = 0;
          ++y;
        }
      } else if (code < kNumLiteralCodes + kNumLengthCodes) {
        uint32_t length = prefix_value(code - kNumLiteralCodes, br_);
        int dsym = g.codes[4].read(br_);
        uint32_t dcode = prefix_value(dsym, br_);
        int64_t dist;
        if (dcode > 120) {
          dist = static_cast<int64_t>(dcode) - 120;
        } else {
          int c = kCodeToPlane[dcode - 1];
          dist = static_cast<int64_t>(c >> 4) * w + (8 - (c & 0xf));
          if (dist < 1) dist = 1;
        }
        if (br_.eos()) break;
        if (static_cast<int64_t>(pos) < dist || total - pos < length)
          malformed("backward reference out of the image");
        for (uint32_t i = 0; i < length; ++i, ++pos) {
          data[pos] = data[pos - dist];
          insert(data[pos]);
        }
        x += static_cast<int>(length % static_cast<uint32_t>(w));
        y += static_cast<int>(length / static_cast<uint32_t>(w));
        if (x >= w) {
          x -= w;
          ++y;
        }
      } else if (code < kNumLiteralCodes + kNumLengthCodes + cache_size) {
        uint32_t argb = cache[code - kNumLiteralCodes - kNumLengthCodes];
        data[pos++] = argb;
        insert(argb);
        if (++x == w) {
          x = 0;
          ++y;
        }
      } else {
        malformed("bad literal code");
      }
      if (br_.eos()) break;
    }
    check();
  }

  static inline uint32_t add(uint32_t a, uint32_t b) {
    return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
           (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
  }
  static inline uint32_t avg2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
  }
  static inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
  static inline uint32_t select(uint32_t t, uint32_t l, uint32_t tl) {
    int d = 0;
    for (int s = 0; s < 32; s += 8) {
      int a = (t >> s) & 0xff, b = (l >> s) & 0xff, c = (tl >> s) & 0xff;
      d += std::abs(b - c) - std::abs(a - c);
    }
    return d <= 0 ? t : l;
  }
  static inline uint32_t add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t o = 0;
    for (int s = 0; s < 32; s += 8)
      o |= static_cast<uint32_t>(clip255(static_cast<int>((a >> s) & 0xff) +
                                         static_cast<int>((b >> s) & 0xff) -
                                         static_cast<int>((c >> s) & 0xff))) << s;
    return o;
  }
  static inline uint32_t add_sub_half(uint32_t a, uint32_t b) {
    uint32_t o = 0;
    for (int s = 0; s < 32; s += 8) {
      int x = (a >> s) & 0xff, y = (b >> s) & 0xff;
      o |= static_cast<uint32_t>(clip255(x + (x - y) / 2)) << s;
    }
    return o;
  }

  static uint32_t predict(int mode, const uint32_t* cur, const uint32_t* top) {
    // cur points at the pixel, top at the pixel above it
    const uint32_t L = cur[-1], T = top[0], TL = top[-1], TR = top[1];
    switch (mode) {
      case 0: return 0xff000000u;
      case 1: return L;
      case 2: return T;
      case 3: return TR;
      case 4: return TL;
      case 5: return avg2(avg2(L, TR), T);
      case 6: return avg2(L, TL);
      case 7: return avg2(L, T);
      case 8: return avg2(TL, T);
      case 9: return avg2(T, TR);
      case 10: return avg2(avg2(L, TL), avg2(T, TR));
      case 11: return select(T, L, TL);
      case 12: return add_sub_full(L, T, TL);
      case 13: return add_sub_half(avg2(L, T), TL);
      default: return 0xff000000u;   // 14, 15: black, as libwebp
    }
  }

  static void inverse(const Transform& t, int h, std::vector<uint32_t>& px) {
    const int w = t.xsize;
    if (t.type == 0) {   // predictor, in place: predictions read decoded pixels
      uint32_t* d = px.data();
      d[0] = add(d[0], 0xff000000u);
      for (int x = 1; x < w; ++x) d[x] = add(d[x], d[x - 1]);
      const int tiles = subsample(w, t.bits);
      for (int y = 1; y < h; ++y) {
        uint32_t* row = d + static_cast<size_t>(y) * w;
        const uint32_t* modes = t.data.data() + static_cast<size_t>(y >> t.bits) * tiles;
        row[0] = add(row[0], row[-w]);
        for (int x = 1; x < w; ++x) {
          int mode = (modes[x >> t.bits] >> 8) & 0xf;
          row[x] = add(row[x], predict(mode, row + x, row + x - w));
        }
      }
    } else if (t.type == 1) {   // cross-colour
      const int tiles = subsample(w, t.bits);
      for (int y = 0; y < h; ++y) {
        uint32_t* row = px.data() + static_cast<size_t>(y) * w;
        const uint32_t* codes = t.data.data() + static_cast<size_t>(y >> t.bits) * tiles;
        for (int x = 0; x < w; ++x) {
          uint32_t m = codes[x >> t.bits];
          int g2r = static_cast<int8_t>(m & 0xff), g2b = static_cast<int8_t>((m >> 8) & 0xff),
              r2b = static_cast<int8_t>((m >> 16) & 0xff);
          uint32_t argb = row[x];
          int green = static_cast<int8_t>((argb >> 8) & 0xff);
          int red = (argb >> 16) & 0xff, blue = argb & 0xff;
          red = (red + ((g2r * green) >> 5)) & 0xff;
          blue += (g2b * green) >> 5;
          blue += (r2b * static_cast<int8_t>(red)) >> 5;
          blue &= 0xff;
          row[x] = (argb & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) |
                   static_cast<uint32_t>(blue);
        }
      }
    } else if (t.type == 2) {   // subtract green
      for (auto& argb : px) {
        uint32_t g = (argb >> 8) & 0xff;
        uint32_t rb = ((argb & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
        argb = (argb & 0xff00ff00u) | rb;
      }
    } else {   // colour indexing, with 8 >> bits bits per packed index
      const int sw = subsample(w, t.bits);
      std::vector<uint32_t> out(static_cast<size_t>(w) * h);
      const int bpp = 8 >> t.bits;
      const uint32_t mask = (1u << bpp) - 1;
      const int per = 1 << t.bits;
      for (int y = 0; y < h; ++y) {
        const uint32_t* src = px.data() + static_cast<size_t>(y) * sw;
        uint32_t* dst = out.data() + static_cast<size_t>(y) * w;
        uint32_t packed = 0;
        for (int x = 0; x < w; ++x) {
          if ((x & (per - 1)) == 0) packed = (src[x >> t.bits] >> 8) & 0xff;
          dst[x] = t.data[packed & mask];
          packed >>= bpp;
        }
      }
      px.swap(out);
    }
  }
};

// ---------------------------------------------------------------------------
// VP8, lossy.

// The boolean decoder, as libwebp's VP8BitReader: `range` holds range - 1,
// `bits` the count of buffered bits past the 8 in use; past the end it
// feeds zeros and sets `eof`.
struct BoolDecoder {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  uint32_t range = 255 - 1;
  int bits = -8;
  bool eof = false;

  void init(const uint8_t* p, size_t n) {
    buf = p;
    end = p + n;
    value = 0;
    range = 255 - 1;
    bits = -8;
    eof = false;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = (value << 8) | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t v = static_cast<uint32_t>(value >> pos);
    int bit;
    if (v > split) {
      r -= split;
      value -= static_cast<uint64_t>(split + 1) << pos;
      bit = 1;
    } else {
      r = split + 1;
      bit = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  int literal(int n) {
    int v = 0;
    while (n-- > 0) v |= get(0x80) << n;
    return v;
  }
  int signed_literal(int n) {
    int v = literal(n);
    return get(0x80) ? -v : v;
  }
};

constexpr int BPS = 32;   // stride of the work buffer, as libwebp's
constexpr int kYOff = BPS * 1 + 8;
constexpr int kUOff = kYOff + BPS * 16 + BPS;
constexpr int kVOff = kUOff + 16;
constexpr int kWorkSize = BPS * 17 + BPS * 9;

enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED,
       B_VL_PRED, B_HD_PRED, B_HU_PRED, B_DC_NOTOP, B_DC_NOLEFT, B_DC_NOTOPLEFT };

inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

#define DST(x, y) dst[(x) + (y) * BPS]

void pred4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, dc, 4);
      break;
    }
    case B_TM_PRED:
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = clip8(top[x] + dst[-1 + y * BPS] - top[-1]);
      break;
    case B_VE_PRED: {
      uint8_t v[4];
      for (int i = 0; i < 4; ++i) v[i] = static_cast<uint8_t>(avg3(top[i - 1], top[i], top[i + 1]));
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE_PRED: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS], D = dst[-1 + 2 * BPS],
                E = dst[-1 + 3 * BPS];
      std::memset(dst + 0 * BPS, avg3(A, B, C), 4);
      std::memset(dst + 1 * BPS, avg3(B, C, D), 4);
      std::memset(dst + 2 * BPS, avg3(C, D, E), 4);
      std::memset(dst + 3 * BPS, avg3(D, E, E), 4);
      break;
    }
    case B_RD_PRED: {
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS],
                X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    }
    case B_LD_PRED: {
      const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5],
                G = top[6], H = top[7];
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    }
    case B_VR_PRED: {
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], X = top[-1], A = top[0],
                B = top[1], C = top[2], D = top[3];
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    }
    case B_VL_PRED: {
      const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5],
                G = top[6], H = top[7];
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    }
    case B_HD_PRED: {
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS],
                X = top[-1], A = top[0], B = top[1], C = top[2];
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    }
    case B_HU_PRED: {
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
    }
  }
}

#undef DST

// 16x16 (size 16) and chroma 8x8 (size 8) prediction; `mode` after the
// DC edge rules
void pred_block(int mode, uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int shift = size == 16 ? 4 : 3;
  int v = -1;
  switch (mode) {
    case B_DC_PRED: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + top[j];
      v = dc >> (shift + 1);
      break;
    }
    case B_DC_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      v = dc >> shift;
      break;
    }
    case B_DC_NOLEFT: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += top[j];
      v = dc >> shift;
      break;
    }
    case B_DC_NOTOPLEFT:
      v = 0x80;
      break;
    case B_TM_PRED:
      for (int y = 0; y < size; ++y)
        for (int x = 0; x < size; ++x) dst[x + y * BPS] = clip8(top[x] + dst[-1 + y * BPS] - top[-1]);
      return;
    case B_VE_PRED:
      for (int y = 0; y < size; ++y) std::memcpy(dst + y * BPS, top, size);
      return;
    case B_HE_PRED:
      for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, dst[-1 + y * BPS], size);
      return;
  }
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, size);
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// the inverse DCT of one 4x4 block, added to dst
void idct_add(const int16_t* in, uint8_t* dst) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {   // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    ++in;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {   // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    ++tmp;
    dst += BPS;
  }
}

// the inverse Walsh-Hadamard transform of the Y2 block into the DC of the
// 16 luma blocks
void iwht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// loop filters (dsp/dec.c), on pixels p at `step` across the edge
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }   // [-1020, 1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }       // [-112, 112]

inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// simple filter along an edge of 16 pixels; `hstride` crosses the edge,
// `vstride` walks along it
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) filter2(p, hstride);
}

// normal filter: six taps on macroblock edges (`mb_edge`), four inside
void normal_edge(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_thresh, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_thresh)) {
      filter2(p, hstride);
    } else if (mb_edge) {
      filter6(p, hstride);
    } else {
      filter4(p, hstride);
    }
  }
}

struct FilterInfo {
  uint8_t limit = 0;   // 0: no filtering
  uint8_t ilevel = 0;
  uint8_t inner = 0;
  uint8_t hev_thresh = 0;
};

struct MBInfo {
  uint8_t nz = 0;      // non-zero flags of the 4 luma columns (low) and 2+2 chroma (high)
  uint8_t nz_dc = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4 = 0;
  uint8_t imodes[16];
  uint8_t uvmode = 0;
  uint8_t segment = 0;
  uint8_t skip = 0;
  uint32_t non_zero_y = 0;
  uint32_t non_zero_uv = 0;
};

class VP8Decoder {
 public:
  int width = 0, height = 0;
  int mbw = 0, mbh = 0;
  std::vector<uint8_t> Y, U, V;   // planes of the padded frame, filtered
  int ystride = 0, uvstride = 0;

  static void frame_size(const uint8_t* d, size_t n, int& w, int& h) {
    if (n < 10) malformed("truncated VP8 frame header");
    const uint32_t bits = le24(d);
    if (bits & 1) malformed("VP8 frame is not a key frame");
    if (((bits >> 1) & 7) > 3) malformed("unknown VP8 profile");
    if (!((bits >> 4) & 1)) malformed("VP8 frame not shown");
    if ((bits >> 5) >= n) malformed("bad VP8 partition length");
    if (d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a) malformed("bad VP8 start code");
    w = le16(d + 6) & 0x3fff;
    h = le16(d + 8) & 0x3fff;
    if (w == 0 || h == 0) malformed("VP8 frame of size 0");
  }

  void decode(const uint8_t* d, size_t n) {
    frame_size(d, n, width, height);
    const uint32_t part0 = le24(d) >> 5;
    mbw = (width + 15) >> 4;
    mbh = (height + 15) >> 4;
    const uint8_t* buf = d + 10;
    size_t size = n - 10;
    if (part0 > size) malformed("bad VP8 partition length");
    br_.init(buf, part0);
    buf += part0;
    size -= part0;
    br_.get(0x80);   // colour space
    br_.get(0x80);   // clamping type (libwebp always clamps)
    parse_segment_header();
    parse_filter_header();
    parse_partitions(buf, size);
    parse_quant();
    br_.get(0x80);   // refresh entropy probabilities: ignored on a key frame
    parse_proba();
    if (br_.eof) malformed("truncated VP8 header");
    precompute_filter_strengths();

    ystride = mbw * 16;
    uvstride = mbw * 8;
    Y.assign(static_cast<size_t>(ystride) * mbh * 16, 0);
    U.assign(static_cast<size_t>(uvstride) * mbh * 8, 0);
    V.assign(U.size(), 0);
    finfo_.assign(static_cast<size_t>(mbw) * mbh, FilterInfo());
    mb_info_.assign(mbw + 1, MBInfo());   // [0] is the left neighbour
    intra_t_.assign(4 * mbw, B_DC_PRED);
    top_.assign(static_cast<size_t>(mbw) * 32, 0);
    mb_data_.assign(mbw, MBData());
    for (int mb_y = 0; mb_y < mbh; ++mb_y) {
      BoolDecoder& tokens = parts_[mb_y & (num_parts_ - 1)];
      std::memset(intra_l_, B_DC_PRED, sizeof intra_l_);
      for (int mb_x = 0; mb_x < mbw; ++mb_x) parse_intra_mode(mb_x);
      if (br_.eof) malformed("premature end of VP8 partition 0");
      mb_info_[0] = MBInfo();
      for (int mb_x = 0; mb_x < mbw; ++mb_x) {
        decode_mb(mb_x, mb_y, tokens);
        if (tokens.eof) malformed("premature end of VP8 token partition");
      }
      reconstruct_row(mb_y);
    }
    if (filter_type_ > 0) {
      for (int mb_y = 0; mb_y < mbh; ++mb_y)
        for (int mb_x = 0; mb_x < mbw; ++mb_x) filter_mb(mb_x, mb_y);
    }
  }

 private:
  BoolDecoder br_;
  BoolDecoder parts_[8];
  int num_parts_ = 1;
  // segment header
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int quantizer_[4] = {0, 0, 0, 0};
  int filter_strength_[4] = {0, 0, 0, 0};
  int seg_probs_[3] = {255, 255, 255};
  // filter header
  bool simple_ = false;
  int level_ = 0, sharpness_ = 0;
  bool use_lf_delta_ = false;
  int ref_lf_delta_[4] = {0, 0, 0, 0};
  int mode_lf_delta_[4] = {0, 0, 0, 0};
  int filter_type_ = 0;   // 0 off, 1 simple, 2 normal
  FilterInfo fstrengths_[4][2];
  // quantisers per segment: y1, y2, uv as (dc, ac)
  int y1_[4][2], y2_[4][2], uv_[4][2];
  uint8_t proba_[4][8][3][11];
  bool use_skip_ = false;
  int skip_p_ = 0;

  std::vector<FilterInfo> finfo_;
  std::vector<MBInfo> mb_info_;
  std::vector<uint8_t> intra_t_;
  uint8_t intra_l_[4];
  std::vector<uint8_t> top_;   // per macroblock: 16 y, 8 u, 8 v unfiltered samples above
  std::vector<MBData> mb_data_;
  uint8_t work_[kWorkSize];

  void parse_segment_header() {
    use_segment_ = br_.get(0x80);
    if (use_segment_) {
      update_map_ = br_.get(0x80);
      if (br_.get(0x80)) {   // update data
        absolute_delta_ = br_.get(0x80);
        for (int s = 0; s < 4; ++s) quantizer_[s] = br_.get(0x80) ? br_.signed_literal(7) : 0;
        for (int s = 0; s < 4; ++s) filter_strength_[s] = br_.get(0x80) ? br_.signed_literal(6) : 0;
      }
      if (update_map_)
        for (int s = 0; s < 3; ++s) seg_probs_[s] = br_.get(0x80) ? br_.literal(8) : 255;
    } else {
      update_map_ = false;
    }
  }

  void parse_filter_header() {
    simple_ = br_.get(0x80);
    level_ = br_.literal(6);
    sharpness_ = br_.literal(3);
    use_lf_delta_ = br_.get(0x80);
    if (use_lf_delta_ && br_.get(0x80)) {
      for (int i = 0; i < 4; ++i)
        if (br_.get(0x80)) ref_lf_delta_[i] = br_.signed_literal(6);
      for (int i = 0; i < 4; ++i)
        if (br_.get(0x80)) mode_lf_delta_[i] = br_.signed_literal(6);
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
  }

  void parse_partitions(const uint8_t* buf, size_t size) {
    num_parts_ = 1 << br_.literal(2);
    const size_t last = static_cast<size_t>(num_parts_ - 1);
    if (size < 3 * last) malformed("truncated VP8 partition sizes");
    const uint8_t* sz = buf;
    const uint8_t* start = buf + 3 * last;
    size_t left = size - 3 * last;
    for (size_t p = 0; p < last; ++p, sz += 3) {
      size_t psize = le24(sz);
      if (psize > left) psize = left;
      parts_[p].init(start, psize);
      start += psize;
      left -= psize;
    }
    parts_[last].init(start, left);
    if (left == 0) malformed("truncated VP8 token partitions");
  }

  static int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

  void parse_quant() {
    const int base_q0 = br_.literal(7);
    const int dqy1_dc = br_.get(0x80) ? br_.signed_literal(4) : 0;
    const int dqy2_dc = br_.get(0x80) ? br_.signed_literal(4) : 0;
    const int dqy2_ac = br_.get(0x80) ? br_.signed_literal(4) : 0;
    const int dquv_dc = br_.get(0x80) ? br_.signed_literal(4) : 0;
    const int dquv_ac = br_.get(0x80) ? br_.signed_literal(4) : 0;
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment_) {
        q = quantizer_[i];
        if (!absolute_delta_) q += base_q0;
      } else {
        q = base_q0;
      }
      y1_[i][0] = kDcTable[clip(q + dqy1_dc, 127)];
      y1_[i][1] = kAcTable[clip(q, 127)];
      y2_[i][0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      y2_[i][1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;   // x 155 / 100
      if (y2_[i][1] < 8) y2_[i][1] = 8;
      uv_[i][0] = kDcTable[clip(q + dquv_dc, 117)];
      uv_[i][1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }

  void parse_proba() {
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p) {
            const int i = ((t * 8 + b) * 3 + c) * 11 + p;
            proba_[t][b][c][p] = static_cast<uint8_t>(
                br_.get(kCoeffsUpdateProba[i]) ? br_.literal(8) : kCoeffsProba0[i]);
          }
    use_skip_ = br_.get(0x80);
    if (use_skip_) skip_p_ = br_.literal(8);
  }

  void precompute_filter_strengths() {
    if (filter_type_ == 0) return;
    for (int s = 0; s < 4; ++s) {
      int base = level_;
      if (use_segment_) {
        base = filter_strength_[s];
        if (!absolute_delta_) base += level_;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FilterInfo& info = fstrengths_[s][i4x4];
        int level = base;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4x4) level += mode_lf_delta_[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = static_cast<uint8_t>(ilevel);
          info.limit = static_cast<uint8_t>(2 * level + ilevel);
          info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = static_cast<uint8_t>(i4x4);
      }
    }
  }

  void parse_intra_mode(int mb_x) {
    uint8_t* top = intra_t_.data() + 4 * mb_x;
    uint8_t* left = intra_l_;
    MBData& block = mb_data_[mb_x];
    if (update_map_) {
      block.segment = static_cast<uint8_t>(!br_.get(seg_probs_[0]) ? br_.get(seg_probs_[1])
                                                                   : br_.get(seg_probs_[2]) + 2);
    } else {
      block.segment = 0;
    }
    block.skip = use_skip_ ? static_cast<uint8_t>(br_.get(skip_p_)) : 0;
    block.is_i4x4 = !br_.get(145);
    if (!block.is_i4x4) {
      const int ymode = br_.get(156) ? (br_.get(128) ? B_TM_PRED : B_HE_PRED)
                                     : (br_.get(163) ? B_VE_PRED : B_DC_PRED);
      block.imodes[0] = static_cast<uint8_t>(ymode);
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = block.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
          ymode = !br_.get(prob[0]) ? B_DC_PRED
                : !br_.get(prob[1]) ? B_TM_PRED
                : !br_.get(prob[2]) ? B_VE_PRED
                : !br_.get(prob[3])
                    ? (!br_.get(prob[4]) ? B_HE_PRED : (!br_.get(prob[5]) ? B_RD_PRED : B_VR_PRED))
                    : (!br_.get(prob[6]) ? B_LD_PRED
                       : (!br_.get(prob[7]) ? B_VL_PRED
                          : (!br_.get(prob[8]) ? B_HD_PRED : B_HU_PRED)));
          top[x] = static_cast<uint8_t>(ymode);
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = static_cast<uint8_t>(ymode);
      }
    }
    block.uvmode = static_cast<uint8_t>(!br_.get(142) ? B_DC_PRED
                                        : !br_.get(114) ? B_VE_PRED
                                        : br_.get(183) ? B_TM_PRED : B_HE_PRED);
  }

  static int large_value(BoolDecoder& br, const uint8_t* p) {
    int v;
    if (!br.get(p[3])) {
      v = !br.get(p[4]) ? 2 : 3 + br.get(p[5]);
    } else if (!br.get(p[6])) {
      if (!br.get(p[7])) {
        v = 5 + br.get(159);
      } else {
        v = 7 + 2 * br.get(165);
        v += br.get(145);
      }
    } else {
      const int bit1 = br.get(p[8]);
      const int bit0 = br.get(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // tokens of one 4x4 block from position n; the position past the last
  // non-zero coefficient
  int coeffs(BoolDecoder& br, int type, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = proba_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.get(p[0])) return n;
      while (!br.get(p[1])) {
        p = proba_[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      if (!br.get(p[2])) {
        v = 1;
        p = proba_[type][kBands[n + 1]][1];
      } else {
        v = large_value(br, p);
        p = proba_[type][kBands[n + 1]][2];
      }
      if (br.get(0x80)) v = -v;
      out[kZigzag[n]] = static_cast<int16_t>(v * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= nz > 3 ? 3 : nz > 1 ? 2 : dc_nz;
    return nz_coeffs;
  }

  // ParseResiduals; true when every coefficient is zero
  bool residuals(int mb_x, BoolDecoder& br) {
    MBData& block = mb_data_[mb_x];
    MBInfo& mb = mb_info_[mb_x + 1];
    MBInfo& left = mb_info_[0];
    const int s = block.segment;
    int16_t* dst = block.coeffs;
    std::memset(dst, 0, sizeof block.coeffs);
    int first, ac_type;
    if (!block.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = mb.nz_dc + left.nz_dc;
      const int nz = coeffs(br, 1, ctx, y2_[s], 0, dc);
      mb.nz_dc = left.nz_dc = nz > 0;
      if (nz > 1) {
        iwht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 256; i += 16) dst[i] = static_cast<int16_t>(dc0);
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    uint32_t tnz = mb.nz & 0x0f, lnz = left.nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = coeffs(br, ac_type, ctx, y1_[s], first, dst);
        l = nz > first;
        tnz = (tnz >> 1) | (l << 7);
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (lnz >> 1) | (l << 7);
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = mb.nz >> (4 + ch);
      lnz = left.nz >> (4 + ch);
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = coeffs(br, 2, ctx, uv_[s], 0, dst);
          l = nz > 0;
          tnz = (tnz >> 1) | (l << 3);
          nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (lnz >> 1) | (l << 5);
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= (tnz << 4) << ch;
      out_l_nz |= (lnz & 0xf0) << ch;
    }
    mb.nz = static_cast<uint8_t>(out_t_nz);
    left.nz = static_cast<uint8_t>(out_l_nz);
    block.non_zero_y = non_zero_y;
    block.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }

  void decode_mb(int mb_x, int mb_y, BoolDecoder& tokens) {
    MBData& block = mb_data_[mb_x];
    MBInfo& mb = mb_info_[mb_x + 1];
    MBInfo& left = mb_info_[0];
    bool skip = use_skip_ ? block.skip : false;
    if (!skip) {
      skip = residuals(mb_x, tokens);
    } else {
      left.nz = mb.nz = 0;
      if (!block.is_i4x4) left.nz_dc = mb.nz_dc = 0;
      block.non_zero_y = 0;
      block.non_zero_uv = 0;
      std::memset(block.coeffs, 0, sizeof block.coeffs);
    }
    if (filter_type_ > 0) {
      FilterInfo f = fstrengths_[block.segment][block.is_i4x4];
      f.inner |= !skip;
      finfo_[static_cast<size_t>(mb_y) * mbw + mb_x] = f;
    }
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode == B_DC_PRED) {
      if (mb_x == 0) return mb_y == 0 ? B_DC_NOTOPLEFT : B_DC_NOLEFT;
      return mb_y == 0 ? B_DC_NOTOP : B_DC_PRED;
    }
    return mode;
  }

  static void transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
    if (bits >> 30) idct_add(src, dst);   // any coefficient: the full IDCT is exact
  }

  static void uv_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
    if (bits & 0xff) {
      for (int b = 0; b < 4; ++b)
        idct_add(src + 16 * b, dst + (b & 1) * 4 + (b >> 1) * 4 * BPS);
    }
  }

  // ReconstructRow: predict from the unfiltered samples in the work buffer
  // (127 above the frame, 129 left of it), add the residuals, copy out
  void reconstruct_row(int mb_y) {
    uint8_t* const y_dst = work_ + kYOff;
    uint8_t* const u_dst = work_ + kUOff;
    uint8_t* const v_dst = work_ + kVOff;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) {
      u_dst[j * BPS - 1] = 129;
      v_dst[j * BPS - 1] = 129;
    }
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mbw; ++mb_x) {
      const MBData& block = mb_data_[mb_x];
      if (mb_x > 0) {   // the left samples from the previous macroblock
        for (int j = -1; j < 16; ++j) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      uint8_t* top = top_.data() + static_cast<size_t>(mb_x) * 32;
      if (mb_y > 0) {
        std::memcpy(y_dst - BPS, top, 16);
        std::memcpy(u_dst - BPS, top + 16, 8);
        std::memcpy(v_dst - BPS, top + 24, 8);
      }
      const int16_t* coeffs = block.coeffs;
      uint32_t bits = block.non_zero_y;
      if (block.is_i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mbw - 1) {
            std::memset(top_right, top[15], 4);
          } else {
            std::memcpy(top_right, top + 32, 4);
          }
        }
        // the top-right samples repeated for the right column of sub-blocks
        for (int r = 1; r <= 3; ++r) std::memcpy(top_right + 4 * r * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          pred4(block.imodes[n], dst);
          transform(bits, coeffs + n * 16, dst);
        }
      } else {
        pred_block(check_mode(mb_x, mb_y, block.imodes[0]), y_dst, 16);
        for (int n = 0; n < 16; ++n, bits <<= 2)
          transform(bits, coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
      const int uvmode = check_mode(mb_x, mb_y, block.uvmode);
      pred_block(uvmode, u_dst, 8);
      pred_block(uvmode, v_dst, 8);
      uv_transform(block.non_zero_uv >> 0, coeffs + 16 * 16, u_dst);
      uv_transform(block.non_zero_uv >> 8, coeffs + 20 * 16, v_dst);
      if (mb_y < mbh - 1) {
        std::memcpy(top, y_dst + 15 * BPS, 16);
        std::memcpy(top + 16, u_dst + 7 * BPS, 8);
        std::memcpy(top + 24, v_dst + 7 * BPS, 8);
      }
      uint8_t* yo = Y.data() + static_cast<size_t>(mb_y) * 16 * ystride + mb_x * 16;
      for (int j = 0; j < 16; ++j) std::memcpy(yo + j * ystride, y_dst + j * BPS, 16);
      uint8_t* uo = U.data() + static_cast<size_t>(mb_y) * 8 * uvstride + mb_x * 8;
      uint8_t* vo = V.data() + static_cast<size_t>(mb_y) * 8 * uvstride + mb_x * 8;
      for (int j = 0; j < 8; ++j) {
        std::memcpy(uo + j * uvstride, u_dst + j * BPS, 8);
        std::memcpy(vo + j * uvstride, v_dst + j * BPS, 8);
      }
    }
  }

  void filter_mb(int mb_x, int mb_y) {
    const FilterInfo& f = finfo_[static_cast<size_t>(mb_y) * mbw + mb_x];
    const int limit = f.limit;
    if (limit == 0) return;
    const int ilevel = f.ilevel;
    const int ys = ystride;
    uint8_t* y = Y.data() + static_cast<size_t>(mb_y) * 16 * ys + mb_x * 16;
    if (filter_type_ == 1) {
      if (mb_x > 0) simple_edge(y, 1, ys, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_edge(y + 4 * k, 1, ys, limit);
      if (mb_y > 0) simple_edge(y, ys, 1, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_edge(y + 4 * k * ys, ys, 1, limit);
      return;
    }
    const int us = uvstride;
    uint8_t* u = U.data() + static_cast<size_t>(mb_y) * 8 * us + mb_x * 8;
    uint8_t* v = V.data() + static_cast<size_t>(mb_y) * 8 * us + mb_x * 8;
    const int hev_t = f.hev_thresh;
    if (mb_x > 0) {
      normal_edge(y, 1, ys, 16, limit + 4, ilevel, hev_t, true);
      normal_edge(u, 1, us, 8, limit + 4, ilevel, hev_t, true);
      normal_edge(v, 1, us, 8, limit + 4, ilevel, hev_t, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) normal_edge(y + 4 * k, 1, ys, 16, limit, ilevel, hev_t, false);
      normal_edge(u + 4, 1, us, 8, limit, ilevel, hev_t, false);
      normal_edge(v + 4, 1, us, 8, limit, ilevel, hev_t, false);
    }
    if (mb_y > 0) {
      normal_edge(y, ys, 1, 16, limit + 4, ilevel, hev_t, true);
      normal_edge(u, us, 1, 8, limit + 4, ilevel, hev_t, true);
      normal_edge(v, us, 1, 8, limit + 4, ilevel, hev_t, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k)
        normal_edge(y + 4 * k * ys, ys, 1, 16, limit, ilevel, hev_t, false);
      normal_edge(u + 4 * us, us, 1, 8, limit, ilevel, hev_t, false);
      normal_edge(v + 4 * us, us, 1, 8, limit, ilevel, hev_t, false);
    }
  }
};

// dsp/yuv.h: 14-bit fixed point, clipped from 6 fractional bits
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) { return static_cast<uint8_t>((v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255); }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  const int yy = mult_hi(y, 19077);
  rgb[0] = yuv_clip8(yy + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(yy + mult_hi(u, 33050) - 17685);
}

// dsp/upsampling.c's fancy upsampler: two output rows from the chroma rows
// above (top) and below (cur) them; `bottom_y` null for a single row
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  auto load = [](int u, int v) { return static_cast<uint32_t>(u) | (static_cast<uint32_t>(v) << 16); };
  const int last_pair = (len - 1) >> 1;
  uint32_t tl_uv = load(top_u[0], top_v[0]);
  uint32_t l_uv = load(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_rgb(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
  }
  if (bottom_y) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_rgb(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
  }
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t_uv = load(top_u[x], top_v[x]);
    const uint32_t uv = load(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_rgb(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, top_dst + (2 * x - 1) * 3);
      yuv_to_rgb(top_y[2 * x], uv1 & 0xff, uv1 >> 16, top_dst + (2 * x) * 3);
    }
    if (bottom_y) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      yuv_to_rgb(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (2 * x - 1) * 3);
      yuv_to_rgb(bottom_y[2 * x], uv1 & 0xff, uv1 >> 16, bottom_dst + (2 * x) * 3);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_rgb(top_y[len - 1], uv0 & 0xff, uv0 >> 16, top_dst + (len - 1) * 3);
    }
    if (bottom_y) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_rgb(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (len - 1) * 3);
    }
  }
}

// EmitFancyRGB over the whole frame: row 0 from chroma row 0 alone, rows
// (2k-1, 2k) between chroma rows k-1 and k, an even height's last row from
// its chroma row alone
void vp8_to_rgb(const VP8Decoder& d, uint8_t* out) {
  const int w = d.width, h = d.height;
  const size_t row = static_cast<size_t>(w) * 3;
  auto Y = [&](int r) { return d.Y.data() + static_cast<size_t>(r) * d.ystride; };
  auto U = [&](int r) { return d.U.data() + static_cast<size_t>(r) * d.uvstride; };
  auto V = [&](int r) { return d.V.data() + static_cast<size_t>(r) * d.uvstride; };
  upsample_pair(Y(0), nullptr, U(0), V(0), U(0), V(0), out, nullptr, w);
  int y = 0;
  for (; y + 2 < h; y += 2) {
    const int k = y / 2;
    upsample_pair(Y(y + 1), Y(y + 2), U(k), V(k), U(k + 1), V(k + 1), out + (y + 1) * row,
                  out + (y + 2) * row, w);
  }
  if (!(h & 1)) {
    const int k = y / 2;
    upsample_pair(Y(h - 1), nullptr, U(k), V(k), U(k), V(k), out + (h - 1) * row, nullptr, w);
  }
}

// the size of the image in a container's bitstream, checked against the
// VP8X canvas: equal to it for a still image, inside it for a frame
void image_size(const Bitstream& bs, int& w, int& h) {
  if (bs.lossless) {
    VP8LDecoder dec(bs.data, bs.size);
    dec.header(w, h);
  } else {
    VP8Decoder::frame_size(bs.data, bs.size, w, h);
  }
  if (bs.animated) {
    if (static_cast<int64_t>(bs.frame_x) + w > bs.canvas_w ||
        static_cast<int64_t>(bs.frame_y) + h > bs.canvas_h)
      malformed("animation frame outside the canvas");
  } else if (bs.canvas_w && (bs.canvas_w != w || bs.canvas_h != h)) {
    malformed("VP8X canvas size differs from the image's");
  }
}

// the image of a bitstream, w x h x 3 RGB at `out` with rows `stride`
// bytes apart
void decode_image(const Bitstream& bs, int w, int h, uint8_t* out, size_t stride) {
  if (bs.lossless) {
    VP8LDecoder dec(bs.data, bs.size);
    dec.header(w, h);
    std::vector<uint32_t> argb = dec.decode(w, h);
    for (int y = 0; y < h; ++y) {
      uint8_t* o = out + y * stride;
      for (int x = 0; x < w; ++x) {
        uint32_t p = argb[static_cast<size_t>(y) * w + x];
        o[3 * x] = static_cast<uint8_t>(p >> 16);
        o[3 * x + 1] = static_cast<uint8_t>(p >> 8);
        o[3 * x + 2] = static_cast<uint8_t>(p);
      }
    }
    return;
  }
  VP8Decoder dec;
  dec.decode(bs.data, bs.size);
  if (stride == static_cast<size_t>(w) * 3) {
    vp8_to_rgb(dec, out);
    return;
  }
  std::vector<uint8_t> rgb(static_cast<size_t>(w) * h * 3);
  vp8_to_rgb(dec, rgb.data());
  for (int y = 0; y < h; ++y)
    std::memcpy(out + y * stride, rgb.data() + static_cast<size_t>(y) * w * 3,
                static_cast<size_t>(w) * 3);
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
}

}  // namespace

extern "C" {

// width and height of a webp file (an animation's canvas)
int smm_webp_size(const uint8_t* data, int64_t len, int32_t* wh, char* err, int errlen) {
  try {
    Bitstream bs = parse_container(data, static_cast<size_t>(len));
    int w, h;
    image_size(bs, w, h);
    wh[0] = bs.animated ? bs.canvas_w : w;
    wh[1] = bs.animated ? bs.canvas_h : h;
    return kOk;
  } catch (const Failure& f) {
    set_error(err, errlen, f.msg);
    return f.code;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return kMalformed;
  }
}

// decode to height x width x 3 RGB bytes at `out` (cap bytes).  An
// animation gives its first frame as WebPAnimDecoder composes it: a key
// frame, decoded straight onto the canvas cleared to transparent black
// (the ANIM background colour and the frame's blend flag play no part),
// of which convert("RGB") keeps the colour
int smm_webp_decode(const uint8_t* data, int64_t len, uint8_t* out, int64_t cap, char* err,
                    int errlen) {
  try {
    Bitstream bs = parse_container(data, static_cast<size_t>(len));
    int w, h;
    image_size(bs, w, h);
    int cw = bs.animated ? bs.canvas_w : w, ch = bs.animated ? bs.canvas_h : h;
    if (static_cast<int64_t>(cw) * ch * 3 > cap) malformed("output buffer too small");
    size_t stride = static_cast<size_t>(cw) * 3;
    if (bs.animated) std::memset(out, 0, stride * ch);
    decode_image(bs, w, h, out + bs.frame_y * stride + static_cast<size_t>(bs.frame_x) * 3,
                 stride);
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
