// Shared by the pair-sum and pair-stats kernels: the kernel mixture
// passed through the C interface, its value k(d2) and derivative
// g = dk/d(d2) from one pass over the terms (mixture_kg), and the
// validation of a call.  The tile engine both use is tiles.cuh.
//
// k is a Gaussian or rational-quadratic mixture (rq optionally plus
// add_dot * <a_i, b_j>), or the energy-distance kernel -sqrt(d2 + eps),
// evaluated as _mixture_k / _mixture_g of smmdax/pallas/mmd_kernel.py do:
// expf / log1pf in float32, no fast math.
//
// Each .cu file that includes this header is its own shared library, so
// the helpers below live in an anonymous namespace (one copy per library).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

// Passed by value through the C interface: it lives outside the anonymous
// namespace so the extern "C" entry points keep external linkage.
struct SmmdaxMix {
  int kind;
  int n;          // number of mixture terms
  float add_dot;  // rq only
  float p[8];     // gaussian: gamma = 1/(2 sigma^2); rq: alpha
};

namespace {

using Mix = SmmdaxMix;
constexpr int kMaxParams = sizeof(Mix::p) / sizeof(float);
constexpr int kGaussian = 0;
constexpr int kRQ = 1;
constexpr int kDistance = 2;
constexpr float kDistEps = 1e-8f;  // smmdax_torch.kernels.kernels.DIST_EPS

constexpr int kThreads = 256;  // threads per block of every kernel

// k and g from one pass over the mixture terms: each term pays one expf
// (and, for rq, one log1pf), and g reuses the term's k_t.  rq:
// g_t = -k_t / 2 / (1 + d2 / 2 alpha), gaussian: g_t = -gamma k_t,
// distance: g = 1 / (2 k).  With kWantG false the g work is dead code.
template <bool kWantG>
__device__ __forceinline__ void mixture_kg(float d2, float dot, const Mix& mx,
                                           float& k, float& g) {
  k = 0.f;
  g = 0.f;
  if (mx.kind == kGaussian) {
    for (int t = 0; t < mx.n; ++t) {
      const float kt = expf(d2 * (-mx.p[t]));
      k += kt;
      if (kWantG) g -= mx.p[t] * kt;
    }
  } else if (mx.kind == kRQ) {
    for (int t = 0; t < mx.n; ++t) {
      const float a = mx.p[t];
      const float x = d2 / (2.f * a);
      const float kt = expf(-a * log1pf(x));
      k += kt;
      if (kWantG) g -= 0.5f * kt * __frcp_rn(1.f + x);
    }
    if (mx.add_dot != 0.f) k += mx.add_dot * dot;
  } else {
    k = -sqrtf(d2 + kDistEps);
    if (kWantG) g = 0.5f / k;
  }
}

inline bool valid(int m, int n, int d, const Mix& mx) {
  return m > 0 && n > 0 && d > 0 && mx.n >= 0 && mx.n <= kMaxParams &&
         mx.kind >= kGaussian && mx.kind <= kDistance;
}

}  // namespace
