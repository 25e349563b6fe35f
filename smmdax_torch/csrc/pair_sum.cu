// Fused pairwise-kernel sums for the MMD^2 estimator, and their gradient.
//
//   pair_sum_fwd:    S = sum_{i,j} mask_ij * k(||a_i - b_j||^2)
//   pair_sum_grad_a: dS/da_i without the pair factor,
//                    rowsum(G)_i * a_i - ((G - add_dot/2 * mask) @ b)_i,
//                    G_ij = mask_ij * dk/d(d2)
//
// k is the mixture of mixture.cuh (shared with pair_stats.cu).  The mask
// drops the diagonal of a self-block (exclude_diag).  Neither kernel
// materialises the (m, n) Gram matrix in device memory.
//
// Replaces the TPU kernels _fwd_kernel/_pair_sum and
// _bwd_kernel/_pair_sum_grad_a of smmdax/pallas/mmd_kernel.py.  The TPU
// grid runs in order on one core, so those kernels carried a scalar
// (forward) and a row block of da (backward) from one grid step to the
// next.  Blocks run in no order here, so:
//   * the forward writes one partial per block to a scratch buffer and a
//     one-block second pass sums the partials in a fixed order
//     (deterministic, no atomics);
//   * the backward gives each block a block of rows of a (and a chunk of
//     the output columns) and loops over every column tile of b itself;
//     its da entries are written once and nothing crosses blocks.
//
// Bound on an H100: at the flagship shape (64 x 16 features) both
// kernels are bound by launch latency (a few thousand pairs).  At large
// m, n the work is m*n pairs of d FMAs plus one exp/log1p pair per
// mixture term: bound by float32 operations, not bytes (inputs are read
// from L2/shared memory many times, the output is a scalar or (m, d)).
// The products run on the FP32 pipes in FMA loops over shared-memory
// tiles; tensor-core (wgmma) tiles are later work.
//
// Plain C interface for ctypes; every entry point returns
// cudaGetLastError() after its launches.

#include "mixture.cuh"

namespace {

constexpr int kTile = 64;       // forward: 64 x 64 pairs per block
constexpr int kGradRows = 32;   // backward: rows of a per block
constexpr int kGradCols = 64;   // backward: column tile of b
constexpr int kGradOut = 128;   // backward: output columns of da per block

// ---------------------------------------------------------------------------
// forward

__global__ void __launch_bounds__(kThreads)
pair_sum_tiles(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ partials, int m, int n, int d,
               int exclude_diag, Mix mx) {
  __shared__ float as[kTile][kChunk + 1];
  __shared__ float bs[kTile][kChunk + 1];
  __shared__ float na[kTile], nb[kTile];
  __shared__ float warp_sums[kThreads / 32];

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;  // this thread: rows ty + 16r, cols tx + 16c
  const int i0 = blockIdx.x * kTile, j0 = blockIdx.y * kTile;

  float dot[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) dot[r][c] = 0.f;
  float norm = 0.f;  // threads [0, 64): ||a_row||^2, [64, 128): ||b_row||^2

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    stage<kTile>(as, a, i0, m, k0, d);
    stage<kTile>(bs, b, j0, n, k0, d);
    __syncthreads();
    if (t < kTile) {
      for (int k = 0; k < kChunk; ++k) norm = fmaf(as[t][k], as[t][k], norm);
    } else if (t < 2 * kTile) {
      for (int k = 0; k < kChunk; ++k) norm = fmaf(bs[t - kTile][k], bs[t - kTile][k], norm);
    }
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = as[ty + 16 * r][k];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = bs[tx + 16 * c][k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) dot[r][c] = fmaf(av[r], bv[c], dot[r][c]);
    }
    __syncthreads();
  }
  if (t < kTile) na[t] = norm;
  else if (t < 2 * kTile) nb[t - kTile] = norm;
  __syncthreads();

  float s = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int li = ty + 16 * r, lj = tx + 16 * c;
      const int i = i0 + li, j = j0 + lj;
      if (i < m && j < n && !(exclude_diag && i == j)) {
        const float d2 = fmaxf(na[li] + nb[lj] - 2.f * dot[r][c], 0.f);
        s += mixture_k(d2, dot[r][c], mx);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if ((t & 31) == 0) warp_sums[t >> 5] = s;
  __syncthreads();
  if (t == 0) {
    float total = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    partials[blockIdx.y * gridDim.x + blockIdx.x] = total;
  }
}

// ---------------------------------------------------------------------------
// backward

__global__ void __launch_bounds__(kThreads)
pair_sum_grad_rows(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ da, int m, int n, int d,
                   int exclude_diag, Mix mx) {
  __shared__ float as[kGradRows][kChunk + 1];
  __shared__ float bs[kGradCols][kChunk + 1];
  __shared__ float na[kGradRows], nb[kGradCols];
  __shared__ float gs[kGradRows][kGradCols + 1];  // masked g: the row sums
  __shared__ float gm[kGradRows][kGradCols + 1];  // masked g - add_dot/2: the G@b operand

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;  // tile phase: rows ty + 16r, cols tx + 16c
  const int ar = t / 8, al = t % 8;    // accumulation phase: row ar, columns al + 8q
  const int i0 = blockIdx.x * kGradRows;
  const int c0 = blockIdx.y * kGradOut;
  const float half_dot = 0.5f * mx.add_dot;

  float acc[kGradOut / 8];
#pragma unroll
  for (int q = 0; q < kGradOut / 8; ++q) acc[q] = 0.f;
  float rowsum = 0.f;

  for (int j0 = 0; j0 < n; j0 += kGradCols) {
    float dot[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) dot[r][c] = 0.f;
    float norm = 0.f;  // threads [0, 32): ||a_row||^2, [32, 96): ||b_row||^2

    for (int k0 = 0; k0 < d; k0 += kChunk) {
      stage<kGradRows>(as, a, i0, m, k0, d);
      stage<kGradCols>(bs, b, j0, n, k0, d);
      __syncthreads();
      if (t < kGradRows) {
        for (int k = 0; k < kChunk; ++k) norm = fmaf(as[t][k], as[t][k], norm);
      } else if (t < kGradRows + kGradCols) {
        const int r = t - kGradRows;
        for (int k = 0; k < kChunk; ++k) norm = fmaf(bs[r][k], bs[r][k], norm);
      }
#pragma unroll 8
      for (int k = 0; k < kChunk; ++k) {
        float av[2], bv[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) av[r] = as[ty + 16 * r][k];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = bs[tx + 16 * c][k];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) dot[r][c] = fmaf(av[r], bv[c], dot[r][c]);
      }
      __syncthreads();
    }
    if (t < kGradRows) na[t] = norm;
    else if (t < kGradRows + kGradCols) nb[t - kGradRows] = norm;
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int li = ty + 16 * r, lj = tx + 16 * c;
        const int i = i0 + li, j = j0 + lj;
        float g = 0.f, g_op = 0.f;
        if (i < m && j < n && !(exclude_diag && i == j)) {
          const float d2 = fmaxf(na[li] + nb[lj] - 2.f * dot[r][c], 0.f);
          g = mixture_g(d2, mx);
          g_op = g - half_dot;
        }
        gs[li][lj] = g;
        gm[li][lj] = g_op;
      }
    }
    __syncthreads();

    for (int jj = al; jj < kGradCols; jj += 8) rowsum += gs[ar][jj];
    const int jn = min(kGradCols, n - j0);
    for (int jj = 0; jj < jn; ++jj) {
      const float w = gm[ar][jj];
      const float* __restrict__ brow = b + (size_t)(j0 + jj) * d;
#pragma unroll
      for (int q = 0; q < kGradOut / 8; ++q) {
        const int col = c0 + al + 8 * q;
        if (col < d) acc[q] = fmaf(w, __ldg(brow + col), acc[q]);
      }
    }
    __syncthreads();
  }

  // the 8 lanes of a row are neighbours in one warp; the butterfly gives
  // every lane the same (commutative) sums
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) rowsum += __shfl_xor_sync(0xffffffffu, rowsum, off);

  const int i = i0 + ar;
  if (i < m) {
#pragma unroll
    for (int q = 0; q < kGradOut / 8; ++q) {
      const int col = c0 + al + 8 * q;
      if (col < d) da[(size_t)i * d + col] = rowsum * a[(size_t)i * d + col] - acc[q];
    }
  }
}

}  // namespace

extern "C" {

// Number of per-block partials (the scratch size) the forward needs.
int smmdax_pair_sum_partials(int m, int n) {
  return ((m + kTile - 1) / kTile) * ((n + kTile - 1) / kTile);
}

int smmdax_pair_sum_fwd(const float* a, const float* b, float* partials,
                        int num_partials, float* out, int m, int n, int d,
                        int exclude_diag, Mix mix, void* stream) {
  if (!valid(m, n, d, mix) || num_partials != smmdax_pair_sum_partials(m, n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  pair_sum_tiles<<<grid, kThreads, 0, s>>>(a, b, partials, m, n, d, exclude_diag, mix);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<<<1, kThreads, 0, s>>>(partials, num_partials, out);
  return (int)cudaGetLastError();
}

int smmdax_pair_sum_grad_a(const float* a, const float* b, float* da, int m,
                           int n, int d, int exclude_diag, Mix mix, void* stream) {
  if (!valid(m, n, d, mix)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((m + kGradRows - 1) / kGradRows, (d + kGradOut - 1) / kGradOut);
  pair_sum_grad_rows<<<grid, kThreads, 0, s>>>(a, b, da, m, n, d, exclude_diag, mix);
  return (int)cudaGetLastError();
}

const char* smmdax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
