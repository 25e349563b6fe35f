// Fused block statistics of a masked Gram block for the t-ratio (tmmd)
// estimator, and their gradient.
//
//   pair_stats_fwd:    rows_i = sum_j mask_ij * k_ij   (m,)
//                      sum_sq = sum_ij mask_ij * k_ij^2  (scalar)
//   pair_stats_grad_a: dS/da_i without the pair factor, for
//                      S = sum_i u_i rows_i + sum_j v_j cols_j + c * sum_sq:
//                      rowsum(T)_i * a_i - (T' @ b)_i,
//                      T_ij  = mask_ij * coeff_ij * g_ij,
//                      T'_ij = mask_ij * coeff_ij * (g_ij - add_dot/2),
//                      coeff_ij = u_i + v_j + 2 c k_ij
//
// with k_ij = k(||a_i - b_j||^2) the mixture of mixture.cuh and
// g = dk/d(d2).  Column sums are the row sums of the swapped call (k is
// symmetric in its pair).  Neither kernel materialises the (m, n) Gram
// matrix in device memory.
//
// Replaces the TPU kernels _stats_kernel/_pair_stats_fwd and
// _stats_bwd_kernel/_pair_stats_grad_a of smmdax/pallas/mmd_kernel.py.
// On the TPU the row block is revisited along the inner grid dimension and
// sum_sq is a scalar += in SMEM, which is safe only because TPU grid
// programs run in order.  Blocks run in no order here, so:
//   * each block owns a block of rows of a, loops over every column tile
//     of b, and writes its row sums once (no atomics); sum_sq is one
//     partial per block, summed in a fixed order by sum_partials
//     (deterministic);
//   * the backward has the design of pair_sum_grad_a: one block per row
//     block (and chunk of output columns), looping over the column tiles,
//     with rowsum(T) and T' @ b in registers and da written once.
// u and v are plain (m,) and (n,) float32 vectors.  c is read from device
// memory: it is an autograd cotangent on the card, and reading it on the
// host would synchronise every backward.
//
// Bound on an H100: at the tmmd step's 64 x 16 features both kernels are
// bound by launch latency (a few thousand pairs).  At large m, n the work
// is m*n pairs of d FMAs plus the mixture (the backward needs both k and
// g): bound by float32 operations.  The products run on the FP32 pipes in
// FMA loops over shared-memory tiles.  With 32 rows per block the grid
// has only m/32 blocks, too few to fill 132 SMs below m = 4224; splitting
// the column loop across blocks is later work.
//
// Plain C interface for ctypes; every entry point returns
// cudaGetLastError() after its launches.

#include "mixture.cuh"

namespace {

constexpr int kRows = 32;    // rows of a per block
constexpr int kCols = 64;    // column tile of b
constexpr int kGradOut = 128;  // backward: output columns of da per block

// dot[r][c] = <a_{i0 + ty + 16r}, b_{j0 + tx + 16c}> for the tile, and the
// squared norms of its rows (na) and columns (nb) in shared memory.
__device__ __forceinline__ void tile_dots(
    const float* __restrict__ a, const float* __restrict__ b, int i0, int j0,
    int m, int n, int d, float (*as)[kChunk + 1], float (*bs)[kChunk + 1],
    float* na, float* nb, float (&dot)[2][4]) {
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) dot[r][c] = 0.f;
  float norm = 0.f;  // threads [0, 32): ||a_row||^2, [32, 96): ||b_row||^2

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    stage<kRows>(as, a, i0, m, k0, d);
    stage<kCols>(bs, b, j0, n, k0, d);
    __syncthreads();
    if (t < kRows) {
      for (int k = 0; k < kChunk; ++k) norm = fmaf(as[t][k], as[t][k], norm);
    } else if (t < kRows + kCols) {
      const int r = t - kRows;
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
  if (t < kRows) na[t] = norm;
  else if (t < kRows + kCols) nb[t - kRows] = norm;
  __syncthreads();
}

// ---------------------------------------------------------------------------
// forward

__global__ void __launch_bounds__(kThreads)
pair_stats_rows(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ rows, float* __restrict__ partials,
                int m, int n, int d, int exclude_diag, Mix mx) {
  __shared__ float as[kRows][kChunk + 1];
  __shared__ float bs[kCols][kChunk + 1];
  __shared__ float na[kRows], nb[kCols];
  __shared__ float warp_sums[kThreads / 32];

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;  // rows ty + 16r, cols tx + 16c
  const int i0 = blockIdx.x * kRows;

  float row_acc[2] = {0.f, 0.f};
  float sq = 0.f;
  for (int j0 = 0; j0 < n; j0 += kCols) {
    float dot[2][4];
    tile_dots(a, b, i0, j0, m, n, d, as, bs, na, nb, dot);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int li = ty + 16 * r, lj = tx + 16 * c;
        const int i = i0 + li, j = j0 + lj;
        if (i < m && j < n && !(exclude_diag && i == j)) {
          const float d2 = fmaxf(na[li] + nb[lj] - 2.f * dot[r][c], 0.f);
          const float k = mixture_k(d2, dot[r][c], mx);
          row_acc[r] += k;
          sq = fmaf(k, k, sq);
        }
      }
    }
    // na / nb are rewritten by the next tile's tile_dots only after its
    // first __syncthreads, which every thread reaches after this read
  }

  // the 16 lanes of a row (fixed ty) are one half of a warp: butterfly
  // over tx in a fixed order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      row_acc[r] += __shfl_xor_sync(0xffffffffu, row_acc[r], off);
  }
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + ty + 16 * r;
      if (i < m) rows[i] = row_acc[r];
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_down_sync(0xffffffffu, sq, off);
  if ((t & 31) == 0) warp_sums[t >> 5] = sq;
  __syncthreads();
  if (t == 0) {
    float total = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    partials[blockIdx.x] = total;
  }
}

// ---------------------------------------------------------------------------
// backward

__global__ void __launch_bounds__(kThreads)
pair_stats_grad_rows(const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ u, const float* __restrict__ v,
                     const float* __restrict__ c_sq, float* __restrict__ da,
                     int m, int n, int d, int exclude_diag, Mix mx) {
  __shared__ float as[kRows][kChunk + 1];
  __shared__ float bs[kCols][kChunk + 1];
  __shared__ float na[kRows], nb[kCols];
  __shared__ float us[kRows], vs[kCols];
  __shared__ float t_sum[kRows][kCols + 1];  // masked coeff * g: the row sums
  __shared__ float t_mat[kRows][kCols + 1];  // masked coeff * (g - add_dot/2): the T'@b operand

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;  // tile phase: rows ty + 16r, cols tx + 16c
  const int ar = t / 8, al = t % 8;    // accumulation phase: row ar, columns al + 8q
  const int i0 = blockIdx.x * kRows;
  const int c0 = blockIdx.y * kGradOut;
  const float half_dot = 0.5f * mx.add_dot;
  const float two_c = 2.f * __ldg(c_sq);

  if (t < kRows) us[t] = (i0 + t < m) ? u[i0 + t] : 0.f;

  float acc[kGradOut / 8];
#pragma unroll
  for (int q = 0; q < kGradOut / 8; ++q) acc[q] = 0.f;
  float rowsum = 0.f;

  for (int j0 = 0; j0 < n; j0 += kCols) {
    // vs is read after tile_dots' barriers; the previous tile's last
    // read of it ended at the barrier closing the loop body
    if (t < kCols) vs[t] = (j0 + t < n) ? v[j0 + t] : 0.f;
    float dot[2][4];
    tile_dots(a, b, i0, j0, m, n, d, as, bs, na, nb, dot);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int li = ty + 16 * r, lj = tx + 16 * c;
        const int i = i0 + li, j = j0 + lj;
        float tv = 0.f, tmv = 0.f;
        if (i < m && j < n && !(exclude_diag && i == j)) {
          const float d2 = fmaxf(na[li] + nb[lj] - 2.f * dot[r][c], 0.f);
          const float k = mixture_k(d2, dot[r][c], mx);
          const float g = mixture_g(d2, mx);
          const float coeff = us[li] + vs[lj] + two_c * k;
          tv = coeff * g;
          tmv = coeff * (g - half_dot);
        }
        t_sum[li][lj] = tv;
        t_mat[li][lj] = tmv;
      }
    }
    __syncthreads();

    for (int jj = al; jj < kCols; jj += 8) rowsum += t_sum[ar][jj];
    const int jn = min(kCols, n - j0);
    for (int jj = 0; jj < jn; ++jj) {
      const float w = t_mat[ar][jj];
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

// Number of per-block partials of sum_sq (the scratch size) the forward needs.
int smmdax_pair_stats_partials(int m) { return (m + kRows - 1) / kRows; }

int smmdax_pair_stats_fwd(const float* a, const float* b, float* rows,
                          float* partials, int num_partials, float* sum_sq,
                          int m, int n, int d, int exclude_diag, Mix mix,
                          void* stream) {
  if (!valid(m, n, d, mix) || num_partials != smmdax_pair_stats_partials(m))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pair_stats_rows<<<num_partials, kThreads, 0, s>>>(a, b, rows, partials, m, n, d,
                                                    exclude_diag, mix);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<<<1, kThreads, 0, s>>>(partials, num_partials, sum_sq);
  return (int)cudaGetLastError();
}

int smmdax_pair_stats_grad_a(const float* a, const float* b, const float* u,
                             const float* v, const float* c_sq, float* da,
                             int m, int n, int d, int exclude_diag, Mix mix,
                             void* stream) {
  if (!valid(m, n, d, mix)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((m + kRows - 1) / kRows, (d + kGradOut - 1) / kGradOut);
  pair_stats_grad_rows<<<grid, kThreads, 0, s>>>(a, b, u, v, c_sq, da, m, n, d,
                                                 exclude_diag, mix);
  return (int)cudaGetLastError();
}

const char* smmdax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
