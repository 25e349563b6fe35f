// Fused block statistics of a masked Gram block for the t-ratio (tmmd)
// estimator, and their gradient, each in one sweep over the pairs.
//
//   pair_stats_fwd:  rows_i = sum_j mask_ij k_ij      (m,)
//                    cols_j = sum_i mask_ij k_ij      (n,), optional
//                    sum_sq = sum_ij mask_ij k_ij^2   (scalar)
//   pair_stats_grad: for S = sum_i u_i rows_i + sum_j v_j cols_j + c sum_sq,
//                    without the factor 2 of d(d2)/da (a scale argument):
//                    da_i = rowsum(T)_i a_i - (T' b)_i       (optional)
//                    db_j = colsum(T)_j b_j - (T'^T a)_j     (optional)
//                    T_ij  = mask_ij coeff_ij g_ij,
//                    T'_ij = mask_ij coeff_ij (g_ij - add_dot/2),
//                    coeff_ij = u_i + v_j + 2 c k_ij
//
// with k_ij = k(||a_i - b_j||^2) the mixture of mixture.cuh and
// g = dk/d(d2).  Neither kernel materialises the (m, n) Gram matrix in
// device memory.
//
// Replaces the TPU kernels _stats_kernel/_pair_stats_fwd and
// _stats_bwd_kernel/_pair_stats_grad_a of smmdax/pallas/mmd_kernel.py.
// A TPU kernel can only accumulate into the block of the outer grid
// dimension, so JAX gets column sums from a second sweep over the swapped
// block and da, db from two calls.  Here one sweep gives rows, cols and
// sum_sq, and one gives da and db, since both sides read the same T.  Both
// run on the tile engine of tiles.cuh:
//   * the forward gives each block one tile.  It writes its partial row
//     sums to scratch indexed by its column tile, its partial column sums
//     indexed by its row tile, and one partial of sum_sq;
//   * the gradient is the engine's grad_tiles with coeff = u_i + v_j +
//     2 c k_ij;
//   * a fixed-order pass sums the partials into the outputs: every sum is
//     deterministic and there are no atomics.
// u and v are plain float32 vectors (a null pointer reads as zeros).  c is
// read on the card (__ldg): it is an autograd cotangent there, and reading
// it on the host would synchronise every backward.
//
// Bound on an H100: at the tmmd step's 64 x 16 features both are bound by
// launch latency (4,032 pairs).  At large m, n the work is m*n pairs of
// d FMAs plus the mixture (the backward needs both k and g, from one pass
// over its terms, and 2d more FMAs for T' b and T'^T a): bound by float32
// operations, on the FP32 pipes.
//
// Plain C interface for ctypes; every entry point returns
// cudaGetLastError() after its launches.

#include "tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// forward: one tile per block, then a fixed-order pass

template <int TILE>
__global__ void __launch_bounds__(kThreads)
pair_stats_tiles(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ rows_part, float* __restrict__ cols_part,
                 float* __restrict__ sq_part, int m, int n, int d, int exclude_diag,
                 int want_cols, int vec, Mix mx) {
  constexpr int R = TILE / 16;
  __shared__ __align__(16) float as[TILE * kPitch];
  __shared__ __align__(16) float bs[TILE * kPitch];
  __shared__ float na[TILE], nb[TILE];
  __shared__ float col_buf[16][TILE];
  __shared__ float warp_sums[kThreads / 32];

  const int t = threadIdx.x, tx = t % 16, ty = t / 16;  // rows ty + 16r, cols tx + 16c
  const int i0 = blockIdx.x * TILE, j0 = blockIdx.y * TILE;

  float dot[R][R];
  tile_dots<TILE>(as, bs, a, b, i0, j0, m, n, d, vec, dot, na, nb);

  float row_acc[R], col_acc[R], sq = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) row_acc[r] = col_acc[r] = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int li = ty + 16 * r, lj = tx + 16 * c;
      const int i = i0 + li, j = j0 + lj;
      if (i < m && j < n && !(exclude_diag && i == j)) {
        const float d2 = fmaxf(na[li] + nb[lj] - 2.f * dot[r][c], 0.f);
        float k, g;
        mixture_kg<false>(d2, dot[r][c], mx, k, g);
        row_acc[r] += k;
        col_acc[c] += k;
        sq = fmaf(k, k, sq);
      }
    }
  }
  // the 16 lanes of a row (fixed ty) are one half of a warp
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      row_acc[r] += __shfl_xor_sync(0xffffffffu, row_acc[r], off);
    const int i = i0 + ty + 16 * r;
    if (tx == 0 && i < m) rows_part[(size_t)blockIdx.y * m + i] = row_acc[r];
  }
  if (want_cols) {
#pragma unroll
    for (int c = 0; c < R; ++c) col_buf[ty][tx + 16 * c] = col_acc[c];
  }
  const float total = block_sum(sq, warp_sums);  // its barrier publishes col_buf
  if (want_cols && t < TILE && j0 + t < n) {
    float s = 0.f;
    for (int y = 0; y < 16; ++y) s += col_buf[y][t];
    cols_part[(size_t)blockIdx.x * n + j0 + t] = s;
  }
  if (t == 0) sq_part[blockIdx.y * gridDim.x + blockIdx.x] = total;
}

// Block 0 sums the sum_sq partials; the others sum row e (e < m) over the
// row_parts column tiles, or column e - m over the col_parts row tiles.
__global__ void __launch_bounds__(kThreads)
pair_stats_sum(const float* __restrict__ rows_part, int row_parts,
               const float* __restrict__ cols_part, int col_parts,
               const float* __restrict__ sq_part, int sq_parts, float* __restrict__ rows,
               float* __restrict__ cols, float* __restrict__ sum_sq, int m, int n) {
  __shared__ float warp_sums[kThreads / 32];
  if (blockIdx.x == 0) {
    float s = 0.f;
    for (int e = threadIdx.x; e < sq_parts; e += kThreads) s += sq_part[e];
    const float total = block_sum(s, warp_sums);
    if (threadIdx.x == 0) *sum_sq = total;
    return;
  }
  const int e = (blockIdx.x - 1) * kThreads + threadIdx.x;
  if (e < m) {
    float s = 0.f;
    for (int p = 0; p < row_parts; ++p) s += rows_part[(size_t)p * m + e];
    rows[e] = s;
  } else if (cols != nullptr && e - m < n) {
    float s = 0.f;
    for (int p = 0; p < col_parts; ++p) s += cols_part[(size_t)p * n + e - m];
    cols[e - m] = s;
  }
}

// ---------------------------------------------------------------------------
// gradient: the engine's rectangle of tiles per block, then a fixed-order pass

// coeff_ij = u_i + v_j + 2 c k_ij; u, v null read as zeros
struct StatsCoeff {
  const float* u;
  const float* v;
  float two_c;
  __device__ __forceinline__ float operator()(int i, int j, float k) const {
    return (u ? __ldg(u + i) : 0.f) + (v ? __ldg(v + j) : 0.f) + two_c * k;
  }
};

template <int TILE>
__global__ void __launch_bounds__(kThreads)
pair_stats_grad_tiles(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ u, const float* __restrict__ v,
                      const float* __restrict__ c_sq, float* __restrict__ da_part,
                      float* __restrict__ db_part, int m, int n, int d, int row_tiles,
                      int col_tiles, int exclude_diag, int need_a, int need_b, int vec,
                      Mix mx) {
  extern __shared__ __align__(16) float smem[];
  grad_tiles<TILE>(smem, a, b, StatsCoeff{u, v, 2.f * __ldg(c_sq)}, da_part, db_part, m, n,
                   d, row_tiles, col_tiles, exclude_diag, need_a, need_b, vec, mx);
}

// out[e] = scale * sum over the groups of part[g][e], first da, then db.
__global__ void __launch_bounds__(kThreads)
pair_stats_grad_sum(const float* __restrict__ da_part, int da_groups,
                    const float* __restrict__ db_part, int db_groups,
                    float* __restrict__ da, float* __restrict__ db, size_t md, size_t nd,
                    float scale) {
  grad_sum(da_part, da_groups, db_part, db_groups, da, db, md, nd, scale);
}

template <int TILE>
cudaError_t launch_fwd(const float* a, const float* b, float* rows, float* cols,
                       float* sum_sq, float* scratch, int m, int n, int d, int exclude_diag,
                       int vec, const Mix& mix, cudaStream_t s) {
  const int ti = cdiv(m, TILE), tj = cdiv(n, TILE);
  float* rows_part = scratch;
  float* cols_part = rows_part + (size_t)tj * m;
  float* sq_part = cols_part + (cols ? (size_t)ti * n : 0);
  pair_stats_tiles<TILE><<<dim3(ti, tj), kThreads, 0, s>>>(
      a, b, rows_part, cols_part, sq_part, m, n, d, exclude_diag, cols != nullptr, vec, mix);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int elems = m + (cols ? n : 0);
  pair_stats_sum<<<1 + cdiv(elems, kThreads), kThreads, 0, s>>>(
      rows_part, tj, cols_part, ti, sq_part, ti * tj, rows, cols, sum_sq, m, n);
  return cudaGetLastError();
}

template <int TILE>
cudaError_t launch_grad(const float* a, const float* b, const float* u, const float* v,
                        const float* c_sq, float* da, float* db, float* scratch, int m,
                        int n, int d, int exclude_diag, int vec, float scale,
                        const Mix& mix, cudaStream_t s) {
  int rg, cg, rt, ct;
  grad_groups(m, n, TILE, &rg, &cg, &rt, &ct);
  const size_t md = da ? (size_t)m * d : 0, nd = db ? (size_t)n * d : 0;
  float* da_part = scratch;
  float* db_part = scratch + cg * md;
  const size_t smem = grad_smem_floats<TILE>() * sizeof(float);
  cudaError_t err = allow_smem(pair_stats_grad_tiles<TILE>, smem);
  if (err != cudaSuccess) return err;
  pair_stats_grad_tiles<TILE><<<dim3(rg, cg), kThreads, smem, s>>>(
      a, b, u, v, c_sq, da_part, db_part, m, n, d, rt, ct, exclude_diag, da != nullptr,
      db != nullptr, vec, mix);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pair_stats_grad_sum<<<grad_sum_blocks(md, nd), kThreads, 0, s>>>(da_part, cg, db_part, rg,
                                                                   da, db, md, nd, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch the forward needs (per-tile partials).
long long smmdax_pair_stats_fwd_scratch(int m, int n, int want_cols) {
  const int tile = tile_for(m, n), ti = cdiv(m, tile), tj = cdiv(n, tile);
  return (long long)tj * m + (want_cols ? (long long)ti * n : 0) + (long long)ti * tj;
}

// rows (m,), cols (n,) unless null, sum_sq () in one sweep.
int smmdax_pair_stats_fwd(const float* a, const float* b, float* rows, float* cols,
                          float* sum_sq, float* scratch, long long scratch_len, int m,
                          int n, int d, int exclude_diag, Mix mix, void* stream) {
  if (!valid(m, n, d, mix) ||
      scratch_len != smmdax_pair_stats_fwd_scratch(m, n, cols != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = d % 4 == 0 && aligned16(a) && aligned16(b);
  switch (tile_for(m, n)) {
    case 64: return (int)launch_fwd<64>(a, b, rows, cols, sum_sq, scratch, m, n, d, exclude_diag, vec, mix, s);
    case 32: return (int)launch_fwd<32>(a, b, rows, cols, sum_sq, scratch, m, n, d, exclude_diag, vec, mix, s);
    default: return (int)launch_fwd<16>(a, b, rows, cols, sum_sq, scratch, m, n, d, exclude_diag, vec, mix, s);
  }
}

// Floats of scratch the gradient needs (per-group partials of da and db).
long long smmdax_pair_stats_grad_scratch(int m, int n, int d, int need_a, int need_b) {
  return grad_scratch(m, n, d, need_a, need_b);
}

// da (m, d) unless null and db (n, d) unless null, times scale, in one
// sweep; u, v may be null (zeros), c_sq is one float on the card.
int smmdax_pair_stats_grad(const float* a, const float* b, const float* u, const float* v,
                           const float* c_sq, float* da, float* db, float* scratch,
                           long long scratch_len, int m, int n, int d, int exclude_diag,
                           float scale, Mix mix, void* stream) {
  if (!valid(m, n, d, mix) || (da == nullptr && db == nullptr) ||
      scratch_len != smmdax_pair_stats_grad_scratch(m, n, d, da != nullptr, db != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = d % 4 == 0 && aligned16(a) && aligned16(b);
  switch (tile_for(m, n)) {
    case 64: return (int)launch_grad<64>(a, b, u, v, c_sq, da, db, scratch, m, n, d, exclude_diag, vec, scale, mix, s);
    case 32: return (int)launch_grad<32>(a, b, u, v, c_sq, da, db, scratch, m, n, d, exclude_diag, vec, scale, mix, s);
    default: return (int)launch_grad<16>(a, b, u, v, c_sq, da, db, scratch, m, n, d, exclude_diag, vec, scale, mix, s);
  }
}

const char* smmdax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
