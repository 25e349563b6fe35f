// Fused pairwise-kernel sums for the MMD^2 estimator, and their gradient,
// each in one sweep over the pairs.
//
//   pair_sum_fwd:  S = sum_ij mask_ij k_ij                  (scalar)
//   pair_sum_grad: dS/da and dS/db times factor * c, without the factor 2
//                  of d(d2)/da (the caller's factor holds it):
//                  da_i = rowsum(T)_i a_i - (T' b)_i        (optional)
//                  db_j = colsum(T)_j b_j - (T'^T a)_j      (optional)
//                  T_ij = mask_ij g_ij, T'_ij = mask_ij (g_ij - add_dot/2)
//
// with k_ij = k(||a_i - b_j||^2) the mixture of mixture.cuh and
// g = dk/d(d2).  The mask drops the diagonal of a self block
// (exclude_diag).  Neither kernel materialises the (m, n) Gram matrix in
// device memory.
//
// Replaces the TPU kernels _fwd_kernel/_pair_sum and
// _bwd_kernel/_pair_sum_grad_a of smmdax/pallas/mmd_kernel.py.  The TPU
// grid runs in order on one core, so those kernels carried a scalar
// (forward) and a row block of da (backward) from one grid step to the
// next, and JAX takes db from a second call on the swapped block.  Blocks
// run in no order here, and the flagship's 64 x 64 block is 4,032 pairs:
// one TPU-sized tile would be one block on one of 132 SMs.  So both run on
// the tile engine of tiles.cuh (shared with pair_stats.cu):
//   * the forward gives each block one TILE x TILE tile (16, 32 or 64
//     pairs a side, the largest whose grid fills the card: 16 blocks of
//     16 x 16 at 64 x 64), with the dot products register-blocked over
//     64-feature chunks padded to 4 and staged by cp.async.  Each block
//     writes one partial of S; a one-block pass sums them in index order;
//   * the gradient is the engine's grad_tiles with coefficient 1: one
//     sweep gives da and db (both read the same T), with b staged in
//     shared memory for T' b and T'^T a.  The pass sums the per-group
//     partials in a fixed order and multiplies by factor * c, where c (an
//     autograd cotangent) is read on the card: reading it on the host would
//     synchronise every backward.  A null c reads as 1.
// Every sum is deterministic and there are no atomics: a repeated launch
// on the same inputs repeats its result bit for bit.
//
// Bound on an H100: at the flagship's 64 x 16 features both are bound by
// launch latency (4,032 pairs).  At large m, n the work is m*n pairs of
// d FMAs plus the mixture (one expf and one log1pf per rq term; the
// gradient takes k and g from that one pass) and, in the gradient, 2d
// FMAs per side for T' b and T'^T a: bound by float32 operations, on the
// FP32 pipes (the inputs are read from shared memory many times, the
// outputs are a scalar or (m, d) and (n, d)).
//
// Plain C interface for ctypes; every entry point returns
// cudaGetLastError() after its launches.

#include "tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// forward: one tile per block, then a fixed-order pass

template <int TILE>
__global__ void __launch_bounds__(kThreads)
pair_sum_tiles(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ part, int m, int n, int d, int exclude_diag, int vec,
               Mix mx) {
  constexpr int R = TILE / 16;
  __shared__ __align__(16) float as[TILE * kPitch];
  __shared__ __align__(16) float bs[TILE * kPitch];
  __shared__ float na[TILE], nb[TILE];
  __shared__ float warp_sums[kThreads / 32];

  const int t = threadIdx.x, tx = t % 16, ty = t / 16;  // rows ty + 16r, cols tx + 16c
  const int i0 = blockIdx.x * TILE, j0 = blockIdx.y * TILE;

  float dot[R][R];
  tile_dots<TILE>(as, bs, a, b, i0, j0, m, n, d, vec, dot, na, nb);

  float s = 0.f;
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
        s += k;
      }
    }
  }
  const float total = block_sum(s, warp_sums);
  if (t == 0) part[blockIdx.y * gridDim.x + blockIdx.x] = total;
}

// One block: the partials of S summed in index order.
__global__ void __launch_bounds__(kThreads)
pair_sum_sum(const float* __restrict__ part, int count, float* __restrict__ out) {
  __shared__ float warp_sums[kThreads / 32];
  float s = 0.f;
  for (int e = threadIdx.x; e < count; e += kThreads) s += part[e];
  const float total = block_sum(s, warp_sums);
  if (threadIdx.x == 0) *out = total;
}

// ---------------------------------------------------------------------------
// gradient: the engine's rectangle of tiles per block, then a fixed-order pass

// Every pair's coefficient is 1: the factor * c of the pair sum multiplies
// in the pass.
struct UnitCoeff {
  __device__ __forceinline__ float operator()(int, int, float) const { return 1.f; }
};

template <int TILE>
__global__ void __launch_bounds__(kThreads)
pair_sum_grad_tiles(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ da_part, float* __restrict__ db_part, int m, int n,
                    int d, int row_tiles, int col_tiles, int exclude_diag, int need_a,
                    int need_b, int vec, Mix mx) {
  extern __shared__ __align__(16) float smem[];
  grad_tiles<TILE>(smem, a, b, UnitCoeff{}, da_part, db_part, m, n, d, row_tiles, col_tiles,
                   exclude_diag, need_a, need_b, vec, mx);
}

// out[e] = factor * c * sum over the groups of part[g][e], first da, then
// db; c null reads as 1.
__global__ void __launch_bounds__(kThreads)
pair_sum_grad_sum(const float* __restrict__ da_part, int da_groups,
                  const float* __restrict__ db_part, int db_groups, float* __restrict__ da,
                  float* __restrict__ db, size_t md, size_t nd, const float* __restrict__ c,
                  float factor) {
  grad_sum(da_part, da_groups, db_part, db_groups, da, db, md, nd,
           c ? factor * __ldg(c) : factor);
}

template <int TILE>
cudaError_t launch_fwd(const float* a, const float* b, float* out, float* scratch, int m,
                       int n, int d, int exclude_diag, int vec, const Mix& mix,
                       cudaStream_t s) {
  const int ti = cdiv(m, TILE), tj = cdiv(n, TILE);
  pair_sum_tiles<TILE><<<dim3(ti, tj), kThreads, 0, s>>>(a, b, scratch, m, n, d, exclude_diag,
                                                         vec, mix);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pair_sum_sum<<<1, kThreads, 0, s>>>(scratch, ti * tj, out);
  return cudaGetLastError();
}

template <int TILE>
cudaError_t launch_grad(const float* a, const float* b, const float* c, float* da, float* db,
                        float* scratch, int m, int n, int d, int exclude_diag, int vec,
                        float factor, const Mix& mix, cudaStream_t s) {
  int rg, cg, rt, ct;
  grad_groups(m, n, TILE, &rg, &cg, &rt, &ct);
  const size_t md = da ? (size_t)m * d : 0, nd = db ? (size_t)n * d : 0;
  float* da_part = scratch;
  float* db_part = scratch + cg * md;
  const size_t smem = grad_smem_floats<TILE>() * sizeof(float);
  cudaError_t err = allow_smem(pair_sum_grad_tiles<TILE>, smem);
  if (err != cudaSuccess) return err;
  pair_sum_grad_tiles<TILE><<<dim3(rg, cg), kThreads, smem, s>>>(
      a, b, da_part, db_part, m, n, d, rt, ct, exclude_diag, da != nullptr, db != nullptr, vec,
      mix);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pair_sum_grad_sum<<<grad_sum_blocks(md, nd), kThreads, 0, s>>>(da_part, cg, db_part, rg, da,
                                                                 db, md, nd, c, factor);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch the forward needs (one partial per tile).
long long smmdax_pair_sum_fwd_scratch(int m, int n) {
  const int tile = tile_for(m, n);
  return (long long)cdiv(m, tile) * cdiv(n, tile);
}

// S () in one sweep.
int smmdax_pair_sum_fwd(const float* a, const float* b, float* out, float* scratch,
                        long long scratch_len, int m, int n, int d, int exclude_diag, Mix mix,
                        void* stream) {
  if (!valid(m, n, d, mix) || scratch_len != smmdax_pair_sum_fwd_scratch(m, n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = d % 4 == 0 && aligned16(a) && aligned16(b);
  switch (tile_for(m, n)) {
    case 64: return (int)launch_fwd<64>(a, b, out, scratch, m, n, d, exclude_diag, vec, mix, s);
    case 32: return (int)launch_fwd<32>(a, b, out, scratch, m, n, d, exclude_diag, vec, mix, s);
    default: return (int)launch_fwd<16>(a, b, out, scratch, m, n, d, exclude_diag, vec, mix, s);
  }
}

// Floats of scratch the gradient needs (per-group partials of da and db).
long long smmdax_pair_sum_grad_scratch(int m, int n, int d, int need_a, int need_b) {
  return grad_scratch(m, n, d, need_a, need_b);
}

// da (m, d) unless null and db (n, d) unless null, times factor * c, in
// one sweep; c is one float on the card, or null for 1.
int smmdax_pair_sum_grad(const float* a, const float* b, const float* c, float* da, float* db,
                         float* scratch, long long scratch_len, int m, int n, int d,
                         int exclude_diag, float factor, Mix mix, void* stream) {
  if (!valid(m, n, d, mix) || (da == nullptr && db == nullptr) ||
      scratch_len != grad_scratch(m, n, d, da != nullptr, db != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = d % 4 == 0 && aligned16(a) && aligned16(b);
  switch (tile_for(m, n)) {
    case 64: return (int)launch_grad<64>(a, b, c, da, db, scratch, m, n, d, exclude_diag, vec, factor, mix, s);
    case 32: return (int)launch_grad<32>(a, b, c, da, db, scratch, m, n, d, exclude_diag, vec, factor, mix, s);
    default: return (int)launch_grad<16>(a, b, c, da, db, scratch, m, n, d, exclude_diag, vec, factor, mix, s);
  }
}

const char* smmdax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
