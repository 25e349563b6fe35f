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
// sum_sq, and one gives da and db, since both sides read the same T:
//   * the pair space is tiled in two dimensions, TILE x TILE pairs
//     (16, 32 or 64, picked so the grid fills the card);
//   * the forward gives each block one tile.  It writes its partial row
//     sums to scratch indexed by its column tile, its partial column sums
//     indexed by its row tile, and one partial of sum_sq;
//   * the backward gives each block a rectangle of tiles (at most 16
//     groups per dimension, which bounds the scratch).  The a-tile stays
//     resident while the block walks the column tiles, and the next b-tile
//     is staged by cp.async into a second buffer while the current one is
//     worked.  T and T' go to shared memory, and T' b, T'^T a are taken
//     from the a- and b-tiles already there, in register blocks of four
//     features.  Each block adds its da (db) contributions into its own
//     slice of scratch, indexed by its column (row) group; only the thread
//     that owns an element ever touches it;
//   * a fixed-order pass sums the partials into the outputs: every sum is
//     deterministic and there are no atomics.
// u and v are plain float32 vectors (a null pointer reads as zeros).  c is
// read on the card (__ldg): it is an autograd cotangent there, and reading
// it on the host would synchronise every backward.  d is staged in chunks
// of kKC features padded to a multiple of 4 (16-byte copies where rows are
// aligned); d <= kKC keeps whole rows resident.
//
// Bound on an H100: at the tmmd step's 64 x 16 features both are bound by
// launch latency (4,032 pairs).  At large m, n the work is m*n pairs of
// d FMAs plus the mixture (the backward needs both k and g, from one pass
// over its terms, and 2d more FMAs for T' b and T'^T a): bound by float32
// operations, on the FP32 pipes.
//
// Plain C interface for ctypes; every entry point returns
// cudaGetLastError() after its launches.

#include <stdint.h>

#include "mixture.cuh"

namespace {

constexpr int kKC = 64;          // features per staged chunk
constexpr int kPitch = kKC + 4;  // row pitch in floats: 16-byte aligned rows
constexpr int kMaxGroups = 16;   // backward: row (column) groups of the grid

__host__ __device__ __forceinline__ int cdiv(int x, int y) { return (x + y - 1) / y; }
__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows [r0, r0 + Rows) x features [k0, k0 + kKC) of x
// (row-major, width d) into s (pitch kPitch), features padded with zeros
// to a multiple of 4 and rows past nrows zero.  The caller commits and
// waits.  vec: d % 4 == 0 and x 16-byte aligned.
template <int Rows>
__device__ __forceinline__ void stage_rows(float* s, const float* __restrict__ x, int r0,
                                           int nrows, int k0, int d, bool vec) {
  const int w = min(d - k0, kKC), wp = round4(w);
  if (vec) {
    const int q = wp / 4;
    for (int e = threadIdx.x; e < Rows * q; e += kThreads) {
      const int r = e / q, c = 4 * (e % q);
      float* dst = s + r * kPitch + c;
      if (r0 + r < nrows) cp_async16(dst, x + (size_t)(r0 + r) * d + k0 + c);
      else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = threadIdx.x; e < Rows * wp; e += kThreads) {
      const int r = e / wp, c = e % wp;
      float* dst = s + r * kPitch + c;
      if (r0 + r < nrows && c < w) cp_async4(dst, x + (size_t)(r0 + r) * d + k0 + c);
      else *dst = 0.f;
    }
  }
}

// dot[r][c] += <as row ty + 16r, bs row tx + 16c> over the wp staged
// features; threads [0, TILE) add ||a row t||^2 to norm, [TILE, 2 TILE)
// ||b row t - TILE||^2.
template <int TILE>
__device__ __forceinline__ void add_dots(const float* __restrict__ as,
                                         const float* __restrict__ bs, int wp,
                                         float (&dot)[TILE / 16][TILE / 16], float& norm) {
  constexpr int R = TILE / 16;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  if (t < 2 * TILE) {
    const float* p = (t < TILE) ? as + t * kPitch : bs + (t - TILE) * kPitch;
    for (int k = 0; k < wp; ++k) norm = fmaf(p[k], p[k], norm);
  }
  for (int k = 0; k < wp; k += 4) {
    float4 av[R], bv[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      av[r] = *reinterpret_cast<const float4*>(as + (ty + 16 * r) * kPitch + k);
#pragma unroll
    for (int c = 0; c < R; ++c)
      bv[c] = *reinterpret_cast<const float4*>(bs + (tx + 16 * c) * kPitch + k);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < R; ++c) {
        float s = dot[r][c];
        s = fmaf(av[r].x, bv[c].x, s);
        s = fmaf(av[r].y, bv[c].y, s);
        s = fmaf(av[r].z, bv[c].z, s);
        dot[r][c] = fmaf(av[r].w, bv[c].w, s);
      }
  }
}

// Fixed-order sum of x over one block; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float x, float* warp_sums) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  return total;
}

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
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) dot[r][c] = 0.f;
  float norm = 0.f;
  for (int k0 = 0; k0 < d; k0 += kKC) {
    stage_rows<TILE>(as, a, i0, m, k0, d, vec);
    stage_rows<TILE>(bs, b, j0, n, k0, d, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    add_dots<TILE>(as, bs, round4(min(d - k0, kKC)), dot, norm);
    __syncthreads();
  }
  if (t < TILE) na[t] = norm;
  else if (t < 2 * TILE) nb[t - TILE] = norm;
  __syncthreads();

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
// backward: a rectangle of tiles per block, then a fixed-order pass

template <int TILE>
constexpr int grad_smem_floats() {
  // a-tile, two b-tile buffers, T, T', norms and the row / column sums of T
  return 3 * TILE * kPitch + 2 * TILE * (TILE + 1) + 4 * TILE;
}

// out[x][k0 + k] (+)= sums[x] * own[x][k] - sum_y tp(x, y) * other[y][k] for
// the rows x < TILE of this tile (global index x0 + x < limit) and the wp
// staged features, in register blocks of four features.  tp(x, y) is
// T'[x][y] (ROWS) or T'[y][x] (columns).  Every element has one owning
// thread, the same for every tile of the walk.
template <int TILE, bool ROWS>
__device__ __forceinline__ void add_products(const float* __restrict__ tp,
                                             const float* __restrict__ sums,
                                             const float* __restrict__ own,
                                             const float* __restrict__ other,
                                             float* __restrict__ out, int x0, int limit,
                                             int k0, int d, bool first) {
  const int w = min(d - k0, kKC), groups = round4(w) / 4;
  for (int item = threadIdx.x; item < TILE * groups; item += kThreads) {
    const int x = item / groups, k = 4 * (item % groups);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int y = 0; y < TILE; ++y) {
      const float wgt = ROWS ? tp[x * (TILE + 1) + y] : tp[y * (TILE + 1) + x];
      const float4 o = *reinterpret_cast<const float4*>(other + y * kPitch + k);
      acc.x = fmaf(wgt, o.x, acc.x);
      acc.y = fmaf(wgt, o.y, acc.y);
      acc.z = fmaf(wgt, o.z, acc.z);
      acc.w = fmaf(wgt, o.w, acc.w);
    }
    if (x0 + x >= limit) continue;
    const float4 s = *reinterpret_cast<const float4*>(own + x * kPitch + k);
    const float vals[4] = {sums[x] * s.x - acc.x, sums[x] * s.y - acc.y,
                           sums[x] * s.z - acc.z, sums[x] * s.w - acc.w};
    float* p = out + (size_t)(x0 + x) * d + k0 + k;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (k + q < w) p[q] = first ? vals[q] : p[q] + vals[q];
  }
}

template <int TILE>
__global__ void __launch_bounds__(kThreads)
pair_stats_grad_tiles(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ u, const float* __restrict__ v,
                      const float* __restrict__ c_sq, float* __restrict__ da_part,
                      float* __restrict__ db_part, int m, int n, int d, int row_tiles,
                      int col_tiles, int exclude_diag, int need_a, int need_b, int vec,
                      Mix mx) {
  constexpr int R = TILE / 16;
  extern __shared__ __align__(16) float smem[];
  float* as = smem;  // then the two b buffers, buffer q at smem + (1 + q) TILE kPitch
  float* tm = smem + 3 * TILE * kPitch;  // T   (pitch TILE + 1)
  float* tp = tm + TILE * (TILE + 1);    // T'  (pitch TILE + 1)
  float* na = tp + TILE * (TILE + 1);
  float* nb = na + TILE;
  float* rsum = nb + TILE;
  float* csum = rsum + TILE;

  const int t = threadIdx.x, tx = t % 16, ty = t / 16;  // pairs: rows ty + 16r, cols tx + 16c
  const int ti0 = blockIdx.x * row_tiles, ti1 = min(ti0 + row_tiles, cdiv(m, TILE));
  const int tj0 = blockIdx.y * col_tiles, tj1 = min(tj0 + col_tiles, cdiv(n, TILE));
  float* da_out = da_part + (size_t)blockIdx.y * m * d;  // indexed by column group
  float* db_out = db_part + (size_t)blockIdx.x * n * d;  // indexed by row group
  const float two_c = 2.f * __ldg(c_sq);
  const float half_dot = 0.5f * mx.add_dot;
  const bool resident = d <= kKC;
  const int wp = round4(min(d, kKC));

  int buf = 0;
  if (resident) {
    stage_rows<TILE>(smem + TILE * kPitch, b, tj0 * TILE, n, 0, d, vec);
    cp_async_commit();
  }
  for (int ti = ti0; ti < ti1; ++ti) {
    const int i0 = ti * TILE;
    if (resident) {
      stage_rows<TILE>(as, a, i0, m, 0, d, vec);
      cp_async_commit();
    }
    for (int tj = tj0; tj < tj1; ++tj) {
      const int j0 = tj * TILE;
      float dot[R][R];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) dot[r][c] = 0.f;
      float norm = 0.f;
      if (resident) {
        // the next b-tile of the walk goes to the other buffer, whose last
        // reads ended at the barrier closing the previous tile
        const int next = tj + 1 < tj1 ? tj + 1 : (ti + 1 < ti1 ? tj0 : -1);
        if (next >= 0) {
          stage_rows<TILE>(smem + (2 - buf) * TILE * kPitch, b, next * TILE, n, 0, d, vec);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        add_dots<TILE>(as, smem + (1 + buf) * TILE * kPitch, wp, dot, norm);
      } else {
        for (int k0 = 0; k0 < d; k0 += kKC) {
          stage_rows<TILE>(as, a, i0, m, k0, d, vec);
          stage_rows<TILE>(smem + TILE * kPitch, b, j0, n, k0, d, vec);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
          add_dots<TILE>(as, smem + TILE * kPitch, round4(min(d - k0, kKC)), dot, norm);
          __syncthreads();
        }
      }
      if (t < TILE) na[t] = norm;
      else if (t < 2 * TILE) nb[t - TILE] = norm;
      __syncthreads();

#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int li = ty + 16 * r, lj = tx + 16 * c;
          const int i = i0 + li, j = j0 + lj;
          float tv = 0.f, tpv = 0.f;
          if (i < m && j < n && !(exclude_diag && i == j)) {
            const float d2 = fmaxf(na[li] + nb[lj] - 2.f * dot[r][c], 0.f);
            float k, g;
            mixture_kg<true>(d2, dot[r][c], mx, k, g);
            const float coeff = (u ? __ldg(u + i) : 0.f) + (v ? __ldg(v + j) : 0.f) + two_c * k;
            tv = coeff * g;
            tpv = coeff * (g - half_dot);
          }
          tm[li * (TILE + 1) + lj] = tv;
          tp[li * (TILE + 1) + lj] = tpv;
        }
      }
      __syncthreads();
      if (t < TILE) {
        float s = 0.f;
        for (int y = 0; y < TILE; ++y) s += tm[t * (TILE + 1) + y];
        rsum[t] = s;
      } else if (t < 2 * TILE) {
        float s = 0.f;
        for (int y = 0; y < TILE; ++y) s += tm[y * (TILE + 1) + t - TILE];
        csum[t - TILE] = s;
      }
      __syncthreads();

      for (int k0 = 0; k0 < d; k0 += kKC) {
        const float* bt = smem + (1 + buf) * TILE * kPitch;  // buf is 0 unless resident
        if (!resident) {
          stage_rows<TILE>(as, a, i0, m, k0, d, vec);
          stage_rows<TILE>(smem + TILE * kPitch, b, j0, n, k0, d, vec);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
        }
        if (need_a)
          add_products<TILE, true>(tp, rsum, as, bt, da_out, i0, m, k0, d, tj == tj0);
        if (need_b)
          add_products<TILE, false>(tp, csum, bt, as, db_out, j0, n, k0, d, ti == ti0);
        __syncthreads();
      }
      if (resident) buf ^= 1;
    }
  }
}

// out[e] = scale * sum over the groups of part[g][e], first da (md
// elements, da_groups partials), then db (nd elements, db_groups).
__global__ void __launch_bounds__(kThreads)
pair_stats_grad_sum(const float* __restrict__ da_part, int da_groups,
                    const float* __restrict__ db_part, int db_groups,
                    float* __restrict__ da, float* __restrict__ db, size_t md, size_t nd,
                    float scale) {
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < md + nd;
       e += (size_t)gridDim.x * kThreads) {
    float s = 0.f;
    if (e < md) {
      for (int g = 0; g < da_groups; ++g) s += da_part[g * md + e];
      da[e] = scale * s;
    } else {
      for (int g = 0; g < db_groups; ++g) s += db_part[g * nd + e - md];
      db[e - md] = scale * s;
    }
  }
}

// Tile side for an m x n block: the largest whose grid fills the card.
int tile_for(int m, int n) {
  if (cdiv(m, 64) * cdiv(n, 64) >= 132) return 64;
  if (cdiv(m, 32) * cdiv(n, 32) >= 132) return 32;
  return 16;
}

// Backward grid: (row groups, column groups) and the tiles per group.
void grad_groups(int m, int n, int tile, int* rg, int* cg, int* rt, int* ct) {
  const int ti = cdiv(m, tile), tj = cdiv(n, tile);
  *rt = cdiv(ti, ti < kMaxGroups ? ti : kMaxGroups);
  *ct = cdiv(tj, tj < kMaxGroups ? tj : kMaxGroups);
  *rg = cdiv(ti, *rt);
  *cg = cdiv(tj, *ct);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

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
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pair_stats_grad_tiles<TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  pair_stats_grad_tiles<TILE><<<dim3(rg, cg), kThreads, smem, s>>>(
      a, b, u, v, c_sq, da_part, db_part, m, n, d, rt, ct, exclude_diag, da != nullptr,
      db != nullptr, vec, mix);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = md + nd;
  const size_t want = (total + kThreads - 1) / kThreads, cap = 8 * 132;
  const int blocks = (int)(want < cap ? want : cap);
  pair_stats_grad_sum<<<blocks, kThreads, 0, s>>>(da_part, cg, db_part, rg, da, db, md, nd,
                                                  scale);
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
  int rg, cg, rt, ct;
  grad_groups(m, n, tile_for(m, n), &rg, &cg, &rt, &ct);
  return (need_a ? (long long)cg * m * d : 0) + (need_b ? (long long)rg * n * d : 0);
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
