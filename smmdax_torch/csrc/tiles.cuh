// The tile engine shared by the pair-sum and pair-stats kernels: the pair
// space of an (m, d) x (n, d) block cut into TILE x TILE tiles (16, 32 or
// 64 pairs a side, picked so the grid fills the card), feature chunks
// staged into shared memory by cp.async, register-blocked dot products,
// and the one-sweep gradient body that gives da and db from the same tile
// of T.
//
// Forward: one tile per block (tile_dots gives the tile's <a_i, b_j> and
// the norms of its rows; the caller reduces the mixture over it).
//
// Gradient (grad_tiles): for a functional whose pair (i, j) carries
// coeff_ij * k_ij,
//   da_i = rowsum(T)_i a_i - (T' b)_i,   db_j = colsum(T)_j b_j - (T'^T a)_j,
//   T_ij = mask_ij coeff_ij g_ij,  T'_ij = mask_ij coeff_ij (g_ij - add_dot/2),
// without the factor 2 of d(d2)/da.  The coefficient is a functor of
// (i, j, k_ij): the pair-stats kernels use u_i + v_j + 2 c k_ij, the
// pair-sum kernels 1 (their factor * c multiplies in the reduction pass).
// Each block walks a rectangle of tiles (at most kMaxGroups groups per
// dimension, which bounds the scratch).  The a-tile stays resident while
// the block walks the column tiles, and the next b-tile is staged by
// cp.async into a second buffer while the current one is worked.  T and
// T' go to shared memory, and T' b, T'^T a are taken from the a- and
// b-tiles already there, in register blocks of four features.  Each block
// adds its da (db) contributions into its own slice of scratch, indexed
// by its column (row) group; only the thread that owns an element ever
// touches it.  grad_sum then sums the slices in a fixed order: every sum
// is deterministic and there are no atomics.
//
// d is staged in chunks of kKC features padded to a multiple of 4
// (16-byte copies where rows are aligned); d <= kKC keeps whole rows
// resident in the gradient.
//
// Each .cu file that includes this header is its own shared library, so
// everything here lives in an anonymous namespace (one copy per library).

#pragma once

#include <stdint.h>

#include "mixture.cuh"

namespace {

constexpr int kKC = 64;          // features per staged chunk
constexpr int kPitch = kKC + 4;  // row pitch in floats: 16-byte aligned rows
constexpr int kMaxGroups = 16;   // gradient: row (column) groups of the grid

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

// The forward's tile: dot[r][c] = <a_{i0 + ty + 16r}, b_{j0 + tx + 16c}>
// over every feature chunk, staged through as and bs, and the squared
// norms of the tile's rows in na (a) and nb (b), published by a barrier.
template <int TILE>
__device__ __forceinline__ void tile_dots(float* as, float* bs, const float* __restrict__ a,
                                          const float* __restrict__ b, int i0, int j0, int m,
                                          int n, int d, bool vec,
                                          float (&dot)[TILE / 16][TILE / 16], float* na,
                                          float* nb) {
  constexpr int R = TILE / 16;
  const int t = threadIdx.x;
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
// gradient: a rectangle of tiles per block, then a fixed-order pass

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

// The gradient body of one block of a (row groups, column groups) grid,
// row_tiles x col_tiles tiles per group, into its slices of da_part
// (indexed by column group) and db_part (by row group).  smem holds
// grad_smem_floats<TILE>() floats; coeff(i, j, k_ij) is the pair's
// coefficient.
template <int TILE, class Coeff>
__device__ __forceinline__ void grad_tiles(float* smem, const float* __restrict__ a,
                                           const float* __restrict__ b, const Coeff& coeff,
                                           float* __restrict__ da_part,
                                           float* __restrict__ db_part, int m, int n, int d,
                                           int row_tiles, int col_tiles, int exclude_diag,
                                           int need_a, int need_b, int vec, const Mix& mx) {
  constexpr int R = TILE / 16;
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
            const float cf = coeff(i, j, k);
            tv = cf * g;
            tpv = cf * (g - half_dot);
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

// The reduction pass: out[e] = f * sum over the groups of part[g][e], first
// da (md elements, da_groups partials), then db (nd elements, db_groups).
__device__ __forceinline__ void grad_sum(const float* __restrict__ da_part, int da_groups,
                                         const float* __restrict__ db_part, int db_groups,
                                         float* __restrict__ da, float* __restrict__ db,
                                         size_t md, size_t nd, float f) {
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < md + nd;
       e += (size_t)gridDim.x * kThreads) {
    float s = 0.f;
    if (e < md) {
      for (int g = 0; g < da_groups; ++g) s += da_part[g * md + e];
      da[e] = f * s;
    } else {
      for (int g = 0; g < db_groups; ++g) s += db_part[g * nd + e - md];
      db[e - md] = f * s;
    }
  }
}

// Tile side for an m x n block: the largest whose grid fills the card.
inline int tile_for(int m, int n) {
  if (cdiv(m, 64) * cdiv(n, 64) >= 132) return 64;
  if (cdiv(m, 32) * cdiv(n, 32) >= 132) return 32;
  return 16;
}

// Gradient grid: (row groups, column groups) and the tiles per group.
inline void grad_groups(int m, int n, int tile, int* rg, int* cg, int* rt, int* ct) {
  const int ti = cdiv(m, tile), tj = cdiv(n, tile);
  *rt = cdiv(ti, ti < kMaxGroups ? ti : kMaxGroups);
  *ct = cdiv(tj, tj < kMaxGroups ? tj : kMaxGroups);
  *rg = cdiv(ti, *rt);
  *cg = cdiv(tj, *ct);
}

// Floats of scratch a gradient needs: per-group partials of da and db.
inline long long grad_scratch(int m, int n, int d, int need_a, int need_b) {
  int rg, cg, rt, ct;
  grad_groups(m, n, tile_for(m, n), &rg, &cg, &rt, &ct);
  return (need_a ? (long long)cg * m * d : 0) + (need_b ? (long long)rg * n * d : 0);
}

// Blocks of the reduction pass over md + nd elements.
inline int grad_sum_blocks(size_t md, size_t nd) {
  const size_t want = (md + nd + kThreads - 1) / kThreads, cap = 8 * 132;
  return (int)(want < cap ? want : cap);
}

// Allow a kernel more than 48 KB of dynamic shared memory where it needs it.
template <class Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace
