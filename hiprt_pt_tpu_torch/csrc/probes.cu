// The round-5 gather probes for Hopper (sm_90a): two ways a traversal kernel
// can fetch leaf rows, measured on their own.
//
// mm_probe (P1) replaces the TPU kernel _mm_kernel
// (benchmarks/r5probe2.py:58): each round r gathers NL rows of a table tab
// (L, W) by a one-hot matrix product gl = tab^T . onehot(sl), with
// sl = (idx[r % 8, :] + r) mod L, takes each column's maximum over W and
// sums the maxima. The result equals
//   sum_r sum_j max_w tab[(idx[r % 8, j] + r) mod L, w].
// dg_probe (P2) replaces _dg_kernel (benchmarks/r5probe2.py:112): each
// round gathers, per 128-column tile c of a table tab (S, tiles * 128), the
// rows (idx[s, k] + r) mod S lane by lane, takes each lane's maximum over
// the S gathered rows and sums the maxima:
//   sum_r sum_c sum_k max_s tab[(idx[s, k] + r) mod S, c * 128 + k].
//
// P1 computes the one-hot product on the tensor cores, because the
// product's cost is what the probe measures: mma.sync m16n8k32 (s8 x s8 ->
// s32) for an int8 table, m16n8k16 (bf16 x bf16 -> f32) for a bf16 table.
// A is the table transposed, (W, L) with L contiguous, zero-padded to a
// multiple of 16 rows and 32 columns (the wrapper's one-time set-up copy);
// B, the one-hot matrix, is never stored: each lane knows the row sl of its
// B column and builds its B fragment in registers (one nonzero byte, or
// bf16 1.0, in the one k-step that holds sl). What bounds the function P1
// returns is its W NL rounds maxima (a few microseconds at the probe's
// shapes), not the product: the product's 2 L W NL rounds operations at the
// dense int8 or bf16 peak are the cost of the probe's method, and the share
// of that peak this kernel reaches is what the probe reports. It feeds
// mma.sync from L1/L2 with plain loads (wgmma and TMA-fed shared-memory
// tiles are for a later version). A warp owns 64 columns for one round and walks all of W in
// 16-row tiles, folding each tile's products into its columns' running
// maxima; `groups` keeps the TPU probe's meaning (one product per group of
// NL / groups columns with the group's slice of idx) and on the card only
// changes how the warps' 64-column tiles are laid over the columns: a tile
// never straddles a group, and its columns past the group's end are masked.
//
// P2 reads rows straight from device memory: a block per (tile, round), a
// thread per (lane, slice of the S rows); neighbouring lanes read
// neighbouring columns of their rows, so a broadcast index array gives
// coalesced rows and a per-lane one scattered words. What bounds P2 is
// bytes (the table, the indices and the output once); the gathered words
// come from L2, which holds the whole table at the probe's sizes.
//
// Both probes write one partial sum per (warp or block, round) and add the
// partials in a second pass in a fixed order, never with atomics, so the
// result repeats bit for bit. With integer table values every partial sum
// is an integer, exact in f32 below 2^24, and the result is exact.
//
// Built without -fmad=false (unlike the traversal sources): there is no
// floating-point product to keep bit-identical.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kMmWarps = 4;          // warps per block
constexpr int kMmTiles = 8;          // n8 tiles per warp
constexpr int kMmCols = 8 * kMmTiles;  // columns per warp
constexpr int kDgLanes = 128;        // lanes of a P2 tile
constexpr int kDgSlices = 8;         // slices of the S rows per block
constexpr int kSumThreads = 256;

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ uint32_t load_u32(const void* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// P1. Fragment layouts (PTX ISA, mma.m16n8k32 .s8 and mma.m16n8k16 .bf16):
// lane = 4 * g + q. A: rows g and g + 8; int8 columns 4q..4q+3 and
// 16 + 4q..; bf16 columns 2q, 2q+1 and 8 + 2q, 8 + 2q + 1. B: column g;
// int8 rows 4q..4q+3 (b0) and 16 + 4q.. (b1); bf16 rows 2q, 2q+1 (b0) and
// 8 + 2q.. (b1). C: rows g (c0, c1) and g + 8 (c2, c3), columns 2q, 2q+1.
template <bool kInt8>
__global__ void __launch_bounds__(kMmWarps * 32)
mm_probe_kernel(const void* __restrict__ tab_t, const int* __restrict__ idx,
                int L, int W, int w_pad, int l_pad, int nl, int groups,
                int tiles_per_group, float* __restrict__ partial) {
  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr int kStep = kInt8 ? 32 : 16;  // K of one mma
  constexpr int kElem = kInt8 ? 1 : 2;    // bytes per table element
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int r = blockIdx.y;
  const int n_wtiles = groups * tiles_per_group;
  const int wtile = blockIdx.x * kMmWarps + (threadIdx.x >> 5);
  float warp_sum = 0.0f;
  if (wtile < n_wtiles) {  // uniform over the warp
    const int gw = nl / groups;
    const int grp = wtile / tiles_per_group;
    const int col0 = (wtile % tiles_per_group) * kMmCols;  // within the group
    // the one-hot B column of this lane in each n8 tile: the k-step that
    // holds its row sl, and its two B registers in that step
    int kstep[kMmTiles];
    uint32_t bhot0[kMmTiles], bhot1[kMmTiles];
#pragma unroll
    for (int t = 0; t < kMmTiles; ++t) {
      const int c = col0 + 8 * t + g;
      kstep[t] = -1;
      bhot0[t] = bhot1[t] = 0u;
      if (c < gw) {
        const int sl = floor_mod(idx[(r % 8) * nl + grp * gw + c] + r, L);
        kstep[t] = sl / kStep;
        const int k = sl % kStep;
        if constexpr (kInt8) {
          const int d0 = k - 4 * q, d1 = k - 16 - 4 * q;
          if (d0 >= 0 && d0 < 4) bhot0[t] = 1u << (8 * d0);
          if (d1 >= 0 && d1 < 4) bhot1[t] = 1u << (8 * d1);
        } else {
          const int d0 = k - 2 * q, d1 = k - 8 - 2 * q;
          if (d0 == 0 || d0 == 1) bhot0[t] = 0x3F80u << (16 * d0);  // bf16 1.0
          if (d1 == 0 || d1 == 1) bhot1[t] = 0x3F80u << (16 * d1);
        }
      }
    }
    Acc lowest;
    if constexpr (kInt8) {
      lowest = INT_MIN;
    } else {
      lowest = -INFINITY;
    }
    Acc colmax[kMmTiles][2];
#pragma unroll
    for (int t = 0; t < kMmTiles; ++t) colmax[t][0] = colmax[t][1] = lowest;

    const char* A = static_cast<const char*>(tab_t);
    const int n_steps = l_pad / kStep;
    for (int m0 = 0; m0 < w_pad; m0 += 16) {
      const char* row_lo = A + (size_t)(m0 + g) * l_pad * kElem;
      const char* row_hi = row_lo + (size_t)8 * l_pad * kElem;
      Acc acc[kMmTiles][4];
#pragma unroll
      for (int t = 0; t < kMmTiles; ++t)
        acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0;
      for (int s = 0; s < n_steps; ++s) {
        const int k0 = s * kStep;
        uint32_t a[4];
        if constexpr (kInt8) {
          a[0] = load_u32(row_lo + k0 + 4 * q);
          a[1] = load_u32(row_hi + k0 + 4 * q);
          a[2] = load_u32(row_lo + k0 + 16 + 4 * q);
          a[3] = load_u32(row_hi + k0 + 16 + 4 * q);
        } else {
          a[0] = load_u32(row_lo + 2 * (k0 + 2 * q));
          a[1] = load_u32(row_hi + 2 * (k0 + 2 * q));
          a[2] = load_u32(row_lo + 2 * (k0 + 8 + 2 * q));
          a[3] = load_u32(row_hi + 2 * (k0 + 8 + 2 * q));
        }
#pragma unroll
        for (int t = 0; t < kMmTiles; ++t) {
          const bool hot = kstep[t] == s;
          const uint32_t b0 = hot ? bhot0[t] : 0u, b1 = hot ? bhot1[t] : 0u;
          if constexpr (kInt8) {
            mma_s8(acc[t], a, b0, b1);
          } else {
            mma_bf16(acc[t], a, b0, b1);
          }
        }
      }
      // fold rows g and g + 8 of this tile into the column maxima; rows
      // past W are padding
      const bool lo_ok = m0 + g < W, hi_ok = m0 + g + 8 < W;
#pragma unroll
      for (int t = 0; t < kMmTiles; ++t) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (lo_ok) colmax[t][j] = max(colmax[t][j], acc[t][j]);
          if (hi_ok) colmax[t][j] = max(colmax[t][j], acc[t][2 + j]);
        }
      }
    }
    // the maximum over the eight row groups (lanes of equal q), then the
    // sum of the valid columns' maxima held by lanes 0..3
#pragma unroll
    for (int t = 0; t < kMmTiles; ++t) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        Acc v = colmax[t][j];
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 4));
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 8));
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 16));
        if (g == 0 && col0 + 8 * t + 2 * q + j < gw) warp_sum += (float)v;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    warp_sum += __shfl_xor_sync(0xffffffffu, warp_sum, off);
  if (lane == 0 && wtile < n_wtiles) partial[(size_t)r * n_wtiles + wtile] = warp_sum;
}

// P2: block (tile c, round r); thread (lane k, slice y) takes rows
// s = y, y + kDgSlices, ...
__global__ void __launch_bounds__(kDgLanes * kDgSlices)
dg_probe_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                int S, int tiles, float* __restrict__ partial) {
  __shared__ float red[kDgSlices][kDgLanes];
  const int k = threadIdx.x, y = threadIdx.y;
  const int c = blockIdx.x, r = blockIdx.y;
  const size_t row_stride = (size_t)tiles * kDgLanes;
  const float* col = tab + (size_t)c * kDgLanes + k;
  float m = -INFINITY;
#pragma unroll 8
  for (int s = y; s < S; s += kDgSlices) {
    const int row = floor_mod(__ldg(idx + (size_t)s * kDgLanes + k) + r, S);
    m = fmaxf(m, __ldg(col + row * row_stride));
  }
  red[y][k] = m;
  __syncthreads();
  if (y == 0) {
#pragma unroll
    for (int j = 1; j < kDgSlices; ++j) m = fmaxf(m, red[j][k]);
    red[0][k] = m;
  }
  __syncthreads();
  // the sum of the 128 lane maxima, a fixed tree
  for (int h = kDgLanes / 2; h > 0; h >>= 1) {
    if (y == 0 && k < h) red[0][k] += red[0][k + h];
    __syncthreads();
  }
  if (k == 0 && y == 0) partial[(size_t)r * tiles + c] = red[0][0];
}

// The second pass: the partial sums added in a fixed order (a strided sum
// per thread, then a fixed tree), in double.
__global__ void __launch_bounds__(kSumThreads)
sum_partials_kernel(const float* __restrict__ partial, int n,
                    float* __restrict__ out) {
  __shared__ double red[kSumThreads];
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kSumThreads) acc += partial[i];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int h = kSumThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = (float)red[0];
}

}  // namespace

// tab_t: (w_pad, l_pad) int8 or bf16, the table transposed and zero-padded;
// idx: (8, nl) int32; partial: rounds * groups * tiles_per_group floats,
// tiles_per_group = ceil(nl / groups / 64); out: one float. Returns the
// launches' cudaError.
extern "C" int hpt_mm_probe(const void* tab_t, const int* idx, int L, int W,
                            int w_pad, int l_pad, int nl, int rounds,
                            int groups, int is_int8, float* partial,
                            float* out, cudaStream_t stream) {
  const int gw = nl / groups;
  const int tiles_per_group = (gw + kMmCols - 1) / kMmCols;
  const int n_wtiles = groups * tiles_per_group;
  const dim3 grid((n_wtiles + kMmWarps - 1) / kMmWarps, rounds);
  if (is_int8) {
    mm_probe_kernel<true><<<grid, kMmWarps * 32, 0, stream>>>(
        tab_t, idx, L, W, w_pad, l_pad, nl, groups, tiles_per_group, partial);
  } else {
    mm_probe_kernel<false><<<grid, kMmWarps * 32, 0, stream>>>(
        tab_t, idx, L, W, w_pad, l_pad, nl, groups, tiles_per_group, partial);
  }
  sum_partials_kernel<<<1, kSumThreads, 0, stream>>>(
      partial, rounds * n_wtiles, out);
  return (int)cudaGetLastError();
}

// tab: (S, tiles * 128) f32; idx: (S, 128) int32; partial: rounds * tiles
// floats; out: one float. Returns the launches' cudaError.
extern "C" int hpt_dg_probe(const float* tab, const int* idx, int S, int tiles,
                            int rounds, float* partial, float* out,
                            cudaStream_t stream) {
  dg_probe_kernel<<<dim3(tiles, rounds), dim3(kDgLanes, kDgSlices), 0,
                    stream>>>(tab, idx, S, tiles, partial);
  sum_partials_kernel<<<1, kSumThreads, 0, stream>>>(partial, rounds * tiles,
                                                      out);
  return (int)cudaGetLastError();
}
