// The mma.sync version of mm_probe_kernel (the port of the TPU probe kernel
// _mm_kernel, benchmarks/r5probe2.py:58) that the wgmma version of
// hiprt_pt_tpu_torch/csrc/probes.cu replaced. It is not part of the package:
// chip_smoke.py builds it only to time the two side by side, on the same
// inputs in the same run.
//
// A is the table transposed, (W, L) with L contiguous, zero-padded to a
// multiple of 16 rows and 32 columns; B, the one-hot matrix, is built in
// registers. mma.sync m16n8k32 (s8) or m16n8k16 (bf16) is fed from L1/L2 with
// plain loads: a warp owns 64 columns for one round and walks all of W in
// 16-row tiles, folding each tile's products into its columns' running
// maxima. One partial sum per (warp, round), added in a fixed order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kMmWarps = 4;          // warps per block
constexpr int kMmTiles = 8;          // n8 tiles per warp
constexpr int kMmCols = 8 * kMmTiles;  // columns per warp
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
extern "C" int hpt_prev_mm_probe(const void* tab_t, const int* idx, int L,
                                 int W, int w_pad, int l_pad, int nl,
                                 int rounds, int groups, int is_int8,
                                 float* partial, float* out,
                                 cudaStream_t stream) {
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

// Registers per thread, local memory bytes per thread, static shared memory
// and resident blocks per SM of the kernel (int8 or bf16), for the records.
extern "C" int hpt_prev_mm_probe_info(int is_int8, int* regs, int* local_bytes,
                                      int* smem_bytes, int* blocks_per_sm) {
  auto info = [&](auto kernel) {
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return (int)e;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    *smem_bytes = (int)attr.sharedSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, kMmWarps * 32, 0);
  };
  return is_int8 ? info(mm_probe_kernel<true>) : info(mm_probe_kernel<false>);
}
