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
// product's cost is what the probe measures. What bounds the function P1
// returns is its W NL rounds maxima (a few microseconds at the probe's
// shapes), not the product: the product's 2 L W NL rounds operations at the
// dense int8 or bf16 peak are the cost of the probe's method, and the share
// of that peak the kernel reaches is what the probe reports. What bounds
// the product on this card is feeding the tensor cores: only wgmma reaches
// their full rate, it reads its B operand from shared memory, and every
// block streams the whole table (6.4 MB in int8, 12.7 MB in bf16, from L2)
// once per round and 256 gathered rows.
//
// The design. The operands are swapped against the TPU kernel's: gl^T =
// onehot^T . tab, so the one-hot matrix is wgmma's A operand, from
// registers, and the table is B. A is never stored: a lane knows the rows
// sl of its fragment's two rows per 64-row block and builds the fragment in
// registers, nonzero in the one K step that holds sl. B is the table
// transposed, (W, L) with L contiguous and zero-padded to a row stride of a
// multiple of 16 bytes (the wrapper's one-time set-up copy): K-major, the
// only layout int8 wgmma takes. (The other shape, the table as A from
// shared memory and a one-hot B written into a zeroed shared tile per K
// step, would store what the registers hold for nothing and read twice as
// much shared memory per product.) A block is one producer warpgroup and
// two consumer warpgroups (hopper_async.cuh has the PTX): one producer
// thread keeps a ring of kMmStages table tiles (kMmN rows x 128 bytes of L,
// 128-byte swizzle) in flight with TMA, full and empty mbarriers per stage;
// TMA zero-fills what a tile reaches past W or past the padded L, so no
// shape is refused. Each consumer warpgroup owns kMmBlocks 64-row blocks of
// gathered rows: per stage and K step (32 int8 or 16 bf16 elements) it
// issues one wgmma m64n128 per block (s8 x s8 -> s32, k32; bf16 x bf16 ->
// f32, k16) into 2 x 64 accumulator registers, drains them, and after the K
// loop over all of L folds the accumulators into its rows' running maxima
// (a row's maximum is a maximum along N over a thread's registers, then
// over the four lanes of its quad). The last tile of W is as narrow as the
// rows left allow (n16, n32, n64 or n128 on the same stages), so that W =
// 2,320 costs 18 1/8 tiles and not 19. `groups` keeps the TPU probe's
// meaning (one product per group of NL / groups columns with the group's
// slice of idx) and on the card only changes how the blocks' kMmRows
// gathered rows are laid over the columns: a block never straddles a
// group, and its rows past the group's end are masked.
//
// P2. What bounds the function it returns is bytes: the table, the indices
// and the output once. The TPU kernel holds the whole table in on-chip
// memory and gathers from there; on this card the on-chip memory that takes
// a data-dependent gather is an SM's shared memory, 227 KB a block. So a
// block owns a strip of the table, (tile c, a group of G of its 128 lanes):
// S x G floats, staged once into shared memory with cp.async, after which
// the table has crossed the memory system once. All rounds run inside the
// block: a thread owns one lane of the group and a slice of the S index
// rows, reads idx[s, k] once, and serves 32 rounds from it, one running
// maximum a round in registers (row (idx + r) mod S is the row after
// (idx + r - 1) mod S, so a round costs an add, a wrap, a shared-memory load
// and a max); more than 32 rounds take another pass over the indices. Every
// gather of every round is performed, from the strip. The running maxima
// of the threads that share a lane meet by shuffles within a warp and by
// atomicMax on order-preserving integer keys across warps (a maximum does
// not depend on the order it is taken in). G and the block size are the
// wrapper's choice (probes/r5probe2.py:dg_plan), so that the strips fill
// the card's SMs at 4 tiles and at 19. A table whose strip of the least G
// does not fit a block's shared memory goes to the earlier kernel
// (dg_probe_l2_kernel): a block per (tile, round), every element gathered
// from device memory through the L2.
//
// Both probes write one partial sum per (block, round) and add the
// partials in a second pass in a fixed order, so the result repeats bit
// for bit whichever block ran when. With integer table values every partial
// sum is an integer, exact in f32 below 2^24, and the result is exact.
//
// Built without -fmad=false (unlike the traversal sources): there is no
// floating-point product to keep bit-identical.

#include <cuda.h>  // the tensor map's types only; libcuda is not linked
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "hopper_async.cuh"

namespace {

using namespace hpt;

// P1's tile: 2 consumer warpgroups x kMmBlocks 64-row blocks of gathered
// rows against kMmN table rows, 128 accumulator registers a thread.
constexpr int kMmConsumers = 2;              // consumer warpgroups per block
constexpr int kMmThreads = (kMmConsumers + 1) * 128;
constexpr int kMmBlocks = 2;                 // 64-row blocks per warpgroup
constexpr int kMmN = 128;                    // table rows (W) per tile
constexpr int kMmRows = kMmConsumers * kMmBlocks * 64;  // gathered rows per block
constexpr int kMmChunkBytes = 128;           // K bytes per stage: one swizzle row
constexpr int kMmStageBytes = kMmN * kMmChunkBytes;
constexpr int kMmStages = 7;                 // table tiles in flight (112 KB)
constexpr int kMmSmemBytes = kMmStages * kMmStageBytes + 1024;
constexpr int kDgLanes = 128;        // lanes of a P2 tile
constexpr int kDgRounds = 32;        // rounds a pass: running maxima a thread
constexpr int kDgMaxThreads = 1024;
constexpr int kDgSlices = 8;         // dg_probe_l2_kernel: slices of the S rows
constexpr int kSumThreads = 256;

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

template <bool kInt8>
using MmAcc = typename std::conditional<kInt8, int, float>::type;

// The register word with element d set to one (int8 1, bf16 1.0).
template <bool kInt8>
__device__ __forceinline__ uint32_t one_hot(int d) {
  return kInt8 ? 1u << (8 * d) : 0x3F80u << (16 * d);
}

// One tile of P1, for a consumer thread: the products of the block's
// gathered rows with the kN table rows from n0 on (the first kN rows of each
// stage's tile), over all of L through the ring's stages, then the fold of
// the products into the thread's rows' running maxima. `whole`: every table
// row of the tile is below W; else the rows past W (zero fill, not data) are
// left out of the maxima. code: see mm_probe_kernel.
template <bool kInt8, int kN>
__device__ __forceinline__ void mm_tile(
    uint32_t tiles, uint64_t* full_bar, uint64_t* empty_bar, int n_chunks,
    const int (&code)[kMmBlocks][2], int n0, int W, bool whole, int q, int lane,
    int& stage, uint32_t& phase, MmAcc<kInt8> (&rowmax)[kMmBlocks][2]) {
  constexpr int kSteps = kMmChunkBytes / 32;  // wgmma K steps per stage
  MmAcc<kInt8> acc[kMmBlocks][kN / 2];
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    mbar_wait(smem_u32(&full_bar[stage]), phase);
    const uint64_t desc = wgmma_desc_k128(tiles + stage * kMmStageBytes);
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int s2 = 2 * (chunk * kSteps + ks);
      uint32_t a[kMmBlocks][4];
#pragma unroll
      for (int b = 0; b < kMmBlocks; ++b) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t word = one_hot<kInt8>(code[b][h] & 3);
          a[b][h] = (code[b][h] >> 2) == s2 ? word : 0u;
          a[b][2 + h] = (code[b][h] >> 2) == s2 + 1 ? word : 0u;
        }
      }
      wgmma_fence();
#pragma unroll
      for (int b = 0; b < kMmBlocks; ++b) {
        wgmma_rs(acc[b], a[b], desc + 2 * ks, (chunk | ks) != 0);
      }
      wgmma_commit();
      // drained at every K step: the A registers of the next step are free
      // to build, and the other consumer warpgroup's products fill the gap
      wgmma_wait<0>();
    }
    if (lane == 0) mbar_arrive(smem_u32(&empty_bar[stage]));
    if (++stage == kMmStages) {
      stage = 0;
      phase ^= 1u;
    }
  }
#pragma unroll
  for (int b = 0; b < kMmBlocks; ++b) {
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      const int h = (i >> 1) & 1;
      if (whole || n0 + 8 * (i >> 2) + 2 * q + (i & 1) < W) {
        rowmax[b][h] = max(rowmax[b][h], acc[b][i]);
      }
    }
  }
}

// P1. A block is two consumer warpgroups and one producer warpgroup. The
// block owns kMmRows gathered rows (columns of NL) of one round: consumer
// warpgroup w, 64-row block b, warp v, lane 4 g + q holds the rows
// (w kMmBlocks + b) 64 + 16 v + g and + 8. A row's one-hot operand is one
// register: which half K step holds sl and where in that half's register
// word the nonzero element sits (hopper_async.cuh has the fragment
// layouts). Launched with 168 registers a thread; the producer warpgroup
// gives registers up (setmaxnreg) and the consumers take 232.
template <bool kInt8>
__global__ void __launch_bounds__(kMmThreads, 1)
mm_probe_kernel(const __grid_constant__ CUtensorMap tmap,
                const int* __restrict__ idx, int L, int W, int n_chunks, int nl,
                int groups, int tiles_per_group, float* __restrict__ partial) {
  using Acc = MmAcc<kInt8>;
  constexpr int kHalf = kInt8 ? 16 : 8;    // K of one A register: half a wgmma
  constexpr int kChunkElems = kMmChunkBytes / (kInt8 ? 1 : 2);
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full_bar[kMmStages], empty_bar[kMmStages];
  __shared__ float warp_sums[kMmConsumers * 4];
  // the swizzle pattern repeats every 1024 bytes: the tiles start on one
  const uint32_t tiles = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int n_ntiles = (W + kMmN - 1) / kMmN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMmStages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), kMmConsumers * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == kMmConsumers) {
    // the producer: one thread keeps kMmStages table tiles in flight
    setmaxnreg_dec<40>();
    if (threadIdx.x == kMmConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int nt = 0; nt < n_ntiles; ++nt) {
        for (int chunk = 0; chunk < n_chunks; ++chunk) {
          mbar_wait(smem_u32(&empty_bar[stage]), phase ^ 1u);
          const uint32_t bar = smem_u32(&full_bar[stage]);
          mbar_arrive_expect_tx(bar, kMmStageBytes);
          tma_load_2d(tiles + stage * kMmStageBytes, &tmap, bar,
                      chunk * kChunkElems, nt * kMmN);
          if (++stage == kMmStages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, q = lane & 3;
    const int r = blockIdx.y;
    const int gw = nl / groups;
    const int grp = blockIdx.x / tiles_per_group;
    const int col0 = (blockIdx.x % tiles_per_group) * kMmRows;  // in the group
    // per row: (the half K step that holds sl) * 4 + (the nonzero element's
    // place in that half's register), or -1 where no element is this
    // lane's or the row is past the group's end
    int code[kMmBlocks][2];
    Acc rowmax[kMmBlocks][2];
#pragma unroll
    for (int b = 0; b < kMmBlocks; ++b) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = col0 + (wg * kMmBlocks + b) * 64 + warp * 16 + g + 8 * h;
        code[b][h] = -1;
        if constexpr (kInt8) {
          rowmax[b][h] = INT_MIN;
        } else {
          rowmax[b][h] = -INFINITY;
        }
        if (c < gw) {
          const int sl = floor_mod(idx[(r % 8) * nl + grp * gw + c] + r, L);
          const int d = sl % kHalf - (kHalf / 4) * q;
          if (d >= 0 && d < kHalf / 4) code[b][h] = (sl / kHalf) * 4 + d;
        }
      }
    }
    // whole tiles of kMmN table rows, then the last one as narrow as the
    // rows that are left allow
    int stage = 0;
    uint32_t phase = 0;
    const int last = (n_ntiles - 1) * kMmN;
    for (int n0 = 0; n0 < last; n0 += kMmN) {
      mm_tile<kInt8, kMmN>(tiles, full_bar, empty_bar, n_chunks, code, n0, W,
                           true, q, lane, stage, phase, rowmax);
    }
    auto tail = [&](auto n) {
      mm_tile<kInt8, decltype(n)::value>(tiles, full_bar, empty_bar, n_chunks,
                                         code, last, W, false, q, lane, stage,
                                         phase, rowmax);
    };
    if (W - last <= 16) {
      tail(std::integral_constant<int, 16>());
    } else if (W - last <= 32) {
      tail(std::integral_constant<int, 32>());
    } else if (W - last <= 64) {
      tail(std::integral_constant<int, 64>());
    } else {
      tail(std::integral_constant<int, kMmN>());
    }
    // a row's maximum over the four lanes of its quad, then the sum of the
    // valid rows' maxima: per warp by shuffles, per block in warp order
    float sum = 0.0f;
#pragma unroll
    for (int b = 0; b < kMmBlocks; ++b) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        Acc v = rowmax[b][h];
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const int c = col0 + (wg * kMmBlocks + b) * 64 + warp * 16 + g + 8 * h;
        if (q == 0 && c < gw) sum += (float)v;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) warp_sums[wg * 4 + warp] = sum;
    named_barrier(1, kMmConsumers * 128);
    if (threadIdx.x == 0) {
      float total = 0.0f;
      for (int w = 0; w < kMmConsumers * 4; ++w) total += warp_sums[w];
      partial[(size_t)r * gridDim.x + blockIdx.x] = total;
    }
  }
}

// A float as an unsigned key of the same order (no NaN), and back.
__device__ __forceinline__ unsigned ordered_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float ordered_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// P2: block (tile c, lanes k0 .. k0 + G - 1); thread (lane kk of the group,
// slice y) takes rows s = y, y + blockDim.x / G, ... The strip is row-major,
// strip[row][kk]: the G lanes of a row are neighbours, so a broadcast index
// row reads G consecutive words. partial[(round) * units + unit].
template <int G>
__global__ void __launch_bounds__(kDgMaxThreads)
dg_probe_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                int S, int tiles, int rounds, float* __restrict__ partial) {
  constexpr int kVec = G >= 4 ? 4 : G;     // floats a cp.async
  constexpr int kRowVecs = G / kVec;
  extern __shared__ __align__(16) float strip[];
  __shared__ unsigned lane_max[kDgRounds][G];
  const int units = tiles * (kDgLanes / G);
  const int unit = blockIdx.x;
  const int c = unit / (kDgLanes / G), k0 = (unit % (kDgLanes / G)) * G;
  const int kk = threadIdx.x % G, y = threadIdx.x / G, ny = blockDim.x / G;
  const size_t row_stride = (size_t)tiles * kDgLanes;

  // the strip, once: every thread's copies are in flight together
  const float* src = tab + (size_t)c * kDgLanes + k0;
  for (int q = threadIdx.x; q < S * kRowVecs; q += blockDim.x) {
    const int row = q / kRowVecs, part = q % kRowVecs;
    cp_async<4 * kVec>(strip + (size_t)q * kVec,
                       src + row * row_stride + part * kVec);
  }
  const int* my_idx = idx + k0 + kk;
  int first = y < S ? __ldg(my_idx + (size_t)y * kDgLanes) : 0;
  cp_async_wait_all();

  for (int r0 = 0; r0 < rounds; r0 += kDgRounds) {
    const int nr = min(kDgRounds, rounds - r0);
    for (int j = threadIdx.x; j < kDgRounds * G; j += blockDim.x) {
      lane_max[j / G][j % G] = ordered_key(-INFINITY);
    }
    __syncthreads();  // the strip (first pass) and the keys are in place
    const int rb = r0 % S;
    float acc[kDgRounds];
#pragma unroll
    for (int j = 0; j < kDgRounds; ++j) acc[j] = -INFINITY;
    // kWhole: the pass has all its kDgRounds rounds
    auto gather = [&](auto whole) {
      constexpr bool kWhole = decltype(whole)::value;
      int next = first;
      for (int s = y; s < S; s += ny) {
        const int base = floor_mod(next, S);
        if (s + ny < S) next = __ldg(my_idx + (size_t)(s + ny) * kDgLanes);
        int row = base + rb;
        if (row >= S) row -= S;
#pragma unroll
        for (int j = 0; j < kDgRounds; ++j) {
          if (kWhole || j < nr) {
            acc[j] = fmaxf(acc[j], strip[row * G + kk]);
            if (++row == S) row = 0;
          }
        }
      }
    };
    if (nr == kDgRounds) {
      gather(std::true_type());
    } else {
      gather(std::false_type());
    }
    // the threads of a lane: the lanes kk, kk + G, ... of a warp by
    // shuffles, the warps by atomicMax on the keys
#pragma unroll
    for (int j = 0; j < kDgRounds; ++j) {
      float m = acc[j];
#pragma unroll
      for (int off = 16; off >= G; off >>= 1) {
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      }
      if ((threadIdx.x & 31) < G && j < nr) {
        atomicMax(&lane_max[j][kk], ordered_key(m));
      }
    }
    __syncthreads();
    // a round's sum over the group's lanes, in lane order
    for (int j = threadIdx.x; j < nr; j += blockDim.x) {
      float sum = 0.0f;
#pragma unroll
      for (int g = 0; g < G; ++g) sum += ordered_float(lane_max[j][g]);
      partial[(size_t)(r0 + j) * units + unit] = sum;
    }
    __syncthreads();  // lane_max is read before the next pass resets it
  }
}

// P2 for a table whose strip does not fit shared memory: block (tile c,
// round r); thread (lane k, slice y) takes rows s = y, y + kDgSlices, ...
// and gathers every element from device memory (the L2, while the table
// fits it); neighbouring lanes read neighbouring columns of their rows.
__global__ void __launch_bounds__(kDgLanes * kDgSlices)
dg_probe_l2_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
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

// cuTensorMapEncodeTiled, looked up in the libcuda that the process has
// loaded already: nothing is linked against it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

template <bool kInt8>
static int launch_mm_probe(const CUtensorMap& tmap, const int* idx, int L, int W,
                           int n_chunks, int nl, int groups, int tiles_per_group,
                           int rounds, float* partial, cudaStream_t stream) {
  auto kernel = mm_probe_kernel<kInt8>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmSmemBytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(groups * tiles_per_group, rounds), kMmThreads, kMmSmemBytes,
           stream>>>(tmap, idx, L, W, n_chunks, nl, groups, tiles_per_group,
                     partial);
  return (int)cudaGetLastError();
}

// Gathered rows (columns of NL) per block: the wrapper sizes `partial` by it.
extern "C" int hpt_mm_probe_rows() { return kMmRows; }

// tab_t: (w_pad, l_pad) int8 or bf16, the table transposed and zero-padded,
// l_pad a multiple of 16 bytes; idx: (8, nl) int32; partial: rounds * groups
// * tiles_per_group floats, tiles_per_group = ceil(nl / groups /
// hpt_mm_probe_rows()); out: one float. Returns the launches' cudaError, or
// -1 where libcuda's tensor-map encoder is missing and -(100 + CUresult)
// where it refuses the table.
extern "C" int hpt_mm_probe(const void* tab_t, const int* idx, int L, int W,
                            int w_pad, int l_pad, int nl, int rounds,
                            int groups, int is_int8, float* partial,
                            float* out, cudaStream_t stream) {
  (void)w_pad;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const int elem = is_int8 ? 1 : 2;
  // the table as the K-major B operand: l_pad of K innermost, W rows; a box
  // of one swizzle row of K by kMmN rows, zero fill past either edge
  CUtensorMap tmap;
  const cuuint64_t dims[2] = {(cuuint64_t)l_pad, (cuuint64_t)W};
  const cuuint64_t strides[1] = {(cuuint64_t)l_pad * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(kMmChunkBytes / elem), (cuuint32_t)kMmN};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(
      &tmap,
      is_int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(tab_t), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -(100 + (int)res);
  const int gw = nl / groups;
  const int tiles_per_group = (gw + kMmRows - 1) / kMmRows;
  const int n_chunks = (l_pad * elem + kMmChunkBytes - 1) / kMmChunkBytes;
  const int err =
      is_int8 ? launch_mm_probe<true>(tmap, idx, L, W, n_chunks, nl, groups,
                                      tiles_per_group, rounds, partial, stream)
              : launch_mm_probe<false>(tmap, idx, L, W, n_chunks, nl, groups,
                                       tiles_per_group, rounds, partial, stream);
  if (err != 0) return err;
  sum_partials_kernel<<<1, kSumThreads, 0, stream>>>(
      partial, rounds * groups * tiles_per_group, out);
  return (int)cudaGetLastError();
}

// Registers per thread, local memory bytes per thread, static + dynamic
// shared memory and resident blocks per SM of P1's kernel (int8 or bf16),
// for the records.
extern "C" int hpt_mm_probe_info(int is_int8, int* regs, int* local_bytes,
                                 int* smem_bytes, int* blocks_per_sm) {
  auto info = [&](auto kernel) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return (int)e;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    *smem_bytes = (int)attr.sharedSizeBytes + kMmSmemBytes;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMmSmemBytes);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, kMmThreads, kMmSmemBytes);
  };
  return is_int8 ? info(mm_probe_kernel<true>) : info(mm_probe_kernel<false>);
}

template <int G>
static int launch_dg_probe(const float* tab, const int* idx, int S, int tiles,
                           int rounds, int threads, float* partial,
                           cudaStream_t stream) {
  const int smem = S * G * (int)sizeof(float);
  auto kernel = dg_probe_kernel<G>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<tiles * (kDgLanes / G), threads, smem, stream>>>(tab, idx, S, tiles,
                                                           rounds, partial);
  return (int)cudaGetLastError();
}

// tab: (S, tiles * 128) f32, 16-byte aligned; idx: (S, 128) int32; out: one
// float. g in {2, 4} and threads (a multiple of 32, at most 1024) pick
// the shared-memory kernel's strip width and block size; partial: rounds *
// tiles * 128 / g floats. g = 0 picks the L2 kernel (threads is not read;
// rounds at most 65,535); partial: rounds * tiles floats. Returns the
// launches' cudaError (cudaErrorInvalidValue for another g or threads).
extern "C" int hpt_dg_probe(const float* tab, const int* idx, int S, int tiles,
                            int rounds, int g, int threads, float* partial,
                            float* out, cudaStream_t stream) {
  int n_partial = rounds * tiles;
  if (g == 0) {
    dg_probe_l2_kernel<<<dim3(tiles, rounds), dim3(kDgLanes, kDgSlices), 0,
                         stream>>>(tab, idx, S, tiles, partial);
  } else {
    if (threads < 32 || threads > kDgMaxThreads || threads % 32 != 0) {
      return (int)cudaErrorInvalidValue;
    }
    int err;
    switch (g) {
      case 2:
        err = launch_dg_probe<2>(tab, idx, S, tiles, rounds, threads, partial,
                                 stream);
        break;
      case 4:
        err = launch_dg_probe<4>(tab, idx, S, tiles, rounds, threads, partial,
                                 stream);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
    if (err != 0) return err;
    n_partial *= kDgLanes / g;
  }
  sum_partials_kernel<<<1, kSumThreads, 0, stream>>>(partial, n_partial, out);
  return (int)cudaGetLastError();
}

// Registers per thread, local memory bytes per thread, static + dynamic
// shared memory of a block and resident blocks per SM of P2's kernel at
// strip width g (0: the L2 kernel), block size `threads` and S table rows,
// for the records.
extern "C" int hpt_dg_probe_info(int g, int threads, int S, int* regs,
                                 int* local_bytes, int* smem_bytes,
                                 int* blocks_per_sm) {
  auto info = [&](auto kernel, int block, int smem) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return (int)e;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    *smem_bytes = (int)attr.sharedSizeBytes + smem;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, block, smem);
  };
  const int smem = S * g * (int)sizeof(float);
  switch (g) {
    case 0: return info(dg_probe_l2_kernel, kDgLanes * kDgSlices, 0);
    case 2: return info(dg_probe_kernel<2>, threads, smem);
    case 4: return info(dg_probe_kernel<4>, threads, smem);
    default: return (int)cudaErrorInvalidValue;
  }
}
