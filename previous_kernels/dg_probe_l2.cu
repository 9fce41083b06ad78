// The version of dg_probe_kernel (the port of the TPU kernel _dg_kernel,
// benchmarks/r5probe2.py:112) that gathers every element from device memory
// through the L2, a block per (tile, round), which the shared-memory strips
// of hiprt_pt_tpu_torch/csrc/probes.cu replaced for every table whose strip
// fits a block's shared memory. It is not part of the package: chip_smoke.py
// builds it only to time the two side by side, on the same inputs in the
// same run. (probes.cu keeps the same kernel as dg_probe_l2_kernel for
// tables past the shared-memory size.)
//
// It computes sum_r sum_c sum_k max_s tab[(idx[s, k] + r) mod S, c * 128 + k]
// with one partial sum per (round, tile) and a fixed-order second pass: see
// probes.cu.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDgLanes = 128;        // lanes of a P2 tile
constexpr int kDgSlices = 8;         // slices of the S rows per block
constexpr int kSumThreads = 256;

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
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

// tab: (S, tiles * 128) f32; idx: (S, 128) int32; partial: rounds * tiles
// floats; out: one float. Returns the launches' cudaError.
extern "C" int hpt_prev_dg_probe(const float* tab, const int* idx, int S,
                                 int tiles, int rounds, float* partial,
                                 float* out, cudaStream_t stream) {
  dg_probe_kernel<<<dim3(tiles, rounds), dim3(kDgLanes, kDgSlices), 0,
                    stream>>>(tab, idx, S, tiles, partial);
  sum_partials_kernel<<<1, kSumThreads, 0, stream>>>(partial, rounds * tiles,
                                                      out);
  return (int)cudaGetLastError();
}

// Registers per thread, local memory bytes per thread, static shared memory
// bytes per block and resident blocks per SM of the kernel, for the records
// (`unused` keeps the signature of the other *_info functions).
extern "C" int hpt_prev_dg_probe_info(int unused, int* regs, int* local_bytes,
                                      int* smem_bytes, int* blocks_per_sm) {
  (void)unused;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, dg_probe_kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, dg_probe_kernel, kDgLanes * kDgSlices, 0);
}
