// The dense emissive sweep for Hopper (sm_90a): for every ray, the nearest
// emissive triangle it hits, occluders ignored (Moller-Trumbore against
// each row of the scene's emissive table). RIS and ReSTIR DI use it to find
// which emitter a BSDF candidate's direction reaches; the winner's
// visibility ray settles occlusion.
//
// It replaces no Pallas kernel: the JAX package's sweep is plain jnp that
// XLA fuses (hiprt_pt_tpu/lights/light_sampling.py:199). Eager PyTorch
// cannot fuse it; its plain version (lights/light_sampling.py:
// _closest_emissive_hit_plain) runs some 64 elementwise kernels over every
// (ray, emitter) block, each writing an (N, block) temporary to device
// memory.
//
// What bounds it on this card: arithmetic. A (ray, emitter) pair costs
// about 53 f32 operations (two cross products, four 3-term dot products,
// the edge vector, the reciprocal, three scalings, seven compares and a
// sum) and nothing from device memory; a ray moves 37 bytes (o, d, its
// active flag in; t, slot out). At 2,073,600 rays and 240 emitters that is
// 26 G operations, about 0.4 ms at 67 TFLOP/s (twice that with no fused
// multiply-add, which the exact contract forbids), against 77 MB, about
// 23 us at 3.35 TB/s.
//
// What the design does about that. One thread a ray, grid-stride, so any N
// works. A block stages the emitters' v0, e1 and e2 in shared memory as
// structure of arrays, in tiles of up to kTile emitters, so any E works: a
// warp's lanes read the same emitter at once, a broadcast with no bank
// conflict, and four emitters at a time as one 16-byte load a component.
// A tile is padded to a multiple of four with zero triangles, which never
// hit (det = 0). A ray's best hit stays in registers; nothing but the
// result goes to device memory.
//
// Bit for bit the plain version: its f32 operations in its order (built
// with -fmad=false, so no multiply and add fuse), IEEE division for the
// reciprocal of det, the constants in f32 as PyTorch casts its scalars.
// Emitters are taken in order and a slot is taken only on a strictly
// smaller t, so the first emitter wins an equal t, as the plain version's
// min over a block and its strict < between blocks. t is computed for
// every ray; an inactive ray gets slot -1.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// four blocks an SM hold ptxas to 64 registers a thread
constexpr int kBlocksPerSM = 4;
// emitters a shared-memory tile holds: 9 x 1,024 f32 = 36 KB
constexpr int kTile = 1024;

struct Tile {
  // v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, kTile each
  float4 c[9][kTile / 4];
};

// Stage rows [s0, s0 + count) of the emissive table (row stride `stride`
// floats, v0 e1 e2 in columns 0..8) and zero triangles up to a multiple of
// four; the caller synchronises around it.
__device__ void stage(Tile& tile, const float* __restrict__ rows, int stride,
                      int s0, int count) {
  float* c = reinterpret_cast<float*>(tile.c);
  const int padded = (count + 3) & ~3;
  for (int i = threadIdx.x; i < 9 * padded; i += blockDim.x) {
    const int k = i / padded, j = i - k * padded;
    c[k * kTile + j] = j < count ? rows[(int64_t)(s0 + j) * stride + k] : 0.0f;
  }
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// The plain version's Moller-Trumbore test of one (ray, emitter) pair;
// slot `slot` replaces the best on a hit strictly nearer.
__device__ __forceinline__ void test(const Ray& r, float v0x, float v0y,
                                     float v0z, float e1x, float e1y,
                                     float e1z, float e2x, float e2y,
                                     float e2z, float t_min, int slot,
                                     float& best_t, int& best_slot) {
  // pvec = d x e2, det = pvec . e1
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = (px * e1x + py * e1y) + pz * e1z;
  const bool ok = fabsf(det) > 1e-12f;
  const float inv_det = ok ? 1.0f / det : 0.0f;
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  const float u = ((tx * px + ty * py) + tz * pz) * inv_det;
  // qvec = tvec x e1
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = ((r.dx * qx + r.dy * qy) + r.dz * qz) * inv_det;
  const float t = ((qx * e2x + qy * e2y) + qz * e2z) * inv_det;
  const bool hit = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min;
  if (hit && t < best_t) {
    best_t = t;
    best_slot = slot;
  }
}

// Every emitter of the staged tile (`padded` of them, a multiple of four,
// the first at slot s0) against one ray.
__device__ __forceinline__ void sweep_tile(const Tile& tile, const Ray& r,
                                           int padded, int s0, float t_min,
                                           float& best_t, int& best_slot) {
#pragma unroll 1
  for (int j = 0; j < padded / 4; ++j) {
    float4 c[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) c[k] = tile.c[k][j];
    const int slot = s0 + 4 * j;
    test(r, c[0].x, c[1].x, c[2].x, c[3].x, c[4].x, c[5].x, c[6].x, c[7].x,
         c[8].x, t_min, slot, best_t, best_slot);
    test(r, c[0].y, c[1].y, c[2].y, c[3].y, c[4].y, c[5].y, c[6].y, c[7].y,
         c[8].y, t_min, slot + 1, best_t, best_slot);
    test(r, c[0].z, c[1].z, c[2].z, c[3].z, c[4].z, c[5].z, c[6].z, c[7].z,
         c[8].z, t_min, slot + 2, best_t, best_slot);
    test(r, c[0].w, c[1].w, c[2].w, c[3].w, c[4].w, c[5].w, c[6].w, c[7].w,
         c[8].w, t_min, slot + 3, best_t, best_slot);
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
emissive_sweep_kernel(const float* __restrict__ rows, int e, int stride,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const uint8_t* __restrict__ active, int64_t n,
                      float t_min, float* __restrict__ t_out,
                      int64_t* __restrict__ slot_out) {
  __shared__ Tile tile;
  const bool one_tile = e <= kTile;
  if (one_tile) {
    stage(tile, rows, stride, 0, e);
    __syncthreads();
  }
  // every thread of the block runs the same number of rounds, so that the
  // tiles' barriers are met by all of them
  const int64_t step = (int64_t)gridDim.x * kThreads;
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < n; base += step) {
    const int64_t i = base + threadIdx.x;
    const bool live = i < n;
    Ray r = {};
    if (live) {
      r = Ray{o[3 * i], o[3 * i + 1], o[3 * i + 2],
              d[3 * i], d[3 * i + 1], d[3 * i + 2]};
    }
    float best_t = __int_as_float(0x7f800000);  // +inf
    int best_slot = -1;
    for (int s0 = 0; s0 < e; s0 += kTile) {
      const int count = min(kTile, e - s0);
      if (!one_tile) {
        __syncthreads();
        stage(tile, rows, stride, s0, count);
        __syncthreads();
      }
      if (live) sweep_tile(tile, r, (count + 3) & ~3, s0, t_min, best_t,
                           best_slot);
    }
    if (live) {
      t_out[i] = best_t;
      slot_out[i] = (active == nullptr || active[i]) ? best_slot : -1;
    }
  }
}

}  // namespace

// Plain C interface for ctypes. Every pointer is a device pointer; `rows`
// is the emissive table, e rows of `stride` floats; `active` may be null
// (every ray active); `stream` is a cudaStream_t. Returns the first CUDA
// error of the launch, or 0. hpt_emissive_sweep_info gives the kernel's
// registers per thread, local memory bytes per thread, static shared
// memory bytes per block and resident blocks per SM, for the records.
extern "C" {

int hpt_emissive_sweep(const void* rows, int e, int stride, const void* o,
                       const void* d, const void* active, int64_t n,
                       float t_min, void* t, void* slot, void* stream) {
  if (n <= 0) return 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, emissive_sweep_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  // one resident wave, or as many blocks as the rays need
  const int64_t need = (n + kThreads - 1) / kThreads;
  const int64_t wave = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(need < wave ? need : wave);
  emissive_sweep_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rows, e, stride, (const float*)o, (const float*)d,
      (const uint8_t*)active, n, t_min, (float*)t, (int64_t*)slot);
  return (int)cudaGetLastError();
}

int hpt_emissive_sweep_info(int* regs, int* local_bytes, int* shared_bytes,
                            int* blocks_per_sm) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, emissive_sweep_kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, emissive_sweep_kernel, kThreads, 0);
}

}  // extern "C"
