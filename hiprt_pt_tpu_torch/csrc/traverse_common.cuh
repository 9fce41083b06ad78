// Helpers shared by the traversal kernels (traverse.cu, traverse8.cu): the
// ray record, the near-zero direction guard, the slab test, the
// Moller-Trumbore triangle test with the equal-t tie rule, the hit-record
// store; for the per-ray walks the warp's draw of ray ids and the test of
// four triangles behind 16-byte loads; and, for the host, the resident
// block count of a persistent kernel and a kernel's registers, local and
// shared memory and residency. They follow the HitRecord contract of ops/traverse.py.
//
// Rounding: the kernels are built with -fmad=false, so the triangle test
// rounds every product and sum exactly as the plain PyTorch version does, and
// the two agree bit for bit where they visit the same triangles.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace hpt {

constexpr int kStack = 64;       // traversal stack entries (host checks depth)
constexpr int kLeafTris = 12;    // triangle slots of a leaf row
constexpr int kLeafFloats = 128;
constexpr int kPacket = 128;     // rays per packet = one 16x8 screen tile
constexpr float kTriEps = 1e-9f;
constexpr int kMegaRowFloats = 128;  // a meganode row (accel/build.py nodes)
constexpr int kMegaLeafTris = 4;     // triangle slots per child of a row
constexpr int kMegaStack = 64;       // far-sibling entries (host checks depth2)
constexpr int kNone = INT_MIN;       // a per-ray walk holds no node or leaf
constexpr unsigned kMissKey = 0xffffffffu;  // sort key of a child not hit

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin;
};

__device__ __forceinline__ float inverse_component(float c) {
  // 1/c, or -1e12 for a tiny negative c and +1e12 for a tiny positive c or
  // ±0 (ops/traverse.py:inverse_direction; the JAX package's guard gives 0
  // for a tiny negative c, which collapses that axis's slab)
  if (fabsf(c) > 1e-12f) return 1.0f / c;
  return c < 0.0f ? -1e12f : 1e12f;
}

__device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                        const float* tmin, int64_t i) {
  Ray r;
  r.ox = o[3 * i + 0];
  r.oy = o[3 * i + 1];
  r.oz = o[3 * i + 2];
  r.dx = d[3 * i + 0];
  r.dy = d[3 * i + 1];
  r.dz = d[3 * i + 2];
  r.ix = inverse_component(r.dx);
  r.iy = inverse_component(r.dy);
  r.iz = inverse_component(r.dz);
  r.tmin = tmin[i];
  return r;
}

// Slab test of one child box b[0..5] = min xyz, max xyz. An empty slot has a
// NaN box; fminf/fmaxf drop NaN, so it is tested explicitly.
__device__ __forceinline__ bool slab(const float* b, const Ray& r,
                                     float best_t, float& t_entry) {
  if (isnan(b[0])) return false;
  const float tx0 = (b[0] - r.ox) * r.ix, tx1 = (b[3] - r.ox) * r.ix;
  const float ty0 = (b[1] - r.oy) * r.iy, ty1 = (b[4] - r.oy) * r.iy;
  const float tz0 = (b[2] - r.oz) * r.iz, tz1 = (b[5] - r.oz) * r.iz;
  const float te = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                         fmaxf(fminf(tz0, tz1), 0.0f));
  const float tx = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                         fminf(fmaxf(tz0, tz1), best_t));
  t_entry = te;
  return te <= tx;
}

// Möller-Trumbore in ops/intersect.py:triangle_test's operation order.
// A hit must beat the best so far; an equal-t tie goes to the smaller prim
// id, so the order of the walk does not pick the winner among triangles it
// tests (a box culled at exactly the tied t is not tested). prim_f points at
// the triangle's prim id (int32 bits), read only for a candidate hit.
__device__ __forceinline__ bool triangle(const float* tri, const float* prim_f,
                                         const Ray& r, float best_t,
                                         int best_prim, float& t_out,
                                         float& u_out, float& v_out,
                                         int& prim_out) {
  const float v0x = tri[0], v0y = tri[1], v0z = tri[2];
  const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
  const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok_det = fabsf(det) > kTriEps;
  const float inv_det = ok_det ? 1.0f / det : 0.0f;
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  if (!(ok_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > r.tmin)) {
    return false;
  }
  const int prim = __float_as_int(*prim_f);
  if (!(t < best_t || (t == best_t && best_prim >= 0 && prim < best_prim))) {
    return false;
  }
  t_out = t;
  u_out = u;
  v_out = v;
  prim_out = prim;
  return true;
}

__device__ __forceinline__ void load_node(const float4* __restrict__ nodes4,
                                          int ref, float* box, int* refs) {
  const float4* nd = nodes4 + (int64_t)ref * 8;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float4 q = __ldg(nd + j);
    box[4 * j + 0] = q.x;
    box[4 * j + 1] = q.y;
    box[4 * j + 2] = q.z;
    box[4 * j + 3] = q.w;
  }
  const float4 q = __ldg(nd + 6);
  refs[0] = __float_as_int(q.x);
  refs[1] = __float_as_int(q.y);
  refs[2] = __float_as_int(q.z);
  refs[3] = __float_as_int(q.w);
}

__device__ __forceinline__ void write_hit(int64_t i, bool any_hit, int prim,
                                          float t, float u, float v,
                                          float* t_out, int32_t* prim_out,
                                          float* u_out, float* v_out) {
  const bool hit = prim >= 0;
  t_out[i] = hit ? t : INFINITY;
  prim_out[i] = prim;
  u_out[i] = (hit && !any_hit) ? u : 0.0f;
  v_out[i] = (hit && !any_hit) ? v : 0.0f;
}

// The next two serve the per-ray walks of traverse.cu. The BVH8 walk
// (traverse8.cu) keeps its own copies of the same code: built from these
// trace_lane8log took 83 registers and 5 resident blocks an SM where its own
// copies take 80 and 6 (sm_90a, measured on an NVIDIA H100).
//
// Ray ids for the lanes of a warp that need one (`want` is their ballot):
// one atomicAdd a warp on the global counter, consecutive ids by rank. Every
// lane of the warp calls it; the id means something only where `want` has
// the lane's bit, and an id >= n says the pool is empty.
__device__ __forceinline__ int64_t warp_take_rays(
    unsigned want, int lane, unsigned long long* __restrict__ next_ray) {
  const int leader = __ffs(want) - 1;
  unsigned long long base = 0;
  if (lane == leader) {
    base = atomicAdd(next_ray, (unsigned long long)__popc(want));
  }
  base = __shfl_sync(0xffffffffu, base, leader);
  return (int64_t)base + __popc(want & ((1u << lane) - 1u));
}

// Four triangle slots (36 floats at a 16-byte boundary: nine 16-byte loads,
// all ahead of the tests) with their prim ids at `prims`; the first `cnt`
// slots are tested (cnt may be <= 0 or > 4). An any-hit walk stops at its
// first hit and sets `done`.
template <bool kAnyHit>
__device__ __forceinline__ void test_four(const float4* __restrict__ tri4,
                                          const float* __restrict__ prims,
                                          int cnt, const Ray& r, float& best_t,
                                          float& best_u, float& best_v,
                                          int& best_prim, bool& done) {
  float f[36];
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const float4 q = __ldg(tri4 + j);
    f[4 * j + 0] = q.x;
    f[4 * j + 1] = q.y;
    f[4 * j + 2] = q.z;
    f[4 * j + 3] = q.w;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float t, u, v;
    int prim;
    if (k < cnt && !done &&
        triangle(f + 9 * k, prims + k, r, best_t, best_prim, t, u, v, prim)) {
      best_t = t;
      best_u = u;
      best_v = v;
      best_prim = prim;
      if (kAnyHit) done = true;
    }
  }
}

// Blocks of `threads` threads that fit the whole card at once.
template <typename K>
int resident_blocks(K kernel, int threads, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  return (int)e;
}

// Registers per thread, local memory bytes per thread (a stack and any
// spills), static shared memory bytes per block and resident blocks of
// `threads` threads per SM of a kernel.
template <typename K>
int kernel_info(K kernel, int threads, int* regs, int* local_bytes,
                int* shared_bytes, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, threads, 0);
}

}  // namespace hpt
