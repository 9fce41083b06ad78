// The one-step-per-turn version of trace_lane8log (the port of the TPU
// kernel _kernel_lane8log, hiprt_pt_tpu/ops/pallas_traverse.py:1331) that the
// while-while walk of hiprt_pt_tpu_torch/csrc/traverse8.cu replaced. It is
// not part of the package: chip_smoke.py builds it only to time the two
// side by side, on the same rays in the same run.
//
// It reads nodes8l + leaf_rows8 (hiprt_pt_tpu_torch/accel/build.py) and
// follows the HitRecord contract of ops/traverse.py: see traverse8.cu.

#include "traverse_common.cuh"

namespace {

using namespace hpt;

constexpr int kNodeFloats = 64;   // a nodes8l row
constexpr int kStack8 = 96;       // BVH8 walk stack (host checks depth8)

__device__ __forceinline__ int child_ref(int c, int base_int, int n_int,
                                         int base_leaf) {
  return c < n_int ? base_int + c : -(base_leaf + (c - n_int)) - 1;
}

// Ascending compare-exchange of (key, ref) pairs.
__device__ __forceinline__ void cx(float* k, int* r, int a, int b) {
  if (k[a] > k[b]) {
    const float tk = k[a]; k[a] = k[b]; k[b] = tk;
    const int tr = r[a]; r[a] = r[b]; r[b] = tr;
  }
}

// K5 port. One thread per ray, persistent: every thread of the card's
// resident blocks walks one ray at a time over nodes8l + leaf_rows8 with its
// own stack (local memory) and, when its ray is done, stores the hit record
// at the ray's index and takes the next ray id. Ids come from a global
// counter, one atomic per warp for the lanes that need a ray (ballot + rank):
// the GPU form of the TPU kernel's lane pool refill. The store at the ray's
// own index takes the place of the completion log and its unscramble scatter
// (pallas_traverse.py:1738-1767). A lane takes one step (a node or a leaf
// visit) per turn of the loop, so that a lane whose ray ends takes a new ray
// while its neighbours go on. At a node the hit children are sorted by entry
// distance (a 19-comparator network) and pushed far-to-near. The walk reads
// exact f32 triangles, so no winner refinement follows; the 128-triangle
// cluster leaves of the TPU kernel exist for its matrix unit and are not
// walked.
template <bool kAnyHit>
__global__ void __launch_bounds__(128)
trace_lane8log_kernel(const float4* __restrict__ nodes8l,
                      const float* __restrict__ leaf_rows8,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ tmin,
                      const float* __restrict__ tmax,
                      const uint8_t* __restrict__ active, int64_t n,
                      unsigned long long* __restrict__ next_ray,
                      float* __restrict__ t_out, int32_t* __restrict__ prim_out,
                      float* __restrict__ u_out, float* __restrict__ v_out) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int64_t i = -1;        // this lane's ray; -1 = needs one, n = pool empty
  int stack[kStack8];
  int sp = 0;
  float best_t = 0.0f, best_u = 0.0f, best_v = 0.0f;
  int best_prim = -1;
  Ray r = {};

  while (true) {
    // refill: the lanes without a ray take consecutive ids
    const bool need = i < 0;
    const unsigned want = __ballot_sync(full, need);
    if (want != 0) {
      const int leader = __ffs(want) - 1;
      unsigned long long base = 0;
      if (lane == leader) base = atomicAdd(next_ray, (unsigned long long)__popc(want));
      base = __shfl_sync(full, base, leader);
      if (need) {
        const int64_t id = (int64_t)base + __popc(want & ((1u << lane) - 1u));
        if (id >= n) {
          i = n;
        } else {
          i = id;
          best_t = tmax[i];
          best_u = best_v = 0.0f;
          best_prim = -1;
          if (active[i]) {
            r = load_ray(o, d, tmin, i);
            stack[0] = 0;
            sp = 1;
          } else {
            sp = 0;
          }
        }
      }
    }
    if (!__any_sync(full, i < n)) break;
    if (i >= 0 && i < n && sp > 0) {
      const int ref = stack[--sp];
      if (ref >= 0) {
        const float4* nd = nodes8l + (int64_t)ref * (kNodeFloats / 4);
        float box[48];
#pragma unroll
        for (int j = 0; j < 12; ++j) {
          const float4 q = __ldg(nd + j);
          box[4 * j + 0] = q.x;
          box[4 * j + 1] = q.y;
          box[4 * j + 2] = q.z;
          box[4 * j + 3] = q.w;
        }
        const float4 w = __ldg(nd + 12);
        const int wa = __float_as_int(w.x);
        const int base_leaf = __float_as_int(w.y);
        const int base_int = wa & ((1 << 26) - 1);
        const int n_int = wa >> 26;
        float key[8];
        int refs[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float te;
          key[c] = slab(box + 6 * c, r, best_t, te) ? te : -1.0f;
          refs[c] = child_ref(c, base_int, n_int, base_leaf);
        }
        // ascending sort; misses (key -1) come first
        cx(key, refs, 0, 2); cx(key, refs, 1, 3); cx(key, refs, 4, 6);
        cx(key, refs, 5, 7); cx(key, refs, 0, 4); cx(key, refs, 1, 5);
        cx(key, refs, 2, 6); cx(key, refs, 3, 7); cx(key, refs, 0, 1);
        cx(key, refs, 2, 3); cx(key, refs, 4, 5); cx(key, refs, 6, 7);
        cx(key, refs, 2, 4); cx(key, refs, 3, 5); cx(key, refs, 1, 4);
        cx(key, refs, 3, 6); cx(key, refs, 1, 2); cx(key, refs, 3, 4);
        cx(key, refs, 5, 6);
#pragma unroll
        for (int c = 7; c >= 0; --c) {
          if (key[c] >= 0.0f) stack[sp++] = refs[c];
        }
      } else {
        const float* lr = leaf_rows8 + (int64_t)(-(ref + 1)) * kLeafFloats;
        const int cnt = (int)__ldg(lr + 121);
        for (int k = 0; k < cnt; ++k) {
          float tri[9];
#pragma unroll
          for (int j = 0; j < 9; ++j) tri[j] = __ldg(lr + 9 * k + j);
          float t, u, v;
          int prim;
          if (triangle(tri, lr + 108 + k, r, best_t, best_prim, t, u, v, prim)) {
            best_t = t;
            best_u = u;
            best_v = v;
            best_prim = prim;
            if (kAnyHit) {
              sp = 0;
              break;
            }
          }
        }
      }
    }
    if (i >= 0 && i < n && sp == 0) {
      write_hit(i, kAnyHit, best_prim, best_t, best_u, best_v,
                t_out, prim_out, u_out, v_out);
      i = -1;
    }
  }
}

}  // namespace

// Plain C interface for ctypes. Every pointer is a device pointer; `stream`
// is a cudaStream_t; `counter` is a zeroed device scratch word (int32 for
// trace_stream8, uint64 for trace_lane8log) that the kernel takes its work
// from. Returns the first CUDA error of the launch, or 0.
extern "C" {

int hpt_prev_trace_lane8log(const void* nodes8l, const void* leaf_rows8,
                       const void* o, const void* d, const void* tmin,
                       const void* tmax, const void* active, int64_t n,
                       int any_hit, void* counter, void* t, void* prim,
                       void* u, void* v, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  auto launch = [&](auto kernel) {
    int blocks = 0;
    const int err = resident_blocks(kernel, 128, &blocks);
    if (err != 0) return err;
    const int64_t need = (n + 127) / 128;
    if ((int64_t)blocks > need) blocks = (int)need;
    kernel<<<blocks, 128, 0, s>>>(
        (const float4*)nodes8l, (const float*)leaf_rows8, (const float*)o,
        (const float*)d, (const float*)tmin, (const float*)tmax,
        (const uint8_t*)active, n, (unsigned long long*)counter, (float*)t,
        (int32_t*)prim, (float*)u, (float*)v);
    return (int)cudaGetLastError();
  };
  return any_hit ? launch(trace_lane8log_kernel<true>)
                 : launch(trace_lane8log_kernel<false>);
}

// Registers per thread, local memory bytes per thread (the stack and any
// spills), static shared memory bytes and resident blocks per SM of
// trace_lane8log, for the records.
int hpt_prev_trace_lane8log_info(int any_hit, int* regs, int* local_bytes,
                                 int* shared_bytes, int* blocks_per_sm) {
  auto info = [&](auto kernel) {
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return (int)e;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    *shared_bytes = (int)attr.sharedSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, 128, 0);
  };
  return any_hit ? info(trace_lane8log_kernel<true>)
                 : info(trace_lane8log_kernel<false>);
}

}  // extern "C"
