// BVH8 closest-hit / any-hit traversal kernels for Hopper (sm_90a).
//
// Both kernels read the port's BVH8 tables (accel/build.py): nodes8l rows of
// 64 floats (up to eight child boxes, internal children first, NaN for an
// empty slot; word A at 48 = first internal child row | n_internal << 26 and
// word B at 49 = first leaf row, both int32 bits) and leaf_rows8 rows of 128
// floats (up to 12 exact f32 triangles [v0, e1, e2], their prim ids as int32
// bits at 108..119, the triangle count at 121). Child c of a node is node row
// A.base + c below n_internal, else leaf row B.base + (c - n_internal). They
// follow the HitRecord contract of ops/traverse.py, with its tie rule, and
// walk until their stack is empty: there is no iteration cap. The host checks
// that 7 * depth8 + 1 entries fit kStack8 (ops/traverse.py,
// check_stack8_depth).
//
// trace_stream8 replaces the TPU kernel _kernel_stream8l
// (hiprt_pt_tpu/ops/pallas_traverse.py:724, K4) for the coherent rays of a
// big scene (camera rays in tile order, RIS's tile-shared shadow rays);
// trace_lane8log replaces _kernel_lane8log
// (hiprt_pt_tpu/ops/pallas_traverse.py:1331, K5) for rays that scatter.
//
// What bounds them on this card: the latency of dependent node and leaf
// loads, and the lanes of a warp that sit idle while the others work. At
// 2.04M triangles nodes8l (11.8 MB) stays in the 50 MB L2 and leaf_rows8
// (115 MB; a leaf holds 9 triangles on average) does not, so a leaf visit
// that misses L2 waits on device memory.
//
// What the design does about that. Both kernels run one walk, walk8 below:
// one ray a thread in persistent threads (as many blocks as fit the card,
// each thread taking its next ray from a global counter when its ray ends),
// as a while-while walk that keeps each body of its loop (descent, leaf) for
// the lanes that need it, orders children with one register per child,
// leaves the nearest child off the stack, drops stack entries the ray has
// passed without loading them, and reads a leaf with 16-byte loads, a
// group's loads ahead of its tests. One compile-time choice tells the
// kernels apart, the refill: trace_lane8log hands a lane a new ray as soon
// as its ray ends; trace_stream8 lets lanes wait until half the warp does
// (or none walks), as trace_incoherent does (traverse.cu:refill_now), so
// that the rays of a warp are drawn together and stay neighbours in a
// screen tile. What was measured (previous_kernels/sweep_k4.py, NVIDIA
// H100): on stress14's camera rays that refill takes 6% off K5's walk, 2% on
// RIS's tile-shared shadow rays; the top BFS levels of nodes8l copied into
// each block's shared memory (previous_kernels/trace_stream8_toptree.cu)
// served 11 of a camera ray's 14 node visits there and saved nothing, since
// those rows are L1 hits already; the block-packet walk it replaced took
// 2.3x and 3x as long.

#include "traverse_common.cuh"

// With HPT_K4_PROFILE (previous_kernels/sweep_k4.py builds it so)
// trace_stream8 adds its counts to scratch[1 + slot], summed over lanes: 0
// node visits, 1 leaf visits, 2 rays drawn, 3 refills of a warp, 4 turns of
// a warp; a profile build is for trace_stream8 only.

namespace {

using namespace hpt;

constexpr int kNodeFloats = 64;   // a nodes8l row
constexpr int kStack8 = 96;       // BVH8 walk stack (host checks depth8)
// trace_stream8's refill: the waiting lanes of a warp that draw rays
// (traverse.cu's kRefillLanes)
constexpr int kStreamRefill = 16;
constexpr int kWalkThreads = 128;
// at least four blocks an SM leaves ptxas up to 128 registers a thread; it
// takes 80, so six blocks are resident (eight would spill)
constexpr int kWalkBlocksPerSM = 4;

__device__ __forceinline__ int child_ref(int c, int base_int, int n_int,
                                         int base_leaf) {
  return c < n_int ? base_int + c : -(base_leaf + (c - n_int)) - 1;
}

// Ascending compare-exchange of two sort keys.
__device__ __forceinline__ void cx(unsigned (&k)[8], int a, int b) {
  const unsigned lo = min(k[a], k[b]), hi = max(k[a], k[b]);
  k[a] = lo;
  k[b] = hi;
}

// The walk of both kernels. One thread per ray, persistent: every thread of
// the card's resident blocks walks one ray at a time over nodes8l +
// leaf_rows8 with its own stack (local memory) and, when its ray is done,
// stores the hit record at the ray's index and takes the next ray id. Ids
// come from a global counter, one atomic per warp for the lanes that need a
// ray (ballot + rank): the GPU form of the TPU kernels' lane pool and
// streaming refill. The store at the ray's own index takes the place of K5's
// completion log and its unscramble scatter (pallas_traverse.py:1738-1767).
// The walk reads exact f32 triangles, so no winner refinement follows; the
// 128-triangle cluster leaves of the TPU kernels exist for its matrix unit
// and are not walked.
//
// The loop is a "while-while" walk. A turn has three parts that the warp
// runs together: the refill (kRefill = 1: lanes whose ray ended take new
// rays until every lane holds a live ray or the pool is empty; else once
// kRefill lanes wait or no lane walks, see refill_now in traverse.cu; an
// inactive ray is answered at once); the descent (a lane goes down through
// nodes until it holds a leaf or its ray ends); the leaf (every lane that
// holds one tests it). So the node body and the leaf body each run with the
// lanes that need it, not both on every step.
//   Node: 13 16-byte loads, eight slab tests, and one sort key per child:
//   the entry distance's bits (>= 0, so they order as unsigned) with the
//   child's slot in the low three bits, all ones for a miss. A 19-comparator
//   network of min/max sorts the eight keys. The nearest hit child stays in
//   a register as the next visit; the others go on the stack far to near,
//   each with its entry distance (closest hit only), so that a pop skips an
//   entry the ray's best t has since passed without loading it.
//   Leaf: four triangles are 36 floats, nine 16-byte loads; the first four
//   and the row's count are loaded together, the next groups only where the
//   count asks for them, all of a group's loads before its tests.
template <bool kAnyHit, int kRefill>
__device__ __forceinline__ void walk8(
    const float4* __restrict__ nodes8l, const float4* __restrict__ leaf_rows8,
    const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ tmin,
    const float* __restrict__ tmax, const uint8_t* __restrict__ active,
    int64_t n, unsigned long long* __restrict__ next_ray,
    float* __restrict__ t_out, int32_t* __restrict__ prim_out,
    float* __restrict__ u_out, float* __restrict__ v_out) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int64_t i = -1;        // this lane's ray; -1 = needs one, n = pool empty
  int cur = kNone;       // the node row (>= 0) or leaf (-(row) - 1) to visit
  int stack_ref[kStack8];
  float stack_t[kAnyHit ? 1 : kStack8];
  int sp = 0;
  float best_t = 0.0f, best_u = 0.0f, best_v = 0.0f;
  int best_prim = -1;
  Ray r = {};
#ifdef HPT_K4_PROFILE
  unsigned long long prof[5] = {};
#define K4_PROF(slot, value) prof[slot] += (unsigned long long)(value)
#else
#define K4_PROF(slot, value)
#endif

  // ends the lane's ray: the record goes to the ray's own index
  auto finish = [&]() {
    write_hit(i, kAnyHit, best_prim, best_t, best_u, best_v, t_out, prim_out,
              u_out, v_out);
    i = -1;
    cur = kNone;
    sp = 0;
  };
  // the next visit from the stack, or the end of the ray
  auto pop = [&]() {
    cur = kNone;
    while (sp > 0) {
      --sp;
      if (kAnyHit || stack_t[kAnyHit ? 0 : sp] <= best_t) {
        cur = stack_ref[sp];
        return;
      }
    }
    finish();
  };

  while (true) {
    K4_PROF(4, lane == 0);
    // refill: the lanes without a ray take consecutive ids
    while (true) {
      const bool need = i < 0;
      const unsigned want = __ballot_sync(full, need);
      if constexpr (kRefill <= 1) {
        if (want == 0) break;
      } else {
        if (want == 0 || (__popc(want) < kRefill &&
                          __any_sync(full, i >= 0 && i < n))) {
          break;
        }
      }
      K4_PROF(3, lane == 0);
      const int leader = __ffs(want) - 1;
      unsigned long long base = 0;
      if (lane == leader) base = atomicAdd(next_ray, (unsigned long long)__popc(want));
      base = __shfl_sync(full, base, leader);
      if (need) {
        const int64_t id = (int64_t)base + __popc(want & ((1u << lane) - 1u));
        if (id >= n) {
          i = n;
        } else {
          K4_PROF(2, 1);
          i = id;
          best_t = tmax[i];
          best_u = best_v = 0.0f;
          best_prim = -1;
          if (active[i]) {
            r = load_ray(o, d, tmin, i);
            cur = 0;
          } else {
            finish();
          }
        }
      }
    }
    if (!__any_sync(full, i < n)) break;

    // the descent
    while (cur >= 0) {
      K4_PROF(0, 1);
      const float4* nd = nodes8l + (int64_t)cur * (kNodeFloats / 4);
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
      unsigned key[8];
      int n_hit = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float te;
        const bool h = slab(box + 6 * c, r, best_t, te);
        key[c] = h ? ((__float_as_uint(te) & ~7u) | (unsigned)c) : kMissKey;
        n_hit += h;
      }
      if (n_hit == 0) {
        pop();
        continue;
      }
      cx(key, 0, 2); cx(key, 1, 3); cx(key, 4, 6); cx(key, 5, 7);
      cx(key, 0, 4); cx(key, 1, 5); cx(key, 2, 6); cx(key, 3, 7);
      cx(key, 0, 1); cx(key, 2, 3); cx(key, 4, 5); cx(key, 6, 7);
      cx(key, 2, 4); cx(key, 3, 5); cx(key, 1, 4); cx(key, 3, 6);
      cx(key, 1, 2); cx(key, 3, 4); cx(key, 5, 6);
#pragma unroll
      for (int c = 7; c >= 1; --c) {
        if (c < n_hit) {
          stack_ref[sp] = child_ref((int)(key[c] & 7u), base_int, n_int, base_leaf);
          if (!kAnyHit) stack_t[kAnyHit ? 0 : sp] = __uint_as_float(key[c] & ~7u);
          ++sp;
        }
      }
      cur = child_ref((int)(key[0] & 7u), base_int, n_int, base_leaf);
    }
    __syncwarp();

    // the leaf
    if (cur != kNone) {
      K4_PROF(1, 1);
      const int row = -(cur + 1);
      const float4* lr = leaf_rows8 + (int64_t)row * (kLeafFloats / 4);
      const float* prims = reinterpret_cast<const float*>(lr) + 108;
      const float4 meta = __ldg(lr + 30);   // floats 120..123: flag, count
      const int cnt = (int)meta.y;
      bool done = false;
#pragma unroll
      for (int grp = 0; grp < kLeafTris / 4; ++grp) {
        // the first group is loaded beside the count, not behind it
        if (grp == 0 || (4 * grp < cnt && !done)) {
          float f[36];
#pragma unroll
          for (int j = 0; j < 9; ++j) {
            const float4 q = __ldg(lr + 9 * grp + j);
            f[4 * j + 0] = q.x;
            f[4 * j + 1] = q.y;
            f[4 * j + 2] = q.z;
            f[4 * j + 3] = q.w;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float t, u, v;
            int prim;
            if (4 * grp + k < cnt && !done &&
                triangle(f + 9 * k, prims + 4 * grp + k, r, best_t, best_prim,
                         t, u, v, prim)) {
              best_t = t;
              best_u = u;
              best_v = v;
              best_prim = prim;
              if (kAnyHit) done = true;
            }
          }
        }
      }
      if (done) {
        finish();
      } else {
        pop();
      }
    }
  }
#ifdef HPT_K4_PROFILE
#pragma unroll
  for (int s = 0; s < 5; ++s) atomicAdd(next_ray + 1 + s, prof[s]);
#endif
#undef K4_PROF
}

// K4 port: walk8 with the refill of half a warp, so that a warp's lanes
// hold neighbouring rays of one screen tile.
template <bool kAnyHit>
__global__ void __launch_bounds__(kWalkThreads, kWalkBlocksPerSM)
trace_stream8_kernel(const float4* __restrict__ nodes8l,
                     const float4* __restrict__ leaf_rows8,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ tmin,
                     const float* __restrict__ tmax,
                     const uint8_t* __restrict__ active, int64_t n,
                     unsigned long long* __restrict__ next_ray,
                     float* __restrict__ t_out, int32_t* __restrict__ prim_out,
                     float* __restrict__ u_out, float* __restrict__ v_out) {
  walk8<kAnyHit, kStreamRefill>(nodes8l, leaf_rows8, o, d, tmin, tmax, active,
                                n, next_ray, t_out, prim_out, u_out, v_out);
}

// K5 port: walk8 with a lane refilled as soon as its ray ends.
template <bool kAnyHit>
__global__ void __launch_bounds__(kWalkThreads, kWalkBlocksPerSM)
trace_lane8log_kernel(const float4* __restrict__ nodes8l,
                      const float4* __restrict__ leaf_rows8,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ tmin,
                      const float* __restrict__ tmax,
                      const uint8_t* __restrict__ active, int64_t n,
                      unsigned long long* __restrict__ next_ray,
                      float* __restrict__ t_out, int32_t* __restrict__ prim_out,
                      float* __restrict__ u_out, float* __restrict__ v_out) {
  walk8<kAnyHit, 1>(nodes8l, leaf_rows8, o, d, tmin, tmax, active, n, next_ray,
                    t_out, prim_out, u_out, v_out);
}

// A persistent launch of a walk8 kernel: as many blocks as fit the card at
// once, no more than the rays need.
template <typename K>
int launch_walk8(K kernel, const void* nodes8l, const void* leaf_rows8,
                 const void* o, const void* d, const void* tmin,
                 const void* tmax, const void* active, int64_t n, void* counter,
                 void* t, void* prim, void* u, void* v, void* stream) {
  int blocks = 0;
  const int err = resident_blocks(kernel, kWalkThreads, &blocks);
  if (err != 0) return err;
  const int64_t need = (n + kWalkThreads - 1) / kWalkThreads;
  if ((int64_t)blocks > need) blocks = (int)need;
  kernel<<<blocks, kWalkThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)nodes8l, (const float4*)leaf_rows8, (const float*)o,
      (const float*)d, (const float*)tmin, (const float*)tmax,
      (const uint8_t*)active, n, (unsigned long long*)counter, (float*)t,
      (int32_t*)prim, (float*)u, (float*)v);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. Every pointer is a device pointer; `stream`
// is a cudaStream_t; `counter` is a zeroed device scratch word (uint64) that
// the kernel takes its rays from. Returns the first CUDA error of the
// launch, or 0.
extern "C" {

int hpt_trace_stream8(const void* nodes8l, const void* leaf_rows8,
                      const void* o, const void* d, const void* tmin,
                      const void* tmax, const void* active, int64_t n,
                      int any_hit, void* counter, void* t, void* prim, void* u,
                      void* v, void* stream) {
  if (n <= 0) return 0;
  return launch_walk8(any_hit ? trace_stream8_kernel<true>
                              : trace_stream8_kernel<false>,
                      nodes8l, leaf_rows8, o, d, tmin, tmax, active, n, counter,
                      t, prim, u, v, stream);
}

int hpt_trace_lane8log(const void* nodes8l, const void* leaf_rows8,
                       const void* o, const void* d, const void* tmin,
                       const void* tmax, const void* active, int64_t n,
                       int any_hit, void* counter, void* t, void* prim,
                       void* u, void* v, void* stream) {
  if (n <= 0) return 0;
  return launch_walk8(any_hit ? trace_lane8log_kernel<true>
                              : trace_lane8log_kernel<false>,
                      nodes8l, leaf_rows8, o, d, tmin, tmax, active, n, counter,
                      t, prim, u, v, stream);
}

// Registers per thread, local memory bytes per thread (the stack and any
// spills), static shared memory bytes and resident blocks per SM, for the
// records.
int hpt_trace_stream8_info(int any_hit, int* regs, int* local_bytes,
                           int* shared_bytes, int* blocks_per_sm) {
  return kernel_info(any_hit ? trace_stream8_kernel<true>
                             : trace_stream8_kernel<false>,
                     kWalkThreads, regs, local_bytes, shared_bytes,
                     blocks_per_sm);
}

int hpt_trace_lane8log_info(int any_hit, int* regs, int* local_bytes,
                            int* shared_bytes, int* blocks_per_sm) {
  return kernel_info(any_hit ? trace_lane8log_kernel<true>
                             : trace_lane8log_kernel<false>,
                     kWalkThreads, regs, local_bytes, shared_bytes,
                     blocks_per_sm);
}

}  // extern "C"
