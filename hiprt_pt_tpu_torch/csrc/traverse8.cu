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
// walk until their stack is empty: there is no iteration cap. The host
// checks that 7 * depth8 + 1 entries fit kStack8 (ops/traverse.py,
// check_stack8_depth).
//
// trace_stream8 replaces the TPU kernel _kernel_stream8l
// (hiprt_pt_tpu/ops/pallas_traverse.py:724, K4); trace_lane8log replaces
// _kernel_lane8log (hiprt_pt_tpu/ops/pallas_traverse.py:1331, K5).
//
// What bounds them on this card: the latency of dependent node and leaf
// loads, and the lanes of a warp that sit idle while the others work. At
// 2.04M triangles nodes8l (11.8 MB) stays in the 50 MB L2 and leaf_rows8
// (115 MB; a leaf holds 9 triangles on average) does not, so a leaf visit
// that misses L2 waits on device memory. Both kernels are persistent: as
// many blocks as fit the card at once, each taking work from a global
// counter, so that no SM idles behind a long walk. trace_stream8 keeps a
// packet's lanes together by walking the packet as one; trace_lane8log, for
// rays that scatter, keeps each body of its loop (descent, leaf) for the
// lanes that need it, orders children with one register per child, leaves
// the nearest child off the stack, drops stack entries the ray has passed
// without loading them, and reads a leaf with 16-byte loads, a group's
// loads ahead of its tests (see the kernel).

#include "traverse_common.cuh"

namespace {

using namespace hpt;

constexpr int kNodeFloats = 64;   // a nodes8l row
constexpr int kStack8 = 96;       // BVH8 walk stack (host checks depth8)
constexpr int kWarps = kPacket / 32;

__device__ __forceinline__ int child_ref(int c, int base_int, int n_int,
                                         int base_leaf) {
  return c < n_int ? base_int + c : -(base_leaf + (c - n_int)) - 1;
}

// K4 port. One block of 128 threads walks one packet of 128 consecutive rays
// (a 16x8 screen tile) at a time, and takes its next packet from a global
// counter when the packet finishes: the GPU form of the TPU kernel's
// streaming refill (qhead_s, pallas_traverse.py:735-763), here across all
// resident blocks of the card. Each visit stages the node row (64 floats)
// or the leaf row (128 floats) in shared memory with one coalesced load. At
// a node every searching lane slab-tests the eight children; the packet
// takes a child if any lane hits it, descends first into the child with the
// smallest packet-minimum entry distance (the lowest slot on a tie) and
// pushes the others on a shared stack. Push and pop are packet-uniform: the
// hit masks and minima are reduced per warp and then across the four warps
// through shared memory.
template <bool kAnyHit>
__global__ void __launch_bounds__(kPacket)
trace_stream8_kernel(const float* __restrict__ nodes8l,
                     const float* __restrict__ leaf_rows8,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ tmin,
                     const float* __restrict__ tmax,
                     const uint8_t* __restrict__ active, int64_t n,
                     int64_t n_packets, int* __restrict__ next_packet,
                     float* __restrict__ t_out, int32_t* __restrict__ prim_out,
                     float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float s_node[kNodeFloats];
  __shared__ float s_leaf[kLeafFloats];
  __shared__ int s_stack[kStack8];
  __shared__ unsigned s_min[kWarps][8];
  __shared__ unsigned s_mask[kWarps];
  __shared__ int s_packet;
  const int lane = threadIdx.x;
  const int warp = lane >> 5;

  while (true) {
    if (lane == 0) s_packet = atomicAdd(next_packet, 1);
    __syncthreads();
    const int64_t packet = s_packet;
    if (packet >= n_packets) break;
    const int64_t i = packet * kPacket + lane;
    const bool valid = i < n;
    bool searching = valid && active[i] != 0;
    float best_t = valid ? tmax[i] : 0.0f, best_u = 0.0f,
          best_v = 0.0f;
    int best_prim = -1;
    Ray r = {};
    if (valid) r = load_ray(o, d, tmin, i);

    // cur and sp are uniform across the block: every decision below is a
    // block-wide reduction, so each thread tracks them in registers. The
    // barrier inside __syncthreads_or also orders this packet's first
    // s_packet read before the next packet's write.
    if (__syncthreads_or(searching)) {
      int cur = 0, sp = 0;
      while (true) {
        bool pop = true;
        if (cur >= 0) {
          if (lane < kNodeFloats) {
            s_node[lane] = __ldg(nodes8l + (int64_t)cur * kNodeFloats + lane);
          }
          __syncthreads();
          unsigned mask = 0;
          unsigned tbits[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            float te = INFINITY;
            const bool h = searching && slab(s_node + 6 * c, r, best_t, te);
            mask |= (unsigned)h << c;
            tbits[c] = __float_as_uint(h ? te : INFINITY);
          }
          const int wa = __float_as_int(s_node[48]);
          const int base_leaf = __float_as_int(s_node[49]);
          const unsigned wmask = __reduce_or_sync(0xffffffffu, mask);
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            // entry distances are >= 0, so their bits order as unsigned ints
            const unsigned m = __reduce_min_sync(0xffffffffu, tbits[c]);
            if ((lane & 31) == 0) s_min[warp][c] = m;
          }
          if ((lane & 31) == 0) s_mask[warp] = wmask;
          __syncthreads();
          unsigned hw = 0;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) hw |= s_mask[w];
          if (hw != 0) {
            int c_near = 0;
            unsigned t_near = 0xffffffffu;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              unsigned m = s_min[0][c];
#pragma unroll
              for (int w = 1; w < kWarps; ++w) m = min(m, s_min[w][c]);
              if (((hw >> c) & 1) && m < t_near) {
                t_near = m;
                c_near = c;
              }
            }
            const int base_int = wa & ((1 << 26) - 1);
            const int n_int = wa >> 26;
            // every thread read s_stack[sp] when it popped it (barriers
            // since), so lane 0 may overwrite it now
            if (lane == 0) {
              int p = sp;
#pragma unroll
              for (int c = 0; c < 8; ++c) {
                if (((hw >> c) & 1) && c != c_near) {
                  s_stack[p++] = child_ref(c, base_int, n_int, base_leaf);
                }
              }
            }
            sp += __popc(hw) - 1;
            cur = child_ref(c_near, base_int, n_int, base_leaf);
            pop = false;
          }
          // the barrier keeps s_min, s_mask and s_node from being rewritten
          // by the next visit while a lane still reads them, and makes lane
          // 0's pushes visible
          __syncthreads();
        } else {
          s_leaf[lane] = __ldg(leaf_rows8 + (int64_t)(-(cur + 1)) * kLeafFloats
                               + lane);
          __syncthreads();
          const int cnt = (int)s_leaf[121];
          if (searching) {
            for (int k = 0; k < cnt; ++k) {
              float t, u, v;
              int prim;
              if (triangle(s_leaf + 9 * k, s_leaf + 108 + k, r, best_t,
                           best_prim, t, u, v, prim)) {
                best_t = t;
                best_u = u;
                best_v = v;
                best_prim = prim;
                if (kAnyHit) {
                  searching = false;
                  break;
                }
              }
            }
          }
          // the barrier also keeps the next leaf's staging from overwriting
          // s_leaf while a lane still reads it
          if (kAnyHit) {
            if (!__syncthreads_or(searching)) break;
          } else {
            __syncthreads();
          }
        }
        if (pop) {
          if (sp == 0) break;
          cur = s_stack[--sp];
        }
      }
    }
    if (valid) {
      write_hit(i, kAnyHit, best_prim, best_t, best_u, best_v,
                t_out, prim_out, u_out, v_out);
    }
  }
}

// Ascending compare-exchange of two sort keys.
__device__ __forceinline__ void cx(unsigned (&k)[8], int a, int b) {
  const unsigned lo = min(k[a], k[b]), hi = max(k[a], k[b]);
  k[a] = lo;
  k[b] = hi;
}

constexpr int kLaneThreads = 128;
// at least four blocks an SM leaves ptxas up to 128 registers a thread; it
// takes 80, so six blocks are resident (eight would spill)
constexpr int kLaneBlocksPerSM = 4;

// K5 port. One thread per ray, persistent: every thread of the card's
// resident blocks walks one ray at a time over nodes8l + leaf_rows8 with its
// own stack (local memory) and, when its ray is done, stores the hit record
// at the ray's index and takes the next ray id. Ids come from a global
// counter, one atomic per warp for the lanes that need a ray (ballot + rank):
// the GPU form of the TPU kernel's lane pool refill. The store at the ray's
// own index takes the place of the completion log and its unscramble scatter
// (pallas_traverse.py:1738-1767). The walk reads exact f32 triangles, so no
// winner refinement follows; the 128-triangle cluster leaves of the TPU
// kernel exist for its matrix unit and are not walked.
//
// The loop is a "while-while" walk. A turn has three parts that the warp
// runs together: the refill (lanes whose ray ended take new rays until every
// lane holds a live ray or the pool is empty; an inactive ray is answered at
// once); the descent (a lane goes down through nodes until it holds a leaf
// or its ray ends); the leaf (every lane that holds one tests it). So the
// node body and the leaf body each run with the lanes that need it, not both
// on every step.
//   Node: 13 16-byte loads, eight slab tests, and one sort key per child: the
//   entry distance's bits (>= 0, so they order as unsigned) with the child's
//   slot in the low three bits, all ones for a miss. A 19-comparator network
//   of min/max sorts the eight keys. The nearest hit child stays in a
//   register as the next visit; the others go on the stack far to near, each
//   with its entry distance (closest hit only), so that a pop skips an entry
//   the ray's best t has since passed without loading it.
//   Leaf: four triangles are 36 floats, nine 16-byte loads; the first four
//   and the row's count are loaded together, the next groups only where the
//   count asks for them, all of a group's loads before its tests.
template <bool kAnyHit>
__global__ void __launch_bounds__(kLaneThreads, kLaneBlocksPerSM)
trace_lane8log_kernel(const float4* __restrict__ nodes8l,
                      const float4* __restrict__ leaf_rows8,
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
  int cur = kNone;       // the node row (>= 0) or leaf (-(row) - 1) to visit
  int stack_ref[kStack8];
  float stack_t[kAnyHit ? 1 : kStack8];
  int sp = 0;
  float best_t = 0.0f, best_u = 0.0f, best_v = 0.0f;
  int best_prim = -1;
  Ray r = {};

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
    // refill: the lanes without a ray take consecutive ids
    while (true) {
      const bool need = i < 0;
      const unsigned want = __ballot_sync(full, need);
      if (want == 0) break;
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
}

}  // namespace

// Plain C interface for ctypes. Every pointer is a device pointer; `stream`
// is a cudaStream_t; `counter` is a zeroed device scratch word (int32 for
// trace_stream8, uint64 for trace_lane8log) that the kernel takes its work
// from. Returns the first CUDA error of the launch, or 0.
extern "C" {

int hpt_trace_stream8(const void* nodes8l, const void* leaf_rows8,
                      const void* o, const void* d, const void* tmin,
                      const void* tmax, const void* active, int64_t n,
                      int any_hit, void* counter, void* t, void* prim, void* u,
                      void* v, void* stream) {
  if (n <= 0) return 0;
  const int64_t packets = (n + kPacket - 1) / kPacket;
  cudaStream_t s = (cudaStream_t)stream;
  auto launch = [&](auto kernel) {
    int blocks = 0;
    const int err = resident_blocks(kernel, kPacket, &blocks);
    if (err != 0) return err;
    if ((int64_t)blocks > packets) blocks = (int)packets;
    kernel<<<blocks, kPacket, 0, s>>>(
        (const float*)nodes8l, (const float*)leaf_rows8, (const float*)o,
        (const float*)d, (const float*)tmin, (const float*)tmax,
        (const uint8_t*)active, n, packets, (int*)counter, (float*)t,
        (int32_t*)prim, (float*)u, (float*)v);
    return (int)cudaGetLastError();
  };
  return any_hit ? launch(trace_stream8_kernel<true>)
                 : launch(trace_stream8_kernel<false>);
}

int hpt_trace_lane8log(const void* nodes8l, const void* leaf_rows8,
                       const void* o, const void* d, const void* tmin,
                       const void* tmax, const void* active, int64_t n,
                       int any_hit, void* counter, void* t, void* prim,
                       void* u, void* v, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  auto launch = [&](auto kernel) {
    int blocks = 0;
    const int err = resident_blocks(kernel, kLaneThreads, &blocks);
    if (err != 0) return err;
    const int64_t need = (n + kLaneThreads - 1) / kLaneThreads;
    if ((int64_t)blocks > need) blocks = (int)need;
    kernel<<<blocks, kLaneThreads, 0, s>>>(
        (const float4*)nodes8l, (const float4*)leaf_rows8, (const float*)o,
        (const float*)d, (const float*)tmin, (const float*)tmax,
        (const uint8_t*)active, n, (unsigned long long*)counter, (float*)t,
        (int32_t*)prim, (float*)u, (float*)v);
    return (int)cudaGetLastError();
  };
  return any_hit ? launch(trace_lane8log_kernel<true>)
                 : launch(trace_lane8log_kernel<false>);
}

// Registers per thread, local memory bytes per thread (the stack and any
// spills), static shared memory bytes and
// resident blocks per SM of trace_lane8log, for the records.
int hpt_trace_lane8log_info(int any_hit, int* regs, int* local_bytes,
                            int* shared_bytes, int* blocks_per_sm) {
  auto info = [&](auto kernel) {
    return kernel_info(kernel, kLaneThreads, regs, local_bytes, shared_bytes,
                       blocks_per_sm);
  };
  return any_hit ? info(trace_lane8log_kernel<true>)
                 : info(trace_lane8log_kernel<false>);
}

}  // extern "C"
