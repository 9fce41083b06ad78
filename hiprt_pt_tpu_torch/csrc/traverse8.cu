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
// loads, as for the BVH4 kernels (traverse.cu). At 2.04M triangles the
// tables no longer fit the 50 MB L2 (nodes8l 11.8 MB, leaf_rows8 115 MB), so
// a leaf visit that misses L2 waits on device memory. Both kernels are
// persistent: as many blocks as fit the card at once, each taking work from
// a global counter, so that no SM idles behind a long walk.

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

}  // extern "C"
