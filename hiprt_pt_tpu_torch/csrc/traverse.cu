// BVH closest-hit / any-hit traversal kernels for Hopper (sm_90a).
//
// Both kernels read the port's BVH4 tables (accel/build.py): nodes4 rows of
// 32 floats (four child boxes, four int32 refs stored bit for bit; an empty
// slot has a NaN box and ref 0) and leaf rows of 128 floats (up to 12 exact
// f32 triangles [v0, e1, e2], their prim ids as int32 bits at 108..119, the
// triangle count at 121). A negative ref r is leaf row -(r+1); row 0 of the
// leaf table is a dummy. They follow the HitRecord contract of
// ops/traverse.py: a miss and an inactive ray give prim = -1, t = inf;
// any-hit returns occlusion in prim >= 0 with u = v = 0.
//
// trace_incoherent replaces the TPU kernel _kernel_lane8s
// (hiprt_pt_tpu/ops/pallas_traverse.py:1866), and trace_coherent replaces
// _kernel_compact4 (hiprt_pt_tpu/ops/pallas_traverse.py:381). A third
// kernel, trace_meganode, reads the meganode BVH2 table instead (its
// layout and design are at the kernel) and replaces _kernel
// (hiprt_pt_tpu/ops/pallas_traverse.py:55, K3).
//
// What bounds them on this card: the latency of dependent node and leaf
// loads. Each step of a walk needs the previous step's node before it knows
// what to load next, and there is little arithmetic per byte. The two
// tables take about 17 MB on the 259k-triangle stress interior (nodes4
// 1.9 MB, leaf_rows 15 MB), so after the first touches they sit in the
// 50 MB L2; each load then costs an L2 round trip, not DRAM bandwidth.
//
// What the design does about that: enough rays in flight to hide the load
// latency, one thread per ray for incoherent rays (the scheduler switches
// warps while loads are outstanding) and, for coherent rays, one packet per
// block so that a node or leaf is fetched once for 128 rays. Faster designs
// (persistent threads, TMA-staged leaves, compressed nodes) are left for
// later.
//
// The shared device helpers (ray record, slab and triangle tests, the tie
// rule) are in traverse_common.cuh.

#include "traverse_common.cuh"

namespace {

using namespace hpt;

// K1 port: one thread per ray, a private 64-entry stack in local memory.
// Hit children are pushed far-to-near (a 4-input sorting network on the
// entry distances), so a closest-hit walk reaches near geometry first and
// the shrinking t_max culls the rest.
template <bool kAnyHit>
__global__ void __launch_bounds__(128)
trace_incoherent_kernel(const float4* __restrict__ nodes4,
                        const float* __restrict__ leaf_rows,
                        const float* __restrict__ o, const float* __restrict__ d,
                        const float* __restrict__ tmin,
                        const float* __restrict__ tmax,
                        const uint8_t* __restrict__ active, int64_t n,
                        float* __restrict__ t_out, int32_t* __restrict__ prim_out,
                        float* __restrict__ u_out, float* __restrict__ v_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float best_t = tmax[i], best_u = 0.0f, best_v = 0.0f;
  int best_prim = -1;
  if (active[i]) {
    const Ray r = load_ray(o, d, tmin, i);
    int stack[kStack];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const int ref = stack[--sp];
      if (ref >= 0) {
        float box[24];
        int refs[4];
        load_node(nodes4, ref, box, refs);
        float key[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float te;
          key[c] = slab(box + 6 * c, r, best_t, te) ? te : -1.0f;
        }
        // ascending sort of (key, ref); misses (key -1) sort first
        swap_if(key[0], refs[0], key[1], refs[1]);
        swap_if(key[2], refs[2], key[3], refs[3]);
        swap_if(key[0], refs[0], key[2], refs[2]);
        swap_if(key[1], refs[1], key[3], refs[3]);
        swap_if(key[1], refs[1], key[2], refs[2]);
#pragma unroll
        for (int c = 3; c >= 0; --c) {
          if (key[c] >= 0.0f) stack[sp++] = refs[c];
        }
      } else {
        const float* lr = leaf_rows + (int64_t)(-(ref + 1)) * kLeafFloats;
        const int cnt = (int)__ldg(lr + 121);
        bool done = false;
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
              done = true;
              break;
            }
          }
        }
        if (done) break;
      }
    }
  }
  write_hit(i, kAnyHit, best_prim, best_t, best_u, best_v,
            t_out, prim_out, u_out, v_out);
}

// K2 port: one block of 128 threads per packet of 128 consecutive rays
// (one 16x8 screen tile in the tile-major pixel order). The packet walks
// one shared stack in shared memory: a child is descended if any live lane's
// slab test hits it (__syncthreads_or), children are taken in fixed order
// as in the TPU kernel, and a leaf row is staged once into shared memory for
// all lanes. A block of 128 (four warps) keeps the TPU kernel's packet size;
// a warp-sized packet is a later measurement.
template <bool kAnyHit>
__global__ void __launch_bounds__(kPacket)
trace_coherent_kernel(const float4* __restrict__ nodes4,
                      const float* __restrict__ leaf_rows,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ tmin,
                      const float* __restrict__ tmax,
                      const uint8_t* __restrict__ active, int64_t n,
                      float* __restrict__ t_out, int32_t* __restrict__ prim_out,
                      float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ int s_stack[kStack];
  __shared__ float s_leaf[kLeafFloats];
  const int lane = threadIdx.x;
  const int64_t i = (int64_t)blockIdx.x * kPacket + lane;
  const bool valid = i < n;
  bool searching = valid && active[i] != 0;
  float best_t = valid ? tmax[i] : 0.0f, best_u = 0.0f, best_v = 0.0f;
  int best_prim = -1;
  Ray r = {};
  if (valid) r = load_ray(o, d, tmin, i);

  // a packet whose lanes are all inactive returns at once
  if (__syncthreads_or(searching)) {
    // sp is uniform across the block: every push/pop decision below is
    // taken on block-wide reductions, so each thread tracks it in a register
    int sp = 1;
    if (lane == 0) s_stack[0] = 0;
    __syncthreads();
    while (sp > 0) {
      const int ref = s_stack[--sp];
      if (ref >= 0) {
        float box[24];
        int refs[4];
        load_node(nodes4, ref, box, refs);
        int take[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float te;
          const bool h = searching && slab(box + 6 * c, r, best_t, te);
          take[c] = __syncthreads_or(h);
        }
        // every thread has read s_stack[sp] (the barriers above), so lane 0
        // may now overwrite it; push in reverse so child 0 is popped first
        if (lane == 0) {
          int p = sp;
#pragma unroll
          for (int c = 3; c >= 0; --c) {
            if (take[c]) s_stack[p++] = refs[c];
          }
        }
        sp += (take[0] != 0) + (take[1] != 0) + (take[2] != 0) + (take[3] != 0);
        __syncthreads();
      } else {
        s_leaf[lane] = __ldg(leaf_rows + (int64_t)(-(ref + 1)) * kLeafFloats + lane);
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
    }
  }
  if (valid) {
    write_hit(i, kAnyHit, best_prim, best_t, best_u, best_v,
              t_out, prim_out, u_out, v_out);
  }
}

// Packet minimum of a non-negative float (+inf where a lane has nothing):
// the bit patterns of non-negative floats order as unsigned ints, so each
// warp reduces with __reduce_min_sync and the four warps meet in s_red.
// Every thread returns the packet minimum. Called by all threads.
__device__ __forceinline__ float packet_min(float x, unsigned* s_red) {
  const unsigned m = __reduce_min_sync(0xffffffffu, __float_as_uint(x));
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = m;
  __syncthreads();
  const unsigned r = min(min(s_red[0], s_red[1]), min(s_red[2], s_red[3]));
  __syncthreads();  // s_red is free again for the next call
  return __uint_as_float(r);
}

// K3 port: one block of 128 threads per packet of 128 consecutive rays (a
// 16x8 screen tile) walking the meganode BVH2 (accel/build.py `nodes`).
// Each visit stages the current 512-byte row in shared memory, one float per
// thread (one coalesced load), and every lane slab-tests both child boxes
// and intersects the embedded leaf triangles of the children it hits. The
// packet descends an internal child if any searching lane hits it
// (__syncthreads_or); with both taken it chains into the nearer one (the
// smaller packet-minimum entry distance, child 0 on a tie) and pushes the
// other on a shared stack. An empty slot (count < 0, zero box) is neither
// descended nor intersected. The walk runs until the stack is empty (or,
// for any-hit, until no lane is searching); the host checks that depth2
// fits the stack.
//
// What bounds it: as K2, the latency of one dependent row load per step
// (the whole table, <= 8 MB, stays in the 50 MB L2) plus the __syncthreads
// of each packet decision; 128 rays share each load.
template <bool kAnyHit>
__global__ void __launch_bounds__(kPacket)
trace_meganode_kernel(const float* __restrict__ nodes,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ tmin,
                      const float* __restrict__ tmax,
                      const uint8_t* __restrict__ active, int64_t n,
                      float* __restrict__ t_out, int32_t* __restrict__ prim_out,
                      float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float s_row[kMegaRowFloats];
  __shared__ int s_stack[kMegaStack];
  __shared__ unsigned s_red[kPacket / 32];
  const int lane = threadIdx.x;
  const int64_t i = (int64_t)blockIdx.x * kPacket + lane;
  const bool valid = i < n;
  bool searching = valid && active[i] != 0;
  float best_t = valid ? tmax[i] : 0.0f, best_u = 0.0f, best_v = 0.0f;
  int best_prim = -1;
  Ray r = {};
  if (valid) r = load_ray(o, d, tmin, i);

  if (__syncthreads_or(searching)) {
    // cur and sp are uniform across the block: every decision below is a
    // block-wide reduction, so each thread tracks them in registers
    int cur = 0, sp = 0;
    while (true) {
      s_row[lane] = __ldg(nodes + (int64_t)cur * kMegaRowFloats + lane);
      __syncthreads();
      const int ref0 = __float_as_int(s_row[12]), cnt0 = __float_as_int(s_row[13]);
      const int ref1 = __float_as_int(s_row[14]), cnt1 = __float_as_int(s_row[15]);
      float te0 = INFINITY, te1 = INFINITY;
      const bool h0 = searching && cnt0 >= 0 && slab(s_row, r, best_t, te0);
      const bool h1 = searching && cnt1 >= 0 && slab(s_row + 6, r, best_t, te1);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int cnt = c ? cnt1 : cnt0;
        if (!(c ? h1 : h0) || cnt <= 0) continue;
        const float* tri = s_row + 16 + 36 * c;
        const float* prims = s_row + 88 + 4 * c;
        for (int k = 0; k < cnt && k < kMegaLeafTris; ++k) {
          float t, u, v;
          int prim;
          if (triangle(tri + 9 * k, prims + k, r, best_t, best_prim, t, u, v,
                       prim)) {
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
        if (kAnyHit && !searching) break;
      }
      // the barriers below also keep the next row's staging from
      // overwriting s_row while a lane still reads this one
      const bool take0 = __syncthreads_or(searching && h0 && cnt0 == 0);
      const bool take1 = __syncthreads_or(searching && h1 && cnt1 == 0);
      if (take0 && take1) {
        bool near0 = true;
        if (!kAnyHit) {
          const float m0 = packet_min(h0 ? te0 : INFINITY, s_red);
          const float m1 = packet_min(h1 ? te1 : INFINITY, s_red);
          near0 = m0 <= m1;
        }
        // every thread has read s_stack[sp] when it popped it (barriers
        // since), so lane 0 may overwrite that slot now
        if (lane == 0) s_stack[sp] = near0 ? ref1 : ref0;
        ++sp;
        cur = near0 ? ref0 : ref1;
      } else if (take0 || take1) {
        cur = take0 ? ref0 : ref1;
      } else {
        if (sp == 0 || (kAnyHit && !__syncthreads_or(searching))) break;
        __syncthreads();  // lane 0's last push is visible to every lane
        cur = s_stack[--sp];
      }
    }
  }
  if (valid) {
    write_hit(i, kAnyHit, best_prim, best_t, best_u, best_v,
              t_out, prim_out, u_out, v_out);
  }
}

}  // namespace

// Plain C interface for ctypes. Every pointer is a device pointer; `stream`
// is a cudaStream_t. Returns cudaGetLastError() after the launch.
extern "C" {

int hpt_trace_meganode(const void* nodes, const void* o, const void* d,
                       const void* tmin, const void* tmax, const void* active,
                       int64_t n, int any_hit, void* t, void* prim, void* u,
                       void* v, void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + kPacket - 1) / kPacket);
  cudaStream_t s = (cudaStream_t)stream;
  auto args = [&](auto kernel) {
    kernel<<<blocks, kPacket, 0, s>>>(
        (const float*)nodes, (const float*)o, (const float*)d,
        (const float*)tmin, (const float*)tmax, (const uint8_t*)active, n,
        (float*)t, (int32_t*)prim, (float*)u, (float*)v);
  };
  if (any_hit) args(trace_meganode_kernel<true>);
  else args(trace_meganode_kernel<false>);
  return (int)cudaGetLastError();
}

int hpt_trace_incoherent(const void* nodes4, const void* leaf_rows,
                         const void* o, const void* d, const void* tmin,
                         const void* tmax, const void* active, int64_t n,
                         int any_hit, void* t, void* prim, void* u, void* v,
                         void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + 127) / 128);
  cudaStream_t s = (cudaStream_t)stream;
  auto args = [&](auto kernel) {
    kernel<<<blocks, 128, 0, s>>>(
        (const float4*)nodes4, (const float*)leaf_rows, (const float*)o,
        (const float*)d, (const float*)tmin, (const float*)tmax,
        (const uint8_t*)active, n, (float*)t, (int32_t*)prim, (float*)u,
        (float*)v);
  };
  if (any_hit) args(trace_incoherent_kernel<true>);
  else args(trace_incoherent_kernel<false>);
  return (int)cudaGetLastError();
}

int hpt_trace_coherent(const void* nodes4, const void* leaf_rows,
                       const void* o, const void* d, const void* tmin,
                       const void* tmax, const void* active, int64_t n,
                       int any_hit, void* t, void* prim, void* u, void* v,
                       void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + kPacket - 1) / kPacket);
  cudaStream_t s = (cudaStream_t)stream;
  auto args = [&](auto kernel) {
    kernel<<<blocks, kPacket, 0, s>>>(
        (const float4*)nodes4, (const float*)leaf_rows, (const float*)o,
        (const float*)d, (const float*)tmin, (const float*)tmax,
        (const uint8_t*)active, n, (float*)t, (int32_t*)prim, (float*)u,
        (float*)v);
  };
  if (any_hit) args(trace_coherent_kernel<true>);
  else args(trace_coherent_kernel<false>);
  return (int)cudaGetLastError();
}

}  // extern "C"
