// The packet version of trace_meganode (the port of the TPU kernel _kernel,
// hiprt_pt_tpu/ops/pallas_traverse.py:55) that the per-ray while-while walk
// of hiprt_pt_tpu_torch/csrc/traverse.cu replaced: one block per packet of
// 128 consecutive rays, the whole 512-byte row staged in shared memory at
// every visit, every decision a block-wide reduction. It is not part of the
// package: chip_smoke.py builds it only to time the two side by side, on
// the same rays in the same run.
//
// It reads the meganode table `nodes` (hiprt_pt_tpu_torch/accel/build.py)
// and follows the HitRecord contract of ops/traverse.py: see traverse.cu.

#include "traverse_common.cuh"

namespace {

using namespace hpt;

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

// Plain C interface for ctypes, as traverse.cu's (this version takes no
// scratch counter). Returns cudaGetLastError() after the launch.
extern "C" {

int hpt_prev_trace_meganode(const void* nodes, const void* o, const void* d,
                            const void* tmin, const void* tmax,
                            const void* active, int64_t n, int any_hit,
                            void* t, void* prim, void* u, void* v,
                            void* stream) {
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

// Registers per thread, local memory bytes per thread (spills; the stack is
// in shared memory), static shared memory bytes and
// resident blocks per SM, for the records.
int hpt_prev_trace_meganode_info(int any_hit, int* regs, int* local_bytes,
                                 int* shared_bytes, int* blocks_per_sm) {
  auto info = [&](auto kernel) {
    return kernel_info(kernel, kPacket, regs, local_bytes, shared_bytes,
                       blocks_per_sm);
  };
  return any_hit ? info(trace_meganode_kernel<true>)
                 : info(trace_meganode_kernel<false>);
}

}  // extern "C"
