// The block-packet version of trace_stream8 (the port of the TPU kernel
// _kernel_stream8l, hiprt_pt_tpu/ops/pallas_traverse.py:724) that the
// per-ray walk of hiprt_pt_tpu_torch/csrc/traverse8.cu replaced. It is not
// part of the package: chip_smoke.py builds it only to time the two side by
// side, on the same rays in the same run.
//
// It reads nodes8l + leaf_rows8 (hiprt_pt_tpu_torch/accel/build.py) and
// follows the HitRecord contract of ops/traverse.py: see traverse8.cu.

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

// One block of 128 threads walks one packet of 128 consecutive rays (a 16x8
// screen tile) at a time, and takes its next packet from a global counter
// when the packet finishes: the GPU form of the TPU kernel's streaming
// refill (qhead_s, pallas_traverse.py:735-763), here across all resident
// blocks of the card. Each visit stages the node row (64 floats) or the leaf
// row (128 floats) in shared memory with one coalesced load. At a node every
// searching lane slab-tests the eight children; the packet takes a child if
// any lane hits it, descends first into the child with the smallest
// packet-minimum entry distance (the lowest slot on a tie) and pushes the
// others on a shared stack. Push and pop are packet-uniform: the hit masks
// and minima are reduced per warp and then across the four warps through
// shared memory.
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

}  // namespace

// Plain C interface for ctypes. Every pointer is a device pointer; `stream`
// is a cudaStream_t; `counter` is a zeroed device scratch word (int32) that
// the kernel takes its packets from. Returns the first CUDA error of the
// launch, or 0.
extern "C" {

int hpt_prev_trace_stream8(const void* nodes8l, const void* leaf_rows8,
                           const void* o, const void* d, const void* tmin,
                           const void* tmax, const void* active, int64_t n,
                           int any_hit, void* counter, void* t, void* prim,
                           void* u, void* v, void* stream) {
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

// Registers per thread, local memory bytes per thread, static shared memory
// bytes and resident blocks per SM of the block-packet trace_stream8, for
// the records.
int hpt_prev_trace_stream8_info(int any_hit, int* regs, int* local_bytes,
                                int* shared_bytes, int* blocks_per_sm) {
  auto info = [&](auto kernel) {
    return kernel_info(kernel, kPacket, regs, local_bytes, shared_bytes,
                       blocks_per_sm);
  };
  return any_hit ? info(trace_stream8_kernel<true>)
                 : info(trace_stream8_kernel<false>);
}

}  // extern "C"
