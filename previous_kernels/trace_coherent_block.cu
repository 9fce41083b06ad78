// The block-packet version of trace_coherent (the port of the TPU kernel
// _kernel_compact4, hiprt_pt_tpu/ops/pallas_traverse.py:381) that the
// warp-packet walk of hiprt_pt_tpu_torch/csrc/traverse.cu replaced: one
// block of 128 threads per packet of 128 consecutive rays, one launch block
// per packet, children taken in fixed order, every decision a block-wide
// reduction. It is not part of the package: chip_smoke.py builds it only to
// time the two side by side, on the same rays in the same run.
//
// It reads nodes4 + leaf_rows (hiprt_pt_tpu_torch/accel/build.py) and
// follows the HitRecord contract of ops/traverse.py: see traverse.cu.

#include "traverse_common.cuh"

namespace {

using namespace hpt;

constexpr int kBlockPacket = 128;  // rays per packet = one 16x8 screen tile

// K2 port: one block of 128 threads per packet of 128 consecutive rays
// (one 16x8 screen tile in the tile-major pixel order). The packet walks
// one shared stack in shared memory: a child is descended if any live lane's
// slab test hits it (__syncthreads_or), children are taken in fixed order
// as in the TPU kernel, and a leaf row is staged once into shared memory for
// all lanes.
template <bool kAnyHit>
__global__ void __launch_bounds__(kBlockPacket)
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
  const int64_t i = (int64_t)blockIdx.x * kBlockPacket + lane;
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

}  // namespace

// Plain C interface for ctypes, as traverse.cu's (this version takes no
// scratch words). Returns cudaGetLastError() after the launch.
extern "C" {

int hpt_prev_trace_coherent(const void* nodes4, const void* leaf_rows,
                            const void* o, const void* d, const void* tmin,
                            const void* tmax, const void* active, int64_t n,
                            int any_hit, void* t, void* prim, void* u, void* v,
                            void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + kBlockPacket - 1) / kBlockPacket);
  cudaStream_t s = (cudaStream_t)stream;
  auto args = [&](auto kernel) {
    kernel<<<blocks, kBlockPacket, 0, s>>>(
        (const float4*)nodes4, (const float*)leaf_rows, (const float*)o,
        (const float*)d, (const float*)tmin, (const float*)tmax,
        (const uint8_t*)active, n, (float*)t, (int32_t*)prim, (float*)u,
        (float*)v);
  };
  if (any_hit) args(trace_coherent_kernel<true>);
  else args(trace_coherent_kernel<false>);
  return (int)cudaGetLastError();
}

// Registers per thread, local and static shared memory bytes and resident
// blocks per SM, for the records.
int hpt_prev_trace_coherent_info(int any_hit, int* regs, int* local_bytes,
                                 int* shared_bytes, int* blocks_per_sm) {
  auto info = [&](auto kernel) {
    return kernel_info(kernel, kBlockPacket, regs, local_bytes, shared_bytes,
                       blocks_per_sm);
  };
  return any_hit ? info(trace_coherent_kernel<true>)
                 : info(trace_coherent_kernel<false>);
}

}  // extern "C"
