// The one-step-per-turn version of trace_incoherent (the port of the TPU
// kernel _kernel_lane8s, hiprt_pt_tpu/ops/pallas_traverse.py:1866) that the
// while-while walk of hiprt_pt_tpu_torch/csrc/traverse.cu replaced: one
// launch thread per ray, one node or leaf visit per turn of its loop, every
// hit child pushed on the stack. It is not part of the package:
// chip_smoke.py builds it only to time the two side by side, on the same
// rays in the same run.
//
// It reads nodes4 + leaf_rows (hiprt_pt_tpu_torch/accel/build.py) and
// follows the HitRecord contract of ops/traverse.py: see traverse.cu.

#include "traverse_common.cuh"

namespace {

using namespace hpt;

// Ascending compare-exchange of a (key, ref) pair.
__device__ __forceinline__ void swap_if(float& ka, int& ra, float& kb, int& rb) {
  if (ka > kb) {
    const float k = ka; ka = kb; kb = k;
    const int r = ra; ra = rb; rb = r;
  }
}

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

}  // namespace

// Plain C interface for ctypes, as traverse.cu's (this version takes no
// scratch counter). Returns cudaGetLastError() after the launch.
extern "C" {

int hpt_prev_trace_incoherent(const void* nodes4, const void* leaf_rows,
                              const void* o, const void* d, const void* tmin,
                              const void* tmax, const void* active, int64_t n,
                              int any_hit, void* t, void* prim, void* u,
                              void* v, void* stream) {
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

// Registers per thread, local memory bytes per thread (the stack and any
// spills), static shared memory bytes and
// resident blocks per SM, for the records.
int hpt_prev_trace_incoherent_info(int any_hit, int* regs, int* local_bytes,
                                   int* shared_bytes, int* blocks_per_sm) {
  auto info = [&](auto kernel) {
    return kernel_info(kernel, 128, regs, local_bytes, shared_bytes,
                       blocks_per_sm);
  };
  return any_hit ? info(trace_incoherent_kernel<true>)
                 : info(trace_incoherent_kernel<false>);
}

}  // extern "C"
