// Variant (b) of the sweep behind trace_stream8 (the port of the TPU kernel
// _kernel_stream8l, hiprt_pt_tpu/ops/pallas_traverse.py:724): the per-ray
// walk of hiprt_pt_tpu_torch/csrc/traverse8.cu (walk8, with the refill of
// half a warp) with rows [0, R) of nodes8l, whole BFS levels chosen on the
// host, copied into each block's shared memory once (cp.async) and read
// there. It lost to the same walk without it (previous_kernels/sweep_k4.py,
// PERF.md): the top levels are L1 hits already. It is not part of the
// package: sweep_k4.py builds it to time it, with HPT_K4_THREADS and
// HPT_K4_BLOCKS (the block size and the resident blocks an SM that bound
// its registers); a block may hold up to 227 KB of top rows. With
// HPT_K4_PROFILE the kernel adds its counts to scratch[1 + slot], summed
// over lanes: 0 node visits read from shared memory, 1 node visits read
// from device memory, 2 leaf visits, 3 rays drawn, 4 refills of a warp, 5
// turns of a warp.
//
// It reads nodes8l + leaf_rows8 (hiprt_pt_tpu_torch/accel/build.py) and
// follows the HitRecord contract of ops/traverse.py: see traverse8.cu.

#include "hopper_async.cuh"
#include "traverse_common.cuh"

#ifndef HPT_K4_THREADS
#define HPT_K4_THREADS 768
#endif
#ifndef HPT_K4_BLOCKS
#define HPT_K4_BLOCKS 1
#endif

namespace {

using namespace hpt;

constexpr int kNodeFloats = 64;   // a nodes8l row
constexpr int kNodeBytes = kNodeFloats * 4;
constexpr int kStack8 = 96;       // BVH8 walk stack (host checks depth8)
constexpr int kRefill = 16;
constexpr int kThreads = HPT_K4_THREADS;
constexpr int kBlocksPerSM = HPT_K4_BLOCKS;
// the most rows a block holds: the 227 KB of shared memory a block may take
constexpr int kTopRowsMax = 232448 / kNodeBytes;

// traverse_common.cuh's resident_blocks, for blocks with `smem` bytes of
// dynamic shared memory each.
template <typename K>
int resident_blocks_smem(K kernel, int threads, size_t smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  return (int)e;
}

__device__ __forceinline__ int child_ref(int c, int base_int, int n_int,
                                         int base_leaf) {
  return c < n_int ? base_int + c : -(base_leaf + (c - n_int)) - 1;
}

__device__ __forceinline__ void cx(unsigned (&k)[8], int a, int b) {
  const unsigned lo = min(k[a], k[b]), hi = max(k[a], k[b]);
  k[a] = lo;
  k[b] = hi;
}

// traverse8.cu's walk8 with the refill of half a warp; a node visit below
// row top_rows reads s_top.
template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
trace_stream8_toptree_kernel(const float4* __restrict__ nodes8l,
                             const float4* __restrict__ leaf_rows8, int top_rows,
                             const float* __restrict__ o,
                             const float* __restrict__ d,
                             const float* __restrict__ tmin,
                             const float* __restrict__ tmax,
                             const uint8_t* __restrict__ active, int64_t n,
                             unsigned long long* __restrict__ next_ray,
                             float* __restrict__ t_out,
                             int32_t* __restrict__ prim_out,
                             float* __restrict__ u_out,
                             float* __restrict__ v_out) {
  extern __shared__ float4 s_top[];
  for (int j = threadIdx.x; j < top_rows * (kNodeFloats / 4); j += blockDim.x) {
    cp_async<16>(s_top + j, nodes8l + j);
  }
  cp_async_wait_all();
  __syncthreads();

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
  unsigned long long prof[6] = {};
#define K4_PROF(slot, value) prof[slot] += (unsigned long long)(value)
#else
#define K4_PROF(slot, value)
#endif

  auto finish = [&]() {
    write_hit(i, kAnyHit, best_prim, best_t, best_u, best_v, t_out, prim_out,
              u_out, v_out);
    i = -1;
    cur = kNone;
    sp = 0;
  };
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
    K4_PROF(5, lane == 0);
    while (true) {
      const bool need = i < 0;
      const unsigned want = __ballot_sync(full, need);
      if (want == 0 || (__popc(want) < kRefill &&
                        __any_sync(full, i >= 0 && i < n))) {
        break;
      }
      K4_PROF(4, lane == 0);
      const int leader = __ffs(want) - 1;
      unsigned long long base = 0;
      if (lane == leader) base = atomicAdd(next_ray, (unsigned long long)__popc(want));
      base = __shfl_sync(full, base, leader);
      if (need) {
        const int64_t id = (int64_t)base + __popc(want & ((1u << lane) - 1u));
        if (id >= n) {
          i = n;
        } else {
          K4_PROF(3, 1);
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

    while (cur >= 0) {
      float box[48];
      float4 w;
      if (cur < top_rows) {
        K4_PROF(0, 1);
        const float4* nd = s_top + cur * (kNodeFloats / 4);
#pragma unroll
        for (int j = 0; j < 12; ++j) {
          const float4 q = nd[j];
          box[4 * j + 0] = q.x;
          box[4 * j + 1] = q.y;
          box[4 * j + 2] = q.z;
          box[4 * j + 3] = q.w;
        }
        w = nd[12];
      } else {
        K4_PROF(1, 1);
        const float4* nd = nodes8l + (int64_t)cur * (kNodeFloats / 4);
#pragma unroll
        for (int j = 0; j < 12; ++j) {
          const float4 q = __ldg(nd + j);
          box[4 * j + 0] = q.x;
          box[4 * j + 1] = q.y;
          box[4 * j + 2] = q.z;
          box[4 * j + 3] = q.w;
        }
        w = __ldg(nd + 12);
      }
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

    if (cur != kNone) {
      K4_PROF(2, 1);
      const int row = -(cur + 1);
      const float4* lr = leaf_rows8 + (int64_t)row * (kLeafFloats / 4);
      const float* prims = reinterpret_cast<const float*>(lr) + 108;
      const float4 meta = __ldg(lr + 30);   // floats 120..123: flag, count
      const int cnt = (int)meta.y;
      bool done = false;
#pragma unroll
      for (int grp = 0; grp < kLeafTris / 4; ++grp) {
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
  for (int s = 0; s < 6; ++s) atomicAdd(next_ray + 1 + s, prof[s]);
#endif
#undef K4_PROF
}

}  // namespace

// Plain C interface for ctypes: trace_stream8's arguments with top_rows
// (the rows of nodes8l each block holds, at most kTopRowsMax and at most
// the table's rows) after any_hit. Returns the first CUDA error of the
// launch, or 0; a top_rows past the budget is refused
// (cudaErrorInvalidValue) before anything is launched.
extern "C" {

int hpt_prev_trace_stream8_toptree(const void* nodes8l, const void* leaf_rows8,
                                   const void* o, const void* d,
                                   const void* tmin, const void* tmax,
                                   const void* active, int64_t n, int any_hit,
                                   int top_rows, void* counter, void* t,
                                   void* prim, void* u, void* v, void* stream) {
  if (n <= 0) return 0;
  if (top_rows < 0 || top_rows > kTopRowsMax) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)top_rows * kNodeBytes;
  auto launch = [&](auto kernel) {
    // above 48 KB a launch is refused unless the kernel's limit is raised
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    int blocks = 0;
    const int err = resident_blocks_smem(kernel, kThreads, smem, &blocks);
    if (err != 0) return err;
    const int64_t need = (n + kThreads - 1) / kThreads;
    if ((int64_t)blocks > need) blocks = (int)need;
    kernel<<<blocks, kThreads, smem, s>>>(
        (const float4*)nodes8l, (const float4*)leaf_rows8, top_rows,
        (const float*)o, (const float*)d, (const float*)tmin,
        (const float*)tmax, (const uint8_t*)active, n,
        (unsigned long long*)counter, (float*)t, (int32_t*)prim, (float*)u,
        (float*)v);
    return (int)cudaGetLastError();
  };
  return any_hit ? launch(trace_stream8_toptree_kernel<true>)
                 : launch(trace_stream8_toptree_kernel<false>);
}

// Registers, local memory, shared memory (static + the full budget of top
// rows) and resident blocks per SM at that budget.
int hpt_prev_trace_stream8_toptree_info(int any_hit, int* regs, int* local_bytes,
                                        int* shared_bytes, int* blocks_per_sm) {
  const size_t smem = (size_t)kTopRowsMax * kNodeBytes;
  auto info = [&](auto kernel) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int err = kernel_info(kernel, kThreads, regs, local_bytes,
                                shared_bytes, blocks_per_sm);
    if (err != 0) return err;
    *shared_bytes += (int)smem;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, kThreads, smem);
  };
  return any_hit ? info(trace_stream8_toptree_kernel<true>)
                 : info(trace_stream8_toptree_kernel<false>);
}

}  // extern "C"
