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
// Rounding: the file is built with -fmad=false, so the triangle test rounds
// every product and sum exactly as the plain PyTorch version does, and the
// two agree bit for bit where they visit the same triangles.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStack = 64;       // traversal stack entries (host checks depth)
constexpr int kLeafTris = 12;    // triangle slots of a leaf row
constexpr int kLeafFloats = 128;
constexpr int kPacket = 128;     // rays per packet = one 16x8 screen tile
constexpr float kTriEps = 1e-9f;
constexpr int kMegaRowFloats = 128;  // a meganode row (accel/build.py nodes)
constexpr int kMegaLeafTris = 4;     // triangle slots per child of a row
constexpr int kMegaStack = 64;       // far-sibling entries (host checks depth2)

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin;
};

__device__ __forceinline__ float inverse_component(float c) {
  // 1/c, or -1e12 for a tiny negative c and +1e12 for a tiny positive c or
  // ±0 (ops/traverse.py:inverse_direction; the JAX package's guard gives 0
  // for a tiny negative c, which collapses that axis's slab)
  if (fabsf(c) > 1e-12f) return 1.0f / c;
  return c < 0.0f ? -1e12f : 1e12f;
}

__device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                        const float* tmin, int64_t i) {
  Ray r;
  r.ox = o[3 * i + 0];
  r.oy = o[3 * i + 1];
  r.oz = o[3 * i + 2];
  r.dx = d[3 * i + 0];
  r.dy = d[3 * i + 1];
  r.dz = d[3 * i + 2];
  r.ix = inverse_component(r.dx);
  r.iy = inverse_component(r.dy);
  r.iz = inverse_component(r.dz);
  r.tmin = tmin[i];
  return r;
}

// Slab test of one child box b[0..5] = min xyz, max xyz. An empty slot has a
// NaN box; fminf/fmaxf drop NaN, so it is tested explicitly.
__device__ __forceinline__ bool slab(const float* b, const Ray& r,
                                     float best_t, float& t_entry) {
  if (isnan(b[0])) return false;
  const float tx0 = (b[0] - r.ox) * r.ix, tx1 = (b[3] - r.ox) * r.ix;
  const float ty0 = (b[1] - r.oy) * r.iy, ty1 = (b[4] - r.oy) * r.iy;
  const float tz0 = (b[2] - r.oz) * r.iz, tz1 = (b[5] - r.oz) * r.iz;
  const float te = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                         fmaxf(fminf(tz0, tz1), 0.0f));
  const float tx = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                         fminf(fmaxf(tz0, tz1), best_t));
  t_entry = te;
  return te <= tx;
}

// Möller-Trumbore in ops/intersect.py:triangle_test's operation order.
// A hit must beat the best so far; an equal-t tie goes to the smaller prim
// id, so the order of the walk does not pick the winner among triangles it
// tests (a box culled at exactly the tied t is not tested). prim_f points at
// the triangle's prim id (int32 bits), read only for a candidate hit.
__device__ __forceinline__ bool triangle(const float* tri, const float* prim_f,
                                         const Ray& r, float best_t,
                                         int best_prim, float& t_out,
                                         float& u_out, float& v_out,
                                         int& prim_out) {
  const float v0x = tri[0], v0y = tri[1], v0z = tri[2];
  const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
  const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok_det = fabsf(det) > kTriEps;
  const float inv_det = ok_det ? 1.0f / det : 0.0f;
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  if (!(ok_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > r.tmin)) {
    return false;
  }
  const int prim = __float_as_int(*prim_f);
  if (!(t < best_t || (t == best_t && best_prim >= 0 && prim < best_prim))) {
    return false;
  }
  t_out = t;
  u_out = u;
  v_out = v;
  prim_out = prim;
  return true;
}

__device__ __forceinline__ void load_node(const float4* __restrict__ nodes4,
                                          int ref, float* box, int* refs) {
  const float4* nd = nodes4 + (int64_t)ref * 8;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float4 q = __ldg(nd + j);
    box[4 * j + 0] = q.x;
    box[4 * j + 1] = q.y;
    box[4 * j + 2] = q.z;
    box[4 * j + 3] = q.w;
  }
  const float4 q = __ldg(nd + 6);
  refs[0] = __float_as_int(q.x);
  refs[1] = __float_as_int(q.y);
  refs[2] = __float_as_int(q.z);
  refs[3] = __float_as_int(q.w);
}

__device__ __forceinline__ void swap_if(float& ka, int& ra, float& kb, int& rb) {
  if (ka > kb) {
    const float k = ka; ka = kb; kb = k;
    const int r = ra; ra = rb; rb = r;
  }
}

__device__ __forceinline__ void write_hit(int64_t i, bool any_hit, int prim,
                                          float t, float u, float v,
                                          float* t_out, int32_t* prim_out,
                                          float* u_out, float* v_out) {
  const bool hit = prim >= 0;
  t_out[i] = hit ? t : INFINITY;
  prim_out[i] = prim;
  u_out[i] = (hit && !any_hit) ? u : 0.0f;
  v_out[i] = (hit && !any_hit) ? v : 0.0f;
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
