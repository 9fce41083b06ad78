// BVH closest-hit / any-hit traversal kernels for Hopper (sm_90a).
//
// trace_incoherent and trace_coherent read the port's BVH4 tables
// (accel/build.py): nodes4 rows of 32 floats (four child boxes, four int32
// refs stored bit for bit; an empty slot has a NaN box and ref 0) and leaf
// rows of 128 floats (up to 12 exact f32 triangles [v0, e1, e2], their prim
// ids as int32 bits at 108..119, the triangle count at 121). A negative ref
// r is leaf row -(r+1); row 0 of the leaf table is a dummy. They follow the
// HitRecord contract of ops/traverse.py: a miss and an inactive ray give
// prim = -1, t = inf; any-hit returns occlusion in prim >= 0 with u = v = 0.
//
// trace_incoherent replaces the TPU kernel _kernel_lane8s
// (hiprt_pt_tpu/ops/pallas_traverse.py:1866, K1), and trace_coherent
// replaces _kernel_compact4 (hiprt_pt_tpu/ops/pallas_traverse.py:381, K2).
// A third kernel, trace_meganode, reads the meganode BVH2 table instead (its
// layout and design are at the kernel) and replaces _kernel
// (hiprt_pt_tpu/ops/pallas_traverse.py:55, K3).
//
// What bounds them on this card: the latency of dependent node and leaf
// loads, and the lanes of a warp that sit idle while the others work. Each
// step of a walk needs the previous step's node before it knows what to load
// next, and there is little arithmetic per byte. The tables take about 17 MB
// on the 259k-triangle stress interior (nodes4 1.9 MB, leaf_rows 15 MB) and
// under 8 MB on a meganode scene, so after the first touches they sit in the
// 50 MB L2; each load then costs an L2 round trip, not DRAM bandwidth.
//
// What the designs do about that. trace_incoherent and trace_meganode walk
// one ray a thread in persistent threads (as many blocks as fit the card,
// rays drawn from a global counter, one atomic a warp), as a while-while
// walk: the warp descends together, then tests triangles together; the
// nearer child stays in a register, the others wait on a private stack with
// their entry distances and are dropped unloaded once the ray's best t has
// passed them; triangles come in 16-byte loads. trace_coherent walks one
// packet of 128 coherent rays per block, so that a node or leaf is fetched
// once for 128 rays.
//
// The shared helpers (ray record, slab and triangle tests, the tie rule, the
// warp's ray draw, the four-triangle test) are in traverse_common.cuh.

#include "traverse_common.cuh"

namespace {

using namespace hpt;

constexpr int kWalkThreads = 128;
// at least six blocks an SM holds ptxas to 80 registers a thread, which both
// per-ray kernels fit without a spill (at eight, 64 registers, they spill)
constexpr int kWalkBlocksPerSM = 6;

// The lanes of `want` have no ray. They draw new ones once kRefillLanes of
// them wait, or when no lane of the warp is walking a ray (`walking` is the
// lane's own state): rays drawn together are neighbours in the wavefront,
// so a warp of coherent rays stays coherent, and a warp of scattered rays
// does not run the refill for every single ray that ends. Half a warp
// measured best: coherent rays gain, scattered rays lose nothing (a whole
// warp leaves too many lanes idle on scattered rays).
constexpr int kRefillLanes = 16;
__device__ __forceinline__ bool refill_now(unsigned want, bool walking) {
  if (want == 0) return false;
  return __popc(want) >= kRefillLanes || !__any_sync(0xffffffffu, walking);
}

// Ascending compare-exchange of two sort keys.
__device__ __forceinline__ void cx(unsigned& a, unsigned& b) {
  const unsigned lo = min(a, b), hi = max(a, b);
  a = lo;
  b = hi;
}

// Element `slot` of four refs held in registers (no indexed local array).
__device__ __forceinline__ int pick(const int (&refs)[4], unsigned slot) {
  const int lo = (slot & 1u) ? refs[1] : refs[0];
  const int hi = (slot & 1u) ? refs[3] : refs[2];
  return (slot & 2u) ? hi : lo;
}

// K1 port. One thread per ray, persistent: every thread of the card's
// resident blocks walks one ray at a time over nodes4 + leaf_rows with its
// own stack (local memory) and, when its ray is done, stores the hit record
// at the ray's index and takes the next ray id from a global counter (one
// atomic per warp for the lanes that need a ray). A wavefront of any size is
// one launch: the grid does not grow with it.
//
// The loop is a "while-while" walk, the one trace_lane8log (traverse8.cu)
// runs over the BVH8. A turn has three parts that the warp runs together:
// the refill (once half the warp's lanes wait for a ray, or none walks one,
// the waiting lanes take new rays until every lane holds a live ray or the
// pool is empty; an inactive ray is answered at once); the
// descent (a lane goes down through nodes until it holds a leaf or its ray
// ends); the leaf (every lane that holds one tests it). So the node body and
// the leaf body each run with the lanes that need it, not both on every
// step.
//   Node: seven 16-byte loads, four slab tests, and one sort key per child:
//   the entry distance's bits (>= 0, so they order as unsigned) with the
//   child's slot in the low two bits, all ones for a miss. A 5-comparator
//   network of min/max sorts the four keys. The nearest hit child stays in a
//   register as the next visit; the others go on the stack far to near, each
//   with its entry distance (closest hit only), so that a pop skips an entry
//   the ray's best t has since passed without loading it.
//   Leaf: four triangles are 36 floats, nine 16-byte loads; the first four
//   and the row's count are loaded together, the next groups only where the
//   count asks for them, all of a group's loads before its tests.
template <bool kAnyHit>
__global__ void __launch_bounds__(kWalkThreads, kWalkBlocksPerSM)
trace_incoherent_kernel(const float4* __restrict__ nodes4,
                        const float4* __restrict__ leaf_rows,
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
  int stack_ref[kStack];
  float stack_t[kAnyHit ? 1 : kStack];
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
    // refill: the lanes without a ray take consecutive ids (refill_now)
    while (true) {
      const bool need = i < 0;
      const unsigned want = __ballot_sync(full, need);
      if (!refill_now(want, i >= 0 && i < n)) break;
      const int64_t id = warp_take_rays(want, lane, next_ray);
      if (need) {
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
      float box[24];
      int refs[4];
      load_node(nodes4, cur, box, refs);
      unsigned key[4];
      int n_hit = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float te;
        const bool h = slab(box + 6 * c, r, best_t, te);
        key[c] = h ? ((__float_as_uint(te) & ~3u) | (unsigned)c) : kMissKey;
        n_hit += h;
      }
      if (n_hit == 0) {
        pop();
        continue;
      }
      cx(key[0], key[1]); cx(key[2], key[3]); cx(key[0], key[2]);
      cx(key[1], key[3]); cx(key[1], key[2]);
#pragma unroll
      for (int c = 3; c >= 1; --c) {
        if (c < n_hit) {
          stack_ref[sp] = pick(refs, key[c] & 3u);
          if (!kAnyHit) stack_t[kAnyHit ? 0 : sp] = __uint_as_float(key[c] & ~3u);
          ++sp;
        }
      }
      cur = pick(refs, key[0] & 3u);
    }
    __syncwarp();

    // the leaf
    if (cur != kNone) {
      const float4* lr = leaf_rows + (int64_t)(-(cur + 1)) * (kLeafFloats / 4);
      const float* prims = reinterpret_cast<const float*>(lr) + 108;
      const float4 meta = __ldg(lr + 30);   // floats 120..123: flag, count
      const int cnt = (int)meta.y;
      bool done = false;
#pragma unroll
      for (int grp = 0; grp < kLeafTris / 4; ++grp) {
        // the first group is loaded beside the count, not behind it
        if (grp == 0 || (4 * grp < cnt && !done)) {
          test_four<kAnyHit>(lr + 9 * grp, prims + 4 * grp, cnt - 4 * grp, r,
                             best_t, best_u, best_v, best_prim, done);
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

// K3 port. One thread per ray, persistent, over the meganode BVH2
// (accel/build.py `nodes`): rows of 128 floats, [0:12] two child boxes,
// [12:16] c0_ref, c0_count, c1_ref, c1_count (int32 bits; count 0 = internal
// child whose ref is its row, count > 0 = a leaf of that many triangles in
// this row, count < 0 = empty slot with a zero box), [16:52] and [52:88] up
// to four triangles per child, [88:96] their prim ids. An empty slot is
// neither descended nor intersected. The walk runs until the ray's stack is
// empty; the host checks that depth2 fits the stack.
//
// It is the while-while walk of trace_incoherent on this row: refill from
// the global ray counter; descent; leaf. A visit of the descent loads only
// floats 0..15 of the row (four 16-byte loads: both boxes, refs and counts)
// and slab-tests the two children. Of the internal children it hits, the
// nearer stays in a register as the next visit and the farther goes on the
// stack with its entry distance, to be dropped at the pop once the ray's
// best t has passed it (closest hit only). A visit that hits a leaf child
// ends the lane's descent: in the leaf part, with the warp's other lanes,
// it loads that child's triangles (nine 16-byte loads, 36 floats at
// 16 + 36c) and tests them, the nearer child's first, so that the farther
// child's are not loaded when the hit already lies before its box.
//
// What bounds it: the latency of one dependent 64-byte row read per step
// out of the L2 (the whole table, <= 8 MB, stays there).
template <bool kAnyHit>
__global__ void __launch_bounds__(kWalkThreads, kWalkBlocksPerSM)
trace_meganode_kernel(const float4* __restrict__ nodes,
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
  int cur = kNone;       // the row to visit, or kNone
  float cur_t = 0.0f;    // its entry distance (closest hit only)
  int leaf_row = -1;     // the row whose hit leaf children wait for the leaf part
  int leaf_cnt0 = 0, leaf_cnt1 = 0;      // their triangle counts, 0 = not hit
  float leaf_t0 = 0.0f, leaf_t1 = 0.0f;  // their entry distances
  int stack_ref[kMegaStack];
  float stack_t[kAnyHit ? 1 : kMegaStack];
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
        if (!kAnyHit) cur_t = stack_t[kAnyHit ? 0 : sp];
        return;
      }
    }
    finish();
  };

  while (true) {
    // refill: the lanes without a ray take consecutive ids (refill_now)
    while (true) {
      const bool need = i < 0;
      const unsigned want = __ballot_sync(full, need);
      if (!refill_now(want, i >= 0 && i < n)) break;
      const int64_t id = warp_take_rays(want, lane, next_ray);
      if (need) {
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
            cur_t = 0.0f;
          } else {
            finish();
          }
        }
      }
    }
    if (!__any_sync(full, i < n)) break;

    // the descent: down through rows until a leaf child is hit or the ray ends
    while (cur >= 0) {
      const float4* row = nodes + (int64_t)cur * (kMegaRowFloats / 4);
      const float4 q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2);
      const float4 m = __ldg(row + 3);
      const float b0[6] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y};
      const float b1[6] = {q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
      const int ref0 = __float_as_int(m.x), cnt0 = __float_as_int(m.y);
      const int ref1 = __float_as_int(m.z), cnt1 = __float_as_int(m.w);
      float te0 = 0.0f, te1 = 0.0f;
      const bool h0 = cnt0 >= 0 && slab(b0, r, best_t, te0);
      const bool h1 = cnt1 >= 0 && slab(b1, r, best_t, te1);
      const int here = cur;
      const bool in0 = h0 && cnt0 == 0, in1 = h1 && cnt1 == 0;
      if (in0 && in1) {
        const bool near0 = te0 <= te1;   // child 0 on a tie
        stack_ref[sp] = near0 ? ref1 : ref0;
        if (!kAnyHit) stack_t[kAnyHit ? 0 : sp] = near0 ? te1 : te0;
        ++sp;
        cur = near0 ? ref0 : ref1;
        cur_t = near0 ? te0 : te1;
      } else if (in0 || in1) {
        cur = in0 ? ref0 : ref1;
        cur_t = in0 ? te0 : te1;
      } else {
        cur = kNone;
      }
      leaf_cnt0 = (h0 && cnt0 > 0) ? cnt0 : 0;
      leaf_cnt1 = (h1 && cnt1 > 0) ? cnt1 : 0;
      if ((leaf_cnt0 | leaf_cnt1) != 0) {
        leaf_row = here;
        leaf_t0 = te0;
        leaf_t1 = te1;
        break;
      }
      if (cur == kNone) pop();
    }
    __syncwarp();

    // the leaf: the hit leaf children of leaf_row, the nearer first
    if (leaf_row >= 0) {
      const float4* row = nodes + (int64_t)leaf_row * (kMegaRowFloats / 4);
      const float* prims = reinterpret_cast<const float*>(row) + 88;
      const bool first1 = leaf_cnt0 == 0 || (leaf_cnt1 > 0 && leaf_t1 < leaf_t0);
      bool done = false;
#pragma unroll 1
      for (int s = 0; s < 2; ++s) {
        const int c = ((s == 0) == first1) ? 1 : 0;
        const int cnt = c ? leaf_cnt1 : leaf_cnt0;
        const float te = c ? leaf_t1 : leaf_t0;
        if (cnt > 0 && !done && (kAnyHit || te <= best_t)) {
          test_four<kAnyHit>(row + 4 + 9 * c, prims + kMegaLeafTris * c, cnt, r,
                             best_t, best_u, best_v, best_prim, done);
        }
      }
      leaf_row = -1;
      if (done) {
        finish();
      } else {
        // the internal child chosen before these tests may lie behind the hit
        if (!kAnyHit && cur >= 0 && cur_t > best_t) cur = kNone;
        if (cur == kNone) pop();
      }
    }
  }
}

// One launch of a persistent per-ray kernel: as many blocks as are resident
// on the card, or as the rays need.
template <typename K, typename... Args>
int launch_walk(K kernel, int64_t n, cudaStream_t s, Args... args) {
  int blocks = 0;
  const int err = resident_blocks(kernel, kWalkThreads, &blocks);
  if (err != 0) return err;
  const int64_t need = (n + kWalkThreads - 1) / kWalkThreads;
  if ((int64_t)blocks > need) blocks = (int)need;
  kernel<<<blocks, kWalkThreads, 0, s>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. Every pointer is a device pointer; `stream`
// is a cudaStream_t; `counter` is a zeroed uint64 device scratch word that a
// persistent kernel draws its rays from. Returns the first CUDA error of
// the launch, or 0. The *_info functions give a kernel's registers per
// thread, local memory bytes per thread (the stack and any spills) and
// resident blocks per SM, for the records.
extern "C" {

int hpt_trace_meganode(const void* nodes, const void* o, const void* d,
                       const void* tmin, const void* tmax, const void* active,
                       int64_t n, int any_hit, void* counter, void* t,
                       void* prim, void* u, void* v, void* stream) {
  if (n <= 0) return 0;
  auto launch = [&](auto kernel) {
    return launch_walk(
        kernel, n, (cudaStream_t)stream, (const float4*)nodes, (const float*)o,
        (const float*)d, (const float*)tmin, (const float*)tmax,
        (const uint8_t*)active, n, (unsigned long long*)counter, (float*)t,
        (int32_t*)prim, (float*)u, (float*)v);
  };
  return any_hit ? launch(trace_meganode_kernel<true>)
                 : launch(trace_meganode_kernel<false>);
}

int hpt_trace_meganode_info(int any_hit, int* regs, int* local_bytes,
                            int* blocks_per_sm) {
  auto info = [&](auto kernel) {
    return kernel_info(kernel, kWalkThreads, regs, local_bytes, blocks_per_sm);
  };
  return any_hit ? info(trace_meganode_kernel<true>)
                 : info(trace_meganode_kernel<false>);
}

int hpt_trace_incoherent(const void* nodes4, const void* leaf_rows,
                         const void* o, const void* d, const void* tmin,
                         const void* tmax, const void* active, int64_t n,
                         int any_hit, void* counter, void* t, void* prim,
                         void* u, void* v, void* stream) {
  if (n <= 0) return 0;
  auto launch = [&](auto kernel) {
    return launch_walk(
        kernel, n, (cudaStream_t)stream, (const float4*)nodes4,
        (const float4*)leaf_rows, (const float*)o, (const float*)d,
        (const float*)tmin, (const float*)tmax, (const uint8_t*)active, n,
        (unsigned long long*)counter, (float*)t, (int32_t*)prim, (float*)u,
        (float*)v);
  };
  return any_hit ? launch(trace_incoherent_kernel<true>)
                 : launch(trace_incoherent_kernel<false>);
}

int hpt_trace_incoherent_info(int any_hit, int* regs, int* local_bytes,
                              int* blocks_per_sm) {
  auto info = [&](auto kernel) {
    return kernel_info(kernel, kWalkThreads, regs, local_bytes, blocks_per_sm);
  };
  return any_hit ? info(trace_incoherent_kernel<true>)
                 : info(trace_incoherent_kernel<false>);
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
