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
// passed them; triangles come in 16-byte loads. trace_coherent walks a
// packet of 32 coherent rays per warp (a 16x2 strip of a screen tile) in
// persistent warps, so that a node or leaf is fetched once for the warp: one
// stack a warp, every decision a warp vote, children near to far by the
// warp's least entry distance, entries dropped at the pop once every lane
// has passed them, and a way out into the per-ray walk for a packet whose
// rays diverge (its design is at the kernel).
//
// The shared helpers (ray record, slab and triangle tests, the tie rule, the
// warp's ray draw, the four-triangle test) are in traverse_common.cuh; the
// node visit, the pop and the leaf visit of a per-ray walk over the BVH4,
// which trace_incoherent and trace_coherent's way out both run, are below.

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

// Element `slot` of four ballots held in registers.
__device__ __forceinline__ unsigned pick(const unsigned (&m)[4], unsigned slot) {
  const unsigned lo = (slot & 1u) ? m[1] : m[0];
  const unsigned hi = (slot & 1u) ? m[3] : m[2];
  return (slot & 2u) ? hi : lo;
}

// The three steps of a per-ray walk over nodes4 + leaf_rows with a private
// stack (stack_t is one entry long in an any-hit walk, which culls nothing).
//
// The node visit: seven 16-byte loads, four slab tests, and one sort key per
// child: the entry distance's bits (>= 0, so they order as unsigned) with
// the child's slot in the low two bits, all ones for a miss. A 5-comparator
// network of min/max sorts the four keys. Returns the nearest hit child, or
// kNone; the other hit children go on the stack far to near, each with its
// entry distance (closest hit only).
template <bool kAnyHit>
__device__ __forceinline__ int ray_visit_node(const float4* __restrict__ nodes4,
                                              int node, const Ray& r,
                                              float best_t, int* stack_ref,
                                              float* stack_t, int& sp) {
  float box[24];
  int refs[4];
  load_node(nodes4, node, box, refs);
  unsigned key[4];
  int n_hit = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float te;
    const bool h = slab(box + 6 * c, r, best_t, te);
    key[c] = h ? ((__float_as_uint(te) & ~3u) | (unsigned)c) : kMissKey;
    n_hit += h;
  }
  if (n_hit == 0) return kNone;
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
  return pick(refs, key[0] & 3u);
}

// The pop: the next visit from the stack, skipping unloaded every entry the
// ray's best t has passed (an entry at exactly best t stays, for the tie
// rule), or kNone when the stack is empty.
template <bool kAnyHit>
__device__ __forceinline__ int ray_pop(const int* stack_ref, const float* stack_t,
                                       int& sp, float best_t) {
  while (sp > 0) {
    --sp;
    if (kAnyHit || stack_t[kAnyHit ? 0 : sp] <= best_t) return stack_ref[sp];
  }
  return kNone;
}

// The leaf visit: four triangles are 36 floats, nine 16-byte loads; the
// first four and the row's count are loaded together, the next groups only
// where the count asks for them, all of a group's loads before its tests.
// Returns whether the ray is done (an any-hit walk that found its hit).
template <bool kAnyHit>
__device__ __forceinline__ bool ray_visit_leaf(const float4* __restrict__ leaf_rows,
                                               int leaf, const Ray& r,
                                               float& best_t, float& best_u,
                                               float& best_v, int& best_prim) {
  const float4* lr = leaf_rows + (int64_t)(-(leaf + 1)) * (kLeafFloats / 4);
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
  return done;
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
// step. The nearest hit child of a node stays in a register as the next
// visit; the others wait on the stack with their entry distances, so that a
// pop skips an entry the ray's best t has since passed without loading it
// (ray_visit_node, ray_pop, ray_visit_leaf above).
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
    cur = ray_pop<kAnyHit>(stack_ref, stack_t, sp, best_t);
    if (cur == kNone) finish();
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
      cur = ray_visit_node<kAnyHit>(nodes4, cur, r, best_t, stack_ref, stack_t,
                                    sp);
      if (cur == kNone) pop();
    }
    __syncwarp();

    // the leaf
    if (cur != kNone) {
      if (ray_visit_leaf<kAnyHit>(leaf_rows, cur, r, best_t, best_u, best_v,
                                  best_prim)) {
        finish();
      } else {
        pop();
      }
    }
  }
}

// K2 port. A warp is a packet: 32 consecutive rays of the tile-major order,
// a 16x2 strip of one 16x8 screen tile (ops/pixel_order.py). Warps are
// persistent (as many blocks as fit the card) and draw whole aligned packets
// from a global counter, one atomic a packet, so a warp always holds one
// strip and a wavefront of any size is one launch.
//
// What coherent rays share is the fetch: every lane reads the node or leaf
// in hand at the same address, so one transaction serves the warp. The walk
// has no block-wide barrier; the warp's stack lives in shared memory, one
// copy a warp, with a uniform depth in a register, and every decision is a
// warp vote. An entry of the stack is a ref, the ballot of the lanes whose
// own slab test (against their own best t) hit its box, and the least entry
// distance over those lanes. A lane takes part in a visit only if its bit is
// set, so it tests the boxes and triangles its own walk would test.
//   Node: each lane slab-tests the four children; per child one ballot and
//   one __reduce_min_sync on K1's sort key (entry-distance bits, slot in the
//   low two) give the lanes that hit and the packet's least entry distance.
//   The keys are the same in every lane, so no lane sorts: lane c < 4 owns
//   child c, ranks its key among the four and stores its own entry. The
//   nearest child stays in a register, the others go on the stack far to
//   near: at most three a level, so the depth the host checks for the
//   per-ray walk holds here.
//   Pop (closest hit): an entry is dropped unloaded when none of its lanes
//   still has a best t at or beyond its distance (<=, for the tie rule). In
//   an any-hit walk a lane that has its hit leaves the votes, and the packet
//   ends when no lane searches.
//   Leaf: the lanes of the entry run K1's leaf visit (16-byte loads, the
//   first four triangles beside the count) at the same address. The row is
//   not staged in shared memory: the loads already cost the warp one
//   transaction each, the fetch is not what the walk waits for (below),
//   and a staged row would add a warp barrier and shared-memory reads.
//   The way out: a packet is worth its votes while the live lanes share
//   the node in hand. When fewer than kExitNum / kExitDen of them do, for
//   kExitVisits visits in a row, the rays have diverged (first-bounce
//   shadow rays toward many lights are the case): every lane copies its own
//   entries of the warp's stack and finishes with K1's per-ray walk, without
//   refill; the warp then draws its next packet. scratch[1] counts the
//   packets that left packet mode.
// What was measured (previous_kernels/sweep_k2_p2.py, NVIDIA H100): a
// packet visit costs about 40% more than the per-ray visit it replaces,
// even where every lane shares the node. It does every lane's slab or
// triangle tests like a per-ray visit, saves no transaction (a warp of
// coherent rays in the per-ray walk reads one address too) and puts the
// votes, the shared stack and its barrier on the dependent chain from one
// node to the next. So packet mode is no faster than the per-ray walk
// where all lanes agree, and slower where few do; of the thresholds tried
// (shares from 1/8 to 1, 1 to 8 visits) the earliest way out measured best
// on camera, MIS and RIS shadow rays together: the packet walks the trunk
// all its live lanes share, and the first visit that one of them does not
// share sends them off.
#ifndef HPT_K2_EXIT_NUM
#define HPT_K2_EXIT_NUM 1
#endif
#ifndef HPT_K2_EXIT_DEN
#define HPT_K2_EXIT_DEN 1
#endif
#ifndef HPT_K2_EXIT_VISITS
#define HPT_K2_EXIT_VISITS 1
#endif
#ifndef HPT_K2_BLOCKS
#define HPT_K2_BLOCKS 5
#endif
// the packet walk and the per-ray walk in one kernel spill at the 80
// registers of six blocks an SM; five blocks give ptxas 96
constexpr int kPacketBlocksPerSM = HPT_K2_BLOCKS;
// With HPT_K2_PROFILE (previous_kernels/sweep_k2_p2.py builds it so) the
// kernel adds to scratch[2 + slot], summed over lanes: 0 packet-mode node
// visits of a warp, 1 its leaf visits, 2 entries dropped at the pop, 3 the
// lanes that shared those visits, 4 turns of the per-ray walk of a warp, 5
// per-ray node visits of a lane, 6 per-ray leaf visits of a lane, 7 clocks
// of a warp in packet mode, 8 in the stack copy, 9 in the per-ray walk, 10
// the stack depth at the way out.
#ifdef HPT_K2_PROFILE
#define K2_PROF(slot, value) prof[slot] += (unsigned long long)(value)
#define K2_CLOCK() clock64()
#else
#define K2_PROF(slot, value)
#define K2_CLOCK() 0
#endif
constexpr int kWalkWarps = kWalkThreads / 32;
constexpr int kExitNum = HPT_K2_EXIT_NUM;
constexpr int kExitDen = HPT_K2_EXIT_DEN;        // 0: never leave packet mode
constexpr int kExitVisits = HPT_K2_EXIT_VISITS;  // 0: leave at the root

template <bool kAnyHit>
__global__ void __launch_bounds__(kWalkThreads, kPacketBlocksPerSM)
trace_coherent_kernel(const float4* __restrict__ nodes4,
                      const float4* __restrict__ leaf_rows,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ tmin,
                      const float* __restrict__ tmax,
                      const uint8_t* __restrict__ active, int64_t n,
                      unsigned long long* __restrict__ scratch,
                      float* __restrict__ t_out, int32_t* __restrict__ prim_out,
                      float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ int s_ref[kWalkWarps][kStack];
  __shared__ unsigned s_mask[kWalkWarps][kStack];
  __shared__ float s_t[kWalkWarps][kAnyHit ? 1 : kStack];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int* w_ref = s_ref[threadIdx.x >> 5];
  unsigned* w_mask = s_mask[threadIdx.x >> 5];
  float* w_t = s_t[threadIdx.x >> 5];
  const int64_t n_packets = (n + 31) / 32;
  // a lane's own stack, for a packet that has left packet mode
  int stack_ref[kStack];
  float stack_t[kAnyHit ? 1 : kStack];
  unsigned long long left = 0;
#ifdef HPT_K2_PROFILE
  unsigned long long prof[11] = {};
#endif

  while (true) {
    unsigned long long packet = 0;
    if (lane == 0) packet = atomicAdd(scratch, 1ull);
    packet = __shfl_sync(full, packet, 0);
    if ((int64_t)packet >= n_packets) break;
    const int64_t i = (int64_t)packet * 32 + lane;
    const bool valid = i < n;
    bool searching = valid && active[i] != 0;
    float best_t = valid ? tmax[i] : 0.0f, best_u = 0.0f, best_v = 0.0f;
    int best_prim = -1;
    Ray r = {};
    if (searching) r = load_ray(o, d, tmin, i);

    // cur, cur_mask, live, sp and low are uniform across the warp: every step
    // below is decided on votes
    unsigned cur_mask = __ballot_sync(full, searching);
    int cur = cur_mask != 0 ? 0 : kNone;  // the visit in hand, and its lanes
    int live = __popc(cur_mask);  // the lanes that still search
    int sp = 0;
    int low = 0;  // visits in a row that too few of the live lanes shared
    bool diverged = false;
    const long long clock0 = K2_CLOCK();
    while (true) {
      if (cur == kNone) {
        // the pop: the next entry that a lane of it still wants
        while (sp > 0) {
          --sp;
          const int ref = w_ref[sp];
          const bool mine = searching && ((w_mask[sp] >> lane) & 1u) != 0 &&
                            (kAnyHit || w_t[kAnyHit ? 0 : sp] <= best_t);
          const unsigned m = __ballot_sync(full, mine);
          if (m != 0) {
            cur = ref;
            cur_mask = m;
            break;
          }
          if (lane == 0) K2_PROF(2, 1);
        }
        if (cur == kNone) break;
      }
      low = (kExitDen > 0 && __popc(cur_mask) * kExitDen < live * kExitNum)
                ? low + 1 : 0;
      if (kExitDen > 0 && low >= kExitVisits) {
        diverged = true;
        break;
      }
      const bool mine = ((cur_mask >> lane) & 1u) != 0;
      if (lane == 0) {
        K2_PROF(cur >= 0 ? 0 : 1, 1);
        K2_PROF(3, __popc(cur_mask));
      }
      if (cur >= 0) {
        float box[24];
        int refs[4];
        load_node(nodes4, cur, box, refs);
        // a child's key: the packet's least entry distance with the child's
        // slot in the low bits (K1's key), in one reduction over the lanes
        unsigned key[4], hit[4];
        int n_hit = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float te = 0.0f;
          const bool h = mine && slab(box + 6 * c, r, best_t, te);
          hit[c] = __ballot_sync(full, h);
          key[c] = __reduce_min_sync(
              full, h ? ((__float_as_uint(te) & ~3u) | (unsigned)c) : kMissKey);
          n_hit += key[c] != kMissKey;
        }
        if (n_hit == 0) {
          cur = kNone;
          continue;
        }
        // lane c < 4 owns child c: its rank among the four keys (0 = nearest;
        // the slot bits make the keys distinct) is its place in the order,
        // and the children of rank 1 .. n_hit - 1 go on the stack far to
        // near, each stored by its own lane, with no sort and no pick a push
        const unsigned me = lane & 3u;
        const unsigned my_key = pick(key, me);
        const int rank = (key[0] < my_key) + (key[1] < my_key) +
                         (key[2] < my_key) + (key[3] < my_key);
        if (lane < 4 && rank >= 1 && rank < n_hit) {
          const int at = sp + n_hit - 1 - rank;
          w_ref[at] = pick(refs, me);
          w_mask[at] = pick(hit, me);
          if (!kAnyHit) w_t[kAnyHit ? 0 : at] = __uint_as_float(my_key & ~3u);
        }
        sp += n_hit - 1;
        __syncwarp();  // the entries, before any lane pops them
        const unsigned nearest =
            min(min(key[0], key[1]), min(key[2], key[3])) & 3u;
        cur = pick(refs, nearest);
        cur_mask = pick(hit, nearest);
      } else {
        if (mine && ray_visit_leaf<kAnyHit>(leaf_rows, cur, r, best_t, best_u,
                                            best_v, best_prim)) {
          searching = false;
        }
        cur = kNone;
        if (kAnyHit) {
          live = __popc(__ballot_sync(full, searching));
          if (live == 0) break;
        }
      }
    }

    const long long clock1 = K2_CLOCK();
    if (lane == 0) K2_PROF(7, clock1 - clock0);
    if (diverged) {
      // the way out: a lane's own entries of the warp's stack (the entry
      // distances are the packet's least, at or before the lane's own), the
      // visit in hand if the lane shares it, then the per-ray walk
      ++left;
      int my_sp = 0;
      for (int k = 0; k < sp; ++k) {
        if (searching && ((w_mask[k] >> lane) & 1u) != 0) {
          stack_ref[my_sp] = w_ref[k];
          if (!kAnyHit) stack_t[kAnyHit ? 0 : my_sp] = w_t[kAnyHit ? 0 : k];
          ++my_sp;
        }
      }
      __syncwarp();  // every lane has its copy before the next packet pushes
      const long long clock2 = K2_CLOCK();
      if (lane == 0) {
        K2_PROF(8, clock2 - clock1);
        K2_PROF(10, sp);
      }
      int my_cur = ((cur_mask >> lane) & 1u) != 0
                       ? cur
                       : ray_pop<kAnyHit>(stack_ref, stack_t, my_sp, best_t);
      while (__any_sync(full, my_cur != kNone)) {
        if (lane == 0) K2_PROF(4, 1);
        while (my_cur >= 0) {
          K2_PROF(5, 1);
          my_cur = ray_visit_node<kAnyHit>(nodes4, my_cur, r, best_t, stack_ref,
                                           stack_t, my_sp);
          if (my_cur == kNone) {
            my_cur = ray_pop<kAnyHit>(stack_ref, stack_t, my_sp, best_t);
          }
        }
        __syncwarp();
        if (my_cur != kNone) {
          K2_PROF(6, 1);
          if (ray_visit_leaf<kAnyHit>(leaf_rows, my_cur, r, best_t, best_u,
                                      best_v, best_prim)) {
            my_cur = kNone;
            my_sp = 0;
          } else {
            my_cur = ray_pop<kAnyHit>(stack_ref, stack_t, my_sp, best_t);
          }
        }
      }
      if (lane == 0) K2_PROF(9, K2_CLOCK() - clock2);
    }
    if (valid) {
      write_hit(i, kAnyHit, best_prim, best_t, best_u, best_v,
                t_out, prim_out, u_out, v_out);
    }
  }
  if (lane == 0 && left != 0) atomicAdd(scratch + 1, left);
#ifdef HPT_K2_PROFILE
  for (int k = 0; k < 11; ++k) {
    if (prof[k] != 0) atomicAdd(scratch + 2 + k, prof[k]);
  }
#endif
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

// One launch of a persistent kernel (a ray a thread, or a 32-ray packet a
// warp): as many blocks as are resident on the card, or as the rays need.
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
// persistent kernel draws its rays from (trace_coherent takes two words:
// the packet counter, then the count of packets that left packet mode,
// which the kernel adds to). Returns the first CUDA error of the launch, or
// 0. The *_info functions give a kernel's registers per thread, local
// memory bytes per thread (the stack and any spills), static shared memory
// bytes per block and resident blocks per SM, for the records.
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
                            int* shared_bytes, int* blocks_per_sm) {
  auto info = [&](auto kernel) {
    return kernel_info(kernel, kWalkThreads, regs, local_bytes, shared_bytes,
                       blocks_per_sm);
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
                              int* shared_bytes, int* blocks_per_sm) {
  auto info = [&](auto kernel) {
    return kernel_info(kernel, kWalkThreads, regs, local_bytes, shared_bytes,
                       blocks_per_sm);
  };
  return any_hit ? info(trace_incoherent_kernel<true>)
                 : info(trace_incoherent_kernel<false>);
}

int hpt_trace_coherent(const void* nodes4, const void* leaf_rows,
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
  return any_hit ? launch(trace_coherent_kernel<true>)
                 : launch(trace_coherent_kernel<false>);
}

int hpt_trace_coherent_info(int any_hit, int* regs, int* local_bytes,
                            int* shared_bytes, int* blocks_per_sm) {
  auto info = [&](auto kernel) {
    return kernel_info(kernel, kWalkThreads, regs, local_bytes, shared_bytes,
                       blocks_per_sm);
  };
  return any_hit ? info(trace_coherent_kernel<true>)
                 : info(trace_coherent_kernel<false>);
}

}  // extern "C"
