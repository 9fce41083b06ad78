#!/usr/bin/env python3
"""Timing sweeps behind two choices of the port's kernels, on one GPU:

    python3 previous_kernels/sweep_k2_p2.py check   # build, hold against plain
    python3 previous_kernels/sweep_k2_p2.py k2      # trace_coherent's way out
    python3 previous_kernels/sweep_k2_p2.py p2      # dg_probe_kernel's plan
    python3 previous_kernels/sweep_k2_p2.py k2prof  # where trace_coherent's time goes

``k2`` builds hiprt_pt_tpu_torch/csrc/traverse.cu once per set of
trace_coherent's constants (HPT_K2_EXIT_NUM, HPT_K2_EXIT_DEN: the share
NUM/DEN of the live lanes below which a visit counts as diverged, DEN 0 =
never leave packet mode; HPT_K2_EXIT_VISITS: such visits in a row, 0 = leave
at the root; HPT_K2_BLOCKS: the resident blocks an SM that bound its
registers) and times each on the 1080p camera rays, first-bounce MIS shadow
rays and RIS tile-shared shadow rays of the stress interior, beside
trace_incoherent and the earlier block-packet trace_coherent
(trace_coherent_block.cu) on the same rays, with the share of packets that
left packet mode. ``p2`` times dg_probe_kernel at every strip width and
block size at 4 and 19 tiles (32 rounds, the probe's own inputs and seeded
per-lane indices), beside the plan that probes/r5probe2.py:dg_plan picks.
``k2prof`` builds a few of those variants with HPT_K2_PROFILE and prints the
kernel's own counts per packet (visits of a warp in packet mode and the lanes
that shared them, entries dropped at the pop, turns and visits of the per-ray
walk, clocks in each part).
``check`` builds the package's sources, prints what ptxas says of the two
kernels and holds both against their plain versions at small sizes.

Every time is device time between CUDA events over ``REPS`` launches after a
warm-up, outputs allocated once. Every line ends with the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke as cs  # noqa: E402
from hiprt_pt_tpu_torch.ops import cuda_build  # noqa: E402
from hiprt_pt_tpu_torch.ops import cuda_traverse as ct  # noqa: E402
from hiprt_pt_tpu_torch.ops import traverse as plain  # noqa: E402
from hiprt_pt_tpu_torch.ops.traverse import HitRecord, per_ray  # noqa: E402
from hiprt_pt_tpu_torch.probes import r5probe2 as pr  # noqa: E402
from hiprt_pt_tpu_torch.utils.native_build import BUILD_DIR  # noqa: E402

REPS = 10
# (HPT_K2_EXIT_NUM, HPT_K2_EXIT_DEN, HPT_K2_EXIT_VISITS, HPT_K2_BLOCKS)
K2_VARIANTS = (
    (1, 0, 1, 5),                       # never leave packet mode
    (1, 4, 0, 5),                       # leave at the root: the per-ray walk
    (1, 1, 1, 5), (1, 1, 2, 5), (1, 1, 4, 5), (3, 4, 1, 5), (3, 4, 2, 5),
    (1, 2, 1, 5), (1, 2, 2, 5), (1, 2, 4, 5), (1, 4, 1, 5), (1, 4, 2, 5),
    (1, 4, 4, 5), (1, 8, 8, 5),
    # a share no visit reaches: leave after exactly so many packet visits
    (2, 1, 1, 5), (2, 1, 2, 5), (2, 1, 4, 5), (2, 1, 8, 5), (2, 1, 16, 5),
    (2, 1, 24, 5),
    (1, 1, 1, 4), (1, 1, 1, 6), (1, 0, 1, 6))
P2_THREADS = (128, 256, 512, 1024)


def device_ms(fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k2_variant(num, den, visits, blocks, profile=False):
    """traverse.cu built with the four constants, as its own library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    stub = os.path.join(BUILD_DIR, f"traverse_exit_{num}_{den}_{visits}_{blocks}"
                                   f"{'_prof' if profile else ''}.cu")
    with open(stub, "w") as f:
        f.write(("#define HPT_K2_PROFILE 1\n" if profile else "")
                + f"#define HPT_K2_EXIT_NUM {num}\n"
                f"#define HPT_K2_EXIT_DEN {den}\n#define HPT_K2_EXIT_VISITS "
                f"{visits}\n#define HPT_K2_BLOCKS {blocks}\n"
                f"#include \"traverse.cu\"\n")
    lib, log = cuda_build.load_source(
        stub, ["-fmad=false"],
        {"hpt_trace_coherent": cuda_build.trace_args(2, True)})
    # what ptxas says of the variant's two trace_coherent kernels
    said, keep = [], False
    for line in log.splitlines():
        if "Compiling" in line:
            keep = "trace_coherent" in line
        elif keep and ("registers" in line or "spill" in line):
            said.append(line.replace("ptxas info    : ", "").strip())
    print(f"[k2] built exit {num}/{den}, {visits} visits, {blocks} blocks: "
          + "; ".join(said), flush=True)
    return lib


class Trace:
    """A traversal C function on fixed rays, outputs allocated once; it
    reads the BVH tables ``tables`` and takes ``extra`` after any_hit."""

    def __init__(self, fn, bvh, o, d, t_min, t_max, active, any_hit, words,
                 tables=("nodes4", "leaf_rows"), extra=()):
        n, dev = o.shape[0], o.device
        self.fn, self.any_hit, self.n, self.extra = fn, any_hit, n, extra
        self.tables = [getattr(bvh, t).data_ptr() for t in tables]
        self.rays = (o, d, per_ray(t_min, n, dev), per_ray(t_max, n, dev), active)
        # words = 0: a kernel that takes no scratch pointer
        self.scratch = torch.zeros((words,), dtype=torch.int64, device=dev)
        self.rec = HitRecord(
            t=torch.empty((n,), dtype=torch.float32, device=dev),
            prim=torch.empty((n,), dtype=torch.int32, device=dev),
            u=torch.empty((n,), dtype=torch.float32, device=dev),
            v=torch.empty((n,), dtype=torch.float32, device=dev))
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def __call__(self):
        self.scratch.zero_()
        r = self.rec
        scratch = (self.scratch.data_ptr(),) if self.scratch.numel() else ()
        err = self.fn(*self.tables, *(x.data_ptr() for x in self.rays), self.n,
                      int(self.any_hit), *self.extra, *scratch, r.t.data_ptr(),
                      r.prim.data_ptr(), r.u.data_ptr(), r.v.data_ptr(),
                      self.stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return r


def stress_rays(dev):
    """{label: (o, d, t_min, t_max, active, any_hit)} at 1080p."""
    scene, cam, bvh = cs.phase_scene("stress", dev)
    out = {}
    for label, tile in (("MIS shadow", None), ("RIS shadow", 128)):
        rays = cs.kind_rays(scene, bvh, cam, cs.WIDTH, cs.HEIGHT, plain.traverse,
                            3, tile)
        o, d, t_max, a = rays["shadow"]
        out[label] = (o, d, 1e-4, t_max, a, True)
    o, d, _t, a = rays["camera"]
    out = {"camera closest": (o, d, 0.0, float("inf"), a, False),
           "camera any-hit": (o, d, 1e-4, float("inf"), a, True)} | out
    return bvh, out


def sweep_k2(dev, where):
    bvh, rays = stress_rays(dev)
    libs = cuda_build.load_libraries()
    earlier, _log = cuda_build.load_source(
        os.path.join(HERE, "trace_coherent_block.cu"), ["-fmad=false"],
        {"hpt_prev_trace_coherent": cuda_build.trace_args(2, False)})
    with ThreadPoolExecutor(len(K2_VARIANTS)) as pool:
        variants = list(pool.map(lambda v: k2_variant(*v), K2_VARIANTS))
    for label, (o, d, t_min, t_max, a, any_hit) in rays.items():
        ref = plain.traverse(bvh, o, d, t_min, t_max, a, any_hit=any_hit)
        k1 = Trace(libs["traverse"].hpt_trace_incoherent, bvh, o, d, t_min,
                   t_max, a, any_hit, 1)
        print(f"[k2] {label}: trace_incoherent {device_ms(k1):.3f} ms [{where}]",
              flush=True)
        block = Trace(earlier.hpt_prev_trace_coherent, bvh, o, d, t_min, t_max,
                      a, any_hit, 0)
        print(f"[k2] {label}: the earlier block-packet trace_coherent "
              f"{device_ms(block):.3f} ms [{where}]", flush=True)
        for (num, den, visits, blocks), lib in zip(K2_VARIANTS, variants):
            k2 = Trace(lib.hpt_trace_coherent, bvh, o, d, t_min, t_max, a,
                       any_hit, 2)
            ms = device_ms(k2)
            rec = k2()
            torch.cuda.synchronize()
            left = int(k2.scratch[1])
            ok = ((rec.prim >= 0) == (ref.prim >= 0) if any_hit
                  else rec.prim == ref.prim).float().mean()
            print(f"[k2] {label}: exit below {num}/{den} for {visits} visits, "
                  f"{blocks} blocks an SM: {ms:.3f} ms, {left} of "
                  f"{-(-o.shape[0] // 32)} packets left packet mode, agreement "
                  f"{float(ok):.6f} [{where}]", flush=True)
        print(f"[k2] {label}: trace_incoherent again {device_ms(k1):.3f} ms "
              f"[{where}]", flush=True)


PROF_VARIANTS = ((1, 0, 1, 5), (1, 4, 0, 5), (1, 1, 1, 5), (1, 4, 4, 5))
PROF_SLOTS = ("packet node visits", "packet leaf visits", "entries dropped",
              "lanes sharing a packet visit", "per-ray turns of a warp",
              "per-ray node visits of a lane", "per-ray leaf visits of a lane",
              "clocks in packet mode", "clocks in the stack copy",
              "clocks in the per-ray walk", "stack depth at the way out")


def profile_k2(dev, where):
    bvh, rays = stress_rays(dev)
    with ThreadPoolExecutor(len(PROF_VARIANTS)) as pool:
        variants = list(pool.map(lambda v: k2_variant(*v, profile=True),
                                 PROF_VARIANTS))
    for label, (o, d, t_min, t_max, a, any_hit) in rays.items():
        for (num, den, visits, blocks), lib in zip(PROF_VARIANTS, variants):
            k2 = Trace(lib.hpt_trace_coherent, bvh, o, d, t_min, t_max, a,
                       any_hit, 2 + len(PROF_SLOTS))
            ms = device_ms(k2)
            k2()
            torch.cuda.synchronize()
            words = k2.scratch.tolist()
            packets = -(-o.shape[0] // 32)
            counts = ", ".join(f"{name} {v / packets:.2f}"
                               for name, v in zip(PROF_SLOTS, words[2:]))
            print(f"[k2prof] {label}: exit below {num}/{den} for {visits} visits: "
                  f"{ms:.3f} ms, {words[1]} of {packets} packets left packet "
                  f"mode; per packet: {counts} [{where}]", flush=True)


def sweep_p2(dev, where):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for S, tiles in pr.DG_CONFIGS:
        for name, (tab, idx) in (
                ("probe inputs", pr.dg_inputs(S, tiles, dev)),
                ("per-lane indices", pr.dg_gate_inputs(S, tiles, 5, dev))):
            want = float(pr.dg_probe_plain(tab, idx, pr.ROUNDS))
            plans = [(0, 0)] + [(g, t) for g in pr.DG_STRIPS for t in P2_THREADS
                                if t >= 32 * g]
            lib = cuda_build.load_libraries()["probes"]
            partial = torch.empty((pr.ROUNDS * tiles * pr.DG_LANES,),
                                  dtype=torch.float32, device=dev)
            out = torch.empty((1, 1), dtype=torch.float32, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream

            def launch(plan):
                # the C function itself: the wrapper's allocations would
                # bound a 30 us kernel by the host
                err = lib.hpt_dg_probe(tab.data_ptr(), idx.data_ptr(), S, tiles,
                                       pr.ROUNDS, plan[0], plan[1],
                                       partial.data_ptr(), out.data_ptr(), stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: cudaError {err}")

            for plan in plans + [pr.dg_plan(S, tiles, sms)]:
                got = float(pr.dg_probe_kernel(tab, idx, pr.ROUNDS, plan))
                ms = device_ms(lambda: launch(plan))
                info = [ctypes.c_int() for _ in range(4)]
                lib.hpt_dg_probe_info(plan[0], plan[1] or 1024, S,
                                      *(ctypes.byref(x) for x in info))
                # an f32 sum past 2^24 (19 tiles of seeded values) is not exact
                print(f"[p2] S={S} tiles={tiles} {name}: g={plan[0]} threads="
                      f"{plan[1]}: {ms:.4f} ms, rel. diff to plain "
                      f"{abs(got - want) / abs(want):.1e}, "
                      f"{info[0].value} registers, {info[1].value} local bytes, "
                      f"{info[2].value} shared bytes, {info[3].value} blocks/SM "
                      f"[{where}]", flush=True)


def check(dev, where):
    cuda_build.load_libraries()
    keep = False
    for line in cuda_build.build_log.splitlines():
        if "Compiling" in line or "registers" in line or "spill" in line:
            if "Compiling" in line:
                keep = "trace_coherent" in line or "dg_probe" in line \
                    or "trace_incoherent" in line
            if keep:
                print("[check] ptxas:", line.strip(), flush=True)
    from hiprt_pt_tpu_torch.accel.build import build_bvh
    from hiprt_pt_tpu_torch.assets.stress import load_stress_scene

    scene, cam = load_stress_scene(aspect=2.0, tri_scale=0.05,
                                   with_textures=False, device=dev)
    bvh = build_bvh(scene.vertices.cpu().numpy(), scene.triangles.cpu().numpy(), dev)
    o, d = cs.camera_rays(cam, 512, 256)
    rng = np.random.default_rng(0)
    n = o.shape[0]
    t_max = torch.from_numpy(np.where(rng.random(n) < 0.3, rng.uniform(0.2, 4.0, n),
                                      np.inf).astype(np.float32)).to(dev)
    act = torch.from_numpy(rng.random(n) >= 0.1).to(dev)
    d_rand = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    d_rand = (d_rand / d_rand.norm(dim=1, keepdim=True)).contiguous()
    for label, dd in (("camera", d), ("scattered", d_rand)):
        for any_hit in (False, True):
            for m in (n, n - 77):
                rk = ct.trace_coherent(bvh, o[:m].contiguous(), dd[:m].contiguous(),
                                       1e-4, t_max[:m].contiguous(),
                                       act[:m].contiguous(), any_hit=any_hit)
                torch.cuda.synchronize()
                rp = plain.traverse(bvh, o[:m], dd[:m], 1e-4, t_max[:m], act[:m],
                                    any_hit=any_hit)
                cs.compare(f"trace_coherent[{label}, any_hit={any_hit}, n={m}]",
                           rk, rp, any_hit, act[:m])
                print(f"[check] packets that left packet mode: "
                      f"{ct.coherent_packets()}", flush=True)
    # every sum stays below 2^24, so the f32 result is exact
    for S, tiles, rounds in ((512, 3, 6), (4096, 4, 32), (4096, 19, 4),
                             (4100, 2, 33), (1000, 1, 1), (30000, 1, 3)):
        for per_lane in (True, False):
            tab, idx = pr.dg_gate_inputs(S, tiles, 3, dev, per_lane=per_lane)
            # negative indices wrap
            idx = (idx - 3 * S * (idx % 3 == 0).int()).contiguous()
            want = float(pr.dg_probe_plain(tab, idx, rounds))
            plans = [None, (0, 0)] + [(g, t) for g in pr.DG_STRIPS
                                      for t in (32 * g, 256, 1024)
                                      if S * g * 4 <= pr.DG_SMEM_BLOCK and t >= 32 * g]
            for plan in plans:
                got = float(pr.dg_probe_kernel(tab, idx, rounds, plan))
                torch.cuda.synchronize()
                print(f"[check] dg_probe_kernel S={S} tiles={tiles} rounds={rounds} "
                      f"per_lane={per_lane} plan={plan or pr.dg_plan(S, tiles)}: "
                      f"{got} vs plain {want} [{where}]", flush=True)
                if got != want:
                    raise AssertionError("dg_probe_kernel disagrees")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("this script needs a GPU")
    what = sys.argv[1] if len(sys.argv) > 1 else "check"
    dev = torch.device("cuda:0")
    where = pr.card()
    {"check": check, "k2": sweep_k2, "p2": sweep_p2,
     "k2prof": profile_k2}[what](dev, where)


if __name__ == "__main__":
    main()
