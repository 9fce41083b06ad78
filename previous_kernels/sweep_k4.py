#!/usr/bin/env python3
"""Timing sweep behind trace_stream8's design (K4, csrc/traverse8.cu), on
one GPU:

    python3 previous_kernels/sweep_k4.py check    # build, hold against plain
    python3 previous_kernels/sweep_k4.py k4       # the variants, stress14 rays
    python3 previous_kernels/sweep_k4.py k4prof   # the kernels' own counts
    python3 previous_kernels/sweep_k4.py check k4 k4prof   # in one process

The designs: (a) the package's trace_stream8, the per-ray walk of
trace_lane8log (K5) with the refill of half a warp, beside K5 itself, the
same walk with a lane refilled as soon as its ray ends; (b) (a) with rows
[0, R) of nodes8l in each block's shared memory
(trace_stream8_toptree.cu), built in blocks of 128 threads (as many as fit)
and in one block of 512, 640 or 768 threads an SM, each timed at R = 0, 1
and every whole number of BFS levels within 227 KB. ``k4`` times them on
the 1080p camera rays (closest and any-hit) and RIS tile-shared shadow rays
of the stress14 path (chip_smoke.py:kind_rays), with the earlier
block-packet trace_stream8 (trace_stream8_packet.cu) on the same rays,
device only, and the package's two kernels through their wrappers too;
then all by camera closest + RIS shadow, the sum the design was chosen by.
``k4prof`` builds (a) and (b) at 768 threads with HPT_K4_PROFILE and prints
their counts per ray (node visits, from shared memory for (b), leaf visits)
and per warp (refills, turns). ``check`` builds the package's sources,
prints what ptxas says of the BVH8 kernels and holds trace_stream8, the
earlier version and (b) at every R against traverse8 at small sizes.

Every device-only time is device time between CUDA events over ``REPS``
launches after a warm-up, outputs allocated once. Every line ends with the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke as cs  # noqa: E402
from sweep_k2_p2 import REPS, device_ms  # noqa: E402
from sweep_k2_p2 import Trace as _Trace  # noqa: E402
from hiprt_pt_tpu_torch.ops import cuda_build  # noqa: E402
from hiprt_pt_tpu_torch.ops import cuda_traverse as ct  # noqa: E402
from hiprt_pt_tpu_torch.ops import traverse as plain  # noqa: E402
from hiprt_pt_tpu_torch.probes import r5probe2 as pr  # noqa: E402
from hiprt_pt_tpu_torch.utils.native_build import BUILD_DIR  # noqa: E402

# the most rows of nodes8l a (b) block holds: 227 KB of 256-byte rows
TOP_ROWS_MAX = 232448 // 256
STREAM8_ARGS = cuda_build.trace_args(2, True)
# the (b) launch takes top_rows (an int) after any_hit
TOPTREE_ARGS = STREAM8_ARGS[:9] + [ctypes.c_int] + STREAM8_ARGS[9:]
# label -> (source, {macro: value}): "pkg" is traverse8.cu (its
# trace_stream8), "toptree" previous_kernels/trace_stream8_toptree.cu
VARIANTS = {
    "a": ("pkg", {}),
    "b t128": ("toptree", {"HPT_K4_THREADS": 128, "HPT_K4_BLOCKS": 4}),
    "b t512": ("toptree", {"HPT_K4_THREADS": 512, "HPT_K4_BLOCKS": 1}),
    "b t640": ("toptree", {"HPT_K4_THREADS": 640, "HPT_K4_BLOCKS": 1}),
    "b t768": ("toptree", {"HPT_K4_THREADS": 768, "HPT_K4_BLOCKS": 1}),
}
# the variants k4 builds (the package's own kernels stand for (a)), and the
# ones k4prof builds with HPT_K4_PROFILE
TIMED_VARIANTS = ("b t128", "b t512", "b t640", "b t768")
PROF_VARIANTS = ("a", "b t768")
PROF_SLOTS = {
    "pkg": ("node visits", "leaf visits", "rays drawn", "refills of a warp",
            "turns of a warp"),
    "toptree": ("node visits from shared memory", "node visits from device "
                "memory", "leaf visits", "rays drawn", "refills of a warp",
                "turns of a warp")}


def log(*a):
    print(*a, flush=True)


def ptxas_lines(build_log, kernel):
    said, keep = [], False
    for line in build_log.splitlines():
        if "Compiling" in line:
            keep = kernel in line
            if keep:
                said.append(line.split("'")[1] if "'" in line else line.strip())
        elif keep and ("registers" in line or "spill" in line):
            said.append(line.replace("ptxas info    : ", "").strip())
    return said


class Variant:
    """A variant built as its own library: ``trace(...)`` and ``info(...)``
    are its launch and *_info C functions; ``top`` whether it takes
    top_rows."""

    def __init__(self, label, profile=False):
        source, macros = VARIANTS[label]
        self.label, self.source, self.top = label, source, source == "toptree"
        macros = dict(macros, **({"HPT_K4_PROFILE": 1} if profile else {}))
        os.makedirs(BUILD_DIR, exist_ok=True)
        name = "_".join(f"{k[4:].lower()}{v}" for k, v in sorted(macros.items()))
        stub = os.path.join(BUILD_DIR, f"k4_{source}_{name or 'as_is'}.cu")
        include = ("traverse8.cu" if source == "pkg"
                   else "trace_stream8_toptree.cu")
        with open(stub, "w") as f:
            f.write("".join(f"#define {k} {v}\n" for k, v in macros.items())
                    + f"#include \"{include}\"\n")
        if self.top:
            sig = {"hpt_prev_trace_stream8_toptree": TOPTREE_ARGS,
                   "hpt_prev_trace_stream8_toptree_info": cuda_build.INFO_ARGS}
        else:
            sig = {"hpt_trace_stream8": STREAM8_ARGS,
                   "hpt_trace_stream8_info": cuda_build.INFO_ARGS}
        lib, out = cuda_build.load_source(stub, ["-fmad=false", "-I", HERE], sig)
        fns = list(sig)
        self.trace, self.info = getattr(lib, fns[0]), getattr(lib, fns[1])
        self.said = "; ".join(ptxas_lines(out, "trace_stream8"))


def info(fn, any_hit):
    out = [ctypes.c_int() for _ in range(4)]
    err = fn(int(any_hit), *(ctypes.byref(x) for x in out))
    if err != 0:
        raise RuntimeError(f"kernel info failed: cudaError {err}")
    return tuple(x.value for x in out)


def Trace(fn, bvh, rays, extra=(), words=1):
    """sweep_k2_p2.Trace on the BVH8 tables: ``rays`` = (o, d, t_min,
    t_max, active, any_hit); ``extra``: (b)'s top rows."""
    return _Trace(fn, bvh, *rays, words, tables=("nodes8l", "leaf_rows8"),
                  extra=extra)


def agreement(rec, ref, any_hit):
    if any_hit:
        return float(((rec.prim >= 0) == (ref.prim >= 0)).float().mean())
    return float((rec.prim == ref.prim).float().mean())


def level_ends(nodes8l):
    """The rows of the shallowest k levels of nodes8l, k = 1 .. its depth:
    rows are numbered breadth-first, and every row's internal children
    (word A) follow those of the rows before it."""
    wa = nodes8l[:, 48].contiguous().view(torch.int32).cpu().numpy()
    ends = np.cumsum(wa >> 26)
    levels = [1]
    while 1 + int(ends[levels[-1] - 1]) != levels[-1]:
        levels.append(1 + int(ends[levels[-1] - 1]))
    return tuple(levels)


def top_counts(bvh):
    """The top rows a (b) variant is timed at: none, the root, and every
    whole number of BFS levels that fits."""
    return sorted({0, 1} | {e for e in level_ends(bvh.nodes8l) if e <= TOP_ROWS_MAX})


def stress14_rays(dev):
    """(bvh, {label: (o, d, t_min, t_max, active, any_hit)}) at 1080p: the
    rays chip_smoke.py times trace_stream8 on."""
    scene, cam, bvh = cs.phase_scene("stress14", dev)
    rays = cs.kind_rays(scene, bvh, cam, cs.WIDTH, cs.HEIGHT, plain.traverse8, 3,
                        cs.shadow_tile("stress14"))
    o, d, _t, a = rays["camera"]
    o_s, d_s, t_s, a_s = rays["shadow"]
    return bvh, {"camera closest": (o, d, 0.0, float("inf"), a, False),
                 "camera any-hit": (o, d, 1e-4, float("inf"), a, True),
                 "RIS shadow": (o_s, d_s, 1e-4, t_s, a_s, True)}


def build_all(state, profile=False):
    """({label: Variant}, the earlier trace_stream8's library), built once
    per process."""
    if profile in state:
        return state[profile]
    labels = PROF_VARIANTS if profile else TIMED_VARIANTS
    with ThreadPoolExecutor(len(labels) + 1) as pool:
        earlier = pool.submit(
            cuda_build.load_source, os.path.join(HERE, "trace_stream8_packet.cu"),
            ["-fmad=false"],
            {"hpt_prev_trace_stream8": STREAM8_ARGS,
             "hpt_prev_trace_stream8_info": cuda_build.INFO_ARGS})
        built = dict(zip(labels, pool.map(lambda v: Variant(v, profile), labels)))
        earlier = earlier.result()[0]
    for label, v in built.items():
        log(f"[build] {label}{' (profile)' if profile else ''}: {v.said}")
    state[profile] = built, earlier
    return state[profile]


def stress14(dev, state):
    if "stress14" not in state:
        state["stress14"] = stress14_rays(dev)
    return state["stress14"]


def sweep_k4(dev, where, state):
    bvh, rays = stress14(dev, state)
    libs = cuda_build.load_libraries()
    variants, earlier = build_all(state)
    package = libs["traverse8"]
    log(f"[k4] nodes8l {tuple(bvh.nodes8l.shape)}, leaf_rows8 "
        f"{tuple(bvh.leaf_rows8.shape)}, level ends {level_ends(bvh.nodes8l)} "
        f"[{where}]")
    for label, v in variants.items():
        for any_hit in (False, True):
            regs, local, shared, blocks = info(v.info, any_hit)
            log(f"[k4] {label} ({'any-hit' if any_hit else 'closest'}): {regs} "
                f"registers, {local} local bytes, {shared} shared bytes at "
                f"{TOP_ROWS_MAX} top rows, {blocks} blocks/SM [{where}]")
    results = {}
    for kind, ray in rays.items():
        o, d, t_min, t_max, a, any_hit = ray
        ref = plain.traverse8(bvh, o, d, t_min, t_max, a, any_hit=any_hit)
        row = results.setdefault(kind, {})

        def timed(name, trace):
            ms = device_ms(trace)
            agree = agreement(trace(), ref, any_hit)
            torch.cuda.synchronize()
            row[name] = ms
            log(f"[k4] {kind}: {name}: {ms:.4f} ms device only, agreement "
                f"{agree:.6f} [{where}]")
            if agree < cs.AGREE_MIN:
                raise AssertionError(f"{name} on {kind}: agreement {agree}")

        timed("K5 trace_lane8log", Trace(package.hpt_trace_lane8log, bvh, ray))
        timed("earlier K4 (block packets)",
              Trace(earlier.hpt_prev_trace_stream8, bvh, ray))
        timed("package K4", Trace(package.hpt_trace_stream8, bvh, ray))
        for label, v in variants.items():
            for top in top_counts(bvh):
                timed(f"{label} R={top}", Trace(v.trace, bvh, ray, (top,)))
        timed("K5 trace_lane8log again", Trace(package.hpt_trace_lane8log, bvh, ray))
        timed("package K4 again", Trace(package.hpt_trace_stream8, bvh, ray))
        # through the wrappers, as the renderer calls them
        for name, fn in (("K4 wrapper", ct.trace_stream8),
                         ("K5 wrapper", ct.trace_lane8log)):
            ms = cs.cuda_ms(lambda: fn(bvh, o, d, t_min, t_max, a,
                                       any_hit=any_hit), reps=REPS)[0]
            row[name] = ms
            log(f"[k4] {kind}: {name}: {ms:.4f} ms through the wrapper [{where}]")
        del ref
    # the rule the design was chosen by: camera closest + RIS shadow, device
    # only, ties to camera closest
    score = {name: results["camera closest"][name] + results["RIS shadow"][name]
             for name in results["camera closest"] if "wrapper" not in name}
    for name in sorted(score, key=score.get):
        log(f"[k4] camera closest + RIS shadow: {name}: {score[name]:.4f} ms "
            f"(camera closest {results['camera closest'][name]:.4f}) [{where}]")
    log(json.dumps({"k4_sweep": results, "card": where}))


def profile_k4(dev, where, state):
    bvh, rays = stress14(dev, state)
    variants, _earlier = build_all(state, profile=True)
    for kind, ray in rays.items():
        n = ray[0].shape[0]
        for label, v in variants.items():
            slots = PROF_SLOTS[v.source]
            for top in (top_counts(bvh) if v.top else (None,)):
                trace = Trace(v.trace, bvh, ray, () if top is None else (top,),
                              words=1 + len(slots))
                ms = device_ms(trace)
                trace()
                torch.cuda.synchronize()
                words = trace.scratch.tolist()[1:]
                warps = -(-n // 32)
                per = [w / (warps if "warp" in s else n)
                       for s, w in zip(slots, words)]
                counts = ", ".join(f"{s} {x:.3f}" for s, x in zip(slots, per))
                name = label if top is None else f"{label} R={top}"
                log(f"[k4prof] {kind}: {name}: {ms:.4f} ms (profiled); per ray "
                    f"or per 32 rays: {counts} [{where}]")


def check(dev, where, state):
    cuda_build.load_libraries()
    for kernel in ("trace_stream8", "trace_lane8log"):
        for line in ptxas_lines(cuda_build.build_log, kernel):
            log("[check] ptxas:", line)
    variants, earlier = build_all(state)
    from hiprt_pt_tpu_torch.accel.build import build_bvh
    from hiprt_pt_tpu_torch.assets.stress import load_stress_scene

    scene, cam = load_stress_scene(aspect=2.0, tri_scale=0.05,
                                   with_textures=False, device=dev)
    bvh = build_bvh(scene.vertices.cpu().numpy(), scene.triangles.cpu().numpy(),
                    dev, all_tables=True)
    rows = bvh.nodes8l.shape[0]
    log(f"[check] nodes8l {tuple(bvh.nodes8l.shape)}, level ends "
        f"{level_ends(bvh.nodes8l)} [{where}]")
    o, d = cs.camera_rays(cam, 512, 256)
    rng = np.random.default_rng(0)
    n = o.shape[0]
    t_max = torch.from_numpy(np.where(rng.random(n) < 0.3, rng.uniform(0.2, 4.0, n),
                                      np.inf).astype(np.float32)).to(dev)
    act = torch.from_numpy(rng.random(n) >= 0.1).to(dev)
    d_rand = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    d_rand = (d_rand / d_rand.norm(dim=1, keepdim=True)).contiguous()
    # (b) at every whole number of levels and at counts off the levels
    tops = sorted(set(top_counts(bvh)) | {min(rows, TOP_ROWS_MAX), 100})
    for label, dd in (("camera", d), ("scattered", d_rand)):
        for any_hit in (False, True):
            for m in (n, n - 77):
                ray = (o[:m].contiguous(), dd[:m].contiguous(), 1e-4,
                       t_max[:m].contiguous(), act[:m].contiguous(), any_hit)
                rp = plain.traverse8(bvh, *ray[:5], any_hit=any_hit)
                name = f"[{label}, any_hit={any_hit}, n={m}]"
                rk = ct.trace_stream8(bvh, *ray[:5], any_hit=any_hit)
                torch.cuda.synchronize()
                cs.compare("trace_stream8" + name, rk, rp, any_hit, ray[4])
                cs.compare("earlier trace_stream8" + name,
                           Trace(earlier.hpt_prev_trace_stream8, bvh, ray)(), rp,
                           any_hit, ray[4])
                for vlabel, v in variants.items():
                    for top in tops:
                        rk = Trace(v.trace, bvh, ray, (top,))()
                        torch.cuda.synchronize()
                        cs.compare(f"{vlabel} R={top}" + name, rk, rp, any_hit,
                                   ray[4])
    # past the budget: refused before the launch
    err = variants["b t768"].trace(
        *(0,) * 7, 1, 0, TOP_ROWS_MAX + 1, *(0,) * 6)
    log(f"[check] the top-rows variant at {TOP_ROWS_MAX + 1} rows: cudaError "
        f"{err} [{where}]")
    if err == 0:
        raise AssertionError("top_rows past the budget was not refused")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("this script needs a GPU")
    what = sys.argv[1:] or ["check"]
    modes = {"check": check, "k4": sweep_k4, "k4prof": profile_k4}
    if any(w not in modes for w in what):
        raise SystemExit(f"modes: {sorted(modes)}")
    dev = torch.device("cuda:0")
    where = pr.card()
    state = {}
    for w in what:
        modes[w](dev, where, state)


if __name__ == "__main__":
    main()
