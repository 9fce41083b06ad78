"""The control of the check, and the program's own readings beside it,
on the card at a cell's own size (not run by the benchmark's runs):

    python3 -m portbench.control --workload <name> --seeds 1,2,3 --seconds 10 \
        [--control-seeds N]

For each seed, a fresh Renderer runs a window of ``--seconds`` as a run
does, and the window's check frames are judged: the program's frames
against the reference (the lower readings of PERF.md), and, for the first
``--control-seeds`` seeds (all by default), the reference's own frames
rendered in bfloat16 shading (check.py:bf16_shading) against the
reference (the upper readings). The scene, the BVH and the reference's
scene are built once.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import check, system
from .cell import inputs as make_inputs, load_cell
from .harness import Window, check_frame


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--control-seeds", type=int, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    system.enable_caches()
    cell = load_cell(args.workload)
    inp = make_inputs(cell)
    scene, cam, bvh, _ = system.load(cell, inp, dev)
    ref = check.reference_scene(cell, inp, dev)
    seeds = [int(s) for s in args.seeds.split(",")]
    n_control = len(seeds) if args.control_seeds is None else args.control_seeds
    for i, seed in enumerate(seeds):
        r = system.renderer(cell, scene, cam, bvh, seed)
        r.step()
        r.reset()
        win = Window(r.step, r.state, args.seconds, check_frame(seed), True).run()
        out = {"workload": cell.name, "seed": seed, "frames": win.frames,
               "check_frames": sorted(win.kept)}
        v = check.judge(cell, inp, seed, win.kept, dev, ref=ref,
                        control=check.bf16_shading if i < n_control else None)
        out["program"] = {k: x for k, (x, _) in v["numbers"].items()}
        out["program_frames"] = v["frames"]
        if "control" in v:
            out["control_bf16"] = v["control"]
        print(json.dumps(out), flush=True)
        del r, win
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
