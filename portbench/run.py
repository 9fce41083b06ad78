"""One run of one cell of BENCHMARK.json on the card:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON object as the last line of
standard output: ``correct``, ``attempted`` (frames of the window),
``failed`` (compared numbers past their limit), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` the ``breakdown``, and last ``checks``:
each number compared, beside its limit (also the last lines of standard
error). Exits non-zero, with no result, without as many CUDA cards as the
cell asks for, and when the process, or any rank of a cell over several,
holds JAX or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# a library the port uses must not load JAX by itself
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

from . import reap  # noqa: E402
from .guard import forbidden_modules  # noqa: E402


def power_limits() -> list:
    """Each card's power limit in watts, as nvidia-smi reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return [float(x) for x in out.split()]
    except (OSError, subprocess.SubprocessError, ValueError):
        return []


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def per_layer(bench: dict, cell_name: str, ctx: dict) -> dict:
    """The per-layer metrics of the cell that their readers find something
    to read in: {name: {"value", "unit"}}."""
    from .harness import metric_readers

    metrics = [m for m in bench["per_layer"]
               if "workloads" not in m or cell_name in m["workloads"]]
    readers = metric_readers(m["name"] for m in metrics)
    out = {}
    for m in metrics:
        value = readers[m["name"]](ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(bench: dict, cell, res: dict, trace: bool, device_info: dict) -> dict:
    verdict = res["verdict"]
    if trace:
        metrics = per_layer(bench, cell.name, res["ctx"])
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in res["e2e"].items()
                   if k in units}
    line = {"correct": verdict["correct"], "attempted": res["frames"],
            "failed": verdict["failed"], "metrics": metrics, "device": device_info}
    if trace and "trace" in res["ctx"]:
        t = res["ctx"]["trace"]
        line["device"]["busy_s"] = t.busy_s
        line["device"]["window_s"] = t.window_s
        line["breakdown"] = {"device_ops": t.device_ops, "idle_gaps": t.idle_gaps}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in verdict["numbers"].items()}
    return line


def _terminated(signum, frame):
    raise SystemExit(128 + signum)


def main(argv=None) -> int:
    """Run the cell; every process the run started has ended, and been
    waited for, before the result is printed and on every way out."""
    args = parse(argv)
    reap.adopt_orphans()
    signal.signal(signal.SIGTERM, _terminated)
    try:
        return _main(args)
    finally:
        reap.stop_all()


def _main(args) -> int:
    import torch

    from .cell import BENCHMARK, load_cell, load_json

    bench = load_json(BENCHMARK)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    if cell.ranks > 1:
        from .ranks import run_ranks

        res = run_ranks(cell, args.seed, args.seconds, bool(args.trace), T_START)
    else:
        from .harness import run_cell

        res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), T_START)
    reap.stop_all()
    return finish(bench, cell, args, res)


def finish(bench: dict, cell, args, res: dict) -> int:
    """Print the run's result; non-zero, and no result, where this process
    or a rank (``res["forbidden"]``) holds JAX or the JAX package."""
    import torch

    bad = sorted(set(forbidden_modules()) | set(res.get("forbidden", ())))
    if bad:
        print(f"portbench: the run holds {bad}: the benchmark measures the "
              "port alone", file=sys.stderr)
        return 3
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips,
                   "memory_peak_bytes": res["memory_peak_bytes"],
                   "power_limit_w": power_limits()[:cell.chips]}
    line = result_line(bench, cell, res, bool(args.trace), device_info)
    print(f"[run] {cell.name} seed {args.seed}: {res['frames']} frames in "
          f"{res['window_s']:.3f} s, {res['mrays_per_s']:.3f} Mrays/s, check "
          f"frames {res['check_frames']}", flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
