"""A run ends every process it started before it prints its result: a
process orphaned below it, the pixel-DP ranks and the multiprocessing
resource tracker that spawning them starts. Each case runs in a process of
its own, since the reaper ends that process's children."""

import json
import os
import subprocess
import sys

from portbench.cell import ROOT

_ORPHAN = """
import json, os, subprocess, sys, time
from portbench import reap
assert reap.adopt_orphans()
# a shell that leaves a sleeper behind and ends: the sleeper is orphaned
subprocess.run(["sh", "-c", "sleep 600 & echo $!"], check=True,
               stdout=open("sleeper.pid", "w"))
sleeper = int(open("sleeper.pid").read())
time.sleep(0.2)
before = sorted(reap.children())
left = reap.stop_all()
print(json.dumps({"sleeper": sleeper, "before": before, "left": left,
                  "after": sorted(reap.children()),
                  "alive": os.path.exists(f"/proc/{sleeper}")}))
"""

_RANKS = """
import json, os, sys, time
import torch
torch.set_num_threads(2)
from portbench import reap
from portbench.cell import load_cell
from portbench.ranks import run_ranks
from portbench.tests.test_portbench_reap import rank_leaving_a_sleeper
assert reap.adopt_orphans()
cell = load_cell("stress-glb-ris-1080p-pixeldp4")
cell.config["resolution"] = [64, 32]
cell.traffic["ranks"] = 2
res = run_ranks(cell, 2**31 + 3, 0.5, False, time.perf_counter(), device="cpu",
                backend="gloo", rank_fn=rank_leaving_a_sleeper)
from multiprocessing import resource_tracker
tracker = resource_tracker._resource_tracker._pid
before = sorted(reap.children())
left = reap.stop_all()
print(json.dumps({"correct": res["verdict"]["correct"], "tracker": tracker,
                  "before": before, "left": left,
                  "after": sorted(reap.children())}))
"""


def rank_leaving_a_sleeper(rank, spec):
    """A rank of the pixel-DP run that starts a process and leaves it
    running when it ends (a spawned rank imports this module by name)."""
    from portbench.ranks import _rank

    if rank == 1:
        subprocess.Popen(["sleep", "600"], start_new_session=True)
    return _rank(rank, spec)


def _python(code, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def test_an_orphaned_process_is_ended_and_waited_for(tmp_path):
    got, err = _python(_ORPHAN, tmp_path)
    assert got["sleeper"] in got["before"]
    assert got["left"] == ["sleep 600"]
    assert got["after"] == [] and not got["alive"]
    assert f"pid {got['sleeper']}: sleep 600" in err


def test_pixel_dp_ranks_leave_nothing_running(tmp_path):
    """Two gloo ranks, one of which leaves a sleeper behind: the sleeper
    comes to the run's process and is ended; the resource tracker is
    stopped; the ranks themselves had ended."""
    got, _ = _python(_RANKS, tmp_path)
    assert got["correct"]
    assert got["tracker"] in got["before"]
    assert got["left"] == ["sleep 600"]
    assert got["after"] == []
