"""A rehearsal of each cell's run on the host at 64x32: the set-up, the
window over the port's Renderer (its plain walks on the CPU), and the check
against the reference; the control in the program's place, and the run
with its timed path broken underneath, come out not correct. The command
itself fails without a card. No number from here is a device metric."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import check, harness
from portbench.cell import BENCHMARK, HERE, ROOT, Cell, inputs, load_cell, load_json

CPU = torch.device("cpu")
SIZE = [64, 32]
# the Cornell cell waits outside BENCHMARK.json (PERF.md, open questions);
# its files stay under portbench/, and the tests build the cell from them
CORNELL = "cornell-envmap-mis-1080p"


def _cornell() -> Cell:
    return Cell(name=CORNELL, chips=1,
                config=load_json(os.path.join(HERE, "configs", "cornell-spheres-envmap.json")),
                traffic=load_json(os.path.join(HERE, "traffic", "mis.json")),
                limits=load_json(os.path.join(HERE, "limits", CORNELL + ".json")))


def tiny(name: str):
    cell = _cornell() if name == CORNELL else load_cell(name)
    cell.config["resolution"] = list(SIZE)
    return cell


def rehearse(name: str, seed: int = 2**31 + 11):
    torch.manual_seed(0)
    return harness.run_cell(tiny(name), seed, 1.5, False, CPU, time.perf_counter())


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["stress-glb-ris-1080p", "stress-glb-restir-1080p",
                                  CORNELL])
def test_reference_agrees_with_the_port_on_the_host(name):
    res = rehearse(name)
    v = res["verdict"]
    assert v["correct"], v
    assert v["numbers"]["pixels_off_pct"][0] == 0.0
    assert res["frames"] >= 1 and 1 in res["check_frames"]
    assert set(res["e2e"]) == {"spp_per_s", "frame_ms_p95", "setup_s"}


@pytest.mark.parametrize("name", ["stress-glb-restir-1080p", CORNELL])
def test_control_is_not_correct(name):
    cell = tiny(name)
    from portbench import system

    inp = inputs(cell)
    scene, cam, bvh, _ = system.load(cell, inp, CPU)
    r = system.renderer(cell, scene, cam, bvh, 424242)
    win = harness.Window(r.step, r.state, 1.0, 2, False).run()
    v = check.judge(cell, inp, 424242, win.kept, CPU, control=check.bf16_shading)
    assert v["correct"]
    ctl = v["control"]
    limits = cell.limits
    assert any(ctl[k] > limits[k] for k in ctl), ctl


def test_restir_chain_to_the_middle_frame_then_the_program_state():
    """ReSTIR over MID_FRAMES + 1 frames: the reference follows its own
    chain to the middle frame, and renders the last from the program's
    state; both agree with the port on the host."""
    from portbench import system

    cell = tiny("stress-glb-restir-1080p")
    inp = inputs(cell)
    scene, cam, bvh, _ = system.load(cell, inp, CPU)
    r = system.renderer(cell, scene, cam, bvh, 31337)
    n = check.MID_FRAMES + 1
    count = iter(range(1, n + 1))
    win = harness.Window(r.step, r.state, 0.0, 3, False,
                         stop=lambda _elapsed: next(count) >= n).run()
    assert sorted(win.kept) == [1, 3, n]
    v = check.judge(cell, inp, 31337, win.kept, CPU)
    assert v["correct"], v
    assert all(f["pixels_off_pct"] == 0.0 and f["reservoirs_off_pct"] == 0.0
               for f in v["frames"].values()), v["frames"]


def _broken_step(kind):
    """A Renderer.step whose frame is broken where it is produced."""
    from hiprt_pt_tpu_torch.render import renderer as rmod

    real = rmod.render_step

    def step(self, block=False):
        if kind == "unchanged":
            return self.state
        prev = self.state
        new = real(*self._step_args(), prev, self.camera, self.settings,
                   self.world, n_samples=1)
        frame = new.accum - prev.accum
        if kind == "half":
            n = frame.shape[0] // 2
            frame = torch.cat([frame[:n], frame[:n].mean(0, keepdim=True)
                               .expand(frame.shape[0] - n, 3)])
        elif kind == "altered":
            frame = frame * 1.01
        self.state = new.replace(accum=prev.accum + frame)
        return self.state
    return step


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(kind, monkeypatch):
    from hiprt_pt_tpu_torch.render.renderer import Renderer

    monkeypatch.setattr(Renderer, "step", _broken_step(kind))
    res = rehearse(CORNELL, seed=97)
    assert not res["verdict"]["correct"], res["verdict"]


def _own_rows_only(state, mesh):
    """A gather that leaves out the exchange: rank 0's rows in place, the
    other ranks' rows zero."""
    from hiprt_pt_tpu_torch.parallel import mesh as pm

    if mesh.rank != 0:
        return None
    n = state.num_pixels

    def widen(x):
        out = torch.zeros((n * mesh.size, *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        out[:n] = x
        return out
    return pm._map_pixels(state, widen)


def _rank_gathering_own_rows(rank, spec):
    """A rank of the pixel-DP run whose gather leaves the other ranks' rows
    out (a spawned rank imports this module by name)."""
    from hiprt_pt_tpu_torch.parallel import mesh as pm
    from portbench.ranks import _rank

    pm.gather_render_state = _own_rows_only
    return _rank(rank, spec)


def _rank_holding_jax(rank, spec):
    """A rank of the pixel-DP run that holds a module named ``jax``."""
    import types

    from portbench.ranks import _rank

    if rank == 1:
        sys.modules["jax"] = types.ModuleType("jax")
    return _rank(rank, spec)


def _pixel_dp(rank_fn=None):
    from portbench.ranks import _rank, run_ranks

    cell = tiny("stress-glb-ris-1080p-pixeldp4")
    cell.traffic["ranks"] = 2
    return cell, run_ranks(cell, 5, 1.0, False, time.perf_counter(), device="cpu",
                           backend="gloo", rank_fn=rank_fn or _rank)


def test_the_exchange_between_ranks_left_out_is_not_correct():
    """Pixel DP over 2 gloo ranks on the host: whole, it is correct; with
    the gather leaving out the other rank's rows, it is not."""
    _, ok = _pixel_dp()
    assert ok["verdict"]["correct"], ok["verdict"]
    assert ok["forbidden"] == []
    _, bad = _pixel_dp(_rank_gathering_own_rows)
    assert not bad["verdict"]["correct"], bad["verdict"]


def test_a_rank_holding_jax_fails_the_run(capsys):
    """A rank that holds JAX after the window: the run prints no result and
    exits non-zero, though the parent process holds none."""
    from portbench import run
    from portbench.cell import load_json

    cell, res = _pixel_dp(_rank_holding_jax)
    assert res["forbidden"] == ["jax"]
    assert "jax" not in sys.modules
    args = run.parse(["--workload", cell.name, "--seed", "5", "--seconds", "1"])
    capsys.readouterr()
    assert run.finish(load_json(BENCHMARK), cell, args, res) != 0
    assert capsys.readouterr().out == ""


def test_a_new_cell_and_metric_as_new_files_only(tmp_path):
    """A copy of the benchmark with a cell, its traffic, its limits and a
    per-layer metric added as new files (and entries in BENCHMARK.json):
    the harness finds them by name and runs them."""
    shutil.copy(BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    pb = tmp_path / "portbench"
    (pb / "traffic" / "dummy.json").write_text(json.dumps(
        {"options": {"direct_light_sampling": "MIS"}, "ranks": 1, "warmup_frames": 1}))
    (pb / "limits" / "dummy-cell.json").write_text(json.dumps(
        {"pixels_off_pct": 0.1, "rel_l1": 1e-4}))
    (pb / "metrics" / "dummy_metric.py").write_text(
        "def read(ctx):\n    return 2.0 * ctx['setup']['bvh_build_s']\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "cornell-spheres-envmap", "source": "a test",
                             "file": "portbench/configs/cornell-spheres-envmap.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "cornell-spheres-envmap",
                               "traffic": "dummy", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy_metric", "unit": "s", "better": "lower",
                               "source": "program_span", "layer": "Test",
                               "moves": "setup_s", "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = """
import json, time, torch
torch.set_num_threads(2)
from portbench.cell import load_cell
from portbench.harness import run_cell
from portbench.run import per_layer
cell = load_cell('dummy-cell')
cell.config['resolution'] = [64, 32]
res = run_cell(cell, 3, 0.5, False, torch.device('cpu'), time.perf_counter())
m = per_layer(json.load(open('BENCHMARK.json')), 'dummy-cell', res['ctx'])
print(json.dumps({'correct': res['verdict']['correct'], 'metrics': sorted(m)}))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert "dummy_metric" in got["metrics"] and "bvh_build_s" in got["metrics"]


def _command(cwd, env):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "stress-glb-ris-1080p",
         "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_the_command_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = _command(ROOT, dict(os.environ))
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_the_command_fails_beside_nothing_but_the_benchmark(tmp_path):
    shutil.copy(BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _command(tmp_path, env)
    assert out.returncode != 0
    assert not out.stdout.strip()
