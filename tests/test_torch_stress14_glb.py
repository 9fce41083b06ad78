"""The cell stress14-ris-1080p (portbench/) on the CPU: its entries and its
maker's counts; a small stress interior from a .glb, routed to the BVH8
walks, through the benchmark's run and check at 64x32; the spans and
counters of each traversal call (ops/cuda_traverse.py); the BVH build's
stages (accel/build.py) in the loader's timings and in the span registry
after more steps than it holds; and the two metric readers of the cell.
No number from here is a device metric."""

import time

import numpy as np
import pytest
import torch

from hiprt_pt_tpu_torch.accel.build import STAGES
from hiprt_pt_tpu_torch.ops import routing
from hiprt_pt_tpu_torch.utils import spans
from portbench import harness, system
from portbench.cell import inputs, load_cell

CELL = "stress14-ris-1080p"
BVH8 = {"trace_stream8", "trace_lane8log"}
READERS = ("traverse_stream_ms_per_frame", "bvh8_collapse_s")


def test_the_cell_reads_its_entries_and_the_maker_gives_its_counts():
    from portbench.inputs.stress import generate_stress_scene

    cell = load_cell(CELL)
    cfg, sc = cell.config, cell.config["scene"]
    assert cfg["name"] == "stress14-interior-glb" and cell.chips == 1
    assert cell.strategy == "RIS_BSDF_LIGHT" and cell.resolution == (1920, 1080)
    assert set(cell.limits) == {"pixels_off_pct", "rel_l1"}
    assert sc["maker"] == "stress_glb" and sc["tri_scale"] == 14.0
    p = generate_stress_scene(seed=sc["seed"], tri_scale=sc["tri_scale"],
                              num_emitters=sc["num_emitters"],
                              texture_size=sc["texture_size"])
    emissive = [i for i, row in enumerate(p.material_rows)
                if np.any(np.asarray(row.get("emission", (0, 0, 0))) > 0)]
    expect = cfg["expect"]
    assert p.triangles.shape[0] == expect["triangles"] == cfg["triangles"]
    assert int(np.isin(p.material_ids, emissive).sum()) == expect["emissive_triangles"]
    assert len(p.material_rows) == expect["materials"]
    assert len(p.images) == cfg["textures"]


def tiny_cell():
    """The cell at 64x32 on a small stress interior, under a configuration
    name of its own (its .glb is cached apart from the full-size one)."""
    cell = load_cell(CELL)
    cell.config["name"] = "stress14-interior-glb-tiny"
    cell.config["scene"]["tri_scale"] = 0.05
    cell.config["resolution"] = [64, 32]
    return cell


@pytest.fixture(scope="module")
def bvh8_gates():
    """Every gate of the router closed, as at Bistro's scale: build_bvh
    keeps the BVH8 tables and route gives trace_stream8 / trace_lane8log."""
    with pytest.MonkeyPatch.context() as m:
        for gate in ("meganode_ok", "wide_ok", "lane8s_tables_ok", "lane8_ok",
                     "stream8_ok"):
            m.setattr(routing, gate, lambda bvh: False)
        n = torch.get_num_threads()
        torch.set_num_threads(2)
        yield
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(bvh8_gates):
    """One run of the tiny cell through the harness, and the cell's metric
    readers read right after it, then with the registry emptied."""
    spans.reset()
    torch.manual_seed(0)
    res = harness.run_cell(tiny_cell(), 2**31 + 19, 1.0, False,
                           torch.device("cpu"), time.perf_counter())
    readers = harness.metric_readers(READERS)
    res["read"] = {k: readers[k](res["ctx"]) for k in READERS}
    spans.reset()
    res["read_emptied"] = {k: readers[k](res["ctx"]) for k in READERS}
    return res


@pytest.fixture(scope="module")
def frame(bvh8_gates):
    """One frame of the tiny cell's renderer under system.RayCapture, with
    the span registry emptied before it."""
    cell = tiny_cell()
    scene, cam, bvh, _ = system.load(cell, inputs(cell), torch.device("cpu"))
    r = system.renderer(cell, scene, cam, bvh, 2**31 + 23)
    spans.reset()
    with system.RayCapture() as cap:
        r.step()
    spans.flush()
    return bvh, cap.launches, spans.steps()


def test_the_bvh8_route_runs_the_cell_and_agrees_with_the_reference(run, frame):
    v = run["verdict"]
    assert v["correct"], v
    assert v["numbers"]["pixels_off_pct"][0] == 0.0
    assert run["frames"] >= 1
    bvh, launches, _ = frame
    assert bvh.nodes8l is not None and bvh.leaf_rows8 is not None
    assert bvh.nodes is None and bvh.leaf_rows is None
    assert {k for k, *_ in launches} == BVH8


def test_each_traversal_call_is_one_span_one_launch_and_its_rays(frame):
    _bvh, launches, steps = frame
    (st,) = steps
    calls, rays = {}, {}
    for kernel, o, *_ in launches:
        calls[kernel] = calls.get(kernel, 0) + 1
        rays[kernel] = rays.get(kernel, 0) + o.shape[0]
    spanned = {}
    for rec in st.records:
        if rec.name.startswith("trace/"):
            spanned[rec.name[6:]] = spanned.get(rec.name[6:], 0) + 1
    assert spanned == calls
    assert {k[9:]: v for k, v in st.counters.items()
            if k.startswith("launches/")} == calls
    assert {k[5:]: v for k, v in st.counters.items()
            if k.startswith("rays/")} == rays


def test_the_bvh_stages_in_the_timings_and_past_the_window(bvh8_gates):
    from hiprt_pt_tpu_torch.assets.loader import load_scene_file

    spans.reset()
    cell = tiny_cell()
    inp = inputs(cell)
    spent = {}
    load_scene_file(inp["glb"], aspect=inp["aspect"], parallel=True,
                    with_bvh=True, device="cpu", timings=spent)
    stages = {k: v for k, v in spent.items() if k.startswith("bvh/")}
    assert set(stages) == {"bvh/" + s for s in STAGES}
    assert all(v >= 0.0 for v in stages.values())
    assert sum(stages.values()) <= spent["bvh"]
    # the build's set-up step outlives more render steps than the registry holds
    for _ in range(spans.WINDOW + 6):
        with spans.step("cpu"), spans.span("step"):
            pass
    held = [r.name for r in spans.records() if r.name.startswith("bvh/")]
    assert held == ["bvh/" + s for s in STAGES]
    assert sum(r.name == "step" for r in spans.records()) == spans.WINDOW


def test_the_cell_metric_readers(run, monkeypatch):
    got = run["read"]
    assert all(v is not None and v > 0.0 for v in got.values()), got
    assert run["read_emptied"] == {k: None for k in READERS}
    import builtins

    real = builtins.__import__

    def no_spans(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "hiprt_pt_tpu_torch.utils" and "spans" in (fromlist or ()):
            raise ImportError("no span registry")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_spans)
    readers = harness.metric_readers(READERS)
    assert {k: readers[k](run["ctx"]) for k in READERS} == {k: None for k in READERS}
