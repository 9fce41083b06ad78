"""The port's spans and counters (hiprt_pt_tpu_torch/utils/spans.py) on the
CPU: nesting, parents, step ids and self time; recording off; the clock
shared with torch.profiler; the resolution of timing events without a
synchronise (with stand-in events); the live-lane counter against
render_sample's bounce stats; the join of a trace with the records; the
Renderer's profile() read from spans. The card's side is in
test_torch_cuda.py."""

import os
import re
import threading
import time

import pytest
import torch

from hiprt_pt_tpu_torch.utils import spans

PACKAGE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "hiprt_pt_tpu_torch")


@pytest.fixture(autouse=True)
def _fresh():
    spans.reset()
    spans.enable(True)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    spans.enable(True)
    spans.reset()
    torch.set_num_threads(n)


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_nesting_parents_step_ids_and_self_time():
    with spans.step("cpu") as sid:
        with spans.span("outer"):
            time.sleep(0.002)
            with spans.span("inner"):
                time.sleep(0.003)
            with spans.span("inner"):
                with spans.span("leaf"):
                    time.sleep(0.001)
        with spans.span("after"):
            pass
    with spans.span("loose"):
        pass
    recs = spans.records()
    named = _by_name(recs)
    assert [r.name for r in recs] == ["outer", "inner", "inner", "leaf", "after",
                                      "loose"]
    assert {r.step for r in recs if r.name != "loose"} == {sid}
    assert named["loose"][0].step != sid and named["loose"][0].parent is None
    assert named["outer"][0].parent is None and named["after"][0].parent is None
    assert [r.parent for r in named["inner"]] == ["outer", "outer"]
    assert named["leaf"][0].parent == "inner"
    outer = named["outer"][0]
    for r in recs:
        # on the CPU the stream ms is the host's
        assert r.stream_ms == pytest.approx(r.host_ms, abs=1e-9)
        assert outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns or \
            r.name in ("after", "loose")
    inner_ms = sum(r.stream_ms for r in named["inner"])
    assert outer.self_ms == pytest.approx(outer.stream_ms - inner_ms)
    assert named["inner"][1].self_ms == pytest.approx(
        named["inner"][1].stream_ms - named["leaf"][0].stream_ms)
    assert outer.self_ms >= 2.0 and inner_ms >= 4.0
    # the steps held: the step's records in the order they opened, then
    # the loose span's step
    held = spans.steps()
    assert [st.id for st in held] == [sid, named["loose"][0].step]
    assert held[0].records == recs[:5] and held[0].counters == {}


def test_a_step_opened_inside_a_step_joins_it():
    with spans.step("cpu") as outer:
        with spans.step("cpu") as inner:
            with spans.span("a"):
                pass
    assert inner == outer
    assert [r.step for r in spans.records()] == [outer]


def test_threads_keep_their_own_stacks_and_steps():
    seen = {}

    def work():
        with spans.step("cpu") as sid:
            with spans.span("thread"):
                time.sleep(0.01)
        seen["sid"] = sid

    with spans.step("cpu") as sid:
        with spans.span("main"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    named = _by_name(spans.records())
    assert named["thread"][0].parent is None
    assert named["thread"][0].step == seen["sid"] != sid
    assert named["main"][0].step == sid


def test_counters_and_shares():
    """Each step keeps its own counters, from which a reader takes a share
    a step; a count outside any step is a step of its own."""
    with spans.step("cpu"):
        with spans.span("s"):
            spans.count("live", 30)
            spans.count("lanes", 40)
            spans.count("live", 10)
            spans.count("lanes", 40)
    with spans.step("cpu"):
        with spans.span("s"):
            spans.count("live", 20)
            spans.count("lanes", 80)
    spans.count("loose", 2)
    held = spans.steps()
    assert [st.counters for st in held] == [{"live": 40, "lanes": 80},
                                            {"live": 20, "lanes": 80},
                                            {"loose": 2}]
    assert [st.records for st in held[2:]] == [[]]
    assert len({st.id for st in held}) == 3


def test_recording_off_records_nothing():
    spans.enable(False)
    with spans.step("cpu") as sid:
        with spans.span("a"):
            spans.count("live", 3)
    spans.flush()
    assert sid is None
    assert spans.steps() == []
    spans.enable(True)
    with spans.span("a"):
        pass
    assert [r.name for r in spans.records()] == ["a"]


def test_host_times_share_the_profilers_clock():
    """A span's host interval holds the aten:: events torch.profiler
    records inside it."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.step("cpu"):
            with spans.span("work"):
                y = (x @ x).relu().sum()
    assert float(y) > 0
    rec = _by_name(spans.records())["work"][0]
    aten = [(int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns()))
            for e in prof.profiler.kineto_results.events()
            if e.name() in ("aten::mm", "aten::relu", "aten::sum")]
    assert len(aten) >= 3
    for start, end in aten:
        assert rec.start_ns <= start <= end <= rec.end_ns, (rec, start, end)


class _Event:
    """A stand-in for torch.cuda.Event: the test says when its work is
    done; elapsed_time is the host time between the two records."""

    done = False
    syncs = 0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def query(self):
        return _Event.done

    def synchronize(self):
        _Event.syncs += 1
        _Event.done = True

    def elapsed_time(self, end):
        if not (_Event.done and self.t is not None and end.t is not None):
            raise RuntimeError("not ready")
        return (end.t - self.t) * 1e3


@pytest.fixture
def stand_in_events(monkeypatch):
    """Spans on a pretend CUDA device 0 whose events are _Event."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda index=None: None)
    monkeypatch.setattr(spans, "_cuda_index", lambda device: 0)
    monkeypatch.setattr(spans, "_free", {})
    monkeypatch.setattr(spans, "_made", {})
    _Event.done, _Event.syncs = False, 0
    return _Event


def test_events_resolve_at_the_next_step_once_done(stand_in_events):
    with spans.step("cuda") as first:
        with spans.span("a"):
            with spans.span("b"):
                time.sleep(0.002)
    assert spans.records() == []
    with spans.step("cuda"):
        pass
    assert spans.records() == []
    stand_in_events.done = True
    with spans.step("cuda") as third:
        with spans.span("c"):
            pass
    recs = spans.records()
    assert [(r.name, r.step) for r in recs] == [("a", first), ("b", first)]
    assert stand_in_events.syncs == 0
    assert recs[0].self_ms == pytest.approx(recs[0].stream_ms - recs[1].stream_ms)
    assert recs[1].stream_ms >= 2.0
    # a's and b's events went back to the pool, and c took two of them;
    # the last step waits for flush()
    assert len(spans._free[0]) == 2 and spans._made[0] == 4
    stand_in_events.done = False
    spans.flush()
    assert stand_in_events.syncs >= 1
    assert [r.step for r in spans.records()][-1] == third


def test_a_spent_pool_keeps_host_times_and_counts_the_drops(stand_in_events,
                                                           monkeypatch):
    monkeypatch.setattr(spans, "POOL_EVENTS", 4)
    with spans.step("cuda"):
        for name in ("a", "b", "c"):
            with spans.span(name):
                pass
    spans.flush()
    recs = spans.records()
    assert [r.stream_ms is None for r in recs] == [False, False, True]
    assert spans.steps()[0].counters == {"spans_dropped": 1}
    assert recs[2].self_ms is None and recs[2].host_ms >= 0.0


def test_attribute_joins_a_trace_with_the_records():
    R = spans.Record
    recs = [R("step", None, 1, 100, 1000, 9.0, 1.0),
            R("camera", "step", 1, 110, 300, 2.0, 2.0),
            R("bounce", "step", 1, 300, 900, 6.0, 1.0),
            R("bounce/direct", "bounce", 1, 310, 600, 3.0, 3.0),
            R("march", "bounce/direct", 1, 400, 500, 1.0, 1.0)]
    events = [
        ("cudaLaunchKernel", 120, 125, False),          # camera
        ("cudaLaunchKernel", 305, 306, False),          # bounce
        ("cudaLaunchKernel", 320, 321, False),          # bounce/direct
        ("cudaLaunchKernel", 410, 411, False),          # march
        ("cudaStreamSynchronize", 450, 480, False),     # march
        ("cudaMemcpy", 700, 720, False),                # bounce
        ("cudaLaunchKernel", 1200, 1201, False),        # outside
        ("aten::add", 320, 330, False),                 # neither
        ("kernel_a", 130, 200, True),
        ("kernel_b", 190, 250, True),                   # overlaps kernel_a
        ("kernel_c", 450, 470, True),                   # gap 250-450: mid 350
        ("kernel_d", 800, 810, True),                   # gap 470-800: mid 635
        ("kernel_e", 990, 995, True),                   # gap 810-990: mid 900
        ("kernel_f", 900, 900, True),                   # empty: ignored
    ]
    got = spans.attribute(events, recs, top=2)
    assert got["spans"] == {
        "camera": {"launches": 1, "syncs": 0},
        "bounce": {"launches": 1, "syncs": 1},
        "bounce/direct": {"launches": 1, "syncs": 0},
        "march": {"launches": 1, "syncs": 1},
        None: {"launches": 1, "syncs": 0}}
    assert got["gaps"] == [["bounce", pytest.approx(330e-6)],
                           ["bounce/direct", pytest.approx(200e-6)]]
    assert got["busy_ms"] == pytest.approx((120 + 20 + 10 + 5) * 1e-6)
    # a midpoint past every span is named None
    late = spans.attribute([("k", 0, 10, True), ("k", 5000, 5010, True)], recs)
    assert late["gaps"] == [[None, pytest.approx(4990e-6)]]


def test_performance_metrics_median():
    from hiprt_pt_tpu_torch.utils.perf import PerformanceMetrics

    m = PerformanceMetrics(window=3)
    assert m.get_median("x") == 0.0
    for v in (5.0, 1.0, 3.0, 100.0):
        m.add("x", v)
    assert m.values("x") == [1.0, 3.0, 100.0] and m.get_median("x") == 3.0
    m.add("x", 4.0)
    m.add("x", 2.0)
    assert m.get_median("x") == 4.0
    m2 = PerformanceMetrics(window=4)
    for v in (4.0, 1.0, 3.0, 2.0):
        m2.add("y", v)
    assert m2.get_median("y") == 2.5


def test_the_port_emits_no_profiler_ranges():
    """No record_function, NVTX or profiler range anywhere in the port."""
    pattern = re.compile(r"record_function|nvtx|_RecordFunction|range_push")
    hits = []
    for root, _dirs, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(root, f)
                with open(path, encoding="utf-8") as fh:
                    if pattern.search(fh.read()):
                        hits.append(path)
    assert hits == []


@pytest.fixture(scope="module")
def box():
    from hiprt_pt_tpu_torch.accel.build import build_bvh
    from hiprt_pt_tpu_torch.assets.stress import load_stress_scene

    scene, cam = load_stress_scene(aspect=2.0, tri_scale=0.01,
                                   with_textures=False, device="cpu")
    bvh = build_bvh(scene.vertices.numpy(), scene.triangles.numpy(), "cpu")
    return scene, cam, bvh


W, H = 32, 16


def _options(**kw):
    from hiprt_pt_tpu_torch.core import settings as ts

    base = dict(direct_light_sampling=ts.LightSamplingStrategy.MIS,
                max_bounces_static=4)
    base.update(kw)
    return ts.RenderOptions(**base)


def test_live_lanes_equal_the_bounce_stats(box):
    """The counters live and lanes of one sample equal render_sample's own
    alive counts and the bounces they cover; the step's share is their
    ratio."""
    from hiprt_pt_tpu_torch.core import rng
    from hiprt_pt_tpu_torch.core import settings as ts
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.render.integrator import camera_rays_pass, render_sample

    scene, cam, bvh = box
    opts = _options(max_bounces_static=6)
    settings = ts.RenderSettings(nb_bounces=6)
    world = ts.WorldSettings()
    s = rng.seed(torch.arange(W * H), 0, 42)
    with spans.step("cpu"):
        s, g, active = camera_rays_pass(scene, bvh, cam, settings,
                                        init_render_state(W, H, 42, "cpu"),
                                        W, H, 0, s, opts)
        out = render_sample(opts, scene, bvh, world, settings, g, active, s,
                            collect_bounce_stats=True)
    alive = out[5]
    ran = int((alive > 0).sum())
    assert 0 < alive[-1] < alive[0] and ran == 6
    (held,) = spans.steps()
    lanes = {k: v for k, v in held.counters.items() if "/" not in k}
    assert lanes == {"live": int(alive.sum()), "lanes": W * H * ran}
    # the rest count the traversal calls (ops/cuda_traverse.py)
    assert {k.split("/")[0] for k in held.counters if "/" in k} == {"launches",
                                                                  "rays"}
    assert len(_by_name(spans.records())["bounce"]) == ran


def test_the_bounce_loop_counts_only_while_spans_record(box, monkeypatch):
    """With spans off the bounce skip asks only whether any path lives, as
    it did before spans; with spans on it counts the live paths instead."""
    from hiprt_pt_tpu_torch.core import settings as ts
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.ops.pixel_order import PixelRange
    from hiprt_pt_tpu_torch.render.renderer import render_step

    scene, cam, bvh = box
    calls = {"any": 0, "count": 0}
    for name in calls:
        real = getattr(PixelRange, name)

        def wrapped(self, flag, _real=real, _name=name):
            calls[_name] += 1
            return _real(self, flag)
        monkeypatch.setattr(PixelRange, name, wrapped)
    args = (_options(), W, H, scene, bvh)
    rest = (cam, ts.RenderSettings(nb_bounces=2), ts.WorldSettings())
    spans.enable(False)
    render_step(*args, init_render_state(W, H, 7, "cpu"), *rest)
    off = dict(calls)
    spans.enable(True)
    render_step(*args, init_render_state(W, H, 7, "cpu"), *rest)
    on = {k: calls[k] - off[k] for k in calls}
    assert off["count"] == 0 and off["any"] >= 2
    assert on == {"count": 2, "any": off["any"] - 2}
    assert spans.steps()[-1].counters["lanes"] == W * H * 2


def test_a_render_step_covers_its_samples_with_spans(box):
    """One render_step of two samples is one step: a ``step`` span a
    sample, each with the camera pass, the bounces and their parts, the
    accumulation; the step's self time is what lies outside them."""
    from hiprt_pt_tpu_torch.core import settings as ts
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.render.renderer import render_step

    scene, cam, bvh = box
    opts = _options(direct_light_sampling=ts.LightSamplingStrategy.RIS_BSDF_LIGHT)
    settings = ts.RenderSettings(nb_bounces=3)
    state = init_render_state(W, H, 7, "cpu")
    render_step(opts, W, H, scene, bvh, state, cam, settings, ts.WorldSettings(),
                n_samples=2)
    recs = spans.records()
    assert len({r.step for r in recs}) == 1
    named = _by_name(recs)
    assert len(named["step"]) == 2 and len(named["camera"]) == 2
    assert len(named["accumulate"]) == 2
    assert all(r.parent == "step" for r in named["camera"] + named["bounce"])
    parts = ("bounce/material", "bounce/direct", "bounce/bsdf", "bounce/trace",
             "bounce/hit")
    assert len(named["bounce"]) == 6
    for p in parts:
        assert len(named[p]) == 6 and all(r.parent == "bounce" for r in named[p])
    for r in named["step"]:
        assert 0.0 <= r.self_ms < 0.25 * r.stream_ms
    # the step's counters cover the bounces of both samples
    (held,) = spans.steps()
    assert held.counters["lanes"] == W * H * 6
    assert 0 < held.counters["live"] <= W * H * 6


def test_restir_passes_are_spans_under_the_default_stage(box):
    from hiprt_pt_tpu_torch.core import settings as ts
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.render.renderer import render_step

    scene, cam, bvh = box
    opts = _options(direct_light_sampling=ts.LightSamplingStrategy.RESTIR_DI)
    settings = ts.RenderSettings(nb_bounces=1)
    state = init_render_state(W, H, 7, "cpu", with_restir=True)
    render_step(opts, W, H, scene, bvh, state, cam, settings, ts.WorldSettings())
    named = _by_name(spans.records())
    restir = [n for n in named if n.startswith("restir/")]
    assert "restir/initial candidates" in restir and "restir/final shading" in restir
    assert all(r.parent == "step" for n in restir for r in named[n])
    # a stage of the caller's own replaces the default, and its spans
    spans.reset()
    seen = []

    def stage(name, fn, *args, **kw):
        seen.append(name)
        return fn(*args, **kw)

    render_step(opts, W, H, scene, bvh, state, cam, settings, ts.WorldSettings(),
                stage=stage)
    assert seen and not any(n.startswith("restir/") for n in _by_name(spans.records()))
