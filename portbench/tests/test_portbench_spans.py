"""The per-layer metrics that read the port's span registry
(portbench/program_spans.py) find values after a rehearsal of each
one-card cell on the host at 64x32, and none where the port has no
registry. No number from here is a device metric."""

import time

import pytest
import torch

from portbench import harness, program_spans
from portbench.cell import BENCHMARK, load_cell, load_json

READERS = ("camera_stream_ms_per_frame", "direct_light_stream_ms_per_frame",
           "shading_stream_ms_per_frame", "bounce_trace_stream_ms_per_frame",
           "live_lanes_pct")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["stress-glb-ris-1080p", "stress-glb-restir-1080p"])
def test_span_readers_find_values_after_a_run(name):
    from hiprt_pt_tpu_torch.utils import spans

    spans.reset()
    cell = load_cell(name)
    cell.config["resolution"] = [64, 32]
    res = harness.run_cell(cell, 2**31 + 5, 1.0, False, torch.device("cpu"),
                           time.perf_counter())
    assert res["verdict"]["correct"]
    bench = load_json(BENCHMARK)
    listed = {m["name"]: m for m in bench["per_layer"]}
    readers = harness.metric_readers(READERS)
    got = {k: readers[k](res["ctx"]) for k in READERS}
    for k, v in got.items():
        assert v is not None and v > 0.0, (k, got)
        assert name in listed[k]["workloads"]
    assert got["live_lanes_pct"] <= 100.0
    # the frames the registry holds: the warm-up and the window's
    steps = {r.step for r in spans.records() if r.name == "step"}
    assert len(steps) >= res["frames"]


def test_span_readers_read_nothing_without_the_registry(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_spans(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "hiprt_pt_tpu_torch.utils" and "spans" in (fromlist or ()):
            raise ImportError("no span registry")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_spans)
    assert program_spans.stream_ms(("camera",)) is None
    assert program_spans.share("live", "lanes") is None
