"""The dense emissive sweep's dispatch on the host (lights/light_sampling.py:
closest_emissive_hit, ops/cuda_sweep.py): CPU tensors take the plain
sweep and launch nothing; the wrapper refuses them; the sweep is one span
a call while spans record, nested in direct light and in ReSTIR's initial
candidates. The kernel itself is held against the plain sweep on the card
in test_torch_cuda.py."""

import dataclasses

import numpy as np
import pytest
import torch

from hiprt_pt_tpu_torch.lights import light_sampling as tls
from hiprt_pt_tpu_torch.ops import cuda_build, cuda_sweep
from hiprt_pt_tpu_torch.ops.routing import KERNEL_TABLES
from hiprt_pt_tpu_torch.utils import spans

W, H = 32, 16


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


@pytest.fixture(scope="module")
def box():
    from hiprt_pt_tpu_torch.accel.build import build_bvh
    from hiprt_pt_tpu_torch.assets.stress import load_stress_scene

    scene, cam = load_stress_scene(aspect=2.0, tri_scale=0.01,
                                   with_textures=False, device="cpu")
    bvh = build_bvh(scene.vertices.numpy(), scene.triangles.numpy(), "cpu")
    return scene, cam, bvh


def _rays(scene, n=2048, seed=3):
    """Rays from the hall toward points near random emitters' centroids."""
    rng = np.random.default_rng(seed)
    p = rng.uniform([-9.0, 0.5, -5.0], [9.0, 5.0, 5.0], (n, 3)).astype(np.float32)
    rows = scene.emissive_rows.numpy()[rng.integers(0, 240, n)]
    target = rows[:, 0:3] + (rows[:, 3:6] + rows[:, 6:9]) / 3.0
    d = (target - p).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.from_numpy(p), torch.from_numpy(d),
            torch.from_numpy(rng.random(n) > 0.1))


def test_cpu_tensors_take_the_plain_sweep(box, monkeypatch):
    """On the CPU closest_emissive_hit is the plain sweep's result, calls
    it once, and leaves the kernel's launch count at 0."""
    scene = box[0]
    o, d, active = _rays(scene)
    calls = []
    plain = tls._closest_emissive_hit_plain

    def counted(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(tls, "_closest_emissive_hit_plain", counted)
    cuda_build.reset_launch_counts()
    t, slot = tls.closest_emissive_hit(scene, o, d, active=active)
    assert len(calls) == 1
    assert cuda_build.launch_counts["emissive_sweep"] == 0
    tp_, sp = plain(scene.emissive_rows, o, d, active)
    assert torch.equal(t, tp_) and torch.equal(slot, sp)
    assert slot.dtype == torch.int64 and (slot >= 0).float().mean() > 0.2
    assert torch.all(slot[~active] == -1)


def test_the_wrapper_refuses_cpu_tensors(box):
    scene = box[0]
    o, d, active = _rays(scene, n=16)
    cuda_build.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sweep.emissive_sweep(scene.emissive_rows, o, d, active)
    assert cuda_build.launch_counts["emissive_sweep"] == 0


def test_no_emitters_no_sweep_and_no_span(box):
    """With no emissive rows every ray misses, and nothing is swept."""
    scene = box[0]
    o, d, _ = _rays(scene, n=16)
    empty = dataclasses.replace(scene, emissive_rows=scene.emissive_rows[:0])
    with spans.step("cpu"):
        t, slot = tls.closest_emissive_hit(empty, o, d)
    assert torch.all(torch.isinf(t)) and torch.all(slot == -1)
    spans.flush()
    assert not [r for r in spans.records() if r.name == "emissive_sweep"]


@pytest.mark.parametrize("on", [True, False])
def test_the_sweep_is_one_span_a_call_while_spans_record(box, on):
    scene = box[0]
    o, d, active = _rays(scene, n=256)
    spans.enable(on)
    with spans.step("cpu"):
        for _ in range(3):
            tls.closest_emissive_hit(scene, o, d, active=active)
    spans.flush()
    recs = [r for r in spans.records() if r.name == "emissive_sweep"]
    assert len(recs) == (3 if on else 0)
    assert all(r.stream_ms is not None and r.stream_ms >= 0.0 for r in recs)


@pytest.mark.parametrize("strategy,parents", [
    ("RIS_BSDF_LIGHT", {"bounce/direct"}),
    ("RESTIR_DI", {"bounce/direct", "restir/initial candidates"})])
def test_a_frame_sweeps_once_a_bounce(box, strategy, parents):
    """A frame of 4 bounces sweeps once in each bounce's direct light (under
    ReSTIR the first bounce's masked RIS too) and, under ReSTIR, once more
    in the initial candidates: 4 and 5 sweeps a frame."""
    from hiprt_pt_tpu_torch.core import settings as ts
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.render.renderer import render_step

    scene, cam, bvh = box
    opts = ts.RenderOptions(
        direct_light_sampling=getattr(ts.LightSamplingStrategy, strategy),
        max_bounces_static=4)
    restir = strategy == "RESTIR_DI"
    state = init_render_state(W, H, 7, "cpu", with_restir=restir)
    render_step(opts, W, H, scene, bvh, state, cam, ts.RenderSettings(nb_bounces=4),
                ts.WorldSettings())
    recs = spans.records()
    sweeps = [r for r in recs if r.name == "emissive_sweep"]
    assert sum(r.name == "bounce/direct" for r in recs) == 4
    assert len(sweeps) == 4 + int(restir)
    assert {r.parent for r in sweeps} == parents


@pytest.mark.parametrize("tag,sweeps", [("headline", 4), ("restir", 5),
                                        ("stress", 0), ("viewer", 0)])
def test_chip_smoke_holds_the_sweep_to_its_count(box, tag, sweeps):
    """chip_smoke.py counts a path's sweeps a frame beside its walks'
    launches, in the one registry the checks reset and read."""
    import chip_smoke

    scene = box[0]
    per_kind = chip_smoke.frame_launches(tag, scene)
    assert per_kind.get((tag, "emissive_sweep", "sweep"), 0) == sweeps
    walks = {k: v for k, v in per_kind.items() if k[1] in KERNEL_TABLES}
    assert walks == chip_smoke.launches_per_frame(tag, scene)
    kernels = chip_smoke.path_kernels(tag)
    assert ("emissive_sweep" in kernels) == bool(sweeps)
    assert kernels <= set(cuda_build.launch_counts)
