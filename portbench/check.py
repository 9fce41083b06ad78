"""What decides ``correct``: the frames of the window that the reference
re-renders, compared with what the program's timed path produced.

The window's image is the accumulation of its frames. The check re-renders
three of them at the cell's size with the reference (portbench/reference/,
a frozen plain copy of the render code with its own BVH and walk): the
first frame, one drawn from the seed among frames 3 to MID_FRAMES, and the
last. The program's contribution to frame k is its accumulation after k
less its accumulation before k, read from the render states the window
kept.

Without ReSTIR a frame depends only on the scene, the camera, the seed and
its sample index, so the reference renders it from a fresh state of its
own. Under ReSTIR a frame reuses the reservoirs and G-buffers of the
frames before it. The reference then follows its own chain: it starts
from a fresh state of its own before frame 1 and renders every frame up
to the middle check frame, from its own states alone, so that the middle
frame's image and reservoirs hold the temporal reuse built up over those
frames. Only a last frame past MID_FRAMES is rendered from the program's
own state before it, converted into the reference's types. The reservoirs
each checked frame leaves are compared too.

The numbers, each beside its limit (portbench/limits/<cell>.json):
- ``pixels_off_pct``: the share of the checked frames' pixels (of every
  check frame) where a channel of the program's radiance is off the
  reference's by more than ATOL + RTOL * |reference|;
- ``rel_l1``: the summed absolute difference over the summed reference;
- ``reservoirs_off_pct`` (ReSTIR): the share of pixels whose reservoir
  weight W, or the radiance of its light sample, is off by the same rule.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from .cell import Cell, options

ATOL = RTOL = 1e-3
# the middle check frame is drawn from frames 3 to MID_FRAMES: from the
# third on, ReSTIR's temporal reuse finds the G-buffer it reads
MID_FRAMES = 6


def reference_scene(cell: Cell, inputs: dict, device):
    """(scene, camera, bvh) built by the reference from the same inputs the
    program got: its own glTF parse, atlas, scene tables, envmap tables and
    BVH."""
    from .reference import accel
    from .reference.assets.scene import build_scene
    from .reference.core.material import MaterialBank

    if "glb" in inputs:
        from .reference.assets.gltf import load_gltf
        from .reference.assets.textures import (build_texture_atlas,
                                                srgb_texture_indices)

        parsed = load_gltf(inputs["glb"], aspect_override=inputs["aspect"])
        atlas = (build_texture_atlas(parsed.images,
                                     srgb_texture_indices(parsed.material_rows),
                                     2048) if parsed.images else None)
        scene = build_scene(parsed.vertices, parsed.triangles,
                            parsed.material_ids,
                            MaterialBank.from_rows(parsed.material_rows),
                            parsed.normals, parsed.uvs, atlas, None, device)
        cam = parsed.camera.to(device)
        v, f = parsed.vertices, parsed.triangles
    else:
        from .reference.assets.envmap import build_envmap
        from .reference.core.camera import camera_from_lookat

        v, f, m, rows, cam_kw = inputs["arrays"]
        envmap = (build_envmap(inputs["envmap"], device=device)
                  if inputs.get("envmap") is not None else None)
        scene = build_scene(v, f, m, MaterialBank.from_rows(rows),
                            envmap=envmap, device=device)
        cam = camera_from_lookat(**cam_kw, device=device)
    return scene, cam, accel.build(v, f, device)


def to_reference_state(state, device):
    """The program's render state as the reference's RenderState: every
    field as it is, the G-buffers and reservoirs in the reference's types."""
    from .reference.core.state import GBuffer, RenderState
    from .reference.restir.reservoir import Reservoir

    def conv(obj, cls):
        if obj is None:
            return None
        return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})

    kw = {f.name: getattr(state, f.name) for f in dataclasses.fields(RenderState)}
    kw["gbuffer"] = conv(state.gbuffer, GBuffer)
    kw["prev_gbuffer"] = conv(state.prev_gbuffer, GBuffer)
    kw["restir"] = conv(state.restir, Reservoir)
    return RenderState(**kw)


def off(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(N,) bool: a channel of ``prog`` off ``ref`` beyond the tolerance."""
    bad = (prog - ref).abs() > ATOL + RTOL * ref.abs()
    return bad.reshape(bad.shape[0], -1).any(dim=1)


class Tally:
    """Sums of the compared numbers over the check frames."""

    def __init__(self):
        self.pixels = 0
        self.off = 0
        self.abs_diff = 0.0
        self.abs_ref = 0.0
        self.res_pixels = 0
        self.res_off = 0

    def add(self, prog, ref, res_prog=None, res_ref=None) -> None:
        o = off(prog, ref)
        self.pixels += o.numel()
        self.off += int(o.sum())
        self.abs_diff += float((prog - ref).abs().double().sum())
        self.abs_ref += float(ref.abs().double().sum())
        if res_prog is not None:
            r = off(res_prog.W[:, None], res_ref.W[:, None]) | off(
                res_prog.radiance, res_ref.radiance)
            self.res_pixels += r.numel()
            self.res_off += int(r.sum())

    def numbers(self) -> dict:
        out = {"pixels_off_pct": 100.0 * self.off / max(self.pixels, 1),
               "rel_l1": self.abs_diff / max(self.abs_ref, 1e-30)}
        if self.res_pixels:
            out["reservoirs_off_pct"] = 100.0 * self.res_off / self.res_pixels
        return out


class ReferenceRun:
    """The reference's frames, under ``ctx`` (the control's context, or
    none): ``frame(k, prev)`` gives its render states before and after
    frame k, where ``prev`` is the program's state before frame k. Without
    ReSTIR, from a fresh state at prev's sample count. Under ReSTIR, up to
    MID_FRAMES along the reference's own chain, from a fresh state before
    the first frame asked for; past it, from ``prev`` itself."""

    def __init__(self, cell: Cell, ref, seed: int, device,
                 ctx=contextlib.nullcontext):
        from .reference.core import settings as sm

        self.cell, self.ref, self.seed, self.device, self.ctx = (
            cell, ref, seed, device, ctx)
        self.opts, self.settings, self.world = options(cell, sm)
        self.chain = None   # (frame, the reference's own state after it)

    def _step(self, st):
        from .reference.render.renderer import render_step

        scene, cam, bvh = self.ref
        w, h = self.cell.resolution
        with self.ctx():
            return render_step(self.opts, w, h, scene, bvh, st, cam,
                               self.settings, self.world,
                               n_samples=max(int(self.settings.samples_per_frame), 1))

    def _fresh(self, sample_count):
        from .reference.core.state import init_render_state

        w, h = self.cell.resolution
        st = init_render_state(w, h, self.seed, self.device,
                               with_restir=self.cell.restir)
        st.sample_count = sample_count
        return st

    def frame(self, k: int, prev):
        if self.cell.restir and k > MID_FRAMES:
            st = to_reference_state(prev, self.device)
        elif self.cell.restir:
            if self.chain is None:
                self.chain = (k - 1, self._fresh(prev.sample_count))
            done, st = self.chain
            while done < k - 1:
                st, done = self._step(st), done + 1
            new = self._step(st)
            self.chain = (k, new)
            return st, new
        else:
            st = self._fresh(prev.sample_count)
        return st, self._step(st)


def judge(cell: Cell, inputs: dict, seed: int, kept: dict, device,
          roofline=None, control=None, ref=None) -> dict:
    """Re-render the kept frames with the reference and compare. ``kept``:
    {frame: (program state before, program state after)}. ``roofline``:
    called with the reference's BVH once it is built. ``control``: a
    context manager under which the reference renders the same frames
    again in the program's place (the control of PERF.md), along a chain of
    its own; its numbers are returned too, under "control". ``ref``: the
    reference's (scene, camera, bvh), built here when not given. Returns
    {"correct", "numbers": {name: (value, limit)}, "failed": numbers past
    their limit, "frames": {frame: its own numbers}}."""
    ref = reference_scene(cell, inputs, device) if ref is None else ref
    if roofline is not None:
        roofline(ref[2])
    tally, ctl, frames = Tally(), Tally(), {}
    run = ReferenceRun(cell, ref, seed, device)
    alt_run = ReferenceRun(cell, ref, seed, device, control) if control else None
    for k in sorted(kept):
        prev, cur = kept[k]
        st, new = run.frame(k, prev)
        ref_rad = new.accum - st.accum
        res_ref = new.restir if cell.restir else None
        args = (cur.accum - prev.accum, ref_rad, cur.restir if cell.restir else None,
                res_ref)
        tally.add(*args)
        frames[k] = Tally()
        frames[k].add(*args)
        del st, new, args
        if alt_run is not None:
            st, alt = alt_run.frame(k, prev)
            ctl.add(alt.accum - st.accum, ref_rad, alt.restir if cell.restir else None,
                    res_ref)
            del st, alt
    del run, alt_run
    limits = cell.limits
    result = {name: (value, limits.get(name)) for name, value in tally.numbers().items()}
    correct = all(lim is not None and value <= lim for value, lim in result.values())
    failed = sum(1 for value, lim in result.values() if lim is None or value > lim)
    out = {"correct": correct, "numbers": result, "failed": failed,
           "frames": {k: t.numbers() for k, t in frames.items()}}
    if control is not None:
        out["control"] = ctl.numbers()
    return out


@contextlib.contextmanager
def bf16_shading():
    """The control: the reference with each vertex's shading values (the
    direct light, the BSDF value and pdf, the throughput and the radiance)
    rounded to bfloat16, the precision below the configuration's float32."""
    from .reference.render import integrator

    integrator.ROUND = lambda x: x.to(torch.bfloat16).to(torch.float32)
    try:
        yield
    finally:
        integrator.ROUND = None
