"""Interactive viewer — browser-based progressive render display, mirroring
``hiprt_pt_tpu.app.viewer`` (reference: the GLFW/ImGui window and
DisplayViewSystem, src/UI/RenderWindow.cpp, redesigned headless-first): a
small HTTP server streams the current render as PNG and exposes the
runtime-settings tree, the per-material editor and the static options; the
render loop runs in a background thread, accumulating continuously, and
every edit resets the accumulation (RenderWindow::reset_render).

    python -c "from hiprt_pt_tpu_torch.app.viewer import ViewerServer; ..."
    ViewerServer(Renderer(scene, cam, 1280, 720), port=8000).serve()

Display views (reference: DisplayViewSystem.cpp:28-74), /image?view=...:
beauty, denoised, denoise_blend, albedo, normal, heatmap (samples per
pixel), boolmap (converged pixels), furnace (|L - 1| > threshold), nan.
Panels: /settings, /materials, /options, /kernels, /bias, /stats,
/perf[?passes=1]. Edits: /control?cmd=set|material|option|preset|benchmark
|reset and the camera interactors rotate, pan, walk, orbit, zoom. Modal
jobs on background threads, polled at the bare endpoint: /bake?what=&res=
&samples=[&out=] and /animate?frames=&spp=&out=[&orbit_deg=][&envmap_deg=]
[&denoise=1].

The render step replaces the renderer's state and never writes into it (no
op of render/ or restir/ updates a state tensor in place), so a view or
/stats reads a shallow copy of the renderer taken at once (``_snapshot``)
and sees one whole state, whatever frame is in flight. Every edit of the
renderer (camera, settings, materials, options, presets, reset) holds
``_step_lock``, the lock each frame holds, so no edit lands in the middle
of a frame and is then overwritten by it; the loop lets a waiting edit in
before its next frame (``_frame_lock``). Handler threads, the render loop
and the modal jobs run their work on the renderer's device. PNGs are
encoded by the port's own writer (assets/image_io.py:encode_png).

Unlike the JAX package's ``_renderer_at_scale`` (hiprt_pt_tpu/app/
viewer.py:472), which hands a scaled renderer the base renderer's scene
and options, a preset switch carries the current scene, options, settings,
world and camera into the renderer it switches to, so material and option
edits survive it.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import enum
import json
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

_PAGE = """<!doctype html><html><head><title>hiprt_pt_tpu_torch viewer</title></head>
<body style="background:#111;color:#ddd;font-family:monospace">
<h3>hiprt_pt_tpu_torch — progressive render</h3>
<div id="stats"></div>
<select id="view" onchange="refresh()">
 <option>beauty</option><option>denoised</option><option>denoise_blend</option>
 <option>albedo</option><option>normal</option><option>heatmap</option>
 <option>boolmap</option><option>furnace</option><option>nan</option></select>
 <button onclick="cam('orbit',15)">orbit</button>
 <button onclick="cam('zoom',0.3)">zoom+</button>
 <button onclick="cam('zoom',-0.3)">zoom-</button>
 <button onclick="fetch('/control?cmd=reset')">reset</button>
<br/><img id="img" style="max-width:60vw;float:left;margin-right:1em"/>
<div id="panel" style="overflow:auto;max-height:80vh"></div>
<script>
function setp(k,v){ fetch('/control?cmd=set&key='+k+'&value='+v); }
function setm(i,k,v){ fetch('/control?cmd=material&index='+i+'&key='+k+'&value='+v); }
function cam(k,v){ fetch('/control?cmd='+k+'&value='+v); }
function seto(k,v){ fetch('/control?cmd=option&key='+k+'&value='+v).then(buildPanel); }
async function kern(){ document.getElementById('kern').innerText =
  await (await fetch('/kernels')).text(); }
async function buildPanel(){
  const s = await (await fetch('/settings')).json();
  let h = '<b>render settings</b><table>';
  for (const [k,v] of Object.entries(s)) {
    h += `<tr><td>${k}</td><td><input style="width:6em" value="${v}"
          onchange="setp('${k}', this.value)"/></td></tr>`;
  }
  h += '</table><b>materials</b> <select id="mat" onchange="buildMat()"></select><div id="matp"></div>';
  const o = await (await fetch('/options')).json();
  h += '<b>kernel options (tier 3 — edits recompile)</b><table>';
  for (const [k,v] of Object.entries(o)) {
    if (v.choices) {
      h += `<tr><td>${k}</td><td><select onchange="seto('${k}', this.value)">` +
           v.choices.map(c=>`<option ${c===v.value?'selected':''}>${c}</option>`).join('') +
           '</select></td></tr>';
    } else {
      h += `<tr><td>${k}</td><td><input style="width:6em" value="${v.value}"
            onchange="seto('${k}', this.value)"/></td></tr>`;
    }
  }
  h += '</table><div id="bias"></div><button onclick="kern()">kernel stats</button><pre id="kern"></pre>';
  document.getElementById('panel').innerHTML = h;
  const b = await (await fetch('/bias')).json();
  if (b.active) {
    document.getElementById('bias').innerHTML = '<b>ReSTIR status:</b> ' +
      (b.biased ? 'BIASED<br/>' + b.reasons.map(x=>'- '+x.title).join('<br/>')
                : 'Unbiased');
  }
  const m = await (await fetch('/materials')).json();
  window._mats = m;
  const sel = document.getElementById('mat');
  m.forEach((_,i)=>{ sel.innerHTML += `<option value="${i}">material ${i}</option>`; });
  buildMat();
}
function buildMat(){
  const i = +document.getElementById('mat').value || 0;
  const m = window._mats[i]; let h = '<table>';
  for (const [k,v] of Object.entries(m)) {
    h += `<tr><td>${k}</td><td><input style="width:10em" value="${v}"
          onchange="setm(${i}, '${k}', this.value)"/></td></tr>`;
  }
  document.getElementById('matp').innerHTML = h + '</table>';
}
async function refresh(){
  const v=document.getElementById('view').value;
  document.getElementById('img').src='/image?view='+v+'&t='+Date.now();
  const s=await fetch('/stats'); document.getElementById('stats').innerText=await s.text();
}
buildPanel(); setInterval(refresh, 1500); refresh();
</script></body></html>"""


# runtime-settings leaves exposed in the panel (the reference edits these
# through ImGuiSettingsWindow without recompiling)
_SETTINGS_KEYS = (
    "nb_bounces", "samples_per_frame", "accumulate", "freeze_random",
    "do_russian_roulette", "rr_min_depth", "rr_throughput_clamp",
    "direct_contribution_clamp", "indirect_contribution_clamp",
    "envmap_contribution_clamp", "minimum_light_contribution",
    "number_of_light_samples", "enable_adaptive_sampling",
    "adaptive_sampling_min_samples", "adaptive_sampling_noise_threshold",
    "stop_noise_threshold", "stop_pixel_percentage_converged",
    "render_low_resolution", "low_resolution_scale", "do_alpha_testing",
    "rr_method",
)

VIEWS = ("beauty", "denoised", "denoise_blend", "albedo", "normal", "heatmap",
         "boolmap", "furnace", "nan")


def _on_device(device):
    """The CUDA device context of ``device`` (a no-op on the CPU), so that a
    thread's work runs on the renderer's card, not the thread's default."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _flag(raw: str) -> bool:
    return raw.strip().lower() in ("1", "true", "yes", "on")


class ViewerServer:
    """Serve a Renderer's progressive output over HTTP."""

    def __init__(self, renderer, host: str = "127.0.0.1", port: int = 8000):
        self.renderer = renderer
        # the renderers of the scaled presets (true low-resolution
        # interaction: a reduced grid, not masked pixels on the full one)
        self._base_renderer = renderer
        self._scaled_renderers = {}
        self.host = host
        self.port = port
        self.denoise_blend = 0.5
        self.furnace_threshold = 0.02
        # application-level perf knobs (reference: ApplicationSettings:
        # auto_sample_per_frame + target_GPU_framerate drive the
        # samples-per-frame tuner, RenderWindow.cpp:798-805;
        # GPU_stall_percentage idles between frames, :660-671)
        self.auto_samples_per_frame = False
        self.target_framerate = 10.0
        self.stall_percentage = 0.0
        self._stop = threading.Event()
        self._render_thread = None
        self._serve_thread = None
        self._httpd = None
        # a modal job (an animation) owns the renderer: the loop yields
        self._busy = threading.Event()
        # held by each frame and by every edit of the renderer (reentrant:
        # a preset edits under it, inside /control's hold); the loop lets
        # the threads that wait for it in (_waiting) take it between frames
        self._step_lock = threading.RLock()
        self._waiting = 0
        self._waiting_lock = threading.Lock()
        self._bake_status = {"state": "idle"}
        self._anim_status = {"state": "idle"}

    # --- render loop (background) ---

    @contextlib.contextmanager
    def _frame_lock(self):
        """Hold the frame lock for an edit or a modal job: taken at the end
        of the frame in flight, before the loop starts another (a plain
        lock goes back to the loop, which asks again at once)."""
        with self._waiting_lock:
            self._waiting += 1
        try:
            with self._step_lock:
                yield
        finally:
            with self._waiting_lock:
                self._waiting -= 1

    def _render_loop(self):
        with _on_device(self.renderer.device):
            while not self._stop.is_set():
                if self._waiting:
                    time.sleep(0.001)  # an edit takes the lock first
                    continue
                if self._busy.is_set() or self.renderer.is_rendering_done():
                    time.sleep(0.05)  # reference: a sleep when converged
                    continue
                with self._step_lock:
                    if self._busy.is_set():
                        continue
                    self.renderer.step(block=True)
                    stall_s = self._post_frame_tuning()
                time.sleep(stall_s)

    def _post_frame_tuning(self) -> float:
        """Auto samples-per-frame (reference: RenderWindow.cpp:798-805),
        under the frame lock like any settings edit; returns the seconds of
        the render-stall throttle (compute_GPU_stall_duration, :660-671),
        which the loop sleeps without the lock."""
        r = self.renderer
        frame_hist = r.metrics.values("frame_ms")
        if not frame_hist:
            return 0.0
        frame_ms = frame_hist[-1]
        if self.auto_samples_per_frame:
            if r.settings.render_low_resolution:
                spf = 1  # one sample per frame while interacting
            else:
                spf_cur = max(1, int(r.settings.samples_per_frame))
                samples_per_s = 1000.0 / max(frame_ms / spf_cur, 1e-3)
                spf = min(max(1, int(samples_per_s
                                     / max(self.target_framerate, 1e-3))),
                          65536)
            r.settings = r.settings.replace(samples_per_frame=spf)
        if self.stall_percentage <= 0.0:
            return 0.0
        p = min(self.stall_percentage, 95.0)
        return min((frame_ms / 1000.0) * (1.0 / (1.0 - p / 100.0) - 1.0), 2.0)

    def _snapshot(self):
        """A shallow copy of the current renderer: its state, shape and
        settings as of one moment (see the module docstring)."""
        return copy.copy(self.renderer)

    def view_image(self, view: str) -> np.ndarray:
        """(H, W, 3) display image in [0, 1] of ``view`` (VIEWS; anything
        else: beauty) from one snapshot of the renderer."""
        from ..ops.pixel_order import unscramble
        from ..ops.tonemap import tonemap_gamma

        r = self._snapshot()
        with _on_device(r.device):
            if view in ("denoised", "denoise_blend"):
                from ..render.denoise import denoise

                den = tonemap_gamma(torch.from_numpy(denoise(r))).numpy()
                if view == "denoised":
                    return den
                # reference: blend_2_display.frag, beauty <-> denoised
                return ((1.0 - self.denoise_blend) * r.ldr_image()
                        + self.denoise_blend * den)
            if view == "albedo":
                return np.clip(r.aov_images()[0], 0, 1)
            if view == "normal":
                return np.clip(r.aov_images()[1] * 0.5 + 0.5, 0, 1)
            if view == "heatmap":
                counts = unscramble(r.state.pixel_sample_count.cpu().numpy(),
                                    r.width, r.height)[::-1].astype(np.float32)
                c = counts / max(counts.max(), 1.0)
                return np.stack([c, 1.0 - c, np.zeros_like(c)], axis=-1)
            if view == "boolmap":
                # reference: boolmap_display.frag
                conv = unscramble(r.state.pixel_converged.cpu().numpy(),
                                  r.width, r.height)[::-1].astype(np.float32)
                return np.repeat(conv[..., None], 3, axis=-1)
            if view == "furnace":
                # reference: white_furnace_threshold.frag
                dev = np.abs(r.hdr_image().mean(-1) - 1.0)
                bad = (dev > self.furnace_threshold).astype(np.float32)
                return np.stack([bad, 1.0 - bad, np.zeros_like(bad)], axis=-1)
            if view == "nan":
                from ..render.debug import nan_view

                return np.asarray(nan_view(r))
            return r.ldr_image()

    def _image_png(self, view: str) -> bytes:
        """``view`` as 8-bit PNG bytes, quantized as the JAX package's
        viewer quantizes (truncation of value * 255)."""
        from ..assets.image_io import encode_png

        img = self.view_image(view)
        return encode_png((np.clip(img, 0, 1) * 255).astype(np.uint8))

    # --- parameter panels ---

    def _settings_json(self) -> str:
        s = self.renderer.settings
        out = {k: getattr(s, k) for k in _SETTINGS_KEYS if hasattr(s, k)}
        out["denoise_blend"] = self.denoise_blend
        out["furnace_threshold"] = self.furnace_threshold
        out["auto_samples_per_frame"] = self.auto_samples_per_frame
        out["target_framerate"] = self.target_framerate
        out["stall_percentage"] = self.stall_percentage
        return json.dumps(out)

    def _materials_json(self) -> str:
        from ..core.material import _COLOR_FIELDS, _SCALAR_FIELDS

        bank = self.renderer.scene.materials
        cols = {name: getattr(bank, name).cpu().numpy()
                for name, _d in _SCALAR_FIELDS + _COLOR_FIELDS}
        rows = []
        for i in range(bank.num_materials):
            row = {name: float(cols[name][i]) for name, _d in _SCALAR_FIELDS}
            for name, _d in _COLOR_FIELDS:
                row[name] = [round(float(x), 5) for x in cols[name][i]]
            rows.append(row)
        return json.dumps(rows)

    def _set_material(self, index: int, key: str, raw: str) -> bool:
        """Live material edit (reference: ImGuiObjectsWindow's material
        editor writing through to the material, then a reset). False for
        an unknown field or material."""
        from ..core.material import _COLOR_FIELDS, _SCALAR_FIELDS

        r = self.renderer
        bank = r.scene.materials
        if not 0 <= index < bank.num_materials:
            return False
        if key in {n for n, _ in _SCALAR_FIELDS}:
            value = float(raw)
        elif key in {n for n, _ in _COLOR_FIELDS}:
            value = [float(x) for x in
                     raw.replace("[", "").replace("]", "").split(",")][:3]
        else:
            return False
        col = getattr(bank, key).clone()
        col[index] = torch.tensor(value, dtype=col.dtype)
        r.scene = dataclasses.replace(
            r.scene, materials=dataclasses.replace(bank, **{key: col}))
        return True

    def _control(self, q) -> str:
        """Runtime parameter edits and camera interaction (reference: the
        ImGui settings window and the interactors; every edit resets the
        accumulation like RenderWindow::reset_render). Each holds the
        frame lock."""
        cmd = q.get("cmd", [""])[0]
        with self._frame_lock():
            err = self._edit(cmd, q)
        if err:
            return json.dumps({"ok": False, "cmd": cmd, "error": err})
        return json.dumps({"ok": True, "cmd": cmd})

    def _edit(self, cmd: str, q):
        """One /control edit; returns an error string or None."""
        from ..core import camera as cam_ops

        r = self.renderer

        def arg(name, default):
            return q.get(name, [default])[0]

        if cmd == "reset":
            r.reset()
        elif cmd == "orbit":
            from ..render.animation import CameraOrbitAnimation

            anim = CameraOrbitAnimation(target=(0.0, 0.0, 0.0),
                                        degrees_per_frame=float(arg("value", "15")))
            r.set_camera(anim.step(r.camera))
        elif cmd == "zoom":
            r.set_camera(cam_ops.camera_zoom(r.camera, float(arg("value", "0.3"))))
        elif cmd in ("walk", "pan"):
            # pan = middle-drag translate in the camera plane; walk = WASD
            dz = float(arg("dz", "0")) if cmd == "walk" else 0.0
            r.set_camera(cam_ops.camera_translate(
                r.camera, float(arg("dx", "0")), float(arg("dy", "0")), dz))
        elif cmd == "rotate":
            # first-person look (reference: left-drag mouse rotation)
            r.set_camera(cam_ops.camera_rotate(
                r.camera, float(arg("yaw", "0")), float(arg("pitch", "0"))))
        elif cmd == "material":
            idx = int(arg("index", "0"))
            if not self._set_material(idx, arg("key", ""), arg("value", "0")):
                return f"no material field {arg('key', '')!r} at {idx}"
            r.reset()
        elif cmd == "option":
            # a static-option edit restarts the render (reference: a macro
            # edit → GPURenderer::recompile_kernels)
            return self._set_option(arg("key", ""), arg("value", ""))
        elif cmd == "preset":
            name = arg("value", "none")
            if not self._apply_performance_preset(name):
                return f"unknown preset {name!r}"
            self.renderer.reset()
        elif cmd == "benchmark":
            # reference: "Apply benchmark settings"
            # (ImGuiSettingsWindow.cpp:2062-2069)
            r.settings = r.settings.replace(freeze_random=True,
                                            enable_adaptive_sampling=False,
                                            samples_per_frame=1)
            self.auto_samples_per_frame = False
            r.reset()
        elif cmd == "set":
            return self._set(arg("key", ""), arg("value", "0"))
        return None

    def _set(self, key: str, raw: str):
        """One settings edit: a viewer knob, or a runtime-settings leaf (with
        a reset). Returns an error string or None."""
        r = self.renderer
        if key == "auto_samples_per_frame":
            self.auto_samples_per_frame = _flag(raw)
        elif key in ("target_framerate", "stall_percentage", "denoise_blend",
                     "furnace_threshold"):
            setattr(self, key, float(raw))
        elif key == "clamp":  # the combined alias
            r.settings = r.settings.replace(
                direct_contribution_clamp=float(raw),
                indirect_contribution_clamp=float(raw))
            r.reset()
        elif key in _SETTINGS_KEYS:
            cur = getattr(r.settings, key)
            if isinstance(cur, bool):
                val = _flag(raw)
            elif isinstance(cur, int):
                val = int(float(raw))
            else:
                val = float(raw)
            r.settings = r.settings.replace(**{key: val})
            r.reset()
        else:
            r.reset()
        return None

    # performance presets (reference: ImGuiSettingsWindow::
    # apply_performance_preset, ImGuiSettingsWindow.cpp:498-580: resolution
    # scaling, target framerate, bounces, RIS candidate counts and the
    # direct-light strategy)
    _PRESETS = {
        "fastest": dict(scale=0.5, fps=25.0, bounces=1, bsdf_cand=0,
                        light_cand=1, strategy="RIS_BSDF_LIGHT"),
        "fast": dict(scale=0.75, fps=15.0, bounces=2, bsdf_cand=1,
                     light_cand=4, strategy="RIS_BSDF_LIGHT"),
        "medium": dict(scale=1.0, fps=5.0, bounces=2, bsdf_cand=1,
                       light_cand=8, strategy="RIS_BSDF_LIGHT"),
        "high_quality": dict(scale=1.0, fps=5.0, bounces=4, bsdf_cand=1,
                             light_cand=8, strategy="RESTIR_DI"),
    }

    def _renderer_at_scale(self, scale: float):
        """The renderer whose wavefront is scaled by ``scale`` (below 1 a
        smaller grid sharing the base BVH, so a 0.5 preset does about a
        quarter of the work), carrying the current renderer's scene,
        options, settings, world and camera."""
        from ..render.renderer import Renderer

        cur = self.renderer
        b = self._base_renderer
        if scale >= 1.0:
            r = b
        else:
            key = round(scale, 3)
            if key not in self._scaled_renderers:
                w2 = max(16, (int(b.width * scale) // 8) * 8)
                h2 = max(16, (int(b.height * scale) // 8) * 8)
                self._scaled_renderers[key] = Renderer(
                    cur.scene, cur.camera, w2, h2, options=cur.options,
                    settings=cur.settings, world=cur.world, bvh=b.bvh,
                    seed=b.seed)
            r = self._scaled_renderers[key]
        if r is not cur:
            r.scene = cur.scene
            r.options = cur.options
            r.camera = cur.camera
            r.world = cur.world
            r.settings = cur.settings
            r.reset()
        return r

    def _apply_performance_preset(self, name: str) -> bool:
        from ..core.settings import LightSamplingStrategy

        if name in ("none", ""):
            return True
        p = self._PRESETS.get(name)
        if p is None:
            return False
        self.target_framerate = p["fps"]
        with self._frame_lock():
            r = self._renderer_at_scale(p["scale"])
            self.renderer = r
            r.settings = r.settings.replace(
                nb_bounces=p["bounces"],
                # the wavefront itself is scaled; pixel masking stays off
                render_low_resolution=False, low_resolution_scale=1,
                ris=dataclasses.replace(
                    r.settings.ris,
                    number_of_bsdf_candidates=p["bsdf_cand"],
                    number_of_light_candidates=p["light_cand"]))
            strategy = getattr(LightSamplingStrategy, p["strategy"])
            if strategy != r.options.direct_light_sampling:
                r.recompile(r.options.replace(direct_light_sampling=strategy))
        return True

    # --- static options panel (reference: per-option macro editing in the
    # ImGui settings window; each edit = recompile_kernels) ---

    def _options_json(self) -> str:
        opts = self.renderer.options
        out = {}
        for f in dataclasses.fields(opts):
            v = getattr(opts, f.name)
            if isinstance(v, enum.Enum):
                out[f.name] = {"value": v.name,
                               "choices": [m.name for m in type(v)]}
            else:
                out[f.name] = {"value": v}
        return json.dumps(out)

    def _set_option(self, key: str, raw: str):
        """Parse and apply one static option; returns an error string or
        None. Enum fields take member names; bools 0/1/true/false."""
        opts = self.renderer.options
        if key not in {f.name for f in dataclasses.fields(opts)}:
            return f"unknown option {key!r}"
        cur = getattr(opts, key)
        try:
            if isinstance(cur, enum.Enum):
                val = type(cur)[raw]
            elif isinstance(cur, bool):
                val = _flag(raw)
            elif isinstance(cur, int):
                val = int(raw)
            else:
                val = type(cur)(raw)
        except (KeyError, ValueError) as e:
            return f"bad value for {key}: {e!r}"
        with self._frame_lock():
            self.renderer.recompile(opts.replace(**{key: val}))
        return None

    def _kernels_json(self) -> str:
        """The routed kernels' registers and occupancy (reference: the
        "Shader kernels" panel, ImGuiSettingsWindow.cpp:2206)."""
        with self._frame_lock(), _on_device(self.renderer.device):
            return json.dumps(self.renderer.kernel_stats())

    def _bias_json(self) -> str:
        from ..restir.bias import bias_status

        r = self.renderer
        return json.dumps(bias_status(r.options, r.settings))

    def _stats(self) -> str:
        r = self._snapshot()
        st = r.state
        return json.dumps({
            "samples": st.sample_count,
            "resolution": [r.width, r.height],
            "rays_traced": float(int(st.rays_traced)),
            "pixels_converged": int(st.nb_pixels_converged),
            "frame_ms_avg": round(r.metrics.get_average("frame_ms"), 2),
            "frame_ms_stddev": round(r.metrics.get_stddev("frame_ms"), 2),
            "samples_per_s": round(r.metrics.get_average("samples_per_s"), 3),
        })

    def _perf_json(self, query) -> str:
        """Performance panel data (reference: the performance plots and
        per-kernel event times, GPUKernel.cpp:180-189): the metrics' windowed
        series and, with ?passes=1, a fresh per-pass breakdown
        (Renderer.profile, which steps a private copy of the state: a frame
        in flight skews its times, nothing else)."""
        r = self.renderer
        m = r.metrics
        out = {"series": {
            name: {"values": m.values(name),
                   "avg": round(m.get_average(name), 3),
                   "stddev": round(m.get_stddev(name), 3),
                   "min": round(m.get_min(name), 3),
                   "max": round(m.get_max(name), 3)}
            for name in m.names()}}
        if parse_qs(query).get("passes", ["0"])[0] in ("1", "true"):
            with _on_device(r.device):
                out["passes_ms"] = {k: round(v, 2)
                                    for k, v in r.profile(frames=1).items()}
        return json.dumps(out)

    def _bake(self, q) -> str:
        """The baking window (reference: ImGuiBakingWindow.cpp:24-366):
        a LUT bake on a background thread on the renderer's device, polled.
        ?what= conductor|glossy_dielectric|glossy_base|fresnel|glass|
        glass_inv|thin_glass, optional res=/samples=/out=. No args: the
        status."""
        what = q.get("what", [""])[0]
        if not what:
            return json.dumps(self._bake_status)
        if self._bake_status.get("state") == "running":
            return json.dumps({"error": "bake already running",
                               **self._bake_status})
        res = int(q.get("res", ["16"])[0])
        samples = int(q.get("samples", ["2048"])[0])
        out = q.get("out", [""])[0]
        device = self.renderer.device

        def run():
            from ..bake import baker

            fns = {
                "conductor": baker.bake_ggx_conductor_ess,
                "glossy_dielectric": baker.bake_ggx_glossy_dielectric_ess,
                "glossy_base": baker.bake_glossy_base_ess,
                "fresnel": baker.bake_ggx_fresnel_ess,
                "glass": baker.bake_ggx_glass_ess,
                "glass_inv": baker.bake_ggx_glass_inv_ess,
                "thin_glass": baker.bake_ggx_thin_glass_ess,
            }
            t0 = time.perf_counter()
            try:
                with _on_device(device):
                    table = fns[what](res=res, n_samples=samples, device=device)
                if out:
                    baker.save_lut(table, out)
                self._bake_status = {
                    "state": "done", "what": what, "shape": list(table.shape),
                    "out": out or None,
                    "seconds": time.perf_counter() - t0}
            except Exception as e:  # reported through the status poll
                self._bake_status = {"state": "error", "what": what,
                                     "error": repr(e)}

        self._bake_status = {"state": "running", "what": what, "res": res,
                             "samples": samples}
        threading.Thread(target=run, daemon=True).start()
        return json.dumps(self._bake_status)

    def _animate(self, q) -> str:
        """The animation window (reference: ImGuiAnimationWindow.cpp:20-266):
        a frame sequence with camera and envmap animation, ?frames=N&spp=S
        &out=dir [&orbit_deg=D][&envmap_deg=D][&denoise=1]. The job holds
        the renderer (and the frame lock) until it is done; the progressive
        loop yields. No args: the status."""
        if "frames" not in q:
            return json.dumps(self._anim_status)
        if self._anim_status.get("state") == "running":
            return json.dumps({"error": "animation already running",
                               **self._anim_status})
        frames = int(q.get("frames", ["4"])[0])
        spp = int(q.get("spp", ["4"])[0])
        out = q.get("out", [os.path.join(tempfile.gettempdir(),
                                         "hiprt_pt_anim")])[0]
        orbit_deg = float(q.get("orbit_deg", ["0"])[0])
        envmap_deg = float(q.get("envmap_deg", ["0"])[0])
        do_denoise = q.get("denoise", ["0"])[0] in ("1", "true")

        def run():
            from ..render.animation import (CameraOrbitAnimation,
                                            EnvmapRotationAnimation,
                                            render_frame_sequence)

            self._busy.set()
            t0 = time.perf_counter()
            try:
                with self._frame_lock(), _on_device(self.renderer.device):
                    cam_anim = (CameraOrbitAnimation(
                        target=(0.0, 0.0, 0.0), degrees_per_frame=orbit_deg)
                        if orbit_deg else None)
                    env_anim = (EnvmapRotationAnimation(
                        yaw_degrees_per_frame=envmap_deg)
                        if envmap_deg else None)
                    paths = render_frame_sequence(
                        self.renderer, frames, spp, out,
                        camera_animation=cam_anim, envmap_animation=env_anim,
                        denoise_frames=do_denoise)
                self._anim_status = {"state": "done", "frames": len(paths),
                                     "out": out, "paths": paths,
                                     "seconds": time.perf_counter() - t0}
            except Exception as e:  # reported through the status poll
                self._anim_status = {"state": "error", "error": repr(e)}
            finally:
                self._busy.clear()

        self._anim_status = {"state": "running", "frames": frames,
                             "spp": spp, "out": out}
        threading.Thread(target=run, daemon=True).start()
        return json.dumps(self._anim_status)

    def serve(self, blocking: bool = True):
        """Start the render loop and the HTTP server on (host, port); port
        0 takes a free port (``_httpd.server_address[1]``). Blocking: serve
        until interrupted, then stop."""
        viewer = self
        routes = {
            "/stats": lambda u: viewer._stats(),
            "/settings": lambda u: viewer._settings_json(),
            "/options": lambda u: viewer._options_json(),
            "/kernels": lambda u: viewer._kernels_json(),
            "/bias": lambda u: viewer._bias_json(),
            "/materials": lambda u: viewer._materials_json(),
            "/perf": lambda u: viewer._perf_json(u.query),
            "/control": lambda u: viewer._control(parse_qs(u.query)),
            "/bake": lambda u: viewer._bake(parse_qs(u.query)),
            "/animate": lambda u: viewer._animate(parse_qs(u.query)),
        }

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    body, ctype = _PAGE.encode(), "text/html"
                elif u.path == "/image":
                    view = parse_qs(u.query).get("view", ["beauty"])[0]
                    body, ctype = viewer._image_png(view), "image/png"
                elif u.path in routes:
                    body = routes[u.path](u).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._render_thread = threading.Thread(target=self._render_loop,
                                               daemon=True)
        self._render_thread.start()
        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        if blocking:
            try:
                self._httpd.serve_forever()
            finally:
                self.stop()
        else:
            self._serve_thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True)
            self._serve_thread.start()
        return self

    def stop(self, timeout: float = 120.0):
        """Stop the render loop and the server and wait for both threads
        (the loop ends its frame first)."""
        self._stop.set()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        for t in (self._render_thread, self._serve_thread):
            if t is not None and t is not threading.current_thread():
                t.join(timeout)
