"""Scene file loading front-end, mirroring ``hiprt_pt_tpu.assets.loader`` —
the analog of SceneParser::parse_scene_file (src/Scene/SceneParser.cpp:
22-220): parse, build the texture atlas, flatten to SceneData, extract the
camera (with bbox-default fallback).

- the reference's parse-failure fallback chain (SceneParser.cpp:26-41): a
  scene that fails to parse falls back to a procedural default Cornell box
  (12 triangles) with a warning; if even that fails the loader hard-exits.
- keyed-thread pipelining (reference: main.cpp:55-67 + SceneParser texture
  threads): the texture atlas and the BVH build overlap on the
  utils/threads.py ThreadManager (``load_scene_file(..., parallel=True,
  with_bvh=True)``). The BVH thread builds on the host and copies its
  tables to the explicit ``device``, never to the thread's current device.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np

from ..core.camera import camera_from_lookat
from ..core.device import resolve_device
from ..core.material import MaterialBank
from ..utils.threads import (
    RENDERER_BUILD_BVH,
    SCENE_TEXTURES_LOADING,
    ThreadManager,
)
from .gltf import ParsedScene, load_gltf
from .scene import build_scene
from .textures import build_texture_atlas, srgb_texture_indices


def default_scene_parsed(aspect: float = 1.0) -> ParsedScene:
    """Procedural Cornell box — the reference's fallback scene when parsing
    fails (SceneParser.cpp:26-41 falls back to a known-good default)."""
    s = 1.0
    v = np.asarray(
        [
            # floor
            [-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s],
            # ceiling
            [-s, 2 * s, -s], [s, 2 * s, -s], [s, 2 * s, s], [-s, 2 * s, s],
            # back wall
            [-s, 0, -s], [s, 0, -s], [s, 2 * s, -s], [-s, 2 * s, -s],
            # left (red) / right (green)
            [-s, 0, -s], [-s, 0, s], [-s, 2 * s, s], [-s, 2 * s, -s],
            [s, 0, -s], [s, 0, s], [s, 2 * s, s], [s, 2 * s, -s],
            # light panel
            [-0.3, 2 * s - 1e-3, -0.3], [0.3, 2 * s - 1e-3, -0.3],
            [0.3, 2 * s - 1e-3, 0.3], [-0.3, 2 * s - 1e-3, 0.3],
        ],
        np.float32,
    )
    quads = [(0, 1, 2, 3), (7, 6, 5, 4), (8, 9, 10, 11),
             (12, 13, 14, 15), (19, 18, 17, 16), (20, 23, 22, 21)]
    mat_of_quad = [0, 0, 0, 1, 2, 3]
    tris = []
    mids = []
    for q, m in zip(quads, mat_of_quad):
        tris.append([q[0], q[1], q[2]])
        tris.append([q[0], q[2], q[3]])
        mids += [m, m]
    mats = [
        dict(base_color=[0.73, 0.73, 0.73]),
        dict(base_color=[0.65, 0.05, 0.05]),
        dict(base_color=[0.12, 0.45, 0.15]),
        dict(base_color=[1, 1, 1], emission=[1, 1, 1],
             emission_strength=15.0),
    ]
    cam = camera_from_lookat(
        eye=(0.0, 1.0, 3.6), target=(0.0, 1.0, 0.0), vfov_deg=40.0,
        aspect=aspect, device="cpu",
    )
    return ParsedScene(
        vertices=v,
        triangles=np.asarray(tris, np.int64),
        normals=None,
        uvs=None,
        material_ids=np.asarray(mids, np.int32),
        material_rows=mats,
        camera=cam,
        images=[],
    )


def load_scene_file(
    path: str,
    aspect: Optional[float] = None,
    envmap=None,
    with_textures: bool = True,
    texture_size: int = 2048,
    parallel: bool = False,
    with_bvh: bool = False,
    device=None,
    timings: Optional[dict] = None,
):
    """Load a GLTF scene file → (SceneData, Camera) on ``device`` (default:
    the GPU, see core/device.py:resolve_device) or, with ``with_bvh``,
    (SceneData, Camera, BVHData). ``envmap``: an EnvmapData for the scene.
    Given ``timings``, adds the seconds of each stage to it: "parse" (the
    glTF file, images excluded), "images" (decoding them), "atlas",
    "bvh" (build and copy to the device), "scene" (build_scene) and
    "total"; with ``parallel`` the atlas and the BVH overlap.

    Failure chain (reference: SceneParser.cpp:26-41): parse error → warn +
    procedural default scene; default-scene failure → hard exit."""
    device = resolve_device(device)
    spent = {} if timings is None else timings
    t0 = time.perf_counter()
    try:
        parsed = load_gltf(path, aspect_override=aspect, timings=spent)
    except Exception as e:  # noqa: BLE001 — reference falls back on any error
        print(
            f"[loader] failed to parse '{path}' ({e!r}); falling back to the "
            "default scene (reference: SceneParser.cpp:26-41)",
            file=sys.stderr,
        )
        try:
            parsed = default_scene_parsed(aspect or 1.0)
        except Exception as e2:  # pragma: no cover — mirrors hard exit
            print(f"[loader] default scene failed too: {e2!r}",
                  file=sys.stderr)
            raise SystemExit(1)
    spent["parse"] = time.perf_counter() - t0 - spent.get("images", 0.0)

    def timed(key, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        spent[key] = time.perf_counter() - t
        return out

    tm = ThreadManager(monothread=not parallel)

    if with_textures and parsed.images:
        tm.start_thread(
            SCENE_TEXTURES_LOADING,
            timed,
            "atlas",
            build_texture_atlas,
            parsed.images,
            srgb_texture_indices(parsed.material_rows),
            texture_size,
        )

    if with_bvh:
        from ..accel.build import build_bvh

        tm.start_thread(
            RENDERER_BUILD_BVH,
            timed,
            "bvh",
            build_bvh,
            np.asarray(parsed.vertices),
            np.asarray(parsed.triangles),
            device,
        )

    tm.join_threads(SCENE_TEXTURES_LOADING)
    atlases = tm.results(SCENE_TEXTURES_LOADING)
    atlas = atlases[0] if atlases else None

    scene = timed(
        "scene",
        build_scene,
        parsed.vertices,
        parsed.triangles,
        parsed.material_ids,
        MaterialBank.from_rows(parsed.material_rows),
        parsed.normals,
        parsed.uvs,
        atlas,
        envmap,
        device,
    )
    camera = parsed.camera.to(device)
    if with_bvh:
        tm.join_threads(RENDERER_BUILD_BVH)
        bvh = tm.results(RENDERER_BUILD_BVH)[0]
        spent["total"] = time.perf_counter() - t0
        return scene, camera, bvh
    spent["total"] = time.perf_counter() - t0
    return scene, camera
