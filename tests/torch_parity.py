"""Shared inputs for the parity tests of the PyTorch port (test_torch_*.py).

Both packages get the same inputs: the stress interior at a small size,
built by the JAX package and carried into the port through
hiprt_pt_tpu_torch.interop, and rays made with numpy from a seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# the procedural Cornell scene lives in the port; tests use it from here
from hiprt_pt_tpu_torch.assets.cornell import (  # noqa: F401
    CORNELL_SPHERE_ROWS, cornell_spheres_arrays)

# ~122k triangles (the feature spheres do not scale) and 120 emitters
TRI_SCALE = 0.01
# rays start inside the hall: x in [-10, 10], y in [0, 6], z in [-6, 6]
HALL_LO = np.asarray([-9.5, 0.4, -5.5], np.float32)
HALL_HI = np.asarray([9.5, 5.5, 5.5], np.float32)


def to_numpy_dict(obj):
    """A flax struct (or any dataclass) of JAX arrays → nested numpy dict."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = to_numpy_dict(v)
        elif v is None or isinstance(v, (int, float, bool, tuple, str)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def jax_stress(aspect: float = 1.0, with_textures: bool = False):
    """(SceneData, Camera, BVHData) of the JAX package."""
    from hiprt_pt_tpu.accel.build import build_bvh
    from hiprt_pt_tpu.assets.stress import load_stress_scene

    scene, cam = load_stress_scene(aspect=aspect, tri_scale=TRI_SCALE,
                                   with_textures=with_textures)
    bvh = build_bvh(np.asarray(scene.vertices), np.asarray(scene.triangles))
    return scene, cam, bvh


def bvh_dict(bvh) -> dict:
    """The JAX package's BVH tables that the port reads, as numpy."""
    d = {k: np.asarray(getattr(bvh, k))
         for k in ("nodes4", "leaf_rows", "tri_rows", "nodes8l", "leaf_rows8",
                   "nodes_lane8", "leaves_lane8")}
    return d | {"depth8": bvh.depth8, "lane8_depth": bvh.lane8_depth}


def port_of(scene, cam, bvh):
    """The port's (SceneData, Camera, BVHData) holding the same arrays."""
    from hiprt_pt_tpu_torch import interop
    from hiprt_pt_tpu_torch.core.camera import Camera

    tscene = interop.scene_from_numpy(to_numpy_dict(scene), "cpu")
    tbvh = interop.bvh_from_numpy(bvh_dict(bvh), "cpu")
    tcam = Camera.from_matrices(
        np.asarray(cam.view), np.asarray(cam.view_inv), np.asarray(cam.proj),
        np.asarray(cam.proj_inv), float(cam.vfov), float(cam.near),
        float(cam.far), bool(cam.do_jitter), device="cpu")
    return tscene, tcam, tbvh


def camera_rays_np(cam, width: int, height: int):
    """Camera rays (tile-major order, pixel centers) from the JAX package,
    as numpy (o, d)."""
    from hiprt_pt_tpu.core.camera import generate_camera_rays
    from hiprt_pt_tpu.ops.pixel_order import pixel_coords

    px, py = pixel_coords(width, height)
    o, d = generate_camera_rays(cam, width, height, None, px, py)
    return np.asarray(o, np.float32), np.asarray(d, np.float32)


def camera_rays_np_torch(cam, width: int, height: int):
    """Camera rays (tile-major order, pixel centers) from the port's
    camera, as numpy (o, d)."""
    from hiprt_pt_tpu_torch.core.camera import generate_camera_rays
    from hiprt_pt_tpu_torch.ops.pixel_order import pixel_coords

    px, py = pixel_coords(width, height, cam.view.device)
    o, d = generate_camera_rays(cam, width, height, None, px, py)
    return o.cpu().numpy(), d.cpu().numpy()


def incoherent_rays_np(n: int, seed: int):
    """Origins uniform in the hall, directions uniform on the sphere."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(HALL_LO, HALL_HI, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def prim_agreement(a, b) -> float:
    return float(np.mean(np.asarray(a) == np.asarray(b)))


def write_cornell_glb(path: str, aspect: float) -> str:
    """The procedural Cornell box (35,852 triangles, its lights and spheres)
    written as a .glb at ``path`` with its camera; both packages' loaders
    read it. Returns ``path``."""
    from hiprt_pt_tpu_torch.assets.gltf import ParsedScene
    from hiprt_pt_tpu_torch.assets.gltf_testscene import write_glb
    from hiprt_pt_tpu_torch.core.camera import camera_from_lookat

    v, f, m, rows, cam = cornell_spheres_arrays(aspect)
    write_glb(path, ParsedScene(
        vertices=v, triangles=f, normals=None, uvs=None, material_ids=m,
        material_rows=[dict(r) for r in rows],
        camera=camera_from_lookat(**cam, device="cpu"), images=[]))
    return path


# --- the JAX package's own spread, the yardstick of the port's bakes ---

# the shipped tables that a fresh bake can be held against: name -> (the JAX
# package's bake function, its keyword arguments at bake_all's sizes)
SHIPPED_BAKES = {
    "data_ggx_conductor_ess_32": ("bake_ggx_conductor_ess", {"res": 32}),
    "data_ggx_glass_ess_16": ("bake_ggx_glass_ess", {"res": 16}),
    "data_ggx_glass_inv_ess_16": ("bake_ggx_glass_inv_ess", {"res": 16}),
    "data_ggx_thin_glass_ess_16": ("bake_ggx_thin_glass_ess", {"res": 16}),
    "data_glossy_base_ess_16": ("bake_glossy_base_ess", {"res": 16}),
}
# the sheen table's cells whose fit is compared: the lobe carries energy
SHEEN_R_MIN = 0.01


def sheen_table_diff(a: np.ndarray, b: np.ndarray) -> dict:
    """Per channel (Ai, Bi, R) of two (32, 32, 3) sheen tables, the max and
    median |a - b| over the cells where both have R >= SHEEN_R_MIN."""
    cells = (a[..., 2] >= SHEEN_R_MIN) & (b[..., 2] >= SHEEN_R_MIN)
    out = {"cells": int(cells.sum())}
    for ch, name in enumerate(("Ai", "Bi", "R")):
        d = np.abs(a[..., ch] - b[..., ch])[cells]
        out[name] = {"max": float(d.max()), "median": float(np.median(d))}
    return out


def jax_spread(seeds=(1234, 99991), n_paths: int = 32768) -> dict:
    """The JAX package on this host's CPU: each shipped bake table baked
    afresh at bake_all's sizes (max |fresh - shipped| and seconds), and the
    sheen fit (run_fit) at ``n_paths`` under two seeds, compared with each
    other and with the shipped table by sheen_table_diff."""
    import os
    import time

    from hiprt_pt_tpu.bake import baker, sheen_ltc_fit

    bake_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "hiprt_pt_tpu", "bake")
    out = {"bakes": {}}
    for name, (fn, kw) in SHIPPED_BAKES.items():
        t0 = time.perf_counter()
        fresh = getattr(baker, fn)(**kw)
        shipped = np.load(os.path.join(bake_dir, name + ".npy"))
        out["bakes"][name] = {
            "max_abs_diff": float(np.abs(fresh - shipped).max()),
            "seconds": time.perf_counter() - t0}
        print(name, out["bakes"][name], flush=True)
    shipped = np.load(sheen_ltc_fit.OUT_PATH)
    tables = []
    for seed in seeds:
        t0 = time.perf_counter()
        tables.append(sheen_ltc_fit.run_fit(n_paths=n_paths, seed=seed,
                                            verbose=False))
        out[f"sheen_seed_{seed}_seconds"] = time.perf_counter() - t0
        out[f"sheen_seed_{seed}_vs_shipped"] = sheen_table_diff(tables[-1],
                                                                shipped)
        print(seed, out[f"sheen_seed_{seed}_vs_shipped"], flush=True)
    out["sheen_seed_to_seed"] = sheen_table_diff(tables[0], tables[1])
    out["n_paths"], out["seeds"] = n_paths, list(seeds)
    return out


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/torch_parity.py [out.json]: the JAX
    # package's fresh-vs-shipped bake gaps and the sheen fit's seed-to-seed
    # spread (PERF.md cites its numbers)
    import json
    import sys

    result = jax_spread()
    print(json.dumps(result))
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(result, f, indent=1)
