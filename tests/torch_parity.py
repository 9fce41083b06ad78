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
