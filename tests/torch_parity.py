"""Shared inputs for the parity tests of the PyTorch port (test_torch_*.py).

Both packages get the same inputs: the stress interior at a small size,
built by the JAX package and carried into the port through
hiprt_pt_tpu_torch.interop, and rays made with numpy from a seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# ~122k triangles (the feature spheres do not scale) and 120 emitters
TRI_SCALE = 0.01
# rays start inside the hall: x in [-10, 10], y in [0, 6], z in [-6, 6]
HALL_LO = np.asarray([-9.5, 0.4, -5.5], np.float32)
HALL_HI = np.asarray([9.5, 5.5, 5.5], np.float32)


def _icosphere(subdiv: int):
    """Unit icosphere (the stress scene's), numpy only: (verts, faces)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.asarray([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                    [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                    [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.asarray([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                    [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                    [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                    [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                   np.int64)
    for _ in range(subdiv):
        cache, verts = {}, list(v)

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                cache[key] = len(verts) - 1
            return cache[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v, f = np.asarray(verts, np.float32), np.asarray(nf, np.int64)
    return v, f


# the stress scene's seven principled prop materials (brushed metal, gold,
# clear glass with dispersion, rough glass, coated paint, velvet, iridescent)
CORNELL_SPHERE_ROWS = [
    dict(base_color=[0.95, 0.93, 0.88], metallic=1.0, roughness=0.15,
         anisotropy=0.8, anisotropy_rotation=0.3),
    dict(base_color=[1.0, 0.77, 0.34], metallic=1.0, roughness=0.05),
    dict(base_color=[1, 1, 1], specular_transmission=1.0, ior=1.5,
         roughness=0.0, absorption_color=[0.9, 0.95, 0.95],
         absorption_at_distance=0.5, dispersion_scale=1.0),
    dict(base_color=[1, 1, 1], specular_transmission=1.0, ior=1.5,
         roughness=0.2, absorption_color=[0.6, 0.9, 0.7],
         absorption_at_distance=0.3),
    dict(base_color=[0.6, 0.1, 0.1], coat=1.0, coat_roughness=0.05,
         roughness=0.4),
    dict(base_color=[0.2, 0.25, 0.6], sheen=0.8, sheen_color=[0.9, 0.9, 1.0],
         roughness=0.7),
    dict(base_color=[0.1, 0.1, 0.1], thin_film=1.0, thin_film_thickness=420.0,
         thin_film_ior=1.6, metallic=1.0, roughness=0.1),
]


def cornell_spheres_arrays(aspect: float = 1.0):
    """The procedural Cornell scene, numpy only: a box (white floor,
    ceiling and back wall, red left and green right wall) widened in x to
    ``aspect``, a 0.6 x 0.6 ceiling light, and seven radius-0.22
    icospheres (subdivision 4) on a ring, one per CORNELL_SPHERE_ROWS
    material: 35,852 triangles. Returns (vertices (V,3) f32, triangles
    (T,3) i64, material ids (T,) i32, material rows, look-at camera kwargs)."""
    vs, fs, mids = [], [], []

    def quad(corners, mat):
        fs.append(np.asarray([[0, 1, 2], [0, 2, 3]], np.int64) + sum(map(len, vs)))
        vs.append(np.asarray(corners, np.float32))
        mids.extend([mat, mat])

    rows = [
        dict(base_color=[0.73, 0.73, 0.73], roughness=1.0, specular=0.0,
             oren_nayar_sigma=0.0),
        dict(base_color=[0.65, 0.05, 0.05], roughness=1.0, specular=0.0,
             oren_nayar_sigma=0.0),
        dict(base_color=[0.12, 0.45, 0.15], roughness=1.0, specular=0.0,
             oren_nayar_sigma=0.0),
        dict(base_color=[0, 0, 0], emission=[1.0, 0.9, 0.75],
             emission_strength=22.0, specular=0.0, oren_nayar_sigma=0.0),
    ] + CORNELL_SPHERE_ROWS
    x = float(max(aspect, 1.0))
    quad([[-x, 0, -1], [x, 0, -1], [x, 0, 1], [-x, 0, 1]], 0)      # floor
    quad([[-x, 2, -1], [-x, 2, 1], [x, 2, 1], [x, 2, -1]], 0)      # ceiling
    quad([[-x, 0, -1], [-x, 2, -1], [x, 2, -1], [x, 0, -1]], 0)    # back
    quad([[-x, 0, -1], [-x, 0, 1], [-x, 2, 1], [-x, 2, -1]], 1)    # left
    quad([[x, 0, -1], [x, 2, -1], [x, 2, 1], [x, 0, 1]], 2)        # right
    h = 1.99
    quad([[-0.3, h, -0.3], [0.3, h, -0.3], [0.3, h, 0.3], [-0.3, h, 0.3]], 3)
    sv, sf = _icosphere(4)
    for k in range(len(CORNELL_SPHERE_ROWS)):
        a = 2.0 * np.pi * k / len(CORNELL_SPHERE_ROWS)
        c = np.asarray([0.62 * x * np.cos(a), 0.3 + 0.25 * (k % 3),
                        0.5 * np.sin(a) - 0.1])
        fs.append(sf + sum(map(len, vs)))
        vs.append((sv * 0.22 + c).astype(np.float32))
        mids.extend([4 + k] * len(sf))
    camera = dict(eye=[0.0, 1.0, 3.4], target=[0.0, 0.9, 0.0], vfov_deg=40.0,
                  aspect=float(aspect))
    return (np.concatenate(vs, 0), np.concatenate(fs, 0),
            np.asarray(mids, np.int32), rows, camera)


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


def jax_stress(aspect: float = 1.0):
    """(SceneData, Camera, BVHData) of the JAX package."""
    from hiprt_pt_tpu.accel.build import build_bvh
    from hiprt_pt_tpu.assets.stress import load_stress_scene

    scene, cam = load_stress_scene(aspect=aspect, tri_scale=TRI_SCALE,
                                   with_textures=False)
    bvh = build_bvh(np.asarray(scene.vertices), np.asarray(scene.triangles))
    return scene, cam, bvh


def port_of(scene, cam, bvh):
    """The port's (SceneData, Camera, BVHData) holding the same arrays."""
    from hiprt_pt_tpu_torch import interop
    from hiprt_pt_tpu_torch.core.camera import Camera

    tscene = interop.scene_from_numpy(to_numpy_dict(scene))
    tbvh = interop.bvh_from_numpy({
        "nodes4": np.asarray(bvh.nodes4),
        "leaf_rows": np.asarray(bvh.leaf_rows),
        "tri_rows": np.asarray(bvh.tri_rows),
    })
    tcam = Camera.from_matrices(
        np.asarray(cam.view), np.asarray(cam.view_inv), np.asarray(cam.proj),
        np.asarray(cam.proj_inv), float(cam.vfov), float(cam.near),
        float(cam.far), bool(cam.do_jitter))
    return tscene, tcam, tbvh


def camera_rays_np(cam, width: int, height: int):
    """Camera rays (tile-major order, pixel centers) from the JAX package,
    as numpy (o, d)."""
    from hiprt_pt_tpu.core.camera import generate_camera_rays
    from hiprt_pt_tpu.ops.pixel_order import pixel_coords

    px, py = pixel_coords(width, height)
    o, d = generate_camera_rays(cam, width, height, None, px, py)
    return np.asarray(o, np.float32), np.asarray(d, np.float32)


def incoherent_rays_np(n: int, seed: int):
    """Origins uniform in the hall, directions uniform on the sphere."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(HALL_LO, HALL_HI, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def prim_agreement(a, b) -> float:
    return float(np.mean(np.asarray(a) == np.asarray(b)))
