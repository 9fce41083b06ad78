"""The procedural Cornell box with seven principled spheres (35,852
triangles), frozen from the port's maker. Numpy only."""

from __future__ import annotations

import numpy as np

from .stress import _icosphere

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
