"""The procedural stress interior, frozen from the port's maker with its
numbers unchanged: about 259k triangles and 120 area emitters at
``tri_scale=1``, deterministic under a fixed seed. Numpy only; the output
is a ``ParsedScene`` of host arrays with a look-at camera.
"""

from __future__ import annotations

import numpy as np

import dataclasses
from typing import Optional


@dataclasses.dataclass
class LookAtCamera:
    """A look-at camera as host matrices: the inverse view (camera to
    world, looking down -Z) and the projection, with its vertical field of
    view (radians) and clip planes."""

    view_inv: np.ndarray
    proj: np.ndarray
    vfov: float
    near: float = 0.1
    far: float = 100.0


def camera_from_lookat(eye, target, up=(0.0, 1.0, 0.0), vfov_deg=45.0,
                       aspect=1.0, near=0.1, far=100.0) -> LookAtCamera:
    """The camera at ``eye`` looking at ``target`` (f32 matrices)."""
    eye = np.asarray(eye, dtype=np.float32)
    target = np.asarray(target, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    view_inv = np.eye(4, dtype=np.float32)
    view_inv[:3, 0] = right
    view_inv[:3, 1] = true_up
    view_inv[:3, 2] = -fwd
    view_inv[:3, 3] = eye
    # as the renderer's camera holds it: the view, inverted back
    view_inv = np.linalg.inv(np.linalg.inv(view_inv).astype(np.float32))
    vfov = np.deg2rad(vfov_deg)
    f = 1.0 / np.tan(vfov / 2.0)
    proj = np.zeros((4, 4), dtype=np.float32)
    proj[0, 0] = f / aspect
    proj[1, 1] = f
    proj[2, 2] = (far + near) / (near - far)
    proj[2, 3] = (2.0 * far * near) / (near - far)
    proj[3, 2] = -1.0
    return LookAtCamera(view_inv, proj, float(vfov), near, far)


@dataclasses.dataclass
class ParsedScene:
    """Host arrays of a scene, as the glTF writer takes them."""

    vertices: np.ndarray
    triangles: np.ndarray
    normals: Optional[np.ndarray]
    uvs: Optional[np.ndarray]
    material_ids: np.ndarray
    material_rows: list
    camera: Optional[LookAtCamera]
    images: list = dataclasses.field(default_factory=list)

# ----------------------------------------------------------- geometry helpers


class _Builder:
    def __init__(self):
        self.verts = []
        self.tris = []
        self.uvs = []
        self.mat_ids = []
        self.nv = 0

    def add(self, v, f, uv, mat_id):
        v = np.asarray(v, np.float32)
        f = np.asarray(f, np.int64)
        uv = np.asarray(uv, np.float32)
        self.verts.append(v)
        self.tris.append(f + self.nv)
        self.uvs.append(uv)
        self.mat_ids.append(np.full((f.shape[0],), mat_id, np.int32))
        self.nv += v.shape[0]

    def finish(self):
        return (
            np.concatenate(self.verts, 0),
            np.concatenate(self.tris, 0),
            np.concatenate(self.uvs, 0),
            np.concatenate(self.mat_ids, 0),
        )


def _grid(nx, nz, scale_u=1.0, scale_v=1.0):
    """Unit grid in the XZ plane: verts (N,3) y=0, faces, uv."""
    xs = np.linspace(0, 1, nx + 1, dtype=np.float32)
    zs = np.linspace(0, 1, nz + 1, dtype=np.float32)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    v = np.stack([X, np.zeros_like(X), Z], -1).reshape(-1, 3)
    uv = np.stack([X * scale_u, Z * scale_v], -1).reshape(-1, 2)
    idx = np.arange((nx + 1) * (nz + 1)).reshape(nx + 1, nz + 1)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[:-1, 1:].ravel()
    d = idx[1:, 1:].ravel()
    f = np.concatenate(
        [np.stack([a, b, d], -1), np.stack([a, d, c], -1)], 0
    )
    return v, f, uv


def _value_noise(rng, n, octaves=4):
    """(n, n) tileable-ish value noise in [0,1]."""
    out = np.zeros((n, n), np.float32)
    amp = 1.0
    for o in range(octaves):
        res = 2 ** (o + 2)
        g = rng.random((res, res)).astype(np.float32)
        # bilinear upsample to n
        xi = np.linspace(0, res - 1, n)
        x0 = np.floor(xi).astype(int) % res
        x1 = (x0 + 1) % res
        fx = (xi - np.floor(xi)).astype(np.float32)
        gx = g[x0][:, x0 * 0]  # placeholder to keep shapes; do full 2D below
        a = g[np.ix_(x0, x0)]
        b = g[np.ix_(x1, x0)]
        c = g[np.ix_(x0, x1)]
        d = g[np.ix_(x1, x1)]
        w = (
            a * np.outer(1 - fx, 1 - fx)
            + b * np.outer(fx, 1 - fx)
            + c * np.outer(1 - fx, fx)
            + d * np.outer(fx, fx)
        )
        out += amp * w
        amp *= 0.5
    out -= out.min()
    out /= max(out.max(), 1e-6)
    return out


def _heightfield(builder, origin, size, nx, nz, height, noise, mat_id,
                 flip=False):
    v, f, uv = _grid(nx, nz, scale_u=6.0, scale_v=6.0)
    hx = np.clip((v[:, 0] * (noise.shape[0] - 1)).astype(int), 0,
                 noise.shape[0] - 1)
    hz = np.clip((v[:, 2] * (noise.shape[1] - 1)).astype(int), 0,
                 noise.shape[1] - 1)
    h = noise[hx, hz] * height
    vv = np.stack(
        [
            origin[0] + v[:, 0] * size[0],
            origin[1] + (h if not flip else -h),
            origin[2] + v[:, 2] * size[1],
        ],
        -1,
    )
    if flip:
        f = f[:, ::-1]
    builder.add(vv, f, uv, mat_id)


def _wall(builder, p0, p1, height, n, mat_id, y0=0.0):
    """Vertical subdivided wall from p0 to p1 (XZ points)."""
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    v, f, uv = _grid(n, n, scale_u=4.0, scale_v=2.0)
    along = v[:, 0:1]
    up = v[:, 2:3]
    pos = np.concatenate(
        [
            p0[0] + along * (p1[0] - p0[0]),
            y0 + up * height,
            p0[1] + along * (p1[1] - p0[1]),
        ],
        -1,
    )
    builder.add(pos, f, uv, mat_id)


def _cylinder(builder, center, radius, height, segs, rings, mat_id):
    th = np.linspace(0, 2 * np.pi, segs, endpoint=False)
    ys = np.linspace(0, height, rings + 1, dtype=np.float32)
    ring = np.stack(
        [np.cos(th) * radius, np.zeros_like(th), np.sin(th) * radius], -1
    ).astype(np.float32)
    verts = []
    uvs = []
    for i, y in enumerate(ys):
        r = ring.copy()
        r[:, 1] = y
        verts.append(r + np.asarray(center, np.float32))
        uvs.append(
            np.stack([th / (2 * np.pi) * 3.0,
                      np.full_like(th, y / height * 2.0)], -1)
        )
    v = np.concatenate(verts, 0)
    uv = np.concatenate(uvs, 0).astype(np.float32)
    f = []
    for i in range(rings):
        base0 = i * segs
        base1 = (i + 1) * segs
        for j in range(segs):
            j2 = (j + 1) % segs
            f.append([base0 + j, base1 + j, base1 + j2])
            f.append([base0 + j, base1 + j2, base0 + j2])
    builder.add(v, np.asarray(f), uv, mat_id)


def _icosphere(subdiv):
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.asarray(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float32,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.asarray(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdiv):
        cache = {}
        verts = list(v)

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key in cache:
                return cache[key]
            m = verts[a] + verts[b]
            m = m / np.linalg.norm(m)
            verts.append(m)
            cache[key] = len(verts) - 1
            return cache[key]

        nf = []
        for (a, b, c) in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(verts, np.float32)
        f = np.asarray(nf, np.int64)
    return v, f


def _sphere(builder, center, radius, subdiv, mat_id):
    v, f = _icosphere(subdiv)
    uv = np.stack(
        [
            (np.arctan2(v[:, 2], v[:, 0]) / (2 * np.pi) + 0.5) * 2.0,
            (np.arcsin(np.clip(v[:, 1], -1, 1)) / np.pi + 0.5) * 2.0,
        ],
        -1,
    ).astype(np.float32)
    builder.add(v * radius + np.asarray(center, np.float32), f, uv, mat_id)


def _box(builder, center, size, n, mat_id):
    cx, cy, cz = center
    sx, sy, sz = size
    for axis, sign in [(0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)]:
        v, f, uv = _grid(n, n, 2.0, 2.0)
        u = v[:, 0] - 0.5
        w = v[:, 2] - 0.5
        if axis == 0:
            pos = np.stack([np.full_like(u, 0.5 * sign), u, w], -1)
        elif axis == 1:
            pos = np.stack([u, np.full_like(u, 0.5 * sign), w], -1)
        else:
            pos = np.stack([u, w, np.full_like(u, 0.5 * sign)], -1)
        if sign < 0:
            f = f[:, ::-1]
        pos = pos * np.asarray(size, np.float32) + np.asarray(
            center, np.float32
        )
        builder.add(pos, f, uv, mat_id)


# ----------------------------------------------------------- texture helpers


def _tex_checker(n, c0, c1, tiles):
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    m = (((xx * tiles // n) + (yy * tiles // n)) % 2).astype(np.float32)
    img = np.outer(1 - m.ravel(), c0) + np.outer(m.ravel(), c1)
    return img.reshape(n, n, 3)


def _tex_stripes(n, c0, c1, stripes, diag=False):
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    t = (xx + yy) if diag else xx
    m = ((t * stripes // n) % 2).astype(np.float32)
    img = np.outer(1 - m.ravel(), c0) + np.outer(m.ravel(), c1)
    return img.reshape(n, n, 3)


def _tex_noise(rng, n, c0, c1, octaves=4):
    w = _value_noise(rng, n, octaves)[..., None]
    return (1 - w) * np.asarray(c0) + w * np.asarray(c1)


def _tex_bricks(n, mortar, brick, rows):
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    bh = n // rows
    bw = bh * 2
    row = yy // bh
    xoff = (row % 2) * (bw // 2)
    in_mortar = (
        ((yy % bh) < max(bh // 8, 1))
        | (((xx + xoff) % bw) < max(bw // 10, 1))
    )
    img = np.where(in_mortar[..., None], np.asarray(mortar), np.asarray(brick))
    return img.astype(np.float32)


def _to_u8(img):
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def _make_textures(rng, size=256):
    """≥16 procedural textures as (H,W,4) uint8 RGBA, is_srgb flags."""
    texs = []

    def add(rgb, srgb=True):
        # srgb-ness is decided by USAGE (srgb_texture_indices scans which
        # material fields reference each index), so only the array is kept
        del srgb
        a = np.concatenate(
            [_to_u8(rgb), np.full((size, size, 1), 255, np.uint8)], -1
        )
        texs.append(a)

    add(_tex_checker(size, [0.9, 0.9, 0.88], [0.15, 0.15, 0.18], 16))
    add(_tex_checker(size, [0.7, 0.5, 0.3], [0.3, 0.2, 0.12], 8))
    add(_tex_bricks(size, [0.75, 0.73, 0.7], [0.55, 0.24, 0.18], 12))
    add(_tex_bricks(size, [0.6, 0.6, 0.62], [0.35, 0.35, 0.4], 20))
    add(_tex_stripes(size, [0.8, 0.76, 0.7], [0.5, 0.42, 0.35], 24))
    add(_tex_stripes(size, [0.2, 0.3, 0.45], [0.7, 0.75, 0.8], 10, diag=True))
    add(_tex_noise(rng, size, [0.45, 0.3, 0.2], [0.75, 0.6, 0.45]))   # wood-ish
    add(_tex_noise(rng, size, [0.85, 0.85, 0.88], [0.55, 0.56, 0.6]))  # marble
    add(_tex_noise(rng, size, [0.2, 0.4, 0.25], [0.5, 0.7, 0.5], 5))
    add(_tex_noise(rng, size, [0.6, 0.2, 0.15], [0.9, 0.6, 0.4], 3))
    add(_tex_checker(size, [1.0, 0.95, 0.8], [0.85, 0.75, 0.55], 32))
    add(_tex_noise(rng, size, [0.3, 0.3, 0.35], [0.75, 0.75, 0.8], 6))
    # roughness maps (linear)
    add(_tex_noise(rng, size, [0.15, 0.15, 0.15], [0.9, 0.9, 0.9]), srgb=False)
    add(_tex_checker(size, [0.2, 0.2, 0.2], [0.8, 0.8, 0.8], 12), srgb=False)
    add(_tex_stripes(size, [0.1, 0.1, 0.1], [0.7, 0.7, 0.7], 32), srgb=False)
    add(_tex_noise(rng, size, [0.4, 0.4, 0.4], [0.65, 0.65, 0.65], 2),
        srgb=False)
    # normal maps (linear, tangent space)
    for octs in (3, 5):
        h = _value_noise(rng, size, octs)
        gx = np.gradient(h, axis=1)
        gy = np.gradient(h, axis=0)
        nrm = np.stack([-gx * 4, -gy * 4, np.ones_like(h)], -1)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        add(nrm * 0.5 + 0.5, srgb=False)
    return texs


# ----------------------------------------------------------- scene assembly


def generate_stress_scene(
    seed: int = 7,
    tri_scale: float = 1.0,
    num_emitters: int = 120,
    texture_size: int = 256,
) -> ParsedScene:
    """Interior hall: relief floor/ceiling, brick walls, columns, furniture,
    ~`num_emitters` ceiling panel lights + lamp spheres. ~285k tris at
    tri_scale=1."""
    rng = np.random.default_rng(seed)
    b = _Builder()
    W, H, D = 20.0, 6.0, 12.0  # hall dimensions

    textures = _make_textures(rng, texture_size)
    n_tex = len(textures)

    def s(n):
        return max(int(n * np.sqrt(tri_scale)), 2)

    # --- materials -------------------------------------------------------
    mats: list[dict] = []

    def mat(**kw):
        mats.append(kw)
        return len(mats) - 1

    m_floor = mat(base_color=[0.8, 0.8, 0.8], roughness=0.35,
                  base_color_texture_index=0, roughness_texture_index=12,
                  normal_map_texture_index=16)
    m_ceiling = mat(base_color=[0.9, 0.9, 0.92], roughness=0.8,
                    base_color_texture_index=7)
    m_brick = mat(base_color=[1, 1, 1], roughness=0.9,
                  base_color_texture_index=2, normal_map_texture_index=17)
    m_brick2 = mat(base_color=[1, 1, 1], roughness=0.85,
                   base_color_texture_index=3)
    m_column = mat(base_color=[0.9, 0.88, 0.85], roughness=0.4,
                   base_color_texture_index=7, coat=0.6, coat_roughness=0.1)
    # furniture / prop materials exercising every lobe
    prop_mats = [
        mat(base_color=[0.95, 0.93, 0.88], metallic=1.0, roughness=0.15,
            anisotropy=0.8, anisotropy_rotation=0.3),            # brushed metal
        mat(base_color=[1.0, 0.77, 0.34], metallic=1.0, roughness=0.05),  # gold
        mat(base_color=[1, 1, 1], specular_transmission=1.0, ior=1.5,
            roughness=0.0, absorption_color=[0.9, 0.95, 0.95],
            absorption_at_distance=0.5),                          # clear glass
        mat(base_color=[1, 1, 1], specular_transmission=1.0, ior=1.5,
            roughness=0.2, absorption_color=[0.6, 0.9, 0.7],
            absorption_at_distance=0.3),                          # rough glass
        mat(base_color=[0.6, 0.1, 0.1], coat=1.0, coat_roughness=0.05,
            roughness=0.4),                                       # coated paint
        mat(base_color=[0.2, 0.25, 0.6], sheen=0.8,
            sheen_color=[0.9, 0.9, 1.0], roughness=0.7),          # velvet
        mat(base_color=[0.1, 0.1, 0.1], thin_film=1.0,
            thin_film_thickness=420.0, thin_film_ior=1.6,
            metallic=1.0, roughness=0.1),                         # iridescent
        mat(base_color=[1, 1, 1], roughness=0.5,
            base_color_texture_index=6, roughness_texture_index=13),  # wood
        mat(base_color=[1, 1, 1], roughness=0.6,
            base_color_texture_index=4),                          # fabric
        mat(base_color=[1, 1, 1], roughness=0.3,
            base_color_texture_index=8, metallic=0.5),            # mixed
        mat(base_color=[1, 1, 1], roughness=0.45,
            base_color_texture_index=9, normal_map_texture_index=16),
        mat(base_color=[1, 1, 1], roughness=0.25,
            base_color_texture_index=11, coat=0.4),
    ]
    m_table = mat(base_color=[1, 1, 1], roughness=0.4,
                  base_color_texture_index=6, roughness_texture_index=15)

    # emissive panel materials: varied warm/cool colors and strengths
    emitter_mats = []
    for i in range(num_emitters):
        hue = rng.random()
        warm = np.asarray([1.0, 0.7 + 0.3 * hue, 0.5 + 0.5 * hue])
        strength = 12.0 + 30.0 * rng.random()
        emitter_mats.append(
            mat(base_color=warm.tolist(), emission=warm.tolist(),
                emission_strength=float(strength))
        )

    # --- geometry --------------------------------------------------------
    noise_f = _value_noise(rng, 128, 5) * 0.5
    noise_c = _value_noise(rng, 128, 4)
    _heightfield(b, (-W / 2, 0.0, -D / 2), (W, D), s(140), s(140), 0.15,
                 noise_f, m_floor)
    _heightfield(b, (-W / 2, H, -D / 2), (W, D), s(140), s(140), 0.3,
                 noise_c, m_ceiling, flip=True)
    _wall(b, (-W / 2, -D / 2), (W / 2, -D / 2), H, s(72), m_brick)
    _wall(b, (W / 2, D / 2), (-W / 2, D / 2), H, s(72), m_brick)
    _wall(b, (-W / 2, D / 2), (-W / 2, -D / 2), H, s(64), m_brick2)
    _wall(b, (W / 2, -D / 2), (W / 2, D / 2), H, s(64), m_brick2)

    # columns: two rows along the hall
    for i in range(6):
        x = -W / 2 + (i + 0.5) * W / 6
        for z in (-D / 4, D / 4):
            _cylinder(b, (x, 0.0, z), 0.25, H, s(24), s(20), m_column)

    # tables with props
    prop_i = 0
    for i in range(5):
        for j in range(3):
            x = -W / 2 + (i + 0.5) * W / 5 + rng.normal() * 0.3
            z = -D / 2 + (j + 0.5) * D / 3 + rng.normal() * 0.3
            _box(b, (x, 0.5, z), (1.4, 1.0, 0.9), s(8), m_table)
            # two props per table
            for kk in range(2):
                px = x + (kk - 0.5) * 0.5
                m = prop_mats[prop_i % len(prop_mats)]
                prop_i += 1
                _sphere(b, (px, 1.25, z), 0.22, 3, m)

    # large feature spheres (high subdivision)
    for i in range(16):
        x = rng.uniform(-W / 2 + 1, W / 2 - 1)
        z = rng.uniform(-D / 2 + 1, D / 2 - 1)
        r = rng.uniform(0.35, 0.6)
        m = prop_mats[(i * 5) % len(prop_mats)]
        _sphere(b, (x, r + 0.16, z), r, 4, m)

    # ceiling light panels: grid covering num_emitters
    cols = int(np.ceil(np.sqrt(num_emitters * W / D)))
    rows = int(np.ceil(num_emitters / cols))
    placed = 0
    for i in range(cols):
        for j in range(rows):
            if placed >= num_emitters:
                break
            x = -W / 2 + (i + 0.5) * W / cols
            z = -D / 2 + (j + 0.5) * D / rows
            sz = 0.25
            v = np.asarray(
                [
                    [x - sz, H - 0.12, z - sz],
                    [x + sz, H - 0.12, z - sz],
                    [x + sz, H - 0.12, z + sz],
                    [x - sz, H - 0.12, z + sz],
                ],
                np.float32,
            )
            f = np.asarray([[0, 2, 1], [0, 3, 2]], np.int64)  # facing down
            uv = np.zeros((4, 2), np.float32)
            b.add(v, f, uv, emitter_mats[placed])
            placed += 1

    vertices, triangles, uvs, mat_ids = b.finish()

    cam = camera_from_lookat(
        eye=(-W / 2 + 1.2, 2.2, 0.0),
        target=(W / 2, 1.6, 0.0),
        vfov_deg=55.0,
        aspect=1.0,
    )
    return ParsedScene(
        vertices=vertices,
        triangles=triangles,
        normals=None,  # build_scene derives smooth vertex normals
        uvs=uvs,
        material_ids=mat_ids,
        material_rows=mats,
        camera=cam,
        images=textures,
    )
