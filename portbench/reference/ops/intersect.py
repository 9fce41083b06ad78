"""Ray-primitive intersection, mirroring ``hiprt_pt_tpu.ops.intersect``:
Möller-Trumbore ray/triangle, the slab ray/box test, the brute-force
all-triangles oracle and the self-intersection origin offset.

``triangle_test`` is written component by component in the same operation
order as the CUDA kernels (csrc/traverse.cu), so the plain traversal and the
kernels round identically.
"""

from __future__ import annotations

import torch

TRI_EPS = 1e-9


def triangle_test(ox, oy, oz, dx, dy, dz,
                  v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z):
    """Möller-Trumbore on broadcastable component tensors.
    Returns (ok, t, u, v) where ok = |det| > eps & u, v inside the triangle
    (the caller adds its t-range test)."""
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok_det = det.abs() > TRI_EPS
    inv_det = torch.where(ok_det, 1.0 / det, torch.zeros_like(det))
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return ok, t, u, v


def ray_triangle(o, d, v0, e1, e2, t_min=1e-4, t_max=float("inf")):
    """Möller-Trumbore on (..., 3) tensors. Returns (hit, t (inf on miss),
    u, v). Backface hits are reported."""
    ok, t, u, v = triangle_test(
        o[..., 0], o[..., 1], o[..., 2], d[..., 0], d[..., 1], d[..., 2],
        v0[..., 0], v0[..., 1], v0[..., 2], e1[..., 0], e1[..., 1], e1[..., 2],
        e2[..., 0], e2[..., 1], e2[..., 2])
    hit = ok & (t > t_min) & (t < t_max)
    return hit, torch.where(hit, t, torch.full_like(t, float("inf"))), u, v


def ray_aabb(o, inv_d, bmin, bmax, t_max):
    """Slab test. Returns (hit mask, t_entry). inv_d precomputed 1/d."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tsm = torch.minimum(t0, t1)
    tbg = torch.maximum(t0, t1)
    t_entry = tsm.amax(dim=-1).clamp_min(0.0)
    t_exit = tbg.amin(dim=-1)
    return t_entry <= torch.minimum(t_exit, torch.as_tensor(t_max)), t_entry


def brute_force_closest(vertices, triangles, o, d, t_min=1e-4,
                        t_max=float("inf"), chunk_elems: int = 1 << 24):
    """O(N_rays × N_tris) closest hit — the traversal correctness oracle.
    Rays are processed in chunks of at most ``chunk_elems`` ray-triangle
    pairs. Returns (t (N,), prim (N,) i32 [-1 = miss], u, v)."""
    tri = triangles.long()
    v0 = vertices[tri[:, 0]]
    e1 = vertices[tri[:, 1]] - v0
    e2 = vertices[tri[:, 2]] - v0
    n = o.shape[0]
    step = max(1, chunk_elems // max(tri.shape[0], 1))
    out_t, out_p, out_u, out_v = [], [], [], []
    for s in range(0, n, step):
        oc, dc = o[s:s + step, None, :], d[s:s + step, None, :]
        _hit, t, u, v = ray_triangle(oc, dc, v0[None], e1[None], e2[None],
                                     t_min, t_max)
        best = t.argmin(dim=1, keepdim=True)
        bt = t.gather(1, best)[:, 0]
        miss = ~torch.isfinite(bt)
        out_t.append(bt)
        out_p.append(torch.where(miss, -1, best[:, 0]).to(torch.int32))
        out_u.append(u.gather(1, best)[:, 0])
        out_v.append(v.gather(1, best)[:, 0])
    return (torch.cat(out_t), torch.cat(out_p), torch.cat(out_u),
            torch.cat(out_v))


def offset_ray_origin(p, n_geom, d):
    """Offset a secondary-ray origin along the geometric normal, toward the
    side d leaves from, to avoid self-intersection."""
    sign = torch.where((n_geom * d).sum(dim=-1, keepdim=True) >= 0.0, 1.0, -1.0)
    scale = 1e-4 * torch.linalg.norm(p, dim=-1, keepdim=True).clamp_min(1.0)
    return p + sign * n_geom * scale
