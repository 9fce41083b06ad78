"""Camera model and batched primary-ray generation, mirroring
``hiprt_pt_tpu.core.camera`` (reference: HIPRTCamera.h:16-49 NDC
unprojection with sub-pixel jitter)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device


def perspective_matrix(vfov_rad: float, aspect: float, near: float, far: float):
    """Right-handed OpenGL-style projection (matches GLTF camera conventions)."""
    f = 1.0 / np.tan(vfov_rad / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = (2.0 * far * near) / (near - far)
    m[3, 2] = -1.0
    return m


def quat_to_matrix(q) -> np.ndarray:
    """Unit quaternion (x, y, z, w) → 3x3 rotation (GLTF component order)."""
    x, y, z, w = [float(v) for v in q]
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float32,
    )


@dataclasses.dataclass
class Camera:
    """``view_inv``/``proj_inv`` feed ray generation; the forward matrices are
    kept for reprojection. Matrices are (4,4) f32 tensors."""

    view: torch.Tensor
    view_inv: torch.Tensor
    proj: torch.Tensor
    proj_inv: torch.Tensor
    position: torch.Tensor  # (3,)
    vfov: float
    near: float
    far: float
    do_jitter: bool = True

    @classmethod
    def create(cls, view: np.ndarray, vfov_rad: float, aspect: float,
               near: float = 0.1, far: float = 100.0,
               do_jitter: bool = True, device=None) -> "Camera":
        proj = perspective_matrix(vfov_rad, aspect, near, far)
        view = np.asarray(view, dtype=np.float32)
        view_inv = np.linalg.inv(view)
        return cls.from_matrices(view, view_inv, proj, np.linalg.inv(proj),
                                 vfov_rad, near, far, do_jitter, device)

    @classmethod
    def from_matrices(cls, view, view_inv, proj, proj_inv, vfov, near, far,
                      do_jitter=True, device=None) -> "Camera":
        """A camera on ``device`` (default: the GPU, see
        core/device.py:resolve_device)."""
        device = resolve_device(device)

        def t(x):
            return torch.tensor(np.asarray(x, np.float32), device=device)

        view_inv = np.asarray(view_inv, np.float32)
        return cls(view=t(view), view_inv=t(view_inv), proj=t(proj),
                   proj_inv=t(proj_inv), position=t(view_inv[:3, 3]),
                   vfov=float(vfov), near=float(near), far=float(far),
                   do_jitter=bool(do_jitter))

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self, view=self.view.to(device), view_inv=self.view_inv.to(device),
            proj=self.proj.to(device), proj_inv=self.proj_inv.to(device),
            position=self.position.to(device))


def camera_from_lookat(eye, target, up=(0.0, 1.0, 0.0), vfov_deg=45.0,
                       aspect=1.0, device=None) -> Camera:
    eye = np.asarray(eye, dtype=np.float32)
    target = np.asarray(target, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    # camera looks down -Z in view space (GL convention)
    view_inv = np.eye(4, dtype=np.float32)
    view_inv[:3, 0] = right
    view_inv[:3, 1] = true_up
    view_inv[:3, 2] = -fwd
    view_inv[:3, 3] = eye
    view = np.linalg.inv(view_inv)
    return Camera.create(view, np.deg2rad(vfov_deg), aspect, device=device)


def camera_from_gltf_node(translation, rotation, yfov: float, aspect: float,
                          near=0.1, far=100.0, device=None) -> Camera:
    """GLTF camera node → Camera on ``device`` (default: the GPU). GLTF
    cameras look down -Z of the node frame (reference scene parsing:
    src/Scene/SceneParser.cpp:222-276)."""
    R = quat_to_matrix(np.asarray(rotation, dtype=np.float32))
    t = np.asarray(translation, dtype=np.float32)
    view_inv = np.eye(4, dtype=np.float32)
    view_inv[:3, :3] = R
    view_inv[:3, 3] = t
    view = np.linalg.inv(view_inv)
    return Camera.create(view, yfov, aspect, near, far, device=device)


def row_products(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x (N,K) @ m.T for a small (J,K) matrix m, summed term by term in one
    order: a matrix product's result may depend on how many rows it has
    (its algorithm does), and a pixel's ray must not depend on how many
    pixels a render step holds (parallel/mesh.py: pixel shards)."""
    out = x[:, 0:1] * m[:, 0]
    for k in range(1, x.shape[1]):
        out = out + x[:, k:k + 1] * m[:, k]
    return out


def generate_camera_rays(camera: Camera, width: int, height: int,
                         jitter: torch.Tensor | None = None,
                         px: torch.Tensor | None = None,
                         py: torch.Tensor | None = None):
    """Primary rays. Returns (origins (N,3), directions (N,3)); pixel (0,0)
    is the bottom left. jitter: optional (N,2) sub-pixel offsets in [0,1);
    px/py: explicit pixel coordinates (default row-major)."""
    dev = camera.view_inv.device
    if px is None or py is None:
        idx = torch.arange(width * height, dtype=torch.int32, device=dev)
        px, py = idx % width, idx // width
    n = px.shape[0]
    pxf = px.to(torch.float32)
    pyf = py.to(torch.float32)
    if jitter is None or not camera.do_jitter:
        jx = jy = 0.5
    else:
        jx, jy = jitter[:, 0], jitter[:, 1]
    ndc_x = (pxf + jx) / width * 2.0 - 1.0
    ndc_y = (pyf + jy) / height * 2.0 - 1.0
    ones = torch.ones_like(ndc_x)
    ndc = torch.stack([ndc_x, ndc_y, -ones, ones], dim=-1)
    view_pt = row_products(ndc, camera.proj_inv)
    view_pt = view_pt[:, :3] / view_pt[:, 3:4]
    dirs = row_products(view_pt, camera.view_inv[:3, :3])
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    origins = camera.position.expand(n, 3).contiguous()
    return origins, dirs


# --- interactive camera operations (reference: Camera zoom/rotate/translate,
# src/Scene/Camera.h:27-87 and the mouse and keyboard interactors); each
# returns a new camera on the same device ---


def _decompose(camera: Camera):
    vi = camera.view_inv.cpu().numpy().copy()
    proj = camera.proj.cpu().numpy()
    aspect = proj[1, 1] / proj[0, 0]
    return vi, camera.vfov, float(aspect), camera.near, camera.far


def _recompose(camera: Camera, vi, vfov, aspect, near, far) -> Camera:
    return Camera.create(np.linalg.inv(vi), vfov, aspect, near, far,
                         do_jitter=camera.do_jitter,
                         device=camera.view_inv.device)


def camera_rotate(camera: Camera, yaw_rad: float, pitch_rad: float) -> Camera:
    """First-person look rotation (reference: mouse-drag rotation): yaw
    about world +Y, pitch about the camera's right axis."""
    vi, vfov, aspect, near, far = _decompose(camera)
    cy, sy = np.cos(yaw_rad), np.sin(yaw_rad)
    cp, sp = np.cos(pitch_rad), np.sin(pitch_rad)
    yaw = np.asarray([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    k = vi[:3, 0] / np.linalg.norm(vi[:3, 0])
    K = np.asarray([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]],
                   np.float32)
    # Rodrigues
    pitch = np.eye(3, dtype=np.float32) + sp * K + (1 - cp) * (K @ K)
    vi[:3, :3] = yaw @ pitch @ vi[:3, :3]
    return _recompose(camera, vi, vfov, aspect, near, far)


def camera_translate(camera: Camera, dx: float, dy: float, dz: float) -> Camera:
    """Walk in camera space: +x right, +y up, -z forward (reference:
    RenderWindowKeyboardInteractor.cpp:29-52)."""
    vi, vfov, aspect, near, far = _decompose(camera)
    vi[:3, 3] += vi[:3, 0] * dx + vi[:3, 1] * dy + vi[:3, 2] * dz
    return _recompose(camera, vi, vfov, aspect, near, far)


def camera_zoom(camera: Camera, amount: float) -> Camera:
    """Dolly along the view direction (reference: scroll zoom)."""
    return camera_translate(camera, 0.0, 0.0, -amount)


def auto_camera_speed(scene_min, scene_max) -> float:
    """Movement speed from the scene's bounding box (reference:
    SceneParser.cpp:206)."""
    return float(np.linalg.norm(np.asarray(scene_max) - np.asarray(scene_min))) / 100.0
