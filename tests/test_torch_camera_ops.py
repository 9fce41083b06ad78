"""The port's interactive camera operations (core/camera.py: rotate,
translate, zoom, the automatic speed) against the JAX package's, as
tests/test_camera_ops.py holds those: every matrix of the new camera within
1e-6, and the primary rays it generates."""

import numpy as np
import pytest

from hiprt_pt_tpu_torch.core import camera as tc

LOOKAT = dict(eye=(0.3, 1.1, 3.4), target=(0.0, 0.9, 0.0), vfov_deg=40.0,
              aspect=16 / 9)
FIELDS = ("view", "view_inv", "proj", "proj_inv", "position")


def _cameras():
    from hiprt_pt_tpu.core.camera import camera_from_lookat

    return camera_from_lookat(**LOOKAT), tc.camera_from_lookat(**LOOKAT,
                                                               device="cpu")


def _assert_same(got, ref):
    for k in FIELDS:
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=0.0,
                                   atol=1e-6, err_msg=k)
    for k in ("vfov", "near", "far"):
        assert abs(getattr(got, k) - float(getattr(ref, k))) <= 1e-6, k


OPS = {
    "rotate": ("camera_rotate", (0.3, -0.2)),
    "rotate-yaw": ("camera_rotate", (-1.1, 0.0)),
    "translate": ("camera_translate", (0.5, -0.25, 1.5)),
    "zoom": ("camera_zoom", (0.7,)),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_camera_op_matches_jax(op):
    from hiprt_pt_tpu.core import camera as jc

    name, args = OPS[op]
    jcam, cam = _cameras()
    ref, got = getattr(jc, name)(jcam, *args), getattr(tc, name)(cam, *args)
    _assert_same(got, ref)
    assert got.view.device == cam.view.device
    # twice, from the results
    _assert_same(getattr(tc, name)(got, *args), getattr(jc, name)(ref, *args))


def test_camera_ops_move_the_primary_rays_as_jax():
    import torch_parity as tp

    from hiprt_pt_tpu.core import camera as jc

    jcam, cam = _cameras()
    jcam = jc.camera_zoom(jc.camera_rotate(jcam, 0.2, 0.1), 0.4)
    cam = tc.camera_zoom(tc.camera_rotate(cam, 0.2, 0.1), 0.4)
    o_ref, d_ref = tp.camera_rays_np(jcam, 32, 16)
    o, d = tp.camera_rays_np_torch(cam, 32, 16)
    np.testing.assert_allclose(o, o_ref, rtol=0.0, atol=1e-6)
    np.testing.assert_allclose(d, d_ref, rtol=0.0, atol=1e-6)


def test_auto_camera_speed_matches_jax():
    from hiprt_pt_tpu.core.camera import auto_camera_speed

    lo, hi = np.asarray([-3.5, 0.0, -1.0]), np.asarray([3.5, 2.0, 1.0])
    assert tc.auto_camera_speed(lo, hi) == auto_camera_speed(lo, hi)
    assert tc.auto_camera_speed(lo, hi) == pytest.approx(np.sqrt(57.0) / 100.0)
