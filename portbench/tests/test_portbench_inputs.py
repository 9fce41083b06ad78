"""The frozen input makers give the port's makers' arrays and .glb bytes
at the commit that froze them (this test imports the port to compare)."""

import numpy as np

from hiprt_pt_tpu_torch.assets import cornell as pc
from hiprt_pt_tpu_torch.assets import envmap as pe
from hiprt_pt_tpu_torch.assets import gltf_testscene as pg
from hiprt_pt_tpu_torch.assets import stress as ps
from hiprt_pt_tpu_torch.paths import GLTF_CUTOUTS
from portbench.cell import load_cell
from portbench.inputs import cornell, envmap, glb, stress


def test_stress_scene_and_glb_bytes(tmp_path):
    sc = load_cell("stress-glb-ris-1080p").config["scene"]
    assert tuple(sc["cutouts"]) == GLTF_CUTOUTS
    kw = dict(seed=sc["seed"], tri_scale=sc["tri_scale"],
              num_emitters=sc["num_emitters"], texture_size=sc["texture_size"])
    a = stress.generate_stress_scene(**kw)
    b = ps.generate_stress_scene(**kw)
    for k in ("vertices", "triangles", "uvs", "material_ids"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert a.material_rows == b.material_rows
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a.images, b.images))
    assert a.camera.view_inv.tobytes() == b.camera.view_inv.numpy().tobytes()
    assert a.camera.proj.tobytes() == b.camera.proj.numpy().tobytes()
    assert a.triangles.shape[0] == 259120
    glb.write_glb(str(tmp_path / "a.glb"), a, alpha_materials=GLTF_CUTOUTS)
    pg.write_glb(str(tmp_path / "b.glb"), b, alpha_materials=GLTF_CUTOUTS)
    assert (tmp_path / "a.glb").read_bytes() == (tmp_path / "b.glb").read_bytes()


def test_cornell_arrays_and_sky():
    x = cornell.cornell_spheres_arrays(16 / 9)
    y = pc.cornell_spheres_arrays(16 / 9)
    for p, q in zip(x[:3], y[:3]):
        assert p.dtype == q.dtype and p.tobytes() == q.tobytes()
    assert x[3] == y[3] and x[4] == y[4]
    assert x[1].shape[0] == 35852
    a = envmap.make_test_envmap(64, 128, "sky")
    assert a.tobytes() == pe.make_test_envmap(64, 128, "sky").tobytes()
    assert np.isfinite(a).all()
