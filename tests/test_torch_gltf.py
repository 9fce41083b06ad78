"""Scene files in the port against the JAX package: the glTF importer
(hiprt_pt_tpu_torch/assets/gltf.py) on .glb and .gltf files (data URIs,
external .bin and .png) that the port's test-content writer
(assets/gltf_testscene.py) makes, the writer itself, interleaved accessors,
texture sources, the glTF camera, the loader's fallback chain and its
thread pipeline (assets/loader.py, utils/threads.py), the gltf path, and
benchmarks/run_configs.py's configs 1-3 on a test-written Cornell .glb.

Image gates, as for the other render paths: >= 98% of pixels within
1e-3 + 1e-3·|ref| per channel, image mean within 1%, rays within 0.5%."""

import base64
import dataclasses
import json
import os
import sys
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_parity as tp  # noqa: E402
from test_torch_envmap import assert_images_agree  # noqa: E402

from hiprt_pt_tpu_torch import interop  # noqa: E402
from hiprt_pt_tpu_torch.assets import gltf_testscene as gw  # noqa: E402
from hiprt_pt_tpu_torch.assets.gltf import ParsedScene, load_gltf  # noqa: E402
from hiprt_pt_tpu_torch.core import settings as ts  # noqa: E402

W, H = 32, 16
# the material fields glTF carries (gltf_testscene.py writes, gltf.py reads)
GLTF_FIELDS = ("base_color", "alpha_opacity", "roughness", "metallic",
               "emission", "emission_strength", "ior", "specular_transmission",
               "absorption_at_distance", "absorption_color", "specular",
               "specular_color", "coat", "coat_roughness", "dispersion_scale",
               "base_color_texture_index", "roughness_metallic_texture_index",
               "normal_map_texture_index", "emission_texture_index")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as in test_torch_envmap.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _textures():
    """Four small RGBA textures: a colour checker, a metallic-roughness
    map, a normal map and an emission ramp."""
    g = np.random.default_rng(11)
    yy, xx = np.mgrid[0:16, 0:24]
    checker = np.where(((yy // 4 + xx // 4) % 2)[..., None] == 0,
                       [200, 60, 40, 255], [30, 90, 220, 255]).astype(np.uint8)
    mr = g.integers(0, 256, (8, 8, 4), dtype=np.uint8)
    mr[..., 3] = 255
    nrm = np.full((8, 8, 4), [128, 128, 255, 255], np.uint8)
    ramp = np.zeros((4, 32, 4), np.uint8)
    ramp[..., :3] = np.linspace(0, 255, 32).astype(np.uint8)[None, :, None]
    ramp[..., 3] = 255
    return [checker, mr, nrm, ramp]


def _cornell_parsed(textures: bool = True) -> ParsedScene:
    """The procedural Cornell box with explicit vertex normals, planar uvs
    and (with ``textures``) a textured wall, sphere and light."""
    from hiprt_pt_tpu_torch.core.camera import camera_from_lookat

    v, f, m, rows, cam = tp.cornell_spheres_arrays(W / H)
    rows = [dict(r) for r in rows]
    nrm = np.zeros_like(v)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    for k in range(3):
        np.add.at(nrm, f[:, k], fn)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    images = []
    if textures:
        rows[0]["base_color_texture_index"] = 0
        rows[5]["roughness_metallic_texture_index"] = 1
        rows[8]["normal_map_texture_index"] = 2
        rows[3]["emission_texture_index"] = 3
        images = _textures()
    uvs = np.stack([0.4 * (v[:, 0] + v[:, 2]), 0.4 * (v[:, 1] - v[:, 2])], -1)
    return ParsedScene(vertices=v, triangles=f, normals=nrm.astype(np.float32),
                       uvs=uvs.astype(np.float32), material_ids=m,
                       material_rows=rows,
                       camera=camera_from_lookat(**cam, device="cpu"),
                       images=images)


def _write(kind: str, folder, parsed, alpha=()):
    """Write ``parsed`` as ``kind``: "glb", "gltf-embedded" (data URIs) or
    "gltf-external" (.bin and .png files beside it)."""
    if kind == "glb":
        path = os.path.join(folder, "scene.glb")
        gw.write_glb(path, parsed, alpha_materials=alpha)
    else:
        path = os.path.join(folder, "scene.gltf")
        gw.write_gltf(path, parsed, alpha_materials=alpha,
                      external=kind == "gltf-external")
    return path


def _assert_parsed_equal(got, ref, cam_atol=1e-6):
    """Port ParsedScene against the JAX package's."""
    for k in ("vertices", "triangles", "normals", "uvs", "material_ids"):
        a, b = getattr(got, k), getattr(ref, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert got.material_rows == ref.material_rows
    assert len(got.images) == len(ref.images)
    for a, b in zip(got.images, ref.images):
        np.testing.assert_array_equal(a, b)
    for k in ("view", "view_inv", "proj", "proj_inv", "position"):
        np.testing.assert_allclose(getattr(got.camera, k).numpy(),
                                   np.asarray(getattr(ref.camera, k)),
                                   rtol=0, atol=cam_atol, err_msg=k)


@pytest.mark.parametrize("kind", ["glb", "gltf-embedded", "gltf-external"])
def test_load_gltf_matches_jax(tmp_path, kind):
    from hiprt_pt_tpu.assets.gltf import load_gltf as jload

    path = _write(kind, str(tmp_path), _cornell_parsed(), alpha=(6,))
    if kind == "gltf-external":
        assert sorted(os.listdir(tmp_path)) == sorted(
            ["scene.gltf", "scene.bin"] + [f"scene_{i}.png" for i in range(5)])
    for aspect in (None, 1.5):
        got, ref = load_gltf(path, aspect), jload(path, aspect)
        _assert_parsed_equal(got, ref)
        assert got.images[4][..., 3].min() == 0  # the cutout's holes


def test_write_glb_round_trips_the_scene(tmp_path):
    """What write_glb writes reads back as the scene written: geometry and
    uvs exactly, normals to float rounding, every glTF material field, the
    images (the alpha material's with its cutout), the camera."""
    from hiprt_pt_tpu_torch.core.material import MaterialBank

    parsed = _cornell_parsed()
    got = load_gltf(_write("glb", str(tmp_path), parsed, alpha=(6,)), W / H)
    for k in ("vertices", "triangles", "uvs", "material_ids"):
        np.testing.assert_array_equal(getattr(got, k), getattr(parsed, k), err_msg=k)
    np.testing.assert_allclose(got.normals, parsed.normals, rtol=0, atol=1e-6)
    want = [dict(r) for r in parsed.material_rows]
    want[6]["base_color_texture_index"] = 4
    a, b = MaterialBank.from_rows(got.material_rows), MaterialBank.from_rows(want)
    for k in GLTF_FIELDS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for im, ref in zip(got.images, parsed.images):
        np.testing.assert_array_equal(im, ref)
    np.testing.assert_array_equal(got.images[4], gw.cutout(np.full((64, 64, 4), 255,
                                                                   np.uint8)))
    for k in ("view", "proj"):
        np.testing.assert_allclose(getattr(got.camera, k).numpy(),
                                   getattr(parsed.camera, k).numpy(), atol=1e-6)


def _interleaved_doc():
    """A two-triangle .gltf whose positions, normals and uvs share one
    bufferView (byteStride 36: 12 + 12 + 4 bytes of data and 8 of padding),
    the uvs normalized uint16, the indices uint16 behind them."""
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0.5]], np.float32)
    nrm = np.asarray([[0, 0, 1]] * 4, np.float32)
    uv = np.asarray([[0, 0], [65535, 0], [0, 65535], [32768, 16384]], np.uint16)
    rec = np.zeros(4, [("p", "<f4", 3), ("n", "<f4", 3), ("uv", "<u2", 2),
                       ("pad", "u1", 8)])
    rec["p"], rec["n"], rec["uv"] = pos, nrm, uv
    idx = np.asarray([0, 1, 2, 1, 3, 2], np.uint16)
    blob = rec.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [0, 0, -2]}],
        "meshes": [{"primitives": [{"attributes": {
            "POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2}, "indices": 3}]}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 144,
                         "byteStride": 36},
                        {"buffer": 0, "byteOffset": 144, "byteLength": 12}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 0, "byteOffset": 12, "componentType": 5126,
             "count": 4, "type": "VEC3"},
            {"bufferView": 0, "byteOffset": 24, "componentType": 5123,
             "normalized": True, "count": 4, "type": "VEC2"},
            {"bufferView": 1, "componentType": 5123, "count": 6, "type": "SCALAR"}],
        "buffers": [{"byteLength": len(blob), "uri":
                     "data:application/octet-stream;base64,"
                     + base64.b64encode(blob).decode()}],
    }
    return doc, pos, uv


def test_interleaved_accessors(tmp_path):
    """An interleaved bufferView reads as one strided view: the values the
    JAX package's element loop reads, and the values written."""
    from hiprt_pt_tpu.assets.gltf import load_gltf as jload

    doc, pos, uv = _interleaved_doc()
    path = tmp_path / "strided.gltf"
    path.write_text(json.dumps(doc))
    got, ref = load_gltf(str(path)), jload(str(path))
    np.testing.assert_array_equal(got.vertices, pos + [0, 0, -2])
    np.testing.assert_array_equal(got.uvs, uv.astype(np.float32) / 65535.0)
    np.testing.assert_array_equal(got.triangles, [[0, 1, 2], [1, 3, 2]])
    for k in ("vertices", "normals", "uvs", "triangles"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k), err_msg=k)
    # an accessor that reads past its buffer is refused
    doc["accessors"][0]["count"] = 6
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="past the end"):
        load_gltf(str(path))


def _swapped_sources(tmp_path):
    """A .gltf whose texture 0 names image 1 and texture 1 image 0."""
    parsed = _cornell_parsed()
    path = _write("gltf-embedded", str(tmp_path), parsed)
    doc = json.loads(open(path).read())
    doc["textures"][0]["source"], doc["textures"][1]["source"] = 1, 0
    with open(path, "w") as f:
        json.dump(doc, f)
    return path, parsed


def test_texture_index_resolves_its_source(tmp_path):
    path, parsed = _swapped_sources(tmp_path)
    got = load_gltf(path)
    assert got.material_rows[0]["base_color_texture_index"] == 1
    assert got.material_rows[5]["roughness_metallic_texture_index"] == 0
    np.testing.assert_array_equal(got.images[1], parsed.images[1])


@pytest.mark.xfail(strict=True, reason=(
    "known fault in the reference (ROADMAP §3): the JAX package's load_gltf "
    "uses a glTF texture index as the image index (gltf.py:262, "
    "tex_offset_of = lambda i: i) instead of textures[i].source"))
def test_jax_texture_index_resolves_its_source(tmp_path):
    from hiprt_pt_tpu.assets.gltf import load_gltf as jload

    path, _parsed = _swapped_sources(tmp_path)
    assert jload(path).material_rows[0]["base_color_texture_index"] == 1


def test_gltf_camera_matches_jax():
    from hiprt_pt_tpu.core.camera import camera_from_gltf_node as jnode
    from hiprt_pt_tpu.core.camera import quat_to_matrix as jquat
    from hiprt_pt_tpu_torch.core.camera import camera_from_gltf_node, quat_to_matrix

    g = np.random.default_rng(2)
    for _ in range(5):
        q = g.normal(size=4)
        q /= np.linalg.norm(q)
        r = quat_to_matrix(q)
        np.testing.assert_array_equal(r, jquat(q))
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-6)
        # the writer's inverse: the same rotation, q or -q
        assert abs(float(np.dot(gw._quaternion(r), q)) - 1.0) < 1e-6 or \
            abs(float(np.dot(gw._quaternion(r), q)) + 1.0) < 1e-6
        t = g.normal(size=3)
        cam = camera_from_gltf_node(t, q, 0.7, 1.6, 0.05, 50.0, device="cpu")
        ref = jnode(t, q, 0.7, 1.6, 0.05, 50.0)
        for k in ("view", "view_inv", "proj", "proj_inv", "position"):
            np.testing.assert_allclose(getattr(cam, k).numpy(),
                                       np.asarray(getattr(ref, k)), atol=1e-6)


def test_loader_fallback_chain(tmp_path):
    """A file that fails to parse falls back to the 12-triangle default box
    (reference: SceneParser.cpp:26-41), as in the JAX package."""
    from hiprt_pt_tpu.assets.loader import load_scene_file as jload
    from hiprt_pt_tpu_torch.assets.loader import load_scene_file

    bad = tmp_path / "broken.gltf"
    bad.write_text("{not valid json")
    for path in (str(bad), str(tmp_path / "missing.glb")):
        scene, cam = load_scene_file(path, aspect=2.0, device="cpu")
        jscene, jcam = jload(path, aspect=2.0)
        assert scene.num_triangles == 12 and scene.num_emissives == 2
        for k in ("vertices", "triangles", "normals", "tri_data", "emissive_rows"):
            np.testing.assert_array_equal(getattr(scene, k).numpy(),
                                          np.asarray(getattr(jscene, k)), err_msg=k)
        np.testing.assert_allclose(cam.view.numpy(), np.asarray(jcam.view), atol=1e-6)
        np.testing.assert_allclose(cam.proj.numpy(), np.asarray(jcam.proj), atol=1e-6)


def test_loader_serial_and_parallel_agree(tmp_path):
    """The thread pipeline (texture atlas and BVH on their own threads,
    reference: main.cpp:55-67) gives the serial load's scene and BVH, and
    both the JAX package's scene arrays."""
    from hiprt_pt_tpu.assets.loader import load_scene_file as jload
    from hiprt_pt_tpu_torch.assets.loader import load_scene_file

    path = _write("glb", str(tmp_path), _cornell_parsed(), alpha=(6,))
    t1, t2 = {}, {}
    s1, c1, b1 = load_scene_file(path, aspect=2.0, with_bvh=True, device="cpu",
                                 timings=t1)
    s2, c2, b2 = load_scene_file(path, aspect=2.0, parallel=True, with_bvh=True,
                                 device="cpu", timings=t2)
    stages = {k for k in t1 if k.startswith("bvh/")}
    assert set(t1) - stages == set(t2) - stages == {"parse", "images", "atlas",
                                                    "bvh", "scene", "total"}
    assert stages and {k for k in t2 if k.startswith("bvh/")} == stages
    assert s1.textures.has_alpha and s1.textures.num_layers == 5
    for k in ("vertices", "triangles", "tri_data", "emissive_rows"):
        assert torch.equal(getattr(s1, k), getattr(s2, k)), k
    assert torch.equal(s1.textures.texels, s2.textures.texels)
    for k in ("nodes4", "tri_rows", "nodes"):  # NaN marks an empty slot
        torch.testing.assert_close(getattr(b1, k), getattr(b2, k), rtol=0,
                                   atol=0, equal_nan=True)
    assert torch.equal(c1.view, c2.view)
    jscene, _jcam = jload(path, aspect=2.0)
    jd = tp.to_numpy_dict(jscene)
    for k in ("vertices", "triangles", "tri_data", "emissive_rows"):
        np.testing.assert_array_equal(getattr(s1, k).numpy(), jd[k], err_msg=k)
    np.testing.assert_array_equal(s1.textures.texels.numpy(), jd["textures"]["texels"])


def test_thread_manager_dag():
    from hiprt_pt_tpu_torch.utils.threads import ThreadManager

    tm = ThreadManager()
    order = []
    tm.add_dependency("b", "a")
    tm.start_thread("a", lambda: (time.sleep(0.1), order.append("a")))
    t = tm.start_thread("b", lambda: order.append("b"))
    tm.join_threads("b")
    assert order == ["a", "b"] and not t.is_alive()
    # monothread mode runs inline
    tm2 = ThreadManager(monothread=True)
    assert tm2.start_thread("x", lambda: order.append("x")) is None
    assert order[-1] == "x"
    tm.start_thread("v", lambda: 7)
    tm.join_all_threads()
    assert tm.results("v") == [7]
    # errors surface at join
    tm.start_thread("err", lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        tm.join_threads("err")


def test_gltf_path_is_the_headline_through_a_scene_file():
    """The gltf path: the headline's options and routes; its cutouts are
    generate_stress_scene's walls, columns and tables."""
    from hiprt_pt_tpu_torch import paths
    from hiprt_pt_tpu_torch.assets.stress import generate_stress_scene

    assert paths.ROUTES["gltf"] == paths.ROUTES["headline"]
    assert paths.slice_options("gltf") == paths.slice_options("headline")
    rows = generate_stress_scene(tri_scale=0.01, texture_size=32).material_rows
    cut = [rows[m] for m in paths.GLTF_CUTOUTS]
    assert [r.get("base_color_texture_index") for r in cut] == [2, 3, 7, 6]
    assert [r.get("roughness") for r in cut] == [0.9, 0.85, 0.4, 0.4]


def _config(n: int):
    """(JAX options, settings, world, envmap kind; the port's options,
    settings, world) of run_configs.py's config ``n`` at 2 bounces (the
    configs' 4 and 6 are cut, which halves the JAX package's trace): 1 the
    Oren-Nayar override under MIS, ambient NONE; 2 MIS with CDF envmap
    sampling and dispersion on every transmissive material; 3 the full
    principled BSDF under MIS with alias-table envmap sampling."""
    from hiprt_pt_tpu.core import settings as js

    kw = dict(direct_light_sampling="MIS", max_bounces_static=2)
    if n == 1:
        kw["bsdf_override"] = "OREN_NAYAR"
    elif n == 2:
        kw["envmap_sampling"] = "CDF_BINARY"
    else:
        kw["envmap_sampling"] = "ALIAS_TABLE"
    enum = {"direct_light_sampling": "LightSamplingStrategy",
            "bsdf_override": "BSDFOverride",
            "envmap_sampling": "EnvmapSamplingStrategy"}

    def opts(mod):
        return mod.RenderOptions(**{k: getattr(getattr(mod, enum[k]), v)
                                    if k in enum else v for k, v in kw.items()})

    ambient = "NONE" if n == 1 else "ENVMAP"
    jworld = js.WorldSettings().replace(ambient_light_type=jnp.int32(
        int(getattr(js.AmbientLightType, ambient))))
    return (opts(js), js.RenderSettings().replace(nb_bounces=jnp.int32(2)),
            jworld, None if n == 1 else "sky", opts(ts),
            ts.RenderSettings(nb_bounces=2),
            interop.world_from_numpy(tp.to_numpy_dict(jworld)))


@pytest.mark.parametrize("config", [1, 2, 3])
def test_run_configs_on_a_gltf_cornell(tmp_path, config):
    """run_configs.py's configs 1-3 name glTF scenes that are absent here;
    both packages load a test-written Cornell .glb instead (config 2's
    dispersion forced on the transmissive spheres, as run_configs.py
    does) through their load_scene_file and render one sample at 32x16."""
    from hiprt_pt_tpu.accel.build import build_bvh as jbvh
    from hiprt_pt_tpu.assets.envmap import build_envmap as jenv
    from hiprt_pt_tpu.assets.loader import load_scene_file as jload
    from hiprt_pt_tpu.core.state import init_render_state as jinit
    from hiprt_pt_tpu.render.renderer import render_step as jstep
    from hiprt_pt_tpu_torch.assets.envmap import build_envmap, make_test_envmap
    from hiprt_pt_tpu_torch.assets.loader import load_scene_file
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.render.renderer import render_step

    jopts, jset, jworld, kind, opts, settings, world = _config(config)
    path = _write("glb", str(tmp_path), _cornell_parsed(textures=False))
    texels = None if kind is None else make_test_envmap(64, 128, kind)
    jscene, jcam = jload(path, aspect=W / H,
                         envmap=None if kind is None else jenv(texels))
    scene, cam, bvh = load_scene_file(
        path, aspect=W / H, envmap=None if kind is None else build_envmap(
            texels, device="cpu"), with_bvh=True, device="cpu")
    if config == 2:
        trans = np.asarray(jscene.materials.specular_transmission) > 0
        jscene = jscene.replace(materials=jscene.materials.replace(
            dispersion_scale=jnp.asarray(np.where(trans, 1.0, 0.0).astype(np.float32))))
        scene = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, dispersion_scale=torch.from_numpy(
                np.where(trans, 1.0, 0.0).astype(np.float32))))
    ref = jstep(jopts, W, H, (jscene, jbvh(np.asarray(jscene.vertices),
                                           np.asarray(jscene.triangles))),
                jinit(W, H, 42), jcam, jset, jworld)
    got = render_step(opts, W, H, scene, bvh, init_render_state(W, H, 42, "cpu"),
                      cam, settings, world)
    assert_images_agree(got.accum.numpy(), np.asarray(ref.accum),
                        int(got.rays_traced), float(ref.rays_traced))
