"""The port's texture path against the JAX package: the atlas of the stress
interior's 18 procedural textures (bit for bit), the bilinear fetch with and
without mips and footprint rows and in each sRGB mode, material texturing
and normal mapping. Inputs are seeded numpy; f32 results are held at atol
1e-5 / rtol 1e-4 (the sRGB decode's pow differs in the last bits between
XLA and PyTorch)."""

import dataclasses
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_parity as tp  # noqa: E402

from hiprt_pt_tpu_torch import interop  # noqa: E402

N = 4096
ATOL, RTOL = 1e-5, 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def scenes():
    from hiprt_pt_tpu.assets.stress import load_stress_scene as jload
    from hiprt_pt_tpu_torch.assets.stress import load_stress_scene as tload

    jscene, _ = jload(aspect=2.0, tri_scale=tp.TRI_SCALE, with_textures=True)
    tscene, _ = tload(aspect=2.0, tri_scale=tp.TRI_SCALE, with_textures=True,
                      device="cpu")
    return jscene, tscene


def test_atlas_matches_jax(scenes):
    jscene, tscene = scenes
    ja, ta = jscene.textures, tscene.textures
    assert ta.num_layers == ja.num_layers == 18
    for f in dataclasses.fields(ta):
        got, ref = getattr(ta, f.name), getattr(ja, f.name)
        if isinstance(got, torch.Tensor):
            assert np.array_equal(got.numpy(), np.asarray(ref)), f.name
        else:
            assert got == ref, f.name
    assert ta.has_alpha is False
    # and through interop
    back = interop.scene_from_numpy(tp.to_numpy_dict(jscene), "cpu").textures
    assert torch.equal(back.texels, ta.texels) and back.kinds_used == ta.kinds_used


def _uv_idx(seed, layers):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-2.0, 3.0, (N, 2)).astype(np.float32)
    idx = rng.integers(-1, layers, N).astype(np.int32)
    lod = rng.uniform(-0.5, 9.0, N).astype(np.float32)
    return uv, idx, lod


@pytest.mark.parametrize("footprint", [True, False])
@pytest.mark.parametrize("decode", [None, True, False])
def test_fetch_bilinear_matches_jax(scenes, decode, footprint):
    from hiprt_pt_tpu.assets.textures import build_texture_atlas as jbuild
    from hiprt_pt_tpu.ops.texture import fetch_bilinear as jfetch
    from hiprt_pt_tpu_torch.assets import textures as ttex
    from hiprt_pt_tpu_torch.ops.texture import fetch_bilinear as tfetch

    jscene, tscene = scenes
    ja, ta = jscene.textures, tscene.textures
    if not footprint:
        # a small atlas built without footprint rows: odd sizes, one image
        # with alpha, an image of one channel, a missing image
        rng = np.random.default_rng(9)
        imgs = [rng.integers(0, 256, (37, 53, 4), dtype=np.uint8),
                rng.random((20, 8, 3)).astype(np.float32),
                rng.integers(0, 256, (16, 16), dtype=np.uint8), None]
        import hiprt_pt_tpu.assets.textures as jtex

        old = (jtex.FOOTPRINT_MAX_TEXELS, ttex.FOOTPRINT_MAX_TEXELS)
        jtex.FOOTPRINT_MAX_TEXELS = ttex.FOOTPRINT_MAX_TEXELS = 10
        try:
            ja = jbuild(imgs, {0, 1}, layer_size=32)
            ta = ttex.build_texture_atlas(imgs, {0, 1}, layer_size=32)
        finally:
            jtex.FOOTPRINT_MAX_TEXELS, ttex.FOOTPRINT_MAX_TEXELS = old
        assert not ta.footprint and ta.has_alpha == ja.has_alpha is True
        assert np.array_equal(ta.texels.numpy(), np.asarray(ja.texels))
    uv, idx, lod = _uv_idx(1, ta.num_layers)
    for lo in (None, lod):
        ref = jfetch(ja, jnp.asarray(idx), jnp.asarray(uv),
                     None if lo is None else jnp.asarray(lo), decode_srgb=decode)
        got = tfetch(ta, _t(idx), _t(uv), None if lo is None else _t(lo),
                     decode_srgb=decode)
        _close(got, ref)
        assert np.all(got.numpy()[idx < 0] == 1.0)


def test_apply_textures_matches_jax(scenes):
    from hiprt_pt_tpu.core.material import MaterialBank as JBank
    from hiprt_pt_tpu.ops.texture import apply_textures as japply
    from hiprt_pt_tpu_torch.core.material import FIELD_NAMES, MaterialBank as TBank
    from hiprt_pt_tpu_torch.ops.texture import apply_textures as tapply

    jscene, tscene = scenes
    # every kind but the normal map (test_apply_normal_map_matches_jax),
    # sRGB and linear ones, and one kind (spec) that reads layers of both
    rows = [dict(base_color=[0.8, 0.7, 0.6], base_color_texture_index=0,
                 roughness_metallic_texture_index=12, emission=[1, 1, 1],
                 emission_texture_index=7),
            dict(roughness_texture_index=13, metallic_texture_index=14,
                 specular_texture_index=15, coat_texture_index=2,
                 sheen_texture_index=3, specular_transmission_texture_index=4,
                 base_color_texture_index=9),
            dict(base_color=[0.3, 0.3, 0.9], specular_texture_index=0)]
    jt = dataclasses.replace(jscene.textures)
    from hiprt_pt_tpu.assets.scene import build_scene as jbuild_scene
    from hiprt_pt_tpu_torch.assets.scene import texture_kinds

    # the kind flags build_scene derives for this bank
    tt = texture_kinds(tscene.textures, TBank.from_rows(rows))
    verts = np.zeros((3, 3), np.float32)
    verts[1, 0] = verts[2, 1] = 1.0
    js = jbuild_scene(verts, np.asarray([[0, 1, 2]]), np.zeros(1, np.int32),
                      JBank.from_rows(rows), textures=jt)
    assert tt.kinds_used == js.textures.kinds_used
    assert tt.kinds_srgb_any == js.textures.kinds_srgb_any
    assert tt.kinds_srgb_all == js.textures.kinds_srgb_all
    assert len(tt.kinds_used) == 9
    assert "spec" in tt.kinds_srgb_any and "spec" not in tt.kinds_srgb_all
    rng = np.random.default_rng(2)
    ids = rng.integers(0, len(rows), N).astype(np.int32)
    uv = rng.uniform(-1.0, 2.0, (N, 2)).astype(np.float32)
    jm = japply(js.textures, JBank.from_rows(rows).to_device().at_indices(
        jnp.asarray(ids)), jnp.asarray(uv))
    tm = tapply(tt, TBank.from_rows(rows).at_indices(_t(ids)), _t(uv))
    for name in FIELD_NAMES:
        _close(getattr(tm, name), getattr(jm, name))


def test_apply_normal_map_matches_jax(scenes):
    from hiprt_pt_tpu.ops.texture import apply_normal_map as jnm
    from hiprt_pt_tpu_torch.ops.texture import apply_normal_map as tnm

    jscene, tscene = scenes
    rng = np.random.default_rng(3)
    idx = rng.choice([-1, 16, 17], N).astype(np.int32)
    uv = rng.uniform(0.0, 4.0, (N, 2)).astype(np.float32)
    ns = rng.normal(size=(N, 3)).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=-1, keepdims=True)
    tan = rng.normal(size=(N, 3)).astype(np.float32)
    tan[: N // 8] = 0.0  # no tangent: the normal stays
    ref = jnm(jscene.textures, jnp.asarray(idx), jnp.asarray(uv),
              jnp.asarray(ns), jnp.asarray(tan))
    got = tnm(tscene.textures, _t(idx), _t(uv), _t(ns), _t(tan))
    _close(got, ref)
    moved = ~np.isclose(got.numpy(), ns).all(-1)
    assert moved.mean() > 0.3 and not moved[: N // 8].any()
    assert np.allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-5)
