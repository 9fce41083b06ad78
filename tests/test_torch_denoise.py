"""The port's denoisers against the JAX package: the à-trous filter
(hiprt_pt_tpu_torch/render/denoise.py) and the learned CNN
(render/denoise_nn.py, its weights copied from the JAX package), alone on
seeded inputs and through ``denoise(renderer)`` on a port render, whose
AOVs and variance maps the JAX package's ``denoise`` reads from a stub
renderer holding the same arrays. No JAX render step is compiled here.

Tolerances: à-trous and ``denoise`` atol 1e-5 + rtol 1e-5; the CNN atol
1e-5 + rtol 1e-4 (five f32 convolutions summed in another order)."""

import importlib
import os
import sys
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_parity as tp  # noqa: E402

# render/__init__ exports a function named denoise, which hides the module
jd = importlib.import_module("hiprt_pt_tpu.render.denoise")
jn = importlib.import_module("hiprt_pt_tpu.render.denoise_nn")
td = importlib.import_module("hiprt_pt_tpu_torch.render.denoise")
tn = importlib.import_module("hiprt_pt_tpu_torch.render.denoise_nn")

# the à-trous inputs and the render that denoise() reads: 48x32, so that
# the JAX package compiles its filter once for both
W, H = 48, 32


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as in test_torch_envmap.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _aovs(seed: int, h: int = H, w: int = W) -> dict:
    """Seeded denoiser inputs: an HDR image with fireflies, albedo, unit
    normals, the variance of the mean and per-pixel sample counts of which
    some are below 2."""
    g = np.random.default_rng(seed)
    color = g.gamma(2.0, 0.3, (h, w, 3)).astype(np.float32)
    hot = g.random((h, w)) < 0.02
    color[hot] *= 60.0
    normal = g.normal(size=(h, w, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    return {
        "color": color,
        "albedo": g.random((h, w, 3)).astype(np.float32),
        "normal": normal,
        "variance": (g.random((h, w)) * 0.05).astype(np.float32),
        "spp_map": g.integers(1, 48, (h, w)).astype(np.float32),
    }


def _both(arrays: dict):
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


@pytest.mark.parametrize("variance", [True, False], ids=["variance", "fixed-sigma"])
@pytest.mark.parametrize("prefilter", [True, False], ids=["prefilter", "raw"])
def test_atrous_matches_jax(prefilter, variance):
    """Five iterations of the 5x5 B3 taps at strides 1 to 16, with and
    without the firefly prefilter and the variance rule (with spp < 2 at
    some pixels)."""
    a = _aovs(1)
    if not variance:
        a.pop("variance")
        a.pop("spp_map")
    ja, ta = _both(a)
    # prefilter stays a default where it is on, as denoise() calls it
    kw = {} if prefilter else {"prefilter": False}
    ref = jd.atrous_denoise(ja.pop("color"), ja.pop("albedo"), ja.pop("normal"),
                            **ja, **kw)
    got = td.atrous_denoise(ta.pop("color"), ta.pop("albedo"), ta.pop("normal"),
                            **ta, **kw)
    assert got.dtype == torch.float32 and got.shape == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_suppress_fireflies_matches_jax():
    color = _aovs(2)["color"]
    ref = jd.suppress_fireflies(jnp.asarray(color), 2.5)
    got = td.suppress_fireflies(torch.from_numpy(color), 2.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    assert (got.numpy() < color).any()


def test_atrous_reduces_noise_and_keeps_edges():
    """tests/test_denoise.py's check on the port: a two-colour image with
    noise comes out closer to the clean image, its albedo edge kept."""
    g = np.random.default_rng(0)
    clean = np.zeros((64, 64, 3), np.float32)
    clean[:, :32] = [1.0, 0.2, 0.2]
    clean[:, 32:] = [0.2, 0.2, 1.0]
    normal = np.tile([0.0, 0.0, 1.0], (64, 64, 1)).astype(np.float32)
    noisy = clean + g.normal(0, 0.25, clean.shape).astype(np.float32)
    out = td.atrous_denoise(torch.from_numpy(noisy), torch.from_numpy(clean),
                            torch.from_numpy(normal)).numpy()
    assert np.abs(out - clean).mean() < 0.4 * np.abs(noisy - clean).mean()
    assert out[:, :30, 0].mean() > 0.7 and out[:, 34:, 0].mean() < 0.4


def test_weights_are_the_jax_packages_byte_for_byte():
    with open(jn.WEIGHTS_PATH, "rb") as f:
        jax_bytes = f.read()
    with open(tn.WEIGHTS_PATH, "rb") as f:
        assert f.read() == jax_bytes
    assert len(jax_bytes) == 133_082


def _cnn_inputs(seed: int, h: int = 24, w: int = 40):
    a = _aovs(seed, h, w)
    a["atrous"] = (a["color"] * 0.7).astype(np.float32)
    return _both(a)


def _apply(mod, params, x):
    return mod.apply(params, x["color"], x["atrous"], x["albedo"], x["normal"],
                     x["variance"], x["spp_map"])


def test_cnn_matches_jax():
    """The shipped weights through interop.denoiser_params_from_numpy (HWIO
    to OIHW) on a 40x24 input."""
    from hiprt_pt_tpu_torch import interop

    with np.load(tn.WEIGHTS_PATH) as data:
        params = interop.denoiser_params_from_numpy(dict(data), "cpu")
    assert [tuple(c.weight.shape) for c in params.convs] == [
        (co, ci, 3, 3) for ci, co, _d in tn._LAYERS]
    jx, tx = _cnn_inputs(3)
    ref = _apply(jn, jn.load_params(), jx)
    got = _apply(tn, params, tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-4)
    # the network changes the à-trous input
    assert np.abs(got.numpy() - tx["atrous"].numpy()).max() > 1e-3
    # without the maps: zero variance, one sample
    ref0 = jn.apply(jn.load_params(), jx["color"], jx["atrous"], jx["albedo"],
                    jx["normal"])
    got0 = tn.apply(params, tx["color"], tx["atrous"], tx["albedo"],
                    tx["normal"])
    np.testing.assert_allclose(got0.numpy(), np.asarray(ref0), atol=1e-5,
                               rtol=1e-4)


def test_saved_params_load_in_jax(tmp_path, monkeypatch):
    """init_params from a torch Generator (every layer then drawn, so that
    the output depends on all five), save_params, and the JAX package's
    load_params reads the file: same arrays, same output."""
    g = torch.Generator().manual_seed(5)
    net = tn.init_params(g, device="cpu")
    x = _cnn_inputs(4)[1]
    # untrained: the identity residual, the à-trous input clamped at 0
    torch.testing.assert_close(_apply(tn, net, x), x["atrous"].clamp_min(0.0))
    with torch.no_grad():
        net.convs[-1].weight.copy_(torch.randn(net.convs[-1].weight.shape,
                                               generator=g) * 0.05)
    path = str(tmp_path / "weights.npz")
    tn.save_params(net, path)
    monkeypatch.setattr(jn, "WEIGHTS_PATH", path)
    jparams = jn.load_params()
    shipped = np.load(tn.WEIGHTS_PATH)
    for i, p in enumerate(jparams):
        assert p["w"].shape == shipped[f"w{i}"].shape
    jx, tx = _cnn_inputs(4)
    np.testing.assert_allclose(_apply(tn, net, tx).numpy(),
                               np.asarray(_apply(jn, jparams, jx)),
                               atol=1e-5, rtol=1e-4)
    back = tn.load_params(path, device="cpu")
    for a, b in zip(back.parameters(), net.parameters()):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """A port Renderer after 2 samples on the CPU at 48x32 (tile-major
    order) on a test-written Cornell .glb: the full principled BSDF, MIS,
    2 bounces."""
    from hiprt_pt_tpu_torch.assets.loader import load_scene_file
    from hiprt_pt_tpu_torch.core import settings as ts
    from hiprt_pt_tpu_torch.render.renderer import Renderer

    glb = tp.write_cornell_glb(str(tmp_path_factory.mktemp("dn") / "c.glb"),
                               W / H)
    scene, cam, bvh = load_scene_file(glb, aspect=W / H, with_bvh=True,
                                      device="cpu")
    r = Renderer(scene, cam, W, H, bvh=bvh, options=ts.RenderOptions(
        direct_light_sampling=ts.LightSamplingStrategy.MIS,
        max_bounces_static=2),
        settings=ts.RenderSettings(nb_bounces=2, samples_per_frame=2))
    with torch.inference_mode():
        r.step()
    return r


def _stub(r):
    """The JAX package's view of the port renderer ``r``: its images and
    its state's buffers as jnp arrays."""
    st = r.state
    return types.SimpleNamespace(
        width=r.width, height=r.height, hdr_image=r.hdr_image,
        aov_images=r.aov_images,
        state=types.SimpleNamespace(**{
            k: jnp.asarray(getattr(st, k).numpy())
            for k in ("pixel_sample_count", "accum", "accum_sq_luminance")}))


def test_collect_aovs_matches_jax(rendered):
    """The variance and spp maps leave the tile-major order by the route of
    hdr_image (unscramble, then flip): the JAX package's on the same
    buffers."""
    ref = jd.collect_aovs(_stub(rendered))
    got = td.collect_aovs(rendered)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)
    var = got[3].numpy()
    assert var.shape == (H, W) and var.std() > 0


@pytest.mark.parametrize("method", ["atrous", "nn"])
def test_denoise_renderer_matches_jax(rendered, method):
    ref = jd.denoise(_stub(rendered), method=method)
    got = td.denoise(rendered, method=method)
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=1e-5)
    raw = rendered.hdr_image()
    tv = [np.abs(np.diff(np.clip(x, 0, 1), axis=0)).mean() for x in (raw, got)]
    assert tv[1] < tv[0]


def test_denoise_blend_and_missing_weights(rendered, monkeypatch, tmp_path):
    """blend mixes the raw image back in; "nn" raises without weights, where
    "auto" (the wavelet filter) needs none."""
    full = td.denoise(rendered)
    half = td.denoise(rendered, blend=0.5)
    np.testing.assert_allclose(half, 0.5 * full + 0.5 * rendered.hdr_image(),
                               atol=1e-6)
    monkeypatch.setattr(tn, "WEIGHTS_PATH", str(tmp_path / "missing.npz"))
    with pytest.raises(FileNotFoundError, match="weights missing"):
        td.denoise(rendered, method="nn")
    np.testing.assert_array_equal(td.denoise(rendered, method="auto"), full)
