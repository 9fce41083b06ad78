"""The principled BSDF's kernels (csrc/principled.cu, ops/cuda_bsdf.py) and
their dispatch (models/principled.py:eval_pdf, sample).

On the host: CPU tensors take the plain version and launch nothing; the
wrapper refuses CPU tensors, other dtypes and shapes; the cheap overrides
never reach the principled BSDF; the coefficient table the kernels read is
the plain version's fits and tables element for element, laid out as the
source reads it; each call is one span, nested where it runs.

On the card (marked ``cuda``; ``python -m pytest
tests/test_torch_bsdf_kernel.py -m cuda --noconftest``): the kernels
against the plain version on the card on 2^20 random lanes whose materials
switch every lobe on and off, under every combination of the four options
the kernels read; and a frame's launches. Tolerances: the RNG state equal
on every lane; the drawn lobe and the refracted flag equal on >= 99.99% of
lanes (a draw within rounding of a lobe's CDF edge or of the Fresnel split
may go the other way); f, pdf and wi within atol 1e-6 / rtol 1e-5 where
the draw agrees (the kernel rounds every operation as the plain version's
separate kernels do, so what differs is a reduction's order or a
library function's last bit)."""

import dataclasses
import itertools
import os
import re

import numpy as np
import pytest
import torch

from hiprt_pt_tpu_torch.core import settings as ts
from hiprt_pt_tpu_torch.core.material import FIELD_NAMES, MaterialBank
from hiprt_pt_tpu_torch.models import dispatcher
from hiprt_pt_tpu_torch.models import principled as pm
from hiprt_pt_tpu_torch.ops import cuda_bsdf, cuda_build
from hiprt_pt_tpu_torch.utils import spans

W, H = 32, 16
ATOL, RTOL = 1e-6, 1e-5
# the share of lanes whose drawn lobe and refracted flag must agree
DRAW_AGREES = 0.9999
OPTION_SETS = list(itertools.product([False, True], repeat=4))


@pytest.fixture(autouse=True)
def _fresh():
    spans.reset()
    spans.enable(True)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    spans.enable(True)
    spans.reset()
    torch.set_num_threads(n)


def _options(thin_film=True, ec=True, exact=False, caps=True, **kw):
    caps = (ts.GGXSamplingVariant.VNDF_SPHERICAL_CAPS if caps
            else ts.GGXSamplingVariant.VNDF)
    return ts.RenderOptions(do_thin_film=thin_film, do_energy_compensation=ec,
                            glass_compensation_exact=exact, ggx_sampling=caps,
                            **kw)


def random_lanes(n, seed, device):
    """(materials, n, wo, wi, eta_rel, rng_state) of ``n`` lanes: every lobe
    on or off by lane (coat, sheen, metal, glass, thin walls, thin film,
    anisotropy, the second roughness), directions on the whole sphere (a
    tenth of wo below the surface), eta_rel entering and exiting."""
    rng = np.random.default_rng(seed)

    def u(lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, n).astype(np.float32)

    def some(x, p=0.5):
        return np.where(rng.random(n) < p, x, 0.0).astype(np.float32)

    def pick(*values):
        return np.asarray(values, np.float32)[rng.integers(0, len(values), n)]

    fields = {
        "roughness": u(), "oren_nayar_sigma": u(), "metallic": pick(0.0, 1.0, -1.0),
        "metallic_F90_falloff_exponent": u(1.0, 8.0),
        "anisotropy": some(u(0.0, 0.95)), "anisotropy_rotation": some(u()),
        "second_roughness_weight": some(u()), "second_roughness": u(),
        "specular": pick(0.0, 1.0, -1.0), "specular_tint": u(),
        "coat": some(u()), "coat_medium_thickness": u(0.0, 10.0),
        "coat_roughness": u(), "coat_darkening": u(),
        "coat_anisotropy": some(u(0.0, 0.95)), "coat_ior": u(1.0, 2.5),
        "sheen": some(u()), "sheen_roughness": u(), "ior": u(1.0, 2.6),
        "specular_transmission": pick(0.0, 1.0, -1.0),
        "thin_walled": pick(0.0, 1.0), "thin_film": some(u()),
        "thin_film_ior": u(1.0, 2.5), "thin_film_thickness": u(0.0, 1000.0),
        "thin_film_hue_shift_degrees": u(-90.0, 90.0),
        "thin_film_base_ior_override": u(1.0, 2.5),
        "thin_film_do_ior_override": pick(0.0, 1.0),
    }
    # -1 marks a lane that takes a uniform value in [0, 1]
    for name in ("metallic", "specular", "specular_transmission"):
        fields[name] = np.where(fields[name] < 0.0, u(), fields[name])
    for name in cuda_bsdf.COLOR_FIELDS:
        fields[name] = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    defaults = MaterialBank.from_rows([{}])
    kw = {}
    for name in FIELD_NAMES:
        if name in fields:
            kw[name] = torch.from_numpy(fields[name])
        else:
            d = getattr(defaults, name)
            kw[name] = d.expand(n, *d.shape[1:]).contiguous()
    mats = MaterialBank(**{k: v.to(device) for k, v in kw.items()}).make_safe()

    def unit():
        v = rng.normal(size=(n, 3))
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)

    nrm, wo, wi = unit(), unit(), unit()
    up = (wo * nrm).sum(-1, keepdims=True) < 0
    wo = np.where(up & (rng.random((n, 1)) < 0.9), -wo, wo).astype(np.float32)
    eta = u(0.6, 1.8)
    state = rng.integers(0, 2**32, n, dtype=np.int64)
    return (mats, *(torch.from_numpy(a).to(device) for a in (nrm, wo, wi, eta)),
            torch.from_numpy(state).to(device))


# --- the host ------------------------------------------------------------

@pytest.fixture(scope="module")
def box():
    from hiprt_pt_tpu_torch.accel.build import build_bvh
    from hiprt_pt_tpu_torch.assets.stress import load_stress_scene

    scene, cam = load_stress_scene(aspect=2.0, tri_scale=0.01,
                                   with_textures=False, device="cpu")
    bvh = build_bvh(scene.vertices.numpy(), scene.triangles.numpy(), "cpu")
    return scene, cam, bvh


@pytest.mark.parametrize("thin_film,ec,exact,caps", OPTION_SETS[::5])
def test_cpu_tensors_take_the_plain_version(monkeypatch, thin_film, ec, exact,
                                            caps):
    """On the CPU eval_pdf and sample are the plain version's results and
    launch nothing."""
    def refuse(*a, **k):
        raise AssertionError("the wrapper was called on the CPU")

    monkeypatch.setattr(cuda_bsdf, "eval_pdf", refuse)
    monkeypatch.setattr(cuda_bsdf, "sample", refuse)
    opts = _options(thin_film, ec, exact, caps)
    mats, nrm, wo, wi, eta, state = random_lanes(2048, 3, "cpu")
    aux = {"eta_rel": eta}
    cuda_build.reset_launch_counts()
    f, pdf = pm.eval_pdf(opts, mats, nrm, wo, wi, aux)
    fp, pp = pm._eval_pdf_plain(opts, mats, nrm, wo, wi, aux)
    assert torch.equal(f, fp) and torch.equal(pdf, pp)
    assert float(pdf.max()) > 0.0
    got = pm.sample(opts, mats, nrm, wo, state, aux)
    ref = pm._sample_plain(opts, mats, nrm, wo, state, aux)
    for a, b in zip(got[:4], ref[:4]):
        assert torch.equal(a, b)
    assert torch.equal(got[4]["refracted"], ref[4]["refracted"])
    assert cuda_build.launch_counts["principled_eval"] == 0
    assert cuda_build.launch_counts["principled_sample"] == 0


def test_the_wrapper_refuses_what_the_kernels_do_not_take():
    opts = _options()
    mats, nrm, wo, wi, eta, state = random_lanes(64, 4, "cpu")
    table = pm.device_coefficients(nrm.device)
    cuda_build.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_bsdf.eval_pdf(opts, table, mats, nrm, wo, wi, eta)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_bsdf.sample(opts, table, mats, nrm, wo, state, eta)
    with pytest.raises(TypeError, match="wo"):
        cuda_bsdf.eval_pdf(opts, table, mats, nrm, wo.double(), wi, eta)
    with pytest.raises(TypeError, match="rng_state"):
        cuda_bsdf.sample(opts, table, mats, nrm, wo, state.to(torch.int32), eta)
    with pytest.raises(TypeError, match="mats.roughness"):
        cuda_bsdf.eval_pdf(opts, table, mats.__class__(**{
            **{k: getattr(mats, k) for k in FIELD_NAMES},
            "roughness": mats.roughness.double()}), nrm, wo, wi, eta)
    with pytest.raises(ValueError, match="wi has shape"):
        cuda_bsdf.eval_pdf(opts, table, mats, nrm, wo, wi[:32], eta)
    with pytest.raises(ValueError, match="eta_rel has shape"):
        cuda_bsdf.eval_pdf(opts, table, mats, nrm, wo, wi, eta[:, None])
    with pytest.raises(ValueError, match="mats.base_color has shape"):
        cuda_bsdf.sample(opts, table, mats.__class__(**{
            **{k: getattr(mats, k) for k in FIELD_NAMES},
            "base_color": mats.base_color[:, :2]}), nrm, wo, state, eta)
    assert cuda_build.launch_counts["principled_eval"] == 0
    assert cuda_build.launch_counts["principled_sample"] == 0


@pytest.mark.parametrize("override", ["LAMBERTIAN", "OREN_NAYAR"])
def test_the_cheap_overrides_never_reach_the_principled_bsdf(box, monkeypatch,
                                                             override):
    """The overrides route to their own eval and sampler: a frame under
    them calls neither eval_pdf nor sample of the principled BSDF, so it
    would launch neither kernel, and records no principled span."""
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.render.renderer import render_step

    def refuse(*a, **k):
        raise AssertionError("the principled BSDF was called")

    for name in ("eval_pdf", "sample", "_eval_pdf_plain", "_sample_plain"):
        monkeypatch.setattr(pm, name, refuse)
    monkeypatch.setattr(cuda_bsdf, "eval_pdf", refuse)
    monkeypatch.setattr(cuda_bsdf, "sample", refuse)
    opts = _options(bsdf_override=getattr(ts.BSDFOverride, override))
    mats, nrm, wo, wi, eta, state = random_lanes(256, 5, "cpu")
    dispatcher.bsdf_eval(opts, mats, nrm, wo, wi, {"eta_rel": eta})
    dispatcher.bsdf_sample(opts, mats, nrm, wo, state, {"eta_rel": eta})
    scene, cam, bvh = box
    for strategy in ("RIS_BSDF_LIGHT", "RESTIR_DI"):
        o = opts.replace(direct_light_sampling=getattr(
            ts.LightSamplingStrategy, strategy), max_bounces_static=2)
        state0 = init_render_state(W, H, 7, "cpu",
                                   with_restir=strategy == "RESTIR_DI")
        render_step(o, W, H, scene, bvh, state0, cam,
                    ts.RenderSettings(nb_bounces=2), ts.WorldSettings())
    assert not [r for r in spans.records() if r.name.startswith("principled/")]


def _csrc() -> str:
    with open(os.path.join(cuda_build.CSRC, "principled.cu")) as f:
        return f.read()


def test_the_coefficient_table_is_the_plain_fits():
    """The table the kernels read holds the plain version's arrays element
    for element, at the offsets the source computes, and the source's
    enums name the fields the wrapper passes, in its order."""
    table = pm.coefficient_table()
    on_host = pm.device_coefficients(torch.device("cpu"))
    assert np.array_equal(on_host.numpy(), table)
    assert pm.device_coefficients(torch.device("cpu")) is on_host
    parts = [pm._GLASS_POLY, pm._CONDUCTOR_POLY, pm._SHEEN_LTC_POLY,
             pm._GLASS_IORS, pm._GGX_ESS, pm._GLASS_ALL]
    at = 0
    for arr in parts:
        got = table[at:at + arr.size].reshape(arr.shape)
        assert got.dtype == np.float32 and np.array_equal(got, arr)
        at += arr.size
    assert at == table.size
    text = _csrc()
    consts = {k: int(v) for k, v in re.findall(
        r"\b(k(?:GlassD[RCI]|CondD|SheenDeg|Iors|CondRes|GlassRes)) = (\d+)", text)}
    assert (consts["kGlassDR"], consts["kGlassDC"], consts["kGlassDI"]) == \
        pm._GLASS_POLY_DEG
    assert (consts["kCondD"],) * 2 == pm._CONDUCTOR_POLY_DEG
    assert consts["kSheenDeg"] == pm._SHEEN_LTC_POLY.shape[1]
    assert consts["kIors"] == len(pm._GLASS_IORS)
    assert pm._GGX_ESS.shape == (consts["kCondRes"],) * 2
    assert pm._GLASS_ALL.shape[2:] == (consts["kGlassRes"],) * 2
    staged = pm._GLASS_POLY.size + pm._CONDUCTOR_POLY.size + \
        pm._SHEEN_LTC_POLY.size + pm._GLASS_IORS.size
    assert table.size == staged + pm._GGX_ESS.size + pm._GLASS_ALL.size

    def enum(name):
        body = re.search(r"enum " + name + r" \{([^}]*)\}", text).group(1)
        return tuple(w.strip() for w in body.split(",") if w.strip())

    assert enum("Scalar") == cuda_bsdf.SCALAR_FIELDS + ("kCount",)
    assert enum("Color") == cuda_bsdf.COLOR_FIELDS + ("kCount",)
    assert set(cuda_bsdf.SCALAR_FIELDS + cuda_bsdf.COLOR_FIELDS) <= set(FIELD_NAMES)


def test_the_kernel_constants_are_the_plain_version_scalars():
    """The Python doubles the source rounds to f32 are the plain version's:
    pi, 2 pi, 1 / pi and the F82 control angle's two powers, whose
    reciprocal the source takes in double, as PyTorch does for a tensor
    divided by a Python number."""
    import math

    from hiprt_pt_tpu_torch.models import fresnel
    from hiprt_pt_tpu_torch.ops.sampling import INV_PI

    text = _csrc()
    got = {k: float(v) for k, v in re.findall(
        r"#define (\w+) F32\(([0-9.e-]+)\)", text)}
    mbar = 1.0 - fresnel._COS_82
    assert got["PI_F"] == math.pi and got["TWO_PI_F"] == 2.0 * math.pi
    assert got["INV_PI_F"] == INV_PI and got["ETA_MIN"] == 1.0 + 1e-3
    assert got["F82_MBAR5"] == mbar ** 5
    denom = re.search(r"#define F82_DENOM ([0-9.e-]+)\n", text).group(1)
    assert float(denom) == fresnel._COS_82 * (mbar ** 6)


@pytest.mark.parametrize("options", [
    dict(), dict(thin_film=False), dict(ec=False), dict(exact=True),
    dict(caps=False), dict(thin_film=False, ec=False, exact=True, caps=False)])
def test_the_option_flags(options):
    opts = _options(**options)
    flags = cuda_bsdf.option_flags(opts)
    assert bool(flags & cuda_bsdf.THIN_FILM) == opts.do_thin_film
    assert bool(flags & cuda_bsdf.ENERGY_COMPENSATION) == opts.do_energy_compensation
    assert bool(flags & cuda_bsdf.COMPENSATION_EXACT) == opts.glass_compensation_exact
    assert bool(flags & cuda_bsdf.SPHERICAL_CAPS) == (
        opts.ggx_sampling == ts.GGXSamplingVariant.VNDF_SPHERICAL_CAPS)
    text = _csrc()
    for name, bit in (("kThinFilm", cuda_bsdf.THIN_FILM),
                      ("kEnergyCompensation", cuda_bsdf.ENERGY_COMPENSATION),
                      ("kCompensationExact", cuda_bsdf.COMPENSATION_EXACT),
                      ("kSphericalCaps", cuda_bsdf.SPHERICAL_CAPS)):
        assert re.search(rf"constexpr int {name} = {bit};", text)


@pytest.mark.parametrize("strategy,evals,eval_parents", [
    ("RIS_BSDF_LIGHT", 4, {"bounce/direct"}),
    ("RESTIR_DI", 5, {"bounce/direct", "restir/final shading"})])
def test_a_frame_evaluates_and_samples_once_a_bounce(box, strategy, evals,
                                                     eval_parents):
    """A frame of 4 bounces under RIS (proxy target) evaluates the winner
    once in each bounce's direct light and samples once in each bounce's
    BSDF step; ReSTIR evaluates once more in final shading: 4 + 4 and
    5 + 4 spans, which are the kernels' launches on the card."""
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.render.renderer import render_step

    scene, cam, bvh = box
    opts = ts.RenderOptions(
        direct_light_sampling=getattr(ts.LightSamplingStrategy, strategy),
        max_bounces_static=4)
    state = init_render_state(W, H, 7, "cpu", with_restir=strategy == "RESTIR_DI")
    render_step(opts, W, H, scene, bvh, state, cam,
                ts.RenderSettings(nb_bounces=4), ts.WorldSettings())
    recs = spans.records()
    ev = [r for r in recs if r.name == "principled/eval"]
    sa = [r for r in recs if r.name == "principled/sample"]
    assert sum(r.name == "bounce" for r in recs) == 4
    assert len(ev) == evals and len(sa) == 4
    assert {r.parent for r in ev} == eval_parents
    assert {r.parent for r in sa} == {"bounce/bsdf"}


@pytest.mark.parametrize("tag", ["headline", "restir", "cornell", "envmap",
                                 "stress", "viewer", "cli"])
def test_chip_smoke_counts_the_bsdf_launches(box, tag):
    """chip_smoke.py holds a path's principled launches a frame to the
    calls its options make: RIS and ReSTIR one eval a bounce (ReSTIR one
    more in final shading), MIS one a light sample a bounce, an
    importance-sampled envmap one more a bounce; a sample a bounce; none
    under the Lambertian override."""
    import chip_smoke
    from hiprt_pt_tpu_torch.paths import slice_options

    opts, settings, _world = slice_options(tag)
    scene = box[0]
    if tag == "envmap":
        # the envmap path's scene has one; only its presence is read here
        scene = dataclasses.replace(scene, envmap=object())
    got = chip_smoke.bsdf_calls_per_frame(opts, settings, scene)
    bounces = min(opts.max_bounces_static, int(settings.nb_bounces))
    want = {"stress": {}, "headline": {"principled_eval": 4, "principled_sample": 4},
            "restir": {"principled_eval": 5, "principled_sample": 4},
            "cli": {"principled_eval": 5, "principled_sample": 4},
            "cornell": {"principled_eval": 4, "principled_sample": 4},
            "envmap": {"principled_eval": 12, "principled_sample": 6},
            "viewer": {"principled_eval": bounces, "principled_sample": bounces}}
    assert got == want[tag]
    assert {k for k, v in got.items() if v} <= chip_smoke.path_kernels(tag)


@pytest.mark.parametrize("name,evals", [("pixels-gltf", 4), ("samples-restir", 5)])
def test_chip_smoke_holds_the_ranks_to_the_bsdf_counts(tmp_path, name, evals):
    """chip_smoke.py's parallel phase holds each rank's timed samples of
    these runs to bsdf_calls_per_frame: 4 + 4 a pixel-DP RIS sample, 5 + 4
    a sample-DP ReSTIR one."""
    import chip_smoke
    from hiprt_pt_tpu_torch.paths import parallel_runs

    run = next(r for r in parallel_runs(str(tmp_path)) if r["name"] == name)
    assert chip_smoke.bsdf_calls_per_frame(run["options"], run["settings"]) == {
        "principled_eval": evals, "principled_sample": 4}


def test_the_plain_lobe_is_the_plain_draw():
    """chip_smoke.plain_lobe, which the checks on the card hold the
    kernel's drawn lobe to, draws every lobe, and the plain sample refracts
    only where it names the glass lobe."""
    import chip_smoke

    opts = _options()
    mats, nrm, wo, _wi, eta, state = random_lanes(8192, 6, "cpu")
    lobe = chip_smoke.plain_lobe(opts, mats, nrm, wo, state)
    refracted = pm._sample_plain(opts, mats, nrm, wo, state,
                                 {"eta_rel": eta})[4]["refracted"]
    assert lobe.dtype == torch.int8 and lobe.shape == (8192,)
    assert set(lobe.tolist()) == set(range(6))
    assert bool(refracted.any()) and bool((lobe[refracted] == 3).all())


# --- the card ------------------------------------------------------------

N_CARD = 1 << 20


@pytest.fixture(scope="module")
def card_lanes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    return random_lanes(N_CARD, 20, torch.device("cuda:0"))


def _far(got, ref):
    """Lanes where got and ref differ past ATOL + RTOL |ref| (any channel),
    and the largest relative error there and elsewhere."""
    err = (got - ref).abs()
    tol = ATOL + RTOL * ref.abs()
    bad = err > tol
    if bad.dim() > 1:
        bad = bad.any(-1)
    rel = (err / ref.abs().clamp_min(ATOL / RTOL))
    return bad, float(rel.max()) if rel.numel() else 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("thin_film,ec,exact,caps", OPTION_SETS)
def test_the_kernels_match_the_plain_version_on_the_card(card_lanes, thin_film,
                                                         ec, exact, caps):
    import chip_smoke

    mats, nrm, wo, wi, eta, state = card_lanes
    opts = _options(thin_film, ec, exact, caps)
    table = pm.device_coefficients(nrm.device)
    n = nrm.shape[0]
    cuda_build.reset_launch_counts()
    f, pdf = cuda_bsdf.eval_pdf(opts, table, mats, nrm, wo, wi, eta)
    rng_k, wi_k, f_k, pdf_k, refr_k, lobe_k = cuda_bsdf.sample(
        opts, table, mats, nrm, wo, state, eta, with_lobe=True)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["principled_eval"] == 1
    assert cuda_build.launch_counts["principled_sample"] == 1
    aux = {"eta_rel": eta}
    fp, pp = pm._eval_pdf_plain(opts, mats, nrm, wo, wi, aux)
    bad_f, rel_f = _far(f, fp)
    bad_p, rel_p = _far(pdf, pp)
    print(f"eval {opts.do_thin_film, opts.do_energy_compensation, exact, caps}: "
          f"f off on {int(bad_f.sum())} lanes (largest relative error "
          f"{rel_f:.3g}), pdf on {int(bad_p.sum())} ({rel_p:.3g})")
    assert not bool(bad_f.any()) and not bool(bad_p.any())
    assert float((pp > 0).float().mean()) > 0.5

    rng_p, wi_p, f_p, pdf_p, aux_p = pm._sample_plain(opts, mats, nrm, wo,
                                                      state, aux)
    assert torch.equal(rng_k, rng_p)
    lobe_p = chip_smoke.plain_lobe(opts, mats, nrm, wo, state)
    same = (lobe_k == lobe_p) & (refr_k == aux_p["refracted"])
    share = float(same.float().mean())
    for k in range(6):
        assert int((lobe_p == k).sum()) > n // 2000, f"lobe {k} is hardly drawn"
    bad_w, rel_w = _far(wi_k[same], wi_p[same])
    bad_fs, rel_fs = _far(f_k[same], f_p[same])
    bad_ps, rel_ps = _far(pdf_k[same], pdf_p[same])
    print(f"sample: draw agrees on {share:.7f}; where it does, wi off on "
          f"{int(bad_w.sum())} ({rel_w:.3g}), f on {int(bad_fs.sum())} "
          f"({rel_fs:.3g}), pdf on {int(bad_ps.sum())} ({rel_ps:.3g})")
    assert share >= DRAW_AGREES
    assert not bool(bad_w.any())
    assert not bool(bad_fs.any()) and not bool(bad_ps.any())


@pytest.mark.cuda
def test_the_kernels_refuse_on_the_card(card_lanes):
    mats, nrm, wo, wi, eta, state = card_lanes
    opts = _options()
    table = pm.device_coefficients(nrm.device)
    cuda_build.reset_launch_counts()
    with pytest.raises(TypeError):
        cuda_bsdf.eval_pdf(opts, table, mats, nrm, wo.double(), wi, eta)
    with pytest.raises(ValueError):
        cuda_bsdf.sample(opts, table, mats, nrm, wo, state[:10], eta)
    with pytest.raises(ValueError):
        cuda_bsdf.eval_pdf(opts, table, mats, nrm, wo, wi.cpu(), eta)
    with pytest.raises(ValueError, match="table has shape"):
        cuda_bsdf.sample(opts, table[:-1], mats, nrm, wo, state, eta)
    with pytest.raises(ValueError, match="table is on"):
        cuda_bsdf.eval_pdf(opts, table.cpu(), mats, nrm, wo, wi, eta)
    assert cuda_build.launch_counts["principled_eval"] == 0
    assert cuda_build.launch_counts["principled_sample"] == 0
    # a strided or broadcast input is made contiguous, as the baker's
    # normal is
    up = torch.tensor([0.0, 0.0, 1.0], device=nrm.device).expand(64, 3)
    m64 = mats.__class__(**{k: getattr(mats, k)[:64] for k in FIELD_NAMES})
    f, pdf = cuda_bsdf.eval_pdf(opts, table, m64, up, wo[:64], wi[:64], eta[:64])
    fp, pp = pm._eval_pdf_plain(opts, m64, up, wo[:64], wi[:64],
                                {"eta_rel": eta[:64]})
    assert not bool(_far(f, fp)[0].any()) and not bool(_far(pdf, pp)[0].any())
    assert cuda_build.launch_counts["principled_eval"] == 1


@pytest.fixture(scope="module")
def card_box():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    from hiprt_pt_tpu_torch.accel.build import build_bvh
    from hiprt_pt_tpu_torch.assets.stress import load_stress_scene

    dev = torch.device("cuda:0")
    scene, cam = load_stress_scene(aspect=2.0, tri_scale=0.01,
                                   with_textures=False, device=dev)
    bvh = build_bvh(scene.vertices.cpu().numpy(), scene.triangles.cpu().numpy(),
                    dev)
    return scene, cam, bvh


@pytest.mark.cuda
@pytest.mark.parametrize("strategy,evals", [("RIS_BSDF_LIGHT", 4),
                                            ("RESTIR_DI", 5)])
def test_a_card_frame_launches_the_kernels_once_a_call(card_box, monkeypatch,
                                                       strategy, evals):
    """A frame of 4 bounces on the card launches principled_eval_kernel 4
    (RIS) or 5 (ReSTIR) times and principled_sample_kernel 4 times, one
    launch a span, and never runs the plain version."""
    from hiprt_pt_tpu_torch.core.state import init_render_state
    from hiprt_pt_tpu_torch.render.renderer import render_step

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(pm, "_eval_pdf_plain", refuse)
    monkeypatch.setattr(pm, "_sample_plain", refuse)
    scene, cam, bvh = card_box
    opts = ts.RenderOptions(
        direct_light_sampling=getattr(ts.LightSamplingStrategy, strategy),
        max_bounces_static=4)
    state = init_render_state(256, 128, 7, scene.vertices.device,
                              with_restir=strategy == "RESTIR_DI")
    cuda_build.reset_launch_counts()
    render_step(opts, 256, 128, scene, bvh, state, cam,
                ts.RenderSettings(nb_bounces=4), ts.WorldSettings())
    torch.cuda.synchronize()
    spans.flush()
    recs = spans.records()
    assert cuda_build.launch_counts["principled_eval"] == evals
    assert cuda_build.launch_counts["principled_sample"] == 4
    assert sum(r.name == "principled/eval" for r in recs) == evals
    assert sum(r.name == "principled/sample" for r in recs) == 4
