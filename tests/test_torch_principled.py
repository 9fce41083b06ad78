"""The port's principled BSDF stack against the JAX package on seeded numpy
inputs: Fresnel, microfacet, thin film, dispersion, the material helpers,
the import-time fits, and principled eval/pdf and sample for every lobe,
both GGX sampling variants and both energy-compensation paths (fitted
polynomials and exact table lookups). Then the BSDF-level white-furnace
bounds of tests/test_principled.py, run on the port, and the LUT copies.

Tolerances: f32, atol 1e-5 and rtol 1e-4 (XLA's CPU code may contract
products into FMAs and uses its own transcendentals, so results differ in
the last bits); sampled directions within atol 1e-4. A sampled direction
that lands within rounding of a lobe or refraction boundary can take the
other branch, so sampled directions are held on >= 99.9% of rays.
sample()'s f and pdf are ill-conditioned in the last bits of the sampled
direction; they are held at the spread the JAX package shows against itself
(see test_principled_sample_matches_jax), and the port's eval_pdf at the
JAX package's sampled direction is held at atol 1e-5 / rtol 1e-4."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

N = 4096
ATOL, RTOL = 1e-5, 1e-4

# one material per lobe, plus all of them mixed per ray
MATERIALS = {
    "diffuse": dict(base_color=[0.8, 0.5, 0.3], roughness=0.6, specular=0.0,
                    oren_nayar_sigma=0.4),
    "specular": dict(base_color=[0.6, 0.6, 0.7], roughness=0.3, ior=1.5,
                     specular_tint=0.5, specular_color=[0.9, 0.8, 0.7]),
    "metal": dict(base_color=[0.95, 0.64, 0.54], metallic=1.0, roughness=0.25,
                  anisotropy=0.7, anisotropy_rotation=0.3, second_roughness=0.7,
                  second_roughness_weight=0.3, metallic_F82=[0.9, 0.8, 0.7]),
    "glass": dict(base_color=[0.9, 0.95, 1.0], specular_transmission=1.0,
                  ior=1.5, roughness=0.2),
    "thin_walled": dict(specular_transmission=1.0, ior=1.45, roughness=0.3,
                        thin_walled=1.0),
    "coat": dict(base_color=[0.6, 0.1, 0.1], coat=1.0, coat_roughness=0.1,
                 roughness=0.4, coat_medium_absorption=[0.8, 0.9, 0.7],
                 coat_medium_thickness=3.0),
    "sheen": dict(base_color=[0.2, 0.25, 0.6], sheen=0.8, roughness=0.7,
                  sheen_color=[0.9, 0.9, 1.0], sheen_roughness=0.4),
    "thin_film": dict(base_color=[0.1, 0.1, 0.1], thin_film=1.0, metallic=1.0,
                      thin_film_thickness=420.0, thin_film_ior=1.6,
                      roughness=0.1, thin_film_hue_shift_degrees=30.0),
}
CASES = list(MATERIALS) + ["mixed"]


def _rng(seed):
    return np.random.default_rng(seed)


def _unit(rng, n=N):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=rtol)


def _frame(seed):
    """World normals, outgoing directions above them, incoming directions
    on the whole sphere, relative IORs on both sides of 1."""
    rng = _rng(seed)
    n, wo, wi = _unit(rng), _unit(rng), _unit(rng)
    wo = np.where((wo * n).sum(-1, keepdims=True) < 0, -wo, wo).astype(np.float32)
    eta = rng.uniform(0.6, 1.8, N).astype(np.float32)
    return n, wo, wi, eta


def _local_dirs(seed, upper=True):
    rng = _rng(seed)
    w = _unit(rng)
    if upper:
        w[:, 2] = np.abs(w[:, 2]) + 1e-3
        w /= np.linalg.norm(w, axis=-1, keepdims=True)
    return w.astype(np.float32)


def _banks(case):
    """(JAX gathered bank, port gathered bank) for a case, made safe."""
    from hiprt_pt_tpu.core.material import MaterialBank as JBank
    from hiprt_pt_tpu_torch.core.material import MaterialBank as TBank

    rows = list(MATERIALS.values()) if case == "mixed" else [MATERIALS[case]]
    ids = _rng(5).integers(0, len(rows), N).astype(np.int32)
    jm = JBank.from_rows(rows).to_device().at_indices(jnp.asarray(ids)).make_safe()
    tm = TBank.from_rows(rows).at_indices(_t(ids)).make_safe()
    return jm, tm


def _options(ggx="VNDF_SPHERICAL_CAPS", exact=False):
    from hiprt_pt_tpu.core import settings as js
    from hiprt_pt_tpu_torch.core import settings as ts

    return (js.RenderOptions(ggx_sampling=js.GGXSamplingVariant[ggx],
                             glass_compensation_exact=exact),
            ts.RenderOptions(ggx_sampling=ts.GGXSamplingVariant[ggx],
                             glass_compensation_exact=exact))


# --- building blocks ---------------------------------------------------------

def test_fresnel_matches_jax():
    from hiprt_pt_tpu.models import fresnel as jf
    from hiprt_pt_tpu_torch.models import fresnel as tf

    rng = _rng(1)
    cos = rng.uniform(0.0, 1.0, N).astype(np.float32)
    eta = rng.uniform(0.4, 2.5, N).astype(np.float32)
    _close(tf.fresnel_dielectric(_t(cos), _t(eta)),
           jf.fresnel_dielectric(jnp.asarray(cos), jnp.asarray(eta)))
    f0 = rng.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    for a in (f0, f0[:, 0]):
        _close(tf.schlick(_t(a), _t(cos)), jf.schlick(jnp.asarray(a), jnp.asarray(cos)))
    f82, f90 = (rng.uniform(0.3, 1.0, (N, 3)).astype(np.float32) for _ in range(2))
    expo = rng.uniform(1.0, 8.0, N).astype(np.float32)
    _close(tf.f82_tint(_t(f0), _t(f82), _t(f90), _t(expo), _t(cos)),
           jf.f82_tint(*(jnp.asarray(a) for a in (f0, f82, f90, expo, cos))))


def test_microfacet_matches_jax():
    from hiprt_pt_tpu.models import microfacet as jm
    from hiprt_pt_tpu_torch.models import microfacet as tm

    rng = _rng(2)
    wo, wi = _local_dirs(3), _local_dirs(4, upper=False)
    ax, ay = (rng.uniform(0.01, 1.0, N).astype(np.float32) for _ in range(2))
    u1, u2 = rng.random((2, N), dtype=np.float32)
    eta = rng.uniform(0.5, 2.0, N).astype(np.float32)
    rot = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    J = lambda *a: [jnp.asarray(x) for x in a]  # noqa: E731
    T = lambda *a: [_t(x) for x in a]  # noqa: E731
    h = np.asarray(jm.sample_vndf_spherical_caps(*J(wo, ax, ay, u1, u2)))
    for name, args in (("ggx_ndf", (h, ax, ay)), ("smith_lambda", (wi, ax, ay)),
                       ("smith_g1", (wo, ax, ay)),
                       ("smith_g2_height_correlated", (wo, wi, ax, ay)),
                       ("sample_vndf", (wo, ax, ay, u1, u2)),
                       ("sample_vndf_spherical_caps", (wo, ax, ay, u1, u2)),
                       ("vndf_pdf", (wo, h, ax, ay)), ("reflect_local", (wo, h)),
                       ("anisotropy_rotate", (wo, rot))):
        _close(getattr(tm, name)(*T(*args)), getattr(jm, name)(*J(*args)))
    wt, tir = tm.refract_local(*T(wo, h, eta))
    wt_j, tir_j = jm.refract_local(*J(wo, h, eta))
    assert np.array_equal(tir.numpy(), np.asarray(tir_j))
    _close(wt, wt_j)


def test_thin_film_matches_jax():
    from hiprt_pt_tpu.models.thin_film import thin_film_reflectance as jtf
    from hiprt_pt_tpu_torch.models.thin_film import thin_film_reflectance as ttf

    rng = _rng(6)
    args = (rng.uniform(0.0, 1.0, N), rng.uniform(1.0, 2.2, N),
            rng.uniform(100.0, 1200.0, N), rng.uniform(1.0, 2.5, N),
            rng.uniform(-90.0, 90.0, N))
    args = [a.astype(np.float32) for a in args]
    got = ttf(*(_t(a) for a in args))
    assert got.shape == (N, 3)
    _close(got, jtf(*(jnp.asarray(a) for a in args)))


def test_dispersion_matches_jax():
    from hiprt_pt_tpu.models import dispersion as jd
    from hiprt_pt_tpu_torch.models import dispersion as td

    assert np.array_equal(td._RGB_NORM, jd._RGB_NORM)
    rng = _rng(7)
    u = rng.random(N, dtype=np.float32)
    lam_t, lam_j = td.sample_wavelength(_t(u)), jd.sample_wavelength(jnp.asarray(u))
    _close(lam_t, lam_j)
    lam = np.asarray(lam_j)
    _close(td.wavelength_rgb_weight(_t(lam)), jd.wavelength_rgb_weight(jnp.asarray(lam)))
    ior, abbe = rng.uniform(1.3, 2.0, N), rng.uniform(15.0, 60.0, N)
    scale = rng.uniform(0.0, 1.0, N)
    args = [a.astype(np.float32) for a in (ior, abbe, scale, lam)]
    _close(td.ior_at_wavelength(*(_t(a) for a in args)),
           jd.ior_at_wavelength(*(jnp.asarray(a) for a in args)))
    # the hero-wavelength weight averages to white
    w = td.wavelength_rgb_weight(td.sample_wavelength(torch.rand(200_000)))
    np.testing.assert_allclose(w.mean(0).numpy(), 1.0, atol=0.02)


def test_material_helpers_match_jax():
    from hiprt_pt_tpu.core import material as jmat
    from hiprt_pt_tpu_torch.core import material as tmat

    rng = _rng(8)
    r, a = rng.random((2, N), dtype=np.float32)
    for x, y in zip(tmat.get_alphas(_t(r), _t(a)),
                    jmat.get_alphas(jnp.asarray(r), jnp.asarray(a))):
        _close(x, y)
    thin = (rng.random(N) < 0.5).astype(np.float32)
    eta = rng.uniform(0.9, 2.0, N).astype(np.float32)
    _close(tmat.thin_walled_roughness(_t(thin), _t(r), _t(eta)),
           jmat.thin_walled_roughness(jnp.asarray(thin), jnp.asarray(r),
                                      jnp.asarray(eta)))


def test_import_time_fits_are_bit_identical():
    from hiprt_pt_tpu.models import principled as jp
    from hiprt_pt_tpu_torch.models import principled as tp_

    for name in ("_GLASS_POLY", "_CONDUCTOR_POLY", "_GGX_ESS", "_GLASS_ALL",
                 "_SHEEN_LTC_POLY"):
        assert np.array_equal(getattr(tp_, name), getattr(jp, name)), name
    assert tp_._GLASS_POLY_DEG == jp._GLASS_POLY_DEG
    assert tp_._CONDUCTOR_POLY_DEG == jp._CONDUCTOR_POLY_DEG


def test_lut_copies_are_byte_identical():
    import hiprt_pt_tpu
    import hiprt_pt_tpu_torch

    src = os.path.join(os.path.dirname(hiprt_pt_tpu.__file__), "bake")
    dst = os.path.join(os.path.dirname(hiprt_pt_tpu_torch.__file__), "bake")
    names = sorted(f for f in os.listdir(dst) if f.endswith(".npy"))
    assert len(names) == 7
    for name in names:
        with open(os.path.join(src, name), "rb") as a, \
                open(os.path.join(dst, name), "rb") as b:
            assert a.read() == b.read(), name


# --- principled eval/pdf and sample ------------------------------------------

@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_principled_eval_matches_jax(case, exact):
    from hiprt_pt_tpu.models import principled as jp
    from hiprt_pt_tpu_torch.models import principled as tp_

    jo, to = _options(exact=exact)
    jm, tm = _banks(case)
    n, wo, wi, eta = _frame(11)
    fj, pj = jp.eval_pdf(jo, jm, *(jnp.asarray(a) for a in (n, wo, wi)),
                         {"eta_rel": jnp.asarray(eta)})
    ft, pt = tp_.eval_pdf(to, tm, _t(n), _t(wo), _t(wi), {"eta_rel": _t(eta)})
    assert float(np.asarray(pj).max()) > 0.0
    _close(ft, fj)
    _close(pt, pj)
    # without aux the glass lobe enters with eta = ior
    fj, pj = jp.eval_pdf(jo, jm, *(jnp.asarray(a) for a in (n, wo, wi)))
    ft, pt = tp_.eval_pdf(to, tm, _t(n), _t(wo), _t(wi))
    _close(ft, fj)
    _close(pt, pj)


# sample()'s f and pdf at the direction it drew, against eval_pdf's at the
# same direction, inside the JAX package alone (seeded inputs of the test
# below, every case and GGX variant, relative error past ATOL): on rays that
# do not refract f and pdf differ by up to 9.3e-4 (thin film, VNDF; 2.1e-4
# on metal); on refracted rays by up to 3.9e-2 (thin-walled, VNDF; 1.3e-2 on
# glass), while their ratio f/pdf, the path weight, differs by at most
# 2.5e-5. The sampled direction is a chain of sqrt and normalizations whose
# last bits move f and pdf by that much, so the port's sample() is held to
# the JAX package's f and pdf at that conditioning: SAMPLE_RTOL without
# refraction, REFRACT_RTOL on refracted rays (the port's largest errors on
# these rays: 3.5e-4 and 1.5e-2).
SAMPLE_RTOL = 1e-3
REFRACT_RTOL = 5e-2


@pytest.mark.parametrize("ggx,exact", [("VNDF_SPHERICAL_CAPS", False),
                                       ("VNDF", False),
                                       ("VNDF_SPHERICAL_CAPS", True)])
@pytest.mark.parametrize("case", CASES)
def test_principled_sample_matches_jax(case, ggx, exact):
    """Every ray is guarded three ways. (1) The lobe choice and the refracted
    flag are equal, and the directions agree within atol 1e-4 on >= 99.9%
    of rays (a direction within rounding of a refraction boundary may take
    the other branch). (2) Strict: the port's eval_pdf at the JAX package's
    sampled direction equals the JAX package's eval_pdf there, atol 1e-5 /
    rtol 1e-4, on every ray; this guards the port's formulas. (3) Where the
    directions agree, sample()'s f and pdf agree at SAMPLE_RTOL; on a
    refracted ray f and pdf both divide by (wo.h + eta wi.h)^2, which nearly
    cancels (on thin-walled glass, eta = 1.001, for every refracted ray), so
    there f and pdf are held at REFRACT_RTOL. Their ratio, the path weight
    f/pdf that the port's sample() returns, is held on every refracted ray
    it keeps (pdf > 0) to the JAX package's eval_pdf at the port's own direction, atol 1e-5 /
    rtol 1e-4: the port's largest error there is 2.0e-5. (Against the JAX
    package's sample() it is 1.5e-4, on one glass ray whose two sampled
    directions differ by 6.9e-5; the path weight follows the direction.)"""
    from hiprt_pt_tpu.core import rng as jrng
    from hiprt_pt_tpu.models import principled as jp
    from hiprt_pt_tpu_torch.core import rng as trng
    from hiprt_pt_tpu_torch.models import principled as tp_

    jo, to = _options(ggx, exact)
    jm, tm = _banks(case)
    n, wo, _wi, eta = _frame(12)
    js = jrng.seed(jnp.arange(N, dtype=jnp.uint32), 2, 17)
    ts_ = trng.seed(torch.arange(N), 2, 17)
    jaux, taux = {"eta_rel": jnp.asarray(eta)}, {"eta_rel": _t(eta)}
    rj, wij, fj, pj, auxj = jp.sample(jo, jm, jnp.asarray(n), jnp.asarray(wo), js,
                                      jaux)
    rt, wit, ft, pt, auxt = tp_.sample(to, tm, _t(n), _t(wo), ts_, taux)
    # four draws, in the JAX package's order
    assert np.array_equal(np.asarray(rj).astype(np.int64), rt.numpy())

    def ok(a, b, atol, rtol=RTOL):
        d = np.abs(a - b) <= atol + rtol * np.abs(b)
        return d.all(axis=-1) if d.ndim == 2 else d

    # (1) the lobe picked by u_sel (the first draw) from each package's lobe
    # probabilities, and the refracted flag
    u_sel = np.asarray(jrng.next_float(js)[1])
    probs_j, _ = jp._lobe_setup(jo, jm, jp._to_local(jnp.asarray(n), jnp.asarray(wo)))
    probs_t, _ = tp_._lobe_setup(to, tm, tp_._to_local(_t(n), _t(wo)))
    lobe_j = (u_sel[:, None] >= np.cumsum(np.stack(
        [np.asarray(p) for p in probs_j], -1), -1)).sum(-1)
    lobe_t = (u_sel[:, None] >= np.cumsum(np.stack(
        [p.numpy() for p in probs_t], -1), -1)).sum(-1)
    assert np.array_equal(lobe_t, lobe_j), case
    refracted = np.asarray(auxj["refracted"])
    assert np.array_equal(auxt["refracted"].numpy(), refracted), case
    wij, fj, pj = np.asarray(wij), np.asarray(fj), np.asarray(pj)
    wit, ft, pt = wit.numpy(), ft.numpy(), pt.numpy()
    same_dir = ok(wit, wij, 1e-4)
    assert same_dir.mean() >= 0.999, (case, same_dir.mean())

    # (2) eval_pdf at the JAX package's direction, every ray
    fej, pej = jp.eval_pdf(jo, jm, jnp.asarray(n), jnp.asarray(wo),
                           jnp.asarray(wij), jaux)
    fet, pet = tp_.eval_pdf(to, tm, _t(n), _t(wo), _t(wij), taux)
    _close(fet, fej)
    _close(pet, pej)

    # (3) sample()'s f and pdf where the directions agree
    f_ok = np.where(refracted,
                    ok(ft, fj, ATOL, REFRACT_RTOL) & ok(pt, pj, ATOL, REFRACT_RTOL),
                    ok(ft, fj, ATOL, SAMPLE_RTOL) & ok(pt, pj, ATOL, SAMPLE_RTOL))
    bad = np.nonzero(same_dir & ~f_ok)[0]
    assert bad.size == 0, (case, bad[:5], ft[bad[:5]], fj[bad[:5]])
    # the path weight of every refracted ray that the port's sample() kept
    # (pdf > 0), at the port's own direction
    fw, pw = (np.asarray(x) for x in jp.eval_pdf(
        jo, jm, jnp.asarray(n), jnp.asarray(wo), jnp.asarray(wit), jaux))
    weight_t = ft[:, 0] / np.maximum(pt, 1e-30)
    weight_j = fw[:, 0] / np.maximum(pw, 1e-30)
    bad = np.nonzero(refracted & (pt > 0) & ~ok(weight_t, weight_j, ATOL))[0]
    assert bad.size == 0, (case, bad[:5], weight_t[bad[:5]], weight_j[bad[:5]])
    assert (pj > 0).mean() > 0.5


def test_dispatcher_routes_to_the_principled_bsdf():
    from hiprt_pt_tpu.core import rng as jrng
    from hiprt_pt_tpu.models.dispatcher import bsdf_eval as jeval, bsdf_sample as jsample
    from hiprt_pt_tpu_torch.core import rng as trng
    from hiprt_pt_tpu_torch.models.dispatcher import bsdf_eval as teval, bsdf_sample as tsample

    jo, to = _options()
    jm, tm = _banks("mixed")
    n, wo, wi, eta = _frame(13)
    fj, pj = jeval(jo, jm, *(jnp.asarray(a) for a in (n, wo, wi)),
                   {"eta_rel": jnp.asarray(eta)})
    ft, pt = teval(to, tm, _t(n), _t(wo), _t(wi), {"eta_rel": _t(eta)})
    _close(ft, fj)
    _close(pt, pj)
    rj, *_ = jsample(jo, jm, jnp.asarray(n), jnp.asarray(wo),
                     jrng.seed(jnp.arange(N, dtype=jnp.uint32), 0, 3))
    rt, *_ = tsample(to, tm, _t(n), _t(wo), trng.seed(torch.arange(N), 0, 3))
    assert np.array_equal(np.asarray(rj).astype(np.int64), rt.numpy())


# --- white furnace, on the port (tests/test_principled.py's bounds) ----------

FN = 60000


def _furnace(mats_row, theta_deg, seed=0, **opts):
    """MC directional albedo of one material by BSDF sampling (port)."""
    from hiprt_pt_tpu_torch.core import rng as trng
    from hiprt_pt_tpu_torch.core.material import MaterialBank
    from hiprt_pt_tpu_torch.core.settings import RenderOptions
    from hiprt_pt_tpu_torch.models import principled

    mats = MaterialBank.from_rows([mats_row]).at_indices(
        torch.zeros(FN, dtype=torch.int64)).make_safe()
    t = np.deg2rad(theta_deg)
    wo = torch.tensor([np.sin(t), 0.0, np.cos(t)], dtype=torch.float32).expand(FN, 3)
    nrm = torch.tensor([0.0, 0.0, 1.0]).expand(FN, 3)
    s = trng.seed(torch.arange(FN), 0, seed)
    _, wi, f, pdf, _ = principled.sample(RenderOptions(**opts), mats, nrm, wo, s)
    est = torch.where((pdf > 1e-8)[..., None],
                      f * (wi[..., 2].abs() / pdf.clamp_min(1e-9))[..., None], 0.0)
    return est.mean(0).numpy()


@pytest.mark.parametrize("theta", [10, 45, 70])
def test_furnace_diffuse(theta):
    alb = _furnace(dict(base_color=[1, 1, 1], roughness=0.5, specular=0.0), theta)
    assert np.all(alb < 1.05) and np.all(alb > 0.80), alb


@pytest.mark.parametrize("rough", [0.1, 0.4, 0.9])
def test_furnace_metal(rough):
    alb = _furnace(dict(base_color=[1, 1, 1], metallic=1.0, roughness=rough), 30)
    assert np.all(alb <= 1.05) and np.all(alb > 0.4), (rough, alb)


@pytest.mark.parametrize("rough", [0.05, 0.3, 0.7])
def test_furnace_glass(rough):
    """A single entering interface returns about F + (1-F)/eta^2 (radiance
    compression into the denser medium)."""
    from hiprt_pt_tpu_torch.models.fresnel import fresnel_dielectric

    eta = 1.5
    alb = _furnace(dict(base_color=[1, 1, 1], specular_transmission=1.0,
                        roughness=rough, ior=eta, specular=0.0), 25, seed=5)
    F = float(fresnel_dielectric(torch.tensor(np.cos(np.deg2rad(25.0)),
                                              dtype=torch.float32),
                                 torch.tensor(eta)))
    expected = F + (1.0 - F) / eta ** 2
    assert np.all(np.abs(alb - expected) < 0.12), (rough, alb, expected)


@pytest.mark.parametrize("exact", [False, True])
def test_furnace_glossy_base(exact):
    row = dict(base_color=[1, 1, 1], roughness=0.9, specular=1.0, ior=1.5)
    on = float(_furnace(row, 40, 77, glass_compensation_exact=exact).mean())
    off = float(_furnace(row, 40, 77, do_energy_compensation=False).mean())
    assert on > off + 0.01 and 0.90 < on < 1.10, (on, off)


def test_furnace_coat():
    row = dict(base_color=[1, 1, 1], roughness=0.4, specular=0.0, coat=1.0,
               coat_roughness=0.7, coat_ior=1.5)
    on = float(_furnace(row, 35, 77).mean())
    off = float(_furnace(row, 35, 77, do_energy_compensation=False).mean())
    assert on > off + 0.01 and on < 1.12, (on, off)
