"""The LUT baker (hiprt_pt_tpu_torch/bake/baker.py) and the sheen LTC fit
(bake/sheen_ltc_fit.py) against the JAX package on the CPU.

The bakes draw the same PCG numbers as the JAX package (every cell's lanes
are seeded with their sample index), so a table agrees cell by cell. The
sheen fit draws from a torch.Generator where the JAX package draws from
threefry keys: its deterministic pieces are held against JAX's on the same
inputs (JAX's own draws fed in), a fitted row statistically. Tolerances are
stated at each test; nothing is written into the package."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hiprt_pt_tpu.bake import baker as jb
from hiprt_pt_tpu.bake import sheen_ltc_fit as jf
from hiprt_pt_tpu_torch.bake import baker as tb
from hiprt_pt_tpu_torch.bake import sheen_ltc_fit as tf

BAKE_DIR = os.path.join(os.path.dirname(tb.__file__))
BAKES = ("bake_ggx_conductor_ess", "bake_ggx_glossy_dielectric_ess",
         "bake_glossy_base_ess", "bake_ggx_fresnel_ess", "bake_ggx_glass_ess",
         "bake_ggx_glass_inv_ess", "bake_ggx_thin_glass_ess")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as in test_torch_envmap.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# --- the baker ---

@pytest.fixture(scope="module", autouse=True)
def jax_tables():
    """{name: future of the JAX package's table at res 4, 256 samples a
    cell}: baked in threads from the module's first test on, so that XLA
    compiles the glass bakes' programs beside each other and beside the
    tests that come before test_bake_matches_jax."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(BAKES)) as pool:
        yield {name: pool.submit(getattr(jb, name), res=4, n_samples=256)
               for name in BAKES}


def test_conductor_ess_properties():
    """tests/test_baker.py's properties, on the port."""
    ess = tb.bake_ggx_conductor_ess(res=16, n_samples=4096, device="cpu")
    assert ess.shape == (16, 16)
    assert np.all(ess <= 1.01) and np.all(ess > 0.1)
    # smooth surfaces lose no energy; rough ones do
    assert ess[0].min() > 0.98
    assert ess[-1].min() < 0.8
    assert ess[-1, -1] < ess[0, -1] + 1e-3


def test_glossy_dielectric_below_conductor():
    c = tb.bake_ggx_conductor_ess(res=8, n_samples=4096, device="cpu")
    g = tb.bake_ggx_glossy_dielectric_ess(eta=1.5, res=8, n_samples=4096,
                                          device="cpu")
    assert np.all(g <= c + 1e-6)
    assert g[0, -1] < 0.1  # ~4% Fresnel at normal incidence


def test_fresh_conductor_bake_matches_the_shipped_table():
    """At the shipped table's resolution, 2,048 samples a cell: within 0.02,
    the tolerance of tests/test_baker.py."""
    saved = np.load(os.path.join(BAKE_DIR, "data_ggx_conductor_ess_32.npy"))
    fresh = tb.bake_ggx_conductor_ess(res=32, n_samples=2048, device="cpu")
    assert np.abs(saved - fresh).max() <= 0.02


def test_bake_all_writes_the_jax_packages_files(tmp_path, monkeypatch):
    """bake_all into a chosen directory: the same files as the JAX
    package's, each table through save_lut (.npy exact, .hdr) or np.save;
    the bakes themselves are stubbed with seeded tables."""
    from hiprt_pt_tpu_torch.assets.image_io import read_hdr

    g = np.random.default_rng(0)
    tables = {}

    def stub(name, shape):
        def fn(res=32, **kw):
            t = g.random(shape(res), dtype=np.float32)
            tables[name] = t
            return t
        return fn

    for mod in (tb, jb):
        for name in BAKES:
            monkeypatch.setattr(mod, name, stub(name, (
                (lambda r: (r, r)) if name in BAKES[:2]
                else (lambda r: (len(tb.GLASS_IORS), r, r)))))
    out = tb.bake_all(out_dir=str(tmp_path / "port"), res=8, device="cpu")
    os.makedirs(tmp_path / "jax")
    jb.bake_all(out_dir=str(tmp_path / "jax"), res=8)
    assert (sorted(os.listdir(tmp_path / "port"))
            == sorted(os.listdir(tmp_path / "jax")))
    assert set(out) == {"conductor", "glossy_dielectric", "glass", "glass_inv",
                        "thin_glass", "glossy_base", "fresnel"}
    ess = np.load(tmp_path / "port" / "GGX_Conductor_Ess_8x8.npy")
    np.testing.assert_array_equal(ess, out["conductor"])
    hdr = read_hdr(str(tmp_path / "port" / "GGX_Conductor_Ess_8x8.hdr"))
    # RGBE keeps 8 bits of mantissa
    np.testing.assert_allclose(hdr[..., 0], ess, rtol=1e-2, atol=1e-2)


def test_save_lut_writes_a_3d_table(tmp_path):
    """A 3D table's .hdr stacks its IOR slices (the JAX package's save_lut
    raises on one: write_hdr takes (H, W, 3))."""
    t = np.random.default_rng(1).random((8, 4, 4), dtype=np.float32)
    tb.save_lut(t, str(tmp_path / "glass"))
    np.testing.assert_array_equal(np.load(tmp_path / "glass.npy"), t)
    from hiprt_pt_tpu_torch.assets.image_io import read_hdr

    assert read_hdr(str(tmp_path / "glass.hdr")).shape == (32, 4, 3)


# --- the sheen fit: its pieces against the JAX package's ---

def _unit(n, seed, up=False):
    w = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    if up:
        w[:, 2] = np.abs(w[:, 2])
    return w


S_CASES = [(1.0, 1.0, float(np.float32(0.3) ** 2)),
           (1.0, 1.0, float(np.float32(0.703125) ** 2))]


@pytest.mark.parametrize("S", S_CASES, ids=["alpha0.3", "alpha0.70"])
def test_sggx_pieces_match_jax(S):
    """sggx_sigma, sggx_ndf, _onb on the same unit vectors: _onb exactly,
    the rest within rtol 1e-6 (an ulp or two of float32: the JAX package
    rounds S's products in float32, the port in Python floats)."""
    w = _unit(2048, 0)
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    for a, b in zip(tf._onb(tw), jf._onb(jw)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for fn in ("sggx_sigma", "sggx_ndf"):
        np.testing.assert_allclose(getattr(tf, fn)(tw, S).numpy(),
                                   np.asarray(getattr(jf, fn)(jw, S)),
                                   rtol=1e-6, err_msg=fn)


def test_ltc_logpdf_matches_jax():
    """On escaped directions and on the (0, 0, 1) of rows that did not
    escape, at several (Ai, Bi): within 1e-6 (log and the squares round
    apart by an ulp); finite everywhere."""
    w = np.concatenate([_unit(2048, 1, up=True),
                        np.tile([0.0, 0.0, 1.0], (4, 1)).astype(np.float32)])
    for ai, bi in ((1.0, 0.0), (0.7, -0.3), (2.5, 1.2)):
        ai, bi = np.float32(ai), np.float32(bi)
        got = tf.ltc_logpdf(torch.from_numpy(w), torch.tensor(ai),
                            torch.tensor(bi)).numpy()
        want = np.asarray(jf.ltc_logpdf(jnp.asarray(w), ai, bi))
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _jax_uniforms(key, n):
    """The uniforms JAX's sggx_sample_visible(key, ...) draws."""
    k1, k2 = jax.random.split(key)
    return (torch.tensor(np.asarray(jax.random.uniform(k1, (n,)))),
            torch.tensor(np.asarray(jax.random.uniform(k2, (n,)))))


@pytest.mark.parametrize("S", S_CASES, ids=["alpha0.3", "alpha0.70"])
def test_sggx_sample_visible_fed_jaxs_draws(S):
    """The visible normals JAX draws with a key, from the port fed that
    key's uniforms: within 2e-6 (cos, sin and sqrt round apart by an ulp);
    on the side of wi."""
    w = _unit(4096, 2)
    key = jax.random.PRNGKey(5)
    u1, u2 = _jax_uniforms(key, w.shape[0])
    got = tf.sggx_sample_visible(u1, u2, torch.from_numpy(w), S).numpy()
    want = np.asarray(jf.sggx_sample_visible(key, jnp.asarray(w), S))
    np.testing.assert_allclose(got, want, atol=2e-6)
    assert ((got * w).sum(-1) > -1e-6).all()


@pytest.mark.parametrize("flake", ["specular", "diffuse"])
def test_slab_bounces_fed_jaxs_draws(flake):
    """Three bounces of the slab walk on 4,096 paths, the port's
    slab_bounce fed the uniforms of JAX's slab_walk keys, against JAX's
    slab_walk(max_bounces=3): escape and life flags agree on >= 99.9% of the
    paths (a path whose free flight ends within an ulp of the slab's top
    may go either way), exit directions within 1e-5 where both escaped.
    JAX's diffuse flake draws its cosine lobe with the flake normal's own
    uniforms (the port's slab_walk draws new ones): fed here as JAX
    draws them."""
    n, mu, alpha = 4096, np.float32(0.4), 0.5
    S = (1.0, 1.0, alpha * alpha)
    key = jax.random.PRNGKey(7)
    esc_j, out_j, alive_j = jf.slab_walk(key, mu, alpha, n, max_bounces=3,
                                         thickness=alpha, flake=flake)
    sin_o = float(np.sqrt(np.float32(1.0) - mu * mu))
    w = torch.tensor([-sin_o, 0.0, -float(mu)]).expand(n, 3)
    z = torch.full((n,), alpha)
    alive = torch.ones(n, dtype=torch.bool)
    esc = torch.zeros(n, dtype=torch.bool)
    out = torch.tensor([0.0, 0.0, 1.0]).expand(n, 3)
    for k in jax.random.split(key, 3):
        k1, k2 = jax.random.split(k)
        u_t = torch.tensor(np.asarray(jax.random.uniform(k1, (n,))))
        u1, u2 = _jax_uniforms(k2, n)
        z, w, alive, esc, out = tf.slab_bounce(
            z, w, alive, esc, out, u_t, u1, u2, S, alpha, flake,
            *((u1, u2) if flake == "diffuse" else ()))
    esc_j, alive_j = np.asarray(esc_j), np.asarray(alive_j)
    assert (esc.numpy() == esc_j).mean() >= 0.999
    assert (alive.numpy() == alive_j).mean() >= 0.999
    both = esc.numpy() & esc_j
    assert both.sum() > n // 10
    np.testing.assert_allclose(out.numpy()[both], np.asarray(out_j)[both],
                               atol=1e-5)


def test_fit_cell_matches_jax():
    """The Adam fit on the same (esc, dirs): Ai, Bi and the loss within
    rtol 1e-5 of JAX's fit_cell (200 steps of the same update; the
    gradients round apart by ulps); a batch of two cells fits as each
    alone (rtol 1e-6)."""
    g = np.random.default_rng(3)
    dirs_pool = _unit(1000, 4, up=True)
    esc, dirs = [], []
    for share in (0.6, 0.2):
        e = (g.random(4096) < share).astype(np.float32)
        d = np.where(e[:, None] > 0, dirs_pool[g.integers(0, 1000, 4096)],
                     np.asarray([0.0, 0.0, 1.0], np.float32))
        esc.append(e)
        dirs.append(d.astype(np.float32))
    batch = tf.fit_cell(torch.from_numpy(np.stack(esc)),
                        torch.from_numpy(np.stack(dirs)))
    want = jf.fit_cell(jnp.asarray(esc[0]), jnp.asarray(dirs[0]))
    for c in range(2):
        one = tf.fit_cell(torch.from_numpy(esc[c]), torch.from_numpy(dirs[c]))
        for a, b, w in zip(one, (x[c] for x in batch), want):
            assert np.isfinite(float(a))
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
            if c == 0:
                np.testing.assert_allclose(float(a), float(w), rtol=1e-5)


def test_fit_poly_of_the_shipped_table_is_the_shipped_poly(capsys):
    """fit_poly (numpy, a copy of the JAX package's) gives back the shipped
    polynomial bit for bit, as the JAX package's fit_poly does."""
    table = np.load(os.path.join(BAKE_DIR, "data_sheen_ltc.npy"))
    poly = np.load(os.path.join(BAKE_DIR, "data_sheen_ltc_poly.npy"))
    got = tf.fit_poly(table)
    np.testing.assert_array_equal(got, poly)
    np.testing.assert_array_equal(got, jf.fit_poly(table))
    np.testing.assert_array_equal(tf.sanitize_table(table),
                                  jf.sanitize_table(table))
    assert "sheen poly ch2" in capsys.readouterr().out


def test_alpha_row_agrees_with_jax_within_monte_carlo_error():
    """One alpha row (alpha = 0.703, a row where the lobe is bright) at
    4,096 paths a cell: R (the escaped share) of each of the 32 cells
    within 4.5 sigma of JAX's, sigma the standard deviation of the
    difference of two independent binomial shares; no path outlives the
    walk; Ai > 0 and every value finite."""
    n, alpha, aj = 4096, 0.703125, 22
    want = jf.fit_alpha_row(jax.random.PRNGKey(1234 + aj), jnp.float32(alpha),
                            n, thickness=jnp.float32(alpha))
    gen = torch.Generator("cpu").manual_seed(1234 + aj)
    got = tf.fit_alpha_row(gen, alpha, n, thickness=alpha)
    Ai, Bi, R, alive, loss = (x.numpy() for x in got)
    r_j = np.asarray(want[2])
    sigma = np.sqrt(2.0 * r_j * (1.0 - r_j) / n)
    assert (np.abs(R - r_j) <= 4.5 * sigma + 1.0 / n).all(), np.abs(R - r_j) / sigma
    assert float(alive.max()) == 0.0 and float(np.asarray(want[3]).max()) == 0.0
    assert (Ai > 0).all() and np.isfinite(np.stack([Ai, Bi, loss])).all()


def test_selftest_and_main_on_the_cpu(tmp_path, capsys):
    """The SGGX self-test passes JAX's gate (every |e| < 0.02) on the CPU;
    main writes the table where --out says."""
    assert tf.main(["--selftest", "--cpu"]) == 0  # raises past the gate
    assert "self-test OK" in capsys.readouterr().out
    out = tmp_path / "sheen.npy"
    assert tf.main(["--cpu", "--paths=8", "--steps=2", f"--out={out}"]) == 0
    table = np.load(out)
    assert table.shape == (32, 32, 3) and np.isfinite(table).all()
    assert (table[..., 2] >= 0).all() and (table[..., 2] <= 1).all()
    assert tf.OUT_PATH.startswith(BAKE_DIR) and tf.POLY_PATH.startswith(BAKE_DIR)


# --- last: the JAX tables are baked in the background meanwhile ---

@pytest.mark.parametrize("name", BAKES)
def test_bake_matches_jax(jax_tables, name):
    """Res 4, 256 samples a cell: every cell within 1e-6 of the JAX
    package's, but at most 1 in 50 of a table's cells, each within 6e-3:
    one lane of 256 (a glass lobe's estimate is about 1.4). XLA's fused,
    jitted glass bake rounds a lane of the smooth lobe to the other side of
    a branch (2 of the 128 cells of glass_inv); with jit off, JAX agrees
    with the port within 3e-7 on every cell."""
    got = getattr(tb, name)(res=4, n_samples=256, device="cpu")
    want = jax_tables[name].result()
    assert got.shape == want.shape and got.dtype == np.float32
    diff = np.abs(got - want)
    assert diff.max() <= 6e-3, diff.max()
    assert (diff > 1e-6).sum() <= diff.size // 50, np.sort(diff.ravel())[-4:]
