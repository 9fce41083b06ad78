"""The port's ReSTIR DI reservoirs (hiprt_pt_tpu_torch/restir/reservoir.py)
against the JAX package's, method by method, on reservoirs and candidates
made with numpy from a seed (4,096 pixels; weights with negative, NaN and
infinite entries; masks; M around the m-cap), and the interop round trip of
a reservoir and of a render state that carries one.

Tolerances: the WRS choices, M, the RNG states and every field a method
selects are exact; sums and the UCW quotient within atol 1e-6 / rtol 1e-6
(one f32 add or divide each side)."""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_parity as tp  # noqa: E402

from hiprt_pt_tpu_torch import interop  # noqa: E402
from hiprt_pt_tpu_torch.restir.reservoir import Reservoir  # noqa: E402

N = 4096
FIELDS = ("weight_sum", "M", "W", "light_point", "light_normal", "radiance",
          "target", "is_envmap")
SUMS = ("weight_sum", "W")


def _jres(d):
    from hiprt_pt_tpu.restir.reservoir import Reservoir as JReservoir

    return JReservoir(**{k: jnp.asarray(v) for k, v in d.items()})


def _tres(d):
    return Reservoir(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})


def _res_np(rng, n=N, bad=False):
    """A reservoir of n pixels; ``bad``: some NaN, negative and infinite
    sums and weights."""
    d = dict(
        weight_sum=rng.exponential(2.0, n).astype(np.float32),
        M=rng.integers(0, 31, n).astype(np.float32),
        W=rng.exponential(1.0, n).astype(np.float32),
        light_point=rng.normal(size=(n, 3)).astype(np.float32),
        light_normal=rng.normal(size=(n, 3)).astype(np.float32),
        radiance=rng.uniform(0, 10, (n, 3)).astype(np.float32),
        target=rng.exponential(1.0, n).astype(np.float32),
        is_envmap=rng.random(n) < 0.2,
    )
    d["target"][rng.random(n) < 0.1] = 0.0
    if bad:
        for k in ("weight_sum", "W"):
            d[k][rng.random(n) < 0.05] = np.nan
            d[k][rng.random(n) < 0.05] = -1.0
        d["radiance"][rng.random(n) < 0.05, 1] = np.inf
    return d


def _weights(rng, n=N):
    w = rng.exponential(1.0, n).astype(np.float32)
    w[rng.random(n) < 0.1] = 0.0
    w[rng.random(n) < 0.05] = -0.5
    w[rng.random(n) < 0.03] = np.nan
    w[rng.random(n) < 0.03] = np.inf
    return w


def _rngs(n=N, sample=5):
    from hiprt_pt_tpu.core import rng as jrng
    from hiprt_pt_tpu_torch.core import rng as trng

    return (jrng.seed(jnp.arange(n, dtype=jnp.uint32), sample, 42),
            trng.seed(torch.arange(n), sample, 42))


def _same(got: Reservoir, ref, sums_tol=False):
    for k in FIELDS:
        g, r = getattr(got, k).numpy(), np.asarray(getattr(ref, k))
        assert g.shape == r.shape, k
        if sums_tol and k in SUMS:
            np.testing.assert_allclose(g, r, atol=1e-6, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(g, r, err_msg=k)


def _same_rng(t, j):
    assert np.array_equal(np.asarray(j).astype(np.int64), t.numpy())


def test_empty_matches_jax():
    from hiprt_pt_tpu.restir.reservoir import Reservoir as JReservoir

    _same(Reservoir.empty(17, "cpu"), JReservoir.empty(17))
    assert Reservoir.N_COLS == JReservoir.N_COLS == 14


@pytest.mark.parametrize("tracked", [False, True])
def test_update_matches_jax(tracked):
    rng = np.random.default_rng(1)
    base = _res_np(rng)
    lp, ln, rad = (rng.normal(size=(N, 3)).astype(np.float32) for _ in range(3))
    target = rng.exponential(1.0, N).astype(np.float32)
    is_env, valid = rng.random(N) < 0.3, rng.random(N) < 0.8
    w = _weights(rng)
    jr, tr = _rngs()
    args = (w, lp, ln, rad, target, is_env, valid)
    jres, tres = _jres(base), _tres(base)
    # three candidates in a row: the winners depend on every draw before
    for step in range(3):
        a = [np.roll(x, step, axis=0) for x in args]
        if tracked:
            jres, jr, jtake = jres.update_tracked(jr, *map(jnp.asarray, a))
            tres, tr, ttake = tres.update_tracked(
                tr, *(torch.from_numpy(np.array(x)) for x in a))
            assert np.array_equal(np.asarray(jtake), ttake.numpy())
        else:
            jres, jr = jres.update(jr, *map(jnp.asarray, a))
            tres, tr = tres.update(tr, *(torch.from_numpy(np.array(x)) for x in a))
        _same_rng(tr, jr)
    _same(tres, jres, sums_tol=True)
    assert 0.05 < float((tres.target != torch.from_numpy(base["target"])).float().mean())


@pytest.mark.parametrize("tracked", [False, True])
def test_combine_matches_jax(tracked):
    rng = np.random.default_rng(2)
    base, other = _res_np(rng), _res_np(rng, bad=True)
    target_here = rng.exponential(1.0, N).astype(np.float32)
    m_weight = _weights(rng)
    valid = rng.random(N) < 0.8
    jr, tr = _rngs()
    if tracked:
        jres, jr, jtake = _jres(base).combine_tracked(
            jr, _jres(other), jnp.asarray(target_here), jnp.asarray(m_weight),
            jnp.asarray(valid))
        tres, tr, ttake = _tres(base).combine_tracked(
            tr, _tres(other), torch.from_numpy(target_here),
            torch.from_numpy(m_weight), torch.from_numpy(valid))
        assert np.array_equal(np.asarray(jtake), ttake.numpy())
        assert 0.05 < float(ttake.float().mean()) < 0.95
    else:
        jres, jr = _jres(base).combine(
            jr, _jres(other), jnp.asarray(target_here), jnp.asarray(m_weight),
            jnp.asarray(valid))
        tres, tr = _tres(base).combine(
            tr, _tres(other), torch.from_numpy(target_here),
            torch.from_numpy(m_weight), torch.from_numpy(valid))
    _same_rng(tr, jr)
    _same(tres, jres, sums_tol=True)


@pytest.mark.parametrize("normalization", ["M", "given"])
def test_finalize_matches_jax(normalization):
    rng = np.random.default_rng(3)
    base = _res_np(rng)
    base["weight_sum"][rng.random(N) < 0.05] = np.inf
    if normalization == "M":
        jres, tres = _jres(base).finalize(), _tres(base).finalize()
    else:
        norm = rng.uniform(0.0, 3.0, N).astype(np.float32)
        norm[rng.random(N) < 0.1] = 0.0
        jres = _jres(base).finalize(normalization=jnp.asarray(norm))
        tres = _tres(base).finalize(normalization=torch.from_numpy(norm))
    _same(tres, jres, sums_tol=True)
    assert float((tres.W == 0).float().mean()) > 0.05


@pytest.mark.parametrize("m_cap", [0, 25])
def test_m_capped_matches_jax(m_cap):
    base = _res_np(np.random.default_rng(4))
    _same(_tres(base).m_capped(m_cap), _jres(base).m_capped(jnp.int32(m_cap)))


def test_gather_pack_and_sanity_match_jax():
    from hiprt_pt_tpu.restir.reservoir import Reservoir as JReservoir

    rng = np.random.default_rng(5)
    base = _res_np(rng, bad=True)
    idx = rng.integers(0, N, 1000)
    jres, tres = _jres(base), _tres(base)
    _same(tres.gather(torch.from_numpy(idx)), jres.gather(jnp.asarray(idx)))
    jcols, tcols = jres.pack_columns(), tres.pack_columns()
    assert tcols.shape == (N, Reservoir.N_COLS)
    np.testing.assert_array_equal(tcols.numpy(), np.asarray(jcols))
    _same(Reservoir.from_columns(tcols), JReservoir.from_columns(jcols))
    _same(Reservoir.from_columns(tcols), jres)
    ok = tres.sanity_mask().numpy()
    assert np.array_equal(ok, np.asarray(jres.sanity_mask()))
    assert 0.5 < ok.mean() < 1.0


def test_reservoir_interop_round_trip():
    """A JAX reservoir carried into the port as numpy and back is the same
    array for array; the port's to_numpy gives the fields the JAX
    package's constructor takes."""
    base = _res_np(np.random.default_rng(6), bad=True)
    jres = _jres(base)
    tres = interop.reservoir_from_numpy(tp.to_numpy_dict(jres), "cpu")
    _same(tres, jres)
    back = _jres(interop.to_numpy(tres))
    _same(tres, back)
    assert tres.is_envmap.dtype == torch.bool


def test_state_interop_carries_restir():
    """A JAX render state with reservoirs comes across with them; one
    without stays without; the port's init_render_state(with_restir=True)
    matches the JAX package's, field by field."""
    from hiprt_pt_tpu.core.state import init_render_state as jinit
    from hiprt_pt_tpu_torch.core.state import init_render_state

    jstate = jinit(32, 16, 7, with_restir=True)
    base = _res_np(np.random.default_rng(7), n=512)
    jstate = jstate.replace(restir=_jres(base))
    state = interop.state_from_numpy(tp.to_numpy_dict(jstate), "cpu")
    _same(state.restir, jstate.restir)
    assert state.seed == 7 and state.num_pixels == 512
    plain = interop.state_from_numpy(tp.to_numpy_dict(jinit(32, 16, 7)), "cpu")
    assert plain.restir is None
    fresh = init_render_state(32, 16, 7, device="cpu", with_restir=True)
    _same(fresh.restir, jinit(32, 16, 7, with_restir=True).restir)
    assert init_render_state(32, 16, device="cpu").restir is None
    assert dataclasses.is_dataclass(fresh.restir)
