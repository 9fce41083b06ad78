"""The port's round-5 gather probes (hiprt_pt_tpu_torch/probes/r5probe2.py)
against the TPU probe's Pallas kernels, _mm_kernel (P1) and _dg_kernel
(P2) of benchmarks/r5probe2.py, run in interpret mode on the same seeded
inputs. benchmarks/ is not a package, so the TPU probe is loaded by path."""

import importlib.util
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hiprt_pt_tpu_torch.probes import r5probe2 as probes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the CPU sizes: P1 (L, W, NL, rounds), P2 (S, rounds)
MM_L, MM_W, MM_NL, MM_ROUNDS = 67, 40, 128, 4
DG_S, DG_ROUNDS = 64, 4


@pytest.fixture(scope="module")
def tpu_probe():
    spec = importlib.util.spec_from_file_location(
        "r5probe2_tpu", os.path.join(REPO, "benchmarks", "r5probe2.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpret(kernel, *args, **kw) -> float:
    """A TPU probe kernel through pallas_call in interpret mode, with the
    probe's own specs (r5probe2.py:90-99, :135-143)."""
    out = pl.pallas_call(
        partial(kernel, **kw),
        grid=(),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        interpret=True,
    )(*args)
    return float(out[0, 0])


def _jnp_table(tab: torch.Tensor):
    if tab.dtype == torch.int8:
        return jnp.asarray(tab.numpy())
    return jnp.asarray(tab.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("groups", [1, 2, 8])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16],
                         ids=["int8", "bf16"])
def test_mm_plain_matches_tpu_kernel(tpu_probe, dtype, groups):
    """P1's plain version equals interpret-mode _mm_kernel exactly (every
    term is an integer, every sum below 2^24) on inputs whose answer is not
    constant."""
    tab, idx = probes.mm_gate_inputs(MM_L, MM_W, MM_NL, dtype, seed=3,
                                     device="cpu")
    want = _interpret(tpu_probe._mm_kernel, _jnp_table(tab),
                      jnp.asarray(idx.numpy()), rounds=MM_ROUNDS, L=MM_L,
                      W=MM_W, NL=MM_NL, groups=groups)
    got = probes.mm_probe_plain(tab, idx, MM_ROUNDS, groups)
    assert got.shape == (1, 1)
    assert float(got) == want
    # the wrapper on CPU tensors is the plain version and launches nothing
    before = dict(probes.launch_counts)
    assert float(probes.mm_probe_kernel(probes.mm_table(tab), idx, MM_ROUNDS,
                                        groups)) == want
    assert probes.launch_counts == before


@pytest.mark.parametrize("table", ["integer", "float"])
@pytest.mark.parametrize("per_lane", [False, True], ids=["broadcast", "per-lane"])
@pytest.mark.parametrize("tiles", [1, 2])
def test_dg_plain_matches_tpu_kernel(tpu_probe, tiles, per_lane, table):
    """P2's plain version against interpret-mode _dg_kernel: exactly on an
    integer table; within rtol 1e-5 on a float table, whose f32 sum the
    TPU kernel takes in another order than the plain float64 sum."""
    tab, idx = probes.dg_gate_inputs(DG_S, tiles, seed=5, device="cpu",
                                     per_lane=per_lane,
                                     integer=table == "integer")
    want = _interpret(tpu_probe._dg_kernel, jnp.asarray(tab.numpy()),
                      jnp.asarray(idx.numpy()), rounds=DG_ROUNDS, S=DG_S,
                      tiles=tiles)
    got = float(probes.dg_probe_plain(tab, idx, DG_ROUNDS))
    if table == "integer":
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.0)
    assert float(probes.dg_probe_kernel(tab, idx, DG_ROUNDS)) == got


@pytest.mark.parametrize("table", ["integer", "float"])
@pytest.mark.parametrize("S,rounds", [(37, 80), (50, 7), (64, 130)])
def test_dg_plain_wraps_like_the_tpu_kernel(tpu_probe, S, rounds, table):
    """P2's plain version against interpret-mode _dg_kernel where the row
    index wraps: indices drawn from [-3 S, 3 S) (floor-mod, so negative ones
    wrap upward), rounds past S and past 2 S (idx + r wraps more than once),
    and table heights that no slice or lane-group count of the CUDA kernels
    divides (37 is prime, 50 = 2 x 5 x 5). Exact on an integer table (one
    tile, so that every sum stays below 2^24: 130 x 128 x 1000), rtol 1e-5
    on a float table."""
    tab, _ = probes.dg_gate_inputs(S, 1, seed=8, device="cpu",
                                   integer=table == "integer")
    idx = torch.from_numpy(np.random.default_rng(9).integers(
        -3 * S, 3 * S, (S, probes.DG_LANES)).astype(np.int32))
    assert (idx < 0).any() and (idx >= S).any()
    want = _interpret(tpu_probe._dg_kernel, jnp.asarray(tab.numpy()),
                      jnp.asarray(idx.numpy()), rounds=rounds, S=S, tiles=1)
    got = float(probes.dg_probe_plain(tab, idx, rounds))
    if table == "integer":
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.0)
    # wrapped by hand: the same sum with every index brought into [0, S)
    assert float(probes.dg_probe_plain(tab, torch.remainder(idx, S), rounds)) == got


@pytest.mark.parametrize("S,tiles,plan", [
    (4096, 4, (4, 1024)), (4096, 19, (4, 512)), (4096, 1, (4, 1024)),
    (14400, 19, (4, 1024)), (14401, 19, (2, 1024)), (20000, 3, (2, 1024)),
    (28800, 2, (2, 1024)), (28801, 2, (0, 0)), (30000, 2, (0, 0)),
    (64, 2, (4, 1024)), (1000, 19, (4, 512))])
def test_dg_plan(S, tiles, plan):
    """The launch P2's wrapper plans on a 132-SM card: strips of 4 lanes
    while S x 4 floats fit a block's shared memory, of 2 lanes up to twice
    that height, the L2 kernel (g = 0) beyond; blocks of 1,024 threads where
    an SM gets or holds one strip, of 512 where it holds two."""
    g, threads = probes.dg_plan(S, tiles)
    assert (g, threads) == plan
    if g:
        assert g in probes.DG_STRIPS and probes.DG_LANES % g == 0
        assert S * g * 4 <= probes.DG_SMEM_BLOCK
        assert threads % (32 * g) == 0 and threads <= probes.DG_MAX_THREADS
    # a card with more SMs than strips gives every strip a whole SM
    assert probes.dg_plan(S, tiles, sms=10 ** 6)[1] in (0, 1024)


def test_dg_probe_kernel_on_the_cpu_ignores_the_plan():
    tab, idx = probes.dg_gate_inputs(DG_S, 2, seed=5, device="cpu")
    want = float(probes.dg_probe_plain(tab, idx, DG_ROUNDS))
    before = dict(probes.launch_counts)
    for plan in (None, (0, 0), (2, 64)):
        assert float(probes.dg_probe_kernel(tab, idx, DG_ROUNDS, plan)) == want
    assert probes.launch_counts == before


@pytest.mark.parametrize("probe", ["mm-int8", "mm-bf16", "dg"])
def test_probe_inputs_match_the_tpu_probe(probe):
    """mm_inputs / dg_inputs build the TPU probe's own inputs bit for bit
    (the jnp expressions of r5probe2.py:82-86 and :128-131, first variant)."""
    if probe == "dg":
        S, tiles = 4096, 4
        tab, idx = probes.dg_inputs(S, tiles, device="cpu")
        jtab = jnp.ones((S, tiles * 128), jnp.float32)
        jidx = jnp.broadcast_to(
            ((jnp.arange(S) * 9973) % S).astype(jnp.int32)[:, None], (S, 128))
    else:
        L, W, NL = probes.L_STRESS, probes.W16, 4096
        dtype, jdt = ((torch.int8, jnp.int8) if probe == "mm-int8"
                      else (torch.bfloat16, jnp.bfloat16))
        tab, idx = probes.mm_inputs(L, W, NL, dtype, device="cpu")
        jtab = (jnp.arange(L * W, dtype=jnp.int32) % 255 - 127).astype(
            jdt if jdt == jnp.int8 else jnp.float32).astype(jdt).reshape(L, W)
        jidx = jnp.arange(8 * NL, dtype=jnp.int32).reshape(8, NL) * 9973 % L
        if dtype == torch.bfloat16:
            tab = tab.view(torch.int16)
            jtab = jax.lax.bitcast_convert_type(jtab, jnp.int16)
    assert idx.dtype == torch.int32 and idx.is_contiguous()
    np.testing.assert_array_equal(tab.numpy(), np.asarray(jtab))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("config", [c[0] for c in probes.MM_CONFIGS]
                         + [f"dg-{t}" for _s, t in probes.DG_CONFIGS])
def test_probe_inputs_give_a_constant(config):
    """The TPU probe's own inputs cannot check a kernel: every row of its P1
    table holds 127 (W >= 255 consecutive values of a period-255 ramp), and
    its P2 table is all ones, so the answer is 127 * NL * rounds or
    tiles * 128 * rounds whatever rows are gathered. The gate inputs' answer
    changes when the gather does."""
    rounds = 2
    if config.startswith("dg-"):
        S, tiles = probes.DG_CONFIGS[0][0], int(config[3:])
        tab, idx = probes.dg_inputs(S, tiles, device="cpu")
        const = tiles * 128 * rounds
        run = partial(probes.dg_probe_plain, rounds=rounds)
        gate_tab, gate_idx = probes.dg_gate_inputs(S, tiles, seed=1, device="cpu")
    else:
        _label, L, W, NL, dtype, groups = next(
            c for c in probes.MM_CONFIGS if c[0] == config)
        tab, idx = probes.mm_inputs(L, W, NL, dtype, device="cpu")
        const = 127 * NL * rounds
        run = partial(probes.mm_probe_plain, rounds=rounds, groups=groups)
        gate_tab, gate_idx = probes.mm_gate_inputs(L, W, NL, dtype, seed=1,
                                                   device="cpu")
    assert float(run(tab, idx)) == const
    # a gather that fetched other rows gives the same answer ...
    assert float(run(tab, (idx * 7 + 1) % tab.shape[0])) == const
    # ... but not on the gate inputs
    assert float(run(gate_tab, gate_idx)) != float(
        run(gate_tab, (gate_idx * 7 + 1) % gate_tab.shape[0]))


def test_mm_table_is_the_padded_transpose():
    tab, _ = probes.mm_gate_inputs(MM_L, MM_W, MM_NL, torch.int8, seed=2,
                                   device="cpu")
    t = probes.mm_table(tab).tab_t
    assert t.shape == (48, 96) and t.dtype == torch.int8 and t.is_contiguous()
    assert torch.equal(t[:MM_W, :MM_L], tab.t())
    assert not t[MM_W:].any() and not t[:, MM_L:].any()


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16],
                         ids=["int8", "bf16"])
@pytest.mark.parametrize("L,W", [(300, 100), (129, 65), (2731, 333), (32, 16),
                                 (33, 17)])
def test_mm_table_off_the_tile(L, W, dtype):
    """The operand of P1's kernel for L and W off its tiles (128 table rows,
    128 bytes of L a stage) and off the padding: exactly tab.t() in its
    corner, zero elsewhere, contiguous, padded to the next multiple of 16
    rows and 32 columns and no further, every row a multiple of the 16
    bytes that a TMA tensor map's stride must be. Exact."""
    tab, _ = probes.mm_gate_inputs(L, W, 8, dtype, seed=9, device="cpu")
    table = probes.mm_table(tab)
    t = table.tab_t
    assert table.tab is tab and t.dtype == dtype and t.is_contiguous()
    assert t.shape == (-(-W // 16) * 16, -(-L // 32) * 32)
    assert t.shape[0] - W < 16 and t.shape[1] - L < 32
    assert (t.stride(0) * t.element_size()) % 16 == 0
    assert torch.equal(t[:W, :L], tab.t())
    assert not t[W:].any() and not t[:, L:].any()


def test_mm_table_refuses_what_the_kernel_does_not_take():
    tab, _ = probes.mm_gate_inputs(40, 24, 8, torch.int8, seed=9, device="cpu")
    with pytest.raises(TypeError):
        probes.mm_table(tab.float())
    with pytest.raises(ValueError, match="2-D"):
        probes.mm_table(tab[0])
    with pytest.raises(ValueError, match="contiguous"):
        probes.mm_table(tab.t())


def test_main_runs_on_the_cpu():
    """The entry point at tiny shapes on the host: the plain versions, no
    times; each line's value is the plain version's on the probe's inputs."""
    res = probes.main(device="cpu", shapes="tiny")
    assert [r["probe"] for r in res] == ["P1"] * 5 + ["P2"] * 2 + ["Q3"] * 3
    assert all(r["ms"] is None for r in res)
    rounds = probes.TINY["rounds"]
    for r, (_label, L, W, NL, dtype, groups) in zip(res, probes.TINY["mm"]):
        tab, idx = probes.mm_inputs(L, W, NL, dtype, device="cpu")
        assert r["value"] == float(probes.mm_probe_plain(tab, idx, rounds, groups))
    for r, (S, tiles) in zip(res[5:], probes.TINY["dg"]):
        assert r["value"] == tiles * 128 * rounds
    for r, (_m, C, N, _sort) in zip(res[7:], probes.TINY["gather"]):
        assert r["value"] == 16 * N * C


def test_main_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probes.main()
