"""The six sampling helpers that no render path calls
(hiprt_pt_tpu_torch/ops/sampling.py: sample_disk, sample_uniform_sphere,
radical_inverse_base2, hammersley_2d, power_heuristic, reflect) against the
JAX package's on the same numpy inputs: bit-identical where the result is
integer or a product of exact operations, else within a few float32 ulps
(rtol 1e-6, atol 1e-6 on values of magnitude <= 1: XLA and torch round
cos, sin and sqrt apart by an ulp)."""

import numpy as np
import jax.numpy as jnp
import torch

from hiprt_pt_tpu.ops import sampling as js
from hiprt_pt_tpu_torch.ops import sampling as ts

N = 4096


def _uniforms(seed, n=N):
    g = np.random.default_rng(seed)
    return g.random(n, dtype=np.float32), g.random(n, dtype=np.float32)


def test_sample_disk_matches_jax():
    u1, u2 = _uniforms(0)
    got = ts.sample_disk(torch.from_numpy(u1), torch.from_numpy(u2))
    want = js.sample_disk(jnp.asarray(u1), jnp.asarray(u2))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    r2 = got[0] ** 2 + got[1] ** 2
    assert float(r2.max()) <= 1.0 + 1e-6


def test_sample_uniform_sphere_matches_jax():
    u1, u2 = _uniforms(1)
    got = ts.sample_uniform_sphere(torch.from_numpy(u1), torch.from_numpy(u2))
    want = js.sample_uniform_sphere(jnp.asarray(u1), jnp.asarray(u2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(torch.linalg.norm(got, dim=-1).numpy(), 1.0,
                               atol=1e-5)
    # uniform on the sphere: E[z] = 0, E[z^2] = 1/3
    z = got[:, 2].double()
    assert abs(float(z.mean())) < 0.03 and abs(float((z * z).mean()) - 1 / 3) < 0.02


def test_radical_inverse_is_bit_identical():
    """Every bit position and the uint32 extremes, then random words."""
    g = np.random.default_rng(2)
    bits = np.concatenate([
        np.uint32(1) << np.arange(32, dtype=np.uint32),
        np.asarray([0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0xAAAAAAAA,
                    0x55555555, 0x12345678], np.uint32),
        g.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)])
    got = ts.radical_inverse_base2(torch.from_numpy(bits.astype(np.int64)))
    want = np.asarray(js.radical_inverse_base2(jnp.asarray(bits)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the bit reversal of 2^k is 2^(31-k), which reads 2^(-1-k)
    np.testing.assert_array_equal(
        got[:32].numpy(), np.float32(2.0) ** -(1 + np.arange(32, dtype=np.float32)))


def test_hammersley_2d_is_bit_identical():
    i = np.arange(1024, dtype=np.int32)
    got = ts.hammersley_2d(torch.from_numpy(i), 1024)
    want = js.hammersley_2d(jnp.asarray(i), 1024)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # a (0, 2)-sequence in base 2: each of 1,024 strata of v holds one point
    assert len(set((got[1].numpy() * 1024).astype(int))) == 1024


def test_power_heuristic_matches_jax():
    g = np.random.default_rng(3)
    a = g.uniform(0.0, 5.0, N).astype(np.float32)
    b = g.uniform(0.0, 5.0, N).astype(np.float32)
    a[:4] = 0.0
    b[:2] = 0.0
    got = ts.power_heuristic(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(js.power_heuristic(a, b)))
    both = ts.power_heuristic(torch.from_numpy(b), torch.from_numpy(a)) + got
    np.testing.assert_allclose(both[2:].numpy(), 1.0, atol=1e-6)


def test_reflect_matches_jax():
    g = np.random.default_rng(4)
    d = g.normal(size=(N, 3)).astype(np.float32)
    n = g.normal(size=(N, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    got = ts.reflect(torch.from_numpy(d), torch.from_numpy(n))
    np.testing.assert_allclose(got.numpy(), np.asarray(js.reflect(d, n)),
                               rtol=1e-6, atol=1e-6)
    # the mirror keeps the length and the normal component
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1),
                               np.linalg.norm(d, axis=-1), rtol=1e-5)
    np.testing.assert_allclose((got.numpy() * n).sum(-1), (d * n).sum(-1),
                               atol=1e-5)
