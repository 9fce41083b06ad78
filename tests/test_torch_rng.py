"""The port's PCG RNG draws exactly the JAX package's numbers over a grid of
(pixel, sample, seed)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hiprt_pt_tpu.core import rng as jrng
from hiprt_pt_tpu_torch.core import rng as trng

PIXELS = np.concatenate([np.arange(2048), [2073599, 2**24 + 3, 2**32 - 2]]).astype(np.uint32)


@pytest.mark.parametrize("sample", [0, 1, 777, 2**31 - 1])
@pytest.mark.parametrize("seed", [0, 42, 0xFFFFFFFF])
def test_seed_and_draws_match_jax(sample, seed):
    js = jrng.seed(jnp.asarray(PIXELS), sample, seed)
    ts = trng.seed(torch.from_numpy(PIXELS.astype(np.int64)), sample, seed)
    assert np.array_equal(np.asarray(js).astype(np.int64), ts.numpy())
    for _ in range(3):
        js, jf = jrng.next_float(js)
        ts, tf = trng.next_float(ts)
        assert np.array_equal(np.asarray(jf), tf.numpy())
    js, ja, jb = jrng.next_float2(js)
    ts, ta, tb = trng.next_float2(ts)
    assert np.array_equal(np.asarray(ja), ta.numpy())
    assert np.array_equal(np.asarray(jb), tb.numpy())
    assert np.array_equal(np.asarray(js).astype(np.int64), ts.numpy())


def test_pcg_hash_matches_jax_on_random_words():
    words = np.random.default_rng(0).integers(0, 2**32, 100_000, dtype=np.uint64)
    jh = np.asarray(jrng.pcg_hash(jnp.asarray(words.astype(np.uint32))))
    th = trng.pcg_hash(torch.from_numpy(words.astype(np.int64)))
    assert np.array_equal(jh.astype(np.int64), th.numpy())


def test_draws_lie_in_unit_interval():
    s = trng.seed(torch.arange(50_000), 0, 7)
    _, f = trng.next_float(s)
    assert f.dtype == torch.float32
    assert float(f.min()) >= 0.0 and float(f.max()) < 1.0
    hist = np.histogram(f.numpy(), bins=10, range=(0, 1))[0]
    assert hist.min() > 4500
