"""The port's PCG4D counter hash is bit-equal to the JAX package's, and its
samplers agree to float32 rounding (solstrale_tpu/ops/rng.py:41-86)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solstrale_tpu.ops import rng as jrng
from solstrale_tpu_torch.ops import rng as trng

torch.set_num_threads(2)

PURPOSES = list(range(12)) + [16, 17, 18]
SEEDS = [0, 1, 7, 123456789, 2**31 - 1]


def _grid(seed):
    """Counter grid: large and small pixel ids, samples, bounces 0-50."""
    g = np.random.default_rng(seed)
    pix = np.concatenate([np.arange(64), g.integers(0, 2**31 - 1, 448),
                          [2**31 - 1, 2**31 - 2, 1920 * 1080 - 1]])
    n = pix.shape[0]
    sample = g.integers(0, 5000, n)
    bounce = np.arange(n) % 51
    return (pix.astype(np.int32), sample.astype(np.int32),
            bounce.astype(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_pcg4d_words_bit_equal(seed):
    pix, sample, bounce = _grid(seed)
    for purpose in PURPOSES:
        u32 = jnp.uint32
        a = jnp.asarray(pix).astype(u32)
        b = jnp.asarray(sample).astype(u32)
        c = (jnp.asarray(bounce).astype(u32) << 8) | u32(purpose)
        d = jnp.full(a.shape, seed, jnp.int32).astype(u32)
        want = [np.asarray(w).astype(np.int64) for w in jrng._pcg4d(a, b, c, d)]
        got = trng.words4(torch.from_numpy(pix), torch.from_numpy(sample),
                          torch.from_numpy(bounce), purpose, seed)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_floats_bit_equal(seed):
    pix, sample, bounce = _grid(seed + 1)
    for purpose in PURPOSES:
        want = jrng.uniform4(jnp.asarray(pix), jnp.asarray(sample),
                             jnp.asarray(bounce), purpose, jnp.int32(seed))
        got = trng.uniform4(torch.from_numpy(pix), torch.from_numpy(sample),
                            torch.from_numpy(bounce), purpose, seed)
        for w, g in zip(want, got):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_scalar_counters_broadcast_like_jax():
    """Python-int counters (the camera's bounce 0, a scalar sample) draw
    the same words as broadcast arrays."""
    pix = np.arange(1000, dtype=np.int32) * 7919
    want = jrng.uniform4(jnp.asarray(pix), 3, 0, jrng.P_JITTER,
                         jnp.int32(42))
    got = trng.uniform4(torch.from_numpy(pix), 3, 0, trng.P_JITTER, 42)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name,n_args", [
    ("cosine_direction3", 2), ("unit_vector3", 2), ("in_unit_sphere3", 3),
    ("in_unit_disc3", 2)])
def test_samplers_allclose(name, n_args):
    g = np.random.default_rng(3)
    args = [g.random(4096).astype(np.float32) for _ in range(n_args)]
    args[0][:3] = [0.0, 0.5, np.float32(1.0 - 2**-24)]
    want = getattr(jrng, name)(*[jnp.asarray(a) for a in args])
    got = getattr(trng, name)(*[torch.from_numpy(a) for a in args])
    for w, gg in zip(want, got):
        np.testing.assert_allclose(gg.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_to_sphere3_allclose():
    g = np.random.default_rng(4)
    radius = g.uniform(0.1, 2.0, 4096).astype(np.float32)
    dist_sq = (radius + g.uniform(0.01, 50, 4096)).astype(np.float32) ** 2
    r1, r2 = (g.random(4096).astype(np.float32) for _ in range(2))
    want = jrng.to_sphere3(*(jnp.asarray(x) for x in (radius, dist_sq, r1,
                                                       r2)))
    got = trng.to_sphere3(*(torch.from_numpy(x) for x in (radius, dist_sq,
                                                           r1, r2)))
    for w, gg in zip(want, got):
        np.testing.assert_allclose(gg.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
