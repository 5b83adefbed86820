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


def _forms():
    """Every argument form the draw callers pass, and broadcast ones:
    (pixel, sample, bounce, seed) with (R,) int32 / int64 tensors, Python
    ints (the camera's bounce 0), pixel ids past 2**32 (taken mod 2**32),
    an (R, 1) by (1, S) broadcast (neither operand contiguous in the
    result's shape), and the seed as an int, a 0-dim int32 / int64 tensor
    or a (1,) tensor."""
    g = np.random.default_rng(11)
    pix = torch.from_numpy(g.integers(0, 2**40, 257))
    sample = torch.from_numpy(g.integers(0, 5000, 257))
    bounce = torch.from_numpy(g.integers(0, 51, 257).astype(np.int32))
    return {
        "lanes": (pix, sample, bounce, 7),
        "int32 lanes": (pix.to(torch.int32), sample.to(torch.int32), bounce,
                        7),
        "int counters": (pix, 3, 0, 42),
        "tensor seed": (pix, sample, bounce, torch.tensor(2**31 - 1)),
        "int32 seed": (pix, 1, bounce, torch.tensor(5, dtype=torch.int32)),
        "(1,) seed": (pix, sample, 0, torch.tensor([9])),
        "0-dim sample": (pix, torch.tensor(100), bounce, 1),
        "broadcast": (pix[:31, None], sample[None, :17], 2, 3),
        "scalars": (torch.tensor(5), 6, 7, 8),
    }


def _kernel_words(args, purpose):
    """The words the draw kernel computes from ``rng.kernel_counter``'s
    arguments: lane i reads a counter's tensor at i * stride, or takes its
    value, as csrc/hit.cuh's Counter does, and hashes the low 32 bits."""
    shape = torch.broadcast_shapes(*(x.shape for x in args
                                     if isinstance(x, torch.Tensor)))
    n = int(np.prod(shape, dtype=np.int64))
    lanes = torch.arange(n)
    vals = []
    for x in args:
        t, stride, value = trng.kernel_counter(x, shape, torch.device("cpu"))
        if t is None:
            v = torch.full((n,), value, dtype=torch.int64)
        else:
            assert stride in (0, 1) and t.is_contiguous()
            assert stride == 0 or t.shape == shape
            v = t.reshape(-1).to(torch.int64)[lanes * stride]
        vals.append(v & 0xFFFFFFFF)
    a, b, bounce, d = vals
    c = ((bounce << 8) & 0xFFFFFFFF) | purpose
    return [w.reshape(shape) for w in trng.pcg4d(a, b, c, d)]


def _jax_args(args):
    return [jnp.asarray(x.numpy()) if isinstance(x, torch.Tensor) else x
            for x in args]


@pytest.mark.parametrize("form", list(_forms()))
def test_kernel_counters_give_the_plain_words(form):
    """The draw kernel's argument normalisation (``kernel_counter``: by
    value, stride 0 or stride 1) gives the JAX package's PCG4D words bit
    for bit for every argument form, and the wrapper on CPU tensors (the
    plain chain) gives JAX's floats bit for bit."""
    args = _forms()[form]
    for purpose in (trng.P_JITTER, trng.P_COSINE, trng.P_MEDIUM_BASE + 3):
        ja = _jax_args(args)
        u32 = jnp.uint32
        a, b, bb, d = (jnp.asarray(x).astype(u32) for x in ja)
        c = (bb << 8) | u32(purpose)
        a, b, c, d = jnp.broadcast_arrays(a, b, c, d)
        want = [np.asarray(w).astype(np.int64) for w in jrng._pcg4d(a, b, c,
                                                                     d)]
        for w, g in zip(want, _kernel_words(args, purpose)):
            np.testing.assert_array_equal(g.numpy(), w)
        want_u = jrng.uniform4(*ja[:3], purpose, ja[3])
        got_u = trng.uniform4(*args[:3], purpose, args[3])
        for w, g in zip(want_u, got_u):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_kernel_counter_refuses_float_counters():
    with pytest.raises(TypeError, match="int32 / int64"):
        trng.kernel_counter(torch.zeros(4), torch.Size([4]),
                            torch.device("cpu"))
