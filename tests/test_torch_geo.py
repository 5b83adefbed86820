"""``geo.ray_shortest_distance`` against the JAX package's
(solstrale_tpu/geo/__init__.py:98-108, the reference's geo/mod.rs:292-304)
on the CPU: JAX's own test values, random ray pairs and exactly parallel
pairs, in f32 within rtol 1e-5 / atol 1e-6, and the batched shape."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solstrale_tpu.geo import ray_shortest_distance as jax_distance
from solstrale_tpu_torch.geo import ray_shortest_distance

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _both(o1, d1, o2, d2):
    args = [np.asarray(a, np.float32) for a in (o1, d1, o2, d2)]
    ref = np.asarray(jax_distance(*map(jnp.asarray, args)))
    got = ray_shortest_distance(*map(torch.from_numpy, args)).numpy()
    return got, ref


def _reference_f64(o1, d1, o2, d2):
    """The reference's f64 formula with the parallel case taken where the
    cross product is exactly zero."""
    o1, d1, o2, d2 = (np.asarray(a, np.float64) for a in (o1, d1, o2, d2))
    n = np.cross(d1, d2)
    n_len = np.linalg.norm(n, axis=-1)
    od = o1 - o2
    parallel = n_len == 0.0
    dist_parallel = (np.linalg.norm(np.cross(d1, od), axis=-1)
                     / np.linalg.norm(d1, axis=-1))
    dist_skew = np.sum(od * n, -1) / np.where(parallel, 1.0, n_len)
    return np.abs(np.where(parallel, dist_parallel, dist_skew))


@pytest.mark.parametrize("o2, d2, want", [
    ((0.0, 2, 0), (1.0, 0, 0), 2.0),     # parallel rays at distance 2
    ((0.0, 0, 3), (0.0, 1, 0), 3.0),     # skew rays at distance 3
])
def test_jax_test_values(o2, d2, want):
    """tests/test_checkpoint.py:42-50's values."""
    got, ref = _both((0.0, 0, 0), (1.0, 0, 0), o2, d2)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_pairs(seed):
    g = np.random.default_rng(seed)
    o1, o2 = g.normal(size=(2, 1000, 3)) * 5.0
    d1, d2 = g.normal(size=(2, 1000, 3))
    got, ref = _both(o1, d1, o2, d2)
    assert got.shape == (1000,)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def _parallel(d1, k):
    return {"same": d1, "opposite": -d1, "double": 2.0 * d1}[k]


@pytest.mark.parametrize("k", ["same", "opposite", "double"])
def test_axis_parallel_pairs_match_jax(k):
    """Parallel pairs along the axes: the cross product is exactly zero in
    f32 on both packages, so both take the parallel case."""
    g = np.random.default_rng(11)
    d1 = (np.eye(3)[g.integers(0, 3, 300)]
          * g.uniform(0.5, 4.0, (300, 1)) * g.choice([-1.0, 1.0], (300, 1)))
    o1, o2 = g.normal(size=(2, 300, 3)) * 5.0
    d1 = d1.astype(np.float32)
    got, ref = _both(o1, d1, o2, _parallel(d1, k))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _reference_f64(o1, d1, o2,
                                                   _parallel(d1, k)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", ["same", "opposite", "double"])
def test_general_parallel_pairs(k):
    """Parallel pairs in any direction: the port's cross product is exactly
    zero (separate multiplies and subtracts), so it takes the parallel case
    and equals the reference's formula. The JAX function on the CPU is not
    the bar here: XLA fuses each cross term into a multiply-add, whose
    nonzero rounding residue sends it down the skew case."""
    g = np.random.default_rng(12)
    o1, o2 = g.normal(size=(2, 1000, 3)) * 5.0
    d1 = g.normal(size=(1000, 3)).astype(np.float32)
    d2 = _parallel(d1, k)
    t = [torch.from_numpy(np.asarray(a, np.float32))
         for a in (o1, d1, o2, d2)]
    got = ray_shortest_distance(*t).numpy()
    np.testing.assert_allclose(got, _reference_f64(*(a.numpy() for a in t)),
                               rtol=RTOL, atol=ATOL)


def test_batched_shape():
    g = np.random.default_rng(3)
    o1, d1, o2, d2 = (g.normal(size=(4, 5, 3)) for _ in range(4))
    d2[0] = d1[0]                     # one row of parallel pairs
    got, ref = _both(o1, d1, o2, d2)
    assert got.shape == (4, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got[1:], ref[1:], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _reference_f64(
        *(np.asarray(a, np.float32) for a in (o1, d1, o2, d2))),
        rtol=RTOL, atol=ATOL)
