"""LBVH builds: the port's on-device build (``accel.build_bvh_device``,
torch, here on CPU tensors) against the JAX package's ``build_bvh_device``
and the port's host ``build_bvh``; the native Morton sort and node
reduction (``native.lbvh_sort`` / ``lbvh_nodes``, built with g++ from the
port's own copy of the C++ source) against the JAX package's native
library and numpy; ``compile_scene(use_bvh="device")`` against
``use_bvh=True``; and a broken native source raising. All exact."""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solstrale_tpu as J
import solstrale_tpu.native as jnative
import solstrale_tpu_torch as T
from solstrale_tpu.accel import build_bvh_device as jbuild_bvh_device
from solstrale_tpu_torch import accel, fixtures, native
from solstrale_tpu_torch.scene.compile import compile_scene, tables_of

from test_torch_scene import assert_tables_equal

torch.set_num_threads(2)

FIELDS = ("node_min", "node_max", "lp_kind", "lp_idx")
SCENES = {
    "sponza40": lambda cfg: fixtures.sponza_class_scene(cfg, n_cells=40),
    "mixed16": lambda cfg: fixtures.mixed_bvh_scene(cfg, n_cells=16),
}


def _host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _assert_bvh_equal(a, b):
    for f in FIELDS:
        x, y = _host(getattr(a, f)), _host(getattr(b, f))
        assert (x.dtype, x.shape) == (y.dtype, y.shape), f
        assert np.array_equal(x, y), f


def _sponza_aabbs():
    cs = compile_scene(SCENES["sponza40"](T.RenderConfig(width=8, height=8)),
                       use_bvh=True, device="cpu")
    kinds, idxs, mins, maxs = accel.solids_aabbs(cs.solids)
    return cs, kinds, idxs, mins.astype(np.float32), maxs.astype(np.float32)


def test_build_bvh_device_matches_jax_and_host():
    """On the sponza-class terrain at n_cells=40 (3,200 triangles and the
    room's 4 quads): the torch device build equals the JAX package's
    device build and the port's host build, array for array."""
    cs, kinds, idxs, mins, maxs = _sponza_aabbs()
    assert int(cs.solids.tr_valid.sum()) == 3200
    got = accel.build_bvh_device(*(torch.from_numpy(a) for a in
                                   (mins, maxs, kinds, idxs)))
    want = jbuild_bvh_device(*(jnp.asarray(a) for a in
                               (mins, maxs, kinds, idxs)))
    assert got.node_min.dtype == torch.float32
    assert got.lp_kind.dtype == torch.int32
    _assert_bvh_equal(got, want)
    _assert_bvh_equal(got, cs.bvh)
    assert (_host(got.lp_kind) >= 0).sum() == 3204


def _random_boxes(n=120_000, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-50.0, 50.0, (n, 3))
    h = rng.uniform(0.0, 1.0, (n, 3))
    return (c - h).astype(np.float32), (c + h).astype(np.float32)


def _morton_f32(mins, maxs):
    """numpy Morton codes with the centroids and their quantisation in f32
    (the native sort's and the device build's arithmetic)."""
    c = (mins + maxs) * np.float32(0.5)
    lo, hi = c.min(0), c.max(0)
    ext = np.maximum(hi - lo, np.float32(1e-12))
    q = np.clip((c - lo) / ext * np.float32(1023.0), 0, 1023).astype(
        np.uint32)
    e = accel._expand_bits
    return (e(q[:, 0]) << 2) | (e(q[:, 1]) << 1) | e(q[:, 2])


def test_native_lbvh_sort_matches_jax_and_numpy():
    """120,000 random boxes (above NATIVE_SORT_THRESHOLD): the port's
    native sort equals the JAX package's native sort and numpy's stable
    argsort of the f32 Morton codes, position for position. The f64
    ``morton_codes`` (numpy's route below the threshold) quantise a few
    centroids that lie within f32 rounding of a bin boundary into the
    neighbouring bin: every code where the two differ is such a case."""
    mins, maxs = _random_boxes()
    assert jnative.load() is not None
    order = native.lbvh_sort(mins, maxs)
    assert order.dtype == np.int32
    np.testing.assert_array_equal(order, jnative.lbvh_sort(mins, maxs))
    code32 = _morton_f32(mins, maxs)
    np.testing.assert_array_equal(order, np.argsort(code32, kind="stable"))

    c = (mins.astype(np.float64) + maxs) / 2.0
    code64 = accel.morton_codes(c)
    off = np.nonzero(code64 != code32)[0]
    assert len(off) < 10
    scaled = (c - c.min(0)) / (c.max(0) - c.min(0)) * 1023.0
    frac = np.abs(scaled[off] - np.round(scaled[off]))
    assert (frac.min(axis=1) < 1e-3).all()


def test_native_lbvh_nodes_matches_jax_and_numpy():
    mins, maxs = _random_boxes(seed=1)
    order = native.lbvh_sort(mins, maxs)
    n_leaves = accel._n_leaves(len(mins), accel.LEAF_SIZE)
    n_slots = n_leaves * accel.LEAF_SIZE
    slot_min = np.full((n_slots, 3), np.inf, np.float32)
    slot_max = np.full((n_slots, 3), -np.inf, np.float32)
    slot_min[:len(mins)] = mins[order]
    slot_max[:len(maxs)] = maxs[order]
    got = native.lbvh_nodes(slot_min, slot_max, accel.LEAF_SIZE)
    want = jnative.lbvh_nodes(slot_min, slot_max, accel.LEAF_SIZE)
    ref = accel._level_boxes(slot_min.astype(np.float64),
                             slot_max.astype(np.float64), n_leaves,
                             accel.LEAF_SIZE)
    for g, w, r in zip(got, want, ref):
        assert g.dtype == np.float32 and g.shape == (2 * n_leaves - 1, 3)
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r.astype(np.float32))


def test_build_bvh_native_route_matches_jax():
    """At NATIVE_SORT_THRESHOLD prims and above, build_bvh takes the native
    sort and node reduction, as the JAX package's does: the trees are equal
    (a terrain of 100,352 triangles plus the room's 4 quads)."""
    from solstrale_tpu.accel import build_bvh as jbuild_bvh
    from solstrale_tpu.scene.compile import compile_scene as jcompile

    cfg = dict(width=8, height=8)
    ct = compile_scene(fixtures.sponza_class_scene(
        T.RenderConfig(**cfg), n_cells=224), use_bvh=False, device="cpu")
    cj = jcompile(fixtures.sponza_class_scene(
        J.RenderConfig(**cfg), n_cells=224, api=J), use_bvh=False)
    n = int(ct.solids.tr_valid.sum()) + int(ct.solids.qd_valid.sum())
    assert n >= accel.NATIVE_SORT_THRESHOLD
    _assert_bvh_equal(accel.build_bvh(ct.solids), jbuild_bvh(cj.solids))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_compile_scene_device_bvh_matches_host(name):
    """compile_scene(use_bvh="device") gives the tables of use_bvh=True
    (mixed16 adds spheres to the prim kinds)."""
    scene = SCENES[name](T.RenderConfig(width=8, height=8))
    dev = compile_scene(scene, use_bvh="device", device="cpu")
    host = compile_scene(scene, use_bvh=True, device="cpu")
    assert isinstance(dev.bvh.node_min, torch.Tensor)
    for k in ("nodes", "prims", "node_min", "node_max"):
        assert torch.equal(getattr(dev.kbvh, k), getattr(host.kbvh, k))
    assert_tables_equal(tables_of(dev), tables_of(host))


def test_failed_native_build_raises(tmp_path):
    """A source that does not compile raises with the compiler's message;
    nothing falls back."""
    broken = tmp_path / "solstrale_native.cpp"
    shutil.copy(native.SOURCE, broken)
    broken.write_text(broken.read_text() + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*error"):
        native.library(broken)
    assert not native.library_path(broken).exists()


def test_native_parse_of_unreadable_file_raises(tmp_path):
    with pytest.raises(OSError, match="could not read"):
        native.parse_obj(tmp_path / "absent.obj")
