"""Scene compile parity: the port's CompiledScene equals the JAX package's
field for field (values, dtypes, shapes), including the BVH and kernel-BVH
arrays, features and light kinds; the converter from JAX tables yields
the same scene; and the port's own kernel-BVH layout is sound."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solstrale_tpu as J
import solstrale_tpu_torch as T
from solstrale_tpu.scene.compile import SceneError as JSceneError
from solstrale_tpu.scene.compile import compile_scene as jcompile
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch.accel import EMPTY_BOX, WALK_LEAF
from solstrale_tpu_torch.scene.compile import SceneError as TSceneError
from solstrale_tpu_torch.scene.compile import (compile_scene as tcompile,
                                               from_numpy_tables, tables_of)

torch.set_num_threads(2)

W, H = 32, 24

FIXTURES = {
    "sponza24": lambda cfg, api: fixtures.sponza_class_scene(
        cfg, n_cells=24, api=api),
    "mixed16": lambda cfg, api: fixtures.mixed_bvh_scene(
        cfg, n_cells=16, api=api),
    "small": lambda cfg, api: fixtures.small_scene(cfg, api=api),
}


def assert_tables_equal(a, b, path="cs"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_tables_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tables_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert np.array_equal(a, b), path
    else:
        assert a == b, path


def _both(name, use_bvh=None):
    build = FIXTURES[name]
    cj = jcompile(build(J.RenderConfig(width=W, height=H), J),
                  use_bvh=use_bvh)
    ct = tcompile(build(T.RenderConfig(width=W, height=H), T),
                  use_bvh=use_bvh, device="cpu")
    return cj, ct


@pytest.mark.parametrize("name,use_bvh", [
    ("sponza24", None), ("mixed16", None), ("small", None),
    ("small", True), ("mixed16", False)])
def test_compiled_tables_equal(name, use_bvh):
    cj, ct = _both(name, use_bvh)
    assert (ct.kbvh is not None) == (cj.kbvh is not None)
    assert_tables_equal(tables_of(cj), tables_of(ct))


def test_bvh_routing_matches_threshold():
    cj, ct = _both("sponza24")
    n_tris = int(ct.solids.tr_valid.sum())
    assert n_tris == 1152 and ct.kbvh is not None and ct.bvh is not None
    _, small = _both("small")
    assert small.kbvh is None and small.bvh is None


@pytest.mark.parametrize("name", ["sponza24", "mixed16", "small"])
def test_from_numpy_tables_equals_compile(name):
    cj, ct = _both(name)
    conv = from_numpy_tables(tables_of(cj), device="cpu")
    assert_tables_equal(tables_of(conv), tables_of(ct))
    if ct.kbvh is not None:
        for k in ("nodes", "prims", "node_min", "node_max"):
            assert torch.equal(getattr(conv.kbvh, k), getattr(ct.kbvh, k))


def test_from_numpy_tables_rejects_foreign_kernel_bvh():
    cj, _ = _both("sponza24")
    tables = tables_of(cj)
    tables["kbvh"]["rows"] = tables["kbvh"]["rows"] + 1.0
    with pytest.raises(ValueError, match="rows"):
        from_numpy_tables(tables, device="cpu")


def test_from_numpy_tables_renders_like_jax():
    """The compiled tables are the renderer's parameters: carried across
    from the JAX package they render the JAX image."""
    from solstrale_tpu.renderer import integrator as JI
    from solstrale_tpu_torch.renderer import integrator as TI

    cj, _ = _both("small")
    conv = from_numpy_tables(tables_of(cj), device="cpu")
    kw = dict(width=W, height=H, max_depth=50, shader_kind=0,
              need_aux=False, n_samples=2)
    img_j, _, _, seg_j = JI.render_sample_batch(cj, jnp.int32(1),
                                                jnp.int32(1), **kw)
    img_t, _, _, seg_t = TI.render_sample_batch(conv, 1, 1, **kw)
    assert int(seg_t) == int(float(seg_j))
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=1e-4,
                               atol=1e-4)


def test_no_light_raises_like_jax():
    def dark(api):
        return api.Scene(
            api.Bvh([api.Sphere((0, 0, 0), 1.0,
                                api.Lambertian(api.SolidColor(1, 1, 1)))]),
            api.CameraConfig(look_from=(0, 0, 5)), (0, 0, 0),
            api.RenderConfig(width=8, height=8))

    with pytest.raises(JSceneError) as ej:
        jcompile(dark(J))
    with pytest.raises(TSceneError) as et:
        tcompile(dark(T), device="cpu")
    assert str(et.value) == str(ej.value) == \
        "Scene should have at least one light"
    with pytest.raises(ValueError, match="at least one light"):
        T.Renderer(dark(T), device="cpu")


def test_compile_defaults_to_cuda_and_never_falls_back():
    """compile_scene and from_numpy_tables put the tables on the card unless
    the caller asks for the CPU; without a card the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cj, _ = _both("small")
    scene = FIXTURES["small"](T.RenderConfig(width=W, height=H), T)
    with pytest.raises(RuntimeError, match="cuda"):
        tcompile(scene)
    with pytest.raises(RuntimeError, match="cuda"):
        from_numpy_tables(tables_of(cj))


@pytest.mark.parametrize("name", ["mixed16", "sponza24"])
def test_kernel_bvh_layout_is_conservative(name):
    """The port's kernel tree: each internal node's row holds both
    children's boxes and valid-prim counts; every box holds the AABBs of
    all prims under it (boxes only grow in the f32 cast), so each child box
    in a parent row holds the child's subtree and each leaf box its prims;
    a leaf's valid rows come first; empty subtrees are the far point box
    with count 0."""
    from solstrale_tpu_torch.accel import _planar_aabbs

    _, ct = _both(name)
    kb = ct.kbvh
    n_leaves, wl = kb.walk_leaves, WALK_LEAF
    n_int = n_leaves - 1
    lo = kb.node_min.numpy().astype(np.float64)
    hi = kb.node_max.numpy().astype(np.float64)
    rows = kb.nodes.numpy().astype(np.float64)
    assert rows.shape == (n_int, 16) and kb.levels == int(np.log2(n_leaves))
    left = 2 * np.arange(n_int) + 1
    for a in range(3):
        np.testing.assert_array_equal(
            rows[:, 4 * a:4 * a + 4],
            np.stack([lo[left, a], lo[left + 1, a], hi[left, a],
                      hi[left + 1, a]], 1))

    qi, q_lo, q_hi, ti, t_lo, t_hi = _planar_aabbs(ct.solids)
    Q = ct.solids.qd_valid.shape[0]
    box_lo = dict(zip(np.concatenate([qi, Q + ti]).tolist(),
                      np.concatenate([q_lo, t_lo])))
    box_hi = dict(zip(np.concatenate([qi, Q + ti]).tolist(),
                      np.concatenate([q_hi, t_hi])))
    prims = kb.prims.numpy()
    valid = prims[:, 13] > 0.5
    assert int(valid.sum()) == len(box_lo)
    count = valid.reshape(n_leaves, wl).sum(1)
    # valid rows first in every leaf
    assert (valid.reshape(n_leaves, wl)
            == (np.arange(wl)[None, :] < count[:, None])).all()
    # counts per node, and every ancestor's box around every prim
    node_count = np.zeros(2 * n_leaves - 1)
    for row in np.nonzero(valid)[0]:
        slot = int(prims[row, 14])
        node = n_int + row // wl
        while True:
            node_count[node] += 1
            assert (lo[node] <= box_lo[slot]).all()
            assert (hi[node] >= box_hi[slot]).all()
            if node == 0:
                break
            node = (node - 1) // 2
    np.testing.assert_array_equal(rows[:, 12], node_count[left])
    np.testing.assert_array_equal(rows[:, 13], node_count[left + 1])
    empty = node_count == 0
    far = np.float32(EMPTY_BOX)
    assert (lo[empty] == far).all() and (hi[empty] == far).all()
    assert (lo[~empty] < EMPTY_BOX).all()


@pytest.mark.parametrize("name", ["mixed16", "sponza24"])
def test_kernel_tree_refines_the_jax_treelets(name):
    """The full-depth kernel tree's leaf order is a permutation of the
    valid planar slots, and it refines the JAX layout's: each treelet of
    the JAX ``rows`` holds the same prims as the kernel tree's slots in the
    same range (the split above the treelet roots is the same), while the
    kernel tree splits on below them, to leaves of WALK_LEAF prims."""
    cj, ct = _both(name)
    kb = ct.kbvh
    prims = kb.prims.numpy()
    n = int((prims[:, 13] > 0.5).sum())
    Q = ct.solids.qd_valid.shape[0]
    want = np.concatenate([np.nonzero(ct.solids.qd_valid.numpy())[0],
                           Q + np.nonzero(ct.solids.tr_valid.numpy())[0]])
    assert (prims[:n, 13] > 0.5).all()
    np.testing.assert_array_equal(np.sort(prims[:n, 14]).astype(np.int64),
                                  np.sort(want))
    jk = cj.kbvh
    p_t = jk.tr * jk.leaf_size
    nbt = max(1, (p_t + 127) // 128)
    jrows = np.asarray(jk.rows).reshape(jk.n_troots, nbt, 16, 128)
    jslots = jrows.transpose(0, 1, 3, 2).reshape(
        jk.n_troots, nbt * 128, 16)[:, :p_t, 14]
    jvalid = jrows.transpose(0, 1, 3, 2).reshape(
        jk.n_troots, nbt * 128, 16)[:, :p_t, 13] > 0.5
    kslots = prims[:, 14].reshape(jk.n_troots, p_t)
    kvalid = prims[:, 13].reshape(jk.n_troots, p_t) > 0.5
    for j in range(jk.n_troots):
        np.testing.assert_array_equal(np.sort(jslots[j][jvalid[j]]),
                                      np.sort(kslots[j][kvalid[j]]))
    assert WALK_LEAF < kb.leaf_size
    assert kb.walk_leaves * WALK_LEAF == kb.n_leaves * kb.leaf_size
    assert not np.array_equal(prims[:n, 14], jslots[jvalid])


@pytest.mark.parametrize("n,leaf_size,n_leaves,stop", [
    (1000, 8, 128, 4), (1000, 4, 256, 1), (37, 2, 32, 2), (5, 8, 1, 1)])
def test_median_split_matches_jax(n, leaf_size, n_leaves, stop):
    """The port's level-at-a-time median split equals the JAX package's
    segment loop: its order where segments cover ``stop`` leaves is the
    JAX order with splitting stopped there, and its split axes are the
    JAX build's above that level."""
    from solstrale_tpu.accel import median_split_order as jsplit
    from solstrale_tpu_torch.accel import median_split_order

    rng = np.random.default_rng(n)
    lo = rng.uniform(-5, 5, (n, 3))
    lo[: n // 3, 1] = 0.25          # ties along one axis keep their order
    hi = lo + rng.uniform(0, 1, (n, 3))
    axes_j = {}
    want = jsplit(lo, hi, leaf_size, n_leaves, stop_leaves=stop,
                  axes_out=axes_j)
    order, axes, kept = median_split_order(lo, hi, leaf_size, n_leaves,
                                           keep_leaves=stop)
    np.testing.assert_array_equal(kept, want)
    assert sorted(order.tolist()) == list(range(n))
    split = {k: int(a) for k, a in enumerate(axes) if a >= 0
             and k < n_leaves // stop - 1}
    assert split == axes_j
