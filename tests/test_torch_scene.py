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
from solstrale_tpu_torch.accel import EMPTY_BOX
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


def test_kernel_bvh_layout_is_conservative():
    """The port's kernel node table: every internal box holds its children,
    every leaf box holds its prims' AABBs (boxes only grow in the f32
    cast), empty subtrees are the far point box, split axes are 0-2."""
    from solstrale_tpu_torch.accel import _planar_aabbs

    _, ct = _both("mixed16")
    kb = ct.kbvh
    nodes = kb.nodes.numpy().astype(np.float64)
    n_leaves, leaf = kb.n_leaves, kb.leaf_size
    bmin, bmax = nodes[:, 0:3], nodes[:, 3:6]
    empty = bmin[:, 0] >= EMPTY_BOX
    inner = np.arange(n_leaves - 1)
    for child in (2 * inner + 1, 2 * inner + 2):
        ok = empty[child] | ((bmin[inner] <= bmin[child]).all(1)
                             & (bmax[inner] >= bmax[child]).all(1))
        assert ok.all()
    assert set(np.unique(nodes[inner, 6])) <= {0.0, 1.0, 2.0}

    qi, q_lo, q_hi, ti, t_lo, t_hi = _planar_aabbs(ct.solids)
    Q = ct.solids.qd_valid.shape[0]
    lo = {int(s): b for s, b in zip(np.concatenate([qi, Q + ti]),
                                    np.concatenate([q_lo, t_lo]))}
    hi = {int(s): b for s, b in zip(np.concatenate([qi, Q + ti]),
                                    np.concatenate([q_hi, t_hi]))}
    prims = kb.prims.numpy()
    assert int(prims[:, 13].sum()) == len(lo)
    for row in np.nonzero(prims[:, 13] > 0.5)[0]:
        node = n_leaves - 1 + row // leaf
        slot = int(prims[row, 14])
        assert (bmin[node] <= lo[slot]).all() and (bmax[node] >= hi[slot]).all()
