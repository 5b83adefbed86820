"""The benchmark's asset-free stand-ins against the JAX package: the
textured sponza-class interior, the production-diversity interior, the
many-light scene and the kitchen (``fixtures.sponza_textured_scene``,
``sponza_production_scene``, ``many_light_scene``, and
``kitchen_sink_scene`` as the bench builds it), built at a small size
through both packages. The compiled tables are equal (tolerance 0), the
JAX package's own fixtures (``tests/scenes.py``, its image loads answered
with the same procedural images) compile to the same tables, and the
port's render_sample_batch agrees with the JAX package's on the three
interiors."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenes
import solstrale_tpu as J
import solstrale_tpu_torch as T
from solstrale_tpu.renderer import integrator as JI
from solstrale_tpu.scene.compile import compile_scene as jcompile
from solstrale_tpu_torch import bench, fixtures
from solstrale_tpu_torch.renderer import integrator as TI
from solstrale_tpu_torch.scene import materials
from solstrale_tpu_torch.scene.compile import (KIND_QUAD, KIND_SPHERE,
                                               KIND_TRIANGLE, compile_scene,
                                               tables_of)

from test_torch_scene import assert_tables_equal

torch.set_num_threads(2)

W, H, SPP, SEED = 32, 24, 2, 1
TEX = 32
# n_lights=20 stays above the 16 lights that next-event estimation unrolls
FIXTURES = {
    "sponza_textured": lambda cfg, api: fixtures.sponza_textured_scene(
        cfg, n_cells=24, tex_size=TEX, api=api),
    "sponza_production": lambda cfg, api: fixtures.sponza_production_scene(
        cfg, n_cells=24, tex_size=TEX, api=api),
    "many_light": lambda cfg, api: fixtures.many_light_scene(
        cfg, n_lights=20, n_cells=16, api=api),
    # bench.WORKLOADS' kitchen_sink at a small texture size
    "kitchen_sink": lambda cfg, api: fixtures.kitchen_sink_scene(
        cfg, api=api, normal_map=False, tex_size=TEX),
}
# the scenes with a BVH (the kitchen's 141 planar rows take none)
BVH_SCENES = ("many_light", "sponza_production", "sponza_textured")
REFERENCE = {
    "sponza_textured": lambda cfg: scenes.create_sponza_class_scene(
        cfg, n_cells=24),
    "sponza_production": lambda cfg: scenes.create_sponza_production_scene(
        cfg, n_cells=24),
    "many_light": lambda cfg: scenes.create_many_light_scene(
        cfg, n_lights=20, n_cells=16),
    "kitchen_sink": scenes.create_test_scene,
}


def _cfg(api):
    return api.RenderConfig(width=W, height=H, samples_per_pixel=SPP,
                            seed=SEED, samples_per_batch=SPP)


def _both(name):
    cj = jcompile(FIXTURES[name](_cfg(J), J))
    ct = compile_scene(FIXTURES[name](_cfg(T), T), device="cpu")
    return cj, ct


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_compiled_tables_equal_jax(name):
    """Every table of the port's compile equals the JAX package's, built
    from the same fixture through each package's API."""
    cj, ct = _both(name)
    has_bvh = name in BVH_SCENES
    assert (ct.kbvh is not None) == has_bvh == (cj.kbvh is not None)
    assert_tables_equal(tables_of(cj), tables_of(ct))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_is_the_jax_scene(name, monkeypatch):
    """The stand-in is the JAX package's fixture line for line: with its
    image loads answered by ``bench_textures`` (by the asset's name),
    ``tests/scenes.py``'s scene compiles to the same tables."""
    images = fixtures.bench_textures(TEX)

    class ImageMap:
        @staticmethod
        def load(path):
            name = os.path.splitext(os.path.basename(path))[0]
            return J.ImageMap(images[name])

    monkeypatch.setattr(scenes, "ImageMap", ImageMap)
    monkeypatch.setattr(scenes, "load_normal_texture",
                        lambda path: ImageMap.load(path))
    want = tables_of(jcompile(REFERENCE[name](_cfg(J))))
    got = tables_of(jcompile(FIXTURES[name](_cfg(J), J)))
    assert_tables_equal(want, got)


def _images(obj, seen=None):
    """The images of every ImageMap reachable from ``obj``'s attributes."""
    seen = set() if seen is None else seen
    if id(obj) in seen or isinstance(obj, (str, bytes, int, float,
                                           np.ndarray)):
        return []
    seen.add(id(obj))
    if isinstance(obj, T.ImageMap):
        return [obj.image]
    items = (obj if isinstance(obj, (list, tuple)) else
             getattr(obj, "__dict__", {}).values())
    return [img for v in items for img in _images(v, seen)]


def test_bench_kitchen_grounds_on_the_production_tex():
    """bench.py's kitchen and production interior load one asset,
    ``tex.jpg``: the bench's kitchen workload takes the image the
    production stand-in takes for it, ``bench_textures()["tex"]``."""
    kitchen = next(w for w in bench.WORKLOADS if w.name == "kitchen_sink")
    cfg = T.RenderConfig(width=8, height=8)
    tex = fixtures.bench_textures()["tex"]
    production = _images(fixtures.sponza_production_scene(cfg, n_cells=4))
    assert any(np.array_equal(img, tex) for img in production)
    images = _images(kitchen.scene(cfg))
    assert len(images) == 1 and np.array_equal(images[0], tex)


def test_bench_textures():
    """Five (size, size, 3) u8 images, none flat; the normal map points
    out of the surface (blue channel high)."""
    images = fixtures.bench_textures(64)
    assert sorted(images) == ["checker", "earth_height", "tex", "wall_color",
                              "wall_n"]
    for img in images.values():
        assert img.shape == (64, 64, 3) and img.dtype == np.uint8
        assert img.std() > 5
    assert images["wall_n"][..., 2].min() > 200
    assert np.array_equal(images["tex"], fixtures.bench_textures(64)["tex"])


@pytest.mark.parametrize("name", BVH_SCENES)
def test_render_sample_batch_matches_jax(name, monkeypatch):
    """32x24, 2 spp, depth 50: the port's render against the JAX package's,
    its Pallas kernels interpreted (SOLSTRALE_PALLAS=1, as for the
    textured kitchen in test_torch_render.py), so both sides intersect
    with the same formulas. Segments equal, every value within rtol 1e-4
    and atol 1e-4."""
    monkeypatch.setenv("SOLSTRALE_PALLAS", "1")
    cj, ct = _both(name)
    kw = dict(width=W, height=H, max_depth=50, shader_kind=0,
              need_aux=False, n_samples=SPP)
    img_j, _, _, seg_j = JI.render_sample_batch(cj, jnp.int32(1),
                                                jnp.int32(SEED), **kw)
    img_t, _, _, seg_t = TI.render_sample_batch(ct, 1, SEED, **kw)
    img_t = img_t.numpy()
    assert img_t.shape == (H, W, 3) and np.isfinite(img_t).all()
    assert img_t.mean() > 0.05
    assert int(seg_t) == int(seg_j)
    np.testing.assert_allclose(img_t, np.asarray(img_j), rtol=1e-4,
                               atol=1e-4)


def test_production_scene_composition():
    """The checks of tests/test_production_scene.py on the port's compile:
    every material kind, at least 16 materials, 4 image textures and 4
    lights, all three light shapes, blends and normal maps."""
    cfg = T.RenderConfig(width=32, height=18, samples_per_pixel=1, seed=1)
    cs = compile_scene(fixtures.sponza_production_scene(
        cfg, n_cells=40, seed=7, tex_size=TEX), device="cpu")
    kinds = set(cs.materials.kind.tolist())
    assert {materials.LAMBERTIAN, materials.METAL, materials.DIELECTRIC,
            materials.BLEND} <= kinds
    assert cs.materials.kind.shape[0] >= 16
    assert int(((cs.textures.w * cs.textures.h) > 1).sum()) >= 4
    assert cs.lights.kind.shape[0] >= 4
    assert {KIND_QUAD, KIND_SPHERE, KIND_TRIANGLE} <= set(
        cs.lights.kind.tolist())
    assert {"blend", "normal_maps"} <= set(cs.features)


def test_many_light_scene_takes_the_batched_light_pdf():
    """64 lights at the benchmark's size (63 spheres and a quad), above the
    unroll limit of the light pdf, on the BVH route."""
    from solstrale_tpu_torch.ops import intersect

    cs = compile_scene(fixtures.many_light_scene(
        T.RenderConfig(width=16, height=9), n_lights=64, n_cells=16),
        device="cpu")
    assert cs.lights.kind.shape[0] == 64 > intersect._MEAN3_UNROLL_MAX
    assert cs.solids.sph_center.shape[0] == 63 and cs.kbvh is not None
