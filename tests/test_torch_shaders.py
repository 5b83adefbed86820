"""The renderer's surface beyond the main path, on the CPU: camera_rays,
render_pixels / render_sample with the path shader (both early_exit modes)
and the albedo, normal and simple debug shaders, the aux planes of
render_sample_batch(need_aux=True), each against the JAX package (its XLA
path) on the same scenes and seeds. The normal-mapped kitchen (the K4
route) is in test_torch_shaders_kitchen.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solstrale_tpu as J
import solstrale_tpu_torch as T
from solstrale_tpu.renderer import integrator as JI
from solstrale_tpu.scene.compile import compile_scene as jcompile
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch.renderer import integrator as TI
from solstrale_tpu_torch.scene.compile import compile_scene as tcompile

torch.set_num_threads(2)

W, H, SEED = 32, 24, 1
TOL = dict(rtol=1e-4, atol=1e-4)
SCENES = {
    "sponza24": lambda cfg, api: fixtures.sponza_class_scene(
        cfg, n_cells=24, api=api),
    "mixed16": lambda cfg, api: fixtures.mixed_bvh_scene(
        cfg, n_cells=16, api=api),
    "small": lambda cfg, api: fixtures.small_scene(cfg, api=api),
}
DEBUG = {"albedo": TI.SHADER_ALBEDO, "normal": TI.SHADER_NORMAL,
         "simple": TI.SHADER_SIMPLE}
_COMPILED = {}


def _compiled(name):
    """(JAX compiled scene, port compiled scene on the CPU), once per
    module."""
    if name not in _COMPILED:
        def cfg(api):
            return api.RenderConfig(width=W, height=H, samples_per_pixel=2,
                                    seed=SEED)

        _COMPILED[name] = (jcompile(SCENES[name](cfg(J), J)),
                           tcompile(SCENES[name](cfg(T), T), device="cpu"))
    return _COMPILED[name]


def _close_or_allowed(name, got, want):
    """rtol = atol = 1e-4; the textured mixed16 is allowed the measured-off
    values of test_torch_render.py's mixed-scene limit (at most 6 values and
    2 pixels, from last-bit t differences between the JAX CPU path's hit
    formulas and the port's that pick another texel). Measured here at
    32x24: none off."""
    got = got.numpy()
    if name != "mixed16":
        np.testing.assert_allclose(got, want, **TOL)
        return
    off = ~np.isclose(got, want, **TOL)
    assert off.sum() <= 6 and off.any(axis=-1).sum() <= 2, off.sum()
    assert np.isfinite(got).all()


@pytest.mark.parametrize("name", ["small", "sponza24"])
def test_camera_rays_match_jax(name):
    cj, ct = _compiled(name)
    pix = np.arange(W * H, dtype=np.int32)
    _, oj, dj = JI.camera_rays(cj, jnp.asarray(pix), W, H, jnp.int32(3),
                               jnp.int32(SEED))
    p, ot, dt = TI.camera_rays(ct, torch.from_numpy(pix).long(), W, H, 3,
                               SEED)
    assert torch.equal(p, torch.arange(W * H))
    for a, b in zip(ot + dt, oj + dj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("shader", list(DEBUG))
@pytest.mark.parametrize("name", list(SCENES))
def test_debug_shader_render_pixels_matches_jax(name, shader):
    """One pass of a debug shader over every pixel (JAX's render_pixels op
    by op), aux planes included."""
    cj, ct = _compiled(name)
    kw = dict(width=W, height=H, max_depth=50, shader_kind=DEBUG[shader],
              need_aux=True)
    want = JI.render_pixels(cj, jnp.arange(W * H, dtype=jnp.int32),
                            jnp.int32(2), jnp.int32(SEED), **kw)
    got = TI.render_pixels(ct, torch.arange(W * H), 2, SEED, **kw)
    assert got[0].shape == (W * H, 3) and float(got[0].abs().sum()) > 0
    for g, w in zip(got, want):
        _close_or_allowed(name, g, np.asarray(w))


@pytest.mark.parametrize("name", list(SCENES))
def test_render_sample_path_matches_jax(name):
    """The path shader through trace (early exit) with the aux planes:
    (pixel, albedo, normal) images in row order."""
    cj, ct = _compiled(name)
    kw = dict(width=W, height=H, max_depth=50, shader_kind=TI.SHADER_PATH,
              need_aux=True)
    want = JI.render_sample(cj, jnp.int32(1), jnp.int32(SEED), **kw)
    got = TI.render_sample(ct, 1, SEED, **kw)
    assert got[0].shape == (H, W, 3) and float(got[0].mean()) > 0.1
    for g, w in zip(got, want):
        _close_or_allowed(name, g, np.asarray(w))


@pytest.mark.parametrize("name", list(SCENES))
def test_trace_fixed_trip_equals_early_exit(name):
    """early_exit=False runs all max_depth + 1 steps and gives the early
    exit's image bit for bit."""
    _, ct = _compiled(name)
    kw = dict(width=W, height=H, max_depth=50, shader_kind=TI.SHADER_PATH,
              need_aux=False)
    pix = torch.arange(W * H)
    early = TI.render_pixels(ct, pix, 1, SEED, **kw)[0]
    fixed = TI.render_pixels(ct, pix, 1, SEED, early_exit=False, **kw)[0]
    assert torch.equal(early, fixed) and float(early.sum()) > 0


def test_trace_fixed_trip_matches_jax_scan():
    """The port's fixed-trip trace against JAX's scan (early_exit=False) at
    a cut depth, which also exercises the depth cap: a ray alive at the cap
    that hits is black, a miss takes the background."""
    cj, ct = _compiled("small")
    kw = dict(width=W, height=H, max_depth=4, shader_kind=TI.SHADER_PATH,
              need_aux=False, early_exit=False)
    want = JI.render_pixels(cj, jnp.arange(W * H, dtype=jnp.int32),
                            jnp.int32(1), jnp.int32(SEED), **kw)[0]
    got = TI.render_pixels(ct, torch.arange(W * H), 1, SEED, **kw)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name,shader", [("sponza24", TI.SHADER_PATH),
                                         ("small", TI.SHADER_PATH),
                                         ("small", TI.SHADER_SIMPLE)])
def test_render_sample_batch_aux_matches_jax(name, shader):
    """render_sample_batch(need_aux=True) over 2 samples: the aux planes
    (one first_hit_aux per sample, summed in order) and the color (the
    wavefront for the path shader, which K5's gate refuses with aux; one
    render_pixels per sample for a debug shader)."""
    cj, ct = _compiled(name)
    kw = dict(width=W, height=H, max_depth=50, shader_kind=shader,
              need_aux=True, n_samples=2)
    want = JI.render_sample_batch(cj, jnp.int32(1), jnp.int32(SEED), **kw)
    got = TI.render_sample_batch(ct, 1, SEED, **kw)
    for g, w in zip(got[:3], want[:3]):
        assert g.shape == (H, W, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert float(got[1].sum()) > 0 and float(got[2].abs().sum()) > 0
    if shader == TI.SHADER_PATH:
        np.testing.assert_allclose(int(got[3]), float(want[3]), rtol=1e-3)
    else:
        assert int(got[3]) == W * H * 2
