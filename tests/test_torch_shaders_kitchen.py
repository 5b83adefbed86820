"""The debug shaders, aux channels and trace on the normal-mapped
kitchen-sink scene (the port's K4 route), against the JAX package with its
own switch SOLSTRALE_PALLAS=1 (read at trace time): its CPU run then takes
its Pallas kernels, interpreted, so both sides intersect with the same
formulas (as test_torch_render.py's kitchen test does).
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
_COMPILED = {}


@pytest.fixture
def kitchen(monkeypatch):
    """(JAX compiled scene, port compiled scene on the CPU), compiled once;
    the JAX side's Pallas switch set for the test."""
    monkeypatch.setenv("SOLSTRALE_PALLAS", "1")
    if not _COMPILED:
        def cfg(api):
            return api.RenderConfig(width=W, height=H, samples_per_pixel=2,
                                    seed=SEED)

        _COMPILED["kitchen"] = (
            jcompile(fixtures.kitchen_sink_scene(cfg(J), api=J)),
            tcompile(fixtures.kitchen_sink_scene(cfg(T), api=T),
                     device="cpu"))
    return _COMPILED["kitchen"]


@pytest.mark.parametrize("shader", [TI.SHADER_PATH, TI.SHADER_ALBEDO,
                                    TI.SHADER_NORMAL, TI.SHADER_SIMPLE])
def test_render_pixels_matches_jax_kitchen(kitchen, shader):
    """One pass of each shader over every pixel with the aux planes (JAX's
    render_pixels op by op)."""
    cj, ct = kitchen
    kw = dict(width=W, height=H, max_depth=50, shader_kind=shader,
              need_aux=True)
    want = JI.render_pixels(cj, jnp.arange(W * H, dtype=jnp.int32),
                            jnp.int32(1), jnp.int32(SEED), **kw)
    got = TI.render_pixels(ct, torch.arange(W * H), 1, SEED, **kw)
    assert float(got[0].sum()) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_fixed_trip_matches_jax_and_early_exit_kitchen(kitchen):
    """early_exit=False: JAX's scan against the port's fixed trip, which
    equals the port's early exit bit for bit."""
    cj, ct = kitchen
    kw = dict(width=W, height=H, max_depth=50, shader_kind=TI.SHADER_PATH,
              need_aux=False)
    want = JI.render_pixels(cj, jnp.arange(W * H, dtype=jnp.int32),
                            jnp.int32(1), jnp.int32(SEED), early_exit=False,
                            **kw)[0]
    pix = torch.arange(W * H)
    fixed = TI.render_pixels(ct, pix, 1, SEED, early_exit=False, **kw)[0]
    early = TI.render_pixels(ct, pix, 1, SEED, **kw)[0]
    np.testing.assert_allclose(fixed.numpy(), np.asarray(want), **TOL)
    assert torch.equal(fixed, early)
