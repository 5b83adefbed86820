"""The port's ``diff`` surface against the JAX package on the CPU:
render_linear over two samples and its arena gradient, the background
gradient, and image_and_texture_grad's loss and gradient, on the small
scene (sphere light, Lambertian sphere, a medium) and the textured
kitchen.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solstrale_tpu as J
import solstrale_tpu_torch as T
from solstrale_tpu import diff as JD
from solstrale_tpu.scene.compile import compile_scene as jcompile
from solstrale_tpu_torch import diff as TD
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch.scene.compile import compile_scene as tcompile

torch.set_num_threads(2)

W, H, DEPTH, SEED = 16, 8, 4, 1
KW = dict(width=W, height=H, max_depth=DEPTH)


def _compile(api, scene=fixtures.small_scene):
    cfg = api.RenderConfig(width=W, height=H, samples_per_pixel=2, seed=SEED)
    return jcompile(scene(cfg, api=api)) if api is J else \
        tcompile(scene(cfg, api=api), device="cpu")


def test_render_linear_two_samples_and_grad_match_jax():
    """The mean of samples 1 and 2 and the arena gradient of its sum."""
    cj, ct = _compile(J), _compile(T)

    def f(p):
        img = JD.render_linear(JD.set_texture_params(cj, p), n_samples=2,
                               seed=SEED, **KW)
        return jnp.sum(img), img

    (_, img_j), g_j = jax.jit(jax.value_and_grad(f, has_aux=True))(
        cj.textures.pixels)
    p = ct.textures.pixels.detach().clone().requires_grad_(True)
    img = TD.render_linear(TD.set_texture_params(ct, p), n_samples=2,
                           seed=SEED, **KW)
    g, = torch.autograd.grad(img.sum(), p)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(img_j),
                               rtol=1e-4, atol=1e-4)
    assert torch.isfinite(g).all() and (g != 0).any()
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-3,
                               atol=1e-4)


def test_background_gradient_matches_jax():
    """The gradient with respect to the background color flows through
    misses: positive, and JAX's."""
    cj, ct = _compile(J), _compile(T)

    def f(bg):
        return jnp.sum(JD.render_linear(dataclasses.replace(cj, bg_color=bg),
                                        n_samples=1, seed=SEED, **KW))

    g_j = np.asarray(jax.jit(jax.grad(f))(cj.bg_color))
    bg = ct.bg_color.detach().clone().requires_grad_(True)
    img = TD.render_linear(dataclasses.replace(ct, bg_color=bg), n_samples=1,
                           seed=SEED, **KW)
    g, = torch.autograd.grad(img.sum(), bg)
    assert (g > 0).all()
    np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("scene", ["small", "kitchen"])
def test_image_and_texture_grad_matches_jax(scene):
    """The L2 loss against a target rendered at seed 2 and its arena
    gradient, against the JAX package's jitted image_and_texture_grad (on
    the kitchen, on the entries where JAX's gradient is finite; the port's
    is finite everywhere)."""
    make = {"small": fixtures.small_scene,
            "kitchen": fixtures.kitchen_sink_scene}[scene]
    cj, ct = _compile(J, make), _compile(T, make)
    with torch.no_grad():
        target = TD.render_linear(ct, n_samples=1, seed=2, **KW)
    loss_j, g_j = JD.image_and_texture_grad(
        cj, jnp.asarray(target.numpy()), n_samples=1, seed=SEED, **KW)
    loss, g = TD.image_and_texture_grad(ct, target, n_samples=1, seed=SEED,
                                        **KW)
    assert not loss.requires_grad and not g.requires_grad
    assert float(loss) > 0 and torch.isfinite(g).all() and (g != 0).any()
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    g_j = np.asarray(g_j)
    ok = np.isfinite(g_j)
    assert ok.mean() > 0.99
    np.testing.assert_allclose(g.numpy()[ok], g_j[ok], rtol=1e-3, atol=1e-4)
