"""Gradients on the card: the inverse-rendering step's loss and arena
gradient against the CPU's, repeats, and the hit kernels' zero geometry
gradient. Marked ``cuda``: they skip where no GPU is present. On a GPU
machine (no JAX needed), from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_diff_cuda.py -q
"""
import pytest
import torch

import solstrale_tpu_torch as T
from solstrale_tpu_torch import diff, fixtures
from solstrale_tpu_torch.ops import bvh, sweep
from solstrale_tpu_torch.renderer import integrator
from solstrale_tpu_torch.scene.compile import compile_scene

pytestmark = pytest.mark.cuda

W, H, DEPTH = 64, 32, 8
SCENES = {
    "mixed": lambda c: fixtures.mixed_bvh_scene(c, n_cells=32),
    "kitchen": fixtures.kitchen_sink_scene,
}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _step(cs, target):
    return diff.image_and_texture_grad(cs, target.to(cs.device), width=W,
                                       height=H, max_depth=DEPTH,
                                       n_samples=1, seed=1)


@pytest.mark.parametrize("name", list(SCENES))
def test_card_grad_matches_cpu(cuda, name):
    """Loss and arena gradient against a target rendered at seed 2: the
    card's equal the CPU's (rtol 1e-3, atol 1e-4), are finite, and a
    repeat agrees to rtol 1e-5 (the arena's index backward accumulates
    with atomics on the card)."""
    scene = SCENES[name](T.RenderConfig(width=W, height=H, seed=1))
    gpu, cpu = (compile_scene(scene, device=d) for d in ("cuda", "cpu"))
    with torch.no_grad():
        target = diff.render_linear(cpu, width=W, height=H, max_depth=DEPTH,
                                    n_samples=1, seed=2)
    loss_g, g_g = _step(gpu, target)
    loss_r, g_r = _step(gpu, target)
    loss_c, g_c = _step(cpu, target)
    assert torch.isfinite(g_g).all() and (g_g != 0).any()
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(g_g.cpu(), g_c, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(loss_r, loss_g, rtol=1e-5, atol=0)
    torch.testing.assert_close(g_r, g_g, rtol=1e-5, atol=1e-7)


def test_kernels_detached_on_card(cuda):
    """K1+K2, K3 and K4 with the directions requiring grad: the same
    outputs as without grad and a zero gradient to the geometry."""
    mixed = compile_scene(SCENES["mixed"](T.RenderConfig(
        width=W, height=H, seed=1)), device="cuda")
    kitchen = compile_scene(SCENES["kitchen"](T.RenderConfig(
        width=W, height=H, seed=1)), device="cuda")
    pix = torch.arange(W * H, dtype=torch.int64, device=cuda)
    zero = torch.zeros_like(pix)
    one = torch.ones_like(pix)
    for cs in (mixed, kitchen):
        o, d = integrator.camera_rays_plain(cs, pix, 1, 1, W, H)
        d_g = tuple(c.detach().clone().requires_grad_(True) for c in d)
        for dirs in (d, d_g):
            if cs.kbvh is not None:
                t, kind, idx = bvh.bvh_closest_hit(cs.kbvh, cs.solids, o,
                                                   dirs, 1e-3, float("inf"))
                out = sweep.media_hit(integrator.media_tables(cs), o, dirs,
                                      t, kind, idx, pix, one, zero, 1)
            else:
                out = sweep.scene_hit(cs.solids, integrator.media_tables(cs),
                                      o, dirs, pix, one, zero, 1)
            if dirs is d:
                want = out
        for a, b in zip(out, want):
            assert torch.equal(a, b)
        hit = torch.isfinite(out[0])
        grads = torch.autograd.grad(out[0][hit].sum(), d_g,
                                    allow_unused=True,
                                    materialize_grads=True)
        assert all(not g.any() for g in grads)
