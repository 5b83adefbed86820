"""The renderer's surface beyond the path shader on the card: the debug
shaders and the aux channels against the CPU render, trace's two modes,
and bloom and the denoiser on the card's tensors. Marked ``cuda``: they
skip where no GPU is present. On a GPU machine (no JAX needed), from the
repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_surface_cuda.py -q
"""
import numpy as np
import pytest
import torch

import solstrale_tpu_torch as T
from solstrale_tpu_torch import fixtures, post
from solstrale_tpu_torch.renderer import integrator, megakernel
from solstrale_tpu_torch.scene.compile import compile_scene

pytestmark = pytest.mark.cuda

W, H = 48, 32
SCENES = {
    "mixed": lambda c: fixtures.mixed_bvh_scene(c, n_cells=32),
    "kitchen": fixtures.kitchen_sink_scene,
    "kitchen_solid": fixtures.kitchen_sink_solid_scene,
}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _both(name):
    scene = SCENES[name](T.RenderConfig(width=W, height=H, seed=1))
    return compile_scene(scene, device="cuda"), compile_scene(scene,
                                                              device="cpu")


@pytest.mark.parametrize("shader,aux", [(integrator.SHADER_PATH, True),
                                        (integrator.SHADER_ALBEDO, False),
                                        (integrator.SHADER_NORMAL, False),
                                        (integrator.SHADER_SIMPLE, True)])
@pytest.mark.parametrize("name", list(SCENES))
def test_debug_shaders_and_aux_match_cpu(cuda, name, shader, aux):
    """render_sample_batch on the card against the CPU: every plane within
    1e-3 on 99.9% of pixels, a repeat bit for bit, and K5 launched once a
    batch for the path color of a scene without a BVH, never for a debug
    shader or a BVH scene (its gate refuses them). The path color of the
    textured
    mixed scene is held to test_card_render_matches_cpu_and_repeats's 99.5%
    at this size: last-bit differences between the card's and the CPU's
    elementwise math pick another texel on a few paths."""
    gpu_cs, cpu_cs = _both(name)
    kw = dict(width=W, height=H, max_depth=50, shader_kind=shader,
              need_aux=aux, n_samples=2)
    megakernel.render_batch_megakernel.launches = 0
    gpu = integrator.render_sample_batch(gpu_cs, 1, 1, **kw)
    again = integrator.render_sample_batch(gpu_cs, 1, 1, **kw)
    cpu = integrator.render_sample_batch(cpu_cs, 1, 1, **kw)
    k5 = shader == integrator.SHADER_PATH and gpu_cs.bvh is None
    assert megakernel.render_batch_megakernel.launches == (2 if k5 else 0)
    for plane, (g, a, c) in enumerate(zip(gpu[:3], again[:3], cpu[:3])):
        assert torch.equal(g, a)
        close = torch.isclose(g.cpu(), c, rtol=1e-3, atol=1e-3).all(-1)
        path_color = plane == 0 and shader == integrator.SHADER_PATH
        assert close.float().mean() >= (0.995 if path_color else 0.999)
    assert abs(int(gpu[3]) - int(cpu[3])) <= 1e-3 * int(cpu[3])


def test_trace_modes_equal_on_card(cuda):
    cs, _ = _both("mixed")
    pix = torch.arange(W * H, device=cuda)
    kw = dict(width=W, height=H, max_depth=50,
              shader_kind=integrator.SHADER_PATH, need_aux=False)
    early = integrator.render_pixels(cs, pix, 1, 1, **kw)[0]
    fixed = integrator.render_pixels(cs, pix, 1, 1, early_exit=False, **kw)[0]
    assert torch.equal(early, fixed) and float(early.sum()) > 0


def test_bloom_and_denoiser_on_card_match_cpu(cuda):
    """Bloom keeps the sums on the card and equals the CPU's within 1e-5;
    the denoiser's u8 image equals the CPU's on 99.9% of pixels, never
    more than 1 apart."""
    g = torch.Generator().manual_seed(3)
    sums = [torch.rand((H, W, 3), generator=g) * 4 for _ in range(2)]
    sums.append(torch.randn((H, W, 3), generator=g))
    bloom = post.BloomPostProcessor(0.2)
    got = bloom.intermediate_post_process(sums[0].cuda(), None, None, W, H,
                                          2)
    assert got.device.type == "cuda"
    want = bloom.intermediate_post_process(sums[0], None, None, W, H, 2)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    proc = post.DenoiserPostProcessor()
    u8_card = proc.post_process(*(x.cuda() for x in sums), W, H, 2)
    u8_cpu = proc.post_process(*sums, W, H, 2)
    diff = np.abs(u8_card.astype(np.int16) - u8_cpu.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).all(-1).mean() >= 0.999
