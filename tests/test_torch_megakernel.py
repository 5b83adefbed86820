"""The render megakernel (K5) on the CPU: its plain version against the JAX
package's megakernel (Pallas, interpreted) and against the port's own
work-queue wavefront, and the port's gate against the JAX gate.

Tolerances are the JAX package's own (tests/test_megakernel.py): 2e-3 and
equal segments against its megakernel, under 0.5% of values off for the
image-textured sphere, whose JAX kernel computes spherical uv with Cephes
polynomials where the port calls acos/atan2 (a nearest-texel flip at a
texel edge). Against ``trace_queued`` the draws and the summation order are
the same, so the limit is 1e-5 with equal segments."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solstrale_tpu as J
import solstrale_tpu_torch as T
from solstrale_tpu.renderer import integrator as JI
from solstrale_tpu.renderer import megakernel as JM
from solstrale_tpu.scene.compile import compile_scene as jcompile
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch.renderer import integrator as TI
from solstrale_tpu_torch.renderer import megakernel as TM
from solstrale_tpu_torch.scene.compile import compile_scene as tcompile

torch.set_num_threads(2)


def _simple(cfg, api):
    """tests/scenes.py::create_simple_test_scene: one sphere and a sphere
    light."""
    camera = api.CameraConfig(vertical_fov_degrees=20.0, aperture_size=0.1,
                              look_from=(0.0, 0.0, 4.0),
                              look_at=(0.0, 0.0, 0.0))
    world = [api.Sphere((0, 100, 0), 20.0, api.DiffuseLight(10.0, 10.0, 10.0)),
             api.Sphere((0, 0, 0), 0.5,
                        api.Lambertian(api.SolidColor(1.0, 1.0, 0.0)))]
    return api.Scene(api.Bvh(world), camera, (0.2, 0.3, 0.5), cfg)


def _image(cfg, api, textured_sphere=False):
    """tests/test_megakernel.py's image-texture scenes: an image-textured
    quad and triangle (identity and interpolated uv) beside a solid sphere,
    or (``textured_sphere``) an image-textured sphere on a solid floor."""
    if textured_sphere:
        img = np.random.default_rng(5).integers(0, 256, (8, 8, 3), np.uint8)
        camera = api.CameraConfig(vertical_fov_degrees=30.0,
                                  look_from=(0.0, 0.8, 4.0),
                                  look_at=(0, 0.5, 0))
        world = [
            api.Sphere((0.0, 0.6, 0.0), 0.9, api.Lambertian(api.ImageMap(img))),
            api.Quad((-4, -0.4, -4), (8, 0, 0), (0, 0, 8),
                     api.Lambertian(api.SolidColor(0.5, 0.5, 0.5))),
            api.Sphere((0, 40, 10), 12.0, api.DiffuseLight(10, 10, 10)),
        ]
        return api.Scene(api.Bvh(world), camera, (0.1, 0.1, 0.2), cfg)
    img = np.random.default_rng(12).integers(0, 256, (8, 8, 3), np.uint8)
    camera = api.CameraConfig(vertical_fov_degrees=35.0,
                              look_from=(0.0, 1.5, 4.0), look_at=(0, 0.5, 0))
    world = [
        api.Quad((-3, 0, -3), (6, 0, 0), (0, 0, 6),
                 api.Lambertian(api.ImageMap(img))),
        api.Sphere((0.8, 0.8, 0.0), 0.6,
                   api.Lambertian(api.SolidColor(0.4, 0.7, 0.9))),
        api.Triangle((-1.5, 0.0, 1.0), (-0.3, 0.0, 1.0), (-0.9, 1.4, 1.0),
                     api.Lambertian(api.ImageMap(img)),
                     uv0=(0.1, 0.1), uv1=(0.9, 0.1), uv2=(0.5, 0.9)),
        api.Sphere((0, 40, 10), 12.0, api.DiffuseLight(10, 10, 10)),
    ]
    return api.Scene(api.Bvh(world), camera, (0.1, 0.1, 0.2), cfg)


# name -> (scene function, width, height, spp, max_depth): the sizes of
# tests/test_megakernel.py:60-67, 84-112, 144-175
CASES = {
    "simple": (_simple, 24, 16, 4, 8),
    "kitchen_solid": (lambda c, api: fixtures.kitchen_sink_solid_scene(
        c, api=api), 16, 12, 3, 8),
    "image": (_image, 40, 24, 2, 6),
    "image_sphere": (lambda c, api: _image(c, api, textured_sphere=True),
                     40, 24, 2, 8),
    # the kitchen-sink scene without its normal map: an image texture on the
    # ground, triangle prims, sphere / quad / triangle lights
    "kitchen_textured": (lambda c, api: fixtures.kitchen_sink_scene(
        c, api=api, normal_map=False), 16, 12, 3, 8),
}
SEED = 3


def _both(name):
    build, w, h, spp, depth = CASES[name]
    cj = jcompile(build(J.RenderConfig(width=w, height=h), J), use_bvh=False)
    ct = tcompile(build(T.RenderConfig(width=w, height=h), T), use_bvh=False,
                  device="cpu")
    return cj, ct, dict(width=w, height=h, max_depth=depth), spp


def _jax_megakernel(cj, spp, kw):
    got, segs = JM.render_batch_megakernel(
        cj, jnp.int32(1), jnp.int32(spp), jnp.int32(SEED), interpret=True,
        **kw)
    return np.asarray(got), float(segs)


@pytest.mark.parametrize("name", ["simple", "kitchen_solid", "image",
                                  "kitchen_textured"])
def test_plain_matches_jax_megakernel(name):
    cj, ct, kw, spp = _both(name)
    assert TM.megakernel_supported(ct, need_aux=False, shader_kind=0)
    want, seg_j = _jax_megakernel(cj, spp, kw)
    got, seg_t = TM.render_batch_megakernel_plain(ct, 1, spp, SEED, **kw)
    assert got.shape == want.shape and float(got.sum()) > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    assert int(seg_t) == int(seg_j)


def test_plain_matches_jax_megakernel_image_textured_sphere():
    """Measured at this size: 3,855 segments in the port against 3,854 in
    the JAX megakernel, with every value within 2.1e-5 of JAX's. The one
    path apart is pixel 225's sample 1: its bounce off the underside of the
    sphere reaches the floor quad 2e-5 inside the quad's edge z = 4. JAX's
    compiled code (its megakernel, and ``bounce_step`` under ``jax.jit``)
    puts that bounce's origin a few ulps away, and the ray misses the quad;
    the same JAX ``bounce_step`` run op by op hits it, as the port does
    (``test_plain_matches_jax_op_by_op_image_textured_sphere``). So the
    limit is the measured count, one segment."""
    cj, ct, kw, spp = _both("image_sphere")
    assert "sphere_image_tex" in ct.features
    want, seg_j = _jax_megakernel(cj, spp, kw)
    got, seg_t = TM.render_batch_megakernel_plain(ct, 1, spp, SEED, **kw)
    assert abs(int(seg_t) - int(seg_j)) <= 1
    got = got.numpy()
    mismatch = (np.abs(got - want) > 2e-3 * (np.abs(want) + 1.0)).mean()
    assert mismatch < 0.005, mismatch


def _jax_segments_op_by_op(cj, spp, width, height, max_depth):
    """(spp, pixels) segments of JAX's ``bounce_step`` called outside
    ``jax.jit`` (each operation dispatched on its own, as the port's plain
    version runs them), the depth cap's final hit included."""
    n = width * height
    pix = jnp.arange(n, dtype=jnp.int32)
    segs = np.zeros((spp, n), np.int64)
    for i, sample in enumerate(range(1, 1 + spp)):
        _, o, d = JI.camera_rays(cj, pix, width, height, jnp.int32(sample),
                                 jnp.int32(SEED))
        zero = o[0] * 0.0
        carry = (o, d, zero == zero, zero, (zero, zero, zero), zero, zero,
                 JI.fold_init(zero))
        for bounce in range(max_depth):
            segs[i] += np.asarray(carry[2])
            carry = JI.bounce_step(cj, carry, jnp.int32(bounce), pix,
                                   jnp.int32(sample), jnp.int32(SEED))
        segs[i] += np.asarray(carry[2])
    return segs


def test_plain_matches_jax_op_by_op_image_textured_sphere():
    """The witness for the one-segment gap above: run op by op, JAX's own
    bounce step traces exactly the port's segments (3,855), pixel 225's
    floor hit included."""
    cj, ct, kw, spp = _both("image_sphere")
    segs = _jax_segments_op_by_op(cj, spp, **kw)
    _, seg_t = TM.render_batch_megakernel_plain(ct, 1, spp, SEED, **kw)
    assert int(segs.sum()) == int(seg_t) == 3855
    assert segs[0, 225] == 3   # the camera ray, the sphere, the floor


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_trace_queued(name):
    _, ct, kw, spp = _both(name)
    want, seg_q = TI.trace_queued(ct, 1, spp, SEED, **kw)
    got, seg_t = TM.render_batch_megakernel_plain(ct, 1, spp, SEED, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert int(seg_t) == int(seg_q)


GATE_SCENES = {
    "small": lambda c, api: fixtures.small_scene(c, api=api),
    "kitchen_solid": lambda c, api: fixtures.kitchen_sink_solid_scene(
        c, api=api),
    "kitchen": lambda c, api: fixtures.kitchen_sink_scene(c, api=api),
    "sponza24": lambda c, api: fixtures.sponza_class_scene(c, n_cells=24,
                                                           api=api),
    "mixed16": lambda c, api: fixtures.mixed_bvh_scene(c, n_cells=16,
                                                       api=api),
    "simple": _simple,
    "image": _image,
    "image_sphere": CASES["image_sphere"][0],
    "kitchen_textured": CASES["kitchen_textured"][0],
}


@pytest.mark.parametrize("name", list(GATE_SCENES))
def test_gate_matches_jax(name):
    build = GATE_SCENES[name]
    cj = jcompile(build(J.RenderConfig(width=8, height=8), J))
    ct = tcompile(build(T.RenderConfig(width=8, height=8), T), device="cpu")
    for kw in (dict(need_aux=False, shader_kind=0),
               dict(need_aux=True, shader_kind=0),
               dict(need_aux=False, shader_kind=1)):
        assert TM.megakernel_supported(ct, **kw) == \
            JM.megakernel_supported(cj, **kw), kw
    expect = name not in ("kitchen", "sponza24", "mixed16")
    assert TM.megakernel_supported(ct, need_aux=False, shader_kind=0) == expect


def test_wrapper_routes_cpu_scene_to_plain():
    """On a CPU scene the K5 wrapper is the plain version and launches no
    kernel; render_sample_batch takes it for a scene the gate accepts."""
    _, ct, kw, spp = _both("kitchen_solid")
    TM.render_batch_megakernel.launches = 0
    got, seg = TM.render_batch_megakernel(ct, 1, spp, SEED, **kw)
    want, seg_p = TM.render_batch_megakernel_plain(ct, 1, spp, SEED, **kw)
    assert torch.equal(got, want) and int(seg) == int(seg_p)
    img, _, _, seg_b = TI.render_sample_batch(
        ct, 1, SEED, shader_kind=0, need_aux=False, n_samples=spp, **kw)
    w, h = kw["width"], kw["height"]
    assert torch.equal(img, torch.flip(want.reshape(h, w, 3), dims=(0,)))
    assert int(seg_b) == int(seg_p)
    assert TM.render_batch_megakernel.launches == 0
