"""The render megakernel (K5) on the CPU: its plain version against the JAX
package's megakernel (Pallas, interpreted), against the JAX package's
``render_sample_batch`` on the normal-mapped kitchen (which JAX's gate
keeps off its megakernel) and against the port's own work-queue
wavefront; the port's gate against the JAX gate; and the aux route.

Tolerances are the JAX package's own (tests/test_megakernel.py): 2e-3 and
equal segments against its megakernel, under 0.5% of values off for the
image-textured sphere, whose JAX kernel computes spherical uv with Cephes
polynomials where the port calls acos/atan2 (a nearest-texel flip at a
texel edge); 1e-4 and equal segments against JAX's wavefront with its
Pallas kernels interpreted (tests/test_torch_render.py's). Against
``trace_queued`` the draws and the summation order are the same, so the
limit is 1e-5 with equal segments."""
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
from solstrale_tpu_torch.ops import sweep as TS
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
    # the kitchen-sink scene with its normal map on the ground
    "kitchen": (lambda c, api: fixtures.kitchen_sink_scene(c, api=api),
                16, 12, 3, 8),
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


def test_plain_matches_jax_render_sample_batch_kitchen(monkeypatch):
    """The normal-mapped kitchen: the plain K5 against the JAX package's
    ``render_sample_batch``, which takes its wavefront (its gate refuses
    normal maps). SOLSTRALE_PALLAS=1 is the JAX package's own switch (read
    at trace time): its CPU run then takes its Pallas kernels, interpreted,
    so both sides intersect with the same formulas."""
    monkeypatch.setenv("SOLSTRALE_PALLAS", "1")
    cj, ct, kw, spp = _both("kitchen")
    assert "normal_maps" in ct.features
    assert TM.megakernel_supported(ct, need_aux=False, shader_kind=0)
    assert not JM.megakernel_supported(cj, need_aux=False, shader_kind=0)
    want = JI.render_sample_batch(cj, jnp.int32(1), jnp.int32(SEED),
                                  shader_kind=0, need_aux=False,
                                  n_samples=spp, **kw)
    got, seg_t = TM.render_batch_megakernel_plain(ct, 1, spp, SEED, **kw)
    img = TI.to_image(got, kw["width"], kw["height"]).numpy()
    assert float(img.sum()) > 0
    np.testing.assert_allclose(img, np.asarray(want[0]), rtol=1e-4,
                               atol=1e-4)
    assert int(seg_t) == int(want[3])


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
    """The port's gate takes every scene and flag set the JAX gate takes,
    and more: the JAX gate's table limits, its refusal of normal maps and
    of the aux planes were the TPU kernel's (its SMEM tables, its code).
    So the port's takes every path-shader render of a scene without a BVH,
    with or without the aux planes (the normal-mapped kitchen too), and
    refuses the debug shaders and the BVH scenes."""
    build = GATE_SCENES[name]
    cj = jcompile(build(J.RenderConfig(width=8, height=8), J))
    ct = tcompile(build(T.RenderConfig(width=8, height=8), T), device="cpu")
    bvh = name in ("sponza24", "mixed16")
    assert (ct.bvh is not None) == bvh
    for kw, expect in ((dict(need_aux=False, shader_kind=0), not bvh),
                       (dict(need_aux=True, shader_kind=0), not bvh),
                       (dict(need_aux=False, shader_kind=1), False),
                       (dict(need_aux=True, shader_kind=3), False)):
        got = TM.megakernel_supported(ct, **kw)
        assert got == expect, kw
        assert got or not JM.megakernel_supported(cj, **kw), kw


def _corners(s):
    """(N, 3) f64 numpy: every vertex of a Solids' valid quads and
    triangles, and each valid sphere's box corners."""
    n = lambda x: x.double().numpy()   # noqa: E731
    q, u, v = (n(x[s.qd_valid]) for x in (s.qd_q, s.qd_u, s.qd_v))
    v0, e1, e2 = (n(x[s.tr_valid]) for x in (s.tr_v0, s.tr_e1, s.tr_e2))
    c = n(s.sph_center[s.sph_valid])
    r = n(s.sph_radius[s.sph_valid])[:, None]
    return np.concatenate([q, q + u, q + v, q + u + v, v0, v0 + e1, v0 + e2,
                           c - r, c + r])


@pytest.mark.parametrize("name", list(CASES))
def test_medium_boxes_contain_boundaries(name):
    """K4's and K5's cull table (one copy, ``MediaTables.box``): each
    medium's box holds every vertex of its boundary prims and every boundary
    sphere with MEDIUM_BOX_PAD of the scene's largest coordinate to spare on
    every side, and no more than twice that."""
    _, ct, _, _ = _both(name)
    assert TM.pack_tables(ct).media is TI.media_tables(ct)
    box = TI.media_tables(ct).box.double().numpy()
    assert box.shape == (len(ct.media), 8)
    cam = ct.camera
    scale = max([1.0, float(cam.origin.abs().max() + cam.lens_radius)]
                + [float(np.abs(_corners(s)).max())
                   for s in [ct.solids] + [m.boundary for m in ct.media]])
    pad = TS.MEDIUM_BOX_PAD * scale
    for m, med in enumerate(ct.media):
        pts = _corners(med.boundary)
        lo, hi = box[m, 0:3], box[m, 4:7]
        assert (lo <= pts.min(0) - pad * (1 - 1e-6)).all()
        assert (hi >= pts.max(0) + pad * (1 - 1e-6)).all()
        assert (lo >= pts.min(0) - 2 * pad).all()
        assert (hi <= pts.max(0) + 2 * pad).all()


def _grazing_rays(lo, hi, n, rng):
    """Rays along the faces, edges and corners of box [lo, hi] (f64): from
    points on a face plane, offset by 0 to 1e-5 along its normal, in
    directions tilted from the plane by at most 1e-6; and from random points
    around the box at its edges and corners. (o, d) (n*2, 3) f32."""
    size = hi - lo
    axis = rng.integers(0, 3, n)
    side = rng.integers(0, 2, n)
    o = lo + rng.uniform(-0.5, 1.5, (n, 3)) * size
    o[np.arange(n), axis] = np.where(side, hi[axis], lo[axis]) + rng.choice(
        [0.0, 1e-7, -1e-7, 1e-6, -1e-6, 1e-5, -1e-5], n)
    d = rng.normal(size=(n, 3))
    d[np.arange(n), axis] = rng.choice([0.0, 1e-6, -1e-6, 1e-7], n)
    # towards a point on an edge or a corner of the box
    target = lo + rng.uniform(0, 1, (n, 3)) * size
    for k in range(3):
        snap = rng.uniform(size=n) < 0.7
        target[snap, k] = np.where(rng.integers(0, 2, n), hi[k], lo[k])[snap]
    o2 = target + rng.normal(size=(n, 3)) * size.max() * 2
    d2 = target - o2
    return (np.concatenate([o, o2]).astype(np.float32),
            np.concatenate([d, d2]).astype(np.float32))


@pytest.mark.parametrize("name", ["kitchen_solid", "kitchen_textured",
                                  "small", "kitchen"])
def test_medium_box_cull_is_conservative(name):
    """K4 and K5 skip a medium's sweeps for a ray whose line cannot meet the
    medium's padded box (``MediaTables.box``) in [0, ts]. That must never
    skip a ray whose event the sweeps would find: with u = 1 every ordered
    entry and exit is an event, and every such ray must pass the box test.
    Scenes: the K5 route's, and the normal-mapped kitchen of the K4 route.
    Rays: the camera's, random ones through the scene, and rays that graze
    the box's faces, edges and corners from outside, on and inside its
    faces."""
    from solstrale_tpu_torch.geo import INF, RAY_T_MIN
    from solstrale_tpu_torch.ops import sweep

    build = GATE_SCENES[name]
    ct = tcompile(build(T.RenderConfig(width=64, height=48), T),
                  use_bvh=False, device="cpu")
    box = TI.media_tables(ct).box
    rng = np.random.default_rng(11)
    pix = torch.arange(64 * 48)
    cam_o, cam_d = TI.camera_rays_plain(ct, pix, 1, SEED, 64, 48)
    med = ct.media[0]
    b = med.boundary
    pts = _corners(b)
    lo, hi = pts.min(0), pts.max(0)
    # along the boundary itself, and along the padded box's faces
    go, gd = (np.concatenate(x) for x in zip(
        _grazing_rays(lo, hi, 4096, rng),
        _grazing_rays(box[0, 0:3].double().numpy(),
                      box[0, 4:7].double().numpy(), 4096, rng)))
    ro = rng.uniform(lo - 3 * (hi - lo), hi + 3 * (hi - lo), (4096, 3))
    rd = rng.normal(size=(4096, 3))
    o = [torch.cat([cam_o[k], torch.from_numpy(go[:, k]),
                    torch.from_numpy(ro[:, k].astype(np.float32))])
         for k in range(3)]
    d = [torch.cat([cam_d[k], torch.from_numpy(gd[:, k]),
                    torch.from_numpy(rd[:, k].astype(np.float32))])
         for k in range(3)]
    s = ct.solids
    ts, _ = sweep.closest_hit_plain(s.sph_table, s.pl_table, o, d,
                                    RAY_T_MIN, INF)
    event = sweep.medium_hit_plain(b.sph_table, b.pl_table,
                                   med.neg_inv_density, o, d, ts,
                                   torch.ones_like(ts))
    reach = sweep.box_reach_plain(o, d, box[0], ts)
    hit = torch.isfinite(event)
    assert hit.sum() > 500 and hit[64 * 48:64 * 48 + 16384].sum() > 200
    assert not (hit & ~reach).any(), int((hit & ~reach).sum())
    assert (~reach).float().mean() > 0.3   # the cull skips most rays


def test_render_sample_batch_aux_on_k5(monkeypatch):
    """``render_sample_batch`` with the aux planes on a scene K5's gate
    takes (the normal-mapped kitchen): the color is K5's (its plain
    version here; ``trace_queued`` is not called), equal to
    ``trace_queued``'s with equal segments, and the albedo and normal
    planes are the first-hit pass's, equal to the JAX package's (its
    Pallas kernels interpreted, as above)."""
    monkeypatch.setenv("SOLSTRALE_PALLAS", "1")
    cj, ct, kw, spp = _both("kitchen")
    want_color, want_segs = TI.trace_queued(ct, 1, spp, SEED, **kw)
    calls = []
    plain = TM.render_batch_megakernel_plain

    def counted(*args, **kwargs):
        calls.append("K5")
        return plain(*args, **kwargs)

    def refused(*args, **kwargs):
        raise AssertionError("trace_queued on a K5 scene")

    monkeypatch.setattr(TM, "render_batch_megakernel_plain", counted)
    monkeypatch.setattr(TI, "trace_queued", refused)
    got = TI.render_sample_batch(ct, 1, SEED, shader_kind=0, need_aux=True,
                                 n_samples=spp, **kw)
    assert calls == ["K5"]
    w, h = kw["width"], kw["height"]
    np.testing.assert_allclose(
        got[0].numpy(), TI.to_image(want_color, w, h).numpy(), rtol=1e-5,
        atol=1e-5)
    assert int(got[3]) == int(want_segs)
    want = JI.render_sample_batch(cj, jnp.int32(1), jnp.int32(SEED),
                                  shader_kind=0, need_aux=True,
                                  n_samples=spp, **kw)
    for g, j in zip(got[1:3], want[1:3]):
        assert float(g.abs().sum()) > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)


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
