"""The CUDA kernels against their plain PyTorch versions on the card, and
the port's card render against its CPU render. Marked ``cuda``: they skip
where no GPU is present. On a GPU machine (no JAX needed), from the repo
root:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q
"""
import numpy as np
import pytest
import torch

import solstrale_tpu_torch as T
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch.geo import INF, RAY_T_MIN
from solstrale_tpu_torch.ops import bvh, sweep
from solstrale_tpu_torch.profiling import device_kernels
from solstrale_tpu_torch.renderer import integrator, megakernel
from solstrale_tpu_torch.scene.compile import compile_scene

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rays(n, seed, device, parked=128, lo=-11.0, hi=11.0):
    g = torch.Generator().manual_seed(seed)
    o = torch.rand((n, 3), generator=g) * (hi - lo) + lo
    d = torch.randn((n, 3), generator=g)
    d[:parked] = 0.0
    o, d = o.to(device), d.to(device)
    return tuple(o[:, k] for k in range(3)), tuple(d[:, k] for k in range(3))


def _assert_hits(t_k, s_k, t_p, s_p, tol=1e-5):
    hit = torch.isfinite(t_p)
    assert torch.equal(torch.isfinite(t_k), hit)
    assert torch.allclose(t_k[hit], t_p[hit], rtol=tol, atol=tol)
    assert (s_k == s_p)[hit].float().mean().item() >= 0.995
    assert hit.sum().item() > 100


@pytest.mark.parametrize("n", [8192, 32768])
def test_k1_matches_plain(cuda, n):
    """K1 against its plain version on random rays (parked ones first) and
    rays aimed at shared triangle vertices and edges (exact ties): equal
    hit sets, equal t and equal slots on every hit. 8,192 random rays take
    the tail's launch shape, 32,768 the wide one."""
    cs = compile_scene(fixtures.mixed_bvh_scene(
        T.RenderConfig(width=8, height=8), n_cells=64), device=cuda)
    o, d = _rays(n, 1, cuda)
    eo, ed = (torch.from_numpy(x).to(cuda)
              for x in fixtures.edge_rays(cs.solids, 4096))
    o = tuple(torch.cat([a, eo[:, k]]) for k, a in enumerate(o))
    d = tuple(torch.cat([a, ed[:, k]]) for k, a in enumerate(d))
    bvh.bvh_planar_hit.launches = 0
    t_k, s_k = bvh.bvh_planar_hit(cs.kbvh, o, d, RAY_T_MIN)
    t_p, s_p = bvh.bvh_planar_hit_plain(cs.kbvh.prims, o, d, RAY_T_MIN)
    torch.cuda.synchronize()
    assert bvh.bvh_planar_hit.launches == 1
    hit = torch.isfinite(t_p)
    assert torch.equal(torch.isfinite(t_k), hit) and hit.sum().item() > 1000
    assert torch.equal(t_k[hit], t_p[hit])
    assert torch.equal(s_k, s_p)
    assert not torch.isfinite(t_k[:128]).any()
    assert (s_k[:128] == -1).all()


def _sphere_rays(cs, n, seed, device):
    """Rays from random origins aimed near the scene's valid spheres."""
    g = torch.Generator().manual_seed(seed)
    s = cs.solids
    centers = s.sph_center[s.sph_valid].cpu()
    o = torch.rand((n, 3), generator=g) * 22 - 11
    pick = torch.randint(0, centers.shape[0], (n,), generator=g)
    d = centers[pick] - o + 0.3 * torch.randn((n, 3), generator=g)
    o, d = o.to(device), d.to(device)
    return tuple(o[:, k] for k in range(3)), tuple(d[:, k] for k in range(3))


@pytest.mark.parametrize("ties", [False, True])
def test_k2_bvh_mode_matches_plain(cuda, ties):
    """K2 in its BVH mode (the sphere sweep min-combined with K1's planar
    hit and decoded in one launch) equals its plain version exactly on t,
    kind and idx: random rays (parked ones first) and rays aimed at the
    spheres on the mixed BVH scene. With ``ties`` the planar hit is set to
    a quad at exactly the sphere's t on every sphere hit: the sphere wins."""
    cs = compile_scene(fixtures.mixed_bvh_scene(
        T.RenderConfig(width=8, height=8), n_cells=64), device=cuda)
    s = cs.solids
    o1, d1 = _rays(16384, 11, cuda)
    o2, d2 = _sphere_rays(cs, 16384, 12, cuda)
    o = tuple(torch.cat([a, b]) for a, b in zip(o1, o2))
    d = tuple(torch.cat([a, b]) for a, b in zip(d1, d2))
    t_p, pslot = bvh.bvh_planar_hit(cs.kbvh, o, d, RAY_T_MIN)
    if ties:
        t_s, _ = sweep.closest_hit_plain(s.sph_table, None, o, d, RAY_T_MIN,
                                         INF, spheres_only=True)
        tie = torch.isfinite(t_s)
        quad = int(torch.nonzero(~s.pl_is_tri & s.pl_valid)[0])
        t_p = torch.where(tie, t_s, t_p)
        pslot = torch.where(tie, quad, pslot).to(torch.int32)
    args = (s.sph_table, o, d, RAY_T_MIN, INF, t_p, pslot, s.pl_idx,
            s.pl_is_tri)
    sweep.bvh_sphere_hit.launches = 0
    got = sweep.bvh_sphere_hit(*args)
    want = sweep.bvh_sphere_hit_plain(*args)
    torch.cuda.synchronize()
    assert sweep.bvh_sphere_hit.launches == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    t, kind, idx = got
    assert not torch.isfinite(t[:128]).any()
    assert (kind[:128] == 0).all() and (idx[:128] == 0).all()
    assert (kind == 0).logical_and(torch.isfinite(t)).sum() > 1000
    if ties:
        assert tie.sum() > 1000 and (kind[tie] == 0).all()


def _grazing_kitchen(cfg):
    """The normal-mapped kitchen-sink scene seen along its medium box's top
    front edge: the pinhole camera sits in the planes y = 2 and z = 1.5 of
    the box (0, 0, 0.5)-(1, 2, 1.5), so the rays near the image's centre
    graze two faces and the edge between them (the risk of K4's box
    cull)."""
    kitchen = fixtures.kitchen_sink_scene(cfg)
    camera = T.CameraConfig(vertical_fov_degrees=8.0,
                            look_from=(-4.0, 2.0, 1.5),
                            look_at=(1.0, 2.0, 1.5))
    return T.Scene(kitchen.world, camera, kitchen.background_color, cfg)


K4_SCENES = {
    "kitchen": fixtures.kitchen_sink_scene,
    "grazing": _grazing_kitchen,
    # 1,156 planar rows: five of K4's shared-memory tiles
    "large": lambda c: fixtures.mixed_bvh_scene(c, n_cells=24),
}


@pytest.mark.parametrize("name", list(K4_SCENES))
def test_k4_matches_plain(cuda, name):
    """The fused scene hit equals its plain version exactly on t, kind and
    idx: on the normal-mapped kitchen-sink scene (2 spheres, 141 planar
    rows, one medium box), on its camera grazing the medium box, and on
    tables of several tiles; camera rays of 96x64 pixels, the
    bounces from their hits, random rays and parked rays. The counters are
    int64 pixel and sample tensors and an int32 bounce tensor, as
    trace_queued gives them."""
    cs = compile_scene(K4_SCENES[name](T.RenderConfig(width=96, height=64)),
                       use_bvh=False, device=cuda)
    assert not cs.media or integrator.media_tables(cs).n_media == len(
        cs.media)
    w, h = 96, 64
    pix = torch.arange(w * h, device=cuda)
    co, cd = integrator.camera_rays_plain(cs, pix, 1, 1, w, h)
    t, kind, idx = sweep.scene_hit_plain(cs.solids,
                                         integrator.media_tables(cs), co, cd,
                                         pix, 1, 0, 1)
    hit = torch.isfinite(t)
    attrs = integrator.full_hit_attributes(
        cs, co, cd, torch.where(hit, t, 0.0), kind, idx, pix, 1, 0, 1)
    bd = tuple(torch.where(hit, c, 0.0) for c in attrs["normal"])
    ro, rd = _rays(4096, 6, cuda, lo=-2.0, hi=3.0)
    o = tuple(torch.cat([a, b, c]) for a, b, c in zip(ro, co,
                                                       attrs["point"]))
    d = tuple(torch.cat([a, b, c]) for a, b, c in zip(rd, cd, bd))
    n = o[0].numel()
    pixel = torch.cat([torch.arange(4096, device=cuda), pix, pix])
    bounce = torch.cat([torch.zeros(4096 + w * h, dtype=torch.int32,
                                    device=cuda),
                        torch.ones(w * h, dtype=torch.int32, device=cuda)])
    sample = torch.ones(n, dtype=torch.int64, device=cuda)
    mt = integrator.media_tables(cs)
    sweep.scene_hit.launches = 0
    got = sweep.scene_hit(cs.solids, mt, o, d, pixel, sample, bounce, 1)
    want = sweep.scene_hit_plain(cs.solids, mt, o, d, pixel, sample, bounce,
                                 1)
    torch.cuda.synchronize()
    assert sweep.scene_hit.launches == 1 and got[0].shape == (n,)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    t, kind, idx = got
    assert not torch.isfinite(t[:128]).any()
    assert (kind[:128] == 0).all() and (idx[:128] == 0).all()
    assert torch.isfinite(t).sum() > n // 2
    if name != "large":
        assert (kind == 3).sum().item() > 20   # medium events


def _grazing_scene(cfg):
    """A medium box seen along its top front edge: the pinhole camera sits
    in the planes y = 2 and z = 1.5 of the box (0, 0, 0.5)-(1, 2, 1.5), so
    the rays near the image's centre graze two faces and the edge between
    them (the risk of K5's box cull)."""
    grey = T.Lambertian(T.SolidColor(0.5, 0.5, 0.5))
    world = [T.Quad((-5, 0, -5), (10, 0, 0), (0, 0, 10), grey),
             T.Quad((6, -5, -5), (0, 10, 0), (0, 0, 10), grey),
             T.ConstantMedium(T.Bvh(T.new_box((0, 0, 0.5), (1, 2, 1.5),
                                              grey)), 0.5, (1, 1, 1)),
             T.Sphere((2.5, 1.8, 1.2), 0.5,
                      T.Metal(T.SolidColor(0.8, 0.8, 0.8), fuzz=0.1)),
             T.Sphere((0, 10, 0), 3.0, T.DiffuseLight(10, 10, 10))]
    camera = T.CameraConfig(vertical_fov_degrees=8.0,
                            look_from=(-4.0, 2.0, 1.5),
                            look_at=(1.0, 2.0, 1.5))
    return T.Scene(T.Bvh(world), camera, (0.2, 0.3, 0.5), cfg)


def _two_media_scene(cfg):
    """A medium box and a medium ball that overlaps it, on a floor: the
    ball's events clip against the box's."""
    grey = T.Lambertian(T.SolidColor(0.5, 0.5, 0.5))
    world = [T.Quad((-5, 0, -5), (10, 0, 0), (0, 0, 10), grey),
             T.ConstantMedium(T.Bvh(T.new_box((-1, 0, -1), (1, 2, 1), grey)),
                              0.5, (1, 1, 1)),
             T.ConstantMedium(T.Sphere((0.8, 1.2, 0.8), 0.9, grey), 0.8,
                              (1, 1, 1)),
             T.Sphere((0, 10, 0), 3.0, T.DiffuseLight(10, 10, 10))]
    camera = T.CameraConfig(vertical_fov_degrees=40.0, look_from=(0, 1, 6),
                            look_at=(0, 1, 0))
    return T.Scene(T.Bvh(world), camera, (0.2, 0.3, 0.5), cfg)


def _large_medium_scene(cfg):
    """The two-media scene with 600 quads more in the box's boundary: more
    rows than K3 stages in shared memory (kMediaSmemBytes), so the kernel
    reads them from device memory."""
    scene = _two_media_scene(cfg)
    grey = T.Lambertian(T.SolidColor(0.5, 0.5, 0.5))
    g = np.random.default_rng(7)
    quads = [T.Quad(g.uniform(-1, 1, 3) + (0, 1, 0), 0.3 * g.normal(size=3),
                    0.3 * g.normal(size=3), grey) for _ in range(600)]
    box = T.ConstantMedium(T.Bvh(T.new_box((-1, 0, -1), (1, 2, 1), grey)
                                 + quads), 0.5, (1, 1, 1))
    world = scene.world.children
    world = [world[0], box] + world[2:]
    return T.Scene(T.Bvh(world), scene.camera, scene.background_color, cfg)


K3_SCENES = {"two_media": _two_media_scene, "grazing": _grazing_scene,
             "large": _large_medium_scene}


@pytest.mark.parametrize("counter", ["int32", "int64"])
@pytest.mark.parametrize("name", list(K3_SCENES))
def test_k3_matches_plain(cuda, name, counter):
    """K3 (every medium in order on top of a solid hit, drawn, culled and
    updated in one launch) equals its plain version exactly on t, kind and
    idx: two overlapping media, a camera grazing a medium box's faces and
    edge, and a boundary of more rows than K3 stages in shared memory; on
    camera rays of 96x64 pixels, the bounces from their hits, random rays
    and parked rays, with int32 or int64 pixel and sample counters. Parked
    lanes keep their input."""
    w, h = 96, 64
    cs = compile_scene(K3_SCENES[name](T.RenderConfig(width=w, height=h)),
                       use_bvh=False, device=cuda)
    mt = integrator.media_tables(cs)
    assert mt.n_media == len(cs.media) >= 1
    if name == "large":
        assert mt.pln.shape[0] * 64 > 32 * 1024
    no_media = sweep.pack_media((), cuda, 1.0)
    pix = torch.arange(w * h, device=cuda)
    co, cd = integrator.camera_rays_plain(cs, pix, 1, 1, w, h)
    t, kind, idx = sweep.scene_hit_plain(cs.solids, mt, co, cd, pix, 1, 0, 1)
    hit = torch.isfinite(t)
    attrs = integrator.full_hit_attributes(
        cs, co, cd, torch.where(hit, t, 0.0), kind, idx, pix, 1, 0, 1)
    bd = tuple(torch.where(hit, c, 0.0) for c in attrs["normal"])
    ro, rd = _rays(4096, 13, cuda, lo=-3.0, hi=3.0)
    o = tuple(torch.cat([a, b, c]) for a, b, c in zip(ro, co,
                                                       attrs["point"]))
    d = tuple(torch.cat([a, b, c]) for a, b, c in zip(rd, cd, bd))
    n = o[0].numel()
    dtype = getattr(torch, counter)
    pixel = torch.cat([torch.arange(4096, device=cuda), pix, pix]).to(dtype)
    bounce = torch.cat([torch.zeros(4096 + w * h, dtype=torch.int32,
                                    device=cuda),
                        torch.ones(w * h, dtype=torch.int32, device=cuda)])
    sample = torch.ones(n, dtype=dtype, device=cuda)
    solid = sweep.scene_hit_plain(cs.solids, no_media, o, d, pixel, sample,
                                  bounce, 1)
    args = (mt, o, d, *solid, pixel, sample, bounce, 1)
    sweep.media_hit.launches = 0
    got = sweep.media_hit(*args)
    want = sweep.media_hit_plain(*args)
    torch.cuda.synchronize()
    assert sweep.media_hit.launches == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(got, solid):   # parked lanes keep their input
        assert torch.equal(a[:128], b[:128])
    kind = got[1]
    assert (kind == 3).sum().item() > 20   # medium events
    if name == "two_media":
        assert (got[2][kind == 3] == 1).sum().item() > 20
    # and the fused K4 on the same scene agrees with K3 on top of K2's
    # sweep (K4 sweeps the solids itself)
    k4 = sweep.scene_hit(cs.solids, mt, o, d, pixel, sample, bounce, 1)
    for a, b in zip(k4, got):
        assert torch.equal(a, b)


K5_SCENES = {"kitchen_solid": fixtures.kitchen_sink_solid_scene,
             "kitchen_textured": lambda c: fixtures.kitchen_sink_scene(
                 c, normal_map=False),
             "grazing": _grazing_scene}


def _k5_against_plain(cs, spp, **kw):
    """K5 twice and its plain version: the two launches and the plain
    version equal bit for bit, segments equal. Returns (accum, segments,
    the first launch's stats)."""
    assert megakernel.megakernel_supported(cs, need_aux=False, shader_kind=0)
    megakernel.render_batch_megakernel.launches = 0
    stats = {}
    a, seg_a = megakernel.render_batch_megakernel(cs, 1, spp, 1, stats=stats,
                                                  **kw)
    b, seg_b = megakernel.render_batch_megakernel(cs, 1, spp, 1, **kw)
    p, seg_p = megakernel.render_batch_megakernel_plain(cs, 1, spp, 1, **kw)
    torch.cuda.synchronize()
    assert megakernel.render_batch_megakernel.launches == 2
    assert torch.equal(a, b) and int(seg_a) == int(seg_b)
    assert int(seg_a) == int(seg_p)
    assert torch.equal(a, p)
    return a, int(seg_a), stats


@pytest.mark.parametrize("name", list(K5_SCENES))
def test_k5_matches_plain_and_repeats(cuda, name):
    """The megakernel equals its plain version bit for bit (values and
    segments) and repeats bit for bit: on the solid kitchen-sink scene, on
    the kitchen-sink scene without its normal map (an image texture on the
    ground, triangle prims, sphere / quad / triangle lights), and on a
    camera that looks along the medium box's faces, where the box cull
    meets grazing rays."""
    cs = compile_scene(K5_SCENES[name](T.RenderConfig(width=8, height=8)),
                       device=cuda)
    _, segs, stats = _k5_against_plain(cs, 4, width=64, height=48,
                                       max_depth=50)
    assert segs >= 64 * 48 * 4
    assert 0 < stats["medium_sweeps"] < segs


def test_k5_many_lights_matches_plain(cuda):
    """24 lights, above the 16 the unrolled light-pdf mean takes and
    within K5's gate of 32: K5 equals its plain version (whose mean sums
    the batched (R, L) table in light order) bit for bit."""
    cs = compile_scene(fixtures.many_light_scene(
        T.RenderConfig(width=8, height=8), n_lights=24, n_cells=4),
        device=cuda)
    assert len(cs.light_kinds) == 24 > 16
    _, segs, _ = _k5_against_plain(cs, 4, width=64, height=48, max_depth=50)
    assert segs >= 64 * 48 * 4


def test_k5_fewer_pixels_than_lanes(cuda):
    """An 8x8 image, far fewer pixels than the persistent grid's lanes:
    every pixel is traced once, and the work counts add up."""
    cs = compile_scene(fixtures.kitchen_sink_solid_scene(
        T.RenderConfig(width=8, height=8)), device=cuda)
    a, segs, stats = _k5_against_plain(cs, 3, width=8, height=8,
                                       max_depth=50)
    ps = stats["pixel_segments"]
    assert ps.shape == (64,) and int(ps.sum()) == segs
    assert int(ps.min()) >= 3 and float(a.sum()) > 0
    assert 1 <= stats["blocks"] <= stats["blocks_per_sm"] * \
        torch.cuda.get_device_properties(0).multi_processor_count
    assert segs <= 32 * stats["warp_iterations"]
    assert stats["warp_medium_sweeps"] <= stats["warp_iterations"]


@pytest.mark.parametrize("name,route", [("kitchen_solid", "K5"),
                                        ("kitchen", "K4")])
def test_small_scene_route(cuda, name, route):
    """A scene the megakernel gate accepts renders in one K5 launch and no
    other hit kernel; the normal-mapped scene takes the wavefront with K4
    and never K5."""
    build = {"kitchen_solid": fixtures.kitchen_sink_solid_scene,
             "kitchen": fixtures.kitchen_sink_scene}[name]
    cs = compile_scene(build(T.RenderConfig(width=8, height=8)), device=cuda)
    fns = {"K1": bvh.bvh_planar_hit, "K2": sweep.bvh_sphere_hit,
           "K3": sweep.media_hit, "K4": sweep.scene_hit,
           "K5": megakernel.render_batch_megakernel}
    for fn in fns.values():
        fn.launches = 0
    img, _, _, segs = integrator.render_sample_batch(
        cs, 1, 1, width=32, height=24, max_depth=50, shader_kind=0,
        need_aux=False, n_samples=2)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in fns.items()}
    if route == "K5":
        assert launches == dict(K1=0, K2=0, K3=0, K4=0, K5=1)
    else:
        assert launches["K4"] > 0 and launches["K5"] == 0
        assert launches["K1"] == launches["K2"] == launches["K3"] == 0
    assert float(img.sum()) > 0 and int(segs) >= 32 * 24 * 2


def test_card_render_matches_cpu_and_repeats(cuda):
    """The mixed BVH scene (all three kernels) on the card against the CPU
    (plain versions), and bit-identical when repeated."""
    w, h = 48, 32
    scene = fixtures.mixed_bvh_scene(T.RenderConfig(width=w, height=h),
                                     n_cells=24)
    kw = dict(width=w, height=h, max_depth=50, shader_kind=0,
              need_aux=False, n_samples=2)
    for fn in (bvh.bvh_planar_hit, sweep.bvh_sphere_hit, sweep.media_hit):
        fn.launches = 0
    cs = compile_scene(scene, device=cuda)
    a, _, _, seg_a = integrator.render_sample_batch(cs, 1, 1, **kw)
    b, _, _, seg_b = integrator.render_sample_batch(cs, 1, 1, **kw)
    assert min(bvh.bvh_planar_hit.launches, sweep.bvh_sphere_hit.launches,
               sweep.media_hit.launches) > 0
    assert torch.equal(a, b) and int(seg_a) == int(seg_b)
    c, _, _, seg_c = integrator.render_sample_batch(
        compile_scene(scene, device="cpu"), 1, 1, **kw)
    assert abs(int(seg_a) - int(seg_c)) <= 1e-3 * int(seg_c)
    close = np.isclose(a.cpu().numpy(), c.numpy(), rtol=1e-3,
                       atol=1e-3).all(-1)
    assert close.mean() >= 0.995


def _device_kernels(fn):
    """Names of the device kernels one call of ``fn`` ran (torch.profiler,
    ``profiling.device_kernels``)."""
    return device_kernels({"call": fn})["call"]


@pytest.mark.parametrize("route", ["K2", "K4"])
def test_scene_hit_is_one_launch(cuda, route):
    """On the BVH route the sphere part of ``bvh_closest_hit`` is one launch
    of K2 (no fill, no combine op), ``bvh_closest_hit`` as a whole is K1's
    bound fill, K1 and K2, and ``integrator.scene_hit`` of a scene with a
    medium adds one launch of K3 (no RNG, compare or where op); on the K4
    route ``integrator.scene_hit`` is one launch of K4 (no RNG, stack or
    decode op)."""
    w, h = 64, 48
    build = (fixtures.kitchen_sink_scene if route == "K4" else
             lambda c: fixtures.mixed_bvh_scene(c, n_cells=24))
    cs = compile_scene(build(T.RenderConfig(width=w, height=h)), device=cuda)
    pix = torch.arange(w * h, device=cuda)
    sample = torch.ones(w * h, dtype=torch.int64, device=cuda)
    bounce = torch.zeros(w * h, dtype=torch.int32, device=cuda)
    o, d = integrator.camera_rays_plain(cs, pix, 1, 1, w, h)
    # a first call packs the tables (K2's sphere table, the media)
    integrator.scene_hit(cs, o, d, pix, sample, bounce, 1)
    if route == "K4":
        names = _device_kernels(
            lambda: integrator.scene_hit(cs, o, d, pix, sample, bounce, 1))
        assert len(names) == 1 and "k4_scene_hit" in names[0], names
        return
    s = cs.solids
    assert cs.media
    t_p, pslot = bvh.bvh_planar_hit(cs.kbvh, o, d, RAY_T_MIN)
    names = _device_kernels(lambda: sweep.bvh_sphere_hit(
        s.sph_table, o, d, RAY_T_MIN, INF, t_p, pslot, s.pl_idx,
        s.pl_is_tri))
    assert len(names) == 1 and "k2_bvh_spheres" in names[0], names
    names = _device_kernels(lambda: bvh.bvh_closest_hit(
        cs.kbvh, s, o, d, RAY_T_MIN, INF))
    assert len(names) == 3 and "k1_bvh" in names[1] and \
        "k2_bvh_spheres" in names[2], names
    names = _device_kernels(
        lambda: integrator.scene_hit(cs, o, d, pix, sample, bounce, 1))
    assert len(names) == 4 and "k1_bvh" in names[1] and \
        "k2_bvh_spheres" in names[2] and "k3_media" in names[3], names


def test_wrapper_rejects_cpu_cuda_mix(cuda):
    cs = compile_scene(fixtures.small_scene(T.RenderConfig(width=8,
                                                           height=8)),
                       device=cuda)
    o, d = _rays(256, 5, "cpu")
    t = torch.full((256,), INF)
    zero = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError):
        sweep.media_hit(integrator.media_tables(cs), o, d, t, zero, zero,
                        zero, zero, zero, 1)


@pytest.mark.parametrize("form", ["lanes", "int bounce", "0-dim seed",
                                  "broadcast"])
def test_draw_kernel_matches_plain(cuda, form):
    """The draw kernel (csrc/rng.cu) against the plain PCG4D chain, the
    floats bit for bit, one launch a call: one device kernel for lanes and
    scalars, and before it a contiguous copy of each operand of a broadcast
    pair that is not of the full shape (rng.kernel_counter)."""
    from solstrale_tpu_torch.ops import rng

    g = torch.Generator().manual_seed(4)
    pix = torch.randint(0, 2**40, (4099,), generator=g).to(cuda)
    sample = torch.randint(0, 64, (4099,), generator=g).to(cuda)
    bounce = torch.randint(0, 51, (4099,), generator=g,
                           dtype=torch.int32).to(cuda)
    args = {"lanes": (pix, sample, bounce, 7),
            "int bounce": (pix, sample, 0, 7),
            "0-dim seed": (pix, 3, bounce, torch.tensor(9, device=cuda)),
            "broadcast": (pix[:64, None], sample[None, :33], 2, 1)}[form]
    before = rng.uniform4.launches
    got = rng.uniform4(*args[:3], rng.P_COSINE, args[3])
    assert rng.uniform4.launches == before + 1
    want = rng.uniform4_plain(*args[:3], rng.P_COSINE, args[3])
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    names = _device_kernels(
        lambda: rng.uniform4(*args[:3], rng.P_COSINE, args[3]))
    copies = 2 if form == "broadcast" else 0
    assert len(names) == 1 + copies and "rng_uniform4" in names[-1], names
    assert all("copy" in n for n in names[:copies]), names


@pytest.mark.parametrize("name", ["mixed", "kitchen"])
def test_graph_driver_matches_eager(cuda, name):
    """trace_queued's card driver (CUDA graph replays) against its eager
    driver at 128x64x4 (a wide and a tail pool): image and segments bit for
    bit at two sample_starts from one capture, one stop read a replay."""
    build = {"mixed": lambda c: fixtures.mixed_bvh_scene(c, n_cells=24),
             "kitchen": fixtures.kitchen_sink_scene}[name]
    w, h, spp = 128, 64, 4
    cs = compile_scene(build(T.RenderConfig(width=w, height=h)), device=cuda)
    kw = dict(width=w, height=h, max_depth=50)
    for start in (1, 5):
        stats = {}
        color, segs = integrator.trace_queued(cs, start, spp, 1,
                                              stats=stats, **kw)
        want, want_segs = integrator.trace_queued_eager(cs, start, spp, 1,
                                                        **kw)
        assert torch.equal(color, want) and int(segs) == int(want_segs)
        assert stats["replays"] == stats["host_reads"] > 0
        assert stats["iters"] == stats["host_reads"] * integrator.GRAPH_STEPS
    assert sum(1 for k in integrator._PER_SCENE
               if k[0] == id(cs) and k[1][0] == "wavefront") == 1


@pytest.mark.parametrize("name", ["mixed", "kitchen"])
def test_graphed_step_matches_eager(cuda, name):
    """The inverse step as image_and_texture_grad runs it on the card (one
    captured CUDA graph, replayed) against the same step run op by op, at
    64x32, depth 8: the loss to rtol 1e-5, the gradient to rtol 1e-5, atol
    1e-7 (the arena's index_add_ adds with atomics); one capture for two
    calls; a replay launches each kernel as often as the eager step's
    forward and path replay together: S1 and its backward S1B, the camera
    rays' CR once, and no draw kernel."""
    from solstrale_tpu_torch import bench, diff

    build = {"mixed": lambda c: fixtures.mixed_bvh_scene(c, n_cells=32),
             "kitchen": fixtures.kitchen_sink_scene}[name]
    w, h = 64, 32
    kw = dict(width=w, height=h, max_depth=8, n_samples=1, seed=1)
    cs = compile_scene(build(T.RenderConfig(width=w, height=h)), device=cuda)
    with torch.no_grad():
        target = diff.render_linear(cs, **dict(kw, seed=2))
    eager = diff._GradStep(cs, target, **kw)
    wrappers = bench.kernel_wrappers()
    captures = diff._GradStep.captures
    diff.image_and_texture_grad(cs, target, **kw)

    def launched(fn):
        before = {k: f.launches for k, f in wrappers.items()}
        out = fn()
        return out, {k: f.launches - before[k] for k, f in wrappers.items()}

    got, replayed = launched(lambda: diff.image_and_texture_grad(cs, target,
                                                                 **kw))
    want, dispatched = launched(lambda: eager.eager(cs, target))
    assert diff._GradStep.captures == captures + 1
    assert replayed == dispatched
    # the camera rays: one CR launch, their draws in registers; no draw
    # kernel, none a bounce
    assert replayed["CR"] == 1 and replayed["draw"] == 0
    assert replayed["K1"] or replayed["K4"]
    assert replayed["S1"] > replayed["S1B"] > 0
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-7)


STEP_SCENES = {
    "mixed": lambda c: fixtures.mixed_bvh_scene(c, n_cells=32),
    "sponza_textured": lambda c: fixtures.sponza_textured_scene(
        c, n_cells=24, tex_size=64),
    "many_lights": lambda c: fixtures.many_light_scene(c, n_lights=24,
                                                       n_cells=24),
    "production": lambda c: fixtures.sponza_production_scene(
        c, n_cells=24, tex_size=64),
    "kitchen": fixtures.kitchen_sink_scene,
    # small tables too large to stage: S1 reads them from device memory
    "many_materials": fixtures.many_material_scene,
}


def _same(a, b):
    """Bit-equal values, NaN where the other has NaN."""
    if a.is_floating_point():
        nan = torch.isnan(a)
        return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan],
                                                                 b[~nan])
    return torch.equal(a, b)


@pytest.mark.parametrize("name", list(STEP_SCENES))
def test_step_kernels_match_plain(cuda, name):
    """S1 (ops.step.step_shade) and S2 (step_regen) against their plain
    versions bit for bit on a 128x64x4 queue of 4,096 lanes, depth 3 (the
    cap ends paths): S2's reset against reset_plain, then eight chained
    steps, each S1 alone against shade_plain on the same inputs (colors,
    flags, lane state) and the whole kernel step against step_plain (the
    pool, the rows, the queue head, the segments); one launch of each a
    step."""
    from solstrale_tpu_torch.ops import step

    w, h, spp, depth = 128, 64, 4, 3
    cs = compile_scene(STEP_SCENES[name](T.RenderConfig(width=w, height=h)),
                       device=cuda)
    wk, wp = (integrator._Wavefront(cs.device, w, h, depth, spp, 1, 4096,
                                    None, None) for _ in range(2))
    wk.reset(cs, 1, None)
    wp.begin(1, None)
    wp.reset_plain(cs, wp.pools[0])
    capped = 0
    for _ in range(8):
        pk, pp = wk.pools[0], wp.pools[0]
        for a, b in zip(pk.tensors(), pp.tensors()):
            assert _same(a, b)
        assert _same(wk.accum[:wk.total_q], wp.accum[:wp.total_q])
        assert int(wk.next_q) == int(wp.next_q)
        assert int(wk.segments) == int(wp.segments)
        t, kind, idx = integrator.step_hit(cs, pp.o, pp.d, pp.pixel,
                                           pp.sample, pp.bounce, 1)
        kp, ip = (kind, idx) if kind is not None else bvh.decode_planar_slot(
            cs.solids, idx)
        args = (pp.bounce, pp.acc_len, pp.fold, pp.pixel, pp.sample, 1,
                pp.qpos < wp.total_q, depth)
        got = step.step_shade(cs, t, kind, idx, pp.o, pp.d, *args)
        want = integrator.shade_plain(cs, pp.o, pp.d, t, kp, ip, *args)
        for k in ("color",) + step.FLAGS:
            assert _same(got[k], want[k]), k
        for k, a, b in zip(step.LANE_ARRAYS, step.lane_arrays(got),
                           step.lane_arrays(want)):
            assert _same(a, b), k
        capped += int(want["capped"].sum())
        before = (step.step_shade.launches, step.step_regen.launches)
        wk.step(cs, pk)
        assert (step.step_shade.launches, step.step_regen.launches) == (
            before[0] + 1, before[1] + 1)
        wp.step_plain(cs, pp)
    assert capped > 0


@pytest.mark.parametrize("name", ["sponza_textured", "many_lights"])
def test_step_graph_batch_matches_plain_batch(cuda, name):
    """trace_queued's card driver, whose graphs hold the hit kernels, S1,
    the scan and S2, against the eager plain driver at 128x64x4: image and
    segments bit for bit; a replayed batch launches no draw kernel."""
    from solstrale_tpu_torch import bench

    w, h, spp = 128, 64, 4
    cs = compile_scene(STEP_SCENES[name](T.RenderConfig(width=w, height=h)),
                       device=cuda)
    kw = dict(width=w, height=h, max_depth=50)
    integrator.trace_queued(cs, 1, spp, 1, **kw)   # the capture
    wrappers = bench.kernel_wrappers()
    before = {k: f.launches for k, f in wrappers.items()}
    stats = {}
    color, segs = integrator.trace_queued(cs, 1, spp, 1, stats=stats, **kw)
    launches = {k: f.launches - before[k] for k, f in wrappers.items()}
    want, want_segs = integrator.trace_queued_eager(cs, 1, spp, 1, **kw)
    assert torch.equal(color, want) and int(segs) == int(want_segs)
    assert launches["draw"] == 0
    assert launches["S1"] == stats["iters"] == launches["S2"] - 1


@pytest.mark.parametrize("lanes,case", [
    (20000, "ragged"), (20000, "all"), (20000, "none"), (16384, "ragged"),
    (8192, "all"), (131149, "ragged"), (131149, "all")])
def test_s2_scan_matches_plain_on_edge_pools(cuda, lanes, case):
    """S2 with its in-kernel scan (decoupled look-back over its blocks'
    status words) against regen_plain bit for bit on pools whose lanes are
    no multiple of its block (20,000, 131,149), the tail pool's widths
    (16,384, 8,192), and flag patterns of every kind: random, every active
    lane terminal (the queue runs out on the second call of the widest) and
    none; three calls in a row, each on the last one's state, and after
    each the ticket back at 0 and the launch counted."""
    from solstrale_tpu_torch.ops import step

    w, h, spp = 128, 64, 40
    cs = compile_scene(STEP_SCENES["kitchen"](T.RenderConfig(width=w,
                                                             height=h)),
                       device=cuda)
    wk, wp = (integrator._Wavefront(cs.device, w, h, 3, spp, 1, lanes, None,
                                    None) for _ in range(2))
    for wf in (wk, wp):
        wf.begin(1, None)
        wf.reset_plain(cs, wf.pools[0])
        wf.step_plain(cs, wf.pools[0])
    pk, pp = wk.pools[0], wp.pools[0]
    gen = torch.Generator().manual_seed(lanes)
    for k in range(3):
        active = pp.qpos < wp.total_q
        pattern = {"ragged": torch.rand(lanes, generator=gen) < 0.3,
                   "all": torch.ones(lanes, dtype=torch.bool),
                   "none": torch.zeros(lanes, dtype=torch.bool)}[case]
        term = pattern.to(cuda) & active
        color = torch.rand((lanes, 3), generator=gen).to(cuda)
        pk.color.copy_(color)
        pp.color.copy_(color)
        step.step_regen(cs, wk, pk, term.clone())
        wp.regen_plain(cs, pp, color, term)
        for a, b in zip(pk.tensors(), pp.tensors()):
            assert _same(a, b)
        assert _same(wk.accum[:wk.total_q], wp.accum[:wp.total_q])
        assert int(wk.next_q) == int(wp.next_q)
        assert int(wk.segments) == int(wp.segments)
        assert wk.ticket.tolist() == [0, k + 1]


def _counted(fn):
    """``fn()`` with the launches of S1 and of K1 (the first kernel of a
    BVH scene's hit) it made: (result, S1's, K1's)."""
    from solstrale_tpu_torch.ops import step

    before = step.step_shade.launches, bvh.bvh_planar_hit.launches
    out = fn()
    return (out, step.step_shade.launches - before[0],
            bvh.bvh_planar_hit.launches - before[1])


def test_forward_renders_launch_s1_once_a_bounce(cuda, tmp_path):
    """The forward renders as a user calls them, grad mode on:
    render_sample, render_pixels on the fixed trip and render_sample_sharded
    (a one-rank NCCL group) shade every bounce with one S1 launch (as many
    as K1's; max_depth + 1 on the fixed trip), and the sharded planes
    equal render_sample's."""
    from solstrale_tpu_torch import parallel
    from solstrale_tpu_torch.parallel import distributed

    w, h, depth = 64, 32, 8
    cs = compile_scene(STEP_SCENES["mixed"](T.RenderConfig(width=w, height=h)),
                       device=cuda)
    assert torch.is_grad_enabled() and cs.kbvh is not None
    kw = dict(width=w, height=h, max_depth=depth,
              shader_kind=integrator.SHADER_PATH, need_aux=False)
    want, s1, k1 = _counted(lambda: integrator.render_sample(cs, 1, 1, **kw))
    assert 1 <= s1 == k1 <= depth + 1
    pix = torch.arange(w * h, device=cuda)
    _, s1, k1 = _counted(lambda: integrator.render_pixels(
        cs, pix, 1, 1, early_exit=False, **kw))
    assert s1 == k1 == depth + 1
    distributed.initialize(f"file://{tmp_path / 'store'}", 1, 0, "cuda")
    try:
        mesh = parallel.make_mesh(1, 1, device_type="cuda")
        got, s1, k1 = _counted(lambda: parallel.render_sample_sharded(
            cs, 1, 1, mesh, **kw))
    finally:
        torch.distributed.destroy_process_group()
    assert 1 <= s1 == k1 <= depth + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_s1_raises_where_autograd_needs_a_graph(cuda):
    """S1 alone builds no autograd graph: a render on the card whose arena
    requires grad raises unless it takes the differentiable route by name,
    which launches S1 a bounce in the forward and S1B a bounce in the
    backward, and gives the gradient."""
    from solstrale_tpu_torch import diff

    w, h = 32, 16
    cs = compile_scene(fixtures.kitchen_sink_scene(
        T.RenderConfig(width=w, height=h)), device=cuda)
    params = cs.textures.pixels.clone().requires_grad_(True)
    leaf = diff.set_texture_params(cs, params)
    pix = torch.arange(w * h, device=cuda)
    kw = dict(width=w, height=h, max_depth=4,
              shader_kind=integrator.SHADER_PATH, need_aux=False)
    from solstrale_tpu_torch.ops import step

    with pytest.raises(ValueError, match="builds no autograd graph"):
        integrator.render_pixels(leaf, pix, 1, 1, **kw)
    (color, _, _), s1, _ = _counted(lambda: integrator.render_pixels(
        leaf, pix, 1, 1, differentiable=True, **kw))
    assert s1 > 0
    before = step.step_shade_backward.launches
    grad, = torch.autograd.grad(color.sum(), params)
    assert step.step_shade_backward.launches - before == s1
    assert torch.isfinite(grad).all() and (grad != 0).any()


def _numpy_fold(g, r, device):
    """A fold from the numpy generator ``g`` with ties (A = B = 0, B = 3A),
    NaN and infinite B and dead channels (tests/test_torch_step_grad.py's
    ``_fold``), on ``device``."""
    A, B = [], []
    for _ in range(3):
        a = torch.from_numpy(g.uniform(0.0, 2.0, r).astype(np.float32))
        a = torch.where(torch.from_numpy(g.random(r) < 0.2), 0.0, a)
        u = torch.from_numpy(g.random(r))
        b = torch.from_numpy(g.uniform(0.0, 4.0, r).astype(np.float32))
        b = torch.where(u < 0.2, 3.0 * a, b)
        b = torch.where((u >= 0.2) & (u < 0.3), float("inf"), b)
        b = torch.where((u >= 0.3) & (u < 0.35), float("nan"), b)
        b = torch.where((u >= 0.35) & (u < 0.45), 0.0, b)
        A.append(a.to(device))
        B.append(b.to(device))
    dead = tuple(torch.from_numpy(g.random(r) < 0.1).to(device)
                 for _ in range(3))
    return (tuple(A), tuple(B), dead,
            torch.from_numpy(g.random(r) < 0.5).to(device))


def _s1b_vs_plain(rec, ab, arena, bg, g_color, g_out):
    """S1B (ops.step.step_shade_backward) against its plain version, each
    adding into sums of its own: one launch, the fold's gradients bit for
    bit, the arena's and the background's sums (by atomics on the card)
    within 1e-5 of the magnitudes summed into each entry (the plain
    backward of the upstream's absolute values) and 1e-7. Returns the
    kernel's sums."""
    from solstrale_tpu_torch.ops import step

    k_sums, p_sums, s_sums = (torch.zeros((arena.shape[0] + 1, 3),
                                          device=arena.device)
                              for _ in range(3))
    before = step.step_shade_backward.launches
    k_ab = step.step_shade_backward(rec, ab, arena, bg, g_color, g_out,
                                    k_sums)
    assert step.step_shade_backward.launches == before + 1
    p_ab = step.step_shade_backward_plain(rec, ab, arena, bg, g_color, g_out,
                                          p_sums)
    for a, b in zip(k_ab, p_ab):
        assert _same(a, b)
    step.step_shade_backward_plain(rec, ab, arena, bg, g_color.abs(),
                                   [x.abs() for x in g_out], s_sums)
    assert ((k_sums - p_sums).abs() <= 1e-5 * s_sums + 1e-7).all()
    return k_sums


def _upstream(g, r, device):
    """Upstream gradients from the numpy generator ``g``: the color's (R, 3)
    with 0 (+0 or -0) on a third of the lanes, where S1B passes a parked
    lane's fold gradients through, and the fold's six (R,)."""
    g_color = g.normal(size=(r, 3)).astype(np.float32)
    u = g.random(r)
    g_color[u < 1 / 6] = 0.0
    g_color[(u >= 1 / 6) & (u < 1 / 3)] = -0.0
    return (torch.from_numpy(g_color).to(device),
            [torch.from_numpy(g.normal(size=r).astype(np.float32)).to(device)
             for _ in range(6)])


def _s1b_bounces(cs, w, h, depth, bounces, g, one_row=None):
    """``bounces`` chained bounces of S1 with its record against
    shade_plain(record=True), bit for bit, each followed by S1B against its
    plain version (``_s1b_vs_plain``) on that record (with ``one_row``,
    every lane's texel row replaced by that row: a solid colour), on
    ``w * h`` lanes with a fold, parked lanes and upstream gradients from
    the numpy generator ``g``."""
    from solstrale_tpu_torch.ops import step

    cuda = cs.device
    pix = torch.arange(w * h, device=cuda)
    r = pix.shape[0]
    sample = torch.ones_like(pix)
    o, d = integrator.camera_rays_plain(cs, pix, 1, 1, w, h)
    bounce = torch.from_numpy(g.integers(0, depth + 1, r).astype(
        np.int32)).to(cuda)
    acc_len = torch.zeros(r, device=cuda)
    active = torch.from_numpy(g.random(r) > 0.1).to(cuda)
    arena, bg = cs.textures.pixels, cs.bg_color
    for _ in range(bounces):
        A, B, dead, outer = _numpy_fold(g, r, cuda)
        t, kind, idx = integrator.step_hit(cs, o, d, pix, sample, bounce, 1)
        kp, ip = (kind, idx) if kind is not None else bvh.decode_planar_slot(
            cs.solids, idx)
        fold = (A, B, dead, outer)
        args = (bounce, acc_len, fold, pix, sample, 1, active, depth)
        got, rec = step.shade_with_record(cs, t, kind, idx, o, d, *args)
        want = integrator.shade_plain(cs, o, d, t, kp, ip, *args,
                                      record=True)
        assert torch.equal(rec, want["record"])
        for k in ("color",) + step.FLAGS:
            assert _same(got[k], want[k]), k
        for k, a, b in zip(step.LANE_ARRAYS, step.lane_arrays(got),
                           step.lane_arrays(want)):
            assert _same(a, b), k
        if one_row is not None:
            rec[0] = one_row
        g_color, g_out = _upstream(g, r, cuda)
        _s1b_vs_plain(rec, (*A, *B), arena, bg, g_color, g_out)
        o, d = want["o"], want["d"]
        bounce, acc_len = want["bounce"], want["acc_len"]


@pytest.mark.parametrize("name", list(STEP_SCENES))
def test_s1b_matches_plain(cuda, name):
    """S1 with its record against shade_plain(record=True), bit for bit, and
    S1B (ops.step.step_shade_backward) against its plain version on the same
    record and inputs (``_s1b_vs_plain``: the fold's gradients bit for bit,
    the lanes S1B passes through included, the sums within 1e-5 of the
    magnitudes summed); three chained bounces of 8,192 lanes at depth cap
    2, folds and upstream gradients from a numpy seed; one S1B launch a
    call."""
    w, h = 128, 64
    cs = compile_scene(STEP_SCENES[name](T.RenderConfig(width=w, height=h)),
                       device=cuda)
    _s1b_bounces(cs, w, h, 2, 3, np.random.default_rng(7))


@pytest.mark.parametrize("name", ["mixed", "sponza_textured"])
def test_s1b_one_row_matches_plain(cuda, name):
    """A solid colour: every lane's texel row the same row, so each warp's
    lanes sum one row in log2 steps before one atomic add; S1B against its
    plain version as in ``test_s1b_matches_plain``, on an untextured and a
    textured scene."""
    w, h = 128, 64
    cs = compile_scene(STEP_SCENES[name](T.RenderConfig(width=w, height=h)),
                       device=cuda)
    _s1b_bounces(cs, w, h, 2, 3, np.random.default_rng(8), one_row=3)


@pytest.mark.parametrize("name,w,h,seed", [("kitchen", 400, 266, 9),
                                           ("mixed", 960, 540, 10)])
def test_s1b_at_step_width_matches_plain(cuda, name, w, h, seed):
    """S1B against its plain version at a 400x266 inverse step's 106,400
    lanes (the kitchen, K4) and at 960x540 (518,400 lanes, the mixed
    scene), where each block of its resident grid loops over more than one
    tile of lanes, its row table and background sum carried across tiles;
    two chained bounces at depth cap 2."""
    cs = compile_scene(STEP_SCENES[name](T.RenderConfig(width=w, height=h)),
                       device=cuda)
    _s1b_bounces(cs, w, h, 2, 2, np.random.default_rng(seed))


def test_graphed_step_at_step_width_matches_eager(cuda):
    """The inverse step at 400x266, depth 50 on the kitchen (106,400 lanes,
    S1B adding into one sums buffer a backward pass): one replay of its
    CUDA graph against the same step run op by op (``_GradStep.eager``,
    the eager route with the same sums): the loss the same bits, the
    gradient within rtol 1e-4, atol 1e-7 (its sums by atomics)."""
    from solstrale_tpu_torch import diff

    w, h = 400, 266
    kw = dict(width=w, height=h, max_depth=50, n_samples=1, seed=1)
    cs = compile_scene(fixtures.kitchen_sink_scene(T.RenderConfig(
        width=w, height=h)), device=cuda)
    with torch.no_grad():
        target = diff.render_linear(cs, **dict(kw, seed=2))
    eager = diff._GradStep(cs, target, **kw)
    diff.image_and_texture_grad(cs, target, **kw)
    loss, g = diff.image_and_texture_grad(cs, target, **kw)
    loss_e, g_e = eager.eager(cs, target)
    assert torch.equal(loss, loss_e)
    assert torch.isfinite(g).all() and (g != 0).any()
    torch.testing.assert_close(g, g_e, rtol=1e-4, atol=1e-7)


def _first_hit_against_plain(cs, pix, sample, w, h):
    """CR against camera_rays_plain, then FH on CR's rays and their depth-0
    hit (step_hit, as first_hit_planes takes it) with every debug shader
    and none and every combination of the aux planes against the plain
    functions, bit for bit (NaN where the plain has NaN), a plane not asked
    for not returned; one launch a call. Returns the hit lanes."""
    from solstrale_tpu_torch.ops import first_hit

    before = first_hit.camera_rays.launches
    o, d = first_hit.camera_rays(cs, pix, sample, 1, w, h)
    assert first_hit.camera_rays.launches == before + 1
    po, pd = integrator.camera_rays_plain(cs, pix, sample, 1, w, h)
    assert all(_same(a, b) for a, b in zip((*o, *d), (*po, *pd)))
    samp, bounce = integrator._depth0(pix, sample)
    hit = integrator.step_hit(cs, o, d, pix, samp, bounce, 1)
    want = {k: fn(cs, o, d, pix, sample, 1, hit)
            for k, fn in integrator._DEBUG_PLAIN.items()}
    aux = integrator.first_hit_aux_plain(cs, o, d, pix, sample, 1, hit)
    for shader in (None, *integrator._DEBUG_PLAIN):
        for alb in (False, True):
            for nrm in (False, True):
                if shader is None and not (alb or nrm):
                    continue
                before = first_hit.first_hit_shade.launches
                got = first_hit.first_hit_shade(cs, *hit, o, d, pix, sample,
                                                1, shader, alb, nrm)
                assert first_hit.first_hit_shade.launches == before + 1
                expect = dict(color=want.get(shader),
                              albedo=aux[0] if alb else None,
                              normal=aux[1] if nrm else None)
                for k, v in expect.items():
                    assert (got[k] is None) == (v is None), k
                    assert v is None or _same(got[k], v), (shader, alb, k)
    return int(torch.isfinite(hit[0]).sum())


@pytest.mark.parametrize("name", list(STEP_SCENES))
def test_first_hit_kernels_match_plain(cuda, name):
    """CR (ops.first_hit.camera_rays) and FH (first_hit_shade) against
    their plain versions bit for bit at 128x64: on 3,001 lanes (an odd
    count: a shuffled subset of the pixel ids, a sample a lane) and on
    the whole image (an int sample), and on 8,191 lanes of a 1080p
    camera's pixel ids (a 0-dim sample on the card); FH with every shader
    kind and plane combination."""
    w, h = 128, 64
    cs = compile_scene(STEP_SCENES[name](T.RenderConfig(width=w, height=h)),
                       device=cuda)
    g = torch.Generator().manual_seed(7)
    subset = torch.randperm(w * h, generator=g)[:3001].to(cuda)
    tall = torch.randperm(1920 * 1080, generator=g)[:8191].to(cuda)
    for pix, sample, (pw, ph) in (
            (subset, torch.full_like(subset, 3), (w, h)),
            (torch.arange(w * h, device=cuda), 2, (w, h)),
            (tall, torch.tensor(5, device=cuda), (1920, 1080))):
        assert _first_hit_against_plain(cs, pix, sample, pw, ph) > 0


@pytest.mark.parametrize("name", ["sponza_textured", "kitchen"])
@pytest.mark.parametrize("lanes", ["1", "255", "257", "wave+1"])
def test_first_hit_ragged_lanes_match_plain(cuda, name, lanes):
    """FH's persistent loop at its edges: CR and FH against their plain
    versions bit for bit (``_first_hit_against_plain``: every shader and
    plane combination) on 1 lane, 255 and 257 (a block's threads less and
    more one, so the last warp is ragged) and one more than a full wave of
    FH's persistent grid (``first_hit_grid``: its blocks times 256 lanes,
    so one warp walks a second time with one lane); pixel ids of a 1080p
    camera from a seeded shuffle, a sample a lane on odd counts, an int on
    even ones; on K1's planar slots (the textured sponza) and on K4's
    (kind, idx) (the normal-mapped kitchen)."""
    from solstrale_tpu_torch.ops import first_hit

    cs = compile_scene(STEP_SCENES[name](T.RenderConfig(width=128,
                                                        height=64)),
                       device=cuda)
    grid = first_hit.first_hit_grid(1 << 30)
    assert grid["blocks"] == grid["per_sm"] * grid["sms"] > 0
    n = (grid["blocks"] * first_hit.THREADS + 1 if lanes == "wave+1"
         else int(lanes))
    assert first_hit.first_hit_grid(n)["blocks"] == min(
        grid["blocks"], -(-n // first_hit.THREADS))
    g = torch.Generator().manual_seed(n)
    pix = torch.randperm(1920 * 1080, generator=g)[:n].to(cuda)
    sample = torch.full_like(pix, 3) if n % 2 else 2
    _first_hit_against_plain(cs, pix, sample, 1920, 1080)


def test_first_hit_routes_launch_cr_and_fh(cuda):
    """On the card the first hit's routes launch CR and FH and never the
    draw kernel: render_pixels with a debug shader and the aux planes one
    CR and one FH (its three planes equal to the plain compositions'),
    first_hit_aux one FH, the aux-on path batch one CR and one FH a
    sample. Where a scene table requires grad, first_hit_aux's backward is
    one FHB launch, its arena gradient within 1e-5 of the magnitudes of
    first_hit_backward_plain's; where a camera tensor does, CR's backward
    is one CRB launch, the camera's gradient as camera_rays_backward_plain
    gives it."""
    import dataclasses

    from solstrale_tpu_torch import bench
    from solstrale_tpu_torch.ops import first_hit

    w, h = 64, 32
    cs = compile_scene(fixtures.kitchen_sink_scene(T.RenderConfig(
        width=w, height=h)), device=cuda)
    wrappers = bench.kernel_wrappers()
    wrappers.update(CRB=first_hit.camera_rays_backward,
                    FHB=first_hit.first_hit_backward)

    def launched(fn):
        before = {k: f.launches for k, f in wrappers.items()}
        out = fn()
        return out, {k: f.launches - before[k] for k, f in wrappers.items()}

    pix = torch.arange(w * h, device=cuda)
    kw = dict(width=w, height=h, max_depth=50)
    got, n = launched(lambda: integrator.render_pixels(
        cs, pix, 1, 1, shader_kind=integrator.SHADER_SIMPLE, need_aux=True,
        **kw))
    assert (n["CR"], n["FH"], n["draw"], n["S1"]) == (1, 1, 0, 0)
    o, d = integrator.camera_rays_plain(cs, pix, 1, 1, w, h)
    want = (integrator.shade_simple_plain(cs, o, d, pix, 1, 1),
            *integrator.first_hit_aux_plain(cs, o, d, pix, 1, 1))
    assert all(_same(a, b) for a, b in zip(got, want))
    _, n = launched(lambda: integrator.first_hit_aux(cs, o, d, pix, 1, 1))
    assert (n["FH"], n["CR"], n["draw"]) == (1, 0, 0)
    _, n = launched(lambda: integrator.render_sample_batch(
        cs, 1, 1, shader_kind=integrator.SHADER_PATH, need_aux=True,
        n_samples=2, **kw))
    assert (n["CR"], n["FH"], n["draw"]) == (2, 2, 0) and n["S1"] > 0
    gen = torch.Generator(device=cuda).manual_seed(3)
    g_alb, g_nrm = (torch.randn((w * h, 3), generator=gen, device=cuda)
                    for _ in range(2))
    arena = cs.textures.pixels.detach().requires_grad_(True)
    grad_cs = dataclasses.replace(cs, textures=dataclasses.replace(
        cs.textures, pixels=arena))
    aux, n = launched(lambda: integrator.first_hit_aux(grad_cs, o, d, pix,
                                                       1, 1))
    assert (n["FH"], n["FHB"]) == (1, 0)
    (g_arena,), n = launched(lambda: torch.autograd.grad(
        (aux[0] * g_alb).sum() + (aux[1] * g_nrm).sum(), [arena]))
    assert (n["FHB"], n["FH"], n["draw"]) == (1, 0, 0)
    samp, bounce = integrator._depth0(pix, 1)
    hit = integrator.step_hit(cs, o, d, pix, samp, bounce, 1)
    planes = dict(albedo=g_alb, normal=g_nrm)
    sums, mags = (torch.zeros((arena.shape[0] + 1, 3), device=cuda)
                  for _ in range(2))
    first_hit.first_hit_backward_plain(cs, *hit, o, d, pix, 1, 1,
                                       cs.textures.pixels, planes, None,
                                       sums, want_bg=False)
    first_hit.first_hit_backward_plain(cs, *hit, o, d, pix, 1, 1,
                                       cs.textures.pixels, planes, None,
                                       mags, want_bg=False, magnitudes=True)
    assert (g_arena != 0).any()
    _grad_sums_close(g_arena, sums[:-1], mags[:-1])
    cam = dataclasses.replace(cs.camera, origin=cs.camera.origin.detach()
                              .requires_grad_(True))
    cam_cs = dataclasses.replace(cs, camera=cam)
    (o2, d2), n = launched(lambda: first_hit.camera_rays(cam_cs, pix, 1, 1,
                                                         w, h))
    assert (n["CR"], n["CRB"]) == (1, 0)
    assert all(_same(a, b) for a, b in zip((*o2, *d2), (*o, *d)))
    g_ray = torch.randn((6, w * h), generator=gen, device=cuda)
    (g_origin,), n = launched(lambda: torch.autograd.grad(
        (torch.stack([*o2, *d2]) * g_ray).sum(), [cam.origin]))
    assert (n["CRB"], n["CR"]) == (1, 0)
    plain = first_hit.camera_rays_backward_plain(cs, pix, 1, 1, w, h, g_ray)
    mag = first_hit.camera_rays_backward_plain(cs, pix, 1, 1, w, h, g_ray,
                                               magnitudes=True)
    _grad_sums_close(g_origin, plain[0], mag[0])


def _grad_sums_close(got, want, scale):
    """An atomic sum against the plain version's: within 1e-5 of the
    magnitudes summed into each entry (``scale``), and 1e-7; the plain
    version's finite."""
    assert torch.isfinite(want).all()
    bad = (got - want).abs() > 1e-5 * scale + 1e-7
    assert not bad.any(), (int(bad.sum()), float((got - want).abs().max()))


def _first_hit_grad_against_plain(cs, pix, sample, w, h, seed=5):
    """CRB and FHB against their plain versions on CR's rays of ``pix``
    and their depth-0 hit (step_hit, as first_hit_planes takes it), with
    upstream gradients from ``seed``: FHB with every debug shader and none
    and every combination of the aux planes, one launch a call, the rays'
    gradients bit for bit, the arena's, the background's and the frame
    tables' sums within 1e-5 of the magnitudes summed into each entry
    (``magnitudes=True``), and 1e-7; CRB's camera gradients likewise.
    Returns the calls checked."""
    from solstrale_tpu_torch.ops import first_hit as fh

    dev = pix.device
    o, d = fh.camera_rays(cs, pix, sample, 1, w, h)
    samp, bounce = integrator._depth0(pix, sample)
    hit = integrator.step_hit(cs, o, d, pix, samp, bounce, 1)
    r = pix.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = {k: torch.randn((r, 3), generator=gen, device=dev)
         for k in fh.PLANES}
    texels = cs.textures.pixels

    def run(fn, planes, shader, **kw):
        sums = torch.zeros((texels.shape[0] + 1, 3), device=dev)
        g_sph = torch.zeros_like(cs.solids.sph_attr)
        g_pl = torch.zeros_like(cs.solids.pl_attr)
        ray = fn(cs, *hit, o, d, pix, sample, 1, texels, planes, shader,
                 sums, g_sph=g_sph, g_pl=g_pl, **kw)
        return ray, (sums, g_sph, g_pl)

    checked = 0
    for shader in (None, *integrator._DEBUG_PLAIN):
        for alb in (False, True):
            for nrm in (False, True):
                if shader is None and not (alb or nrm):
                    continue
                planes = dict(color=g["color"] if shader else None,
                              albedo=g["albedo"] if alb else None,
                              normal=g["normal"] if nrm else None)
                before = fh.first_hit_backward.launches
                k_ray, k_sums = run(fh.first_hit_backward, planes, shader)
                assert fh.first_hit_backward.launches == before + 1
                p_ray, p_sums = run(fh.first_hit_backward_plain, planes,
                                    shader)
                _, m_sums = run(fh.first_hit_backward_plain, planes, shader,
                                magnitudes=True)
                assert all(_same(a, b) for a, b in zip(k_ray, p_ray)), (
                    shader, alb, nrm)
                for a, b, m in zip(k_sums, p_sums, m_sums):
                    _grad_sums_close(a, b, m)
                checked += 1
    g_ray = torch.randn((6, r), generator=gen, device=dev)
    before = fh.camera_rays_backward.launches
    k_cam = fh.camera_rays_backward(cs, pix, sample, 1, w, h, g_ray)
    assert fh.camera_rays_backward.launches == before + 1
    p_cam = fh.camera_rays_backward_plain(cs, pix, sample, 1, w, h, g_ray)
    m_cam = fh.camera_rays_backward_plain(cs, pix, sample, 1, w, h, g_ray,
                                          magnitudes=True)
    for a, b, m in zip(k_cam, p_cam, m_cam):
        assert a.shape == b.shape
        _grad_sums_close(a, b, m)
    return checked


@pytest.mark.parametrize("name", list(STEP_SCENES))
def test_first_hit_backward_kernels_match_plain(cuda, name):
    """CRB (ops.first_hit.camera_rays_backward) and FHB
    (first_hit_backward) against their plain versions
    (``_first_hit_grad_against_plain``) at 128x64: on 3,001 lanes (a
    shuffled subset of the pixel ids, a sample a lane) and on the whole
    image (an int sample), and on 8,191 lanes of a 1080p camera's pixel
    ids (a 0-dim sample on the card); every shader kind and plane
    combination, K1's planar slots (the textured sponza, many_materials)
    and (kind, idx) (the rest)."""
    w, h = 128, 64
    cs = compile_scene(STEP_SCENES[name](T.RenderConfig(width=w, height=h)),
                       device=cuda)
    g = torch.Generator().manual_seed(9)
    subset = torch.randperm(w * h, generator=g)[:3001].to(cuda)
    tall = torch.randperm(1920 * 1080, generator=g)[:8191].to(cuda)
    for pix, sample, (pw, ph) in (
            (subset, torch.full_like(subset, 3), (w, h)),
            (torch.arange(w * h, device=cuda), 2, (w, h)),
            (tall, torch.tensor(5, device=cuda), (1920, 1080))):
        assert _first_hit_grad_against_plain(cs, pix, sample, pw, ph) == 15


@pytest.mark.parametrize("lanes", [1, 255, 257, 300001])
def test_first_hit_backward_ragged_lanes_match_plain(cuda, lanes):
    """CRB and FHB at their edges: 1 lane, a block's threads less and more
    one, and more lanes than CRB's grid holds at one lane a thread (its
    threads then sum several lanes each), on the normal-mapped kitchen
    (spheres, a medium, K4's (kind, idx)) and a 1080p camera's pixel
    ids."""
    cs = compile_scene(fixtures.kitchen_sink_scene(T.RenderConfig(
        width=128, height=64)), device=cuda)
    g = torch.Generator().manual_seed(lanes)
    pix = torch.randperm(1920 * 1080, generator=g)[:lanes].to(cuda)
    sample = torch.full_like(pix, 3) if lanes % 2 else 2
    assert _first_hit_grad_against_plain(cs, pix, sample, 1920, 1080) == 15
