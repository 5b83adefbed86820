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


@pytest.mark.parametrize("spheres_only", [False, True])
def test_k2_matches_plain(cuda, spheres_only):
    cs = compile_scene(fixtures.mixed_bvh_scene(
        T.RenderConfig(width=8, height=8), n_cells=8), use_bvh=False,
        device=cuda)
    s = cs.solids
    o, d = _rays(16384, 2, cuda)
    t_k, s_k = sweep.closest_hit(s.sph_table, s.pl_table, o, d, RAY_T_MIN,
                                 INF, spheres_only=spheres_only)
    t_p, s_p = sweep.closest_hit_plain(s.sph_table, s.pl_table, o, d,
                                       RAY_T_MIN, INF,
                                       spheres_only=spheres_only)
    _assert_hits(t_k, s_k, t_p, s_p)


def test_k3_matches_plain(cuda):
    cs = compile_scene(fixtures.small_scene(T.RenderConfig(width=8,
                                                           height=8)),
                       device=cuda)
    med = cs.media[0]
    o, d = _rays(16384, 3, cuda, lo=-1.5, hi=1.5)
    g = torch.Generator().manual_seed(4)
    t_solid = (torch.rand(16384, generator=g) * 5).to(cuda)
    u = torch.rand(16384, generator=g).to(cuda)
    args = (med.boundary.sph_table, med.boundary.pl_table,
            med.neg_inv_density, o, d, t_solid, u)
    got, want = sweep.medium_hit(*args), sweep.medium_hit_plain(*args)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin) and fin.sum() > 100
    assert torch.allclose(got[fin], want[fin], rtol=1e-4, atol=1e-4)


def test_k4_matches_plain(cuda):
    """The fused scene hit on the normal-mapped kitchen-sink scene (2
    spheres, 141 planar rows, one medium box), parked rays included."""
    cs = compile_scene(fixtures.kitchen_sink_scene(
        T.RenderConfig(width=8, height=8)), device=cuda)
    s = cs.solids
    o, d = _rays(16384, 6, cuda, lo=-2.0, hi=3.0)
    g = torch.Generator().manual_seed(7)
    u = torch.rand((1, 16384), generator=g).to(cuda)
    mt = integrator.media_tables(cs)
    sweep.scene_hit.launches = 0
    t_k, s_k = sweep.scene_hit(s.sph_table, s.pl_table, mt, o, d, u)
    t_p, s_p = sweep.scene_hit_plain(s.sph_table, s.pl_table, mt, o, d, u)
    torch.cuda.synchronize()
    assert sweep.scene_hit.launches == 1
    _assert_hits(t_k, s_k, t_p, s_p, tol=1e-4)
    n_solid = s.sph_table.shape[0] + s.pl_table.shape[0]
    assert (s_k == n_solid).sum().item() > 20   # medium events
    assert not torch.isfinite(t_k[:128]).any() and (s_k[:128] == -1).all()


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
    fns = {"K1": bvh.bvh_planar_hit, "K2": sweep.closest_hit,
           "K3": sweep.medium_hit, "K4": sweep.scene_hit,
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
    for fn in (bvh.bvh_planar_hit, sweep.closest_hit, sweep.medium_hit):
        fn.launches = 0
    cs = compile_scene(scene, device=cuda)
    a, _, _, seg_a = integrator.render_sample_batch(cs, 1, 1, **kw)
    b, _, _, seg_b = integrator.render_sample_batch(cs, 1, 1, **kw)
    assert min(bvh.bvh_planar_hit.launches, sweep.closest_hit.launches,
               sweep.medium_hit.launches) > 0
    assert torch.equal(a, b) and int(seg_a) == int(seg_b)
    c, _, _, seg_c = integrator.render_sample_batch(
        compile_scene(scene, device="cpu"), 1, 1, **kw)
    assert abs(int(seg_a) - int(seg_c)) <= 1e-3 * int(seg_c)
    close = np.isclose(a.cpu().numpy(), c.numpy(), rtol=1e-3,
                       atol=1e-3).all(-1)
    assert close.mean() >= 0.995


def test_wrapper_rejects_cpu_cuda_mix(cuda):
    cs = compile_scene(fixtures.small_scene(T.RenderConfig(width=8,
                                                           height=8)),
                       device=cuda)
    o, d = _rays(256, 5, "cpu")
    with pytest.raises(ValueError):
        sweep.closest_hit(cs.solids.sph_table, cs.solids.pl_table, o, d,
                          RAY_T_MIN, INF)
