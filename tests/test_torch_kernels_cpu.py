"""Each kernel module's plain PyTorch version against the JAX function it
ports, on the CPU: K2's sweep (both modes, and its BVH mode's min-combine
with K1's planar hit), K3 (one medium, and every medium in order on top of
a solid hit, drawing from the lane counters) and K4 (the fused scene hit)
against the Pallas kernels in interpret mode and the XLA sweeps; K1 (BVH
planar hit) against the Pallas BVH kernel in interpret mode and the XLA
brute force, and K1's walk of the kernel tree (``accel.walk_counts``)
against the brute force, ties included; the hit attribute and NEE
light-table ops; the wrappers' device routing; and the kernels' C entry
points against their ctypes signatures."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solstrale_tpu as J
import solstrale_tpu_torch as T
from solstrale_tpu.geo import INF, RAY_T_MIN
from solstrale_tpu.ops import intersect as JX
from solstrale_tpu.ops import pallas_bvh
from solstrale_tpu.ops import rng as JR
from solstrale_tpu.ops.pallas_bvh import (bvh_closest_hit_pallas,
                                          bvh_planar_hit_pallas)
from solstrale_tpu.ops.pallas_sweep import (closest_hit_pallas,
                                            medium_hit_pallas,
                                            scene_hit_fused)
from solstrale_tpu.renderer.integrator import _MEDIUM_PURPOSE_BASE
from solstrale_tpu.scene.compile import compile_scene as jcompile
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch.ops import _build, bvh, intersect, rng, sweep
from solstrale_tpu_torch.renderer.integrator import media_tables
from solstrale_tpu_torch.scene.compile import compile_scene as tcompile

torch.set_num_threads(2)

N_RAYS = 1500
N_PARKED = 100


def _soup(api, n_sph=24, n_quads=96, n_tris=96, n_lights=3, seed=5,
          n_media=1):
    """Procedural prim soup: spheres, quads, triangles, a medium box and
    sphere / quad / triangle lights (``n_lights`` of each kind); with
    ``n_media=2`` also a medium ball that overlaps the box."""
    g = np.random.default_rng(seed)
    mat = api.Lambertian(api.SolidColor(0.5, 0.5, 0.5))
    world = [api.Sphere(g.uniform(-6, 6, 3), float(g.uniform(0.2, 1.0)), mat)
             for _ in range(n_sph)]
    for _ in range(n_quads):
        world.append(api.Quad(g.uniform(-6, 6, 3), g.normal(size=3),
                              g.normal(size=3), mat))
    for _ in range(n_tris):
        v0 = g.uniform(-6, 6, 3)
        world.append(api.Triangle(v0, v0 + g.normal(size=3),
                                  v0 + g.normal(size=3), mat))
    for i in range(n_lights):
        light = api.DiffuseLight(4.0 + i, 4.0, 4.0)
        c = g.uniform(-5, 5, 3)
        world.append(api.Sphere(c + (0, 8, 0), 0.7, light))
        world.append(api.Quad(c + (0, 9, 0), (1.5, 0, 0), (0, 0, 1.5), light))
        world.append(api.Triangle(c + (0, 10, 0), c + (1, 10, 0),
                                  c + (0, 10, 1), light))
    world.append(api.ConstantMedium(
        api.Bvh(api.new_box((-2, -1, -2), (2, 1.5, 2), mat)), 0.5,
        (1, 1, 1)))
    if n_media == 2:
        world.append(api.ConstantMedium(api.Sphere((1.5, -0.5, 1.5), 1.5, mat),
                                        0.8, (1, 1, 1)))
    return api.Scene(api.Bvh(world), api.CameraConfig(look_from=(0, 0, 10)),
                     (0, 0, 0), api.RenderConfig(width=8, height=8))


def _rays(n=N_RAYS, parked=N_PARKED, seed=0, lo=-6, hi=6):
    g = np.random.default_rng(seed)
    o = g.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d[:parked] = 0.0   # parked lanes (zero direction) must miss
    return o, d


def _t(x):
    return tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in x.T)


def _check_hits(t_ref, t_got, same, tol, agree=0.995):
    t_ref, t_got = np.asarray(t_ref), np.asarray(t_got)
    hit = np.isfinite(t_ref)
    np.testing.assert_array_equal(hit, np.isfinite(t_got))
    np.testing.assert_allclose(t_got[hit], t_ref[hit], rtol=tol, atol=tol)
    assert hit.sum() > 100
    assert np.asarray(same)[hit].mean() >= agree


@pytest.fixture(scope="module")
def soup():
    cj = jcompile(_soup(J), use_bvh=False)
    ct = tcompile(_soup(T), use_bvh=False, device="cpu")
    return cj, ct


@pytest.mark.parametrize("spheres_only", [False, True])
def test_k2_plain_matches_pallas_interpret(soup, spheres_only):
    cj, ct = soup
    o, d = _rays()
    t_j, s_j = closest_hit_pallas(cj.solids, jnp.asarray(o), jnp.asarray(d),
                                  RAY_T_MIN, INF, spheres_only=spheres_only,
                                  interpret=True)
    s = ct.solids
    t_t, s_t = sweep.closest_hit_plain(s.sph_table, s.pl_table, _t(o), _t(d),
                                       RAY_T_MIN, INF,
                                       spheres_only=spheres_only)
    _check_hits(t_j, t_t.numpy(), s_t.numpy() == np.asarray(s_j), 1e-5)
    assert not np.isfinite(t_t.numpy()[:N_PARKED]).any()


# The XLA sweep evaluates the plane functionals as matmuls, the kernels in
# the hit-point form: on this soup the JAX package's own XLA and Pallas
# sweeps differ by up to 7e-5 in t on 17 of ~540 hits (its 1e-4 note,
# ops/intersect.py:168-169), so comparisons with the XLA forms use 1e-4.
XLA_TOL = 1e-4


def test_k2_closest_solid_hit_matches_xla(soup):
    """The solid part of the scene hit (the fused path with no medium: K2's
    sweep and the slot decode) against the JAX package's XLA sweep."""
    cj, ct = soup
    o, d = _rays(seed=1)
    t_j, k_j, i_j = JX.closest_solid_hit(cj.solids, jnp.asarray(o),
                                         jnp.asarray(d), RAY_T_MIN, INF)
    no_media = sweep.pack_media((), "cpu", 1.0)
    t_t, k_t, i_t = sweep.scene_hit(ct.solids, no_media, _t(o), _t(d), 0, 1,
                                    0, 7)
    same = (k_t.numpy() == np.asarray(k_j)) & (i_t.numpy() == np.asarray(i_j))
    _check_hits(t_j, t_t.numpy(), same, XLA_TOL)


def test_k3_plain_matches_pallas_interpret(soup):
    cj, ct = soup
    o, d = _rays(seed=2, lo=-4, hi=4)
    g = np.random.default_rng(3)
    t_solid = g.uniform(0.5, 20.0, N_RAYS).astype(np.float32)
    u = g.random(N_RAYS).astype(np.float32)
    want = np.asarray(medium_hit_pallas(cj.media[0], jnp.asarray(o),
                                        jnp.asarray(d), jnp.asarray(t_solid),
                                        jnp.asarray(u), interpret=True))
    b = ct.media[0].boundary
    got = sweep.medium_hit_plain(b.sph_table, b.pl_table,
                                 ct.media[0].neg_inv_density, _t(o), _t(d),
                                 torch.from_numpy(t_solid),
                                 torch.from_numpy(u)).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(fin, np.isfinite(got))
    assert fin.sum() > 50
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-4)
    # and against the XLA medium_hit the JAX CPU path takes
    xla = np.asarray(JX.medium_hit(cj.media[0], jnp.asarray(o),
                                   jnp.asarray(d), jnp.asarray(t_solid),
                                   jnp.asarray(u)))
    np.testing.assert_array_equal(np.isfinite(xla), fin)
    np.testing.assert_allclose(got[fin], xla[fin], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("counter", ["int32", "int64"])
def test_media_hit_plain_matches_jax(counter):
    """K3's plain version, every medium in order on top of a solid hit (a
    box and a ball that overlaps it, so order and clipping matter), against
    the loop the JAX package's integrator runs on BVH scenes
    (integrator.py:153-165): its own rng.uniform per medium and
    medium_hit_pallas interpreted. The lane counters are int32 or int64
    tensors (int64 pixels above 2^32, taken as their low 32 bits; JAX gets
    those bits as int32); parked lanes keep their input."""
    cj = jcompile(_soup(J, n_media=2), use_bvh=False)
    ct = tcompile(_soup(T, n_media=2), use_bvh=False, device="cpu")
    o, d = _rays(seed=22, lo=-4, hi=4)
    g = np.random.default_rng(23)
    pix32 = g.integers(0, 2**31 - 1, N_RAYS).astype(np.int32)
    bounce = g.integers(0, 50, N_RAYS).astype(np.int32)
    sample, seed = 2, 23
    t0 = g.uniform(0.5, 12.0, N_RAYS).astype(np.float32)
    t0[g.random(N_RAYS) < 0.3] = np.inf
    t0[:N_PARKED] = np.inf
    kind0 = g.integers(0, 3, N_RAYS).astype(np.int32)
    idx0 = g.integers(0, 40, N_RAYS).astype(np.int32)
    pix_t = torch.from_numpy(pix32)
    if counter == "int64":
        pix_t = pix_t.long() + (torch.from_numpy(
            g.integers(1, 4, N_RAYS)) << 32)
    bounce_t = torch.from_numpy(bounce).to(getattr(torch, counter))

    t_j, k_j, i_j = (jnp.asarray(x) for x in (t0, kind0, idx0))
    oj, dj = jnp.asarray(o), jnp.asarray(d)
    for m, med in enumerate(cj.media):
        u_j = JR.uniform(jnp.asarray(pix32), sample, jnp.asarray(bounce),
                         _MEDIUM_PURPOSE_BASE + m, jnp.uint32(seed))
        u_t = rng.uniform(pix_t, sample, bounce_t, rng.P_MEDIUM_BASE + m,
                          seed)
        assert np.array_equal(np.asarray(u_j).view(np.uint32),
                              u_t.numpy().view(np.uint32))
        t_m = medium_hit_pallas(med, oj, dj, t_j, u_j, interpret=True)
        is_med = t_m < t_j
        t_j = jnp.where(is_med, t_m, t_j)
        k_j = jnp.where(is_med, 3, k_j)
        i_j = jnp.where(is_med, m, i_j)
    t_j, k_j, i_j = (np.asarray(x) for x in (t_j, k_j, i_j))

    args = (media_tables(ct), _t(o), _t(d), torch.from_numpy(t0),
            torch.from_numpy(kind0), torch.from_numpy(idx0), pix_t, sample,
            bounce_t, seed)
    t_t, k_t, i_t = (x.numpy() for x in sweep.media_hit_plain(*args))
    assert k_t.dtype == np.int32 and i_t.dtype == np.int32
    np.testing.assert_array_equal(k_t, k_j)
    np.testing.assert_array_equal(i_t, i_j)
    fin = np.isfinite(t_j)
    np.testing.assert_array_equal(fin, np.isfinite(t_t))
    np.testing.assert_allclose(t_t[fin], t_j[fin], rtol=1e-4, atol=1e-4)
    med = k_t == 3
    assert (i_t[med] == 0).sum() > 20 and (i_t[med] == 1).sum() > 20
    assert (med & (t0 < np.inf)).sum() > 20   # media clip solid hits
    assert not med[:N_PARKED].any()
    assert np.array_equal(t_t[:N_PARKED], t0[:N_PARKED])
    # the wrapper on CPU tensors is the plain version
    sweep.media_hit.launches = 0
    got = sweep.media_hit(*args)
    assert sweep.media_hit.launches == 0
    assert all(np.array_equal(a.numpy(), b) for a, b in
               zip(got, (t_t, k_t, i_t)))


def test_k4_plain_matches_pallas_interpret():
    """The fused scene hit over the soup with two media (a box and an
    overlapping ball, so the second clips against the first's events),
    parked rays included, against the JAX package's scene_hit_fused with its
    Pallas kernel interpreted. The port draws each medium's flight uniform
    from the lane counters; JAX gets them from its own rng.uniform on the
    same counters, and the draws are bit-equal."""
    cj = jcompile(_soup(J, n_media=2), use_bvh=False)
    ct = tcompile(_soup(T, n_media=2), use_bvh=False, device="cpu")
    o, d = _rays(seed=15, lo=-4, hi=4)
    g = np.random.default_rng(16)
    pix = g.integers(0, 2**31 - 1, N_RAYS).astype(np.int64)
    bounce = g.integers(0, 50, N_RAYS).astype(np.int32)
    sample, seed = 3, 16
    u_j = np.stack([np.asarray(JR.uniform(
        jnp.asarray(pix.astype(np.int32)), sample, jnp.asarray(bounce),
        16 + m, jnp.uint32(seed))) for m in range(2)])
    u_t = np.stack([rng.uniform(torch.from_numpy(pix), sample,
                                torch.from_numpy(bounce),
                                rng.P_MEDIUM_BASE + m, seed).numpy()
                    for m in range(2)])
    assert np.array_equal(u_j.view(np.uint32), u_t.view(np.uint32))
    t_j, k_j, i_j = (np.asarray(x) for x in scene_hit_fused(
        cj, jnp.asarray(o), jnp.asarray(d),
        tuple(jnp.asarray(x) for x in u_j), RAY_T_MIN, interpret=True))
    t_t, k_t, i_t = (x.numpy() for x in sweep.scene_hit_plain(
        ct.solids, media_tables(ct), _t(o), _t(d), torch.from_numpy(pix),
        sample, torch.from_numpy(bounce), seed))
    hit = np.isfinite(t_j)
    np.testing.assert_array_equal(hit, np.isfinite(t_t))
    assert not hit[:N_PARKED].any() and (k_t[:N_PARKED] == 0).all()
    med = hit & (k_j == 3)
    assert (i_j[med] == 0).sum() > 20 and (i_j[med] == 1).sum() > 20
    np.testing.assert_allclose(t_t[hit & ~med], t_j[hit & ~med], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(t_t[med], t_j[med], rtol=1e-4, atol=1e-4)
    same = (k_t == k_j) & (i_t == i_j)
    assert same[hit].mean() > 0.999


@pytest.fixture(scope="module")
def terrain():
    cfg = dict(width=8, height=8)
    cj = jcompile(fixtures.sponza_class_scene(J.RenderConfig(**cfg),
                                              n_cells=24, api=J))
    ct = tcompile(fixtures.sponza_class_scene(T.RenderConfig(**cfg),
                                              n_cells=24), device="cpu")
    assert cj.kbvh is not None and ct.kbvh is not None
    return cj, ct


def _terrain_rays(n=1024, parked=64, seed=6):
    """Camera-like coherent rays from inside the room plus random rays."""
    g = np.random.default_rng(seed)
    half = n // 2
    o1 = np.tile(np.array([[0.0, 6.0, 9.0]], np.float32), (half, 1))
    d1 = (np.array([[0.0, -0.55, -1.0]], np.float32)
          + 0.35 * g.normal(size=(half, 3)).astype(np.float32))
    o2 = g.uniform(-11, 11, (n - half, 3)).astype(np.float32)
    d2 = g.normal(size=(n - half, 3)).astype(np.float32)
    o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
    d[-parked:] = 0.0
    return o, d


def test_k1_plain_matches_pallas_bvh_interpret(terrain):
    cj, ct = terrain
    o, d = _terrain_rays()
    t_j, s_j = bvh_planar_hit_pallas(cj.kbvh, jnp.asarray(o), jnp.asarray(d),
                                     RAY_T_MIN, interpret=True)
    t_t, s_t = bvh.bvh_planar_hit_plain(ct.kbvh.prims, _t(o), _t(d),
                                        RAY_T_MIN)
    _check_hits(t_j, t_t.numpy(), s_t.numpy() == np.asarray(s_j), 1e-5)
    assert not np.isfinite(t_t.numpy()[-64:]).any()
    assert (s_t.numpy()[~np.isfinite(t_t.numpy())] == -1).all()


def test_k1_closest_hit_matches_xla_brute_force(terrain):
    cj, ct = terrain
    o, d = _terrain_rays(seed=7)
    t_j, k_j, i_j = JX.closest_solid_hit(cj.solids, jnp.asarray(o),
                                         jnp.asarray(d), RAY_T_MIN, INF)
    t_t, k_t, i_t = bvh.bvh_closest_hit(ct.kbvh, ct.solids, _t(o), _t(d),
                                        RAY_T_MIN, INF)
    same = (k_t.numpy() == np.asarray(k_j)) & (i_t.numpy() == np.asarray(i_j))
    _check_hits(t_j, t_t.numpy(), same, 1e-5)


def _exact_ties(prims, o, d, t_best):
    """Rays on which two or more valid prims give the closest t exactly
    (the brute force's formula over every prim)."""
    f = [prims[:, k][None, :] for k in range(15)]
    om = [c[:, None] for c in _t(o)]
    dm = [c[:, None] for c in _t(d)]
    dot = [lambda v, a=a: v[0] * f[a] + v[1] * f[a + 1] + v[2] * f[a + 2]
           for a in (0, 4, 8)]
    dn = dot[0](dm)
    t = (f[3] - dot[0](om)) / dn
    u = dot[1](om) + t * dot[1](dm) + f[7]
    v = dot[2](om) + t * dot[2](dm) + f[11]
    ok = ((torch.abs(dn) >= 1e-8) & (f[13] > 0.5) & (u >= 0) & (u <= 1)
          & (v >= 0) & torch.where(f[12] > 0.5, u + v <= 1, v <= 1)
          & (t >= RAY_T_MIN))
    return int(((ok & (t == t_best[:, None])).sum(1) >= 2).sum())


@pytest.mark.parametrize("name", ["terrain", "mixed"])
def test_walk_counts_equals_brute_force(terrain, name):
    """accel.walk_counts, the plain walk of the kernel tree that csrc/bvh.cu
    makes, returns the brute force's (t, slot) exactly: on camera-like and
    random rays, parked rays, and rays aimed at shared triangle vertices
    and edges, where several prims tie at the closest t and the walk must
    return the smallest slot. It counts box and prim tests per ray and the
    distinct prim rows read."""
    from solstrale_tpu_torch.accel import WALK_LEAF, walk_counts

    if name == "terrain":
        ct = terrain[1]
    else:
        ct = tcompile(fixtures.mixed_bvh_scene(T.RenderConfig(width=8,
                                                              height=8),
                                               n_cells=16), device="cpu")
    kb = ct.kbvh
    o1, d1 = _terrain_rays(seed=9)
    o2, d2 = fixtures.edge_rays(ct.solids, 1024, seed=10)
    o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
    t_p, s_p = bvh.bvh_planar_hit_plain(kb.prims, _t(o), _t(d), RAY_T_MIN)
    t_w, s_w, boxes, tests, rows = walk_counts(
        kb.node_min, kb.node_max, kb.prims, WALK_LEAF, _t(o), _t(d),
        RAY_T_MIN)
    assert torch.equal(t_w, t_p) and torch.equal(s_w, s_p)
    assert _exact_ties(kb.prims, o2, d2, t_p[len(o1):]) > 50
    assert torch.isfinite(t_p).sum() > 1500
    parked = torch.from_numpy((d == 0).all(1))
    assert parked.sum() == 64
    assert (boxes[parked] == 0).all() and (tests[parked] == 0).all()
    assert (boxes[~parked] >= 2).all()
    n_prims = int((kb.prims[:, 13] > 0.5).sum())
    assert tests[~parked].float().mean() < 0.1 * n_prims
    assert tests.max() <= rows <= min(n_prims, int(tests.sum()))


@pytest.mark.parametrize("cu_name,py_name", [
    ("kWalkLeaf", "WALK_LEAF"), ("kFarScale", "FAR_SCALE"),
    ("kBestScale", "BEST_SCALE")])
def test_bvh_cu_constants_match_accel(cu_name, py_name):
    """The constants K1's source shares with the tree build and the plain
    walk (csrc/bvh.cu cannot import them) hold accel's values in f32."""
    import re
    from pathlib import Path

    from solstrale_tpu_torch import accel

    src = (Path(bvh.__file__).parent.parent / "csrc" / "bvh.cu").read_text()
    m = re.search(rf"constexpr (?:int|float) {cu_name} = ([0-9.]+)f?;", src)
    assert m is not None
    assert np.float32(m.group(1)) == np.float32(getattr(accel, py_name))


def _c_launchers():
    """Each source's ``extern "C"`` launcher: name -> its parameters."""
    import re
    from pathlib import Path

    out = {}
    for src in _build.SOURCES:
        text = (Path(_build.__file__).parent.parent / "csrc" / src).read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            out[m.group(1)] = [p.strip() for p in m.group(2).split(",")]
    return out


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_launch_signature_matches_source(name):
    """The ctypes argument types of each kernel's C entry point follow its
    declaration in ``csrc`` (no compiler here to catch a mismatch): a
    pointer is c_void_p, an unsigned int c_uint, a float c_float, an int
    c_int, a long long c_longlong."""
    import ctypes

    def ctype(param):
        decl = param.rsplit(" ", 1)[0] if "*" not in param else "*"
        return {"*": ctypes.c_void_p, "unsigned int": ctypes.c_uint,
                "float": ctypes.c_float, "int": ctypes.c_int,
                "long long": ctypes.c_longlong}[decl]

    launchers = _c_launchers()
    assert set(launchers) == set(_build._SIGNATURES)
    assert [ctype(p) for p in launchers[name]] == _build._SIGNATURES[name]


def _away_rays(n):
    """Rays from far above the scene pointing away from it: they miss
    every prim."""
    o = np.tile(np.array([[0.0, 0.0, 200.0]], np.float32), (n, 1))
    d = np.random.default_rng(21).normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    return o, d


@pytest.mark.parametrize("ties", [False, True])
def test_k2_bvh_combine_matches_pallas_interpret(monkeypatch, ties):
    """K2's BVH mode (the spheres-only sweep min-combined with K1's planar
    hit and decoded, ``sweep.bvh_sphere_hit_plain``) against the JAX
    package's ``bvh_closest_hit_pallas`` with its Pallas kernels
    interpreted, on a BVH scene with spheres: camera-like and random rays,
    parked rays, and rays that miss everything (kind sphere, idx 0). With
    ``ties``, both get the same planar hit, set to a quad at exactly the
    sphere's t on every sphere hit: the sphere must win."""
    cfg = dict(width=8, height=8)
    cj = jcompile(fixtures.mixed_bvh_scene(J.RenderConfig(**cfg), n_cells=16,
                                           api=J))
    ct = tcompile(fixtures.mixed_bvh_scene(T.RenderConfig(**cfg),
                                           n_cells=16), device="cpu")
    assert ct.kbvh.has_spheres
    s = ct.solids
    # camera-like and random rays (the last 64 parked), rays aimed at the
    # spheres, rays that miss everything
    o1, d1 = _terrain_rays(seed=17)
    g = np.random.default_rng(18)
    centers = s.sph_center[s.sph_valid].numpy()
    o2 = g.uniform(-11, 11, (768, 3)).astype(np.float32)
    d2 = (centers[g.integers(0, len(centers), 768)] - o2
          + 0.3 * g.normal(size=(768, 3))).astype(np.float32)
    o3, d3 = _away_rays(256)
    o, d = np.concatenate([o2, o1, o3]), np.concatenate([d2, d1, d3])
    t_p, pslot = bvh.bvh_planar_hit_plain(ct.kbvh.prims, _t(o), _t(d),
                                          RAY_T_MIN)
    if ties:
        # rays on which both packages' sphere sweeps give the same t (on ~10%
    # of sphere hits: they round differently in the last bits)
        t_s, _ = sweep.closest_hit_plain(s.sph_table, None, _t(o), _t(d),
                                         RAY_T_MIN, INF, spheres_only=True)
        t_sj, _ = closest_hit_pallas(cj.solids, jnp.asarray(o),
                                     jnp.asarray(d), RAY_T_MIN, INF,
                                     spheres_only=True, interpret=True)
        quad = int(np.flatnonzero(~s.pl_is_tri.numpy()
                                  & s.pl_valid.numpy())[0])
        tie = torch.isfinite(t_s) & (t_s == torch.from_numpy(
            np.asarray(t_sj)))
        assert tie.sum() > 20
        t_p = torch.where(tie, t_s, t_p)
        pslot = torch.where(tie, quad, pslot).to(torch.int32)
        monkeypatch.setattr(pallas_bvh, "bvh_planar_hit_pallas",
                            lambda *a, **k: (jnp.asarray(t_p.numpy()),
                                             jnp.asarray(pslot.numpy())))
    t_j, k_j, i_j = (np.asarray(x) for x in bvh_closest_hit_pallas(
        cj.kbvh, cj.solids, jnp.asarray(o), jnp.asarray(d), RAY_T_MIN, INF,
        interpret=True))
    t_t, k_t, i_t = (x.numpy() for x in sweep.bvh_sphere_hit_plain(
        s.sph_table, _t(o), _t(d), RAY_T_MIN, INF, t_p, pslot, s.pl_idx,
        s.pl_is_tri))
    hit = np.isfinite(t_j)
    np.testing.assert_array_equal(hit, np.isfinite(t_t))
    np.testing.assert_allclose(t_t[hit], t_j[hit], rtol=1e-5, atol=1e-5)
    same = (k_t == k_j) & (i_t == i_j)
    assert same[hit].mean() >= 0.995 and same[~hit].all()
    miss = ~hit
    assert miss[-256:].all() and miss[-64 - 256:-256].all()  # away, parked
    assert (k_t[miss] == 0).all() and (i_t[miss] == 0).all()
    if ties:
        tie = tie.numpy()
        assert np.array_equal(t_t[tie], t_j[tie]) and same[tie].all()
        assert (k_t[tie] == 0).all()
    else:
        assert (k_t[hit] == 0).sum() > 10 and (k_t[hit] != 0).sum() > 100


def test_bvh_closest_hit_with_spheres_matches_xla():
    """K1 + K2 spheres-only, min-combined, on a BVH scene with spheres."""
    cfg = dict(width=8, height=8)
    cj = jcompile(fixtures.mixed_bvh_scene(J.RenderConfig(**cfg), n_cells=16,
                                           api=J))
    ct = tcompile(fixtures.mixed_bvh_scene(T.RenderConfig(**cfg),
                                           n_cells=16), device="cpu")
    assert ct.kbvh.has_spheres
    o, d = _terrain_rays(seed=8)
    t_j, k_j, i_j = JX.closest_solid_hit(cj.solids, jnp.asarray(o),
                                         jnp.asarray(d), RAY_T_MIN, INF)
    t_t, k_t, i_t = bvh.bvh_closest_hit(ct.kbvh, ct.solids, _t(o), _t(d),
                                        RAY_T_MIN, INF)
    same = (k_t.numpy() == np.asarray(k_j)) & (i_t.numpy() == np.asarray(i_j))
    _check_hits(t_j, t_t.numpy(), same, 1e-5)
    assert (k_t.numpy() == 0).sum() > 10   # some sphere hits


def _soa(x):
    return tuple(np.asarray(c) for c in x)


def test_hit_attributes_soa_allclose(soup):
    cj, ct = soup
    o, d = _rays(parked=0, seed=9)
    t_j, k_j, i_j = JX.closest_solid_hit(cj.solids, jnp.asarray(o),
                                         jnp.asarray(d), RAY_T_MIN, INF)
    hit = np.isfinite(np.asarray(t_j))
    t_safe = np.where(hit, np.asarray(t_j), 0.0).astype(np.float32)
    for has_spheres in (True, False):
        want = JX.hit_attributes_soa(
            cj.solids, tuple(jnp.asarray(c) for c in o.T),
            tuple(jnp.asarray(c) for c in d.T), jnp.asarray(t_safe), k_j,
            i_j, has_spheres=has_spheres)
        got = intersect.hit_attributes_soa(
            ct.solids, _t(o), _t(d), torch.from_numpy(t_safe),
            torch.from_numpy(np.array(k_j)),
            torch.from_numpy(np.array(i_j)), has_spheres=has_spheres)
        for key in ("point", "normal", "tangent", "bitangent", "uv"):
            for w, g in zip(_soa(want[key]), got[key]):
                np.testing.assert_allclose(g.numpy()[hit], w[hit],
                                           rtol=1e-5, atol=1e-5)
        for key in ("front_face", "mat"):
            np.testing.assert_array_equal(got[key].numpy()[hit],
                                          np.asarray(want[key])[hit])


@pytest.mark.parametrize("n_lights,tol", [(3, 1e-5), (6, 1e-4)])
def test_light_pdf_mean3_allclose(n_lights, tol):
    """3 lights of each kind (9, unrolled) and 6 (18, the batched (R, L)
    fallback above 16 lights). The JAX fallback sums its dot products as
    XLA reductions (another order than left to right), and a grazing pdf
    t^2*|d|^2/(cos*area) amplifies that: 1.6e-5 relative on one ray here,
    so the fallback is held at 1e-4."""
    cj = jcompile(_soup(J, n_lights=n_lights), use_bvh=False)
    ct = tcompile(_soup(T, n_lights=n_lights), use_bvh=False,
                  device="cpu")
    assert len(ct.light_kinds) == 3 * n_lights
    o, d = _rays(parked=0, seed=10)
    # aim half the rays at the lights so the pdfs are non-zero
    g = np.random.default_rng(11)
    pick = g.integers(0, 3 * n_lights, N_RAYS // 2)
    d[: N_RAYS // 2] = (np.asarray(cj.lights.p0)[pick] + 0.1
                        - o[: N_RAYS // 2])
    want = np.asarray(JX.light_pdf_mean3(
        cj.lights, tuple(jnp.asarray(c) for c in o.T),
        tuple(jnp.asarray(c) for c in d.T), kinds=cj.light_kinds))
    got = intersect.light_pdf_mean3(ct.lights, _t(o), _t(d),
                                    kinds=ct.light_kinds).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert (want[ok] > 0).sum() > 100
    np.testing.assert_allclose(got[ok], want[ok], rtol=tol, atol=tol)


def test_sample_light_direction3_allclose(soup):
    cj, ct = soup
    o, _ = _rays(parked=0, seed=12)
    g = np.random.default_rng(13)
    n_l = len(ct.light_kinds)
    pick = g.integers(0, n_l, N_RAYS).astype(np.int32)
    r1, r2 = (g.random(N_RAYS).astype(np.float32) for _ in range(2))
    want = JX.sample_light_direction3(
        cj.lights, tuple(jnp.asarray(c) for c in o.T), jnp.asarray(pick),
        jnp.asarray(r1), jnp.asarray(r2), kinds=cj.light_kinds)
    got = intersect.sample_light_direction3(
        ct.lights, _t(o), torch.from_numpy(pick), torch.from_numpy(r1),
        torch.from_numpy(r2), kinds=ct.light_kinds)
    for w, gg in zip(_soa(want), got):
        np.testing.assert_allclose(gg.numpy(), w, rtol=1e-5, atol=1e-5)


def test_table_rows_out_of_range_is_zero_row(soup):
    _, ct = soup
    table = ct.materials.attr
    idx = torch.tensor([0, -1, table.shape[0], table.shape[0] - 1])
    rows = torch.stack(intersect.table_rows(table, idx), dim=1)
    assert torch.equal(rows[0], table[0])
    assert torch.equal(rows[3], table[-1])
    assert not rows[1].any() and not rows[2].any()


def test_wrappers_route_cpu_tensors_to_plain(soup, terrain):
    """On CPU tensors each wrapper returns its plain version's result and
    launches no kernel."""
    _, ct = soup
    _, cterr = terrain
    for fn in (bvh.bvh_planar_hit, sweep.bvh_sphere_hit, sweep.media_hit,
               sweep.scene_hit):
        fn.launches = 0
    o, d = _t(_rays(seed=14)[0]), _t(_rays(seed=14)[1])
    s = ct.solids
    # K2 on the soup's spheres, combined with its planar sweep, on two
    # windows
    t_p, slot_p = sweep.closest_hit_plain(s.sph_table[:0], s.pl_table, o, d,
                                          RAY_T_MIN, INF)
    for tmax in (INF, 5.0):
        args = (s.sph_table, o, d, RAY_T_MIN, tmax, t_p, slot_p, s.pl_idx,
                s.pl_is_tri)
        got = sweep.bvh_sphere_hit(*args)
        want = sweep.bvh_sphere_hit_plain(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    pix = torch.arange(N_RAYS)
    mt = media_tables(ct)
    t0 = torch.full((N_RAYS,), 20.0)
    k0 = torch.zeros(N_RAYS, dtype=torch.int32)
    args = (mt, o, d, t0, k0, k0 + 1, pix, 1, 0, 5)
    got, want = sweep.media_hit(*args), sweep.media_hit_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (got[1] == 3).any()
    got = sweep.scene_hit(s, mt, o, d, pix, 1, 0, 5)
    want = sweep.scene_hit_plain(s, mt, o, d, pix, 1, 0, 5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = bvh.bvh_planar_hit(cterr.kbvh, o, d, RAY_T_MIN)
    want = bvh.bvh_planar_hit_plain(cterr.kbvh.prims, o, d, RAY_T_MIN)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    st = cterr.solids
    args = (st.sph_table, o, d, RAY_T_MIN, INF, *got, st.pl_idx, st.pl_is_tri)
    assert all(torch.equal(a, b) for a, b in zip(
        sweep.bvh_sphere_hit(*args), sweep.bvh_sphere_hit_plain(*args)))
    assert (bvh.bvh_planar_hit.launches, sweep.bvh_sphere_hit.launches,
            sweep.media_hit.launches, sweep.scene_hit.launches) == (0,) * 4


def test_wrappers_reject_bad_inputs(soup):
    _, ct = soup
    s = ct.solids
    o, d = _t(_rays()[0]), _t(_rays()[1])
    t_p = torch.full((N_RAYS,), INF)
    slot = torch.zeros(N_RAYS, dtype=torch.int32)
    with pytest.raises(ValueError):
        sweep.bvh_sphere_hit(s.sph_table, tuple(c.double() for c in o), d,
                             RAY_T_MIN, INF, t_p, slot, s.pl_idx, s.pl_is_tri)
    with pytest.raises(ValueError):
        sweep.bvh_sphere_hit(s.sph_table.t(), o, d, RAY_T_MIN, INF, t_p, slot,
                             s.pl_idx, s.pl_is_tri)
    mt = media_tables(ct)
    with pytest.raises(ValueError):
        sweep.media_hit(mt, tuple(c.double() for c in o), d, t_p, slot, slot,
                        0, 1, 0, 1)
    with pytest.raises(ValueError):
        sweep.media_hit(mt, o, d, t_p.double(), slot, slot, 0, 1, 0, 1)
