"""The first hit's gradient on the CPU: CR and FH as autograd Functions
(``ops.first_hit.CameraRaysFn``, ``FirstHitFn``), whose backwards there are
the plain versions of CRB and FHB, ``camera_rays_backward_plain`` and
``first_hit_backward_plain``, on the fixtures of test_torch_first_hit.py
(mixed16, kitchen, small, sponza24) and a scene with a sphere under a
normal map (``spheremap``; no fixture has one), on the same rays (a
partial, shuffled list of pixel ids; rays at both faces of a light):

(a) the arena and the background: ``jax.grad`` of a seeded weighted sum of
    each plane (the aux planes, each debug shader's color) through JAX's
    own ``first_hit_aux`` and ``shade_*`` against ``torch.autograd.grad``
    through the port's, within 1e-5 of the magnitudes summed into each
    entry (``first_hit_backward_plain(..., magnitudes=True)``), and 1e-6;
(b) the rays and the solid tables' frame columns (``Solids.sph_attr``'s
    center, ``Solids.pl_attr``'s normal, tangent and bitangent) against
    JAX's own pieces composed as first_hit_aux's and shade_normal's bodies
    compose them, t under ``jax.lax.stop_gradient`` (the JAX package's
    detached route), both on the port's hit: the rays per lane to rtol
    1e-4, atol 1e-5, the tables as (a);
(c) the camera: ``jax.grad`` of JAX's ``camera_rays`` with a lens and
    without, against the CR Function, as (a);
(d) each plain backward against ``torch.autograd.grad`` through the plain
    forward (``first_hit_plain``, ``camera_rays_plain``): per-lane ray
    gradients equal to rounding (rtol = atol = 1e-6; the sums of a lane's
    paths are taken in another order), sums within 1e-5 of the magnitudes;
(e) every other float table of the compiled scene, made a leaf that
    requires grad, gets a zero gradient (or none), as JAX's is zero;
(f) ``render_pixels`` with a debug shader and the aux planes, and the path
    shader's differentiable trace with the aux planes, through the
    Functions against autograd through their plain forwards; a trace and
    an aux plane of one pass add into one ``GradSums`` buffer.

The JAX side runs as test_torch_first_hit.py's fixture sets it up (its
kernels in Pallas interpret mode, detached by the JAX package's
``detached_call``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solstrale_tpu as J
import solstrale_tpu_torch as T
from solstrale_tpu.ops import rng as JR
from solstrale_tpu.renderer import integrator as JI
from solstrale_tpu.scene.compile import compile_scene as jcompile
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch.ops import bvh as TB
from solstrale_tpu_torch.ops import first_hit as FH
from solstrale_tpu_torch.ops import step as TS
from solstrale_tpu_torch.renderer import integrator as TI
from solstrale_tpu_torch.scene.compile import compile_scene as tcompile

from test_torch_first_hit import (H, SAMPLE, SCENES, SEED, W, _COMPILED,
                                  _jax_and_port, _rays, compiled)

torch.set_num_threads(2)

FIXTURES = list(SCENES)
PLANES = ("aux", "albedo", "normal", "simple")


def spheremap_scene(cfg, api):
    """A sphere and a quad under a normal map (the sphere's frame, its
    unnormalised bitangent included, through the map), a plain sphere, a
    quad light and a background: every frame gradient FHB takes."""
    albedo, height = fixtures.procedural_textures()
    normal = fixtures._submodule(api, "utils").height_to_normal_map(height)
    mapped = api.Lambertian(api.ImageMap(albedo), api.ImageMap(normal))
    world = [
        api.Sphere((0.0, 1.0, 0.0), 1.0, mapped),
        api.Sphere((2.2, 0.8, -0.5), 0.8,
                   api.Lambertian(api.SolidColor(0.7, 0.3, 0.2))),
        api.Quad((-5, 0, -5), (10, 0, 0), (0, 0, 10), mapped),
        api.Quad((-1, 4, -1), (2, 0, 0), (0, 0, 2),
                 api.DiffuseLight(6, 6, 6)),
    ]
    # level with the sphere's center: its poles, where the tangent of
    # (n_raw.z, 0, -n_raw.x) turns fast, lie on its silhouette
    camera = api.CameraConfig(vertical_fov_degrees=40.0, aperture_size=0.0,
                              look_from=(0.0, 1.0, 6.0),
                              look_at=(0.5, 0.9, 0.0))
    return api.Scene(api.Bvh(world), camera, (0.3, 0.4, 0.6), cfg)


def hotquad_scene(cfg, api):
    """One large quad of one solid colour filling most of the view, a small
    sphere light above it and the background past its far edge: most
    lanes hit one planar row and read one texel row, the hottest rows
    FHB's sums meet."""
    world = [
        api.Quad((-4, 0, -4), (8, 0, 0), (0, 0, 8),
                 api.Lambertian(api.SolidColor(0.6, 0.5, 0.3))),
        api.Sphere((0.0, 3.0, 0.0), 0.3, api.DiffuseLight(5, 5, 5)),
    ]
    camera = api.CameraConfig(vertical_fov_degrees=50.0, aperture_size=0.0,
                              look_from=(0.0, 4.0, 4.0),
                              look_at=(0.0, 0.0, -0.5))
    return api.Scene(api.Bvh(world), camera, (0.3, 0.4, 0.6), cfg)


# scenes of this file's own, beside test_torch_first_hit.py's fixtures
OWN = {"spheremap": spheremap_scene, "hotquad": hotquad_scene}
ALL = FIXTURES + ["spheremap"]


def _scene(compiled, name):
    """(JAX compiled scene, port compiled scene on the CPU)."""
    if name not in OWN:
        return compiled(name)
    if name not in _COMPILED:
        def cfg(api):
            return api.RenderConfig(width=W, height=H, samples_per_pixel=2,
                                    seed=SEED)

        _COMPILED[name] = (jcompile(OWN[name](cfg(J), J)),
                           tcompile(OWN[name](cfg(T), T), device="cpu"))
    return _COMPILED[name]


def _args(compiled, name):
    """(cj, ct, JAX arguments, port arguments): ``o, d, pix, sample,
    seed`` of the same rays on both sides."""
    if name not in OWN:
        return _jax_and_port(compiled, name)
    cj, ct = _scene(compiled, name)
    pix, o, d = _rays(name, ct)
    jargs = (tuple(jnp.asarray(o[:, k]) for k in range(3)),
             tuple(jnp.asarray(d[:, k]) for k in range(3)),
             jnp.asarray(pix.astype(np.int32)), jnp.int32(SAMPLE),
             jnp.int32(SEED))
    targs = (tuple(torch.from_numpy(o[:, k].copy()) for k in range(3)),
             tuple(torch.from_numpy(d[:, k].copy()) for k in range(3)),
             torch.from_numpy(pix), SAMPLE, SEED)
    return cj, ct, jargs, targs


def _port_hit(ct, targs):
    """The port's depth-0 hit of the rays (``step_hit``, K1's planar slot
    decoded), as (t, kind, idx) numpy arrays."""
    o, d, pix, sample, seed = targs
    samp, bounce = TI._depth0(pix, sample)
    t, kind, idx = TI.step_hit(ct, o, d, pix, samp, bounce, seed)
    if kind is None:
        kind, idx = TB.decode_planar_slot(ct.solids, idx)
    return tuple(x.numpy() for x in (t, kind, idx))


@pytest.fixture
def same_hit(monkeypatch):
    """Hands the port's hit to JAX's shading (its integrator's scene_hit
    returns it): both packages then shade the same hit, so that the
    comparison is of the shading and its reverse, not of two hit formulas
    whose t round apart in the last bits (a texel picked across a
    boundary, a sphere's frame near its pole)."""
    def use(ct, targs):
        hit = tuple(jnp.asarray(x) for x in _port_hit(ct, targs))
        monkeypatch.setattr(JI, "scene_hit", lambda *a, **k: hit)

    return use


def _weights(r, n, seed=11):
    """``n`` seeded (R, 3) f32 weights."""
    g = np.random.default_rng(seed)
    return [g.standard_normal((r, 3)).astype(np.float32) for _ in range(n)]


def _close(got, want, scale, name):
    """A sum against another: within 1e-5 of the magnitudes summed into
    each entry (``scale``), and 1e-6."""
    got, want, scale = (np.asarray(x, dtype=np.float64)
                        for x in (got, want, scale))
    assert np.isfinite(got).all() and np.isfinite(want).all(), name
    bad = np.abs(got - want) > 1e-5 * scale + 1e-6
    assert not bad.any(), (name, int(bad.sum()),
                           float(np.abs(got - want).max()))


# --- paths of a compiled scene's float tables -------------------------------

def _float_paths(x, path=()):
    """The paths (tuples of field names and tuple indices) of every
    floating-point array of a compiled scene (the port's or JAX's),
    through its dataclasses and tuples."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [p for f in dataclasses.fields(x)
                for p in _float_paths(getattr(x, f.name), path + (f.name,))]
    if isinstance(x, tuple):
        return [p for i, v in enumerate(x) for p in _float_paths(v, path
                                                                + (i,))]
    if isinstance(x, torch.Tensor):
        return [path] if x.is_floating_point() else []
    if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating):
        return [path]
    return []


def _get(x, path):
    for k in path:
        x = x[k] if isinstance(k, int) else getattr(x, k)
    return x


def _set(x, path, value):
    """``x`` with the array at ``path`` replaced by ``value``."""
    if not path:
        return value
    k = path[0]
    if isinstance(k, int):
        return tuple(_set(v, path[1:], value) if i == k else v
                     for i, v in enumerate(x))
    return dataclasses.replace(x, **{k: _set(getattr(x, k), path[1:],
                                             value)})


def _leaves(ct, paths):
    """(the port's scene with each table at ``paths`` a new leaf that
    requires grad, the leaves)."""
    leaves = {}
    for p in paths:
        leaves[p] = _get(ct, p).detach().clone().requires_grad_(True)
        ct = _set(ct, p, leaves[p])
    return ct, leaves


ARENA, BG = ("textures", "pixels"), ("bg_color",)
SPH, PL = ("solids", "sph_attr"), ("solids", "pl_attr")
CAMERA = tuple(("camera", f) for f in FH.CAMERA_FIELDS)


# --- (a) the arena and the background against jax.grad ----------------------

def _jax_planes(c, jargs, plane):
    if plane == "aux":
        return JI.first_hit_aux(c, *jargs)
    return (getattr(JI, f"shade_{plane}")(c, *jargs),)


def _port_planes(c, targs, plane):
    if plane == "aux":
        return TI.first_hit_aux(c, *targs)
    return (getattr(TI, f"shade_{plane}")(c, *targs),)


def _magnitudes(ct, targs, planes):
    """The magnitudes FHB's sums add on the port's rays: the arena's (N,
    3) and the background's (3,), and sph_attr's and pl_attr's, for the
    upstream gradients ``planes`` ({plane: (R, 3)}) of one FH call
    (``first_hit_planes``' hit)."""
    o, d, pix, sample, seed = targs
    shader = {"albedo": TI.SHADER_ALBEDO, "normal": TI.SHADER_NORMAL,
              "simple": TI.SHADER_SIMPLE}
    samp, bounce = TI._depth0(pix, sample)
    hit = TI.step_hit(ct, o, d, pix, samp, bounce, seed)
    sums = torch.zeros((ct.textures.pixels.shape[0] + 1, 3))
    g_sph = torch.zeros_like(ct.solids.sph_attr)
    g_pl = torch.zeros_like(ct.solids.pl_attr)
    for k, g in planes.items():
        g_planes = (dict(albedo=g[0], normal=g[1]) if k == "aux" else
                    dict(color=g[0]))
        FH.first_hit_backward_plain(
            ct, *hit, o, d, pix, sample, seed, ct.textures.pixels.detach(),
            g_planes, shader.get(k), sums, g_sph=g_sph, g_pl=g_pl,
            magnitudes=True)
    return sums[:-1], sums[-1], g_sph, g_pl


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("name", ALL)
def test_arena_and_background_grad_matches_jax(compiled, same_hit, name,
                                               plane):
    """(a) jax.grad of a seeded weighted sum of a plane (the two aux
    planes, or a debug shader's color) through JAX's own first_hit_aux /
    shade_* against torch.autograd.grad through the port's public
    functions (the FH Function; its plain backward here): the arena's and
    the background's gradients within 1e-5 of the magnitudes summed into
    each entry, and 1e-6, both packages shading the port's hit
    (``same_hit``); each non-zero somewhere where JAX's is (a closed room's
    rays all hit; the normal shader reads texels only through a normal
    map), the arena's but for the normal shader always."""
    cj, ct, jargs, targs = _args(compiled, name)
    same_hit(ct, targs)
    r = targs[2].shape[0]
    ws = _weights(r, 2 if plane == "aux" else 1)

    def f(p, bg):
        c = dataclasses.replace(cj, textures=dataclasses.replace(
            cj.textures, pixels=p), bg_color=bg)
        return sum(jnp.sum(x * w) for x, w in
                   zip(_jax_planes(c, jargs, plane), ws))

    gj = jax.grad(f, argnums=(0, 1))(cj.textures.pixels, cj.bg_color)
    c, leaves = _leaves(ct, (ARENA, BG))
    out = _port_planes(c, targs, plane)
    loss = sum((x * torch.from_numpy(w)).sum() for x, w in zip(out, ws))
    g_arena, g_bg = torch.autograd.grad(loss, [leaves[ARENA], leaves[BG]])
    s_arena, s_bg, _, _ = _magnitudes(ct, targs, {plane: [
        torch.from_numpy(w) for w in ws]})
    _close(g_arena, gj[0], s_arena, "arena")
    _close(g_bg, gj[1], s_bg, "background")
    for g, w in zip((g_arena, g_bg), gj):
        assert bool((g != 0).any()) == bool((np.asarray(w) != 0).any())
    assert plane == "normal" or (g_arena != 0).any()


@pytest.mark.parametrize("plane", PLANES)
def test_hot_row_grad_matches_jax(compiled, same_hit, plane):
    """(a) on the hottest rows (``hotquad``: most lanes hit one quad of
    one solid colour, so that their gradients meet in one texel row and
    one frame row, as FHB's block tables sum them on the card): jax.grad
    of a seeded weighted sum of a plane through JAX's own first_hit_aux /
    shade_* with respect to the arena, the background and pl_attr, both
    packages shading the port's hit (``same_hit``; t a constant, so
    pl_attr's gradient is its frame's), against torch.autograd.grad
    through the port's public functions (their plain backward here):
    within 1e-5 of the magnitudes summed into each entry, and 1e-6; the
    quad's frame row non-zero."""
    cj, ct, jargs, targs = _args(compiled, "hotquad")
    same_hit(ct, targs)
    t, kind, idx = _port_hit(ct, targs)
    quad = np.isfinite(t) & (kind == 1) & (idx == 0)
    assert quad.mean() > 0.5, quad.mean()
    r = targs[2].shape[0]
    ws = _weights(r, 2 if plane == "aux" else 1, seed=29)

    def f(p, bg, pl):
        c = dataclasses.replace(
            cj, textures=dataclasses.replace(cj.textures, pixels=p),
            bg_color=bg, solids=dataclasses.replace(cj.solids, pl_attr=pl))
        return sum(jnp.sum(x * w) for x, w in
                   zip(_jax_planes(c, jargs, plane), ws))

    gj = jax.grad(f, argnums=(0, 1, 2))(cj.textures.pixels, cj.bg_color,
                                        cj.solids.pl_attr)
    c, leaves = _leaves(ct, (ARENA, BG, PL))
    out = _port_planes(c, targs, plane)
    loss = sum((x * torch.from_numpy(w)).sum() for x, w in zip(out, ws))
    got = torch.autograd.grad(loss, [leaves[p] for p in (ARENA, BG, PL)])
    s_arena, s_bg, _, s_pl = _magnitudes(ct, targs, {plane: [
        torch.from_numpy(w) for w in ws]})
    for label, g, w, m in zip(("arena", "background", "pl_attr"), got, gj,
                              (s_arena, s_bg, s_pl)):
        _close(g, w, m, label)
    assert plane == "albedo" or (got[2][0] != 0).any()
    assert plane == "normal" or (got[0] != 0).any()


# --- (b) and (e): the rays and every float table against JAX's pieces -------

def _jax_detached(c, o, d, pix, sample, seed, hit):
    """The aux planes, the simple shader's color and the normal shader's
    from JAX's pieces on the hit ``hit`` (t, kind, idx as scene_hit gives
    them) under stop_gradient (no cotangent, as the JAX package's detached
    kernels give none): first_hit_aux's body and shade_simple's and
    shade_normal's."""
    t, kind, idx = jax.lax.stop_gradient(hit)
    hit = jnp.isfinite(t)
    t_safe = jnp.where(hit, t, 0.0)
    attrs = JI.full_hit_attributes(c, o, d, t_safe, kind, idx, pix, sample,
                                   0, seed)
    sc = JI.scatter(c, o, d, attrs, pix, sample, 0, seed)
    n = sc["shading_normal"]
    factor = (n[0] * 1.0 + n[1] * 1.0 + n[2] * -1.0) * 0.5 + 0.75
    u_bn = JR.uniform4(pix, sample, 0, JR.P_BLEND_NORMAL, seed)
    eff_n = JI.resolve_blend(c.materials, attrs["mat"], u_bn, c.features)
    nrm = JI.shading_normal_of(c, eff_n, attrs)
    albedo = jnp.stack([jnp.where(hit, jnp.where(
        sc["is_emission"], sc["emit_color"][k], sc["tape_color"][k]),
        c.bg_color[k]) for k in range(3)], -1)
    normal = jnp.stack([jnp.where(hit, n[k], 0.0) for k in range(3)], -1)
    simple = jnp.stack([jnp.where(hit, jnp.where(
        sc["is_emission"], sc["emit_color"][k],
        sc["tape_color"][k] * factor), c.bg_color[k]) for k in range(3)],
        -1)
    shade_n = jnp.stack([jnp.where(hit, nrm[k], c.bg_color[k])
                         for k in range(3)], -1)
    return albedo, normal, simple, shade_n


_DETACHED = {}


def _detached_grads(compiled, name):
    """JAX's and the port's gradients of one seeded weighted sum of the
    four planes of ``_jax_detached`` on the port's hit (on the port:
    ``first_hit_planes`` with the simple shader and the aux planes, and
    with the normal shader) with respect to the rays and every float
    table of the
    compiled scene: ({"o0".. "d2": (R,)}, {path: table}) each, and the
    magnitudes of the frame tables' sums; once a scene."""
    if name in _DETACHED:
        return _DETACHED[name]
    cj, ct, jargs, targs = _args(compiled, name)
    paths = [p for p in _float_paths(ct) if p in set(_float_paths(cj))]
    r = targs[2].shape[0]
    ws = _weights(r, 4, seed=13)
    hit = _port_hit(ct, targs)

    def f(o, d, tables):
        c = cj
        for p, v in zip(paths, tables):
            c = _set(c, p, v)
        return sum(jnp.sum(x * w) for x, w in zip(_jax_detached(
            c, o, d, *jargs[2:], tuple(jnp.asarray(x) for x in hit)), ws))

    g_o, g_d, g_t = jax.grad(f, argnums=(0, 1, 2))(
        jargs[0], jargs[1], [_get(cj, p) for p in paths])
    want = ({k: np.asarray(v) for k, v in zip(FH.RAY, (*g_o, *g_d))},
            {p: np.asarray(g) for p, g in zip(paths, g_t)})
    c, leaves = _leaves(ct, paths)
    ray = [x.clone().requires_grad_(True) for x in (*targs[0], *targs[1])]
    args = (tuple(ray[:3]), tuple(ray[3:]), *targs[2:])
    simple = TI.first_hit_planes(c, *args, TI.SHADER_SIMPLE, aux=True)
    shade_n = TI.first_hit_planes(c, *args, TI.SHADER_NORMAL)["color"]
    out = (simple["albedo"], simple["normal"], simple["color"], shade_n)
    loss = sum((x * torch.from_numpy(w)).sum() for x, w in zip(out, ws))
    grads = torch.autograd.grad(loss, ray + [leaves[p] for p in paths],
                                allow_unused=True)
    got = ({k: g.numpy() for k, g in zip(FH.RAY, grads[:6])},
           {p: None if g is None else g.numpy()
            for p, g in zip(paths, grads[6:])})
    w = [torch.from_numpy(x) for x in ws]
    mags = _magnitudes(ct, targs, {"aux": w[:2], "simple": [w[2]],
                                   "normal": [w[3]]})
    _DETACHED[name] = (want, got, mags)
    return _DETACHED[name]


@pytest.mark.parametrize("name", ALL)
def test_ray_and_frame_grad_matches_jax(compiled, name):
    """(b) The rays' gradients (per lane, rtol 1e-4, atol 1e-5) and the
    frame columns of sph_attr and pl_attr (within 1e-5 of the magnitudes
    summed into each entry, and 1e-6) against JAX's detached pieces; the
    arena and the background as (a). A sphere hit under a normal map
    occurs on spheremap, and its rays and centers take gradients."""
    want, got, (s_arena, s_bg, s_sph, s_pl) = _detached_grads(compiled,
                                                             name)
    for k in FH.RAY:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    _close(got[1][ARENA], want[1][ARENA], s_arena, "arena")
    _close(got[1][BG], want[1][BG], s_bg, "background")
    _close(got[1][PL], want[1][PL], s_pl, "pl_attr")
    sph = got[1].get(SPH)
    if sph is not None:
        _close(sph, want[1][SPH], s_sph, "sph_attr")
    if name == "spheremap":
        assert (sph[:, :3] != 0).all()
        assert all((got[0][k] != 0).any() for k in FH.RAY)


@pytest.mark.parametrize("name", ALL)
def test_other_float_tables_get_no_grad(compiled, name):
    """(e) Every float table of the compiled scene but the arena, the
    background and the frame columns, made a leaf that requires grad,
    gets no gradient or a zero one, as JAX's is zero; so do sph_attr's
    and pl_attr's other columns on both sides."""
    want, got, _ = _detached_grads(compiled, name)
    frame = {SPH: [0, 1, 2], PL: [0, 1, 2, 11, 12, 13, 14, 15, 16]}
    checked = 0
    for p, g in got[1].items():
        if p in (ARENA, BG):
            continue
        w = want[1][p]
        if p in frame:
            keep = np.ones(w.shape[1], bool)
            keep[frame[p]] = False
            w = w[:, keep]
            g = None if g is None else g[:, keep]
        assert (w == 0).all(), p
        assert g is None or (g == 0).all(), p
        checked += 1
    assert checked >= 20


# --- (c) the camera ---------------------------------------------------------

@pytest.mark.parametrize("name", ["small", "kitchen", "sponza24"])
def test_camera_grad_matches_jax(compiled, name):
    """(c) jax.grad of a seeded weighted sum of JAX's camera_rays (a
    shuffled list of pixel ids) against the CR Function's, for the
    camera's seven tensors, with a lens (small, kitchen) and without
    (sponza24; lens_radius and the lens basis get 0), within 1e-5 of the
    magnitudes summed into each value (``camera_rays_backward_plain(...,
    magnitudes=True)``), and 1e-6."""
    cj, ct = _scene(compiled, name)
    pix = np.random.default_rng(3).permutation(W * H)[:300]
    ws = _weights(pix.shape[0], 2, seed=17)

    def f(cam):
        c = dataclasses.replace(cj, camera=cam)
        _, o, d = JI.camera_rays(c, jnp.asarray(pix.astype(np.int32)), W, H,
                                 jnp.int32(SAMPLE), jnp.int32(SEED))
        return (jnp.sum(jnp.stack(o, -1) * ws[0])
                + jnp.sum(jnp.stack(d, -1) * ws[1]))

    gj = jax.grad(f)(cj.camera)
    c, leaves = _leaves(ct, CAMERA)
    tp = torch.from_numpy(pix)
    before = FH.camera_rays.launches
    _, o, d = TI.camera_rays(c, tp, W, H, SAMPLE, SEED)
    assert FH.camera_rays.launches == before
    loss = ((torch.stack(o, -1) * torch.from_numpy(ws[0])).sum()
            + (torch.stack(d, -1) * torch.from_numpy(ws[1])).sum())
    got = torch.autograd.grad(loss, [leaves[p] for p in CAMERA])
    g_ray = torch.from_numpy(np.concatenate(ws, 1).T.copy())
    mags = FH.camera_rays_backward_plain(ct, tp, SAMPLE, SEED, W, H, g_ray,
                                         magnitudes=True)
    lens = float(ct.camera.lens_radius) > 0
    assert lens == (name != "sponza24")
    for field, g, m in zip(FH.CAMERA_FIELDS, got, mags):
        _close(g, getattr(gj, field), m, field)
        if not lens and field in ("u", "v", "lens_radius"):
            assert (g == 0).all()
        elif field != "lens_radius" or lens:
            assert (g != 0).any(), field


# --- (d) each plain backward against autograd through its plain forward -----

@pytest.mark.parametrize("shader", [None, TI.SHADER_ALBEDO, TI.SHADER_NORMAL,
                                    TI.SHADER_SIMPLE])
@pytest.mark.parametrize("name", ALL)
def test_first_hit_backward_plain_matches_autograd(compiled, name, shader):
    """(d) first_hit_backward_plain against torch.autograd.grad through
    first_hit_plain (every plane FH writes with the shader: the color,
    and both aux planes; without a shader the aux planes alone), from
    step_hit's hit (K1's planar slot on sponza24): the rays' gradients per
    lane to rtol = atol = 1e-6, the arena's, the background's and the
    frame tables' sums within 1e-5 of the magnitudes, and 1e-6."""
    _, ct, _, targs = _args(compiled, name)
    o, d, pix, sample, seed = targs
    samp, bounce = TI._depth0(pix, sample)
    hit = TI.step_hit(ct, o, d, pix, samp, bounce, seed)
    assert (hit[1] is None) == (name == "sponza24")
    c, leaves = _leaves(ct, (ARENA, BG, SPH, PL))
    ray = [x.clone().requires_grad_(True) for x in (*o, *d)]
    planes = TI.first_hit_plain(c, tuple(ray[:3]), tuple(ray[3:]), *hit, pix,
                                sample, seed, shader, True, True)
    r = pix.shape[0]
    ws = dict(zip(FH.PLANES, (torch.from_numpy(w)
                              for w in _weights(r, 3, seed=19))))
    g_planes = {k: ws[k] if planes[k] is not None else None
                for k in FH.PLANES}
    loss = sum((planes[k] * g).sum() for k, g in g_planes.items()
               if g is not None)
    want = torch.autograd.grad(loss, ray + [leaves[p] for p in
                                            (ARENA, BG, SPH, PL)],
                               allow_unused=True)
    n = ct.textures.pixels.shape[0]
    sums, mags = torch.zeros((n + 1, 3)), torch.zeros((n + 1, 3))
    g_sph, m_sph = (torch.zeros_like(ct.solids.sph_attr) for _ in range(2))
    g_pl, m_pl = (torch.zeros_like(ct.solids.pl_attr) for _ in range(2))
    got = FH.first_hit_backward_plain(ct, *hit, o, d, pix, sample, seed,
                                      ct.textures.pixels, g_planes, shader,
                                      sums, g_sph=g_sph, g_pl=g_pl)
    FH.first_hit_backward_plain(ct, *hit, o, d, pix, sample, seed,
                                ct.textures.pixels, g_planes, shader, mags,
                                g_sph=m_sph, g_pl=m_pl, magnitudes=True)
    for k, a, b in zip(FH.RAY, got, want[:6]):
        b = torch.zeros_like(a) if b is None else b
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6, msg=k)
    for label, a, b, m in (("arena", sums[:-1], want[6], mags[:-1]),
                           ("background", sums[-1], want[7], mags[-1]),
                           ("sph_attr", g_sph, want[8], m_sph),
                           ("pl_attr", g_pl, want[9], m_pl)):
        _close(a, torch.zeros_like(a) if b is None else b, m, label)


@pytest.mark.parametrize("name", ["small", "sponza24"])
def test_camera_backward_plain_matches_autograd(compiled, name):
    """(d) camera_rays_backward_plain against torch.autograd.grad through
    camera_rays_plain, with a lens (small) and without (sponza24), within
    1e-5 of the magnitudes, and 1e-6."""
    _, ct = _scene(compiled, name)
    pix = torch.from_numpy(np.random.default_rng(3).permutation(W * H)[:300])
    c, leaves = _leaves(ct, CAMERA)
    o, d = TI.camera_rays_plain(c, pix, SAMPLE, SEED, W, H)
    g_ray = torch.from_numpy(np.concatenate(_weights(300, 2, seed=23), 1)
                             .T.copy())
    loss = (torch.stack([*o, *d]) * g_ray).sum()
    want = torch.autograd.grad(loss, [leaves[p] for p in CAMERA])
    got = FH.camera_rays_backward_plain(ct, pix, SAMPLE, SEED, W, H, g_ray)
    mags = FH.camera_rays_backward_plain(ct, pix, SAMPLE, SEED, W, H, g_ray,
                                         magnitudes=True)
    for field, a, b, m in zip(FH.CAMERA_FIELDS, got, want, mags):
        assert a.shape == b.shape, field
        _close(a, b, m, field)


# --- (f) the routes ---------------------------------------------------------

def _route_leaves(ct):
    return _leaves(ct, (ARENA, BG, SPH, PL) + CAMERA)


@pytest.mark.parametrize("name", ALL)
def test_render_pixels_debug_route_matches_plain_autograd(compiled, name):
    """(f) render_pixels with the simple shader and the aux planes
    (CameraRaysFn, then FirstHitFn: one call of each, and one plain
    backward of each) against autograd through camera_rays_plain and
    first_hit_plain from the same hit: the same planes, and the arena's,
    the background's, the frame tables' and the camera's gradients within
    1e-4 of each other's magnitude (rtol 1e-4, atol 1e-5)."""
    _, ct = _scene(compiled, name)
    pix = torch.arange(W * H)
    ws = [torch.from_numpy(w) for w in _weights(W * H, 3, seed=29)]
    c, leaves = _route_leaves(ct)
    calls = {"cr": 0, "fh": 0, "crb": 0, "fhb": 0}
    fns = {"cr": "camera_rays_plain", "fh": "first_hit_plain"}

    def counted(key, fn):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call

    with pytest.MonkeyPatch.context() as mp:
        for key, attr in fns.items():
            mp.setattr(TI, attr, counted(key, getattr(TI, attr)))
        mp.setattr(FH, "camera_rays_backward_plain",
                   counted("crb", FH.camera_rays_backward_plain))
        mp.setattr(FH, "first_hit_backward_plain",
                   counted("fhb", FH.first_hit_backward_plain))
        out = TI.render_pixels(c, pix, SAMPLE, SEED, width=W, height=H,
                               max_depth=5, shader_kind=TI.SHADER_SIMPLE,
                               need_aux=True)
        loss = sum((x * w).sum() for x, w in zip(out, ws))
        got = torch.autograd.grad(loss, list(leaves.values()))
    assert calls == {"cr": 1, "fh": 1, "crb": 1, "fhb": 1}
    c2, leaves2 = _route_leaves(ct)
    o, d = TI.camera_rays_plain(c2, pix, SAMPLE, SEED, W, H)
    samp, bounce = TI._depth0(pix, SAMPLE)
    hit = TI.step_hit(c2, o, d, pix, samp, bounce, SEED)
    planes = TI.first_hit_plain(c2, o, d, *hit, pix, SAMPLE, SEED,
                                TI.SHADER_SIMPLE, True, True)
    ref = (planes["color"], planes["albedo"], planes["normal"])
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    want = torch.autograd.grad(sum((x * w).sum() for x, w in zip(ref, ws)),
                               list(leaves2.values()), allow_unused=True)
    for p, a, b in zip(leaves, got, want):
        b = torch.zeros_like(a) if b is None else b
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=str(p))
        # the rays take gradients only through a sphere's frame
        if p == ARENA or (p == CAMERA[0] and "spheres" in ct.features):
            assert (a != 0).any(), p


@pytest.mark.parametrize("name", ["kitchen", "mixed16"])
def test_trace_and_aux_share_one_pass(compiled, name):
    """(f) The path shader's differentiable route with the aux planes
    (render_pixels(..., differentiable=True, need_aux=True)), whose trace
    (S1 with S1B's plain version) and FH (FHB's) each add the arena's and
    the background's gradients into a GradSums of one backward pass: the
    gradients are the trace's plus the aux planes', each taken alone (rtol
    1e-5, atol 1e-6), also where the scene given is already a grad_scene
    copy (its arena a sums sink's view, whose sums FH adds into)."""
    _, ct = _scene(compiled, name)
    w, h = 16, 8
    pix = torch.arange(w * h)
    ws = [torch.from_numpy(x) for x in _weights(w * h, 3, seed=31)]
    kw = dict(width=w, height=h, max_depth=4, differentiable=True)

    def grads(share):
        c, leaves = _leaves(ct, (ARENA, BG))
        if share:
            c = TS.grad_scene(c)
        out = TI.render_pixels(c, pix, SAMPLE, SEED,
                               shader_kind=TI.SHADER_PATH, need_aux=True,
                               **kw)
        loss = sum((x * wt).sum() for x, wt in zip(out, ws))
        return torch.autograd.grad(loss, [leaves[ARENA], leaves[BG]])

    c, leaves = _leaves(ct, (ARENA, BG))
    trace = TI.render_pixels(c, pix, SAMPLE, SEED, shader_kind=TI.SHADER_PATH,
                             need_aux=False, **kw)[0]
    alone = torch.autograd.grad((trace * ws[0]).sum(),
                                [leaves[ARENA], leaves[BG]])
    c, leaves = _leaves(ct, (ARENA, BG))
    _, o, d = TI.camera_rays(c, pix, w, h, SAMPLE, SEED)
    aux = TI.first_hit_aux(c, o, d, pix, SAMPLE, SEED)
    aux_g = torch.autograd.grad(sum((x * wt).sum() for x, wt in
                                    zip(aux, ws[1:])),
                                [leaves[ARENA], leaves[BG]])
    for share in (False, True):
        for a, t, x in zip(grads(share), alone, aux_g):
            torch.testing.assert_close(a, t + x, rtol=1e-5, atol=1e-6)
    assert (aux_g[0] != 0).any() and (alone[0] != 0).any()


def test_route_without_grad_takes_no_function(compiled):
    """With nothing that requires grad (or grad mode off), CR and FH take
    their plain versions directly on the CPU: no Function node, no
    backward call, the same bits as before."""
    _, ct = _scene(compiled, "kitchen")
    pix = torch.arange(W * H)
    c, leaves = _leaves(ct, (ARENA,))
    with torch.no_grad():
        out = TI.render_pixels(c, pix, SAMPLE, SEED, width=W, height=H,
                               max_depth=5, shader_kind=TI.SHADER_SIMPLE,
                               need_aux=True)
    assert all(x.grad_fn is None for x in out)
    plain = TI.render_pixels(ct, pix, SAMPLE, SEED, width=W, height=H,
                             max_depth=5, shader_kind=TI.SHADER_SIMPLE,
                             need_aux=True)
    assert all(x.grad_fn is None for x in plain)
    assert all(torch.equal(a, b) for a, b in zip(out, plain))


@pytest.mark.parametrize("name", ["kitchen", "mixed16"])
def test_inverse_step_takes_no_function(compiled, name, monkeypatch):
    """The inverse step (``diff.render_linear`` with the arena requiring
    grad, then its backward) never enters CR's or FH's Function, and
    dispatches the same ops in every step after the first (which packs the
    scene's tables once): ``wavefront_ab.dispatched_ops_mode``,
    which phase 5 of chip_smoke.py holds to the count of the tree before
    the Functions, counts the ops that are not views (a view and a detach
    none, an add and a sum one each)."""
    from solstrale_tpu_torch import diff as TD
    from solstrale_tpu_torch.wavefront_ab import dispatched_ops_mode

    x = torch.arange(6.0)
    with dispatched_ops_mode() as ops:
        (x.view(2, 3).t().detach() + 1).sum()
    assert ops.n == 2, ops.n

    def refuse(*args):
        raise AssertionError("the inverse step entered a first-hit Function")

    monkeypatch.setattr(FH.CameraRaysFn, "apply", refuse)
    monkeypatch.setattr(FH.FirstHitFn, "apply", refuse)
    _, ct = _scene(compiled, name)
    w, h = 16, 8
    target = torch.from_numpy(_weights(w * h, 1, seed=41)[0])
    seen = []
    for _ in range(3):
        c, leaves = _leaves(ct, (ARENA,))
        with dispatched_ops_mode() as fwd:
            img = TD.render_linear(c, width=w, height=h, max_depth=4,
                                   n_samples=1, seed=SEED)
            loss = torch.mean((img - target) ** 2)
        with dispatched_ops_mode() as bwd:
            g, = torch.autograd.grad(loss, leaves[ARENA])
        assert torch.isfinite(g).all() and (g != 0).any()
        seen.append((fwd.n, bwd.n))
    assert seen[1] == seen[2] and min(seen[1]) > 0, seen
