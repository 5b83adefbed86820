"""The differentiable route's bounce on the CPU: S1 with its record and S1B
(``ops.step.step_shade_grad``, an autograd Function) through their plain
versions, ``shade_plain(..., record=True)`` and
``step_shade_backward_plain``, on six scenes at small size (the untextured
interior cut to 3,200 triangles, the textured interior, production,
many_lights, the mixed BVH scene and the normal-mapped kitchen), checked:

(a) the plain backward against ``torch.autograd.grad`` through
    ``shade_plain`` in trace's carry form (the route before S1B) lane by
    lane, over chained bounces that reach the depth cap, with folds drawn
    from a numpy seed so that ``torch.minimum``'s ties (A = B = 0: a black
    albedo; B = 3A) and NaN operands (B = NaN) occur, and dead channels:
    the carried color's and the fold's gradients exactly, the arena's and
    the background's to rtol 1e-6;
(b) ``trace(..., differentiable=True)``'s whole-image gradient of the
    arena and the background against the JAX package's ``jax.grad`` of
    ``render_linear`` (16x8, depth 4, 1 spp; tests/test_torch_diff.py's
    rtol 1e-3, atol 1e-4, on the entries where JAX's is finite);
(c) a normal map's texels get a gradient of exactly 0;
(d) the material table's gradient (its attenuation column) against the
    JAX package's, and the route raises where another scene table
    requires grad;
(e) the arena's and the background's gradients summed in one buffer a
    backward pass (``ops.step.GradSums``) against the route before it,
    which zeroed a buffer every S1B call and let autograd add them
    (``_per_call_shade_grad``, kept here over ``step_shade_backward_plain``),
    with two samples and the bounces checkpointed one a chunk; one zero
    fill of the arena's size a trace and a backward pass, and no per-bounce
    add; a second backward over a retained graph gives the same gradient,
    not twice it, and leaves the first one as it was;
(f) the lanes whose fold gradients S1B passes through without reading
    the fold (no branch, no texel, a zero pdf weight, a zero color
    gradient) get the same bits from the full formula.
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
from solstrale_tpu_torch.ops import bvh as TB
from solstrale_tpu_torch.ops import step as S
from solstrale_tpu_torch.renderer import integrator as TI
from solstrale_tpu_torch.profiling import ArenaOps
from solstrale_tpu_torch.scene.compile import compile_scene as tcompile

torch.set_num_threads(2)

SEED = 1
SCENES = {
    # BVH, no textures: the main path's interior cut to 3,200 triangles
    "sponza": lambda c, api: fixtures.sponza_class_scene(c, n_cells=40,
                                                         api=api),
    # BVH without spheres or media: S1 decodes K1's planar slot
    "sponza_textured": lambda c, api: fixtures.sponza_textured_scene(
        c, n_cells=16, tex_size=32, api=api),
    # every material kind, blends, a normal map, four emitters
    "production": lambda c, api: fixtures.sponza_production_scene(
        c, n_cells=16, tex_size=32, api=api),
    # 20 sphere emitters: the batched light pdf
    "many_lights": lambda c, api: fixtures.many_light_scene(
        c, n_lights=20, n_cells=16, api=api),
    # blend floor, normal map, image textures, a medium, metal, dielectric
    "mixed": lambda c, api: fixtures.mixed_bvh_scene(c, n_cells=16, api=api),
    # no BVH (K4): normal map, image texture, triangles, a medium
    "kitchen": lambda c, api: fixtures.kitchen_sink_scene(c, api=api),
}
NORMAL_MAPPED = ["sponza_textured", "production", "mixed", "kitchen"]


def _compile(name, api, w, h):
    cfg = api.RenderConfig(width=w, height=h, samples_per_pixel=1, seed=SEED)
    scene = SCENES[name](cfg, api)
    return jcompile(scene) if api is J else tcompile(scene, device="cpu")


def _fold(g, r):
    """A fold from the numpy generator ``g``: A in [0, 2) with one lane in
    five 0; B drawn, or 3A (a tie at a pdf level), inf, NaN or 0 (with A =
    0 a tie at the terminal color, as a black albedo makes it); about one
    channel in ten dead, outer on half the lanes."""
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
        A.append(a)
        B.append(b)
    dead = tuple(torch.from_numpy(g.random(r) < 0.1) for _ in range(3))
    return tuple(A), tuple(B), dead, torch.from_numpy(g.random(r) < 0.5)


def _with_leaves(cs, arena, bg):
    return dataclasses.replace(TD.set_texture_params(cs, arena), bg_color=bg)


@pytest.mark.parametrize("name", list(SCENES))
def test_plain_backward_matches_autograd(name):
    """(a) S1B's plain version from S1's record against autograd through
    shade_plain in the carry form (a carried color from a second numpy
    seed), three chained bounces of 768 lanes at depth cap 2: the carried
    color's and the fold's gradients bit for bit, the arena's and the
    background's to rtol 1e-6; the record's S1 outputs equal shade_plain's
    without it; ties, NaN operands, dead channels and capped lanes all
    occur."""
    w, h, depth = 32, 24, 2
    cs = _compile(name, T, w, h)
    g = np.random.default_rng(7)
    pix = torch.arange(w * h, dtype=torch.int64)
    r = pix.shape[0]
    o, d = TI.camera_rays_plain(cs, pix, 1, SEED, w, h)
    bounce = torch.from_numpy(g.integers(0, depth + 1, r).astype(np.int32))
    acc_len = torch.zeros(r)
    active = torch.from_numpy(g.random(r) > 0.1)
    seen = dict(ties=0, nan=0, dead=0, capped=0, scat=0, emit=0, miss=0)
    g_carry_draws = np.random.default_rng(8)
    for _ in range(3):
        A, B, dead, outer = _fold(g, r)
        t, kind, idx = TI.step_hit(cs, o, d, pix, 1, bounce, SEED)
        if kind is None:
            kind, idx = TB.decode_planar_slot(cs.solids, idx)
        args = (bounce, acc_len)
        tail = (pix, 1, SEED, active, depth)

        arena = cs.textures.pixels.clone().requires_grad_(True)
        bg = cs.bg_color.clone().requires_grad_(True)
        ab = [x.clone().requires_grad_(True) for x in (*A, *B)]
        carry = torch.from_numpy(g_carry_draws.normal(size=(r, 3)).astype(
            np.float32)).requires_grad_(True)
        st = TI.shade_plain(_with_leaves(cs, arena, bg), o, d, t, kind, idx,
                            *args, (ab[:3], ab[3:], dead, outer), *tail,
                            color=carry)
        g_color = torch.from_numpy(g.normal(size=(r, 3)).astype(np.float32))
        g_out = [torch.from_numpy(g.normal(size=r).astype(np.float32))
                 for _ in range(6)]
        want = torch.autograd.grad(
            [st["color"], *st["fold"][0], *st["fold"][1]],
            [*ab, arena, bg, carry], [g_color, *g_out], allow_unused=True,
            materialize_grads=True)

        with torch.no_grad():
            rec_st = TI.shade_plain(cs, o, d, t, kind, idx, *args,
                                    (A, B, dead, outer), *tail, record=True,
                                    color=carry)
        rec = rec_st["record"]
        assert rec.shape == (4, r) and rec.dtype == torch.int32
        for k in ("color",) + S.FLAGS:
            torch.testing.assert_close(rec_st[k], st[k].detach(), rtol=0,
                                       atol=0, equal_nan=True, msg=k)
        sums = torch.zeros((cs.textures.pixels.shape[0] + 1, 3))
        g_carry = torch.empty((r, 3))
        got_ab = S.step_shade_backward_plain(
            rec, (*A, *B), cs.textures.pixels, cs.bg_color, g_color, g_out,
            sums, g_carry=g_carry)
        for k, (a, b) in enumerate(zip(got_ab, want[:6])):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                       msg=f"fold input {k}")
        torch.testing.assert_close(g_carry, want[8], rtol=0, atol=0,
                                   equal_nan=True, msg="carried color")
        torch.testing.assert_close(sums[:-1], want[6], rtol=1e-6, atol=0)
        torch.testing.assert_close(sums[-1], want[7], rtol=1e-6, atol=0)

        # the lanes where a minimum's operands tie or one is NaN, with a
        # gradient to split: min(A t_c, B) at the terminal color (t_c the
        # background, an emitter's texel or 0), min(B, 3A) at a pdf level
        word, row = rec[3], rec[0]
        texel = cs.textures.pixels[torch.clamp(row, min=0).long()]
        for c in range(3):
            dead_t = (word & (S.REC_DEAD_T << c)) != 0
            pdf = (word & S.REC_PDF) != 0
            term = torch.where((word & S.REC_MISS) != 0, cs.bg_color[c],
                               torch.where((word & S.REC_EMIT_FRONT) != 0,
                                           texel[:, c], 0.0))
            x = A[c] * torch.where(dead_t, 0.0, term)
            seen["ties"] += int(((x == B[c]) & ~dead_t).sum()
                                + ((B[c] == 3.0 * A[c]) & pdf).sum())
            seen["nan"] += int((torch.isnan(B[c]) & ~dead_t).sum())
            seen["dead"] += int(dead_t.sum())
        for k in ("capped", "scat", "emit", "miss"):
            seen[k] += int(rec_st[k].sum())
        o, d = rec_st["o"], rec_st["d"]
        bounce, acc_len = rec_st["bounce"], rec_st["acc_len"]
    assert all(v > 0 for k, v in seen.items() if k != "emit"), seen


@pytest.fixture(scope="module")
def jax_grads():
    """{scene: (image, arena gradient, background gradient)} of sum(image)
    from the JAX package's render_linear at 16x8, depth 4, 1 spp, one
    jitted value_and_grad per scene, computed on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            cj = _compile(name, J, 16, 8)

            def f(p, bg):
                img = JD.render_linear(
                    dataclasses.replace(JD.set_texture_params(cj, p),
                                        bg_color=bg),
                    width=16, height=8, max_depth=4, n_samples=1, seed=SEED)
                return jnp.sum(img), img

            (_, img), (g_p, g_bg) = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(cj.textures.pixels,
                                                  cj.bg_color)
            cache[name] = (np.asarray(img), np.asarray(g_p),
                           np.asarray(g_bg))
        return cache[name]

    return get


def _route_grads(cs, w=16, h=8, depth=4):
    """(image, arena gradient, background gradient) of sum(image) through
    trace(..., differentiable=True) (render_linear)."""
    arena = cs.textures.pixels.detach().clone().requires_grad_(True)
    bg = cs.bg_color.detach().clone().requires_grad_(True)
    img = TD.render_linear(_with_leaves(cs, arena, bg), width=w, height=h,
                           max_depth=depth, n_samples=1, seed=SEED)
    g_arena, g_bg = torch.autograd.grad(img.sum(), (arena, bg))
    return img.detach(), g_arena, g_bg


# scenes whose JAX background gradient is NaN at this size although their
# image is finite: the NaN of a masked branch in JAX's backward, which the
# port's repair keeps out (ROADMAP C, reference side; the kitchen's arena
# has such rows too, tests/test_torch_diff.py's JAX_NAN_ROWS)
JAX_NAN_BG = {"production", "kitchen"}


@pytest.mark.parametrize("name", list(SCENES))
def test_route_grad_matches_jax(jax_grads, name, monkeypatch):
    """(b) The route's image and its whole-image gradients of the arena and
    the background against the JAX package's (rtol 1e-3, atol 1e-4; the
    arena on the entries where JAX's gradient is finite, at least 99%; the
    background where JAX's is finite, JAX_NAN_BG's scenes alone not), and
    both against autograd through the torch composition the route replaced
    (``path_step_plain``), to rtol 1e-5, atol 1e-7."""
    img_j, g_j, g_bg_j = jax_grads(name)
    cs = _compile(name, T, 16, 8)
    img, g, g_bg = _route_grads(cs)
    np.testing.assert_allclose(img.numpy(), img_j, rtol=1e-4, atol=1e-4)
    assert torch.isfinite(g).all() and (g != 0).any()
    assert torch.isfinite(g_bg).all() and (g_bg != 0).any()
    ok = np.isfinite(g_j)
    assert ok.mean() > 0.99
    np.testing.assert_allclose(g.numpy()[ok], g_j[ok], rtol=1e-3, atol=1e-4)
    assert np.isfinite(g_bg_j).all() == (name not in JAX_NAN_BG)
    if name not in JAX_NAN_BG:
        np.testing.assert_allclose(g_bg.numpy(), g_bg_j, rtol=1e-3,
                                   atol=1e-4)
    monkeypatch.setattr(TI, "path_step_grad", TI.path_step_plain)
    img_p, g_p, g_bg_p = _route_grads(cs)
    assert torch.equal(img, img_p)
    torch.testing.assert_close(g, g_p, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(g_bg, g_bg_p, rtol=1e-5, atol=1e-7)


def _normal_map_rows(cs):
    """The arena rows of the textures that only normal maps read."""
    attr = cs.materials.attr
    normal = set(attr[:, 2].int().tolist()) - {-1}
    albedo = set(attr[:, 1].int().tolist())
    rows = []
    for tex in sorted(normal - albedo):
        off, tw, th = (int(v) for v in cs.textures.attr[tex])
        rows.append(torch.arange(off, off + tw * th))
    return torch.cat(rows)


@pytest.mark.parametrize("name", NORMAL_MAPPED)
def test_normal_map_texels_get_no_gradient(name):
    """(c) The shading normal reaches only detached quantities (directions,
    pdf weights), so the whole-image gradient is exactly 0 on every texel of
    a normal map, and non-zero elsewhere."""
    cs = _compile(name, T, 16, 8)
    rows = _normal_map_rows(cs)
    assert rows.numel() > 0
    _, g, _ = _route_grads(cs)
    assert torch.equal(g[rows], torch.zeros_like(g[rows]))
    assert (g != 0).any()


def _attenuation_scene(api, w=16, h=12):
    """tests/scenes.py::create_light_attenuation_scene(rc, 0.5) through
    ``api``, line for line: a small attenuated sphere light over spheres
    on a red quad (no assets), compiled at w x h, seed 1."""
    rc = api.RenderConfig(width=w, height=h, samples_per_pixel=1, seed=SEED)
    camera = api.CameraConfig(vertical_fov_degrees=20.0, aperture_size=0.0,
                              look_from=(0.0, 1.0, 2.0),
                              look_at=(0.0, 0.2, 0.0))
    light = api.DiffuseLight(25.0, 25.0, 25.0, attenuation_half_length=0.5)
    world = [
        api.Sphere((0, 0.2, 0), 0.03, light),
        api.Sphere((0.25, 0.1, 0.25), 0.1,
                   api.Lambertian(api.SolidColor(0, 1, 0))),
        api.Sphere((0.25, 0.1, -0.5), 0.1,
                   api.Lambertian(api.SolidColor(0, 0, 1))),
        api.Sphere((-0.1, 0.1, -0.1), 0.1,
                   api.Dielectric(api.SolidColor(0.8, 0.8, 0.8), None, 1.5)),
        api.Quad((-1, 0, -1), (2, 0, 0), (0, 0, 2),
                 api.Lambertian(api.SolidColor(1, 0, 0))),
    ]
    scene = api.Scene(api.Bvh(world), camera, (0.0, 0.0, 0.0), rc)
    return jcompile(scene) if api is J else tcompile(scene, device="cpu")


def _jax_attr_grad(w=16, h=12, depth=4):
    """(image, material table gradient) of sum(image) from the JAX
    package's render_linear on the attenuation scene (its default XLA
    route; its Pallas route gives the same attenuation column)."""
    cj = _attenuation_scene(J, w, h)

    def f(attr):
        img = JD.render_linear(
            dataclasses.replace(cj, materials=dataclasses.replace(
                cj.materials, attr=attr)),
            width=w, height=h, max_depth=depth, n_samples=1, seed=SEED)
        return jnp.sum(img), img

    (_, img), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        cj.materials.attr)
    return np.asarray(img), np.asarray(g)


@pytest.mark.parametrize("table", ["materials", "lights", "solids",
                                   "camera"])
def test_route_raises_on_other_tables(table):
    """(d) The material table requiring grad: the route returns its
    gradient, JAX's: on the attenuation scene (16x12, depth 4, 1 spp) the
    attenuation column (``ops.step.ATTEN_COL``) of the attenuated light's
    row against ``jax.grad`` of the JAX package's render_linear (rtol
    1e-3, atol 1e-4, the file's tolerance against JAX; JAX's finite), every
    other entry exactly 0, the rows whose factor is 0 included, and the
    image as the route gives it without grad. A light, solid or camera
    table that requires grad: the route raises, naming the leaves it
    supports (among them the material table), rather than return a
    gradient that leaves it out."""
    if table == "materials":
        img_j, g_j = _jax_attr_grad()
        cs = _attenuation_scene(T)
        leaf = cs.materials.attr.clone().requires_grad_(True)
        scene = dataclasses.replace(cs, materials=dataclasses.replace(
            cs.materials, attr=leaf))
        img = TD.render_linear(scene, width=16, height=12, max_depth=4,
                               n_samples=1, seed=SEED)
        g, = torch.autograd.grad(img.sum(), leaf)
        with torch.no_grad():
            plain = TD.render_linear(cs, width=16, height=12, max_depth=4,
                                     n_samples=1, seed=SEED)
        assert torch.equal(img.detach(), plain)
        np.testing.assert_allclose(img.detach().numpy(), img_j, rtol=1e-4,
                                   atol=1e-4)
        col = S.ATTEN_COL
        atten = cs.materials.attr[:, col] > 0
        assert int(atten.sum()) == 1 and np.isfinite(g_j[:, col]).all()
        assert float(g[atten, col]) < 0
        np.testing.assert_allclose(g[:, col].numpy(), g_j[:, col],
                                   rtol=1e-3, atol=1e-4)
        rest = torch.ones_like(g, dtype=torch.bool)
        rest[atten, col] = False
        assert torch.equal(g[rest], torch.zeros_like(g[rest]))
        return
    cs = _compile("kitchen", T, 16, 8)
    part = getattr(cs, table)
    field = dict(lights="w", solids="sph_attr", camera="origin")[table]
    leaf = getattr(part, field).clone().requires_grad_(True)
    bad = dataclasses.replace(cs, **{table: dataclasses.replace(
        part, **{field: leaf})})
    with pytest.raises(ValueError, match=r"cs\.textures\.pixels.*"
                       r"cs\.materials\.attr"):
        TD.render_linear(bad, width=16, height=8, max_depth=4, n_samples=1,
                         seed=SEED)
    with torch.no_grad():
        img = TD.render_linear(bad, width=16, height=8, max_depth=4,
                               n_samples=1, seed=SEED)
    assert torch.isfinite(img).all()


class _PerCallShadeFn(torch.autograd.Function):
    """The differentiable bounce before the pass's sums: S1 with its record
    (in the carry form), and in the backward S1B's plain version into a
    buffer zeroed for this call, whose arena and background rows it
    returns for autograd to add to the other bounces'."""

    @staticmethod
    def forward(ctx, cs, call, arena, bg, color, *ab):
        (t, kind, idx, o, d, bounce, acc_len, dead, outer, pixel, sample,
         seed, active, max_depth) = call
        out, rec = S.shade_with_record(
            cs, t, kind, idx, o, d, bounce, acc_len,
            (ab[:3], ab[3:], dead, outer), pixel, sample, seed, active,
            max_depth, arena, bg, color=color)
        ctx.save_for_backward(rec, arena, bg, *ab)
        ctx.set_materialize_grads(False)
        A, B, dead, outer = out["fold"]
        rest = (*out["o"], *out["d"], out["bounce"], out["acc_len"], *dead,
                outer, *(out[k] for k in S.FLAGS))
        ctx.mark_non_differentiable(*rest)
        return (out["color"], *A, *B) + rest

    @staticmethod
    def backward(ctx, g_color, *g_out):
        rec, arena, bg, *ab = ctx.saved_tensors
        need = ctx.needs_input_grad
        sums = torch.zeros((arena.shape[0] + 1, 3), dtype=arena.dtype)
        g_carry = (torch.empty_like(g_color)
                   if need[4] and g_color is not None else None)
        g_ab = S.step_shade_backward_plain(rec, ab, arena, bg, g_color,
                                           g_out[:6], sums, need[2], need[3],
                                           need[5:11], g_carry=g_carry)
        return (None, None, sums[:-1] if need[2] else None,
                sums[-1] if need[3] else None, g_carry, *g_ab)


def _per_call_shade_grad(cs, t, kind, idx, o, d, bounce, acc_len, fold,
                         pixel, sample, seed, active, max_depth, color):
    """``ops.step.step_shade_grad`` on ``_PerCallShadeFn``."""
    A, B, dead, outer = fold
    outs = _PerCallShadeFn.apply(
        cs, (t, kind, idx, o, d, bounce, acc_len, dead, outer, pixel, sample,
             seed, active, max_depth), cs.textures.pixels, cs.bg_color,
        color, *A, *B)
    out = dict(zip(S.FLAGS, outs[19:]))
    out.update(color=outs[0], o=outs[7:10], d=outs[10:13], bounce=outs[13],
               acc_len=outs[14], fold=(outs[1:4], outs[4:7], outs[15:18],
                                       outs[18]), alive=out["scat"])
    return out


def _two_sample_grads(cs, w=16, h=8, depth=4, samples=2):
    """(image, arena gradient, background gradient) of a weighted sum of
    ``render_linear``'s image with ``samples`` samples (weights from a
    numpy seed), and the arena-sized zero fills and adds of the backward
    pass (``profiling.ArenaOps``)."""
    arena = cs.textures.pixels.detach().clone().requires_grad_(True)
    bg = cs.bg_color.detach().clone().requires_grad_(True)
    img = TD.render_linear(_with_leaves(cs, arena, bg), width=w, height=h,
                           max_depth=depth, n_samples=samples, seed=SEED)
    weight = torch.from_numpy(np.random.default_rng(3).normal(
        size=img.shape).astype(np.float32))
    with ArenaOps(arena.shape[0]) as ops:
        g_arena, g_bg = torch.autograd.grad((img * weight).sum(), (arena, bg))
    return img.detach(), g_arena, g_bg, ops


@pytest.mark.parametrize("name", ["kitchen", "mixed"])
def test_sums_route_matches_per_call_route(name, monkeypatch):
    """(e) With two samples and the bounces checkpointed one a chunk
    (``remat_chunk`` 1: four chunks and the last bounce), the arena's and
    the background's gradients of the pass's sums against the per-call
    route's: the same image bit for bit, the gradients within 1e-6 of the
    largest entry (the same lanes' terms, added into one running sum
    instead of into a sum a bounce and then across bounces); the backward
    pass zeroes one arena-sized buffer a sample (a trace) and adds two
    arena-sized gradients once (the samples'), where the per-call route
    zeroes one a bounce and adds them a bounce at a time."""
    monkeypatch.setattr(TI, "remat_chunk", lambda depth: 1)
    cs = _compile(name, T, 16, 8)
    img, g, g_bg, ops = _two_sample_grads(cs)
    assert torch.isfinite(g).all() and (g != 0).any()
    assert torch.isfinite(g_bg).all() and (g_bg != 0).any()
    assert (ops.fills, ops.adds) == (2, 1), (ops.fills, ops.adds)
    monkeypatch.setattr(S, "step_shade_grad", _per_call_shade_grad)
    img_p, g_p, g_bg_p, ops_p = _two_sample_grads(cs)
    assert torch.equal(img, img_p)
    assert ops_p.fills == 2 * 5 and ops_p.adds > 2 * 4, (ops_p.fills,
                                                         ops_p.adds)
    for a, b in ((g, g_p), (g_bg, g_bg_p)):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-6 * float(b.abs().max()))


def test_retained_second_backward_does_not_double():
    """(e) Backward passes over one retained graph of three chained
    bounces (``path_step_grad`` on one ``grad_scene``): a second pass for
    the arena and the background starts its sums from zero (a pass is
    autograd's graph task), so it gives the first's gradients bit for bit,
    and the first's tensors keep their values; a pass for the first fold
    only runs every S1B but not the sums' sink, and leaves nothing that the
    next pass adds to."""
    cs = _compile("kitchen", T, 16, 8)
    arena = cs.textures.pixels.detach().clone().requires_grad_(True)
    bg = cs.bg_color.detach().clone().requires_grad_(True)
    scene = S.grad_scene(_with_leaves(cs, arena, bg))
    assert S.sums_of(scene.textures.pixels) is not None
    pix = torch.arange(16 * 8, dtype=torch.int64)
    _, o, d = TI.camera_rays(scene, pix, 16, 8, 1, SEED)
    zero = torch.zeros_like(o[0])
    A, B, dead, outer = TI.fold_init(zero)
    a0 = tuple(x.clone().requires_grad_(True) for x in A)
    fold = (a0, B, dead, outer)
    bounce = torch.zeros(pix.shape, dtype=torch.int32)
    alive = torch.ones(pix.shape, dtype=torch.bool)
    acc_len, color = zero, torch.zeros((pix.shape[0], 3))
    for _ in range(3):
        st = TI.path_step_grad(scene, o, d, bounce, acc_len, fold, pix, 1,
                               SEED, alive, 4, color)
        o, d, bounce, acc_len, fold, alive, color = (
            st["o"], st["d"], st["bounce"], st["acc_len"], st["fold"],
            st["alive"], st["color"])
    loss = (color * color).sum()
    g1 = torch.autograd.grad(loss, (arena, bg), retain_graph=True)
    kept = [g.clone() for g in g1]
    g2 = torch.autograd.grad(loss, (arena, bg), retain_graph=True)
    for a, b, k in zip(g1, g2, kept):
        assert torch.equal(a, b) and torch.equal(a, k)
        assert (a != 0).any() and a.data_ptr() != b.data_ptr()
    g_a0 = torch.autograd.grad(loss, a0, retain_graph=True)
    assert any((g != 0).any() for g in g_a0)
    g3 = torch.autograd.grad(loss, (arena, bg))
    for a, b in zip(g1, g3):
        assert torch.equal(a, b)


def test_bounce_without_a_trace_head_keeps_its_arena_gradient():
    """(e) ``path_step_grad`` called on a scene that no trace passed through
    ``grad_scene`` makes the sums' head for its own call: the arena's and
    the background's gradients of one bounce equal those of the same
    bounce on a ``grad_scene`` copy, and are not all zero."""
    cs = _compile("kitchen", T, 16, 8)
    pix = torch.arange(16 * 8, dtype=torch.int64)
    grads = []
    for head in (False, True):
        arena = cs.textures.pixels.detach().clone().requires_grad_(True)
        bg = cs.bg_color.detach().clone().requires_grad_(True)
        scene = _with_leaves(cs, arena, bg)
        if head:
            scene = S.grad_scene(scene)
        assert (S.sums_of(scene.textures.pixels) is not None) == head
        _, o, d = TI.camera_rays(scene, pix, 16, 8, 1, SEED)
        zero = torch.zeros_like(o[0])
        st = TI.path_step_grad(scene, o, d, torch.zeros(pix.shape,
                                                        dtype=torch.int32),
                               zero, TI.fold_init(zero), pix, 1, SEED,
                               torch.ones(pix.shape, dtype=torch.bool), 4,
                               torch.zeros((pix.shape[0], 3)))
        grads.append(torch.autograd.grad(
            (st["color"] * st["color"]).sum(), (arena, bg)))
    for a, b in zip(*grads):
        assert torch.equal(a, b) and (a != 0).any()


def test_pass_through_lanes_equal_full_formula():
    """(f) S1B does not read A and B on a lane whose record sets no branch
    bit, reads no texel and has a zero pdf weight, on a channel whose color
    gradient times the attenuation is 0 (csrc/step.cu): it writes the
    upstream fold gradients plus 0. The plain version's full formula gives
    those bits on every such lane and channel, with A and B 0, 1, inf,
    NaN, tied (B = 3A, B = A * 0) or random, the color gradient +0 or -0
    (or any value on a dead-at-terminal channel), the attenuation from a
    record, and upstream fold gradients +0, -0, inf, NaN or random; a
    lane that does not end passes its color gradient, whatever it is, to
    the carried color (its bits) and shades nothing; and on a lane that
    ends (its record's terminal bit) a color gradient that is not 0 (NaN,
    inf, a number) gives what the full formula gives, which the kernel then
    computes."""
    g = np.random.default_rng(11)
    r = 4096
    special = np.array([0.0, -0.0, 1.0, np.inf, -np.inf, np.nan],
                       dtype=np.float32)

    def draw(p_special):
        x = g.normal(size=r).astype(np.float32)
        pick = g.random(r) < p_special
        x[pick] = special[g.integers(0, len(special), int(pick.sum()))]
        return torch.from_numpy(x)

    A = [draw(0.5) for _ in range(3)]
    B = [draw(0.5) for _ in range(3)]
    B[0][:64] = 3.0 * A[0][:64]
    B[1][64:128] = A[1][64:128] * 0.0
    g_out = [draw(0.3) for _ in range(6)]
    dead_t = [torch.from_numpy(g.random(r) < 0.2) for _ in range(3)]
    dead = [torch.from_numpy(g.random(r) < 0.2) for _ in range(3)]
    att = torch.from_numpy(g.uniform(0.1, 1.0, r).astype(np.float32))
    att[::3] = 1.0
    none = torch.zeros(r, dtype=torch.bool)
    # a third of the lanes end (the rest shade nothing) with a color
    # gradient that is not 0; another third does not end with one
    end = torch.arange(r) % 3 == 0
    rec = S.shade_record(torch.full((r,), -1, dtype=torch.int32),
                         torch.zeros(r), att, none, none, none, none, end,
                         dead_t, dead, none, torch.zeros(r),
                         torch.zeros(r, dtype=torch.int32))
    zero = torch.from_numpy(np.where(g.random((r, 3)) < 0.5, 0.0, -0.0)
                            .astype(np.float32))
    g_color = torch.where((torch.arange(r)[:, None] % 3 != 2),
                          draw(0.5)[:, None].expand(r, 3), zero)
    texels, bg = torch.rand(8, 3), torch.rand(3)
    sums = torch.zeros((9, 3))
    g_carry = torch.empty((r, 3))
    got = S.step_shade_backward_plain(rec, (*A, *B), texels, bg, g_color,
                                      g_out, sums, g_carry=g_carry)
    assert not sums.any()
    assert torch.equal(g_carry[~end].view(torch.int32),
                       g_color[~end].view(torch.int32))
    assert torch.equal(g_carry[end], torch.zeros_like(g_carry[end]))
    passed = 0
    for c in range(3):
        gl = torch.where(dead_t[c], 0.0,
                         torch.where(end, g_color[:, c], 0.0) * att)
        through = (gl == 0.0) & ~end
        passed += int(through.sum())
        for k, up in ((c, g_out[c]), (3 + c, g_out[3 + c])):
            want = (up + 0.0)[through]
            assert torch.equal(got[k][through].view(torch.int32),
                               want.view(torch.int32)), (c, k)
        # a gradient that is not 0 reaches the result through the terminal
        # color's minimum: gx t_c is NaN where gx is not finite, which
        # happens unless A t_c > B (min_grads' NaN rule)
        nan = ~through & ~torch.isfinite(gl) & ~(A[c] * 0.0 > B[c])
        assert nan.any() and torch.isnan(got[c][nan]).all()
    assert passed == 3 * int((~end).sum())
