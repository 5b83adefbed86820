"""Trace's carry form on the CPU: S1 takes the color and the alive flag
each lane carries (``path_step(..., color=...)``, plain version
``shade_plain(..., color=...)``) and S1B returns the carried color's
gradient, so that ``integrator.trace``'s bounce loop runs nothing of its
own. Checked at small size on the six scenes of
``tests/test_torch_step_grad.py``:

(a) the carry form's outputs against the composition it replaced (S1 in
    its old form, then ``torch.where`` on the color, ``alive &
    ~terminal`` and the parked direction) bit for bit over chained
    bounces that reach the depth cap, and its ``alive`` is ``alive &
    ~terminal`` and the ``scat`` flag;
(b) the differentiable route's gradients (the carried color's through the
    bounces, the fold's, the arena's and the background's) against that
    composition's, S1B then getting the gradient of ``torch.where``'s
    transpose, bit for bit;
(c) S1B's gradient of the materials' attenuation factors
    (``cs.materials.attr``'s column ``ops.step.ATTEN_COL``) against
    autograd through ``shade_plain`` on two scenes with an attenuated
    emitter (rtol 1e-6, the sums' tolerance of test_torch_step_grad.py),
    0 in every other entry, and the whole trace's against autograd through
    the torch composition (rtol 1e-5, atol 1e-7).
"""
import dataclasses

import numpy as np
import pytest
import torch

import solstrale_tpu_torch as T
from solstrale_tpu_torch import diff as TD
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch.ops import bvh as TB
from solstrale_tpu_torch.ops import step as S
from solstrale_tpu_torch.renderer import integrator as TI
from solstrale_tpu_torch.scene.compile import compile_scene as tcompile

torch.set_num_threads(2)

SEED = 1
SCENES = {
    "sponza": lambda c: fixtures.sponza_class_scene(c, n_cells=40, api=T),
    "sponza_textured": lambda c: fixtures.sponza_textured_scene(
        c, n_cells=16, tex_size=32, api=T),
    "production": lambda c: fixtures.sponza_production_scene(
        c, n_cells=16, tex_size=32, api=T),
    "many_lights": lambda c: fixtures.many_light_scene(
        c, n_lights=20, n_cells=16, api=T),
    "mixed": lambda c: fixtures.mixed_bvh_scene(c, n_cells=16, api=T),
    "kitchen": lambda c: fixtures.kitchen_sink_scene(c, api=T),
}


def _attenuation(c):
    """tests/scenes.py::create_light_attenuation_scene(rc, 0.5) through the
    port: a small attenuated sphere light the camera looks at."""
    light = T.DiffuseLight(25.0, 25.0, 25.0, attenuation_half_length=0.5)
    world = [
        T.Sphere((0, 0.2, 0), 0.03, light),
        T.Sphere((0.25, 0.1, 0.25), 0.1, T.Lambertian(T.SolidColor(0, 1, 0))),
        T.Sphere((0.25, 0.1, -0.5), 0.1, T.Lambertian(T.SolidColor(0, 0, 1))),
        T.Sphere((-0.1, 0.1, -0.1), 0.1,
                 T.Dielectric(T.SolidColor(0.8, 0.8, 0.8), None, 1.5)),
        T.Quad((-1, 0, -1), (2, 0, 0), (0, 0, 2),
               T.Lambertian(T.SolidColor(1, 0, 0))),
    ]
    camera = T.CameraConfig(vertical_fov_degrees=20.0, aperture_size=0.0,
                            look_from=(0.0, 1.0, 2.0), look_at=(0.0, 0.2, 0.0))
    return T.Scene(T.Bvh(world), camera, (0.0, 0.0, 0.0), c)


ATTENUATED = {
    # an attenuated quad light (half length 10) among every material kind
    "kitchen_solid": lambda c: fixtures.kitchen_sink_solid_scene(c, api=T),
    "attenuation": _attenuation,
}


def _compile(make, w, h):
    cfg = T.RenderConfig(width=w, height=h, samples_per_pixel=1, seed=SEED)
    return tcompile(make(cfg), device="cpu")


def _same(a, b):
    """Bit for bit, NaNs included."""
    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _glue(st, alive, color):
    """The carry as ``trace``'s bounce loop built it before the carry form:
    (color, alive, d) from S1's old-form outputs ``st``."""
    color = torch.where(st["terminal"][:, None], st["color"], color)
    alive = alive & ~st["terminal"]
    return color, alive, tuple(torch.where(alive, c, 0.0) for c in st["d"])


def _start(cs, w, h):
    pix = torch.arange(w * h, dtype=torch.int64)
    _, o, d = TI.camera_rays(cs, pix, w, h, 1, SEED)
    zero = torch.zeros_like(o[0])
    return (pix, o, d, torch.zeros(pix.shape, dtype=torch.int32), zero,
            TI.fold_init(zero), torch.ones(pix.shape, dtype=torch.bool),
            torch.zeros((pix.shape[0], 3)))


@pytest.mark.parametrize("name", list(SCENES))
def test_carry_forward_matches_glue(name):
    """(a) Five chained bounces at depth cap 3 of 768 lanes: the carry form
    (``path_step(..., color=...)``) against the old form plus the torch
    glue, every output bit for bit (the color, the parked direction, the
    rest of the lane state, the six flags), ``alive`` equal to ``alive &
    ~terminal`` and to ``scat``; lanes end by every kind and park."""
    w, h, depth = 32, 24, 3
    cs = _compile(SCENES[name], w, h)
    pix, o, d, bounce, acc_len, fold, alive, color = _start(cs, w, h)
    ended = 0
    for _ in range(5):
        st = TI.path_step(cs, o, d, bounce, acc_len, fold, pix, 1, SEED,
                          alive, depth, color)
        old = TI.path_step(cs, o, d, bounce, acc_len, fold, pix, 1, SEED,
                           alive, depth)
        want_color, want_alive, want_d = _glue(old, alive, color)
        assert _same(st["color"], want_color)
        assert torch.equal(st["alive"], want_alive)
        assert torch.equal(st["alive"], st["scat"])
        for a, b in zip(st["d"], want_d):
            assert _same(a, b)
        for k in S.FLAGS:
            assert torch.equal(st[k], old[k]), k
        for a, b in zip(S.lane_arrays(st)[:3] + S.lane_arrays(st)[6:],
                        S.lane_arrays(old)[:3] + S.lane_arrays(old)[6:]):
            assert _same(a, b)
        ended += int(st["terminal"].sum())
        o, d, bounce, acc_len, fold, alive, color = (
            st["o"], st["d"], st["bounce"], st["acc_len"], st["fold"],
            st["alive"], st["color"])
    assert ended > 0 and (color != 0).any()


class _GlueShadeFn(torch.autograd.Function):
    """``ops.step.StepShadeFn`` before the carry form: S1 with its record in
    the old form (the color ``L * att`` on every lane), and in the
    backward S1B on the color gradient that ``torch.where``'s transpose
    hands it (0 where the lane did not end), into the pass's sums."""

    @staticmethod
    def forward(ctx, cs, call, arena, bg, *ab):
        (t, kind, idx, o, d, bounce, acc_len, dead, outer, pixel, sample,
         seed, active, max_depth, sums) = call
        out, rec = S.shade_with_record(
            cs, t, kind, idx, o, d, bounce, acc_len,
            (ab[:3], ab[3:], dead, outer), pixel, sample, seed, active,
            max_depth, arena, bg)
        ctx.save_for_backward(rec, arena, bg, *ab)
        ctx.sums = sums
        ctx.set_materialize_grads(False)
        A, B, dead, outer = out["fold"]
        rest = (*out["o"], *out["d"], out["bounce"], out["acc_len"], *dead,
                outer, *(out[k] for k in S.FLAGS))
        ctx.mark_non_differentiable(*rest)
        return (out["color"], *A, *B) + rest

    @staticmethod
    def backward(ctx, g_color, *g_out):
        rec, arena, bg, *ab = ctx.saved_tensors
        sums = ctx.sums
        g_ab = S.step_shade_backward_plain(
            rec, ab, arena, bg, g_color, g_out[:6], sums.buffer(),
            sums.want_texels, sums.want_bg, ctx.needs_input_grad[4:10])
        return (None, None, None, None, *g_ab)


def _glue_step(cs, o, d, bounce, acc_len, fold, pix, sample, seed, alive,
               max_depth, color):
    """One bounce as ``trace`` took it before the carry form: the hit,
    ``_GlueShadeFn`` and the torch glue; the carry form's dict."""
    t, kind, idx = TI.step_hit(cs, o, d, pix, sample, bounce, seed)
    A, B, dead, outer = fold
    outs = _GlueShadeFn.apply(
        cs, (t, kind, idx, o, d, bounce, acc_len, dead, outer, pix, sample,
             seed, alive, max_depth, S.sums_of(cs.textures.pixels)),
        cs.textures.pixels, cs.bg_color, *A, *B)
    st = dict(zip(S.FLAGS, outs[19:]))
    st.update(color=outs[0], d=outs[10:13])
    color, alive, d = _glue(st, alive, color)
    return dict(st, color=color, alive=alive, d=d, o=outs[7:10],
                bounce=outs[13], acc_len=outs[14],
                fold=(outs[1:4], outs[4:7], outs[15:18], outs[18]))


def _route_grads(cs, w, h, depth, step):
    """The carried colors of four chained bounces at depth cap ``depth``
    through ``step`` on a ``grad_scene`` with a leaf arena, background and
    first fold A, and the gradients of a weighted sum of the last color
    (weights from a numpy seed) to the leaves."""
    arena = cs.textures.pixels.detach().clone().requires_grad_(True)
    bg = cs.bg_color.detach().clone().requires_grad_(True)
    scene = S.grad_scene(dataclasses.replace(
        TD.set_texture_params(cs, arena), bg_color=bg))
    pix, o, d, bounce, acc_len, fold, alive, color = _start(scene, w, h)
    a0 = tuple(torch.from_numpy(np.random.default_rng(4).uniform(
        0.5, 1.5, pix.shape[0]).astype(np.float32)).requires_grad_(True)
        for _ in range(3))
    fold = (a0,) + fold[1:]
    colors = []
    for _ in range(4):
        st = step(scene, o, d, bounce, acc_len, fold, pix, 1, SEED, alive,
                  depth, color)
        o, d, bounce, acc_len, fold, alive, color = (
            st["o"], st["d"], st["bounce"], st["acc_len"], st["fold"],
            st["alive"], st["color"])
        colors.append(color.detach())
    weight = torch.from_numpy(np.random.default_rng(3).normal(
        size=color.shape).astype(np.float32))
    grads = torch.autograd.grad((color * weight).sum(), (arena, bg, *a0))
    return colors, grads


@pytest.mark.parametrize("name", list(SCENES))
def test_carry_backward_matches_glue(name):
    """(b) Four chained bounces of 192 lanes at depth cap 2 on the
    differentiable route (``path_step_grad``: S1 and S1B in the carry
    form, the plain versions) against the same bounces through the old
    form and the torch glue, whose transpose hands S1B the color's
    gradient: the carried colors, and the gradients of the arena, the
    background and the first bounce's fold (which reach them through every
    bounce's carried color and fold), bit for bit."""
    w, h, depth = 16, 12, 2
    cs = _compile(SCENES[name], w, h)
    colors, grads = _route_grads(cs, w, h, depth, TI.path_step_grad)
    want_colors, want = _route_grads(cs, w, h, depth, _glue_step)
    for a, b in zip(colors, want_colors):
        assert _same(a, b)
    for k, (a, b) in enumerate(zip(grads, want)):
        assert _same(a, b), k
    assert (grads[0] != 0).any() and all((g != 0).any() for g in grads[2:])


def _aimed_rays(cs, pix, w, h, name):
    """Camera rays, and on the kitchen half the lanes aimed up at its
    attenuated quad light (y = 10, x and z in [-1, 1], facing down) from
    below, so that lanes end on it."""
    _, o, d = TI.camera_rays(cs, pix, w, h, 1, SEED)
    if name != "kitchen_solid":
        return o, d
    g = np.random.default_rng(9)
    n = pix.shape[0] // 2
    up = [torch.from_numpy(x.astype(np.float32)) for x in (
        g.uniform(-0.8, 0.8, n), np.full(n, 5.0), g.uniform(-0.8, 0.8, n))]
    tip = [torch.from_numpy(x.astype(np.float32)) for x in (
        g.uniform(-0.1, 0.1, n), np.ones(n), g.uniform(-0.1, 0.1, n))]
    o = tuple(torch.cat([a[:pix.shape[0] - n], b]) for a, b in zip(o, up))
    d = tuple(torch.cat([a[:pix.shape[0] - n], b]) for a, b in zip(d, tip))
    return o, d


@pytest.mark.parametrize("name", list(ATTENUATED))
def test_atten_backward_matches_autograd(name):
    """(c) Three chained bounces of 768 lanes at depth cap 2: S1B's plain
    version's attenuation sums (``g_mats``) against autograd through
    ``shade_plain`` in the carry form with the material table a leaf
    (rtol 1e-6), with the carried color's and the fold's gradients as
    (a) of test_torch_step_grad.py holds them; lanes end on the attenuated
    emitter, the sums are not 0 there, and every other entry of the table
    gets exactly 0."""
    w, h, depth = 32, 24, 2
    cs = _compile(ATTENUATED[name], w, h)
    g = np.random.default_rng(7)
    pix = torch.arange(w * h, dtype=torch.int64)
    r = pix.shape[0]
    o, d = _aimed_rays(cs, pix, w, h, name)
    bounce = torch.zeros(r, dtype=torch.int32)
    acc_len = torch.zeros(r)
    fold = TI.fold_init(acc_len)
    alive = torch.ones(r, dtype=torch.bool)
    color = torch.zeros((r, 3))
    total, atten_lanes = torch.zeros_like(cs.materials.attr), 0
    want_total = torch.zeros_like(total)
    for _ in range(3):
        t, kind, idx = TI.step_hit(cs, o, d, pix, 1, bounce, SEED)
        if kind is None:
            kind, idx = TB.decode_planar_slot(cs.solids, idx)
        A, B, dead, outer = fold
        attr = cs.materials.attr.clone().requires_grad_(True)
        leaf = dataclasses.replace(cs, materials=dataclasses.replace(
            cs.materials, attr=attr))
        ab = [x.clone().requires_grad_(True) for x in (*A, *B)]
        carry = color.clone().requires_grad_(True)
        tail = (pix, 1, SEED, alive, depth)
        st = TI.shade_plain(leaf, o, d, t, kind, idx, bounce, acc_len,
                            (ab[:3], ab[3:], dead, outer), *tail,
                            color=carry)
        g_color = torch.from_numpy(g.normal(size=(r, 3)).astype(np.float32))
        g_out = [torch.from_numpy(g.normal(size=r).astype(np.float32))
                 for _ in range(6)]
        want = torch.autograd.grad(
            [st["color"], *st["fold"][0], *st["fold"][1]],
            [*ab, carry, attr], [g_color, *g_out], allow_unused=True,
            materialize_grads=True)
        with torch.no_grad():
            rec_st = TI.shade_plain(cs, o, d, t, kind, idx, bounce, acc_len,
                                    fold, *tail, record=True, color=color)
        rec = rec_st.pop("record")
        g_mats = torch.zeros_like(cs.materials.attr)
        g_carry = torch.empty((r, 3))
        sums = torch.zeros((cs.textures.pixels.shape[0] + 1, 3))
        got = S.step_shade_backward_plain(
            rec, (*A, *B), cs.textures.pixels, cs.bg_color, g_color, g_out,
            sums, g_carry=g_carry, g_mats=g_mats)
        for k, (a, b) in enumerate(zip(got, want[:6])):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                       msg=f"fold input {k}")
        torch.testing.assert_close(g_carry, want[6], rtol=0, atol=0)
        torch.testing.assert_close(g_mats, want[7], rtol=1e-6, atol=0)
        atten_lanes += int(((rec[3] & S.REC_ATTEN) != 0).sum())
        total += g_mats
        want_total += want[7]
        o, d, bounce, acc_len, fold, alive, color = (
            rec_st["o"], rec_st["d"], rec_st["bounce"], rec_st["acc_len"],
            rec_st["fold"], rec_st["alive"], rec_st["color"])
    col = S.ATTEN_COL
    atten = cs.materials.attr[:, col] > 0
    assert atten_lanes > 0 and bool((total[atten, col] != 0).all())
    rest = torch.ones_like(total, dtype=torch.bool)
    rest[atten, col] = False
    assert torch.equal(total[rest], torch.zeros_like(total[rest]))
    assert torch.equal(want_total[rest], torch.zeros_like(want_total[rest]))


@pytest.mark.parametrize("name", list(ATTENUATED))
def test_trace_atten_grad_matches_torch_route(name, monkeypatch):
    """(c) ``diff.render_linear`` (trace's differentiable route, 16x12,
    depth 4, 1 spp) with the material table a leaf: its gradient against
    autograd through the torch composition (``path_step_plain`` in the
    carry form) to rtol 1e-5, atol 1e-7, not 0 on the attenuated row's
    factor, exactly 0 elsewhere; the image the same bit for bit."""
    cs = _compile(ATTENUATED[name], 16, 12)

    def grads():
        attr = cs.materials.attr.clone().requires_grad_(True)
        leaf = dataclasses.replace(cs, materials=dataclasses.replace(
            cs.materials, attr=attr))
        img = TD.render_linear(leaf, width=16, height=12, max_depth=4,
                               n_samples=1, seed=SEED)
        return img.detach(), torch.autograd.grad(img.sum(), attr)[0]

    img, g = grads()
    monkeypatch.setattr(TI, "path_step_grad", TI.path_step_plain)
    img_p, g_p = grads()
    assert torch.equal(img, img_p)
    torch.testing.assert_close(g, g_p, rtol=1e-5, atol=1e-7)
    col = S.ATTEN_COL
    atten = cs.materials.attr[:, col] > 0
    assert bool((g[atten, col] != 0).all())
    rest = torch.ones_like(g, dtype=torch.bool)
    rest[atten, col] = False
    assert torch.equal(g[rest], torch.zeros_like(g[rest]))
