"""Differentiable rendering in the port (``solstrale_tpu_torch.diff``) on
the CPU: the two repairs (detached sampling; no 0 x NaN in the backward)
against the JAX package's gradients and central differences, the detached
hit kernels, the checkpointed path-replay backward and the port's own
finite-difference check. The JAX reference of each scene (image and arena
gradient of sum(image), 16x8, depth 4, 1 spp, seed 1) is computed once.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

import solstrale_tpu as J
import solstrale_tpu_torch as T
from solstrale_tpu import diff as JD
from solstrale_tpu.scene.compile import compile_scene as jcompile
from solstrale_tpu_torch import diff as TD
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch.ops import bvh as TB
from solstrale_tpu_torch.ops import sweep as TS
from solstrale_tpu_torch.renderer import integrator as TI
from solstrale_tpu_torch.scene.compile import compile_scene as tcompile

torch.set_num_threads(2)

W, H, DEPTH, SEED = 16, 8, 4, 1
SCENES = {
    "mixed": lambda cfg, api: fixtures.mixed_bvh_scene(cfg, n_cells=8,
                                                       api=api),
    "kitchen": lambda cfg, api: fixtures.kitchen_sink_scene(cfg, api=api),
}
# the kitchen's arena rows where the JAX package's gradient is NaN at this
# size although its image is finite (ROADMAP C, reference side)
JAX_NAN_ROWS = [0, 725, 1378, 1445, 2560, 8194, 8195]


def _compile(name, api, **kw):
    cfg = api.RenderConfig(width=W, height=H, samples_per_pixel=1, seed=SEED)
    scene = SCENES[name](cfg, api)
    return jcompile(scene) if api is J else tcompile(scene, device="cpu",
                                                     **kw)


@pytest.fixture(scope="module")
def jax_ref():
    """{scene: (image, arena gradient of sum(image))} from the JAX
    package (its XLA path), one compile per scene."""
    out = {}
    for name in SCENES:
        cs = _compile(name, J)

        def f(p, cs=cs):
            img = JD.render_linear(JD.set_texture_params(cs, p), width=W,
                                   height=H, max_depth=DEPTH, n_samples=1,
                                   seed=SEED)
            return jnp.sum(img), img

        (_, img), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
            cs.textures.pixels)
        out[name] = (np.asarray(img), np.asarray(g))
    return out


def _render(cs, params, weight, depth, samples, size):
    w, h = size
    img = TD.render_linear(TD.set_texture_params(cs, params), width=w,
                           height=h, max_depth=depth, n_samples=samples,
                           seed=SEED)
    return img, (img if weight is None else img * weight).double().sum()


def _port_grad(cs, weight=None, depth=DEPTH, samples=1, size=(W, H)):
    """(image, arena gradient of sum(image * weight))."""
    p = cs.textures.pixels.detach().clone().requires_grad_(True)
    img, s = _render(cs, p, weight, depth, samples, size)
    g, = torch.autograd.grad(s, p)
    return img.detach(), g


def _differences(cs, i, c, weight=None, depth=DEPTH, samples=1,
                 size=(W, H), eps=1e-3):
    """(forward, backward) one-sided differences of sum(image * weight) in
    arena[i, c]; their mean is the central difference."""
    f = []
    for step in (eps, 0.0, -eps):
        p = cs.textures.pixels.clone()
        p[i, c] += step
        with torch.no_grad():
            f.append(float(_render(cs, p, weight, depth, samples,
                                   size)[1]))
    return (f[0] - f[1]) / eps, (f[1] - f[2]) / eps


def _check_fd(g, fwd, bwd, what, tol=2e-2):
    """The gradient against central differences (rtol = atol = ``tol``)
    where the two one-sided differences agree to that tolerance; where they
    do not, the image has a kink there and the gradient must lie between
    them (a subgradient). Returns whether there was a kink."""
    central = 0.5 * (fwd + bwd)
    if abs(fwd - bwd) <= tol + tol * abs(central):
        np.testing.assert_allclose(g, central, rtol=tol, atol=tol,
                                   err_msg=what)
        return False
    assert min(fwd, bwd) - tol <= g <= max(fwd, bwd) + tol, (what, g, fwd,
                                                             bwd)
    return True


@pytest.mark.parametrize("name", list(SCENES))
def test_render_linear_matches_jax(jax_ref, name):
    """The forward image of render_linear against the JAX package's."""
    img, _ = _port_grad(_compile(name, T))
    assert img.shape == (W * H, 3) and torch.isfinite(img).all()
    np.testing.assert_allclose(img.numpy(), jax_ref[name][0], rtol=1e-4,
                               atol=1e-4)


def test_detached_sampling_mixed_grad_matches_jax(jax_ref):
    """The textured, normal-mapped BVH scene with Blend and a medium: the
    arena gradient equals JAX's (rtol 1e-3, atol 1e-4, JAX's own
    kernel-vs-XLA tolerance). Without the detached direction and pdf
    weight in scatter the port's gradient was NaN here."""
    _, g = _port_grad(_compile("mixed", T))
    g_j = jax_ref["mixed"][1]
    assert np.isfinite(g_j).all() and torch.isfinite(g).all()
    assert (g != 0).any()
    np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-3, atol=1e-4)


def test_kitchen_grad_finite_and_matches_jax_and_fd(jax_ref):
    """No 0 x NaN in the backward: the kitchen's arena gradient is finite
    wherever its image is, equals JAX's on every entry where JAX's is
    finite, and on the entries where JAX's is NaN matches central
    differences (eps 1e-3, rtol 2e-2, atol 2e-2, as
    tests/test_gradients.py does) where the image is differentiable, and
    lies between the one-sided differences at its two kinks."""
    cs = _compile("kitchen", T)
    img, g = _port_grad(cs)
    img_j, g_j = jax_ref["kitchen"]
    assert torch.isfinite(img).all() and np.isfinite(img_j).all()
    assert torch.isfinite(g).all()
    bad = ~np.isfinite(g_j)
    assert sorted(set(np.nonzero(bad)[0])) == JAX_NAN_ROWS
    np.testing.assert_allclose(g.numpy()[~bad], g_j[~bad], rtol=1e-3,
                               atol=1e-4)
    kinks = [(int(i), int(c)) for i, c in zip(*np.nonzero(bad))
             if _check_fd(float(g[i, c]), *_differences(cs, i, c),
                          f"arena[{i},{c}]")]
    # the red material's zero green and blue: the image is not
    # differentiable at a zero channel (one-sided slopes 24 and 81 for
    # green), and the gradient lies between the two
    assert kinks == [(8194, 1), (8194, 2)]


def test_grad_matches_finite_differences():
    """The port's own FD check (tests/test_gradients.py's): a random
    projection of the small scene's image at 24x12, depth 6, 2 spp, probed
    on the light's emission and the sphere's albedo."""
    size = (24, 12)
    cs = tcompile(fixtures.small_scene(T.RenderConfig(
        width=size[0], height=size[1], samples_per_pixel=2, seed=SEED)),
        device="cpu")
    weight = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(size[0] * size[1], 3)).astype(np.float32))
    kw = dict(weight=weight, depth=6, samples=2, size=size)
    _, g = _port_grad(cs, **kw)
    assert (g != 0).any()
    for i in range(min(cs.textures.pixels.shape[0], 3)):
        for c in range(3):
            fwd, bwd = _differences(cs, i, c, **kw)
            np.testing.assert_allclose(float(g[i, c]), 0.5 * (fwd + bwd),
                                       rtol=2e-2, atol=2e-2,
                                       err_msg=f"arena[{i},{c}]")


def _requiring_grad(tables, leaves):
    """A shallow copy of a scene table whose float tensors are new leaves
    that require grad (appended to ``leaves``): geometry that the plain
    versions could differentiate."""
    out = copy.copy(tables)
    for k, v in vars(tables).items():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            v = v.detach().clone().requires_grad_(True)
            leaves.append(v)
            object.__setattr__(out, k, v)
    return out


def _hit_calls(geometry_grad=False):
    """{name: (compiled scene, call(o, d), geometry leaves)} for each
    detached hit wrapper; with ``geometry_grad`` the BVH, solid and media
    tables the calls read require grad."""
    mixed = tcompile(fixtures.mixed_bvh_scene(T.RenderConfig(
        width=W, height=H, samples_per_pixel=1, seed=SEED), n_cells=16),
        device="cpu")
    kitchen = _compile("kitchen", T)
    assert mixed.kbvh is not None and mixed.media
    pix = torch.arange(W * H, dtype=torch.int64)
    zero = torch.zeros_like(pix)
    leaves = []
    kbvh, solids_m, solids_k = mixed.kbvh, mixed.solids, kitchen.solids
    mt_m, mt_k = TI.media_tables(mixed), TI.media_tables(kitchen)
    if geometry_grad:
        kbvh, solids_m, solids_k, mt_m, mt_k = (
            _requiring_grad(x, leaves)
            for x in (kbvh, solids_m, solids_k, mt_m, mt_k))

    def k3(o, d):
        t, kind, idx = TB.bvh_closest_hit(kbvh, solids_m, o, d, 1e-3,
                                          float("inf"))
        return TS.media_hit(mt_m, o, d, t.detach(), kind, idx, pix, 1, zero,
                            SEED)

    return {
        "bvh_planar_hit": (mixed, lambda o, d: TB.bvh_planar_hit(
            kbvh, o, d, 1e-3), leaves),
        "bvh_closest_hit": (mixed, lambda o, d: TB.bvh_closest_hit(
            kbvh, solids_m, o, d, 1e-3, float("inf")), leaves),
        "media_hit": (mixed, k3, leaves),
        "scene_hit": (kitchen, lambda o, d: TS.scene_hit(
            solids_k, mt_k, o, d, pix, 1, zero, SEED), leaves),
    }


HIT_WRAPPERS = ["bvh_planar_hit", "bvh_closest_hit", "media_hit",
                "scene_hit"]


@pytest.mark.parametrize("name", HIT_WRAPPERS)
def test_detached_geometry(name):
    """With the ray directions requiring grad, the CPU route (the plain
    versions, which autograd could differentiate) gives the geometry a zero
    gradient, as a kernel launch on the card does, and its outputs are
    those of the call without grad."""
    cs, call, _ = _hit_calls()[name]
    pix = torch.arange(W * H, dtype=torch.int64)
    o, d = TI.camera_rays_plain(cs, pix, 1, SEED, W, H)
    with torch.no_grad():
        want = call(o, d)
    d_g = tuple(c.detach().clone().requires_grad_(True) for c in d)
    got = call(o, d_g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    t = got[0]
    hit = torch.isfinite(t)
    assert hit.any() and t.requires_grad
    grads = torch.autograd.grad((t[hit] * 2.0).sum(), d_g, allow_unused=True,
                                materialize_grads=True)
    assert all(not gr.any() for gr in grads)


@pytest.mark.parametrize("name", HIT_WRAPPERS)
def test_detached_geometry_in_tables(name):
    """With the geometry held in the scene's tables requiring grad (and no
    ray), the CPU route builds no graph through the plain versions, as a
    kernel launch on the card builds none: ``t`` does not require grad and
    the outputs are those of the call without grad."""
    cs, call, leaves = _hit_calls(geometry_grad=True)[name]
    pix = torch.arange(W * H, dtype=torch.int64)
    o, d = TI.camera_rays_plain(cs, pix, 1, SEED, W, H)
    assert leaves and all(x.requires_grad for x in leaves)
    with torch.no_grad():
        want = call(o, d)
    got = call(o, d)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.isfinite(got[0]).any()
    assert not any(x.requires_grad for x in got)


def test_remat_chunk_rule():
    """The JAX package's chunk: the largest divisor k of max_depth with
    k * k <= 2 * max_depth."""
    assert [TI.remat_chunk(d) for d in (0, 1, 4, 8, 12, 50)] == \
        [1, 1, 2, 4, 4, 10]


def test_checkpointed_backward_equals_unchunked(monkeypatch):
    """The chunked path replay (2 chunks of 4 at depth 8) gives the
    gradient of the unchunked tape (checkpoint replaced by a plain call) to
    1e-6, and keeps far fewer bytes between forward and backward."""
    cs = _compile("kitchen", T)

    def saved_bytes_and_grad():
        total = [0]

        def pack(x):
            total[0] += x.numel() * x.element_size()
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            _, g = _port_grad(cs, depth=8)
        return total[0], g

    chunked_bytes, g_chunked = saved_bytes_and_grad()
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda fn, *args, **kw: fn(*args))
    flat_bytes, g_flat = saved_bytes_and_grad()
    assert torch.isfinite(g_chunked).all() and (g_chunked != 0).any()
    torch.testing.assert_close(g_chunked, g_flat, rtol=0, atol=1e-6)
    assert chunked_bytes * 3 < flat_bytes, (chunked_bytes, flat_bytes)


@pytest.mark.parametrize("name", list(SCENES))
def test_two_sample_step_matches_jax(name, monkeypatch):
    """``image_and_texture_grad`` with two samples, whose two traces sum
    their arena gradients each in one buffer a backward pass (the pass's
    sums, ``ops.step.GradSums``), with the bounces checkpointed one a chunk
    (``remat_chunk`` 1), against the JAX package's: the loss to rtol
    1e-5, the gradient to rtol 1e-3, atol 1e-4 on the entries where JAX's
    is finite (the kitchen's NaN rows, ROADMAP C), as
    tests/test_torch_diff_graph.py holds the one-sample step."""
    if name == "kitchen":
        monkeypatch.setenv("SOLSTRALE_PALLAS", "1")
    monkeypatch.setattr(TI, "remat_chunk", lambda depth: 1)
    cj, ct = _compile(name, J), _compile(name, T)
    target = torch.from_numpy(np.random.default_rng(4).uniform(
        size=(W * H, 3)).astype(np.float32))
    kw = dict(width=W, height=H, max_depth=DEPTH, n_samples=2, seed=SEED)
    loss_j, g_j = JD.image_and_texture_grad(
        cj, jnp.asarray(target.numpy()), **kw)
    loss, g = TD.image_and_texture_grad(ct, target, **kw)
    assert float(loss) > 0 and torch.isfinite(g).all() and (g != 0).any()
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    g_j = np.asarray(g_j)
    ok = np.isfinite(g_j)
    assert ok.mean() > 0.99
    np.testing.assert_allclose(g.numpy()[ok], g_j[ok], rtol=1e-3, atol=1e-4)


def test_fixed_trip_without_grad_unchanged():
    """Outside grad the fixed trip takes no checkpoint, and under grad its
    forward is the same image bit for bit."""
    cs = _compile("mixed", T)
    with torch.no_grad():
        img = TD.render_linear(cs, width=W, height=H, max_depth=DEPTH,
                               n_samples=1, seed=SEED)
    img_grad, _ = _port_grad(cs)
    assert torch.equal(img, img_grad)


def test_set_texture_params_shares_geometry_tables():
    """The copy keeps the media tables (no repack, no box-scale sync) but
    not K5's, which hold the texels."""
    cs = _compile("kitchen", T)
    mt = TI.media_tables(cs)
    copy = TD.set_texture_params(cs, cs.textures.pixels * 0.5)
    assert TI.media_tables(copy) is mt
    assert copy.solids is cs.solids and copy.textures.offset is \
        cs.textures.offset
    bg = dataclasses.replace(cs, bg_color=cs.bg_color)
    assert TI.media_tables(bg) is not mt
