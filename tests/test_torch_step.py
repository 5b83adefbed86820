"""The wavefront step on the CPU against the JAX package: ``path_step_plain``
(S1's plain version, with the scene hit) and the refactored step that runs
through S1's and S2's wrappers (``ops/step.py``) held draw for draw against
the body of the JAX package's ``one_step`` (``full_hit_attributes`` ->
``scatter`` -> terminal classification -> the clamp-fold,
solstrale_tpu/renderer/integrator.py:765-808) and its regeneration's
camera rays, over chained steps on small scenes that cover every branch S1
has: blend, normal maps, image textures, a medium (isotropic), metal,
dielectric, sphere, quad and triangle lights, more than 16 lights, K1's
planar slot decoded by S1, and the depth cap.

Both sides get the same hit (the port's: the JAX package's CPU BVH path
intersects with other formulas, see test_torch_render.py) and, at every
step, the same lane state (the port's), made from a numpy seed. Tolerances
are the render tests': 1e-5 for positions and directions, 1e-4 for colors,
pdf weights and the fold (whose prefix product A is compared on live
channels only: a dead channel's A is never read).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solstrale_tpu as J
import solstrale_tpu_torch as T
from solstrale_tpu.geo import soa as jsoa
from solstrale_tpu.geo import INF as JINF
from solstrale_tpu.ops import intersect as JX
from solstrale_tpu.renderer import integrator as JI
from solstrale_tpu.scene.compile import compile_scene as jcompile
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch.ops import bvh as TB
from solstrale_tpu_torch.ops import intersect as TX
from solstrale_tpu_torch.ops import step as S
from solstrale_tpu_torch.renderer import integrator as TI
from solstrale_tpu_torch.scene.compile import compile_scene as tcompile

torch.set_num_threads(2)

W, H, SEED, DEPTH, STEPS = 32, 24, 1, 2, 4
SCENES = {
    # BVH (K1-K3): blend floor, normal map, image textures, a medium with
    # its isotropic phase, dielectric and metal spheres, a quad light
    "mixed": lambda c, api: fixtures.mixed_bvh_scene(c, n_cells=16,
                                                     api=api),
    # BVH: every material kind, blends with metal and dielectric, normal
    # maps, sphere, quad and triangle lights
    "production": lambda c, api: fixtures.sponza_production_scene(
        c, n_cells=16, tex_size=32, api=api),
    # BVH with 20 lights: the batched light pdf
    "many_lights": lambda c, api: fixtures.many_light_scene(
        c, n_lights=20, n_cells=16, api=api),
    # BVH without spheres or media: S1 decodes K1's planar slot
    "sponza_textured": lambda c, api: fixtures.sponza_textured_scene(
        c, n_cells=16, tex_size=32, api=api),
    # no BVH (K4): normal map, image texture, triangles, a medium
    "kitchen": lambda c, api: fixtures.kitchen_sink_scene(c, api=api),
}


def _cfg(api):
    return api.RenderConfig(width=W, height=H, samples_per_pixel=2,
                            seed=SEED)


def _compiled(name):
    return (jcompile(SCENES[name](_cfg(J), J)),
            tcompile(SCENES[name](_cfg(T), T), device="cpu"))


def _lanes(n=600, seed=5):
    """Lane counters and an active mask from a numpy seed: pixel ids (some
    repeated), samples 1-3, about one lane in twelve inactive."""
    g = np.random.default_rng(seed)
    pix = torch.from_numpy(g.integers(0, W * H, n))
    sample = torch.from_numpy(g.integers(1, 4, n))
    active = torch.from_numpy(g.random(n) > 1 / 12)
    return pix, sample, active


def _jax_step(cj, o, d, t, kind, idx, bounce, acc_len, fold, pix, sample,
              seed, active, max_depth):
    """The JAX package's one_step body after the scene hit (its lines
    774-806), given the hit; ``color`` on every lane (one_step keeps it
    where terminal)."""
    finite = jnp.isfinite(t)
    miss = active & ~finite
    t_safe = jnp.where(finite, t, 0.0)
    attrs = JI.full_hit_attributes(cj, o, d, t_safe, kind, idx, pix, sample,
                                   bounce, seed)
    sc = JI.scatter(cj, o, d, attrs, pix, sample, bounce, seed)
    capped = active & finite & (bounce >= max_depth)
    emit = active & finite & ~capped & sc["is_emission"]
    scat = active & finite & ~capped & ~sc["is_emission"]
    terminal = miss | capped | emit
    total_len = acc_len + t_safe
    term_color = tuple(
        jnp.where(miss, cj.bg_color[c],
                  jnp.where(emit, sc["emit_color"][c], 0.0))
        for c in range(3))
    term_af = jnp.where(emit, sc["atten"], 0.0)
    term_acc = jnp.where(emit, total_len, 0.0)
    L = JI.fold_resolve(fold, term_color)
    att = jnp.where(term_af > 0.0, 1.0 / (1.0 + term_af * term_acc), 1.0)
    A, B, dead, outer = JI.fold_scatter(fold, sc["tape_color"], sc["prob"],
                                        sc["is_pdf"], scat)
    fold = (tuple(jnp.where(terminal, 1.0, A[c]) for c in range(3)),
            tuple(jnp.where(terminal, JINF, B[c]) for c in range(3)),
            tuple(jnp.where(terminal, False, dead[c]) for c in range(3)),
            jnp.where(terminal, False, outer))
    return dict(terminal=terminal, miss=miss, capped=capped, emit=emit,
                scat=scat, is_pdf=sc["is_pdf"],
                color=jnp.stack([L[c] * att for c in range(3)], -1),
                o=jsoa.where3(scat, attrs["point"], o),
                d=jsoa.where3(scat, sc["new_dir"], d),
                bounce=jnp.where(scat, bounce + 1, bounce),
                acc_len=jnp.where(scat, total_len, acc_len), fold=fold)


_JAX_STEP = jax.jit(_jax_step, static_argnames=("max_depth",))


def _j(x):
    """A port value (tensor or nested tuple of them) as JAX arrays."""
    if isinstance(x, tuple):
        return tuple(_j(v) for v in x)
    return jnp.asarray(x.numpy())


def _chain(ct, steps=STEPS):
    """Camera rays of ``_lanes`` and ``steps`` chained steps of
    ``path_step`` on the CPU: yields each step's inputs (the port's lane
    state and the hit as S1 takes it) and the port's result."""
    pix, sample, active = _lanes()
    o, d = TI.camera_rays_plain(ct, pix, sample, SEED, W, H)
    zero = torch.zeros(pix.shape[0])
    bounce = torch.zeros(pix.shape[0], dtype=torch.int32)
    acc_len, fold = zero, TI.fold_init(zero)
    for _ in range(steps):
        hit = TI.step_hit(ct, o, d, pix, sample, bounce, SEED)
        state = (o, d, bounce, acc_len, fold, pix, sample, SEED, active)
        st = TI.path_step(ct, o, d, bounce, acc_len, fold, pix, sample, SEED,
                          active, DEPTH)
        yield hit, state, st
        o, d, bounce, acc_len, fold = (st["o"], st["d"], st["bounce"],
                                       st["acc_len"], st["fold"])
        active = active & ~st["terminal"]


@pytest.mark.parametrize("name", list(SCENES))
def test_step_matches_jax_one_step(name):
    """Each chained step of the refactored path_step equals the JAX
    package's one_step body on the same inputs: the six flags exactly, the
    lane state and the colors to the render tests' tolerances, NaN where
    the JAX package has NaN; the chain meets the depth cap, scatters and
    ends paths by emission and by a miss."""
    cj, ct = _compiled(name)
    seen = dict.fromkeys(("capped", "scat", "emit", "miss"), 0)
    for (t, kind, idx), state, st in _chain(ct):
        if kind is None:
            kind, idx = TB.decode_planar_slot(ct.solids, idx)
        o, d, bounce, acc_len, fold, pix, sample, seed, active = state
        want = _JAX_STEP(cj, _j(o), _j(d), _j(t), _j(kind), _j(idx),
                         _j(bounce), _j(acc_len), _j(fold),
                         jnp.asarray(pix.numpy().astype(np.int32)),
                         jnp.asarray(sample.numpy().astype(np.int32)),
                         jnp.int32(seed), _j(active), max_depth=DEPTH)
        for k in S.FLAGS:
            np.testing.assert_array_equal(st[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)
            if k in seen:
                seen[k] += int(st[k].sum())
        term = st["terminal"].numpy()
        np.testing.assert_allclose(st["color"].numpy()[term],
                                   np.asarray(want["color"])[term],
                                   rtol=1e-4, atol=1e-4)
        got, ref = S.lane_arrays(st), S.lane_arrays(want)
        dead = st["fold"][2]
        for k, g, r in zip(S.LANE_ARRAYS, got, ref):
            g, r = g.numpy(), np.asarray(r)
            if k in ("a0", "a1", "a2"):
                # a dead channel resolves to 0 whatever its A: the port
                # folds it as color * 0 (a finite operand for the
                # backward), the JAX package as color * prob
                live = ~dead[int(k[1])].numpy()
                g, r = g[live], r[live]
            tol = 1e-4 if k[:2] in ("a0", "a1", "a2", "b0", "b1", "b2") \
                else 1e-5
            np.testing.assert_allclose(g, r, rtol=tol, atol=tol, err_msg=k)
    assert min(seen.values()) > 0, seen


@pytest.mark.parametrize("name", ["mixed", "kitchen"])
def test_regenerated_rays_match_jax_camera(name):
    """Steps of the refactored wavefront step (hit, S1, scan, S2 through
    their wrappers): in the step where lanes first end, each took the next
    queue position in order, and its new ray equals the JAX package's
    camera ray for the (pixel, sample) that position assigns."""
    cj, ct = _compiled(name)
    wf = TI._Wavefront(ct.device, W, H, 50, 2, SEED, 256, None, None)
    wf.reset(ct, 1, None)
    pool = wf.pools[0]
    for _ in range(8):
        before = pool.qpos.clone()
        wf.step(ct, pool)
        term = pool.qpos != before
        n = int(term.sum())
        if n:
            break
    assert n > 0
    assert torch.equal(pool.qpos[term], torch.arange(256, 256 + n))
    assert int(wf.next_q) == 256 + n
    pix = pool.pixel[term]
    sample = pool.sample[term]
    want_pix, want_sample = TI.queue_assignment(pool.qpos[term], W, H, 1)
    assert torch.equal(pix, want_pix) and torch.equal(sample, want_sample)
    _, jo, jd = JI.camera_rays(cj, jnp.asarray(pix.numpy().astype(np.int32)),
                               W, H, jnp.asarray(sample.numpy()
                                                 .astype(np.int32)),
                               jnp.int32(SEED))
    for g, w in zip((*pool.o, *pool.d), (*jo, *jd)):
        np.testing.assert_allclose(g[term].numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    assert int(pool.bounce[term].abs().sum()) == 0
    assert float(pool.acc_len[term].abs().sum()) == 0.0


def test_many_light_pdf_sums_in_light_order():
    """Above 16 lights light_pdf_mean3 sums the batched (R, L) table's
    columns in light order (the order S1 sums them), bit for bit, and stays
    within 1e-4 of the JAX package's mean over that table."""
    cj, ct = _compiled("many_lights")
    g = np.random.default_rng(2)
    o = tuple(torch.from_numpy(g.uniform(-8, 8, 512).astype(np.float32))
              for _ in range(3))
    d = tuple(torch.from_numpy(g.normal(size=512).astype(np.float32))
              for _ in range(3))
    got = TX.light_pdf_mean3(ct.lights, o, d, kinds=ct.light_kinds)
    values = TX.light_pdf_values(ct.lights, o, d)
    acc = torch.zeros(512)
    for i in range(values.shape[1]):
        acc = acc + values[:, i]
    assert len(ct.light_kinds) > TX._MEAN3_UNROLL_MAX
    assert torch.equal(got, acc / values.shape[1])
    want = JX.light_pdf_mean3(cj.lights, _j(o), _j(d), kinds=cj.light_kinds)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
