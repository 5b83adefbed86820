"""The first hit's kernels on the CPU (``ops/first_hit.py``: CR
``camera_rays``, FH ``first_hit_shade``), where their wrappers run the plain
versions: ``camera_rays_plain`` and the FH plain functions
(``first_hit_aux_plain``, ``shade_albedo_plain``, ``shade_normal_plain``,
``shade_simple_plain``) against the JAX package's ``camera_rays``,
``first_hit_aux`` and debug shaders called directly on the same rays (a
partial, shuffled list of pixel ids; a lens and none; a medium, a blend, a
normal map, spheres and both faces of a light); the dispatch by device
with no launch counted; ``render_pixels`` and ``render_sample_batch`` with
a debug shader and the aux planes from one scene hit and one FH call; and
the argument names against ``csrc/first_hit.cu``'s enums.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solstrale_tpu as J
import solstrale_tpu_torch as T
from solstrale_tpu.renderer import integrator as JI
from solstrale_tpu.scene.compile import compile_scene as jcompile
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch.ops import first_hit as FH
from solstrale_tpu_torch.ops import step as TS
from solstrale_tpu_torch.renderer import integrator as TI
from solstrale_tpu_torch.scene.compile import compile_scene as tcompile

from test_torch_step_drive import _enum

torch.set_num_threads(2)

W, H, SEED, SAMPLE = 32, 24, 1, 2
TOL = dict(rtol=1e-4, atol=1e-4)
SCENES = {
    # a medium, a blend floor, a normal-mapped terrain, two spheres and the
    # room's quad light (the BVH route)
    "mixed16": lambda cfg, api: fixtures.mixed_bvh_scene(
        cfg, n_cells=16, api=api),
    # a normal map, a medium, spheres, quad and triangle lights (K4's route)
    "kitchen": lambda cfg, api: fixtures.kitchen_sink_scene(cfg, api=api),
    # spheres, a medium, a sphere light and a lens
    "small": lambda cfg, api: fixtures.small_scene(cfg, api=api),
    # no lens, triangles only (the BVH route without spheres or media)
    "sponza24": lambda cfg, api: fixtures.sponza_class_scene(
        cfg, n_cells=24, api=api),
}
# rays aimed at both faces of a light: the two origins, one on each side of
# it, and the box (centre, half extents) of the points they aim at on it:
# the room's ceiling quad, the kitchen's triangle light
LIGHT_RAYS = {"mixed16": ((0.0, 12.5, 0.0), (0.0, 8.0, 0.0),
                          (0.0, 10.5, 0.0), (3.5, 0.0, 3.5)),
              "kitchen": ((-1.0, 1.4, -1.0), (-1.0, 1.4, -5.0),
                          (-1.0, 1.4, -3.0), (0.2, 0.2, 0.0))}
_COMPILED = {}


@pytest.fixture
def compiled(monkeypatch):
    """(JAX compiled scene, port compiled scene on the CPU) of a scene,
    once per module; the JAX side's kernels switched to its Pallas versions
    (interpreted), as test_torch_shaders_kitchen.py does, so that both
    sides intersect the kitchen with the same formulas."""
    monkeypatch.setenv("SOLSTRALE_PALLAS", "1")

    def get(name):
        if name not in _COMPILED:
            def cfg(api):
                return api.RenderConfig(width=W, height=H,
                                        samples_per_pixel=2, seed=SEED)

            _COMPILED[name] = (jcompile(SCENES[name](cfg(J), J)),
                               tcompile(SCENES[name](cfg(T), T),
                                        device="cpu"))
        return _COMPILED[name]

    return get


def _pixel_ids(n, seed=3):
    """A partial, shuffled list of ``n`` of the image's pixel ids."""
    return np.random.default_rng(seed).permutation(W * H)[:n]


def _rays(name, ct):
    """(pixel ids, o, d) as numpy arrays: the camera rays of a shuffled
    subset of the image and, on scenes with a light to aim at, rays at both
    faces of it (pixel ids past the image's)."""
    pix = _pixel_ids(500)
    o, d = TI.camera_rays_plain(ct, torch.from_numpy(pix), SAMPLE, SEED, W,
                                H)
    o = np.stack([c.numpy() for c in o], -1)
    d = np.stack([c.numpy() for c in d], -1)
    if name in LIGHT_RAYS:
        a, b, centre, half = LIGHT_RAYS[name]
        k = 64
        aim = np.asarray(centre) + np.random.default_rng(5).uniform(
            -1.0, 1.0, (2 * k, 3)) * np.asarray(half)
        org = np.concatenate([np.tile(a, (k, 1)), np.tile(b, (k, 1))])
        o = np.concatenate([o, org]).astype(np.float32)
        d = np.concatenate([d, aim - org]).astype(np.float32)
        pix = np.concatenate([pix, W * H + np.arange(2 * k)])
    return pix, o, d


def _close_or_allowed(name, got, want):
    """rtol = atol = 1e-4; the textured mixed16 is allowed
    test_torch_shaders.py's measured-off values (at most 6 values and 2
    rays, from last-bit t differences between the JAX CPU path's hit
    formulas and the port's that pick another texel)."""
    got = got.numpy()
    if name != "mixed16":
        np.testing.assert_allclose(got, want, **TOL)
        return
    off = ~np.isclose(got, want, **TOL)
    assert off.sum() <= 6 and off.any(axis=-1).sum() <= 2, off.sum()
    assert np.isfinite(got).all()


@pytest.mark.parametrize("sample_form", ["int", "0-dim tensor"])
@pytest.mark.parametrize("name", ["small", "sponza24"])
def test_camera_rays_plain_matches_jax(compiled, name, sample_form):
    """camera_rays_plain against JAX's camera_rays on a partial, shuffled
    list of pixel ids, with a lens (small) and without (sponza24), the
    sample an int and a 0-dim tensor; the CR wrapper on CPU tensors is the
    plain version, bit for bit, and counts no launch."""
    cj, ct = compiled(name)
    assert (float(ct.camera.lens_radius) > 0) == (name == "small")
    pix = _pixel_ids(300)
    _, oj, dj = JI.camera_rays(cj, jnp.asarray(pix.astype(np.int32)), W, H,
                               jnp.int32(SAMPLE), jnp.int32(SEED))
    sample = SAMPLE if sample_form == "int" else torch.tensor(SAMPLE)
    tp = torch.from_numpy(pix)
    ot, dt = TI.camera_rays_plain(ct, tp, sample, SEED, W, H)
    for a, b in zip(ot + dt, oj + dj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    before = FH.camera_rays.launches
    p, ow, dw = TI.camera_rays(ct, tp, W, H, sample, SEED)
    assert FH.camera_rays.launches == before and p is tp
    assert all(torch.equal(a, b) for a, b in zip(ow + dw, ot + dt))


def _jax_and_port(compiled, name):
    cj, ct = compiled(name)
    pix, o, d = _rays(name, ct)
    jargs = (tuple(jnp.asarray(o[:, k]) for k in range(3)),
             tuple(jnp.asarray(d[:, k]) for k in range(3)),
             jnp.asarray(pix.astype(np.int32)), jnp.int32(SAMPLE),
             jnp.int32(SEED))
    targs = (tuple(torch.from_numpy(o[:, k].copy()) for k in range(3)),
             tuple(torch.from_numpy(d[:, k].copy()) for k in range(3)),
             torch.from_numpy(pix), SAMPLE, SEED)
    return cj, ct, jargs, targs


@pytest.mark.parametrize("name", ["mixed16", "kitchen", "small"])
def test_first_hit_aux_plain_matches_jax(compiled, name):
    """first_hit_aux_plain against JAX's first_hit_aux on the same rays:
    albedo and normal planes; rays at both faces of a light give its
    emission on the front and black on the back."""
    cj, ct, jargs, targs = _jax_and_port(compiled, name)
    want = JI.first_hit_aux(cj, *jargs)
    got = TI.first_hit_aux_plain(ct, *targs)
    for g, w in zip(got, want):
        _close_or_allowed(name, g, np.asarray(w))
    if name in LIGHT_RAYS:
        # the aux normal is 0 only on a miss
        light, hit = got[0][-128:], (got[1][-128:] != 0).any(-1)
        assert bool(((light == 0).all(-1) & hit).any()), "no back face hit"
        assert bool(((light > 1).all(-1) & hit).any()), "no front face hit"


@pytest.mark.parametrize("shader", ["albedo", "normal", "simple"])
@pytest.mark.parametrize("name", ["mixed16", "kitchen", "small"])
def test_debug_shader_plain_matches_jax(compiled, name, shader):
    """shade_albedo_plain / shade_normal_plain / shade_simple_plain against
    JAX's shade_albedo / shade_normal / shade_simple on the same rays; the
    public shade_* (FH's wrapper, from step_hit) on CPU tensors equal
    them bit for bit."""
    cj, ct, jargs, targs = _jax_and_port(compiled, name)
    want = getattr(JI, f"shade_{shader}")(cj, *jargs)
    got = getattr(TI, f"shade_{shader}_plain")(ct, *targs)
    assert got.shape == (targs[2].shape[0], 3)
    _close_or_allowed(name, got, np.asarray(want))
    assert torch.equal(getattr(TI, f"shade_{shader}")(ct, *targs), got)


@pytest.mark.parametrize("name", ["mixed16", "kitchen", "sponza24"])
def test_fh_on_cpu_is_the_plain_composition(compiled, name):
    """FH's wrapper on CPU tensors (through the public first_hit_aux and
    debug shaders, from step_hit: on sponza24 K1's raw planar slot) equals
    the torch compositions from scene_hit bit for bit, and counts no
    launch; every plane combination of one call equals the planes of
    separate calls."""
    _, ct, _, targs = _jax_and_port(compiled, name)
    before = (FH.first_hit_shade.launches, FH.camera_rays.launches)
    want_aux = TI.first_hit_aux_plain(ct, *targs)
    got_aux = TI.first_hit_aux(ct, *targs)
    assert all(torch.equal(a, b) for a, b in zip(got_aux, want_aux))
    for kind in (TI.SHADER_ALBEDO, TI.SHADER_NORMAL, TI.SHADER_SIMPLE):
        want = TI._DEBUG_PLAIN[kind](ct, *targs)
        for aux in (False, True):
            planes = TI.first_hit_planes(ct, *targs, shader_kind=kind,
                                         aux=aux)
            assert torch.equal(planes["color"], want)
            if aux:
                assert torch.equal(planes["albedo"], want_aux[0])
                assert torch.equal(planes["normal"], want_aux[1])
            else:
                assert planes["albedo"] is None and planes["normal"] is None
    assert (FH.first_hit_shade.launches, FH.camera_rays.launches) == before


def test_wrappers_refuse_other_devices(compiled):
    """CR and FH run their plain versions only on CPU tensors; any other
    device but CUDA raises, and so does a shader that is not a debug
    shader."""
    _, ct = compiled("small")
    pix = torch.zeros(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        FH.camera_rays(ct, pix, 1, SEED, W, H)
    t = torch.zeros(8, device="meta")
    ray = (t, t, t)
    with pytest.raises(ValueError, match="unsupported device"):
        FH.first_hit_shade(ct, t, t.int(), t.int(), ray, ray, pix, 1, SEED,
                           albedo=True)
    with pytest.raises(ValueError, match="not a debug shader"):
        FH.first_hit_shade(ct, t, t.int(), t.int(), ray, ray, pix, 1, SEED,
                           shader_kind=TI.SHADER_PATH)


@pytest.mark.parametrize("shader", [TI.SHADER_ALBEDO, TI.SHADER_SIMPLE])
def test_debug_render_with_aux_takes_one_hit_and_one_fh(compiled,
                                                        monkeypatch, shader):
    """render_pixels with a debug shader and the aux planes takes one scene
    hit and one FH call (color, albedo and normal together), and
    render_sample_batch one of each a sample; the planes equal the plain
    compositions' (the color of shade_*_plain, the aux planes of
    first_hit_aux_plain, from camera_rays_plain), summed in sample order."""
    _, ct = compiled("kitchen")
    calls = {"hit": 0, "fh": 0}
    hit, fh = TI.step_hit, FH.first_hit_shade

    def counted_hit(*a, **k):
        calls["hit"] += 1
        return hit(*a, **k)

    def counted_fh(*a, **k):
        calls["fh"] += 1
        return fh(*a, **k)

    monkeypatch.setattr(TI, "step_hit", counted_hit)
    monkeypatch.setattr(FH, "first_hit_shade", counted_fh)
    pix = torch.arange(W * H)
    kw = dict(width=W, height=H, max_depth=50, shader_kind=shader,
              need_aux=True)
    got = TI.render_pixels(ct, pix, SAMPLE, SEED, **kw)
    assert calls == {"hit": 1, "fh": 1}
    o, d = TI.camera_rays_plain(ct, pix, SAMPLE, SEED, W, H)
    want = (TI._DEBUG_PLAIN[shader](ct, o, d, pix, SAMPLE, SEED),
            *TI.first_hit_aux_plain(ct, o, d, pix, SAMPLE, SEED))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    calls.update(hit=0, fh=0)
    batch = TI.render_sample_batch(ct, SAMPLE, SEED, n_samples=2, **kw)
    assert calls == {"hit": 2, "fh": 2}
    nxt = TI.render_pixels(ct, pix, SAMPLE + 1, SEED, **kw)
    zero = torch.zeros((W * H, 3))
    for k in range(3):
        assert torch.equal(batch[k], TI.to_image(zero + got[k] + nxt[k], W,
                                                 H))
    assert int(batch[3]) == 2 * W * H


@pytest.mark.parametrize("enum,prefix,names,groups", [
    ("CamPtr", "CP_", FH.CAM_PTRS, {}),
    ("CamInt", "CV_", FH.CAM_INTS, {"CV_SAMPLE": "sample_size",
                                    "CV_SEED": "seed_size"}),
    ("FirstPtr", "FHP_", FH.FIRST_PTRS, {"FHP_RAY": "o0"}),
    ("FirstInt", "FHV_", FH.FIRST_INTS, {"FHV_PIXEL": "pixel_size",
                                        "FHV_SAMPLE": "sample_size",
                                        "FHV_SEED": "seed_size"}),
    ("CamBackPtr", "CBP_", FH.CAM_BACK_PTRS, {}),
    ("BackPtr", "FBP_", FH.FIRST_BACK_PTRS, {"FBP_RAY": "o0",
                                            "FBP_G_RAY": "g_o0"}),
    ("BackInt", "FBV_", FH.FIRST_BACK_INTS, {"FBV_PIXEL": "pixel_size",
                                            "FBV_SAMPLE": "sample_size",
                                            "FBV_SEED": "seed_size"})])
def test_first_hit_argument_names(enum, prefix, names, groups):
    """CR's, FH's, CRB's and FHB's wrappers fill the kernels' argument
    arrays by the names of ops/first_hit.py, at the indices
    csrc/first_hit.cu's enums give them: each enumerator is its name's
    index, a group's first name sits at its enumerator, and the arrays are
    as long as the enums count (CRB takes CR's int64 values)."""
    src = (Path(FH.__file__).parent.parent / "csrc" /
           "first_hit.cu").read_text()
    values = _enum(src, enum)
    assert values[prefix + "COUNT"] == len(names) == len(set(names))
    for key, value in values.items():
        if key == prefix + "COUNT":
            continue
        want = groups.get(key, key[len(prefix):].lower())
        assert names[value] == want, key
    if enum == "FirstPtr":
        assert values["FHP_PIXEL"] - values["FHP_RAY"] == len(FH.RAY)
    if enum == "BackPtr":
        assert values["FBP_PIXEL"] - values["FBP_RAY"] == len(FH.RAY)
        assert values["FBP_G_SPH"] - values["FBP_G_RAY"] == len(FH.RAY)


@pytest.mark.parametrize("name,value", [
    ("kFirstThreads", FH.THREADS),
    ("kMaxStageBytes", TS.STAGE_MAX_BYTES)])
def test_first_hit_constants_match_the_wrapper(name, value):
    """FH's block size (the wave ``first_hit_grid`` counts in) and the
    largest staging its persistent grid is sized for, as
    csrc/first_hit.cu states them, are the wrapper's: ``THREADS`` and
    ``ops.step.STAGE_MAX_BYTES``, the most ``stage_floats`` hands it."""
    src = (Path(FH.__file__).parent.parent / "csrc" /
           "first_hit.cu").read_text()
    assert f"constexpr int {name} = {value};" in src


def test_shader_kinds_match_the_kernel():
    """FH's shader argument is integrator.SHADER_*: the kernel's constants
    and the wrapper's accepted kinds say the same."""
    src = (Path(FH.__file__).parent.parent / "csrc" /
           "first_hit.cu").read_text()
    for name in ("ALBEDO", "NORMAL", "SIMPLE"):
        value = getattr(TI, f"SHADER_{name}")
        assert f"SHADER_{name} = {value}" in src
        assert value in FH.SHADERS
    assert TI.SHADER_PATH not in FH.SHADERS
