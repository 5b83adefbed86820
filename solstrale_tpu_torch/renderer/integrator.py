"""Wavefront path-tracing integrator on tensors: the path-tracing shader,
the debug shaders and the aux channels.

Port of the JAX package's ``renderer/integrator.py``. The main path: a fixed
pool of lanes drains the global (pixel, sample) work queue
(``trace_queued``); every iteration runs ``path_step``: ``scene_hit`` (the
BVH kernels K1-K3, or the fused scene hit K4 below 512 solids),
``full_hit_attributes``, ``scatter`` (materials, blend, textures, normal
maps, the 50/50 NEE mixture) and the forward clamp-fold, then accumulates
the finished paths and regenerates their lanes. On the card everything
after the scene hit is two kernels, S1 and S2 (``ops/step.py``); the torch
composition (``path_step_plain``, ``_Wavefront.step_plain``) is their plain
version. The differentiable route (``path_step_grad``) is S1 with its
backward kernel S1B, an autograd Function. Scenes the megakernel
gate accepts skip the wavefront:
``render_sample_batch`` renders their whole batch in one launch of K5
(``renderer/megakernel.py``), whose plain version runs ``path_step`` too.
``trace`` runs ``path_step`` on a wavefront of one lane per pixel
(``render_pixels``, the unit the debug shaders, aux channels and
``render_sample`` use). On the card the camera rays are one kernel, CR,
and the first hit's shading for the debug shaders and the aux planes one
more, FH (``ops/first_hit.py``); ``camera_rays_plain`` and
``first_hit_plain`` (built on ``first_hit_aux_plain`` and the
``shade_*_plain`` shaders) are their plain versions. Where a camera
tensor, a ray or a scene table requires grad, CR and FH run as autograd
Functions whose backwards are the kernels CRB and FHB (their plain
versions on the CPU), so the debug shaders and the aux planes
differentiate on both devices.

The reference's nested ``clamp(<=3) + NaN->0`` ScatterPdf semantics
(shader.rs:95-125) are folded forward with O(1) per-lane state using
``min(a*L, 3) = a*min(L, 3/a)`` for a >= 0; see the JAX module docstring
for the derivation. The loop carries the prefix product A, the running
bound B, a per-channel dead flag and an outer-pdf flag.

Vectors and colors are component tuples of (R,) tensors (``geo/soa.py``).
The JAX ``while_loop``s become Python loops. On the card, ``trace_queued``
replays each pool's steps as CUDA graphs and reads its loop test once a
replay, and the path shader's sample pass (``sample_pass``: CR and
``trace``'s bounces) replays one graph of the fixed trip; elsewhere each
loop test is one host read.
"""
from __future__ import annotations

import math
import weakref

import torch
import torch.utils.checkpoint

from ..geo import INF, RAY_T_MIN
from ..geo import soa
from ..geo.soa import (dot3, onb_from_w3, onb_local3, reflect3, refract3,
                       unit3, vneg, vscale, where3)
from ..ops import first_hit, rng, sweep
from ..ops import step as step_ops
from ..ops.bvh import bvh_closest_hit, bvh_planar_hit, decode_planar_slot
from ..ops.intersect import (hit_attributes_soa, light_pdf_mean3,
                             sample_light_direction3, table_rows)
from ..scene.compile import (BLEND, DIELECTRIC, DIFFUSE_LIGHT, ISOTROPIC,
                             KIND_MEDIUM, LAMBERTIAN, METAL, CompiledScene)
from . import megakernel

MAX_BLEND_DEPTH = 3

SHADER_PATH = 0
SHADER_ALBEDO = 1
SHADER_NORMAL = 2
SHADER_SIMPLE = 3


def mat_row(mats, mat_id):
    """Per-ray material parameters, each field a (R,) tensor."""
    a = table_rows(mats.attr, mat_id)
    return dict(kind=a[0].to(torch.int32),
                albedo_tex=a[1].to(torch.int32),
                normal_tex=a[2].to(torch.int32),
                fuzz=a[3], ior=a[4], atten=a[5],
                blend_factor=a[6],
                blend_m1=a[7].to(torch.int32),
                blend_m2=a[8].to(torch.int32))


def sample_texture(tex, tex_id, uv):
    """Arena texture lookup: nearest neighbour, abs-wrap, flipped v
    (texture.rs:167-180). uv is an (u, v) tuple of (R,); returns an
    (r, g, b) tuple. tex_id = -1 reads texture 0 (callers mask)."""
    idx = texel_index(tex, tex_id, uv)
    # index_select, not pixels[idx]: the same gather, but its backward is
    # index_add_ (atomic adds on the card), where indexing's sorts the
    # indices and adds each run of equal ones serially, which took 450 ms
    # a bounce at 1080p (a solid color is one texel that most rays read)
    px = torch.index_select(tex.pixels, 0, idx)
    return (px[:, 0], px[:, 1], px[:, 2])


def texel_index(tex, tex_id, uv):
    """The arena row (int64) that ``sample_texture`` reads."""
    tid = torch.clamp(tex_id, min=0)
    ta = table_rows(tex.attr, tid)
    off = ta[0].to(torch.int32)
    w = ta[1].to(torch.int32)
    h = ta[2].to(torch.int32)
    # the operand is non-negative, so fmod equals Python's % (jnp's)
    u = torch.fmod(torch.abs(uv[0]), 1.0)
    v = 1.0 - torch.fmod(torch.abs(uv[1]), 1.0)
    x = (u * (w - 1).to(torch.float32)).to(torch.int32)
    y = (v * (h - 1).to(torch.float32)).to(torch.int32)
    idx = off + y * w + x
    # out-of-range (NaN-derived) indices clamp, like a JAX gather
    return torch.clamp(idx, 0, tex.pixels.shape[0] - 1).long()


def resolve_blend(mats, mat_id, u_levels, features=frozenset(("blend",))):
    """Walk blend chains: pick material_1 if U > blend_factor else
    material_2, independently per level (material/mod.rs:429-444).
    Identity when the scene has no blend materials."""
    if "blend" not in features:
        return mat_id
    for lvl in range(MAX_BLEND_DEPTH):
        row = mat_row(mats, mat_id)
        is_blend = row["kind"] == BLEND
        pick1 = u_levels[lvl] > row["blend_factor"]
        nxt = torch.where(pick1, row["blend_m1"], row["blend_m2"])
        mat_id = torch.where(is_blend, nxt, mat_id)
    return mat_id


def shading_normal_of(cs, mat_id, attrs, row=None):
    """Material-transformed normal: tangent-space normal map through the
    hit frame (material/mod.rs:386-389); the geometric normal without a
    map, and exactly it when no material of the scene has one."""
    if "normal_maps" not in cs.features:
        return attrs["normal"]
    ntex = (row or mat_row(cs.materials, mat_id))["normal_tex"]
    tc = sample_texture(cs.textures, ntex, attrs["uv"])
    tex_n = (tc[0] * 2.0 - 1.0, tc[1] * 2.0 - 1.0, tc[2] * 2.0 - 1.0)
    mapped = onb_local3(attrs["tangent"], attrs["bitangent"],
                        attrs["normal"], tex_n)
    return where3(ntex >= 0, mapped, attrs["normal"])


_PER_SCENE = {}


def per_scene(cs: CompiledScene, name, make):
    """``make()``, computed once per compiled scene and dropped when the scene
    is collected: the kernels' packed tables (K4's media, K5's scene). The
    compiled scene itself stays a plain record of tables."""
    key = (id(cs), name)
    if key not in _PER_SCENE:
        _PER_SCENE[key] = make()
        weakref.finalize(cs, _PER_SCENE.pop, key, None)
    return _PER_SCENE[key]


# The per_scene name (the first item of its key tuple) of ``diff``'s
# captured inverse steps, which ``share_geometry_tables`` carries across
GRAD_STEP = "grad_step"
# ... and of ``sample_pass``'s captured passes (``_SamplePass``)
SAMPLE_PASS = "sample_pass"
# ... and of ``first_hit_pass``'s captured sample loops (``_FirstHitPass``)
FIRST_HIT_PASS = "first_hit_pass"


def share_geometry_tables(src: CompiledScene, dst: CompiledScene):
    """Give ``dst``, a copy of ``src`` with the same geometry (another
    texture arena: ``diff.set_texture_params``), ``src``'s packed media
    tables, so that the copy neither repacks them nor syncs for the box
    scale, and its inverse steps (``GRAD_STEP``), which copy the arena in
    at each call, so that an SGD loop captures its step once. K5's tables
    and the wavefront's, the sample pass's and the first-hit pass's graphs
    hold the texels and are not shared."""
    for (sid, name), value in list(_PER_SCENE.items()):
        if sid == id(src) and (name == "media" or (
                isinstance(name, tuple) and name[0] == GRAD_STEP)):
            per_scene(dst, name, lambda v=value: v)


def media_tables(cs: CompiledScene):
    """Every medium's boundary packed, with its padded box, for the media
    hit (K3), the fused scene hit (K4) and the render megakernel (K5):
    ``ops.sweep.MediaTables``."""
    return per_scene(cs, "media", lambda: sweep.pack_media(
        cs.media, cs.device, box_scale(cs)))


def box_scale(cs: CompiledScene):
    """The scene's largest coordinate, at least 1: over the solids, the
    media's boundaries and the camera's origin and lens, the scale of every
    ray origin and hit point. The media's boxes are padded by
    ``ops.sweep.MEDIUM_BOX_PAD`` of it."""
    coords = torch.cat([torch.cat(sweep.extent(s)) for s in
                        [cs.solids] + [m.boundary for m in cs.media]]).detach()
    cam = cs.camera
    return max(1.0, float(cam.origin.detach().abs().max()
                          + cam.lens_radius.detach()),
               float(coords[coords.isfinite()].abs().max()))


def scene_hit(cs: CompiledScene, o, d, pix, sample, bounce, seed,
              plain=False):
    """world.hit: closest solid hit plus constant-medium events. Returns
    (t, kind, idx) with kind = KIND_MEDIUM for volume scattering. Medium m
    draws its free-flight uniform with purpose rng.P_MEDIUM_BASE + m.

    BVH scenes: K1 over planar prims, then K2 (the sphere sweep,
    min-combined and decoded), then, with media, K3: one launch that draws,
    culls and updates (t, kind, idx) for every medium. Other scenes: the
    fused K4 (its plain version if ``plain``), one launch that draws, culls
    and decodes for the solids and every medium."""
    if cs.kbvh is None:
        fn = sweep.scene_hit_plain if plain else sweep.scene_hit
        return fn(cs.solids, media_tables(cs), o, d, pix, sample, bounce,
                  seed)
    t, kind, idx = bvh_closest_hit(cs.kbvh, cs.solids, o, d, RAY_T_MIN, INF)
    if not cs.media:
        return t, kind, idx
    return sweep.media_hit(media_tables(cs), o, d, t, kind, idx, pix, sample,
                           bounce, seed)


def full_hit_attributes(cs, o, d, t, kind, idx, pix, sample, bounce, seed):
    """hit_attributes_soa plus the medium overrides (random phase normal,
    unit tangents, zero uv, back face, phase material —
    constant_medium.rs:63-74)."""
    attrs = hit_attributes_soa(cs.solids, o, d, t, kind, idx,
                               has_spheres="spheres" in cs.features)
    if cs.media:
        is_med = (kind == KIND_MEDIUM)
        r1, r2, _, _ = rng.uniform4(pix, sample, bounce, rng.P_PHASE, seed)
        phase_n = rng.unit_vector3(r1, r2)
        one = torch.ones_like(t)
        ones = (one, one, one)
        med_mats = torch.stack([m.mat for m in cs.media])
        m_idx = torch.clamp(idx, 0, len(cs.media) - 1).long()
        attrs["normal"] = where3(is_med, phase_n, attrs["normal"])
        attrs["tangent"] = where3(is_med, ones, attrs["tangent"])
        attrs["bitangent"] = where3(is_med, ones, attrs["bitangent"])
        attrs["uv"] = (torch.where(is_med, 0.0, attrs["uv"][0]),
                       torch.where(is_med, 0.0, attrs["uv"][1]))
        attrs["front_face"] = torch.where(is_med, False, attrs["front_face"])
        attrs["mat"] = torch.where(is_med, med_mats[m_idx], attrs["mat"])
    return attrs


# --- forward clamp-fold state ------------------------------------------------
#   A         prefix product of color_j*prob_j over scatter levels so far
#   B         running clamp bound min_i 3*A_{i-1} over pdf levels so far
#   dead      channel forced to 0 by a NaN filtered at a pdf level
#   outer_pdf True once any pdf level has been folded

def fold_init(zero):
    """Identity fold state from a (R,) zero tensor."""
    one = zero + 1.0
    big = zero + INF
    f = zero > 1.0
    return ((one, one, one), (big, big, big), (f, f, f), f)


def fold_scatter(state, color, prob, is_pdf, scat):
    """Fold one scatter level into (A, B, dead, outer_pdf) where ``scat``;
    reproduces the reference's nested f(color*prob*L) recursion
    (shader.rs:85-125)."""
    A, B, dead, outer_pdf = state
    pdf_lvl = scat & is_pdf
    basic_lvl = scat & ~is_pdf
    nA, nB, nD = [], [], []
    # the level's factor is 0 on a lane that does not scatter and on a
    # channel the fold drops: the forward discards both, and a finite
    # operand there keeps the backward from 0 x NaN
    prob_scat = torch.where(scat, prob, 0.0)
    for c in range(3):
        nan_a = torch.isnan(color[c] * prob)
        # pdf level: records its clamp bound 3*A_prev, filters its own NaNs
        nB.append(torch.where(pdf_lvl, torch.minimum(B[c], 3.0 * A[c]), B[c]))
        # basic level: its NaN is filtered by the nearest OUTER pdf level
        d = dead[c] | (pdf_lvl & nan_a) | (basic_lvl & nan_a & outer_pdf)
        nD.append(d)
        a = color[c] * torch.where(d, 0.0, prob_scat)
        nA.append(torch.where(scat, A[c] * a, A[c]))
    return tuple(nA), tuple(nB), tuple(nD), outer_pdf | pdf_lvl


def fold_resolve(state, term_color):
    """Terminal color through the folded clamps: min(A*T, B), a NaN
    terminal filtered by the innermost pdf level when there is one."""
    A, B, dead, outer_pdf = state
    out = []
    for c in range(3):
        dead_t = dead[c] | (torch.isnan(term_color[c]) & outer_pdf)
        t_c = torch.where(dead_t, 0.0, term_color[c])
        out.append(torch.where(dead_t, 0.0,
                               torch.minimum(A[c] * t_c, B[c])))
    return tuple(out)


def scatter(cs: CompiledScene, o, d, attrs, pix, sample, bounce, seed):
    """Material dispatch: every material model's scatter, selected per ray.
    Returns is_emission, emit_color, atten, new_dir, tape_color, prob,
    is_pdf, shading_normal, is_basic, and mat (the effective material)."""
    mats = cs.materials

    if "blend" in cs.features:
        u_b = rng.uniform4(pix, sample, bounce, rng.P_BLEND_SCATTER, seed)
        eff = resolve_blend(mats, attrs["mat"], u_b)
        u_bn = rng.uniform4(pix, sample, bounce, rng.P_BLEND_NORMAL, seed)
        eff_n = resolve_blend(mats, attrs["mat"], u_bn)
        row = mat_row(mats, eff)
        row_n = mat_row(mats, eff_n)
    else:
        eff = eff_n = attrs["mat"]
        row = row_n = mat_row(mats, eff)
    s_normal = shading_normal_of(cs, eff_n, attrs, row=row_n)

    mk = row["kind"]
    albedo = sample_texture(cs.textures, row["albedo_tex"], attrs["uv"])

    is_light = mk == DIFFUSE_LIGHT
    is_lamb = mk == LAMBERTIAN
    is_iso = mk == ISOTROPIC
    is_metal = mk == METAL
    is_diel = mk == DIELECTRIC
    is_pdf = is_lamb | is_iso

    # --- emission (material/mod.rs:359-368) ---
    emit_color = tuple(torch.where(attrs["front_face"], c, 0.0)
                       for c in albedo)
    atten = row["atten"]

    # --- pdf-mixture scatter (material/mod.rs:191-207, 396-410) ---
    # material kinds absent from the scene run no code (bit-identical)
    has_iso = "isotropic" in cs.features
    has_metal = "metal" in cs.features
    has_diel = "dielectric" in cs.features

    r1, r2, _, _ = rng.uniform4(pix, sample, bounce, rng.P_COSINE, seed)
    ct, cb, cn = onb_from_w3(s_normal)
    cos_dir = onb_local3(ct, cb, cn, rng.cosine_direction3(r1, r2))
    bsdf_dir = (where3(is_iso, rng.unit_vector3(r1, r2), cos_dir)
                if has_iso else cos_dir)

    n_lights = cs.lights.kind.shape[0]
    u_pick = rng.uniform(pix, sample, bounce, rng.P_LIGHT_PICK, seed)
    pick = torch.clamp((u_pick * n_lights).to(torch.int32), max=n_lights - 1)
    l1, l2, _, _ = rng.uniform4(pix, sample, bounce, rng.P_LIGHT_SAMPLE, seed)
    light_dir = sample_light_direction3(cs.lights, attrs["point"], pick,
                                        l1, l2, kinds=cs.light_kinds)

    u_coin = rng.uniform(pix, sample, bounce, rng.P_MIX_COIN, seed)
    pdf_dir = where3(u_coin < 0.5, light_dir, bsdf_dir)

    light_val = light_pdf_mean3(cs.lights, attrs["point"], pdf_dir,
                                kinds=cs.light_kinds)
    unit_pdf_dir = unit3(pdf_dir)
    cos_value = torch.clamp(dot3(unit_pdf_dir, unit3(s_normal)),
                            min=0.0) / math.pi
    sphere_value = 1.0 / (4.0 * math.pi)
    bsdf_val = (torch.where(is_iso, sphere_value, cos_value)
                if has_iso else cos_value)
    mix_val = 0.5 * light_val + 0.5 * bsdf_val

    cos_sc = dot3(s_normal, unit_pdf_dir)
    lamb_sc = torch.where(cos_sc < 0.0, 0.0, cos_sc / math.pi)
    scat_pdf = (torch.where(is_iso, sphere_value, lamb_sc)
                if has_iso else lamb_sc)
    prob = scat_pdf / mix_val

    new_dir = pdf_dir
    if has_metal:
        # --- metal (material/mod.rs:239-249) ---
        f1, f2, f3, _ = rng.uniform4(pix, sample, bounce, rng.P_FUZZ, seed)
        reflected = reflect3(unit3(d), s_normal)
        metal_dir = soa.vadd(reflected,
                             vscale(rng.in_unit_sphere3(f1, f2, f3),
                                    row["fuzz"]))
        new_dir = where3(is_metal, metal_dir, new_dir)

    if has_diel:
        # --- dielectric (material/mod.rs:279-316) ---
        ior = row["ior"]
        rr = torch.where(attrs["front_face"], 1.0 / ior, ior)
        udir = unit3(d)
        cos_t = torch.clamp(dot3(vneg(udir), s_normal), max=1.0)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        cannot = rr * sin_t > 1.0
        r0 = (1.0 - rr) / (1.0 + rr)
        r0 = r0 * r0
        # x**5 as lax.integer_pow evaluates it: x * ((x*x) * (x*x))
        q = 1.0 - cos_t
        q2 = q * q
        reflectance = r0 + (1.0 - r0) * (q * (q2 * q2))
        u_d = rng.uniform(pix, sample, bounce, rng.P_DIELECTRIC, seed)
        diel_dir = where3(cannot | (reflectance > u_d),
                          reflect3(udir, s_normal),
                          refract3(udir, s_normal, rr))
        new_dir = where3(is_diel, diel_dir, new_dir)

    # Detached-sampling estimator: gradients flow through color and
    # emission values, never through sample directions or pdf weights
    # (material/mod.rs:202-206's probability is a sampling artifact).
    new_dir = tuple(c.detach() for c in new_dir)
    prob = prob.detach()

    return dict(
        is_emission=is_light,
        emit_color=emit_color,
        atten=atten,
        new_dir=new_dir,
        tape_color=albedo,
        albedo_tex=row["albedo_tex"],
        prob=torch.where(is_pdf, prob, 1.0),
        is_pdf=is_pdf,
        shading_normal=s_normal,
        normal_tex=row_n["normal_tex"],
        is_basic=is_metal | is_diel,
        mat=eff,
    )


def step_hit(cs: CompiledScene, o, d, pixel, sample, bounce, seed):
    """The scene hit as S1 (``ops.step.step_shade``) takes it: ``scene_hit``'s
    (t, kind, idx), or on a BVH scene without spheres and media K1's (t,
    planar slot) with kind None, which S1 decodes itself (the decode
    ``bvh_closest_hit`` runs in torch)."""
    if cs.kbvh is not None and not cs.kbvh.has_spheres and not cs.media:
        t, slot = bvh_planar_hit(cs.kbvh, o, d, RAY_T_MIN)
        return t, None, slot
    return scene_hit(cs, o, d, pixel, sample, bounce, seed)


def path_step(cs: CompiledScene, o, d, bounce, acc_len, fold, pixel, sample,
              seed, active, max_depth, color=None):
    """One bounce of every lane, the body that ``trace_queued`` and the
    plain megakernel share: scene hit, attributes, scatter, terminal
    classification, the terminal color through the clamp-fold, and the fold
    of this bounce's scatter level. The scene-hit kernels (``step_hit``),
    then S1 (``ops.step.step_shade``: one launch on the card, its plain
    version ``shade_plain`` on the CPU). Returns a dict:

    - ``terminal``: lanes whose path ended here (miss, depth cap, emission);
    - ``miss``, ``capped``, ``emit``, ``scat``: the four kinds of segment
      (``terminal`` is the first three), and ``is_pdf``: a scatter with the
      NEE mixture (Lambertian, isotropic) rather than metal or dielectric;
    - ``color``: (R, 3) contributions of the ended paths;
    - ``o``, ``d``, ``bounce``, ``acc_len``: the state a lane that goes on
      carries (a terminal lane's are the caller's to regenerate);
    - ``fold``: the fold state, already reset on terminal lanes.

    With ``color``, the (R, 3) color each lane carries, it is ``trace``'s
    carry form (``active`` the lanes alive): ``color`` is the carried color
    with the ended paths' contributions written in, ``d`` is parked (zero)
    on every lane that does not go on, and ``alive`` (alive & ~terminal)
    is added, the ``scat`` flag."""
    t, kind, idx = step_hit(cs, o, d, pixel, sample, bounce, seed)
    return step_ops.step_shade(cs, t, kind, idx, o, d, bounce, acc_len, fold,
                               pixel, sample, seed, active, max_depth,
                               color=color)


def path_step_grad(cs: CompiledScene, o, d, bounce, acc_len, fold, pixel,
                   sample, seed, active, max_depth, color):
    """``path_step`` in the carry form on the differentiable route: the
    scene-hit kernels (``step_hit``), then ``ops.step.step_shade_grad``,
    S1 as an autograd Function whose backward is S1B (the plain versions of
    both on the CPU). Gradients reach the carried color, the fold, the
    texture arena, the background and the materials' attenuation factors.
    Same dict as ``path_step``."""
    t, kind, idx = step_hit(cs, o, d, pixel, sample, bounce, seed)
    return step_ops.step_shade_grad(cs, t, kind, idx, o, d, bounce, acc_len,
                                    fold, pixel, sample, seed, active,
                                    max_depth, color)


def path_step_plain(cs: CompiledScene, o, d, bounce, acc_len, fold, pixel,
                    sample, seed, active, max_depth, color=None, plain=False,
                    mapped=False):
    """``path_step`` as the torch composition: ``scene_hit`` (its plain
    version if ``plain``), then ``shade_plain``. S1's plain version; autograd
    through it is the reference S1B is held to."""
    t, kind, idx = scene_hit(cs, o, d, pixel, sample, bounce, seed,
                             plain=plain)
    return shade_plain(cs, o, d, t, kind, idx, bounce, acc_len, fold, pixel,
                       sample, seed, active, max_depth, color=color,
                       mapped=mapped)


def shade_plain(cs: CompiledScene, o, d, t, kind, idx, bounce, acc_len, fold,
                pixel, sample, seed, active, max_depth, record=False,
                color=None, mapped=False):
    """Everything ``path_step`` does after the scene hit, in torch: S1's
    plain version. Same dict as ``path_step`` (``color``: the carry form);
    with ``record`` it also holds S1's record for the backward
    (``ops.step.shade_record``), with ``mapped`` the lanes that scatter off
    a normal map (K5's work count, ``render_batch_megakernel_plain``)."""
    finite = torch.isfinite(t)
    miss = active & ~finite
    t_safe = torch.where(finite, t, 0.0)
    attrs = full_hit_attributes(cs, o, d, t_safe, kind, idx, pixel, sample,
                                bounce, seed)
    sc = scatter(cs, o, d, attrs, pixel, sample, bounce, seed)

    capped = active & finite & (bounce >= max_depth)
    emit = active & finite & ~capped & sc["is_emission"]
    scat = active & finite & ~capped & ~sc["is_emission"]
    terminal = miss | capped | emit

    total_len = acc_len + t_safe
    term_color = tuple(
        torch.where(miss, cs.bg_color[c],
                    torch.where(emit, sc["emit_color"][c], 0.0))
        for c in range(3))
    term_af = torch.where(emit, sc["atten"], 0.0)
    term_acc = torch.where(emit, total_len, 0.0)
    L = fold_resolve(fold, term_color)
    atten = term_af > 0.0
    att = torch.where(atten, 1.0 / (1.0 + term_af * term_acc), 1.0)

    # fold this bounce's scatter level; reset terminal lanes
    A, B, dead, outer = fold_scatter(fold, sc["tape_color"], sc["prob"],
                                     sc["is_pdf"], scat)
    extra = {}
    if record:
        dead_t = tuple(fold[2][c] | (torch.isnan(term_color[c]) & fold[3])
                       for c in range(3))
        row = torch.where(emit | scat, texel_index(
            cs.textures, sc["albedo_tex"], attrs["uv"]).to(torch.int32), -1)
        extra["record"] = step_ops.shade_record(
            row, torch.where(scat, sc["prob"], 0.0), att, miss,
            emit & attrs["front_face"], scat, scat & sc["is_pdf"], terminal,
            dead_t, dead, atten, term_acc, sc["mat"])
    if mapped:
        extra["mapped"] = scat & (sc["normal_tex"] >= 0) if (
            "normal_maps" in cs.features) else torch.zeros_like(scat)
    fold = (tuple(torch.where(terminal, 1.0, A[c]) for c in range(3)),
            tuple(torch.where(terminal, INF, B[c]) for c in range(3)),
            tuple(torch.where(terminal, False, dead[c]) for c in range(3)),
            torch.where(terminal, False, outer))
    shaded = torch.stack([L[c] * att for c in range(3)], -1)
    d_rest = d
    if color is not None:
        # the carry form: an ended path's color, the carried one elsewhere;
        # a lane that does not go on parks
        shaded = torch.where(terminal[:, None], shaded, color)
        extra["alive"] = active & ~terminal
        d_rest = (0.0, 0.0, 0.0)
    return dict(terminal=terminal, miss=miss, capped=capped, emit=emit,
                scat=scat, is_pdf=sc["is_pdf"], color=shaded,
                o=where3(scat, attrs["point"], o),
                d=tuple(torch.where(scat, n, r)
                        for n, r in zip(sc["new_dir"], d_rest)),
                bounce=torch.where(scat, bounce + 1, bounce),
                acc_len=torch.where(scat, total_len, acc_len), fold=fold,
                **extra)


def _tile_swizzle(width, height):
    """Screen tile for the full-image queue order: consecutive queue slots
    cover a (tw x th) tile, so neighbouring lanes trace neighbouring
    pixels (coherent BVH walks). Pure bijection; the RNG keys off the
    pixel id, so the image does not depend on it."""
    for tw, th in ((32, 32), (32, 16), (32, 8), (32, 4), (64, 2)):
        if width % tw == 0 and height % th == 0:
            return tw, th
    return None


def queue_assignment(qpos, width, height, sample_start=0):
    """trace_queued's queue order: queue position -> (pixel id, sample
    id), tile-swizzled within each sample where the image allows."""
    n_pix = width * height
    pslot = qpos % n_pix
    samp = sample_start + qpos // n_pix
    swz = _tile_swizzle(width, height)
    if swz is None:
        return pslot, samp
    tw, th = swz
    tile, within = pslot // (tw * th), pslot % (tw * th)
    tx, ty = tile % (width // tw), tile // (width // tw)
    return (ty * th + within // tw) * width + tx * tw + within % tw, samp


def camera_rays_plain(cs, pixel, sample, seed, width, height):
    """Jittered thin-lens primary rays (renderer/mod.rs:262-265,
    camera.rs:77-89); pixel (x, y) is v-up. CR's plain version
    (``ops.first_hit.camera_rays``), and the camera part of the plain
    versions of S2 (``_Wavefront.camera``) and K5."""
    x = (pixel % width).to(torch.float32)
    y = (pixel // width).to(torch.float32)
    j1, j2, _, _ = rng.uniform4(pixel, sample, 0, rng.P_JITTER, seed)
    u = (x + j1) / (width - 1)
    v = (y + j2) / (height - 1)
    cam = cs.camera
    l1, l2, _, _ = rng.uniform4(pixel, sample, 0, rng.P_LENS, seed)
    rd = rng.in_unit_disc3(l1, l2)
    rd0 = rd[0] * cam.lens_radius
    rd1 = rd[1] * cam.lens_radius
    use_lens = cam.lens_radius > 0.0
    o = []
    d = []
    for c in range(3):
        off = torch.where(use_lens, cam.u[c] * rd0 + cam.v[c] * rd1, 0.0)
        o.append(cam.origin[c] + off)
        d.append(cam.lower_left[c] + cam.horizontal[c] * u
                 + cam.vertical[c] * v - cam.origin[c] - off)
    return tuple(o), tuple(d)


def camera_rays(cs: CompiledScene, pix, width, height, sample, seed):
    """Jittered thin-lens primary rays for an arbitrary batch of pixel ids
    (the JAX name and signature): CR (``ops.first_hit.camera_rays``; on the
    CPU its plain version ``camera_rays_plain``), differentiable in the
    camera's tensors (CRB). Returns (pix, o, d), o and d component
    tuples."""
    o, d = first_hit.camera_rays(cs, pix, sample, seed, width, height)
    return pix, o, d


def _lanes(x, pix):
    """A lane counter as the hit kernels take it: a contiguous tensor of
    ``pix``'s shape (an int becomes an int64 fill)."""
    if isinstance(x, torch.Tensor):
        return x.expand(pix.shape).contiguous()
    return torch.full(pix.shape, int(x), dtype=torch.int64, device=pix.device)


def remat_chunk(max_depth):
    """Bounces per checkpointed chunk of the fixed trip's backward: the
    largest divisor k of ``max_depth`` with k * k <= 2 * max_depth (10 at
    depth 50), the JAX package's rule."""
    return max((k for k in range(1, max_depth + 1)
                if max_depth % k == 0 and k * k <= 2 * max_depth), default=1)


def trace(cs: CompiledScene, o, d, pix, sample, seed, max_depth,
          early_exit=True, differentiable=False):
    """Full path trace of a ray wavefront -> linear color (R, 3), one
    ``path_step`` per bounce for every lane (the body ``trace_queued``
    runs), in its carry form: S1 takes each lane's color and alive flag
    and returns them updated, so a lane whose path ends keeps its color
    and parks with a zero direction, which every hit kernel rejects, and
    the bounce loop runs nothing of its own. Step ``max_depth`` is the
    depth cap: a ray still alive that hits shades to black, a miss takes
    the background (renderer/mod.rs:164-206).

    ``early_exit=True`` stops once no lane is alive (one host read a
    bounce; ``render_pixels`` on the card replays the fixed trip as a CUDA
    graph instead, ``_SamplePass``); ``early_exit=False`` always runs all
    ``max_depth + 1`` steps and gives the same image bit for bit, because
    a parked lane's step changes nothing. Under grad the fixed trip is the
    path-replay backward: its first ``max_depth`` steps run in chunks of
    ``remat_chunk`` under ``torch.utils.checkpoint``, so only the lane
    carry (~30 values a lane) is kept between chunks and the backward
    replays each chunk; the counter-keyed RNG and the deterministic kernels
    draw the same paths again.

    ``differentiable`` names the route autograd runs through: every bounce
    is ``path_step_grad``, S1 with its backward S1B, which take gradients
    to the carried color, the fold, the texture arena, the background and
    the materials' attenuation factors (the plain versions on the CPU), the
    last three summed over the trace's bounces in buffers of a backward
    pass (``ops.step.grad_scene``, applied here once).
    Otherwise every bounce is ``path_step`` (S1 alone on the card),
    whether grad mode is on or not; S1's wrapper raises when a table it
    reads requires grad."""
    sample = _lanes(sample, pix)
    step = path_step
    if differentiable:
        step, cs = path_step_grad, step_ops.grad_scene(cs)

    def steps(carry, n):
        return _bounces(cs, carry, pix, sample, seed, max_depth, n, step)

    carry = _trace_carry(o, d, pix)
    if early_exit:
        for _ in range(max_depth + 1):
            if not bool(carry[5].any()):
                break
            carry = steps(carry, 1)
    elif torch.is_grad_enabled():
        chunk = remat_chunk(max_depth)
        for _ in range(max_depth // chunk):
            carry = torch.utils.checkpoint.checkpoint(
                steps, carry, chunk, use_reentrant=False,
                preserve_rng_state=False)
        carry = steps(carry, 1)
    else:
        carry = steps(carry, max_depth + 1)
    return carry[6]


def _trace_carry(o, d, pix):
    """``trace``'s carry before the first bounce: (o, d, bounce, acc_len,
    fold, alive, color), every lane alive with a zero color."""
    zero = torch.zeros_like(o[0])
    bounce = torch.zeros(pix.shape, dtype=torch.int32, device=zero.device)
    alive = torch.ones(pix.shape, dtype=torch.bool, device=zero.device)
    color = torch.zeros((zero.shape[0], 3), dtype=torch.float32,
                        device=zero.device)
    return o, d, bounce, zero, fold_init(zero), alive, color


def _bounces(cs, carry, pix, sample, seed, max_depth, n, step=path_step):
    """``n`` bounces of ``trace``'s carry (``sample``: the lane tensor):
    ``step`` (``path_step`` or ``path_step_grad``) and nothing else. A lane
    that is not alive keeps its carry, so bounces past ``max_depth + 1``
    change nothing."""
    o, d, bounce, acc_len, fold, alive, color = carry
    for _ in range(n):
        st = step(cs, o, d, bounce, acc_len, fold, pix, sample, seed, alive,
                  max_depth, color)
        o, d, bounce, acc_len, fold, alive, color = (
            st["o"], st["d"], st["bounce"], st["acc_len"], st["fold"],
            st["alive"], st["color"])
    return o, d, bounce, acc_len, fold, alive, color


def _depth0(pix, sample):
    """The sample and bounce counters of the first hit as lane tensors."""
    return _lanes(sample, pix), torch.zeros(pix.shape, dtype=torch.int32,
                                            device=pix.device)


def _first_hit(cs, o, d, pix, sample, seed, hit=None):
    """Scene hit (``hit``: (t, kind, idx) as ``step_hit`` gives it, else
    ``scene_hit``'s) and attributes at depth 0: (hit mask, attrs, the sample
    and bounce counters as lane tensors)."""
    sample, bounce = _depth0(pix, sample)
    if hit is None:
        hit = scene_hit(cs, o, d, pix, sample, bounce, seed)
    t, kind, idx = hit
    if kind is None:
        kind, idx = decode_planar_slot(cs.solids, idx)
    hit = torch.isfinite(t)
    attrs = full_hit_attributes(cs, o, d, torch.where(hit, t, 0.0), kind,
                                idx, pix, sample, bounce, seed)
    return hit, attrs, sample, bounce


def first_hit_aux_plain(cs: CompiledScene, o, d, pix, sample, seed,
                        hit=None):
    """Albedo and normal aux channels at depth 0 (renderer/mod.rs:175-189
    with the reference's flag inversion fixed): albedo = the scatter color
    (the emission color on a light), normal = the shading normal; the
    background and zero on a miss. Returns two (R, 3) tensors. The torch
    composition (``first_hit_aux`` on the CPU), from ``scene_hit`` or the
    given ``hit``."""
    hit, attrs, sample, bounce = _first_hit(cs, o, d, pix, sample, seed, hit)
    sc = scatter(cs, o, d, attrs, pix, sample, bounce, seed)
    albedo = torch.stack([
        torch.where(hit, torch.where(sc["is_emission"], sc["emit_color"][c],
                                     sc["tape_color"][c]), cs.bg_color[c])
        for c in range(3)], -1)
    normal = torch.stack([torch.where(hit, sc["shading_normal"][c], 0.0)
                          for c in range(3)], -1)
    return albedo, normal


# --- single-bounce debug shaders (shader.rs:127-215) ----------------------
# The torch compositions (``*_plain``, from ``scene_hit`` or the given
# ``hit``); ``shade_albedo`` / ``shade_normal`` / ``shade_simple`` run the
# scene-hit kernels and FH (``first_hit_planes``).

def shade_albedo_plain(cs, o, d, pix, sample, seed, hit=None):
    albedo, _ = first_hit_aux_plain(cs, o, d, pix, sample, seed, hit)
    return albedo


def shade_normal_plain(cs, o, d, pix, sample, seed, hit=None):
    """The shading normal at the first hit (the blend chain resolved with
    the normal draw), the background on a miss."""
    hit, attrs, sample, bounce = _first_hit(cs, o, d, pix, sample, seed, hit)
    u_bn = rng.uniform4(pix, sample, bounce, rng.P_BLEND_NORMAL, seed)
    eff_n = resolve_blend(cs.materials, attrs["mat"], u_bn, cs.features)
    normal = shading_normal_of(cs, eff_n, attrs)
    return torch.stack([torch.where(hit, normal[c], cs.bg_color[c])
                        for c in range(3)], -1)


def shade_simple_plain(cs, o, d, pix, sample, seed, hit=None):
    """Flat shading: the emission color, or the albedo times
    (n.l * 0.5 + 0.75) with l = (1, 1, -1) (shader.rs:191-215)."""
    hit, attrs, sample, bounce = _first_hit(cs, o, d, pix, sample, seed, hit)
    sc = scatter(cs, o, d, attrs, pix, sample, bounce, seed)
    n = sc["shading_normal"]
    factor = (n[0] * 1.0 + n[1] * 1.0 + n[2] * -1.0) * 0.5 + 0.75
    return torch.stack([
        torch.where(hit, torch.where(sc["is_emission"], sc["emit_color"][c],
                                     sc["tape_color"][c] * factor),
                    cs.bg_color[c]) for c in range(3)], -1)


_DEBUG_PLAIN = {SHADER_ALBEDO: shade_albedo_plain,
                SHADER_NORMAL: shade_normal_plain,
                SHADER_SIMPLE: shade_simple_plain}


def first_hit_plain(cs, o, d, t, kind, idx, pix, sample, seed,
                    shader_kind=None, albedo=False, normal=False):
    """FH's plain version (``ops.first_hit.first_hit_shade``): from the
    scene hit at depth 0 (t, kind, idx; kind None: K1's planar slot), the
    debug shader ``shader_kind``'s color (None: none) and the aux albedo
    and normal planes asked for, by the torch compositions above. Returns
    a dict of (R, 3) tensors, None where not asked for."""
    hit = (t, kind, idx)
    out = dict(color=None, albedo=None, normal=None)
    if shader_kind is not None:
        out["color"] = _DEBUG_PLAIN[shader_kind](cs, o, d, pix, sample, seed,
                                                 hit)
    if albedo or normal:
        a, n = first_hit_aux_plain(cs, o, d, pix, sample, seed, hit)
        out.update(albedo=a if albedo else None, normal=n if normal else None)
    return out


def first_hit_planes(cs: CompiledScene, o, d, pix, sample, seed,
                     shader_kind=None, aux=False):
    """The first hit's planes from one scene hit (``step_hit`` at depth 0)
    and one FH launch (``ops.first_hit.first_hit_shade``; on the CPU their
    plain versions): the debug shader ``shader_kind``'s color (None: none)
    and, with ``aux``, the albedo and normal planes. Returns FH's dict;
    the planes differentiate in the arena, the background, the rays and
    the frame columns of ``sph_attr`` and ``pl_attr`` (FHB)."""
    t, kind, idx = step_hit(cs, o, d, pix, *_depth0(pix, sample), seed)
    return first_hit.first_hit_shade(cs, t, kind, idx, o, d, pix, sample,
                                     seed, shader_kind, albedo=aux,
                                     normal=aux)


def first_hit_aux(cs: CompiledScene, o, d, pix, sample, seed):
    """Albedo and normal aux channels at depth 0 (``first_hit_aux_plain``
    says what they hold): the scene-hit kernels and FH. Returns two (R, 3)
    tensors."""
    planes = first_hit_planes(cs, o, d, pix, sample, seed, aux=True)
    return planes["albedo"], planes["normal"]


# The counterparts of the JAX package's public debug shaders, one debug
# color each from ``first_hit_planes``; ``render_pixels`` calls that
# directly, since a debug view with aux takes its planes from the same hit.

def shade_albedo(cs, o, d, pix, sample, seed):
    return first_hit_planes(cs, o, d, pix, sample, seed,
                            SHADER_ALBEDO)["color"]


def shade_normal(cs, o, d, pix, sample, seed):
    return first_hit_planes(cs, o, d, pix, sample, seed,
                            SHADER_NORMAL)["color"]


def shade_simple(cs, o, d, pix, sample, seed):
    return first_hit_planes(cs, o, d, pix, sample, seed,
                            SHADER_SIMPLE)["color"]


def render_pixels(cs: CompiledScene, pix, sample, seed, *, width, height,
                  max_depth, shader_kind, need_aux, early_exit=True,
                  differentiable=False):
    """Render a wavefront of pixel ids (one lane each, the whole wavefront
    in every launch) -> (color, albedo, normal), (R, 3) linear colors. The
    RNG keys off the pixel id, so any partition of the ids renders the
    same values. Without ``need_aux`` albedo and normal are zero. The
    camera rays are CR; a debug shader writes its color, and with
    ``need_aux`` the aux planes, from one scene hit and one FH launch
    (``first_hit_planes``). Where autograd records nothing (no scene table
    requires grad, or grad mode is off) that is ``first_hit_pass`` of one
    sample: on the card one CUDA graph replay; otherwise the planes
    differentiate through CR's and FH's autograd Functions (CRB, FHB),
    eagerly. The path shader with early exit (and not ``differentiable``)
    is ``sample_pass``: on the card one CUDA graph replay.
    ``differentiable``: the path shader's route for autograd (``trace``)."""
    if shader_kind == SHADER_PATH and early_exit and not differentiable:
        return sample_pass(cs, pix, sample, seed, width=width, height=height,
                           max_depth=max_depth, need_aux=need_aux)
    if shader_kind != SHADER_PATH and not step_ops.needs_grad(cs):
        return first_hit_pass(cs, pix, sample, seed, width=width,
                              height=height, shader_kind=shader_kind,
                              aux=need_aux, n_samples=1)
    _, o, d = camera_rays(cs, pix, width, height, sample, seed)
    if shader_kind != SHADER_PATH:
        planes = first_hit_planes(cs, o, d, pix, sample, seed, shader_kind,
                                  aux=need_aux)
        color = planes["color"]
        if need_aux:
            return color, planes["albedo"], planes["normal"]
        return color, torch.zeros_like(color), torch.zeros_like(color)
    color = trace(cs, o, d, pix, sample, seed, max_depth,
                  early_exit=early_exit, differentiable=differentiable)
    return color, *_aux_planes(cs, o, d, pix, sample, seed, color, need_aux)


def _aux_planes(cs, o, d, pix, sample, seed, color, need_aux):
    """(albedo, normal) of a path pass: ``first_hit_aux`` with
    ``need_aux``, else one zero plane like ``color`` as both."""
    if need_aux:
        return first_hit_aux(cs, o, d, pix, sample, seed)
    zero = torch.zeros_like(color)
    return zero, zero


def sample_pass_eager(cs: CompiledScene, pix, sample, seed, *, width, height,
                      max_depth, need_aux):
    """``sample_pass`` op by op: CR, ``trace`` with early exit (one host
    read a bounce), then with ``need_aux`` ``first_hit_aux`` on the same
    rays. The CPU's route; on the card, the route the graphs replaced,
    which they are held against."""
    _, o, d = camera_rays(cs, pix, width, height, sample, seed)
    color = trace(cs, o, d, pix, sample, seed, max_depth)
    return color, *_aux_planes(cs, o, d, pix, sample, seed, color, need_aux)


def sample_pass(cs: CompiledScene, pix, sample, seed, *, width, height,
                max_depth, need_aux):
    """The path shader's sample pass with early exit over the pixel ids
    ``pix``: (color, albedo, normal) as ``render_pixels`` returns them. The
    driver follows the scene's device. On the CPU, ``sample_pass_eager``.
    On the card, the JAX package's one device program a pass: one replay
    of ``_SamplePass``'s CUDA graph, the fixed trip of ``max_depth + 1``
    bounces with no host read (a parked lane's bounce changes nothing, and
    every hit kernel skips a parked lane's tests), captured once per
    compiled scene and (lane count, width, height, max_depth, seed as an
    int, need_aux); ``pix`` and ``sample`` (an int or a one-element int
    tensor) are written into the capture's own tensors each pass. The
    image equals ``sample_pass_eager``'s and the eager fixed trip's
    (``render_pixels(..., early_exit=False)``) bit for bit. A failed
    capture raises; so does a scene table that requires grad with grad
    mode on (S1 builds no autograd graph: the differentiable route is
    ``render_pixels(..., differentiable=True)``)."""
    kw = dict(width=width, height=height, max_depth=max_depth,
              need_aux=need_aux)
    if cs.device.type != "cuda":
        return sample_pass_eager(cs, pix, sample, seed, **kw)
    if step_ops.needs_grad(cs):
        raise ValueError("sample_pass: S1 alone builds no autograd graph; a "
                         "render that autograd runs through takes the "
                         "differentiable route (render_pixels(..., "
                         "differentiable=True): S1 with its backward S1B)")
    key = (pix.shape[0], width, height, max_depth, int(seed), need_aux)
    with torch.no_grad():
        driver = per_scene(cs, (SAMPLE_PASS, *key),
                           lambda: _SamplePass(cs, *key))
        return driver.run(pix, sample)


def first_hit_pass_eager(cs: CompiledScene, pix, sample_start, seed, *,
                         width, height, shader_kind, aux, n_samples):
    """``first_hit_pass`` op by op: for each sample ``sample_start + i`` in
    order, CR and ``first_hit_planes`` (the scene-hit kernels and one FH
    launch), each plane asked for added onto a zero plane. The CPU's
    route; on the card, the body ``_FirstHitPass`` captures and the route
    its graph is held against."""
    if pix is None:
        pix = torch.arange(width * height, dtype=torch.int64,
                           device=cs.device)
    zero = torch.zeros((pix.shape[0], 3), dtype=torch.float32,
                       device=cs.device)
    color = albedo = normal = zero
    for i in range(n_samples):
        sample = sample_start + i
        _, o, d = camera_rays(cs, pix, width, height, sample, seed)
        planes = first_hit_planes(cs, o, d, pix, sample, seed, shader_kind,
                                  aux=aux)
        if shader_kind is not None:
            color = color + planes["color"]
        if aux:
            albedo = albedo + planes["albedo"]
            normal = normal + planes["normal"]
    return color, albedo, normal


def first_hit_pass(cs: CompiledScene, pix, sample_start, seed, *, width,
                   height, shader_kind, aux, n_samples):
    """The first-hit samples of the pixel ids ``pix`` (None: every pixel
    of the image in id order), ``n_samples`` of them from ``sample_start``
    (an int or a one-element int tensor): the summed (color, albedo,
    normal) (R, 3) planes, the color the debug shader ``shader_kind``'s
    (None: no shader, a zero plane), the albedo and normal the aux planes
    with ``aux`` (else zero planes). The counterpart of the JAX package's
    jitted ``fori_loop`` of ``render_pixels`` or ``first_hit_aux``. The
    driver follows the scene's device. On the CPU, ``first_hit_pass_eager``.
    On the card, one replay of ``_FirstHitPass``'s CUDA graph with no host
    read, captured once per compiled scene and (lane count, width, height,
    seed as an int, shader_kind, aux, n_samples); the planes equal
    ``first_hit_pass_eager``'s bit for bit. A failed capture raises; so
    does a scene table that requires grad with grad mode on (the replay
    builds no autograd graph: ``render_pixels`` differentiates a debug
    shader's planes eagerly, through CRB and FHB)."""
    kw = dict(width=width, height=height, shader_kind=shader_kind, aux=aux,
              n_samples=n_samples)
    if cs.device.type != "cuda":
        return first_hit_pass_eager(cs, pix, sample_start, seed, **kw)
    if step_ops.needs_grad(cs):
        raise ValueError("first_hit_pass: a graph replay builds no autograd "
                         "graph; render_pixels differentiates a debug "
                         "shader's planes eagerly (CRB, FHB)")
    r = width * height if pix is None else pix.shape[0]
    key = (r, width, height, int(seed), shader_kind, aux, n_samples)
    with torch.no_grad():
        driver = per_scene(cs, (FIRST_HIT_PASS, *key),
                           lambda: _FirstHitPass(cs, *key))
        return driver.run(pix, sample_start)


def to_image(c, width, height):
    """(width*height, 3) in pixel-id order -> (height, width, 3) image rows,
    top row first (renderer/mod.rs:261)."""
    return torch.flip(c.reshape(height, width, 3), dims=(0,))


def render_sample(cs: CompiledScene, sample, seed, *, width, height,
                  max_depth, shader_kind, need_aux):
    """Render one full-image sample pass -> (pixel, albedo, normal) linear
    planes of shape (height, width, 3) in image-row order (the path shader:
    ``sample_pass``)."""
    pix = torch.arange(width * height, dtype=torch.int64, device=cs.device)
    planes = render_pixels(cs, pix, sample, seed, width=width, height=height,
                           max_depth=max_depth, shader_kind=shader_kind,
                           need_aux=need_aux)
    return tuple(to_image(c, width, height) for c in planes)


# Steps of one pool that a CUDA graph of the wavefront's card driver holds,
# and so the steps between two reads of its stop test: chosen from {1, 2,
# 4, 8} by measurement on the H100 (PERF.md, PR 12).
GRAPH_STEPS = 2


def _counted_wrappers():
    """The kernel wrappers a wavefront step or an inverse step launches
    through, each with its ``launches`` count: the hit kernels K1-K4, the
    draw kernel, the step kernels S1 and S2, S1's backward S1B and the
    first hit's CR and FH."""
    return (bvh_planar_hit, sweep.bvh_sphere_hit, sweep.media_hit,
            sweep.scene_hit, rng.uniform4, step_ops.step_shade,
            step_ops.step_regen, step_ops.step_shade_backward,
            first_hit.camera_rays, first_hit.first_hit_shade)


def _queue_sizes(width, height, n_samples, lanes, pix_ids, n_valid):
    """(rows of the result, pixels of the queue, queue entries, lanes of the
    wide pool)."""
    if pix_ids is None:
        n_rows = n_pix = width * height
    else:
        n_rows = pix_ids.shape[0]
        n_pix = n_rows if n_valid is None else int(n_valid)
    total_q = n_pix * n_samples
    if lanes is None:
        # large queues amortize per-iteration cost over more lanes; small
        # ones finish their drain tail sooner with half-size pools
        lanes = 131072 if total_q >= 1_500_000 else 65536
    return n_rows, n_pix, total_q, min(lanes, total_q)


class _Pool:
    """One pool of lanes: queue position, the pixel and sample ids it
    assigns, bounce, ray, accumulated length and fold state, each a tensor
    of its own that every step overwrites in place (so a captured step
    reads and writes the same memory on every replay), and a step's
    scratch: S1's colors and terminal flags."""

    def __init__(self, n, dev):
        def zeros(dtype=torch.float32):
            return torch.zeros((n,), dtype=dtype, device=dev)

        self.qpos = zeros(torch.int64)
        self.pixel = zeros(torch.int64)
        self.sample = zeros(torch.int64)
        self.bounce = zeros(torch.int32)
        self.o = tuple(zeros() for _ in range(3))
        self.d = tuple(zeros() for _ in range(3))
        self.acc_len = zeros()
        self.fold = (tuple(zeros() for _ in range(3)),
                     tuple(zeros() for _ in range(3)),
                     tuple(zeros(torch.bool) for _ in range(3)),
                     zeros(torch.bool))
        self.color = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        self.terminal = zeros(torch.bool)

    def lanes(self):
        """The lane state S1 updates, in ``ops.step.LANE_ARRAYS`` order."""
        return step_ops.lane_arrays(vars(self))

    def tensors(self):
        """Every per-lane tensor a compaction carries."""
        return [self.qpos, self.pixel, self.sample, *self.lanes()]

    def shade_out(self):
        """S1's outputs in this pool: the lane state in place, the colors
        and the terminal flags."""
        return dict(color=self.color, terminal=self.terminal, o=self.o,
                    d=self.d, bounce=self.bounce, acc_len=self.acc_len,
                    fold=self.fold)


class _Wavefront:
    """trace_queued's work queue for one (image or shard, n_samples,
    lanes, seed) in fixed tensors: the wide pool and, for 32,768 lanes or
    more, the tail pool an eighth as wide; the next free queue position;
    one accumulation row per queue entry plus a discard row; the segment
    count; the first sample id (``start``, a 0-dim int64 tensor) and the
    shard's pixel ids. ``step`` runs one iteration of a pool and writes its
    results back in place; ``stop_test`` writes whether the pool must go on
    into ``go``. Holds no reference to the scene: each method that needs it
    takes it."""

    def __init__(self, dev, width, height, max_depth, n_samples, seed,
                 lanes, pix_ids, n_valid):
        self.width, self.height = width, height
        self.max_depth, self.n_samples, self.seed = max_depth, n_samples, seed
        self.n_rows, self.n_pix, self.total_q, self.lanes = _queue_sizes(
            width, height, n_samples, lanes, pix_ids, n_valid)
        self.pix = None if pix_ids is None else torch.zeros_like(pix_ids)
        self.swizzle = _tile_swizzle(width, height) if pix_ids is None \
            else None
        self.tail_lanes = self.lanes // 8 if self.lanes >= 32768 else 0
        i64 = dict(dtype=torch.int64, device=dev)
        self.start = torch.zeros((), **i64)
        self.next_q = torch.zeros((), **i64)
        self.segments = torch.zeros((), **i64)
        self.go = torch.zeros((), dtype=torch.bool, device=dev)
        # S2's scan: its count of started blocks (0 between launches: the
        # kernel puts it back) and of its launches, and one status word a
        # block of the wide pool (tagged by the launch: never cleared)
        self.ticket = torch.zeros((2,), dtype=torch.int32, device=dev)
        self.scan_status = torch.zeros((step_ops.scan_words(self.lanes),),
                                       dtype=torch.int64, device=dev)
        self.accum = torch.zeros((self.total_q + 1, 3), dtype=torch.float32,
                                 device=dev)
        self.pools = [_Pool(n, dev) for n in (self.lanes, self.tail_lanes)
                      if n]

    def assignment(self, qpos):
        """Queue position -> (pixel id, sample id)."""
        if self.pix is None:
            return queue_assignment(qpos, self.width, self.height,
                                    self.start)
        return (self.pix[qpos % self.n_pix],
                self.start + qpos // self.n_pix)

    def row_of(self, qpos, pixel):
        """The accumulation row of a queue position: sample-major, by pixel
        id in the full image, by slot in a shard."""
        if self.pix is None:
            return (qpos // self.n_pix) * self.n_pix + pixel
        return qpos

    def camera(self, cs, qpos):
        """(pixel id, sample id, o, d) of these queue positions: camera
        rays, a position past the queue parked with a zero direction."""
        pixel, samp = self.assignment(torch.clamp(qpos, max=self.total_q - 1))
        o, d = camera_rays_plain(cs, pixel, samp, self.seed, self.width,
                                 self.height)
        parked = qpos >= self.total_q
        return pixel, samp, o, tuple(torch.where(parked, 0.0, c) for c in d)

    def begin(self, sample_start, pix_ids):
        """A new batch's counters from ``sample_start`` (an int or a 0-dim
        tensor): the queue, rows and segments zeroed. The pool's first
        camera rays are ``reset``'s."""
        if isinstance(sample_start, torch.Tensor):
            self.start.copy_(sample_start)
        else:
            self.start.fill_(int(sample_start))
        if self.pix is not None:
            self.pix.copy_(pix_ids)
        self.accum.zero_()
        self.segments.zero_()
        self.next_q.fill_(self.lanes)

    def reset(self, cs, sample_start, pix_ids):
        """A new batch: ``begin``, then the wide pool on the first queue
        positions (S2's camera part, ``ops.step.step_regen``; its plain
        version is ``reset_plain``)."""
        self.begin(sample_start, pix_ids)
        step_ops.step_regen(cs, self, self.pools[0])

    def reset_plain(self, cs, pool):
        """The camera part of ``reset`` in torch (S2's plain version in its
        reset mode): every lane on its own queue position, fold identity."""
        qpos = torch.arange(pool.qpos.shape[0], dtype=torch.int64,
                            device=self.start.device)
        pixel, samp, o, d = self.camera(cs, qpos)
        A, B, dead, outer = pool.fold
        for dst, src in zip((pool.qpos, pool.pixel, pool.sample, *pool.o,
                             *pool.d), (qpos, pixel, samp, *o, *d)):
            dst.copy_(src)
        for x, v in ((pool.bounce, 0), (pool.acc_len, 0.0), *((a, 1.0)
                     for a in A), *((b, INF) for b in B),
                     *((x, False) for x in dead), (outer, False)):
            x.fill_(v)

    def step(self, cs, pool):
        """One iteration of ``pool``: the scene-hit kernels, S1
        (``ops.step.step_shade``) into the pool in place, and S2
        (``ops.step.step_regen``): the finished paths' colors stored in
        their rows, and terminal lanes claiming the next queue positions in
        order (S2 scans the terminal flags itself) with new camera rays. On
        CPU tensors the wrappers run their plain versions; ``step_plain``
        is the whole step's."""
        t, kind, idx = step_hit(cs, pool.o, pool.d, pool.pixel, pool.sample,
                                pool.bounce, self.seed)
        step_ops.step_shade(cs, t, kind, idx, pool.o, pool.d, pool.bounce,
                            pool.acc_len, pool.fold, pool.pixel, pool.sample,
                            self.seed, (pool.qpos, self.total_q),
                            self.max_depth, out=pool.shade_out())
        step_ops.step_regen(cs, self, pool, pool.terminal)

    def step_plain(self, cs, pool):
        """``step`` in torch: ``path_step_plain`` on every lane (with the
        scene-hit kernels), its lane state written back, then
        ``regen_plain``."""
        qpos = pool.qpos
        pixel, sample = self.assignment(torch.clamp(qpos,
                                                    max=self.total_q - 1))
        st = path_step_plain(cs, pool.o, pool.d, pool.bounce, pool.acc_len,
                             pool.fold, pixel, sample, self.seed,
                             qpos < self.total_q, self.max_depth)
        for dst, src in zip(pool.lanes(), step_ops.lane_arrays(st)):
            dst.copy_(src)
        self.regen_plain(cs, pool, st["color"], st["terminal"])

    def regen_plain(self, cs, pool, color, terminal):
        """The step after the shading, in torch (S2's plain version): the
        pool holds the shaded lane state; the finished paths' colors
        (``color`` (R, 3) where ``terminal``) go to their rows, terminal
        lanes claim the next queue positions in order (rank by an exclusive
        cumsum) and start there with new camera rays, and the segment and
        queue counters advance."""
        total_q = self.total_q
        qpos = pool.qpos
        pixel, _ = self.assignment(torch.clamp(qpos, max=total_q - 1))
        active = qpos < total_q
        row = self.row_of(qpos, pixel)
        self.accum.index_put_((torch.where(terminal, row, total_q),), color)
        term_i = terminal.to(torch.int64)
        rank = torch.cumsum(term_i, 0) - term_i
        new_qpos = torch.where(terminal, self.next_q + rank, qpos)
        new_pixel, new_sample, o_new, d_new = self.camera(cs, new_qpos)
        self.segments.add_(active.sum())
        new = [new_qpos, new_pixel, new_sample,
               *where3(terminal, o_new, pool.o),
               *where3(terminal, d_new, pool.d),
               torch.where(terminal, 0, pool.bounce),
               torch.where(terminal, 0.0, pool.acc_len)]
        self.next_q.add_(term_i.sum())
        for dst, src in zip((pool.qpos, pool.pixel, pool.sample, *pool.o,
                             *pool.d, pool.bounce, pool.acc_len), new):
            dst.copy_(src)

    def stop_test(self, pool):
        """Into ``go``: whether ``pool`` must go on. The wide pool of a run
        with a tail pool, while the queue is not fully claimed or more
        lanes than the tail pool holds are live; else while a lane is
        live."""
        live = pool.qpos < self.total_q
        if pool is self.pools[0] and len(self.pools) > 1:
            go = (self.next_q < self.total_q) | (live.sum() > self.tail_lanes)
        else:
            go = live.any()
        self.go.copy_(go)

    def compact(self):
        """The wide pool's live lanes, in a stable alive-first order, into
        the tail pool."""
        wide, tail = self.pools
        active = wide.qpos < self.total_q
        perm = torch.argsort(torch.where(active, 0, 1), stable=True)[
            :self.tail_lanes]
        for dst, src in zip(tail.tensors(), wide.tensors()):
            torch.index_select(src, 0, perm, out=dst)

    def result(self):
        """The color summed over the samples in sample order (deterministic)
        and the segments, both new tensors."""
        per_sample = self.accum[:self.total_q].view(self.n_samples,
                                                    self.n_pix, 3)
        color = per_sample[0].clone()
        for s in range(1, self.n_samples):
            color = color + per_sample[s]
        if self.n_rows > self.n_pix:
            color = torch.cat([color,
                               color.new_zeros((self.n_rows - self.n_pix, 3))])
        return color, self.segments.clone()


def _empty_result(n_rows, dev):
    """The result of an empty queue: zero rows, zero segments."""
    return (torch.zeros((n_rows, 3), dtype=torch.float32, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev))


def _drain(wf, advance, steps, stats, replays):
    """Run each pool of ``wf`` until its stop test fails, the live lanes
    compacted into the tail pool between the two: ``advance(k)`` runs
    ``steps`` steps of pool k and its stop test, and ``go`` is read once
    after each (the one host read). Fills ``stats``."""
    iters = []
    for k in range(len(wf.pools)):
        if k:
            wf.compact()
        n = 0
        while True:
            advance(k)
            n += 1
            if not bool(wf.go):
                break
        iters.append(n)
    if stats is not None:
        stats.update(iters=sum(iters) * steps,
                     iters_wide=iters[0] * steps if len(iters) > 1 else 0,
                     iters_tail=iters[-1] * steps, lanes=wf.lanes,
                     tail_lanes=wf.tail_lanes, host_reads=sum(iters),
                     replays=sum(iters) if replays else 0)


def warm_up(dev, fn):
    """``fn()`` on a side stream, the current stream waiting for it: the
    step a capture runs first, so that the kernels' build, the scene's
    packed tables and every lazy state exist before capture."""
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)


def capture_counted(fn, pool=None):
    """``fn()`` captured as a CUDA graph, in ``pool`` (a private pool if
    None) -> (graph, the launches each counted wrapper made in it). The
    wrappers count their launches once, at capture, where nothing runs:
    their counts are restored here, and ``replay_counted`` adds them on
    every replay. A failed capture raises."""
    wrappers = _counted_wrappers()
    before = [w.launches for w in wrappers]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        fn()
    counts = [w.launches - b for w, b in zip(wrappers, before)]
    for w, b in zip(wrappers, before):
        w.launches = b
    return graph, counts


def replay_counted(graph, counts):
    """One replay of a ``capture_counted`` graph, its launches counted."""
    graph.replay()
    for w, c in zip(_counted_wrappers(), counts):
        w.launches += c


class _WavefrontGraphs:
    """The card driver's capture of one ``_Wavefront``: per pool one CUDA
    graph of ``GRAPH_STEPS`` steps and the stop test, and the launches each
    kernel wrapper makes in one replay. Built once per compiled scene and
    key (``per_scene``): a warm-up on a side stream first (``warm_up``),
    then the captures, sharing one memory pool. The graphs hold the
    scene's tables by address: they are dropped with the scene."""

    def __init__(self, cs, wf, sample_start, pix_ids):
        self.wf, self.steps = wf, GRAPH_STEPS

        def warm():
            wf.reset(cs, sample_start, pix_ids)
            for k, pool in enumerate(wf.pools):
                if k:
                    wf.compact()
                wf.step(cs, pool)
                wf.stop_test(pool)

        def steps(pool):
            for _ in range(self.steps):
                wf.step(cs, pool)
            wf.stop_test(pool)

        warm_up(cs.device, warm)
        mempool = torch.cuda.graph_pool_handle()
        self.graphs = [capture_counted(lambda p=pool: steps(p), mempool)
                       for pool in wf.pools]

    def advance(self, k):
        replay_counted(*self.graphs[k])


class _SamplePass:
    """``sample_pass``'s card driver for one key: one CUDA graph of CR,
    with ``need_aux`` the aux planes (``first_hit_aux``: the hit kernels
    and FH), and the fixed trip's ``max_depth + 1`` bounces. The pixel ids
    and the sample (a 0-dim tensor, which the kernels read with stride 0)
    are fixed tensors written before each pass; the color and the aux
    planes are the graph's outputs, which stay allocated in its pool.
    Built once per compiled scene and key (``per_scene``): a warm-up of the
    pass on a side stream (``warm_up``), then the capture
    (``capture_counted``). The graph reads the scene's tables by address:
    it is dropped with the scene. ``replays`` counts its replays."""

    def __init__(self, cs, r, width, height, max_depth, seed, need_aux):
        dev = cs.device
        self.pix = torch.zeros((r,), dtype=torch.int64, device=dev)
        self.sample = torch.zeros((), dtype=torch.int64, device=dev)
        self.replays = 0

        def body():
            _, o, d = camera_rays(cs, self.pix, width, height, self.sample,
                                  seed)
            lanes = _lanes(self.sample, self.pix)
            carry = _bounces(cs, _trace_carry(o, d, self.pix), self.pix,
                             lanes, seed, max_depth, max_depth + 1)
            self.planes = (carry[6], *_aux_planes(
                cs, o, d, self.pix, self.sample, seed, carry[6], need_aux))

        warm_up(dev, body)
        self.graph = capture_counted(body)

    def run(self, pix, sample):
        """One pass: the ids and the sample written in, one replay. Returns
        new (color, albedo, normal)."""
        _sample_into(self.sample, sample, "sample_pass")
        self.pix.copy_(pix)
        replay_counted(*self.graph)
        self.replays += 1
        return tuple(x.clone() for x in self.planes)


def _sample_into(dst, sample, name):
    """Write ``sample`` (an int or a one-element tensor) into a driver's
    0-dim sample tensor."""
    if isinstance(sample, torch.Tensor):
        if sample.numel() != 1:
            raise ValueError(f"{name}: the sample must be an int or a "
                             f"one-element tensor")
        dst.copy_(sample.reshape(()))
    else:
        dst.fill_(int(sample))


class _FirstHitPass:
    """``first_hit_pass``'s card driver for one key: one CUDA graph of the
    eager driver's loop (``first_hit_pass_eager``) with its ``n_samples``
    passes unrolled, each pass's sample a device add onto a fixed 0-dim
    tensor, so that a batch is one replay. The pixel ids (the whole
    image's until a pass writes others) and the first sample are fixed
    tensors written before each replay; the summed planes are the graph's
    outputs, which stay allocated in its pool. Built once per compiled
    scene and key (``per_scene``): a warm-up of the loop on a side stream
    (``warm_up``), then the capture (``capture_counted``). The graph reads
    the scene's tables by address: it is dropped with the scene.
    ``replays`` counts its replays."""

    def __init__(self, cs, r, width, height, seed, shader_kind, aux,
                 n_samples):
        dev = cs.device
        self.width, self.height = width, height
        self.pix = torch.arange(r, dtype=torch.int64, device=dev)
        # whether ``pix`` holds the whole image's ids (``run(None, ...)``)
        self.whole = r == width * height
        self.sample = torch.zeros((), dtype=torch.int64, device=dev)
        self.replays = 0

        def body():
            self.planes = first_hit_pass_eager(
                cs, self.pix, self.sample, seed, width=width, height=height,
                shader_kind=shader_kind, aux=aux, n_samples=n_samples)

        warm_up(dev, body)
        self.graph = capture_counted(body)

    def run(self, pix, sample_start):
        """One batch: the ids (None: the whole image's) and the first
        sample written in, one replay. Returns new (color, albedo,
        normal)."""
        _sample_into(self.sample, sample_start, "first_hit_pass")
        if pix is not None:
            self.pix.copy_(pix)
            self.whole = False
        elif not self.whole:
            if self.pix.shape[0] != self.width * self.height:
                raise ValueError("first_hit_pass: no pixel ids given, and "
                                 "the lanes are not the image's pixels")
            torch.arange(self.pix.shape[0], out=self.pix)
            self.whole = True
        replay_counted(*self.graph)
        self.replays += 1
        return tuple(x.clone() for x in self.planes)


def trace_queued_eager(cs: CompiledScene, sample_start, n_samples, seed, *,
                       width, height, max_depth, lanes=None, stats=None,
                       pix_ids=None, n_valid=None, steps=1):
    """``trace_queued``'s eager driver, the CPU path and the card driver's
    plain version (``_Wavefront.step_plain``, no step kernel): each pool's
    steps dispatched op by op from Python, the
    stop test read every ``steps`` steps (1: after each; the card driver's
    ``GRAPH_STEPS`` gives its exact schedule). Same arguments and result
    as ``trace_queued``."""
    wf = _Wavefront(cs.device, width, height, max_depth, n_samples, seed,
                    lanes, pix_ids, n_valid)
    if wf.total_q == 0:
        return _empty_result(wf.n_rows, cs.device)
    wf.begin(sample_start, pix_ids)
    wf.reset_plain(cs, wf.pools[0])

    def advance(k):
        for _ in range(steps):
            wf.step_plain(cs, wf.pools[k])
        wf.stop_test(wf.pools[k])

    _drain(wf, advance, steps, stats, replays=False)
    return wf.result()


def trace_queued(cs: CompiledScene, sample_start, n_samples, seed, *, width,
                 height, max_depth, lanes=None, stats=None, pix_ids=None,
                 n_valid=None):
    """Work-queue wavefront: a pool of ``lanes`` lanes drains the (pixel,
    sample) queue. Terminating lanes claim the next queue positions in
    order (rank by an exclusive cumsum) and start the next camera ray; once
    the queue is spent, lanes park with a zero direction, which every hit
    kernel rejects. When the live count falls to lanes/8 after the queue is
    fully claimed, the survivors are compacted (stable order) into a pool
    an eighth the width.

    ``pix_ids`` (Np,) int64: the pixel ids this call owns (a shard), in
    queue order; None is the full image in tile-swizzled order. Only the
    first ``n_valid`` (an int; all if None) are real work: sharded callers
    pad their last shard with repeated ids and leave them out here, so
    segment counts stay exact.

    Accumulation is deterministic: each (pixel, sample) queue entry ends
    exactly once, so its color is stored (not added) in a per-sample
    buffer, and the samples are summed in order at the end — no float
    atomics.

    The driver follows the scene's device. On the CPU, the eager driver
    (``trace_queued_eager``). On the card, the JAX package's one device
    program per batch: each pool runs as replays of one CUDA graph of
    ``GRAPH_STEPS`` steps and the stop test, read once a replay, with no
    host work between its steps. The graphs are captured once per compiled
    scene and (width, height, max_depth, n_samples, lanes, seed, shard
    shape and n_valid), ``seed`` taken as an int; ``sample_start`` (an int
    or a 0-dim tensor) is written into the capture's own tensor each batch.
    A pool may run up to ``GRAPH_STEPS - 1`` steps past its stop test: a
    step on parked lanes changes nothing, so the image and the segments
    equal the eager driver's bit for bit. A failed capture raises.

    Returns (accum summed over n_samples, segments traced as a 0-dim int64
    tensor): accum is (width*height, 3) in pixel-id order, or (Np, 3) in
    ``pix_ids`` order with zero rows for the padding. ``stats`` (optional
    dict) receives the steps run (``iters``, ``iters_wide``,
    ``iters_tail``), the pools' widths, the stop-test reads
    (``host_reads``) and the graph replays (``replays``; 0 on the CPU)."""
    kw = dict(width=width, height=height, max_depth=max_depth, lanes=lanes,
              stats=stats, pix_ids=pix_ids, n_valid=n_valid)
    if cs.device.type != "cuda":
        return trace_queued_eager(cs, sample_start, n_samples, seed, **kw)
    seed = int(seed)
    n_rows, n_pix, total_q, lanes = _queue_sizes(width, height, n_samples,
                                                 lanes, pix_ids, n_valid)
    if total_q == 0:
        return _empty_result(n_rows, cs.device)
    key = ("wavefront", width, height, max_depth, n_samples, lanes, seed,
           None if pix_ids is None else tuple(pix_ids.shape), n_pix,
           GRAPH_STEPS)
    with torch.no_grad():
        graphs = per_scene(cs, key, lambda: _WavefrontGraphs(
            cs, _Wavefront(cs.device, width, height, max_depth, n_samples,
                           seed, lanes, pix_ids, n_valid),
            sample_start, pix_ids))
        graphs.wf.reset(cs, sample_start, pix_ids)
        _drain(graphs.wf, graphs.advance, graphs.steps, stats, replays=True)
        return graphs.wf.result()


def render_sample_batch(cs: CompiledScene, sample_start, seed, *, width,
                        height, max_depth, shader_kind, need_aux, n_samples,
                        stats=None):
    """Accumulate n_samples consecutive sample passes: in one launch of the
    render megakernel (K5) when ``megakernel_supported`` accepts the scene,
    else the path shader with the work-queue wavefront (``trace_queued``)
    and a debug shader with ``first_hit_pass``, its color (and with
    ``need_aux`` its aux planes) from one scene hit and one FH launch a
    sample. With ``need_aux`` the path shader's albedo and normal planes
    are a ``first_hit_pass`` of their own, beside the color of K5 or of
    the wavefront. On the card each of these
    is one device program a batch: the wavefront's graph replays, one
    replay of the first-hit pass's graph. Returns summed (pixel, albedo,
    normal) (height, width, 3) planes in image-row order (top row first,
    renderer/mod.rs:261) plus the traced-segment count (a debug shader
    counts one per pixel and sample). ``stats`` receives the wavefront's
    iteration counts (it stays empty on the other routes)."""
    n_pix = width * height
    fh = dict(width=width, height=height, n_samples=n_samples)
    if megakernel.megakernel_supported(cs, need_aux=need_aux,
                                       shader_kind=shader_kind):
        color, segments = megakernel.render_batch_megakernel(
            cs, sample_start, n_samples, seed, width=width, height=height,
            max_depth=max_depth)
    elif shader_kind == SHADER_PATH:
        color, segments = trace_queued(cs, sample_start, n_samples, seed,
                                       width=width, height=height,
                                       max_depth=max_depth, stats=stats)
    else:
        color, albedo, normal = first_hit_pass(
            cs, None, sample_start, seed, shader_kind=shader_kind,
            aux=need_aux, **fh)
        segments = torch.tensor(n_pix * n_samples, dtype=torch.int64,
                                device=cs.device)
    if shader_kind == SHADER_PATH:
        if need_aux:
            _, albedo, normal = first_hit_pass(cs, None, sample_start, seed,
                                               shader_kind=None, aux=True,
                                               **fh)
        else:
            albedo = normal = torch.zeros_like(color)
    return (to_image(color, width, height), to_image(albedo, width, height),
            to_image(normal, width, height), segments)
