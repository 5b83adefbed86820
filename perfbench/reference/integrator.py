"""The plain path tracer: one bounce of a wavefront of lanes, each lane a
(pixel, sample) path, in plain PyTorch.

A frozen copy of the plain versions of ``solstrale_tpu_torch``'s
``renderer/integrator.py`` (the materials' scatter, the forward
clamp-fold, the camera rays and the bounce after the scene hit, which the
port's CPU tests hold to the JAX package), with the scene hit always the
brute-force sweep over every prim (``ops.sweep.scene_hit_plain``) and the
draws always the plain counter hash. ``trace_paths`` runs whole paths of
any set of lanes: the draws are a pure function of (pixel, sample,
bounce, purpose, seed), so a subset of pixels traces the same paths as the
whole image does.

The reference's nested ``clamp(<=3) + NaN->0`` ScatterPdf semantics
(shader.rs:95-125) are folded forward with O(1) per-lane state using
``min(a*L, 3) = a*min(L, 3/a)`` for a >= 0. Vectors and colours are
component tuples of (R,) tensors (``geo/soa.py``).
"""
from __future__ import annotations

import math

import torch

from .geo import INF
from .geo import soa
from .geo.soa import (dot3, onb_from_w3, onb_local3, reflect3, refract3,
                      unit3, vneg, vscale, where3)
from .ops import rng, sweep
from .ops.intersect import (hit_attributes_soa, light_pdf_mean3,
                            sample_light_direction3, table_rows)
from .scene.compile import (BLEND, DIELECTRIC, DIFFUSE_LIGHT, ISOTROPIC,
                            KIND_MEDIUM, LAMBERTIAN, METAL, CompiledScene)

MAX_BLEND_DEPTH = 3


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


def shade_plain(cs: CompiledScene, o, d, t, kind, idx, bounce, acc_len, fold,
                pixel, sample, seed, active, max_depth, color=None,
                mapped=False):
    """Everything a bounce does after the scene hit: the attributes, the
    material's scatter, the terminal colour through the clamp-fold and the
    fold of this bounce's scatter level. Returns a dict: ``terminal``
    (``miss | capped | emit``), ``miss``, ``capped``, ``emit``, ``scat``,
    ``is_pdf``, ``color`` (R, 3), the state a lane that goes on carries
    (``o``, ``d``, ``bounce``, ``acc_len``, ``fold``); with ``color``, the
    carried (R, 3) colour, the carry form (an ended path's colour written
    in, ``d`` parked on a lane that does not go on, and ``alive``); with
    ``mapped`` the lanes that scatter off a normal map."""
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



def media_tables(cs: CompiledScene):
    """Every medium's boundary packed, with its padded box
    (``ops.sweep.MediaTables``)."""
    return sweep.pack_media(cs.media, cs.device, box_scale(cs))


def scene_hit(cs: CompiledScene, media, o, d, pix, sample, bounce, seed):
    """world.hit by brute force: the closest solid hit over every sphere
    and planar row (the first slot wins a tie), then every constant medium
    in order. Returns (t, kind, idx), kind = KIND_MEDIUM for volume
    scattering."""
    return sweep.scene_hit_plain(cs.solids, media, o, d, pix, sample, bounce,
                                 seed)


def quantized(cs: CompiledScene, dtype):
    """``cs`` with every float table rounded to ``dtype`` and back to f32:
    the tables as a program that stores them in ``dtype`` reads them."""
    import dataclasses

    def walk(x):
        if isinstance(x, torch.Tensor):
            return (x.to(dtype).to(x.dtype) if x.is_floating_point() else x)
        if isinstance(x, tuple):
            return tuple(walk(v) for v in x)
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: walk(getattr(x, f.name))
                              for f in dataclasses.fields(x)})
        return x

    return walk(cs)


def trace_paths(cs: CompiledScene, pixel, sample, seed, *, width, height,
                max_depth, media=None, quantize=None, observe=None):
    """Linear colour (R, 3) of the paths of the lanes (``pixel``,
    ``sample``: (R,) int64 tensors): the jittered camera ray, then one
    bounce after another until no lane is alive, at most ``max_depth + 1``
    (the last one the depth cap: a ray still alive that hits shades to
    black, a miss takes the background). Each bounce runs on the lanes
    still alive only; a lane's colour is written when its path ends.

    ``quantize`` (a dtype) rounds the lane state (origin, direction, path
    length, fold and colour) to that dtype after every bounce: with
    ``quantized`` tables, the program that keeps its state in ``dtype``.
    ``observe(o, d, st, lanes, b)``, if given, sees every bounce ``b``:
    the rays it traced, its result dict (``shade_plain``'s, with
    ``mapped``) and the lanes' indices. Autograd runs through it: the colour is differentiable
    in the texture arena (``cs.textures.pixels``)."""
    if media is None:
        media = media_tables(cs)
    r = pixel.shape[0]
    dev = pixel.device
    o, d = camera_rays_plain(cs, pixel, sample, seed, width, height)
    zero = torch.zeros((r,), dtype=torch.float32, device=dev)
    bounce = torch.zeros((r,), dtype=torch.int32, device=dev)
    acc_len = zero
    fold = fold_init(zero)
    color = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    lanes = torch.arange(r, device=dev)

    def q(x):
        return x if quantize is None else x.to(quantize).to(x.dtype)

    for b in range(max_depth + 1):
        if lanes.numel() == 0:
            break
        pix, smp = pixel[lanes], sample[lanes]
        lo = tuple(c[lanes] for c in o)
        ld = tuple(c[lanes] for c in d)
        lb = bounce[lanes]
        t, kind, idx = scene_hit(cs, media, lo, ld, pix, smp, lb, seed)
        active = torch.ones_like(pix, dtype=torch.bool)
        st = shade_plain(cs, lo, ld, t, kind, idx, lb, acc_len[lanes],
                         tuple(tuple(x[lanes] for x in f) if isinstance(
                             f, tuple) else f[lanes] for f in fold),
                         pix, smp, seed, active, max_depth,
                         mapped=observe is not None)
        if observe is not None:
            observe(lo, ld, st, lanes, b)
        color = color.index_copy(0, lanes, torch.where(
            st["terminal"][:, None], q(st["color"]), color[lanes]))
        go = torch.nonzero(st["scat"]).squeeze(1)
        keep = lanes[go]
        o = tuple(c.index_copy(0, keep, q(n[go])) for c, n in zip(o, st["o"]))
        d = tuple(c.index_copy(0, keep, q(n[go])) for c, n in zip(d, st["d"]))
        bounce = bounce.index_copy(0, keep, st["bounce"][go])
        acc_len = acc_len.index_copy(0, keep, q(st["acc_len"][go]))
        fold = tuple(
            tuple(c.index_copy(0, keep, q(n[go]) if n.is_floating_point()
                               else n[go]) for c, n in zip(f, nf))
            if isinstance(f, tuple) else f.index_copy(0, keep, nf[go])
            for f, nf in zip(fold, st["fold"]))
        lanes = keep
    return color
