"""Ray-scene intersection on tensors: hit attributes and the NEE
light-table ops (the scene hit itself is ``ops/bvh.py`` and
``ops/sweep.py``: K1-K3 on BVH scenes, the fused K4 otherwise).

Mirrors the JAX package's ``ops/intersect.py``. Its one-hot matmul lookups
(an MXU workaround) become direct indexing here, with the one-hot
semantics kept: an out-of-range index yields a zero row
(``table_rows``). Interval semantics (inclusive contains, t-min epsilon)
follow ``util/interval.rs:25-96``.
"""
from __future__ import annotations

import math

import torch

from ..geo import ALMOST_ZERO, INF, RAY_T_MIN, soa
from ..scene.compile import (KIND_QUAD, KIND_SPHERE, KIND_TRIANGLE,
                             Lights, Solids)

# light_pdf_mean3 unrolls its light loop up to this many lights; above it
# the batched (R, L) form (light_pdf_values) takes over, as in the JAX
# package
_MEAN3_UNROLL_MAX = 16


def _contains(t, tmin, tmax):
    return (t >= tmin) & (t <= tmax)


def table_rows(table, idx):
    """Rows of ``table`` at ``idx`` as a tuple of (R,) f32 columns; an
    out-of-range index yields a zero row (the JAX one-hot lookup's
    semantics, intersect.py:236-239)."""
    n = table.shape[0]
    in_range = (idx >= 0) & (idx < n)
    rows = table[torch.clamp(idx, 0, n - 1).long()].to(torch.float32)
    rows = torch.where(in_range[:, None], rows, 0.0)
    return tuple(rows.unbind(dim=1))


def hit_attributes_soa(s: Solids, o, d, t, kind, idx, has_spheres=True):
    """Full hit attributes for the winning (kind, idx, t), SoA in and out:
    point, face-forward normal, tangent frame, uv, front_face, material
    (sphere.rs:84-107 / quad.rs:164-193 / triangle.rs:142-172).
    has_spheres=False skips the sphere branch (a scene-static choice)."""
    point = (o[0] + d[0] * t, o[1] + d[1] * t, o[2] + d[2] * t)
    n_q = s.qd_q.shape[0]
    n_pl = s.pl_attr.shape[0]

    is_s = (kind == KIND_SPHERE)
    planar_slot = torch.where(kind == KIND_TRIANGLE, n_q + idx, idx)
    planar_slot = torch.clamp(planar_slot, 0, n_pl - 1)
    ap = table_rows(s.pl_attr, planar_slot)    # 25 columns

    # --- planar derived (quad.rs:164-193 / triangle.rs:142-172) ---
    n = (ap[0], ap[1], ap[2])
    bu = soa.dot3(point, (ap[3], ap[4], ap[5])) + ap[6]
    bv = soa.dot3(point, (ap[7], ap[8], ap[9])) + ap[10]
    tangent_p = (ap[11], ap[12], ap[13])
    bitangent_p = (ap[14], ap[15], ap[16])
    uv_p = (ap[17] + bu * ap[19] + bv * ap[21],
            ap[18] + bu * ap[20] + bv * ap[22])
    mat_p = ap[23]
    front_p = soa.dot3(d, n) < 0.0
    normal_p = soa.where3(front_p, n, soa.vneg(n))

    if not has_spheres:
        return dict(point=point, normal=normal_p, tangent=tangent_p,
                    bitangent=bitangent_p, uv=uv_p, front_face=front_p,
                    mat=mat_p.to(torch.int32))

    n_sph = s.sph_attr.shape[0]
    asp = table_rows(s.sph_attr, torch.clamp(idx, 0, n_sph - 1))

    # --- sphere derived (sphere.rs:84-107) ---
    c = (asp[0], asp[1], asp[2])
    n_raw = soa.vsub(point, c)
    n_unit = soa.unit3(n_raw)
    front_s = soa.dot3(d, n_unit) < 0.0
    normal_s = soa.where3(front_s, n_unit, soa.vneg(n_unit))
    theta = torch.arccos(torch.clamp(-n_unit[1], -1.0, 1.0))
    phi = -torch.atan2(n_unit[2], n_unit[0]) + math.pi
    uv_s = (phi / (2.0 * math.pi), theta / math.pi)
    # cross(unit_y, n_raw) with unit_y=(0,1,0) = (n_raw.z, 0, -n_raw.x)
    tangent_s = soa.unit3((n_raw[2], torch.zeros_like(n_raw[2]), -n_raw[0]))
    bitangent_s = soa.cross3(n_raw, tangent_s)  # unnormalized (sphere.rs:89-90)
    mat_s = asp[4]

    return dict(
        point=point,
        normal=soa.where3(is_s, normal_s, normal_p),
        tangent=soa.where3(is_s, tangent_s, tangent_p),
        bitangent=soa.where3(is_s, bitangent_s, bitangent_p),
        uv=(torch.where(is_s, uv_s[0], uv_p[0]),
            torch.where(is_s, uv_s[1], uv_p[1])),
        front_face=torch.where(is_s, front_s, front_p),
        mat=torch.where(is_s, mat_s, mat_p).to(torch.int32),
    )


# --- NEE light table ops (pdf.rs:88-102 semantics) ------------------------

def _row(x, i):
    """Light i's vector as a tuple of 0-dim tensors (views, no copy)."""
    return (x[i, 0], x[i, 1], x[i, 2])


def _sphere_light_pdf(lights, i, o, d, dd, tmin, tmax):
    p0 = _row(lights.p0, i)
    oc = soa.vsub(o, p0)
    half_b = soa.dot3(oc, d)
    radius = lights.radius[i]
    dist_sq = soa.dot3(oc, oc)
    c2 = dist_sq - radius * radius
    disc = half_b * half_b - dd * c2
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    r1 = (-half_b - sq) / dd
    r2 = (-half_b + sq) / dd
    sph_hit = (disc >= 0.0) & (_contains(r1, tmin, tmax)
                               | _contains(r2, tmin, tmax))
    cos_theta_max = torch.sqrt(1.0 - radius * radius / dist_sq)
    solid_angle = 2.0 * math.pi * (1.0 - cos_theta_max)
    return torch.where(sph_hit, 1.0 / solid_angle, 0.0)


def _quad_light_t(lights, i, o, d, tmin, tmax):
    p0 = _row(lights.p0, i)
    nrm = _row(lights.normal, i)
    denom = soa.dot3(d, nrm)
    t_pl = (lights.d[i] - soa.dot3(o, nrm)) / denom
    hp = (o[0] + d[0] * t_pl, o[1] + d[1] * t_pl, o[2] + d[2] * t_pl)
    pv = soa.vsub(hp, p0)
    w = _row(lights.w, i)
    pu = soa.dot3(w, soa.cross3(pv, _row(lights.p2, i)))
    pvv = soa.dot3(w, soa.cross3(_row(lights.p1, i), pv))
    ok = ((torch.abs(denom) >= ALMOST_ZERO)
          & (pu >= 0.0) & (pu <= 1.0) & (pvv >= 0.0) & (pvv <= 1.0)
          & _contains(t_pl, tmin, tmax))
    return t_pl, ok, denom


def _tri_light_t(lights, i, o, d, tmin, tmax):
    """Moller-Trumbore on (v0, e1, e2)."""
    u_e, v_e = _row(lights.p1, i), _row(lights.p2, i)
    pvec = soa.cross3(d, v_e)
    det = soa.dot3(u_e, pvec)
    inv_det = 1.0 / det
    tvec = soa.vsub(o, _row(lights.p0, i))
    qvec = soa.cross3(tvec, u_e)
    bu = soa.dot3(tvec, pvec) * inv_det
    bv = soa.dot3(d, qvec) * inv_det
    t_pl = soa.dot3(v_e, qvec) * inv_det
    denom = soa.dot3(d, _row(lights.normal, i))
    ok = ((torch.abs(det) >= ALMOST_ZERO)
          & (bu >= 0.0) & (bu <= 1.0) & (bv >= 0.0) & (bu + bv <= 1.0)
          & _contains(t_pl, tmin, tmax))
    return t_pl, ok, denom


def light_pdf_mean3(lights: Lights, o, d, kinds):
    """Mean over lights of the per-light sampling pdf, SoA o and d -> (R,).
    Unrolled over the light list with each light's static kind (``kinds``,
    the compiled scene's ``light_kinds``): sphere -> 1/solid-angle gated on
    a self re-intersection (sphere.rs:40-56), quad/tri -> dist^2/(cos*area)
    (quad.rs:132-143). NaNs propagate as in the reference and are filtered
    later by the clamp-fold. Above _MEAN3_UNROLL_MAX lights the batched
    (R, L) form takes over. Either way the pdfs are summed in light order
    and the sum divided by the count, as the step kernels sum them
    (``csrc/shade.cuh``; a ``torch.mean`` would sum in the device's
    order)."""
    tmin, tmax = RAY_T_MIN, INF
    n_l = len(kinds)
    acc = torch.zeros_like(o[0])
    if n_l > _MEAN3_UNROLL_MAX:
        values = light_pdf_values(lights, o, d)
        for i in range(n_l):
            acc = acc + values[:, i]
        return acc / n_l
    dd = soa.dot3(d, d)
    for i, kind in enumerate(kinds):
        if kind == KIND_SPHERE:
            acc = acc + _sphere_light_pdf(lights, i, o, d, dd, tmin, tmax)
            continue
        if kind == KIND_QUAD:
            t_pl, ok_pl, denom = _quad_light_t(lights, i, o, d, tmin, tmax)
        else:
            t_pl, ok_pl, denom = _tri_light_t(lights, i, o, d, tmin, tmax)
        cos_planar = torch.abs(denom) / torch.sqrt(dd)
        acc = acc + torch.where(
            ok_pl, t_pl * t_pl * dd / (cos_planar * lights.area[i]), 0.0)
    return acc / n_l


def light_pdf_values(lights: Lights, o, d):
    """Per-light pdf of sampling direction d from origin o: (R, L), the
    batched form of light_pdf_mean3 (intersect.py:581-623 of the JAX
    package): every light is tested with both the sphere and the planar
    forms and the light's kind selects."""
    tmin, tmax = RAY_T_MIN, INF
    col = tuple(c[:, None] for c in o)
    dcol = tuple(c[:, None] for c in d)
    p0 = tuple(lights.p0[None, :, k] for k in range(3))
    p1 = tuple(lights.p1[None, :, k] for k in range(3))
    p2 = tuple(lights.p2[None, :, k] for k in range(3))
    nrm = tuple(lights.normal[None, :, k] for k in range(3))
    w = tuple(lights.w[None, :, k] for k in range(3))
    radius = lights.radius[None, :]

    # sphere part
    oc = soa.vsub(col, p0)
    a = soa.dot3(dcol, dcol)
    half_b = soa.dot3(oc, dcol)
    dist_sq = soa.dot3(oc, oc)
    c2 = dist_sq - radius * radius
    disc = half_b * half_b - a * c2
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    r1 = (-half_b - sq) / a
    r2 = (-half_b + sq) / a
    sph_hit = (disc >= 0.0) & (_contains(r1, tmin, tmax)
                               | _contains(r2, tmin, tmax))
    cos_theta_max = torch.sqrt(1.0 - radius * radius / dist_sq)
    solid_angle = 2.0 * math.pi * (1.0 - cos_theta_max)
    pdf_sph = torch.where(sph_hit, 1.0 / solid_angle, 0.0)

    # quad part (quad.rs:150-173)
    denom = soa.dot3(dcol, nrm)
    tq = (lights.d[None, :] - soa.dot3(col, nrm)) / denom
    hp = (col[0] + dcol[0] * tq, col[1] + dcol[1] * tq,
          col[2] + dcol[2] * tq)
    pv = soa.vsub(hp, p0)
    pu = soa.dot3(w, soa.cross3(pv, p2))
    pvv = soa.dot3(w, soa.cross3(p1, pv))
    okq = ((torch.abs(denom) >= ALMOST_ZERO) & (pu >= 0.0) & (pu <= 1.0)
           & (pvv >= 0.0) & (pvv <= 1.0) & _contains(tq, tmin, tmax))
    tq = torch.where(okq, tq, INF)

    # triangle part (Moller-Trumbore, triangle.rs:119-148)
    pvec = soa.cross3(dcol, p2)
    det = soa.dot3(p1, pvec)
    inv_det = 1.0 / det
    tvec = soa.vsub(col, p0)
    qvec = soa.cross3(tvec, p1)
    bu = soa.dot3(tvec, pvec) * inv_det
    bv = soa.dot3(dcol, qvec) * inv_det
    tt = soa.dot3(p2, qvec) * inv_det
    okt = ((torch.abs(det) >= ALMOST_ZERO) & (bu >= 0.0) & (bu <= 1.0)
           & (bv >= 0.0) & (bu + bv <= 1.0) & _contains(tt, tmin, tmax))
    tt = torch.where(okt, tt, INF)

    kind = lights.kind[None, :]
    cos_planar = torch.abs(denom) / torch.sqrt(a)
    t_planar = torch.where(kind == KIND_QUAD, tq, tt)
    pdf_planar = torch.where(
        torch.isfinite(t_planar),
        t_planar * t_planar * a / (cos_planar * lights.area[None, :]), 0.0)
    return torch.where(kind == KIND_SPHERE, pdf_sph, pdf_planar)


def sample_light_direction3(lights: Lights, o, pick, r1, r2, kinds):
    """Direction towards a point sampled on the light picked per ray
    (pdf.rs:98-101): sphere -> cone sample (sphere.rs:58-62), quad/tri ->
    uniform parallelogram point minus origin (quad.rs:145-148). Only the
    samplers of the kinds present in ``kinds`` run."""
    from . import rng

    any_sphere = any(k == KIND_SPHERE for k in kinds)
    any_planar = any(k != KIND_SPHERE for k in kinds)

    la = table_rows(lights.attr, pick)   # kind p0 p1 p2 radius
    kind = la[0].to(torch.int32)
    p0 = (la[1], la[2], la[3])
    p1 = (la[4], la[5], la[6])
    p2 = (la[7], la[8], la[9])
    radius = la[10]

    dir_sphere = dir_planar = None
    if any_sphere:
        to_c = soa.vsub(p0, o)
        dist_sq = soa.dot3(to_c, to_c)
        tan, bit, nrm = soa.onb_from_w3(to_c)
        local = rng.to_sphere3(radius, dist_sq, r1, r2)
        dir_sphere = soa.onb_local3(tan, bit, nrm, local)
    if any_planar:
        dir_planar = soa.vsub(soa.vadd(p0, soa.vadd(soa.vscale(p1, r1),
                                                    soa.vscale(p2, r2))), o)
    if not any_planar:
        return dir_sphere
    if not any_sphere:
        return dir_planar
    return soa.where3(kind == KIND_SPHERE, dir_sphere, dir_planar)
