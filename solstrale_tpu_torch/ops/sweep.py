"""Brute-force sweeps: the BVH route's sphere sweep (K2), every constant
medium's scattering event on the BVH route (K3), and both fused into the
whole scene hit of a scene without a BVH (K4).

Each has a hand-written CUDA kernel (``csrc/sweep.cu``) and a plain PyTorch
version with the same formulas, op for op (the JAX package's
``ops/pallas_sweep.py`` kernels, which these replace). The wrapper picks by
the tensors' device only: CPU tensors take the plain version, CUDA tensors
launch the kernel or raise.

- ``bvh_sphere_hit``: K2, the spheres-only sweep min-combined with K1's
  planar hit and decoded to (t, kind, idx) in the same launch, as the JAX
  package's ``bvh_closest_hit_pallas`` combines them.
- ``media_hit``: K3, every medium in order on top of a solid hit (t, kind,
  idx): the flight uniforms are drawn from the lane counters, the media
  culled by their padded boxes and (t, kind, idx) updated in the kernel.
- ``scene_hit``: K4, (t, kind, idx) from the lane counters: the solid
  sweep, then the media as in K3, and the slot decoded in the kernel.

``closest_hit_plain`` (K2's sweep over both tables, (t, slot)) and
``medium_hit_plain`` (one medium's event) are the plain references these
build on.

Tables (``Solids.sph_table`` / ``Solids.pl_table``):
- spheres (S, 8): cx cy cz radius valid 0 0 0
- planar (P, 16): nx ny nz d g1.xyz g1o g2.xyz g2o is_tri valid 0 0
Rays are component tuples of (R,) f32 tensors (``geo/soa.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..geo import ALMOST_ZERO, INF, RAY_T_MIN
from ..scene.compile import (KIND_MEDIUM, KIND_QUAD, KIND_SPHERE,
                             KIND_TRIANGLE, Solids)
from . import _build, rng
from .detached import detached

# plain versions work on (ray chunk, prim chunk) blocks to bound memory
RAY_CHUNK = 8192
PRIM_CHUNK = 1024

# K4 and K5 cull a medium for a ray that cannot reach the medium's box,
# grown by this fraction of the scene's largest coordinate (at least 1),
# the scale of every ray origin and hit point. The pad exceeds the rounding
# of any boundary hit the sweeps accept: the planar test errs by a few f32
# ulps of that scale, and the sphere test's expanded form (c2 = |o|^2 -
# 2 o.c + |c|^2 - r^2) can accept a grazing line up to about sqrt(eps) of
# it outside the sphere; 2^-9 is 8 sqrt(eps) for eps = 2^-24.
MEDIUM_BOX_PAD = 2.0 ** -9


# --- plain versions ---------------------------------------------------------

def _ray_scalars(o, d):
    dd = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    od = o[0] * d[0] + o[1] * d[1] + o[2] * d[2]
    oo = o[0] * o[0] + o[1] * o[1] + o[2] * o[2]
    return dd, od, oo


def _sphere_roots(o, d, dd, od, oo, sph):
    """(R,1) ray columns x (1,S) sphere rows -> (ok, r1, r2), each (R, S);
    the expanded form of pallas_sweep.py:93-101."""
    cx, cy, cz, radius, valid = (sph[:, k][None, :] for k in range(5))
    cd = cx * d[0] + cy * d[1] + cz * d[2]
    co = cx * o[0] + cy * o[1] + cz * o[2]
    half_b = od - cd
    c2 = oo - 2.0 * co + (cx * cx + cy * cy + cz * cz) - radius * radius
    disc = half_b * half_b - dd * c2
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    r1 = (-half_b - sq) / dd
    r2 = (-half_b + sq) / dd
    return (disc >= 0.0) & (valid > 0.5), r1, r2


def _planar_t(o, d, pln):
    """(R,1) x (1,P) unified quad/triangle test (pallas_sweep.py:115-135):
    returns (ok without the t bounds, t)."""
    f = [pln[:, k][None, :] for k in range(14)]
    nx, ny, nz, dpl = f[0:4]
    denom = nx * d[0] + ny * d[1] + nz * d[2]
    t = (dpl - (nx * o[0] + ny * o[1] + nz * o[2])) / denom
    hx = o[0] + t * d[0]
    hy = o[1] + t * d[1]
    hz = o[2] + t * d[2]
    u = hx * f[4] + hy * f[5] + hz * f[6] + f[7]
    v = hx * f[8] + hy * f[9] + hz * f[10] + f[11]
    tri = f[12] > 0.5
    contain = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & torch.where(
        tri, u + v <= 1.0, v <= 1.0)
    return (torch.abs(denom) >= ALMOST_ZERO) & (f[13] > 0.5) & contain, t


def _first_min(t, best_t, best_slot, slot0):
    """Fold an (R, n) t-matrix into the running (best, slot) with a strict
    '<': the first (smallest) slot wins ties, like the TPU kernel's ordered
    loop. Rows that stay INF keep their slot."""
    ct, ci = torch.min(t, dim=1)  # first index among equal minima
    take = ct < best_t
    return (torch.where(take, ct, best_t),
            torch.where(take, ci.to(torch.int32) + slot0, best_slot))


def closest_hit_plain(sph, pln, o, d, tmin, tmax, spheres_only=False):
    """Brute-force closest hit over both tables (K2's sweep; the JAX
    package's ``closest_hit_pallas``): (t, slot) with slot < S a sphere,
    S + p planar row p, -1 a miss (t = INF). ``pln`` is not read if
    ``spheres_only``."""
    r = o[0].shape[0]
    tmin = _build.per_ray(tmin, o[0])
    tmax = _build.per_ray(tmax, o[0])
    n_sph = sph.shape[0]
    n_pl = 0 if spheres_only else pln.shape[0]
    out_t = torch.full((r,), INF, dtype=torch.float32, device=o[0].device)
    out_s = torch.full((r,), -1, dtype=torch.int32, device=o[0].device)
    for a in range(0, r, RAY_CHUNK):
        sl = slice(a, a + RAY_CHUNK)
        oc = tuple(c[sl][:, None] for c in o)
        dc = tuple(c[sl][:, None] for c in d)
        lo, hi = tmin[sl][:, None], tmax[sl][:, None]
        dd, od, oo = _ray_scalars(oc, dc)
        best_t, best_s = out_t[sl], out_s[sl]
        for p in range(0, n_sph, PRIM_CHUNK):
            ok, r1, r2 = _sphere_roots(oc, dc, dd, od, oo,
                                       sph[p:p + PRIM_CHUNK])
            t = torch.where(ok & (r1 >= lo) & (r1 <= hi), r1,
                            torch.where(ok & (r2 >= lo) & (r2 <= hi), r2,
                                        INF))
            best_t, best_s = _first_min(t, best_t, best_s, p)
        for p in range(0, n_pl, PRIM_CHUNK):
            ok, t = _planar_t(oc, dc, pln[p:p + PRIM_CHUNK])
            t = torch.where(ok & (t >= lo) & (t <= hi), t, INF)
            best_t, best_s = _first_min(t, best_t, best_s, n_sph + p)
        out_t[sl], out_s[sl] = best_t, best_s
    return out_t, out_s


def bvh_sphere_hit_plain(sph, o, d, tmin, tmax, t_p, pslot, pl_idx,
                         pl_is_tri):
    """Plain PyTorch K2 in its BVH mode: the spheres-only sweep min-combined
    with K1's planar hit (``t_p``, ``pslot``) exactly as
    ``bvh_closest_hit_pallas`` does (pallas_bvh.py:613-628): the sphere wins
    ties (and a miss of both, as kind sphere, idx 0), its idx is max(slot,
    0); a planar hit's clipped slot is decoded by ``pl_is_tri`` and
    ``pl_idx``. Returns (t, kind, idx)."""
    t_s, slot_s = closest_hit_plain(sph, None, o, d, tmin, tmax,
                                    spheres_only=True)
    pslot_c = torch.clamp(pslot, 0, pl_idx.shape[0] - 1).long()
    kind_p = torch.where(pl_is_tri[pslot_c], KIND_TRIANGLE,
                         KIND_QUAD).to(torch.int32)
    idx_p = pl_idx[pslot_c]
    sphere_wins = t_s <= t_p
    t = torch.where(sphere_wins, t_s, t_p)
    kind = torch.where(sphere_wins, KIND_SPHERE, kind_p).to(torch.int32)
    idx = torch.where(sphere_wins, torch.clamp(slot_s, min=0), idx_p)
    return t, kind, idx


def _closest_t_plain(sph, pln, o, d, dd, od, oo, lo):
    """Closest boundary t >= lo (no upper bound) — one K3 sweep."""
    best = torch.full(dd.shape[:1], INF, dtype=torch.float32,
                      device=dd.device)
    for p in range(0, sph.shape[0], PRIM_CHUNK):
        ok, r1, r2 = _sphere_roots(o, d, dd, od, oo, sph[p:p + PRIM_CHUNK])
        t = torch.where(ok & (r1 >= lo), r1,
                        torch.where(ok & (r2 >= lo), r2, INF))
        best = torch.minimum(best, t.min(dim=1).values)
    for p in range(0, pln.shape[0], PRIM_CHUNK):
        ok, t = _planar_t(o, d, pln[p:p + PRIM_CHUNK])
        t = torch.where(ok & (t >= lo), t, INF)
        best = torch.minimum(best, t.min(dim=1).values)
    return best


def medium_hit_plain(sph, pln, neg_inv_density, o, d, t_solid, u_flight):
    """One constant medium's event t per ray, INF when none
    (constant_medium.rs:35-79; the JAX package's ``medium_hit_pallas``,
    pallas_sweep.py:249-313)."""
    r = o[0].shape[0]
    out = torch.empty((r,), dtype=torch.float32, device=o[0].device)
    t_solid = torch.where(torch.isfinite(t_solid), t_solid, INF)
    for a in range(0, r, RAY_CHUNK):
        sl = slice(a, a + RAY_CHUNK)
        oc = tuple(c[sl][:, None] for c in o)
        dc = tuple(c[sl][:, None] for c in d)
        dd, od, oo = _ray_scalars(oc, dc)
        t1 = _closest_t_plain(sph, pln, oc, dc, dd, od, oo, -INF)
        t2 = _closest_t_plain(sph, pln, oc, dc, dd, od, oo,
                              (t1 + 1e-4)[:, None])
        both = (t1 < INF) & (t2 < INF)
        t1c = torch.clamp(t1, min=RAY_T_MIN)
        t2c = torch.minimum(t2, t_solid[sl])
        ordered = t1c < t2c
        t1c = torch.clamp(t1c, min=0.0)
        r_len = torch.sqrt(dd[:, 0])
        dist_inside = (t2c - t1c) * r_len
        hit_dist = neg_inv_density * torch.log(
            torch.clamp(u_flight[sl], min=1e-38))
        scatters = hit_dist <= dist_inside
        t = t1c + hit_dist / r_len
        out[sl] = torch.where(both & ordered & scatters, t, INF)
    return out


@dataclass(frozen=True)
class MediaTables:
    """Every medium's boundary tables packed into one sphere and one planar
    table (K4's and K5's layout): medium m owns rows ``sph_off[m]:
    sph_off[m+1]`` and ``pl_off[m]:pl_off[m+1]``. The offsets are kept both
    on the host (the plain versions slice with them) and as int32 tensors on
    the tables' device (the kernels read them). ``box`` holds each medium's
    padded box (``medium_boxes``), by which K4 and K5 cull the medium."""

    sph: torch.Tensor        # (sum S_m, 8) f32
    pln: torch.Tensor        # (sum P_m, 16) f32
    sph_off: tuple           # M+1 host ints
    pl_off: tuple
    sph_off_t: torch.Tensor  # (M+1,) int32
    pl_off_t: torch.Tensor
    nid: torch.Tensor        # (M,) f32 neg_inv_density
    mat: torch.Tensor        # (M,) int32 phase material
    box: torch.Tensor        # (M, 8) f32 lo xyz 0 hi xyz 0

    @property
    def n_media(self):
        return len(self.sph_off) - 1

    def boundary(self, m):
        """Medium m's (sphere, planar) table views."""
        return (self.sph[self.sph_off[m]:self.sph_off[m + 1]],
                self.pln[self.pl_off[m]:self.pl_off[m + 1]])


def extent(s: Solids):
    """(lo, hi) f64 (3,) over the valid spheres, quad corners and triangle
    vertices of a ``Solids``; lo = inf, hi = -inf when it has none."""
    c = s.sph_center[s.sph_valid].double()
    r = s.sph_radius[s.sph_valid].double()[:, None]
    q, u, v = (x[s.qd_valid].double() for x in (s.qd_q, s.qd_u, s.qd_v))
    v0, e1, e2 = (x[s.tr_valid].double() for x in (s.tr_v0, s.tr_e1,
                                                     s.tr_e2))
    corners = torch.cat([q, q + u, q + v, q + u + v, v0, v0 + e1, v0 + e2])
    inf = torch.full((1, 3), torch.inf, dtype=torch.float64, device=c.device)
    return (torch.cat([c - r, corners, inf]).amin(0),
            torch.cat([c + r, corners, -inf]).amax(0))


def medium_boxes(media, device, scale):
    """(M, 8) f32 box per medium of ``media`` (tuple of Medium) for the
    cull, lo xyz 0 hi xyz 0: the extent of the medium's boundary grown by
    MEDIUM_BOX_PAD of ``scale``, the scene's largest coordinate (the
    renderer's ``integrator.box_scale``). A medium without boundary prims
    keeps lo = inf, hi = -inf, which the slab test never culls (its sweeps
    find nothing)."""
    pad = MEDIUM_BOX_PAD * scale
    zero = torch.zeros(1, dtype=torch.float64, device=device)
    rows = [torch.cat([lo - pad, zero, hi + pad, zero])
            for lo, hi in (extent(m.boundary) for m in media)]
    return (torch.stack(rows).to(torch.float32) if rows else
            torch.zeros((0, 8), dtype=torch.float32, device=device))


def box_reach_plain(o, d, box, ts):
    """``hit::box_reach`` in f32 torch for one medium's box row ``box``
    (8,): whether each ray's line meets the box at some parameter in [0,
    ts] (torch.fmin / fmax drop NaN as fminf / fmaxf do)."""
    tn = torch.full_like(ts, -torch.inf)
    tf = torch.full_like(ts, torch.inf)
    for k in range(3):
        inv = 1.0 / d[k]
        a, b = (box[k] - o[k]) * inv, (box[4 + k] - o[k]) * inv
        tn = torch.fmax(tn, torch.fmin(a, b))
        tf = torch.fmin(tf, torch.fmax(a, b))
    return (tn <= tf) & (tf >= 0.0) & (tn <= ts)


def pack_media(media, device, scale):
    """MediaTables of ``media`` (tuple of Medium) on ``device``; ``scale``
    sizes the boxes' pad (``medium_boxes``)."""
    def offsets(tables):
        out = [0]
        for t in tables:
            out.append(out[-1] + t.shape[0])
        return tuple(out)

    sphs = [m.boundary.sph_table for m in media]
    plns = [m.boundary.pl_table for m in media]
    f32 = dict(dtype=torch.float32, device=device)
    sph_off, pl_off = offsets(sphs), offsets(plns)
    return MediaTables(
        sph=torch.cat(sphs).contiguous() if media else torch.zeros((0, 8), **f32),
        pln=torch.cat(plns).contiguous() if media else torch.zeros((0, 16), **f32),
        sph_off=sph_off, pl_off=pl_off,
        sph_off_t=torch.tensor(sph_off, dtype=torch.int32, device=device),
        pl_off_t=torch.tensor(pl_off, dtype=torch.int32, device=device),
        nid=(torch.stack([m.neg_inv_density for m in media]).to(torch.float32)
             if media else torch.zeros((0,), **f32)),
        mat=(torch.stack([m.mat for m in media]).to(torch.int32) if media
             else torch.zeros((0,), dtype=torch.int32, device=device)),
        box=medium_boxes(media, device, scale))


def media_hit_plain(media: MediaTables, o, d, t, kind, idx, pixel, sample,
                    bounce, seed):
    """Plain PyTorch K3: every medium of ``media`` in order on top of the hit
    (t, kind, idx), as the JAX package's integrator runs them
    (integrator.py:153-165): medium m's flight uniform is ``rng.uniform``
    of the lane counters (pixel, sample, bounce, seed; each an (R,) int
    tensor or an int) with purpose ``rng.P_MEDIUM_BASE + m``, its event is
    ``medium_hit_plain`` clipped to the t so far, and it wins by a strict
    '<', setting (t_m, KIND_MEDIUM, m). Returns (t, kind, idx)."""
    for m in range(media.n_media):
        msph, mpln = media.boundary(m)
        u = rng.uniform(pixel, sample, bounce, rng.P_MEDIUM_BASE + m, seed)
        t_m = medium_hit_plain(msph, mpln, media.nid[m], o, d, t,
                               torch.broadcast_to(u, t.shape))
        is_med = t_m < t
        t = torch.where(is_med, t_m, t)
        kind = torch.where(is_med, KIND_MEDIUM, kind)
        idx = torch.where(is_med, m, idx)
    return t, kind, idx


def scene_hit_plain(s: Solids, media: MediaTables, o, d, pixel, sample,
                    bounce, seed):
    """Plain PyTorch K4: the closest solid hit on [RAY_T_MIN, inf), decoded
    as the JAX ``scene_hit_fused`` does (pallas_sweep.py:563-575; a miss is
    (INF, KIND_SPHERE, 0)), then every medium in order (``media_hit_plain``;
    a medium wins only by a strict '<', as in the fused slot encoding).
    Each counter is an (R,) int tensor or an int. Returns (t, kind, idx)."""
    t, slot = closest_hit_plain(s.sph_table, s.pl_table, o, d, RAY_T_MIN,
                                INF)
    n_sph, n_pl = s.sph_table.shape[0], s.pl_table.shape[0]
    is_sphere = slot < n_sph
    pslot = torch.clamp(slot - n_sph, 0, n_pl - 1).long()
    kind = torch.where(is_sphere, KIND_SPHERE,
                       torch.where(s.pl_is_tri[pslot], KIND_TRIANGLE,
                                   KIND_QUAD)).to(torch.int32)
    idx = torch.where(is_sphere, torch.clamp(slot, min=0),
                      s.pl_idx[pslot]).to(torch.int32)
    return media_hit_plain(media, o, d, t, kind, idx, pixel, sample, bounce,
                           seed)


# --- wrappers ---------------------------------------------------------------

def _hit_outputs(r, dev):
    """Empty (t, kind, idx) for R rays: f32, int32, int32."""
    return (torch.empty((r,), dtype=torch.float32, device=dev),
            torch.empty((r,), dtype=torch.int32, device=dev),
            torch.empty((r,), dtype=torch.int32, device=dev))


def bvh_sphere_hit(sph, o, d, tmin, tmax, t_p, pslot, pl_idx, pl_is_tri):
    """K2 in its BVH mode: the closest sphere hit on [tmin, tmax] (Python
    floats) min-combined with K1's planar hit (``t_p`` (R,) f32, ``pslot``
    (R,) int32) and decoded by ``pl_idx`` (P,) int32 and ``pl_is_tri`` (P,)
    bool, in one launch (``bvh_sphere_hit_plain`` says what it computes).
    Returns (t, kind, idx)."""
    rays = _build.ray_components(o, d)
    dev, r = _build.check_rays(rays, sph, t_p)
    if dev.type == "cpu":
        return bvh_sphere_hit_plain(sph, rays[:3], rays[3:], tmin, tmax,
                                    t_p, pslot, pl_idx, pl_is_tri)
    if dev.type != "cuda":
        raise ValueError(f"bvh_sphere_hit: unsupported device {dev}")
    if isinstance(tmin, torch.Tensor) or isinstance(tmax, torch.Tensor):
        raise TypeError("bvh_sphere_hit: tmin and tmax must be Python floats")
    n_pl = pl_idx.shape[0]
    if sph.shape[1] != 8 or t_p.shape != (r,) or n_pl < 1:
        raise ValueError("bvh_sphere_hit: spheres must be (S, 8), t_p (R,), "
                         "and the planar table non-empty")
    for x, dtype, n in ((pslot, torch.int32, r), (pl_idx, torch.int32, n_pl),
                        (pl_is_tri, torch.bool, n_pl)):
        if x.device != dev or x.dtype != dtype or x.shape != (n,) or \
                not x.is_contiguous():
            raise ValueError("bvh_sphere_hit: pslot must be (R,) int32, "
                             "pl_idx (P,) int32 and pl_is_tri (P,) bool, "
                             "contiguous on the rays' device")
    outs = _hit_outputs(r, dev)
    p = _build.ptr
    err = _build.library().k2_bvh_spheres_launch(
        *(p(x) for x in rays), float(tmin), float(tmax), p(sph),
        sph.shape[0], p(t_p), p(pslot), p(pl_idx), p(pl_is_tri), n_pl, r,
        *(p(x) for x in outs), _build.stream_of(outs[0]))
    _build.check(err, "k2_bvh_spheres")
    bvh_sphere_hit.launches += 1
    return outs


bvh_sphere_hit.launches = 0


def _draw_args(name, pixel, sample, bounce, seed, r, dev):
    """The kernels' lane counters as (pointer, element size) pairs and the
    seed as its low 32 bits: each counter a contiguous (R,) int32 or int64
    tensor on the rays' device."""
    args = []
    for x in (pixel, sample, bounce):
        if not isinstance(x, torch.Tensor) or x.shape != (r,) or \
                x.dtype not in (torch.int32, torch.int64) or \
                x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name}: a counter must be a contiguous (R,) "
                             "int32 / int64 tensor on the rays' device")
        args += [_build.ptr(x), x.element_size()]
    return args + [int(seed) & 0xFFFFFFFF]


def _media_args(name, media: MediaTables, dev):
    """The kernels' media arguments: packed tables and their row counts,
    offsets, neg_inv_density, boxes and the number of media."""
    if media.sph.shape[1] != 8 or media.pln.shape[1] != 16 or \
            media.box.shape != (media.n_media, 8) or \
            media.nid.shape != (media.n_media,):
        raise ValueError(f"{name}: media tables must be (S, 8) and (P, 16), "
                         "boxes (M, 8) and densities (M,)")
    if media.sph_off_t.device != dev or media.pl_off_t.device != dev:
        raise ValueError(f"{name}: media offsets must be on the rays' device")
    p = _build.ptr
    return [p(media.sph), media.sph.shape[0], p(media.pln),
            media.pln.shape[0], p(media.sph_off_t), p(media.pl_off_t),
            p(media.nid), p(media.box), media.n_media]


@detached
def media_hit(media: MediaTables, o, d, t, kind, idx, pixel, sample, bounce,
              seed):
    """K3: every medium of ``media`` in order on top of the hit (``t`` (R,)
    f32, ``kind`` and ``idx`` (R,) int32, as K2 gives them), in one launch:
    each medium culled by its padded box, its flight uniform drawn from the
    lane counters (pixel, sample, bounce: (R,) int32 / int64 tensors, as
    ``trace_queued`` passes them; seed: an int) and its event won by a
    strict '<' (``media_hit_plain`` says what it computes; on CPU rays it
    also takes ints for counters). Returns new (t, kind, idx)."""
    rays = _build.ray_components(o, d)
    dev, r = _build.check_rays(rays, t, media.sph, media.pln, media.nid,
                               media.box)
    if dev.type == "cpu":
        return media_hit_plain(media, rays[:3], rays[3:], t, kind, idx, pixel,
                               sample, bounce, seed)
    if dev.type != "cuda":
        raise ValueError(f"media_hit: unsupported device {dev}")
    for x, dtype in ((t, torch.float32), (kind, torch.int32),
                     (idx, torch.int32)):
        if x.device != dev or x.dtype != dtype or x.shape != (r,) or \
                not x.is_contiguous():
            raise ValueError("media_hit: t must be (R,) f32, kind and idx "
                             "(R,) int32, contiguous on the rays' device")
    draw = _draw_args("media_hit", pixel, sample, bounce, seed, r, dev)
    outs = _hit_outputs(r, dev)
    p = _build.ptr
    err = _build.library().k3_media_launch(
        *(p(x) for x in rays), *draw, *_media_args("media_hit", media, dev),
        p(t), p(kind), p(idx), r, *(p(x) for x in outs),
        _build.stream_of(outs[0]))
    _build.check(err, "k3_media")
    media_hit.launches += 1
    return outs


media_hit.launches = 0


@detached
def scene_hit(s: Solids, media: MediaTables, o, d, pixel, sample, bounce,
              seed):
    """K4: the whole scene hit of a scene without a BVH in one launch —
    closest solid hit plus every medium's event, the flight uniforms drawn
    from the lane counters (pixel, sample, bounce: (R,) int32 / int64
    tensors, as ``trace_queued`` passes them; seed: an int) in the kernel
    (``scene_hit_plain`` says what it computes; on CPU rays it also takes
    ints for counters). Returns (t, kind, idx)."""
    rays = _build.ray_components(o, d)
    sph, pln = s.sph_table, s.pl_table
    dev, r = _build.check_rays(rays, sph, pln, media.sph, media.pln,
                               media.nid, media.box)
    if dev.type == "cpu":
        return scene_hit_plain(s, media, rays[:3], rays[3:], pixel, sample,
                               bounce, seed)
    if dev.type != "cuda":
        raise ValueError(f"scene_hit: unsupported device {dev}")
    if sph.shape[1] != 8 or pln.shape[1] != 16:
        raise ValueError("scene_hit: tables must be (S, 8) and (P, 16)")
    if s.pl_idx.device != dev:
        raise ValueError("scene_hit: pl_idx must be on the rays' device")
    draw = _draw_args("scene_hit", pixel, sample, bounce, seed, r, dev)
    outs = _hit_outputs(r, dev)
    p = _build.ptr
    err = _build.library().k4_scene_hit_launch(
        *(p(x) for x in rays), *draw, p(sph), sph.shape[0], p(pln),
        pln.shape[0], p(s.pl_idx), *_media_args("scene_hit", media, dev), r,
        *(p(x) for x in outs), _build.stream_of(outs[0]))
    _build.check(err, "k4_scene_hit")
    scene_hit.launches += 1
    return outs


scene_hit.launches = 0
