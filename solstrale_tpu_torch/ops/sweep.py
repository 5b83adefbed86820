"""Brute-force sweeps: closest hit over the sphere + planar tables (K2),
one constant medium's scattering event (K3), and both fused into the whole
scene hit of a scene without a BVH (K4).

Each has a hand-written CUDA kernel (``csrc/sweep.cu``) and a plain PyTorch
version with the same formulas, op for op (the JAX package's
``ops/pallas_sweep.py`` kernels, which these replace). The wrapper picks by
the tensors' device only: CPU tensors take the plain version, CUDA tensors
launch the kernel or raise.

Tables (``Solids.sph_table`` / ``Solids.pl_table``):
- spheres (S, 8): cx cy cz radius valid 0 0 0
- planar (P, 16): nx ny nz d g1.xyz g1o g2.xyz g2o is_tri valid 0 0
Rays are component tuples of (R,) f32 tensors (``geo/soa.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..geo import ALMOST_ZERO, INF, RAY_T_MIN
from . import _build

# plain versions work on (ray chunk, prim chunk) blocks to bound memory
RAY_CHUNK = 8192
PRIM_CHUNK = 1024


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
    """Plain PyTorch K2: (t, slot) with slot < S a sphere, S + p planar row
    p, -1 a miss (t = INF)."""
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
    """Plain PyTorch K3: the medium event t per ray, INF when none
    (constant_medium.rs:35-79, pallas_sweep.py:249-313)."""
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
    the tables' device (the kernels read them)."""

    sph: torch.Tensor        # (sum S_m, 8) f32
    pln: torch.Tensor        # (sum P_m, 16) f32
    sph_off: tuple           # M+1 host ints
    pl_off: tuple
    sph_off_t: torch.Tensor  # (M+1,) int32
    pl_off_t: torch.Tensor
    nid: torch.Tensor        # (M,) f32 neg_inv_density
    mat: torch.Tensor        # (M,) int32 phase material

    @property
    def n_media(self):
        return len(self.sph_off) - 1

    def boundary(self, m):
        """Medium m's (sphere, planar) table views."""
        return (self.sph[self.sph_off[m]:self.sph_off[m + 1]],
                self.pln[self.pl_off[m]:self.pl_off[m + 1]])


def pack_media(media, device):
    """MediaTables of a CompiledScene's ``media`` (tuple of Medium)."""
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
             else torch.zeros((0,), dtype=torch.int32, device=device)))


def scene_hit_plain(sph, pln, media: MediaTables, o, d, u_flights):
    """Plain PyTorch K4: K2 over the solid tables on [RAY_T_MIN, inf), then
    K3 for each medium in order, each clipped to the best t so far (the
    events of the media before it included). ``u_flights`` is (M, R).
    Returns (t, slot): slot < S sphere, S + p planar row p, S + P + m
    medium m, -1 a miss (t = INF)."""
    t, slot = closest_hit_plain(sph, pln, o, d, RAY_T_MIN, INF)
    base = sph.shape[0] + pln.shape[0]
    for m in range(media.n_media):
        msph, mpln = media.boundary(m)
        t_m = medium_hit_plain(msph, mpln, media.nid[m], o, d, t,
                               u_flights[m])
        is_med = t_m < t
        t = torch.where(is_med, t_m, t)
        slot = torch.where(is_med, base + m, slot)
    return t, slot


# --- wrappers ---------------------------------------------------------------

def closest_hit(sph, pln, o, d, tmin, tmax, spheres_only=False):
    """K2: closest hit over both tables (spheres only if ``spheres_only``).
    Returns (t (R,) f32, slot (R,) int32): slot < S sphere, S + p planar,
    -1 miss."""
    rays = _build.ray_components(o, d)
    dev, r = _build.check_rays(rays, sph, pln)
    if dev.type == "cpu":
        return closest_hit_plain(sph, pln, rays[:3], rays[3:], tmin, tmax,
                                 spheres_only)
    if dev.type != "cuda":
        raise ValueError(f"closest_hit: unsupported device {dev}")
    if sph.shape[1] != 8 or pln.shape[1] != 16:
        raise ValueError("closest_hit: tables must be (S, 8) and (P, 16)")
    lo, hi = _build.per_ray(tmin, rays[0]), _build.per_ray(tmax, rays[0])
    out_t = torch.empty((r,), dtype=torch.float32, device=dev)
    out_s = torch.empty((r,), dtype=torch.int32, device=dev)
    p = _build.ptr
    err = _build.library().k2_sweep_launch(
        *(p(x) for x in rays), p(lo), p(hi), p(sph), sph.shape[0], p(pln),
        0 if spheres_only else pln.shape[0], r, p(out_t), p(out_s),
        _build.stream_of(out_t))
    _build.check(err, "k2_sweep")
    closest_hit.launches += 1
    return out_t, out_s


closest_hit.launches = 0


def medium_hit(sph, pln, neg_inv_density, o, d, t_solid, u_flight):
    """K3: one constant medium's scattering t per ray (INF = no event).
    ``neg_inv_density`` is a 0-dim f32 tensor on the rays' device."""
    rays = _build.ray_components(o, d)
    t_solid = t_solid.contiguous()
    u_flight = u_flight.contiguous()
    dev, r = _build.check_rays(rays + (t_solid, u_flight), sph, pln)
    if dev.type == "cpu":
        return medium_hit_plain(sph, pln, neg_inv_density, rays[:3],
                                rays[3:], t_solid, u_flight)
    if dev.type != "cuda":
        raise ValueError(f"medium_hit: unsupported device {dev}")
    if sph.shape[1] != 8 or pln.shape[1] != 16:
        raise ValueError("medium_hit: tables must be (S, 8) and (P, 16)")
    nid = neg_inv_density.to(device=dev, dtype=torch.float32).reshape(1)
    out_t = torch.empty((r,), dtype=torch.float32, device=dev)
    p = _build.ptr
    err = _build.library().k3_medium_launch(
        *(p(x) for x in rays), p(t_solid), p(u_flight), p(sph), sph.shape[0],
        p(pln), pln.shape[0], p(nid), r, p(out_t), _build.stream_of(out_t))
    _build.check(err, "k3_medium")
    medium_hit.launches += 1
    return out_t


medium_hit.launches = 0


def scene_hit(sph, pln, media: MediaTables, o, d, u_flights):
    """K4: the whole scene hit of a scene without a BVH in one launch —
    closest solid hit plus every medium's event (``scene_hit_plain`` says
    what it computes). ``u_flights`` is (M, R) f32. Returns (t, slot)."""
    rays = _build.ray_components(o, d)
    u_flights = u_flights.contiguous()
    dev, r = _build.check_rays(rays, sph, pln, media.sph, media.pln,
                               media.nid, u_flights)
    if u_flights.shape != (media.n_media, r):
        raise ValueError("scene_hit: u_flights must be (n_media, R)")
    if dev.type == "cpu":
        return scene_hit_plain(sph, pln, media, rays[:3], rays[3:],
                               u_flights)
    if dev.type != "cuda":
        raise ValueError(f"scene_hit: unsupported device {dev}")
    if sph.shape[1] != 8 or pln.shape[1] != 16 or media.sph.shape[1] != 8 \
            or media.pln.shape[1] != 16:
        raise ValueError("scene_hit: tables must be (S, 8) and (P, 16)")
    if media.sph_off_t.device != dev or media.pl_off_t.device != dev:
        raise ValueError("scene_hit: media offsets must be on the rays' device")
    out_t = torch.empty((r,), dtype=torch.float32, device=dev)
    out_s = torch.empty((r,), dtype=torch.int32, device=dev)
    p = _build.ptr
    err = _build.library().k4_scene_hit_launch(
        *(p(x) for x in rays), p(u_flights), p(sph), sph.shape[0], p(pln),
        pln.shape[0], p(media.sph), p(media.pln), p(media.sph_off_t),
        p(media.pl_off_t), p(media.nid), media.n_media, r, p(out_t),
        p(out_s), _build.stream_of(out_t))
    _build.check(err, "k4_scene_hit")
    scene_hit.launches += 1
    return out_t, out_s


scene_hit.launches = 0
