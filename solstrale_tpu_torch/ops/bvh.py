"""Closest planar hit through the BVH (K1), and the BVH scene's closest
solid hit (K1, then K2 in its BVH mode: spheres-only, min-combined).

K1 has a hand-written CUDA kernel (``csrc/bvh.cu``, replacing the JAX
package's ``ops/pallas_bvh.py::_bvh_kernel``: a walk of the port's
full-depth kernel tree, child boxes in the parent, the top levels in shared
memory) and a plain PyTorch version: a brute-force sweep, chunked over rays
and prims, over the same leaf table the kernel reads. The wrapper picks by
the tensors' device only: CPU tensors take the plain version, CUDA tensors
launch the kernel or raise.
"""
from __future__ import annotations

import torch

from ..accel import WALK_LEAF
from ..geo import ALMOST_ZERO, INF
from ..scene.compile import KIND_QUAD, KIND_TRIANGLE
from . import _build, sweep
from .detached import detached

RAY_CHUNK = 8192
PRIM_CHUNK = 4096
# The kernel tree's internal levels the shared-memory stack may hold (8
# bytes an entry per thread; 2^28 leaves is far beyond any scene).
MAX_LEVELS = 28
# Block size by lane count, chosen by measurement on the H100 (PERF.md,
# K1): a launch of at most 132 blocks of THREADS (the wavefront's
# 16,384-lane tail) takes TAIL_THREADS, so that every one of the 132 SMs
# gets a block.
THREADS = 256
TAIL_THREADS = 64


def bvh_planar_hit_plain(prims, o, d, tmin):
    """Plain PyTorch K1 over the (n_slots, 16) leaf table: closest t >= tmin
    with the kernel's unified formula (pallas_bvh.py:250-264), ties to the
    smallest slot; (INF, -1) on a miss."""
    r = o[0].shape[0]
    dev = o[0].device
    tmin = _build.per_ray(tmin, o[0])
    out_t = torch.full((r,), INF, dtype=torch.float32, device=dev)
    out_s = torch.full((r,), -1, dtype=torch.int32, device=dev)
    big = torch.iinfo(torch.int32).max
    for a in range(0, r, RAY_CHUNK):
        sl = slice(a, a + RAY_CHUNK)
        om = tuple(c[sl][:, None] for c in o)
        dm = tuple(c[sl][:, None] for c in d)
        lo = tmin[sl][:, None]
        best_t, best_s = out_t[sl], out_s[sl]
        for p in range(0, prims.shape[0], PRIM_CHUNK):
            f = [prims[p:p + PRIM_CHUNK, k][None, :] for k in range(15)]
            on = om[0] * f[0] + om[1] * f[1] + om[2] * f[2]
            dn = dm[0] * f[0] + dm[1] * f[1] + dm[2] * f[2]
            og1 = om[0] * f[4] + om[1] * f[5] + om[2] * f[6]
            dg1 = dm[0] * f[4] + dm[1] * f[5] + dm[2] * f[6]
            og2 = om[0] * f[8] + om[1] * f[9] + om[2] * f[10]
            dg2 = dm[0] * f[8] + dm[1] * f[9] + dm[2] * f[10]
            t = (f[3] - on) / dn
            u = og1 + t * dg1 + f[7]
            v = og2 + t * dg2 + f[11]
            contain = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & torch.where(
                f[12] > 0.5, u + v <= 1.0, v <= 1.0)
            ok = ((torch.abs(dn) >= ALMOST_ZERO) & (f[13] > 0.5) & contain
                  & (t >= lo))
            t = torch.where(ok, t, INF)
            ct = t.min(dim=1).values
            slot = f[14].to(torch.int32).expand_as(t)
            cs = torch.where(ok & (t == ct[:, None]), slot, big).min(
                dim=1).values
            take = (ct < best_t) | ((ct == best_t) & (ct < INF)
                                    & (cs < best_s))
            best_t = torch.where(take, ct, best_t)
            best_s = torch.where(take, cs, best_s)
        out_t[sl], out_s[sl] = best_t, best_s
    return out_t, out_s


@detached
def bvh_planar_hit(kbvh, o, d, tmin):
    """K1: closest planar hit (t (R,) f32, planar slot (R,) int32; INF/-1
    on a miss). ``kbvh`` is an ``accel.KernelBvh`` on the rays' device;
    ``tmin`` a Python number, which goes to the kernel as an argument, or
    a tensor that broadcasts to the rays (a bound a ray)."""
    rays = _build.ray_components(o, d)
    dev, r = _build.check_rays(rays, kbvh.nodes, kbvh.prims)
    if dev.type == "cpu":
        return bvh_planar_hit_plain(kbvh.prims, rays[:3], rays[3:], tmin)
    if dev.type != "cuda":
        raise ValueError(f"bvh_planar_hit: unsupported device {dev}")
    n_int = kbvh.walk_leaves - 1
    if kbvh.nodes.shape != (n_int, 16) or \
            kbvh.prims.shape != (kbvh.walk_leaves * WALK_LEAF, 16):
        raise ValueError("bvh_planar_hit: node/prim tables do not match "
                         "walk_leaves and WALK_LEAF")
    if kbvh.levels > MAX_LEVELS:
        raise ValueError(f"bvh_planar_hit: tree depth {kbvh.levels} exceeds "
                         f"the kernel stack ({MAX_LEVELS})")
    lo = (_build.per_ray(tmin, rays[0]) if isinstance(tmin, torch.Tensor)
          else None)
    out_t = torch.empty((r,), dtype=torch.float32, device=dev)
    out_s = torch.empty((r,), dtype=torch.int32, device=dev)
    p = _build.ptr
    err = _build.library().k1_bvh_launch(
        *(p(x) for x in rays), None if lo is None else p(lo),
        0.0 if lo is not None else float(tmin), p(kbvh.nodes), p(kbvh.prims),
        n_int,
        kbvh.levels, THREADS if r > 132 * THREADS else TAIL_THREADS, r,
        p(out_t), p(out_s), _build.stream_of(out_t))
    _build.check(err, "k1_bvh")
    bvh_planar_hit.launches += 1
    return out_t, out_s


bvh_planar_hit.launches = 0


@detached
def bvh_closest_hit(kbvh, solids, o, d, tmin, tmax):
    """Closest solid hit on a BVH scene: K1 over planar prims, min-combined
    with K2's spheres-only sweep exactly as the JAX package's
    ``bvh_closest_hit_pallas`` (pallas_bvh.py:606-629); with spheres, the
    sweep, the combine and the decode are one launch of K2 in its BVH mode
    (``sweep.bvh_sphere_hit``). Returns (t, kind, idx)."""
    t_p, pslot = bvh_planar_hit(kbvh, o, d, tmin)
    if kbvh.has_spheres:
        return sweep.bvh_sphere_hit(solids.sph_table, o, d, tmin, tmax, t_p,
                                    pslot, solids.pl_idx, solids.pl_is_tri)
    return (t_p, *decode_planar_slot(solids, pslot))


def decode_planar_slot(solids, slot):
    """K1's planar slot -> (kind, idx) (R,) int32: the solid row of a
    quad or triangle (a miss's slot decodes to a row of no meaning; its t
    is infinite). S1 (``ops.step.step_shade``) decodes the slot the same
    way in its kernel."""
    c = torch.clamp(slot, 0, solids.pl_idx.shape[0] - 1).long()
    kind = torch.where(solids.pl_is_tri[c], KIND_TRIANGLE,
                       KIND_QUAD).to(torch.int32)
    return kind, solids.pl_idx[c]
