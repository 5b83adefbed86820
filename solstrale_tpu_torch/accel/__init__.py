"""Host-side (numpy) BVH builds: the complete-tree LBVH and the layout the
BVH hit kernel (``ops/bvh.py``) traverses.

Both trees are *complete* binary trees over a power-of-two leaf count, so
node i's children are 2i+1 / 2i+2 and no child pointers are stored. The
builds match the JAX package's ``accel/__init__.py`` array for array
(``Bvh`` and the ``KernelBvh`` fields ``top_nodes`` / ``rows``); the port's
``KernelBvh`` additionally keeps the full node arrays and the row-major
leaf table that its GPU kernel reads.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..scene.compile import KIND_QUAD, KIND_SPHERE, KIND_TRIANGLE, Solids

LEAF_SIZE = 4
# Levels of the kernel tree above the treelet roots. This fixes the treelet
# size (n_leaves / 2^(TOP_LEVELS-1) leaves) and with it the leaf order, so
# it stays equal to the JAX package's value for the layouts to match.
TOP_LEVELS = 12
# Box stored for an empty subtree (all-padding leaves): a point far away,
# which the strict near < far slab test misses. The ±inf box a min/max
# reduction leaves there would be hit by every ray.
EMPTY_BOX = 1e30


@dataclass(frozen=True)
class Bvh:
    node_min: object   # (2*n_leaves-1, 3) f32
    node_max: object
    lp_kind: object    # (n_leaves*LEAF_SIZE,) int32, -1 = padding
    lp_idx: object     # (n_leaves*LEAF_SIZE,) int32


class KernelBvh:
    """Planar-only BVH (quads + triangles; spheres are swept by the caller).

    Fields shared with the JAX package's layout:
    - ``top_nodes`` (n_top_p, 8) f32 [min xyz, max xyz, split axis, 0]: the
      first 2*n_troots-1 nodes, down to the treelet roots;
    - ``rows`` (n_troots*nbt*16, 128) f32: the TPU column-block leaf layout.
    Fields of the port's kernel:
    - ``node_min`` / ``node_max`` (n_nodes, 3) f32: every node of the
      complete tree over ``n_leaves`` leaves of ``leaf_size`` prims, as the
      level reduction leaves them (±inf on empty subtrees);
    - ``nodes`` (n_nodes, 8) f32 [min xyz, max xyz, split axis, 0]: the
      boxes the kernel tests, rounded outwards in the f64 -> f32 cast so
      they never shrink, empty subtrees as an EMPTY_BOX point, split
      axis of each internal node (recorded by the median-split build above
      the treelet roots, the axis of widest child-centre separation below);
    - ``prims`` (n_leaves*leaf_size, 16) f32: one row per leaf slot,
      n.xyz d g1.xyz g1o g2.xyz g2o is_tri valid slot 0.
    """

    KLEAF = 8

    def __init__(self, top_nodes, rows, n_troots, tr, n_leaves, leaf_size,
                 has_spheres, node_min, node_max, nodes, prims):
        self.top_nodes = top_nodes
        self.rows = rows
        self.n_troots = int(n_troots)
        self.tr = int(tr)
        self.n_leaves = int(n_leaves)
        self.leaf_size = int(leaf_size)
        self.has_spheres = bool(has_spheres)
        self.node_min = node_min
        self.node_max = node_max
        self.nodes = nodes
        self.prims = prims

    _ARRAYS = ("top_nodes", "rows", "node_min", "node_max", "nodes", "prims")

    def to(self, device):
        """Copy with every array as a tensor on ``device``."""
        kw = {k: torch.as_tensor(getattr(self, k)).to(device)
              for k in self._ARRAYS}
        return KernelBvh(n_troots=self.n_troots, tr=self.tr,
                         n_leaves=self.n_leaves, leaf_size=self.leaf_size,
                         has_spheres=self.has_spheres, **kw)

    @property
    def depth(self):
        """Number of levels of the complete tree."""
        return int(np.log2(self.n_leaves)) + 1


def _expand_bits(v):
    """Spread the low 10 bits of v over 30 bits (Morton interleave)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(centroids):
    """30-bit Morton codes of points normalized to the overall AABB."""
    c = np.asarray(centroids, np.float64)
    lo = c.min(axis=0)
    hi = c.max(axis=0)
    ext = np.maximum(hi - lo, 1e-12)
    q = np.clip(((c - lo) / ext) * 1023.0, 0, 1023).astype(np.uint32)
    return (_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1) | \
        _expand_bits(q[:, 2])


def _padded(lo, hi, pad=1e-4):
    """Pad degenerate AABB axes like the reference (geo/mod.rs:134-156)."""
    thin = (hi - lo) < pad
    return (np.where(thin, lo - pad / 2, lo), np.where(thin, hi + pad / 2, hi))


def _planar_aabbs(s: Solids):
    """Valid quad and triangle AABBs (f64) with their typed indices."""
    qi = np.nonzero(np.asarray(s.qd_valid))[0]
    qq = np.asarray(s.qd_q, np.float64)[qi]
    qu = np.asarray(s.qd_u, np.float64)[qi]
    qv = np.asarray(s.qd_v, np.float64)[qi]
    pts = np.stack([qq, qq + qu, qq + qv, qq + qu + qv], axis=1)
    q_lo, q_hi = _padded(pts.min(1), pts.max(1))

    ti = np.nonzero(np.asarray(s.tr_valid))[0]
    tv = np.asarray(s.tr_v0, np.float64)[ti]
    te1 = np.asarray(s.tr_e1, np.float64)[ti]
    te2 = np.asarray(s.tr_e2, np.float64)[ti]
    pts = np.stack([tv, tv + te1, tv + te2], axis=1)
    t_lo, t_hi = _padded(pts.min(1), pts.max(1))
    return qi, q_lo, q_hi, ti, t_lo, t_hi


def solids_aabbs(s: Solids):
    """Per-primitive AABBs for the unified prim list (host numpy): returns
    (kinds, idxs, aabb_min, aabb_max) for valid prims only."""
    si = np.nonzero(np.asarray(s.sph_valid))[0]
    sc = np.asarray(s.sph_center, np.float64)[si]
    sr = np.asarray(s.sph_radius, np.float64)[si, None]
    qi, q_lo, q_hi, ti, t_lo, t_hi = _planar_aabbs(s)
    kinds = np.concatenate([np.full(len(si), KIND_SPHERE, np.int32),
                            np.full(len(qi), KIND_QUAD, np.int32),
                            np.full(len(ti), KIND_TRIANGLE, np.int32)])
    idxs = np.concatenate([si, qi, ti]).astype(np.int32)
    mins = np.concatenate([sc - sr, q_lo, t_lo], axis=0)
    maxs = np.concatenate([sc + sr, q_hi, t_hi], axis=0)
    return kinds, idxs, mins, maxs


def median_split_order(mins, maxs, leaf_size, n_leaves, stop_leaves=1,
                       axes_out=None):
    """Leaf ordering by recursive most-spread-axis median splits (the
    reference's split rule, bvh.rs:116-162) in the complete-tree layout:
    each split puts the first half-capacity of the sorted segment in the
    left subtree. Splitting stops once a segment covers ``stop_leaves``
    leaves. axes_out (optional dict) receives {node id: split axis}.
    Returns a permutation of range(n)."""
    c = (np.asarray(mins, np.float64) + np.asarray(maxs, np.float64)) * 0.5
    n = c.shape[0]
    order = np.arange(n)
    segments = [(0, n, n_leaves, 0)]
    while segments:
        nxt = []
        for s, e, nl, node in segments:
            if e - s <= 1 or nl <= stop_leaves:
                continue
            seg = order[s:e]
            cs = c[seg]
            axis = int(np.argmax(cs.max(axis=0) - cs.min(axis=0)))
            if axes_out is not None:
                axes_out[node] = axis
            order[s:e] = seg[np.argsort(cs[:, axis], kind="stable")]
            half_cap = (nl // 2) * leaf_size
            split = min(e - s, half_cap)
            nxt.append((s, s + split, nl // 2, 2 * node + 1))
            nxt.append((s + split, e, nl - nl // 2, 2 * node + 2))
        segments = nxt
    return order


def _n_leaves(n, leaf_size):
    return max(1, 1 << int(np.ceil(np.log2(max(1, (n + leaf_size - 1)
                                               // leaf_size)))))


def _level_boxes(slot_min, slot_max, n_leaves, leaf_size):
    """Complete-tree node boxes by bottom-up level reductions."""
    n_nodes = 2 * n_leaves - 1
    node_min = np.full((n_nodes, 3), np.inf)
    node_max = np.full((n_nodes, 3), -np.inf)
    lvl_min = slot_min.reshape(n_leaves, leaf_size, 3).min(1)
    lvl_max = slot_max.reshape(n_leaves, leaf_size, 3).max(1)
    node_min[n_leaves - 1:] = lvl_min
    node_max[n_leaves - 1:] = lvl_max
    while lvl_min.shape[0] > 1:
        lvl_min = lvl_min.reshape(-1, 2, 3).min(1)
        lvl_max = lvl_max.reshape(-1, 2, 3).max(1)
        base = lvl_min.shape[0] - 1
        node_min[base:base + lvl_min.shape[0]] = lvl_min
        node_max[base:base + lvl_max.shape[0]] = lvl_max
    return node_min, node_max


def build_bvh(s: Solids, leaf_size=LEAF_SIZE) -> Bvh:
    """Host-side LBVH build: Morton sort + complete-tree AABBs (numpy)."""
    kinds, idxs, mins, maxs = solids_aabbs(s)
    n = len(kinds)
    order = np.argsort(morton_codes((mins + maxs) / 2.0), kind="stable")
    kinds, idxs = kinds[order], idxs[order]
    mins, maxs = mins[order], maxs[order]

    n_leaves = _n_leaves(n, leaf_size)
    n_slots = n_leaves * leaf_size
    lp_kind = np.full(n_slots, -1, np.int32)
    lp_idx = np.zeros(n_slots, np.int32)
    lp_kind[:n] = kinds
    lp_idx[:n] = idxs
    slot_min = np.full((n_slots, 3), np.inf)
    slot_max = np.full((n_slots, 3), -np.inf)
    slot_min[:n] = mins
    slot_max[:n] = maxs
    node_min, node_max = _level_boxes(slot_min, slot_max, n_leaves,
                                      leaf_size)
    return Bvh(node_min=node_min.astype(np.float32),
               node_max=node_max.astype(np.float32),
               lp_kind=lp_kind, lp_idx=lp_idx)


def _round_down(x):
    """f64 -> f32, rounded towards -inf (boxes only grow in the cast)."""
    y = x.astype(np.float32)
    return np.where(y.astype(np.float64) > x,
                    np.nextafter(y, np.float32(-np.inf)), y)


def _round_up(x):
    y = x.astype(np.float32)
    return np.where(y.astype(np.float64) < x,
                    np.nextafter(y, np.float32(np.inf)), y)


def _kernel_nodes(node_min, node_max, split_axes, n_leaves):
    """(n_nodes, 8) f32 kernel node table: empty boxes replaced by the
    EMPTY_BOX point, split axis per internal node."""
    bmin = node_min.copy()
    bmax = node_max.copy()
    empty = ~(bmin[:, 0] <= bmax[:, 0])
    bmin[empty] = EMPTY_BOX
    bmax[empty] = EMPTY_BOX
    n_int = n_leaves - 1
    centre = (bmin + bmax) * 0.5
    # below the treelet roots the build recorded no split: take the axis
    # along which the two children's centres lie farthest apart
    left = 2 * np.arange(n_int) + 1
    axis = np.zeros(2 * n_leaves - 1)
    if n_int:
        sep = np.abs(centre[left + 1] - centre[left])
        sep[~np.isfinite(sep) | (sep > EMPTY_BOX / 2)] = 0.0
        axis[:n_int] = np.argmax(sep, axis=1)
    for node, ax in split_axes.items():
        axis[node] = ax
    nodes = np.zeros((2 * n_leaves - 1, 8), np.float32)
    nodes[:, 0:3] = _round_down(bmin)
    nodes[:, 3:6] = _round_up(bmax)
    nodes[empty, 0:6] = EMPTY_BOX  # a point: min == max after the cast too
    nodes[:, 6] = axis
    return nodes


def build_kernel_bvh(s: Solids, leaf_size=KernelBvh.KLEAF):
    """Planar-only BVH for the hit kernel (see KernelBvh), host numpy.
    Median-split leaf order, stopped at the treelet level like the JAX
    package's build."""
    Q = np.asarray(s.qd_valid).shape[0]
    qi, q_lo, q_hi, ti, t_lo, t_hi = _planar_aabbs(s)
    slots = np.concatenate([qi, Q + ti]).astype(np.int32)
    mins = np.concatenate([q_lo, t_lo], axis=0)
    maxs = np.concatenate([q_hi, t_hi], axis=0)
    n = slots.shape[0]

    n_leaves = _n_leaves(n, leaf_size)
    stop = max(1, n_leaves // (1 << (TOP_LEVELS - 1)))
    split_axes = {}
    order = median_split_order(mins, maxs, leaf_size, n_leaves,
                               stop_leaves=stop, axes_out=split_axes)
    slots, mins, maxs = slots[order], mins[order], maxs[order]
    n_slots = n_leaves * leaf_size

    rows = np.zeros((n_slots, 16), np.float32)
    pl_cols = np.concatenate(
        [np.asarray(s.pl_n, np.float32),
         np.asarray(s.pl_d, np.float32)[:, None],
         np.asarray(s.pl_g1, np.float32),
         np.asarray(s.pl_g1o, np.float32)[:, None],
         np.asarray(s.pl_g2, np.float32),
         np.asarray(s.pl_g2o, np.float32)[:, None],
         np.asarray(s.pl_is_tri, np.float32)[:, None]], axis=1)
    rows[:n, :13] = pl_cols[slots]
    rows[:n, 13] = 1.0                        # valid
    rows[:n, 14] = slots.astype(np.float32)   # planar slot id

    slot_min = np.full((n_slots, 3), np.inf)
    slot_max = np.full((n_slots, 3), -np.inf)
    slot_min[:n] = mins
    slot_max[:n] = maxs
    node_min, node_max = _level_boxes(slot_min, slot_max, n_leaves,
                                      leaf_size)

    # the JAX package's two-level TPU layout, kept field for field
    tr = max(1, n_leaves // (1 << (TOP_LEVELS - 1)))
    n_troots = n_leaves // tr
    n_top = 2 * n_troots - 1
    n_top_p = (n_top + 7) // 8 * 8
    top = np.zeros((n_top_p, 8), np.float32)
    tmin_ = node_min[:n_top].copy()
    tmax_ = node_max[:n_top].copy()
    empty = ~(tmin_[:, 0] <= tmax_[:, 0])
    tmin_[empty] = EMPTY_BOX
    tmax_[empty] = EMPTY_BOX
    top[:n_top, 0:3] = tmin_
    top[:n_top, 3:6] = tmax_
    for node, axis in split_axes.items():
        if node < n_top:
            top[node, 6] = float(axis)
    has_spheres = bool(np.asarray(s.sph_valid).any())
    p_t = tr * leaf_size
    nbt = max(1, (p_t + 127) // 128)
    blk = np.zeros((n_troots, nbt * 128, 16), np.float32)
    blk[:, :p_t, :] = rows.reshape(n_troots, p_t, 16)
    blk = blk.reshape(n_troots, nbt, 128, 16).transpose(0, 1, 3, 2)

    return KernelBvh(top_nodes=top,
                     rows=np.ascontiguousarray(
                         blk.reshape(n_troots * nbt * 16, 128)),
                     n_troots=n_troots, tr=tr,
                     n_leaves=n_leaves, leaf_size=leaf_size,
                     has_spheres=has_spheres,
                     node_min=node_min.astype(np.float32),
                     node_max=node_max.astype(np.float32),
                     nodes=_kernel_nodes(node_min, node_max, split_axes,
                                         n_leaves),
                     prims=rows)
