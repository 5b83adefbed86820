"""BVH builds: the complete-tree LBVH on the host (numpy, or the native
sort for large scenes) or on a device (``build_bvh_device``, torch), and
the tree the BVH hit kernel (``ops/bvh.py``, ``csrc/bvh.cu``) walks; and
``walk_counts``, a plain PyTorch walk of that tree which counts its work.

Both trees are *complete* binary trees over a power-of-two leaf count, so
node i's children are 2i+1 / 2i+2 and no child pointers are stored. The
builds match the JAX package's ``accel/__init__.py`` array for array
(``Bvh`` and the ``KernelBvh`` fields ``top_nodes`` / ``rows``); the port's
``KernelBvh`` additionally holds its own full-depth tree: the median split
continued down to leaves of ``WALK_LEAF`` prims, with both children's boxes
in each internal node's row.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..geo import ALMOST_ZERO, INF
from ..scene.compile import KIND_QUAD, KIND_SPHERE, KIND_TRIANGLE, Solids

LEAF_SIZE = 4
# prim count from which build_bvh takes the native C++ parallel Morton sort
# and node reduction (native/) over numpy: the JAX package's threshold, so
# its trees and the port's are equal at every size
NATIVE_SORT_THRESHOLD = 100_000
# Levels of the kernel tree above the treelet roots. This fixes the treelet
# size (n_leaves / 2^(TOP_LEVELS-1) leaves) and with it the JAX layout's
# leaf order, so it stays equal to the JAX package's value for the layouts
# to match.
TOP_LEVELS = 12
# Prims per leaf of the port's full-depth kernel tree (2 was measured
# faster than 4 on the H100, PERF.md; csrc/bvh.cu's kWalkLeaf).
WALK_LEAF = 2
# Box stored for an empty subtree (all-padding leaves): a point far away,
# which the strict near < far slab test misses. The ±inf box a min/max
# reduction leaves there would be hit by every ray.
EMPTY_BOX = 1e30
# The walk's slab-test widenings (csrc/bvh.cu uses the same f32 values): a
# box is entered when near < far * FAR_SCALE and near <= best * BEST_SCALE,
# so rounding in the slab test never drops a box the ray really crosses
# (FAR_SCALE) or one holding a prim at the best t (BEST_SCALE: exact ties
# then resolve to the smallest slot, as the brute force resolves them).
FAR_SCALE = float(np.float32(1.0000004))
BEST_SCALE = float(np.float32(1.000002))
# Every prim box of the kernel tree grows by this fraction of the largest
# coordinate of the scene's prim boxes (at least 1). A prim test accepts
# points a few f32 ulps of |o| outside the prim (a ray through a shared
# vertex or edge), which a box that merely holds the prim would cut off at
# its face or corner; the pad keeps such points inside, far beyond the
# slab test's own rounding.
BOX_PAD = 2.0 ** -17


@dataclass(frozen=True)
class Bvh:
    node_min: object   # (2*n_leaves-1, 3) f32
    node_max: object
    lp_kind: object    # (n_leaves*LEAF_SIZE,) int32, -1 = padding
    lp_idx: object     # (n_leaves*LEAF_SIZE,) int32


class KernelBvh:
    """Planar-only BVH (quads + triangles; spheres are swept by the caller).

    Fields shared with the JAX package's layout (``n_leaves`` leaves of
    ``leaf_size`` = 8 prims, median split stopped at the treelet roots):
    - ``top_nodes`` (n_top_p, 8) f32 [min xyz, max xyz, split axis, 0]: the
      first 2*n_troots-1 nodes, down to the treelet roots;
    - ``rows`` (n_troots*nbt*16, 128) f32: the TPU column-block leaf layout.
    Fields of the port's kernel tree: the median split continued down to
    ``walk_leaves`` leaves of WALK_LEAF prims (a complete tree with
    ``walk_leaves - 1`` internal nodes):
    - ``node_min`` / ``node_max`` (2*walk_leaves-1, 3) f32: every node's
      box over its prims' boxes grown by BOX_PAD, rounded outwards in the
      f64 -> f32 cast so it never shrinks, empty subtrees as an EMPTY_BOX
      point;
    - ``nodes`` (walk_leaves-1, 16) f32: one 64-byte row per internal node
      holding both children's boxes, [Lminx Rminx Lmaxx Rmaxx | the same
      for y | for z | L count, R count, 0, 0], the counts being the valid
      prims under each child (a leaf child's prims are its first count
      rows);
    - ``prims`` (n_leaves*leaf_size, 16) f32: one row per leaf slot in the
      kernel tree's leaf order, n.xyz d g1.xyz g1o g2.xyz g2o is_tri
      valid slot 0 (valid rows first in every leaf).
    """

    KLEAF = 8

    def __init__(self, top_nodes, rows, n_troots, tr, n_leaves, leaf_size,
                 has_spheres, walk_leaves, node_min, node_max, nodes, prims):
        self.top_nodes = top_nodes
        self.rows = rows
        self.n_troots = int(n_troots)
        self.tr = int(tr)
        self.n_leaves = int(n_leaves)
        self.leaf_size = int(leaf_size)
        self.has_spheres = bool(has_spheres)
        self.walk_leaves = int(walk_leaves)
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
                         has_spheres=self.has_spheres,
                         walk_leaves=self.walk_leaves, **kw)

    @property
    def levels(self):
        """Internal levels of the kernel tree (the walk's stack bound)."""
        return int(np.log2(self.walk_leaves))


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


def median_split_order(mins, maxs, leaf_size, n_leaves, keep_leaves=None):
    """Leaf ordering by recursive most-spread-axis median splits (the
    reference's split rule, bvh.rs:116-162) in the complete-tree layout:
    each split puts the first half-capacity of the sorted segment in the
    left subtree, so node j of a level whose segments cover ``nl`` leaves
    holds the slot range [j*cap, (j+1)*cap), cap = nl * leaf_size, clipped
    to the n prims. The split runs down to single leaves a level at a time:
    one stable sort by (segment, key) orders every segment of the level.

    Returns (order, axes, kept): ``order`` a permutation of range(n);
    ``axes`` (n_leaves-1,) int8, each internal node's split axis (-1 where
    its segment holds fewer than two prims, which are not split); ``kept``
    the order at the level whose segments cover ``keep_leaves`` leaves
    (where a split that stops at that level ends), else None."""
    c = (np.asarray(mins, np.float64) + np.asarray(maxs, np.float64)) * 0.5
    n = c.shape[0]
    pos = np.arange(n)
    order = pos.copy()
    axes = np.full(n_leaves - 1, -1, np.int8)
    kept = None
    nl = n_leaves
    while True:
        if nl == keep_leaves:
            kept = order.copy()
        if nl <= 1:
            return order, axes, kept
        cap = nl * leaf_size
        starts = np.arange(0, n, cap)   # the level's non-empty segments
        if n:
            cs = c[order]
            spread = (np.maximum.reduceat(cs, starts)
                      - np.minimum.reduceat(cs, starts))
            seg_axis = np.argmax(spread, axis=1)
            split = np.diff(np.append(starts, n)) >= 2
            axes[n_leaves // nl - 1 + np.nonzero(split)[0]] = seg_axis[split]
            seg = pos // cap
            order = order[np.lexsort((cs[pos, seg_axis[seg]], seg))]
        nl //= 2


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
    """Host-side LBVH build: Morton sort + complete-tree AABBs. numpy below
    NATIVE_SORT_THRESHOLD prims; the native C++ parallel sort and node
    reduction (in f32) from there on, as the JAX package's build does."""
    kinds, idxs, mins, maxs = solids_aabbs(s)
    n = len(kinds)
    large = n >= NATIVE_SORT_THRESHOLD
    if large:
        order = native.lbvh_sort(mins.astype(np.float32),
                                 maxs.astype(np.float32))
    else:
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
    if large:
        node_min, node_max = native.lbvh_nodes(slot_min.astype(np.float32),
                                               slot_max.astype(np.float32),
                                               leaf_size)
    else:
        node_min, node_max = _level_boxes(slot_min, slot_max, n_leaves,
                                          leaf_size)
    return Bvh(node_min=node_min.astype(np.float32),
               node_max=node_max.astype(np.float32),
               lp_kind=lp_kind, lp_idx=lp_idx)


def build_bvh_device(aabb_min, aabb_max, kinds, idxs, leaf_size=LEAF_SIZE):
    """On-device LBVH build (torch, on the tensors' device): Morton sort +
    bottom-up level reductions, the steps of the JAX package's
    ``build_bvh_device``. Takes per-prim boxes (n, 3) f32 and their kinds
    and indices (n,) int32; returns a Bvh of tensors on that device.

    The centroids and their quantisation are f32 in JAX's order of
    operations, so the tree equals the JAX one and, from
    NATIVE_SORT_THRESHOLD prims, the host build's native f32 sort."""
    n = aabb_min.shape[0]
    dev = aabb_min.device
    centroid = (aabb_min + aabb_max) * 0.5
    lo = centroid.amin(0)
    hi = centroid.amax(0)
    ext = torch.maximum(hi - lo, torch.tensor(1e-12, dtype=torch.float32,
                                              device=dev))
    q = ((centroid - lo) / ext * 1023.0).clamp(0, 1023).to(torch.int64)

    # Torch has no uint32 arithmetic: spread in int64 with the uint32
    # masks. The inputs are below 2^10 and every mask below 2^32, so each
    # step equals its uint32 wraparound (no product even reaches 2^32).
    def expand(v):
        v = (v * 0x00010001) & 0xFF0000FF
        v = (v * 0x00000101) & 0x0F00F00F
        v = (v * 0x00000011) & 0xC30C30C3
        v = (v * 0x00000005) & 0x49249249
        return v

    code = (expand(q[:, 0]) << 2) | (expand(q[:, 1]) << 1) | expand(q[:, 2])
    order = torch.argsort(code, stable=True)

    n_leaves = _n_leaves(n, leaf_size)
    pad = n_leaves * leaf_size - n
    lp_kind = torch.cat([kinds[order].to(torch.int32),
                         torch.full((pad,), -1, dtype=torch.int32,
                                    device=dev)])
    lp_idx = torch.cat([idxs[order].to(torch.int32),
                        torch.zeros(pad, dtype=torch.int32, device=dev)])
    slot_min = torch.cat([aabb_min[order],
                          torch.full((pad, 3), INF, dtype=aabb_min.dtype,
                                     device=dev)])
    slot_max = torch.cat([aabb_max[order],
                          torch.full((pad, 3), -INF, dtype=aabb_max.dtype,
                                     device=dev)])
    levels_min = [slot_min.reshape(n_leaves, leaf_size, 3).amin(1)]
    levels_max = [slot_max.reshape(n_leaves, leaf_size, 3).amax(1)]
    while levels_min[-1].shape[0] > 1:
        levels_min.append(levels_min[-1].reshape(-1, 2, 3).amin(1))
        levels_max.append(levels_max[-1].reshape(-1, 2, 3).amax(1))
    return Bvh(node_min=torch.cat(levels_min[::-1]),
               node_max=torch.cat(levels_max[::-1]),
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


def _conservative(lo, hi):
    """f64 node boxes -> f32 rounded outwards (boxes only grow in the
    cast), empty subtrees (the ±inf a min/max reduction leaves) as the
    EMPTY_BOX point: min == max after the cast too."""
    empty = ~(lo[:, 0] <= hi[:, 0])
    lo, hi = _round_down(lo), _round_up(hi)
    lo[empty] = EMPTY_BOX
    hi[empty] = EMPTY_BOX
    return lo, hi


def _padded_boxes(mins, maxs):
    """Prim boxes grown by BOX_PAD of the largest coordinate."""
    pad = BOX_PAD * max(1.0, float(np.abs(mins).max(initial=0.0)),
                        float(np.abs(maxs).max(initial=0.0)))
    return mins - pad, maxs + pad


def _slot_boxes(mins, maxs, n_slots):
    """(n_slots, 3) f64 slot boxes: the given ones first, ±inf padding."""
    lo = np.full((n_slots, 3), np.inf)
    hi = np.full((n_slots, 3), -np.inf)
    lo[:len(mins)] = mins
    hi[:len(maxs)] = maxs
    return lo, hi


def _prim_rows(s: Solids, slots, n_slots):
    """(n_slots, 16) leaf table: the planar rows of ``slots`` in order, then
    padding (valid 0)."""
    rows = np.zeros((n_slots, 16), np.float32)
    pl_cols = np.concatenate(
        [np.asarray(s.pl_n, np.float32),
         np.asarray(s.pl_d, np.float32)[:, None],
         np.asarray(s.pl_g1, np.float32),
         np.asarray(s.pl_g1o, np.float32)[:, None],
         np.asarray(s.pl_g2, np.float32),
         np.asarray(s.pl_g2o, np.float32)[:, None],
         np.asarray(s.pl_is_tri, np.float32)[:, None]], axis=1)
    n = len(slots)
    rows[:n, :13] = pl_cols[slots]
    rows[:n, 13] = 1.0                        # valid
    rows[:n, 14] = slots.astype(np.float32)   # planar slot id
    return rows


def _planar_slots(s: Solids):
    """Valid planar slots (quads, then Q + triangle index) and their f64
    AABBs."""
    Q = np.asarray(s.qd_valid).shape[0]
    qi, q_lo, q_hi, ti, t_lo, t_hi = _planar_aabbs(s)
    return (np.concatenate([qi, Q + ti]).astype(np.int32),
            np.concatenate([q_lo, t_lo], axis=0),
            np.concatenate([q_hi, t_hi], axis=0))


def leaf_tree(s: Solids, prims, leaf_size):
    """(node_min, node_max) f32 boxes of the complete tree whose leaves are
    the rows of the leaf table ``prims`` in order, ``leaf_size`` to a leaf,
    built as the kernel tree's are: what ``walk_counts`` takes for another
    leaf order of the same prims."""
    slots, mins, maxs = _planar_slots(s)
    box_lo = np.zeros((np.asarray(s.pl_n).shape[0], 3))
    box_hi = np.zeros_like(box_lo)
    box_lo[slots], box_hi[slots] = _padded_boxes(mins, maxs)
    prims = np.asarray(prims)
    valid = prims[:, 13] > 0.5
    slot = prims[:, 14].astype(np.int64)
    lo = np.where(valid[:, None], box_lo[slot], np.inf)
    hi = np.where(valid[:, None], box_hi[slot], -np.inf)
    return _conservative(*_level_boxes(lo, hi, prims.shape[0] // leaf_size,
                                       leaf_size))


def build_kernel_bvh(s: Solids, leaf_size=KernelBvh.KLEAF):
    """Planar-only BVH for the hit kernel (see KernelBvh), host numpy.

    One median split, down to leaves of WALK_LEAF prims, orders the
    kernel tree. Its levels above the treelet roots are the JAX package's
    split (same slot ranges, same rule), and its order at the treelet level,
    where the JAX build stops splitting, gives the JAX layout's fields."""
    slots, mins, maxs = _planar_slots(s)
    n = slots.shape[0]
    n_leaves = _n_leaves(n, leaf_size)
    n_slots = n_leaves * leaf_size
    walk_leaves = n_slots // WALK_LEAF
    tr = max(1, n_leaves // (1 << (TOP_LEVELS - 1)))
    order, axes, kept = median_split_order(
        mins, maxs, WALK_LEAF, walk_leaves,
        keep_leaves=tr * leaf_size // WALK_LEAF)

    # the kernel tree: both children's boxes and prim counts in each
    # internal node's row (valid slots come first, so leaf j holds
    # min(WALK_LEAF, n - j*WALK_LEAF) of them)
    mins, maxs = mins[order], maxs[order]
    node_min, node_max = _conservative(*_level_boxes(
        *_slot_boxes(*_padded_boxes(mins, maxs), n_slots), walk_leaves,
        WALK_LEAF))
    count = np.clip(n - np.arange(walk_leaves) * WALK_LEAF, 0, WALK_LEAF)
    node_count = np.zeros(2 * walk_leaves - 1)
    node_count[walk_leaves - 1:] = count
    while count.shape[0] > 1:
        count = count.reshape(-1, 2).sum(1)
        node_count[count.shape[0] - 1:2 * count.shape[0] - 1] = count
    left = 2 * np.arange(walk_leaves - 1) + 1
    nodes = np.zeros((walk_leaves - 1, 16), np.float32)
    for a in range(3):
        nodes[:, 4 * a:4 * a + 4] = np.stack(
            [node_min[left, a], node_min[left + 1, a], node_max[left, a],
             node_max[left + 1, a]], axis=1)
    nodes[:, 12] = node_count[left]
    nodes[:, 13] = node_count[left + 1]

    # the JAX package's two-level TPU layout, kept field for field: its
    # top nodes are the kernel tree's (the same prims under each), split
    # axes only above the treelet roots, leaves in the treelet-level order
    n_troots = n_leaves // tr
    n_top = 2 * n_troots - 1
    top = np.zeros(((n_top + 7) // 8 * 8, 8), np.float32)
    tmin_, tmax_ = _level_boxes(*_slot_boxes(mins, maxs, n_slots),
                                walk_leaves, WALK_LEAF)
    tmin_, tmax_ = tmin_[:n_top], tmax_[:n_top]
    empty = ~(tmin_[:, 0] <= tmax_[:, 0])
    tmin_[empty] = EMPTY_BOX
    tmax_[empty] = EMPTY_BOX
    top[:n_top, 0:3] = tmin_
    top[:n_top, 3:6] = tmax_
    top[:n_troots - 1, 6] = np.maximum(axes[:n_troots - 1], 0)
    p_t = tr * leaf_size
    nbt = max(1, (p_t + 127) // 128)
    blk = np.zeros((n_troots, nbt * 128, 16), np.float32)
    blk[:, :p_t, :] = _prim_rows(s, slots[kept], n_slots).reshape(
        n_troots, p_t, 16)
    blk = blk.reshape(n_troots, nbt, 128, 16).transpose(0, 1, 3, 2)

    return KernelBvh(top_nodes=top,
                     rows=np.ascontiguousarray(
                         blk.reshape(n_troots * nbt * 16, 128)),
                     n_troots=n_troots, tr=tr,
                     n_leaves=n_leaves, leaf_size=leaf_size,
                     has_spheres=bool(np.asarray(s.sph_valid).any()),
                     walk_leaves=walk_leaves,
                     node_min=node_min, node_max=node_max, nodes=nodes,
                     prims=_prim_rows(s, slots[order], n_slots))


def _slab(lo, hi, o, inv):
    """Entry and exit distances of rays (o, inv = 1/d) through boxes
    (R, 3): the kernel's slab test, in its order (fmin/fmax ignore the NaN
    of 0 * inf as fminf/fmaxf do), entry clamped at 0."""
    near = far = None
    for a in range(3):
        t0 = (lo[:, a] - o[a]) * inv[a]
        t1 = (hi[:, a] - o[a]) * inv[a]
        if near is None:
            near, far = torch.fmin(t0, t1), torch.fmax(t0, t1)
        else:
            near = torch.fmax(near, torch.fmin(t0, t1))
            far = torch.fmin(far, torch.fmax(t0, t1))
    return torch.clamp(near, min=0.0), far


def walk_counts(node_min, node_max, prims, leaf_size, o, d, tmin):
    """Plain PyTorch walk of a complete kernel tree, vectorised over rays,
    counting its work. ``node_min`` / ``node_max`` (2L-1, 3) are the boxes
    of a tree over L leaves of ``leaf_size`` rows of the leaf table
    ``prims`` (valid rows first in each leaf).

    The walk is the one ``csrc/bvh.cu`` makes: each internal node's visit
    slab-tests both children; a child is entered when near < far *
    FAR_SCALE and near <= best * BEST_SCALE; of two entered internal
    children the nearer (left on a tie) is visited next and the other
    pushed with its entry; entered leaf children have their prims tested
    at once, nearer first, the second only if its entry still passes; a
    popped entry is skipped once the best t has passed it. Parked rays
    (zero direction) do no work.

    Returns (t (R,) f32, slot (R,) int32: the closest t >= tmin and its
    planar slot, ties to the smallest slot, (INF, -1) on a miss; box tests
    (R,) int32; prim tests (R,) int32; prim rows read: the number of
    distinct valid rows of ``prims`` that some ray tested)."""
    dev = o[0].device
    r = o[0].shape[0]
    n_leaves = (node_min.shape[0] + 1) // 2
    n_int = n_leaves - 1
    valid = prims[:, 13] > 0.5
    count = torch.zeros(n_leaves * leaf_size, dtype=torch.int32, device=dev)
    count[:prims.shape[0]] = valid[:n_leaves * leaf_size].to(torch.int32)
    count = count.view(n_leaves, leaf_size).sum(1)
    inv = tuple(1.0 / c for c in d)
    lo_t = torch.as_tensor(tmin, dtype=torch.float32,
                           device=dev).expand(r)
    best = torch.full((r,), INF, dtype=torch.float32, device=dev)
    best_slot = torch.full((r,), -1, dtype=torch.int32, device=dev)
    boxes = torch.zeros((r,), dtype=torch.int32, device=dev)
    tests = torch.zeros((r,), dtype=torch.int32, device=dev)
    seen = torch.zeros((n_leaves,), dtype=torch.bool, device=dev)
    depth = max(1, int(np.log2(n_leaves)))
    stack = torch.zeros((r, depth), dtype=torch.int64, device=dev)
    stack_near = torch.zeros((r, depth), dtype=torch.float32, device=dev)
    sp = torch.zeros((r,), dtype=torch.int64, device=dev)
    # node to visit per ray: >= 0 an internal node, -1 pop, -2 done
    parked = (d[0] == 0) & (d[1] == 0) & (d[2] == 0)
    node = torch.where(parked, -2, 0 if n_int else -3).to(torch.int64)

    def leaf(ray, lf):
        """Test the prims of leaf ``lf`` (per ray in ``ray``) in order."""
        tests[ray] += count[lf]
        seen[lf] = True
        oo = tuple(c[ray] for c in o)
        dd = tuple(c[ray] for c in d)
        for k in range(leaf_size):
            f = prims[torch.clamp(lf * leaf_size + k, max=prims.shape[0] - 1)]
            on = oo[0] * f[:, 0] + oo[1] * f[:, 1] + oo[2] * f[:, 2]
            dn = dd[0] * f[:, 0] + dd[1] * f[:, 1] + dd[2] * f[:, 2]
            og1 = oo[0] * f[:, 4] + oo[1] * f[:, 5] + oo[2] * f[:, 6]
            dg1 = dd[0] * f[:, 4] + dd[1] * f[:, 5] + dd[2] * f[:, 6]
            og2 = oo[0] * f[:, 8] + oo[1] * f[:, 9] + oo[2] * f[:, 10]
            dg2 = dd[0] * f[:, 8] + dd[1] * f[:, 9] + dd[2] * f[:, 10]
            t = (f[:, 3] - on) / dn
            u = og1 + t * dg1 + f[:, 7]
            v = og2 + t * dg2 + f[:, 11]
            contain = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & torch.where(
                f[:, 12] > 0.5, u + v <= 1.0, v <= 1.0)
            slot = f[:, 14].to(torch.int32)
            b, bs = best[ray], best_slot[ray]
            take = ((k < count[lf]) & (torch.abs(dn) >= ALMOST_ZERO) & contain
                    & (t >= lo_t[ray])
                    & ((t < b) | ((t == b) & (slot < bs))))
            best[ray] = torch.where(take, t, b)
            best_slot[ray] = torch.where(take, slot, bs)

    if not n_int:   # a one-leaf tree: its leaf, unless parked
        live = torch.nonzero(node == -3).squeeze(1)
        leaf(live, torch.zeros_like(live))
        node[live] = -2
    while True:
        ray = torch.nonzero(node >= 0).squeeze(1)
        if ray.numel() == 0:
            break
        c = node[ray]
        left = 2 * c + 1
        oo = tuple(x[ray] for x in o)
        ii = tuple(x[ray] for x in inv)
        n_l, f_l = _slab(node_min[left], node_max[left], oo, ii)
        n_r, f_r = _slab(node_min[left + 1], node_max[left + 1], oo, ii)
        boxes[ray] += 2
        lim = best[ray] * BEST_SCALE
        h_l = (n_l < f_l * FAR_SCALE) & (n_l <= lim)
        h_r = (n_r < f_r * FAR_SCALE) & (n_r <= lim)
        r_first = h_r & (~h_l | (n_r < n_l))
        first = torch.where(r_first, left + 1, left)
        second = torch.where(r_first, left, left + 1)
        near2 = torch.where(r_first, n_l, n_r)
        kids_leaves = left >= n_int
        go = kids_leaves & (h_l | h_r)
        leaf(ray[go], first[go] - n_int)
        go = kids_leaves & h_l & h_r
        go &= near2 <= best[ray] * BEST_SCALE
        leaf(ray[go], second[go] - n_int)
        both = ~kids_leaves & h_l & h_r
        pb = ray[both]
        stack[pb, sp[pb]] = second[both]
        stack_near[pb, sp[pb]] = near2[both]
        sp[pb] += 1
        node[ray] = torch.where(~kids_leaves & (h_l | h_r), first,
                                torch.full_like(first, -1))
        while True:   # pop until an entry the best t has not passed
            pr = torch.nonzero(node == -1).squeeze(1)
            if pr.numel() == 0:
                break
            empty = sp[pr] == 0
            node[pr[empty]] = -2
            pr = pr[~empty]
            sp[pr] -= 1
            ok = stack_near[pr, sp[pr]] <= best[pr] * BEST_SCALE
            node[pr[ok]] = stack[pr[ok], sp[pr[ok]]]
    return best, best_slot, boxes, tests, int(count[seen].sum())
