"""Geometry constants, ``ray_shortest_distance`` and host-side (numpy,
f64) construction helpers.

The ray-time vector math lives in ``geo/soa.py`` (torch tensors); this
module keeps what the scene baking needs. Semantics mirror the reference's
``geo/mod.rs`` and ``geo/vec3.rs``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# Matches reference ALMOST_ZERO (vec3.rs:21): parallel-ray epsilon in
# quad/triangle intersection, compared against |denominators| of O(scene
# scale), so it stays 1e-8 in f32.
ALMOST_ZERO = 1e-8

# Global ray interval (interval.rs:25-28): t-min epsilon against
# self-intersection, t-max unbounded.
RAY_T_MIN = 1e-3
INF = math.inf


def ray_shortest_distance(o1, d1, o2, d2):
    """Shortest distance between two rays (geo/mod.rs:292-304), batched:
    (..., 3) tensors -> (...), on the tensors' device. Exactly parallel
    rays (a cross product of exactly zero) take |d1 x (o1 - o2)| / |d1|.
    The cross products are separate multiplies and subtracts, never fused,
    so d1 and k * d1 give exactly zero on every device."""
    def cross(a, b):
        ax, ay, az = a.unbind(-1)
        bx, by, bz = b.unbind(-1)
        return torch.stack((ay * bz - az * by, az * bx - ax * bz,
                            ax * by - ay * bx), -1)

    def length(v):
        return (v * v).sum(-1).sqrt()

    n = cross(d1, d2)
    od = o1 - o2
    n_len = length(n)
    parallel = n_len == 0.0
    dist_parallel = length(cross(d1, od)) / length(d1)
    dist_skew = (od * n).sum(-1) / torch.where(parallel, 1.0, n_len)
    return torch.where(parallel, dist_parallel, dist_skew).abs()


# --- host-side (numpy, f64) construction helpers -------------------------
# Scene baking happens on the host in float64 to mirror the reference's f64
# construction math before casting the compiled tables to f32.

def np_unit(v):
    return v / np.linalg.norm(v)


def np_cross(a, b):
    return np.cross(a, b)


def aabb_from_points(*points):
    """AABB of a point set (geo/mod.rs:88-121). Host-side, f64."""
    pts = np.stack([np.asarray(p, np.float64) for p in points])
    return pts.min(axis=0), pts.max(axis=0)


PAD_DELTA = 1e-4


def pad_aabb_if_needed(lo, hi):
    """Pad degenerate AABB axes (geo/mod.rs:134-156)."""
    lo, hi = np.array(lo, np.float64), np.array(hi, np.float64)
    for ax in range(3):
        if hi[ax] - lo[ax] < PAD_DELTA:
            lo[ax] -= PAD_DELTA / 2
            hi[ax] += PAD_DELTA / 2
    return lo, hi
