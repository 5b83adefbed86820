"""Geometry constants (a frozen copy of ``solstrale_tpu_torch``'s
``geo``). The ray-time vector math lives in ``geo/soa.py`` (torch
tensors). Semantics mirror the upstream library's ``geo/mod.rs`` and
``geo/vec3.rs``.
"""
from __future__ import annotations

import math

# Matches the upstream ALMOST_ZERO (vec3.rs:21): parallel-ray epsilon in
# quad/triangle intersection, compared against |denominators| of O(scene
# scale), so it stays 1e-8 in f32.
ALMOST_ZERO = 1e-8

# Global ray interval (interval.rs:25-28): t-min epsilon against
# self-intersection, t-max unbounded.
RAY_T_MIN = 1e-3
INF = math.inf
