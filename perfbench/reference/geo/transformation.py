"""Construction-time geometry transformations.

Mirrors the reference API (the reference's ``src/geo/transformation.rs:8-206``):
transforms are applied while *baking* primitives on the host (quads/triangles
store transformed vertices; nothing is transformed at trace time). Host-side
numpy f64, matching the reference's f64 math.
"""
from __future__ import annotations

import math

import numpy as np


class Transformer:
    """Base transformation; ``skip_translation`` is set for direction vectors
    (transformation.rs:8-11)."""

    def transform(self, vec, skip_translation=False):
        raise NotImplementedError


class NopTransformer(Transformer):
    """Identity transform (transformation.rs:21-27)."""

    def transform(self, vec, skip_translation=False):
        return np.asarray(vec, np.float64)


class Transformations(Transformer):
    """Ordered composite of transformations (transformation.rs:40-53)."""

    def __init__(self, transformations):
        self.transformations = list(transformations)

    def transform(self, vec, skip_translation=False):
        v = np.asarray(vec, np.float64)
        for t in self.transformations:
            v = t.transform(v, skip_translation)
        return v


class Translation(Transformer):
    """Translate by a fixed offset; skipped for directions
    (transformation.rs:66-85)."""

    def __init__(self, translation):
        self.translation = np.asarray(translation, np.float64)

    def transform(self, vec, skip_translation=False):
        v = np.asarray(vec, np.float64)
        return v if skip_translation else v + self.translation


class _Rotation(Transformer):
    def __init__(self, angle_degrees):
        radians = math.radians(angle_degrees)
        self.sin_theta = math.sin(radians)
        self.cos_theta = math.cos(radians)


class RotationX(_Rotation):
    """Rotate about the global x-axis (transformation.rs:95-118)."""

    def transform(self, vec, skip_translation=False):
        x, y, z = np.asarray(vec, np.float64)
        return np.array([
            x,
            self.cos_theta * y + self.sin_theta * z,
            -self.sin_theta * y + self.cos_theta * z,
        ])


class RotationY(_Rotation):
    """Rotate about the global y-axis (transformation.rs:121-152)."""

    def transform(self, vec, skip_translation=False):
        x, y, z = np.asarray(vec, np.float64)
        return np.array([
            self.cos_theta * x + self.sin_theta * z,
            y,
            -self.sin_theta * x + self.cos_theta * z,
        ])


class RotationZ(_Rotation):
    """Rotate about the global z-axis (transformation.rs:155-187)."""

    def transform(self, vec, skip_translation=False):
        x, y, z = np.asarray(vec, np.float64)
        return np.array([
            self.cos_theta * x + self.sin_theta * y,
            -self.sin_theta * x + self.cos_theta * y,
            z,
        ])


class Scale(Transformer):
    """Uniform scale (transformation.rs:197-206)."""

    def __init__(self, scale):
        self.scale = float(scale)

    def transform(self, vec, skip_translation=False):
        return np.asarray(vec, np.float64) * self.scale
