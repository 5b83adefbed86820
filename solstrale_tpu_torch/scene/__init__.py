"""Scene description API (host side).

Mirrors the reference's construction surface (the reference's ``src/hittable/``)
— spheres, quads (+boxes), triangles, constant media, grouping — with all
transforms baked at construction time exactly like the reference
(quad.rs:41-43, triangle.rs:63-65). As in the JAX package, these
descriptors are *not* the runtime representation. ``compile.compile_scene``
flattens the world into typed SoA device tables; grouping nodes (``Bvh``)
are acceleration *hints* — global acceleration is rebuilt as a flattened
LBVH over the whole primitive soup.
"""
from __future__ import annotations

import numpy as np

from ..geo.transformation import NopTransformer, Transformer
from .materials import (BLEND, DIELECTRIC, DIFFUSE_LIGHT, ISOTROPIC,
                        LAMBERTIAN, METAL, Blend, Dielectric, DiffuseLight,
                        Isotropic, Lambertian, Material, Metal)
from .textures import ImageMap, SolidColor, Texture, load_normal_texture

__all__ = [
    "Sphere", "Quad", "Triangle", "ConstantMedium", "Bvh", "new_box",
    "Scene", "CameraConfig",
    "Lambertian", "Metal", "Dielectric", "DiffuseLight", "Isotropic", "Blend",
    "SolidColor", "ImageMap", "load_normal_texture",
]

_NOP = NopTransformer()


class Hittable:
    pass


class Sphere(Hittable):
    """Sphere primitive (sphere.rs:23-37)."""

    def __init__(self, center, radius, material: Material):
        self.center = np.asarray(center, np.float64)
        self.radius = float(radius)
        self.material = material


class Quad(Hittable):
    """Planar parallelogram; transform baked, plane data precomputed
    (quad.rs:31-66)."""

    def __init__(self, q, u, v, material: Material,
                 transformation: Transformer = _NOP):
        self.q = transformation.transform(np.asarray(q, np.float64), False)
        self.u = transformation.transform(np.asarray(u, np.float64), True)
        self.v = transformation.transform(np.asarray(v, np.float64), True)
        n = np.cross(self.u, self.v)
        n_len = np.linalg.norm(n)
        self.normal = n / n_len if n_len > 0 else np.array([0.0, 0.0, 1.0])
        self.d = float(np.dot(self.normal, self.q))
        self.w = n / np.dot(n, n) if n_len > 0 else np.zeros(3)
        self.area = float(n_len)
        self.material = material


def new_box(a, b, material: Material, transformation: Transformer = _NOP):
    """Six quads forming an axis-aligned box, transformed per-quad
    (quad.rs:69-128)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mn, mx = np.minimum(a, b), np.maximum(a, b)
    dx = np.array([mx[0] - mn[0], 0.0, 0.0])
    dy = np.array([0.0, mx[1] - mn[1], 0.0])
    dz = np.array([0.0, 0.0, mx[2] - mn[2]])
    return [
        Quad([mn[0], mn[1], mx[2]], dx, dy, material, transformation),
        Quad([mx[0], mn[1], mx[2]], -dz, dy, material, transformation),
        Quad([mx[0], mn[1], mn[2]], -dx, dy, material, transformation),
        Quad([mn[0], mn[1], mn[2]], dz, dy, material, transformation),
        Quad([mn[0], mx[1], mx[2]], dx, -dz, material, transformation),
        Quad([mn[0], mn[1], mn[2]], dx, dz, material, transformation),
    ]


# Attach as a constructor-style alias to mirror `Quad::new_box`.
Quad.new_box = staticmethod(new_box)


class Triangle(Hittable):
    """Triangle with per-vertex UVs; tangent frame precomputed from UV deltas
    for bump mapping (triangle.rs:29-96). Counterclockwise winding."""

    def __init__(self, v0, v1, v2, material: Material,
                 transformation: Transformer = _NOP,
                 uv0=(0.0, 0.0), uv1=(0.0, 0.0), uv2=(0.0, 0.0)):
        v0 = transformation.transform(np.asarray(v0, np.float64), False)
        v1 = transformation.transform(np.asarray(v1, np.float64), False)
        v2 = transformation.transform(np.asarray(v2, np.float64), False)
        self.v0 = v0
        self.e1 = v1 - v0
        self.e2 = v2 - v0
        self.uv0 = np.asarray(uv0, np.float64)
        self.uv1 = np.asarray(uv1, np.float64)
        self.uv2 = np.asarray(uv2, np.float64)
        n = np.cross(self.e1, self.e2)
        n_len = np.linalg.norm(n)
        self.normal = n / n_len if n_len > 0 else np.array([0.0, 0.0, 1.0])
        self.area = n_len / 2.0

        duv1 = self.uv1 - self.uv0
        duv2 = self.uv2 - self.uv0
        denom = duv1[0] * duv2[1] - duv1[1] * duv2[0]
        if abs(denom) > 1e-20:
            r = 1.0 / denom
            t = (self.e1 * duv2[1] - self.e2 * duv1[1]) * r
            b = (self.e2 * duv1[0] - self.e1 * duv2[0]) * r
            tl, bl = np.linalg.norm(t), np.linalg.norm(b)
            self.tangent = t / tl if tl > 0 else _safe_tangent(self.e1)
            self.bi_tangent = b / bl if bl > 0 else _safe_tangent(self.e2)
        else:
            # Degenerate UVs (e.g. no tex coords): the reference computes NaN
            # tangents here; they are only ever consumed by normal mapping,
            # which requires real UVs, so substitute a finite frame.
            self.tangent = _safe_tangent(self.e1)
            self.bi_tangent = _safe_tangent(self.e2)
        self.material = material

    @staticmethod
    def new_with_tex_coords(v0, v1, v2, uv0, uv1, uv2, material,
                            transformation: Transformer = _NOP):
        return Triangle(v0, v1, v2, material, transformation, uv0, uv1, uv2)


def _safe_tangent(v):
    n = np.linalg.norm(v)
    return v / n if n > 0 else np.array([1.0, 0.0, 0.0])


class TriangleMesh(Hittable):
    """Array-backed triangle soup sharing one material — the scalable ingest
    path for large OBJ meshes. Per-face quantities are precomputed
    vectorized (numpy), matching Triangle's semantics exactly
    (triangle.rs:53-96) without per-face Python objects.
    """

    def __init__(self, verts, material: Material, uvs=None,
                 transformation: Transformer = _NOP):
        verts = np.asarray(verts, np.float64)  # (N, 3, 3)
        if not isinstance(transformation, NopTransformer):
            flat = verts.reshape(-1, 3)
            flat = np.stack([transformation.transform(v, False) for v in flat])
            verts = flat.reshape(verts.shape)
        n = verts.shape[0]
        self.uvs = (np.zeros((n, 3, 2)) if uvs is None
                    else np.asarray(uvs, np.float64))
        self.v0 = verts[:, 0]
        self.e1 = verts[:, 1] - verts[:, 0]
        self.e2 = verts[:, 2] - verts[:, 0]
        nvec = np.cross(self.e1, self.e2)
        nlen = np.linalg.norm(nvec, axis=-1)
        safe = np.maximum(nlen, 1e-30)[:, None]
        self.normal = np.where(nlen[:, None] > 0, nvec / safe,
                               [[0.0, 0.0, 1.0]])
        self.area = nlen / 2.0

        duv1 = self.uvs[:, 1] - self.uvs[:, 0]
        duv2 = self.uvs[:, 2] - self.uvs[:, 0]
        denom = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
        ok = np.abs(denom) > 1e-20
        r = 1.0 / np.where(ok, denom, 1.0)
        t = (self.e1 * duv2[:, 1:2] - self.e2 * duv1[:, 1:2]) * r[:, None]
        b = (self.e2 * duv1[:, 0:1] - self.e1 * duv2[:, 0:1]) * r[:, None]

        def norm_rows(x, fallback):
            ln = np.linalg.norm(x, axis=-1)
            good = ln > 0
            out = np.where(good[:, None], x / np.maximum(ln, 1e-30)[:, None],
                           fallback)
            return out

        e1n = norm_rows(self.e1, [[1.0, 0.0, 0.0]])
        e2n = norm_rows(self.e2, [[0.0, 1.0, 0.0]])
        self.tangent = np.where(ok[:, None], norm_rows(t, [[1.0, 0.0, 0.0]]),
                                e1n)
        self.bi_tangent = np.where(ok[:, None],
                                   norm_rows(b, [[0.0, 1.0, 0.0]]), e2n)
        self.material = material

    def __len__(self):
        return self.v0.shape[0]


class ConstantMedium(Hittable):
    """Homogeneous participating medium bounded by arbitrary geometry;
    exponential free-flight sampling (constant_medium.rs:22-79)."""

    def __init__(self, boundary, density, color):
        self.boundary = boundary
        self.neg_inv_density = -1.0 / float(density)
        self.phase_material = Isotropic(SolidColor.new_from_vec3(color))


class Bvh(Hittable):
    """Grouping node. In the reference this is the binary acceleration tree
    (bvh.rs); here it is a pure grouping hint — acceleration is rebuilt
    globally as a flattened LBVH at compile time."""

    def __init__(self, children):
        self.children = list(children)


class CameraConfig:
    """Thin-lens camera parameters (camera.rs:8-31)."""

    def __init__(self, vertical_fov_degrees=50.0, aperture_size=0.0,
                 look_from=(0.0, 0.0, 0.0), look_at=(0.0, 0.0, 0.0),
                 up=(0.0, 1.0, 0.0)):
        self.vertical_fov_degrees = float(vertical_fov_degrees)
        self.aperture_size = float(aperture_size)
        self.look_from = np.asarray(look_from, np.float64)
        self.look_at = np.asarray(look_at, np.float64)
        self.up = np.asarray(up, np.float64)


class Scene:
    """World + camera + background + render config (renderer/mod.rs:63-72)."""

    def __init__(self, world, camera: CameraConfig, background_color,
                 render_config):
        self.world = world
        self.camera = camera
        self.background_color = np.asarray(background_color, np.float64)
        self.render_config = render_config
