"""Scene -> device table compiler.

The scene graph flattens into typed primitive tables (spheres / quads /
triangles), a material parameter table, a packed texture arena, a unified
light table and per-medium boundary sub-tables — the same field names and
column layouts as the JAX package's ``scene/compile.py``. All baking math
is float64 on the host (matching the reference's f64 construction, e.g.
quad.rs:41-65), then every table is cast to f32/int32 and moved to the
target device in one pass.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, fields
from functools import cached_property

import numpy as np
import torch

from . import (Bvh, ConstantMedium, Hittable, Quad, Scene, Sphere, Triangle,
               TriangleMesh)
from .materials import (BLEND, DIELECTRIC, DIFFUSE_LIGHT, ISOTROPIC,
                        LAMBERTIAN, METAL, Blend, Dielectric, DiffuseLight,
                        Isotropic, Lambertian, Metal)
from .textures import ImageMap, SolidColor

KIND_SPHERE = 0
KIND_QUAD = 1
KIND_TRIANGLE = 2
KIND_MEDIUM = 3  # pseudo-kind for volume scattering events


@dataclass(frozen=True)
class Solids:
    """Typed solid-primitive tables. Padded rows are masked via *_valid.
    Column layouts match the JAX package (``pl_attr`` columns: unit_normal
    0:3, g1 3:6, g1o 6, g2 7:10, g2o 10, tangent 11:14, bitangent 14:17,
    uv0 17:19, duv1 19:21, duv2 21:23, mat 23, is_tri 24; ``sph_attr``:
    center 0:3, radius 3, mat 4)."""

    sph_center: torch.Tensor   # (S, 3)
    sph_radius: torch.Tensor   # (S,)
    sph_mat: torch.Tensor      # (S,) int32
    sph_valid: torch.Tensor    # (S,) bool
    qd_q: torch.Tensor         # (Q, 3)
    qd_u: torch.Tensor
    qd_v: torch.Tensor
    qd_normal: torch.Tensor
    qd_d: torch.Tensor         # (Q,)
    qd_w: torch.Tensor         # (Q, 3)
    qd_area: torch.Tensor      # (Q,)
    qd_mat: torch.Tensor
    qd_valid: torch.Tensor
    tr_v0: torch.Tensor        # (T, 3)
    tr_e1: torch.Tensor
    tr_e2: torch.Tensor
    tr_uv0: torch.Tensor       # (T, 2)
    tr_uv1: torch.Tensor
    tr_uv2: torch.Tensor
    tr_normal: torch.Tensor
    tr_tangent: torch.Tensor
    tr_bitangent: torch.Tensor
    tr_area: torch.Tensor      # (T,)
    tr_mat: torch.Tensor
    tr_valid: torch.Tensor
    # unified planar table (quads then triangles)
    pl_n: torch.Tensor         # (Pp, 3) unit normal for quads, raw e1xe2 for tris
    pl_d: torch.Tensor         # (Pp,) plane offset n·p0
    pl_g1: torch.Tensor        # (Pp, 3) first barycentric functional
    pl_g1o: torch.Tensor       # (Pp,)
    pl_g2: torch.Tensor        # (Pp, 3)
    pl_g2o: torch.Tensor       # (Pp,)
    pl_is_tri: torch.Tensor    # (Pp,) bool — containment rule selector
    pl_idx: torch.Tensor       # (Pp,) int32 index into the typed table
    pl_valid: torch.Tensor     # (Pp,) bool
    sph_attr: torch.Tensor     # (S, 5)
    pl_attr: torch.Tensor      # (Pp, 25)

    @cached_property
    def sph_table(self):
        """(S, 8) f32 sweep-kernel sphere table: cx cy cz radius valid 0 0 0
        (the JAX package's ``pallas_sweep._pack_tables`` layout)."""
        s = self.sph_center
        return torch.cat([
            s, self.sph_radius[:, None],
            self.sph_valid.to(torch.float32)[:, None],
            torch.zeros((s.shape[0], 3), dtype=torch.float32,
                        device=s.device)], dim=1).contiguous()

    @cached_property
    def pl_table(self):
        """(P, 16) f32 sweep-kernel planar table: n.xyz d g1.xyz g1o
        g2.xyz g2o is_tri valid 0 0."""
        n = self.pl_n
        return torch.cat([
            n, self.pl_d[:, None], self.pl_g1, self.pl_g1o[:, None],
            self.pl_g2, self.pl_g2o[:, None],
            self.pl_is_tri.to(torch.float32)[:, None],
            self.pl_valid.to(torch.float32)[:, None],
            torch.zeros((n.shape[0], 2), dtype=torch.float32,
                        device=n.device)], dim=1).contiguous()


@dataclass(frozen=True)
class Medium:
    """One constant medium: boundary geometry + phase parameters
    (constant_medium.rs:16-31)."""

    boundary: Solids
    neg_inv_density: torch.Tensor  # () f32
    mat: torch.Tensor              # () int32 — isotropic phase material


@dataclass(frozen=True)
class Lights:
    """Unified light table for NEE (pdf.rs:88-102). p0/p1/p2 mean (center,
    -, -) for spheres, (q, u, v) for quads, (v0, e1, e2) for triangles."""

    kind: torch.Tensor     # (L,) int32
    p0: torch.Tensor       # (L, 3)
    p1: torch.Tensor       # (L, 3)
    p2: torch.Tensor       # (L, 3)
    radius: torch.Tensor   # (L,)
    normal: torch.Tensor   # (L, 3)
    d: torch.Tensor        # (L,)
    w: torch.Tensor        # (L, 3)
    area: torch.Tensor     # (L,)
    attr: torch.Tensor     # (L, 11) kind p0 p1 p2 radius


@dataclass(frozen=True)
class Materials:
    kind: torch.Tensor          # (M,) int32
    albedo_tex: torch.Tensor    # (M,) int32
    normal_tex: torch.Tensor    # (M,) int32, -1 = none
    fuzz: torch.Tensor          # (M,)
    ior: torch.Tensor           # (M,)
    atten: torch.Tensor         # (M,) attenuation factor, 0 = none
    blend_factor: torch.Tensor  # (M,)
    blend_m1: torch.Tensor      # (M,) int32
    blend_m2: torch.Tensor      # (M,) int32
    # kind(0) albedo_tex(1) normal_tex(2) fuzz(3) ior(4) atten(5)
    # blend_factor(6) m1(7) m2(8)
    attr: torch.Tensor          # (M, 9)


@dataclass(frozen=True)
class TexArena:
    pixels: torch.Tensor   # (N, 3) f32 — the differentiable parameter bank
    offset: torch.Tensor   # (Tt,) int32
    w: torch.Tensor        # (Tt,) int32
    h: torch.Tensor        # (Tt,) int32
    attr: torch.Tensor     # (Tt, 3) offset w h (as f32)


@dataclass(frozen=True)
class CameraSoA:
    origin: torch.Tensor       # (3,)
    lower_left: torch.Tensor
    horizontal: torch.Tensor
    vertical: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    lens_radius: torch.Tensor  # ()


@dataclass(frozen=True)
class CompiledScene:
    solids: Solids
    media: tuple            # tuple[Medium, ...]
    lights: Lights
    materials: Materials
    textures: TexArena
    bg_color: torch.Tensor  # (3,)
    camera: CameraSoA
    bvh: object = None      # accel.Bvh when the scene is large enough
    kbvh: object = None     # accel.KernelBvh (BVH kernel layout)
    # static feature flags ({"blend", "normal_maps", "spheres", "metal",
    # "dielectric", ...}): the integrator skips whole code paths for scenes
    # that cannot exercise them, with bit-identical results
    features: frozenset = field(default_factory=frozenset)
    # per-light kind tags (KIND_SPHERE/QUAD/TRIANGLE): the NEE light loop
    # runs only each light's own shape branch
    light_kinds: tuple = ()

    @property
    def device(self):
        return self.bg_color.device


class SceneError(ValueError):
    pass


def _walk(node, out, in_medium):
    if isinstance(node, (list, tuple)):
        for c in node:
            _walk(c, out, in_medium)
    elif isinstance(node, Bvh):
        _walk(node.children, out, in_medium)
    elif isinstance(node, ConstantMedium):
        if in_medium:
            raise SceneError("nested constant media are not supported")
        sub = {"spheres": [], "quads": [], "triangles": [], "meshes": [],
               "media": None}
        _walk(node.boundary, sub, True)
        out["media"].append((node, sub))
    elif isinstance(node, Sphere):
        out["spheres"].append(node)
    elif isinstance(node, Quad):
        out["quads"].append(node)
    elif isinstance(node, Triangle):
        out["triangles"].append(node)
    elif isinstance(node, TriangleMesh):
        out["meshes"].append(node)
    elif isinstance(node, Hittable):
        raise SceneError(f"unsupported hittable: {type(node).__name__}")
    else:
        raise SceneError(f"not a hittable: {type(node).__name__}")


class _TexArenaBuilder:
    def __init__(self):
        self.pixels = []
        self.offset = []
        self.w = []
        self.h = []
        self._by_id = {}
        self._n = 0

    def add(self, tex):
        if tex is None:
            return -1
        key = id(tex)
        if key in self._by_id:
            return self._by_id[key]
        if isinstance(tex, SolidColor):
            img = np.asarray(tex.rgb, np.float64).reshape(1, 1, 3)
        elif isinstance(tex, ImageMap):
            # u8 -> [0, 1] like the reference rgb_to_vec3 (rgb_color.rs:37-43)
            img = tex.image.astype(np.float64) / 255.0
        else:
            raise SceneError(f"unsupported texture: {type(tex).__name__}")
        h, w = img.shape[:2]
        tid = len(self.offset)
        self.offset.append(self._n)
        self.w.append(w)
        self.h.append(h)
        self.pixels.append(img.reshape(-1, 3))
        self._n += h * w
        self._by_id[key] = tid
        return tid

    def build(self):
        if not self.pixels:
            self.add(SolidColor(1.0, 1.0, 1.0))
        return TexArena(
            pixels=np.concatenate(self.pixels, 0).astype(np.float32),
            offset=np.asarray(self.offset, np.int32),
            w=np.asarray(self.w, np.int32),
            h=np.asarray(self.h, np.int32),
            attr=np.stack([self.offset, self.w, self.h], 1).astype(
                np.float32),
        )


class _MatTableBuilder:
    def __init__(self, arena):
        self.arena = arena
        self.rows = []
        self._by_id = {}

    def add(self, mat):
        key = id(mat)
        if key in self._by_id:
            return self._by_id[key]
        row = dict(kind=LAMBERTIAN, albedo_tex=-1, normal_tex=-1, fuzz=0.0,
                   ior=1.0, atten=0.0, blend_factor=0.0, blend_m1=-1,
                   blend_m2=-1)
        mi = len(self.rows)
        self.rows.append(row)  # reserve slot before recursing (blend children)
        self._by_id[key] = mi
        if isinstance(mat, Lambertian):
            row.update(kind=LAMBERTIAN, albedo_tex=self.arena.add(mat.albedo),
                       normal_tex=self.arena.add(mat.normal))
        elif isinstance(mat, Metal):
            row.update(kind=METAL, albedo_tex=self.arena.add(mat.albedo),
                       normal_tex=self.arena.add(mat.normal), fuzz=mat.fuzz)
        elif isinstance(mat, Dielectric):
            row.update(kind=DIELECTRIC, albedo_tex=self.arena.add(mat.albedo),
                       normal_tex=self.arena.add(mat.normal),
                       ior=mat.index_of_refraction)
        elif isinstance(mat, DiffuseLight):
            row.update(kind=DIFFUSE_LIGHT, albedo_tex=self.arena.add(mat.tex),
                       atten=mat.attenuation_factor)
        elif isinstance(mat, Isotropic):
            row.update(kind=ISOTROPIC, albedo_tex=self.arena.add(mat.tex))
        elif isinstance(mat, Blend):
            row.update(kind=BLEND, blend_factor=mat.blend_factor,
                       blend_m1=self.add(mat.material_1),
                       blend_m2=self.add(mat.material_2))
        else:
            raise SceneError(f"unsupported material: {type(mat).__name__}")
        return mi

    def build(self):
        rows = self.rows or [dict(kind=LAMBERTIAN,
                                  albedo_tex=self.arena.add(SolidColor(1, 1, 1)),
                                  normal_tex=-1, fuzz=0.0, ior=1.0, atten=0.0,
                                  blend_factor=0.0, blend_m1=-1, blend_m2=-1)]

        def col(name, dtype):
            return np.array([r[name] for r in rows], dtype)

        attr = np.array(
            [[r["kind"], r["albedo_tex"], r["normal_tex"], r["fuzz"],
              r["ior"], r["atten"], r["blend_factor"], r["blend_m1"],
              r["blend_m2"]] for r in rows], np.float32)
        return Materials(
            kind=col("kind", np.int32),
            albedo_tex=col("albedo_tex", np.int32),
            normal_tex=col("normal_tex", np.int32),
            fuzz=col("fuzz", np.float32), ior=col("ior", np.float32),
            atten=col("atten", np.float32),
            blend_factor=col("blend_factor", np.float32),
            blend_m1=col("blend_m1", np.int32),
            blend_m2=col("blend_m2", np.int32),
            attr=attr,
        )


def _build_solids(spheres, quads, tris, mats, meshes=()):
    f32, i32 = np.float32, np.int32
    S = max(len(spheres), 1)
    sph_center = np.zeros((S, 3)); sph_radius = np.ones(S)
    sph_mat = np.zeros(S, i32); sph_valid = np.zeros(S, bool)
    for i, s in enumerate(spheres):
        sph_center[i], sph_radius[i] = s.center, s.radius
        sph_mat[i] = mats.add(s.material)
        sph_valid[i] = True

    Q = max(len(quads), 1)
    qd_q = np.zeros((Q, 3)); qd_u = np.zeros((Q, 3)); qd_v = np.zeros((Q, 3))
    qd_normal = np.tile(np.array([0.0, 0.0, 1.0]), (Q, 1))
    qd_d = np.zeros(Q); qd_w = np.zeros((Q, 3)); qd_area = np.ones(Q)
    qd_mat = np.zeros(Q, i32); qd_valid = np.zeros(Q, bool)
    for i, q in enumerate(quads):
        qd_q[i], qd_u[i], qd_v[i] = q.q, q.u, q.v
        qd_normal[i], qd_d[i], qd_w[i], qd_area[i] = q.normal, q.d, q.w, q.area
        qd_mat[i] = mats.add(q.material)
        qd_valid[i] = True

    n_mesh_tris = sum(len(m) for m in meshes)
    T = max(len(tris) + n_mesh_tris, 1)
    tr_v0 = np.zeros((T, 3)); tr_e1 = np.zeros((T, 3)); tr_e2 = np.zeros((T, 3))
    tr_uv0 = np.zeros((T, 2)); tr_uv1 = np.zeros((T, 2)); tr_uv2 = np.zeros((T, 2))
    tr_normal = np.tile(np.array([0.0, 0.0, 1.0]), (T, 1))
    tr_tangent = np.tile(np.array([1.0, 0.0, 0.0]), (T, 1))
    tr_bitangent = np.tile(np.array([0.0, 1.0, 0.0]), (T, 1))
    tr_area = np.ones(T)
    tr_mat = np.zeros(T, i32); tr_valid = np.zeros(T, bool)
    for i, t in enumerate(tris):
        tr_v0[i], tr_e1[i], tr_e2[i] = t.v0, t.e1, t.e2
        tr_uv0[i], tr_uv1[i], tr_uv2[i] = t.uv0, t.uv1, t.uv2
        tr_normal[i], tr_tangent[i], tr_bitangent[i] = t.normal, t.tangent, t.bi_tangent
        tr_area[i] = t.area
        tr_mat[i] = mats.add(t.material)
        tr_valid[i] = True
    off = len(tris)
    for m in meshes:  # vectorized block copy per mesh
        k = len(m)
        sl = slice(off, off + k)
        tr_v0[sl], tr_e1[sl], tr_e2[sl] = m.v0, m.e1, m.e2
        tr_uv0[sl], tr_uv1[sl], tr_uv2[sl] = (m.uvs[:, 0], m.uvs[:, 1],
                                              m.uvs[:, 2])
        tr_normal[sl], tr_tangent[sl] = m.normal, m.tangent
        tr_bitangent[sl] = m.bi_tangent
        tr_area[sl] = m.area
        tr_mat[sl] = mats.add(m.material)
        tr_valid[sl] = True
        off += k

    # --- unified planar functional table (quads then tris), host f64 ---
    Pp = Q + T
    pl_n = np.zeros((Pp, 3)); pl_n[:, 2] = 1.0
    pl_d = np.zeros(Pp)
    pl_g1 = np.zeros((Pp, 3)); pl_g1o = np.zeros(Pp)
    pl_g2 = np.zeros((Pp, 3)); pl_g2o = np.zeros(Pp)
    pl_is_tri = np.zeros(Pp, bool)
    pl_idx = np.zeros(Pp, i32)
    pl_valid = np.zeros(Pp, bool)

    # quads: UNIT normal in the eps test (quad.rs:151-155)
    nq_raw = np.cross(qd_u, qd_v)
    nn_q = np.einsum("ij,ij->i", nq_raw, nq_raw)
    ok_q = qd_valid & (nn_q > 0)
    nn_qs = np.where(nn_q > 0, nn_q, 1.0)[:, None]
    g1_q = np.cross(qd_v, nq_raw) / nn_qs       # u = (hp-q)·(v×n)/|n|²
    g2_q = np.cross(nq_raw, qd_u) / nn_qs       # v = (hp-q)·(n×u)/|n|²
    pl_n[:Q] = np.where(ok_q[:, None], qd_normal, pl_n[:Q])
    pl_d[:Q] = np.where(ok_q, qd_d, 0.0)
    pl_g1[:Q] = np.where(ok_q[:, None], g1_q, 0.0)
    pl_g1o[:Q] = np.where(ok_q, -np.einsum("ij,ij->i", qd_q, g1_q), 0.0)
    pl_g2[:Q] = np.where(ok_q[:, None], g2_q, 0.0)
    pl_g2o[:Q] = np.where(ok_q, -np.einsum("ij,ij->i", qd_q, g2_q), 0.0)
    pl_idx[:Q] = np.where(ok_q, np.arange(Q, dtype=i32), 0)
    pl_valid[:Q] = ok_q

    # tris: RAW normal — |d·(e1×e2)| == Möller's |det| (triangle.rs:119-125)
    nt_raw = np.cross(tr_e1, tr_e2)
    nn_t = np.einsum("ij,ij->i", nt_raw, nt_raw)
    ok_t = tr_valid & (nn_t > 0)
    nn_ts = np.where(nn_t > 0, nn_t, 1.0)[:, None]
    g1_t = np.cross(tr_e2, nt_raw) / nn_ts      # dual basis of (e1, e2)
    g2_t = np.cross(nt_raw, tr_e1) / nn_ts
    pl_n[Q:] = np.where(ok_t[:, None], nt_raw, pl_n[Q:])
    pl_d[Q:] = np.where(ok_t, np.einsum("ij,ij->i", nt_raw, tr_v0), 0.0)
    pl_g1[Q:] = np.where(ok_t[:, None], g1_t, 0.0)
    pl_g1o[Q:] = np.where(ok_t, -np.einsum("ij,ij->i", tr_v0, g1_t), 0.0)
    pl_g2[Q:] = np.where(ok_t[:, None], g2_t, 0.0)
    pl_g2o[Q:] = np.where(ok_t, -np.einsum("ij,ij->i", tr_v0, g2_t), 0.0)
    pl_is_tri[Q:] = ok_t
    pl_idx[Q:] = np.where(ok_t, np.arange(T, dtype=i32), 0)
    pl_valid[Q:] = ok_t

    sph_attr = np.concatenate(
        [sph_center, sph_radius[:, None],
         sph_mat[:, None].astype(np.float64)], axis=1)

    # quad uv == planar coordinates: uv0=(0,0) duv1=(1,0) duv2=(0,1) makes
    # the triangle interpolation formula produce them directly
    pl_tangent = np.zeros((Pp, 3)); pl_bitangent = np.zeros((Pp, 3))
    pl_uv0 = np.zeros((Pp, 2)); pl_duv1 = np.zeros((Pp, 2))
    pl_duv2 = np.zeros((Pp, 2)); pl_mat_col = np.zeros(Pp)
    un = np.linalg.norm(qd_u, axis=-1)
    vn = np.linalg.norm(qd_v, axis=-1)
    pl_tangent[:Q] = np.where((un > 0)[:, None],
                              qd_u / np.maximum(un, 1e-300)[:, None],
                              [[1.0, 0.0, 0.0]])
    pl_bitangent[:Q] = np.where((vn > 0)[:, None],
                                qd_v / np.maximum(vn, 1e-300)[:, None],
                                [[0.0, 1.0, 0.0]])
    pl_duv1[:Q] = [1.0, 0.0]
    pl_duv2[:Q] = [0.0, 1.0]
    pl_mat_col[:Q] = qd_mat
    pl_tangent[Q:] = tr_tangent
    pl_bitangent[Q:] = tr_bitangent
    pl_uv0[Q:] = tr_uv0
    pl_duv1[Q:] = tr_uv1 - tr_uv0
    pl_duv2[Q:] = tr_uv2 - tr_uv0
    pl_mat_col[Q:] = tr_mat
    pl_unit_n = np.concatenate([qd_normal, tr_normal], axis=0)
    pl_attr = np.concatenate(
        [pl_unit_n, pl_g1, pl_g1o[:, None], pl_g2, pl_g2o[:, None],
         pl_tangent, pl_bitangent, pl_uv0, pl_duv1, pl_duv2,
         pl_mat_col[:, None], pl_is_tri[:, None].astype(np.float64)], axis=1)

    # host (numpy) arrays: the BVH build reads them without device
    # round-trips; compile_scene moves the whole tree to the device at the
    # end
    j = lambda x: np.asarray(x, f32)  # noqa: E731
    ji = lambda x: np.asarray(x, i32)  # noqa: E731
    return Solids(
        sph_center=j(sph_center), sph_radius=j(sph_radius),
        sph_mat=ji(sph_mat), sph_valid=sph_valid,
        qd_q=j(qd_q), qd_u=j(qd_u), qd_v=j(qd_v), qd_normal=j(qd_normal),
        qd_d=j(qd_d), qd_w=j(qd_w), qd_area=j(qd_area), qd_mat=ji(qd_mat),
        qd_valid=qd_valid,
        tr_v0=j(tr_v0), tr_e1=j(tr_e1), tr_e2=j(tr_e2),
        tr_uv0=j(tr_uv0), tr_uv1=j(tr_uv1), tr_uv2=j(tr_uv2),
        tr_normal=j(tr_normal), tr_tangent=j(tr_tangent),
        tr_bitangent=j(tr_bitangent), tr_area=j(tr_area), tr_mat=ji(tr_mat),
        tr_valid=tr_valid,
        pl_n=j(pl_n), pl_d=j(pl_d), pl_g1=j(pl_g1), pl_g1o=j(pl_g1o),
        pl_g2=j(pl_g2), pl_g2o=j(pl_g2o), pl_is_tri=pl_is_tri,
        pl_idx=ji(pl_idx), pl_valid=pl_valid,
        sph_attr=j(sph_attr), pl_attr=j(pl_attr),
    )


def _build_lights(spheres, quads, tris, meshes=()):
    rows = []
    for s in spheres:
        if s.material.is_light:
            rows.append((KIND_SPHERE, s.center, np.zeros(3), np.zeros(3),
                         s.radius, np.zeros(3), 0.0, np.zeros(3), 1.0))
    for q in quads:
        if q.material.is_light:
            rows.append((KIND_QUAD, q.q, q.u, q.v, 0.0, q.normal, q.d, q.w,
                         q.area))
    for t in tris:
        if t.material.is_light:
            rows.append((KIND_TRIANGLE, t.v0, t.e1, t.e2, 0.0, t.normal, 0.0,
                         np.zeros(3), t.area))
    for m in meshes:
        if m.material.is_light:
            for i in range(len(m)):
                rows.append((KIND_TRIANGLE, m.v0[i], m.e1[i], m.e2[i], 0.0,
                             m.normal[i], 0.0, np.zeros(3), m.area[i]))
    if not rows:
        raise SceneError("Scene should have at least one light")
    j = lambda xs: np.asarray(xs, np.float32)  # noqa: E731
    attr = np.concatenate(
        [np.array([[r[0]] for r in rows], np.float32),
         np.asarray([r[1] for r in rows], np.float32),
         np.asarray([r[2] for r in rows], np.float32),
         np.asarray([r[3] for r in rows], np.float32),
         np.array([[r[4]] for r in rows], np.float32)], axis=1)
    return Lights(
        kind=np.array([r[0] for r in rows], np.int32),
        p0=j([r[1] for r in rows]), p1=j([r[2] for r in rows]),
        p2=j([r[3] for r in rows]), radius=j([r[4] for r in rows]),
        normal=j([r[5] for r in rows]), d=j([r[6] for r in rows]),
        w=j([r[7] for r in rows]), area=j([r[8] for r in rows]),
        attr=attr,
    )


def compile_camera(camera, width, height):
    """Thin-lens camera precompute (camera.rs:47-74), host f64."""
    aspect = width / height
    theta = math.radians(camera.vertical_fov_degrees)
    h = math.tan(theta / 2.0)
    vp_height = 2.0 * h
    vp_width = aspect * vp_height

    look_v = camera.look_from - camera.look_at
    focus = np.linalg.norm(look_v)
    w = look_v / focus
    u = np.cross(camera.up / np.linalg.norm(camera.up), w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)

    horizontal = u * vp_width * focus
    vertical = v * vp_height * focus
    lower_left = camera.look_from - horizontal / 2 - vertical / 2 - w * focus
    j = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return CameraSoA(origin=j(camera.look_from), lower_left=j(lower_left),
                     horizontal=j(horizontal), vertical=j(vertical),
                     u=j(u), v=j(v),
                     lens_radius=j(camera.aperture_size / 2.0))


# primitive count above which the BVH is built (below it, the brute-force
# sweep kernel covers the scene)
BVH_THRESHOLD = 512


def _mat_has_image(m, depth=0):
    if depth > 4 or m is None:
        return False
    if isinstance(m, Blend):
        return (_mat_has_image(m.material_1, depth + 1)
                or _mat_has_image(m.material_2, depth + 1))
    # .albedo covers Lambertian/Metal/Dielectric/DiffuseLight; .tex covers
    # Isotropic (scene/materials.py)
    return (isinstance(getattr(m, "albedo", None), ImageMap)
            or isinstance(getattr(m, "tex", None), ImageMap))


def _features(mats, arena, spheres):
    features = set()
    if any(r["kind"] == BLEND for r in mats.rows):
        features.add("blend")
    if any(r["normal_tex"] >= 0 for r in mats.rows):
        features.add("normal_maps")
    if any(w > 1 or h > 1 for w, h in zip(arena.w, arena.h)):
        features.add("image_tex")
        # every image texel exactly representable in u8 (ImageMap stores u8
        # and divides by 255, so this holds by construction)
        u8_ok = True
        for w, h, px in zip(arena.w, arena.h, arena.pixels):
            if w * h > 1:
                seg = np.asarray(px, np.float64) * 255.0
                if not np.allclose(seg, np.round(seg), atol=1e-4):
                    u8_ok = False
                    break
        if u8_ok:
            features.add("image_tex_u8")
        if any(_mat_has_image(sp.material) for sp in spheres):
            features.add("sphere_image_tex")
    if spheres:
        features.add("spheres")
    _kind_feature = {METAL: "metal", DIELECTRIC: "dielectric",
                     ISOTROPIC: "isotropic"}
    for r in mats.rows:
        f = _kind_feature.get(r["kind"])
        if f:
            features.add(f)
    return frozenset(features)


def to_device(cs: CompiledScene, device) -> CompiledScene:
    """A copy of the compiled scene with every table on ``device``."""
    return _to_device(cs, torch.device(device))


def _to_device(obj, device):
    """Cast every numpy leaf to f32/int32/bool and move it to ``device``:
    the one host->device pass of a compile. Tensor leaves keep their
    dtype."""
    from ..accel import KernelBvh

    if obj is None or isinstance(obj, (frozenset, str, int, float, bool)):
        return obj
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (tuple, list)):
        return tuple(_to_device(x, device) for x in obj)
    if isinstance(obj, KernelBvh):
        return obj.to(device)
    if dataclasses.is_dataclass(obj):
        kw = {f.name: _to_device(getattr(obj, f.name), device)
              for f in fields(obj)}
        return type(obj)(**kw)
    a = np.asarray(obj)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy()  # (np.ascontiguousarray would turn 0-d into 1-d)
    return torch.from_numpy(a).to(device)


def _target_device(device, who):
    """torch.device for ``device``; a CUDA device that is not available
    raises (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: device {dev} requested but "
                           "torch.cuda.is_available() is false")
    return dev


def compile_scene(scene: Scene, use_bvh=None, device="cuda") -> CompiledScene:
    """Flatten a Scene into a CompiledScene of tensors on ``device`` (the
    card unless the caller asks for the CPU; without CUDA the default
    raises).

    use_bvh: None = auto (build the BVH when the solid count exceeds
    BVH_THRESHOLD), True/False = force, "device" = build the LBVH
    (``cs.bvh``) with torch on ``device`` (``accel.build_bvh_device``; the
    kernel tree stays a host build).

    Raises SceneError("Scene should have at least one light") like
    renderer/mod.rs:143-147.
    """
    dev = _target_device(device, "compile_scene")
    out = {"spheres": [], "quads": [], "triangles": [], "meshes": [],
           "media": []}
    _walk(scene.world, out, False)

    arena = _TexArenaBuilder()
    mats = _MatTableBuilder(arena)

    solids = _build_solids(out["spheres"], out["quads"], out["triangles"],
                           mats, out["meshes"])
    lights = _build_lights(out["spheres"], out["quads"], out["triangles"],
                           out["meshes"])

    media = []
    for node, sub in out["media"]:
        boundary = _build_solids(sub["spheres"], sub["quads"],
                                 sub["triangles"], mats, sub["meshes"])
        media.append(Medium(
            boundary=boundary,
            neg_inv_density=np.float32(node.neg_inv_density),
            mat=np.int32(mats.add(node.phase_material)),
        ))

    n_solids = (len(out["spheres"]) + len(out["quads"])
                + len(out["triangles"]) + sum(len(m) for m in out["meshes"]))
    bvh = kbvh = None
    if use_bvh or (use_bvh is None and n_solids > BVH_THRESHOLD):
        from ..accel import (build_bvh, build_bvh_device, build_kernel_bvh,
                             solids_aabbs)

        if use_bvh == "device":
            kinds, idxs, mins, maxs = solids_aabbs(solids)
            bvh = build_bvh_device(*(
                torch.from_numpy(a).to(dev) for a in (
                    mins.astype(np.float32), maxs.astype(np.float32),
                    kinds, idxs)))
        else:
            bvh = build_bvh(solids)
        kbvh = build_kernel_bvh(solids)

    material_table = mats.build()
    features = _features(mats, arena, out["spheres"])
    cs = CompiledScene(
        solids=solids,
        media=tuple(media),
        lights=lights,
        materials=material_table,
        textures=arena.build(),
        bg_color=np.asarray(scene.background_color, np.float32),
        camera=compile_camera(scene.camera, scene.render_config.width,
                              scene.render_config.height),
        bvh=bvh,
        kbvh=kbvh,
        features=features,
        light_kinds=tuple(int(k) for k in lights.kind),
    )
    return _to_device(cs, dev)


# --- carrying compiled tables across packages ------------------------------

def tables_of(obj):
    """Nested dict/list of numpy arrays from a CompiledScene of either
    package (duck-typed: dataclass fields, tuples, and the KernelBvh's
    array/int attributes). Static ``features`` / ``light_kinds`` pass
    through unchanged."""
    if obj is None or isinstance(obj, (frozenset, str, int, float, bool)):
        return obj
    if isinstance(obj, (tuple, list)):
        return [tables_of(x) for x in obj]
    if dataclasses.is_dataclass(obj):
        return {f.name: tables_of(getattr(obj, f.name))
                for f in fields(obj)}
    if type(obj).__name__ == "KernelBvh":
        return {k: tables_of(getattr(obj, k)) for k in
                ("top_nodes", "rows", "n_troots", "tr", "n_leaves",
                 "leaf_size", "has_spheres")}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)


def _from_dict(cls, d):
    return cls(**{f.name: d[f.name] for f in fields(cls)})


def from_numpy_tables(tables, device="cuda") -> CompiledScene:
    """Build the port's CompiledScene from another package's compiled
    tables (``tables_of`` of a JAX ``CompiledScene``: nested dicts of
    numpy arrays plus the static ``features`` and ``light_kinds``), on
    ``device`` (the card unless the caller asks for the CPU; without CUDA
    the default raises).

    The kernel BVH's node and leaf arrays are rebuilt from the solid
    tables (the JAX layout keeps only its TPU treelet form); the rebuilt
    ``top_nodes`` / ``rows`` must equal the given ones, else ValueError."""
    from ..accel import Bvh as _Bvh, build_kernel_bvh

    dev = _target_device(device, "from_numpy_tables")
    solids = _from_dict(Solids, tables["solids"])
    media = tuple(
        Medium(boundary=_from_dict(Solids, m["boundary"]),
               neg_inv_density=np.asarray(m["neg_inv_density"], np.float32),
               mat=np.asarray(m["mat"], np.int32))
        for m in tables["media"])
    kbvh = None
    if tables.get("kbvh") is not None:
        kbvh = build_kernel_bvh(solids)
        given = tables["kbvh"]
        for k in ("top_nodes", "rows"):
            if not np.array_equal(np.asarray(given[k]), getattr(kbvh, k)):
                raise ValueError(f"kernel BVH field {k} does not match the "
                                 "one rebuilt from the solid tables")
    bvh = (None if tables.get("bvh") is None
           else _from_dict(_Bvh, tables["bvh"]))
    cs = CompiledScene(
        solids=solids, media=media,
        lights=_from_dict(Lights, tables["lights"]),
        materials=_from_dict(Materials, tables["materials"]),
        textures=_from_dict(TexArena, tables["textures"]),
        bg_color=np.asarray(tables["bg_color"]),
        camera=_from_dict(CameraSoA, tables["camera"]),
        bvh=bvh, kbvh=kbvh,
        features=frozenset(tables["features"]),
        light_kinds=tuple(int(k) for k in tables["light_kinds"]),
    )
    return _to_device(cs, dev)
