"""Wavefront OBJ + MTL ingest.

Mirrors the reference's ``loader/obj.rs`` as the JAX package's loader does:
fan-triangulated faces, MTL diffuse colour / texture -> Lambertian, bump and
normal maps -> normal textures (height maps detected and converted), the
caller's default material where a face has none. ``Obj.load`` parses with
the native C++ parser (``native.parse_obj``) and returns one array-backed
``TriangleMesh`` per material under a ``Bvh``: the JAX package's native
route, table for table. ``_parse_obj`` is the plain Python parser the
native one is held to (``parse_obj_arrays`` gives it the native parser's
return values).
"""
from __future__ import annotations

import os

import numpy as np

from .. import native
from . import Bvh, TriangleMesh
from .materials import Lambertian, Material
from .textures import ImageMap, SolidColor, load_normal_texture


class Loader:
    def load(self, transformation, default_material=None):
        raise NotImplementedError


class Obj(Loader):
    """OBJ file loader (obj.rs:22-35). ``path`` is the directory prefix
    (ending in a separator) that ``filename``, the MTL files and the
    textures are found under."""

    def __init__(self, path, filename):
        self.path = path
        self.filename = filename

    def load(self, transformation, default_material: Material | None = None):
        filepath = f"{self.path}{self.filename}"
        if default_material is None:
            default_material = Lambertian(SolidColor(1.0, 1.0, 1.0))
        if not os.path.exists(filepath):
            raise FileNotFoundError(
                f"failed to load obj model from {filepath}")
        verts, uvs, tri_mat, mat_names, mtllibs, has_uvs = \
            native.parse_obj(filepath)

        materials = {}
        for lib in mtllibs:
            lib_path = os.path.join(self.path, lib)
            if not os.path.exists(lib_path):
                raise FileNotFoundError(
                    f"failed to load MTL file for {filepath}")
            materials.update(_parse_mtl(lib_path))
        mat_map = _build_materials(materials, self.path, default_material)

        groups = []
        for mid in np.unique(tri_mat):
            name = mat_names[mid] if mid >= 0 else None
            sel = tri_mat == mid
            groups.append(TriangleMesh(verts[sel],
                                       mat_map.get(name, default_material),
                                       uvs[sel] if has_uvs else None,
                                       transformation))
        return Bvh(groups)


def _build_materials(materials, path, default_material):
    mat_map = {None: default_material}
    for name, m in materials.items():
        if m.get("map_kd"):
            albedo = ImageMap.load(os.path.join(path, m["map_kd"]))
        elif m.get("kd") is not None:
            albedo = SolidColor(*m["kd"])
        else:
            albedo = SolidColor(1.0, 1.0, 1.0)
        normal = None
        if m.get("map_bump"):
            normal = load_normal_texture(os.path.join(path, m["map_bump"]))
        mat_map[name] = Lambertian(albedo, normal)
    return mat_map


def _parse_obj(filepath):
    """Plain parse -> (positions, texcoords, faces, mtllibs); a face is
    (vertex indices, uv indices or None, usemtl name or None), indices
    0-based with negative ones resolved."""
    positions, texcoords, faces, mtllibs = [], [], [], []
    current_mtl = None
    with open(filepath, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                positions.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "vt":
                texcoords.append(tuple(float(x) for x in parts[1:3]))
            elif tag == "mtllib":
                mtllibs.append(parts[1])
            elif tag == "usemtl":
                current_mtl = parts[1] if len(parts) > 1 else None
            elif tag == "f":
                verts, uvs = [], []
                for vert in parts[1:]:
                    comps = vert.split("/")
                    vi = int(comps[0])
                    verts.append(vi - 1 if vi > 0 else len(positions) + vi)
                    if len(comps) > 1 and comps[1]:
                        ti = int(comps[1])
                        uvs.append(ti - 1 if ti > 0 else len(texcoords) + ti)
                    else:
                        uvs.append(None)
                faces.append((verts, uvs, current_mtl))
    return positions, texcoords, faces, mtllibs


def parse_obj_arrays(filepath):
    """``_parse_obj`` fan-triangulated into ``native.parse_obj``'s return
    values (vertices and UVs in f32, material ids in order of first use,
    (0, 0) UVs where a corner has none): the plain version of the native
    parser."""
    positions, texcoords, faces, mtllibs = _parse_obj(filepath)
    pos = np.asarray(positions, np.float64).reshape(-1, 3)
    tex = np.asarray(texcoords, np.float64).reshape(-1, 2)
    corners, uv_corners, tri_mat, names = [], [], [], {}
    for verts, uvs, mtl in faces:
        mid = -1 if mtl is None else names.setdefault(mtl, len(names))
        for i in range(1, len(verts) - 1):
            corners.append((verts[0], verts[i], verts[i + 1]))
            uv_corners.append((uvs[0], uvs[i], uvs[i + 1]))
            tri_mat.append(mid)
    n = len(corners)
    tri_verts = pos[np.asarray(corners, np.int64).reshape(n, 3)]
    uv_idx = np.asarray([[-1 if u is None else u for u in c]
                         for c in uv_corners], np.int64).reshape(n, 3)
    tri_uvs = np.zeros((n, 3, 2))
    if len(tex):
        tri_uvs = np.where((uv_idx >= 0)[..., None],
                           tex[np.maximum(uv_idx, 0)], 0.0)
    return (tri_verts.astype(np.float32), tri_uvs.astype(np.float32),
            np.asarray(tri_mat, np.int32), list(names), mtllibs,
            bool((uv_idx >= 0).any()))


def _parse_mtl(lib_path):
    materials = {}
    current = None
    with open(lib_path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0].lower()
            if tag == "newmtl":
                current = {}
                materials[parts[1]] = current
            elif current is None:
                continue
            elif tag == "kd":
                current["kd"] = tuple(float(x) for x in parts[1:4])
            elif tag == "map_kd":
                current["map_kd"] = parts[1]
            elif tag in ("map_bump", "bump", "norm", "map_norm"):
                current["map_bump"] = parts[-1]
    return materials
