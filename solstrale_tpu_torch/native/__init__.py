"""ctypes bindings of the native host library (``csrc/solstrale_native.cpp``):
the C++ OBJ parser and the parallel Morton sort and node reduction of large
LBVH builds, with the JAX package's signatures and return values.

Nothing here runs at import. The first call builds the library with g++
into ``_build/`` (named by a hash of the source and the flags, so an edited
source rebuilds; written to a temporary file and renamed, so processes that
build at once never load a partial file) and later calls reuse it. A failed
build raises with the compiler's output and a failed load raises too:
nothing falls back to the Python parser or to numpy.

Flags, and why: no ``-march=native`` and no fast math, so the code does
not depend on the build host's CPU features and its f32 arithmetic (the
parse's ``strtof``, the sort's centroids and quantisation) is plain IEEE,
operation for operation what ``accel.build_bvh_device`` computes in torch.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "solstrale_native.cpp"
_BUILD = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-Wall", "-fPIC", "-shared", "-pthread")

_F = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)


class _ObjMesh(ctypes.Structure):
    _fields_ = [
        ("tri_verts", _F),
        ("tri_uvs", _F),
        ("tri_mat", _I32),
        ("n_tris", ctypes.c_int32),
        ("has_uvs", ctypes.c_int32),
        ("mat_names", ctypes.c_char_p),
        ("mtl_libs", ctypes.c_char_p),
    ]


def library_path(source=SOURCE):
    """Path of the shared library for ``source`` and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(Path(source).read_bytes())
    return _BUILD / f"libsolstrale_native_{h.hexdigest()[:16]}.so"


def build(source=SOURCE):
    """Compile ``source`` unless its library exists; returns the library's
    path. Raises RuntimeError with g++'s output when the build fails."""
    so = library_path(source)
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {source} needs a C++ compiler")
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                           f"{source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: no loader sees a partial file
    return so


@functools.lru_cache(maxsize=None)
def library(source=SOURCE):
    """The loaded library of ``source`` (built on first call)."""
    lib = ctypes.CDLL(str(build(source)))
    lib.obj_parse.restype = ctypes.POINTER(_ObjMesh)
    lib.obj_parse.argtypes = [ctypes.c_char_p]
    lib.obj_free.argtypes = [ctypes.POINTER(_ObjMesh)]
    lib.lbvh_sort.argtypes = [_F, _F, ctypes.c_int32, _I32]
    lib.lbvh_nodes.argtypes = [_F, _F, ctypes.c_int32, ctypes.c_int32, _F,
                               _F]
    return lib


def parse_obj(path):
    """Native OBJ parse -> (tri_verts (N,3,3) f32, tri_uvs (N,3,2) f32,
    tri_mat (N,) int32 (-1 = no usemtl), mat_names list, mtl_libs list,
    has_uvs). Faces are fan-triangulated; raises OSError when the file
    cannot be read."""
    lib = library()
    mesh_p = lib.obj_parse(os.fsencode(path))
    if not mesh_p:
        raise OSError(f"native OBJ parser could not read {path}")
    try:
        m = mesh_p.contents
        n = int(m.n_tris)
        verts = np.ctypeslib.as_array(m.tri_verts, (n, 3, 3)).copy()
        uvs = np.ctypeslib.as_array(m.tri_uvs, (n, 3, 2)).copy()
        mats = np.ctypeslib.as_array(m.tri_mat, (n,)).copy()
        names = m.mat_names.decode() if m.mat_names else ""
        libs = m.mtl_libs.decode() if m.mtl_libs else ""
        has_uvs = bool(m.has_uvs)
    finally:
        lib.obj_free(mesh_p)
    return (verts, uvs, mats,
            names.split("\n") if names else [],
            libs.split("\n") if libs else [], has_uvs)


def lbvh_sort(aabb_min, aabb_max):
    """Morton-order permutation (n,) int32 of the boxes' centroids, in f32
    and stable: the order of ``accel.build_bvh_device``."""
    mn = np.ascontiguousarray(aabb_min, np.float32)
    mx = np.ascontiguousarray(aabb_max, np.float32)
    n = mn.shape[0]
    order = np.empty(n, np.int32)
    library().lbvh_sort(mn.ctypes.data_as(_F), mx.ctypes.data_as(_F), n,
                        order.ctypes.data_as(_I32))
    return order


def lbvh_nodes(slot_min, slot_max, leaf_size):
    """Complete-tree node boxes (2*n_leaves-1, 3) f32 (min, max) of the
    slot boxes (n_leaves*leaf_size, 3), padding slots +inf / -inf."""
    mn = np.ascontiguousarray(slot_min, np.float32)
    mx = np.ascontiguousarray(slot_max, np.float32)
    n_slots = mn.shape[0]
    n_leaves = n_slots // leaf_size
    node_min = np.empty((2 * n_leaves - 1, 3), np.float32)
    node_max = np.empty((2 * n_leaves - 1, 3), np.float32)
    library().lbvh_nodes(mn.ctypes.data_as(_F), mx.ctypes.data_as(_F),
                         n_slots, leaf_size, node_min.ctypes.data_as(_F),
                         node_max.ctypes.data_as(_F))
    return node_min, node_max
