"""Build and load the hand-written CUDA kernels (``csrc/*.cu``), and the
plumbing every kernel wrapper shares (pointers, stream, input checks).

The sources compile with ``nvcc`` for ``sm_90a`` (one process per source,
all started together) and link into one shared library with a plain C
interface, loaded with ctypes. Nothing here runs at import: the first
kernel launch builds the library into ``_build/`` (named by a hash of the
sources, headers and flags, so an edited source rebuilds) and later
launches reuse it.

Flags, and why:
- no ``--use_fast_math``: parked lanes rely on IEEE inf/NaN (a zero
  direction gives 1/0 = inf and NaN comparisons, i.e. a miss), and the hit
  tests need IEEE division and sqrt;
- ``-fmad=false``: the plain PyTorch versions never contract a*b+c, and a
  contraction can flip a containment test on a grazing ray.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
SOURCES = ("bvh.cu", "sweep.cu", "megakernel.cu", "rng.cu", "step.cu",
           "first_hit.cu")
HEADERS = ("hit.cuh", "shade.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
_L = ctypes.c_longlong
# C entry points: argument types (pointers, ints, floats, stream) ->
# cudaError_t
_SIGNATURES = {
    "k1_bvh_launch": [_P] * 7 + [_F, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "k2_bvh_spheres_launch": [_P] * 6 + [_F, _F, _P, _I, _P, _P, _P, _P, _I,
                                         _I, _P, _P, _P, _P],
    "k3_media_launch": [_P] * 6 + [_P, _I] * 3 + [
        _U, _P, _I, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P,
        _P],
    "k4_scene_hit_launch": [_P] * 6 + [_P, _I] * 3 + [
        _U, _P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _P,
        _P, _P, _P],
    "k5_render_launch": [_P, _P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _I, _P,
                         _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _P, _P, _P, _P, _P],
    # counters: (pointer, element size, stride, value) each
    "rng_uniform4_launch": [_P, _I, _I, _U] * 3 + [_U, _P, _I, _I, _U, _L,
                                                   _P, _P],
    # an array of pointers and one of int64 values (ops/step.py and
    # ops/first_hit.py name them)
    "step_shade_launch": [_P, _P, _P],
    "step_regen_launch": [_P, _P, _P],
    "step_shade_backward_launch": [_P, _P, _P],
    "camera_rays_launch": [_P, _P, _P],
    "first_hit_launch": [_P, _P, _P],
    "camera_rays_backward_launch": [_P, _P, _P],
    "first_hit_backward_launch": [_P, _P, _P],
    # FH's and FHB's grids for n lanes: out = {blocks, blocks a SM, SMs}
    "first_hit_grid": [_L, _P],
    "first_hit_backward_grid": [_L, _P],
}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels in "
                       f"{_SRC} need the CUDA toolkit to build")


def library_path():
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((_SRC / name).read_bytes())
    return _BUILD / f"libsolstrale_kernels_{h.hexdigest()[:16]}.so"


class BuildInfo:
    """What the last build did: seconds spent in nvcc (0 when the library
    was already built) and the compiler's resource report."""

    seconds = 0.0
    log = ""


def _nvcc_run(args):
    """Run nvcc; returns its output, raises RuntimeError on failure."""
    proc = subprocess.run([_nvcc(), *args], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(proc.args)}\n{proc.stdout}"
                           f"{proc.stderr}")
    return proc.stdout + proc.stderr


def build():
    """Compile the kernels unless the library for these sources exists:
    one nvcc per source, all started together, then one link. Returns the
    library's path; raises RuntimeError with nvcc's output on failure."""
    so = library_path()
    if so.exists():
        return so
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_BUILD) as objdir, \
            ThreadPoolExecutor(len(SOURCES)) as pool:
        objs = [str(Path(objdir) / f"{Path(s).stem}.o") for s in SOURCES]
        logs = list(pool.map(
            lambda src, obj: _nvcc_run([*NVCC_FLAGS, "-c", "-o", obj,
                                        str(_SRC / src)]), SOURCES, objs))
        logs.append(_nvcc_run(["-shared", "-o", str(tmp), *objs]))
    BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.log = "".join(logs)
    so.with_suffix(".log").write_text(BuildInfo.log)
    os.replace(tmp, so)  # atomic: a concurrent loader never sees a partial file
    return so


@functools.lru_cache(maxsize=1)
def library():
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err, name):
    """Raise if a launch reported a CUDA error (the launch returns
    cudaGetLastError())."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


# --- what every kernel wrapper needs ----------------------------------------

def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def per_ray(x, like):
    """Scalar or (R,) bound -> contiguous (R,) f32 tensor (a fill kernel for
    a Python scalar: no host-to-device copy, no sync)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).expand_as(like).contiguous()
    return torch.full_like(like, float(x))


def ray_components(o, d):
    """(o, d) component tuples -> six contiguous (R,) tensors."""
    return tuple(c.contiguous() for c in (*o, *d))


def check_rays(rays, *tables):
    """Validate (R,) f32 ray components and f32 contiguous tables on one
    device; returns (device, R)."""
    dev = rays[0].device
    r = rays[0].shape[0]
    for x in rays:
        if x.device != dev or x.dtype != torch.float32 or x.shape != (r,):
            raise ValueError("rays must be (R,) float32 tensors on one device")
    for t in tables:
        if t.device != dev or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError("tables must be contiguous float32 tensors on "
                             "the rays' device")
    return dev, r
