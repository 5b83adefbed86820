"""The first hit as two hand-written kernels (``csrc/first_hit.cu``): CR
``camera_rays``, the camera rays of a list of pixel ids, and FH
``first_hit_shade``, the shading at depth 0 that the aux planes and the
debug shaders read.

Replaces what XLA fuses in the JAX package's forward renderer
(``solstrale_tpu/renderer/integrator.py``): ``camera_rays`` :401 and
``first_hit_aux`` :515, ``shade_albedo`` :538, ``shade_normal`` :543,
``shade_simple`` :556. The port's plain versions run them as chains of
torch ops, a draw-kernel launch for each draw, over every pixel:

- ``camera_rays`` (CR): the jittered thin-lens rays, one thread a pixel id,
  both draws in registers. Plain version:
  ``integrator.camera_rays_plain``.
- ``first_hit_shade`` (FH): from the scene hit at depth 0 (``t``, ``kind``,
  ``idx`` as ``integrator.step_hit`` gives them), the debug shader's color
  and the aux albedo and normal planes, each written only where asked for,
  in one launch, on a persistent grid (``first_hit_grid``). Plain version:
  ``integrator.first_hit_plain`` (the torch compositions
  ``first_hit_aux_plain`` and ``shade_*_plain``).

Each wrapper picks by the device of its tensors only: CPU tensors take the
plain version, CUDA tensors launch the kernel or raise. Both launch on the
current stream (the inverse step's CUDA graph captures CR as it is), read
nothing back to the host and count their launches (``launches``). Neither
builds an autograd graph: CR raises on the card where the camera's tensors
require grad, FH where a ray or a scene table does (as S1,
``ops.step.needs_grad``). The arguments go to the kernels as one array of
pointers and one of int64 values, indexed by the names below, which
``csrc/first_hit.cu``'s enums list in the same order.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .step import (_COUNTER, _add_counters, _check, _launch, needs_grad,
                   stage_floats, step_tables)

RAY = ("o0", "o1", "o2", "d0", "d1", "d2")
CAM_PTRS = ("cam", "pixel", "sample", "seed", "out")
CAM_INTS = ("n", "width", "height") + tuple(
    f"{c}_{k}" for c in ("sample", "seed") for k in _COUNTER)
FIRST_PTRS = (("cam", "sph", "pln", "mats", "tex_attr", "texels", "lights",
               "med_mat", "pl_row", "small", "t", "kind", "idx") + RAY
              + ("pixel", "sample", "seed", "color", "albedo", "normal"))
FIRST_INTS = (("n", "flags", "shader", "n_sph", "n_pl", "n_q", "n_mat",
               "n_tex", "n_texels", "n_media", "stage")
              + tuple(f"{c}_{k}" for c in ("pixel", "sample", "seed")
                      for k in _COUNTER))
# the debug shaders FH writes into its color plane (integrator.SHADER_*)
SHADERS = (1, 2, 3)
# FH's threads a block (csrc/first_hit.cu's kFirstThreads)
THREADS = 256


def camera_rays(cs, pixel, sample, seed, width, height):
    """CR: the jittered thin-lens camera rays of the pixel ids ``pixel``
    ((R,) int64, any subset of the image's) for sample ``sample`` and
    ``seed`` (each an int, a 0-dim tensor or an (R,) tensor:
    ``rng.kernel_counter``), in one launch; ``integrator.camera_rays_plain``
    says what it computes. Returns (o, d), component tuples of (R,) f32
    rows of one (6, R) block."""
    dev = pixel.device
    if dev.type == "cpu":
        from ..renderer.integrator import camera_rays_plain

        return camera_rays_plain(cs, pixel, sample, seed, width, height)
    if dev.type != "cuda":
        raise ValueError(f"camera_rays: unsupported device {dev}")
    if needs_grad(cs.camera):
        raise ValueError("camera_rays: the kernel builds no autograd graph, "
                         "and a camera tensor requires grad")
    out = camera_kernel(_build.library().camera_rays_launch, cs, pixel,
                        sample, seed, width, height,
                        _build.stream_of(pixel))
    camera_rays.launches += 1
    return out


camera_rays.launches = 0


def camera_kernel(fn, cs, pixel, sample, seed, width, height, stream):
    """CR's launch through its C entry ``fn`` (``camera_rays_launch``) on
    ``stream``: the checks and the two argument arrays."""
    dev = pixel.device
    pixel = pixel.to(torch.int64).contiguous()
    r = pixel.shape[0]
    _check("camera_rays: pixel", pixel, torch.int64, r, dev)
    cam = step_tables(cs).cam
    if cam.device != dev:
        raise ValueError("camera_rays: the scene's tables are not on the "
                         "pixel ids' device")
    out = torch.empty((6, r), dtype=torch.float32, device=dev)
    p = _build.ptr
    ptrs = dict(cam=p(cam), pixel=p(pixel), out=p(out))
    ints = dict(n=r, width=width, height=height)
    held = _add_counters(ptrs, ints, (("sample", sample), ("seed", seed)), r,
                         dev)
    _build.check(_launch(fn, CAM_PTRS, CAM_INTS, ptrs, ints, stream),
                 "camera_rays")
    rows = out.unbind(0)
    return rows[:3], rows[3:]


def first_hit_shade(cs, t, kind, idx, o, d, pixel, sample, seed,
                    shader_kind=None, albedo=False, normal=False):
    """FH: the shading at depth 0 from the scene hit (``t`` (R,) f32,
    ``kind`` and ``idx`` (R,) int32 as ``integrator.scene_hit`` gives them,
    or ``kind`` None and ``idx`` K1's planar slot, as ``integrator.step_hit``
    gives it on a BVH scene without spheres or media) of the rays ``o``,
    ``d`` (component tuples of (R,) f32), in one launch: the color of the
    debug shader ``shader_kind`` (``integrator.SHADER_ALBEDO``,
    ``SHADER_NORMAL`` or ``SHADER_SIMPLE``; None: no color) and the aux
    ``albedo`` and ``normal`` planes where asked for
    (``integrator.first_hit_plain`` says what it computes). Counters:
    ``pixel`` an (R,) int tensor, ``sample`` and ``seed`` ints or tensors
    (``rng.kernel_counter``). Returns a dict of (R, 3) f32 tensors,
    ``color``, ``albedo`` and ``normal``, None where not asked for."""
    dev = t.device
    if shader_kind is not None and shader_kind not in SHADERS:
        raise ValueError(f"first_hit_shade: shader_kind {shader_kind} is "
                         f"not a debug shader")
    if dev.type == "cpu":
        from ..renderer.integrator import first_hit_plain

        return first_hit_plain(cs, o, d, t, kind, idx, pixel, sample, seed,
                               shader_kind, albedo, normal)
    if dev.type != "cuda":
        raise ValueError(f"first_hit_shade: unsupported device {dev}")
    if needs_grad(cs, o, d):
        raise ValueError("first_hit_shade: the kernel builds no autograd "
                         "graph, and a ray or a scene table requires grad")
    out = first_hit_kernel(_build.library().first_hit_launch, cs, t, kind,
                           idx, o, d, pixel, sample, seed, shader_kind,
                           albedo, normal, _build.stream_of(t))
    first_hit_shade.launches += 1
    return out


first_hit_shade.launches = 0


def first_hit_grid(n):
    """FH's persistent grid for ``n`` lanes on the current CUDA device, as
    its launch computes it (the device's occupancy query, made once, at the
    first call or launch): a dict of ``blocks``, ``per_sm`` (the blocks
    that stay resident on one SM) and ``sms``. A wave of the grid is
    ``blocks * THREADS`` lanes."""
    out = (ctypes.c_int * 3)()
    _build.check(_build.library().first_hit_grid(n, out), "first_hit_grid")
    return dict(blocks=out[0], per_sm=out[1], sms=out[2])


def first_hit_kernel(fn, cs, t, kind, idx, o, d, pixel, sample, seed,
                     shader_kind, albedo, normal, stream):
    """FH's launch through its C entry ``fn`` (``first_hit_launch``) on
    ``stream``: the checks, the planes asked for (new tensors) and the two
    argument arrays."""
    dev = t.device
    r = t.shape[0]
    tab = step_tables(cs)
    if tab.cam.device != dev:
        raise ValueError("first_hit_shade: the scene's tables are not on "
                         "the rays' device")
    _check("first_hit_shade: t", t, torch.float32, r, dev)
    _check("first_hit_shade: idx", idx, torch.int32, r, dev)
    if kind is not None:
        _check("first_hit_shade: kind", kind, torch.int32, r, dev)
    elif tab.pl_row.shape[0] == 0:
        raise ValueError("first_hit_shade: a planar slot needs a planar "
                         "table")
    ray = [c.contiguous() for c in (*o, *d)]
    for name, x in zip(RAY, ray):
        _check(f"first_hit_shade: {name}", x, torch.float32, r, dev)
    planes = {k: (torch.empty((r, 3), dtype=torch.float32, device=dev)
                  if want else None)
              for k, want in (("color", shader_kind is not None),
                              ("albedo", albedo), ("normal", normal))}
    p = _build.ptr
    ptrs = dict(cam=p(tab.cam), sph=p(tab.sph), pln=p(tab.pln),
                mats=p(tab.mats), tex_attr=p(tab.tex_attr),
                texels=p(tab.texels), lights=p(tab.lights),
                med_mat=p(tab.med_mat), pl_row=p(tab.pl_row),
                small=p(tab.small), t=p(t), idx=p(idx))
    if kind is not None:
        ptrs["kind"] = p(kind)
    ptrs.update((name, p(x)) for name, x in zip(RAY, ray))
    ptrs.update((k, p(x)) for k, x in planes.items() if x is not None)
    ints = dict(n=r, flags=tab.flags, shader=shader_kind or 0,
                n_sph=tab.sph.shape[0], n_pl=tab.pln.shape[0], n_q=tab.n_q,
                n_mat=tab.mats.shape[0], n_tex=tab.tex_attr.shape[0],
                n_texels=tab.texels.shape[0], n_media=tab.med_mat.shape[0],
                stage=stage_floats(tab))
    held = _add_counters(ptrs, ints, (("pixel", pixel), ("sample", sample),
                                      ("seed", seed)), r, dev)
    _build.check(_launch(fn, FIRST_PTRS, FIRST_INTS, ptrs, ints, stream),
                 "first_hit_shade")
    return planes
