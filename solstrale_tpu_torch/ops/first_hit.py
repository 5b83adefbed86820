"""The first hit as hand-written kernels (``csrc/first_hit.cu``): CR
``camera_rays``, the camera rays of a list of pixel ids, and FH
``first_hit_shade``, the shading at depth 0 that the aux planes and the
debug shaders read; and their backward kernels, CRB
``camera_rays_backward`` and FHB ``first_hit_backward``, which make both
differentiable (``CameraRaysFn``, ``FirstHitFn``).

Replaces what XLA fuses in the JAX package's forward renderer
(``solstrale_tpu/renderer/integrator.py``): ``camera_rays`` :401 and
``first_hit_aux`` :515, ``shade_albedo`` :538, ``shade_normal`` :543,
``shade_simple`` :556, and their transposes under ``jax.grad``. The port's
plain versions run them as chains of torch ops, a draw-kernel launch for
each draw, over every pixel:

- ``camera_rays`` (CR): the jittered thin-lens rays, one thread a pixel id,
  both draws in registers. Plain version:
  ``integrator.camera_rays_plain``.
- ``first_hit_shade`` (FH): from the scene hit at depth 0 (``t``, ``kind``,
  ``idx`` as ``integrator.step_hit`` gives them), the debug shader's color
  and the aux albedo and normal planes, each written only where asked for,
  in one launch, on a persistent grid (``first_hit_grid``). Plain version:
  ``integrator.first_hit_plain`` (the torch compositions
  ``first_hit_aux_plain`` and ``shade_*_plain``).
- ``camera_rays_backward`` (CRB): the rays' gradients reduced to the
  camera's 19 values (``CAMERA_FIELDS``), the draws redrawn in registers.
  Plain version: ``camera_rays_backward_plain``.
- ``first_hit_backward`` (FHB): FH's forward recomputed lane by lane from
  FH's inputs, and the planes' gradients taken back to the texture arena
  and the background (added into the backward pass's ``ops.step.GradSums``,
  as S1B adds), to the rays (detached t: the hit point's), and to the
  frame columns of ``Solids.sph_attr`` (center) and ``Solids.pl_attr``
  (normal, tangent, bitangent); on a resident grid
  (``first_hit_backward_grid``) whose blocks sum each row in shared memory
  (``BACK_SLOTS``) before one atomic add. Plain version:
  ``first_hit_backward_plain``.

Each wrapper picks by the device of its tensors only: CPU tensors take the
plain version, CUDA tensors launch the kernel or raise. All launch on the
current stream (the inverse step's CUDA graph captures CR as it is), read
nothing back to the host and count their launches (``launches``). Where
autograd would record a graph (``ops.step.needs_grad``), ``camera_rays``
and ``first_hit_shade`` go through ``CameraRaysFn`` and ``FirstHitFn``,
whose backward is CRB or FHB (on the CPU the plain forward and the plain
backward); otherwise they launch CR or FH alone and save nothing. The
arguments go to the kernels as one array of pointers and one of int64
values, indexed by the names below, which ``csrc/first_hit.cu``'s enums
list in the same order.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, bvh, rng
from ..geo import soa
from .step import (_COUNTER, _add_counters, _check, _check_table, _launch,
                   grad_scene, needs_grad, stage_floats, step_tables, sums_of)

RAY = ("o0", "o1", "o2", "d0", "d1", "d2")
_COUNTERS = ("pixel", "sample", "seed")
CAM_PTRS = ("cam", "pixel", "sample", "seed", "out")
CAM_INTS = ("n", "width", "height") + tuple(
    f"{c}_{k}" for c in ("sample", "seed") for k in _COUNTER)
FIRST_PTRS = (("cam", "sph", "pln", "mats", "tex_attr", "texels", "lights",
               "med_mat", "pl_row", "small", "t", "kind", "idx") + RAY
              + ("pixel", "sample", "seed", "color", "albedo", "normal"))
FIRST_INTS = (("n", "flags", "shader", "n_sph", "n_pl", "n_q", "n_mat",
               "n_tex", "n_texels", "n_media", "stage")
              + tuple(f"{c}_{k}" for c in _COUNTERS for k in _COUNTER))
# CRB's pointers (its int64 values are CR's, CAM_INTS)
CAM_BACK_PTRS = ("cam", "pixel", "sample", "seed", "g_ray", "g_cam")
FIRST_BACK_PTRS = (("sph", "pln", "mats", "tex_attr", "texels", "med_mat",
                    "pl_row", "small", "t", "kind", "idx") + RAY
                   + _COUNTERS + ("g_color", "g_albedo", "g_normal",
                                  "g_texels", "g_bg")
                   + tuple("g_" + n for n in RAY) + ("g_sph", "g_pln"))
FIRST_BACK_INTS = (("n", "flags", "shader", "n_sph", "n_pl", "n_q", "n_mat",
                    "n_tex", "n_texels", "n_media", "stage")
                   + tuple(f"{c}_{k}" for c in _COUNTERS for k in _COUNTER))
# the debug shaders FH writes into its color plane (integrator.SHADER_*)
SHADERS = (1, 2, 3)
# FH's planes, in its outputs' order
PLANES = ("color", "albedo", "normal")
# the camera's tensors CRB's gradients reach, in camera_table's order
# (scene.compile.CameraSoA; 3 values each, lens_radius one)
CAMERA_FIELDS = ("origin", "lower_left", "horizontal", "vertical", "u", "v",
                 "lens_radius")
# FH's and FHB's threads a block (csrc/first_hit.cu's kFirstThreads and
# kBackThreads)
THREADS = 256
BACK_THREADS = 256
# the slots of FHB's block tables of row sums (csrc/first_hit.cu's
# kTexelSlotBits, kFrameSlotBits, kSphereSlotBits): a block's distinct rows
# beyond them are added to device memory directly
BACK_SLOTS = dict(texel=1 << 10, frame=1 << 8, sphere=1 << 7)


def camera_rays(cs, pixel, sample, seed, width, height):
    """CR: the jittered thin-lens camera rays of the pixel ids ``pixel``
    ((R,) int64, any subset of the image's) for sample ``sample`` and
    ``seed`` (each an int, a 0-dim tensor or an (R,) tensor:
    ``rng.kernel_counter``), in one launch; ``integrator.camera_rays_plain``
    says what it computes. Returns (o, d), component tuples of (R,) f32
    rows of one (6, R) block. Where a camera tensor requires grad (grad
    mode on), through ``CameraRaysFn``: gradients reach the camera's
    tensors (``CAMERA_FIELDS``), by CRB on the card."""
    dev = pixel.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"camera_rays: unsupported device {dev}")
    if needs_grad(cs.camera):
        rows = CameraRaysFn.apply(
            cs, (pixel, sample, seed, width, height),
            *(getattr(cs.camera, f) for f in CAMERA_FIELDS)).unbind(0)
        return rows[:3], rows[3:]
    if dev.type == "cpu":
        from ..renderer.integrator import camera_rays_plain

        return camera_rays_plain(cs, pixel, sample, seed, width, height)
    rows = camera_launch(cs, pixel, sample, seed, width, height).unbind(0)
    return rows[:3], rows[3:]


camera_rays.launches = 0


def camera_launch(cs, pixel, sample, seed, width, height):
    """One counted CR launch on the current stream: the (6, R) block of
    the rays."""
    out = camera_kernel(_build.library().camera_rays_launch, cs, pixel,
                        sample, seed, width, height,
                        _build.stream_of(pixel))
    camera_rays.launches += 1
    return out


def camera_kernel(fn, cs, pixel, sample, seed, width, height, stream):
    """CR's launch through its C entry ``fn`` (``camera_rays_launch``) on
    ``stream``: the checks and the two argument arrays. Returns the (6, R)
    block o0 o1 o2 d0 d1 d2."""
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
    return out


class CameraRaysFn(torch.autograd.Function):
    """CR with CRB as its backward. Inputs: the compiled scene, CR's other
    arguments (pixel, sample, seed, width, height) in one tuple, then the
    camera's seven tensors (``CAMERA_FIELDS``), the leaves the gradients
    reach (CR reads their values from the scene's packed camera table,
    ``step_tables(cs).cam``). Output: the (6, R) block of the rays. Nothing
    is saved but the arguments; the backward redraws."""

    @staticmethod
    def forward(ctx, cs, call, *cam):
        ctx.cs, ctx.call = cs, call
        ctx.set_materialize_grads(False)
        if call[0].device.type == "cpu":
            from ..renderer.integrator import camera_rays_plain

            o, d = camera_rays_plain(cs, *call)
            return torch.stack([*o, *d])
        return camera_launch(cs, *call)

    @staticmethod
    def backward(ctx, g_ray):
        want = ctx.needs_input_grad[2:]
        if g_ray is None:
            return (None,) * (2 + len(want))
        return (None, None, *camera_rays_backward(ctx.cs, *ctx.call, g_ray,
                                                  want))


def camera_rays_backward(cs, pixel, sample, seed, width, height, g_ray,
                         want=(True,) * 7):
    """CRB: the gradients of the camera's tensors (``CAMERA_FIELDS``) from
    the rays' upstream gradient ``g_ray`` ((6, R) f32: o0 o1 o2 d0 d1 d2)
    of CR's call on ``pixel``, ``sample``, ``seed``, ``width``,
    ``height``. Returns seven tensors of the fields' shapes (None where
    ``want`` is false), views of one new (19,) tensor on the card. One
    launch on the card; ``camera_rays_backward_plain`` on the CPU."""
    dev = pixel.device
    if dev.type == "cpu":
        return camera_rays_backward_plain(cs, pixel, sample, seed, width,
                                          height, g_ray, want)
    if dev.type != "cuda":
        raise ValueError(f"camera_rays_backward: unsupported device {dev}")
    g = camera_backward_kernel(_build.library().camera_rays_backward_launch,
                               cs, pixel, sample, seed, width, height, g_ray,
                               _build.stream_of(pixel))
    camera_rays_backward.launches += 1
    parts = (g[0:3], g[3:6], g[6:9], g[9:12], g[12:15], g[15:18],
             g[18].reshape(cs.camera.lens_radius.shape))
    return tuple(x if w else None for x, w in zip(parts, want))


camera_rays_backward.launches = 0


def camera_backward_kernel(fn, cs, pixel, sample, seed, width, height, g_ray,
                           stream):
    """CRB's launch through its C entry ``fn``
    (``camera_rays_backward_launch``) on ``stream``: the checks, the new
    zeroed (19,) sums and the two argument arrays."""
    dev = pixel.device
    pixel = pixel.to(torch.int64).contiguous()
    r = pixel.shape[0]
    _check("camera_rays_backward: pixel", pixel, torch.int64, r, dev)
    g_ray = g_ray.contiguous()
    _check_table("camera_rays_backward: g_ray", g_ray, (6, r), dev)
    cam = step_tables(cs).cam
    if cam.device != dev:
        raise ValueError("camera_rays_backward: the scene's tables are not "
                         "on the pixel ids' device")
    g_cam = torch.zeros((19,), dtype=torch.float32, device=dev)
    p = _build.ptr
    ptrs = dict(cam=p(cam), pixel=p(pixel), g_ray=p(g_ray), g_cam=p(g_cam))
    ints = dict(n=r, width=width, height=height)
    held = _add_counters(ptrs, ints, (("sample", sample), ("seed", seed)), r,
                         dev)
    _build.check(_launch(fn, CAM_BACK_PTRS, CAM_INTS, ptrs, ints, stream),
                 "camera_rays_backward")
    return g_cam


def camera_rays_backward_plain(cs, pixel, sample, seed, width, height, g_ray,
                               want=(True,) * 7, magnitudes=False):
    """CRB's plain version: the reverse that autograd runs through
    ``integrator.camera_rays_plain``, written out in torch ops. With
    ``g_off = g_o - g_d`` (o takes the lens offset, d subtracts it and the
    origin): origin ``sum g_off``, lower_left ``sum g_d``, horizontal
    ``sum g_d u``, vertical ``sum g_d v``; where ``lens_radius > 0`` (else
    0: ``torch.where``'s untaken side) u ``sum g_off rd0``, v ``sum g_off
    rd1`` and lens_radius ``sum (g_off . u) disc0 + (g_off . v) disc1``
    (``rd = disc * lens_radius``, ``disc`` the lens draw's point of the
    unit disc). Same arguments and returns as ``camera_rays_backward``;
    with ``magnitudes`` every operand is taken as its absolute value and
    every difference as a sum: the magnitudes of the terms summed into
    each value, the scale to which the same sums taken in another order or
    grouping round."""
    cam = cs.camera
    x = (pixel % width).to(torch.float32)
    y = (pixel // width).to(torch.float32)
    j1, j2, _, _ = rng.uniform4(pixel, sample, 0, rng.P_JITTER, seed)
    u = (x + j1) / (width - 1)
    v = (y + j2) / (height - 1)
    l1, l2, _, _ = rng.uniform4(pixel, sample, 0, rng.P_LENS, seed)
    disc = rng.in_unit_disc3(l1, l2)
    lr = cam.lens_radius.detach()

    def op(x):
        return x.abs() if magnitudes else x

    g_o, g_d = op(g_ray[:3]), op(g_ray[3:])
    g_off = g_o + g_d if magnitudes else g_o - g_d
    g_lens = torch.where(lr > 0.0, g_off, 0.0)
    g_rd = [(g_lens * op(x.detach())[:, None]).sum(0) for x in (cam.u, cam.v)]
    disc = [op(x) for x in disc[:2]]
    parts = (g_off.sum(1), g_d.sum(1), (g_d * op(u)).sum(1),
             (g_d * op(v)).sum(1), (g_lens * (disc[0] * lr)).sum(1),
             (g_lens * (disc[1] * lr)).sum(1),
             (g_rd[0] * disc[0] + g_rd[1] * disc[1]).sum()
             .reshape(cam.lens_radius.shape))
    return tuple(x if w else None for x, w in zip(parts, want))


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
    ``color``, ``albedo`` and ``normal``, None where not asked for. Where
    a ray or a scene table requires grad (grad mode on), through
    ``FirstHitFn`` (``first_hit_grad``)."""
    dev = t.device
    if shader_kind is not None and shader_kind not in SHADERS:
        raise ValueError(f"first_hit_shade: shader_kind {shader_kind} is "
                         f"not a debug shader")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"first_hit_shade: unsupported device {dev}")
    if needs_grad(cs, o, d):
        return first_hit_grad(cs, t, kind, idx, o, d, pixel, sample, seed,
                              shader_kind, albedo, normal)
    if dev.type == "cpu":
        from ..renderer.integrator import first_hit_plain

        return first_hit_plain(cs, o, d, t, kind, idx, pixel, sample, seed,
                               shader_kind, albedo, normal)
    return first_hit_launch(cs, t, kind, idx, o, d, pixel, sample, seed,
                            shader_kind, albedo, normal)


first_hit_shade.launches = 0


def first_hit_launch(cs, t, kind, idx, o, d, pixel, sample, seed, shader_kind,
                     albedo, normal):
    """One counted FH launch on the current stream: its dict of planes."""
    out = first_hit_kernel(_build.library().first_hit_launch, cs, t, kind,
                           idx, o, d, pixel, sample, seed, shader_kind,
                           albedo, normal, _build.stream_of(t))
    first_hit_shade.launches += 1
    return out


def first_hit_grid(n):
    """FH's persistent grid for ``n`` lanes on the current CUDA device, as
    its launch computes it (the device's occupancy query, made once, at the
    first call or launch): a dict of ``blocks``, ``per_sm`` (the blocks
    that stay resident on one SM) and ``sms``. A wave of the grid is
    ``blocks * THREADS`` lanes."""
    out = (ctypes.c_int * 3)()
    _build.check(_build.library().first_hit_grid(n, out), "first_hit_grid")
    return dict(blocks=out[0], per_sm=out[1], sms=out[2])


def first_hit_backward_grid(n):
    """FHB's resident grid for ``n`` lanes on the current CUDA device, as
    its launch computes it (as ``first_hit_grid`` does FH's): a dict of
    ``blocks``, ``per_sm`` and ``sms``. A wave of the grid is ``blocks *
    BACK_THREADS`` lanes."""
    out = (ctypes.c_int * 3)()
    _build.check(_build.library().first_hit_backward_grid(n, out),
                 "first_hit_backward_grid")
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


def first_hit_grad(cs, t, kind, idx, o, d, pixel, sample, seed, shader_kind,
                   albedo, normal):
    """``first_hit_shade`` through ``FirstHitFn``: FH, and FHB in the
    backward. Gradients reach the texture arena and the background
    (through the sums of the arena's ``ops.step.grad_scene``, made here
    where the scene has none yet), the rays, and ``Solids.sph_attr`` and
    ``Solids.pl_attr``; every other table of the scene gets none (JAX's
    gradient of each is zero). Same dict as ``first_hit_shade``."""
    arena, bg = cs.textures.pixels, cs.bg_color
    if (arena.requires_grad or bg.requires_grad) and sums_of(arena) is None:
        cs = grad_scene(cs)
        arena, bg = cs.textures.pixels, cs.bg_color
    call = (t, kind, idx, pixel, sample, seed, shader_kind, albedo, normal,
            sums_of(arena))
    planes = FirstHitFn.apply(cs, call, arena, bg, cs.solids.sph_attr,
                              cs.solids.pl_attr, *o, *d)
    return dict(zip(PLANES, planes))


class FirstHitFn(torch.autograd.Function):
    """FH with FHB as its backward. Inputs: the compiled scene, FH's other
    arguments and the pass's ``GradSums`` (or None: neither the arena nor
    the background wants a gradient) in one tuple, then the differentiable
    ones: the arena and the background (``grad_scene``'s views), which FHB
    reads from these tensors, not from the scene's packed tables,
    ``Solids.sph_attr``, ``Solids.pl_attr`` and the six ray components.
    Outputs: the color, albedo and normal planes (None where not asked
    for). Nothing new is saved: FHB recomputes each lane's forward from
    FH's inputs. The backward adds the arena's and the background's
    gradients into the sums and returns none for them (the sums' sink
    does), and the tables' in new zeroed tables of their shapes."""

    @staticmethod
    def forward(ctx, cs, call, arena, bg, sph_attr, pl_attr, *ray):
        t, kind, idx, pixel, sample, seed, shader_kind, albedo, normal, _ = \
            call
        if t.device.type == "cpu":
            from ..renderer.integrator import first_hit_plain

            planes = first_hit_plain(cs, ray[:3], ray[3:], t, kind, idx,
                                     pixel, sample, seed, shader_kind,
                                     albedo, normal)
        else:
            planes = first_hit_launch(cs, t, kind, idx, ray[:3], ray[3:],
                                      pixel, sample, seed, shader_kind,
                                      albedo, normal)
        ctx.cs, ctx.call = cs, call
        ctx.save_for_backward(arena, *ray)
        ctx.set_materialize_grads(False)
        return tuple(planes[k] for k in PLANES)

    @staticmethod
    def backward(ctx, *g_planes):
        arena, *ray = ctx.saved_tensors
        t, kind, idx, pixel, sample, seed, shader_kind, _, _, sums = ctx.call
        cs, need = ctx.cs, ctx.needs_input_grad
        want_texels = sums is not None and sums.want_texels
        want_bg = sums is not None and sums.want_bg
        g_sph = (torch.zeros_like(cs.solids.sph_attr) if need[4] else None)
        g_pl = (torch.zeros_like(cs.solids.pl_attr) if need[5] else None)
        g_ray = first_hit_backward(
            cs, t, kind, idx, ray[:3], ray[3:], pixel, sample, seed, arena,
            dict(zip(PLANES, g_planes)), shader_kind,
            sums.buffer() if want_texels or want_bg else None, want_texels,
            want_bg, need[6:12], g_sph, g_pl)
        return (None, None, None, None, g_sph, g_pl, *g_ray)


def first_hit_backward(cs, t, kind, idx, o, d, pixel, sample, seed, texels,
                       g_planes, shader_kind, sums, want_texels=True,
                       want_bg=True, want_ray=(True,) * 6, g_sph=None,
                       g_pl=None):
    """FHB: the gradients of one FH call's inputs (its hit, rays and
    counters as FH took them, its shader) from the upstream gradients of
    its planes (``g_planes``: a dict of (R, 3) f32 tensors by ``PLANES``,
    None where a plane has none or was not asked for), with the arena
    ``texels`` ((N, 3) f32) read for the texels' values. Adds the arena's
    gradient into ``sums[:N]`` and the background's into ``sums[N]``
    (``sums``: an (N + 1, 3) f32 tensor, ``GradSums.buffer``; None where
    neither is wanted), each where its ``want_*`` is true, and the frame
    columns' gradients into ``g_sph`` ((S, 5), ``Solids.sph_attr``'s
    shape) and ``g_pl`` ((P, 25)) where given; returns the six ray
    components' gradients ((R,) f32, None where ``want_ray`` is false).
    One launch on the card, which allocates only those six;
    ``first_hit_backward_plain`` on the CPU."""
    dev = t.device
    if dev.type == "cpu":
        return first_hit_backward_plain(cs, t, kind, idx, o, d, pixel,
                                        sample, seed, texels, g_planes,
                                        shader_kind, sums, want_texels,
                                        want_bg, want_ray, g_sph, g_pl)
    if dev.type != "cuda":
        raise ValueError(f"first_hit_backward: unsupported device {dev}")
    out = first_back_kernel(_build.library().first_hit_backward_launch, cs,
                            t, kind, idx, o, d, pixel, sample, seed, texels,
                            g_planes, shader_kind, sums, want_texels,
                            want_bg, want_ray, g_sph, g_pl,
                            _build.stream_of(t))
    first_hit_backward.launches += 1
    return out


first_hit_backward.launches = 0


def first_back_kernel(fn, cs, t, kind, idx, o, d, pixel, sample, seed,
                      texels, g_planes, shader_kind, sums, want_texels,
                      want_bg, want_ray, g_sph, g_pl, stream):
    """FHB's launch through its C entry ``fn`` (``first_hit_backward_launch``)
    on ``stream``: the checks, the rays' new gradient tensors and the two
    argument arrays."""
    dev = t.device
    r = t.shape[0]
    tab = step_tables(cs)
    if tab.cam.device != dev:
        raise ValueError("first_hit_backward: the scene's tables are not on "
                         "the rays' device")
    _check("first_hit_backward: t", t, torch.float32, r, dev)
    _check("first_hit_backward: idx", idx, torch.int32, r, dev)
    if kind is not None:
        _check("first_hit_backward: kind", kind, torch.int32, r, dev)
    elif tab.pl_row.shape[0] == 0:
        raise ValueError("first_hit_backward: a planar slot needs a planar "
                         "table")
    n = texels.shape[0]
    _check_table("first_hit_backward: texels", texels, (n, 3), dev)
    p = _build.ptr
    keep = []   # the upstream gradients made contiguous, held to the launch
    ptrs = dict(sph=p(tab.sph), pln=p(tab.pln), mats=p(tab.mats),
                tex_attr=p(tab.tex_attr), texels=p(texels),
                med_mat=p(tab.med_mat), pl_row=p(tab.pl_row),
                small=p(tab.small), t=p(t), idx=p(idx))
    if kind is not None:
        ptrs["kind"] = p(kind)
    ray = [c.contiguous() for c in (*o, *d)]
    for name, x in zip(RAY, ray):
        _check(f"first_hit_backward: {name}", x, torch.float32, r, dev)
        ptrs[name] = p(x)
    for k in PLANES:
        g = g_planes.get(k)
        if g is None or (k == "color" and shader_kind is None):
            continue
        g = g.contiguous()
        _check_table(f"first_hit_backward: g_{k}", g, (r, 3), dev)
        keep.append(g)
        ptrs["g_" + k] = p(g)
    if want_texels or want_bg:
        _check_table("first_hit_backward: sums", sums, (n + 1, 3), dev)
        if want_texels:
            ptrs["g_texels"] = p(sums)
        if want_bg:
            ptrs["g_bg"] = p(sums[n])
    for name, g, table in (("g_sph", g_sph, cs.solids.sph_attr),
                           ("g_pln", g_pl, cs.solids.pl_attr)):
        if g is not None:
            _check_table(f"first_hit_backward: {name}", g,
                         tuple(table.shape), dev)
            ptrs[name] = p(g)
    g_ray = [torch.empty_like(x) if w else None
             for x, w in zip(ray, want_ray)]
    ptrs.update(("g_" + name, p(g)) for name, g in zip(RAY, g_ray)
                if g is not None)
    ints = dict(n=r, flags=tab.flags, shader=shader_kind or 0,
                n_sph=tab.sph.shape[0], n_pl=tab.pln.shape[0], n_q=tab.n_q,
                n_mat=tab.mats.shape[0], n_tex=tab.tex_attr.shape[0],
                n_texels=n, n_media=tab.med_mat.shape[0],
                stage=stage_floats(tab))
    held = _add_counters(ptrs, ints, (("pixel", pixel), ("sample", sample),
                                      ("seed", seed)), r, dev)
    _build.check(_launch(fn, FIRST_BACK_PTRS, FIRST_BACK_INTS, ptrs, ints,
                         stream), "first_hit_backward")
    return tuple(g_ray)


def first_hit_backward_plain(cs, t, kind, idx, o, d, pixel, sample, seed,
                             texels, g_planes, shader_kind, sums,
                             want_texels=True, want_bg=True,
                             want_ray=(True,) * 6, g_sph=None, g_pl=None,
                             magnitudes=False):
    """FHB's plain version: the reverse that autograd runs through
    ``integrator.first_hit_plain``, written out in torch ops over every
    lane, each branch computed and selected (a ``torch.where``'s untaken
    side passes 0), with t detached (the hit kernels' zero cotangent):

    - a miss passes the albedo plane's and the color's gradients to the
      background (every debug shader shows it there);
    - on a hit the albedo texel takes the albedo plane's and the albedo
      shader's gradients where the plane shows it (not on a light's back
      face), and the simple shader's (times its factor; on a light the
      emission's, front face only); the shading normal s takes the normal
      plane's, the normal shader's and the simple shader's factor's
      (``sum_c g_c texel_c * 0.5`` times (1, 1, -1); not on a light);
    - where a normal map applies, ``s = T tn.x + B tn.y + N tn.z`` with
      ``tn = 2 texel - 1``: the map's texel takes ``2 (g_s . T, g_s . B,
      g_s . N)`` and the frame ``g_s tn``; elsewhere N takes ``g_s``;
    - a planar hit's row takes the face-forwarded normal's gradient
      (negated on a back face) in its normal columns, the tangent's and
      the bitangent's in theirs;
    - a sphere hit's frame is a function of ``n_raw = o + d t - center``:
      the face-forwarded unit normal, the unit tangent of ``(n_raw.z, 0,
      -n_raw.x)`` and the bitangent ``cross(n_raw, tangent)``; each unit
      vector's reverse as torch takes it (``1 / sqrt``: the reciprocal's
      ``-g r r``, the root's ``g / (2 root)``), o takes n_raw's gradient,
      d it times t, the center its negation;
    - a medium's frame is a draw and constants: no gradient.

    The arena's gradient is ``index_add_`` into the sums' rows of the
    texels read (``index_select``'s backward), the background's added to
    the last row, the tables' ``index_add_`` into the rows hit. Same
    arguments and returns as ``first_hit_backward``; each lane's ray
    gradients are the kernel's bits on the card. With ``magnitudes``
    every operand is taken as its absolute value and every difference as
    a sum: the magnitudes of the terms summed into each entry (and each
    lane's ray gradient), the scale to which the same sums taken in
    another order or grouping round."""
    from ..renderer import integrator as itg
    from ..scene.compile import DIFFUSE_LIGHT, KIND_MEDIUM, KIND_SPHERE, \
        KIND_TRIANGLE

    def op(x):
        return abs(x) if magnitudes else x

    def less(x, y):
        return x + y if magnitudes else x - y

    def neg(x):
        return x if magnitudes else -x

    def dot(u, v):
        return op(u[0]) * op(v[0]) + op(u[1]) * op(v[1]) + op(u[2]) * op(v[2])

    def cross(u, v):
        u, v = [op(x) for x in u], [op(x) for x in v]
        return (less(u[1] * v[2], u[2] * v[1]),
                less(u[2] * v[0], u[0] * v[2]),
                less(u[0] * v[1], u[1] * v[0]))

    def add(u, v):
        return tuple(a + b for a, b in zip(u, v))

    def scale(u, k):
        return tuple(op(a) * op(k) for a in u)

    if kind is None:
        kind, idx = bvh.decode_planar_slot(cs.solids, idx)
    hit, attrs, samp, bounce = itg._first_hit(cs, o, d, pixel, sample, seed,
                                              (t, kind, idx))
    zero = torch.zeros_like(t)
    gc, ga, gn = (None if g is None else op(g) for g in
                  (g_planes.get(k) for k in PLANES))
    gc = gc if shader_kind is not None else None

    def col(g, c):
        return zero if g is None else g[:, c]

    mats, feats = cs.materials, cs.features
    want_alb = ga is not None or (gc is not None
                                  and shader_kind != itg.SHADER_NORMAL)
    want_n = gn is not None or (gc is not None
                                and shader_kind != itg.SHADER_ALBEDO)
    tex, light, r_alb = (zero, zero, zero), hit & False, None
    if want_alb:
        eff = itg.resolve_blend(mats, attrs["mat"], rng.uniform4(
            pixel, samp, bounce, rng.P_BLEND_SCATTER, seed), feats)
        row = itg.mat_row(mats, eff)
        r_alb = itg.texel_index(cs.textures, row["albedo_tex"], attrs["uv"])
        tex = tuple(op(x) for x in
                    torch.index_select(texels, 0, r_alb).unbind(1))
        light = row["kind"] == DIFFUSE_LIGHT
    N, T, B = attrs["normal"], attrs["tangent"], attrs["bitangent"]
    front = attrs["front_face"]
    s, mapped = N, None
    if want_n and "normal_maps" in feats:
        eff_n = itg.resolve_blend(mats, attrs["mat"], rng.uniform4(
            pixel, samp, bounce, rng.P_BLEND_NORMAL, seed), feats)
        ntex = itg.mat_row(mats, eff_n)["normal_tex"]
        mapped = hit & (ntex >= 0)
        r_nrm = itg.texel_index(cs.textures, ntex, attrs["uv"])
        tn = tuple(x * 2.0 - 1.0
                   for x in torch.index_select(texels, 0, r_nrm).unbind(1))
        s = soa.where3(mapped, soa.onb_local3(T, B, N, tn), N)
    # the planes' gradients to the albedo texel and the shading normal
    take = ~light | front
    g_alb = [torch.where(take, col(ga, c), 0.0) for c in range(3)]
    g_s = [col(gn, c) for c in range(3)]
    if gc is not None and shader_kind == itg.SHADER_ALBEDO:
        g_alb = [g_alb[c] + torch.where(take, gc[:, c], 0.0)
                 for c in range(3)]
    elif gc is not None and shader_kind == itg.SHADER_NORMAL:
        g_s = [g_s[c] + gc[:, c] for c in range(3)]
    elif gc is not None and shader_kind == itg.SHADER_SIMPLE:
        f = op((s[0] * 1.0 + s[1] * 1.0 + s[2] * -1.0) * 0.5 + 0.75)
        g_alb = [g_alb[c] + torch.where(
            light, torch.where(front, gc[:, c], 0.0), gc[:, c] * f)
            for c in range(3)]
        g_f = (gc[:, 0] * tex[0] + gc[:, 1] * tex[1]
               + gc[:, 2] * tex[2]) * 0.5
        g_s = [torch.where(light, g, g + x)
               for g, x in zip(g_s, (g_f, g_f, neg(g_f)))]
    # through the normal map to the frame and the map's texel
    gs = tuple(g_s)
    g_nrm = None
    if mapped is None:
        gN, gT, gB = gs, (zero,) * 3, (zero,) * 3
    else:
        tn = tuple(op(x) for x in tn)
        gT = tuple(torch.where(mapped, g * tn[0], 0.0) for g in gs)
        gB = tuple(torch.where(mapped, g * tn[1], 0.0) for g in gs)
        gN = tuple(torch.where(mapped, g * tn[2], g) for g in gs)
        g_nrm = [torch.where(mapped, dot(gs, x) * 2.0, 0.0)
                 for x in (T, B, N)]
    g_face = soa.where3(front, gN, tuple(neg(x) for x in gN))
    med = hit & (kind == KIND_MEDIUM) if cs.media else hit & False
    sph = (hit & (kind == KIND_SPHERE) if "spheres" in feats
           else hit & False)
    pl = hit & ~med & ~sph
    g_ray = [zero] * 6
    if "spheres" in feats:
        n_s = cs.solids.sph_attr.shape[0]
        rows = torch.clamp(idx, 0, n_s - 1).long()
        cen = cs.solids.sph_attr.detach()[rows]
        p = attrs["point"]
        n_raw = (p[0] - cen[:, 0], p[1] - cen[:, 1], p[2] - cen[:, 2])
        l1 = torch.sqrt(soa.dot3(n_raw, n_raw))
        inv1 = 1.0 / l1
        tr = (n_raw[2], zero, -n_raw[0])
        l2 = torch.sqrt(soa.dot3(tr, tr))
        inv2 = 1.0 / l2
        tng = scale(tr, inv2)
        # bitangent = cross(n_raw, tng); tng = tr * inv2
        g_a = cross(tng, gB)
        g_tan = add(gT, cross(gB, n_raw))
        g_l2 = neg(dot(g_tan, tr)) * (inv2 * inv2)
        g_s2 = g_l2 / (2.0 * l2)
        g_tr = add(scale(g_tan, inv2), scale(scale(tr, g_s2), 2.0))
        g_a = (g_a[0] + neg(g_tr[2]), g_a[1], g_a[2] + g_tr[0])
        # unit normal = n_raw * inv1
        g_l1 = neg(dot(g_face, n_raw)) * (inv1 * inv1)
        g_s1 = g_l1 / (2.0 * l1)
        g_a = add(g_a, add(scale(g_face, inv1),
                           scale(scale(n_raw, g_s1), 2.0)))
        g_ray = ([torch.where(sph, g, 0.0) for g in g_a]
                 + [torch.where(sph, g * op(t), 0.0) for g in g_a])
        if g_sph is not None:
            vals = torch.zeros((int(sph.sum()), g_sph.shape[1]),
                               dtype=g_sph.dtype, device=g_sph.device)
            vals[:, 0:3] = torch.stack([neg(g) for g in g_a], -1)[sph]
            g_sph.index_add_(0, rows[sph], vals)
    n_pl = cs.solids.pl_attr.shape[0]
    if g_pl is not None and n_pl > 0:
        n_q = cs.solids.qd_q.shape[0]
        slot = torch.clamp(torch.where(kind == KIND_TRIANGLE, n_q + idx, idx),
                           0, n_pl - 1).long()
        vals = torch.zeros((int(pl.sum()), g_pl.shape[1]), dtype=g_pl.dtype,
                           device=g_pl.device)
        for c0, g in ((0, g_face), (11, gT), (14, gB)):
            vals[:, c0:c0 + 3] = torch.stack(g, -1)[pl]
        g_pl.index_add_(0, slot[pl], vals)
    if want_texels:
        if r_alb is not None:
            sums[:-1].index_add_(0, r_alb[hit], torch.stack(g_alb, -1)[hit])
        if g_nrm is not None:
            sums[:-1].index_add_(0, r_nrm[mapped],
                                 torch.stack(g_nrm, -1)[mapped])
    if want_bg:
        sums[-1] += torch.stack([torch.where(hit, 0.0, col(ga, c) + col(gc, c))
                                 .sum() for c in range(3)])
    return tuple(g if w else None for g, w in zip(g_ray, want_ray))
