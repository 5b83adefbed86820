"""The wavefront step's shading and regeneration as two hand-written kernels
(``csrc/step.cu``): S1 ``step_shade`` and S2 ``step_regen``; and S1's
backward, S1B ``step_shade_backward``, which makes S1 the differentiable
route's bounce (``step_shade_grad``).

Replaces the step body of the JAX package's one-program wavefront
(``solstrale_tpu/renderer/integrator.py:765-836``, ``one_step`` inside
``trace_queued``), which XLA fuses: hit attributes, scatter, clamp-fold,
accumulation, regeneration and the draws. The port's plain versions run it
as ~700-1,300 torch kernels a step; with these a step is the scene-hit
kernels (K1-K3 or K4), S1 and S2.

- ``step_shade`` (S1): everything ``integrator.path_step`` does after the
  scene hit, one thread a lane, every draw computed in registers. Plain
  version: ``integrator.shade_plain``.
- ``step_regen`` (S2): the rest of ``integrator._Wavefront.step``: the
  exclusive scan of S1's terminal flags (in the kernel: a single-pass scan
  with decoupled look-back over one status word a block, ``scan_words``),
  accumulation rows, queue positions, camera rays, the pool's write-back
  and the segment and queue counters; without flags, the camera part of
  ``_Wavefront.reset``. Plain versions: ``_Wavefront.regen_plain`` and
  ``_Wavefront.reset_plain``.

- ``step_shade_grad``: S1 as a ``torch.autograd.Function``
  (``StepShadeFn``) for ``integrator.trace(..., differentiable=True)``.
  The forward is S1 in trace's carry form writing new tensors and a record
  of 16 bytes a lane (``shade_record``); the backward is S1B
  (``step_shade_backward``: the carried color's and the fold's gradients
  from the record, one thread a lane, and the texture arena's, the
  background's and the materials' attenuation factors' added into the
  sums of the backward pass, ``GradSums``, which the trace's head,
  ``grad_scene``, hands to autograd once a pass). Plain versions:
  ``shade_plain(..., record=True)`` and ``step_shade_backward_plain``, the
  reverse that autograd runs through ``shade_plain``.

S1's carry form (``step_shade(..., color=carry)``, trace's bounce): S1 also
takes the color each lane carries, keeps it on a lane that does not end
and writes the terminal color on one that does, and parks the direction
of a lane that does not go on; the dict's ``alive`` (alive & ~terminal)
is its ``scat`` flag. The wavefront's pool form leaves color and direction
as they were.

Each wrapper picks by the device of its tensors only: CPU tensors take the
plain version, CUDA tensors launch the kernel or raise. All launch on the
current stream (the wavefront's and the inverse step's CUDA graphs capture
them as they are) and count their launches (``launches``). ``step_shade``
alone builds no autograd graph: on the card it raises where autograd would
want one (``trace``'s differentiable route takes ``step_shade_grad``). The
arguments go to the kernels as one array of pointers and one of int64
values, indexed by the names below, which ``csrc/step.cu``'s enums list in
the same order.
"""
from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import torch

from . import _build, bvh, rng

# S1's flag bits (FLAG_BLEND is K5's bit too)
FLAG_BLEND = 1
FLAG_NORMAL_MAPS = 2
FLAG_SPHERES = 4

# a lane's state, in the pool's order (integrator._Pool.lanes)
LANE_ARRAYS = ("o0", "o1", "o2", "d0", "d1", "d2", "bounce", "acc_len",
               "a0", "a1", "a2", "b0", "b1", "b2", "dead0", "dead1", "dead2",
               "outer")
FLAGS = ("terminal", "miss", "capped", "emit", "scat", "is_pdf")
_COUNTER = ("size", "stride", "value")
# the fold's differentiable arrays, in S1B's argument groups
FOLD_ARRAYS = ("a0", "a1", "a2", "b0", "b1", "b2")

# S1's record for S1B, a (4, R) int32 tensor: the albedo texel row (-1
# where a lane reads none), as f32 bits prob_scat on a lane that scatters
# and the terminal path length on one whose emitter attenuates (else 0),
# and att, and a flag word of these bits (csrc/step.cu's kRec*); channel
# c's at REC_DEAD_T << c and REC_DEAD << c
REC_MISS, REC_EMIT_FRONT, REC_SCAT, REC_PDF, REC_TERMINAL = 1, 2, 4, 8, 16
REC_DEAD_T = 32    # the channel was dead at the terminal color (dead_t)
REC_DEAD = 256     # the channel is dead after this level's fold
REC_ATTEN = 2048   # the lane's emitter attenuates (its factor > 0)
# where REC_ATTEN is set, the word's bits from REC_MAT_SHIFT up hold the
# effective material's row, so a record takes scenes of at most
# REC_MAT_MAX materials
REC_MAT_SHIFT = 12
REC_MAT_MAX = 1 << 19
# the column of the attenuation factor in ``Materials.attr``
ATTEN_COL = 5

SHADE_PTRS = (("cam", "sph", "pln", "mats", "tex_attr", "texels", "lights",
               "med_mat", "pl_row", "small", "t", "kind", "idx", "pixel",
               "sample", "seed", "active", "qpos", "color") + FLAGS
              + tuple("in_" + n for n in LANE_ARRAYS)
              + tuple("out_" + n for n in LANE_ARRAYS) + ("bg", "rec",
                                                          "carry"))
SHADE_INTS = (("n", "max_depth", "flags", "n_sph", "n_pl", "n_q", "n_mat",
               "n_tex", "n_texels", "n_light", "n_media", "total_q", "stage")
              + tuple(f"{c}_{k}" for c in ("pixel", "sample", "seed")
                      for k in _COUNTER))
REGEN_PTRS = (("cam", "qpos", "pixel", "sample", "terminal", "color",
               "accum", "next_q", "segments", "ticket", "status", "start",
               "pix_ids") + tuple("pool_" + n for n in LANE_ARRAYS))
REGEN_INTS = ("n", "total_q", "n_pix", "npix_magic", "npix_sh1", "npix_sh2",
              "width", "height", "swizzle", "tile_wl", "tile_hl", "n_status",
              "seed", "reset")
# S2's block (csrc/step.cu kRegenThreads): its scan keeps one status word a
# block (``scan_words``)
REGEN_THREADS = 256
# S1 stages the small tables (camera, materials, texture attributes,
# lights: ``StepTables.small``) in shared memory once a block where they
# fit in this many bytes (``stage_floats``); a scene with more (about 300
# materials) reads them from device memory. At 8 blocks an SM, 12 KB a
# block leaves shared memory to spare (PERF.md §6).
STAGE_MAX_BYTES = 12288
BACK_PTRS = (("rec", "texels", "bg", "g_color", "g_texels", "g_bg",
              "g_mats", "g_carry")
             + tuple("in_" + n for n in FOLD_ARRAYS)
             + tuple("g_out_" + n for n in FOLD_ARRAYS)
             + tuple("g_in_" + n for n in FOLD_ARRAYS))
BACK_INTS = ("n",)


@dataclass(frozen=True)
class StepTables:
    """S1's and S2's scene tables, packed once per compiled scene
    (``step_tables``), contiguous on the scene's device:

    - ``small``: one f32 buffer holding the small tables below, each from
      a 16-byte boundary (S1 stages it in shared memory whole), and
      ``cam``, ``mats``, ``tex_attr``, ``lights`` views of it:
      ``cam`` (24,) and ``lights`` (L, 20) K5's
      (``megakernel.camera_table``, ``light_table``), ``mats`` (Mt, 9) and
      ``tex_attr`` (T, 3) ``Materials.attr`` and ``TexArena.attr``;
    - ``sph`` (S, 8) f32: ``Solids.sph_attr`` (center, radius, mat) padded;
    - ``pln`` (P, 28) f32: ``Solids.pl_attr`` padded (16-byte rows);
    - ``texels`` (N, 3) f32: ``TexArena.pixels``;
    - ``med_mat`` (M,) int32: each medium's phase material;
    - ``pl_row`` (P,) int32: K1's planar slot -> its ``pln`` row (the
      decode of ``ops.bvh.decode_planar_slot``, clamped as S1 clamps);
    - ``n_q``: the quads, which come before the triangles in ``pln``;
    - ``flags``: ``FLAG_*`` of the scene's features."""

    small: torch.Tensor
    cam: torch.Tensor
    sph: torch.Tensor
    pln: torch.Tensor
    mats: torch.Tensor
    tex_attr: torch.Tensor
    texels: torch.Tensor
    lights: torch.Tensor
    med_mat: torch.Tensor
    pl_row: torch.Tensor
    n_q: int
    flags: int


def feature_flags(features):
    """The ``FLAG_*`` bits of a compiled scene's ``features``: the code
    paths the plain versions skip when the scene cannot take them."""
    return ((FLAG_BLEND if "blend" in features else 0)
            | (FLAG_NORMAL_MAPS if "normal_maps" in features else 0)
            | (FLAG_SPHERES if "spheres" in features else 0))


def _packed(parts, dev):
    """One f32 buffer of ``parts`` (f32 tensors), each from a multiple of 4
    floats, and a view of each part in it."""
    offsets, n = [], 0
    for x in parts:
        offsets.append(n)
        n += -(-x.numel() // 4) * 4
    buf = torch.zeros((max(n, 4),), dtype=torch.float32, device=dev)
    views = []
    for x, off in zip(parts, offsets):
        view = buf[off:off + x.numel()].view(x.shape)
        view.copy_(x)
        views.append(view)
    return buf, views


def slot_rows(solids, n_q):
    """K1's planar slot -> its row of the planar table, (P,) int32: a
    triangle's after the ``n_q`` quads, clamped to the table."""
    row = torch.where(solids.pl_is_tri, n_q + solids.pl_idx.long(),
                      solids.pl_idx.long())
    n_pl = solids.pl_attr.shape[0]
    return torch.clamp(row, 0, max(n_pl - 1, 0)).to(torch.int32).contiguous()


def pack_tables(cs):
    """StepTables of a compiled scene."""
    from ..renderer.megakernel import camera_table, light_table

    s, dev = cs.solids, cs.device

    def padded(x, cols):
        x = x.to(torch.float32)
        return torch.cat([x, x.new_zeros((x.shape[0], cols - x.shape[1]))],
                         1).contiguous()

    med_mat = (torch.stack([m.mat for m in cs.media]) if cs.media else
               torch.zeros((0,), device=dev))
    n_q = s.qd_q.shape[0]
    small, (cam, mats, tex_attr, lights) = _packed(
        [camera_table(cs), cs.materials.attr.to(torch.float32),
         cs.textures.attr.to(torch.float32), light_table(cs)], dev)
    return StepTables(
        small=small, cam=cam, sph=padded(s.sph_attr, 8),
        pln=padded(s.pl_attr, 28), mats=mats, tex_attr=tex_attr,
        texels=cs.textures.pixels.to(torch.float32).contiguous(),
        lights=lights, med_mat=med_mat.to(torch.int32).contiguous(),
        pl_row=slot_rows(s, n_q), n_q=n_q, flags=feature_flags(cs.features))


def stage_floats(tab):
    """The floats of ``tab.small`` that S1 stages in shared memory: all of
    them where they fit in ``STAGE_MAX_BYTES``, else none (S1 then reads
    the small tables from device memory)."""
    n = tab.small.numel()
    return n if n * 4 <= STAGE_MAX_BYTES else 0


def step_tables(cs):
    """The StepTables of a compiled scene, packed on first use."""
    from ..renderer.integrator import per_scene

    return per_scene(cs, "step", lambda: pack_tables(cs))


def lane_arrays(st):
    """The 18 (R,) lane arrays (``LANE_ARRAYS``) of a dict with path_step's
    ``o``, ``d``, ``bounce``, ``acc_len`` and ``fold``."""
    A, B, dead, outer = st["fold"]
    return [*st["o"], *st["d"], st["bounce"], st["acc_len"], *A, *B, *dead,
            outer]


def _new_outputs(r, dev):
    """S1's outputs as path_step's dict, in new tensors: the fold's A and B
    each in a tensor of its own (an autograd Function's differentiable
    outputs, on the differentiable route), the rest views of two blocks."""
    f = torch.empty((7, r), dtype=torch.float32, device=dev)
    b = torch.empty((10, r), dtype=torch.bool, device=dev)
    A, B = (tuple(torch.empty((r,), dtype=torch.float32, device=dev)
                  for _ in range(3)) for _ in range(2))
    out = dict(zip(FLAGS, b[4:].unbind(0)))
    out.update(color=torch.empty((r, 3), dtype=torch.float32, device=dev),
               o=tuple(f[0:3].unbind(0)), d=tuple(f[3:6].unbind(0)),
               bounce=torch.empty((r,), dtype=torch.int32, device=dev),
               acc_len=f[6], fold=(A, B, tuple(b[0:3].unbind(0)), b[3]))
    return out


def needs_grad(cs, *args, skip=()):
    """Whether autograd would record a graph through the step: grad mode
    on, and a tensor among ``args`` (one level into tuples) or among the
    compiled scene's tables (its dataclass fields, nested) requires grad;
    the tensors in ``skip`` (by identity) do not count."""
    if not torch.is_grad_enabled():
        return False

    def walk(x):
        if isinstance(x, torch.Tensor):
            return x.requires_grad and not any(x is y for y in skip)
        if isinstance(x, (tuple, list)):
            return any(walk(v) for v in x)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return any(walk(getattr(x, f.name))
                       for f in dataclasses.fields(x))
        return False

    return walk(args) or walk(cs)


def _check(name, x, dtype, r, dev):
    if not isinstance(x, torch.Tensor) or x.device != dev or \
            x.dtype != dtype or x.shape != (r,) or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous ({r},) {dtype} "
                         f"tensor on {dev}")


def _check_table(name, x, shape, dev, dtype=torch.float32):
    if not isinstance(x, torch.Tensor) or x.device != dev or \
            x.dtype != dtype or tuple(x.shape) != shape or \
            not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {shape} {dtype} "
                         f"tensor on {dev}")


def _counter_args(x, r, dev):
    """A draw counter (pixel, sample or seed) as (tensor or None, (size,
    stride, value)), the draw kernel's form (``rng.kernel_counter``)."""
    t, stride, value = rng.kernel_counter(x, torch.Size((r,)), dev)
    if t is None:
        return None, (0, 0, value)
    return t, (t.element_size(), stride, 0)


def _add_counters(ptrs, ints, counters, r, dev):
    """Each (name, draw counter) of ``counters`` into a kernel's argument
    arrays as the kernels take it (``_counter_args``): its tensor's pointer
    under the name, its (size, stride, value) under ``name_size`` ...
    Returns the counters' tensors, which the caller holds until the launch
    (one may be a new tensor)."""
    held = []
    for name, x in counters:
        t_c, vals = _counter_args(x, r, dev)
        held.append(t_c)
        if t_c is not None:
            ptrs[name] = _build.ptr(t_c)
        ints.update(zip((f"{name}_{k}" for k in _COUNTER), vals))
    return held


def _launch(fn, names_p, names_v, ptrs, ints, stream):
    """Call a kernel's C entry (the step kernels', ``ops.first_hit``'s) with
    its pointer and int64 arrays, each filled by name (a name left out is a
    null pointer)."""
    unknown = (set(ptrs) - set(names_p)) | (set(ints) - set(names_v))
    if unknown:
        raise KeyError(f"kernel arguments: unknown {sorted(unknown)}")
    p = (ctypes.c_void_p * len(names_p))(*(ptrs.get(n) for n in names_p))
    v = (ctypes.c_longlong * len(names_v))(*(int(ints.get(n, 0))
                                             for n in names_v))
    return fn(p, v, stream)


def step_shade(cs, t, kind, idx, o, d, bounce, acc_len, fold, pixel, sample,
               seed, active, max_depth, out=None, color=None):
    """S1: the rest of ``path_step`` after the scene hit, in one launch
    (``integrator.shade_plain`` says what it computes). ``t`` (R,) f32,
    ``kind`` and ``idx`` (R,) int32 as the hit kernels give them, or
    ``kind`` None and ``idx`` K1's planar slot (a BVH scene without spheres
    or media: S1 decodes it as ``bvh_closest_hit`` does). The lane state is
    path_step's: component tuples of (R,) f32, ``bounce`` (R,) int32, the
    fold's flags (R,) bool. Counters: ``pixel`` an (R,) int tensor,
    ``sample`` and ``seed`` ints or tensors (``rng.kernel_counter``).
    ``active`` is an (R,) bool tensor, or (qpos, total_q): the lanes whose
    queue position ((R,) int64) is below total_q. ``out``: a dict of
    tensors to write (path_step's keys; a flag it lacks is not written),
    which may hold the input state itself (the wavefront updates its pool
    in place), or None for new tensors. ``color``: the (R, 3) f32 color
    the lanes carry, for trace's carry form (with ``active`` a bool
    tensor; the module's docstring). Returns the dict."""
    dev = t.device
    if dev.type == "cpu":
        return _step_shade_plain(cs, t, kind, idx, o, d, bounce, acc_len,
                                 fold, pixel, sample, seed, active,
                                 max_depth, out, color=color)
    if dev.type != "cuda":
        raise ValueError(f"step_shade: unsupported device {dev}")
    if needs_grad(cs, o, d, acc_len, fold, color):
        raise ValueError("step_shade: S1 alone builds no autograd graph; a "
                         "render that autograd runs through takes the "
                         "differentiable route (integrator.trace(..., "
                         "differentiable=True): S1 with its backward S1B)")
    out = shade_kernel(_build.library().step_shade_launch, cs, t, kind, idx,
                       o, d, bounce, acc_len, fold, pixel, sample, seed,
                       active, max_depth, out, _build.stream_of(t),
                       carry=color)
    step_shade.launches += 1
    return out


step_shade.launches = 0


def shade_kernel(fn, cs, t, kind, idx, o, d, bounce, acc_len, fold, pixel,
                 sample, seed, active, max_depth, out, stream, texels=None,
                 bg=None, rec=None, carry=None):
    """S1's launch through its C entry ``fn`` (``step_shade_launch``) on
    ``stream``: the argument checks and the two argument arrays. ``texels``
    ((N, 3) f32) and ``bg`` ((3,) f32): the arena and background read in
    place of the packed tables' (the differentiable route's own inputs);
    ``rec``: a (4, R) int32 tensor for S1's record; ``carry``: the (R, 3)
    f32 carried color of the carry form (``active`` a bool tensor). Returns
    the output dict, whose ``alive`` is its ``scat`` in the carry form."""
    dev = t.device
    r = t.shape[0]
    tab = step_tables(cs)
    if tab.cam.device != dev:
        raise ValueError("step_shade: the scene's tables are not on the "
                         "rays' device")
    state = [*o, *d, bounce, acc_len, *[x for part in fold[:3]
                                        for x in part], fold[3]]
    dtypes = [torch.float32] * 6 + [torch.int32, torch.float32] + \
        [torch.float32] * 6 + [torch.bool] * 4
    for name, x, dtype in zip(LANE_ARRAYS, state, dtypes):
        _check(f"step_shade: {name}", x, dtype, r, dev)
    _check("step_shade: t", t, torch.float32, r, dev)
    _check("step_shade: idx", idx, torch.int32, r, dev)
    if kind is not None:
        _check("step_shade: kind", kind, torch.int32, r, dev)
    elif tab.pl_row.shape[0] == 0:
        raise ValueError("step_shade: a planar slot needs a planar table")
    if out is None:
        out = _new_outputs(r, dev)
    outs = lane_arrays(out)
    for name, x, dtype in zip(LANE_ARRAYS, outs, dtypes):
        _check(f"step_shade: out {name}", x, dtype, r, dev)
    color = out["color"]
    if color.shape != (r, 3) or color.dtype != torch.float32 or \
            color.device != dev or not color.is_contiguous():
        raise ValueError("step_shade: color must be a contiguous (R, 3) "
                         "float32 tensor")
    texels = tab.texels if texels is None else texels
    _check_table("step_shade: texels", texels, (texels.shape[0], 3), dev)
    p = _build.ptr
    ptrs = dict(cam=p(tab.cam), sph=p(tab.sph), pln=p(tab.pln),
                mats=p(tab.mats), tex_attr=p(tab.tex_attr),
                texels=p(texels), lights=p(tab.lights),
                med_mat=p(tab.med_mat), pl_row=p(tab.pl_row),
                small=p(tab.small), t=p(t), idx=p(idx), color=p(color))
    if kind is not None:
        ptrs["kind"] = p(kind)
    if isinstance(active, tuple):
        if carry is not None or rec is not None:
            raise ValueError("step_shade: the carry form and the record take "
                             "a bool active")
        qpos, total_q = active
        _check("step_shade: qpos", qpos, torch.int64, r, dev)
        ptrs["qpos"] = p(qpos)
    else:
        _check("step_shade: active", active, torch.bool, r, dev)
        ptrs["active"], total_q = p(active), 0
    if carry is not None:
        _check_table("step_shade: color carry", carry, (r, 3), dev)
        if out.get("scat") is None:
            raise ValueError("step_shade: the carry form writes scat (alive)")
        ptrs["carry"] = p(carry)
    if bg is not None:
        _check_table("step_shade: bg", bg, (3,), dev)
        ptrs["bg"] = p(bg)
    if rec is not None:
        _check_table("step_shade: rec", rec, (4, r), dev, torch.int32)
        ptrs["rec"] = p(rec)
    ints = dict(n=r, max_depth=max_depth, flags=tab.flags,
                n_sph=tab.sph.shape[0], n_pl=tab.pln.shape[0], n_q=tab.n_q,
                n_mat=tab.mats.shape[0], n_tex=tab.tex_attr.shape[0],
                n_texels=texels.shape[0], n_light=tab.lights.shape[0],
                n_media=tab.med_mat.shape[0], total_q=total_q,
                stage=stage_floats(tab))
    held = _add_counters(ptrs, ints, (("pixel", pixel), ("sample", sample),
                                      ("seed", seed)), r, dev)
    for k in FLAGS:
        if out.get(k) is not None:
            _check(f"step_shade: {k}", out[k], torch.bool, r, dev)
            ptrs[k] = p(out[k])
    for name, x in zip(LANE_ARRAYS, state):
        ptrs["in_" + name] = p(x)
    for name, x in zip(LANE_ARRAYS, outs):
        ptrs["out_" + name] = p(x)
    _build.check(_launch(fn, SHADE_PTRS, SHADE_INTS, ptrs, ints, stream),
                 "step_shade")
    if carry is not None:
        out["alive"] = out["scat"]
    return out


def _step_shade_plain(cs, t, kind, idx, o, d, bounce, acc_len, fold, pixel,
                      sample, seed, active, max_depth, out, record=False,
                      color=None):
    """S1's CPU side: ``integrator.shade_plain``, copied into ``out`` when
    given."""
    from ..renderer.integrator import shade_plain

    if kind is None:
        kind, idx = bvh.decode_planar_slot(cs.solids, idx)
    if isinstance(active, tuple):
        if color is not None:
            raise ValueError("step_shade: the carry form takes a bool active")
        active = active[0] < active[1]
    st = shade_plain(cs, o, d, t, kind, idx, bounce, acc_len, fold, pixel,
                     sample, seed, active, max_depth, record=record,
                     color=color)
    if out is None:
        return st
    if color is not None and out.get("scat") is None:
        raise ValueError("step_shade: the carry form writes scat (alive)")
    for dst, src in zip(lane_arrays(out), lane_arrays(st)):
        dst.copy_(src)
    for k in ("color",) + FLAGS:
        if out.get(k) is not None:
            out[k].copy_(st[k])
    if color is not None:
        out["alive"] = out["scat"]
    return out


def shade_record(row, prob_scat, att, miss, emit_front, scat, pdf,
                 terminal, dead_t, dead, atten, term_acc, mat):
    """S1's record of a bounce for its backward, as ``csrc/step.cu`` writes
    it: a (4, R) int32 tensor of the albedo texel row (-1: none read), as
    f32 bits the scatter level's pdf weight ``prob_scat`` where ``scat``,
    else the terminal path length ``term_acc`` where ``atten`` (the
    lane's emitter attenuates), else 0, and the terminal attenuation
    ``att``, and the flag word (``REC_*``; ``dead_t`` and ``dead`` are
    per-channel tuples; where ``atten``, the effective material ``mat``
    from ``REC_MAT_SHIFT`` up)."""
    bits = [(miss, REC_MISS), (emit_front, REC_EMIT_FRONT), (scat, REC_SCAT),
            (pdf, REC_PDF), (terminal, REC_TERMINAL), (atten, REC_ATTEN)]
    bits += [(dead_t[c], REC_DEAD_T << c) for c in range(3)]
    bits += [(dead[c], REC_DEAD << c) for c in range(3)]
    word = sum(b.to(torch.int32) * k for b, k in bits)
    word = word + torch.where(atten, mat.to(torch.int32) << REC_MAT_SHIFT, 0)
    r1 = torch.where(scat, prob_scat, torch.where(atten, term_acc, 0.0))
    return torch.stack([row, r1.view(torch.int32), att.view(torch.int32),
                        word])


class GradSums:
    """The texture arena's, the background's and the materials'
    attenuation gradients summed over one backward pass of a
    differentiable trace: one (N + 1, 3) buffer, the arena's N rows, then
    the background, and one of the material table's shape, (M, 9), whose
    attenuation column (``ATTEN_COL``) takes the sums. The first S1B of a
    pass that wants one makes it, zeroed (``buffer`` / ``mat_buffer``: the
    pass's one fill of each, which a captured inverse step replays), every
    S1B of the pass adds into it, and the trace's head (``_GradSink``)
    hands them to autograd once (``take``), as the JAX transpose carries
    one cotangent for the arena. A pass is autograd's graph task, so a
    second backward over a retained graph, or one that stops short of the
    head, starts from zero; a gradient handed out is never added to
    again."""

    def __init__(self, arena, bg, attr):
        self.rows = arena.shape[0]
        self.dtype, self.device = arena.dtype, arena.device
        self.mat_shape, self.mat_dtype = tuple(attr.shape), attr.dtype
        self.want_texels = arena.requires_grad
        self.want_bg = bg.requires_grad
        self.want_atten = attr.requires_grad
        self._buf = self._mat = self._task = None

    def _this_pass(self):
        task = torch._C._current_graph_task_id()
        if self._task != task:
            self._buf = self._mat = None
            self._task = task

    def buffer(self):
        """This pass's arena and background buffer, made and zeroed at its
        first use."""
        self._this_pass()
        if self._buf is None:
            self._buf = torch.zeros((self.rows + 1, 3), dtype=self.dtype,
                                    device=self.device)
        return self._buf

    def mat_buffer(self):
        """This pass's (M, 9) material buffer, made and zeroed at its first
        use."""
        self._this_pass()
        if self._mat is None:
            self._mat = torch.zeros(self.mat_shape, dtype=self.mat_dtype,
                                    device=self.device)
        return self._mat

    def take(self):
        """This pass's (arena, background, material table) gradients, (N,
        3) and (3,) views of its buffer and the (M, 9) buffer, each None
        where no S1B of it added; the next use starts new buffers."""
        mine = self._task == torch._C._current_graph_task_id()
        buf, mat = (self._buf, self._mat) if mine else (None, None)
        self._buf = self._mat = self._task = None
        return (None, None, mat) if buf is None else (buf[:-1], buf[-1], mat)


def _plus(a, b):
    return b if a is None else a if b is None else a + b


class _GradSink(torch.autograd.Function):
    """A differentiable trace's head: the arena, the background and the
    material table passed on as views, and in the backward their gradients
    from the pass's ``GradSums`` (the trace's S1B calls add into it and
    return none of their own), plus any that reached the views another way
    (a torch op, as the plain route's texel gather). Autograd runs it after
    every S1B of the trace, whose inputs the views are."""

    @staticmethod
    def forward(ctx, sums, arena, bg, attr):
        ctx.grad_sums = sums
        ctx.set_materialize_grads(False)
        return arena.view_as(arena), bg.view_as(bg), attr.view_as(attr)

    @staticmethod
    def backward(ctx, g_arena, g_bg, g_attr):
        sums = ctx.grad_sums.take()
        need = ctx.needs_input_grad
        return (None,) + tuple(_plus(g, s) if n else None for g, s, n in
                               zip((g_arena, g_bg, g_attr), sums, need[1:]))


def _fresh_mats(tab, attr):
    """``tab`` with its small tables in a new buffer whose material table
    is ``attr`` as it is now (a leaf that an optimiser steps in place is
    read as stepped)."""
    small = tab.small.detach().clone()

    def at(v):
        off = v.storage_offset() - tab.small.storage_offset()
        return small[off:off + v.numel()].view(v.shape)

    mats = at(tab.mats)
    mats.copy_(attr.detach())
    return dataclasses.replace(tab, small=small, cam=at(tab.cam), mats=mats,
                               tex_attr=at(tab.tex_attr),
                               lights=at(tab.lights))


def grad_scene(cs):
    """``cs`` for one differentiable trace: a copy whose arena, background
    and material table are ``_GradSink``'s views of the scene's, which
    carry the trace's ``GradSums`` (``sums_of``), sharing the scene's
    packed tables (S1's with the view as its texels and, where the
    material table requires grad, its values of now; and the media's),
    which are packed for ``cs`` at its first trace, so that a trace
    captured after a warm-up one packs nothing (a pack reads back to the
    host). ``cs`` itself where grad mode is off or none of the three
    requires grad."""
    from ..renderer.integrator import (media_tables, per_scene,
                                       share_geometry_tables)

    arena, bg, attr = cs.textures.pixels, cs.bg_color, cs.materials.attr
    if not (torch.is_grad_enabled() and (
            arena.requires_grad or bg.requires_grad or attr.requires_grad)):
        return cs
    tab = step_tables(cs)
    media_tables(cs)
    view, bg_view, attr_view = _GradSink.apply(GradSums(arena, bg, attr),
                                               arena, bg, attr)
    out = dataclasses.replace(
        cs, textures=dataclasses.replace(cs.textures, pixels=view),
        bg_color=bg_view,
        materials=dataclasses.replace(cs.materials, attr=attr_view))
    share_geometry_tables(cs, out)
    if attr.requires_grad:
        tab = _fresh_mats(tab, attr)
    per_scene(out, "step", lambda: dataclasses.replace(
        tab, texels=view.to(torch.float32).contiguous()))
    return out


def sums_of(arena):
    """The ``GradSums`` an arena from ``grad_scene`` carries, else None."""
    return getattr(arena.grad_fn, "grad_sums", None)


def step_shade_grad(cs, t, kind, idx, o, d, bounce, acc_len, fold, pixel,
                    sample, seed, active, max_depth, color):
    """``step_shade`` in the carry form (``color``: the (R, 3) carried
    color) on the differentiable route: S1, and S1B in the backward
    (``StepShadeFn``), with path_step's arguments and dict (new tensors).
    Gradients reach the carried color, the fold's A and B, the texture
    arena (``cs.textures.pixels``: albedos, texture maps and emitter
    radiance), the background (``cs.bg_color``) and the attenuation
    factors of the material table (``cs.materials.attr``'s column
    ``ATTEN_COL``; its other columns get 0); the last three through the
    sums of the arena's ``grad_scene`` (``trace`` makes one a trace; a
    scene without one gets one for this call). Raises, on every device,
    where a lane input or another table of the scene requires grad. Where
    none of them requires grad (or grad mode is off) it is
    ``step_shade``."""
    A, B, dead, outer = fold
    arena, bg, attr = cs.textures.pixels, cs.bg_color, cs.materials.attr
    if needs_grad(cs, t, o, d, acc_len, skip=(arena, bg, attr)):
        raise ValueError("step_shade_grad: gradients reach only the carried "
                         "color, the fold, the texture arena "
                         "(cs.textures.pixels), the background (cs.bg_color) "
                         "and the attenuation factors of the material table "
                         "(cs.materials.attr); a lane input or another scene "
                         "table requires grad")
    if not (torch.is_grad_enabled() and any(
            x.requires_grad for x in (arena, bg, attr, color, *A, *B))):
        return step_shade(cs, t, kind, idx, o, d, bounce, acc_len, fold,
                          pixel, sample, seed, active, max_depth, color=color)
    if (arena.requires_grad or bg.requires_grad or attr.requires_grad) and \
            sums_of(arena) is None:
        cs = grad_scene(cs)
        arena, bg, attr = cs.textures.pixels, cs.bg_color, cs.materials.attr
    outs = StepShadeFn.apply(cs, (t, kind, idx, o, d, bounce, acc_len, dead,
                                  outer, pixel, sample, seed, active,
                                  max_depth, sums_of(arena)), arena, bg,
                             attr, color, *A, *B)
    out = dict(zip(FLAGS, outs[19:]))
    out.update(color=outs[0], o=outs[7:10], d=outs[10:13], bounce=outs[13],
               acc_len=outs[14], fold=(outs[1:4], outs[4:7], outs[15:18],
                                       outs[18]), alive=out["scat"])
    return out


class StepShadeFn(torch.autograd.Function):
    """S1 in the carry form with S1B as its backward. Inputs: the compiled
    scene, the rest of path_step's arguments and the pass's ``GradSums``
    (or None: no scene table wants a gradient) in one tuple, then the
    differentiable ones: the arena and the background (``grad_scene``'s
    views), which the kernels read from these tensors, not from the
    scene's packed tables (an inverse step swaps its own leaf arena in),
    the material table (its view, which S1 reads packed), the carried
    color, and the fold's A and B (3 each). Outputs: color, A', B'
    (differentiable), then o, d, bounce, acc_len, dead, outer and the six
    flags (not). The record (16 bytes a lane) and the fold's A and B are
    saved for the backward, which reads nothing back to the host; it adds
    the arena's, the background's and the attenuation factors' gradients
    into the sums and returns none for them (the sums' sink does)."""

    @staticmethod
    def forward(ctx, cs, call, arena, bg, attr, color, *ab):
        (t, kind, idx, o, d, bounce, acc_len, dead, outer, pixel, sample,
         seed, active, max_depth, sums) = call
        out, rec = shade_with_record(
            cs, t, kind, idx, o, d, bounce, acc_len,
            (ab[:3], ab[3:], dead, outer), pixel, sample, seed, active,
            max_depth, arena, bg, color=color)
        ctx.save_for_backward(rec, arena, bg, *ab)
        ctx.sums = sums
        ctx.set_materialize_grads(False)
        A, B, dead, outer = out["fold"]
        rest = (*out["o"], *out["d"], out["bounce"], out["acc_len"], *dead,
                outer, *(out[k] for k in FLAGS))
        ctx.mark_non_differentiable(*rest)
        return (out["color"], *A, *B) + rest

    @staticmethod
    def backward(ctx, g_color, *g_out):
        rec, arena, bg, *ab = ctx.saved_tensors
        sums, need = ctx.sums, ctx.needs_input_grad
        want_texels = sums is not None and sums.want_texels
        want_bg = sums is not None and sums.want_bg
        want_atten = sums is not None and sums.want_atten
        g_carry = (torch.empty_like(g_color)
                   if need[5] and g_color is not None else None)
        g_ab = step_shade_backward(
            rec, ab, arena, bg, g_color, g_out[:6],
            sums.buffer() if want_texels or want_bg else None, want_texels,
            want_bg, need[6:12], g_carry=g_carry,
            g_mats=sums.mat_buffer() if want_atten else None)
        return (None, None, None, None, None, g_carry, *g_ab)


def shade_with_record(cs, t, kind, idx, o, d, bounce, acc_len, fold, pixel,
                      sample, seed, active, max_depth, arena=None, bg=None,
                      color=None):
    """S1 with its record for S1B: (path_step's dict in new tensors, the
    (4, R) int32 record). ``arena`` and ``bg`` (default: the scene's) are
    the texels and background it reads; ``color``: the carried color of
    the carry form. One S1 launch on the card (counted in
    ``step_shade.launches``), ``shade_plain(..., record=True)`` on the
    CPU."""
    arena = cs.textures.pixels if arena is None else arena
    bg = cs.bg_color if bg is None else bg
    if cs.materials.attr.shape[0] > REC_MAT_MAX:
        raise ValueError(f"step_shade_grad: S1's record takes at most "
                         f"{REC_MAT_MAX} materials")
    dev = t.device
    if dev.type == "cpu":
        out = _step_shade_plain(cs, t, kind, idx, o, d, bounce, acc_len, fold,
                                pixel, sample, seed, active, max_depth, None,
                                record=True, color=color)
        return out, out.pop("record")
    if dev.type != "cuda":
        raise ValueError(f"step_shade_grad: unsupported device {dev}")
    r = t.shape[0]
    rec = torch.empty((4, r), dtype=torch.int32, device=dev)
    out = shade_kernel(_build.library().step_shade_launch, cs, t, kind, idx,
                       o, d, bounce, acc_len, fold, pixel, sample, seed,
                       active, max_depth,
                       _new_outputs(r, dev),
                       _build.stream_of(t), texels=arena, bg=bg, rec=rec,
                       carry=color)
    step_shade.launches += 1
    return out, rec


def step_shade_backward(rec, ab, texels, bg, g_color, g_ab_out, sums,
                        want_texels=True, want_bg=True, want_ab=(True,) * 6,
                        g_carry=None, g_mats=None):
    """S1B: the gradients of one S1 call's inputs (in the carry form) from
    its record ``rec`` ((4, R) int32), its fold inputs ``ab`` (A then B,
    six (R,) f32), the arena ``texels`` ((N, 3) f32) and ``bg`` ((3,)
    f32), and the upstream gradients of its color ((R, 3)) and of its fold
    outputs A' and B' (six; None is a zero gradient). Adds the arena's
    gradient into ``sums[:N]`` and the background's into ``sums[N]``
    (``sums``: an (N + 1, 3) f32 tensor, ``GradSums.buffer``; None where
    neither is wanted), each where its ``want_*`` is true, and the
    materials' attenuation factors' into ``g_mats[:, ATTEN_COL]`` (an (M,
    9) f32 tensor, ``GradSums.mat_buffer``, or None); writes the carried
    color's gradient into ``g_carry`` ((R, 3) f32, or None: not wanted);
    returns the six fold inputs' gradients (None where not wanted). One
    launch on the card, which allocates only those six;
    ``step_shade_backward_plain`` on the CPU."""
    dev = rec.device
    if dev.type == "cpu":
        return step_shade_backward_plain(rec, ab, texels, bg, g_color,
                                         g_ab_out, sums, want_texels,
                                         want_bg, want_ab, g_carry, g_mats)
    if dev.type != "cuda":
        raise ValueError(f"step_shade_backward: unsupported device {dev}")
    out = backward_kernel(_build.library().step_shade_backward_launch, rec,
                          ab, texels, bg, g_color, g_ab_out, sums,
                          want_texels, want_bg, want_ab,
                          _build.stream_of(rec), g_carry, g_mats)
    step_shade_backward.launches += 1
    return out


step_shade_backward.launches = 0


def backward_kernel(fn, rec, ab, texels, bg, g_color, g_ab_out, sums,
                    want_texels, want_bg, want_ab, stream, g_carry=None,
                    g_mats=None):
    """S1B's launch through its C entry ``fn``
    (``step_shade_backward_launch``) on ``stream``: the checks, the fold's
    new gradient tensors and the two argument arrays; the arena's, the
    background's and the attenuation factors' gradients go into ``sums``
    and ``g_mats``, the carried color's into ``g_carry``."""
    dev = rec.device
    r = rec.shape[1]
    n = texels.shape[0]
    _check_table("step_shade_backward: rec", rec, (4, r), dev, torch.int32)
    _check_table("step_shade_backward: texels", texels, (n, 3), dev)
    _check_table("step_shade_backward: bg", bg, (3,), dev)
    p = _build.ptr
    keep = []   # the upstream gradients made contiguous, held to the launch
    ptrs = dict(rec=p(rec), texels=p(texels), bg=p(bg))
    if g_color is not None:
        g_color = g_color.contiguous()
        _check_table("step_shade_backward: g_color", g_color, (r, 3), dev)
        keep.append(g_color)
        ptrs["g_color"] = p(g_color)
    if want_texels or want_bg:
        _check_table("step_shade_backward: sums", sums, (n + 1, 3), dev)
        if want_texels:
            ptrs["g_texels"] = p(sums)
        if want_bg:
            ptrs["g_bg"] = p(sums[n])
    if g_mats is not None:
        _check_table("step_shade_backward: g_mats", g_mats,
                     (g_mats.shape[0], 9), dev)
        ptrs["g_mats"] = p(g_mats)
    if g_carry is not None:
        _check_table("step_shade_backward: g_carry", g_carry, (r, 3), dev)
        ptrs["g_carry"] = p(g_carry)
    g_ab = [torch.empty_like(x) if w else None for x, w in zip(ab, want_ab)]
    for name, x, g, gi in zip(FOLD_ARRAYS, ab, g_ab_out, g_ab):
        _check(f"step_shade_backward: {name}", x, torch.float32, r, dev)
        ptrs["in_" + name] = p(x)
        if g is not None:
            g = g.contiguous()
            _check(f"step_shade_backward: g_out_{name}", g, torch.float32,
                   r, dev)
            keep.append(g)
            ptrs["g_out_" + name] = p(g)
        if gi is not None:
            ptrs["g_in_" + name] = p(gi)
    _build.check(_launch(fn, BACK_PTRS, BACK_INTS, ptrs, dict(n=r), stream),
                 "step_shade_backward")
    return tuple(g_ab)


def _min_grads(x, y, g):
    """torch.minimum's backward (derivatives.yaml): the gradient ``g`` of
    min(x, y) to x and to y, halved at a tie, whole to both where either is
    NaN."""
    h = torch.where(x == y, g / 2, g)
    return torch.where(x > y, 0.0, h), torch.where(x < y, 0.0, h)


def step_shade_backward_plain(rec, ab, texels, bg, g_color, g_ab_out, sums,
                              want_texels=True, want_bg=True,
                              want_ab=(True,) * 6, g_carry=None, g_mats=None):
    """S1B's plain version: the reverse that autograd runs through
    ``integrator.shade_plain`` in the carry form, written out in torch ops
    from the record, each product's gradient taken as torch's backward
    takes it (a masked branch's zero meets the same operands) and
    ``torch.minimum``'s tie and NaN rule (``_min_grads``). Per channel c:

    - ``color' = terminal ? L * att : color``, ``L = dead_t ? 0 : min(A *
      t_c, B)``, ``t_c = dead_t ? 0 : term``, ``term = miss ? bg : (emit
      && front ? albedo : 0)``;
    - ``att = atten > 0 ? 1 / (1 + atten * term_acc) : 1``, ``atten`` the
      emitting lane's effective material's factor;
    - ``A' = terminal ? 1 : (scat ? A * (albedo * m) : A)``, ``m = dead ? 0 :
      prob_scat``;
    - ``B' = terminal ? inf : (pdf ? min(B, 3 A) : B)``.

    ``prob_scat``, ``term_acc`` and the directions are detached (the JAX
    package's stop_gradients). The shading normal reaches only them, so a
    normal map's texels get no gradient. Each input's contributions (at
    most two non-zero on a lane) are summed; the arena's gradient is
    ``index_add_`` into the sums' rows of the lanes' albedos, as
    ``index_select``'s backward adds them, the background's sum added to
    the sums' last row, and the attenuation factor's, ``-(sum_c g_c L_c)
    * att^2 * term_acc`` (the reciprocal's backward), ``index_add_`` into
    ``g_mats``' column ``ATTEN_COL`` at the lanes' material rows. Same
    arguments and returns as ``step_shade_backward``."""
    row, word = rec[0], rec[3]
    r1, att = rec[1].view(torch.float32), rec[2].view(torch.float32)

    def bit(k):
        return (word & k) != 0

    miss, emit_front = bit(REC_MISS), bit(REC_EMIT_FRONT)
    scat, pdf, terminal = bit(REC_SCAT), bit(REC_PDF), bit(REC_TERMINAL)
    prob = torch.where(scat, r1, 0.0)
    read = row >= 0
    rows = torch.clamp(row, min=0).long()
    texel = torch.index_select(texels, 0, rows)
    zero = torch.zeros_like(prob)
    g_ab, g_alb, g_bg = [None] * 6, [], []
    g_att = zero
    for c in range(3):
        A, B = ab[c], ab[3 + c]
        alb = torch.where(read, texel[:, c], 0.0)
        dead_t, dead = bit(REC_DEAD_T << c), bit(REC_DEAD << c)
        g_c = zero if g_color is None else g_color[:, c]
        g_end = torch.where(terminal, g_c, 0.0)
        # fold_resolve
        term = torch.where(miss, bg[c], torch.where(emit_front, alb, 0.0))
        t_c = torch.where(dead_t, 0.0, term)
        gx, gy = _min_grads(A * t_c, B, torch.where(dead_t, 0.0, g_end * att))
        if g_mats is not None:
            g_att = g_att + g_end * torch.where(
                dead_t, 0.0, torch.minimum(A * t_c, B))
        g_term = torch.where(dead_t, 0.0, gx * A)
        g_bg.append(torch.where(miss, g_term, 0.0).sum())
        # the terminal reset and fold_scatter
        g_a2, g_b2 = (torch.where(terminal, 0.0, zero if g is None else g)
                      for g in (g_ab_out[c], g_ab_out[3 + c]))
        m = torch.where(dead, 0.0, prob)
        g_p = torch.where(scat, g_a2, 0.0)
        gs, go = _min_grads(B, 3.0 * A, torch.where(pdf, g_b2, 0.0))
        g_alb.append(torch.where(emit_front, g_term, 0.0) + (g_p * A) * m)
        g_ab[c] = (gx * t_c + go * 3.0 + g_p * (alb * m)
                   + torch.where(scat, 0.0, g_a2))
        g_ab[3 + c] = gy + gs + torch.where(pdf, 0.0, g_b2)
    if g_carry is not None:
        if g_color is None:
            g_carry.zero_()
        else:
            g_carry.copy_(torch.where(terminal[:, None], 0.0, g_color))
    if want_texels:
        sums[:-1].index_add_(0, rows, torch.where(
            read[:, None], torch.stack(g_alb, -1), 0.0))
    if want_bg:
        sums[-1] += torch.stack(g_bg)
    if g_mats is not None:
        atten = bit(REC_ATTEN)
        mat = word >> REC_MAT_SHIFT
        g_atten = ((-g_att) * (att * att)) * r1
        g_mats[:, ATTEN_COL].index_add_(0, mat[atten].long(), g_atten[atten])
    return tuple(g if w else None for g, w in zip(g_ab, want_ab))


def div_magic(d):
    """The constants of an exact unsigned 64-bit division by ``d`` (1 <= d
    < 2**63) as a multiply-high (Granlund and Montgomery, 1994, fig. 4.1),
    S2's ``q / n_pix``: (m, sh1, sh2) with, for every 0 <= q < 2**64,
    ``t = (m * q) >> 64`` and ``q // d == (t + ((q - t) >> sh1)) >> sh2``.
    m is returned as the int64 of its 64 bits (the kernels' argument
    array holds int64)."""
    if not 1 <= d < 2 ** 63:
        raise ValueError(f"div_magic: divisor {d} out of range")
    ell = (d - 1).bit_length()            # ceil(log2 d)
    m = (2 ** 64 * (2 ** ell - d)) // d + 1
    m -= 2 ** 64 if m >= 2 ** 63 else 0
    return m, min(ell, 1), max(ell - 1, 0)


def regen_constants(wf):
    """S2's queue constants of the wavefront ``wf``: the division by its
    pixels (``div_magic``) and the tile swizzle's log2 width and height
    (``integrator._tile_swizzle``'s sides are powers of two; swizzle 0:
    none, or a shard's pixel ids)."""
    m, sh1, sh2 = div_magic(wf.n_pix)
    tile_w, tile_h = wf.swizzle or (1, 1)
    return dict(npix_magic=m, npix_sh1=sh1, npix_sh2=sh2,
                swizzle=int(wf.swizzle is not None),
                tile_wl=tile_w.bit_length() - 1,
                tile_hl=tile_h.bit_length() - 1)


def scan_words(lanes):
    """The status words S2's scan needs for a pool of ``lanes`` lanes: one
    a block of ``REGEN_THREADS``."""
    return -(-lanes // REGEN_THREADS)


def step_regen(cs, wf, pool, terminal=None):
    """S2 on ``pool`` of the wavefront ``wf`` (an ``integrator._Wavefront``)
    in one launch. With ``terminal`` (S1's (R,) bool flags, its colors in
    ``pool.color``): the rest of ``wf.step`` (``wf.regen_plain`` says what
    it computes), the exclusive scan of the flags included (a single-pass
    scan in the kernel over ``wf.scan_status``, blocks ordered by
    ``wf.ticket``, which the kernel puts back). Without them: the camera
    part of ``wf.reset`` for the wide pool (``wf.reset_plain``). Returns
    None."""
    dev = pool.qpos.device
    reset = terminal is None
    if dev.type == "cpu":
        if reset:
            wf.reset_plain(cs, pool)
        else:
            wf.regen_plain(cs, pool, pool.color, terminal)
        return
    if dev.type != "cuda":
        raise ValueError(f"step_regen: unsupported device {dev}")
    regen_kernel(_build.library().step_regen_launch, cs, wf, pool, terminal,
                 _build.stream_of(pool.qpos))
    step_regen.launches += 1


step_regen.launches = 0


def regen_kernel(fn, cs, wf, pool, terminal, stream):
    """S2's launch through its C entry ``fn`` (``step_regen_launch``) on
    ``stream``: the argument checks and the two argument arrays."""
    dev = pool.qpos.device
    reset = terminal is None
    r = pool.qpos.shape[0]
    lanes = pool.lanes()
    dtypes = [torch.float32] * 6 + [torch.int32, torch.float32] + \
        [torch.float32] * 6 + [torch.bool] * 4
    for name, x, dtype in zip(LANE_ARRAYS, lanes, dtypes):
        _check(f"step_regen: {name}", x, dtype, r, dev)
    for name, x in (("qpos", pool.qpos), ("pixel", pool.pixel),
                    ("sample", pool.sample)):
        _check(f"step_regen: {name}", x, torch.int64, r, dev)
    for name, x in (("next_q", wf.next_q), ("segments", wf.segments),
                    ("start", wf.start)):
        if x.shape != () or x.dtype != torch.int64 or x.device != dev:
            raise ValueError(f"step_regen: {name} must be a 0-dim int64 "
                             f"tensor on {dev}")
    tab = step_tables(cs)
    p = _build.ptr
    ptrs = dict(cam=p(tab.cam), qpos=p(pool.qpos), pixel=p(pool.pixel),
                sample=p(pool.sample), start=p(wf.start))
    if wf.pix is not None:
        _check("step_regen: pix_ids", wf.pix, torch.int64, wf.pix.shape[0],
               dev)
        ptrs["pix_ids"] = p(wf.pix)
    if not reset:
        _check("step_regen: terminal", terminal, torch.bool, r, dev)
        if pool.color.shape != (r, 3) or not pool.color.is_contiguous():
            raise ValueError("step_regen: color must be contiguous (R, 3)")
        if wf.accum.shape != (wf.total_q + 1, 3) or \
                not wf.accum.is_contiguous():
            raise ValueError("step_regen: accum must be contiguous "
                             "(total_q + 1, 3)")
        status = wf.scan_status
        if status.dtype != torch.int64 or status.device != dev or \
                status.dim() != 1 or not status.is_contiguous() or \
                status.shape[0] < scan_words(r):
            raise ValueError(f"step_regen: scan_status must be a contiguous "
                             f"int64 tensor of {scan_words(r)} words or more "
                             f"on {dev}")
        _check("step_regen: ticket", wf.ticket, torch.int32, 2, dev)
        ptrs.update(terminal=p(terminal), color=p(pool.color),
                    accum=p(wf.accum), next_q=p(wf.next_q),
                    segments=p(wf.segments), ticket=p(wf.ticket),
                    status=p(wf.scan_status))
    for name, x in zip(LANE_ARRAYS, lanes):
        ptrs["pool_" + name] = p(x)
    ints = dict(n=r, total_q=wf.total_q, n_pix=wf.n_pix, width=wf.width,
                height=wf.height, n_status=wf.scan_status.shape[0],
                seed=int(wf.seed) & 0xFFFFFFFF, reset=int(reset),
                **regen_constants(wf))
    _build.check(_launch(fn, REGEN_PTRS, REGEN_INTS, ptrs, ints, stream),
                 "step_regen")
