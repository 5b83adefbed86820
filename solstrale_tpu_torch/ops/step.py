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
  The forward is S1 writing new tensors and a record of 16 bytes a lane
  (``shade_record``); the backward is S1B (``step_shade_backward``: the
  fold's gradients from the record, one thread a lane, and the texture
  arena's and the background's added into the sums of the backward pass,
  ``GradSums``, which the trace's head, ``grad_scene``, hands to autograd
  once a pass). Plain versions: ``shade_plain(..., record=True)`` and
  ``step_shade_backward_plain``, the reverse that autograd runs through
  ``shade_plain``.

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
# where a lane reads none), prob_scat and att as f32 bits, and a flag word
# of these bits (csrc/step.cu's kRec*); channel c's at REC_DEAD_T << c and
# REC_DEAD << c
REC_MISS, REC_EMIT_FRONT, REC_SCAT, REC_PDF, REC_TERMINAL = 1, 2, 4, 8, 16
REC_DEAD_T = 32    # the channel was dead at the terminal color (dead_t)
REC_DEAD = 256     # the channel is dead after this level's fold

SHADE_PTRS = (("cam", "sph", "pln", "mats", "tex_attr", "texels", "lights",
               "med_mat", "pl_row", "small", "t", "kind", "idx", "pixel",
               "sample", "seed", "active", "qpos", "color") + FLAGS
              + tuple("in_" + n for n in LANE_ARRAYS)
              + tuple("out_" + n for n in LANE_ARRAYS) + ("bg", "rec"))
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
BACK_PTRS = (("rec", "texels", "bg", "g_color", "g_texels", "g_bg")
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
               seed, active, max_depth, out=None):
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
    in place), or None for new tensors. Returns the dict."""
    dev = t.device
    if dev.type == "cpu":
        return _step_shade_plain(cs, t, kind, idx, o, d, bounce, acc_len,
                                 fold, pixel, sample, seed, active,
                                 max_depth, out)
    if dev.type != "cuda":
        raise ValueError(f"step_shade: unsupported device {dev}")
    if needs_grad(cs, o, d, acc_len, fold):
        raise ValueError("step_shade: S1 alone builds no autograd graph; a "
                         "render that autograd runs through takes the "
                         "differentiable route (integrator.trace(..., "
                         "differentiable=True): S1 with its backward S1B)")
    out = shade_kernel(_build.library().step_shade_launch, cs, t, kind, idx,
                       o, d, bounce, acc_len, fold, pixel, sample, seed,
                       active, max_depth, out, _build.stream_of(t))
    step_shade.launches += 1
    return out


step_shade.launches = 0


def shade_kernel(fn, cs, t, kind, idx, o, d, bounce, acc_len, fold, pixel,
                 sample, seed, active, max_depth, out, stream, texels=None,
                 bg=None, rec=None):
    """S1's launch through its C entry ``fn`` (``step_shade_launch``) on
    ``stream``: the argument checks and the two argument arrays. ``texels``
    ((N, 3) f32) and ``bg`` ((3,) f32): the arena and background read in
    place of the packed tables' (the differentiable route's own inputs);
    ``rec``: a (4, R) int32 tensor for S1's record. Returns the output
    dict."""
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
        qpos, total_q = active
        _check("step_shade: qpos", qpos, torch.int64, r, dev)
        ptrs["qpos"] = p(qpos)
    else:
        _check("step_shade: active", active, torch.bool, r, dev)
        ptrs["active"], total_q = p(active), 0
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
    return out


def _step_shade_plain(cs, t, kind, idx, o, d, bounce, acc_len, fold, pixel,
                      sample, seed, active, max_depth, out, record=False):
    """S1's CPU side: ``integrator.shade_plain``, copied into ``out`` when
    given."""
    from ..renderer.integrator import shade_plain

    if kind is None:
        kind, idx = bvh.decode_planar_slot(cs.solids, idx)
    if isinstance(active, tuple):
        active = active[0] < active[1]
    st = shade_plain(cs, o, d, t, kind, idx, bounce, acc_len, fold, pixel,
                     sample, seed, active, max_depth, record=record)
    if out is None:
        return st
    for dst, src in zip(lane_arrays(out), lane_arrays(st)):
        dst.copy_(src)
    for k in ("color",) + FLAGS:
        if out.get(k) is not None:
            out[k].copy_(st[k])
    return out


def shade_record(row, prob_scat, att, miss, emit_front, scat, pdf,
                 terminal, dead_t, dead):
    """S1's record of a bounce for its backward, as ``csrc/step.cu`` writes
    it: a (4, R) int32 tensor of the albedo texel row (-1: none read), the
    scatter level's pdf weight ``prob_scat`` and the terminal attenuation
    ``att`` as f32 bits, and the flag word (``REC_*``; ``dead_t`` and
    ``dead`` are per-channel tuples)."""
    bits = [(miss, REC_MISS), (emit_front, REC_EMIT_FRONT), (scat, REC_SCAT),
            (pdf, REC_PDF), (terminal, REC_TERMINAL)]
    bits += [(dead_t[c], REC_DEAD_T << c) for c in range(3)]
    bits += [(dead[c], REC_DEAD << c) for c in range(3)]
    word = sum(b.to(torch.int32) * k for b, k in bits)
    return torch.stack([row, prob_scat.view(torch.int32),
                        att.view(torch.int32), word])


class GradSums:
    """The texture arena's and the background's gradients summed over one
    backward pass of a differentiable trace: one (N + 1, 3) buffer, the
    arena's N rows, then the background. The first S1B of a pass that
    wants either makes it, zeroed (``buffer``: the pass's one fill, which
    a captured inverse step replays), every S1B of the pass adds into it,
    and the trace's head (``_GradSink``) hands it to autograd once
    (``take``), as the JAX transpose carries one cotangent for the arena.
    A pass is autograd's graph task, so a second backward over a retained
    graph, or one that stops short of the head, starts from zero; a
    gradient handed out is never added to again."""

    def __init__(self, arena, bg):
        self.rows = arena.shape[0]
        self.dtype, self.device = arena.dtype, arena.device
        self.want_texels = arena.requires_grad
        self.want_bg = bg.requires_grad
        self._buf = self._task = None

    def buffer(self):
        """This pass's buffer, made and zeroed at its first use."""
        task = torch._C._current_graph_task_id()
        if self._buf is None or self._task != task:
            self._buf = torch.zeros((self.rows + 1, 3), dtype=self.dtype,
                                    device=self.device)
            self._task = task
        return self._buf

    def take(self):
        """This pass's (arena, background) gradients, (N, 3) and (3,) views
        of its buffer, or (None, None) where no S1B of it added; the next
        use starts a new buffer."""
        buf = self._buf if self._task == \
            torch._C._current_graph_task_id() else None
        self._buf = self._task = None
        return (None, None) if buf is None else (buf[:-1], buf[-1])


def _plus(a, b):
    return b if a is None else a if b is None else a + b


class _GradSink(torch.autograd.Function):
    """A differentiable trace's head: the arena and the background passed
    on as views, and in the backward their gradients from the pass's
    ``GradSums`` (the trace's S1B calls add into it and return none of
    their own), plus any that reached the views another way (a torch
    op, as the plain route's texel gather). Autograd runs it after every
    S1B of the trace, whose inputs the views are."""

    @staticmethod
    def forward(ctx, sums, arena, bg):
        ctx.grad_sums = sums
        ctx.set_materialize_grads(False)
        return arena.view_as(arena), bg.view_as(bg)

    @staticmethod
    def backward(ctx, g_arena, g_bg):
        s_arena, s_bg = ctx.grad_sums.take()
        need = ctx.needs_input_grad
        return (None, _plus(g_arena, s_arena) if need[1] else None,
                _plus(g_bg, s_bg) if need[2] else None)


def grad_scene(cs):
    """``cs`` for one differentiable trace: a copy whose arena and
    background are ``_GradSink``'s views of the scene's, which carry the
    trace's ``GradSums`` (``sums_of``), sharing the scene's packed tables
    (S1's with the view as its texels, and the media's), which are packed
    for ``cs`` at its first trace, so that a trace captured after a
    warm-up one packs nothing (a pack reads back to the host). ``cs``
    itself where grad mode is off or neither requires grad."""
    from ..renderer.integrator import (media_tables, per_scene,
                                       share_geometry_tables)

    arena, bg = cs.textures.pixels, cs.bg_color
    if not (torch.is_grad_enabled()
            and (arena.requires_grad or bg.requires_grad)):
        return cs
    tab = step_tables(cs)
    media_tables(cs)
    view, bg_view = _GradSink.apply(GradSums(arena, bg), arena, bg)
    out = dataclasses.replace(
        cs, textures=dataclasses.replace(cs.textures, pixels=view),
        bg_color=bg_view)
    share_geometry_tables(cs, out)
    per_scene(out, "step", lambda: dataclasses.replace(
        tab, texels=view.to(torch.float32).contiguous()))
    return out


def sums_of(arena):
    """The ``GradSums`` an arena from ``grad_scene`` carries, else None."""
    return getattr(arena.grad_fn, "grad_sums", None)


def step_shade_grad(cs, t, kind, idx, o, d, bounce, acc_len, fold, pixel,
                    sample, seed, active, max_depth):
    """``step_shade`` on the differentiable route: S1, and S1B in the
    backward (``StepShadeFn``), with path_step's arguments and dict (new
    tensors). Gradients reach the fold's A and B, the texture arena
    (``cs.textures.pixels``: albedos, texture maps and emitter radiance)
    and the background (``cs.bg_color``); the last two through the sums of
    the arena's ``grad_scene`` (``trace`` makes one a trace; a scene
    without one gets one for this call). Raises, on every device, where a
    lane input or another table of the scene requires grad. Where none of
    the four requires grad (or grad mode is off) it is ``step_shade``."""
    A, B, dead, outer = fold
    arena, bg = cs.textures.pixels, cs.bg_color
    if needs_grad(cs, t, o, d, acc_len, skip=(arena, bg)):
        raise ValueError("step_shade_grad: gradients reach only the fold, "
                         "the texture arena (cs.textures.pixels) and the "
                         "background (cs.bg_color); a lane input or "
                         "another scene table requires grad")
    if not (torch.is_grad_enabled() and any(
            x.requires_grad for x in (arena, bg, *A, *B))):
        return step_shade(cs, t, kind, idx, o, d, bounce, acc_len, fold,
                          pixel, sample, seed, active, max_depth)
    if (arena.requires_grad or bg.requires_grad) and sums_of(arena) is None:
        cs = grad_scene(cs)
        arena, bg = cs.textures.pixels, cs.bg_color
    outs = StepShadeFn.apply(cs, (t, kind, idx, o, d, bounce, acc_len, dead,
                                  outer, pixel, sample, seed, active,
                                  max_depth, sums_of(arena)), arena, bg,
                             *A, *B)
    out = dict(zip(FLAGS, outs[19:]))
    out.update(color=outs[0], o=outs[7:10], d=outs[10:13], bounce=outs[13],
               acc_len=outs[14], fold=(outs[1:4], outs[4:7], outs[15:18],
                                       outs[18]))
    return out


class StepShadeFn(torch.autograd.Function):
    """S1 with S1B as its backward. Inputs: the compiled scene, the rest of
    path_step's arguments and the pass's ``GradSums`` (or None: neither
    the arena nor the background wants a gradient) in one tuple, then the
    differentiable ones: the arena and the background (``grad_scene``'s
    views), which the kernels read from these tensors, not from the
    scene's packed tables (an inverse step swaps its own leaf arena in),
    and the fold's A and B (3 each). Outputs: color, A', B'
    (differentiable), then o, d, bounce, acc_len, dead, outer and the six
    flags (not). The record (16 bytes a lane) and the fold's A and B are
    saved for the backward, which reads nothing back to the host; it adds
    the arena's and the background's gradients into the sums and returns
    none for them (the sums' sink does)."""

    @staticmethod
    def forward(ctx, cs, call, arena, bg, *ab):
        (t, kind, idx, o, d, bounce, acc_len, dead, outer, pixel, sample,
         seed, active, max_depth, sums) = call
        out, rec = shade_with_record(
            cs, t, kind, idx, o, d, bounce, acc_len,
            (ab[:3], ab[3:], dead, outer), pixel, sample, seed, active,
            max_depth, arena, bg)
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
        sums = ctx.sums
        want_texels = sums is not None and sums.want_texels
        want_bg = sums is not None and sums.want_bg
        g_ab = step_shade_backward(
            rec, ab, arena, bg, g_color, g_out[:6],
            sums.buffer() if want_texels or want_bg else None, want_texels,
            want_bg, ctx.needs_input_grad[4:10])
        return (None, None, None, None, *g_ab)


def shade_with_record(cs, t, kind, idx, o, d, bounce, acc_len, fold, pixel,
                      sample, seed, active, max_depth, arena=None, bg=None):
    """S1 with its record for S1B: (path_step's dict in new tensors, the
    (4, R) int32 record). ``arena`` and ``bg`` (default: the scene's) are
    the texels and background it reads. One S1 launch on the card (counted
    in ``step_shade.launches``), ``shade_plain(..., record=True)`` on the
    CPU."""
    arena = cs.textures.pixels if arena is None else arena
    bg = cs.bg_color if bg is None else bg
    dev = t.device
    if dev.type == "cpu":
        out = _step_shade_plain(cs, t, kind, idx, o, d, bounce, acc_len, fold,
                                pixel, sample, seed, active, max_depth, None,
                                record=True)
        return out, out.pop("record")
    if dev.type != "cuda":
        raise ValueError(f"step_shade_grad: unsupported device {dev}")
    r = t.shape[0]
    rec = torch.empty((4, r), dtype=torch.int32, device=dev)
    out = shade_kernel(_build.library().step_shade_launch, cs, t, kind, idx,
                       o, d, bounce, acc_len, fold, pixel, sample, seed,
                       active, max_depth,
                       _new_outputs(r, dev),
                       _build.stream_of(t), texels=arena, bg=bg, rec=rec)
    step_shade.launches += 1
    return out, rec


def step_shade_backward(rec, ab, texels, bg, g_color, g_ab_out, sums,
                        want_texels=True, want_bg=True, want_ab=(True,) * 6):
    """S1B: the gradients of one S1 call's inputs from its record ``rec``
    ((4, R) int32), its fold inputs ``ab`` (A then B, six (R,) f32), the
    arena ``texels`` ((N, 3) f32) and ``bg`` ((3,) f32), and the upstream
    gradients of its color ((R, 3)) and of its fold outputs A' and B' (six;
    None is a zero gradient). Adds the arena's gradient into ``sums[:N]``
    and the background's into ``sums[N]`` (``sums``: an (N + 1, 3) f32
    tensor, ``GradSums.buffer``; None where neither is wanted), each where
    its ``want_*`` is true; returns the six fold inputs' gradients (None
    where not wanted). One launch on the card, which allocates only those
    six; ``step_shade_backward_plain`` on the CPU."""
    dev = rec.device
    if dev.type == "cpu":
        return step_shade_backward_plain(rec, ab, texels, bg, g_color,
                                         g_ab_out, sums, want_texels,
                                         want_bg, want_ab)
    if dev.type != "cuda":
        raise ValueError(f"step_shade_backward: unsupported device {dev}")
    out = backward_kernel(_build.library().step_shade_backward_launch, rec,
                          ab, texels, bg, g_color, g_ab_out, sums,
                          want_texels, want_bg, want_ab,
                          _build.stream_of(rec))
    step_shade_backward.launches += 1
    return out


step_shade_backward.launches = 0


def backward_kernel(fn, rec, ab, texels, bg, g_color, g_ab_out, sums,
                    want_texels, want_bg, want_ab, stream):
    """S1B's launch through its C entry ``fn``
    (``step_shade_backward_launch``) on ``stream``: the checks, the fold's
    new gradient tensors and the two argument arrays; the arena's and the
    background's gradients go into ``sums``."""
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
                              want_ab=(True,) * 6):
    """S1B's plain version: the reverse that autograd runs through
    ``integrator.shade_plain``, written out in torch ops from the record,
    each product's gradient taken as torch's backward takes it (a masked
    branch's zero meets the same operands) and ``torch.minimum``'s tie and
    NaN rule (``_min_grads``). Per channel c:

    - ``color = (dead_t ? 0 : min(A * t_c, B)) * att``, ``t_c = dead_t ? 0 :
      term``, ``term = miss ? bg : (emit && front ? albedo : 0)``;
    - ``A' = terminal ? 1 : (scat ? A * (albedo * m) : A)``, ``m = dead ? 0 :
      prob_scat``;
    - ``B' = terminal ? inf : (pdf ? min(B, 3 A) : B)``.

    ``prob_scat``, ``att`` and the directions are detached (the JAX
    package's stop_gradients). The shading normal reaches only them, so a
    normal map's texels get no gradient. Each input's contributions (at
    most two non-zero on a lane) are summed; the arena's gradient is
    ``index_add_`` into the sums' rows of the lanes' albedos, as
    ``index_select``'s backward adds them, and the background's sum added
    to the sums' last row. Same arguments and returns as
    ``step_shade_backward``."""
    row, word = rec[0], rec[3]
    prob, att = rec[1].view(torch.float32), rec[2].view(torch.float32)

    def bit(k):
        return (word & k) != 0

    miss, emit_front = bit(REC_MISS), bit(REC_EMIT_FRONT)
    scat, pdf, terminal = bit(REC_SCAT), bit(REC_PDF), bit(REC_TERMINAL)
    read = row >= 0
    rows = torch.clamp(row, min=0).long()
    texel = torch.index_select(texels, 0, rows)
    zero = torch.zeros_like(prob)
    g_ab, g_alb, g_bg = [None] * 6, [], []
    for c in range(3):
        A, B = ab[c], ab[3 + c]
        alb = torch.where(read, texel[:, c], 0.0)
        dead_t, dead = bit(REC_DEAD_T << c), bit(REC_DEAD << c)
        # fold_resolve
        term = torch.where(miss, bg[c], torch.where(emit_front, alb, 0.0))
        t_c = torch.where(dead_t, 0.0, term)
        g_l = (zero if g_color is None else g_color[:, c]) * att
        gx, gy = _min_grads(A * t_c, B, torch.where(dead_t, 0.0, g_l))
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
    if want_texels:
        sums[:-1].index_add_(0, rows, torch.where(
            read[:, None], torch.stack(g_alb, -1), 0.0))
    if want_bg:
        sums[-1] += torch.stack(g_bg)
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
