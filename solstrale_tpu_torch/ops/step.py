"""The wavefront step's shading and regeneration as two hand-written kernels
(``csrc/step.cu``): S1 ``step_shade`` and S2 ``step_regen``.

Replaces the step body of the JAX package's one-program wavefront
(``solstrale_tpu/renderer/integrator.py:765-836``, ``one_step`` inside
``trace_queued``), which XLA fuses: hit attributes, scatter, clamp-fold,
accumulation, regeneration and the draws. The port's plain versions run it
as ~700-1,300 torch kernels a step; with these a step is the scene-hit
kernels (K1-K3 or K4), S1, one scan and S2.

- ``step_shade`` (S1): everything ``integrator.path_step`` does after the
  scene hit, one thread a lane, every draw computed in registers. Plain
  version: ``integrator.shade_plain``.
- ``step_regen`` (S2): the rest of ``integrator._Wavefront.step`` after the
  inclusive scan of S1's terminal flags (the one library op left in the
  step): accumulation rows, queue positions, camera rays, the pool's
  write-back and the segment and queue counters; without flags, the camera
  part of ``_Wavefront.reset``. Plain versions: ``_Wavefront.regen_plain``
  and ``_Wavefront.reset_plain``.

Each wrapper picks by the device of its tensors only: CPU tensors take the
plain version, CUDA tensors launch the kernel or raise. Both launch on the
current stream (the wavefront's CUDA graphs capture them as they are) and
count their launches (``launches``). S1 has no backward: on the card it
raises where autograd would want a graph through it (``trace``'s
differentiable route is the torch composition). The arguments go to the kernels as one
array of pointers and one of int64 values, indexed by the names below,
which ``csrc/step.cu``'s enums list in the same order.
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

SHADE_PTRS = (("cam", "sph", "pln", "mats", "tex_attr", "texels", "lights",
               "med_mat", "pl_idx", "pl_is_tri", "t", "kind", "idx", "pixel",
               "sample", "seed", "active", "qpos", "color") + FLAGS
              + tuple("in_" + n for n in LANE_ARRAYS)
              + tuple("out_" + n for n in LANE_ARRAYS))
SHADE_INTS = (("n", "max_depth", "flags", "n_sph", "n_pl", "n_q", "n_mat",
               "n_tex", "n_texels", "n_light", "n_media", "total_q")
              + tuple(f"{c}_{k}" for c in ("pixel", "sample", "seed")
                      for k in _COUNTER))
REGEN_PTRS = (("cam", "qpos", "pixel", "sample", "terminal", "rank",
               "color", "accum", "next_q", "segments", "done", "start",
               "pix_ids") + tuple("pool_" + n for n in LANE_ARRAYS))
REGEN_INTS = ("n", "total_q", "n_pix", "width", "height", "tile_w", "tile_h",
              "seed", "reset")


@dataclass(frozen=True)
class StepTables:
    """S1's and S2's scene tables, packed once per compiled scene
    (``step_tables``), contiguous on the scene's device:

    - ``cam`` (24,) and ``lights`` (L, 20): K5's
      (``megakernel.camera_table``, ``light_table``);
    - ``sph`` (S, 8) f32: ``Solids.sph_attr`` (center, radius, mat) padded;
    - ``pln`` (P, 28) f32: ``Solids.pl_attr`` padded (16-byte rows);
    - ``mats`` (Mt, 9), ``tex_attr`` (T, 3), ``texels`` (N, 3) f32:
      ``Materials.attr``, ``TexArena.attr`` and ``.pixels``;
    - ``med_mat`` (M,) int32: each medium's phase material;
    - ``pl_idx`` (P,) int32 and ``pl_is_tri`` (P,) bool: the decode of
      K1's planar slot;
    - ``n_q``: the quads, which come before the triangles in ``pln``;
    - ``flags``: ``FLAG_*`` of the scene's features."""

    cam: torch.Tensor
    sph: torch.Tensor
    pln: torch.Tensor
    mats: torch.Tensor
    tex_attr: torch.Tensor
    texels: torch.Tensor
    lights: torch.Tensor
    med_mat: torch.Tensor
    pl_idx: torch.Tensor
    pl_is_tri: torch.Tensor
    n_q: int
    flags: int


def feature_flags(features):
    """The ``FLAG_*`` bits of a compiled scene's ``features``: the code
    paths the plain versions skip when the scene cannot take them."""
    return ((FLAG_BLEND if "blend" in features else 0)
            | (FLAG_NORMAL_MAPS if "normal_maps" in features else 0)
            | (FLAG_SPHERES if "spheres" in features else 0))


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
    return StepTables(
        cam=camera_table(cs), sph=padded(s.sph_attr, 8),
        pln=padded(s.pl_attr, 28),
        mats=cs.materials.attr.to(torch.float32).contiguous(),
        tex_attr=cs.textures.attr.to(torch.float32).contiguous(),
        texels=cs.textures.pixels.to(torch.float32).contiguous(),
        lights=light_table(cs),
        med_mat=med_mat.to(torch.int32).contiguous(),
        pl_idx=s.pl_idx.to(torch.int32).contiguous(),
        pl_is_tri=s.pl_is_tri.to(torch.bool).contiguous(),
        n_q=s.qd_q.shape[0], flags=feature_flags(cs.features))


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
    """S1's outputs as path_step's dict, in new tensors."""
    f = torch.empty((13, r), dtype=torch.float32, device=dev)
    b = torch.empty((10, r), dtype=torch.bool, device=dev)
    out = dict(zip(FLAGS, b[4:].unbind(0)))
    out.update(color=torch.empty((r, 3), dtype=torch.float32, device=dev),
               o=tuple(f[0:3].unbind(0)), d=tuple(f[3:6].unbind(0)),
               bounce=torch.empty((r,), dtype=torch.int32, device=dev),
               acc_len=f[6],
               fold=(tuple(f[7:10].unbind(0)), tuple(f[10:13].unbind(0)),
                     tuple(b[0:3].unbind(0)), b[3]))
    return out


def needs_grad(cs, *args):
    """Whether autograd would record a graph through the step: grad mode
    on, and a tensor among ``args`` (one level into tuples) or among the
    compiled scene's tables (its dataclass fields, nested) requires grad."""
    if not torch.is_grad_enabled():
        return False

    def walk(x):
        if isinstance(x, torch.Tensor):
            return x.requires_grad
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


def _counter_args(x, r, dev):
    """A draw counter (pixel, sample or seed) as (tensor or None, (size,
    stride, value)), the draw kernel's form (``rng.kernel_counter``)."""
    t, stride, value = rng.kernel_counter(x, torch.Size((r,)), dev)
    if t is None:
        return None, (0, 0, value)
    return t, (t.element_size(), stride, 0)


def _launch(fn, names_p, names_v, ptrs, ints, stream):
    """Call a step kernel's C entry with its pointer and int64 arrays, each
    filled by name (a name left out is a null pointer)."""
    unknown = (set(ptrs) - set(names_p)) | (set(ints) - set(names_v))
    if unknown:
        raise KeyError(f"step kernel arguments: unknown {sorted(unknown)}")
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
        raise ValueError("step_shade: S1 has no backward; a render that "
                         "autograd runs through takes the differentiable "
                         "route (integrator.trace(..., differentiable=True))")
    out = shade_kernel(_build.library().step_shade_launch, cs, t, kind, idx,
                       o, d, bounce, acc_len, fold, pixel, sample, seed,
                       active, max_depth, out, _build.stream_of(t))
    step_shade.launches += 1
    return out


step_shade.launches = 0


def shade_kernel(fn, cs, t, kind, idx, o, d, bounce, acc_len, fold, pixel,
                 sample, seed, active, max_depth, out, stream):
    """S1's launch through its C entry ``fn`` (``step_shade_launch``) on
    ``stream``: the argument checks and the two argument arrays. Returns
    the output dict."""
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
    elif tab.pl_idx.shape[0] == 0:
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
    p = _build.ptr
    ptrs = dict(cam=p(tab.cam), sph=p(tab.sph), pln=p(tab.pln),
                mats=p(tab.mats), tex_attr=p(tab.tex_attr),
                texels=p(tab.texels), lights=p(tab.lights),
                med_mat=p(tab.med_mat), pl_idx=p(tab.pl_idx),
                pl_is_tri=p(tab.pl_is_tri), t=p(t), idx=p(idx), color=p(color))
    if kind is not None:
        ptrs["kind"] = p(kind)
    if isinstance(active, tuple):
        qpos, total_q = active
        _check("step_shade: qpos", qpos, torch.int64, r, dev)
        ptrs["qpos"] = p(qpos)
    else:
        _check("step_shade: active", active, torch.bool, r, dev)
        ptrs["active"], total_q = p(active), 0
    ints = dict(n=r, max_depth=max_depth, flags=tab.flags,
                n_sph=tab.sph.shape[0], n_pl=tab.pln.shape[0], n_q=tab.n_q,
                n_mat=tab.mats.shape[0], n_tex=tab.tex_attr.shape[0],
                n_texels=tab.texels.shape[0], n_light=tab.lights.shape[0],
                n_media=tab.med_mat.shape[0], total_q=total_q)
    counters = []   # held until the launch: a counter may be a new tensor
    for name, x in (("pixel", pixel), ("sample", sample), ("seed", seed)):
        t_c, vals = _counter_args(x, r, dev)
        counters.append(t_c)
        if t_c is not None:
            ptrs[name] = p(t_c)
        ints.update(zip((f"{name}_{k}" for k in _COUNTER), vals))
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
                      sample, seed, active, max_depth, out):
    """S1's CPU side: ``integrator.shade_plain``, copied into ``out`` when
    given."""
    from ..renderer.integrator import shade_plain

    if kind is None:
        kind, idx = bvh.decode_planar_slot(cs.solids, idx)
    if isinstance(active, tuple):
        active = active[0] < active[1]
    st = shade_plain(cs, o, d, t, kind, idx, bounce, acc_len, fold, pixel,
                     sample, seed, active, max_depth)
    if out is None:
        return st
    for dst, src in zip(lane_arrays(out), lane_arrays(st)):
        dst.copy_(src)
    for k in ("color",) + FLAGS:
        if out.get(k) is not None:
            out[k].copy_(st[k])
    return out


def step_regen(cs, wf, pool, terminal=None, rank=None):
    """S2 on ``pool`` of the wavefront ``wf`` (an ``integrator._Wavefront``)
    in one launch. With ``terminal`` (S1's (R,) bool flags, its colors in
    ``pool.color``) and ``rank`` (their inclusive ``torch.cumsum``, int64):
    the rest of ``wf.step`` (``wf.regen_plain`` says what it computes).
    Without them: the camera part of ``wf.reset`` for the wide pool
    (``wf.reset_plain``). Returns None."""
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
                 rank, _build.stream_of(pool.qpos))
    step_regen.launches += 1


step_regen.launches = 0


def regen_kernel(fn, cs, wf, pool, terminal, rank, stream):
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
        _check("step_regen: rank", rank, torch.int64, r, dev)
        if pool.color.shape != (r, 3) or not pool.color.is_contiguous():
            raise ValueError("step_regen: color must be contiguous (R, 3)")
        if wf.accum.shape != (wf.total_q + 1, 3) or \
                not wf.accum.is_contiguous():
            raise ValueError("step_regen: accum must be contiguous "
                             "(total_q + 1, 3)")
        ptrs.update(terminal=p(terminal), rank=p(rank), color=p(pool.color),
                    accum=p(wf.accum), next_q=p(wf.next_q),
                    segments=p(wf.segments), done=p(wf.done))
    for name, x in zip(LANE_ARRAYS, lanes):
        ptrs["pool_" + name] = p(x)
    tile_w, tile_h = wf.swizzle or (0, 0)
    ints = dict(n=r, total_q=wf.total_q, n_pix=wf.n_pix, width=wf.width,
                height=wf.height, tile_w=tile_w, tile_h=tile_h,
                seed=int(wf.seed) & 0xFFFFFFFF, reset=int(reset))
    _build.check(_launch(fn, REGEN_PTRS, REGEN_INTS, ptrs, ints, stream),
                 "step_regen")
