"""The render megakernel (K5): a whole progressive sample batch of a small
scene in one launch.

Replaces the JAX package's ``renderer/megakernel.py::render_batch_megakernel``
(TPU kernel ``_render_kernel``). Execution model, as there: one lane per
pixel traces the pixel's ``n_samples`` paths back to back — camera ray,
scene hit with every medium, attributes, material scatter with the 50/50
NEE mixture, clamp-fold — and when a path ends it folds the path's color
into the pixel's own accumulator, in sample order, and starts the pixel's
next sample. No value crosses lanes. The randomness is the same counter
hash as the wavefront's (``ops/rng.py``), so K5 reproduces ``trace_queued``
draw for draw.

- ``render_batch_megakernel``: the wrapper. CPU scenes take the plain
  version; CUDA scenes launch the hand-written kernel
  (``csrc/megakernel.cu``: a persistent grid whose warps take pixels from
  a queue in runs of 32, and a cull of the media by their padded boxes,
  ``ops.sweep.medium_boxes``, neither of which changes a value) or raise.
- ``render_batch_megakernel_plain``: K5 in torch with K5's execution model.
  Its body is ``integrator.path_step_plain``, the torch composition of the
  step ``trace_queued`` runs, with the scene hit's plain version: no hit or
  step kernel runs in it on any device.
- ``megakernel_supported``: the static gate that sends a render to K5:
  path-shader renders of scenes without a BVH, within the table limits
  the gate sweep measured on the card.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..ops import _build
from ..ops.sweep import MediaTables
from ..scene.compile import CompiledScene

# K5's table limits: the crossovers of the gate sweep (gate_sweep.py; its
# table in PERF.md §6, PR 26), K5 against the wavefront (trace_queued: K4,
# S1, S2) on scenes that grow one table at a time, at 400x266x8, depth 50,
# on an H100 80GB HBM3 at 700.00 W: the largest size measured at which K5
# was not slower with or without a normal map (at 2,050 planar rows it was
# 0.997-1.108x the wavefront's speed, a tie). One size further K5 took
# 1.40-1.49x the wavefront's time at 2,562 planar rows, 1.06-1.29x at 224
# spheres, 1.02x at 96 lights without the map (1.13x at 112). Materials and
# textures (to 258 rows) and a medium's boundary rows (to 865) had no
# crossover, K5 1.2-3.0x faster at every size: they have no limit.
MAX_PLANAR = 2050
MAX_SPHERES = 192
MAX_LIGHTS = 80

# k5_render_launch flag bits (FLAG_NORMAL_MAPS picks the kernel's
# instantiation with the shading normal's code)
_FLAG_BLEND = 1
_FLAG_NORMAL_MAPS = 2


def megakernel_supported(cs: CompiledScene, *, need_aux, shader_kind):
    """Static gate: the megakernel renders the path shader's color of a
    scene without a BVH whose planar rows, spheres and lights are within
    ``MAX_PLANAR``, ``MAX_SPHERES`` and ``MAX_LIGHTS`` (the H100's
    crossovers); the rest, BVH scenes and the debug shaders take the
    wavefront and the first-hit pass. ``need_aux`` does not matter: the aux
    planes are a first-hit pass of their own (``render_sample_batch``).

    The JAX gate's other conditions were the TPU kernel's, and none binds
    K5: its table limits were the sizes that fit SMEM (K5 reads every table
    from device memory), the normal maps and the aux planes code the Pallas
    kernel did not have, and the image-texture conditions its u8 SMEM
    texture arena's (K5 reads the f32 texel table, ``TexArena.pixels``, as
    ``sample_texture`` does)."""
    del need_aux
    return (shader_kind == 0 and cs.bvh is None
            and cs.solids.pl_n.shape[0] <= MAX_PLANAR
            and cs.solids.sph_center.shape[0] <= MAX_SPHERES
            and cs.lights.kind.shape[0] <= MAX_LIGHTS)


@dataclass(frozen=True)
class MegakernelTables:
    """K5's inputs, packed once per compiled scene (``scene_tables``), all
    f32 and contiguous on the scene's device:

    - ``cam`` (24,): origin lower_left horizontal vertical u v (3 each),
      lens_radius, background color (3), 0 0;
    - ``sph`` (S, 8): cx cy cz radius valid mat 0 0;
    - ``pln`` (P, 28): the sweep row (n d g1 g1o g2 g2o is_tri valid), mat,
      0, the stored unit normal (3), 0, uv0 duv1 duv2 (2 each), 0 0. The
      JAX kernel's (P, 22) row re-normalises the plane normal in the
      kernel; the port's attributes read the unit normal the compile
      stored (``pl_attr[:, 0:3]``), so K5 carries it and matches them;
    - ``frame`` (P, 8): tangent, 0, bitangent, 0 (``pl_attr[:, 11:17]``),
      the planar rows' tangent frames, which only a scene with normal maps
      reads (``_FLAG_NORMAL_MAPS``); (0, 8) otherwise;
    - ``lights`` (L, 20): kind p0 p1 p2 radius normal d w area 0;
    - ``mats`` (Mt, 9): ``Materials.attr``; ``tex_attr`` (T, 3) and
      ``texels`` (N, 3): ``TexArena.attr`` and ``.pixels``;
    - ``media``: the packed boundaries and each medium's padded box
      (``ops.sweep.MediaTables``, ``box``: K5 culls by the boxes K4 culls
      by), and ``med`` (M, 4): neg_inv_density, phase material, 0, 0."""

    cam: torch.Tensor
    sph: torch.Tensor
    pln: torch.Tensor
    frame: torch.Tensor
    lights: torch.Tensor
    mats: torch.Tensor
    tex_attr: torch.Tensor
    texels: torch.Tensor
    media: MediaTables
    med: torch.Tensor
    flags: int


def scene_tables(cs: CompiledScene):
    """K5's MegakernelTables of a compiled scene, packed on first use."""
    from .integrator import per_scene

    return per_scene(cs, "megakernel", lambda: pack_tables(cs))


def _col(x):
    return x.to(torch.float32)[:, None]


def camera_table(cs: CompiledScene):
    """(24,) f32: origin lower_left horizontal vertical u v (3 each),
    lens_radius, background color (3), 0 0 (K5's and the step kernels')."""
    cam = cs.camera
    return torch.cat([cam.origin, cam.lower_left, cam.horizontal,
                      cam.vertical, cam.u, cam.v, cam.lens_radius.reshape(1),
                      cs.bg_color, torch.zeros(2, dtype=torch.float32,
                                               device=cs.device)]).contiguous()


def light_table(cs: CompiledScene):
    """(L, 20) f32: kind p0 p1 p2 radius normal d w area 0 (K5's and the
    step kernels')."""
    lt = cs.lights
    return torch.cat([_col(lt.kind), lt.p0, lt.p1, lt.p2, _col(lt.radius),
                      lt.normal, _col(lt.d), lt.w, _col(lt.area),
                      torch.zeros((lt.kind.shape[0], 1), dtype=torch.float32,
                                  device=cs.device)], 1).contiguous()


def pack_tables(cs: CompiledScene):
    """MegakernelTables of a compiled scene."""
    from .integrator import media_tables

    s = cs.solids
    f32 = dict(dtype=torch.float32, device=cs.device)

    def zeros(rows, cols):
        return torch.zeros((rows, cols), **f32)

    n_sph, n_pl = s.sph_center.shape[0], s.pl_n.shape[0]
    media = media_tables(cs)
    maps = "normal_maps" in cs.features
    frame = (torch.cat([s.pl_attr[:, 11:14], zeros(n_pl, 1),
                        s.pl_attr[:, 14:17], zeros(n_pl, 1)], 1)
             if maps else zeros(0, 8))
    return MegakernelTables(
        cam=camera_table(cs),
        sph=torch.cat([s.sph_center, _col(s.sph_radius), _col(s.sph_valid),
                       _col(s.sph_mat), zeros(n_sph, 2)], 1).contiguous(),
        pln=torch.cat([s.pl_table[:, :14], s.pl_attr[:, 23:24],
                       zeros(n_pl, 1), s.pl_attr[:, 0:3], zeros(n_pl, 1),
                       s.pl_attr[:, 17:23], zeros(n_pl, 2)], 1).contiguous(),
        frame=frame.to(torch.float32).contiguous(),
        lights=light_table(cs),
        mats=cs.materials.attr.to(torch.float32).contiguous(),
        tex_attr=cs.textures.attr.to(torch.float32).contiguous(),
        texels=cs.textures.pixels.to(torch.float32).contiguous(),
        media=media,
        med=torch.cat([_col(media.nid), _col(media.mat),
                       zeros(media.n_media, 2)], 1).contiguous(),
        flags=((_FLAG_BLEND if "blend" in cs.features else 0)
               | (_FLAG_NORMAL_MAPS if maps else 0)))


def render_batch_megakernel_plain(cs: CompiledScene, sample_start, n_samples,
                                  seed, *, width, height, max_depth,
                                  events=None):
    """Plain PyTorch K5: one lane per pixel, each running
    ``path_step_plain`` (with the scene hit's plain version) and, when its
    path ends, adding the color to its pixel's sum and regenerating at its
    own pixel with ``sample + 1``; a pixel whose samples are spent drops
    out. Each step runs on the pixels still tracing only (every operation
    of the step is per lane, so which lanes share a call changes no value;
    a 1080p batch's last steps hold a few hundred). Returns
    (accum (width*height, 3) in pixel-id order, segments as a 0-dim int64
    tensor): the values of ``trace_queued``, which draws the same numbers
    and sums each pixel's samples in the same order.

    ``events`` (optional dict) receives how many segments of each kind the
    batch traced (the work K5 does depends on them): ``miss``, ``capped``
    (the depth cap), ``emit``, ``pdf`` (a scatter with the NEE mixture),
    ``basic`` (a metal or dielectric scatter) and ``mapped`` (a scatter
    whose shading normal comes from a normal map)."""
    from .integrator import camera_rays_plain, fold_init, path_step_plain

    n_pix = width * height
    dev = cs.device
    sample_start, seed = int(sample_start), int(seed)
    end = sample_start + int(n_samples)
    pix = torch.arange(n_pix, dtype=torch.int64, device=dev)
    sample = torch.full((n_pix,), sample_start, dtype=torch.int64, device=dev)
    o, d = (list(x) for x in camera_rays_plain(cs, pix, sample, seed, width,
                                                height))
    zero = torch.zeros((n_pix,), dtype=torch.float32, device=dev)
    bounce = torch.zeros((n_pix,), dtype=torch.int32, device=dev)
    acc_len = zero.clone()
    fold = fold_init(zero)
    # the fold as one list of per-lane tensors: A (3), B (3), dead (3), outer
    fold = [c.clone() for part in fold[:3] for c in part] + [fold[3].clone()]
    accum = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    counts = dict.fromkeys(("miss", "capped", "emit", "pdf", "basic",
                            "mapped"), 0)
    while True:
        live = (sample < end).nonzero().squeeze(1)
        if live.numel() == 0:
            break
        f = [c[live] for c in fold]
        smp = sample[live]
        st = path_step_plain(
            cs, tuple(c[live] for c in o), tuple(c[live] for c in d),
            bounce[live], acc_len[live], (tuple(f[0:3]), tuple(f[3:6]),
                                          tuple(f[6:9]), f[9]),
            pix[live], smp, seed, torch.ones_like(smp, dtype=torch.bool),
            max_depth, plain=True, mapped=events is not None)
        terminal = st["terminal"]
        accum[live] = accum[live] + torch.where(terminal[:, None],
                                                st["color"], 0.0)
        smp = torch.where(terminal, smp + 1, smp)
        o_new, d_new = camera_rays_plain(cs, pix[live], smp, seed, width,
                                         height)
        parked = smp >= end
        d_new = tuple(torch.where(parked, 0.0, c) for c in d_new)
        for c in range(3):
            o[c][live] = torch.where(terminal, o_new[c], st["o"][c])
            d[c][live] = torch.where(terminal, d_new[c], st["d"][c])
        sample[live] = smp
        bounce[live] = torch.where(terminal, 0, st["bounce"]).to(torch.int32)
        acc_len[live] = torch.where(terminal, 0.0, st["acc_len"])
        A, B, dead, outer = st["fold"]
        for c, x in zip(fold, (*A, *B, *dead, outer)):
            c[live] = x
        segments = segments + live.numel()
        if events is not None:
            scat, is_pdf = st["scat"], st["is_pdf"]
            for k, mask in (("miss", st["miss"]), ("capped", st["capped"]),
                            ("emit", st["emit"]), ("pdf", scat & is_pdf),
                            ("basic", scat & ~is_pdf),
                            ("mapped", st["mapped"])):
                counts[k] = counts[k] + mask.sum()
    if events is not None:
        events.update({k: int(v) for k, v in counts.items()})
    return accum, segments


def render_batch_megakernel(cs: CompiledScene, sample_start, n_samples, seed,
                            *, width, height, max_depth, stats=None):
    """K5: render ``n_samples`` progressive passes of the full image in one
    launch. Returns (accum (width*height, 3) in pixel-id order, segments as
    a 0-dim int64 tensor). The kernel writes each pixel's segment count as
    int32 and this wrapper sums them: no float atomics, so a repeated
    launch is bit-identical.

    ``stats`` (optional dict, CUDA scenes; reading it synchronises)
    receives the launch's work counts: ``warp_iterations`` (iterations of
    the kernel's loop summed over warps, each tracing one segment per active
    lane), ``medium_sweeps`` (segment-medium pairs that passed the box cull
    and swept the boundary), ``warp_medium_sweeps`` (warp iterations in
    which a lane swept), ``pixel_segments`` ((width*height,) int32), and the
    persistent grid, ``blocks`` and ``blocks_per_sm``."""
    dev = cs.device
    if dev.type == "cpu":
        return render_batch_megakernel_plain(
            cs, sample_start, n_samples, seed, width=width, height=height,
            max_depth=max_depth)
    if dev.type != "cuda":
        raise ValueError(f"render_batch_megakernel: unsupported device {dev}")
    if not megakernel_supported(cs, need_aux=False, shader_kind=0):
        raise ValueError("render_batch_megakernel: the scene is outside the "
                         "megakernel gate (megakernel_supported)")
    return launch(cs, sample_start, n_samples, seed, width=width,
                  height=height, max_depth=max_depth, stats=stats)


def launch(cs: CompiledScene, sample_start, n_samples, seed, *, width,
           height, max_depth, stats=None):
    """``render_batch_megakernel``'s launch on a CUDA scene, without the
    gate check: the wrapper calls it after the check, and the gate sweep
    (``gate_sweep.py``) calls it to time K5 past the gate's limits."""
    dev = cs.device
    if dev.type != "cuda":
        raise ValueError(f"megakernel.launch: unsupported device {dev}")
    n_pix = width * height
    if int(n_samples) <= 0:   # nothing to trace
        return (torch.zeros((n_pix, 3), dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    t = scene_tables(cs)
    accum = torch.empty((n_pix, 3), dtype=torch.float32, device=dev)
    segs = torch.empty((n_pix,), dtype=torch.int32, device=dev)
    work = torch.zeros((4,), dtype=torch.int64, device=dev)
    grid = (ctypes.c_int * 2)()
    p = _build.ptr
    m = t.media
    err = _build.library().k5_render_launch(
        p(t.cam), p(t.sph), t.sph.shape[0], p(t.pln), t.pln.shape[0],
        p(t.frame), p(t.mats), t.mats.shape[0], p(t.tex_attr),
        t.tex_attr.shape[0],
        p(t.texels), t.texels.shape[0], p(t.lights), t.lights.shape[0],
        p(m.sph), p(m.pln), p(m.sph_off_t), p(m.pl_off_t), p(t.med),
        p(m.box), m.n_media, width, height, int(sample_start),
        int(n_samples), max_depth, int(seed), t.flags, p(accum), p(segs),
        p(work), grid, _build.stream_of(accum))
    _build.check(err, "k5_render")
    render_batch_megakernel.launches += 1
    if stats is not None:
        _, iterations, sweeps, warp_sweeps = work.tolist()
        stats.update(warp_iterations=iterations, medium_sweeps=sweeps,
                     warp_medium_sweeps=warp_sweeps, pixel_segments=segs,
                     blocks=grid[0], blocks_per_sm=grid[1])
    return accum, segs.sum(dtype=torch.int64)


render_batch_megakernel.launches = 0
