#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``solstrale_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (each prints one line of numbers; a failed phase raises, so the
script exits non-zero):
  0. device: a CUDA card must be present (name and power limit from
     nvidia-smi, torch and CUDA versions);
  1. build: compile the CUDA kernels from ``solstrale_tpu_torch/csrc`` (one
     nvcc per source, in parallel) and print ptxas' resource lines;
  2. kernels: K1-K4 against their plain PyTorch versions on the card, with
     each kernel's device time (``device_ms``: calls queued behind a sleep,
     so the host's enqueue time is not in it), its wrapper's time on an idle
     card (``wrapper_ms``: enqueue included), the plain version's time and
     the bound (K1 at the main path's 131,072 lanes and at the 16,384 of its
     tail, slots equal on every hit, with the box and prim tests per ray of
     the treelet tree and of the kernel tree; K2 and K3, t, kind and idx
     equal, on the mixed BVH scene's tables and lane counters, the shapes
     the main path gives them, with the device kernels one call of each and
     of the scene's whole ``integrator.scene_hit`` runs, K2 also on the
     many-light scene's 63 sphere emitters, and K3 also on two overlapping
     media; K4, t, kind and idx equal, on the kitchen's,
     likewise, and on the same two media);
  2b. the draw kernel (``csrc/rng.cu``, ``ops.rng.uniform4``) against its
     plain chain, bit for bit, at the main path's shapes (the wide pool's
     131,072 lanes, the tail's 16,384, the camera's int bounce, a 1080p
     ``render_pixels`` wavefront) and every argument form the callers pass
     (int32 and int64 lanes, ints, 0-dim sample and seed on the card, a
     broadcast pair, pixel ids past 2**32), one launch and one device
     kernel a call, timed at 131,072 lanes against its byte bound;
  2c. the wavefront step's kernels (``csrc/step.cu``): S1
     (``ops.step.step_shade``, the shading, the fold and the flags) and S2
     (``ops.step.step_regen``, the scan of the terminal flags, the rows,
     the queue and the regeneration) against their plain versions
     (``integrator.shade_plain``,
     ``_Wavefront.step_plain`` / ``reset_plain``) bit for bit at the wide
     pool's 131,072 lanes on six scenes (the interior, the textured
     sponza, production, many_lights, the mixed scene at depth 4, the
     normal-mapped kitchen on K4 at depth 4), S2's reset and six chained
     steps each (S1 alone in the wavefront pool's form), every output
     equal (NaN where the plain has NaN); at each step S1 in trace's carry
     form (the carried color, alive, the parked direction) with its record
     (``ops.step.shade_with_record``) and without against
     ``shade_plain(..., record=True, color=...)`` bit for bit, a quarter
     of the lanes parked, and S1B (``ops.step.step_shade_backward``, the
     differentiable route's backward) against ``step_shade_backward_plain``
     on that record and finite upstream gradients from a seed (the color's
     0 on a third of the lanes), each adding into sums of its own: the
     carried color's and the fold's gradients bit for bit, lanes S1B passes
     through included, the arena's, the background's and the materials'
     attenuation sums (all finite) within 1e-5 of the magnitudes summed,
     and 1e-7; then the carried color's and the fold's gradients alone
     again with the color's gradient inf or NaN on a few lanes, which must
     not pass; the attenuation's gradient on the kitchen-sink solid scene
     (its attenuated quad light) through K4, S1 and S1B against autograd
     through the torch composition on the card; S2 alone
     against ``regen_plain`` on edge pools (20,000 and 131,149 lanes, no
     multiple of its block; 16,384 and 131,072; random flags, every
     active lane terminal, none), three calls each; one captured step
     replayed 8 times against as many plain steps; each kernel's device,
     wrapper and plain time against its byte bound (S1B's on the mixed
     scene's record, with the fixed trip's upstream gradients, as the
     inverse step calls it: into a sums buffer made once, so its device
     time is the kernel's alone; and checked on the same record with every
     lane's texel row one row, a solid colour); S1's (both forms), S2's
     and S1B's device time and bound at 16,384, 106,400, 131,072 and
     2,073,600 lanes, S1B checked against its plain version at each (at
     2,073,600
     each block of its resident grid loops over several tiles), and
     ptxas' registers and spills of the
     step kernels; S1 and the step on a seventh scene, whose small tables
     are too large to stage in shared memory, chained as on the six;
  2d. the first hit's kernels (``csrc/first_hit.cu``): CR
     (``ops.first_hit.camera_rays``, the camera rays of a list of pixel
     ids) against ``integrator.camera_rays_plain`` and FH
     (``ops.first_hit.first_hit_shade``, the debug shaders' color and the
     aux planes from the depth-0 hit) against the plain functions
     (``first_hit_aux_plain``, ``shade_*_plain``) bit for bit at the wide
     pool's 131,072 lanes and at a 1080p image's 2,073,600 on 2c's six
     scenes, every shader kind and plane combination; each one's device,
     wrapper and plain time against its byte bound, ptxas' registers and
     spills of both, and S1 still at 64 registers or fewer without
     spills;
  2e. the first hit's backward kernels (``csrc/first_hit.cu``): FHB
     (``ops.first_hit.first_hit_backward``, the planes' gradients to the
     arena, the background, the rays and the frame columns of sph_attr and
     pl_attr) and CRB (``camera_rays_backward``, the rays' gradients to the
     camera's seven tensors) against their plain versions
     (``first_hit_backward_plain``, ``camera_rays_backward_plain``) at
     phase 2d's widths on its six scenes, on CR's rays and their depth-0
     hit (K1's planar slots and (kind, idx)), every shader kind and plane
     combination, upstream gradients from a seed: the rays' gradients bit
     for bit, every sum within 1e-5 of the magnitudes summed into each
     entry, and 1e-7; each kernel's device, wrapper and plain time against
     its byte bound and the copy floor, FH's time on the same planes
     beside FHB's, ptxas' lines of both; then the route at full width:
     ``torch.autograd.grad`` of a seeded loss over ``render_pixels`` at
     1920x1080 with the simple shader and the aux planes on the interior
     and the textured sponza, the arena, the background, the camera, and
     sph_attr and pl_attr requiring grad: CR, FH, CRB and FHB one launch
     each, no draw kernel and no S1, against autograd through
     ``camera_rays_plain`` and ``first_hit_plain`` on the card (the same
     planes bit for bit, the gradients within 1e-5 of the magnitudes),
     its forward and forward + backward ms;
  3. main path at full size: ``ray_trace`` on the 262,088-triangle interior
     at 1920x1080 (untextured, then with spheres,
     a medium and textures), launch counts read around both renders, and
     ``render_sample_batch`` timed like ``bench.py`` (median of three);
  3b. the small-scene path at full size: ``ray_trace`` at 1920x1080 of the
     solid kitchen-sink scene and of the normal-mapped one (K5's normal-map
     instantiation), each one K5 launch per batch and no other kernel (no
     K4, S1 or S2), launch counts read around each, and
     ``render_sample_batch`` of both timed at bench.py's settings (400x266,
     8 spp, depth 50, median of three);
  3c. K5 against its plain version exactly (max abs error 0, equal
     segments) and a repeated launch bit for bit, at 1920x1080x8 on the
     solid kitchen-sink scene (43,809,619 segments, asserted) and at
     400x266x8 on the kitchen-sink scene without its normal map (image
     texture, triangles, a triangle light), which is also timed at
     1920x1080x8, and on a 24-light scene (the light-pdf mean above its
     unroll of 16) at 160x120x8; on the normal-mapped kitchen (the
     kernel's normal-map instantiation) at 400x266x8 and at 1920x1080x8,
     timed there with its bound; with each launch's work counts
     (active-lane efficiency, the static one-pixel-per-thread map's, the
     medium sweep shares, the persistent grid); K5 against
     ``trace_queued`` (the K4 route) at 1920x1080x1 on both kitchens; and
     the aux batch of the normal-mapped kitchen at 400x266x8
     (``render_sample_batch`` with the aux planes: one K5 launch and one
     replay of the first-hit pass) against its eager form (K5's plain
     version and ``first_hit_pass_eager``) bit for bit;
  3e. ``trace_queued``'s card driver (CUDA graph replays of
     ``integrator.GRAPH_STEPS`` steps of the hit kernels, S1 and S2 (its
     scan inside), one stop read a replay) against the eager loop (the
     plain step) bit for bit, image and segments: sponza 1080p (its recorded
     segments), the textured sponza, production, many_lights, the mixed
     scene (K1-K3) and the normal-mapped kitchen (K4) at 400x266x8; one
     capture replayed at two sample_starts, a second seed its own capture,
     and a replayed batch's launches equal to its steps (no draw kernel);
  3d. the renderer's surface at full size: ``ray_trace`` on the interior
     at 1920x1080 with bloom and the denoiser, checkpointed every sample and
     resumed from sample 1 bit for bit (K1, S1, S2, and CR and FH once a
     sample for the aux planes; never K5 or the draw kernel); the albedo,
     normal and simple shaders at 1920x1080 on the interior (K1) and the
     kitchen (K4), one CR and one FH launch a sample, never K5 or the draw
     kernel; the sample pass (``render_pixels``, the path shader, early
     exit, depth 50, grad mode on as a user calls it) at 1920x1080 on the
     mixed scene (K1, K2, K3), the normal-mapped kitchen (K4) with the aux
     planes and the textured sponza (K1): one replay of its CUDA graph
     (``integrator.sample_pass``, captured by a first call) against the
     eager fixed trip (``early_exit=False``) and the eager early exit
     (``sample_pass_eager``, one host read a bounce), every plane bit for
     bit, CR once, FH once with the aux planes, S1 once a bounce (51 on
     the graph and the fixed trip, with the same launches; the early
     exit's bounces logged), and ``render_sample`` of the same (one
     replay, its planes); two ``sample_pass`` lines, the mixed and the
     kitchen pass graphed, as the eager fixed trip and with one read a
     bounce, wall ms, busy ms, bounces, host reads and replays of each
     (``wavefront_ab.sample_pass_times``); K1
     and K4 over all 2,073,600 camera rays of a 1080p image in one launch
     equal to 16 launches of 131,072; the CNN denoiser on the card against
     the CPU; times of the denoiser, bloom, ``first_hit_aux``, the hit
     kernels alone and CR on the 2,073,600 camera rays, the debug shaders
     and the aux-on batch against the aux-off one;
  4. card against CPU and determinism: five small scenes (the fifth a
     128-triangle terrain loaded from an OBJ with textures, a normal map and
     a height map: the wavefront with K4) rendered on the card and on the
     CPU with the path shader (with and without the aux channels) and the
     three debug shaders, and the card run repeated bit for bit; every
     pixel outside 1e-3 there and in phase 7 (up to 8 a scene) is traced
     to the first (sample, bounce) and quantity at which the two devices'
     lanes part, one ``card_vs_cpu_outlier`` line each;
  5. diff and parallel: the inverse-rendering step (the fixed trip's
     forward and its checkpointed path-replay backward, every bounce S1
     with its backward S1B) on the mixed scene at 1920x1080, depth 50
     (K1-K3) and on the kitchen at 400x266 (K4), against a target at seed
     2: taken by hand, a finite loss, a non-zero finite gradient, its peak
     memory and the kernels' launches in the forward (S1 51, CR 1 for
     the camera rays) and in the replay (S1 50, S1B 51; no draw kernel in
     either),
     one zero fill of the arena's size in the backward and no add of one
     (the pass's gradient sums), its loss equal to
     that of the route before S1B (autograd through ``shade_plain``, put in
     place of ``path_step_grad`` by ``_parent_route_step``) and its
     gradient within rtol 1e-4, atol 1e-7 (atomic sums grouped otherwise),
     beside the peak memory, time and gradient
     (rtol 1e-5) of the step that keeps the whole tape (checkpoint
     replaced by a plain call), the first hit's backwards CRB and FHB
     never launched, the step's dispatched ops and kernel launches, forward
     and backward, as before them (``STEP_DEVICE_WORK``); then ``diff.image_and_texture_grad`` as it
     runs on the card (one captured CUDA graph, replayed) beside the same
     step run op by op (``diff._GradStep.eager``): one capture, the
     replay equal to the eager step (loss rtol 1e-5, gradient rtol 1e-5,
     atol 1e-7), no host read in a call, a replay's launches equal to the
     eager forward's and replay's, each step's time (CUDA events, three of
     each in turns, median and all), the capture's time and the peak bytes
     of the capture, a replay and the eager step, and the graph pool's
     resident bytes, and one replay under ``torch.profiler`` (device ops a
     step, the fills and adds among them, busy time, each kernel's time);
     on the kitchen, a 10-step SGD loop through
     ``set_texture_params`` from a scene of its own, one capture, its
     final arena equal to the eager loop's (rtol 1e-4, atol 1e-7); card
     against CPU gradients at 64x32, depth 8 (rtol 1e-3, atol 1e-4); on a
     one-rank NCCL group, ``render_batch_sharded`` on the interior at 1080p
     equal to ``render_sample_batch`` (6,708,708 segments),
     ``render_sample_sharded`` on the kitchen at 400x266 equal to
     ``render_sample`` (planes and launches: one replay each of the sample
     pass's graph, 51 S1 launches) and to the eager early exit's planes,
     ``train_step_sharded`` (its shard step graphed too) equal to one
     ``image_and_texture_grad`` SGD step and
     ``render_distributed``'s final image (a capture's warm-up and two
     replays, 153 S1 launches; its passes' sum equal to the eager early
     exit's); the denoiser trainer for a few
     steps at 64x64, and one Adam step on the card against the CPU;
  6. OBJ ingest and the device BVH build: the sponza-class terrain written
     as a 262,088-triangle OBJ with its MTL and PNG textures
     (``fixtures.write_obj_scene``), parsed by the native C++ parser and by
     the plain Python one (every triangle equal), loaded with ``Obj``,
     compiled with ``use_bvh="device"`` (the LBVH built with torch on the
     card) and with ``use_bvh=True``: the card's tree equal exactly to the
     host build's and to the same function on the CPU; ``ray_trace`` of the
     loaded scene at 1920x1080, 1 spp, depth 50 through K1 (K1's launches
     count in the kernels line), a non-black frame; the write, parse, load,
     compile and build times;
  7. bench: the port's throughput script (``solstrale_tpu_torch.bench``)
     over bench.py's five workloads at full size, its JSON lines printed
     as they end (Mrays/s, every run's seconds, segments, route, launches),
     each workload's route and hit kernels checked (K1 and K2 on the
     production and many-light interiors, K1 on the textured sponza, one
     K5 launch a batch on the kitchen and the megakernel workload, K5 on
     no BVH scene; these launches count in the kernels line), and its three
     new scenes at a small size on the card against the CPU, repeated bit
     for bit;
  8. four cards: with four cards or more visible, the sharded routes on
     four NCCL ranks, one a card, each held to one card
     (``python -m solstrale_tpu_torch.parallel.four_card``, run in this
     process: ``render_batch_sharded``, ``render_sample_sharded``,
     ``render_distributed`` and ``train_step_sharded`` on the 4x1 and the
     2x2 mesh, its JSON lines, and the phase fails if a check does); with
     fewer, one line saying that the phase did not run and how many cards
     are visible.
The last lines are the card's name and power limit, the kernels' JSON
summary (K1-K5, the draw kernel, S1, S2, S1B, CR, FH, CRB and FHB; every
kernel but the draw kernel launched at least once, or the script fails;
the draw kernel's launches are those of the denoised render of phase 3d,
0: no route on the card launches it since CR and FH draw in registers;
K4's those of phase 3d's debug shaders and first-hit passes on the
kitchen, whose path color K5 renders; K5's those of phases 3b and 7; CR's
and FH's those of phase 3d's denoised render and debug shaders and of
phase 2e's routes, and CR's of phase 5's graphed steps too; S1B's those
of phase 5's graphed steps, its ``ms`` the kernel alone; CRB's and FHB's
those of phase 2e's routes, their ``ms`` at 2,073,600 lanes on the
interior, CRB's with the fill of its (19,) sums) and the result line.
"""
import json
import os
import subprocess
import sys
import time

# segments of the sponza 1080p, 1 spp, seed 1 batch (unchanged since the
# port first rendered it)
SPONZA_SEGMENTS = 6708708
# segments of the kitchen-solid 1920x1080, 8 spp, seed 1 K5 batch (unchanged
# since the port first rendered it)
KITCHEN_SOLID_SEGMENTS = 43809619
# K5 against trace_queued, rtol = atol (test_megakernel.py:40); against its
# plain version K5 is exact
TOL_K5 = 2e-3

# f32 operations of one ray-prim test, counted from csrc/hit.cuh (sqrt and
# division count one each; compares not counted)
FLOPS_SPHERE = 31
FLOPS_PLANAR = 32
# FLOPS_PLANAR in parts: a planar row's numerator and denominator
# (hit::planar_nd: d.n 5, o.n 5, the subtraction), its division, and the
# rest of its test (the hit point and both functionals). K3's and K4's
# bounds charge the division and the rest only where a sweep needs them
# (_planar_rows)
FLOPS_PLANAR_ND = 11
FLOPS_PLANAR_DIV = 1
FLOPS_PLANAR_REST = FLOPS_PLANAR - FLOPS_PLANAR_ND - FLOPS_PLANAR_DIV
# one box of K1's slab test (csrc/bvh.cu slab2 and its callers): per axis
# two subtractions and two multiplies, the interval's min and max, and on
# the second and third axes the fold into near and far; the entry's clamp
# at 0 and the far widening
FLOPS_SLAB = 24
# The media loop of K3, K4 and K5 (csrc/sweep.cu media_events,
# csrc/megakernel.cu): per live ray of a scene with media the direction's
# reciprocals; per ray and medium hit::box_reach (8 per axis); per ray that
# reaches the box beyond its two boundary sweeps the flight uniform 1,
# t1 + 1e-4 1 and hit::medium_event 12
MEDIUM_INV = 3
MEDIUM_BOX = 24
MEDIUM_EVENT = 14
# K5's f32 operations beyond the sweeps, counted line by line from
# csrc/megakernel.cu: an add, subtract, multiply, division, square root,
# min or max is one, a call of sinf, cosf, acosf, atan2f, expf or logf is
# one; compares, selects, sign changes and the integer PCG4D hash are not
# counted, and a division by a loop-invariant value counts as its multiply.
# Where the work depends on a branch this run does not split (the kind of
# prim hit, the light picked, a dielectric's reflection or refraction),
# the cheapest branch is charged.
K5_SEGMENT = 16    # every segment: hit::make_ray 15, total_len 1
#                    (and the media loop's MEDIUM_* per segment)
K5_PATH = 58       # every path: camera_ray 46, the terminal fold 12
K5_HIT = 24        # every emission and scatter: the hit point 6, the
#                    cheapest attributes (a medium's phase normal) 13,
#                    sample_texture 5
K5_BLEND = 3       # every emission and scatter of a scene with blends
K5_PDF = 127       # every NEE scatter beyond its light pdfs: the onb 38,
#                    the cheaper bsdf sample (isotropic) 11, light pick and
#                    the cheaper light sample (quad, triangle) 15, the draws
#                    9, light_pdf_mean's own 7, the mixture pdf 37, the fold
#                    of a pdf level 12
K5_BASIC = 51      # every metal or dielectric scatter: the cheaper, a
#                    dielectric reflection off a back face, 45, the fold 6
K5_NORMAL_MAP = 26  # every scatter off a normal map (the kNormalMaps
#                    instantiation): the map's sample_texture 5, its
#                    tangent-space normal 6, the frame's onb_local 15 (a
#                    planar hit's frame is two loads; a sphere's costs more)
K5_LIGHT = {0: 31, 1: 55, 2: 57}   # light_pdf_mean per sphere / quad /
#                                    triangle light, per NEE scatter
# S1's and S2's f32 operations (csrc/step.cu, counted as K5's): every lane of
# S1 the hit point 6 and the terminal fold 12; each emission and scatter
# K5_HIT - 6 more (attributes, texture), each scatter K5_PDF plus its light
# pdfs or K5_BASIC; every lane S2 regenerates its camera ray, 46
S1_LANE = 18
S2_REGEN = 46
# the lanes of the step kernels' checks and times: the wide pool's; phase
# 2c's scenes (``_wavefront_scene``) and the widths its S1, S2 and S1B are
# timed at besides (the tail pool's, a 400x266 inverse step's, and a 1080p
# render_pixels', the inverse step's)
STEP_LANES = 131072
STEP_SCENES = ("sponza", "sponza_textured", "sponza_production",
               "many_lights", "mixed", "kitchen")
STEP_WIDTHS = (16384, 106400, 131072, 2073600)
# chained steps checked per scene in phase 2c
STEP_BOUNCES = 6


def log(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def bound(nbytes, flops):
    """The least time the card could take (``wavefront_ab.bound_ms``: the
    larger of the bytes over the memory rate and the f32 operations over
    the f32 peak, one H100 SXM's published peaks)."""
    from solstrale_tpu_torch.wavefront_ab import bound_ms

    ms, by = bound_ms(nbytes, flops)
    return dict(bound_ms=ms, bound_by=by)


def sweep_flops(n_sph, n_pl):
    return n_sph * FLOPS_SPHERE + n_pl * FLOPS_PLANAR


def k5_flops(t, light_kinds, n_paths, segments, ev, sweeps):
    """K5's f32 operations for a batch from the kinds of segment it traced
    (``ev``, from the plain version's ``events``) and the segment-medium
    pairs whose ray could reach the medium's box (``sweeps``, from the
    kernel's count; each charged the cheapest medium's two sweeps)."""
    mt = t.media
    per_segment = (K5_SEGMENT + sweep_flops(t.sph.shape[0], t.pln.shape[0])
                   + ((MEDIUM_INV + MEDIUM_BOX * mt.n_media) if mt.n_media
                      else 0))
    per_sweep = MEDIUM_EVENT + min(
        (2 * sweep_flops(*(x.shape[0] for x in mt.boundary(m)))
         for m in range(mt.n_media)), default=0)
    hits = ev["emit"] + ev["pdf"] + ev["basic"]
    # a scene with normal maps and blends walks the normal draw's blend on
    # every scatter
    maps_blend = (t.flags & 2) and (t.flags & 1)
    return (segments * per_segment + sweeps * per_sweep + n_paths * K5_PATH
            + hits * (K5_HIT + K5_BLEND * (t.flags & 1))
            + ev["pdf"] * (K5_PDF + sum(K5_LIGHT[k] for k in light_kinds))
            + ev["basic"] * K5_BASIC + ev["mapped"] * K5_NORMAL_MAP
            + (ev["pdf"] + ev["basic"]) * K5_BLEND * bool(maps_blend))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def live_rays(d):
    """Rays with a non-zero direction (parked rays need no work)."""
    return int(((d[0] != 0) | (d[1] != 0) | (d[2] != 0)).sum().item())


def reset_launches(wrappers):
    for fn in wrappers.values():
        fn.launches = 0


def launch_counts(wrappers):
    return {k: fn.launches for k, fn in wrappers.items()}


def all_wrappers():
    """Each kernel's wrapper on the routes, by kernel name: the bench's
    (K1-K5, the draw kernel, S1, S2, S1B, CR, FH) and the first hit's
    backwards, CRB and FHB."""
    from solstrale_tpu_torch import bench
    from solstrale_tpu_torch.ops import first_hit

    return dict(bench.kernel_wrappers(), CRB=first_hit.camera_rays_backward,
                FHB=first_hit.first_hit_backward)


def wrapper_ms(fn, reps=5, warmup=2):
    """Median milliseconds of one fn() on an idle card, CUDA events around
    the call: the host's enqueue (Python, ctypes, the wrapper's own ops)
    lies inside the interval."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


_SLEEP = {}


def _sleep_cycles_per_ms():
    """torch.cuda._sleep's cycles per millisecond on this card (timed once
    with CUDA events)."""
    import torch

    if "rate" not in _SLEEP:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        torch.cuda._sleep(20_000_000)
        b.record()
        torch.cuda.synchronize()
        _SLEEP["rate"] = 20_000_000 / a.elapsed_time(b)
    return _SLEEP["rate"]


def device_ms(fn, n=20, reps=3, warmup=2):
    """Milliseconds of device time per fn(): ``n`` calls queued behind a
    ``torch.cuda._sleep`` that outlasts their enqueue, CUDA events around
    the n calls, so the card runs them back to back and the host's time is
    not in the interval. Median of ``reps``. Where the host falls behind
    the sleep (a slow enqueue, or a full launch queue, which blocks the
    host until the card drains it) the sleep grows and n halves; raises if
    even one call cannot be queued behind a second's sleep (fn must not
    synchronise)."""
    import torch

    for _ in range(warmup):
        fn()
    rate = _sleep_cycles_per_ms()
    times, sleep_ms = [], 20.0
    while len(times) < reps:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(sleep_ms * rate))
        a.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        torch.cuda.synchronize()
        if host_ms < 0.8 * sleep_ms:
            times.append(a.elapsed_time(b) / n)
        elif n == 1 and sleep_ms >= 1000.0:
            raise RuntimeError("device_ms: the host did not stay ahead of "
                               "the card")
        else:
            sleep_ms = min(1000.0, 2.0 * host_ms + 10.0)
            n = max(1, n // 2)
    times.sort()
    return times[len(times) // 2]


def kernel_times(fn, plain):
    """The device, wrapper and plain times of a kernel's wrapper ``fn`` and
    its plain version ``plain``."""
    return dict(ms=device_ms(fn), wrapper_ms=wrapper_ms(fn),
                plain_ms=wrapper_ms(plain, reps=3, warmup=1))


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "false; this smoke test runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", gpu=smi, kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0])
    return smi


def phase_build():
    from solstrale_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    resources = [ln.strip() for ln in _build.BuildInfo.log.splitlines()
                 if "registers" in ln or "Compiling entry" in ln
                 or "spill" in ln]
    log("build", seconds=time.perf_counter() - t0,
        nvcc_seconds=_build.BuildInfo.seconds, ptxas=resources)


def _procedural_tables(device):
    """64 spheres and 1,024 quads + triangles and two overlapping medium
    boxes (K3, K4)."""
    import numpy as np
    import solstrale_tpu_torch as T
    from solstrale_tpu_torch.scene.compile import compile_scene

    rng = np.random.default_rng(5)
    mat = T.Lambertian(T.SolidColor(0.5, 0.5, 0.5))
    world = [T.Sphere(rng.uniform(-8, 8, 3), float(rng.uniform(0.2, 1.0)),
                      mat) for _ in range(64)]
    for _ in range(512):
        q = rng.uniform(-8, 8, 3)
        world.append(T.Quad(q, rng.normal(size=3), rng.normal(size=3), mat))
    for _ in range(512):
        v0 = rng.uniform(-8, 8, 3)
        world.append(T.Triangle(v0, v0 + rng.normal(size=3),
                                v0 + rng.normal(size=3), mat))
    world.append(T.Sphere((0, 50, 0), 5.0, T.DiffuseLight(5, 5, 5)))
    world.append(T.ConstantMedium(
        T.Bvh(T.new_box((-3, -2, -3), (3, 2, 3), mat)), 0.4, (1, 1, 1)))
    world.append(T.ConstantMedium(
        T.Bvh(T.new_box((0, -4, 0), (5, 1, 5), mat)), 0.7, (1, 1, 1)))
    scene = T.Scene(T.Bvh(world), T.CameraConfig(look_from=(0, 0, 10)),
                    (0, 0, 0), T.RenderConfig(width=8, height=8))
    return compile_scene(scene, use_bvh=False, device=device)


def _random_rays(n, device, seed, parked=0):
    import torch

    g = torch.Generator().manual_seed(seed)
    o = (torch.rand((n, 3), generator=g) * 20 - 10)
    d = torch.randn((n, 3), generator=g)
    d[n - parked:] = 0.0
    o, d = o.to(device), d.to(device)
    return (o[:, 0], o[:, 1], o[:, 2]), (d[:, 0], d[:, 1], d[:, 2])


def _bounces(cs, o, d, pix, park_misses):
    """Cosine bounce rays from the camera rays' closest hits."""
    import torch
    from solstrale_tpu_torch.geo import INF, RAY_T_MIN, soa
    from solstrale_tpu_torch.ops import bvh, rng
    from solstrale_tpu_torch.renderer import integrator

    t, kind, idx = bvh.bvh_closest_hit(cs.kbvh, cs.solids, o, d, RAY_T_MIN,
                                       INF)
    hit = torch.isfinite(t)
    attrs = integrator.full_hit_attributes(
        cs, o, d, torch.where(hit, t, 0.0), kind, idx, pix, 1, 0, 1)
    r1, r2, _, _ = rng.uniform4(pix, 1, 0, rng.P_COSINE, 1)
    bd = soa.onb_local3(*soa.onb_from_w3(attrs["normal"]),
                        rng.cosine_direction3(r1, r2))
    if park_misses:
        bd = tuple(torch.where(hit, c, 0.0) for c in bd)
    return soa.where3(hit, attrs["point"], o), bd


def _subsampled_rays(cs, n=16384, parked=256):
    """Camera rays of (n - parked) / 2 pixels spread evenly over the 1080p
    image, a cosine bounce from each one's hit point, and ``parked``
    zero-direction rays. Returns (o, d, parked mask (numpy))."""
    import torch
    from solstrale_tpu_torch.renderer import integrator

    dev = cs.device
    n_cam = (n - parked) // 2
    pix = torch.linspace(0, 1920 * 1080 - 1, n_cam, device=dev).long()
    o, d = integrator.camera_rays_plain(cs, pix, 1, 1, 1920, 1080)
    bo, bd = _bounces(cs, o, d, pix, park_misses=False)
    zeros = torch.zeros(parked, device=dev)
    po = tuple(torch.full((parked,), 2.0, device=dev) for _ in range(3))
    oo = tuple(torch.cat([a, b, c]) for a, b, c in zip(o, bo, po))
    dd = tuple(torch.cat([a, b, zeros]) for a, b in zip(d, bd))
    mask = torch.zeros(n_cam * 2 + parked, dtype=torch.bool)
    mask[n_cam * 2:] = True
    return oo, dd, mask.numpy()


def _queue_rays(cs, lanes=131072):
    """The first lanes/2 camera rays in trace_queued's queue order (1080p,
    sample 1, seed 1) and their cosine bounces (parked where the camera ray
    missed), as the wavefront's first iteration and a later one give them.
    Returns (o, d)."""
    import torch
    from solstrale_tpu_torch.renderer import integrator

    half = lanes // 2
    pix, samp = integrator.queue_assignment(
        torch.arange(half, device=cs.device), 1920, 1080, 1)
    o, d = integrator.camera_rays_plain(cs, pix, samp, 1, 1920, 1080)
    bo, bd = _bounces(cs, o, d, pix, park_misses=True)
    return (tuple(torch.cat([a, b]) for a, b in zip(o, bo)),
            tuple(torch.cat([a, b]) for a, b in zip(d, bd)))


def _walk_stats(tree, o, d):
    """The walk (``accel.walk_counts``) of ``tree`` = (node_min, node_max,
    prims, leaf size) by these rays: mean and p99 box and prim tests per
    ray (parked rays included), their sums and the distinct prim rows
    read; and its (t, slot)."""
    from solstrale_tpu_torch.accel import walk_counts
    from solstrale_tpu_torch.geo import RAY_T_MIN

    t, slot, boxes, tests, rows = walk_counts(*tree, o, d, RAY_T_MIN)
    b, p = boxes.double(), tests.double()
    return dict(box_mean=b.mean().item(), box_p99=b.quantile(0.99).item(),
                prim_mean=p.mean().item(), prim_p99=p.quantile(0.99).item(),
                box_tests=int(b.sum().item()), prim_tests=int(p.sum().item()),
                prim_rows_read=rows), (t, slot)


def _treelet_tree(cs):
    """The treelet tree, for its walk counts: the median split stopped at
    the treelet roots, leaves of 8 prims in the order of the last split
    (the JAX layout's order, which K1 walked before the kernel tree split
    on: its leaf table is recovered from the ``rows`` field), boxes built
    as the kernel tree's are. Returns (node_min, node_max, prims, leaf
    size) on the card."""
    import dataclasses
    import torch
    from solstrale_tpu_torch import accel

    kb = cs.kbvh
    p_t = kb.tr * kb.leaf_size
    nbt = max(1, (p_t + 127) // 128)
    prims = kb.rows.reshape(kb.n_troots, nbt, 16, 128).transpose(2, 3) \
        .reshape(kb.n_troots, nbt * 128, 16)[:, :p_t].reshape(-1, 16) \
        .contiguous()
    host = type(cs.solids)(**{f.name: getattr(cs.solids, f.name).cpu()
                              for f in dataclasses.fields(cs.solids)})
    lo, hi = accel.leaf_tree(host, prims.cpu(), kb.leaf_size)
    return (torch.from_numpy(lo).to(prims.device),
            torch.from_numpy(hi).to(prims.device), prims, kb.leaf_size)


def _k1(cs):
    """K1 on the 262,088-triangle tree at the main path's two shapes: 131,072
    lanes (the first 65,536 camera rays in trace_queued's tile order and
    their bounces) and the 16,384 of the wavefront's tail (camera and bounce
    rays of 8,064 pixels spread over the image, 256 parked): equal to its
    plain version (hit sets, t and every slot) with its bound a Python
    number (a kernel argument, the main path's form) and as a tensor a
    ray, kernel and plain times, and the box and prim tests per ray of the
    walk (``accel.walk_counts``) of the treelet tree and of the kernel
    tree. The kernels line's row is the 131,072 lanes'. Its bound counts
    what these rays need: the walk's box and prim tests, against the bytes
    of the rays in (24 a ray) and out (8) and of each prim row some ray
    tests, read once (the kernel's own node table is not an input of the
    function and is not charged)."""
    import torch
    from solstrale_tpu_torch.accel import WALK_LEAF
    from solstrale_tpu_torch.geo import RAY_T_MIN
    from solstrale_tpu_torch.ops import bvh

    kb = cs.kbvh
    treelet = _treelet_tree(cs)
    row = None
    shapes = {"main": _queue_rays(cs), "tail": _subsampled_rays(cs)[:2]}
    for shape, (o, d) in shapes.items():
        r = o[0].numel()
        t_k, s_k = bvh.bvh_planar_hit(kb, o, d, RAY_T_MIN)
        t_p, s_p = bvh.bvh_planar_hit_plain(kb.prims, o, d, RAY_T_MIN)
        parked = (d[0] == 0) & (d[1] == 0) & (d[2] == 0)
        if not (torch.equal(t_k, t_p) and torch.equal(s_k, s_p)):
            raise AssertionError(f"K1 ({shape}): (t, slot) differ from the "
                                 "plain version")
        if torch.isfinite(t_k[parked]).any():
            raise AssertionError(f"K1 ({shape}): a parked ray hit")
        # the bound as a tensor a ray, as JAX's wrapper broadcasts it
        t_b, s_b = bvh.bvh_planar_hit(kb, o, d, torch.full_like(
            o[0], RAY_T_MIN))
        if not (torch.equal(t_b, t_k) and torch.equal(s_b, s_k)):
            raise AssertionError(f"K1 ({shape}): a bound a ray differs from "
                                 f"the scalar bound")
        tm = kernel_times(
            lambda: bvh.bvh_planar_hit(kb, o, d, RAY_T_MIN),
            lambda: bvh.bvh_planar_hit_plain(kb.prims, o, d, RAY_T_MIN))
        walk, (t_w, s_w) = _walk_stats(
            (kb.node_min, kb.node_max, kb.prims, WALK_LEAF), o, d)
        if not (torch.equal(t_w, t_p) and torch.equal(s_w, s_p)):
            raise AssertionError(f"K1 ({shape}): the walk's (t, slot) "
                                 "differ from the brute force")
        walk_treelet, _ = _walk_stats(treelet, o, d)
        b = bound(r * 32 + walk["prim_rows_read"] * 64,
                  walk["box_tests"] * FLOPS_SLAB
                  + walk["prim_tests"] * FLOPS_PLANAR)
        log("kernel", name="K1 bvh_planar_hit", shape=shape, rays=r,
            live_rays=live_rays(d), prims=int(kb.prims[:, 13].sum().item()),
            hits=int(torch.isfinite(t_k).sum().item()), max_abs_err=0.0,
            slots_equal=True, **tm, walk_kernel_tree=walk,
            walk_treelet_tree=walk_treelet, **b)
        if shape == "main":
            row = dict(max_abs_err=0.0, **tm, **b)
    return row


def phase_kernels(sponza_cs):
    import torch
    from solstrale_tpu_torch import profiling

    dev = torch.device("cuda")
    out = {}

    out["K1"] = _k1(sponza_cs)

    # the kernels line's K2 and K3 rows come from the main path's shapes
    # (_main_path_k2_k3), K4's from the kitchen's (_check_k4)
    traces = {}
    _main_path_k2_k3(out, traces)
    _many_light_k2()

    # K3 and K4 on procedural tables with two media boxes (the second
    # overlaps the first, so it clips against the first's events) and
    # seeded counters
    cs = _procedural_tables(dev)
    o, d = _random_rays(65536, dev, seed=1, parked=256)
    g = torch.Generator().manual_seed(3)
    counters = (torch.randint(0, 2**40, (65536,), generator=g).to(dev),
                torch.randint(0, 64, (65536,), generator=g).to(dev),
                torch.randint(0, 50, (65536,), generator=g,
                              dtype=torch.int32).to(dev), 3)
    _check_k3("K3 media_hit (procedural)", cs, o, d, counters)
    _check_k4("K4 scene_hit (procedural)", cs, o, d, counters)
    # and at the main path's shape: the normal-mapped kitchen-sink scene's
    # tables, 131,072 lanes of 1080p camera rays and their bounces
    kcs, ko, kd, counters = _kitchen_rays(dev)
    out["K4"] = _check_k4("K4 scene_hit (kitchen)", kcs, ko, kd, counters,
                          traces)
    # the device kernels of one call each: K2's, K3's and K4's a route makes
    # are one kernel (no fill, RNG, stack, combine, where or decode op), and
    # K1 takes its scalar bound as an argument (no fill)
    kernels = profiling.device_kernels(traces)
    for key, want in (("K2 bvh_sphere_hit", ["k2_bvh_spheres"]),
                      ("K3 media_hit", ["k3_media"]),
                      ("K4 integrator.scene_hit", ["k4_scene_hit"]),
                      ("bvh_closest_hit", ["k1_bvh", "k2_bvh_spheres"]),
                      ("BVH integrator.scene_hit",
                       ["k1_bvh", "k2_bvh_spheres", "k3_media"])):
        got = kernels[key]
        if len(got) != len(want) or not all(w in g for w, g in zip(want, got)):
            raise AssertionError(f"{key}: one call ran {got}")
    log("kernels_per_call", **{
        k: [g.replace("(anonymous namespace)::", "").split("(")[0][:60]
            for g in v] for k, v in kernels.items()})
    return out


def phase_draws():
    """2b: the draw kernel (``csrc/rng.cu``, ``ops.rng.uniform4``) against
    its plain chain (``uniform4_plain``) at the main path's shapes and at
    every argument form the callers pass: the four floats bit for bit (so
    the top 24 bits of every PCG4D word), one launch a call (one device
    kernel at the wide pool's form), ``uniform`` row 0 of it. Timed at the
    wide pool's 131,072 lanes and at 2,073,600 (a 1080p image's camera
    rays, whose draws CR now makes in registers: no route on the card
    launches the draw kernel); bound: the counters read once (int64 pixel and
    sample, int32 bounce; an int is no bytes) and four f32 written, over
    the memory rate. Returns its row of the kernels line."""
    import torch
    from solstrale_tpu_torch import profiling
    from solstrale_tpu_torch.ops import rng
    from solstrale_tpu_torch.renderer import integrator

    dev = torch.device("cuda")
    lanes = 131072
    start = torch.tensor(1, device=dev)
    pix, samp = integrator.queue_assignment(
        torch.arange(lanes, device=dev), 1920, 1080, start)
    g = torch.Generator().manual_seed(5)
    bounce = torch.randint(0, 51, (lanes,), generator=g,
                           dtype=torch.int32).to(dev)
    full = torch.arange(1920 * 1080, device=dev)
    wide = (pix, samp, bounce, 1)
    forms = {
        "wide pool": wide,
        "tail pool": (pix[:16384], samp[:16384], bounce[:16384], 1),
        "camera (int bounce 0)": (pix, samp, 0, 1),
        "1080p wavefront of render_pixels": (
            full, torch.full_like(full, 3),
            torch.zeros_like(full, dtype=torch.int32), 1),
        "int32 counters": (pix.int(), samp.int(), bounce, 1),
        "int sample": (pix, 7, bounce, 1),
        "0-dim seed on the card": (pix, samp, bounce,
                                   torch.tensor(2**31 - 1, device=dev)),
        "0-dim sample on the card": (pix, start, bounce, 1),
        "broadcast (512, 1) x (1, 256)": (pix[:512, None], samp[None, :256],
                                          2, 9),
        "pixel ids past 2**32": (pix + 2**33, samp, bounce, 1),
    }
    checked = 0
    for purpose in (rng.P_JITTER, rng.P_COSINE, rng.P_MEDIUM_BASE + 2):
        for name, (a, b, c, seed) in forms.items():
            before = rng.uniform4.launches
            got = rng.uniform4(a, b, c, purpose, seed)
            if rng.uniform4.launches != before + 1:
                raise AssertionError(f"draws ({name}): not one launch")
            want = rng.uniform4_plain(a, b, c, purpose, seed)
            words = rng.words4(a, b, c, purpose, seed)
            for x, y, w in zip(got, want, words):
                if x.shape != y.shape or not torch.equal(
                        x.view(torch.int32), y.view(torch.int32)) or \
                        not torch.equal((x * 16777216.0).long(), w >> 8):
                    raise AssertionError(f"draws ({name}, purpose "
                                         f"{purpose}): the kernel differs "
                                         "from the plain chain")
            if not torch.equal(rng.uniform(a, b, c, purpose, seed), got[0]):
                raise AssertionError(f"draws ({name}): uniform is not row 0")
            checked += 1
    kernels = profiling.device_kernels(
        {"draw": lambda: rng.uniform4(*wide[:3], rng.P_COSINE, wide[3])})
    if len(kernels["draw"]) != 1 or "rng_uniform4" not in kernels["draw"][0]:
        raise AssertionError(f"draws: one call ran {kernels['draw']}")
    tm = kernel_times(lambda: rng.uniform4(*wide[:3], rng.P_COSINE, 1),
                      lambda: rng.uniform4_plain(*wide[:3], rng.P_COSINE, 1))
    # a 1080p render_pixels' camera rays' width (the draws CR now makes in
    # registers), the pixel ids with an int sample and bounce
    camera = dict(ms=device_ms(lambda: rng.uniform4(full, 1, 0, rng.P_JITTER,
                                                    1)),
                  **bound(nbytes(full) + 16 * full.shape[0], 0))
    row = dict(max_abs_err=0.0, **tm,
               **bound(nbytes(pix, samp, bounce) + 16 * lanes, 0),
               widths={full.shape[0]: camera})
    log("kernel", name="rng_uniform4 (draws)", lanes=lanes,
        forms=list(forms), calls_checked=checked, bit_equal=True,
        device_kernels_per_call=1, **row)
    return row


_SCENES = {}


def _wavefront_scene(name, sponza_cs=None):
    """(cs, width, height, spp) of a wavefront scene of phases 2c and 3e,
    compiled once: ``sponza`` (the main path's untextured interior, 1080p),
    the bench's ``sponza_textured``, ``sponza_production`` (1080p) and
    ``many_lights`` (960x540), ``mixed`` (K1-K3, 1080p), the normal-mapped
    ``kitchen`` (K4, 400x266x8) and ``many_materials`` (K1, 640x360: the
    1,152 tiles of ``fixtures.many_material_scene``, whose small tables S1
    reads from device memory)."""
    import solstrale_tpu_torch as T
    from solstrale_tpu_torch import bench, fixtures
    from solstrale_tpu_torch.scene.compile import compile_scene

    if name == "sponza":
        return sponza_cs, 1920, 1080, 1
    if name not in _SCENES:
        if name == "many_materials":
            cs = compile_scene(fixtures.many_material_scene(T.RenderConfig(
                width=640, height=360, seed=1)), device="cuda")
            _SCENES[name] = (cs, 640, 360, 1)
        elif name == "mixed":
            cs = compile_scene(fixtures.mixed_bvh_scene(T.RenderConfig(
                width=1920, height=1080, seed=1), n_cells=362), device="cuda")
            _SCENES[name] = (cs, 1920, 1080, 1)
        elif name == "kitchen":
            cs = compile_scene(fixtures.kitchen_sink_scene(T.RenderConfig(
                width=400, height=266, samples_per_pixel=8, seed=1)),
                device="cuda")
            _SCENES[name] = (cs, 400, 266, 8)
        else:
            w = next(x for x in bench.WORKLOADS
                     if x.name == {"sponza_textured": "sponza"}.get(name,
                                                                    name))
            cs = compile_scene(w.scene(T.RenderConfig(
                width=w.width, height=w.height, samples_per_pixel=w.spp,
                seed=1)), device="cuda")
            _SCENES[name] = (cs, w.width, w.height, 1)
    return _SCENES[name]


def _same(a, b):
    """Bit-equal values: the same NaNs, the rest equal (torch.equal)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def _same_wavefront(wk, wp):
    """The names of the state that differs between two ``_Wavefront``s: the
    wide pool's per-lane tensors, the rows below the discard row, the queue
    head and the segments."""
    from solstrale_tpu_torch.ops import step

    names = ("qpos", "pixel", "sample", *step.LANE_ARRAYS)
    bad = [n for n, a, b in zip(names, wk.pools[0].tensors(),
                                wp.pools[0].tensors()) if not _same(a, b)]
    for n in ("next_q", "segments"):
        if not _same(getattr(wk, n), getattr(wp, n)):
            bad.append(n)
    if not _same(wk.accum[:wk.total_q], wp.accum[:wp.total_q]):
        bad.append("accum")
    return bad


def _s1_work(cs, hit, st, r, carry=False):
    """S1's bytes and f32 operations on one call's hit (t, kind, idx as S1
    takes them: no kind where idx is K1's planar slot) and results ``st``.
    Bytes: per lane the hit (``kind`` only where given), the counters, the
    queue position (the pool's form) or, with ``carry`` (trace's form), the
    active flag and the carried color on each lane that does not end, the
    lane arrays in and out, the color and the flags; the distinct attribute
    rows the lanes read (on K1's slot, each slot's entry of ``pl_row`` too)
    and the small tables whole; texel rows not counted."""
    import torch
    from solstrale_tpu_torch.ops import step
    from solstrale_tpu_torch.scene.compile import (KIND_MEDIUM, KIND_SPHERE,
                                                   KIND_TRIANGLE)

    tab = step.step_tables(cs)
    _, kind, idx = hit
    n_pl = tab.pln.shape[0]
    if kind is None:
        # S1 maps every lane's clamped slot to its row through pl_row
        ps = idx.clamp(0, max(n_pl - 1, 0))
        rows = int(torch.unique(ps).numel()) * (112 + 4) if n_pl else 0
        lane_hit = 4 * 2
    else:
        sph = (kind == KIND_SPHERE) & bool(tab.flags & step.FLAG_SPHERES)
        pl = ~sph & ~((kind == KIND_MEDIUM) & (tab.med_mat.shape[0] > 0))
        slot = torch.where(kind == KIND_TRIANGLE, tab.n_q + idx, idx)
        slot = slot.clamp(0, max(n_pl - 1, 0))
        rows = ((int(torch.unique(slot[pl]).numel()) * 112 if n_pl else 0)
                + int(torch.unique(idx[sph]).numel()) * 32)
        lane_hit = 4 * 3
    lane = (lane_hit + 8 + 8           # t (kind) idx, pixel sample
            + (1 if carry else 8)      # active, or the queue position
            + 2 * (4 * 14 + 4)         # the lane arrays in and out
            + 12 + 6)                  # color, flags
    small = nbytes(tab.small, tab.med_mat)
    carried = 12 * int((~st["terminal"]).sum()) if carry else 0
    scat, pdf = st["scat"], st["scat"] & st["is_pdf"]
    hits = int((st["emit"] | scat).sum())
    light = sum(K5_LIGHT[k] for k in cs.light_kinds)
    flops = (r * S1_LANE + hits * (K5_HIT - 6 + K5_BLEND * (tab.flags & 1))
             + int(pdf.sum()) * (K5_PDF + light)
             + int((scat & ~st["is_pdf"]).sum()) * K5_BASIC)
    return r * lane + rows + small + carried, flops


def _s2_work(cs, r, n_term):
    """S2's bytes and f32 operations on ``r`` lanes of which ``n_term``
    end: per lane its queue position and terminal flag (9 B); per lane it
    regenerates the color read and its row written (24), the queue
    position, pixel and sample ids (24), the ray (24), bounce and acc_len
    (8); a status word a block (8), the camera row, and the queue head,
    segment count and ticket read and written once; the camera ray of each
    regenerated lane."""
    from solstrale_tpu_torch.ops import step

    words = step.scan_words(r)
    return (9 * r + 80 * n_term + 8 * words
            + nbytes(step.step_tables(cs).cam) + 2 * (8 + 8 + 8),
            S2_REGEN * n_term)


def _step_times(cs, w, h, spp, depth):
    """S1 and S2 timed on the wide pool after two plain steps
    (``wavefront_ab.step_kernel_calls``): S1 in trace_queued's form (the
    pool's queue positions, new outputs) and in trace's carry form
    (``s1_carry``), each against ``shade_plain``; S2, its scan of S1's
    flags inside,
    on those flags (idempotent once the queue head is put back before each
    call; that 8-byte copy's own time is subtracted) against
    ``regen_plain``; S1B on the pool's next hit (``wavefront_ab.s1b_calls``:
    upstream gradients as the fixed trip gives them), and on the same
    record with every lane's texel row one row (``s1b_one_row``: a solid
    colour, where a warp sums one row). Returns their kernels-line
    rows."""
    import torch
    from solstrale_tpu_torch import wavefront_ab
    from solstrale_tpu_torch.ops import bvh
    from solstrale_tpu_torch.renderer import integrator

    r = STEP_LANES
    c = wavefront_ab.step_kernel_calls(cs, w, h, spp, r, depth)
    wf, pool, (t, kind, idx), args = c["wf"], c["pool"], c["hit"], c["args"]
    kp, ip = (kind, idx) if kind is not None else bvh.decode_planar_slot(
        cs.solids, idx)
    s1 = kernel_times(c["s1"], lambda: integrator.shade_plain(
        cs, c["o"], c["d"], t, kp, ip, *args))
    s1.update(bound(*_s1_work(cs, c["hit"], c["shaded"], r)))
    s1_carry = kernel_times(c["s1_carry"], lambda: integrator.shade_plain(
        cs, c["o"], c["d"], t, kp, ip, *args, color=c["carry"]))
    s1_carry.update(bound(*_s1_work(cs, c["hit"], c["shaded_carry"], r,
                                    carry=True)))
    term = c["terminal"]
    n_term = int(term.sum())
    if int(wf.next_q) + n_term > wf.total_q:
        raise AssertionError("step times: the queue runs out, so repeated "
                             "regenerations would not repeat")

    def s2_plain():
        c["restore"]()
        wf.regen_plain(cs, pool, pool.color, term)

    base = kernel_times(c["restore"], c["restore"])
    s2t = kernel_times(c["s2"], s2_plain)
    for k in ("ms", "wrapper_ms", "plain_ms"):
        s2t[k] -= base[k]
    s2t.update(bound(*_s2_work(cs, r, n_term)))
    s1b = _s1b_row(cs, wavefront_ab.s1b_calls(cs, pool, args[-2], depth))
    # a solid colour: every lane's texel row one row, the most read one
    rows = s1b.pop("rec")[0]
    read = rows[rows >= 0]
    top = int(torch.mode(read).values) if read.numel() else 0
    solid = _s1b_row(cs, wavefront_ab.s1b_calls(cs, pool, args[-2], depth,
                                                 one_row=top), timed=False)
    solid.pop("rec")
    return dict(s1=dict(max_abs_err=0.0, **s1),
                s1_carry=dict(max_abs_err=0.0, **s1_carry),
                s2=dict(max_abs_err=0.0, **s2t), s1b=s1b, s1b_one_row=solid,
                terminal_lanes=n_term)


def _width_times(cs, w, h, spp, lanes):
    """S1's (both forms), S2's and S1B's device ms and bound at ``lanes``
    lanes (depth 50), as ``_step_times`` sets them up; S1B as the inverse
    step calls it
    (``wavefront_ab.s1b_calls``), and checked there against its plain
    version (``_s1b_against_plain``): above ~270,000 lanes each block of
    its resident grid loops over several tiles of lanes."""
    from solstrale_tpu_torch import wavefront_ab

    c = wavefront_ab.step_kernel_calls(cs, w, h, spp, lanes)
    n_term = int(c["terminal"].sum())
    restore = device_ms(c["restore"])
    pool = c["pool"]
    b = wavefront_ab.s1b_calls(cs, pool, pool.qpos < c["wf"].total_q)
    err = _s1b_against_plain(b["rec"], b["ab"], cs.textures.pixels,
                             cs.bg_color, b["g_color"], b["g_out"])
    return dict(
        s1=dict(ms=device_ms(c["s1"]),
                **bound(*_s1_work(cs, c["hit"], c["shaded"], lanes))),
        s1_carry=dict(ms=device_ms(c["s1_carry"]),
                      **bound(*_s1_work(cs, c["hit"], c["shaded_carry"],
                                        lanes, carry=True))),
        s2=dict(ms=device_ms(c["s2"]) - restore, restore_ms=restore,
                **bound(*_s2_work(cs, lanes, n_term))),
        s1b=dict(ms=device_ms(b["launch"]), max_abs_err=max(err.values()),
                 **bound(*wavefront_ab.s1b_work(b["rec"], b["g_color"]))),
        terminal_lanes=n_term)


# S2's edge pools of phase 2c: (lanes, flags) with lanes no multiple of its
# block or the tail pool's width, every active lane terminal, or none
S2_EDGES = ((20000, "ragged"), (131149, "all"), (16384, "none"),
            (131072, "ragged"))
# replays of one captured step held to as many plain steps in phase 2c
STEP_REPLAYS = 8


def _s2_edges(cs, w, h):
    """S2 with its in-kernel scan against ``regen_plain`` bit for bit on
    ``S2_EDGES``: two wavefronts in one state (reset and one plain step),
    then three calls each on the last one's state, with flags from a seed
    (random, every active lane, none) and random colors; after each the
    pool, the rows, the queue head and the segments equal, the ticket back
    at 0 and the launch counted. Returns the terminal lanes of each
    call."""
    import torch
    from solstrale_tpu_torch.ops import step
    from solstrale_tpu_torch.renderer import integrator

    out = {}
    for lanes, case in S2_EDGES:
        spp = -(-3 * lanes // (w * h)) + 1
        wk, wp = (integrator._Wavefront(cs.device, w, h, 50, spp, 1, lanes,
                                        None, None) for _ in range(2))
        for wf in (wk, wp):
            wf.begin(1, None)
            wf.reset_plain(cs, wf.pools[0])
            wf.step_plain(cs, wf.pools[0])
        pk, pp = wk.pools[0], wp.pools[0]
        gen = torch.Generator(device="cuda").manual_seed(lanes)
        seen = []
        for k in range(3):
            active = pp.qpos < wp.total_q
            if case == "ragged":
                term = torch.rand(lanes, generator=gen, device="cuda") < 0.3
            else:
                term = torch.full((lanes,), case == "all", device="cuda")
            term &= active
            color = torch.rand((lanes, 3), generator=gen, device="cuda")
            pk.color.copy_(color)
            pp.color.copy_(color)
            step.step_regen(cs, wk, pk, term.clone())
            wp.regen_plain(cs, pp, color, term)
            bad = _same_wavefront(wk, wp)
            if wk.ticket.tolist() != [0, k + 1]:
                bad.append(f"ticket {wk.ticket.tolist()}")
            if bad:
                raise AssertionError(f"S2 ({lanes} lanes, {case}, call {k}) "
                                     f"differs from regen_plain in {bad}")
            seen.append(int(term.sum()))
        out[f"{lanes}_{case}"] = seen
    return out


def _replayed_steps(cs, w, h, spp, depth):
    """One ``_Wavefront.step`` (the hit kernels, S1 and S2 with its scan)
    captured as a CUDA graph after a warm-up step, replayed
    ``STEP_REPLAYS`` times, each replay held bit for bit to a plain step
    (``step_plain``) of a twin wavefront: the pool, the rows, the queue
    head, the segments (so the scan's ticket comes back to 0 and its
    launch count moves on inside a graph, as the kernel promises)."""
    import torch
    from solstrale_tpu_torch.renderer import integrator

    wk, wp = (integrator._Wavefront(cs.device, w, h, depth, spp, 1,
                                    STEP_LANES, None, None)
              for _ in range(2))
    wk.reset(cs, 1, None)
    wp.begin(1, None)
    wp.reset_plain(cs, wp.pools[0])
    pk, pp = wk.pools[0], wp.pools[0]
    integrator.warm_up(cs.device, lambda: wk.step(cs, pk))
    wp.step_plain(cs, pp)
    graph, counts = integrator.capture_counted(lambda: wk.step(cs, pk))
    for k in range(STEP_REPLAYS):
        integrator.replay_counted(graph, counts)
        wp.step_plain(cs, pp)
        bad = _same_wavefront(wk, wp)
        if bad:
            raise AssertionError(f"replay {k} of a captured step differs "
                                 f"from step_plain in {bad}")
    torch.cuda.synchronize()
    return dict(replays=STEP_REPLAYS, next_q=int(wk.next_q),
                segments=int(wk.segments))


def _upstream(r, seed):
    """Upstream gradients of S1's color and fold outputs, from a seed: (R,
    3) and six (R,) f32 on the card, finite; the color's 0 (+0 or -0) on a
    third of the lanes, where S1B passes a quiet lane's fold gradients
    through."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    g_color = torch.randn((r, 3), generator=gen, device="cuda")
    u = torch.rand((r, 1), generator=gen, device="cuda")
    g_color = torch.where(u < 1 / 6, 0.0, torch.where(u < 1 / 3, -0.0,
                                                      g_color))
    return (g_color, [torch.randn((r,), generator=gen, device="cuda")
                      for _ in range(6)])


def _wild(g_color, seed):
    """``g_color`` with inf on 0.5% of the lanes and NaN on another 0.5%
    (from a seed), which S1B must not pass through."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.rand((g_color.shape[0], 1), generator=gen, device="cuda")
    g_color = torch.where((u > 0.99) & (u < 0.995), float("inf"), g_color)
    return torch.where(u >= 0.995, float("nan"), g_color)


def _sums_close(name, got, want, scale):
    """An atomic sum against the plain version's: within 1e-5 of the sum
    of the magnitudes added into each entry (``scale``; the rounding of a
    float32 sum taken in another order is relative to it, not to the sum
    itself, where signed terms cancel), and 1e-7."""
    import torch

    bad = (got - want).abs() > 1e-5 * scale + 1e-7
    if bool(bad.any()) or not torch.equal(torch.isnan(got),
                                          torch.isnan(want)):
        raise AssertionError(f"{name}: {int(bad.sum())} entries differ, the "
                             f"largest by {float((got - want).abs().max())}")


def _s1b_against_plain(rec, ab, arena, bg, g_color, g_out, sums=True,
                       mats=None):
    """S1B (``ops.step.step_shade_backward``, the carry form) against its
    plain version on the same inputs, each adding into sums of its own:
    the carried color's and the fold's gradients bit for bit and, with
    ``sums``, the arena's and the background's sums (by atomics on the
    card) and, with ``mats`` (the material table's rows), the materials'
    attenuation sums, within 1e-5 of the magnitudes summed into each
    entry, and 1e-7 (``_sums_close``; the magnitudes: the plain backward of
    the upstream's absolute values), the plain sums all finite, so that no
    entry is held as NaN against NaN. Returns the largest absolute
    differences of the sums (with ``sums``)."""
    import torch
    from solstrale_tpu_torch.ops import step

    dev, r = arena.device, rec.shape[1]
    k_sums, p_sums, s_sums = (torch.zeros((arena.shape[0] + 1, 3),
                                          device=dev) for _ in range(3))
    k_mat, p_mat, s_mat = ((torch.zeros((mats, 9), device=dev)
                            if sums and mats else None) for _ in range(3))
    k_carry, p_carry = (torch.empty((r, 3), device=dev) for _ in range(2))
    k_ab = step.step_shade_backward(rec, ab, arena, bg, g_color, g_out,
                                    k_sums, g_carry=k_carry, g_mats=k_mat)
    p_ab = step.step_shade_backward_plain(rec, ab, arena, bg, g_color, g_out,
                                          p_sums, g_carry=p_carry,
                                          g_mats=p_mat)
    bad = [n for n, a, c in zip(step.FOLD_ARRAYS, k_ab, p_ab)
           if not _same(a, c)]
    if not _same(k_carry, p_carry):
        bad.append("carried color")
    if bad:
        raise AssertionError(f"S1B's gradients differ from the plain "
                             f"backward's in {bad}")
    if not sums:
        return {}
    if not (bool(torch.isfinite(p_sums).all())
            and (p_mat is None or bool(torch.isfinite(p_mat).all()))):
        raise AssertionError("S1B's check: the plain version's sums are not "
                             "all finite")
    step.step_shade_backward_plain(rec, ab, arena, bg, g_color.abs(),
                                   [g.abs() for g in g_out], s_sums,
                                   g_mats=s_mat)
    _sums_close("S1B's arena gradient", k_sums[:-1], p_sums[:-1],
                s_sums[:-1])
    _sums_close("S1B's background gradient", k_sums[-1], p_sums[-1],
                s_sums[-1])
    diff = (k_sums - p_sums).abs()
    out = dict(arena=float(diff[:-1].max()), bg=float(diff[-1].max()))
    if p_mat is not None:
        _sums_close("S1B's attenuation gradient", k_mat, p_mat, s_mat.abs())
        out["atten"] = float((k_mat - p_mat).abs().max())
    return out


def _s1b_check(cs, hit, lanes, args, seed):
    """S1 in trace's carry form, with its record
    (``ops.step.shade_with_record``) and without (``step_shade(...,
    color=...)``), against ``shade_plain(..., color=...)`` bit for bit
    (record, the carried colors, alive, the parked directions, flags, lane
    state), with a quarter of the active lanes parked and the carried
    color from ``seed``, then S1B against ``step_shade_backward_plain`` on
    that record, the lanes' fold and upstream gradients from ``seed``
    (``_upstream``; ``_s1b_against_plain``: the carried color's and the
    fold's gradients, the arena's, background's and materials' sums), and
    again with the color's gradient inf or NaN on a few lanes (``_wild``),
    where only the carried color's and the fold's gradients are held (a
    lane that missed or emitted makes its sums NaN). Returns the largest
    absolute differences of the sums, the lanes whose minimums tie and the
    lane channels S1B passes through (a parked lane's)."""
    import torch
    from solstrale_tpu_torch import wavefront_ab
    from solstrale_tpu_torch.ops import bvh, step
    from solstrale_tpu_torch.renderer import integrator

    t, kind, idx = hit
    o, d = lanes
    gen = torch.Generator(device="cuda").manual_seed(seed)
    parked = torch.rand(t.shape, generator=gen, device="cuda") < 0.25
    args = (*args[:6], args[6] & ~parked, args[7])
    kp, ip = (kind, idx) if kind is not None else bvh.decode_planar_slot(
        cs.solids, idx)
    carry = torch.randn((t.shape[0], 3), generator=gen, device="cuda")
    got, rec = step.shade_with_record(cs, t, kind, idx, o, d, *args,
                                      color=carry)
    alone = step.step_shade(cs, t, kind, idx, o, d, *args, color=carry)
    want = integrator.shade_plain(cs, o, d, t, kp, ip, *args, record=True,
                                  color=carry)
    bad = []
    for form, st in (("record", got), ("alone", alone)):
        bad += [f"{form} {k}" for k in ("color", "alive") + step.FLAGS
                if not _same(st[k], want[k])]
        bad += [f"{form} {k}" for k, a, c in zip(
            step.LANE_ARRAYS, step.lane_arrays(st), step.lane_arrays(want))
            if not _same(a, c)]
    if not _same(rec, want["record"]):
        bad.append("record")
    if bad:
        raise AssertionError(f"S1 in the carry form differs from "
                             f"shade_plain in {bad}")
    A, B = args[2][0], args[2][1]
    g_color, g_out = _upstream(t.shape[0], seed)
    out = _s1b_against_plain(rec, (*A, *B), cs.textures.pixels, cs.bg_color,
                             g_color, g_out,
                             mats=cs.materials.attr.shape[0])
    _s1b_against_plain(rec, (*A, *B), cs.textures.pixels, cs.bg_color,
                       _wild(g_color, seed), g_out, sums=False)
    pdf = (rec[3] & step.REC_PDF) != 0
    out["pdf_ties"] = sum(int(((B[c] == 3.0 * A[c]) & pdf).sum())
                          for c in range(3))
    out["passed_through"] = int(wavefront_ab.s1b_through(rec, g_color).sum())
    return out


def _s1b_row(cs, b, timed=True):
    """S1B on ``wavefront_ab.s1b_calls``'s call ``b``, against its plain
    version (``_s1b_against_plain``), and with ``timed`` its kernels-line
    row: its device time as the inverse step calls it (``ms``: the wrapper
    adding into a sums buffer made once, so the card runs the kernel
    alone), one call on an idle card (``wrapper_ms``), the plain version's
    time and the bound (``wavefront_ab.s1b_work``). The row keeps the
    record (``rec``) for the caller."""
    import torch
    from solstrale_tpu_torch import wavefront_ab
    from solstrale_tpu_torch.ops import step

    arena, bg = cs.textures.pixels, cs.bg_color
    args = (b["rec"], b["ab"], arena, bg, b["g_color"], b["g_out"])
    err = _s1b_against_plain(*args)
    row = dict(rec=b["rec"], max_abs_err=max(err.values()),
               **bound(*wavefront_ab.s1b_work(b["rec"], b["g_color"])))
    if timed:
        scratch = torch.zeros((arena.shape[0] + 1, 3), device=arena.device)
        row.update(ms=device_ms(b["launch"]),
                   wrapper_ms=wrapper_ms(b["launch"]),
                   plain_ms=wrapper_ms(lambda: step.step_shade_backward_plain(
                       *args, scratch, g_carry=b["g_carry"]), reps=3,
                       warmup=1))
    return row


def _atten_route(w=400, h=266, depth=8):
    """The materials' attenuation gradient on the card: ``diff.render_linear``
    of the kitchen-sink solid scene (an attenuated quad light, K4's route)
    at ``w`` x ``h``, depth ``depth``, with ``cs.materials.attr`` a leaf,
    S1B adding the factor's sums, against autograd through the torch
    composition on the card (``integrator.path_step_plain`` in place of
    ``path_step_grad``): the image the same bits, the gradient within rtol
    1e-4, atol 1e-7 (sums of atomics), not 0 on the light's factor and 0
    in every other entry; S1B once a bounce, K4 on every bounce (the
    checkpointed ones twice)."""
    import dataclasses

    import torch
    import solstrale_tpu_torch as T
    from solstrale_tpu_torch import diff, fixtures
    from solstrale_tpu_torch.ops import step, sweep
    from solstrale_tpu_torch.renderer import integrator
    from solstrale_tpu_torch.scene.compile import compile_scene

    cs = compile_scene(fixtures.kitchen_sink_solid_scene(T.RenderConfig(
        width=w, height=h, seed=1)), device="cuda")
    if cs.kbvh is not None:
        raise AssertionError("attenuation route: the scene is not on K4")

    def grads():
        attr = cs.materials.attr.clone().requires_grad_(True)
        leaf = dataclasses.replace(cs, materials=dataclasses.replace(
            cs.materials, attr=attr))
        img = diff.render_linear(leaf, width=w, height=h, max_depth=depth,
                                 n_samples=1, seed=1)
        return img.detach(), torch.autograd.grad(img.sum(), attr)[0]

    wrappers = {"S1B": step.step_shade_backward, "K4": sweep.scene_hit}
    reset_launches(wrappers)
    img, g = grads()
    launches = launch_counts(wrappers)
    route = integrator.path_step_grad
    integrator.path_step_grad = integrator.path_step_plain
    try:
        img_p, g_p = grads()
    finally:
        integrator.path_step_grad = route
    col = step.ATTEN_COL
    light = cs.materials.attr[:, col] > 0
    rest = torch.ones_like(g, dtype=torch.bool)
    rest[light, col] = False
    if not torch.equal(img, img_p):
        raise AssertionError("attenuation route: the image differs from the "
                             "torch composition's")
    torch.testing.assert_close(g, g_p, rtol=1e-4, atol=1e-7)
    if not (bool((g[light, col] != 0).all()) and not bool(g[rest].any())):
        raise AssertionError(f"attenuation route: gradient {g}")
    # the fixed trip's forward, and the checkpointed bounces again in the
    # backward
    if launches != {"S1B": depth + 1, "K4": 2 * depth + 1}:
        raise AssertionError(f"attenuation route: launches {launches}")
    return dict(width=w, height=h, depth=depth, launches=launches,
                grad=g[light, col].tolist(), plain_grad=g_p[light, col].tolist(),
                max_abs_err=float((g - g_p).abs().max()))


def phase_step(sponza_cs):
    """2c: the wavefront step's kernels S1 (``ops.step.step_shade``) and S2
    (``ops.step.step_regen``, its scan of the terminal flags inside)
    against their plain versions at the wide pool's 131,072 lanes on six
    scenes (``STEP_SCENES``: the main path's interior, the textured
    sponza, production, many_lights, the mixed scene, the normal-mapped
    kitchen on K4), and on a seventh whose small tables are too large to
    stage (``many_materials``, which takes S1's route that reads them from
    device memory): S2's reset mode against ``reset_plain``, then
    ``STEP_BOUNCES`` chained steps, each S1 alone (the pool's form)
    against ``shade_plain`` on the same inputs (every output: colors, the
    six flags, the lane state) and the whole step (``_Wavefront.step``: the
    hit kernels, S1 in place, S2) against ``step_plain`` (the pool, the
    accumulation rows, the queue head, the segments), all bit for bit; at
    each step too S1 in trace's carry form, with its record, and S1B
    against their plain versions (``_s1b_check``); the kitchen and the
    mixed scene at depth 4, so that the depth cap ends paths. Then, on the
    six, S2 alone against ``regen_plain`` on its edge pools
    (``_s2_edges``), a captured step's replays against plain steps
    (``_replayed_steps``), each kernel's device, wrapper and plain time
    against its bound, and S1's (both forms), S2's and S1B's device time
    and bound at ``STEP_WIDTHS``; the attenuation route
    (``_atten_route``); the log carries ptxas' registers, stack and spills
    of the step kernels.
    Returns the rows of the kernels line: S1's and S2's of the main path's
    interior, S1B's of the mixed scene (the inverse step's cell on
    K1-K3)."""
    import torch
    from solstrale_tpu_torch import wavefront_ab
    from solstrale_tpu_torch.ops import _build, bvh, step
    from solstrale_tpu_torch.renderer import integrator

    start = time.perf_counter()
    out, rows = {}, None
    for name in (*STEP_SCENES, "many_materials"):
        cs, w, h, spp = _wavefront_scene(name, sponza_cs)
        staged = step.stage_floats(step.step_tables(cs)) > 0
        if staged != (name != "many_materials"):
            raise AssertionError(f"step ({name}): S1 would "
                                 f"{'' if staged else 'not '}stage its "
                                 f"small tables")
        depth = 4 if name in ("mixed", "kitchen") else 50
        wk, wp = (integrator._Wavefront(cs.device, w, h, depth, spp, 1,
                                        STEP_LANES, None, None)
                  for _ in range(2))
        wk.reset(cs, 1, None)
        wp.begin(1, None)
        wp.reset_plain(cs, wp.pools[0])
        bad = _same_wavefront(wk, wp)
        if bad:
            raise AssertionError(f"step ({name}): S2's reset differs from "
                                 f"reset_plain in {bad}")
        counts = dict(miss=0, capped=0, emit=0, scat=0)
        s1b_seen = {}
        for b in range(STEP_BOUNCES):
            pk, pp = wk.pools[0], wp.pools[0]
            t, kind, idx = integrator.step_hit(cs, pp.o, pp.d, pp.pixel,
                                               pp.sample, pp.bounce, 1)
            kp, ip = (kind, idx) if kind is not None else \
                bvh.decode_planar_slot(cs.solids, idx)
            active = pp.qpos < wp.total_q
            args = (pp.bounce, pp.acc_len, pp.fold, pp.pixel, pp.sample, 1,
                    active, depth)
            got = step.step_shade(cs, t, kind, idx, pp.o, pp.d, *args[:6],
                                  (pp.qpos, wp.total_q), depth)
            want = integrator.shade_plain(cs, pp.o, pp.d, t, kp, ip, *args)
            bad = [k for k in ("color",) + step.FLAGS
                   if not _same(got[k], want[k])]
            bad += [k for k, a, c in zip(step.LANE_ARRAYS,
                                         step.lane_arrays(got),
                                         step.lane_arrays(want))
                    if not _same(a, c)]
            if bad:
                raise AssertionError(f"step ({name}, bounce {b}): S1 differs "
                                     f"from shade_plain in {bad}")
            for k in counts:
                counts[k] += int(want[k].sum())
            s1b = _s1b_check(cs, (t, kind, idx), (pp.o, pp.d), args, b)
            for k, v in s1b.items():
                s1b_seen[k] = (max(s1b_seen.get(k, 0), v)
                               if k in ("arena", "bg")
                               else s1b_seen.get(k, 0) + v)
            wk.step(cs, pk)
            wp.step_plain(cs, pp)
            bad = _same_wavefront(wk, wp)
            if bad:
                raise AssertionError(f"step ({name}, bounce {b}): the kernel "
                                     f"step differs from step_plain in {bad}")
        if name in ("mixed", "kitchen") and counts["capped"] == 0:
            raise AssertionError(f"step ({name}): no lane met the depth cap")
        if not s1b_seen["passed_through"]:
            raise AssertionError(f"step ({name}): S1B passed no lane's "
                                 f"fold gradients through")
        if not staged:
            out[name] = dict(depth=depth, bounces=STEP_BOUNCES,
                             segments=counts, s1b_check=s1b_seen,
                             small_bytes=nbytes(step.step_tables(cs).small))
            continue
        edges = _s2_edges(cs, w, h)
        replays = _replayed_steps(cs, w, h, spp, depth)
        times = _step_times(cs, w, h, spp, 50)
        if name == "sponza":
            rows = {"S1": times["s1"], "S2": times["s2"]}
        keys = ("ms", "bound_ms", "bound_by")
        widths = {lanes: _width_times(cs, w, h, spp, lanes)
                  if lanes != STEP_LANES else
                  dict(s1={k: times["s1"][k] for k in keys},
                       s1_carry={k: times["s1_carry"][k] for k in keys},
                       s2={k: times["s2"][k] for k in keys},
                       s1b={k: times["s1b"][k]
                            for k in keys + ("max_abs_err",)},
                       terminal_lanes=times["terminal_lanes"])
                  for lanes in STEP_WIDTHS}
        out[name] = dict(depth=depth, bounces=STEP_BOUNCES, segments=counts,
                         s1b_check=s1b_seen, s2_edges=edges,
                         graph_replays=replays, widths=widths, **times)
    # S1B's row: the mixed scene, the inverse step's cell on K1-K3, with its
    # times at each width
    rows["S1B"] = dict(out["mixed"]["s1b"], widths={
        lanes: v["s1b"] for lanes, v in out["mixed"]["widths"].items()})
    out["atten_route"] = _atten_route()
    torch.cuda.synchronize()
    log("step", lanes=STEP_LANES, bit_equal=True,
        ptxas=wavefront_ab.ptxas_lines(_build.BuildInfo.log),
        seconds=time.perf_counter() - start, **out)
    return rows


# the inverse step's device work in phase 5's step taken by hand, as
# measured with S1 and S1B in trace's carry form and K1 taking a scalar
# bound (the mixed scene at 1080p, the kitchen at 400x266, depth 50; an
# H100 80GB HBM3 at 700.00 W; ``python -m solstrale_tpu_torch.wavefront_ab
# --parent DIR --workloads step_kitchen,step_mixed``, ``step_by_hand``):
# for the forward and the backward, the ops dispatched that are not views
# (``wavefront_ab.dispatched_ops_mode``) and the hand-written kernels'
# launches (every wrapper's count). Both are the same in every run; a
# profiler trace's count of device ops is not, so phase 5 logs that one
# and holds these. The two runs of each tree gave these counts; the tree
# before (the torch glue of the carry, K1's bound fill) gave (1526, 205)
# and (1914, 251) on the mixed scene, (1220, 103) and (1614, 151) on the
# kitchen, where the profiler read 1,652 and 1,349 device ops a step
# against 485 and 283 with the carry form
STEP_DEVICE_WORK = {"mixed": dict(forward=(1016, 205), replay=(1307, 251)),
                    "kitchen": dict(forward=(761, 103), replay=(1057, 151))}

# phase 2d's widths, by lanes: (width, height, the pixel ids' form) of a
# whole 400x266 image (the inverse step's small width: every pixel id and
# an int sample, render_pixels' form), the wide pool's (pixel ids of a
# 1080p image in the wavefront's queue order, a sample a lane) and a 1080p
# image's (every pixel id and an int sample, the denoised render's)
FIRST_WIDTHS = {106400: (400, 266, "image"), 131072: (1920, 1080, "queue"),
                2073600: (1920, 1080, "image")}


def _copy_floor_ms(nbytes):
    """The card's own streaming floor for ``nbytes``: the device ms of one
    ``torch.Tensor.copy_`` that reads nbytes / 2 and writes as many (a
    yardstick beside a kernel's byte bound; the port never calls it)."""
    import torch

    src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    return device_ms(lambda: dst.copy_(src))


def _first_hit_check(name, cs, pix, sample, w, h):
    """CR and FH against their plain versions bit for bit (NaN where the
    plain has NaN) on ``pix`` with ``sample``: CR against
    ``camera_rays_plain``; then on CR's rays and their depth-0 hit
    (``integrator.step_hit``, as ``first_hit_planes`` takes it) FH with
    every debug shader and none, and every combination of the aux planes,
    each plane against the plain functions' (``integrator._DEBUG_PLAIN``,
    ``first_hit_aux_plain``), a plane not asked for not returned; one
    launch a call. Returns (CR's rays, the hit, the calls checked, the hit
    lanes)."""
    import torch
    from solstrale_tpu_torch.ops import first_hit
    from solstrale_tpu_torch.renderer import integrator

    before = first_hit.camera_rays.launches
    o, d = first_hit.camera_rays(cs, pix, sample, 1, w, h)
    if first_hit.camera_rays.launches != before + 1:
        raise AssertionError(f"first hit ({name}): CR not one launch")
    po, pd = integrator.camera_rays_plain(cs, pix, sample, 1, w, h)
    bad = [k for k, a, b in zip(("o0", "o1", "o2", "d0", "d1", "d2"),
                                (*o, *d), (*po, *pd)) if not _same(a, b)]
    if bad:
        raise AssertionError(f"first hit ({name}, {pix.shape[0]} lanes): CR "
                             f"differs from camera_rays_plain in {bad}")
    samp, bounce = integrator._depth0(pix, sample)
    hit = integrator.step_hit(cs, o, d, pix, samp, bounce, 1)
    want = {k: fn(cs, o, d, pix, sample, 1, hit)
            for k, fn in integrator._DEBUG_PLAIN.items()}
    want_aux = integrator.first_hit_aux_plain(cs, o, d, pix, sample, 1, hit)
    checked = 0
    for shader in (None, *integrator._DEBUG_PLAIN):
        for alb in (False, True):
            for nrm in (False, True):
                if shader is None and not (alb or nrm):
                    continue
                before = first_hit.first_hit_shade.launches
                got = first_hit.first_hit_shade(cs, *hit, o, d, pix, sample,
                                                1, shader, alb, nrm)
                if first_hit.first_hit_shade.launches != before + 1:
                    raise AssertionError(f"first hit ({name}): FH not one "
                                         f"launch")
                expect = dict(color=want.get(shader),
                              albedo=want_aux[0] if alb else None,
                              normal=want_aux[1] if nrm else None)
                bad = [k for k, v in expect.items()
                       if (v is None) != (got[k] is None)
                       or (v is not None and not _same(got[k], v))]
                if bad:
                    raise AssertionError(
                        f"first hit ({name}, {pix.shape[0]} lanes, shader "
                        f"{shader}, albedo {alb}, normal {nrm}): FH differs "
                        f"from the plain functions in {bad}")
                checked += 1
    return o, d, hit, checked, int(torch.isfinite(hit[0]).sum())


def phase_first_hit(sponza_cs):
    """2d: the first hit's kernels (``csrc/first_hit.cu``): CR
    (``ops.first_hit.camera_rays``) and FH (``first_hit_shade``) against
    their plain versions (``_first_hit_check``) at ``FIRST_WIDTHS``: a whole
    400x266 image's 106,400 lanes, the wide pool's 131,072 (the queue's
    pixel ids, a sample a lane) and a 1080p image's 2,073,600 (every pixel
    id, an int sample) on phase 2c's six scenes (camera rays from each
    scene's camera), every shader kind and plane combination; each
    kernel's device, wrapper and plain time (FH asked for the aux planes,
    the denoiser's form; and each debug shader's device time) against its
    bound (``wavefront_ab.cr_work`` / ``fh_work``) and beside the copy
    floor of as many bytes (``_copy_floor_ms``); FH's persistent grid
    (``first_hit_grid``); ptxas' registers and spills of CR and FH, and S1
    still at 64 registers or fewer with no spills. Returns the rows of the
    kernels line: CR's and FH's on the main path's interior at 2,073,600
    lanes (the denoised render's)."""
    import re

    import torch
    from solstrale_tpu_torch import wavefront_ab
    from solstrale_tpu_torch.ops import first_hit
    from solstrale_tpu_torch.renderer import integrator

    start = time.perf_counter()
    dev = torch.device("cuda")
    ptxas = wavefront_ab.build_log()
    # S1's entry alone ("step_shadeE" in its mangled name, not S1B's)
    s1 = wavefront_ab.ptxas_lines(ptxas, ("step_shadeE",))
    regs = [int(m.group(1)) for ln in s1
            for m in [re.search(r"Used (\d+) registers", ln)] if m]
    spills = [ln for ln in s1 if re.search(r"[1-9]\d* bytes spill", ln)]
    if len(regs) != 1 or regs[0] > 64 or spills:
        raise AssertionError(f"first hit: S1 at {regs} registers, spills "
                             f"{spills} ({s1})")
    out, rows, floors = {}, {}, {}
    for name in STEP_SCENES:
        cs = _wavefront_scene(name, sponza_cs)[0]
        per = {}
        for lanes, (w, h, form) in FIRST_WIDTHS.items():
            if form == "image":
                pix, sample = torch.arange(lanes, device=dev), 1
            else:
                pix, sample = integrator.queue_assignment(
                    torch.arange(lanes, device=dev), w, h,
                    torch.tensor(1, device=dev))
            o, d, hit, checked, hits = _first_hit_check(name, cs, pix, sample,
                                                        w, h)
            aux = dict(albedo=True, normal=True)

            def cr():
                return first_hit.camera_rays(cs, pix, sample, 1, w, h)

            def fh(shader=None, planes=aux):
                return first_hit.first_hit_shade(cs, *hit, o, d, pix, sample,
                                                 1, shader, **planes)

            cr_bytes, cr_ops = wavefront_ab.cr_work(cs, pix, sample)
            fh_bytes, fh_ops = wavefront_ab.fh_work(cs, o, d, hit, pix,
                                                    sample, aux)
            for nb in (cr_bytes, fh_bytes):
                if nb not in floors:
                    floors[nb] = _copy_floor_ms(nb)
            cr_row = dict(max_abs_err=0.0, **kernel_times(
                cr, lambda: integrator.camera_rays_plain(cs, pix, sample, 1,
                                                         w, h)),
                **bound(cr_bytes, cr_ops), copy_floor_ms=floors[cr_bytes])
            fh_row = dict(max_abs_err=0.0, **kernel_times(
                fh, lambda: integrator.first_hit_plain(
                    cs, o, d, *hit, pix, sample, 1, None, True, True)),
                **bound(fh_bytes, fh_ops), copy_floor_ms=floors[fh_bytes])
            none = dict(albedo=False, normal=False)
            shaders = {k: dict(ms=device_ms(lambda k=k: fh(k, none)),
                               **bound(*wavefront_ab.fh_work(
                                   cs, o, d, hit, pix, sample, none, k)))
                       for k in integrator._DEBUG_PLAIN}
            per[lanes] = dict(checked=checked, hit_lanes=hits, CR=cr_row,
                              FH=fh_row, FH_shader=shaders,
                              FH_grid=first_hit.first_hit_grid(lanes))
            if name == "sponza" and lanes == 2073600:
                rows = {"CR": cr_row, "FH": fh_row}
        out[name] = per
    torch.cuda.synchronize()
    log("first_hit", bit_equal=True, widths=list(FIRST_WIDTHS),
        ptxas=wavefront_ab.ptxas_lines(ptxas, ("camera_rays",
                                               "first_hit_shade",
                                               "step_shade")),
        seconds=time.perf_counter() - start, **out)
    return rows


def _fhb_calls(cs, o, d, hit, pix, sample):
    """The arguments of FHB's calls on one hit: (shader, planes' upstream
    gradients) for every debug shader and none and every combination of
    the aux planes, each gradient (R, 3) from a seed, finite."""
    import torch
    from solstrale_tpu_torch.renderer import integrator

    r = pix.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(r)
    g = {k: torch.randn((r, 3), generator=gen, device="cuda")
         for k in ("color", "albedo", "normal")}
    return [(shader, dict(color=g["color"] if shader else None,
                          albedo=g["albedo"] if alb else None,
                          normal=g["normal"] if nrm else None))
            for shader in (None, *integrator._DEBUG_PLAIN)
            for alb in (False, True) for nrm in (False, True)
            if shader is not None or alb or nrm]


def _fhb_run(fn, cs, o, d, hit, pix, sample, shader, planes, **kw):
    """One FHB call (``fn``: the kernel's wrapper or a plain version) into
    new sums: (the rays' gradients, (arena and background sums, sph_attr's,
    pl_attr's))."""
    import torch

    texels = cs.textures.pixels
    sums = torch.zeros((texels.shape[0] + 1, 3), device="cuda")
    g_sph = torch.zeros_like(cs.solids.sph_attr)
    g_pl = torch.zeros_like(cs.solids.pl_attr)
    ray = fn(cs, *hit, o, d, pix, sample, 1, texels, planes, shader, sums,
             g_sph=g_sph, g_pl=g_pl, **kw)
    return ray, (sums, g_sph, g_pl)


def _first_hit_grad_check(name, cs, o, d, hit, pix, sample, w, h):
    """FHB (``ops.first_hit.first_hit_backward``) and CRB
    (``camera_rays_backward``) against their plain versions on CR's rays
    and their depth-0 hit: FHB with every debug shader and none and every
    combination of the aux planes (``_fhb_calls``), one launch a call, the
    rays' gradients bit for bit, the arena's, the background's, sph_attr's
    and pl_attr's sums within 1e-5 of the magnitudes summed into each entry
    (the plain version's ``magnitudes``), and 1e-7 (``_sums_close``), the
    plain sums all finite; CRB likewise on seeded gradients of the rays.
    Returns (the calls checked, the largest difference of a sum)."""
    import torch
    from solstrale_tpu_torch.ops import first_hit

    checked, worst = 0, 0.0
    for shader, planes in _fhb_calls(cs, o, d, hit, pix, sample):
        before = first_hit.first_hit_backward.launches
        k_ray, k_sums = _fhb_run(first_hit.first_hit_backward, cs, o, d, hit,
                                 pix, sample, shader, planes)
        if first_hit.first_hit_backward.launches != before + 1:
            raise AssertionError(f"FHB ({name}): not one launch")
        p_ray, p_sums = _fhb_run(first_hit.first_hit_backward_plain, cs, o,
                                 d, hit, pix, sample, shader, planes)
        _, m_sums = _fhb_run(first_hit.first_hit_backward_plain, cs, o, d,
                             hit, pix, sample, shader, planes,
                             magnitudes=True)
        label = (f"FHB ({name}, {pix.shape[0]} lanes, shader {shader}, "
                 f"planes {[k for k, v in planes.items() if v is not None]})")
        bad = [k for k, a, b in zip(first_hit.RAY, k_ray, p_ray)
               if not _same(a, b)]
        if bad:
            raise AssertionError(f"{label}: the rays' gradients differ from "
                                 f"the plain version's in {bad}")
        for part, a, b, m in zip(("sums", "sph_attr", "pl_attr"), k_sums,
                                 p_sums, m_sums):
            if not bool(torch.isfinite(b).all()):
                raise AssertionError(f"{label}: the plain {part} are not "
                                     f"all finite")
            _sums_close(f"{label} {part}", a, b, m)
            if a.numel():
                worst = max(worst, float((a - b).abs().max()))
        checked += 1
    gen = torch.Generator(device="cuda").manual_seed(pix.shape[0] + 1)
    g_ray = torch.randn((6, pix.shape[0]), generator=gen, device="cuda")
    before = first_hit.camera_rays_backward.launches
    k_cam = first_hit.camera_rays_backward(cs, pix, sample, 1, w, h, g_ray)
    if first_hit.camera_rays_backward.launches != before + 1:
        raise AssertionError(f"CRB ({name}): not one launch")
    p_cam = first_hit.camera_rays_backward_plain(cs, pix, sample, 1, w, h,
                                                 g_ray)
    m_cam = first_hit.camera_rays_backward_plain(cs, pix, sample, 1, w, h,
                                                 g_ray, magnitudes=True)
    for field, a, b, m in zip(first_hit.CAMERA_FIELDS, k_cam, p_cam, m_cam):
        _sums_close(f"CRB ({name}, {pix.shape[0]} lanes) {field}", a, b, m)
        worst = max(worst, float((a - b).abs().max()))
    return checked + 1, worst, g_ray


# the upstream gradients FHB is timed on, the route's form: the simple
# shader's color and both aux planes (a debug view fitted with its aux
# planes, every output's gradient wanted)
ROUTE_PLANES = ("color", "albedo", "normal")

# ptxas' two lines (stack and spills; registers, barriers, shared memory)
# of the kernels FHB's redesign leaves alone, as the build before it gave
# them (sm_90a, on an H100 80GB HBM3); S1B's as its carry form gave it
# (the kernel without the materials' sums: its spills of 8 bytes gone)
PTXAS_KEPT = {
    "first_hit_shade": (
        "32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "Used 61 registers, used 1 barriers, 32 bytes cumulative stack "
        "size"),
    "camera_rays": (
        "32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "Used 31 registers, used 0 barriers, 32 bytes cumulative stack "
        "size"),
    "camera_rays_backward": (
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "Used 63 registers, used 1 barriers, 608 bytes smem"),
    "step_shade_backward": (
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "Used 32 registers, used 1 barriers, 16768 bytes smem")}


def _ptxas_of(log, name):
    """ptxas' lines (after its entry's name) of the kernel ``name`` in a
    build log: the entry whose mangled name holds the name itself (its
    length, then the name, then its arguments), so that ``camera_rays``
    is not ``camera_rays_backward``."""
    from solstrale_tpu_torch import wavefront_ab

    lines = wavefront_ab.ptxas_lines(log, (f"{len(name)}{name}E",))
    if not lines or sum("_GLOBAL__" in ln for ln in lines) != 1:
        raise AssertionError(f"ptxas: no single entry for {name}: {lines}")
    return tuple(lines[1:])


def phase_first_hit_grad(sponza_cs):
    """2e: the first hit's backward kernels (``csrc/first_hit.cu``): FHB
    (``ops.first_hit.first_hit_backward``) and CRB
    (``camera_rays_backward``) against their plain versions
    (``_first_hit_grad_check``) at ``FIRST_WIDTHS`` on phase 2c's six
    scenes, CR's rays and their depth-0 hit as in phase 2d (K1's planar
    slots on the textured sponza, (kind, idx) elsewhere); each kernel's
    device, wrapper and plain time (FHB in the route's form,
    ``ROUTE_PLANES``, into sums made once) against its bound
    (``wavefront_ab.fhb_work`` / ``crb_work``: the bytes of its own loads)
    and the copy floor of as many bytes; FH's time on the same hit beside
    it (the recompute's share); FHB also without its sums, with the
    arena's alone and with the frame tables' alone
    (``wavefront_ab.fhb_calls``), its resident grid
    (``first_hit_backward_grid``: two blocks a SM or more) and its shared
    memory a block (its row tables, and the staged tables); FHB's ptxas
    line without spills, and FH's, CR's and CRB's the same as before
    FHB's redesign, S1B's as its carry form gave it (``PTXAS_KEPT``).
    Returns the rows of the kernels line: CRB's and FHB's on the interior
    at 2,073,600 lanes (the denoised render's width, the route's)."""
    import re

    import torch
    from solstrale_tpu_torch import wavefront_ab
    from solstrale_tpu_torch.ops import first_hit
    from solstrale_tpu_torch.ops.step import (STAGE_MAX_BYTES, stage_floats,
                                              step_tables)
    from solstrale_tpu_torch.renderer import integrator

    start = time.perf_counter()
    dev = torch.device("cuda")
    out, rows, floors = {}, {}, {}
    for name in STEP_SCENES:
        cs = _wavefront_scene(name, sponza_cs)[0]
        per = {}
        for lanes, (w, h, form) in FIRST_WIDTHS.items():
            if form == "image":
                pix, sample = torch.arange(lanes, device=dev), 1
            else:
                pix, sample = integrator.queue_assignment(
                    torch.arange(lanes, device=dev), w, h,
                    torch.tensor(1, device=dev))
            o, d = first_hit.camera_rays(cs, pix, sample, 1, w, h)
            samp, bounce = integrator._depth0(pix, sample)
            hit = integrator.step_hit(cs, o, d, pix, samp, bounce, 1)
            checked, worst, g_ray = _first_hit_grad_check(
                name, cs, o, d, hit, pix, sample, w, h)
            shader, planes = _fhb_calls(cs, o, d, hit, pix, sample)[-1]
            if shader != integrator.SHADER_SIMPLE or \
                    any(planes[k] is None for k in ROUTE_PLANES):
                raise AssertionError("2e: the route's FHB call is not the "
                                     "last of _fhb_calls")
            texels = cs.textures.pixels
            sums = torch.zeros((texels.shape[0] + 1, 3), device=dev)
            g_sph = torch.zeros_like(cs.solids.sph_attr)
            g_pl = torch.zeros_like(cs.solids.pl_attr)

            def fhb(fn=first_hit.first_hit_backward):
                return fn(cs, *hit, o, d, pix, sample, 1, texels, planes,
                          shader, sums, g_sph=g_sph, g_pl=g_pl)

            def crb(fn=first_hit.camera_rays_backward):
                return fn(cs, pix, sample, 1, w, h, g_ray)

            fhb_bytes, fhb_ops = wavefront_ab.fhb_work(
                cs, o, d, hit, pix, sample, dict(albedo=True, normal=True),
                shader)
            crb_bytes, crb_ops = wavefront_ab.crb_work(cs, pix, sample)
            for nb in (fhb_bytes, crb_bytes):
                if nb not in floors:
                    floors[nb] = _copy_floor_ms(nb)
            fhb_row = dict(max_abs_err=worst, **kernel_times(
                fhb, lambda: fhb(first_hit.first_hit_backward_plain)),
                **bound(fhb_bytes, fhb_ops), copy_floor_ms=floors[fhb_bytes])
            crb_row = dict(max_abs_err=worst, **kernel_times(
                crb, lambda: crb(first_hit.camera_rays_backward_plain)),
                **bound(crb_bytes, crb_ops), copy_floor_ms=floors[crb_bytes])
            fh_ms = device_ms(lambda: first_hit.first_hit_shade(
                cs, *hit, o, d, pix, sample, 1, shader, True, True))
            # FHB without its sums, with the arena's alone, with the frame
            # tables' alone (wavefront_ab.fhb_calls, the same upstream)
            parts = wavefront_ab.fhb_calls(cs, o, d, hit, pix, sample, 1)
            if not all(torch.equal(parts["planes"][k], planes[k])
                       for k in ROUTE_PLANES):
                raise AssertionError("2e: fhb_calls' upstream is not the "
                                     "route's")
            decomposed = {f"{k}_ms": device_ms(parts[k])
                          for k in ("rays_only", "texels_only",
                                    "frames_only")}
            per[lanes] = dict(checked=checked,
                              hit_lanes=int(torch.isfinite(hit[0]).sum()),
                              FHB=fhb_row, FHB_parts=decomposed,
                              FHB_grid=first_hit.first_hit_backward_grid(
                                  lanes),
                              FHB_stage_bytes=4 * stage_floats(
                                  step_tables(cs)),
                              CRB=crb_row, FH_same_planes_ms=fh_ms)
            if name == "sponza" and lanes == 2073600:
                rows = {"CRB": crb_row, "FHB": fhb_row}
        out[name] = per
    torch.cuda.synchronize()
    build = wavefront_ab.build_log()
    fhb = _ptxas_of(build, "first_hit_backward")
    smem = re.search(r"(\d+) bytes smem", fhb[1])
    smem = int(smem.group(1)) if smem else 0
    grid = first_hit.first_hit_backward_grid(1 << 30)
    kept = {k: _ptxas_of(build, k) for k in PTXAS_KEPT}
    moved = {k: v for k, v in kept.items() if v != PTXAS_KEPT[k]}
    log("first_hit_grad", widths=list(FIRST_WIDTHS), ptxas_fhb=fhb,
        fhb_grid=dict(grid, threads=first_hit.BACK_THREADS,
                      slots=first_hit.BACK_SLOTS),
        fhb_static_smem_bytes=smem,
        fhb_smem_bytes_most=smem + STAGE_MAX_BYTES, ptxas_kept=kept,
        seconds=time.perf_counter() - start, **out)
    if not re.search(r"\b0 bytes spill stores, 0 bytes spill loads", fhb[0]):
        raise AssertionError(f"2e: FHB spills: {fhb}")
    if grid["per_sm"] < 2:
        raise AssertionError(f"2e: FHB keeps {grid} resident, not two "
                             f"blocks a SM")
    if moved:
        raise AssertionError(f"2e: ptxas lines moved from PTXAS_KEPT's: "
                             f"{moved}")
    return rows


def _route_leaves(cs):
    """(``cs`` with its arena, background, the camera's seven tensors,
    sph_attr and pl_attr each a new leaf that requires grad, the leaves by
    name)."""
    import dataclasses

    from solstrale_tpu_torch.ops import first_hit

    leaves = {k: getattr(cs.camera, k).detach().clone().requires_grad_(True)
              for k in first_hit.CAMERA_FIELDS}
    cam = dataclasses.replace(cs.camera, **leaves)
    leaves.update(
        arena=cs.textures.pixels.detach().clone().requires_grad_(True),
        bg=cs.bg_color.detach().clone().requires_grad_(True),
        sph_attr=cs.solids.sph_attr.detach().clone().requires_grad_(True),
        pl_attr=cs.solids.pl_attr.detach().clone().requires_grad_(True))
    out = dataclasses.replace(
        cs, camera=cam,
        textures=dataclasses.replace(cs.textures, pixels=leaves["arena"]),
        bg_color=leaves["bg"],
        solids=dataclasses.replace(cs.solids, sph_attr=leaves["sph_attr"],
                                   pl_attr=leaves["pl_attr"]))
    return out, leaves


def phase_first_hit_route(sponza_cs):
    """2e, the route at full width: ``torch.autograd.grad`` of a seeded
    weighted sum of ``render_pixels(..., width=1920, height=1080,
    shader_kind=SHADER_SIMPLE, need_aux=True)``'s three planes on the
    interior (K1) and the textured sponza (K1, image textures, a normal
    map), with the arena, the background, the camera's seven tensors,
    sph_attr and pl_attr requiring grad: launches CR 1, FH 1, CRB 1, FHB 1,
    draw 0, S1 0 (the counts set to 0 just before and read just after);
    against the same loss through ``camera_rays_plain`` and
    ``first_hit_plain`` on the card (autograd): the same planes bit for
    bit, every gradient within 1e-5 of the magnitudes summed into each
    entry (the plain backwards' ``magnitudes`` on the plain route's
    upstream gradients), and 1e-7; the route's forward and forward +
    backward ms (CUDA events, median of 3 after one warm-up). Returns the
    launches of the two routes."""
    import torch
    from solstrale_tpu_torch.ops import first_hit
    from solstrale_tpu_torch.renderer import integrator

    start = time.perf_counter()
    wrappers = all_wrappers()
    w, h = 1920, 1080
    pix = torch.arange(w * h, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    ws = [torch.randn((w * h, 3), generator=gen, device="cuda")
          for _ in range(3)]
    kw = dict(width=w, height=h, max_depth=50,
              shader_kind=integrator.SHADER_SIMPLE, need_aux=True)
    total = dict.fromkeys(wrappers, 0)
    out = {}
    for name in ("sponza", "sponza_textured"):
        cs = _wavefront_scene(name, sponza_cs)[0]
        c, leaves = _route_leaves(cs)

        def route():
            planes = integrator.render_pixels(c, pix, 1, 1, **kw)
            loss = sum((x * g).sum() for x, g in zip(planes, ws))
            return planes, torch.autograd.grad(loss, list(leaves.values()),
                                               allow_unused=True)

        reset_launches(wrappers)
        planes, grads = route()
        launches = launch_counts(wrappers)
        want = dict(CR=1, FH=1, CRB=1, FHB=1, draw=0, S1=0, K5=0)
        if any(launches[k] != n for k, n in want.items()) or \
                launches["K1"] <= 0:
            raise AssertionError(f"the first hit's route ({name}) launched "
                                 f"{launches}, expected {want} and K1")
        for k, n in launches.items():
            total[k] += n
        c2, leaves2 = _route_leaves(cs)
        o, d = integrator.camera_rays_plain(c2, pix, 1, 1, w, h)
        samp, bounce = integrator._depth0(pix, 1)
        hit = integrator.step_hit(c2, o, d, pix, samp, bounce, 1)
        ref = integrator.first_hit_plain(c2, o, d, *hit, pix, 1, 1,
                                         integrator.SHADER_SIMPLE, True,
                                         True)
        ref = (ref["color"], ref["albedo"], ref["normal"])
        if not all(_same(a, b) for a, b in zip(planes, ref)):
            raise AssertionError(f"the first hit's route ({name}): its "
                                 f"planes differ from the plain versions'")
        loss2 = sum((x * g).sum() for x, g in zip(ref, ws))
        want_g = torch.autograd.grad(loss2, list(leaves2.values()),
                                     allow_unused=True)
        # the magnitudes summed into each entry, from the plain backwards
        with torch.no_grad():
            od = [x.detach() for x in (*o, *d)]
            n = cs.textures.pixels.shape[0]
            m_sums = torch.zeros((n + 1, 3), device="cuda")
            m_sph = torch.zeros_like(cs.solids.sph_attr)
            m_pl = torch.zeros_like(cs.solids.pl_attr)
            g_planes = dict(color=ws[0], albedo=ws[1], normal=ws[2])
            g_ray = first_hit.first_hit_backward_plain(
                cs, *hit, tuple(od[:3]), tuple(od[3:]), pix, 1, 1,
                cs.textures.pixels, g_planes, integrator.SHADER_SIMPLE,
                m_sums, g_sph=m_sph, g_pl=m_pl, magnitudes=True)
            m_cam = first_hit.camera_rays_backward_plain(
                cs, pix, 1, 1, w, h, torch.stack(g_ray), magnitudes=True)
        mags = dict(zip(first_hit.CAMERA_FIELDS, m_cam),
                    arena=m_sums[:-1], bg=m_sums[-1], sph_attr=m_sph,
                    pl_attr=m_pl)
        errs = {}
        for k, a, b in zip(leaves, grads, want_g):
            a = torch.zeros_like(leaves[k]) if a is None else a
            b = torch.zeros_like(leaves[k]) if b is None else b
            _sums_close(f"the first hit's route ({name}) {k}", a, b,
                        mags[k])
            errs[k] = float((a - b).abs().max()) if a.numel() else 0.0
        nonzero = {k: bool((g != 0).any()) for k, g in zip(leaves, grads)
                   if g is not None}
        if not (nonzero["arena"] and nonzero["pl_attr"]):
            raise AssertionError(f"the first hit's route ({name}): zero "
                                 f"gradients {nonzero}")
        fwd = [_event_ms(lambda: integrator.render_pixels(c, pix, 1, 1,
                                                          **kw))
               for _ in range(4)][1:]
        both = [_event_ms(route) for _ in range(4)][1:]
        out[name] = dict(launches=launches, grad_max_abs_err=errs,
                         nonzero=nonzero, forward_ms=sorted(fwd)[1],
                         forward_ms_all=fwd,
                         forward_backward_ms=sorted(both)[1],
                         forward_backward_ms_all=both)
    log("first_hit_route", seconds=time.perf_counter() - start, **out)
    return total


def _graph_entries(cs):
    """The card driver's captures cached for the compiled scene ``cs``."""
    from solstrale_tpu_torch.renderer import integrator

    return {k[1] for k in integrator._PER_SCENE
            if k[0] == id(cs) and k[1][0] == "wavefront"}


def phase_graphs(sponza_cs):
    """3e: trace_queued's card driver (each pool's GRAPH_STEPS steps and
    stop test replayed as one CUDA graph: the hit kernels, S1 and S2 a
    step) against the eager loop (the plain step,
    ``_Wavefront.step_plain``), bit for bit (image and segments), on sponza
    1080p (its recorded segments), the textured sponza, production,
    many_lights, the mixed scene (K1-K3) and the normal-mapped kitchen (K4,
    400x266x8): one capture replayed at two sample_starts equal to the
    eager driver at each, a second seed its own capture, and a replayed
    batch's launches (K1-K4 and S1 once a step, S2 once a step and once for
    the reset, no draw kernel) equal to the steps it ran."""
    import torch
    from solstrale_tpu_torch.renderer import integrator

    start = time.perf_counter()
    wrappers = all_wrappers()
    per_step = {"sponza": ("K1",), "sponza_textured": ("K1",),
                "sponza_production": ("K1", "K2"),
                "many_lights": ("K1", "K2"), "mixed": ("K1", "K2", "K3"),
                "kitchen": ("K4",)}
    out = {}
    for name in per_step:
        cs, w, h, spp = _wavefront_scene(name, sponza_cs)
        kw = dict(width=w, height=h, max_depth=50)

        def run(drive, sample_start, seed=1):
            stats = {}
            reset_launches(wrappers)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            color, segs = drive(cs, sample_start, spp, seed, stats=stats,
                                **kw)
            segs = int(segs)
            return dict(color=color, segments=segs, stats=stats,
                        launches=launch_counts(wrappers),
                        seconds=time.perf_counter() - t0)

        def same(a, b, what):
            if a["segments"] != b["segments"] or not torch.equal(
                    a["color"], b["color"]):
                raise AssertionError(f"graphs ({name}, {what}): the card "
                                     "driver differs from the eager one")

        before = _graph_entries(cs)
        eager = run(integrator.trace_queued_eager, 1)
        first = run(integrator.trace_queued, 1)      # captures
        graph = run(integrator.trace_queued, 1)      # replays only
        same(eager, first, "sample 1, capture")
        same(eager, graph, "sample 1")
        keys = _graph_entries(cs) - before
        if len(keys) != 1:
            raise AssertionError(f"graphs ({name}): {len(keys)} captures")
        iters, reads = graph["stats"]["iters"], graph["stats"]["host_reads"]
        if graph["stats"]["replays"] != reads or \
                iters != reads * integrator.GRAPH_STEPS:
            raise AssertionError(f"graphs ({name}): stats {graph['stats']}")
        draws_a_step = (eager["launches"]["draw"] - 2) / eager["stats"][
            "iters"]
        want = {k: iters if k in per_step[name] else 0
                for k in ("K1", "K2", "K3", "K4", "K5")}
        want.update(draw=0, S1=iters, S2=iters + 1, S1B=0, CR=0, FH=0,
                    CRB=0, FHB=0)
        if graph["launches"] != want:
            raise AssertionError(f"graphs ({name}): launches "
                                 f"{graph['launches']}, want {want}")
        line = dict(segments=graph["segments"],
                    eager_seconds=eager["seconds"],
                    first_graph_seconds=first["seconds"],
                    graph_seconds=graph["seconds"],
                    eager_iterations=eager["stats"]["iters"],
                    eager_host_reads=eager["stats"]["host_reads"],
                    iterations=iters, host_reads=reads,
                    launches=graph["launches"], draws_a_step=draws_a_step)
        if name == "sponza":
            if graph["segments"] != SPONZA_SEGMENTS:
                raise AssertionError(f"sponza segments {graph['segments']}, "
                                     f"not {SPONZA_SEGMENTS}")
            same(run(integrator.trace_queued_eager, 2),
                 run(integrator.trace_queued, 2), "sample 2")
            if _graph_entries(cs) - before != keys:
                raise AssertionError("graphs: sample 2 captured anew")
            same(run(integrator.trace_queued_eager, 1, seed=2),
                 run(integrator.trace_queued, 1, seed=2), "seed 2")
            if len(_graph_entries(cs) - before) != 2:
                raise AssertionError("graphs: seed 2 took no capture of its "
                                     "own")
            line.update(sample_2_equal=True, seed_2_own_capture=True)
        out[name] = line
    log("graphs", graph_steps=integrator.GRAPH_STEPS, bit_equal=True,
        seconds=time.perf_counter() - start, **out)


def _check_k3(name, cs, o, d, counters):
    """K3 against its plain version on top of the solid hit of these rays
    (K4's plain solid sweep): t, kind and idx equal, parked rays keeping
    their input."""
    import torch
    from solstrale_tpu_torch.ops import sweep
    from solstrale_tpu_torch.renderer import integrator

    mt = integrator.media_tables(cs)
    solid = sweep.scene_hit_plain(cs.solids, sweep.pack_media(
        (), cs.device, 1.0), o, d, *counters)
    args = (mt, o, d, *solid, *counters)
    got, want = sweep.media_hit(*args), sweep.media_hit_plain(*args)
    torch.cuda.synchronize()
    for field, a, b in zip(("t", "kind", "idx"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {field} differs from the plain "
                                 "version")
    parked = (d[0] == 0) & (d[1] == 0) & (d[2] == 0)
    if not all(torch.equal(a[parked], b[parked]) for a, b in zip(got,
                                                                  solid)):
        raise AssertionError(f"{name}: a parked (zero-direction) ray changed")
    kind, idx = got[1], got[2]
    log("kernel", name=name, rays=o[0].numel(), live_rays=live_rays(d),
        media=mt.n_media, boundary_rows=[sum(x.shape[0] for x in
                                              mt.boundary(m))
                                          for m in range(mt.n_media)],
        medium_events=[int(((kind == 3) & (idx == m)).sum())
                       for m in range(mt.n_media)],
        max_abs_err=0.0, t_kind_idx_equal=True)


def _lane_counters(n_cam, parked, device):
    """trace_queued's counters of _subsampled_rays' lanes: the camera
    rays' pixels (int64), their bounces' (the same pixels), parked lanes
    pixel 0; sample 1 (int64); bounce 0, 1 and 0 (int32); seed 1."""
    import torch

    pix = torch.linspace(0, 1920 * 1080 - 1, n_cam, device=device).long()
    pixel = torch.cat([pix, pix, torch.zeros(parked, dtype=torch.int64,
                                             device=device)])
    bounce = torch.cat([torch.zeros(n_cam, dtype=torch.int32, device=device),
                        torch.ones(n_cam, dtype=torch.int32, device=device),
                        torch.zeros(parked, dtype=torch.int32,
                                    device=device)])
    return pixel, torch.ones_like(pixel), bounce, 1


def _check_k2(label, cs, o, d, parked, traces=None):
    """K2 fed K1's planar hit of these rays, against its plain version: t,
    kind and idx equal, no parked ray hit. Logs its device, wrapper and
    plain times, those of the whole ``bvh_closest_hit`` (K1, K2) and its
    bound; puts both calls into ``traces`` when given.
    K2's bound: the rays, t_p and pslot in, (t, kind, idx) out, the sphere
    table and the pl_idx and pl_is_tri entries of the distinct planar
    slots hit, read once; the sphere tests of the live rays. Returns K2's
    (t, kind, idx) and its row of the kernels line."""
    import torch
    from solstrale_tpu_torch.geo import INF, RAY_T_MIN
    from solstrale_tpu_torch.ops import bvh, sweep

    s = cs.solids
    n_live, r = live_rays(d), len(parked)
    t_p, pslot = bvh.bvh_planar_hit(cs.kbvh, o, d, RAY_T_MIN)
    args = (s.sph_table, o, d, RAY_T_MIN, INF, t_p, pslot, s.pl_idx,
            s.pl_is_tri)
    got = sweep.bvh_sphere_hit(*args)
    want = sweep.bvh_sphere_hit_plain(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("t", "kind", "idx"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"K2 ({label}): {name} differs from the "
                                 "plain version")
    if torch.isfinite(got[0][torch.from_numpy(parked).to(cs.device)]).any():
        raise AssertionError(f"K2 ({label}): a parked ray hit")
    tm = kernel_times(lambda: sweep.bvh_sphere_hit(*args),
                      lambda: sweep.bvh_sphere_hit_plain(*args))

    def closest():
        return bvh.bvh_closest_hit(cs.kbvh, s, o, d, RAY_T_MIN, INF)

    if traces is not None:
        traces["K2 bvh_sphere_hit"] = lambda a=args: sweep.bvh_sphere_hit(*a)
        traces["bvh_closest_hit"] = closest
    full = dict(device_ms=device_ms(closest), wrapper_ms=wrapper_ms(closest))
    n_sph = s.sph_table.shape[0]
    slots = int(torch.unique(pslot[pslot >= 0]).numel())
    row = dict(max_abs_err=0.0, **tm, **bound(
        r * (24 + 8 + 12) + slots * 5 + nbytes(s.sph_table),
        n_live * n_sph * FLOPS_SPHERE))
    log("kernel", name=f"K2 bvh_sphere_hit ({label})", rays=r,
        live_rays=n_live, spheres=n_sph, planar_slots_hit=slots,
        sphere_hits=int(((got[1] == 0) & torch.isfinite(got[0])).sum()),
        t_kind_idx_equal=True, **row,
        bvh_closest_hit=full)
    return got, row


def _many_light_k2():
    """K2 at the many-light workload's 63 sphere emitters (bench.py's
    ``many_lights``, 64 lights, 96 terrain cells): its tables and 131,072
    lanes of camera rays, their bounces and parked rays, exactly equal to
    its plain version."""
    import solstrale_tpu_torch as T
    from solstrale_tpu_torch import fixtures
    from solstrale_tpu_torch.scene.compile import compile_scene

    cs = compile_scene(fixtures.many_light_scene(
        T.RenderConfig(width=960, height=540, samples_per_pixel=1, seed=1),
        n_lights=64), device="cuda")
    if cs.solids.sph_table.shape[0] != 63:
        raise AssertionError("many-lights: expected 63 sphere emitters")
    o, d, parked = _subsampled_rays(cs, n=131072)
    _check_k2("many-lights, 63 spheres", cs, o, d, parked)


def _main_path_k2_k3(out, traces):
    """K2 and K3 at the main path's shape: the mixed BVH scene's tables at
    1080p and one wavefront iteration's 131,072 lanes (camera rays,
    bounces, parked rays) with trace_queued's counters, K2 fed K1's planar
    hit of the same rays and K3 K2's (t, kind, idx). Both equal their plain
    versions exactly (t, kind and idx). Also the wrapper-level calls the
    integrator makes, ``bvh_closest_hit`` (K1, K2) and
    the whole ``integrator.scene_hit`` (those and K3); all four calls go
    into ``traces`` for their device kernels. The kernels line's K2 and K3
    rows take these times and bounds. K2's bound: ``_check_k2``. K3's
    bound: the rays and (t, kind, idx) in, (t, kind, idx) out, the media
    tables, and the counters of the rays that reach a medium's box, read
    once; its operations from ``_media_flops``."""
    import torch
    import solstrale_tpu_torch as T
    from solstrale_tpu_torch import fixtures
    from solstrale_tpu_torch.ops import sweep
    from solstrale_tpu_torch.renderer import integrator
    from solstrale_tpu_torch.scene.compile import compile_scene

    dev = torch.device("cuda")
    cs = compile_scene(fixtures.mixed_bvh_scene(
        T.RenderConfig(width=1920, height=1080, samples_per_pixel=1, seed=1),
        n_cells=362), device=dev)
    o, d, parked = _subsampled_rays(cs, n=131072)
    n_live, r = live_rays(d), len(parked)
    counters = _lane_counters((r - 256) // 2, 256, dev)
    got, out["K2"] = _check_k2("mixed, main path", cs, o, d, parked, traces)

    # K3 gets K2's (t, kind, idx) of the same rays, as scene_hit gives it
    mt = integrator.media_tables(cs)
    margs = (mt, o, d, *got, *counters)
    m_k, m_p = sweep.media_hit(*margs), sweep.media_hit_plain(*margs)
    torch.cuda.synchronize()
    for name, a, b in zip(("t", "kind", "idx"), m_k, m_p):
        if not torch.equal(a, b):
            raise AssertionError(f"K3 (mixed): {name} differs from the plain "
                                 "version")
    tm = kernel_times(lambda: sweep.media_hit(*margs),
                      lambda: sweep.media_hit_plain(*margs))

    def scene_hit():
        return integrator.scene_hit(cs, o, d, *counters)

    if not all(torch.equal(a, b) for a, b in zip(scene_hit(), m_k)):
        raise AssertionError("K3 (mixed): integrator.scene_hit differs from "
                             "K1, K2 and K3 called one by one")
    traces["K3 media_hit"] = lambda a=margs: sweep.media_hit(*a)
    traces["BVH integrator.scene_hit"] = scene_hit
    full = dict(device_ms=device_ms(scene_hit),
                wrapper_ms=wrapper_ms(scene_hit))
    live = (d[0] != 0) | (d[1] != 0) | (d[2] != 0)
    flops, reach = _media_flops(mt, o, d, got[0], live, counters)
    # a warp whose lanes all miss the boxes skips the sweeps: the share of
    # warps (32 consecutive lanes) with a lane that reaches one
    warps = reach.view(-1, 32).any(1).double().mean().item()
    reach = int(reach.sum())
    counter_bytes = sum(c.element_size() for c in counters[:3])
    out["K3"] = dict(max_abs_err=0.0, **tm, **bound(
        r * (24 + 12 + 12) + reach * counter_bytes
        + nbytes(mt.sph, mt.pln, mt.sph_off_t, mt.pl_off_t, mt.nid, mt.box),
        flops))
    log("kernel", name="K3 media_hit (mixed, main path)", rays=r,
        live_rays=n_live, media=mt.n_media, rays_reaching_a_medium=reach,
        warps_reaching_a_medium=warps,
        medium_events=int((m_k[1] == 3).sum()), flops=flops,
        max_abs_err=0.0, t_kind_idx_equal=True, **tm,
        integrator_scene_hit=full)


def _planar_rows(pln, o, d, mask, lo, best):
    """One sweep of planar table ``pln`` by the rays in ``mask`` on [lo,
    ...) ((R,) f32) whose answer is ``best`` ((R,) f32): (rows it must
    divide, rows it must test in full), over all those rays. A row needs its
    division unless the sweep may skip it (lo > 0 and t not positive:
    hit::planar_ahead), and the rest of its test only where lo <= t <=
    best, the one window in which it can decide the answer; a row outside
    the window is rejected on its t alone."""
    from solstrale_tpu_torch.ops import sweep

    divided = tested = 0
    for a in range(0, o[0].numel(), sweep.RAY_CHUNK):
        sl = slice(a, a + sweep.RAY_CHUNK)
        _, t = sweep._planar_t(tuple(c[sl][:, None] for c in o),
                               tuple(c[sl][:, None] for c in d), pln)
        m = mask[sl][:, None]
        lo_c, best_c = lo[sl][:, None], best[sl][:, None]
        divided += int((m & ((t > 0) | (lo_c <= 0))).sum())
        tested += int((m & (t >= lo_c) & (t <= best_c)).sum())
    return divided, tested


def _planar_flops(pln, o, d, mask, lo, best):
    """f32 operations of that sweep's planar rows: every row's numerator
    and denominator, and the division and the rest of the test where
    ``_planar_rows`` says the sweep needs them."""
    divided, tested = _planar_rows(pln, o, d, mask, lo, best)
    return (int(mask.sum()) * pln.shape[0] * FLOPS_PLANAR_ND
            + divided * FLOPS_PLANAR_DIV + tested * FLOPS_PLANAR_REST)


def _medium_sweep_flops(msph, mpln, o, d, mask):
    """f32 operations of one medium's two boundary sweeps by the rays in
    ``mask``: every sphere test of both, and the planar rows as
    ``_planar_flops`` counts them: the entry sweep on (-inf, ...) up to its
    answer t1, the exit sweep on [t1 + 1e-4, ...) up to its answer t2."""
    import torch
    from solstrale_tpu_torch.geo import INF
    from solstrale_tpu_torch.ops import sweep

    t1s, t2s = [], []
    for a in range(0, o[0].numel(), sweep.RAY_CHUNK):
        sl = slice(a, a + sweep.RAY_CHUNK)
        oc = tuple(c[sl][:, None] for c in o)
        dc = tuple(c[sl][:, None] for c in d)
        dd, od, oo = sweep._ray_scalars(oc, dc)
        t1 = sweep._closest_t_plain(msph, mpln, oc, dc, dd, od, oo, -INF)
        t1s.append(t1)
        t2s.append(sweep._closest_t_plain(msph, mpln, oc, dc, dd, od, oo,
                                          (t1 + 1e-4)[:, None]))
    t1, t2 = torch.cat(t1s), torch.cat(t2s)
    return (int(mask.sum()) * 2 * msph.shape[0] * FLOPS_SPHERE
            + _planar_flops(mpln, o, d, mask, torch.full_like(t1, -INF), t1)
            + _planar_flops(mpln, o, d, mask, t1 + 1e-4, t2))


def _media_flops(mt, o, d, t, live, counters):
    """The media loop's f32 operations on these rays (K3's, and K4's after
    its solid sweep), from the work their data needs: per live ray the
    direction's reciprocals and per medium its box test; per ray that
    reaches medium m's box, against the best t after the media before it
    (the plain loop's), that medium's two boundary sweeps
    (``_medium_sweep_flops``) and the event. ``t`` is the solid hit.
    Returns (operations, the (R,) mask of rays that reach some medium's
    box)."""
    import torch
    from solstrale_tpu_torch.geo import INF
    from solstrale_tpu_torch.ops import rng, sweep

    n_live = int(live.sum())
    flops = n_live * (MEDIUM_INV + mt.n_media * MEDIUM_BOX) if mt.n_media \
        else 0
    reach_rays = torch.zeros_like(live)
    best = t
    for m in range(mt.n_media):
        msph, mpln = mt.boundary(m)
        ts = torch.where(torch.isfinite(best), best, INF)
        reach = live & sweep.box_reach_plain(o, d, mt.box[m], ts)
        reach_rays |= reach
        flops += (int(reach.sum()) * MEDIUM_EVENT
                  + _medium_sweep_flops(msph, mpln, o, d, reach))
        u = rng.uniform(*counters[:3], rng.P_MEDIUM_BASE + m, counters[3])
        t_m = sweep.medium_hit_plain(msph, mpln, mt.nid[m], o, d, best, u)
        best = torch.where(t_m < best, t_m, best)
    return flops, reach_rays


def _k4_flops(cs, o, d, t_solid, counters):
    """K4's f32 operations on these rays, from the work their data needs:
    per live ray each sphere's test (31) and the solid planar rows as
    ``_planar_flops`` counts them on [RAY_T_MIN, ...) up to the closest
    solid hit ``t_solid``; then the media loop (``_media_flops``). Returns
    (operations, rays that reach a medium's box, solid planar rows tested
    in full per live ray)."""
    import torch
    from solstrale_tpu_torch.geo import RAY_T_MIN
    from solstrale_tpu_torch.renderer import integrator

    s = cs.solids
    live = (d[0] != 0) | (d[1] != 0) | (d[2] != 0)
    n_live = int(live.sum())
    lo = torch.full_like(t_solid, RAY_T_MIN)
    divided, tested = _planar_rows(s.pl_table, o, d, live, lo, t_solid)
    media, reach = _media_flops(integrator.media_tables(cs), o, d, t_solid,
                                live, counters)
    reach = int(reach.sum())
    flops = (n_live * (s.sph_table.shape[0] * FLOPS_SPHERE
                       + s.pl_table.shape[0] * FLOPS_PLANAR_ND)
             + divided * FLOPS_PLANAR_DIV + tested * FLOPS_PLANAR_REST
             + media)
    return flops, reach, tested / max(n_live, 1)


def _check_k4(name, cs, o, d, counters, traces=None):
    """K4 against its plain version: t, kind and idx equal, parked rays
    missing; at the main path's shape (``traces`` given) also the times,
    the bound and the kernels-line row, and one ``integrator.scene_hit``
    call into ``traces`` for its device kernels. K4's bound: the rays in
    and (t, kind, idx) out, the counters of the rays that reach a medium's
    box (the only ones it reads), and the solid and media tables, read
    once; its operations from ``_k4_flops``."""
    import torch
    from solstrale_tpu_torch.ops import sweep
    from solstrale_tpu_torch.renderer import integrator

    s, mt = cs.solids, integrator.media_tables(cs)
    got = sweep.scene_hit(s, mt, o, d, *counters)
    want = sweep.scene_hit_plain(s, mt, o, d, *counters)
    torch.cuda.synchronize()
    for field, a, b in zip(("t", "kind", "idx"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {field} differs from the plain "
                                 "version")
    parked = (d[0] == 0) & (d[1] == 0) & (d[2] == 0)
    if torch.isfinite(got[0][parked]).any():
        raise AssertionError(f"{name}: a parked (zero-direction) ray hit")
    t, kind, _ = got
    info = dict(rays=o[0].numel(), live_rays=live_rays(d),
                spheres=s.sph_table.shape[0], planar=s.pl_table.shape[0],
                media=mt.n_media, medium_events=int((kind == 3).sum()),
                hits=int(torch.isfinite(t).sum()), max_abs_err=0.0,
                t_kind_idx_equal=True)
    if traces is None:
        log("kernel", name=name, **info)
        return None
    traces["K4 integrator.scene_hit"] = lambda: integrator.scene_hit(
        cs, o, d, *counters)
    tm = kernel_times(lambda: sweep.scene_hit(s, mt, o, d, *counters),
                      lambda: sweep.scene_hit_plain(s, mt, o, d, *counters))
    t_solid = sweep.closest_hit_plain(s.sph_table, s.pl_table, o, d,
                                      1e-3, float("inf"))[0]
    flops, reach, rows_tested = _k4_flops(cs, o, d, t_solid, counters)
    counter_bytes = sum(c.element_size() for c in counters[:3])
    b = bound(o[0].numel() * (24 + 12) + reach * counter_bytes
              + nbytes(s.sph_table, s.pl_table, s.pl_idx, mt.sph, mt.pln,
                       mt.sph_off_t, mt.pl_off_t, mt.nid, mt.box), flops)
    log("kernel", name=name, **info, rays_reaching_a_medium=reach,
        solid_rows_tested_per_live_ray=rows_tested, flops=flops, **tm, **b)
    return dict(max_abs_err=0.0, **tm, **b)


def _kitchen_rays(device, lanes=131072):
    """The K4 inputs of one wavefront iteration on the normal-mapped
    kitchen-sink scene at 1080p: camera rays of every 16th pixel, bounce
    rays from their hits, and their counters (pixel int64, sample int64 1,
    bounce int32 0 or 1, seed 1), as trace_queued gives them. Returns (cs,
    o, d, counters)."""
    import torch
    import solstrale_tpu_torch as T
    from solstrale_tpu_torch import fixtures
    from solstrale_tpu_torch.geo import soa
    from solstrale_tpu_torch.ops import rng
    from solstrale_tpu_torch.renderer import integrator
    from solstrale_tpu_torch.scene.compile import compile_scene

    cs = compile_scene(fixtures.kitchen_sink_scene(
        T.RenderConfig(width=1920, height=1080, samples_per_pixel=1,
                       seed=1)), device=device)
    half = lanes // 2
    pix = torch.linspace(0, 1920 * 1080 - 1, half, device=device).long()
    o, d = integrator.camera_rays_plain(cs, pix, 1, 1, 1920, 1080)
    sample = torch.ones_like(pix)
    zero = torch.zeros(half, dtype=torch.int32, device=device)
    t, kind, idx = integrator.scene_hit(cs, o, d, pix, sample, zero, 1)
    hit = torch.isfinite(t)
    attrs = integrator.full_hit_attributes(
        cs, o, d, torch.where(hit, t, 0.0), kind, idx, pix, 1, 0, 1)
    r1, r2, _, _ = rng.uniform4(pix, 1, 0, rng.P_COSINE, 1)
    frame = soa.onb_from_w3(attrs["normal"])
    bd = soa.onb_local3(*frame, rng.cosine_direction3(r1, r2))
    bd = tuple(torch.where(hit, c, 0.0) for c in bd)   # misses park
    bo = soa.where3(hit, attrs["point"], o)
    oo = tuple(torch.cat([a, b]) for a, b in zip(o, bo))
    dd = tuple(torch.cat([a, b]) for a, b in zip(d, bd))
    bounce = torch.cat([zero, torch.ones_like(zero)])
    return cs, oo, dd, (torch.cat([pix, pix]), torch.cat([sample, sample]),
                        bounce, 1)


def _final_image(scene, device):
    import solstrale_tpu_torch as T

    image = None
    for progress in T.ray_trace(scene, device=device):
        if progress.render_image is not None:
            image = progress.render_image
    return image


def phase_main_path():
    import torch
    import solstrale_tpu_torch as T
    from solstrale_tpu_torch import fixtures
    from solstrale_tpu_torch.ops import bvh
    from solstrale_tpu_torch.scene.compile import compile_scene

    w, h = 1920, 1080
    cfg = T.RenderConfig(width=w, height=h, samples_per_pixel=1, seed=1,
                         shader=T.PathTracingShader(50))
    scene = fixtures.sponza_class_scene(cfg)
    mixed = fixtures.mixed_bvh_scene(
        T.RenderConfig(width=w, height=h, samples_per_pixel=1, seed=1),
        n_cells=362)
    wrappers = all_wrappers()
    reset_launches(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    image = _final_image(scene, "cuda")
    t_sponza = time.perf_counter() - t0
    k1_sponza = bvh.bvh_planar_hit.launches
    t0 = time.perf_counter()
    image_mixed = _final_image(mixed, "cuda")
    t_mixed = time.perf_counter() - t0
    launches = launch_counts(wrappers)
    for name, img in (("sponza", image), ("mixed", image_mixed)):
        if img is None or img.shape != (h, w, 3):
            raise AssertionError(f"{name}: no final image of shape {(h, w)}")
        if not float(img.mean()) >= 2.0:
            raise AssertionError(f"{name}: black frame (mean u8 "
                                 f"{float(img.mean()):.3f})")
    if k1_sponza <= 0 or min(launches[k] for k in ("K1", "K2", "K3", "S1",
                                                    "S2")) <= 0:
        raise AssertionError(f"main path missed a kernel: {launches}")
    if launches["K4"] or launches["K5"] or launches["draw"]:
        raise AssertionError(f"the BVH path launched K4, K5 or the draw "
                             f"kernel: {launches}")

    # one render_sample_batch timed like bench.py (the loop is host-bound:
    # the three times show the spread)
    stats = {}
    timing = _batch_timing(compile_scene(scene, device="cuda"), w, h, 1,
                           stats=stats)
    if timing["segments"] != SPONZA_SEGMENTS:
        raise AssertionError(f"sponza segments {timing['segments']}, not "
                             f"{SPONZA_SEGMENTS}")
    log("main_path", ray_trace_seconds=t_sponza, mixed_ray_trace_seconds=t_mixed,
        mean_u8=float(image.mean()), mixed_mean_u8=float(image_mixed.mean()),
        launches=launches, k1_launches_sponza=k1_sponza, **timing,
        iterations=stats["iters"], iterations_wide=stats["iters_wide"],
        iterations_tail=stats["iters_tail"], lanes=stats["lanes"],
        host_reads=stats["host_reads"], replays=stats["replays"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches


def _batch_timing(cs, w, h, spp, stats=None):
    """render_sample_batch timed like bench.py (depth 50): warm up, then
    three batches to completion (a scalar checksum forces each); median
    seconds. ``stats`` receives the wavefront's iteration counts."""
    import torch
    from solstrale_tpu_torch.renderer import integrator

    kw = dict(width=w, height=h, max_depth=50,
              shader_kind=integrator.SHADER_PATH, need_aux=False,
              n_samples=spp)
    float(integrator.render_sample_batch(cs, 100, 1, **kw)[0].sum())
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        color, _, _, segs = integrator.render_sample_batch(
            cs, 1, 1, stats=stats, **kw)
        checksum = float(color.sum())
        times.append(time.perf_counter() - t0)
        if not checksum > 0:
            raise AssertionError(f"degenerate render: checksum={checksum}")
    segs = int(segs)
    if segs < w * h * spp:
        raise AssertionError(f"segments {segs} < pixels x spp")
    dt = sorted(times)[1]
    return dict(batch_seconds=dt, batch_seconds_all=times, segments=segs,
                segments_per_second=segs / dt)


def phase_small_scene():
    """The small-scene path at full size: one K5 launch a batch for the
    solid kitchen-sink scene and for the normal-mapped one."""
    import solstrale_tpu_torch as T
    from solstrale_tpu_torch import fixtures
    from solstrale_tpu_torch.renderer import megakernel
    from solstrale_tpu_torch.scene.compile import compile_scene

    w, h = 1920, 1080
    wrappers = all_wrappers()
    runs = {}
    for name, build, spp in (
            ("kitchen_solid", fixtures.kitchen_sink_solid_scene, 8),
            ("kitchen", fixtures.kitchen_sink_scene, 1)):
        scene = build(T.RenderConfig(width=w, height=h, samples_per_pixel=spp,
                                     samples_per_batch=spp, seed=1))
        reset_launches(wrappers)
        t0 = time.perf_counter()
        img = _final_image(scene, "cuda")
        seconds = time.perf_counter() - t0
        launches = launch_counts(wrappers)
        if img is None or img.shape != (h, w, 3):
            raise AssertionError(f"{name}: no final image of shape {(h, w)}")
        if not float(img.mean()) >= 2.0:
            raise AssertionError(f"{name}: black frame (mean u8 "
                                 f"{float(img.mean()):.3f})")
        cs = compile_scene(scene, device="cuda")
        gate = megakernel.megakernel_supported(cs, need_aux=False,
                                               shader_kind=0)
        runs[name] = dict(ray_trace_seconds=seconds,
                          mean_u8=float(img.mean()), launches=launches,
                          megakernel_gate=gate,
                          bench_400x266x8=_batch_timing(cs, 400, 266, 8))
    solid, kitchen = runs["kitchen_solid"]["launches"], runs["kitchen"][
        "launches"]
    for name, got in (("kitchen_solid", solid), ("kitchen", kitchen)):
        if got != dict(K1=0, K2=0, K3=0, K4=0, K5=1, draw=0, S1=0, S2=0,
                       S1B=0, CR=0, FH=0, CRB=0, FHB=0):
            raise AssertionError(f"{name}: expected one K5 launch and no "
                                 f"other kernel, got {got}")
        if not runs[name]["megakernel_gate"]:
            raise AssertionError(f"{name}: outside the megakernel gate")
    log("small_scene_path", **runs)
    return {k: kitchen[k] + solid[k] for k in ("K4", "K5", "draw", "S1",
                                               "S2")}


def _median_ms(fn, reps=3):
    """Median milliseconds of fn() over ``reps`` calls, CUDA events around
    each (after one warm-up call)."""
    return wrapper_ms(fn, reps=reps, warmup=1)


def _slices_equal(full, fn, n, width=131072):
    """fn(a, b) over [a, b) slices of ``width`` lanes, concatenated, equals
    ``full`` (a tuple of (n,) tensors) exactly."""
    import torch

    parts = [fn(a, min(a + width, n)) for a in range(0, n, width)]
    return len(parts), all(torch.equal(f, torch.cat(p)) for f, p in
                           zip(full, zip(*parts)))


def _check_image(name, img, h, w):
    if img is None or img.shape != (h, w, 3):
        raise AssertionError(f"{name}: no final image of shape {(h, w)}")
    if not float(img.mean()) >= 2.0:
        raise AssertionError(f"{name}: black frame (mean u8 "
                             f"{float(img.mean()):.3f})")


def _sample_replays(cs):
    """Replays of the sample pass's graphs on this compiled scene, over
    its keys."""
    from solstrale_tpu_torch.renderer import integrator

    return sum(v.replays for (sid, key), v in list(
        integrator._PER_SCENE.items()) if sid == id(cs) and
        isinstance(key, tuple) and key[0] == integrator.SAMPLE_PASS)


def _first_hit_drivers(cs):
    """The first-hit pass's card drivers on this compiled scene, by key."""
    from solstrale_tpu_torch.renderer import integrator

    return {key: v for (sid, key), v in list(integrator._PER_SCENE.items())
            if sid == id(cs) and isinstance(key, tuple) and
            key[0] == integrator.FIRST_HIT_PASS}


def _first_hit_replays(cs):
    """Replays of the first-hit pass's graphs on this compiled scene, over
    its keys."""
    return sum(v.replays for v in _first_hit_drivers(cs).values())


# the first-hit pass's forms phase 3d holds its graph to the eager driver
# in: (shader_kind name or None, aux) at each of FIRST_HIT_SAMPLES
FIRST_HIT_FORMS = (("albedo", False), ("albedo", True), ("normal", False),
                   ("normal", True), ("simple", False), ("simple", True),
                   (None, True))
FIRST_HIT_SAMPLES = (1, 8)


def _first_hit_pass_vs_eager(name, cs, w, h, wrappers, kernels):
    """The first-hit pass (seed 1, first sample 1; its graph captured by a
    first call at sample 9, timed, with its pool's bytes) in every form of
    ``FIRST_HIT_FORMS`` at each of ``FIRST_HIT_SAMPLES``, a debug shader's
    through ``render_sample_batch`` and the aux planes alone through
    ``first_hit_pass`` (the path batch around them reads the wavefront's
    stop test), each of which must take one replay with no host read,
    against ``first_hit_pass_eager``: every plane bit for bit, the same
    launches (CR, FH and each hit kernel of ``kernels`` once a sample, no
    draw, step or K5 kernel), and both timed (median ms, CUDA events).
    Each driver is dropped once checked. Returns (each form's line, the
    launches of the graphed batches)."""
    import torch
    from solstrale_tpu_torch.profiling import HostReads
    from solstrale_tpu_torch.renderer import integrator

    total = dict.fromkeys(wrappers, 0)
    cells = {}
    for shader, aux in FIRST_HIT_FORMS:
        kind = None if shader is None else getattr(
            integrator, f"SHADER_{shader.upper()}")
        for n in FIRST_HIT_SAMPLES:
            label = f"{shader or 'aux'}{'+aux' if shader and aux else ''}" \
                    f" x{n}"
            fh = dict(width=w, height=h, shader_kind=kind, aux=aux,
                      n_samples=n)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            integrator.first_hit_pass(cs, None, 9, 1, **fh)
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            key = (integrator.FIRST_HIT_PASS, w * h, w, h, 1, kind, aux, n)
            driver = _first_hit_drivers(cs)[key]
            pool = _pool_bytes(driver.graph[0])
            replays = driver.replays
            reset_launches(wrappers)
            with HostReads() as reads:
                if kind is None:
                    planes = integrator.first_hit_pass(cs, None, 1, 1, **fh)
                else:
                    batch = integrator.render_sample_batch(
                        cs, 1, 1, max_depth=50, shader_kind=kind,
                        need_aux=aux, **{k: fh[k] for k in (
                            "width", "height", "n_samples")})
                    planes = tuple(torch.flip(p, dims=(0,)).reshape(-1, 3)
                                   for p in batch[:3])
            torch.cuda.synchronize()
            graphed = launch_counts(wrappers)
            replayed = driver.replays - replays
            reset_launches(wrappers)
            eager = integrator.first_hit_pass_eager(cs, None, 1, 1, **fh)
            torch.cuda.synchronize()
            eager_launches = launch_counts(wrappers)
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(planes, eager))
            want = {k: n for k in ("CR", "FH") + kernels}
            if not same or replayed != 1 or reads.n != 0 or \
                    graphed != eager_launches or \
                    any(graphed[k] != v for k, v in want.items()) or \
                    any(graphed[k] for k in ("draw", "S1", "S2", "K5")):
                raise AssertionError(
                    f"{name} first-hit pass {label}: expected one replay, no "
                    f"host read, the eager driver's planes bit for bit and "
                    f"its launches ({want} a batch), got same={same}, "
                    f"replays={replayed}, host reads={reads.n}, {graphed} "
                    f"against {eager_launches}")
            if not all(bool(torch.isfinite(p).all()) for p in planes) or \
                    float(planes[1].abs().sum() > 0) != float(aux) or \
                    float(planes[0].abs().sum() > 0) != float(kind is not
                                                              None):
                raise AssertionError(f"{name} first-hit pass {label}: "
                                     f"non-finite or missing planes")
            for k, v in graphed.items():
                total[k] += v
            cells[label] = dict(
                capture_s=capture_s, pool_bytes=pool[0],
                pool_segments=pool[1], launches={
                    k: v for k, v in graphed.items() if v},
                replays=replayed, host_reads=reads.n, bit_identical=True,
                graphed_ms=_median_ms(lambda: integrator.first_hit_pass(
                    cs, None, 1, 1, **fh)),
                eager_ms=_median_ms(lambda: integrator.first_hit_pass_eager(
                    cs, None, 1, 1, **fh)))
            del integrator._PER_SCENE[id(cs), key]
            driver = None
    return cells, total


def _sample_pass_vs_eager(name, cs, w, h, need_aux, wrappers, kernels):
    """The path shader's sample pass (depth 50, seed 1, sample 1; its graph
    captured by a first call at sample 2, timed), grad mode on as a user
    calls it, three ways through ``render_pixels``: ``graphed`` (one replay
    of the fixed trip), ``fixed`` (the eager fixed trip, ``early_exit=
    False``) and ``early_exit`` (``sample_pass_eager``: one host read a
    bounce, the route before the graph). Each launches every kernel of
    ``kernels``, CR once, FH once with the aux planes, no draw kernel, and
    S1 once a bounce, the first hit kernel as often (plus FH's hit); the
    graphed and fixed ways 51 bounces with the same launches, the early
    exit its own count (logged); every plane of the three bit for bit the
    same. Then ``render_sample``: one replay and the same planes. Returns
    the launches and seconds of each."""
    import torch
    from solstrale_tpu_torch.renderer import integrator

    kw = dict(width=w, height=h, max_depth=50, need_aux=need_aux)
    path = integrator.SHADER_PATH
    pix = torch.arange(w * h, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    integrator.render_sample(cs, 2, 1, shader_kind=path, **kw)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    ways = {
        "graphed": lambda: integrator.render_pixels(
            cs, pix, 1, 1, shader_kind=path, **kw),
        "fixed": lambda: integrator.render_pixels(
            cs, pix, 1, 1, shader_kind=path, early_exit=False, **kw),
        "early_exit": lambda: integrator.sample_pass_eager(
            cs, pix, 1, 1, **kw)}
    aux = int(need_aux)
    planes, rp = {}, {}
    for way, fn in ways.items():
        reset_launches(wrappers)
        replays = _sample_replays(cs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        planes[way] = fn()
        torch.cuda.synchronize()
        got = launch_counts(wrappers)
        rp[way] = dict(seconds=time.perf_counter() - t0, launches=got,
                       bounces=got["S1"],
                       replays=_sample_replays(cs) - replays)
        if min(got[k] for k in kernels) <= 0 or got["S1"] > 51 or \
                got[kernels[0]] != got["S1"] + aux or \
                (got["CR"], got["FH"], got["draw"]) != (1, aux, 0) or \
                rp[way]["replays"] != int(way == "graphed") or \
                (way != "early_exit" and got["S1"] != 51):
            raise AssertionError(f"{name} {way}: expected {kernels}, one S1 "
                                 f"launch a bounce (51 on the fixed trip), "
                                 f"CR 1, FH {aux}, no draw kernel and "
                                 f"{int(way == 'graphed')} replays, got "
                                 f"{rp[way]}")
    if rp["graphed"]["launches"] != rp["fixed"]["launches"]:
        raise AssertionError(f"{name}: the graphed pass's launches are not "
                             f"the fixed trip's: {rp}")
    color = planes["graphed"][0]
    if not all(torch.equal(a, b) for way in ("fixed", "early_exit")
               for a, b in zip(planes["graphed"], planes[way])):
        raise AssertionError(f"{name}: the graphed pass, the fixed trip and "
                             f"the early exit differ")
    if not (bool(torch.isfinite(color).all()) and float(color.mean()) > 0):
        raise AssertionError(f"{name}: non-finite or black image")
    reset_launches(wrappers)
    replays = _sample_replays(cs)
    image = integrator.render_sample(cs, 1, 1, shader_kind=path, **kw)
    got = launch_counts(wrappers)
    if got != rp["graphed"]["launches"] or \
            _sample_replays(cs) - replays != 1 or not all(
                torch.equal(a, integrator.to_image(b, w, h))
                for a, b in zip(image, planes["graphed"])):
        raise AssertionError(f"{name} render_sample: expected one replay, "
                             f"render_pixels' launches and planes, got "
                             f"{got}")
    return dict(capture_s=capture_s, render_pixels=rp,
                render_sample=dict(launches=got, replays=1),
                early_exit_bounces=rp["early_exit"]["bounces"],
                bit_identical=True, mean=float(color.mean()))


def phase_surface(sponza_cs, smi):
    """3d: the renderer's surface beyond the path shader at full size."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import solstrale_tpu_torch as T
    from solstrale_tpu_torch import fixtures, post, wavefront_ab
    from solstrale_tpu_torch.geo import RAY_T_MIN
    from solstrale_tpu_torch.ops import bvh, sweep
    from solstrale_tpu_torch.renderer import integrator
    from solstrale_tpu_torch.scene.compile import compile_scene
    from solstrale_tpu_torch.utils import to_float

    w, h = 1920, 1080
    n_pix = w * h
    wrappers = all_wrappers()
    out = {}
    start = time.perf_counter()

    # ray_trace with bloom and the denoiser, a checkpoint every sample, and
    # a resume from sample 1's
    def sponza(**kw):
        return fixtures.sponza_class_scene(T.RenderConfig(
            width=w, height=h, samples_per_pixel=2, samples_per_batch=1,
            seed=1, post_processors=[post.BloomPostProcessor(0.02),
                                     post.DenoiserPostProcessor()], **kw))

    with tempfile.TemporaryDirectory() as tmp:
        ck, ck1 = os.path.join(tmp, "ck.npz"), os.path.join(tmp, "ck1.npz")
        # the aux planes' first-hit pass captures its graph on a key's
        # first call, after a warm-up pass whose launches count too: the
        # key is warmed first, at another sample
        renderer = T.Renderer(sponza(), device="cuda")
        integrator.render_sample_batch(
            renderer.compiled, 3, 1, width=w, height=h, max_depth=50,
            shader_kind=integrator.SHADER_PATH, need_aux=True, n_samples=1)
        replays = _first_hit_replays(renderer.compiled)
        reset_launches(wrappers)
        t0 = time.perf_counter()
        straight = None
        for n, p in enumerate(renderer.render(
                checkpoint_path=ck, checkpoint_every=1), 1):
            if n == 1:
                shutil.copy(ck, ck1)
            straight = p.render_image if p.render_image is not None \
                else straight
        seconds = time.perf_counter() - t0
        launches = launch_counts(wrappers)
        aux_replays = _first_hit_replays(renderer.compiled) - replays
        renderer = T.Renderer(sponza(), device="cuda")
        resumed = [p.render_image for p in renderer.render(resume_from=ck1)]
        if len(resumed) != 1 or renderer.samples_done != 2:
            raise AssertionError("resume: expected one batch from sample 1")
    _check_image("sponza with bloom and the denoiser", straight, h, w)
    if not np.array_equal(resumed[-1], straight):
        raise AssertionError("the render resumed from sample 1 is not "
                             "bit-identical to the straight one")
    # the aux planes: one CR and one FH launch a sample (the first-hit
    # pass, 2 batches of 1 sample: one replay each), their draws in
    # registers: no draw kernel
    if min(launches[k] for k in ("K1", "S1", "S2")) <= 0 or \
            launches["CR"] != 2 or launches["FH"] != 2 or \
            launches["K5"] != 0 or launches["draw"] != 0 or \
            aux_replays != 2:
        raise AssertionError(f"sponza with aux: expected K1, S1, S2, CR 2, "
                             f"FH 2, no K5 or draw kernel and 2 first-hit "
                             f"replays, got {launches}, {aux_replays}")
    aux_launches = launches
    out["sponza_bloom_denoiser"] = dict(
        ray_trace_seconds=seconds, mean_u8=float(straight.mean()),
        launches=launches, first_hit_replays=aux_replays,
        resume_bit_identical=True)

    # the debug shaders through ray_trace on the interior (K1) and the
    # kitchen (K4), then one sample of each timed
    kitchen_cs = compile_scene(fixtures.kitchen_sink_scene(T.RenderConfig(
        width=w, height=h, seed=1)), device="cuda")
    shaders = {"albedo": T.AlbedoShader, "normal": T.NormalShader,
               "simple": T.SimpleShader}
    debug_launches = dict(CR=0, FH=0, K4=0)
    for scene_name, build, cs, kernel in (
            ("sponza", fixtures.sponza_class_scene, sponza_cs, "K1"),
            ("kitchen", fixtures.kitchen_sink_scene, kitchen_cs, "K4")):
        runs = {}
        for shader_name, shader in shaders.items():
            kw = dict(width=w, height=h, max_depth=50,
                      shader_kind=shader.kind, need_aux=False, n_samples=1)
            renderer = T.Renderer(build(T.RenderConfig(
                width=w, height=h, samples_per_pixel=1, seed=1,
                shader=shader())), device="cuda")
            # the key's first call (warm-up and capture) at another sample
            integrator.render_sample_batch(renderer.compiled, 2, 1, **kw)
            replays = _first_hit_replays(renderer.compiled)
            reset_launches(wrappers)
            img = None
            for p in renderer.render():
                img = p.render_image if p.render_image is not None else img
            launches = launch_counts(wrappers)
            replays = _first_hit_replays(renderer.compiled) - replays
            _check_image(f"{scene_name} {shader_name}", img, h, w)
            # one sample: one replay of the first-hit pass, one CR and one
            # FH launch, no draw kernel
            if launches[kernel] <= 0 or launches["K5"] != 0 or \
                    launches["CR"] != 1 or launches["FH"] != 1 or \
                    launches["draw"] != 0 or replays != 1:
                raise AssertionError(f"{scene_name} {shader_name}: expected "
                                     f"{kernel}, CR 1, FH 1, no K5 or draw "
                                     f"kernel and one replay, got "
                                     f"{launches}, {replays}")
            for k in debug_launches:
                debug_launches[k] += launches[k]
            renderer = None
            runs[shader_name] = dict(
                mean_u8=float(img.mean()), launches=launches,
                replays=replays,
                one_sample_ms=_median_ms(
                    lambda: integrator.render_sample_batch(cs, 1, 1, **kw)),
                one_sample_eager_ms=_median_ms(
                    lambda: integrator.first_hit_pass_eager(
                        cs, None, 1, 1, width=w, height=h,
                        shader_kind=shader.kind, aux=False, n_samples=1)))
        pix = torch.arange(n_pix, device="cuda")
        _, o, d = integrator.camera_rays(cs, pix, w, h, 1, 1)
        runs["first_hit_aux_ms"] = _median_ms(
            lambda: integrator.first_hit_aux(cs, o, d, pix, 1, 1))
        # the hit kernels alone on the 2,073,600 camera rays (the hit
        # first_hit_aux takes: step_hit)
        samp, bounce = integrator._depth0(pix, 1)

        def hit0():
            return integrator.step_hit(cs, o, d, pix, samp, bounce, 1)

        runs["camera_hit_ms"] = _median_ms(hit0)
        runs["camera_hit_device_ms"] = device_ms(hit0)
        runs["camera_rays_ms"] = _median_ms(
            lambda: integrator.camera_rays(cs, pix, w, h, 1, 1))
        out[f"{scene_name}_debug_shaders"] = runs

    # the aux-on batch against the aux-off one (the interior, 1 spp), in
    # turns: off, on, on, off (the host-bound batches spread widely)
    kw = dict(width=w, height=h, max_depth=50,
              shader_kind=integrator.SHADER_PATH, n_samples=1)
    turns = {False: [], True: []}
    for aux in (False, True, True, False):
        turns[aux].append(_median_ms(lambda a=aux: float(
            integrator.render_sample_batch(sponza_cs, 1, 1, need_aux=a,
                                           **kw)[0].sum())))
    out["sponza_batch_ms"] = {f"need_aux={a}": v for a, v in turns.items()}

    # the sample pass at 1080p, depth 50: one replay of the fixed trip's
    # graph, bit for bit the eager fixed trip and the eager early exit, on
    # the mixed scene (K1-K3), the normal-mapped kitchen (K4) with the aux
    # planes and the textured sponza (K1); then the mixed and the kitchen
    # pass timed, graphed against the eager ways
    mixed = compile_scene(fixtures.mixed_bvh_scene(T.RenderConfig(
        width=w, height=h, seed=1), n_cells=362), device="cuda")
    sponza_tex = compile_scene(fixtures.sponza_textured_scene(
        T.RenderConfig(width=w, height=h, seed=1)), device="cuda")
    for name, cs, aux, kernels in (
            ("mixed", mixed, False, ("K1", "K2", "K3")),
            ("kitchen", kitchen_cs, True, ("K4",)),
            ("sponza_textured", sponza_tex, False, ("K1",))):
        res = _sample_pass_vs_eager(name, cs, w, h, aux, wrappers, kernels)
        if name == "mixed":
            out["mixed_render_pixels"] = dict(
                **res["render_pixels"], capture_s=res["capture_s"],
                bit_identical=True, mean=res["mean"])
            out["mixed_render_sample"] = dict(**res["render_sample"],
                                              bit_identical=True)
        else:
            out[f"{name}_render_sample"] = res
    sponza_tex = None
    for name, cs in (("mixed", mixed), ("kitchen", kitchen_cs)):
        log("sample_pass", gpu=smi, scene=f"{name} 1920x1080, depth 50",
            **wavefront_ab.sample_pass_times(cs, w, h))

    # the first-hit pass at 1080p: one replay of its graph a batch, no host
    # read, bit for bit the eager driver, for every debug shader with and
    # without the aux planes and the aux planes alone, at 1 and 8 samples,
    # on the interior (K1), the mixed scene (K1-K3) and the kitchen (K4)
    first_hit_launches = dict.fromkeys(wrappers, 0)
    for name, cs, kernels in (("interior", sponza_cs, ("K1",)),
                              ("mixed", mixed, ("K1", "K2", "K3")),
                              ("kitchen", kitchen_cs, ("K4",))):
        cells, total = _first_hit_pass_vs_eager(name, cs, w, h, wrappers,
                                                kernels)
        log("first_hit_pass", gpu=smi, scene=f"{name} 1920x1080", **cells)
        for k, n in total.items():
            first_hit_launches[k] += n

    # K1 and K4 over all 2,073,600 camera rays of a 1080p image in one
    # launch, against 131,072-lane slices (their plain versions are checked
    # at 131,072 lanes in phase 2)
    o, d = integrator.camera_rays_plain(sponza_cs, pix, 1, 1, w, h)
    kb = sponza_cs.kbvh
    full = bvh.bvh_planar_hit(kb, o, d, RAY_T_MIN)
    n_k1, k1_equal = _slices_equal(full, lambda a, b: bvh.bvh_planar_hit(
        kb, tuple(c[a:b] for c in o), tuple(c[a:b] for c in d), RAY_T_MIN),
        n_pix)
    o, d = integrator.camera_rays_plain(kitchen_cs, pix, 1, 1, w, h)
    counters = (pix, torch.ones_like(pix),
                torch.zeros(n_pix, dtype=torch.int32, device="cuda"))
    mt = integrator.media_tables(kitchen_cs)
    full4 = sweep.scene_hit(kitchen_cs.solids, mt, o, d, *counters, 1)
    n_k4, k4_equal = _slices_equal(full4, lambda a, b: sweep.scene_hit(
        kitchen_cs.solids, mt, tuple(c[a:b] for c in o),
        tuple(c[a:b] for c in d), *(c[a:b] for c in counters), 1), n_pix)
    torch.cuda.synchronize()
    if not (k1_equal and k4_equal):
        raise AssertionError(f"one launch of {n_pix} lanes differs from "
                             f"131,072-lane slices: K1 {k1_equal}, K4 "
                             f"{k4_equal}")
    out["one_launch_of_2073600"] = dict(
        k1_equal_to_slices=n_k1, k4_equal_to_slices=n_k4,
        k1_hits=int(torch.isfinite(full[0]).sum()),
        k4_hits=int(torch.isfinite(full4[0]).sum()))

    # the denoiser and bloom at 1080p, on the interior's aux planes
    color, albedo, normal = integrator.render_sample_batch(
        sponza_cs, 1, 1, width=w, height=h, max_depth=50,
        shader_kind=integrator.SHADER_PATH, need_aux=True, n_samples=1)[:3]
    proc = post.DenoiserPostProcessor()
    tone = (to_float(color, 1), to_float(albedo, 1), normal)
    out["denoiser_cnn_1080p_ms"] = _median_ms(lambda: proc.denoise(*tone))
    out["bloom_1080p_ms"] = {
        str(f): _median_ms(lambda f=f: post.BloomPostProcessor(f)
                           .intermediate_post_process(color, albedo, normal,
                                                      w, h, 1))
        for f in (0.02, 0.5)}

    # the CNN on the card against the CPU at 256x256
    g = torch.Generator().manual_seed(11)
    sums = [torch.rand((256, 256, 3), generator=g) * 3 for _ in range(2)]
    sums.append(torch.randn((256, 256, 3), generator=g))
    tone = (to_float(sums[0], 2), to_float(sums[1], 2), sums[2] / 2)
    cpu = proc.denoise(*tone)
    card = proc.denoise(*(x.cuda() for x in tone)).cpu()
    err = float((card - cpu).abs().max())
    u8_cpu = proc.post_process(*sums, 256, 256, 2)
    u8_card = proc.post_process(*(x.cuda() for x in sums), 256, 256, 2)
    diff = np.abs(u8_card.astype(np.int16) - u8_cpu.astype(np.int16))
    same = float((diff == 0).all(axis=-1).mean())
    if err > 1e-4 or diff.max() > 1 or same < 0.999:
        raise AssertionError(f"CNN card vs CPU: max abs {err}, u8 equal on "
                             f"{same}, max u8 diff {diff.max()}")
    out["cnn_card_vs_cpu_256"] = dict(max_abs_err=err,
                                      u8_pixels_equal=same,
                                      u8_max_diff=int(diff.max()))
    log("surface", **out, seconds=time.perf_counter() - start)
    # the first hit's kernels and the draw kernel on ray_trace with the
    # denoiser's aux planes (the first-hit pass; the draw kernel 0), the
    # debug shaders and the first-hit pass's batches; K4 on the kitchen's
    # debug shaders and first-hit passes (its depth-0 hit)
    return {"draw": aux_launches["draw"],
            "K4": debug_launches["K4"] + first_hit_launches["K4"],
            "CR": aux_launches["CR"] + debug_launches["CR"]
            + first_hit_launches["CR"],
            "FH": aux_launches["FH"] + debug_launches["FH"]
            + first_hit_launches["FH"]}


def k5_work(stats, segments):
    """K5's work counts from one launch's ``stats``: the active-lane
    efficiency (segments over 32 lanes x warp iterations), the same
    efficiency of the static one-pixel-per-thread map (warps of 32
    consecutive pixels, each running as long as its longest pixel: mean over
    max of the per-pixel segments), the shares of segments and of warp
    iterations that swept a medium, and the persistent grid."""
    import torch

    ps = stats["pixel_segments"].to(torch.int64)
    ps = torch.nn.functional.pad(ps, (0, -ps.numel() % 32)).view(-1, 32)
    return dict(
        active_lane_efficiency=segments / (32 * stats["warp_iterations"]),
        static_map_efficiency=int(ps.sum()) / (32 * int(ps.amax(1).sum())),
        warp_iterations=stats["warp_iterations"],
        medium_sweeps=stats["medium_sweeps"],
        medium_sweep_share=stats["medium_sweeps"] / segments,
        warp_medium_sweep_share=(stats["warp_medium_sweeps"]
                                 / stats["warp_iterations"]),
        blocks=stats["blocks"], blocks_per_sm=stats["blocks_per_sm"])


# K5's many-light case: lights above the light-pdf mean's unroll of 16,
# within the megakernel's gate (MAX_LIGHTS)
K5_MANY_LIGHTS = 24


def phase_megakernel():
    """K5 against its plain version, exactly (values and segments), and a
    repeated launch bit for bit: at the main path's shape (the solid
    kitchen-sink scene at 1920x1080, 8 spp, depth 50: the kernels line's
    row, its bound from the kinds of segment the plain version counted and
    the medium sweeps the kernel counted), and on the kitchen-sink scene
    without its normal map (an image texture, triangle prims, a triangle
    light) at bench.py's 400x266x8, which is also timed at 1920x1080x8, on
    a 24-light scene (above the light-pdf mean's unroll of 16) at
    160x120x8, and on the normal-mapped kitchen (K5's normal-map
    instantiation) at 400x266x8 and 1920x1080x8, timed at the latter with
    its bound; the work counts of each (``k5_work``); then K5 against
    trace_queued (the K4 route) at 1920x1080, 1 spp, on the solid kitchen
    and the normal-mapped one; and the normal-mapped kitchen's aux batch
    at 400x266x8 against its eager form (``_aux_batch_vs_eager``)."""
    import numpy as np
    import torch
    import solstrale_tpu_torch as T
    from solstrale_tpu_torch import fixtures
    from solstrale_tpu_torch.renderer import integrator, megakernel
    from solstrale_tpu_torch.scene.compile import compile_scene

    def compare(name, got, seg, want, seg_w, tol):
        got, want = got.cpu().numpy(), want.cpu().numpy()
        if int(seg) != int(seg_w):
            raise AssertionError(f"{name}: segments {int(seg)} vs "
                                 f"{int(seg_w)}")
        if not np.allclose(got, want, rtol=tol, atol=tol):
            raise AssertionError(f"{name}: values differ beyond {tol}")
        return float(np.abs(got - want).max())

    def check(name, cs, kw, spp, events=None):
        """K5 twice and its plain version once (timed with CUDA events),
        all three equal. Returns (max abs error, segments, plain ms, the
        first launch's work counts)."""
        stats = {}
        a, seg_a = megakernel.render_batch_megakernel(cs, 1, spp, 1,
                                                      stats=stats, **kw)
        b, seg_b = megakernel.render_batch_megakernel(cs, 1, spp, 1, **kw)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        p, seg_p = megakernel.render_batch_megakernel_plain(
            cs, 1, spp, 1, events=events, **kw)
        end.record()
        torch.cuda.synchronize()
        if not (torch.equal(a, b) and int(seg_a) == int(seg_b)):
            raise AssertionError(f"{name}: a repeated launch is not "
                                 "bit-identical")
        err = compare(name, a, seg_a, p, seg_p, 0.0)
        return err, int(seg_a), start.elapsed_time(end), k5_work(
            stats, int(seg_a))

    def compiled(build, w, h):
        return compile_scene(build(T.RenderConfig(width=w, height=h,
                                                  seed=1)), device="cuda")

    w, h, spp = 1920, 1080, 8
    kw = dict(width=w, height=h, max_depth=50)
    cs = compiled(fixtures.kitchen_sink_solid_scene, w, h)
    ev = {}
    err, segs, plain_ms, work = check("K5 vs plain (kitchen_solid)", cs, kw,
                                      spp, events=ev)
    if segs != KITCHEN_SOLID_SEGMENTS:
        raise AssertionError(f"kitchen_solid: segments {segs}, not "
                             f"{KITCHEN_SOLID_SEGMENTS}")
    if ev["miss"] + ev["capped"] + ev["emit"] != w * h * spp or \
            sum(ev.values()) != segs:
        raise AssertionError(f"K5: the segment kinds {ev} do not add up to "
                             f"{w * h * spp} paths and {segs} segments")
    def launch():
        return megakernel.render_batch_megakernel(cs, 1, spp, 1, **kw)

    tm = dict(ms=device_ms(launch, n=5), wrapper_ms=wrapper_ms(launch))
    t = megakernel.scene_tables(cs)
    flops = k5_flops(t, cs.light_kinds, w * h * spp, segs, ev,
                     work["medium_sweeps"])
    out = dict(max_abs_err=err, **tm, plain_ms=plain_ms, **bound(
        w * h * 16 + nbytes(t.cam, t.sph, t.pln, t.lights, t.mats,
                            t.tex_attr, t.texels, t.media.sph, t.media.pln,
                            t.med, t.media.box), flops))

    build_tex = lambda c: fixtures.kitchen_sink_scene(  # noqa: E731
        c, normal_map=False)
    tex = compiled(build_tex, 400, 266)
    if not megakernel.megakernel_supported(tex, need_aux=False,
                                           shader_kind=0):
        raise AssertionError("kitchen_textured: outside the megakernel gate")
    err_tex, segs_tex, _, work_tex = check(
        "K5 vs plain (kitchen_textured)", tex,
        dict(width=400, height=266, max_depth=50), 8)
    # 24 lights: above the 16 the unrolled light-pdf mean takes, the
    # batched form's rule
    many = compiled(lambda c: fixtures.many_light_scene(
        c, n_lights=K5_MANY_LIGHTS, n_cells=4), 160, 120)
    if not megakernel.megakernel_supported(many, need_aux=False,
                                           shader_kind=0) or \
            len(many.light_kinds) != K5_MANY_LIGHTS:
        raise AssertionError("many_lights_24: outside the megakernel gate")
    err_many, segs_many, _, work_many = check(
        "K5 vs plain (many_lights_24)", many,
        dict(width=160, height=120, max_depth=50), 8)
    # the normal-mapped kitchen: K5's normal-map instantiation, at
    # 400x266x8 and at 1920x1080x8 (timed there, with its bound)
    kw_small = dict(width=400, height=266, max_depth=50)
    mapped = compiled(fixtures.kitchen_sink_scene, 400, 266)
    if "normal_maps" not in mapped.features or \
            not megakernel.megakernel_supported(mapped, need_aux=True,
                                                shader_kind=0):
        raise AssertionError("kitchen: not a normal-mapped scene inside the "
                             "megakernel gate")
    ev_map = {}
    err_map, segs_map, _, work_map = check(
        "K5 vs plain (kitchen, normal-mapped)", mapped, kw_small, 8,
        events=ev_map)
    if not ev_map["mapped"] > 0:
        raise AssertionError("kitchen: no scatter off the normal map")
    aux = _aux_batch_vs_eager(mapped, kw_small, 8)
    mapped_hd = compiled(fixtures.kitchen_sink_scene, w, h)
    ev_hd = {}
    err_map_hd, segs_map_hd, plain_map_ms, work_map_hd = check(
        "K5 vs plain (kitchen, normal-mapped, 1080p)", mapped_hd, kw, spp,
        events=ev_hd)
    t_map = megakernel.scene_tables(mapped_hd)
    flops_map = k5_flops(t_map, mapped_hd.light_kinds, w * h * spp,
                         segs_map_hd, ev_hd, work_map_hd["medium_sweeps"])
    map_hd_run = dict(
        ms=device_ms(lambda: megakernel.render_batch_megakernel(
            mapped_hd, 1, spp, 1, **kw), n=5),
        plain_ms=plain_map_ms, max_abs_err=err_map_hd, segments=segs_map_hd,
        segment_kinds=ev_hd, flops=flops_map,
        flops_per_segment=flops_map / segs_map_hd, **bound(
            w * h * 16 + nbytes(t_map.cam, t_map.sph, t_map.pln, t_map.frame,
                                t_map.lights, t_map.mats, t_map.tex_attr,
                                t_map.texels, t_map.media.sph,
                                t_map.media.pln, t_map.med, t_map.media.box),
            flops_map), **work_map_hd)
    out["max_abs_err"] = max(err, err_tex, err_many, err_map, err_map_hd)
    # the textured kitchen at 1920x1080x8: time and work only (its plain
    # version would take minutes)
    tex_hd = compiled(build_tex, w, h)
    stats = {}
    _, seg_hd = megakernel.render_batch_megakernel(tex_hd, 1, spp, 1,
                                                   stats=stats, **kw)
    tex_hd_run = dict(ms=device_ms(lambda: megakernel.render_batch_megakernel(
        tex_hd, 1, spp, 1, **kw), n=5), segments=int(seg_hd),
        **k5_work(stats, int(seg_hd)))

    k5, seg_k5 = megakernel.render_batch_megakernel(cs, 1, 1, 1, **kw)
    q, seg_q = integrator.trace_queued(cs, 1, 1, 1, **kw)
    err_q = compare("K5 vs trace_queued", k5, seg_k5, q, seg_q, TOL_K5)
    k5, seg_k5_map = megakernel.render_batch_megakernel(mapped_hd, 1, 1, 1,
                                                        **kw)
    q, seg_q = integrator.trace_queued(mapped_hd, 1, 1, 1, **kw)
    err_q_map = compare("K5 vs trace_queued (kitchen, normal-mapped)", k5,
                        seg_k5_map, q, seg_q, TOL_K5)
    log("megakernel", scene="kitchen_solid", shape="1920x1080x8 depth 50",
        segments=segs, segment_kinds=ev, **tm, plain_ms=plain_ms,
        max_abs_err=err, bit_identical_repeat=True, flops=flops,
        flops_per_segment=flops / segs, bound_ms=out["bound_ms"], **work,
        textured_400x266x8=dict(segments=segs_tex, max_abs_err=err_tex,
                                lights=list(tex.light_kinds), **work_tex),
        textured_1920x1080x8=tex_hd_run,
        many_lights_24_160x120x8=dict(segments=segs_many,
                                      max_abs_err=err_many, **work_many),
        segments_1080p_1spp=int(seg_k5),
        max_abs_err_vs_trace_queued_1080p=err_q,
        normal_mapped_400x266x8=dict(segments=segs_map,
                                     max_abs_err=err_map,
                                     segment_kinds=ev_map, **work_map),
        normal_mapped_1920x1080x8=map_hd_run,
        normal_mapped_segments_1080p_1spp=int(seg_k5_map),
        normal_mapped_max_abs_err_vs_trace_queued_1080p=err_q_map,
        normal_mapped_aux_400x266x8=aux)
    return out


def _aux_batch_vs_eager(cs, kw, spp):
    """``render_sample_batch`` of the path shader with the aux planes on a
    K5 scene (its first call, at another sample, captures the first-hit
    pass's graph): one K5 launch for the color, one replay of the first-hit
    pass (CR and FH once a sample) for the albedo and normal, no step or
    draw kernel, and every plane bit for bit its eager form's (K5's plain
    version, ``first_hit_pass_eager``). Returns the batch's wall ms and
    launches."""
    import torch
    from solstrale_tpu_torch.renderer import integrator, megakernel

    w, h = kw["width"], kw["height"]
    batch_kw = dict(kw, shader_kind=integrator.SHADER_PATH, need_aux=True,
                    n_samples=spp)
    integrator.render_sample_batch(cs, 9, 1, **batch_kw)
    wrappers = all_wrappers()
    replays = _first_hit_replays(cs)
    reset_launches(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = integrator.render_sample_batch(cs, 1, 1, **batch_kw)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts(wrappers)
    replays = _first_hit_replays(cs) - replays
    color, _ = megakernel.render_batch_megakernel_plain(cs, 1, spp, 1, **kw)
    _, albedo, normal = integrator.first_hit_pass_eager(
        cs, None, 1, 1, width=w, height=h, shader_kind=None, aux=True,
        n_samples=spp)
    want = [integrator.to_image(x, w, h) for x in (color, albedo, normal)]
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got[:3], want))
    expect = dict(launches, K5=1, CR=spp, FH=spp, K4=spp)
    if not same or replays != 1 or launches != expect or \
            any(launches[k] for k in ("K1", "K2", "K3", "S1", "S2", "draw")):
        raise AssertionError(f"aux batch: expected its eager form's planes "
                             f"bit for bit, one K5 launch and one first-hit "
                             f"replay ({spp} CR and FH), got same={same}, "
                             f"replays={replays}, {launches}")
    if not all(float(p.abs().sum()) > 0 for p in got[:3]):
        raise AssertionError("aux batch: a zero plane")
    return dict(wall_ms=wall_ms, launches=launches, first_hit_replays=replays,
                bit_identical=True)


# what one replayed bounce computes, in the order the bounce decides it
REPLAY_ORDER = ("draws", "o", "d", "t", "kind", "idx", "point", "uv",
                "texel", "normal", "cos_dir", "light_dir", "light_pdf",
                "new_dir", "prob", "throughput", "color", "terminal")
DISCRETE = ("draws", "kind", "idx", "texel", "terminal")
MAX_OUTLIERS = 8          # pixels traced per scene


def _replay_start(cs, pix, sample, seed, w, h):
    """The lane state ``integrator.trace`` starts from: camera rays."""
    import torch
    from solstrale_tpu_torch.renderer import integrator

    _, o, d = integrator.camera_rays(cs, pix, w, h, sample, seed)
    zero = torch.zeros_like(o[0])
    return (o, d, torch.zeros(pix.shape, dtype=torch.int32,
                              device=zero.device),
            zero, integrator.fold_init(zero),
            torch.ones(pix.shape, dtype=torch.bool, device=zero.device))


def _replay_bounce(cs, state, pix, sample, seed, max_depth):
    """One bounce of every lane as ``integrator.trace`` runs it (its
    ``path_step``), with what the bounce computes on the way: the draws of
    every purpose, (t, kind, idx), the hit point and uv, the albedo and
    normal-map texels it reads, the shading normal, the cosine and light
    directions it samples, the light pdf of the direction it takes, that
    direction and its weight, and after the bounce the throughput (the
    clamp-fold's state), the color of the ended paths and which ended.
    Returns (quantities as (R, k) tensors, the next state)."""
    import torch
    from solstrale_tpu_torch.ops import intersect, rng
    from solstrale_tpu_torch.renderer import integrator

    o, d, bounce, acc_len, fold, alive = state
    sample = integrator._lanes(sample, pix)
    purposes = list(range(rng.P_PHASE + 1)) + [
        rng.P_MEDIUM_BASE + m for m in range(len(cs.media))]
    q = {"draws": torch.stack([u for p in purposes for u in rng.uniform4(
        pix, sample, bounce, p, seed)], -1),
        "o": torch.stack(o, -1), "d": torch.stack(d, -1)}
    t, kind, idx = integrator.scene_hit(cs, o, d, pix, sample, bounce, seed)
    attrs = integrator.full_hit_attributes(
        cs, o, d, torch.where(torch.isfinite(t), t, 0.0), kind, idx, pix,
        sample, bounce, seed)
    sc = integrator.scatter(cs, o, d, attrs, pix, sample, bounce, seed)
    mats = [integrator.resolve_blend(cs.materials, attrs["mat"], rng.uniform4(
        pix, sample, bounce, p, seed), cs.features)
        for p in (rng.P_BLEND_SCATTER, rng.P_BLEND_NORMAL)]
    r1, r2, _, _ = rng.uniform4(pix, sample, bounce, rng.P_COSINE, seed)
    n_l = cs.lights.kind.shape[0]
    pick = torch.clamp((rng.uniform(pix, sample, bounce, rng.P_LIGHT_PICK,
                                    seed) * n_l).to(torch.int32),
                       max=n_l - 1)
    l1, l2, _, _ = rng.uniform4(pix, sample, bounce, rng.P_LIGHT_SAMPLE,
                                seed)
    q.update(
        t=t[:, None], kind=kind[:, None], idx=idx[:, None],
        point=torch.stack(attrs["point"], -1),
        uv=torch.stack(attrs["uv"], -1),
        texel=torch.stack([torch.where(tid >= 0, integrator.texel_index(
            cs.textures, tid, attrs["uv"]), -1) for tid in (
                integrator.mat_row(cs.materials, m)[key] for m, key in zip(
                    mats, ("albedo_tex", "normal_tex")))], -1),
        normal=torch.stack(sc["shading_normal"], -1),
        cos_dir=torch.stack(rng.cosine_direction3(r1, r2), -1),
        light_dir=torch.stack(intersect.sample_light_direction3(
            cs.lights, attrs["point"], pick, l1, l2, kinds=cs.light_kinds),
            -1),
        light_pdf=intersect.light_pdf_mean3(
            cs.lights, attrs["point"], sc["new_dir"],
            kinds=cs.light_kinds)[:, None],
        new_dir=torch.stack(sc["new_dir"], -1), prob=sc["prob"][:, None])
    st = integrator.path_step(cs, o, d, bounce, acc_len, fold, pix, sample,
                              seed, alive, max_depth)
    q.update(throughput=torch.stack(st["fold"][0] + st["fold"][1], -1),
             color=st["color"], terminal=st["terminal"][:, None])
    alive = alive & ~st["terminal"]
    d = tuple(torch.where(alive, c, 0.0) for c in st["d"])
    return q, (st["o"], d, st["bounce"], st["acc_len"], st["fold"], alive)


def _replay(cs, lanes, sample, seed, w, h, max_depth):
    """Every pixel's lane of one sample pass (the whole image, as the
    render runs it), bounce by bounce until the paths of the pixel ids
    ``lanes`` have ended: per bounce their quantities and every lane's
    state going in, on the host."""
    import torch

    pix = torch.arange(w * h, dtype=torch.int64, device=cs.device)
    lanes = lanes.to(cs.device)
    state = _replay_start(cs, pix, sample, seed, w, h)
    recs, states = [], []
    for _ in range(max_depth + 1):
        if not bool(state[5][lanes].any()):
            break
        states.append(_to(state, "cpu"))
        q, state = _replay_bounce(cs, state, pix, sample, seed, max_depth)
        recs.append({k: v[lanes].cpu() for k, v in q.items()})
    return recs, states


def _to(tree, device):
    """A nest of tuples of tensors, moved to ``device``."""
    if isinstance(tree, tuple):
        return tuple(_to(x, device) for x in tree)
    return tree.to(device)


def _ulps(a, b):
    """Largest distance between two f32 tensors in units in the last
    place (0 where both are the same NaN or infinity); for integers the
    largest difference."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i + 2 ** 31), i)

    if not a.is_floating_point():
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
    return int((ordered(a) - ordered(b)).abs().max())


def _differs(name, a, b, bits):
    """Whether quantity ``name`` differs between the devices: in any bit
    (``bits``), else beyond rounding (a discrete quantity in any bit, a
    float beyond rtol 1e-3 / atol 1e-3, or NaN or infinity on one side)."""
    import torch

    if bits or name in DISCRETE or not a.is_floating_point():
        if a.is_floating_point():
            return not torch.equal(a.view(torch.int32), b.view(torch.int32))
        return not torch.equal(a, b)
    return not bool(torch.isclose(a, b, rtol=1e-3, atol=1e-3,
                                  equal_nan=True).all())


def _first_difference(card, cpu, alive_card, alive_cpu, j, bits):
    """The first (bounce, quantity) at which lane j of the two replays
    differs, looking at the bounces where the lane is alive on either
    (``alive_*``: per bounce, whether it is)."""
    for b in range(min(len(card), len(cpu))):
        if not (alive_card[b] or alive_cpu[b]):
            return None
        for name in REPLAY_ORDER:
            if _differs(name, card[b][name][j], cpu[b][name][j], bits):
                return b, name
    return None


def _same_inputs(cs_card, state_cpu, cpu_rec, j, lanes, w, h, sample,
                 seed, max_depth):
    """The quantities of lane j that still differ in some bit when the card
    runs a bounce from the CPU's own state going into it (``state_cpu``,
    its rays included): what that bounce's torch ops compute differently
    on the two devices."""
    import torch

    pix = torch.arange(w * h, dtype=torch.int64, device=cs_card.device)
    q, _ = _replay_bounce(cs_card, _to(state_cpu, cs_card.device), pix,
                          sample, seed, max_depth)
    return [n for n in REPLAY_ORDER if _differs(
        n, q[n][lanes.to(cs_card.device)][j].cpu(), cpu_rec[n][j], True)]


def _camera_probe(compiled, pid, sample, seed, w, h):
    """The camera's screen coordinates of pixel ``pid``, u = (x + j1) /
    (w - 1) and v = (y + j2) / (h - 1) as ``integrator.camera_rays``
    computes them: their ulps between the devices, and the card's against
    the CPU's multiply by the f32 reciprocal of the divisor (0: the card
    divides by a Python number that way, the CPU exactly)."""
    import torch
    from solstrale_tpu_torch.ops import rng

    out = {}
    for dev, cs in compiled.items():
        pix = torch.tensor([pid], dtype=torch.int64, device=cs.device)
        j1, j2, _, _ = rng.uniform4(pix, sample, 0, rng.P_JITTER, seed)
        x = (pix % w).to(torch.float32) + j1
        y = (pix // w).to(torch.float32) + j2
        out[dev] = [z.cpu() for z in (x / (w - 1), y / (h - 1),
                                      x * (1.0 / (w - 1)),
                                      y * (1.0 / (h - 1)))]
    card, cpu = out["cuda"], out["cpu"]
    return dict(u_ulps=_ulps(card[0], cpu[0]), v_ulps=_ulps(card[1], cpu[1]),
                card_vs_cpu_reciprocal_ulps=[_ulps(card[0], cpu[2]),
                                             _ulps(card[1], cpu[3])])


def _light_probe(compiled, recs, b, j):
    """Each light whose pdf for lane j's direction at bounce b differs
    between the devices (``intersect.light_pdf_values`` of that device's
    own point and direction): its index and kind, both pdfs, and for a
    sphere both devices' discriminant half_b^2 - |d|^2 c of the
    re-intersection test with its share of half_b^2 (near 0: a graze)."""
    import torch
    from solstrale_tpu_torch.geo import soa
    from solstrale_tpu_torch.ops import intersect

    per = {}
    for dev, cs in compiled.items():
        p, d = (recs[dev][b][k][j:j + 1].to(cs.device).unbind(-1)
                for k in ("point", "new_dir"))
        pdf = intersect.light_pdf_values(cs.lights, p, d)[0]
        # the sphere test's operations in light_pdf_values' order
        oc = soa.vsub(p, cs.lights.p0.unbind(-1))
        half_b = soa.dot3(oc, d)
        radius = cs.lights.radius
        disc = half_b * half_b - soa.dot3(d, d) * (soa.dot3(oc, oc)
                                                   - radius * radius)
        per[dev] = [x.cpu() for x in (pdf, disc, disc / (half_b * half_b))]
    kind = compiled["cpu"].lights.kind.cpu()
    out = []
    for li in torch.nonzero(per["cuda"][0] != per["cpu"][0]).flatten():
        li = int(li)
        row = dict(light=li, kind=int(kind[li]),
                   pdf=[float(per[k][0][li]) for k in ("cuda", "cpu")])
        if int(kind[li]) == 0:
            row.update(disc=[float(per[k][1][li]) for k in ("cuda", "cpu")],
                       disc_share=[float(per[k][2][li])
                                   for k in ("cuda", "cpu")])
        out.append(row)
    return out


def _values(x):
    return [float(v) if x.is_floating_point() else int(v)
            for v in x.flatten().tolist()]


def _trace_outliers(name, variant, compiled, outliers, gpu, cpu, w, h, spp,
                    seed=1, sample_start=1, max_depth=50):
    """For each outlier pixel ((image row, column) of ``gpu`` / ``cpu``),
    find the first (sample, bounce) at which the two devices' lanes part:
    replay its samples on both devices one bounce at a time, until one
    parts, and compare the draws, o, d, (t, kind, idx) and the rest of
    ``REPLAY_ORDER``. Prints one ``card_vs_cpu_outlier`` line per pixel:
    the first difference beyond rounding and the first in any bit, each
    with both values, the ulps of o and d going into that bounce, what
    still differs when the card runs that bounce from the CPU's inputs,
    the camera's screen coordinates' ulps, and for a light pdf each light
    whose pdf differs."""
    import torch

    ids = [(h - 1 - r) * w + c for r, c in outliers]
    lanes = torch.tensor(ids, dtype=torch.int64)
    lines = [dict(scene=name, shader=variant, pixel=[r, c], pixel_id=pid,
                  card=gpu[r, c].tolist(), cpu=cpu[r, c].tolist())
             for (r, c), pid in zip(outliers, ids)]
    for s in range(sample_start, sample_start + spp):
        todo = [j for j, ln in enumerate(lines)
                if "first_difference" not in ln]
        if not todo:
            break
        run = {dev: _replay(compiled[dev], lanes, s, seed, w, h, max_depth)
               for dev in ("cuda", "cpu")}
        recs = {dev: r[0] for dev, r in run.items()}
        st_cpu = run["cpu"][1]
        for j in todo:
            alive = [[bool(x[5][ids[j]]) for x in run[dev][1]]
                     for dev in ("cuda", "cpu")]
            first = {}
            for key, bits in (("first_difference", False),
                              ("first_bit_difference", True)):
                hit = _first_difference(recs["cuda"], recs["cpu"], *alive,
                                        j, bits)
                if hit is None:
                    continue
                b, qn = hit
                card, host = recs["cuda"][b], recs["cpu"][b]
                first[key] = dict(
                    bounce=b, quantity=qn, card=_values(card[qn][j]),
                    cpu=_values(host[qn][j]),
                    ulps=_ulps(card[qn][j], host[qn][j]),
                    ulps_in=dict(o=_ulps(card["o"][j], host["o"][j]),
                                 d=_ulps(card["d"][j], host["d"][j])),
                    same_inputs_differ=_same_inputs(
                        compiled["cuda"], st_cpu[b], host, j, lanes, w, h,
                        s, seed, max_depth))
                if b == 0:
                    first[key]["camera"] = _camera_probe(
                        compiled, ids[j], s, seed, w, h)
                if qn == "light_pdf":
                    first[key]["lights"] = _light_probe(compiled, recs, b, j)
            if "first_difference" in first or "sample" not in lines[j]:
                lines[j].update(sample=s, **first)
    for ln in lines:
        ln["reproduced"] = "first_difference" in ln
        log("card_vs_cpu_outlier", **ln)


def _card_vs_cpu(name, scene, variants, w, h, spp, start):
    """``scene`` compiled on the card and on the CPU and rendered with each
    of ``variants`` ((label, shader kind, aux)) at w x h, ``spp`` samples:
    segments within 1e-3, 99.9% of pixels within 1e-3 on every plane, and
    the card run repeated bit for bit. The first ``MAX_OUTLIERS`` pixels
    of the scene outside 1e-3 are traced to their first difference
    (``_trace_outliers``)."""
    import numpy as np
    from solstrale_tpu_torch.renderer import integrator
    from solstrale_tpu_torch.scene.compile import compile_scene

    compiled = {dev: compile_scene(scene, device=dev)
                for dev in ("cuda", "cpu")}
    traced = set()
    for variant, shader_kind, need_aux in variants:
        kw = dict(width=w, height=h, max_depth=50, shader_kind=shader_kind,
                  need_aux=need_aux, n_samples=spp)
        runs = {}
        for dev in ("cuda", "cpu", "cuda"):
            planes = integrator.render_sample_batch(compiled[dev], 1, 1, **kw)
            img = np.concatenate([p.cpu().numpy() for p in
                                  planes[:3 if need_aux else 1]], -1)
            runs.setdefault(dev, []).append((img, int(planes[3])))
        (gpu, gseg), (gpu2, gseg2) = runs["cuda"]
        cpu, cseg = runs["cpu"][0]
        label = f"{name} {variant}"
        if not (np.array_equal(gpu, gpu2) and gseg == gseg2):
            raise AssertionError(f"{label}: repeated card run not "
                                 "bit-identical")
        if abs(gseg - cseg) > 1e-3 * cseg:
            raise AssertionError(f"{label}: segments card {gseg} cpu {cseg}")
        close = np.isclose(gpu, cpu, rtol=1e-3, atol=1e-3).reshape(
            h, w, -1, 3).all(axis=-1)
        # the replay is the path whatever the shader: one line a pixel
        outliers = [(int(r), int(c)) for r, c in
                    zip(*np.nonzero(~close.all(axis=-1)))
                    if (int(r), int(c)) not in traced]
        outliers = outliers[:max(0, MAX_OUTLIERS - len(traced))]
        if outliers:
            _trace_outliers(name, variant, compiled, outliers, gpu, cpu, w,
                            h, spp)
            traced.update(outliers)
        if close.mean(axis=(0, 1)).min() < 0.999:
            raise AssertionError(f"{label}: only {close.mean():.4f} of "
                                 "pixels agree card vs CPU within 1e-3")
        log("card_vs_cpu", scene=name, shader=variant, segments_card=gseg,
            segments_cpu=cseg,
            pixels_within_1e3=float(close.mean(axis=(0, 1)).min()),
            max_abs_diff=float(np.abs(gpu - cpu).max()), bit_identical=True,
            seconds=time.perf_counter() - start)


def phase_card_vs_cpu():
    """Five small scenes (the fifth the terrain loaded from an OBJ of 128
    triangles) rendered on the card and on the CPU, with the path shader
    (aux off and on) and the three debug shaders: segments within 1e-3,
    99.9% of pixels within 1e-3 on every plane, and the card run repeated
    bit for bit."""
    import tempfile

    import solstrale_tpu_torch as T
    from solstrale_tpu_torch import fixtures
    from solstrale_tpu_torch.renderer import integrator

    w, h, spp = 64, 48, 2
    start = time.perf_counter()
    objdir = tempfile.TemporaryDirectory()
    fixtures.write_obj_scene(objdir.name, n_cells=8)
    variants = (("path", integrator.SHADER_PATH, False),
                ("path+aux", integrator.SHADER_PATH, True),
                ("albedo", integrator.SHADER_ALBEDO, False),
                ("normal", integrator.SHADER_NORMAL, False),
                ("simple", integrator.SHADER_SIMPLE, False))
    for name, build in (
            ("mixed_bvh_scene", lambda c: fixtures.mixed_bvh_scene(
                c, n_cells=48)),
            ("small_scene", fixtures.small_scene),
            ("kitchen_sink_solid_scene", fixtures.kitchen_sink_solid_scene),
            ("kitchen_sink_scene", fixtures.kitchen_sink_scene),
            ("obj_scene", lambda c: fixtures.obj_scene(c, objdir.name))):
        _card_vs_cpu(name, build(T.RenderConfig(width=w, height=h, seed=1)),
                     variants, w, h, spp, start)
    objdir.cleanup()


def _grad_step(cs, target, w, h, depth, wrappers=None):
    """One inverse-rendering step (``diff.image_and_texture_grad``'s loss
    and arena gradient) taken by hand, so that the kernels' launches of the
    forward and of the backward's replay are read apart, the backward's
    zero fills and adds of the arena's size (``profiling.ArenaOps``) are
    counted, and so are the ops each part dispatches that are not views
    (``wavefront_ab.dispatched_ops_mode``). Returns (loss, gradient,
    launches, arena ops and dispatched ops)."""
    import torch
    from solstrale_tpu_torch import diff
    from solstrale_tpu_torch.profiling import ArenaOps
    from solstrale_tpu_torch.wavefront_ab import dispatched_ops_mode

    p = cs.textures.pixels.detach().requires_grad_(True)
    counts = {}
    if wrappers:
        reset_launches(wrappers)
    with dispatched_ops_mode() as fwd:
        img = diff.render_linear(diff.set_texture_params(cs, p), width=w,
                                 height=h, max_depth=depth, n_samples=1,
                                 seed=1)
        loss = torch.mean((img - target) ** 2)
    if wrappers:
        counts["forward"] = launch_counts(wrappers)
        reset_launches(wrappers)
    with dispatched_ops_mode() as bwd, ArenaOps(p.shape[0]) as ops:
        g, = torch.autograd.grad(loss, p)
    counts["arena_ops"] = dict(fills=ops.fills, adds=ops.adds)
    counts["dispatched_ops"] = dict(forward=fwd.n, replay=bwd.n)
    if wrappers:
        counts["replay"] = launch_counts(wrappers)
    return loss.detach(), g, counts


def _parent_route_step(cs, target, w, h, depth, wrappers):
    """``_grad_step`` on the route the differentiable bounce took before S1B:
    autograd through the torch composition (``integrator.path_step_plain``:
    the hit, then ``shade_plain``, with the draw kernel), put in place of
    ``path_step_grad`` for this call only. Returns what ``_grad_step``
    does."""
    from solstrale_tpu_torch.renderer import integrator

    route = integrator.path_step_grad
    integrator.path_step_grad = integrator.path_step_plain
    try:
        return _grad_step(cs, target, w, h, depth, wrappers)
    finally:
        integrator.path_step_grad = route


def _eager_step(cs, target, w, h, depth):
    """The inverse step dispatched op by op on the card (``diff._GradStep``
    without its graph: the plain version of a replay)."""
    from solstrale_tpu_torch import diff

    return diff._GradStep(cs, target, width=w, height=h, max_depth=depth,
                          n_samples=1, seed=1)


def _event_ms(fn):
    """One call of fn timed by CUDA events (ms)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def _unchunked_step(cs, target, w, h, depth):
    """The step with the whole tape kept: the fixed trip's checkpoint
    replaced by a plain call, as tests/test_torch_diff.py's unchunked test
    does on the CPU, run eagerly (a cached graph would keep its chunks).
    Returns (peak bytes above the step's start, step ms as the median of 3
    after the measured call, gradient)."""
    import torch
    import torch.utils.checkpoint

    chunked = torch.utils.checkpoint.checkpoint
    torch.utils.checkpoint.checkpoint = lambda fn, *args, **kw: fn(*args)
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, g, _ = _grad_step(cs, target, w, h, depth)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        step = _eager_step(cs, target, w, h, depth)
        ms = wrapper_ms(lambda: step.eager(cs, target), reps=3, warmup=0)
    finally:
        torch.utils.checkpoint.checkpoint = chunked
    return peak, ms, g


def _pool_bytes(graph):
    """Bytes of the device segments held by ``graph``'s private memory
    pool (the allocator's snapshot), and the segments counted."""
    import torch

    pool = tuple(graph.pool())
    segs = [s for s in torch.cuda.memory_snapshot()
            if tuple(s.get("segment_pool_id") or ()) == pool]
    return sum(s["total_size"] for s in segs), len(segs)


def _graphed_step_cell(name, cs, target, w, h, depth, eager_counts,
                       wrappers):
    """The step as ``diff.image_and_texture_grad`` runs it on the card (one
    CUDA graph a geometry and key) beside the eager step on the same
    inputs: its first call (the capture), three replays and three eager
    steps (CUDA events, in turns), each's peak bytes above the step's start,
    the graph pool's resident bytes, the host reads inside a call, and the
    launches of one replay against the eager step's forward + replay.
    Checks the replay against the eager step (loss rtol 1e-5; gradient
    rtol 1e-5, atol 1e-7) and the launches. Returns the log fields."""
    import torch
    from solstrale_tpu_torch import diff
    from solstrale_tpu_torch.profiling import HostReads

    kw = dict(width=w, height=h, max_depth=depth, n_samples=1, seed=1)
    eager = _eager_step(cs, target, w, h, depth)

    def peak_of(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base, out

    captures = diff._GradStep.captures
    t0 = time.perf_counter()
    capture_peak, (loss_g, g_g) = peak_of(
        lambda: diff.image_and_texture_grad(cs, target, **kw))
    capture_s = time.perf_counter() - t0
    if diff._GradStep.captures != captures + 1:
        raise AssertionError(f"{name}: {diff._GradStep.captures - captures}"
                             " captures on a key's first call")
    step = diff.grad_step(cs, target, **kw)
    pool, pool_segments = _pool_bytes(step.graph)
    reset_launches(wrappers)
    with HostReads() as reads:
        replay_peak, (loss_r, g_r) = peak_of(
            lambda: diff.image_and_texture_grad(cs, target, **kw))
    counts = launch_counts(wrappers)
    with HostReads() as eager_reads:
        eager_peak, (loss_e, g_e) = peak_of(lambda: eager.eager(cs, target))
    # three of each in turns: graph, eager, eager, graph, graph, eager
    ms = {"graph": [], "eager": []}
    for side in ("graph", "eager", "eager", "graph", "graph", "eager"):
        ms[side].append(_event_ms(
            (lambda: diff.image_and_texture_grad(cs, target, **kw))
            if side == "graph" else (lambda: eager.eager(cs, target))))
    if diff._GradStep.captures != captures + 1:
        raise AssertionError(f"{name}: a replay captured again")
    torch.testing.assert_close(loss_r, loss_e, rtol=1e-5, atol=0)
    torch.testing.assert_close(g_r, g_e, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(loss_g, loss_e, rtol=1e-5, atol=0)
    torch.testing.assert_close(g_g, g_e, rtol=1e-5, atol=1e-7)
    want = {k: eager_counts["forward"][k] + eager_counts["replay"][k]
            for k in counts}
    if counts != want or reads.n:
        raise AssertionError(f"{name}: a replay launched {counts}, the "
                             f"eager step {want}; host reads {reads.n}")
    return dict(
        graph_step_ms=sorted(ms["graph"])[1], graph_step_ms_all=ms["graph"],
        eager_step_ms=sorted(ms["eager"])[1], eager_step_ms_all=ms["eager"],
        capture_s=capture_s,
        capture_peak_bytes=capture_peak, replay_peak_bytes=replay_peak,
        eager_peak_bytes=eager_peak, pool_bytes=pool,
        pool_segments=pool_segments,
        host_reads_replay=reads.n, host_reads_eager=eager_reads.n,
        replay_launches=counts,
        replay_grad_max_abs_err=float((g_r - g_e).abs().max()),
        replay_loss_rel_err=float(abs(loss_r - loss_e) / loss_e)), (loss_e,
                                                                   g_e)


def _sgd_loop(cs, target, w, h, depth, lr, steps=10):
    """``steps`` SGD steps through ``set_texture_params``, graphed
    (``image_and_texture_grad``) and eager (one ``_GradStep`` run op by op),
    from the same scene. Returns (final arenas, captures of the graphed
    loop, losses of each)."""
    from solstrale_tpu_torch import diff

    kw = dict(width=w, height=h, max_depth=depth, n_samples=1, seed=1)
    eager = _eager_step(cs, target, w, h, depth)
    captures = diff._GradStep.captures
    out = {}
    for side in ("graph", "eager"):
        p, losses = cs, []
        for _ in range(steps):
            loss, g = (diff.image_and_texture_grad(p, target, **kw)
                       if side == "graph" else eager.eager(p, target))
            losses.append(float(loss))
            p = diff.set_texture_params(p, p.textures.pixels - lr * g)
        out[side] = (p.textures.pixels, losses)
        if side == "graph":
            captured = diff._GradStep.captures - captures
    return out, captured


def phase_diff_parallel(sponza_cs, smi):
    """5: the inverse-rendering step at full size (K1-K3 on mixed 1080p,
    K4 on the kitchen): its bounces on S1 and S1B (S1 51 + 50 launches, S1B
    51, the draw kernel only for the camera rays), its loss equal to the
    route before S1B's (autograd through the torch composition) and its
    gradient within rtol 1e-4, atol 1e-7, the graphed step's device ops and
    pool; card against CPU, the
    shard route and the sharded step on a one-rank NCCL group, and the
    denoiser trainer. Returns the launches of the two graphed inverse
    steps' replays (their kernels' main path)."""
    import numpy as np
    import torch
    import solstrale_tpu_torch as T
    from solstrale_tpu_torch import diff, fixtures, parallel
    from solstrale_tpu_torch.models import denoiser, train_denoiser
    from solstrale_tpu_torch.ops import _build
    from solstrale_tpu_torch.parallel import distributed
    from solstrale_tpu_torch.post.denoise import BUNDLED_WEIGHTS
    from solstrale_tpu_torch.renderer import integrator
    from solstrale_tpu_torch.scene.compile import compile_scene
    from solstrale_tpu_torch.utils import to_rgb_u8

    from solstrale_tpu_torch.profiling import _profile, fills_and_adds

    wrappers = all_wrappers()
    start = time.perf_counter()
    depth = 50
    path_launches = dict.fromkeys(wrappers, 0)
    for name, build, (w, h), need in (
            ("mixed", lambda c: fixtures.mixed_bvh_scene(c, n_cells=362),
             (1920, 1080), ("K1", "K2", "K3")),
            ("kitchen", fixtures.kitchen_sink_scene, (400, 266), ("K4",))):
        cs = compile_scene(build(T.RenderConfig(width=w, height=h, seed=1)),
                           device="cuda")
        with torch.no_grad():
            target = diff.render_linear(cs, width=w, height=h,
                                        max_depth=depth, n_samples=1, seed=2)
            img = diff.render_linear(cs, width=w, height=h, max_depth=depth,
                                     n_samples=1, seed=1)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, g, counts = _grad_step(cs, target, w, h, depth, wrappers)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        # the camera rays: one CR launch in the forward, none in the
        # replay, and no draw kernel; the arena's gradient zeroed once a
        # backward pass (the pass's sums, ops.step.GradSums) and added to
        # nothing else: no S1B call zeroes a gradient of its own, and
        # autograd adds none a bounce
        want = {"forward": dict(S1=depth + 1, S1B=0, CR=1, draw=0, CRB=0,
                                FHB=0),
                "replay": dict(S1=depth, S1B=depth + 1, CR=0, draw=0, CRB=0,
                               FHB=0),
                "arena_ops": dict(fills=1, adds=0)}
        if any(counts[part][k] != n for part, ks in want.items()
               for k, n in ks.items()):
            raise AssertionError(f"{name}: the inverse step's launches "
                                 f"{counts}, expected {want}")
        loss_p, g_p, counts_p = _parent_route_step(cs, target, w, h, depth,
                                                   wrappers)
        if not torch.equal(loss_p, loss) or counts_p["forward"]["S1"] or \
                counts_p["replay"]["S1B"]:
            raise AssertionError(f"{name}: loss {float(loss)} against the "
                                 f"route before S1B's {float(loss_p)}; its "
                                 f"launches {counts_p}")
        # the texels' sums of ~10^5 signed path contributions, added in
        # another grouping (S1B's warp sums against index_add_'s lanes)
        torch.testing.assert_close(g, g_p, rtol=1e-4, atol=1e-7)
        flat_peak, flat_ms, g_flat = _unchunked_step(cs, target, w, h, depth)
        cell, (loss2, again) = _graphed_step_cell(name, cs, target, w, h,
                                                  depth, counts, wrappers)
        for k, n in cell["replay_launches"].items():
            path_launches[k] += n
        prof, kernels = _profile(lambda: diff.image_and_texture_grad(
            cs, target, width=w, height=h, max_depth=depth, n_samples=1,
            seed=1))
        fills, adds = fills_and_adds(kernels)
        # the first hit's backwards add nothing to the step: its dispatched
        # ops and kernel launches, forward and backward, as before them
        work = {part: (counts["dispatched_ops"][part],
                       sum(counts[part].values()))
                for part in ("forward", "replay")}
        if work != STEP_DEVICE_WORK[name]:
            raise AssertionError(f"{name}: the step's (dispatched ops, "
                                 f"kernel launches) {work}, "
                                 f"{STEP_DEVICE_WORK[name]} before")
        if not (bool(torch.isfinite(img).all())
                and bool(torch.isfinite(g).all()) and bool((g != 0).any())):
            raise AssertionError(f"{name}: image or gradient not finite, "
                                 "or the gradient all zero")
        torch.testing.assert_close(again, g, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(g_flat, g, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(loss2, loss, rtol=1e-5, atol=0)
        if not float(loss) > 0:
            raise AssertionError(f"{name}: loss {float(loss)}")
        for k in need:
            if counts["forward"][k] < depth or counts["replay"][k] < depth:
                raise AssertionError(f"{name}: {k} launches {counts}")
        if name == "kitchen" and any(counts["forward"][k] for k in
                                     ("K1", "K2", "K3", "K5")):
            raise AssertionError(f"kitchen: launches off the K4 route "
                                 f"{counts}")
        log("diff_step", gpu=smi, scene=name, width=w, height=h,
            max_depth=depth, loss=float(loss), step_ms=cell["graph_step_ms"],
            peak_bytes=peak, baseline_bytes=base,
            flat_tape_peak_bytes=flat_peak, flat_tape_step_ms=flat_ms,
            chunk=integrator.remat_chunk(depth),
            grad_nonzero=int((g != 0).sum()), launches=counts,
            parent_route_loss_equal=True, parent_route_launches=counts_p,
            parent_route_grad_max_abs_err=float((g - g_p).abs().max()),
            device_ops_per_step=prof["kernel_launches"],
            device_fills_per_step=fills, device_adds_per_step=adds,
            device_busy_ms=prof["device_busy_ms"],
            device_idle_share=prof["device_idle_share"],
            kernel_ms=prof["hit_kernel_ms"], **cell,
            seconds=time.perf_counter() - start)
        if name == "kitchen":
            # a 10-step SGD loop from a scene of its own: one capture, and
            # the eager loop's arena (lr 0.3: the loss falls at every step
            # of a 40x27, depth-8 CPU run; 1.0 oscillates, 3.0 diverges)
            fresh = compile_scene(build(T.RenderConfig(width=w, height=h,
                                                       seed=1)),
                                  device="cuda")
            lr = 0.3
            loop, captured = _sgd_loop(fresh, target, w, h, depth, lr)
            (p_g, losses_g), (p_e, losses_e) = loop["graph"], loop["eager"]
            if captured != 1:
                raise AssertionError(f"SGD loop: {captured} captures")
            torch.testing.assert_close(p_g, p_e, rtol=1e-4, atol=1e-7)
            log("diff_sgd_loop", gpu=smi, scene=name, steps=10, lr=lr,
                captures=captured, losses_graph=losses_g,
                losses_eager=losses_e,
                arena_max_abs_err=float((p_g - p_e).abs().max()),
                arena_moved=float((p_g - fresh.textures.pixels).abs().max()),
                seconds=time.perf_counter() - start)
            del fresh, loop, p_g, p_e
        del cs, target, img, g, again, g_flat, g_p
    if path_launches["S1"] <= 0 or path_launches["S1B"] <= 0 or \
            path_launches["CR"] != 2 or path_launches["draw"] != 0:
        raise AssertionError(f"the graphed inverse steps launched "
                             f"{path_launches}")

    # card against CPU at 64x32, depth 8
    for name, build in (
            ("mixed", lambda c: fixtures.mixed_bvh_scene(c, n_cells=32)),
            ("kitchen", fixtures.kitchen_sink_scene)):
        scene = build(T.RenderConfig(width=64, height=32, seed=1))
        out = {}
        for dev in ("cuda", "cpu"):
            cs = compile_scene(scene, device=dev)
            with torch.no_grad():
                target = diff.render_linear(cs, width=64, height=32,
                                            max_depth=8, n_samples=1, seed=2)
            out[dev] = [x.cpu() for x in diff.image_and_texture_grad(
                cs, target, width=64, height=32, max_depth=8, n_samples=1,
                seed=1)]
        (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
        torch.testing.assert_close(lg, lc, rtol=1e-3, atol=1e-4)
        torch.testing.assert_close(gg, gc, rtol=1e-3, atol=1e-4)
        log("diff_card_vs_cpu", gpu=smi, scene=name, loss_card=float(lg),
            loss_cpu=float(lc), grad_max_abs_err=float((gg - gc).abs().max()),
            grad_max_abs=float(gc.abs().max()),
            seconds=time.perf_counter() - start)

    # a one-rank NCCL group: the shard route and the sharded step
    store = _build._BUILD / "nccl_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    n, rank = distributed.initialize(f"file://{store}", 1, 0, "cuda")
    try:
        mesh = parallel.make_mesh(1, 1, device_type="cuda")
        w, h = 1920, 1080
        kw = dict(width=w, height=h, max_depth=50)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img_s, segs_s = parallel.render_batch_sharded(sponza_cs, 1, 1, 1,
                                                      mesh, **kw)
        torch.cuda.synchronize()
        t_shard = time.perf_counter() - t0
        img, _, _, segs = integrator.render_sample_batch(
            sponza_cs, 1, 1, shader_kind=integrator.SHADER_PATH,
            need_aux=False, n_samples=1, **kw)
        if not torch.equal(img_s, img) or int(segs_s) != int(segs) or \
                int(segs) != SPONZA_SEGMENTS:
            raise AssertionError(f"render_batch_sharded: segments "
                                 f"{int(segs_s)} / {int(segs)}, images "
                                 f"equal {torch.equal(img_s, img)}")
        kitchen = compile_scene(fixtures.kitchen_sink_scene(T.RenderConfig(
            width=400, height=266, seed=1)), device="cuda")
        with torch.no_grad():
            target = diff.render_linear(kitchen, width=400, height=266,
                                        max_depth=50, n_samples=1, seed=2)
        lr = 10.0
        loss_s, new_cs = diff.train_step_sharded(
            kitchen, target, mesh, width=400, height=266, max_depth=50,
            lr=lr, seed=1)
        loss, g = diff.image_and_texture_grad(
            kitchen, target, width=400, height=266, max_depth=50,
            n_samples=1, seed=1)
        # the step's gradient against the unsharded one: their sums of
        # ~10^5 path contributions per arena entry accumulate in another
        # order (atomics): 1.2e-5 apart at most on an H100
        torch.testing.assert_close(loss_s, loss, rtol=1e-5, atol=0)
        torch.testing.assert_close(
            (kitchen.textures.pixels - new_cs.textures.pixels) / lr, g,
            rtol=1e-4, atol=1e-7)
        # render_sample_sharded, grad mode on as a user calls it: one
        # replay of the rank's sample pass graph (captured by a first pass
        # at sample 2; the whole image is the one rank's tile, so
        # render_sample replays the same graph), the fixed trip's 51 S1
        # launches, render_sample's planes and launches, and the eager
        # early exit's planes bit for bit (its bounces logged)
        kw = dict(width=400, height=266, max_depth=50,
                  shader_kind=integrator.SHADER_PATH, need_aux=False)
        parallel.render_sample_sharded(kitchen, 2, 1, mesh, **kw)
        runs = {}
        for name, fn in (
                ("sharded", lambda: parallel.render_sample_sharded(
                    kitchen, 1, 1, mesh, **kw)),
                ("render_sample", lambda: integrator.render_sample(
                    kitchen, 1, 1, **kw)),
                ("early_exit", lambda: tuple(
                    integrator.to_image(c, 400, 266)
                    for c in integrator.sample_pass_eager(
                        kitchen, torch.arange(400 * 266, device="cuda"), 1,
                        1, width=400, height=266, max_depth=50,
                        need_aux=False)))):
            reset_launches(wrappers)
            replays = _sample_replays(kitchen)
            planes = fn()
            runs[name] = (planes, launch_counts(wrappers),
                          _sample_replays(kitchen) - replays)
        (p_s, l_s, r_s), (p_r, l_r, r_r), (p_e, l_e, r_e) = runs.values()
        if not l_s["S1"] == l_s["K4"] == 51 or l_s != l_r or \
                (r_s, r_r, r_e) != (1, 1, 0) or \
                not l_e["S1"] == l_e["K4"] <= 51 or \
                not all(torch.equal(a, b) and torch.equal(a, c)
                        for a, b, c in zip(p_s, p_r, p_e)):
            raise AssertionError(f"render_sample_sharded: expected one "
                                 f"replay of 51 S1 launches, render_sample's "
                                 f"planes and the early exit's, got {l_s} / "
                                 f"{l_r} / {l_e}, replays {r_s}, {r_r}, "
                                 f"{r_e}")
        small = fixtures.small_scene(T.RenderConfig(
            width=320, height=180, samples_per_pixel=2, seed=1))
        reset_launches(wrappers)
        images = [im for _, im in distributed.render_distributed(
            small, device_type="cuda")]
        l_d = launch_counts(wrappers)
        # two passes, each a replay of the sample pass graph's fixed trip,
        # after the capture's warm-up pass: 3 x 51 S1 launches
        if l_d["S1"] != 3 * 51:
            raise AssertionError(f"render_distributed: expected a warm-up "
                                 f"and two replays of 51 S1 launches, got "
                                 f"{l_d}")
        cs = compile_scene(small, device="cuda")
        total = sum(integrator.render_sample(
            cs, s, 1, width=320, height=180, max_depth=50,
            shader_kind=integrator.SHADER_PATH, need_aux=False)[0]
            for s in (1, 2))
        eager = sum(integrator.to_image(integrator.sample_pass_eager(
            cs, torch.arange(320 * 180, device="cuda"), s, 1, width=320,
            height=180, max_depth=50, need_aux=False)[0], 320, 180)
            for s in (1, 2))
        if len(images) != 2 or not torch.equal(total, eager) or \
                not np.array_equal(images[-1],
                                   to_rgb_u8(total, 2).cpu().numpy()):
            raise AssertionError("render_distributed: final image differs")
        _check_image("render_distributed", images[-1], 180, 320)
        log("nccl_one_rank", gpu=smi, world=n, rank=rank,
            backend=torch.distributed.get_backend(),
            sponza_segments=int(segs_s), sponza_sharded_s=t_shard,
            sharded_step_loss=float(loss_s),
            sharded_step_equals_sgd=True, distributed_images=len(images),
            render_sample_sharded_launches=l_s,
            early_exit_bounces=l_e["S1"],
            render_distributed_launches=l_d,
            seconds=time.perf_counter() - start)
    finally:
        torch.distributed.destroy_process_group()

    # the denoiser trainer: a few steps on two fixture scenes at 64x64, and
    # one step on the card against one on the CPU
    size = 64
    scenes = [lambda spp: fixtures.small_scene(T.RenderConfig(
                  width=size, height=size, samples_per_pixel=spp, seed=3)),
              lambda spp: fixtures.kitchen_sink_solid_scene(T.RenderConfig(
                  width=size, height=size, samples_per_pixel=spp, seed=3))]
    t0 = time.perf_counter()
    net = train_denoiser.train(4, None, size=size, clean_spp=16,
                               scenes=scenes, device="cuda")
    t_train = time.perf_counter() - t0
    init = train_denoiser.init_like_flax(denoiser.DenoiserCNN()).cuda()
    if all(torch.equal(a, b) for a, b in zip(net.parameters(),
                                            init.parameters())):
        raise AssertionError("train_denoiser: parameters did not move")
    if not all(bool(torch.isfinite(p).all()) for p in net.parameters()):
        raise AssertionError("train_denoiser: non-finite parameters")
    pair = [x.cpu() for x in train_denoiser._render_pair(
        scenes[1], 4, 16, size, "cuda")]
    steps = {}
    for dev in ("cpu", "cuda"):
        model = denoiser.params_from_flax(denoiser.load_weights(
            BUNDLED_WEIGHTS)).to(dev)
        opt, sched = train_denoiser.make_optimizer(model, 10)
        loss = train_denoiser.train_step(model, opt, sched,
                                         *(x.to(dev) for x in pair))
        steps[dev] = (float(loss),
                      [p.grad.cpu() for p in model.parameters()],
                      [p.detach().cpu() for p in model.parameters()])
    (lg, gg, pg), (lc, gc, pc) = steps["cuda"], steps["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    scale = max(float(g.abs().max()) for g in gc)
    for a, b in zip(gg, gc):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * scale)
    # the Adam step on the card from the CPU's gradient equals the CPU's
    # step (a weight whose gradient is near Adam's eps, 1e-8, moves by
    # lr * g / (|g| + eps), so the gradients' last bits would reach it)
    model = denoiser.params_from_flax(denoiser.load_weights(
        BUNDLED_WEIGHTS)).cuda()
    opt, _ = train_denoiser.make_optimizer(model, 10)
    for p, g in zip(model.parameters(), gc):
        p.grad = g.cuda()
    opt.step()
    for p, b in zip(model.parameters(), pc):
        torch.testing.assert_close(p.detach().cpu(), b, rtol=1e-5, atol=5e-8)
    log("train_denoiser", gpu=smi, steps=4, size=size, seconds_train=t_train,
        loss_card=lg, loss_cpu=lc,
        grad_max_abs_err=max(float((a - b).abs().max())
                             for a, b in zip(gg, gc)),
        param_max_abs_err_own_gradients=max(
            float((a - b).abs().max()) for a, b in zip(pg, pc)),
        seconds=time.perf_counter() - start)
    return path_launches


def phase_obj_ingest(smi):
    """6: a 262,088-triangle OBJ written, parsed (native and plain), loaded,
    compiled with the LBVH built on the card and on the host (the trees
    equal exactly, and equal to the same build on the CPU), and rendered
    with ray_trace at 1080p through K1. Returns the kernels' launches of
    that render."""
    import tempfile

    import numpy as np
    import torch
    import solstrale_tpu_torch as T
    from solstrale_tpu_torch import accel, fixtures, native
    from solstrale_tpu_torch.scene import loader
    from solstrale_tpu_torch.scene.compile import compile_scene

    w, h = 1920, 1080
    start = time.perf_counter()
    cfg = T.RenderConfig(width=w, height=h, samples_per_pixel=1, seed=1,
                         shader=T.PathTracingShader(50))
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = fixtures.write_obj_scene(d)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        native.library()    # built by the first compile of a large scene
        t_native_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        parsed = native.parse_obj(path)
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = loader.parse_obj_arrays(path)
        t_plain = time.perf_counter() - t0
        n_tris = parsed[0].shape[0]
        if n_tris != 262088:
            raise AssertionError(f"OBJ parsed to {n_tris} triangles, not "
                                 "262,088")
        if not (all(np.array_equal(a, b) for a, b in zip(parsed[:3],
                                                         plain[:3]))
                and parsed[3:] == plain[3:]):
            raise AssertionError("native OBJ parse differs from the plain "
                                 "parse")
        t0 = time.perf_counter()
        scene = fixtures.obj_scene(cfg, d)
        t_load = time.perf_counter() - t0
        obj_bytes = os.path.getsize(path)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # in turns (device, host, host, device): the first compile also warms
    # up torch's kernels
    compiles, compiled = {"device": [], True: []}, {}
    for use_bvh in ("device", True, True, "device"):
        compiled[use_bvh], seconds = timed(lambda: compile_scene(
            scene, use_bvh=use_bvh, device="cuda"))
        compiles[use_bvh].append(seconds)
    cs_dev, cs_host = compiled["device"], compiled[True]
    host = compile_scene(scene, use_bvh=False, device="cpu")
    kinds, idxs, mins, maxs = accel.solids_aabbs(host.solids)
    args = [torch.from_numpy(a) for a in (mins.astype(np.float32),
                                          maxs.astype(np.float32), kinds,
                                          idxs)]
    on_card = [a.cuda() for a in args]
    # the first call warms up; median of the next three
    build_ms = [timed(lambda: accel.build_bvh_device(*on_card))[1] * 1e3
                for _ in range(4)][1:]
    cpu_bvh, t_build_cpu = timed(lambda: accel.build_bvh_device(*args))
    t_build_host = timed(lambda: accel.build_bvh(host.solids))[1]
    for name, other in (("host build", cs_host.bvh),
                        ("device build on the CPU", cpu_bvh)):
        for f in ("node_min", "node_max", "lp_kind", "lp_idx"):
            a = getattr(cs_dev.bvh, f)
            b = torch.as_tensor(getattr(other, f)).to(a.device)
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"device-built bvh.{f} differs from "
                                     f"the {name}")
    for k in ("nodes", "prims", "node_min", "node_max"):
        if not torch.equal(getattr(cs_dev.kbvh, k), getattr(cs_host.kbvh, k)):
            raise AssertionError(f"kbvh.{k} differs between the routes")

    wrappers = all_wrappers()
    reset_launches(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    image = _final_image(scene, "cuda")
    t_render = time.perf_counter() - t0
    launches = launch_counts(wrappers)
    _check_image("obj_scene", image, h, w)
    if launches["K1"] <= 0 or launches["K4"] or launches["K5"]:
        raise AssertionError(f"the loaded mesh did not take K1 alone: "
                             f"{launches}")
    segments = _segments(cs_dev, w, h)
    log("obj_ingest", gpu=smi, triangles=n_tris, obj_bytes=obj_bytes,
        write_seconds=t_write, native_build_seconds=t_native_build,
        parse_native_seconds=t_native, parse_plain_seconds=t_plain,
        load_seconds=t_load, compile_device_bvh_seconds=compiles["device"],
        compile_host_bvh_seconds=compiles[True],
        build_bvh_device_ms=sorted(build_ms)[1],
        build_bvh_device_ms_all=build_ms,
        build_bvh_device_cpu_seconds=t_build_cpu,
        build_bvh_host_seconds=t_build_host,
        bvh_nodes=int(cs_dev.bvh.node_min.shape[0]),
        bvh_slots=int(cs_dev.bvh.lp_kind.shape[0]),
        ray_trace_seconds=t_render, mean_u8=float(image.mean()),
        launches=launches, k1_launches=launches["K1"],
        segments_device_bvh_scene=segments,
        seconds=time.perf_counter() - start)
    return launches


def phase_bench():
    """The port's throughput script at full size (``bench.run``: bench.py's
    five workloads, five timed batches each; its lines are printed as they
    end) with each workload's route and launches held to what its scene
    must take: the production and many-light interiors K1, K2, S1 and S2,
    never K5 or the draw kernel; the textured sponza K1, S1 and S2, never
    K5 or the draw kernel; the kitchen and the megakernel workload one K5
    launch a batch and no other hit or step kernel. Then the three
    new scenes at a small size (24 terrain cells, 64-texel textures,
    64x48, 1 spp, path shader) on the card against the CPU and repeated
    bit for bit. Returns the hit kernels' launches in the bench's run."""
    import solstrale_tpu_torch as T
    from solstrale_tpu_torch import bench, fixtures
    from solstrale_tpu_torch.renderer import integrator

    start = time.perf_counter()
    wrappers = all_wrappers()
    reset_launches(wrappers)
    lines = bench.run(bench.WORKLOADS, "cuda", runs=5)
    launches = launch_counts(wrappers)
    failed = [ln for ln in lines if "error" in ln]
    if failed:
        raise AssertionError(f"bench: {failed}")
    by_name = {w.name: ln for w, ln in zip(bench.WORKLOADS, lines)}
    for name, route, must, never in (
            ("sponza_production", "wavefront", ("K1", "K2", "S1", "S2"),
             ("K5", "draw")),
            ("many_lights", "wavefront", ("K1", "K2", "S1", "S2"),
             ("K5", "draw")),
            ("sponza", "wavefront", ("K1", "S1", "S2"), ("K5", "draw")),
            ("kitchen_sink", "k5", ("K5",),
             ("K1", "K2", "K3", "K4", "S1", "S2")),
            ("megakernel", "k5", ("K5",),
             ("K1", "K2", "K3", "K4", "S1", "S2"))):
        ln = by_name[name]
        if ln["route"] != route or any(ln["launches"][k] <= 0 for k in must) \
                or any(ln["launches"][k] for k in never):
            raise AssertionError(f"bench {name}: route {ln['route']}, "
                                 f"launches {ln['launches']}")
        if route == "k5" and ln["launches"]["K5"] != 1:
            raise AssertionError(f"bench {name}: {ln['launches']['K5']} K5 "
                                 "launches in one batch")
    log("bench", seconds=time.perf_counter() - start, launches=launches)

    w, h = 64, 48
    path = (("path", integrator.SHADER_PATH, False),)
    for name, build in (
            ("sponza_textured_scene", lambda c: fixtures.sponza_textured_scene(
                c, n_cells=24, tex_size=64)),
            ("sponza_production_scene",
             lambda c: fixtures.sponza_production_scene(
                 c, n_cells=24, tex_size=64)),
            ("many_light_scene", lambda c: fixtures.many_light_scene(
                c, n_cells=24))):
        _card_vs_cpu(name, build(T.RenderConfig(width=w, height=h, seed=1)),
                     path, w, h, 1, start)
    return launches


def phase_four_card():
    """8: the four-card check (``parallel.four_card.run``) where four cards
    are visible; otherwise one line: the phase did not run, and the cards
    seen."""
    import torch

    n = torch.cuda.device_count()
    if n < 4:
        log("four_card", ran=False, cards_visible=n,
            reason="the four-card check needs 4 cards")
        return
    from solstrale_tpu_torch.parallel import four_card

    t0 = time.perf_counter()
    lines = four_card.run("cuda")
    log("four_card", ran=True, cards_visible=n,
        checks=sum("ok" in x for x in lines),
        seconds=time.perf_counter() - t0)


def _segments(cs, w, h):
    """Segments of one 1 spp, depth-50 render_sample_batch of ``cs``."""
    from solstrale_tpu_torch.renderer import integrator

    return int(integrator.render_sample_batch(
        cs, 1, 1, width=w, height=h, max_depth=50,
        shader_kind=integrator.SHADER_PATH, need_aux=False, n_samples=1)[3])


def main():
    import torch

    smi = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import solstrale_tpu_torch as T
    from solstrale_tpu_torch import fixtures
    from solstrale_tpu_torch.scene.compile import compile_scene

    phase_build()
    t0 = time.perf_counter()
    sponza_cs = compile_scene(fixtures.sponza_class_scene(
        T.RenderConfig(width=1920, height=1080, samples_per_pixel=1, seed=1)),
        device="cuda")
    log("compile_scene", seconds=time.perf_counter() - t0,
        triangles=int(sponza_cs.solids.tr_valid.sum().item()),
        leaves=sponza_cs.kbvh.n_leaves)
    timings = phase_kernels(sponza_cs)
    timings["draw"] = phase_draws()
    timings.update(phase_step(sponza_cs))
    timings.update(phase_first_hit(sponza_cs))
    timings.update(phase_first_hit_grad(sponza_cs))
    route_launches = phase_first_hit_route(sponza_cs)
    launches = phase_main_path()
    for k, n in route_launches.items():
        launches[k] += n
    for k, n in phase_small_scene().items():
        launches[k] += n
    phase_graphs(sponza_cs)
    timings["K5"] = phase_megakernel()
    for k, n in phase_surface(sponza_cs, smi).items():
        launches[k] += n
    phase_card_vs_cpu()
    # S1B's main path is the inverse step (its two graphed cells), and it
    # is on CR's too (the camera rays of each step)
    diff_launches = phase_diff_parallel(sponza_cs, smi)
    for k in ("S1B", "CR"):
        launches[k] += diff_launches[k]
    for phase in (lambda: phase_obj_ingest(smi), phase_bench):
        for k, n in phase().items():
            launches[k] += n
    phase_four_card()

    source = {"K1": ("solstrale_tpu_torch/csrc/bvh.cu",
                     "solstrale_tpu/ops/pallas_bvh.py:104"),
              "K2": ("solstrale_tpu_torch/csrc/sweep.cu",
                     "solstrale_tpu/ops/pallas_sweep.py:55"),
              "K3": ("solstrale_tpu_torch/csrc/sweep.cu",
                     "solstrale_tpu/ops/pallas_sweep.py:220"),
              "K4": ("solstrale_tpu_torch/csrc/sweep.cu",
                     "solstrale_tpu/ops/pallas_sweep.py:356"),
              "K5": ("solstrale_tpu_torch/csrc/megakernel.cu",
                     "solstrale_tpu/renderer/megakernel.py:228"),
              "draw": ("solstrale_tpu_torch/csrc/rng.cu",
                       "solstrale_tpu/ops/rng.py:68"),
              "S1": ("solstrale_tpu_torch/csrc/step.cu",
                     "solstrale_tpu/renderer/integrator.py:765"),
              "S2": ("solstrale_tpu_torch/csrc/step.cu",
                     "solstrale_tpu/renderer/integrator.py:808"),
              "S1B": ("solstrale_tpu_torch/csrc/step.cu",
                      "solstrale_tpu/renderer/integrator.py:364"),
              "CR": ("solstrale_tpu_torch/csrc/first_hit.cu",
                     "solstrale_tpu/renderer/integrator.py:401"),
              "FH": ("solstrale_tpu_torch/csrc/first_hit.cu",
                     "solstrale_tpu/renderer/integrator.py:515"),
              "CRB": ("solstrale_tpu_torch/csrc/first_hit.cu",
                      "solstrale_tpu/renderer/integrator.py:401"),
              "FHB": ("solstrale_tpu_torch/csrc/first_hit.cu",
                      "solstrale_tpu/renderer/integrator.py:515")}
    names = {"K1": "k1_bvh", "K2": "k2_bvh_spheres", "K3": "k3_media",
             "K4": "k4_scene_hit", "K5": "k5_render",
             "draw": "rng_uniform4", "S1": "step_shade", "S2": "step_regen",
             "S1B": "step_shade_backward", "CR": "camera_rays",
             "FH": "first_hit_shade", "CRB": "camera_rays_backward",
             "FHB": "first_hit_backward"}
    # no single PyTorch call computes any of these functions (the draw
    # kernel's counter hash included: torch has no PCG4D; nor the step's
    # shading or regeneration, nor their reverse, nor the camera rays' and
    # the first hit's draws and lookups, nor their reverse)
    # every kernel of the path ran in this run (the draw kernel is on no
    # route since CR and FH draw in registers: its 0 is the check)
    idle = [k for k in names if k != "draw" and launches[k] <= 0]
    if idle or launches["draw"]:
        raise AssertionError(f"kernels never launched on the path: {idle}; "
                             f"draw kernel launches {launches['draw']}")
    kernels = [dict(name=names[k], route="cuda", source=source[k][0],
                    replaces=source[k][1], launches=launches[k],
                    library_ms=None, **timings[k]) for k in names]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
