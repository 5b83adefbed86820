"""The wavefront route and the inverse step on the card, measured on two
trees in turns, or over the card driver's steps per replay.

    python -m solstrale_tpu_torch.wavefront_ab --parent DIR [--workloads A,B]
    python -m solstrale_tpu_torch.wavefront_ab --steps 1,2,4,8

The workloads: the bench's three wavefront workloads at its settings
(``sponza_production`` 1080p, ``many_lights`` 960x540, ``sponza``, the
headline, 1080p; 1 spp), the normal-mapped kitchen, which K5's gate
refuses (the wavefront with K4), at the bench kitchen's 400x266, 8 spp,
and the bench's two K5 workloads (``kitchen_sink``, ``megakernel``: one
K5 launch a batch through ``render_sample_batch``, no steps), the
controls of a change to the wavefront.
Depth 50, seed 1. Per workload: one warm-up batch at ``sample_start`` 100
(the kernels' build and, on a tree with the card driver, its graph
capture), then ``RUNS`` batches at ``sample_start`` 1, each ending in a
synchronise (the Mrays/s median and every run), the steps a batch ran
(``iterations``), its stop-test reads (``host_reads``: the driver's own
count, or on a tree without one its loop's, one read a step plus one a
pool), the kernels' launches a batch by their wrappers' counts, and one
more batch under ``torch.profiler``: its device kernels (and memory ops)
a step, its device busy time, its idle share of the profiled wall time
and of the unprofiled median batch, the launches of K1 the profiler saw
beside the wrapper's count, and on a batch of few ops (K5's route) each
op's name.

The inverse step's cells (``step_kitchen``: the normal-mapped kitchen at
400x266, K4; ``step_kitchen_tex1024``: the same with its ground's albedo
the 1024x1024 stand-in texture, an arena of ~12.6 MB, the size users
optimise; ``step_mixed``: the mixed BVH scene at 1920x1080, K1-K3;
depth 50, 1 spp, against a target at seed 2): ``diff.image_and_texture_grad``
called once (on a tree with the graphed step, the capture), then ``RUNS``
steps by CUDA events (the median and every run), the peak bytes of the
first call and of a step, the allocator's reserved bytes after them and
the graph pool's resident bytes (null without a graph), the kernels'
launches a step (S1 and its backward S1B among them, on a tree that has
S1B), the host reads of a step (null on a tree without
``profiling.HostReads``), the loss and the gradient's absolute sum, and
one step under ``torch.profiler`` (device ops, busy ms, idle; the fills
and adds among the ops, the most frequent op names, and S1B's device
microseconds by bounce, 0 to ``DEPTH``: the backward runs the bounces
last to first), and the step taken by hand twice (``step_by_hand``: the
ops it dispatches that are not views and its kernel launches, forward and
backward, the same in every run).

The step kernels' cells (``kernels_<scene>``, ``KERNEL_SCENES``: the
262,088-triangle interior at 1920x1080, the bench's textured sponza,
sponza_production and many_lights at their bench sizes, the mixed BVH
scene at 1920x1080 and the normal-mapped kitchen, K4, at 400x266x8):
S1 (``ops.step.step_shade``), S2 (``ops.step.step_regen`` with the
scan of the terminal flags it needs) and S1B (``ops.step.step_shade_backward``)
on one pool at each of ``KERNEL_WIDTHS`` lanes (the tail pool's 16,384,
the 106,400 of a 400x266 inverse step, the wide pool's 131,072 and the
2,073,600 of a 1080p ``render_pixels``, the inverse step's), set up by
``step_kernel_calls`` and ``s1b_calls``; device ms by ``device_ms``, S2's
less the put-back of the queue head that makes it repeat, the pool's
terminal lanes; S1B as the inverse step calls it (its wrapper, adding
into a sums buffer made once, so the device runs the kernel alone) with
its bound (``s1b_work``), without the arena's and background's sums (the
fold's gradients alone), on the same record with every lane reading
texel row 0 (a solid colour), and how its arena adds meet
(``s1b_rows``); the first hit's kernels, FH and CR, at the whole-image
widths of ``FIRST_IMAGES`` (106,400 lanes of a 400x266 image, 2,073,600 of
a 1920x1080 one: every pixel id once, an int sample, the scene's camera),
set up and timed by ``first_hit_times``: CR, FH with the aux planes and
FH with each debug shader alone, each by ``device_ms`` beside its bound
(``cr_work``, ``fh_work``); and ptxas' lines for the step kernels, FH and
CR. The first hit's kernel cells (``first_hit_<scene>``, the same scenes)
run FH's and CR's part alone, with their ptxas lines.

The first hit's cells (``aux_interior``: the untextured interior at
1920x1080, the main path's denoised render, K1; ``aux_kitchen``: the
normal-mapped kitchen at 1920x1080, K4; seed 1, sample 1): the camera rays
of all 2,073,600 pixels (``integrator.camera_rays``), the scene hit at
depth 0 on them alone (``integrator.scene_hit`` and, where the tree has
it, ``step_hit``, the hit the first-hit kernel FH takes),
``integrator.first_hit_aux`` on them (the hit and the planes), one sample
of each debug shader through ``render_sample_batch``, and the 1 spp,
depth-50 path batch with and without the aux planes: each by CUDA events
(the median and every run of ``RUNS``, after one warm-up call) with its
kernels' launches a call; the camera rays and the hits also by
``device_ms``, and ``first_hit_aux`` by its device ops and busy time
under ``torch.profiler``.

``--parent DIR`` runs the tree at DIR (a checkout of the parent commit,
unpacked where ``.gitignore`` keeps it out of the repo), this tree, this
tree and DIR again, each in a process of its own that imports that tree's
package. ``--steps`` runs this tree alone, with ``integrator.GRAPH_STEPS``
set to each value in turn and then in the reverse order (each value
recaptures its graphs; the step cells run once a process).
``--workloads`` picks some of them (default: all). Prints one JSON line
per tree (or steps value) and workload, the card's name and power limit
in each, and writes them to ``chiprun_out/wavefront_ab.jsonl``. Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import math
from collections import Counter
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUNS = 5
# a profiled batch of at most this many device ops lists them by name
NAMED_OPS = 64
SEED = 1
DEPTH = 50
# the step kernels' cells: each one's scene, as the workload of that name
# builds it ("interior": the untextured 262,088-triangle sponza-class
# scene at 1920x1080), and their widths
KERNEL_SCENES = {"sponza": "interior", "sponza_textured": "sponza",
                 "sponza_production": "sponza_production",
                 "many_lights": "many_lights", "mixed": "step_mixed",
                 "kitchen": "kitchen_k4"}
KERNEL_WIDTHS = (16384, 106400, 131072, 2073600)
# the first hit's images in the step kernels' and the first hit's kernel
# cells (first_hit_times), and its kernels' entry names
FIRST_IMAGES = ((400, 266), (1920, 1080))
FIRST_KERNELS = ("first_hit_shade", "camera_rays")
# the first hit's cells: each one's scene, as the workload of that name
# builds it, at 1920x1080
AUX = {"aux_interior": "interior", "aux_kitchen": "kitchen_1080p"}
WORKLOADS = ("sponza_production", "many_lights", "sponza", "kitchen_k4",
             "kitchen_sink", "megakernel", "step_kitchen",
             "step_kitchen_tex1024", "step_mixed",
             *(f"kernels_{x}" for x in KERNEL_SCENES),
             *(f"first_hit_{x}" for x in KERNEL_SCENES), *AUX)
# the inverse step's cells: (width, height) of each
STEPS = {"step_kitchen": (400, 266), "step_kitchen_tex1024": (400, 266),
         "step_mixed": (1920, 1080)}
# published peaks of one H100 SXM, the bounds' (``bound_ms``; chip_smoke.py
# takes its bounds from it too): f32 FLOP/s outside the tensor cores, and
# device memory bytes/s
PEAK_F32 = 67e12
HBM_BPS = 3.35e12
# S1B's f32 operations a lane (csrc/step.cu::step_shade_backward): per
# channel the terminal color's reverse 7 (A t_c, the upstream times att,
# the minimum's halving, gx A, gx t_c, the two sums into g_B and g_bg's
# share), the fold's 10 (3A, the minimum's halving, go 3, g_p A, that
# times m, albedo m, g_p times it, g_A's three sums less one, g_B's sum),
# and the albedo gradient's sum 1; the background's sum 3 a lane
S1B_LANE = 3 * 18 + 3
# FH's f32 operations (csrc/first_hit.cu::first_lane): a hit lane's point
# and attributes 24 (chip_smoke.py's K5_HIT: the same device code), a blend
# walk 3 (K5_BLEND), a normal map's tangent-space normal 6 and its frame 15,
# the simple shader's factor 5 and product 3; CR's camera ray a lane 46
# (chip_smoke.py's S2_REGEN, the same camera_ray)
FH_HIT = 24
FH_BLEND = 3
FH_NORMAL_MAP = 21
FH_SIMPLE = 8
CR_LANE = 46
# FHB's f32 operations beyond FH's (csrc/first_hit.cu::first_back_lane):
# a hit lane's plane gradients summed 6; a mapped normal's reverse 27 (the
# frame's 9 products, the map texel's three dot products and doublings); the
# simple shader's factor 7, the texel's share 6, the normal's 9; a sphere
# frame's reverse 88 (the two unit vectors recomputed 17, the cross
# products' reverses 21, the unit vectors' reverses 45, the ray's 3, the
# center's 2). CRB's a lane 61: u, v and the disc point 12 (the draws'
# integer hash not counted), the six products' sums 45, lens_radius's 4
FHB_LANE = 6
FHB_NORMAL_MAP = 27
FHB_SIMPLE = 22
FHB_SPHERE = 88
CRB_LANE = 61
HERE = Path(__file__).resolve().parent.parent


def _workload(name):
    """(scene, width, height, spp) of a workload of this module."""
    import solstrale_tpu_torch as T
    from solstrale_tpu_torch import bench, fixtures

    for cell in ("kernels_", "first_hit_"):
        if name.startswith(cell):
            name = KERNEL_SCENES[name.removeprefix(cell)]
    name = AUX.get(name, name)
    if name == "kitchen_k4":
        w, h, spp, build = 400, 266, 8, fixtures.kitchen_sink_scene
    elif name == "kitchen_1080p":
        w, h, spp, build = 1920, 1080, 1, fixtures.kitchen_sink_scene
    elif name == "interior":
        w, h, spp, build = 1920, 1080, 1, fixtures.sponza_class_scene
    elif name in STEPS:
        (w, h), spp = STEPS[name], 1
        build = {"step_kitchen": fixtures.kitchen_sink_scene,
                 "step_kitchen_tex1024": lambda c: fixtures.kitchen_sink_scene(
                     c, tex_size=1024),
                 "step_mixed": lambda c: fixtures.mixed_bvh_scene(
                     c, n_cells=362)}[name]
    else:
        wl = next(x for x in bench.WORKLOADS if x.name == name)
        w, h, spp, build = wl.width, wl.height, wl.spp, wl.scene
    return build(T.RenderConfig(width=w, height=h, samples_per_pixel=spp,
                                samples_per_batch=spp, seed=SEED)), w, h, spp


def _wrappers():
    from solstrale_tpu_torch import bench

    fn = getattr(bench, "kernel_wrappers", None) or bench.hit_kernels
    return fn()


def _host_reads(stats):
    if "host_reads" in stats:
        return stats["host_reads"], "driver"
    # the eager loop of a tree without the count: a read before every step
    # and one that ends each pool
    pools = 2 if stats["tail_lanes"] else 1
    return stats["iters"] + pools, "loop"


# the names of torch's fill and add kernels (and of the copy engine's
# memsets) among a profiled step's device ops
FILL_OPS = ("FillFunctor", "Memset")
ADD_OPS = ("CUDAFunctor_add", "CUDAFunctorOnSelf_add")
# the most frequent device op names a profiled step lists
TOP_OPS = 12


def _profiled(batch, step_ops=False):
    """One batch under torch.profiler: device ops, busy ms, wall ms, the
    K1 kernels seen and, for a batch of at most ``NAMED_OPS`` device ops
    (K5's route), each op's name with its count. With ``step_ops`` (an
    inverse step) also the fills and adds among the ops, the ``TOP_OPS``
    most frequent names, and S1B's device microseconds in bounce order
    (its launches run last bounce first)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in ops) / 1e3
    out = dict(device_ops=len(ops), device_busy_ms=busy_ms,
               profiled_wall_ms=wall_ms,
               device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
               k1_seen=sum("k1_bvh" in e.name for e in ops),
               device_op_names=(dict(Counter(e.name[:80] for e in ops))
                                if len(ops) <= NAMED_OPS else None))
    if step_ops:
        from solstrale_tpu_torch.profiling import _is_kernel

        s1b = sorted((e for e in ops
                      if _is_kernel("step_shade_backward", e.name)),
                     key=lambda e: e.time_range.start)
        out.update(
            fills=sum(any(k in e.name for k in FILL_OPS) for e in ops),
            adds=sum(any(k in e.name for k in ADD_OPS) for e in ops),
            top_ops=Counter(e.name[:100] for e in ops).most_common(TOP_OPS),
            s1b_us_by_bounce=[e.time_range.elapsed_us() for e in s1b][::-1])
    return out


def measure(cs, w, h, spp, profile=True):
    """The line of one workload on a compiled scene (see the module
    docstring)."""
    import torch
    from solstrale_tpu_torch.renderer import integrator

    kw = dict(width=w, height=h, max_depth=DEPTH,
              shader_kind=integrator.SHADER_PATH, need_aux=False,
              n_samples=spp)
    wrappers = _wrappers()

    def batch(stats=None):
        color, _, _, segs = integrator.render_sample_batch(
            cs, 1, SEED, stats=stats, **kw)
        return color, segs

    float(integrator.render_sample_batch(cs, 100, SEED, **kw)[0].sum())
    seconds, seen = [], set()
    for _ in range(RUNS):
        stats = {}
        before = {k: fn.launches for k, fn in wrappers.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        color, segs = batch(stats)
        checksum = float(color.sum())
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if not checksum > 0:
            raise RuntimeError(f"degenerate render: checksum={checksum}")
        launches = {k: fn.launches - before[k] for k, fn in wrappers.items()}
        # K5's route fills no stats: no steps, no stop-test reads
        seen.add((int(segs), stats.get("iters"),
                  _host_reads(stats) if stats else (None, "k5"),
                  tuple(launches.values())))
    if len(seen) != 1:
        raise RuntimeError(f"the batches did not repeat: {sorted(seen)}")
    segments, iters, (reads, reads_from), _ = seen.pop()
    median = statistics.median(seconds)
    line = dict(mrays_per_s=segments / median / 1e6, runs_s=seconds,
                segments=segments, iterations=iters, host_reads=reads,
                host_reads_from=reads_from,
                ms_per_iteration=median * 1e3 / iters if iters else None,
                launches=launches, replays=stats.get("replays"))
    if profile:
        before = wrappers["K1"].launches
        prof = _profiled(batch)
        prof["k1_counted"] = wrappers["K1"].launches - before
        prof["device_ops_per_iteration"] = (prof["device_ops"] / iters
                                            if iters else None)
        # the profiler slows the host: the share against the unprofiled
        # median batch of the same workload
        prof["device_idle_share_of_median"] = max(
            0.0, 1.0 - prof["device_busy_ms"] / (median * 1e3))
        line.update(prof)
    return line


def dispatched_ops_mode():
    """A ``TorchDispatchMode`` that counts in ``n`` the ops dispatched that
    are not views (a view or an alias, ``OpOverload.is_view``, launches
    nothing on the card). With the hand-written kernels' launches (their
    wrappers' counts: no op dispatches them) it is a count of a step's
    device work that is the same in every run, which a profiler trace's
    count is not (a trace can lose events). Ops inside a CUDA graph replay
    are not dispatched. Defined here, not in the package, so that it
    counts on any tree this file runs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class DispatchedOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += not func.is_view
            return func(*args, **(kwargs or {}))

    return DispatchedOps()


def step_by_hand(cs, target, w, h, wrappers, seed=SEED):
    """One inverse step taken by hand (``diff.render_linear`` with the arena
    requiring grad, the mean squared error against ``target``, then
    ``torch.autograd.grad`` to the arena), op by op on any tree: the
    forward's and the backward's (ops dispatched that are not views,
    kernel launches) by ``dispatched_ops_mode`` and the wrappers' counts,
    and the loss and the gradient."""
    import torch
    from solstrale_tpu_torch import diff

    p = cs.textures.pixels.detach().requires_grad_(True)
    work = {}
    before = {k: f.launches for k, f in wrappers.items()}
    with dispatched_ops_mode() as fwd:
        img = diff.render_linear(diff.set_texture_params(cs, p), width=w,
                                 height=h, max_depth=DEPTH, n_samples=1,
                                 seed=seed)
        loss = torch.mean((img - target) ** 2)
    mid = {k: f.launches for k, f in wrappers.items()}
    with dispatched_ops_mode() as bwd:
        g, = torch.autograd.grad(loss, p)
    after = {k: f.launches for k, f in wrappers.items()}
    work["forward"] = (fwd.n, sum(mid[k] - before[k] for k in wrappers))
    work["backward"] = (bwd.n, sum(after[k] - mid[k] for k in wrappers))
    return work, loss.detach(), g


def measure_step(cs, w, h):
    """The line of an inverse-step cell: ``diff.image_and_texture_grad``
    against a target at seed 2 (on a tree with the graphed step, its first
    call captures), then ``RUNS`` calls timed by CUDA events, each's peak
    bytes above its start, the kernels' launches a call, the host reads of
    one call, one call under ``torch.profiler``, and the step taken by
    hand twice (``step_by_hand``: its dispatched ops and launches, forward
    and backward, each time)."""
    import torch
    from solstrale_tpu_torch import diff, profiling

    kw = dict(width=w, height=h, max_depth=DEPTH, n_samples=1)
    with torch.no_grad():
        target = diff.render_linear(cs, seed=2, **kw)
    wrappers = _wrappers()

    def step():
        return diff.image_and_texture_grad(cs, target, seed=SEED, **kw)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first_peak = torch.cuda.max_memory_allocated() - base
    ms, peaks, seen = [], [], set()
    for _ in range(RUNS):
        before = {k: fn.launches for k, fn in wrappers.items()}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loss, g = step()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
        peaks.append(torch.cuda.max_memory_allocated() - base)
        seen.add(tuple(fn.launches - before[k]
                       for k, fn in wrappers.items()))
        if not (float(loss) > 0 and bool(torch.isfinite(g).all())):
            raise RuntimeError(f"degenerate step: loss {float(loss)}")
    if len(seen) != 1:
        raise RuntimeError(f"the steps did not repeat: {sorted(seen)}")
    reads = None
    if hasattr(profiling, "HostReads"):
        with profiling.HostReads() as counter:
            step()
        reads = counter.n
    prof = _profiled(step, step_ops=True)
    graph = diff.grad_step(cs, target, seed=SEED, **kw).graph
    pool = None
    if graph is not None:
        pid = tuple(graph.pool())
        pool = sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id") or ()) == pid)
    return dict(step_ms=statistics.median(ms), runs_ms=ms,
                first_call_s=first_s, first_call_peak_bytes=first_peak,
                step_peak_bytes=max(peaks),
                reserved_bytes=torch.cuda.memory_reserved(),
                pool_bytes=pool,
                launches=dict(zip(wrappers, seen.pop())), host_reads=reads,
                loss=float(loss), grad_abs_sum=float(g.double().abs().sum()),
                step_by_hand=[step_by_hand(cs, target, w, h, wrappers)[0]
                              for _ in range(2)],
                **prof)


def _timed(fn, wrappers):
    """fn() timed by CUDA events after one warm-up call: the median ms and
    every run of ``RUNS``, and the kernels' launches of one call."""
    import torch

    fn()
    ms = []
    for _ in range(RUNS):
        before = {k: f.launches for k, f in wrappers.items()}
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    return dict(ms=statistics.median(ms), runs_ms=ms,
                launches={k: f.launches - before[k]
                          for k, f in wrappers.items()})


def measure_aux(cs, w, h):
    """The line of a first hit's cell (see the module docstring)."""
    import torch
    from solstrale_tpu_torch.renderer import integrator

    wrappers = _wrappers()
    pix = torch.arange(w * h, dtype=torch.int64, device="cuda")
    _, o, d = integrator.camera_rays(cs, pix, w, h, 1, SEED)
    sample = torch.ones_like(pix)
    bounce = torch.zeros(pix.shape, dtype=torch.int32, device="cuda")
    calls = {
        "camera_rays": lambda: integrator.camera_rays(cs, pix, w, h, 1,
                                                      SEED),
        "scene_hit": lambda: integrator.scene_hit(cs, o, d, pix, sample,
                                                  bounce, SEED),
        "step_hit": lambda: integrator.step_hit(cs, o, d, pix, sample,
                                                bounce, SEED),
        "first_hit_aux": lambda: integrator.first_hit_aux(cs, o, d, pix, 1,
                                                          SEED)}
    out = {}
    with torch.no_grad():
        for name, fn in calls.items():
            out[name] = _timed(fn, wrappers)
            # device_ms queues 20 calls behind one sleep, which a tree that
            # runs first_hit_aux as a chain of torch ops does not keep up
            # with
            if name != "first_hit_aux":
                out[name]["device_ms"] = device_ms(fn)
        prof = _profiled(calls["first_hit_aux"])
        out["first_hit_aux"].update(device_ops=prof["device_ops"],
                                    device_busy_ms=prof["device_busy_ms"])
        for shader in ("albedo", "normal", "simple"):
            kind = getattr(integrator, f"SHADER_{shader.upper()}")
            out[f"{shader}_sample"] = _timed(
                lambda k=kind: integrator.render_sample_batch(
                    cs, 1, SEED, width=w, height=h, max_depth=DEPTH,
                    shader_kind=k, need_aux=False, n_samples=1), wrappers)
        for aux in (False, True):
            out[f"batch_need_aux={aux}"] = _timed(
                lambda a=aux: float(integrator.render_sample_batch(
                    cs, 1, SEED, width=w, height=h, max_depth=DEPTH,
                    shader_kind=integrator.SHADER_PATH, need_aux=a,
                    n_samples=1)[0].sum()), wrappers)
    return out


def device_ms(fn, n=20, reps=3):
    """Milliseconds of device time per fn(): ``n`` calls queued behind a
    ``torch.cuda._sleep`` that outlasts their enqueue, CUDA events around
    the calls; median of ``reps``."""
    import torch

    fn()
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def step_kernel_calls(cs, w, h, spp, lanes, depth=DEPTH):
    """The wavefront step's kernels as calls that repeat, on one pool: a
    ``_Wavefront`` of ``lanes`` lanes (its samples raised so that the queue
    holds three pools) after ``reset_plain`` and two plain steps, and the
    hit of its next step. ``s1``: S1 in ``path_step``'s form (new
    outputs) on a copy of the pool's state. S1 then runs once in place on
    the pool; ``s2``: S2 on its flags, the queue head put back first
    (``restore``, which the caller times alone and subtracts). Returns a
    dict: ``wf``, ``pool``, ``hit`` (t, kind, idx as S1 takes them),
    ``o``, ``d`` and ``args`` (the copies ``s1`` reads; args: its inputs
    after o and d), ``shaded`` (the outputs of one ``s1``), ``terminal``
    (the flags S2 reads), ``s1``, ``s2``, ``restore``."""
    from solstrale_tpu_torch.ops import step
    from solstrale_tpu_torch.renderer import integrator

    spp = max(spp, math.ceil(3 * lanes / (w * h)))
    wf = integrator._Wavefront(cs.device, w, h, depth, spp, 1, lanes, None,
                               None)
    wf.begin(1, None)
    pool = wf.pools[0]
    wf.reset_plain(cs, pool)
    for _ in range(2):
        wf.step_plain(cs, pool)
    hit = integrator.step_hit(cs, pool.o, pool.d, pool.pixel, pool.sample,
                              pool.bounce, 1)
    o, d, args = _copied((pool.o, pool.d, (
        pool.bounce, pool.acc_len, pool.fold, pool.pixel, pool.sample, 1,
        pool.qpos < wf.total_q, depth)))

    def s1():
        return step.step_shade(cs, *hit, o, d, *args)

    shaded = s1()
    step.step_shade(cs, *hit, pool.o, pool.d, pool.bounce, pool.acc_len,
                    pool.fold, pool.pixel, pool.sample, 1,
                    (pool.qpos, wf.total_q), depth, out=pool.shade_out())
    term = pool.terminal.clone()
    head = wf.next_q.clone()

    def restore():
        wf.next_q.copy_(head)

    def s2():
        restore()
        step.step_regen(cs, wf, pool, term)

    return dict(wf=wf, pool=pool, hit=hit, o=o, d=d, args=args,
                shaded=shaded, terminal=term, s1=s1, s2=s2, restore=restore)


def _copied(x):
    """A copy of the tensors in nested tuples ``x``, the rest as it is."""
    if isinstance(x, tuple):
        return tuple(_copied(v) for v in x)
    return x.clone() if hasattr(x, "clone") else x


def s1b_calls(cs, pool, active, depth=DEPTH, seed=5, one_row=None):
    """S1B as a call that repeats, on the next bounce of ``pool``'s lanes:
    S1's record of it (``shade_with_record``; with ``one_row``, every
    lane's texel row replaced by that row, as if the whole arena were one
    solid colour), the pool's fold, and upstream gradients from ``seed``
    as the fixed trip gives them (the color's on the lanes that end, 0 on
    the rest, whose color ``torch.where`` drops; the fold's on every
    lane). ``launch(sums=True)``: ``ops.step.step_shade_backward`` as the
    inverse step calls it, adding into one sums buffer made here (a step
    zeroes its pass's once), so that the card runs S1B's kernel alone;
    with ``sums`` False, without the arena's and the background's
    gradients (the fold's alone). Returns a dict: ``rec``, ``ab``,
    ``g_color``, ``g_out`` and ``launch``."""
    import torch
    from solstrale_tpu_torch.ops import step
    from solstrale_tpu_torch.renderer import integrator

    hit = integrator.step_hit(cs, pool.o, pool.d, pool.pixel, pool.sample,
                              pool.bounce, 1)
    _, rec = step.shade_with_record(cs, *hit, pool.o, pool.d, pool.bounce,
                                    pool.acc_len, pool.fold, pool.pixel,
                                    pool.sample, 1, active, depth)
    if one_row is not None:
        rec[0] = one_row
    r, dev = rec.shape[1], rec.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    end = (rec[3] & step.REC_TERMINAL) != 0
    g_color = torch.where(end[:, None], torch.randn(
        (r, 3), generator=gen, device=dev), 0.0)
    g_out = [torch.randn((r,), generator=gen, device=dev) for _ in range(6)]
    ab = tuple(x.clone() for x in (*pool.fold[0], *pool.fold[1]))
    arena, bg = cs.textures.pixels, cs.bg_color
    buf = torch.zeros((arena.shape[0] + 1, 3), dtype=torch.float32,
                      device=dev)

    def launch(sums=True):
        return step.step_shade_backward(rec, ab, arena, bg, g_color, g_out,
                                        buf if sums else None, sums, sums)

    return dict(rec=rec, ab=ab, g_color=g_color, g_out=g_out, launch=launch)


def s1b_through(rec, g_color):
    """(R, 3) bool: the lane channels whose fold gradients S1B passes
    through without reading the fold (csrc/step.cu): a lane whose record
    sets no branch flag, reads no texel and has a zero pdf weight, on a
    channel whose color gradient times the attenuation (0 where the channel
    was dead at the terminal color) is 0."""
    import torch
    from solstrale_tpu_torch.ops import step

    word = rec[3]
    att = rec[2].view(torch.float32)
    quiet = ((word & (step.REC_MISS | step.REC_EMIT_FRONT | step.REC_SCAT
                      | step.REC_PDF | step.REC_TERMINAL)) == 0) & \
        (rec[0] < 0) & (rec[1].view(torch.float32) == 0.0)
    return torch.stack([quiet & (torch.where(
        (word & (step.REC_DEAD_T << c)) != 0, 0.0, g_color[:, c] * att)
        == 0.0) for c in range(3)], -1)


def s1b_work(rec, g_color):
    """S1B's bytes and f32 operations on one call's record and upstream
    color gradient, counted as the function needs them: per lane the
    record (16), the color's gradient (12) and the fold's gradients out
    (24); the fold's gradients in (24) on each lane that does not end; the
    fold's A and B (8 a channel) on each channel whose gradients are not a
    pass-through of those (``s1b_through``); each distinct texel row read
    (12) and its sums read and written (24); the background (12) and its
    sums (24). Operations: ``S1B_LANE`` a lane."""
    import torch
    from solstrale_tpu_torch.ops import step

    r = rec.shape[1]
    through = int(s1b_through(rec, g_color).sum())
    going = int(((rec[3] & step.REC_TERMINAL) == 0).sum())
    rows = int(torch.unique(rec[0][rec[0] >= 0]).numel())
    return (r * (16 + 12 + 24) + 24 * going + 8 * (3 * r - through)
            + 36 * rows + 12 + 24, r * S1B_LANE)


def s1b_rows(rec):
    """How S1B's arena sums meet on one call's record: the distinct texel
    rows the lanes read, the (warp, row) pairs (a warp adds each row its
    lanes read once, so each pair is one atomic add a channel), and the
    most warps that add to one row (the adds one address takes in turn)."""
    import torch

    row = rec[0].long()
    read = row >= 0
    warp = torch.arange(row.shape[0], device=row.device)[read] // 32
    pairs = torch.unique(warp * (int(row.max()) + 1) + row[read])
    per_row = torch.bincount(pairs % (int(row.max()) + 1)) if \
        pairs.numel() else torch.zeros(1)
    return dict(rows=int(torch.unique(row[read]).numel()),
                warp_rows=int(pairs.numel()), hot_row_warps=int(per_row.max()))


def bound_ms(nbytes, flops):
    """(the least ms the card could take, "bytes" or "operations"): the
    larger of the bytes over the memory rate and the f32 operations over
    the f32 peak."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def lane_bytes(x):
    """The bytes a lane reads of a draw counter: its element where it is a
    lane array, none where it is one value."""
    import torch

    return (x.element_size() if isinstance(x, torch.Tensor) and x.numel() > 1
            else 0)


def _texel_rows(cs, o, d, hit, pix, sample, want_alb, want_n):
    """The texel rows FH and FHB read on one call's hit: (the albedo
    texels' rows of the hit lanes where ``want_alb``, else None; the
    normal map's of the lanes it applies to where ``want_n`` on a scene
    with normal maps, else None), (R',) int64 each."""
    import torch
    from solstrale_tpu_torch.ops import rng, step
    from solstrale_tpu_torch.renderer import integrator

    live = torch.isfinite(hit[0])
    _, attrs, samp, bounce = integrator._first_hit(cs, o, d, pix, sample, 1,
                                                   hit)
    mats = cs.materials
    alb = nrm = None
    if want_alb:
        eff = integrator.resolve_blend(mats, attrs["mat"], rng.uniform4(
            pix, samp, bounce, rng.P_BLEND_SCATTER, 1), cs.features)
        alb = integrator.texel_index(
            cs.textures, integrator.mat_row(mats, eff)["albedo_tex"],
            attrs["uv"])[live]
    if want_n and step.step_tables(cs).flags & step.FLAG_NORMAL_MAPS:
        eff_n = integrator.resolve_blend(mats, attrs["mat"], rng.uniform4(
            pix, samp, bounce, rng.P_BLEND_NORMAL, 1), cs.features)
        ntex = integrator.mat_row(mats, eff_n)["normal_tex"]
        on = live & (ntex >= 0)
        nrm = integrator.texel_index(cs.textures, ntex, attrs["uv"])[on]
    return alb, nrm


def _hit_rows(cs, hit):
    """The attribute rows one call's hit lanes read: (distinct planar
    slots, distinct sphere rows), each counted once."""
    import torch
    from solstrale_tpu_torch.ops import step
    from solstrale_tpu_torch.scene.compile import (KIND_MEDIUM, KIND_SPHERE,
                                                   KIND_TRIANGLE)

    tab = step.step_tables(cs)
    t, kind, idx = hit
    live = torch.isfinite(t)
    n_pl = tab.pln.shape[0]
    if kind is None:
        return int(torch.unique(idx[live].clamp(0, max(n_pl - 1, 0)))
                   .numel()), 0
    sph = live & (kind == KIND_SPHERE) & bool(tab.flags & step.FLAG_SPHERES)
    pl = live & ~sph & ~((kind == KIND_MEDIUM) & (tab.med_mat.shape[0] > 0))
    slot = torch.where(kind == KIND_TRIANGLE, tab.n_q + idx, idx)
    return (int(torch.unique(slot[pl].clamp(0, max(n_pl - 1, 0))).numel()),
            int(torch.unique(idx[sph]).numel()))


def fh_work(cs, o, d, hit, pix, sample, planes, shader=None, grain=12):
    """FH's bytes and f32 operations on one call's hit (t, kind, idx as FH
    takes them: no kind where idx is K1's planar slot), as
    ``csrc/first_hit.cu::first_lane`` loads them. Bytes: per lane t and
    each (R, 3) plane written; per hit lane idx (and kind where given), the
    ray, the pixel id (and the sample where it is a lane array); per
    distinct row the hit lanes read, the attribute rows (a planar row 112
    B, with its ``pl_row`` entry on K1's slot; a sphere row 32), the albedo
    texels where the albedo is read (the albedo plane, or a color but the
    normal shader's) and, on a scene with normal maps where a normal is
    read (the normal plane, or the normal or simple shader's color), the
    normal map's texels (12 B each; with ``grain`` 32, each distinct
    32-byte sector of the texel arena those texels lie in, 32 B: what the
    card's memory moves for them at the least); the small tables, read
    once a block, not counted. Operations: every hit lane FH_HIT, FH_BLEND
    a blend walk on a scene with blends (the albedo's, the normal map's), a
    mapped normal FH_NORMAL_MAP, the simple shader FH_SIMPLE."""
    import torch
    from solstrale_tpu_torch.ops import step
    from solstrale_tpu_torch.renderer import integrator

    tab = step.step_tables(cs)
    t, kind, _ = hit
    r = t.shape[0]
    hits = int(torch.isfinite(t).sum())
    n_pl_rows, n_sph_rows = _hit_rows(cs, hit)
    rows = n_pl_rows * (112 + (4 if kind is None else 0)) + n_sph_rows * 32
    want_alb = planes["albedo"] or shader in (integrator.SHADER_ALBEDO,
                                              integrator.SHADER_SIMPLE)
    want_n = planes["normal"] or shader in (integrator.SHADER_NORMAL,
                                            integrator.SHADER_SIMPLE)
    alb, nrm = _texel_rows(cs, o, d, hit, pix, sample, want_alb, want_n)

    def read(rows):
        return int(torch.unique(rows * 12 // grain).numel()) * grain

    texel_bytes = sum(read(x) for x in (alb, nrm) if x is not None)
    mapped = 0 if nrm is None else nrm.numel()
    n_planes = sum(bool(v) for v in planes.values()) + (shader is not None)
    lane = 4 + 12 * n_planes
    hit_lane = (4 * (1 if kind is None else 2) + 24 + pix.element_size()
                + lane_bytes(sample))
    walks = ((int(want_alb) + int(nrm is not None))
             * bool(tab.flags & step.FLAG_BLEND))
    flops = (hits * (FH_HIT + FH_BLEND * walks) + mapped * FH_NORMAL_MAP
             + (hits * FH_SIMPLE if shader == integrator.SHADER_SIMPLE
                else 0))
    return r * lane + hits * hit_lane + rows + texel_bytes, flops


def fhb_work(cs, o, d, hit, pix, sample, planes, shader=None):
    """FHB's bytes and f32 operations on one call's hit and upstream
    gradients (``planes``: which of the aux planes have one; ``shader``:
    the color's, or None), every gradient wanted (the rays', the arena's
    and the background's sums, the frame tables'), as
    ``csrc/first_hit.cu::first_back_lane`` loads them: what FH reads for
    the same planes (``fh_work``; an upstream gradient is read where FH
    writes its plane, as many bytes), the rays' gradients written (24 B a
    lane), each distinct texel row's sums read and written (24 B), each
    distinct sphere row's center sums (24 B) and planar row's frame sums
    (72 B), and the background's sums (24 B). Operations: FH's, and a
    lane's reverse: every hit lane FHB_LANE, a mapped normal
    FHB_NORMAL_MAP, the simple shader FHB_SIMPLE, a sphere hit
    FHB_SPHERE."""
    import torch
    from solstrale_tpu_torch.ops import step
    from solstrale_tpu_torch.renderer import integrator
    from solstrale_tpu_torch.scene.compile import KIND_SPHERE

    nbytes, flops = fh_work(cs, o, d, hit, pix, sample, planes, shader)
    t, kind, _ = hit
    live = torch.isfinite(t)
    want_alb = planes["albedo"] or shader in (integrator.SHADER_ALBEDO,
                                              integrator.SHADER_SIMPLE)
    want_n = planes["normal"] or shader in (integrator.SHADER_NORMAL,
                                            integrator.SHADER_SIMPLE)
    alb, nrm = _texel_rows(cs, o, d, hit, pix, sample, want_alb, want_n)
    texel_rows = torch.cat([x for x in (alb, nrm) if x is not None]
                           or [torch.zeros(0, dtype=torch.int64)])
    n_pl_rows, n_sph_rows = _hit_rows(cs, hit)
    hits = int(live.sum())
    spheres = 0
    if kind is not None and step.step_tables(cs).flags & step.FLAG_SPHERES:
        spheres = int((live & (kind == KIND_SPHERE)).sum())
    mapped = 0 if nrm is None else nrm.numel()
    nbytes += (24 * t.shape[0] + 24 * int(torch.unique(texel_rows).numel())
               + 24 * n_sph_rows + 72 * n_pl_rows + 24)
    flops += (hits * FHB_LANE + mapped * FHB_NORMAL_MAP + spheres * FHB_SPHERE
              + (hits * FHB_SIMPLE if shader == integrator.SHADER_SIMPLE
                 else 0))
    return nbytes, flops


def cr_work(cs, pix, sample):
    """CR's bytes and f32 operations: per lane the pixel id read (and the
    sample where it is a lane array) and the ray written, the camera row
    once; the camera ray (CR_LANE) a lane."""
    from solstrale_tpu_torch.ops import step

    r = pix.shape[0]
    lane = pix.element_size() + 24 + lane_bytes(sample)
    cam = step.step_tables(cs).cam
    return r * lane + cam.numel() * cam.element_size(), r * CR_LANE


def crb_work(cs, pix, sample):
    """CRB's bytes and f32 operations: per lane the pixel id (and the
    sample where it is a lane array) and the rays' six gradients read, the
    camera row once and its 19 sums read and written once a block of its
    grid (at most 1,024 blocks); CRB_LANE a lane."""
    from solstrale_tpu_torch.ops import step

    r = pix.shape[0]
    lane = pix.element_size() + 24 + lane_bytes(sample)
    cam = step.step_tables(cs).cam
    blocks = min(1024, -(-r // 256))
    return (r * lane + cam.numel() * cam.element_size() + blocks * 19 * 8,
            r * CRB_LANE)


def first_hit_times(cs):
    """FH's and CR's device ms in a step kernels' cell: at each image of
    ``FIRST_IMAGES`` (every pixel id once, sample 1, seed ``SEED``, the
    scene's camera), CR, and FH on CR's rays and their depth-0 hit
    (``integrator.step_hit``, as ``first_hit_planes`` takes it) with the
    aux planes (the denoiser's form) and with each debug shader alone, each
    beside its bound (``cr_work``, ``fh_work``) and FH's also beside the
    bound that counts each texel read as the 32-byte sectors it lies in
    (``fh_work``'s ``grain``). Keys by lane count."""
    import torch
    from solstrale_tpu_torch.ops import first_hit
    from solstrale_tpu_torch.renderer import integrator

    out = {}
    for w, h in FIRST_IMAGES:
        pix = torch.arange(w * h, device="cuda")
        o, d = first_hit.camera_rays(cs, pix, 1, SEED, w, h)
        samp, bounce = integrator._depth0(pix, 1)
        hit = integrator.step_hit(cs, o, d, pix, samp, bounce, SEED)
        line = dict(cr_ms=device_ms(lambda: first_hit.camera_rays(
            cs, pix, 1, SEED, w, h)),
            cr_bound_ms=bound_ms(*cr_work(cs, pix, 1))[0],
            hit_lanes=int(torch.isfinite(hit[0]).sum()))
        none = dict(albedo=False, normal=False)
        for name, shader, planes in (
                ("aux", None, dict(albedo=True, normal=True)),
                ("albedo", integrator.SHADER_ALBEDO, none),
                ("normal", integrator.SHADER_NORMAL, none),
                ("simple", integrator.SHADER_SIMPLE, none)):
            line[f"fh_{name}_ms"] = device_ms(
                lambda k=shader, p=planes: first_hit.first_hit_shade(
                    cs, *hit, o, d, pix, 1, SEED, k, **p))
            for key, grain in (("bound", 12), ("sector_bound", 32)):
                line[f"fh_{name}_{key}_ms"] = bound_ms(*fh_work(
                    cs, o, d, hit, pix, 1, planes, shader, grain))[0]
        out[str(w * h)] = line
    return out


def build_log():
    """The compiler's report of the kernel library in use: this process's
    build's, or the one written beside the library when it was built."""
    from solstrale_tpu_torch.ops import _build

    log = _build.library_path().with_suffix(".log")
    return _build.BuildInfo.log or (log.read_text() if log.exists() else "")


def ptxas_lines(log, names=("step_",)):
    """ptxas' lines for the kernels in a build log whose entry names hold
    one of ``names`` (default: the step kernels): each entry's name, then
    its stack, spills and registers."""
    out, keep = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            keep = any(n in ln for n in names)
            if keep:
                out.append(ln.split("'")[1] if "'" in ln else ln)
        elif keep and ("registers" in ln or "spill" in ln
                       or "stack frame" in ln):
            out.append(ln.split("ptxas info    :")[-1].strip())
    return out


def measure_first_hit(cs):
    """The line of a first hit's kernel cell: FH and CR alone
    (``first_hit_times``) and their ptxas lines."""
    return dict(first_hit=first_hit_times(cs),
                ptxas=ptxas_lines(build_log(), FIRST_KERNELS))


def measure_kernels(cs, w, h, spp):
    """The line of a step kernels' cell (see the module docstring)."""
    out = {}
    for lanes in KERNEL_WIDTHS:
        calls = step_kernel_calls(cs, w, h, spp, lanes)
        restore = device_ms(calls["restore"])
        line = dict(
            s1_ms=device_ms(calls["s1"]),
            s2_ms=device_ms(calls["s2"]) - restore, restore_ms=restore,
            terminal_lanes=int(calls["terminal"].sum()))
        wf, pool = calls["wf"], calls["pool"]
        b = s1b_calls(cs, pool, pool.qpos < wf.total_q)
        nbytes, flops = s1b_work(b["rec"], b["g_color"])
        bound, by = bound_ms(nbytes, flops)
        solid = s1b_calls(cs, pool, pool.qpos < wf.total_q, one_row=0)
        line.update(s1b_ms=device_ms(b["launch"]),
                    s1b_fold_only_ms=device_ms(lambda: b["launch"](False)),
                    s1b_one_row_ms=device_ms(solid["launch"]),
                    s1b_bound_ms=bound, s1b_bound_by=by, s1b_bytes=nbytes,
                    s1b_rows=s1b_rows(b["rec"]))
        out[str(lanes)] = line
    return dict(widths=out, first_hit=first_hit_times(cs),
                ptxas=ptxas_lines(build_log(), ("step_",) + FIRST_KERNELS))


def _device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("wavefront_ab needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return smi


def worker(root, steps, side, workloads=WORKLOADS):
    """In a process whose package is ``root``'s: each workload measured,
    at each of ``steps`` (None: the tree's own driver; the step cells only
    at None), one JSON line each."""
    # run as a script, this file's directory heads sys.path: the package
    # must come from ``root`` alone
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(root)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != here]
    import solstrale_tpu_torch
    from solstrale_tpu_torch.renderer import integrator
    from solstrale_tpu_torch.scene.compile import compile_scene

    if Path(solstrale_tpu_torch.__file__).resolve().parent.parent != \
            Path(root).resolve():
        raise RuntimeError(f"imported {solstrale_tpu_torch.__file__}, not "
                           f"the tree at {root}")
    gpu = _device()
    for name in workloads:
        scene, w, h, spp = _workload(name)
        t0 = time.perf_counter()
        cs = compile_scene(scene, device="cuda")
        compile_s = time.perf_counter() - t0
        if name in STEPS or name in AUX or name.startswith(("kernels_",
                                                             "first_hit_")):
            line = (measure_step(cs, w, h) if name in STEPS else
                    measure_aux(cs, w, h) if name in AUX else
                    measure_first_hit(cs) if name.startswith("first_hit_")
                    else measure_kernels(cs, w, h, spp))
            print(json.dumps(dict(side=side, workload=name, width=w,
                                  height=h, max_depth=DEPTH,
                                  compile_s=compile_s, gpu=gpu, **line)),
                  flush=True)
            cs = None
            continue
        for k in steps or (None,):
            if k is not None:
                integrator.GRAPH_STEPS = k
            line = measure(cs, w, h, spp, profile=k is None)
            print(json.dumps(dict(side=side, workload=name, graph_steps=k,
                                  width=w, height=h, spp=spp,
                                  compile_s=compile_s, gpu=gpu, **line)),
                  flush=True)


def _run_side(root, side, steps=None, workloads=WORKLOADS):
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
           str(root), "--side", side, "--workloads", ",".join(workloads)]
    if steps:
        cmd += ["--steps", ",".join(map(str, steps))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        raise RuntimeError(f"{side} at {root} failed ({proc.returncode})")
    return [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="root of the parent's tree")
    ap.add_argument("--steps", help="GRAPH_STEPS values, comma-separated")
    ap.add_argument("--workloads", default=",".join(WORKLOADS),
                    help="comma-separated, of: " + ", ".join(WORKLOADS))
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--side", default="change", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    steps = [int(x) for x in args.steps.split(",")] if args.steps else None
    workloads = args.workloads.split(",")
    unknown = set(workloads) - set(WORKLOADS)
    if unknown:
        ap.error(f"unknown workloads {sorted(unknown)}")
    if args.worker:
        worker(args.worker, steps, args.side, workloads)
        return 0
    if args.parent:
        plan = [(args.parent, "parent", None), (HERE, "change", None),
                (HERE, "change", None), (args.parent, "parent", None)]
    elif steps:
        plan = [(HERE, "change", steps + steps[::-1])]
    else:
        ap.error("give --parent DIR or --steps LIST")
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "wavefront_ab.jsonl", "a") as f:
        for root, side, k in plan:
            for line in _run_side(root, side, k, workloads):
                print(line, flush=True)
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
