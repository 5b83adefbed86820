"""The progressive-render driver: a user watches one image converge.

The window drives the library's entry, ``Renderer.render`` (what
``ray_trace`` runs), with an image each update (``EverySample``),
``samples_per_batch`` samples a pixel an update and ``samples_per_pixel``
large enough to outlast the window; its ``abort`` ends the render at the
first request after the window's end. A closed loop: the next update is requested when the last
one's u8 image is on the host.

- ``msamples_per_s``: pixel samples whose image reached the host in the
  window, over the window's seconds (from the first request to the last
  image's arrival: the updates requested before the deadline);
- ``update_ms_p95``: the 95th percentile (nearest rank) over every update
  of the window of the wait from its request to its image's arrival;
- ``setup_s``: from the process's start to the first timed request: the
  imports, CUDA's start, the scene's generation and compile, the library
  load (and in a checkout's first run its build) and one warm-up update
  (the graphs' capture).

``correct`` (checked once the window has closed, the program's state
freed): the colour of every update at ``check_pixels`` pixels drawn from
the seed is kept from the timed path (one gather of a few hundred values
an update); at ``check_updates`` updates drawn from the seed (the first and
the last among them) the plain reference traces the same (pixel, sample)
paths, and the share of (pixel, update) colours that differ by more than
``atol + rtol * |reference|`` in a channel is held to its limit; the final
image at those pixels must equal the tone map of the sum of every update's
kept colours (the progressive sum and the tone map, exactly).
"""
from __future__ import annotations

import time

import numpy as np

from .. import harness
from . import common

HUGE_SPP = 1 << 30


class Abort:
    """``Renderer.render``'s abort callable for a window that ends at
    ``deadline``: the loop asks before each batch and again before making
    its image; only the first of the two asks may end the render, so every
    update the window requested reaches the host with its image."""

    def __init__(self, deadline):
        self.deadline = deadline
        self.calls = 0

    def __call__(self):
        self.calls += 1
        return self.calls % 2 == 1 and time.perf_counter() >= self.deadline


def run(run):
    import torch

    import solstrale_tpu_torch as T
    from solstrale_tpu_torch import post
    from solstrale_tpu_torch.renderer import integrator
    from solstrale_tpu_torch.scene import compile as scene_compile

    cfg, mix = run.config, run.traffic
    width = int(mix.get("width", cfg["width"]))
    height = int(mix.get("height", cfg["height"]))
    spb = int(mix["samples_per_batch"])
    max_depth = int(cfg["max_depth"])
    rec = run.rec
    dev = run.device

    # the pixels whose colours are kept, drawn from the seed
    rng = np.random.default_rng([run.seed, 1])
    pix = np.sort(rng.choice(width * height, int(mix["check_pixels"]),
                             replace=False))
    rows = torch.as_tensor(height - 1 - pix // width, device=dev)
    cols = torch.as_tensor(pix % width, device=dev)

    updates = []      # per update: sample_start, samples, segments, span
    # in the traced run on the card, CUDA events around each update's
    # post_process: its device time without a sync the program lacks
    image_events = []

    def keep(out, args, kwargs):
        color, _, _, segs = out
        u = rec.counters.setdefault("picks", [])
        u.append(color[rows, cols])
        updates.append(dict(sample=int(args[1]), n=int(kwargs["n_samples"]),
                            segs=segs,
                            t=rec.spans["render_sample_batch"][-1]))

    def image_start(args, kwargs):
        image_events.append([torch.cuda.Event(enable_timing=True), None])
        image_events[-1][0].record()
        return args, kwargs

    def image_end(out, args, kwargs):
        image_events[-1][1] = torch.cuda.Event(enable_timing=True)
        image_events[-1][1].record()

    timed_image = run.trace and dev == "cuda"
    restore = [
        rec.wrap(scene_compile, "compile_scene"),
        rec.wrap(integrator, "render_sample_batch", after=keep),
        rec.wrap(post.NopPostProcessor, "post_process",
                 before=image_start if timed_image else None,
                 after=image_end if timed_image else None),
    ]
    try:
        scene = common.build_scene(T, run, width, height, T.RenderConfig(
            width=width, height=height, samples_per_pixel=HUGE_SPP,
            samples_per_batch=spb, render_image_strategy=T.EverySample(),
            shader=T.PathTracingShader(max_depth), seed=run.render_seed))
        renderer = T.Renderer(scene, device=dev)
        # warm-up: the loop's first update, its graphs captured
        gen = renderer.render()
        next(gen)
        gen.close()
        common.sync(dev)
        run.warm_profiler()
        rec.counters["picks"] = []
        updates.clear()
        image_events.clear()

        waits, last = [], None
        t_start = time.perf_counter()
        deadline = t_start + run.args.seconds
        setup_s = t_start - run.t_process
        t_req = t_start
        t_last = t_start
        for progress in renderer.render(abort=Abort(deadline)):
            t_arr = time.perf_counter()
            if progress.render_image is None:
                raise RuntimeError("an update without an image")
            waits.append(t_arr - t_req)
            last = progress.render_image
            t_last = t_arr
            run.maybe_stretch(t_start, t_arr)
            t_req = time.perf_counter()
        common.sync(dev)
        run.close_stretch()
    finally:
        for r in restore:
            r()
    window_s = t_last - t_start
    n_updates = len(waits)
    updates = updates[:n_updates]
    picks = rec.counters["picks"][:n_updates]
    run.attempted = n_updates
    run.memory_peak_bytes = common.memory_peak(dev)
    run.metric("msamples_per_s",
               n_updates * spb * width * height / window_s / 1e6,
               "Msamples/s")
    run.metric("update_ms_p95", harness.percentile(waits, 95) * 1e3, "ms")
    run.metric("setup_s", setup_s, "s")
    run.info.update(common.device_info(dev), updates=n_updates,
                    window_s=window_s)
    run.power_limit = harness.power_limit(run) if dev == "cuda" else None
    rec.counters["segments"] = [int(u["segs"]) for u in updates]
    if timed_image:
        rec.counters["image_ms"] = [a.elapsed_time(b) for a, b in
                                    image_events[:n_updates]]
    if run.trace:
        run.stretch_summary = (run.stretch.summary(set(rec.spans))
                               if run.stretch.t1 is not None else None)

    picks = torch.stack(picks).cpu() if picks else torch.zeros((0, len(pix),
                                                                  3))
    final = (torch.as_tensor(last[height - 1 - pix // width, pix % width])
             if last is not None else None)
    # the program's state goes before the reference runs
    del renderer, gen, scene
    common.free(dev)
    check(run, pix, picks, final, updates, width, height, spb, max_depth)
    if run.trace:
        harness.read_layer_metrics(run)


def check(run, pix, picks, final, updates, width, height, spb, max_depth):
    """The comparisons of ``correct`` (see the module's docstring)."""
    import torch

    from ..reference import integrator as ref
    from ..reference.utils import to_rgb_u8

    mix, dev = run.traffic, run.device
    lim = common.limits(run)
    n = len(updates)
    if n == 0:
        run.check("updates", 0, -1)
        return
    # the progressive sum and the tone map: exact
    total = torch.zeros_like(picks[0], device=dev)
    for k in range(n):
        total = total + picks[k].to(dev)
    expect = to_rgb_u8(total, n * spb).cpu()
    gap = int((expect.to(torch.int32) - final.to(torch.int32)).abs().max())
    run.check("image_u8_gap", gap, lim["image_u8_gap"])

    # the paths of a sample of updates against the reference
    chosen = chosen_updates(run, n)
    cs, media = common.reference_scene(run, width, height)
    lanes_pix, lanes_smp = lanes(pix, [updates[u]["sample"] for u in chosen],
                                 spb, dev)
    observer = (common.Observer(run, cs, media)
                if common.Observer.wanted(run) else None)
    t0 = time.perf_counter()
    color = ref.trace_paths(
        cs, lanes_pix, lanes_smp, run.render_seed,
        width=width, height=height, max_depth=max_depth, media=media,
        observe=observer)
    run.info["reference_s"] = time.perf_counter() - t0
    ref_c = color.reshape(len(chosen), spb, len(pix), 3).sum(1).cpu()
    prog = picks[chosen]
    run.check("path_mismatch_share", mismatch_share(prog, ref_c, mix),
              lim["path_mismatch_share"])
    run.info.update(checked_updates=len(chosen), checked_pixels=len(pix),
                    max_gap=float((prog - ref_c).abs().max()))
    if observer is not None:
        observer.finish(run, updates, width * height * spb, width * height)


def chosen_updates(run, n):
    """The indices of the updates whose paths are checked: the first, the
    last and ``check_updates`` drawn from the seed among ``n``."""
    rng = np.random.default_rng([run.seed, 2])
    k = min(n, int(run.traffic["check_updates"]))
    return sorted({0, n - 1} | set(rng.choice(n, k, replace=False)
                                   .tolist()))


def lanes(pix, samples, spb, dev):
    """(pixel, sample) lanes of the checked pixels at each update's
    ``spb`` samples from ``samples``, update by update."""
    import torch

    pixel = torch.as_tensor(pix, dtype=torch.int64, device=dev)
    p, s = [], []
    for start in samples:
        for j in range(spb):
            p.append(pixel)
            s.append(torch.full_like(pixel, start + j))
    return torch.cat(p), torch.cat(s)


def mismatch_share(prog, ref, mix):
    """The share of (update, pixel) colours of ``prog`` that differ from
    ``ref`` by more than ``atol + rtol * |ref|`` in some channel."""
    bad = ((prog - ref).abs() > mix["atol"] + mix["rtol"] * ref.abs()).any(-1)
    return float(bad.float().mean())
