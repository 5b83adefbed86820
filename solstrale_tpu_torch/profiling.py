"""Where one render batch spends its time on the card.

    python -m solstrale_tpu_torch.profiling [--scene sponza|mixed|kitchen]

Compiles the fixture scene (1920x1080; sponza and mixed: 362 terrain
cells, the 262,088-triangle interior; kitchen: the normal-mapped
kitchen-sink scene, which takes the wavefront with the fused scene hit) on
the GPU, warms up, then times one
``render_sample_batch`` (1 spp, depth 50) twice: once bare (CUDA-synced
host clock: the end-to-end number) and once under ``torch.profiler``
(device time per kernel name, the device's busy and idle share of the
profiled wall time, and the hit kernels' share). Prints one JSON
object. Needs a CUDA device; there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch

HIT_KERNELS = ("k1_bvh", "k2_bvh_spheres", "k3_media", "k4_scene_hit",
               "k5_render")
WIDTH, HEIGHT, N_CELLS = 1920, 1080, 362


def _scene(name):
    import solstrale_tpu_torch as T
    from . import fixtures

    cfg = T.RenderConfig(width=WIDTH, height=HEIGHT, samples_per_pixel=1,
                         seed=1)
    if name == "sponza":
        return fixtures.sponza_class_scene(cfg, n_cells=N_CELLS)
    if name == "kitchen":
        return fixtures.kitchen_sink_scene(cfg)
    return fixtures.mixed_bvh_scene(cfg, n_cells=N_CELLS)


def device_kernel_times(prof):
    """{kernel name: (count, total device microseconds)} from a profile."""
    out = defaultdict(lambda: [0, 0.0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            rec = out[evt.name]
            rec[0] += 1
            rec[1] += evt.time_range.elapsed_us()
    return {k: tuple(v) for k, v in out.items()}


def device_kernels(calls, attempts=5):
    """For each of ``calls`` (name -> fn), the names of the device kernels
    one call runs. One torch.profiler session for all: the calls are
    separated by a short ``torch.cuda._sleep``, whose spin kernel marks the
    boundaries in the device timeline; memory copies and sets are not
    counted. A session sometimes comes back without device events, or
    without its last ones (seen on an H100 with torch 2.11): a few more
    markers follow the last call, at least one must arrive, and a session
    that fails that is run again, up to ``attempts`` times."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for fn in calls.values():
                torch.cuda._sleep(100_000)
                fn()
            for _ in range(4):
                torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and "memcpy" not in e.name.lower()
                         and "memset" not in e.name.lower()),
                        key=lambda e: e.time_range.start)
        groups = [[] for _ in calls]
        markers = 0
        for e in events:
            if "spin_kernel" in e.name or "sleep" in e.name.lower():
                markers += 1
            elif 1 <= markers <= len(calls):
                groups[markers - 1].append(e.name)
        if markers > len(calls):
            return dict(zip(calls, groups))
    raise RuntimeError(f"device_kernels: {attempts} traces held at most "
                       f"{markers} markers for {len(calls)} calls")


def profile_batch(scene_name="sponza"):
    from .renderer import integrator
    from .scene.compile import compile_scene

    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device")
    cs = compile_scene(_scene(scene_name), device="cuda")
    kw = dict(width=WIDTH, height=HEIGHT, max_depth=50,
              shader_kind=integrator.SHADER_PATH, need_aux=False, n_samples=1)
    float(integrator.render_sample_batch(cs, 100, 1, **kw)[0].sum())

    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    color, _, _, segs = integrator.render_sample_batch(cs, 1, 1, stats=stats,
                                                       **kw)
    float(color.sum())
    wall = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        color, _, _, _ = integrator.render_sample_batch(cs, 1, 1, **kw)
        float(color.sum())
        prof_wall = time.perf_counter() - t1
    kernels = device_kernel_times(prof)
    busy_us = sum(v[1] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:20]
    hit = {name: sum(v[1] for k, v in kernels.items() if name in k) / 1e3
           for name in HIT_KERNELS}
    return dict(
        scene=scene_name, width=WIDTH, height=HEIGHT,
        gpu=torch.cuda.get_device_name(0),
        batch_seconds=wall, segments=int(segs),
        segments_per_second=int(segs) / wall, iterations=stats["iters"],
        ms_per_iteration=wall * 1e3 / stats["iters"],
        profiled_wall_ms=prof_wall * 1e3, device_busy_ms=busy_us / 1e3,
        device_idle_share=max(0.0, 1.0 - busy_us / 1e3 / (prof_wall * 1e3)),
        kernel_launches=sum(v[0] for v in kernels.values()),
        hit_kernel_ms=hit,
        top_kernels=[dict(name=k[:90], count=v[0], ms=v[1] / 1e3)
                     for k, v in top])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=("sponza", "mixed", "kitchen"),
                    default="sponza")
    args = ap.parse_args(argv)
    print(json.dumps(profile_batch(args.scene)))


if __name__ == "__main__":
    main()
