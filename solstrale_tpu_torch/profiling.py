"""Where one render batch, or one inverse-rendering step, spends its time
on the card.

    python -m solstrale_tpu_torch.profiling [--scene NAME]
    python -m solstrale_tpu_torch.profiling --step [--scene mixed|kitchen]
    python -m solstrale_tpu_torch.profiling --step --eager [--scene ...]

Compiles the fixture scene (1920x1080; sponza and mixed: 362 terrain
cells, the 262,088-triangle interior; kitchen: the normal-mapped
kitchen-sink scene, which takes the wavefront with the fused scene hit;
or a wavefront workload of ``bench`` at its size: sponza_textured, the
bench's headline ``sponza``; sponza_production; many_lights) on the GPU,
warms up (on the wavefront, the warm-up batch also captures its CUDA
graphs), then times one ``render_sample_batch`` (1 spp, depth 50) twice:
once bare (CUDA-synced host clock: the end-to-end number, with the steps
run, the stop-test reads and the graph replays) and once under
``torch.profiler`` (device time per kernel name, the device's busy and
idle share of the profiled wall time, the hit kernels', the draw
kernel's and the step kernels' (S1, S2) share, the device kernels a step,
and the launches the profiler saw of K1, the draw kernel, S1 and S2 beside
the wrappers' counts: kernels inside a graph replay are attributed only if
the two agree). ``--step`` times one
``diff.image_and_texture_grad`` step instead (1 spp, depth 50, against a
target at seed 2), which on the card replays the step's CUDA graph: its
first call (the capture), one call by CUDA events, the host reads of a
call and the kernels' launches in it (S1 and its backward S1B among
them), and one call under ``torch.profiler`` (its device ops, the fills
and adds among them, busy and idle share, each kernel's time); ``--eager``
runs the same step op by op (``diff._GradStep.eager``)
and times its forward and its backward (the checkpointed replay and the
gradient) apart. Prints one JSON object. Needs a CUDA device; there is
no CPU fallback.
"""
from __future__ import annotations

import argparse
import json
import re
import time
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

HIT_KERNELS = ("k1_bvh", "k2_bvh_spheres", "k3_media", "k4_scene_hit",
               "k5_render", "rng_uniform4", "step_shade", "step_regen",
               "step_shade_backward", "camera_rays", "first_hit_shade")
WIDTH, HEIGHT, N_CELLS = 1920, 1080, 362


# --scene names of the bench's wavefront workloads -> their bench names
BENCH_SCENES = {"sponza_textured": "sponza",
                "sponza_production": "sponza_production",
                "many_lights": "many_lights"}


def _scene(name):
    """(scene, width, height) of a --scene name."""
    import solstrale_tpu_torch as T
    from . import bench, fixtures

    if name in BENCH_SCENES:
        w = next(w for w in bench.WORKLOADS if w.name == BENCH_SCENES[name])
        return (w.scene(T.RenderConfig(width=w.width, height=w.height,
                                       samples_per_pixel=1, seed=1)),
                w.width, w.height)
    cfg = T.RenderConfig(width=WIDTH, height=HEIGHT, samples_per_pixel=1,
                         seed=1)
    if name == "sponza":
        scene = fixtures.sponza_class_scene(cfg, n_cells=N_CELLS)
    elif name == "kitchen":
        scene = fixtures.kitchen_sink_scene(cfg)
    else:
        scene = fixtures.mixed_bvh_scene(cfg, n_cells=N_CELLS)
    return scene, WIDTH, HEIGHT


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
    counted. A session sometimes comes back without device events, without
    its last ones, or without one call's kernel between markers that
    arrived (seen on an H100 with torch 2.11): a few more markers follow
    the last call, at least one must arrive, every call must show a
    kernel (each of the callers' calls launches one), and a session that
    fails that is run again, up to ``attempts`` times."""
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
        if markers > len(calls) and all(groups):
            return dict(zip(calls, groups))
    raise RuntimeError(f"device_kernels: none of {attempts} traces held "
                       f"every call's kernels between {len(calls) + 1} "
                       f"markers (the last: {markers} markers, kernels "
                       f"{groups})")


def _is_kernel(name, event):
    """Whether a profiler event's name is the kernel ``name`` (not one whose
    name it begins, as step_shade begins step_shade_backward)."""
    return re.search(rf"\b{name}\(", event) is not None or event == name


def _profile(fn):
    """fn() under torch.profiler: its wall ms and the device's kernels (a
    summary, and ``device_kernel_times``)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernel_times(prof)
    busy_us = sum(v[1] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:20]
    return dict(
        profiled_wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
        device_idle_share=max(0.0, 1.0 - busy_us / 1e3 / wall_ms),
        kernel_launches=sum(v[0] for v in kernels.values()),
        hit_kernel_ms={name: sum(v[1] for k, v in kernels.items()
                                 if _is_kernel(name, k)) / 1e3
                       for name in HIT_KERNELS},
        top_kernels=[dict(name=k[:90], count=v[0], ms=v[1] / 1e3)
                     for k, v in top]), kernels


class HostReads(TorchDispatchMode):
    """While active, counts in ``n`` the ops that read a tensor back to the
    host (each a sync on the card). Ops inside a CUDA graph replay are not
    dispatched, so they read nothing."""

    SYNCS = frozenset({"_local_scalar_dense", "nonzero", "is_nonzero",
                       "equal", "masked_select", "allclose", "argwhere",
                       "unique", "_unique2", "repeat_interleave"})

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.SYNCS:
            self.n += 1
        return func(*args, **(kwargs or {}))


class ArenaOps(TorchDispatchMode):
    """While active, counts the zero fills (``fills``) and the adds
    (``adds``) whose result has a texture arena's shape, (rows, 3), or its
    gradient sums' (``ops.step.GradSums``), (rows + 1, 3): what one
    backward pass spends on the arena's gradient outside S1B. Ops inside
    a CUDA graph replay are not dispatched."""

    FILLS = frozenset({"zeros", "zeros_like", "new_zeros", "zero_", "fill_"})
    ADDS = frozenset({"add", "add_"})

    def __init__(self, rows):
        super().__init__()
        self.shapes = {(rows, 3), (rows + 1, 3)}
        self.fills = self.adds = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and tuple(out.shape) in self.shapes:
            name = func.overloadpacket.__name__
            self.fills += name in self.FILLS
            self.adds += name in self.ADDS
        return out


def fills_and_adds(kernels):
    """(fill ops, add ops) among a profile's device kernels
    (``device_kernel_times``), by ``wavefront_ab``'s name patterns."""
    from .wavefront_ab import ADD_OPS, FILL_OPS

    def count(keys):
        return sum(v[0] for k, v in kernels.items()
                   if any(x in k for x in keys))

    return count(FILL_OPS), count(ADD_OPS)


def profile_step(scene_name="mixed", eager=False):
    from . import diff
    from .scene.compile import compile_scene

    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device")
    scene, width, height = _scene(scene_name)
    cs = compile_scene(scene, device="cuda")
    kw = dict(width=width, height=height, max_depth=50, n_samples=1)
    with torch.no_grad():
        target = diff.render_linear(cs, seed=2, **kw)
    if eager:
        step = diff._GradStep(cs, target, seed=1, **kw)

        def call():
            return step.eager(cs, target)
    else:
        def call():
            return diff.image_and_texture_grad(cs, target, seed=1, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0

    out = dict(scene=scene_name, width=width, height=height, max_depth=50,
               gpu=torch.cuda.get_device_name(0),
               route="eager" if eager else "graph", first_call_seconds=first)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks[0].record()
    if eager:
        # the forward and the backward (the checkpointed replay and the
        # gradient) apart
        p = cs.textures.pixels.detach().requires_grad_(True)
        img = diff.render_linear(diff.set_texture_params(cs, p), seed=1,
                                 **kw)
        loss = torch.mean((img - target) ** 2)
        marks[1].record()
        torch.autograd.grad(loss, p)
    else:
        call()
    marks[2].record()
    torch.cuda.synchronize()
    out["step_seconds"] = time.perf_counter() - t0
    out["step_ms"] = marks[0].elapsed_time(marks[2])
    if eager:
        out["forward_ms"] = marks[0].elapsed_time(marks[1])
        out["backward_ms"] = marks[1].elapsed_time(marks[2])
    from . import bench

    wrappers = bench.kernel_wrappers()
    before = {k: fn.launches for k, fn in wrappers.items()}
    with HostReads() as reads:
        call()
    torch.cuda.synchronize()
    out["host_reads"] = reads.n
    out["launches"] = {k: fn.launches - before[k]
                       for k, fn in wrappers.items()}
    prof, kernels = _profile(call)
    # every kernel of the step, inside a replay too
    prof["device_ops_per_step"] = prof["kernel_launches"]
    prof["fills"], prof["adds"] = fills_and_adds(kernels)
    return dict(out, **prof)


def profile_batch(scene_name="sponza"):
    from . import bench
    from .renderer import integrator
    from .scene.compile import compile_scene

    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device")
    scene, width, height = _scene(scene_name)
    cs = compile_scene(scene, device="cuda")
    kw = dict(width=width, height=height, max_depth=50,
              shader_kind=integrator.SHADER_PATH, need_aux=False, n_samples=1)
    float(integrator.render_sample_batch(cs, 100, 1, **kw)[0].sum())

    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    color, _, _, segs = integrator.render_sample_batch(cs, 1, 1, stats=stats,
                                                       **kw)
    float(color.sum())
    wall = time.perf_counter() - t0

    wrappers = bench.kernel_wrappers()
    before = {k: fn.launches for k, fn in wrappers.items()}
    prof, kernels = _profile(
        lambda: integrator.render_sample_batch(cs, 1, 1, **kw))
    counted = {k: fn.launches - before[k] for k, fn in wrappers.items()}
    pairs = {"k1_bvh": "K1", "rng_uniform4": "draw", "step_shade": "S1",
             "step_regen": "S2"}
    seen = {name: sum(v[0] for k, v in kernels.items()
                      if _is_kernel(name, k)) for name in pairs}
    iters = stats.get("iters")
    return dict(
        scene=scene_name, width=width, height=height,
        gpu=torch.cuda.get_device_name(0),
        batch_seconds=wall, segments=int(segs),
        segments_per_second=int(segs) / wall, iterations=iters,
        host_reads=stats.get("host_reads"), replays=stats.get("replays"),
        ms_per_iteration=wall * 1e3 / iters if iters else None,
        launches_per_iteration=(prof["kernel_launches"] / iters if iters
                                else None),
        profiled_vs_counted={name: [seen[name], counted[key]]
                             for name, key in pairs.items()},
        **prof)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=("sponza", "mixed", "kitchen",
                                        *BENCH_SCENES),
                    default=None, help="default: sponza, mixed with --step")
    ap.add_argument("--step", action="store_true",
                    help="one inverse-rendering step, not a render batch")
    ap.add_argument("--eager", action="store_true",
                    help="with --step: the step dispatched op by op, its "
                         "forward and backward timed apart")
    args = ap.parse_args(argv)
    if args.eager and not args.step:
        ap.error("--eager needs --step")
    if args.step:
        print(json.dumps(profile_step(args.scene or "mixed", args.eager)))
    else:
        print(json.dumps(profile_batch(args.scene or "sponza")))


if __name__ == "__main__":
    main()
