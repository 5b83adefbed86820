"""Path-tracing throughput of the port on the card, over the five workloads
of the JAX package's ``bench.py`` at its settings (depth 50, seed 1).

    python -m solstrale_tpu_torch.bench

Prints one JSON line per workload, the headline (``sponza``, the
image-textured, normal-mapped 262,088-triangle interior at 1920x1080) last,
under ``bench.py``'s metric names: ``value`` is the median over ``runs``
timed batches of the path segments traced per second, in Mrays/s, beside
every run's seconds, the segments, the route (``k5``: one megakernel
launch per batch; ``wavefront``: the work-queue loop, on the card CUDA
graph replays), the kernels' launches in one batch (the hit kernels K1-K5
and the draw kernel), the wavefront's iterations and its stop-test reads
(host reads), the peak device memory and the card's name and power
limit. A workload that fails prints an
``error`` line; the others still run, and the script exits with 1. There
is no ``vs_baseline``: ``bench.py``'s 100 Mrays/s is a per-chip target of
the TPU work, not a number of this card.

The scenes are ``fixtures``' asset-free stand-ins for the JAX package's
``tests/scenes.py`` fixtures. Needs a CUDA device: ``main(device="cpu")``
and ``run(..., device="cpu")`` measure on the CPU only when the caller
asks for it.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import traceback
from collections.abc import Callable
from dataclasses import dataclass
from functools import partial

import torch

from . import fixtures

SEED = 1
MAX_DEPTH = 50


@dataclass(frozen=True)
class Workload:
    """One measured configuration: ``scene(render_config)`` compiled and
    rendered at width x height, ``spp`` samples per batch; ``k5_direct``
    calls the megakernel's wrapper itself (the scene must pass its gate)
    instead of ``render_sample_batch``."""
    name: str
    metric: str
    scene: Callable
    width: int
    height: int
    spp: int
    k5_direct: bool = False


# bench.py's workloads in its order, the headline last
WORKLOADS = (
    # the reference's own profiling workload (bench.py:61-70), its tex.jpg
    # the production interior's image; without a normal map the megakernel
    # gate takes it: one K5 launch per batch
    Workload("kitchen_sink", "kitchen_sink_mrays_per_s",
             partial(fixtures.kitchen_sink_scene, normal_map=False,
                     tex_size=1024),
             400, 266, 8),
    Workload("sponza_production", "sponza_production_mrays_per_s",
             fixtures.sponza_production_scene, 1920, 1080, 1),
    Workload("many_lights", "many_lights_mrays_per_s",
             partial(fixtures.many_light_scene, n_lights=64), 960, 540, 1),
    # bench.py compiles it with use_bvh=False; the default gives a scene
    # this small (under BVH_THRESHOLD solids) no BVH either
    Workload("megakernel", "megakernel_mrays_per_s",
             fixtures.kitchen_sink_solid_scene, 400, 266, 8,
             k5_direct=True),
    Workload("sponza", "sponza_1080p_mrays_per_s",
             fixtures.sponza_textured_scene, 1920, 1080, 1),
)


def kernel_wrappers():
    """The kernels' wrappers by name, the hit kernels K1-K5, the draw
    kernel, the wavefront step's S1 and S2, S1's backward S1B and the first
    hit's camera rays CR and shading FH; each counts its launches in
    ``launches``."""
    from .ops import bvh, first_hit, rng, step, sweep
    from .renderer import megakernel

    return {"K1": bvh.bvh_planar_hit, "K2": sweep.bvh_sphere_hit,
            "K3": sweep.media_hit, "K4": sweep.scene_hit,
            "K5": megakernel.render_batch_megakernel, "draw": rng.uniform4,
            "S1": step.step_shade, "S2": step.step_regen,
            "S1B": step.step_shade_backward, "CR": first_hit.camera_rays,
            "FH": first_hit.first_hit_shade}


def device_info(device):
    """The card's name and power limit as nvidia-smi reports them; raises
    without a card."""
    if torch.device(device).type != "cuda":
        return {"name": "cpu", "power_limit": None}
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "false")
    name, limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].split(", ")
    return {"name": name, "power_limit": limit}


def measure(cs, width, height, spp, max_depth, runs=5, k5_direct=False):
    """Time ``runs`` batches of ``spp`` samples of the compiled scene
    ``cs`` at ``sample_start`` 1, seed 1, after one warm-up batch at
    ``sample_start`` 100 (it also builds the kernels outside the clock).
    Each timed batch ends in a device synchronise before the clock stops;
    a black batch (``color.sum() <= 0``) raises, and so do batches that do
    not repeat their segments, iterations, host reads and launches exactly.
    Returns the median Mrays/s (segments over seconds), every run's
    seconds, the segments, the route, the kernels' launches in one batch,
    the wavefront's iterations and stop-test reads (None on the K5 route)
    and the peak device memory in GB (None on the CPU)."""
    from .renderer import integrator, megakernel

    cuda = cs.device.type == "cuda"
    gate = megakernel.megakernel_supported(cs, need_aux=False,
                                           shader_kind=integrator.SHADER_PATH)
    if k5_direct and not gate:
        raise ValueError("k5_direct: the scene is outside the megakernel "
                         "gate")
    kernels = kernel_wrappers()

    def batch(sample_start, stats):
        if k5_direct:
            return megakernel.render_batch_megakernel(
                cs, sample_start, spp, SEED, width=width, height=height,
                max_depth=max_depth)
        color, _, _, segs = integrator.render_sample_batch(
            cs, sample_start, SEED, width=width, height=height,
            max_depth=max_depth, shader_kind=integrator.SHADER_PATH,
            need_aux=False, n_samples=spp, stats=stats)
        return color, segs

    def sync():
        if cuda:
            torch.cuda.synchronize()

    batch(100, None)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    seconds, repeats = [], set()
    for _ in range(runs):
        stats = {}
        before = {k: fn.launches for k, fn in kernels.items()}
        sync()
        t0 = time.perf_counter()
        color, segs = batch(1, stats)
        sync()
        seconds.append(time.perf_counter() - t0)
        checksum = float(color.sum())
        if not checksum > 0:
            raise RuntimeError(f"degenerate render: checksum={checksum}")
        launches = {k: fn.launches - before[k] for k, fn in kernels.items()}
        repeats.add((int(segs), stats.get("iters"), stats.get("host_reads"),
                     tuple(launches.values())))
    if len(repeats) != 1:
        raise RuntimeError(f"the batches did not repeat: {sorted(repeats)}")
    segments, iterations, host_reads, _ = repeats.pop()
    return dict(
        value=segments / statistics.median(seconds) / 1e6, unit="Mrays/s",
        route="k5" if gate else "wavefront", segments=segments,
        runs_s=seconds, launches=launches, iterations=iterations,
        host_reads=host_reads,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda
        else None)


def run_workload(w, device="cuda", runs=5):
    """Build and compile ``w``'s scene on ``device`` and measure it; the
    JSON line as a dict (the build's and compile's seconds in
    ``compile_s``)."""
    from . import RenderConfig
    from .scene.compile import compile_scene

    t0 = time.perf_counter()
    cs = compile_scene(w.scene(RenderConfig(
        width=w.width, height=w.height, samples_per_pixel=w.spp,
        samples_per_batch=w.spp, seed=SEED)), device=device)
    compile_s = time.perf_counter() - t0
    line = measure(cs, w.width, w.height, w.spp, MAX_DEPTH, runs=runs,
                   k5_direct=w.k5_direct)
    return {"metric": w.metric, **line, "width": w.width,
            "height": w.height, "spp": w.spp, "compile_s": compile_s}


def run(workloads=WORKLOADS, device="cuda", runs=5):
    """Measure each workload in order and print its JSON line as it ends;
    a workload that raises prints an ``error`` line (its traceback on
    stderr) and the rest still run. Returns the lines."""
    info = device_info(device)
    lines = []
    for w in workloads:
        try:
            line = {**run_workload(w, device, runs), "device": info}
        except Exception as err:  # noqa: BLE001 — report, run the rest
            traceback.print_exc()
            line = {"metric": w.metric,
                    "error": f"{type(err).__name__}: {err}"[:500]}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def main(argv=None, device="cuda"):
    """Run every workload on ``device``; 1 if any failed, else 0."""
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    lines = run(WORKLOADS, device)
    return 1 if any("error" in line for line in lines) else 0


if __name__ == "__main__":
    sys.exit(main())
