"""K5 against the small-scene wavefront on scenes that grow one table at a
time: the sweep behind the megakernel's gate (``megakernel_supported``).

    python -m solstrale_tpu_torch.gate_sweep [--tables planar,spheres,...]
        [--sizes N,N,...] [--runs N]

For each table of ``fixtures.TABLES`` (planar rows, spheres, lights,
materials with their textures, a medium's boundary rows) and each size of
``SIZES`` (or of ``--sizes``), ``fixtures.table_scene`` is compiled
without a BVH (``use_bvh=False``, so that planar rows past the BVH
threshold stay on these two routes) and rendered at ``WIDTH`` x
``HEIGHT`` x ``SPP``, depth ``DEPTH``, seed 1, sample 1, once without and
once with a normal map on the ground (K5's two instantiations): by K5
(``megakernel.launch``, the launch ``render_batch_megakernel`` makes,
without its gate, so that sizes past the gate's limits are timed too;
``gate`` in each line says whether the gate takes the scene) and by
``trace_queued`` (the wavefront with the fused scene hit K4, S1
and S2, replayed as CUDA graphs), each after a warm-up batch (the build
and the graph capture), then ``RUNS`` batches of each in turns (K5,
wavefront, wavefront, K5, ...), each timed by the host's clock to a
synchronise. One JSON line a point: both routes' median and every ms,
Mrays/s, ``wavefront_over_k5`` (above 1: K5 is faster), the table sizes,
the segments (equal on both routes) and the largest difference of the two
images (within ``TOL``, ``chip_smoke.py``'s K5-against-wavefront limit);
the card's name and power limit in each. The lines are also written to
``chiprun_out/gate_sweep.jsonl``. Needs a CUDA device; a check that fails
raises.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

WIDTH, HEIGHT, SPP, DEPTH, SEED = 400, 266, 8, 50, 1
RUNS = 5
# K5 against trace_queued: rtol = atol (chip_smoke.py's TOL_K5)
TOL = 2e-3
# each table's sizes: items of the table (the media's: boundary rows,
# 6 k^2)
SIZES = {"planar": (64, 128, 256, 512, 1024, 2048, 4096),
         "spheres": (8, 16, 32, 64, 128, 256, 512),
         "lights": (8, 16, 32, 64, 128, 256),
         "materials": (16, 32, 64, 128, 256),
         "media": (6, 24, 96, 216, 384, 864)}


def table_sizes(cs):
    """The sizes of the tables the old gate bounded."""
    return dict(planar=cs.solids.pl_n.shape[0],
                spheres=cs.solids.sph_center.shape[0],
                lights=cs.lights.kind.shape[0],
                materials=cs.materials.kind.shape[0],
                textures=cs.textures.attr.shape[0],
                medium_rows=[m.boundary.pl_n.shape[0] for m in cs.media])


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def point(table, n, normal_map, runs=RUNS):
    """One point of the sweep on the card (see the module docstring)."""
    import torch
    import solstrale_tpu_torch as T
    from solstrale_tpu_torch import fixtures
    from solstrale_tpu_torch.renderer import integrator, megakernel
    from solstrale_tpu_torch.scene.compile import compile_scene

    cs = compile_scene(fixtures.table_scene(
        T.RenderConfig(width=WIDTH, height=HEIGHT, seed=SEED), table, n,
        normal_map=normal_map), use_bvh=False, device="cuda")
    kw = dict(width=WIDTH, height=HEIGHT, max_depth=DEPTH)
    routes = {
        "k5": lambda s: megakernel.launch(cs, s, SPP, SEED, **kw),
        "wavefront": lambda s: integrator.trace_queued(cs, s, SPP, SEED,
                                                       **kw)}
    for fn in routes.values():
        fn(100)
    ms = {k: [] for k in routes}
    out = {}
    for i in range(runs):
        order = ("k5", "wavefront") if i % 2 == 0 else ("wavefront", "k5")
        for k in order:
            t, out[k] = _timed(lambda k=k: routes[k](1))
            ms[k].append(t)
    (a, seg_a), (b, seg_b) = out["k5"], out["wavefront"]
    if int(seg_a) != int(seg_b):
        raise AssertionError(f"{table} {n}: segments K5 {int(seg_a)}, "
                             f"wavefront {int(seg_b)}")
    if not torch.allclose(a, b, rtol=TOL, atol=TOL):
        raise AssertionError(f"{table} {n}: K5 and the wavefront differ "
                             f"beyond {TOL}")
    med = {k: statistics.median(v) for k, v in ms.items()}
    return dict(
        table=table, n=n, normal_map=normal_map, sizes=table_sizes(cs),
        gate=megakernel.megakernel_supported(cs, need_aux=False,
                                             shader_kind=0),
        segments=int(seg_a), k5_ms=med["k5"], wavefront_ms=med["wavefront"],
        k5_ms_all=ms["k5"], wavefront_ms_all=ms["wavefront"],
        k5_mrays_per_s=int(seg_a) / med["k5"] / 1e3,
        wavefront_mrays_per_s=int(seg_a) / med["wavefront"] / 1e3,
        wavefront_over_k5=med["wavefront"] / med["k5"],
        max_abs_diff=float((a - b).abs().max()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tables", default=",".join(SIZES),
                    help="comma-separated, of: " + ", ".join(SIZES))
    ap.add_argument("--sizes", help="comma-separated sizes in place of "
                    "each table's SIZES")
    ap.add_argument("--runs", type=int, default=RUNS)
    args = ap.parse_args(argv)
    tables = args.tables.split(",")
    unknown = set(tables) - set(SIZES)
    if unknown:
        ap.error(f"unknown tables {sorted(unknown)}")
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("gate_sweep needs a CUDA device")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out = Path(__file__).resolve().parent.parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "gate_sweep.jsonl", "a") as f:
        for table in tables:
            sizes = (SIZES[table] if args.sizes is None else
                     [int(x) for x in args.sizes.split(",")])
            for n in sizes:
                for normal_map in (False, True):
                    line = json.dumps(dict(gpu=gpu, width=WIDTH,
                                           height=HEIGHT, spp=SPP,
                                           max_depth=DEPTH, **point(
                                               table, n, normal_map,
                                               args.runs)))
                    print(line, flush=True)
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
