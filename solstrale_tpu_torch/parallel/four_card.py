"""The sharded routes on four cards, one NCCL rank a card, each held to one
card.

    python -m solstrale_tpu_torch.parallel.four_card
    python -m solstrale_tpu_torch.parallel.four_card --device-type cpu

On the card it needs four CUDA devices and raises with fewer: it never runs
fewer ranks, gloo or the CPU in their place. ``--device-type cpu`` runs the
same rank functions on four gloo ranks at small sizes (``SIZES["cpu"]``),
the CPU twin that the tests drive.

``run`` makes two launches (``distributed.launch``): one rank on one card
(a one-rank group, mesh 1x1), the reference, then four ranks, rank r on
card r, each route on the 4x1 and the 2x2 mesh (``parallel.make_mesh``).
Every rank returns CPU values only; the launcher compares them with the
reference and prints one JSON line a check and a measurement, each with
the cards' names and power limits (``nvidia-smi``). A check outside its
tolerance raises once every line is printed.

Checks (depth 50, seed 1):
- the ranks: four distinct cards (index and UUID), the backend;
- ``render_batch_sharded`` of the textured sponza at 1920x1080, samples 1-8
  (K1, S1, S2): the image against one card's ``render_sample_batch``
  (rtol 1e-6, atol 1e-6: the 2x2 mesh sums the sample halves in another
  order), the segments exactly equal, the per-tile segments summing to
  them, every rank's image the same bits;
- ``render_sample_sharded`` of the mixed scene at 1920x1080, the path
  shader (K1-K3, S1, CR) and the simple shader with the aux planes (CR,
  FH): bit-equal to one card's ``render_sample`` at sample 1 (4x1) and to
  samples 1 and 2 summed (2x2);
- ``render_distributed`` of the interior at 320x180, 2 spp, with
  ``n_sample_axis`` 1 and 2: rank 0's final u8 image equal to one card's;
- ``train_step_sharded`` on the mixed scene at 1920x1080 (K1-K3, S1, S1B)
  and the normal-mapped kitchen at 400x266 (K4), lr 10, against a target
  at seed 2: the loss within rtol 1e-5 and the gradient, ``(old - new) /
  lr``, within rtol 1e-4, atol 1e-7 (atomic sums) of one card's shard
  steps over the whole image at sample 1 (4x1), at samples 1 and 2 summed
  (2x2); every rank's new arena the same bits as rank 0's.

Measurements (on the card; host clocks and no device numbers on the CPU):
the batch's Mrays/s (segments over the synced batch's wall time, the
slowest rank's, median of ``runs``) at one rank, 4x1 and 2x2, the scaling
efficiency, each rank's own batch ms (``parallel.shard_batch``) and the
tiles' segments; the sharded step's replay ms (``diff.shard_loss_and_grad``)
and its two all-reduces' ms by CUDA events, the all-reduce alone after a
barrier, the arena's bytes and the step's ms; one path pass of
``render_sample_sharded``: each rank's wall ms and, under torch.profiler,
its device busy ms apart from NCCL's kernels; the NCCL version.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist

from . import all_reduce, make_mesh, mesh_device, render_batch_sharded, \
    render_sample_sharded, shard_batch
from . import distributed

WORLD = 4
MESHES = ((4, 1), (2, 2))
SEED, TARGET_SEED, LR = 1, 2, 10.0
# each launch's limit in seconds (the one-card reference took 50 s and the
# four ranks 57 s on H100s)
TIMEOUT = {"cuda": 300.0, "cpu": 600.0}
# rtol, atol of each check that is not bit for bit
BATCH_TOL = (1e-6, 1e-6)
LOSS_RTOL = 1e-5
GRAD_TOL = (1e-4, 1e-7)
# arenas the all-reduce alone is timed at (rows of 3 floats): one 1024^2
# texture (12.6 MB) and the production interior's five (62.9 MB)
ARENAS = {"tex1024": 1 << 20, "tex1024x5": 5 << 20}


@dataclasses.dataclass(frozen=True)
class Sizes:
    batch: tuple        # (width, height, samples): the textured sponza
    mixed: tuple        # (width, height): the mixed scene's pass and step
    distributed: tuple  # (width, height, spp): the interior
    kitchen: tuple      # (width, height): the kitchen's step
    n_cells: int        # terrain cells of the sponzas and the mixed scene
    tex_size: int       # the textured sponza's texture size
    depth: int          # max depth of the renders
    step_depth: int     # max depth of the steps
    runs: int           # timed runs a measurement (median)


SIZES = {"cuda": Sizes(batch=(1920, 1080, 8), mixed=(1920, 1080),
                       distributed=(320, 180, 2), kitchen=(400, 266), n_cells=362, tex_size=1024,
                       depth=50, step_depth=50, runs=5),
         "cpu": Sizes(batch=(21, 11, 2), mixed=(20, 12),
                      distributed=(16, 8, 2), kitchen=(16, 8),
                      n_cells=16, tex_size=32, depth=50, step_depth=4,
                      runs=2)}


def _key(mesh):
    """A mesh shape's name: "4x1"."""
    return f"{mesh[0]}x{mesh[1]}"


# --- in each rank -----------------------------------------------------------

def _sync(device_type):
    if device_type == "cuda":
        torch.cuda.synchronize()


def _barrier(device_type):
    if device_type == "cuda":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _wall_ms(fn, device_type, runs):
    """``fn()`` ``runs`` times, each started after a barrier and ended by a
    synchronise: (host ms of each run, the last result)."""
    ms, out = [], None
    for _ in range(runs):
        _barrier(device_type)
        _sync(device_type)
        t0 = time.perf_counter()
        out = fn()
        _sync(device_type)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, out


def _events_ms(parts, runs):
    """Each of ``parts`` (callables run in order on the current stream)
    timed by CUDA events, ``runs`` times after a barrier: a list of ms a
    part, each a list of runs."""
    out = [[] for _ in parts]
    for _ in range(runs):
        _barrier("cuda")
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(parts) + 1)]
        ev[0].record()
        for i, fn in enumerate(parts):
            fn()
            ev[i + 1].record()
        torch.cuda.synchronize()
        for i in range(len(parts)):
            out[i].append(ev[i].elapsed_time(ev[i + 1]))
    return out


def _profile(fn):
    """One ``fn()`` under torch.profiler after a barrier: its wall ms and
    the device's busy ms, NCCL's kernels apart (they wait on the other
    ranks)."""
    from ..profiling import device_kernel_times

    _barrier("cuda")
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = device_kernel_times(prof)
    nccl = sum(us for k, (_, us) in kernels.items() if "nccl" in k.lower())
    busy = sum(us for _, us in kernels.values()) - nccl
    return dict(wall_ms=wall, busy_ms=busy / 1e3, nccl_ms=nccl / 1e3,
                busy_share=busy / 1e3 / wall,
                device_ops=sum(n for n, _ in kernels.values()))


def _digest(t):
    return hashlib.sha256(np.ascontiguousarray(
        t.detach().cpu().numpy()).tobytes()).hexdigest()


def _full(t, rank):
    """``t`` on the CPU on rank 0, None elsewhere (the others send its
    digest)."""
    return t.detach().cpu() if rank == 0 else None


def _device_info(device_type):
    """This rank's card: its index, name and UUID, the backend, NCCL's
    version and whether it reaches each other card's memory directly (peer
    access); the rank and backend alone on the CPU."""
    info = dict(rank=dist.get_rank(), backend=dist.get_backend())
    if device_type == "cuda":
        i = torch.cuda.current_device()
        props = torch.cuda.get_device_properties(i)
        info.update(index=i, name=torch.cuda.get_device_name(i),
                    uuid=str(props.uuid),
                    nccl=".".join(map(str, torch.cuda.nccl.version())),
                    peer_access={j: torch.cuda.can_device_access_peer(i, j)
                                 for j in range(torch.cuda.device_count())
                                 if j != i})
    return info


def _scenes(sz, device):
    """The checks' compiled scenes on ``device``."""
    import solstrale_tpu_torch as T
    from .. import fixtures
    from ..scene.compile import compile_scene

    def cfg(w, h, spp=1):
        return T.RenderConfig(width=w, height=h, samples_per_pixel=spp,
                              seed=SEED)

    bw, bh, _ = sz.batch
    return dict(
        sponza=compile_scene(fixtures.sponza_textured_scene(
            cfg(bw, bh), n_cells=sz.n_cells, tex_size=sz.tex_size),
            device=device),
        mixed=compile_scene(fixtures.mixed_bvh_scene(
            cfg(*sz.mixed), n_cells=sz.n_cells), device=device),
        kitchen=compile_scene(fixtures.kitchen_sink_scene(cfg(*sz.kitchen)),
                              device=device))


def _interior(sz):
    import solstrale_tpu_torch as T
    from .. import fixtures

    w, h, spp = sz.distributed
    return fixtures.sponza_class_scene(T.RenderConfig(
        width=w, height=h, samples_per_pixel=spp, seed=SEED),
        n_cells=sz.n_cells)


def _batch(cs, mesh, sz, device_type):
    """``render_batch_sharded`` of samples 1..n: the image (rank 0; the
    others its digest), the segments and the tiles', each run's ms (after a
    warm-up batch at sample 100, which captures the graphs) and this
    rank's own batch (``shard_batch``) ms."""
    w, h, spp = sz.batch
    kw = dict(width=w, height=h, max_depth=sz.depth)
    render_batch_sharded(cs, 100, spp, SEED, mesh, **kw)
    img, total, per_tile = render_batch_sharded(cs, 1, spp, SEED, mesh,
                                                shard_stats=True, **kw)
    runs_ms, _ = _wall_ms(lambda: render_batch_sharded(
        cs, 1, spp, SEED, mesh, **kw), device_type, sz.runs)
    shard_ms, _ = _wall_ms(lambda: shard_batch(cs, 1, spp, SEED, mesh, **kw),
                           device_type, sz.runs)
    rank = dist.get_rank()
    return dict(image=_full(img, rank), digest=_digest(img),
                segments=int(total), per_tile=per_tile.cpu().tolist(),
                runs_ms=runs_ms, shard_ms=shard_ms)


def _sample(cs, mesh, sz, device_type):
    """``render_sample_sharded`` at sample 1 with the path shader and with
    the simple shader and aux planes: the planes (rank 0; the others their
    digests); the path pass's ms and, on the card, its profile."""
    from ..renderer import integrator

    w, h = sz.mixed
    rank = dist.get_rank()
    out = {}
    for name, shader, aux in (("path", integrator.SHADER_PATH, False),
                              ("simple", integrator.SHADER_SIMPLE, True)):
        planes = render_sample_sharded(
            cs, 1, SEED, mesh, width=w, height=h, max_depth=sz.depth,
            shader_kind=shader, need_aux=aux)
        out[name] = dict(planes=[_full(p, rank) for p in planes],
                         digests=[_digest(p) for p in planes])

    def path_pass():
        return render_sample_sharded(
            cs, 1, SEED, mesh, width=w, height=h, max_depth=sz.depth,
            shader_kind=integrator.SHADER_PATH, need_aux=False)

    out["pass_ms"], _ = _wall_ms(path_pass, device_type, sz.runs)
    out["profile"] = _profile(path_pass) if device_type == "cuda" else None
    return out


def _distributed(scene, n_sample_axis, device_type):
    """``render_distributed``: rank 0's final u8 image and the passes."""
    images = [im for _, im in distributed.render_distributed(
        scene, n_sample_axis=n_sample_axis, device_type=device_type)]
    return dict(image=images[-1], passes=len(images))


def _target(cs, w, h, depth):
    from .. import diff

    with torch.no_grad():
        return diff.render_linear(cs, width=w, height=h, max_depth=depth,
                                  n_samples=1, seed=TARGET_SEED)


def _step(cs, mesh, w, h, sz, device_type, timed):
    """One ``train_step_sharded`` from ``cs``: its loss and new arena; with
    ``timed`` (on the card) also each run's step ms, the replay's and the
    two all-reduces' ms by CUDA events, the all-reduce alone after a
    barrier, the arena's bytes, and the all-reduce alone at the sizes of
    ``ARENAS``."""
    from .. import diff

    target = _target(cs, w, h, sz.step_depth)
    kw = dict(width=w, height=h, max_depth=sz.step_depth, seed=SEED)
    loss, new_cs = diff.train_step_sharded(cs, target, mesh, lr=LR, **kw)
    out = dict(loss=float(loss), arena=new_cs.textures.pixels.cpu())
    if not timed:
        return out
    out["step_ms"], _ = _wall_ms(lambda: diff.train_step_sharded(
        cs, target, mesh, lr=LR, **kw), device_type, sz.runs)
    held = {}

    def replay():
        held["err"], held["grad"] = diff.shard_loss_and_grad(
            cs, target, mesh, **kw)

    def reduce():
        all_reduce(held["err"].reshape(1), mesh)
        all_reduce(held["grad"], mesh)

    out["replay_ms"], out["all_reduce_ms"] = _events_ms((replay, reduce),
                                                        sz.runs)
    out["all_reduce_alone_ms"], = _events_ms(
        (lambda: all_reduce(held["grad"], mesh),), sz.runs)
    out["arena_bytes"] = held["grad"].numel() * held["grad"].element_size()
    for name, rows in ARENAS.items():
        x = torch.zeros((rows, 3), dtype=torch.float32, device=cs.device)
        out[f"all_reduce_{name}_ms"], = _events_ms(
            (lambda: all_reduce(x, mesh),), sz.runs)
    return out


def _shard_steps(cs, w, h, sz):
    """One card's shard steps over the whole image at samples 1 and 2
    (``diff.grad_step``): the error sums and gradients, and the arena."""
    from .. import diff

    target = _target(cs, w, h, sz.step_depth)
    pix = torch.arange(w * h, dtype=torch.int64, device=cs.device)
    valid = torch.ones((w * h, 1), dtype=torch.float32, device=cs.device)
    errs, grads = [], []
    for sample in (1, 2):
        step = diff.grad_step(cs, target, width=w, height=h,
                              max_depth=sz.step_depth, n_samples=1, seed=SEED,
                              pix=pix, sample=sample)
        err, grad = step(cs, target, pix, valid)
        errs.append(float(err))
        grads.append(grad.cpu())
    return dict(errs=errs, grads=grads, arena=cs.textures.pixels.cpu())


def reference(device_type="cuda"):
    """The one-card side (a one-rank group, mesh 1x1): every route as the
    four ranks run it, its measurements at one rank, and the one-card
    functions the routes are held to (``render_sample_batch``,
    ``render_sample`` at samples 1 and 2, the shard steps at samples 1 and
    2). CPU values only."""
    from ..renderer import integrator

    sz = SIZES[device_type]
    mesh = make_mesh(1, 1, device_type)
    scenes = _scenes(sz, mesh_device(mesh))
    w, h, spp = sz.batch
    img, _, _, segs = integrator.render_sample_batch(
        scenes["sponza"], 1, SEED, width=w, height=h, max_depth=sz.depth,
        shader_kind=integrator.SHADER_PATH, need_aux=False, n_samples=spp)
    sample = {}
    sw, sh = sz.mixed
    for name, shader, aux in (("path", integrator.SHADER_PATH, False),
                              ("simple", integrator.SHADER_SIMPLE, True)):
        sample[name] = [[p.cpu() for p in integrator.render_sample(
            scenes["mixed"], s, SEED, width=sw, height=sh, max_depth=sz.depth,
            shader_kind=shader, need_aux=aux)] for s in (1, 2)]
    return dict(
        device=_device_info(device_type),
        batch_image=img.cpu(), batch_segments=int(segs), sample=sample,
        shard_steps={name: _shard_steps(scenes[name], *wh, sz)
                     for name, wh in (("mixed", sz.mixed),
                                      ("kitchen", sz.kitchen))},
        routes=_routes(scenes, mesh, sz, device_type))


def _routes(scenes, mesh, sz, device_type):
    """Every route on ``mesh``, with its measurements."""
    return dict(
        batch=_batch(scenes["sponza"], mesh, sz, device_type),
        sample=_sample(scenes["mixed"], mesh, sz, device_type),
        distributed=_distributed(_interior(sz), mesh.size(1), device_type),
        mixed=_step(scenes["mixed"], mesh, *sz.mixed, sz, device_type,
                    timed=device_type == "cuda"),
        kitchen=_step(scenes["kitchen"], mesh, *sz.kitchen, sz, device_type,
                      timed=False))


def sharded(device_type="cuda"):
    """One of the four ranks: every route on the 4x1 and on the 2x2 mesh.
    CPU values only."""
    sz = SIZES[device_type]
    meshes = {_key(m): make_mesh(*m, device_type) for m in MESHES}
    scenes = _scenes(sz, mesh_device(next(iter(meshes.values()))))
    return dict(device=_device_info(device_type),
                meshes={k: _routes(scenes, m, sz, device_type)
                        for k, m in meshes.items()})


# --- in the launcher --------------------------------------------------------

def _cards():
    """(nvidia-smi's name and power limit of every card, the links between
    them: for ``nvidia-smi topo -m`` and ``nvidia-smi nvlink --status``
    each, its lines, or its exit code and output where it is refused)."""
    def smi(*args):
        p = subprocess.run(["nvidia-smi", *args], capture_output=True,
                           text=True, timeout=60)
        return p.returncode, (p.stdout + p.stderr).strip().splitlines()

    rc, gpus = smi("--query-gpu=name,power.limit", "--format=csv,noheader")
    if rc:
        raise RuntimeError(f"nvidia-smi failed ({rc}): {gpus}")
    links = {}
    for args in (("topo", "-m"), ("nvlink", "--status")):
        rc, out = smi(*args)
        links[" ".join(args)] = out if rc == 0 else dict(exit=rc, output=out)
    return gpus, links


def _close(got, want, rtol, atol):
    """(within tolerance, max abs error) of two CPU tensors."""
    err = float((got - want).abs().max()) if got.numel() else 0.0
    ok = bool(torch.isclose(got, want, rtol=rtol, atol=atol).all())
    return ok, err


def _median_of_max(per_rank_runs):
    """The median over runs of the slowest rank's ms."""
    return statistics.median(max(r) for r in zip(*per_rank_runs))


def _checks(ref, ranks, sz, device_type):
    """The checks: (name, ok, numbers) each."""
    lines = []

    def add(name, ok, **kw):
        lines.append((name, bool(ok), kw))

    devs = [r["device"] for r in ranks]
    add("ranks", [d["rank"] for d in devs] == list(range(WORLD))
        and all(d["backend"] == distributed.BACKENDS[device_type]
                for d in devs + [ref["device"]])
        and len({d.get("index", d["rank"]) for d in devs}) == WORLD
        and len({d.get("uuid", d["rank"]) for d in devs}) == WORLD,
        reference=ref["device"], ranks=devs)
    rb = ref["routes"]["batch"]
    add("batch_one_rank", torch.equal(rb["image"], ref["batch_image"])
        and rb["segments"] == ref["batch_segments"],
        segments=rb["segments"],
        render_sample_batch_segments=ref["batch_segments"])
    for key, n_sample in ((_key(m), m[1]) for m in MESHES):
        rs = [r["meshes"][key] for r in ranks]
        b = [r["batch"] for r in rs]
        ok, err = _close(b[0]["image"], ref["batch_image"], *BATCH_TOL)
        add(f"batch_{key}", ok
            and all(x["digest"] == b[0]["digest"] for x in b)
            and all(x["segments"] == ref["batch_segments"] for x in b)
            and all(sum(x["per_tile"]) == x["segments"] for x in b)
            and all(x["per_tile"] == b[0]["per_tile"] for x in b),
            rtol=BATCH_TOL[0], atol=BATCH_TOL[1], max_abs_err=err,
            segments=[x["segments"] for x in b],
            reference_segments=ref["batch_segments"],
            per_tile=b[0]["per_tile"])
        for shader in ("path", "simple"):
            s1, s2 = ref["sample"][shader]
            want = s1 if n_sample == 1 else [a + c for a, c in zip(s1, s2)]
            s = [r["sample"][shader] for r in rs]
            got = s[0]["planes"]
            add(f"sample_{shader}_{key}",
                all(torch.equal(g, x) for g, x in zip(got, want))
                and all(x["digests"] == s[0]["digests"] for x in s),
                samples=list(range(1, n_sample + 1)),
                max_abs_err=max(float((g - x).abs().max())
                                for g, x in zip(got, want)))
        d = [r["distributed"] for r in rs]
        want = ref["routes"]["distributed"]
        add(f"distributed_{key}",
            np.array_equal(d[0]["image"], want["image"])
            and d[0]["passes"] * n_sample == want["passes"]
            and all(x["image"] is None for x in d[1:]),
            n_sample_axis=n_sample, passes=d[0]["passes"],
            reference_passes=want["passes"],
            max_abs_err=int(np.abs(d[0]["image"].astype(np.int32)
                                   - want["image"].astype(np.int32)).max()))
        for scene, (w, h) in (("mixed", sz.mixed), ("kitchen", sz.kitchen)):
            shard = ref["shard_steps"][scene]
            denom = w * h * 3 * n_sample
            want_loss = sum(shard["errs"][:n_sample]) / denom
            want_grad = sum(shard["grads"][:n_sample]) / denom
            st = [r[scene] for r in rs]
            g_ok, g_err = _close((shard["arena"] - st[0]["arena"]) / LR,
                                 want_grad, *GRAD_TOL)
            add(f"train_{scene}_{key}",
                abs(st[0]["loss"] - want_loss) <= LOSS_RTOL * abs(want_loss)
                and g_ok
                and all(torch.equal(x["arena"], st[0]["arena"]) for x in st),
                samples=list(range(1, n_sample + 1)),
                loss=st[0]["loss"], reference_loss=want_loss,
                losses=[x["loss"] for x in st], loss_rtol=LOSS_RTOL,
                grad_rtol=GRAD_TOL[0], grad_atol=GRAD_TOL[1],
                grad_max_abs_err=g_err,
                grad_max_abs=float(want_grad.abs().max()))
    return lines


def _measurements(ref, ranks, sz):
    """The measurement lines: (name, numbers) each. Host clocks only on
    the CPU."""
    lines = []
    sides = {"1": [ref["routes"]]}
    sides.update({key: [r["meshes"][key] for r in ranks]
                  for key in map(_key, MESHES)})
    w, h, spp = sz.batch
    rates = {}
    for key, rs in sides.items():
        b = [r["batch"] for r in rs]
        batch_ms = _median_of_max([x["runs_ms"] for x in b])
        rates[key] = b[0]["segments"] / batch_ms / 1e3
        tiles = b[0]["per_tile"]
        lines.append((f"batch_rate_{key}", dict(
            scene="sponza_textured", width=w, height=h, samples=spp,
            ranks=len(rs), segments=b[0]["segments"], mrays_per_s=rates[key],
            batch_ms=batch_ms, runs_ms=[x["runs_ms"] for x in b],
            shard_ms=[statistics.median(x["shard_ms"]) for x in b],
            per_tile=tiles, imbalance=max(tiles) / (sum(tiles) / len(tiles)))))
    lines.append(("scaling_efficiency", {
        key: distributed.scaling_efficiency(
            {1: rates["1"], WORLD: rates[key]})[WORLD]
        for key in map(_key, MESHES)}))
    for key, rs in sides.items():
        s = [r["sample"] for r in rs]
        lines.append((f"path_pass_{key}", dict(
            scene="mixed", width=sz.mixed[0], height=sz.mixed[1],
            ranks=len(rs), wall_ms=[statistics.median(x["pass_ms"])
                                    for x in s],
            profile=[x["profile"] for x in s])))
        st = [r["mixed"] for r in rs]
        if "step_ms" in st[0]:
            lines.append((f"step_time_{key}", dict(
                scene="mixed", width=sz.mixed[0], height=sz.mixed[1],
                ranks=len(rs), step_ms=_median_of_max(
                    [x["step_ms"] for x in st]),
                replay_ms=[statistics.median(x["replay_ms"]) for x in st],
                all_reduce_ms=[statistics.median(x["all_reduce_ms"])
                               for x in st],
                all_reduce_alone_ms=[statistics.median(
                    x["all_reduce_alone_ms"]) for x in st],
                arena_bytes=st[0]["arena_bytes"],
                **{f"all_reduce_{k}_ms": [statistics.median(
                    x[f"all_reduce_{k}_ms"]) for x in st] for k in ARENAS},
                **{f"{k}_bytes": rows * 12 for k, rows in ARENAS.items()})))
    return lines


def _need_cards(device_type):
    """On the card: raise unless four cards are visible."""
    if device_type != "cuda":
        return
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < WORLD:
        raise RuntimeError(f"four_card: {WORLD} cards needed, {n} visible "
                           f"(torch.cuda.is_available() is "
                           f"{torch.cuda.is_available()})")


def collect(device_type="cuda"):
    """Both launches: (the reference's result, the four ranks' results, the
    seconds of each launch). On the card it raises unless it sees four
    cards."""
    from .. import native

    _need_cards(device_type)
    if device_type == "cuda":
        native.build()      # the BVH build's library, once, not per rank
    kw = dict(args=(device_type,), device_type=device_type,
              timeout=TIMEOUT[device_type])
    t0 = time.perf_counter()
    ref, = distributed.launch(reference, 1, **kw)
    t1 = time.perf_counter()
    ranks = distributed.launch(sharded, WORLD, **kw)
    return ref, ranks, (t1 - t0, time.perf_counter() - t1)


def report(ref, ranks, device_type="cuda", gpus=("cpu",)):
    """The lines (dicts) of ``collect``'s results: the checks', each with
    ``ok``, then the measurements', each with the cards (``gpus``)."""
    sz = SIZES[device_type]
    gpus = list(gpus)
    out = [dict(four_card=name, ok=ok, gpus=gpus, **kw)
           for name, ok, kw in _checks(ref, ranks, sz, device_type)]
    out += [dict(four_card=name, gpus=gpus, **kw)
            for name, kw in _measurements(ref, ranks, sz)]
    return out


def run(device_type="cuda"):
    """``collect`` and ``report``: prints one JSON line each (the first the
    cards, their links and the launches' seconds) and returns them; raises
    when a check failed, after printing."""
    _need_cards(device_type)
    gpus, links = _cards() if device_type == "cuda" else (["cpu"], None)
    ref, ranks, (t_ref, t_ranks) = collect(device_type)
    out = [dict(four_card="cards", gpus=gpus, links=links,
                device_type=device_type, nccl=ref["device"].get("nccl"),
                reference_s=t_ref, four_ranks_s=t_ranks)]
    out += report(ref, ranks, device_type, gpus)
    for line in out:
        print(json.dumps(line), flush=True)
    failed = [x["four_card"] for x in out if x.get("ok") is False]
    if failed:
        raise AssertionError(f"four_card: {failed} outside tolerance")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device-type", default="cuda",
                   choices=sorted(distributed.BACKENDS))
    run(p.parse_args().device_type)
