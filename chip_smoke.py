#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``solstrale_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (each prints one line of numbers; a failed phase raises, so the
script exits non-zero):
  0. device: a CUDA card must be present (name and power limit from
     nvidia-smi, torch and CUDA versions);
  1. build: compile the CUDA kernels from ``solstrale_tpu_torch/csrc``;
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, with kernel and plain median times;
  3. main path at full size: ``ray_trace`` on the 262,088-triangle interior
     at 1920x1080 (untextured, the benchmark workload, then with spheres,
     a medium and textures), launch counts read around both renders, and
     ``render_sample_batch`` timed like ``bench.py`` (median of three);
  4. card against CPU and determinism: two small scenes rendered on the
     card and on the CPU, and the card run repeated bit for bit.
The last two lines are the kernels' JSON summary and the result line.
"""
import json
import os
import subprocess
import sys
import time

TOL_T = 1e-5          # hit t, rtol = atol (tests/test_pallas.py:33-35)
TOL_MEDIUM = 1e-4     # medium t, rtol = atol (tests/test_pallas.py:59-61)
SLOT_AGREE = 0.995    # kind/slot agreement on hits (exact ties may differ)


def log(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, reps=5, warmup=2):
    """Median milliseconds of fn() on the card (CUDA events)."""
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


def compare_hits(name, t_k, s_k, t_p, s_p, tol, parked=None):
    """Hit sets equal, t within tol, slots agreeing on SLOT_AGREE of hits.
    Returns the max abs t error over hits."""
    import numpy as np

    t_k, s_k, t_p, s_p = (x.cpu().numpy() for x in (t_k, s_k, t_p, s_p))
    hit_k, hit_p = np.isfinite(t_k), np.isfinite(t_p)
    if not np.array_equal(hit_k, hit_p):
        raise AssertionError(f"{name}: hit sets differ on "
                             f"{int((hit_k != hit_p).sum())} rays")
    if not np.allclose(t_k[hit_p], t_p[hit_p], rtol=tol, atol=tol):
        raise AssertionError(f"{name}: t differs beyond {tol}")
    if hit_p.any():
        agree = float((s_k == s_p)[hit_p].mean())
        if agree < SLOT_AGREE:
            raise AssertionError(f"{name}: slots agree on {agree:.4f} of hits")
    if parked is not None and hit_k[parked].any():
        raise AssertionError(f"{name}: a parked (zero-direction) ray hit")
    return float(np.abs(t_k[hit_p] - t_p[hit_p]).max()) if hit_p.any() else 0.0


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
                 if "registers" in ln or "Compiling entry" in ln]
    log("build", seconds=time.perf_counter() - t0,
        nvcc_seconds=_build.BuildInfo.seconds, ptxas=resources)


def _procedural_tables(device):
    """64 spheres and 1,024 quads + triangles (K2), and a medium box (K3)."""
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


def _bvh_rays(cs, device, n=16384, parked=256):
    """Subsampled 1080p camera rays, cosine bounce rays from their hit
    points, and parked zero-direction rays."""
    import torch
    from solstrale_tpu_torch.geo import INF, soa
    from solstrale_tpu_torch.ops import bvh, rng
    from solstrale_tpu_torch.renderer import integrator

    n_cam = (n - parked) // 2
    pix = torch.linspace(0, 1920 * 1080 - 1, n_cam, device=device).long()
    o, d = integrator._camera_rays(cs, pix, 1, 1, 1920, 1080)
    t, kind, idx = bvh.bvh_closest_hit(cs.kbvh, cs.solids, o, d, 1e-3, INF)
    hit = torch.isfinite(t)
    attrs = integrator.full_hit_attributes(
        cs, o, d, torch.where(hit, t, 0.0), kind, idx, pix, 1, 0, 1)
    r1, r2, _, _ = rng.uniform4(pix, 1, 0, rng.P_COSINE, 1)
    frame = soa.onb_from_w3(attrs["normal"])
    bounce_d = soa.onb_local3(*frame, rng.cosine_direction3(r1, r2))
    bo = soa.where3(hit, attrs["point"], o)
    zeros = torch.zeros(parked, device=device)
    po = tuple(torch.full((parked,), 2.0, device=device) for _ in range(3))
    oo = tuple(torch.cat([a, b, c]) for a, b, c in zip(o, bo, po))
    dd = tuple(torch.cat([a, b, zeros]) for a, b in zip(d, bounce_d))
    parked_mask = torch.zeros(n_cam * 2 + parked, dtype=torch.bool)
    parked_mask[n_cam * 2:] = True
    return oo, dd, parked_mask.numpy()


def phase_kernels(sponza_cs):
    import torch
    from solstrale_tpu_torch.geo import INF, RAY_T_MIN
    from solstrale_tpu_torch.ops import bvh, sweep

    dev = torch.device("cuda")
    out = {}

    # K1 on the full 262,088-triangle kernel BVH
    kb = sponza_cs.kbvh
    o, d, parked = _bvh_rays(sponza_cs, dev)
    t_k, s_k = bvh.bvh_planar_hit(kb, o, d, RAY_T_MIN)
    t_p, s_p = bvh.bvh_planar_hit_plain(kb.prims, o, d, RAY_T_MIN)
    torch.cuda.synchronize()
    err = compare_hits("K1", t_k, s_k, t_p, s_p, TOL_T, parked)
    ms = cuda_ms(lambda: bvh.bvh_planar_hit(kb, o, d, RAY_T_MIN))
    plain_ms = cuda_ms(lambda: bvh.bvh_planar_hit_plain(kb.prims, o, d,
                                                        RAY_T_MIN), reps=3,
                       warmup=1)
    out["K1"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    log("kernel", name="K1 bvh_planar_hit", rays=len(parked),
        prims=int(kb.prims[:, 13].sum().item()), hits=int(
            torch.isfinite(t_k).sum().item()), max_abs_err=err, ms=ms,
        plain_ms=plain_ms)

    # K2 (both modes) and K3 on procedural tables
    cs = _procedural_tables(dev)
    s = cs.solids
    o, d = _random_rays(65536, dev, seed=1, parked=256)
    errs = []
    for mode in (False, True):
        t_k, s_k = sweep.closest_hit(s.sph_table, s.pl_table, o, d,
                                     RAY_T_MIN, INF, spheres_only=mode)
        t_p, s_p = sweep.closest_hit_plain(s.sph_table, s.pl_table, o, d,
                                           RAY_T_MIN, INF, spheres_only=mode)
        errs.append(compare_hits(f"K2 spheres_only={mode}", t_k, s_k, t_p,
                                 s_p, TOL_T))
        ms = cuda_ms(lambda: sweep.closest_hit(
            s.sph_table, s.pl_table, o, d, RAY_T_MIN, INF, spheres_only=mode))
        plain_ms = cuda_ms(lambda: sweep.closest_hit_plain(
            s.sph_table, s.pl_table, o, d, RAY_T_MIN, INF,
            spheres_only=mode), reps=3, warmup=1)
        log("kernel", name="K2 closest_hit", spheres_only=mode, rays=65536,
            spheres=s.sph_table.shape[0], planar=s.pl_table.shape[0],
            max_abs_err=errs[-1], ms=ms, plain_ms=plain_ms)
        if not mode:
            out["K2"] = dict(ms=ms, plain_ms=plain_ms)
    out["K2"]["max_abs_err"] = max(errs)

    med = cs.media[0]
    b = med.boundary
    g = torch.Generator().manual_seed(3)
    t_solid = (torch.rand(65536, generator=g) * 30).to(dev)
    u = torch.rand(65536, generator=g).to(dev)
    args = (b.sph_table, b.pl_table, med.neg_inv_density, o, d, t_solid, u)
    m_k = sweep.medium_hit(*args)
    m_p = sweep.medium_hit_plain(*args)
    torch.cuda.synchronize()
    fin = torch.isfinite(m_p)
    if not torch.equal(torch.isfinite(m_k), fin):
        raise AssertionError("K3: finite sets differ")
    if not torch.allclose(m_k[fin], m_p[fin], rtol=TOL_MEDIUM,
                          atol=TOL_MEDIUM):
        raise AssertionError("K3: medium t differs beyond tolerance")
    err = float((m_k[fin] - m_p[fin]).abs().max().item()) if fin.any() \
        else 0.0
    ms = cuda_ms(lambda: sweep.medium_hit(*args))
    plain_ms = cuda_ms(lambda: sweep.medium_hit_plain(*args), reps=3,
                       warmup=1)
    out["K3"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    log("kernel", name="K3 medium_hit", rays=65536, events=int(fin.sum()),
        max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return out


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
    from solstrale_tpu_torch.ops import bvh, sweep
    from solstrale_tpu_torch.renderer import integrator
    from solstrale_tpu_torch.scene.compile import compile_scene

    w, h = 1920, 1080
    cfg = T.RenderConfig(width=w, height=h, samples_per_pixel=1, seed=1,
                         shader=T.PathTracingShader(50))
    scene = fixtures.sponza_class_scene(cfg)
    mixed = fixtures.mixed_bvh_scene(
        T.RenderConfig(width=w, height=h, samples_per_pixel=1, seed=1),
        n_cells=362)
    wrappers = {"K1": bvh.bvh_planar_hit, "K2": sweep.closest_hit,
                "K3": sweep.medium_hit}
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    image = _final_image(scene, "cuda")
    t_sponza = time.perf_counter() - t0
    k1_sponza = bvh.bvh_planar_hit.launches
    t0 = time.perf_counter()
    image_mixed = _final_image(mixed, "cuda")
    t_mixed = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    for name, img in (("sponza", image), ("mixed", image_mixed)):
        if img is None or img.shape != (h, w, 3):
            raise AssertionError(f"{name}: no final image of shape {(h, w)}")
        if not float(img.mean()) >= 2.0:
            raise AssertionError(f"{name}: black frame (mean u8 "
                                 f"{float(img.mean()):.3f})")
    if k1_sponza <= 0 or min(launches.values()) <= 0:
        raise AssertionError(f"main path missed a kernel: {launches}")

    # one render_sample_batch timed like bench.py: warm up, then time one
    # batch to completion (a scalar checksum forces it)
    cs = compile_scene(scene, device="cuda")
    kw = dict(width=w, height=h, max_depth=50,
              shader_kind=integrator.SHADER_PATH, need_aux=False, n_samples=1)
    float(integrator.render_sample_batch(cs, 100, 1, **kw)[0].sum())
    stats = {}
    times = []
    for _ in range(3):  # the loop is host-bound: report the spread
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        color, _, _, segs = integrator.render_sample_batch(
            cs, 1, 1, stats=stats, **kw)
        checksum = float(color.sum())
        times.append(time.perf_counter() - t0)
        segs = int(segs)
        if not checksum > 0:
            raise AssertionError(f"degenerate render: checksum={checksum}")
    if segs < 2 * w * h:
        raise AssertionError(f"segments {segs} < 2 x pixels")
    dt = sorted(times)[1]
    log("main_path", ray_trace_seconds=t_sponza, mixed_ray_trace_seconds=t_mixed,
        mean_u8=float(image.mean()), mixed_mean_u8=float(image_mixed.mean()),
        launches=launches, k1_launches_sponza=k1_sponza,
        batch_seconds=dt, batch_seconds_all=times, segments=segs,
        segments_per_second=segs / dt,
        iterations=stats["iters"], iterations_wide=stats["iters_wide"],
        iterations_tail=stats["iters_tail"], lanes=stats["lanes"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches


def phase_card_vs_cpu():
    import numpy as np
    import torch
    import solstrale_tpu_torch as T
    from solstrale_tpu_torch import fixtures
    from solstrale_tpu_torch.renderer import integrator
    from solstrale_tpu_torch.scene.compile import compile_scene

    w, h, spp = 64, 48, 2
    kw = dict(width=w, height=h, max_depth=50,
              shader_kind=integrator.SHADER_PATH, need_aux=False,
              n_samples=spp)
    for name, build in (
            ("mixed_bvh_scene", lambda c: fixtures.mixed_bvh_scene(
                c, n_cells=48)),
            ("small_scene", fixtures.small_scene)):
        scene = build(T.RenderConfig(width=w, height=h, seed=1))
        runs = {}
        for dev in ("cuda", "cpu", "cuda"):
            cs = compile_scene(scene, device=dev)
            img, _, _, segs = integrator.render_sample_batch(cs, 1, 1, **kw)
            runs.setdefault(dev, []).append((img.cpu().numpy(), int(segs)))
        (gpu, gseg), (gpu2, gseg2) = runs["cuda"]
        cpu, cseg = runs["cpu"][0]
        if not (np.array_equal(gpu, gpu2) and gseg == gseg2):
            raise AssertionError(f"{name}: repeated card run not bit-identical")
        if abs(gseg - cseg) > 1e-3 * cseg:
            raise AssertionError(f"{name}: segments card {gseg} cpu {cseg}")
        close = np.isclose(gpu, cpu, rtol=1e-3, atol=1e-3).all(axis=-1)
        if close.mean() < 0.999:
            raise AssertionError(f"{name}: only {close.mean():.4f} of pixels "
                                 "agree card vs CPU within 1e-3")
        log("card_vs_cpu", scene=name, segments_card=gseg, segments_cpu=cseg,
            pixels_within_1e3=float(close.mean()),
            max_abs_diff=float(np.abs(gpu - cpu).max()), bit_identical=True)


def main():
    import torch

    phase_device()
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
    launches = phase_main_path()
    phase_card_vs_cpu()

    source = {"K1": ("solstrale_tpu_torch/csrc/bvh.cu",
                     "solstrale_tpu/ops/pallas_bvh.py:104"),
              "K2": ("solstrale_tpu_torch/csrc/sweep.cu",
                     "solstrale_tpu/ops/pallas_sweep.py:55"),
              "K3": ("solstrale_tpu_torch/csrc/sweep.cu",
                     "solstrale_tpu/ops/pallas_sweep.py:220")}
    names = {"K1": "k1_bvh", "K2": "k2_sweep", "K3": "k3_medium"}
    kernels = [dict(name=names[k], route="cuda", source=source[k][0],
                    replaces=source[k][1], launches=launches[k],
                    **timings[k]) for k in ("K1", "K2", "K3")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
