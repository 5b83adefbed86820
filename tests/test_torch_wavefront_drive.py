"""trace_queued's two drivers on the CPU. The card driver replays each
pool's ``GRAPH_STEPS`` steps as one CUDA graph and reads the stop test once
a replay; what it relies on is checked here with the eager driver, which is
the CPU path and its plain version:

- the first sample id as a 0-dim tensor (the capture's own scalar) gives
  the queue order and the camera rays of the int form bit for bit;
- the stop test read every K steps (so a pool runs up to K - 1 steps past
  it, and the hand-over to the tail pool moves) gives the image and the
  segments of the step-by-step run bit for bit, on the mixed BVH scene
  (K1-K3's plain versions) and the normal-mapped kitchen (K4's), and stays
  within the tolerance of the JAX package's trace_queued;
- a step and a stop test read nothing back to the host (no item, bool,
  nonzero or boolean-mask indexing), so they can be captured.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import solstrale_tpu as J
import solstrale_tpu_torch as T
from solstrale_tpu.renderer import integrator as JI
from solstrale_tpu.scene.compile import compile_scene as jcompile
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch.renderer import integrator as TI
from solstrale_tpu_torch.scene.compile import compile_scene as tcompile

torch.set_num_threads(2)

SEED = 1
SCENES = {
    "mixed": lambda cfg, api: fixtures.mixed_bvh_scene(cfg, n_cells=16,
                                                       api=api),
    "kitchen": lambda cfg, api: fixtures.kitchen_sink_scene(cfg, api=api),
}
# 32,768 queue entries: a wide pool of 32,768 lanes and a tail pool of
# 4,096, so the hand-over between them can move
W, H, SPP = 128, 64, 4


def _compiled(name, w, h, spp):
    cfg = T.RenderConfig(width=w, height=h, samples_per_pixel=spp, seed=SEED)
    return tcompile(SCENES[name](cfg, T), device="cpu")


@pytest.mark.parametrize("w,h", [(128, 64), (50, 30)])
def test_queue_assignment_tensor_start_is_bit_equal(w, h):
    """A tile-swizzled image and one with no tile: (pixel, sample) of a 0-dim
    int64 sample_start equal the int form's, across sample boundaries."""
    qpos = torch.arange(3 * w * h + 17, dtype=torch.int64)
    for start in (0, 1, 100, 2**31 + 5):
        want = TI.queue_assignment(qpos, w, h, start)
        got = TI.queue_assignment(qpos, w, h, torch.tensor(start))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == torch.int64
            assert torch.equal(a, b)


def test_camera_rays_tensor_sample_is_bit_equal():
    """camera_rays_plain with a 0-dim int64 sample (the draws broadcast it) and
    with per-lane samples from a tensor start equal the int forms."""
    cs = _compiled("mixed", 48, 32, 1)
    pix = torch.arange(48 * 32, dtype=torch.int64)
    want = TI.camera_rays_plain(cs, pix, 7, SEED, 48, 32)
    for sample in (torch.tensor(7), torch.full_like(pix, 7)):
        got = TI.camera_rays_plain(cs, pix, sample, SEED, 48, 32)
        for a, b in zip((*got[0], *got[1]), (*want[0], *want[1])):
            assert torch.equal(a, b)
    _, samp = TI.queue_assignment(pix, 48, 32, torch.tensor(7))
    got = TI.camera_rays_plain(cs, pix, samp, SEED, 48, 32)
    for a, b in zip((*got[0], *got[1]), (*want[0], *want[1])):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def step_by_step():
    """Per scene: the compiled scene and the eager driver's result and
    stats with a stop read after every step, from a tensor sample_start."""
    out = {}
    for name in SCENES:
        cs = _compiled(name, W, H, SPP)
        stats = {}
        color, segs = TI.trace_queued_eager(
            cs, torch.tensor(1), SPP, SEED, width=W, height=H, max_depth=50,
            stats=stats, steps=1)
        out[name] = cs, color, int(segs), stats
    return out


@pytest.mark.parametrize("steps", [3, 8])
@pytest.mark.parametrize("name", list(SCENES))
def test_reads_every_k_steps_keep_image_and_segments(step_by_step, name,
                                                     steps):
    """Reading the stop test every ``steps`` steps moves where the wide pool
    hands over (and adds no-op steps on parked lanes) but not one bit of
    the image or the segment count; one read per ``steps`` steps."""
    cs, want, want_segs, want_stats = step_by_step[name]
    stats = {}
    color, segs = TI.trace_queued_eager(cs, 1, SPP, SEED, width=W, height=H,
                                        max_depth=50, stats=stats,
                                        steps=steps)
    assert torch.equal(color, want)
    assert int(segs) == want_segs
    assert want_stats["tail_lanes"] == stats["tail_lanes"] == 4096
    assert want_stats["host_reads"] == want_stats["iters"]
    assert stats["iters"] == stats["host_reads"] * steps
    assert stats["iters_wide"] % steps == 0
    assert stats["iters_tail"] % steps == 0
    assert 0 <= stats["iters_wide"] - want_stats["iters_wide"] < steps
    assert stats["iters"] >= want_stats["iters"]
    if want_stats["iters_wide"] % steps:
        assert stats["iters_wide"] != want_stats["iters_wide"]


@pytest.mark.parametrize("name", list(SCENES))
def test_k_step_reads_within_jax_tolerance(name, monkeypatch):
    """The eager driver at the card driver's GRAPH_STEPS against the JAX
    package's trace_queued (32x24, 2 spp), with test_torch_render.py's
    tolerances for each scene: the kitchen's segments equal and values
    within 1e-4 (both sides' sweep formulas, the JAX Pallas kernels
    interpreted); the mixed scene's segments within rtol 1e-3 and at most 6
    values (2 pixels) beyond 1e-4 (the JAX CPU BVH intersects with other
    formulas)."""
    if name == "kitchen":
        monkeypatch.setenv("SOLSTRALE_PALLAS", "1")
    w, h, spp = 32, 24, 2
    cfg = dict(width=w, height=h, samples_per_pixel=spp, seed=SEED)
    cj = jcompile(SCENES[name](J.RenderConfig(**cfg), J))
    cs = tcompile(SCENES[name](T.RenderConfig(**cfg), T), device="cpu")
    accum_j, seg_j = JI.trace_queued(cj, None, jnp.int32(1), spp,
                                     jnp.int32(SEED), width=w, height=h,
                                     max_depth=50)
    want = np.asarray(accum_j)
    color, segs = TI.trace_queued_eager(cs, 1, spp, SEED, width=w, height=h,
                                        max_depth=50,
                                        steps=TI.GRAPH_STEPS)
    got = color.numpy()
    assert np.isfinite(got).all() and got.mean() > 0.1
    if name == "kitchen":
        assert int(segs) == int(seg_j)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(int(segs), float(seg_j), rtol=1e-3)
        off = ~np.isclose(got, want, rtol=1e-4, atol=1e-4)
        assert off.sum() <= 6 and off.any(axis=-1).sum() <= 2, off.sum()


def test_trace_queued_takes_the_eager_driver_on_the_cpu(step_by_step):
    """On CPU tensors trace_queued is the eager driver: the same image and
    segments, one stop read a step and no replay."""
    cs, want, want_segs, _ = step_by_step["kitchen"]
    stats = {}
    color, segs = TI.trace_queued(cs, 1, SPP, SEED, width=W, height=H,
                                  max_depth=50, stats=stats)
    assert torch.equal(color, want) and int(segs) == want_segs
    assert stats["replays"] == 0 and stats["host_reads"] == stats["iters"]


class _NoHostReads(TorchDispatchMode):
    """Fails on any op that reads a tensor back to the host or whose output
    shape depends on the data (a sync on the card, and refused inside a
    CUDA graph capture)."""

    BANNED = {"_local_scalar_dense", "nonzero", "is_nonzero", "equal",
              "masked_select", "unique", "_unique", "_unique2",
              "unique_consecutive", "unique_dim", "repeat_interleave",
              "allclose", "argwhere"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.BANNED:
            raise AssertionError(f"host read in a captured region: {name}")
        if name.startswith("index"):
            idx = args[1] if len(args) > 1 else ()
            for i in (idx if isinstance(idx, (list, tuple)) else ()):
                if isinstance(i, torch.Tensor) and i.dtype in (torch.bool,
                                                               torch.uint8):
                    raise AssertionError(f"boolean-mask {name} in a "
                                         "captured region")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", list(SCENES))
def test_captured_region_reads_nothing_back(name):
    """What the card driver captures, a pool's step and its stop test, on
    both pools after a warm-up step, under a dispatch mode that fails on a
    host read; the guard itself catches bool() of a tensor."""
    w, h = 128, 64
    cs = _compiled(name, w, h, 4)
    wf = TI._Wavefront(cs.device, w, h, 50, 4, SEED, None, None, None)
    wf.reset(cs, torch.tensor(1), None)
    wide, tail = wf.pools
    wf.step(cs, wide)
    with _NoHostReads():
        for _ in range(2):
            wf.step(cs, wide)
        wf.stop_test(wide)
    wf.compact()
    with _NoHostReads():
        wf.step(cs, tail)
        wf.stop_test(tail)
        with pytest.raises(AssertionError, match="_local_scalar_dense"):
            bool(wf.go)
