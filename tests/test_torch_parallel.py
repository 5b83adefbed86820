"""The port's sharding (``solstrale_tpu_torch.parallel``) on gloo: ranks are
processes spawned by ``parallel.distributed.launch``, each joined with a
timeout, so a hang fails the test. The sharded renders equal the
single-process ones (the RNG is keyed on the pixel id, so any partition
draws the same paths), and the sharded training step equals the JAX
package's on a 2x2 mesh of its CPU devices.
"""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solstrale_tpu as J
import solstrale_tpu_torch as T
from solstrale_tpu import diff as JD
from solstrale_tpu import parallel as JP
from solstrale_tpu.scene.compile import compile_scene as jcompile
from solstrale_tpu_torch import diff as TD
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch import parallel as P
from solstrale_tpu_torch.parallel import distributed as PD
from solstrale_tpu_torch.renderer import integrator as TI
from solstrale_tpu_torch.scene.compile import compile_scene as tcompile
from solstrale_tpu_torch.utils import to_rgb_u8

torch.set_num_threads(2)

SEED = 1
W, H = 40, 16             # 640 pixels: 4 tiles of 160
BW, BH = 21, 11           # 231 pixels: 4 does not divide them
TW, TH, T_DEPTH, LR = 16, 8, 4, 1.0
KW = dict(max_depth=8, shader_kind=0, need_aux=False)
TIMEOUT = 240.0


def _small(w, h, spp=2):
    return fixtures.small_scene(T.RenderConfig(width=w, height=h,
                                               samples_per_pixel=spp,
                                               seed=SEED))


def _textured(api):
    """A quad with a 4x4 random image texture under a sphere light: the
    arena is the parameter the sharded step trains."""
    rng = np.random.default_rng(2)
    tex = api.ImageMap(rng.integers(25, 230, (4, 4, 3), dtype=np.uint8))
    return api.Scene(
        api.Bvh([api.Quad((-2, 0, -2), (4, 0, 0), (0, 0, 4),
                          api.Lambertian(tex)),
                 api.Sphere((0, 60, 0), 20.0,
                            api.DiffuseLight(10, 10, 10))]),
        api.CameraConfig(vertical_fov_degrees=50.0,
                         look_from=(0.0, 3.0, 0.01), look_at=(0, 0, 0)),
        (0.2, 0.2, 0.3),
        api.RenderConfig(width=TW, height=TH, samples_per_pixel=1,
                         seed=SEED))


def _four_ranks():
    """What each of 4 ranks computes, on a 4x1 and a 2x2 mesh."""
    out = {}
    cs = tcompile(_small(W, H), device="cpu")
    cs_b = tcompile(_small(BW, BH), device="cpu")
    cs_t = tcompile(_textured(T), device="cpu")
    for n_tile, n_sample in ((4, 1), (2, 2)):
        mesh = P.make_mesh(n_tile, n_sample, device_type="cpu")
        key = f"{n_tile}x{n_sample}"
        rep = P.replicate_scene(cs, mesh)
        out[f"sample {key}"] = P.render_sample_sharded(
            rep, 5, SEED, mesh, width=W, height=H, **KW)[0]
        out[f"batch {key}"] = P.render_batch_sharded(
            P.replicate_scene(cs_b, mesh), 1, 2, SEED, mesh, width=BW,
            height=BH, max_depth=50, shard_stats=True)
    mesh = P.make_mesh(2, 2, device_type="cpu")
    target = torch.zeros((TW * TH, 3))
    loss, new_cs = TD.train_step_sharded(
        cs_t, target, mesh, width=TW, height=TH, max_depth=T_DEPTH, lr=LR,
        seed=SEED)
    out["train"] = (loss, new_cs.textures.pixels)
    out["rank"] = (mesh.get_local_rank("tile"), mesh.get_local_rank("sample"),
                   PD.initialize())
    return out


def _one_rank():
    """render_distributed's images on a one-rank group."""
    return [img for _, img in PD.render_distributed(
        _small(32, 16), device_type="cpu")]


@pytest.fixture(scope="module")
def ranks():
    return PD.launch(_four_ranks, 4, device_type="cpu", timeout=TIMEOUT)


def test_mesh_rank_order(ranks):
    """Row-major rank order, as the JAX mesh reshapes its devices; inside
    a group initialize() reports (world size, rank)."""
    assert [r["rank"] for r in ranks] == [
        (0, 0, (4, 0)), (0, 1, (4, 1)), (1, 0, (4, 2)), (1, 1, (4, 3))]


def test_tile_sharded_render_equal(ranks):
    """4x1: every rank's assembled image is the single-process
    render_sample, bit for bit."""
    cs = tcompile(_small(W, H), device="cpu")
    single, _, _ = TI.render_sample(cs, 5, SEED, width=W, height=H, **KW)
    for r in ranks:
        assert torch.equal(r["sample 4x1"], single)


def test_tile_and_sample_axes(ranks):
    """2x2: the sample axis renders samples 5 and 6 and sums them."""
    cs = tcompile(_small(W, H), device="cpu")
    s1, _, _ = TI.render_sample(cs, 5, SEED, width=W, height=H, **KW)
    s2, _, _ = TI.render_sample(cs, 6, SEED, width=W, height=H, **KW)
    for r in ranks:
        torch.testing.assert_close(r["sample 2x2"], s1 + s2, rtol=0, atol=0)


@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_batch_sharded_workqueue_equal(ranks, mesh):
    """render_batch_sharded at 21x11 (the last of 4 tiles padded) equals
    the full-image trace_queued; segments exactly, per tile summing to the
    total."""
    cs = tcompile(_small(BW, BH), device="cpu")
    full, segs = TI.trace_queued(cs, 1, 2, SEED, width=BW, height=BH,
                                 max_depth=50)
    full_img = torch.flip(full.reshape(BH, BW, 3), dims=(0,))
    for r in ranks:
        img, total, per_tile = r[f"batch {mesh}"]
        torch.testing.assert_close(img, full_img, rtol=1e-6, atol=1e-6)
        assert int(total) == int(segs)
        assert int(per_tile.sum()) == int(segs)
        assert per_tile.shape == (int(mesh[0]),) and (per_tile > 0).all()


def test_train_step_sharded_matches_jax(ranks):
    """The 2x2 sharded SGD step against the JAX package's on
    make_mesh(2, 2) of four CPU devices: loss and new arena, and every rank
    holds the same update."""
    cj = jcompile(_textured(J))
    mesh = JP.make_mesh(2, 2, jax.devices()[:4])
    loss_j, new_j = JD.train_step_sharded(
        JP.replicate_scene(cj, mesh), jnp.zeros((TW * TH, 3), jnp.float32),
        mesh, width=TW, height=TH, max_depth=T_DEPTH, lr=LR, seed=SEED)
    new_j = np.asarray(new_j.textures.pixels)
    base = ranks[0]["train"]
    for r in ranks:
        assert torch.equal(r["train"][0], base[0])
        assert torch.equal(r["train"][1], base[1])
    np.testing.assert_allclose(float(base[0]), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(base[1].numpy(), new_j, rtol=1e-5, atol=1e-6)
    moved = np.abs(base[1].numpy() - np.asarray(cj.textures.pixels)).max()
    assert moved > 1e-2


def test_initialize_without_group():
    assert PD.initialize() == (1, 0)


@pytest.mark.skipif(torch.cuda.is_available(), reason="tests the CPU-only "
                    "case: without a card the default raises")
def test_launch_defaults_to_the_card():
    """``launch`` runs its ranks on the card (NCCL) unless asked for the
    CPU, like every entry point of ``parallel``: without a card it
    raises before any rank starts."""
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        PD.launch(_one_rank, 1, timeout=TIMEOUT)


def test_render_distributed_one_rank():
    """One gloo rank: the generator yields the progressive u8 images, the
    last one the renderer's sum of both samples."""
    images, = PD.launch(_one_rank, 1, device_type="cpu",
                        timeout=TIMEOUT)
    assert len(images) == 2 and images[-1].shape == (16, 32, 3)
    cs = tcompile(_small(32, 16), device="cpu")
    total = sum(TI.render_sample(cs, s, SEED, width=32, height=16,
                                 **{**KW, "max_depth": 50})[0]
                for s in (1, 2))
    np.testing.assert_array_equal(images[-1], to_rgb_u8(total, 2).numpy())


def test_scaling_efficiency():
    eff = PD.scaling_efficiency({1: 100.0, 4: 360.0})
    assert eff[1] == 1.0 and abs(eff[4] - 0.9) < 1e-9


def test_full_image_route_unchanged():
    """trace_queued without pix_ids on the sponza-class fixture (8 cells,
    below the BVH threshold, so the queue code dominates the CPU time) at
    128x64x4, 32,768 queue entries, so the wide pool and the tail pool both
    run: the image (its sha256), segments and iteration counts are those
    the route gave before it took pix_ids (one stop-test read a step, no
    graph replay on the CPU), and the shard route over every pixel id gives
    the same image and segments."""
    w, h, spp = 128, 64, 4
    cs = tcompile(fixtures.sponza_class_scene(T.RenderConfig(
        width=w, height=h, samples_per_pixel=spp, seed=SEED), n_cells=8),
        device="cpu")
    stats = {}
    color, segs = TI.trace_queued(cs, 1, spp, SEED, width=w, height=h,
                                  max_depth=50, stats=stats)
    assert hashlib.sha256(color.numpy().tobytes()).hexdigest().startswith(
        "485f2c63cd940f3f")
    assert int(segs) == 70624
    assert stats == dict(iters=20, iters_wide=3, iters_tail=17, lanes=32768,
                         tail_lanes=4096, host_reads=20, replays=0)
    pix = torch.arange(w * h, dtype=torch.int64)
    shard, segs_s = TI.trace_queued(cs, 1, spp, SEED, width=w, height=h,
                                    max_depth=50, pix_ids=pix)
    assert torch.equal(shard, color) and int(segs_s) == int(segs)
