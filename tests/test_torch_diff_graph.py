"""The inverse step as the card captures it (``diff._GradStep``), on the
CPU. On the card ``image_and_texture_grad`` and each rank's loss and
gradient in ``train_step_sharded`` replay one CUDA graph of
``_GradStep.run`` per scene geometry and key; on the CPU the same ``run``
is called directly. Checked here:

- ``run`` (the forward, the checkpointed chunks of the fixed trip and
  ``autograd.grad``) reads nothing back to the host after a warm-up
  step, so it can be captured;
- the step gives the loss and gradient of the eager code it replaced bit
  for bit, and JAX's ``image_and_texture_grad`` within
  tests/test_torch_diff.py's tolerances;
- consecutive calls with other arenas give their own gradients (nothing
  leaks through the fixed tensors);
- an SGD loop through ``set_texture_params`` finds one cached step, and
  a scene whose tables are other tensors raises;
- ``train_step_sharded`` on a one-rank gloo group equals the eager
  sharded step bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solstrale_tpu as J
import solstrale_tpu_torch as T
from solstrale_tpu import diff as JD
from solstrale_tpu.scene.compile import compile_scene as jcompile
from solstrale_tpu_torch import diff as TD
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch import parallel as P
from solstrale_tpu_torch.parallel import distributed as PD
from solstrale_tpu_torch.renderer import integrator as TI
from solstrale_tpu_torch.scene.compile import compile_scene as tcompile
from test_torch_wavefront_drive import _NoHostReads

torch.set_num_threads(2)

W, H, DEPTH, SEED = 32, 16, 8, 1
SCENES = {
    "mixed": lambda cfg, api: fixtures.mixed_bvh_scene(cfg, n_cells=8,
                                                       api=api),
    "kitchen": lambda cfg, api: fixtures.kitchen_sink_scene(cfg, api=api),
}
KW = dict(width=W, height=H, max_depth=DEPTH, n_samples=1, seed=SEED)


def _compile(name, api=T, w=W, h=H):
    cfg = api.RenderConfig(width=w, height=h, samples_per_pixel=1,
                           seed=SEED)
    scene = SCENES[name](cfg, api)
    return jcompile(scene) if api is J else tcompile(scene, device="cpu")


def _target(cs, w=W, h=H, depth=DEPTH):
    with torch.no_grad():
        return TD.render_linear(cs, width=w, height=h, max_depth=depth,
                                n_samples=1, seed=2)


def _eager(cs, target, *, width, height, max_depth, n_samples, seed):
    """image_and_texture_grad as the port ran it before the step was
    captured: the plain version of a replay."""
    params = cs.textures.pixels.detach().requires_grad_(True)
    with torch.enable_grad():
        img = TD.render_linear(TD.set_texture_params(cs, params),
                               width=width, height=height,
                               max_depth=max_depth, n_samples=n_samples,
                               seed=seed)
        loss = torch.mean((img - target.reshape(-1, 3)) ** 2)
        grad, = torch.autograd.grad(loss, params)
    return loss.detach(), grad


def _steps(cs, shard=False):
    """The distinct cached inverse steps of ``cs``, of full images or of
    shards (the key's shard shape, its next to last item, set)."""
    return {id(v) for (sid, name), v in TI._PER_SCENE.items()
            if sid == id(cs) and isinstance(name, tuple)
            and name[0] == TI.GRAD_STEP and (name[-2] is not None) == shard}


@pytest.fixture(scope="module")
def scenes():
    """Per scene: the compiled scene and its target (seed 2)."""
    out = {}
    for name in SCENES:
        cs = _compile(name)
        out[name] = cs, _target(cs)
    return out


@pytest.mark.parametrize("name", list(SCENES))
def test_run_reads_nothing_back(scenes, name):
    """After a warm-up step, the captured body (forward, checkpointed
    chunks, autograd.grad) runs under a dispatch mode that fails on a host
    read; the guard catches a planted .item() in the forward."""
    cs, target = scenes[name]
    step = TD.grad_step(cs, target, **KW)
    step(cs, target)
    step.load(cs, target)
    with _NoHostReads():
        step.run()
    assert torch.isfinite(step.grad).all() and float(step.loss) > 0

    render = TD.render_linear

    def planted(*args, **kw):
        img = render(*args, **kw)
        img.sum().item()
        return img

    TD.render_linear = planted
    try:
        with _NoHostReads(), pytest.raises(AssertionError,
                                           match="_local_scalar_dense"):
            step.run()
    finally:
        TD.render_linear = render


@pytest.mark.parametrize("name", list(SCENES))
def test_run_reads_nothing_back_on_a_fresh_scene(name):
    """The same on a scene compiled for the step alone, whose target comes
    from elsewhere: nothing of the scene was packed before the step's
    warm-up, and the differentiable trace's scene copy (``grad_scene``)
    packs nothing in the captured body either (a pack of the media tables
    reads back to the host, which fails a capture)."""
    cs = _compile(name)
    target = torch.from_numpy(np.random.default_rng(6).uniform(
        size=(W * H, 3)).astype(np.float32))
    step = TD.grad_step(cs, target, **KW)
    step(cs, target)
    step.load(cs, target)
    with _NoHostReads():
        step.run()
    assert torch.isfinite(step.grad).all() and float(step.loss) > 0


@pytest.mark.parametrize("depth", [DEPTH, 5])
@pytest.mark.parametrize("name", list(SCENES))
def test_step_equals_eager_bit_for_bit(scenes, name, depth):
    """image_and_texture_grad (the cached step's ``__call__``) and the
    step's ``eager`` give the eager code's loss and gradient bit for bit, at
    depth 8 (two checkpointed chunks of 4 and the cap step) and depth 5
    (five chunks of 1)."""
    cs, target = scenes[name]
    kw = dict(KW, max_depth=depth)
    want = _eager(cs, target, **kw)
    got = TD.image_and_texture_grad(cs, target, **kw)
    again = TD.grad_step(cs, target, **kw).eager(cs, target)
    for loss, grad in (got, again):
        assert not loss.requires_grad and not grad.requires_grad
        assert torch.equal(loss, want[0]) and torch.equal(grad, want[1])
    assert torch.isfinite(got[1]).all() and (got[1] != 0).any()


@pytest.mark.parametrize("name", ["mixed", "kitchen"])
def test_step_matches_jax(name, monkeypatch):
    """The step at 16x8, depth 4, against the JAX package's jitted
    image_and_texture_grad: the loss to rtol 1e-5, the gradient to
    tests/test_torch_diff.py's rtol 1e-3, atol 1e-4 on the entries where
    JAX's is finite (the kitchen's has NaN rows, ROADMAP C)."""
    if name == "kitchen":
        monkeypatch.setenv("SOLSTRALE_PALLAS", "1")
    w, h, depth = 16, 8, 4
    cj, ct = _compile(name, J, w, h), _compile(name, T, w, h)
    target = _target(ct, w, h, depth)
    kw = dict(width=w, height=h, max_depth=depth, n_samples=1, seed=SEED)
    loss_j, g_j = JD.image_and_texture_grad(
        cj, jnp.asarray(target.numpy()), **kw)
    step = TD.grad_step(ct, target, **kw)
    step.load(ct, target)
    step.run()
    assert float(step.loss) > 0 and torch.isfinite(step.grad).all()
    np.testing.assert_allclose(float(step.loss), float(loss_j), rtol=1e-5)
    g_j = np.asarray(g_j)
    ok = np.isfinite(g_j)
    assert ok.mean() > 0.99
    np.testing.assert_allclose(step.grad.numpy()[ok], g_j[ok], rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("name", list(SCENES))
def test_consecutive_arenas_give_their_own_gradients(scenes, name):
    """Three calls in a row on one cached step with arenas a, b, a: each
    equals the eager step of its own arena, and the returned tensors are
    not the step's fixed outputs."""
    cs, target = scenes[name]
    a = cs.textures.pixels
    b = torch.flip(a, dims=(0,)) * 0.75
    arenas = (a, b, a)
    got = [TD.image_and_texture_grad(TD.set_texture_params(cs, p), target,
                                     **KW) for p in arenas]
    step = TD.grad_step(cs, target, **KW)
    for (loss, grad), p in zip(got, arenas):
        want = _eager(TD.set_texture_params(cs, p), target, **KW)
        assert torch.equal(loss, want[0]) and torch.equal(grad, want[1])
        assert grad.data_ptr() != step.grad.data_ptr()
    assert not torch.equal(got[0][1], got[1][1])


def test_sgd_loop_finds_one_step_and_changed_geometry_raises(scenes):
    """Three SGD steps through set_texture_params from a newly compiled
    scene: every scene of the loop holds the one step of the first (a new
    scene each step, one cache entry), the arenas equal the eager loop's
    bit for bit; a copy sharing
    the cache whose tables are other tensors raises, and a scene copied
    without sharing builds its own step."""
    _, target = scenes["kitchen"]
    # compiled afresh: the tables the scene caches on first use appear
    # during the first step
    cs = _compile("kitchen")
    lr = 0.3
    p, q = cs, cs
    seen = set()
    for _ in range(3):
        _, g = TD.image_and_texture_grad(p, target, **KW)
        seen |= _steps(p)
        p = TD.set_texture_params(p, p.textures.pixels - lr * g)
        _, g_e = _eager(q, target, **KW)
        q = TD.set_texture_params(q, q.textures.pixels - lr * g_e)
    assert len(seen) == 1 and _steps(p) == seen
    assert torch.equal(p.textures.pixels, q.textures.pixels)
    assert not torch.equal(p.textures.pixels, cs.textures.pixels)

    cam = dataclasses.replace(p.camera, origin=p.camera.origin + 0.5)
    moved = dataclasses.replace(p, camera=cam)
    TI.share_geometry_tables(p, moved)
    assert _steps(moved) == seen
    with pytest.raises(ValueError, match="not the tensors"):
        TD.image_and_texture_grad(moved, target, **KW)
    own = dataclasses.replace(p, camera=cam)
    loss, g = TD.image_and_texture_grad(own, target, **KW)
    assert len(_steps(own)) == 1 and _steps(own) != seen
    want = _eager(own, target, **KW)
    assert torch.equal(loss, want[0]) and torch.equal(g, want[1])


def _eager_sharded(cs, target, mesh, *, width, height, max_depth, lr, seed):
    """train_step_sharded as the port ran it before the step was
    captured."""
    n_pix = width * height
    ids, _ = P.tile_ids(n_pix, mesh)
    valid = (ids < n_pix).to(torch.float32)[:, None]
    pix = torch.clamp(ids, max=n_pix - 1)
    tgt = target.reshape(-1, 3)[pix]
    params = cs.textures.pixels.detach().requires_grad_(True)
    with torch.enable_grad():
        color, _, _ = TI.render_pixels(
            TD.set_texture_params(cs, params), pix,
            1 + mesh.get_local_rank("sample"), seed, width=width,
            height=height, max_depth=max_depth,
            shader_kind=TI.SHADER_PATH, need_aux=False, early_exit=False,
            differentiable=True)
        err = torch.sum((color - tgt) ** 2 * valid)
        grad, = torch.autograd.grad(err, params)
    loss = P.all_reduce(err.detach().reshape(1), mesh)[0]
    grad = P.all_reduce(grad, mesh)
    denom = n_pix * 3 * mesh.size(1)
    return loss / denom, params.detach() - lr * grad / denom


def test_train_step_sharded_equals_eager_on_one_rank(scenes, tmp_path):
    """On a one-rank gloo group: two sharded SGD steps (the second on the
    first's scene, which shares its cached step) equal the eager sharded
    step bit for bit, through one shard step held by both scenes."""
    cs, target = scenes["mixed"]
    PD.initialize(f"file://{tmp_path / 'store'}", 1, 0, "cpu")
    try:
        mesh = P.make_mesh(1, 1, device_type="cpu")
        kw = dict(width=W, height=H, max_depth=DEPTH, lr=10.0, seed=SEED)
        p, q = cs, cs.textures.pixels
        for _ in range(2):
            loss, p_next = TD.train_step_sharded(p, target, mesh, **kw)
            want_loss, q = _eager_sharded(TD.set_texture_params(cs, q),
                                          target, mesh, **kw)
            assert torch.equal(loss, want_loss)
            assert torch.equal(p_next.textures.pixels, q)
            shard = _steps(p, shard=True)
            p = p_next
        assert len(shard) == 1 and _steps(p, shard=True) == shard
    finally:
        torch.distributed.destroy_process_group()
