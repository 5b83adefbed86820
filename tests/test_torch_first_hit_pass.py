"""The first-hit sample loops (``integrator.first_hit_pass``): a debug
shader's samples and the aux planes of a batch, summed in sample order.
On the CPU: ``render_sample_batch`` against the JAX package's (jitted),
the eager driver against the per-sample loops it replaced, the card
driver with its capture run eagerly, the captured region's host reads and
the routes. On the card, in the ``cuda`` tests, which skip without one:
the driver's CUDA graph against the eager driver, its launches, its reuse
and the autograd route. On a GPU machine (no JAX needed), from the repo
root:

    python -m pytest --noconftest -m cuda tests/test_torch_first_hit_pass.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

import solstrale_tpu_torch as T
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch.ops import first_hit as FH
from solstrale_tpu_torch.renderer import integrator as TI
from solstrale_tpu_torch.scene.compile import compile_scene

torch.set_num_threads(2)

W, H, SEED, START, N = 32, 24, 1, 2, 3
TOL = dict(rtol=1e-4, atol=1e-4)
SCENES = {
    # a normal map, a medium, spheres, quad and triangle lights (the first
    # hit's scene hit K4; the path color K5)
    "kitchen": lambda cfg, api=None: fixtures.kitchen_sink_scene(cfg,
                                                                  api=api),
    # a medium, a blend floor, a normal-mapped terrain, two spheres and the
    # room's quad light (the BVH route, K1-K3)
    "mixed16": lambda cfg, api=None: fixtures.mixed_bvh_scene(
        cfg, n_cells=16, api=api),
}
DEBUG = (TI.SHADER_ALBEDO, TI.SHADER_NORMAL, TI.SHADER_SIMPLE)
# (shader_kind, need_aux) of render_sample_batch: each debug shader with
# and without the aux planes, and the path shader with them
BATCHES = [(k, a) for k in DEBUG for a in (False, True)] + [
    (TI.SHADER_PATH, True)]
# (shader_kind, aux) of first_hit_pass: a debug shader with and without
# the aux planes, and the aux planes alone
PASSES = [(k, a) for k in DEBUG for a in (False, True)] + [(None, True)]
_COMPILED = {}


def _compiled(name, device="cpu", w=W, h=H):
    key = (name, str(device), w, h)
    if key not in _COMPILED:
        _COMPILED[key] = compile_scene(SCENES[name](T.RenderConfig(
            width=w, height=h, seed=SEED)), device=device)
    return _COMPILED[key]


def _bits(x):
    return x.contiguous().view(torch.int32)


def _same_bits(a, b):
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


def _old_loop(cs, pix, sample_start, shader_kind, aux, n_samples, w=W,
              h=H):
    """render_sample_batch's per-sample loops before the first-hit pass: a
    debug shader's samples (render_pixels' route: CR, then the planes of
    one scene hit and one FH launch) or, with no shader, the aux planes'
    (CR, then first_hit_aux), each plane added onto a zero plane in
    sample order."""
    zero = torch.zeros((pix.shape[0], 3), dtype=torch.float32,
                       device=pix.device)
    color = albedo = normal = zero
    for i in range(n_samples):
        _, o, d = TI.camera_rays(cs, pix, w, h, sample_start + i, SEED)
        if shader_kind is None:
            a, n = TI.first_hit_aux(cs, o, d, pix, sample_start + i, SEED)
        else:
            planes = TI.first_hit_planes(cs, o, d, pix, sample_start + i,
                                         SEED, shader_kind, aux=aux)
            color = color + planes["color"]
            a, n = planes["albedo"], planes["normal"]
        if aux:
            albedo, normal = albedo + a, normal + n
    return color, albedo, normal


@pytest.mark.parametrize("shader,aux", BATCHES)
@pytest.mark.parametrize("name", list(SCENES))
def test_render_sample_batch_matches_jax(name, shader, aux, monkeypatch):
    """render_sample_batch (3 samples from sample 2) against the JAX
    package's, jitted on the CPU: every plane within rtol = atol = 1e-4,
    mixed16's with at most 6 values and 2 pixels off,
    tests/test_torch_first_hit.py's limit for it; the segments equal. The
    kitchen and mixed16's path batch run with SOLSTRALE_PALLAS=1 (the JAX
    package's Pallas kernels, interpreted), so that both sides intersect
    with the same formulas; mixed16's debug batches on JAX's XLA path,
    whose BVH formulas differ from the port's in the last bits of t (its
    path batch there ends one segment short: tests/test_torch_render.py)."""
    import jax.numpy as jnp

    import solstrale_tpu as J
    from solstrale_tpu.renderer import integrator as JI
    from solstrale_tpu.scene.compile import compile_scene as jcompile

    if name == "kitchen" or shader == TI.SHADER_PATH:
        monkeypatch.setenv("SOLSTRALE_PALLAS", "1")
    cj = jcompile(SCENES[name](J.RenderConfig(width=W, height=H, seed=SEED),
                               J))
    kw = dict(width=W, height=H, max_depth=50, shader_kind=shader,
              need_aux=aux, n_samples=N)
    want = JI.render_sample_batch(cj, jnp.int32(START), jnp.int32(SEED),
                                  **kw)
    got = TI.render_sample_batch(_compiled(name), START, SEED, **kw)
    assert int(got[3]) == int(want[3])
    if shader != TI.SHADER_PATH:
        assert int(got[3]) == W * H * N
    for k, (g, w) in enumerate(zip(got[:3], want[:3])):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == (H, W, 3) and np.isfinite(g).all()
        assert (np.abs(g).sum() > 0) == (k == 0 or aux), k
        if name == "kitchen":
            np.testing.assert_allclose(g, w, **TOL)
        else:
            off = ~np.isclose(g, w, **TOL)
            assert off.sum() <= 6 and off.any(axis=-1).sum() <= 2, off.sum()


@pytest.mark.parametrize("shader,aux", PASSES)
@pytest.mark.parametrize("name", list(SCENES))
def test_eager_driver_equals_per_sample_loop(name, shader, aux):
    """first_hit_pass_eager (the CPU's route and the body the card's graph
    holds) gives the old per-sample loops' planes bit for bit: 3 samples
    from sample 2 over the whole image and over a shuffled subset of the
    pixel ids (None: the whole image's, in id order)."""
    cs = _compiled(name)
    kw = dict(width=W, height=H, shader_kind=shader, aux=aux, n_samples=N)
    whole = torch.arange(W * H)
    subset = torch.from_numpy(np.random.default_rng(3).permutation(W * H)[
        :500])
    for pix in (whole, subset):
        got = TI.first_hit_pass_eager(cs, pix, START, SEED, **kw)
        want = _old_loop(cs, pix, START, shader, aux, N)
        assert _same_bits(got, want)
        assert float(got[1].abs().sum() > 0) == float(aux)
        assert float(got[0].abs().sum() > 0) == float(shader is not None)
    assert _same_bits(TI.first_hit_pass_eager(cs, None, START, SEED, **kw),
                      _old_loop(cs, whole, START, shader, aux, N))


@pytest.mark.parametrize("shader,aux", [(TI.SHADER_NORMAL, False),
                                        (TI.SHADER_SIMPLE, True),
                                        (None, True)])
@pytest.mark.parametrize("name", list(SCENES))
def test_render_sample_batch_routes(name, shader, aux, monkeypatch):
    """render_sample_batch takes one first_hit_pass a batch for a debug
    shader (its aux planes from the same call) and one for the path
    shader's aux planes, with no pixel ids (the whole image); its planes
    are the eager driver's, flipped to image rows."""
    cs = _compiled(name)
    calls = []
    real = TI.first_hit_pass

    def counted(*a, **k):
        calls.append((a[1], k["shader_kind"], k["aux"], k["n_samples"]))
        return real(*a, **k)

    monkeypatch.setattr(TI, "first_hit_pass", counted)
    kind = TI.SHADER_PATH if shader is None else shader
    got = TI.render_sample_batch(cs, START, SEED, width=W, height=H,
                                 max_depth=4, shader_kind=kind,
                                 need_aux=aux, n_samples=N)
    assert calls == [(None, shader, aux, N)]
    want = TI.first_hit_pass_eager(cs, None, START, SEED, width=W, height=H,
                                   shader_kind=shader, aux=aux, n_samples=N)
    first = 1 if shader is None else 0
    for g, w in zip(got[first:3], want[first:]):
        assert torch.equal(_bits(g), _bits(TI.to_image(w, W, H)))


def test_render_pixels_routes(monkeypatch):
    """render_pixels with a debug shader takes first_hit_pass of one sample
    where autograd records nothing (grad mode off, or on with no table
    requiring grad), and the eager route through CR's and FH's autograd
    Functions where a table requires grad in grad mode; both give the
    same planes, and only the eager route has a gradient."""
    cs = _compiled("kitchen")
    calls = []
    real = TI.first_hit_pass

    def counted(*a, **k):
        calls.append(k["n_samples"])
        return real(*a, **k)

    monkeypatch.setattr(TI, "first_hit_pass", counted)
    pix = torch.arange(W * H)
    kw = dict(width=W, height=H, max_depth=50,
              shader_kind=TI.SHADER_SIMPLE, need_aux=True)
    assert torch.is_grad_enabled()
    got = TI.render_pixels(cs, pix, START, SEED, **kw)
    with torch.no_grad():
        off = TI.render_pixels(cs, pix, START, SEED, **kw)
    assert calls == [1, 1]
    arena = cs.textures.pixels.detach().clone().requires_grad_(True)
    leaf = dataclasses.replace(cs, textures=dataclasses.replace(
        cs.textures, pixels=arena))
    with torch.no_grad():
        TI.render_pixels(leaf, pix, START, SEED, **kw)
    assert calls == [1, 1, 1]
    planes = TI.render_pixels(leaf, pix, START, SEED, **kw)
    assert calls == [1, 1, 1]
    assert all(p.requires_grad for p in planes)
    assert all(torch.equal(a, b) and torch.equal(a, c.detach())
               for a, b, c in zip(got, off, planes))
    g, = torch.autograd.grad(sum(p.sum() for p in planes), [arena])
    assert bool((g != 0).any())


class _EagerCapture:
    """The card driver's capture calls made eager: capture_counted keeps
    the function, each replay calls it, the warm-up runs it. Counts the
    replays."""

    def __init__(self, monkeypatch):
        self.replays = []
        monkeypatch.setattr(TI, "warm_up", lambda dev, fn: fn())
        monkeypatch.setattr(TI, "capture_counted",
                            lambda fn, pool=None: (fn, None))
        monkeypatch.setattr(TI, "replay_counted", self.replay)

    def replay(self, fn, counts):
        self.replays.append(fn)
        fn()


@pytest.mark.parametrize("shader,aux", [(TI.SHADER_ALBEDO, True),
                                        (None, True),
                                        (TI.SHADER_NORMAL, False)])
@pytest.mark.parametrize("name", list(SCENES))
def test_card_driver_on_cpu(name, shader, aux, monkeypatch):
    """_FirstHitPass with its capture run eagerly: one driver, an int and a
    one-element tensor first sample, the whole image's ids (None) and
    others, each batch one replay equal to first_hit_pass_eager's planes
    bit for bit, the sample and the ids written into the driver's own
    tensors, and planes that the next batch does not overwrite."""
    cap = _EagerCapture(monkeypatch)
    cs = _compiled(name)
    kw = dict(width=W, height=H, shader_kind=shader, aux=aux, n_samples=N)
    driver = TI._FirstHitPass(cs, W * H, W, H, SEED, shader, aux, N)
    flipped = torch.arange(W * H).flip(0)
    batches = []
    for sample, pix in ((START, None), (torch.tensor([5]), None),
                        (START, flipped), (torch.tensor(START), None)):
        cap.replays.clear()
        got = driver.run(pix, sample)
        want = TI.first_hit_pass_eager(cs, pix, sample, SEED, **kw)
        assert _same_bits(got, want)
        assert len(cap.replays) == 1
        assert int(driver.sample) == int(sample)
        assert torch.equal(driver.pix, torch.arange(W * H) if pix is None
                           else pix)
        assert got[1].data_ptr() != driver.planes[1].data_ptr()
        batches.append(got)
    assert driver.replays == 4
    assert _same_bits(batches[0], batches[3])
    k = 1 if aux else 0
    assert not torch.equal(batches[0][k], batches[1][k])
    assert torch.equal(batches[2][k], batches[0][k].flip(0))
    with pytest.raises(ValueError, match="one-element"):
        driver.run(None, torch.tensor([1, 2]))


@pytest.mark.parametrize("shader,aux", [(TI.SHADER_SIMPLE, True),
                                        (None, True),
                                        (TI.SHADER_NORMAL, False)])
@pytest.mark.parametrize("name", list(SCENES))
def test_captured_region_reads_nothing_back(name, shader, aux):
    """What the card driver's graph holds, the eager driver's loop from a
    0-dim sample tensor, under a dispatch mode that fails on a host read,
    after a warm-up pass (as the driver captures after one: a scene's
    packed tables are made on their first use); the guard itself catches
    a read."""
    from test_torch_wavefront_drive import _NoHostReads

    cs = _compiled(name)
    pix = torch.arange(W * H)
    kw = dict(width=W, height=H, shader_kind=shader, aux=aux, n_samples=N)
    warm = TI.first_hit_pass_eager(cs, pix, torch.tensor(9), SEED, **kw)
    with _NoHostReads():
        planes = TI.first_hit_pass_eager(cs, pix, torch.tensor(START), SEED,
                                         **kw)
        with pytest.raises(AssertionError, match="_local_scalar_dense"):
            bool(planes[1].any())
    assert float(planes[1].abs().sum() > 0) == float(aux)
    assert not torch.equal(planes[1 if aux else 0], warm[1 if aux else 0])


def test_first_hit_pass_on_cpu_is_the_eager_driver():
    """On the CPU first_hit_pass is first_hit_pass_eager, and no table
    requiring grad makes it raise there."""
    cs = _compiled("mixed16")
    kw = dict(width=W, height=H, shader_kind=TI.SHADER_SIMPLE, aux=True,
              n_samples=N)
    assert _same_bits(TI.first_hit_pass(cs, None, START, SEED, **kw),
                      TI.first_hit_pass_eager(cs, None, START, SEED, **kw))


# --- on the card -----------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launches():
    from solstrale_tpu_torch import bench

    wrappers = bench.kernel_wrappers()
    wrappers.update(CRB=FH.camera_rays_backward, FHB=FH.first_hit_backward)
    return {k: f.launches for k, f in wrappers.items()}


def _since(before):
    now = _launches()
    return {k: now[k] - before[k] for k in now}


def _drivers(cs):
    return [v for (sid, key), v in list(TI._PER_SCENE.items())
            if sid == id(cs) and isinstance(key, tuple)
            and key[0] == TI.FIRST_HIT_PASS]


@pytest.mark.cuda
@pytest.mark.parametrize("n_samples", [1, N])
@pytest.mark.parametrize("shader,aux", PASSES)
@pytest.mark.parametrize("name", list(SCENES))
def test_graph_matches_eager_driver(cuda, name, shader, aux, n_samples):
    """One replay of the first-hit pass's graph against the eager driver on
    the card, every plane bit for bit; a replay launches CR, the scene hit
    (K4, or K1 with K2 and K3 on mixed16) and FH once a sample, no draw
    kernel and no step kernel, as the eager driver does."""
    cs = _compiled(name, cuda)
    kw = dict(width=W, height=H, shader_kind=shader, aux=aux,
              n_samples=n_samples)
    TI.first_hit_pass(cs, None, START + 7, SEED, **kw)
    driver = TI._PER_SCENE[id(cs), (TI.FIRST_HIT_PASS, W * H, W, H, SEED,
                                    shader, aux, n_samples)]
    replays = driver.replays
    before = _launches()
    got = TI.first_hit_pass(cs, None, START, SEED, **kw)
    graphed = _since(before)
    assert driver.replays == replays + 1
    before = _launches()
    want = TI.first_hit_pass_eager(cs, None, START, SEED, **kw)
    eager = _since(before)
    assert driver.replays == replays + 1
    assert _same_bits(got, want)
    assert graphed == eager
    hits = ("K4",) if cs.kbvh is None else ("K1", "K2", "K3")
    assert all(graphed[k] == n_samples for k in ("CR", "FH") + hits)
    assert graphed["draw"] == graphed["S1"] == graphed["S2"] == 0
    assert float(got[1].abs().sum() > 0) == float(aux)


@pytest.mark.cuda
def test_another_sample_start_reuses_the_capture(cuda):
    """Other first samples (an int, a 0-dim and a one-element tensor) and
    other pixel ids replay one capture, each equal to its eager pass; a
    second seed and another n_samples capture graphs of their own;
    render_sample_batch and render_pixels replay the same drivers (a scene
    compiled for this test alone, so that no other test's drivers
    count)."""
    cs = compile_scene(SCENES["mixed16"](T.RenderConfig(
        width=W, height=H, seed=SEED)), device=cuda)
    kw = dict(width=W, height=H, shader_kind=TI.SHADER_SIMPLE, aux=True,
              n_samples=N)
    flipped = torch.arange(W * H, device=cuda).flip(0)
    outs = []
    for sample, pix in ((START, None), (torch.tensor(9, device=cuda), None),
                        (torch.tensor([START], device=cuda), flipped),
                        (START, None)):
        got = TI.first_hit_pass(cs, pix, sample, SEED, **kw)
        assert _same_bits(got, TI.first_hit_pass_eager(cs, pix, sample,
                                                       SEED, **kw))
        outs.append(got)
    assert len(_drivers(cs)) == 1 and _drivers(cs)[0].replays == 4
    assert _same_bits(outs[0], outs[3])
    assert not torch.equal(outs[0][0], outs[1][0])
    TI.first_hit_pass(cs, None, START, SEED + 1, **kw)
    TI.first_hit_pass(cs, None, START, SEED, **{**kw, "n_samples": 1})
    assert len(_drivers(cs)) == 3
    batch = TI.render_sample_batch(cs, START, SEED, width=W, height=H,
                                   max_depth=50, shader_kind=TI.SHADER_SIMPLE,
                                   need_aux=True, n_samples=N)
    assert all(torch.equal(a, TI.to_image(b, W, H))
               for a, b in zip(batch, outs[0]))
    assert int(batch[3]) == W * H * N
    pix = torch.arange(W * H, device=cuda)
    one = TI.render_pixels(cs, pix, START, SEED, width=W, height=H,
                           max_depth=50, shader_kind=TI.SHADER_SIMPLE,
                           need_aux=True)
    assert len(_drivers(cs)) == 3
    assert sum(d.replays for d in _drivers(cs)) == 4 + 1 + 1 + 1 + 1
    assert _same_bits(one, TI.first_hit_pass_eager(
        cs, pix, START, SEED, **{**kw, "n_samples": 1}))


@pytest.mark.cuda
def test_grad_route_keeps_crb_and_fhb(cuda):
    """A texture arena that requires grad (grad mode on) sends
    render_pixels' debug route through CR's and FH's autograd Functions,
    eagerly: CR 1 and FH 1 in the forward, no replay, one FHB in the
    backward, the planes equal to the graph's; first_hit_pass itself
    raises there."""
    cs = _compiled("kitchen", cuda)
    arena = cs.textures.pixels.detach().clone().requires_grad_(True)
    leaf = dataclasses.replace(cs, textures=dataclasses.replace(
        cs.textures, pixels=arena))
    pix = torch.arange(W * H, device=cuda)
    kw = dict(width=W, height=H, max_depth=50,
              shader_kind=TI.SHADER_SIMPLE, need_aux=True)
    graphed = TI.render_pixels(cs, pix, START, SEED, **kw)
    before = _launches()
    planes = TI.render_pixels(leaf, pix, START, SEED, **kw)
    fwd = _since(before)
    assert (fwd["CR"], fwd["FH"], fwd["CRB"], fwd["FHB"]) == (1, 1, 0, 0)
    assert not _drivers(leaf)
    before = _launches()
    g, = torch.autograd.grad(sum(p.sum() for p in planes), [arena])
    back = _since(before)
    assert (back["FHB"], back["CRB"], back["FH"], back["CR"]) == (1, 0, 0, 0)
    assert bool((g != 0).any())
    assert all(torch.equal(a, b.detach()) for a, b in zip(graphed, planes))
    with pytest.raises(ValueError, match="builds no autograd graph"):
        TI.first_hit_pass(leaf, pix, START, SEED, width=W, height=H,
                          shader_kind=TI.SHADER_SIMPLE, aux=True,
                          n_samples=1)
