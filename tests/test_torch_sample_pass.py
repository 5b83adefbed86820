"""The path shader's sample pass (``integrator.sample_pass``): the fixed
trip its card graph holds against the per-bounce loop of the early exit,
the carry past the depth cap, ``render_sample`` against the JAX
package's, the graph's region's host reads, and the card driver with its
capture run eagerly, on the CPU; the card driver's CUDA graph against the
eager routes in the ``cuda`` tests, which skip without a card. On a GPU
machine (no JAX needed), from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_sample_pass.py -q
"""
import numpy as np
import pytest
import torch

import solstrale_tpu_torch as T
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch.renderer import integrator as TI
from solstrale_tpu_torch.scene.compile import compile_scene

torch.set_num_threads(2)

W, H, DEPTH, SEED = 64, 48, 50, 1
SCENES = {
    # the BVH route (K1-K3 on the card)
    "mixed": lambda cfg, api=None: fixtures.mixed_bvh_scene(
        cfg, n_cells=16, api=api),
    # the fused scene hit (K4 on the card)
    "kitchen": lambda cfg, api=None: fixtures.kitchen_sink_scene(cfg,
                                                                  api=api),
}
DEPTHS = (2, 3, 4, 8, DEPTH)
_COMPILED = {}
_LOOP = {}


def _compiled(name, device="cpu", seed=SEED):
    key = (name, str(device), seed)
    if key not in _COMPILED:
        _COMPILED[key] = compile_scene(SCENES[name](T.RenderConfig(
            width=W, height=H, seed=seed)), device=device)
    return _COMPILED[key]


def _rays(cs, sample=1):
    pix = torch.arange(W * H, device=cs.device)
    _, o, d = TI.camera_rays(cs, pix, W, H, sample, SEED)
    return pix, o, d


def _leaves(tree):
    """The tensors of a tuple tree (trace's carry) in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for part in tree for x in _leaves(part)]


def _per_bounce_loop(cs, o, d, pix, sample, seed, max_depth):
    """The early exit as one loop of path_step, the alive test read before
    every bounce: trace's route before the sample pass had a graph.
    Returns (color, bounces run)."""
    sample = torch.full(pix.shape, sample, dtype=torch.int64)
    zero = torch.zeros_like(o[0])
    bounce = torch.zeros(pix.shape, dtype=torch.int32)
    alive = torch.ones(pix.shape, dtype=torch.bool)
    color = torch.zeros((zero.shape[0], 3))
    fold, acc_len, n = TI.fold_init(zero), zero, 0
    for _ in range(max_depth + 1):
        if not bool(alive.any()):
            break
        st = TI.path_step(cs, o, d, bounce, acc_len, fold, pix, sample, seed,
                          alive, max_depth, color)
        o, d, bounce, acc_len, fold, alive, color = (
            st["o"], st["d"], st["bounce"], st["acc_len"], st["fold"],
            st["alive"], st["color"])
        n += 1
    return color, n


def _loop(name, depth=DEPTH):
    if (name, depth) not in _LOOP:
        cs = _compiled(name)
        pix, o, d = _rays(cs)
        _LOOP[name, depth] = _per_bounce_loop(cs, o, d, pix, 1, SEED, depth)
    return _LOOP[name, depth]


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("name", list(SCENES))
def test_fixed_trip_equals_per_bounce_loop(name, depth):
    """The card graph's bounces, ``depth + 1`` of them from trace's first
    carry with no read, give the per-bounce loop's color bit for bit, as
    does trace's early exit, at depths whose loop stops early or runs
    every bounce."""
    cs = _compiled(name)
    pix, o, d = _rays(cs)
    want, n = _loop(name, depth)
    assert 1 <= n <= depth + 1 and float(want.sum()) > 0
    lanes = TI._lanes(1, pix)
    carry = TI._bounces(cs, TI._trace_carry(o, d, pix), pix, lanes, SEED,
                        depth, depth + 1)
    assert torch.equal(carry[6], want)
    assert torch.equal(TI.trace(cs, o, d, pix, 1, SEED, depth), want)


@pytest.mark.parametrize("name", list(SCENES))
def test_bounces_past_the_depth_change_nothing(name):
    """After max_depth + 1 bounces no lane is alive, and more bounces leave
    the whole carry bit for bit: the color, the parked rays, the counters
    and the fold."""
    cs = _compiled(name)
    pix, o, d = _rays(cs)
    lanes = TI._lanes(1, pix)
    carry = TI._bounces(cs, TI._trace_carry(o, d, pix), pix, lanes, SEED,
                        DEPTH, DEPTH + 1)
    assert not bool(carry[5].any())
    assert torch.equal(carry[6], _loop(name)[0])
    more = TI._bounces(cs, carry, pix, lanes, SEED, DEPTH, 3)
    for a, b in zip(_leaves(carry), _leaves(more)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(SCENES))
def test_render_sample_matches_jax(name, monkeypatch):
    """render_sample with the aux planes against the JAX package's, run as
    its own CPU tests run it (the kitchen with SOLSTRALE_PALLAS=1, its
    Pallas kernels interpreted; the mixed scene on its XLA path):
    rtol = atol = 1e-4 with at most 6 values and 2 pixels of a plane off,
    tests/test_torch_render.py's limit for the mixed scene, whose BVH
    formulas differ from the port's in the last bits of t. Measured at
    64x48: the kitchen 1 color value and 3 normal values (one pixel), the
    mixed scene 1 normal value."""
    import jax.numpy as jnp

    import solstrale_tpu as J
    from solstrale_tpu.renderer import integrator as JI
    from solstrale_tpu.scene.compile import compile_scene as jcompile

    if name == "kitchen":
        monkeypatch.setenv("SOLSTRALE_PALLAS", "1")
    cj = jcompile(SCENES[name](J.RenderConfig(width=W, height=H, seed=SEED),
                               J))
    kw = dict(width=W, height=H, max_depth=DEPTH, shader_kind=TI.SHADER_PATH,
              need_aux=True)
    want = JI.render_sample(cj, jnp.int32(1), jnp.int32(SEED), **kw)
    got = TI.render_sample(_compiled(name), 1, SEED, **kw)
    assert got[0].shape == (H, W, 3) and float(got[0].mean()) > 0.1
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        off = ~np.isclose(g, w, rtol=1e-4, atol=1e-4)
        assert off.sum() <= 6 and off.any(axis=-1).sum() <= 2, off.sum()
        assert np.isfinite(g).all()


@pytest.mark.parametrize("name,need_aux", [("mixed", False),
                                           ("kitchen", True)])
def test_captured_region_reads_nothing_back(name, need_aux):
    """What the card driver's graph holds, CR, the fixed trip's bounces and
    with ``need_aux`` the aux planes, under a dispatch mode that fails on a
    host read (depth 4); the guard itself catches trace's early exit."""
    from test_torch_wavefront_drive import _NoHostReads

    cs = _compiled(name)
    pix = torch.arange(W * H)
    sample = torch.tensor(1)
    with _NoHostReads():
        _, o, d = TI.camera_rays(cs, pix, W, H, sample, SEED)
        carry = TI._bounces(cs, TI._trace_carry(o, d, pix), pix,
                            TI._lanes(sample, pix), SEED, 4, 5)
        planes = TI._aux_planes(cs, o, d, pix, sample, SEED, carry[6],
                                need_aux)
        with pytest.raises(AssertionError, match="_local_scalar_dense"):
            TI.trace(cs, o, d, pix, sample, SEED, 4)
    assert float(carry[6].sum()) > 0
    assert float(planes[0].abs().sum() > 0) == float(need_aux)


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


@pytest.mark.parametrize("name,need_aux", [("mixed", False),
                                           ("kitchen", True)])
def test_card_driver_on_cpu(name, need_aux, monkeypatch):
    """_SamplePass with its capture run eagerly (depth 8): two samples (an
    int and a one-element tensor) from one driver, each one replay, equal to
    sample_pass_eager's planes bit for bit, the ids and the sample written
    into the driver's own tensors, and planes that the next pass does not
    overwrite."""
    cap = _EagerCapture(monkeypatch)
    cs = _compiled(name)
    pix = torch.arange(W * H)
    kw = dict(width=W, height=H, max_depth=8, need_aux=need_aux)
    driver = TI._SamplePass(cs, W * H, W, H, 8, SEED, need_aux)
    passes = []
    for sample in (1, torch.tensor([2])):
        cap.replays.clear()
        got = driver.run(pix, sample)
        want = TI.sample_pass_eager(cs, pix, sample, SEED, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert float(got[0].sum()) > 0
        assert float(got[1].abs().sum() > 0) == float(need_aux)
        assert len(cap.replays) == 1
        assert int(driver.sample) == int(sample)
        assert got[0].data_ptr() != driver.planes[0].data_ptr()
        passes.append(got)
    assert driver.replays == 2
    assert not torch.equal(passes[0][0], passes[1][0])
    with pytest.raises(ValueError, match="one-element"):
        driver.run(pix, torch.tensor([1, 2]))


def test_sample_pass_routes():
    """render_pixels takes sample_pass on the path shader with early exit;
    on the CPU that is sample_pass_eager, and it equals the fixed trip
    (early_exit=False) bit for bit."""
    cs = _compiled("kitchen")
    pix = torch.arange(W * H)
    kw = dict(width=W, height=H, max_depth=4, need_aux=True)
    got = TI.render_pixels(cs, pix, 1, SEED, shader_kind=TI.SHADER_PATH,
                           **kw)
    eager = TI.sample_pass_eager(cs, pix, 1, SEED, **kw)
    fixed = TI.render_pixels(cs, pix, 1, SEED, shader_kind=TI.SHADER_PATH,
                             early_exit=False, **kw)
    for a, b, c in zip(got, eager, fixed):
        assert torch.equal(a, b) and torch.equal(a, c)


# --- on the card -----------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launches():
    from solstrale_tpu_torch import bench

    return {k: f.launches for k, f in bench.kernel_wrappers().items()}


def _since(before):
    now = _launches()
    return {k: now[k] - before[k] for k in now}


def _drivers(cs):
    return [v for (sid, key), v in list(TI._PER_SCENE.items())
            if sid == id(cs) and isinstance(key, tuple)
            and key[0] == TI.SAMPLE_PASS]


@pytest.mark.cuda
@pytest.mark.parametrize("need_aux", [False, True])
@pytest.mark.parametrize("name", list(SCENES))
def test_graph_matches_eager_routes(cuda, name, need_aux):
    """render_pixels' graphed pass (one replay) against the eager fixed
    trip (early_exit=False) and the eager early exit (sample_pass_eager)
    on the card, bit for bit, each plane: the replay's launches equal the
    fixed trip's (S1 max_depth + 1, the first hit kernel as many plus FH's
    hit; CR 1; FH 1 with the aux planes), the early exit's S1 at most as
    many."""
    cs = _compiled(name, cuda)
    pix = torch.arange(W * H, device=cuda)
    kw = dict(width=W, height=H, max_depth=DEPTH, need_aux=need_aux)
    path = TI.SHADER_PATH
    TI.render_pixels(cs, pix, 5, SEED, shader_kind=path, **kw)
    driver = TI._PER_SCENE[id(cs), (TI.SAMPLE_PASS, W * H, W, H, DEPTH,
                                    SEED, need_aux)]
    replays = driver.replays
    before = _launches()
    got = TI.render_pixels(cs, pix, 1, SEED, shader_kind=path, **kw)
    graphed = _since(before)
    assert driver.replays == replays + 1
    before = _launches()
    fixed = TI.render_pixels(cs, pix, 1, SEED, shader_kind=path,
                             early_exit=False, **kw)
    fixed_launches = _since(before)
    before = _launches()
    early = TI.sample_pass_eager(cs, pix, 1, SEED, **kw)
    early_launches = _since(before)
    assert driver.replays == replays + 1
    for a, b, c in zip(got, fixed, early):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert graphed == fixed_launches
    hit = "K1" if cs.kbvh is not None else "K4"
    aux = 1 if need_aux else 0
    assert graphed["S1"] == graphed[hit] - aux == DEPTH + 1
    assert (graphed["CR"], graphed["FH"], graphed["draw"]) == (1, aux, 0)
    assert 1 <= early_launches["S1"] == early_launches[hit] - aux <= DEPTH + 1


@pytest.mark.cuda
def test_two_samples_and_seeds_from_their_captures(cuda):
    """Two samples replay one capture, each equal to its eager pass (and
    the two different); a second seed captures a graph of its own and
    equals its eager pass; render_sample's image is the pass flipped."""
    cs = _compiled("mixed", cuda)
    pix = torch.arange(W * H, device=cuda)
    kw = dict(width=W, height=H, max_depth=DEPTH, need_aux=False)
    out, captures = {}, []
    for sample, seed in ((1, SEED), (2, SEED), (1, SEED + 1)):
        got = TI.sample_pass(cs, pix, sample, seed, **kw)[0]
        captures.append(len(_drivers(cs)))
        want = TI.sample_pass_eager(cs, pix, sample, seed, **kw)[0]
        assert torch.equal(got, want)
        out[sample, seed] = got
    assert captures[1] == captures[0] and captures[2] == captures[1] + 1
    assert not torch.equal(out[1, SEED], out[2, SEED])
    assert not torch.equal(out[1, SEED], out[1, SEED + 1])
    img = TI.render_sample(cs, 2, SEED, shader_kind=TI.SHADER_PATH, **kw)[0]
    assert torch.equal(img, TI.to_image(out[2, SEED], W, H))


@pytest.mark.cuda
def test_other_scene_tables_get_their_own_capture(cuda):
    """A scene copy with another texture arena (diff.set_texture_params)
    and another scene at the same key (the solid kitchen-sink scene) get
    captures of their own: each pass equals its own scene's eager pass,
    not the first scene's, which replays as before."""
    from solstrale_tpu_torch import diff

    cs = _compiled("kitchen", cuda)
    pix = torch.arange(W * H, device=cuda)
    kw = dict(width=W, height=H, max_depth=DEPTH, need_aux=True)
    first = TI.sample_pass(cs, pix, 1, SEED, **kw)
    dark = diff.set_texture_params(cs, cs.textures.pixels * 0.25)
    fresh = compile_scene(fixtures.kitchen_sink_solid_scene(
        T.RenderConfig(width=W, height=H, seed=SEED)), device=cuda)
    for other in (dark, fresh):
        got = TI.sample_pass(other, pix, 1, SEED, **kw)
        want = TI.sample_pass_eager(other, pix, 1, SEED, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert not torch.equal(got[0], first[0])
        assert len(_drivers(other)) == 1
    again = TI.sample_pass(cs, pix, 1, SEED, **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.cuda
def test_sample_pass_raises_where_autograd_needs_a_graph(cuda):
    """Grad mode on with nothing requiring grad stays on the graph; a
    table that requires grad raises before any capture."""
    from solstrale_tpu_torch import diff

    cs = _compiled("kitchen", cuda)
    pix = torch.arange(W * H, device=cuda)
    kw = dict(width=W, height=H, max_depth=DEPTH, need_aux=False)
    assert torch.is_grad_enabled()
    TI.sample_pass(cs, pix, 1, SEED, **kw)
    assert sum(d.replays for d in _drivers(cs)) >= 1
    leaf = diff.set_texture_params(
        cs, cs.textures.pixels.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="builds no autograd graph"):
        TI.sample_pass(leaf, pix, 1, SEED, **kw)
    assert not _drivers(leaf)
