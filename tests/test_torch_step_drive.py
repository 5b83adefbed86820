"""The wavefront step's kernel wrappers (``ops/step.py``: S1 ``step_shade``,
S2 ``step_regen``) on the CPU, where they run their plain versions: the
dispatch by device, the in-place form the wavefront uses, the refactored
``_Wavefront.step`` against ``step_plain`` bit for bit (every lane
tensor, the accumulation rows, the queue head, the segments) over whole
batches in the full image and in a shard, the packed tables S1 and S2
read (dtype, contiguity, row layout, flag bits against the compiled
scene), the argument names against ``csrc/step.cu``'s enums, and the
differentiable route ``trace`` takes under grad.
"""
import re
from pathlib import Path

import pytest
import torch

import solstrale_tpu_torch as T
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch.ops import bvh as TB
from solstrale_tpu_torch.ops import step as S
from solstrale_tpu_torch.renderer import integrator as TI
from solstrale_tpu_torch.renderer import megakernel
from solstrale_tpu_torch.scene.compile import compile_scene

torch.set_num_threads(2)

W, H, SEED = 32, 24, 1
SCENES = {
    "mixed": lambda c: fixtures.mixed_bvh_scene(c, n_cells=16),
    "sponza_textured": lambda c: fixtures.sponza_textured_scene(
        c, n_cells=16, tex_size=32),
    "many_lights": lambda c: fixtures.many_light_scene(c, n_lights=20,
                                                       n_cells=16),
    "kitchen": fixtures.kitchen_sink_scene,
    "small": fixtures.small_scene,
}


def _cs(name):
    return compile_scene(SCENES[name](T.RenderConfig(
        width=W, height=H, samples_per_pixel=2, seed=SEED)), device="cpu")


def _equal(a, b):
    """Bit-equal tensors, NaN where the other has NaN."""
    if a.is_floating_point():
        return torch.equal(torch.isnan(a), torch.isnan(b)) and \
            torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))
    return torch.equal(a, b)


def _start(cs, n=400):
    """Camera rays of n lanes (every other pixel id, sample 2) with the
    last eighth inactive."""
    pix = torch.arange(n, dtype=torch.int64) * 2 % (W * H)
    sample = torch.full((n,), 2, dtype=torch.int64)
    o, d = TI.camera_rays_plain(cs, pix, sample, SEED, W, H)
    zero = torch.zeros(n)
    active = torch.arange(n) < n - n // 8
    return (o, d, torch.zeros(n, dtype=torch.int32), zero,
            TI.fold_init(zero), pix, sample, SEED, active)


@pytest.mark.parametrize("name", list(SCENES))
def test_path_step_is_the_plain_step_on_the_cpu(name):
    """On CPU tensors path_step (the scene hit, then S1's wrapper) is
    path_step_plain bit for bit over chained steps, and no kernel wrapper
    counts a launch; path_step_plain with the scene hit's plain version
    (K5's plain step) is the same step."""
    cs = _cs(name)
    o, d, bounce, acc_len, fold, pix, sample, seed, active = _start(cs)
    before = (S.step_shade.launches, S.step_regen.launches)
    for _ in range(4):
        args = (o, d, bounce, acc_len, fold, pix, sample, seed, active, 3)
        got = TI.path_step(cs, *args)
        want = TI.path_step_plain(cs, *args)
        plain = TI.path_step_plain(cs, *args, plain=True)
        for k in ("color",) + S.FLAGS:
            assert _equal(got[k], want[k]) and _equal(plain[k], want[k]), k
        for g, w, p in zip(S.lane_arrays(got), S.lane_arrays(want),
                           S.lane_arrays(plain)):
            assert _equal(g, w) and _equal(p, w)
        o, d, bounce, acc_len, fold = (got["o"], got["d"], got["bounce"],
                                       got["acc_len"], got["fold"])
        active = active & ~got["terminal"]
    assert (S.step_shade.launches, S.step_regen.launches) == before


@pytest.mark.parametrize("name", ["mixed", "sponza_textured"])
def test_step_shade_forms(name):
    """S1's wrapper: in place into its own input tensors (the wavefront's
    form, active as (qpos, total_q)) equals new outputs with an active
    mask; K1's planar slot (kind None) equals its decoded (kind, idx); a
    flag left out of ``out`` is not written."""
    cs = _cs(name)
    o, d, bounce, acc_len, fold, pix, sample, seed, active = _start(cs)
    t, kind, idx = TI.step_hit(cs, o, d, pix, sample, bounce, seed)
    decoded = (kind, idx) if kind is not None else \
        TB.decode_planar_slot(cs.solids, idx)
    want = TI.shade_plain(cs, o, d, t, *decoded, bounce, acc_len, fold, pix,
                          sample, seed, active, 4)
    got = S.step_shade(cs, t, kind, idx, o, d, bounce, acc_len, fold, pix,
                       sample, seed, active, 4)
    n = active.shape[0]
    qpos = torch.where(active, torch.arange(n), n + 5)
    state = [x.clone() for x in S.lane_arrays(dict(
        o=o, d=d, bounce=bounce, acc_len=acc_len, fold=fold))]
    A, B, dead = state[8:11], state[11:14], state[14:17]
    out = dict(o=tuple(state[0:3]), d=tuple(state[3:6]), bounce=state[6],
               acc_len=state[7], fold=(tuple(A), tuple(B), tuple(dead),
                                       state[17]),
               color=torch.zeros((n, 3)), terminal=torch.zeros(n, dtype=bool))
    S.step_shade(cs, t, kind, idx, out["o"], out["d"], out["bounce"],
                 out["acc_len"], out["fold"], pix, sample, seed,
                 (qpos, n + 1), 4, out=out)
    for k in ("color",) + S.FLAGS:
        assert _equal(got[k], want[k]), k
    assert _equal(out["color"], want["color"])
    assert _equal(out["terminal"], want["terminal"]) and "miss" not in out
    for g, i, w in zip(S.lane_arrays(got), S.lane_arrays(out),
                       S.lane_arrays(want)):
        assert _equal(g, w) and _equal(i, w)


def _drain(cs, wf, step):
    """Run wf's pools to the end with ``step`` (a _Wavefront method)."""
    def advance(k):
        step(cs, wf.pools[k])
        wf.stop_test(wf.pools[k])

    TI._drain(wf, advance, 1, None, replays=False)
    return wf.result()


@pytest.mark.parametrize("name", list(SCENES))
def test_wavefront_step_matches_step_plain(name):
    """The refactored step (hit, S1 in place, scan, S2) against step_plain
    on two wavefronts of the same queue: S2's reset equals reset_plain,
    then after every step the pool's tensors (queue position, pixel and
    sample ids, lane state), the accumulation rows, the queue head and the
    segments are equal, through the compaction into the tail pool; the
    batch equals trace_queued (the CPU driver) bit for bit."""
    cs = _cs(name)
    kw = (cs.device, W, H, 6, 3, SEED, 512, None, None)
    wk, wp = TI._Wavefront(*kw), TI._Wavefront(*kw)
    wk.reset(cs, 1, None)
    wp.begin(1, None)
    wp.reset_plain(cs, wp.pools[0])
    steps = 0
    for k in range(len(wk.pools)):
        if k:
            wk.compact()
            wp.compact()
        while True:
            for a, b in zip(wk.pools[k].tensors(), wp.pools[k].tensors()):
                assert _equal(a, b), steps
            assert _equal(wk.accum[:wk.total_q], wp.accum[:wp.total_q])
            assert int(wk.next_q) == int(wp.next_q)
            assert int(wk.segments) == int(wp.segments)
            wk.stop_test(wk.pools[k])
            if not bool(wk.go):
                break
            wk.step(cs, wk.pools[k])
            wp.step_plain(cs, wp.pools[k])
            steps += 1
    assert steps > 6 and len(wk.pools) == 1
    got = wk.result()
    want = TI.trace_queued(cs, 1, 3, SEED, width=W, height=H, max_depth=6,
                           lanes=512)
    assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])


def test_wavefront_step_with_a_tail_pool_and_a_shard():
    """A queue long enough for the tail pool (32,768 lanes, 4,096 in the
    tail) and a padded shard of pixel ids (the shard's own row order): the
    refactored step drains to trace_queued_eager's image and segments bit
    for bit."""
    cs = _cs("small")
    kw = dict(width=W, height=H, max_depth=8)
    for n_samples, lanes, pix_ids, n_valid in (
            (48, 32768, None, None),
            (3, 256, torch.arange(W * H - 100, dtype=torch.int64).flip(0),
             W * H - 140)):
        wf = TI._Wavefront(cs.device, W, H, 8, n_samples, SEED, lanes,
                           pix_ids, n_valid)
        wf.reset(cs, 2, pix_ids)
        got = _drain(cs, wf, wf.step)
        want = TI.trace_queued_eager(cs, 2, n_samples, SEED, lanes=lanes,
                                     pix_ids=pix_ids, n_valid=n_valid, **kw)
        assert len(wf.pools) == (2 if pix_ids is None else 1)
        assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])


@pytest.mark.parametrize("name", list(SCENES))
def test_step_tables_layout(name):
    """S1's and S2's tables against the compiled scene: f32 rows padded to
    16 bytes (sph_attr to 8 columns, pl_attr to 28), the materials, texel
    and texture tables as they are, K5's camera and light rows, the four
    small tables as views of one buffer, each from a 16-byte boundary (S1
    stages the buffer whole), the media's phase materials, K1's slot ->
    row map, the quads' count and the feature flag bits; every table
    contiguous on the scene's device and packed once per scene."""
    cs = _cs(name)
    tab = S.step_tables(cs)
    assert S.step_tables(cs) is tab
    s = cs.solids
    for x, dtype in ((tab.cam, torch.float32), (tab.sph, torch.float32),
                     (tab.pln, torch.float32), (tab.mats, torch.float32),
                     (tab.tex_attr, torch.float32),
                     (tab.texels, torch.float32), (tab.lights, torch.float32),
                     (tab.med_mat, torch.int32), (tab.pl_row, torch.int32),
                     (tab.small, torch.float32)):
        assert x.dtype == dtype and x.is_contiguous()
        assert x.device == cs.device
    assert tab.sph.shape == (s.sph_attr.shape[0], 8)
    assert torch.equal(tab.sph[:, :5], s.sph_attr)
    assert not tab.sph[:, 5:].any()
    assert tab.pln.shape == (s.pl_attr.shape[0], 28)
    assert torch.equal(tab.pln[:, :25], s.pl_attr)
    assert not tab.pln[:, 25:].any()
    assert torch.equal(tab.mats, cs.materials.attr)
    assert torch.equal(tab.tex_attr, cs.textures.attr)
    assert torch.equal(tab.texels, cs.textures.pixels)
    assert torch.equal(tab.cam, megakernel.camera_table(cs))
    assert torch.equal(tab.lights, megakernel.light_table(cs))
    assert torch.equal(tab.lights[:, :11], cs.lights.attr)
    base = tab.small.data_ptr()
    ends = []
    for x in (tab.cam, tab.mats, tab.tex_attr, tab.lights):
        off = x.data_ptr() - base
        assert off % 16 == 0 and off >= (ends[-1] if ends else 0)
        ends.append(off + x.numel() * 4)
    assert ends[-1] <= tab.small.numel() * 4 and tab.small.numel() % 4 == 0
    assert tab.med_mat.tolist() == [int(m.mat) for m in cs.media]
    assert tab.pl_row.shape == s.pl_idx.shape
    assert tab.n_q == s.qd_q.shape[0]
    flags = {"blend": S.FLAG_BLEND, "normal_maps": S.FLAG_NORMAL_MAPS,
             "spheres": S.FLAG_SPHERES}
    assert tab.flags == sum(v for k, v in flags.items() if k in cs.features)
    assert S.FLAG_BLEND == megakernel._FLAG_BLEND


def _enum(src, name):
    """{enumerator: value} of a C enum in ``src`` (enumerators are NAME or
    NAME = OTHER + k)."""
    body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
    values, nxt = {}, 0
    for item in (x.strip() for x in body.split(",")):
        if not item:
            continue
        m = re.fullmatch(r"(\w+)(?:\s*=\s*(\w+)\s*\+\s*(\d+))?", item)
        key, base, k = m.groups()
        values[key] = values[base] + int(k) if base else nxt
        nxt = values[key] + 1
    return values


@pytest.mark.parametrize("enum,prefix,names,groups", [
    ("ShadePtr", "SP_", S.SHADE_PTRS, {"SP_IN": "in_o0", "SP_OUT": "out_o0"}),
    ("ShadeInt", "SV_", S.SHADE_INTS, {"SV_PIXEL": "pixel_size",
                                       "SV_SAMPLE": "sample_size",
                                       "SV_SEED": "seed_size"}),
    ("RegenPtr", "RP_", S.REGEN_PTRS, {"RP_POOL": "pool_o0"}),
    ("RegenInt", "RV_", S.REGEN_INTS, {}),
    ("BackPtr", "BP_", S.BACK_PTRS, {"BP_IN": "in_a0",
                                     "BP_G_OUT": "g_out_a0",
                                     "BP_G_IN": "g_in_a0"}),
    ("BackInt", "BV_", S.BACK_INTS, {})])
def test_kernel_argument_names(enum, prefix, names, groups):
    """The wrappers fill the kernels' argument arrays by the names of
    ops/step.py, at the indices csrc/step.cu's enums give them: each
    enumerator is its name's index, a group's first name sits at its
    enumerator, and the arrays are as long as the enums count."""
    src = (Path(S.__file__).parent.parent / "csrc" / "step.cu").read_text()
    values = _enum(src, enum)
    assert values[prefix + "COUNT"] == len(names) == len(set(names))
    for key, value in values.items():
        if key == prefix + "COUNT":
            continue
        want = groups.get(key, key[len(prefix):].lower())
        assert names[value] == want, key
    assert len(S.LANE_ARRAYS) == values.get("SP_OUT", 18) - values.get(
        "SP_IN", 0)


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; any other
    device but CUDA raises."""
    cs = _cs("small")
    o, d, bounce, acc_len, fold, pix, sample, seed, active = _start(cs, 8)
    t = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        S.step_shade(cs, t, t.int(), t.int(), o, d, bounce, acc_len, fold,
                     pix, sample, seed, active, 4)
    wf = TI._Wavefront(torch.device("meta"), W, H, 4, 1, SEED, 8, None, None)
    with pytest.raises(ValueError, match="unsupported device"):
        S.step_regen(cs, wf, wf.pools[0])


def test_trace_takes_the_differentiable_route_under_grad(monkeypatch):
    """trace runs path_step (S1 on the card) whether grad mode is on or
    not, and path_step_grad (S1 with its backward S1B; on the CPU their
    plain versions) only when asked by name, differentiable=True, as
    diff's renders ask; same colors, and the gradient reaches the arena
    through S1B's plain version, once a bounce that shades a lane."""
    cs = _cs("kitchen")
    pix = torch.arange(W * H, dtype=torch.int64)
    _, o, d = TI.camera_rays(cs, pix, W, H, 1, SEED)
    calls = []
    for fn in ("path_step", "path_step_grad", "path_step_plain"):
        orig = getattr(TI, fn)
        monkeypatch.setattr(TI, fn, lambda *a, _f=orig, _n=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    with torch.no_grad():
        plain = TI.trace(cs, o, d, pix, 1, SEED, 6)
    assert set(calls) == {"path_step"}
    calls.clear()
    assert torch.is_grad_enabled()
    assert torch.equal(TI.trace(cs, o, d, pix, 1, SEED, 6), plain)
    assert set(calls) == {"path_step"}
    calls.clear()
    params = cs.textures.pixels.clone().requires_grad_(True)
    from solstrale_tpu_torch import diff
    color = TI.trace(diff.set_texture_params(cs, params), o, d, pix, 1,
                     SEED, 6, differentiable=True)
    assert set(calls) == {"path_step_grad"}
    assert torch.equal(color.detach(), plain)
    backward = S.step_shade_backward_plain
    monkeypatch.setattr(S, "step_shade_backward_plain", lambda *a, **k: (
        calls.append("backward"), backward(*a, **k))[1])
    grad, = torch.autograd.grad(color.sum(), params)
    assert grad.abs().sum() > 0
    assert calls.count("backward") == calls.count("path_step_grad") > 1


def test_needs_grad_reads_the_lanes_and_every_table():
    """S1's guard (``ops.step.needs_grad``): false with grad mode off or
    nothing requiring grad; true for a lane input or any table of the
    scene (the texture arena, the background, a material table) that
    requires grad."""
    import dataclasses

    from solstrale_tpu_torch import diff

    cs = _cs("kitchen")
    o = tuple(torch.zeros(4) for _ in range(3))
    assert not S.needs_grad(cs, o)
    arena = diff.set_texture_params(
        cs, cs.textures.pixels.clone().requires_grad_(True))
    assert S.needs_grad(arena, o)
    with torch.no_grad():
        assert not S.needs_grad(arena, o)
    bg = dataclasses.replace(cs, bg_color=cs.bg_color.clone()
                             .requires_grad_(True))
    assert S.needs_grad(bg, o)
    mats = cs.materials
    field = next(f.name for f in dataclasses.fields(mats)
                 if isinstance(getattr(mats, f.name), torch.Tensor)
                 and getattr(mats, f.name).is_floating_point())
    m = dataclasses.replace(cs, materials=dataclasses.replace(
        mats, **{field: getattr(mats, field).clone().requires_grad_(True)}))
    assert S.needs_grad(m, o)
    assert S.needs_grad(cs, (o[0].clone().requires_grad_(True),) + o[1:])
