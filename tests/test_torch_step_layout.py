"""The layouts and constants the wavefront step's kernels read
(``ops/step.py``, ``csrc/step.cu``), checked on the CPU: S1's (P,) map from
K1's planar slot to its attribute row against the decode through
``pl_is_tri`` / ``pl_idx`` for every slot of the mixed and sponza fixtures,
and S2's queue arithmetic (``div_magic``, ``regen_constants``) in numpy
uint64 and uint32 arithmetic that mirrors the kernel's steps, against
``q // n_pix``, ``q % n_pix``, ``queue_assignment`` and ``row_of`` at the
edge values of the queue, on an image of every ``_tile_swizzle`` shape;
which scenes' small tables S1 stages; and the repeatable S1 and S2 calls
that the step kernels' timings are made of.
"""
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import solstrale_tpu_torch as T
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch.ops import bvh as TB
from solstrale_tpu_torch.ops import step as S
from solstrale_tpu_torch.renderer import integrator as TI
from solstrale_tpu_torch.scene.compile import KIND_TRIANGLE, compile_scene

torch.set_num_threads(2)

SLOT_SCENES = {
    "mixed": lambda c: fixtures.mixed_bvh_scene(c, n_cells=24),
    "sponza": lambda c: fixtures.sponza_class_scene(c, n_cells=24),
}


@pytest.mark.parametrize("name", list(SLOT_SCENES))
def test_slot_row_map_matches_the_decode(name):
    """``StepTables.pl_row`` at every slot K1 can report (and past both
    ends, clamped as S1 clamps the slot) names the planar row that the
    decode through ``pl_is_tri`` and ``pl_idx`` names: a triangle's after
    the quads."""
    cs = compile_scene(SLOT_SCENES[name](T.RenderConfig(width=8, height=8)),
                       device="cpu")
    tab = S.step_tables(cs)
    n_pl = tab.pln.shape[0]
    assert n_pl > 1000 and tab.pl_row.shape == (n_pl,)
    slots = torch.arange(-3, n_pl + 3, dtype=torch.int32)
    kind, idx = TB.decode_planar_slot(cs.solids, slots)
    want = torch.where(kind == KIND_TRIANGLE, tab.n_q + idx.long(),
                       idx.long()).clamp(0, n_pl - 1)
    got = tab.pl_row[slots.clamp(0, n_pl - 1).long()].long()
    assert torch.equal(got, want)
    assert bool((cs.solids.pl_is_tri[:tab.n_q] == 0).all())


STAGE_SCENES = {
    "kitchen": (fixtures.kitchen_sink_scene, True),
    "many_lights": (lambda c: fixtures.many_light_scene(c, n_cells=8), True),
    "many_materials": (fixtures.many_material_scene, False),
}


@pytest.mark.parametrize("name", list(STAGE_SCENES))
def test_stage_floats_follow_the_limit(name):
    """S1 stages ``StepTables.small`` whole where it fits in
    ``STAGE_MAX_BYTES`` and not at all where it does not: the 64-light
    scene's tables fit, the 576-material room's do not, so the card's
    tests and phase 2c take both routes."""
    build, staged = STAGE_SCENES[name]
    cs = compile_scene(build(T.RenderConfig(width=8, height=8)),
                       device="cpu")
    tab = S.step_tables(cs)
    nbytes = tab.small.numel() * 4
    assert (nbytes <= S.STAGE_MAX_BYTES) == staged
    assert S.stage_floats(tab) == (tab.small.numel() if staged else 0)
    assert S.stage_floats(tab) % 4 == 0


def _umulhi(a, b):
    """The high 64 bits of a * b for uint64 arrays (the card's
    __umul64hi), from 32-bit halves."""
    lo = np.uint64(0xFFFFFFFF)
    s32 = np.uint64(32)
    a_lo, a_hi, b_lo, b_hi = a & lo, a >> s32, b & lo, b >> s32
    p0, p1, p2, p3 = a_lo * b_lo, a_lo * b_hi, a_hi * b_lo, a_hi * b_hi
    mid = (p0 >> s32) + (p1 & lo) + (p2 & lo)
    return p3 + (p1 >> s32) + (p2 >> s32) + (mid >> s32)


def _assignment(q, c, n_pix, width):
    """csrc/step.cu's assignment, step for step: (q / n_pix, the slot, the
    pixel id) for uint64 queue positions ``q`` with the constants ``c``
    (``regen_constants``)."""
    m = np.uint64(c["npix_magic"] % 2 ** 64)
    t = _umulhi(np.full_like(q, m), q)
    qq = (t + ((q - t) >> np.uint64(c["npix_sh1"]))) >> np.uint64(
        c["npix_sh2"])
    u32 = np.uint32
    pslot = q.astype(u32) - qq.astype(u32) * u32(n_pix)
    if not c["swizzle"]:
        return qq, pslot, pslot
    wl, hl = u32(c["tile_wl"]), u32(c["tile_hl"])
    tl = wl + hl
    tile = pslot >> tl
    within = pslot & ((u32(1) << tl) - u32(1))
    tiles_x = u32(width) >> wl
    ty = tile // tiles_x
    tx = tile - ty * tiles_x
    pixel = (((ty << hl) + (within >> wl)) * u32(width) + (tx << wl)
             + (within & ((u32(1) << wl) - u32(1))))
    return qq, pslot, pixel


# images of every tile shape integrator._tile_swizzle picks, and of none
IMAGES = {(32, 32): (64, 64), (32, 16): (96, 48), (32, 8): (1920, 1080),
          (32, 4): (160, 20), (64, 2): (128, 6), None: (100, 10)}


@pytest.mark.parametrize("tile", list(IMAGES), ids=str)
def test_regen_constants_reproduce_the_queue_math(tile):
    """S2's multiply-high division by n_pix and its 32-bit tile math equal
    the torch queue order exactly at the queue's edge values (0, n_pix - 1,
    n_pix, 2**31 +- 1, 2**32 + 1, total_q - 1 of a 1,000-sample queue) and
    at random positions up to 2**40: the sample, the slot, the pixel id
    (``queue_assignment``) and the accumulation row (``row_of``)."""
    width, height = IMAGES[tile]
    n_pix = width * height
    assert TI._tile_swizzle(width, height) == tile
    for side in tile or ():   # the kernel's shifts need powers of two
        assert side & (side - 1) == 0
    wf = types.SimpleNamespace(n_pix=n_pix, swizzle=tile)
    c = S.regen_constants(wf)
    total_q = n_pix * 1000
    edges = [0, 1, n_pix - 1, n_pix, n_pix + 1, 2 ** 31 - 1, 2 ** 31,
             2 ** 31 + 1, 2 ** 32 + 1, total_q - 1]
    rng = np.random.default_rng(n_pix)
    q = np.array(edges + list(rng.integers(0, 2 ** 40, 4000)),
                 dtype=np.uint64)
    qq, pslot, pixel = _assignment(q, c, n_pix, width)
    qt = torch.from_numpy(q.astype(np.int64))
    assert np.array_equal(qq, q // np.uint64(n_pix))
    assert np.array_equal(pslot.astype(np.uint64), q % np.uint64(n_pix))
    want_pixel, want_sample = TI.queue_assignment(qt, width, height)
    assert np.array_equal(pixel.astype(np.int64), want_pixel.numpy())
    assert np.array_equal(qq.astype(np.int64), want_sample.numpy())
    row = qq * np.uint64(n_pix) + pixel.astype(np.uint64)
    image = types.SimpleNamespace(pix=None, n_pix=n_pix)
    full = TI._Wavefront.row_of(image, qt, want_pixel)
    assert np.array_equal(row.astype(np.int64), full.numpy())


@pytest.mark.parametrize("d", [1, 2, 3, 7, 16384, 106400, 518400, 2073600,
                               2 ** 31 - 1, 2 ** 31, 2 ** 32 + 1,
                               2 ** 62 + 3])
def test_div_magic_is_exact(d):
    """``div_magic`` gives q // d for every q it is tried on, near the
    multiples of d and at the ends of the uint64 range, in the kernel's
    steps."""
    m, sh1, sh2 = S.div_magic(d)
    rng = np.random.default_rng(d)
    q = np.concatenate([
        np.array([0, 1, d - 1, d, d + 1, 2 * d - 1, 2 * d, 2 ** 63,
                  2 ** 64 - 1], dtype=np.uint64),
        rng.integers(0, 2 ** 63, 2000, dtype=np.uint64) * np.uint64(2)
        + np.uint64(1)])
    t = _umulhi(np.full_like(q, np.uint64(m % 2 ** 64)), q)
    got = (t + ((q - t) >> np.uint64(sh1))) >> np.uint64(sh2)
    assert np.array_equal(got, q // np.uint64(d))
    with pytest.raises(ValueError):
        S.div_magic(0)


def test_scan_words_follow_the_kernel_block():
    """``scan_words`` counts one status word a block of S2 as
    ``csrc/step.cu`` sizes its block (``kRegenThreads``), and a
    ``_Wavefront`` holds that many for its wide pool, with its ticket and
    launch count at 0."""
    src = (Path(S.__file__).parent.parent / "csrc" / "step.cu").read_text()
    threads = int(re.search(r"constexpr int kRegenThreads = (\d+);",
                            src).group(1))
    assert S.REGEN_THREADS == threads
    assert S.scan_words(1) == 1 and S.scan_words(threads) == 1
    assert S.scan_words(threads + 1) == 2
    wf = TI._Wavefront(torch.device("cpu"), 64, 64, 4, 40, 1, 131072, None,
                       None)
    assert wf.scan_status.shape == (131072 // threads,)
    assert wf.scan_status.dtype == torch.int64
    assert wf.ticket.tolist() == [0, 0]


@pytest.mark.parametrize("name", ["kitchen", "many_materials"])
def test_step_kernel_calls_repeat(name):
    """``wavefront_ab.step_kernel_calls``, which the A/B cells and phase 2c
    time, sets up calls that repeat (on the CPU, the plain versions): S1
    reads copies, so two calls give the same outputs and leave the pool
    alone; S2, with the queue head put back, regenerates the same lanes to
    the same state each call."""
    from solstrale_tpu_torch import wavefront_ab

    build, _ = STAGE_SCENES[name]
    w, h = 32, 16
    cs = compile_scene(build(T.RenderConfig(width=w, height=h)),
                       device="cpu")
    c = wavefront_ab.step_kernel_calls(cs, w, h, 1, 1024, depth=4)
    pool = c["pool"]
    before = [x.clone() for x in pool.tensors()]
    a, b = c["s1"](), c["s1"]()
    for k in ("color",) + S.FLAGS:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(a["color"], c["shaded"]["color"])
    assert all(torch.equal(x, y) for x, y in zip(pool.tensors(), before))
    assert 0 < int(c["terminal"].sum()) < 1024
    c["s2"]()
    once = ([x.clone() for x in pool.tensors()], int(c["wf"].next_q))
    c["s2"]()
    assert int(c["wf"].next_q) == once[1] > 0
    assert all(torch.equal(x, y) for x, y in zip(pool.tensors(), once[0]))
