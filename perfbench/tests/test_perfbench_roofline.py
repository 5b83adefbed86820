"""The yardstick's frozen counts equal the program's own at a tiny size on
the CPU: the bound (``wavefront_ab.bound_ms``), K5's and the sweeps'
operations (``chip_smoke.k5_flops``, ``sweep_flops``). These tests import
the program; the benchmark's runs do not."""
import sys

import pytest

from perfbench import roofline

from .conftest import ROOT

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.mark.parametrize("nbytes,flops", [(3.35e9, 1e9), (1e6, 67e9),
                                          (0, 0), (12345678, 9876543)])
def test_bound_equals_the_programs(nbytes, flops):
    from solstrale_tpu_torch.wavefront_ab import bound_ms

    ms, by = bound_ms(nbytes, flops)
    s, by2 = roofline.bound_s(nbytes, flops)
    assert by == by2 and s * 1e3 == pytest.approx(ms, rel=1e-12)


def test_constants_equal_the_programs():
    import chip_smoke as cs

    for name in ("FLOPS_SPHERE", "FLOPS_PLANAR", "MEDIUM_INV",
                 "MEDIUM_BOX", "MEDIUM_EVENT", "K5_SEGMENT", "K5_PATH",
                 "K5_HIT", "K5_BLEND", "K5_PDF", "K5_BASIC",
                 "K5_NORMAL_MAP", "K5_LIGHT"):
        assert getattr(roofline, name) == getattr(cs, name), name
    for n_sph, n_pl in ((0, 0), (3, 141), (64, 4096)):
        assert roofline.sweep_flops(n_sph, n_pl) == cs.sweep_flops(n_sph,
                                                                   n_pl)


@pytest.mark.parametrize("normal_map", (True, False))
def test_k5_flops_equal_the_programs(normal_map):
    import chip_smoke as cs
    import solstrale_tpu_torch as T
    from solstrale_tpu_torch import fixtures
    from solstrale_tpu_torch.renderer import megakernel
    from solstrale_tpu_torch.scene.compile import compile_scene

    scene = fixtures.kitchen_sink_scene(T.RenderConfig(width=16, height=12),
                                        normal_map=normal_map, tex_size=16)
    c = compile_scene(scene, device="cpu")
    t = megakernel.pack_tables(c)
    ev = dict(miss=11, capped=3, emit=29, pdf=1234, basic=567, mapped=89)
    want = cs.k5_flops(t, c.light_kinds, 192, 1800, ev, 77)
    media = [tuple(x.shape[0] for x in t.media.boundary(m))
             for m in range(t.media.n_media)]
    got = roofline.k5_flops(t.sph.shape[0], t.pln.shape[0], media, t.flags,
                            c.light_kinds, 192, 1800, ev, 77)
    assert got == want
    s = c.solids
    assert (t.sph.shape[0], t.pln.shape[0]) == (s.sph_center.shape[0],
                                                 s.pl_n.shape[0])
