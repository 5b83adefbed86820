"""The gate sweep's scenes (``fixtures.table_scene``) on the CPU: each grows
the one table it names and keeps the others, K5's plain version renders
each as ``trace_queued`` does (with the normal map), the gate stops at
the limits the sweep measured on the card, and the sweep itself refuses
to run without a card."""
import pytest
import torch

import solstrale_tpu_torch as T
from solstrale_tpu_torch import fixtures, gate_sweep
from solstrale_tpu_torch.renderer import integrator as TI
from solstrale_tpu_torch.renderer import megakernel as TM
from solstrale_tpu_torch.scene.compile import compile_scene

torch.set_num_threads(2)

# the size each table's sizes are keyed by, in gate_sweep.table_sizes
KEY = {"planar": "planar", "spheres": "spheres", "lights": "lights",
       "materials": "materials", "media": "medium_rows"}


def _compiled(table, n, normal_map=False, w=8, h=6):
    return compile_scene(fixtures.table_scene(
        T.RenderConfig(width=w, height=h), table, n, normal_map=normal_map),
        use_bvh=False, device="cpu")


@pytest.mark.parametrize("table", fixtures.TABLES)
def test_table_scene_grows_one_table(table):
    """From the sweep's first size to its second the named table grows by
    the sizes' difference and no other table the old gate bounded
    changes (the lights' quads add planar rows too, and the materials'
    own colours add textures)."""
    n0, n1 = gate_sweep.SIZES[table][:2]
    a, b = (gate_sweep.table_sizes(_compiled(table, n)) for n in (n0, n1))
    grown = {"lights": {"lights", "planar"},
             "materials": {"materials", "textures"}}.get(table, {KEY[table]})
    if table == "media":
        assert a["medium_rows"][0] < b["medium_rows"][0]
        assert b["medium_rows"][0] - a["medium_rows"][0] == n1 - n0
    else:
        for k in grown:
            assert b[k] - a[k] == n1 - n0, k
    assert {k: v for k, v in a.items() if k not in grown} == \
        {k: v for k, v in b.items() if k not in grown}


@pytest.mark.parametrize("table", fixtures.TABLES)
def test_table_scene_k5_matches_trace_queued(table):
    """Each sweep scene, with its normal map, at its smallest size: K5's
    gate takes it and its plain version equals ``trace_queued`` (1e-5,
    segments equal), the rendering the sweep compares K5 with."""
    n = gate_sweep.SIZES[table][0]
    cs = _compiled(table, n, normal_map=True)
    assert "normal_maps" in cs.features
    assert TM.megakernel_supported(cs, need_aux=False, shader_kind=0)
    kw = dict(width=12, height=8, max_depth=6)
    want, seg_q = TI.trace_queued(cs, 1, 2, 1, **kw)
    got, seg_k = TM.render_batch_megakernel_plain(cs, 1, 2, 1, **kw)
    assert float(got.sum()) > 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert int(seg_k) == int(seg_q)


# each limited table: (its limit, the sweep scene's items at that limit)
LIMITS = {"planar": (TM.MAX_PLANAR, TM.MAX_PLANAR - 2),
          "spheres": (TM.MAX_SPHERES, TM.MAX_SPHERES),
          "lights": (TM.MAX_LIGHTS, TM.MAX_LIGHTS)}


@pytest.mark.parametrize("table", list(LIMITS))
def test_gate_stops_at_the_measured_limit(table):
    """The gate takes a sweep scene whose table is at its limit and
    refuses one a row past it (``use_bvh=False``: no BVH either way);
    the sweep's other tables have no limit."""
    limit, n = LIMITS[table]
    key = KEY[table]
    at, past = _compiled(table, n), _compiled(table, n + 1)
    assert gate_sweep.table_sizes(at)[key] == limit
    assert gate_sweep.table_sizes(past)[key] == limit + 1
    assert TM.megakernel_supported(at, need_aux=True, shader_kind=0)
    assert not TM.megakernel_supported(past, need_aux=False, shader_kind=0)
    assert set(LIMITS) | {"materials", "media"} == set(fixtures.TABLES)


def test_sweep_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gate_sweep.main(["--tables", "spheres"])
