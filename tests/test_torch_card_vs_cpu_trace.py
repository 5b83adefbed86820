"""``chip_smoke.py``'s trace of a card-against-CPU outlier pixel, run on
the CPU with a CPU-compiled scene standing in for each device: two
many-light scenes whose terrains differ part at bounce 0 on a hit, the
line names that bounce and quantity with both values and what differs
from the same inputs, and a scene traced against itself parts nowhere."""
import json

import numpy as np
import torch

import chip_smoke
import solstrale_tpu_torch as T
from solstrale_tpu_torch import fixtures
from solstrale_tpu_torch.renderer import integrator
from solstrale_tpu_torch.scene.compile import compile_scene

torch.set_num_threads(2)

W, H = 16, 12


def _scene(n_cells):
    cfg = T.RenderConfig(width=W, height=H, seed=1)
    cs = compile_scene(fixtures.many_light_scene(cfg, n_lights=20,
                                                 n_cells=n_cells),
                       device="cpu")
    img = integrator.render_sample_batch(
        cs, 1, 1, width=W, height=H, max_depth=50, shader_kind=0,
        need_aux=False, n_samples=1)[0].numpy()
    return cs, img


def _lines(capsys):
    return [json.loads(s) for s in capsys.readouterr().out.splitlines()]


def test_trace_names_where_two_scenes_part(capsys):
    (a, img_a), (b, img_b) = _scene(8), _scene(9)
    close = np.isclose(img_a, img_b, rtol=1e-3, atol=1e-3).all(-1)
    far = [tuple(int(x) for x in p) for p in np.argwhere(~close)[:2]]
    assert far
    chip_smoke._trace_outliers("many_light", "path", {"cuda": a, "cpu": b},
                               far, img_a, img_b, W, H, 1)
    lines = _lines(capsys)
    assert [ln["pixel"] for ln in lines] == [list(p) for p in far]
    for ln, (r, c) in zip(lines, far):
        assert ln["phase"] == "card_vs_cpu_outlier" and ln["reproduced"]
        assert ln["pixel_id"] == (H - 1 - r) * W + c and ln["sample"] == 1
        first = ln["first_difference"]
        assert first["quantity"] in chip_smoke.REPLAY_ORDER
        assert first["card"] != first["cpu"]
        # the camera rays are the same on both: the terrain sets them apart
        assert first["ulps_in"] == {"o": 0, "d": 0} or first["bounce"] > 0
        assert first["quantity"] in first["same_inputs_differ"]
        bit = ln["first_bit_difference"]
        assert (bit["bounce"], chip_smoke.REPLAY_ORDER.index(
            bit["quantity"])) <= (first["bounce"],
                                  chip_smoke.REPLAY_ORDER.index(
                                      first["quantity"]))


def test_trace_of_a_scene_against_itself_finds_nothing(capsys):
    a, img = _scene(8)
    chip_smoke._trace_outliers("many_light", "path", {"cuda": a, "cpu": a},
                               [(3, 5)], img, img, W, H, 1)
    (ln,) = _lines(capsys)
    assert not ln["reproduced"] and "first_bit_difference" not in ln
