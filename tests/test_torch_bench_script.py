"""The port's throughput script (``solstrale_tpu_torch.bench``) on the CPU at
tiny sizes: ``measure``'s line, the black-frame guard, the megakernel
gate of the direct K5 workload, one failing workload reported while the
others run and the exit code non-zero, and the card as the default device.
"""
import dataclasses
import json

import pytest
import torch

import solstrale_tpu_torch as T
from solstrale_tpu_torch import bench, fixtures
from solstrale_tpu_torch.scene.compile import compile_scene

torch.set_num_threads(2)

LINE_KEYS = {"value", "unit", "route", "segments", "runs_s", "launches",
             "iterations", "host_reads", "peak_mem_gb"}


def _compiled(build, w=16, h=12):
    return compile_scene(build(T.RenderConfig(width=w, height=h, seed=1)),
                         device="cpu")


def _tiny_sponza(cfg):
    return fixtures.sponza_textured_scene(cfg, n_cells=16, tex_size=16)


@pytest.mark.parametrize("scene,route,k5_direct", [
    (_tiny_sponza, "wavefront", False),
    (fixtures.kitchen_sink_solid_scene, "k5", False),
    (fixtures.kitchen_sink_solid_scene, "k5", True)])
def test_measure_returns_the_line(scene, route, k5_direct):
    cs = _compiled(scene)
    line = bench.measure(cs, 16, 12, 2, 50, runs=3, k5_direct=k5_direct)
    assert set(line) == LINE_KEYS
    assert line["route"] == route and line["unit"] == "Mrays/s"
    assert len(line["runs_s"]) == 3 and min(line["runs_s"]) > 0
    assert line["segments"] >= 16 * 12 * 2
    assert line["value"] == pytest.approx(
        line["segments"] / sorted(line["runs_s"])[1] / 1e6)
    # the wrappers count only launches of their kernels: none on the CPU
    assert line["launches"] == dict(K1=0, K2=0, K3=0, K4=0, K5=0, draw=0,
                                   S1=0, S2=0, S1B=0, CR=0, FH=0)
    assert (line["iterations"] is None) == (route == "k5")
    # the CPU's eager driver reads the stop test after every step
    assert line["host_reads"] == line["iterations"]
    assert line["peak_mem_gb"] is None


def test_k5_direct_refuses_a_scene_outside_the_gate():
    with pytest.raises(ValueError, match="megakernel gate"):
        bench.measure(_compiled(_tiny_sponza), 16, 12, 1, 50, runs=1,
                      k5_direct=True)


def test_black_frame_raises():
    """Every camera ray misses (the only emitter is behind the camera, the
    background is black): the guard refuses the throughput."""
    def dark(cfg):
        camera = T.CameraConfig(vertical_fov_degrees=20.0,
                                look_from=(0, 0, 4), look_at=(0, 0, 0))
        world = [T.Sphere((0, 0, 100), 1.0, T.DiffuseLight(10, 10, 10))]
        return T.Scene(T.Bvh(world), camera, (0.0, 0.0, 0.0), cfg)

    with pytest.raises(RuntimeError, match="degenerate render"):
        bench.measure(_compiled(dark), 16, 12, 1, 50, runs=1)


def _tiny(w, **kw):
    return dataclasses.replace(w, width=16, height=12, **kw)


def _broken(cfg):
    raise RuntimeError("scene build failed")


def test_main_reports_a_failure_runs_the_rest_and_exits_nonzero(
        monkeypatch, capsys):
    kitchen, _, many, megakernel, _ = bench.WORKLOADS
    monkeypatch.setattr(bench, "WORKLOADS", (
        _tiny(kitchen),
        _tiny(many, scene=_broken),
        _tiny(megakernel)))
    assert bench.main([], device="cpu") == 1
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [ln["metric"] for ln in lines] == [
        "kitchen_sink_mrays_per_s", "many_lights_mrays_per_s",
        "megakernel_mrays_per_s"]
    assert lines[1] == {"metric": "many_lights_mrays_per_s",
                        "error": "RuntimeError: scene build failed"}
    for ln in (lines[0], lines[2]):
        assert "error" not in ln and ln["value"] > 0
        assert ln["device"] == {"name": "cpu", "power_limit": None}
        assert ln["route"] == "k5"


def test_main_exits_zero_when_every_workload_ran(monkeypatch, capsys):
    monkeypatch.setattr(bench, "WORKLOADS", tuple(
        _tiny(w) for w in bench.WORKLOADS if w.name in ("kitchen_sink",
                                                        "megakernel")))
    assert bench.main([], device="cpu") == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [ln["metric"] for ln in lines] == ["kitchen_sink_mrays_per_s",
                                              "megakernel_mrays_per_s"]
    with pytest.raises(SystemExit):
        bench.main(["--runs", "1"], device="cpu")


def test_the_card_is_the_default():
    """Without a card the default device raises before any workload runs;
    nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the CPU-only host")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


def test_workloads_are_bench_py_s():
    """bench.py's five workloads, metric names and settings, the headline
    last."""
    assert [(w.metric, w.width, w.height, w.spp) for w in bench.WORKLOADS] == [
        ("kitchen_sink_mrays_per_s", 400, 266, 8),
        ("sponza_production_mrays_per_s", 1920, 1080, 1),
        ("many_lights_mrays_per_s", 960, 540, 1),
        ("megakernel_mrays_per_s", 400, 266, 8),
        ("sponza_1080p_mrays_per_s", 1920, 1080, 1)]
    assert [w.k5_direct for w in bench.WORKLOADS] == [False, False, False,
                                                      True, False]
    assert (bench.SEED, bench.MAX_DEPTH) == (1, 50)
