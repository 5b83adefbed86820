"""``BENCHMARK.json`` keeps to the benchmark's contract, and every
configuration, traffic mix and per-layer metric a cell names is found by
its name."""
import json
import re

import pytest

from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 runs a cell, each run_seconds
    # + 60, each cell 2 x 90 to compile, 1200 spare
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_command_and_paths(bench):
    cmd, paths = bench["command"], bench["paths"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for w in cmd[1:]:
        if "/" in w or w.endswith(".py"):
            assert any(w == p or w.startswith(p + "/") for p in paths), w


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
    for group in ("configs", "workloads"):
        ns = [e["name"] for e in bench[group]]
        assert len(ns) == len(set(ns))
    metrics = [e["name"] for g in ("end_to_end", "per_layer")
               for e in bench[g]]
    assert len(metrics) == len(set(metrics))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(bench["workloads"]) // 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert one_line(m["layer"])


def test_every_cell_reports_what_it_must(bench):
    """Each cell reports setup_s, another end-to-end metric and a per-layer
    metric, and each per-layer metric the end-to-end metric it moves."""
    from perfbench import harness

    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in bench["end_to_end"])
    cells = {w["name"] for w in bench["workloads"]}
    configs = {c["name"] for c in bench["configs"]}
    assert {w["config"] for w in bench["workloads"]} == configs
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    for name in cells:
        _, _, _, e2e, layer = harness.find_cell(name, bench)
        e2e_names = {m["name"] for m in e2e}
        assert "setup_s" in e2e_names and len(e2e_names) >= 2
        assert layer
        for m in layer:
            assert m["moves"] in e2e_names, (name, m["name"])
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        layers.setdefault(m["layer"], set()).add(m["name"])


def test_found_by_name(bench):
    """Every configuration file, traffic mix, driver and metric reader a
    cell names exists, and the configurations say what they were cut
    from."""
    from perfbench import harness

    for c in bench["configs"]:
        path = ROOT / c["file"]
        assert c["file"].startswith("perfbench/") and path.is_file()
        conf = json.loads(path.read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]
        assert (ROOT / "perfbench" / "scenes" / f"{conf['scene']}.py"
                ).is_file()
    for w in bench["workloads"]:
        mix = json.loads((ROOT / "perfbench" / "traffic" /
                          f"{w['traffic']}.json").read_text())
        assert (ROOT / "perfbench" / "drivers" / f"{mix['driver']}.py"
                ).is_file()
        _, config, _, _, _ = harness.find_cell(w["name"], bench)
    for m in bench["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def test_limits_for_every_cell(bench):
    """Each cell's checks have their limits, found by configuration and
    mix."""
    import argparse

    from perfbench import harness
    from perfbench.drivers import common

    preview = {"path_mismatch_share", "image_u8_gap"}
    needed = {"progressive": preview,
              "inverse": {"loss_gap", "grad_norm_gap", "change_norm_gap",
                          "grad_diff_norm", "change_diff_norm"}}
    for w in bench["workloads"]:
        run = harness.make_run(argparse.Namespace(
            workload=w["name"], seed=1, seconds=1, trace=0), "cpu")
        assert set(common.limits(run)) == needed[run.traffic["driver"]]
