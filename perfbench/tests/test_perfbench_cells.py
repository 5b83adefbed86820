"""Each cell runs end to end on the CPU at a tiny size through the program's
plain versions, and its result line has the contract's keys; the command
refuses to run without the cards a cell asks for, and in a checkout that
holds only the benchmark."""
import json
import shutil
import subprocess
import sys

import pytest

from .conftest import ROOT, run_tiny

CELLS = ("kitchen_preview", "kitchen_inverse")


@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_prints_the_contract_line(cell, trace, capsys):
    from perfbench import harness

    run = run_tiny(cell, trace=trace)
    harness.print_result(run)
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if trace and "breakdown" in line:
        keys.append("breakdown")
    assert list(line) == keys + ["checks"]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    names = {m["name"] for m in (run.layer if trace else run.e2e)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) >= {"value", "unit"}
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
    # the checks are the last lines of standard error
    err = out.err.strip().splitlines()
    assert all(e.startswith("check ") for e in err[-len(line["checks"]):])


def test_same_seed_same_checked_inputs():
    """The same seed gives the same inputs: the checked pixels and the
    colours the program produced at them."""
    a = run_tiny("kitchen_preview", seed=12345, seconds=0.5)
    b = run_tiny("kitchen_preview", seed=12345, seconds=0.5)
    assert a.correct and b.correct
    assert a.info["max_gap"] == b.info["max_gap"]


def test_cli_refuses_without_a_card():
    """Without a CUDA device the command prints no result and exits with
    2 (this sandbox has none)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "kitchen_preview",
         "--seed", "3000000017", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


def test_cli_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, the command exits with an error and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    code = ("import sys, runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 4\n"
            "sys.argv = ['perfbench/run.py', '--workload', "
            "'kitchen_preview', '--seed', '5', '--seconds', '1', "
            "'--trace', '0']\n"
            "runpy.run_path('perfbench/run.py', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout == ""
    assert "solstrale_tpu_torch" in out.stderr


def test_cell_on_the_card(card):
    """A short run of the kitchen's preview on the card is correct."""
    import argparse

    from perfbench import run as bench_run

    run = bench_run.run_cell(argparse.Namespace(
        workload="kitchen_preview", seed=3000000029, seconds=2, trace=0))
    assert run.correct, run.checks
    assert run.result()["device"]["platform"] == "gpu"
