"""A new configuration, traffic mix and per-layer metric are new files
alone: in a copy of the benchmark, one of each is added beside the
existing files (none of which changes) and entries for them in
``BENCHMARK.json``, and the new cell runs and reports the new metric."""
import json
import shutil
import subprocess
import sys

from .conftest import ROOT


def test_new_config_mix_and_metric_are_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*")
              if p.is_file()}
    bench_dir = tmp_path / "perfbench"

    conf = json.loads((bench_dir / "configs" / "kitchen_sink.json")
                      .read_text())
    conf.update(name="kitchen_small", width=24, height=16,
                params={"tex_size": 16, "tex_seed": 5},
                limits={})
    (bench_dir / "configs" / "kitchen_small.json").write_text(
        json.dumps(conf))
    mix = {"driver": "progressive", "samples_per_batch": 2,
           "check_pixels": 12, "check_updates": 3, "control_updates": 10,
           "atol": 1e-4, "rtol": 1e-3, "profile_at": 0.2,
           "profile_s": 0.2,
           "limits": {"kitchen_small": {"path_mismatch_share": 0.05,
                                        "image_u8_gap": 0}}}
    (bench_dir / "traffic" / "progressive_2spp.json").write_text(
        json.dumps(mix))
    (bench_dir / "metrics" / "segments_per_update.py").write_text(
        "def read(run):\n"
        "    segs = run.rec.counters.get('segments')\n"
        "    return sum(segs) / len(segs) if segs else None\n")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "kitchen_small", "source": conf["source"],
        "file": "perfbench/configs/kitchen_small.json", "reduced": [],
        "why": "the kitchen at a tiny size"})
    bench["workloads"].append({
        "name": "kitchen_small_preview", "config": "kitchen_small",
        "traffic": "progressive_2spp", "chips": 1,
        "why": "a tiny progressive render, 2 spp an update"})
    for m in bench["end_to_end"]:
        if m["name"] in ("msamples_per_s", "update_ms_p95"):
            m["workloads"].append("kitchen_small_preview")
    bench["per_layer"].append({
        "name": "segments_per_update", "unit": "segments",
        "better": "lower", "source": "program_counter",
        "layer": "wavefront loop: renderer/integrator.py",
        "moves": "msamples_per_s", "workloads": ["kitchen_small_preview"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = (
        "import sys, argparse, time, json\n"
        "sys.path.insert(0, %r); sys.path.append(%r)\n"
        "import torch; torch.set_num_threads(2)\n"
        "from perfbench import run, harness\n"
        "assert harness.ROOT.samefile(%r)\n"
        "r = run.run_cell(argparse.Namespace(workload='kitchen_small_preview',"
        " seed=2**31 + 11, seconds=1.0, trace=1), device='cpu',"
        " t_process=time.perf_counter())\n"
        "print(json.dumps(r.result()))\n"
        % (str(tmp_path), str(ROOT), str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line
    assert line["metrics"]["segments_per_update"]["value"] > 0
    for p, data in before.items():
        assert p.read_bytes() == data, p
