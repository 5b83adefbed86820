"""The port and its smoke script lint clean with the repo's own linter:
``python tools/lint.py solstrale_tpu_torch chip_smoke.py`` from the repo
root exits 0 and reports no problem."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_lints_clean():
    out = subprocess.run(
        [sys.executable, "tools/lint.py", "solstrale_tpu_torch",
         "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True,
        timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    assert " 0 problems" in out.stdout, out.stdout
