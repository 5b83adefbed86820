"""Shared fixtures of the benchmark's own tests (run on the CPU with
``python -m pytest perfbench/tests``; the card tests, marked ``cuda``,
skip where there is no card)."""
import argparse
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each cell at a tiny size: what the CPU can run in seconds through the
# program's plain versions
TINY = {
    "kitchen_preview": dict(config=dict(width=32, height=24),
                            params=dict(tex_size=32)),
    "kitchen_inverse": dict(traffic=dict(width=24, height=16,
                                         reference_block=128),
                            params=dict(tex_size=32)),
}


def tiny(cell, **traffic):
    """The overrides of ``cell`` at its tiny size, the profiled stretch
    early and short, and ``traffic`` on top."""
    ov = {k: dict(v) for k, v in TINY[cell].items()}
    ov["traffic"] = {**ov.get("traffic", {}), "profile_at": 0.2,
                     "profile_s": 0.3, "check_pixels": 16,
                     "control_updates": 20, **traffic}
    return ov


def run_tiny(cell, seed=2 ** 31 + 977, seconds=1.5, trace=0, **traffic):
    """One run of ``cell`` on the CPU at its tiny size: the ``Run``."""
    import torch

    from perfbench import run as bench_run

    torch.set_num_threads(2)
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=trace)
    return bench_run.run_cell(args, device="cpu",
                              t_process=time.perf_counter(),
                              overrides=tiny(cell, **traffic))


@pytest.fixture
def card():
    """Skips the test where no CUDA device is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch.cuda.is_available() is "
                    "false")
