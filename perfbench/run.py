"""Run one cell of the benchmark of ``solstrale_tpu_torch``:

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with as many CUDA devices as the
cell asks for. The cell (``BENCHMARK.json``'s ``workloads``) names a
configuration (``perfbench/configs/<config>.json``: the scene, its size
and its depth) and a traffic mix (``perfbench/traffic/<traffic>.json``:
the driver and its parameters). The run builds its inputs from ``--seed``,
sets up and warms up the program (``setup_s``), measures for ``--seconds``
seconds, checks what the timed path produced against the plain reference
(``perfbench/reference``), and prints one JSON line last: the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``. Without enough CUDA devices it prints no result and exits
with 2; if a JAX module is loaded once the window has closed, with 3.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(args, device="cuda", t_process=None, overrides=None):
    """Set up, measure and check one cell; returns the ``harness.Run``.
    ``overrides`` replaces configuration and traffic parameters (the tests'
    tiny sizes on the CPU)."""
    run = harness.make_run(args, device, overrides,
                           T_PROCESS if t_process is None else t_process)
    harness.load_driver(run.traffic["driver"]).run(run)
    return run


def main(argv=None):
    args = parse(argv)
    harness.cache_environment()
    import torch

    cell = harness.find_cell(args.workload)[0]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s): "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    run = run_cell(args)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"the process holds {loaded} once the window has closed",
              file=sys.stderr)
        return 3
    harness.print_result(run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
