"""The readings that a cell's limits are set against: its control and its
planted faults, each put in the program's place.

- Preview cells: the control is the plain reference computed in bfloat16
  (every float table and the lane state after every bounce rounded to
  bfloat16: the nearest precision below the configuration's float32) in
  the program's place, at the lanes a run checks: ``path_mismatch_share``
  against the float32 reference.
- ``kitchen_inverse``: the same control (the arena, too, rounded to
  bfloat16 after each update), and three faults planted in the reference
  put in the program's place: ``half`` (the loss's mean over the even
  pixels only), ``swap`` (the image's red and blue channels swapped
  where it is produced) and ``mirror`` (each gradient sent to the
  mirrored texel). A step that returns its state unchanged reads
  ``change_norm_gap`` 1 by its definition and needs no run.

    python3 perfbench/control.py --workload NAME --seed N [--seed N ...]

prints one JSON line a seed with each reading beside the cell's limit. The
benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402
from perfbench.drivers import common  # noqa: E402


def preview_readings(run):
    """{"control": {"path_mismatch_share": share}} of a preview cell: the
    bfloat16 reference against the float32 one at the lanes a run of the
    traffic's ``control_updates`` updates checks."""
    import numpy as np
    import torch

    from perfbench.drivers import progressive
    from perfbench.reference import integrator as ref

    cfg, mix, dev = run.config, run.traffic, run.device
    width = int(mix.get("width", cfg["width"]))
    height = int(mix.get("height", cfg["height"]))
    spb = int(mix.get("samples_per_batch", mix.get("n_sample_axis", 1)))
    n = int(mix["control_updates"])
    rng = np.random.default_rng([run.seed, 1])
    pix = np.sort(rng.choice(width * height, int(mix["check_pixels"]),
                             replace=False))
    chosen = progressive.chosen_updates(run, n)
    p, s = progressive.lanes(pix, [1 + u * spb for u in chosen], spb, dev)
    colors = {}
    for name, q in (("f32", None), ("bf16", torch.bfloat16)):
        cs, media = common.reference_scene(run, width, height, quantize=q)
        c = ref.trace_paths(cs, p, s, run.render_seed, width=width,
                            height=height, max_depth=int(cfg["max_depth"]),
                            media=media, quantize=q)
        colors[name] = c.reshape(len(chosen), spb, len(pix), 3).sum(1).cpu()
    return {"control": {"path_mismatch_share": progressive.mismatch_share(
        colors["bf16"], colors["f32"], mix)}}


def inverse_readings(run, kinds=("control", "half", "swap", "mirror")):
    """{kind: the compared gaps} of ``kitchen_inverse``: the bfloat16
    reference (``control``) and the planted faults put in the program's
    place, against the float32 reference's trajectory; the step after the
    window is taken from the state the stand-in's own steps left, as a
    run takes it from the program's."""
    import torch

    from perfbench.drivers import inverse

    mix, dev = run.traffic, run.device
    width, height = int(mix["width"]), int(mix["height"])
    steps = int(mix["checked_steps"])
    target = inverse.make_target(run.seed, width, height,
                                 int(mix["target_cells"]), dev)
    ref_t = inverse.reference_trajectory(run, target, width, height, steps)
    out = {}
    for kind in kinds:
        q = torch.bfloat16 if kind == "control" else None
        fault = None if kind == "control" else kind
        other = inverse.reference_trajectory(run, target, width, height,
                                             steps, quantize=q, fault=fault)
        other.update(inverse.reference_window_step(
            run, target, width, height, other["arena"], quantize=q,
            fault=fault))
        ref = {**ref_t, **inverse.reference_window_step(
            run, target, width, height, other["arena"])}
        out[kind] = inverse.gaps(other, ref)
    return out


def readings(args, device="cuda", overrides=None):
    """The control's and faults' readings of ``args.workload`` at
    ``args.seed``."""
    run = harness.make_run(args, device, overrides)
    if run.traffic["driver"] == "inverse":
        return inverse_readings(run)
    return preview_readings(run)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    a = p.parse_args(argv)
    harness.cache_environment()
    for seed in a.seed:
        args = argparse.Namespace(workload=a.workload, seed=seed, seconds=0,
                                  trace=0)
        run = harness.make_run(args, "cuda")
        lim = common.limits(run)
        out = readings(args)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "readings": out, "limits": lim}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
