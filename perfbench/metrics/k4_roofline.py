"""``k4_roofline``: the share of its roofline that K4, the small-scene hit
kernel (``ops/sweep.py::scene_hit``, ``csrc/sweep.cu``) reaches over the
profiled stretch: the least time one H100 could take for the kernel's work
there (``perfbench.roofline.bound_s`` of the bytes and f32 operations the
driver counted from the reference's paths) over the kernel's device
seconds in the trace, in percent. Beside it: which of the two bounds it
and the card's power limit. None where the stretch holds no launch of the
kernel or no count."""
from perfbench import harness, roofline


def read(run):
    work = run.work.get("K4")
    if run.stretch_summary is None or work is None:
        return None
    launches, secs = harness.kernel_seconds(run.stretch_summary["kernels"],
                                            r"\bk4_scene_hit\(")
    if not launches or secs <= 0:
        return None
    least, by = roofline.bound_s(*work)
    return {"value": 100.0 * least / secs, "bound_by": by,
            "power_limit": run.power_limit, "launches": launches,
            "device_s": secs}
