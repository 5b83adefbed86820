"""``image_ms``: milliseconds an update spends in the post-processor's
``post_process`` (``post/``: the tone map to u8 and the copy to the host),
the mean over the window's updates. On the card, the device time between
CUDA events the benchmark records around each call, so no sync is added to
the traced run; on the CPU, the benchmark's host span around it."""


def read(run):
    n = run.attempted
    times = run.rec.counters.get("image_ms")
    if times is None:
        times = [t * 1e3 for t in run.rec.durations("post_process")[-n:]]
    return sum(times) / len(times) if times and n else None
