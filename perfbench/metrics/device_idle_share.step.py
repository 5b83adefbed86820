"""``device_idle_share.step``: the share of the profiled stretch in which no
operation ran on the device: 1 - busy / stretch seconds, in percent, busy
being the union of the device operations' intervals in the profiler's
trace. None without a trace."""


def read(run):
    st = run.stretch_summary
    if st is None or st["window_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - st["busy_s"] / st["window_s"])
