"""``step_peak_gb``: the allocator's peak of device memory over the
window's inverse steps (the step's graph pool, its tape and the
optimiser's state), in GB (1e9 bytes): the benchmark's reading of
``torch.cuda.max_memory_allocated`` after a reset at the window's
start."""


def read(run):
    peak = run.rec.counters.get("window_peak_bytes")
    return peak / 1e9 if peak else None
