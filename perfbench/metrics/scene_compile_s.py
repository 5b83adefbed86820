"""``scene_compile_s``: host seconds of the program's ``compile_scene``
(``scene/compile.py``), summed over the run's calls: the benchmark's span
around it. None where it was not called."""


def read(run):
    spans = run.rec.durations("compile_scene")
    return sum(spans) if spans else None
