"""What every cell's run shares: finding the cell's configuration, traffic
mix and per-layer metrics by name, the spans and counters the benchmark
records around the program's calls, the profiler's stretch of a traced
window, the comparisons that decide ``correct``, and the result line.

Everything here belongs to the benchmark, not to the program: the spans
wrap module attributes the program looks up at call time, and no span
goes inside the program.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
# top-level module names that no run may hold once its window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "solstrale_tpu")


def load_benchmark(root=ROOT):
    """``BENCHMARK.json`` of the checkout."""
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path):
    with open(path) as f:
        return json.load(f)


def find_cell(name, bench=None, bench_dir=BENCH):
    """(cell, configuration, traffic mix, per-layer metrics) of the cell
    ``name``, each found by its name: ``configs/<config>.json``,
    ``traffic/<traffic>.json``; the per-layer metrics that list the cell,
    or that list no cell and move an end-to-end metric the cell reports."""
    bench = bench or load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[name]
    conf_entry = next(c for c in bench["configs"] if c["name"] ==
                      cell["config"])
    config = read_json(ROOT / conf_entry["file"])
    traffic = read_json(Path(bench_dir) / "traffic" /
                        f"{cell['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in e2e_names
                              else [])]
    return cell, config, traffic, e2e, layer


def load_reader(metric, bench_dir=BENCH):
    """The ``read(run)`` of ``metrics/<metric>.py``."""
    path = Path(bench_dir) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{re.sub(r'[^A-Za-z0-9_]', '_', metric)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_driver(kind):
    """The driver module of a traffic mix's ``driver`` (``drivers/<kind>.py``)."""
    return importlib.import_module(f"perfbench.drivers.{kind}")


def percentile(values, q):
    """The nearest-rank ``q``-th percentile of ``values``."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def forbidden_loaded():
    """Top-level names of ``FORBIDDEN_MODULES`` in ``sys.modules``,
    compared whole (``solstrale_tpu_torch`` is not ``solstrale_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


CARD_FIELDS = ("power.limit", "clocks.sm", "clocks.max.sm",
               "temperature.gpu", "power.draw")


def card_state():
    """The first card's power limit, SM clock, its maximum, temperature
    and power draw as ``nvidia-smi`` reports them ({field: text}), or {}
    where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=" + ",".join(CARD_FIELDS),
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    return dict(zip(CARD_FIELDS, out[0].split(", "))) if out else {}


def power_limit(run=None):
    """The card's power limit (text, as ``nvidia-smi`` gives it), or None;
    with ``run``, the card's state right after the window goes into its
    ``info``."""
    state = card_state()
    if run is not None and state:
        run.info["card_after_window"] = state
    return state.get("power.limit")


class Recorder:
    """Spans and counters the benchmark records around the program's
    calls: ``spans[name]`` a list of (start, end) host seconds, ``counters``
    named values. With ``trace``, each span is also a profiler range of
    its name, so the trace can say what the host did in a device gap."""

    def __init__(self, trace=False):
        self.trace = trace
        self.spans = {}
        self.counters = {}

    @contextlib.contextmanager
    def span(self, name):
        ctx = contextlib.nullcontext()
        if self.trace:
            import torch

            ctx = torch.profiler.record_function(name)
        t0 = time.perf_counter()
        with ctx:
            yield
        self.spans.setdefault(name, []).append((t0, time.perf_counter()))

    def wrap(self, module, attr, name=None, after=None, before=None):
        """Replace ``module.attr`` by a call of the original inside a span
        ``name`` (default: ``attr``); ``before(args, kwargs)`` may change
        the arguments, ``after(result, args, kwargs)`` sees the result.
        Returns a function that puts the original back."""
        orig = getattr(module, attr)
        name = name or attr

        def wrapped(*args, **kwargs):
            if before is not None:
                args, kwargs = before(args, kwargs)
            with self.span(name):
                out = orig(*args, **kwargs)
            if after is not None:
                after(out, args, kwargs)
            return out

        setattr(module, attr, wrapped)
        return lambda: setattr(module, attr, orig)

    def durations(self, name):
        """Seconds of the spans ``name``."""
        return [b - a for a, b in self.spans.get(name, [])]


class Stretch:
    """A ``torch.profiler`` session over a stretch of the traced window:
    ``start()`` and ``stop()`` between two updates or steps, then
    ``summary()``: the device's busy seconds (the union of its kernels'
    and copies' intervals), the stretch's seconds, the kernels by name, the
    device operations that took most time and the longest idle gaps, each
    named by the benchmark's span the host was in when it began."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None

    def warm(self):
        """One empty profiler session: the profiler's first start (its
        tracer's set-up, seconds long) happens in the set-up, not in the
        window."""
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts):
            if torch.cuda.is_available():
                torch.cuda.synchronize()

    def start(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    @property
    def active(self):
        return self.prof is not None and self.t1 is None

    def summary(self, span_names):
        """Busy, window and per-kernel numbers of the stretch (None if the
        profiler saw no device operation)."""
        import torch

        dev, host = [], []
        for e in self.prof.events():
            tr = e.time_range
            if e.name in span_names or e.name.startswith("Optimizer."):
                # a range the host annotated: the profiler shows it on the
                # device's timeline too, but it is no device operation
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    host.append((tr.start, tr.end, e.name))
            elif e.device_type == torch.autograd.DeviceType.CUDA and \
                    not getattr(e, "is_user_annotation", False):
                dev.append((tr.start, tr.end, e.name))
        if not dev:
            return None
        dev.sort()
        busy = 0.0
        gaps = []
        cur_s, cur_e = dev[0][0], dev[0][1]
        for s, e, _ in dev[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        by_name = {}
        for s, e, name in dev:
            rec = by_name.setdefault(name, [0, 0.0])
            rec[0] += 1
            rec[1] += (e - s) / 1e6
        host.sort()

        def doing(t):
            inner = [h for h in host if h[0] <= t <= h[1]]
            return min(inner, key=lambda h: h[1] - h[0])[2] if inner \
                else "host"

        gaps.sort(key=lambda g: g[0] - g[1])
        window_s = self.t1 - self.t0
        return dict(
            busy_s=busy / 1e6, window_s=window_s,
            kernels={k: tuple(v) for k, v in by_name.items()},
            device_ops=[[k[:120], v[1]] for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1][1])[:10]],
            idle_gaps=[[doing(a), (b - a) / 1e6] for a, b in gaps[:10]])


def kernel_seconds(kernels, pattern):
    """(launches, device seconds) of the kernels whose name matches the
    regular expression ``pattern``."""
    rx = re.compile(pattern)
    n, s = 0, 0.0
    for name, (count, secs) in kernels.items():
        if rx.search(name):
            n += count
            s += secs
    return n, s


class Run:
    """One run of a cell: its arguments, the cell's configuration and
    mix, the recorder, the numbers the drivers measure and the checks
    that decide ``correct``."""

    def __init__(self, args, cell, config, traffic, e2e, layer, device,
                 t_process):
        self.args = args
        self.seed = int(args.seed)
        self.render_seed = self.seed % (2 ** 31)
        self.cell = cell
        self.config = config
        self.traffic = traffic
        self.e2e = e2e
        self.layer = layer
        self.device = device
        self.trace = bool(args.trace)
        self.t_process = t_process
        self.rec = Recorder(trace=self.trace)
        self.stretch = Stretch() if self.trace else None
        self.stretch_summary = None
        self.metrics = {}
        self.checks = []
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes = 0
        self.work = {}        # what the rooflines' readers need
        self.power_limit = None
        self.info = {}

    def metric(self, name, value, unit, **extra):
        self.metrics[name] = {"value": value, "unit": unit, **extra}

    def check(self, name, value, limit):
        """A number compared: ``value`` must not exceed ``limit``; a value
        that is not a number (NaN) fails."""
        ok = value == value and value <= limit
        self.checks.append((name, value, limit, ok))
        return ok

    @property
    def correct(self):
        return bool(self.checks) and all(c[3] for c in self.checks)

    def warm_profiler(self):
        """In a traced run, the profiler's first start, in the set-up."""
        if self.stretch is not None:
            self.stretch.warm()

    def maybe_stretch(self, t_window0, now):
        """Start the profiler once the traffic's ``profile_at`` share of the
        window has passed, stop it ``profile_s`` seconds later; called
        between two updates or steps."""
        if self.stretch is None or self.stretch.t1 is not None:
            return
        at = self.traffic.get("profile_at", 0.4) * self.args.seconds
        if self.stretch.prof is None and now - t_window0 >= at:
            self.stretch.start()
        elif self.stretch.active and (now - self.stretch.t0 >=
                                      self.traffic.get("profile_s", 2.0)):
            self.stretch.stop()

    def close_stretch(self):
        if self.stretch is not None and self.stretch.active:
            self.stretch.stop()

    def in_stretch(self, t0, t1):
        """Whether host interval [t0, t1] lies inside the profiled
        stretch."""
        s = self.stretch
        return (s is not None and s.t0 is not None and s.t1 is not None
                and s.t0 <= t0 and t1 <= s.t1)

    def result(self):
        """The result line as a dict; ``checks`` comes last."""
        dev = {"platform": "gpu" if self.device == "cuda" else "cpu",
               "kind": self.info.get("kind", "cpu"),
               "count": int(self.cell["chips"]),
               "memory_peak_bytes": int(self.memory_peak_bytes)}
        if self.power_limit:
            dev["power_limit"] = self.power_limit
        out = {"correct": self.correct, "attempted": int(self.attempted),
               "failed": int(self.failed)}
        if self.trace:
            out["metrics"] = {m["name"]: self.metrics[m["name"]]
                              for m in self.layer if m["name"] in self.metrics}
            st = self.stretch_summary
            if st is not None:
                dev["busy_s"] = st["busy_s"]
                dev["window_s"] = st["window_s"]
                out["breakdown"] = {"device_ops": st["device_ops"],
                                    "idle_gaps": st["idle_gaps"]}
        else:
            out["metrics"] = {m["name"]: self.metrics[m["name"]]
                              for m in self.e2e if m["name"] in self.metrics}
        out["device"] = dev
        out["checks"] = {name: {"value": value, "limit": limit}
                         for name, value, limit, _ in self.checks}
        return out


def make_run(args, device, overrides=None, t_process=0.0):
    """The ``Run`` of ``args.workload`` on ``device``: its cell, its
    configuration and traffic mix found by name, with ``overrides``
    (``config``, ``params``, ``traffic``: the tests' tiny sizes) laid over
    them."""
    cell, config, traffic, e2e, layer = find_cell(args.workload)
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    config["params"] = {**config.get("params", {}),
                        **overrides.get("params", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    return Run(args, cell, config, traffic, e2e, layer, device, t_process)


def read_layer_metrics(run):
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing to read returns None and the metric is left out."""
    for m in run.layer:
        value = load_reader(m["name"])(run)
        if value is not None:
            if isinstance(value, dict):
                run.metric(m["name"], unit=m["unit"], **value)
            else:
                run.metric(m["name"], value, m["unit"])


def print_result(run):
    """What the run noted (``info``), then the checks, on standard error;
    the result as the last line of standard output."""
    print("info " + json.dumps(run.info, default=str), file=sys.stderr)
    for name, value, limit, ok in run.checks:
        print(f"check {name} = {value!r} limit {limit!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr, flush=True)
    print(json.dumps(run.result()), flush=True)


def cache_environment(root=ROOT):
    """Point every build and kernel cache at fixed directories inside the
    checkout. The program's CUDA library already builds into
    ``solstrale_tpu_torch/_build/``."""
    base = Path(root) / "perfbench" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
