"""The benchmark's machinery: where a cell's files are found, the spans it
records around its calls into the program, the reading of a profiler trace,
and the result line.

Everything that belongs to one cell is found by name:

* the cell's entry in ``BENCHMARK.json`` (its configuration and traffic);
* ``configs/<config>.json``: the configuration's sizes and its scene;
* ``traffic/<traffic>.json``: the traffic mix's parameters, among them the
  ``runner`` (``runners/<runner>.py``) that runs that kind of traffic;
* ``limits/<cell>.json``: the limits of the numbers its check compares;
* ``metrics/<metric>.py``: one reader per metric, ``read(r) -> float or
  None``;
* ``rooflines/<kernel>.py``: a kernel's least time, from the reference's
  count of the work;
* ``reference/<reference>.py``: the plain reference that the
  configuration names (``reference``, default ``whitted``; its interface
  is in ``reference/__init__.py``).

A configuration may also name the kernel its K1 metrics read
(``k1_kernel``: a part of the device operations' names, default
``K1_KERNEL``) and the files its scene reads beside it (``assets``).
``Layout`` looks each file up in a list of roots, the benchmark's own
folder last, so that a configuration, a cell or a metric can be added as
files and entries alone.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import sys
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names that may not be loaded in a run (compared whole:
# the program's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "advanced_cpu_raytracing_tpu")
# a traced run's window, at most: the profiler's own cost grows with the
# events it holds (on the H100, a training window traced for 51 s ran 30%
# slower than untraced, one traced for 20 s a few per cent)
TRACE_SECONDS = 20.0
# the part of K1's name that its metrics read it by, where the
# configuration names none: K1a, the Whitted megakernel
K1_KERNEL = "mega_whitted"


def loaded(names) -> list[str]:
    """The names among ``names`` that are the top-level name of a loaded
    module."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(names))


class Layout:
    """The benchmark's files, found by name under ``roots`` in order."""

    def __init__(self, roots=(), spec: dict | None = None):
        self.roots = [Path(r) for r in roots] + [BENCH_DIR]
        self.spec = spec if spec is not None else json.loads(
            (ROOT / "BENCHMARK.json").read_text())
        self._loaded = {}  # path -> module, for modules under other roots

    def find(self, *parts: str) -> Path:
        for r in self.roots:
            p = r.joinpath(*parts)
            if p.exists():
                return p
        raise FileNotFoundError("/".join(parts))

    def json(self, *parts: str) -> dict:
        return json.loads(self.find(*parts).read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                path = self.find(*Path(c["file"]).relative_to(
                    BENCH_DIR.name).parts)
                return {**json.loads(path.read_text()), "_dir": path.parent}
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self.json("traffic", f"{name}.json")

    def limits(self, cell: str) -> dict:
        return self.json("limits", f"{cell}.json")

    def module(self, kind: str, name: str):
        path = self.find(kind, f"{name}.py")
        if path.parent == BENCH_DIR / kind and "." not in name and \
                (path.parent / "__init__.py").exists():
            return importlib.import_module(f"benchmark.{kind}.{name}")
        if path not in self._loaded:
            spec = importlib.util.spec_from_file_location(
                f"benchmark_{kind}_{name.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._loaded[path] = mod
        return self._loaded[path]

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics, or with ``trace`` its per-layer
        ones: those that list it, or that list no cells."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if cell in m.get("workloads", [cell])]


class Spans:
    """Host-clock spans around the benchmark's calls into the program,
    each also a profiler range ``bench.<name>`` when ``annotate``."""

    def __init__(self, annotate: bool):
        self.annotate = annotate
        self.items: list[tuple[str, float, float]] = []

    @contextmanager
    def __call__(self, name: str):
        rf = nullcontext()
        if self.annotate:
            from torch.profiler import record_function
            rf = record_function("bench." + name)
        t0 = time.perf_counter()
        with rf:
            yield
        self.items.append((name, t0, time.perf_counter()))

    def total(self, name: str) -> float:
        return sum(b - a for n, a, b in self.items if n == name)


@dataclass
class Run:
    """One run of one cell."""

    layout: Layout
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    overrides: dict = field(default_factory=dict)  # smaller sizes, for tests
    spans: Spans = None
    t_start: float = 0.0

    def __post_init__(self):
        if self.spans is None:
            self.spans = Spans(self.trace)

    def scene_path(self) -> Path:
        return Path(self.overrides.get("scene_dir", self.config["_dir"])) \
            / self.config["scene"]

    def reference(self):
        """The plain reference module that the configuration names."""
        return self.layout.module("reference",
                                  self.config.get("reference", "whitted"))

    def k1_kernel(self) -> str:
        """The part of K1's name by which the metrics read it in this
        configuration."""
        return self.config.get("k1_kernel", K1_KERNEL)


class Sample:
    """The answers a window keeps for the check: ``k`` drawn from the seed
    by reservoir sampling, and the last; of each image only the values at
    ``pixels`` (scanline indices), so the window holds no whole image."""

    def __init__(self, seed: int, k: int, pixels):
        import numpy as np

        self.rng = np.random.default_rng([seed, 1])
        self.k, self.pixels = k, pixels
        self.kept, self.last, self.n = [], None, 0

    def offer(self, key, img):
        vals = img.reshape(-1, 3)[self.pixels]
        if len(self.kept) < self.k:
            self.kept.append((key, vals))
        else:
            j = int(self.rng.integers(0, self.n + 1))
            if j < self.k:
                self.kept[j] = (key, vals)
        self.last = (key, vals)
        self.n += 1

    def answers(self) -> list:
        """The kept (key, values), the last among them."""
        keys = [k for k, _ in self.kept]
        return self.kept + ([self.last] if self.last[0] not in keys else [])


def sample_pixels(seed: int, n_pixels: int, count: int):
    """``count`` distinct scanline indices below ``n_pixels``, sorted,
    drawn from the seed."""
    import numpy as np

    return np.sort(np.random.default_rng([seed, 2]).choice(
        n_pixels, size=min(count, n_pixels), replace=False))


# ---- statistics ----

def quantile(values, q: float) -> float:
    """The q-quantile of all values, linear between order statistics."""
    xs = sorted(values)
    if len(xs) == 1:
        return float(xs[0])
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return float(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))


def median(values) -> float:
    return float(statistics.median(values))


# ---- the trace ----

@dataclass
class Trace:
    """What a profiled window shows: the window (start, end) in seconds,
    the device's operations [(name, start, end)] clipped to it, and the
    benchmark's host ranges [(name, start, end)]."""

    window: tuple
    device: list
    host: list

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """The union of the device operations' intervals."""
        total, end = 0.0, None
        for _, a, b in sorted(self.device, key=lambda x: x[1]):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total

    def gaps(self) -> list[tuple[float, float]]:
        out, t = [], self.window[0]
        for _, a, b in sorted(self.device, key=lambda x: x[1]):
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return out

    def kernel_s(self, pattern: str) -> tuple[float, int]:
        """(seconds, launches) of the device operations whose name holds
        ``pattern``."""
        hits = [b - a for n, a, b in self.device if pattern in n]
        return sum(hits), len(hits)

    def host_at(self, t: float) -> str:
        """The innermost benchmark range open on the host at ``t``."""
        best, width = "window", None
        for n, a, b in self.host:
            if n != "window" and a <= t <= b and (width is None
                                                  or b - a < width):
                best, width = n, b - a
        return best

    def breakdown(self, n: int = 10) -> dict:
        by = {}
        for name, a, b in self.device:
            by[name] = by.get(name, 0.0) + (b - a)
        ops = sorted(by.items(), key=lambda x: -x[1])[:n]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[self.host_at((a + b) / 2), b - a]
                              for a, b in gaps]}


def read_trace(prof) -> Trace:
    """The window's device operations and host ranges from a
    ``torch.profiler`` run over ``bench.window``."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    win = [e for e in cpu if e.name() == "bench.window"]
    if not win:
        raise RuntimeError("the trace holds no bench.window range")
    w0 = win[0].start_ns() * 1e-9
    w1 = w0 + win[0].duration_ns() * 1e-9
    host = [(e.name()[len("bench."):], e.start_ns() * 1e-9,
             (e.start_ns() + e.duration_ns()) * 1e-9)
            for e in cpu if e.name().startswith("bench.")]
    dev = []
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation() \
                or e.name().startswith("bench."):
            continue
        a = e.start_ns() * 1e-9
        b = a + e.duration_ns() * 1e-9
        a, b = max(a, w0), min(b, w1)
        if b > a:
            dev.append((e.name(), a, b))
    return Trace((w0, w1), dev, host)


# ---- the result ----

@dataclass
class Readings:
    """What the metric readers read."""

    run: Run
    setup_s: float
    window_s: float
    work: dict  # the runner's record of the window
    trace: Trace | None = None
    roofline: dict = field(default_factory=dict)  # kernel -> least seconds


def read_metrics(layout: Layout, r: Readings, entries: list[dict]) -> dict:
    out = {}
    for m in entries:
        v = layout.module("metrics", m["name"]).read(r)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def check_lines(checks: dict) -> list[str]:
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in checks.items()]


# ---- one run ----

def _sync(device: str):
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def execute(run: Run, program_patch=None) -> dict:
    """Set up, measure the window, judge and read one run of ``run.cell``;
    returns the result line's object.  ``program_patch``, a context
    manager, is entered around the program's part (set-up, window and the
    answers read from it) alone: the tests plant faults with it."""
    import gc

    import torch

    layout, cell = run.layout, run.cell
    if run.trace:
        run.seconds = min(run.seconds, TRACE_SECONDS)
    runner = layout.module("runners", run.traffic["runner"])
    cuda = run.device == "cuda"
    prof = None
    with (program_patch() if program_patch else nullcontext()):
        state = runner.setup(run)
        _sync(run.device)
        setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        if run.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if cuda else [])
            prof = profile(activities=acts)
            prof.__enter__()
        t_w0 = time.perf_counter()
        with run.spans("window"):
            work = runner.window(run, state)
            _sync(run.device)
        t_w1 = time.perf_counter()
        if prof is not None:
            prof.__exit__(None, None, None)
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        work["window_peak_bytes"] = window_peak
        prog = runner.answers(run, state, work)
    del state
    gc.collect()
    bad = loaded(FORBIDDEN)
    if bad:
        raise RuntimeError(f"modules loaded in the run: {', '.join(bad)}")
    trace = read_trace(prof) if prof is not None else None
    del prof
    readings = Readings(run, setup_s=t_w0 - run.t_start,
                        window_s=t_w1 - t_w0, work=work, trace=trace)
    # the reference, once the program's state is freed
    ref = runner.reference_answers(run, prog)
    numbers = runner.compare(prog, ref)
    limits = layout.limits(cell["name"])
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(v["value"] <= v["limit"] for v in checks.values())
    if run.trace:
        for k in run.traffic["rooflines"]:
            readings.roofline[k] = layout.module("rooflines", k).least_s(
                run, runner.counts(run, prog))
    metrics = read_metrics(layout, readings,
                           layout.metrics(cell["name"], run.trace))
    if cuda:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cell["chips"],
               "memory_peak_bytes": max(setup_peak, window_peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    out = {"correct": ok, "attempted": work["units"],
           "failed": 0 if ok else runner.checked(prog), "metrics": metrics,
           "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
        out["breakdown"] = trace.breakdown()
    out["checks"] = checks
    return out
