"""The benchmark's driver: finds a cell by name, runs it once, judges it
against the plain reference and reports the contract's JSON line.

Everything that belongs to one cell is found by name, so a new cell,
configuration, traffic mix or metric is a new file:
- `BENCHMARK.json` (the checkout's root): the cell's configuration,
  traffic, chips and metrics;
- `portbench/configs/<config>.json`: the configuration as it is run (its
  artifact, topology, precision, the limit of each compared number, and
  under `reference` the name of its plain reference);
- `portbench/reference/<reference>.py`: the configuration's plain
  reference, which imports nothing of the program and provides
  `load(artifact) -> net` (its own decoding of the artifact),
  `check(net, config)` (raises ValueError unless the artifact is the
  configuration the file states) and
  `forward(net, x, *, device, dtype=torch.float32) -> logits [N, classes]`
  (every input, blocked by the reference itself; `dtype` the precision of
  the output arithmetic: float32 as the configuration states, lower for
  the control);
- `portbench/traffic/<traffic>.json`: the traffic mix, whose `kind` names
  the loop `portbench/traffic/<kind>.py` that drives it;
- `portbench/metrics/<metric>.py`: one reader per metric, `read(rec)`,
  which returns a number or None (nothing to read: left out).

A run: set-up (the kind's inputs from the seed, the program, warm-up),
the measured window, the device's memory peak, the program released,
then the reference over every input the window answered and the
comparison. A kind module provides `inputs(ctx)`, `setup(ctx, inputs)`,
`window(state, inputs, ctx, tracer)`, `release(state)` and
`reference_inputs(inputs)`.
"""

from __future__ import annotations

import bisect
import contextlib
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names that must not be loaded in a run (whole names:
# the port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "bnn_pynq_tpu")
# the traced slice at the end of a `--trace 1` window, seconds
TRACE_SLICE_S = 2.0


# -- finding a cell by name ---------------------------------------------------
@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    kind: object                      # the traffic kind's module
    reference: object                 # the configuration's reference module
    end_to_end: List[dict]            # BENCHMARK.json entries, in order
    per_layer: List[dict]


_modules: Dict[Path, object] = {}


def load_module(path: Path):
    """Import a file of the benchmark by its path (names may hold dots)."""
    path = Path(path).resolve()
    if path not in _modules:
        if not path.is_file():
            raise FileNotFoundError(f"no such benchmark file: {path}")
        modname = "portbench._by_path." + path.stem.replace(".", "_") \
            .replace("-", "_")
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod    # dataclasses look their module up
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return _modules[path]


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root/BENCHMARK.json`, with its files."""
    root = Path(root)
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                       f"{sorted(cells)}")
    w = cells[name]
    bdir = root / "portbench"
    config_path = bdir / "configs" / f"{w['config']}.json"
    config = _read_json(config_path)
    if "reference" not in config:
        raise ValueError(f"{config_path} names no plain reference "
                         f"(its key 'reference')")
    reference = load_module(bdir / "reference" / f"{config['reference']}.py")
    traffic = _read_json(bdir / "traffic" / f"{w['traffic']}.json")
    kind = load_module(bdir / "traffic" / f"{traffic['kind']}.py")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name, w["chips"], w["config"], config, traffic, kind,
                reference, e2e, per_layer)


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    return load_module(Path(root) / "portbench" / "metrics"
                       / f"{name}.py").read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


# -- what a run records --------------------------------------------------------
@dataclass
class Window:
    """What a kind's window returns."""
    seconds: float                    # host clock, first request to last
    images: int                       # images answered in the window
    attempted: int                    # answers due (images)
    failed: int                       # answers that raised or never came
    answers: list                     # [(ids, served classes)]
    latencies_ms: Optional[np.ndarray] = None   # per request, from due
    lag_ms: Optional[np.ndarray] = None         # send time - due time
    counters: Dict[str, float] = field(default_factory=dict)


@dataclass
class Trace:
    """The profiler's view of the traced slice (timestamps in us), and the
    harness's counts before it and in it."""
    slice_s: float                    # host clock length of the slice
    t0: float
    t1: float
    device: list                      # (name, cat, ts, dur)
    annotations: list                 # (name, ts, dur), the harness's spans
    counts: Dict[str, float]          # the harness's counts in the slice
    pre_s: float                      # window seconds before the slice
    pre_counts: Dict[str, float]      # the harness's counts before it


@dataclass
class Record:
    """Everything a metric reader may read."""
    cell: Cell
    setup_s: float
    window: Window
    spans: Dict[str, List[float]]     # span name -> durations (s), traced
    trace: Optional[Trace]


class Tracer:
    """Spans and counts around the harness's calls into the program, and
    a torch.profiler trace of a slice at the window's end: it begins
    TRACE_SLICE_S before the window's close, and a closed loop runs on
    until the slice is that long. Off (`--trace 0`) every call is a
    no-op."""

    def __init__(self, enabled: bool, seconds: float):
        self.enabled = enabled
        self.slice_s = min(TRACE_SLICE_S, seconds / 2)
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self.counts: Dict[str, float] = defaultdict(float)
        self.trace: Optional[Trace] = None
        self._prof = None
        self._slice_fn = None
        self._w0 = self._t0 = 0.0
        self._pre = (0.0, {})
        self.start_s = 0.0                # the profiler's start in the window

    def _profile(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        sets up the device tracing and takes seconds."""
        if self.enabled:
            prof = self._profile()
            prof.start()
            prof.stop()

    @contextlib.contextmanager
    def _span(self, name):
        t = time.perf_counter()
        if self._prof is not None:
            from torch.profiler import record_function
            with record_function(name):
                yield
        else:
            yield
        self.spans[name].append(time.perf_counter() - t)

    def span(self, name: str):
        return self._span(name) if self.enabled else contextlib.nullcontext()

    def count(self, name: str, n: float = 1) -> None:
        if self.enabled:
            self.counts[name] += n

    def start_window(self) -> float:
        self._w0 = time.perf_counter()
        return self._w0

    def begin_slice(self) -> None:
        if not self.enabled or self._prof is not None or \
                self.trace is not None:
            return
        from torch.profiler import record_function
        self._pre = (time.perf_counter() - self._w0, dict(self.counts))
        t = time.perf_counter()
        self._prof = self._profile()
        self._prof.start()
        self._slice_fn = record_function("pb.slice")
        self._slice_fn.__enter__()
        self._t0 = time.perf_counter()
        self.start_s = self._t0 - t

    def deadline(self, deadline: float) -> float:
        """A closed loop's deadline: the window's, or later, until the
        slice is TRACE_SLICE_S long."""
        if self._prof is None:
            return deadline
        return max(deadline, self._t0 + self.slice_s)

    def end_slice(self) -> None:
        if self._prof is None:
            return
        slice_s = time.perf_counter() - self._t0
        self._slice_fn.__exit__(None, None, None)
        prof, self._prof = self._prof, None
        prof.stop()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            events = _read_json(Path(path))
        pre_s, pre = self._pre
        counts = {k: v - pre.get(k, 0.0) for k, v in self.counts.items()}
        self.trace = _parse_trace(events, slice_s, counts, pre_s, pre)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _parse_trace(events, slice_s: float, counts, pre_s: float,
                 pre_counts) -> Trace:
    evs = events["traceEvents"] if isinstance(events, dict) else events
    device, notes = [], []
    t0 = t1 = None
    for e in evs:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat"), float(e["ts"]), float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            device.append((e["name"], cat, ts, dur))
        elif cat == "user_annotation" and e["name"].startswith("pb."):
            if e["name"] == "pb.slice":
                t0, t1 = ts, ts + dur
            else:
                notes.append((e["name"], ts, dur))
    if t0 is None:
        stamps = [ts for _, _, ts, _ in device] + [ts for _, ts, _ in notes]
        t0 = min(stamps, default=0.0)
        t1 = t0 + slice_s * 1e6
    return Trace(slice_s, t0, t1, device, notes, counts, pre_s, pre_counts)


def busy_intervals(trace: Trace) -> List[tuple]:
    """The union of the device's operation intervals (us), clipped to the
    slice, sorted."""
    iv = sorted((max(ts, trace.t0), min(ts + dur, trace.t1))
                for _, _, ts, dur in trace.device)
    out: List[list] = []
    for a, b in iv:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def busy_s(trace: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(trace)) * 1e-6


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time, and the idle time by
    the harness span open on the host (the innermost at a gap's middle)."""
    ops: Dict[str, float] = defaultdict(float)
    for name, _, _, dur in trace.device:
        ops[name] += dur * 1e-6
    idle: Dict[str, float] = defaultdict(float)
    edges = [trace.t0] + [x for iv in busy_intervals(trace) for x in iv] \
        + [trace.t1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    mids = [(a + b) / 2 for a, b in gaps]
    labels = ["pb.other"] * len(gaps)
    widths = [math.inf] * len(gaps)
    for name, ts, dur in trace.annotations:
        for i in range(bisect.bisect_left(mids, ts),
                       bisect.bisect_right(mids, ts + dur)):
            if dur < widths[i]:
                labels[i], widths[i] = name, dur
    for (a, b), label in zip(gaps, labels):
        idle[label[3:]] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),  # noqa: E731
                                               key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}


# -- a run ---------------------------------------------------------------------
@dataclass
class Ctx:
    """What a kind's functions get: the cell, the seed, the window length,
    the device, a torch.Generator on it and a numpy Generator, both
    seeded from the seed."""
    cell: Cell
    seed: int
    seconds: float
    device: str
    generator: object
    rng: np.random.Generator          # host-side draws from the seed
    artifact: str
    params: dict                      # the traffic mix, with any overrides
    fault: Optional[Callable] = None  # wraps the engine (tests)


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def build_program() -> None:
    """The port's install step and kernel library: `native.build()`
    (`make -C native`) and the CUDA kernels (`ops/_build.py`, cached in
    `bnn_pynq_tpu_torch/_build/` inside the checkout)."""
    from bnn_pynq_tpu_torch import native
    if not native.build(quiet=True):
        raise RuntimeError("native.build() failed: make -C native")
    import torch
    if torch.cuda.is_available():
        from bnn_pynq_tpu_torch.ops import _build
        _build.library()


def make_ctx(cell: Cell, seed: int, seconds: float, device: str,
             overrides: dict = None, fault: Callable = None,
             root: Path = ROOT) -> Ctx:
    """The cell's context for one seed; the configuration's reference
    checks that the artifact is the configuration the file states."""
    import torch
    artifact = str(Path(root) / cell.config["artifact"])
    cell.reference.check(cell.reference.load(artifact), cell.config)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 64))
    rng = np.random.default_rng(seed % (1 << 64))
    params = dict(cell.traffic, **(overrides or {}))
    return Ctx(cell, seed, seconds, device, gen, rng, artifact, params,
               fault)


def run(cell: Cell, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str = "cuda", overrides: dict = None,
        fault: Callable = None, root: Path = ROOT) -> dict:
    """Run `cell` once; returns the result's fields (see `report`)."""
    import torch
    cuda = device.startswith("cuda")
    ctx = make_ctx(cell, seed, seconds, device, overrides, fault, root)
    kind = cell.kind
    build_program()
    inputs = kind.inputs(ctx)
    state = kind.setup(ctx, inputs)
    tracer = Tracer(trace, seconds)
    tracer.warm()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    try:
        win = kind.window(state, inputs, ctx, tracer)
    finally:
        tracer.end_slice()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind.release(state)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref_s = time.perf_counter()
    checks = judge(cell, ctx, kind.reference_inputs(inputs), win)
    ref_s = time.perf_counter() - ref_s
    rec = Record(cell, setup_s, win, dict(tracer.spans), tracer.trace)
    return {"rec": rec, "checks": checks, "memory_peak_bytes": int(peak),
            "reference_s": ref_s, "profiler_start_s": tracer.start_s}


def judge(cell: Cell, ctx: Ctx, ref_inputs, win: Window) -> dict:
    """The reference over the inputs, and every answer of the window
    against it: the widest gap in logits over the answers that name a
    class, the answers that name none, and the answers that never came
    or raised. Each is correct at or under its limit."""
    from portbench.reference import judge as jg
    ref = cell.reference.forward(cell.reference.load(ctx.artifact),
                                 ref_inputs, device=ctx.device)
    widest, invalid = jg.widest_gap(ref.cpu().numpy(), win.answers)
    return {
        "widest_gap": {"value": widest,
                       "limit": cell.config["limits"]["widest_gap"]},
        "invalid_class": {"value": invalid, "limit": 0},
        "unanswered": {"value": int(win.failed), "limit": 0},
    }


def is_correct(checks: dict, attempted: int) -> bool:
    """Every compared number at or under its limit, and some answer due."""
    return attempted > 0 and all(c["value"] <= c["limit"]
                                 for c in checks.values())


def metrics_of(rec: Record, trace: bool, root: Path = ROOT) -> dict:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on), each read by its own reader; None leaves it out."""
    out = {}
    specs = rec.cell.per_layer if trace else rec.cell.end_to_end
    for m in specs:
        v = metric_reader(m["name"], root)(rec)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def report(res: dict, trace: bool, device_name: str, power_w,
           root: Path = ROOT) -> dict:
    rec: Record = res["rec"]
    checks = res["checks"]
    line = {
        "correct": is_correct(checks, rec.window.attempted),
        "attempted": int(rec.window.attempted),
        "failed": int(rec.window.failed),
        "metrics": metrics_of(rec, trace, root),
        "device": {"platform": "gpu", "kind": device_name, "count": 1,
                   "memory_peak_bytes": res["memory_peak_bytes"],
                   "power_limit_w": power_w},
    }
    if trace:
        if rec.trace is not None:
            line["device"]["busy_s"] = busy_s(rec.trace)
            line["device"]["window_s"] = rec.trace.slice_s
            line["breakdown"] = breakdown(rec.trace)
        # the end-to-end readings of the traced run, for the overhead
        line["end_to_end_traced"] = metrics_of(rec, False, root)
    line["reference_s"] = res["reference_s"]
    if trace:
        line["profiler_start_s"] = res["profiler_start_s"]
    line["checks"] = checks
    return line


def main(args, t_start: float) -> int:
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    power = power_limit_w()
    res = run(cell, args.seed, args.seconds, bool(args.trace),
              t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that a run may not load: {bad}",
              file=sys.stderr)
        return 3
    line = report(res, bool(args.trace), torch.cuda.get_device_name(0),
                  power)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
