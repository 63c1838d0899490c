"""One run of one cell: ``python3 benchmark/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>`` from the root of a checkout.

Everything that belongs to one configuration, traffic kind or per-layer
metric is a file found by its name:

- ``BENCHMARK.json`` (the checkout's root): the cells, the end-to-end
  metrics with the cells that report them, and the per-layer metrics;
- ``benchmark/configs/<file>``: a configuration, with the name of the
  generator (``benchmark/generators/<generator>.py``) that makes its
  input from the seed;
- ``benchmark/workloads/<cell>.json``: the traffic kind
  (``benchmark/jobs/<kind>.py``) and its parameters;
- ``benchmark/metrics/<metric>.py``: the reader of one per-layer metric.

A run makes the input, lets the job warm up every shape it uses (the
set-up), freezes the objects that set-up left out of the collector's
full passes (``gc.freeze``), measures for ``--seconds`` (with ``--trace 1`` under
``torch.profiler``, reading the per-layer metrics instead of the
end-to-end ones), frees the program's state, has the plain reference
judge what the window produced, and prints one JSON line.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

from benchmark.harness import trace as T

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "disq_tpu")
PROGRAM = "disq_tpu_torch"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)


class RunError(Exception):
    """A run that cannot give a result; ``code`` is its exit code."""

    def __init__(self, msg: str, code: int = 1) -> None:
        super().__init__(msg)
        self.code = code


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise RunError(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: str, bench_dir: str = BENCH_DIR) -> None:
        self.root = root
        self.bench_dir = bench_dir
        self.doc = load_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise RunError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise RunError(f"no config {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return load_json(os.path.join(self.bench_dir, "workloads",
                                      f"{name}.json"))

    def job(self, kind: str):
        return load_module(os.path.join(self.bench_dir, "jobs", f"{kind}.py"),
                           f"benchmark_job_{kind}")

    def generator(self, name: str):
        return load_module(os.path.join(self.bench_dir, "generators",
                                        f"{name}.py"),
                           f"benchmark_generator_{name}")

    def reader(self, metric: str):
        return load_module(os.path.join(self.bench_dir, "metrics",
                                        f"{metric}.py"),
                           "benchmark_metric_" + metric.replace(".", "_")
                           .replace("-", "_"))

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.doc["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.doc["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]


class Context:
    """What a job and a reader see of one run."""

    def __init__(self, *, root, work, config, workload, seed, seconds,
                 trace, device, torch, port) -> None:
        self.root, self.work = root, work
        self.config, self.workload = config, workload
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.torch, self.port = device, torch, port
        self.inputs: Dict[str, Any] = {}

    @property
    def params(self) -> dict:
        return self.workload.get("params", {})

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)


class Measure:
    """A traced window's readings, handed to each per-layer reader:
    ``spans`` (the program's host spans inside the window, seconds of
    ``time.perf_counter``), ``launches`` and ``counters`` (the program's
    books, deltas over the window), ``events`` (the device's operations
    from the profiler, microseconds), ``window_s`` and ``busy_s`` (the
    device's union of operations), and the job's ``facts``."""

    def __init__(self, **kw) -> None:
        self.spans: List[dict] = kw.get("spans", [])
        self.launches: Dict[str, int] = kw.get("launches", {})
        self.counters: Dict[str, float] = kw.get("counters", {})
        self.events: List[dict] = kw.get("events", [])
        self.window_s: float = kw.get("window_s", 0.0)
        self.busy_s: float = kw.get("busy_s", 0.0)
        self.facts: Dict[str, Any] = kw.get("facts", {})
        self.notes: List[str] = []

    def note(self, msg: str) -> None:
        self.notes.append(msg)
        log(msg)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _counter_totals() -> Dict[str, float]:
    from disq_tpu_torch.runtime import tracing

    out = {}
    for name, m in tracing.REGISTRY.metrics().items():
        if m.kind == "counter":
            out[name] = float(m.total())
    return out


def forbidden_modules() -> List[str]:
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def _cache_env(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths.
    The program builds its kernels into its own ``_build`` there; these
    two are for what PyTorch itself would build."""
    cache = os.path.join(root, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(cache, sub)


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, *, device: Optional[str] = None,
             config_overrides: Optional[dict] = None,
             manifest: Optional[Manifest] = None,
             t_start: Optional[float] = None) -> dict:
    """Run one cell once and return the result line's object. On the
    card (``device`` None) a missing card raises; a test passes another
    ``device`` and smaller ``config_overrides``."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest or Manifest(root)
    cell = man.cell(workload)
    config = dict(man.config(cell["config"]), **(config_overrides or {}))
    wl = man.workload(workload)
    if wl.get("traffic") != cell["traffic"] or wl.get("config") != cell["config"]:
        raise RunError(f"benchmark/workloads/{workload}.json disagrees with "
                       f"BENCHMARK.json on its traffic or configuration")
    import torch

    chips = int(cell.get("chips", 1))
    if device is None:
        if not torch.cuda.is_available():
            raise RunError("CUDA is not available", 3)
        if torch.cuda.device_count() < chips:
            raise RunError(f"{torch.cuda.device_count()} CUDA devices, the "
                           f"cell asks for {chips}", 3)
        device = "cuda"
    dev = torch.device(device)
    if root not in sys.path:
        sys.path.insert(0, root)
    _cache_env(root)
    try:
        port = importlib.import_module(PROGRAM)
    except ImportError as e:
        raise RunError(f"the program {PROGRAM} cannot be imported: {e}", 2)
    from disq_tpu_torch.runtime import counters, tracing

    work = os.path.join(root, ".bench_work", workload)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ctx = Context(root=root, work=work, config=config, workload=wl,
                  seed=seed, seconds=seconds, trace=trace, device=dev,
                  torch=torch, port=port)
    job = man.job(wl["kind"])
    try:
        if dev.type == "cuda":
            torch.zeros(1, device=dev)   # the CUDA context
        t0 = time.perf_counter()
        ctx.inputs = man.generator(config["generator"]).make(
            config, seed, work)
        t1 = time.perf_counter()
        state = job.setup(ctx)
        ctx.sync()
        # the objects that set-up left (the imports, the input's making)
        # are kept out of the window's full collections: each of those
        # took 0.11-0.36 s of a 1.1-1.9 s read pass with them, 0.01-0.03 s
        # without them (one H100 machine, 4 executor workers)
        gc.collect()
        gc.freeze()
        log(f"set-up: start {t0 - t_start:.3f}s, input {t1 - t0:.3f}s, "
            f"warm-up {time.perf_counter() - t1:.3f}s")
        card = card_line() if dev.type == "cuda" else "cpu"
        measure = None
        marker = torch.zeros(1, device=dev)
        ctx.sync()
        if trace:
            tracing.set_span_ring_capacity(1 << 20)
            tracing.reset_spans()
            launches0 = counters.launches()
            totals0 = _counter_totals()
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        setup_s = time.perf_counter() - t_start
        # the window's start and end on the device's clock: one small
        # fill each, with nothing else in flight
        t_mark = time.perf_counter()
        marker.fill_(1.0)
        ctx.sync()
        win = job.window(ctx, state, seconds)
        ctx.sync()
        marker.fill_(2.0)
        ctx.sync()
        host_window_s = time.perf_counter() - t_mark
        if trace:
            prof.__exit__(None, None, None)
            path = os.path.join(work, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            spans = [s for s in tracing.spans() if s["ts"] >= t_mark]
            launches1 = counters.launches()
            totals1 = _counter_totals()
            measure = _measure(path, spans, launches0, launches1, totals0,
                               totals1, t_mark, host_window_s,
                               win.get("facts", {}))
            log(f"trace: host window {host_window_s:.3f}s, device window "
                f"{measure.window_s:.3f}s, first and last device events "
                f"{measure.facts['edges']}")
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        t0 = time.perf_counter()
        job.release(state)
        t1 = time.perf_counter()
        checks = job.verify(ctx, state, win)
        log(f"judged: release {t1 - t0:.3f}s, reference "
            f"{time.perf_counter() - t1:.3f}s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    metrics: Dict[str, dict] = {}
    if trace:
        for m in man.per_layer(workload):
            value = man.reader(m["name"]).read(measure)
            if value is None:
                log(f"{m['name']}: nothing to read, left out")
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            if m["name"].endswith("_roofline"):
                metrics[m["name"]]["card"] = card
    else:
        values = dict(win.get("e2e", {}), setup_s=setup_s)
        for m in man.end_to_end(workload):
            if m["name"] not in values:
                raise RunError(f"the job gave no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        raise RunError(f"modules that must not load were loaded: {found}", 4)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device_doc = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                  "count": chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(win["attempted"]),
              "failed": int(win.get("failed", 0)), "metrics": metrics,
              "device": device_doc}
    if trace:
        device_doc["busy_s"] = measure.busy_s
        device_doc["window_s"] = measure.window_s
        result["breakdown"] = measure.facts.get("breakdown", {})
    result["checks"] = checks
    return result


def _measure(path, spans, launches0, launches1, totals0, totals1, t_mark,
             host_window_s, facts) -> Measure:
    """The traced window on the trace's clock: from the start marker (the
    first device event) for as long as the host measured between the two
    markers; the end marker, when the trace holds it, is left out of the
    device's work with the start marker."""
    events = T.device_events(path)
    if not events:
        raise RunError("the profiler's trace holds no device operation")
    lo = events[0]["ts"]
    hi = lo + host_window_s * 1e6
    inner = events[1:]
    if inner and inner[-1]["dur"] < 100 and inner[-1]["ts"] > hi - 1e4:
        inner = inner[:-1]
    iv = T.union(T.event_intervals(inner), lo, hi)
    offset_us = lo - t_mark * 1e6
    facts = dict(facts)
    facts["edges"] = [[str(e.get("name"))[:60], e["ts"], e["dur"]]
                      for e in events[:2] + events[-2:]]
    facts["breakdown"] = {
        "device_ops": T.device_ops(inner),
        "idle_gaps": T.idle_gaps(iv, lo, hi, spans, offset_us)}
    return Measure(
        spans=spans,
        launches={k: launches1.get(k, 0) - launches0.get(k, 0)
                  for k in set(launches0) | set(launches1)},
        counters={k: totals1.get(k, 0.0) - totals0.get(k, 0.0)
                  for k in set(totals0) | set(totals1)},
        events=inner, window_s=(hi - lo) / 1e6,
        busy_s=sum(b - a for a, b in iv) / 1e6, facts=facts)


def print_checks(checks: dict) -> None:
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.path.dirname(BENCH_DIR)
    try:
        res = run_cell(root, args.workload, args.seed, args.seconds,
                       bool(args.trace), t_start=t_start)
    except RunError as e:
        log(f"FAILED: {e}")
        return e.code
    print_checks(res["checks"])
    print(json.dumps(res), flush=True)
    return 0
