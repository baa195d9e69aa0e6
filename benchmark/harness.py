"""The benchmark's harness: finds a cell's configuration, traffic and
metric readers by name, runs the cell's driver, and builds the result.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own:

- `BENCHMARK.json` names the cell's configuration and traffic;
- `configs/<config>.json` holds the configuration's sizes, and the key
  `engine` names what it runs;
- `traffic/<traffic>.json` holds the mix's parameters, and the key
  `generator` names the module of `drivers/` that generates the mix from
  the seed, drives the program through the window and checks the answers;
- `metrics/<metric>.py` reads one per-layer metric from a traced run
  (`read(ctx)`, None where it finds nothing to read).

So a new cell of an existing kind is a data file, and a new per-layer
metric is one reader.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
#: caches of the cells' set-up (tables, parsed target lists): inside the
#: checkout, at fixed paths, so a checkout's later runs find them
CACHE_DIR = os.path.join(BENCH_DIR, "cache")
#: top-level module names that no run may hold once its window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "keyhunt_tpu")


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is a
    forbidden one, compared whole: keyhunt_tpu_torch is not keyhunt_tpu."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Cell:
    """What a driver gets: the cell's entries, its configuration and
    traffic, the run's arguments, and where to write."""
    name: str
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float                  # perf_counter at process start
    cache_dir: str
    tmp_dir: str
    control: bool = False           # run the control in the program's place
    shared: dict = dataclasses.field(default_factory=dict)


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    out.update(over or {})
    return out


def cell_entries(name: str, man: dict | None = None):
    """(workload, configuration entry, end-to-end metrics, per-layer
    metrics) of cell `name`, as BENCHMARK.json lists them."""
    man = man or manifest()
    wl = next((w for w in man["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in man["configs"] if c["name"] == wl["config"])
    e2e = [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return wl, cfg, e2e, layer


def load_reader(metric: str):
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             overrides: dict | None = None, control: bool = False,
             shared: dict | None = None, cache_dir: str = CACHE_DIR,
             man: dict | None = None) -> dict:
    """Run cell `name` of `man` (BENCHMARK.json by default) once; returns
    the result line as a dict. overrides ({"config": {...}, "traffic":
    {...}}) resize a cell for the CPU tests."""
    t_start = time.perf_counter() if t_start is None else t_start
    overrides = overrides or {}
    wl, cfg_entry, e2e, layer = cell_entries(name, man)
    config = _merge(load_json(os.path.join(ROOT, cfg_entry["file"])),
                    overrides.get("config"))
    traffic = _merge(load_json(os.path.join(BENCH_DIR, "traffic",
                                            wl["traffic"] + ".json")),
                     overrides.get("traffic"))
    driver = importlib.import_module("benchmark.drivers." + traffic["generator"])
    tmp_dir = tempfile.mkdtemp(prefix="kh-bench-")
    try:
        cell = Cell(name=name, config_name=cfg_entry["name"],
                    traffic_name=wl["traffic"], config=config, traffic=traffic, seed=seed,
                    seconds=seconds, trace=trace, device=device,
                    t_start=t_start, cache_dir=cache_dir, tmp_dir=tmp_dir,
                    control=control, shared=shared if shared is not None else {})
        out = driver.run(cell)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return result_line(out, e2e if not trace else [], layer if trace else [])


def result_line(out: dict, e2e: list, layer: list) -> dict:
    """The line the benchmark prints: `out` is a driver's result."""
    metrics = {}
    for m in e2e:
        v = out["e2e"].get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    for m in layer:
        v = load_reader(m["name"])(out.get("layer_ctx", {}))
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = out["checks"]
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": out["device"]}
    if out.get("breakdown"):
        line["breakdown"] = out["breakdown"]
    line["info"] = out.get("info", {})
    line["check"] = checks
    return line


def device_info(device: str, count: int = 1) -> dict:
    import torch
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": count,
                "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                             for i in range(count)))}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": 0}


def p95(values: list[float]) -> float:
    """Nearest-rank 95th percentile (an entry of `values`)."""
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


def sync(device: str) -> None:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


class Tracer:
    """A torch.profiler trace of one stretch of a window: `tick()` once
    before each dispatch (or query); the trace opens at tick `skip` + 1
    and closes at tick `skip` + `count` + 1 or at `finish()`. The device is
    synchronised at both ends, so the stretch holds all of its own work.
    Launches are counted by kernel and width over the same stretch (the
    program's `_build.LAUNCH_WIDTHS`)."""

    def __init__(self, enabled: bool, device: str, prefix: str,
                 skip: int, count: int):
        self.enabled, self.device, self.prefix = enabled, device, prefix
        self.skip, self.count = skip, count
        self.ticks = 0
        self.traced = 0
        self._prof = self._window = None
        self.result = None

    def warm(self) -> None:
        """Start and stop the profiler once, so that its first start
        (CUPTI's set-up) falls in the set-up."""
        if not self.enabled:
            return
        import torch
        from torch.profiler import profile
        with profile(activities=self._activities()):
            torch.ones(8, device=self.device).sum().item()

    def _activities(self):
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    def tick(self) -> None:
        if not self.enabled:
            return
        self.ticks += 1
        if self.ticks == self.skip + 1:
            self._start()
        elif self.ticks == self.skip + self.count + 1:
            self.finish()
        if self._prof is not None:
            self.traced += 1

    def _start(self) -> None:
        import torch
        from torch.profiler import profile
        from keyhunt_tpu_torch import _build
        sync(self.device)
        self._launches0 = dict(_build.LAUNCH_WIDTHS)
        self._prof = profile(activities=self._activities())
        self._prof.start()
        self._window = torch.profiler.record_function("bench.window")
        self._window.__enter__()

    def finish(self) -> None:
        if self._prof is None:
            return
        from torch.autograd import DeviceType
        from keyhunt_tpu_torch import _build
        sync(self.device)
        self._window.__exit__(None, None, None)
        self._prof.stop()
        launches = {k: v - self._launches0.get(k, 0)
                    for k, v in _build.LAUNCH_WIDTHS.items()
                    if v - self._launches0.get(k, 0) > 0}
        cpu, dev, window = [], [], None
        for e in self._prof.profiler.kineto_results.events():
            start = e.start_ns()
            row = (start, start + e.duration_ns(), e.name(), e.correlation_id())
            if e.device_type() == DeviceType.CPU:
                if row[2] == "bench.window":
                    window = (row[0], row[1])
                cpu.append(row)
            elif e.device_type() == DeviceType.CUDA:
                dev.append(row)
        self._prof = None
        if window is None or self.traced == 0:
            return
        from . import yardstick
        self.result = {"trace": yardstick.reduce_trace(cpu, dev, self.prefix, window),
                       "launch_widths": launches, "ticks": self.traced}


def tick_each_dispatch(eng, tracer: Tracer) -> None:
    """In a traced run, tick `tracer` before each of the engine's
    dispatches (its `_dispatch`, which every dispatch goes through)."""
    if tracer.enabled:
        dispatch = eng._dispatch

        def traced(*args):
            tracer.tick()
            return dispatch(*args)
        eng._dispatch = traced


def attach_trace(out: dict, tracer: Tracer, **ctx) -> None:
    """Put a traced stretch into a driver's result: the device's busy and
    traced seconds, the breakdown, and what the per-layer readers read
    (`ctx` beside the trace)."""
    out["layer_ctx"] = dict(ctx)
    if tracer.result:
        t = tracer.result["trace"]
        out["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        out["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
        out["layer_ctx"].update(tracer.result)
