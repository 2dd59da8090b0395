"""The harness: finds a cell's configuration, traffic, limits, kind and
per-layer metrics by name, runs the cell once and builds its result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own (README.md):

  BENCHMARK.json                      cells, metrics, configurations
  benchmark/configs/<config>.json     the model as run
  benchmark/traffic/<traffic>.json    a mix: its kind and parameters
  benchmark/kinds/<kind>.py           the generator and driver of a kind
  benchmark/workloads/<cell>.json     the cell's limits of `correct`
  benchmark/metrics/<metric>.py       a per-layer metric's reader
  benchmark/models/<model>.py         a configuration's model: weights,
                                      plain forward, FLOPs, kernel names
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# top-level module names no run may hold once its window has closed: the
# JAX stack and the JAX package (compared whole: the port's name starts
# with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "gnn_tumor_seg_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def import_file(path: str, name: str):
    """A module from a file of the benchmark, imported as a submodule of
    `benchmark` so its relative imports resolve."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list[str]:
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN_MODULES))


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the BENCHMARK.json workload
    config: dict
    traffic: dict
    limits: dict


def load_benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def bench_dir(root: str = ROOT) -> str:
    return os.path.join(root, "benchmark")


def load_cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[entry["config"]]["file"]))
    traffic = load_json(os.path.join(bench_dir(root), "traffic", f"{entry['traffic']}.json"))
    limits = load_json(os.path.join(bench_dir(root), "workloads", f"{name}.json"))["limits"]
    return Cell(name, entry, config, traffic, limits)


def cell_metrics(bench: dict, cell: str, section: str) -> list[dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") a cell
    reports: those listing it, and those without a list whose moved (or
    own) end-to-end metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m.get("moves", m["name"]) in e2e:
            out.append(m)
    return out


@dataclasses.dataclass
class Run:
    """What a kind is given: the cell, the run's arguments, its device, its
    tracer and a scratch directory under TMPDIR (removed at the end)."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    tracer: object
    scratch: str
    overrides: dict = dataclasses.field(default_factory=dict)
    marks: list = dataclasses.field(default_factory=list)

    def param(self, key):
        return self.overrides.get(key, self.cell.traffic[key])

    def mark(self, name: str) -> None:
        """Note that set-up finished `name` (printed to standard error)."""
        self.marks.append((name, time.perf_counter()))


def device_info(device, devices=None) -> dict:
    """The run's device: this process's, or where a kind's ranks ran in
    processes of their own and it reports `devices` (the peak bytes of each
    device they used), their number and the fullest one's peak."""
    import torch

    if device.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    if devices:
        info.update(count=len(devices),
                    memory_peak_bytes=max(int(b) for b in devices))
    return info


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             overrides: dict | None = None, t_start: float | None = None,
             root: str = ROOT) -> tuple[dict, dict]:
    """Run one cell once. Returns (the result line, the compared numbers
    with their limits). `overrides` replace traffic parameters (the tests'
    small sizes)."""
    import torch

    from .trace import Tracer

    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_benchmark(root)
    cell = load_cell(bench, name, root)
    kind = import_file(os.path.join(bench_dir(root), "kinds", f"{cell.traffic['kind']}.py"),
                       f"benchmark.kinds.{cell.traffic['kind']}")
    dev = torch.device(device)
    scratch = tempfile.mkdtemp(prefix="bench_")
    run = Run(cell, int(seed), float(seconds), bool(trace), dev, Tracer(bool(trace), dev),
              scratch, dict(overrides or {}))
    try:
        state = kind.setup(run)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t_start
        prev = t_start
        for step, t in run.marks:
            print(f"setup {step} {t - prev:.3f} s", file=sys.stderr)
            prev = t
        print(f"setup total {setup_s:.3f} s", file=sys.stderr, flush=True)
        out = kind.window(state, run)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dev_info = device_info(dev, out.get("devices"))
        numbers = kind.judge(state, run)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    checks = {k: {"value": float(numbers.get(k, math.inf)), "limit": float(v)}
              for k, v in cell.limits.items()}
    correct = (all(c["value"] <= c["limit"] for c in checks.values())
               and out["failed"] == 0 and out["attempted"] > 0)
    metrics = {}
    if not trace:
        values = dict(out["e2e"], setup_s=setup_s)
        for m in cell_metrics(bench, name, "end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    else:
        record = dict(out["record"], trace=run.tracer.result)
        for m in cell_metrics(bench, name, "per_layer"):
            reader = import_file(os.path.join(bench_dir(root), "metrics", f"{m['name']}.py"),
                                 f"benchmark.metrics.{m['name'].replace('.', '_')}")
            value = reader.read(record, cell)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if run.tracer.result is not None:
            dev_info["busy_s"] = run.tracer.result["busy_s"]
            dev_info["window_s"] = run.tracer.result["window_s"]
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": dev_info}
    if trace and run.tracer.result is not None:
        result["breakdown"] = run.tracer.breakdown()
    result["checks"] = checks
    return result, checks
