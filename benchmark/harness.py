"""One run of one cell: set-up, the measured window, the comparison with the
plain reference, the metrics, and the result line.

Everything is found by name from data.  ``BENCHMARK.json`` names the cell's
configuration and traffic mix; ``configs/<config>.json`` holds the port's
``Config`` dict and the sizes the inputs are drawn from; ``traffic/<traffic>
.json`` names the entry that drives the port (``entries/<entry>.py``) and
its parameters; ``workloads/<cell>.json`` holds the limits of the numbers
the cell compares; ``metrics/<metric>.py`` reads one metric (see
:func:`reader_path` for the readers that several metrics share).

A run: the entry's set-up (the port's ``Trainer`` on the inputs made from
the seed, every shape of the cell warmed up) is timed as ``setup_s``; the
window then calls the entry while under ``--seconds`` and counts whole
calls.  The traced run (``--trace 1``) first records one call, or the part
of it the entry chooses, with torch.profiler, then runs the untraced
window.  After the window the peak memory is read, the port's state is
freed and the entry compares what the window produced with the reference.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

from benchmark import port
from benchmark import trace as tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hual_tpu")


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` and the files it is found by."""

    def __init__(self, name: str, bench: Optional[dict] = None):
        self.bench = bench if bench is not None else _read_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.spec = _read_json(ROOT / configs[self.workload["config"]]["file"])
        self.traffic = _read_json(HERE / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = _read_json(HERE / "workloads" / f"{name}.json")["limits"]
        self.entry = _load_module(HERE / "entries" / f"{self.traffic['entry']}.py",
                                  f"benchmark_entry_{self.traffic['entry']}")

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics this cell reports: end-to-end ones untraced,
        per-layer ones traced, each where its ``workloads`` list has it."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if "workloads" not in m or self.name in m["workloads"]]


class Context:
    """What an entry gets: the cell, the run's seed, the device, a work
    directory under ``TMPDIR`` and the tracer of a traced run."""

    def __init__(self, cell: Cell, seed: int, device: torch.device,
                 tracer: Optional[tracing.Tracer], workdir: str):
        self.cell, self.seed, self.device = cell, seed, device
        self.spec, self.traffic = cell.spec, cell.traffic
        self.tracer, self.workdir = tracer, workdir


def reader_path(name: str) -> Path:
    """The reader of metric ``name``: ``metrics/<name>.py``; else the reader
    of the part before the first dot (``idle_share.train`` reads with
    ``metrics/idle_share.py``); else, for a name ending in ``_per_s``,
    ``metrics/per_s.py`` (the window's work over its seconds)."""
    stems = [name, name.split(".")[0]] + (["per_s"] if name.endswith("_per_s") else [])
    for stem in stems:
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            return path
    raise FileNotFoundError(f"no reader for the metric {name!r} under {HERE / 'metrics'}")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", bench: Optional[dict] = None,
        entry_options: Optional[dict] = None) -> dict:
    """One run; returns the result dict (without printing it)."""
    device = torch.device(device)
    cell = Cell(workload, bench)
    workdir = tempfile.mkdtemp(prefix="hual-bench-")
    cwd = os.getcwd()
    os.chdir(workdir)          # the Trainer writes logs/ under the working directory
    try:
        tracer = tracing.Tracer(device, port.launches) if trace else None
        ctx = Context(cell, seed, device, tracer, workdir)
        entry = cell.entry.Entry(ctx, **(entry_options or {}))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t_start

        calls, units = [], []
        t0 = time.perf_counter()
        if tracer is not None:
            # the traced call, then a window of untraced calls for the
            # per-layer times that need no trace
            tracer.start()
            units.append(entry.call())
            tracer.stop()
            calls.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or len(calls) < 1 + (tracer is not None):
            c0 = time.perf_counter()
            units.append(entry.call())
            calls.append(time.perf_counter() - c0)
        window_s = time.perf_counter() - t0
        memory_peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
                       else 0)
        facts = {"setup_s": setup_s, "window_s": window_s, "calls": calls, "units": units,
                 "entry": entry.facts(), "spec": cell.spec, "traffic": cell.traffic}
        entry.release()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        numbers = entry.check()
        trace_facts = None
        if tracer is not None:
            trace_facts = tracing.reduce(tracer.events)
            tracing.check_launches(trace_facts, tracer.launched)
            facts["trace"] = trace_facts
        metrics = {}
        for m in cell.metrics(trace):
            reader = _load_module(reader_path(m["name"]),
                                  f"benchmark_metric_{m['name'].replace('.', '_')}")
            value = reader.read(facts)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    finally:
        os.chdir(cwd)
        shutil.rmtree(workdir, ignore_errors=True)

    compared = {}
    for name, value in numbers.items():
        if name not in cell.limits:
            raise KeyError(f"{workload}: no limit for the compared number {name!r}")
        compared[name] = {"value": value, "limit": cell.limits[name]}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": int(sum(units)),
              "failed": 0, "metrics": metrics, "device": dev}
    if trace_facts is not None:
        dev["busy_s"] = trace_facts["busy_s"]
        dev["window_s"] = trace_facts["window_s"]
        result["breakdown"] = trace_facts["breakdown"]
    result["calls_s"] = calls
    result["compared"] = compared
    return result
