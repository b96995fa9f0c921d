"""One run of one benchmark cell: the harness behind ``benchmark/run.py``.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is found by its name in ``BENCHMARK.json`` and in files
of its own under ``benchmark/``:

- ``configs/<config>.json``: the configuration as it is run (shapes,
  ``source``, ``assumed``); its ``generator`` and ``reference`` keys name
  ``generators/<name>.py`` (makes the inputs from the seed) and
  ``reference/<name>.py`` (the plain reference);
- ``traffic/<mix>.json``: the job's parameters; its ``loop`` key names
  ``loops/<name>.py``, which drives the program (set-up, one timed unit,
  the outputs) and judges the outputs with the plain reference;
- ``limits/<cell>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: one reader a per-layer metric, ``read(record)``
  returning the value, or None when the run holds nothing to read.

A run: set-up (data, the program's build, warm-up) is timed from process
start; the window repeats the loop's unit until ``--seconds`` have passed
(the unit that crosses the mark completes and counts); with ``--trace 1``
the window runs under ``torch.profiler``. Then the peak device memory is
read, the program's state is freed, and the loop judges its outputs.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

# top-level module names no benchmark process may hold: JAX and the JAX
# package (the port's own name begins with it, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "photon_ml_tpu")


class BenchmarkError(Exception):
    """A cell, file or device the run needs is missing or malformed."""


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py``, loaded once by its path (a metric's
    name may hold dots)."""
    key = "_bench_" + kind + "__" + name.replace(".", "__").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if not os.path.isfile(path):
        raise BenchmarkError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    """One entry of ``workloads`` with the files it names, loaded."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def find_cell(name: str, root: str = ROOT) -> Cell:
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise BenchmarkError(f"no workload named {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        traffic_name=w["traffic"], config=config,
        traffic=load_json(os.path.join(root, "benchmark", "traffic", w["traffic"] + ".json")),
        limits=load_json(os.path.join(root, "benchmark", "limits", name + ".json")),
        end_to_end=[m for m in spec["end_to_end"] if applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if applies(m, name)],
    )


@dataclass
class Record:
    """What one run measured, for the per-layer readers. ``layer`` holds
    the loop's readings by name (host-clock spans, counters, set-up
    parts); ``shapes`` the input counts the yardstick reads (nonzeros,
    rows, features, bank members); ``required_s`` the least device time of
    the window's required work, counted by the loop from the solvers'
    results (``peaks.py``); ``trace`` the device trace of a traced run."""

    cell: Cell
    units: int = 0
    window_s: float = 0.0
    layer: Dict[str, object] = field(default_factory=dict)
    shapes: Dict[str, int] = field(default_factory=dict)
    required_s: float = 0.0
    trace: Optional[object] = None


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device="cuda",
             start: Optional[float] = None) -> dict:
    """One run; -> the result line's object (``checks`` last). ``start``:
    the process's start on ``time.perf_counter``'s clock (set-up is timed
    from it)."""
    import torch

    start = time.perf_counter() if start is None else start
    loop = module("loops", cell.traffic["loop"])
    record = Record(cell)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    state = loop.setup(cell, seed, device, record, traced)
    _sync(device)
    setup_s = time.perf_counter() - start

    ends = []
    with contextlib.ExitStack() as traced_window:
        if traced:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
            prof = traced_window.enter_context(profile(activities=acts))
            traced_window.enter_context(record_function("bench.window"))
        t0 = time.perf_counter()
        while True:
            loop.step(state)
            record.units += 1
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        _sync(device)
        record.window_s = time.perf_counter() - t0
        t_read = time.perf_counter()
    if traced:
        import devtrace

        record.trace = devtrace.from_profiler(prof, "bench.window")
        del prof
    t_read = time.perf_counter() - t_read
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    loop.window_closed(state, record)

    # the program's outputs are kept; its state goes before the reference runs
    outputs = loop.outputs(state)
    del state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    numbers = loop.judge(cell, seed, device, outputs)
    t_judge = time.perf_counter() - t_judge
    units = [round(b - a, 4) for a, b in zip([0.0] + ends, ends)]
    print(f"bench {cell.name} seed {seed}: set-up {setup_s:.3f} s, window {record.window_s:.3f} s "
          f"over {record.units} units {units}, trace read {t_read:.3f} s, reference {t_judge:.3f} s; "
          f"{loop.summary(record)}", file=sys.stderr)
    checks = {k: {"value": None if numbers.get(k) is None else float(numbers[k]), "limit": float(lim)}
              for k, lim in cell.limits.items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    unit_metric = cell.traffic["unit_metric"]
    values = {"setup_s": setup_s, unit_metric: record.window_s / record.units}
    if traced:
        for m in cell.per_layer:
            v = module("metrics", m["name"]).read(record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    out = {
        "correct": bool(correct),
        "attempted": record.units,
        "failed": record.units if not correct else 0,
        "metrics": metrics,
        "device": device_info(device, cell.chips, peak),
    }
    if traced:
        tr = record.trace
        out["device"]["busy_s"] = tr.busy_s if on_card else 0.0
        out["device"]["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    out["checks"] = checks
    return out


def device_info(device, count: int, peak: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(device),
        "count": int(count),
        "memory_peak_bytes": int(peak),
    }
