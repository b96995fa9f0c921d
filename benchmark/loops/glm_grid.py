"""λ-grid fits of a sparse GLM through the port's trainers.

Traffic keys: ``mode`` (``batched``: ``train_grid_batched``, every λ from
zero in one bank; ``sequential``: ``train_generalized_linear_model``, λ
descending, each warm-started from the last), ``lambdas``, ``optimizer``,
``max_iter``, ``tolerance``, ``history`` (L-BFGS), ``kernel``, ``check_models``
(how many grid indices under 64 the check judges, drawn from the seed,
where the window reaches them; the last grid is always judged).

Set-up makes the rows (the configuration's generator), builds the tiled
batch once (``build_tiled_batch``: the two schedules, timed as
``schedule_build_s``) and fits one grid to warm up. A unit is one grid fit
on that batch, ended by a synchronisation. The schedule cache is off
(``PHOTON_TILE_CACHE_DIR`` is cleared by ``run.py``): a run builds.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

import harness
import peaks


@dataclass
class State:
    cell: object
    seed: int
    device: object
    tb: object
    kw: dict
    trainer: object
    data: dict
    fetches: List[int] = field(default_factory=list)
    passes: List[int] = field(default_factory=list)  # K2 launches a grid
    iterations: List[List[int]] = field(default_factory=list)
    judged: set = field(default_factory=set)  # the grids the check reads, by index
    grids: dict = field(default_factory=dict)
    last: dict = None


def _trainer(mode: str):
    from photon_ml_tpu_torch import training

    return {"batched": training.train_grid_batched,
            "sequential": training.train_generalized_linear_model}[mode]


def setup(cell, seed, device, record, traced):
    from photon_ml_tpu_torch.ops.tiled_sparse import build_tiled_batch
    from photon_ml_tpu_torch.optim.config import OptimizerType, RegularizationType

    cfg, tr = cell.config, cell.traffic
    data = harness.module("generators", cfg["generator"]).generate(cfg, seed, device)
    feats, vals, labels = data["feats"], data["vals"], data["labels"]
    n, k = feats.shape
    d = int(cfg["features"])
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    t0 = time.perf_counter()
    tb = build_tiled_batch(
        rows, feats.reshape(-1), vals.reshape(-1), labels,
        np.zeros(n, np.float32), np.ones(n, np.float32), d, device=device,
    )
    harness._sync(device)
    record.layer["schedule_build_s"] = time.perf_counter() - t0
    del rows
    record.shapes.update(nnz=int(np.count_nonzero(vals)), rows=n, features=d,
                         members=len(tr["lambdas"]))
    kw = dict(
        optimizer_type=OptimizerType[tr["optimizer"]],
        regularization_type=RegularizationType.L2,
        regularization_weights=list(tr["lambdas"]), max_iter=int(tr["max_iter"]),
        tolerance=float(tr["tolerance"]), intercept_index=d - 1,
        kernel=tr["kernel"], device=device,
    )
    state = State(cell, seed, device, tb, kw, _trainer(tr["mode"]), data)
    step(state)  # warm-up: the allocator, the kernels' launch plans
    state.fetches.clear()
    state.passes.clear()
    state.iterations.clear()
    rng = np.random.default_rng([int(seed), 7])
    state.judged = set(rng.choice(64, size=int(tr["check_models"]), replace=False).tolist())
    state.grids.clear()
    return state


def step(state: State) -> None:
    from photon_ml_tpu_torch.ops.kernels import grid_bilinear_pass
    from photon_ml_tpu_torch.optim import common
    from photon_ml_tpu_torch.task import TaskType

    d = int(state.cell.config["features"])
    f0, k0 = common.host_fetches, grid_bilinear_pass.launches
    with torch.profiler.record_function("bench.grid"):
        models, results = state.trainer(state.tb, TaskType.LOGISTIC_REGRESSION, d, **state.kw)
        harness._sync(state.device)
    state.fetches.append(common.host_fetches - f0)
    state.passes.append(grid_bilinear_pass.launches - k0)
    state.iterations.append([int(results[lam].iterations) for lam in sorted(results)])
    # what the check reads of each λ: the start (zero, or on the
    # warm-started path the model of the λ before), the model, the value
    # the program reported and its tracker's value at the start and after
    # each iteration
    grid, start = {}, torch.zeros_like(models[max(models)].means)
    for lam in sorted(models, reverse=True):
        t = results[lam].tracker
        grid[lam] = {"start": start, "w": models[lam].means, "reported": results[lam].value,
                     "values": t.values[: int(results[lam].iterations) + 1], "first_grad_norm": t.grad_norms[0]}
        if state.cell.traffic["mode"] == "sequential":
            start = models[lam].means
    index = len(state.iterations) - 1
    if index in state.judged:
        state.grids[index] = grid
    state.last = grid


def window_closed(state: State, record) -> None:
    """The grid's per-layer readings and its required work (module note of
    ``peaks.py``): a value-and-gradient evaluation a member and iteration,
    plus the first; the batched path reads the data once a bank trip for
    every member still running, the sequential path once a member."""
    s = record.shapes
    record.layer["host_fetches"] = float(np.mean(state.fetches))
    if any(state.passes):  # K2 is counted where it launches: on the card
        record.layer["k2_passes"] = float(np.mean(state.passes))
    total = 0.0
    for its in state.iterations:
        if state.cell.traffic["mode"] == "batched":
            for t in range(max(its) + 1):
                active = sum(1 for i in its if i >= t)
                total += peaks.evaluation_least_s(s["nnz"], s["rows"], s["features"], active)
        else:
            total += sum(i + 1 for i in its) * peaks.evaluation_least_s(
                s["nnz"], s["rows"], s["features"])
    record.required_s = total
    record.layer["iterations"] = state.iterations
    record.layer["passes"] = state.passes


def summary(record) -> str:
    """Each grid's iterations by λ (ascending) and K2 launches, for the
    run's log line."""
    return (f"iterations by lambda {record.layer.get('iterations')}; "
            f"K2 launches a grid {record.layer.get('passes')}")


def outputs(state: State) -> dict:
    """The judged grids (those drawn from the seed that the window reached,
    and the last); the tiled batch is dropped."""
    out = {"grids": list(state.grids.values()) + [state.last], "data": state.data}
    state.tb, state.grids, state.last = None, {}, None
    return out


def judge(cell, seed, device, outputs) -> dict:
    ref = harness.module("reference", cell.config["reference"])
    rows = ref.Rows(outputs["data"], cell.config["features"], device)
    return ref.judge(rows, outputs["grids"], int(cell.traffic["history"]))
