"""GAME fits by coordinate descent through the port's ``CoordinateDescent``:
a global fixed effect and a per-user random effect.

Traffic keys: ``sweeps``; ``global`` (``max_iter``, ``tolerance``,
``history``, ``reg_weight``, ``kernel``) and ``per_user`` (``optimizer``, ``max_iter``, ``tolerance``,
``history``, ``reg_weight``) for the two coordinates; ``check_fits`` (how
many fit indices under 64 the check judges, drawn from the seed, where
the window reaches them; the last fit is always judged).

Set-up makes the rows (the configuration's generator), builds the
program's dataset and the random effect's buckets
(``build_random_effect_dataset``, as the program makes them), builds the
fixed effect's tiled schedules (``ensure_tiled``, timed as
``schedule_build_s``; the coordinate's fits then find them in the
program's in-memory tier) and fits once to warm up. A unit is one
``CoordinateDescent.run(sweeps)`` from a cold model, ended by a
synchronisation. In a traced run each coordinate's updates are timed
between two synchronisations (``fe_update_s``, ``re_update_s``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

import harness
import peaks


class Watched:
    """A coordinate whose ``update_model`` calls are logged: each call's
    residual (the other coordinate's scores it was fitted against) and
    what it returned, for the check; with ``seconds`` (a traced run) each
    call is also timed on the host clock between two synchronisations,
    summed into ``seconds[key]`` (the idea of ``chip_smoke.py:1659``
    ``TimedCoordinate``, kept here so the yardstick does not move with the
    script)."""

    def __init__(self, coord, key: str, device, seconds=None):
        self.coord, self.key, self.device, self.seconds = coord, key, device, seconds
        self.log: list = []

    def __getattr__(self, name):
        return getattr(self.coord, name)

    def update_model(self, model, residual=None):
        if self.seconds is None:
            out = self.coord.update_model(model, residual)
        else:
            harness._sync(self.device)
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"bench.{self.key}"):
                out = self.coord.update_model(model, residual)
                harness._sync(self.device)
            self.seconds[self.key] = self.seconds.get(self.key, 0.0) + time.perf_counter() - t0
        self.log.append((residual, out))
        return out


@dataclass
class State:
    cell: object
    seed: int
    device: object
    cd: object
    re_coord: object
    fe_watch: Watched
    data: dict
    seconds: dict = field(default_factory=dict)
    kept: dict = field(default_factory=dict)
    iterations: List[tuple] = field(default_factory=list)
    last: object = None


def setup(cell, seed, device, record, traced):
    from photon_ml_tpu_torch.game import (
        CoordinateDescent,
        EntityIndex,
        FixedEffectCoordinate,
        GameDataset,
        RandomEffectCoordinate,
        RandomEffectDataConfiguration,
        RandomEffectOptimizationProblem,
        ShardData,
        build_random_effect_dataset,
    )
    from photon_ml_tpu_torch.ops import tiled_sparse
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig,
        OptimizerType,
        RegularizationContext,
        RegularizationType,
    )
    from photon_ml_tpu_torch.optim.problem import create_glm_problem
    from photon_ml_tpu_torch.task import TaskType
    from photon_ml_tpu_torch.utils.index_map import IdentityIndexMap

    cfg, tr = cell.config, cell.traffic
    data = harness.module("generators", cfg["generator"]).generate(cfg, seed, device)
    d, n = int(cfg["features"]), len(data["labels"])
    users_n = int(cfg["users"])
    imap = IdentityIndexMap(d - 1, add_intercept=True)
    ds = GameDataset(
        uids=[""] * n, labels=data["labels"], offsets=np.zeros(n, np.float32),
        weights=np.ones(n, np.float32),
        shards={"global": ShardData(data["g_idx"], data["g_val"], imap, d - 1),
                "user": ShardData(data["u_idx"], data["u_val"], imap, d - 1)},
        entity_codes={"userId": data["users"]},
        entity_indexes={"userId": EntityIndex.build("userId", [f"{u:06d}" for u in range(users_n)])},
        num_real_rows=n, device=torch.device(device),
    )
    red = build_random_effect_dataset(ds, RandomEffectDataConfiguration("userId", "user"), seed=seed)
    t0 = time.perf_counter()
    tiled_sparse.ensure_tiled(ds.batch_for_shard("global"), d, device=device)
    harness._sync(device)
    record.layer["schedule_build_s"] = time.perf_counter() - t0
    record.shapes.update(
        nnz=int(np.count_nonzero(data["g_val"])), rows=n, features=d,
        user_nnz=int(np.count_nonzero(data["u_val"])), users=users_n,
    )

    l2 = RegularizationContext(RegularizationType.L2)
    fe_tr, re_tr = tr["global"], tr["per_user"]
    fe = FixedEffectCoordinate(
        name="global", dataset=ds,
        problem=create_glm_problem(
            TaskType.LOGISTIC_REGRESSION, d,
            config=OptimizerConfig(max_iter=int(fe_tr["max_iter"]), tolerance=float(fe_tr["tolerance"]),
                                   lbfgs_history=int(fe_tr["history"])),
            regularization=l2, intercept_index=d - 1, kernel=fe_tr["kernel"],
        ),
        feature_shard_id="global", reg_weight=float(fe_tr["reg_weight"]),
    )
    re = RandomEffectCoordinate(
        name="per-user", dataset=ds, re_dataset=red,
        problem=RandomEffectOptimizationProblem(
            LOGISTIC,
            OptimizerConfig(OptimizerType[re_tr["optimizer"]], max_iter=int(re_tr["max_iter"]),
                            tolerance=float(re_tr["tolerance"]),
                            lbfgs_history=int(re_tr["history"])),
            l2, reg_weight=float(re_tr["reg_weight"]),
        ),
    )
    seconds: dict = {}
    timed = seconds if traced else None
    fe_w, re_w = Watched(fe, "fe_update", device, timed), Watched(re, "re_update", device, timed)
    cd = CoordinateDescent({"global": fe_w, "per-user": re_w}, ds, TaskType.LOGISTIC_REGRESSION)
    state = State(cell, seed, device, cd, re, fe_w, data, seconds)
    rng = np.random.default_rng([int(seed), 8])
    state.kept = {int(i): None for i in rng.choice(64, size=int(tr["check_fits"]), replace=False)}
    step(state)  # warm-up: the allocator, the kernels' launch plans
    state.kept = dict.fromkeys(state.kept)
    state.iterations.clear()
    seconds.clear()
    return state


def step(state: State) -> None:
    state.fe_watch.log = []
    with torch.profiler.record_function("bench.fit"):
        result = state.cd.run(int(state.cell.traffic["sweeps"]))
        harness._sync(state.device)
    result.fe_log = state.fe_watch.log
    i = len(state.iterations)
    fe_its = [int(t.iterations) for t in result.trackers["global"]]
    re_its = [float(t.iterations_mean) * int(t.num_entities) for t in result.trackers["per-user"]]
    state.iterations.append((fe_its, re_its))
    if i in state.kept:
        state.kept[i] = result
    state.last = result


def window_closed(state: State, record) -> None:
    """Per fit: the coordinates' update seconds; the required work (a
    value-and-gradient evaluation of the global model an iteration plus
    the first, one of each user an iteration of its solve plus the first,
    over the data's nonzeros alone, and a score pass of each coordinate a
    sweep; ``peaks.py``)."""
    s = record.shapes
    for key, secs in state.seconds.items():
        record.layer[key] = secs / len(state.iterations)
    fe_eval = peaks.evaluation_least_s(s["nnz"], s["rows"], s["features"])
    re_eval = peaks.evaluation_least_s(s["user_nnz"], s["rows"], 0)
    score = peaks.pass_least_s(s["nnz"], s["features"], s["rows"]) + peaks.pass_least_s(
        s["user_nnz"], 0, s["rows"])
    total = 0.0
    for fe_its, re_its in state.iterations:
        total += sum(i + 1 for i in fe_its) * fe_eval
        total += sum(it / s["users"] + 1 for it in re_its) * re_eval
        total += len(fe_its) * score
    record.required_s = total
    record.layer["iterations"] = [(fe, [round(r / s["users"], 3) for r in re])
                                  for fe, re in state.iterations]


def summary(record) -> str:
    """Each fit's iterations, for the run's log line."""
    return f"global iterations, users' Newton iterations a sweep: {record.layer.get('iterations')}"


def _judged(state: State, result) -> dict:
    re_model = result.model.models["per-user"]
    first = result.trackers["global"][0]  # the first sweep's global fit
    return {
        "values": first.tracker.values[: int(first.iterations) + 1],
        "first_grad_norm": first.tracker.grad_norms[0],
        # each sweep's global fit: the users' scores it was fitted against,
        # its model and the value it reported
        "global_fits": [(res.detach().clone(), out[0].model.means.detach().clone(), float(out[1].value))
                        for res, out in result.fe_log],
        "global": result.model.models["global"].model.means.detach().clone(),
        "user_scores": state.re_coord.score(re_model).detach().clone(),
        "bank_sq": float((re_model.bank.double() ** 2).sum()),
        "reported": float(result.objective_history[-1]),
    }


def outputs(state: State) -> dict:
    """The judged fits (a sample drawn from the seed, and the last) as the
    reference reads them: the global coefficients, the users' scores (the
    program's own scoring of its bank), the bank's squared norm and the
    reported objective; then the program's state is dropped."""
    results = [r for r in state.kept.values() if r is not None] + [state.last]
    out = {"fits": [_judged(state, r) for r in results], "data": state.data}
    state.kept, state.last, state.cd, state.re_coord = {}, None, None, None
    return out


def judge(cell, seed, device, outputs) -> dict:
    ref = harness.module("reference", cell.config["reference"])
    tr = cell.traffic
    rows = ref.Rows(outputs["data"], cell.config["features"], device)
    lam_g, lam_u = float(tr["global"]["reg_weight"]), float(tr["per_user"]["reg_weight"])
    return ref.judge(rows, outputs["fits"], lam_g, lam_u, global_fit(tr))


def global_fit(traffic) -> dict:
    """The global model's optimizer settings, as the reference takes them."""
    g = traffic["global"]
    return {"max_iter": int(g["max_iter"]), "tolerance": float(g["tolerance"]),
            "history": int(g["history"])}
