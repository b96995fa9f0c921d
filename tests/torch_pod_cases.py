"""Rank functions and data of the port's entity-sharded tests
(``tests/test_torch_pod_game.py``, ``test_torch_residual_routing.py``,
``test_torch_unified_mesh.py``). Imports neither JAX nor the reference: a
spawned rank re-imports this module."""

from __future__ import annotations

import numpy as np
import torch

from photon_ml_tpu_torch.game.config import ProjectorType, RandomEffectDataConfiguration
from photon_ml_tpu_torch.game.data import EntityIndex, GameDataset, ShardData
from photon_ml_tpu_torch.game.random_effect import RandomEffectOptimizationProblem
from photon_ml_tpu_torch.game.random_effect_data import build_random_effect_dataset
from photon_ml_tpu_torch.ops.losses import LOGISTIC
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig,
    OptimizerType,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.utils.index_map import IndexMap, feature_key


def synthetic_arrays(seed=0, n=257, E=37, d=12, k=4):
    """The reference's ``_synthetic_re`` arrays (tests/test_pod_game.py):
    weight-0 rows, several capacity classes, an uneven entity histogram."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, E, size=n).astype(np.int32)
    ix = rng.integers(0, d, size=(n, k)).astype(np.int32)
    v = rng.normal(size=(n, k)).astype(np.float32)
    lab = (rng.uniform(size=n) > 0.5).astype(np.float32)
    w = np.ones(n, np.float32)
    w[::17] = 0.0
    off = (rng.normal(size=n) * 0.1).astype(np.float32)
    return dict(codes=codes, ix=ix, v=v, lab=lab, w=w, off=off, E=E, d=d)


def port_re(arrs, device="cpu"):
    """-> (GameDataset, IDENTITY RandomEffectDataset) of the port."""
    n = len(arrs["codes"])
    imap = IndexMap.build((feature_key(f"f{i}", "") for i in range(arrs["d"])),
                          add_intercept=False)
    ds = GameDataset(
        uids=[str(i) for i in range(n)],
        labels=arrs["lab"], offsets=arrs["off"], weights=arrs["w"],
        shards={"s": ShardData(indices=arrs["ix"], values=arrs["v"], index_map=imap,
                               intercept_index=None)},
        entity_codes={"user": arrs["codes"]},
        entity_indexes={"user": EntityIndex.build(
            "user", [f"e{i:03d}" for i in range(arrs["E"])])},
        num_real_rows=n,
        device=torch.device(device),
    )
    red = build_random_effect_dataset(ds, RandomEffectDataConfiguration(
        random_effect_type="user", feature_shard_id="s",
        projector_type=ProjectorType.IDENTITY,
    ))
    return ds, red


def port_problem(optimizer="LBFGS", reg_weight=0.5, max_iter=5, tol=1e-7, mesh=None, **kw):
    return RandomEffectOptimizationProblem(
        LOGISTIC, OptimizerConfig(OptimizerType[optimizer], max_iter=max_iter, tolerance=tol),
        RegularizationContext(RegularizationType.L2), reg_weight=reg_weight, mesh=mesh, **kw,
    )


def residual_for(arrs, seed=3):
    return (np.random.default_rng(seed).normal(size=len(arrs["codes"])) * 0.2).astype(np.float32)


def offsets_for(arrs, residual) -> np.ndarray:
    """Offsets plus residual, rounded to float32 as the reference's update
    rounds them (so a float64 run sees the same values)."""
    return (arrs["off"] + residual).astype(np.float32)


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------


def router_tables(mesh, codes):
    """This rank's PodResidualRouter tables and one route in / out."""
    from photon_ml_tpu_torch.game.residual_routing import PodResidualRouter

    router = PodResidualRouter(mesh, codes)
    vals = torch.as_tensor(np.arange(len(codes), dtype=np.float32) + 1.0)
    slots = router.route_in(vals)
    back = router.route_out(slots)
    return dict(cap=router.cap, slot_row=router.slot_row, slot_of_row=router.slot_of_row,
                slots=slots, back=back)


def shuffle_round_trip(mesh, codes, cap):
    """entity_all_to_all of this rank's row block with its row ids as the
    payload -> (received codes, received ids, received count, dropped)."""
    from photon_ml_tpu_torch.parallel.mesh import ENTITY_AXIS
    from photon_ml_tpu_torch.parallel.shuffle import entity_all_to_all, row_block

    n_dev, me = mesh.size(ENTITY_AXIS), mesh.index(ENTITY_AXIS)
    c = row_block(torch.as_tensor(codes), n_dev, me)
    pad = torch.arange(len(codes)) < len(codes)
    c = torch.where(row_block(pad, n_dev, me), c, -1)
    ids = row_block(torch.arange(len(codes), dtype=torch.int64), n_dev, me)
    out = entity_all_to_all(mesh, c, (ids,), cap=cap, axis=ENTITY_AXIS)
    return (out.entity_codes, out.payload[0], int(out.received), int(out.dropped))


def data_router_route(mesh, arrs, residual):
    """ResidualRouter(mesh, red).route of the offsets plus ``residual`` ->
    this rank's flat buffer and the bucket slabs, plus its static tables."""
    from photon_ml_tpu_torch.game.residual_routing import ResidualRouter

    _, red = port_re(arrs, device=mesh.device)
    router = ResidualRouter(mesh, red)
    flat = router.route(torch.as_tensor((arrs["off"] + residual).astype(np.float32)))
    slabs = [router.bucket_slab(flat, bi, b.capacity) for bi, b in enumerate(red.buckets)]
    return dict(cap=router.cap, dest_dev=router.dest_dev, flat_pos=router.flat_pos,
                flat=flat, slabs=slabs)


def pod_update(mesh, arrs, residual, optimizer="LBFGS", dtype="float32", reg_weight=0.5,
               max_iter=5, repeats=2):
    """PodRandomEffectProblem on this rank: ``repeats`` updates with
    variances from a zero bank, then the score, the reg term and the
    tracker; the banks whole (to_global) plus this rank's bytes."""
    from photon_ml_tpu_torch.game.pod import PodRandomEffectProblem, per_device_bytes
    from photon_ml_tpu_torch.optim import common

    dt = getattr(torch, dtype)
    ds, red = port_re(arrs, device=mesh.device)
    pod = PodRandomEffectProblem(port_problem(optimizer, reg_weight, max_iter), mesh)
    offsets = torch.as_tensor(offsets_for(arrs, residual), device=mesh.device).to(dt)
    out = {"banks": [], "vars": []}
    for _ in range(repeats):
        bank0 = pod.init_bank(red, dtype=dt)
        before = common.host_fetches
        bank, tracker, var = pod.update_bank(bank0, red, offsets, with_variances=True)
        out["fetches"] = common.host_fetches - before
        out["banks"].append(bank.to_global())
        out["vars"].append(var.to_global())
    out["score"] = pod.score(bank, red)
    out["reg"] = float(pod.regularization_term(bank))
    out["tracker"] = (tracker.num_entities, tracker.iterations_mean, tracker.iterations_max,
                      dict(tracker.reason_counts))
    out["bytes"] = per_device_bytes(bank, var)
    out["shard_rows"] = bank.spec.rows_per_shard
    return out


def replicated_update(arrs, residual, optimizer="LBFGS", dtype="float32", reg_weight=0.5,
                      max_iter=5, mesh=None, device="cpu"):
    """The port's replicated update_bank (or its mesh= path on ``mesh``):
    bank, variances, score, reg term and tracker."""
    from photon_ml_tpu_torch.game.random_effect import score_random_effect

    dt = getattr(torch, dtype)
    dev = mesh.device if mesh is not None else torch.device(device)
    ds, red = port_re(arrs, device=dev)
    prob = port_problem(optimizer, reg_weight, max_iter, mesh=mesh)
    offsets = torch.as_tensor(offsets_for(arrs, residual), device=dev).to(dt)
    bank0 = torch.zeros(red.num_entities, red.local_dim, dtype=dt, device=dev)
    bank, tracker, var = prob.update_bank(bank0, red, offsets, with_variances=True)
    return dict(bank=bank, var=var, score=score_random_effect(bank, red),
                reg=float(prob.regularization_term(bank)),
                tracker=(tracker.num_entities, tracker.iterations_mean,
                         tracker.iterations_max, dict(tracker.reason_counts)),
                variances=prob.bank_variances(bank, red, offsets))


def mesh_update(mesh, arrs, residual, **kw):
    """:func:`replicated_update` through ``RandomEffectOptimizationProblem(
    mesh=)`` on this rank."""
    return replicated_update(arrs, residual, mesh=mesh, **kw)


def pod_cd(mesh, arrs, iterations=2, pod=True):
    """A fixed effect plus the user random effect through CoordinateDescent
    (the pod coordinate, or the replicated one) -> objective history and
    the final bank, and the host fetches of each iteration."""
    from photon_ml_tpu_torch.game.coordinate import (
        FixedEffectCoordinate,
        PodRandomEffectCoordinate,
        RandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.game.coordinate_descent import CoordinateDescent
    from photon_ml_tpu_torch.optim.problem import create_glm_problem
    from photon_ml_tpu_torch.task import TaskType

    dev = mesh.device if mesh is not None else torch.device("cpu")
    ds, red = port_re(arrs, device=dev)
    fe = FixedEffectCoordinate(
        name="fe", dataset=ds,
        problem=create_glm_problem(
            TaskType.LOGISTIC_REGRESSION, arrs["d"],
            config=OptimizerConfig(max_iter=10, tolerance=1e-7),
            regularization=RegularizationContext(RegularizationType.L2),
        ),
        feature_shard_id="s", reg_weight=1.0,
    )
    if pod:
        re = PodRandomEffectCoordinate(name="re", dataset=ds, re_dataset=red,
                                       problem=port_problem(), mesh=mesh)
    else:
        re = RandomEffectCoordinate(name="re", dataset=ds, re_dataset=red,
                                    problem=port_problem())
    cd = CoordinateDescent({"fe": fe, "re": re}, ds, TaskType.LOGISTIC_REGRESSION)
    result = cd.run(iterations)
    m = result.model.get_model("re")
    return dict(objective=result.objective_history, bank=m.bank,
                fe=result.model.get_model("fe").model.means)


def unified_arrays(seed=0, n=4096, E=512, d=16, k=6):
    """The reference's unified-mesh bench data (``bench.py``
    ``_unified_mesh_config``): unit weights, no padding rows."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, E, size=n).astype(np.int32)
    ix = rng.integers(0, d, size=(n, k)).astype(np.int32)
    v = rng.normal(size=(n, k)).astype(np.float32)
    lab = (rng.uniform(size=n) > 0.5).astype(np.float32)
    w = np.ones(n, np.float32)
    off = (rng.normal(size=n) * 0.1).astype(np.float32)
    return dict(codes=codes, ix=ix, v=v, lab=lab, w=w, off=off, E=E, d=d)


def unified_problems(d, fe_max_iter=5):
    from photon_ml_tpu_torch.optim.problem import create_glm_problem
    from photon_ml_tpu_torch.task import TaskType

    fe = create_glm_problem(TaskType.LOGISTIC_REGRESSION, d,
                            config=OptimizerConfig(max_iter=fe_max_iter))
    return fe, port_problem("LBFGS", reg_weight=1.0, max_iter=5, tol=1e-6)


def unified_grid(mesh, arrs, lambdas, iterations=2, sequential=True, snapshot=False):
    """run_game_grid on the (grid, entity) mesh ``resolve_mesh`` lays over
    the spawned ranks (its shape must be ``mesh``'s); with
    ``sequential``, the per-member pod CD (fixed effect + pod random
    effect on this rank's entity mesh) for every λ too. -> objectives,
    whole FE and RE banks per member, readbacks, bytes."""
    from photon_ml_tpu_torch.game.coordinate import (
        FixedEffectCoordinate,
        PodRandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.game.coordinate_descent import CoordinateDescent
    from photon_ml_tpu_torch.game.unified import run_game_grid
    from photon_ml_tpu_torch.parallel.mesh import ENTITY_AXIS, entity_mesh
    from photon_ml_tpu_torch.parallel.unified_mesh import resolve_mesh
    from photon_ml_tpu_torch.task import TaskType

    ds, red = port_re(arrs, device=mesh.device)
    n_ent = mesh.size(ENTITY_AXIS)
    plan = resolve_mesh(grid_size=len(lambdas), entity_shards=n_ent, device=mesh.device)
    assert (plan.grid_rows, plan.entity_shards) == tuple(mesh.shape)
    fe_problem, re_problem = unified_problems(arrs["d"])
    res = run_game_grid(plan, ds, red, fe_problem, re_problem, lambdas,
                        feature_shard_id="s", fe_reg_weight=0.1, num_iterations=iterations)
    out = dict(
        objective=res.objective_history,
        fe=res.fe_banks[: len(lambdas)],
        re=[res.re_bank.member_global(g) for g in range(len(lambdas))],
        readbacks=res.readbacks,
        bytes=res.re_bank.per_device_bytes(),
        trackers=[[(t.num_entities, t.iterations_max) for t in it] for it in res.re_trackers],
    )
    if snapshot:
        out["snapshot"] = res.re_bank.snapshot()
        out["layout"] = res.re_bank.layout()
    if sequential:
        pod_mesh = entity_mesh(n_ent, device=mesh.device)
        seq = []
        for lam in lambdas:
            coords = {
                "fixed": FixedEffectCoordinate(
                    name="fixed", dataset=ds, problem=fe_problem, feature_shard_id="s",
                    reg_weight=0.1,
                ),
                "per-user": PodRandomEffectCoordinate(
                    name="per-user", dataset=ds, re_dataset=red,
                    problem=port_problem("LBFGS", reg_weight=lam, max_iter=5, tol=1e-6),
                    mesh=pod_mesh,
                ),
            }
            r = CoordinateDescent(coords, ds, TaskType.LOGISTIC_REGRESSION).run(iterations)
            seq.append(dict(objective=r.objective_history,
                            fe=r.model.get_model("fixed").model.means,
                            re=r.model.get_model("per-user").bank))
        out["sequential"] = seq
    return out


def grid_bank_round_trip(mesh, E, d, lambdas, path=None, load=None):
    """GridShardedREBank from member banks made from a seed: member round
    trips, the raw snapshot (optionally written to / restored from a
    GridCheckpointer at ``path``), and ``load`` (a snapshot array written
    elsewhere) restored onto this mesh."""
    from photon_ml_tpu_torch.game.pod import EntityShardSpec
    from photon_ml_tpu_torch.game.unified import GridShardedREBank
    from photon_ml_tpu_torch.parallel.mesh import ENTITY_AXIS

    rng = np.random.default_rng(7)
    banks = [rng.normal(size=(E, d)).astype(np.float32) for _ in lambdas]
    spec = EntityShardSpec(mesh.size(ENTITY_AXIS), E)
    gb = GridShardedREBank.from_member_globals(mesh, spec, len(lambdas), banks)
    out = dict(members=[gb.member_global(g) for g in range(len(lambdas))], banks=banks,
               snapshot=gb.snapshot(), layout=gb.layout())
    restored = GridShardedREBank.restore(mesh, spec, len(lambdas), out["snapshot"])
    out["restored_equal"] = bool(torch.equal(restored.data, gb.data))
    if path is not None and mesh.rank == 0:
        from photon_ml_tpu_torch.reliability.checkpoint import GridCheckpointer

        ck = GridCheckpointer(path, {"test": "grid-bank"})
        ck.save_grid_bank("per-user", out["snapshot"], gb.layout())
    if load is not None:
        back = GridShardedREBank.restore(mesh, spec, len(lambdas), load)
        out["loaded_members"] = [back.member_global(g) for g in range(len(lambdas))]
    return out


def routing_suite(mesh, codes, caps, arrs, residual):
    """Every routing case on this rank of an entity mesh: the pod router's
    tables and hops, the shuffle at each of ``caps``, the data router's
    tables and routed slabs, and the RE ``mesh=`` update."""
    return dict(
        pod=router_tables(mesh, codes),
        shuffle=[shuffle_round_trip(mesh, codes, cap) for cap in caps],
        data=data_router_route(mesh, arrs, residual),
        mesh_update=mesh_update(mesh, arrs, residual),
        mesh_update_tron=mesh_update(mesh, arrs, residual, optimizer="TRON"),
    )


def pod_suite(mesh, arrs, residual):
    """Every pod case on this rank of an entity mesh: float32 L-BFGS
    updates twice, a TRON update, a float64 update, and the CD loop."""
    return dict(
        f32=pod_update(mesh, arrs, residual),
        tron=pod_update(mesh, arrs, residual, optimizer="TRON", repeats=1),
        f64=pod_update(mesh, arrs, residual, dtype="float64", max_iter=40, repeats=1),
        cd=pod_cd(mesh, arrs),
    )


STREAM_FE_SPEC, STREAM_RE_SPEC = "50,1e-6,0.5,1,TRON,L2", "50,1e-6,1.0,1,LBFGS,L2"


def streamed_game(mesh, train_dir, spill_root, iterations=2):
    """``train_streaming_game(entity_mesh=)`` on this rank (its own spill
    directory) over the Avro files in ``train_dir``; ``mesh`` None runs
    the replicated streamed path. -> objective history, the whole RE bank
    and the FE means of the exported model."""
    import os

    from photon_ml_tpu_torch.game import streaming as gs
    from photon_ml_tpu_torch.game.config import (
        FeatureShardConfiguration,
        FixedEffectDataConfiguration,
    )
    from photon_ml_tpu_torch.optim.config import GLMOptimizationConfiguration
    from photon_ml_tpu_torch.task import TaskType

    shards = [FeatureShardConfiguration("globalShard", ["features"]),
              FeatureShardConfiguration("userShard", ["userFeatures"])]
    fe = {"global": FixedEffectDataConfiguration("globalShard")}
    re = {"per-user": RandomEffectDataConfiguration(
        "userId", "userShard", projector_type=ProjectorType.IDENTITY)}
    combo = {"global": GLMOptimizationConfiguration.parse(STREAM_FE_SPEC),
             "per-user": GLMOptimizationConfiguration.parse(STREAM_RE_SPEC)}
    rank = 0 if mesh is None else mesh.rank
    spill = os.path.join(spill_root, f"rank{rank}")
    os.makedirs(spill, exist_ok=True)
    result, _ = gs.train_streaming_game(
        [train_dir], shards, fe, re, combo, TaskType.LOGISTIC_REGRESSION,
        num_iterations=iterations, spill_dir=spill, entity_mesh=mesh,
        device="cpu" if mesh is None else None,
    )
    gm = result.game_model
    return dict(objective=result.objective_history,
                bank=gm.get_model("per-user").bank,
                fe=gm.get_model("global").model.means)
