"""GAME training driver and CLI (port of
``photon_ml_tpu/cli/game_training_driver.py``, the single-process,
in-memory path on one device).

    python -m photon_ml_tpu_torch.cli.game_training_driver \\
        --train-input-dirs DIR --output-dir OUT \\
        --feature-shard-id-to-feature-section-keys-map ... [options]

Reference: photon-ml .../cli/game/training/Driver.scala:642-757 (run:
prepareFeatureMaps -> prepareGameDataSet -> prepareTrainingDataSet ->
evaluators -> train over the config grid -> save models) and
Params.scala:199-426 (option names kept verbatim: ``train-input-dirs``,
``feature-shard-id-to-feature-section-keys-map``,
``fixed-effect-data-configurations``, per-coordinate config maps in the
``coord1:cfg|coord2:cfg`` string DSL with grid expansion).

The parser accepts every option of the JAX package's driver, and every
path behind them is ported. ``--entity-shards N`` shards each plain
random effect's bank over an entity mesh of N processes by entity hash
(``game/pod.py``; ``-1`` every process, one process and N = 1 the
single-shard pod path); without it, over several processes the random
effects split each bucket's entities over a data mesh of the ranks. The
one option the port adds is
``--device``: the card by default (the driver raises without CUDA), ``cpu``
on request. As in the reference, the fixed effect solves on the scatter
objective. ``--streaming true`` trains out of core
(``game/streaming.py``): scan, stage to spilled chunks sized by
``--stream-memory-budget``, streamed coordinate descent with streamed
validation, under the reference's gates (IDENTITY projectors, no
active-data cap, no factored coordinates, one process).
``--retrain-from R`` warm-starts the fixed-effect vectors and the
random-effect banks from the latest committed generation of the model
registry ``R`` (``registry/warm_start.py``: by feature key, new entities
at the prior mean); ``--publish-registry R`` publishes ``best-model`` as
the next generation, gated against the parent on the validation data by
the ``--gate-*`` thresholds.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import os
from dataclasses import dataclass, field
from itertools import product
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.cli.glm_driver import prepare_output_dir
from photon_ml_tpu_torch.parallel import multihost
from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, entity_mesh, make_mesh
from photon_ml_tpu_torch.evaluation.evaluator import Evaluator, EvaluatorType
from photon_ml_tpu_torch.game.config import (
    FactoredRandomEffectConfiguration,
    FeatureShardConfiguration,
    FixedEffectDataConfiguration,
    ProjectorType,
    RandomEffectDataConfiguration,
)
from photon_ml_tpu_torch.game.coordinate import (
    FactoredRandomEffectCoordinate,
    FactoredRandomEffectModel,
    FixedEffectCoordinate,
    PodRandomEffectCoordinate,
    RandomEffectCoordinate,
    _latent_scores,
)
from photon_ml_tpu_torch.game.coordinate_descent import (
    CoordinateDescent,
    CoordinateDescentResult,
)
from photon_ml_tpu_torch.game.data import GameDataset, ShardData, build_game_dataset_from_files
from photon_ml_tpu_torch.game.model import FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_tpu_torch.game.model_io import save_game_model
from photon_ml_tpu_torch.game.random_effect import (
    RandomEffectOptimizationProblem,
    score_random_effect,
)
from photon_ml_tpu_torch.game.random_effect_data import build_random_effect_dataset
from photon_ml_tpu_torch.game.streaming import (
    train_streaming_game,
    validate_streaming_game_configs,
)
from photon_ml_tpu_torch.utils.profiling import peak_rss_bytes, profile_trace
from photon_ml_tpu_torch.ops import schedule_cache
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.optim import common
from photon_ml_tpu_torch.optim.config import GLMOptimizationConfiguration
from photon_ml_tpu_torch.optim.problem import create_glm_problem
from photon_ml_tpu_torch.parallel import overlap
from photon_ml_tpu_torch.reliability import (
    ensure_run_manifest,
    install_plan,
    reliability_metrics,
)
from photon_ml_tpu_torch.reliability.artifacts import atomic_write_json
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.training import resolve_entity_shards, resolve_grid_mode
from photon_ml_tpu_torch.utils.checkpoint import TrainingCheckpointer
from photon_ml_tpu_torch.utils.date_range import expand_dated_paths, resolve_date_range
from photon_ml_tpu_torch.utils.device import resolve_device
from photon_ml_tpu_torch.utils.logging_util import PhotonLogger, Timer
from photon_ml_tpu_torch.utils.preemption import PreemptionGuard


def parse_keyed_map(s: str) -> Dict[str, str]:
    """``key1:value1|key2:value2`` -> dict (the per-coordinate DSL)."""
    out: Dict[str, str] = {}
    for part in s.split("|"):
        part = part.strip()
        if not part:
            continue
        key, _, value = part.partition(":")
        out[key.strip()] = value.strip()
    return out


def parse_shard_map(s: str) -> List[FeatureShardConfiguration]:
    """``shard1:bag1,bag2|shard2:bag3`` -> shard configs."""
    return [
        FeatureShardConfiguration(k, [b.strip() for b in v.split(",") if b.strip()])
        for k, v in parse_keyed_map(s).items()
    ]


def apply_intercept_map(
    shards: List[FeatureShardConfiguration], intercept_map: Optional[str]
) -> List[FeatureShardConfiguration]:
    """``shardId1:true|shardId2:false`` -> per-shard add_intercept
    (featureShardIdToInterceptMap, Params.scala:289-300; default true, a
    bare ``shardId`` also means true)."""
    if not intercept_map:
        return shards
    flags = {}
    for k, v in parse_keyed_map(intercept_map).items():
        s = v.strip().lower()
        if s in ("", "true", "1", "yes"):
            flags[k] = True
        elif s in ("false", "0", "no"):
            flags[k] = False
        else:
            raise ValueError(
                f"intercept map value for {k!r} must be true/false, got {v!r}"
            )
    unknown = set(flags) - {s.shard_id for s in shards}
    if unknown:
        raise ValueError(f"intercept map references unknown feature shards {sorted(unknown)}")
    return [
        dataclasses.replace(s, add_intercept=flags.get(s.shard_id, s.add_intercept))
        for s in shards
    ]


def expand_config_grid(
    opt_configs: Dict[str, str]
) -> List[Dict[str, GLMOptimizationConfiguration]]:
    """Per-coordinate strings carry ';'-separated alternatives; the
    cross-product of the per-coordinate lists is one training run each
    (cli/game/training/Driver.scala:329-347)."""
    names = list(opt_configs)
    alternatives = [
        [GLMOptimizationConfiguration.parse(alt) for alt in opt_configs[n].split(";") if alt.strip()]
        for n in names
    ]
    return [dict(zip(names, combo)) for combo in product(*alternatives)]


@dataclass
class GameTrainingParams:
    """Every field of the JAX package's driver, so that every option
    parses (:meth:`validate` holds them to the reference's rules)."""

    train_input_dirs: List[str] = field(default_factory=list)
    validate_input_dirs: Optional[List[str]] = None
    output_dir: str = ""
    # dated inputs (Params.scala:44-82): <dir>/daily/yyyy/MM/dd
    train_date_range: Optional[str] = None
    train_date_range_days_ago: Optional[str] = None
    validate_date_range: Optional[str] = None
    validate_date_range_days_ago: Optional[str] = None
    task_type: TaskType = TaskType.LOGISTIC_REGRESSION
    feature_shards: List[FeatureShardConfiguration] = field(default_factory=list)
    fixed_effect_data_configs: Dict[str, FixedEffectDataConfiguration] = field(default_factory=dict)
    fixed_effect_opt_configs: Dict[str, str] = field(default_factory=dict)
    random_effect_data_configs: Dict[str, RandomEffectDataConfiguration] = field(default_factory=dict)
    random_effect_opt_configs: Dict[str, str] = field(default_factory=dict)
    factored_re_configs: Dict[str, FactoredRandomEffectConfiguration] = field(default_factory=dict)
    updating_sequence: Optional[List[str]] = None
    num_iterations: int = 1
    evaluator_types: List[EvaluatorType] = field(default_factory=list)
    compute_variance: bool = False
    # ALL: best-model plus every combo's final model under all/<index>;
    # BEST: best-model only; NONE: no model output
    model_output_mode: str = "ALL"
    num_output_files_for_random_effect_model: int = 1
    application_name: str = "photon-ml-tpu-game-training"
    offheap_indexmap_dir: Optional[str] = None
    offheap_indexmap_num_partitions: Optional[int] = None
    feature_name_and_term_set_path: Optional[str] = None
    delete_output_dir_if_exists: bool = False
    # "auto" / "off": one process on one device here; "feature" waits
    distributed: str = "auto"
    model_shards: Optional[int] = None
    entity_shards: Optional[int] = None
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    checkpoint_dir: Optional[str] = None
    profile_dir: Optional[str] = None
    obs_dir: Optional[str] = None
    # persistent tile-schedule cache directory for tiled fixed effects
    tile_cache_dir: Optional[str] = None
    # serial execution: no deferred readbacks or async writes
    no_overlap: bool = False
    streaming: bool = False
    stream_memory_budget: int = 0
    diagnostic_reservoir_rows: int = 100_000
    diagnostic_reservoir_bytes: int = 256 << 20
    # fixed-effect λ-tuning policy for a pure FE λ sweep (see _fe_grid_lambdas)
    grid_mode: str = "auto"
    grid_memory_budget: int = 1 << 30
    fault_plan: Optional[str] = None
    # Continuous retraining (registry/): --retrain-from warm-starts the
    # FE coefficient vectors AND the per-entity RE banks from the latest
    # committed generation with drift-safe alignment (new vocab terms
    # zero-init, removed terms dropped with accounting, churned entities
    # prior-mean-initialized; bitwise pass-through when nothing
    # drifted); --publish-registry publishes best-model as the next
    # generation, gated against the parent on the validation data.
    retrain_from: Optional[str] = None
    publish_registry: Optional[str] = None
    gate_max_auc_drop: float = 0.005
    gate_max_rmse_increase: float = 0.01
    gate_max_coef_norm_ratio: float = 10.0
    gate_max_prediction_drift: Optional[float] = None
    # where training runs: None = the CUDA card (raises without one), "cpu"
    device: Optional[str] = None

    def unported(self) -> List[str]:
        """The options set here whose paths the port lacks, each with the
        ROADMAP item it waits for: none is left."""
        return []

    def validate(self) -> None:
        unported = self.unported()
        if unported:
            raise NotImplementedError(
                "not ported to photon_ml_tpu_torch yet: " + "; ".join(unported)
            )
        if not self.train_input_dirs:
            raise ValueError("train-input-dirs is required")
        if not self.output_dir:
            raise ValueError("output-dir is required")
        if self.distributed not in ("auto", "off", "feature"):
            raise ValueError(f"unknown distributed mode {self.distributed!r}")
        if self.model_output_mode not in ("ALL", "BEST", "NONE"):
            raise ValueError(f"unknown model output mode {self.model_output_mode!r}")
        resolve_date_range(self.train_date_range, self.train_date_range_days_ago)
        resolve_date_range(self.validate_date_range, self.validate_date_range_days_ago)
        coords = set(self.fixed_effect_data_configs) | set(self.random_effect_data_configs)
        if not coords:
            raise ValueError("at least one coordinate configuration required")
        for name in self.fixed_effect_data_configs:
            if name not in self.fixed_effect_opt_configs:
                raise ValueError(f"missing optimization config for {name}")
        for name in self.random_effect_data_configs:
            if name not in self.random_effect_opt_configs:
                raise ValueError(f"missing optimization config for {name}")
        unknown = set(self.factored_re_configs) - set(self.random_effect_data_configs)
        if unknown:
            raise ValueError(
                f"factored configurations name no random-effect coordinate: {sorted(unknown)}"
            )
        if self.diagnostic_reservoir_rows < 1:
            raise ValueError("diagnostic-reservoir-rows must be >= 1")
        if self.diagnostic_reservoir_bytes < 1:
            raise ValueError("diagnostic-reservoir-bytes must be >= 1")
        if self.grid_mode not in ("batched", "sequential", "auto"):
            raise ValueError(
                f"unknown grid mode {self.grid_mode!r}; expected batched | sequential | auto"
            )
        if self.entity_shards is not None and self.entity_shards not in (0, -1) \
                and self.entity_shards < 1:
            raise ValueError(
                f"entity-shards must be -1, 0 or >= 1, got {self.entity_shards}"
            )
        if self.entity_shards not in (None, 0):
            if self.factored_re_configs:
                raise ValueError(
                    "--entity-shards supports plain random-effect "
                    "coordinates only (factored REs re-project rows "
                    "through a replicated latent view)"
                )
            if self.compute_variance and self.streaming:
                raise ValueError(
                    "--entity-shards with --streaming does not support "
                    "--compute-variance yet"
                )
        if self.grid_memory_budget < 1:
            raise ValueError("grid-memory-budget must be >= 1")
        if self.stream_memory_budget and not self.streaming:
            raise ValueError("stream-memory-budget requires --streaming true")
        if self.streaming:
            # the streaming layer's structural gates
            unsupported = []
            if self.factored_re_configs:
                unsupported.append(
                    "factored random effects (latent re-projection re-materializes "
                    "every row per inner iteration)"
                )
            if self.distributed == "feature":
                unsupported.append(
                    "a feature-sharded fixed effect (use the GLM driver's "
                    "--streaming --distributed feature for that composition)"
                )
            if self.coordinator_address is not None:
                unsupported.append("multi-process training")
            for et in self.evaluator_types:
                if et.is_sharded:
                    unsupported.append(f"the sharded evaluator {et.render()}")
            if unsupported:
                raise ValueError(
                    "streaming GAME training does not support: " + ", ".join(unsupported)
                )
            validate_streaming_game_configs(self.random_effect_data_configs)
        if self.retrain_from:
            unsupported = []
            if self.streaming:
                unsupported.append(
                    "--streaming (the out-of-core CD builds its banks from disk "
                    "segments; warm-starting them is not wired yet)"
                )
            if self.entity_shards not in (None, 0):
                unsupported.append(
                    "--entity-shards (the pod coordinates own their sharded bank layout)"
                )
            if unsupported:
                raise ValueError("--retrain-from does not support: " + ", ".join(unsupported))
        if self.retrain_from and self.publish_registry and not self.validate_input_dirs:
            raise ValueError(
                "validation-gated promotion (--retrain-from + "
                "--publish-registry) requires validate-input-dirs: the "
                "gates compare candidate vs parent on held-out data"
            )
        if self.publish_registry and self.model_output_mode == "NONE":
            raise ValueError(
                "--publish-registry publishes the saved best-model; "
                "model-output-mode NONE writes none"
            )
        if self.gate_max_coef_norm_ratio <= 0:
            raise ValueError("gate-max-coef-norm-ratio must be > 0")


class GameTrainingDriver:
    """After run(): ``results`` lists (combo, CoordinateDescentResult,
    grid index); ``best_result`` is (result, metric) and ``best_config``
    its combo."""

    def __init__(self, params: GameTrainingParams, logger=None):
        params.validate()
        self.params = params
        self.device = resolve_device(params.device)
        # one process a rank: process 0 writes, every rank trains
        multihost.initialize_multihost(
            params.coordinator_address, params.num_processes, params.process_id,
            device=params.device,
        )
        if params.no_overlap:
            overlap.set_overlap(False)
        if params.fault_plan:
            install_plan(params.fault_plan)
        if multihost.process_count() > 1:
            multihost.prepare_output_dir(
                params.output_dir, delete_if_exists=params.delete_output_dir_if_exists
            )
        else:
            prepare_output_dir(
                params.output_dir, delete_if_exists=params.delete_output_dir_if_exists
            )
        self.logger = logger or PhotonLogger(
            params.output_dir if multihost.is_coordinator() else None
        )
        self._process_meshes = None
        from photon_ml_tpu_torch.obs import ObsSession

        self.obs = ObsSession(params.obs_dir, signal_dump=False)
        self.timer = Timer()
        self.results = []
        self.best_result = None
        self.best_config = None
        self._evaluators: List[EvaluatorType] = []
        # continuous retraining state (--retrain-from / --publish-registry)
        self._parent_generation = None   # registry.GenerationInfo
        self._parent_loaded = None       # game.model_io.LoadedGameModel
        self._drift_reports = {}
        self._published_generation = None
        self._gate_report = None

    # -- data ------------------------------------------------------------------

    def _expand_dated(self, dirs, date_range, days_ago):
        return expand_dated_paths(dirs, date_range, days_ago, self.logger)

    def _load_dataset(self, dirs: Sequence[str], index_maps=None) -> GameDataset:
        re_types = [c.random_effect_type for c in self.params.random_effect_data_configs.values()]
        # sharded evaluators need their id columns too
        for et in self.params.evaluator_types:
            if et.id_type and et.id_type not in re_types:
                re_types.append(et.id_type)
        return build_game_dataset_from_files(
            list(dirs), self.params.feature_shards, re_types,
            index_maps=index_maps, is_response_required=True, device=self.device,
        )

    def _offheap_index_maps(self):
        """{shard_id: index map} as the reference's prepareFeatureMaps
        dispatch resolves it (cli/game/GAMEDriver.scala:89-97): off-heap
        stores, else name-and-term lists, else None (built from the data)."""
        p = self.params
        if p.offheap_indexmap_dir:
            from photon_ml_tpu_torch.utils.native_index import load_offheap_index_maps

            maps = load_offheap_index_maps(
                p.offheap_indexmap_dir, [cfg.shard_id for cfg in p.feature_shards],
                num_partitions=p.offheap_indexmap_num_partitions,
            )
            for sid, m in maps.items():
                self.logger.info("offheap index map %s: %d features", sid, m.size)
            return maps
        if p.feature_name_and_term_set_path:
            from photon_ml_tpu_torch.io.name_term_list import index_maps_from_name_term_lists

            maps = index_maps_from_name_term_lists(p.feature_name_and_term_set_path, p.feature_shards)
            for sid, m in maps.items():
                self.logger.info("name-term list index map %s: %d features", sid, m.size)
            return maps
        return None

    # -- coordinates -----------------------------------------------------------

    def _meshes(self) -> dict:
        """The meshes over the processes, made once and in one order on
        every rank: ``fe`` for the fixed effect, ``data`` for the
        replicated random effects' mesh path, ``entity`` for the pod
        coordinates (``--entity-shards``). Without entity shards, "feature"
        gives the fixed effect a (data, model) mesh with ``--model-shards``
        (default 2) on the model axis, "auto" a data mesh, and the random
        effects a data mesh; None with one process or "off", as the
        reference's ``maybe_make_mesh`` gives none for one device. A
        PARTIAL entity mesh (N below the process count) restricts the
        fixed effect's mesh to the pod's N ranks: each block of N ranks
        runs the same program, and N = 1 means no fixed-effect mesh."""
        if self._process_meshes is not None:
            return self._process_meshes
        p = self.params
        n = multihost.process_count()
        backend = multihost.backend_for(n, p.device)
        n_ent = resolve_entity_shards(p.entity_shards)
        pod = None
        if n_ent is not None:
            pod = entity_mesh(n_ent, device=self.device, backend=backend)
        ranks = n if n_ent is None else n_ent
        fe = data = None
        if p.distributed != "off" and ranks >= 2:
            if p.distributed == "feature":
                m = p.model_shards if p.model_shards is not None else 2
                if ranks % m != 0:
                    if n_ent is not None and ranks < n:
                        raise ValueError(
                            f"model_shards={m} does not divide the {ranks}-device "
                            "entity mesh (--entity-shards restricts the fixed "
                            "effect's (data, model) mesh to the pod device set)"
                        )
                    raise ValueError(f"model_shards={m} does not divide the {n} processes")
                fe = make_mesh((ranks // m, m), (DATA_AXIS, MODEL_AXIS), device=self.device,
                               backend=backend, replicas=True)
            if pod is None:
                data = make_mesh((ranks,), (DATA_AXIS,), device=self.device,
                                 backend=backend, replicas=True)
            if fe is None:
                fe = data if data is not None else make_mesh(
                    (ranks,), (DATA_AXIS,), device=self.device, backend=backend, replicas=True
                )
        self._process_meshes = {"fe": fe, "data": data, "entity": pod}
        return self._process_meshes

    def _entity_mesh(self):
        """The pod-scale entity mesh (``--entity-shards``), or None for the
        replicated random-effect banks."""
        return self._meshes()["entity"]

    def _build_coordinates(self, dataset: GameDataset, re_datasets, opt_combo):
        p = self.params
        meshes = self._meshes()
        fe_mesh, pod_mesh = meshes["fe"], meshes["entity"]
        coords = {}
        for name, dcfg in p.fixed_effect_data_configs.items():
            ocfg = opt_combo[name]
            shard = dataset.shards[dcfg.feature_shard_id]
            coords[name] = FixedEffectCoordinate(
                name=name,
                dataset=dataset,
                problem=create_glm_problem(
                    p.task_type, shard.dim,
                    config=ocfg.optimizer_config,
                    regularization=ocfg.regularization,
                    compute_variances=p.compute_variance,
                    intercept_index=shard.intercept_index,
                ),
                feature_shard_id=dcfg.feature_shard_id,
                reg_weight=ocfg.reg_weight,
                down_sampling_rate=ocfg.down_sampling_rate,
                mesh=fe_mesh,
            )
        loss = loss_for_task(p.task_type)
        for name in p.random_effect_data_configs:
            ocfg = opt_combo[name]
            red = re_datasets[name]
            problem = RandomEffectOptimizationProblem(
                loss, ocfg.optimizer_config, ocfg.regularization,
                reg_weight=ocfg.reg_weight,
                # the pod layer owns placement on the entity-sharded path
                mesh=None if pod_mesh is not None else meshes["data"],
                # a factored model is saved in the original space, where the
                # latent-space Hdiag does not transform diagonally
                compute_variances=p.compute_variance and name not in p.factored_re_configs,
            )
            if name in p.factored_re_configs:
                fcfg = p.factored_re_configs[name]
                coords[name] = FactoredRandomEffectCoordinate(
                    name=name, dataset=dataset, re_dataset=red, problem=problem,
                    projection_problem=create_glm_problem(
                        p.task_type, red.local_dim * fcfg.latent_space_dimension,
                        config=ocfg.optimizer_config, regularization=ocfg.regularization,
                    ),
                    config=fcfg,
                    reg_weight_projection=ocfg.reg_weight,
                )
            elif pod_mesh is not None:
                coords[name] = PodRandomEffectCoordinate(
                    name=name, dataset=dataset, re_dataset=red, problem=problem, mesh=pod_mesh,
                )
            else:
                coords[name] = RandomEffectCoordinate(
                    name=name, dataset=dataset, re_dataset=red, problem=problem
                )
        return coords

    def _fe_grid_lambdas(self, combos) -> Optional[List[float]]:
        """The combo grid as a pure fixed-effect λ sweep, or None: one FE
        coordinate, no random effects, 1 CD iteration, combos differing
        only in the FE regWeight (then one batched solve serves them all;
        ``--grid-mode auto`` applies the memory budget)."""
        p = self.params
        if p.grid_mode == "sequential":
            return None
        if (
            len(p.fixed_effect_data_configs) != 1
            or p.random_effect_data_configs
            or p.num_iterations != 1
            or p.checkpoint_dir is not None
            # the retrain warm start needs the sequential sweep's
            # initial_model seam
            or p.retrain_from is not None
            or len(combos) <= 1
        ):
            return None
        name = next(iter(p.fixed_effect_data_configs))
        base = combos[0][name]
        for combo in combos:
            cfg = combo[name]
            if (
                cfg.optimizer_config != base.optimizer_config
                or cfg.regularization != base.regularization
                or cfg.down_sampling_rate != base.down_sampling_rate
            ):
                return None
        lambdas = [combo[name].reg_weight for combo in combos]
        if len(set(lambdas)) != len(lambdas):
            return None
        if p.grid_mode == "auto":
            ds = getattr(self, "_train_dataset", None)
            if ds is not None:
                dim = ds.shards[p.fixed_effect_data_configs[name].feature_shard_id].dim
                mode = resolve_grid_mode(
                    "auto", num_weights=len(lambdas), dim=dim,
                    optimizer_type=base.optimizer_config.optimizer_type,
                    history=base.optimizer_config.lbfgs_history,
                    memory_budget_bytes=p.grid_memory_budget,
                )
                if mode != "batched":
                    self.logger.info(
                        "grid-mode auto: FE grid bank over %d features exceeds "
                        "the %d-byte budget; sequential sweep", dim, p.grid_memory_budget,
                    )
                    return None
        return lambdas

    def _consider(self, combo, result: CoordinateDescentResult, ci: int, maximize: bool):
        """Keep the best combo by its validation metric; without a metric,
        the first in the user's grid order."""
        self.results.append((combo, result, ci))
        metric = result.best_metric
        if metric is None:
            if self.best_result is None or (
                self.best_result[1] is None and ci < self._best_index
            ):
                self.best_result, self.best_config, self._best_index = (result, None), combo, ci
        elif (
            self.best_result is None
            or self.best_result[1] is None
            or (maximize and metric > self.best_result[1])
            or (not maximize and metric < self.best_result[1])
        ):
            self.best_result, self.best_config, self._best_index = (result, metric), combo, ci

    def _train_fe_grid_batched(self, combos, dataset, re_datasets, validation_fn, maximize):
        """A pure FE λ sweep in one batched solve; per-combo objectives
        (loss + the combo's reg term) come back in one fetch; validation
        and selection then run per combo as in the sequential sweep."""
        p = self.params
        name = next(iter(p.fixed_effect_data_configs))
        lambdas = [combo[name].reg_weight for combo in combos]
        self.logger.info(
            "training the %d-combo FE lambda grid BATCHED (one bank; no "
            "cross-combo warm starts)", len(combos),
        )
        with self.timer.time("train-fe-grid-batched"):
            coord = self._build_coordinates(dataset, re_datasets, combos[0])[name]
            fitted = coord.update_model_grid(lambdas)
            loss = loss_for_task(p.task_type)
            lab, off, w = dataset.row_tensors()
            values = []
            for lam, (fe_model, _) in zip(lambdas, fitted):
                z = coord.score(fe_model) + off
                value = (w * loss.value(z, lab)).sum()
                l1, l2 = coord.problem.regularization.split(lam)
                m = fe_model.model.means
                value = value + 0.5 * l2 * (m * m).sum()
                if l1:
                    value = value + l1 * m.abs().sum()
                values.append(value)
            (objectives,) = common.fetch(torch.stack(values))
        for ci, combo in enumerate(combos):
            fe_model, res = fitted[ci]
            game_model = GameModel({name: fe_model}, p.task_type)
            history, best_metric = [], None
            if validation_fn is not None:
                metrics = validation_fn(game_model)
                history.append(metrics)
                self.logger.info("combo %d validation: %s", ci, metrics)
                best_metric = metrics[self._evaluators[0].render()]
            self._consider(combo, CoordinateDescentResult(
                model=game_model, objective_history=[objectives[ci]],
                trackers={name: [res]}, validation_history=history,
                best_model=game_model, best_metric=best_metric,
            ), ci, maximize)

    # -- validation --------------------------------------------------------------

    def _validation_fn(self, vdata: GameDataset):
        p = self.params
        loss = loss_for_task(p.task_type)
        evaluators = p.evaluator_types or [
            EvaluatorType.parse("AUC" if p.task_type == TaskType.LOGISTIC_REGRESSION else "RMSE")
        ]
        lab, off, w = vdata.row_tensors()

        def fn(game_model: GameModel) -> Dict[str, float]:
            z = self._score_on(game_model, vdata) + off
            out = {}
            for et in evaluators:
                if et.is_sharded:
                    gids = torch.as_tensor(vdata.entity_codes[et.id_type], device=vdata.device)
                    ev = Evaluator(et, num_groups=vdata.entity_indexes[et.id_type].num_entities)
                    out[et.render()] = float(ev.evaluate(z, lab, w, gids.long().clamp_min(0)))
                else:
                    metric_in = loss.mean(z) if et.name == "RMSE" else z
                    out[et.render()] = float(Evaluator(et).evaluate(metric_in, lab, w))
            return out

        self._evaluators = evaluators
        return fn

    def _score_on(self, game_model: GameModel, vdata: GameDataset) -> torch.Tensor:
        """Score a validation dataset: fixed effects directly, random
        effects through row views over the validation rows."""
        total = torch.zeros(vdata.num_rows, device=vdata.device)
        for sub in game_model.models.values():
            if isinstance(sub, RandomEffectModel):
                total = total + score_random_effect(sub.bank, self._re_view(sub, vdata))
            elif isinstance(sub, FactoredRandomEffectModel):
                total = total + _latent_scores(sub.bank, sub.projection, self._re_view(sub, vdata))
            else:
                total = total + sub.score(vdata)
        return total

    def _re_view(self, sub, vdata: GameDataset):  # photon: entropy(id-keyed validation-view memo; identity-checked, in-memory only)
        """Project validation rows into the model's entity-local spaces,
        matching entities by raw id (unseen entities score 0); cached per
        (model's RE dataset, validation set)."""
        cache = vdata.__dict__.setdefault("_re_views", {})
        key = (id(sub.re_dataset), sub.random_effect_type, sub.feature_shard_id)
        hit = cache.get(key)
        if hit is not None and hit[0] is sub.re_dataset:
            return hit[1]
        base = sub.re_dataset
        train_eindex = self._train_dataset.entity_indexes[sub.random_effect_type]
        v_eindex = vdata.entity_indexes[sub.random_effect_type]
        sd = vdata.shards[sub.feature_shard_id]
        n, k = sd.indices.shape
        # raw-id join: validation code -> training code (-1 when unseen)
        to_train = np.array(
            [train_eindex.code_of.get(raw, -1) for raw in v_eindex.ids] + [-1], np.int32
        )
        v_codes = vdata.entity_codes[sub.random_effect_type]
        codes = np.where(
            (v_codes >= 0) & (vdata.weights > 0), to_train[np.where(v_codes >= 0, v_codes, -1)], -1
        ).astype(np.int32)
        ptype = base.config.projector_type
        if ptype == ProjectorType.IDENTITY:
            row_ix, row_v = sd.indices.copy(), sd.values.copy()
        elif ptype == ProjectorType.RANDOM:
            D = base.local_dim
            row_ix = np.tile(np.arange(D, dtype=np.int32)[None, :], (n, 1))
            row_v = np.zeros((n, D), np.float32)
            for i in np.nonzero(codes >= 0)[0]:
                nz = sd.values[i] != 0
                row_v[i] = base.random_projection[sd.indices[i][nz]].T @ sd.values[i][nz]
        else:
            row_ix = np.zeros((n, k), np.int32)
            row_v = np.zeros((n, k), np.float32)
            dim = max(sd.dim, 1)
            proj = base.projection
            e_idx, l_idx = np.nonzero(proj >= 0)
            # (training code, global feature) -> local slot, as sorted keys
            keys = e_idx.astype(np.int64) * dim + proj[e_idx, l_idx]
            order = np.argsort(keys)
            keys, local = keys[order], l_idx[order]
            rows = np.nonzero(codes >= 0)[0]
            q = codes[rows].astype(np.int64)[:, None] * dim + sd.indices[rows]
            pos = np.clip(np.searchsorted(keys, q), 0, max(len(keys) - 1, 0))
            found = (sd.values[rows] != 0)
            if len(keys):
                found &= keys[pos] == q
            else:
                found &= False
            r_i, s_i = np.nonzero(found)
            row_ix[rows[r_i], s_i] = local[pos[r_i, s_i]]
            row_v[rows[r_i], s_i] = sd.values[rows[r_i], s_i]
        view = dataclasses.replace(
            base, row_local_indices=row_ix, row_local_values=row_v,
            row_entity_codes=codes, buckets=[], device=vdata.device,
        )
        view.__dict__.pop("_device_rows", None)
        cache[key] = (base, view)
        return view

    # -- continuous retraining (registry/) ---------------------------------------

    def _load_parent(self) -> None:
        """Resolve --retrain-from to the latest committed generation's
        loaded GAME artifact (cold start when the registry is empty)."""
        p = self.params
        if not p.retrain_from:
            return
        from photon_ml_tpu_torch.game.model_io import load_game_model
        from photon_ml_tpu_torch.registry import ModelRegistry

        registry = ModelRegistry(p.retrain_from)
        info = registry.latest()
        if info is None:
            self.logger.info(
                "retrain-from registry %s has no committed generation; cold start",
                p.retrain_from,
            )
            return
        self._parent_generation = info
        with self.timer.time("load-parent"):
            self._parent_loaded = load_game_model(info.model_dir)
        self.logger.info(
            "retraining from generation %d (lineage %s, coordinates %s)",
            info.generation, registry.lineage(info.generation),
            self._parent_loaded.coordinate_names(),
        )

    def _warm_start_model(self, dataset, re_datasets):
        """The initial GameModel for the first combo: parent FE vectors
        and RE banks aligned to the NEW dataset (coordinates the parent
        lacks fall back to zero-init inside CoordinateDescent.run)."""
        if self._parent_loaded is None:
            return None
        from photon_ml_tpu_torch.registry import warm_start_game_model

        model, reports = warm_start_game_model(
            self._parent_loaded, dataset, re_datasets, self.params.task_type
        )
        self._drift_reports = reports
        for name, rep in reports.items():
            self.logger.info(
                "warm-start %s: %d kept, %d new, %d dropped, %d entities kept, "
                "%d churned (prior-mean), %d entities dropped%s",
                name, rep.kept, rep.new_zero_init, rep.dropped, rep.kept_entities,
                rep.churned_entities_prior_init, rep.dropped_entities,
                "" if rep.no_drift else " [DRIFT]",
            )
        return model

    def _model_norms(self, best_model):
        """(candidate_norm, parent_norm): FE + RE coefficient L2 norms for
        the coefficient-sanity gate, both sides over their own stored
        coefficients (the candidate's squares in one fetch)."""
        sq_terms = []
        for sub in best_model.models.values():
            if isinstance(sub, FixedEffectModel):
                w = sub.model.means
                sq_terms.append(torch.dot(w, w))
            elif isinstance(sub, RandomEffectModel):
                sq_terms.append((sub.bank * sub.bank).sum())
        cand_sq = (
            sum(float(x) for x in overlap.device_get(sq_terms)) if sq_terms else 0.0
        )
        par_sq = 0.0
        for _name, (_sid, means) in self._parent_loaded.fixed_effects.items():
            par_sq += sum(float(v) ** 2 for v in means.values())
        for _name, (_rt, _sid, per_entity) in self._parent_loaded.random_effects.items():
            for means in per_entity.values():
                par_sq += sum(float(v) ** 2 for v in means.values())
        return float(np.sqrt(cand_sq)), float(np.sqrt(par_sq))

    def _run_gates(self, best_model, vdata):
        """Candidate-vs-parent gates on the loaded validation dataset
        (both models score the SAME rows; the parent resolves features and
        entities by key, so drift costs it exactly its vanished terms)."""
        from photon_ml_tpu_torch.registry import GateConfig, evaluate_gates

        p = self.params
        config = GateConfig(
            max_auc_drop=p.gate_max_auc_drop,
            max_rmse_increase=p.gate_max_rmse_increase,
            max_coef_norm_ratio=p.gate_max_coef_norm_ratio,
            max_prediction_drift=p.gate_max_prediction_drift,
        )
        labels, offsets, weights = vdata.row_tensors()
        cand, par, labels, weights = overlap.device_get((
            self._score_on(best_model, vdata) + offsets,
            self._parent_loaded.score(vdata, p.task_type) + offsets,
            labels,
            weights,
        ))
        cand_norm, par_norm = self._model_norms(best_model)
        report = evaluate_gates(
            [(cand, par, labels, weights)], p.task_type, config=config,
            candidate_norm=cand_norm, parent_norm=par_norm, device=self.device,
        )
        self._gate_report = report
        self.logger.info(
            "validation gates: %s %s", report.verdict,
            {k: v.get("passed") for k, v in report.checks.items()},
        )
        return report

    def _publish_to_registry(self, vdata) -> None:
        """Publish the saved best-model directory as the next generation;
        a failed gate records its named verdict (registry refusal +
        metrics.json) and leaves the lineage unchanged."""
        p = self.params
        best = self.best_result[0] if self.best_result is not None else None
        if best is None:
            return
        gate_report = None
        if self._parent_loaded is not None and vdata is not None:
            gate_report = self._run_gates(best.best_model, vdata)
        from photon_ml_tpu_torch.registry import ModelRegistry, RefusedCandidate

        registry = ModelRegistry(p.publish_registry)
        extra = {"task": p.task_type.name}
        if self._drift_reports:
            extra["drift"] = {name: rep.as_dict() for name, rep in self._drift_reports.items()}
        try:
            info = registry.publish(
                os.path.join(p.output_dir, "best-model"),
                parent=(
                    self._parent_generation.generation
                    if self._parent_generation is not None else None
                ),
                data_ranges={
                    "train_input_dirs": list(p.train_input_dirs),
                    "train_date_range": p.train_date_range,
                    "train_date_range_days_ago": p.train_date_range_days_ago,
                },
                gate_report=gate_report.as_dict() if gate_report is not None else None,
                extra=extra,
            )
            self._published_generation = info.generation
            self.logger.info(
                "published generation %d (parent %s, signature %s)",
                info.generation, info.parent, info.signature,
            )
        except RefusedCandidate as e:
            self.logger.warning(
                "candidate REFUSED by validation gate %s; generation lineage "
                "unchanged (refusal recorded at %s)", e.verdict, e.refused_dir,
            )

    def _registry_metrics(self):
        p = self.params
        if not (p.retrain_from or p.publish_registry):
            return None
        return {
            "retrain_from": p.retrain_from,
            "parent_generation": (
                self._parent_generation.generation
                if self._parent_generation is not None else None
            ),
            "published_generation": self._published_generation,
            "drift": {name: rep.as_dict() for name, rep in self._drift_reports.items()},
            "gates": self._gate_report.as_dict() if self._gate_report is not None else None,
        }

    # -- checkpoints -------------------------------------------------------------

    def _run_manifest(self) -> Dict[str, object]:
        """What a resumed run must share with the run that wrote the
        checkpoints: inputs, shards, data configurations, the update
        sequence and the feature-map source (it defines the coefficient
        index space)."""
        p = self.params
        return {
            "train_input_dirs": list(p.train_input_dirs),
            "train_date_range": p.train_date_range,
            "train_date_range_days_ago": p.train_date_range_days_ago,
            "task_type": p.task_type.name,
            "updating_sequence": list(p.updating_sequence or []),
            "feature_shards": [repr(s) for s in p.feature_shards],
            "fixed_effect_data_configs": {
                k: repr(v) for k, v in sorted(p.fixed_effect_data_configs.items())
            },
            "random_effect_data_configs": {
                k: repr(v) for k, v in sorted(p.random_effect_data_configs.items())
            },
            "offheap_indexmap_dir": p.offheap_indexmap_dir,
            "feature_name_and_term_set_path": p.feature_name_and_term_set_path,
        }

    def _combo_checkpointer(self, combo) -> Optional[TrainingCheckpointer]:
        """A TrainingCheckpointer for one combo under --checkpoint-dir, in
        a directory keyed by the combo's content (a changed grid gets a
        fresh directory, not another combo's weights), whose manifest
        refuses a resume under another run configuration."""
        p = self.params
        if p.checkpoint_dir is None:
            return None
        fp = hashlib.sha1(
            "|".join(f"{name}:{cfg.render()}" for name, cfg in sorted(combo.items())).encode()
        ).hexdigest()[:12]
        combo_dir = os.path.join(p.checkpoint_dir, f"combo-{fp}")
        ensure_run_manifest(combo_dir, self._run_manifest(), kind="game-training")
        return TrainingCheckpointer(combo_dir)

    # -- run ---------------------------------------------------------------------

    def run(self) -> None:
        p = self.params
        self.logger.info("application: %s", p.application_name)
        scope = (
            schedule_cache.cache_scope(p.tile_cache_dir)
            if p.tile_cache_dir is not None else contextlib.nullcontext()
        )
        with scope:
            if p.streaming:
                self._run_streaming()
            else:
                self._run()

    def _run_streaming(self) -> None:
        """The out-of-core run: scan -> stage -> streamed CD per combo,
        with streamed validation, the best model written through the
        standard ``save_game_model`` layout (the scoring driver reads it
        as it is) and metrics.json's streaming block."""
        p = self.params
        train_paths = self._expand_dated(
            p.train_input_dirs, p.train_date_range, p.train_date_range_days_ago
        )
        validate_paths = None
        if p.validate_input_dirs:
            validate_paths = self._expand_dated(
                p.validate_input_dirs, p.validate_date_range, p.validate_date_range_days_ago
            )
        combos = expand_config_grid({**p.fixed_effect_opt_configs, **p.random_effect_opt_configs})
        self.logger.info(
            "streaming GAME training: %d configuration combo(s), %d B memory budget",
            len(combos), p.stream_memory_budget,
        )
        maximize = p.task_type == TaskType.LOGISTIC_REGRESSION
        best = best_extras = best_ci = None
        guard = PreemptionGuard().install() if p.checkpoint_dir is not None else None
        preempted = False
        try:
            for ci, combo in enumerate(combos):
                if guard is not None and guard.requested:
                    self.logger.warning(
                        "preemption requested: not starting combo %d/%d", ci + 1, len(combos)
                    )
                    preempted = True
                    break
                combo_ckpt_dir = None
                if p.checkpoint_dir is not None:
                    # keyed by the combo's content: a changed grid never
                    # resumes foreign staged chunks or CD snapshots
                    fp = hashlib.sha1(
                        "|".join(f"{name}:{cfg.render()}"
                                 for name, cfg in sorted(combo.items())).encode()
                    ).hexdigest()[:12]
                    combo_ckpt_dir = os.path.join(p.checkpoint_dir, f"combo-{fp}")
                with self.timer.time(f"train-combo-{ci}"), profile_trace(
                    p.profile_dir if ci == 0 else None, self.device
                ):
                    result, extras = train_streaming_game(
                        train_paths, p.feature_shards, p.fixed_effect_data_configs,
                        p.random_effect_data_configs, combo, p.task_type,
                        num_iterations=p.num_iterations,
                        update_sequence=p.updating_sequence,
                        memory_budget_bytes=p.stream_memory_budget,
                        index_maps=self._offheap_index_maps(),
                        validate_paths=validate_paths,
                        evaluator_types=p.evaluator_types or None,
                        compute_variance=p.compute_variance,
                        diagnostic_reservoir_rows=p.diagnostic_reservoir_rows,
                        diagnostic_reservoir_bytes=p.diagnostic_reservoir_bytes,
                        logger=self.logger,
                        checkpoint_dir=combo_ckpt_dir,
                        preemption_guard=guard,
                        entity_mesh=self._entity_mesh(),
                        device=self.device,
                    )
                self.results.append((combo, result, ci))
                metric = result.best_metric
                if metric is None:
                    if best is None or (best.best_metric is None and ci < best_ci):
                        best, best_extras, best_ci = result, extras, ci
                        self.best_config = combo
                elif (
                    best is None
                    or best.best_metric is None
                    or (maximize and metric > best.best_metric)
                    or (not maximize and metric < best.best_metric)
                ):
                    best, best_extras, best_ci = result, extras, ci
                    self.best_config = combo
                if result.preempted:
                    self.logger.warning(
                        "stopping streaming combo sweep after preemption (combo %d/%d)",
                        ci + 1, len(combos),
                    )
                    preempted = True
                    break
        finally:
            if guard is not None:
                guard.uninstall()
        if preempted:
            self.logger.warning(
                "preempted: publishing best-so-far; rerun with the same args to resume "
                "the sweep from the checkpoints"
            )
        self.best_result = (best, best.best_metric if best else None)
        if p.model_output_mode != "NONE" and best is not None:
            # a shell dataset with only what save_game_model reads: the
            # per-shard index maps and the entity indexes
            shell = GameDataset(
                uids=[],
                labels=np.zeros(0, np.float32),
                offsets=np.zeros(0, np.float32),
                weights=np.zeros(0, np.float32),
                shards={
                    sid: ShardData(
                        indices=np.zeros((0, 1), np.int32), values=np.zeros((0, 1), np.float32),
                        index_map=imap, intercept_index=None,
                    )
                    for sid, imap in best_extras["index_maps"].items()
                },
                entity_codes={},
                entity_indexes=best_extras["entity_indexes"],
                num_real_rows=0,
                device=self.device,
            )
            with self.timer.time("save-model"):
                save_game_model(
                    best.game_model, shell, os.path.join(p.output_dir, "best-model"),
                    model_spec="\n".join(
                        f"{name} -> {cfg.render()}" for name, cfg in self.best_config.items()
                    ),
                    num_re_output_files=p.num_output_files_for_random_effect_model,
                )
        sample = best_extras["diagnostics_sample"] if best_extras else None
        diag = None
        if sample is not None and len(sample["lab"]):
            diag = {
                "reservoir_rows": int(len(sample["lab"])),
                "label_mean": float(np.mean(sample["lab"])),
                "weight_sum": float(np.sum(sample["wgt"])),
            }
        atomic_write_json(os.path.join(p.output_dir, "metrics.json"), {
            "objective_history": best.objective_history if best else [],
            "validation_history": best.validation_history if best else [],
            "best_metric": best.best_metric if best else None,
            "timers": self.timer.durations,
            "streaming": {
                "memory_budget_bytes": p.stream_memory_budget,
                "rows_per_chunk": best_extras["rows_per_chunk"] if best_extras else None,
                "num_chunks": best_extras["store"].count if best_extras else None,
                "peak_rss_bytes": peak_rss_bytes(),
                "diagnostics": diag,
            },
            "reliability": reliability_metrics(),
            **({"obs": self.obs.finish()} if self.obs.enabled else {}),
        })
        self.logger.info("timers:\n%s", self.timer.summary())

    def _run(self) -> None:
        p = self.params
        with self.timer.time("load-train"):
            dataset = self._load_dataset(
                self._expand_dated(p.train_input_dirs, p.train_date_range,
                                   p.train_date_range_days_ago),
                index_maps=self._offheap_index_maps(),
            )
        self._train_dataset = dataset
        self.logger.info(
            "GAME train data: %d rows, shards %s", dataset.num_real_rows,
            {s: d.dim for s, d in dataset.shards.items()},
        )
        with self.timer.time("re-datasets"):
            re_datasets = {
                name: build_random_effect_dataset(dataset, cfg)
                for name, cfg in p.random_effect_data_configs.items()
            }
        self._load_parent()
        warm_model = self._warm_start_model(dataset, re_datasets)
        vdata = None
        validation_fn = None
        if p.validate_input_dirs:
            with self.timer.time("load-validate"):
                index_maps = {s: d.index_map for s, d in dataset.shards.items()}
                vdata = self._load_dataset(
                    self._expand_dated(p.validate_input_dirs, p.validate_date_range,
                                       p.validate_date_range_days_ago),
                    index_maps,
                )
            validation_fn = self._validation_fn(vdata)

        combos = expand_config_grid({**p.fixed_effect_opt_configs, **p.random_effect_opt_configs})
        self.logger.info("training %d configuration combo(s)", len(combos))
        maximize = p.task_type == TaskType.LOGISTIC_REGRESSION
        self._best_index = None
        if self._fe_grid_lambdas(combos) is not None:
            self._train_fe_grid_batched(combos, dataset, re_datasets, validation_fn, maximize)
        else:
            # cross-combo warm start: the most-regularized combo first, each
            # later combo seeded from the previous fit; grid indices ride
            # along for the timer labels and metric-less selection
            order = sorted(
                range(len(combos)), key=lambda i: -sum(c.reg_weight for c in combos[i].values())
            )
            guard = PreemptionGuard().install() if p.checkpoint_dir is not None else None
            # retrain warm start: the aligned parent model seeds the FIRST
            # (most-regularized) combo as the cross-combo warm start seeds
            # the rest
            prev_model = warm_model
            try:
                for ti, ci in enumerate(order):
                    combo = combos[ci]
                    if guard is not None and guard.requested:
                        self.logger.warning(
                            "preemption requested: not starting combo %d/%d",
                            ti + 1, len(combos),
                        )
                        break
                    with self.timer.time(f"train-combo-{ci}"), profile_trace(
                        # trace the FIRST combo trained (combos run in
                        # warm-start order, not grid order)
                        p.profile_dir if ti == 0 else None, self.device
                    ):
                        coords = self._build_coordinates(dataset, re_datasets, combo)
                        cd = CoordinateDescent(
                            coords, dataset, p.task_type,
                            update_sequence=p.updating_sequence,
                            validation_fn=validation_fn,
                            validation_metric=(
                                self._evaluators[0].render() if validation_fn is not None else None
                            ),
                            validation_maximize=maximize,
                            logger=self.logger,
                            checkpointer=self._combo_checkpointer(combo),
                            preemption_guard=guard,
                        )
                        result = cd.run(p.num_iterations, initial_model=prev_model)
                        prev_model = result.model
                    self._consider(combo, result, ci, maximize)
                    if result.preempted:
                        self.logger.warning(
                            "stopping combo sweep after preemption (combo %d/%d)",
                            ti + 1, len(combos),
                        )
                        break
            finally:
                if guard is not None:
                    guard.uninstall()

        if self.best_result is None:
            # preempted before any combo finished: the checkpoints carry
            # the partial state; there is no coherent model to save
            self.logger.warning("no configuration combo completed; skipping model save")
            return
        # a pod model's whole bank is an all-gather: every rank makes it
        # here, before process 0 alone writes
        for _, result, _ in self.results:
            for model in (result.model, result.best_model):
                for sub in model.models.values():
                    if getattr(sub, "sharded_bank", None) is not None:
                        sub.bank  # noqa: B018 - materializes the cached whole bank
                        sub.variances  # noqa: B018
        if not multihost.is_coordinator():
            return  # every rank holds the same models; process 0 writes
        best = self.best_result[0]
        if p.model_output_mode != "NONE":
            with self.timer.time("save-model"):
                spec = "\n".join(f"{name} -> {cfg.render()}" for name, cfg in self.best_config.items())
                save_game_model(
                    best.best_model, dataset, os.path.join(p.output_dir, "best-model"),
                    model_spec=spec,
                    num_re_output_files=p.num_output_files_for_random_effect_model,
                )
                if p.model_output_mode == "ALL":
                    # every combo's final model under all/<original grid index>
                    for combo, result, ci in self.results:
                        save_game_model(
                            result.model, dataset, os.path.join(p.output_dir, "all", str(ci)),
                            model_spec="\n".join(
                                f"{name} -> {cfg.render()}" for name, cfg in combo.items()
                            ),
                            num_re_output_files=p.num_output_files_for_random_effect_model,
                        )
        if p.publish_registry:
            with self.timer.time("publish-registry"):
                self._publish_to_registry(vdata)
        registry_block = self._registry_metrics()
        atomic_write_json(os.path.join(p.output_dir, "metrics.json"), {
            "objective_history": best.objective_history,
            "validation_history": best.validation_history,
            "best_metric": best.best_metric,
            "timers": self.timer.durations,
            "reliability": reliability_metrics(),
            **({"registry": registry_block} if registry_block is not None else {}),
            **({"obs": self.obs.finish()} if self.obs.enabled else {}),
        })
        self.logger.info("timers:\n%s", self.timer.summary())


# ---------------------------------------------------------------------------
# CLI (option names from cli/game/training/Params.scala)
# ---------------------------------------------------------------------------


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="photon-ml-tpu-torch game-training")
    ap.add_argument("--train-input-dirs", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--validate-input-dirs", default=None)
    ap.add_argument("--train-date-range", default=None,
                    help="yyyyMMdd-yyyyMMdd; expects <dir>/daily/yyyy/MM/dd")
    ap.add_argument("--train-date-range-days-ago", default=None,
                    help="start-end days ago, e.g. 90-1")
    ap.add_argument("--validate-date-range", default=None)
    ap.add_argument("--validate-date-range-days-ago", default=None)
    ap.add_argument("--task-type", default="LOGISTIC_REGRESSION")
    ap.add_argument("--feature-shard-id-to-feature-section-keys-map", required=True)
    ap.add_argument("--feature-shard-id-to-intercept-map", default=None,
                    help="shardId1:true|shardId2:false (default true)")
    ap.add_argument("--feature-name-and-term-set-path", default=None)
    ap.add_argument("--fixed-effect-data-configurations", default="")
    ap.add_argument("--fixed-effect-optimization-configurations", default="")
    ap.add_argument("--random-effect-data-configurations", default="")
    ap.add_argument("--random-effect-optimization-configurations", default="")
    ap.add_argument("--factored-random-effect-optimization-configurations", default="")
    ap.add_argument("--updating-sequence", default=None)
    ap.add_argument("--num-iterations", type=int, default=1)
    ap.add_argument("--evaluator-types", default=None)
    ap.add_argument("--offheap-indexmap-dir", default=None)
    ap.add_argument("--offheap-indexmap-num-partitions", type=int, default=None)
    ap.add_argument("--compute-variance", default="false")
    ap.add_argument("--model-output-mode", default=None, choices=["ALL", "BEST", "NONE"])
    ap.add_argument("--save-models-to-hdfs", default=None,
                    help="DEPRECATED -- use --model-output-mode (true -> ALL)")
    ap.add_argument("--num-output-files-for-random-effect-model", type=int, default=1)
    ap.add_argument("--application-name", default=None)
    ap.add_argument("--min-partitions-for-validation", type=int, default=None,
                    help="ignored (Spark-only)")
    ap.add_argument("--delete-output-dir-if-exists", default="false")
    ap.add_argument("--coordinator-address", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--distributed", default="auto", choices=["auto", "off", "feature"])
    ap.add_argument("--model-shards", type=int, default=None)
    ap.add_argument("--entity-shards", type=int, default=None)
    ap.add_argument("--fault-plan", default=None)
    ap.add_argument(
        "--retrain-from", default=None,
        help="model-registry directory: warm-start FE vectors and per-entity "
        "RE banks from the latest committed generation with drift-safe "
        "alignment (new terms zero-init, removed terms dropped with "
        "accounting, churned entities prior-mean-init; bitwise pass-through "
        "when nothing drifted)",
    )
    ap.add_argument(
        "--publish-registry", default=None,
        help="model-registry directory: publish best-model as the next "
        "generation, gated against the parent on the validation data (a "
        "failed gate records a named verdict; the candidate is never loadable)",
    )
    ap.add_argument("--gate-max-auc-drop", type=float, default=0.005)
    ap.add_argument("--gate-max-rmse-increase", type=float, default=0.01)
    ap.add_argument("--gate-max-coef-norm-ratio", type=float, default=10.0)
    ap.add_argument(
        "--gate-max-prediction-drift", type=float, default=None,
        help="mean |candidate - parent| holdout margin bound (default: gate off)",
    )
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument(
        "--profile-dir", default=None,
        help="write a torch.profiler trace of the first training combo here",
    )
    ap.add_argument(
        "--obs-dir", default=None,
        help="unified telemetry: training-span tracing + flight "
        "recorder; trace.json / flight.json / metrics_snapshot.json "
        "land here atomically",
    )
    ap.add_argument("--tile-cache-dir", default=None,
                    help="persistent tile-schedule cache directory")
    ap.add_argument("--no-overlap", default="false")
    ap.add_argument("--grid-mode", default="auto", choices=["batched", "sequential", "auto"])
    ap.add_argument("--grid-memory-budget", type=int, default=1 << 30)
    ap.add_argument("--streaming", default="false")
    ap.add_argument("--stream-memory-budget", type=int, default=0)
    ap.add_argument("--diagnostic-reservoir-rows", type=int, default=100_000)
    ap.add_argument("--diagnostic-reservoir-bytes", type=int, default=256 << 20)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    return ap


def _model_output_mode(ns) -> str:
    """--model-output-mode, with the deprecated --save-models-to-hdfs
    boolean mapping to ALL/NONE (Params.scala:379-386)."""
    if ns.save_models_to_hdfs is not None:
        if ns.model_output_mode is not None:
            raise ValueError(
                "specifying both save-models-to-hdfs and model-output-mode is not supported"
            )
        save = str(ns.save_models_to_hdfs).lower() in ("true", "1", "yes")
        return "ALL" if save else "NONE"
    return ns.model_output_mode or "ALL"


def _bool(s) -> bool:
    return str(s).lower() in ("true", "1", "yes")


def params_from_args(argv=None) -> GameTrainingParams:
    ns = build_arg_parser().parse_args(argv)
    factored = {}
    for k, v in parse_keyed_map(ns.factored_random_effect_optimization_configurations).items():
        parts = [x.strip() for x in v.split(",")]  # latentDim,numInnerIterations
        factored[k] = FactoredRandomEffectConfiguration(
            latent_space_dimension=int(parts[0]),
            num_inner_iterations=int(parts[1]) if len(parts) > 1 else 2,
        )
    return GameTrainingParams(
        train_input_dirs=ns.train_input_dirs.split(","),
        validate_input_dirs=ns.validate_input_dirs.split(",") if ns.validate_input_dirs else None,
        train_date_range=ns.train_date_range,
        train_date_range_days_ago=ns.train_date_range_days_ago,
        validate_date_range=ns.validate_date_range,
        validate_date_range_days_ago=ns.validate_date_range_days_ago,
        output_dir=ns.output_dir,
        task_type=TaskType.parse(ns.task_type),
        feature_shards=apply_intercept_map(
            parse_shard_map(ns.feature_shard_id_to_feature_section_keys_map),
            ns.feature_shard_id_to_intercept_map,
        ),
        feature_name_and_term_set_path=ns.feature_name_and_term_set_path,
        fixed_effect_data_configs={
            k: FixedEffectDataConfiguration.parse(v)
            for k, v in parse_keyed_map(ns.fixed_effect_data_configurations).items()
        },
        fixed_effect_opt_configs=parse_keyed_map(ns.fixed_effect_optimization_configurations),
        random_effect_data_configs={
            k: RandomEffectDataConfiguration.parse(v)
            for k, v in parse_keyed_map(ns.random_effect_data_configurations).items()
        },
        random_effect_opt_configs=parse_keyed_map(ns.random_effect_optimization_configurations),
        factored_re_configs=factored,
        updating_sequence=ns.updating_sequence.split(",") if ns.updating_sequence else None,
        num_iterations=ns.num_iterations,
        evaluator_types=(
            [EvaluatorType.parse(s) for s in ns.evaluator_types.split(",")]
            if ns.evaluator_types else []
        ),
        compute_variance=_bool(ns.compute_variance),
        model_output_mode=_model_output_mode(ns),
        num_output_files_for_random_effect_model=ns.num_output_files_for_random_effect_model,
        application_name=ns.application_name or "photon-ml-tpu-game-training",
        offheap_indexmap_dir=ns.offheap_indexmap_dir,
        offheap_indexmap_num_partitions=ns.offheap_indexmap_num_partitions,
        delete_output_dir_if_exists=_bool(ns.delete_output_dir_if_exists),
        distributed=ns.distributed,
        model_shards=ns.model_shards,
        entity_shards=ns.entity_shards,
        coordinator_address=ns.coordinator_address,
        num_processes=ns.num_processes,
        process_id=ns.process_id,
        checkpoint_dir=ns.checkpoint_dir,
        fault_plan=ns.fault_plan,
        profile_dir=ns.profile_dir,
        obs_dir=ns.obs_dir,
        tile_cache_dir=ns.tile_cache_dir,
        no_overlap=_bool(ns.no_overlap),
        grid_mode=ns.grid_mode,
        grid_memory_budget=ns.grid_memory_budget,
        streaming=_bool(ns.streaming),
        stream_memory_budget=ns.stream_memory_budget,
        diagnostic_reservoir_rows=ns.diagnostic_reservoir_rows,
        diagnostic_reservoir_bytes=ns.diagnostic_reservoir_bytes,
        retrain_from=ns.retrain_from,
        publish_registry=ns.publish_registry,
        gate_max_auc_drop=ns.gate_max_auc_drop,
        gate_max_rmse_increase=ns.gate_max_rmse_increase,
        gate_max_coef_norm_ratio=ns.gate_max_coef_norm_ratio,
        gate_max_prediction_drift=ns.gate_max_prediction_drift,
        device=ns.device,
    )


def main(argv=None) -> GameTrainingDriver:
    driver = GameTrainingDriver(params_from_args(argv))
    driver.run()
    return driver


if __name__ == "__main__":
    main()
