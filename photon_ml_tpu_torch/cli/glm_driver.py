"""GLM training driver: the end-to-end single-model pipeline and its CLI
(port of ``photon_ml_tpu/cli/glm_driver.py``).

    python -m photon_ml_tpu_torch.cli.glm_driver \\
        --training-data-directory DIR --output-directory OUT [options]

Reference: photon-ml Driver.scala, a staged pipeline
INIT -> PREPROCESSED -> TRAINED -> VALIDATED -> DIAGNOSED
(DriverStage.scala:47-51; stage methods at Driver.scala:267-292
preprocess, 294-327 train, 329-413 validate (with per-iteration models),
525-552 diagnose, 618-638 report, main at 590-616), PhotonMLCmdLineParser.scala + OptionNames.scala
(the option names, kept verbatim) and Params.scala:200-222 (cross-field
validation).

The parser accepts every option of the JAX package's driver and refuses
what the reference's refuses. Several processes run one a rank
(``--coordinator-address HOST:PORT --num-processes N --process-id I``,
``parallel/multihost.py``): ``--distributed auto`` trains data-parallel,
``--distributed feature`` over a (data, model) mesh of the processes
(``--model-shards``), ``--streaming`` has each process stream its shard of
the files; process 0 writes. ``--streaming true`` trains out of core
(``io/streaming.py``): the preprocess stage scans the files in one pass
(through the per-partition cache of ``--scan-cache-dir``), training reads
fixed-shape chunks from the cache tiers that ``--stream-memory-budget``
sizes (K1 over each chunk's schedules on the card), validation streams
the validation files, and diagnostics run on a reservoir sample. The one
option the port adds is ``--device``: the card by default (the driver
raises without CUDA), ``cpu`` on request.
Training goes through the tiled kernels on the card (``--kernel auto``): K1
for the sequential λ-grid and the diagnostics' refits, K2 for the batched
grid. ``--offheap-indexmap-dir`` reads a store that
``cli/feature_indexing_driver.py`` built. ``--checkpoint-dir`` snapshots
every solved λ (``reliability.GridCheckpointer``): a rerun with the same
arguments after a kill loads them and solves only the rest, and a SIGTERM
stops the sweep at a λ boundary with the outputs withheld.
``--fault-plan`` installs a deterministic fault plan
(``reliability/faults.py``); ``metrics.json`` carries the reliability
block. ``--retrain-from R`` warm-starts the first λ from the latest
committed generation of the model registry ``R`` (``registry/``), aligned
by feature key; ``--publish-registry R`` publishes the best model as the
next generation, gated against that parent on the validation files by
the ``--gate-*`` thresholds (a failed gate is recorded as a refusal and
publishes nothing).
"""

from __future__ import annotations

import argparse
import enum
import os
import shutil
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from photon_ml_tpu_torch.data.stats import compute_summary
from photon_ml_tpu_torch.data.validators import DataValidationType, sanity_check_data
from photon_ml_tpu_torch.diagnostics.report import run_glm_diagnostics
from photon_ml_tpu_torch.evaluation.metrics import (
    area_under_roc_curve,
    mean_pointwise_loss,
    root_mean_squared_error,
)
from photon_ml_tpu_torch.events import (
    EventEmitter,
    PhotonOptimizationLogEvent,
    ScheduleCacheEvent,
    TrainingFinishEvent,
    TrainingStartEvent,
)
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro_codec import write_container
from photon_ml_tpu_torch.evaluation.streaming import (
    finalize_metrics,
    glm_streaming_metrics,
    update_glm_metrics,
)
from photon_ml_tpu_torch.io.input_format import (
    LoadedData,
    create_input_format,
    parse_constraint_string,
)
from photon_ml_tpu_torch.io.streaming import (
    budgeted_rows,
    iter_chunks,
    scan_stream,
    scan_stream_with_summary,
    sparse_row_bytes,
    stream_budget_rows,
    shard_stream_files,
    streaming_summary,
)
from photon_ml_tpu_torch.io.model_io import save_glm_models_avro, write_models_in_text
from photon_ml_tpu_torch.models.glm import compute_margins, compute_means
from photon_ml_tpu_torch.ops import schedule_cache
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.normalization import (
    NormalizationContext,
    NormalizationType,
    build_normalization,
)
from photon_ml_tpu_torch.optim.common import CONVERGENCE_REASON_NAMES
from photon_ml_tpu_torch.optim.config import OptimizerType, RegularizationType
from photon_ml_tpu_torch.reliability import (
    GridCheckpointer,
    install_plan,
    reliability_metrics,
)
from photon_ml_tpu_torch.registry import cached_scan_stream, cached_scan_stream_with_summary
from photon_ml_tpu_torch.reliability.artifacts import atomic_write_json, atomic_writer
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.training import (
    grid_result_scalars,
    iteration_models,
    resolve_grid_mode,
    train_generalized_linear_model,
    train_grid_batched,
    train_feature_sharded,
    train_grid_batched_feature_sharded,
    train_streaming_feature_sharded,
    train_streaming_glm,
)
from photon_ml_tpu_torch.utils.date_range import (
    input_paths_within_date_range,
    resolve_date_range,
)
from photon_ml_tpu_torch.utils.device import resolve_device
from photon_ml_tpu_torch.utils.index_map import intercept_key, split_feature_key
from photon_ml_tpu_torch.utils.native_index import load_offheap_index_map
from photon_ml_tpu_torch.parallel import multihost
from photon_ml_tpu_torch.parallel.mesh import maybe_make_mesh
from photon_ml_tpu_torch.utils.logging_util import PhotonLogger, Timer
from photon_ml_tpu_torch.utils.preemption import PreemptionGuard
from photon_ml_tpu_torch.utils.profiling import peak_rss_bytes


class DriverStage(enum.IntEnum):
    INIT = 0
    PREPROCESSED = 1
    TRAINED = 2
    VALIDATED = 3
    DIAGNOSED = 4


class DiagnosticMode(enum.Enum):
    NONE = "NONE"
    TRAIN = "TRAIN"
    VALIDATE = "VALIDATE"
    ALL = "ALL"

    @classmethod
    def parse(cls, s: str) -> "DiagnosticMode":
        return cls(s.strip().upper())


@dataclass
class GLMParams:
    """The reference's Params bean (Params.scala), with every field of the
    JAX package's driver so that every option parses; the fields of paths
    not ported yet must keep their defaults (:meth:`validate`)."""

    train_dir: str = ""
    output_dir: str = ""
    validate_dir: Optional[str] = None
    # dated inputs (DateRange.scala / IOUtils.scala:84+): with a range the
    # directory is read in daily format <dir>/daily/yyyy/MM/dd
    train_date_range: Optional[str] = None
    train_date_range_days_ago: Optional[str] = None
    validate_date_range: Optional[str] = None
    validate_date_range_days_ago: Optional[str] = None
    validate_per_iteration: bool = False
    task: TaskType = TaskType.LOGISTIC_REGRESSION
    input_format: str = "AVRO"  # AVRO | LIBSVM (INPUT_FILE_FORMAT)
    # Avro field names (io/FieldNamesType.scala): the response is "label"
    # for TRAINING_EXAMPLE, "response" for RESPONSE_PREDICTION
    field_names: str = "TRAINING_EXAMPLE"
    # pre-declared LibSVM dimension (LibSVMInputDataFormat.scala:32-39)
    feature_dimension: Optional[int] = None
    # writes optimization-log.txt under the output directory
    enable_optimization_tracker: bool = True
    add_intercept: bool = True
    regularization_weights: List[float] = field(default_factory=lambda: [0.0])
    regularization_type: RegularizationType = RegularizationType.L2
    elastic_net_alpha: Optional[float] = None
    optimizer_type: OptimizerType = OptimizerType.LBFGS
    max_num_iterations: Optional[int] = None
    tolerance: Optional[float] = None
    normalization_type: NormalizationType = NormalizationType.NONE
    data_validation_type: DataValidationType = DataValidationType.VALIDATE_FULL
    constraint_string: Optional[str] = None
    selected_features_file: Optional[str] = None
    summarization_output_dir: Optional[str] = None
    offheap_indexmap_dir: Optional[str] = None
    offheap_indexmap_num_partitions: Optional[int] = None
    diagnostic_mode: DiagnosticMode = DiagnosticMode.NONE
    compute_variances: bool = False
    delete_output_dirs_if_exist: bool = False
    job_name: str = "photon-ml-tpu"
    event_listeners: List[str] = field(default_factory=list)
    # "auto" (the tiled kernels on the card, scatter on the CPU), "tiled"
    # or "scatter": see optim.problem.resolve_kernel
    kernel: str = "auto"
    # "auto" and "off" train on one card; "feature" is the mesh path
    distributed: str = "auto"
    model_shards: Optional[int] = None
    streaming: bool = False
    stream_memory_budget: int = 0
    # torch.profiler trace of the training stage into this directory
    # (utils/profiling.py; conventionally <output-dir>/profile)
    profile_dir: Optional[str] = None
    # --obs-dir: training-span tracing + flight recorder + metrics
    # snapshots (trace.json, flight.json, metrics_snapshot.json)
    obs_dir: Optional[str] = None
    # persistent schedule cache (ops/schedule_cache.py); None falls back
    # to the PHOTON_TILE_CACHE_DIR env var; unset = off
    tile_cache_dir: Optional[str] = None
    # accepted: the GLM path has no deferred readbacks or async writes
    no_overlap: bool = False
    diagnostic_reservoir_rows: int = 100_000
    diagnostic_reservoir_bytes: int = 256 << 20
    # λ-grid policy (training.resolve_grid_mode): "batched" solves the grid
    # as one [G, d] bank (K2), "sequential" warm-starts one fit per λ
    # (K1), "auto" picks batched when the grid has more than one member
    # and the bank fits grid_memory_budget
    grid_mode: str = "auto"
    grid_memory_budget: int = 1 << 30
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    checkpoint_dir: Optional[str] = None
    fault_plan: Optional[str] = None
    # Continuous retraining (registry/): --retrain-from warm-starts the
    # coefficient vector from the latest committed generation of a model
    # registry with drift-safe alignment (new vocab terms zero-init,
    # removed terms dropped with accounting — bitwise pass-through when
    # nothing drifted); --publish-registry publishes the trained best
    # model as the next generation, gated against the parent on the
    # validating directory (AUC/RMSE non-regression, coefficient-norm
    # sanity, optional prediction-drift bound). A failed gate records a
    # named terminal verdict and the candidate is never loadable.
    retrain_from: Optional[str] = None
    publish_registry: Optional[str] = None
    gate_max_auc_drop: float = 0.005
    gate_max_rmse_increase: float = 0.01
    gate_max_coef_norm_ratio: float = 10.0
    gate_max_prediction_drift: Optional[float] = None
    scan_cache_dir: Optional[str] = None
    # where the fit runs: None = the CUDA card (raises without one), "cpu"
    device: Optional[str] = None

    def unported(self) -> List[str]:
        """The options set here whose paths the port lacks, each with the
        ROADMAP item it waits for."""
        out = []

        def need(cond: bool, what: str, item: str) -> None:
            if cond:
                out.append(f"{what} (ROADMAP {item})")

        return out

    def validate(self) -> None:
        """Cross-field checks (Params.validate, Params.scala:200-222)."""
        unported = self.unported()
        if unported:
            raise NotImplementedError(
                "not ported to photon_ml_tpu_torch yet: " + "; ".join(unported)
            )
        if not self.train_dir:
            raise ValueError("training-data-directory is required")
        if not self.output_dir:
            raise ValueError("output-directory is required")
        if self.kernel not in ("auto", "tiled", "scatter"):
            raise ValueError(f"unknown kernel {self.kernel!r}")
        if self.feature_dimension is not None and self.input_format.strip().upper() != "LIBSVM":
            raise ValueError("feature-dimension only applies to the LIBSVM input format")
        if self.distributed not in ("auto", "off", "feature"):
            raise ValueError(f"unknown distributed mode {self.distributed!r}")
        if self.optimizer_type == OptimizerType.TRON and self.regularization_type in (
            RegularizationType.L1,
            RegularizationType.ELASTIC_NET,
        ):
            raise ValueError(
                f"Combination of optimizer {self.optimizer_type.value} and "
                f"regularization {self.regularization_type.value} is not allowed"
            )
        if (
            self.task == TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM
            and self.optimizer_type == OptimizerType.TRON
        ):
            raise ValueError("TRON is not supported for the smoothed hinge loss")
        if self.constraint_string is not None and self.normalization_type != NormalizationType.NONE:
            raise ValueError("box constraints with normalization are not supported")
        if any(w < 0 for w in self.regularization_weights):
            raise ValueError("regularization weights must be non-negative")
        if self.grid_mode not in ("batched", "sequential", "auto"):
            raise ValueError(
                f"unknown grid mode {self.grid_mode!r}; expected "
                "batched | sequential | auto"
            )
        if self.streaming:
            # what the streamed path leaves out, in the reference's words
            unsupported = []
            if self.distributed == "feature":
                if self.normalization_type != NormalizationType.NONE:
                    unsupported.append(
                        "normalization with streaming feature-sharded training "
                        "(the shift/factor extras are not threaded through the "
                        "per-chunk sharded programs)"
                    )
                if self.coordinator_address is not None:
                    unsupported.append("multi-process streaming feature-sharded training")
            if self.coordinator_address is not None and not self.offheap_indexmap_dir:
                unsupported.append(
                    "multi-process streaming without a prebuilt offheap index "
                    "map (no single process sees the vocabulary)"
                )
            if unsupported:
                raise ValueError(
                    "streaming training does not support: " + ", ".join(unsupported)
                )
        if self.grid_mode == "batched" and self.streaming:
            raise ValueError(
                "--grid-mode batched is incompatible with --streaming: a "
                "streamed objective reads its chunks on every evaluation; the "
                "streaming path always runs the warm-started sequential grid"
            )
        if self.grid_memory_budget < 1:
            raise ValueError("grid-memory-budget must be >= 1")
        if self.diagnostic_reservoir_rows < 1:
            raise ValueError("diagnostic-reservoir-rows must be >= 1")
        if self.diagnostic_reservoir_bytes < 1:
            raise ValueError("diagnostic-reservoir-bytes must be >= 1")
        if self.validate_per_iteration and not self.validate_dir:
            raise ValueError("validate-per-iteration requires a validating data directory")
        if self.stream_memory_budget and not self.streaming:
            raise ValueError("stream-memory-budget requires --streaming true")
        if self.scan_cache_dir and not self.streaming:
            raise ValueError(
                "scan-cache-dir caches the streaming preprocess scan; it "
                "requires --streaming true"
            )
        if self.scan_cache_dir and self.input_format.strip().upper() != "AVRO":
            raise ValueError(
                "scan-cache-dir requires the AVRO input format (the "
                "per-partition moment partials use the Avro decoder)"
            )
        if self.gate_max_coef_norm_ratio <= 0:
            raise ValueError("gate-max-coef-norm-ratio must be > 0")
        if self.retrain_from and self.publish_registry and not self.validate_dir:
            raise ValueError(
                "validation-gated promotion (--retrain-from + "
                "--publish-registry) requires a validating data "
                "directory: the gates compare candidate vs parent on a "
                "held-out stream"
            )
        if self.retrain_from and self.distributed == "feature":
            raise ValueError(
                "--retrain-from warm starts are not wired through the "
                "feature-sharded trainers yet; use --distributed auto|off"
            )
        # the range strings fail here, not mid-preprocess
        resolve_date_range(self.train_date_range, self.train_date_range_days_ago)
        resolve_date_range(self.validate_date_range, self.validate_date_range_days_ago)


def _glm_artifact_means(model_dir: str) -> Dict[str, float]:
    """The coefficient dict {feature key: value} of a published GLM
    generation (``model.avro``, one best-model record) — the KEY-space
    view drift-safe alignment consumes."""
    from photon_ml_tpu_torch.io.avro_codec import read_container
    from photon_ml_tpu_torch.utils.index_map import feature_key

    path = os.path.join(model_dir, "model.avro")
    _, records = read_container(path)
    for record in records:
        return {
            feature_key(m["name"], m["term"]): float(m["value"])
            for m in record["means"]
        }
    raise ValueError(f"no model record in {path}")


def budgeted_reservoir_rows(max_rows: int, budget_bytes: int, max_nnz: int) -> int:
    """Rows of the streamed diagnostics' reservoir under a byte budget: the
    sample is rows x max_nnz slots (8 B each, plus 12 B a row), so wide
    rows scale the count down instead of allocating gigabytes on the
    host."""
    return budgeted_rows(max_rows, budget_bytes, sparse_row_bytes(max_nnz))


def prepare_output_dir(path: str, *, delete_if_exists: bool, hint: str = "") -> None:
    """Refuse a non-empty output directory unless asked to replace it
    (IOUtils.processOutputDir, Driver.scala:148-151)."""
    if os.path.isdir(path) and os.listdir(path) and not delete_if_exists:
        suffix = f" ({hint})" if hint else ""
        raise ValueError(f"output directory {path} exists and is non-empty{suffix}")
    if os.path.isdir(path) and delete_if_exists:
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)


class GLMDriver:
    """Staged GLM pipeline. After run(): ``stage_history`` lists completed
    stages, ``models`` maps lambda->model, ``best_model`` /
    ``validation_metrics`` filled when a validation dir was given."""

    def __init__(
        self,
        params: GLMParams,
        logger: Optional[PhotonLogger] = None,
        emitter: Optional[EventEmitter] = None,
    ):
        params.validate()
        self.params = params
        # before anything touches the output directory: without CUDA and
        # without device="cpu" this raises
        self.device = resolve_device(params.device)
        # one process a rank (a no-op without --coordinator-address): every
        # rank trains, process 0 writes
        multihost.initialize_multihost(
            params.coordinator_address, params.num_processes, params.process_id,
            device=params.device,
        )
        if params.fault_plan:
            install_plan(params.fault_plan)
        # the output-dir guard precedes the logger, which opens photon.log
        # inside the output dir
        guard_dir = (
            multihost.prepare_output_dir if multihost.process_count() > 1
            else prepare_output_dir
        )
        guard_dir(
            params.output_dir,
            delete_if_exists=params.delete_output_dirs_if_exist,
            hint="pass --delete-output-dirs-if-exist to overwrite",
        )
        # every process logs; process 0's photon.log is the log of record
        self.logger = logger or PhotonLogger(
            params.output_dir if multihost.is_coordinator() else None
        )
        self._process_mesh = None
        self.emitter = emitter or EventEmitter()
        for name in params.event_listeners:
            self.emitter.register_by_name(name)
        from photon_ml_tpu_torch.obs import ObsSession

        self.obs = ObsSession(params.obs_dir, signal_dump=False)
        self.timer = Timer()
        self.stage = DriverStage.INIT
        self.stage_history: List[DriverStage] = []
        self.models = {}
        self.results = {}
        self.best_model = None
        self.best_lambda: Optional[float] = None
        self.validation_metrics: Dict[float, Dict[str, float]] = {}
        # --validate-per-iteration: {lambda: [metrics of iteration 0, 1, ...]}
        self.per_iteration_metrics: Dict[float, List[Dict[str, float]]] = {}
        self._data: Optional[LoadedData] = None
        self._norm: Optional[NormalizationContext] = None
        self._summary = None
        # tile-schedule cache counters captured after the train stage
        self._schedule_cache_stats: Dict[str, float] = {}
        # a SIGTERM stopped the λ sweep (--checkpoint-dir): outputs withheld
        self._preempted = False
        # --streaming: (train paths, StreamStats), the diagnostics'
        # reservoir sample, the scan cache's counters and the streamed
        # objective's tier counters
        self._stream = None
        self._stream_sample = None
        self._scan_cache_stats: Dict[str, int] = {}
        self._stream_stats: Dict[str, object] = {}
        # continuous retraining state (--retrain-from / --publish-registry)
        self._parent_generation = None   # registry.GenerationInfo
        self._parent_means: Optional[Dict[str, float]] = None
        self._drift_report = None        # registry.DriftReport
        self._published_generation: Optional[int] = None
        self._gate_report = None

    # -- stages ------------------------------------------------------------

    def _advance(self, stage: DriverStage) -> None:
        self.stage_history.append(stage)
        self.stage = stage

    def preprocess(self) -> None:
        p = self.params
        with self.timer.time("preprocess"):
            selected = None
            if p.selected_features_file:
                with open(p.selected_features_file) as f:
                    selected = [line.strip() for line in f if line.strip()]
            kwargs = dict(add_intercept=p.add_intercept, selected_features=selected)
            if p.input_format.strip().upper() == "AVRO":
                kwargs["field_names"] = p.field_names
            elif p.feature_dimension is not None:
                kwargs["feature_dimension"] = p.feature_dimension
            fmt = create_input_format(p.input_format, **kwargs)
            self._fmt = fmt
            train_paths = self._dated_paths(
                p.train_dir, p.train_date_range, p.train_date_range_days_ago
            )
            prebuilt = None
            if p.offheap_indexmap_dir:
                # a store from the feature-indexing driver replaces the
                # vocabulary scan (PalDBIndexMapLoader analog)
                prebuilt = load_offheap_index_map(
                    p.offheap_indexmap_dir,
                    num_partitions=p.offheap_indexmap_num_partitions,
                )
                self.logger.info(
                    "offheap index map: %d features from %s",
                    prebuilt.size, p.offheap_indexmap_dir,
                )
            if p.streaming:
                self._preprocess_streaming(fmt, train_paths, prebuilt)
                self._advance(DriverStage.PREPROCESSED)
                return
            data = fmt.load(
                train_paths, index_map=prebuilt,
                constraint_string=p.constraint_string, device=self.device,
            )
            self._data = data
            self.logger.info(
                "loaded %d examples, %d features",
                int((data.batch.weights > 0).sum()),
                data.num_features,
            )
            sanity_check_data(data.batch, p.task, p.data_validation_type)
            self._summary = compute_summary(data.batch, data.num_features)
            self._norm = build_normalization(
                p.normalization_type,
                mean=self._summary.mean,
                std=self._summary.std,
                max_magnitude=self._summary.max_magnitude,
                intercept_index=data.intercept_index,
            )
            if p.summarization_output_dir and multihost.is_coordinator():
                self._write_summary(p.summarization_output_dir)
        self._advance(DriverStage.PREPROCESSED)

    def _preprocess_streaming(self, fmt, train_paths, prebuilt) -> None:
        """The streamed preprocess: one bounded-memory scan (vocabulary,
        staging shape and, when normalization, a summary output or
        diagnostics need it, the colStats summary) with no full load; the
        fused scan when no diagnostics reservoir is drawn, through the
        per-partition cache with ``--scan-cache-dir``; then the data
        checks, chunk by chunk."""
        p = self.params
        needs_summary = (
            p.normalization_type != NormalizationType.NONE
            or bool(p.summarization_output_dir)
            or p.diagnostic_mode != DiagnosticMode.NONE
        )
        # the fused pass cannot draw the reservoir (it needs rows in the
        # final index space): diagnostics take scan + streamed summary
        multi = multihost.process_count() > 1
        # several processes: the scan reads every file (the global
        # vocabulary and staging shape), the summary and the checks each
        # process's shard, the summary's moments summed in rank order
        use_fused = not multi and needs_summary and p.diagnostic_mode == DiagnosticMode.NONE and hasattr(
            fmt, "stream_scan_with_summary"
        )
        fused_summary = None
        if p.scan_cache_dir is not None:
            if use_fused:
                index_map, stats, fused_summary, cache_stats = cached_scan_stream_with_summary(
                    train_paths, fmt, p.scan_cache_dir, index_map=prebuilt, device=self.device,
                )
            else:
                index_map, stats, cache_stats = cached_scan_stream(
                    train_paths, fmt, p.scan_cache_dir, index_map=prebuilt
                )
            self._scan_cache_stats = cache_stats.as_dict()
            self.logger.info(
                "scan cache: %d partition(s), %d cached, %d scanned, %d quarantined",
                cache_stats.partitions, cache_stats.cached, cache_stats.scanned,
                cache_stats.quarantined,
            )
        elif use_fused:
            index_map, stats, fused_summary = scan_stream_with_summary(
                train_paths, fmt, index_map=prebuilt, device=self.device
            )
        else:
            index_map, stats = scan_stream(train_paths, fmt, index_map=prebuilt)
        icept = index_map.get_index(intercept_key()) if p.add_intercept else -1
        intercept_index = icept if icept >= 0 else None
        self._data = LoadedData(
            batch=None, index_map=index_map, num_features=index_map.size,
            intercept_index=intercept_index,
            constraints=parse_constraint_string(
                p.constraint_string, index_map, index_map.size, intercept_index,
                device=self.device,
            ),
        )
        self._stream = (train_paths, stats)
        self.logger.info(
            "streaming scan: %d examples, %d features, max %d nnz/row",
            stats.num_rows, index_map.size, stats.max_nnz,
        )
        if needs_summary:
            if fused_summary is not None:
                self._summary = fused_summary
            else:
                reservoir = 0
                if p.diagnostic_mode != DiagnosticMode.NONE:
                    reservoir = budgeted_reservoir_rows(
                        p.diagnostic_reservoir_rows, p.diagnostic_reservoir_bytes,
                        stats.max_nnz,
                    )
                    if reservoir < p.diagnostic_reservoir_rows:
                        self.logger.info(
                            "diagnostics reservoir scaled to %d rows (%d B budget at "
                            "%d nnz/row)", reservoir, p.diagnostic_reservoir_bytes,
                            stats.max_nnz,
                        )
                self._summary, self._stream_sample = streaming_summary(
                    shard_stream_files(train_paths, fmt) if multi else train_paths,
                    fmt, index_map, stats, reservoir_rows=reservoir,
                    device=self.device,
                )
            self._norm = build_normalization(
                p.normalization_type,
                mean=self._summary.mean,
                std=self._summary.std,
                max_magnitude=self._summary.max_magnitude,
                intercept_index=intercept_index,
            )
            if p.summarization_output_dir and multihost.is_coordinator():
                self._write_summary(p.summarization_output_dir)
        if p.data_validation_type != DataValidationType.VALIDATE_DISABLED:
            # the in-memory path's checks, chunk by chunk (each process
            # checks its own shard)
            for chunk in iter_chunks(
                shard_stream_files(train_paths, fmt) if multi else train_paths,
                fmt, index_map, rows_per_chunk=65536,
                nnz_width=stats.max_nnz, device=self.device,
            ):
                sanity_check_data(chunk, p.task, p.data_validation_type)

    def _dated_paths(self, base_dir, date_range, days_ago):
        """Expand a base dir to its daily paths when a date range is given
        (IOUtils.getInputPathsWithinDateRange); otherwise the dir itself."""
        rng = resolve_date_range(date_range, days_ago)
        if rng is None:
            return base_dir
        paths = input_paths_within_date_range(base_dir, rng)
        self.logger.info(
            "date range %s expanded %s to %d daily paths", rng, base_dir, len(paths),
        )
        return paths

    def _grid_checkpoint_setup(self):
        """(GridCheckpointer, installed PreemptionGuard) for
        --checkpoint-dir, or (None, None). The run manifest fingerprints
        everything that shapes the λ iterate chain, so a resume under a
        changed configuration fails loudly instead of mixing in foreign
        snapshots."""
        p = self.params
        if p.checkpoint_dir is None:
            return None, None
        run_config = {
            "train_dir": p.train_dir,
            "train_date_range": p.train_date_range,
            "train_date_range_days_ago": p.train_date_range_days_ago,
            "task": p.task.name,
            "optimizer": p.optimizer_type.value,
            "regularization_type": p.regularization_type.value,
            "regularization_weights": sorted(set(float(w) for w in p.regularization_weights)),
            "elastic_net_alpha": p.elastic_net_alpha,
            "max_num_iterations": p.max_num_iterations,
            "tolerance": p.tolerance,
            "normalization_type": p.normalization_type.value,
            "intercept": p.add_intercept,
            "kernel": p.kernel,
            "grid_mode": p.grid_mode,
            "streaming": p.streaming,
            "constraint_string": p.constraint_string,
        }
        if p.retrain_from:
            # the warm start changes the iterate chain: a resumed sweep
            # must come from the SAME parent generation
            run_config["retrain_parent_signature"] = (
                self._parent_generation.signature
                if self._parent_generation is not None
                else None
            )
        guard = PreemptionGuard().install()
        if not multihost.is_coordinator():
            multihost.sync_processes()  # process 0 writes the manifest first
        checkpointer = GridCheckpointer(p.checkpoint_dir, run_config)
        if multihost.is_coordinator():
            multihost.sync_processes()
        return checkpointer, guard

    def train(self) -> None:
        p = self.params
        self.emitter.send(TrainingStartEvent(p.job_name))
        self._load_parent()
        grid_ckpt, guard = self._grid_checkpoint_setup()
        from photon_ml_tpu_torch.utils.profiling import profile_trace

        with self.timer.time("train"), profile_trace(p.profile_dir, self.device):
            initial = self._retrain_initial()
            if p.streaming:
                self._train_streaming(grid_ckpt, guard, initial)
            else:
                self._train_in_memory(grid_ckpt, guard, initial)
            self._log_results()
        if guard is not None:
            self._preempted = guard.requested
            guard.uninstall()
            if self._preempted:
                self.logger.warning(
                    "preemption requested: lambda sweep stopped at a lambda "
                    "boundary (%d snapshot(s) on disk); rerun with the same "
                    "args to resume", len(self.models),
                )
        self._log_schedule_cache()
        self.emitter.send(TrainingFinishEvent(p.job_name))
        self._advance(DriverStage.TRAINED)

    def _train_in_memory(self, grid_ckpt, guard, initial) -> None:
        """The in-memory λ-grid: sequential (K1) or batched (K2), from
        ``initial`` (the retrain warm start) or zeros."""
        p = self.params
        data = self._data
        mesh = self._mesh()
        if p.distributed == "feature" and mesh is not None:
            self._train_feature_sharded(mesh)
            return
        trainer = train_generalized_linear_model
        extra = {"grid_checkpointer": grid_ckpt, "preemption_guard": guard}
        if mesh is not None:
            # the data-parallel fit: every rank its shard of the rows
            extra["mesh"] = mesh
            self.logger.info("training data-parallel over %d processes", mesh.world_size)
        if self._resolved_grid_mode(data.num_features) == "batched":
            trainer = train_grid_batched
            # one solve has no λ boundary to stop at
            extra.pop("preemption_guard")
            self.logger.info(
                "training a BATCHED %d-member lambda grid (one optimizer "
                "loop over a [G, d] bank; no cross-lambda warm starts)",
                len(set(p.regularization_weights)),
            )
        self.models, self.results = trainer(
            data.batch,
            p.task,
            data.num_features,
            optimizer_type=p.optimizer_type,
            regularization_type=p.regularization_type,
            regularization_weights=p.regularization_weights,
            elastic_net_alpha=p.elastic_net_alpha,
            max_iter=p.max_num_iterations,
            tolerance=p.tolerance,
            normalization=self._norm,
            compute_variances=p.compute_variances,
            box=data.constraints,
            intercept_index=data.intercept_index,
            kernel=p.kernel,
            device=None if mesh is not None else self.device,
            track_models=p.validate_per_iteration,
            tile_cache_dir=p.tile_cache_dir,
            initial=initial,
            **extra,
        )

    def _mesh(self):
        """The mesh over the processes, made once (every rank makes it in
        the same order): ``parallel.mesh.maybe_make_mesh``, None with one
        process or "off"; "feature" a (data, model) mesh with
        ``--model-shards`` (default 2) on the model axis; "auto" a data
        mesh."""
        p = self.params
        if self._process_mesh is None:
            self._process_mesh = maybe_make_mesh(
                p.distributed, p.model_shards, device=self.device,
                backend=multihost.backend_for(multihost.process_count(), p.device),
            )
        return self._process_mesh

    def _train_feature_sharded(self, mesh) -> None:
        """The in-memory λ-grid over a feature-sharded coefficient vector
        (``--distributed feature``), warm-started or batched."""
        p = self.params
        data = self._data
        batched = self._resolved_grid_mode(data.num_features) == "batched"
        trainer = train_grid_batched_feature_sharded if batched else train_feature_sharded
        self.logger.info(
            "training feature-sharded over mesh %s%s", dict(zip(mesh.axis_names, mesh.shape)),
            " with a BATCHED lambda grid" if batched else "",
        )
        self.models, self.results = trainer(
            data.batch,
            p.task,
            data.num_features,
            mesh=mesh,
            regularization_type=p.regularization_type,
            regularization_weights=p.regularization_weights,
            elastic_net_alpha=p.elastic_net_alpha,
            max_iter=p.max_num_iterations,
            tolerance=p.tolerance,
            normalization=self._norm,
            compute_variances=p.compute_variances,
            box=data.constraints,
            intercept_index=data.intercept_index,
            kernel=p.kernel,
            optimizer_type=p.optimizer_type,
            track_models=p.validate_per_iteration,
            tile_cache_dir=p.tile_cache_dir,
        )

    def _train_streaming(self, grid_ckpt, guard, initial) -> None:
        """The out-of-core λ-grid (sequential, warm-started): chunk rows
        and cache tiers from ``--stream-memory-budget``."""
        p = self.params
        train_paths, stats = self._stream
        rows_per_chunk = stream_budget_rows(
            p.stream_memory_budget, sparse_row_bytes(stats.max_nnz)
        )
        cache_bytes = p.stream_memory_budget if p.stream_memory_budget > 0 else 2 << 30
        if p.stream_memory_budget:
            self.logger.info(
                "stream memory budget %d B -> %d rows/chunk, %d B cache tiers",
                p.stream_memory_budget, rows_per_chunk, cache_bytes,
            )
        # a plain streamed run over several processes needs no mesh: each
        # streams its shard and the partials are summed in rank order
        mesh = self._mesh() if p.distributed == "feature" else None
        if mesh is not None:
            self.logger.info(
                "training in streaming FEATURE-SHARDED mode over mesh %s (%d rows "
                "per full-batch pass)", dict(zip(mesh.axis_names, mesh.shape)),
                stats.num_rows,
            )
            self.models, self.results, _ = train_streaming_feature_sharded(
                train_paths, p.task, mesh=mesh,
                regularization_type=p.regularization_type,
                regularization_weights=p.regularization_weights,
                elastic_net_alpha=p.elastic_net_alpha,
                max_iter=p.max_num_iterations, tolerance=p.tolerance,
                rows_per_chunk=rows_per_chunk, cache_bytes=cache_bytes,
                sharded_cache_bytes=cache_bytes, optimizer_type=p.optimizer_type,
                compute_variances=p.compute_variances, box=self._data.constraints,
                track_models=p.validate_per_iteration, fmt=self._fmt,
                index_map=self._data.index_map, stats=stats,
                grid_checkpointer=grid_ckpt, preemption_guard=guard,
            )
            return
        self.logger.info(
            "training in streaming mode (%d rows per full-batch pass%s)", stats.num_rows,
            f"; this process streams its shard of {multihost.process_count()}"
            if multihost.process_count() > 1 else "",
        )
        objectives = []
        self.models, self.results, _ = train_streaming_glm(
            train_paths,
            p.task,
            regularization_type=p.regularization_type,
            regularization_weights=p.regularization_weights,
            elastic_net_alpha=p.elastic_net_alpha,
            max_iter=p.max_num_iterations,
            tolerance=p.tolerance,
            rows_per_chunk=rows_per_chunk,
            cache_bytes=cache_bytes,
            kernel=p.kernel,
            optimizer_type=p.optimizer_type,
            normalization=self._norm,
            compute_variances=p.compute_variances,
            box=self._data.constraints,
            track_models=p.validate_per_iteration,
            fmt=self._fmt,
            index_map=self._data.index_map,
            stats=stats,
            tile_cache_dir=p.tile_cache_dir,
            grid_checkpointer=grid_ckpt,
            preemption_guard=guard,
            initial=initial,
            device=self.device,
            objective_out=objectives,
        )
        objective = objectives[0]
        self._stream_stats = {
            "rows_per_chunk": objective.rows_per_chunk,
            "tiers": objective.tier_counts,
            "spill_bytes": objective.spill_bytes,
            "decode_passes": objective.decode_passes,
        }
        # the tiers hold device memory and scratch: released here
        objective.close()

    def _resolved_grid_mode(self, dim: int) -> str:
        """Resolve --grid-mode for the in-memory training stage."""
        p = self.params
        n_weights = len(set(p.regularization_weights))
        mode = resolve_grid_mode(
            p.grid_mode,
            num_weights=n_weights,
            dim=dim,
            optimizer_type=p.optimizer_type,
            memory_budget_bytes=p.grid_memory_budget,
            streaming=False,
        )
        if p.grid_mode == "auto" and mode == "sequential" and n_weights > 1:
            self.logger.info(
                "grid-mode auto: %d-member grid over %d features does not fit "
                "the %d-byte bank budget; using the warm-started sequential path",
                n_weights, dim, p.grid_memory_budget,
            )
        return mode

    def _log_schedule_cache(self) -> None:
        """Surface the tile-schedule cache outcome of the training stage
        (build/load/hit-miss timers) to the log and the event stream."""
        s = schedule_cache.stats()
        if not (s.builds or s.hits or s.misses):
            return  # scatter kernel: no tiled conversion this run
        self._schedule_cache_stats = s.as_dict()
        self.emitter.send(ScheduleCacheEvent(stats=self._schedule_cache_stats))
        self.logger.info(
            "tile-schedule cache: %d hit(s), %d miss(es), %d build(s), %d store(s) "
            "(build %.2fs, load %.3fs, store %.2fs, hash %.2fs, wait %.2fs)",
            s.hits, s.misses, s.builds, s.stores, s.build_s, s.load_s, s.store_s,
            s.hash_s, s.wait_s,
        )

    def _log_results(self) -> None:
        # one fetch for the whole grid's (iterations, value, reason)
        for lam, (iters, value, reason) in grid_result_scalars(self.results).items():
            name = CONVERGENCE_REASON_NAMES.get(reason, "?")
            self.emitter.send(
                PhotonOptimizationLogEvent(
                    reg_weight=lam, iterations=iters, convergence_reason=name,
                    final_value=value,
                )
            )
            self.logger.info(
                "lambda=%g: %d iters, f=%g, reason=%s", lam, iters, value, name
            )

    def _metrics_for(self, model, batch) -> Dict[str, float]:
        task = self.params.task
        margins = compute_margins(model.means, batch)
        loss = loss_for_task(task)
        metrics = {
            f"{loss.name}_loss": float(
                mean_pointwise_loss(loss, margins, batch.labels, batch.weights)
            )
        }
        if task in (TaskType.LOGISTIC_REGRESSION, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM):
            metrics["AUC"] = float(area_under_roc_curve(margins, batch.labels, batch.weights))
        if task in (TaskType.LINEAR_REGRESSION, TaskType.POISSON_REGRESSION):
            means = compute_means(task, model.means, batch)
            metrics["RMSE"] = float(
                root_mean_squared_error(means, batch.labels, batch.weights)
            )
        return metrics

    def _streamed_metrics_for(self, means, validate_paths, vstats) -> Dict[str, float]:
        """One bounded pass over the validation stream for ONE model: the
        driver's metric set through streaming accumulators
        (``evaluation/streaming.py``)."""
        loss = loss_for_task(self.params.task)
        accs = glm_streaming_metrics(self.params.task, loss)
        for chunk in iter_chunks(
            validate_paths, self._fmt, self._data.index_map, rows_per_chunk=65536,
            nnz_width=vstats.max_nnz, device=self.device,
        ):
            update_glm_metrics(
                accs, loss, compute_margins(means, chunk), chunk.labels, chunk.weights
            )
        return finalize_metrics(accs)

    def _validate_streaming(self, validate_paths) -> None:
        """Streamed validation (Driver.scala:329-413 as one more pass):
        per-λ metrics, the best model and the per-iteration metrics, each
        one pass over the validation files, never loaded whole."""
        p = self.params
        _, vstats = scan_stream(validate_paths, self._fmt, index_map=self._data.index_map)
        self.logger.info(
            "streamed validation scan: %d examples, max %d nnz/row",
            vstats.num_rows, vstats.max_nnz,
        )
        if p.data_validation_type != DataValidationType.VALIDATE_DISABLED:
            for chunk in iter_chunks(
                validate_paths, self._fmt, self._data.index_map, rows_per_chunk=65536,
                nnz_width=vstats.max_nnz, device=self.device,
            ):
                sanity_check_data(chunk, p.task, p.data_validation_type)

        def metrics_of(model):
            return self._streamed_metrics_for(model.means, validate_paths, vstats)

        if p.validate_per_iteration:
            self._log_per_iteration(metrics_of)
        self._select_best(metrics_of)

    def _select_best(self, metrics_of) -> None:
        """Each λ's metrics and the best model: by AUC for classification,
        RMSE or the loss otherwise (ModelSelection.scala:36-63)."""
        maximize = self.params.task == TaskType.LOGISTIC_REGRESSION
        best = None
        for lam, model in self.models.items():
            metrics = metrics_of(model)
            self.validation_metrics[lam] = metrics
            key = "AUC" if maximize else ("RMSE" if "RMSE" in metrics else next(iter(metrics)))
            score = metrics[key]
            self.logger.info("lambda=%g validation %s", lam, metrics)
            if (
                best is None
                or (maximize and score > best[2])
                or (not maximize and score < best[2])
            ):
                best = (lam, model, score)
        self.best_lambda, self.best_model, _ = best

    def validate(self) -> None:
        p = self.params
        with self.timer.time("validate"):
            validate_paths = self._dated_paths(
                p.validate_dir, p.validate_date_range, p.validate_date_range_days_ago,
            )
            if p.streaming:
                self._validate_streaming(validate_paths)
                self._advance(DriverStage.VALIDATED)
                return
            vdata = self._fmt.load(
                validate_paths, index_map=self._data.index_map, device=self.device
            )
            sanity_check_data(vdata.batch, p.task, p.data_validation_type)
            self._validation_data = vdata

            def metrics_of(model):
                return self._metrics_for(model, vdata.batch)

            if p.validate_per_iteration:
                self._log_per_iteration(metrics_of)
            self._select_best(metrics_of)
        self._advance(DriverStage.VALIDATED)

    def _log_per_iteration(self, metrics_of) -> None:
        """Metrics of every (lambda, iteration) model
        (computeAndLogModelMetrics, Driver.scala:330-349)."""
        p = self.params
        for lam, result in self.results.items():
            models = iteration_models(
                result, p.task, self._norm, self._data.intercept_index
            )
            per_iter = [metrics_of(m) for m in models]
            self.per_iteration_metrics[lam] = per_iter
            msg = "\n".join(
                f"Iteration: [{i:6d}] " + " ".join(
                    f"Metric: [{k}] value: {v}" for k, v in sorted(metrics.items())
                )
                for i, metrics in enumerate(per_iter)
            )
            self.logger.info("Model with lambda = %g:\n%s", lam, msg)

    def diagnose(self) -> None:
        """Model diagnostics and the HTML report (Driver.scala:525-552,
        618-638)."""
        with self.timer.time("diagnose"):
            run_glm_diagnostics(self)
        self._advance(DriverStage.DIAGNOSED)

    # -- continuous retraining (registry/) -----------------------------------

    def _load_parent(self) -> None:
        """Resolve --retrain-from to the latest committed generation and
        its coefficient dict (by feature KEY — alignment never trusts
        indices across vocabularies). A registry with no committed
        generation is a cold start, not an error: the first cron tick of
        a retrain loop trains from zeros and publishes generation 1."""
        p = self.params
        if not p.retrain_from:
            return
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
        self._parent_means = _glm_artifact_means(info.model_dir)
        self.logger.info(
            "retraining from generation %d (lineage %s, %d parent coefficients, "
            "gate verdict %s)",
            info.generation, registry.lineage(info.generation),
            len(self._parent_means), info.gate_verdict,
        )

    def _retrain_initial(self):
        """The drift-safe warm-start vector in the CURRENT index space
        (None when not retraining): new terms zero-init, removed terms
        dropped with accounting, bitwise the parent when nothing drifted.
        The report lands in metrics.json."""
        if self._parent_means is None:
            return None
        from photon_ml_tpu_torch.registry import DriftReport, align_coefficients

        report = DriftReport()
        initial = align_coefficients(self._parent_means, self._data.index_map, report=report)
        self._drift_report = report
        self.logger.info(
            "warm-start alignment: %d kept, %d new (zero-init), %d dropped%s",
            report.kept, report.new_zero_init, report.dropped,
            "" if report.no_drift else " [DRIFT]",
        )
        return initial

    def _run_gates(self, candidate_model):
        """Candidate-vs-parent gates on the validation data; returns the
        GateReport whose verdict decides the publish. Both models score
        the same rows on the driver's device, one fetch a chunk."""
        import torch

        from photon_ml_tpu_torch.parallel import overlap
        from photon_ml_tpu_torch.registry import GateConfig, align_coefficients, evaluate_gates
        from photon_ml_tpu_torch.registry.gates import glm_gate_chunks

        p = self.params
        config = GateConfig(
            max_auc_drop=p.gate_max_auc_drop,
            max_rmse_increase=p.gate_max_rmse_increase,
            max_coef_norm_ratio=p.gate_max_coef_norm_ratio,
            max_prediction_drift=p.gate_max_prediction_drift,
        )
        # the parent scored through TODAY's featurization: shared terms
        # contribute identically, vanished terms contribute nothing
        parent_vec = align_coefficients(self._parent_means, self._data.index_map)
        # photon: allow(hidden-host-sync) — the gates read the candidate's means once, after the fit; this scope's gate metrics go through overlap.device_get
        candidate_means = candidate_model.means.detach().cpu().numpy()
        if p.streaming:
            validate_paths = self._dated_paths(
                p.validate_dir, p.validate_date_range, p.validate_date_range_days_ago,
            )
            _, vstats = scan_stream(validate_paths, self._fmt, index_map=self._data.index_map)
            chunks = glm_gate_chunks(
                candidate_means, parent_vec, validate_paths, self._fmt,
                self._data.index_map, vstats.max_nnz, device=self.device,
            )
        else:
            batch = self._validation_data.batch
            chunks = [overlap.device_get((
                compute_margins(candidate_model.means, batch),
                compute_margins(torch.as_tensor(parent_vec, device=self.device), batch),
                batch.labels,
                batch.weights,
            ))]
        report = evaluate_gates(
            chunks, p.task, config=config,
            candidate_norm=float(np.linalg.norm(candidate_means)),
            parent_norm=float(np.linalg.norm(parent_vec)),
            device=self.device,
        )
        self._gate_report = report
        self.logger.info(
            "validation gates: %s %s", report.verdict,
            {k: v.get("passed") for k, v in report.checks.items()},
        )
        return report

    def _publish_to_registry(self) -> None:
        """Publish the trained model as the next generation. A failed gate
        is an EXPECTED terminal outcome of the retrain loop: the refusal
        (named verdict) is recorded in the registry and in metrics.json,
        and the driver exits cleanly without a new generation."""
        p = self.params
        if self.best_model is not None:
            lam, model = self.best_lambda, self.best_model
        elif len(self.models) == 1:
            lam, model = next(iter(self.models.items()))
        else:
            raise ValueError(
                "publishing a multi-lambda grid requires a validating "
                "directory to select the best model"
            )
        gate_report = None
        if self._parent_generation is not None:
            gate_report = self._run_gates(model)
        candidate_dir = os.path.join(p.output_dir, "registry-candidate")
        save_glm_models_avro(
            {lam: model}, os.path.join(candidate_dir, "model.avro"), self._data.index_map
        )
        # the index map rides with the artifact so the NEXT retrain (and
        # any scorer) aligns by key without this run's output tree
        self._data.index_map.save(os.path.join(candidate_dir, "feature-index", "index.json"))
        from photon_ml_tpu_torch.registry import ModelRegistry, RefusedCandidate

        registry = ModelRegistry(p.publish_registry)
        extra = {
            "task": p.task.name,
            "lambda": float(lam),
            "num_features": int(self._data.num_features),
        }
        if self._drift_report is not None:
            extra["drift"] = self._drift_report.as_dict()
        try:
            info = registry.publish(
                candidate_dir,
                parent=(
                    self._parent_generation.generation
                    if self._parent_generation is not None else None
                ),
                data_ranges={
                    "train_dir": p.train_dir,
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

    # -- outputs -----------------------------------------------------------

    def _write_summary(self, out_dir: str) -> None:
        os.makedirs(out_dir, exist_ok=True)
        s = self._summary
        columns = {
            "mean": s.mean, "variance": s.variance, "numNonzeros": s.num_nonzeros,
            "max": s.max, "min": s.min, "normL1": s.norm_l1, "normL2": s.norm_l2,
            "meanAbs": s.mean_abs,
        }
        columns = {k: v.cpu().tolist() for k, v in columns.items()}
        records = []
        for key, i in self._data.index_map.items():
            name, term = split_feature_key(key)
            records.append(
                {
                    "featureName": name,
                    "featureTerm": term,
                    "metrics": {k: v[i] for k, v in columns.items()},
                }
            )
        write_container(
            os.path.join(out_dir, "part-00000.avro"),
            schemas.FEATURE_SUMMARIZATION_RESULT_AVRO,
            records,
        )

    def _write_outputs(self) -> None:
        p = self.params
        out = p.output_dir
        os.makedirs(out, exist_ok=True)
        index_map = self._data.index_map
        index_map.save(os.path.join(out, "feature-index", "index.json"))
        write_models_in_text(self.models, os.path.join(out, "models-text"), index_map)
        save_glm_models_avro(
            self.models, os.path.join(out, "models", "models.avro"), index_map
        )
        if self.best_model is not None:
            save_glm_models_avro(
                {self.best_lambda: self.best_model},
                os.path.join(out, "best-model", "model.avro"),
                index_map,
            )
        if p.enable_optimization_tracker:
            with atomic_writer(os.path.join(out, "optimization-log.txt")) as f:
                for lam, res in sorted(self.results.items()):
                    t = res.tracker
                    values = t.values.cpu().tolist()
                    grad_norms = t.grad_norms.cpu().tolist()
                    f.write(
                        f"lambda={lam} iterations={int(res.iterations)} "
                        f"converged={res.reason_name}\n"
                    )
                    # slot 0 is the pre-optimization initial point
                    for i in range(int(t.count)):
                        f.write(
                            f"  iter={i} value={values[i]:.8g} "
                            f"|grad|={grad_norms[i]:.8g}\n"
                        )
        payload = {
            "validation": {str(k): v for k, v in self.validation_metrics.items()},
            "per_iteration_validation": {
                str(k): v for k, v in self.per_iteration_metrics.items()
            },
            "best_lambda": self.best_lambda,
            "timers": self.timer.durations,
            "schedule_cache": self._schedule_cache_stats,
        }
        if self._scan_cache_stats:
            # the "touched only new partitions" counters
            payload["scan_cache"] = self._scan_cache_stats
        if p.retrain_from or p.publish_registry:
            payload["registry"] = {
                "retrain_from": p.retrain_from,
                "parent_generation": (
                    self._parent_generation.generation
                    if self._parent_generation is not None else None
                ),
                "published_generation": self._published_generation,
                "drift": (
                    self._drift_report.as_dict() if self._drift_report is not None else None
                ),
                "gates": (
                    self._gate_report.as_dict() if self._gate_report is not None else None
                ),
            }
        if p.streaming:
            # the out-of-core contract made observable: the budget against
            # the host's measured high-water, and the tiers it filled
            payload["streaming"] = {
                "memory_budget_bytes": p.stream_memory_budget,
                "peak_rss_bytes": peak_rss_bytes(),
                **self._stream_stats,
            }
        # every injected fault, retry and quarantined artifact, by seam
        payload["reliability"] = reliability_metrics()
        atomic_write_json(os.path.join(out, "metrics.json"), payload)

    def run(self) -> None:
        p = self.params
        self.preprocess()
        self.train()
        if self._preempted:
            # the λ snapshots carry the partial sweep; outputs of a partial
            # grid would pass for a whole one
            self.logger.info("preempted: outputs withheld; resume to finish")
            self.obs.finish(reason="preempted")
            self.emitter.close()
            self.logger.close()
            return
        if not multihost.is_coordinator():
            # every rank holds the same models: process 0 validates and writes
            self.logger.info("stages: %s", [st.name for st in self.stage_history])
            self.obs.finish()
            self.emitter.close()
            self.logger.close()
            return
        if p.validate_dir:
            self.validate()
        if p.diagnostic_mode != DiagnosticMode.NONE:
            self.diagnose()
        if p.publish_registry:
            # gates + publish run BEFORE the outputs so the verdict and the
            # published generation land in metrics.json
            with self.timer.time("publish-registry"):
                self._publish_to_registry()
        with self.timer.time("write"):
            self._write_outputs()
        self.logger.info("stages: %s", [s.name for s in self.stage_history])
        self.logger.info("timers:\n%s", self.timer.summary())
        self.obs.finish()
        self.emitter.close()
        self.logger.close()


# ---------------------------------------------------------------------------
# CLI (option names from OptionNames.scala)
# ---------------------------------------------------------------------------


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m photon_ml_tpu_torch.cli.glm_driver",
        description="GLM training driver of the PyTorch/CUDA port (Photon ML parity)",
    )
    ap.add_argument("--training-data-directory", required=True)
    ap.add_argument("--output-directory", required=True)
    ap.add_argument("--validating-data-directory", default=None)
    ap.add_argument("--train-date-range", default=None,
                    help="yyyyMMdd-yyyyMMdd; expects <dir>/daily/yyyy/MM/dd")
    ap.add_argument("--train-date-range-days-ago", default=None,
                    help="start-end days ago, e.g. 90-1")
    ap.add_argument("--validate-date-range", default=None)
    ap.add_argument("--validate-date-range-days-ago", default=None)
    ap.add_argument("--validate-per-iteration", default="false")
    ap.add_argument("--task", default="LOGISTIC_REGRESSION")
    ap.add_argument(
        "--format", default="TRAINING_EXAMPLE",
        help="Avro field-name convention: TRAINING_EXAMPLE | "
        "RESPONSE_PREDICTION (FieldNamesType). Legacy values AVRO|LIBSVM "
        "are accepted as --input-file-format.",
    )
    ap.add_argument("--input-file-format", default=None, help="AVRO | LIBSVM")
    ap.add_argument("--feature-dimension", type=int, default=None)
    ap.add_argument("--optimization-tracker", default="true")
    ap.add_argument(
        "--training-diagnostics", default=None,
        help="DEPRECATED -- use --diagnostic-mode (true -> ALL)",
    )
    # Spark-runtime tuning knobs, accepted for invocation compatibility and
    # ignored: serialization, input splits and treeAggregate depth have no
    # counterpart here
    ap.add_argument("--kryo", default=None, help="ignored (Spark-only)")
    ap.add_argument("--min-partitions", type=int, default=None, help="ignored (Spark-only)")
    ap.add_argument("--tree-aggregate-depth", type=int, default=None,
                    help="ignored (Spark-only)")
    ap.add_argument("--intercept", default="true")
    ap.add_argument("--regularization-weights", default="0")
    ap.add_argument("--regularization-type", default="L2")
    ap.add_argument("--elastic-net-alpha", type=float, default=None)
    ap.add_argument("--optimizer", default="LBFGS")
    ap.add_argument("--num-iterations", type=int, default=None)
    ap.add_argument("--convergence-tolerance", type=float, default=None)
    ap.add_argument("--normalization-type", default="NONE")
    ap.add_argument("--data-validation-type", default="VALIDATE_FULL")
    ap.add_argument("--coefficient-box-constraints", default=None)
    ap.add_argument("--selected-features-file", default=None)
    ap.add_argument("--summarization-output-dir", default=None)
    ap.add_argument(
        "--offheap-indexmap-dir", default=None,
        help="a feature index store built by "
        "python -m photon_ml_tpu_torch.cli.feature_indexing_driver",
    )
    ap.add_argument("--offheap-indexmap-num-partitions", type=int, default=None)
    ap.add_argument("--diagnostic-mode", default=None,
                    help="NONE | TRAIN | VALIDATE | ALL")
    ap.add_argument("--compute-variances", default="false")
    ap.add_argument("--delete-output-dirs-if-exist", default="false")
    ap.add_argument("--job-name", default="photon-ml-tpu")
    ap.add_argument("--event-listeners", default=None)
    ap.add_argument(
        "--kernel", default="auto", choices=["auto", "tiled", "scatter"],
        help="objective kernel (auto: the tiled kernels on the card, "
        "scatter on the CPU)",
    )
    ap.add_argument(
        "--distributed", default="auto", choices=["auto", "off", "feature"],
        help="over several processes: auto trains data-parallel, feature "
        "shards the coefficients over a (data, model) mesh; off, or one "
        "process: one card",
    )
    ap.add_argument("--model-shards", type=int, default=None,
                    help="model-axis size for --distributed feature (default 2)")
    ap.add_argument(
        "--streaming", default="false",
        help="true: stream the training data from disk per evaluation "
        "(bounded host memory for data larger than RAM; Avro or LibSVM)",
    )
    ap.add_argument(
        "--stream-memory-budget", type=int, default=0,
        help="host-memory byte budget of the streaming layer: fixes the "
        "staged chunk's rows and the cache tiers; peak RSS is reported "
        "against it in metrics.json. 0 = default sizing",
    )
    ap.add_argument(
        "--profile-dir", default=None,
        help="write a torch.profiler trace of the training stage here "
        "(Chrome trace-event JSON, the card's kernels included on CUDA)",
    )
    ap.add_argument(
        "--obs-dir", default=None,
        help="unified telemetry: training-span tracing + flight "
        "recorder; trace.json (Chrome trace-event), flight.json and "
        "metrics_snapshot.json land here atomically",
    )
    ap.add_argument(
        "--tile-cache-dir", default=None,
        help="persistent content-addressed tile-schedule cache directory: "
        "warm reruns over the same dataset load the tiled layout instead "
        "of rebuilding it. Default: $PHOTON_TILE_CACHE_DIR, unset = off",
    )
    ap.add_argument("--diagnostic-reservoir-rows", type=int, default=100_000)
    ap.add_argument("--diagnostic-reservoir-bytes", type=int, default=256 << 20)
    ap.add_argument("--coordinator-address", default=None,
                    help="host:port (or tcp://host:port) where process 0 of a "
                    "multi-process run listens; with --num-processes and "
                    "--process-id, one process a rank")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument(
        "--no-overlap", default="false",
        help="accepted; the GLM path has no deferred readbacks or async writes to turn off",
    )
    ap.add_argument(
        "--grid-mode", default="auto", choices=["batched", "sequential", "auto"],
        help="lambda-grid execution: batched = one optimizer loop over a "
        "[G, d] coefficient bank (K2 on the card; no cross-lambda warm "
        "starts); sequential = warm-started one fit per lambda (K1); auto = "
        "batched when the grid has >1 member and the bank fits "
        "--grid-memory-budget",
    )
    ap.add_argument(
        "--grid-memory-budget", type=int, default=1 << 30,
        help="byte budget for the batched grid's G x d bank and optimizer "
        "state; auto falls back to sequential above it (default 1 GiB)",
    )
    ap.add_argument(
        "--checkpoint-dir", default=None,
        help="per-lambda crash-safe snapshots: a rerun with the same args "
        "loads the solved lambdas and resumes the sweep",
    )
    ap.add_argument(
        "--fault-plan", default=None,
        help="deterministic fault injection, e.g. ckpt_save:4:KILL "
        "(seam:nth:error[:times]; also PHOTON_FAULT_PLAN)",
    )
    ap.add_argument(
        "--retrain-from", default=None,
        help="model-registry directory: warm-start the coefficients from the "
        "latest committed generation with drift-safe alignment (new terms "
        "zero-init, removed terms dropped with accounting; bitwise "
        "pass-through when nothing drifted)",
    )
    ap.add_argument(
        "--publish-registry", default=None,
        help="model-registry directory: publish the trained best model as the "
        "next generation, gated against the parent on the validating "
        "directory when --retrain-from resolved one (a failed gate records a "
        "named verdict; the candidate is never loadable)",
    )
    ap.add_argument(
        "--scan-cache-dir", default=None,
        help="append-only per-partition scan/stats cache: the streaming "
        "preprocess reads again ONLY partitions without an entry (counters "
        "in metrics.json)",
    )
    ap.add_argument("--gate-max-auc-drop", type=float, default=0.005)
    ap.add_argument("--gate-max-rmse-increase", type=float, default=0.01)
    ap.add_argument("--gate-max-coef-norm-ratio", type=float, default=10.0)
    ap.add_argument(
        "--gate-max-prediction-drift", type=float, default=None,
        help="mean |candidate - parent| holdout margin bound (default: gate off)",
    )
    ap.add_argument(
        "--device", default=None,
        help="where to train: the CUDA card by default (the driver raises "
        "without one); cpu on request",
    )
    return ap


def _bool(s) -> bool:
    return str(s).strip().lower() in ("true", "1", "yes")


def params_from_args(argv=None) -> GLMParams:
    ns = build_arg_parser().parse_args(argv)
    # --format carries the FieldNamesType; legacy invocations that passed
    # AVRO|LIBSVM there are routed to --input-file-format instead
    fmt = (ns.format or "TRAINING_EXAMPLE").strip().upper()
    file_format = ns.input_file_format
    field_names = "TRAINING_EXAMPLE"
    if fmt in ("AVRO", "LIBSVM"):
        file_format = file_format or fmt
    elif fmt in ("TRAINING_EXAMPLE", "RESPONSE_PREDICTION", "NONE"):
        field_names = fmt
    else:
        raise ValueError(f"unknown --format {ns.format!r}")
    if ns.training_diagnostics is not None:
        # deprecated boolean (PhotonMLCmdLineParser.scala:68-69,184-186):
        # exclusive with --diagnostic-mode, maps to ALL/NONE
        if ns.diagnostic_mode is not None:
            raise ValueError(
                "specifying both training-diagnostics and diagnostic-mode "
                "is not supported"
            )
        ns.diagnostic_mode = "ALL" if _bool(ns.training_diagnostics) else "NONE"
    return GLMParams(
        train_dir=ns.training_data_directory,
        output_dir=ns.output_directory,
        validate_dir=ns.validating_data_directory,
        train_date_range=ns.train_date_range,
        train_date_range_days_ago=ns.train_date_range_days_ago,
        validate_date_range=ns.validate_date_range,
        validate_date_range_days_ago=ns.validate_date_range_days_ago,
        validate_per_iteration=_bool(ns.validate_per_iteration),
        task=TaskType.parse(ns.task),
        input_format=file_format or "AVRO",
        field_names=field_names,
        feature_dimension=ns.feature_dimension,
        enable_optimization_tracker=_bool(ns.optimization_tracker),
        add_intercept=_bool(ns.intercept),
        regularization_weights=[float(x) for x in ns.regularization_weights.split(",") if x],
        regularization_type=RegularizationType.parse(ns.regularization_type),
        elastic_net_alpha=ns.elastic_net_alpha,
        optimizer_type=OptimizerType.parse(ns.optimizer),
        max_num_iterations=ns.num_iterations,
        tolerance=ns.convergence_tolerance,
        normalization_type=NormalizationType(ns.normalization_type.strip().upper()),
        data_validation_type=DataValidationType.parse(ns.data_validation_type),
        constraint_string=ns.coefficient_box_constraints,
        selected_features_file=ns.selected_features_file,
        summarization_output_dir=ns.summarization_output_dir,
        offheap_indexmap_dir=ns.offheap_indexmap_dir,
        offheap_indexmap_num_partitions=ns.offheap_indexmap_num_partitions,
        diagnostic_mode=DiagnosticMode.parse(ns.diagnostic_mode or "NONE"),
        compute_variances=_bool(ns.compute_variances),
        delete_output_dirs_if_exist=_bool(ns.delete_output_dirs_if_exist),
        job_name=ns.job_name,
        kernel=ns.kernel,
        distributed=ns.distributed,
        streaming=_bool(ns.streaming),
        stream_memory_budget=ns.stream_memory_budget,
        profile_dir=ns.profile_dir,
        obs_dir=ns.obs_dir,
        tile_cache_dir=ns.tile_cache_dir,
        no_overlap=_bool(ns.no_overlap),
        grid_mode=ns.grid_mode,
        grid_memory_budget=ns.grid_memory_budget,
        diagnostic_reservoir_rows=ns.diagnostic_reservoir_rows,
        diagnostic_reservoir_bytes=ns.diagnostic_reservoir_bytes,
        model_shards=ns.model_shards,
        coordinator_address=ns.coordinator_address,
        num_processes=ns.num_processes,
        process_id=ns.process_id,
        checkpoint_dir=ns.checkpoint_dir,
        fault_plan=ns.fault_plan,
        retrain_from=ns.retrain_from,
        publish_registry=ns.publish_registry,
        scan_cache_dir=ns.scan_cache_dir,
        gate_max_auc_drop=ns.gate_max_auc_drop,
        gate_max_rmse_increase=ns.gate_max_rmse_increase,
        gate_max_coef_norm_ratio=ns.gate_max_coef_norm_ratio,
        gate_max_prediction_drift=ns.gate_max_prediction_drift,
        event_listeners=ns.event_listeners.split(",") if ns.event_listeners else [],
        device=ns.device,
    )


def main(argv=None) -> GLMDriver:
    """Parse ``argv``, run the pipeline; -> the driver (its models, stage
    timers and metrics), for callers that run it in-process."""
    driver = GLMDriver(params_from_args(argv))
    driver.run()
    return driver


if __name__ == "__main__":
    main()
