"""GAME scoring driver: load a model directory -> score Avro data -> write
ScoringResultAvro -> optional evaluation (port of
``photon_ml_tpu/cli/game_scoring_driver.py``).

    python -m photon_ml_tpu_torch.cli.game_scoring_driver \\
        --input-data-dirs DIR --game-model-input-dir MODEL --output-dir OUT \\
        --feature-shard-id-to-feature-section-keys-map ... [options]

Reference: photon-ml .../cli/game/scoring/Driver.scala:171-204 (run:
prepareFeatureMaps -> prepareGameDataSet(isResponseRequired=false) ->
loadGameModelFromHDFS -> score -> saveScoresToHDFS -> evaluateScores) and
cli/game/scoring/Params.scala (option names kept), ScoredItem.scala.

``--streaming true`` scores one input file at a time in
``--rows-per-chunk`` slices (with prebuilt feature maps: no chunk sees
the whole vocabulary). ``--obs-dir`` writes the scoring pass's trace,
flight recorder and metrics snapshots; ``--profile-dir`` a
``torch.profiler`` trace of the scoring pass. ``--fault-plan`` installs a deterministic
fault plan (``reliability/faults.py``), and ``metrics.json`` carries the
reliability block. The port adds ``--device`` (the card by default,
``cpu`` on request).
"""

from __future__ import annotations

import argparse
import contextlib
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.cli.game_training_driver import (
    _bool,
    apply_intercept_map,
    parse_shard_map,
)
from photon_ml_tpu_torch.cli.glm_driver import prepare_output_dir
from photon_ml_tpu_torch.evaluation.evaluator import Evaluator, EvaluatorType
from photon_ml_tpu_torch.game.config import FeatureShardConfiguration
from photon_ml_tpu_torch.game.data import build_game_dataset_from_files
from photon_ml_tpu_torch.game.model_io import _write_parts, load_game_model
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.ops import schedule_cache
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.parallel import overlap
from photon_ml_tpu_torch.reliability.artifacts import atomic_write_json
from photon_ml_tpu_torch.reliability import install_plan, reliability_metrics
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.utils.date_range import expand_dated_paths
from photon_ml_tpu_torch.utils.device import resolve_device
from photon_ml_tpu_torch.utils.logging_util import PhotonLogger, Timer
from photon_ml_tpu_torch.utils.profiling import profile_trace


@dataclass
class GameScoringParams:
    input_dirs: List[str] = field(default_factory=list)
    game_model_input_dir: str = ""
    output_dir: str = ""
    date_range: Optional[str] = None
    date_range_days_ago: Optional[str] = None
    # extra entity-id columns written with each score (randomEffectTypeSet)
    random_effect_id_set: List[str] = field(default_factory=list)
    num_files: int = 1
    delete_output_dir_if_exists: bool = False
    application_name: str = "photon-ml-tpu-game-scoring"
    task_type: TaskType = TaskType.LOGISTIC_REGRESSION
    feature_shards: List[FeatureShardConfiguration] = field(default_factory=list)
    evaluator_types: List[EvaluatorType] = field(default_factory=list)
    model_id: str = ""
    has_response: bool = True
    offheap_indexmap_dir: Optional[str] = None
    offheap_indexmap_num_partitions: Optional[int] = None
    feature_name_and_term_set_path: Optional[str] = None
    profile_dir: Optional[str] = None
    obs_dir: Optional[str] = None
    tile_cache_dir: Optional[str] = None
    no_overlap: bool = False
    streaming: bool = False
    rows_per_chunk: int = 100_000
    stream_memory_budget: int = 0
    fault_plan: Optional[str] = None
    # where scoring runs: None = the CUDA card (raises without one), "cpu"
    device: Optional[str] = None

    def validate(self):
        if not self.input_dirs:
            raise ValueError("input-data-dirs is required")
        if self.stream_memory_budget and not self.streaming:
            raise ValueError("stream-memory-budget requires --streaming true")
        if self.streaming:
            # every streaming misconfiguration the params show fails here,
            # before the output directory is touched
            if self.rows_per_chunk < 1:
                raise ValueError("rows-per-chunk must be >= 1")
            if not (self.offheap_indexmap_dir or self.feature_name_and_term_set_path):
                raise ValueError(
                    "streaming scoring requires prebuilt feature maps "
                    "(--offheap-indexmap-dir or --feature-name-and-term-set-path): no "
                    "single chunk sees the whole vocabulary"
                )
            for et in self.evaluator_types:
                if et.is_sharded:
                    raise ValueError(
                        f"sharded evaluator {et.render()!r} needs global per-group data; "
                        "use in-memory scoring"
                    )
        if not self.game_model_input_dir:
            raise ValueError("game-model-input-dir is required")
        if not self.output_dir:
            raise ValueError("output-dir is required")


class _ScoreRecordRows:
    """Sliceable, re-iterable score records over column arrays: each record
    dict is built only as the Avro writer consumes it, and ``[i::n]`` (the
    part split) slices columns."""

    def __init__(self, uids, labels, scores, weights, meta_cols, model_id):
        self._uids = uids
        self._labels = labels
        self._scores = scores
        self._weights = weights
        self._meta_cols = meta_cols
        self._model_id = model_id

    def __len__(self) -> int:
        return len(self._uids)

    def __getitem__(self, sl):
        if not isinstance(sl, slice):
            raise TypeError("row views only slice")
        return _ScoreRecordRows(
            uids=self._uids[sl],
            labels=self._labels[sl] if self._labels is not None else None,
            scores=self._scores[sl],
            weights=self._weights[sl],
            meta_cols=[(t, vals[sl], mask[sl]) for t, vals, mask in self._meta_cols],
            model_id=self._model_id,
        )

    def __iter__(self):
        labels = self._labels
        for i, uid in enumerate(self._uids):
            meta = {t: vals[i] for t, vals, mask in self._meta_cols if mask[i]}
            yield {
                "uid": uid,
                "label": labels[i] if labels is not None else None,
                "modelId": self._model_id,
                "predictionScore": self._scores[i],
                "weight": self._weights[i],
                "metadataMap": meta or None,
            }


class GameScoringDriver:
    """After run(): ``metrics`` maps each evaluator's name to its value."""

    def __init__(self, params: GameScoringParams, logger=None):
        params.validate()
        self.params = params
        self.device = resolve_device(params.device)
        if params.fault_plan:
            install_plan(params.fault_plan)
        prepare_output_dir(params.output_dir, delete_if_exists=params.delete_output_dir_if_exists)
        self.logger = logger or PhotonLogger(params.output_dir)
        self.timer = Timer()
        from photon_ml_tpu_torch.obs import ObsSession

        self.obs = ObsSession(params.obs_dir, signal_dump=False)
        self.metrics: Dict[str, float] = {}
        self.scores: Optional[torch.Tensor] = None

    def run(self) -> None:
        p = self.params
        self.logger.info("application: %s", p.application_name)
        with self.timer.time("load-model"):
            model = load_game_model(p.game_model_input_dir)
        self.logger.info("loaded coordinates: %s", model.coordinate_names())

        # id columns: RE types, MF types, sharded evaluator ids, pass-through ids
        id_types = set(p.random_effect_id_set)
        for _, (re_type, _, _) in model.random_effects.items():
            id_types.add(re_type)
        for _, (rt, ct, _, _) in model.matrix_factorizations.items():
            id_types.update((rt, ct))
        for et in p.evaluator_types:
            if et.id_type:
                id_types.add(et.id_type)

        index_maps = None
        if p.offheap_indexmap_dir:
            from photon_ml_tpu_torch.utils.native_index import load_offheap_index_maps

            index_maps = load_offheap_index_maps(
                p.offheap_indexmap_dir, [cfg.shard_id for cfg in p.feature_shards],
                num_partitions=p.offheap_indexmap_num_partitions,
            )
        elif p.feature_name_and_term_set_path:
            from photon_ml_tpu_torch.io.name_term_list import index_maps_from_name_term_lists

            index_maps = index_maps_from_name_term_lists(
                p.feature_name_and_term_set_path, p.feature_shards
            )
        input_paths = expand_dated_paths(
            p.input_dirs, p.date_range, p.date_range_days_ago, self.logger
        )
        scope = (
            schedule_cache.cache_scope(p.tile_cache_dir)
            if p.tile_cache_dir is not None else contextlib.nullcontext()
        )
        if p.streaming:
            with scope:
                self._run_streaming(model, sorted(id_types), index_maps, input_paths)
            self.obs.finish()
            self.logger.info("timers:\n%s", self.timer.summary())
            return
        with scope:
            with self.timer.time("load-data"):
                dataset = build_game_dataset_from_files(
                    input_paths, p.feature_shards, sorted(id_types),
                    index_maps=index_maps, is_response_required=p.has_response,
                    device=self.device,
                )
            with self.timer.time("score"), profile_trace(p.profile_dir, self.device):
                scores = model.score(dataset, p.task_type) + dataset.row_tensors()[1]
                self.scores = scores
        with self.timer.time("write-scores"):
            self._write_scores(dataset, scores.cpu().numpy())
        if p.evaluator_types and p.has_response:
            with self.timer.time("evaluate"):
                self._evaluate(dataset, scores)
            atomic_write_json(
                os.path.join(p.output_dir, "metrics.json"),
                {**self.metrics, "reliability": reliability_metrics()},
            )
        self.obs.finish()
        self.logger.info("timers:\n%s", self.timer.summary())

    def _run_streaming(self, model, id_types, index_maps, input_paths) -> None:
        """Chunked scoring: ONE input file loads at a time, then scores and
        writes in ``rows_per_chunk`` row slices (one scores part file per
        slice), so peak memory is one file's features (the reference
        scores RDD partitions without collecting them, cli/game/scoring/
        Driver.scala:171-204). The pointwise metrics take the scores of
        every slice at the end."""
        from photon_ml_tpu_torch.game.data import slice_game_dataset
        from photon_ml_tpu_torch.game.streaming import game_row_bytes
        from photon_ml_tpu_torch.io.avro_codec import write_container
        from photon_ml_tpu_torch.io.paths import expand_input_paths
        from photon_ml_tpu_torch.io.streaming import stream_budget_rows

        p = self.params
        if p.num_files != 1:
            self.logger.warning(
                "--num-files is ignored in streaming mode: one scores part file is "
                "written per %d-row chunk", p.rows_per_chunk,
            )
        # sorted within each directory, in the caller's directory order:
        # the in-memory path's global order
        files = expand_input_paths(input_paths, lambda fn: fn.endswith(".avro"))
        all_scores, all_labels, all_weights = [], [], []
        n_rows = 0
        part = 0
        rows_per_chunk = p.rows_per_chunk
        os.makedirs(os.path.join(p.output_dir, "scores"), exist_ok=True)
        with self.timer.time("score-stream"), profile_trace(p.profile_dir, self.device):
            for path in files:
                try:
                    ds_file = build_game_dataset_from_files(
                        [path], p.feature_shards, id_types, index_maps=index_maps,
                        is_response_required=p.has_response, row_offset=n_rows,
                        device=self.device,
                    )
                except ValueError as e:
                    if "empty GAME dataset" in str(e):
                        continue  # a part file without records
                    raise
                if p.stream_memory_budget and n_rows == 0:
                    # the training drivers' budget: the chunk's rows from
                    # the scored row's staged bytes
                    row_bytes = game_row_bytes(
                        {sid: sd.indices.shape[1] for sid, sd in ds_file.shards.items()},
                        len(id_types),
                    )
                    rows_per_chunk = min(rows_per_chunk, stream_budget_rows(
                        p.stream_memory_budget, row_bytes, default_rows=rows_per_chunk,
                    ))
                    self.logger.info(
                        "stream memory budget %d B -> %d rows/chunk",
                        p.stream_memory_budget, rows_per_chunk,
                    )
                for a in range(0, ds_file.num_real_rows, rows_per_chunk):
                    ds = slice_game_dataset(ds_file, a, a + rows_per_chunk)
                    scores = model.score(ds, p.task_type) + ds.row_tensors()[1]
                    host = overlap.device_get(scores)[: ds.num_real_rows]
                    write_container(
                        os.path.join(p.output_dir, "scores", f"part-{part:05d}.avro"),
                        schemas.SCORING_RESULT_AVRO, self._score_records(ds, host),
                    )
                    part += 1
                    n_rows += ds.num_real_rows
                    if p.evaluator_types and p.has_response:
                        all_scores.append(host)
                        all_labels.append(np.asarray(ds.labels[: ds.num_real_rows]))
                        all_weights.append(np.asarray(ds.weights[: ds.num_real_rows]))
        if n_rows == 0:
            raise ValueError("empty GAME dataset")  # as the in-memory path
        self.logger.info("streamed %d rows in %d chunk(s) from %d file(s)", n_rows, part, len(files))
        if p.evaluator_types and p.has_response:
            with self.timer.time("evaluate"):
                self._evaluate_pointwise(
                    *(torch.as_tensor(np.concatenate(a), device=self.device)
                      for a in (all_scores, all_labels, all_weights))
                )
            atomic_write_json(
                os.path.join(p.output_dir, "metrics.json"),
                {**self.metrics, "reliability": reliability_metrics()},
            )

    def _score_records(self, dataset, scores: np.ndarray) -> _ScoreRecordRows:
        n = dataset.num_real_rows
        meta_cols = []
        for t in sorted(dataset.entity_indexes):
            codes = np.asarray(dataset.entity_codes[t][:n])
            ids_arr = np.asarray(dataset.entity_indexes[t].ids, dtype=object)
            vals = ids_arr[np.maximum(codes, 0)] if ids_arr.size else np.empty((n,), dtype=object)
            meta_cols.append((t, vals, codes >= 0))
        return _ScoreRecordRows(
            uids=list(dataset.uids[:n]),
            labels=np.asarray(dataset.labels[:n]).tolist() if self.params.has_response else None,
            scores=np.asarray(scores[:n]).tolist(),
            weights=np.asarray(dataset.weights[:n]).tolist(),
            meta_cols=meta_cols,
            model_id=self.params.model_id or "game-model",
        )

    def _write_scores(self, dataset, scores: np.ndarray) -> None:
        _write_parts(
            os.path.join(self.params.output_dir, "scores"),
            schemas.SCORING_RESULT_AVRO,
            self._score_records(dataset, scores),
            self.params.num_files,
        )

    def _evaluate_pointwise(self, scores: torch.Tensor, lab: torch.Tensor, w: torch.Tensor) -> None:
        """The non-sharded evaluators over [n] scores (streamed scoring)."""
        for et in self.params.evaluator_types:
            self._record(et, self._pointwise_metric(et, scores, lab, w))

    def _pointwise_metric(self, et, scores, lab, w) -> float:
        loss = loss_for_task(self.params.task_type)
        metric_in = loss.mean(scores) if et.name == "RMSE" else scores
        return float(Evaluator(et).evaluate(metric_in, lab, w))

    def _record(self, et, value: float) -> None:
        self.metrics[et.render()] = value
        self.logger.info("%s = %g", et.render(), value)

    def _evaluate(self, dataset, scores: torch.Tensor) -> None:
        p = self.params
        lab, _, w = dataset.row_tensors()
        for et in p.evaluator_types:
            if et.is_sharded:
                gids = torch.as_tensor(dataset.entity_codes[et.id_type], device=dataset.device)
                ev = Evaluator(et, num_groups=dataset.entity_indexes[et.id_type].num_entities)
                value = float(ev.evaluate(scores, lab, w, gids.long().clamp_min(0)))
            else:
                value = self._pointwise_metric(et, scores, lab, w)
            self._record(et, value)


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="photon-ml-tpu-torch game-scoring")
    ap.add_argument("--input-data-dirs", required=True)
    ap.add_argument("--game-model-input-dir", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--task-type", default="LOGISTIC_REGRESSION")
    ap.add_argument("--feature-shard-id-to-feature-section-keys-map", required=True)
    ap.add_argument("--evaluator-types", default=None)
    ap.add_argument("--game-model-id", default=None)
    ap.add_argument("--model-id", default=None, help="alias of --game-model-id")
    ap.add_argument("--has-response", default="true")
    ap.add_argument("--offheap-indexmap-dir", default=None)
    ap.add_argument("--offheap-indexmap-num-partitions", type=int, default=None)
    ap.add_argument("--feature-name-and-term-set-path", default=None)
    ap.add_argument("--feature-shard-id-to-intercept-map", default=None)
    ap.add_argument("--date-range", default=None)
    ap.add_argument("--date-range-days-ago", default=None)
    ap.add_argument("--random-effect-id-set", default=None)
    ap.add_argument("--num-files", type=int, default=1)
    ap.add_argument("--delete-output-dir-if-exists", default="false")
    ap.add_argument("--application-name", default=None)
    ap.add_argument(
        "--obs-dir", default=None,
        help="unified telemetry: span tracing + flight recorder; "
        "trace.json / flight.json / metrics_snapshot.json land here",
    )
    ap.add_argument(
        "--profile-dir", default=None,
        help="write a torch.profiler trace of the scoring pass here",
    )
    ap.add_argument("--tile-cache-dir", default=None)
    ap.add_argument("--streaming", default="false")
    ap.add_argument("--rows-per-chunk", type=int, default=100_000)
    ap.add_argument("--stream-memory-budget", type=int, default=0)
    ap.add_argument("--no-overlap", default="false")
    ap.add_argument("--fault-plan", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    return ap


def params_from_args(argv=None) -> GameScoringParams:
    ns = build_arg_parser().parse_args(argv)
    return GameScoringParams(
        input_dirs=ns.input_data_dirs.split(","),
        game_model_input_dir=ns.game_model_input_dir,
        output_dir=ns.output_dir,
        task_type=TaskType.parse(ns.task_type),
        feature_shards=apply_intercept_map(
            parse_shard_map(ns.feature_shard_id_to_feature_section_keys_map),
            ns.feature_shard_id_to_intercept_map,
        ),
        evaluator_types=(
            [EvaluatorType.parse(s) for s in ns.evaluator_types.split(",")]
            if ns.evaluator_types else []
        ),
        model_id=ns.game_model_id or ns.model_id or "",
        profile_dir=ns.profile_dir,
        obs_dir=ns.obs_dir,
        tile_cache_dir=ns.tile_cache_dir,
        no_overlap=_bool(ns.no_overlap),
        streaming=_bool(ns.streaming),
        rows_per_chunk=ns.rows_per_chunk,
        stream_memory_budget=ns.stream_memory_budget,
        fault_plan=ns.fault_plan,
        has_response=_bool(ns.has_response),
        date_range=ns.date_range,
        date_range_days_ago=ns.date_range_days_ago,
        random_effect_id_set=(
            [s for s in ns.random_effect_id_set.split(",") if s]
            if ns.random_effect_id_set else []
        ),
        num_files=ns.num_files,
        delete_output_dir_if_exists=_bool(ns.delete_output_dir_if_exists),
        application_name=ns.application_name or "photon-ml-tpu-game-scoring",
        offheap_indexmap_dir=ns.offheap_indexmap_dir,
        offheap_indexmap_num_partitions=ns.offheap_indexmap_num_partitions,
        feature_name_and_term_set_path=ns.feature_name_and_term_set_path,
        device=ns.device,
    )


def main(argv=None) -> GameScoringDriver:
    driver = GameScoringDriver(params_from_args(argv))
    driver.run()
    return driver


if __name__ == "__main__":
    main()
