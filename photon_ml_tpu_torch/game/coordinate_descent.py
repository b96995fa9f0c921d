"""Block coordinate descent over GAME coordinates (port of
``photon_ml_tpu/game/coordinate_descent.py``).

Reference: photon-ml .../algorithm/CoordinateDescent.scala:50-262 —
init models + scores per coordinate (:82-119); per iteration, per
coordinate: residual = sum of OTHER coordinates' scores -> updateModel ->
rescore -> objective = loss(sum scores) + sum regTerms -> optional
per-iteration validation; tracks the best full model by the first
validation evaluator (:130-262). ``run(numIterations, gameModel)`` accepts
a warm-start model (:82-87).

The score algebra (KeyValueScore.scala:62-82) is row-aligned tensor
arithmetic on the device; the objective and every coordinate's deferred
tracker come back in one batched readback per iteration
(``parallel/overlap.py``). With a ``checkpointer`` every iteration's
models are saved (off the critical path, drained before ``run`` returns)
and a rerun resumes from the latest step; a ``preemption_guard`` stops the
run at the next iteration boundary, agreed by every process of a
multi-process run (``parallel/multihost.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from photon_ml_tpu_torch.game.coordinate import Coordinate
from photon_ml_tpu_torch.game.data import GameDataset
from photon_ml_tpu_torch.game.model import GameModel
from photon_ml_tpu_torch.obs.trace import span as obs_span
from photon_ml_tpu_torch.obs.trace import start_span
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.parallel import multihost, overlap
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.utils.logging_util import PhotonLogger

Tensor = torch.Tensor


@dataclass
class CoordinateDescentResult:
    model: GameModel
    objective_history: List[float]
    trackers: Dict[str, List[object]]
    validation_history: List[Dict[str, float]] = field(default_factory=list)
    best_model: Optional[GameModel] = None
    best_metric: Optional[float] = None
    # True when the run stopped early on a preemption signal; the last
    # completed iteration is checkpointed, so a restarted job resumes
    preempted: bool = False


class CoordinateDescent:
    """run() drives the blocks in ``update_sequence`` order."""

    def __init__(
        self,
        coordinates: Dict[str, Coordinate],
        dataset: GameDataset,
        task: TaskType,
        *,
        update_sequence: Optional[List[str]] = None,
        validation_fn: Optional[Callable[[GameModel], Dict[str, float]]] = None,
        validation_metric: Optional[str] = None,
        validation_maximize: bool = True,
        logger: Optional[PhotonLogger] = None,
        checkpointer=None,  # utils.checkpoint.TrainingCheckpointer
        preemption_guard=None,  # utils.preemption.PreemptionGuard
    ):
        self.coordinates = coordinates
        self.dataset = dataset
        self.task = task
        self.update_sequence = update_sequence or list(coordinates)
        unknown = set(self.update_sequence) - set(coordinates)
        if unknown:
            raise ValueError(f"update sequence references unknown coordinates {unknown}")
        self.validation_fn = validation_fn
        self.validation_metric = validation_metric
        self.validation_maximize = validation_maximize
        self.logger = logger or PhotonLogger()
        self.checkpointer = checkpointer
        self.preemption_guard = preemption_guard

    def _preemption_agreed(self) -> bool:
        """Whether to stop for preemption, agreed across processes: a
        SIGTERM may reach only some of them, and a process that stopped
        alone would leave the others waiting in the next iteration's
        collectives. Every process polls at the same iteration boundary;
        any process's flag stops all (one process: its own flag)."""
        if self.preemption_guard is None:
            return False
        return multihost.any_process(self.preemption_guard.requested)

    def _objective_device(self, total_score: Tensor, models: Dict[str, object]) -> Tensor:
        """loss(sum of scores + offsets) + sum of reg terms
        (CoordinateDescent.scala:196-243), as a device scalar."""
        loss = loss_for_task(self.task)
        lab, off, w = self.dataset.row_tensors()
        z = total_score + off
        value = (w * loss.value(z, lab)).sum()
        for name, coord in self.coordinates.items():
            value = value + coord.regularization_term_device(models[name])
        return value

    def run(
        self,
        num_iterations: int,
        initial_model: Optional[GameModel] = None,
    ) -> CoordinateDescentResult:
        seq = self.update_sequence
        models: Dict[str, object] = {}
        scores: Dict[str, Tensor] = {}
        for name in seq:
            coord = self.coordinates[name]
            if initial_model is not None and initial_model.get_model(name) is not None:
                models[name] = initial_model.get_model(name)
            else:
                models[name] = coord.initialize_model()

        start_iteration = 0
        restored_meta = None
        if self.checkpointer is not None:
            latest = self.checkpointer.latest_step()
            if latest is not None:
                models = self.checkpointer.restore(latest, models)
                start_iteration = latest
                restored_meta = self.checkpointer.load_meta()
                self.logger.info("resumed coordinate descent from checkpoint step %d", latest)
        for name in seq:
            scores[name] = self.coordinates[name].score(models[name])

        objective_history: List[float] = []
        trackers: Dict[str, List[object]] = {name: [] for name in seq}
        validation_history: List[Dict[str, float]] = []
        best_model = None
        best_metric = None
        best_step = None
        preempted = False

        if (
            restored_meta is not None
            and restored_meta.get("best_step")
            and restored_meta.get("metric_name") == self.validation_metric
        ):
            # a resume keeps the original run's best iteration: its metric
            # from the sidecar, its weights from that step while the
            # checkpointer still keeps it; else it is judged anew
            step = int(restored_meta["best_step"])
            if step == start_iteration:
                best_model = GameModel(dict(models), self.task)
            elif step in self.checkpointer.available_steps():
                best_model = GameModel(self.checkpointer.restore(step, models), self.task)
            else:
                self.logger.warning(
                    "best iteration %d checkpoint was pruned; re-judging from "
                    "the restored final model", step,
                )
            if best_model is not None:
                best_metric = restored_meta.get("best_metric")
                best_step = step

        for it in range(start_iteration, num_iterations):
            # one host span per CD iteration (with per-coordinate children)
            # under --obs-dir; --profile-dir carries the device side
            it_span = start_span("cd.iteration", iteration=it + 1)
            # a fresh score sum once per iteration; inside the sweep each
            # coordinate's residual is total - own score and the total is
            # patched as it goes (the KeyValueScore `-` of the reference)
            total = torch.zeros(self.dataset.num_rows, device=self.dataset.device)
            for name in seq:
                total = total + scores[name]
            for name in seq:
                coord = self.coordinates[name]
                residual = total - scores[name] if len(seq) > 1 else None
                with obs_span(
                    "cd.update", parent_id=it_span.span_id,
                    trace_id=it_span.trace_id, coordinate=name,
                ):
                    models[name], tracker = coord.update_model(models[name], residual)
                    trackers[name].append(tracker)
                    new_score = coord.score(models[name])
                total = residual + new_score if residual is not None else new_score
                scores[name] = new_score

            # the objective (loss + every reg term) and every coordinate's
            # deferred tracker in ONE batched readback per iteration
            objective_d = overlap.Deferred(self._objective_device(total, models), float)
            overlap.fetch_all(
                [objective_d]
                + [getattr(trackers[name][-1], "deferred", None) for name in seq]
            )
            objective = objective_d.result()
            it_span.end(objective=objective)
            objective_history.append(objective)
            self.logger.info("coordinate descent iter %d: objective=%g", it + 1, objective)
            if self.checkpointer is not None:
                # a sharded bank is gathered here, by every rank together,
                # and not in the IO worker
                for m in models.values():
                    if getattr(m, "sharded_bank", None) is not None:
                        m.bank  # noqa: B018 - materializes the cached whole bank
                # the write leaves the critical path; drain_io() below is
                # the barrier before any return
                overlap.submit_io(
                    self.checkpointer.save, it + 1, dict(models),
                    artifact=f"checkpoint step {it + 1}",
                )

            if self.validation_fn is not None:
                game_model = GameModel({name: models[name] for name in seq}, self.task)
                metrics = self.validation_fn(game_model)
                validation_history.append(metrics)
                self.logger.info("iter %d validation: %s", it + 1, metrics)
                if self.validation_metric is not None:
                    m = metrics[self.validation_metric]
                    better = (
                        best_metric is None
                        or (self.validation_maximize and m > best_metric)
                        or (not self.validation_maximize and m < best_metric)
                    )
                    if better:
                        best_metric = m
                        best_model = game_model
                        best_step = it + 1

            if self.checkpointer is not None:
                overlap.submit_io(
                    self.checkpointer.save_meta,
                    {
                        "best_step": best_step,
                        "best_metric": best_metric,
                        "metric_name": self.validation_metric,
                    },
                    artifact="checkpoint meta",
                )

            if self._preemption_agreed():
                # iteration it + 1 is complete (and checkpointed above): stop
                # at the safe boundary, flagged even after the last
                # iteration so a caller sweeping a grid stops too
                preempted = True
                self.logger.warning(
                    "preemption requested: stopping after iteration %d/%d",
                    it + 1, num_iterations,
                )
                break

        # every queued checkpoint write is on disk before the run returns
        overlap.drain_io()

        if (
            self.validation_fn is not None
            and not validation_history
            and best_metric is None
            and start_iteration >= num_iterations
        ):
            # a resume with nothing left to run and no best-iteration
            # sidecar: judge the restored model, so the combo has a metric
            game_model = GameModel({name: models[name] for name in seq}, self.task)
            metrics = self.validation_fn(game_model)
            validation_history.append(metrics)
            if self.validation_metric is not None:
                best_metric = metrics[self.validation_metric]
                best_model = game_model

        final = GameModel({name: models[name] for name in seq}, self.task)
        return CoordinateDescentResult(
            model=final,
            objective_history=objective_history,
            trackers=trackers,
            validation_history=validation_history,
            best_model=best_model if best_model is not None else final,
            best_metric=best_metric,
            preempted=preempted,
        )
