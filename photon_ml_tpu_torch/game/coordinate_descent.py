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
arithmetic on the device; the objective comes back in one fetch per
iteration. Checkpoints and the preemption guard wait for ROADMAP item 12.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from photon_ml_tpu_torch.game.coordinate import Coordinate
from photon_ml_tpu_torch.game.data import GameDataset
from photon_ml_tpu_torch.game.model import GameModel
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.optim import common
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
    # a stop on a preemption signal (always False until ROADMAP item 12)
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
        checkpointer=None,
        preemption_guard=None,
    ):
        if checkpointer is not None or preemption_guard is not None:
            raise NotImplementedError(
                "not ported yet: coordinate-descent checkpoints and the "
                "preemption guard (ROADMAP item 12)"
            )
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
        for name in seq:
            scores[name] = self.coordinates[name].score(models[name])

        objective_history: List[float] = []
        trackers: Dict[str, List[object]] = {name: [] for name in seq}
        validation_history: List[Dict[str, float]] = []
        best_model = None
        best_metric = None

        for it in range(num_iterations):
            # a fresh score sum once per iteration; inside the sweep each
            # coordinate's residual is total - own score and the total is
            # patched as it goes (the KeyValueScore `-` of the reference)
            total = torch.zeros(self.dataset.num_rows, device=self.dataset.device)
            for name in seq:
                total = total + scores[name]
            for name in seq:
                coord = self.coordinates[name]
                residual = total - scores[name] if len(seq) > 1 else None
                models[name], tracker = coord.update_model(models[name], residual)
                trackers[name].append(tracker)
                new_score = coord.score(models[name])
                total = residual + new_score if residual is not None else new_score
                scores[name] = new_score

            (objective,) = common.fetch(self._objective_device(total, models))
            objective_history.append(objective)
            self.logger.info("coordinate descent iter %d: objective=%g", it + 1, objective)

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

        final = GameModel({name: models[name] for name in seq}, self.task)
        return CoordinateDescentResult(
            model=final,
            objective_history=objective_history,
            trackers=trackers,
            validation_history=validation_history,
            best_model=best_model if best_model is not None else final,
            best_metric=best_metric,
        )
