"""GAME coordinates: the fixed effect and the random effect (port of the
single-device parts of ``photon_ml_tpu/game/coordinate.py``).

Reference: photon-ml .../algorithm/Coordinate.scala:82 (score /
initializeModel / updateModel / regTerm over its dataset),
FixedEffectCoordinate.scala:137-164, RandomEffectCoordinate.scala:104-199,
RandomEffectCoordinateInProjectedSpace.scala:30-140.

The KeyValueScore residual currency is a row-aligned [n] tensor on the
dataset's device; every ``updateModel(model, partialScore)`` folds the
residual into the offsets (dataSet.addScoresToOffsets) by passing
``offsets + residual``. The fixed effect solves through its problem's
objective: the scatter objective, or the tiled one (K1 on the card), whose
schedules ``ensure_tiled`` builds once and reuses across sweeps because
every sweep's batch shares the dataset's cached feature tensors.

Not here yet, each raising with its ROADMAP item: the feature-sharded fixed
effect and ``PodRandomEffectCoordinate`` (item 13), the factored random
effect and matrix factorization (item 10, the next GAME slice).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from photon_ml_tpu_torch.data.sampler import down_sample
from photon_ml_tpu_torch.game.data import GameDataset
from photon_ml_tpu_torch.game.model import (
    DatumScoringModel,
    FixedEffectModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.game.random_effect import (
    RandomEffectOptimizationProblem,
    device_row_view,
    score_random_effect,
)
from photon_ml_tpu_torch.game.random_effect_data import RandomEffectDataset
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import create_model
from photon_ml_tpu_torch.optim.common import OptResult
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem

Tensor = torch.Tensor


class Coordinate:
    """One block of the coordinate descent (Coordinate.scala)."""

    name: str

    def initialize_model(self) -> DatumScoringModel:
        raise NotImplementedError

    def update_model(
        self, model: DatumScoringModel, residual: Optional[Tensor]
    ) -> Tuple[DatumScoringModel, object]:
        raise NotImplementedError

    def score(self, model: DatumScoringModel) -> Tensor:
        raise NotImplementedError

    def regularization_term(self, model: DatumScoringModel) -> float:
        return float(self.regularization_term_device(model))

    def regularization_term_device(self, model: DatumScoringModel) -> Tensor:
        """The reg term as a device scalar: the CD loop sums these into its
        one fetch per iteration."""
        raise NotImplementedError

    def prepare(self, model: Optional[DatumScoringModel] = None) -> None:
        """Stage this coordinate's next update (device uploads); idempotent.
        Default: nothing."""


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


@dataclass
class FixedEffectCoordinate(Coordinate):
    """Global GLM block (FixedEffectCoordinate.scala:137-164). ``mesh``
    (the data-parallel and feature-sharded fixed effect) waits for ROADMAP
    item 13. ``sampler_seed`` seeds the down-sampling draw
    (``down_sampling_rate < 1``), one ``torch.Generator`` per update."""

    name: str
    dataset: GameDataset
    problem: GLMOptimizationProblem
    feature_shard_id: str
    reg_weight: float = 0.0
    down_sampling_rate: float = 1.0
    sampler_seed: int = 0
    mesh: Optional[object] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "not ported yet: the fixed effect over a mesh (ROADMAP item 13)"
            )

    def initialize_model(self) -> FixedEffectModel:
        dim = self.dataset.shards[self.feature_shard_id].dim
        zeros = torch.zeros(dim, device=self.dataset.device)
        return FixedEffectModel(
            create_model(self.problem.task, Coefficients(zeros)), self.feature_shard_id
        )

    def _batch(self, residual: Optional[Tensor]):
        offsets = None
        if residual is not None:
            # the residual algebra stays on the device
            offsets = self.dataset.row_tensors()[1] + residual
        return self.dataset.batch_for_shard(self.feature_shard_id, offsets)

    def update_model(self, model, residual=None):
        batch = self._batch(residual)
        initial = model.model.means if model is not None else None
        if self.down_sampling_rate < 1.0:
            coefficients, result = self.problem.run_with_sampling(
                batch, _generator(batch.device, self.sampler_seed),
                self.down_sampling_rate, initial=initial, reg_weight=self.reg_weight,
            )
        else:
            coefficients, result = self.problem.run(
                batch, initial=initial, reg_weight=self.reg_weight
            )
        return (
            FixedEffectModel(self.problem.create_model(coefficients), self.feature_shard_id),
            result,
        )

    def update_model_grid(self, reg_weights):
        """Every grid weight in one solve over a [G, d] bank
        (``problem.run_grid``: K2 when the problem is tiled), cold starts
        per member; the down-sampling draw is λ-independent, so the whole
        grid solves against one sampled batch. -> [(FixedEffectModel,
        OptResult), ...] aligned with ``reg_weights``."""
        batch = self._batch(None)
        if self.down_sampling_rate < 1.0:
            batch = down_sample(
                _generator(batch.device, self.sampler_seed), batch,
                self.down_sampling_rate, self.problem.task,
            )
        variances, result = self.problem.run_grid(batch, [float(w) for w in reg_weights])
        out = []
        for i in range(len(reg_weights)):
            var_i = variances[i] if variances is not None else None
            coefficients = Coefficients(result.coefficients[i], var_i)
            member: OptResult = result.member(i)
            out.append((
                FixedEffectModel(
                    self.problem.create_model(coefficients), self.feature_shard_id
                ),
                member,
            ))
        return out

    def score(self, model: FixedEffectModel) -> Tensor:
        return model.score(self.dataset)

    def regularization_term_device(self, model: FixedEffectModel) -> Tensor:
        l1, l2 = self.problem.regularization.split(self.reg_weight)
        w = model.model.means
        term = 0.5 * l2 * (w * w).sum()
        if l1:
            term = term + l1 * w.abs().sum()
        return term

    def prepare(self, model=None) -> None:
        """Upload the shard's columns ahead of update_model."""
        self.dataset.batch_for_shard(self.feature_shard_id)


@dataclass
class RandomEffectCoordinate(Coordinate):
    """Per-entity block (RandomEffectCoordinate[InProjectedSpace])."""

    name: str
    dataset: GameDataset
    re_dataset: RandomEffectDataset
    problem: RandomEffectOptimizationProblem

    def _zeros(self) -> Tensor:
        return torch.zeros(
            self.re_dataset.num_entities, self.re_dataset.local_dim,
            device=self.re_dataset.device,
        )

    def initialize_model(self) -> RandomEffectModel:
        return RandomEffectModel(
            self._zeros(),
            self.re_dataset,
            self.re_dataset.config.random_effect_type,
            self.re_dataset.config.feature_shard_id,
        )

    def update_model(self, model, residual=None):
        offsets = self.dataset.row_tensors()[1]
        if residual is not None:
            offsets = offsets + residual
        variances = None
        if self.problem.compute_variances:
            bank, tracker, variances = self.problem.update_bank(
                model.bank, self.re_dataset, residual_offsets=offsets,
                with_variances=True, defer_tracker=True,
            )
        else:
            bank, tracker = self.problem.update_bank(
                model.bank, self.re_dataset, residual_offsets=offsets,
                defer_tracker=True,
            )
        return replace(model, bank=bank, variances=variances), tracker

    def score(self, model: RandomEffectModel) -> Tensor:
        return score_random_effect(model.bank, self.re_dataset)

    def regularization_term_device(self, model: RandomEffectModel) -> Tensor:
        return self.problem.regularization_term_device(model.bank)

    def prepare(self, model=None) -> None:
        """Upload the buckets and the row view the score pass reads."""
        self.problem.prepare(model.bank if model is not None else self._zeros(), self.re_dataset)
        device_row_view(self.re_dataset)


def _waits(what: str, item: str):
    class _NotPorted(Coordinate):
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(f"not ported yet: {what} (ROADMAP {item})")

    _NotPorted.__name__ = what
    return _NotPorted


PodRandomEffectCoordinate = _waits("PodRandomEffectCoordinate", "item 13")
FactoredRandomEffectCoordinate = _waits("FactoredRandomEffectCoordinate", "item 10")
MatrixFactorizationCoordinate = _waits("MatrixFactorizationCoordinate", "item 10")
