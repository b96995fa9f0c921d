"""GAME model classes (port of ``photon_ml_tpu/game/model.py``).

Reference: photon-ml .../model/GAMEModel.scala:93-95 (Map[coordinateName ->
DatumScoringModel], score = sum of submodel scores), FixedEffectModel.scala
:29-104, RandomEffectModel.scala:126-168 (RDD[(entityId, GLM)] scored via
join), RandomEffectModelInProjectedSpace.scala, MatrixFactorizationModel
.scala:141-178, DatumScoringModel.scala.

Every model scores a GameDataset into a row-aligned [n] tensor on the
dataset's device; the RDD of per-entity models is a dense [E, D] bank; the
MF cogroup is two row gathers and a dot.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from photon_ml_tpu_torch.game.data import GameDataset
from photon_ml_tpu_torch.game.random_effect import score_random_effect
from photon_ml_tpu_torch.game.random_effect_data import RandomEffectDataset
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.task import TaskType

Tensor = torch.Tensor


class DatumScoringModel:
    """score(dataset) -> row-aligned [n] raw scores (no offsets)."""

    def score(self, dataset: GameDataset) -> Tensor:  # pragma: no cover
        raise NotImplementedError


@dataclass
class FixedEffectModel(DatumScoringModel):
    """Global GLM over one feature shard (FixedEffectModel.scala)."""

    model: GeneralizedLinearModel
    feature_shard_id: str

    def score(self, dataset: GameDataset) -> Tensor:
        return self.model.score(dataset.batch_for_shard(self.feature_shard_id))


@dataclass
class RandomEffectModel(DatumScoringModel):
    """Per-entity coefficient bank [E, D] over a local projection
    (RandomEffectModel + RandomEffectModelInProjectedSpace)."""

    bank: Tensor  # [E, D]
    re_dataset: RandomEffectDataset
    random_effect_type: str
    feature_shard_id: str
    # per-entity coefficient variances [E, D] when the problem computes them
    variances: Optional[Tensor] = None

    def score(self, dataset: GameDataset) -> Tensor:
        # the bank's projection is tied to re_dataset; another dataset
        # needs a re-projected view (score_rows)
        return score_random_effect(self.bank, self.re_dataset)

    def score_rows(self, re_view: RandomEffectDataset) -> Tensor:
        return score_random_effect(self.bank, re_view)


@dataclass
class MatrixFactorizationModel(DatumScoringModel):
    """score_i = rowLatent[rowId_i] . colLatent[colId_i]
    (MatrixFactorizationModel.scala:141-178); scoring only here, its
    training waits for the factored random effect's slice."""

    row_effect_type: str
    col_effect_type: str
    row_latent: Tensor  # [R, K]
    col_latent: Tensor  # [C, K]

    @property
    def num_latent_factors(self) -> int:
        return self.row_latent.shape[1]

    def score(self, dataset: GameDataset) -> Tensor:
        dev = self.row_latent.device
        rows = torch.as_tensor(dataset.entity_codes[self.row_effect_type], device=dev).long()
        cols = torch.as_tensor(dataset.entity_codes[self.col_effect_type], device=dev).long()
        r = self.row_latent[rows.clamp_min(0)]
        c = self.col_latent[cols.clamp_min(0)]
        return torch.where((rows >= 0) & (cols >= 0), (r * c).sum(dim=-1), 0.0)


@dataclass
class GameModel:
    """Ordered coordinate name -> submodel; total score = sum
    (GAMEModel.scala:93-95)."""

    models: Dict[str, DatumScoringModel] = field(default_factory=dict)
    task: TaskType = TaskType.LOGISTIC_REGRESSION

    def get_model(self, name: str) -> Optional[DatumScoringModel]:
        return self.models.get(name)

    def update_model(self, name: str, model: DatumScoringModel) -> "GameModel":
        new = dict(self.models)
        new[name] = model
        return GameModel(new, self.task)

    def score(self, dataset: GameDataset) -> Tensor:
        total = torch.zeros(dataset.num_rows, device=dataset.device)
        for m in self.models.values():
            total = total + m.score(dataset)
        return total
