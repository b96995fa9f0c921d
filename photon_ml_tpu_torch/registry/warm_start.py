"""Drift-safe warm starts: align a parent generation's coefficients to
a retrain's (possibly drifted) feature/entity space (port of
``photon_ml_tpu/registry/warm_start.py``; the alignment is numpy on the
host, bitwise the reference's, and only the built model holds torch
tensors).

An hourly retrain's vocabulary is ALMOST the parent's: a few new terms
appear (no coefficient yet), a few die (their coefficients must not
leak into other slots), entities churn. The alignment rules, each
explicit and accounted in a :class:`DriftReport`:

- **kept** terms copy their parent value into the new index — by KEY,
  never by position (indices reshuffle whenever the sorted vocabulary
  changes).
- **new** terms initialize to exactly 0.0 (the optimizer's own prior).
- **dropped** terms are discarded, counted — silently losing half a
  model to a bad index map must be visible in the report.
- **churned entities** (random effects): a new entity with no parent
  rows starts from the PRIOR MEAN — the column-mean of the parent bank
  over entities that carried the term — rather than zero, which is the
  empirical-Bayes shrinkage center the reference's random-effect prior
  encodes (SURVEY §4: per-entity models shrink toward the population).

**No-drift bitwise pin:** when the vocabulary (and entity set) are
unchanged, the aligned vector/bank is BITWISE the parent's stored
coefficients — alignment is a permutation-by-key, float values pass
through untouched. The tests pin this; it is what makes "warm-start
from the parent" a no-op rather than a perturbation when nothing
changed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional

import numpy as np

__all__ = [
    "DriftReport",
    "align_coefficients",
    "align_re_bank",
    "warm_start_game_model",
]


@dataclass
class DriftReport:
    """Accounting of one alignment: what the drift actually was."""

    kept: int = 0
    new_zero_init: int = 0
    dropped: int = 0
    kept_entities: int = 0
    churned_entities_prior_init: int = 0
    dropped_entities: int = 0
    dropped_keys_sample: List[str] = field(default_factory=list)

    _SAMPLE = 16

    def note_dropped(self, key: str) -> None:
        self.dropped += 1
        if len(self.dropped_keys_sample) < self._SAMPLE:
            self.dropped_keys_sample.append(key)

    @property
    def no_drift(self) -> bool:
        return (
            self.new_zero_init == 0
            and self.dropped == 0
            and self.churned_entities_prior_init == 0
            and self.dropped_entities == 0
        )

    def as_dict(self) -> Dict[str, object]:
        return {
            "kept": self.kept,
            "new_zero_init": self.new_zero_init,
            "dropped": self.dropped,
            "kept_entities": self.kept_entities,
            "churned_entities_prior_init": (
                self.churned_entities_prior_init
            ),
            "dropped_entities": self.dropped_entities,
            "no_drift": self.no_drift,
            "dropped_keys_sample": list(self.dropped_keys_sample),
        }

    def merge(self, other: "DriftReport") -> "DriftReport":
        self.kept += other.kept
        self.new_zero_init += other.new_zero_init
        self.dropped += other.dropped
        self.kept_entities += other.kept_entities
        self.churned_entities_prior_init += (
            other.churned_entities_prior_init
        )
        self.dropped_entities += other.dropped_entities
        for k in other.dropped_keys_sample:
            if len(self.dropped_keys_sample) < self._SAMPLE:
                self.dropped_keys_sample.append(k)
        return self


def align_coefficients(
    parent_means: Mapping[str, float],
    index_map,
    *,
    report: Optional[DriftReport] = None,
) -> np.ndarray:
    """Parent {feature key: value} -> float32 vector in the NEW index
    space. Keys absent from the new map drop (counted); new-map indices
    with no parent key zero-init (counted)."""
    report = report if report is not None else DriftReport()
    out = np.zeros((index_map.size,), np.float32)
    hit = np.zeros((index_map.size,), bool)
    for key, value in parent_means.items():
        i = index_map.get_index(key)
        if i < 0:
            report.note_dropped(key)
            continue
        out[i] = np.float32(value)
        hit[i] = True
        report.kept += 1
    report.new_zero_init += int((~hit).sum())
    return out


def align_re_bank(
    parent_per_entity: Mapping[str, Mapping[str, float]],
    entity_ids,
    projection: np.ndarray,
    index_map,
    *,
    report: Optional[DriftReport] = None,
) -> np.ndarray:
    """Parent per-entity coefficient dicts -> a [E, D] bank in the new
    random-effect dataset's LOCAL projection space.

    ``entity_ids``: the new dataset's entity order; ``projection``
    [E, D] maps local slot -> global feature id (-1 pad); ``index_map``
    is the shard's global map (key <-> global id).

    Entities present in the parent copy by key through the projection;
    churned (new) entities get the prior mean: for each feature KEY the
    mean of the parent entities' values for it (missing treated as 0 —
    the shrinkage center), counted per entity in the report. Parent
    entities absent from the new dataset drop, counted.
    """
    report = report if report is not None else DriftReport()
    E, D = projection.shape
    bank = np.zeros((E, D), np.float32)
    new_ids = list(entity_ids)
    new_set = set(new_ids)
    report.dropped_entities += sum(
        1 for e in parent_per_entity if e not in new_set
    )
    # prior mean per feature key over the parent population (float32
    # accumulation matches the bank dtype; missing-as-zero denominator
    # is the FULL parent entity count — the shrinkage-to-population
    # convention)
    prior: Dict[str, np.float32] = {}
    n_parent = len(parent_per_entity)
    if n_parent:
        sums: Dict[str, float] = {}
        for means in parent_per_entity.values():
            for key, v in means.items():
                sums[key] = sums.get(key, 0.0) + float(v)
        prior = {
            key: np.float32(total / n_parent)
            for key, total in sums.items()
        }
    # key per (entity slot): resolve via the index map's reverse lookup
    for e, raw_id in enumerate(new_ids):
        means = parent_per_entity.get(raw_id)
        churned = means is None
        source = prior if churned else means
        if churned:
            if n_parent:
                report.churned_entities_prior_init += 1
        else:
            report.kept_entities += 1
        if not source:
            continue
        for local in range(D):
            g = int(projection[e, local])
            if g < 0:
                continue
            key = index_map.get_feature_name(g)
            if key is None:
                continue
            v = source.get(key)
            if v is not None:
                bank[e, local] = np.float32(v)
                if not churned:
                    report.kept += 1
        if not churned:
            # terms the parent entity carried that the new projection
            # has no slot for are dropped coefficients
            slots = {
                index_map.get_feature_name(int(g))
                for g in projection[e]
                if int(g) >= 0
            }
            for key in means:
                if key not in slots:
                    report.note_dropped(key)
    return bank


def warm_start_game_model(
    loaded,
    dataset,
    re_datasets: Mapping[str, object],
    task,
    *,
    coordinate_names=None,
):
    """Build the initial :class:`GameModel` for a GAME retrain from a
    parent generation's loaded artifact (``game.model_io
    .LoadedGameModel``), aligned to the NEW dataset's feature/entity
    spaces, with its tensors on the dataset's device. Coordinates the
    parent does not carry fall back to the coordinate's own
    ``initialize_model`` (by being absent here — CoordinateDescent.run
    treats missing names exactly so). Returns
    ``(GameModel, {coordinate: DriftReport})``.
    """
    import torch

    from photon_ml_tpu_torch.game.model import (
        FixedEffectModel,
        GameModel,
        RandomEffectModel,
    )
    from photon_ml_tpu_torch.models.coefficients import Coefficients
    from photon_ml_tpu_torch.models.glm import create_model

    dev = dataset.device
    reports: Dict[str, DriftReport] = {}
    models = {}
    wanted = set(coordinate_names) if coordinate_names is not None else None
    for name, (shard_id, means) in loaded.fixed_effects.items():
        if wanted is not None and name not in wanted:
            continue
        if shard_id not in dataset.shards:
            continue
        report = DriftReport()
        vec = align_coefficients(
            means, dataset.shards[shard_id].index_map, report=report
        )
        models[name] = FixedEffectModel(
            model=create_model(
                task, Coefficients(torch.as_tensor(vec, device=dev))
            ),
            feature_shard_id=shard_id,
        )
        reports[name] = report
    for name, (re_type, shard_id, per_entity) in (
        loaded.random_effects.items()
    ):
        if wanted is not None and name not in wanted:
            continue
        red = re_datasets.get(name)
        if red is None or shard_id not in dataset.shards:
            continue
        report = DriftReport()
        bank = align_re_bank(
            per_entity,
            dataset.entity_indexes[re_type].ids,
            np.asarray(red.projection),
            dataset.shards[shard_id].index_map,
            report=report,
        )
        models[name] = RandomEffectModel(
            bank=torch.as_tensor(bank, device=dev),
            re_dataset=red,
            random_effect_type=re_type,
            feature_shard_id=shard_id,
        )
        reports[name] = report
    return GameModel(models, task), reports
