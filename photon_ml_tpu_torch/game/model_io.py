"""GAME model persistence with reference directory-layout parity.

Reference: photon-ml .../avro/model/ModelProcessingUtils.scala:44-189 and
avro/Constants.scala:22-25 —

    <dir>/fixed-effect/<coordinate>/id-info            (feature shard id)
    <dir>/fixed-effect/<coordinate>/coefficients/part-00000.avro
    <dir>/random-effect/<coordinate>/id-info           (reType, shardId)
    <dir>/random-effect/<coordinate>/coefficients/part-00000.avro
    <dir>/matrix-factorization/<coordinate>/{row,col}-latent/part-00000.avro
    <dir>/model-spec                                   (human-readable)

Fixed-effect coefficients: ONE BayesianLinearModelAvro (modelId
"fixed-effect"); random-effect: one record PER ENTITY (modelId = raw
entity id); MF latent factors as LatentFactorAvro. Files written by the
reference load here and vice versa (same schemas + layout).

Port of ``photon_ml_tpu/game/model_io.py`` over the port's Avro codec
(byte-identical to the JAX package's): for the same model the two packages
write the same bytes. A factored random effect is written as a plain
random-effect model in the original space (``bank_latent @ B^T`` per
entity), so the scoring driver reads it as one.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.game.coordinate import FactoredRandomEffectModel
from photon_ml_tpu_torch.data.batch import fe_row_scores, mf_row_scores, re_row_scores
from photon_ml_tpu_torch.game.data import GameDataset
from photon_ml_tpu_torch.game.model import (
    FixedEffectModel,
    GameModel,
    MatrixFactorizationModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro_codec import read_avro_records, write_container
from photon_ml_tpu_torch.io.model_io import model_to_bayesian_avro, read_model_records
from photon_ml_tpu_torch.reliability.artifacts import atomic_writer
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.utils.index_map import split_feature_key

FIXED_EFFECT = "fixed-effect"
RANDOM_EFFECT = "random-effect"
MATRIX_FACTORIZATION = "matrix-factorization"
ID_INFO = "id-info"
COEFFICIENTS = "coefficients"


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _write_lines(path: str, lines: List[str]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with atomic_writer(path) as f:
        f.write("\n".join(lines) + "\n")


def _write_parts(base: str, schema, records, num_files: int) -> None:
    """Split records across ``num_files`` container part files
    (numberOfOutputFilesForRandomEffectModel,
    avro/model/ModelProcessingUtils.scala save path; <=0 means one
    file). The loader reads the whole directory, so the split is
    transparent on read."""
    n = max(1, num_files)
    chunks = [records[i::n] for i in range(n)] if n > 1 else [records]
    for i, chunk in enumerate(chunks):
        write_container(
            os.path.join(base, f"part-{i:05d}.avro"), schema, chunk
        )


def save_loaded_game_model(loaded: "LoadedGameModel", out_dir: str) -> str:
    """Write a host-side :class:`LoadedGameModel` back out in the
    reference directory layout — the dataset-free publication path
    (synthetic fleets, republication of a loaded artifact, bench/chaos
    fixtures). Round-trips bitwise through :func:`load_game_model`:
    coefficients are plain named floats both ways."""
    os.makedirs(out_dir, exist_ok=True)

    def _means_record(model_id, means: Dict[str, float]) -> Dict:
        out = []
        for key, v in means.items():
            nm, term = split_feature_key(key)
            out.append({"name": nm, "term": term, "value": float(v)})
        return {
            "modelId": model_id,
            "modelClass": None,
            "means": out,
            "variances": None,
            "lossFunction": None,
        }

    for name, (shard_id, means) in loaded.fixed_effects.items():
        base = os.path.join(out_dir, FIXED_EFFECT, name)
        _write_lines(os.path.join(base, ID_INFO), [shard_id])
        write_container(
            os.path.join(base, COEFFICIENTS, "part-00000.avro"),
            schemas.BAYESIAN_LINEAR_MODEL_AVRO,
            [_means_record(name, means)],
        )
    for name, (re_type, shard_id, per_entity) in (
        loaded.random_effects.items()
    ):
        base = os.path.join(out_dir, RANDOM_EFFECT, name)
        _write_lines(os.path.join(base, ID_INFO), [re_type, shard_id])
        _write_parts(
            os.path.join(base, COEFFICIENTS),
            schemas.BAYESIAN_LINEAR_MODEL_AVRO,
            [
                _means_record(eid, means)
                for eid, means in sorted(per_entity.items())
            ],
            1,
        )
    for name, (row_t, col_t, rows, cols) in (
        loaded.matrix_factorizations.items()
    ):
        base = os.path.join(out_dir, MATRIX_FACTORIZATION, name)
        _write_lines(os.path.join(base, ID_INFO), [row_t, col_t])
        for sub, latent in (("row-latent", rows), ("col-latent", cols)):
            write_container(
                os.path.join(base, sub, "part-00000.avro"),
                schemas.LATENT_FACTOR_AVRO,
                [
                    {
                        "effectId": eid,
                        "latentFactor": [float(x) for x in vec],
                    }
                    for eid, vec in sorted(latent.items())
                ],
            )
    return out_dir


def save_game_model(
    model: GameModel,
    dataset: GameDataset,
    out_dir: str,
    *,
    model_spec: Optional[str] = None,
    num_re_output_files: int = 1,
) -> None:
    os.makedirs(out_dir, exist_ok=True)
    if model_spec:
        with atomic_writer(os.path.join(out_dir, "model-spec")) as f:
            f.write(model_spec)
    for name, sub in model.models.items():
        if isinstance(sub, FixedEffectModel):
            base = os.path.join(out_dir, FIXED_EFFECT, name)
            _write_lines(os.path.join(base, ID_INFO), [sub.feature_shard_id])
            imap = dataset.shards[sub.feature_shard_id].index_map
            rec = model_to_bayesian_avro(sub.model, FIXED_EFFECT, imap)
            write_container(
                os.path.join(base, COEFFICIENTS, "part-00000.avro"),
                schemas.BAYESIAN_LINEAR_MODEL_AVRO,
                [rec],
            )
        elif isinstance(sub, RandomEffectModel):
            base = os.path.join(out_dir, RANDOM_EFFECT, name)
            _write_lines(
                os.path.join(base, ID_INFO),
                [sub.random_effect_type, sub.feature_shard_id],
            )
            imap = dataset.shards[sub.feature_shard_id].index_map
            eindex = dataset.entity_indexes[sub.random_effect_type]
            bank = _host(sub.bank)
            bank_vars = (
                _host(sub.variances) if sub.variances is not None else None
            )
            projection = sub.re_dataset.projection
            records = []
            for e in range(sub.re_dataset.num_entities):
                means = []
                variances = [] if bank_vars is not None else None
                for local, g in enumerate(projection[e]):
                    if g < 0:
                        continue
                    v = float(bank[e, local])
                    if v == 0.0:
                        continue
                    key = imap.get_feature_name(int(g))
                    if key is None:
                        continue
                    nm, term = split_feature_key(key)
                    means.append({"name": nm, "term": term, "value": v})
                    if variances is not None:
                        variances.append({
                            "name": nm,
                            "term": term,
                            "value": float(bank_vars[e, local]),
                        })
                records.append({
                    "modelId": eindex.ids[e],
                    "modelClass": None,
                    "means": means,
                    "variances": variances,
                    "lossFunction": None,
                })
            _write_parts(
                os.path.join(base, COEFFICIENTS),
                schemas.BAYESIAN_LINEAR_MODEL_AVRO,
                records,
                num_re_output_files,
            )
        elif isinstance(sub, MatrixFactorizationModel):
            base = os.path.join(out_dir, MATRIX_FACTORIZATION, name)
            _write_lines(
                os.path.join(base, ID_INFO),
                [sub.row_effect_type, sub.col_effect_type],
            )
            for side, latent, id_type in (
                ("row-latent", sub.row_latent, sub.row_effect_type),
                ("col-latent", sub.col_latent, sub.col_effect_type),
            ):
                eindex = dataset.entity_indexes[id_type]
                arr = _host(latent)
                records = [
                    {
                        "effectId": eindex.ids[e],
                        "latentFactor": [float(x) for x in arr[e]],
                    }
                    for e in range(arr.shape[0])
                ]
                write_container(
                    os.path.join(base, side, "part-00000.avro"),
                    schemas.LATENT_FACTOR_AVRO,
                    records,
                )
        elif isinstance(sub, FactoredRandomEffectModel):
            # a plain random-effect model in the original space:
            # bank_global = bank_latent @ projection^T per entity
            base = os.path.join(out_dir, RANDOM_EFFECT, name)
            _write_lines(
                os.path.join(base, ID_INFO),
                [sub.random_effect_type, sub.feature_shard_id],
            )
            imap = dataset.shards[sub.feature_shard_id].index_map
            eindex = dataset.entity_indexes[sub.random_effect_type]
            bank_g = _host(sub.bank @ sub.projection.T)  # [E, d_local]
            projection = sub.re_dataset.projection
            records = []
            for e in range(bank_g.shape[0]):
                means = []
                for local, g in enumerate(projection[e]):
                    if g < 0 or local >= bank_g.shape[1]:
                        continue
                    v = float(bank_g[e, local])
                    if v == 0.0:
                        continue
                    key = imap.get_feature_name(int(g))
                    if key is None:
                        continue
                    nm, term = split_feature_key(key)
                    means.append({"name": nm, "term": term, "value": v})
                records.append({
                    "modelId": eindex.ids[e], "modelClass": None,
                    "means": means, "variances": None, "lossFunction": None,
                })
            write_container(
                os.path.join(base, COEFFICIENTS, "part-00000.avro"),
                schemas.BAYESIAN_LINEAR_MODEL_AVRO,
                records,
            )
        else:
            raise ValueError(f"cannot save model type {type(sub)} for {name}")


class LoadedGameModel:
    """Host-side loaded GAME model, scorable against any GameDataset built
    with compatible shard index maps (loadGameModelFromHDFS analog)."""

    def __init__(self):
        self.fixed_effects: Dict[str, Tuple[str, "np.ndarray"]] = {}
        self.random_effects: Dict[str, Tuple[str, str, Dict[str, Dict[str, float]]]] = {}
        self.matrix_factorizations: Dict[str, Tuple[str, str, Dict[str, np.ndarray], Dict[str, np.ndarray]]] = {}
        # {coordinate: {entity id: {feature key: variance}}} for models
        # saved with per-entity variances (scoring ignores them; they load
        # for inspection/round-trip parity)
        self.random_effect_variances: Dict[str, Dict[str, Dict[str, float]]] = {}

    def coordinate_names(self) -> List[str]:
        return (
            list(self.fixed_effects)
            + list(self.random_effects)
            + list(self.matrix_factorizations)
        )

    def score(self, dataset: GameDataset, task: TaskType) -> torch.Tensor:
        """Row-aligned raw scores [n] on the dataset's device. Each row's
        terms sum in ``data.batch.row_sum``'s fixed order, the serving
        programs' too, so a served row is bitwise its batch score."""
        dev = dataset.device
        total = torch.zeros(dataset.num_rows, device=dev)
        fe_cache = self.__dict__.setdefault("_fe_weight_cache", {})
        for name, (shard_id, means) in self.fixed_effects.items():
            imap = dataset.shards[shard_id].index_map
            # the fixed-effect weight vector depends only on (model,
            # index map): chunked scoring calls score() once per chunk
            # with the SAME prebuilt maps — don't rebuild the whole
            # coefficient dict each time
            hit = fe_cache.get(name)
            if hit is None or hit[0] is not imap:
                w = np.zeros((imap.size,), np.float32)
                for key, v in means.items():
                    i = imap.get_index(key)
                    if i >= 0:
                        w[i] = v
                hit = (imap, torch.as_tensor(w, device=dev))
                fe_cache[name] = hit
            batch = dataset.batch_for_shard(shard_id)
            total = total + fe_row_scores(hit[1], batch.indices, batch.values)
        re_cache = self.__dict__.setdefault("_re_bank_cache", {})
        for name, (re_type, shard_id, per_entity) in self.random_effects.items():
            imap = dataset.shards[shard_id].index_map
            eindex = dataset.entity_indexes[re_type]
            # chunks sliced from one file share eindex/imap: build the
            # bank once per (entity index, index map), like the FE cache
            hit = re_cache.get(name)
            if hit is None or hit[0] is not eindex or hit[1] is not imap:
                bank = np.zeros((eindex.num_entities, imap.size), np.float32)
                # iterate the DATASET's entities (small per scoring
                # chunk) and look up the model dict — not the model's
                # full entity set per call
                for code, raw_id in enumerate(eindex.ids):
                    means = per_entity.get(raw_id)
                    if not means:
                        continue  # entity has no model (scores 0)
                    for key, v in means.items():
                        i = imap.get_index(key)
                        if i >= 0:
                            bank[code, i] = v
                hit = (eindex, imap, torch.as_tensor(bank, device=dev))
                re_cache[name] = hit
            bank = hit[2]
            codes = torch.as_tensor(dataset.entity_codes[re_type], device=dev)
            batch = dataset.batch_for_shard(shard_id)
            # bank[codes[:, None], indices]: the [n, k] gather, not [n, D] rows
            total = total + re_row_scores(bank, codes, batch.indices, batch.values)
        mf_cache = self.__dict__.setdefault("_mf_latent_cache", {})
        for name, (row_t, col_t, rows, cols) in self.matrix_factorizations.items():
            r_index = dataset.entity_indexes[row_t]
            c_index = dataset.entity_indexes[col_t]
            hit = mf_cache.get(name)
            if hit is None or hit[0] is not r_index or hit[1] is not c_index:
                K = len(next(iter(rows.values())))
                R = np.zeros((r_index.num_entities, K), np.float32)
                C = np.zeros((c_index.num_entities, K), np.float32)
                for code, rid in enumerate(r_index.ids):
                    vec = rows.get(rid)
                    if vec is not None:
                        R[code] = vec
                for code, cid in enumerate(c_index.ids):
                    vec = cols.get(cid)
                    if vec is not None:
                        C[code] = vec
                hit = (
                    r_index, c_index, torch.as_tensor(R, device=dev),
                    torch.as_tensor(C, device=dev),
                )
                mf_cache[name] = hit
            total = total + mf_row_scores(
                hit[2], hit[3],
                torch.as_tensor(dataset.entity_codes[row_t], device=dev),
                torch.as_tensor(dataset.entity_codes[col_t], device=dev),
            )
        return total


def load_game_model(model_dir: str) -> LoadedGameModel:
    out = LoadedGameModel()
    fe_dir = os.path.join(model_dir, FIXED_EFFECT)
    if os.path.isdir(fe_dir):
        for name in sorted(os.listdir(fe_dir)):
            base = os.path.join(fe_dir, name)
            with open(os.path.join(base, ID_INFO)) as f:
                shard_id = f.read().split()[0]
            recs = list(read_model_records(os.path.join(base, COEFFICIENTS)))
            keys, values = recs[0][2]
            out.fixed_effects[name] = (shard_id, dict(zip(keys, values.tolist())))
    re_dir = os.path.join(model_dir, RANDOM_EFFECT)
    if os.path.isdir(re_dir):
        for name in sorted(os.listdir(re_dir)):
            base = os.path.join(re_dir, name)
            with open(os.path.join(base, ID_INFO)) as f:
                parts = f.read().split()
            re_type, shard_id = parts[0], parts[1] if len(parts) > 1 else parts[0]
            per_entity: Dict[str, Dict[str, float]] = {}
            coef_dir = os.path.join(base, COEFFICIENTS)
            # A random-effect coordinate with no part files loads as an
            # empty per-entity map (every entity scores 0 through this
            # coordinate) — the reference's own GameIntegTest/gameModel
            # fixture ships exactly this shape (id-info only).
            recs = read_model_records(coef_dir) if os.path.isdir(coef_dir) else ()
            per_entity_vars: Dict[str, Dict[str, float]] = {}
            for model_id, _, (keys, values), variances in recs:
                per_entity[model_id] = dict(zip(keys, values.tolist()))
                if variances is not None:
                    keys, values = variances
                    per_entity_vars[model_id] = dict(zip(keys, values.tolist()))
            out.random_effects[name] = (re_type, shard_id, per_entity)
            if per_entity_vars:
                out.random_effect_variances[name] = per_entity_vars
    mf_dir = os.path.join(model_dir, MATRIX_FACTORIZATION)
    if os.path.isdir(mf_dir):
        for name in sorted(os.listdir(mf_dir)):
            base = os.path.join(mf_dir, name)
            with open(os.path.join(base, ID_INFO)) as f:
                row_t, col_t = f.read().split()[:2]
            rows = {
                r["effectId"]: np.asarray(r["latentFactor"], np.float32)
                for r in read_avro_records(os.path.join(base, "row-latent"))
            }
            cols = {
                r["effectId"]: np.asarray(r["latentFactor"], np.float32)
                for r in read_avro_records(os.path.join(base, "col-latent"))
            }
            out.matrix_factorizations[name] = (row_t, col_t, rows, cols)
    return out
