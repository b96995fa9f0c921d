"""Random-effect dataset: per-entity data as bucketed dense blocks (port
of ``photon_ml_tpu/game/random_effect_data.py``: the same numpy build, so
the same ``seed`` gives the same buckets, projections and reservoir draws
bit for bit).

Reference: photon-ml .../data/RandomEffectDataSet.scala (activeData grouped
per entity with reservoir cap + weight rescale at :254-317, passive split
at :328-369), data/LocalDataSet.scala (Pearson feature filter :116-130,
scorer :202+), projector/IndexMapProjector.scala:83-105 (per-entity dense
re-indexing), ProjectionMatrix.scala:90-119 (shared Gaussian random
projection, intercept-preserving), RandomEffectDataSetPartitioner.scala
(entity load balancing).

The shape: the groupByKey shuffle becomes a host-side stable sort;
entities are packed into BUCKETS of equal sample capacity (power-of-two)
so per-entity solves run over [E_b, S_b, k] blocks with weight-0
padding — the "millions of tiny LBFGS solves" run as ONE bank solve per
bucket (``game/random_effect.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.game.config import (
    ProjectorType,
    RandomEffectDataConfiguration,
)
from photon_ml_tpu_torch.game.data import GameDataset, ShardData
from photon_ml_tpu_torch.utils.device import resolve_device


@dataclass
class RandomEffectBucket:
    """Entities with <= capacity active samples, dense-packed."""

    entity_codes: np.ndarray  # int32 [E_b]
    row_index: np.ndarray  # int32 [E_b, S_b] global row id, -1 pad
    indices: np.ndarray  # int32 [E_b, S_b, k] LOCAL feature indices, 0 pad
    values: np.ndarray  # float32 [E_b, S_b, k]
    labels: np.ndarray  # float32 [E_b, S_b]
    offsets: np.ndarray  # float32 [E_b, S_b]
    weights: np.ndarray  # float32 [E_b, S_b] (0 pad; reservoir-rescaled)
    # True when ``indices`` is the tiled arange(k) (k == local_dim, the
    # MF latent view): the dense solvers then use X = values directly,
    # skipping the [E, S, k, D] densify broadcast entirely
    identity_indices: bool = False

    @property
    def num_entities(self) -> int:
        return self.entity_codes.shape[0]

    @property
    def capacity(self) -> int:
        return self.row_index.shape[1]


@dataclass
class RandomEffectDataset:
    """Active data bucketed per entity + row-aligned local projections."""

    config: RandomEffectDataConfiguration
    num_entities: int
    local_dim: int  # D: width of the entity model bank
    # per-entity projection: global feature id per local slot, -1 pad
    projection: np.ndarray  # int32 [E, D]
    # Row-aligned views over the FULL dataset (active + passive + unseen):
    # local feature indices per row (0 pad; unseen features dropped).
    row_local_indices: np.ndarray  # int32 [n, k]
    row_local_values: np.ndarray  # float32 [n, k]
    row_entity_codes: np.ndarray  # int32 [n] (-1 for padding rows)
    buckets: List[RandomEffectBucket]
    num_active_rows: int
    num_passive_rows: int
    # RANDOM projector only: [d_global, D] projection matrix
    random_projection: Optional[np.ndarray] = None
    # where the solves and scores run (the GameDataset's): None is the card
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def intercept_local_index(self) -> Optional[int]:
        return self._intercept_local

    _intercept_local: Optional[int] = None


def build_random_effect_dataset(
    dataset: GameDataset,
    config: RandomEffectDataConfiguration,
    *,
    seed: int = 0,
) -> RandomEffectDataset:
    """GameDataset + config -> bucketed per-entity dataset.

    Mirrors RandomEffectDataSet.buildWithConfiguration: group by entity,
    reservoir-cap active data with weight rescale cnt/cap, passive split,
    optional Pearson filter, per-entity index (or shared random)
    projection.

    The reference does this as a distributed groupByKey shuffle
    (RandomEffectDataSet.scala:169-369); here the whole build is a handful
    of argsort/bincount/flat-scatter passes — no per-row or per-entity
    Python loops; the unique() sort over entity-feature keys dominates.
    """
    shard: ShardData = dataset.shards[config.feature_shard_id]
    codes = np.asarray(dataset.entity_codes[config.random_effect_type])
    eindex = dataset.entity_indexes[config.random_effect_type]
    E = eindex.num_entities
    n = dataset.num_rows
    k = shard.indices.shape[1]
    rng = np.random.default_rng(seed)

    real = np.asarray(dataset.weights) > 0
    valid = real & (codes >= 0)
    labels = np.asarray(dataset.labels)
    offsets = np.asarray(dataset.offsets)
    weights = np.asarray(dataset.weights)

    # --- group rows by entity (the groupByKey analog: one stable sort) ---
    vrows = np.nonzero(valid)[0]
    scodes = codes[vrows]
    order = np.argsort(scodes, kind="stable")
    srows = vrows[order]  # grouped by entity, ascending row id within
    scodes = scodes[order]
    counts = np.bincount(scodes, minlength=E)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])

    # --- reservoir cap with weight rescale cnt/cap -----------------------
    # (RandomEffectDataSet.scala:254-317). Uniform without-replacement
    # sampling per over-cap entity: random priority per row, keep the cap
    # best-ranked priorities within each entity.
    cap = config.active_data_upper_bound
    if cap is not None and len(srows):
        pri = rng.random(len(srows))
        po = np.lexsort((pri, scodes))
        pri_rank = np.empty(len(srows), np.int64)
        pri_rank[po] = np.arange(len(srows)) - starts[scodes[po]]
        keep_active = pri_rank < cap
        scale_e = np.where(counts > cap, counts / max(cap, 1), 1.0)
        num_passive = int(np.maximum(counts - cap, 0).sum())
    else:
        keep_active = np.ones(len(srows), bool)
        scale_e = np.ones(E)
        num_passive = 0
    arows = srows[keep_active]
    acodes = scodes[keep_active]
    acounts = np.bincount(acodes, minlength=E)
    astarts = np.concatenate([[0], np.cumsum(acounts)[:-1]])
    arank = np.arange(len(arows)) - astarts[acodes]
    num_active = int(acounts.sum())

    # --- per-entity feature selection + local projection + row remap -----
    dim = shard.dim
    proj_type = config.projector_type
    random_projection = None
    intercept_local: Optional[int] = None

    if proj_type == ProjectorType.IDENTITY:
        D = max(dim, 1)
        projection = np.full((E, D), -1, np.int32)
        projection[:] = np.arange(D, dtype=np.int32)[None, :]
        if shard.intercept_index is not None:
            intercept_local = shard.intercept_index
        row_local_ix = shard.indices.copy()
        row_local_v = shard.values.copy()
    elif proj_type == ProjectorType.RANDOM:
        D = max(int(config.random_projection_dim), 1)
        # Gaussian N(0, 1/D), intercept column preserved
        # (ProjectionMatrix.scala:90-119).
        random_projection = rng.normal(
            0.0, 1.0 / np.sqrt(D), size=(dim, D)
        ).astype(np.float32)
        if shard.intercept_index is not None:
            random_projection[shard.intercept_index, :] = 0.0
            random_projection[:, D - 1] = np.where(
                np.arange(dim) == shard.intercept_index, 1.0, 0.0
            )
            intercept_local = D - 1
        projection = np.full((E, D), -1, np.int32)
        # dense projected rows: x_local = x . P  [D]
        kk = max(k, D)
        row_local_ix = np.zeros((n, kk), np.int32)
        row_local_v = np.zeros((n, kk), np.float32)
        row_local_ix[:, :D] = np.arange(D, dtype=np.int32)[None, :]
        chunk = max(1, (1 << 22) // max(D, 1))  # bound gather temp memory
        for s in range(0, len(vrows), chunk):
            rs = vrows[s:s + chunk]
            vals = shard.values[rs]  # [c, k]
            proj = random_projection[shard.indices[rs]]  # [c, k, D]
            row_local_v[rs, :D] = np.einsum(
                "ck,ckd->cd", vals, proj, optimize=True
            )
    else:  # INDEX_MAP: per-entity dense re-indexing of active features
        # (IndexMapProjector.scala:83-105). ONE unique(return_inverse) over
        # the live entries of every valid row replaces the per-entity set
        # building AND every later lookup: a per-key "kept" mask (active
        # membership / Pearson top-k / intercept) defines the map, the
        # inverse positions remap every row — no searchsorted anywhere.
        ratio = config.features_to_samples_ratio
        srow_of_entry = np.repeat(np.arange(len(srows)), k)
        slot_of_entry = np.tile(np.arange(k), len(srows))
        ft = shard.indices[srows].ravel().astype(np.int64)
        vv = shard.values[srows].ravel()
        live = vv != 0
        e_srow = srow_of_entry[live]
        e_slot = slot_of_entry[live]
        e_val = vv[live]
        ekeys = scodes[e_srow].astype(np.int64) * dim + ft[live]
        n_live = len(ekeys)
        if shard.intercept_index is not None:
            # intercept key for EVERY entity (always in the map, even for
            # entities with no active rows)
            icept = (
                np.arange(E, dtype=np.int64) * dim + shard.intercept_index
            )
            ekeys = np.concatenate([ekeys, icept])
        uniq, inv = np.unique(ekeys, return_inverse=True)
        inv_live = inv[:n_live]
        U = len(uniq)
        code_u = uniq // dim
        feat_u = uniq % dim
        counts_u = np.bincount(code_u, minlength=E)
        starts_u = np.concatenate([[0], np.cumsum(counts_u)[:-1]])

        entry_active = keep_active[e_srow]
        kept = np.zeros(U, bool)
        if ratio is None:
            if cap is None:
                kept[:] = True
            else:
                # map = features seen in at least one ACTIVE entry
                kept[inv_live[entry_active]] = True
                if shard.intercept_index is not None:
                    kept[inv[n_live:]] = True
        else:
            # Pearson top-k per entity over the ACTIVE entries
            # (LocalDataSet.filterFeaturesByPearsonCorrelationScore:116-130)
            lab_s = labels[srows].astype(np.float64)
            m_safe = np.maximum(acounts, 1)
            ybar = (
                np.bincount(
                    scodes[keep_active], weights=lab_s[keep_active],
                    minlength=E,
                )
                / m_safe
            )
            yc_s = np.where(keep_active, lab_s - ybar[scodes], 0.0)
            y_var = np.bincount(scodes, weights=yc_s**2, minlength=E) / m_safe
            va = np.where(entry_active, e_val.astype(np.float64), 0.0)
            x_sum = np.bincount(inv_live, weights=va, minlength=U)
            x2_sum = np.bincount(inv_live, weights=va * va, minlength=U)
            xy_sum = np.bincount(
                inv_live, weights=va * yc_s[e_srow], minlength=U
            )
            cand = np.zeros(U, bool)
            cand[inv_live[entry_active]] = True
            m = acounts[code_u].astype(np.float64)
            m = np.maximum(m, 1.0)
            x_mean = x_sum / m
            x_var = x2_sum / m - x_mean**2
            denom = np.sqrt(np.maximum(x_var * y_var[code_u], 1e-30))
            corr = np.where(denom > 1e-15, np.abs(xy_sum / m) / denom, 0.0)
            corr = np.where(cand, corr, -np.inf)
            if shard.intercept_index is not None:
                cand[inv[n_live:]] = True
                corr = np.where(feat_u == shard.intercept_index, np.inf, corr)
            num_keep = np.maximum(
                1, np.ceil(ratio * acounts[code_u])
            ).astype(np.int64)
            order_u = np.lexsort((-corr, code_u))
            rank = np.arange(U) - starts_u[code_u[order_u]]
            kept[order_u] = rank < num_keep[order_u]
            kept &= cand

        # local index of each kept key = its rank among kept within entity
        kept_cum = np.cumsum(kept)
        kept_before = np.concatenate([[0], kept_cum])[starts_u]
        local_u = (kept_cum - 1) - kept_before[code_u]  # valid where kept
        local_dims = np.bincount(code_u[kept], minlength=E)
        D = max(int(local_dims.max()) if U else 1, 1)
        projection = np.full((E, D), -1, np.int32)
        if U:
            projection[code_u[kept], local_u[kept]] = feat_u[kept].astype(
                np.int32
            )

        # row remap over the FULL valid table (active + passive rows;
        # filtered-out features drop to 0-slots)
        row_local_ix = np.zeros((n, k), np.int32)
        row_local_v = np.zeros((n, k), np.float32)
        entry_kept = kept[inv_live]
        er = srows[e_srow[entry_kept]]
        es = e_slot[entry_kept]
        row_local_ix[er, es] = local_u[inv_live[entry_kept]].astype(np.int32)
        row_local_v[er, es] = e_val[entry_kept]

    # --- bucketed active data (power-of-two capacities) ------------------
    # one flat scatter per bucket instead of per-entity/per-row fills
    caps_arr = np.zeros(E, np.int64)
    nz_e = acounts > 0
    caps_arr[nz_e] = 1 << np.ceil(
        np.log2(np.maximum(acounts[nz_e], 1))
    ).astype(np.int64)
    buckets: List[RandomEffectBucket] = []
    kk = row_local_ix.shape[1]
    row_scale = scale_e[acodes]  # reservoir weight rescale per active row
    for S in sorted(set(caps_arr[nz_e].tolist())):
        members = np.nonzero(caps_arr == S)[0]
        E_b = len(members)
        in_bucket = caps_arr[acodes] == S
        br = arows[in_bucket]  # global row ids, grouped by entity
        # entity -> dense slot in this bucket
        b_pos = np.searchsorted(members, acodes[in_bucket])
        b_slot = arank[in_bucket]
        b_rows = np.full((E_b, S), -1, np.int32)
        b_ix = np.zeros((E_b, S, kk), np.int32)
        b_v = np.zeros((E_b, S, kk), np.float32)
        b_lab = np.zeros((E_b, S), np.float32)
        b_off = np.zeros((E_b, S), np.float32)
        b_w = np.zeros((E_b, S), np.float32)
        b_rows[b_pos, b_slot] = br.astype(np.int32)
        b_ix[b_pos, b_slot] = row_local_ix[br]
        b_v[b_pos, b_slot] = row_local_v[br]
        b_lab[b_pos, b_slot] = labels[br]
        b_off[b_pos, b_slot] = offsets[br]
        b_w[b_pos, b_slot] = weights[br] * row_scale[in_bucket]
        buckets.append(
            RandomEffectBucket(
                entity_codes=members.astype(np.int32),
                row_index=b_rows,
                indices=b_ix,
                values=b_v,
                labels=b_lab,
                offsets=b_off,
                weights=b_w,
            )
        )

    ds = RandomEffectDataset(
        config=config,
        num_entities=E,
        local_dim=D,
        projection=projection,
        row_local_indices=row_local_ix,
        row_local_values=row_local_v,
        row_entity_codes=np.where(real, codes, -1).astype(np.int32),
        buckets=buckets,
        num_active_rows=num_active,
        num_passive_rows=num_passive,
        random_projection=random_projection,
        device=dataset.device,
    )
    ds._intercept_local = intercept_local
    return ds
