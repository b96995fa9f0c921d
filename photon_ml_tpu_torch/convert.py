"""State carried across from the JAX package.

Each function takes the JAX package's state already as numpy arrays (or
plain Python values) and returns the port's objects, so a test or a
migration can run both packages on identical inputs, down to the tile
schedule. The caller does the ``np.asarray`` calls; nothing here knows a
JAX type.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.tiled_sparse import (
    FeatureShardedTiledBatch,
    FeatureShardedTiledMeta,
    TiledMeta,
    TiledSparseBatch,
    TileParams,
    tiled_batch_from_arrays,
)
from photon_ml_tpu_torch.utils.device import DeviceLike, resolve_device


def _tensor(a, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.as_tensor(np.require(a, np.float32, ["C", "W"]), device=device)


def coefficients_from_reference(
    means: np.ndarray, variances: Optional[np.ndarray] = None, *,
    device: DeviceLike = None,
) -> Coefficients:
    dev = resolve_device(device)
    return Coefficients(_tensor(means, dev), _tensor(variances, dev))


def coefficient_bank_from_reference(
    means: np.ndarray, variances: Optional[np.ndarray] = None, *,
    device: DeviceLike = None,
) -> Coefficients:
    """A reference coefficient bank (the batched grid's ``[G, d]`` means,
    and optionally its ``[G, d]`` variances) -> the port's, e.g. as the
    ``initial`` bank of ``run_grid``."""
    if np.ndim(means) != 2 or (
        variances is not None and np.shape(variances) != np.shape(means)
    ):
        raise ValueError("a coefficient bank is [G, d] means (and variances)")
    return coefficients_from_reference(means, variances, device=device)


def normalization_from_reference(
    factor: Optional[np.ndarray] = None, shift: Optional[np.ndarray] = None,
    *, device: DeviceLike = None,
) -> NormalizationContext:
    dev = resolve_device(device)
    return NormalizationContext(_tensor(factor, dev), _tensor(shift, dev))


def tiled_batch_from_reference(
    meta: Mapping,
    z_sched: Sequence[np.ndarray],
    g_sched: Sequence[np.ndarray],
    g_vals_sq: np.ndarray,
    labels: np.ndarray,
    offsets: np.ndarray,
    weights: np.ndarray,
    *,
    device: DeviceLike = None,
) -> TiledSparseBatch:
    """A reference ``TiledSparseBatch`` -> the port's.

    ``meta`` is ``dataclasses.asdict`` of the reference's ``_TiledMeta``
    (``params`` as a dict of its ``TileParams`` fields); ``z_sched`` and
    ``g_sched`` are the nine ``_Schedule`` arrays of each pass in field
    order. Only single-device layouts (``data_shards == 1``) carry over.
    """
    if meta.get("data_shards", 1) != 1:
        raise ValueError("only single-device (data_shards == 1) batches carry over")
    params = _params(meta)
    return tiled_batch_from_arrays(
        list(z_sched), list(g_sched), g_vals_sq, labels, offsets, weights,
        meta=TiledMeta(
            params=params, num_rows=meta["num_rows"], dim=meta["dim"],
            num_real_rows=meta["num_real_rows"], real_dim=meta["real_dim"],
        ),
        device=device,
    )


def _params(meta: Mapping) -> TileParams:
    p = meta["params"]
    return TileParams(
        s_hi=p["s_hi"], s_lo=p["s_lo"], chunk=p["chunk"],
        spill_cap=p.get("spill_cap"),
    )


def feature_sharded_block(w_pad: np.ndarray, block_dim: int, model_index: int) -> np.ndarray:
    """Block ``model_index`` of the reference's padded feature-sharded
    coefficient vector ``[d_pad]`` (or bank ``[G, d_pad]``): its slots
    ``[m * block_dim, (m + 1) * block_dim)``."""
    w_pad = np.asarray(w_pad)
    return w_pad[..., model_index * block_dim:(model_index + 1) * block_dim]


def feature_sharded_vector(blocks: Sequence[np.ndarray]) -> np.ndarray:
    """Each block in model order -> the padded ``[d_pad]`` vector (or
    bank) again."""
    return np.concatenate([np.asarray(b) for b in blocks], axis=-1)


def feature_sharded_cell_from_reference(
    meta: Mapping,
    z_sched: Sequence[np.ndarray],
    g_sched: Sequence[np.ndarray],
    labels: np.ndarray,
    offsets: np.ndarray,
    weights: np.ndarray,
    *,
    data_index: int,
    model_index: int,
    device: DeviceLike = None,
) -> FeatureShardedTiledBatch:
    """Cell (data_index, model_index) of a reference
    ``FeatureShardedTiledBatch`` -> the port's cell for that rank.

    ``meta`` is ``dataclasses.asdict`` of the reference's
    ``_FeatureShardedTiledMeta``; ``z_sched`` / ``g_sched`` the nine
    concatenated ``_Schedule`` arrays of each pass (cells in data-major,
    model-minor order, each padded to one step count, entry-row count and
    spill count, so each array splits evenly); the row arrays span every
    data shard."""
    params = _params(meta)
    R = meta["rows_per_shard"]
    n_cells = meta["data_shards"] * meta["model_shards"]
    cell = data_index * meta["model_shards"] + model_index

    def own(arrays):
        out = []
        for a in arrays:
            a = np.asarray(a)
            k = a.shape[0] // n_cells
            out.append(a[cell * k:(cell + 1) * k])
        return out

    z, g = own(z_sched), own(g_sched)
    rows = slice(data_index * R, (data_index + 1) * R)
    fs_meta = FeatureShardedTiledMeta(
        params, R, meta["block_dim"], meta["num_real_rows"], meta["real_dim"],
        meta["data_shards"], meta["model_shards"],
    )
    tiled = tiled_batch_from_arrays(
        z, g, g[5] ** 2, np.asarray(labels)[rows], np.asarray(offsets)[rows],
        np.asarray(weights)[rows], meta=fs_meta.cell_meta(data_index, model_index),
        device=device,
    )
    return FeatureShardedTiledBatch(fs_meta, tiled, data_index, model_index)


def game_model_from_reference(
    task,
    fixed_effects: Mapping[str, tuple],
    random_effects: Mapping[str, tuple],
    re_datasets: Mapping[str, object],
    *,
    factored: Optional[Mapping[str, tuple]] = None,
    matrix_factorizations: Optional[Mapping[str, tuple]] = None,
    device: DeviceLike = None,
):
    """A JAX ``GameModel`` carried across as numpy -> the port's
    ``GameModel``.

    ``fixed_effects``: {name: (feature shard id, means [d], variances [d]
    or None)}; ``random_effects``: {name: (random-effect type, feature
    shard id, bank [E, D], variances [E, D] or None, projection [E, D],
    entity ids)}; ``re_datasets``: {name: the port's RandomEffectDataset}
    the bank is tied to, whose projection and entity order must be the
    reference's (a mismatch raises: the bank would mean other features).
    ``factored``: {name: (random-effect type, feature shard id, latent bank
    [E, L], projection matrix B [d, L])}, tied to ``re_datasets[name]``
    (the IDENTITY-projected base view); ``matrix_factorizations``: {name:
    (row effect type, column effect type, row factors [R, K], column
    factors [C, K])}."""
    from photon_ml_tpu_torch.game.coordinate import FactoredRandomEffectModel
    from photon_ml_tpu_torch.game.model import (
        FixedEffectModel,
        GameModel,
        MatrixFactorizationModel,
        RandomEffectModel,
    )
    from photon_ml_tpu_torch.models.glm import create_model

    dev = resolve_device(device)
    models = {}
    for name, (shard_id, means, variances) in fixed_effects.items():
        coefs = coefficients_from_reference(means, variances, device=dev)
        models[name] = FixedEffectModel(create_model(task, coefs), shard_id)
    for name, (re_type, shard_id, bank, variances, projection, ids) in random_effects.items():
        red = re_datasets[name]
        if not np.array_equal(red.projection, projection) or red.num_entities != len(ids):
            raise ValueError(f"{name}: the port's dataset does not hold the reference's projection")
        models[name] = RandomEffectModel(
            _tensor(bank, dev), red, re_type, shard_id, _tensor(variances, dev)
        )
    for name, (re_type, shard_id, bank, projection) in (factored or {}).items():
        red = re_datasets[name]
        if np.shape(bank)[0] != red.num_entities or np.shape(projection)[0] != red.local_dim:
            raise ValueError(f"{name}: the port's dataset does not match the factored model")
        models[name] = FactoredRandomEffectModel(
            _tensor(bank, dev), _tensor(projection, dev), red, re_type, shard_id
        )
    for name, (row_type, col_type, rows, cols) in (matrix_factorizations or {}).items():
        models[name] = MatrixFactorizationModel(
            row_type, col_type, _tensor(rows, dev), _tensor(cols, dev)
        )
    return GameModel(models, task)


def serving_bank_from_reference(
    spec: tuple,
    arrays: Mapping[str, object],
    entity_ids: Mapping[str, Sequence[str]],
    shard_widths: Mapping[str, int],
    *,
    index_maps: Optional[Mapping[str, object]] = None,
    generation: int = 1,
    model_id: str = "",
    native_index_threshold: Optional[int] = None,
    device: DeviceLike = None,
):
    """A JAX ``serving.ModelBank`` carried across as numpy -> the port's
    ``ModelBank``, row for row: ``spec`` is the reference's program
    signature (kept as it is), ``arrays`` {coordinate: [d] or [E_pad, d]
    array, or an MF's (rows [E_pad, K], cols [E_pad, K])}, ``entity_ids``
    {id type: the reference row index's ids, in bank row order}.
    ``index_maps`` (the port's, for ``request_from_record``) are
    optional: a replayed trace needs none."""
    from photon_ml_tpu_torch.serving.model_bank import (
        EntityRowIndex,
        ModelBank,
        place_on_device,
    )

    dev = resolve_device(device)
    host = {}
    for entry in spec:
        a = arrays[entry[1]]
        if entry[0] == "mf":
            shapes = ((entry[4], entry[6]), (entry[5], entry[6]))
            host[entry[1]] = tuple(np.require(x, np.float32, ["C", "W"]) for x in a)
        else:
            shapes = ((entry[3],),) if entry[0] == "fe" else ((entry[4], entry[5]),)
            host[entry[1]] = np.require(a, np.float32, ["C", "W"])
        got = tuple(
            np.shape(x) for x in (host[entry[1]] if entry[0] == "mf" else (host[entry[1]],))
        )
        if got != shapes:
            raise ValueError(f"{entry[1]}: arrays {got} do not match the spec's {shapes}")
    return ModelBank(
        generation=generation,
        spec=tuple(spec),
        arrays=place_on_device(host, dev),
        entity_rows={
            t: EntityRowIndex(ids, native_threshold=native_index_threshold)
            for t, ids in entity_ids.items()
        },
        index_maps=dict(index_maps or {}),
        shard_widths={k: int(v) for k, v in shard_widths.items()},
        model_id=model_id,
        device=dev,
    )
