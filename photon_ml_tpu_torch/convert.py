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
    p = meta["params"]
    params = TileParams(
        s_hi=p["s_hi"], s_lo=p["s_lo"], chunk=p["chunk"],
        spill_cap=p.get("spill_cap"),
    )
    return tiled_batch_from_arrays(
        list(z_sched), list(g_sched), g_vals_sq, labels, offsets, weights,
        meta=TiledMeta(
            params=params, num_rows=meta["num_rows"], dim=meta["dim"],
            num_real_rows=meta["num_real_rows"], real_dim=meta["real_dim"],
        ),
        device=device,
    )
