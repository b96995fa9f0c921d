"""GLM model persistence: text + BayesianLinearModelAvro (port of
``photon_ml_tpu/io/model_io.py``; the files are byte-identical to the JAX
package's for the same coefficients).

Reference: photon-ml .../util/IOUtils.scala:206-259 (writeModelsInText:
per-lambda files of ``name TAB term TAB value TAB lambda`` rows sorted by
coefficient value descending) and the BayesianLinearModelAvro conversion
of avro/AvroUtils / ModelProcessingUtils (means/variances as NameTermValue
lists, modelClass = the reference's GLM class names).
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro_codec import (
    EncodedArray,
    encode_long,
    read_container,
    write_container,
)
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel, create_model
from photon_ml_tpu_torch.reliability.artifacts import atomic_writer
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.utils.device import DeviceLike, resolve_device
from photon_ml_tpu_torch.utils.index_map import feature_key, split_feature_key

# The reference's GLM class names (BayesianLinearModelAvro.modelClass)
_MODEL_CLASS_BY_TASK = {
    TaskType.LOGISTIC_REGRESSION:
        "com.linkedin.photon.ml.supervised.classification.LogisticRegressionModel",
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM:
        "com.linkedin.photon.ml.supervised.classification.SmoothedHingeLossLinearSVMModel",
    TaskType.LINEAR_REGRESSION:
        "com.linkedin.photon.ml.supervised.regression.LinearRegressionModel",
    TaskType.POISSON_REGRESSION:
        "com.linkedin.photon.ml.supervised.regression.PoissonRegressionModel",
}
_TASK_BY_MODEL_CLASS = {v: k for k, v in _MODEL_CLASS_BY_TASK.items()}


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def write_models_in_text(
    models: Dict[float, GeneralizedLinearModel], model_dir: str, index_map,
) -> None:
    """One ``<lambda>.txt`` per model; rows sorted by value descending
    (IOUtils.writeModelsInText)."""
    os.makedirs(model_dir, exist_ok=True)
    for lam, model in models.items():
        means = _host(model.means)
        order = np.argsort(-means)
        lines = []
        for i in order:
            key = index_map.get_feature_name(int(i))
            if key is None:
                continue
            name, term = split_feature_key(key)
            lines.append(f"{name}\t{term}\t{means[i]}\t{lam}")
        with atomic_writer(os.path.join(model_dir, f"{lam}.txt")) as f:
            f.write("\n".join(lines) + "\n")


# The last index map's encoded (name, term) prefixes, reused by the next
# model over it (a λ-grid writes every model over one map); the entry
# holds the map, so its id cannot be reused while the entry lives.
_NTV_PREFIXES: Optional[tuple] = None


def _ntv_prefixes(index_map, dim: int) -> Tuple[np.ndarray, List[bytes]]:
    """(the indices below ``dim`` that have a feature key, each one's
    NameTermValue name and term in Avro binary form)."""
    global _NTV_PREFIXES
    hit = _NTV_PREFIXES
    if hit is not None and hit[0] is index_map and hit[1] == dim:
        return hit[2], hit[3]
    idx, prefixes = [], []
    for i in range(dim):
        key = index_map.get_feature_name(i)
        if key is None:
            continue
        name, term = (x.encode("utf-8") for x in split_feature_key(key))
        idx.append(i)
        prefixes.append(encode_long(len(name)) + name + encode_long(len(term)) + term)
    idx = np.asarray(idx, np.int64)
    _NTV_PREFIXES = (index_map, dim, idx, prefixes)
    return idx, prefixes


def _ntv_array(values: np.ndarray, index_map) -> EncodedArray:
    """A NameTermValue array of one value per keyed index, encoded in bulk:
    the bytes the generic encoder writes for the list of records (one
    block of n items, each name, term and little-endian double, then 0)."""
    idx, prefixes = _ntv_prefixes(index_map, len(values))
    if not len(idx):
        return EncodedArray(encode_long(0))
    packed = np.asarray(values, np.float64)[idx].astype("<f8").tobytes()
    doubles = (packed[j:j + 8] for j in range(0, len(packed), 8))
    body = b"".join(itertools.chain.from_iterable(zip(prefixes, doubles)))
    return EncodedArray(encode_long(len(idx)) + body + encode_long(0))


def model_to_bayesian_avro(
    model: GeneralizedLinearModel, model_id: str, index_map,
) -> dict:
    means = _host(model.coefficients.means)
    variances = model.coefficients.variances
    variances = None if variances is None else _host(variances)
    return {
        "modelId": model_id,
        "modelClass": _MODEL_CLASS_BY_TASK[model.task],
        "means": _ntv_array(means, index_map),
        "variances": None if variances is None else _ntv_array(variances, index_map),
        "lossFunction": None,
    }


def bayesian_avro_to_model(
    record: dict,
    index_map,
    *,
    task: Optional[TaskType] = None,
    dim: Optional[int] = None,
    device: DeviceLike = None,
) -> Tuple[str, GeneralizedLinearModel]:
    """-> (modelId, model on ``device``). Unknown feature keys are dropped
    (the reference's behavior when loading with a narrower index map)."""
    d = dim if dim is not None else index_map.size
    dev = resolve_device(device)

    def dense(ntvs) -> torch.Tensor:
        out = np.zeros((d,), np.float32)
        for ntv in ntvs:
            i = index_map.get_index(feature_key(ntv["name"], ntv["term"]))
            if 0 <= i < d:
                out[i] = ntv["value"]
        return torch.as_tensor(out, device=dev)

    means = dense(record["means"])
    variances = dense(record["variances"]) if record.get("variances") else None
    if task is None:
        task = _TASK_BY_MODEL_CLASS.get(record.get("modelClass"), TaskType.LINEAR_REGRESSION)
    return record["modelId"], create_model(task, Coefficients(means, variances))


def save_glm_models_avro(
    models: Dict[float, GeneralizedLinearModel], path: str, index_map,
) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    records = [
        model_to_bayesian_avro(model, str(lam), index_map)
        for lam, model in models.items()
    ]
    write_container(path, schemas.BAYESIAN_LINEAR_MODEL_AVRO, records)


def load_glm_models_avro(
    path: str,
    index_map,
    *,
    task: Optional[TaskType] = None,
    device: DeviceLike = None,
) -> Dict[str, GeneralizedLinearModel]:
    """{modelId: model} from a BayesianLinearModelAvro container, the
    coefficients on ``device`` (default: the CUDA card)."""
    _, it = read_container(path)
    out = {}
    for record in it:
        model_id, model = bayesian_avro_to_model(record, index_map, task=task, device=device)
        out[model_id] = model
    return out
