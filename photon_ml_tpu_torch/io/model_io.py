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
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from photon_ml_tpu_torch.io import native_avro, schemas
from photon_ml_tpu_torch.io.avro_codec import (
    EncodedArray,
    encode_long,
    read_container,
    read_container_schema,
    write_container,
)
from photon_ml_tpu_torch.io.paths import expand_input_paths
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


# A coefficient list as read: (feature keys, name TAB term; float64 values)
Coefficients64 = Tuple[List[str], np.ndarray]


def _coefficient_pairs(ntvs) -> Optional[Coefficients64]:
    """A decoded NameTermValue list as (keys, values); None if null or
    empty."""
    if not ntvs:
        return None
    return ([feature_key(m["name"], m["term"]) for m in ntvs],
            np.asarray([m["value"] for m in ntvs], np.float64))


def _decoded_models(path: str):
    """One BayesianLinearModelAvro container through the native column
    decoder (``native_avro``), or None where the decoder does not build or
    the file's schema is not of that shape."""
    if not native_avro.available():
        return None
    try:
        schema = read_container_schema(path)
        names = [f["name"] for f in schema.get("fields", [])]
        if "modelId" not in names or "means" not in names:
            return None
        plan = native_avro.Plan(schema).compile(
            string_fields=[f for f in ("modelId", "modelClass") if f in names],
            bag_fields=[f for f in ("means", "variances") if f in names],
        )
        return native_avro.decode_columns(path, plan)
    except (native_avro.PlanError, ValueError, OSError):
        return None


def read_model_records(
    paths: Union[str, Sequence[str]],
) -> Iterator[Tuple[str, Optional[str], Coefficients64, Optional[Coefficients64]]]:
    """(modelId, modelClass, means, variances) of every
    BayesianLinearModelAvro record in ``paths`` (files, or directories of
    ``*.avro`` as ``read_avro_records`` expands them). A coefficient list
    is (feature keys, float64 values) in file order; variances are
    None where null or empty. A file goes through the native column
    decoder where it builds, else through the Python codec; both give the
    same keys and the same doubles."""
    for path in expand_input_paths(paths, lambda fn: fn.endswith(".avro")):
        cols = _decoded_models(path)
        if cols is None:
            _, records = read_container(path)
            for r in records:
                yield (r["modelId"], r.get("modelClass"),
                       _coefficient_pairs(r["means"]) or ([], np.zeros(0)),
                       _coefficient_pairs(r.get("variances")))
            continue
        strings = np.asarray(cols.strings + [None], dtype=object)  # id -1: null
        ids = cols.str_ids("modelId")
        classes = (cols.str_ids("modelClass") if "modelClass" in cols.plan.str_slots
                   else np.full(cols.num_records, -1, np.int32))
        bags = {field: cols.bag(field) for field in cols.plan.bag_slots}
        n = cols.num_records
        cols.close()

        def pair(field, i):
            if field not in bags:
                return None
            row_ptr, key_ids, values = bags[field]
            a, b = int(row_ptr[i]), int(row_ptr[i + 1])
            return (strings[key_ids[a:b]].tolist(), values[a:b]) if b > a else None

        for i in range(n):
            yield (strings[ids[i]], strings[classes[i]],
                   pair("means", i) or ([], np.zeros(0)), pair("variances", i))


def _dense(coefficients: Coefficients64, index_map, d: int, dev) -> torch.Tensor:
    """A ``[d]`` float32 vector of the coefficients at their indices in
    ``index_map``; keys it lacks or past ``d`` are dropped, and a repeated
    key keeps its last value (a file-order loop's result)."""
    keys, values = coefficients
    out = np.zeros((d,), np.float32)
    if keys:
        many = getattr(index_map, "get_indices", None)
        idx = (np.asarray(many(keys), np.int64) if many is not None
               else np.asarray([index_map.get_index(k) for k in keys], np.int64))
        keep = (idx >= 0) & (idx < d)
        idx, values = idx[keep][::-1], values[keep][::-1]
        idx, first = np.unique(idx, return_index=True)
        out[idx] = values[first]
    return torch.as_tensor(out, device=dev)


def _model_of(model_class, means, variances, index_map, task, dim, device):
    d = dim if dim is not None else index_map.size
    dev = resolve_device(device)
    if task is None:
        task = _TASK_BY_MODEL_CLASS.get(model_class, TaskType.LINEAR_REGRESSION)
    variances = None if variances is None else _dense(variances, index_map, d, dev)
    return create_model(
        task, Coefficients(_dense(means, index_map, d, dev), variances))


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
    means = _coefficient_pairs(record["means"]) or ([], np.zeros(0))
    model = _model_of(record.get("modelClass"), means,
                      _coefficient_pairs(record.get("variances")), index_map, task,
                      dim, device)
    return record["modelId"], model


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
    return {
        model_id: _model_of(model_class, means, variances, index_map, task, None, device)
        for model_id, model_class, means, variances in read_model_records(path)
    }
