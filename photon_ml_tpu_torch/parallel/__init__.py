"""Distributed runtime over processes: meshes of ranks, sharded batches and
objectives, the feature-axis fits (port of ``photon_ml_tpu/parallel``).

The names below load their module on first use: importing the package
joins no process group and builds no kernel."""

import importlib

_EXPORTS = {
    "mesh": (
        "DATA_AXIS", "MODEL_AXIS", "data_sharding", "make_mesh", "replicate", "replicated",
        "shard_batch",
    ),
    "multihost": (
        "initialize_multihost", "is_coordinator", "process_count", "process_index",
        "process_shard", "sync_processes",
    ),
    "shuffle": ("ShuffledRows", "entity_all_to_all", "reshard_capacity"),
    "distributed": (
        "FeatureShardedSparseBatch", "data_parallel_fit_lbfgs",
        "data_parallel_value_and_grad", "feature_shard_sparse_batch", "feature_sharded_fit",
        "feature_sharded_sparse_fit", "feature_sharded_sparse_fit_owlqn",
        "feature_sharded_value_and_grad",
    ),
}
_MODULE_OF = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = [name for names in _EXPORTS.values() for name in names]


def __getattr__(name):
    module = _MODULE_OF.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value
