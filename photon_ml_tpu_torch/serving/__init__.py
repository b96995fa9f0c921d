"""Online scoring service: the low-latency request path over
device-resident GAME model banks (port of ``photon_ml_tpu/serving``).

Nine pieces, composed by ``cli/serving_driver.py``:

- :mod:`photon_ml_tpu_torch.serving.model_bank` — fixed/random-effect
  coefficients as padded device tensors + O(1) host entity->row index;
- :mod:`photon_ml_tpu_torch.serving.programs` — the fixed-shape program
  ladder (a CUDA graph per batch shape on the card, captured before it
  can reach the hot path);
- :mod:`photon_ml_tpu_torch.serving.admission` — deadlines, the
  load-shed predictor, and the named terminal outcomes every request
  resolves to;
- :mod:`photon_ml_tpu_torch.serving.batcher` — micro-batching dispatch
  loop, exactly one counted readback per dispatched batch, deadline
  drops before dispatch, FE-only graceful degradation, bounded drain;
- :mod:`photon_ml_tpu_torch.serving.frontend` — the TCP JSON-lines
  accept loop (bounded reads, per-connection writers,
  readiness/liveness, SIGTERM drain), also speaking photon-wire
  (:mod:`photon_ml_tpu_torch.serving.wire`);
- :mod:`photon_ml_tpu_torch.serving.swap` — hot swap of model
  generations (in place when the signature is unchanged) with
  quarantine + rollback on poisoned artifacts;
- :mod:`photon_ml_tpu_torch.serving.metrics` — p50/p99 latency, QPS,
  occupancy, shed/deadline/degraded/drain accounting for metrics.json;
- :mod:`photon_ml_tpu_torch.serving.shard_server` — the same stack
  serving ONE entity shard in partial-score mode, plus the router's
  control plane (topology discovery, two-step generation flip);
- :mod:`photon_ml_tpu_torch.serving.routing` — the scatter/gather tier
  in front of a shard-server fleet: ownership-ruled fan-out, bitwise
  f32 recomposition, per-shard degradation, the hot-entity cache. The
  router is host-only numpy: it touches no tensor and creates no CUDA
  context.

The names below load their module on first use, so that importing one
host-only module of the package (``wire``, ``routing``) does not import
torch.
"""


import importlib

_EXPORTS = {
    "admission": (
        "AdmissionController", "BatcherClosed", "DeadlineExceeded", "DrainTimeout",
        "NoShardAvailable", "PartialScore", "RequestShed", "ScoreOutcome", "ServingError",
    ),
    "batcher": (
        "DrainReport", "MicroBatcher", "ScoreRequest", "request_from_record",
        "requests_from_dataset",
    ),
    "frontend": ("ServingFrontend",),
    "metrics": ("ServingMetrics",),
    "model_bank": (
        "DEFAULT_ENTITY_PAD", "EntityRowIndex", "ModelBank", "bank_from_arrays",
        "build_model_bank",
    ),
    "programs": ("DEFAULT_LADDER", "RequestBatch", "ServingPrograms", "select_shape"),
    "routing": (
        "HotEntityCache", "RoutedScore", "RouterMetrics", "RoutingPolicy", "ShardHealth",
        "ShardRouter", "TcpShardTransport",
    ),
    "shard_server": ("ShardServer", "make_shard_ops", "shard_topology"),
    "swap": ("ServingModel", "SwapResult", "load_model_artifact"),
}
_MODULE_OF = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    module = _MODULE_OF.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value
