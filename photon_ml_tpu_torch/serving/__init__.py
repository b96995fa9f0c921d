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
"""

from photon_ml_tpu_torch.serving.admission import (  # noqa: F401
    AdmissionController,
    BatcherClosed,
    DeadlineExceeded,
    DrainTimeout,
    NoShardAvailable,
    PartialScore,
    RequestShed,
    ScoreOutcome,
    ServingError,
)
from photon_ml_tpu_torch.serving.batcher import (  # noqa: F401
    DrainReport,
    MicroBatcher,
    ScoreRequest,
    request_from_record,
    requests_from_dataset,
)
from photon_ml_tpu_torch.serving.frontend import ServingFrontend  # noqa: F401
from photon_ml_tpu_torch.serving.metrics import ServingMetrics  # noqa: F401
from photon_ml_tpu_torch.serving.model_bank import (  # noqa: F401
    DEFAULT_ENTITY_PAD,
    EntityRowIndex,
    ModelBank,
    bank_from_arrays,
    build_model_bank,
)
from photon_ml_tpu_torch.serving.programs import (  # noqa: F401
    DEFAULT_LADDER,
    RequestBatch,
    ServingPrograms,
    select_shape,
)
from photon_ml_tpu_torch.serving.routing import (  # noqa: F401
    HotEntityCache,
    RoutedScore,
    RouterMetrics,
    RoutingPolicy,
    ShardHealth,
    ShardRouter,
    TcpShardTransport,
)
from photon_ml_tpu_torch.serving.shard_server import (  # noqa: F401
    ShardServer,
    make_shard_ops,
    shard_topology,
)
from photon_ml_tpu_torch.serving.swap import (  # noqa: F401
    ServingModel,
    SwapResult,
    load_model_artifact,
)
