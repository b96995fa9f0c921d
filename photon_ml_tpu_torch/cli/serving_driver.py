"""Online scoring driver: load a GAME model into a device-resident bank
and serve score requests through the micro-batched request path (port
of ``photon_ml_tpu/cli/serving_driver.py``).

    python -m photon_ml_tpu_torch.cli.serving_driver \\
        --game-model-input-dir MODEL --output-dir OUT \\
        --request-paths TRACE --feature-shard-id-to-feature-section-keys-map ...

Three request sources:

- a replayed Avro trace (the batch scoring driver's own input format,
  which is what makes serving-vs-batch bitwise parity a one-line diff);
- JSON lines on stdin (``--request-paths -``);
- a TCP network front-end (``--frontend-port``): the JSON-lines accept
  loop from :mod:`photon_ml_tpu_torch.serving.frontend`, with admission
  control, deadlines, readiness/liveness status requests and a SIGTERM
  drain protocol. The bound port (0 = ephemeral) is published to
  ``<output-dir>/frontend.json``.

Two replay load modes:

- ``closed`` (default): one request in flight at a time — the
  single-request latency floor (every dispatch is shape 1).
- ``open``: ``--concurrency N`` submitter threads each run their own
  closed loop over a shared trace iterator — the saturating-load mode
  where the batcher's coalescing fills the ladder.

``--swap-model-dir`` stages a second model generation and flips it
after ``--swap-after-requests`` completions, under live traffic.

Two fleet modes:

- shard-server (``--shard-index S --shard-count N --frontend-port P``):
  this process serves ONE entity shard in partial-score mode through the
  front end, with the router's control ops (topology, stage/commit/abort
  swap) attached; the topology rides ``frontend.json`` and every status
  reply;
- router (``--shard-servers host:port,...``): the trace replays through
  the scatter/gather tier (:mod:`photon_ml_tpu_torch.serving.routing`)
  instead of a local bank — no device bank, no programs, no CUDA
  context; ``--swap-model-dir`` runs the fleet-wide two-step flip, and
  ``--fleet-obs-dir`` stitches every member's trace ring into one fleet
  trace.

Lifecycle: SIGTERM (or Ctrl-C) anywhere stops admitting, drains the
batcher within ``--drain-timeout`` (leftover futures fail with the
named ``DRAIN_TIMEOUT`` outcome — never a hang), drains async IO, and
writes metrics.json with an ``interrupted`` marker so a partial run
still accounts for everything it did.

Telemetry: ``--obs-dir`` (tracing, the metrics registry's snapshots and
the flight recorder), ``--profile-dir`` (a ``torch.profiler`` trace of
the serve phase) and ``--slo`` (the burn-rate engine).

Continuous retraining: ``--registry-dir R --frontend-port P`` serves the
latest committed generation of the model registry ``R`` and runs its
watcher (``registry/watcher.py``) beside the front end: a newly
published generation is hot-swapped in under traffic, and with
``--auto-rollback`` (the default) a post-swap window of degraded, shed
or failed responses past ``--rollback-max-unhealthy`` flips back to the
parent generation, reloaded from its artifact, and quarantines the bad
one. With ``--slo`` the window's judgment is the burn-rate alert state.

The port adds ``--device`` (the card by default, ``cpu`` on request; a
router takes none).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.cli.game_training_driver import (
    _bool,
    apply_intercept_map,
    parse_shard_map,
)
from photon_ml_tpu_torch.cli.glm_driver import prepare_output_dir
from photon_ml_tpu_torch.evaluation.evaluator import EvaluatorType
from photon_ml_tpu_torch.game.config import FeatureShardConfiguration
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.utils.device import resolve_device
from photon_ml_tpu_torch.utils.logging_util import PhotonLogger, Timer

DEFAULT_LADDER_TEXT = "1,8,64,256"

@dataclass
class ServingParams:
    game_model_input_dir: str = ""
    output_dir: str = ""
    # Replay source: an Avro file/dir trace (request_paths) or "-" for
    # JSON lines on stdin.
    request_paths: List[str] = field(default_factory=list)
    feature_shards: List[FeatureShardConfiguration] = field(
        default_factory=list
    )
    task_type: TaskType = TaskType.LOGISTIC_REGRESSION
    model_id: str = ""
    has_response: bool = True
    evaluator_types: List[EvaluatorType] = field(default_factory=list)
    # Prebuilt feature maps (required for stdin; the Avro replay path
    # can fall back to building maps from the trace itself, which is
    # exactly what the batch scorer's in-memory mode does).
    offheap_indexmap_dir: Optional[str] = None
    offheap_indexmap_num_partitions: Optional[int] = None
    feature_name_and_term_set_path: Optional[str] = None
    # Padded micro-batch shape ladder + batching policy.
    ladder: List[int] = field(default_factory=lambda: [1, 8, 64, 256])
    max_wait_ms: float = 0.0
    max_queue: int = 4096
    # Per-shard request nnz width for stdin mode ("shard:k|shard:k" or
    # one integer for all shards); Avro replay derives widths from the
    # trace's padded layout.
    request_nnz_width: Optional[str] = None
    # Load mode.
    mode: str = "closed"
    concurrency: int = 8
    # Hot swap: stage + flip this model generation after N completed
    # requests.
    swap_model_dir: Optional[str] = None
    swap_after_requests: int = 0
    entity_pad_to: int = 256
    write_scores: bool = True
    delete_output_dir_if_exists: bool = False
    application_name: str = "photon-ml-tpu-serving"
    no_overlap: bool = False
    fault_plan: Optional[str] = None
    # Network front-end: serve over a TCP JSON-lines socket instead of
    # replaying a trace. 0 = ephemeral port, published to
    # <output-dir>/frontend.json.
    frontend_host: str = "127.0.0.1"
    frontend_port: Optional[int] = None
    # SIGTERM drain budget: pending requests past it fail with the
    # named DRAIN_TIMEOUT outcome — zero hung futures.
    drain_timeout_s: float = 10.0
    # Admission default: requests that carry no deadline_ms of their
    # own get this one (None = no deadline).
    default_deadline_ms: Optional[float] = None
    # photon-wire's framing cap, shared by JSON lines and binary frames
    # (the front end speaks both, by first-byte sniffing; None resolves
    # PHOTON_MAX_FRAME_BYTES, then 1 MiB), published in frontend.json and
    # every status response
    max_frame_bytes: Optional[int] = None
    # where the bank lives and the programs run: None = the CUDA card
    # (raises without one), "cpu" on request; a router takes none
    device: Optional[str] = None
    # Shard-server mode: this replica serves ONE entity shard
    # (--shard-index of --shard-count) in partial-score mode with the
    # router control ops attached; topology is published in
    # frontend.json and every status response. Router mode:
    # --shard-servers host:port,... replays the trace through the
    # scatter/gather tier instead of a local bank.
    shard_index: Optional[int] = None
    shard_count: Optional[int] = None
    shard_servers: Optional[str] = None
    hot_cache_entries: int = 4096
    router_subrequest_timeout_ms: float = 2000.0
    router_hedge: bool = True
    # Telemetry plane: --obs-dir enables request tracing (Chrome
    # trace-event JSON), the live metrics registry ({"op": "metrics"} +
    # periodic atomic snapshots), and the flight recorder (auto-dumped on
    # swap/rollback transitions + at drain).
    obs_dir: Optional[str] = None
    obs_snapshot_s: float = 5.0
    # Device-timeline co-capture: a torch.profiler trace over the serve
    # phase (replay, frontend and router modes), next to the host spans.
    profile_dir: Optional[str] = None
    # Router mode only: --fleet-obs-dir runs a live FleetCollector over
    # the shard fleet (incremental {"op":"trace"} drains on fresh
    # connections, NTP-style clock-skew normalization) and writes ONE
    # merged fleet_trace.json + fleet_conservation.json at exit.
    fleet_obs_dir: Optional[str] = None
    fleet_poll_s: float = 1.0
    # Declarative SLOs with multi-window burn-rate alerting: inline
    # JSON, @file, or "default". Alerts land on the flight-recorder ring
    # and as registry gauges.
    slo: Optional[str] = None
    slo_tick_s: float = 1.0
    # Router mode: the data-plane protocol — "binary" requires every
    # shard to advertise photon-wire framing (mismatched fleets are
    # refused at connect), "auto" negotiates binary when the whole fleet
    # speaks it, "json" pins the JSON-lines plane.
    wire: str = "auto"
    # Continuous retraining (registry/): serve the latest committed
    # generation of a model registry and hot-swap newly published ones
    # under live traffic. --auto-rollback flips BACK to the parent
    # generation (bitwise, reloaded from the registry artifact) and
    # quarantines the bad one when the post-swap health window
    # regresses (degraded/shed/error rate over the sliding window).
    registry_dir: Optional[str] = None
    registry_poll_s: float = 2.0
    auto_rollback: bool = True
    rollback_window: int = 64
    rollback_min_requests: int = 16
    rollback_max_unhealthy: float = 0.5

    @property
    def stdin_mode(self) -> bool:
        return self.request_paths == ["-"]

    @property
    def frontend_mode(self) -> bool:
        return self.frontend_port is not None

    @property
    def shard_mode(self) -> bool:
        return self.shard_index is not None or self.shard_count is not None

    @property
    def router_mode(self) -> bool:
        return bool(self.shard_servers)

    @property
    def entity_shard(self):
        return (
            (self.shard_index, self.shard_count)
            if self.shard_mode
            else None
        )

    @property
    def shard_addresses(self):
        out = []
        for part in (self.shard_servers or "").split(","):
            part = part.strip()
            if not part:
                continue
            host, _, port = part.rpartition(":")
            out.append((host or "127.0.0.1", int(port)))
        return out

    def validate(self) -> None:
        if self.fleet_obs_dir and not self.router_mode:
            raise ValueError(
                "--fleet-obs-dir is the router-side fleet collector; "
                "it requires --shard-servers (router mode)"
            )
        if self.fleet_poll_s <= 0:
            raise ValueError("fleet-poll-s must be > 0")
        if self.wire not in ("json", "binary", "auto"):
            raise ValueError(
                f"--wire must be json|binary|auto, got {self.wire!r}"
            )
        if self.max_frame_bytes is not None and self.max_frame_bytes <= 0:
            raise ValueError("--max-frame-bytes must be positive")
        if self.slo_tick_s <= 0:
            raise ValueError("slo-tick-s must be > 0")
        if self.slo:
            from photon_ml_tpu_torch.obs.slo import parse_slo_specs

            # parse-time rejection: a typo'd spec must fail the launch,
            # not silently alert on nothing
            parse_slo_specs(self.slo)
        if self.shard_mode:
            if self.shard_index is None or self.shard_count is None:
                raise ValueError(
                    "--shard-index and --shard-count go together"
                )
            if not (
                self.shard_count >= 1
                and 0 <= self.shard_index < self.shard_count
            ):
                raise ValueError(
                    f"need 0 <= shard-index < shard-count, got "
                    f"{self.shard_index}/{self.shard_count}"
                )
            if not self.frontend_mode:
                raise ValueError(
                    "a shard-server serves the routing tier over TCP; "
                    "--shard-index requires --frontend-port"
                )
            if self.registry_dir:
                raise ValueError(
                    "--shard-index is incompatible with --registry-dir: "
                    "a watcher-owned swap on one shard would desync the "
                    "fleet's generations — the router coordinates swaps "
                    "through the stage/commit ops"
                )
            if self.swap_model_dir:
                raise ValueError(
                    "--swap-model-dir is incompatible with "
                    "--shard-index: shard generations flip through the "
                    "router's two-step stage/commit protocol"
                )
        if self.router_mode:
            if self.shard_mode:
                raise ValueError(
                    "a process is a shard-server or a router, not both"
                )
            if self.frontend_mode:
                raise ValueError(
                    "router mode replays --request-paths through the "
                    "fleet; it does not serve a frontend itself"
                )
            if self.registry_dir:
                raise ValueError(
                    "router mode coordinates fleet swaps itself; "
                    "--registry-dir is the single-server watcher path"
                )
            if self.device is not None:
                raise ValueError(
                    "router mode builds no device bank; --device is the "
                    "shard-servers' option"
                )
            if not self.request_paths:
                raise ValueError(
                    "router mode needs --request-paths ('-' for stdin)"
                )
            if not self.shard_addresses:
                raise ValueError(
                    f"unparseable --shard-servers {self.shard_servers!r}"
                )
            if self.swap_model_dir and self.swap_after_requests < 1:
                raise ValueError(
                    "swap-model-dir requires --swap-after-requests >= 1"
                )
            if not self.game_model_input_dir:
                raise ValueError(
                    "router mode needs --game-model-input-dir (the "
                    "router builds its entity->shard index from the "
                    "model's entity universe)"
                )
            if not self.output_dir:
                raise ValueError("output-dir is required")
            if self.mode not in ("closed", "open"):
                raise ValueError(
                    f"mode must be closed|open, got {self.mode!r}"
                )
            if not self.feature_shards:
                raise ValueError(
                    "feature shard configuration is required"
                )
            return  # the bank/ladder rules below are shard-side
        if not self.game_model_input_dir and not self.registry_dir:
            raise ValueError(
                "game-model-input-dir is required (or --registry-dir to "
                "serve the latest committed registry generation)"
            )
        if self.game_model_input_dir and self.registry_dir:
            raise ValueError(
                "choose ONE model source: --game-model-input-dir or "
                "--registry-dir"
            )
        if self.registry_dir and not self.frontend_mode:
            raise ValueError(
                "--registry-dir serves live traffic (the watcher swaps "
                "generations under load); it requires --frontend-port"
            )
        if self.registry_dir and self.swap_model_dir:
            raise ValueError(
                "--swap-model-dir is the manual swap demonstration; "
                "with --registry-dir the watcher owns swaps"
            )
        if self.registry_poll_s <= 0:
            raise ValueError("registry-poll-s must be > 0")
        if not 0 < self.rollback_max_unhealthy <= 1:
            raise ValueError("rollback-max-unhealthy must be in (0, 1]")
        if self.rollback_window < 1 or self.rollback_min_requests < 1:
            raise ValueError("rollback window/min-requests must be >= 1")
        if not self.output_dir:
            raise ValueError("output-dir is required")
        if not self.request_paths and not self.frontend_mode:
            raise ValueError(
                "request-paths is required ('-' for stdin) unless "
                "--frontend-port starts the network front-end"
            )
        if self.frontend_mode and self.request_paths:
            raise ValueError(
                "choose ONE request source: --request-paths (replay) or "
                "--frontend-port (network front-end)"
            )
        if not self.feature_shards:
            raise ValueError("feature shard configuration is required")
        if self.mode not in ("closed", "open"):
            raise ValueError(f"mode must be closed|open, got {self.mode!r}")
        if self.mode == "open" and self.concurrency < 1:
            raise ValueError("concurrency must be >= 1")
        if sorted(set(self.ladder)) != list(self.ladder) or not self.ladder:
            raise ValueError(f"ladder must be increasing: {self.ladder}")
        if self.swap_model_dir and self.swap_after_requests < 1:
            raise ValueError(
                "swap-model-dir requires --swap-after-requests >= 1"
            )
        if self.drain_timeout_s <= 0:
            raise ValueError(
                f"drain-timeout must be > 0, got {self.drain_timeout_s}"
            )
        if (
            self.default_deadline_ms is not None
            and self.default_deadline_ms <= 0
        ):
            raise ValueError(
                "default-deadline-ms must be > 0 when set, got "
                f"{self.default_deadline_ms}"
            )
        if self.stdin_mode or self.frontend_mode:
            source = "stdin" if self.stdin_mode else "front-end"
            if not (
                self.offheap_indexmap_dir
                or self.feature_name_and_term_set_path
            ):
                raise ValueError(
                    f"{source} serving requires prebuilt feature maps "
                    "(--offheap-indexmap-dir or "
                    "--feature-name-and-term-set-path): a request stream "
                    "has no vocabulary to build from"
                )
            if not self.request_nnz_width:
                raise ValueError(
                    f"{source} serving requires --request-nnz-width (the "
                    "fixed per-shard feature width baked into the program "
                    "shapes)"
                )


def _parse_widths(text: str, shard_ids: List[str]) -> Dict[str, int]:
    text = text.strip()
    if "|" not in text and ":" not in text:
        return {sid: int(text) for sid in shard_ids}
    out: Dict[str, int] = {}
    for part in text.split("|"):
        sid, _, k = part.partition(":")
        out[sid.strip()] = int(k)
    missing = [sid for sid in shard_ids if sid not in out]
    if missing:
        raise ValueError(f"request-nnz-width missing shards {missing}")
    return out


@dataclass
class _RoutedRequest:
    """Just enough of a ScoreRequest for the score-artifact writer and
    the trace evaluators (router mode routes raw records; nothing else
    needs assembling)."""

    uid: str
    label: Optional[float]
    weight: float
    metadata: Optional[Dict[str, str]]


class ServingDriver:
    def __init__(self, params: ServingParams, logger=None):
        params.validate()
        self.params = params
        # a router builds no device bank: it never resolves (or creates a
        # context on) a device
        self.device = None if params.router_mode else resolve_device(params.device)
        if params.no_overlap:
            from photon_ml_tpu_torch.parallel import overlap

            overlap.set_overlap(False)
        if params.fault_plan:
            from photon_ml_tpu_torch.reliability import install_plan

            install_plan(params.fault_plan)
        prepare_output_dir(
            params.output_dir,
            delete_if_exists=params.delete_output_dir_if_exists,
        )
        self.logger = logger or PhotonLogger(params.output_dir)
        self.timer = Timer()
        # --obs-dir: one session owns tracing + registry + flight
        # recorder; the driver's own drain paths call finish() (signal
        # dumps ride the drain protocol, not a second handler)
        from photon_ml_tpu_torch.obs import ObsSession

        self.obs = ObsSession(
            params.obs_dir,
            snapshot_period_s=params.obs_snapshot_s,
            signal_dump=False,
        )
        self.serving_model = None
        self.metrics = None
        self.results: List[float] = []
        # replay interrupt machinery: SIGTERM/Ctrl-C writes partial
        # accounting instead of losing it
        self._stop_replay = threading.Event()
        self._closed_scored: List[tuple] = []
        self._open_results: Dict[int, tuple] = {}
        self.drain_report = None
        self.interrupted = False
        # fleet observability (--fleet-obs-dir / --slo)
        self.slo_engine = None          # obs.slo.SLOEngine
        self.fleet_collector = None     # obs.fleet.FleetCollector
        # continuous-retraining state (--registry-dir)
        self.registry = None            # registry.ModelRegistry
        self.registry_watcher = None    # registry.RegistryWatcher
        self._registry_generation = None

    # -- SLO engine (--slo) --------------------------------------------------

    def _start_slo(self, *, router=None):
        """Start the burn-rate engine over the process registry: bind
        the live instruments (serving or router plane), register the
        status view, run the tick thread. Alerts file onto the flight
        ring and surface as slo_* gauges."""
        p = self.params
        if not p.slo:
            return None
        from photon_ml_tpu_torch.obs.flight_recorder import flight_recorder
        from photon_ml_tpu_torch.obs.registry import default_registry
        from photon_ml_tpu_torch.obs.slo import (
            SLOEngine,
            default_router_slos,
            parse_slo_specs,
        )

        registry = self.obs.registry or default_registry()
        if p.slo.strip() == "default" and router is not None:
            specs = default_router_slos()
        else:
            specs = parse_slo_specs(p.slo)
        if router is not None:
            router.metrics.bind_registry(registry)
        elif self.metrics is not None:
            self.metrics.bind_registry(registry)
        engine = SLOEngine(registry, specs, recorder=flight_recorder())
        registry.register_view("slo", engine.status)
        engine.start(period_s=p.slo_tick_s)
        self.slo_engine = engine
        self.logger.info(
            "SLO engine: %d spec(s), tick %.2fs — %s",
            len(specs), p.slo_tick_s,
            ", ".join(s.name for s in specs),
        )
        return engine

    def _finish_slo(self) -> Optional[Dict]:
        if self.slo_engine is None:
            return None
        self.slo_engine.stop()
        return self.slo_engine.status()

    # -- setup ---------------------------------------------------------------

    def _prebuilt_index_maps(self):
        p = self.params
        if p.offheap_indexmap_dir:
            from photon_ml_tpu_torch.utils.native_index import (
                load_offheap_index_maps,
            )

            return load_offheap_index_maps(
                p.offheap_indexmap_dir,
                [cfg.shard_id for cfg in p.feature_shards],
                num_partitions=p.offheap_indexmap_num_partitions,
            )
        if p.feature_name_and_term_set_path:
            from photon_ml_tpu_torch.io.name_term_list import (
                index_maps_from_name_term_lists,
            )

            return index_maps_from_name_term_lists(
                p.feature_name_and_term_set_path, p.feature_shards
            )
        return None

    def _build(self):
        """Load the model artifact (behind the serving.model_load seam),
        resolve feature maps + widths, stage the device bank, capture
        the whole ladder. Returns the replayable request list."""
        from photon_ml_tpu_torch.serving import (
            ServingModel,
            ServingPrograms,
            build_model_bank,
            load_model_artifact,
            requests_from_dataset,
        )
        from photon_ml_tpu_torch.serving.batcher import request_from_record

        p = self.params
        model_dir = p.game_model_input_dir
        if p.registry_dir:
            from photon_ml_tpu_torch.registry import ModelRegistry

            self.registry = ModelRegistry(p.registry_dir)
            info = self.registry.latest()
            if info is None:
                raise ValueError(
                    f"registry {p.registry_dir} has no committed "
                    "generation to serve"
                )
            self._registry_generation = info
            model_dir = info.model_dir
            self.logger.info(
                "serving registry generation %d (parent %s, gates %s)",
                info.generation, info.parent, info.gate_verdict,
            )
        with self.timer.time("load-model"):
            loaded = load_model_artifact(model_dir)
        id_types = sorted(
            {re_t for re_t, _, _ in loaded.random_effects.values()}
            | {
                t
                for rt, ct, _, _ in loaded.matrix_factorizations.values()
                for t in (rt, ct)
            }
        )
        index_maps = self._prebuilt_index_maps()
        requests = None
        dataset = None
        if p.stdin_mode or p.frontend_mode:
            widths = _parse_widths(
                p.request_nnz_width,
                [cfg.shard_id for cfg in p.feature_shards],
            )
        else:
            with self.timer.time("load-trace"):
                from photon_ml_tpu_torch.game.data import (
                    build_game_dataset_from_files,
                )

                # the trace stays on the host: requests are numpy rows
                dataset = build_game_dataset_from_files(
                    p.request_paths,
                    p.feature_shards,
                    id_types,
                    index_maps=index_maps,
                    is_response_required=p.has_response,
                    device="cpu",
                )
            if index_maps is None:
                # batch-scorer in-memory parity mode: the trace itself
                # defines the vocabulary
                index_maps = {
                    sid: sd.index_map for sid, sd in dataset.shards.items()
                }
            widths = (
                _parse_widths(
                    p.request_nnz_width,
                    [cfg.shard_id for cfg in p.feature_shards],
                )
                if p.request_nnz_width
                else {
                    sid: sd.indices.shape[1]
                    for sid, sd in dataset.shards.items()
                }
            )
        with self.timer.time("stage-bank"):
            bank = build_model_bank(
                loaded,
                index_maps,
                widths,
                entity_pad_to=p.entity_pad_to,
                model_id=p.model_id,
                entity_shard=p.entity_shard,
                device=self.device,
            )
        with self.timer.time("warmup-programs"):
            self.serving_model = ServingModel(
                bank,
                ServingPrograms(tuple(p.ladder)),
                partial=p.shard_mode,
                entity_shard=p.entity_shard,
            )
        self.logger.info(
            "bank generation %d staged: %d coordinate(s), %.1f MiB on "
            "%s, ladder %s built (%d program(s))%s",
            bank.generation,
            len(bank.spec),
            bank.device_bytes() / (1 << 20),
            self.device,
            tuple(p.ladder),
            self.serving_model.programs.stats()["compiled_programs"],
            (
                f", entity shard {p.shard_index}/{p.shard_count} "
                "(partial-score mode)"
                if p.shard_mode else ""
            ),
        )
        if dataset is not None:
            with self.timer.time("assemble-requests"):
                requests = requests_from_dataset(dataset, bank)
        elif p.stdin_mode:
            def stdin_requests():
                for line in sys.stdin:
                    line = line.strip()
                    if not line:
                        continue
                    yield request_from_record(
                        json.loads(line),
                        bank,
                        p.feature_shards,
                        has_response=p.has_response,
                    )

            requests = stdin_requests()
        # frontend mode: requests arrive over the socket, not here
        return requests

    # -- replay --------------------------------------------------------------

    def _maybe_swap(self, completed: int, swap_once: threading.Lock):
        p = self.params
        if (
            p.swap_model_dir
            and completed >= p.swap_after_requests
            # non-blocking acquire = atomic test-and-set: exactly one
            # thread stages the flip, racers skip past
            and swap_once.acquire(blocking=False)
        ):
            with self.timer.time("hot-swap"):
                res = self.serving_model.stage_and_swap(
                    p.swap_model_dir,
                    entity_pad_to=p.entity_pad_to,
                    model_id=p.model_id,
                )
            self.logger.info(
                "hot swap after %d request(s): ok=%s generation=%d "
                "donated=%s recompiled=%d rolled_back=%s%s",
                completed, res.ok, res.generation, res.donated,
                res.recompiled_programs, res.rolled_back,
                f" quarantined={res.quarantined}" if res.quarantined else "",
            )

    def _score_one(self, batcher, req) -> tuple:
        """One request -> one named terminal outcome: ("ok", score) or
        (outcome_name, None). Sheds, deadline drops, drain failures and
        seam-named dispatch failures are RESULTS of an overloaded or
        draining service, not driver crashes — they are accounted, and
        the replay keeps going."""
        import concurrent.futures

        from photon_ml_tpu_torch.reliability import SeamFailure
        from photon_ml_tpu_torch.serving import (
            DeadlineExceeded,
            RequestShed,
            ServingError,
        )

        try:
            return ("ok", batcher.score(req))
        except RequestShed:
            return ("shed", None)
        except DeadlineExceeded:
            return ("deadline_exceeded", None)
        except ServingError as e:
            return (f"error:{e.code}", None)
        except SeamFailure:
            return ("error:DISPATCH_FAILED", None)
        except concurrent.futures.TimeoutError:
            return ("error:TIMEOUT", None)

    def _replay_closed(self, batcher, requests) -> List[tuple]:
        swap_once = threading.Lock()
        out = self._closed_scored
        for req in requests:
            if self._stop_replay.is_set():
                break
            outcome, score = self._score_one(batcher, req)
            out.append((req, outcome, score))
            self._maybe_swap(len(out), swap_once)
        return out

    def _replay_open(self, batcher, requests) -> List[tuple]:
        """``concurrency`` closed-loop submitters over one shared
        iterator: results keep trace order via their request index."""
        p = self.params
        it = iter(enumerate(requests))
        it_lock = threading.Lock()
        out_lock = threading.Lock()
        swap_once = threading.Lock()
        results = self._open_results
        errors: List[BaseException] = []

        def worker():
            while not self._stop_replay.is_set():
                with it_lock:
                    try:
                        i, req = next(it)
                    except StopIteration:
                        return
                try:
                    outcome, score = self._score_one(batcher, req)
                except BaseException as e:
                    with out_lock:
                        errors.append(e)
                    return
                with out_lock:
                    results[i] = (req, outcome, score)
                    n = len(results)
                self._maybe_swap(n, swap_once)

        threads = [
            threading.Thread(
                target=worker, name=f"photon-serving-load-{t}", daemon=True
            )
            for t in range(p.concurrency)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return [results[i] for i in sorted(results)]

    def _partial_results(self) -> List[tuple]:
        """Whatever the replay completed before an interrupt."""
        if self.params.mode == "closed":
            return list(self._closed_scored)
        return [self._open_results[i] for i in sorted(self._open_results)]

    # -- output --------------------------------------------------------------

    def _write_scores(self, scored: List[tuple]) -> None:
        from photon_ml_tpu_torch.io import schemas
        from photon_ml_tpu_torch.io.avro_codec import write_container

        p = self.params

        def records():
            for req, outcome, score in scored:
                if outcome != "ok":
                    continue  # shed/expired/failed: accounted, not scored
                yield {
                    "uid": req.uid,
                    "label": req.label if p.has_response else None,
                    "modelId": p.model_id or "game-model",
                    "predictionScore": float(score),
                    "weight": req.weight,
                    "metadataMap": req.metadata or None,
                }

        write_container(
            os.path.join(p.output_dir, "scores", "part-00000.avro"),
            schemas.SCORING_RESULT_AVRO,
            records(),
        )

    def _evaluate(self, scored: List[tuple]) -> Dict[str, float]:
        """Pointwise trace metrics (AUC/RMSE/losses) over the replayed
        scores — the batch driver's evaluator path, on the driver's
        device, over the scores the request loop already paid for."""
        from photon_ml_tpu_torch.evaluation.evaluator import Evaluator
        from photon_ml_tpu_torch.ops.losses import loss_for_task

        p = self.params
        out: Dict[str, float] = {}
        ok = [(r, s) for r, outcome, s in scored if outcome == "ok"]
        if not (p.evaluator_types and p.has_response and ok):
            return out

        def col(values):
            return torch.as_tensor(
                np.asarray(values, np.float32), device=self.device
            )

        scores = col([s for _, s in ok])
        labels = col([r.label for r, _ in ok])
        weights = col([r.weight for r, _ in ok])
        loss = loss_for_task(p.task_type)
        for et in p.evaluator_types:
            if et.is_sharded:
                raise ValueError(
                    f"sharded evaluator {et.render()!r} needs global "
                    "per-group data; evaluate with the batch driver"
                )
            metric_in = loss.mean(scores) if et.name == "RMSE" else scores
            value = float(Evaluator(et).evaluate(metric_in, labels, weights))
            out[et.render()] = value
            self.logger.info("%s = %g", et.render(), value)
        return out

    # -- lifecycle -----------------------------------------------------------

    def _install_signal_handlers(self, handler) -> List[tuple]:
        """Install SIGTERM/SIGINT handlers (main thread only — a driver
        constructed inside a test worker skips them); returns what to
        restore."""
        prev = []
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev.append((sig, signal.signal(sig, handler)))
            except ValueError:
                pass  # not the main thread
        return prev

    @staticmethod
    def _restore_signal_handlers(prev: List[tuple]) -> None:
        for sig, old in prev:
            try:
                signal.signal(sig, old)
            except (ValueError, TypeError):
                pass

    def _metrics_extra(self, scored, eval_metrics) -> Dict:
        from photon_ml_tpu_torch.parallel import overlap

        outcomes: Dict[str, int] = {}
        for _req, outcome, _s in scored:
            outcomes[outcome] = outcomes.get(outcome, 0) + 1
        extra = {
            **eval_metrics,
            "mode": (
                "frontend" if self.params.frontend_mode else self.params.mode
            ),
            "device": str(self.device),
            "interrupted": self.interrupted,
            "generation": self.serving_model.generation,
            "programs": self.serving_model.programs.stats(),
            "readbacks": overlap.readback_stats(),
            "swap_history": [
                {
                    "ok": s.ok,
                    "generation": s.generation,
                    "donated": s.donated,
                    "recompiled_programs": s.recompiled_programs,
                    "rolled_back": s.rolled_back,
                    "quarantined": s.quarantined,
                    "error": s.error,
                }
                for s in self.serving_model.swap_history
            ],
        }
        if outcomes:
            extra["outcomes"] = dict(sorted(outcomes.items()))
        if self.drain_report is not None:
            extra["drain"] = self.drain_report.to_dict()
        slo_status = self._finish_slo()
        if slo_status is not None:
            extra["slo"] = slo_status
        if self.registry_watcher is not None:
            extra["registry"] = {
                **self.registry_watcher.lineage(),
                "watcher_history": [
                    {
                        "action": r.action,
                        "registry_generation": r.registry_generation,
                        "parent": r.parent,
                        "ok": r.ok,
                        "error": r.error,
                    }
                    for r in self.registry_watcher.history
                ],
            }
        elif self.registry is not None:
            extra["registry"] = {
                "registry_path": self.registry.root,
                "registry_generation": (
                    self._registry_generation.generation
                    if self._registry_generation is not None else None
                ),
            }
        return extra

    def run(self) -> None:
        from photon_ml_tpu_torch.parallel import overlap
        from photon_ml_tpu_torch.serving import MicroBatcher, ServingMetrics

        p = self.params
        self.logger.info("application: %s", p.application_name)
        if p.router_mode:
            self._run_router()
            return
        requests = self._build()
        self.metrics = ServingMetrics()
        self.obs.register_view("serving", self.metrics.snapshot)
        self._start_slo()
        overlap.reset_readback_stats()
        batcher = MicroBatcher(
            self.serving_model.current,
            self.serving_model.programs,
            self.metrics,
            max_wait_s=p.max_wait_ms / 1e3,
            max_queue=p.max_queue,
            default_deadline_ms=p.default_deadline_ms,
        )
        if p.frontend_mode:
            self._run_frontend(batcher)
            return

        def _interrupt(signum, frame):
            # raised in the main thread: aborts the replay loop / joins;
            # workers observe _stop_replay and stop submitting
            self._stop_replay.set()
            raise KeyboardInterrupt(f"signal {signum}")

        from photon_ml_tpu_torch.utils.profiling import profile_trace

        prev = self._install_signal_handlers(_interrupt)
        scored = []
        try:
            try:
                # --profile-dir: device timeline over the serve phase,
                # co-captured with the host spans (--obs-dir trace.json)
                with self.timer.time("serve"), profile_trace(
                    p.profile_dir, self.device
                ):
                    scored = (
                        self._replay_closed(batcher, requests)
                        if p.mode == "closed"
                        else self._replay_open(batcher, requests)
                    )
            except KeyboardInterrupt:
                # Ctrl-C / SIGTERM must not lose the accounting — drain
                # within budget, mark the artifact
                self.interrupted = True
                self._stop_replay.set()
                self.logger.info(
                    "interrupted: draining batcher (budget %.1fs)",
                    p.drain_timeout_s,
                )
                self.drain_report = batcher.drain(p.drain_timeout_s)
                scored = self._partial_results()
        finally:
            self._restore_signal_handlers(prev)
            batcher.close()
            overlap.drain_io()
        if not scored and not self.interrupted:
            raise ValueError("empty request trace")
        self.logger.info(
            "served %d request(s) in %s mode%s",
            len(scored), p.mode,
            " (interrupted)" if self.interrupted else "",
        )
        if p.write_scores and scored:
            with self.timer.time("write-scores"):
                self._write_scores(scored)
        eval_metrics = self._evaluate(scored)
        extra = self._metrics_extra(scored, eval_metrics)
        obs_summary = self.obs.finish()
        if obs_summary is not None:
            extra["obs"] = obs_summary
        self.metrics.write(
            os.path.join(p.output_dir, "metrics.json"),
            extra=extra,
        )
        self.results = [s for _, outcome, s in scored if outcome == "ok"]
        self.logger.info("timers:\n%s", self.timer.summary())

    # -- router mode (--shard-servers) ---------------------------------------

    def _router_entity_ids(self, loaded) -> Dict[str, List[str]]:
        """The router's only model state: each id type's FULL sorted
        entity-id universe (position == code == the ownership rule's
        input). No coefficients are ever loaded router-side."""
        entity_ids: Dict[str, List[str]] = {}
        for re_type, _sid, per_entity in loaded.random_effects.values():
            ids = sorted(per_entity)
            prev = entity_ids.get(re_type)
            if prev is not None and prev != ids:
                raise ValueError(
                    f"random-effect coordinates disagree on the "
                    f"{re_type!r} entity set"
                )
            entity_ids[re_type] = ids
        for row_t, col_t, rows, cols in (
            loaded.matrix_factorizations.values()
        ):
            for t, latent in ((row_t, rows), (col_t, cols)):
                entity_ids.setdefault(t, sorted(latent))
        return entity_ids

    def _router_records(self):
        p = self.params
        if p.stdin_mode:
            def stdin_records():
                for line in sys.stdin:
                    line = line.strip()
                    if line:
                        yield json.loads(line)

            return stdin_records()
        from photon_ml_tpu_torch.io.avro_codec import read_avro_records

        out = []
        for path in p.request_paths:
            out.extend(read_avro_records(path))
        return out

    def _route_one(self, router, record) -> tuple:
        from photon_ml_tpu_torch.serving import ServingError

        p = self.params
        try:
            outcome = router.score_record(
                record,
                deadline_ms=record.get("deadline_ms",
                                       p.default_deadline_ms),
            )
            return ("ok", outcome)
        except ServingError as e:
            return (f"error:{e.code}", None)

    def _maybe_router_swap(
        self, router, completed: int, swap_once: threading.Lock
    ) -> None:
        p = self.params
        if (
            p.swap_model_dir
            and completed >= p.swap_after_requests
            and swap_once.acquire(blocking=False)
        ):
            with self.timer.time("router-swap"):
                res = router.coordinate_swap(p.swap_model_dir)
            self._router_swap_result = res
            self.logger.info(
                "router-coordinated two-step swap after %d request(s): "
                "%s", completed, res,
            )

    def _run_router(self) -> None:
        """Replay the trace through the scatter/gather tier: the driver
        is the THIN router — no device bank, no programs, just the
        entity->shard index and the fleet connections. Bitwise vs the
        single-server replay is the acceptance bar; a mid-replay
        --swap-model-dir runs the two-step fleet flip."""
        from photon_ml_tpu_torch.game.data import record_response
        from photon_ml_tpu_torch.parallel import overlap
        from photon_ml_tpu_torch.reliability import (
            atomic_write_json,
            reliability_metrics,
        )
        from photon_ml_tpu_torch.serving import (
            RoutingPolicy,
            ShardRouter,
        )
        from photon_ml_tpu_torch.serving.swap import load_model_artifact

        p = self.params
        with self.timer.time("load-model"):
            loaded = load_model_artifact(p.game_model_input_dir)
        router = ShardRouter(
            p.shard_addresses,
            entity_ids=self._router_entity_ids(loaded),
            shard_configs=p.feature_shards,
            policy=RoutingPolicy(
                hedge=p.router_hedge,
                subrequest_timeout_s=(
                    p.router_subrequest_timeout_ms / 1e3
                ),
            ),
            cache_entries=p.hot_cache_entries,
            wire=p.wire,
        )
        with self.timer.time("connect-fleet"):
            info = router.connect()
        self.obs.register_view("routing", router.status)
        self.logger.info(
            "routing over %d shard-server(s), fleet generation %d, "
            "%s wire", info["shards"], info["generation"], info["wire"],
        )
        self._start_slo(router=router)
        if p.fleet_obs_dir:
            os.makedirs(p.fleet_obs_dir, exist_ok=True)
            from photon_ml_tpu_torch.obs.fleet import FleetCollector

            # the live fleet collector: incremental {"op":"trace"}
            # drains over fresh connections against every shard, plus
            # the router's own local spans — one merged timeline
            self.fleet_collector = FleetCollector(
                [
                    (f"shard{i}", h, pt)
                    for i, (h, pt) in enumerate(p.shard_addresses)
                ],
                local_name="router",
                poll_s=p.fleet_poll_s,
            ).start()
            self.logger.info(
                "fleet collector polling %d shard(s) every %.2fs -> %s",
                len(p.shard_addresses), p.fleet_poll_s, p.fleet_obs_dir,
            )
        self._router_swap_result = None
        records = self._router_records()
        swap_once = threading.Lock()
        scored: List[tuple] = []
        out_lock = threading.Lock()

        def _interrupt(signum, frame):
            self._stop_replay.set()
            raise KeyboardInterrupt(f"signal {signum}")

        from photon_ml_tpu_torch.utils.profiling import profile_trace

        prev = self._install_signal_handlers(_interrupt)
        try:
            try:
                with self.timer.time("serve"), profile_trace(p.profile_dir):
                    if p.mode == "closed":
                        for rec in records:
                            if self._stop_replay.is_set():
                                break
                            outcome, score = self._route_one(router, rec)
                            scored.append((rec, outcome, score))
                            self._maybe_router_swap(
                                router, len(scored), swap_once
                            )
                    else:
                        it = iter(enumerate(records))
                        it_lock = threading.Lock()
                        results: Dict[int, tuple] = {}
                        errors: List[BaseException] = []

                        def worker():
                            while not self._stop_replay.is_set():
                                with it_lock:
                                    try:
                                        i, rec = next(it)
                                    except StopIteration:
                                        return
                                try:
                                    outcome, score = self._route_one(
                                        router, rec
                                    )
                                except BaseException as e:
                                    with out_lock:
                                        errors.append(e)
                                    return
                                with out_lock:
                                    results[i] = (rec, outcome, score)
                                    n = len(results)
                                self._maybe_router_swap(
                                    router, n, swap_once
                                )

                        threads = [
                            threading.Thread(
                                target=worker,
                                name=f"photon-router-load-{t}",
                                daemon=True,
                            )
                            for t in range(p.concurrency)
                        ]
                        for t in threads:
                            t.start()
                        for t in threads:
                            t.join()
                        if errors:
                            raise errors[0]
                        scored = [results[i] for i in sorted(results)]
            except KeyboardInterrupt:
                self.interrupted = True
                self._stop_replay.set()
        finally:
            self._restore_signal_handlers(prev)
            router.close()
            overlap.drain_io()
        if not scored and not self.interrupted:
            raise ValueError("empty request trace")
        self.logger.info(
            "routed %d request(s) in %s mode%s",
            len(scored), p.mode,
            " (interrupted)" if self.interrupted else "",
        )
        outcomes: Dict[str, int] = {}
        for _rec, outcome, _s in scored:
            outcomes[outcome] = outcomes.get(outcome, 0) + 1
        if p.write_scores and scored:
            id_types = sorted(router._indexes)

            def shim(rec):
                meta = {
                    t: str(v) for t, v in (
                        (t, rec.get(t) or (rec.get("metadataMap") or {})
                         .get(t))
                        for t in id_types
                    ) if v is not None
                }
                return _RoutedRequest(
                    uid=str(rec.get("uid") or ""),
                    label=(
                        record_response(rec, True)
                        if p.has_response else None
                    ),
                    weight=(
                        1.0 if rec.get("weight") is None
                        else float(rec["weight"])
                    ),
                    metadata=meta or None,
                )

            with self.timer.time("write-scores"):
                self._write_scores([
                    (shim(rec), outcome, score)
                    for rec, outcome, score in scored
                ])
        status = router.status()
        degraded = sum(
            1 for _r, o, s in scored
            if o == "ok" and getattr(s, "degraded", False)
        )
        fleet_block = self._finish_fleet_obs()
        slo_status = self._finish_slo()
        obs_summary = self.obs.finish()
        atomic_write_json(
            os.path.join(p.output_dir, "metrics.json"),
            {
                "mode": "router",
                **({"obs": obs_summary} if obs_summary else {}),
                **({"fleet_obs": fleet_block} if fleet_block else {}),
                **({"slo": slo_status} if slo_status else {}),
                "interrupted": self.interrupted,
                "outcomes": dict(sorted(outcomes.items())),
                "degraded_responses": degraded,
                "generation": router.generation,
                "routing": status,
                "swap": self._router_swap_result,
                "shard_servers": [
                    f"{h}:{pt}" for h, pt in p.shard_addresses
                ],
                "reliability": reliability_metrics(),
            },
        )
        self.results = [
            s for _r, outcome, s in scored if outcome == "ok"
        ]
        self.logger.info("timers:\n%s", self.timer.summary())

    def _finish_fleet_obs(self) -> Optional[Dict]:
        """Stop the collector (one final drain poll), fetch every
        member's flight book, write fleet_trace.json +
        fleet_conservation.json, and return the metrics.json block."""
        if self.fleet_collector is None:
            return None
        from photon_ml_tpu_torch.obs.fleet import fleet_check_conservation
        from photon_ml_tpu_torch.reliability import atomic_write_json

        p = self.params
        collector = self.fleet_collector
        collector.stop()
        flight = collector.collect_flight()
        books = {
            f"shard{i}": {
                "conservation": (
                    flight.get(f"shard{i}", {}).get("conservation") or {}
                ),
                "complete": bool(
                    flight.get(f"shard{i}", {}).get("complete")
                ),
                "shard_indices": [i],
            }
            for i in range(len(p.shard_addresses))
        }
        router_book = (
            flight.get("router", {}).get("conservation") or {}
        )
        conservation = fleet_check_conservation(router_book, books)
        trace_path = os.path.join(p.fleet_obs_dir, "fleet_trace.json")
        n_events = collector.export(
            trace_path, extra={"conservation_ok": conservation["ok"]}
        )
        atomic_write_json(
            os.path.join(p.fleet_obs_dir, "fleet_conservation.json"),
            conservation,
        )
        self.logger.info(
            "fleet obs: %d merged trace event(s) -> %s; conservation "
            "%s", n_events, trace_path,
            "OK" if conservation["ok"] else "VIOLATED",
        )
        return {
            "fleet_obs_dir": p.fleet_obs_dir,
            "fleet_trace_path": trace_path,
            "trace_events": n_events,
            "members": collector.member_status(),
            "conservation": conservation,
        }


    def _run_frontend(self, batcher) -> None:
        """Network-serving main loop: publish the bound port, serve
        until SIGTERM/SIGINT, then the drain protocol — stop accepting,
        drain the batcher within ``--drain-timeout`` (leftovers fail
        with DRAIN_TIMEOUT), flush + close every connection, write
        metrics.json with the interrupted marker."""
        from photon_ml_tpu_torch.parallel import overlap
        from photon_ml_tpu_torch.reliability import atomic_write_json
        from photon_ml_tpu_torch.serving import ServingFrontend
        from photon_ml_tpu_torch.serving.wire import (
            WIRE_PROTOCOLS as wire_protocols,
            WIRE_VERSION as wire_version,
        )

        p = self.params
        swap_once = threading.Lock()
        on_completion = (
            (lambda n: self._maybe_swap(n, swap_once))
            if p.swap_model_dir
            else None
        )
        on_outcome = None
        lineage_provider = None
        rollback_handler = None
        if self.registry is not None:
            from photon_ml_tpu_torch.registry import (
                RegistryWatcher,
                RollbackPolicy,
            )

            self.registry_watcher = RegistryWatcher(
                self.registry,
                self.serving_model,
                poll_s=p.registry_poll_s,
                policy=RollbackPolicy(
                    window=p.rollback_window,
                    min_requests=p.rollback_min_requests,
                    max_unhealthy_rate=p.rollback_max_unhealthy,
                ),
                auto_rollback=p.auto_rollback,
                swap_kwargs={
                    "entity_pad_to": p.entity_pad_to,
                    "model_id": p.model_id,
                },
                logger=self.logger,
                initial_generation=self._registry_generation,
                # --slo: the post-swap health judgment consumes the
                # burn-rate alert state instead of raw error fractions
                burn_gate=(
                    self.slo_engine.any_alert_active
                    if self.slo_engine is not None
                    else None
                ),
            ).start()
            watcher = self.registry_watcher
            on_outcome = (
                lambda ok, degraded, failed:
                watcher.observe_outcome(degraded=degraded, failed=failed)
            )
            lineage_provider = watcher.lineage
            rollback_handler = watcher.rollback
        extra_ops = None
        status_extra = None
        shard_block = None
        if p.shard_mode:
            from photon_ml_tpu_torch.serving import (
                make_shard_ops,
                shard_topology,
            )

            extra_ops = make_shard_ops(
                self.serving_model,
                p.entity_shard,
                swap_kwargs={
                    "entity_pad_to": p.entity_pad_to,
                    "model_id": p.model_id,
                },
            )
            status_extra = lambda: {  # noqa: E731
                "shard": shard_topology(self.serving_model, p.entity_shard)
            }
            shard_block = shard_topology(self.serving_model, p.entity_shard)
        frontend = ServingFrontend(
            batcher,
            self.serving_model,
            p.feature_shards,
            metrics=self.metrics,
            host=p.frontend_host,
            port=p.frontend_port,
            has_response=p.has_response,
            max_frame_bytes=p.max_frame_bytes,
            on_completion=on_completion,
            on_outcome=on_outcome,
            lineage_provider=lineage_provider,
            rollback_handler=rollback_handler,
            extra_ops=extra_ops,
            status_extra=status_extra,
            metrics_registry=self.obs.registry,
            flight_dump_path=(
                self.obs.flight_path if self.obs.enabled else None
            ),
        )
        frontend.start()
        atomic_write_json(
            os.path.join(p.output_dir, "frontend.json"),
            {  # photon: entropy(discovery artifact; pid names the live process for operators)
                "host": p.frontend_host,
                "port": frontend.port,
                "pid": os.getpid(),
                # the registry this replica follows (null when serving
                # a fixed artifact): operators read it to publish to and
                # poke the SAME lineage the service sees
                "registry": (
                    self.registry.root if self.registry is not None
                    else None
                ),
                # shard topology (null off the routing tier): how the
                # router — and any operator — discovers the fleet
                # layout without out-of-band config
                "shard": shard_block,
                # the wire contract this frontend enforces: protocols
                # spoken on the port (both, via first-byte sniffing)
                # and the shared JSON-line/binary-frame cap
                "wire": {
                    "protocols": list(wire_protocols),
                    "version": wire_version,
                    "max_frame_bytes": frontend.max_frame_bytes,
                },
            },
        )
        self.logger.info(
            "front-end listening on %s:%d (drain budget %.1fs)",
            p.frontend_host, frontend.port, p.drain_timeout_s,
        )
        shutdown = threading.Event()
        prev = self._install_signal_handlers(
            lambda signum, frame: shutdown.set()
        )
        from photon_ml_tpu_torch.utils.profiling import profile_trace

        try:
            try:
                # --profile-dir: the device timeline of everything the
                # dispatcher runs while the frontend serves (the trace
                # closes at SIGTERM, before the drain)
                with profile_trace(p.profile_dir, self.device):
                    while not shutdown.wait(timeout=0.2):
                        pass
            except KeyboardInterrupt:
                pass
            self.interrupted = True
            with self.timer.time("drain"):
                if self.registry_watcher is not None:
                    # stop promoting before the drain: a swap staged
                    # into a draining batcher would never serve
                    self.registry_watcher.stop()
                frontend.stop_accepting()
                self.drain_report = batcher.drain(p.drain_timeout_s)
                frontend.close()
        finally:
            self._restore_signal_handlers(prev)
            if self.registry_watcher is not None:
                self.registry_watcher.stop()
            batcher.close()
            overlap.drain_io()
        leaked = frontend.open_connections()
        self.logger.info(
            "drained: %s; open connections after close: %d",
            self.drain_report.to_dict(), leaked,
        )
        extra = {
            **self._metrics_extra([], {}),
            "frontend_completed": frontend.completed(),
            "leaked_connections": leaked,
        }
        obs_summary = self.obs.finish(reason="drain")
        if obs_summary is not None:
            extra["obs"] = obs_summary
        self.metrics.write(
            os.path.join(p.output_dir, "metrics.json"),
            extra=extra,
        )
        self.logger.info("timers:\n%s", self.timer.summary())


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="photon-ml-tpu-torch serving")
    ap.add_argument("--game-model-input-dir", default=None,
                    help="GAME model artifact to serve (or --registry-dir to "
                    "follow a model registry's committed generations)")
    ap.add_argument("--output-dir", required=True)
    ap.add_argument(
        "--request-paths", default=None,
        help="Avro trace file(s)/dir(s), comma-separated, or '-' for "
        "JSON-lines requests on stdin (omit when --frontend-port serves "
        "over the network)",
    )
    ap.add_argument(
        "--feature-shard-id-to-feature-section-keys-map", required=True
    )
    ap.add_argument("--feature-shard-id-to-intercept-map", default=None)
    ap.add_argument("--task-type", default="LOGISTIC_REGRESSION")
    ap.add_argument("--evaluator-types", default=None)
    ap.add_argument("--game-model-id", default=None)
    ap.add_argument("--has-response", default="true")
    ap.add_argument("--offheap-indexmap-dir", default=None)
    ap.add_argument(
        "--offheap-indexmap-num-partitions", type=int, default=None
    )
    ap.add_argument("--feature-name-and-term-set-path", default=None)
    ap.add_argument(
        "--ladder", default=DEFAULT_LADDER_TEXT,
        help="padded micro-batch shapes, comma-separated increasing "
        f"(default {DEFAULT_LADDER_TEXT}); every shape is built (on the "
        "card: captured as a CUDA graph) at startup",
    )
    ap.add_argument(
        "--max-wait-ms", type=float, default=0.0,
        help="linger for coalescing before dispatching a partial batch "
        "(0 = continuous batching: dispatch whatever accumulated)",
    )
    ap.add_argument("--max-queue", type=int, default=4096)
    ap.add_argument(
        "--request-nnz-width", default=None,
        help="per-shard request feature width ('shard:k|shard:k' or one "
        "int for all); required for stdin, defaults to the trace's "
        "padded width for Avro replay",
    )
    ap.add_argument(
        "--mode", default="closed",
        help="closed = one request in flight (latency floor); open = "
        "--concurrency submitter threads (saturating load)",
    )
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument(
        "--swap-model-dir", default=None,
        help="stage + hot-swap this model generation mid-replay",
    )
    ap.add_argument("--swap-after-requests", type=int, default=0)
    ap.add_argument("--entity-pad-to", type=int, default=256)
    ap.add_argument("--write-scores", default="true")
    ap.add_argument("--delete-output-dir-if-exists", default="false")
    ap.add_argument("--application-name", default=None)
    ap.add_argument(
        "--no-overlap", default="false",
        help="disable the host-device overlap layer (A/B baseline)",
    )
    ap.add_argument(
        "--fault-plan", default=None,
        help="deterministic fault injection "
        "(seam:nth:error[:times], comma-separated); also via "
        "PHOTON_FAULT_PLAN",
    )
    ap.add_argument("--frontend-host", default="127.0.0.1")
    ap.add_argument(
        "--frontend-port", type=int, default=None,
        help="serve over a TCP JSON-lines front-end on this port "
        "(0 = ephemeral; the bound port is published to "
        "<output-dir>/frontend.json); SIGTERM drains and exits",
    )
    ap.add_argument(
        "--drain-timeout", type=float, default=10.0,
        help="seconds to finish pending requests on SIGTERM/Ctrl-C; "
        "leftovers fail with the named DRAIN_TIMEOUT outcome",
    )
    ap.add_argument(
        "--default-deadline-ms", type=float, default=None,
        help="deadline applied to requests that carry none of their "
        "own; enables load shedding under overload",
    )
    ap.add_argument(
        "--shard-index", type=int, default=None,
        help="serve ONE entity shard of the model (0-based) in "
        "partial-score mode for the routing tier; requires "
        "--shard-count and --frontend-port",
    )
    ap.add_argument(
        "--shard-count", type=int, default=None,
        help="total shard-servers in the fleet (the N of the "
        "entity_code %% N ownership rule)",
    )
    ap.add_argument(
        "--shard-servers", default=None,
        help="router mode: comma-separated host:port shard-servers; "
        "the trace replays through the scatter/gather tier instead of "
        "a local bank (--swap-model-dir runs the two-step fleet flip)",
    )
    ap.add_argument(
        "--hot-cache-entries", type=int, default=4096,
        help="router hot-entity cache capacity (generation-keyed LRU "
        "of partial scores; 0 disables)",
    )
    ap.add_argument(
        "--router-subrequest-timeout-ms", type=float, default=2000.0,
        help="per-shard sub-request budget for deadline-less requests",
    )
    ap.add_argument(
        "--router-hedge", default="true",
        help="hedge a slow shard once on a fresh connection inside the "
        "remaining budget before shedding it (FE-only for its "
        "entities)",
    )
    ap.add_argument(
        "--obs-dir", default=None,
        help="unified telemetry: enable request tracing + the live "
        "metrics registry + the flight recorder; trace.json / "
        "flight.json / metrics_snapshot.json land here atomically "
        "(also exposed live via the {\"op\": \"metrics\"} and "
        "{\"op\": \"flight\"} control ops)",
    )
    ap.add_argument(
        "--obs-snapshot-s", type=float, default=5.0,
        help="period of the --obs-dir metrics snapshot writer",
    )
    ap.add_argument(
        "--profile-dir", default=None,
        help="torch.profiler trace (Chrome trace-event JSON, the card's "
        "kernels included on CUDA) over the serve phase (replay, "
        "frontend and router modes) — co-captured with the --obs-dir "
        "host spans",
    )
    ap.add_argument(
        "--fleet-obs-dir", default=None,
        help="router mode: run the live fleet collector (incremental "
        "{\"op\": \"trace\"} drains over fresh connections, clock-skew "
        "normalized) and write ONE merged fleet_trace.json + "
        "fleet_conservation.json here at exit",
    )
    ap.add_argument(
        "--fleet-poll-s", type=float, default=1.0,
        help="fleet collector poll period",
    )
    ap.add_argument(
        "--slo", default=None,
        help="declarative SLOs with multi-window burn-rate alerting: "
        "inline JSON (object or list of {name, objective, kind, "
        "metric, ...}), @file, or 'default'; alerts land on the "
        "flight-recorder ring and as slo_* registry gauges",
    )
    ap.add_argument(
        "--slo-tick-s", type=float, default=1.0,
        help="SLO engine evaluation period",
    )
    ap.add_argument(
        "--wire", default="auto", choices=("json", "binary", "auto"),
        help="router data-plane protocol: binary requires every shard "
        "to advertise photon-wire framing (mismatches refused at "
        "connect), auto negotiates it fleet-wide, json pins the "
        "legacy JSON-lines plane; frontends always speak both via "
        "first-byte sniffing",
    )
    ap.add_argument(
        "--max-frame-bytes", type=int, default=None,
        help="framing cap enforced identically for JSON line lengths "
        "and binary frame lengths (default: PHOTON_MAX_FRAME_BYTES "
        "env, then 1 MiB); published in frontend.json and every "
        "status response",
    )
    ap.add_argument(
        "--registry-dir", default=None,
        help="model-registry directory: serve its latest committed "
        "generation and hot-swap newly published ones under live "
        "traffic (requires --frontend-port; the registry path is "
        "published to frontend.json)",
    )
    ap.add_argument(
        "--registry-poll-s", type=float, default=2.0,
        help="registry poll period for the generation watcher",
    )
    ap.add_argument(
        "--auto-rollback", default="true",
        help="roll back to the parent generation (bitwise) and "
        "quarantine the bad one when the post-swap health window "
        "regresses",
    )
    ap.add_argument(
        "--rollback-window", type=int, default=64,
        help="sliding window of post-swap completions judged for "
        "auto-rollback",
    )
    ap.add_argument(
        "--rollback-min-requests", type=int, default=16,
        help="minimum post-swap completions before auto-rollback can "
        "trigger",
    )
    ap.add_argument(
        "--rollback-max-unhealthy", type=float, default=0.5,
        help="auto-rollback when (degraded+shed+errors)/window exceeds "
        "this rate",
    )
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    return ap


def params_from_args(argv=None) -> ServingParams:
    ns = build_arg_parser().parse_args(argv)
    return ServingParams(
        game_model_input_dir=ns.game_model_input_dir or "",
        output_dir=ns.output_dir,
        request_paths=(
            []
            if ns.request_paths is None
            else ["-"]
            if ns.request_paths.strip() == "-"
            else ns.request_paths.split(",")
        ),
        feature_shards=apply_intercept_map(
            parse_shard_map(ns.feature_shard_id_to_feature_section_keys_map),
            ns.feature_shard_id_to_intercept_map,
        ),
        task_type=TaskType.parse(ns.task_type),
        evaluator_types=(
            [EvaluatorType.parse(s) for s in ns.evaluator_types.split(",")]
            if ns.evaluator_types
            else []
        ),
        model_id=ns.game_model_id or "",
        has_response=_bool(ns.has_response),
        offheap_indexmap_dir=ns.offheap_indexmap_dir,
        offheap_indexmap_num_partitions=ns.offheap_indexmap_num_partitions,
        feature_name_and_term_set_path=ns.feature_name_and_term_set_path,
        ladder=[int(b) for b in ns.ladder.split(",")],
        max_wait_ms=ns.max_wait_ms,
        max_queue=ns.max_queue,
        request_nnz_width=ns.request_nnz_width,
        mode=ns.mode,
        concurrency=ns.concurrency,
        swap_model_dir=ns.swap_model_dir,
        swap_after_requests=ns.swap_after_requests,
        entity_pad_to=ns.entity_pad_to,
        write_scores=_bool(ns.write_scores),
        delete_output_dir_if_exists=_bool(ns.delete_output_dir_if_exists),
        application_name=ns.application_name or "photon-ml-tpu-serving",
        no_overlap=_bool(ns.no_overlap),
        fault_plan=ns.fault_plan,
        frontend_host=ns.frontend_host,
        frontend_port=ns.frontend_port,
        drain_timeout_s=ns.drain_timeout,
        default_deadline_ms=ns.default_deadline_ms,
        max_frame_bytes=ns.max_frame_bytes,
        device=ns.device,
        shard_index=ns.shard_index,
        shard_count=ns.shard_count,
        shard_servers=ns.shard_servers,
        hot_cache_entries=ns.hot_cache_entries,
        router_subrequest_timeout_ms=ns.router_subrequest_timeout_ms,
        router_hedge=_bool(ns.router_hedge),
        obs_dir=ns.obs_dir,
        obs_snapshot_s=ns.obs_snapshot_s,
        profile_dir=ns.profile_dir,
        fleet_obs_dir=ns.fleet_obs_dir,
        fleet_poll_s=ns.fleet_poll_s,
        slo=ns.slo,
        slo_tick_s=ns.slo_tick_s,
        wire=ns.wire,
        registry_dir=ns.registry_dir,
        registry_poll_s=ns.registry_poll_s,
        auto_rollback=_bool(ns.auto_rollback),
        rollback_window=ns.rollback_window,
        rollback_min_requests=ns.rollback_min_requests,
        rollback_max_unhealthy=ns.rollback_max_unhealthy,
    )


def main(argv=None) -> "ServingDriver":
    driver = ServingDriver(params_from_args(argv))
    driver.run()
    return driver


if __name__ == "__main__":
    main()
