"""Online scoring driver: load a GAME model into a device-resident bank
and serve score requests through the micro-batched request path (port
of ``photon_ml_tpu/cli/serving_driver.py``, the single-server modes).

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

Lifecycle: SIGTERM (or Ctrl-C) anywhere stops admitting, drains the
batcher within ``--drain-timeout`` (leftover futures fail with the
named ``DRAIN_TIMEOUT`` outcome — never a hang), drains async IO, and
writes metrics.json with an ``interrupted`` marker so a partial run
still accounts for everything it did.

The port adds ``--device`` (the card by default, ``cpu`` on request).
The shard-server and router modes and the fleet collector wait for
ROADMAP item 14; the registry watcher, ``--obs-dir``, ``--profile-dir``
and the SLO engine for item 15: their options raise, naming the item.
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

# The options of the JAX driver whose paths the port lacks: the field of
# ServingParams, the option, the ROADMAP item. Each defaults to None, so
# giving one at all refuses the run.
_UNPORTED = (
    ("shard_index", "--shard-index", "item 14"),
    ("shard_count", "--shard-count", "item 14"),
    ("shard_servers", "--shard-servers", "item 14"),
    ("hot_cache_entries", "--hot-cache-entries", "item 14"),
    ("router_subrequest_timeout_ms", "--router-subrequest-timeout-ms", "item 14"),
    ("router_hedge", "--router-hedge", "item 14"),
    ("fleet_obs_dir", "--fleet-obs-dir", "item 14"),
    ("fleet_poll_s", "--fleet-poll-s", "item 14"),
    ("wire", "--wire", "item 14"),
    ("registry_dir", "--registry-dir", "item 15"),
    ("registry_poll_s", "--registry-poll-s", "item 15"),
    ("auto_rollback", "--auto-rollback", "item 15"),
    ("rollback_window", "--rollback-window", "item 15"),
    ("rollback_min_requests", "--rollback-min-requests", "item 15"),
    ("rollback_max_unhealthy", "--rollback-max-unhealthy", "item 15"),
    ("obs_dir", "--obs-dir", "item 15"),
    ("obs_snapshot_s", "--obs-snapshot-s", "item 15"),
    ("profile_dir", "--profile-dir", "item 15"),
    ("slo", "--slo", "item 15"),
    ("slo_tick_s", "--slo-tick-s", "item 15"),
)


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
    # (raises without one), "cpu" on request
    device: Optional[str] = None
    # Options of paths not ported yet (_UNPORTED): None unless given.
    shard_index: Optional[int] = None
    shard_count: Optional[int] = None
    shard_servers: Optional[str] = None
    hot_cache_entries: Optional[int] = None
    router_subrequest_timeout_ms: Optional[float] = None
    router_hedge: Optional[bool] = None
    fleet_obs_dir: Optional[str] = None
    fleet_poll_s: Optional[float] = None
    wire: Optional[str] = None  # the router's data-plane protocol
    registry_dir: Optional[str] = None
    registry_poll_s: Optional[float] = None
    auto_rollback: Optional[bool] = None
    rollback_window: Optional[int] = None
    rollback_min_requests: Optional[int] = None
    rollback_max_unhealthy: Optional[float] = None
    obs_dir: Optional[str] = None
    obs_snapshot_s: Optional[float] = None
    profile_dir: Optional[str] = None
    slo: Optional[str] = None
    slo_tick_s: Optional[float] = None

    @property
    def stdin_mode(self) -> bool:
        return self.request_paths == ["-"]

    @property
    def frontend_mode(self) -> bool:
        return self.frontend_port is not None

    def unported(self) -> List[str]:
        """The options set here whose paths the port lacks, each with the
        ROADMAP item it waits for."""
        return [
            f"{opt} (ROADMAP {item})"
            for name, opt, item in _UNPORTED
            if getattr(self, name) is not None
        ]

    def validate(self) -> None:
        unported = self.unported()
        if unported:
            raise NotImplementedError(
                "not ported to photon_ml_tpu_torch yet: " + "; ".join(unported)
            )
        if self.max_frame_bytes is not None and self.max_frame_bytes <= 0:
            raise ValueError("--max-frame-bytes must be positive")
        if not self.game_model_input_dir:
            raise ValueError("game-model-input-dir is required")
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


class ServingDriver:
    def __init__(self, params: ServingParams, logger=None):
        params.validate()
        self.params = params
        self.device = resolve_device(params.device)
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
        with self.timer.time("load-model"):
            loaded = load_model_artifact(p.game_model_input_dir)
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
                device=self.device,
            )
        with self.timer.time("warmup-programs"):
            self.serving_model = ServingModel(
                bank, ServingPrograms(tuple(p.ladder))
            )
        self.logger.info(
            "bank generation %d staged: %d coordinate(s), %.1f MiB on "
            "%s, ladder %s built (%d program(s))",
            bank.generation,
            len(bank.spec),
            bank.device_bytes() / (1 << 20),
            self.device,
            tuple(p.ladder),
            self.serving_model.programs.stats()["compiled_programs"],
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
        return extra

    def run(self) -> None:
        from photon_ml_tpu_torch.parallel import overlap
        from photon_ml_tpu_torch.serving import MicroBatcher, ServingMetrics

        p = self.params
        self.logger.info("application: %s", p.application_name)
        requests = self._build()
        self.metrics = ServingMetrics()
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

        prev = self._install_signal_handlers(_interrupt)
        scored = []
        try:
            try:
                with self.timer.time("serve"):
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
        self.metrics.write(
            os.path.join(p.output_dir, "metrics.json"),
            extra=extra,
        )
        self.results = [s for _, outcome, s in scored if outcome == "ok"]
        self.logger.info("timers:\n%s", self.timer.summary())

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
        )
        frontend.start()
        atomic_write_json(
            os.path.join(p.output_dir, "frontend.json"),
            {  # photon: entropy(discovery artifact; pid names the live process for operators)
                "host": p.frontend_host,
                "port": frontend.port,
                "pid": os.getpid(),
                # no registry watcher and no shard topology in the port
                # yet (ROADMAP items 15 and 14): the keys stay, as null
                "registry": None,
                "shard": None,
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
        try:
            try:
                while not shutdown.wait(timeout=0.2):
                    pass
            except KeyboardInterrupt:
                pass
            self.interrupted = True
            with self.timer.time("drain"):
                frontend.stop_accepting()
                self.drain_report = batcher.drain(p.drain_timeout_s)
                frontend.close()
        finally:
            self._restore_signal_handlers(prev)
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
        self.metrics.write(
            os.path.join(p.output_dir, "metrics.json"),
            extra=extra,
        )
        self.logger.info("timers:\n%s", self.timer.summary())


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="photon-ml-tpu-torch serving")
    ap.add_argument("--game-model-input-dir", default=None,
                    help="GAME model artifact to serve")
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
        "--max-frame-bytes", type=int, default=None,
        help="framing cap enforced identically for JSON line lengths "
        "and binary frame lengths (default: PHOTON_MAX_FRAME_BYTES "
        "env, then 1 MiB); published in frontend.json and every "
        "status response",
    )
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    # the JAX driver's options whose paths are not ported yet: accepted
    # by name so that giving one refuses the run, naming its ROADMAP item
    for _name, opt, item in _UNPORTED:
        ap.add_argument(opt, default=None,
                        help=f"not ported yet (ROADMAP {item}); raises")
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
        **{name: getattr(ns, name) for name, _opt, _item in _UNPORTED},
    )


def main(argv=None) -> "ServingDriver":
    driver = ServingDriver(params_from_args(argv))
    driver.run()
    return driver


if __name__ == "__main__":
    main()
