"""Shard-server extensions to the serving frontend: one scorer of ONE
entity shard, speaking the routing tier's control plane (a copy of
``photon_ml_tpu/serving/shard_server.py`` over the port's batcher, front
end and CUDA-graph programs).

A shard-server is the EXISTING MicroBatcher/ServingModel/frontend stack
with three twists, all additive:

- its model bank holds one entity shard
  (``build_model_bank(entity_shard=(s, N))`` — the shared ownership
  rule, :mod:`photon_ml_tpu_torch.ownership`), so its random-effect banks are
  ``1/N`` of the model and every off-shard entity resolves to the
  FE-only row;
- its batcher runs in PARTIAL mode (``ServingModel(partial=True)``):
  dispatches run the scatter/gather program family and score lines
  answer ``{"fe": …, "terms": {…}}`` halves instead of full margins;
- it exposes the router's control ops: ``topology`` (shard index/count,
  ownership rule, spec term entries, generation — everything the router
  needs to discover the fleet layout without out-of-band config) and
  the two-step flip ``stage_swap`` / ``commit_swap`` / ``abort_swap``
  (:meth:`~.swap.ServingModel.prepare_swap` /
  :meth:`~.swap.ServingModel.commit_prepared`), so the router can stage
  a new generation fleet-wide and only flip when EVERY shard staged OK.

The same topology block rides every ``status`` response and the
driver's ``frontend.json``, so operators discover the layout the same
way the router does.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from photon_ml_tpu_torch import ownership
from photon_ml_tpu_torch.serving import wire
from photon_ml_tpu_torch.serving.batcher import MicroBatcher
from photon_ml_tpu_torch.serving.frontend import ServingFrontend
from photon_ml_tpu_torch.serving.metrics import ServingMetrics
from photon_ml_tpu_torch.serving.programs import term_entries
from photon_ml_tpu_torch.serving.swap import ServingModel

__all__ = [
    "shard_topology",
    "make_shard_ops",
    "ShardServer",
]


def shard_topology(
    serving_model: ServingModel,
    entity_shard: Tuple[int, int],
) -> Dict[str, object]:
    """The topology payload: everything a router (or operator) needs to
    place requests on this fleet without out-of-band configuration."""
    s, n = ownership.validate_entity_shard(entity_shard)
    bank = serving_model.current()
    return {
        "shard_index": s,
        "shard_count": n,
        "rule": ownership.OWNERSHIP_RULE,
        "generation": bank.generation,
        "entries": [
            [kind, name, list(types), shard]
            for kind, name, types, shard in term_entries(bank.spec)
        ],
        "re_types": list(bank.re_types),
        "partial": serving_model.partial,
        "ready": serving_model.ready(),
        # wire advertisement: the router negotiates the data plane from
        # this block at connect() — a shard without it is JSON-only
        "wire": {
            "protocols": list(wire.WIRE_PROTOCOLS),
            "version": wire.WIRE_VERSION,
        },
    }


def make_shard_ops(
    serving_model: ServingModel,
    entity_shard: Tuple[int, int],
    *,
    stager: Optional[Callable[[Dict], object]] = None,
    swap_kwargs: Optional[Dict[str, object]] = None,
) -> Dict[str, Callable[[Dict], Dict]]:
    """The extra control ops a shard-server frontend serves. Every
    handler echoes the request's uid (routed control responses demux by
    it). ``stager`` overrides how ``stage_swap`` builds the next
    generation (synthetic fleets stage from arrays); the
    default loads ``model_dir`` through
    :meth:`~.swap.ServingModel.prepare_swap` — which re-slices the SAME
    entity shard this server owns."""
    kwargs = dict(swap_kwargs or {})

    def _swap_response(obj: Dict, op: str, res) -> Dict:
        return {
            "uid": obj.get("uid"),
            "status": "ok" if res.ok else "error",
            "op": op,
            "ok": res.ok,
            "generation": res.generation,
            "donated": res.donated,
            "error": res.error,
        }

    def topology(obj: Dict) -> Dict:
        out = shard_topology(serving_model, entity_shard)
        out.update({"uid": obj.get("uid"), "status": "ok",
                    "op": "topology"})
        return out

    def stage_swap(obj: Dict) -> Dict:
        if stager is not None:
            res = stager(obj)
        else:
            model_dir = obj.get("model_dir")
            if not model_dir:
                return {
                    "uid": obj.get("uid"),
                    "status": "error",
                    "error": "BAD_REQUEST",
                    "message": "stage_swap needs model_dir",
                }
            res = serving_model.prepare_swap(str(model_dir), **kwargs)
        return _swap_response(obj, "stage_swap", res)

    def commit_swap(obj: Dict) -> Dict:
        return _swap_response(
            obj, "commit_swap", serving_model.commit_prepared()
        )

    def abort_swap(obj: Dict) -> Dict:
        return {
            "uid": obj.get("uid"),
            "status": "ok",
            "op": "abort_swap",
            "aborted": serving_model.abort_prepared(),
        }

    return {
        "topology": topology,
        "stage_swap": stage_swap,
        "commit_swap": commit_swap,
        "abort_swap": abort_swap,
    }


class ShardServer:
    """One in-process shard-serving stack (tests, synthetic fleets, and the
    driver's ``--shard-index`` mode all assemble exactly this): a
    partial-mode batcher over one entity shard's bank, fronted by the
    TCP frontend with the shard control ops attached."""

    def __init__(
        self,
        serving_model: ServingModel,
        shard_configs,
        entity_shard: Tuple[int, int],
        *,
        metrics: Optional[ServingMetrics] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        stager: Optional[Callable[[Dict], object]] = None,
        swap_kwargs: Optional[Dict[str, object]] = None,
        has_response: bool = True,
        max_queue: int = 4096,
        default_deadline_ms: Optional[float] = None,
        on_outcome=None,
        recorder=None,
        max_frame_bytes: Optional[int] = None,
    ):
        if not serving_model.partial:
            raise ValueError(
                "a shard-server needs a partial-mode ServingModel "
                "(ServingModel(..., partial=True)): the router sums "
                "per-coordinate terms, not full margins"
            )
        self.entity_shard = ownership.validate_entity_shard(entity_shard)
        self.serving_model = serving_model
        self.metrics = metrics or ServingMetrics()
        # recorder: this shard's conservation ledger — in-process
        # fleets (tests, synthetic fleets) give every member its OWN book so the
        # fleet-wide check can join them; subprocess shards default to
        # their process recorder
        self.batcher = MicroBatcher(
            serving_model.current,
            serving_model.programs,
            self.metrics,
            max_queue=max_queue,
            default_deadline_ms=default_deadline_ms,
            recorder=recorder,
        )
        self.frontend = ServingFrontend(
            self.batcher,
            serving_model,
            shard_configs,
            metrics=self.metrics,
            host=host,
            port=port,
            has_response=has_response,
            max_frame_bytes=max_frame_bytes,
            on_outcome=on_outcome,
            extra_ops=make_shard_ops(
                serving_model,
                self.entity_shard,
                stager=stager,
                swap_kwargs=swap_kwargs,
            ),
            status_extra=lambda: {
                "shard": shard_topology(serving_model, self.entity_shard)
            },
        )

    @property
    def port(self) -> int:
        return self.frontend.port

    def start(self) -> "ShardServer":
        self.frontend.start()
        return self

    def close(self, drain_timeout_s: float = 5.0):
        """Drain-ordered teardown (the frontend's SIGTERM protocol)."""
        self.frontend.stop_accepting()
        report = self.batcher.drain(drain_timeout_s)
        self.frontend.close()
        self.batcher.close()
        return report
