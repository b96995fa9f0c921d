"""Artifact targets for the twin-run determinism harness (port of
``photon_ml_tpu/testing/determinism_targets.py``).

One callable per artifact CLASS the port ships, each driving the port's
real production writer (never a test-only reimplementation) with fixed
inputs that deliberately flow through hash-ordered containers — so a
writer that forgets to sort diverges under the harness's twin
``PYTHONHASHSEED`` runs. The classes:

- ``metrics_json``     — the run-summary/metrics JSON family
  (``reliability.atomic_write_json``)
- ``wire_frames``      — one frame of every photon-wire message family
  (MSG_JSON, score request/response, partial response, trace response)
- ``registry_publish`` — a full registry publish: staged model copy,
  manifest, content signature, COMMIT marker
- ``avro_container``   — an Avro object container (deterministic sync
  marker contract from ``io.avro_codec``)
- ``fleet_trace``      — the merged fleet timeline
  (``obs.fleet.export_fleet_trace``) over fixed stitched spans

The reference's sixth class, ``sharding_md``, is not ported: it renders
the JAX lint's ``SHARDING.md`` through the reference's ``lint`` package,
and the lint stays the reference's tool (ROADMAP, "Not ported on
purpose").

Every target is host code and makes no CUDA context.

``CONTROL_TARGETS`` holds the harness's positive control: a writer that
is hash-order dependent ON PURPOSE. It must DIVERGE under the twin run
— a harness that passes it is broken. It is excluded from the gate
matrix (``TARGETS``) for exactly that reason.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

__all__ = ["ALL_TARGETS", "CONTROL_TARGETS", "TARGETS"]


def target_metrics_json(out: str) -> None:
    from photon_ml_tpu_torch.reliability import atomic_write_json
    from photon_ml_tpu_torch.reliability.retry import reliability_metrics

    # seam names enter as a SET: the writer below only produces stable
    # bytes because the payload sorts them — exactly the discipline
    # PL015 enforces on the production metrics writers
    seams = {"chunk_read", "spill_write", "ckpt_save", "serving.dispatch"}
    payload = {
        "round": {"name": "determinism-harness", "artifact": "metrics"},
        "seams": sorted(seams),
        "reliability": reliability_metrics(),
    }
    atomic_write_json(os.path.join(out, "metrics.json"), payload)


class _FixedPartial:
    """The two-method surface ``wire.append_response`` needs from a
    PartialScore carrier, with fixed values."""

    fe = 0.5

    def term_vector(self):
        import numpy as np

        return ["geo:us", "item:42"], np.asarray(
            [0.25, -0.75], dtype="<f4"
        )


def target_wire_frames(out: str) -> None:
    from photon_ml_tpu_torch.serving import wire

    buf = bytearray()
    # MSG_JSON: shard names enter as a set, sorted at the seam
    wire.append_json(
        buf,
        {"op": "status", "shards": sorted({"shard-1", "shard-0"})},
    )
    # MSG_SCORE_REQUEST: a columnar bag + scalar fields
    wire.append_score_request(
        buf,
        {
            "uid": 7,
            "features": [
                {"name": "f0", "term": "", "value": 1.5},
                {"name": "f1", "term": "t", "value": -2.25},
            ],
        },
    )
    # MSG_SCORE_RESPONSE
    wire.append_response(
        buf, {"status": "ok", "uid": 7, "score": 0.125}
    )
    # MSG_PARTIAL_RESPONSE
    wire.append_response(
        buf, {"status": "ok", "uid": 8, "_wire_partial": _FixedPartial()}
    )
    # MSG_TRACE_RESPONSE, one finished + one unfinished span
    wire.append_response(
        buf,
        {
            "op": "trace",
            "status": "ok",
            "spans": [
                {
                    "name": "serving.score",
                    "trace_id": "t1",
                    "span_id": "s1",
                    "parent_id": None,
                    "t0": 1.0,
                    "t1": 1.5,
                    "tid": 3,
                    "seq": 1,
                    "attrs": {"generation": 4},
                },
                {
                    "name": "serving.dispatch",
                    "trace_id": "t1",
                    "span_id": "s2",
                    "parent_id": "s1",
                    "t0": 1.1,
                    "t1": None,
                    "tid": 3,
                    "seq": 2,
                    "attrs": {},
                },
            ],
            "cursor": 2,
            "dropped": 0,
            "epoch": [0.0, 0.0],
        },
    )
    from photon_ml_tpu_torch.reliability import atomic_write_bytes

    atomic_write_bytes(os.path.join(out, "frames.bin"), bytes(buf))


def target_registry_publish(out: str) -> None:
    from photon_ml_tpu_torch.registry.registry import ModelRegistry

    from photon_ml_tpu_torch.reliability import atomic_write_json

    src = os.path.join(out, "candidate")
    os.makedirs(src, exist_ok=True)
    atomic_write_json(
        os.path.join(src, "model.json"),
        {"coefficients": [0.1, -0.2, 0.3], "intercept": 0.05},
    )
    reg = ModelRegistry(os.path.join(out, "registry"))
    reg.publish(
        src,
        data_ranges={"train": "2026-01"},
        gate_report={"verdict": "PASS", "checks": ["auc"]},
    )


def target_avro_container(out: str) -> None:
    from photon_ml_tpu_torch.io.avro_codec import write_container

    schema = {
        "type": "record",
        "name": "Pair",
        "fields": [
            {"name": "name", "type": "string"},
            {"name": "value", "type": "double"},
        ],
    }
    records = [{"name": f"f{i}", "value": i * 0.5} for i in range(16)]
    write_container(os.path.join(out, "pairs.avro"), schema, records)


def target_fleet_trace(out: str) -> None:
    from photon_ml_tpu_torch.obs.fleet import export_fleet_trace

    stitched = [
        {
            "name": "serving.score",
            "trace_id": "t9",
            "span_id": "shard-0.s1",
            "parent_id": None,
            "t0": 10.0,
            "t1": 10.5,
            "tid": 1,
            "seq": 1,
            "member": "shard-0",
            "attrs": {"generation": 2},
        },
        {
            "name": "serving.dispatch",
            "trace_id": "t9",
            "span_id": "shard-1.s1",
            "parent_id": "shard-0.s1",
            "t0": 10.1,
            "t1": 10.4,
            "tid": 2,
            "seq": 1,
            "member": "shard-1",
            "attrs": {},
        },
    ]
    member_status = {
        "shard-0": {"polls": 3, "offset_s": 0.0},
        "shard-1": {"polls": 3, "offset_s": 0.001},
    }
    export_fleet_trace(
        os.path.join(out, "fleet_trace.json"),
        stitched,
        member_status=member_status,
        extra={"round": "determinism-harness"},
    )


def control_hash_order(out: str) -> None:
    """POSITIVE CONTROL — intentionally hash-order dependent: string
    set iteration order follows PYTHONHASHSEED, and nothing here sorts
    it. The harness MUST report this one as diverged; see
    test_determinism_harness.py."""
    keys = {f"key-{i}" for i in range(64)}
    path = os.path.join(out, "control.txt")
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        for k in keys:
            fh.write(k + "\n")
    os.replace(tmp, path)


TARGETS: Dict[str, Callable[[str], None]] = {
    "metrics_json": target_metrics_json,
    "wire_frames": target_wire_frames,
    "registry_publish": target_registry_publish,
    "avro_container": target_avro_container,
    "fleet_trace": target_fleet_trace,
}

CONTROL_TARGETS: Dict[str, Callable[[str], None]] = {
    "control_hash_order": control_hash_order,
}

ALL_TARGETS: Dict[str, Callable[[str], None]] = {
    **TARGETS,
    **CONTROL_TARGETS,
}
