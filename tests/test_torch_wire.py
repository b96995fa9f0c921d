"""photon-wire in the port (``photon_ml_tpu_torch/serving/wire.py``): for
the same records the port's encoder writes the JAX package's bytes, each
package decodes the other's frames to the same objects, every malformed
payload is a named refusal, and the port's front end speaks the binary
framing beside JSON lines on one port with scores bitwise the batch
scorer's."""

import json
import struct

import numpy as np
import pytest

from photon_ml_tpu.serving import PartialScore as RefPartialScore
from photon_ml_tpu.serving import wire as ref_wire
from photon_ml_tpu_torch.game.data import build_game_dataset
from photon_ml_tpu_torch.serving import (
    MicroBatcher,
    PartialScore,
    ServingFrontend,
    ServingMetrics,
    ServingModel,
    ServingPrograms,
)
from photon_ml_tpu_torch.serving import wire
from torch_serving_cases import (
    SHARDS,
    batch_reference_scores,
    make_bank,
    synth_model,
    synth_records,
)


def _hdr(obj, tail=b""):
    hj = json.dumps(obj).encode("utf-8")
    return struct.pack("<I", len(hj)) + hj + tail


def _records():
    rng = np.random.default_rng(7)
    return [
        {
            "uid": "q1", "deadline_ms": 250.0,
            "metadataMap": {"userId": "user3"},
            "features": [
                {"name": f"g{i}", "term": "", "value": float(v)}
                for i, v in enumerate(rng.standard_normal(8))
            ],
            "userFeatures": [{"name": "u0", "term": "t", "value": -1.5}],
        },
        {"uid": "q2", "features": [{"name": "a", "term": "", "value": 1.5, "extra": 2}]},
        {"uid": "q3", "features": [{"name": "a", "value": 1.5}]},
        {"uid": "q4", "features": [{"name": "a\x1fb", "term": "", "value": 1.5}]},
        {"uid": "q5", "features": [{"name": 3, "term": "", "value": 1.5}]},
        {"uid": "q6", "features": [{"name": "a", "term": "", "value": True}]},
        {"uid": "q7", "features": [{"name": "a", "term": "", "value": "str"}]},
        {"uid": "q8", "features": [{"name": "a", "term": "", "value": 2 ** 400}]},
        {"uid": "q9", "features": [{"name": "a", "term": "", "value": 7}]},
        {"uid": "q10", "features": ["not-a-dict"]},
        {"uid": "q11", "features": []},
        {"uid": "q12", "trace_id": "t1-2", "parent_span": "s3", "offset": 0.25,
         "features": [{"name": "x", "term": "y", "value": float(np.float32(0.1))}]},
    ]


def _responses(partial_cls):
    names = ("per-user", "per-item")
    ps = partial_cls.from_vector(
        float(np.float32(0.7)), names,
        np.asarray([0.25, -1.125], dtype=np.float32), generation=2,
    )
    return [
        {"uid": "q", "status": "ok", "score": float(np.float32(0.1)),
         "degraded": False, "generation": 3},
        {"uid": "q", "status": "ok", "partial": True, "generation": 2,
         "degraded": False, "_wire_partial": ps},
        {"uid": "t", "status": "ok", "op": "trace", "cursor": 9, "dropped": 0,
         "spans": [
             {"seq": 1, "name": "a", "t0": 1.25, "t1": 2.5},
             {"seq": 2, "name": "b", "t0": 3.125, "t1": None},
         ]},
        {"uid": "q", "status": "error", "error": "BAD_REQUEST", "message": "nope"},
        {"status": "ok", "op": "status", "ready": True, "alive": True},
    ]


class TestBytesMatchTheReference:
    @pytest.mark.parametrize("i", range(12))
    def test_score_request_bytes(self, i):
        rec = _records()[i]
        ours, theirs = bytearray(), bytearray()
        wire.append_score_request(ours, rec)
        ref_wire.append_score_request(theirs, rec)
        assert bytes(ours) == bytes(theirs)
        # and each package decodes the other's frame to one object
        frame = wire.FrameDecoder().feed(bytes(theirs))[0]
        ref_frame = ref_wire.FrameDecoder().feed(bytes(ours))[0]
        assert wire.decode_message(*frame) == ref_wire.decode_message(*ref_frame)
        assert wire.decode_message(*frame) == json.loads(json.dumps(rec))

    @pytest.mark.parametrize("i", range(5))
    def test_response_bytes(self, i):
        ours, theirs = bytearray(), bytearray()
        wire.append_response(ours, _responses(PartialScore)[i])
        ref_wire.append_response(theirs, _responses(RefPartialScore)[i])
        assert bytes(ours) == bytes(theirs)
        (mtype, payload), = wire.FrameDecoder().feed(bytes(ours))
        assert wire.decode_message(mtype, payload) == ref_wire.decode_message(mtype, payload)

    def test_json_frames_and_constants(self):
        ours, theirs = bytearray(), bytearray()
        for obj in ({"op": "status"}, {"op": "metrics", "x": [1, 2.5, None]}):
            wire.append_json(ours, obj)
            ref_wire.append_json(theirs, obj)
        assert bytes(ours) == bytes(theirs)
        for name in ("MAGIC", "WIRE_VERSION", "WIRE_PROTOCOLS", "DEFAULT_MAX_FRAME_BYTES",
                     "MSG_JSON", "MSG_SCORE_REQUEST", "MSG_SCORE_RESPONSE",
                     "MSG_PARTIAL_RESPONSE", "MSG_TRACE_RESPONSE"):
            assert getattr(wire, name) == getattr(ref_wire, name), name


# malformed payloads, keyed by every MSG_* type of the port's wire module
# (the port's PL018 checks the keys against the module's inventory)
WIRE_FUZZ_CORPUS = {
    wire.MSG_JSON: [b"{", b"[1, 2]", b"\xff\xfe\x00"],
    wire.MSG_SCORE_REQUEST: [
        struct.pack("<I", 999) + b"{}",
        _hdr({"_wire_bags": "nope"}),
        _hdr({"features": [{"name": "a"}], "_wire_bags": {"features": 1}}, b"\x00" * 4),
    ],
    wire.MSG_SCORE_RESPONSE: [b"\x00", _hdr({})],
    wire.MSG_PARTIAL_RESPONSE: [_hdr({}), _hdr({"names": ["a", "b"]}, b"\x00" * 4)],
    wire.MSG_TRACE_RESPONSE: [
        _hdr({}), _hdr({"spans": [{}]}), _hdr({"spans": [1]}, b"\x00" * 16),
    ],
}
FUZZ = WIRE_FUZZ_CORPUS


class TestWireFuzzCorpus:
    """The WIRE_FUZZ_CORPUS contract, runtime half (after the reference's
    ``tests/test_wire.py``): the port's PL018 proves the corpus keys track
    wire.py's MSG_* inventory; these prove every payload is refused by
    both packages' codecs alike, bare and through their framing."""

    def test_corpus_covers_every_message_type(self):
        inventory = {
            v for k, v in vars(wire).items() if k.startswith("MSG_") and isinstance(v, int)
        }
        assert set(WIRE_FUZZ_CORPUS) == inventory
        assert len(inventory) == sum(1 for k in vars(wire) if k.startswith("MSG_"))
        ref_inventory = {
            v for k, v in vars(ref_wire).items() if k.startswith("MSG_") and isinstance(v, int)
        }
        assert inventory == ref_inventory

    def test_every_payload_is_the_same_refusal_in_both_codecs(self):
        for mtype, payloads in WIRE_FUZZ_CORPUS.items():
            assert payloads, f"empty corpus list for 0x{mtype:02x}"
            for payload in payloads:
                with pytest.raises(wire.WireError) as ours:
                    wire.decode_message(mtype, payload)
                with pytest.raises(ref_wire.WireError) as theirs:
                    ref_wire.decode_message(mtype, payload)
                assert (ours.value.kind, str(ours.value)) == (theirs.value.kind, str(theirs.value))

    def test_corpus_payloads_survive_framing_then_refuse(self):
        for mtype, payloads in WIRE_FUZZ_CORPUS.items():
            for payload in payloads:
                buf, ref_buf = bytearray(), bytearray()
                wire.append_frame(buf, mtype, payload)
                ref_wire.append_frame(ref_buf, mtype, payload)
                assert bytes(buf) == bytes(ref_buf)
                for codec in (wire, ref_wire):
                    frames = codec.FrameDecoder().feed(bytes(buf))
                    assert len(frames) == 1
                    got_type, got_payload = frames[0]
                    assert (got_type, bytes(got_payload)) == (mtype, payload)
                    with pytest.raises(codec.WireError):
                        codec.decode_message(got_type, got_payload)


class TestRefusals:
    @pytest.mark.parametrize("mtype,payload", [
        (m, p) for m, ps in FUZZ.items() for p in ps
    ])
    def test_malformed_payloads_are_named_refusals(self, mtype, payload):
        with pytest.raises(wire.WireError) as ours:
            wire.decode_message(mtype, payload)
        with pytest.raises(ref_wire.WireError) as theirs:
            ref_wire.decode_message(mtype, payload)
        assert ours.value.kind == theirs.value.kind

    def test_decoder_named_failures_and_streaming(self):
        dec = wire.FrameDecoder(max_frame_bytes=1024)
        with pytest.raises(wire.WireError, match="framing lost"):
            dec.feed(b"\x00" * 7)
        giant = struct.pack("<BBBI", wire.MAGIC, wire.WIRE_VERSION, wire.MSG_JSON, 1 << 30)
        with pytest.raises(wire.WireError, match="exceeds") as ei:
            wire.FrameDecoder(max_frame_bytes=1024).feed(giant)
        assert ei.value.kind == "oversized"
        buf = bytearray()
        wire.append_json(buf, {"op": "status"})
        wire.append_json(buf, {"op": "metrics"})
        dec = wire.FrameDecoder()
        out = []
        for i in range(len(buf)):
            out.extend(dec.feed(bytes(buf[i:i + 1])))
        assert [m for m, _ in out] == [wire.MSG_JSON, wire.MSG_JSON]
        assert dec.pending_bytes == 0

    def test_resolve_max_frame_bytes(self, monkeypatch):
        monkeypatch.delenv(wire.MAX_FRAME_BYTES_ENV, raising=False)
        assert wire.resolve_max_frame_bytes() == wire.DEFAULT_MAX_FRAME_BYTES
        monkeypatch.setenv(wire.MAX_FRAME_BYTES_ENV, "4096")
        assert wire.resolve_max_frame_bytes() == 4096
        assert wire.resolve_max_frame_bytes(512) == 512
        with pytest.raises(ValueError, match="positive"):
            wire.resolve_max_frame_bytes(0)


class TestBinaryFrontEnd:
    @pytest.fixture
    def front(self, rng):
        recs = synth_records(rng)
        ds = build_game_dataset(recs, SHARDS, ["userId"], device="cpu")
        lm = synth_model(rng)
        sm = ServingModel(make_bank(lm, ds), ServingPrograms((1, 8)))
        metrics = ServingMetrics()
        batcher = MicroBatcher(sm.current, sm.programs, metrics)
        fe = ServingFrontend(batcher, sm, SHARDS, metrics=metrics, port=0).start()
        yield recs, ds, lm, fe
        fe.stop_accepting()
        batcher.drain(10.0)
        fe.close()
        batcher.close()

    def test_binary_and_json_clients_score_bitwise(self, front):
        import socket

        recs, ds, lm, fe = front
        ref = batch_reference_scores(lm, ds)
        with socket.create_connection(("127.0.0.1", fe.port), timeout=15) as sock:
            buf = bytearray()
            for i in (0, 5, 17):
                wire.append_score_request(buf, recs[i])
            wire.append_json(buf, {"op": "status"})
            sock.sendall(bytes(buf))
            dec = wire.FrameDecoder()
            frames = []
            while len(frames) < 4:
                frames.extend(dec.feed(sock.recv(1 << 16)))
        got = [wire.decode_message(*f) for f in frames]
        by_uid = {g["uid"]: g for g in got if "uid" in g}
        for i in (0, 5, 17):
            assert by_uid[recs[i]["uid"]]["status"] == "ok"
            assert np.float32(by_uid[recs[i]["uid"]]["score"]) == ref[i]
        status = [g for g in got if g.get("op") == "status"][0]
        assert status["wire"]["protocols"] == list(wire.WIRE_PROTOCOLS)
        with socket.create_connection(("127.0.0.1", fe.port), timeout=15) as sock:
            sock.sendall((json.dumps(recs[5]) + "\n").encode())
            line = sock.makefile("rb").readline()
        assert np.float32(json.loads(line)["score"]) == ref[5]
