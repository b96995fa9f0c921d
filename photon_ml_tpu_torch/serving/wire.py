"""photon-wire: the length-prefixed binary wire plane for the serving
fleet (a copy of ``photon_ml_tpu/serving/wire.py``, which imports nothing
of JAX; its bytes equal the reference encoder's).

Every frame is ``MAGIC(1) | VERSION(1) | TYPE(1) | u32-LE LEN(4) |
PAYLOAD(LEN)``. The magic byte (0xF7) is not a legal first byte of any
JSON-lines request (JSON text starts with ``{``, whitespace, or other
ASCII), so the frontend sniffs the FIRST byte of a connection and keeps
speaking JSON-lines to old clients on the same port — the two protocols
coexist per-connection, never per-frame.

Payload shapes (all multi-byte integers little-endian, all float
buffers raw little-endian numpy — decoded with ``np.frombuffer``,
never per-float text):

- ``MSG_JSON``: a UTF-8 JSON object. Control ops, errors, and anything
  without a hot-path codec ride binary connections inside this frame
  type; the framing win (no ``\\n`` scanning, one length read) still
  applies.
- ``MSG_SCORE_REQUEST``: ``u32 hdr_len | JSON header | f64-LE values``.
  The header is the score record with each feature bag's ``value``
  floats stripped out (bag name -> count recorded under ``_wire_bags``,
  in header order); the tail carries every stripped value as raw f64 —
  the lossless twin of JSON's shortest-round-trip double, so decoded
  requests are byte-identical inputs to the batcher. Bags whose every
  entry is exactly ``{"name", "term", "value"}`` additionally go
  COLUMNAR (``_wire_cols``): names and terms ride as two
  ``\\x1f``-joined strings instead of per-entry JSON objects, so the
  header encode/decode never touches a per-feature dict on the hot
  path.
- ``MSG_SCORE_RESPONSE``: ``u32 hdr_len | JSON header | f32-LE[1]``.
  The header is the ok-response without ``score``; the tail is the
  score's exact f32 bits (``float(np.float32(x))`` round-trips to the
  same double the JSON path prints).
- ``MSG_PARTIAL_RESPONSE``: ``u32 hdr_len | JSON header |
  f32-LE[1 + n_terms]``. The header carries ``names`` (term order);
  the tail is ``[fe, terms...]`` — one buffer copy out of the
  vectorized :meth:`PartialScore.term_vector`, never a per-float dict.
- ``MSG_TRACE_RESPONSE``: ``u32 hdr_len | JSON header |
  f64-LE[2 * n_spans]``. The header is the trace-drain payload with
  each span's ``t0``/``t1`` stripped; the tail interleaves them
  (``NaN`` encodes an unfinished span's ``t1 = None``).

Decode failures raise :class:`WireError` with a ``kind`` the frontend
maps onto the SAME named refusals the JSON path uses (``oversized``
for giant lengths, ``malformed`` for everything else) — a lying length
is a BAD_REQUEST, never a crash or a stuck reader.
"""

from __future__ import annotations

import json
import math
import operator
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "MAGIC",
    "WIRE_VERSION",
    "WIRE_PROTOCOLS",
    "DEFAULT_MAX_FRAME_BYTES",
    "MAX_FRAME_BYTES_ENV",
    "MSG_JSON",
    "MSG_SCORE_REQUEST",
    "MSG_SCORE_RESPONSE",
    "MSG_PARTIAL_RESPONSE",
    "MSG_TRACE_RESPONSE",
    "WireError",
    "FrameDecoder",
    "resolve_max_frame_bytes",
    "append_frame",
    "append_json",
    "append_score_request",
    "append_response",
    "decode_score_request",
    "decode_message",
]

MAGIC = 0xF7  # invalid UTF-8 lead byte: no JSON-lines request starts with it
WIRE_VERSION = 1
# What this build speaks, in preference order — advertised in topology
# blocks and status responses; routers negotiate the data plane from it.
WIRE_PROTOCOLS = ("json", "binary")

DEFAULT_MAX_FRAME_BYTES = 1 << 20
MAX_FRAME_BYTES_ENV = "PHOTON_MAX_FRAME_BYTES"

MSG_JSON = 0x01
MSG_SCORE_REQUEST = 0x02
MSG_SCORE_RESPONSE = 0x03
MSG_PARTIAL_RESPONSE = 0x04
MSG_TRACE_RESPONSE = 0x05

_HEADER = struct.Struct("<BBBI")
_U32 = struct.Struct("<I")
_BAGS_KEY = "_wire_bags"
_COLS_KEY = "_wire_cols"
# Column separator for the fast bag path: the ASCII unit separator —
# a feature name/term containing it falls back to the generic path.
_COL_SEP = "\x1f"
_GET_NAME = operator.itemgetter("name")
_GET_TERM = operator.itemgetter("term")
_GET_VALUE = operator.itemgetter("value")


class WireError(ValueError):
    """A frame or payload that cannot be decoded. ``kind`` is
    ``"oversized"`` for frame lengths over the cap (the binary twin of
    the JSON line-length refusal) and ``"malformed"`` for everything
    else; the frontend notes the matching counter either way."""

    def __init__(self, message: str, *, kind: str = "malformed"):
        super().__init__(message)
        self.kind = kind


def resolve_max_frame_bytes(value: Optional[int] = None) -> int:
    """Explicit value > ``PHOTON_MAX_FRAME_BYTES`` env > 1 MiB default.
    One resolution rule for both protocols: the SAME cap refuses a JSON
    line and a binary frame length."""
    if value is None:
        env = os.environ.get(MAX_FRAME_BYTES_ENV)
        if env:
            value = int(env)
        else:
            value = DEFAULT_MAX_FRAME_BYTES
    out = int(value)
    if out <= 0:
        raise ValueError(f"max_frame_bytes must be positive, got {out}")
    return out


class FrameDecoder:
    """Incremental frame splitter: ``feed(chunk)`` returns every
    complete ``(msg_type, payload)`` and buffers the tail. Raises
    :class:`WireError` the moment framing is provably lost (bad magic,
    unknown version) or a header announces a length over the cap —
    BEFORE buffering a giant payload."""

    def __init__(self, max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES):
        self.max_frame_bytes = int(max_frame_bytes)
        self._buf = bytearray()

    @property
    def pending_bytes(self) -> int:
        """Bytes buffered mid-frame (nonzero at EOF == truncated frame)."""
        return len(self._buf)

    def feed(self, chunk: bytes) -> List[Tuple[int, bytes]]:
        self._buf += chunk
        out: List[Tuple[int, bytes]] = []
        while len(self._buf) >= _HEADER.size:
            magic, version, mtype, length = _HEADER.unpack_from(self._buf)
            if magic != MAGIC:
                raise WireError(
                    f"bad frame magic 0x{magic:02x} (want 0x{MAGIC:02x}): "
                    "framing lost"
                )
            if version != WIRE_VERSION:
                raise WireError(
                    f"unsupported wire version {version} "
                    f"(this build speaks {WIRE_VERSION})"
                )
            if length > self.max_frame_bytes:
                raise WireError(
                    f"frame length {length} exceeds {self.max_frame_bytes} "
                    "bytes",
                    kind="oversized",
                )
            end = _HEADER.size + length
            if len(self._buf) < end:
                break
            out.append((mtype, bytes(self._buf[_HEADER.size:end])))
            del self._buf[:end]
        return out


def append_frame(buf: bytearray, msg_type: int, *parts: bytes) -> None:
    """Append one frame to a caller-owned (reused) encode buffer."""
    buf += _HEADER.pack(
        MAGIC, WIRE_VERSION, msg_type, sum(len(p) for p in parts)
    )
    for p in parts:
        buf += p


def append_json(buf: bytearray, obj: Dict) -> None:
    append_frame(
        buf, MSG_JSON, json.dumps(obj, separators=(",", ":")).encode("utf-8")
    )


def _split_header(payload: bytes) -> Tuple[Dict, bytes]:
    if len(payload) < _U32.size:
        raise WireError("payload too short for its header length")
    (hdr_len,) = _U32.unpack_from(payload)
    end = _U32.size + hdr_len
    if end > len(payload):
        raise WireError(
            f"payload header length {hdr_len} overruns the frame"
        )
    try:
        head = json.loads(payload[_U32.size:end].decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise WireError(f"payload header is not JSON: {e}") from e
    if not isinstance(head, dict):
        raise WireError("payload header must be a JSON object")
    return head, payload[end:]


def _json_header(head: Dict) -> Tuple[bytes, bytes]:
    hj = json.dumps(head, separators=(",", ":")).encode("utf-8")
    return _U32.pack(len(hj)), hj


def _floats(tail: bytes, dtype: str, want: int, what: str) -> np.ndarray:
    itemsize = np.dtype(dtype).itemsize
    if len(tail) != want * itemsize:
        raise WireError(
            f"{what}: float buffer is {len(tail)} bytes, header promised "
            f"{want} x {itemsize}"
        )
    return np.frombuffer(tail, dtype=dtype)


# ---------------------------------------------------------------------------
# score requests


def _strippable_bag(v: object) -> bool:
    # A feature bag whose every entry carries a numeric "value" — those
    # floats ride the raw f64 tail. Anything else stays in the header.
    if not isinstance(v, list) or not v:
        return False
    for f in v:
        if not isinstance(f, dict):
            return False
        fv = f.get("value")
        if isinstance(fv, bool) or not isinstance(fv, (int, float)):
            return False
    return True


def _columnar_bag(v: List[Dict]):
    # The fast shape: every entry is EXACTLY {"name","term","value"}
    # with string name/term free of the column separator and a numeric
    # non-bool value. Returns (names_col, terms_col, f64_array) or None
    # to fall back to the generic strip. Every check here is a C-level
    # pass (itemgetter/map/join/count/np.array) — the encoder never
    # runs Python bytecode per feature entry.
    try:
        names = _COL_SEP.join(map(_GET_NAME, v))
        terms = _COL_SEP.join(map(_GET_TERM, v))
        vlist = list(map(_GET_VALUE, v))
        if bool in map(type, vlist):
            return None
        arr = np.array(vlist, dtype="<f8")
    except (KeyError, TypeError, ValueError, OverflowError):
        return None
    n = len(v)
    if (
        arr.ndim != 1
        # all three lookups succeeded and total key count is 3n, so
        # every entry has exactly those three keys
        or sum(map(len, v)) != 3 * n
        or names.count(_COL_SEP) != n - 1
        or terms.count(_COL_SEP) != n - 1
    ):
        return None
    return names, terms, arr


def append_score_request(buf: bytearray, record: Dict) -> None:
    """Encode one score record: feature-bag values stripped into one
    raw f64-LE tail, everything else (uid, deadline, trace keys, the
    bags' name/term metadata) in the JSON header. Standard-shaped bags
    go columnar — two joined strings per bag, no per-entry objects."""
    head: Dict = {}
    bags: Dict[str, int] = {}
    cols: Dict[str, List[str]] = {}
    chunks: List[bytes] = []
    for k, v in record.items():
        if isinstance(v, list) and v:
            col = _columnar_bag(v)
            if col is not None:
                bags[k] = len(v)
                cols[k] = [col[0], col[1]]
                chunks.append(col[2].tobytes())
                continue
            if _strippable_bag(v):
                stripped = []
                values: List[float] = []
                for f in v:
                    g = dict(f)
                    values.append(float(g.pop("value")))
                    stripped.append(g)
                bags[k] = len(v)
                head[k] = stripped
                chunks.append(np.asarray(values, dtype="<f8").tobytes())
                continue
        head[k] = v
    if bags:
        head[_BAGS_KEY] = bags
    if cols:
        head[_COLS_KEY] = cols
    hdr_len, hj = _json_header(head)
    append_frame(buf, MSG_SCORE_REQUEST, hdr_len, hj, b"".join(chunks))


def decode_score_request(payload: bytes) -> Dict:
    head, tail = _split_header(payload)
    bags = head.pop(_BAGS_KEY, None)
    cols = head.pop(_COLS_KEY, None)
    if bags is None:
        if tail or cols is not None:
            raise WireError("score request has a tail but no _wire_bags")
        return head
    if not isinstance(bags, dict):
        raise WireError("_wire_bags must be an object")
    if cols is None:
        cols = {}
    elif not isinstance(cols, dict):
        raise WireError("_wire_cols must be an object")
    counts: List[Tuple[str, int]] = []
    total = 0
    for k, n in bags.items():
        if isinstance(n, bool) or not isinstance(n, int) or n < 0:
            raise WireError(f"_wire_bags[{k!r}] is not a count")
        counts.append((k, n))
        total += n
    for k in cols:
        if k not in bags:
            raise WireError(f"_wire_cols[{k!r}] has no _wire_bags count")
    vals = _floats(tail, "<f8", total, "score request values")
    off = 0
    for k, n in counts:
        # .tolist() materializes exact f64 Python floats — the same
        # doubles json.loads would have produced
        col = cols.get(k)
        if col is not None:
            if (
                not isinstance(col, list)
                or len(col) != 2
                or not isinstance(col[0], str)
                or not isinstance(col[1], str)
            ):
                raise WireError(f"_wire_cols[{k!r}] is not two columns")
            names = col[0].split(_COL_SEP)
            terms = col[1].split(_COL_SEP)
            if len(names) != n or len(terms) != n:
                raise WireError(
                    f"bag {k!r}: columns have {len(names)}/{len(terms)} "
                    f"entries, _wire_bags promised {n}"
                )
            head[k] = [
                {"name": nm, "term": tm, "value": v}
                for nm, tm, v in zip(
                    names, terms, vals[off:off + n].tolist()
                )
            ]
        else:
            entries = head.get(k)
            if not isinstance(entries, list) or len(entries) != n:
                raise WireError(
                    f"bag {k!r}: header has {len(entries) if isinstance(entries, list) else 'no'} "
                    f"entries, _wire_bags promised {n}"
                )
            for f, v in zip(entries, vals[off:off + n].tolist()):
                if not isinstance(f, dict):
                    raise WireError(f"bag {k!r}: entry is not an object")
                f["value"] = v
        off += n
    return head


# ---------------------------------------------------------------------------
# responses


def _append_score_response(buf: bytearray, resp: Dict) -> None:
    head = {k: v for k, v in resp.items() if k != "score"}
    hdr_len, hj = _json_header(head)
    tail = np.asarray([resp["score"]], dtype="<f4").tobytes()
    append_frame(buf, MSG_SCORE_RESPONSE, hdr_len, hj, tail)


def _decode_score_response(payload: bytes) -> Dict:
    head, tail = _split_header(payload)
    vals = _floats(tail, "<f4", 1, "score response")
    head["score"] = float(vals[0])
    return head


def _append_partial_response(buf: bytearray, resp: Dict, partial) -> None:
    """Single-pass vectorized PartialScore encode: the gather response's
    ``fe`` + term values ride ONE f32 buffer copy; no per-term dict is
    ever materialized on the shard."""
    names, vec = partial.term_vector()
    head = {k: v for k, v in resp.items()
            if k not in ("fe", "terms", "_wire_partial")}
    head["names"] = list(names)
    hdr_len, hj = _json_header(head)
    tail = np.empty(1 + len(names), dtype="<f4")
    tail[0] = np.float32(partial.fe)
    tail[1:] = vec
    append_frame(buf, MSG_PARTIAL_RESPONSE, hdr_len, hj, tail.tobytes())


def _decode_partial_response(payload: bytes) -> Dict:
    head, tail = _split_header(payload)
    names = head.pop("names", None)
    if not isinstance(names, list):
        raise WireError("partial response header lacks names")
    vals = _floats(tail, "<f4", 1 + len(names), "partial response")
    # .tolist() yields the exact f64 of each f32 — identical to the
    # float(np.float32(x)) the JSON path round-trips
    as_floats = vals.tolist()
    head["fe"] = as_floats[0]
    head["terms"] = dict(zip(names, as_floats[1:]))
    return head


def _append_trace_response(buf: bytearray, resp: Dict) -> None:
    spans = resp.get("spans") or []
    times = np.empty(2 * len(spans), dtype="<f8")
    meta = []
    for i, s in enumerate(spans):
        d = dict(s)
        t1 = d.pop("t1")
        times[2 * i] = d.pop("t0")
        times[2 * i + 1] = math.nan if t1 is None else t1
        meta.append(d)
    head = {k: v for k, v in resp.items() if k != "spans"}
    head["spans"] = meta
    hdr_len, hj = _json_header(head)
    append_frame(buf, MSG_TRACE_RESPONSE, hdr_len, hj, times.tobytes())


def _decode_trace_response(payload: bytes) -> Dict:
    head, tail = _split_header(payload)
    spans = head.get("spans")
    if not isinstance(spans, list):
        raise WireError("trace response header lacks spans")
    times = _floats(tail, "<f8", 2 * len(spans), "trace span times")
    as_floats = times.tolist()
    for i, s in enumerate(spans):
        if not isinstance(s, dict):
            raise WireError("trace span is not an object")
        t1 = as_floats[2 * i + 1]
        s["t0"] = as_floats[2 * i]
        s["t1"] = None if math.isnan(t1) else t1
    return head


def append_response(buf: bytearray, resp: Dict) -> None:
    """Encode one frontend response, picking the hot-path codec when
    one applies: PartialScore gather answers (marked by the writer-side
    ``_wire_partial`` carrier), trace drains, and plain score answers.
    Everything else — status, swap control, errors — is MSG_JSON."""
    partial = resp.get("_wire_partial")
    if partial is not None:
        _append_partial_response(buf, resp, partial)
    elif resp.get("op") == "trace" and isinstance(resp.get("spans"), list):
        _append_trace_response(buf, resp)
    elif resp.get("status") == "ok" and isinstance(
        resp.get("score"), float
    ):
        _append_score_response(buf, resp)
    else:
        append_json(buf, resp)


def decode_message(msg_type: int, payload: bytes) -> Dict:
    """Decode any frame back to the dict the JSON protocol would have
    carried (client / router-transport side)."""
    if msg_type == MSG_JSON:
        try:
            obj = json.loads(payload.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise WireError(f"MSG_JSON payload is not JSON: {e}") from e
        if not isinstance(obj, dict):
            raise WireError("MSG_JSON payload must be a JSON object")
        return obj
    if msg_type == MSG_SCORE_REQUEST:
        return decode_score_request(payload)
    if msg_type == MSG_SCORE_RESPONSE:
        return _decode_score_response(payload)
    if msg_type == MSG_PARTIAL_RESPONSE:
        return _decode_partial_response(payload)
    if msg_type == MSG_TRACE_RESPONSE:
        return _decode_trace_response(payload)
    raise WireError(f"unknown message type 0x{msg_type:02x}")
