"""Fleet-scale observability: cross-process trace stitching into ONE
timeline, a live fleet telemetry collector, and fleet-wide score
conservation (a copy of ``photon_ml_tpu/obs/fleet.py``).

The per-process telemetry plane is strictly per-process: each of the
router and the N shard-servers dumps its OWN trace ring,
metrics snapshot and flight recorder, and ``check_conservation()``
balances one process's books. The trace ids already cross the wire
(``trace_id`` / ``parent_span`` on every sub-request) — this module is
the layer that stitches them:

- :class:`FleetCollector` polls every fleet member over FRESH control
  connections (never the multiplexed data plane) using the incremental
  ``{"op": "trace"}`` drain op: cursor/seq-keyed, so polls never
  duplicate a span and never silently drop one (ring evictions between
  polls are counted, per member, into the artifact). A SIGKILLed
  shard's spans survive in the COLLECTOR — everything polled before
  the kill joins the fleet timeline.

- **Clock-skew normalization.** Spans carry ``perf_counter`` pairs
  mapped onto the wall clock through one per-process ``(wall, perf)``
  epoch (``obs/trace.py``). Each poll runs one NTP-style exchange
  against that SAME mapping: the collector stamps its epoch-time
  before (``c0``) and after (``c1``) the request, the member answers
  with its epoch-mapped "now"; ``offset = member_now - (c0 + c1)/2``
  with uncertainty ``(c1 - c0)/2`` (half the round trip). The
  lowest-uncertainty estimate seen so far wins, every member's offset
  and uncertainty ride the artifact, and
  :func:`verify_fleet_trace` uses the summed uncertainties as the
  tolerance for its parent→child monotonicity check — the accuracy
  envelope is explicit, never assumed.

- **Stitching** (:func:`stitch_spans`): per-process span ids are
  namespaced ``<member>:<span_id>`` in the merged artifact (the
  source-side pid+nonce prefixes make collisions vanishingly rare, but
  a fleet merge must not DEPEND on that — collisions are counted and
  surfaced), parent references are remapped through the global id map
  (wire-carried parents cross processes by design), and the batch-level
  dispatch spans expand into their per-request ``serving.score`` leaves
  exactly like the single-process exporter does.

- **Fleet-wide conservation**
  (:func:`fleet_check_conservation`): router admitted == Σ
  shard-attributed terminals + router-local outcomes (sheds, NO_SHARD
  refusals, hot-cache hits that fan out to zero shards, FE-only
  degraded), joined against each shard's own per-generation terminal
  split. A shard whose book is a mid-flight snapshot (SIGKILLed — its
  last transition auto-dump is all there is) is joined advisorily,
  never counted as a failure; a CLEANLY drained shard must balance
  exactly and must have served at least every sub-request the router
  attributed to it.

- **Post-hoc merge**: ``python -m photon_ml_tpu_torch.obs.fleet <obs-dir>...``
  merges already-dumped ``trace.json`` / ``flight.json`` artifacts into
  one ``fleet_trace.json`` (flight-ring events join the timeline as
  instant events, so a SIGKILLed process's rings are still
  visible in it) and re-checks conservation from the dumped books.

Host arithmetic only: nothing in obs/ touches a device tensor.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from photon_ml_tpu_torch.obs import trace as obs_trace
from photon_ml_tpu_torch.obs.trace import TRACES_ATTR

__all__ = [
    "FleetCollector",
    "stitch_spans",
    "verify_fleet_trace",
    "fleet_chrome_events",
    "export_fleet_trace",
    "fleet_check_conservation",
    "spans_from_chrome_export",
    "load_obs_dump",
    "main",
]

# Control ops run on fresh connections; a trace drain can carry many
# thousands of spans in one JSON line.
CONTROL_TIMEOUT_S = 30.0
DEFAULT_POLL_S = 1.0
# Per-member span accumulation cap: the collector is itself bounded
# (old spans fall off, counted), so a week-long fleet watch cannot grow
# host memory.
DEFAULT_MAX_SPANS_PER_MEMBER = 1 << 17


def _request_line(
    host: str, port: int, obj: Mapping, timeout_s: float
) -> Dict:
    """One JSON-lines control request on a FRESH connection — staging
    or a slow member must never stall a shared data-plane reader."""
    with socket.create_connection(
        (host, int(port)), timeout=timeout_s
    ) as sock:
        sock.settimeout(timeout_s)
        sock.sendall((json.dumps(obj) + "\n").encode("utf-8"))
        buf = b""
        while b"\n" not in buf:
            chunk = sock.recv(1 << 16)
            if not chunk:
                raise ConnectionError("EOF before response line")
            buf += chunk
    return json.loads(buf.split(b"\n", 1)[0].decode("utf-8"))


def _request_wire(
    host: str, port: int, obj: Mapping, timeout_s: float
) -> Dict:
    """The binary twin of :func:`_request_line`: one MSG_JSON request
    frame on a fresh connection (the frontend sniffs the magic byte),
    one decoded response frame back. The trace drain's span batches —
    the collector's bulk transfer — ride photon-wire's raw float
    buffers instead of per-float JSON text. Imported lazily so the obs
    plane stays importable without the serving stack."""
    from photon_ml_tpu_torch.serving import wire as wirefmt

    out = bytearray()
    wirefmt.append_json(out, dict(obj))
    decoder = wirefmt.FrameDecoder(wirefmt.resolve_max_frame_bytes())
    with socket.create_connection(
        (host, int(port)), timeout=timeout_s
    ) as sock:
        sock.settimeout(timeout_s)
        sock.sendall(out)
        while True:
            chunk = sock.recv(1 << 16)
            if not chunk:
                raise ConnectionError("EOF before response frame")
            frames = decoder.feed(chunk)
            if frames:
                return wirefmt.decode_message(*frames[0])


class _MemberState:
    """One fleet member's collector-side book. Every field is guarded
    by the owning collector's ``_lock``; the poll path reads the cursor
    under the lock, does its socket IO with NO lock held, and publishes
    the results back under the lock."""

    __slots__ = (
        "name", "host", "port", "local", "cursor", "spans",
        "ring_dropped", "merge_dropped", "epoch_wall", "epoch_perf",
        "pid", "offset_s", "offset_unc_s", "polls", "errors",
        "enabled", "last_error", "uid_seq",
    )

    def __init__(self, name: str, host: Optional[str], port: int):
        self.name = str(name)
        self.host = host
        self.port = int(port)
        self.local = host is None
        self.cursor = 0
        self.spans: List[Dict] = []
        self.ring_dropped = 0   # evicted at the member between polls
        self.merge_dropped = 0  # evicted here past the collector cap
        self.epoch_wall: Optional[float] = None
        self.epoch_perf: Optional[float] = None
        self.pid: Optional[int] = None
        self.offset_s = 0.0
        self.offset_unc_s: Optional[float] = None  # None = never synced
        self.polls = 0
        self.errors = 0
        self.enabled: Optional[bool] = None
        self.last_error = ""
        self.uid_seq = 0


class FleetCollector:
    """Polls every fleet member's ``{"op": "trace"}`` drain (plus the
    local process tracer when ``local_name`` is set — the router's own
    spans join the same timeline) and merges the result into one
    skew-corrected Chrome trace.

    ``members`` is a sequence of ``(name, host, port)``. Polling runs
    either on the background thread (:meth:`start` / :meth:`stop`) or
    deterministically via :meth:`poll_once` — tests
    drive the latter. A member that cannot be reached costs one counted
    error, never a crash: a SIGKILLed shard simply stops contributing
    new spans while everything already collected stays merged.
    """

    def __init__(
        self,
        members: Sequence[Tuple[str, str, int]],
        *,
        local_name: Optional[str] = None,
        poll_s: float = DEFAULT_POLL_S,
        connect_timeout_s: float = 5.0,
        max_spans_per_member: int = DEFAULT_MAX_SPANS_PER_MEMBER,
        wire: str = "json",
    ):
        self.wire = str(wire)
        if self.wire not in ("json", "binary"):
            raise ValueError(
                f"unknown wire protocol {wire!r} (json | binary)"
            )
        self.poll_s = max(float(poll_s), 0.02)
        self.connect_timeout_s = float(connect_timeout_s)
        self.max_spans_per_member = int(max_spans_per_member)
        self._lock = threading.Lock()
        # serializes whole polls (background thread vs an explicit
        # poll_once vs the stop-time final poll): two concurrent polls
        # of one member would read the same cursor and duplicate spans
        self._poll_serial = threading.Lock()
        self._members: List[_MemberState] = [
            _MemberState(name, host, port) for name, host, port in members
        ]
        if local_name is not None:
            self._members.append(_MemberState(local_name, None, 0))
        names = [m.name for m in self._members]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate member names: {names}")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- polling --------------------------------------------------------------

    def _poll_member(self, m: _MemberState) -> None:
        with self._lock:
            cursor = m.cursor
        if m.local:
            # the collector's own process: read the tracer directly —
            # same cursor contract, offset zero by construction
            spans, new_cursor, dropped = obs_trace.tracer().read_since(
                cursor
            )
            ew, ep = obs_trace.epoch()
            payload = {
                "spans": [s.to_dict() for s in spans],
                "cursor": new_cursor,
                "dropped": dropped,
                "epoch_wall": ew,
                "epoch_perf": ep,
                "pid": os.getpid(),
                "enabled": obs_trace.tracing_enabled(),
            }
            offset, unc = 0.0, 0.0
        else:
            # NTP-style exchange against the member's span-time epoch:
            # both c0/c1 are THIS process's epoch-mapped now, so the
            # derived offset lands every member on the collector's own
            # span timeline
            ask = _request_wire if self.wire == "binary" else _request_line
            c0 = obs_trace.epoch_now()
            payload = ask(
                m.host, m.port,
                {"op": "trace", "cursor": cursor, "uid": self._uid(m)},
                self.connect_timeout_s,
            )
            c1 = obs_trace.epoch_now()
            if payload.get("status") != "ok":
                raise ConnectionError(
                    f"trace op refused: {payload.get('error')}"
                )
            member_now = payload["epoch_wall"] + (
                payload["now_perf"] - payload["epoch_perf"]
            )
            offset = member_now - 0.5 * (c0 + c1)
            unc = 0.5 * (c1 - c0)
        with self._lock:
            m.polls += 1
            m.cursor = int(payload["cursor"])
            m.ring_dropped += int(payload.get("dropped") or 0)
            m.epoch_wall = float(payload["epoch_wall"])
            m.epoch_perf = float(payload["epoch_perf"])
            m.pid = payload.get("pid")
            m.enabled = payload.get("enabled")
            if m.offset_unc_s is None or unc < m.offset_unc_s:
                # keep the tightest estimate: uncertainty is half the
                # round trip, so the fastest exchange wins
                m.offset_s, m.offset_unc_s = offset, unc
            m.spans.extend(payload["spans"])
            overflow = len(m.spans) - self.max_spans_per_member
            if overflow > 0:
                del m.spans[:overflow]
                m.merge_dropped += overflow

    def _uid(self, m: _MemberState) -> str:
        with self._lock:
            m.uid_seq += 1
            return f"fleet-{m.name}-{m.uid_seq}"

    def poll_once(self) -> Dict[str, bool]:
        """One deterministic poll of every member; returns name -> ok.
        Serialized against the background thread, so a test (or the
        stop-time final poll) can interleave with it safely."""
        out: Dict[str, bool] = {}
        with self._poll_serial:
            for m in list(self._members):
                try:
                    self._poll_member(m)
                    out[m.name] = True
                except (OSError, ValueError, KeyError, TypeError) as e:
                    with self._lock:
                        m.errors += 1
                        m.last_error = str(e)
                    out[m.name] = False
        return out

    def _loop(self) -> None:
        while not self._stop.wait(timeout=self.poll_s):
            self.poll_once()

    def start(self) -> "FleetCollector":
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="photon-fleet-collector", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 10.0, *, final_poll: bool = True):
        """Join the poll thread, then (by default) drain each member's
        ring one last time so the artifact holds the tail."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None
        if final_poll:
            self.poll_once()

    # -- the fleet flight/conservation plane ----------------------------------

    def collect_flight(self) -> Dict[str, Dict]:
        """Fetch every member's flight ring + conservation book over a
        fresh ``{"op": "flight"}`` each (the local member reads the
        process recorder). Unreachable members are reported with an
        ``error`` entry — the fleet check treats them as incomplete."""
        from photon_ml_tpu_torch.obs.flight_recorder import flight_recorder

        out: Dict[str, Dict] = {}
        for m in list(self._members):
            if m.local:
                rec = flight_recorder()
                out[m.name] = {
                    "conservation": rec.check_conservation(),
                    "events": rec.events(),
                    "complete": True,
                }
                continue
            try:
                resp = _request_line(
                    m.host, m.port,
                    {"op": "flight", "uid": self._uid(m)},
                    self.connect_timeout_s,
                )
                out[m.name] = {
                    "conservation": resp["conservation"],
                    "events": resp["flight"]["events"],
                    "complete": True,
                }
            except (OSError, ValueError, KeyError) as e:
                out[m.name] = {"error": str(e), "complete": False}
        return out

    # -- merge ----------------------------------------------------------------

    def member_status(self) -> Dict[str, Dict[str, object]]:
        with self._lock:
            return {
                m.name: {
                    "pid": m.pid,
                    "polls": m.polls,
                    "errors": m.errors,
                    "spans": len(m.spans),
                    "cursor": m.cursor,
                    "ring_dropped": m.ring_dropped,
                    "merge_dropped": m.merge_dropped,
                    "clock_offset_s": m.offset_s,
                    "clock_offset_uncertainty_s": m.offset_unc_s,
                    "tracing_enabled": m.enabled,
                    "last_error": m.last_error,
                }
                for m in self._members
            }

    def _payloads(self) -> List[Dict]:
        with self._lock:
            return [
                {
                    "name": m.name,
                    "pid": m.pid,
                    "spans": list(m.spans),
                    "epoch_wall": m.epoch_wall,
                    "epoch_perf": m.epoch_perf,
                    "offset_s": m.offset_s,
                    "offset_unc_s": m.offset_unc_s,
                    "wall_mapped": False,
                }
                for m in self._members
                if m.spans
            ]

    def stitched_spans(self) -> List[Dict]:
        return stitch_spans(self._payloads())

    def export(self, path: str, *, extra: Optional[Dict] = None) -> int:
        """Write the merged, skew-corrected fleet timeline as ONE
        Chrome trace-event JSON. Returns the event count."""
        stitched = self.stitched_spans()
        status = self.member_status()
        return export_fleet_trace(
            path, stitched, member_status=status, extra=extra
        )


# -- stitching ------------------------------------------------------------------


def _expand_wire_span(s: Dict) -> List[Dict]:
    """The wire twin of ``trace.expand_spans``: a dispatch span dict
    carrying per-request trace contexts expands into its
    ``serving.score`` leaves (leaf ids derive from the dispatch span's
    own id, so they stay unique after namespacing)."""
    out = [s]
    traces = (s.get("attrs") or {}).get(TRACES_ATTR)
    if not traces:
        return out
    for k, entry in enumerate(traces):
        trace_id, parent_id, degraded = entry[0], entry[1], entry[2]
        out.append({
            "name": "serving.score",
            "trace_id": trace_id,
            "span_id": f"{s['span_id']}#{k}",
            "parent_id": parent_id,
            "t0": s["t0"],
            "t1": s["t1"],
            "tid": s.get("tid"),
            "seq": s.get("seq"),
            "attrs": {
                "degraded": bool(degraded),
                "dispatch_span": s["span_id"],
                **{
                    k2: v for k2, v in (s.get("attrs") or {}).items()
                    if k2 in ("generation", "shape")
                },
            },
        })
    return out


def stitch_spans(payloads: Sequence[Mapping]) -> List[Dict]:
    """Merge per-member span payloads into ONE namespaced, parent-
    linked, skew-corrected span list.

    Each payload: ``{name, pid, spans, epoch_wall, epoch_perf,
    offset_s, offset_unc_s, wall_mapped}`` — ``spans`` hold raw
    ``perf_counter`` times unless ``wall_mapped`` (the post-hoc path,
    whose exporter already applied the epoch). Output spans carry
    ``member``, ``pid``, a namespaced ``span_id``, a remapped
    ``parent_id`` (left verbatim when the parent was never collected —
    e.g. minted by a process outside the fleet), wall-clock ``t0``/
    ``t1`` seconds on the collector's timeline, and the member's
    offset uncertainty (``unc``) for tolerance-aware checks."""
    # pass 1: wall-map + expand each member's spans, build the global
    # id map (original id -> namespaced id)
    per_member: List[Tuple[Mapping, List[Dict]]] = []
    id_map: Dict[str, str] = {}
    collisions = 0
    for p in payloads:
        expanded: List[Dict] = []
        for s in p["spans"]:
            expanded.extend(_expand_wire_span(s))
        for s in expanded:
            sid = s["span_id"]
            nsid = f"{p['name']}:{sid}"
            if sid in id_map:
                collisions += 1
            else:
                id_map[sid] = nsid
        per_member.append((p, expanded))
    # pass 2: emit namespaced spans with remapped parents
    out: List[Dict] = []
    for p, expanded in per_member:
        offset = float(p.get("offset_s") or 0.0)
        unc = p.get("offset_unc_s")
        wall_mapped = bool(p.get("wall_mapped"))
        ew = p.get("epoch_wall")
        ep = p.get("epoch_perf")

        def to_wall(t, _ew=ew, _ep=ep, _off=offset, _wm=wall_mapped):
            if t is None:
                return None
            if _wm:
                return float(t) - _off
            return float(_ew) + (float(t) - float(_ep)) - _off

        for s in expanded:
            parent = s.get("parent_id")
            attrs = dict(s.get("attrs") or {})
            dispatch = attrs.get("dispatch_span")
            if dispatch is not None:
                attrs["dispatch_span"] = id_map.get(
                    str(dispatch), str(dispatch)
                )
            out.append({
                "name": s["name"],
                "member": p["name"],
                "pid": p.get("pid"),
                "tid": s.get("tid"),
                "trace_id": s.get("trace_id"),
                "span_id": id_map.get(s["span_id"], s["span_id"]),
                "parent_id": (
                    None if parent is None
                    else id_map.get(str(parent), str(parent))
                ),
                "t0": to_wall(s.get("t0")),
                "t1": to_wall(s.get("t1")),
                "unc": unc,
                "attrs": attrs,
                "id_collisions": collisions or None,
            })
    return out


def verify_fleet_trace(stitched: Sequence[Mapping]) -> Dict[str, object]:
    """The fleet-timeline contract, machine-checked:

    - every ``router.subrequest`` parents under a ``router.request``;
    - every ``frontend.request`` that joins a routed trace parents
      under a ``router.subrequest``;
    - every ``serving.score`` leaf parents under its ``frontend.request``
      AND its ``dispatch_span`` resolves to a ``serving.dispatch`` span
      of the SAME member (the request's trace joins the device dispatch
      that served it);
    - skew-corrected timestamps are monotone parent -> child within
      every trace, to the summed clock-sync uncertainty of the two
      members involved.
    """
    by_id = {s["span_id"]: s for s in stitched}
    violations: List[str] = []
    checked_edges = 0

    def tol(a: Mapping, b: Mapping) -> float:
        return (a.get("unc") or 0.0) + (b.get("unc") or 0.0)

    want_parent = {
        "router.subrequest": ("router.request",),
        "serving.score": ("frontend.request",),
    }
    n_sub = n_front = n_score = 0
    for s in stitched:
        parent = by_id.get(s.get("parent_id") or "")
        name = s["name"]
        if name == "router.subrequest":
            n_sub += 1
        elif name == "frontend.request":
            n_front += 1
        elif name == "serving.score":
            n_score += 1
        expect = want_parent.get(name)
        if expect is not None:
            if parent is None:
                violations.append(
                    f"{name} {s['span_id']}: parent "
                    f"{s.get('parent_id')!r} not in the merged trace"
                )
                continue
            if parent["name"] not in expect:
                violations.append(
                    f"{name} {s['span_id']}: parent is "
                    f"{parent['name']}, expected one of {expect}"
                )
        if name == "frontend.request" and parent is not None:
            # a frontend span with a collected parent must hang off a
            # router sub-request (bare client traffic stays parentless)
            if parent["name"] != "router.subrequest":
                violations.append(
                    f"frontend.request {s['span_id']}: parent is "
                    f"{parent['name']}, expected router.subrequest"
                )
        if name == "serving.score":
            d = (s.get("attrs") or {}).get("dispatch_span")
            dspan = by_id.get(str(d)) if d is not None else None
            if dspan is None or dspan["name"] != "serving.dispatch":
                violations.append(
                    f"serving.score {s['span_id']}: dispatch_span "
                    f"{d!r} does not resolve to a serving.dispatch span"
                )
            elif dspan["member"] != s["member"]:
                violations.append(
                    f"serving.score {s['span_id']}: dispatch span "
                    f"belongs to member {dspan['member']!r}, leaf to "
                    f"{s['member']!r}"
                )
        # monotonicity along every resolvable edge, skew-aware
        if parent is not None and s.get("t0") is not None:
            checked_edges += 1
            slack = tol(parent, s)
            if s["t0"] + slack < parent["t0"]:
                violations.append(
                    f"{name} {s['span_id']} starts "
                    f"{(parent['t0'] - s['t0']) * 1e3:.3f}ms before its "
                    f"parent {parent['name']} (tolerance "
                    f"{slack * 1e3:.3f}ms)"
                )
    return {
        "ok": not violations,
        "spans": len(stitched),
        "edges_checked": checked_edges,
        "router_subrequests": n_sub,
        "frontend_requests": n_front,
        "score_leaves": n_score,
        "violations": violations[:50],
    }


# -- chrome export ----------------------------------------------------------------


def fleet_chrome_events(
    stitched: Sequence[Mapping],
    *,
    flight_events: Optional[Mapping[str, Sequence[Mapping]]] = None,
    flight_offsets: Optional[Mapping[str, float]] = None,
) -> List[Dict]:
    """Chrome trace events with one pid LANE per member (synthetic,
    deterministic lane ids — real pids can collide across hosts), plus
    the members' flight-ring events as instant markers so protocol
    transitions (and a SIGKILLed process's last recorded acts) sit on
    the same timeline as the spans."""
    members: List[str] = []
    for s in stitched:
        if s["member"] not in members:
            members.append(s["member"])
    for name in (flight_events or {}):
        if name not in members:
            members.append(name)
    lane = {name: i + 1 for i, name in enumerate(sorted(members))}
    events: List[Dict] = []
    for name, pid_lane in sorted(lane.items()):
        real = next(
            (s.get("pid") for s in stitched if s["member"] == name), None
        )
        events.append({
            "name": "process_name",
            "ph": "M",
            "pid": pid_lane,
            "args": {
                "name": f"{name}" + (f" (pid {real})" if real else "")
            },
        })
    for s in stitched:
        if s.get("t1") is None or s.get("t0") is None:
            continue
        args: Dict[str, object] = {
            "member": s["member"],
            "trace_id": s.get("trace_id"),
            "span_id": s["span_id"],
        }
        if s.get("parent_id") is not None:
            args["parent_span"] = s["parent_id"]
        for k, v in (s.get("attrs") or {}).items():
            if k == TRACES_ATTR:
                args["traced_requests"] = len(v)
                continue
            args[k] = v if isinstance(v, (int, float, bool, str)) else str(v)
        events.append({
            "name": s["name"],
            "cat": s["name"].split(".", 1)[0],
            "ph": "X",
            "ts": s["t0"] * 1e6,
            "dur": max((s["t1"] - s["t0"]) * 1e6, 0.001),
            "pid": lane[s["member"]],
            "tid": s.get("tid") or 0,
            "args": args,
        })
    for name, evs in (flight_events or {}).items():
        off = float((flight_offsets or {}).get(name, 0.0))
        for e in evs:
            events.append({
                "name": str(e.get("kind")),
                "cat": "flight",
                "ph": "i",
                "s": "p",
                "ts": (float(e["t"]) - off) * 1e6,
                "pid": lane[name],
                "tid": 0,
                "args": {
                    "seq": e.get("seq"),
                    **{
                        k: (v if isinstance(v, (int, float, bool, str))
                            else str(v))
                        for k, v in (e.get("fields") or {}).items()
                    },
                },
            })
    return events


def export_fleet_trace(
    path: str,
    stitched: Sequence[Mapping],
    *,
    member_status: Optional[Mapping] = None,
    flight_events: Optional[Mapping[str, Sequence[Mapping]]] = None,
    flight_offsets: Optional[Mapping[str, float]] = None,
    extra: Optional[Dict] = None,
) -> int:
    """Atomically write ONE merged fleet timeline. The per-member clock
    offsets/uncertainties and drop accounting ride ``otherData``."""
    from photon_ml_tpu_torch.reliability import atomic_write_json

    events = fleet_chrome_events(
        stitched,
        flight_events=flight_events,
        flight_offsets=flight_offsets,
    )
    verification = verify_fleet_trace(stitched)
    atomic_write_json(path, {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "members": dict(member_status or {}),
            "verification": verification,
            **(extra or {}),
        },
    })
    return len(events)


# -- fleet-wide conservation -------------------------------------------------------


def fleet_check_conservation(
    router_book: Mapping,
    shard_books: Mapping[str, Mapping],
) -> Dict[str, object]:
    """Balance the WHOLE fleet's request ledger.

    ``router_book`` is the router process's ``check_conservation()``
    dict — every terminal attributed (``shard:<i>`` / ``cache`` /
    ``degraded`` / ``no_shard`` / ``shed``). ``shard_books`` maps member
    name -> ``{"conservation": <dict>, "complete": bool,
    "shard_indices": [i, ...]}``.

    Checks, in order:

    1. the router's own books balance: admitted == Σ terminals, with
       the per-generation split re-summing;
    2. the attribution table re-sums to the terminal total (every
       admitted request landed in exactly one bucket — a dropped
       response is a hole HERE);
    3. every CLEANLY-drained shard book balances internally, its
       per-generation split re-sums, and it served at least every
       sub-request the router attributed to it (hedges / abandoned-but-
       served sub-requests make the shard side >=, never ==);
    4. a shard whose book is a mid-flight snapshot (SIGKILLed: the
       auto-dumped transition ring is all that survives) is joined
       advisorily — reported, never failed.
    """
    attr = dict(router_book.get("terminal_by_attribution") or {})
    attr_total = sum(attr.values())
    terminal_total = int(router_book.get("terminal_total") or 0)
    by_gen = router_book.get("terminal_by_generation") or {}
    router_ok = bool(router_book.get("ok"))
    attribution_ok = attr_total == terminal_total
    gen_ok = sum(by_gen.values()) == terminal_total
    ok = router_ok and attribution_ok and gen_ok
    shards_out: Dict[str, Dict[str, object]] = {}
    for name, book in sorted(shard_books.items()):
        cons = book.get("conservation") or {}
        complete = bool(book.get("complete", True))
        indices = list(book.get("shard_indices") or [])
        attributed = sum(
            v for k, v in attr.items()
            if k.startswith("shard:")
            and k.split(":", 1)[1].isdigit()
            and int(k.split(":", 1)[1]) in indices
        ) if indices else None
        served_ok = int((cons.get("terminal") or {}).get("ok") or 0)
        entry: Dict[str, object] = {
            "complete": complete,
            "book_ok": bool(cons.get("ok")),
            "admitted": cons.get("admitted"),
            "served_ok": served_ok,
            "router_attributed": attributed,
            "terminal_by_generation": cons.get("terminal_by_generation"),
        }
        if not complete:
            # last-transition snapshot: requests served after the dump
            # are invisible, so neither direction of the join is sound
            entry["join_ok"] = None
        else:
            join_ok = bool(cons.get("ok"))
            if attributed is not None:
                join_ok = join_ok and served_ok >= attributed
            entry["join_ok"] = join_ok
            ok = ok and join_ok
        shards_out[name] = entry
    return {
        "ok": ok,
        "router_ok": router_ok,
        "attribution_ok": attribution_ok,
        "generation_split_ok": gen_ok,
        "admitted": router_book.get("admitted"),
        "terminal_total": terminal_total,
        "terminal_by_attribution": attr,
        "terminal_by_generation": dict(by_gen),
        "shards": shards_out,
    }


# -- post-hoc merge ------------------------------------------------------------------


def spans_from_chrome_export(data: Mapping) -> List[Dict]:
    """Normalize an already-exported per-process ``trace.json`` back
    into span dicts (wall-mapped; ``serving.score`` leaves were already
    expanded by the exporter)."""
    out: List[Dict] = []
    for e in data.get("traceEvents") or []:
        if e.get("ph") != "X":
            continue
        args = dict(e.get("args") or {})
        out.append({
            "name": e.get("name"),
            "trace_id": args.pop("trace_id", None),
            "span_id": args.pop("span_id", None),
            "parent_id": args.pop("parent_span", None),
            "t0": float(e["ts"]) / 1e6,
            "t1": (float(e["ts"]) + float(e.get("dur") or 0.0)) / 1e6,
            "tid": e.get("tid"),
            "seq": None,
            "attrs": args,
        })
    return out


def load_obs_dump(obs_dir: str, *, name: Optional[str] = None) -> Dict:
    """Read one ``--obs-dir``: the exported ``trace.json`` (if the
    process lived to export one) and the ``flight.json`` ring/book (the
    auto-dump survives a SIGKILL). ``complete`` reflects whether the
    flight book was written by a clean drain/exit — anything else is a
    mid-flight snapshot."""
    out: Dict[str, object] = {
        "dir": obs_dir,
        "name": name or os.path.basename(os.path.normpath(obs_dir)),
        "spans": [],
        "pid": None,
        "flight": None,
        "conservation": None,
        "complete": False,
    }
    trace_path = os.path.join(obs_dir, "trace.json")
    if os.path.exists(trace_path):
        with open(trace_path) as f:
            data = json.load(f)
        out["spans"] = spans_from_chrome_export(data)
        out["pid"] = (data.get("otherData") or {}).get("pid")
    flight_path = os.path.join(obs_dir, "flight.json")
    if os.path.exists(flight_path):
        with open(flight_path) as f:
            flight = json.load(f)
        out["flight"] = flight
        out["conservation"] = flight.get("conservation")
        out["pid"] = out["pid"] or flight.get("pid")
        out["complete"] = flight.get("reason") in ("exit", "drain")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m photon_ml_tpu_torch.obs.fleet <obs-dir>... [-o OUT]`` —
    merge post-hoc per-process dumps into one fleet timeline + a fleet
    conservation verdict. Exit 0 when the merged trace verifies and
    conservation balances, 1 otherwise."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m photon_ml_tpu_torch.obs.fleet",
        description="merge per-process --obs-dir dumps into one "
        "fleet_trace.json + fleet_conservation.json",
    )
    ap.add_argument("obs_dirs", nargs="+", help="per-process obs dirs")
    ap.add_argument(
        "-o", "--out", default=".",
        help="output directory (default: cwd)",
    )
    ap.add_argument(
        "--router", default=None,
        help="member name holding the ROUTER conservation book "
        "(default: auto-detected by its attribution table)",
    )
    ns = ap.parse_args(argv)
    dumps = [load_obs_dump(d) for d in ns.obs_dirs]
    names = [d["name"] for d in dumps]
    if len(set(names)) != len(names):
        # disambiguate duplicate basenames by position
        for i, d in enumerate(dumps):
            d["name"] = f"{d['name']}#{i}"
    payloads = [
        {
            "name": d["name"],
            "pid": d["pid"],
            "spans": d["spans"],
            "epoch_wall": None,
            "epoch_perf": None,
            "offset_s": 0.0,
            "offset_unc_s": None,  # post-hoc: no live exchange to sync
            "wall_mapped": True,
        }
        for d in dumps
    ]
    stitched = stitch_spans(payloads)
    verification = verify_fleet_trace(stitched)
    flight_events = {
        d["name"]: (d["flight"] or {}).get("events") or []
        for d in dumps
        if d.get("flight")
    }
    os.makedirs(ns.out, exist_ok=True)
    trace_out = os.path.join(ns.out, "fleet_trace.json")
    n_events = export_fleet_trace(
        trace_out,
        stitched,
        flight_events=flight_events,
        member_status={
            d["name"]: {
                "dir": d["dir"],
                "pid": d["pid"],
                "spans": len(d["spans"]),
                "complete": d["complete"],
                "clock_offset_s": 0.0,
                "clock_offset_uncertainty_s": None,
            }
            for d in dumps
        },
        extra={"mode": "post-hoc", "merged_at": time.time()},
    )
    # conservation: the router book is the one whose terminals carry a
    # full attribution table (or the named one)
    router_dump = None
    if ns.router is not None:
        router_dump = next(
            (d for d in dumps if d["name"] == ns.router), None
        )
        if router_dump is None:
            print(f"no obs dir named {ns.router!r}", flush=True)
            return 2
    else:
        for d in dumps:
            cons = d.get("conservation") or {}
            attr = cons.get("terminal_by_attribution") or {}
            if attr and sum(attr.values()) == cons.get("terminal_total"):
                router_dump = d
                break
    conservation = None
    if router_dump is not None and router_dump.get("conservation"):
        shard_books = {
            d["name"]: {
                "conservation": d.get("conservation") or {},
                "complete": d["complete"],
                "shard_indices": None,  # unknown post-hoc: internal-only
            }
            for d in dumps
            if d is not router_dump and d.get("conservation")
        }
        conservation = fleet_check_conservation(
            router_dump["conservation"], shard_books
        )
        from photon_ml_tpu_torch.reliability import atomic_write_json

        atomic_write_json(
            os.path.join(ns.out, "fleet_conservation.json"), conservation
        )
    ok = verification["ok"] and (
        conservation is None or conservation["ok"]
    )
    print(json.dumps({  # photon: entropy(operator-facing merge report; carries live merge wall-time by design)
        "fleet_trace": trace_out,
        "events": n_events,
        "members": len(dumps),
        "verification_ok": verification["ok"],
        "violations": verification["violations"][:5],
        "conservation_ok": (
            None if conservation is None else conservation["ok"]
        ),
    }, indent=2), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
