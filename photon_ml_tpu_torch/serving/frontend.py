"""Network front-end: a TCP JSON-lines accept loop in front of
``MicroBatcher.submit`` (a copy of ``photon_ml_tpu/serving/frontend.py``
over the port's batcher, which imports nothing of JAX).

The wire protocol is one JSON object per ``\\n``-terminated line, both
directions — the same GameExample-shaped records the stdin replay path
consumes (plus an optional ``deadline_ms``), so a request that works
through ``--request-paths -`` works verbatim over a socket. Responses
carry exactly one terminal ``status`` per request line:

- ``{"uid":…, "status":"ok", "score":…, "generation":…, "degraded":…}``
- ``{"uid":…, "status":"shed", "error":"SHED", "message":…}``
- ``{"uid":…, "status":"deadline_exceeded", "error":"DEADLINE_EXCEEDED",…}``
- ``{"uid":…, "status":"error", "error":<NAME>, "message":…}`` — named
  errors (``BAD_REQUEST``, ``READ_FAULT``, ``DRAIN_TIMEOUT``,
  ``DISPATCH_FAILED``, ``CLOSED``, ``INTERNAL``), never a crash and
  never silence.

The same port also speaks photon-wire's length-prefixed binary framing
(:mod:`photon_ml_tpu_torch.serving.wire`): the reader sniffs each
connection's FIRST byte — the frame magic selects binary for that
connection, anything else stays JSON-lines — so old clients and binary
routers coexist on one accept loop. Binary responses reuse the same
terminal-status dicts, hot paths (scores, partials, trace drains) ride
raw little-endian float buffers, and both protocols share one framing
cap (``max_frame_bytes``).

Control lines ``{"op": "status"|"ready"|"live"}`` answer the lifecycle
questions without touching the device: **readiness** (bank loaded +
ladder warm — ``ServingModel.ready()``) says "this replica may take
traffic"; **liveness** (the dispatcher heartbeat — beating even when
idle) says "this replica is not wedged". A load balancer drains on
not-ready and restarts on not-live; conflating them turns every staging
pause into a restart. ``{"op": "quarantine_re", "re_type": …}`` is the
operator's graceful-degradation lever: the named random-effect bank of
the CURRENT generation stops being consulted and affected requests
score FE-only with ``degraded: true`` until the next swap.

Robustness invariants (the "serving under fire" contract):

- **Bounded reads.** Per-connection reads are buffered with a hard
  ``max_line_bytes`` cap — an unframed flood gets a named error and the
  connection closed, never unbounded host memory.
- **Per-connection writer threads.** Responses are demuxed onto a
  bounded per-connection queue drained by a writer thread with a send
  timeout: a slow (or stalled) client backs up only its OWN queue; when
  that overflows the connection is dropped and counted
  (``frontend.connections_dropped_slow``) — the dispatcher and every
  other client are unaffected.
- **Fault seam.** Every received line crosses the
  ``serving.frontend.read`` reliability seam: a planned fault surfaces
  as a ``READ_FAULT`` error response on that connection, bit-for-bit
  reproducible from the fault plan, with the service still up.
- **Drain protocol.** ``stop_accepting()`` (SIGTERM) closes the
  listener and refuses new score lines with ``CLOSED``; the driver then
  drains the batcher within its budget (leftovers fail with
  ``DRAIN_TIMEOUT``) and ``close()`` flushes every writer queue and
  joins every connection thread — zero hung futures, zero leaked
  connections (``open_connections()`` is asserted by the chaos arm).
"""

from __future__ import annotations

import json
import os
import queue
import socket
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

from photon_ml_tpu_torch.obs import trace as obs_trace
from photon_ml_tpu_torch.obs.flight_recorder import flight_recorder
from photon_ml_tpu_torch.obs.trace import TRACE_KEY, start_span, wire_context
from photon_ml_tpu_torch.serving.admission import (
    DeadlineExceeded,
    DrainTimeout,
    PartialScore,
    RequestShed,
    ServingError,
)
from photon_ml_tpu_torch.serving.batcher import MicroBatcher, request_from_record
from photon_ml_tpu_torch.serving import wire

__all__ = ["ServingFrontend", "READ_SEAM"]

READ_SEAM = "serving.frontend.read"

# Framing cap: a line that exceeds this without a newline is not a
# request, it is a flood — named error, connection closed. The SAME cap
# refuses a binary frame length (wire.py); both resolve through
# wire.resolve_max_frame_bytes (explicit > PHOTON_MAX_FRAME_BYTES > 1 MiB).
DEFAULT_MAX_LINE_BYTES = wire.DEFAULT_MAX_FRAME_BYTES
# Bounded per-connection response queue (slow-client protection).
DEFAULT_WRITER_QUEUE = 1024
# Socket poll period: every blocking socket wait wakes at this beat to
# observe shutdown — no untimed waits anywhere on the request path.
POLL_S = 0.25
# A client that cannot absorb one response within this budget is
# stalled; its connection is dropped rather than wedging the writer.
DEFAULT_SEND_TIMEOUT_S = 5.0

_STATUS_OPS = ("status", "ready", "readiness", "live", "liveness", "health")


def _error_response(uid, code: str, message: str) -> Dict[str, object]:
    return {
        "uid": uid,
        "status": "error",
        "error": code,
        "message": message,
    }


def _outcome_response(uid, outcome, *, binary: bool = False) -> Dict[str, object]:
    if isinstance(outcome, PartialScore):
        # shard-server mode: the scatter/gather half-score. Floats ride
        # JSON as shortest-round-trip doubles holding exact f32 values,
        # so the router's recomposition is bitwise. On a binary
        # connection the PartialScore itself rides to the writer thread
        # (_wire_partial) and its f32 term VECTOR is encoded in one
        # buffer copy — no per-term dict is ever built.
        if binary:
            return {
                "uid": uid,
                "status": "ok",
                "partial": True,
                "generation": outcome.generation,
                "degraded": outcome.degraded,
                "_wire_partial": outcome,
            }
        return {
            "uid": uid,
            "status": "ok",
            "partial": True,
            "fe": outcome.fe,
            "terms": dict(outcome.terms),
            "generation": outcome.generation,
            "degraded": outcome.degraded,
        }
    return {
        "uid": uid,
        "status": "ok",
        "score": float(outcome),
        "generation": getattr(outcome, "generation", 0),
        "degraded": bool(getattr(outcome, "degraded", False)),
    }


def _failure_response(uid, exc: BaseException) -> Dict[str, object]:
    from photon_ml_tpu_torch.reliability import SeamFailure

    if isinstance(exc, RequestShed):
        return {
            "uid": uid, "status": "shed", "error": exc.code,
            "message": str(exc),
        }
    if isinstance(exc, DeadlineExceeded):
        return {
            "uid": uid, "status": "deadline_exceeded", "error": exc.code,
            "message": str(exc),
        }
    if isinstance(exc, DrainTimeout):
        return _error_response(uid, exc.code, str(exc))
    if isinstance(exc, ServingError):
        return _error_response(uid, exc.code, str(exc))
    if isinstance(exc, SeamFailure):
        return _error_response(uid, "DISPATCH_FAILED", str(exc))
    if isinstance(exc, TimeoutError):
        return _error_response(uid, "TIMEOUT", str(exc))
    return _error_response(uid, "INTERNAL", str(exc))


class _Connection:
    """One accepted socket: a reader thread (bounded framing ->
    request handling) and a writer thread (bounded queue -> coalesced
    sendall with a send timeout). Either side failing closes both.

    The reader sniffs the connection's FIRST byte: the wire magic
    selects binary framing for the whole connection; anything else is
    the JSON-lines protocol, unchanged."""

    def __init__(self, frontend: "ServingFrontend", sock: socket.socket,
                 peer: str):
        self.fe = frontend
        self.sock = sock
        self.peer = peer
        # single-writer atomic publish: the reader thread flips this to
        # "binary" ONCE at first-byte sniff, before any request (and so
        # any response the writer could encode) exists on the connection
        self.proto = "json"  # photon: guarded-by(atomic)
        self.outq: "queue.Queue" = queue.Queue(
            maxsize=frontend.writer_queue_max
        )
        self.closing = threading.Event()
        self.pending = 0
        self._pending_lock = threading.Lock()
        sock.settimeout(POLL_S)
        self.reader = threading.Thread(
            target=self._read_loop, name=f"photon-fe-read-{peer}",
            daemon=True,
        )
        self.writer = threading.Thread(
            target=self._write_loop, name=f"photon-fe-write-{peer}",
            daemon=True,
        )
        self.reader.start()
        self.writer.start()

    # -- response side -------------------------------------------------------

    def send(self, response: Dict[str, object]) -> None:
        """Enqueue one response; a full queue means THIS client is not
        keeping up — drop the connection (counted), never block the
        caller (which may be the dispatcher's done-callback)."""
        try:
            self.outq.put_nowait(response)
        except queue.Full:
            self.fe._note("connections_dropped_slow")
            self.closing.set()

    def _note_pending(self, delta: int) -> None:
        with self._pending_lock:
            self.pending += delta

    def _write_loop(self) -> None:
        out = bytearray()  # reused encode buffer: grows once, kept hot
        while True:
            try:
                resp = self.outq.get(timeout=POLL_S)
            except queue.Empty:
                if self.closing.is_set():
                    with self._pending_lock:
                        drained = self.pending == 0
                    if drained and self.outq.empty():
                        break
                continue
            # coalesce the backlog: every response already queued rides
            # the SAME sendall — one syscall per burst, not per response
            batch = [resp]
            while True:
                try:
                    batch.append(self.outq.get_nowait())
                except queue.Empty:
                    break
            del out[:]
            if self.proto == "binary":
                for r in batch:
                    wire.append_response(out, r)
            else:
                for r in batch:
                    out += json.dumps(r).encode("utf-8")
                    out += b"\n"
            try:
                self.sock.settimeout(DEFAULT_SEND_TIMEOUT_S)
                self.sock.sendall(out)
                self.sock.settimeout(POLL_S)
            except OSError:
                self.fe._note("connections_dropped_slow")
                self.closing.set()
                break
            if len(batch) > 1:
                self.fe._note("coalesced_responses", len(batch) - 1)
            if self.fe.metrics is not None:
                for r in batch:
                    self.fe.metrics.record_response(str(r.get("status")))
        self._shutdown_socket()

    # -- request side --------------------------------------------------------

    def _read_loop(self) -> None:
        # first-byte protocol sniff: a binary client's very first byte
        # is the frame magic — not a legal first byte of any JSON-lines
        # request — so one byte decides the connection's protocol and
        # JSON clients keep working unchanged on the same port
        buf = b""
        while not self.closing.is_set() and not buf:
            try:
                buf = self.sock.recv(1 << 16)
            except socket.timeout:
                continue
            except OSError:
                self.closing.set()
                return
            if not buf:
                self.closing.set()
                return  # EOF before any byte
        if buf and buf[0] == wire.MAGIC:
            self.proto = "binary"
            self._read_frames(buf)
        else:
            self._read_lines(buf)
        self.closing.set()

    def _read_lines(self, buf: bytes) -> None:
        from photon_ml_tpu_torch.reliability import (
            InjectedCorruption,
            InjectedFault,
            inject,
        )

        while not self.closing.is_set():
            nl = buf.find(b"\n")
            if nl < 0:
                if len(buf) > self.fe.max_frame_bytes:
                    # unframed flood: named error, then close — framing
                    # cannot be recovered past the cap
                    self.fe._note("oversized")
                    self.send(_error_response(
                        None, "BAD_REQUEST",
                        f"line exceeds {self.fe.max_frame_bytes} bytes",
                    ))
                    break
                try:
                    chunk = self.sock.recv(1 << 16)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not chunk:
                    break  # EOF
                buf += chunk
                continue
            line, buf = buf[:nl], buf[nl + 1:]
            if not line.strip():
                continue
            self.fe._note("lines")
            try:
                # the reliability seam: one crossing per received line,
                # so "fail the 3rd read with EIO" replays exactly
                inject(READ_SEAM, detail=self.peer)
            except (InjectedFault, InjectedCorruption, OSError) as e:
                self.fe._note("read_faults")
                self.send(_error_response(None, "READ_FAULT", str(e)))
                continue
            self._handle_line(line)

    def _read_frames(self, buf: bytes) -> None:
        from photon_ml_tpu_torch.reliability import (
            InjectedCorruption,
            InjectedFault,
            inject,
        )

        decoder = wire.FrameDecoder(self.fe.max_frame_bytes)
        while not self.closing.is_set():
            try:
                frames = decoder.feed(buf)
            except wire.WireError as e:
                # framing provably lost (bad magic/version) or a giant
                # announced length: the binary twin of the oversized
                # line — named refusal, then close (framing cannot be
                # recovered; a lying length never buffers its payload)
                self.fe._note(
                    "oversized" if e.kind == "oversized" else "malformed"
                )
                self.send(_error_response(None, "BAD_REQUEST", str(e)))
                break
            for mtype, payload in frames:
                self.fe._note("lines")
                try:
                    # same seam, same cadence: one crossing per frame
                    inject(READ_SEAM, detail=self.peer)
                except (InjectedFault, InjectedCorruption, OSError) as e:
                    self.fe._note("read_faults")
                    self.send(_error_response(None, "READ_FAULT", str(e)))
                    continue
                self._handle_frame(mtype, payload)
            try:
                buf = self.sock.recv(1 << 16)
            except socket.timeout:
                buf = b""
                continue
            except OSError:
                break
            if not buf:
                break  # EOF (a mid-frame disconnect just drops the tail)

    def _handle_frame(self, mtype: int, payload: bytes) -> None:
        try:
            if mtype == wire.MSG_SCORE_REQUEST:
                obj = wire.decode_score_request(payload)
            elif mtype == wire.MSG_JSON:
                obj = wire.decode_message(mtype, payload)
            else:
                raise wire.WireError(
                    f"unexpected message type 0x{mtype:02x} on the "
                    "request side"
                )
        except wire.WireError as e:
            self.fe._note("malformed")
            self.send(_error_response(None, "BAD_REQUEST", str(e)))
            return
        self._handle_obj(obj)

    def _handle_line(self, line: bytes) -> None:
        try:
            obj = json.loads(line.decode("utf-8"))
            if not isinstance(obj, dict):
                raise ValueError("request must be a JSON object")
        except (ValueError, UnicodeDecodeError) as e:
            self.fe._note("malformed")
            self.send(_error_response(None, "BAD_REQUEST", str(e)))
            return
        self._handle_obj(obj)

    def _handle_obj(self, obj: Dict) -> None:
        op = obj.get("op")
        if op is not None:
            self.fe._note("control")
            if str(op) in _STATUS_OPS:
                self.send(self.fe.status_response(str(op)))
            elif str(op) == "metrics":
                # live wire exposition of the process metrics plane:
                # the registry's merged snapshot (instruments + every
                # subsystem view), or Prometheus-style text with
                # {"format": "prometheus"} — without a registry wired
                # the op still answers from the serving accumulator
                self.send(self.fe.metrics_response(obj))
            elif str(op) == "trace":
                # incremental span drain for the fleet collector:
                # cursor/seq-keyed so polls never duplicate or drop
                # spans, plus the (wall, perf) epoch + epoch-mapped
                # "now" for NTP-style clock-skew estimation
                self.send(self.fe.trace_response(obj))
            elif str(op) == "flight":
                rec = flight_recorder()
                self.send({
                    "uid": obj.get("uid"),
                    "status": "ok",
                    "op": op,
                    "flight": rec.snapshot(),
                    "conservation": rec.check_conservation(),
                })
            elif str(op) == "dump_flight":
                if not self.fe.flight_dump_path:
                    self.send(_error_response(
                        obj.get("uid"), "BAD_REQUEST",
                        "no flight dump path configured (--obs-dir)",
                    ))
                    return
                path = flight_recorder().dump(
                    self.fe.flight_dump_path, reason="operator op"
                )
                self.send({
                    "uid": obj.get("uid"),
                    "status": "ok" if path else "error",
                    "op": op,
                    "path": path,
                })
            elif str(op) == "quarantine_re":
                # operator lever for graceful degradation: mark one RE
                # coordinate of the CURRENT generation unusable —
                # affected requests score FE-only with degraded=True
                # until the next swap installs a clean bank
                re_type = str(obj.get("re_type"))
                try:
                    self.fe.serving_model.quarantine_re(re_type)
                except ValueError as e:
                    self.send(_error_response(
                        obj.get("uid"), "BAD_REQUEST", str(e)
                    ))
                    return
                self.send({
                    "status": "ok",
                    "op": op,
                    "re_type": re_type,
                    "generation": self.fe.serving_model.generation,
                })
            elif str(op) == "rollback":
                # operator lever: flip back to the parent generation
                # (registry watcher required — a replay-mode service
                # has no lineage to roll along)
                if self.fe.rollback_handler is None:
                    self.send(_error_response(
                        obj.get("uid"), "BAD_REQUEST",
                        "no registry watcher attached: rollback needs "
                        "generation lineage",
                    ))
                    return
                ok = bool(self.fe.rollback_handler())
                self.send({
                    "status": "ok" if ok else "error",
                    "op": op,
                    "rolled_back": ok,
                    "generation": self.fe.serving_model.generation,
                })
            elif str(op) in self.fe.extra_ops:
                # extension ops (shard topology / two-step swap):
                # handler failures become named responses, never a
                # dropped line or a dead connection
                try:
                    resp = self.fe.extra_ops[str(op)](obj)
                except Exception as e:
                    resp = _error_response(obj.get("uid"), "INTERNAL",
                                           str(e))
                self.send(resp)
            else:
                self.send(_error_response(
                    obj.get("uid"), "BAD_REQUEST", f"unknown op {op!r}"
                ))
            return
        self.fe._handle_score(self, obj)

    # -- teardown ------------------------------------------------------------

    def _shutdown_socket(self) -> None:
        try:
            self.sock.close()
        except OSError:
            self.fe._note("socket_close_errors")
        self.fe._forget(self)

    def join(self, timeout_s: float) -> None:
        self.closing.set()
        self.reader.join(timeout=timeout_s)
        self.writer.join(timeout=timeout_s)


class ServingFrontend:
    """The accept loop + connection registry in front of one
    :class:`MicroBatcher`. See the module docstring for the protocol
    and the robustness contract."""

    def __init__(
        self,
        batcher: MicroBatcher,
        serving_model,
        shard_configs,
        *,
        metrics=None,
        host: str = "127.0.0.1",
        port: int = 0,
        has_response: bool = True,
        max_line_bytes: Optional[int] = None,
        max_frame_bytes: Optional[int] = None,
        writer_queue_max: int = DEFAULT_WRITER_QUEUE,
        on_completion: Optional[Callable[[int], None]] = None,
        on_outcome: Optional[Callable[[bool, bool, bool], None]] = None,
        lineage_provider: Optional[Callable[[], Dict]] = None,
        rollback_handler: Optional[Callable[[], bool]] = None,
        extra_ops: Optional[Dict[str, Callable[[Dict], Dict]]] = None,
        status_extra: Optional[Callable[[], Dict]] = None,
        metrics_registry=None,
        flight_dump_path: Optional[str] = None,
    ):
        self.batcher = batcher
        self.serving_model = serving_model
        self.shard_configs = shard_configs
        self.metrics = metrics
        # live telemetry exposition (obs/): {"op": "metrics"} serves
        # the process registry's merged snapshot (JSON or Prometheus
        # text); {"op": "flight"} serves the flight-recorder ring +
        # conservation verdict; {"op": "dump_flight"} persists it to
        # the operator-configured path (never a wire-supplied one)
        self.metrics_registry = metrics_registry
        self.flight_dump_path = flight_dump_path
        self.host = host
        self.has_response = bool(has_response)
        # ONE framing cap for both protocols (JSON line length == binary
        # frame length): explicit arg > PHOTON_MAX_FRAME_BYTES env >
        # 1 MiB. max_line_bytes is the legacy spelling of the same knob.
        self.max_frame_bytes = wire.resolve_max_frame_bytes(
            max_frame_bytes if max_frame_bytes is not None
            else max_line_bytes
        )
        self.max_line_bytes = self.max_frame_bytes
        self.writer_queue_max = int(writer_queue_max)
        self.on_completion = on_completion
        # continuous-retraining hooks (registry.watcher): per-outcome
        # health feed (ok, degraded, failed), generation-lineage block
        # for the status op, and the operator rollback lever
        self.on_outcome = on_outcome
        self.lineage_provider = lineage_provider
        self.rollback_handler = rollback_handler
        # extension seam (serving/shard_server.py): extra control ops
        # (op name -> handler(request dict) -> response dict, which MUST
        # echo the request's uid for routed demux) and an extra block
        # merged into every status payload (shard topology)
        self.extra_ops = dict(extra_ops or {})
        self.status_extra = status_extra
        self._completed = 0
        self._completed_lock = threading.Lock()
        self._conns: List[_Connection] = []
        self._conns_lock = threading.Lock()
        self._accepting = threading.Event()
        self._stopped = threading.Event()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(
            socket.SOL_SOCKET, socket.SO_REUSEADDR, 1
        )
        self._listener.bind((host, int(port)))
        self.port = self._listener.getsockname()[1]
        self._accept_thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServingFrontend":
        self._listener.listen(128)
        self._listener.settimeout(POLL_S)
        self._accepting.set()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="photon-fe-accept", daemon=True
        )
        self._accept_thread.start()
        return self

    def stop_accepting(self) -> None:
        """SIGTERM step 1: close the listener; established connections
        keep receiving responses for already-admitted work, but new
        score lines are refused with ``CLOSED``.

        The shutdown() wakes an accept() blocked in another thread —
        CPython defers the actual close until accept returns, so
        without it the port would keep accepting for up to one poll
        period after "stop"."""
        self._accepting.clear()
        self._stopped.set()
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # already shut down / never listened
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2 * POLL_S + 1.0)
        try:
            self._listener.close()
        except OSError:
            self._note("socket_close_errors")

    def close(self, timeout_s: float = DEFAULT_SEND_TIMEOUT_S) -> None:
        """Final teardown: flush + close every connection, join every
        thread (all bounded). Call after the batcher has drained so
        every pending future already holds its terminal outcome."""
        self.stop_accepting()
        with self._conns_lock:
            conns = list(self._conns)
        deadline = time.perf_counter() + max(timeout_s, 0.1)
        for c in conns:
            c.join(max(deadline - time.perf_counter(), 0.1))
        if self._accept_thread is not None:
            self._accept_thread.join(
                timeout=max(deadline - time.perf_counter(), 0.1)
            )
        with self._conns_lock:
            leaked = list(self._conns)
        for c in leaked:
            c._shutdown_socket()

    def open_connections(self) -> int:
        with self._conns_lock:
            return len(self._conns)

    def completed(self) -> int:
        with self._completed_lock:
            return self._completed

    @property
    def draining(self) -> bool:
        return self._stopped.is_set()

    def status_response(self, op: str = "status") -> Dict[str, object]:
        """Readiness + liveness in one payload: ``ready`` gates traffic
        (bank live, ladder warm), ``alive``/``heartbeat_age_s`` gate
        restarts (dispatcher beating). With a registry watcher attached
        the payload also carries generation LINEAGE (registry
        generation, parent chain, last swap/rollback outcome) — the
        operator's one-stop "what exactly is serving right now"."""
        out = {
            "status": "ok",
            "op": op,
            "ready": bool(
                self.serving_model.ready()
                and not self.batcher.draining
                and not self.batcher.closed
                and not self._stopped.is_set()
            ),
            "alive": self.batcher.alive(),
            "heartbeat_age_s": round(self.batcher.heartbeat_age_s(), 4),
            "draining": self._stopped.is_set() or self.batcher.draining,
            "generation": self.serving_model.generation,
            "queue_depth": self.batcher.queue_depth(),
            # the wire contract: what this frontend speaks (routers
            # negotiate the data plane from the same block in topology)
            # and the frame/line cap it enforces
            "wire": {
                "protocols": list(wire.WIRE_PROTOCOLS),
                "version": wire.WIRE_VERSION,
                "max_frame_bytes": self.max_frame_bytes,
            },
        }
        history = getattr(self.serving_model, "swap_history", None)
        if history:
            last = history[-1]
            out["last_swap"] = {
                "ok": last.ok,
                "generation": last.generation,
                "donated": last.donated,
                "rolled_back": last.rolled_back,
                "error": last.error,
            }
        if self.lineage_provider is not None:
            try:
                out["registry"] = self.lineage_provider()
            except Exception as e:
                # status must answer even when the watcher is wedged
                out["registry"] = {"error": str(e)}
        if self.status_extra is not None:
            try:
                out.update(self.status_extra())
            except Exception as e:
                out["status_extra_error"] = str(e)
        return out

    def metrics_response(self, obj: Dict) -> Dict[str, object]:
        """The ``{"op": "metrics"}`` payload: the live process registry
        when one is wired (driver ``--obs-dir`` / explicit ctor arg),
        otherwise the serving accumulator's snapshot — the op always
        answers. ``format: "prometheus"`` returns text exposition."""
        uid = obj.get("uid")
        fmt = str(obj.get("format") or "json").lower()
        reg = self.metrics_registry
        if fmt == "prometheus":
            if reg is None:
                return _error_response(
                    uid, "BAD_REQUEST",
                    "prometheus exposition needs a metrics registry "
                    "(--obs-dir)",
                )
            return {
                "uid": uid, "status": "ok", "op": "metrics",
                "format": "prometheus", "text": reg.prometheus(),
            }
        if reg is not None:
            payload = reg.snapshot()
        elif self.metrics is not None:
            payload = {"serving": self.metrics.snapshot()}
        else:
            payload = {}
        return {
            "uid": uid, "status": "ok", "op": "metrics",
            "metrics": payload,
        }

    def trace_response(self, obj: Dict) -> Dict[str, object]:  # photon: entropy(live trace-poll payload; epoch/now mapping is the protocol)
        """The ``{"op": "trace"}`` payload: the process tracer's spans
        AFTER the caller's cursor (contiguous seq run; evictions since
        the last poll are counted in ``dropped``), the process's
        ``(wall, perf)`` epoch, and an epoch-mapped ``now_perf`` so the
        caller can run one NTP-style offset estimate per poll. The
        cursor contract: pass ``cursor`` back verbatim on the next poll
        — no span is ever sent twice, and a cursor from before a ring
        reset restarts cleanly from the beginning."""
        uid = obj.get("uid")
        try:
            cursor = int(obj.get("cursor") or 0)
        except (TypeError, ValueError):
            return _error_response(
                uid, "BAD_REQUEST", "cursor must be an integer"
            )
        t = obs_trace.tracer()
        spans, new_cursor, dropped = t.read_since(cursor)
        epoch_wall, epoch_perf = obs_trace.epoch()
        return {
            "uid": uid,
            "status": "ok",
            "op": "trace",
            "pid": os.getpid(),
            "enabled": obs_trace.tracing_enabled(),
            "epoch_wall": epoch_wall,
            "epoch_perf": epoch_perf,
            "now_perf": time.perf_counter(),
            "cursor": new_cursor,
            "dropped": dropped,
            "max_spans": t.max_spans,
            "spans": [s.to_dict() for s in spans],
        }

    # -- internals -----------------------------------------------------------

    def _note(self, event: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.record_frontend(event, n)

    def _forget(self, conn: _Connection) -> None:
        with self._conns_lock:
            if conn in self._conns:
                self._conns.remove(conn)
        self._note("connections_closed")

    def _accept_loop(self) -> None:
        while self._accepting.is_set():
            try:
                sock, addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # listener closed (drain)
            if not self._accepting.is_set():
                try:
                    sock.close()
                except OSError:
                    self._note("socket_close_errors")
                break
            peer = f"{addr[0]}:{addr[1]}"
            conn = _Connection(self, sock, peer)
            with self._conns_lock:
                self._conns.append(conn)
            self._note("connections_opened")

    def _handle_score(self, conn: _Connection, record: Dict) -> None:
        uid = record.get("uid")
        if self._stopped.is_set():
            conn.send(_error_response(
                uid, "CLOSED", "front-end is draining"
            ))
            return
        try:
            req = request_from_record(
                record,
                self.serving_model.current(),
                self.shard_configs,
                has_response=self.has_response,
            )
        except (ValueError, KeyError, TypeError) as e:
            self._note("malformed")
            conn.send(_error_response(uid, "BAD_REQUEST", str(e)))
            return
        # trace ids are minted HERE, at the edge: a request arriving
        # with wire context joins the caller's trace (the router's
        # sub-request path), a bare one roots a fresh trace. The span
        # covers queue wait + dispatch + demux; the dispatch-window
        # child is stamped by the batcher under req.parent_span.
        wire_t, wire_p = wire_context(record)
        sp = start_span(
            "frontend.request", trace_id=wire_t, parent_id=wire_p,
            uid=str(uid) if uid is not None else "",
        )
        if sp.trace_id is not None:
            req.trace_id = sp.trace_id
            req.parent_span = sp.span_id
        else:
            # tracing off on this hop: still RELAY the caller's context
            # so downstream hops (and the response echo) stay connected
            req.trace_id, req.parent_span = wire_t, wire_p
        try:
            fut = self.batcher.submit(req)
        except ServingError as e:
            sp.end(status="refused", error=type(e).__name__)
            conn.send(_failure_response(uid, e))
            return
        conn._note_pending(+1)
        fut.add_done_callback(
            lambda f, c=conn, u=req.uid, t=req.trace_id, s=sp:
            self._on_done(c, u, f, trace_id=t, span=s)
        )

    def _on_done(
        self, conn: _Connection, uid: str, fut: Future,
        *, trace_id: Optional[str] = None, span=None,
    ) -> None:
        # runs on the dispatcher (or drain) thread: the future is
        # already terminal, so result(timeout=0) cannot block
        try:
            outcome = fut.result(timeout=0)
            resp = _outcome_response(
                uid, outcome, binary=conn.proto == "binary"
            )
            ok, degraded, failed = (
                True, bool(getattr(outcome, "degraded", False)), False,
            )
        except BaseException as e:
            resp = _failure_response(uid, e)
            ok, degraded, failed = False, False, True
        if trace_id is not None:
            # the response echoes the trace id so the client (router or
            # operator) can stitch both sides of the wire
            resp[TRACE_KEY] = trace_id
        if span is not None:
            span.end(status=str(resp.get("status")), degraded=degraded)
        hook = self.on_outcome
        if hook is not None:
            try:
                # the registry watcher's post-swap health feed: two
                # boolean ORs on the response path, never a swap
                hook(ok, degraded, failed)
            except Exception:
                self._note("completion_hook_errors")
        # ENQUEUE the response BEFORE decrementing pending: the writer
        # thread's drain check is "pending == 0 and queue empty", so a
        # decrement-first ordering opens a window where a closing
        # writer observes both true between our two steps and exits
        # with the final response still in hand — a silently dropped
        # response at drain time (pinned by the interleaving harness
        # test; the schedule is replayable from its seed)
        conn.send(resp)
        conn._note_pending(-1)
        with self._completed_lock:
            self._completed += 1
            n = self._completed
        hook = self.on_completion
        if hook is not None:
            try:
                hook(n)
            except Exception:
                # a completion hook (e.g. the driver's swap trigger)
                # must never take down the response path; failures are
                # visible in its own accounting
                self._note("completion_hook_errors")
