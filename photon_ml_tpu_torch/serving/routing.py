"""Scatter/gather routing tier: planet-scale serving over entity-sharded
shard-servers (a copy of ``photon_ml_tpu/serving/routing.py``; the router
touches no tensor and never creates a CUDA context).

The Podracer split (PAPERS.md) applied to GAME serving: THIN routers in
front of N device-resident scorers, where shard-server ``s`` holds
exactly the ``1/N`` slice of every random-effect bank that the shared
ownership rule (:mod:`photon_ml_tpu_torch.ownership` — the same ``e % N`` the
pod trainer places banks with) assigns to it. The router holds no
coefficients at all: just the model's entity-id -> code indexes (the
O(1) :class:`~.model_bank.EntityRowIndex` machinery, mmap-backed above
100k ids) and persistent connections to the fleet. Per request it:

1. resolves each raw entity id to its code and its code to its OWNING
   shard (``ownership.owner_of``) — the scatter set is the owners, not
   the fleet, so per-request work does not grow with N;
2. scatters one partial-score sub-request per owning shard (plus one
   designated shard for the fixed-effect half — every shard holds the
   full FE banks, so any healthy shard can provide it, bitwise);
3. gathers the per-coordinate terms and re-sums them HOST-SIDE in
   float32, in the bank spec's exact accumulation order, finishing
   with the request's offset — each step an exactly-rounded IEEE add,
   which is what makes the routed margin **bitwise-equal** to the
   single-server serving path and the batch scorer (the DrJAX
   map/reduce framing: shard-local map, order-pinned reduce).

**Degradation is per-shard, never an outage.** Each shard has a health
window + circuit breaker; a dead, shedding or deadline-blown shard
yields FE-only terms for *its* entities only, flagged ``degraded`` —
exactly the unknown-entity zero the single-server path adds — while
every other shard's terms stay exact. Sub-requests run under the
request's own deadline budget with a hedged-or-shed policy: a slow
shard is hedged once on a fresh connection inside the remaining
budget, then shed (degraded) — the p99 does not ride the slowest
shard. Only a fleet with NO healthy shard refuses outright
(:class:`~.admission.NoShardAvailable` — without FE there is nothing
left to degrade to).

**Hot-entity cache.** Head-skewed (zipf) traffic re-scores the same
few entities with the same features; the router absorbs it with a
bounded LRU over ``(generation, slot, blake2b(entity, features))`` ->
term. Keys carry the routing generation, so a cached gen-N partial can
never serve under gen-N+1 by construction, and the whole map is purged
atomically at swap-commit. Only deterministic paths populate it
(non-degraded responses at the current generation), so a cache hit is
bitwise the cold path — pinned by tests.

**Two-step generation flip.** Shard generations must advance in
lockstep (a margin summed from gen-N and gen-N+1 terms matches neither
model), so the router coordinates swaps: phase 1 stages the new
generation on EVERY shard (slow work under live traffic; any failure
aborts the others and nobody flips), phase 2 commits shard by shard
(each a sub-ms flip), then the router bumps its own generation and
purges the cache under one lock. In-flight gathers that straddle the
commit wave detect mixed generations and re-scatter once against the
settled fleet.
"""

from __future__ import annotations

import hashlib
import json
import socket
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch import ownership
from photon_ml_tpu_torch.obs.flight_recorder import flight_recorder
from photon_ml_tpu_torch.obs.trace import (
    PARENT_KEY,
    TRACE_KEY,
    start_span,
    wire_context,
)
from photon_ml_tpu_torch.serving import wire as wirefmt
from photon_ml_tpu_torch.serving.admission import NoShardAvailable, ScoreOutcome
from photon_ml_tpu_torch.serving.model_bank import EntityRowIndex

__all__ = [
    "RoutedScore",
    "RoutingPolicy",
    "ShardHealth",
    "HotEntityCache",
    "TcpShardTransport",
    "RouterMetrics",
    "ShardRouter",
]

# Poll beat for every blocking wait on the router's paths (request-path
# hygiene: no untimed waits anywhere).
POLL_S = 0.25
# Default sub-request budget when the request carries no deadline.
DEFAULT_SUBREQUEST_TIMEOUT_S = 2.0
# Control-plane ops (topology, stage/commit) may do artifact IO.
CONTROL_TIMEOUT_S = 120.0
# The fe slot's cache key name (no spec coordinate is ever named this:
# coordinate names come from artifacts, this is not a legal one).
FE_SLOT = "__fe__"


class RoutedScore(ScoreOutcome):
    """A routed margin: still a float (the bitwise parity tests compare
    it raw), still carrying ``degraded``/``generation``, plus the
    routing annotations: how many shards the request fanned out to
    (0 = served entirely from the hot-entity cache), whether every slot
    came from cache, and which shards degraded to FE-only."""

    __slots__ = ("fanout", "cache_hit", "degraded_shards", "fe_shard")

    def __new__(
        cls,
        value: float,
        *,
        degraded: bool = False,
        generation: int = 0,
        fanout: int = 0,
        cache_hit: bool = False,
        degraded_shards: Tuple[int, ...] = (),
        fe_shard: Optional[int] = None,
    ) -> "RoutedScore":
        self = super().__new__(
            cls, value, degraded=degraded, generation=generation
        )
        self.fanout = int(fanout)
        self.cache_hit = bool(cache_hit)
        self.degraded_shards = tuple(degraded_shards)
        # which shard provided the fixed-effect half (None = the hot
        # cache did): the fleet-conservation attribution key — every
        # wire-served request is attributed to exactly ONE shard
        self.fe_shard = None if fe_shard is None else int(fe_shard)
        return self


@dataclass(frozen=True)
class RoutingPolicy:
    """The hedged-or-shed knobs.

    ``hedge_frac`` of the remaining budget is given to the first
    attempt; if it times out and ``hedge`` is on, ONE hedge goes out on
    a fresh connection for the remainder — tail latency from a slow
    connection costs one retry, never the whole budget twice. Shards
    whose circuit is open (``fail_threshold`` consecutive failures) are
    skipped outright for ``cooldown_s``, then probed half-open.
    """

    hedge: bool = True
    hedge_frac: float = 0.5
    subrequest_timeout_s: float = DEFAULT_SUBREQUEST_TIMEOUT_S
    fail_threshold: int = 3
    cooldown_s: float = 2.0
    health_window: int = 64


class ShardHealth:
    """Per-shard health: a sliding outcome window for observability and
    a consecutive-failure circuit breaker for routing decisions.

    ``allow()`` is consulted before every sub-request: CLOSED (healthy)
    admits; OPEN (tripped) refuses until ``cooldown_s`` elapsed, then
    admits probes (half-open) — a recovered shard heals itself on the
    first success, a still-dead one re-opens on the probe's failure.
    """

    def __init__(
        self, shard_index: int, policy: RoutingPolicy, *, recorder=None
    ):
        self.shard_index = int(shard_index)
        self._policy = policy
        self._lock = threading.Lock()
        self._window: List[int] = []
        self._consecutive_failures = 0
        self._open_until = 0.0
        self._failures_total = 0
        self._successes_total = 0
        self._flight = (
            recorder if recorder is not None else flight_recorder()
        )

    def note(self, ok: bool) -> None:
        transition = None
        with self._lock:
            was_open = (
                self._consecutive_failures >= self._policy.fail_threshold
            )
            self._window.append(0 if ok else 1)
            if len(self._window) > self._policy.health_window:
                self._window.pop(0)
            if ok:
                self._consecutive_failures = 0
                self._open_until = 0.0
                self._successes_total += 1
                if was_open:
                    transition = "close"
            else:
                self._consecutive_failures += 1
                self._failures_total += 1
                if self._consecutive_failures >= self._policy.fail_threshold:
                    self._open_until = (
                        time.monotonic() + self._policy.cooldown_s
                    )
                    if not was_open:
                        transition = "open"
        if transition is not None:
            # breaker transitions are flight-recorder events (recorded
            # OUTSIDE this health window's lock — the recorder has its
            # own); per-call outcomes stay counters, not events
            self._flight.record(
                f"circuit.{transition}", shard=self.shard_index
            )

    def allow(self) -> bool:
        with self._lock:
            if self._consecutive_failures < self._policy.fail_threshold:
                return True
            # open: admit again once the cooldown passed (half-open
            # probe; a failure re-arms the cooldown via note())
            return time.monotonic() >= self._open_until

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            n = len(self._window)
            return {
                "shard": self.shard_index,
                "healthy": (
                    self._consecutive_failures < self._policy.fail_threshold
                    or time.monotonic() >= self._open_until
                ),
                "consecutive_failures": self._consecutive_failures,
                "window_unhealthy_rate": (
                    round(sum(self._window) / n, 4) if n else 0.0
                ),
                "successes": self._successes_total,
                "failures": self._failures_total,
            }


class HotEntityCache:
    """Bounded LRU over ``(generation, slot, digest)`` -> float32 term.

    ``slot`` is a spec coordinate name (or :data:`FE_SLOT`), ``digest``
    a blake2b over the entity id + the exact feature payload the term
    depends on — so a hit is the deterministic replay of the cold
    path's float, bit for bit. Generation lives IN the key: a stale
    generation's entry can never answer a lookup at the live one, and
    :meth:`purge_other_generations` drops the dead weight atomically at
    swap-commit. ``max_entries <= 0`` disables caching entirely."""

    def __init__(self, max_entries: int = 4096):
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        self._map: Dict[tuple, float] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.purged = 0

    @property
    def enabled(self) -> bool:
        return self.max_entries > 0

    def get(self, key: tuple) -> Optional[float]:
        if not self.enabled:
            return None
        with self._lock:
            if key in self._map:
                v = self._map.pop(key)
                self._map[key] = v  # recency touch
                self.hits += 1
                return v
            self.misses += 1
            return None

    def put(self, key: tuple, value: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._map.pop(key, None)
            while len(self._map) >= self.max_entries:
                self._map.pop(next(iter(self._map)))
                self.evictions += 1
            self._map[key] = float(value)

    def purge_other_generations(self, generation: int) -> int:
        """Drop every entry not keyed to ``generation`` — ONE atomic
        sweep under the lock, called at swap-commit so no reader can
        observe a mix of old and new entries."""
        with self._lock:
            dead = [k for k in self._map if k[0] != generation]
            for k in dead:
                del self._map[k]
            self.purged += len(dead)
            return len(dead)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._map),
                "max_entries": self.max_entries,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "purged": self.purged,
            }


class TransportError(RuntimeError):
    """A sub-request could not complete at the transport level
    (connect/send/receive failure or timeout). The router converts it
    into per-shard degradation, never a request failure."""


class TcpShardTransport:
    """One persistent connection to a shard-server, safe for concurrent
    callers: requests are multiplexed by uid — senders serialize on a
    write lock, a reader thread demuxes responses into per-uid futures.
    A connection-level failure fails every pending future (the router
    then degrades/hedges); the transport is single-use after that (the
    router opens a fresh one).

    ``wire`` picks the protocol for the WHOLE connection: ``"json"``
    is the JSON-lines plane; ``"binary"`` speaks photon-wire frames
    (the shard frontend sniffs our first byte) — score sub-requests
    and partial responses ride raw float buffers, control objects ride
    MSG_JSON frames, and encodes reuse one per-transport buffer.
    """

    def __init__(
        self,
        host: str,
        port: int,
        *,
        connect_timeout_s: float = 5.0,
        wire: str = "json",
        max_frame_bytes: Optional[int] = None,
    ):
        self.host = host
        self.port = int(port)
        self.wire = str(wire)
        if self.wire not in wirefmt.WIRE_PROTOCOLS:
            raise ValueError(
                f"unknown wire protocol {wire!r} "
                f"(know {wirefmt.WIRE_PROTOCOLS})"
            )
        self.max_frame_bytes = wirefmt.resolve_max_frame_bytes(
            max_frame_bytes
        )
        self._sock = socket.create_connection(
            (host, int(port)), timeout=connect_timeout_s
        )
        self._sock.settimeout(POLL_S)
        self._send_lock = threading.Lock()
        # reused per-connection encode buffer; mutated ONLY under
        # _send_lock (the same lock that orders the sendalls)
        self._encode_buf = bytearray()
        self._lock = threading.Lock()  # guards _pending
        self._pending: Dict[str, Future] = {}
        self.unmatched_responses = 0
        self._closed = threading.Event()
        self._reader = threading.Thread(
            target=self._read_loop,
            name=f"photon-router-read-{host}:{port}",
            daemon=True,
        )
        self._reader.start()

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def send_request(self, obj: Mapping) -> Future:
        """Ship one request (a JSON line or a binary frame, per the
        connection's protocol); the returned future resolves with the
        response object for ``obj['uid']`` (callers wait with their own
        timeout)."""
        uid = obj["uid"]
        fut: Future = Future()
        with self._lock:
            if self._closed.is_set():
                raise TransportError(
                    f"connection to {self.host}:{self.port} is closed"
                )
            self._pending[uid] = fut
        try:
            if self.wire == "binary":
                with self._send_lock:
                    buf = self._encode_buf
                    del buf[:]
                    if "op" in obj:
                        # control objects ride MSG_JSON frames — same
                        # framing, no hot-path codec needed
                        wirefmt.append_json(buf, obj)
                    else:
                        wirefmt.append_score_request(buf, obj)
                    self._sock.sendall(buf)
            else:
                data = (json.dumps(obj) + "\n").encode("utf-8")
                with self._send_lock:
                    self._sock.sendall(data)
        except OSError as e:
            with self._lock:
                self._pending.pop(uid, None)
            self._fail_all(e)
            raise TransportError(
                f"send to {self.host}:{self.port} failed: {e}"
            ) from e
        return fut

    def abandon(self, uid: str) -> None:
        """Forget a pending uid (hedged-away / timed-out attempt); its
        late response, if any, is counted unmatched and dropped."""
        with self._lock:
            self._pending.pop(uid, None)

    def request(self, obj: Mapping, timeout_s: float):
        """Send + wait, bounded. Timeout abandons the uid (a late
        response is counted unmatched and dropped)."""
        fut = self.send_request(obj)
        try:
            return fut.result(timeout=max(timeout_s, 0.001))
        except (TimeoutError, _FutureTimeout):
            self.abandon(obj["uid"])
            raise TransportError(
                f"no response from {self.host}:{self.port} within "
                f"{timeout_s * 1e3:.0f}ms"
            ) from None

    def _read_loop(self) -> None:
        if self.wire == "binary":
            self._read_frames()
            return
        buf = b""
        while not self._closed.is_set():
            nl = buf.find(b"\n")
            if nl < 0:
                try:
                    chunk = self._sock.recv(1 << 16)
                except socket.timeout:
                    continue
                except OSError as e:
                    self._fail_all(e)
                    return
                if not chunk:
                    self._fail_all(ConnectionError("EOF from shard"))
                    return
                buf += chunk
                continue
            line, buf = buf[:nl], buf[nl + 1:]
            if not line.strip():
                continue
            try:
                resp = json.loads(line.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                self.unmatched_responses += 1
                continue
            self._dispatch_response(resp)

    def _read_frames(self) -> None:
        decoder = wirefmt.FrameDecoder(self.max_frame_bytes)
        while not self._closed.is_set():
            try:
                chunk = self._sock.recv(1 << 16)
            except socket.timeout:
                continue
            except OSError as e:
                self._fail_all(e)
                return
            if not chunk:
                self._fail_all(ConnectionError("EOF from shard"))
                return
            try:
                frames = decoder.feed(chunk)
            except wirefmt.WireError as e:
                # framing lost on a multiplexed connection: nothing
                # downstream is decodable — fail every pending future
                # (the router degrades/hedges per shard, as for EOF)
                self._fail_all(e)
                return
            for mtype, payload in frames:
                # response-side dispatch: only response frame types may
                # resolve pending futures. Without this allowlist a
                # request-type frame (MSG_SCORE_REQUEST) carrying a uid
                # would decode fine and complete a caller's future with
                # a request echo — protocol confusion, not an error.
                if mtype not in (
                    wirefmt.MSG_JSON,
                    wirefmt.MSG_SCORE_RESPONSE,
                    wirefmt.MSG_PARTIAL_RESPONSE,
                    wirefmt.MSG_TRACE_RESPONSE,
                ):
                    self.unmatched_responses += 1
                    continue
                try:
                    resp = wirefmt.decode_message(mtype, payload)
                except wirefmt.WireError:
                    self.unmatched_responses += 1
                    continue
                self._dispatch_response(resp)

    def _dispatch_response(self, resp: Mapping) -> None:
        uid = resp.get("uid")
        with self._lock:
            fut = self._pending.pop(uid, None) if uid else None
        if fut is None:
            # a response for an abandoned/unknown uid (e.g. a
            # hedged-away attempt, or a shard-side READ_FAULT whose
            # uid was lost): counted, dropped — the owning attempt
            # recovers through its own timeout
            self.unmatched_responses += 1
            return
        if not fut.done():
            fut.set_result(resp)

    def _fail_all(self, exc: BaseException) -> None:
        self._closed.set()
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for fut in pending:
            if not fut.done():
                fut.set_exception(
                    TransportError(f"connection failed: {exc}")
                )
        try:
            self._sock.close()
        except OSError:
            pass

    def close(self) -> None:
        self._fail_all(ConnectionError("transport closed"))
        self._reader.join(timeout=2 * POLL_S + 1.0)


class RouterMetrics:
    """Router-side accounting: request outcomes, fan-out, cache and
    health counters, fan-out latency percentiles. Host arithmetic only
    (the router has no device)."""

    def __init__(self, *, max_latency_samples: int = 1 << 18):
        self._lock = threading.Lock()
        self._max_samples = int(max_latency_samples)
        self._lat: List[float] = []
        self._stride = 1
        self._seen = 0
        self._requests = 0
        self._ok = 0
        self._degraded = 0
        self._failed = 0
        self._cache_full_hits = 0
        self._fanout_counts: Dict[int, int] = {}
        self._subrequests = 0
        self._sub_failures: Dict[int, int] = {}
        self._hedges = 0
        self._generation_retries = 0
        self._first_t: Optional[float] = None
        self._last_t: Optional[float] = None
        # live registry mirrors (SLO-engine inputs), bound once by
        # bind_registry before traffic; single-writer plain publishes
        self._reg_total = None  # photon: guarded-by(atomic)
        self._reg_bad = None  # photon: guarded-by(atomic)
        self._reg_latency = None  # photon: guarded-by(atomic)

    def bind_registry(self, registry, *, prefix: str = "router") -> None:
        """Mirror request outcomes into live registry instruments —
        ``<prefix>_requests_total`` / ``<prefix>_bad_total`` counters
        and the ``<prefix>_latency_seconds`` histogram — so SLO specs
        (obs/slo.py) evaluate over the routed plane. Bind BEFORE
        traffic: the mirrors are plain single-writer references read
        bare on the record path."""
        self._reg_total = registry.counter(
            f"{prefix}_requests_total", "routed requests completed"
        )
        self._reg_bad = registry.counter(
            f"{prefix}_bad_total",
            "routed requests that burned error budget "
            "(failed or degraded)",
        )
        self._reg_latency = registry.histogram(
            f"{prefix}_latency_seconds", "routed request latency"
        )

    def record(
        self,
        *,
        ok: bool,
        degraded: bool,
        fanout: int,
        cache_full_hit: bool,
        latency_s: float,
    ) -> None:
        now = time.perf_counter()
        # registry mirrors first, OUTSIDE our lock (each instrument has
        # its own; nesting ours around theirs would add a lock edge the
        # record path does not need)
        total = self._reg_total
        if total is not None:
            total.inc()
            if not ok:
                self._reg_bad.inc(reason="failed")
            elif degraded:
                self._reg_bad.inc(reason="degraded")
            self._reg_latency.observe(latency_s)
        with self._lock:
            self._requests += 1
            self._ok += int(ok and not degraded)
            self._degraded += int(ok and degraded)
            self._failed += int(not ok)
            self._cache_full_hits += int(cache_full_hit)
            self._fanout_counts[fanout] = (
                self._fanout_counts.get(fanout, 0) + 1
            )
            if self._first_t is None:
                self._first_t = now - latency_s
            self._last_t = now
            self._seen += 1
            if (self._seen - 1) % self._stride == 0:
                self._lat.append(latency_s)
                if len(self._lat) >= self._max_samples:
                    self._lat = self._lat[::2]
                    self._stride *= 2

    def record_subrequest(self, shard: int, *, ok: bool) -> None:
        with self._lock:
            self._subrequests += 1
            if not ok:
                self._sub_failures[shard] = (
                    self._sub_failures.get(shard, 0) + 1
                )

    def record_hedge(self) -> None:
        with self._lock:
            self._hedges += 1

    def record_generation_retry(self) -> None:
        with self._lock:
            self._generation_retries += 1

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            lat = np.asarray(self._lat, np.float64)
            elapsed = (
                (self._last_t - self._first_t)
                if self._first_t is not None and self._last_t is not None
                else 0.0
            )
            out: Dict[str, object] = {
                "requests": self._requests,
                "ok": self._ok,
                "degraded": self._degraded,
                "failed": self._failed,
                "qps": (
                    round(self._requests / elapsed, 3)
                    if elapsed > 0 else None
                ),
                "cache_full_hits": self._cache_full_hits,
                "fanout_counts": {
                    str(k): v
                    for k, v in sorted(self._fanout_counts.items())
                },
                "fanout_mean": (
                    round(
                        sum(k * v for k, v in self._fanout_counts.items())
                        / self._requests,
                        4,
                    )
                    if self._requests else None
                ),
                "subrequests": self._subrequests,
                "subrequest_failures": {
                    str(k): v
                    for k, v in sorted(self._sub_failures.items())
                },
                "hedges": self._hedges,
                "generation_retries": self._generation_retries,
            }
            if lat.size:
                out.update({
                    "latency_p50_ms": round(
                        float(np.percentile(lat, 50)) * 1e3, 6
                    ),
                    "latency_p99_ms": round(
                        float(np.percentile(lat, 99)) * 1e3, 6
                    ),
                    "latency_max_ms": round(float(lat.max()) * 1e3, 6),
                })
            return out


def _digest(*parts: object) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    for p in parts:
        h.update(
            p if isinstance(p, bytes)
            else json.dumps(p, sort_keys=False).encode("utf-8")
        )
        h.update(b"\x00")
    return h.digest()


class ShardRouter:
    """The scatter/gather tier over one shard-server fleet.

    ``transport_factory(shard_index)`` opens a connection to shard
    ``i`` (defaults to :class:`TcpShardTransport` over ``addresses``);
    tests inject in-process fakes, which also makes the whole
    fan-out/cache/swap plane schedulable under the interleaving
    harness. ``entity_ids`` maps each random-effect id type to the
    model's FULL sorted entity-id list — the router's only model state:
    an id's position is its code, its code's owner is the shared rule.

    ``score_record`` is thread-safe (open-loop drivers call it from
    many submitter threads); swaps serialize on their own lock.
    """

    def __init__(
        self,
        addresses: Sequence[Tuple[str, int]] = (),
        *,
        entity_ids: Mapping[str, Sequence[str]],
        shard_configs=None,
        transport_factory: Optional[Callable[[int], object]] = None,
        num_shards: Optional[int] = None,
        policy: Optional[RoutingPolicy] = None,
        cache_entries: int = 4096,
        metrics: Optional[RouterMetrics] = None,
        native_index_threshold: Optional[int] = None,
        recorder=None,
        wire: str = "json",
    ):
        self.wire = str(wire)
        if self.wire not in ("json", "binary", "auto"):
            raise ValueError(
                f"unknown wire mode {wire!r} (json | binary | auto)"
            )
        # the NEGOTIATED data-plane protocol: starts json, settled at
        # connect() from the fleet's topology advertisements.
        # single-writer atomic publish — connect() is the only writer
        # (one plain assignment, before it marks the router connected)
        self._data_wire = "json"  # photon: guarded-by(atomic)
        if transport_factory is None:
            if not addresses:
                raise ValueError(
                    "ShardRouter needs addresses or a transport_factory"
                )
            addrs = [(h, int(p)) for h, p in addresses]

            def transport_factory(i, _addrs=addrs):
                # data plane: reads the negotiated protocol at BUILD
                # time, so transports (re)opened after connect() speak
                # whatever the fleet agreed on
                return TcpShardTransport(*_addrs[i], wire=self._data_wire)

            def control_factory(i, _addrs=addrs):
                # control plane: always fresh JSON connections — swap
                # staging and topology discovery predate (and outlive)
                # any data-plane negotiation
                return TcpShardTransport(*_addrs[i])

            self.num_shards = len(addrs)
        else:
            control_factory = transport_factory
            self.num_shards = (
                int(num_shards)
                if num_shards is not None
                else (len(addresses) if addresses else None)
            )
        self._transport_factory = transport_factory
        self._control_factory = control_factory
        self.policy = policy or RoutingPolicy()
        self.metrics = metrics or RouterMetrics()
        # the router's conservation ledger (obs/flight_recorder.py):
        # every admitted request reaches exactly one ATTRIBUTED
        # terminal — shard:<i> (wire-served, keyed by the FE provider),
        # cache (zero fan-out), degraded (FE-only), no_shard/error —
        # which is what fleet_check_conservation balances against the
        # shards' own books. Defaults to the process recorder;
        # in-process fleets pass the router its own.
        self._flight = (
            recorder if recorder is not None else flight_recorder()
        )
        self.cache = HotEntityCache(cache_entries)
        self._indexes: Dict[str, EntityRowIndex] = {}
        for id_type, ids in entity_ids.items():
            ids = list(ids)
            if ids != sorted(ids):
                raise ValueError(
                    f"entity ids for {id_type!r} must be the model's "
                    "SORTED id list (position == entity code)"
                )
            self._indexes[id_type] = EntityRowIndex(
                ids, native_threshold=native_index_threshold
            )
        # per-shard feature-bag map for cache digests (None disables
        # per-entry digests in favor of whole-record ones)
        self._shard_bags: Optional[Dict[str, List[str]]] = (
            {
                cfg.shard_id: list(cfg.feature_bags)
                for cfg in shard_configs
            }
            if shard_configs is not None
            else None
        )
        # connection state, lazily (re)built per shard under _conn_lock
        self._conn_lock = threading.Lock()
        self._transports: Dict[int, object] = {}
        self._uid_lock = threading.Lock()
        self._uid_seq = 0
        # routing-generation state + the swap protocol serializer
        self._gen_lock = threading.Lock()
        self._generation = 0
        self._swap_serial = threading.Lock()
        self.health: List[ShardHealth] = []
        self._entries: Tuple = ()
        self._id_types: Tuple[str, ...] = ()
        self._connected = False

    # -- wiring --------------------------------------------------------------

    def connect(self) -> Dict[str, object]:
        """Fetch + cross-check every shard's topology: indexes must
        match positions, counts must agree (and equal the fleet size),
        spec entries and generations must be identical — a fleet that
        disagrees on any of these would route coefficients to the
        wrong host, so it is refused outright."""
        topos = []
        n = self.num_shards
        if n is None:
            raise ValueError("fleet size unknown: pass addresses")
        for i in range(n):
            # topology is fetched over the control plane (fresh JSON
            # connections): the data plane's protocol is not yet known
            # — it is negotiated from these very advertisements
            t = self._control_factory(i)
            try:
                resp = t.request(
                    {"op": "topology", "uid": self._next_uid()},
                    CONTROL_TIMEOUT_S,
                )
            finally:
                if hasattr(t, "close"):
                    t.close()
            if resp.get("status") != "ok":
                raise ValueError(f"shard {i} topology refused: {resp}")
            topos.append(resp)
        for i, topo in enumerate(topos):
            if int(topo["shard_index"]) != i:
                raise ValueError(
                    f"shard at position {i} reports index "
                    f"{topo['shard_index']} — the fleet ordering and the "
                    "ownership rule disagree"
                )
            if int(topo["shard_count"]) != n:
                raise ValueError(
                    f"shard {i} reports {topo['shard_count']} shards, "
                    f"router has {n}"
                )
            if topo.get("rule") != ownership.OWNERSHIP_RULE:
                raise ValueError(
                    f"shard {i} uses ownership rule {topo.get('rule')!r}, "
                    f"router uses {ownership.OWNERSHIP_RULE!r}"
                )
        first = topos[0]
        for i, topo in enumerate(topos[1:], start=1):
            if topo["entries"] != first["entries"]:
                raise ValueError(
                    f"shard {i} spec entries differ from shard 0: "
                    f"{topo['entries']} vs {first['entries']}"
                )
            if int(topo["generation"]) != int(first["generation"]):
                raise ValueError(
                    f"fleet generations disagree: shard {i} at "
                    f"{topo['generation']}, shard 0 at "
                    f"{first['generation']}"
                )
        self._entries = tuple(
            (e[0], e[1], tuple(e[2]), e[3]) for e in first["entries"]
        )
        self._id_types = tuple(
            sorted({t for e in self._entries for t in e[2]})
        )
        missing = [t for t in self._id_types if t not in self._indexes]
        if missing:
            raise ValueError(
                f"router has no entity-id index for id type(s) {missing}"
            )
        # -- wire negotiation: the data plane goes binary only when the
        # WHOLE fleet advertises it. A router pinned to binary facing a
        # JSON-only shard is refused outright — a wire-protocol
        # mismatch is a fleet-layout mismatch, the same class of error
        # as a misordered shard.
        json_only = [
            i for i, topo in enumerate(topos)
            if "binary" not in (
                (topo.get("wire") or {}).get("protocols") or ("json",)
            )
        ]
        if self.wire == "binary" and json_only:
            raise ValueError(
                "wire-protocol mismatch: router requires the binary "
                f"data plane but shard(s) {json_only} advertise JSON "
                "only"
            )
        negotiated = (
            "binary"
            if self.wire in ("binary", "auto") and not json_only
            else "json"
        )
        if negotiated != self._data_wire:
            self._data_wire = negotiated
            # drop any pre-negotiation data transports; the next
            # sub-request rebuilds them on the negotiated protocol
            with self._conn_lock:
                stale = list(self._transports.values())
                self._transports.clear()
            for t in stale:
                if hasattr(t, "close"):
                    t.close()
        self.health = [
            ShardHealth(i, self.policy, recorder=self._flight)
            for i in range(n)
        ]
        with self._gen_lock:
            self._generation = int(first["generation"])
        self._connected = True
        return {
            "shards": n,
            "generation": int(first["generation"]),
            "entries": [list(e) for e in self._entries],
            "wire": negotiated,
        }

    @property
    def generation(self) -> int:
        with self._gen_lock:
            return self._generation

    def _next_uid(self) -> str:
        with self._uid_lock:
            self._uid_seq += 1
            return f"sub-{self._uid_seq}"

    def _publish_transport(self, shard: int, fresh):  # photon: guarded-by(_conn_lock)
        """Install ``fresh`` unless a racing builder already published
        a live transport (the decision re-checks under the lock —
        never trusts the caller's pre-build peek). Returns
        (transport_to_drop, transport_to_use)."""
        cur = self._transports.get(shard)
        if cur is not None and not getattr(cur, "closed", False):
            return fresh, cur
        self._transports[shard] = fresh
        return None, fresh

    def _transport(self, shard: int):
        with self._conn_lock:
            t = self._transports.get(shard)
            if t is not None and not getattr(t, "closed", False):
                return t
        # build OUTSIDE the lock (a TCP connect can block for seconds;
        # holding _conn_lock would stall every other shard's senders),
        # then publish — a racing builder's duplicate is closed
        fresh = self._transport_factory(shard)
        with self._conn_lock:
            drop, keep = self._publish_transport(shard, fresh)
        if drop is not None and hasattr(drop, "close"):
            drop.close()
        return keep

    def _drop_transport(self, shard: int, t) -> None:
        with self._conn_lock:
            if self._transports.get(shard) is t:
                self._transports.pop(shard, None)
        if hasattr(t, "close"):
            t.close()

    def close(self) -> None:
        with self._conn_lock:
            transports = list(self._transports.values())
            self._transports.clear()
        for t in transports:
            if hasattr(t, "close"):
                t.close()

    # -- the scatter/gather request path ------------------------------------

    def _codes_of(self, record: Mapping) -> Dict[str, Tuple[Optional[str], int]]:
        """id type -> (raw id or None, code or -1): the same id
        resolution the single-server request assembly performs, plus
        the router's code lookup (position in the model's sorted id
        universe; -1 = unknown -> the zero term, never a sub-request)."""
        out: Dict[str, Tuple[Optional[str], int]] = {}
        meta = record.get("metadataMap") or {}
        for t in self._id_types:
            v = record.get(t)
            if v is None:
                v = meta.get(t)
            if v is None:
                out[t] = (None, -1)
            else:
                v = str(v)
                out[t] = (v, self._indexes[t].row_of(v))
        return out

    def _entry_cache_key(
        self, generation: int, entry, codes, record: Mapping
    ) -> Optional[tuple]:
        """Cache key for one term slot, or None when the slot is not
        cacheable (no feature-bag map, or an mf pair with a missing
        id). The digest covers the entity id(s) AND the exact feature
        payload the term depends on, so equal keys imply bitwise-equal
        terms."""
        kind, name, id_types, feature_shard = entry
        ids = [codes[t][0] for t in id_types]
        if any(i is None for i in ids):
            return None
        if kind == "re":
            if self._shard_bags is None:
                return None
            bags = self._shard_bags.get(feature_shard)
            if bags is None:
                return None
            payload = [record.get(b) or [] for b in bags]
            return (
                generation, name, _digest(ids, payload)
            )
        # mf: the term is a latent dot product — it depends only on the
        # two entity ids
        return (generation, name, _digest(ids))

    def _fe_cache_key(
        self, generation: int, record: Mapping
    ) -> Optional[tuple]:
        if self._shard_bags is None:
            return None
        payload = [
            [record.get(b) or [] for b in bags]
            for _sid, bags in sorted(self._shard_bags.items())
        ]
        return (generation, FE_SLOT, _digest(payload))

    def _scatter(
        self,
        record: Mapping,
        shards: Sequence[int],
        budget_s: float,
        trace=None,
    ) -> Dict[int, Optional[Mapping]]:
        """Fan one partial-score sub-request out to ``shards`` and
        gather, bounded by ``budget_s`` overall. ALL first attempts go
        out before any wait (the fleet computes concurrently; the
        gather's wall time is the slowest shard, not the sum), then the
        hedged-or-shed policy runs per shard: no answer by the hedge
        point -> one fresh-connection hedge inside the remaining
        budget -> shed (None, degraded downstream). Every outcome is
        noted in its shard's health window."""
        t0 = time.monotonic()
        hedge_at = t0 + (
            budget_s * self.policy.hedge_frac
            if self.policy.hedge
            else budget_s
        )
        deadline = t0 + budget_s
        # phase 1: fire every first attempt
        pending: Dict[int, tuple] = {}  # shard -> (transport, obj, fut, span)
        out: Dict[int, Optional[Mapping]] = {}
        for s in shards:
            if not self.health[s].allow():
                out[s] = None
                continue
            obj = dict(record)
            obj["uid"] = self._next_uid()
            obj["deadline_ms"] = budget_s * 1e3
            # sub-request span, nested under the router span; the wire
            # object carries its context so the shard frontend's span
            # nests under THIS one (dict(record) already relayed any
            # caller context; an active trace overrides it)
            sub = start_span(
                "router.subrequest",
                trace_id=getattr(trace, "trace_id", None),
                parent_id=getattr(trace, "span_id", None),
                shard=s,
            )
            if sub.trace_id is not None:
                obj[TRACE_KEY] = sub.trace_id
                obj[PARENT_KEY] = sub.span_id
            try:
                t = self._transport(s)
                pending[s] = (t, obj, t.send_request(obj), sub)
            except (TransportError, OSError):
                pending[s] = (None, obj, None, sub)
        # phase 2: gather; concurrent attempts overlap, so the per-shard
        # waits share the same absolute deadlines
        for s, (t, obj, fut, sub) in pending.items():
            resp = None
            if fut is not None:
                try:
                    resp = fut.result(
                        timeout=max(hedge_at - time.monotonic(), 0.001)
                    )
                except (TimeoutError, _FutureTimeout):
                    if hasattr(t, "abandon"):
                        t.abandon(obj["uid"])
                except (TransportError, OSError):
                    pass  # connection-level failure: hedge below
            if t is not None and getattr(t, "closed", False):
                self._drop_transport(s, t)
            if resp is None and self.policy.hedge:
                remaining = deadline - time.monotonic()
                if remaining > 0:
                    self.metrics.record_hedge()
                    resp = self._hedge_once(s, obj, remaining)
            ok = (
                resp is not None
                and resp.get("status") == "ok"
                and "fe" in resp
            )
            sub.end(ok=ok)
            out[s] = resp if ok else None
            self.health[s].note(ok)
            self.metrics.record_subrequest(s, ok=ok)
        return out

    def _hedge_once(
        self, shard: int, obj: Mapping, budget_s: float
    ) -> Optional[Mapping]:
        """One hedge on a FRESH connection (the persistent one may be
        the problem); a fresh uid so the abandoned first attempt's late
        response can never be mistaken for this one's."""
        try:
            hedge = self._transport_factory(shard)
        except (TransportError, OSError):
            return None
        try:
            retry = dict(obj)
            retry["uid"] = self._next_uid()
            return hedge.request(retry, budget_s)
        except (TransportError, OSError):
            return None
        finally:
            if hasattr(hedge, "close"):
                hedge.close()

    def score_record(
        self,
        record: Mapping,
        *,
        deadline_ms: Optional[float] = None,
    ) -> RoutedScore:
        """Route one GameExample-shaped record through the fleet into
        one final margin. See the module docstring for the algebra; the
        short version: scatter to owners (+ one FE provider), gather
        terms, re-sum in spec order in float32, cache the hot slots."""
        if not self._connected:
            raise RuntimeError("router not connected (call connect())")
        t_start = time.perf_counter()
        if deadline_ms is None:
            deadline_ms = record.get("deadline_ms")
        budget_s = (
            float(deadline_ms) / 1e3
            if deadline_ms is not None
            else self.policy.subrequest_timeout_s
        )
        codes = self._codes_of(record)
        # conservation ledger: admitted HERE, exactly one attributed
        # terminal below — the router side of the fleet-wide invariant
        self._flight.note_admitted()
        # the root of the routed request's trace: one trace id per
        # request, minted here (or joined from the caller's wire
        # context); every sub-request and every shard-side span nests
        # under it — "one connected trace per routed request"
        wire_t, wire_p = wire_context(record)
        sp = start_span(
            "router.request", trace_id=wire_t, parent_id=wire_p,
            uid=str(record.get("uid") or ""),
        )
        try:
            outcome = self._score_once(
                record, codes, budget_s, use_cache=True, trace=sp
            )
            if outcome is None:
                # generation moved mid-gather (a commit wave passed):
                # one clean re-scatter against the settled fleet, cache
                # cold
                self.metrics.record_generation_retry()
                outcome = self._score_once(
                    record, codes, budget_s, use_cache=False, trace=sp
                )
            if outcome is None:
                # still unsettled after one retry: fleet is mid-flip
                # AND disagreeing; refuse rather than emit a mixed
                # margin
                raise NoShardAvailable(
                    "shard generations disagreed across two gather "
                    "attempts"
                )
        except NoShardAvailable:
            sp.end(status="refused")
            self._flight.note_terminal("no_shard", attribution="no_shard")
            self.metrics.record(
                ok=False,
                degraded=False,
                fanout=0,
                cache_full_hit=False,
                latency_s=time.perf_counter() - t_start,
            )
            raise
        except Exception:
            # anything else still reaches a named terminal — an
            # admitted request with no terminal is exactly the hole
            # fleet conservation exists to expose
            sp.end(status="error")
            self._flight.note_terminal("error", attribution="error")
            raise
        sp.end(
            status="ok",
            fanout=outcome.fanout,
            degraded=outcome.degraded,
            cache_hit=outcome.cache_hit,
            generation=outcome.generation,
        )
        # attribution: degraded outcomes are router-local (FE-only for
        # at least one slot — no single shard "served" the request);
        # zero-fan-out requests were served by the hot cache; the rest
        # key off the shard that provided the FE half. "mixed" (FE from
        # cache, terms from the wire) stays a router-local bucket so
        # the shard join's >= direction is never overstated.
        if outcome.degraded:
            attribution = "degraded"
        elif outcome.fanout == 0:
            attribution = "cache"
        elif outcome.fe_shard is not None:
            attribution = f"shard:{outcome.fe_shard}"
        else:
            attribution = "mixed"
        self._flight.note_terminal(
            "ok", generation=outcome.generation, attribution=attribution
        )
        self.metrics.record(
            ok=True,
            degraded=outcome.degraded,
            fanout=outcome.fanout,
            cache_full_hit=outcome.cache_hit,
            latency_s=time.perf_counter() - t_start,
        )
        return outcome

    def _score_once(
        self, record, codes, budget_s: float, *, use_cache: bool,
        trace=None,
    ) -> Optional[RoutedScore]:
        generation = self.generation
        cache_on = use_cache and self.cache.enabled
        # -- plan: which slots come from cache, which shard owns the
        # rest ------------------------------------------------------------
        fe_key = self._fe_cache_key(generation, record) if cache_on else None
        fe_value = self.cache.get(fe_key) if fe_key is not None else None
        slot_values: Dict[str, float] = {}
        slot_keys: Dict[str, tuple] = {}
        need: Dict[int, List[object]] = {}  # shard -> [entry, ...]
        fe_entries = []  # entries any shard can answer (mf)
        for entry in self._entries:
            kind, name, id_types, _shard = entry
            entry_codes = [codes[t][1] for t in id_types]
            if any(c < 0 for c in entry_codes):
                # unknown/absent entity: the exact 0.0 the single-server
                # program adds — no sub-request, no cache entry
                slot_values[name] = 0.0
                continue
            key = (
                self._entry_cache_key(generation, entry, codes, record)
                if cache_on else None
            )
            if key is not None:
                hit = self.cache.get(key)
                if hit is not None:
                    slot_values[name] = hit
                    continue
                slot_keys[name] = key
            if kind == "re":
                owner = ownership.owner_of(entry_codes[0], self.num_shards)
                need.setdefault(owner, []).append(entry)
            else:
                fe_entries.append(entry)
        need_fe = fe_value is None or fe_entries
        fanout_shards = sorted(need)
        if need_fe and not fanout_shards:
            # nothing entity-owned to fetch, but the FE half (and any
            # mf terms) still needs A shard: pick a healthy one,
            # spreading deadline-less idle traffic by uid hash
            fe_shard = self._pick_fe_shard(record)
            if fe_shard is None:
                raise NoShardAvailable(
                    "no healthy shard-server can provide the "
                    "fixed-effect score"
                )
            fanout_shards = [fe_shard]
        # -- scatter/gather -----------------------------------------------
        responses = (
            self._scatter(record, fanout_shards, budget_s, trace=trace)
            if fanout_shards else {}
        )
        live = {
            s: r for s, r in responses.items() if r is not None
        }
        if need_fe and not live and fanout_shards:
            # every owner (or the chosen FE provider) failed; the FE
            # half is non-negotiable — walk the remaining healthy fleet
            for s in self._fallback_order(record):
                if s in responses:
                    continue
                extra = self._scatter(record, [s], budget_s, trace=trace)
                if extra[s] is not None:
                    responses.update(extra)
                    live = {s: extra[s]}
                    break
            else:
                raise NoShardAvailable(
                    "no healthy shard-server answered for the "
                    "fixed-effect score"
                )
        # -- generation consistency ---------------------------------------
        gens = {int(r["generation"]) for r in live.values()}
        if len(gens) > 1:
            return None  # mixed gather: caller re-scatters once
        gen = gens.pop() if gens else generation
        if cache_on and gen != generation:
            # the fleet flipped under us; every cached slot we planned
            # with belongs to the old generation — redo cold
            return None
        # -- assemble -------------------------------------------------------
        degraded_shards = []
        degraded = False
        fe_from_wire = None
        fe_shard: Optional[int] = None
        for s, r in responses.items():
            if r is None:
                degraded_shards.append(s)
                continue
            if bool(r.get("degraded")):
                degraded = True
            if fe_from_wire is None:
                fe_from_wire = np.float32(r["fe"])
                fe_shard = s
            terms = r.get("terms") or {}
            for entry in need.get(s, ()):
                name = entry[1]
                if name in terms:
                    slot_values[name] = float(np.float32(terms[name]))
                else:
                    slot_values[name] = 0.0
                    degraded = True
            if s in live and fe_entries:
                for entry in fe_entries:
                    name = entry[1]
                    if name in terms:
                        slot_values.setdefault(
                            name, float(np.float32(terms[name]))
                        )
        for s in degraded_shards:
            # a dead shard's entities degrade to the FE-only zero — for
            # ITS entities only; everything else in this request is
            # exact
            degraded = True
            for entry in need.get(s, ()):
                slot_values[entry[1]] = 0.0
        for entry in fe_entries:
            if entry[1] not in slot_values:
                slot_values[entry[1]] = 0.0
                degraded = True
        if fe_value is None:
            if fe_from_wire is None:
                raise NoShardAvailable(
                    "no healthy shard-server answered for the "
                    "fixed-effect score"
                )
            fe = fe_from_wire
        else:
            fe = np.float32(fe_value)
            fe_shard = None  # the cache provided the FE half
        # -- recompose: the full program's accumulation order, f32 ---------
        total = np.float32(fe)
        for entry in self._entries:
            total = np.float32(
                total + np.float32(slot_values[entry[1]])
            )
        off = record.get("offset")
        total = np.float32(
            total + np.float32(0.0 if off is None else float(off))
        )
        # -- populate the cache (deterministic, current-gen, non-degraded
        # slots only) ------------------------------------------------------
        if cache_on and gen == generation and not degraded:
            if fe_key is not None and fe_value is None:
                self.cache.put(fe_key, float(fe))
            for name, key in slot_keys.items():
                if name in slot_values:
                    self.cache.put(key, slot_values[name])
        return RoutedScore(
            float(total),
            degraded=degraded,
            generation=gen,
            fanout=len(fanout_shards),
            cache_hit=not fanout_shards,
            degraded_shards=tuple(sorted(degraded_shards)),
            fe_shard=fe_shard,
        )

    def _pick_fe_shard(self, record: Mapping) -> Optional[int]:
        for s in self._fallback_order(record):
            return s
        return None

    def _fallback_order(self, record: Mapping):
        """Healthy shards, starting at a uid-hash offset so FE-only
        traffic spreads over the fleet instead of hammering shard 0."""
        uid = str(record.get("uid") or "")
        start = (
            int.from_bytes(_digest(uid)[:4], "big") % self.num_shards
        )
        for k in range(self.num_shards):
            s = (start + k) % self.num_shards
            if self.health[s].allow():
                yield s

    # -- the router-coordinated two-step flip --------------------------------

    def coordinate_swap(self, model_dir) -> Dict[str, object]:
        """Flip the WHOLE fleet to a new model generation, two-step:

        1. ``stage_swap`` on every shard (each loads + warms its own
           1/N slice under live traffic). ANY failure aborts the
           already-staged shards — nobody flips, the old generation
           keeps serving everywhere.
        2. ``commit_swap`` on every shard (each a sub-ms flip), then —
           under one lock — bump the routing generation and purge every
           other generation's cache entries. In-flight gathers that
           straddle the wave re-scatter once via the mixed-generation
           check.

        ``model_dir`` is one artifact path for the whole fleet (every
        shard loads its own entity slice of it) or a per-shard list.
        """
        dirs = (
            list(model_dir)
            if isinstance(model_dir, (list, tuple))
            else [model_dir] * self.num_shards
        )
        if len(dirs) != self.num_shards:
            raise ValueError(
                f"{len(dirs)} model dirs for {self.num_shards} shards"
            )
        with self._swap_serial:
            staged: List[int] = []
            for s in range(self.num_shards):
                resp = self._control(
                    s, {"op": "stage_swap", "model_dir": dirs[s]}
                )
                if resp is None or not resp.get("ok"):
                    for p in staged:
                        self._control(p, {"op": "abort_swap"})
                    self._flight.record(
                        "swap.fleet_abort", phase="stage", failed_shard=s,
                    )
                    return {
                        "ok": False,
                        "phase": "stage",
                        "failed_shard": s,
                        "error": (
                            resp.get("error", "stage refused")
                            if resp is not None
                            else "shard unreachable"
                        ),
                        "generation": self.generation,
                    }
                staged.append(s)
            committed: List[int] = []
            new_gens = set()
            for s in range(self.num_shards):
                resp = self._control(s, {"op": "commit_swap"})
                if resp is None or not resp.get("ok"):
                    # a commit failure mid-wave leaves a mixed fleet —
                    # surfaced loudly; the gather-side consistency check
                    # keeps responses correct (never mixed) meanwhile
                    return {
                        "ok": False,
                        "phase": "commit",
                        "failed_shard": s,
                        "committed": committed,
                        "error": (
                            resp.get("error", "commit refused")
                            if resp is not None
                            else "shard unreachable"
                        ),
                        "generation": self.generation,
                    }
                committed.append(s)
                new_gens.add(int(resp["generation"]))
            if len(new_gens) != 1:
                return {
                    "ok": False,
                    "phase": "commit",
                    "error": f"fleet generations diverged: {new_gens}",
                    "generation": self.generation,
                }
            new_gen = new_gens.pop()
            with self._gen_lock:
                self._generation = new_gen
                purged = self.cache.purge_other_generations(new_gen)
            self._flight.record(
                "swap.fleet_commit", generation=new_gen,
                shards=self.num_shards, cache_purged=purged,
            )
            return {
                "ok": True,
                "generation": new_gen,
                "cache_purged": purged,
            }

    def _control(self, shard: int, obj: Dict) -> Optional[Mapping]:
        """One control op on a FRESH connection: staging a generation
        can take seconds, and running it on the multiplexed data
        connection would stall every in-flight score sub-request behind
        the shard frontend's per-connection reader. Control stays JSON
        regardless of the negotiated data plane — status/swap tooling
        must work against ANY fleet member, negotiated or not."""
        obj = dict(obj)
        obj["uid"] = self._next_uid()
        try:
            t = self._control_factory(shard)
        except (TransportError, OSError):
            return None
        try:
            resp = t.request(obj, CONTROL_TIMEOUT_S)
        except (TransportError, OSError):
            return None
        finally:
            if hasattr(t, "close"):
                t.close()
        if resp.get("status") not in ("ok", "error"):
            return None
        return resp

    # -- observability -------------------------------------------------------

    def status(self) -> Dict[str, object]:
        return {
            "shards": self.num_shards,
            "generation": self.generation,
            "rule": ownership.OWNERSHIP_RULE,
            "wire": {
                "requested": self.wire,
                "negotiated": self._data_wire,
            },
            "health": [h.snapshot() for h in self.health],
            "cache": self.cache.snapshot(),
            "router": self.metrics.snapshot(),
        }
