"""Registry watcher: promote newly published generations into a live
scorer, and ROLL BACK automatically when the swap makes serving worse
(port of ``photon_ml_tpu/registry/watcher.py``; it drives the port's
``ServingModel.stage_and_swap``).

The serving half of continuous retraining: the trainer publishes into
the registry (validation-gated), and this watcher — a thread inside the
serving driver — polls the loader view, hot-swaps a newly committed
generation through the existing staged/donated swap machinery, then
watches the post-swap health window. Health is judged on what the
service itself already measures: the fraction of recent completions
that came back degraded (FE-only after RE quarantine / row-resolution
failures), shed, or errored. If the post-swap window regresses past the
policy bound, the watcher flips BACK to the parent generation —
reloaded from the registry artifact, so the restored scores are
bitwise the parent's — and quarantines the bad generation in the
registry so no watcher (this one or a peer's) promotes it again.

The watcher never blocks the request path: swaps happen on the watcher
thread through ``ServingModel.stage_and_swap`` (all slow work off the
dispatch lock), and health observations are lock-light counters fed
from the completion callback.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from photon_ml_tpu_torch.obs.flight_recorder import flight_recorder
from photon_ml_tpu_torch.registry.registry import GenerationInfo, ModelRegistry

__all__ = ["RollbackPolicy", "HealthWindow", "RegistryWatcher"]


@dataclass(frozen=True)
class RollbackPolicy:
    """When does a swap count as a regression?

    Judged over a sliding window of the most recent ``window``
    completions, only once ``min_requests`` post-swap completions
    exist (a 1-request window would roll back on any single shed).
    ``max_unhealthy_rate`` is an absolute bound on
    (degraded + shed + errors) / window — the degraded path is the
    signature of a generation whose RE bank cannot resolve live
    traffic (the exact failure entity churn + a bad publish produces).
    """

    window: int = 64
    min_requests: int = 16
    max_unhealthy_rate: float = 0.5

    def as_dict(self) -> Dict[str, object]:
        return {
            "window": self.window,
            "min_requests": self.min_requests,
            "max_unhealthy_rate": self.max_unhealthy_rate,
        }


class HealthWindow:
    """Ring buffer of request outcomes: 0 healthy, 1 unhealthy."""

    def __init__(self, size: int):
        self._size = max(int(size), 1)
        self._buf: List[int] = []
        self._pos = 0
        self._lock = threading.Lock()

    def observe(self, unhealthy: bool) -> None:
        with self._lock:
            v = 1 if unhealthy else 0
            if len(self._buf) < self._size:
                self._buf.append(v)
            else:
                self._buf[self._pos] = v
                self._pos = (self._pos + 1) % self._size

    def snapshot(self):
        with self._lock:
            n = len(self._buf)
            return n, (sum(self._buf) / n if n else 0.0)

    def reset(self) -> None:
        with self._lock:
            self._buf = []
            self._pos = 0


@dataclass
class _SwapRecord:
    registry_generation: int
    parent: Optional[int]
    action: str  # "swap" | "rollback"
    ok: bool
    error: str = ""


class RegistryWatcher:
    """Polls ``registry`` and drives ``serving_model`` swaps.

    ``serving_model`` needs ``stage_and_swap(model_dir, **kw)`` (the
    ServingModel protocol); swap kwargs (entity padding, model id) ride
    through ``swap_kwargs``. Health observations arrive via
    :meth:`observe_outcome` from the driver's completion hook.
    """

    def __init__(
        self,
        registry: ModelRegistry,
        serving_model,
        *,
        poll_s: float = 2.0,
        policy: Optional[RollbackPolicy] = None,
        auto_rollback: bool = True,
        swap_kwargs: Optional[Dict[str, object]] = None,
        logger=None,
        initial_generation: Optional[GenerationInfo] = None,
        burn_gate: Optional[Callable[[], bool]] = None,
    ):
        self.registry = registry
        self.serving_model = serving_model
        self.poll_s = max(float(poll_s), 0.05)
        self.policy = policy or RollbackPolicy()
        self.auto_rollback = auto_rollback
        # SLO integration (obs/slo.py): when set, the post-swap health
        # judgment consumes BURN-RATE state (typically
        # SLOEngine.any_alert_active — both windows past threshold)
        # instead of the window's raw error fraction. The window still
        # gates on min_requests so a swap is never judged on no data.
        self.burn_gate = burn_gate
        self.swap_kwargs = dict(swap_kwargs or {})
        self.logger = logger
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # guards the lineage/health FLAGS shared between the watcher
        # thread, the response-path health feed (observe_outcome runs
        # on frontend connection threads) and the operator rollback op
        self._lock = threading.Lock()
        # serializes whole promote/rollback protocols (read lineage ->
        # stage -> flip -> write lineage): the operator rollback op
        # arrives on a connection thread while the watcher thread may
        # be mid-promote — without this, both read the same parent and
        # the loser publishes stale lineage (and two staged swaps race
        # at the serving model)
        self._swap_serial = threading.Lock()
        self._window = HealthWindow(self.policy.window)
        # lineage state: which registry generation is live, its parent
        self._live: Optional[GenerationInfo] = initial_generation
        self._last_swap: Optional[_SwapRecord] = None
        self._watching_swap = False
        self._rollback_wanted = False
        self.history: List[_SwapRecord] = []

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "RegistryWatcher":
        self._thread = threading.Thread(
            target=self._loop, name="photon-registry-watcher", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)

    def poke(self) -> None:
        """Force an immediate poll (tests / operator ops)."""
        self._wake.set()

    # -- health feed ---------------------------------------------------------

    def observe_outcome(
        self, *, degraded: bool = False, failed: bool = False
    ) -> None:
        """One completed request's health, fed from the driver's
        completion path. Only consulted while a post-swap watch is
        active — steady-state traffic costs one locked flag read."""
        with self._lock:
            if not self._watching_swap:
                return
        self._window.observe(degraded or failed)
        n, rate = self._window.snapshot()
        if self.burn_gate is not None:
            # burn-rate mode: the SLO engine's multi-window verdict
            # replaces the raw window fraction — min_requests still
            # applies, so the first post-swap completion cannot roll
            # back on a stale pre-swap burn
            try:
                unhealthy = bool(self.burn_gate())
            except Exception:
                unhealthy = False  # a wedged gate must not roll back
        else:
            unhealthy = rate > self.policy.max_unhealthy_rate
        if n >= self.policy.min_requests and unhealthy:
            # flag for the watcher thread; the completion callback must
            # never run a swap itself (it holds response-path time).
            # Re-check the watch under the lock: a rollback that just
            # completed cleared it, and re-arming the flag here would
            # roll back AGAIN off the bad generation's stale window.
            with self._lock:
                if self._watching_swap:
                    self._rollback_wanted = True
            self._wake.set()

    # -- status --------------------------------------------------------------

    def lineage(self) -> Dict[str, object]:
        """The frontend-status payload: live registry generation, its
        parent chain, and the last swap/rollback outcome."""
        with self._lock:
            live = self._live
            last = self._last_swap
        out: Dict[str, object] = {
            "registry_path": self.registry.root,
            "registry_generation": (
                live.generation if live is not None else None
            ),
            "parent": live.parent if live is not None else None,
            "lineage": (
                self.registry.lineage(live.generation)
                if live is not None else []
            ),
        }
        if last is not None:
            out["last_swap"] = {
                "action": last.action,
                "registry_generation": last.registry_generation,
                "ok": last.ok,
                "error": last.error,
            }
        n, rate = self._window.snapshot()
        with self._lock:
            watching = self._watching_swap
        out["post_swap_window"] = {
            "observed": n,
            "unhealthy_rate": round(rate, 4),
            "watching": watching,
        }
        return out

    # -- the loop ------------------------------------------------------------

    def _log(self, msg: str, *args) -> None:
        if self.logger is not None:
            self.logger.info(msg, *args)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=self.poll_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                with self._lock:
                    wanted = self._rollback_wanted
                    self._rollback_wanted = False
                if wanted:
                    self.rollback(reason="post-swap health regression")
                    continue
                self._check_registry()
            except Exception as e:  # the watcher must outlive one bad poll
                self._log("registry watcher poll failed: %s", e)

    def _check_registry(self) -> None:
        latest = self.registry.latest()
        if latest is None:
            return
        with self._lock:
            live_gen = (
                self._live.generation if self._live is not None else None
            )
        if live_gen is not None and latest.generation <= live_gen:
            return
        self._promote(latest)

    def _promote(self, info: GenerationInfo) -> None:
        self._log(
            "registry: promoting generation %d (parent %s)",
            info.generation, info.parent,
        )
        # _swap_serial held across the WHOLE protocol (stage -> flip ->
        # lineage write): the operator rollback op runs on a connection
        # thread and must not interleave with a promote — and holding
        # one outer lock across both _lock sections is what makes the
        # read-then-write below atomic (PL010)
        with self._swap_serial:
            res = self.serving_model.stage_and_swap(
                info.model_dir, **self.swap_kwargs
            )
            rec = _SwapRecord(
                registry_generation=info.generation,
                parent=info.parent,
                action="swap",
                ok=res.ok,
                error=res.error,
            )
            if res.ok and self.auto_rollback:
                self._window.reset()
            with self._lock:
                self.history.append(rec)
                self._last_swap = rec
                if res.ok:
                    self._live = info
                    if self.auto_rollback:
                        # arm AFTER the reset: a straggler completion
                        # between reset and arming is ignored, never
                        # counted against the new generation
                        self._watching_swap = True
                        self._rollback_wanted = False
        self._log(
            "registry swap -> generation %d: ok=%s%s",
            info.generation, res.ok,
            f" error={res.error}" if res.error else "",
        )
        flight_recorder().record(
            "watcher.promote", registry_generation=info.generation,
            parent=info.parent, ok=res.ok, error=res.error,
        )

    def rollback(self, *, reason: str = "operator request") -> bool:
        """Flip back to the live generation's parent (reloaded from the
        registry artifact — bitwise the parent's scores) and quarantine
        the bad generation in the registry. Operator op and the
        auto-rollback trigger both land here — serialized against
        promotes AND against each other, with the health watch disarmed
        (and any pending trigger cleared) BEFORE the flip so a stale
        window from the bad generation can never roll back twice."""
        with self._swap_serial:
            with self._lock:
                live = self._live
                self._watching_swap = False
                self._rollback_wanted = False
            if live is None or live.parent is None:
                self._log("rollback requested but no parent generation")
                return False
            parent = self.registry.generation(live.parent)
            if parent is None:
                self._log(
                    "rollback target generation %d is not loadable",
                    live.parent,
                )
                return False
            self._log(
                "ROLLING BACK generation %d -> parent %d (%s)",
                live.generation, parent.generation, reason,
            )
            res = self.serving_model.stage_and_swap(
                parent.model_dir, **self.swap_kwargs
            )
            rec = _SwapRecord(
                registry_generation=parent.generation,
                parent=parent.parent,
                action="rollback",
                ok=res.ok,
                error=res.error,
            )
            with self._lock:
                self.history.append(rec)
                self._last_swap = rec
                if res.ok:
                    self._live = parent
            if res.ok:
                q = self.registry.quarantine_generation(
                    live.generation, reason=reason
                )
                self._log(
                    "generation %d quarantined in the registry (%s)",
                    live.generation, q,
                )
            # the rollback is the flight recorder's marquee event: the
            # record (kind "watcher.*") also triggers the armed
            # auto-dump, so the ring is on disk the moment the service
            # rolled back — not only at clean exit
            flight_recorder().record(
                "watcher.rollback",
                from_generation=live.generation,
                to_generation=parent.generation,
                reason=reason,
                ok=res.ok,
            )
            return res.ok
