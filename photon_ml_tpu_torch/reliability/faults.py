"""Deterministic fault injection for the IO and transfer seams (port of
``photon_ml_tpu/reliability/faults.py``; no JAX in it, so a copy).

A production retraining loop has to assume that components fail and
restart while the rest keep making progress, and chaos has to be
reproducible, or a flaky green run proves nothing. Every IO seam of the
package is a *named injection point* driven by a parsed fault plan, so
"fail the 3rd chunk read with EIO, once" is a string that replays bit for
bit.

Plan syntax (``--fault-plan`` / ``PHOTON_FAULT_PLAN``): comma-separated
entries, each ::

    <seam>:<nth>:<error>[:<times>]

- ``seam``: one of :data:`SEAMS` (``chunk_read``, ``spill_write``, ...).
- ``nth``: 1-based call index at which the fault starts firing.
- ``error``: ``EIO`` / ``ENOSPC`` / ``EACCES`` / ``ETIMEDOUT`` (raised
  as :class:`InjectedFault`, an OSError the retry layer treats like any
  transient IO error), ``CORRUPT`` (raised as
  :class:`InjectedCorruption`, a ValueError — the artifact-damage
  class the quarantine paths handle), or ``KILL`` (SIGKILL to the own
  process at that exact crossing: deterministic ``kill -9`` — no
  handlers, no atexit, no flushes — the crash-resume tests' hammer).
- ``times``: how many consecutive calls fail (default 1; ``once`` is an
  accepted alias; ``*`` means every call from ``nth`` on — the
  poisoned-artifact case that must end in quarantine/giveup, never a
  silent skip).

Example: ``chunk_read:3:EIO,ckpt_save:1:ENOSPC:2``.

Injection is counted per seam whether or not a fault fires, so the
accounting in ``metrics.json`` shows exactly which seams a run crossed
and how many faults were injected — the chaos matrix's completion
invariant is checked against these counters.
"""

from __future__ import annotations

import errno
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = [
    "SEAMS",
    "InjectedFault",
    "InjectedCorruption",
    "FaultEntry",
    "FaultPlan",
    "install_plan",
    "active_plan",
    "inject",
    "fault_stats",
    "reset_fault_stats",
]

ENV_FAULT_PLAN = "PHOTON_FAULT_PLAN"

# The seam classes threaded through the package. Every io_call /
# inject() site names one of these; an unknown seam is a programming
# error (raised at plan parse AND at injection time).
SEAMS = (
    "chunk_read",     # Avro/LibSVM file decode feeding iter_chunks
    "spill_write",    # chunk/score/bucket-segment store writes
    "spill_read",     # chunk/score/bucket-segment store reads
    "cache_load",     # tile-schedule cache artifact load
    "cache_store",    # tile-schedule cache artifact store
    "ckpt_save",      # checkpoint step / meta / lambda-snapshot save
    "ckpt_restore",   # checkpoint restore / meta load
    "io_worker",      # overlap.submit_io async artifact writes
    "decode_ahead",   # decode-ahead worker thread handoff
    "serving.model_load",  # serving bank load / hot-swap staging reads
    "serving.frontend.read",   # network front-end per-line reads
    "serving.dispatch",        # micro-batch device dispatch (idempotent)
    "registry.publish",        # model-registry publish protocol steps
    "registry.stats_cache",    # per-partition scan/stats cache load/store
)

_ERRNO = {
    "EIO": errno.EIO,
    "ENOSPC": errno.ENOSPC,
    "EACCES": errno.EACCES,
    "ETIMEDOUT": errno.ETIMEDOUT,
}


class InjectedFault(OSError):
    """A planned transient IO failure (retryable, carries a real errno)."""

    def __init__(self, seam: str, err: str, occurrence: int, detail: str):
        super().__init__(
            _ERRNO[err],
            f"injected {err} at {seam} call #{occurrence}"
            + (f" ({detail})" if detail else ""),
        )
        self.seam = seam
        self.occurrence = occurrence


class InjectedCorruption(ValueError):
    """Planned artifact damage (NOT retryable: re-reading a corrupt file
    yields the same bytes — the quarantine/rebuild paths own this)."""

    def __init__(self, seam: str, occurrence: int, detail: str):
        super().__init__(
            f"injected corruption at {seam} call #{occurrence}"
            + (f" ({detail})" if detail else "")
        )
        self.seam = seam
        self.occurrence = occurrence


@dataclass(frozen=True)
class FaultEntry:
    seam: str
    nth: int          # 1-based first failing call
    error: str        # key of _ERRNO, or "CORRUPT"
    times: int        # consecutive failures; -1 = every call from nth on

    def fires_at(self, occurrence: int) -> bool:
        if occurrence < self.nth:
            return False
        return self.times < 0 or occurrence < self.nth + self.times


@dataclass
class FaultPlan:
    """Parsed plan + per-seam call counters. Deterministic by
    construction: the nth crossing of a seam fires the nth-indexed
    entries, independent of threads or timing (the counter increment is
    atomic under the plan lock)."""

    entries: List[FaultEntry] = field(default_factory=list)
    text: str = ""
    _calls: Dict[str, int] = field(default_factory=dict)
    _injected: Dict[str, int] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        entries = []
        for raw in (text or "").split(","):
            raw = raw.strip()
            if not raw:
                continue
            parts = raw.split(":")
            if len(parts) not in (3, 4):
                raise ValueError(
                    f"bad fault-plan entry {raw!r}: expected "
                    "seam:nth:error[:times]"
                )
            seam, nth_s, err = parts[0].strip(), parts[1].strip(), (
                parts[2].strip().upper()
            )
            if seam not in SEAMS:
                raise ValueError(
                    f"unknown fault seam {seam!r}; known: {', '.join(SEAMS)}"
                )
            if err not in ("CORRUPT", "KILL") and err not in _ERRNO:
                raise ValueError(
                    f"unknown fault error {err!r}; known: "
                    f"{', '.join(_ERRNO)}, CORRUPT, KILL"
                )
            nth = int(nth_s)
            if nth < 1:
                raise ValueError(f"fault nth must be >= 1, got {nth}")
            times_s = parts[3].strip().lower() if len(parts) == 4 else "1"
            if times_s in ("once", "1"):
                times = 1
            elif times_s == "*":
                times = -1
            else:
                times = int(times_s)
                if times < 1:
                    raise ValueError(
                        f"fault times must be >= 1 or '*', got {times_s}"
                    )
            entries.append(FaultEntry(seam, nth, err, times))
        return cls(entries=entries, text=text or "")

    def check(self, seam: str, detail: str = "") -> None:
        """Count one crossing of ``seam``; raise the planned error when an
        entry covers this occurrence."""
        with self._lock:
            n = self._calls.get(seam, 0) + 1
            self._calls[seam] = n
            fire = next(
                (e for e in self.entries
                 if e.seam == seam and e.fires_at(n)),
                None,
            )
            if fire is not None:
                self._injected[seam] = self._injected.get(seam, 0) + 1
        if fire is None:
            return
        if fire.error == "KILL":
            # deterministic kill -9 at this exact crossing: SIGKILL is
            # uncatchable, so nothing below this line runs — exactly the
            # no-cleanup crash the resume machinery must survive
            import signal

            os.kill(os.getpid(), signal.SIGKILL)
        if fire.error == "CORRUPT":
            raise InjectedCorruption(seam, n, detail)
        raise InjectedFault(seam, fire.error, n, detail)

    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {
                "calls": dict(self._calls),
                "injected": dict(self._injected),
            }


# -- process-wide plan --------------------------------------------------------

_LOCK = threading.Lock()
_PLAN: Optional[FaultPlan] = None
_PLAN_RESOLVED = False
# Seam-crossing counters kept even with NO plan installed, so the
# accounting in metrics.json always shows which seams a run exercised.
_BASE_CALLS: Dict[str, int] = {}


def install_plan(plan) -> Optional[FaultPlan]:
    """Install a FaultPlan (or plan text, or None to clear). Drivers call
    this from ``--fault-plan``; tests from fixtures."""
    global _PLAN, _PLAN_RESOLVED
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    with _LOCK:
        _PLAN = plan
        _PLAN_RESOLVED = True
    return plan


def active_plan() -> Optional[FaultPlan]:
    """The installed plan, resolving ``PHOTON_FAULT_PLAN`` on first use."""
    global _PLAN, _PLAN_RESOLVED
    with _LOCK:
        if not _PLAN_RESOLVED:
            text = os.environ.get(ENV_FAULT_PLAN, "").strip()
            _PLAN = FaultPlan.parse(text) if text else None
            _PLAN_RESOLVED = True
        return _PLAN


def inject(seam: str, detail: str = "") -> None:
    """The injection point: every reliability seam calls this once per
    attempt. No plan installed -> a counter bump and nothing else."""
    if seam not in SEAMS:
        raise ValueError(f"unknown fault seam {seam!r}")
    plan = active_plan()
    if plan is not None:
        plan.check(seam, detail)
        return
    with _LOCK:
        _BASE_CALLS[seam] = _BASE_CALLS.get(seam, 0) + 1


def fault_stats() -> Dict[str, Dict[str, int]]:
    """{"calls": {seam: n}, "injected": {seam: k}, "plan": text} for the
    metrics.json accounting block."""
    plan = active_plan()
    if plan is not None:
        out = plan.stats()
        out["plan"] = plan.text
        return out
    with _LOCK:
        return {"calls": dict(_BASE_CALLS), "injected": {}, "plan": ""}


def reset_fault_stats() -> None:
    global _PLAN, _PLAN_RESOLVED
    with _LOCK:
        _BASE_CALLS.clear()
        _PLAN = None
        _PLAN_RESOLVED = False
