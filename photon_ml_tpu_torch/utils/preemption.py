"""Preemption detection for long-running training loops (port of
``photon_ml_tpu/utils/preemption.py``; no JAX in it, so a copy).

Photon ML delegates failure recovery entirely to Spark/YARN (lineage
recompute, container restarts; the code itself only fails fast,
Driver.scala:148-151). A job with no resource manager underneath it, on a
preemptible or spot machine, receives SIGTERM with a short grace window
before eviction. This module turns that signal into a cooperative flag
that training loops poll at safe points (iteration boundaries), so the
loop can write a final checkpoint and exit cleanly; the restarted job
resumes from the checkpoint (CoordinateDescent + TrainingCheckpointer).

Design: a tiny chained-handler guard rather than raising out of the
signal handler: an unwind in the middle of a device call can leave the
runtime in a bad state, while a flag checked between device calls is
always safe.
"""

from __future__ import annotations

import signal
import threading
from typing import List, Optional


class PreemptionGuard:
    """Cooperative preemption flag set by SIGTERM (and optionally other
    signals). Poll :meth:`requested` at iteration boundaries."""

    def __init__(self, signals: Optional[List[int]] = None):
        self.signals = list(signals) if signals is not None else [signal.SIGTERM]
        self._event = threading.Event()
        self._prev = {}
        self._installed = False

    # -- signal plumbing ---------------------------------------------------
    def install(self) -> "PreemptionGuard":
        """Register handlers; chains any previously-installed handler so
        outer supervisors still observe the signal. Main thread only."""
        if self._installed:
            return self
        for sig in self.signals:
            self._prev[sig] = signal.signal(sig, self._handle)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
        self._installed = False

    def _handle(self, signum, frame) -> None:
        self._event.set()
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- polling -----------------------------------------------------------
    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self) -> None:
        """Set the flag programmatically (tests, host-level watchdogs)."""
        self._event.set()

    def reset(self) -> None:
        self._event.clear()
