"""The arithmetic the per-layer metric files under ``metrics/`` share.

Each reads a run's ``harness.Record`` and returns the metric's value, or
None where the run holds nothing to read (no traced device operation, no
launch of the kernel): a share is never given as 0 for a kernel that did
not run.
"""

from __future__ import annotations

import devtrace
import peaks


def layer(record, key):
    """A reading the loop took by name (host clock, counters)."""
    return record.layer.get(key)


def idle_share(record):
    """Percent of the traced window in which no operation ran on the device."""
    tr = record.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu(record):
    """Percent: the least time of the window's required work (counted by
    the loop from the solvers' results, ``peaks.py``) over the window."""
    tr = record.trace
    if tr is None or not tr.device or record.required_s <= 0:
        return None
    return 100.0 * record.required_s / tr.window_s


def roofline(record, kernel: str, members: int = 1):
    """Percent: the least time of every launch of ``kernel`` (a sparse pass
    over the run's ``nnz`` nonzeros, ``rows`` and ``features``, for
    ``members`` vectors) over the launches' device time."""
    tr = record.trace
    if tr is None:
        return None
    took = devtrace.launch_groups(tr.device, kernel)
    if not took:
        return None
    s = record.shapes
    least = len(took) * peaks.pass_least_s(s["nnz"], s["features"], s["rows"], members)
    return peaks.share_percent(least, sum(took))
