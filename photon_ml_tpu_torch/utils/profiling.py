"""Profiler hooks: ``torch.profiler`` traces behind the drivers'
``--profile-dir`` flag (port of ``photon_ml_tpu/utils/profiling.py``,
whose ``jax.profiler`` trace this replaces). The host's operator
timeline, plus the card's kernels when the device is CUDA, lands in the
given directory as one Chrome trace-event file per process
(``<pid>.pt.trace.json``), which opens in Perfetto or
``chrome://tracing`` next to the ``--obs-dir`` host spans. Profiling is
off unless asked for."""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager, nullcontext
from typing import Dict, Optional


def profile_path(profile_dir: str) -> str:  # photon: entropy(pid-named trace file; one trace a process by design, as torch.profiler names it)
    """The Chrome trace this process's ``profile_trace`` writes."""
    return os.path.join(profile_dir, f"{os.getpid()}.pt.trace.json")


@contextmanager
def _trace(profile_dir: str, device):
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(profile_path(profile_dir))


def profile_trace(profile_dir: Optional[str], device=None):
    """Context manager: a ``torch.profiler`` trace into ``profile_dir``
    (CPU activity, plus CUDA activity when ``device`` is a card), or a
    no-op when the flag is unset."""
    if not profile_dir:
        return nullcontext()
    return _trace(profile_dir, device)


# -- host-side timing registry ----------------------------------------------
#
# The profiler covers device timelines; HOST-side one-off costs (schedule
# builds, cache loads/stores) need their own accumulation so drivers can
# report them without wrapping every call site in a Timer. Named buckets
# accumulate across the process; drivers snapshot into metrics.json.

_HOST_TIMINGS: Dict[str, float] = {}
_HOST_TIMINGS_LOCK = threading.Lock()


def record_host_timing(name: str, seconds: float) -> None:
    """Accumulate ``seconds`` into the named host-timing bucket
    (thread-safe — schedule builds run on worker threads)."""
    with _HOST_TIMINGS_LOCK:
        _HOST_TIMINGS[name] = _HOST_TIMINGS.get(name, 0.0) + seconds


def host_timings() -> Dict[str, float]:
    """Snapshot of all accumulated host-timing buckets."""
    with _HOST_TIMINGS_LOCK:
        return dict(_HOST_TIMINGS)


def reset_host_timings() -> None:
    with _HOST_TIMINGS_LOCK:
        _HOST_TIMINGS.clear()


def peak_rss_bytes() -> int:
    """The process's peak resident set in bytes (``ru_maxrss``, KiB on
    Linux, bytes on macOS): the streaming layer's reported host-memory
    ceiling."""
    import resource
    import sys

    ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return int(ru if sys.platform == "darwin" else ru * 1024)
