"""Retry and quarantine for the IO seams (a minimal port of
``photon_ml_tpu/reliability/retry.py``: the schedule cache's seams,
``cache_load`` and ``cache_store``; fault injection comes with ROADMAP
item 12).

- :func:`io_call` runs one IO operation, retried once after a short fixed
  backoff on a transient OS error.
- :class:`SeamFailure` is what a seam raises once its budget is spent: it
  names the seam and the artifact.
- :func:`quarantine_artifact` renames an artifact that keeps failing to
  ``*.corrupt`` (counted), so the caller rebuilds instead of re-tripping
  on it in every run.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Callable, Dict, List, Optional


# the cache seams fall back to a cheap rebuild, so their budget is shallow
MAX_ATTEMPTS = 2
BACKOFF_S = 0.01
# transient OS/IO errors; a ValueError (corrupt bytes) is not retried:
# re-reading them yields the same bytes, so it routes to quarantine
RETRYABLE = (OSError, EOFError)


class SeamFailure(RuntimeError):
    """A seam exhausted its retry budget."""

    def __init__(self, seam: str, detail: str, attempts: int):
        super().__init__(
            f"{seam} failed after {attempts} attempt(s)"
            + (f" on {detail}" if detail else "")
        )
        self.seam = seam
        self.detail = detail
        self.attempts = attempts


_LOCK = threading.Lock()
_ATTEMPTS: Dict[str, int] = {}
_RETRIES: Dict[str, int] = {}
_GIVEUPS: Dict[str, int] = {}
_QUARANTINED: Dict[str, int] = {}
_QUARANTINED_PATHS: List[str] = []


def _note(table: Dict[str, int], seam: str) -> None:
    with _LOCK:
        table[seam] = table.get(seam, 0) + 1


def retry_stats() -> Dict[str, object]:
    """The attempt, retry, give-up and quarantine counters by seam."""
    with _LOCK:
        return {
            "attempts": dict(_ATTEMPTS),
            "retries": dict(_RETRIES),
            "giveups": dict(_GIVEUPS),
            "quarantined": dict(_QUARANTINED),
            "quarantined_artifacts": list(_QUARANTINED_PATHS),
        }


def io_call(seam: str, fn: Callable, *args, detail: str = "", **kwargs):
    """Run ``fn`` (idempotent per attempt) behind its seam: transient
    errors back off and retry, the budget's end raises SeamFailure."""
    attempt = 0
    while True:
        attempt += 1
        _note(_ATTEMPTS, seam)
        try:
            return fn(*args, **kwargs)
        except RETRYABLE as e:
            if attempt >= MAX_ATTEMPTS:
                _note(_GIVEUPS, seam)
                raise SeamFailure(seam, detail, attempt) from e
            _note(_RETRIES, seam)
            time.sleep(BACKOFF_S)


def quarantine_artifact(path: str, seam: str) -> Optional[str]:
    """Rename a poisoned artifact (file or directory) to ``*.corrupt``;
    -> the quarantine path (None when the artifact vanished)."""
    if not os.path.exists(path):
        return None
    dst = path + ".corrupt"
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = f"{path}.corrupt-{n}"
    try:
        os.replace(path, dst)
    except OSError:
        # cross-device or permission trouble: remove it instead, so the
        # next run does not load it again
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        else:
            os.remove(path)
        dst = path + " (removed)"
    _note(_QUARANTINED, seam)
    with _LOCK:
        _QUARANTINED_PATHS.append(dst)
    return dst
