"""Retry / backoff / quarantine policy for the IO seams (port of
``photon_ml_tpu/reliability/retry.py``; no JAX in it, so a copy).

Photon ML delegates all of this to Spark: a failed partition read is
retried by the task scheduler, a lost executor's lineage recomputes. With
no scheduler underneath, every IO seam (spill stores, schedule cache,
checkpoints, async artifact writes) routes through this one policy layer:

- :func:`io_call` — the reliable-call wrapper: one :func:`faults.inject`
  crossing per attempt (chaos runs exercise the retry path
  deterministically), bounded exponential backoff with deterministic
  jitter, per-seam attempt budgets.
- :class:`SeamFailure` — what a seam raises after its budget is spent:
  names the seam AND the artifact, so a failed write can never
  masquerade as success or as some generic stack trace.
- :func:`quarantine_artifact` — the poisoned-artifact protocol: an
  artifact that keeps failing is renamed to ``*.corrupt`` (it stops
  poisoning every future run) and counted; the caller rebuilds from
  source or fails loudly — never a silent drop.

Backoff jitter is deterministic (seeded from seam + attempt), so a chaos
run's retry schedule replays exactly. Delays are intentionally small
(10 ms base) — these seams are local disk, not RPC.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from photon_ml_tpu_torch.reliability.faults import InjectedCorruption, inject

__all__ = [
    "RetryPolicy",
    "SeamFailure",
    "io_call",
    "policy_for",
    "quarantine_artifact",
    "retry_stats",
    "reset_retry_stats",
    "reliability_metrics",
]

ENV_MAX_ATTEMPTS = "PHOTON_RETRY_ATTEMPTS"
ENV_BASE_DELAY = "PHOTON_RETRY_BASE_S"


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff: attempt k sleeps
    ``min(base * 2^(k-1), max_delay) * (1 + jitter * u)`` with u a
    deterministic per-(seam, attempt) uniform draw."""

    max_attempts: int = 3
    base_delay_s: float = 0.01
    max_delay_s: float = 0.25
    jitter: float = 0.5
    # Exception classes worth a retry: transient OS/IO errors. ValueError
    # (artifact corruption) is NOT here — re-reading corrupt bytes yields
    # corrupt bytes; that class routes to quarantine instead.
    retryable: Tuple[type, ...] = (OSError, EOFError)


# Per-seam budgets: data-path reads get the deepest budget (losing one
# loses the run), cache seams the shallowest (their fallback is a cheap
# rebuild, not a failure).
_POLICIES: Dict[str, RetryPolicy] = {
    "chunk_read": RetryPolicy(max_attempts=4),
    "spill_write": RetryPolicy(max_attempts=3),
    "spill_read": RetryPolicy(max_attempts=3),
    "cache_load": RetryPolicy(max_attempts=2),
    "cache_store": RetryPolicy(max_attempts=2),
    "ckpt_save": RetryPolicy(max_attempts=3),
    "ckpt_restore": RetryPolicy(max_attempts=3),
    "io_worker": RetryPolicy(max_attempts=3),
    "decode_ahead": RetryPolicy(max_attempts=1),
    # a failed swap load rolls back to the serving generation, so the
    # budget is shallow-ish: three attempts, then keep serving N
    "serving.model_load": RetryPolicy(max_attempts=3),
    # a failed connection read is the CLIENT's problem: one named error
    # response, no retry — the service must not burn dispatcher time on
    # a broken socket
    "serving.frontend.read": RetryPolicy(max_attempts=1),
    # dispatch is pure compute + one readback (idempotent); a transient
    # fault retries bitwise, an exhausted budget fails the batch's
    # futures with the seam-named error
    "serving.dispatch": RetryPolicy(max_attempts=3, base_delay_s=0.002),
    # every publish step is idempotent (stage into a token-unique
    # directory, rename, marker write), so transient faults retry; an
    # exhausted budget aborts the publish with NOTHING visible — the
    # crash-resume path (adopt-or-quarantine of uncommitted dirs)
    # handles the rest
    "registry.publish": RetryPolicy(max_attempts=3),
    # cache seams fall back to a rescan of the partition, so the budget
    # is shallow like the schedule cache's
    "registry.stats_cache": RetryPolicy(max_attempts=2),
}


def policy_for(seam: str) -> RetryPolicy:
    policy = _POLICIES.get(seam, RetryPolicy())
    forced = os.environ.get(ENV_MAX_ATTEMPTS)
    base = os.environ.get(ENV_BASE_DELAY)
    if forced or base:
        from dataclasses import replace

        if forced:
            policy = replace(policy, max_attempts=max(1, int(forced)))
        if base:
            policy = replace(policy, base_delay_s=float(base))
    return policy


class SeamFailure(RuntimeError):
    """A seam exhausted its retry budget. Carries the seam and artifact
    name so the failure is attributable from the driver log alone."""

    def __init__(self, seam: str, detail: str, attempts: int):
        super().__init__(
            f"{seam} failed after {attempts} attempt(s)"
            + (f" on {detail}" if detail else "")
        )
        self.seam = seam
        self.detail = detail
        self.attempts = attempts


# -- stats --------------------------------------------------------------------

_LOCK = threading.Lock()
_ATTEMPTS: Dict[str, int] = {}
_RETRIES: Dict[str, int] = {}
_GIVEUPS: Dict[str, int] = {}
_QUARANTINED: Dict[str, int] = {}
_QUARANTINED_PATHS: List[str] = []


def _note(table: Dict[str, int], seam: str) -> None:
    with _LOCK:
        table[seam] = table.get(seam, 0) + 1


def retry_stats() -> Dict[str, Dict[str, int]]:
    with _LOCK:
        return {
            "attempts": dict(_ATTEMPTS),
            "retries": dict(_RETRIES),
            "giveups": dict(_GIVEUPS),
            "quarantined": dict(_QUARANTINED),
            "quarantined_artifacts": list(_QUARANTINED_PATHS),
        }


def reset_retry_stats() -> None:
    with _LOCK:
        _ATTEMPTS.clear()
        _RETRIES.clear()
        _GIVEUPS.clear()
        _QUARANTINED.clear()
        _QUARANTINED_PATHS.clear()


def reliability_metrics() -> Dict[str, object]:
    """The metrics.json accounting block: fault-injection counters +
    retry/quarantine counters. Every retry and every quarantine a run
    performed is visible here — the chaos matrix asserts against it."""
    from photon_ml_tpu_torch.reliability.faults import fault_stats

    return {"faults": fault_stats(), "retries": retry_stats()}


# -- the reliable-call wrapper ------------------------------------------------


def _backoff_s(policy: RetryPolicy, seam: str, attempt: int) -> float:
    import random
    import zlib

    delay = min(
        policy.base_delay_s * (2.0 ** (attempt - 1)), policy.max_delay_s
    )
    # crc32, not hash(): the builtin is PYTHONHASHSEED-randomized, so
    # the per-(seam, attempt) jitter schedule — which tests and reruns
    # rely on being reproducible — would differ per process
    seed = zlib.crc32(f"{seam}:{attempt}".encode("utf-8"))
    u = random.Random(seed).random()
    return delay * (1.0 + policy.jitter * u)


def io_call(
    seam: str,
    fn: Callable,
    *args,
    detail: str = "",
    policy: Optional[RetryPolicy] = None,
    **kwargs,
):
    """Run one IO operation behind its seam: fault injection fires per
    ATTEMPT (a planned once-fault exercises the retry; an every-call
    fault exhausts the budget), transient errors back off and retry,
    the budget's end raises :class:`SeamFailure` naming the artifact.

    The wrapped ``fn`` must be idempotent per attempt (seek-then-write,
    whole-file decode, tmp+rename) — every seam in the package is.
    """
    policy = policy or policy_for(seam)
    attempt = 0
    while True:
        attempt += 1
        _note(_ATTEMPTS, seam)
        try:
            inject(seam, detail=detail)
            return fn(*args, **kwargs)
        except InjectedCorruption:
            raise  # corruption is the caller's quarantine path, not ours
        except policy.retryable as e:
            if attempt >= policy.max_attempts:
                _note(_GIVEUPS, seam)
                raise SeamFailure(seam, detail, attempt) from e
            _note(_RETRIES, seam)
            time.sleep(_backoff_s(policy, seam, attempt))


def quarantine_artifact(path: str, seam: str) -> Optional[str]:
    """Rename a poisoned artifact (file OR directory) to ``*.corrupt``
    so it cannot fail every future run; returns the quarantine path
    (None when the artifact vanished underneath us). Counted per seam
    and listed by name in :func:`reliability_metrics` — quarantines are
    accounted, never silent."""
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
        # cross-device or permission trouble: fall back to removal — the
        # point is that the next run must not reload the poison
        import shutil

        shutil.rmtree(path, ignore_errors=True) if os.path.isdir(
            path
        ) else os.remove(path)
        dst = path + " (removed)"
    _note(_QUARANTINED, seam)
    with _LOCK:
        _QUARANTINED_PATHS.append(dst)
    return dst
