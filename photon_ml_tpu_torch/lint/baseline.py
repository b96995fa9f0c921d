"""Baseline handling: grandfathered violations, keyed content-wise (the
port's copy of ``photon_ml_tpu/lint/baseline.py``).

Entries match on ``(file, rule, stripped source line)`` rather than line
numbers, so unrelated edits above a grandfathered site don't churn the
baseline. Each key carries a count — two identical raw readback lines in
one file need two entries' worth of allowance, and FIXING one of them
makes the spare allowance visible as an unused entry."""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import List, Sequence, Tuple

from photon_ml_tpu_torch.lint.core import Report, Violation

BASELINE_VERSION = 1

# Rules whose violations may never be grandfathered. A lock-order
# inversion (PL009) is a deadlock with a schedule attached — baselining
# it ships the failure; write_baseline refuses and load_baseline rejects
# hand-edited entries. Ambient entropy in an artifact (PL016) rots the
# very signatures the bitwise gates compare, and a half-wired message
# type (PL018) is a protocol hole — both have declaration/contract
# mechanisms instead of grandfathering. (The reference's PL012, a
# sharded bank's host gather, is an SPMD-pass rule the port does not
# have.)
NEVER_BASELINE = frozenset({"PL009", "PL016", "PL018"})

_NEVER_BASELINE_WHY = {
    "PL009": "lock-order inversions are never baseline-able; fix the "
             "acquisition order instead",
    "PL016": "ambient entropy in artifacts is never baseline-able; "
             "derive the value from content or declare it with "
             "'# photon: entropy(<reason>)' instead",
    "PL018": "wire-contract holes are never baseline-able; wire the "
             "missing encoder/decoder/dispatch/corpus leg instead",
}

Key = Tuple[str, str, str]


class BaselineRefused(ValueError):
    """Raised when a violation set contains never-baseline-able rules."""


def baseline_key(v: Violation) -> Key:
    return (v.path, v.rule, v.snippet)


def load_baseline(path: str) -> Counter:
    """Baseline file -> Counter of (file, rule, snippet) allowances."""
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"unsupported baseline version {data.get('version')!r} "
            f"in {path} (expected {BASELINE_VERSION})"
        )
    allow: Counter = Counter()
    for e in data.get("entries", []):
        if e["rule"] in NEVER_BASELINE:
            raise ValueError(
                f"baseline {path} grandfathers {e['rule']} "
                f"({e['file']}) — {_NEVER_BASELINE_WHY[e['rule']]}"
            )
        allow[(e["file"], e["rule"], e["snippet"])] += int(
            e.get("count", 1)
        )
    return allow


def write_baseline(path: str, violations: Sequence[Violation]) -> dict:
    refused = [v for v in violations if v.rule in NEVER_BASELINE]
    if refused:
        sites = ", ".join(v.location() for v in refused[:5])
        why = "; ".join(sorted({
            _NEVER_BASELINE_WHY[v.rule] for v in refused
        }))
        raise BaselineRefused(
            f"{len(refused)} {sorted({v.rule for v in refused})} "
            f"violation(s) cannot be grandfathered ({sites}"
            f"{', ...' if len(refused) > 5 else ''}) — {why}; no "
            "baseline was written"
        )
    counts: Counter = Counter(baseline_key(v) for v in violations)
    entries: List[dict] = [
        {"file": f, "rule": r, "snippet": s, "count": c}
        for (f, r, s), c in sorted(counts.items())
    ]
    data = {"version": BASELINE_VERSION, "entries": entries}
    # temp + os.replace (PL006's own contract) without importing the
    # reliability helpers: the analyzer stays stdlib-only by design
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return data


def apply_baseline(report: Report, allow: Counter) -> Report:
    """Filter baselined violations out of ``report`` (in place): each
    (file, rule, snippet) key absorbs up to its count. Leftover
    allowances are surfaced as ``unused_baseline`` so stale entries are
    visible (and removable) instead of silently masking future
    regressions at the same key."""
    remaining = Counter(allow)
    kept: List[Violation] = []
    baselined = 0
    for v in report.violations:
        k = baseline_key(v)
        if remaining.get(k, 0) > 0:
            remaining[k] -= 1
            baselined += 1
        else:
            kept.append(v)
    report.violations = kept
    report.baselined = baselined
    report.unused_baseline = [
        {"file": f, "rule": r, "snippet": s, "count": c}
        for (f, r, s), c in sorted(remaining.items())
        if c > 0
    ]
    return report
