"""Device time from a ``torch.profiler`` trace of the window.

``busy_s`` is the union of the device operations' intervals inside the
window (kernels, copies and fills: one stream, and where two overlapped
they count once), so the idle share is ``1 - busy_s / window_s``. That is
``photon_ml_tpu_torch/tools/profile_grid.py``'s ``profile_fits`` arithmetic
(idle = 1 - device busy / host seconds, ``profile_grid.py:59-65``) with a
union in place of its sum over kernels, which counts an overlap twice.

Events are read from the profiler's raw kineto results, not
``key_averages()``: a 30-second window holds some million events, and the
averaged tree would take minutes to build.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

# the longest idle gaps are also named by the host operations they overlap
# (looked for among the CANDIDATES that start last before each gap ends)
LABELLED = 2000
CANDIDATES = 64


@dataclass
class Trace:
    """Device operations ``(name, start_s, end_s)`` sorted by start, and the
    host's operations, clipped to the window ``[start_s, end_s]`` (seconds
    on the profiler's clock)."""

    start_s: float
    end_s: float
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.end_s - self.start_s

    @property
    def busy_s(self) -> float:
        return union_s((s, e) for _, s, e in self.device)

    def top_ops(self, limit: int) -> List[List]:
        """The device operations that took most time, summed by name."""
        total = defaultdict(float)
        for name, s, e in self.device:
            total[short_name(name)] += e - s
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:limit]]

    def idle_gaps(self, limit: int) -> List[List]:
        """Idle device time inside the window summed by what the host was
        doing: each gap is named by the innermost benchmark span around it
        (``bench.re_update``), and each of the LABELLED longest gaps also by
        the host operation that overlaps it most
        (``bench.re_update/aten::nonzero``)."""
        all_gaps = sorted(gaps(self.device, self.start_s, self.end_s), key=lambda g: g[0] - g[1])
        spans = [h for h in self.host if h[0].startswith("bench.") and h[0] != "bench.window"]
        span_starts = [s for _, s, _ in spans]
        ops = [h for h in self.host if not h[0].startswith("bench.")]
        starts = [s for _, s, _ in ops]
        total = defaultdict(float)
        for k, (gs, ge) in enumerate(all_gaps):
            span = "outside the units"
            i = bisect.bisect_right(span_starts, gs) - 1
            while i >= 0:
                if spans[i][2] >= ge:
                    span = spans[i][0]
                    break
                i -= 1
            if k >= LABELLED:
                total[f"{span}/short gaps"] += ge - gs
                continue
            best, best_overlap = "host (no traced operation)", 0.0
            hi = bisect.bisect_right(starts, ge)
            for name, s, e in ops[max(0, hi - CANDIDATES):hi]:
                overlap = min(e, ge) - max(s, gs)
                if overlap > best_overlap:
                    best, best_overlap = name, overlap
            total[f"{span}/{best}"] += ge - gs
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:limit]]


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    argument list (templates kept)."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            return name[:i][:120]
    return name[:120]


def union_s(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(device, start: float, end: float):
    """The idle intervals of the window between device operations."""
    cur = start
    for _, s, e in device:
        if s > cur:
            yield cur, min(s, end)
        cur = max(cur, e)
    if end > cur:
        yield cur, end


def launch_groups(device, kernel: str, helpers: Sequence[str] = ("reduce_shared",)):
    """Device seconds of each launch of ``kernel``: a kernel whose name
    (templates and arguments aside) is ``kernel``, plus the ``helpers``
    kernels that follow it before any other operation (K1's and K2's
    wrappers launch a shared-block reduction after the pass)."""
    out: List[float] = []
    current: Optional[int] = None
    for name, s, e in device:
        base = _base(name)
        if base == kernel:
            out.append(e - s)
            current = len(out) - 1
        elif base in helpers and current is not None:
            out[current] += e - s
        else:
            current = None
    return out


def _base(name: str) -> str:
    return short_name(name).split("<")[0].split("::")[-1].strip()


def _ns(ev, what: str) -> int:
    fn = getattr(ev, what + "_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, what + "_us")()) * 1000


def _annotation(ev) -> bool:
    """A host span mirrored onto the device's timeline, not an operation."""
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag()) if flag is not None else ev.name().startswith("bench.")


def from_profiler(prof, window_name: str) -> Trace:
    """The window's device and host operations from a stopped profiler."""
    events = prof.profiler.kineto_results.events()
    device, host = [], []
    start = end = None
    # seconds from the first event, taken from integer nanoseconds: the
    # clock's epoch value has too many digits for a float
    base = min((_ns(ev, "start") for ev in events), default=0)
    for ev in events:
        kind = str(ev.device_type()).split(".")[-1]
        s_ns = _ns(ev, "start")
        s = (s_ns - base) * 1e-9
        e = (s_ns + _ns(ev, "duration") - base) * 1e-9
        if kind == "CPU":
            name = ev.name()
            if name == window_name:
                start, end = s, e
            host.append((name, s, e))
        elif kind == "CUDA" and not _annotation(ev):
            device.append((ev.name(), s, e))
    if start is None:
        raise RuntimeError(f"the trace holds no {window_name!r} span")
    device = sorted(
        ((n, max(s, start), min(e, end)) for n, s, e in device if e > start and s < end),
        key=lambda t: t[1],
    )
    host = sorted(
        ((n, s, e) for n, s, e in host if e > start and s < end), key=lambda t: t[1]
    )
    return Trace(start, end, device, host)
