"""Hash-seed twin-run reproducibility harness — the runtime twin of the
lint determinism pass (PL015-PL018); port of
``photon_ml_tpu/testing/determinism.py``.

Static analysis proves no unordered iteration or ambient entropy REACHES
an artifact writer; this harness proves the composition: it executes the
same artifact-producing target in two fresh subprocesses under different
``PYTHONHASHSEED`` values (plus a perturbed ``TZ`` — the classic second
channel for "works on my box" artifacts), then byte-diffs the produced
trees. A divergence names the first differing file and byte offset, so
the offending writer is attributable from the gate log alone.

Why subprocesses and not ``sys.flags``: hash randomization is fixed at
interpreter startup — the ONLY way to run the same code under two seeds
is two interpreters. The child entry is this module's ``__main__``
(``python -m photon_ml_tpu_torch.testing.determinism --target <name>
--out <dir>``); targets live in :mod:`determinism_targets`, one per
artifact class the port ships. Each child runs under a timeout, so a
hung child fails its twin run instead of hanging the caller. The targets
are host writers: a child imports torch at most, and never creates a
CUDA context.

``python -m photon_ml_tpu_torch.testing.determinism --matrix --out DIR``
runs the full matrix as a gate: every artifact class twin-run, nonzero
exit on any divergence.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "TwinRunError",
    "TwinRunResult",
    "byte_diff_trees",
    "run_matrix",
    "run_target",
    "stable_seed",
    "twin_run",
]

# Repo root (the directory holding photon_ml_tpu_torch/): children need
# the package importable regardless of the caller's cwd.
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

# The two child environments. Different PYTHONHASHSEED is the point of
# the exercise; different TZ flushes out localtime-formatted timestamps
# that happen to agree when both runs share a zone. Kiritimati (UTC+14)
# maximizes the calendar distance from UTC — even the DATE differs for
# more than half of every day.
DEFAULT_SEEDS: Tuple[str, str] = ("0", "4242")
DEFAULT_TZS: Tuple[str, str] = ("UTC", "Pacific/Kiritimati")


def stable_seed(*parts: object) -> int:
    """A process-stable seed from the parts' text: crc32, NOT the
    builtin ``hash()`` (which is PYTHONHASHSEED-randomized — the exact
    defect class this harness exists to catch)."""
    text = ":".join(str(p) for p in parts)
    return zlib.crc32(text.encode("utf-8"))


class TwinRunError(RuntimeError):
    """A child run FAILED (nonzero exit) — distinct from a divergence,
    which is a successful run pair producing different bytes."""


@dataclass(frozen=True)
class TwinRunResult:
    target: str
    identical: bool
    divergence: Optional[str]  # None when identical
    seeds: Tuple[str, str]
    runtime_s: float

    def to_dict(self) -> Dict[str, object]:
        return {
            "target": self.target,
            "identical": self.identical,
            "divergence": self.divergence,
            "seeds": list(self.seeds),
            "runtime_s": round(self.runtime_s, 3),
        }


# -- tree comparison ----------------------------------------------------------


def _tree_files(root: str) -> Dict[str, str]:
    """relpath -> abspath for every file under root (sorted walk)."""
    out: Dict[str, str] = {}
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames.sort()
        for name in sorted(filenames):
            path = os.path.join(dirpath, name)
            out[os.path.relpath(path, root)] = path
    return out


def byte_diff_trees(a: str, b: str) -> Optional[str]:
    """None when the two trees are bitwise identical; else a message
    naming the FIRST divergence (missing file or first differing byte
    offset) — the attribution a gate log needs."""
    fa, fb = _tree_files(a), _tree_files(b)
    only_a = sorted(set(fa) - set(fb))
    only_b = sorted(set(fb) - set(fa))
    if only_a:
        return f"{only_a[0]}: present only in the first run"
    if only_b:
        return f"{only_b[0]}: present only in the second run"
    for rel in sorted(fa):
        with open(fa[rel], "rb") as fh:
            ba = fh.read()
        with open(fb[rel], "rb") as fh:
            bb = fh.read()
        if ba == bb:
            continue
        off = next(
            (i for i, (x, y) in enumerate(zip(ba, bb)) if x != y),
            min(len(ba), len(bb)),
        )
        return (
            f"{rel}: first byte divergence at offset {off} "
            f"({len(ba)} vs {len(bb)} bytes)"
        )
    return None


# -- the twin run -------------------------------------------------------------


def _child_env(seed: str, tz: str) -> Dict[str, str]:
    env = dict(os.environ)
    env["PYTHONHASHSEED"] = seed
    env["TZ"] = tz
    # a child never touches the card, even on a machine that has one
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = (
        _REPO_ROOT + os.pathsep + env["PYTHONPATH"]
        if env.get("PYTHONPATH")
        else _REPO_ROOT
    )
    return env


def twin_run(
    target: str,
    *,
    base_dir: str,
    seeds: Sequence[str] = DEFAULT_SEEDS,
    tzs: Sequence[str] = DEFAULT_TZS,
    timeout_s: float = 300.0,
) -> TwinRunResult:
    """Run ``target`` in two subprocesses under ``seeds[i]``/``tzs[i]``
    and byte-diff the output trees. Raises :class:`TwinRunError` when a
    child FAILS or outlives ``timeout_s`` (it is killed); a divergence is
    a normal (identical=False) result."""
    if len(seeds) != 2 or len(tzs) != 2:
        raise ValueError("twin_run needs exactly two seeds and two TZs")
    t0 = time.perf_counter()
    out_dirs: List[str] = []
    for i, (seed, tz) in enumerate(zip(seeds, tzs)):
        out = os.path.join(base_dir, f"{target}.run{i}")
        os.makedirs(out, exist_ok=True)
        try:
            proc = subprocess.run(
                [
                    sys.executable,
                    "-m",
                    "photon_ml_tpu_torch.testing.determinism",
                    "--target",
                    target,
                    "--out",
                    out,
                ],
                env=_child_env(seed, tz),
                cwd=_REPO_ROOT,
                capture_output=True,
                text=True,
                timeout=timeout_s,
            )
        except subprocess.TimeoutExpired as e:
            raise TwinRunError(
                f"{target} child (PYTHONHASHSEED={seed}, TZ={tz}) did not "
                f"finish within {timeout_s:g} s"
            ) from e
        if proc.returncode != 0:
            tail = (proc.stderr or proc.stdout or "").strip().splitlines()
            raise TwinRunError(
                f"{target} child (PYTHONHASHSEED={seed}, TZ={tz}) exited "
                f"{proc.returncode}: {' | '.join(tail[-3:])}"
            )
        out_dirs.append(out)
    divergence = byte_diff_trees(out_dirs[0], out_dirs[1])
    return TwinRunResult(
        target=target,
        identical=divergence is None,
        divergence=divergence,
        seeds=(str(seeds[0]), str(seeds[1])),
        runtime_s=time.perf_counter() - t0,
    )


def run_target(name: str, out_dir: str) -> None:
    """In-process dispatch to one artifact target (the child entry and
    the unit tests both route through here)."""
    from photon_ml_tpu_torch.testing import determinism_targets as dt

    fn = dt.ALL_TARGETS.get(name)
    if fn is None:
        known = ", ".join(sorted(dt.ALL_TARGETS))
        raise KeyError(f"unknown determinism target {name!r} (known: {known})")
    os.makedirs(out_dir, exist_ok=True)
    fn(out_dir)


# -- the gate matrix ----------------------------------------------------------


def run_matrix(
    base_dir: str,
    *,
    targets: Optional[Sequence[str]] = None,
    report_path: Optional[str] = None,
) -> Dict[str, object]:
    """Twin-run every artifact class; returns (and optionally writes)
    the gate report: per-class identical/divergence/runtime plus the
    overall verdict. The shell gate exits nonzero on ``ok == False``."""
    from photon_ml_tpu_torch.testing import determinism_targets as dt

    names = list(targets) if targets is not None else sorted(dt.TARGETS)
    t0 = time.perf_counter()
    classes: Dict[str, object] = {}
    ok = True
    for name in names:
        result = twin_run(name, base_dir=base_dir)
        classes[name] = result.to_dict()
        ok = ok and result.identical
    report: Dict[str, object] = {
        "ok": ok,
        "classes": classes,
        "seeds": list(DEFAULT_SEEDS),
        "tzs": list(DEFAULT_TZS),
        "runtime_s": round(time.perf_counter() - t0, 3),
    }
    if report_path is not None:
        from photon_ml_tpu_torch.reliability import atomic_write_json

        atomic_write_json(report_path, report)
    return report


def _main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m photon_ml_tpu_torch.testing.determinism",
        description=(
            "Twin-run determinism harness: --target/--out runs ONE "
            "artifact target in-process (the child mode twin_run "
            "spawns); --matrix twin-runs every artifact class and "
            "exits nonzero on any byte divergence."
        ),
    )
    ap.add_argument("--target", help="artifact target name (child mode)")
    ap.add_argument("--out", help="output directory")
    ap.add_argument(
        "--matrix",
        action="store_true",
        help="run the full twin-run matrix over every artifact class",
    )
    ap.add_argument(
        "--report",
        help="with --matrix: write the gate report JSON here",
    )
    args = ap.parse_args(argv)
    if args.matrix:
        if not args.out:
            ap.error("--matrix requires --out")
        report = run_matrix(args.out, report_path=args.report)
        for name in sorted(report["classes"]):
            entry = report["classes"][name]
            verdict = (
                "byte-identical"
                if entry["identical"]
                else f"DIVERGED: {entry['divergence']}"
            )
            print(
                f"determinism[{name}]: {verdict} "
                f"({entry['runtime_s']:.2f}s)"
            )
        print(
            "determinism matrix: "
            + ("OK" if report["ok"] else "DIVERGENCE")
            + f" ({report['runtime_s']:.2f}s, {len(report['classes'])} "
            f"classes, seeds {'/'.join(report['seeds'])})"
        )
        return 0 if report["ok"] else 1
    if not args.target or not args.out:
        ap.error("child mode requires --target and --out")
    run_target(args.target, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(_main())
