"""photon-lint CLI for the port: text (clickable file:line:col) and --json
modes, with the reference CLI's flags, exit codes and JSON keys
(``photon_ml_tpu/lint/cli.py``).

Exit codes: 0 clean, 1 non-baselined violations, 2 analysis/usage error
(a file that does not parse is an error, not a pass). The port has no
SPMD pass: ``--no-spmd`` is accepted, so a command line that works for
the reference works here, and changes nothing; the JSON's
``sharding_contracts`` and ``export_scopes`` are empty lists. The
reference's ``--write-sharding-md`` / ``--check-sharding-md`` are not
options here (argparse's exit 2).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Sequence

from photon_ml_tpu_torch.lint.baseline import (
    BaselineRefused,
    apply_baseline,
    load_baseline,
    write_baseline,
)
from photon_ml_tpu_torch.lint.core import all_rules, analyze_paths

DEFAULT_BASELINE = ".photon-lint-torch-baseline.json"
DEFAULT_PATHS = ("photon_ml_tpu_torch",)


def _default_paths() -> List[str]:
    return [p for p in DEFAULT_PATHS if os.path.exists(p)]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m photon_ml_tpu_torch.lint",
        description=(
            "AST-based invariant checker for the PyTorch port's hot "
            "path (readback seam, spill/IO hygiene), the thread plane "
            "(guard discipline, lock ordering, atomicity) and the "
            "determinism plane (unordered iteration into artifacts, "
            "ambient entropy in signatures, float accumulation order, "
            "wire-contract completeness) — all whole-package passes on "
            "by default. Suppress a line with '# photon: allow(<rule>)'; "
            "declare guard discipline with '# photon: guarded-by(<lock>)' "
            "and legitimate entropy with '# photon: entropy(<reason>)'."
        ),
    )
    p.add_argument(
        "paths", nargs="*",
        help="files or directories (default: photon_ml_tpu_torch)",
    )
    p.add_argument(
        "--json", action="store_true", dest="as_json",
        help="machine-readable report (violations, baselined count, "
             "allow-sites with seam accounting, unused baseline entries)",
    )
    p.add_argument(
        "--baseline", default=None, metavar="PATH",
        help=f"baseline file (default: {DEFAULT_BASELINE} when present)",
    )
    p.add_argument(
        "--no-baseline", action="store_true",
        help="ignore any baseline file",
    )
    p.add_argument(
        "--write-baseline", action="store_true",
        help="write the current violation set as the new baseline "
             "and exit 0",
    )
    p.add_argument(
        "--list-rules", action="store_true",
        help="print the rule table and exit",
    )
    p.add_argument(
        "--no-concurrency", action="store_true",
        help="skip the whole-package concurrency pass (PL008-PL010); "
             "the pass runs by default",
    )
    p.add_argument(
        "--no-spmd", action="store_true",
        help="accepted for parity with the reference CLI and does nothing: "
             "the port has no SPMD pass (PL011-PL014 check shard_map programs)",
    )
    p.add_argument(
        "--no-determinism", action="store_true",
        help="skip the whole-package determinism pass (PL015-PL018 + "
             "entropy declarations + wire contract); the pass runs by "
             "default",
    )
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rule in sorted(all_rules().values(), key=lambda r: r.id):
            print(f"{rule.id}  {rule.slug:24s}  {rule.doc}")
        return 0

    paths = args.paths or _default_paths()
    if not paths:
        print(
            "photon-lint: no paths given and no default targets found",
            file=sys.stderr,
        )
        return 2

    report = analyze_paths(
        paths,
        package_pass=not args.no_concurrency,
        determinism_pass=not args.no_determinism,
    )

    baseline_path = args.baseline or (
        DEFAULT_BASELINE if os.path.exists(DEFAULT_BASELINE) else None
    )
    if args.write_baseline:
        target = args.baseline or DEFAULT_BASELINE
        try:
            data = write_baseline(target, report.violations)
        except BaselineRefused as e:
            print(f"photon-lint: {e}", file=sys.stderr)
            return 2
        print(
            f"photon-lint: wrote {len(data['entries'])} baseline "
            f"entr{'y' if len(data['entries']) == 1 else 'ies'} "
            f"({len(report.violations)} violation(s)) to {target}"
        )
        return 0

    if baseline_path and not args.no_baseline:
        try:
            allow = load_baseline(baseline_path)
        except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
            print(f"photon-lint: bad baseline {baseline_path}: {e}",
                  file=sys.stderr)
            return 2
        apply_baseline(report, allow)

    exit_code = 0
    if report.violations:
        exit_code = 1
    if report.errors:
        exit_code = 2

    if args.as_json:
        payload = {
            "version": 1,
            "files_checked": len(report.files),
            "violations": [v.to_dict() for v in report.violations],
            "baselined": report.baselined,
            "allow_sites": [
                s.to_dict() for s in report.allow_sites
            ],
            "unused_baseline": report.unused_baseline,
            "errors": [
                {"file": f, "message": m} for f, m in report.errors
            ],
            "exit_code": exit_code,
        }
        if report.package is not None and not args.no_spmd:
            # the reference's SPMD inventory keys; the port has none
            payload["sharding_contracts"] = []
            payload["export_scopes"] = []
        if report.package is not None and not args.no_determinism:
            from photon_ml_tpu_torch.lint import determinism

            contract = determinism.wire_contract(report.package)
            payload["wire_contract"] = (
                contract.to_dict() if contract is not None else None
            )
            payload["entropy_declarations"] = (
                determinism.entropy_inventory(report.package)
            )
        print(json.dumps(payload, indent=2))
        return exit_code

    for f, m in report.errors:
        print(f"{f}:1:0: ERROR {m}")
    for v in report.violations:
        print(f"{v.location()}: {v.rule} [{v.slug}] {v.message}")
    for e in report.unused_baseline:
        print(
            f"warning: unused baseline entry {e['file']} {e['rule']} "
            f"{e['snippet']!r} x{e['count']} — fixed? remove it",
        )
    n = len(report.violations)
    print(
        f"photon-lint: {n} violation(s), {report.baselined} baselined, "
        f"{len(report.files)} file(s) checked"
    )
    return exit_code


if __name__ == "__main__":  # pragma: no cover - exercised via __main__
    sys.exit(main())
