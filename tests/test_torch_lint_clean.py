"""Tier-1 gate: the port is clean under its own analyzer, and under the
reference's for every rule both have.

A new raw ``.cpu()`` / ``.item()`` of a tensor, a torn artifact write or
an undeclared id-keyed memo anywhere in ``photon_ml_tpu_torch/`` fails
here unless it is allowed in place (with its reason) or listed in the
port's baseline (``.photon-lint-torch-baseline.json``). Each analyzer
runs once for the module: the reference's pass over the port takes about
15 s.
"""

import json
import os
import subprocess
import sys

import pytest

from photon_ml_tpu.lint import analyze_paths as ref_analyze
from photon_ml_tpu.lint import apply_baseline as ref_apply_baseline
from photon_ml_tpu.lint import load_baseline as ref_load_baseline
from photon_ml_tpu_torch.lint import (
    Report,
    analyze_paths,
    apply_baseline,
    load_baseline,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, ".photon-lint-torch-baseline.json")
TARGETS = ["photon_ml_tpu_torch"]
SHARED = {"PL001", "PL004", "PL005", "PL006", "PL007", "PL008", "PL009", "PL010",
          "PL015", "PL016", "PL017", "PL018"}


def _in_repo(fn, *args):
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        return fn(*args)
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def port_report():
    return _in_repo(analyze_paths, TARGETS)


@pytest.fixture(scope="module")
def ref_report():
    return _in_repo(ref_analyze, TARGETS)


def _fmt(violations):
    return "\n".join(f"{v.location()}: {v.rule} {v.message}" for v in violations)


def _copy(report):
    return Report(files=report.files, violations=list(report.violations),
                  allow_sites=report.allow_sites)


def test_port_is_clean_under_its_analyzer(port_report):
    assert not port_report.errors, port_report.errors
    report = _copy(port_report)
    apply_baseline(report, load_baseline(BASELINE))
    assert report.violations == [], (
        "non-baselined photon-lint violations:\n" + _fmt(report.violations))


def test_baseline_has_no_stale_entries(port_report):
    report = _copy(port_report)
    apply_baseline(report, load_baseline(BASELINE))
    assert report.unused_baseline == [], report.unused_baseline


def test_every_baseline_entry_is_load_bearing(port_report):
    """Removing any one entry resurfaces a violation."""
    entries = json.load(open(BASELINE))["entries"]
    assert entries
    full = load_baseline(BASELINE)
    for e in entries:
        allow = full.copy()
        key = (e["file"], e["rule"], e["snippet"])
        allow[key] -= 1
        report = _copy(port_report)
        apply_baseline(report, allow)
        assert report.violations, f"baseline entry {key} allows nothing"


def test_baseline_holds_only_what_may_be_grandfathered():
    entries = json.load(open(BASELINE))["entries"]
    assert {e["rule"] for e in entries} <= {"PL001", "PL006"}


def test_reference_analyzer_finds_nothing_unbaselined_of_a_shared_rule(ref_report):
    """The reference's analyzer over the port, with the port's baseline:
    no finding of a rule both analyzers have (its jax-only rules read no
    jax in the port; PL011's axis literals included)."""
    assert not ref_report.errors
    report = _copy(ref_report)
    ref_apply_baseline(report, ref_load_baseline(BASELINE))
    assert [v for v in report.violations if v.rule in SHARED | {"PL011"}] == [], _fmt(
        report.violations)


def test_cli_exits_0_over_the_port():
    r = subprocess.run([sys.executable, "-m", "photon_ml_tpu_torch.lint"],
                       capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 violation(s)" in r.stdout
