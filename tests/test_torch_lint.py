"""The port's analyzer (``photon_ml_tpu_torch/lint/``) against the
reference's (``photon_ml_tpu/lint/``).

- Every rule both have gives the same (rule, file, line) findings over the
  reference's read-only fixtures (``tests/lint_fixtures/``), and PL001's
  allow-site audit the same audit findings.
- Both CLIs give the same exit codes, JSON keys and baseline round trip
  on the same inputs.
- The torch PL001 and its seam audit over their own fixtures
  (``tests/torch_lint_fixtures/``).
"""

import json
import os
import subprocess
import sys

import pytest

from photon_ml_tpu.lint import analyze_paths as ref_analyze
from photon_ml_tpu_torch.lint import (
    BaselineRefused,
    all_rules,
    analyze_paths,
    analyze_source,
    apply_baseline,
    load_baseline,
    write_baseline,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join("tests", "lint_fixtures")
TORCH_FIXTURES = os.path.join("tests", "torch_lint_fixtures")
# the rules both analyzers have (PL001 is the port's own: its taint is
# torch's, so only its allow-site audit is compared)
SHARED = ("PL004", "PL005", "PL006", "PL007", "PL008", "PL009", "PL010",
          "PL015", "PL016", "PL017", "PL018")
AUDIT = "allow(hidden-host-sync) site is unaccounted"


def _in_repo(fn, *args, **kw):
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        return fn(*args, **kw)
    finally:
        os.chdir(cwd)


def _findings(report, rules):
    return {(v.rule, v.path, v.line) for v in report.violations if v.rule in rules}


@pytest.fixture(scope="module")
def fixture_reports():
    """Both analyzers over the whole fixture tree, and over each PL018
    fixture tree on its own (the wire inventory is per analyzed set)."""
    out = {}
    for target in (FIXTURES, os.path.join(FIXTURES, "pl018_pos"),
                   os.path.join(FIXTURES, "pl018_neg")):
        out[target] = (_in_repo(analyze_paths, [target]), _in_repo(ref_analyze, [target]))
    return out


@pytest.mark.parametrize("rule", SHARED)
def test_rule_matches_the_reference_on_its_fixtures(fixture_reports, rule):
    port, ref = fixture_reports[FIXTURES]
    assert not port.errors and not ref.errors
    assert _findings(port, {rule}) == _findings(ref, {rule})


@pytest.mark.parametrize("tree", ["pl018_pos", "pl018_neg"])
def test_wire_contract_matches_the_reference(fixture_reports, tree):
    port, ref = fixture_reports[os.path.join(FIXTURES, tree)]
    assert _findings(port, {"PL018"}) == _findings(ref, {"PL018"})
    assert bool(_findings(port, {"PL018"})) == (tree == "pl018_pos")


def test_fixtures_exercise_the_shared_rules(fixture_reports):
    """The comparison compares something: every shared rule but PL018
    fires on the whole tree, PL018 on its positive tree."""
    port, _ = fixture_reports[FIXTURES]
    fired = {v.rule for v in port.violations}
    assert set(SHARED) - {"PL018"} <= fired


def test_seam_audit_matches_the_reference(fixture_reports):
    port, ref = fixture_reports[FIXTURES]
    audit = {(v.path, v.line) for v in port.violations if AUDIT in v.message}
    assert audit == {(v.path, v.line) for v in ref.violations if AUDIT in v.message}
    assert audit, "the reference's audit fixture has an unaccounted site"
    seam = {(s.path, s.applies_to, s.seam_ok) for s in port.allow_sites if s.seam_ok is not None}
    assert seam == {(s.path, s.applies_to, s.seam_ok) for s in ref.allow_sites
                    if s.seam_ok is not None}


def test_rule_table():
    rules = all_rules()
    assert sorted(rules) == ["PL001", *SHARED]
    assert rules["PL001"].slug == "hidden-host-sync"


# ---------------------------------------------------------------------------
# PL001 for torch
# ---------------------------------------------------------------------------


def _torch(rel):
    report = _in_repo(analyze_paths, [os.path.join(TORCH_FIXTURES, rel)])
    assert not report.errors, report.errors
    return report


def test_pl001_positive():
    vs = _torch("pl001_pos.py").violations
    assert [v.rule for v in vs] == ["PL001"] * 7  # one a seeded sync
    assert [v.line for v in vs] == [9, 13, 18, 23, 27, 31, 36]


def test_pl001_negative():
    assert _torch("pl001_neg.py").violations == []


def test_pl001_audit_positive():
    vs = _torch(os.path.join("photon_ml_tpu_torch", "audit_pos.py")).violations
    assert [(v.rule, v.line) for v in vs] == [("PL001", 7)]
    assert AUDIT in vs[0].message


def test_pl001_audit_negative():
    report = _torch(os.path.join("photon_ml_tpu_torch", "audit_neg.py"))
    assert report.violations == []
    assert [s.seam_ok for s in report.allow_sites] == [True, True]


def test_pl001_allow_suppresses_and_is_audited_only_in_the_package():
    src = "def f(t):\n    return t.cpu()  # photon: allow(hidden-host-sync)\n"
    assert analyze_source("tools/x.py", src).violations == []
    vs = analyze_source("photon_ml_tpu_torch/x.py", src).violations
    assert [(v.rule, v.line) for v in vs] == [("PL001", 2)]
    assert AUDIT in vs[0].message


def test_pl001_taint_ends_at_the_host():
    src = (
        "import torch\n"
        "def f(n):\n"
        "    x = torch.ones(n)\n"
        "    h = x.cpu()\n"  # 4: the sync
        "    a = h.numpy()\n"  # a CPU tensor: not a second sync
        "    return a.tolist(), int(x.numel())\n"
    )
    vs = analyze_source("m.py", src).violations
    assert [(v.rule, v.line) for v in vs] == [("PL001", 4)]


# ---------------------------------------------------------------------------
# the CLIs side by side
# ---------------------------------------------------------------------------


def _cli(package, *args):
    return subprocess.run([sys.executable, "-m", f"{package}.lint", *args],
                          capture_output=True, text=True, cwd=REPO)


BOTH = ("photon_ml_tpu", "photon_ml_tpu_torch")


@pytest.mark.parametrize("case,want", [
    ("pl006_neg.py", 0), ("pl006_pos.py", 1), ("pl009_pos.py", 1), ("pl017_pos.py", 1),
])
def test_clis_agree_on_exit_codes(case, want):
    target = os.path.join(FIXTURES, case)
    assert [_cli(p, target, "--no-baseline").returncode for p in BOTH] == [want, want]


def test_clis_agree_on_a_file_that_does_not_parse(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f(:\n")
    assert [_cli(p, str(bad), "--no-baseline").returncode for p in BOTH] == [2, 2]


def test_clis_agree_on_json_keys_and_findings():
    target = os.path.join(FIXTURES, "pl008_pos.py")
    outs = [_cli(p, target, "--no-baseline", "--json") for p in BOTH]
    assert [o.returncode for o in outs] == [1, 1]
    ref, port = (json.loads(o.stdout) for o in outs)
    assert sorted(port) == sorted(ref)
    assert port["violations"] == ref["violations"]
    assert port["exit_code"] == ref["exit_code"] == 1
    assert sorted(port["violations"][0]) == sorted(ref["violations"][0])


def test_clis_agree_on_the_baseline_round_trip(tmp_path):
    """--write-baseline then --baseline: exit 0 in both, the same file."""
    target = os.path.join(FIXTURES, "pl006_pos.py")
    files = []
    for p in BOTH:
        path = str(tmp_path / f"{p}.json")
        w = _cli(p, target, "--write-baseline", "--baseline", path)
        assert w.returncode == 0, w.stderr
        r = _cli(p, target, "--baseline", path)
        assert r.returncode == 0, r.stdout
        with open(path) as f:
            files.append(json.load(f))
    assert files[0] == files[1]


@pytest.mark.parametrize("case", ["pl009_pos.py", "pl016_pos.py"])
def test_clis_refuse_to_baseline_the_same_rules(tmp_path, case):
    target = os.path.join(FIXTURES, case)
    codes = [_cli(p, target, "--write-baseline", "--baseline", str(tmp_path / f"{p}.json"))
             .returncode for p in BOTH]
    assert codes == [2, 2]


def test_cli_list_rules_and_the_spmd_flags():
    r = _cli("photon_ml_tpu_torch", "--list-rules")
    assert r.returncode == 0
    for rid in ("PL001", *SHARED):
        assert rid in r.stdout
    assert "PL002" not in r.stdout and "PL011" not in r.stdout
    target = os.path.join(FIXTURES, "pl006_neg.py")
    assert _cli("photon_ml_tpu_torch", target, "--no-spmd").returncode == 0
    assert _cli("photon_ml_tpu_torch", target, "--check-sharding-md").returncode == 2


def test_baseline_api_round_trip(tmp_path):
    report = _in_repo(analyze_paths, [os.path.join(FIXTURES, "pl006_pos.py")])
    path = str(tmp_path / "b.json")
    write_baseline(path, report.violations)
    fresh = _in_repo(analyze_paths, [os.path.join(FIXTURES, "pl006_pos.py")])
    apply_baseline(fresh, load_baseline(path))
    assert fresh.violations == [] and fresh.baselined == 4
    pl009 = _in_repo(analyze_paths, [os.path.join(FIXTURES, "pl009_pos.py")])
    with pytest.raises(BaselineRefused):
        write_baseline(str(tmp_path / "c.json"), pl009.violations)
