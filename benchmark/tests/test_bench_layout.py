"""The harness finds every cell, configuration, traffic mix, limit file and
per-layer metric by name from files alone, and ``BENCHMARK.json`` keeps
the benchmark's contract."""

import json
import os
import re
import shutil

import pytest

import harness

SPEC = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.find_cell(cell)
    assert c.config["generator"] and c.config["reference"]
    harness.module("generators", c.config["generator"])
    harness.module("reference", c.config["reference"])
    loop = harness.module("loops", c.traffic["loop"])
    for fn in ("setup", "step", "window_closed", "outputs", "judge"):
        assert callable(getattr(loop, fn))
    assert c.limits and all(v > 0 for v in c.limits.values())
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and c.traffic["unit_metric"] in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.module("metrics", metric).read)


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    names = [x["name"] for x in SPEC["configs"] + SPEC["workloads"]
             + SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "workloads" in m
        for cell in m["workloads"]:
            assert harness.applies(e2e[m["moves"]], cell)
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.isfile(
            os.path.join(harness.ROOT, c["file"]))
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_cell_added_by_files_alone(tmp_path):
    """A later cell is an entry and data files: no file already there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "criteo1tb_logistic.few_lambdas", "config": "criteo1tb_logistic",
                              "traffic": "few_lambdas", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = harness.load_json(os.path.join(harness.BENCH_DIR, "traffic", "grid_batched.json"))
    traffic["lambdas"] = [1.0, 0.1]
    (root / "benchmark" / "traffic" / "few_lambdas.json").write_text(json.dumps(traffic))
    (root / "benchmark" / "limits" / "criteo1tb_logistic.few_lambdas.json").write_text(
        json.dumps({"grad_rel": 1.0, "value_gap": 1.0}))
    cell = harness.find_cell("criteo1tb_logistic.few_lambdas", root=str(root))
    assert cell.traffic["lambdas"] == [1.0, 0.1] and cell.config["rows"] == 1 << 22
    assert {m["name"] for m in cell.end_to_end} == {"setup_s"}  # lists name their cells


def test_unknown_cell_is_refused():
    with pytest.raises(harness.BenchmarkError):
        harness.find_cell("no_such.cell")
    with pytest.raises(harness.BenchmarkError):
        harness.module("metrics", "no_such_metric")
