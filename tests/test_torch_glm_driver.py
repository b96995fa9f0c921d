"""The port's GLM driver (``photon_ml_tpu_torch.cli.glm_driver``) against
the JAX package's on the same seeded fixtures: Avro in the pattern of
``tests/test_glm_driver.py`` and LibSVM, the λ-grid [10, 1, 0.1],
sequential and batched grids, the scatter kernel and small tiled cases,
STANDARDIZATION, variances and box constraints (one bound on an Avro
feature and one on a LibSVM feature).

Both drivers get the same argv (the reference with ``--distributed off``,
the port also with ``--device cpu``) and must give the same stage history,
feature index (byte-identical ``index.json``) and best λ; coefficients and
variances within rtol 1e-4 of their largest magnitude (PR 1's fit
tolerance); validation metrics within 1e-5; the same iteration counts and
stop reasons in ``optimization-log.txt``; the same ``metrics.json`` keys;
the same feature summary (``--summarization-output-dir``) within rtol
1e-6.
The fits run at a convergence tolerance of 1e-4: at the default 1e-7
(and still at 1e-5, at the flat end of the warm-started path) the
function-change test compares differences of a few f32 ulps, a line
search can branch the other way in one package, and the two part on
rounding.

Also: the parser takes exactly the reference's option strings (and
``--device``), each option of a path not ported yet raises naming its
ROADMAP item, the output-directory guard, and the card as the default
device. And per-iteration validation, diagnostics with their report and
the off-heap index map: both drivers over one store built by the port's
feature-indexing driver.
"""

import json
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import glm_driver as ref_driver
from photon_ml_tpu.io.avro_codec import read_container
from photon_ml_tpu_torch.cli import glm_driver
from photon_ml_tpu_torch.io.model_io import load_glm_models_avro
from photon_ml_tpu_torch.utils.index_map import IndexMap

from tests.test_glm_driver import synth_avro
from tests.torch_parity import assert_close_to_scale


def synth_libsvm(path, rng, n, d=8):
    """Planted logistic rows as LibSVM lines, labels in {-1, +1}."""
    w = np.linspace(-1, 1, d)
    lines = []
    for _ in range(n):
        ix = np.sort(rng.choice(d, size=4, replace=False))
        vs = rng.normal(size=4)
        z = float(np.sum(w[ix] * vs))
        label = "+1" if 1 / (1 + np.exp(-z)) > rng.uniform() else "-1"
        lines.append(label + "".join(f" {i + 1}:{v:.9g}" for i, v in zip(ix, vs)))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("driver_data")
    rng = np.random.default_rng(42)
    dirs = {}
    for kind, write, ext in (("avro", synth_avro, "avro"), ("libsvm", synth_libsvm, "txt")):
        for split, n in (("train", 200), ("val", 80)):
            d = root / kind / split
            d.mkdir(parents=True)
            write(str(d / f"part-0.{ext}"), rng, n=n)
        dirs[kind] = (str(root / kind / "train"), str(root / kind / "val"))
    return dirs


GRID = ["--regularization-weights", "10,1,0.1", "--convergence-tolerance", "1e-4"]
BOX = json.dumps([{"name": "4", "term": "", "lowerBound": -0.05, "upperBound": 0.05}])
AVRO_BOX = json.dumps([{"name": "f4", "term": "", "lowerBound": -0.05, "upperBound": 0.05}])
CASES = {
    "avro_sequential_box": ("avro", GRID + [
        "--grid-mode", "sequential", "--compute-variances", "true",
        "--coefficient-box-constraints", AVRO_BOX]),
    "avro_batched_tiled_box": ("avro", GRID + [
        "--grid-mode", "batched", "--kernel", "tiled",
        "--coefficient-box-constraints", AVRO_BOX]),
    "avro_sequential_variances": ("avro", GRID + [
        "--grid-mode", "sequential", "--compute-variances", "true"]),
    "avro_batched_standardized": ("avro", GRID + [
        "--grid-mode", "batched", "--normalization-type", "STANDARDIZATION",
        "--compute-variances", "true"]),
    "libsvm_sequential_box": ("libsvm", GRID + [
        "--input-file-format", "LIBSVM", "--grid-mode", "sequential",
        "--coefficient-box-constraints", BOX]),
    "libsvm_batched_dimension": ("libsvm", GRID + [
        "--input-file-format", "LIBSVM", "--feature-dimension", "8",
        "--grid-mode", "batched", "--compute-variances", "true"]),
    "avro_tiled_variances": ("avro", GRID + [
        "--grid-mode", "sequential", "--kernel", "tiled", "--num-iterations", "4",
        "--compute-variances", "true"]),
}


def _run_both(tmp_path, fixtures, case):
    kind, extra = CASES[case]
    train, val = fixtures[kind]
    argv = ["--training-data-directory", train, "--validating-data-directory", val] + extra
    ref = ref_driver.GLMDriver(ref_driver.params_from_args(
        argv + ["--output-directory", str(tmp_path / "ref"), "--distributed", "off",
                "--summarization-output-dir", str(tmp_path / "ref_summary")]))
    ref.run()
    port = glm_driver.main(
        argv + ["--output-directory", str(tmp_path / "port"), "--device", "cpu",
                "--summarization-output-dir", str(tmp_path / "port_summary")])
    return ref, port


def _summary(path):
    _, records = read_container(str(path / "part-00000.avro"))
    return {(r["featureName"], r["featureTerm"]): r["metrics"] for r in records}


def _log_headers(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return [ln for ln in lines if ln.startswith("lambda=")], len(lines)


@pytest.mark.parametrize("case", sorted(CASES))
def test_driver_matches_reference(tmp_path, fixtures, case):
    ref, port = _run_both(tmp_path, fixtures, case)
    out, ref_out = tmp_path / "port", tmp_path / "ref"
    assert [s.name for s in port.stage_history] == [s.name for s in ref.stage_history]
    assert (out / "feature-index" / "index.json").read_bytes() == \
        (ref_out / "feature-index" / "index.json").read_bytes()
    assert port.best_lambda == ref.best_lambda
    assert sorted(port.models) == sorted(ref.models) == [0.1, 1.0, 10.0]
    for lam, ref_model in ref.models.items():
        got = port.models[lam].coefficients
        want = ref_model.coefficients
        assert_close_to_scale(got.means, np.asarray(want.means), rtol=1e-4)
        assert (got.variances is None) == (want.variances is None)
        if want.variances is not None:
            assert_close_to_scale(got.variances, np.asarray(want.variances), rtol=1e-4)
        metrics, ref_metrics = port.validation_metrics[lam], ref.validation_metrics[lam]
        assert sorted(metrics) == sorted(ref_metrics)
        for name, value in ref_metrics.items():
            assert abs(metrics[name] - value) <= 1e-5, (lam, name)
    assert _log_headers(out / "optimization-log.txt") == \
        _log_headers(ref_out / "optimization-log.txt")
    payload = json.loads((out / "metrics.json").read_text())
    ref_payload = json.loads((ref_out / "metrics.json").read_text())
    assert sorted(payload) == sorted(ref_payload)
    assert sorted(payload["timers"]) == sorted(ref_payload["timers"])
    assert payload["best_lambda"] == ref_payload["best_lambda"]
    assert sorted(os.listdir(out / "models-text")) == sorted(os.listdir(ref_out / "models-text"))
    # the feature summary: the same features and statistics (f32 sums in
    # another order: rtol 1e-6)
    summary, ref_summary = _summary(tmp_path / "port_summary"), _summary(tmp_path / "ref_summary")
    assert sorted(summary) == sorted(ref_summary)
    for key, metrics in ref_summary.items():
        assert sorted(summary[key]) == sorted(metrics)
        for name, value in metrics.items():
            assert summary[key][name] == pytest.approx(value, rel=1e-6, abs=1e-6), (key, name)
    # the written models read back to the trained ones
    imap = IndexMap.load(str(out / "feature-index" / "index.json"))
    loaded = load_glm_models_avro(str(out / "models" / "models.avro"), imap, device="cpu")
    for lam, model in port.models.items():
        torch.testing.assert_close(loaded[str(lam)].means, model.means, rtol=0, atol=0)


def _options(parser):
    return {s for action in parser._actions for s in action.option_strings}


def test_parser_takes_the_reference_options():
    assert _options(glm_driver.build_arg_parser()) == \
        _options(ref_driver.build_arg_parser()) | {"--device"}


UNPORTED = [
    (["--streaming", "true"], None),
    (["--stream-memory-budget", "1024"], "requires --streaming true"),
    (["--scan-cache-dir", "/c"], "requires --streaming true"),
    (["--distributed", "feature"], None),
    (["--model-shards", "2"], None),
    (["--coordinator-address", "localhost:1234"], "--num-processes"),
    (["--checkpoint-dir", "ck"], None),
    (["--fault-plan", "chunk_read:1:EIO"], None),
    (["--retrain-from", "reg"], None),
    (["--publish-registry", "reg", "--regularization-weights", "1"], None),
    (["--gate-max-auc-drop", "0.1"], None),
    (["--retrain-from", "/r", "--publish-registry", "/r"], "requires a validating"),
    (["--obs-dir", "obs"], None),
    (["--profile-dir", "prof"], None),
]


@pytest.mark.parametrize("extra,item", UNPORTED, ids=[u[0][0] for u in UNPORTED])
def test_unported_options_raise_naming_their_item(tmp_path, fixtures, extra, item):
    """An option of a path not ported yet raises naming its item; one whose
    item is ported (None) runs: ``--checkpoint-dir`` snapshots every λ,
    ``--fault-plan`` shows in the reliability block, ``--streaming true``
    writes the streaming block, ``--obs-dir`` the trace, flight and
    snapshot files, ``--profile-dir`` a profiler trace, the registry
    options their metrics block (a retrain from an empty registry is a
    cold start, a publish makes generation 1); one whose item is ported
    but that needs another option raises the reference's ValueError."""
    if item is None:
        from photon_ml_tpu_torch.reliability import install_plan

        extra = [str(tmp_path / a) if a in ("ck", "obs", "prof", "reg") else a for a in extra]
        argv = ["--training-data-directory", fixtures["avro"][0], "--output-directory",
                str(tmp_path / "out"), "--regularization-weights", "10,1",
                "--grid-mode", "sequential", "--device", "cpu"] + extra
        try:
            glm_driver.main(argv)
        finally:
            install_plan(None)
        metrics = json.load(open(tmp_path / "out" / "metrics.json"))
        if extra[0] == "--streaming":
            assert metrics["streaming"]["decode_passes"] == 1
            assert sorted(metrics["timers"]) == ["preprocess", "train"]
        elif extra[0] == "--checkpoint-dir":
            names = sorted(os.listdir(tmp_path / "ck"))
            assert "manifest.json" in names
            assert len([n for n in names if n.startswith("lambda-") and n.endswith(".json")]) == 2
        elif extra[0] == "--obs-dir":
            assert sorted(os.listdir(tmp_path / "obs")) == [
                "flight.json", "metrics_snapshot.json", "trace.json"
            ]
        elif extra[0] == "--profile-dir":
            assert [n for n in os.listdir(tmp_path / "prof") if n.endswith(".pt.trace.json")]
        elif extra[0] == "--retrain-from":
            assert metrics["registry"]["parent_generation"] is None
            assert metrics["registry"]["drift"] is None
        elif extra[0] == "--publish-registry":
            assert metrics["registry"]["published_generation"] == 1
            assert metrics["registry"]["gates"] is None
        elif extra[0] == "--gate-max-auc-drop":
            assert "registry" not in metrics
        elif extra[0] in ("--distributed", "--model-shards"):
            # one process: no mesh to shard over, the fit of one card
            assert "train" in metrics["timers"] and os.path.exists(tmp_path / "out" / "models")
        else:
            assert metrics["reliability"]["faults"]["plan"] == extra[1]
        return
    argv = ["--training-data-directory", "t", "--output-directory",
            str(tmp_path / "out"), "--device", "cpu"] + extra
    if item.startswith("item "):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            glm_driver.main(argv)
    else:
        with pytest.raises(ValueError, match=item):
            glm_driver.main(argv)
    assert not (tmp_path / "out").exists()


SLICE_OPTIONS = [
    (["--diagnostic-mode", "ALL"], {"diagnostic_mode": glm_driver.DiagnosticMode.ALL}),
    (["--training-diagnostics", "true"], {"diagnostic_mode": glm_driver.DiagnosticMode.ALL}),
    (["--offheap-indexmap-dir", "/i", "--offheap-indexmap-num-partitions", "3"],
     {"offheap_indexmap_dir": "/i", "offheap_indexmap_num_partitions": 3}),
    (["--validate-per-iteration", "true", "--validating-data-directory", "v"],
     {"validate_per_iteration": True, "validate_dir": "v"}),
]


@pytest.mark.parametrize("extra,fields", SLICE_OPTIONS, ids=[o[0][0] for o in SLICE_OPTIONS])
def test_options_of_the_driver_slice_are_accepted(extra, fields):
    """Per-iteration validation, diagnostics and the off-heap index map
    parse as the reference's and pass validation."""
    argv = ["--training-data-directory", "t", "--output-directory", "o", "--device", "cpu"]
    p = glm_driver.params_from_args(argv + extra)
    ref = ref_driver.params_from_args(argv[:-2] + extra)
    p.validate()
    assert not p.unported()
    for name, value in fields.items():
        assert getattr(p, name) == value
        assert str(getattr(ref, name)) == str(value)


def test_validate_per_iteration_needs_a_validating_dir(tmp_path):
    with pytest.raises(ValueError, match="validating data directory"):
        glm_driver.main(["--training-data-directory", "t", "--output-directory",
                         str(tmp_path / "o"), "--validate-per-iteration", "true",
                         "--device", "cpu"])


def test_accepted_options_parse(tmp_path):
    """The Spark-only knobs and --no-overlap are accepted."""
    p = glm_driver.params_from_args([
        "--training-data-directory", "t", "--output-directory", "o", "--kryo", "true",
        "--min-partitions", "4", "--tree-aggregate-depth", "2", "--no-overlap", "true",
        "--format", "LIBSVM", "--training-diagnostics", "false", "--device", "cpu",
    ])
    p.validate()
    assert p.no_overlap and p.input_format == "LIBSVM" and p.device == "cpu"


def test_output_dir_guard(tmp_path, fixtures):
    train, _ = fixtures["avro"]
    out = tmp_path / "out"
    out.mkdir()
    (out / "stale").write_text("x")
    argv = ["--training-data-directory", train, "--output-directory", str(out),
            "--regularization-weights", "1", "--device", "cpu"]
    with pytest.raises(ValueError, match="non-empty"):
        glm_driver.main(argv)
    driver = glm_driver.main(argv + ["--delete-output-dirs-if-exist", "true"])
    assert not (out / "stale").exists()
    assert (out / "metrics.json").is_file() and driver.best_model is None


def test_the_card_is_the_default_device(tmp_path, fixtures, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train, _ = fixtures["avro"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        glm_driver.main(["--training-data-directory", train,
                         "--output-directory", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


class Recorder:
    """An event listener named on the command line (``--event-listeners``)."""

    events = []

    def on_event(self, event):
        Recorder.events.append(event)

    def close(self):
        Recorder.events.append("closed")


def test_event_listeners_see_the_training_events(tmp_path, fixtures):
    train, _ = fixtures["libsvm"]
    Recorder.events = []
    glm_driver.main([
        "--training-data-directory", train, "--output-directory", str(tmp_path / "out"),
        "--input-file-format", "LIBSVM", "--regularization-weights", "1,0.1",
        "--kernel", "tiled", "--tile-cache-dir", str(tmp_path / "cache"),
        "--event-listeners", f"{__name__}.Recorder", "--device", "cpu",
    ])
    names = [e if isinstance(e, str) else type(e).__name__ for e in Recorder.events]
    assert names == [
        "TrainingStartEvent", "PhotonOptimizationLogEvent", "PhotonOptimizationLogEvent",
        "ScheduleCacheEvent", "TrainingFinishEvent", "closed",
    ]
    assert [e.reg_weight for e in Recorder.events[1:3]] == [1.0, 0.1]
    assert Recorder.events[3].stats["stores"] >= 2


# -- per-iteration validation, diagnostics and the off-heap index map --------


def _numbers_match(text, ref_text):
    """The two reports line for line: the same words, and each number within
    1e-4 relative or half a unit of its last printed digit (the reports
    print with %.3g-%.5g, so a value within 1e-5 can print one digit off)."""
    import re

    num = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
    lines, ref_lines = text.splitlines()[2:], ref_text.splitlines()[2:]  # past the title
    assert len(lines) == len(ref_lines)
    count = 0
    for line, ref_line in zip(lines, ref_lines):
        assert num.sub("#", line).replace(" ", "") == num.sub("#", ref_line).replace(" ", ""), \
            (line, ref_line)
        for a, b in zip(num.findall(line), num.findall(ref_line)):
            mant = b.split("e")[0]
            digits = len(mant.split(".")[1]) if "." in mant else 0
            exp = int(b.split("e")[1]) if "e" in b else 0
            unit = 10.0 ** (exp - digits)
            assert abs(float(a) - float(b)) <= max(1e-4 * abs(float(b)), unit), (line, ref_line)
            assert np.isfinite(float(a))
            count += 1
    return count


@pytest.mark.parametrize("kind", ["avro", "libsvm"])
def test_driver_slice_matches_reference(tmp_path, fixtures, kind):
    """Both drivers with --validate-per-iteration true --diagnostic-mode ALL
    --offheap-indexmap-dir over one store that the port's feature-indexing
    driver built: per-iteration metrics within 1e-5 (the validation
    metrics' tolerance), the same stages and report, the pointer written
    as the feature index."""
    from photon_ml_tpu_torch.cli import feature_indexing_driver

    train, val = fixtures[kind]
    fmt = "AVRO" if kind == "avro" else "LIBSVM"
    store = feature_indexing_driver.run_feature_indexing(
        [train], str(tmp_path / "store"), data_format=fmt, num_partitions=2)
    argv = [
        "--training-data-directory", train, "--validating-data-directory", val,
        "--input-file-format", fmt, "--validate-per-iteration", "true",
        "--diagnostic-mode", "ALL", "--offheap-indexmap-dir", store,
        "--offheap-indexmap-num-partitions", "2",
    ] + GRID
    ref = ref_driver.GLMDriver(ref_driver.params_from_args(
        argv + ["--output-directory", str(tmp_path / "ref"), "--distributed", "off"]))
    ref.run()
    port = glm_driver.main(argv + ["--output-directory", str(tmp_path / "port"),
                                   "--device", "cpu"])
    out, ref_out = tmp_path / "port", tmp_path / "ref"
    assert [s.name for s in port.stage_history] == [s.name for s in ref.stage_history] == [
        "PREPROCESSED", "TRAINED", "VALIDATED", "DIAGNOSED"]
    assert port.best_lambda == ref.best_lambda
    assert sorted(port.per_iteration_metrics) == sorted(ref.per_iteration_metrics)
    for lam, ref_iters in ref.per_iteration_metrics.items():
        iters = port.per_iteration_metrics[lam]
        assert len(iters) == len(ref_iters) == int(port.results[lam].iterations) + 1
        for metrics, ref_metrics in zip(iters, ref_iters):
            assert sorted(metrics) == sorted(ref_metrics)
            for name, value in ref_metrics.items():
                assert abs(metrics[name] - value) <= 1e-5, (lam, name)
        # the last iterate is the final model
        for name, value in port.validation_metrics[lam].items():
            assert iters[-1][name] == pytest.approx(value, abs=1e-6)
        assert_close_to_scale(port.models[lam].means, np.asarray(ref.models[lam].means),
                              rtol=1e-4)
    payload = json.loads((out / "metrics.json").read_text())
    ref_payload = json.loads((ref_out / "metrics.json").read_text())
    assert sorted(payload["per_iteration_validation"]) == \
        sorted(ref_payload["per_iteration_validation"])
    assert "diagnose" in payload["timers"] and "diagnose" in ref_payload["timers"]
    assert _numbers_match((out / "model-diagnostics" / "report.txt").read_text(),
                          (ref_out / "model-diagnostics" / "report.txt").read_text()) > 50
    html = (out / "model-diagnostics" / "report.html").read_text()
    for title in ("Bootstrap analysis", "Fitting analysis", "Hosmer-Lemeshow calibration",
                  "Feature importance", "Prediction-error independence (Kendall tau)"):
        assert title in html
    # the feature index is the store's pointer, read back by either package
    pointer = json.loads((out / "feature-index" / "index.json").read_text())
    assert pointer["num_partitions"] == 2
    imap = IndexMap.load(str(out / "feature-index" / "index.json"))
    assert dict(imap.items()) == dict(port._data.index_map.items())
