"""The port's out-of-core GLM path (``io/streaming.py``, the streaming
protocol of ``io/input_format.py``, the host optimizers, streamed
evaluation, the scan cache, ``train_streaming_glm`` and the GLM driver's
``--streaming``) against the JAX package on the same seeded files.

Tolerances: the streamed objective against the in-memory one, value 1e-5
relative and gradient 1e-4 of its scale (float32 sums in another order);
the host optimizers and the streamed fits against the reference's host
optimizers in float64 to 1e-9 with the same iterations (the reference's
streamed trainer itself casts to float32, ``jnp.asarray(w0, float32)``
in its host optimizers, so it is held in float32 to 5e-4); summaries to
float64 rounding (float32 results of float64 moments: 1e-6 relative);
streamed AUC to 1e-3 of the exact AUC, RMSE and losses to 1e-12.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from photon_ml_tpu.io.input_format import (
    AvroInputDataFormat as RefAvro,
    LibSVMInputDataFormat as RefLibSVM,
)
from photon_ml_tpu.io import streaming as ref_streaming
from photon_ml_tpu.ops.objective import GLMObjective as RefGLMObjective
from photon_ml_tpu.ops.losses import LOGISTIC as REF_LOGISTIC
from photon_ml_tpu.optim import host_lbfgs as ref_host_lbfgs
from photon_ml_tpu.optim import host_tron as ref_host_tron
from photon_ml_tpu.optim.config import (
    OptimizerType as RefOpt,
    RegularizationType as RefReg,
)
from photon_ml_tpu.parallel import overlap as ref_overlap
from photon_ml_tpu.registry import stats_cache as ref_stats_cache
from photon_ml_tpu.task import TaskType as RefTask
from photon_ml_tpu.training import train_streaming_glm as ref_train_streaming
from photon_ml_tpu_torch.cli import glm_driver
from photon_ml_tpu_torch.evaluation.metrics import (
    area_under_roc_curve,
    mean_pointwise_loss,
    root_mean_squared_error,
)
from photon_ml_tpu_torch.evaluation.streaming import (
    StreamingAUC,
    StreamingMeanLoss,
    StreamingRMSE,
)
from photon_ml_tpu_torch.io import schemas, streaming
from photon_ml_tpu_torch.io.avro_codec import write_container
from photon_ml_tpu_torch.io.input_format import AvroInputDataFormat, LibSVMInputDataFormat
from photon_ml_tpu_torch.io.streaming import (
    StreamingGLMObjective,
    iter_chunks,
    scan_stream,
    scan_stream_with_summary,
    streaming_summary,
)
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.optim.config import OptimizerType, RegularizationType
from photon_ml_tpu_torch.optim.host_lbfgs import minimize_lbfgs_host, minimize_owlqn_host
from photon_ml_tpu_torch.optim.host_tron import minimize_tron_host
from photon_ml_tpu_torch.parallel import overlap
from photon_ml_tpu_torch.registry import stats_cache
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.training import train_generalized_linear_model, train_streaming_glm
from torch_parity import assert_close_to_scale, to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGISTIC = TaskType.LOGISTIC_REGRESSION
D = 25


def _write_files(root, seed, n_files=3, rows_per_file=80, d=D, k=4, weights=False):
    """Seeded logistic TrainingExampleAvro part files (a zero value and,
    with ``weights``, weight-0 rows among them)."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    w_true = rng.normal(size=d)
    for fi in range(n_files):
        recs = []
        for i in range(rows_per_file):
            ix = rng.choice(d, size=k, replace=False)
            vs = rng.normal(size=k)
            if i == 3:
                vs[0] = 0.0
            z = float(w_true[ix] @ vs)
            recs.append({
                "uid": f"f{fi}-r{i}",
                "label": float(rng.uniform() < 1 / (1 + np.exp(-z))),
                "features": [
                    {"name": f"x{j}", "term": "", "value": float(v)} for j, v in zip(ix, vs)
                ],
                "offset": float(rng.normal() * 0.1),
                "weight": float(i % 7 != 0) * 1.5 if weights else 1.0,
            })
        write_container(os.path.join(root, f"part-{fi}.avro"), schemas.TRAINING_EXAMPLE_AVRO, recs)
    return str(root)


@pytest.fixture
def files(tmp_path):
    return _write_files(tmp_path / "train", 3)


def _no_native(monkeypatch):
    import photon_ml_tpu.io.native_avro as ref_na
    import photon_ml_tpu_torch.io.native_avro as na

    monkeypatch.setattr(na, "available", lambda: False)
    monkeypatch.setattr(ref_na, "available", lambda: False)


def _same_map(port_map, ref_map):
    assert dict(port_map.items()) == dict(ref_map.items())


# -- the scan and the chunks ---------------------------------------------------


@pytest.mark.parametrize("native", [True, False], ids=["native", "python-codec"])
def test_scan_and_chunks_match_reference(files, monkeypatch, native):
    """Same vocabulary, stats and staged chunks (bitwise) as the JAX
    package, through the native decoder and the Python codec; 240 rows in
    chunks of 100 cover every row once."""
    if not native:
        _no_native(monkeypatch)
    fmt, ref_fmt = AvroInputDataFormat(), RefAvro()
    imap, stats = scan_stream([files], fmt)
    ref_imap, ref_stats = ref_streaming.scan_stream([files], ref_fmt)
    _same_map(imap, ref_imap)
    assert (stats.num_rows, stats.max_nnz) == (ref_stats.num_rows, ref_stats.max_nnz) == (240, 5)
    chunks = list(iter_chunks([files], fmt, imap, rows_per_chunk=100,
                              nnz_width=stats.max_nnz, device="cpu"))
    ref_chunks = list(ref_streaming.iter_chunks([files], ref_fmt, ref_imap,
                                                rows_per_chunk=100, nnz_width=stats.max_nnz))
    assert len(chunks) == len(ref_chunks) == 3
    for c, r in zip(chunks, ref_chunks):
        assert c.indices.shape == (100, stats.max_nnz)
        for a, b in zip((c.indices, c.values, c.labels, c.offsets, c.weights),
                        (r.indices, r.values, r.labels, r.offsets, r.weights)):
            np.testing.assert_array_equal(to_np(a), np.asarray(b))
    assert sum(int((c.weights > 0).sum()) for c in chunks) == 240


def test_libsvm_stream_scan_and_rows(tmp_path):
    rng = np.random.default_rng(4)
    d = tmp_path / "svm"
    d.mkdir()
    for p in range(2):
        lines = []
        for _ in range(30):
            ix = np.sort(rng.choice(40, size=3, replace=False)) + 1
            lines.append(f"{int(rng.uniform() < 0.5)} " + " ".join(
                f"{i}:{rng.normal():.6g}" for i in ix))
        (d / f"part-{p}.txt").write_text("\n".join(lines) + "\n")
    for kw in ({}, {"feature_dimension": 50}):
        fmt, ref_fmt = LibSVMInputDataFormat(**kw), RefLibSVM(**kw)
        imap, stats = fmt.stream_scan([str(d)])
        ref_imap, ref_stats = ref_fmt.stream_scan([str(d)])
        assert imap.size == ref_imap.size
        assert stats == streaming.StreamStats(ref_stats.num_rows, ref_stats.max_nnz)
        for path in fmt.stream_files([str(d)]):
            assert list(fmt.stream_rows(path, imap)) == list(ref_fmt.stream_rows(path, ref_imap))


# -- summaries -----------------------------------------------------------------


@pytest.mark.parametrize("native", [True, False], ids=["native", "python-codec"])
def test_fused_scan_and_streamed_summary_match_reference(tmp_path, monkeypatch, native):
    """The fused scan's and the streamed pass's summaries equal the JAX
    package's (float64 moments finalized in float32), also with a prebuilt
    map that drops features; the reservoir sample is the reference's
    draw, row for row."""
    if not native:
        _no_native(monkeypatch)
    root = _write_files(tmp_path / "w", 5, weights=True)
    fmt, ref_fmt = AvroInputDataFormat(), RefAvro()
    imap, stats, summary = scan_stream_with_summary([root], fmt, device="cpu")
    ref_imap, ref_stats, ref_summary = ref_fmt.stream_scan_with_summary([root])
    _same_map(imap, ref_imap)
    for name in summary._fields:
        np.testing.assert_allclose(
            to_np(getattr(summary, name)), np.asarray(getattr(ref_summary, name)),
            rtol=1e-6, atol=1e-7, err_msg=name,
        )
    streamed, sample = streaming_summary([root], fmt, imap, stats, reservoir_rows=50,
                                         seed=3, rows_per_chunk=64, device="cpu")
    ref_streamed, ref_sample = ref_streaming.streaming_summary(
        [root], ref_fmt, ref_imap, ref_stats, reservoir_rows=50, seed=3, rows_per_chunk=64)
    for name in summary._fields:
        np.testing.assert_allclose(to_np(getattr(streamed, name)),
                                   np.asarray(getattr(ref_streamed, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(to_np(getattr(streamed, name)),
                                   to_np(getattr(summary, name)), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(to_np(sample.indices), np.asarray(ref_sample.indices))
    np.testing.assert_array_equal(to_np(sample.labels), np.asarray(ref_sample.labels))
    # a prebuilt map without x0..x4 drops them from vocabulary and moments
    from photon_ml_tpu_torch.utils.index_map import IndexMap

    keep = [k for k, _ in imap.items() if not k.startswith(("x0\t", "x1\t", "x2\t"))]
    pre = IndexMap.build(iter(k for k in keep if "(INTERCEPT)" not in k), add_intercept=True)
    _, _, s_pre = scan_stream_with_summary([root], fmt, index_map=pre, device="cpu")
    for key, j in pre.items():
        assert float(s_pre.mean[j]) == pytest.approx(float(summary.mean[imap.get_index(key)]),
                                                     rel=1e-6, abs=1e-7)


# -- the streamed objective ------------------------------------------------------


@pytest.mark.parametrize("kernel", ["scatter", "tiled"])
def test_streaming_objective_matches_in_memory(files, kernel):
    """Value, gradient, Hv and Hessian diagonal of the streamed objective
    (three chunks: one in the device tier, two spilled; the tiled kernel's
    plain version on the CPU) against the in-memory scatter objective."""
    fmt = AvroInputDataFormat()
    loaded = fmt.load([files], device="cpu")
    imap, stats = scan_stream([files], fmt)
    obj = StreamingGLMObjective([files], fmt, imap, stats, LOGISTIC, rows_per_chunk=96,
                                cache_bytes=96 * 52, kernel=kernel, device="cpu")
    oracle = GLMObjective(loss_for_task(LOGISTIC), loaded.num_features)
    rng = np.random.default_rng(1)
    w = torch.tensor(rng.normal(size=obj.dim).astype(np.float32))
    d = torch.tensor(rng.normal(size=obj.dim).astype(np.float32))
    v_m, g_m = oracle.value_and_gradient(w, loaded.batch, 0.4)
    for _ in range(2):  # the filling pass, then the tiers (and K1's tiles)
        v_s, g_s = obj.value_and_gradient(w, 0.4)
        assert float(v_s) == pytest.approx(float(v_m), rel=1e-5)
        np.testing.assert_allclose(to_np(g_s), to_np(g_m), atol=1e-4 * float(g_m.abs().max()))
    assert obj.tier_counts == {"device": 1, "disk": 2, "tiled": 3 if kernel == "tiled" else 0,
                               "overflow": 0 if kernel == "tiled" else 3}
    # with every chunk tiled an evaluation reads no spilled chunk; on the
    # scatter partial it reads both
    from photon_ml_tpu_torch.reliability.retry import reset_retry_stats, retry_stats

    reset_retry_stats()
    obj.value_and_gradient(w, 0.4)
    assert retry_stats()["attempts"].get("spill_read", 0) == (0 if kernel == "tiled" else 2)
    hv = obj.hessian_vector(w, d, 0.4)
    hv_m = oracle.hessian_vector(w, d, loaded.batch, 0.4)
    np.testing.assert_allclose(to_np(hv), to_np(hv_m), atol=1e-4 * float(hv_m.abs().max()))
    hd = obj.hessian_diagonal(w, 0.4)
    hd_m = oracle.hessian_diagonal(w, loaded.batch, 0.4)
    np.testing.assert_allclose(to_np(hd), to_np(hd_m), atol=1e-4 * float(hd_m.abs().max()))
    assert obj.decode_passes == 1
    # the reference's streamed objective at the same point
    ref_fmt = RefAvro()
    ref_imap, ref_stats = ref_streaming.scan_stream([files], ref_fmt)
    ref_obj = ref_streaming.StreamingGLMObjective([files], ref_fmt, ref_imap, ref_stats,
                                                  RefTask.LOGISTIC_REGRESSION, rows_per_chunk=96)
    v_r, g_r = ref_obj.value_and_gradient(jnp.asarray(to_np(w)), 0.4)
    assert float(v_s) == pytest.approx(float(v_r), rel=1e-5)
    np.testing.assert_allclose(to_np(g_s), np.asarray(g_r), atol=1e-4 * float(g_m.abs().max()))


def test_tiled_budget_overflow_keeps_the_rest_on_scatter(files):
    """A tiled cache that holds one chunk: the other two take the scatter
    partial, and the sum is the all-scatter objective's."""
    fmt = AvroInputDataFormat()
    imap, stats = scan_stream([files], fmt)
    kw = dict(rows_per_chunk=96, device="cpu")
    full = StreamingGLMObjective([files], fmt, imap, stats, LOGISTIC, kernel="scatter", **kw)
    obj = StreamingGLMObjective([files], fmt, imap, stats, LOGISTIC, kernel="tiled", **kw)
    w = torch.tensor(np.random.default_rng(2).normal(size=obj.dim).astype(np.float32))
    obj.value_and_gradient(w)
    obj._ensure_tiled()
    sizes = obj.tiled_nbytes
    assert len(sizes) == 3
    obj.tiled_cache_bytes = sizes[0] + sizes[1] // 2
    obj._tiled = None
    v, g = obj.value_and_gradient(w, 0.1)
    v_f, g_f = full.value_and_gradient(w, 0.1)
    assert obj.tier_counts["tiled"] == 1 and obj.tier_counts["overflow"] == 2
    assert float(v) == pytest.approx(float(v_f), rel=1e-6)
    np.testing.assert_allclose(to_np(g), to_np(g_f), atol=1e-5 * float(g_f.abs().max()))


def test_cache_tiers_decode_once_and_spill_exact(files, monkeypatch):
    """The first evaluation decodes each file once and fills the tiers;
    later ones decode nothing. A one-chunk device budget spills the rest,
    and the spilled tier gives bitwise the same evaluation; cache_bytes=0
    decodes on every evaluation. The scratch goes with close()."""
    calls = {"n": 0}
    real = AvroInputDataFormat.decode_payload

    def counting(self, path):
        calls["n"] += 1
        return real(self, path)

    monkeypatch.setattr(AvroInputDataFormat, "decode_payload", counting)
    fmt = AvroInputDataFormat()
    imap, stats = scan_stream([files], fmt)
    w = torch.tensor(np.random.default_rng(3).normal(size=imap.size).astype(np.float32))
    obj = StreamingGLMObjective([files], fmt, imap, stats, LOGISTIC, rows_per_chunk=64,
                                cache_bytes=1, kernel="scatter", device="cpu")
    v1, g1 = obj.value_and_gradient(w)
    assert calls["n"] == 3
    spill = obj._disk_cache.dir
    assert obj.tier_counts["device"] == 1 and obj.tier_counts["disk"] == 3
    assert obj.spill_bytes == 3 * 64 * (5 * 8 + 12)
    v2, g2 = obj.value_and_gradient(w)
    obj.hessian_vector(w, w)
    assert calls["n"] == 3 and obj.decode_passes == 1
    assert float(v1) == float(v2)
    torch.testing.assert_close(g1, g2, rtol=0, atol=0)
    obj.close()
    assert not os.path.isdir(spill)
    nocache = StreamingGLMObjective([files], fmt, imap, stats, LOGISTIC, rows_per_chunk=64,
                                    cache_bytes=0, kernel="scatter", device="cpu")
    nocache.value_and_gradient(w)
    nocache.value_and_gradient(w)
    assert calls["n"] == 9 and nocache.decode_passes == 2


def test_spill_dirs_swept_at_exit(tmp_path):
    """A spill directory left open at interpreter exit is removed by the
    atexit sweep; close() unregisters it."""
    code = (
        "import os, sys; sys.path.insert(0, sys.argv[1]);"
        "from photon_ml_tpu_torch.io.streaming import make_spill_dir, unregister_spill_dir;"
        "d = make_spill_dir('photon-test-', sys.argv[2]);"
        "open(os.path.join(d, 'x.bin'), 'wb').write(b'1' * 10);"
        "print(d)"
    )
    r = subprocess.run([sys.executable, "-c", code, REPO, str(tmp_path)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert not os.path.exists(r.stdout.strip())
    d = streaming.make_spill_dir("photon-test-", str(tmp_path))
    assert d in streaming._LIVE_SPILL_DIRS
    streaming.unregister_spill_dir(d)
    assert d not in streaming._LIVE_SPILL_DIRS


def test_stream_budget_helpers():
    assert streaming.stream_budget_rows(0, 100) == 65536
    assert streaming.stream_budget_rows(33554432, streaming.sparse_row_bytes(65)) == 63072
    assert streaming.stream_budget_rows(10, 100) == 8
    assert streaming.sparse_row_bytes(65) == ref_streaming.sparse_row_bytes(65) == 532
    assert streaming.budgeted_rows(100_000, 1 << 20, 532) == 1971
    assert glm_driver.budgeted_reservoir_rows(10, 1 << 30, 5) == 10


# -- host optimizers in float64 --------------------------------------------------


def _ref_batch64(batch):
    """The reference's SparseBatch with float64 values, labels, offsets and
    weights (its gradient accumulates in the values' dtype); built as
    numpy, so it is float64 inside ``jax.enable_x64``."""
    return batch._replace(**{
        f: np.asarray(getattr(batch, f), np.float64)
        for f in ("values", "labels", "offsets", "weights")
    })


def _objectives64(seed=7, n=300, d=30):
    """(port vg / hvp of w, reference vg / hvp under x64): the in-memory
    objectives over the same rows, computing in float64."""
    from torch_parity import both_batches, random_rows

    rng = np.random.default_rng(seed)
    rows, labels = random_rows(rng, n=n, d=d)
    ref_b, port_b = both_batches(rows, labels)
    obj = GLMObjective(loss_for_task(LOGISTIC), d)
    ref_obj = RefGLMObjective(REF_LOGISTIC, d)

    def vg(l2):
        return lambda w: obj.value_and_gradient(w, port_b, l2)

    def hvp(l2):
        return lambda w, v: obj.hessian_vector(w, v, port_b, l2)

    ref_b = _ref_batch64(ref_b)

    def ref_vg(l2):
        return lambda w: ref_obj.value_and_gradient(jnp.asarray(w, jnp.float64), ref_b, l2)

    def ref_hvp(l2):
        return lambda w, v: ref_obj.hessian_vector(
            jnp.asarray(w, jnp.float64), jnp.asarray(v, jnp.float64), ref_b, l2)

    return d, vg, hvp, ref_vg, ref_hvp


@pytest.mark.parametrize("kind", ["lbfgs", "owlqn", "tron", "lbfgs-box"])
def test_host_optimizers_match_reference_float64(kind):
    """Each host optimizer walks the reference's iterates in float64 (to
    1e-9, the same iterations and stop reason) with the same number of
    counted fetches, so the same pattern per iteration."""
    d, vg, hvp, ref_vg, ref_hvp = _objectives64()
    w0 = torch.zeros(d, dtype=torch.float64)
    mask = torch.ones(d, dtype=torch.float64)
    mask[-1] = 0.0
    box = None
    if kind == "lbfgs-box":
        from photon_ml_tpu.optim.common import BoxConstraints as RefBox
        from photon_ml_tpu_torch.optim.common import BoxConstraints

        box = BoxConstraints(torch.full((d,), -0.3, dtype=torch.float64),
                             torch.full((d,), 0.3, dtype=torch.float64))
    overlap.reset_readback_stats()
    ref_overlap.reset_readback_stats()
    with jax.enable_x64(True):
        if kind in ("lbfgs", "lbfgs-box"):
            ref_box = None if box is None else RefBox(jnp.full((d,), -0.3), jnp.full((d,), 0.3))
            res = minimize_lbfgs_host(vg(0.5), w0, tol=1e-9, box=box, track_coefficients=True)
            ref = ref_host_lbfgs.minimize_lbfgs_host(ref_vg(0.5), jnp.zeros(d), tol=1e-9,
                                                     box=ref_box, track_coefficients=True)
        elif kind == "owlqn":
            res = minimize_owlqn_host(vg(0.2), w0, 0.8, tol=1e-9, l1_mask=mask,
                                      track_coefficients=True)
            ref = ref_host_lbfgs.minimize_owlqn_host(ref_vg(0.2), jnp.zeros(d), 0.8, tol=1e-9,
                                                     l1_mask=jnp.asarray(to_np(mask)),
                                                     track_coefficients=True)
        else:
            # at 1e-9 the last trust-region test compares reductions at
            # float64 noise and may go either way: 1e-6 stops before that
            res = minimize_tron_host(vg(0.5), hvp(0.5), w0, tol=1e-6, track_coefficients=True)
            ref = ref_host_tron.minimize_tron_host(ref_vg(0.5), ref_hvp(0.5), jnp.zeros(d),
                                                   tol=1e-6, track_coefficients=True)
        ref_coefs = np.asarray(ref.coefficients, np.float64)
        ref_track = np.asarray(ref.tracker.coefs, np.float64)
    assert res.iterations == int(ref.iterations) and res.reason == int(ref.reason)
    assert res.coefficients.dtype == torch.float64
    np.testing.assert_allclose(to_np(res.coefficients), ref_coefs, rtol=0, atol=1e-9)
    n = res.tracker.count
    assert n == int(ref.tracker.count)
    # the reference's tracker keeps float32 coefficients
    np.testing.assert_allclose(to_np(res.tracker.coefs[:n]), ref_track[:n], rtol=0, atol=1e-6)
    if kind == "owlqn":
        assert float(res.coefficients[-1]) != 0.0 and (to_np(res.coefficients) == 0).any()
    assert overlap.readback_stats() == ref_overlap.readback_stats() > 2 * res.iterations


# -- streamed fits ----------------------------------------------------------------

FITS = {
    "lbfgs": (OptimizerType.LBFGS, RegularizationType.L2, None, RefOpt.LBFGS, RefReg.L2),
    "owlqn-elastic-net": (OptimizerType.LBFGS, RegularizationType.ELASTIC_NET, 0.5,
                          RefOpt.LBFGS, RefReg.ELASTIC_NET),
    "tron": (OptimizerType.TRON, RegularizationType.L2, None, RefOpt.TRON, RefReg.L2),
}


@pytest.mark.parametrize("fit", sorted(FITS))
def test_streamed_fit_matches_reference(tmp_path, fit):
    """train_streaming_glm against the JAX package's: float32 against its
    streamed trainer (5e-4 of the largest coefficient), and in float64 (initial in float64) against
    the reference's host optimizer over the in-memory objective in float64
    (1e-9, the same iterations); the intercept is exempt from L1, and the
    variances are the streamed Hessian diagonal's."""
    root = _write_files(tmp_path / "fit", 11, n_files=4, rows_per_file=60)
    opt, reg, alpha, ref_opt, ref_reg = FITS[fit]
    kw = dict(regularization_type=reg, elastic_net_alpha=alpha,
              regularization_weights=[1.0, 0.1], optimizer_type=opt, rows_per_chunk=64,
              cache_bytes=64 * 52 * 2, device="cpu", compute_variances=True)
    models, results, imap = train_streaming_glm([root], LOGISTIC, **kw)
    ref_models, ref_results, ref_imap = ref_train_streaming(
        [root], RefTask.LOGISTIC_REGRESSION, regularization_type=ref_reg,
        elastic_net_alpha=alpha, regularization_weights=[1.0, 0.1], optimizer_type=ref_opt,
        rows_per_chunk=64, compute_variances=True)
    _same_map(imap, ref_imap)
    icept = imap.get_index("(INTERCEPT)\t")
    for lam in (1.0, 0.1):
        assert_close_to_scale(models[lam].means, np.asarray(ref_models[lam].coefficients.means),
                              rtol=5e-4)
        assert_close_to_scale(models[lam].coefficients.variances,
                              np.asarray(ref_models[lam].coefficients.variances), rtol=5e-4)
    if reg == RegularizationType.ELASTIC_NET:
        assert float(models[0.1].means[icept]) != 0.0
    # float64: the same streamed trainer from a float64 start
    models64, results64, _ = train_streaming_glm(
        [root], LOGISTIC, initial=torch.zeros(imap.size, dtype=torch.float64),
        **{**kw, "compute_variances": False})
    fmt = AvroInputDataFormat()
    loaded = RefAvro().load([root], index_map=ref_imap)
    ref_batch = _ref_batch64(loaded.batch)
    ref_obj = RefGLMObjective(REF_LOGISTIC, imap.size)
    l1_mask = np.ones(imap.size)
    l1_mask[icept] = 0.0
    current = jnp.zeros(imap.size)
    with jax.enable_x64(True):
        for lam in (1.0, 0.1):
            l1, l2 = (0.5 * lam, 0.5 * lam) if alpha else (0.0, lam)

            def vg(w, l2=l2):
                return ref_obj.value_and_gradient(jnp.asarray(w, jnp.float64), ref_batch, l2)

            if opt == OptimizerType.TRON:
                ref = ref_host_tron.minimize_tron_host(
                    vg, lambda w, v, l2=l2: ref_obj.hessian_vector(
                        jnp.asarray(w, jnp.float64), v, ref_batch, l2), current)
            elif alpha:
                ref = ref_host_lbfgs.minimize_owlqn_host(vg, current, l1,
                                                         l1_mask=jnp.asarray(l1_mask))
            else:
                ref = ref_host_lbfgs.minimize_lbfgs_host(vg, current)
            current = ref.coefficients
            assert results64[lam].iterations == int(ref.iterations), lam
            np.testing.assert_allclose(to_np(models64[lam].means), np.asarray(current),
                                       rtol=0, atol=1e-9)
    del fmt


def test_streamed_fit_with_normalization_matches_in_memory(tmp_path):
    """Normalization goes back to the original space as the in-memory
    trainer's does (float32: 1e-3 of the largest coefficient)."""
    from photon_ml_tpu_torch.data.stats import compute_summary
    from photon_ml_tpu_torch.ops.normalization import NormalizationType, build_normalization

    root = _write_files(tmp_path / "norm", 13)
    fmt = AvroInputDataFormat()
    loaded = fmt.load([root], device="cpu")
    s = compute_summary(loaded.batch, loaded.num_features)
    norm = build_normalization(NormalizationType.STANDARDIZATION, mean=s.mean, std=s.std,
                               max_magnitude=s.max_magnitude,
                               intercept_index=loaded.intercept_index)
    kw = dict(regularization_type=RegularizationType.L2, regularization_weights=[1.0],
              normalization=norm)
    models, _, _ = train_streaming_glm([root], LOGISTIC, rows_per_chunk=64, device="cpu", **kw)
    mm, _ = train_generalized_linear_model(loaded.batch, LOGISTIC, loaded.num_features,
                                           intercept_index=loaded.intercept_index,
                                           device="cpu", **kw)
    scale = float(mm[1.0].means.abs().max())
    np.testing.assert_allclose(to_np(models[1.0].means), to_np(mm[1.0].means),
                               atol=1e-3 * scale)


# -- streamed evaluation ------------------------------------------------------------


def test_streamed_metrics_match_exact():
    rng = np.random.default_rng(5)
    n = 20_000
    z = torch.tensor(rng.normal(size=n) * 2)
    y = torch.tensor((rng.uniform(size=n) < torch.sigmoid(z).numpy()).astype(np.float64))
    w = torch.tensor(rng.uniform(0.5, 2.0, size=n))
    auc, rmse, loss = StreamingAUC(), StreamingRMSE(), StreamingMeanLoss(loss_for_task(LOGISTIC))
    for part in np.array_split(np.arange(n), 7):
        auc.update(z[part], y[part], w[part])
        rmse.update(torch.sigmoid(z[part]), y[part], w[part])
        loss.update(z[part], y[part], w[part])
    assert auc.result() == pytest.approx(float(area_under_roc_curve(z, y, w)), abs=1e-3)
    assert rmse.result() == pytest.approx(
        float(root_mean_squared_error(torch.sigmoid(z), y, w)), rel=1e-12)
    assert loss.result() == pytest.approx(
        float(mean_pointwise_loss(loss_for_task(LOGISTIC), z, y, w)), rel=1e-12)
    from photon_ml_tpu.evaluation.streaming import StreamingAUC as RefAUC

    ref = RefAUC()
    ref.update(z.numpy(), y.numpy(), w.numpy())
    assert auc.result() == pytest.approx(ref.result(), rel=1e-12)


# -- the scan cache -----------------------------------------------------------------


def test_stats_cache_cross_loads_and_quarantines(tmp_path, files):
    """Entries written by either package are read by the other (every
    partition cached, the same map, stats and summary); a torn entry is
    quarantined and its partition scanned again."""
    fmt, ref_fmt = AvroInputDataFormat(), RefAvro()
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    imap, stats, summary, cs = stats_cache.cached_scan_stream_with_summary(
        [files], fmt, port_dir, device="cpu")
    assert (cs.scanned, cs.cached, cs.stored) == (3, 0, 3)
    r_imap, r_stats, r_summary, r_cs = ref_stats_cache.cached_scan_stream_with_summary(
        [files], ref_fmt, port_dir)
    assert (r_cs.scanned, r_cs.cached) == (0, 3)
    ref_stats_cache.cached_scan_stream_with_summary([files], ref_fmt, ref_dir)
    imap2, stats2, summary2, cs2 = stats_cache.cached_scan_stream_with_summary(
        [files], fmt, ref_dir, device="cpu")
    assert (cs2.scanned, cs2.cached) == (0, 3)
    _same_map(imap2, r_imap)
    assert stats == stats2 == streaming.StreamStats(r_stats.num_rows, r_stats.max_nnz)
    fused = scan_stream_with_summary([files], fmt, device="cpu")[2]
    for name in summary._fields:
        np.testing.assert_allclose(to_np(getattr(summary, name)),
                                   np.asarray(getattr(r_summary, name)), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(to_np(getattr(summary2, name)),
                                   to_np(getattr(fused, name)), rtol=1e-6, atol=1e-7)
    # the entries themselves: the same files, keys and float64 partials
    names = sorted(os.listdir(os.path.join(port_dir, "v1")))
    assert names == sorted(os.listdir(os.path.join(ref_dir, "v1")))
    for name in names:
        mine = json.load(open(os.path.join(port_dir, "v1", name)))
        theirs = json.load(open(os.path.join(ref_dir, "v1", name)))
        assert mine == theirs, name
    entry = names[0]
    with open(os.path.join(port_dir, "v1", entry), "w") as f:
        f.write("{torn")
    _, _, cs3 = stats_cache.cached_scan_stream([files], fmt, port_dir)
    assert (cs3.scanned, cs3.cached, cs3.quarantined) == (1, 2, 1)
    assert any(n.endswith(".corrupt") for n in os.listdir(os.path.join(port_dir, "v1")))


# -- the driver ----------------------------------------------------------------------


def _driver_argv(train, val, out, *extra):
    return ["--training-data-directory", train, "--validating-data-directory", val,
            "--output-directory", out, "--regularization-weights", "10,1",
            "--device", "cpu", "--streaming", "true", *extra]


def test_streaming_driver_matches_reference_driver(tmp_path):
    """Both drivers with --streaming true, a memory budget that spills,
    the scan cache, variances and per-iteration validation: the same
    models (float32, 1e-3), the streamed AUC within 1e-3 of the exact AUC
    of the written model, the scan cache block, then a warm rerun with
    TRON and --diagnostic-mode ALL (the reservoir): every partition
    cached, the report's chapters written with finite numbers."""
    from photon_ml_tpu.cli import glm_driver as ref_driver
    from photon_ml_tpu_torch.io.model_io import load_glm_models_avro
    from photon_ml_tpu_torch.models.glm import compute_margins
    from photon_ml_tpu_torch.utils.index_map import IndexMap

    train = _write_files(tmp_path / "train", 21, n_files=3, rows_per_file=80)
    val = _write_files(tmp_path / "val", 22, n_files=1, rows_per_file=100)
    extra = ["--stream-memory-budget", str(64 * 52 * 2), "--scan-cache-dir",
             str(tmp_path / "sc"), "--compute-variances", "true",
             "--validate-per-iteration", "true", "--convergence-tolerance", "1e-4"]
    port = glm_driver.main(_driver_argv(train, val, str(tmp_path / "out"), *extra))
    ref_extra = [a if a != str(tmp_path / "sc") else str(tmp_path / "rsc") for a in extra]
    ref_argv = _driver_argv(train, val, str(tmp_path / "ref"), *ref_extra)
    ref_argv.remove("--device")
    ref_argv.remove("cpu")
    ref = ref_driver.GLMDriver(ref_driver.params_from_args(ref_argv))
    ref.run()
    metrics = json.load(open(tmp_path / "out" / "metrics.json"))
    ref_metrics = json.load(open(tmp_path / "ref" / "metrics.json"))
    assert metrics["scan_cache"] == ref_metrics["scan_cache"] == {
        "partitions": 3, "scanned": 3, "cached": 0, "stored": 3, "quarantined": 0}
    assert metrics["streaming"]["tiers"]["disk"] >= 1
    assert metrics["best_lambda"] == ref_metrics["best_lambda"]
    for lam in (10.0, 1.0):
        np.testing.assert_allclose(to_np(port.models[lam].means),
                                   np.asarray(ref.models[lam].coefficients.means), atol=1e-3)
        assert len(metrics["per_iteration_validation"][str(lam)]) == \
            port.results[lam].iterations + 1
        assert metrics["validation"][str(lam)]["AUC"] == pytest.approx(
            ref_metrics["validation"][str(lam)]["AUC"], abs=1e-3)
    # the streamed AUC against the exact AUC of the written model
    imap = IndexMap.load(str(tmp_path / "out" / "feature-index" / "index.json"))
    written = load_glm_models_avro(str(tmp_path / "out" / "models" / "models.avro"), imap,
                                   device="cpu")
    vdata = AvroInputDataFormat().load([val], index_map=imap, device="cpu")
    for lam in (10.0, 1.0):
        z = compute_margins(written[str(lam)].means, vdata.batch)
        exact = float(area_under_roc_curve(z, vdata.batch.labels, vdata.batch.weights))
        assert metrics["validation"][str(lam)]["AUC"] == pytest.approx(exact, abs=1e-3)
    # warm rerun: TRON, the reservoir and the report
    out2 = str(tmp_path / "out2")
    argv2 = _driver_argv(train, val, out2, "--scan-cache-dir", str(tmp_path / "sc"),
                         "--optimizer", "TRON", "--diagnostic-mode", "ALL")
    argv2[argv2.index("10,1")] = "1"
    glm_driver.main(argv2)
    m2 = json.load(open(os.path.join(out2, "metrics.json")))
    assert m2["scan_cache"]["cached"] == 3 and m2["scan_cache"]["scanned"] == 0
    report = open(os.path.join(out2, "model-diagnostics", "report.txt")).read()
    # as in the JAX package, no fitting curves without a validation batch
    assert "Model lambda=1.0" in report and "Bootstrap analysis" in report
    assert "Fitting analysis" not in report
    assert "nan" not in report.lower()


@pytest.mark.parametrize("extra,error", [
    (["--grid-mode", "batched"], "incompatible with --streaming"),
    (["--stream-memory-budget", "1024"], "requires --streaming true"),
    (["--scan-cache-dir", "/c"], "requires --streaming true"),
    (["--input-file-format", "LIBSVM", "--scan-cache-dir", "/c"], "AVRO"),
])
def test_streaming_gates(tmp_path, extra, error):
    streaming_on = extra[0] in ("--grid-mode",) or extra[0] == "--input-file-format"
    argv = ["--training-data-directory", "t", "--output-directory", str(tmp_path / "o"),
            "--device", "cpu", *extra] + (["--streaming", "true"] if streaming_on else [])
    with pytest.raises(ValueError, match=error):
        glm_driver.params_from_args(argv).validate()


# -- kill -9 and memory --------------------------------------------------------------


def _run(args, *, expect_kill=False, timeout=300):
    env = {**os.environ, "PHOTON_RETRY_BASE_S": "0.001"}
    r = subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=timeout)
    if expect_kill:
        assert r.returncode == -9, f"expected SIGKILL, got rc={r.returncode}\n{r.stderr[-2000:]}"
    else:
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return r


def test_streamed_grid_killed_mid_lambda_resumes_bitwise(tmp_path):
    """kill -9 in λ = 1's snapshot of a streamed grid, then the same run
    again: the model files are bitwise an uninterrupted run's."""
    train = _write_files(tmp_path / "train", 31)
    clean, kill, ckpt = (str(tmp_path / n) for n in ("clean", "kill", "ckpt"))

    def args(out, *extra):
        return ["-m", "photon_ml_tpu_torch.cli.glm_driver", "--training-data-directory", train,
                "--output-directory", out, "--regularization-weights", "10,1,0.1",
                "--streaming", "true", "--stream-memory-budget", str(64 * 52),
                "--compute-variances", "true", "--delete-output-dirs-if-exist", "true",
                "--device", "cpu", *extra]

    _run(args(clean))
    _run(args(kill, "--checkpoint-dir", ckpt, "--fault-plan", "ckpt_save:4:KILL"),
         expect_kill=True)
    committed = [f for f in os.listdir(ckpt) if f.startswith("lambda-") and f.endswith(".json")]
    assert len(committed) == 1
    _run(args(kill, "--checkpoint-dir", ckpt))
    for sub in ("models/models.avro", "optimization-log.txt"):
        assert open(os.path.join(clean, sub), "rb").read() == \
            open(os.path.join(kill, sub), "rb").read(), sub


def test_rss_bounded_by_the_chunk_not_the_dataset(tmp_path):
    """A streamed fit over ~6 MB of staged rows (16 files) with a 1 MB
    budget (one chunk on the device tier, the rest spilled), after a
    warm-up over one file: the RSS grows by less than half of what loading
    the same files into memory adds (every file decoded at once; measured
    6.3 MB against 25.2 MB on the CPU, for 6.4 MB of staged rows)."""
    code = r'''
import gc, os, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro_codec import write_container
root = sys.argv[2]
rng = np.random.default_rng(0)
n, k, d, parts = 12000, 64, 5000, 16
for p in range(parts):
    ix = rng.integers(0, d, size=(n // parts, k))
    vs = rng.normal(size=(n // parts, k))
    recs = [{"uid": None, "label": float(i % 2), "offset": None, "weight": None,
             "features": [{"name": str(j), "term": "", "value": float(v)}
                          for j, v in zip(ix[i], vs[i])]} for i in range(n // parts)]
    write_container(os.path.join(root, f"p{p:02d}.avro"), schemas.TRAINING_EXAMPLE_AVRO, recs)
    del recs
import torch
from photon_ml_tpu_torch.io.input_format import AvroInputDataFormat
from photon_ml_tpu_torch.io.streaming import StreamingGLMObjective, scan_stream, sparse_row_bytes
from photon_ml_tpu_torch.task import TaskType
def rss():
    gc.collect()
    return int(open("/proc/self/statm").read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
fmt = AvroInputDataFormat()
imap, stats = scan_stream([root], fmt)
w = torch.zeros(imap.size)

def fit(paths):
    obj = StreamingGLMObjective(paths, fmt, imap, stats, TaskType.LOGISTIC_REGRESSION,
                                rows_per_chunk=(1 << 20) // sparse_row_bytes(stats.max_nnz),
                                cache_bytes=1 << 20, kernel="scatter", device="cpu")
    for _ in range(3):
        obj.value_and_gradient(w, 1.0)
    return obj

# the first file first, so the costs paid once a process (threads,
# allocator arenas, torch's first calls) stay out of both measurements
first = os.path.join(root, "p00.avro")
warm = (fit([first]), fmt.load([first], index_map=imap, device="cpu"))
base = rss()
obj = fit([root])
streamed = rss() - base
base = rss()
loaded = fmt.load([root], index_map=imap, device="cpu")
in_memory = rss() - base
print(streamed, in_memory, stats.num_rows * sparse_row_bytes(stats.max_nnz), obj.tier_counts["disk"])
'''
    root = tmp_path / "big"
    root.mkdir()
    env = {**os.environ, "PHOTON_SPILL_DIR": str(tmp_path)}
    r = subprocess.run([sys.executable, "-c", code, REPO, str(root)], capture_output=True,
                       text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    streamed, in_memory, data, disk = (int(x) for x in r.stdout.split())
    assert data > 6 << 20 and disk >= 5
    assert streamed < in_memory // 2, (streamed, in_memory, data)
