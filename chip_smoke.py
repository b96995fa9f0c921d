#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``photon_ml_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printing its own lines:

1. device: the card's name and power limit (nvidia-smi), and the build of
   the CUDA kernel (nvcc, sm_90a) and the native schedule builder (g++);
2. K1, the bilinear pass, against its plain PyTorch version on the card,
   at a small shape (forced spills, ragged tiles) and at the ads shape
   (2^18 rows x 64 nnz x 2^20 features): z-pass, g-pass and the g-pass
   over squared values;
3. K1 times at the ads shape (CUDA events, after warm-up) beside the plain
   version's, one torch.sparse CSR matvec of the same X (a yardstick the
   port never calls) and the bytes bound;
4. the main path at full width on planted-model logistic data: the
   L-BFGS lambda-grid [10, 1] with variances and a TRON fit through
   ``train_generalized_linear_model(kernel="tiled")``, then scores and
   AUC, with K1's launch count over exactly that run;
5. a ``kernels`` JSON line, the nvidia-smi line, and the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero without a CUDA card, without the package beside it, or
when any check fails. It imports nothing of JAX.
"""

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and f32 (non-tensor-core)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

N_ROWS, NNZ_PER_ROW, DIM = 1 << 18, 64, 1 << 20
N_HELD_OUT = 1 << 16
RTOL = 1e-5  # of the output's largest magnitude: f32 sums, another order


def say(*parts):
    print(*parts, flush=True)


def fail(msg):
    say(f"FAILED: {msg}")
    sys.exit(1)


def planted_data(rng, n, w_true):
    """Rows of NNZ_PER_ROW uniform features with normal values; labels
    drawn from the logistic model w_true."""
    idx = rng.integers(0, DIM, size=(n, NNZ_PER_ROW), dtype=np.int64)
    vals = rng.normal(size=(n, NNZ_PER_ROW)).astype(np.float32)
    margin = (vals * w_true[idx]).sum(axis=1)
    labels = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float32)
    return idx, vals, labels


def compare_passes(k1, tb, rng, label):
    """K1 against its plain version on z, g and g_sq passes; -> max abs err."""
    win = tb.params.window
    w = torch.as_tensor(rng.normal(size=tb.dim).astype(np.float32), device="cuda")
    c = torch.as_tensor(rng.normal(size=tb.num_rows).astype(np.float32), device="cuda")
    worst_abs, worst_rel = 0.0, 0.0
    for name, sched, src, n_out, vals in (
        ("z", tb.z_sched, w, tb.num_row_blocks, None),
        ("g", tb.g_sched, c, tb.num_feat_blocks, None),
        ("g_sq", tb.g_sched, c, tb.num_feat_blocks, tb.g_vals_sq),
    ):
        got = k1.bilinear_pass(sched, src, n_out, win, vals=vals)
        ref = k1.bilinear_pass_plain(sched, src, n_out, win, vals=vals)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        rel = err / max(scale, 1e-30)
        say(f"k1_check {label} {name}: max_abs_err={err!r} max_rel_err={rel!r} "
            f"scale={scale!r}")
        if not np.isfinite(err) or err > 1e-6 + RTOL * scale:
            fail(f"K1 {label} {name} disagrees with its plain version")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    return worst_abs, worst_rel


def time_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def pass_bound_ms(sched, n_src, n_out):
    """Least time for one pass: each entry's (in_pos, out_pos, val) read
    once, the source read once, the output written once, over the HBM
    rate; or 2 flops per entry over the f32 rate, whichever is larger.
    Entries are the slots of the G steps that hold a value (the data's
    values are normal draws, never 0); padding slots and spilled entries
    (added by ``apply_spill``, not K1) do no work of K1's function."""
    entries = int(torch.count_nonzero(sched.vals[: sched.num_steps]))
    nbytes = 12 * entries + 4 * n_src + 4 * n_out
    bound = max(nbytes / HBM_BYTES_PER_S, 2 * entries / F32_FLOPS_PER_S) * 1e3
    return bound, nbytes, entries


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2

    from photon_ml_tpu_torch.data.batch import sparse_batch_from_arrays
    from photon_ml_tpu_torch.evaluation.metrics import area_under_roc_curve
    from photon_ml_tpu_torch.models.glm import compute_margins
    from photon_ml_tpu_torch.ops import losses
    from photon_ml_tpu_torch.ops import tiled_sparse as ts
    from photon_ml_tpu_torch.ops.kernels import bilinear_pass as k1
    from photon_ml_tpu_torch.ops.objective import GLMObjective
    from photon_ml_tpu_torch.optim import common
    from photon_ml_tpu_torch.optim.config import OptimizerType, RegularizationType
    from photon_ml_tpu_torch.task import TaskType
    from photon_ml_tpu_torch.training import train_generalized_linear_model
    from photon_ml_tpu_torch.utils.device import gpu_name_and_power_limit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 1. device and builds --------------------------------------------------
    smi = gpu_name_and_power_limit()
    if smi is None:
        fail("nvidia-smi is not available")
    kind = torch.cuda.get_device_name(0)
    say(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    with ThreadPoolExecutor(2) as pool:  # nvcc and g++ side by side
        f_k1 = pool.submit(k1.build_kernel)
        f_native = pool.submit(ts._tile_lib)
        k1_build_s = f_k1.result()
        native_ok = bool(f_native.result())
    say(f"build: bilinear_pass.cu {k1_build_s:.2f} s; native schedule "
        f"builder {'ok' if native_ok else 'unavailable (numpy builder)'}")

    rng = np.random.default_rng(args.seed)

    # -- 2a. K1 against plain at a small shape ----------------------------------
    n_s, d_s = 3000, 5000
    rows = rng.integers(0, n_s, 40000)
    feats = rng.integers(0, d_s, 40000)
    feats[:6000] = d_s - 1  # heavy column: long, ragged tiles
    small = ts.build_tiled_batch(
        rows, feats, rng.normal(size=40000).astype(np.float32),
        np.zeros(n_s, np.float32), np.zeros(n_s, np.float32),
        np.ones(n_s, np.float32), d_s,
        params=ts.TileParams(s_hi=8, s_lo=8, chunk=32, spill_cap=8),
        device="cuda",
    )
    n_spill = int(torch.count_nonzero(small.z_sched.spill_vals))
    if n_spill == 0:
        fail("small shape did not spill")
    say(f"small shape: {n_s} x {d_s}, window 64, chunk 32, {n_spill} spills")
    small_err = compare_passes(k1, small, rng, "small")

    # -- main-path data at the ads shape ----------------------------------------
    t0 = time.perf_counter()
    w_true = (rng.normal(size=DIM) * 0.3).astype(np.float32)
    idx, vals, labels = planted_data(rng, N_ROWS, w_true)
    h_idx, h_vals, h_labels = planted_data(rng, N_HELD_OUT, w_true)
    say(f"data: {N_ROWS} x {NNZ_PER_ROW} nnz x {DIM} features "
        f"({N_ROWS * NNZ_PER_ROW} entries), made in "
        f"{time.perf_counter() - t0:.2f} s; positive rate {labels.mean():.4f}")
    ones = np.ones(N_ROWS, np.float32)
    zeros = np.zeros(N_ROWS, np.float32)
    t0 = time.perf_counter()
    tb = ts.build_tiled_batch(
        np.repeat(np.arange(N_ROWS, dtype=np.int64), NNZ_PER_ROW),
        idx.reshape(-1), vals.reshape(-1), labels, zeros, ones, DIM,
        device="cuda",
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    say(f"schedule: built by {tb.builder} in {build_s:.2f} s; window "
        f"{tb.params.window}, chunk {tb.params.chunk}, z steps "
        f"{tb.z_sched.num_steps}, g steps {tb.g_sched.num_steps}, "
        f"{tb.num_row_blocks} row blocks, {tb.num_feat_blocks} feature blocks, "
        f"z spills {int(torch.count_nonzero(tb.z_sched.spill_vals))}")
    train = sparse_batch_from_arrays(idx, vals, labels, zeros, ones, device="cuda")
    held_out = sparse_batch_from_arrays(
        h_idx, h_vals, h_labels, np.zeros(N_HELD_OUT, np.float32),
        np.ones(N_HELD_OUT, np.float32), device="cuda",
    )

    # -- 2b. K1 against plain at the ads shape ----------------------------------
    ads_err = compare_passes(k1, tb, rng, "ads")

    # -- 3. times at the ads shape ----------------------------------------------
    win = tb.params.window
    w = torch.as_tensor(rng.normal(size=tb.dim).astype(np.float32), device="cuda")
    c = torch.as_tensor(rng.normal(size=tb.num_rows).astype(np.float32), device="cuda")
    z_args = (tb.z_sched, w, tb.num_row_blocks, win)
    g_args = (tb.g_sched, c, tb.num_feat_blocks, win)
    coo = torch.stack([
        torch.arange(N_ROWS, device="cuda").repeat_interleave(NNZ_PER_ROW),
        torch.as_tensor(idx.reshape(-1), device="cuda"),
    ])
    x_vals = torch.as_tensor(vals.reshape(-1), device="cuda")
    x_csr = torch.sparse_coo_tensor(coo, x_vals, (tb.num_rows, tb.dim)).coalesce().to_sparse_csr()
    xt_csr = torch.sparse_coo_tensor(coo.flip(0), x_vals, (tb.dim, tb.num_rows)).coalesce().to_sparse_csr()
    del coo, x_vals
    times = {}
    for name, fn in (
        ("z_ms", lambda: k1.bilinear_pass(*z_args)),
        ("g_ms", lambda: k1.bilinear_pass(*g_args)),
        ("z_plain_ms", lambda: k1.bilinear_pass_plain(*z_args)),
        ("g_plain_ms", lambda: k1.bilinear_pass_plain(*g_args)),
        ("z_library_ms", lambda: x_csr @ w[:, None]),
        ("g_library_ms", lambda: xt_csr @ c[:, None]),
        ("z_ms_again", lambda: k1.bilinear_pass(*z_args)),
        ("g_ms_again", lambda: k1.bilinear_pass(*g_args)),
    ):
        times[name] = time_ms(fn)
    del x_csr, xt_csr
    z_bound, z_bytes, z_entries = pass_bound_ms(tb.z_sched, tb.dim, tb.num_rows)
    g_bound, g_bytes, g_entries = pass_bound_ms(tb.g_sched, tb.num_rows, tb.dim)
    say(f"k1_times ({smi}): " + " ".join(f"{k}={v!r}" for k, v in times.items())
        + f" z_bound_ms={z_bound!r} g_bound_ms={g_bound!r} "
        f"z_entries={z_entries} g_entries={g_entries} "
        f"z_bytes={z_bytes} g_bytes={g_bytes}")

    # -- 4. main path at full width ---------------------------------------------
    k1.launches = 0
    common.host_fetches = 0
    t0 = time.perf_counter()
    models, results = train_generalized_linear_model(
        tb, TaskType.LOGISTIC_REGRESSION, DIM,
        optimizer_type=OptimizerType.LBFGS,
        regularization_type=RegularizationType.L2,
        regularization_weights=[10.0, 1.0], max_iter=10,
        compute_variances=True, kernel="tiled", device="cuda",
    )
    torch.cuda.synchronize()
    lbfgs_s = time.perf_counter() - t0
    lbfgs_launches, lbfgs_fetches = k1.launches, common.host_fetches
    t0 = time.perf_counter()
    tron_models, tron_results = train_generalized_linear_model(
        tb, TaskType.LOGISTIC_REGRESSION, DIM,
        optimizer_type=OptimizerType.TRON,
        regularization_type=RegularizationType.L2,
        regularization_weights=[1.0], max_iter=3, kernel="tiled",
        device="cuda",
    )
    torch.cuda.synchronize()
    tron_s = time.perf_counter() - t0
    fits = [("lbfgs", lam, models[lam], results[lam]) for lam in models]
    fits.append(("tron", 1.0, tron_models[1.0], tron_results[1.0]))
    aucs = {}
    for opt, lam, model, res in fits:
        means = model.coefficients.means
        train_auc = float(area_under_roc_curve(
            compute_margins(means, train), train.labels, train.weights))
        held_margins = compute_margins(means, held_out)
        held_auc = float(area_under_roc_curve(
            held_margins, held_out.labels, held_out.weights))
        f_first, f_last = float(res.tracker.values[0]), float(res.value)
        say(f"fit {opt} lambda={lam}: iterations={res.iterations} "
            f"reason={res.reason_name} objective {f_first!r} -> {f_last!r} "
            f"train_auc={train_auc!r} held_out_auc={held_auc!r}")
        if not f_last < f_first:
            fail(f"{opt} lambda={lam}: the objective did not fall")
        if not bool(torch.isfinite(means).all()) or not bool(
            torch.isfinite(held_margins).all()
        ):
            fail(f"{opt} lambda={lam}: non-finite coefficients or scores")
        if not (train_auc > 0.75 and held_auc > 0.55):
            fail(f"{opt} lambda={lam}: AUC too low for planted data")
        aucs[f"{opt}_{lam}"] = held_auc
    variances = models[1.0].coefficients.variances
    if variances is None or not bool(torch.isfinite(variances).all()) or not bool(
        (variances > 0).all()
    ):
        fail("variances missing, non-finite or not positive")
    launches, fetches = k1.launches, common.host_fetches
    say(f"main_path: lbfgs grid {lbfgs_s:.3f} s ({lbfgs_launches} K1 launches, "
        f"{lbfgs_fetches} host fetches, iterations "
        f"{[results[lam].iterations for lam in models]}); tron {tron_s:.3f} s "
        f"({launches - lbfgs_launches} K1 launches, "
        f"{fetches - lbfgs_fetches} host fetches, iterations "
        f"{tron_results[1.0].iterations}); K1 launches {launches}, host "
        f"fetches {fetches}")
    if launches == 0:
        fail("the main path never launched K1")

    # the tiled CUDA objective at the fitted point against the scatter
    # objective (plain PyTorch gather/scatter) on the same rows; at l2 = 0,
    # so the data gradient X^T c is not cancelled by the l2 term
    coef = models[1.0].coefficients.means
    tiled_obj = ts.TiledGLMObjective(losses.LOGISTIC, DIM)
    v_t, g_t = tiled_obj.value_and_gradient(coef, tb, 0.0)
    v_s, g_s = GLMObjective(losses.LOGISTIC, DIM).value_and_gradient(coef, train, 0.0)
    v_err = abs(float(v_t) - float(v_s)) / abs(float(v_s))
    g_err = float((g_t - g_s).abs().max() / g_s.abs().max())
    say(f"objective check: tiled vs scatter value rel err {v_err!r}, "
        f"gradient rel err {g_err!r}")
    if not (v_err < 1e-5 and g_err < RTOL):
        fail("tiled objective disagrees with the scatter objective")

    # -- 5. result lines --------------------------------------------------------
    kernels = [{
        "name": "bilinear_pass",
        "route": "cuda",
        "source": "photon_ml_tpu_torch/ops/csrc/bilinear_pass.cu",
        "replaces": "photon_ml_tpu/ops/tiled_sparse.py:1294",
        "launches": launches,
        "max_abs_err": max(small_err[0], ads_err[0]),
        "ms": times["z_ms"] + times["g_ms"],
        "plain_ms": times["z_plain_ms"] + times["g_plain_ms"],
        "bound_ms": z_bound + g_bound,
        "bound_by": "bytes",
        "library_ms": times["z_library_ms"] + times["g_library_ms"],
        "work": "one z-pass + one g-pass at the ads shape",
        "z_ms": times["z_ms"], "g_ms": times["g_ms"],
        "z_bound_ms": z_bound, "g_bound_ms": g_bound,
        "max_rel_err": max(small_err[1], ads_err[1]),
    }]
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind,
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
