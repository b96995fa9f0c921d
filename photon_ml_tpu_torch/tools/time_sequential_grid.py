"""Time the warm-started sequential L-BFGS λ-grid, warm, on one NVIDIA card.

    python3 -m photon_ml_tpu_torch.tools.time_sequential_grid [--seed 0] [--repeats 5]

Builds planted-model logistic data at the ads shape (2^18 rows x 64 nnz x
2^20 features), fits the grid once to warm up (builds, allocator, library
handles), then times ``--repeats`` fits of
``train_generalized_linear_model`` (L-BFGS, L2, λ in {10, 1, 0.1, 0.01},
10 iterations, variances, ``kernel="tiled"``) on the host clock, with
``torch.cuda.synchronize()`` before the clock stops. Each fit prints its
seconds, K1 launches, host fetches and iterations. One more fit runs
under ``torch.profiler``: it prints the device operations launched (each
one a host launch; a count that does not vary from run to run as the
seconds do), the device's busy time and the kinds launched most often,
then the host calls that took the most of the host's time. Last, the
host's microseconds per K1 launch (200 launches enqueued behind a sleep
on the card, so that only the host sets their pace) and the card's name
and power limit.

It calls only entry points the port has had since its first slice, so it
can time an older checkout too: run it as a file with that checkout first
on ``PYTHONPATH``, in turns with the current one. It needs a CUDA card; it
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

LAMBDAS = [10.0, 1.0, 0.1, 0.01]
N_ROWS, NNZ_PER_ROW, DIM = 1 << 18, 64, 1 << 20
TOP = 8
LAUNCHES = 200


def ads_batch(seed: int):
    """Planted-model logistic rows at the ads shape, tiled on the card."""
    from photon_ml_tpu_torch.ops import tiled_sparse as ts

    rng = np.random.default_rng(seed)
    w_true = (rng.normal(size=DIM) * 0.3).astype(np.float32)
    idx = rng.integers(0, DIM, size=(N_ROWS, NNZ_PER_ROW), dtype=np.int64)
    vals = rng.normal(size=(N_ROWS, NNZ_PER_ROW)).astype(np.float32)
    margin = (vals * w_true[idx]).sum(axis=1)
    labels = (rng.uniform(size=N_ROWS) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    return ts.build_tiled_batch(
        np.repeat(np.arange(N_ROWS, dtype=np.int64), NNZ_PER_ROW), idx.reshape(-1),
        vals.reshape(-1), labels, np.zeros(N_ROWS, np.float32),
        np.ones(N_ROWS, np.float32), DIM, device="cuda",
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_sequential_grid: needs an NVIDIA card", file=sys.stderr)
        return 2

    from torch.profiler import ProfilerActivity, profile

    import photon_ml_tpu_torch
    from photon_ml_tpu_torch.ops.kernels import bilinear_pass as k1
    from photon_ml_tpu_torch.optim import common
    from photon_ml_tpu_torch.optim.config import OptimizerType, RegularizationType
    from photon_ml_tpu_torch.task import TaskType
    from photon_ml_tpu_torch.training import train_generalized_linear_model
    from photon_ml_tpu_torch.utils.device import gpu_name_and_power_limit

    tb = ads_batch(args.seed)

    def fit():
        return train_generalized_linear_model(
            tb, TaskType.LOGISTIC_REGRESSION, DIM,
            optimizer_type=OptimizerType.LBFGS,
            regularization_type=RegularizationType.L2,
            regularization_weights=LAMBDAS, max_iter=10, compute_variances=True,
            kernel="tiled", device="cuda",
        )

    fit()
    torch.cuda.synchronize()
    print(f"time_sequential_grid package={photon_ml_tpu_torch.__file__}", flush=True)
    for i in range(args.repeats):
        k1.launches = common.host_fetches = 0
        t0 = time.perf_counter()
        _, results = fit()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        iters = [results[lam].iterations for lam in sorted(results, reverse=True)]
        print(f"time_sequential_grid fit {i}: {seconds!r} s, {k1.launches} K1 "
              f"launches, {common.host_fetches} host fetches, iterations {iters}",
              flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fit()
        torch.cuda.synchronize()
    ops = sorted(
        (e for e in prof.key_averages() if e.device_type.name == "CUDA"),
        key=lambda e: e.count, reverse=True,
    )
    print(f"time_sequential_grid profiled fit: {sum(e.count for e in ops)} device "
          f"operations, {sum(e.self_device_time_total for e in ops) / 1e3!r} ms "
          f"device busy", flush=True)
    for e in ops[:TOP]:
        print(f"  {e.count} x {e.self_device_time_total / 1e3:.3f} ms: {e.key[:80]}")
    cpu = sorted(
        (e for e in prof.key_averages() if e.device_type.name == "CPU"),
        key=lambda e: e.self_cpu_time_total, reverse=True,
    )
    print(f"time_sequential_grid host calls by self time: {sum(e.count for e in cpu)} "
          f"calls, {sum(e.self_cpu_time_total for e in cpu) / 1e3!r} ms", flush=True)
    for e in cpu[:TOP]:
        print(f"  {e.count} x {e.self_cpu_time_total / 1e3:.3f} ms: {e.key[:80]}")

    # the host's cost of one K1 launch: calls enqueued behind a sleep on the
    # card, so the card never holds the host back
    win = tb.params.window
    for name, sched, n, n_out in (
        ("z", tb.z_sched, tb.dim, tb.num_row_blocks),
        ("g", tb.g_sched, tb.num_rows, tb.num_feat_blocks),
    ):
        src = torch.zeros(n, device="cuda")
        k1.bilinear_pass(sched, src, n_out, win)
        torch.cuda.synchronize()
        torch.cuda._sleep(LAUNCHES * 400_000)
        t0 = time.perf_counter()
        for _ in range(LAUNCHES):
            k1.bilinear_pass(sched, src, n_out, win)
        host_us = (time.perf_counter() - t0) / LAUNCHES * 1e6
        torch.cuda.synchronize()
        print(f"time_sequential_grid host us per K1 {name}-pass launch: {host_us!r}")
    print(gpu_name_and_power_limit())
    return 0


if __name__ == "__main__":
    sys.exit(main())
