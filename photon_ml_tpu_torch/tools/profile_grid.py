"""Where a λ-grid fit's time goes on one NVIDIA card, at the ads shape.

    python3 -m photon_ml_tpu_torch.tools.profile_grid [--seed 0]

Builds the planted-model logistic data of ``time_sequential_grid`` (2^18
rows x 64 nnz x 2^20 features), warms up with one fit, then traces the batched
L-BFGS grid (``train_grid_batched``) and the warm-started sequential grid
(``train_generalized_linear_model``) over λ in {10, 1, 0.1, 0.01} with 10
iterations and variances, each under ``torch.profiler``. For each it
prints the host seconds, the device time summed over the kernels, the
device's idle share (1 - busy / host seconds; kernels on one stream do
not overlap) and the kernels that took most of it, then the card's name
and power limit. It needs a CUDA card; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from photon_ml_tpu_torch.tools.time_sequential_grid import DIM, LAMBDAS, ads_batch

TOP = 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_grid: needs an NVIDIA card", file=sys.stderr)
        return 2

    from torch.profiler import ProfilerActivity, profile

    from photon_ml_tpu_torch.optim.config import OptimizerType, RegularizationType
    from photon_ml_tpu_torch.task import TaskType
    from photon_ml_tpu_torch.training import (
        train_generalized_linear_model,
        train_grid_batched,
    )
    from photon_ml_tpu_torch.utils.device import gpu_name_and_power_limit

    tb = ads_batch(args.seed)
    kw = dict(
        optimizer_type=OptimizerType.LBFGS,
        regularization_type=RegularizationType.L2,
        regularization_weights=LAMBDAS, max_iter=10, compute_variances=True,
        kernel="tiled", device="cuda",
    )
    task = TaskType.LOGISTIC_REGRESSION
    for trainer in (train_grid_batched, train_generalized_linear_model):
        trainer(tb, task, DIM, **kw)  # warm-up: builds, allocator, handles
    torch.cuda.synchronize()
    for label, trainer in (
        ("batched", train_grid_batched),
        ("sequential", train_generalized_linear_model),
    ):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer(tb, task, DIM, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        kernels = sorted(
            (e for e in prof.key_averages() if e.device_type.name == "CUDA"),
            key=lambda e: e.self_device_time_total, reverse=True,
        )
        busy_us = sum(e.self_device_time_total for e in kernels)
        print(f"profile_grid {label}: {seconds!r} s host, {busy_us / 1e6!r} s "
              f"device busy, idle share {1 - busy_us / 1e6 / seconds!r}",
              flush=True)
        for e in kernels[:TOP]:
            print(f"  {e.self_device_time_total / 1e3:.3f} ms in {e.count} "
                  f"calls: {e.key[:90]}")
    print(gpu_name_and_power_limit())
    return 0


if __name__ == "__main__":
    sys.exit(main())
