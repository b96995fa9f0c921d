"""Where a λ-grid fit's time goes on one NVIDIA card, at the ads shape.

    python3 -m photon_ml_tpu_torch.tools.profile_grid [--seed 0]

Builds the planted-model logistic data of ``time_sequential_grid`` (2^18
rows x 64 nnz x 2^20 features), warms up with one fit, then traces the batched
L-BFGS grid (``train_grid_batched``) and the warm-started sequential grid
(``train_generalized_linear_model``) over λ in {10, 1, 0.1, 0.01} with 10
iterations and variances, each under ``torch.profiler``. For each it
prints the host seconds, the device time summed over the kernels, the
device's idle share (1 - busy / host seconds; kernels on one stream do
not overlap), the kernels that took most of it and the host calls that
took most of the host's time, then the card's name and power limit. Run
as a file with another checkout first on ``PYTHONPATH``, it profiles that
checkout. It needs a CUDA card; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from photon_ml_tpu_torch.tools.time_sequential_grid import DIM, LAMBDAS, ads_batch

TOP = 8


def profile_fits(tb, dim, kw, say=print) -> dict:
    """Trace the batched and the warm-started sequential grid on ``tb``
    (``dim`` features) with the trainers' keywords ``kw``, after one warm-up fit of each;
    print each one's host seconds, device busy time, idle share, top
    kernels and the host calls that took the most host time; -> {label: (host s, busy s, idle share)}."""
    from torch.profiler import ProfilerActivity, profile

    from photon_ml_tpu_torch.task import TaskType
    from photon_ml_tpu_torch.training import (
        train_generalized_linear_model,
        train_grid_batched,
    )

    task = TaskType.LOGISTIC_REGRESSION
    for trainer in (train_grid_batched, train_generalized_linear_model):
        trainer(tb, task, dim, **kw)  # warm-up: builds, allocator, handles
    torch.cuda.synchronize()
    out = {}
    for label, trainer in (
        ("batched", train_grid_batched),
        ("sequential", train_generalized_linear_model),
    ):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer(tb, task, dim, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        kernels = sorted(
            (e for e in prof.key_averages() if e.device_type.name == "CUDA"),
            key=lambda e: e.self_device_time_total, reverse=True,
        )
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        out[label] = (seconds, busy, 1 - busy / seconds)
        say(f"profile_grid {label}: {seconds!r} s host, {busy!r} s device "
            f"busy, idle share {1 - busy / seconds!r}")
        for e in kernels[:TOP]:
            say(f"  {e.self_device_time_total / 1e3:.3f} ms in {e.count} "
                f"calls: {e.key[:90]}")
        host = sorted(
            (e for e in prof.key_averages() if e.device_type.name == "CPU"),
            key=lambda e: e.self_cpu_time_total, reverse=True,
        )
        say(f"profile_grid {label} host calls by self time:")
        for e in host[:TOP]:
            say(f"  {e.self_cpu_time_total / 1e3:.3f} ms in {e.count} calls: {e.key[:90]}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_grid: needs an NVIDIA card", file=sys.stderr)
        return 2

    from photon_ml_tpu_torch.optim.config import OptimizerType, RegularizationType
    from photon_ml_tpu_torch.utils.device import gpu_name_and_power_limit

    profile_fits(ads_batch(args.seed), DIM, dict(
        optimizer_type=OptimizerType.LBFGS,
        regularization_type=RegularizationType.L2,
        regularization_weights=LAMBDAS, max_iter=10, compute_variances=True,
        kernel="tiled", device="cuda",
    ))
    print(gpu_name_and_power_limit())
    return 0


if __name__ == "__main__":
    sys.exit(main())
