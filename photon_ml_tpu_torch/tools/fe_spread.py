"""Spread of the GAME fixed-effect fit between identical runs on one NVIDIA card.

    python3 -m photon_ml_tpu_torch.tools.fe_spread [--seed 0]

Builds the fixed effect of ``chip_smoke.py``'s run G from the same seed
stream (100,000 users x 16 rows; 2^20 global features, 64 a row and the
intercept; planted-model logistic labels with per-user effects) and fits
it from zero, as a coordinate-descent sweep's first fixed-effect update
does: L-BFGS, L2 1, with a budget of 50 iterations (run G's) and of 1000
(the fit then stops on its tolerance, 1e-7). Each budget runs REPEATS
times through the tiled objective (K1) and through the
scatter objective (``index_add_``); then two 50-iteration fits run through
the scatter objective under ``torch.use_deterministic_algorithms(True)``.
Each fit prints its iterations, stop reason, objective, gradient norm and
seconds; each budget and objective prints the spread of the objectives,
(max - min) / min. The script fails unless the two deterministic fits end
bitwise equal. Last, the card's name and power limit. It needs a CUDA
card; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

DIM = 1 << 20
USERS = 100_000
ROWS_PER_USER = 16
NNZ = 64
USER_NNZ = 32
USER_POOL = 1000
BUDGETS = (50, 1000)
REPEATS = 6


def fe_batch(seed: int, device):
    """Run G's global shard as a SparseBatch: the draws of
    ``chip_smoke.game_model`` and ``game_rows`` in their order."""
    from photon_ml_tpu_torch.data.batch import sparse_batch_from_arrays

    rng = np.random.default_rng([seed, 3])
    w_global = (rng.normal(size=DIM) * 0.3).astype(np.float32)
    w_user = (rng.normal(size=(USERS, USER_POOL)) * 0.3).astype(np.float32)
    users = np.repeat(np.arange(USERS), ROWS_PER_USER)
    n = len(users)
    g_idx = rng.integers(0, DIM - 1, size=(n, NNZ))
    g_val = rng.normal(size=(n, NNZ)).astype(np.float32)
    picks = rng.integers(0, USER_POOL, size=(n, USER_NNZ))
    u_val = rng.normal(size=(n, USER_NNZ)).astype(np.float32)
    z = (g_val * w_global[g_idx]).sum(1) + (u_val * w_user[users[:, None], picks]).sum(1)
    labels = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    width = (NNZ + 1 + 7) // 8 * 8
    idx = np.zeros((n, width), np.int32)
    val = np.zeros((n, width), np.float32)
    idx[:, :NNZ], val[:, :NNZ] = g_idx, g_val
    idx[:, NNZ], val[:, NNZ] = DIM - 1, 1.0
    ones = np.ones(n, np.float32)
    return sparse_batch_from_arrays(idx, val, labels, np.zeros(n, np.float32), ones,
                                    device=device)


def fit(batch, kernel: str, max_iter: int):
    """One fit from zero; -> (OptResult, seconds, coefficients)."""
    from photon_ml_tpu_torch.optim.config import (
        OptimizerConfig,
        RegularizationContext,
        RegularizationType,
    )
    from photon_ml_tpu_torch.optim.problem import create_glm_problem
    from photon_ml_tpu_torch.task import TaskType

    problem = create_glm_problem(
        TaskType.LOGISTIC_REGRESSION, DIM, config=OptimizerConfig(max_iter=max_iter),
        regularization=RegularizationContext(RegularizationType.L2),
        intercept_index=DIM - 1, kernel=kernel,
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coefficients, result = problem.run(batch, reg_weight=1.0)
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, coefficients.means


def report(label, result, seconds):
    value = float(result.value)
    print(f"{label}: {result.iterations} iterations, {result.reason_name}, objective "
          f"{value!r}, gradient norm {float(result.grad_norm)!r}, {seconds!r} s", flush=True)
    return value


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fe_spread: CUDA is not available", file=sys.stderr)
        return 2
    from photon_ml_tpu_torch.ops.kernels import bilinear_pass as k1
    from photon_ml_tpu_torch.utils.device import gpu_name_and_power_limit

    torch.backends.cuda.matmul.allow_tf32 = False
    k1.build_kernel()
    batch = fe_batch(args.seed, "cuda")
    for max_iter in BUDGETS:
        for kernel in ("tiled", "scatter"):
            values = [
                report(f"{kernel} max_iter {max_iter} run {r}", *fit(batch, kernel, max_iter)[:2])
                for r in range(REPEATS)
            ]
            print(f"spread {kernel} max_iter {max_iter}: "
                  f"{(max(values) - min(values)) / min(values)!r}", flush=True)
    torch.use_deterministic_algorithms(True)
    runs = [fit(batch, "scatter", BUDGETS[0]) for _ in range(2)]
    for r, (result, seconds, _) in enumerate(runs):
        report(f"deterministic scatter max_iter {BUDGETS[0]} run {r}", result, seconds)
    same = torch.equal(runs[0][2], runs[1][2]) and torch.equal(runs[0][0].value, runs[1][0].value)
    print(f"deterministic scatter fits bitwise equal: {same}", flush=True)
    print(f"card: {gpu_name_and_power_limit()}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
