"""Spread of the GAME fixed-effect fit between identical runs on one NVIDIA card.

    python3 -m photon_ml_tpu_torch.tools.fe_spread [--seed 0]

Builds the fixed effect of ``chip_smoke.py``'s run G from the same seed
stream (100,000 users x 16 rows; 2^20 global features, 64 a row and the
intercept; planted-model logistic labels with per-user effects) and fits
it from zero, as a coordinate-descent sweep's first fixed-effect update
does: L-BFGS, L2 1, with a budget of 50 iterations (run G's) and of 1000
(the fit then stops on its tolerance, 1e-7). Each budget runs REPEATS
times through the tiled objective (K1, K3) and through the scatter
objective (``data/batch.py``'s fixed-order scatter-add), with
``torch.use_deterministic_algorithms`` left off: every sum on both paths
comes in a fixed order of its own. Each fit prints its iterations, stop
reason, objective, gradient norm and seconds; each budget and objective
prints the spread of the objectives, (max - min) / min, and of the
coefficients, max |c - c_0| / max |c_0|, then the gap between the two
objectives' mean values. The script fails unless every repeat ends
bitwise equal to the first. Last, the card's name and power limit. It
needs a CUDA card; it imports nothing of JAX.
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
    same = True
    for max_iter in BUDGETS:
        means = {}
        for kernel in ("tiled", "scatter"):
            values, coefs = [], []
            for r in range(REPEATS):
                result, seconds, coef = fit(batch, kernel, max_iter)
                values.append(report(f"{kernel} max_iter {max_iter} run {r}", result, seconds))
                coefs.append(coef)
            spread = max(float((c - coefs[0]).abs().max()) for c in coefs)
            bitwise = all(torch.equal(c, coefs[0]) for c in coefs)
            same = same and bitwise
            means[kernel] = sum(values) / len(values)
            print(f"spread {kernel} max_iter {max_iter}: objective "
                  f"{(max(values) - min(values)) / min(values)!r}, coefficients "
                  f"{spread / float(coefs[0].abs().max())!r}; every repeat bitwise {bitwise}",
                  flush=True)
        print(f"tiled vs scatter max_iter {max_iter}: objective gap "
              f"{abs(means['tiled'] - means['scatter']) / means['scatter']!r}", flush=True)
    print(f"card: {gpu_name_and_power_limit()}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
