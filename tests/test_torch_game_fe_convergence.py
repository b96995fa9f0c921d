"""GAME's tiled and scatter coordinate descent at a fixed-effect cap and
run to convergence, in the port and in the JAX package (ROADMAP Queue 3,
PR 7's open item).

On the card, run G's tiled and scatter CD objectives parted by 6.6e-2
after sweep 1, both fixed-effect fits stopping at their 50-iteration cap.
Here, at a small GLMix with an ill-conditioned global shard (feature
popularity ~ 1 / rank^1.1, so rare features leave flat directions), the
JAX package's own tiled and scatter paths part at a reached cap too: the
gap is the two summation orders' float32 trajectories stopping at
different points, not a fault of the port. With a cap the fits do not
reach and a stop below float32's resolution of the objective (tolerance
1e-10; at the default 1e-7 an L-BFGS fit may stop on one slow step, and
on the card run G's did, 1.2e-4 apart), the port's tiled and scatter CD
objectives agree within 1e-4, and each agrees with the JAX package's
within 1e-4.

``python -m tests.test_torch_game_fe_convergence`` (from the repo root,
on the CPU) prints the relative gaps of both packages at caps of 5, 50
and 500, and at 500 with the tolerance 1e-10.
"""

import numpy as np
import pytest

from photon_ml_tpu.game import CoordinateDescent as RefCD
from photon_ml_tpu.game import FixedEffectCoordinate as RefFE
from photon_ml_tpu.game import RandomEffectCoordinate as RefRE
from photon_ml_tpu.game import RandomEffectDataConfiguration as RefREConfig
from photon_ml_tpu.game import RandomEffectOptimizationProblem as RefREProblem
from photon_ml_tpu.game import build_random_effect_dataset as ref_build_re
from photon_ml_tpu.ops.losses import LOGISTIC as REF_LOGISTIC
from photon_ml_tpu.optim.config import OptimizerConfig as RefOptConfig
from photon_ml_tpu.optim.config import RegularizationContext as RefReg
from photon_ml_tpu.optim.config import RegularizationType as RefRegType
from photon_ml_tpu.optim.problem import create_glm_problem as ref_create_problem
from photon_ml_tpu.task import TaskType as RefTask
from photon_ml_tpu_torch.game import (
    CoordinateDescent,
    FixedEffectCoordinate,
    RandomEffectCoordinate,
    RandomEffectDataConfiguration,
    RandomEffectOptimizationProblem,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.ops.losses import LOGISTIC
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.optim.problem import create_glm_problem
from photon_ml_tpu_torch.task import TaskType
from tests.torch_game_cases import both_datasets

N, USERS, D_GLOBAL, K = 2000, 40, 300, 8
FE_TOL = 1e-7  # the trainers' default: an L-BFGS stop on one slow step
# "converged": an iteration that moves the objective by under 1e-10 of its
# start, below float32's resolution of it; the cap is not reached
CONVERGED_TOL, CONVERGED_CAP = 1e-10, 500
GAP_RTOL = 1e-4


def _records(seed=0, d_user=4):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, D_GLOBAL + 1) ** 1.1
    p /= p.sum()
    w_global = rng.normal(size=D_GLOBAL)
    w_user = rng.normal(size=(USERS, d_user))
    recs = []
    for i in range(N):
        u = int(rng.integers(0, USERS))
        ix = rng.choice(D_GLOBAL, size=K, replace=False, p=p)
        xg = rng.normal(size=K) + 1.0
        xu = rng.normal(size=d_user)
        z = float(xg @ w_global[ix] * 0.5 + xu @ w_user[u])
        recs.append({
            "uid": f"r{i}", "response": float(1 / (1 + np.exp(-z)) > rng.uniform()),
            "userId": f"user{u:03d}",
            "features": [{"name": f"g{j}", "term": "", "value": float(v)}
                         for j, v in zip(ix, xg)],
            "userFeatures": [{"name": f"u{j}", "term": "", "value": float(xu[j])}
                             for j in range(d_user)],
        })
    return recs


def _runs(cap, datasets, tol=FE_TOL):
    """-> {kernel: (reference CD result, port CD result)} after 2 sweeps of
    the fixed effect (capped at ``cap`` iterations, stopping at ``tol``)
    and a user random effect."""
    ref_ds, port_ds = datasets
    shard = port_ds.shards["globalShard"]
    out = {}
    for kernel in ("scatter", "tiled"):
        ref_coords = {
            "global": RefFE(
                name="global", dataset=ref_ds, feature_shard_id="globalShard", reg_weight=0.1,
                problem=ref_create_problem(
                    RefTask.LOGISTIC_REGRESSION, shard.dim, kernel=kernel,
                    config=RefOptConfig(max_iter=cap, tolerance=tol),
                    regularization=RefReg(RefRegType.L2), intercept_index=shard.intercept_index,
                ),
            ),
            "per-userId": RefRE(
                name="per-userId", dataset=ref_ds,
                re_dataset=ref_build_re(ref_ds, RefREConfig("userId", "userShard")),
                problem=RefREProblem(REF_LOGISTIC, RefOptConfig(max_iter=60, tolerance=1e-9),
                                     RefReg(RefRegType.L2), reg_weight=1.0),
            ),
        }
        coords = {
            "global": FixedEffectCoordinate(
                name="global", dataset=port_ds, feature_shard_id="globalShard", reg_weight=0.1,
                problem=create_glm_problem(
                    TaskType.LOGISTIC_REGRESSION, shard.dim, kernel=kernel,
                    config=OptimizerConfig(max_iter=cap, tolerance=tol),
                    regularization=RegularizationContext(RegularizationType.L2),
                    intercept_index=shard.intercept_index,
                ),
            ),
            "per-userId": RandomEffectCoordinate(
                name="per-userId", dataset=port_ds,
                re_dataset=build_random_effect_dataset(
                    port_ds, RandomEffectDataConfiguration("userId", "userShard")),
                problem=RandomEffectOptimizationProblem(
                    LOGISTIC, OptimizerConfig(max_iter=60, tolerance=1e-9),
                    RegularizationContext(RegularizationType.L2), reg_weight=1.0),
            ),
        }
        out[kernel] = (
            RefCD(ref_coords, ref_ds, RefTask.LOGISTIC_REGRESSION).run(2),
            CoordinateDescent(coords, port_ds, TaskType.LOGISTIC_REGRESSION).run(2),
        )
    return out


def _gaps(runs):
    """-> (reference tiled vs scatter, port tiled vs scatter), relative, per
    sweep."""
    def rel(a, b):
        a, b = np.asarray(a.objective_history), np.asarray(b.objective_history)
        return np.abs(a - b) / np.abs(b)

    (rs, ps), (rt, pt) = runs["scatter"], runs["tiled"]
    return rel(rt, rs), rel(pt, ps)


@pytest.fixture(scope="module")
def datasets():
    return both_datasets(_records(), ("userId",))


def test_converged_fixed_effects_close_the_gap(datasets):
    runs = _runs(CONVERGED_CAP, datasets, CONVERGED_TOL)
    for kernel, (ref, port) in runs.items():
        fits = port.trackers["global"]
        assert fits and all(t.iterations < CONVERGED_CAP for t in fits), kernel
        assert all(t.reason_name != "MaxIterations" for t in fits), kernel
        np.testing.assert_allclose(port.objective_history, ref.objective_history,
                                   rtol=GAP_RTOL)
    ref_gap, port_gap = _gaps(runs)
    assert max(port_gap) <= GAP_RTOL and max(ref_gap) <= GAP_RTOL


def test_the_reference_parts_at_a_reached_cap_too(datasets):
    """At a cap both paths reach, the JAX package's tiled and scatter CD
    part as the port's do (neither is zero), and the fits stop on the cap."""
    runs = _runs(50, datasets)
    assert all(t.reason_name == "MaxIterations"
               for t in runs["tiled"][1].trackers["global"][:1])
    ref_gap, port_gap = _gaps(runs)
    assert max(ref_gap) > 0 and max(port_gap) > 0


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    data = both_datasets(_records(), ("userId",))
    for cap, tol in ((5, FE_TOL), (50, FE_TOL), (CONVERGED_CAP, FE_TOL),
                     (CONVERGED_CAP, CONVERGED_TOL)):
        ref_gap, port_gap = _gaps(_runs(cap, data, tol))
        print(f"cap {cap}, tolerance {tol}: tiled vs scatter CD objective, relative gap "
              f"per sweep: JAX package {ref_gap.tolist()}, port {port_gap.tolist()}")
