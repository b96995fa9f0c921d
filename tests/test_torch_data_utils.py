"""The port's feature statistics and data validators against the JAX
package's: ``compute_summary`` (and the moments it is made of) within rtol
1e-6 (f32 sums taken in another order), ``validation_failures`` and
``sanity_check_data`` giving the same counts and decisions on clean and
broken batches at every validation level.
"""

import math

import numpy as np
import pytest

from photon_ml_tpu.data import stats as ref_stats
from photon_ml_tpu.data import validators as ref_validators
from photon_ml_tpu.task import TaskType as RefTaskType
from photon_ml_tpu_torch.data import stats, validators
from photon_ml_tpu_torch.task import TaskType

from tests.torch_parity import both_batches, random_rows

D = 40


def _batches(seed, labels=None, offsets=None, mutate=None, n=90):
    rng = np.random.default_rng(seed)
    rows, labs = random_rows(rng, n=n, d=D, k=6)
    if mutate is not None:
        mutate(rows)
    weights = rng.uniform(0.5, 2.0, size=n).tolist()
    weights[3] = 0.0  # a real row with weight 0 counts as padding
    return both_batches(rows, labels if labels is not None else labs, weights, offsets)


SUMMARY_FIELDS = ("mean", "variance", "count", "num_nonzeros", "max", "min",
                  "norm_l1", "norm_l2", "mean_abs")


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_summary_matches_reference(seed):
    def spice(rows):
        # explicit zeros, negative-only and positive-only columns
        rows[0][1][0] = 0.0
        for ix, vs in rows:
            for j, i in enumerate(ix):
                if i == 5:
                    vs[j] = -abs(vs[j])
                elif i == 6:
                    vs[j] = abs(vs[j]) + 1.0

    ref_batch, batch = _batches(seed, mutate=spice)
    got = stats.compute_summary(batch, D)
    want = ref_stats.compute_summary(ref_batch, D)
    for name in SUMMARY_FIELDS:
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=1e-6, atol=1e-6, err_msg=name,
        )
    np.testing.assert_allclose(got.std.numpy(), np.asarray(want.std), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.max_magnitude.numpy(), np.asarray(want.max_magnitude),
                               rtol=1e-6)


def test_sparse_moments_and_finalize_match_reference():
    """Two chunks' moments summed (max/min taken) and finalized once give
    the reference's numbers; untouched features get the +-inf sentinels."""
    parts, ref_parts = [], []
    for seed in (3, 4):
        ref_batch, batch = _batches(seed, n=40)
        parts.append(stats.sparse_moments(batch, D + 5))
        ref_parts.append(ref_stats.sparse_moments(ref_batch, D + 5))
    for got, want in zip(parts[0], ref_parts[0]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert float(parts[0][5][-1]) == -math.inf and float(parts[0][6][-1]) == math.inf

    def fold(ps, maximum, minimum):
        summed = [ps[0][i] + ps[1][i] for i in range(5)]
        return summed + [maximum(ps[0][5], ps[1][5]), minimum(ps[0][6], ps[1][6])]

    import torch

    got = stats.finalize_summary(*fold(parts, torch.maximum, torch.minimum))
    want = ref_stats.finalize_summary(*fold(ref_parts, np.maximum, np.minimum))
    for name in SUMMARY_FIELDS:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def _break_feature(rows):
    rows[7][1][0] = float("nan")


def _break_offsets(n=90):
    off = [0.0] * n
    off[11] = float("inf")
    off[3] = float("nan")  # on the weight-0 row: not counted
    return off


CASES = {
    "clean": dict(),
    "nan_feature": dict(mutate=_break_feature),
    "inf_offset": dict(offsets=_break_offsets()),
    "labels": dict(labels=[2.0, -1.0, 0.5] + [1.0] * 87),
}
TASKS = ["LOGISTIC_REGRESSION", "POISSON_REGRESSION", "LINEAR_REGRESSION",
         "SMOOTHED_HINGE_LOSS_LINEAR_SVM"]


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_validators_match_reference(case, task):
    ref_batch, batch = _batches(5, **CASES[case])
    got = validators.validation_failures(batch, TaskType(task))
    want = ref_validators.validation_failures(ref_batch, RefTaskType(task))
    assert got == want
    assert (case == "clean") <= (got == {})
    for level in ("VALIDATE_FULL", "VALIDATE_SAMPLE", "VALIDATE_DISABLED"):
        outcomes = []
        for mod, t, b in ((validators, TaskType(task), batch),
                          (ref_validators, RefTaskType(task), ref_batch)):
            try:
                mod.sanity_check_data(b, t, mod.DataValidationType.parse(level))
                outcomes.append(None)
            except mod.DataValidationError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1], level
