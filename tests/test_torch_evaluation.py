"""The port's evaluation (``evaluation/metrics.py``, ``evaluation/evaluator.py``)
and down-samplers (``data/sampler.py``) against the JAX package's.

Inputs are made with numpy from a seed: scores rounded to a coarse grid so
that many tie, weights with zeros (padding rows) and non-unit values, and
dense per-query group ids (some groups one-class, one group empty). Each
metric is computed by both packages in float32 on the same arrays:
AUC-type metrics (AUC, AUPR, precision@k, F1) within 1e-6 absolute, RMSE,
the losses and AIC within 1e-5 relative; the grouped AUC within 1e-12 in
float64 and within 1e-6 of that in float32 (see its test).

Samplers: given the reference's own keep draws (``jax.random.bernoulli``
with its key), the port's weight transform is bitwise the reference's.
The port's draws (a ``torch.Generator``) keep a fraction of the rows
within 4 sigma of the rate, and in binary mode every positive; and
``run_with_sampling`` fits the sampled batch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from photon_ml_tpu.data import sampler as ref_sampler
from photon_ml_tpu.evaluation import evaluator as ref_evaluator
from photon_ml_tpu.evaluation import metrics as ref_metrics
from photon_ml_tpu.ops import losses as ref_losses
from photon_ml_tpu.task import TaskType as RefTaskType
from photon_ml_tpu_torch.data import sampler
from photon_ml_tpu_torch.data.batch import make_sparse_batch
from photon_ml_tpu_torch.evaluation import evaluator, metrics
from photon_ml_tpu_torch.ops import losses
from photon_ml_tpu_torch.task import TaskType

N, GROUPS = 400, 17


def _case(seed):
    rng = np.random.default_rng(seed)
    scores = np.round(rng.normal(size=N) * 4) / 4  # ties
    labels = (rng.uniform(size=N) < 1 / (1 + np.exp(-scores))).astype(np.float32)
    weights = rng.uniform(0.2, 3.0, size=N)
    weights[rng.uniform(size=N) < 0.15] = 0.0  # padding rows
    groups = rng.integers(0, GROUPS - 1, size=N)  # group GROUPS - 1 is empty
    labels[groups == 3] = 1.0  # a one-class group
    return (scores.astype(np.float32), labels, weights.astype(np.float32),
            groups.astype(np.int32))


SEEDS = [0, 1, 2]


def _both(seed):
    s, y, w, g = _case(seed)
    return (s, y, w, g), (torch.as_tensor(s), torch.as_tensor(y), torch.as_tensor(w),
                          torch.as_tensor(g))


def _f(x) -> float:
    return float(np.asarray(x.detach().cpu() if torch.is_tensor(x) else x))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("unit_weights", [False, True])
def test_curve_metrics_match_reference(seed, unit_weights):
    (s, y, w, g), (ts, ty, tw, tg) = _both(seed)
    if unit_weights:
        w = (w > 0).astype(np.float32)
        tw = torch.as_tensor(w)
    for name in ("area_under_roc_curve", "area_under_precision_recall_curve", "f1_score"):
        args_ref = (s if name != "f1_score" else (s > 0).astype(np.float32), y, w)
        args = (ts if name != "f1_score" else (ts > 0).float(), ty, tw)
        want = _f(getattr(ref_metrics, name)(*map(jnp.asarray, args_ref)))
        got = _f(getattr(metrics, name)(*args))
        assert abs(got - want) <= 1e-6, (name, got, want)
    for k in (1, 5, 50, N + 3):
        want = _f(ref_metrics.precision_at_k(k, jnp.asarray(s), jnp.asarray(y), jnp.asarray(w)))
        got = _f(metrics.precision_at_k(k, ts, ty, tw))
        assert abs(got - want) <= 1e-6, (k, got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_grouped_metrics_match_reference(seed):
    """The grouped AUC takes each group's credit as a global cumulative sum
    less the group's base, so each package's float32 value carries up to
    ~1e-6 of its own rounding (8.5e-7 for the reference on seed 0). Both
    packages are therefore held in float64, to each other within 1e-12,
    and each float32 value within 1e-6 of that float64 value."""
    (s, y, w, g), (ts, ty, tw, tg) = _both(seed)
    with jax.enable_x64(True):
        truth = _f(ref_metrics.sharded_auc(
            jnp.asarray(g), *(jnp.asarray(a, jnp.float64) for a in (s, y, w)), GROUPS))
    port64 = _f(metrics.sharded_auc(tg, ts.double(), ty.double(), tw.double(), GROUPS))
    assert abs(port64 - truth) <= 1e-12
    want = _f(ref_metrics.sharded_auc(*map(jnp.asarray, (g, s, y, w)), GROUPS))
    got = _f(metrics.sharded_auc(tg, ts, ty, tw, GROUPS))
    assert abs(got - truth) <= 1e-6 and abs(want - truth) <= 1e-6, (got, want, truth)
    for k in (1, 3, 10):
        want = _f(ref_metrics.sharded_precision_at_k(k, *map(jnp.asarray, (g, s, y, w)), GROUPS))
        got = _f(metrics.sharded_precision_at_k(k, tg, ts, ty, tw, GROUPS))
        assert abs(got - want) <= 1e-6, (k, got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_losses_rmse_and_aic_match_reference(seed):
    (s, y, w, _), (ts, ty, tw, _) = _both(seed)
    pairs = [
        (ref_metrics.root_mean_squared_error(*map(jnp.asarray, (s, y, w))),
         metrics.root_mean_squared_error(ts, ty, tw)),
    ]
    for ref_loss, loss in ((ref_losses.LOGISTIC, losses.LOGISTIC),
                           (ref_losses.LINEAR, losses.LINEAR),
                           (ref_losses.POISSON, losses.POISSON),
                           (ref_losses.SMOOTHED_HINGE, losses.SMOOTHED_HINGE)):
        args = tuple(map(jnp.asarray, (s, y, w)))
        pairs.append((ref_metrics.mean_pointwise_loss(ref_loss, *args),
                      metrics.mean_pointwise_loss(loss, ts, ty, tw)))
        total, ref_total = (metrics.total_pointwise_loss(loss, ts, ty, tw),
                            ref_metrics.total_pointwise_loss(ref_loss, *args))
        pairs.append((ref_total, total))
        pairs.append((ref_metrics.akaike_information_criterion(ref_total, jnp.float32(9.0)),
                      metrics.akaike_information_criterion(total, 9.0)))
    for want, got in pairs:
        assert abs(_f(got) - _f(want)) <= 1e-5 * abs(_f(want)), (_f(got), _f(want))


EVALUATORS = ["AUC", "aupr", "RMSE", "LOGISTIC_LOSS", "squared_loss", "POISSON_LOSS",
              "SMOOTHED_HINGE_LOSS", "precision@3:queryId", "AUC:documentId"]


@pytest.mark.parametrize("text", EVALUATORS)
def test_evaluator_matches_reference(text):
    ref_t, t = ref_evaluator.EvaluatorType.parse(text), evaluator.EvaluatorType.parse(text)
    assert (t.name, t.k, t.id_type) == (ref_t.name, ref_t.k, ref_t.id_type)
    assert (t.render(), t.is_sharded, t.maximize) == (ref_t.render(), ref_t.is_sharded,
                                                       ref_t.maximize)
    assert t.better_than(1.0, 2.0) == ref_t.better_than(1.0, 2.0)
    assert evaluator.EvaluatorType.parse(t.render()) == t
    (s, y, w, g), (ts, ty, tw, tg) = _both(5)
    num_groups = GROUPS if t.is_sharded else None
    want = _f(ref_evaluator.Evaluator(ref_t, num_groups).evaluate(
        *map(jnp.asarray, (s, y, w)), jnp.asarray(g) if t.is_sharded else None))
    got = _f(evaluator.Evaluator(t, num_groups).evaluate(ts, ty, tw, tg if t.is_sharded else None))
    assert abs(got - want) <= max(1e-6, 1e-5 * abs(want)), (got, want)


def test_evaluator_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError):
        evaluator.EvaluatorType.parse("NDCG")
    with pytest.raises(ValueError, match="group_ids"):
        evaluator.Evaluator(evaluator.EvaluatorType.parse("AUC:q")).evaluate(
            torch.zeros(2), torch.zeros(2), torch.ones(2))


def test_select_best_model_matches_reference():
    metric = {1.0: 0.7, 0.1: 0.9, 10.0: 0.9, 0.01: 0.2}
    for maximize in (True, False):
        got = evaluator.select_best_model(metric, lambda m: m, maximize)
        want = ref_evaluator.select_best_model(metric, lambda m: m, maximize)
        assert got == want


# -- samplers -----------------------------------------------------------------

TASKS = [("LOGISTIC_REGRESSION", True), ("SMOOTHED_HINGE_LOSS_LINEAR_SVM", True),
         ("LINEAR_REGRESSION", False), ("POISSON_REGRESSION", False)]


@pytest.mark.parametrize("task,binary", TASKS)
@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_sampler_weights_given_the_reference_draws_are_bitwise(task, binary, rate):
    _, y, w, _ = _case(11)
    key = jax.random.PRNGKey(7)
    want = np.asarray(ref_sampler.down_sample_weights(
        key, jnp.asarray(y), jnp.asarray(w), rate, RefTaskType[task]))
    keep = torch.as_tensor(np.array(jax.random.bernoulli(key, rate, w.shape)))
    got = sampler.weights_from_keep(
        keep, torch.as_tensor(y), torch.as_tensor(w), rate, TaskType[task]).numpy()
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("task,binary", TASKS)
def test_port_draws_keep_the_rate_and_every_positive(task, binary):
    n, rate = 20000, 0.3
    rng = np.random.default_rng(3)
    y = torch.as_tensor((rng.uniform(size=n) < 0.4).astype(np.float32))
    w = torch.ones(n)
    gen = torch.Generator().manual_seed(5)
    out = sampler.down_sample_weights(gen, y, w, rate, TaskType[task])
    sampled = (y <= 0.5) if binary else torch.ones(n, dtype=torch.bool)
    kept = float(((out > 0) & sampled).sum()) / float(sampled.sum())
    sigma = (rate * (1 - rate) / float(sampled.sum())) ** 0.5
    assert abs(kept - rate) <= 4 * sigma
    assert torch.all((out == 0) | (out == w / rate) | ((y > 0.5) & (out == w)))
    if binary:
        assert torch.equal(out[y > 0.5], w[y > 0.5])
    again = sampler.down_sample_weights(
        torch.Generator().manual_seed(5), y, w, rate, TaskType[task])
    assert torch.equal(again, out)  # the draw is the generator's


def test_down_sample_replaces_only_the_weights():
    rows = [([0, 2], [1.0, 2.0]), ([1], [0.5]), ([2], [1.5])]
    batch = make_sparse_batch(rows, [1.0, 0.0, 0.0], device="cpu")
    out = sampler.down_sample(torch.Generator().manual_seed(0), batch, 0.5,
                              TaskType.LOGISTIC_REGRESSION)
    assert out.indices is batch.indices and out.values is batch.values
    assert float(out.weights[0]) == 1.0  # the positive is kept as it is


def test_run_with_sampling_fits_the_sampled_batch():
    """``GLMOptimizationProblem.run_with_sampling`` is ``run`` on the task
    sampler's batch (the same generator draws), and ``run`` itself at a
    rate of 1."""
    from photon_ml_tpu_torch.optim.problem import create_glm_problem
    from tests.torch_mesh_cases import D, planted_problem

    rows, labels, weights = planted_problem(12)
    batch = make_sparse_batch(rows, labels, weights=weights, device="cpu")
    problem = create_glm_problem(TaskType.LOGISTIC_REGRESSION, D)
    sampled, _ = problem.run_with_sampling(
        batch, torch.Generator().manual_seed(4), 0.5, reg_weight=1.0)
    by_hand, _ = problem.run(
        sampler.down_sample(torch.Generator().manual_seed(4), batch, 0.5,
                            TaskType.LOGISTIC_REGRESSION), reg_weight=1.0)
    assert torch.equal(sampled.means, by_hand.means)
    whole, _ = problem.run_with_sampling(batch, torch.Generator(), 1.0, reg_weight=1.0)
    assert torch.equal(whole.means, problem.run(batch, reg_weight=1.0)[0].means)
    assert not torch.equal(sampled.means, whole.means)
