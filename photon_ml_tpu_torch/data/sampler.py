"""Down-samplers as row-weight masks (port of
``photon_ml_tpu/data/sampler.py``).

Reference: photon-ml .../sampler/DownSampler.scala,
BinaryClassificationDownSampler.scala:89-109 (negatives only, kept weights
rescaled by 1/rate) and DefaultDownSampler.scala (uniform, for regression).

Rows are masked in place rather than dropped: a dropped row gets weight 0
(padding semantics) and a kept row's weight is divided by the rate, so the
objective stays an unbiased estimate and the batch keeps its shape (a tiled
batch keeps its schedules). Each draw comes from an explicit
``torch.Generator``; the weight transform given a keep mask is a function
of its own (:func:`weights_from_keep`), so a test can feed it the JAX
package's draws.
"""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_tpu_torch.task import TaskType

Tensor = torch.Tensor

# Tasks whose sampler keeps every positive (BinaryClassificationDownSampler).
_BINARY_TASKS = (TaskType.LOGISTIC_REGRESSION, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM)


def bernoulli_keep(generator: torch.Generator, like: Tensor, rate) -> Tensor:
    """A keep mask shaped like ``like``: each row kept with probability
    ``rate``, drawn on the generator's device."""
    u = torch.rand(like.shape, generator=generator, device=generator.device)
    return (u < rate).to(like.device)


def default_weights(keep: Tensor, weights: Tensor, rate) -> Tensor:
    """Uniform sampling: kept rows' weights / rate, dropped rows 0."""
    return torch.where(keep, weights / rate, torch.zeros_like(weights))


def binary_weights(keep: Tensor, labels: Tensor, weights: Tensor, rate) -> Tensor:
    """Every positive kept as it is; negatives by ``keep``, rescaled."""
    return torch.where(labels > 0.5, weights, default_weights(keep, weights, rate))


def weights_from_keep(
    keep: Tensor, labels: Tensor, weights: Tensor, rate, task: TaskType
) -> Tensor:
    """The task's weight transform given a keep mask (the draws)."""
    if task in _BINARY_TASKS:
        return binary_weights(keep, labels, weights, rate)
    return default_weights(keep, weights, rate)


def down_sample_weights(
    generator: torch.Generator, labels: Tensor, weights: Tensor, rate,
    task: TaskType,
) -> Tensor:
    """The samplers' weight transform with its own draw: [n] -> [n]."""
    keep = bernoulli_keep(generator, weights, rate)
    return weights_from_keep(keep, labels, weights, rate, task)


def default_down_sample(generator: torch.Generator, batch, rate):
    """Uniform row down-sampling with the 1/rate weight rescale."""
    keep = bernoulli_keep(generator, batch.weights, rate)
    return dataclasses.replace(batch, weights=default_weights(keep, batch.weights, rate))


def binary_classification_down_sample(generator: torch.Generator, batch, rate):
    """Keep every positive; keep negatives with probability ``rate`` and
    rescale their weight by 1/rate."""
    keep = bernoulli_keep(generator, batch.weights, rate)
    return dataclasses.replace(
        batch, weights=binary_weights(keep, batch.labels, batch.weights, rate)
    )


def down_sample(generator: torch.Generator, batch, rate, task: TaskType):
    """The task's sampler (DownSampler factory semantics) over a
    SparseBatch or TiledSparseBatch."""
    return dataclasses.replace(
        batch,
        weights=down_sample_weights(generator, batch.labels, batch.weights, rate, task),
    )
