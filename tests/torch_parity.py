"""Parity helpers for the PyTorch port's tests (``tests/test_torch_*.py``).

The same inputs, made with numpy from a seed, go to the JAX package (the
reference) and to ``photon_ml_tpu_torch``; arrays cross between the two
only as numpy arrays. Every comparison states its tolerance at the call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_ml_tpu.data.batch import make_sparse_batch as ref_make_sparse_batch
from photon_ml_tpu_torch.convert import tiled_batch_from_reference
from photon_ml_tpu_torch.data.batch import make_sparse_batch


def to_np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(actual, expected, *, rtol: float, atol: float = 0.0):
    """|actual - expected| <= atol + rtol * |expected|, elementwise."""
    np.testing.assert_allclose(to_np(actual), to_np(expected), rtol=rtol, atol=atol)


def assert_close_to_scale(actual, expected, *, rtol: float, atol: float = 0.0):
    """|actual - expected| <= atol + rtol * max|expected| (normwise): the
    form for sums taken in another order, whose error scales with the
    output's magnitude rather than each element's."""
    a, e = to_np(actual), to_np(expected)
    scale = float(np.max(np.abs(e))) if e.size else 0.0
    np.testing.assert_allclose(a, e, rtol=0.0, atol=atol + rtol * scale)


def random_rows(rng, n=100, d=150, k=6, intercept=True):
    """Random sparse rows (as the reference's tiled tests make them): 1..k
    features per row plus, with ``intercept``, feature d-1 in every row."""
    rows, labels = [], []
    for _ in range(n):
        nnz = int(rng.integers(1, k + 1))
        ix = rng.choice(d - 1, size=nnz, replace=False).tolist()
        vs = rng.normal(size=nnz).tolist()
        if intercept:
            ix.append(d - 1)
            vs.append(1.0)
        labels.append(float(rng.uniform() > 0.5))
        rows.append((ix, vs))
    return rows, labels


def both_batches(rows, labels, weights=None, offsets=None):
    """-> (reference SparseBatch, port SparseBatch on the CPU)."""
    ref = ref_make_sparse_batch(rows, labels, offsets, weights)
    port = make_sparse_batch(rows, labels, offsets, weights, device="cpu")
    return ref, port


def port_tiled_batch(ref_tb):
    """The reference TiledSparseBatch, carried into the port on the CPU."""
    return tiled_batch_from_reference(
        dataclasses.asdict(ref_tb.meta),
        [np.asarray(a) for a in ref_tb.z_sched],
        [np.asarray(a) for a in ref_tb.g_sched],
        np.asarray(ref_tb.g_vals_sq),
        np.asarray(ref_tb.labels),
        np.asarray(ref_tb.offsets),
        np.asarray(ref_tb.weights),
        device="cpu",
    )


def training_examples(seed, n=60, d=12):
    """TrainingExampleAvro records with nulls, weights, offsets, metadata
    and an empty feature bag among them."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        k = int(rng.integers(0, 5))
        ix = rng.choice(d, size=k, replace=False)
        recs.append({
            "uid": None if i % 7 == 0 else f"u{i}",
            "label": float(rng.integers(0, 2)),
            "features": [
                {"name": f"f{j}", "term": "t" if j % 3 else "", "value": float(v)}
                for j, v in zip(ix, rng.normal(size=k))
            ],
            "metadataMap": None if i % 2 else {"k": f"v{i}"},
            "weight": None if i % 5 == 0 else float(rng.uniform(0.5, 2.0)),
            "offset": None if i % 4 == 0 else float(rng.normal()),
        })
    return recs


def clear_reference_pod_programs():
    """Drop the JAX package's compiled entity-sharded programs. Its
    ``game/pod.py`` caches them by (mesh, solver kind) and not by the
    problem's optimizer settings, so a program another test built for
    another configuration on a mesh of the same shape (in the same
    process: a pytest worker runs many files) would answer for this one."""
    from photon_ml_tpu.game import pod

    pod._PROGRAM_CACHE.clear()
