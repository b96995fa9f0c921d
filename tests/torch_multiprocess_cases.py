"""Rank functions of the port's multi-process tests (mesh trainers with
λ snapshots, the streamed feature-sharded trainer). Imports neither JAX
nor the reference: a spawned rank re-imports this module."""

import numpy as np

from photon_ml_tpu_torch.data.batch import make_sparse_batch
from photon_ml_tpu_torch.reliability.checkpoint import GridCheckpointer
from photon_ml_tpu_torch.task import TaskType
from photon_ml_tpu_torch.training import train_generalized_linear_model

DIM = 30


def glm_rows(seed=42, n=400, k=4):
    rng = np.random.default_rng(seed)
    ix = rng.integers(0, DIM, size=(n, k)).astype(np.int32)
    vs = rng.normal(size=(n, k)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return [(ix[i].tolist(), vs[i].tolist()) for i in range(n)], y.tolist()


def mesh_checkpoint_fit(mesh, ckpt_dir, config):
    """The data-parallel λ sweep [10, 1] on this rank with per-λ
    snapshots: -> {λ: coefficients} as numpy."""
    rows, labels = glm_rows()
    batch = make_sparse_batch(rows, labels, device="cpu")
    models, _ = train_generalized_linear_model(
        batch, TaskType.LOGISTIC_REGRESSION, DIM, regularization_weights=[10.0, 1.0],
        mesh=mesh, grid_checkpointer=GridCheckpointer(ckpt_dir, config),
    )
    return {lam: m.means.cpu().numpy() for lam, m in models.items()}


def _stream_inputs(root, store):
    from photon_ml_tpu_torch.io.input_format import AvroInputDataFormat
    from photon_ml_tpu_torch.utils.native_index import load_offheap_index_map

    imap = None if store is None else load_offheap_index_map(store)
    return AvroInputDataFormat(), imap


def stream_fit(mesh, root, store, kw):
    """train_streaming_glm on this rank (each streams its shard of the
    files when there are several); ``kw["float64"]``: from a float64 start.
    -> {λ: (coefficients, iterations, value)}."""
    from photon_ml_tpu_torch.training import train_streaming_glm

    import torch

    fmt, imap = _stream_inputs(root, store)
    kw = dict(kw)
    if kw.pop("float64", False):  # the fit in float64 from a float64 start
        kw["initial"] = torch.zeros(imap.size, dtype=torch.float64)
    models, results, _ = train_streaming_glm(
        [root], TaskType.LOGISTIC_REGRESSION, fmt=fmt, index_map=imap, device="cpu", **kw
    )
    return {
        lam: (m.means.cpu().numpy(), int(results[lam].iterations), float(results[lam].value))
        for lam, m in models.items()
    }


def stream_summary(mesh, root, store):
    """The streamed summary over this process's shard of the files, its
    moments summed over the processes: -> (mean, variance, count)."""
    from photon_ml_tpu_torch.io.streaming import scan_stream, shard_stream_files, streaming_summary

    fmt, imap = _stream_inputs(root, store)
    imap, stats = scan_stream([root], fmt, index_map=imap)
    summary, _ = streaming_summary(shard_stream_files([root], fmt), fmt, imap, stats, device="cpu")
    return summary.mean.numpy(), summary.variance.numpy(), float(summary.count)


def stream_feature_sharded_fit(mesh, root, kw):
    """train_streaming_feature_sharded on this rank of a (data, model) mesh:
    -> {λ: (coefficients, iterations, value)}."""
    from photon_ml_tpu_torch.training import train_streaming_feature_sharded

    models, results, _ = train_streaming_feature_sharded(
        [root], TaskType.LOGISTIC_REGRESSION, mesh=mesh, **kw
    )
    return {
        lam: (m.means.cpu().numpy(), int(results[lam].iterations), float(results[lam].value))
        for lam, m in models.items()
    }
