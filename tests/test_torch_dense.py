"""The dense batch (``data/batch.py`` ``DenseBatch``, ``make_dense_batch``),
``GLMObjective``'s dense branches, the dense ``compute_*`` of
``models/glm.py`` and ``parallel/mesh.py`` ``pad_batch_rows`` against the
JAX package's, on the same numpy inputs made from a seed.

Tolerances: float64 (the binding check, the reference under
``jax.enable_x64``) within 1e-9 of each output's scale, float32 within
1e-5 of scale (matrix products summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data.batch import make_dense_batch as ref_make_dense
from photon_ml_tpu.data.batch import make_sparse_batch as ref_make_sparse
from photon_ml_tpu.models import glm as ref_glm
from photon_ml_tpu.ops import losses as ref_losses
from photon_ml_tpu.ops.normalization import NormalizationContext as RefNorm
from photon_ml_tpu.ops.objective import GLMObjective as RefObjective
from photon_ml_tpu.parallel.mesh import pad_batch_rows as ref_pad_batch_rows
from photon_ml_tpu.task import TaskType as RefTask
from photon_ml_tpu_torch.data.batch import DenseBatch, make_dense_batch, make_sparse_batch
from photon_ml_tpu_torch.models import glm
from photon_ml_tpu_torch.ops import losses
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.parallel.mesh import pad_batch_rows
from photon_ml_tpu_torch.task import TaskType
from tests.torch_parity import assert_close_to_scale, to_np

N, D = 37, 9
LOSSES = ("LOGISTIC", "LINEAR", "POISSON", "SMOOTHED_HINGE")
RTOL = {"float64": 1e-9, "float32": 1e-5}


def _inputs(loss_name, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D))
    if loss_name == "POISSON":
        y = rng.poisson(2.0, size=N).astype(float)
        x *= 0.3
    elif loss_name == "LINEAR":
        y = rng.normal(size=N)
    else:
        y = (rng.uniform(size=N) > 0.5).astype(float)
    return dict(
        x=x, y=y, off=rng.normal(size=N) * 0.1, wt=rng.uniform(0.5, 2.0, N),
        w=rng.normal(size=D) * 0.3, d=rng.normal(size=D),
        shift=rng.normal(size=D) * 0.1, factor=rng.uniform(0.5, 1.5, D),
    )


def _both(a, dtype):
    ref = ref_make_dense(a["x"], a["y"], a["off"], a["wt"], dtype=np.dtype(dtype))
    ours = make_dense_batch(a["x"], a["y"], a["off"], a["wt"], dtype=np.dtype(dtype),
                            device="cpu")
    return ref, ours


def _outputs(obj, w, d, batch, l2):
    value, grad = obj.value_and_gradient(w, batch, l2)
    return [value, grad, obj.hessian_vector(w, d, batch, l2),
            obj.hessian_diagonal(w, batch, l2), obj.margins(w, batch)]


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("loss_name", LOSSES)
def test_dense_objective_matches_reference(loss_name, dtype, normalized):
    a = _inputs(loss_name)
    cast = np.dtype(dtype).type
    with jax.enable_x64(dtype == "float64"):
        ref_batch, batch = _both(a, dtype)
        ref_norm, norm = RefNorm(), NormalizationContext()
        if normalized:
            ref_norm = RefNorm(jnp.asarray(a["factor"], dtype), jnp.asarray(a["shift"], dtype))
            norm = NormalizationContext(torch.as_tensor(a["factor"].astype(dtype)),
                                        torch.as_tensor(a["shift"].astype(dtype)))
        ref = _outputs(
            RefObjective(getattr(ref_losses, loss_name), D, ref_norm),
            jnp.asarray(a["w"], dtype), jnp.asarray(a["d"], dtype), ref_batch, cast(0.7),
        )
        ref = [np.asarray(r) for r in ref]
    got = _outputs(
        GLMObjective(getattr(losses, loss_name), D, norm),
        torch.as_tensor(a["w"].astype(dtype)), torch.as_tensor(a["d"].astype(dtype)),
        batch, 0.7,
    )
    for g, r in zip(got, ref):
        assert to_np(g).dtype == np.dtype(dtype)
        assert_close_to_scale(g, r, rtol=RTOL[dtype])


@pytest.mark.parametrize("loss_name", LOSSES)
def test_dense_bank_is_each_member(loss_name):
    """A ``[G, d]`` bank with a weight per member gives each member's own
    outputs (the reference's ``vmap``), float64."""
    a = _inputs(loss_name, seed=1)
    _, batch = _both(a, "float64")
    obj = GLMObjective(getattr(losses, loss_name), D)
    rng = np.random.default_rng(2)
    bank = torch.as_tensor(rng.normal(size=(3, D)) * 0.2)
    dirs = torch.as_tensor(rng.normal(size=(3, D)))
    l2 = torch.tensor([0.0, 0.5, 2.0], dtype=torch.float64)
    got = _outputs(obj, bank, dirs, batch, l2)
    for g in range(3):
        one = _outputs(obj, bank[g], dirs[g], batch, float(l2[g]))
        for x, y in zip(got, one):
            assert_close_to_scale(x[g], y, rtol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dense_scores_match_reference(dtype):
    a = _inputs("LOGISTIC")
    with jax.enable_x64(dtype == "float64"):
        ref_batch, batch = _both(a, dtype)
        w = jnp.asarray(a["w"], dtype)
        ref = [ref_glm.compute_scores(w, ref_batch), ref_glm.compute_margins(w, ref_batch)] + [
            ref_glm.compute_means(RefTask[t.name], w, ref_batch) for t in TaskType
        ]
        ref = [np.asarray(r) for r in ref]
    wt = torch.as_tensor(a["w"].astype(dtype))
    got = [glm.compute_scores(wt, batch), glm.compute_margins(wt, batch)] + [
        glm.compute_means(t, wt, batch) for t in TaskType
    ]
    for g, r in zip(got, ref):
        assert_close_to_scale(g, r, rtol=RTOL[dtype])


def test_make_dense_batch_pads_as_the_reference():
    a = _inputs("LOGISTIC")
    ref, ours = _both(a, "float32")
    assert isinstance(ours, DenseBatch) and ours.num_rows == ref.num_rows == 40
    for f in ("features", "labels", "offsets", "weights"):
        np.testing.assert_array_equal(to_np(getattr(ours, f)), np.asarray(getattr(ref, f)))
    none = make_dense_batch(a["x"][:3], a["y"][:3], device="cpu")
    assert none.num_rows == 8 and float(none.weights.sum()) == 3.0
    assert not none.offsets.any()


@pytest.mark.parametrize("kind", ["sparse", "dense"])
@pytest.mark.parametrize("multiple", [1, 4, 7])
def test_pad_batch_rows_matches_reference(kind, multiple):
    a = _inputs("LOGISTIC")
    if kind == "dense":
        ref, ours = _both(a, "float32")
    else:
        rows = [(list(range(i % 5, i % 5 + 3)), [1.0, 2.0, -1.0]) for i in range(N)]
        ref = ref_make_sparse(rows, a["y"], pad_rows_to=1)
        ours = make_sparse_batch(rows, a["y"], pad_rows_to=1, device="cpu")
    want, got = ref_pad_batch_rows(ref, multiple), pad_batch_rows(ours, multiple)
    assert type(got) is type(ours) and (got is ours) == (want is ref)
    for f, v in want._asdict().items():
        np.testing.assert_array_equal(to_np(getattr(got, f)), np.asarray(v))
    with pytest.raises(TypeError, match="cannot row-pad"):
        pad_batch_rows(object(), 2)
