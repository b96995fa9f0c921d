"""The PyTorch port's objectives against the reference's: the scatter
``GLMObjective`` against the reference ``GLMObjective``, and the tiled
``TiledGLMObjective`` (plain K1 on the CPU) against the reference
``TiledGLMObjective(interpret=True, mxu="highest")`` on the same schedule,
for value_and_gradient, hessian_vector and hessian_diagonal, with and
without a shift/factor normalization, with offsets, for the logistic and
squared losses.

Tolerance: rtol 1e-5 of the output's largest magnitude plus atol 1e-6:
both sides compute in f32 and sum in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.ops import losses as ref_losses
from photon_ml_tpu.ops.normalization import NormalizationContext as RefNorm
from photon_ml_tpu.ops.objective import GLMObjective as RefGLMObjective
from photon_ml_tpu.ops.tiled_sparse import TiledGLMObjective as RefTiledObjective
from photon_ml_tpu.ops.tiled_sparse import TileParams as RefTileParams
from photon_ml_tpu.ops.tiled_sparse import (
    tiled_batch_from_sparse as ref_tiled_batch_from_sparse,
)
from photon_ml_tpu_torch.convert import normalization_from_reference
from photon_ml_tpu_torch.ops import losses
from photon_ml_tpu_torch.ops.normalization import identity_context
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.ops.tiled_sparse import TiledGLMObjective
from tests.torch_parity import (
    assert_close_to_scale,
    both_batches,
    port_tiled_batch,
    random_rows,
)

PARAMS = RefTileParams(s_hi=8, s_lo=8, chunk=32, spill_cap=8)
D = 150
L2 = 0.7

# (loss name, with normalization + offsets)
CASES = [("logistic", False), ("logistic", True), ("squared", True)]


def _setup(loss_name, normalized):
    rng = np.random.default_rng(11)
    rows, labels = random_rows(rng, n=100, d=D)
    if loss_name == "squared":
        labels = rng.normal(size=len(rows)).tolist()
    weights = rng.uniform(0.5, 2.0, len(rows))
    offsets = rng.normal(scale=0.3, size=len(rows)) if normalized else None
    ref_batch, batch = both_batches(rows, labels, weights, offsets)
    if normalized:
        factor = rng.uniform(0.5, 2.0, D).astype(np.float32)
        shift = rng.normal(scale=0.2, size=D).astype(np.float32)
        factor[-1], shift[-1] = 1.0, 0.0  # intercept slot
        ref_norm = RefNorm(jnp.asarray(factor), jnp.asarray(shift))
        norm = normalization_from_reference(factor, shift, device="cpu")
    else:
        ref_norm, norm = RefNorm(), identity_context()
    ref_loss = ref_losses.LOGISTIC if loss_name == "logistic" else ref_losses.LINEAR
    loss = losses.LOGISTIC if loss_name == "logistic" else losses.LINEAR
    w = rng.normal(scale=0.3, size=D).astype(np.float32)
    v = rng.normal(size=D).astype(np.float32)
    return rng, ref_batch, batch, ref_norm, norm, ref_loss, loss, w, v


def _compare(ref_obj, ref_batch, obj, batch, w, v):
    jw, jv = jnp.asarray(w), jnp.asarray(v)
    tw, tv = torch.as_tensor(w), torch.as_tensor(v)
    rv, rg = ref_obj.value_and_gradient(jw, ref_batch, L2)
    pv, pg = obj.value_and_gradient(tw, batch, L2)
    assert_close_to_scale(pv, rv, rtol=1e-5, atol=1e-6)
    assert_close_to_scale(pg, rg, rtol=1e-5, atol=1e-6)
    assert_close_to_scale(
        obj.hessian_vector(tw, tv, batch, L2),
        ref_obj.hessian_vector(jw, jv, ref_batch, L2), rtol=1e-5, atol=1e-6,
    )
    assert_close_to_scale(
        obj.hessian_diagonal(tw, batch, L2),
        ref_obj.hessian_diagonal(jw, ref_batch, L2), rtol=1e-5, atol=1e-6,
    )


@pytest.mark.parametrize("loss_name,normalized", CASES)
def test_scatter_objective_matches_reference(loss_name, normalized):
    _, ref_batch, batch, ref_norm, norm, ref_loss, loss, w, v = _setup(
        loss_name, normalized
    )
    _compare(
        RefGLMObjective(ref_loss, D, ref_norm), ref_batch,
        GLMObjective(loss, D, norm), batch, w, v,
    )


@pytest.mark.parametrize("loss_name,normalized", CASES)
def test_tiled_objective_matches_reference(loss_name, normalized):
    _, ref_batch, _, ref_norm, norm, ref_loss, loss, w, v = _setup(
        loss_name, normalized
    )
    ref_tb = ref_tiled_batch_from_sparse(ref_batch, D, params=PARAMS)
    _compare(
        RefTiledObjective(ref_loss, D, ref_norm, interpret=True, mxu="highest"),
        ref_tb, TiledGLMObjective(loss, D, norm), port_tiled_batch(ref_tb), w, v,
    )


def test_tiled_margins_match_scatter_margins():
    """The port's two objectives agree with each other on margins (the
    tiled ones live in padded row space)."""
    _, ref_batch, batch, _, norm, _, loss, w, _ = _setup("logistic", True)
    tb = port_tiled_batch(ref_tiled_batch_from_sparse(ref_batch, D, params=PARAMS))
    tw = torch.as_tensor(w)
    scatter = GLMObjective(loss, D, norm).margins(tw, batch)
    tiled = TiledGLMObjective(loss, D, norm).margins(tw, tb)
    assert_close_to_scale(tiled[: batch.num_rows], scatter, rtol=1e-5, atol=1e-6)
