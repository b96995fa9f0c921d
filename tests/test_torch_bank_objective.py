"""The port's objectives over a coefficient bank [G, d] against
``jax.vmap`` of the reference's objectives (what the reference's batched
λ-grid runs): the scatter ``GLMObjective``, and the tiled
``TiledGLMObjective`` (plain K2 on the CPU) against the reference's tiled
objective, whose passes the vmap sends to ``_grid_bilinear_pass``. Value,
gradient, Hessian-vector product and Hessian diagonal, with a per-member
l2 weight, with and without a shift/factor normalization and offsets.
Also: every member of a bank equals the same vector evaluated alone.

Tolerance: rtol 1e-5 of the output's largest magnitude plus atol 1e-6:
both sides compute in f32 and sum in another order.
"""

import numpy as np
import pytest
import torch

import jax
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
L2 = np.array([2.0, 0.5, 0.0, 0.1], np.float32)  # one per member
G = len(L2)


def _setup(normalized):
    rng = np.random.default_rng(13)
    rows, labels = random_rows(rng, n=100, d=D)
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
    w = rng.normal(scale=0.3, size=(G, D)).astype(np.float32)
    v = rng.normal(size=(G, D)).astype(np.float32)
    return ref_batch, batch, ref_norm, norm, w, v


def _bank_outputs(obj, batch, w, v, l2):
    vg = obj.value_and_gradient(w, batch, l2)
    return {
        "value": vg[0],
        "gradient": vg[1],
        "hessian_vector": obj.hessian_vector(w, v, batch, l2),
        "hessian_diagonal": obj.hessian_diagonal(w, batch, l2),
    }


def _ref_bank_outputs(ref_obj, ref_batch, w, v):
    vg = jax.vmap(lambda wi, l2: ref_obj.value_and_gradient(wi, ref_batch, l2))
    hv = jax.vmap(lambda wi, vi, l2: ref_obj.hessian_vector(wi, vi, ref_batch, l2))
    hd = jax.vmap(lambda wi, l2: ref_obj.hessian_diagonal(wi, ref_batch, l2))
    jw, jv, jl2 = jnp.asarray(w), jnp.asarray(v), jnp.asarray(L2)
    value, grad = vg(jw, jl2)
    return {
        "value": value,
        "gradient": grad,
        "hessian_vector": hv(jw, jv, jl2),
        "hessian_diagonal": hd(jw, jl2),
    }


def _objectives(kind, normalized):
    ref_batch, batch, ref_norm, norm, w, v = _setup(normalized)
    if kind == "scatter":
        ref_obj = RefGLMObjective(ref_losses.LOGISTIC, D, ref_norm)
        obj = GLMObjective(losses.LOGISTIC, D, norm)
        return ref_obj, ref_batch, obj, batch, w, v
    ref_tb = ref_tiled_batch_from_sparse(ref_batch, D, params=PARAMS)
    ref_obj = RefTiledObjective(
        ref_losses.LOGISTIC, D, ref_norm, interpret=True, mxu="highest"
    )
    obj = TiledGLMObjective(losses.LOGISTIC, D, norm)
    return ref_obj, ref_tb, obj, port_tiled_batch(ref_tb), w, v


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("kind", ["scatter", "tiled"])
def test_bank_objective_matches_vmapped_reference(kind, normalized):
    ref_obj, ref_batch, obj, batch, w, v = _objectives(kind, normalized)
    expected = _ref_bank_outputs(ref_obj, ref_batch, w, v)
    got = _bank_outputs(
        obj, batch, torch.as_tensor(w), torch.as_tensor(v), torch.as_tensor(L2)
    )
    for name, e in expected.items():
        assert got[name].shape == e.shape, name
        assert_close_to_scale(got[name], e, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["scatter", "tiled"])
def test_bank_member_equals_vector_alone(kind):
    """Row g of every bank output is the one-vector method at w[g] and
    l2[g] (same f32 arithmetic, another batching: rtol 1e-6 of scale)."""
    _, _, obj, batch, w, v = _objectives(kind, True)
    bank = _bank_outputs(
        obj, batch, torch.as_tensor(w), torch.as_tensor(v), torch.as_tensor(L2)
    )
    for g in range(G):
        one = _bank_outputs(
            obj, batch, torch.as_tensor(w[g]), torch.as_tensor(v[g]), float(L2[g])
        )
        for name in bank:
            assert_close_to_scale(bank[name][g], one[name], rtol=1e-6, atol=1e-6)
