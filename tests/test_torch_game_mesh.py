"""GAME's fixed effect over a mesh of ranks in the port
(``FixedEffectCoordinate(mesh=...)``) against the JAX package's on its
virtual CPU devices.

The port runs on 2 x 1 and 1 x 2 (data, model) gloo meshes of spawned CPU
processes, and on a 1-D data mesh of 2 (the data-parallel solve); the
reference on 2 of its 8 virtual devices, the same mesh shapes. Both
stop at a gradient test near float32 rounding. Tolerances (float32, the
reference's sharded fit is float32 by construction): the objective within
1e-5 relative, the coefficients within 1e-4 of their max-abs; every rank
returns the same bits, and two fits of the same inputs repeat bitwise.
Against the port's own single-process fit: within 1e-5 of scale.
"""

import numpy as np
import pytest

from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, spawn_mesh
from tests.torch_game_mesh_cases import SHARDS, TOL, fe_fits
from torch_game_cases import make_records

MESHES = {
    "2x1": ((2, 1), (DATA_AXIS, MODEL_AXIS)),
    "1x2": ((1, 2), (DATA_AXIS, MODEL_AXIS)),
    "data2": ((2,), (DATA_AXIS,)),
}


def _records():
    return make_records(11, n=240, n_users=8, d_global=9)


def _residual(n):
    return np.random.default_rng(5).normal(scale=0.3, size=n).astype(np.float32)


def _reference(recs, shape, axes, residual):
    import jax

    from photon_ml_tpu.game import FeatureShardConfiguration as RefShard
    from photon_ml_tpu.game import FixedEffectCoordinate as RefFE
    from photon_ml_tpu.game import build_game_dataset as ref_build
    from photon_ml_tpu.optim.config import OptimizerConfig as RefOptConfig
    from photon_ml_tpu.optim.config import RegularizationContext as RefReg
    from photon_ml_tpu.optim.config import RegularizationType as RefRegType
    from photon_ml_tpu.optim.problem import create_glm_problem as ref_problem
    from photon_ml_tpu.parallel.mesh import make_mesh as ref_mesh
    from photon_ml_tpu.task import TaskType as RefTask

    ds = ref_build(recs, [RefShard(s, b, add_intercept=True) for s, b in SHARDS], ["userId"])
    mesh = ref_mesh(shape, axes, jax.devices()[: int(np.prod(shape))])
    dim = ds.shards["globalShard"].dim
    fe = RefFE(
        name="global", dataset=ds,
        problem=ref_problem(
            RefTask.LOGISTIC_REGRESSION, dim,
            config=RefOptConfig(max_iter=60, tolerance=TOL),
            regularization=RefReg(RefRegType.L2),
            intercept_index=ds.shards["globalShard"].intercept_index,
        ),
        feature_shard_id="globalShard", reg_weight=0.1, mesh=mesh,
    )
    out = []
    for r in (None, residual):
        model, result = fe.update_model(None, None if r is None else jax.numpy.asarray(r))
        out.append((np.asarray(model.model.means), int(result.iterations), float(result.value)))
    return out


@pytest.fixture(scope="module")
def runs():
    recs = _records()
    residual = _residual(len(recs))
    out = {}
    for name, (shape, axes) in MESHES.items():
        out[name] = spawn_mesh(
            fe_fits, shape, axes, device="cpu",
            args=(recs, "scatter", "LBFGS", residual),
        )
    out["single"] = fe_fits(None, recs, "scatter", "LBFGS", residual)
    return recs, residual, out


@pytest.mark.parametrize("name", sorted(MESHES))
def test_fe_on_mesh_matches_reference(runs, name):
    recs, residual, out = runs
    shape, axes = MESHES[name]
    ref = _reference(recs, shape, axes, residual)
    got = out[name][0]
    for (coef, it, val), (r_coef, r_it, r_val) in zip((got[0], got[2]), ref):
        assert abs(it - r_it) <= 1
        assert abs(val - r_val) <= 1e-5 * abs(r_val)
        scale = float(np.abs(r_coef).max())
        np.testing.assert_allclose(coef, r_coef, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_fe_on_mesh_repeats_bitwise_and_ranks_agree(runs, name):
    _, _, out = runs
    ranks = out[name]
    first = ranks[0]
    assert np.array_equal(first[0][0], first[1][0]) and first[0][1:] == first[1][1:]
    for other in ranks[1:]:
        for a, b in zip(first, other):
            assert np.array_equal(a[0], b[0]) and a[1:] == b[1:]
    single = out["single"]
    for (coef, _, val), (s_coef, _, s_val) in zip((first[0], first[2]), (single[0], single[2])):
        assert abs(val - s_val) <= 1e-5 * abs(s_val)
        np.testing.assert_allclose(coef, s_coef, rtol=0, atol=1e-5 * float(np.abs(s_coef).max()))


def test_fe_on_mesh_tiled_kernel():
    """The tiled kernel's cells (K1's plain version on the CPU): a 1 x 2
    mesh agrees with the scatter mesh fit and repeats bitwise."""
    recs = _records()
    residual = _residual(len(recs))
    shape, axes = MESHES["1x2"]
    tiled = spawn_mesh(fe_fits, shape, axes, device="cpu",
                       args=(recs, "tiled", "TRON", residual))
    scatter = spawn_mesh(fe_fits, shape, axes, device="cpu",
                         args=(recs, "scatter", "TRON", residual))
    t, s = tiled[0], scatter[0]
    assert np.array_equal(t[0][0], t[1][0])
    for (coef, _, val), (s_coef, _, s_val) in zip(t, s):
        assert abs(val - s_val) <= 1e-5 * abs(s_val)
        np.testing.assert_allclose(coef, s_coef, rtol=0, atol=1e-4 * float(np.abs(s_coef).max()))
