"""Both GLM drivers below convergence tolerance 1e-4: the same optimum.

The driver parity tests (``tests/test_torch_glm_driver.py``) run at
``--convergence-tolerance 1e-4``. At 1e-5 the port's and the JAX package's
coefficients part by more than 1e-4 of their max-abs on the LibSVM fixture
with a box constraint (1.3e-4 at λ = 1, 1.5e-4 at λ = 0.1). This file
runs both drivers at 1e-5 on that fixture, sequential with the box and
batched with a declared dimension, and computes each package's final
objective at each λ in float64 from its definition at the model it wrote:
they agree within 1e-6 relative (9e-8 measured where the coefficients
part), so the two stopped at the same optimum along a flat direction.
"""

import json

import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import glm_driver as ref_driver
from photon_ml_tpu_torch.cli import glm_driver
from tests.test_torch_glm_driver import BOX, fixtures  # noqa: F401  (a fixture)

CASES = {
    "sequential_box": ["--grid-mode", "sequential", "--coefficient-box-constraints", BOX],
    "batched_dimension": ["--grid-mode", "batched", "--feature-dimension", "8"],
}


def _objective64(batch, means, lam) -> float:
    """sum_i w_i (log(1 + e^z_i) - y_i z_i) + lam/2 |means|^2 in float64."""
    w = torch.as_tensor(np.array(means), dtype=torch.float64)
    z = (batch.values.double() * w[batch.indices.long()]).sum(1) + batch.offsets.double()
    y, wt = batch.labels.double(), batch.weights.double()
    return float((wt * (torch.nn.functional.softplus(z) - y * z)).sum() + 0.5 * lam * (w @ w))


@pytest.mark.parametrize("case", list(CASES))
def test_drivers_reach_the_same_objective_at_tolerance_1e5(tmp_path, fixtures, case):  # noqa: F811
    train, val = fixtures["libsvm"]
    argv = [
        "--training-data-directory", train, "--validating-data-directory", val,
        "--input-file-format", "LIBSVM", "--regularization-weights", "10,1,0.1",
        "--convergence-tolerance", "1e-5",
    ] + CASES[case]
    ref = ref_driver.GLMDriver(ref_driver.params_from_args(
        argv + ["--output-directory", str(tmp_path / "ref"), "--distributed", "off"]))
    ref.run()
    port = glm_driver.main(argv + ["--output-directory", str(tmp_path / "port"), "--device", "cpu"])
    batch = port._data.batch
    for lam in (10.0, 1.0, 0.1):
        want = _objective64(batch, ref.models[lam].means, lam)
        got = _objective64(batch, port.models[lam].means, lam)
        assert abs(got - want) <= 1e-6 * abs(want), (lam, got, want)
    if case == "sequential_box":  # both models lie in the box
        bound = json.loads(BOX)[0]
        i = port._data.index_map.get_index("4\t")
        for model in list(port.models.values()) + list(ref.models.values()):
            v = np.asarray(model.means)[i]  # float32, as the bounds are stored
            assert np.float32(bound["lowerBound"]) <= v <= np.float32(bound["upperBound"])
