"""What decides ``correct`` fails what it must, at a size a test run holds:
the control (the reference in the program's place, bfloat16 values with
float32 sums) and the faults the timed path can have (a fit that returns
its start unchanged, half the rows left out, an answer altered where it is
produced, and a wrong update once L-BFGS's history of 10 pairs is full)
each read over a limit; the program reads under every limit."""

import dataclasses

import pytest

import calibrate
import harness
from test_bench_dry_run import SEQUENTIAL, small_cell

GLM = "criteo1tb_logistic.grid_batched"
GAME = "glmix_ads_user.cd_fit"


def _over(numbers, limits):
    return [k for k in limits if numbers[k] > limits[k]]


@pytest.mark.parametrize("cell", [GLM, SEQUENTIAL, GAME])
def test_control_fails_and_program_passes(cell):
    c = small_cell(cell)
    for seed in (3, 2**31 + 9):
        assert _over(calibrate.control_reading(c, seed, "cpu"), c.limits)
        assert not _over(calibrate.program_reading(c, seed, "cpu"), c.limits)


def _glm_fault(fault):
    from photon_ml_tpu_torch import training

    real = training.train_grid_batched

    def broken(tb, task, dim, **kw):
        if fault == "half":
            w = tb.weights.clone()
            w[tb.num_real_rows // 2:] = 0  # the second half of the rows left out
            tb = dataclasses.replace(tb, weights=w)
        models, results = real(tb, task, dim, **kw)
        for i, m in enumerate(models.values()):
            if fault == "unchanged":
                m.means.zero_()  # the fit's start, returned as it was
            elif fault == "altered" and i == 0:
                m.means[-1] += 1.0
        return models, results

    return training, "train_grid_batched", broken


def _game_fault(fault):
    from photon_ml_tpu_torch.game import coordinate

    if fault == "unchanged":
        real = coordinate.RandomEffectCoordinate.update_model

        def broken(self, model, residual=None):
            return model, real(self, model, residual)[1]

        return coordinate.RandomEffectCoordinate, "update_model", broken
    if fault == "half":
        real = coordinate.FixedEffectCoordinate._batch

        def broken(self, residual):
            batch = real(self, residual)
            w = batch.weights.clone()
            w[w.shape[0] // 2:] = 0
            return dataclasses.replace(batch, weights=w)

        return coordinate.FixedEffectCoordinate, "_batch", broken
    real = coordinate.FixedEffectCoordinate.update_model

    def broken(self, model, residual=None):
        new, result = real(self, model, residual)
        new.model.means[-1] += 1.0
        return new, result

    return coordinate.FixedEffectCoordinate, "update_model", broken


def _wrapped_history():
    """From the 11th pair on, L-BFGS's write slot no longer advances: the
    newest pair overwrites one slot, read as the oldest, and the two-loop
    recursion scales by a pair that is no longer the newest. The first
    10 iterations are untouched; the 12th direction is the first wrong."""
    from photon_ml_tpu_torch.optim import lbfgs

    real = lbfgs._Memory.push

    def broken(self, s, y, rho, keep, kept):
        m, full, ptr = self.rho.shape[1], list(self.length), list(self.ptr)
        real(self, s, y, rho, keep, kept)
        self.ptr = [p if n == m else q for p, q, n in zip(ptr, self.ptr, full)]

    return lbfgs._Memory, "push", broken


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "wrapped_history"])
@pytest.mark.parametrize("cell", [GLM, GAME])
def test_fault_in_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    if fault == "wrapped_history":
        target, name, broken = _wrapped_history()
    else:
        target, name, broken = (_glm_fault if cell == GLM else _game_fault)(fault)
    monkeypatch.setattr(target, name, broken)
    out = harness.run_cell(small_cell(cell), 41, 0.01, False, "cpu")
    assert out["correct"] is False, out["checks"]
    assert out["failed"] == out["attempted"]
