"""Inputs and checks shared by the port's mesh tests
(``tests/test_torch_feature_sharded.py``, ``tests/test_torch_data_parallel.py``).

Imports neither JAX nor the reference: the spawned ranks of those tests
import it.
"""

import numpy as np

N, D, K = 120, 100, 5


def planted_problem(seed=0):
    """Planted-model logistic rows (K features, then an intercept in
    column D - 1), labels and weights, from a numpy seed."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=D)
    rows, labels = [], []
    for _ in range(N):
        ix = rng.choice(D - 1, size=K, replace=False)
        vs = rng.normal(size=K)
        z = float((w_true[ix] * vs).sum()) + w_true[D - 1]
        labels.append(float(rng.uniform() < 1 / (1 + np.exp(-z))))
        rows.append((ix.tolist() + [D - 1], vs.tolist() + [1.0]))
    return rows, labels, rng.uniform(0.5, 2.0, N)


def standardization(rows):
    """Standardization (shift = mean, factor = 1/std) with the intercept
    left alone, as float32 numpy vectors of length D."""
    x = np.zeros((len(rows), D))
    for i, (ix, vs) in enumerate(rows):
        x[i, ix] = vs
    std = x.std(axis=0)
    factor = np.where(std > 0, 1.0 / np.where(std > 0, std, 1.0), 1.0)
    shift = x.mean(axis=0)
    factor[D - 1], shift[D - 1] = 1.0, 0.0
    return shift.astype(np.float32), factor.astype(np.float32)


def schedule_entries(sched, window):
    """A schedule's (flat out, flat in, value) triples of its held and
    spilled entries, sorted: what it computes, whatever its layout."""
    a = [np.asarray(t) for t in (
        sched.step_out, sched.step_in, sched.out_pos, sched.in_pos, sched.vals,
        sched.spill_out, sched.spill_in, sched.spill_vals,
    )]
    step_out, step_in, o_pos, i_pos, vals, sp_out, sp_in, sp_vals = a
    G = len(step_out)
    held = vals[:G] != 0
    out = np.concatenate([
        (step_out[:, None] * window + o_pos[:G])[held], sp_out[sp_vals != 0],
    ])
    inn = np.concatenate([
        (step_in[:, None] * window + i_pos[:G])[held], sp_in[sp_vals != 0],
    ])
    v = np.concatenate([vals[:G][held], sp_vals[sp_vals != 0]])
    order = np.lexsort((v, inn, out))
    return out[order], inn[order], v[order]


def close_to_scale(got, want, rtol):
    """|got - want| <= rtol * max|want|, elementwise (sums taken in another
    order err in proportion to the output's scale)."""
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)
