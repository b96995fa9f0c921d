"""GLMix rows: a global shard and a per-user shard with planted-model labels.

Frozen copies of ``chip_smoke.py``'s run G generators, so a change there
cannot move this benchmark's inputs:
``user_features`` (``chip_smoke.py:1603``), ``game_rows``
(``chip_smoke.py:1609``), ``game_model`` (``chip_smoke.py:1636``) and the
array half of ``game_data`` (``chip_smoke.py:2218``: the same generator
stream ``[seed, 3]``). Its sizes come from the configuration instead of
the script's constants; run F's ``user_pool`` shard and the cut into
buckets are left out (the program's random-effect build makes its own
buckets).

-> host arrays: ``g_idx`` / ``g_val`` [n, 72] (64 global features, then the
intercept, zero-padded to a multiple of 8), ``u_idx`` / ``u_val`` [n, 40]
(32 user features from the user's pool, then the intercept), ``labels``
[n], ``users`` int32 [n] (each row's user, 16 rows a user).
"""

from __future__ import annotations

import numpy as np


def user_features(users, picks, dim):
    """A user's pool of feature ids, distinct, spread over the
    user shard's dim - 1 features (the last is the intercept)."""
    return (users * 7919 + picks * 1031) % (dim - 1)


def game_rows(rng, users, w_global, w_user, global_nnz, user_nnz, pool):
    """GLMix rows for the given users: global features (uniform, then the
    intercept), user features (from the user's pool, then the intercept),
    planted-model logistic labels; -> (global idx, global values, user idx,
    user values, labels, each user feature's index in its user's pool),
    widths padded to 8."""
    n, dim = len(users), len(w_global)
    g_idx = rng.integers(0, dim - 1, size=(n, global_nnz))
    g_val = rng.normal(size=(n, global_nnz)).astype(np.float32)
    picks = rng.integers(0, pool, size=(n, user_nnz))
    u_val = rng.normal(size=(n, user_nnz)).astype(np.float32)
    z = (g_val * w_global[g_idx]).sum(1) + (u_val * w_user[users[:, None], picks]).sum(1)
    labels = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)

    def with_intercept(idx, val):
        k = idx.shape[1] + 1
        width = (k + 7) // 8 * 8
        out_i = np.zeros((n, width), np.int32)
        out_v = np.zeros((n, width), np.float32)
        out_i[:, : k - 1], out_v[:, : k - 1] = idx, val
        out_i[:, k - 1], out_v[:, k - 1] = dim - 1, 1.0
        return out_i, out_v

    return (*with_intercept(g_idx, g_val),
            *with_intercept(user_features(users[:, None], picks, dim), u_val),
            labels, picks)


def game_model(rng, n_users, dim, pool):
    w_global = (rng.normal(size=dim) * 0.3).astype(np.float32)
    w_user = (rng.normal(size=(n_users, pool)) * 0.3).astype(np.float32)
    return w_global, w_user


def generate(config: dict, seed: int, device=None) -> dict:
    """The rows of ``config["data_seed"]`` (run G's rows at that seed), the
    same set for every ``seed``: the seed permutes the users' names and
    the rows' order. The users' rows and labels, and so the work of a fit,
    stay the same (a seed that drew new rows changed the random effect's
    Newton iterations, and a fit's time by 12%)."""
    users_n, per_user = int(config["users"]), int(config["rows_per_user"])
    dim, pool = int(config["features"]), int(config["user_pool"])
    rng = np.random.default_rng([int(config["data_seed"]), 3])
    w_global, w_user = game_model(rng, users_n, dim, pool)
    users = np.repeat(np.arange(users_n), per_user)
    g_idx, g_val, u_idx, u_val, labels, _ = game_rows(
        rng, users, w_global, w_user, int(config["global_nnz"]), int(config["user_nnz"]), pool)
    order = np.random.default_rng([int(seed), 4])
    names = order.permutation(users_n)
    rows = order.permutation(len(users))
    return {
        "g_idx": g_idx[rows], "g_val": g_val[rows], "u_idx": u_idx[rows], "u_val": u_val[rows],
        "labels": labels[rows], "users": names[users[rows]].astype(np.int32),
    }
