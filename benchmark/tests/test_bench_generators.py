"""The generators repeat from a seed, at a small size on the CPU, for seeds
past 32 bits as the benchmark's runs draw them."""

import numpy as np
import pytest

import harness

SEEDS = (7, 2**31 + 12345, 2**40 + 3)


def _clicklog(seed, rows=2048, features=1 << 14):
    cfg = {**harness.find_cell("criteo1tb_logistic.grid_batched").config,
           "rows": rows, "features": features}
    return harness.module("generators", "clicklog").generate(cfg, seed, "cpu")


def _glmix(seed, users=64, features=1 << 14):
    cfg = {**harness.find_cell("glmix_ads_user.cd_fit").config, "users": users, "features": features}
    return harness.module("generators", "glmix").generate(cfg, seed, "cpu")


@pytest.mark.parametrize("make", [_clicklog, _glmix], ids=["clicklog", "glmix"])
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_inputs(make, seed):
    a, b = make(seed), make(seed)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    c = make(seed + 1)
    assert any(not np.array_equal(a[k], c[k]) for k in a)


def test_clicklog_row_shape():
    d = _clicklog(11, rows=4096, features=1 << 14)
    feats, vals, labels = d["feats"], d["vals"], d["labels"]
    assert feats.shape == vals.shape == (4096, 40)
    assert (vals > 0).all()  # 40 nonzeros every row
    np.testing.assert_array_equal(feats[:, :13], np.broadcast_to(np.arange(13), (4096, 13)))
    assert (feats[:, 13:39] >= 13).all() and (feats[:, 13:39] < (1 << 14) - 1).all()
    assert (feats[:, 39] == (1 << 14) - 1).all() and (vals[:, 13:] == 1).all()
    assert 0.005 < labels.mean() < 0.2  # a click rate of a few percent
    # Zipf: the most frequent id of the first categorical column holds a large share
    _, counts = np.unique(feats[:, 13], return_counts=True)
    assert counts.max() / 4096 > 0.05


def test_clicklog_seed_permutes_one_set_of_rows():
    a, b = _clicklog(5, rows=1024), _clicklog(6, rows=1024)
    assert not np.array_equal(a["vals"], b["vals"])

    def rows(d):
        whole = np.concatenate([d["feats"], d["vals"].view(np.int32), d["labels"][:, None].view(np.int32)], 1)
        return whole[np.lexsort(whole.T[::-1])]

    np.testing.assert_array_equal(rows(a), rows(b))


def test_glmix_matches_the_frozen_shape():
    d = _glmix(5, users=32)
    assert d["g_idx"].shape == (512, 72) and d["u_idx"].shape == (512, 40)
    assert (d["g_val"][:, 64] == 1).all() and (d["g_val"][:, 65:] == 0).all()
    np.testing.assert_array_equal(np.bincount(d["users"]), np.full(32, 16))


def test_glmix_seed_permutes_one_set_of_rows():
    """Every seed fits the same users' rows, named and ordered anew."""
    a, b = _glmix(5, users=32), _glmix(6, users=32)

    def by_user(d):
        key = np.lexsort((d["g_val"][:, 0], d["users"]))
        return d["g_val"][key].reshape(32, 16, -1), d["labels"][key].reshape(32, 16)

    assert not np.array_equal(a["users"], b["users"])
    ga, la = by_user(a)
    gb, lb = by_user(b)
    order_a = np.lexsort(ga[:, :, 0].T)
    order_b = np.lexsort(gb[:, :, 0].T)
    np.testing.assert_array_equal(ga[order_a], gb[order_b])
    np.testing.assert_array_equal(la[order_a], lb[order_b])
