"""Shared GAME fixtures for the port's tests (``tests/test_torch_game_*.py``):
records made with numpy from a seed, fed to both packages."""

from __future__ import annotations

import numpy as np

from photon_ml_tpu.game import FeatureShardConfiguration as RefShard
from photon_ml_tpu.game import build_game_dataset as ref_build
from photon_ml_tpu_torch.game import FeatureShardConfiguration, build_game_dataset


def make_records(seed, n=200, n_users=10, n_items=0, d_global=6, d_user=4,
                 dup_every=0):
    """Synthetic GLMix records: a global effect plus per-user (and, with
    ``n_items``, per-item) effects. ``dup_every``: every such row repeats
    its first user feature (a duplicate index within the row)."""
    rng = np.random.default_rng(seed)
    w_global = np.linspace(-1, 1, d_global)
    w_user = rng.normal(size=(max(n_users, 1), d_user)).astype(np.float32)
    recs = []
    for i in range(n):
        u = int(rng.integers(0, n_users))
        xg = rng.normal(size=d_global).astype(np.float32)
        xu = rng.normal(size=d_user).astype(np.float32)
        z = float(xg @ w_global + xu @ w_user[u])
        y = float(1 / (1 + np.exp(-z)) > rng.uniform())
        rec = {
            "uid": f"r{i}",
            "response": y,
            "userId": f"user{u:03d}",
            "features": [
                {"name": f"g{j}", "term": "", "value": float(xg[j])}
                for j in range(d_global)
            ],
            "userFeatures": [
                {"name": f"u{j}", "term": "", "value": float(xu[j])}
                for j in range(d_user)
                if rng.uniform() > 0.2
            ],
        }
        if dup_every and i % dup_every == 0 and rec["userFeatures"]:
            rec["userFeatures"].append(dict(rec["userFeatures"][0], value=0.5))
        if n_items:
            rec["itemId"] = f"item{int(rng.integers(0, n_items)):02d}"
            rec["offset"] = float(rng.normal() * 0.1)
            rec["weight"] = float(rng.uniform(0.5, 1.5))
        recs.append(rec)
    return recs


SHARD_SPECS = [("globalShard", ["features"]), ("userShard", ["userFeatures"])]


def shards(package="port"):
    cls = FeatureShardConfiguration if package == "port" else RefShard
    return [cls(s, bags, add_intercept=True) for s, bags in SHARD_SPECS]


def both_datasets(recs, re_types=("userId",)):
    """-> (reference GameDataset, port GameDataset on the CPU)."""
    ref = ref_build(recs, shards("ref"), list(re_types))
    port = build_game_dataset(recs, shards("port"), list(re_types), device="cpu")
    return ref, port
