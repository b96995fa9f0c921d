"""Click-log rows at the Criteo 1TB shape, made on the device from the seed.

A row has the source's 13 integer features and 26 categorical features,
plus an intercept:

- integer column j sits at feature id j (0-12) with value log(1 + count);
  counts are heavy-tailed, ``1 + floor(exp(N(mu, sigma)))`` (at least 1, so
  every row keeps its 40 nonzeros);
- categorical column c draws a category of rank r from a Zipf law of
  exponent s over its cardinality K_c, and hashes (c, r) into the ids
  13 .. features - 2 with value 1.0 (two categories may share an id, as
  under any hashing trick);
- the intercept is the last id, value 1.0.

Labels come from a planted logistic model: a weight per id, the integer
columns' own, and a bias set for a click rate of a few percent.
``assumed`` in the configuration holds every number chosen here.

The rows are those of ``config["data_seed"]``, the same set for every
run; a run's seed puts them in another order. (Rows drawn anew from each
seed changed the line searches' trials, and a grid's time by up to 16%.)

-> host arrays: ``feats`` int64 [n, 40], ``vals`` float32 [n, 40],
``labels`` float32 [n]; the same seed gives the same arrays on one kind of
device.
"""

from __future__ import annotations

import numpy as np
import torch

# hashed key = column * 2^KEY_BITS + rank; every cardinality is below it
KEY_BITS = 24
HASH_PRIME = 15_485_863


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one stream of ``seed`` (any whole number)."""
    return int(np.random.SeedSequence([int(seed) & ((1 << 128) - 1), stream]).generate_state(
        1, np.uint64)[0]) & ((1 << 63) - 1)


def zipf_ranks(u: torch.Tensor, cardinality: torch.Tensor, s: float) -> torch.Tensor:
    """Ranks 0 .. K-1 with P(r) roughly proportional to (r + 1)^-s: the
    inverse of the continuous power law's CDF on [1, K + 1), floored."""
    a = 1.0 - s
    top = (cardinality.double() + 1.0) ** a
    x = (1.0 + u * (top - 1.0)) ** (1.0 / a)
    r = torch.floor(x).long() - 1
    return torch.minimum(r.clamp_min(0), cardinality.long() - 1)


def generate(config: dict, seed: int, device) -> dict:
    n, d = int(config["rows"]), int(config["features"])
    a = config["assumed"]
    n_int, n_cat = int(config["integer_columns"]), int(config["categorical_columns"])
    dev = torch.device(device)
    data_seed = int(config["data_seed"])
    g = torch.Generator(device=dev).manual_seed(stream_seed(data_seed, 1))

    counts = 1.0 + torch.floor(torch.exp(
        a["count_log_mean"] + a["count_log_sigma"] * torch.randn(n, n_int, generator=g, device=dev)))
    int_vals = torch.log1p(counts).float()

    card = torch.tensor(a["cardinalities"], dtype=torch.float64, device=dev)
    u = torch.rand(n, n_cat, generator=g, device=dev, dtype=torch.float64)
    ranks = zipf_ranks(u, card, float(a["zipf_exponent"]))
    del u
    keys = torch.arange(n_cat, device=dev, dtype=torch.int64) * (1 << KEY_BITS) + ranks
    cat_ids = n_int + (keys * HASH_PRIME) % (d - n_int - 1)
    del keys, ranks

    feats = torch.empty(n, n_int + n_cat + 1, dtype=torch.int64, device=dev)
    feats[:, :n_int] = torch.arange(n_int, device=dev)
    feats[:, n_int:n_int + n_cat] = cat_ids
    feats[:, -1] = d - 1
    vals = torch.ones(n, n_int + n_cat + 1, dtype=torch.float32, device=dev)
    vals[:, :n_int] = int_vals
    del cat_ids, int_vals, counts

    gm = torch.Generator(device=dev).manual_seed(stream_seed(data_seed, 2))
    w = torch.randn(d, generator=gm, device=dev) * a["planted_category_sigma"]
    w[:n_int] = torch.randn(n_int, generator=gm, device=dev) * a["planted_integer_sigma"]
    w[d - 1] = a["planted_bias"]
    margin = (vals * w[feats]).sum(1)
    labels = (torch.rand(n, generator=gm, device=dev) < torch.sigmoid(margin)).float()
    order = torch.randperm(n, generator=torch.Generator(device=dev).manual_seed(
        stream_seed(seed, 3)), device=dev)
    return {
        "feats": feats[order].cpu().numpy(),
        "vals": vals[order].cpu().numpy(),
        "labels": labels[order].cpu().numpy(),
    }
