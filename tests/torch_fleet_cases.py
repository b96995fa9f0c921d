"""Shared fleet fixtures for the port's routing and fleet-telemetry tests
(``tests/test_torch_shard_routing.py``, ``tests/test_torch_fleet_obs.py``):
in-process shard-server fleets on loopback TCP over the port's banks and
the port's single server as the bitwise oracle. Imports nothing of JAX."""

from __future__ import annotations

import numpy as np

from photon_ml_tpu_torch.serving import (
    MicroBatcher,
    ServingModel,
    ServingPrograms,
    ShardRouter,
    ShardServer,
    bank_from_arrays,
    requests_from_dataset,
)
from photon_ml_tpu_torch.utils.index_map import IndexMap
from torch_serving_cases import SHARDS, make_bank

LADDER = (1, 8)


def user_ids(lm):
    """The model's sorted entity universe — the router's index input."""
    return sorted(lm.random_effects["per-user"][2])


def build_fleet(lm, ds, n_shards, *, shards=SHARDS, recorders=None):
    """N in-process shard-servers over real sockets, each loading ONE
    entity shard of the model through the artifact-path bank builder."""
    servers = []
    for s in range(n_shards):
        bank = make_bank(lm, ds, entity_shard=(s, n_shards))
        sm = ServingModel(
            bank, ServingPrograms(LADDER), partial=True, entity_shard=(s, n_shards)
        )
        servers.append(
            ShardServer(
                sm,
                shards,
                (s, n_shards),
                recorder=recorders[s] if recorders else None,
            ).start()
        )
    return servers


def build_router(servers, entity_ids, **kw):
    kw.setdefault("shard_configs", SHARDS)
    router = ShardRouter(
        [("127.0.0.1", srv.port) for srv in servers],
        entity_ids=entity_ids,
        **kw,
    )
    router.connect()
    return router


def close_fleet(servers, router=None):
    if router is not None:
        router.close()
    for srv in servers:
        srv.close()


def single_server_scores(lm, ds):
    """The port's single server over the whole bank, one request at a time."""
    bank = make_bank(lm, ds)
    programs = ServingPrograms(LADDER)
    programs.ensure_compiled(bank)
    with MicroBatcher(lambda: bank, programs) as mb:
        return np.asarray(
            [mb.score(r) for r in requests_from_dataset(ds, bank)], np.float32
        )


def synthetic_bank_arrays(rng, *, scale=1.0, E=14, d_g=6, d_u=4):
    ids = sorted(f"user{i:02d}" for i in range(E))
    fe_w = (rng.standard_normal(d_g) * scale).astype(np.float32)
    re_w = (rng.standard_normal((E, d_u)) * scale).astype(np.float32)
    return ids, fe_w, re_w


def synthetic_fleet(arrays, n_shards, *, stagers=None, recorders=None):
    """In-memory fleet from raw arrays (``bank_from_arrays``) — the
    swap-under-traffic rig: ``stagers(s, sm, build)`` builds shard ``s``'s
    stage_swap handler."""
    ids, fe_w, re_w = arrays
    d_g, d_u = fe_w.shape[0], re_w.shape[1]
    widths = {"g": 4, "u": 4}
    imaps = {
        "g": IndexMap({f"g{j}\t": j for j in range(d_g)}),
        "u": IndexMap({f"u{j}\t": j for j in range(d_u)}),
    }

    def build(s, n, fe, re):
        return bank_from_arrays(
            fixed=[("global", "g", fe)],
            random=[("per-user", "userId", "u", re, ids)],
            shard_widths=widths,
            index_maps=imaps,
            entity_shard=(s, n),
            device="cpu",
        )

    servers = []
    for s in range(n_shards):
        sm = ServingModel(
            build(s, n_shards, fe_w, re_w),
            ServingPrograms(LADDER),
            partial=True,
            entity_shard=(s, n_shards),
        )
        servers.append(
            ShardServer(
                sm,
                SHARDS,
                (s, n_shards),
                stager=stagers(s, sm, build) if stagers is not None else None,
                has_response=False,
                recorder=recorders[s] if recorders else None,
            ).start()
        )
    return servers, build


def synthetic_records(rng, ids, n=30):
    return [
        {
            "uid": f"q{i}",
            "metadataMap": {"userId": ids[i % len(ids)]},
            "features": [
                {"name": f"g{j}", "term": "", "value": float(rng.standard_normal())}
                for j in range(3)
            ],
            "userFeatures": [
                {"name": f"u{j}", "term": "", "value": float(rng.standard_normal())}
                for j in range(2)
            ],
            "offset": float(rng.normal() * 0.1),
        }
        for i in range(n)
    ]


def reference_router(arrays):
    """A single-shard fleet as the bitwise oracle for synthetic banks."""
    servers, _build = synthetic_fleet(arrays, 1)
    router = build_router(servers, {"userId": arrays[0]}, cache_entries=0)
    return servers, router
