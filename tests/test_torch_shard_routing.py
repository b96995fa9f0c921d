"""The port's serving fleet on the CPU (``serving/routing.py``,
``serving/shard_server.py``): in-process shard-server fleets on loopback
TCP behind the scatter/gather router.

Routed scores at N in {1, 2, 4} are bitwise the port's single server and
batch scorer (offsets and the unknown-entity row included), and within
1e-6 of the output's scale of the JAX package's batch scorer, called
directly on the same records and coefficients (float32 sums in another
order). A dead or stalled shard degrades only its own entities to their
FE-only score, bitwise; the generation-keyed cache serves replays
bitwise with zero fan-out and is purged at the two-step flip; the
interleaving harness drives the router's fan-out, cache and swap plane
through seeded schedules: every call terminal, no deadlock, no score
across generations.
"""

import threading
import time

import numpy as np
import pytest

from photon_ml_tpu_torch import ownership
from photon_ml_tpu_torch.game.data import build_game_dataset
from photon_ml_tpu_torch.game.model_io import LoadedGameModel
from photon_ml_tpu_torch.serving import (
    MicroBatcher,
    NoShardAvailable,
    RoutingPolicy,
    ServingError,
    ServingPrograms,
    ShardRouter,
    requests_from_dataset,
)
from photon_ml_tpu_torch.serving.programs import term_entries
from photon_ml_tpu_torch.serving.routing import FE_SLOT, HotEntityCache, TransportError
from photon_ml_tpu_torch.serving.swap import SwapResult
from photon_ml_tpu_torch.testing import explore
from torch_fleet_cases import (
    LADDER,
    build_fleet,
    build_router,
    close_fleet,
    reference_router,
    single_server_scores,
    synthetic_bank_arrays,
    synthetic_fleet,
    synthetic_records,
    user_ids,
)
from torch_parity import assert_close_to_scale
from torch_serving_cases import (
    SHARDS,
    Client,
    batch_reference_scores,
    make_bank,
    synth_model_dicts,
    synth_records,
)


def _dataset(recs, shards=SHARDS, re_types=("userId",)):
    return build_game_dataset(recs, shards, list(re_types), device="cpu")


def _model(fixed, random, mf=None):
    lm = LoadedGameModel()
    lm.fixed_effects, lm.random_effects = dict(fixed), dict(random)
    if mf:
        lm.matrix_factorizations = dict(mf)
    return lm


def jax_batch_scores(recs, fixed, random, mf=None, re_types=("userId",)):
    """The JAX package's batch scorer on the same records and
    coefficients: raw scores + offsets."""
    import jax.numpy as jnp

    from photon_ml_tpu.game.config import FeatureShardConfiguration as RefShard
    from photon_ml_tpu.game.data import build_game_dataset as ref_build
    from photon_ml_tpu.game.model_io import LoadedGameModel as RefLoaded
    from photon_ml_tpu.task import TaskType as RefTaskType

    ref = RefLoaded()
    ref.fixed_effects, ref.random_effects = dict(fixed), dict(random)
    if mf:
        ref.matrix_factorizations = dict(mf)
    ds = ref_build(
        recs, [RefShard(s.shard_id, s.feature_bags) for s in SHARDS], list(re_types)
    )
    out = ref.score(ds, RefTaskType.LOGISTIC_REGRESSION) + jnp.asarray(ds.offsets)
    return np.asarray(out)[: ds.num_real_rows]


def _owned_by(recs, ids, shard, n):
    return [
        r for r in recs
        if r["metadataMap"]["userId"] in ids
        and ownership.owner_of(ids.index(r["metadataMap"]["userId"]), n) == shard
    ]


class TestRoutedParity:
    @pytest.mark.parametrize("n_shards", [1, 2, 4])
    def test_routed_bitwise_vs_single_server_batch_and_jax(self, rng, n_shards):
        """Every routed margin is bit for bit the port's batch scorer and
        single server (offsets and the unknown entity included), and
        within 1e-6 of scale of the JAX package's batch scorer."""
        recs = synth_records(rng)
        ds = _dataset(recs)
        fixed, random = synth_model_dicts(rng)
        lm = _model(fixed, random)
        ref_batch = batch_reference_scores(lm, ds)
        assert np.array_equal(single_server_scores(lm, ds), ref_batch)
        servers = build_fleet(lm, ds, n_shards)
        router = build_router(servers, {"userId": user_ids(lm)})
        try:
            got = [router.score_record(r) for r in recs]
            routed = np.asarray(got, np.float32)
            assert np.array_equal(routed, ref_batch)
            # the unknown entity (user6) is not degraded: the zero term
            for rec, out in zip(recs, got):
                if rec["metadataMap"]["userId"] == "user6":
                    assert out.degraded is False
            assert all(out.generation == 1 for out in got)
            assert all(out.fanout == 1 for out in got)
        finally:
            close_fleet(servers, router)
        assert_close_to_scale(routed, jax_batch_scores(recs, fixed, random), rtol=1e-6)

    def test_binary_wire_routes_bitwise(self, rng):
        """photon-wire carries raw float32 halves: negotiated binary
        routing gives the JSON plane's bits."""
        recs = synth_records(rng, n=30)
        ds = _dataset(recs)
        lm = _model(*synth_model_dicts(rng))
        ref = batch_reference_scores(lm, ds)
        servers = build_fleet(lm, ds, 2)
        router = ShardRouter(
            [("127.0.0.1", s.port) for s in servers],
            entity_ids={"userId": user_ids(lm)},
            shard_configs=SHARDS,
            wire="binary",
        )
        try:
            assert router.connect()["wire"] == "binary"
            got = np.asarray([router.score_record(r) for r in recs], np.float32)
            assert np.array_equal(got, ref)
        finally:
            close_fleet(servers, router)

    def test_two_fixed_effects_a_random_effect_and_mf(self, rng):
        """A spec with two fixed effects, a random effect and an MF: the
        FE prefix precedes every per-entity term, so the router's
        FE-then-terms sum is the full program's order, bitwise."""
        recs = synth_records(rng, n=40)
        for r in recs:
            r["metadataMap"]["itemId"] = f"item{int(rng.integers(0, 5))}"
            r["metadataMap"]["ctxId"] = f"ctx{int(rng.integers(0, 4))}"
        re_types = ("ctxId", "itemId", "userId")
        ds = _dataset(recs, re_types=re_types)
        fixed, random = synth_model_dicts(rng)
        fixed["global-u"] = ("u", {f"u{j}\t": float(rng.normal()) for j in range(3)})
        # every shard holds the whole MF (the FE provider answers it), so
        # its id types are not a sharded random effect's; one item unknown
        mf = {
            "mf": (
                "itemId", "ctxId",
                {f"item{e}": rng.normal(size=4).astype(np.float32) for e in range(4)},
                {f"ctx{e}": rng.normal(size=4).astype(np.float32) for e in range(4)},
            )
        }
        lm = _model(fixed, random, mf)
        bank = make_bank(lm, ds)
        kinds = [e[0] for e in bank.spec]
        assert kinds[:2] == ["fe", "fe"] and set(kinds[2:]) == {"re", "mf"}
        ref = batch_reference_scores(lm, ds)
        servers = build_fleet(lm, ds, 2)
        router = build_router(
            servers,
            {
                "userId": user_ids(lm),
                "itemId": sorted(mf["mf"][2]),
                "ctxId": sorted(mf["mf"][3]),
            },
        )
        try:
            routed = np.asarray([router.score_record(r) for r in recs], np.float32)
            assert np.array_equal(routed, ref)
        finally:
            close_fleet(servers, router)
        assert_close_to_scale(
            routed, jax_batch_scores(recs, fixed, random, mf, re_types), rtol=1e-6
        )

    def test_interleaved_spec_is_refused(self):
        spec = (
            ("fe", "a", "g", 5, 8),
            ("re", "per-user", "userId", "u", 4, 8),
            ("fe", "b", "u", 3, 8),
        )
        with pytest.raises(ValueError, match="follows a per-entity entry"):
            term_entries(spec)

    def test_partial_recomposition_matches_full_program(self, rng):
        """fe + spec-ordered f32 term adds + offset == the full program,
        bitwise."""
        recs = synth_records(rng)
        ds = _dataset(recs)
        lm = _model(*synth_model_dicts(rng))
        bank = make_bank(lm, ds)
        programs = ServingPrograms(LADDER)
        reqs = requests_from_dataset(ds, bank)
        with MicroBatcher(lambda: bank, programs) as mb:
            full = [mb.score(r) for r in reqs]
        with MicroBatcher(lambda: bank, programs, partial=True) as mb:
            parts = [mb.score(r) for r in reqs]
        names = [e[1] for e in term_entries(bank.spec)]
        for req, f, p in zip(reqs, full, parts):
            total = np.float32(p.fe)
            for name in names:
                total = np.float32(total + np.float32(p.terms[name]))
            total = np.float32(total + np.float32(req.offset))
            assert np.float32(f) == total

    def test_topology_op_and_status_publish_shard_layout(self, rng):
        recs = synth_records(rng, n=10)
        ds = _dataset(recs)
        lm = _model(*synth_model_dicts(rng))
        servers = build_fleet(lm, ds, 2)
        try:
            c = Client(servers[1].port)
            topo = c.ask({"op": "topology", "uid": "t1"})
            assert topo["uid"] == "t1" and topo["status"] == "ok"
            assert (topo["shard_index"], topo["shard_count"]) == (1, 2)
            assert topo["rule"] == ownership.OWNERSHIP_RULE
            assert topo["generation"] == 1
            assert topo["partial"] is True and topo["ready"] is True
            assert topo["entries"] == [["re", "per-user", ["userId"], "u"]]
            assert "binary" in topo["wire"]["protocols"]
            status = c.ask({"op": "status"})
            assert status["shard"]["shard_index"] == 1
            assert status["shard"]["rule"] == ownership.OWNERSHIP_RULE
            c.close()
        finally:
            close_fleet(servers)

    def test_misordered_fleet_is_refused(self, rng):
        recs = synth_records(rng, n=10)
        ds = _dataset(recs)
        lm = _model(*synth_model_dicts(rng))
        servers = build_fleet(lm, ds, 2)
        try:
            router = ShardRouter(
                [("127.0.0.1", servers[1].port), ("127.0.0.1", servers[0].port)],
                entity_ids={"userId": user_ids(lm)},
                shard_configs=SHARDS,
            )
            with pytest.raises(ValueError, match="ownership rule|index"):
                router.connect()
            router.close()
        finally:
            close_fleet(servers)

    def test_router_requires_sorted_entity_universe(self):
        with pytest.raises(ValueError, match="SORTED"):
            ShardRouter([("127.0.0.1", 1)], entity_ids={"userId": ["b", "a"]})


class TestDegradation:
    def test_dead_shard_degrades_its_entities_fe_only(self, rng):
        """One shard dies, not the service: its entities answer their
        FE-only score plus the offset (bitwise the batch scorer over the
        FE-only model), the other shard's entities stay exact."""
        recs = synth_records(rng)
        ds = _dataset(recs)
        fixed, random = synth_model_dicts(rng)
        lm = _model(fixed, random)
        ref_full = batch_reference_scores(lm, ds)
        ref_fe = batch_reference_scores(_model(fixed, {}), ds)
        servers = build_fleet(lm, ds, 2)
        router = build_router(
            servers, {"userId": user_ids(lm)},
            policy=RoutingPolicy(subrequest_timeout_s=1.0),
        )
        try:
            servers[1].close()
            ids = user_ids(lm)
            for i, rec in enumerate(recs[:20]):
                uid = rec["metadataMap"]["userId"]
                out = router.score_record(rec)
                owner = ownership.owner_of(ids.index(uid), 2) if uid in ids else None
                if owner == 1:
                    assert out.degraded is True and out.degraded_shards == (1,)
                    assert np.float32(out) == np.float32(ref_fe[i]), i
                else:
                    assert out.degraded is False
                    assert np.float32(out) == np.float32(ref_full[i]), i
            assert router.health[1].snapshot()["failures"] >= 1
            assert router.health[0].snapshot()["failures"] == 0
        finally:
            close_fleet(servers[:1], router)

    def test_stalled_shard_hedged_then_shed_within_budget(self, rng):
        recs = synth_records(rng)
        ds = _dataset(recs)
        lm = _model(*synth_model_dicts(rng))
        servers = build_fleet(lm, ds, 2)
        router = build_router(
            servers, {"userId": user_ids(lm)},
            policy=RoutingPolicy(subrequest_timeout_s=0.6),
        )
        try:
            rec = _owned_by(recs, user_ids(lm), 1, 2)[0]
            # wedge shard 1's dispatcher: dispatch cannot run while the
            # swap exclusion lock is held
            gate = servers[1].serving_model.dispatch_lock
            gate.acquire()
            try:
                t0 = time.perf_counter()
                out = router.score_record(rec)
                elapsed = time.perf_counter() - t0
            finally:
                gate.release()
            assert out.degraded is True and out.degraded_shards == (1,)
            assert elapsed < 5.0
            assert router.metrics.snapshot()["hedges"] >= 1
            assert router.score_record(rec).degraded is False
        finally:
            close_fleet(servers, router)

    def test_all_shards_down_is_named_refusal(self, rng):
        recs = synth_records(rng, n=5)
        ds = _dataset(recs)
        lm = _model(*synth_model_dicts(rng))
        servers = build_fleet(lm, ds, 2)
        router = build_router(
            servers, {"userId": user_ids(lm)},
            policy=RoutingPolicy(subrequest_timeout_s=0.4),
        )
        try:
            for srv in servers:
                srv.close()
            with pytest.raises(NoShardAvailable):
                router.score_record(recs[0])
            assert router.metrics.snapshot()["failed"] == 1
        finally:
            router.close()

    def test_circuit_breaker_skips_dead_shard_without_waiting(self, rng):
        recs = synth_records(rng)
        ds = _dataset(recs)
        lm = _model(*synth_model_dicts(rng))
        servers = build_fleet(lm, ds, 2)
        router = build_router(
            servers, {"userId": user_ids(lm)},
            policy=RoutingPolicy(
                subrequest_timeout_s=0.4, fail_threshold=2, cooldown_s=60.0,
                hedge=False,
            ),
        )
        try:
            servers[1].close()
            owned = _owned_by(recs, user_ids(lm), 1, 2)
            for rec in owned[:2]:
                router.score_record(rec)  # trip the breaker
            assert not router.health[1].allow()
            t0 = time.perf_counter()
            out = router.score_record(owned[2])
            assert out.degraded is True
            assert time.perf_counter() - t0 < 0.2
        finally:
            close_fleet(servers[:1], router)


def _swap_stagers(fe2, re2):
    def stagers(s, sm, build):
        return lambda obj: sm.prepare_swap_bank(build(s, sm.entity_shard[1], fe2, re2))

    return stagers


class TestHotEntityCache:
    def test_replay_serves_from_cache_bitwise_with_zero_fanout(self, rng):
        arrays = synthetic_bank_arrays(rng)
        ids = arrays[0]
        servers, _build = synthetic_fleet(arrays, 2)
        router = build_router(servers, {"userId": ids})
        try:
            recs = synthetic_records(rng, ids)
            cold = [router.score_record(r) for r in recs]
            warm = [router.score_record(r) for r in recs]
            assert np.array_equal(np.asarray(cold, np.float32), np.asarray(warm, np.float32))
            assert all(w.cache_hit and w.fanout == 0 for w in warm)
            assert router.cache.snapshot()["hits"] >= len(recs)
        finally:
            close_fleet(servers, router)

    def test_degraded_responses_never_populate_the_cache(self, rng):
        arrays = synthetic_bank_arrays(rng)
        ids = arrays[0]
        servers, _build = synthetic_fleet(arrays, 2)
        router = build_router(
            servers, {"userId": ids},
            policy=RoutingPolicy(subrequest_timeout_s=0.4, hedge=False),
        )
        try:
            servers[1].close()
            rec = _owned_by(synthetic_records(rng, ids), ids, 1, 2)[0]
            assert router.score_record(rec).degraded
            out2 = router.score_record(rec)
            assert out2.degraded and not out2.cache_hit
            assert router.cache.snapshot()["hits"] == 0
        finally:
            close_fleet(servers[:1], router)

    def test_swap_commit_purges_cache_and_gen1_never_serves_gen2(self, rng):
        """A record cached at generation 1 answers generation 2's score
        (bitwise the generation-2 oracle) right after the two-step flip,
        and the purge is atomic at commit."""
        rng2 = np.random.default_rng(rng.integers(1 << 30))
        arrays1 = synthetic_bank_arrays(rng)
        ids = arrays1[0]
        fe2 = (arrays1[1] * -2.0).astype(np.float32)
        re2 = (arrays1[2] * 0.5).astype(np.float32)
        servers, _build = synthetic_fleet(arrays1, 2, stagers=_swap_stagers(fe2, re2))
        router = build_router(servers, {"userId": ids})
        o1_servers, oracle1 = reference_router(arrays1)
        o2_servers, oracle2 = reference_router((ids, fe2, re2))
        try:
            recs = synthetic_records(rng2, ids)
            ref1 = np.asarray([oracle1.score_record(r) for r in recs], np.float32)
            ref2 = np.asarray([oracle2.score_record(r) for r in recs], np.float32)
            cold = np.asarray([router.score_record(r) for r in recs], np.float32)
            assert np.array_equal(cold, ref1)
            assert all(router.score_record(r).cache_hit for r in recs)
            res = router.coordinate_swap("synthetic")
            assert res["ok"] and res["generation"] == 2, res
            assert res["cache_purged"] > 0
            after = [router.score_record(r) for r in recs]
            assert all(a.generation == 2 and not a.cache_hit for a in after)
            assert np.array_equal(np.asarray(after, np.float32), ref2)
            assert not np.array_equal(ref1, ref2)
            warm2 = [router.score_record(r) for r in recs]
            assert all(w.cache_hit for w in warm2)
            assert np.array_equal(np.asarray(warm2, np.float32), ref2)
        finally:
            close_fleet(servers, router)
            close_fleet(o1_servers, oracle1)
            close_fleet(o2_servers, oracle2)

    def test_failed_stage_aborts_fleet_wide_nobody_flips(self, rng):
        arrays = synthetic_bank_arrays(rng)
        ids = arrays[0]

        def stagers(s, sm, build):
            if s == 0:
                return lambda obj: sm.prepare_swap_bank(
                    build(s, sm.entity_shard[1], arrays[1], arrays[2])
                )
            return lambda obj: SwapResult(ok=False, generation=1, error="poisoned artifact")

        servers, _build = synthetic_fleet(arrays, 2, stagers=stagers)
        router = build_router(servers, {"userId": ids})
        try:
            recs = synthetic_records(rng, ids, n=8)
            before = np.asarray([router.score_record(r) for r in recs], np.float32)
            res = router.coordinate_swap("synthetic")
            assert res["ok"] is False and res["phase"] == "stage"
            assert res["failed_shard"] == 1
            assert router.generation == 1
            assert servers[0].serving_model._prepared is None
            after = [router.score_record(r) for r in recs]
            assert np.array_equal(before, np.asarray(after, np.float32))
            assert all(a.generation == 1 for a in after)
        finally:
            close_fleet(servers, router)

    def test_cache_unit_lru_and_generation_keying(self):
        cache = HotEntityCache(max_entries=2)
        cache.put((1, FE_SLOT, b"a"), 1.5)
        cache.put((1, "re", b"b"), 2.5)
        assert cache.get((1, FE_SLOT, b"a")) == 1.5
        cache.put((1, "re", b"c"), 3.5)  # evicts the LRU entry
        assert cache.get((1, "re", b"b")) is None
        assert cache.get((2, FE_SLOT, b"a")) is None
        assert cache.purge_other_generations(2) == 2
        assert cache.get((1, FE_SLOT, b"a")) is None
        snap = cache.snapshot()
        assert snap["entries"] == 0 and snap["purged"] == 2
        off = HotEntityCache(max_entries=0)
        off.put((1, FE_SLOT, b"a"), 1.0)
        assert off.get((1, FE_SLOT, b"a")) is None and not off.enabled


# -- interleaving schedules ---------------------------------------------------
#
# The router's fan-out/cache/swap plane under the deterministic scheduler:
# fake shards whose handlers are host float32 math, transports that
# resolve futures on cooperative threads, so every lock, future wait and
# virtual timeout in the real ShardRouter is a preemption point.

IDS16 = sorted(f"user{i:02d}" for i in range(16))


class _FakeShard:
    def __init__(self, index, count):
        self.index, self.count = index, count
        self.generation, self.staged, self.dead = 1, None, False
        self._lock = threading.Lock()

    @staticmethod
    def fe_of(record, gen):
        return np.float32(np.float32(gen * 1.25) + np.float32(record["features"][0]["value"]))

    @staticmethod
    def term_of(record, code, gen):
        return np.float32(
            np.float32(gen * 10.0 + code) + np.float32(record["userFeatures"][0]["value"])
        )

    def handle(self, obj):
        if self.dead:
            raise TransportError("shard process gone")
        op, uid = obj.get("op"), obj.get("uid")
        with self._lock:
            gen = self.generation
            if op == "topology":
                return {
                    "uid": uid, "status": "ok", "shard_index": self.index,
                    "shard_count": self.count, "rule": ownership.OWNERSHIP_RULE,
                    "generation": gen,
                    "entries": [["re", "per-user", ["userId"], "u"]],
                }
            if op == "stage_swap":
                self.staged = gen + 1
                return {"uid": uid, "status": "ok", "ok": True,
                        "generation": self.staged, "error": ""}
            if op == "commit_swap":
                if self.staged is None:
                    return {"uid": uid, "status": "error", "ok": False,
                            "generation": gen, "error": "nothing staged"}
                self.generation, self.staged = self.staged, None
                return {"uid": uid, "status": "ok", "ok": True,
                        "generation": self.generation, "error": ""}
            if op == "abort_swap":
                had, self.staged = self.staged is not None, None
                return {"uid": uid, "status": "ok", "aborted": had}
        entity = (obj.get("metadataMap") or {}).get("userId")
        code = IDS16.index(entity) if entity in IDS16 else -1
        term = 0.0
        if code >= 0 and ownership.owner_of(code, self.count) == self.index:
            term = float(self.term_of(obj, code, gen))
        return {
            "uid": obj["uid"], "status": "ok", "partial": True,
            "fe": float(self.fe_of(obj, gen)), "terms": {"per-user": term},
            "generation": gen, "degraded": False,
        }


class _FakeTransport:
    closed = False

    def __init__(self, shard):
        self.shard = shard

    def send_request(self, obj):
        from concurrent.futures import Future

        fut = Future()
        snapshot = dict(obj)

        def work():
            try:
                fut.set_result(self.shard.handle(snapshot))
            except BaseException as e:
                if not fut.done():
                    fut.set_exception(TransportError(str(e)))

        threading.Thread(target=work, daemon=True).start()
        return fut

    def request(self, obj, timeout_s):
        import concurrent.futures as cf

        try:
            return self.send_request(obj).result(timeout=max(timeout_s, 0.001))
        except (TimeoutError, cf.TimeoutError):
            raise TransportError("timeout") from None

    def abandon(self, uid):
        pass

    def close(self):
        pass


def _interleave_record(i):
    return {
        "uid": f"iv{i}",
        "metadataMap": {"userId": IDS16[i % len(IDS16)]},
        "features": [{"name": "g0", "term": "", "value": 0.125 * (i % 7)}],
        "userFeatures": [{"name": "u0", "term": "", "value": 0.25 * (i % 5)}],
        "offset": 0.0,
    }


def _expected_margin(record, gen, *, fe_only):
    code = IDS16.index(record["metadataMap"]["userId"])
    term = np.float32(0.0) if fe_only else _FakeShard.term_of(record, code, gen)
    total = np.float32(_FakeShard.fe_of(record, gen) + term)
    return np.float32(total + np.float32(record["offset"]))


class TestRouterInterleave:
    N_SHARDS = 2

    def _scenario(self, sched, *, kill_shard):
        results, failures, submitted = [], [], [0]
        with sched.patched():
            shards = [_FakeShard(i, self.N_SHARDS) for i in range(self.N_SHARDS)]
            router = ShardRouter(
                transport_factory=lambda i: _FakeTransport(shards[i]),
                num_shards=self.N_SHARDS,
                entity_ids={"userId": IDS16},
                shard_configs=SHARDS,
                policy=RoutingPolicy(subrequest_timeout_s=1.0, cooldown_s=0.5),
                cache_entries=64,
            )

            def scorer(base):
                def body():
                    # repeats on purpose: the cache must race the commit
                    for k in [0, 1, 2, 0, 1, 2]:
                        rec = _interleave_record(base + k)
                        submitted[0] += 1
                        try:
                            results.append((rec, router.score_record(rec)))
                        except ServingError as e:
                            results.append((rec, e))
                        except BaseException as e:
                            failures.append(e)
                            return

                return body

            def swapper():
                results.append(("swap", router.coordinate_swap("synthetic")))

            def driver():
                # connect and spawn on a scheduled task: waits on the
                # fake transports' futures must park on managed threads
                router.connect()
                workers = [
                    threading.Thread(target=scorer(4 * t), name=f"scorer{t}")
                    for t in range(3)
                ]
                workers.append(threading.Thread(target=swapper, name="swapper"))
                if kill_shard:
                    def killer():
                        shards[1].dead = True

                    workers.append(threading.Thread(target=killer, name="killer"))
                for w in workers:
                    w.start()

            sched.spawn(driver, name="driver")
            sched.run()

        def verify():
            assert not failures, failures[:2]
            outcomes = [r for r in results if r[0] != "swap"]
            assert len(outcomes) == submitted[0], "every call reaches one terminal outcome"
            for rec, out in outcomes:
                if isinstance(out, ServingError):
                    continue  # a named refusal is terminal
                assert out.generation in (1, 2), out.generation
                owner = ownership.owner_of(
                    IDS16.index(rec["metadataMap"]["userId"]), self.N_SHARDS
                )
                if out.degraded:
                    assert kill_shard and owner == 1
                    assert np.float32(out) == _expected_margin(
                        rec, out.generation, fe_only=True
                    )
                else:
                    # exact for its generation: a cached slot of the
                    # other generation matches neither expectation
                    assert np.float32(out) == _expected_margin(
                        rec, out.generation, fe_only=False
                    )
            swaps = [r[1] for r in results if r[0] == "swap"]
            if swaps and swaps[0]["ok"] and not kill_shard:
                assert all(s.generation == 2 for s in shards)

        return verify

    @pytest.mark.parametrize("kill_shard,seeds", [(False, range(10)), (True, range(10, 20))])
    def test_fanout_cache_swap_schedules(self, kill_shard, seeds):
        explore(lambda sched: self._scenario(sched, kill_shard=kill_shard), seeds=seeds)
