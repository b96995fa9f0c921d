"""The port's online scoring path (``photon_ml_tpu_torch/serving``,
``cli/serving_driver.py``) on the CPU: served scores bitwise equal to the
port's own batch scorer (offsets, unknown entities, FE-only degradation,
across hot swaps), and within 1e-6 of the output's scale of the JAX
package's ``ServingPrograms.score`` on the same bank (float32 sums in
another order); the row index (dict and native store), the ladder, the
program cache (LRU, single-flight warmup, nothing rebuilt after warmup or
on an in-place swap), one readback a dispatch, admission, deadlines,
drain, swap rollback and retries; the driver against the port's
``game_scoring_driver`` (bitwise) and the JAX package's serving driver
(1e-6 of scale), and the registry watcher's options held to the
reference's validation rules.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from conftest import game_example_schema
from photon_ml_tpu.game.model_io import LoadedGameModel as RefLoadedGameModel
from photon_ml_tpu.io.avro_codec import write_container
from photon_ml_tpu.serving import (
    RequestBatch as RefRequestBatch,
    ServingPrograms as RefServingPrograms,
    build_model_bank as ref_build_model_bank,
)
from photon_ml_tpu_torch.convert import serving_bank_from_reference
from photon_ml_tpu_torch.game.data import build_game_dataset
from photon_ml_tpu_torch.game.model_io import LoadedGameModel
from photon_ml_tpu_torch.io.avro_codec import read_avro_records
from photon_ml_tpu_torch.parallel import overlap
from photon_ml_tpu_torch.serving import (
    AdmissionController,
    BatcherClosed,
    DeadlineExceeded,
    DrainTimeout,
    EntityRowIndex,
    MicroBatcher,
    RequestBatch,
    RequestShed,
    ScoreOutcome,
    ServingMetrics,
    ServingModel,
    ServingPrograms,
    bank_from_arrays,
    build_model_bank,
    request_from_record,
    requests_from_dataset,
    select_shape,
)
from photon_ml_tpu_torch.serving.programs import term_entries
from torch_game_cases import make_records
from torch_parity import assert_close_to_scale
from torch_serving_cases import (
    SHARDS,
    batch_reference_scores,
    index_maps_and_widths,
    make_bank,
    synth_model,
    synth_model_dicts,
    synth_records,
    wait_until,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dataset(recs, shards=SHARDS, re_types=("userId",)):
    return build_game_dataset(recs, shards, list(re_types), device="cpu")


@pytest.fixture
def served(rng):
    recs = synth_records(rng)
    ds = _dataset(recs)
    lm = synth_model(rng)
    bank = make_bank(lm, ds)
    programs = ServingPrograms((1, 8, 64))
    programs.ensure_compiled(bank)
    return recs, ds, lm, bank, programs


class TestScoringParity:
    def test_serving_scores_bitwise_match_batch_scorer(self, served):
        """The request path reproduces the port's batch scoring driver's
        scores BITWISE, including offsets and masked unknown entities."""
        _, ds, lm, bank, programs = served
        ref = batch_reference_scores(lm, ds)
        with MicroBatcher(lambda: bank, programs, ServingMetrics()) as mb:
            futs = [mb.submit(r) for r in requests_from_dataset(ds, bank)]
            got = np.asarray([f.result() for f in futs], np.float32)
        assert np.array_equal(got, ref)

    def test_single_request_dispatches_shape_one(self, served):
        _, ds, lm, bank, programs = served
        ref = batch_reference_scores(lm, ds)
        metrics = ServingMetrics()
        reqs = requests_from_dataset(ds, bank)
        with MicroBatcher(lambda: bank, programs, metrics) as mb:
            for i in (0, 7, 23):
                assert mb.score(reqs[i]) == ref[i]
        snap = metrics.snapshot()
        assert snap["shape_counts"] == {"1": 3}
        assert snap["pad_waste_frac"] == 0.0

    def test_every_ladder_shape_scores_bitwise(self, served):
        """Each rung's program on the same rows: equal to the batch
        scorer at n = the whole dataset, whatever the padded shape."""
        _, ds, lm, bank, programs = served
        ref = batch_reference_scores(lm, ds)
        reqs = requests_from_dataset(ds, bank)
        batcher = MicroBatcher(lambda: bank, programs)
        try:
            for B in programs.ladder:
                take = reqs[:B]
                batch, _ = batcher._assemble(take, bank, B)
                out = overlap.device_get(programs.score(bank, batch))
                assert np.array_equal(out[: len(take)], ref[: len(take)]), B
        finally:
            batcher.close()

    def test_unknown_entity_scores_through_fe_only(self, served):
        recs, ds, lm, bank, _ = served
        missing = "user6"
        assert any(r["metadataMap"]["userId"] == missing for r in recs)
        assert bank.entity_row("userId", missing) == -1
        assert bank.entity_row("userId", "user0") >= 0

    def test_fe_only_model_under_multi_shard_config(self, served):
        """An FE-only model served with a multi-shard request config: the
        batch assembles (and the program runs) on exactly the spec's
        shards, scoring bitwise the FE-only batch path."""
        _, ds, lm, _bank, _ = served
        fe = LoadedGameModel()
        fe.fixed_effects = dict(lm.fixed_effects)
        bank = make_bank(fe, ds)
        assert set(bank.shard_widths) == {"g", "u"}
        assert bank.used_shards == ("g",)
        programs = ServingPrograms((1, 8))
        programs.ensure_compiled(bank)
        ref = batch_reference_scores(fe, ds)
        with MicroBatcher(lambda: bank, programs) as mb:
            got = np.asarray(
                [mb.score(r) for r in requests_from_dataset(ds, bank)],
                np.float32,
            )
        assert np.array_equal(got, ref)

    def test_record_assembly_matches_dataset_assembly(self, served):
        recs, ds, lm, bank, programs = served
        ref = batch_reference_scores(lm, ds)
        with MicroBatcher(lambda: bank, programs) as mb:
            for i in (0, 11, 42):
                assert mb.score(request_from_record(recs[i], bank, SHARDS)) == ref[i]

    def test_record_width_overflow_raises(self, served):
        recs, ds, lm, bank, _ = served
        fat = dict(recs[0])
        fat["features"] = [
            {"name": f"g{j % 5}", "term": "", "value": 1.0}
            for j in range(bank.shard_widths["g"] + 1)
        ]
        with pytest.raises(ValueError, match="exceeds shard"):
            request_from_record(fat, bank, SHARDS)

    def test_record_missing_id_omits_metadata_and_scores_fe_only(self, served):
        recs, ds, lm, bank, programs = served
        bare = dict(recs[0])
        bare.pop("metadataMap")
        req = request_from_record(bare, bank, SHARDS)
        assert req.entity_ids == {"userId": None}
        assert req.metadata is None
        unknown = dict(recs[0])
        unknown["metadataMap"] = {"userId": "no-such-user"}
        req_unknown = request_from_record(unknown, bank, SHARDS)
        assert req_unknown.metadata == {"userId": "no-such-user"}
        with MicroBatcher(lambda: bank, programs) as mb:
            assert mb.score(req) == mb.score(req_unknown)

    def test_matrix_factorization_scores_bitwise(self, rng):
        """An MF coordinate beside the FE and RE: the latent dot product
        masked where either entity is unknown, bitwise the batch scorer."""
        recs = synth_records(rng)
        for r in recs:
            r["metadataMap"]["itemId"] = f"item{int(rng.integers(0, 5))}"
        ds = _dataset(recs, re_types=("itemId", "userId"))
        lm = synth_model(rng)
        lm.matrix_factorizations["mf"] = (
            "userId", "itemId",
            # the RE's users (one entity set an id type), one item unknown
            {f"user{e}": rng.normal(size=4).astype(np.float32) for e in range(6)},
            {f"item{e}": rng.normal(size=4).astype(np.float32) for e in range(4)},
        )
        bank = make_bank(lm, ds)
        programs = ServingPrograms((1, 8, 64))
        ref = batch_reference_scores(lm, ds)
        with MicroBatcher(lambda: bank, programs) as mb:
            futs = [mb.submit(r) for r in requests_from_dataset(ds, bank)]
            got = np.asarray([f.result() for f in futs], np.float32)
        assert np.array_equal(got, ref)


class TestRowSum:
    """The batch scorer's and the programs' one per-row sum: an explicit
    pairwise tree over the zero-padded row, so its bits depend on the
    row's length only (on the card ``.sum(dim=-1)``'s thread layout
    follows the batch shape: rows of 72 summed differently at n = 1 and
    n = 8,192, NVIDIA H100 80GB HBM3)."""

    @staticmethod
    def _pairwise(row):
        row = np.asarray(row, np.float32)
        width = 1 << max(len(row) - 1, 0).bit_length()
        row = np.concatenate([row, np.zeros(width - len(row), np.float32)])
        while len(row) > 1:
            half = len(row) // 2
            row = (row[:half] + row[half:]).astype(np.float32)
        return row[0]

    @pytest.mark.parametrize("k", [0, 1, 5, 8, 33, 40, 64, 72])
    def test_matches_a_pairwise_tree_at_every_batch_size(self, rng, k):
        from photon_ml_tpu_torch.data.batch import row_sum

        x = (rng.standard_normal((300, k)) * 10.0 ** rng.integers(-3, 4, (300, k))).astype(np.float32)
        full = row_sum(torch.as_tensor(x)).numpy()
        want = np.asarray([self._pairwise(r) for r in x], np.float32)
        assert np.array_equal(full, want)
        for B in (1, 8, 64):
            part = row_sum(torch.as_tensor(x[:B])).numpy()
            assert np.array_equal(part, full[:B])

    def test_served_rows_of_an_odd_width_are_bitwise(self, rng):
        """Rows of 72 and 40 features (run H's padded widths) served at
        every ladder shape equal the batch scorer at n = all rows."""
        recs = synth_records(rng, n=70, d_g=65, d_u=33)
        ds = _dataset(recs)
        assert (ds.shards["g"].indices.shape[1], ds.shards["u"].indices.shape[1]) == (72, 40)
        lm = synth_model(rng, d_g=65, d_u=33)
        bank = make_bank(lm, ds)
        ref = batch_reference_scores(lm, ds)
        programs = ServingPrograms((1, 8, 64))
        batcher = MicroBatcher(lambda: bank, programs)
        try:
            reqs = requests_from_dataset(ds, bank)
            for B in programs.ladder:
                batch, _ = batcher._assemble(reqs[-B:], bank, B)
                out = overlap.device_get(programs.score(bank, batch))
                assert np.array_equal(out, ref[-B:]), B
        finally:
            batcher.close()


class TestReferenceParity:
    """The port's programs against the JAX package's on one bank carried
    across as numpy (``convert.serving_bank_from_reference``)."""

    def _both(self, rng):
        recs = synth_records(rng, n=40)
        fixed, random = synth_model_dicts(rng)
        ref_lm = RefLoadedGameModel()
        ref_lm.fixed_effects, ref_lm.random_effects = fixed, random
        from photon_ml_tpu.game.data import build_game_dataset as ref_build
        from photon_ml_tpu.game.config import FeatureShardConfiguration as RefShard

        ref_ds = ref_build(
            recs, [RefShard(s.shard_id, s.feature_bags) for s in SHARDS], ["userId"]
        )
        imaps = {sid: sd.index_map for sid, sd in ref_ds.shards.items()}
        widths = {sid: sd.indices.shape[1] for sid, sd in ref_ds.shards.items()}
        ref_bank = ref_build_model_bank(ref_lm, imaps, widths)
        self._loaded = LoadedGameModel()
        self._loaded.fixed_effects, self._loaded.random_effects = fixed, random
        port_bank = serving_bank_from_reference(
            ref_bank.spec,
            {k: np.asarray(v) for k, v in ref_bank.arrays.items()},
            {t: idx.ids for t, idx in ref_bank.entity_rows.items()},
            ref_bank.shard_widths,
            device="cpu",
        )
        ds = _dataset(recs)
        return recs, ref_bank, port_bank, ds

    def test_programs_match_reference_programs(self, rng):
        recs, ref_bank, port_bank, ds = self._both(rng)
        reqs = requests_from_dataset(ds, port_bank)
        ref_programs = RefServingPrograms((8, 64))
        programs = ServingPrograms((8, 64))
        batcher = MicroBatcher(lambda: port_bank, programs)
        try:
            for B, take in ((8, reqs[:5]), (64, reqs)):
                batch, _ = batcher._assemble(take, port_bank, B)
                got = overlap.device_get(programs.score(port_bank, batch))
                want = np.asarray(ref_programs.score(
                    ref_bank, RefRequestBatch(*batch)
                ))
                assert_close_to_scale(got, want, rtol=1e-6)
                got_fe, got_terms = overlap.device_get(
                    programs.score_partial(port_bank, batch)
                )
                want_fe, want_terms = ref_programs.score_partial(
                    ref_bank, RefRequestBatch(*batch)
                )
                assert_close_to_scale(got_fe, np.asarray(want_fe), rtol=1e-6)
                assert_close_to_scale(got_terms, np.asarray(want_terms), rtol=1e-6)
        finally:
            batcher.close()

    def test_converted_bank_is_the_native_bank(self, rng):
        """The port's own build over the port's dataset gives the JAX
        package's bank: the same spec, the same arrays (bitwise) and the
        same entity rows."""
        recs, ref_bank, port_bank, ds = self._both(rng)
        assert port_bank.spec == ref_bank.spec
        own = make_bank(self._loaded, ds)
        assert own.spec == ref_bank.spec
        for name, arr in own.arrays.items():
            assert np.array_equal(arr.numpy(), np.asarray(ref_bank.arrays[name])), name
            assert torch.equal(arr, port_bank.arrays[name]), name
        assert own.entity_rows["userId"].ids == ref_bank.entity_rows["userId"].ids

    def test_term_entries_match_reference(self, rng):
        from photon_ml_tpu.serving.programs import term_entries as ref_terms

        _, ref_bank, port_bank, _ = self._both(rng)
        assert term_entries(port_bank.spec) == ref_terms(ref_bank.spec)


class TestEntityRowIndex:
    def test_dict_backend(self):
        idx = EntityRowIndex(["a", "b", "c"])
        assert idx.backend == "dict"
        assert [idx.row_of(e) for e in ("a", "c", "zz")] == [0, 2, -1]
        assert idx.rows_of(["b", "nope", "a"]).tolist() == [1, -1, 0]

    def test_native_backend_matches_dict(self):
        """Above the threshold the rows come from the native store
        (``native/index_store.cpp``, built with g++ at first use)."""
        ids = [f"member-{i}" for i in range(257)]
        native = EntityRowIndex(ids, native_threshold=1)
        assert native.backend == "native"
        plain = EntityRowIndex(ids)
        probe = ids[::13] + ["member-9999", ""]
        assert native.rows_of(probe).tolist() == plain.rows_of(probe).tolist()
        assert native.row_of("member-5") == 5
        assert native.row_of("nope") == -1

    def test_native_bank_serves_bitwise(self, rng):
        recs = synth_records(rng)
        ds = _dataset(recs)
        lm = synth_model(rng)
        bank = make_bank(lm, ds, native_index_threshold=1)
        assert bank.entity_rows["userId"].backend == "native"
        ref = batch_reference_scores(lm, ds)
        with MicroBatcher(lambda: bank, ServingPrograms((1, 8, 64))) as mb:
            futs = [mb.submit(r) for r in requests_from_dataset(ds, bank)]
            got = np.asarray([f.result() for f in futs], np.float32)
        assert np.array_equal(got, ref)


class TestModelBank:
    def test_entity_padding_and_device_bytes(self, served):
        _, ds, lm, bank, _ = served
        re_entry = next(e for e in bank.spec if e[0] == "re")
        assert re_entry[4] == 256  # 6 users round up to one pad bucket
        assert bank.arrays["per-user"].shape == (256, ds.shards["u"].index_map.size)
        expected = sum(a.numel() * 4 for a in bank.arrays.values())
        assert bank.device_bytes() == expected
        assert bank.device == torch.device("cpu")

    def test_bank_from_arrays_pads_and_shards(self, rng):
        w = rng.standard_normal(16).astype(np.float32)
        b = rng.standard_normal((10, 6)).astype(np.float32)
        ids = [f"e{i:02d}" for i in range(10)]
        bank = bank_from_arrays(
            fixed=[("global", "g", w)],
            random=[("per-e", "eid", "g", b, ids)],
            shard_widths={"g": 3}, entity_pad_to=8, device="cpu",
        )
        assert bank.arrays["per-e"].shape == (16, 6)
        assert np.array_equal(bank.arrays["per-e"][:10].numpy(), b)
        half = bank_from_arrays(
            random=[("per-e", "eid", "g", b, ids)],
            shard_widths={"g": 3}, entity_pad_to=8, entity_shard=(1, 2),
            device="cpu",
        )
        assert half.entity_rows["eid"].ids == ids[1::2]
        assert np.array_equal(half.arrays["per-e"][:5].numpy(), b[1::2])
        assert half.entity_row("eid", "e00") == -1

    def test_host_staging_bank_and_the_card_default(self, served, monkeypatch):
        _, ds, lm, _, _ = served
        staged = make_bank(lm, ds, device=False)
        assert staged.device is None
        assert isinstance(staged.arrays["global"], np.ndarray)
        with pytest.raises(ValueError, match="placed bank"):
            ServingModel(staged, ServingPrograms((1,)))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_bank(lm, ds, device=None)


class TestLadder:
    def test_select_shape_picks_smallest_fit(self):
        ladder = (1, 8, 64, 256)
        assert select_shape(1, ladder) == 1
        assert select_shape(2, ladder) == 8
        assert select_shape(8, ladder) == 8
        assert select_shape(65, ladder) == 256
        with pytest.raises(ValueError):
            select_shape(257, ladder)

    def test_bad_ladder_rejected(self):
        with pytest.raises(ValueError):
            ServingPrograms((8, 1))
        with pytest.raises(ValueError):
            ServingPrograms(())

    def test_coalesced_batches_use_ladder_shapes(self, served):
        _, ds, lm, bank, programs = served
        metrics = ServingMetrics()
        reqs = requests_from_dataset(ds, bank)
        with MicroBatcher(lambda: bank, programs, metrics) as mb:
            for f in [mb.submit(r) for r in reqs]:
                f.result()
        snap = metrics.snapshot()
        assert {int(s) for s in snap["shape_counts"]} <= {1, 8, 64}
        assert snap["requests"] == len(reqs)
        padded = sum(int(s) * c for s, c in snap["shape_counts"].items())
        assert snap["batch_occupancy_mean"] == pytest.approx(len(reqs) / padded)

    def test_max_wait_coalesces_trickled_requests(self, served):
        _, ds, lm, bank, programs = served
        metrics = ServingMetrics()
        reqs = requests_from_dataset(ds, bank)[:8]
        with MicroBatcher(lambda: bank, programs, metrics, max_wait_s=0.25) as mb:
            for f in [mb.submit(r) for r in reqs]:
                f.result()
        assert metrics.snapshot()["dispatches"] < len(reqs)


class TestProgramCache:
    def _bank(self, rng, d):
        return bank_from_arrays(
            fixed=[("global", "g", rng.standard_normal(d).astype(np.float32))],
            shard_widths={"g": 4}, device="cpu",
        )

    def test_eviction_is_lru_not_fifo(self, rng):
        bank_a = self._bank(rng, 16)
        bank_b = self._bank(rng, 32)
        programs = ServingPrograms((1, 8), max_entries=3)
        programs.ensure_compiled(bank_a)
        assert programs.executable(bank_a.spec, 1) is not None
        programs.ensure_compiled(bank_b)  # the 4th insert evicts ONE entry
        assert programs.executable(bank_a.spec, 1) is not None
        assert programs.executable(bank_a.spec, 8) is None

    def test_concurrent_warmup_compiles_each_shape_once(self, rng):
        bank = self._bank(rng, 16)
        programs = ServingPrograms((1, 8, 64))
        errors = []

        def warm():
            try:
                programs.ensure_compiled(bank)
            except BaseException as e:
                errors.append(e)

        threads = [threading.Thread(target=warm) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors, errors
        assert programs.stats()["compile_count"] == 3

    def test_cold_shape_on_the_hot_path_is_counted(self, rng):
        bank = self._bank(rng, 16)
        programs = ServingPrograms((1, 8))
        batch = RequestBatch(
            indices={"g": np.zeros((8, 4), np.int32)},
            values={"g": np.ones((8, 4), np.float32)},
            codes={}, offsets=np.zeros((8,), np.float32),
        )
        programs.score(bank, batch)
        assert programs.stats() == {
            "compiled_programs": 1, "compile_count": 1,
            "cold_dispatch_compiles": 1,
        }

    def test_partial_family_is_keyed_apart(self, served):
        _, ds, lm, bank, _ = served
        programs = ServingPrograms((1, 8))
        assert programs.ensure_compiled(bank) == 2
        assert programs.ensure_compiled(bank, partial=True) == 2
        assert programs.ensure_compiled(bank) == 0
        batcher = MicroBatcher(lambda: bank, programs, partial=True)
        try:
            reqs = requests_from_dataset(ds, bank)
            fe_only = LoadedGameModel()
            fe_only.fixed_effects = dict(lm.fixed_effects)
            full = batch_reference_scores(lm, ds)
            fe_ref = batch_reference_scores(fe_only, ds) - ds.offsets[: ds.num_real_rows]
            out = batcher.score(reqs[3])
            assert np.float32(out.fe) == np.float32(fe_ref[3])
            # recomposed in float32: fe + term + offset is the full score
            recomposed = (
                np.float32(out.fe) + np.float32(out.terms["per-user"])
            ) + np.float32(reqs[3].offset)
            assert recomposed == full[3]
        finally:
            batcher.close()


class TestMicroBatchDemux:
    def test_concurrent_submitters_each_get_their_own_score(self, served):
        _, ds, lm, bank, programs = served
        ref = batch_reference_scores(lm, ds)
        reqs = requests_from_dataset(ds, bank)
        errors = []

        def worker(idx):
            try:
                for i in idx:
                    got = mb.score(reqs[i])
                    assert got == ref[i], (i, got, ref[i])
            except BaseException as e:
                errors.append(e)

        with MicroBatcher(lambda: bank, programs) as mb:
            threads = [
                threading.Thread(target=worker, args=(range(t, len(reqs), 6),))
                for t in range(6)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not errors, errors

    def test_submit_after_close_raises(self, served):
        _, ds, _, bank, programs = served
        reqs = requests_from_dataset(ds, bank)
        mb = MicroBatcher(lambda: bank, programs)
        mb.close()
        with pytest.raises(RuntimeError, match="closed"):
            mb.submit(reqs[0])


class TestCompileAndReadbackContract:
    def test_zero_rebuilds_after_warmup(self, served):
        _, ds, lm, bank, programs = served
        reqs = requests_from_dataset(ds, bank)
        before = programs.stats()
        with MicroBatcher(lambda: bank, programs) as mb:
            for f in [mb.submit(r) for r in reqs]:
                f.result()
            for r in reqs[:5]:
                mb.score(r)
        after = programs.stats()
        assert after["compile_count"] == before["compile_count"] == 3
        assert after["cold_dispatch_compiles"] == 0

    def test_exactly_one_readback_per_dispatched_batch(self, served):
        _, ds, lm, bank, programs = served
        metrics = ServingMetrics()
        reqs = requests_from_dataset(ds, bank)
        with MicroBatcher(lambda: bank, programs, metrics) as mb:
            overlap.reset_readback_stats()
            for f in [mb.submit(r) for r in reqs]:
                f.result()
            for r in reqs[:4]:
                mb.score(r)
            assert overlap.readback_stats() == metrics.snapshot()["dispatches"]


class TestHotSwap:
    def _save(self, lm, path):
        from photon_ml_tpu_torch.game.model_io import save_loaded_game_model

        save_loaded_game_model(lm, str(path))

    def _fe_only(self, rng, scale):
        lm = LoadedGameModel()
        lm.fixed_effects["global"] = (
            "g", {f"g{j}\t": float(rng.normal()) * scale for j in range(5)},
        )
        return lm

    @pytest.fixture
    def two_generations(self, rng, tmp_path):
        recs = synth_records(rng)
        ds = _dataset(recs, [SHARDS[0]], [])
        gens = {}
        for name, scale in (("g1", 1.0), ("g2", -2.0)):
            lm = self._fe_only(rng, scale)
            self._save(lm, tmp_path / name)
            gens[name] = lm
        return ds, gens, tmp_path

    def _serving_model(self, ds, model_dir):
        imaps = {"g": ds.shards["g"].index_map}
        widths = {"g": ds.shards["g"].indices.shape[1]}
        return ServingModel.load(
            str(model_dir), imaps, widths, ladder=(1, 8), device="cpu"
        ), imaps, widths

    def test_swap_parity_mid_load(self, two_generations):
        """Requests before the flip score generation 1, after it
        generation 2, and the swapped bank is BITWISE a fresh load of
        generation 2 — through the in-place path (same shapes)."""
        ds, gens, tmp = two_generations
        sm, imaps, widths = self._serving_model(ds, tmp / "g1")
        ref1 = batch_reference_scores(gens["g1"], ds)
        ref2 = batch_reference_scores(gens["g2"], ds)
        reqs = requests_from_dataset(ds, sm.current())
        tensor_before = sm.current().arrays["global"]
        with MicroBatcher(sm.current, sm.programs) as mb:
            for i in range(5):
                assert mb.score(reqs[i]) == ref1[i]
            res = sm.stage_and_swap(str(tmp / "g2"))
            assert res.ok and res.generation == 2
            assert res.donated, "same-shape swap must take the in-place path"
            assert res.recompiled_programs == 0
            for i in range(5, 10):
                assert mb.score(reqs[i]) == ref2[i]
        fresh = build_model_bank(gens["g2"], imaps, widths, device="cpu")
        assert sm.current().arrays["global"] is tensor_before
        assert np.array_equal(
            overlap.device_get(sm.current().arrays["global"]),
            overlap.device_get(fresh.arrays["global"]),
        ), "the in-place refresh must be a bitwise move"
        assert sm.current().generation == 2

    def test_swap_under_concurrent_traffic(self, two_generations):
        ds, gens, tmp = two_generations
        sm, _, _ = self._serving_model(ds, tmp / "g1")
        ref1 = batch_reference_scores(gens["g1"], ds)
        ref2 = batch_reference_scores(gens["g2"], ds)
        reqs = requests_from_dataset(ds, sm.current())
        errors = []

        def worker(idx):
            try:
                for i in idx:
                    got = mb.score(reqs[i])
                    assert got in (ref1[i], ref2[i]), (i, got)
            except BaseException as e:
                errors.append(e)

        with MicroBatcher(sm.current, sm.programs) as mb:
            threads = [
                threading.Thread(target=worker, args=(range(t, len(reqs), 4),))
                for t in range(4)
            ]
            for t in threads:
                t.start()
            sm.stage_and_swap(str(tmp / "g2"))
            for t in threads:
                t.join(timeout=60)
            assert not errors, errors
            for i in range(4):
                assert mb.score(reqs[i]) == ref2[i]

    def test_batcher_autowires_the_dispatch_lock(self, two_generations):
        ds, gens, tmp = two_generations
        sm, _, _ = self._serving_model(ds, tmp / "g1")
        mb = MicroBatcher(sm.current, sm.programs)
        try:
            assert mb._swap_lock is sm.dispatch_lock
        finally:
            mb.close()
        plain = MicroBatcher(lambda: sm.current(), sm.programs)
        try:
            assert plain._swap_lock is None
        finally:
            plain.close()

    def test_repeated_swaps_under_fire_never_break_a_dispatch(self, two_generations):
        ds, gens, tmp = two_generations
        sm, _, _ = self._serving_model(ds, tmp / "g1")
        ref1 = batch_reference_scores(gens["g1"], ds)
        ref2 = batch_reference_scores(gens["g2"], ds)
        reqs = requests_from_dataset(ds, sm.current())
        errors = []
        stop = threading.Event()

        def submitter():
            try:
                i = 0
                while not stop.is_set():
                    j = i % len(reqs)
                    got = mb.score(reqs[j])
                    assert got in (ref1[j], ref2[j]), (j, got)
                    i += 1
            except BaseException as e:
                errors.append(e)

        with MicroBatcher(sm.current, sm.programs) as mb:
            threads = [threading.Thread(target=submitter) for _ in range(3)]
            for t in threads:
                t.start()
            try:
                for gen_dir in ("g2", "g1", "g2", "g1", "g2"):
                    res = sm.stage_and_swap(str(tmp / gen_dir))
                    assert res.ok and res.donated, res
            finally:
                stop.set()
                for t in threads:
                    t.join(timeout=60)
        assert not errors, errors
        assert sm.current().generation == 6
        assert sm.programs.stats()["compile_count"] == 2

    def test_corrupt_swap_quarantines_and_rolls_back(self, two_generations):
        from photon_ml_tpu_torch.reliability import install_plan
        from photon_ml_tpu_torch.reliability.retry import (
            reset_retry_stats,
            retry_stats,
        )

        ds, gens, tmp = two_generations
        sm, _, _ = self._serving_model(ds, tmp / "g1")
        ref1 = batch_reference_scores(gens["g1"], ds)
        reqs = requests_from_dataset(ds, sm.current())
        victim = str(tmp / "g2-copy")
        shutil.copytree(str(tmp / "g2"), victim)
        reset_retry_stats()
        install_plan("serving.model_load:1:CORRUPT")
        try:
            res = sm.stage_and_swap(victim)
        finally:
            install_plan(None)
        assert not res.ok and res.rolled_back
        assert res.quarantined and os.path.exists(res.quarantined)
        assert not os.path.exists(victim)
        assert retry_stats()["quarantined"].get("serving.model_load", 0) == 1
        assert sm.current().generation == 1
        with MicroBatcher(sm.current, sm.programs) as mb:
            for i in range(3):
                assert mb.score(reqs[i]) == ref1[i]

    def test_transient_load_fault_retries(self, two_generations):
        from photon_ml_tpu_torch.reliability import install_plan
        from photon_ml_tpu_torch.reliability.retry import (
            reset_retry_stats,
            retry_stats,
        )

        ds, gens, tmp = two_generations
        sm, _, _ = self._serving_model(ds, tmp / "g1")
        reset_retry_stats()
        install_plan("serving.model_load:1:EIO")
        try:
            res = sm.stage_and_swap(str(tmp / "g2"))
        finally:
            install_plan(None)
        assert res.ok and res.generation == 2
        assert retry_stats()["retries"].get("serving.model_load", 0) >= 1

    def test_exhausted_load_budget_rolls_back(self, two_generations):
        from photon_ml_tpu_torch.reliability import install_plan

        ds, gens, tmp = two_generations
        sm, _, _ = self._serving_model(ds, tmp / "g1")
        install_plan("serving.model_load:1:EIO:*")
        try:
            res = sm.stage_and_swap(str(tmp / "g2"))
        finally:
            install_plan(None)
        assert not res.ok and res.rolled_back
        assert sm.current().generation == 1
        assert os.path.isdir(str(tmp / "g2"))

    def test_entity_set_change_resolves_rows_at_dispatch(self, rng):
        """Generation 2 adds an entity inside the same padded bucket that
        sorts BEFORE existing ones, so every bank row shifts. The swap is
        in place (same spec), yet requests built BEFORE it score
        generation 2 bitwise: entity ids resolve to rows at dispatch."""
        recs = synth_records(rng)
        ds = _dataset(recs)
        lm1 = synth_model(rng)
        lm2 = synth_model(rng, scale=-1.5)
        lm2.random_effects["per-user"][2]["user00"] = {
            "u0\t": 3.0, "u1\t": -2.0, "u2\t": 1.0
        }
        bank1 = make_bank(lm1, ds)
        sm = ServingModel(bank1, ServingPrograms((1, 8, 64)))
        ref1 = batch_reference_scores(lm1, ds)
        ref2 = batch_reference_scores(lm2, ds)
        reqs = requests_from_dataset(ds, bank1)
        stdin_reqs = [request_from_record(recs[i], bank1, SHARDS) for i in (1, 9)]
        imaps, widths = index_maps_and_widths(ds)
        staged = build_model_bank(lm2, imaps, widths, device=False)
        with MicroBatcher(sm.current, sm.programs) as mb:
            for i in range(3):
                assert mb.score(reqs[i]) == ref1[i]
            res = sm.swap_to_bank(staged)
            assert res.ok and res.generation == 2
            assert res.donated and res.recompiled_programs == 0
            got = np.asarray([mb.score(r) for r in reqs], np.float32)
            assert np.array_equal(got, ref2)
            for req, i in zip(stdin_reqs, (1, 9)):
                assert mb.score(req) == ref2[i]

    def test_second_donated_swap_builds_nothing(self, rng):
        recs = synth_records(rng)
        ds = _dataset(recs)
        imaps, widths = index_maps_and_widths(ds)
        sm = ServingModel(make_bank(synth_model(rng), ds), ServingPrograms((1, 8)))
        sm.swap_to_bank(
            build_model_bank(synth_model(rng, scale=2.0), imaps, widths, device=False)
        )
        before = sm.programs.stats()["compile_count"]
        res = sm.swap_to_bank(
            build_model_bank(synth_model(rng, scale=-3.0), imaps, widths, device=False)
        )
        assert res.ok and res.donated and res.recompiled_programs == 0
        assert sm.programs.stats()["compile_count"] == before == 2

    def test_changed_spec_builds_its_ladder_before_the_flip(self, rng):
        recs = synth_records(rng)
        ds = _dataset(recs)
        imaps, widths = index_maps_and_widths(ds)
        sm = ServingModel(make_bank(synth_model(rng), ds), ServingPrograms((1, 8)))
        lm = synth_model(rng, n_users=300, drop_user=False)  # > one pad bucket
        res = sm.swap_to_bank(build_model_bank(lm, imaps, widths, device=False))
        assert res.ok and not res.donated and res.recompiled_programs == 2
        assert sm.ready()
        ref = batch_reference_scores(lm, ds)
        with MicroBatcher(sm.current, sm.programs) as mb:
            got = np.asarray(
                [mb.score(r) for r in requests_from_dataset(ds, sm.current())],
                np.float32,
            )
        assert np.array_equal(got, ref)

    def test_two_step_prepare_commit_abort(self, two_generations):
        ds, gens, tmp = two_generations
        sm, _, _ = self._serving_model(ds, tmp / "g1")
        ref2 = batch_reference_scores(gens["g2"], ds)
        assert not sm.commit_prepared().ok
        staged = sm.prepare_swap(str(tmp / "g2"))
        assert staged.ok and staged.donated and sm.generation == 1
        assert sm.abort_prepared() and not sm.abort_prepared()
        assert sm.prepare_swap(str(tmp / "g2")).ok
        res = sm.commit_prepared()
        assert res.ok and res.generation == 2
        with MicroBatcher(sm.current, sm.programs) as mb:
            assert mb.score(requests_from_dataset(ds, sm.current())[0]) == ref2[0]


class TestAdmissionControl:
    def _blocked_batcher(self, served, **kw):
        """A batcher whose dispatcher is parked on a held lock — the
        deterministic way to build queue depth."""
        _, ds, lm, bank, programs = served
        gate = threading.Lock()
        gate.acquire()
        metrics = ServingMetrics()
        mb = MicroBatcher(lambda: bank, programs, metrics, swap_lock=gate, **kw)
        return mb, metrics, requests_from_dataset(ds, bank), gate

    def test_predicted_wait_sheds_immediately(self, served):
        admission = AdmissionController()
        admission.note_dispatch(rows=1, busy_s=10.0)  # 10 s a row
        mb, metrics, reqs, gate = self._blocked_batcher(served, admission=admission)
        try:
            f1 = mb.submit(reqs[0])
            assert wait_until(lambda: not mb._queue and mb._inflight)
            f2 = mb.submit(reqs[1])
            r3 = reqs[2]
            r3.deadline_ms = 50.0
            t0 = time.perf_counter()
            with pytest.raises(RequestShed, match="predicted queue wait"):
                mb.submit(r3)
            assert time.perf_counter() - t0 < 1.0
        finally:
            gate.release()
        assert isinstance(f1.result(timeout=30), float)
        assert isinstance(f2.result(timeout=30), float)
        mb.close()
        assert metrics.snapshot()["sheds"] == {"predicted_wait": 1, "total": 1}

    def test_full_queue_submit_sheds_after_bounded_wait(self, served):
        mb, metrics, reqs, gate = self._blocked_batcher(served, max_queue=1)
        try:
            f1 = mb.submit(reqs[0])
            assert wait_until(lambda: not mb._queue and mb._inflight)
            f2 = mb.submit(reqs[1])
            r3 = reqs[2]
            r3.deadline_ms = 100.0
            t0 = time.perf_counter()
            with pytest.raises(RequestShed, match="queue full"):
                mb.submit(r3)
            assert 0.05 < time.perf_counter() - t0 < 5.0
        finally:
            gate.release()
        assert isinstance(f1.result(timeout=30), float)
        assert isinstance(f2.result(timeout=30), float)
        mb.close()
        assert metrics.snapshot()["sheds"]["queue_full"] == 1

    def test_expired_request_dropped_before_dispatch(self, served):
        mb, metrics, reqs, gate = self._blocked_batcher(served)
        try:
            f1 = mb.submit(reqs[0])
            assert wait_until(lambda: not mb._queue and mb._inflight)
            r2 = reqs[1]
            r2.deadline_ms = 20.0
            f2 = mb.submit(r2)
            time.sleep(0.1)
        finally:
            gate.release()
        assert isinstance(f1.result(timeout=30), float)
        with pytest.raises(DeadlineExceeded, match="deadline"):
            f2.result(timeout=30)
        mb.close()
        snap = metrics.snapshot()
        assert snap["deadline_expired"] == 1
        assert snap["dispatches"] == 1

    def test_default_deadline_applies_to_undeadlined_requests(self, served):
        _, ds, lm, bank, programs = served
        reqs = requests_from_dataset(ds, bank)
        with MicroBatcher(lambda: bank, programs, default_deadline_ms=1234.0) as mb:
            assert reqs[0].deadline_ms is None
            mb.score(reqs[0])
            assert reqs[0].deadline_ms == 1234.0

    def test_outcome_is_an_annotated_float(self, served):
        _, ds, lm, bank, programs = served
        ref = batch_reference_scores(lm, ds)
        reqs = requests_from_dataset(ds, bank)
        with MicroBatcher(lambda: bank, programs) as mb:
            out = mb.score(reqs[0])
        assert isinstance(out, ScoreOutcome)
        assert out == ref[0]
        assert out.degraded is False
        assert out.generation == bank.generation

    def test_record_deadline_propagates(self, served):
        recs, ds, lm, bank, _ = served
        rec = dict(recs[0])
        rec["deadline_ms"] = 75.5
        assert request_from_record(rec, bank, SHARDS).deadline_ms == 75.5
        assert request_from_record(recs[0], bank, SHARDS).deadline_ms is None


class TestGracefulDegradation:
    def _fe_only_reference(self, lm, ds):
        fe = LoadedGameModel()
        fe.fixed_effects = dict(lm.fixed_effects)
        return batch_reference_scores(fe, ds)

    def test_quarantined_re_scores_fe_only_bitwise(self, served):
        _, ds, lm, bank, programs = served
        ref_fe = self._fe_only_reference(lm, ds)
        assert not np.array_equal(ref_fe, batch_reference_scores(lm, ds))
        bank.quarantine_re("userId")
        metrics = ServingMetrics()
        reqs = requests_from_dataset(ds, bank)
        with MicroBatcher(lambda: bank, programs, metrics) as mb:
            outs = [mb.score(r) for r in reqs]
        assert np.array_equal(np.asarray(outs, np.float32), ref_fe)
        assert all(o.degraded for o in outs)
        assert metrics.snapshot()["degraded_responses"] == len(reqs)

    def test_unknown_re_type_quarantine_rejected(self, served):
        _, ds, lm, bank, _ = served
        with pytest.raises(ValueError, match="unknown random-effect"):
            bank.quarantine_re("no-such-type")

    def test_row_resolution_failure_degrades_then_quarantines(self, served):
        from photon_ml_tpu_torch.serving.batcher import RE_QUARANTINE_AFTER

        _, ds, lm, bank, programs = served
        ref_fe = self._fe_only_reference(lm, ds)

        class DyingIndex:
            calls = 0

            def rows_of(self, ids):
                DyingIndex.calls += 1
                raise RuntimeError("entity store died")

        bank.entity_rows["userId"] = DyingIndex()
        metrics = ServingMetrics()
        reqs = requests_from_dataset(ds, bank)
        n = RE_QUARANTINE_AFTER + 2
        with MicroBatcher(lambda: bank, programs, metrics) as mb:
            outs = [mb.score(reqs[i]) for i in range(n)]
        assert np.array_equal(np.asarray(outs, np.float32), ref_fe[:n])
        assert all(o.degraded for o in outs)
        assert "userId" in bank.quarantined_re_types
        assert DyingIndex.calls == RE_QUARANTINE_AFTER
        snap = metrics.snapshot()
        assert snap["re_resolution_failures"] == {"userId": RE_QUARANTINE_AFTER}
        assert snap["re_quarantines"] == {"userId": 1}
        assert snap["degraded_responses"] == n

    def test_swap_installs_a_clean_bank(self, served, rng):
        _, ds, lm, bank, programs = served
        bank.quarantine_re("userId")
        sm = ServingModel(bank, programs)
        imaps, widths = index_maps_and_widths(ds)
        res = sm.swap_to_bank(
            build_model_bank(synth_model(rng, scale=2.0), imaps, widths, device=False)
        )
        assert res.ok
        assert sm.current().quarantined_re_types == set()


class TestShutdownAndDrain:
    def test_close_under_saturated_queue_wakes_blocked_submitters(self, served):
        _, ds, lm, bank, programs = served
        gate = threading.Lock()
        gate.acquire()
        mb = MicroBatcher(lambda: bank, programs, swap_lock=gate, max_queue=1)
        reqs = requests_from_dataset(ds, bank)
        f1 = mb.submit(reqs[0])
        assert wait_until(lambda: not mb._queue and mb._inflight)
        f2 = mb.submit(reqs[1])
        blocked_outcome = []

        def blocked_submitter():
            try:
                mb.submit(reqs[2])
                blocked_outcome.append("admitted")
            except BatcherClosed:
                blocked_outcome.append("closed")

        t = threading.Thread(target=blocked_submitter)
        t.start()
        time.sleep(0.1)
        closer = threading.Thread(target=mb.close)
        closer.start()
        t.join(timeout=10)
        assert not t.is_alive()
        assert blocked_outcome == ["closed"]
        gate.release()
        closer.join(timeout=10)
        assert not closer.is_alive()
        assert isinstance(f1.result(timeout=10), float)
        assert isinstance(f2.result(timeout=10), float)

    def test_clean_close_resolves_every_future(self, served):
        _, ds, lm, bank, programs = served
        mb = MicroBatcher(lambda: bank, programs)
        futs = [mb.submit(r) for r in requests_from_dataset(ds, bank)]
        mb.close()
        assert all(f.done() for f in futs)
        assert [f.result(timeout=0) for f in futs]

    def test_drain_serves_queue_inside_budget(self, served):
        _, ds, lm, bank, programs = served
        metrics = ServingMetrics()
        reqs = requests_from_dataset(ds, bank)
        mb = MicroBatcher(lambda: bank, programs, metrics)
        futs = [mb.submit(r) for r in reqs]
        report = mb.drain(30.0)
        assert report.failed == 0 and not report.timed_out
        assert all(f.done() for f in futs)
        assert metrics.snapshot()["drain"]["failed"] == 0
        with pytest.raises(BatcherClosed):
            mb.submit(reqs[0])

    def test_drain_timeout_fails_leftovers_with_named_error(self, served):
        _, ds, lm, bank, programs = served
        gate = threading.Lock()
        gate.acquire()
        metrics = ServingMetrics()
        mb = MicroBatcher(lambda: bank, programs, metrics, swap_lock=gate)
        futs = [mb.submit(r) for r in requests_from_dataset(ds, bank)[:5]]
        assert wait_until(lambda: mb._inflight)
        report = mb.drain(0.3)
        assert report.timed_out and report.failed == len(futs)
        for f in futs:
            assert f.done()
            with pytest.raises(DrainTimeout):
                f.result(timeout=0)
        assert metrics.snapshot()["drain"]["timed_out"] is True
        gate.release()
        assert wait_until(lambda: not mb.alive(), timeout=10)

    def test_drain_is_idempotent_after_close(self, served):
        _, ds, lm, bank, programs = served
        mb = MicroBatcher(lambda: bank, programs)
        mb.close()
        report = mb.drain(1.0)
        assert report.pending_at_start == 0 and report.failed == 0

    def test_heartbeat_beats_while_idle(self, served):
        _, ds, lm, bank, programs = served
        with MicroBatcher(lambda: bank, programs) as mb:
            assert mb.alive()
            time.sleep(0.6)
            assert mb.heartbeat_age_s() < 0.5

    def test_kill_fault_plan_dies_instead_of_hanging(self):
        """A SIGKILL planned at the serving.dispatch crossing kills the
        process AT that crossing — promptly, no drain, no hang."""
        script = r"""
import numpy as np
from photon_ml_tpu_torch.reliability import install_plan
from photon_ml_tpu_torch.serving import (
    MicroBatcher, ScoreRequest, ServingPrograms, bank_from_arrays,
)

bank = bank_from_arrays(
    fixed=[("global", "g", np.ones(8, np.float32))],
    shard_widths={"g": 2}, device="cpu",
)
programs = ServingPrograms((1, 4))
programs.ensure_compiled(bank)
install_plan("serving.dispatch:1:KILL")
mb = MicroBatcher(lambda: bank, programs)
fut = mb.submit(ScoreRequest(
    uid="x",
    indices={"g": np.zeros(2, np.int32)},
    values={"g": np.zeros(2, np.float32)},
    entity_ids={},
))
import time
time.sleep(60)
print("SURVIVED")
"""
        r = subprocess.run(
            [sys.executable, "-c", script], capture_output=True, text=True,
            timeout=120, cwd=REPO,
        )
        assert r.returncode == -9, (r.returncode, r.stdout, r.stderr)
        assert "SURVIVED" not in r.stdout


# -- the driver --------------------------------------------------------------

SHARD_MAP = "globalShard:features|userShard:userFeatures"


def _avro(path, seed, n):
    recs = make_records(seed, n=n, n_users=8, n_items=3)
    for r in recs:
        r["metadataMap"] = {"userId": r.pop("userId"), "itemId": r.pop("itemId")}
        r["uid"] = f"p{seed}-{r['uid']}"
    write_container(path, game_example_schema(), recs)


@pytest.fixture(scope="module")
def driver_data(tmp_path_factory):
    """Avro rows and a GAME model written by the port's training driver."""
    from photon_ml_tpu_torch.cli import game_training_driver

    root = tmp_path_factory.mktemp("serving_avro")
    (root / "train").mkdir()
    _avro(str(root / "train" / "p0.avro"), 31, 120)
    _avro(str(root / "train" / "p1.avro"), 32, 70)
    game_training_driver.main([
        "--train-input-dirs", str(root / "train"),
        "--output-dir", str(root / "trained"),
        "--feature-shard-id-to-feature-section-keys-map", SHARD_MAP,
        "--fixed-effect-data-configurations", "global:globalShard,1",
        "--fixed-effect-optimization-configurations", "global:20,1e-6,1,1,LBFGS,L2",
        "--random-effect-data-configurations",
        "per-user:userId,userShard,1,none,none,none,INDEX_MAP",
        "--random-effect-optimization-configurations", "per-user:20,1e-6,1,1,LBFGS,L2",
        "--num-iterations", "1",
        "--device", "cpu",
    ])
    return root, root / "trained" / "best-model"


@pytest.fixture(scope="module")
def batch_scores(driver_data, tmp_path_factory):
    from photon_ml_tpu_torch.cli import game_scoring_driver

    root, model = driver_data
    out = tmp_path_factory.mktemp("batch") / "out"
    driver = game_scoring_driver.main([
        "--input-data-dirs", str(root / "train"),
        "--game-model-input-dir", str(model),
        "--output-dir", str(out),
        "--feature-shard-id-to-feature-section-keys-map", SHARD_MAP,
        "--evaluator-types", "AUC",
        "--device", "cpu",
    ])
    return {r["uid"]: r for r in read_avro_records(str(out / "scores"))}, driver


def _serve_argv(root, model, out, *extra):
    return [
        "--game-model-input-dir", str(model),
        "--output-dir", str(out),
        "--request-paths", str(root / "train"),
        "--feature-shard-id-to-feature-section-keys-map", SHARD_MAP,
        *extra,
    ]


class TestServingDriver:
    def test_replayed_trace_matches_batch_driver_bitwise(
        self, driver_data, batch_scores, tmp_path
    ):
        """The port's serving driver over the port's trained model: score
        records equal to the port's GAME scoring driver's, record for
        record; metrics.json carries the latency/occupancy/build
        accounting, one readback a dispatch, and the same AUC."""
        from photon_ml_tpu_torch.cli import serving_driver

        root, model = driver_data
        batch, scoring = batch_scores
        for mode in ("closed", "open"):
            out = tmp_path / mode
            serving_driver.main(_serve_argv(
                root, model, out, "--mode", mode, "--concurrency", "4",
                "--evaluator-types", "AUC", "--device", "cpu",
            ))
            serve = {
                r["uid"]: r for r in read_avro_records(str(out / "scores"))
            }
            assert serve == batch
            m = json.load(open(out / "metrics.json"))
            assert m["programs"]["cold_dispatch_compiles"] == 0
            assert m["programs"]["compile_count"] == 4
            assert m["readbacks"] == m["serving"]["dispatches"]
            assert m["serving"]["latency_p99_ms"] > 0
            assert m["AUC"] == scoring.metrics["AUC"]
            assert m["device"] == "cpu"

    def test_reference_serving_driver_agrees(self, driver_data, batch_scores, tmp_path):
        """The JAX package's serving driver over the same model and trace:
        the same records, scores within 1e-6 of their scale."""
        from photon_ml_tpu.cli import serving_driver as ref_driver
        from photon_ml_tpu_torch.cli import serving_driver

        root, model = driver_data
        ref_driver.main(_serve_argv(root, model, tmp_path / "ref", "--ladder", "1,8"))
        serving_driver.main(_serve_argv(
            root, model, tmp_path / "port", "--ladder", "1,8", "--device", "cpu",
        ))
        ref = list(read_avro_records(str(tmp_path / "ref" / "scores")))
        port = list(read_avro_records(str(tmp_path / "port" / "scores")))
        for key in ("uid", "label", "modelId", "weight", "metadataMap"):
            assert [r[key] for r in port] == [r[key] for r in ref], key
        assert_close_to_scale(
            [r["predictionScore"] for r in port],
            [r["predictionScore"] for r in ref], rtol=1e-6,
        )

    def test_driver_hot_swap_mid_replay(self, driver_data, batch_scores, tmp_path):
        from photon_ml_tpu_torch.cli import serving_driver

        root, model = driver_data
        batch, _ = batch_scores
        out = tmp_path / "swap"
        serving_driver.main(_serve_argv(
            root, model, out, "--mode", "open", "--concurrency", "4",
            "--swap-model-dir", str(model), "--swap-after-requests", "40",
            "--device", "cpu",
        ))
        m = json.load(open(out / "metrics.json"))
        assert m["generation"] == 2
        swaps = m["swap_history"]
        assert len(swaps) == 1 and swaps[0]["ok"] and swaps[0]["donated"]
        assert swaps[0]["recompiled_programs"] == 0
        assert set(m["serving"]["generation_dispatches"]) == {"1", "2"}
        assert m["outcomes"] == {"ok": len(batch)}
        serve = {r["uid"]: r for r in read_avro_records(str(out / "scores"))}
        assert serve == batch  # the same model: no score moved

    def test_stdin_mode(self, driver_data, batch_scores, tmp_path):
        """``--request-paths -``: JSON lines on stdin through prebuilt maps
        (the feature-indexing driver's store), bitwise the batch scores."""
        from photon_ml_tpu_torch.cli import feature_indexing_driver

        root, model = driver_data
        batch, _ = batch_scores
        store = tmp_path / "store"
        for shard, bag in (("globalShard", "features"), ("userShard", "userFeatures")):
            feature_indexing_driver.main([
                "--input-paths", str(root / "train"), "--output-dir", str(store),
                "--feature-bags", bag, "--shard-name", shard,
            ])
        lines = "".join(
            json.dumps(r) + "\n"
            for r in read_avro_records(str(root / "train"))
        )
        out = tmp_path / "stdin"
        r = subprocess.run(
            [sys.executable, "-m", "photon_ml_tpu_torch.cli.serving_driver",
             *_serve_argv(root, model, out)[:4], "--request-paths", "-",
             "--feature-shard-id-to-feature-section-keys-map", SHARD_MAP,
             "--offheap-indexmap-dir", str(store),
             "--request-nnz-width", "8", "--device", "cpu"],
            input=lines, capture_output=True, text=True, cwd=REPO, timeout=300,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        serve = {x["uid"]: x for x in read_avro_records(str(out / "scores"))}
        assert serve.keys() == batch.keys()
        for uid, rec in serve.items():
            assert rec["predictionScore"] == batch[uid]["predictionScore"], uid

    @pytest.mark.parametrize("extra,item", [
        (["--registry-dir", "x"], "choose ONE model source"),
        (["--registry-poll-s", "0"], "registry-poll-s must be > 0"),
        (["--auto-rollback", "true", "--registry-dir", "x"], "choose ONE model source"),
        (["--rollback-window", "0"], "rollback window/min-requests must be >= 1"),
        (["--rollback-min-requests", "0"], "rollback window/min-requests must be >= 1"),
        (["--rollback-max-unhealthy", "1.5"], r"rollback-max-unhealthy must be in \(0, 1\]"),
    ])
    def test_unported_options_raise_naming_their_item(self, tmp_path, extra, item):
        """The registry watcher's options are ported: each is held to the
        reference's validation rules, refused before the output exists."""
        from photon_ml_tpu_torch.cli import serving_driver

        argv = _serve_argv(tmp_path, tmp_path / "m", tmp_path / "o", *extra)
        with pytest.raises(ValueError, match=item):
            serving_driver.main(argv + ["--device", "cpu"])
        assert not (tmp_path / "o").exists()

    def test_device_defaults_to_the_card(self, driver_data, tmp_path, monkeypatch):
        from photon_ml_tpu_torch.cli import serving_driver

        root, model = driver_data
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serving_driver.main(_serve_argv(root, model, tmp_path / "o"))


class TestServingDriverValidation:
    def _params(self, **kw):
        from photon_ml_tpu_torch.cli.serving_driver import ServingParams

        base = dict(
            game_model_input_dir="m", output_dir="o",
            request_paths=["trace"], feature_shards=[SHARDS[0]],
        )
        base.update(kw)
        return ServingParams(**base)

    def test_stdin_requires_prebuilt_maps_and_width(self):
        with pytest.raises(ValueError, match="prebuilt feature maps"):
            self._params(request_paths=["-"]).validate()
        with pytest.raises(ValueError, match="request-nnz-width"):
            self._params(request_paths=["-"], offheap_indexmap_dir="idx").validate()

    def test_swap_requires_threshold(self):
        with pytest.raises(ValueError, match="swap-after-requests"):
            self._params(swap_model_dir="m2").validate()

    def test_bad_ladder_and_mode(self):
        with pytest.raises(ValueError, match="ladder"):
            self._params(ladder=[8, 1]).validate()
        with pytest.raises(ValueError, match="mode"):
            self._params(mode="burst").validate()

    def test_one_request_source(self):
        with pytest.raises(ValueError, match="ONE request source"):
            self._params(frontend_port=0).validate()
