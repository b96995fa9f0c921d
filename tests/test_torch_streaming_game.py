"""The port's out-of-core GAME path (``game/streaming.py`` and the drivers'
``--streaming``) against the JAX package on the same seeded files.

The scan, the staged chunks and the spilled segments are held bit for bit
(against the JAX package and against the port's in-memory buckets). The
streamed fit is held against the JAX package's in float32, the only
precision the reference's streamed GAME runs in (its coordinates start
from ``jnp.zeros(float32)`` banks and float32 chunks): the objective
history to 1e-5 relative and the coefficients to 1e-3 of their scale; and
against the port's in-memory CD by the reference's own envelopes
(objective 1e-4, coefficients 2e-3). The kill -9 resumes are bitwise.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from photon_ml_tpu.game.config import (
    FeatureShardConfiguration as RefShard,
    FixedEffectDataConfiguration as RefFE,
    ProjectorType as RefProjector,
    RandomEffectDataConfiguration as RefRE,
)
from photon_ml_tpu.game import streaming as ref_gs
from photon_ml_tpu.optim.config import GLMOptimizationConfiguration as RefOptConfig
from photon_ml_tpu.task import TaskType as RefTask
from photon_ml_tpu_torch.evaluation.evaluator import Evaluator, EvaluatorType
from photon_ml_tpu_torch.game import streaming as gs
from photon_ml_tpu_torch.game.config import (
    FeatureShardConfiguration,
    FixedEffectDataConfiguration,
    ProjectorType,
    RandomEffectDataConfiguration,
)
from photon_ml_tpu_torch.io.avro_codec import write_container
from photon_ml_tpu_torch.optim.config import GLMOptimizationConfiguration
from photon_ml_tpu_torch.reliability import SeamFailure, install_plan, read_manifest
from photon_ml_tpu_torch.task import TaskType
from torch_parity import assert_close_to_scale, to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGISTIC = TaskType.LOGISTIC_REGRESSION
SHARDS = [
    FeatureShardConfiguration("globalShard", ["features"]),
    FeatureShardConfiguration("userShard", ["userFeatures"]),
]
REF_SHARDS = [
    RefShard("globalShard", ["features"]),
    RefShard("userShard", ["userFeatures"]),
]
FE_DATA = {"global": FixedEffectDataConfiguration("globalShard")}
RE_DATA = {
    "per-user": RandomEffectDataConfiguration(
        "userId", "userShard", projector_type=ProjectorType.IDENTITY
    )
}
REF_FE_DATA = {"global": RefFE("globalShard")}
REF_RE_DATA = {
    "per-user": RefRE("userId", "userShard", projector_type=RefProjector.IDENTITY)
}
FE_SPEC, RE_SPEC = "50,1e-6,0.5,1,TRON,L2", "50,1e-6,1.0,1,LBFGS,L2"


def _write_game_files(base, seed, *, n_files=3, rows_per_file=80, n_users=6, d_g=5, d_u=3):
    """Seeded GAME records (the reference's test fixture): a global and a
    per-user feature bag, the user id in metadataMap."""
    from conftest import game_example_schema

    rng = np.random.default_rng(seed)
    os.makedirs(base, exist_ok=True)
    w_g = np.linspace(-1, 1, d_g)
    w_u = np.random.default_rng(7).normal(size=(n_users, d_u))
    for fi in range(n_files):
        recs = []
        for i in range(rows_per_file):
            u = int(rng.integers(0, n_users))
            xg = rng.normal(size=d_g)
            xu = rng.normal(size=d_u)
            z = float(xg @ w_g + xu @ w_u[u])
            recs.append({
                "uid": f"f{fi}-{i}",
                "response": float(1 / (1 + np.exp(-z)) > rng.uniform()),
                "metadataMap": {"userId": f"user{u}"},
                "features": [{"name": f"g{j}", "term": "", "value": float(xg[j])}
                             for j in range(d_g)],
                "userFeatures": [{"name": f"u{j}", "term": "", "value": float(xu[j])}
                                 for j in range(d_u)],
            })
        write_container(os.path.join(base, f"part-{fi}.avro"), game_example_schema(), recs)
    return str(base)


@pytest.fixture
def train(tmp_path):
    return _write_game_files(tmp_path / "train", 0)


def _combo(fe=FE_SPEC, re=RE_SPEC):
    return ({"global": GLMOptimizationConfiguration.parse(fe),
             "per-user": GLMOptimizationConfiguration.parse(re)},
            {"global": RefOptConfig.parse(fe), "per-user": RefOptConfig.parse(re)})


def _scan_both(train):
    port = gs.scan_game_stream([train], SHARDS, ["userId"])
    ref = ref_gs.scan_game_stream([train], REF_SHARDS, ["userId"])
    return port, ref


# -- scan, stage and segments -------------------------------------------------


def test_scan_and_stage_are_the_references_bit_for_bit(train, tmp_path):
    """The same vocabularies, entity codes and counts, staging widths; the
    same staged chunk files byte for byte (and the diagnostics
    reservoir)."""
    (imaps, eidx, stats), (r_imaps, r_eidx, r_stats) = _scan_both(train)
    for sid in imaps:
        assert dict(imaps[sid].items()) == dict(r_imaps[sid].items())
    assert eidx["userId"].ids == r_eidx["userId"].ids
    assert stats.num_rows == r_stats.num_rows and stats.shard_nnz == r_stats.shard_nnz
    np.testing.assert_array_equal(stats.entity_counts["userId"], r_stats.entity_counts["userId"])
    assert gs.game_row_bytes(stats.shard_nnz, 1) == ref_gs.game_row_bytes(r_stats.shard_nnz, 1)
    store, sample = gs.stage_game_stream(
        [train], SHARDS, ["userId"], imaps, eidx, stats, rows_per_chunk=64,
        reservoir_rows=50, seed=3, persist_dir=str(tmp_path / "port"),
    )
    r_store, r_sample = ref_gs.stage_game_stream(
        [train], REF_SHARDS, ["userId"], r_imaps, r_eidx, r_stats, rows_per_chunk=64,
        reservoir_rows=50, seed=3, persist_dir=str(tmp_path / "ref"),
    )
    assert store.count == r_store.count == 4
    for fn in sorted(os.listdir(store.dir)):
        if fn.endswith(".bin"):
            assert open(os.path.join(store.dir, fn), "rb").read() == \
                open(os.path.join(r_store.dir, fn), "rb").read(), fn
    assert read_manifest(store.dir)["real_rows"] == read_manifest(r_store.dir)["real_rows"]
    for k in sample:
        np.testing.assert_array_equal(sample[k], r_sample[k])


def test_segments_equal_the_in_memory_buckets(train):
    """The spilled grouping's segments hold, entity by entity, the port's
    in-memory buckets' rows, features and labels bit for bit (and the
    reference's spilled segments), at a segment budget that splits a
    capacity class."""
    from photon_ml_tpu_torch.game.data import build_game_dataset_from_files
    from photon_ml_tpu_torch.game.random_effect_data import build_random_effect_dataset

    (imaps, eidx, stats), (r_imaps, r_eidx, r_stats) = _scan_both(train)
    store, _ = gs.stage_game_stream([train], SHARDS, ["userId"], imaps, eidx, stats,
                                    rows_per_chunk=64)
    spilled = gs.SpilledREBuckets(store, "userId", "userShard", stats.entity_counts["userId"],
                                  segment_budget_bytes=64 * (8 * 8 + 16))
    r_store, _ = ref_gs.stage_game_stream([train], REF_SHARDS, ["userId"], r_imaps, r_eidx,
                                          r_stats, rows_per_chunk=64)
    r_spilled = ref_gs.SpilledREBuckets(r_store, "userId", "userShard",
                                        r_stats.entity_counts["userId"],
                                        segment_budget_bytes=64 * (8 * 8 + 16))
    assert len(spilled.segments) == len(r_spilled.segments) > 1
    ds = build_game_dataset_from_files([train], SHARDS, ["userId"], device="cpu")
    red = build_random_effect_dataset(ds, RE_DATA["per-user"])
    mem = {}
    for b in red.buckets:
        for e_i, code in enumerate(b.entity_codes):
            keep = b.row_index[e_i] >= 0
            mem[int(code)] = (b.capacity, b.row_index[e_i][keep].tolist(),
                              b.values[e_i][keep].tolist(), b.labels[e_i][keep].tolist(),
                              b.weights[e_i][keep].tolist())
    st = {}
    for (codes, arrs), (r_codes, r_arrs) in zip(spilled.iter_segments(), r_spilled.iter_segments()):
        np.testing.assert_array_equal(codes, r_codes)
        for f in arrs:
            np.testing.assert_array_equal(arrs[f], r_arrs[f])
        for e_i, code in enumerate(codes):
            keep = arrs["rows"][e_i] >= 0
            st[int(code)] = (arrs["rows"].shape[1], arrs["rows"][e_i][keep].tolist(),
                             arrs["v"][e_i][keep].tolist(), arrs["lab"][e_i][keep].tolist(),
                             arrs["wgt"][e_i][keep].tolist())
    assert st == mem


# -- the streamed fit ---------------------------------------------------------------


def test_streamed_fit_matches_reference_and_in_memory(train, tmp_path):
    """train_streaming_game over 4 chunks against the JAX package's (float32:
    objective history 1e-5, coefficients and bank 1e-3 of their scale;
    float32 sums in another order through two CD sweeps of TRON and
    L-BFGS solves part them by ~1.2e-4),
    with streamed validation, and against the port's in-memory CD
    (objective 1e-4, coefficients 2e-3: the reference's envelopes)."""
    from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
    from photon_ml_tpu_torch.game.coordinate_descent import CoordinateDescent
    from photon_ml_tpu_torch.game.data import build_game_dataset_from_files
    from photon_ml_tpu_torch.game.random_effect import RandomEffectOptimizationProblem
    from photon_ml_tpu_torch.game.random_effect_data import build_random_effect_dataset
    from photon_ml_tpu_torch.ops.losses import loss_for_task
    from photon_ml_tpu_torch.optim.problem import create_glm_problem

    val = _write_game_files(tmp_path / "val", 1, n_files=2, rows_per_file=150)
    combo, ref_combo = _combo()
    res, extras = gs.train_streaming_game(
        [train], SHARDS, FE_DATA, RE_DATA, combo, LOGISTIC, num_iterations=2,
        memory_budget_bytes=100 * 80, validate_paths=[val], device="cpu",
    )
    ref, r_extras = ref_gs.train_streaming_game(
        [train], REF_SHARDS, REF_FE_DATA, REF_RE_DATA, ref_combo,
        RefTask.LOGISTIC_REGRESSION, num_iterations=2, memory_budget_bytes=100 * 80,
        validate_paths=[val],
    )
    assert extras["store"].count == r_extras["store"].count >= 3
    np.testing.assert_allclose(res.objective_history, ref.objective_history, rtol=1e-5)
    assert res.objective_history[1] <= res.objective_history[0]
    fe = res.game_model.get_model("global").model.means
    bank = res.game_model.get_model("per-user").bank
    assert_close_to_scale(fe, np.asarray(ref.game_model.get_model("global").model.means),
                          rtol=1e-3)
    assert_close_to_scale(bank, np.asarray(ref.game_model.get_model("per-user").bank), rtol=1e-3)
    assert res.validation_history[-1]["AUC"] == pytest.approx(
        ref.validation_history[-1]["AUC"], abs=1e-4)
    # the exact AUC of the exported model on the staged validation chunks
    vstore = extras["validate_store"]
    zs, labs, wgts = [], [], []
    coords = {"global": fe, "per-user": bank}
    for i in range(vstore.count):
        c = vstore.chunk(i)
        w = to_np(coords["global"])
        z = (c["v__globalShard"] * w[c["ix__globalShard"]]).sum(axis=1)
        codes = c["code__userId"]
        rows = to_np(bank)[np.maximum(codes, 0)]
        z_u = (c["v__userShard"] * np.take_along_axis(rows, c["ix__userShard"], axis=1)).sum(1)
        zs.append(z + np.where((codes >= 0) & (c["wgt"] > 0), z_u, 0.0) + c["off"])
        labs.append(c["lab"])
        wgts.append(c["wgt"])
    exact = float(Evaluator(EvaluatorType.parse("AUC")).evaluate(
        *(torch.as_tensor(np.concatenate(a)) for a in (zs, labs, wgts))))
    assert abs(res.validation_history[-1]["AUC"] - exact) < 1e-3
    # the port's in-memory CD on the same files
    ds = build_game_dataset_from_files([train], SHARDS, ["userId"], device="cpu")
    red = build_random_effect_dataset(ds, RE_DATA["per-user"])
    coordinates = {
        "global": FixedEffectCoordinate(
            name="global", dataset=ds,
            problem=create_glm_problem(
                LOGISTIC, ds.shards["globalShard"].dim, config=combo["global"].optimizer_config,
                regularization=combo["global"].regularization,
                intercept_index=ds.shards["globalShard"].intercept_index,
            ),
            feature_shard_id="globalShard", reg_weight=combo["global"].reg_weight,
        ),
        "per-user": RandomEffectCoordinate(
            name="per-user", dataset=ds, re_dataset=red,
            problem=RandomEffectOptimizationProblem(
                loss_for_task(LOGISTIC), combo["per-user"].optimizer_config,
                combo["per-user"].regularization, reg_weight=combo["per-user"].reg_weight,
            ),
        ),
    }
    mem = CoordinateDescent(coordinates, ds, LOGISTIC).run(2)
    np.testing.assert_allclose(res.objective_history, mem.objective_history, rtol=1e-4)
    np.testing.assert_allclose(to_np(fe), to_np(mem.model.get_model("global").model.means),
                               rtol=2e-3, atol=3e-4)
    np.testing.assert_allclose(to_np(bank), to_np(mem.model.get_model("per-user").bank),
                               rtol=2e-3, atol=3e-4)


def test_streamed_cd_checkpoints_every_iteration(train, tmp_path):
    """One StreamingCDCheckpointer step a CD iteration; a rerun resumes
    from the last and gives bitwise the same states."""
    combo, _ = _combo("20,1e-6,0.5,1,LBFGS,L2", "20,1e-6,1.0,1,LBFGS,L2")
    kw = dict(num_iterations=3, memory_budget_bytes=100 * 80, device="cpu",
              checkpoint_dir=str(tmp_path / "ck"))
    res, _ = gs.train_streaming_game([train], SHARDS, FE_DATA, RE_DATA, combo, LOGISTIC, **kw)
    from photon_ml_tpu_torch.reliability import StreamingCDCheckpointer

    ck = StreamingCDCheckpointer(str(tmp_path / "ck" / "cd"))
    assert ck.steps() == [1, 2, 3]
    states, _, hist = ck.load(3)
    for name in ("global", "per-user"):
        np.testing.assert_array_equal(states[name], to_np(res.models[name]))
    assert hist["objective"] == res.objective_history
    again, _ = gs.train_streaming_game([train], SHARDS, FE_DATA, RE_DATA, combo, LOGISTIC, **kw)
    assert again.objective_history == res.objective_history
    for name in ("global", "per-user"):
        torch.testing.assert_close(again.models[name], res.models[name], rtol=0, atol=0)


def test_interrupted_stage_resumes_bitwise(train, tmp_path):
    """A stage pass whose spill writes start failing mid-pass, then the
    same pass with no plan: the resumed store's files are bitwise an
    uninterrupted store's, without staging the committed records again
    (the reference's TestStageResume)."""
    imaps, eidx, stats = gs.scan_game_stream([train], SHARDS, ["userId"])

    def stage(persist, plan):
        install_plan(plan)
        try:
            return gs.stage_game_stream([train], SHARDS, ["userId"], imaps, eidx, stats,
                                        rows_per_chunk=32, persist_dir=persist)
        finally:
            install_plan(None)

    clean = str(tmp_path / "clean")
    stage(clean, None)
    broken = str(tmp_path / "broken")
    with pytest.raises(SeamFailure):
        stage(broken, "spill_write:30:EIO:*")
    m = read_manifest(broken)
    assert 0 < m["chunks"] < read_manifest(clean)["chunks"]
    resumed, _ = stage(broken, None)
    assert resumed.staged
    for key in ("chunks", "real_rows"):
        assert read_manifest(broken)[key] == read_manifest(clean)[key]
    for fn in sorted(os.listdir(clean)):
        if fn.endswith(".bin"):
            assert open(os.path.join(clean, fn), "rb").read() == \
                open(os.path.join(broken, fn), "rb").read(), fn


# -- the drivers --------------------------------------------------------------------


def _train_args(train, out, *extra):
    return [
        "--train-input-dirs", train, "--output-dir", out, "--task-type", "LOGISTIC_REGRESSION",
        "--feature-shard-id-to-feature-section-keys-map",
        "globalShard:features|userShard:userFeatures",
        "--fixed-effect-data-configurations", "global:globalShard,1",
        "--fixed-effect-optimization-configurations", f"global:{FE_SPEC}",
        "--random-effect-data-configurations",
        "per-user:userId,userShard,1,none,none,none,identity",
        "--random-effect-optimization-configurations", f"per-user:{RE_SPEC}",
        "--num-iterations", "2", "--delete-output-dir-if-exists", "true", "--device", "cpu",
        *extra,
    ]


def test_streaming_drivers_end_to_end(train, tmp_path):
    """The GAME training driver streamed and in memory over the same files
    (objective 1e-4), the streamed best model read back by the scoring
    driver, in memory and with --streaming true over the validation files
    (the same AUC, 1e-6), and the streaming block of metrics.json."""
    from photon_ml_tpu_torch.cli import game_scoring_driver, game_training_driver
    from photon_ml_tpu_torch.io.name_term_list import save_name_and_term_feature_sets
    from photon_ml_tpu_torch.utils.index_map import intercept_key

    val = _write_game_files(tmp_path / "val", 1, n_files=2, rows_per_file=150)
    common = ["--validate-input-dirs", val, "--evaluator-types", "AUC"]
    mem = game_training_driver.main(_train_args(train, str(tmp_path / "mem"), *common))
    stream = game_training_driver.main(_train_args(
        train, str(tmp_path / "stream"), *common, "--streaming", "true",
        "--stream-memory-budget", str(100 * 80)))
    m = json.load(open(tmp_path / "stream" / "metrics.json"))
    m_mem = json.load(open(tmp_path / "mem" / "metrics.json"))
    assert m["streaming"]["num_chunks"] >= 3 and m["streaming"]["peak_rss_bytes"] > 0
    assert m["streaming"]["diagnostics"]["reservoir_rows"] == 240
    np.testing.assert_allclose(m["objective_history"], m_mem["objective_history"], rtol=1e-4)
    assert m["validation_history"][-1]["AUC"] == pytest.approx(
        m_mem["validation_history"][-1]["AUC"], abs=1e-3)
    del mem, stream
    # the scoring driver over the streamed model, in memory and streamed
    maps = str(tmp_path / "maps")
    imaps, _, _ = gs.scan_game_stream([train], SHARDS, ["userId"])
    save_name_and_term_feature_sets({
        bag: [k for k, _ in imaps[cfg.shard_id].items() if k != intercept_key()]
        for cfg in SHARDS for bag in cfg.feature_bags
    }, maps)
    score = ["--input-data-dirs", val, "--game-model-input-dir",
             str(tmp_path / "stream" / "best-model"),
             "--feature-shard-id-to-feature-section-keys-map",
             "globalShard:features|userShard:userFeatures", "--evaluator-types", "AUC",
             "--feature-name-and-term-set-path", maps, "--device", "cpu"]
    game_scoring_driver.main(score + ["--output-dir", str(tmp_path / "score-mem")])
    game_scoring_driver.main(score + ["--output-dir", str(tmp_path / "score-stream"),
                                      "--streaming", "true", "--rows-per-chunk", "64"])
    auc_mem = json.load(open(tmp_path / "score-mem" / "metrics.json"))["AUC"]
    auc_stream = json.load(open(tmp_path / "score-stream" / "metrics.json"))["AUC"]
    assert auc_stream == pytest.approx(auc_mem, abs=1e-6)
    assert len(os.listdir(tmp_path / "score-stream" / "scores")) == 6  # 3 chunks a file


def _params(tmp_path, **kw):
    from photon_ml_tpu_torch.cli.game_training_driver import GameTrainingParams

    base = dict(
        train_input_dirs=[str(tmp_path / "train")], output_dir=str(tmp_path / "out"),
        task_type=LOGISTIC, feature_shards=SHARDS,
        fixed_effect_data_configs=dict(FE_DATA),
        fixed_effect_opt_configs={"global": "20,1e-6,0.1,1,LBFGS,L2"},
        random_effect_data_configs=dict(RE_DATA),
        random_effect_opt_configs={"per-user": "20,1e-6,1.0,1,LBFGS,L2"},
        streaming=True,
    )
    base.update(kw)
    return GameTrainingParams(**base)


GATES = [
    ({"random_effect_data_configs": {"per-user": RandomEffectDataConfiguration(
        "userId", "userShard", projector_type=ProjectorType.INDEX_MAP)}}, "IDENTITY projector"),
    ({"random_effect_data_configs": {"per-user": RandomEffectDataConfiguration(
        "userId", "userShard", active_data_upper_bound=4,
        projector_type=ProjectorType.IDENTITY)}}, "active-data-upper-bound"),
    ({"evaluator_types": [EvaluatorType.parse("AUC:userId")]}, "sharded evaluator"),
    ({"streaming": False, "stream_memory_budget": 1 << 20}, "requires --streaming true"),
    ({"checkpoint_dir": "ck"}, None),
]


@pytest.mark.parametrize("kw,error", GATES, ids=[str(i) for i in range(len(GATES))])
def test_streaming_gates(tmp_path, kw, error):
    p = _params(tmp_path, **kw)
    if error is None:
        p.validate()  # streaming with checkpoints is supported
    else:
        with pytest.raises(ValueError, match=error):
            p.validate()


# -- kill -9 -----------------------------------------------------------------------


def _run(args, *, expect_kill=False, timeout=300):
    env = {**os.environ, "PHOTON_RETRY_BASE_S": "0.001"}
    r = subprocess.run([sys.executable, "-m", "photon_ml_tpu_torch.cli.game_training_driver",
                        *args], cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=timeout)
    if expect_kill:
        assert r.returncode == -9, f"expected SIGKILL, got rc={r.returncode}\n{r.stderr[-2000:]}"
    else:
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]


def _tree(root):
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fn in sorted(filenames):
            p = os.path.join(dirpath, fn)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("plan,where", [
    ("spill_write:12:KILL", "stage"),  # inside the stage pass
    ("spill_read:300:KILL", "cd"),  # inside CD iteration 2, after 1's snapshot
])
def test_streamed_game_killed_resumes_bitwise(tmp_path, plan, where):
    """kill -9 mid-stage or mid-CD, then the same run again: the best
    model is bitwise an uninterrupted run's (the reference's
    test_reliability.py:592 and :625)."""
    sys.path.insert(0, os.path.join(REPO, "dev-scripts"))
    import chaos_matrix

    train = str(tmp_path / "train")
    chaos_matrix.gen_game_data(train, seed=0)

    def args(out, ckpt, *extra):
        a = _train_args(train, out, "--streaming", "true", "--stream-memory-budget",
                        str(8 << 10), "--checkpoint-dir", ckpt, *extra)
        a[a.index(f"global:{FE_SPEC}")] = "global:20,1e-6,0.5,1,TRON,L2"
        a[a.index(f"per-user:{RE_SPEC}")] = "per-user:20,1e-6,1.0,1,LBFGS,L2"
        return a

    clean, kill, ckpt = (str(tmp_path / n) for n in ("clean", "kill", "ck"))
    _run(args(clean, str(tmp_path / "ck-clean")))
    _run(args(kill, ckpt, "--fault-plan", plan), expect_kill=True)
    combo_dir = os.path.join(ckpt, sorted(os.listdir(ckpt))[0])
    stage = read_manifest(os.path.join(combo_dir, "stage-train"))
    if where == "stage":
        assert stage is not None and not stage.get("staged"), stage
    else:
        assert stage.get("staged")
        assert any(f.endswith(".json") for f in os.listdir(os.path.join(combo_dir, "cd")))
    _run(args(kill, ckpt))
    a, b = _tree(os.path.join(clean, "best-model")), _tree(os.path.join(kill, "best-model"))
    assert a.keys() == b.keys()
    assert [k for k in a if a[k] != b[k]] == []
