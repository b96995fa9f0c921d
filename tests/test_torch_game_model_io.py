"""GAME model files (``game/model_io.py``): a JAX ``GameModel`` carried
across by ``convert.game_model_from_reference`` and saved by both packages
gives byte-identical files, and each package loads the other's directory
and scores the same rows within 1e-6 of the scores' max-abs."""

import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.game import CoordinateDescent as RefCD
from photon_ml_tpu.game import FixedEffectCoordinate as RefFE
from photon_ml_tpu.game import RandomEffectCoordinate as RefRE
from photon_ml_tpu.game import RandomEffectDataConfiguration as RefREConfig
from photon_ml_tpu.game import RandomEffectOptimizationProblem as RefREProblem
from photon_ml_tpu.game import build_random_effect_dataset as ref_build_re
from photon_ml_tpu.game.model_io import load_game_model as ref_load
from photon_ml_tpu.game.model_io import save_game_model as ref_save
from photon_ml_tpu.game.model_io import save_loaded_game_model as ref_save_loaded
from photon_ml_tpu.ops.losses import LOGISTIC as REF_LOGISTIC
from photon_ml_tpu.optim.config import OptimizerConfig as RefOptConfig
from photon_ml_tpu.optim.config import RegularizationContext as RefReg
from photon_ml_tpu.optim.config import RegularizationType as RefRegType
from photon_ml_tpu.optim.problem import create_glm_problem as ref_create_problem
from photon_ml_tpu.task import TaskType as RefTask
from photon_ml_tpu_torch.convert import game_model_from_reference
from photon_ml_tpu_torch.game import (
    RandomEffectDataConfiguration,
    build_random_effect_dataset,
    load_game_model,
    save_game_model,
    save_loaded_game_model,
)
from photon_ml_tpu_torch.task import TaskType
from torch_game_cases import both_datasets, make_records
from torch_parity import assert_close_to_scale


def _reference_model(variances):
    recs = make_records(12, n=200, n_users=7)
    ref_ds, port_ds = both_datasets(recs)
    red = ref_build_re(ref_ds, RefREConfig("userId", "userShard"))
    coords = {
        "global": RefFE(
            name="global", dataset=ref_ds,
            problem=ref_create_problem(
                RefTask.LOGISTIC_REGRESSION, ref_ds.shards["globalShard"].dim,
                config=RefOptConfig(max_iter=20), regularization=RefReg(RefRegType.L2),
                compute_variances=variances,
            ),
            feature_shard_id="globalShard", reg_weight=0.5,
        ),
        "per-user": RefRE(
            name="per-user", dataset=ref_ds, re_dataset=red,
            problem=RefREProblem(
                REF_LOGISTIC, RefOptConfig(max_iter=20), RefReg(RefRegType.L2),
                reg_weight=1.0, compute_variances=variances,
            ),
        ),
    }
    model = RefCD(coords, ref_ds, RefTask.LOGISTIC_REGRESSION).run(2).model
    port_red = build_random_effect_dataset(
        port_ds, RandomEffectDataConfiguration("userId", "userShard")
    )
    fe, re = model.models["global"], model.models["per-user"]
    port_model = game_model_from_reference(
        TaskType.LOGISTIC_REGRESSION,
        {"global": (
            "globalShard", np.asarray(fe.model.coefficients.means),
            None if fe.model.coefficients.variances is None
            else np.asarray(fe.model.coefficients.variances),
        )},
        {"per-user": (
            "userId", "userShard", np.asarray(re.bank),
            None if re.variances is None else np.asarray(re.variances),
            red.projection, ref_ds.entity_indexes["userId"].ids,
        )},
        {"per-user": port_red},
        device="cpu",
    )
    return ref_ds, port_ds, model, port_model


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("variances", [False, True])
@pytest.mark.parametrize("parts", [1, 3])
def test_files_are_byte_identical(tmp_path, variances, parts):
    ref_ds, port_ds, ref_model, port_model = _reference_model(variances)
    spec = "global -> x\nper-user -> y"
    ref_save(ref_model, ref_ds, str(tmp_path / "ref"), model_spec=spec, num_re_output_files=parts)
    save_game_model(port_model, port_ds, str(tmp_path / "port"), model_spec=spec,
                    num_re_output_files=parts)
    ref_files, port_files = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(port_files) == sorted(ref_files)
    assert len([f for f in port_files if f.endswith(".avro")]) == 1 + parts
    for name, data in ref_files.items():
        assert port_files[name] == data, name


def test_each_package_loads_the_others_files(tmp_path):
    ref_ds, port_ds, ref_model, port_model = _reference_model(True)
    ref_save(ref_model, ref_ds, str(tmp_path / "ref"))
    save_game_model(port_model, port_ds, str(tmp_path / "port"))
    # new rows, scored by the model from either directory in either package
    new_ref, new_port = both_datasets(make_records(13, n=90, n_users=9))
    want = np.asarray(ref_load(str(tmp_path / "ref")).score(new_ref, RefTask.LOGISTIC_REGRESSION))
    for src in ("ref", "port"):
        loaded = load_game_model(str(tmp_path / src))
        assert loaded.coordinate_names() == ["global", "per-user"]
        got = loaded.score(new_port, TaskType.LOGISTIC_REGRESSION)
        assert_close_to_scale(got, want, rtol=1e-6)
        ref_got = np.asarray(ref_load(str(tmp_path / src)).score(new_ref, RefTask.LOGISTIC_REGRESSION))
        assert_close_to_scale(ref_got, want, rtol=1e-6)
    loaded = load_game_model(str(tmp_path / "port"))
    assert loaded.random_effect_variances["per-user"] == (
        ref_load(str(tmp_path / "ref")).random_effect_variances["per-user"]
    )


def test_save_loaded_round_trip(tmp_path):
    ref_ds, _, ref_model, _ = _reference_model(False)
    ref_save(ref_model, ref_ds, str(tmp_path / "src"))
    save_loaded_game_model(load_game_model(str(tmp_path / "src")), str(tmp_path / "port"))
    ref_save_loaded(ref_load(str(tmp_path / "src")), str(tmp_path / "ref"))
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


def test_a_mismatched_projection_is_refused():
    _, port_ds, _, port_model = _reference_model(False)
    red = port_model.models["per-user"].re_dataset
    with pytest.raises(ValueError, match="projection"):
        game_model_from_reference(
            TaskType.LOGISTIC_REGRESSION, {},
            {"per-user": ("userId", "userShard", np.zeros((red.num_entities, red.local_dim)),
                          None, red.projection + 1, list(range(red.num_entities)))},
            {"per-user": red}, device="cpu",
        )


def test_native_and_python_readers_load_the_same_model(tmp_path, monkeypatch):
    """``load_game_model`` over the native column decoder and over the
    Python codec: the same coefficient and variance maps, key for key and
    bit for bit (3 random-effect part files)."""
    from photon_ml_tpu_torch.io import native_avro

    if not native_avro.available():
        pytest.skip("the native Avro decoder does not build here (g++, zlib)")
    _, port_ds, _, port_model = _reference_model(True)
    save_game_model(port_model, port_ds, str(tmp_path / "m"), num_re_output_files=3)
    from photon_ml_tpu_torch.io.model_io import _decoded_models

    for coordinate in ("fixed-effect/global", "random-effect/per-user"):
        base = tmp_path / "m" / coordinate / "coefficients"
        files = sorted(base.glob("*.avro"))
        assert files and all(_decoded_models(str(f)) is not None for f in files)
    native = load_game_model(str(tmp_path / "m"))
    monkeypatch.setattr(native_avro, "available", lambda: False)
    python = load_game_model(str(tmp_path / "m"))
    assert native.fixed_effects == python.fixed_effects
    assert native.random_effects == python.random_effects
    assert native.random_effect_variances == python.random_effect_variances
    assert native.random_effect_variances["per-user"]
