"""The port's twin-run determinism harness
(``photon_ml_tpu_torch/testing/determinism.py``), held to
``tests/test_determinism_harness.py`` and to the JAX package's targets.

* unit — ``stable_seed``, ``byte_diff_trees``, ``run_target`` dispatch,
  ``_child_env`` hygiene (the children never see a card), a hung child
  fails its twin run instead of hanging the caller;
* positive control — the harness MUST catch the hash-order-dependent
  writer;
* twin runs of ``registry_publish`` and (slow, as the reference's)
  ``wire_frames``;
* cross-package — each of the five ported targets writes a tree
  byte-identical to the JAX package's target of the same name (in fresh
  children for ``metrics_json``, which reads process-wide counters);
* regression — the retry plane's backoff jitter draws the same in two
  interpreters under different ``PYTHONHASHSEED`` values.

The full matrix and the ``wire_frames`` twin run keep the reference's
``slow`` mark.
"""

import os
import subprocess
import sys

import pytest

from photon_ml_tpu.testing import determinism as ref_det
from photon_ml_tpu.testing import determinism_targets as ref_dt
from photon_ml_tpu_torch.testing import determinism as det
from photon_ml_tpu_torch.testing import determinism_targets as dt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestUnits:
    def test_stable_seed_is_process_stable_and_distinct(self):
        import zlib

        s = det.stable_seed("seam", 3)
        assert s == zlib.crc32(b"seam:3") == ref_det.stable_seed("seam", 3)
        assert det.stable_seed("seam", 4) != s

    def test_byte_diff_trees_identical(self, tmp_path):
        for run in ("a", "b"):
            d = tmp_path / run / "sub"
            d.mkdir(parents=True)
            (d / "x.json").write_bytes(b'{"k": 1}')
            (tmp_path / run / "y.bin").write_bytes(b"\x00\x01")
        assert det.byte_diff_trees(str(tmp_path / "a"), str(tmp_path / "b")) is None

    def test_byte_diff_trees_names_file_and_offset(self, tmp_path):
        for run, tail in (("a", b"AB"), ("b", b"AC")):
            d = tmp_path / run
            d.mkdir()
            (d / "same.bin").write_bytes(b"equal")
            (d / "diff.bin").write_bytes(b"xx" + tail)
        msg = det.byte_diff_trees(str(tmp_path / "a"), str(tmp_path / "b"))
        assert msg == "diff.bin: first byte divergence at offset 3 (4 vs 4 bytes)", msg

    def test_byte_diff_trees_missing_file(self, tmp_path):
        (tmp_path / "a").mkdir()
        (tmp_path / "b").mkdir()
        (tmp_path / "a" / "only.txt").write_bytes(b"x")
        a, b = str(tmp_path / "a"), str(tmp_path / "b")
        assert det.byte_diff_trees(a, b) == "only.txt: present only in the first run"
        assert det.byte_diff_trees(b, a) == "only.txt: present only in the second run"

    def test_run_target_unknown_name(self, tmp_path):
        with pytest.raises(KeyError, match="unknown determinism target"):
            det.run_target("no_such_artifact", str(tmp_path))

    def test_child_env_hygiene(self):
        before = dict(os.environ)
        env = det._child_env("4242", "Pacific/Kiritimati")
        assert dict(os.environ) == before
        assert env["PYTHONHASHSEED"] == "4242"
        assert env["TZ"] == "Pacific/Kiritimati"
        assert det._REPO_ROOT in env["PYTHONPATH"].split(os.pathsep)
        assert det._REPO_ROOT == REPO
        # the children are host writers: no card, no CUDA context
        assert env["CUDA_VISIBLE_DEVICES"] == ""

    def test_gate_matrix_excludes_the_control(self):
        assert "control_hash_order" not in dt.TARGETS
        assert "control_hash_order" in dt.ALL_TARGETS
        assert set(dt.ALL_TARGETS) == set(dt.TARGETS) | set(dt.CONTROL_TARGETS)

    def test_targets_are_the_references_but_sharding_md(self):
        """The lint's SHARDING.md renderer stays the reference's tool."""
        assert set(dt.TARGETS) == set(ref_dt.TARGETS) - {"sharding_md"}

    def test_twin_run_surfaces_child_failure(self, tmp_path):
        with pytest.raises(det.TwinRunError, match="no_such_artifact"):
            det.twin_run("no_such_artifact", base_dir=str(tmp_path))

    def test_a_hung_child_fails_within_its_timeout(self, tmp_path, monkeypatch):
        """A child that outlives ``timeout_s`` is killed and named, never a
        hang of the caller."""
        hang = tmp_path / "hang.sh"
        hang.write_text("#!/bin/sh\nexec sleep 30\n")
        hang.chmod(0o755)
        monkeypatch.setattr(sys, "executable", str(hang))
        with pytest.raises(det.TwinRunError, match="did not finish within 0.5 s"):
            det.twin_run("registry_publish", base_dir=str(tmp_path), timeout_s=0.5)


class TestPositiveControl:
    def test_harness_catches_hash_order_dependent_writer(self, tmp_path):
        res = det.twin_run("control_hash_order", base_dir=str(tmp_path))
        assert res.identical is False
        assert res.divergence is not None
        assert res.divergence.startswith("control.txt:"), res.divergence
        d = res.to_dict()
        assert d["target"] == "control_hash_order"
        assert d["identical"] is False


def _twin_identical(tmp_path, target):
    res = det.twin_run(target, base_dir=str(tmp_path))
    assert res.identical, res.divergence
    files = det._tree_files(os.path.join(str(tmp_path), f"{target}.run0"))
    assert files and all(os.path.getsize(p) > 0 for p in files.values())


class TestGateClasses:
    def test_registry_publish_twin_run_is_byte_identical(self, tmp_path):
        """The subprocess plumbing end to end in tier-1: the registry's
        children import no torch and take under a second each."""
        _twin_identical(tmp_path, "registry_publish")

    @pytest.mark.slow
    def test_wire_frames_twin_run_is_byte_identical(self, tmp_path):
        """As the reference's, slow: each child imports torch."""
        _twin_identical(tmp_path, "wire_frames")

    @pytest.mark.slow
    def test_full_matrix_is_byte_identical(self, tmp_path):
        report = det.run_matrix(str(tmp_path), report_path=str(tmp_path / "gate.json"))
        assert report["ok"] is True, report
        assert sorted(report["classes"]) == sorted(dt.TARGETS)
        assert os.path.exists(tmp_path / "gate.json")


def _child(module, target, out):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", module, "--target", target, "--out", out],
                       env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


class TestAgainstTheJaxPackage:
    @pytest.mark.parametrize("target", sorted(dt.TARGETS))
    def test_port_tree_is_byte_identical_to_the_references(self, tmp_path, target):
        port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
        if target == "metrics_json":
            # reads process-wide retry/fault counters: fresh children
            _child("photon_ml_tpu_torch.testing.determinism", target, port)
            _child("photon_ml_tpu.testing.determinism", target, ref)
        else:
            det.run_target(target, port)
            ref_det.run_target(target, ref)
        assert det._tree_files(port)
        assert det.byte_diff_trees(port, ref) is None


class TestSeedRegressions:
    def _child_eval(self, code: str, seed: str) -> str:
        proc = subprocess.run(
            [sys.executable, "-c", code], env=det._child_env(seed, "UTC"), cwd=REPO,
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 0, proc.stderr
        return proc.stdout.strip()

    def test_fixed_seeds_identical_across_hash_seeds(self):
        """The retry plane's backoff jitter (crc32-seeded, never hash())
        draws the same in two children under different PYTHONHASHSEEDs,
        and the same as the JAX package's."""
        code = (
            "from photon_ml_tpu_torch.reliability.retry import RetryPolicy, _backoff_s\n"
            "p = RetryPolicy()\n"
            "print([round(_backoff_s(p, 'chunk_read', a), 12) for a in (1, 2, 3)])\n"
        )
        a = self._child_eval(code, "0")
        b = self._child_eval(code, "4242")
        assert a == b, (a, b)
        from photon_ml_tpu.reliability.retry import RetryPolicy, _backoff_s

        assert a == str([round(_backoff_s(RetryPolicy(), "chunk_read", n), 12) for n in (1, 2, 3)])
