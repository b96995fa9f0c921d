"""The port's serving driver in its fleet modes on the CPU:
``ServingParams.validate`` holds every shard, router, wire, fleet-obs
and SLO rule of the JAX package's driver with the same messages (a
shard-server refuses the registry watcher, as the reference's does); and one
end-to-end run: two ``--shard-index`` driver processes and a router
driver process over the same Avro trace, whose routed scores are bitwise
the single-server driver's, across the router's two-step flip, with the
fleet trace and the fleet books written and verified."""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from conftest import game_example_schema
from photon_ml_tpu.cli.serving_driver import ServingParams as RefServingParams
from photon_ml_tpu.game.config import FeatureShardConfiguration as RefShard
from photon_ml_tpu_torch import ownership
from photon_ml_tpu_torch.cli import serving_driver
from photon_ml_tpu_torch.cli.serving_driver import ServingParams
from photon_ml_tpu_torch.game.model_io import LoadedGameModel, save_loaded_game_model
from photon_ml_tpu_torch.io.avro_codec import read_avro_records, write_container
from photon_ml_tpu_torch.io.name_term_list import save_name_and_term_feature_sets
from torch_serving_cases import SHARDS, synth_records, wait_until

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASE = dict(
    game_model_input_dir="m",
    output_dir="o",
    frontend_port=0,
    offheap_indexmap_dir="maps",
    request_nnz_width="4",
)
SHARD = dict(shard_index=0, shard_count=2)
ROUTER = dict(shard_servers="127.0.0.1:1,127.0.0.1:2", frontend_port=None, request_paths=["t"])

# (case, overrides): each breaks one rule of the reference's validate
RULES = [
    ("fleet-obs-needs-router", dict(fleet_obs_dir="fo")),
    ("fleet-poll", dict(ROUTER, fleet_poll_s=0.0)),
    ("wire", dict(wire="udp")),
    ("max-frame-bytes", dict(max_frame_bytes=0)),
    ("slo-tick", dict(slo_tick_s=0.0)),
    ("slo-spec", dict(slo='{"name": "a", "objective": 1.5, "metric": "t", "bad_metric": "b"}')),
    ("shard-pair", dict(shard_index=0)),
    ("shard-range", dict(shard_index=2, shard_count=2)),
    ("shard-needs-frontend", dict(SHARD, frontend_port=None, request_paths=["t"])),
    ("shard-swap", dict(SHARD, swap_model_dir="g2", swap_after_requests=5)),
    ("router-and-shard", dict(ROUTER, **SHARD)),
    ("router-frontend", dict(ROUTER, frontend_port=0)),
    ("router-request-paths", dict(ROUTER, request_paths=[])),
    ("router-addresses", dict(ROUTER, shard_servers=" , ")),
    ("router-swap-after", dict(ROUTER, swap_model_dir="g2")),
    ("router-model", dict(ROUTER, game_model_input_dir="")),
    ("router-output", dict(ROUTER, output_dir="")),
    ("router-mode", dict(ROUTER, mode="burst")),
    ("router-feature-shards", dict(ROUTER, feature_shards=[])),
]


def _both(**over):
    kw = dict(BASE, feature_shards=SHARDS)
    kw.update(over)
    ref_kw = dict(kw, feature_shards=[RefShard(s.shard_id, s.feature_bags) for s in kw["feature_shards"]])
    return ServingParams(**kw), RefServingParams(**ref_kw)


class TestValidation:
    @pytest.mark.parametrize("case,over", RULES, ids=[r[0] for r in RULES])
    def test_rule_and_message_match_the_reference(self, case, over):
        port, ref = _both(**over)
        with pytest.raises(ValueError) as ref_err:
            ref.validate()
        with pytest.raises(ValueError) as port_err:
            port.validate()
        assert str(port_err.value) == str(ref_err.value)

    @pytest.mark.parametrize("over", [SHARD, ROUTER, dict(ROUTER, slo="default",
                                                       fleet_obs_dir="fo", wire="binary")])
    def test_fleet_modes_validate(self, over):
        port, ref = _both(**over)
        ref.validate()
        port.validate()
        assert (port.shard_mode, port.router_mode, port.entity_shard) == (
            ref.shard_mode, ref.router_mode, ref.entity_shard
        )
        assert port.shard_addresses == ref.shard_addresses

    def test_parsed_defaults_equal_the_reference(self):
        from photon_ml_tpu.cli.serving_driver import params_from_args as ref_params

        argv = ["--output-dir", "o", "--feature-shard-id-to-feature-section-keys-map",
                "g:features|u:userFeatures", "--shard-servers", "hostA:12, hostB:13",
                "--request-paths", "t", "--game-model-input-dir", "m"]
        port, ref = serving_driver.params_from_args(argv), ref_params(argv)
        for name in ("shard_addresses", "hot_cache_entries", "router_subrequest_timeout_ms",
                     "router_hedge", "obs_snapshot_s", "fleet_poll_s", "slo_tick_s", "wire"):
            assert getattr(port, name) == getattr(ref, name), name
        assert port.shard_addresses == [("hostA", 12), ("hostB", 13)]

    def test_router_takes_no_device(self):
        port = ServingParams(**dict(BASE, feature_shards=SHARDS, device="cpu", **ROUTER))
        with pytest.raises(ValueError, match="builds no device bank"):
            port.validate()

    def test_shard_server_defaults_to_the_card(self, tmp_path, monkeypatch):
        """A shard-server that cannot reach a card raises unless given
        ``--device cpu``; nothing falls back to the CPU."""
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serving_driver.main([
                "--game-model-input-dir", "m", "--output-dir", str(tmp_path / "o"),
                "--feature-shard-id-to-feature-section-keys-map", "g:features",
                "--frontend-port", "0", "--shard-index", "0", "--shard-count", "2",
                "--feature-name-and-term-set-path", "nt", "--request-nnz-width", "4",
            ])

    def test_registry_options_still_raise_naming_item_15(self):
        """The registry options are ported (item 15 is done); on a
        shard-server they are refused with the reference's message."""
        port, ref = _both(registry_dir="r", **SHARD)
        with pytest.raises(ValueError, match="incompatible with --registry-dir") as e:
            port.validate()
        with pytest.raises(ValueError) as r:
            ref.validate()
        assert str(e.value) == str(r.value)


# -- one end-to-end fleet of driver processes ----------------------------------


def _write_inputs(tmp_path, rng):
    lm = LoadedGameModel()
    lm.fixed_effects["global"] = ("g", {f"g{j}\t": float(rng.normal()) for j in range(5)})
    lm.random_effects["per-user"] = (
        "userId", "u",
        {f"user{e}": {f"u{j}\t": float(rng.normal()) for j in range(3)} for e in range(6)},
    )
    model_dir = save_loaded_game_model(lm, str(tmp_path / "model"))
    nt_dir = str(tmp_path / "nt")
    save_name_and_term_feature_sets(
        {"features": {f"g{j}\t" for j in range(5)},
         "userFeatures": {f"u{j}\t" for j in range(3)}},
        nt_dir,
    )
    recs = synth_records(rng, n=50, n_users=7)
    trace = tmp_path / "trace"
    write_container(
        str(trace / "part-0.avro"), game_example_schema(),
        [{k: r[k] for k in ("uid", "response", "metadataMap", "features", "userFeatures")}
         for r in recs],
    )
    return model_dir, nt_dir, str(trace), recs


def _scores(out_dir):
    return {x["uid"]: x["predictionScore"]
            for x in read_avro_records(os.path.join(out_dir, "scores"))}


def test_shard_and_router_drivers_route_bitwise_the_single_server(tmp_path, rng):
    model_dir, nt_dir, trace, recs = _write_inputs(tmp_path, rng)
    common = [
        "--feature-shard-id-to-feature-section-keys-map", "g:features|u:userFeatures",
        "--feature-name-and-term-set-path", nt_dir,
        "--request-nnz-width", "g:8|u:8",
        "--ladder", "1,8",
    ]
    single_out = str(tmp_path / "single")
    serving_driver.main(["--game-model-input-dir", model_dir, "--output-dir", single_out,
                         "--request-paths", trace, "--device", "cpu"] + common)
    procs = []
    try:
        for s in range(2):
            out = str(tmp_path / f"shard{s}")
            obs = ["--obs-dir", str(tmp_path / "shard0-obs"),
                   "--profile-dir", str(tmp_path / "shard0-prof")] if s == 0 else []
            procs.append((out, subprocess.Popen(
                [sys.executable, "-m", "photon_ml_tpu_torch.cli.serving_driver",
                 "--game-model-input-dir", model_dir, "--output-dir", out,
                 "--frontend-port", "0", "--shard-index", str(s), "--shard-count", "2",
                 "--device", "cpu"] + common + obs,
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                # every member traces, so that the fleet trace joins them
                env={**os.environ, "PHOTON_TRACE": "1"},
            )))
        ports = []
        for out, p in procs:
            fj = os.path.join(out, "frontend.json")
            assert wait_until(lambda: os.path.exists(fj), timeout=120), (
                "shard-server never published its port"
            )
            meta = json.load(open(fj))
            ports.append(meta["port"])
            assert meta["shard"]["shard_count"] == 2
            assert meta["shard"]["rule"] == ownership.OWNERSHIP_RULE
            assert meta["shard"]["partial"] is True
        router_out, fleet_obs = str(tmp_path / "router"), str(tmp_path / "fleet-obs")
        r = subprocess.run(
            [sys.executable, "-m", "photon_ml_tpu_torch.cli.serving_driver",
             "--game-model-input-dir", model_dir, "--output-dir", router_out,
             "--request-paths", trace, "--mode", "open", "--concurrency", "4",
             "--shard-servers", ",".join(f"127.0.0.1:{pt}" for pt in ports),
             "--feature-shard-id-to-feature-section-keys-map", "g:features|u:userFeatures",
             "--wire", "binary", "--fleet-obs-dir", fleet_obs, "--fleet-poll-s", "0.2",
             "--obs-dir", str(tmp_path / "router-obs"),
             "--slo", "default", "--swap-model-dir", model_dir,
             "--swap-after-requests", "20"],
            cwd=REPO, capture_output=True, text=True, timeout=300,
        )
        assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
        single, routed = _scores(single_out), _scores(router_out)
        assert set(single) == set(routed) == {x["uid"] for x in recs}
        assert not [u for u in single if np.float32(single[u]) != np.float32(routed[u])], (
            "routed scores must be bitwise the single server's"
        )
        m = json.load(open(os.path.join(router_out, "metrics.json")))
        assert m["mode"] == "router" and m["outcomes"] == {"ok": len(recs)}
        assert m["routing"]["shards"] == 2
        assert m["swap"]["ok"] and m["generation"] == 2
        assert m["slo"]["alerts_active"] == []
        assert m["fleet_obs"]["conservation"]["ok"]
        fleet = json.load(open(os.path.join(fleet_obs, "fleet_trace.json")))
        assert fleet["otherData"]["verification"]["ok"], fleet["otherData"]["verification"]
        assert fleet["otherData"]["verification"]["router_subrequests"] > 0
        assert json.load(open(os.path.join(fleet_obs, "fleet_conservation.json")))["ok"]
        for out, p in procs:
            p.send_signal(signal.SIGTERM)
        for out, p in procs:
            assert p.wait(timeout=60) == 0, p.stdout.read()[-3000:]
            sm = json.load(open(os.path.join(out, "metrics.json")))
            assert sm["programs"]["cold_dispatch_compiles"] == 0
            assert sm["leaked_connections"] == 0
            assert sm["generation"] == 2
        shard0 = json.load(open(os.path.join(tmp_path, "shard0", "metrics.json")))
        assert shard0["obs"]["conservation"]["ok"]
        assert sorted(os.listdir(tmp_path / "shard0-obs")) == [
            "flight.json", "metrics_snapshot.json", "trace.json"
        ]
        assert [n for n in os.listdir(tmp_path / "shard0-prof") if n.endswith(".pt.trace.json")]
    finally:
        for _out, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
